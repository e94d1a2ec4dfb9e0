from tpusfm_torch.io.image import imread_gray
from tpusfm_torch.io.dataset import REFERENCE_ROOT, source_image, has_reference_data
