from tpusfm_torch.io.image import imread, imread_gray, imwrite
from tpusfm_torch.io.dataset import REFERENCE_ROOT, source_image, has_reference_data
