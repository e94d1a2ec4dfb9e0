"""``python -m tpusfm_torch.bench``: the two-view benchmark's JSON line."""
from tpusfm_torch.bench.two_view import main

if __name__ == "__main__":
    main()
