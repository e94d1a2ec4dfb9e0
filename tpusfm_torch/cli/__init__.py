"""The port's command line: python -m tpusfm_torch.cli <cmd> ..."""
