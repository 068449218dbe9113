"""Flash attention: the CUDA kernel, its wrapper and its plain version."""
