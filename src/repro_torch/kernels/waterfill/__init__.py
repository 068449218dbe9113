"""Max-min water-filling: the CUDA kernel, its wrapper and plain versions."""
