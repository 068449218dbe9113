"""Int8 block quantization: the CUDA kernels, their wrapper and their
plain versions."""
