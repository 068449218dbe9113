"""Mamba2 SSD chunked scan: the CUDA kernel, its wrapper and its plain
version."""
