"""Skyplane on PyTorch and CUDA: the port of the ``repro`` package.

The port keeps the reference package's module names and layout, imports
``torch`` and ``numpy`` and nothing of the reference, and runs its entry
points on the CUDA card unless the caller passes ``device="cpu"``. Each
TPU (Pallas) kernel of the reference on the ported path is a CUDA kernel
written for Hopper under ``kernels/``; its plain PyTorch version sits
beside it and serves the CPU.
"""
