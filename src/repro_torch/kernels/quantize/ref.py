"""Plain PyTorch versions of the quantize kernels (the port of
``repro/kernels/quantize/ref.py``), and the flat form the wrapper and the
gradient compressor use."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quantize_int8_2d_ref(x2d):
    """x2d [n_blocks, block] -> (q int8 [n_blocks, block], scales f32
    [n_blocks, 1]). ``amax`` propagates NaN as ``jnp.max`` does, and a NaN
    absmax fails ``> 0``, so its block's scale is 1.0, as in the
    reference; ``torch.round`` rounds half to even as ``jnp.round``."""
    x = x2d.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA ``div`` by a Python scalar
    # multiplies by its reciprocal, one ulp from the IEEE division of the
    # reference and of the kernel in some blocks
    scale = torch.where(absmax > 0.0,
                        absmax / torch.full_like(absmax, 127.0),
                        torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_int8_2d_ref(q2d, scales):
    return q2d.to(torch.float32) * scales


def quantize_int8_flat(flat, block: int):
    """f32 [n] -> (q int8 [n], scales f32 [ceil(n / block)]): the last
    block padded with zeros, which leave its absmax as it is."""
    n = flat.shape[0]
    x2d = F.pad(flat, (0, (-n) % block)).reshape(-1, block)
    q, scale = quantize_int8_2d_ref(x2d)
    return q.reshape(-1)[:n], scale[:, 0]


def dequantize_int8_flat(q, scales, block: int):
    """int8 [n], f32 [ceil(n / block)] -> f32 [n]."""
    n = q.shape[0]
    q2d = F.pad(q, (0, (-n) % block)).reshape(-1, block)
    return dequantize_int8_2d_ref(q2d, scales[:, None]).reshape(-1)[:n]
