"""Public int8 block-quantization wrappers over tensors of any shape.

``quantize_int8`` flattens to f32 and ``dequantize_int8`` inverts it; each
takes the plain version (``ref.py``) for tensors on the CPU and launches
its CUDA kernel (``csrc/quantize.cu``) for tensors on the card; there is
no other route and no fallback, but for ``meta`` tensors (the dry run,
``launch/dryrun.py``), which get outputs of the right shapes and compute
nothing. The kernels mask the ragged last block
themselves, so nothing is padded on the card; the reference's padding to
8 rows of blocks (``repro/kernels/quantize/ops.py:11,25-26,42-45``) was
the TPU's sublane tiling and is not carried over. q and the scales equal
the plain version bit for bit on finite inputs; q of a NaN or infinite
input is outside the contract (a NaN block's scale is 1.0, as in the
reference). Each launch adds one to ``kernels.quantize_int8.launches`` or
``kernels.dequantize_int8.launches`` in the port's metrics registry; CPU
calls do not count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.device import note_meta
from repro_torch.obs.metrics import REGISTRY

from .. import refuse_dtensor
from ..nvcc import BASE_FLAGS, Library
from . import ref

_q_launches = REGISTRY.counter("kernels.quantize_int8.launches")
_dq_launches = REGISTRY.counter("kernels.dequantize_int8.launches")


def _declare(lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for fn in (lib.quantize_int8_f32, lib.dequantize_int8_f32):
        fn.restype = i
    lib.quantize_int8_f32.argtypes = [p, p, p, ll, i, p]
    lib.dequantize_int8_f32.argtypes = [p, p, p, ll, i, p]


LIBRARY = Library(
    Path(__file__).resolve().parent / "csrc" / "quantize.cu", BASE_FLAGS,
    _declare,
)


def _n_blocks(n: int, block: int) -> int:
    if block <= 0:
        raise ValueError(f"block must be positive, not {block}")
    return -(-n // block)


def _quant_kernel(flat, block: int):
    n = flat.shape[0]
    q = torch.empty(n, dtype=torch.int8, device=flat.device)
    scales = torch.empty(_n_blocks(n, block), dtype=torch.float32,
                         device=flat.device)
    rc = LIBRARY.load().quantize_int8_f32(
        flat.data_ptr(), q.data_ptr(), scales.data_ptr(), n, block,
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"quantize launch failed: CUDA error {rc}")
    _q_launches.inc()
    return q, scales


def _dequant_kernel(q, scales, block: int):
    n = q.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=q.device)
    rc = LIBRARY.load().dequantize_int8_f32(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), n, block,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dequantize launch failed: CUDA error {rc}")
    _dq_launches.inc()
    return out


def _quant_meta(flat, block: int):
    """The meta route (the dry run): the kernel's outputs, allocated and
    reported to the active step recorder; nothing computed or launched."""
    q = torch.empty(flat.shape[0], dtype=torch.int8, device=flat.device)
    scales = torch.empty(_n_blocks(flat.shape[0], block),
                         dtype=torch.float32, device=flat.device)
    note_meta("kernel", (flat,), (q, scales))
    return q, scales


def _dequant_meta(q, scales, block: int):
    out = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    note_meta("kernel", (q, scales), (out,))
    return out


def _route(t, kernel, plain, meta):
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "meta":
        return meta
    raise ValueError(f"no quantize kernel for device {t.device}")


def quantize_int8(x, *, block: int = 256):
    """x: any shape and float type -> (q int8 [x.shape], scales f32
    [n_blocks]): the plain version on the CPU, the CUDA kernel on the
    card."""
    refuse_dtensor("quantize", x)
    flat = x.reshape(-1).to(torch.float32).contiguous()
    _n_blocks(flat.shape[0], block)
    fn = _route(flat, _quant_kernel, ref.quantize_int8_flat,
                _quant_meta)
    q, scales = fn(flat, block)
    return q.reshape(x.shape), scales


def dequantize_int8(q, scales, *, block: int = 256):
    """Inverse of ``quantize_int8``: f32 of q's shape."""
    refuse_dtensor("dequantize", q, scales)
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("q must be int8 and scales float32")
    flat = q.reshape(-1).contiguous()
    scales = scales.contiguous()
    if scales.shape != (_n_blocks(flat.shape[0], block),):
        raise ValueError(
            f"{tuple(scales.shape)} scales for {flat.shape[0]} values in "
            f"blocks of {block}"
        )
    if scales.device != flat.device:
        raise ValueError("q and scales must be on one device")
    fn = _route(flat, _dequant_kernel, ref.dequantize_int8_flat,
                _dequant_meta)
    return fn(flat, scales, block).reshape(q.shape)


def quantize_int8_plain(x, *, block: int = 256):
    """What ``quantize_int8`` computes, by the plain version on any device:
    the yardstick the kernel is held against on the card."""
    flat = x.reshape(-1).to(torch.float32)
    q, scales = ref.quantize_int8_flat(flat, block)
    return q.reshape(x.shape), scales


def dequantize_int8_plain(q, scales, *, block: int = 256):
    """What ``dequantize_int8`` computes, by the plain version on any
    device."""
    return ref.dequantize_int8_flat(q.reshape(-1), scales,
                                    block).reshape(q.shape)
