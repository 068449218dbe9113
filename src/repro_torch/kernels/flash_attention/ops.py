"""Public flash-attention wrapper in the model layout [B,S,H,D].

``flash_attention`` takes the plain version (``ref.py``) for tensors on
the CPU and launches the CUDA kernel (``csrc/flash_attention.cu``) for
tensors on the card; there is no other route and no fallback. Neither
pads the sequence: both attend over the S given keys only, and the kernel
reads a ragged last tile as zeros it never attends to. For causal
attention (every call on the model path) that is what the reference's
padded wrapper (``repro/kernels/flash_attention/ops.py:20-42``) computes,
whose zero keys past S lie after every real query. The kernel reads the
[B,S,H,D] layout as it is, so nothing is transposed on the card. Each
launch adds one to ``kernels.flash_attention.launches`` in the port's
metrics registry; CPU calls do not count. The kernel has no backward
(nor has the reference's Pallas kernel), so the public wrapper refuses
inputs that require grad while grad mode is on, on every device, before
any build or launch: autograd would otherwise drop their gradient.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.obs.metrics import REGISTRY

from .. import refuse_grad
from ..nvcc import BASE_FLAGS, Library
from . import ref

_launches = REGISTRY.counter("kernels.flash_attention.launches")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 192


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p] * 4 + [i] * 8 + [
        ctypes.c_float, p]
    lib.flash_attention_fwd.restype = i


LIBRARY = Library(
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    BASE_FLAGS, _declare,
)


def _kernel(q, k, v, *, causal: bool, window: int | None, scale: float):
    """The CUDA kernel on [B,S,H,D] / [B,S,Kv,D] card tensors."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"no flash kernel for dtype {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} differs from q in dtype or device")
        if t.shape != (b, s, kvh, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} above the kernel's {MAX_HEAD_DIM}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = LIBRARY.load()
    rc = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, s, h, kvh, d, int(causal),
        -1 if window is None else int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash attention launch failed: CUDA error {rc}")
    _launches.inc()
    return out


def _plain(q, k, v, *, causal: bool, window: int | None, scale: float):
    h, kvh = q.shape[2], k.shape[2]
    return ref.attention_bhsd_ref(
        q.movedim(2, 1), k.movedim(2, 1), v.movedim(2, 1),
        q_per_kv=h // kvh, causal=causal, window=window, scale=scale,
    ).movedim(1, 2).to(q.dtype)


def _checked(fn, q, k, v, *, causal, window, scale):
    h, kvh, d = q.shape[2], k.shape[2], q.shape[3]
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    scale = d ** -0.5 if scale is None else scale
    return fn(q, k, v, causal=causal, window=window, scale=scale)


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None):
    """q: [B,S,H,D], k/v: [B,S,Kv,D] -> [B,S,H,D] in q's type: the plain
    version on the CPU, the CUDA kernel on the card. Raises for inputs
    that require grad (module docstring)."""
    refuse_grad("flash attention", q, k, v)
    if q.device.type == "cpu":
        fn = _plain
    elif q.device.type == "cuda":
        fn = _kernel
    else:
        raise ValueError(f"no flash attention kernel for device {q.device}")
    return _checked(fn, q, k, v, causal=causal, window=window, scale=scale)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None):
    """What ``flash_attention`` computes, by the plain version on any
    device: the yardstick the kernel is held against on the card."""
    return _checked(_plain, q, k, v, causal=causal, window=window,
                    scale=scale)
