"""Public flash-attention wrapper in the model layout [B,S,H,D].

``flash_attention`` takes the plain version (``ref.py``) for tensors on
the CPU and launches a CUDA kernel for tensors on the card, chosen by
shape and type (``kernel_for``):

- bf16 with a head dim D that is a multiple of 16 up to 192 (every head
  dim of ``configs/archs.py``: 64, 112, 128, 192): the tensor-core kernel
  (``csrc/flash_wgmma.cu``: wgmma products, TMA loads);
- f32 (whose 2e-5 tolerance rules out TF32 products), and bf16 with any
  other D up to 192: the vector-unit kernel (``csrc/flash_attention.cu``).

There is no fallback: a build or launch failure raises. No version
pads the sequence: each attends over the S given keys only, and the
kernels read a ragged last tile as zeros they never attend to. For causal
attention (every call on the model path) that is what the reference's
padded wrapper (``repro/kernels/flash_attention/ops.py:20-42``) computes,
whose zero keys past S lie after every real query. The kernels read the
[B,S,H,D] layout as it is, so nothing is transposed on the card. Each
launch of either kernel adds one to ``kernels.flash_attention.launches``
in the port's metrics registry, and each launch of the tensor-core kernel
one to ``kernels.flash_attention.wgmma_launches``; CPU calls do not
count. The kernels have no backward (nor has the reference's Pallas
kernel), so the public wrappers refuse inputs that require grad while
grad mode is on, on every device, before any build or launch: autograd
would otherwise drop their gradient.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.obs.metrics import REGISTRY

from .. import aligned16, refuse_dtensor, refuse_grad
from ..nvcc import BASE_FLAGS, Library
from . import ref

_launches = REGISTRY.counter("kernels.flash_attention.launches")
_wgmma_launches = REGISTRY.counter("kernels.flash_attention.wgmma_launches")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 192
_CSRC = Path(__file__).resolve().parent / "csrc"


def kernel_for(dtype: torch.dtype, d: int) -> str:
    """The kernel a card call takes: ``"wgmma"`` (tensor cores) for bf16
    with D a multiple of 16 up to 192, else ``"vector"``."""
    if dtype == torch.bfloat16 and d % 16 == 0 and 0 < d <= MAX_HEAD_DIM:
        return "wgmma"
    return "vector"


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p] * 4 + [i] * 8 + [
        ctypes.c_float, p]
    lib.flash_attention_fwd.restype = i


def _declare_wgmma(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_wgmma.argtypes = [p] * 4 + [i] * 7 + [
        ctypes.c_float, p]
    lib.flash_attention_wgmma.restype = i


LIBRARY = Library(_CSRC / "flash_attention.cu", BASE_FLAGS, _declare)
WGMMA_LIBRARY = Library(_CSRC / "flash_wgmma.cu", BASE_FLAGS, _declare_wgmma)


def _kernel(q, k, v, *, causal: bool, window: int | None, scale: float,
            kernel: str | None = None):
    """A CUDA kernel on [B,S,H,D] / [B,S,Kv,D] card tensors: ``kernel``
    ("wgmma" or "vector"), or ``kernel_for``'s choice."""
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
    kernel = kernel_for(q.dtype, d) if kernel is None else kernel
    if kernel == "wgmma" and kernel_for(q.dtype, d) != "wgmma":
        raise ValueError(f"no tensor-core flash kernel for {q.dtype}, D {d}")
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    out = torch.empty_like(q)
    win = -1 if window is None else int(window)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if kernel == "wgmma":
        rc = WGMMA_LIBRARY.load().flash_attention_wgmma(
            *ptrs, b, s, h, kvh, d, int(causal), win, float(scale), stream)
    elif kernel == "vector":
        rc = LIBRARY.load().flash_attention_fwd(
            *ptrs, _DTYPES[q.dtype], b, s, h, kvh, d, int(causal), win,
            float(scale), stream)
    else:
        raise ValueError(f"no flash kernel named {kernel!r}")
    if rc != 0:
        raise RuntimeError(
            f"flash attention ({kernel}) launch failed: CUDA error {rc}")
    _launches.inc()
    if kernel == "wgmma":
        _wgmma_launches.inc()
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
    refuse_dtensor("flash attention", q, k, v)
    refuse_grad("flash attention", q, k, v)
    if q.device.type == "cpu":
        fn = _plain
    elif q.device.type == "cuda":
        fn = _kernel
    else:
        raise ValueError(f"no flash attention kernel for device {q.device}")
    return _checked(fn, q, k, v, causal=causal, window=window, scale=scale)


def flash_attention_on(kernel: str, q, k, v, *, causal: bool = True,
                       window: int | None = None,
                       scale: float | None = None):
    """What ``flash_attention`` computes, by the named CUDA kernel
    (``"wgmma"`` or ``"vector"``) on card tensors, whatever ``kernel_for``
    would choose: to hold the two kernels against each other."""
    refuse_dtensor("flash attention", q, k, v)
    refuse_grad("flash attention", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(
            f"the {kernel} kernel runs on the card, not on {q.device}")
    return _checked(functools.partial(_kernel, kernel=kernel), q, k, v,
                    causal=causal, window=window, scale=scale)


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: int | None = None,
                          scale: float | None = None):
    """What ``flash_attention`` computes, by the plain version on any
    device: the yardstick the kernel is held against on the card."""
    return _checked(_plain, q, k, v, causal=causal, window=window,
                    scale=scale)
