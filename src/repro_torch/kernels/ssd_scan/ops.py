"""Public SSD wrapper in the model layout ([B,S,H,P]).

``ssd_scan`` pads a ragged tail with ``dt = 0`` (zero step size leaves the
recurrence unchanged), as the reference does
(``repro/kernels/ssd_scan/ops.py:17-36``), then takes the plain version
(``ref.py``) for tensors on the CPU and launches a CUDA kernel for tensors
on the card, chosen by type and shape (``kernel_for``, a pure rule):

- bf16 with a chunk that is a multiple of 64 up to 256, a head dim that is
  a multiple of 8 up to 64 and a state that is a multiple of 8 up to 128
  (Zamba2's 256, 64, 64 among them): the tensor-core kernel
  (``csrc/ssd_wgmma.cu``: wgmma products, TMA loads);
- f32 (whose 1e-3 tolerance rules out bf16 products), and bf16 at any
  other shape the vector-unit kernel takes: ``csrc/ssd_scan.cu``.

There is no other route and no fallback: a build or launch failure
raises. The kernels read the model layout as it is. Each launch of either
kernel adds one to ``kernels.ssd_scan.launches`` in the port's metrics
registry, and each launch of the tensor-core kernel one to
``kernels.ssd_scan.wgmma_launches``; CPU calls do not count. The kernels
have no backward
(nor has the reference's Pallas kernel), so the public wrapper refuses
inputs that require grad while grad mode is on, on every device, before
any build or launch: autograd would otherwise drop their gradient.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.obs.metrics import REGISTRY

from .. import aligned16, refuse_dtensor, refuse_grad
from ..nvcc import BASE_FLAGS, Library
from . import ref

_launches = REGISTRY.counter("kernels.ssd_scan.launches")
_wgmma_launches = REGISTRY.counter("kernels.ssd_scan.wgmma_launches")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 256, 64, 128
_CSRC = Path(__file__).resolve().parent / "csrc"


def kernel_for(dtype: torch.dtype, chunk: int, p: int, n: int) -> str:
    """The kernel a card call takes: ``"wgmma"`` (tensor cores) for bf16
    with the chunk a multiple of 64 up to 256, the head dim a multiple of 8
    up to 64 and the state a multiple of 8 up to 128, else ``"vector"``."""
    if (dtype == torch.bfloat16 and chunk % 64 == 0
            and 0 < chunk <= MAX_CHUNK and p % 8 == 0
            and 0 < p <= MAX_HEAD_DIM and n % 8 == 0 and 0 < n <= MAX_STATE):
        return "wgmma"
    return "vector"


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_fwd.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.ssd_scan_fwd.restype = i


def _declare_wgmma(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_wgmma.argtypes = [p] * 7 + [i] * 6 + [p]
    lib.ssd_scan_wgmma.restype = i


LIBRARY = Library(_CSRC / "ssd_scan.cu", BASE_FLAGS, _declare)
# the tensor-core kernel includes flash attention's Hopper headers
WGMMA_LIBRARY = Library(
    _CSRC / "ssd_wgmma.cu", BASE_FLAGS, _declare_wgmma,
    deps=(_CSRC.parent.parent / "flash_attention" / "csrc",),
)


def _kernel(xh, dtv, a, bm, cm, *, chunk: int, kernel: str | None = None):
    """A CUDA kernel on card tensors in the model layout, S a multiple of
    ``chunk``: ``kernel`` ("wgmma" or "vector"), or ``kernel_for``'s
    choice."""
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    if xh.dtype not in _DTYPES:
        raise TypeError(f"no SSD kernel for dtype {xh.dtype}")
    if bm.dtype != xh.dtype or cm.dtype != xh.dtype:
        raise TypeError("B and C must have x's dtype")
    if bm.shape != (b, s, n) or cm.shape != (b, s, n):
        raise ValueError("B and C must be [batch, seq, state]")
    if dtv.shape != (b, s, h) or a.shape != (h,):
        raise ValueError("dt must be [batch, seq, heads] and a [heads]")
    if chunk > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(
            f"chunk {chunk}, head dim {p}, state {n} above the kernel's "
            f"{MAX_CHUNK}, {MAX_HEAD_DIM}, {MAX_STATE}"
        )
    for t in (dtv, a, bm, cm):
        if t.device != xh.device:
            raise ValueError("every operand must be on x's device")
    kernel = kernel_for(xh.dtype, chunk, p, n) if kernel is None else kernel
    if kernel == "wgmma" and kernel_for(xh.dtype, chunk, p, n) != "wgmma":
        raise ValueError(f"no tensor-core SSD kernel for {xh.dtype}, chunk "
                         f"{chunk}, head dim {p}, state {n}")
    xh, bm, cm = aligned16(xh), aligned16(bm), aligned16(cm)
    dtv = dtv.to(torch.float32).contiguous()
    a = a.to(torch.float32).contiguous()
    y = torch.empty_like(xh)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=xh.device)
    ptrs = (xh.data_ptr(), dtv.data_ptr(), a.data_ptr(), bm.data_ptr(),
            cm.data_ptr(), y.data_ptr(), state.data_ptr())
    stream = torch.cuda.current_stream(xh.device).cuda_stream
    if kernel == "wgmma":
        rc = WGMMA_LIBRARY.load().ssd_scan_wgmma(*ptrs, b, s, h, p, n, chunk,
                                                 stream)
    elif kernel == "vector":
        rc = LIBRARY.load().ssd_scan_fwd(*ptrs, _DTYPES[xh.dtype], b, s, h, p,
                                         n, chunk, stream)
    else:
        raise ValueError(f"no SSD kernel named {kernel!r}")
    if rc != 0:
        raise RuntimeError(
            f"SSD scan ({kernel}) launch failed: CUDA error {rc}")
    _launches.inc()
    if kernel == "wgmma":
        _wgmma_launches.inc()
    return y, state


def _plain(xh, dtv, a, bm, cm, *, chunk: int):
    y, state = ref.ssd_scan_bhsp_ref(
        xh.movedim(2, 1), dtv.movedim(2, 1), a, bm, cm, chunk=chunk
    )
    return y.movedim(1, 2), state


def _padded(fn, xh, dtv, a, bm, cm, *, chunk: int):
    """``fn`` on inputs padded with dt = 0 to the chunk grid, y cut back."""
    s_orig = xh.shape[1]
    chunk = min(chunk, s_orig)
    pad = (-s_orig) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dtv = F.pad(dtv, (0, 0, 0, pad))
        bm, cm = F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad))
    y, state = fn(xh, dtv, a, bm, cm, chunk=chunk)
    return (y[:, :s_orig] if pad else y), state


def ssd_scan(xh, dtv, a, bm, cm, *, chunk: int = 256):
    """Model layout: xh [B,S,H,P], dtv [B,S,H], a [H], bm/cm [B,S,N]
    -> (y [B,S,H,P] in x's type, final_state [B,H,P,N] f32): the plain
    version on the CPU, a CUDA kernel on the card (``kernel_for``). Raises
    for inputs that require grad (module docstring)."""
    refuse_dtensor("SSD scan", xh, dtv, a, bm, cm)
    refuse_grad("SSD scan", xh, dtv, a, bm, cm)
    if xh.device.type == "cpu":
        fn = _plain
    elif xh.device.type == "cuda":
        fn = _kernel
    else:
        raise ValueError(f"no SSD kernel for device {xh.device}")
    return _padded(fn, xh, dtv, a, bm, cm, chunk=chunk)


def ssd_scan_on(kernel: str, xh, dtv, a, bm, cm, *, chunk: int = 256):
    """What ``ssd_scan`` computes, by the named CUDA kernel (``"wgmma"`` or
    ``"vector"``) on card tensors, whatever ``kernel_for`` would choose: to
    hold the two kernels against each other."""
    refuse_dtensor("SSD scan", xh, dtv, a, bm, cm)
    refuse_grad("SSD scan", xh, dtv, a, bm, cm)
    if xh.device.type != "cuda":
        raise ValueError(
            f"the {kernel} kernel runs on the card, not on {xh.device}")
    return _padded(functools.partial(_kernel, kernel=kernel), xh, dtv, a, bm,
                   cm, chunk=chunk)


def ssd_scan_plain(xh, dtv, a, bm, cm, *, chunk: int = 256):
    """What ``ssd_scan`` computes, by the plain version on any device: the
    yardstick the kernel is held against on the card."""
    return _padded(_plain, xh, dtv, a, bm, cm, chunk=chunk)
