"""Public wrappers of the sim-step kernels (``csrc/simstep.cu``).

An iteration of the card's sim is three launches on one stream:
``sim_pre_f64``, the water-filling solve (``kernels/waterfill``) and
``sim_post_f64``. The two kernels here read and write the sim's state
tensors in place. ``bind`` checks every tensor they touch once, when a
sim builds its state on the card (device, dtype, shape, contiguity), and
packs their addresses with the scenario's sizes and constants into the C
struct ``SimArgs`` (``FIELDS`` lists its members in order). The state
keeps its storage for the whole run, so those addresses hold for every
launch and for every CUDA graph that records one.

There is no CPU route and no fallback: the CPU runs the torch ops of
``transfer/flowsim_torch.py`` (``_cascade_batch`` / ``_step``), the plain
version these kernels are held against. Each launch adds one to
``kernels.sim_pre_f64.launches`` or ``kernels.sim_post_f64.launches``; a
call under CUDA stream capture records the kernel into a graph and adds
one to the ``.recorded`` twin instead, and whoever replays the graph adds
the launches it recorded (``GRAPH_COUNTERS`` pairs the two, as in
``kernels.waterfill.ops``). A launch the CUDA runtime refuses raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.obs.metrics import REGISTRY

from .. import refuse_dtensor

KERNELS = ("sim_pre_f64", "sim_post_f64")
_launches = {k: REGISTRY.counter(f"kernels.{k}.launches") for k in KERNELS}
# (recorded under capture, launched) counter pairs of both kernels
GRAPH_COUNTERS = tuple(
    (REGISTRY.counter(c.name.replace(".launches", ".recorded")), c)
    for c in _launches.values()
)
_recorded = {c.name: r for r, c in GRAPH_COUNTERS}

_F64, _I64, _I32 = torch.float64, torch.int64, torch.int32
_B, _U8 = torch.bool, torch.uint8
# the device tensors of ``SimArgs``, in order: name, dtype, shape (by the
# names of ``SIZES``; ``ns1`` is ns + 1, ``nj1`` nj + 1, ``nseg1`` nseg + 1)
TENSORS = (
    # the sim's state
    ("now", _F64, ()), ("it", _I64, ()), ("events", _I64, ()),
    ("draining", _B, ()), ("stop", _B, ()), ("t_sched", _F64, ()),
    ("chunk_arr", _I64, ("ncp",)), ("remaining", _F64, ("ncp",)),
    ("conn_alive", _B, ("ncp",)), ("arrived", _B, ("nj",)),
    ("ready_buf", _I64, ("ns1", "qcap")), ("q_head", _I64, ("ns1",)),
    ("q_tail", _I64, ("ns1",)), ("relay_occ", _I64, ("ns1",)),
    ("done_bm", _B, ("ns1", "qcap")), ("enq_bm", _B, ("ns1", "qcap")),
    ("delivered", _I64, ("nslot",)), ("finished", _B, ("nj",)),
    ("finish", _F64, ("nj",)), ("jeg", _F64, ("nseg",)),
    ("jeo", _F64, ("nseg",)), ("jeb", _F64, ("nseg",)),
    ("rates", _F64, ("ncp",)), ("last_active", _B, ("ncp",)),
    ("rates_valid", _B, ()), ("td_time", _F64, ("nj1",)),
    ("td_job", _I64, ("nj1",)), ("td_n", _I64, ()), ("solves", _I64, ()),
    # the scenario's constants
    ("conn_job", _I64, ("ncp",)), ("conn_sid", _I64, ("ncp",)),
    ("conn_valid", _B, ("ncp",)), ("chunk_size", _F64, ("ncp",)),
    ("conn_first", _I64, ("ncp",)), ("stage_hop", _I64, ("ns1",)),
    ("stage_deliver", _I64, ("ns1",)), ("children", _I64, ("ns1", "maxch")),
    ("slot_job", _I64, ("nslot",)), ("slot_need", _I64, ("nslot",)),
    ("je_off", _I32, ("nseg1",)), ("je_idx", _I32, ("ncp",)),
    # scratch (``Scratch``)
    ("go", _B, ()), ("run", _B, ()), ("active", _B, ("ncp",)),
    ("changed", _B, ()), ("w", _F64, ("ncp",)), ("excl", _I32, ("ncp",)),
    ("lane_ch", _I64, ("ncp",)), ("lane_flags", _U8, ("ncp",)),
    ("ord", _F64, ("ncp",)), ("ord_on", _U8, ("ncp",)),
)
# the scalars of ``SimArgs`` after the tensors, in order
KNOBS = (
    ("relay_cap", ctypes.c_longlong), ("max_events", ctypes.c_longlong),
    ("horizon", ctypes.c_double), ("hz_eps", ctypes.c_double),
    ("t_eps", ctypes.c_double), ("eps", ctypes.c_double),
)
SIZES = ("ncp", "ns", "nj", "nslot", "nseg", "qcap", "maxch",
         "seq_possible", "drain")
FIELDS = (tuple(name for name, _, _ in TENSORS)
          + tuple(name for name, _ in KNOBS) + SIZES)


class SimArgs(ctypes.Structure):
    """``csrc/simstep.cu``'s ``SimArgs``, member for member."""

    _fields_ = ([(name, ctypes.c_void_p) for name, _, _ in TENSORS]
                + list(KNOBS) + [(name, ctypes.c_int) for name in SIZES])


class Scratch(NamedTuple):
    """What ``sim_pre_f64`` leaves for the solve and ``sim_post_f64``
    (``go``, ``run``, ``active``, ``changed``), and the lane values each
    kernel passes between its own phases (``excl``, ``ord`` and
    ``ord_on`` only where they do not fit its shared memory)."""

    go: torch.Tensor
    run: torch.Tensor
    active: torch.Tensor
    changed: torch.Tensor
    w: torch.Tensor
    excl: torch.Tensor
    lane_ch: torch.Tensor
    lane_flags: torch.Tensor
    ord: torch.Tensor
    ord_on: torch.Tensor


def scratch(ncp: int, device) -> Scratch:
    """The kernels' scratch for ``ncp`` lanes, allocated once a sim."""
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Scratch(go=z((), _B), run=z((), _B), active=z(ncp, _B),
                   changed=z((), _B), w=z(ncp, _F64), excl=z(ncp, _I32),
                   lane_ch=z(ncp, _I64), lane_flags=z(ncp, _U8),
                   ord=z(ncp, _F64), ord_on=z(ncp, _U8))


class Bound(NamedTuple):
    """One sim's tensors bound to the kernels: the packed ``SimArgs``, the
    tensors it points into (held, so their storage outlives it), the
    scratch and the lane count."""

    args: SimArgs
    tensors: dict
    scratch: Scratch
    ncp: int


def _check(t, name: str, dtype, shape: tuple, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} is not a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check(tensors: dict, knobs: dict, sc: Scratch) -> dict:
    """Check the sim's tensors (``tensors`` by the names of ``TENSORS``,
    but the scratch's, which ``sc`` holds) against ``knobs`` (every name
    of ``KNOBS`` and ``SIZES``): one device, and each tensor's dtype,
    shape and contiguity. Returns the tensors by name; raises on one the
    kernels do not take. Any device passes here (``bind`` takes only the
    card's), so the CPU tests hold the sim's layout to the kernels'."""
    tensors = {**tensors, **sc._asdict()}
    missing = [n for n, _, _ in TENSORS if n not in tensors]
    missing += [n for n, _ in KNOBS if n not in knobs]
    missing += [n for n in SIZES if n not in knobs]
    if missing:
        raise KeyError(f"the sim-step kernels miss {missing}")
    refuse_dtensor("sim step", *(tensors[n] for n, _, _ in TENSORS))
    device = tensors["now"].device
    dims = {n: int(knobs[n]) for n in SIZES}
    dims.update(ns1=dims["ns"] + 1, nj1=dims["nj"] + 1,
                nseg1=dims["nseg"] + 1)
    for name, dtype, shape in TENSORS:
        _check(tensors[name], name, dtype, tuple(dims[d] for d in shape),
               device)
    return {name: tensors[name] for name, _, _ in TENSORS}


def bind(tensors: dict, knobs: dict, sc: Scratch) -> Bound:
    """``check`` the sim's tensors and pack their addresses with
    ``knobs`` into ``SimArgs``. Only a CUDA device is taken."""
    held = check(tensors, knobs, sc)
    device = held["now"].device
    if device.type != "cuda":
        raise ValueError(f"the sim-step kernels run on the card, not on "
                         f"{device}: the CPU runs the torch ops")
    from .build import load

    size = load().simstep_args_bytes()
    if size != ctypes.sizeof(SimArgs):
        raise RuntimeError(f"the library's SimArgs takes {size} bytes, "
                           f"ops.SimArgs {ctypes.sizeof(SimArgs)}")
    args = SimArgs(
        *(held[name].data_ptr() for name, _, _ in TENSORS),
        *(knobs[name] for name, _ in KNOBS),
        *(int(knobs[name]) for name in SIZES),
    )
    return Bound(args, held, sc, int(knobs["ncp"]))


def _count(kernel: str) -> None:
    """One call that launched (or, under stream capture, recorded) its
    kernel."""
    launches = _launches[kernel]
    if torch.cuda.is_current_stream_capturing():
        _recorded[launches.name].inc()
    else:
        launches.inc()


def _stream(b: Bound):
    return torch.cuda.current_stream(b.tensors["now"].device).cuda_stream


def sim_pre_f64(b: Bound, *, seq: bool = False) -> None:
    """The iteration's loop flag, head, batched refill and the solve's
    membership flags (``b.scratch``: ``go``, ``run``, ``active``,
    ``changed``). ``seq`` leaves the refill to the host's sequential
    cascade, which runs after this launch where ``run`` holds."""
    from .build import load

    rc = load().sim_pre_f64(ctypes.byref(b.args), int(seq), _stream(b))
    if rc != 0:
        raise RuntimeError(f"sim_pre_f64 kernel launch failed: CUDA error {rc}")
    _count("sim_pre_f64")


def sim_post_f64(b: Bound, rates: torch.Tensor) -> None:
    """The rest of the iteration after the solve, whose output is
    ``rates`` (f64, one a lane, on the state's device), and the solve's
    flag ``changed`` added to the state's ``solves``."""
    _check(rates, "rates", _F64, (b.ncp,), b.tensors["now"].device)
    from .build import load

    rc = load().sim_post_f64(ctypes.byref(b.args), rates.data_ptr(),
                             _stream(b))
    if rc != 0:
        raise RuntimeError(f"sim_post_f64 kernel launch failed: CUDA error "
                           f"{rc}")
    _count("sim_post_f64")
