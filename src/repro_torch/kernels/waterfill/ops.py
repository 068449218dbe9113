"""Public wrappers of the water-filling kernels.

``waterfill_rates`` and ``segment_sum_ordered`` take the plain PyTorch
version (``ref.py``) for tensors on the CPU and launch the CUDA kernel
(``csrc/waterfill.cu``) for tensors on the card; there is no other route
and no fallback. Each launch adds one to its kernel's counter in the
port's metrics registry (``kernels.waterfill_f64.launches``,
``kernels.waterfill_f32.launches``, ``kernels.segsum_ordered.launches``);
CPU calls do not count. One block takes an f64 solve whose every operand
fits its shared memory staged (``shared_smem_bytes``: the staged kernel,
which counts on ``kernels.waterfill_f64_shared.launches`` as well as on
``kernels.waterfill_f64.launches``), and an f32 solve whose lanes fit it
(``smem_bytes``). A larger solve takes the cluster kernel (one
thread-block cluster of 2 to 16 blocks per solve) when the caller hands
it a lane scratch (``lanes``, of ``scratch_bytes``, which the kernel uses
only where the largest cluster's shared memory cannot hold the lanes);
the sim decides that once per scenario by ``needs_cluster``, a mirror of
the library's own size rule (``cluster_plan`` mirrors the cluster's size
K and its bytes a block), and the cluster kernel counts on
``kernels.waterfill_{f64,f32}_cluster.launches``. A call under CUDA stream
capture records the kernel into a graph and launches nothing: it adds one
to the kernel's ``.recorded`` counter instead, and whoever replays the
graph adds the launches it recorded to ``.launches`` at each replay
(``GRAPH_COUNTERS`` pairs the two).

The kernels walk CSR lists (row -> ascending connection lanes) instead of
one-hot matrices. The maps they encode are constant for a scenario, so a
caller that solves many times (the sim) builds them once with
``build_segments`` / ``csr``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.obs.metrics import REGISTRY, Counter

from .. import refuse_dtensor
from . import ref

_DTYPES = {"f64": torch.float64, "f32": torch.float32}
_launches = {
    p: REGISTRY.counter(f"kernels.waterfill_{p}.launches") for p in _DTYPES
}
_cluster_launches = {
    p: REGISTRY.counter(f"kernels.waterfill_{p}_cluster.launches")
    for p in _DTYPES
}
_shared_launches = REGISTRY.counter("kernels.waterfill_f64_shared.launches")
_segsum_launches = REGISTRY.counter("kernels.segsum_ordered.launches")
# (recorded under capture, launched) counter pairs of every kernel here
GRAPH_COUNTERS = tuple(
    (REGISTRY.counter(c.name.replace(".launches", ".recorded")), c)
    for c in (*_launches.values(), *_cluster_launches.values(),
              _shared_launches, _segsum_launches)
)
_recorded = {c.name: r for r, c in GRAPH_COUNTERS}


def _count(launches: Counter) -> None:
    """One call that launched (or, under stream capture, recorded) its
    kernel."""
    if torch.cuda.is_current_stream_capturing():
        _recorded[launches.name].inc()
    else:
        launches.inc()


# csrc/waterfill.cu's launch shapes and shared-memory layouts, mirrored so
# that a caller picks the kernel without loading the library (a card test
# holds the mirror equal to the library's own functions)
SMEM_LIMIT = 232448  # dynamic shared memory one block may take (227 KB)
_WARPS, _RUN = 12, 256
_S_WARPS, _S_RUN = 24, 128
_C_WARPS, _C_RUN, _RING, _RING_CHUNK = 16, 128, 4, 512
MAX_CLUSTER = 16  # blocks, where the card holds one such cluster (else 8)
_ELEM = {"f64": 8, "f32": 4}


def smem_bytes(nc: int, nv: int, ne: int, elem: int) -> int:
    """Shared memory of one solve in the one-block kernel that takes the
    f32 solves, every lane in it, as ``waterfill_smem_bytes`` computes
    it."""
    nseg = 2 * nv + ne
    reals = _WARPS * (1 + _RUN + 8) + 2 * nc + 2 * nseg
    ints = _WARPS + 1 + nseg
    return (reals * elem + ints * 4 + nc + 15) & ~15


def shared_smem_bytes(nc: int, nv: int, ne: int) -> int:
    """Shared memory of one f64 solve in one block with every operand
    staged (the lanes' segments and list positions, and a rate and two
    bits a list position, each list from a multiple of 32 positions on), as
    ``waterfill_shared_smem_bytes`` computes it."""
    nseg = 2 * nv + ne
    ncw = -(-nc // 32) * 32
    reals = _S_WARPS * (_S_RUN + 8) + 1 + 2 * nc + 3 * ncw + 8 + 2 * nseg
    ints = 4 + 3 * nseg + 1 + 2 * (3 * ncw // 32)
    return (reals * 8 + ints * 4 + 12 * nc + nc + 15) & ~15


def cluster_smem_bytes(nc: int, nv: int, ne: int, elem: int, k: int,
                       lanes_shared: bool) -> int:
    """Shared memory of one block of a ``k``-block cluster, with its share
    of the lanes (``lanes_shared``) or none, as
    ``waterfill_cluster_smem_bytes`` computes it."""
    nseg = 2 * nv + ne
    nown = -(-nseg // k)
    lanes = -(-nc // k) if lanes_shared else 0
    reals = (_C_WARPS + 1 + nseg + nown + _RING * (_RING_CHUNK + 8)
             + _C_WARPS * (_C_RUN + 8) + 2 * lanes)
    ints = _C_WARPS + 5 + 2 * _RING + 5 * nown
    return (16 * _RING + reals * elem + ints * 4 + lanes + 15) & ~15


class LaunchPlan(NamedTuple):
    """The kernel a solve takes (``waterfill_f64_shared``,
    ``waterfill_{p}`` or ``waterfill_{p}_cluster``), its blocks, each
    block's shared memory, and whether the lanes live there (else in the
    caller's scratch)."""

    kernel: str
    k: int
    block_bytes: int
    lanes_shared: bool


def cluster_plan(nc: int, nv: int, ne: int, precision: str = "f64",
                 max_k: int = MAX_CLUSTER) -> LaunchPlan:
    """The cluster kernel's size rule (``waterfill_cluster_plan``): the
    smallest K of 2, 4, 8 and, up to ``max_k``, 16 whose blocks hold the
    lanes; past that ``max_k`` blocks with the lanes in device memory.
    Raises where not even the segments fit a block."""
    elem = _ELEM[precision]
    name = f"waterfill_{precision}_cluster"
    k = 2
    while k <= max_k:
        b = cluster_smem_bytes(nc, nv, ne, elem, k, True)
        if b <= SMEM_LIMIT:
            return LaunchPlan(name, k, b, True)
        k *= 2
    b = cluster_smem_bytes(nc, nv, ne, elem, max_k, False)
    if b > SMEM_LIMIT:
        raise ValueError(f"{nv} VMs and {ne} edges do not fit one block's "
                         "shared memory")
    return LaunchPlan(name, max_k, b, False)


def scratch_bytes(nc: int, elem: int) -> int:
    """The cluster kernel's lane scratch (cap, rate, state per lane)."""
    return (2 * nc * elem + nc + 15) & ~15


def needs_cluster(nc: int, nv: int, ne: int, precision: str = "f64") -> bool:
    """Whether a solve of this size takes the cluster kernel: at f64 its
    operands do not all fit one block's shared memory staged, at f32 its
    lanes do not fit it."""
    if precision == "f64":
        return not takes_shared(nc, nv, ne)
    return smem_bytes(nc, nv, ne, _ELEM[precision]) > SMEM_LIMIT


def takes_shared(nc: int, nv: int, ne: int, precision: str = "f64") -> bool:
    """Whether a solve of this size takes the staged one-block kernel: f64,
    and every operand fits one block's shared memory."""
    return precision == "f64" and shared_smem_bytes(nc, nv, ne) <= SMEM_LIMIT


def launch_plan(nc: int, nv: int, ne: int,
                precision: str = "f64") -> LaunchPlan:
    """What the sim launches for a solve of this size: one block (at f64
    the staged kernel) where ``needs_cluster`` says it fits, else
    ``cluster_plan``'s cluster."""
    if needs_cluster(nc, nv, ne, precision):
        return cluster_plan(nc, nv, ne, precision)
    if precision == "f64":
        return LaunchPlan("waterfill_f64_shared", 1,
                          shared_smem_bytes(nc, nv, ne), True)
    return LaunchPlan(f"waterfill_{precision}", 1,
                      smem_bytes(nc, nv, ne, _ELEM[precision]), True)


class Segments(NamedTuple):
    """CSR lists of connection lanes per VM egress, VM ingress and edge."""

    src_off: torch.Tensor  # int32 [nv + 1]
    src_idx: torch.Tensor  # int32 [nc]
    dst_off: torch.Tensor
    dst_idx: torch.Tensor
    ed_off: torch.Tensor  # int32 [ne + 1] ([1] when there are no edges)
    ed_idx: torch.Tensor


def csr(idx: torch.Tensor, n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(offsets int32 [n_rows + 1], lanes int32 [n]): the lanes of each row
    in ascending order. Raises if an index lies outside [0, n_rows)."""
    idx = idx.to(torch.int64)
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n_rows):
        raise ValueError(f"segment index outside [0, {n_rows})")
    order = torch.argsort(idx, stable=True)
    counts = torch.zeros(n_rows, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    off = torch.zeros(n_rows + 1, dtype=torch.int64, device=idx.device)
    off[1:] = torch.cumsum(counts, 0)
    return off.to(torch.int32), order.to(torch.int32)


def build_segments(src, dst, eid, n_vms: int, n_edges: int) -> Segments:
    """The three CSR lists of a connection set (``eid`` None: no edges)."""
    so, si = csr(src, n_vms)
    do, di = csr(dst, n_vms)
    if eid is None or n_edges == 0:
        eo = torch.zeros(1, dtype=torch.int32, device=src.device)
        ei = torch.zeros(0, dtype=torch.int32, device=src.device)
    else:
        eo, ei = csr(eid, n_edges)
    return Segments(so, si, do, di, eo, ei)


def _check(t: torch.Tensor, name: str, dtype, n: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({n},)")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def waterfill_rates(caps, src, dst, eg_cap, in_cap, eid=None, ed_cap=None,
                    active=None, *, precision: str = "f64",
                    n_edges_bound: int | None = None, changed=None,
                    prev=None, segments: Segments | None = None,
                    lanes: torch.Tensor | None = None,
                    clocks: torch.Tensor | None = None) -> torch.Tensor:
    """Max-min fair per-connection rates over the ``active`` lanes.

    caps/src/dst/eid/active are per-connection lanes [NC]; eg_cap/in_cap
    per-VM budgets [NV]; ed_cap the shared per-edge budgets [NE], or None
    without link contention. Returns rates [NC], 0.0 on inactive lanes.

    ``precision="f64"`` is the sim's parity solver (``ref.
    masked_maxmin_rates``, bitwise); ``n_edges_bound`` overrides the edge
    term of its round bound. ``precision="f32"`` is the TPU kernel's
    counterpart (``ref.waterfill_rounds_f32``): without edges it pins every
    lane to one BIG edge, as the TPU wrapper does, and runs the TPU
    kernel's ``2*nv + ne + 4`` rounds.

    ``changed`` (a bool scalar tensor on the caps' device) with ``prev``
    (rates of the caps' dtype) returns ``prev`` when the flag is False;
    on the card the kernel reads the flag itself, so nothing syncs.

    Without ``lanes`` a solve runs on one block (at f64 the staged
    kernel), and one that ``needs_cluster`` raises. ``lanes`` (uint8, at
    least ``scratch_bytes(nc, elem)``, on the caps' device) runs the
    cluster kernel: one cluster of ``cluster_plan``'s K blocks, the lanes
    in their shared memory, or in ``lanes`` past the largest cluster's,
    so any lane count solves. ``clocks`` (int64 [128], zeroed, on
    the card) receives the cluster kernel's cycles per pass (the layout of
    ``csrc/waterfill.cu``'s ``Clock``). The CPU's plain version ignores
    both.
    """
    refuse_dtensor("water-filling", caps, src, dst, eg_cap, in_cap, eid,
                   ed_cap, active)
    if precision not in _DTYPES:
        raise ValueError(f"unknown precision {precision!r} (f64 or f32)")
    dtype = _DTYPES[precision]
    dev = caps.device
    nc, nv = caps.shape[0], eg_cap.shape[0]
    if active is None:
        active = torch.ones(nc, dtype=torch.bool, device=dev)
    if precision == "f32" and ed_cap is None:
        eid = torch.zeros(nc, dtype=src.dtype, device=dev)
        ed_cap = torch.full((1,), ref.BIG, dtype=dtype, device=dev)
    ne = 0 if ed_cap is None else ed_cap.shape[0]
    if n_edges_bound is None:
        n_edges_bound = ne
    n_iters = 2 * nv + ne + 4  # the f32 rounds (the f64 bound is adaptive)
    if (changed is None) != (prev is None):
        raise ValueError("changed and prev go together")

    if dev.type == "cpu":
        if changed is not None and not bool(changed):
            return prev.clone()
        if precision == "f64":
            return ref.masked_maxmin_rates(
                caps, src, dst, eg_cap, in_cap, eid, ed_cap, active,
                n_vms=nv, n_edges=ne, n_edges_bound=n_edges_bound,
            )
        return ref.waterfill_rounds_f32(
            caps, src, dst, eg_cap, in_cap, eid, ed_cap, active,
            n_iters=n_iters,
        )
    if dev.type != "cuda":
        raise ValueError(f"no water-filling kernel for device {dev}")

    from .build import load

    lib = load()
    i32 = torch.int32
    _check(caps, "caps", dtype, nc, dev)
    _check(src, "src", i32, nc, dev)
    _check(dst, "dst", i32, nc, dev)
    _check(eg_cap, "eg_cap", dtype, nv, dev)
    _check(in_cap, "in_cap", dtype, nv, dev)
    _check(active, "active", torch.bool, nc, dev)
    if ed_cap is not None:
        _check(eid, "eid", i32, nc, dev)
        _check(ed_cap, "ed_cap", dtype, ne, dev)
    if changed is not None:
        _check(changed.reshape(1), "changed", torch.bool, 1, dev)
        _check(prev, "prev", dtype, nc, dev)
    elem = 8 if dtype == torch.float64 else 4
    if lanes is not None:
        _check(lanes, "lanes", torch.uint8, lanes.shape[0], dev)
        if lanes.shape[0] < lib.waterfill_scratch_bytes(nc, elem):
            raise ValueError(f"lanes holds {lanes.shape[0]} bytes, fewer "
                             f"than {nc} connections need")
        kmax = lib.waterfill_cluster_max()
        if kmax < 0:
            raise RuntimeError(f"the cluster size query failed: CUDA error "
                               f"{-kmax}")
        if lib.waterfill_cluster_plan(nc, nv, ne, elem, kmax) == 0:
            raise ValueError(f"{nv} VMs and {ne} edges do not fit one "
                             "block's shared memory")
        if clocks is not None:
            _check(clocks, "clocks", torch.int64, 128, dev)
    elif clocks is not None:
        raise ValueError("clocks go with the cluster kernel (lanes)")
    elif needs_cluster(nc, nv, ne, precision):
        raise ValueError(
            f"{nc} connections, {nv} VMs and {ne} edges do not fit one "
            "block's shared memory"
        )
    if segments is None:
        segments = build_segments(src, dst, eid if ne else None, nv, ne)
    out = torch.empty(nc, dtype=dtype, device=dev)
    if nc == 0:
        return out

    def ptr(t):
        return None if t is None else t.data_ptr()

    name = f"waterfill_{precision}"
    staged = lanes is None and precision == "f64"
    if lanes is not None:
        name, scratch, clk = f"{name}_cluster", (ptr(lanes),), (ptr(clocks),)
    else:
        scratch = clk = ()
    if staged:
        name = f"{name}_shared"
    rc = getattr(lib, name)(
        ptr(caps), ptr(src), ptr(dst), ptr(eid), ptr(eg_cap), ptr(in_cap),
        ptr(ed_cap), ptr(active), ptr(changed), ptr(prev),
        *(ptr(t) for t in segments), *scratch, ptr(out), nc, nv, ne,
        n_edges_bound, -1 if precision == "f64" else n_iters, *clk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _count((_launches if lanes is None else _cluster_launches)[precision])
    if staged:
        _count(_shared_launches)
    return out


def segment_sum_ordered(values, seg, n_segments: int, *,
                        lists: tuple[torch.Tensor, torch.Tensor] | None = None
                        ) -> torch.Tensor:
    """f64 ``out[s] = 0.0 + values[i0] + values[i1] + ...`` over the lanes
    with ``seg[i] == s`` in ascending lane order, on any device.
    ``lists`` is ``csr(seg, n_segments)``, built once by callers that sum
    over the same map many times."""
    refuse_dtensor("segment sum", values, seg)
    if values.device.type == "cpu":
        return ref.segment_sum_ordered(values, seg, n_segments)
    if values.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {values.device}")
    from .build import load

    lib = load()
    if lists is None:
        lists = csr(seg, n_segments)
    off, idx = lists
    n = values.shape[0]
    _check(values, "values", torch.float64, n, values.device)
    _check(off, "offsets", torch.int32, n_segments + 1, values.device)
    _check(idx, "lanes", torch.int32, n, values.device)
    out = torch.empty(n_segments, dtype=torch.float64, device=values.device)
    rc = lib.segsum_ordered_f64(
        values.data_ptr(), off.data_ptr(), idx.data_ptr(), out.data_ptr(),
        n_segments, torch.cuda.current_stream(values.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"segment-sum kernel launch failed: CUDA error {rc}")
    _count(_segsum_launches)
    return out
