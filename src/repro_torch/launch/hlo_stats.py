"""Roofline terms of one recorded step (the port of
``repro/launch/hlo_stats.py``).

The reference reads an AOT-compiled XLA executable: FLOPs and bytes from
``compiled.cost_analysis()``, memory from ``compiled.memory_analysis()``
and collective traffic from the HLO text. PyTorch compiles nothing ahead
of time, so the port runs the step once, eagerly, on ``meta`` tensors
(shapes and types, no storage) under ``StepRecorder``, a
``TorchDispatchMode`` that sees every operator the step issues, and reads
the same numbers from what it saw:

  * FLOPs: ``torch.utils.flop_counter``'s formulas, the ones
    ``FlopCounterMode`` applies (matrix products, convolutions, attention;
    elementwise ops count 0, as there). THE RULE: every op is counted once,
    at its local size. An op on DTensors is not counted itself: the mode
    hands it back (``NotImplemented``) to DTensor, whose local ops on each
    rank's shards then come back through the mode and are counted. DTensor
    also runs each op once at global size on fake tensors to infer its
    output's shape; ops on fake tensors are skipped. So one device's count
    is what that device computes, and on a one-rank mesh it is what
    ``FlopCounterMode`` counts for the same step on plain tensors.
  * bytes: each counted op's operands plus its outputs (views and
    ``empty`` allocations move none). This is the eager counterpart of
    XLA's "bytes accessed"; eager PyTorch fuses nothing, so every
    intermediate is written and read back and the count runs larger than
    a fused program's. An indexed op moves only the elements its index
    names: a selector (``index_select``, ``gather``, ``embedding``,
    advanced indexing) its other operands plus its output twice (read,
    then written); an in-place writer (``index_copy_``, ``index_put_``,
    ``index_add_``, the ``scatter_`` family) its other operands plus the
    elements it writes, twice where it adds to them.
  * collectives: each ``_c10d_functional`` op (DTensor's redistributions)
    and each ``c10d`` op by kind, result bytes and group size, and each
    hop of the pod ring (``note_hop``), all priced by ``wire_bytes``.
  * kernels: a kernel's meta route reports what it reads and writes
    (``note_kernel``); both reports reach the recorder through
    ``device.note_meta``.
  * memory: the live bytes of the storages the step allocates, tracked
    from allocation to release; their peak gives ``temp_bytes``.

The hardware constants are an H100 SXM5's, the card "H100 80GB HBM3" at
700 W (NVIDIA H100 Tensor Core GPU datasheet): dense bf16 tensor-core
FLOP/s, HBM3 bandwidth, and NVLink 4's bandwidth in one direction. The
one-term collective model prices every mesh axis at that one link, the
``pod`` axis too, as the reference prices its DCN at ICI; no measured
number exists for either.

Eager execution runs every layer, so the counts are trip-faithful as
they are: the reference's two-probe extrapolation over scanned layer
groups has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math
import re
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# H100 SXM5 (NVIDIA H100 Tensor Core GPU datasheet)
PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s per card
ICI_BW = 450e9  # NVLink 4 bytes/s per card, one direction (900e9 both ways)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16, "s4": 1, "u4": 1,
}

_COLL_RE = re.compile(
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?(?:\.\d+)?\("
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(type_str: str) -> int:
    """'f32[16,128]' or '(f32[2], s32[4])' -> total bytes."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveStats:
    counts: dict  # op kind -> count
    result_bytes: dict  # op kind -> total result bytes (per device)
    wire_bytes: float  # estimated bytes moved on the interconnect per device

    def as_dict(self):
        return {
            "counts": self.counts,
            "result_bytes": self.result_bytes,
            "wire_bytes": self.wire_bytes,
        }


def wire_bytes(kind: str, result_bytes: float, group_size: int) -> float:
    """Ring-algorithm wire estimate (bytes leaving/entering one device) of
    one collective whose result is ``result_bytes`` over ``group_size``
    devices:

      all-gather:          result * (g-1)/g     (receives all other shards)
      reduce-scatter:      input  * (g-1)/g  == result * (g-1)
      all-reduce:          2 * shard * (g-1)/g  ~= 2 * result * (g-1)/g
      all-to-all:          result * (g-1)/g
      collective-permute:  result               (send + receive one buffer)
    """
    if group_size <= 1:
        return 0.0
    frac = (group_size - 1) / group_size
    if kind == "all-gather":
        return result_bytes * frac
    if kind == "reduce-scatter":
        return result_bytes * (group_size - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * frac
    if kind == "all-to-all":
        return result_bytes * frac
    return result_bytes  # collective-permute


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """Collect per-device collective traffic from compiled HLO text, priced
    by ``wire_bytes``."""
    counts: dict = {}
    result_bytes: dict = {}
    wire = 0.0
    for line in hlo_text.splitlines():
        line = line.strip()
        m = _COLL_RE.search(line)
        if not m or " = " not in line:
            continue
        kind = m.group(1)
        # result type sits between '=' and the op name:
        #   %all-gather.1 = f32[96,576]{0,1} all-gather(%x), replica_groups=...
        rhs = line.split(" = ", 1)[1]
        type_seg = rhs.split(kind, 1)[0]
        rb = _shape_bytes(type_seg)
        if rb == 0:
            continue
        gm = _GROUPS_RE.search(line)
        if gm:
            gsize = int(gm.group(2))
        else:
            gm2 = re.search(r"replica_groups=\{\{([\d,]+)\}", line)
            gsize = len(gm2.group(1).split(",")) if gm2 else 2
        counts[kind] = counts.get(kind, 0) + 1
        result_bytes[kind] = result_bytes.get(kind, 0) + rb
        wire += wire_bytes(kind, rb, gsize)
    return CollectiveStats(counts, result_bytes, wire)


def cost_stats(step: "StepRecorder") -> dict:
    return {
        "flops_per_device": float(step.flops),
        "bytes_per_device": float(step.bytes),
    }


def memory_stats(step: "StepRecorder") -> dict:
    """The reference's keys; ``code_bytes`` is 0, as no code is
    generated."""
    return {
        "argument_bytes": int(step.argument_bytes),
        "output_bytes": int(step.output_bytes),
        "temp_bytes": int(step.temp_bytes),
        "alias_bytes": int(step.alias_bytes),
        "code_bytes": 0,
    }


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   wire_bytes_per_dev: float) -> dict:
    """The three roofline terms in seconds (per-device program, so chips
    cancel out of the brief's formulas)."""
    return {
        "compute_s": flops_per_dev / PEAK_FLOPS,
        "memory_s": bytes_per_dev / HBM_BW,
        "collective_s": wire_bytes_per_dev / ICI_BW,
    }


def dominant_term(terms: dict) -> str:
    key = max(
        ("compute_s", "memory_s", "collective_s"), key=lambda k: terms.get(k, 0.0)
    )
    return {"compute_s": "compute", "memory_s": "memory",
            "collective_s": "collective"}[key]


# ------------------------------------------------------------ the recorder
def _kind_of(func) -> str | None:
    """The reference's name of a c10d op's collective, or None."""
    name = func._overloadpacket.__name__
    if func.namespace not in ("_c10d_functional", "c10d"):
        return None
    for key, kind in (("all_gather", "all-gather"), ("allgather", "all-gather"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                      ("all_reduce", "all-reduce"), ("allreduce", "all-reduce")):
        if name.startswith(key):
            return kind
    return None


def _bound(func, args, kwargs) -> dict:
    """An op's arguments by their schema names."""
    bound = dict(zip((a.name for a in func._schema.arguments), args))
    bound.update(kwargs)
    return bound


def _group_size(func, args, kwargs) -> int:
    """The group size a c10d op runs over: its ``group_size`` argument,
    else its process group's (by object or by registered name)."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    bound = _bound(func, args, kwargs)
    if "group_size" in bound:
        return int(bound["group_size"])
    for key in ("group_name", "process_group", "group"):
        g = bound.get(key)
        if g is None:
            continue
        if isinstance(g, str):
            g = _resolve_process_group(g)
        elif not isinstance(g, ProcessGroup):  # as the c10d ops box it
            g = ProcessGroup.unbox(g)
        return int(g.size())
    raise ValueError(f"no group of {func}")


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# ops that query a tensor's metadata; FlopCounterMode leaves them alone too
_QUERIES = {"sym_is_contiguous", "is_contiguous", "is_strides_like_format",
            "is_non_overlapping_and_dense", "size", "sym_size", "stride",
            "sym_stride", "storage_offset", "sym_storage_offset", "numel",
            "sym_numel", "dim", "layout"}
# ops that allocate without writing, or only wrap what exists
_NO_BYTES = {"empty", "empty_like", "empty_strided", "wait_tensor",
             "_wrap_tensor_autograd", "lift_fresh"}

# indexed ops (module docstring): selectors, and in-place writers with
# whether they add to what they write (an argument's name, or always)
_SELECTORS = {"index", "index_select", "gather", "embedding"}
_WRITERS = {"index_copy_": False, "index_put_": "accumulate",
            "index_add_": True, "scatter_": "reduce", "scatter_add_": True,
            "scatter_reduce_": True}


def _written(name: str, bound: dict) -> int:
    """How many elements of its destination an in-place writer writes."""
    if name in ("index_copy_", "index_add_"):
        return bound["source"].numel()
    if name == "index_put_":
        dst, idx = bound["self"], list(bound["indices"])
        idx += [None] * (dst.ndim - len(idx))
        picked = torch.broadcast_shapes(*(i.shape for i in idx
                                          if i is not None))
        return math.prod(picked) * math.prod(
            n for n, i in zip(dst.shape, idx) if i is None)
    return bound["index"].numel()  # the scatter family


def _moved_bytes(func, args, kwargs, ins, outs) -> int:
    """The bytes one counted op moves (module docstring)."""
    name = func._overloadpacket.__name__
    if name in _SELECTORS:
        return (sum(_nbytes(t) for t in ins[1:])
                + 2 * sum(_nbytes(t) for t in outs))
    if name in _WRITERS:
        bound = _bound(func, args, kwargs)
        adds = _WRITERS[name]
        if isinstance(adds, str):
            adds = bool(bound.get(adds))
        return (sum(_nbytes(t) for t in ins[1:])
                + (1 + adds) * _written(name, bound) * ins[0].element_size())
    return sum(_nbytes(t) for t in (*ins, *outs))


class StepRecorder(TorchDispatchMode):
    """Record one step: ``with StepRecorder(args) as rec: step(*args)``,
    then ``rec.close(outputs)``. ``args`` is whatever the step reads (any
    tree of tensors and DTensors): its local bytes are
    ``argument_bytes``. The counts follow the module docstring's rules;
    ``collectives`` is a ``CollectiveStats``."""

    def __init__(self, args=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveStats({}, {}, 0.0)
        self._args = _storage_keys(args)
        self.argument_bytes = sum(self._args.values())
        self._live = 0
        self.peak_bytes = 0  # peak live bytes allocated inside the step
        self._tracked: dict[int, int] = {}
        self.output_bytes = self.alias_bytes = self.temp_bytes = 0

    def close(self, outputs=()) -> "StepRecorder":
        """Split the step's ``outputs`` into new bytes and bytes that alias
        an argument; ``temp_bytes`` is the peak less the new outputs."""
        for key, n in _storage_keys(outputs).items():
            if key in self._args:
                self.alias_bytes += n
            else:
                self.output_bytes += n
        self.temp_bytes = max(self.peak_bytes - self.output_bytes, 0)
        return self

    # -- what the meta routes of the kernels and the ring report, through
    # ``device.note_meta``
    def note_kernel(self, reads, writes) -> None:
        """A kernel that ``reads`` and ``writes`` these tensors (each once)
        and computes no FLOPs that ``flop_counter`` would count."""
        self.bytes += sum(_nbytes(t) for t in (*reads, *writes))
        self._track(writes)

    def note_hop(self, received, group_size: int) -> None:
        """One hop of the pod ring: a collective-permute per received
        tensor."""
        for t in received:
            self._collective("collective-permute", _nbytes(t), group_size)
            self.bytes += 2 * _nbytes(t)
        self._track(received)

    # -- the dispatch
    def _collective(self, kind: str, result: int, group_size: int) -> None:
        c = self.collectives
        c.counts[kind] = c.counts.get(kind, 0) + 1
        c.result_bytes[kind] = c.result_bytes.get(kind, 0) + result
        c.wire_bytes += wire_bytes(kind, result, group_size)

    def _track(self, outputs) -> None:
        for t in outputs:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._tracked or key in self._args:
                continue
            self._tracked[key] = n = st.nbytes()
            self._live += n
            self.peak_bytes = max(self.peak_bytes, self._live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._live -= self._tracked.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor

        from repro_torch.device import is_dtensor

        kwargs = kwargs or {}
        name = func._overloadpacket.__name__
        if name in _QUERIES:
            return NotImplemented
        ins = _tensors((args, kwargs))
        if any(is_dtensor(t) for t in ins):
            return NotImplemented  # DTensor runs it; its local ops come back
        if any(isinstance(t, FakeTensor) for t in ins):
            return func(*args, **kwargs)  # DTensor's shape inference
        if (func._overloadpacket not in self._formulas
                and func.namespace != "prim"):
            # as FlopCounterMode: a composite op reaching the mode (inference
            # mode) is counted through its decomposition
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            return out
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        kind = _kind_of(func)
        if kind is not None:
            self._collective(kind, sum(_nbytes(t) for t in outs),
                             _group_size(func, args, kwargs))
        if not (func.is_view or name in _NO_BYTES):
            self.bytes += _moved_bytes(func, args, kwargs, ins, outs)
        self._track(outs)
        return out


def _storage_keys(tree) -> dict[int, int]:
    """{storage id: bytes} of the local data of every tensor in ``tree``
    (a DTensor's local shard), each storage once."""
    from repro_torch.device import is_dtensor

    out = {}
    for t in _tensors(tree):
        if is_dtensor(t):
            t = t.to_local()
        st = t.untyped_storage()
        out[id(st)] = st.nbytes()
    return out
