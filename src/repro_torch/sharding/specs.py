"""Logical-axis sharding rules (MaxText-style), the port of
``repro/sharding/specs.py``.

Model code annotates tensors with *logical* axis names ("batch", "heads",
"ff", ...). A ``ShardingRules`` instance maps each logical name to zero or
more *mesh* axes. Changing the parallelism scheme means swapping rules,
never touching model code.

Default scheme:
  batch   -> ("pod", "data")   pure DP over pods, batch-DP within a pod
  fsdp    -> "data"            parameters fully sharded over the data axis
  tp      -> "model"           tensor parallelism (heads / ff / vocab / experts)
  seq     -> None              (context parallelism only for long-decode rules)

torch has no ``PartitionSpec``: ``P`` is a tuple of the same entries (one
per tensor dim: None, a mesh axis name, or a tuple of names), and
``NamedSharding(mesh, spec).placements()`` turns it into DTensor
placements, one ``Shard(dim)`` or ``Replicate()`` per mesh dimension. A
mesh is anything with axis names and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``,
``shape``) or an object with ``axis_names`` and ``devices.shape`` as the
reference's test meshes have (``mesh_axis_sizes`` reads both).

Mesh plumbing: the launcher calls ``set_mesh(mesh)``; ``shard_constraint``
then redistributes a DTensor to the spec's placements. A plain tensor
passes unchanged (the pod ring's ranks run the models on plain local
tensors), as does everything with no mesh set; the reference's
constraint never changes values either.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Sequence

from repro_torch.device import is_dtensor

_state = threading.local()


def set_mesh(mesh) -> None:
    _state.mesh = mesh


def current_mesh():
    return getattr(_state, "mesh", None)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a DeviceMesh or of a mesh with ``axis_names``
    and ``devices.shape``, in the mesh's axis order."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


class P(tuple):
    """A partition spec: one entry per tensor dim, each None, a mesh axis
    name, or a tuple of mesh axis names (sharded over their product)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh; ``placements()`` gives its DTensor placements."""

    mesh: Any
    spec: P

    def placements(self) -> tuple:
        """One placement per mesh axis: ``Shard(d)`` where tensor dim ``d``
        names the axis, else ``Replicate()``. A dim sharded over several
        axes lists them in mesh order (major first), which is how DTensor
        splits a dim that several mesh dims shard."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_axis_sizes(self.mesh))
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, tuple) else (entry,)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(
                    f"dim {d} sharded over {axes}, not in the mesh's "
                    f"order {tuple(names)}"
                )
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axes (str, tuple of str, or None)."""

    batch: Any = ("pod", "data")
    fsdp: Any = "data"  # parameter sharding (ZeRO-3 style)
    tp: Any = "model"  # tensor parallel
    seq: Any = None  # sequence/context parallel
    expert: Any = "model"  # expert parallel
    # set fsdp_pod to also shard params/optimizer over the pod axis (ZeRO-3
    # across pods; trades parameter all-gather traffic on DCN for memory).
    fsdp_pod: bool = False

    def resolve(self, logical: str | None):
        if logical is None or logical == "layers":
            return None  # the stacked-layer axis is never sharded
        return {
            "batch": self.batch,
            "fsdp": self._fsdp_axes(),
            "tp": self.tp,
            "seq": self.seq,
            "expert": self.expert,
        }[logical]

    def _fsdp_axes(self):
        if self.fsdp is None:
            return None
        if self.fsdp_pod:
            base = self.fsdp if isinstance(self.fsdp, tuple) else (self.fsdp,)
            return ("pod",) + base
        return self.fsdp

    def filter_for_mesh(self, mesh) -> "ShardingRules":
        """Drop references to mesh axes that don't exist (e.g. 'pod' on the
        single-pod mesh)."""
        if mesh is None:
            return self
        names = set(mesh_axis_sizes(mesh))

        def keep(v):
            if v is None:
                return None
            if isinstance(v, tuple):
                kept = tuple(a for a in v if a in names)
                return kept if kept else None
            return v if v in names else None

        return dataclasses.replace(
            self,
            batch=keep(self.batch),
            fsdp=keep(self.fsdp),
            tp=keep(self.tp),
            seq=keep(self.seq),
            expert=keep(self.expert),
            fsdp_pod=self.fsdp_pod and "pod" in names,
        )


def logical_to_physical(
    rules: ShardingRules,
    logical: Sequence[str | None],
    shape: Sequence[int] | None = None,
    mesh=None,
) -> P:
    """Resolve logical axes to a partition spec.

    Shape-aware: a mesh axis (product) that does not evenly divide the dim is
    dropped (the dim stays replicated), as the reference does for its jit
    shardings; several pool archs have head counts that don't divide the
    16-wide model axis (e.g. qwen2's 28 heads / 8 kv heads), and those dims
    fall back to replication.
    """
    sizes = mesh_axis_sizes(mesh) if mesh is not None else {}
    axes = []
    used: set[str] = set()
    for d, name in enumerate(logical):
        ax = rules.resolve(name)
        if ax is None:
            axes.append(None)
            continue
        flat = ax if isinstance(ax, tuple) else (ax,)
        flat = tuple(a for a in flat if a not in used)
        if shape is not None and sizes:
            prod = 1
            for a in flat:
                prod *= sizes.get(a, 1)
            if prod == 0 or (prod and shape[d] % prod != 0):
                # try dropping trailing axes until it divides
                while flat:
                    prod = 1
                    for a in flat:
                        prod *= sizes.get(a, 1)
                    if prod and shape[d] % prod == 0:
                        break
                    flat = flat[:-1]
                if not flat:
                    axes.append(None)
                    continue
                prod = 1
                for a in flat:
                    prod *= sizes.get(a, 1)
                if shape[d] % prod != 0:
                    axes.append(None)
                    continue
        used.update(flat)
        axes.append(flat if len(flat) > 1 else (flat[0] if flat else None))
    return P(*axes)


def shard_constraint(x, rules: ShardingRules, *logical: str | None):
    """A DTensor redistributed to the logical spec's placements while a
    mesh is set; anything else as it is."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = logical_to_physical(
        rules.filter_for_mesh(mesh), logical, shape=x.shape, mesh=mesh
    )
    return x.redistribute(x.device_mesh, NamedSharding(mesh, spec).placements())


def from_local(local, mesh, placements, shape):
    """The DTensor of global ``shape`` (contiguous) whose shard on this
    rank is ``local``, on ``placements``: the far side of a boundary where
    the model hands local shards to a kernel or a plain function."""
    import torch
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(
        local.contiguous(), mesh, list(placements), run_check=False,
        shape=tuple(shape),
        stride=torch.empty(tuple(shape), device="meta").stride())


def local_call(fn, args, in_placements, out_placements, out_shapes,
               grad_placements=None):
    """``fn`` on this rank's shards of the DTensors ``args``, its output
    (or each of a tuple of them) back as the DTensor of global shape
    ``out_shapes`` on ``out_placements``: the one boundary where the model
    hands a kernel or a plain function what one rank holds. Each arg is
    first redistributed to its entry of ``in_placements`` (None passes the
    arg as it is); ``grad_placements`` (default ``in_placements``) lays
    out its gradient's shard, ``Partial`` where every rank adds a part.
    torch's ``local_map`` does the same but infers each output's global
    shape from even shards."""
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    grads = in_placements if grad_placements is None else grad_placements
    out = fn(*(a if pl is None else
               a.redistribute(mesh, pl).to_local(grad_placements=g)
               for a, pl, g in zip(args, in_placements, grads)))
    if isinstance(out, tuple):
        return tuple(from_local(o, mesh, pl, sh) for o, pl, sh
                     in zip(out, out_placements, out_shapes))
    return from_local(out, mesh, out_placements, out_shapes)


def kernel_split(x, *head_counts: int, heads: int = 2) -> list:
    """Per mesh axis of DTensor ``x``, how a kernel that works per batch
    row and head (flash attention, the SSD scan) takes it as local shards
    that compute the same function: "batch" where the axis cuts dim 0,
    "heads" where it cuts dim ``heads`` into shards that hold whole groups
    of every one of ``head_counts`` (GQA's query and kv heads), else None:
    gathered first (the sequence, uneven heads)."""
    from torch.distributed.tensor import Shard

    n = shards_of(x, heads)
    whole = all(c % n == 0 for c in head_counts)
    return ["batch" if pl == Shard(0) else
            "heads" if pl == Shard(heads) and whole else None
            for pl in x.placements]


def replicate_like(t, ref):
    """A plain tensor ``t`` as a DTensor replicated over the mesh of
    ``ref`` when ``ref`` is a DTensor; else ``t``. DTensor refuses an op
    that mixes a DTensor with a plain tensor of more than one element (the
    masks, frequencies and index ranges a layer builds), in the backward
    pass too."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    mesh = ref.device_mesh
    return from_local(t, mesh, [Replicate()] * mesh.ndim, t.shape)


def shards_of(x, dim: int) -> int:
    """Into how many pieces the mesh axes of DTensor ``x`` cut its tensor
    dim ``dim`` (1 for anything else)."""
    if not is_dtensor(x):
        return 1
    from torch.distributed.tensor import Shard

    n = 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim % x.ndim:
            n *= x.device_mesh.size(i)
    return n


def shard_offset(x, dim: int) -> int:
    """Where this rank's shard of DTensor ``x`` starts along ``dim`` (0
    where no mesh axis cuts it). Each axis that cuts ``dim``, in mesh
    order, splits what the axes before it left as ``torch.chunk`` does:
    pieces of ceil(n / k), the last ones short or empty."""
    from torch.distributed.tensor import Shard

    mesh, dim = x.device_mesh, dim % x.ndim
    coord = mesh.get_coordinate()
    start, size = 0, x.shape[dim]
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            chunk = -(-size // mesh.size(i))
            lo = min(coord[i] * chunk, size)
            start, size = start + lo, min(chunk, size - lo)
    return start


def unshard(x, *dims: int):
    """A DTensor redistributed so that no mesh axis shards tensor dims
    ``dims`` (every dim when none is named) and no partial sum is left
    pending; anything else as it is. The model stack calls it where
    DTensor has no sharding strategy for an op on a sharded dim: GSPMD
    replicates that dim there too."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    nd = max(x.ndim, 1)
    drop = {d % nd for d in dims} if dims else set(range(nd))
    out = [pl if isinstance(pl, Shard) and pl.dim not in drop
           else Replicate() for pl in x.placements]
    if out == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, out)


def device_put(tree, shardings):
    """Each tensor of ``tree`` as a DTensor placed by the ``NamedSharding``
    at the same path of ``shardings``: the port of ``jax.device_put(tree,
    shardings)``. Rank 0's values are the ones scattered
    (``src_data_rank=0``), so every rank holds the same global tensor
    whatever its own copy held; a DTensor is redistributed. Trees are
    nested dicts."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.tree import tree_map

    def put(t, sh):
        if is_dtensor(t):
            return t.redistribute(sh.mesh, sh.placements())
        return distribute_tensor(t, sh.mesh, sh.placements(),
                                 src_data_rank=0)

    return tree_map(put, tree, shardings)


def make_param_shardings(mesh, rules: ShardingRules, abstract_tree):
    """Tree of ParamDef -> tree of NamedSharding (shape-aware)."""
    from repro_torch.models.params import tree_map_defs

    rules = rules.filter_for_mesh(mesh)
    return tree_map_defs(
        lambda pd: NamedSharding(
            mesh, logical_to_physical(rules, pd.logical, pd.shape, mesh)
        ),
        abstract_tree,
    )


def shardings_for(mesh, rules: ShardingRules, logical_tree, sds_tree):
    """(logical tuples tree, tree of anything with a ``shape``) ->
    NamedSharding tree. Trees are nested dicts; a logical tuple is a
    leaf."""
    from repro_torch.tree import tree_map

    rules = rules.filter_for_mesh(mesh)
    return tree_map(
        lambda spec, sds: NamedSharding(
            mesh, logical_to_physical(rules, spec, sds.shape, mesh)
        ),
        logical_tree,
        sds_tree,
    )
