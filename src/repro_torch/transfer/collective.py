"""Planner-scheduled inter-pod collectives (the port of
``repro/transfer/collective.py``).

The pod axis of a multi-pod mesh crosses slow, heterogeneous links that
(across regions and clouds) are *billed per byte*: exactly the setting of
Skyplane's planner. This module reduces data-parallel gradients over the
pod axis as an explicit ring of point-to-point messages
(``torch.distributed``), one rank per pod:

  * the ring order comes from a Skyplane-style bottleneck-max heuristic over
    the pod-level throughput grid (choose_ring_order);
  * each tensor is cut into one segment per rank, so reduce-scatter and
    all-gather take ``n - 1`` hops each;
  * optional int8 on-wire compression cuts the bytes 4x (the egress-volume
    lever of paper §2 applied to gradients).

The reference names the pod axis inside a ``shard_map``; here the axis is
the pod dimension's process group (``mesh.get_group("pod")``), and a rank
of that group sits at ring position ``order.index(rank)``. Each hop is one
``batch_isend_irecv`` of a send to the ring's successor and a receive from
its predecessor (blocking sends around a ring would deadlock). On a gloo
group the wire runs through host memory (gloo's point-to-point ops take
CPU tensors); on NCCL it stays on the device.

Compression quantizes through ``kernels.quantize``: the plain version for
tensors on the CPU, the hand-written CUDA kernels for tensors on the card
(the reference's jnp quantizer, which XLA fuses, has them as its
counterpart; they give the plain version's bits). There is no fallback: a
kernel that fails to build or launch raises. Adds keep the reference's
order (own term first), padding is zeros, and the mean multiplies by a 0-d
tensor of ``1/n`` (as XLA computes the reference's ``r / n``), so the card,
the CPU and the uncompressed reference give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.device import note_meta
from repro_torch.kernels.quantize import ops as qops
from repro_torch.sharding.specs import mesh_axis_sizes
from repro_torch.tree import tree_leaves, tree_unflatten


def choose_ring_order(pod_tput: np.ndarray) -> list[int]:
    """Order pods to maximize the minimum link throughput along the ring
    (greedy nearest-neighbor on the bottleneck metric — the RON-style
    heuristic specialized to a Hamiltonian cycle)."""
    n = pod_tput.shape[0]
    if n <= 2:
        return list(range(n))
    order = [0]
    left = set(range(1, n))
    while left:
        cur = order[-1]
        nxt = max(left, key=lambda j: min(pod_tput[cur, j], pod_tput[j, cur]))
        order.append(nxt)
        left.remove(nxt)
    return order


def _wire_device(t: torch.Tensor, group) -> torch.device:
    """Where a message crosses: host memory on gloo, else the tensor's
    own device (``meta`` stays ``meta``: it has no data to stage)."""
    if dist.get_backend(group) == "gloo" and t.device.type != "meta":
        return torch.device("cpu")
    return t.device


def _exchange(tensors: list, group, dst: int, src: int) -> list:
    """Send ``tensors`` to group rank ``dst`` and receive as many of the
    same shapes and types from group rank ``src``, in one batch. Meta
    tensors (the dry run) move nothing: the received ones are allocated
    and the hop is reported to the active step recorder."""
    wire = _wire_device(tensors[0], group)
    if wire.type == "meta":
        recv = [torch.empty_like(t) for t in tensors]
        note_meta("hop", recv, dist.get_world_size(group))
        return recv
    out = [t.to(wire).contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in out]
    g_dst = dist.get_global_rank(group, dst) if group is not None else dst
    g_src = dist.get_global_rank(group, src) if group is not None else src
    ops = [dist.P2POp(dist.isend, t, g_dst, group, tag)
           for tag, t in enumerate(out)]
    ops += [dist.P2POp(dist.irecv, t, g_src, group, tag)
            for tag, t in enumerate(recv)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)]


def _ring_peers(group, order: list[int]) -> tuple[int, int, int]:
    """(ring position, successor's group rank, predecessor's group rank)."""
    n = len(order)
    pos = order.index(dist.get_rank(group))
    return pos, order[(pos + 1) % n], order[(pos - 1) % n]


def _send(seg, group, order: list[int], compress_wire: bool, block: int):
    """Move one ring segment to the next rank. With compression the WIRE
    carries int8 + per-block scales (4x fewer bytes); the receiver
    dequantizes. Without it, the raw floats move."""
    _, nxt, prv = _ring_peers(group, order)
    if not compress_wire:
        return _exchange([seg], group, nxt, prv)[0]
    q, scales = qops.quantize_int8(seg, block=block)
    q_r, s_r = _exchange([q, scales], group, nxt, prv)
    return qops.dequantize_int8(q_r, s_r, block=block).to(seg.dtype)


def _quant_lastaxis(x, block: int):
    """int8 quantization in blocks along the LAST axis only (the last axis
    padded with zeros to a multiple of ``block``): the padded tensor, read
    as rows of ``block``, is the quantize kernels' layout. Returns (q
    [..., n_blocks, block], scales [..., n_blocks], pad)."""
    last = x.shape[-1]
    pad = (-last) % block
    xp = F.pad(x.to(torch.float32), (0, pad)) if pad else x
    q, scales = qops.quantize_int8(xp, block=block)
    lead = xp.shape[:-1]
    return (q.reshape(*lead, -1, block), scales.reshape(*lead, -1), pad)


def _dequant_lastaxis(q, scale, pad: int, out_shape):
    x = qops.dequantize_int8(q, scale.reshape(-1).contiguous(),
                             block=q.shape[-1])
    x = x.reshape(*x.shape[:-2], -1)
    if pad:
        x = x[..., :-pad]
    return x.reshape(out_shape)


def _exchange_reduce_pair(x, group, *, compress_wire: bool, block: int):
    """2-pod all-reduce: one exchange of the whole tensor each way,
    optionally int8 on the wire."""
    other_rank = 1 - dist.get_rank(group)
    if not compress_wire:
        return x + _exchange([x], group, other_rank, other_rank)[0]
    q, scale, pad = _quant_lastaxis(x, block)
    q_r, s_r = _exchange([q, scale], group, other_rank, other_rank)
    other = _dequant_lastaxis(q_r, s_r, pad, x.shape).to(x.dtype)
    # symmetric lossy view: quantize our own contribution identically so
    # both pods hold bit-identical parameters afterwards
    own = _dequant_lastaxis(q, scale, pad, x.shape).to(x.dtype)
    return own + other


def _ring_allreduce(x, group, order: list[int], *,
                    compress_wire: bool = False, block: int = 256):
    """Ring all-reduce over ``group`` in the planner's ring order.

    reduce-scatter + all-gather, ``n-1`` steps each. With compression,
    each hop quantizes its outgoing segment. The 2-pod case
    short-circuits to a pairwise exchange (see _exchange_reduce_pair)."""
    n = len(order)
    if n <= 1:
        return x
    if n == 2:
        return _exchange_reduce_pair(
            x, group, compress_wire=compress_wire, block=block
        )
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % n
    acc = F.pad(flat, (0, pad)).reshape(n, -1).clone()
    pos, _, _ = _ring_peers(group, order)
    # ---- reduce-scatter: after n-1 steps, rank at ring position i owns the
    # fully-reduced segment (i+1) % n
    for k in range(n - 1):
        recv = _send(acc[(pos - k) % n], group, order, compress_wire, block)
        recv_ix = (pos - k - 1) % n
        acc[recv_ix] = acc[recv_ix] + recv
    # ---- all-gather: rank at position i owns segment (i+1); at step k it
    # sends segment (i+1-k) (own first, then forward what it received) and
    # receives segment (i-k) from its predecessor.
    for k in range(n - 1):
        recv = _send(acc[(pos + 1 - k) % n], group, order, compress_wire,
                     block)
        acc[(pos - k) % n] = recv
    out = acc.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


def ring_allreduce_tree(grads, group, order: list[int], *,
                        compress_wire: bool = False, mean: bool = True):
    """All-reduce a tree over ``group`` (None: the default group) with the
    planner's ring; every rank of the group must call it with trees of the
    same keys and shapes. Leaves go round one after another in sorted key
    order."""
    n = len(order)
    if n != dist.get_world_size(group):
        raise ValueError(f"ring of {n} over a group of "
                         f"{dist.get_world_size(group)}")

    def one(g):
        r = _ring_allreduce(g, group, order, compress_wire=compress_wire)
        return mean_of_sum(r, n) if mean else r

    return tree_unflatten(grads, [one(g) for g in tree_leaves(grads)])


def mean_of_sum(total, n: int):
    """``total / n`` as the reference's jitted ``r / n`` computes it: XLA
    rewrites a division by a constant as a product with its reciprocal,
    rounded to the operand's type. A 0-d tensor factor, so the card and
    the CPU multiply alike (a Python scalar takes other routes on each)."""
    inv = torch.tensor(1.0 / n, dtype=total.dtype, device=total.device)
    return total * inv


def make_pod_gradient_reducer(mesh, *, pod_tput: np.ndarray | None = None,
                              compress_wire: bool = False, mean: bool = True):
    """Returns reduce(tree) -> tree over the 'pod' axis of a DeviceMesh with
    an explicit planner-ordered ring. The input tree holds this rank's
    per-pod partial values. None on single-pod meshes."""
    sizes = mesh_axis_sizes(mesh)
    if "pod" not in sizes:
        return None
    n_pods = sizes["pod"]
    if pod_tput is None:
        pod_tput = np.ones((n_pods, n_pods))
    order = choose_ring_order(pod_tput)
    group = mesh.get_group("pod")

    def reduce_tree(grads):
        return ring_allreduce_tree(
            grads, group, order, compress_wire=compress_wire, mean=mean
        )

    return reduce_tree
