"""Gradient compression for inter-pod reduction (the port of
``repro/transfer/compression.py``).

Skyplane's cost lever is *egress volume* (§2: transfers are billed per GB).
Across pods of accelerators the pod-to-pod links are the expensive, slow
resource, so the same lever applies: per-block symmetric int8
quantization cuts wire bytes 4x. Error feedback (Seide et al.;
Karimireddy et al. 2019) keeps SGD/Adam convergence: the quantization
residual is carried and re-added next step.

``use_pallas=True`` (the reference's name) quantizes through the port's
CUDA kernel on the card (``repro_torch.kernels.quantize``), and
``compress`` then dequantizes through its inverse kernel too, where the
reference dequantizes in plain jnp: both give the same bits. Trees are
nested dicts of tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quantize import ops as qops
from repro_torch.kernels.quantize import ref as qref
from repro_torch.sharding.specs import is_dtensor, local_call
from repro_torch.tree import tree_map


def quantize_int8_blockwise(x, block: int = 256, *, use_pallas: bool = False):
    """x: float tensor -> (q int8 [same shape], scales f32 [n_blocks])."""
    if use_pallas:
        return qops.quantize_int8(x, block=block)
    q, scales = qref.quantize_int8_flat(x.reshape(-1).to(torch.float32),
                                        block)
    return q.reshape(x.shape), scales


def dequantize_int8_blockwise(q, scales, block: int = 256):
    """-> f32 [q.numel()], flat, as in the reference."""
    return qref.dequantize_int8_flat(q.reshape(-1), scales, block)


def compress(x, block: int = 256, *, use_pallas: bool = False):
    """Lossy round-trip (the on-wire transform). The blocks run over the
    whole tensor flattened, across any shard's edges, so a DTensor is
    gathered whole, compressed on every rank, and handed back on its own
    placements (each rank keeps its shard)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        whole = [Replicate()] * x.device_mesh.ndim
        out = local_call(
            lambda t: compress(t, block, use_pallas=use_pallas), (x,),
            (whole,), whole, x.shape)
        return out.redistribute(x.device_mesh, x.placements)
    q, s = quantize_int8_blockwise(x, block, use_pallas=use_pallas)
    if use_pallas:
        out = qops.dequantize_int8(q, s, block=block)
    else:
        out = dequantize_int8_blockwise(q, s, block)
    return out.reshape(x.shape).to(x.dtype)


def init_error_feedback(params) -> dict:
    return tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params,
    )


def compress_with_error_feedback(grads, ef_state, block: int = 256,
                                 *, use_pallas: bool = False):
    """Returns (compressed_grads, new_ef_state)."""

    def one(g, e):
        corrected = g.to(torch.float32) + e
        sent = compress(corrected, block, use_pallas=use_pallas)
        return sent.to(g.dtype), corrected - sent

    out = tree_map(one, grads, ef_state)
    return _pick(out, 0), _pick(out, 1)


def _pick(tree, i: int):
    """Element ``i`` of every (sent, residual) pair of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
