"""Plain PyTorch versions of the water-filling kernels.

``masked_maxmin_rates`` is the f64 parity solver: a transliteration of
the reference package's ``kernels/waterfill/ref.py::masked_maxmin_rates``
(itself the masked form of the numpy sim's ``_maxmin_rates_arr``). It runs
the iterative bottleneck-saturation rounds over every padded lane, with
inactive lanes pinned at rate 0 and excluded from every count, share,
threshold and budget subtraction. On CPU tensors it is bitwise equal to
the numpy oracle on the active lanes: ``index_add_`` on the CPU adds its
lanes in index order, as numpy's ``bincount`` does, and the masked lanes
add ``+0.0``, which cannot change an IEEE sum.

``waterfill_rounds_f32`` transliterates the rounds of the TPU kernel
(``kernels/waterfill/waterfill.py::_waterfill_kernel`` in the reference
package): float32, ``BIG`` in place of +inf, saturation tolerance 1e-6
and a fixed round count.

``segment_sum_ordered`` is the plain version of the ordered segment sum
the sim uses for its per-(job, edge) telemetry.

These functions accept tensors on any device, but only on the CPU are
their floating sums taken in a fixed order; the CUDA kernels in
``csrc/waterfill.cu`` are held against them on CPU copies of the inputs.
"""

from __future__ import annotations

import torch

EPS64 = 1e-12  # saturation tolerance of the f64 solver (numpy sim's _EPS)
EPS32 = 1e-6  # saturation tolerance of the f32 (TPU-kernel) rounds
BIG = 1e30  # the f32 rounds' finite stand-in for +inf


def _segsum(w: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=w.dtype, device=w.device)
    return out.index_add_(0, idx, w)


def segment_sum_ordered(values: torch.Tensor, seg: torch.Tensor,
                        n_segments: int) -> torch.Tensor:
    """``out[s] = 0.0 + values[i0] + values[i1] + ...`` over the lanes i
    with ``seg[i] == s``, added in ascending lane order (on the CPU)."""
    return _segsum(values, seg, n_segments)


def masked_maxmin_rates(caps, src, dst, eg_cap, in_cap, eid, ed_cap, active,
                        *, n_vms: int, n_edges: int,
                        n_edges_bound: int | None = None) -> torch.Tensor:
    """Max-min fair rates over the ``active`` lanes of a padded conn set.

    caps/src/dst/eid/active are per-connection lanes; eg_cap and in_cap are
    per-VM budgets sized ``n_vms``; ed_cap is the shared per-edge budget
    sized ``n_edges``, or None when link contention is off. Returns
    per-lane rates, 0.0 on inactive lanes. ``n_edges_bound`` overrides the
    edge term of the round bound (callers that feed BIG edge budgets in
    place of "no contention" pass 0)."""
    active = active.to(torch.bool)
    # the numpy oracle bounds its rounds by the compacted VM count; recover
    # it from the active lanes so the trip count matches exactly
    nv = int(torch.where(active, torch.maximum(src, dst), -1).max()) + 1
    if n_edges_bound is None:
        n_edges_bound = n_edges if ed_cap is not None else 0
    bound = 2 * nv + n_edges_bound + 4
    inf = torch.tensor(float("inf"), dtype=caps.dtype, device=caps.device)
    rate = torch.zeros_like(caps)
    fixed = ~active
    eg, inn = eg_cap.clone(), in_cap.clone()
    ed = None if ed_cap is None else ed_cap.clone()
    k = 0
    while k < bound and bool((~fixed & active).any()):
        un = active & ~fixed
        unf = un.to(caps.dtype)
        cnt_out = _segsum(unf, src, n_vms)
        cnt_in = _segsum(unf, dst, n_vms)
        share_out = torch.where(cnt_out > 0, eg / cnt_out.clamp(min=1), inf)
        share_in = torch.where(cnt_in > 0, inn / cnt_in.clamp(min=1), inf)
        share = torch.minimum(share_out[src], share_in[dst])
        if ed is not None:
            cnt_ed = _segsum(unf, eid, n_edges)
            share_ed = torch.where(cnt_ed > 0, ed / cnt_ed.clamp(min=1), inf)
            share = torch.minimum(share, share_ed[eid])
        cap_hit = un & (caps <= share + EPS64)
        anyc = cap_hit.any()
        thresh = torch.where(un, share, inf).amin()
        newly = torch.where(anyc, cap_hit, un & (share <= thresh + EPS64))
        rate = torch.where(newly, torch.where(anyc, caps, share), rate)
        w = torch.where(newly, rate, 0.0)
        eg = torch.clamp(eg - _segsum(w, src, n_vms), min=0.0)
        inn = torch.clamp(inn - _segsum(w, dst, n_vms), min=0.0)
        if ed is not None:
            ed = torch.clamp(ed - _segsum(w, eid, n_edges), min=0.0)
        fixed = fixed | newly
        k += 1
    return rate


def waterfill_rounds_f32(caps, src, dst, eg_cap, in_cap, eid, ed_cap, active,
                         *, n_iters: int) -> torch.Tensor:
    """The TPU kernel's rounds in float32: per-VM/edge counts, the minimum
    fair share per lane, then either every lane whose own cap binds or
    every lane at the bottleneck threshold is fixed, and the fixed rates
    leave the budgets. ``ed_cap`` is required (callers without link
    contention pass one BIG edge). Rounds past convergence are no-ops."""
    f32 = torch.float32
    caps = caps.to(f32)
    active = active.to(torch.bool)
    big = torch.tensor(BIG, dtype=f32, device=caps.device)
    nv, ne = eg_cap.shape[0], ed_cap.shape[0]
    eg, inn, ed = eg_cap.to(f32), in_cap.to(f32), ed_cap.to(f32)
    rate = torch.zeros_like(caps)
    fixed = ~active
    for _ in range(n_iters):
        un = active & ~fixed
        unf = un.to(f32)
        cnt_out = _segsum(unf, src, nv)
        cnt_in = _segsum(unf, dst, nv)
        cnt_ed = _segsum(unf, eid, ne)
        share_out = torch.where(cnt_out > 0, eg / cnt_out.clamp(min=1), big)
        share_in = torch.where(cnt_in > 0, inn / cnt_in.clamp(min=1), big)
        share_ed = torch.where(cnt_ed > 0, ed / cnt_ed.clamp(min=1), big)
        share = torch.minimum(share_out[src], share_in[dst])
        share = torch.minimum(share, share_ed[eid])
        share = torch.where(un, share, big)
        cap_hit = un & (caps <= share + EPS32)
        anyc = cap_hit.any()
        thresh = share.amin()
        newly = torch.where(anyc, cap_hit, un & (share <= thresh + EPS32))
        rate = torch.where(newly, torch.where(anyc, caps, share), rate)
        w = torch.where(newly, rate, 0.0)
        eg = torch.clamp(eg - _segsum(w, src, nv), min=0.0)
        inn = torch.clamp(inn - _segsum(w, dst, nv), min=0.0)
        ed = torch.clamp(ed - _segsum(w, eid, ne), min=0.0)
        fixed = fixed | newly
    return rate
