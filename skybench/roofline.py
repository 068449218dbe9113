"""Peaks of the card and the least work of a water-filling solve.

The peaks are NVIDIA's data sheet for the H100 SXM part (dense, without
sparsity), which assume the full 700 W power limit; a card set below it
runs slower, so a share reads low there. The solve's bytes and operations
are ``chip_smoke.py::wf_bound``'s arithmetic: each operand read once (the
lane-to-VM and lane-to-edge maps as int32), the rates written once, and
per live round ~12 float operations a lane and 2 a VM or edge budget.

The solves counted are the ones the frozen reference makes for the same
inputs (it solves only when the set of active connections changes), with
the rounds its water-filling loop runs, so the least time does not depend
on how the program implements the solve or how often it launches it.
"""

from __future__ import annotations

import contextlib

import numpy as np

H100 = {
    "hbm_bytes_s": 3.35e12,
    "f64_flops": 34e12,  # outside the tensor cores
    "f32_flops": 67e12,
    "bf16_flops": 989e12,
}
_EPS = 1e-12  # the reference's water-filling tolerance


def solve_bytes(n: int, nv: int, ne: int, elem: int = 8) -> int:
    """Bytes one solve over ``n`` lanes, ``nv`` VMs and ``ne`` shared
    edges must move: caps, the maps, an active byte a lane, the VM and
    edge budgets in, the rates out."""
    maps = 3 if ne else 2
    return n * elem + maps * n * 4 + n + 2 * nv * elem + ne * elem + n * elem


def solve_ops(n: int, nv: int, ne: int, rounds: int) -> int:
    return rounds * (12 * n + 2 * (2 * nv + ne))


def least_seconds(solves, peaks: dict = H100) -> float:
    """The least device time of ``solves``, (lanes, VMs, edges, rounds)
    each: per solve the larger of its bytes at the memory rate and its
    float64 operations at the float64 peak."""
    return sum(
        max(solve_bytes(n, nv, ne) / peaks["hbm_bytes_s"],
            solve_ops(n, nv, ne, r) / peaks["f64_flops"])
        for n, nv, ne, r in solves)


def rounds(caps, src, dst, vm_eg_cap, vm_in_cap, eid=None, edge_cap=None):
    """(rates, rounds) of the reference's ``_maxmin_rates_arr`` on these
    operands: its loop, counting the rounds it runs."""
    nv = max(int(src.max()), int(dst.max())) + 1
    budgets = [(src, vm_eg_cap[:nv].astype(float)),
               (dst, vm_in_cap[:nv].astype(float))]
    if eid is not None:
        budgets.append((eid, np.array(edge_cap, dtype=float)))
    ne = 0 if eid is None else edge_cap.shape[0]
    rate = np.zeros(caps.shape[0])
    fixed = np.zeros(caps.shape[0], dtype=bool)
    k = 0
    for _ in range(2 * nv + ne + 4):
        un = ~fixed
        if not un.any():
            break
        share = np.full(caps.shape[0], np.inf)
        for idx, rem in budgets:
            cnt = np.bincount(idx[un], minlength=rem.shape[0]).astype(float)
            with np.errstate(divide="ignore", invalid="ignore"):
                seg = np.where(cnt > 0, rem / np.maximum(cnt, 1), np.inf)
            share = np.minimum(share, seg[idx])
        newly = un & (caps <= share + _EPS)
        if newly.any():
            rate[newly] = caps[newly]
        else:
            newly = un & (share <= share[un].min() + _EPS)
            rate[newly] = share[newly]
        for idx, rem in budgets:
            rem -= np.bincount(idx[newly], weights=rate[newly],
                               minlength=rem.shape[0])
            np.maximum(rem, 0.0, out=rem)
        fixed |= newly
        k += 1
    return rate, k


@contextlib.contextmanager
def counting_solves(flowsim_module):
    """Within the block, every water-filling solve the reference's sim
    module makes is recorded as (lanes, VMs, edges, rounds) in the list
    it yields."""
    solve = flowsim_module._maxmin_rates_arr
    seen: list = []

    def counted(caps, src, dst, vm_eg_cap, vm_in_cap, eid=None,
                edge_cap=None):
        nv = max(int(src.max()), int(dst.max())) + 1
        ne = 0 if eid is None else int(edge_cap.shape[0])
        _, k = rounds(caps, src, dst, vm_eg_cap, vm_in_cap, eid, edge_cap)
        seen.append((int(caps.shape[0]), nv, ne, k))
        return solve(caps, src, dst, vm_eg_cap, vm_in_cap, eid=eid,
                     edge_cap=edge_cap)

    flowsim_module._maxmin_rates_arr = counted
    try:
        yield seen
    finally:
        flowsim_module._maxmin_rates_arr = solve
