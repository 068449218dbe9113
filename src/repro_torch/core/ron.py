"""RON baseline (Andersen et al., SOSP'01) — paper §2, §7.6, Table 2.

RON probes the network and routes via a single intermediate relay chosen for
low latency/loss (optionally a TCP throughput model); it is *price-blind* and
*elasticity-blind*. Following the paper's §7.6 methodology we implement RON's
path-selection heuristic inside our data plane: pick the single relay that
maximizes the bottleneck throughput of src->relay->dst (falling back to the
latency metric when no throughput model is available), allocate the full VM
budget along that path, and use the maximum connection count everywhere.
"""

from __future__ import annotations

import numpy as np

from .plan import TransferPlan
from .topology import Topology


def ron_plan(
    top: Topology,
    src: str,
    dst: str,
    volume_gb: float,
    *,
    num_vms: int = 4,
    metric: str = "throughput",  # "throughput" (TCP-model RON) | "latency"
) -> TransferPlan:
    s, t = top.index(src), top.index(dst)
    v = top.num_regions
    n_vm = min(num_vms, top.limit_vm)

    def path_tput(path: list[int]) -> float:
        """Achievable Gbit/s along a relay chain with n_vm VMs per region."""
        caps = []
        for a, b in zip(path[:-1], path[1:]):
            caps.append(top.tput[a, b] * n_vm)  # link, scaled by VM pairs
            caps.append(top.limit_egress[a] * n_vm)
            caps.append(top.limit_ingress[b] * n_vm)
        return min(caps)

    best_path = [s, t]
    if metric == "throughput":
        best_score = path_tput(best_path)
        for r in range(v):
            if r in (s, t):
                continue
            cand = [s, r, t]
            score = path_tput(cand)
            if score > best_score + 1e-9:
                best_score = score
                best_path = cand
    else:  # latency-minimizing RON
        assert top.rtt_ms is not None
        best_score = top.rtt_ms[s, t]
        for r in range(v):
            if r in (s, t):
                continue
            lat = top.rtt_ms[s, r] + top.rtt_ms[r, t]
            if lat < best_score - 1e-9:
                best_score = lat
                best_path = [s, r, t]

    tput = path_tput(best_path)
    F = np.zeros((v, v))
    M = np.zeros((v, v))
    N = np.zeros(v)
    for a, b in zip(best_path[:-1], best_path[1:]):
        F[a, b] = tput
        M[a, b] = top.limit_conn * n_vm
    for r in best_path:
        N[r] = n_vm
    return TransferPlan(
        top=top, src=s, dst=t, tput_goal=tput, volume_gb=volume_gb,
        F=F, N=N, M=M, solver_status="ron",
    )
