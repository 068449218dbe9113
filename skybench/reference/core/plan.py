# Frozen copy of src/repro/core/plan.py at commit 9de379d4b486;
# only the imports changed.
"""TransferPlan: the output of Skyplane's planner (paper Fig. 5).

A plan pins down the overlay topology (F), resource allocation (N VMs per
region, M connections per region pair) and exposes the paper's cost model:

  egress cost = sum_e  (bytes through e) * price_e          [volume-billed, §2]
  vm cost     = sum_v  N_v * price_vm_v * transfer_time
  transfer_time = VOLUME / TPUT_GOAL                        [linear reformulation]

``validate`` re-checks every constraint 4b-4j so tests (and hypothesis
properties) can assert that any plan the solver emits is feasible.
``paths`` decomposes F into weighted s->t paths for the data plane.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

from .topology import GBIT_PER_GB, Topology

_TOL = 1e-5
_FLOW_EPS = 1e-9


def _widest_path(
    F: np.ndarray, src: int, dst: int
) -> tuple[list[int], float] | None:
    """Widest src->dst path in the flow grid F (Dijkstra-like relaxation on
    bottleneck capacity). Returns (path, width) or None when no flow path
    with width > _FLOW_EPS exists."""
    v = F.shape[0]
    width = np.full(v, 0.0)
    prev = np.full(v, -1, dtype=np.int64)
    width[src] = np.inf
    visited = np.zeros(v, dtype=bool)
    for _ in range(v):
        u = -1
        best = 0.0
        for i in range(v):
            if not visited[i] and width[i] > best:
                best = width[i]
                u = i
        if u < 0:
            break
        visited[u] = True
        if u == dst:
            break
        for w in range(v):
            cand = min(width[u], F[u, w])
            if cand > width[w] + 1e-12:
                width[w] = cand
                prev[w] = u
    if width[dst] <= _FLOW_EPS:
        return None
    path = [dst]
    while path[-1] != src:
        path.append(int(prev[path[-1]]))
    path.reverse()
    return path, float(width[dst])


def _peel_paths(
    F: np.ndarray,
    src: int,
    dst: int,
    max_paths: int | None,
    stop_below: float = 0.0,
) -> list[tuple[list[int], float]]:
    """Greedy widest-path flow decomposition of F (mutated in place). Each
    peel zeroes at least one edge, so at most #positive-edges paths exist;
    ``max_paths`` only caps that (None = all of them). ``stop_below`` ends
    the peel once the residual source outflow is negligible (solver noise
    would otherwise decompose into useless micro-paths)."""
    cap = max_paths if max_paths is not None else int((F > _FLOW_EPS).sum()) + 4
    out: list[tuple[list[int], float]] = []
    for _ in range(cap):
        hit = _widest_path(F, src, dst)
        if hit is None:
            break
        path, flow = hit
        for a, b in zip(path[:-1], path[1:]):
            F[a, b] -= flow
        out.append((path, flow))
        if stop_below > 0.0 and float(F[src, :].sum()) <= stop_below:
            break
    return out


@dataclasses.dataclass
class TransferPlan:
    top: Topology
    src: int
    dst: int
    tput_goal: float  # Gbit/s
    volume_gb: float  # GB to move
    F: np.ndarray  # [V,V] Gbit/s
    N: np.ndarray  # [V] VMs (int)
    M: np.ndarray  # [V,V] TCP connections (int)
    solver_status: str = "optimal"

    # ------------------------------------------------------------------ costs
    @property
    def throughput(self) -> float:
        """Planned end-to-end throughput (Gbit/s)."""
        return float(self.F[self.src, :].sum())

    @property
    def transfer_time_s(self) -> float:
        return self.volume_gb * GBIT_PER_GB / max(self.throughput, 1e-9)

    @property
    def egress_cost(self) -> float:
        t = self.transfer_time_s
        gb_per_edge = self.F * t / GBIT_PER_GB
        return float((gb_per_edge * self.top.price_egress).sum())

    @property
    def vm_cost(self) -> float:
        return float(self.N @ self.top.price_vm) * self.transfer_time_s

    @property
    def total_cost(self) -> float:
        return self.egress_cost + self.vm_cost

    @property
    def cost_per_gb(self) -> float:
        return self.total_cost / max(self.volume_gb, 1e-9)

    @property
    def num_vms(self) -> int:
        return int(self.N.sum())

    def with_volume(self, volume_gb: float) -> "TransferPlan":
        """The same allocation, re-scoped to a different volume — how the
        transfer service carries a plan over to the *remaining* bytes of a
        partially completed job (costs and transfer time rescale; F/N/M and
        feasibility are untouched)."""
        return dataclasses.replace(self, volume_gb=float(volume_gb))

    # ------------------------------------------------------------- valididity
    def validate(self, tol: float = _TOL) -> list[str]:
        """Returns a list of violated-constraint descriptions (empty = valid)."""
        top, F, N, M = self.top, self.F, self.N, self.M
        v = top.num_regions
        errs = []
        scale = max(self.tput_goal, 1.0)
        if (F < -tol).any():
            errs.append("F has negative entries")
        if (N < -tol).any() or (M < -tol).any():
            errs.append("N or M has negative entries")
        # 4b
        cap = top.tput * M / top.limit_conn
        if (F - cap > tol * scale).any():
            errs.append("4b: flow exceeds per-connection capacity")
        # 4c / 4d
        if F[self.src, :].sum() < self.tput_goal - tol * scale:
            errs.append("4c: source egress below goal")
        if F[:, self.dst].sum() < self.tput_goal - tol * scale:
            errs.append("4d: dest ingress below goal")
        # 4e
        for r in range(v):
            if r in (self.src, self.dst):
                continue
            if abs(F[:, r].sum() - F[r, :].sum()) > tol * scale:
                errs.append(f"4e: flow not conserved at region {r}")
        # 4f / 4g
        for r in range(v):
            if F[:, r].sum() - top.limit_ingress[r] * N[r] > tol * scale:
                errs.append(f"4f: ingress over VM limit at region {r}")
            if F[r, :].sum() - top.limit_egress[r] * N[r] > tol * scale:
                errs.append(f"4g: egress over VM limit at region {r}")
        # 4h / 4i
        for r in range(v):
            if M[r, :].sum() - top.limit_conn * N[r] > tol:
                errs.append(f"4h: outgoing connections over limit at region {r}")
            if M[:, r].sum() - top.limit_conn * N[r] > tol:
                errs.append(f"4i: incoming connections over limit at region {r}")
        # 4j
        if (N > top.limit_vm + tol).any():
            errs.append("4j: VM count over service limit")
        return errs

    # ------------------------------------------------------------------ paths
    def paths(
        self, max_paths: int | None = None, *, rel_eps: float = 1e-6
    ) -> list[tuple[list[int], float]]:
        """Greedy flow decomposition of F into (region path, Gbit/s) pairs.

        Repeatedly peels the widest remaining s->t path until the residual
        source outflow is below ``rel_eps`` of the plan throughput. Each peel
        zeroes at least one edge, so at most #positive-edges paths exist;
        ``max_paths`` is only a safety cap (default: all of them). Dropping
        residual flow silently would under-provision the gateway chains the
        data plane maps chunk streams onto, so any leftover beyond the
        tolerance warns.
        """
        F = self.F.copy()
        tol = rel_eps * max(self.throughput, 1e-9)
        out = _peel_paths(F, self.src, self.dst, max_paths, stop_below=tol)
        leftover = float(F[self.src, :].sum())
        if leftover > tol and _widest_path(F, self.src, self.dst) is not None:
            warnings.warn(
                f"paths(): {leftover:.3g} Gbit/s of source outflow left "
                f"undecomposed after {len(out)} paths; the gateway chains "
                "will under-provision",
                stacklevel=2,
            )
        return out

    def describe(self) -> str:
        keys = self.top.keys()
        lines = [
            f"plan {keys[self.src]} -> {keys[self.dst]}: "
            f"{self.throughput:.2f} Gbps, ${self.cost_per_gb:.4f}/GB "
            f"({self.num_vms} VMs, {int(self.M.sum())} conns)"
        ]
        for path, flow in self.paths():
            hops = " -> ".join(keys[i] for i in path)
            lines.append(f"  {flow:6.2f} Gbps via {hops}")
        return "\n".join(lines)


# ------------------------------------------------------------------ multicast
@dataclasses.dataclass
class McTree:
    """One distribution tree of a multicast plan: a rate and, per
    destination region, the path that serves it. Paths may share edges —
    a chunk traverses each shared edge once and fans out where the paths
    diverge (that sharing is exactly what the envelope bills once)."""

    rate: float  # Gbit/s carried by this tree
    paths: dict[int, list[int]]  # dest region -> [src, ..., dest]

    def edges(self) -> list[tuple[int, int]]:
        """Distinct edges in first-appearance order (dest order, then path
        order) — the deterministic stage order of the data plane."""
        seen: list[tuple[int, int]] = []
        have = set()
        for d in sorted(self.paths):
            p = self.paths[d]
            for e in zip(p[:-1], p[1:]):
                if e not in have:
                    have.add(e)
                    seen.append(e)
        return seen

    def dests_of_edge(self) -> dict[tuple[int, int], set[int]]:
        """edge -> destinations whose path traverses it."""
        out: dict[tuple[int, int], set[int]] = {}
        for d, p in self.paths.items():
            for e in zip(p[:-1], p[1:]):
                out.setdefault(e, set()).add(d)
        return out

    def children(self) -> dict[tuple[int, int], list[tuple[int, int]]]:
        """edge -> downstream edges some destination path continues on."""
        out: dict[tuple[int, int], set] = {e: set() for e in self.edges()}
        for p in self.paths.values():
            for i in range(len(p) - 2):
                out[(p[i], p[i + 1])].add((p[i + 1], p[i + 2]))
        order = {e: i for i, e in enumerate(self.edges())}
        return {e: sorted(cs, key=order.__getitem__)
                for e, cs in out.items()}

    def roots(self) -> list[tuple[int, int]]:
        """Distinct first edges (out of the source), in edge order."""
        firsts = {(p[0], p[1]) for p in self.paths.values()}
        return [e for e in self.edges() if e in firsts]

    def delivers(self) -> dict[tuple[int, int], int]:
        """edge -> destination region it terminates at (last hop only)."""
        return {(p[-2], p[-1]): d for d, p in self.paths.items()}


@dataclasses.dataclass
class MulticastPlan:
    """Output of the multicast planner: one source, a commodity per
    destination, egress billed once on the shared envelope ``G``.

    ``F[k]`` is the flow grid of the commodity serving ``dsts[k]``; the
    envelope satisfies ``F[k] <= G`` edge-wise, and ``G`` is what bytes
    actually traverse — the cost model and the data plane both run on it.
    """

    top: Topology
    src: int
    dsts: list[int]
    tput_goals: np.ndarray  # [D] Gbit/s floors the plan was asked for
    volume_gb: float  # GB delivered to EACH destination
    G: np.ndarray  # [V,V] envelope Gbit/s
    F: np.ndarray  # [D,V,V] per-commodity Gbit/s
    N: np.ndarray  # [V] VMs (int)
    M: np.ndarray  # [V,V] TCP connections (int)
    solver_status: str = "optimal"

    # ------------------------------------------------------------------ costs
    def delivered_gbps(self, dst: int) -> float:
        """Planned delivery rate into destination region ``dst``."""
        k = self.dsts.index(dst)
        return float(self.F[k][:, dst].sum())

    @property
    def active_dsts(self) -> list[int]:
        """Destinations with a positive goal or positive planned delivery."""
        out = []
        for k, d in enumerate(self.dsts):
            if self.tput_goals[k] > _FLOW_EPS or self.F[k][:, d].sum() > _FLOW_EPS:
                out.append(d)
        return out

    @property
    def throughput(self) -> float:
        """Sustained one-to-many rate: the slowest active branch (a chunk
        is retired once every destination holds it)."""
        rates = [self.delivered_gbps(d) for d in self.active_dsts]
        return float(min(rates)) if rates else 0.0

    @property
    def transfer_time_s(self) -> float:
        return self.volume_gb * GBIT_PER_GB / max(self.throughput, 1e-9)

    @property
    def egress_cost(self) -> float:
        """Envelope egress: every link billed once for the bytes it carries,
        no matter how many destinations ride it."""
        t = self.transfer_time_s
        gb_per_edge = self.G * t / GBIT_PER_GB
        return float((gb_per_edge * self.top.price_egress).sum())

    @property
    def vm_cost(self) -> float:
        return float(self.N @ self.top.price_vm) * self.transfer_time_s

    @property
    def total_cost(self) -> float:
        return self.egress_cost + self.vm_cost

    @property
    def cost_per_gb(self) -> float:
        """Cost per GB of source data replicated (not per GB delivered)."""
        return self.total_cost / max(self.volume_gb, 1e-9)

    @property
    def num_vms(self) -> int:
        return int(self.N.sum())

    def with_volume(self, volume_gb: float) -> "MulticastPlan":
        return dataclasses.replace(self, volume_gb=float(volume_gb))

    # ------------------------------------------------------------- valididity
    def validate(self, tol: float = _TOL) -> list[str]:
        """Violated-constraint descriptions (empty = valid). Flow
        conservation is checked per commodity."""
        top, G, N, M = self.top, self.G, self.N, self.M
        v = top.num_regions
        errs = []
        scale = max(float(self.tput_goals.max(initial=0.0)), 1.0)
        if (G < -tol).any() or (self.F < -tol).any():
            errs.append("G or F has negative entries")
        if (N < -tol).any() or (M < -tol).any():
            errs.append("N or M has negative entries")
        # envelope dominance
        if (self.F - G[None, :, :] > tol * scale).any():
            errs.append("commodity flow exceeds the envelope")
        # 4b on the envelope
        cap = top.tput * M / top.limit_conn
        if (G - cap > tol * scale).any():
            errs.append("4b: envelope exceeds per-connection capacity")
        for k, d in enumerate(self.dsts):
            Fk = self.F[k]
            goal = float(self.tput_goals[k])
            if Fk[self.src, :].sum() < goal - tol * scale:
                errs.append(f"4c: source egress below goal for dest {d}")
            if Fk[:, d].sum() < goal - tol * scale:
                errs.append(f"4d: ingress below goal at dest {d}")
            for r in range(v):
                if r in (self.src, d):
                    continue
                if abs(Fk[:, r].sum() - Fk[r, :].sum()) > tol * scale:
                    errs.append(
                        f"4e: commodity {d} flow not conserved at region {r}"
                    )
        for r in range(v):
            if G[:, r].sum() - top.limit_ingress[r] * N[r] > tol * scale:
                errs.append(f"4f: ingress over VM limit at region {r}")
            if G[r, :].sum() - top.limit_egress[r] * N[r] > tol * scale:
                errs.append(f"4g: egress over VM limit at region {r}")
            if M[r, :].sum() - top.limit_conn * N[r] > tol:
                errs.append(f"4h: outgoing connections over limit at region {r}")
            if M[:, r].sum() - top.limit_conn * N[r] > tol:
                errs.append(f"4i: incoming connections over limit at region {r}")
        if (N > top.limit_vm + tol).any():
            errs.append("4j: VM count over service limit")
        return errs

    # ------------------------------------------------------------------ trees
    def paths_to(
        self, dst: int, max_paths: int | None = None
    ) -> list[tuple[list[int], float]]:
        """Decomposition of the commodity flow serving ``dst`` into
        (path, Gbit/s) pairs — the per-destination tree decomposition."""
        k = self.dsts.index(dst)
        return _peel_paths(self.F[k].copy(), self.src, dst, max_paths)

    def trees(self, rel_eps: float = 1e-3) -> list[McTree]:
        """Peel the commodity flows into distribution trees.

        Each round takes the widest remaining path per active destination
        and carves the common rate (the min width) out of all of them: the
        result is a forwarding structure in which shared path segments carry
        a chunk once and fan out where destinations diverge.

        Every chunk must reach EVERY active destination, so every tree
        spans all of them: the commodity flows are first normalized to the
        slowest branch's delivery rate (a replication is governed by its
        slowest branch — ``throughput`` — and a faster branch's surplus
        capacity cannot retire chunks the slow branch still needs). Without
        this, unequal per-destination floors would peel trees serving only
        a subset, and chunks binned to those trees would never complete.

        Peeling stops when the residual is below ``rel_eps`` of the common
        rate (chunk streams are assigned to trees by rate share, so a
        sub-0.1% residual tree would only add idle stages to the data
        plane); a leftover beyond that warns."""
        act = self.active_dsts
        if not act:
            return []
        rate_of = {d: self.delivered_gbps(d) for d in act}
        r_min = min(rate_of.values())
        # scale each commodity down to the common rate; conservation is
        # preserved, so the widest-path peel still decomposes exactly
        res = {
            d: self.F[self.dsts.index(d)] * (r_min / rate_of[d])
            for d in act
        }
        remaining = {d: r_min for d in act}
        tol = rel_eps * max(r_min, 1e-9)
        cap = int((self.F > _FLOW_EPS).sum()) + 4 * len(act) + 4
        out: list[McTree] = []
        for _ in range(cap):
            live = [d for d in act if remaining[d] > tol]
            if not live:
                break
            paths: dict[int, list[int]] = {}
            widths = []
            for d in live:
                hit = _widest_path(res[d], self.src, d)
                if hit is None:
                    break
                paths[d], w = hit
                widths.append(min(w, remaining[d]))
            if len(paths) < len(live):
                break  # a destination ran dry mid-round: leftover warns below
            rate = float(min(widths))
            if rate <= _FLOW_EPS:
                break
            for d in live:
                for a, b in zip(paths[d][:-1], paths[d][1:]):
                    res[d][a, b] -= rate
                remaining[d] -= rate
            out.append(McTree(rate=rate, paths=paths))
        leftover = {d: remaining[d] for d in act if remaining[d] > tol}
        if leftover:
            warnings.warn(
                f"trees(): undecomposed delivery remains for {leftover} "
                f"after {len(out)} trees",
                stacklevel=2,
            )
        return out

    def describe(self) -> str:
        keys = self.top.keys()
        names = ", ".join(keys[d] for d in self.dsts)
        lines = [
            f"multicast plan {keys[self.src]} -> {{{names}}}: "
            f"{self.throughput:.2f} Gbps/dest, ${self.cost_per_gb:.4f}/GB "
            f"({self.num_vms} VMs, {int(self.M.sum())} conns)"
        ]
        for t in self.trees():
            lines.append(f"  tree @ {t.rate:.2f} Gbps:")
            for d in sorted(t.paths):
                hops = " -> ".join(keys[i] for i in t.paths[d])
                lines.append(f"    {hops}")
        return "\n".join(lines)
