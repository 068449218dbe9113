"""Skyplane's MILP formulation (paper §5.1.4, Eq. 4a-4j) as LP matrices.

Decision vector layout:  x = [ F (E), N (V), M (E) ]
  F_e  >= 0  flow on directed edge e (Gbit/s)
  N_v  >= 0  VMs provisioned in region v         (integer in the MILP)
  M_e  >= 0  TCP connections on edge e (pooled across the region pair;
             integer in the MILP)

Objective (Eq. 4a): minimize  (VOLUME / TPUT_GOAL) * (<F, Cost_egress> + <N, Cost_vm>)
The leading factor is a positive constant after the paper's linear
reformulation (transfer time == VOLUME / TPUT_GOAL), so the LP minimizes the
unscaled "cost per second" and the caller scales afterwards.

Constraints (paper numbering):
  4b  F_e <= (Limit_link_e / Limit_conn) * M_e      per-connection throughput
  4c  sum_v F_{s,v} >= TPUT_GOAL                    source egress meets goal
  4d  sum_u F_{u,t} >= TPUT_GOAL                    dest ingress meets goal
  4e  flow conservation at every v not in {s, t}
  4f  sum_u F_{u,v} <= Limit_ingress_v * N_v        per-VM ingress scaled by VMs
  4g  sum_w F_{u,w} <= Limit_egress_u * N_u         per-VM egress scaled by VMs
  4h  sum_w M_{u,w} <= Limit_conn * N_u             outgoing conns per region
  4i  sum_u M_{u,v} <= Limit_conn * N_v             incoming conns per region
  4j  N_v <= Limit_vm

ERRATUM NOTE: the paper's printed 4h/4i bound region u's outgoing connections
by N_v and incoming by N_u — a typesetting slip (the text of §5.1.2 says "the
maximum number of egress TCP connections per region [scales] by the number of
VMs provisioned in each region"). We implement the semantically consistent
version above.

Assembly is split in two layers so the planner's hot path (thousands of
solves per (src, dst) pair — round-down refits, B&B nodes, Pareto sweeps)
never re-runs the O(rows * cols) construction:

  * ``LPStructure`` — built once per (topology, src, dst) by vectorized
    scatter-index assembly, cached on the Topology instance.  Holds the full
    A_ub/A_eq/c plus precomputed "pin patterns" (column partitions + reduced
    matrices) for the fixed-N and fixed-N+M refits of §5.1.3.
  * ``LPStructure.lp(...)`` — O(rows) derivation of a concrete ``LPData``
    for a given (tput_goal, fixed_n, fixed_m, extra_ub): copies b, shifts the
    RHS by the pinned values, and reuses the cached reduced matrices.

``build_lp`` keeps the original one-shot signature on top of the cache, and
``build_lp_reference`` keeps the original pure-Python row-loop assembly as
the oracle for equivalence tests and as the pre-optimization benchmark
baseline.
"""

from __future__ import annotations

# This module is the port's structure factory home, as core/milp.py is in
# the reference package: the cache discipline holds here by construction.
# skylint: disable=SKY002

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import get_tracer

from .topology import GBIT_PER_GB, Topology

_ZERO_ROW_TOL = 1e-12
_RHS_TOL = 1e-9

# Running count of LPStructure assemblies (the O(rows*cols) construction).
# Re-planning on a degraded topology must be a pure cache hit: tests snapshot
# this counter around a re-plan and assert it did not move. The count lives
# in the observability plane's registry; the module attribute
# ``N_STRUCT_BUILDS`` survives as a bitwise-compatible read alias below.
_struct_builds = REGISTRY.counter("planner.struct_builds")
_lp_cache_hits = REGISTRY.counter("planner.lp_cache_hits")
_lp_cache_misses = REGISTRY.counter("planner.lp_cache_misses")


def __getattr__(name: str):
    # PEP 562 read alias: ``milp.N_STRUCT_BUILDS`` (and ``from ... import``)
    # keeps returning the plain int every zero-re-assembly pin snapshots.
    if name == "N_STRUCT_BUILDS":
        return int(_struct_builds.value)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class LPData:
    """min c@x  s.t.  A_ub@x <= b_ub,  A_eq@x = b_eq,  x >= 0."""

    c: np.ndarray
    A_ub: np.ndarray
    b_ub: np.ndarray
    A_eq: np.ndarray
    b_eq: np.ndarray
    integer_mask: np.ndarray  # True where x must be integral in the MILP
    # bookkeeping for unpacking solutions
    edges: list[tuple[int, int]]
    num_regions: int
    src: int
    dst: int
    tput_goal: float
    row_4c: int  # row index of the source-egress constraint in A_ub
    row_4d: int
    # fixed-variable elimination (round-down refits): full-space values for
    # pinned variables; solver variables are the free columns only. F columns
    # come first and are never pinned, so F indices are stable.
    fixed_values: np.ndarray | None = None  # [nx_full] nan where free
    trivially_infeasible: bool = False

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def _full_x(self, x: np.ndarray) -> np.ndarray:
        if self.fixed_values is None:
            return x
        full = self.fixed_values.copy()
        full[np.isnan(self.fixed_values)] = x
        return full

    def split(self, x: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """solver x -> (F [V,V], N [V], M [V,V])."""
        x = self._full_x(np.asarray(x, dtype=float))
        e, v = self.n_edges, self.num_regions
        eu, ew = _edge_arrays(self.edges)
        F = np.zeros((v, v))
        M = np.zeros((v, v))
        F[eu, ew] = x[:e]
        M[eu, ew] = x[e + v :]
        N = np.asarray(x[e : e + v], dtype=float).copy()
        return F, N, M


def _edge_arrays(edges: list[tuple[int, int]]) -> tuple[np.ndarray, np.ndarray]:
    arr = np.asarray(edges, dtype=np.int64).reshape(len(edges), 2)
    return arr[:, 0], arr[:, 1]


def _scale_cut_rows(
    nx: int,
    m_col: int,
    tput_e: np.ndarray,
    limit_conn: float,
    edge_scale: np.ndarray,
    agg_cap: float | np.ndarray | None,
    tol: float,
) -> list[tuple[np.ndarray, float]]:
    """Shared body of the unicast/multicast ``scale_cuts``: per edge with
    phi < 1, a tightened 4b row (flow column k vs M column m_col + k) and,
    with ``agg_cap``, an aggregate interconnect row.

    ``agg_cap`` is a scalar (data-plane capacity factor: aggregate rows
    only where phi < 1, since an uncapped healthy link never binds) or a
    per-edge array (per-tenant fair-share caps: an aggregate row for EVERY
    edge with a finite entry, even healthy ones — a tenant's share of a
    contended link binds regardless of drift). Non-finite array entries
    mean "this edge is not share-capped"."""
    cuts: list[tuple[np.ndarray, float]] = []
    coef = tput_e / limit_conn
    agg_arr = None
    if agg_cap is not None and np.ndim(agg_cap) > 0:
        agg_arr = np.asarray(agg_cap, dtype=float)
        if agg_arr.shape != tput_e.shape:
            raise ValueError(
                f"per-edge agg_cap must have shape {tput_e.shape}, "
                f"got {agg_arr.shape}"
            )
    for k in np.flatnonzero(edge_scale < 1.0 - tol):
        phi = float(edge_scale[k])
        row = np.zeros(nx)
        row[k] = 1.0
        row[m_col + k] = -phi * coef[k]
        cuts.append((row, 0.0))
        if agg_cap is not None and agg_arr is None:
            agg = np.zeros(nx)
            agg[k] = 1.0
            cuts.append((agg, phi * float(tput_e[k]) * float(agg_cap)))
    if agg_arr is not None:
        for k in np.flatnonzero(np.isfinite(agg_arr)):
            phi = min(float(edge_scale[k]), 1.0)
            agg = np.zeros(nx)
            agg[k] = 1.0
            cuts.append((agg, phi * float(tput_e[k]) * float(agg_arr[k])))
    return cuts


@dataclasses.dataclass
class PinPattern:
    """Column partition + reduced matrices for one (pin_n, pin_m) choice.

    Rows of A_ub whose free part is structurally zero are dropped from
    ``A_ub_free``; their RHS (after the pinned shift) is only checked for
    trivial infeasibility. Which rows those are depends solely on the edge
    structure, so the masks are precomputed here.
    """

    pinned: np.ndarray  # [nx] bool
    A_ub_free: np.ndarray  # [m_keep, n_free]
    A_ub_pin: np.ndarray  # [m_ub, n_pin] (all rows, for RHS shifts)
    keep_ub: np.ndarray  # [m_ub] bool
    drop_ub: np.ndarray  # [m_ub] bool
    A_eq_free: np.ndarray  # [m_eq_keep, n_free]
    keep_eq: np.ndarray
    drop_eq: np.ndarray
    c_free: np.ndarray
    integer_mask_free: np.ndarray
    row_4c: int  # goal rows remapped into kept-row space (-1 if dropped)
    row_4d: int

    @property
    def n_free(self) -> int:
        return self.A_ub_free.shape[1]


class LPStructure:
    """Vectorized, cached assembly of Eq. 4a-4j for one (top, src, dst)."""

    def __init__(self, top: Topology, src: int, dst: int):
        _struct_builds.inc()
        self.top = top
        self.src = src
        self.dst = dst
        self.edges = top.edge_list(src, dst)
        self.eu, self.ew = _edge_arrays(self.edges)
        e, v = len(self.edges), top.num_regions
        self.n_edges = e
        self.num_regions = v
        nx = 2 * e + v
        self.nx = nx
        self.row_4c = e
        self.row_4d = e + 1
        ar = np.arange(e)

        # ---- objective (Eq. 4a without the constant factor)
        c = np.zeros(nx)
        c[:e] = top.price_egress[self.eu, self.ew] / GBIT_PER_GB
        c[e : e + v] = top.price_vm
        self.c = c

        # ---- A_ub, rows in the fixed order 4b | 4c | 4d | 4f | 4g | 4h | 4i | 4j
        m_ub = e + 2 + 5 * v
        A = np.zeros((m_ub, nx))
        b0 = np.zeros(m_ub)
        # 4b
        A[ar, ar] = 1.0
        A[ar, e + v + ar] = -top.tput[self.eu, self.ew] / top.limit_conn
        # 4c / 4d (b filled per-goal in lp())
        A[e, ar[self.eu == src]] = -1.0
        A[e + 1, ar[self.ew == dst]] = -1.0
        # 4f / 4g
        A[e + 2 + self.ew, ar] = 1.0
        A[e + 2 + np.arange(v), e + np.arange(v)] = -top.limit_ingress
        A[e + 2 + v + self.eu, ar] = 1.0
        A[e + 2 + v + np.arange(v), e + np.arange(v)] = -top.limit_egress
        # 4h / 4i
        A[e + 2 + 2 * v + self.eu, e + v + ar] = 1.0
        A[e + 2 + 2 * v + np.arange(v), e + np.arange(v)] = -float(top.limit_conn)
        A[e + 2 + 3 * v + self.ew, e + v + ar] = 1.0
        A[e + 2 + 3 * v + np.arange(v), e + np.arange(v)] = -float(top.limit_conn)
        # 4j
        A[e + 2 + 4 * v + np.arange(v), e + np.arange(v)] = 1.0
        b0[e + 2 + 4 * v :] = float(top.limit_vm)
        self.A_ub = A
        self.b_ub0 = b0

        # ---- A_eq: flow conservation at touched relays (ascending region id)
        full = np.zeros((v, nx))
        np.add.at(full, (self.ew, ar), 1.0)
        np.add.at(full, (self.eu, ar), -1.0)
        touched = np.zeros(v, dtype=bool)
        touched[self.eu] = True
        touched[self.ew] = True
        relay = touched.copy()
        relay[[src, dst]] = False
        self.A_eq = full[relay] if relay.any() else np.zeros((0, nx))
        self.b_eq = np.zeros(self.A_eq.shape[0])

        self.integer_mask = np.zeros(nx, dtype=bool)
        self.integer_mask[e:] = True  # N and M

        self._pin_patterns: dict[tuple[bool, bool], PinPattern] = {}
        self._reduced_cache: dict = {}

    # ------------------------------------------------------------ pin patterns
    def pin_pattern(self, pin_n: bool, pin_m: bool) -> PinPattern:
        key = (pin_n, pin_m)
        pat = self._pin_patterns.get(key)
        if pat is not None:
            return pat
        e, v = self.n_edges, self.num_regions
        pinned = np.zeros(self.nx, dtype=bool)
        if pin_n:
            pinned[e : e + v] = True
        if pin_m:
            pinned[e + v :] = True
        free = ~pinned
        A_ub_free = self.A_ub[:, free]
        A_eq_free = self.A_eq[:, free]
        drop_ub = (
            np.abs(A_ub_free).max(axis=1, initial=0.0) < _ZERO_ROW_TOL
            if pinned.any()
            else np.zeros(self.A_ub.shape[0], dtype=bool)
        )
        drop_eq = (
            np.abs(A_eq_free).max(axis=1, initial=0.0) < _ZERO_ROW_TOL
            if (pinned.any() and self.A_eq.size)
            else np.zeros(self.A_eq.shape[0], dtype=bool)
        )
        keep_ub = ~drop_ub
        keep_eq = ~drop_eq
        newpos = np.cumsum(keep_ub) - 1
        pat = PinPattern(
            pinned=pinned,
            A_ub_free=np.ascontiguousarray(A_ub_free[keep_ub]),
            A_ub_pin=np.ascontiguousarray(self.A_ub[:, pinned]),
            keep_ub=keep_ub,
            drop_ub=drop_ub,
            A_eq_free=np.ascontiguousarray(A_eq_free[keep_eq]),
            keep_eq=keep_eq,
            drop_eq=drop_eq,
            c_free=self.c[free],
            integer_mask_free=self.integer_mask[free],
            row_4c=int(newpos[self.row_4c]) if keep_ub[self.row_4c] else -1,
            row_4d=int(newpos[self.row_4d]) if keep_ub[self.row_4d] else -1,
        )
        self._pin_patterns[key] = pat
        return pat

    def pin_values(
        self, fixed_n: np.ndarray | None, fixed_m: np.ndarray | None
    ) -> np.ndarray:
        """Full-space fixed-value vector (nan where free)."""
        e, v = self.n_edges, self.num_regions
        fv = np.full(self.nx, np.nan)
        if fixed_n is not None:
            fv[e : e + v] = np.asarray(fixed_n, dtype=float)
        if fixed_m is not None:
            fm = np.asarray(fixed_m, dtype=float)
            fv[e + v :] = fm[self.eu, self.ew]
        return fv

    def outflow_c(self, pat: PinPattern | None = None) -> np.ndarray:
        """c with min c@x == max source outflow (F columns lead and are never
        pinned, so the same vector works for any pin pattern)."""
        n = pat.n_free if pat is not None else self.nx
        c = np.zeros(n)
        c[np.flatnonzero(self.eu == self.src)] = -1.0
        return c

    # ------------------------------------------------------------- scale cuts
    def scale_cuts(
        self,
        edge_scale: np.ndarray,
        agg_cap: float | np.ndarray | None = None,
        tol: float = 1e-9,
    ) -> list[tuple[np.ndarray, float]]:
        """Tightened rows for a per-edge throughput scale vector.

        ``edge_scale[k]`` (aligned with ``self.edges``) rescales edge k's
        grid throughput. For every edge with phi < 1 (phi >= 1 never
        binds next to the base 4b row and is skipped) this emits:

          * a tightened 4b row  ``F_k <= phi * tput_k / limit_conn * M_k``
            — the per-connection rate on a drifted link is down by phi;
          * with ``agg_cap`` (the data plane's shared-link capacity factor,
            ``link_capacity_scale``): an AGGREGATE row
            ``F_k <= phi * tput_k * agg_cap`` — an interconnect incident
            caps the wide-area link itself, so the solver cannot buy the
            loss back with more VMs and connections.

        ``agg_cap`` may also be a per-edge array (non-finite = uncapped):
        then an aggregate row ``F_k <= min(phi,1) * tput_k * agg_cap[k]``
        is emitted for every finite entry, drifted or not — the fleet
        controller's per-tenant fair-share caps on shared structures.

        This is how the calibration plane plans against a lower-confidence-
        bound grid: the scale vector rides the CACHED structure as
        ``extra_ub`` rows — exactly the degraded-link discipline — so a
        robust (re-)plan assembles nothing (``N_STRUCT_BUILDS`` does not
        move)."""
        edge_scale = np.asarray(edge_scale, dtype=float)
        if edge_scale.shape != (self.n_edges,):
            raise ValueError(
                f"edge_scale must have shape ({self.n_edges},), "
                f"got {edge_scale.shape}"
            )
        return _scale_cut_rows(
            self.nx, self.n_edges + self.num_regions,
            self.top.tput[self.eu, self.ew], self.top.limit_conn,
            edge_scale, agg_cap, tol,
        )

    # ----------------------------------------------------------- exact presolve
    def reduced(
        self,
        region_support: np.ndarray,
        edge_mask: np.ndarray | None = None,
    ) -> tuple["LPStructure", np.ndarray] | None:
        """Exact presolve for pinned solves: the sub-structure over supported
        regions (N_v > 0) and, optionally, supported edges (M_e > 0).

        With N_v = 0 pinned, 4f/4g force all flow through v to zero and 4h/4i
        force its connections to zero; with M_e = 0 pinned, 4b forces F_e = 0.
        Dropping those variables (and the rows that become empty) is lossless:
        the reduced LP's optimum extends by zeros to the full LP's optimum.
        Round-down refits typically keep 2-4 of 12 regions, shrinking the LP
        ~100x. Returns (sub-structure, kept region indices) — cached per
        (support, edge-mask) — or None when src/dst lost support or no edge
        survived (max-flow 0 / infeasible at any positive goal).
        """
        region_support = np.asarray(region_support, dtype=bool)
        if not (region_support[self.src] and region_support[self.dst]):
            return None
        key = (
            region_support.tobytes(),
            None if edge_mask is None else np.asarray(edge_mask, bool).tobytes(),
        )
        hit = self._reduced_cache.get(key)
        if hit is not None:
            return hit if hit != "empty" else None
        keep = np.flatnonzero(region_support)
        rtop = self.top.subgraph([int(i) for i in keep])
        if edge_mask is not None:
            rtop = rtop.with_tput(
                scale=np.asarray(edge_mask, bool)[np.ix_(keep, keep)]
            )
        rs = int(np.searchsorted(keep, self.src))
        rt = int(np.searchsorted(keep, self.dst))
        rstruct = LPStructure(rtop, rs, rt)
        if rstruct.n_edges == 0:
            self._reduced_cache[key] = "empty"
            return None
        out = (rstruct, keep)
        self._reduced_cache[key] = out
        return out

    # --------------------------------------------------------------- batch RHS
    def batch_b_ub(
        self,
        pat: PinPattern,
        goals: np.ndarray,
        pin_values: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray]:
        """RHS vectors for a batch of (tput_goal, pinned-value) variants.

        pin_values: [B, n_pin] values of the pinned variables per sample.
        Returns (b_keep [B, m_keep], trivially_infeasible [B]).
        """
        goals = np.asarray(goals, dtype=float)
        b = np.tile(self.b_ub0[None, :], (len(goals), 1))
        b[:, self.row_4c] = -goals
        b[:, self.row_4d] = -goals
        if pat.pinned.any():
            b -= np.asarray(pin_values, dtype=float) @ pat.A_ub_pin.T
        trivial = (
            (b[:, pat.drop_ub] < -_RHS_TOL).any(axis=1)
            if pat.drop_ub.any()
            else np.zeros(len(goals), dtype=bool)
        )
        return b[:, pat.keep_ub], trivial

    # ---------------------------------------------------------------- LP build
    def lp(
        self,
        tput_goal: float,
        *,
        fixed_n: np.ndarray | None = None,
        fixed_m: np.ndarray | None = None,
        extra_ub: list[tuple[np.ndarray, float]] | None = None,
    ) -> LPData:
        e, v = self.n_edges, self.num_regions
        b_ub = self.b_ub0.copy()
        b_ub[self.row_4c] = -tput_goal
        b_ub[self.row_4d] = -tput_goal

        if fixed_n is None and fixed_m is None:
            A_ub, A_eq, b_eq = self.A_ub, self.A_eq, self.b_eq
            if extra_ub:
                A_ub = np.vstack([A_ub] + [np.asarray(r, dtype=float)[None, :]
                                           for r, _ in extra_ub])
                b_ub = np.concatenate([b_ub, [float(b) for _, b in extra_ub]])
            return LPData(
                c=self.c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq.copy(),
                integer_mask=self.integer_mask, edges=self.edges,
                num_regions=v, src=self.src, dst=self.dst,
                tput_goal=tput_goal, row_4c=self.row_4c, row_4d=self.row_4d,
            )

        pat = self.pin_pattern(fixed_n is not None, fixed_m is not None)
        fv = self.pin_values(fixed_n, fixed_m)
        xpin = fv[pat.pinned]
        b_full = b_ub - pat.A_ub_pin @ xpin
        trivial = bool((b_full[pat.drop_ub] < -_RHS_TOL).any())
        A_ub_out = pat.A_ub_free
        b_ub_out = b_full[pat.keep_ub]
        if extra_ub:
            # extra rows (B&B cuts) go through the same elimination
            ex_rows = np.stack([np.asarray(r, dtype=float) for r, _ in extra_ub])
            ex_b = np.array([float(b) for _, b in extra_ub])
            ex_b = ex_b - ex_rows[:, pat.pinned] @ xpin
            ex_free = ex_rows[:, ~pat.pinned]
            ex_zero = np.abs(ex_free).max(axis=1, initial=0.0) < _ZERO_ROW_TOL
            if (ex_b[ex_zero] < -_RHS_TOL).any():
                trivial = True
            A_ub_out = np.vstack([A_ub_out, ex_free[~ex_zero]])
            b_ub_out = np.concatenate([b_ub_out, ex_b[~ex_zero]])
        # eq rows only touch F (never pinned): RHS shift is structurally zero
        return LPData(
            c=pat.c_free, A_ub=A_ub_out, b_ub=b_ub_out,
            A_eq=pat.A_eq_free, b_eq=self.b_eq[pat.keep_eq].copy(),
            integer_mask=pat.integer_mask_free, edges=self.edges,
            num_regions=v, src=self.src, dst=self.dst, tput_goal=tput_goal,
            row_4c=self.row_4c, row_4d=self.row_4d,
            fixed_values=fv, trivially_infeasible=trivial,
        )


def structure(top: Topology, src: int, dst: int) -> LPStructure:
    """The cached LPStructure for (top, src, dst). The cache lives on the
    Topology instance and is dropped whenever a new Topology is built."""
    cache = top._lp_struct_cache
    key = (src, dst)
    s = cache.get(key)
    tr = get_tracer()
    if s is None:
        _lp_cache_misses.inc()
        if tr.enabled:
            tr.instant("planner.lp_cache_miss", tr.now_wall(),
                       track="planner", key=f"{src}->{dst}")
        s = LPStructure(top, src, dst)
        cache[key] = s
    else:
        _lp_cache_hits.inc()
        if tr.enabled:
            tr.instant("planner.lp_cache_hit", tr.now_wall(),
                       track="planner", key=f"{src}->{dst}")
    return s


# ---------------------------------------------------------------- multicast
@dataclasses.dataclass
class McPinPattern:
    """Column partition + reduced matrices for one (pin_n, pin_m) choice of
    the multicast structure. Mirrors ``PinPattern`` except the goal rows are
    arrays (one 4c and one 4d row per destination commodity)."""

    pinned: np.ndarray  # [nx] bool
    A_ub_free: np.ndarray
    A_ub_pin: np.ndarray
    keep_ub: np.ndarray
    drop_ub: np.ndarray
    A_eq_free: np.ndarray
    keep_eq: np.ndarray
    drop_eq: np.ndarray
    c_free: np.ndarray
    integer_mask_free: np.ndarray
    rows_4c: np.ndarray  # [D] goal rows remapped into kept-row space
    rows_4d: np.ndarray

    @property
    def n_free(self) -> int:
        return self.A_ub_free.shape[1]


@dataclasses.dataclass
class MulticastLPData:
    """Concrete multicast LP (same contract as LPData, D commodities)."""

    c: np.ndarray
    A_ub: np.ndarray
    b_ub: np.ndarray
    A_eq: np.ndarray
    b_eq: np.ndarray
    integer_mask: np.ndarray
    edges: list[tuple[int, int]]
    num_regions: int
    src: int
    dsts: tuple[int, ...]
    goals: np.ndarray  # [D] per-destination throughput floors (Gbit/s)
    fixed_values: np.ndarray | None = None
    trivially_infeasible: bool = False

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def _full_x(self, x: np.ndarray) -> np.ndarray:
        if self.fixed_values is None:
            return x
        full = self.fixed_values.copy()
        full[np.isnan(self.fixed_values)] = x
        return full

    def split(
        self, x: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """solver x -> (G [V,V], F [D,V,V], N [V], M [V,V])."""
        x = self._full_x(np.asarray(x, dtype=float))
        e, v, d = self.n_edges, self.num_regions, len(self.dsts)
        eu, ew = _edge_arrays(self.edges)
        G = np.zeros((v, v))
        F = np.zeros((d, v, v))
        M = np.zeros((v, v))
        G[eu, ew] = x[:e]
        for k in range(d):
            F[k][eu, ew] = x[(1 + k) * e : (2 + k) * e]
        off = (1 + d) * e
        N = np.asarray(x[off : off + v], dtype=float).copy()
        M[eu, ew] = x[off + v :]
        return G, F, N, M


class MulticastLPStructure:
    """Cached multicast LP assembly for one (top, src, dsts) — the one-to-many
    extension of Eq. 4a-4j (paper §5.1.4) used by checkpoint replication.

    Decision vector:  x = [ G (E), F^0..F^{D-1} (D*E), N (V), M (E) ]

      G_e    envelope flow on edge e — the rate at which *bytes actually
             traverse* the link. A chunk forwarded over a hop serves every
             downstream destination, so egress is billed on G exactly once
             no matter how many commodities ride the link.
      F^d_e  commodity flow toward destination d (F^d_e <= G_e).
      N, M   shared VM / connection allocations, as in the unicast MILP.

    Objective: <G, Cost_egress> + <N, Cost_vm> — the "bill each link once"
    cost lever that makes one-to-many trees cheaper than N unicasts.

    Inequality rows, fixed order (D = len(dsts)):
      4b   G_e <= (tput_e / limit_conn) * M_e                     [E]
      dom  F^d_e <= G_e                                           [D*E]
      4c   sum_{e out of src} F^d_e >= goal_d                     [D]
      4d   sum_{e into d} F^d_e >= goal_d                         [D]
      4f/4g  VM ingress/egress caps on G                          [2V]
      4h/4i  connection caps                                      [2V]
      4j   N_v <= Limit_vm                                        [V]
    Equalities: per-commodity flow conservation at every touched region
    except {src, d} (a destination may relay to other destinations).

    Like ``LPStructure``, assembly is O(rows*cols) exactly once per
    (topology, src, dsts) — counted in ``N_STRUCT_BUILDS`` — and every
    variant (per-goal RHS, pinned N/M refits, degraded-link cuts via
    ``extra_ub``) derives in O(rows) from the cached matrices, so
    failure-driven re-planning is a pure cache hit.
    """

    def __init__(self, top: Topology, src: int, dsts: tuple[int, ...]):
        _struct_builds.inc()
        self.top = top
        self.src = src
        self.dsts = tuple(int(d) for d in dsts)
        if src in self.dsts:
            raise ValueError("source cannot be a multicast destination")
        if len(set(self.dsts)) != len(self.dsts):
            raise ValueError("duplicate multicast destinations")
        # edges into the source are never useful; edges out of a destination
        # stay (a destination can relay on toward another destination)
        self.edges = top.edge_list(src, None)
        self.eu, self.ew = _edge_arrays(self.edges)
        e, v, D = len(self.edges), top.num_regions, len(self.dsts)
        self.n_edges = e
        self.num_regions = v
        self.n_dsts = D
        nx = (1 + D) * e + v + e
        self.nx = nx
        self.iN = (1 + D) * e  # first N column
        self.iM = (1 + D) * e + v  # first M column
        ar = np.arange(e)

        # ---- objective: egress billed once on the envelope, VMs as usual
        c = np.zeros(nx)
        c[:e] = top.price_egress[self.eu, self.ew] / GBIT_PER_GB
        c[self.iN : self.iN + v] = top.price_vm
        self.c = c

        # ---- A_ub in the fixed row order documented above
        m_ub = e + D * e + 2 * D + 5 * v
        self.rows_4c = e + D * e + np.arange(D)
        self.rows_4d = e + D * e + D + np.arange(D)
        r_4f = e + D * e + 2 * D
        A = np.zeros((m_ub, nx))
        b0 = np.zeros(m_ub)
        # 4b on the envelope
        A[ar, ar] = 1.0
        A[ar, self.iM + ar] = -top.tput[self.eu, self.ew] / top.limit_conn
        # dominance F^d <= G
        for k in range(D):
            A[e + k * e + ar, (1 + k) * e + ar] = 1.0
            A[e + k * e + ar, ar] = -1.0
        # 4c / 4d per commodity (b filled per-goal in lp())
        for k, d in enumerate(self.dsts):
            A[self.rows_4c[k], (1 + k) * e + ar[self.eu == src]] = -1.0
            A[self.rows_4d[k], (1 + k) * e + ar[self.ew == d]] = -1.0
        # 4f / 4g on the envelope
        A[r_4f + self.ew, ar] = 1.0
        A[r_4f + np.arange(v), self.iN + np.arange(v)] = -top.limit_ingress
        A[r_4f + v + self.eu, ar] = 1.0
        A[r_4f + v + np.arange(v), self.iN + np.arange(v)] = -top.limit_egress
        # 4h / 4i
        A[r_4f + 2 * v + self.eu, self.iM + ar] = 1.0
        A[r_4f + 2 * v + np.arange(v), self.iN + np.arange(v)] = -float(top.limit_conn)
        A[r_4f + 3 * v + self.ew, self.iM + ar] = 1.0
        A[r_4f + 3 * v + np.arange(v), self.iN + np.arange(v)] = -float(top.limit_conn)
        # 4j
        A[r_4f + 4 * v + np.arange(v), self.iN + np.arange(v)] = 1.0
        b0[r_4f + 4 * v :] = float(top.limit_vm)
        self.A_ub = A
        self.b_ub0 = b0

        # ---- per-commodity flow conservation
        inc = np.zeros((v, e))
        np.add.at(inc, (self.ew, ar), 1.0)
        np.add.at(inc, (self.eu, ar), -1.0)
        touched = np.zeros(v, dtype=bool)
        touched[self.eu] = True
        touched[self.ew] = True
        eq_rows = []
        for k, d in enumerate(self.dsts):
            relay = touched.copy()
            relay[[src, d]] = False
            if not relay.any():
                continue
            block = np.zeros((int(relay.sum()), nx))
            block[:, (1 + k) * e : (2 + k) * e] = inc[relay]
            eq_rows.append(block)
        self.A_eq = np.vstack(eq_rows) if eq_rows else np.zeros((0, nx))
        self.b_eq = np.zeros(self.A_eq.shape[0])

        self.integer_mask = np.zeros(nx, dtype=bool)
        self.integer_mask[self.iN :] = True  # N and M

        self._pin_patterns: dict[tuple[bool, bool], McPinPattern] = {}
        self._reduced_cache: dict = {}

    # ----------------------------------------------------------- exact presolve
    def reduced(
        self, region_support: np.ndarray
    ) -> tuple["MulticastLPStructure", np.ndarray] | None:
        """Exact presolve for pinned solves: the sub-structure over supported
        regions. The source and every destination are force-kept even with
        N = 0 pinned — their 4f/4g rows then force zero delivery, which the
        scale probe reports faithfully — so only dead relays are dropped
        (lossless, as in ``LPStructure.reduced``). Cached per support;
        returns None when no edge survives."""
        region_support = np.asarray(region_support, dtype=bool).copy()
        region_support[[self.src, *self.dsts]] = True
        key = region_support.tobytes()
        hit = self._reduced_cache.get(key)
        if hit is not None:
            return hit if hit != "empty" else None
        keep = np.flatnonzero(region_support)
        rtop = self.top.subgraph([int(i) for i in keep])
        rs = int(np.searchsorted(keep, self.src))
        rds = tuple(int(np.searchsorted(keep, d)) for d in self.dsts)
        rstruct = MulticastLPStructure(rtop, rs, rds)
        if rstruct.n_edges == 0:
            self._reduced_cache[key] = "empty"
            return None
        out = (rstruct, keep)
        self._reduced_cache[key] = out
        return out

    def reduced_cached(self, region_support: np.ndarray):
        """Like ``reduced`` but NEVER assembles: returns the cached
        reduction, None for a cached-empty support, or "miss". Constrained
        re-plans use this so a cold support falls back to the full-size
        solve instead of building a structure mid-replan (the
        N_STRUCT_BUILDS == 0 contract of failure-driven re-planning)."""
        region_support = np.asarray(region_support, dtype=bool).copy()
        region_support[[self.src, *self.dsts]] = True
        hit = self._reduced_cache.get(region_support.tobytes())
        if hit is None:
            return "miss"
        return None if hit == "empty" else hit

    # ------------------------------------------------------------ pin patterns
    def pin_pattern(self, pin_n: bool, pin_m: bool) -> McPinPattern:
        key = (pin_n, pin_m)
        pat = self._pin_patterns.get(key)
        if pat is not None:
            return pat
        v = self.num_regions
        pinned = np.zeros(self.nx, dtype=bool)
        if pin_n:
            pinned[self.iN : self.iN + v] = True
        if pin_m:
            pinned[self.iM :] = True
        free = ~pinned
        A_ub_free = self.A_ub[:, free]
        A_eq_free = self.A_eq[:, free]
        drop_ub = (
            np.abs(A_ub_free).max(axis=1, initial=0.0) < _ZERO_ROW_TOL
            if pinned.any()
            else np.zeros(self.A_ub.shape[0], dtype=bool)
        )
        # eq rows only touch F columns, which are never pinned
        drop_eq = np.zeros(self.A_eq.shape[0], dtype=bool)
        keep_ub = ~drop_ub
        newpos = np.cumsum(keep_ub) - 1
        # goal rows touch F columns only: never dropped by pinning
        pat = McPinPattern(
            pinned=pinned,
            A_ub_free=np.ascontiguousarray(A_ub_free[keep_ub]),
            A_ub_pin=np.ascontiguousarray(self.A_ub[:, pinned]),
            keep_ub=keep_ub,
            drop_ub=drop_ub,
            A_eq_free=np.ascontiguousarray(A_eq_free),
            keep_eq=~drop_eq,
            drop_eq=drop_eq,
            c_free=self.c[free],
            integer_mask_free=self.integer_mask[free],
            rows_4c=newpos[self.rows_4c].astype(np.int64),
            rows_4d=newpos[self.rows_4d].astype(np.int64),
        )
        self._pin_patterns[key] = pat
        return pat

    def pin_values(
        self, fixed_n: np.ndarray | None, fixed_m: np.ndarray | None
    ) -> np.ndarray:
        fv = np.full(self.nx, np.nan)
        if fixed_n is not None:
            fv[self.iN : self.iN + self.num_regions] = np.asarray(
                fixed_n, dtype=float
            )
        if fixed_m is not None:
            fm = np.asarray(fixed_m, dtype=float)
            fv[self.iM :] = fm[self.eu, self.ew]
        return fv

    # ------------------------------------------------------------- scale cuts
    def scale_cuts(
        self,
        edge_scale: np.ndarray,
        agg_cap: float | np.ndarray | None = None,
        tol: float = 1e-9,
    ) -> list[tuple[np.ndarray, float]]:
        """Tightened rows on the ENVELOPE for a per-edge scale vector —
        the multicast analogue of ``LPStructure.scale_cuts`` (what crosses
        the wire is G, so the lower-confidence-bound grid binds G; the
        ``agg_cap`` aggregate row likewise). Rows ride the cached
        structure as ``extra_ub``; nothing re-assembles."""
        edge_scale = np.asarray(edge_scale, dtype=float)
        if edge_scale.shape != (self.n_edges,):
            raise ValueError(
                f"edge_scale must have shape ({self.n_edges},), "
                f"got {edge_scale.shape}"
            )
        return _scale_cut_rows(
            self.nx, self.iM,
            self.top.tput[self.eu, self.ew], self.top.limit_conn,
            edge_scale, agg_cap, tol,
        )

    # ---------------------------------------------------------------- LP build
    def _b_and_trivial(
        self,
        goals: np.ndarray,
        pat: McPinPattern,
        fv: np.ndarray,
        extra_ub,
    ):
        """(b_ub_kept, A_extra_free, b_extra, trivially_infeasible)."""
        b_ub = self.b_ub0.copy()
        b_ub[self.rows_4c] = -goals
        b_ub[self.rows_4d] = -goals
        trivial = False
        if pat.pinned.any():
            xpin = fv[pat.pinned]
            b_ub = b_ub - pat.A_ub_pin @ xpin
            trivial = bool((b_ub[pat.drop_ub] < -_RHS_TOL).any())
        A_ex, b_ex = None, None
        if extra_ub:
            ex_rows = np.stack([np.asarray(r, dtype=float) for r, _ in extra_ub])
            ex_b = np.array([float(b) for _, b in extra_ub])
            if pat.pinned.any():
                ex_b = ex_b - ex_rows[:, pat.pinned] @ fv[pat.pinned]
            ex_free = ex_rows[:, ~pat.pinned]
            ex_zero = np.abs(ex_free).max(axis=1, initial=0.0) < _ZERO_ROW_TOL
            if (ex_b[ex_zero] < -_RHS_TOL).any():
                trivial = True
            A_ex, b_ex = ex_free[~ex_zero], ex_b[~ex_zero]
        return b_ub[pat.keep_ub], A_ex, b_ex, trivial

    def lp(
        self,
        goals: np.ndarray,
        *,
        fixed_n: np.ndarray | None = None,
        fixed_m: np.ndarray | None = None,
        extra_ub: list[tuple[np.ndarray, float]] | None = None,
    ) -> MulticastLPData:
        """O(rows) multicast LP for per-destination goals (Gbit/s)."""
        goals = np.asarray(goals, dtype=float)
        pat = self.pin_pattern(fixed_n is not None, fixed_m is not None)
        fv = self.pin_values(fixed_n, fixed_m)
        b_keep, A_ex, b_ex, trivial = self._b_and_trivial(
            goals, pat, fv, extra_ub
        )
        A_ub = pat.A_ub_free
        if A_ex is not None and A_ex.size:
            A_ub = np.vstack([A_ub, A_ex])
            b_keep = np.concatenate([b_keep, b_ex])
        return MulticastLPData(
            c=pat.c_free, A_ub=A_ub, b_ub=b_keep,
            A_eq=pat.A_eq_free, b_eq=self.b_eq.copy(),
            integer_mask=pat.integer_mask_free, edges=self.edges,
            num_regions=self.num_regions, src=self.src, dsts=self.dsts,
            goals=goals,
            fixed_values=fv if pat.pinned.any() else None,
            trivially_infeasible=trivial,
        )

    def probe_lp(
        self,
        goals: np.ndarray,
        *,
        fixed_n: np.ndarray | None = None,
        fixed_m: np.ndarray | None = None,
        extra_ub: list[tuple[np.ndarray, float]] | None = None,
        cap: float | None = 1.0,
    ):
        """Uniform-scale feasibility probe: max t s.t. every commodity
        delivers >= t * goal_d. Always feasible (x=0, t=0), so the round-down
        pipeline never hands the IPM an infeasible instance — the multicast
        analogue of the unicast max-flow probe.

        Returns (c, A_ub, b_ub, A_eq, b_eq) over [free columns | t], or None
        when the pinned RHS is trivially infeasible. ``cap`` bounds t (1.0
        for feasibility checks — only "can we hit the goals" matters; None
        for max-rate probes with unit goals).
        """
        goals = np.asarray(goals, dtype=float)
        pat = self.pin_pattern(fixed_n is not None, fixed_m is not None)
        fv = self.pin_values(fixed_n, fixed_m)
        # goal rows move into the t column: RHS uses goals=0
        b_keep, A_ex, b_ex, trivial = self._b_and_trivial(
            np.zeros_like(goals), pat, fv, extra_ub
        )
        if trivial:
            return None
        tcol = np.zeros(self.A_ub.shape[0])
        tcol[self.rows_4c] = goals
        tcol[self.rows_4d] = goals
        A_ub = np.hstack([pat.A_ub_free, tcol[pat.keep_ub][:, None]])
        if A_ex is not None and A_ex.size:
            A_ub = np.vstack(
                [A_ub, np.hstack([A_ex, np.zeros((A_ex.shape[0], 1))])]
            )
            b_keep = np.concatenate([b_keep, b_ex])
        if cap is not None:
            cap_row = np.zeros(A_ub.shape[1])
            cap_row[-1] = 1.0
            A_ub = np.vstack([A_ub, cap_row[None, :]])
            b_keep = np.concatenate([b_keep, [float(cap)]])
        A_eq = np.hstack(
            [pat.A_eq_free, np.zeros((pat.A_eq_free.shape[0], 1))]
        )
        c = np.zeros(A_ub.shape[1])
        c[-1] = -1.0
        return c, A_ub, b_keep, A_eq, self.b_eq.copy()


def multicast_structure(
    top: Topology, src: int, dsts: Sequence[int]
) -> MulticastLPStructure:
    """The cached MulticastLPStructure for (top, src, dsts). Shares the
    Topology-instance cache with the unicast structures (distinct key space),
    so re-planning a degraded multicast job is a pure cache hit."""
    cache = top._lp_struct_cache
    key = ("mc", src, tuple(int(d) for d in dsts))
    s = cache.get(key)
    tr = get_tracer()
    if s is None:
        _lp_cache_misses.inc()
        if tr.enabled:
            tr.instant("planner.lp_cache_miss", tr.now_wall(),
                       track="planner", key=f"{src}->mc{list(key[2])}")
        s = MulticastLPStructure(top, src, tuple(int(d) for d in dsts))
        cache[key] = s
    else:
        _lp_cache_hits.inc()
        if tr.enabled:
            tr.instant("planner.lp_cache_hit", tr.now_wall(),
                       track="planner", key=f"{src}->mc{list(key[2])}")
    return s


def build_lp(
    top: Topology,
    src: int,
    dst: int,
    tput_goal: float,
    *,
    fixed_n: np.ndarray | None = None,
    fixed_m: np.ndarray | None = None,
    extra_ub: list[tuple[np.ndarray, float]] | None = None,
) -> LPData:
    """Build Eq. 4a-4j for a single s->t job on ``top``.

    fixed_n: if given, adds N_v == fixed_n[v] equality rows (used when
      re-fitting F, M after integer rounding of N).
    fixed_m: if given, adds M_e == fixed_m[u,w] equality rows (round-down
      refit of F with both integer allocations pinned, §5.1.3).
    extra_ub: extra inequality rows (used by branch & bound for bound cuts).
    """
    return structure(top, src, dst).lp(
        tput_goal, fixed_n=fixed_n, fixed_m=fixed_m, extra_ub=extra_ub
    )


def build_lp_reference(
    top: Topology,
    src: int,
    dst: int,
    tput_goal: float,
    *,
    fixed_n: np.ndarray | None = None,
    fixed_m: np.ndarray | None = None,
    extra_ub: list[tuple[np.ndarray, float]] | None = None,
) -> LPData:
    """Original pure-Python row-loop assembly; oracle for LPStructure."""
    v = top.num_regions
    edges = top.edge_list(src, dst)
    e = len(edges)
    nx = 2 * e + v
    def iF(k):
        return k

    def iN(r):
        return e + r

    def iM(k):
        return e + v + k

    # ---- objective: $/s of the running transfer (Eq. 4a without the constant)
    c = np.zeros(nx)
    for k, (u, w) in enumerate(edges):
        c[iF(k)] = top.price_egress[u, w] / GBIT_PER_GB  # $/Gbit * Gbit/s = $/s
    for r in range(v):
        c[iN(r)] = top.price_vm[r]

    rows_ub: list[np.ndarray] = []
    b_ub: list[float] = []

    def add_ub(row: np.ndarray, b: float) -> int:
        rows_ub.append(row)
        b_ub.append(b)
        return len(b_ub) - 1

    # ---- 4b: per-connection throughput cap
    for k, (u, w) in enumerate(edges):
        row = np.zeros(nx)
        row[iF(k)] = 1.0
        row[iM(k)] = -top.tput[u, w] / top.limit_conn
        add_ub(row, 0.0)

    # ---- 4c / 4d: goal throughput at the endpoints (>=, negated into <=)
    row = np.zeros(nx)
    for k, (u, w) in enumerate(edges):
        if u == src:
            row[iF(k)] = -1.0
    row_4c = add_ub(row, -tput_goal)

    row = np.zeros(nx)
    for k, (u, w) in enumerate(edges):
        if w == dst:
            row[iF(k)] = -1.0
    row_4d = add_ub(row, -tput_goal)

    # ---- 4f / 4g: per-region ingress/egress scaled by VM count
    for r in range(v):
        row = np.zeros(nx)
        for k, (u, w) in enumerate(edges):
            if w == r:
                row[iF(k)] = 1.0
        row[iN(r)] = -top.limit_ingress[r]
        add_ub(row, 0.0)
    for r in range(v):
        row = np.zeros(nx)
        for k, (u, w) in enumerate(edges):
            if u == r:
                row[iF(k)] = 1.0
        row[iN(r)] = -top.limit_egress[r]
        add_ub(row, 0.0)

    # ---- 4h / 4i: connection count scaled by VM count (erratum-corrected)
    for r in range(v):
        row = np.zeros(nx)
        for k, (u, w) in enumerate(edges):
            if u == r:
                row[iM(k)] = 1.0
        row[iN(r)] = -float(top.limit_conn)
        add_ub(row, 0.0)
    for r in range(v):
        row = np.zeros(nx)
        for k, (u, w) in enumerate(edges):
            if w == r:
                row[iM(k)] = 1.0
        row[iN(r)] = -float(top.limit_conn)
        add_ub(row, 0.0)

    # ---- 4j: per-region VM limit
    for r in range(v):
        row = np.zeros(nx)
        row[iN(r)] = 1.0
        add_ub(row, float(top.limit_vm))

    if extra_ub:
        for row, b in extra_ub:
            add_ub(np.asarray(row, dtype=float), float(b))

    # ---- 4e: flow conservation at relays
    rows_eq: list[np.ndarray] = []
    b_eq: list[float] = []
    for r in range(v):
        if r in (src, dst):
            continue
        row = np.zeros(nx)
        touched = False
        for k, (u, w) in enumerate(edges):
            if w == r:
                row[iF(k)] += 1.0
                touched = True
            if u == r:
                row[iF(k)] -= 1.0
                touched = True
        if touched:
            rows_eq.append(row)
            b_eq.append(0.0)

    integer_mask = np.zeros(nx, dtype=bool)
    integer_mask[e : e + v] = True  # N
    integer_mask[e + v :] = True  # M

    A_ub = np.array(rows_ub) if rows_ub else np.zeros((0, nx))
    b_ub_arr = np.array(b_ub)
    A_eq = np.array(rows_eq) if rows_eq else np.zeros((0, nx))
    b_eq_arr = np.array(b_eq)

    # ---- eliminate pinned variables (numerically cleaner than eq rows)
    fixed_values = None
    trivially_infeasible = False
    if fixed_n is not None or fixed_m is not None:
        fixed_values = np.full(nx, np.nan)
        if fixed_n is not None:
            fixed_values[e : e + v] = np.asarray(fixed_n, dtype=float)
        if fixed_m is not None:
            for k, (u, w) in enumerate(edges):
                fixed_values[iM(k)] = float(fixed_m[u, w])
        pinned = ~np.isnan(fixed_values)
        xb = np.where(pinned, fixed_values, 0.0)
        if A_ub.size:
            b_ub_arr = b_ub_arr - A_ub @ xb
            A_ub = A_ub[:, ~pinned]
        if A_eq.size:
            b_eq_arr = b_eq_arr - A_eq @ xb
            A_eq = A_eq[:, ~pinned]
        c = c[~pinned]
        integer_mask = integer_mask[~pinned]
        # drop rows that became vacuous; detect trivial infeasibility
        if A_ub.size:
            zero = np.abs(A_ub).max(axis=1) < _ZERO_ROW_TOL
            if (b_ub_arr[zero] < -_RHS_TOL).any():
                trivially_infeasible = True
            A_ub = A_ub[~zero]
            b_ub_arr = b_ub_arr[~zero]
        if A_eq.size:
            zero = np.abs(A_eq).max(axis=1) < _ZERO_ROW_TOL
            if (np.abs(b_eq_arr[zero]) > _RHS_TOL).any():
                trivially_infeasible = True
            A_eq = A_eq[~zero]
            b_eq_arr = b_eq_arr[~zero]

    return LPData(
        c=c,
        A_ub=A_ub,
        b_ub=b_ub_arr,
        A_eq=A_eq,
        b_eq=b_eq_arr,
        integer_mask=integer_mask,
        edges=edges,
        num_regions=v,
        src=src,
        dst=dst,
        tput_goal=tput_goal,
        row_4c=row_4c,
        row_4d=row_4d,
        fixed_values=fixed_values,
        trivially_infeasible=trivially_infeasible,
    )
