"""Seeded numpy inputs shared by the port's kernel tests: the CPU tests
that hold the plain versions against the reference, and the ``gpu`` tests
that hold the CUDA kernels against the plain versions (which import no
jax, so they run on a card's machine without it). The sim scenarios are
built with the port alone for the same reason. ``one_thread`` is the
fixture a test file imports to run its tests on one CPU thread."""

from __future__ import annotations

import numpy as np
import pytest


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One BLAS, OpenMP and intra-op thread while the importing module
    runs: the suite runs in several worker processes at once, and torch's
    and numpy's thread pools, each as wide as the host, would otherwise
    contend for its cores (most of these tests run many small ops, which
    gain nothing from more threads)."""
    import torch
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(n)


def waterfill_case(seed, *, with_edges):
    """A padded max-min scenario: nc live lanes scattered across ncp slots,
    junk caps in the dead lanes (the mask must neutralize them)."""
    rng = np.random.default_rng(seed)
    nv = int(rng.integers(2, 10))
    nc = int(rng.integers(1, 40))
    ncp = nc + int(rng.integers(0, 17))
    active = np.zeros(ncp, dtype=bool)
    active[rng.permutation(ncp)[:nc]] = True
    caps = np.where(active, rng.uniform(0.5, 8.0, ncp), 123.0)
    src = rng.integers(0, nv, ncp)
    dst = rng.integers(0, nv, ncp)
    eg = rng.uniform(1.0, 12.0, nv)
    inn = rng.uniform(1.0, 12.0, nv)
    if with_edges:
        ne = int(rng.integers(1, 5))
        eid = rng.integers(0, ne, ncp)
        ed = rng.uniform(2.0, 20.0, ne)
    else:
        ne, eid, ed = 0, np.zeros(ncp, dtype=np.int64), None
    return caps, src, dst, eg, inn, eid, ed, active, nv, ne


WATERFILL_CHAIN_CASES = ("one_segment", "all_tied", "zero_caps")


def waterfill_chain_case(name):
    """Cases that stress the ordered budget chains, in ``waterfill_case``'s
    layout, with edges: 300 live lanes among 330 (several per thread, ten
    32-lane steps per long segment).

    ``one_segment``: one VM sends on every lane over one edge, so a single
    egress and a single edge segment hold every lane. ``all_tied``: equal
    caps and budgets, lanes spread evenly, so every lane ties at the
    threshold and is fixed in the same round. ``zero_caps``: a third of
    the caps are 0.0 and one VM has no budget, so rounds fix runs of
    zero rates between nonzero ones."""
    rng = np.random.default_rng(17)
    nc, ncp, nv = 300, 330, 6
    active = np.zeros(ncp, dtype=bool)
    active[rng.permutation(ncp)[:nc]] = True
    src = rng.integers(0, nv, ncp)
    dst = rng.integers(0, nv, ncp)
    eg = rng.uniform(50.0, 400.0, nv)
    inn = rng.uniform(50.0, 400.0, nv)
    caps = np.where(active, rng.uniform(0.5, 8.0, ncp), 123.0)
    ne, eid, ed = 1, np.zeros(ncp, dtype=np.int64), np.array([300.0])
    if name == "one_segment":
        src[:] = 0
        caps = np.where(active, rng.uniform(5.0, 50.0, ncp), 123.0)
    elif name == "all_tied":
        lanes = np.arange(ncp)
        src, dst = lanes % nv, (lanes + 1) % nv
        active[:] = True
        caps = np.full(ncp, 1e3)
        eg = inn = np.full(nv, 110.0)
        ed = np.array([1e9])
    elif name == "zero_caps":
        caps = np.where(rng.uniform(size=ncp) < 1 / 3, 0.0, caps)
        eg[2] = 0.0
        ne = 3
        eid = rng.integers(0, ne, ncp)
        ed = np.array([30.0, 400.0, 90.0])
    else:
        raise KeyError(name)
    return caps, src, dst, eg, inn, eid, ed, active, nv, ne


SEGSUM_CASES = ("zeros_between", "empty_segments", "long_segment",
                "equal_run", "many_segments")


def segsum_case(name):
    """(values f64, segment of each lane, segment count) for the ordered
    segment sum: zeros (and -0.0) between nonzeros, empty segments, one
    segment of 12,000 lanes, a run of 1,000 equal values whose sum
    rounds at every step, and 1,000 short segments."""
    rng = np.random.default_rng(23)
    if name == "zeros_between":
        n, nseg = 500, 3
        v = rng.uniform(0.0, 5.0, n) * (rng.uniform(size=n) < 0.4)
        v[rng.permutation(n)[:20]] = -0.0
        return v, rng.integers(0, nseg, n), nseg
    if name == "empty_segments":
        n, nseg = 200, 10
        return rng.uniform(0.0, 5.0, n), rng.choice([1, 4, 9], n), nseg
    if name == "long_segment":
        n = 12_000
        seg = np.zeros(n, dtype=np.int64)
        seg[rng.permutation(n)[:50]] = 1
        return rng.uniform(0.0, 3.0, n), seg, 2
    if name == "equal_run":
        v = np.full(1500, 0.1)
        v[:300] = rng.uniform(0.0, 1e6, 300)
        return v, np.zeros(1500, dtype=np.int64), 1
    if name == "many_segments":
        n, nseg = 5000, 1000
        return rng.uniform(-2.0, 5.0, n), rng.integers(0, nseg, n), nseg
    raise KeyError(name)


# a fleet of direct jobs of 8 VMs x 64 connections each (512 lanes a job,
# the topology's per-VM and per-region limits) over three routes: about
# 22 such jobs fill one block's shared memory in a water-filling solve, so
# 48 take twice that (24,576 lanes, 768 VMs)
FLEET_ROUTES = (("aws:us-east-1", "aws:ap-southeast-2"),
                ("aws:us-west-2", "aws:eu-central-1"),
                ("gcp:us-central1", "gcp:europe-west1"))


def fleet_jobs(top, n_jobs: int, chunks: int = 8):
    """``n_jobs`` staggered direct jobs of 8 VMs x 64 connections and
    ``chunks`` chunks of 16 MB each, built with the port's own planner."""
    from repro_torch.core import direct_plan
    from repro_torch.transfer import TransferJob

    return [TransferJob(
        direct_plan(top, *FLEET_ROUTES[i % 3], chunks * 16.0 / 1024,
                    num_vms=8),
        f"fleet{i}", chunk_mb=16.0, arrival_s=0.01 * i)
        for i in range(n_jobs)]


SIM_SCENARIOS = ("plain", "every_event", "horizon_cut", "horizon_drain",
                 "contention_off", "multicast_mix", "tied_arrivals",
                 "relay_buffer_1")
_SRC, _DST, _SRC2 = "aws:us-west-2", "aws:eu-central-1", "gcp:us-central1"


def sim_scenario(name, top):
    """(jobs, faults, sim kwargs) of each ``tests/test_sim_engines.py``
    scenario, and the multicast mix with a relay buffer of one chunk,
    built with the port's own planner and events (``top`` is the port's
    ``default_topology()``)."""
    from repro_torch.core import Planner, PlanSpec, direct_plan
    from repro_torch.transfer import (GrayFailure, LinkDegrade, LinkRestore,
                                      TransferJob, VMFailure)

    s, d, s2 = top.index(_SRC), top.index(_DST), top.index(_SRC2)

    def job(src, name, arrival=0.0, volume=0.5):
        return TransferJob(direct_plan(top, src, _DST, volume, num_vms=2),
                           name, arrival_s=arrival)

    unicast = [job(_SRC, "a"), job(_SRC, "b", 1.0), job(_SRC2, "c")]
    if name == "plain":
        return unicast, [], {}
    if name == "every_event":
        return unicast, [
            LinkDegrade(t_s=0.5, src=s, dst=d, factor=0.5),
            GrayFailure(t_s=0.8, src=s2, dst=d, factor=0.4),
            VMFailure(t_s=1.0, job=0, region=s, count=1),
            LinkRestore(t_s=1.4, src=s, dst=d, factor=2.0),
            GrayFailure(t_s=1.6, src=s2, dst=d, factor=2.5),
        ], {}
    if name in ("horizon_cut", "horizon_drain"):
        return unicast, [LinkDegrade(t_s=0.4, src=s, dst=d, factor=0.3)], {
            "horizon_s": 1.0, "drain": name == "horizon_drain"}
    if name == "contention_off":
        return unicast, [], {"link_capacity_scale": None}
    if name in ("multicast_mix", "relay_buffer_1"):
        mc = Planner(top, max_relays=6).plan(PlanSpec(
            objective="cost_min", src=_SRC2,
            dsts=("gcp:europe-west1", "gcp:europe-west3", "gcp:europe-west4"),
            tput_goal_gbps=2.0, volume_gb=1.0,
        ))
        kill = next(int(r) for r in mc.dsts if mc.N[r] >= 1)
        kw = {"relay_buffer_chunks": 1} if name == "relay_buffer_1" else {}
        return ([TransferJob(mc, "repl"), job(_SRC, "uni", 0.5)],
                [VMFailure(t_s=0.8, job=0, region=kill, count=1)], kw)
    if name == "tied_arrivals":
        return [job(_SRC, "x", 1.0, 0.25), job(_SRC2, "y", 1.0, 0.25),
                job(_SRC, "z", 0.0, 0.25)], [], {}
    raise KeyError(name)


# Skyplane's OPT-66B broadcast test: the source and its six destinations
BCAST_SRC = "gcp:us-east1"
BCAST_DSTS = ("gcp:australia-southeast1", "gcp:southamerica-east1",
              "gcp:europe-west4", "gcp:europe-west6", "gcp:asia-east1",
              "gcp:europe-west2")
# the sim's count of solves, on the benchmark's two deployments at a CPU's
# size: case -> (plan, relay buffer in chunks, with scripted faults)
SOLVE_CASES = {
    "bcast": ("bcast", 64, False),
    "direct": ("direct", 64, False),
    "bcast_relay_full": ("bcast", 1, False),
    "bcast_events": ("bcast", 64, True),
}
SOLVE_CHUNKS, SOLVE_CHUNK_MB, SOLVE_SEED = 200, 64.0, 1_826_701_614


def solve_plans(core):
    """(topology, broadcast plan, direct plan), 64 connections a VM, built
    with ``core`` (the port's or the reference's package): the broadcast
    planned cost_min at 10 Gbit/s to each destination with no relay region
    beyond the destinations (12 VMs in the 7 regions, 36 edges, 637
    connections, planned in seconds), the direct plan 2 VMs a region from
    ``aws:us-west-2`` to ``aws:eu-central-1``; each scoped to 200 chunks
    of 64 MB."""
    import dataclasses

    top = dataclasses.replace(core.default_topology(), limit_conn=64)
    gb = SOLVE_CHUNKS * SOLVE_CHUNK_MB / 1024
    bcast = core.Planner(top, max_relays=0).plan(core.PlanSpec(
        objective="cost_min", src=BCAST_SRC, dsts=BCAST_DSTS,
        tput_goal_gbps=10.0, volume_gb=123.0, backend="numpy",
    )).with_volume(gb)
    direct = core.direct_plan(top, _SRC, _DST, gb, num_vms=2)
    return top, bcast, direct


def solve_case(name, plans, transfer):
    """(jobs, faults, sim kwargs, sim seed) of a ``SOLVE_CASES`` entry,
    from ``solve_plans``' output and the same package's ``transfer``: the
    benchmark's sim knobs; the faults halve the broadcast's first hop to
    ``southamerica-east1`` and restore it, and lose a VM of
    ``europe-west6``, a destination that relays."""
    top, bcast, direct = plans
    which, relay, with_faults = SOLVE_CASES[name]
    plan = bcast if which == "bcast" else direct
    jobs = [transfer.TransferJob(plan, name, chunk_mb=SOLVE_CHUNK_MB)]
    faults = []
    if with_faults:
        a, b = top.index(BCAST_SRC), top.index("gcp:southamerica-east1")
        faults = [
            transfer.LinkDegrade(t_s=10.0, src=a, dst=b, factor=0.5),
            transfer.VMFailure(t_s=20.0, job=0,
                               region=top.index("gcp:europe-west6"), count=1),
            transfer.LinkRestore(t_s=30.0, src=a, dst=b, factor=2.0),
        ]
    kw = dict(link_capacity_scale=2.0, straggler_prob=0.05,
              straggler_speed=(0.15, 0.5), relay_buffer_chunks=relay)
    return jobs, faults, kw, SOLVE_SEED


def qkv(seed, b, s, h, kv, d):
    """f32 q [B,S,H,D] and k, v [B,S,Kv,D]."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32))


def ssd_inputs(seed, b, h, s, p, n, *, layout="bhsp"):
    """x, dt, a, B, C (f32) in the kernel's [B,H,S,P] layout or the
    model's [B,S,H,P]."""
    rng = np.random.default_rng(seed)
    shape_x = (b, h, s, p) if layout == "bhsp" else (b, s, h, p)
    shape_dt = (b, h, s) if layout == "bhsp" else (b, s, h)
    x = rng.standard_normal(shape_x).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal(shape_dt))).astype(np.float32)
    a = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bm, cm


def quantize_inputs(case: str):
    """(x f32, block) for the quantizer: the lengths of the reference's
    compression tests, a ragged tail, half-way ties, zeros and a leaf of
    several dims."""
    rng = np.random.default_rng(11)
    if case == "ties":
        # absmax 127 makes the scale exactly 1, so x / scale is x
        x = np.zeros(256, np.float32)
        x[:9] = [2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 1.5, -1.5, 127.0]
        x[9:] = rng.uniform(-100, 100, 247).astype(np.float32)
        return x, 256
    if case == "zeros":
        return np.zeros((3, 5, 7), np.float32), 16
    if case == "leaf_3d":
        return rng.standard_normal((3, 17, 29)).astype(np.float32), 256
    if case == "huge_and_tiny":
        x = rng.standard_normal(2048).astype(np.float32)
        x[:256] *= 1e30
        x[256:512] *= 1e-30
        return x, 256
    n, block, scale = {
        "normal_1024": (1024, 256, 1.0), "ragged_1000": (1000, 256, 1.0),
        "tiny_7_block4": (7, 4, 1.0), "one_block_256": (256, 256, 1.0),
        "scaled_4000": (4000, 256, 1e3),
    }[case]
    return (rng.standard_normal(n) * scale).astype(np.float32), block
