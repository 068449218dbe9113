"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card: a CUDA
kernel has no CPU mode. The file imports no jax and nothing of the
reference package, so it runs on a card's machine that has neither:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

The CPU tests (``test_torch_waterfill``, ``test_torch_flash_attention``,
``test_torch_ssd_scan``, ``test_torch_quantize``) hold the same plain
versions against the reference; the tolerances here are theirs (the
quantizer's: bit for bit).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.quantize import ops as quant_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.waterfill import ops as wf_ops
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import on_track

from test_torch_cases import (
    SEGSUM_CASES,
    SIM_SCENARIOS,
    SOLVE_CASES,
    WATERFILL_CHAIN_CASES,
    fleet_jobs,
    qkv,
    quantize_inputs,
    segsum_case,
    sim_scenario,
    solve_case,
    solve_plans,
    ssd_inputs,
    waterfill_case,
    waterfill_chain_case,
)

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")


def _kernels_match_plain_versions(case):
    caps, src, dst, eg, inn, eid, ed, active, nv, ne = case
    for precision, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        args = [
            torch.as_tensor(caps, dtype=dtype),
            torch.as_tensor(src, dtype=torch.int32),
            torch.as_tensor(dst, dtype=torch.int32),
            torch.as_tensor(eg, dtype=dtype), torch.as_tensor(inn, dtype=dtype),
            None if ed is None else torch.as_tensor(eid, dtype=torch.int32),
            None if ed is None else torch.as_tensor(ed, dtype=dtype),
            torch.as_tensor(active),
        ]
        plain = wf_ops.waterfill_rates(*args, precision=precision)
        count = REGISTRY.counter(f"kernels.waterfill_{precision}.launches")
        n0 = count.value
        got = wf_ops.waterfill_rates(
            *[None if a is None else a.cuda() for a in args],
            precision=precision,
        ).cpu()
        assert count.value == n0 + 1
        if precision == "f64":
            assert torch.equal(got, plain)
        else:
            torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("with_edges", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_cuda_kernels_match_plain_versions(seed, with_edges):
    _need_card()
    _kernels_match_plain_versions(waterfill_case(seed, with_edges=with_edges))


@pytest.mark.gpu
@pytest.mark.parametrize("name", WATERFILL_CHAIN_CASES)
def test_cuda_kernels_match_plain_versions_on_chain_cases(name):
    _need_card()
    _kernels_match_plain_versions(waterfill_chain_case(name))


@pytest.mark.gpu
@pytest.mark.parametrize("name", SEGSUM_CASES)
def test_segment_sum_kernel_bitwise_on_its_cases(name):
    _need_card()
    vals, seg, nseg = segsum_case(name)
    v, sg = torch.as_tensor(vals), torch.as_tensor(seg)
    count = REGISTRY.counter("kernels.segsum_ordered.launches")
    n0 = count.value
    got = wf_ops.segment_sum_ordered(v.cuda(), sg.cuda(), nseg).cpu()
    assert count.value == n0 + 1
    assert torch.equal(got, wf_ops.segment_sum_ordered(v, sg, nseg))


def _largest(fits) -> int:
    """The largest lane count ``fits`` accepts (it accepts 1)."""
    nc = 1
    while fits(2 * nc):
        nc *= 2
    lo, hi = nc, 2 * nc  # fits, does not fit
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def _limit_args(nv, ne):
    rng = np.random.default_rng(29)

    def args(n, dev):
        return dict(
            caps=torch.tensor(rng.uniform(0.5, 8.0, n), device=dev),
            src=torch.tensor(rng.integers(0, nv, n), dtype=torch.int32,
                             device=dev),
            dst=torch.tensor(rng.integers(0, nv, n), dtype=torch.int32,
                             device=dev),
            eg_cap=torch.tensor(rng.uniform(100, 900, nv), device=dev),
            in_cap=torch.tensor(rng.uniform(100, 900, nv), device=dev),
            eid=torch.tensor(rng.integers(0, ne, n), dtype=torch.int32,
                             device=dev),
            ed_cap=torch.tensor(rng.uniform(500, 2000, ne), device=dev),
        )

    return args


def _solves_bitwise(a, lanes=None):
    got = wf_ops.waterfill_rates(**a, lanes=lanes).cpu()
    want = wf_ops.waterfill_rates(**{k: t.cpu() for k, t in a.items()})
    assert torch.equal(got, want)


def _lanes_for(nc, nv, ne):
    """The lane scratch that the size rule asks of an f64 solve of this
    size (the cluster kernel's), or None where one block takes it."""
    if not wf_ops.needs_cluster(nc, nv, ne):
        return None
    return torch.empty(wf_ops.scratch_bytes(nc, 8), dtype=torch.uint8,
                       device="cuda")


@pytest.mark.gpu
def test_waterfill_at_the_shared_memory_limit_and_past_it():
    """The most lanes one block's shared memory takes (the one-block kernel,
    which takes the f32 solves) solve within 1e-5 of the plain version;
    one lane more raises before any launch."""
    _need_card()
    from repro_torch.kernels.waterfill.build import load

    lib = load()
    nv, ne = 8, 2
    limit = lib.waterfill_smem_limit(4)
    lo = _largest(lambda n: lib.waterfill_smem_bytes(n, nv, ne, 4) <= limit)
    args = _limit_args(nv, ne)

    def f32(a):
        return {k: t.float() if t.is_floating_point() else t
                for k, t in a.items()}

    a = f32(args(lo, "cuda"))
    got = wf_ops.waterfill_rates(**a, precision="f32").cpu()
    want = wf_ops.waterfill_rates(**{k: t.cpu() for k, t in a.items()},
                                  precision="f32")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="shared memory"):
        wf_ops.waterfill_rates(**f32(args(lo + 1, "cuda")), precision="f32")


@pytest.mark.gpu
@pytest.mark.parametrize("nv,ne", [(8, 2), (20, 1), (64, 16)])
def test_waterfill_takes_the_solves_an_all_shared_layout_took(nv, ne):
    """Every f64 solve that a layout of 25 bytes a lane (cap, rate, share,
    state) and 16 bytes a segment (budget, share) took in one block,
    beside 192 bytes of static scratch in 227 KB, still solves: the
    largest takes the staged kernel or a cluster of two blocks that holds
    its lanes in shared memory, and solves bitwise."""
    _need_card()
    nseg = 2 * nv + ne

    def earlier_fits(n):
        b = (3 * n + 2 * nseg) * 8 + n
        return ((b + 15) & ~15) <= 232448 - 192

    n = _largest(earlier_fits)
    plan = wf_ops.launch_plan(n, nv, ne)
    assert plan.k <= 2 and plan.lanes_shared
    _solves_bitwise(_limit_args(nv, ne)(n, "cuda"), _lanes_for(n, nv, ne))


@pytest.mark.gpu
def test_waterfill_size_mirror_equals_the_library():
    """``ops.smem_bytes``, ``ops.shared_smem_bytes``,
    ``ops.cluster_smem_bytes``, ``ops.cluster_plan``, ``ops.scratch_bytes``
    and ``ops.SMEM_LIMIT``, which the sim uses to pick a kernel without
    loading the library, are the library's own numbers (the staged
    kernel's capacity too), and this card holds the largest cluster the
    mirror assumes."""
    _need_card()
    from repro_torch.kernels.waterfill.build import load

    lib = load()
    assert lib.waterfill_cluster_max() == wf_ops.MAX_CLUSTER
    for nv, ne in ((12, 36), (20, 1), (8, 2)):
        limit = lib.waterfill_smem_limit(8)
        assert _largest(lambda n: lib.waterfill_shared_smem_bytes(n, nv, ne)
                        <= limit) == _largest(
            lambda n: wf_ops.takes_shared(n, nv, ne))
    for elem, p in ((8, "f64"), (4, "f32")):
        assert lib.waterfill_smem_limit(elem) == wf_ops.SMEM_LIMIT
        for nc, nv, ne in ((0, 8, 2), (1, 1, 0), (600, 20, 1),
                           (640, 12, 36), (12_345, 64, 16),
                           (24_576, 768, 3), (262_144, 64, 16),
                           (600_000, 3_000, 40)):
            assert (wf_ops.smem_bytes(nc, nv, ne, elem)
                    == lib.waterfill_smem_bytes(nc, nv, ne, elem))
            assert (wf_ops.shared_smem_bytes(nc, nv, ne)
                    == lib.waterfill_shared_smem_bytes(nc, nv, ne))
            assert (wf_ops.scratch_bytes(nc, elem)
                    == lib.waterfill_scratch_bytes(nc, elem))
            for k in (2, 4, 8, 16):
                for shared in (True, False):
                    assert (wf_ops.cluster_smem_bytes(nc, nv, ne, elem, k,
                                                      shared)
                            == lib.waterfill_cluster_smem_bytes(
                                nc, nv, ne, elem, k, int(shared)))
            for kmax in (8, 16):
                plan = wf_ops.cluster_plan(nc, nv, ne, p, kmax)
                assert lib.waterfill_cluster_plan(nc, nv, ne, elem, kmax) == (
                    plan.k if plan.lanes_shared else -plan.k)


@pytest.mark.gpu
@pytest.mark.parametrize("nv,ne", [(8, 2), (64, 16)])
def test_device_memory_variant_bitwise_at_twice_the_limit(nv, ne):
    """Twice the lanes the one-block layout takes at f64 (``smem_bytes``):
    without the lane scratch the call raises, the cluster kernel solves
    them bitwise equal to the plain f64 version (f32 within its
    tolerance) and counts on its own counter."""
    _need_card()
    from repro_torch.kernels.waterfill.build import load

    lib = load()
    lo = _largest(lambda n: lib.waterfill_smem_bytes(n, nv, ne, 8)
                  <= lib.waterfill_smem_limit(8))
    a = _limit_args(nv, ne)(2 * lo, "cuda")
    with pytest.raises(ValueError, match="shared memory"):
        wf_ops.waterfill_rates(**a)
    for precision, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        args = {k: t.to(dtype) if t.is_floating_point() else t
                for k, t in a.items()}
        lanes = torch.empty(wf_ops.scratch_bytes(2 * lo, 8 if dtype ==
                                                 torch.float64 else 4),
                            dtype=torch.uint8, device="cuda")
        count = REGISTRY.counter(f"kernels.waterfill_{precision}_cluster"
                                 ".launches")
        shared = REGISTRY.counter(f"kernels.waterfill_{precision}.launches")
        n0, s0 = count.value, shared.value
        got = wf_ops.waterfill_rates(**args, precision=precision,
                                     lanes=lanes).cpu()
        assert (count.value, shared.value) == (n0 + 1, s0)
        want = wf_ops.waterfill_rates(
            **{k: t.cpu() for k, t in args.items()}, precision=precision)
        if precision == "f64":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


CLUSTER_CASES = ("ragged", "idle_block", "segment_in_every_block",
                 "edge_holds_every_lane", "changed", "past_cluster_memory",
                 "captured_graph")


def _cluster_args(name, precision):
    """A solve for the cluster kernel, on the CPU: about twice the lanes one
    block takes (8 VMs, 2 edges), shaped by ``name``. ``ragged``: a lane
    count that K does not divide; ``idle_block``: only the first quarter
    of the lanes active, so the other blocks hold none; ``segment_in_every
    _block``: VM 0 sends on every seventh lane; ``edge_holds_every_lane``:
    one edge; ``past_cluster_memory``: more lanes than a 16-block cluster's
    shared memory holds (64 VMs, 16 edges), so they go to device memory."""
    rng = np.random.default_rng(41)
    dtype = torch.float64 if precision == "f64" else torch.float32
    elem = 8 if precision == "f64" else 4
    nv, ne = (64, 16) if name == "past_cluster_memory" else (8, 2)
    if name == "past_cluster_memory":
        nc = 1
        while wf_ops.cluster_plan(nc, nv, ne, precision).lanes_shared:
            nc *= 2
    else:
        nc = 2 * _largest(lambda n: wf_ops.smem_bytes(n, nv, ne, elem)
                          <= wf_ops.SMEM_LIMIT) + 3
    src = rng.integers(0, nv, nc)
    eid = rng.integers(0, ne, nc)
    active = np.ones(nc, dtype=bool)
    if name == "idle_block":
        active[nc // 4:] = False
    if name == "segment_in_every_block":
        src = np.where(np.arange(nc) % 7 == 0, 0, rng.integers(1, nv, nc))
    if name == "edge_holds_every_lane":
        ne, eid = 1, np.zeros(nc, dtype=np.int64)
    plan = wf_ops.cluster_plan(nc, nv, ne, precision)
    assert (nc % plan.k != 0) or name != "ragged"
    assert plan.lanes_shared == (name != "past_cluster_memory")
    return dict(
        caps=torch.tensor(rng.uniform(0.5, 8.0, nc), dtype=dtype),
        src=torch.tensor(src, dtype=torch.int32),
        dst=torch.tensor(rng.integers(0, nv, nc), dtype=torch.int32),
        eg_cap=torch.tensor(rng.uniform(100, 900, nv), dtype=dtype),
        in_cap=torch.tensor(rng.uniform(100, 900, nv), dtype=dtype),
        eid=torch.tensor(eid, dtype=torch.int32),
        ed_cap=torch.tensor(rng.uniform(500, 2000, ne), dtype=dtype),
        active=torch.tensor(active),
    )


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("name", CLUSTER_CASES)
def test_cluster_kernel_matches_plain_version_on_its_cases(name, precision):
    """The cluster kernel against the plain version, f64 bit for bit and
    f32 within 1e-5: a ragged lane count, a block with no active lane, a
    segment whose lanes lie in every block, one edge holding every lane,
    the ``changed`` flag (False returns ``prev`` unread, True solves), lanes
    past the largest cluster's shared memory, and a launch recorded in a
    CUDA graph and replayed. Each launch counts once on the cluster
    kernel's counter (under capture on ``.recorded``)."""
    _need_card()
    a = _cluster_args(name, precision)
    want = wf_ops.waterfill_rates(**a, precision=precision)
    g = {k: t.cuda() for k, t in a.items()}
    nc = a["caps"].shape[0]
    lanes = torch.empty(wf_ops.scratch_bytes(nc, 8 if precision == "f64"
                                             else 4),
                        dtype=torch.uint8, device="cuda")
    count = REGISTRY.counter(f"kernels.waterfill_{precision}_cluster"
                             ".launches")
    recorded = REGISTRY.counter(f"kernels.waterfill_{precision}_cluster"
                                ".recorded")
    n0, r0 = count.value, recorded.value
    if name == "changed":
        prev = torch.full((nc,), 3.25, dtype=want.dtype, device="cuda")
        kept = wf_ops.waterfill_rates(
            **g, precision=precision, lanes=lanes,
            changed=torch.tensor(False, device="cuda"), prev=prev)
        assert torch.equal(kept.cpu(), prev.cpu())
        got = wf_ops.waterfill_rates(
            **g, precision=precision, lanes=lanes,
            changed=torch.tensor(True, device="cuda"), prev=prev)
        assert count.value == n0 + 2
    elif name == "captured_graph":  # the lists built outside, as the sim
        segs = wf_ops.build_segments(g["src"], g["dst"], g["eid"],
                                     g["eg_cap"].shape[0],
                                     g["ed_cap"].shape[0])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # the library built and configured
            wf_ops.waterfill_rates(**g, precision=precision, lanes=lanes,
                                   segments=segs)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = wf_ops.waterfill_rates(**g, precision=precision,
                                         lanes=lanes, segments=segs)
        graph.replay()
        assert (count.value, recorded.value) == (n0 + 1, r0 + 1)
    else:
        got = wf_ops.waterfill_rates(**g, precision=precision, lanes=lanes)
        assert count.value == n0 + 1
    got = got.cpu()
    if precision == "f64":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cluster_kernel_without_scratch_or_past_the_segments_raises():
    """No quiet fallback: a solve past one block without the lane scratch
    raises before any launch, as does a cluster launch whose segments
    alone do not fit a block; neither counts a launch."""
    _need_card()
    a = {k: t.cuda() for k, t in _cluster_args("ragged", "f64").items()}
    count = REGISTRY.counter("kernels.waterfill_f64_cluster.launches")
    shared = REGISTRY.counter("kernels.waterfill_f64.launches")
    n0, s0 = count.value, shared.value
    with pytest.raises(ValueError, match="shared memory"):
        wf_ops.waterfill_rates(**a)
    nv = 16_000  # 32,000 VM segments: the share replica alone is too big
    b = dict(a, src=a["src"] % nv, dst=a["dst"] % nv,
             eg_cap=torch.ones(nv, dtype=torch.float64, device="cuda"),
             in_cap=torch.ones(nv, dtype=torch.float64, device="cuda"))
    nc = a["caps"].shape[0]
    lanes = torch.empty(wf_ops.scratch_bytes(nc, 8), dtype=torch.uint8,
                        device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        wf_ops.waterfill_rates(**b, lanes=lanes)
    assert (count.value, shared.value) == (n0, s0)


STAGED_CASES = ("bcast_151", "bcast_338", "bcast_422", "one_edge_600",
                "direct_128", "no_active_lane", "n_edges_bound", "changed")


def _staged_args(name):
    """A solve the staged one-block kernel takes, on the CPU. ``bcast_<n>``:
    the broadcast's shape (640 lanes, 12 VMs, 36 edges; egress and ingress
    lists of 9 to 100 lanes) with ``n`` lanes active, as its solves have
    151 to 422; ``one_edge_600``: the Fig. 6 sim's 600 lanes, 20 VMs and one
    edge that holds every lane; ``direct_128``: 2 VMs a region, 128 lanes
    on one edge; ``no_active_lane``; ``n_edges_bound``: edge budgets of
    1e30 with the bound's edge term overridden to 0, as the sim passes
    without link contention; ``changed``: the broadcast's shape at 338."""
    rng = np.random.default_rng(30)
    if name == "one_edge_600":
        nc, nv, ne, n_active = 600, 20, 1, 600
    elif name == "direct_128":
        nc, nv, ne, n_active = 128, 4, 1, 128
    else:
        nc, nv, ne = 640, 12, 36
        n_active = {"no_active_lane": 0}.get(
            name, int(name.split("_")[1]) if name.startswith("bcast")
            else 338)
    if name == "direct_128":
        src = np.arange(nc) // 64
        dst = 2 + np.arange(nc) % 2
    else:
        skew = np.arange(1, nv + 1) / np.arange(1, nv + 1).sum()
        src = rng.choice(nv, nc, p=skew)
        dst = rng.choice(nv, nc, p=skew[::-1])
    active = np.zeros(nc, dtype=bool)
    active[rng.choice(nc, n_active, replace=False)] = True
    ed = rng.uniform(20, 200, ne) if ne > 1 else rng.uniform(1000, 2000, 1)
    if name == "n_edges_bound":
        ed = np.full(ne, 1e30)
    return dict(
        caps=torch.tensor(rng.uniform(0.5, 8.0, nc), dtype=torch.float64),
        src=torch.tensor(src, dtype=torch.int32),
        dst=torch.tensor(dst, dtype=torch.int32),
        eg_cap=torch.tensor(rng.uniform(30, 400, nv), dtype=torch.float64),
        in_cap=torch.tensor(rng.uniform(30, 400, nv), dtype=torch.float64),
        eid=torch.tensor(rng.integers(0, ne, nc), dtype=torch.int32),
        ed_cap=torch.tensor(ed, dtype=torch.float64),
        active=torch.tensor(active),
    )


_F64 = ("kernels.waterfill_f64.launches",
        "kernels.waterfill_f64_shared.launches")


@pytest.mark.gpu
@pytest.mark.parametrize("name", STAGED_CASES)
def test_staged_kernel_bitwise_on_its_shapes(name):
    """The staged one-block kernel, which the size rule gives these solves,
    bitwise equal to the plain f64 version at the broadcast's shape with
    151, 338 and 422 active lanes, at the Fig. 6 sim's shape (one list
    holds every lane), at the direct cell's 128 lanes, with no active lane,
    with the round bound's edge term overridden, and with ``changed``
    (False returns ``prev``, True solves). Each launch counts once on
    ``kernels.waterfill_f64.launches`` and once on
    ``kernels.waterfill_f64_shared.launches``."""
    _need_card()
    a = _staged_args(name)
    nc, nv, ne = (a["caps"].shape[0], a["eg_cap"].shape[0],
                  a["ed_cap"].shape[0])
    assert wf_ops.launch_plan(nc, nv, ne).kernel == "waterfill_f64_shared"
    kw = {"n_edges_bound": 0} if name == "n_edges_bound" else {}
    want = wf_ops.waterfill_rates(**a, **kw)
    g = {k: t.cuda() for k, t in a.items()}
    before = [REGISTRY.counter(n).value for n in _F64]
    if name == "changed":
        prev = torch.full((nc,), 3.25, dtype=torch.float64, device="cuda")
        kept = wf_ops.waterfill_rates(
            **g, changed=torch.tensor(False, device="cuda"), prev=prev)
        assert torch.equal(kept.cpu(), prev.cpu())
        got = wf_ops.waterfill_rates(
            **g, changed=torch.tensor(True, device="cuda"), prev=prev)
        n = 2
    else:
        got = wf_ops.waterfill_rates(**g, **kw)
        n = 1
    assert [REGISTRY.counter(c).value - b
            for c, b in zip(_F64, before)] == [n, n]
    assert torch.equal(got.cpu(), want)
    if name == "no_active_lane":
        assert not want.any()


@pytest.mark.gpu
def test_staged_kernel_at_its_limit_and_one_lane_past_it():
    """The most lanes the staged layout takes (12 VMs, 36 edges) solve on
    it (both f64 counters count); one lane more raises without the lane
    scratch and solves on a cluster of two with it (only the cluster's
    counter counts); both bitwise equal to the plain version."""
    _need_card()
    from repro_torch.kernels.waterfill.build import load

    lib = load()
    nv, ne = 12, 36
    limit = lib.waterfill_smem_limit(8)
    lo = _largest(lambda n: lib.waterfill_shared_smem_bytes(n, nv, ne)
                  <= limit)
    args = _limit_args(nv, ne)
    with pytest.raises(ValueError, match="shared memory"):
        wf_ops.waterfill_rates(**args(lo + 1, "cuda"))
    names = (*_F64, "kernels.waterfill_f64_cluster.launches")
    for nc, counted in ((lo, [1, 1, 0]), (lo + 1, [0, 0, 1])):
        assert wf_ops.takes_shared(nc, nv, ne) == (nc == lo)
        before = [REGISTRY.counter(n).value for n in names]
        _solves_bitwise(args(nc, "cuda"), _lanes_for(nc, nv, ne))
        assert [REGISTRY.counter(c).value - b
                for c, b in zip(names, before)] == counted


@pytest.mark.gpu
def test_staged_kernel_counts_on_both_counters_captured_and_replayed(
        port_top):
    """Under stream capture the staged kernel records on the
    ``.recorded`` counters of both ``waterfill_f64`` and
    ``waterfill_f64_shared`` and launches nothing; a sim's replays add the
    recorded launches to both ``.launches`` counters, so over a card sim
    of the direct cell's 128 lanes each equals ``sim.iterations``."""
    _need_card()
    a = {k: t.cuda() for k, t in _staged_args("direct_128").items()}
    segs = wf_ops.build_segments(a["src"], a["dst"], a["eid"],
                                 a["eg_cap"].shape[0], a["ed_cap"].shape[0])
    recorded = [n.replace(".launches", ".recorded") for n in _F64]
    names = (*_F64, *recorded)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the library built and configured
        wf_ops.waterfill_rates(**a, segments=segs)
    torch.cuda.current_stream().wait_stream(side)
    before = {n: REGISTRY.counter(n).value for n in names}
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = wf_ops.waterfill_rates(**a, segments=segs)
    graph.replay()
    d = {n: REGISTRY.counter(n).value - before[n] for n in names}
    assert d == {**{n: 0 for n in _F64}, **{n: 1 for n in recorded}}
    assert torch.equal(got.cpu(), wf_ops.waterfill_rates(
        **{k: t.cpu() for k, t in a.items()}))

    names = ("sim.iterations", "sim.graph_replays", *_F64)
    before = {n: REGISTRY.counter(n).value for n in names}
    _sim(_direct_2vm(port_top, 300), [], {"block": 8}, None)
    torch.cuda.synchronize()
    d = {n: REGISTRY.counter(n).value - before[n] for n in names}
    assert d["sim.graph_replays"] >= 1
    assert d[_F64[0]] == d[_F64[1]] == d["sim.iterations"]


@pytest.fixture(scope="module")
def port_top():
    from repro_torch.core import default_topology

    return default_topology()


def _sim(jobs, faults, kw, device):
    from repro_torch.obs import trace
    from repro_torch.transfer.flowsim_torch import simulate_multi_torch

    tr = trace.enable(capacity=1 << 16)
    try:
        res = simulate_multi_torch(jobs, faults, device=device,
                                   **{"seed": 0, **kw})
        return res, tr.events()
    finally:
        trace.disable()


_STEP = ("kernels.sim_pre_f64.launches", "kernels.sim_post_f64.launches")


@pytest.mark.gpu
@pytest.mark.parametrize("name", SIM_SCENARIOS)
def test_graph_sim_equals_cpu_and_counts_every_launch(name, port_top):
    """The card's sim (CUDA graphs of the predicated blocks, here of 4
    iterations so that every scenario replays one) equals the CPU run
    (blocks of 64) field for field, with the same Skytrace stream; the
    water-filling kernel and both sim-step kernels launch once an
    iteration the device ran, and the ordered segment sum, folded into
    ``sim_post_f64``, not at all."""
    _need_card()
    jobs, faults, kw = sim_scenario(name, port_top)
    names = ("sim.iterations", "sim.graph_captures", "sim.graph_replays",
             "kernels.waterfill_f64.launches",
             "kernels.segsum_ordered.launches", *_STEP)
    before = {n: REGISTRY.counter(n).value for n in names}
    got, got_tr = _sim(jobs, faults, dict(kw, block=4), None)
    torch.cuda.synchronize()
    d = {n: REGISTRY.counter(n).value - before[n] for n in names}
    want, want_tr = _sim(jobs, faults, kw, "cpu")
    assert got.events == want.events and got.time_s == want.time_s
    for a, b in zip(got.jobs, want.jobs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert on_track(got_tr) == on_track(want_tr)
    assert d["sim.graph_captures"] >= 1 and d["sim.graph_replays"] >= 1
    assert d["sim.iterations"] >= got.events
    assert d["kernels.waterfill_f64.launches"] == d["sim.iterations"]
    for n in _STEP:
        assert d[n] == d["sim.iterations"], n
    assert d["kernels.segsum_ordered.launches"] == 0


@pytest.fixture(scope="module")
def solve_port_plans():
    from repro_torch import core

    return solve_plans(core)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SOLVE_CASES)
def test_card_counts_the_solves_the_cpu_counts(name, solve_port_plans):
    """On the card ``sim_post_f64`` adds ``changed`` to the state's count
    of solves, as the solve read it (the host's after a sequential
    cascade): ``sim.solves`` equals the CPU's for the same sim (the CPU's
    equals the numpy engine's, ``tests/test_torch_sim_solves.py``)."""
    _need_card()
    from repro_torch import transfer
    from repro_torch.transfer import simulate

    jobs, faults, kw, seed = solve_case(name, solve_port_plans, transfer)
    names = ("sim.solves", "sim.seq_cascades")

    def run(device):
        before = {n: REGISTRY.counter(n).value for n in names}
        res = simulate(jobs, faults, engine="torch", device=device,
                       seed=seed, **kw)
        return res, {n: REGISTRY.counter(n).value - before[n] for n in names}

    got, d_card = run("cuda")
    torch.cuda.synchronize()
    want, d_cpu = run("cpu")
    assert got.events == want.events and got.time_s == want.time_s
    for a, b in zip(got.jobs, want.jobs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert d_card == d_cpu and d_card["sim.solves"] > 0
    assert (d_card["sim.seq_cascades"] > 0) == (name == "bcast_relay_full")


def _direct_2vm(top, chunks: int):
    """One direct job of 2 VMs x 64 connections and ``chunks`` 64 MB
    chunks, ``aws:us-west-2`` to ``aws:eu-central-1``: the benchmark's
    bulk transfer, shortened."""
    from repro_torch.core import direct_plan
    from repro_torch.transfer import TransferJob

    return [TransferJob(direct_plan(top, "aws:us-west-2", "aws:eu-central-1",
                                    chunks * 64.0 / 1024, num_vms=2),
                        "bulk", chunk_mb=64.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("seed,tied", [(0, False), (3, True)])
def test_card_sim_of_a_bulk_transfer_equals_cpu(seed, tied, port_top):
    """A 2,000-chunk direct transfer of 128 lanes on the sim-step kernels
    equals the CPU's torch ops field for field, with the same Skytrace
    stream: seed 0 has one event a chunk, seed 3 ties completions (fewer
    events than chunks). Every iteration runs both kernels."""
    _need_card()
    jobs = _direct_2vm(port_top, 2000)
    names = ("sim.iterations", "kernels.waterfill_f64.launches", *_STEP)
    before = {n: REGISTRY.counter(n).value for n in names}
    got, got_tr = _sim(jobs, [], {"seed": seed}, None)
    torch.cuda.synchronize()
    d = {n: REGISTRY.counter(n).value - before[n] for n in names}
    want, want_tr = _sim(jobs, [], {"seed": seed}, "cpu")
    assert got.events == want.events and got.time_s == want.time_s
    for a, b in zip(got.jobs, want.jobs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert on_track(got_tr) == on_track(want_tr)
    assert got.jobs[0].chunks_delivered == 2000
    assert (got.events < 2000) == tied
    for n in names[1:]:
        assert d[n] == d["sim.iterations"], n


@pytest.mark.gpu
def test_f32_solver_sim_on_the_step_kernels(port_top):
    """The f32 solver keeps its casts around the solve; between them the
    sim-step kernels run every iteration, and the card's run equals the
    CPU's f32 run in every chunk, status and event."""
    _need_card()
    jobs, faults, kw = sim_scenario("plain", port_top)
    kw = dict(kw, rate_solver="f32")
    names = ("sim.iterations", "kernels.waterfill_f32.launches", *_STEP)
    before = {n: REGISTRY.counter(n).value for n in names}
    got, got_tr = _sim(jobs, faults, kw, None)
    torch.cuda.synchronize()
    d = {n: REGISTRY.counter(n).value - before[n] for n in names}
    want, want_tr = _sim(jobs, faults, kw, "cpu")
    assert got.events == want.events
    assert [(j.chunks_delivered, j.status) for j in got.jobs] == [
        (j.chunks_delivered, j.status) for j in want.jobs]
    assert got.time_s == pytest.approx(want.time_s, rel=1e-5)
    for n in names[1:]:
        assert d[n] == d["sim.iterations"], n


@pytest.mark.gpu
@pytest.mark.parametrize("block", [1, 8, 64])
def test_a_captured_block_records_three_kernels_an_iteration(block,
                                                             port_top,
                                                             monkeypatch):
    """A CUDA graph of ``block`` iterations records exactly ``block``
    launches of each sim-step kernel and of the water-filling kernel, and
    none of the ordered segment sum (``.recorded`` counters, read around
    each capture)."""
    _need_card()
    from repro_torch.transfer import flowsim_torch

    counters = {n: REGISTRY.counter(n.replace(".launches", ".recorded"))
                for n in (*_STEP, "kernels.waterfill_f64.launches",
                          "kernels.segsum_ordered.launches")}
    seen = []
    capture = flowsim_torch._Blocks._capture

    def spy(self, n):
        before = {k: c.value for k, c in counters.items()}
        out = capture(self, n)
        seen.append((n, {k: c.value - before[k] for k, c in counters.items()}))
        return out

    monkeypatch.setattr(flowsim_torch._Blocks, "_capture", spy)
    _sim(_direct_2vm(port_top, 300), [], {"block": block}, None)
    assert seen and any(n == block for n, _ in seen)
    for n, rec in seen:
        assert rec == {**{k: n for k in rec},
                       "kernels.segsum_ordered.launches": 0}, (n, rec)


@pytest.mark.gpu
def test_each_replay_is_timed_by_one_event_pair(port_top, monkeypatch):
    """``sim.replay_device_s`` is the card's time in the replayed graphs:
    one pair of CUDA events recorded around each replay and read once,
    more than nothing and no more than the run's wall time. The host's
    gaps before replays are measured too."""
    _need_card()
    from repro_torch.transfer.flowsim_torch import simulate_multi_torch

    calls = {"record": 0, "elapsed_time": 0}

    class Counted(torch.cuda.Event):
        def record(self, stream=None):
            calls["record"] += 1
            return super().record(stream)

        def elapsed_time(self, end_event):
            calls["elapsed_time"] += 1
            return super().elapsed_time(end_event)

    monkeypatch.setattr(torch.cuda, "Event", Counted)
    jobs, faults, kw = sim_scenario("plain", port_top)
    names = ("sim.replay_device_s", "sim.graph_replays", "sim.block_gap_s",
             "sim.flag_reads")
    before = {n: REGISTRY.counter(n).value for n in names}
    t0 = time.perf_counter()
    simulate_multi_torch(jobs, faults, seed=0, block=4, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = {n: REGISTRY.counter(n).value - before[n] for n in names}
    assert d["sim.graph_replays"] >= 2
    assert calls["record"] == 2 * d["sim.graph_replays"]
    assert calls["elapsed_time"] == d["sim.graph_replays"]
    assert 0 < d["sim.replay_device_s"] <= wall
    assert 0 < d["sim.block_gap_s"] < wall
    assert d["sim.flag_reads"] > d["sim.graph_replays"]


@pytest.mark.gpu
def test_card_sim_at_twice_the_shared_memory_limit_equals_cpu(port_top):
    """48 jobs of 8 VMs x 64 connections (24,576 lanes, twice what one
    block's shared memory takes): the card's sim runs every solve on the
    cluster kernel and equals the CPU run field for field, with the same
    Skytrace stream."""
    _need_card()
    jobs = fleet_jobs(port_top, 48)
    names = ("sim.iterations", "kernels.waterfill_f64.launches",
             "kernels.waterfill_f64_cluster.launches")
    before = {n: REGISTRY.counter(n).value for n in names}
    got, got_tr = _sim(jobs, [], {}, None)
    torch.cuda.synchronize()
    d = {n: REGISTRY.counter(n).value - before[n] for n in names}
    want, want_tr = _sim(jobs, [], {}, "cpu")
    assert got.events == want.events and got.time_s == want.time_s
    for a, b in zip(got.jobs, want.jobs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert on_track(got_tr) == on_track(want_tr)
    assert all(j.status == "done" for j in got.jobs)
    assert d["kernels.waterfill_f64.launches"] == 0
    assert d["kernels.waterfill_f64_cluster.launches"] == d["sim.iterations"]
    assert d["sim.iterations"] >= got.events


@pytest.mark.gpu
def test_long_sim_replays_its_graphs(port_top):
    """A run of several blocks replays the captured graph; the replays'
    launches are counted."""
    _need_card()
    from repro_torch.core import direct_plan
    from repro_torch.transfer import TransferJob, simulate

    jobs = [TransferJob(direct_plan(port_top, "aws:us-west-2",
                                    "aws:eu-central-1", 64.0, num_vms=2),
                        "long", chunk_mb=64.0)]
    names = ("sim.iterations", "sim.graph_replays",
             "kernels.waterfill_f64.launches")
    before = {n: REGISTRY.counter(n).value for n in names}
    res = simulate(jobs)
    torch.cuda.synchronize()
    d = {n: REGISTRY.counter(n).value - before[n] for n in names}
    assert res.jobs[0].status == "done"
    assert d["sim.graph_replays"] > 0
    assert d["kernels.waterfill_f64.launches"] == d["sim.iterations"]
    assert d["sim.iterations"] >= res.events


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,kv,d,window",
    [(1, 128, 2, 2, 32, None), (2, 256, 4, 2, 64, None),
     (1, 192, 6, 2, 16, None), (1, 300, 4, 2, 112, None),
     (1, 256, 2, 2, 192, 200), (1, 256, 2, 2, 32, 64)],
)
def test_flash_kernel_matches_plain_version(dtype, b, s, h, kv, d, window):
    _need_card()
    q, k, v = (torch.tensor(a).to(_TORCH[dtype])
               for a in qkv(3, b, s, h, kv, d))
    count = REGISTRY.counter("kernels.flash_attention.launches")
    n0 = count.value
    got = flash_ops.flash_attention(q.cuda(), k.cuda(), v.cuda(),
                                    window=window)
    torch.cuda.synchronize()
    assert count.value == n0 + 1
    want = flash_ops.flash_attention_plain(q, k, v, window=window)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol,
                               rtol=0)


_WGMMA_CASES = (
    # every head dim of configs/archs.py at S 1, 63, 129 and 1000 (B 2)
    [(2, s, 2, 2, d, None, True) for d in (64, 112, 128, 192)
     for s in (1, 63, 129, 1000)]
    # GQA 7:1 and 8:1, windows 64 and 200, one non-causal call
    + [(2, 129, 14, 2, 128, None, True), (2, 1000, 8, 1, 112, None, True),
       (2, 1000, 16, 2, 64, 64, True), (2, 1000, 7, 1, 192, 200, True),
       (2, 63, 8, 1, 112, 200, True), (2, 1000, 4, 4, 112, 64, True),
       (2, 129, 4, 4, 112, None, False), (2, 300, 3, 3, 16, None, True)]
)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d,window,causal", _WGMMA_CASES)
def test_wgmma_flash_kernel_matches_plain_version(b, s, h, kv, d, window,
                                                  causal):
    """The tensor-core kernel (bf16, D a multiple of 16) against the
    plain version at the reference's bf16 tolerance, 2e-2."""
    _need_card()
    q, k, v = (torch.tensor(a).to(torch.bfloat16)
               for a in qkv(11, b, s, h, kv, d))
    assert flash_ops.kernel_for(q.dtype, d) == "wgmma"
    count = REGISTRY.counter("kernels.flash_attention.launches")
    wgmma = REGISTRY.counter("kernels.flash_attention.wgmma_launches")
    n0, w0 = count.value, wgmma.value
    got = flash_ops.flash_attention(q.cuda(), k.cuda(), v.cuda(),
                                    causal=causal, window=window)
    torch.cuda.synchronize()
    assert (count.value, wgmma.value) == (n0 + 1, w0 + 1)
    want = flash_ops.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.cpu().float(), want.float(), atol=2e-2,
                               rtol=0)


@pytest.mark.gpu
def test_vector_kernel_still_takes_f32_and_odd_bf16_head_dims():
    _need_card()
    wgmma = REGISTRY.counter("kernels.flash_attention.wgmma_launches")
    for dtype, d in ((torch.float32, 112), (torch.bfloat16, 24)):
        q, k, v = (torch.tensor(a).to(dtype) for a in qkv(12, 1, 70, 2, 2, d))
        w0 = wgmma.value
        got = flash_ops.flash_attention(q.cuda(), k.cuda(), v.cuda())
        torch.cuda.synchronize()
        assert wgmma.value == w0
        want = flash_ops.flash_attention_plain(q, k, v)
        tol = 2e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,s,p,n,q",
    [(1, 2, 64, 16, 16, 16), (2, 3, 128, 16, 32, 32), (1, 4, 256, 32, 64, 64),
     (1, 4, 512, 64, 128, 256), (2, 5, 100, 16, 16, 16)],
)
def test_ssd_kernel_matches_plain_version(dtype, b, h, s, p, n, q):
    _need_card()
    td = _TORCH[dtype]
    x, dt, a, bm, cm = (torch.tensor(t) for t in ssd_inputs(
        7, b, h, s, p, n, layout="bshp"))
    args = (x.to(td), dt, a, bm.to(td), cm.to(td))
    count = REGISTRY.counter("kernels.ssd_scan.launches")
    n0 = count.value
    y, state = ssd_ops.ssd_scan(*(t.cuda() for t in args), chunk=q)
    torch.cuda.synchronize()
    assert count.value == n0 + 1
    y_want, s_want = ssd_ops.ssd_scan_plain(*args, chunk=q)
    tol = 1e-3 if dtype == "float32" else 1e-1
    torch.testing.assert_close(y.cpu().float(), y_want.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(state.cpu(), s_want, atol=tol, rtol=tol)


def _ssd_case(seed, b, h, s, p, n, dtype):
    x, dt, a, bm, cm = (torch.tensor(t) for t in ssd_inputs(
        seed, b, h, s, p, n, layout="bshp"))
    return x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,p,n,q", [
    (1, 2, 1024, 64, 64, 256),   # Zamba2-7B's head shape
    (2, 3, 1000, 64, 64, 256),   # a ragged S, padded with dt = 0
    (1, 3, 512, 32, 128, 256),   # P 32, N 128 (two state atoms)
    (2, 2, 768, 64, 64, 128),    # two heads of each batch row share B, C
    (1, 2, 320, 16, 64, 64),     # the smallest chunk it takes
])
def test_wgmma_ssd_kernel_matches_plain_version(b, h, s, p, n, q):
    """The tensor-core kernel (bf16) against the plain version at the
    reference's bf16 tolerance, 1e-1 (y and the final state)."""
    _need_card()
    args = _ssd_case(8, b, h, s, p, n, torch.bfloat16)
    assert ssd_ops.kernel_for(torch.bfloat16, q, p, n) == "wgmma"
    count = REGISTRY.counter("kernels.ssd_scan.launches")
    wgmma = REGISTRY.counter("kernels.ssd_scan.wgmma_launches")
    n0, w0 = count.value, wgmma.value
    y, state = ssd_ops.ssd_scan(*(t.cuda() for t in args), chunk=q)
    torch.cuda.synchronize()
    assert (count.value, wgmma.value) == (n0 + 1, w0 + 1)
    y_want, s_want = ssd_ops.ssd_scan_plain(*args, chunk=q)
    assert bool(torch.isfinite(y).all() and torch.isfinite(state).all())
    torch.testing.assert_close(y.cpu().float(), y_want.float(), atol=1e-1,
                               rtol=1e-1)
    torch.testing.assert_close(state.cpu(), s_want, atol=1e-1, rtol=1e-1)


@pytest.mark.gpu
def test_vector_ssd_kernel_still_takes_f32_and_other_bf16_shapes():
    """f32 and the bf16 shapes off the tensor-core kernel's grid launch
    the vector-unit kernel; ``ssd_scan_on("vector", ...)`` runs it on a
    bf16 shape the tensor-core kernel takes."""
    _need_card()
    wgmma = REGISTRY.counter("kernels.ssd_scan.wgmma_launches")
    for dtype, (b, h, s, p, n, q), kernel in (
            (torch.float32, (1, 2, 512, 64, 64, 256), None),
            (torch.bfloat16, (2, 3, 128, 16, 32, 32), None),
            (torch.bfloat16, (1, 2, 512, 64, 64, 256), "vector")):
        args = _ssd_case(9, b, h, s, p, n, dtype)
        w0 = wgmma.value
        on = [t.cuda() for t in args]
        y, state = (ssd_ops.ssd_scan(*on, chunk=q) if kernel is None
                    else ssd_ops.ssd_scan_on(kernel, *on, chunk=q))
        torch.cuda.synchronize()
        assert wgmma.value == w0
        y_want, s_want = ssd_ops.ssd_scan_plain(*args, chunk=q)
        tol = 1e-3 if dtype == torch.float32 else 1e-1
        torch.testing.assert_close(y.cpu().float(), y_want.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(state.cpu(), s_want, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    "normal_1024", "ragged_1000", "tiny_7_block4", "one_block_256",
    "scaled_4000", "ties", "zeros", "leaf_3d", "huge_and_tiny",
])
def test_quantize_kernels_match_plain_versions_bitwise(case, dtype):
    _need_card()
    x, block = quantize_inputs(case)
    t = torch.tensor(x).to(_TORCH[dtype])
    qc = REGISTRY.counter("kernels.quantize_int8.launches")
    dc = REGISTRY.counter("kernels.dequantize_int8.launches")
    n0, m0 = qc.value, dc.value
    q, s = quant_ops.quantize_int8(t.cuda(), block=block)
    back = quant_ops.dequantize_int8(q, s, block=block)
    torch.cuda.synchronize()
    assert (qc.value, dc.value) == (n0 + 1, m0 + 1)
    q0, s0 = quant_ops.quantize_int8_plain(t, block=block)
    assert torch.equal(q.cpu(), q0) and torch.equal(s.cpu(), s0)
    assert torch.equal(back.cpu(),
                       quant_ops.dequantize_int8_plain(q0, s0, block=block))


@pytest.mark.gpu
def test_quantize_kernel_nan_block_and_unaligned_view():
    """A NaN block's scale is 1.0 as in the plain version; a view that
    starts off the 16-byte grid takes the scalar kernel, same bits."""
    _need_card()
    x = torch.tensor(quantize_inputs("scaled_4000")[0])
    x[300] = float("nan")
    q, s = quant_ops.quantize_int8(x.cuda())
    q0, s0 = quant_ops.quantize_int8_plain(x)
    assert torch.equal(s.cpu(), s0) and float(s[1]) == 1.0
    finite = torch.isfinite(x)
    assert torch.equal(q.cpu()[finite], q0[finite])
    y = torch.tensor(quantize_inputs("scaled_4000")[0]).cuda()[1:]
    q, s = quant_ops.quantize_int8(y)
    q0, s0 = quant_ops.quantize_int8_plain(y.cpu())
    assert torch.equal(q.cpu(), q0) and torch.equal(s.cpu(), s0)
    back = quant_ops.dequantize_int8(q[1:], s, block=256)
    want = quant_ops.dequantize_int8_plain(q0[1:], s0, block=256)
    assert torch.equal(back.cpu(), want)
