"""The port's real-bytes gateway and checkpoint replication against the
reference package's.

The assertions of ``test_gateway_faults.py`` and the gateway cases of
``test_multicast.py`` and ``test_transfer_integration.py`` run on the
port's gateway, over plans made by the reference and carried across with
``repro_torch.convert``. Where the reference moves the same objects
through the same plan with the same scripted faults, the objects each
destination ends up holding are held BYTE-EQUAL across the two packages.
Counts that depend on the worker threads' order (bytes per hop, retries
beyond the faults fired) are held only as the reference's own tests hold
them. Checkpoint replication copies a reduced model's checkpoint, saved
by the port, from one directory with both packages: the replicated files
are byte-equal and the plans behind them equal. Shard placement is held
equal too.
"""

from __future__ import annotations

import dataclasses
import random
import threading

import numpy as np
import pytest
import torch

from repro.core import Planner, PlanSpec, default_topology, toy_topology
from repro.transfer import gateway as ref_gw
from repro.transfer.chunk import chunk_manifest
from repro_torch import convert, models
from repro_torch.configs import ARCHS, reduced
from repro_torch.transfer import gateway as port_gw
from test_torch_cases import one_thread  # noqa: F401

MC_SRC = "gcp:us-central1"
MC_DSTS = ("gcp:europe-west1", "gcp:europe-west3", "gcp:europe-west4")
SIDES = {"ref": ref_gw, "port": port_gw}


@pytest.fixture(scope="module")
def toy_plans():
    """test_gateway_faults' toy cost-min plan, in both packages."""
    top = toy_topology(n=5, seed=2)
    plan = Planner(top, max_relays=3).plan(PlanSpec(
        objective="cost_min", src="toy:r0", dst="toy:r1", tput_goal_gbps=2.0,
        volume_gb=0.01,
    ))
    assert plan.solver_status == "optimal"
    return {"ref": plan, "port": convert.to_port_plan(plan)}


@pytest.fixture(scope="module")
def mc_plans():
    top = default_topology()
    plan = Planner(top, max_relays=6).plan(PlanSpec(
        objective="cost_min", src=MC_SRC, dsts=MC_DSTS, tput_goal_gbps=2.0,
        volume_gb=4.0,
    ))
    assert plan.solver_status == "optimal"
    return {"ref": plan, "port": convert.to_port_plan(plan)}


def _objects(n_objects=4, size=1_200_000, seed=0):
    rng = np.random.default_rng(seed)
    return {f"shard/{i:03d}.npy": rng.bytes(size + i * 31337)
            for i in range(n_objects)}


def _store(gw, objects):
    st = gw.BlobStore()
    for k, v in objects.items():
        st.put(k, v)
    return st


def _contents(store) -> dict:
    return {k: store.get(k) for k in sorted(store.keys())}


def _both(plans, objects, *, injector=None, **kw):
    """Move ``objects`` through each package's gateway; returns
    {side: (report, destination contents)}."""
    out = {}
    for side, gw in SIDES.items():
        src, dst = _store(gw, objects), gw.BlobStore()
        inj = None if injector is None else injector(gw)
        rep = gw.transfer_objects(plans[side], src, dst, sorted(objects),
                                  fault_injector=inj, **kw)
        out[side] = (rep, _contents(dst))
    return out


def test_gateway_moves_bytes_exactly(toy_plans):
    objects = _objects(size=1_500_000)
    out = _both(toy_plans, objects, chunk_bytes=1 << 18)
    rep, got = out["port"]
    assert rep.checksum_failures == 0 and got == objects
    assert got == out["ref"][1]
    assert rep.bytes_moved >= sum(len(v) for v in objects.values())


def test_gateway_kill_mid_transfer_zero_data_loss(toy_plans):
    out = _both(toy_plans, _objects(), chunk_bytes=1 << 18,
                workers_per_hop=3,
                injector=lambda gw: gw.FaultInjector(
                    kill_worker_after={(0, 0): 2}))
    rep, got = out["port"]
    assert rep.faults_injected >= 1 and rep.retried_chunks >= 1
    assert rep.checksum_failures == 0 and rep.chunks_missing == 0
    assert got == _objects() == out["ref"][1]
    assert rep.faults_injected == out["ref"][0].faults_injected


def test_gateway_corruption_detected_and_retried(toy_plans):
    objects = _objects(n_objects=2)
    src = port_gw.BlobStore()
    for k, v in objects.items():
        src.put(k, v)
    _, chunk_sums, _ = chunk_manifest(src, sorted(objects), 1 << 18)
    victims = sorted(chunk_sums)[:3]
    out = _both(toy_plans, objects, chunk_bytes=1 << 18,
                injector=lambda gw: gw.FaultInjector(corrupt_chunks=victims))
    for side, (rep, got) in out.items():
        assert rep.faults_injected == len(victims), side
        assert rep.retried_chunks >= len(victims)
        assert rep.checksum_failures == 0 and rep.chunks_missing == 0
        assert got == objects


def test_gateway_resume_skips_verified_objects(toy_plans):
    objects = _objects(n_objects=3)
    keys = sorted(objects)
    finals = {}
    for side, gw in SIDES.items():
        plan, src, dst = toy_plans[side], _store(gw, objects), gw.BlobStore()
        rep1 = gw.transfer_objects(plan, src, dst, keys, chunk_bytes=1 << 18)
        assert rep1.objects_skipped == 0 and rep1.bytes_moved > 0
        rep2 = gw.transfer_objects(plan, src, dst, keys, chunk_bytes=1 << 18)
        assert rep2.objects_skipped == len(keys)
        assert rep2.chunks == 0 and rep2.bytes_moved == 0
        blob = bytearray(dst.get(keys[0]))
        blob[0] ^= 0xFF
        dst.put(keys[0], bytes(blob))
        rep3 = gw.transfer_objects(plan, src, dst, keys, chunk_bytes=1 << 18)
        assert rep3.objects_skipped == len(keys) - 1 and rep3.chunks > 0
        finals[side] = (_contents(dst), rep1.chunks, rep3.chunks)
    assert finals["port"] == finals["ref"]
    assert finals["port"][0] == objects


def test_zero_byte_objects_are_committed(toy_plans):
    objects = {"empty.bin": b"", "tiny.bin": b"x" * 17}
    out = _both(toy_plans, objects)
    rep, got = out["port"]
    assert rep.checksum_failures == 0 and rep.chunks_missing == 0
    assert got == objects == out["ref"][1]


def test_dirstore_directory_is_authoritative(tmp_path):
    store = port_gw.DirStore(tmp_path)
    store.put("a/b.bin", b"\x01" * 1024)
    assert not hasattr(store, "_data")
    assert store.get("a/b.bin") == b"\x01" * 1024
    assert store.get_range("a/b.bin", 10, 5) == b"\x01" * 5
    (tmp_path / "ext__obj.bin").write_bytes(b"xyz")
    assert store.exists("ext/obj.bin")
    assert store.get("ext/obj.bin") == b"xyz"
    assert sorted(store.keys()) == ["a/b.bin", "ext/obj.bin"]
    assert store.size("ext/obj.bin") == 3
    # the same directory read through the reference's DirStore
    ref = ref_gw.DirStore(tmp_path)
    assert _contents(ref) == _contents(store)


def test_dirstore_tmp_suffix_does_not_collide(tmp_path):
    store = port_gw.DirStore(tmp_path)
    store.put("x.npy", b"npy")
    store.put("x.txt", b"txt")
    assert store.get("x.npy") == b"npy" and store.get("x.txt") == b"txt"
    assert sorted(store.keys()) == ["x.npy", "x.txt"]


def test_gateway_through_dirstore_roundtrip(toy_plans, tmp_path):
    objects = _objects(n_objects=2, size=400_000)
    got = {}
    for side, gw in SIDES.items():
        dst = gw.DirStore(tmp_path / side)
        rep = gw.transfer_objects(toy_plans[side], _store(gw, objects), dst,
                                  sorted(objects), chunk_bytes=1 << 17)
        assert rep.checksum_failures == 0 and rep.chunks_missing == 0
        got[side] = _contents(dst)
    assert got["port"] == got["ref"] == objects
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())


def test_retry_delay_backoff_equals_reference():
    """Exponential, capped, jittered in [0.5, 1.5), seeded: the port's
    delays are the reference's, draw for draw."""
    assert port_gw._retry_delay(0, 0.01, 0.25, random.Random(1)) == 0.0
    assert port_gw._retry_delay(3, 0.0, 0.25, random.Random(1)) == 0.0
    got = [port_gw._retry_delay(a, 0.01, 0.25, rng)
           for rng in [random.Random(7)] for a in range(1, 12)]
    want = [ref_gw._retry_delay(a, 0.01, 0.25, rng)
            for rng in [random.Random(7)] for a in range(1, 12)]
    assert got == want
    for a, d in enumerate(got, start=1):
        nominal = min(0.01 * 2.0 ** (a - 1), 0.25)
        assert 0.5 * nominal <= d < 1.5 * nominal


class _OneHangStore(port_gw.BlobStore):
    """The first worker read blocks until released: a hung store call."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._hung = False
        self.release = threading.Event()

    def get_range(self, key, offset, length):
        if threading.current_thread() is not threading.main_thread():
            with self._lock:
                hang, self._hung = not self._hung, True
            if hang:
                self.release.wait()
        return super().get_range(key, offset, length)


def test_gateway_counts_leaked_workers_and_still_delivers(toy_plans):
    from repro_torch.obs.metrics import get_registry

    leaked0 = get_registry().counter("gateway.workers_leaked").value
    objects = {f"shard/{i:03d}.npy": v for i, v in enumerate(
        np.random.default_rng(3).bytes(600_000) for _ in range(3))}
    src = _OneHangStore()
    for k, v in objects.items():
        src.put(k, v)
    dst = port_gw.BlobStore()
    try:
        rep = port_gw.transfer_objects(
            toy_plans["port"], src, dst, sorted(objects), chunk_bytes=1 << 17,
            workers_per_hop=3, stall_timeout_s=0.2,
        )
    finally:
        src.release.set()
    assert rep.workers_leaked >= 1
    counted = get_registry().counter("gateway.workers_leaked").value
    assert counted - leaked0 == rep.workers_leaked
    assert rep.to_dict()["metrics"]["gateway.workers_leaked"] == counted
    assert rep.chunks_missing == 0 and rep.checksum_failures == 0
    assert _contents(dst) == objects


def _multicast(gw, plan, objects, *, seeded=None):
    keys = sorted(objects)
    src = _store(gw, objects)
    names = [plan.top.keys()[d] for d in plan.dsts]
    stores = {n: gw.BlobStore() for n in names}
    if seeded is not None:
        stores[names[0]].put(seeded, src.get(seeded))
    rep = gw.transfer_objects_multicast(plan, src, stores, keys,
                                        chunk_bytes=1 << 16)
    return rep, {n: _contents(s) for n, s in stores.items()}


def test_gateway_multicast_zero_byte_objects_reach_all_destinations(
        mc_plans):
    rng = np.random.default_rng(7)
    objects = {"a": rng.bytes(200_000), "empty": b"", "b": rng.bytes(70_000)}
    rep, got = _multicast(port_gw, mc_plans["port"], objects)
    assert rep.chunks_missing == 0 and rep.checksum_failures == 0
    for name, contents in got.items():
        assert contents == objects
        assert rep.per_dest[name].chunks_missing == 0
    assert got == _multicast(ref_gw, mc_plans["ref"], objects)[1]


def test_gateway_multicast_per_destination_resume(mc_plans):
    objects = {"x": np.random.default_rng(8).bytes(150_000)}
    rep, got = _multicast(port_gw, mc_plans["port"], objects, seeded="x")
    names = list(got)
    assert rep.per_dest[names[0]].objects_skipped == 1
    assert rep.per_dest[names[1]].objects_skipped == 0
    ref_rep, ref_got = _multicast(ref_gw, mc_plans["ref"], objects,
                                  seeded="x")
    assert got == ref_got
    assert {n: r.objects_skipped for n, r in rep.per_dest.items()} == \
        {n: r.objects_skipped for n, r in ref_rep.per_dest.items()}


# ------------------------------------------------------------ replication
@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory):
    """A reduced smollm-135m checkpoint saved by the port."""
    from repro_torch.ckpt import save_checkpoint

    cfg = reduced(ARCHS["smollm-135m"])
    params = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return save_checkpoint(tmp_path_factory.mktemp("ckpt"), 3,
                           {"params": params})


def _replicate(ckpt, dsts, **kw):
    """Replicate with each package from the same directory; returns
    {side: (reports, destination contents)}."""
    from repro.ckpt import replicate_checkpoint as ref_replicate
    from repro_torch.ckpt import replicate_checkpoint as port_replicate
    from repro_torch.core import default_topology as port_default

    out = {}
    for side, fn, top, gw in (
        ("ref", ref_replicate, default_topology(), ref_gw),
        ("port", port_replicate, port_default(), port_gw),
    ):
        stores = {d: gw.BlobStore() for d in dsts}
        reports = fn(ckpt, top, "aws:us-east-1", list(dsts), stores, **kw)
        out[side] = (reports, {d: _contents(s) for d, s in stores.items()})
    return out


@pytest.mark.parametrize("dsts", [("gcp:europe-west4",),
                                  ("gcp:europe-west4", "azure:westeurope")])
def test_replicated_checkpoint_files_equal_reference(port_checkpoint, dsts):
    out = _replicate(port_checkpoint, dsts, tput_floor_gbps=5.0)
    reports, got = out["port"]
    ref_reports, want = out["ref"]
    assert got == want
    files = {p.name: p.read_bytes() for p in port_checkpoint.iterdir()}
    for d in dsts:
        assert got[d] == files and "MANIFEST.json" in got[d]
    for rep, ref in zip(reports, ref_reports):
        assert rep.gateway.checksum_failures == 0
        assert rep.plan_tput_gbps >= 5.0 * 0.95
        a, b = rep.to_dict(), ref.to_dict()
        a.pop("gateway"), b.pop("gateway")  # wall-clock link timings
        assert a == b


def test_replicate_rejects_both_planner_modes(tmp_path):
    from repro_torch.ckpt import replicate_checkpoint
    from repro_torch.core import default_topology as port_default

    (tmp_path / "f").write_bytes(b"x" * 128)
    stores = {d: port_gw.BlobStore() for d in MC_DSTS}
    with pytest.raises(ValueError, match="at most one"):
        replicate_checkpoint(tmp_path, port_default(), MC_SRC, list(MC_DSTS),
                             stores, cost_ceiling_per_gb=0.1,
                             tput_floor_gbps=1.0)
    with pytest.raises(ValueError, match="missing from dst_stores"):
        replicate_checkpoint(tmp_path, port_default(), MC_SRC, list(MC_DSTS),
                             {MC_DSTS[0]: port_gw.BlobStore()},
                             tput_floor_gbps=1.0)


def test_shard_placement_equals_reference():
    from repro.data.placement import plan_shard_sources as ref_place
    from repro_torch.core import default_topology as port_default
    from repro_torch.data.placement import plan_shard_sources

    replicas = {0: ["aws:us-east-1", "gcp:asia-southeast1"],
                1: ["gcp:us-central1"], 2: ["aws:us-east-2"]}
    kw = {"consumer_region": "aws:us-east-2", "tput_floor_gbps": 1.0}
    got = plan_shard_sources(port_default(), replicas, **kw)
    want = ref_place(default_topology(), replicas, **kw)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert got[0].source_region == "aws:us-east-1"
    assert got[0].plan_cost_per_gb < 0.05
    assert got[2].plan_cost_per_gb == 0.0  # the consumer holds shard 2
