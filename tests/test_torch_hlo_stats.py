"""The port's ``launch/hlo_stats.py`` against the reference's.

``parse_collectives`` is copied: on HLO lines of each of the five
collective kinds, with both ``replica_groups`` syntaxes, it gives the
reference's result (the reference module imports no jax). The recorder
prices each collective it sees by ``wire_bytes``, the one home of the
ring formulas, and counts every op once at its local size: a DTensor
product on a fake (2, 16, 16) mesh whose placements divide every dim
counts 1/512 of the global product on each rank. The fake process group
lives in this process for the module and is destroyed after it.
"""

from __future__ import annotations

import pytest
import torch

from test_torch_cases import one_thread  # noqa: F401

# one line per kind; the first five name their groups as [n,g]<=[...]
# (iota), the rest list them ({{...},{...}})
HLO = "\n".join([
    "%all-gather.1 = f32[96,576]{0,1} all-gather(%p0), channel_id=1, "
    "replica_groups=[16,16]<=[256], dimensions={0}",
    "%all-reduce.2 = bf16[4,1024]{1,0} all-reduce(%p1), channel_id=2, "
    "replica_groups=[2,128]<=[256], to_apply=%add",
    "%reduce-scatter.3 = f32[8,128]{1,0} reduce-scatter(%p2), "
    "channel_id=3, replica_groups=[32,8]<=[256], dimensions={0}, "
    "to_apply=%add",
    "%all-to-all.4 = s32[16,16]{1,0} all-to-all(%p3), channel_id=4, "
    "replica_groups=[64,4]<=[256], dimensions={0}",
    "%collective-permute.5 = f32[1024]{0} collective-permute(%p4), "
    "channel_id=5, source_target_pairs={{0,1},{1,0}}",
    "%all-gather-start.6 = (f32[8], f32[64]) all-gather-start(%p5), "
    "replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}",
    "%all-reduce.7 = f32[2,3]{1,0} all-reduce(%p6), "
    "replica_groups={{0,1},{2,3}}, to_apply=%add",
    "%reduce-scatter.8 = bf16[16]{0} reduce-scatter(%p7), "
    "replica_groups={{0,1,2,3}}, dimensions={0}",
    "%all-to-all.9 = f32[4,4]{1,0} all-to-all(%p8), "
    "replica_groups={{0,1,2,3}}, dimensions={1}",
    "%collective-permute-start.10 = s8[256]{0} "
    "collective-permute-start(%p9), source_target_pairs={{0,1}}",
    "%add.11 = f32[4]{0} add(%a, %b)",
])
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


@pytest.mark.parametrize("line", HLO.splitlines(),
                         ids=lambda s: s[1:s.index(" ")])
def test_parse_collectives_equals_reference_per_line(line):
    from repro.launch import hlo_stats as ref
    from repro_torch.launch import hlo_stats as port

    assert port.parse_collectives(line).as_dict() == \
        ref.parse_collectives(line).as_dict()


def test_parse_collectives_equals_reference_on_the_module():
    from repro.launch import hlo_stats as ref
    from repro_torch.launch import hlo_stats as port

    got = port.parse_collectives(HLO).as_dict()
    assert got == ref.parse_collectives(HLO).as_dict()
    assert set(got["counts"]) == set(KINDS)
    assert all(n == 2 for n in got["counts"].values())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("g", [1, 2, 16, 512])
def test_wire_bytes_is_the_reference_formula(kind, g):
    """``wire_bytes`` of one op equals the reference's parse of a line of
    that op with ``g`` devices in its group."""
    from repro.launch import hlo_stats as ref
    from repro_torch.launch import hlo_stats as port

    groups = f"replica_groups=[{512 // g},{g}]<=[512]"
    line = f"%x.1 = f32[64,32]{{1,0}} {kind}(%p), {groups}"
    want = ref.parse_collectives(line).wire_bytes
    assert port.wire_bytes(kind, 64 * 32 * 4, g) == want


def test_constants_are_the_h100_datasheet_values():
    from repro_torch.launch import hlo_stats

    assert hlo_stats.PEAK_FLOPS == 989e12
    assert hlo_stats.HBM_BW == 3.35e12
    assert hlo_stats.ICI_BW == 450e9
    terms = hlo_stats.roofline_terms(989e12, 3.35e12, 450e9)
    assert terms == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
    assert hlo_stats.dominant_term({"compute_s": 1, "memory_s": 2,
                                    "collective_s": 0}) == "memory"


# ------------------------------------------------- on a fake process group
@pytest.fixture(scope="module")
def mesh():
    """The multi-pod mesh over a fake group of 512 ranks (this process
    rank 0), torn down after the module."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        yield make_production_mesh(multi_pod=True, device="cpu")
    finally:
        dist.destroy_process_group()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


FUNCTIONAL = {
    # kind: (call on x [32, 64] f32 over group g, the result's bytes)
    "all-gather": (lambda fc, x, g: fc.all_gather_tensor(x, 0, g),
                   lambda n: 32 * 64 * 4 * n),
    "reduce-scatter": (lambda fc, x, g: fc.reduce_scatter_tensor(
        x, "sum", 0, g), lambda n: 32 * 64 * 4 // n),
    "all-reduce": (lambda fc, x, g: fc.all_reduce(x, "sum", g),
                   lambda n: 32 * 64 * 4),
    "all-to-all": (lambda fc, x, g: fc.all_to_all_single(x, None, None, g),
                   lambda n: 32 * 64 * 4),
}


@pytest.mark.parametrize("axis", ["pod", "model"])
@pytest.mark.parametrize("kind", sorted(FUNCTIONAL))
def test_recorder_prices_functional_collectives_by_wire_bytes(mesh, kind,
                                                             axis):
    import torch.distributed._functional_collectives as fc

    from repro_torch.launch import hlo_stats

    call, result = FUNCTIONAL[kind]
    group = mesh.get_group(axis)
    n = group.size()
    x = _meta(32, 64)
    with hlo_stats.StepRecorder() as rec:
        fc.wait_tensor(call(fc, x, group))
    c = rec.collectives
    assert c.counts == {kind: 1}
    assert c.result_bytes == {kind: result(n)}
    assert c.wire_bytes == hlo_stats.wire_bytes(kind, result(n), n)
    assert rec.flops == 0


def test_recorder_prices_c10d_all_reduce_and_ring_hops(mesh):
    """``dist.all_reduce`` (the pod mean of the loss) is a c10d op on a
    boxed group; a ring hop is reported by the collective's meta route."""
    import torch.distributed as dist

    from repro_torch.launch import hlo_stats
    from repro_torch.transfer import collective

    pod = mesh.get_group("pod")
    x = _meta(1000)
    with hlo_stats.StepRecorder() as rec:
        dist.all_reduce(x, group=pod)
        got = collective._exchange([_meta(300, dtype=torch.int8),
                                    _meta(2)], pod, 1, 1)
    assert [tuple(t.shape) for t in got] == [(300,), (2,)]
    assert got[0].dtype == torch.int8 and got[0].is_meta
    c = rec.collectives
    assert c.counts == {"all-reduce": 1, "collective-permute": 2}
    assert c.result_bytes == {"all-reduce": 4000, "collective-permute": 308}
    assert c.wire_bytes == (hlo_stats.wire_bytes("all-reduce", 4000, 2)
                            + hlo_stats.wire_bytes("collective-permute",
                                                   308, 2))


@pytest.mark.parametrize("case", ["batch_by_columns", "contracted"])
def test_flop_rule_counts_each_op_once_at_local_size(mesh, case):
    """A [256, 1024] x [1024, 4096] DTensor product whose placements
    divide every dim over all three mesh axes: one rank's count times 512
    is the global product's, and DTensor's own global-shape run (its
    shape inference on fake tensors) is not counted."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import hlo_stats

    if case == "batch_by_columns":  # rows over (pod, data), columns over model
        pa, pb = (Shard(0), Shard(0), Replicate()), (Replicate(),
                                                     Replicate(), Shard(1))
    else:  # rows over (pod, data), the contracted dim over model
        pa, pb = (Shard(0), Shard(0), Shard(1)), (Replicate(), Replicate(),
                                                  Shard(0))

    def dt(shape, pl):
        local = list(shape)
        for axis, p in zip(("pod", "data", "model"), pl):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(mesh.mesh_dim_names.index(axis))
        return DTensor.from_local(_meta(*local), mesh, list(pl),
                                  run_check=False, shape=shape,
                                  stride=_meta(*shape).stride())

    a, b = dt((256, 1024), pa), dt((1024, 4096), pb)
    glob = 2 * 256 * 1024 * 4096
    with FlopCounterMode(display=False) as fcm:
        torch.mm(_meta(256, 1024), _meta(1024, 4096))
    assert fcm.get_total_flops() == glob
    for _ in range(2):  # the second product hits DTensor's sharding cache
        with hlo_stats.StepRecorder() as rec:
            c = a @ b
        assert rec.flops * 512 == glob
    assert c.shape == (256, 4096)
    # the contracted case leaves a partial sum, reduced by no collective yet
    assert rec.collectives.counts == {}


def test_recorder_tracks_arguments_peak_and_outputs():
    from repro_torch.launch import hlo_stats

    w = _meta(64, 64)
    with hlo_stats.StepRecorder((w,)) as rec:
        h = w @ w  # 16 KiB
        h2 = h @ w  # 16 KiB more live
        del h
        out = h2.sum()
    rec.close((out, w))
    assert rec.argument_bytes == 64 * 64 * 4
    assert rec.peak_bytes == 2 * 64 * 64 * 4
    assert rec.alias_bytes == 64 * 64 * 4 and rec.output_bytes == 4
    assert rec.temp_bytes == rec.peak_bytes - 4
    assert rec.flops == 2 * (2 * 64 ** 3)
    # operands + outputs of the two products and the sum
    assert rec.bytes == 3 * 16384 * 2 + 16384 + 4


# indexed ops on a [B, T, K, D] = [2, 1024, 4, 64] f32 cache (8 MiB) and
# one row of it, R = 2 * 4 * 64 * 4 bytes; a long index of one slot is 8
# bytes, one expanded over the row 2R. Each op: (the call on the cache,
# the row and the slot's index, the bytes it moves): the index, the
# source row, and the row of the cache it reads or writes (twice where it
# adds: read, then written)
R = 2 * 4 * 64 * 4


def _row_index(i):
    return i.reshape(1, 1, 1, 1).expand(2, 1, 4, 64)


INDEXED = {
    "index_copy_": (lambda c, r, i: c.index_copy_(1, i, r), 8 + 2 * R),
    "index_add_": (lambda c, r, i: c.index_add_(1, i, r), 8 + 3 * R),
    # c[:, i] = r: an index_put_ with indices (None, i)
    "index_put_": (lambda c, r, i: c.__setitem__((slice(None), i), r),
                   8 + 2 * R),
    "index_select": (lambda c, r, i: c.index_select(1, i), 8 + 2 * R),
    "index": (lambda c, r, i: c[:, i], 8 + 2 * R),
    "gather": (lambda c, r, i: c.gather(1, _row_index(i)), 2 * R + 2 * R),
    "scatter_": (lambda c, r, i: c.scatter_(1, _row_index(i), r),
                 2 * R + 2 * R),
    "scatter_add_": (lambda c, r, i: c.scatter_add_(1, _row_index(i), r),
                     2 * R + 3 * R),
    # the table's rows [1024, 64] at a [2, 1] batch of tokens
    "embedding": (lambda c, r, i: torch.nn.functional.embedding(
        i.reshape(1, 1).expand(2, 1), c[0, :, 0]), 16 + 2 * 2 * 64 * 4),
}


@pytest.mark.parametrize("op", sorted(INDEXED))
def test_indexed_ops_count_the_rows_they_touch(op):
    """One row written into or read from a KV cache moves that row, the
    index and the source, not the whole cache: a decode step's slot write
    is two rows of bytes."""
    from repro_torch.launch import hlo_stats

    call, want = INDEXED[op]
    cache, row = _meta(2, 1024, 4, 64), _meta(2, 1, 4, 64)
    slot = torch.empty(1, dtype=torch.long, device="meta")
    with hlo_stats.StepRecorder() as rec:
        call(cache, row, slot)
    assert rec.bytes == want
    assert rec.flops == 0
