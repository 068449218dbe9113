"""The port's water-filling against the reference package's.

On the CPU the port's wrapper takes the plain versions (``repro_torch.
kernels.waterfill.ref``); these tests hold them against the reference:

  * the f64 parity solver is BITWISE equal to the numpy sim's
    ``_maxmin_rates_arr`` on the active lanes and to the reference's jnp
    ``masked_maxmin_rates`` (float64) on every lane;
  * the f32 rounds match the reference's Pallas kernel (interpret mode on
    the CPU) at the f32 tolerance the reference's own kernel test uses.

The CUDA kernels themselves run only on the card, held against these plain
versions by ``tests/test_torch_cuda_kernels.py`` (``gpu`` marker).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.waterfill.ops import waterfill_rates as pallas_rates
from repro.kernels.waterfill.ref import masked_maxmin_rates as jnp_masked
from repro.transfer.flowsim import _maxmin_rates_arr
from repro_torch.kernels.waterfill import ops, ref
from repro_torch.obs.metrics import REGISTRY

from test_torch_cases import (
    SEGSUM_CASES,
    WATERFILL_CHAIN_CASES,
    segsum_case,
    waterfill_chain_case,
)
from test_torch_cases import waterfill_case as _case
from test_torch_cases import one_thread  # noqa: F401


def _port_rates(case, precision, **kw):
    caps, src, dst, eg, inn, eid, ed, active, nv, ne = case
    dtype = torch.float64 if precision == "f64" else torch.float32

    def f(a):
        return torch.as_tensor(a, dtype=dtype)

    return ops.waterfill_rates(
        f(caps), torch.as_tensor(src), torch.as_tensor(dst), f(eg), f(inn),
        None if ed is None else torch.as_tensor(eid),
        None if ed is None else f(ed), torch.as_tensor(active),
        precision=precision, **kw,
    ).numpy()


def _f64_bitwise_vs_numpy_oracle_and_jnp_masked(case):
    caps, src, dst, eg, inn, eid, ed, active, nv, ne = case
    got = _port_rates(case, "f64")
    want = _maxmin_rates_arr(
        caps[active], src[active], dst[active], eg, inn,
        eid[active] if ed is not None else None, ed,
    )
    assert np.array_equal(got[active], want)
    assert np.all(got[~active] == 0.0)
    with jax.enable_x64(True):
        ref_jnp = np.asarray(jnp_masked(
            jnp.asarray(caps), jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(eg), jnp.asarray(inn), jnp.asarray(eid),
            None if ed is None else jnp.asarray(ed),
            jnp.asarray(active), n_vms=nv, n_edges=ne,
        ))
    assert ref_jnp.dtype == np.float64
    assert np.array_equal(got, ref_jnp)


@pytest.mark.parametrize("with_edges", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_f64_bitwise_vs_numpy_oracle_and_jnp_masked(seed, with_edges):
    _f64_bitwise_vs_numpy_oracle_and_jnp_masked(
        _case(seed, with_edges=with_edges))


@pytest.mark.parametrize("name", WATERFILL_CHAIN_CASES)
def test_chain_cases_f64_bitwise_vs_numpy_oracle_and_jnp_masked(name):
    """One segment holding every lane, every lane tied at the threshold,
    zero caps: the cases that stress the kernel's ordered chains."""
    _f64_bitwise_vs_numpy_oracle_and_jnp_masked(waterfill_chain_case(name))


@pytest.mark.parametrize("name", WATERFILL_CHAIN_CASES)
def test_chain_cases_f32_rounds_match_pallas_kernel(name):
    case = waterfill_chain_case(name)
    caps, src, dst, eg, inn, eid, ed, active, nv, ne = case
    got = _port_rates(case, "f32")
    want = np.asarray(pallas_rates(caps, src, dst, eg, inn, eid, ed, active))
    np.testing.assert_allclose(got[active], want[active], rtol=5e-3,
                               atol=5e-3)
    assert np.all(got[~active] == 0.0)


@pytest.mark.parametrize("with_edges", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_f32_rounds_match_pallas_kernel(seed, with_edges):
    """The f32 transliteration of the TPU kernel's rounds against the
    reference's Pallas kernel, at the reference kernel test's tolerance
    (rtol = atol = 5e-3: both are f32 and sum in different orders)."""
    case = _case(seed, with_edges=with_edges)
    caps, src, dst, eg, inn, eid, ed, active, nv, ne = case
    got = _port_rates(case, "f32")
    want = np.asarray(pallas_rates(
        caps, src, dst, eg, inn, eid if ed is not None else None, ed, active,
    ))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[active], want[active], rtol=5e-3,
                               atol=5e-3)
    assert np.all(got[~active] == 0.0)
    oracle = _maxmin_rates_arr(
        caps[active], src[active], dst[active], eg, inn,
        eid[active] if ed is not None else None, ed,
    )
    np.testing.assert_allclose(got[active], oracle, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_changed_flag_returns_cached_rates(precision):
    case = _case(7, with_edges=True)
    first = _port_rates(case, precision)
    dtype = torch.float64 if precision == "f64" else torch.float32
    prev = torch.full((first.shape[0],), 3.25, dtype=dtype)
    same = _port_rates(case, precision, changed=torch.tensor(False),
                       prev=prev)
    assert np.all(same == 3.25)
    again = _port_rates(case, precision, changed=torch.tensor(True),
                        prev=prev)
    assert np.array_equal(again, first)


@pytest.mark.parametrize("seed", range(3))
def test_ordered_segment_sum_is_bincount(seed):
    rng = np.random.default_rng(seed)
    n, nseg = int(rng.integers(1, 300)), int(rng.integers(1, 9))
    seg = rng.integers(0, nseg, n)
    vals = rng.uniform(0.0, 5.0, n) * (rng.uniform(size=n) < 0.7)
    got = ops.segment_sum_ordered(
        torch.as_tensor(vals), torch.as_tensor(seg), nseg
    ).numpy()
    assert np.array_equal(got, np.bincount(seg, weights=vals, minlength=nseg))


@pytest.mark.parametrize("name", SEGSUM_CASES)
def test_ordered_segment_sum_cases_bitwise(name):
    """Zeros between nonzeros, empty segments, a segment of 12,000 lanes,
    a run of equal values and many short segments: bitwise equal to
    numpy's bincount and to the reference's ``jax.ops.segment_sum`` in
    float64."""
    vals, seg, nseg = segsum_case(name)
    got = ops.segment_sum_ordered(
        torch.as_tensor(vals), torch.as_tensor(seg), nseg
    ).numpy()
    assert np.array_equal(got, np.bincount(seg, weights=vals, minlength=nseg))
    with jax.enable_x64(True):
        want = np.asarray(jax.ops.segment_sum(
            jnp.asarray(vals), jnp.asarray(seg), num_segments=nseg))
    assert want.dtype == np.float64
    assert np.array_equal(got, want)


def test_csr_lists_are_ascending_per_row():
    rng = np.random.default_rng(3)
    idx = torch.as_tensor(rng.integers(0, 6, 50))
    off, lanes = ops.csr(idx, 7)
    off, lanes = off.numpy(), lanes.numpy()
    assert off[0] == 0 and off[-1] == 50 and off[-2] == off[-1]  # row 6 empty
    for r in range(7):
        row = lanes[off[r]:off[r + 1]]
        assert np.all(np.diff(row) > 0)
        assert np.all(idx.numpy()[row] == r)
    with pytest.raises(ValueError):
        ops.csr(torch.tensor([0, 7]), 7)


def test_no_kernel_and_no_fallback_off_cpu_and_cuda():
    """A tensor on a device with no kernel raises; nothing is quietly
    computed by the plain version."""
    z = torch.zeros(4, device="meta")
    i = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ops.waterfill_rates(z, i, i, z, z)
    with pytest.raises(ValueError):
        ops.segment_sum_ordered(z.double(), i, 2)


# (label, nc, nv, ne, precision, kernel, K, bytes a block, lanes shared):
# the block counts transcribed by hand from csrc/waterfill.cu's layouts
# (the staged block, f64: 24 warps' runs of 128 + 8, the round's least
# share, cap and rate per lane, a rate per list position (three lists of
# nc rounded up to 32) + 8, budget and share per segment; 5 + 3 * nseg
# ints and two bit words per 32 list positions; six 16-bit ids and
# positions and a state byte per lane; the f32 block: 12 warps' minima and
# runs of 256 + 8, cap and rate per lane,
# budget and share per segment, 13 + nseg ints, a state byte per lane; a
# cluster block: 64 bytes of ring mbarriers (4 full, 4 empty), 16 warps'
# minima and runs of 128 + 8, the block's minimum, the share replica, owned
# budgets, 4 ring slots of 512 + 8, cap and rate per own lane, 29 + 5 ints
# per owned segment, a state byte per own lane; each rounded up to 16
# bytes)
SIZE_CASES = [
    ("fig6_sim", 600, 20, 1, "f64", "waterfill_f64_shared", 1, 59_808,
     True),
    ("fleet", 24_576, 768, 3, "f64", "waterfill_f64_cluster", 4, 161_904,
     True),
    ("fleet_f32", 24_576, 768, 3, "f32", "waterfill_f32_cluster", 2,
     152_512, True),
    ("at_the_one_block_limit", 24_384, 8, 2, "f32", "waterfill_f32", 1,
     232_448, True),
    ("one_lane_past_it", 24_385, 8, 2, "f32", "waterfill_f32_cluster", 2,
     127_312, True),
    ("past_a_16_block_cluster", 262_144, 64, 16, "f64",
     "waterfill_f64_cluster", 16, 35_776, False),
    ("bcast_sim", 640, 12, 36, "f64", "waterfill_f64_shared", 1, 62_288,
     True),
    ("fig6_sim_f32", 600, 20, 1, "f32", "waterfill_f32", 1, 18_672, True),
    ("at_the_staged_limit", 3_804, 12, 36, "f64", "waterfill_f64_shared", 1,
     232_448, True),
    ("one_lane_past_the_staged_limit", 3_805, 12, 36, "f64",
     "waterfill_f64_cluster", 2, 68_048, True),
    ("f64_where_one_block_held_it", 12_152, 8, 2, "f64",
     "waterfill_f64_cluster", 2, 138_064, True),
    ("direct_fleet_of_22_jobs", 11_264, 352, 3, "f64",
     "waterfill_f64_cluster", 2, 145_680, True),
]


@pytest.mark.parametrize("case", SIZE_CASES, ids=[c[0] for c in SIZE_CASES])
def test_size_mirror_picks_the_kernel_its_blocks_and_their_bytes(case):
    """The Python mirror of the library's size rule (which a card test holds
    equal to the library's own functions): which kernel a solve takes,
    the cluster's K and each block's shared memory, at the Fig. 6 sim's
    shape (f64 on the staged kernel, f32 on the one-block one), the
    broadcast's (640 lanes, 12 VMs, 36 edges), exactly at the staged
    kernel's limit and one lane past it (a cluster of 2: f64 has no other
    one-block kernel), the fleet's 24,576 lanes (768 VMs, 3 edges),
    exactly at the f32 one block's limit and one lane past it, the f64
    solves that one block held before the staged kernel (up to 12,152
    lanes at 8 VMs and 2 edges; 22 direct jobs of 8 VMs), which a cluster
    of 2 solves faster, and past what a 16-block cluster holds (lanes in
    device memory)."""
    _, nc, nv, ne, precision, kernel, k, nbytes, shared = case
    plan = ops.launch_plan(nc, nv, ne, precision)
    assert plan == (kernel, k, nbytes, shared)
    assert ops.needs_cluster(nc, nv, ne, precision) == (k > 1)
    assert ops.takes_shared(nc, nv, ne, precision) == (
        kernel == "waterfill_f64_shared")
    assert nbytes <= ops.SMEM_LIMIT
    if k > 1:
        assert ops.cluster_plan(nc, nv, ne, precision) == plan
        if k > 2 and shared:  # the smallest K whose blocks hold the lanes
            smaller = ops.cluster_smem_bytes(nc, nv, ne, 8 if precision ==
                                             "f64" else 4, k // 2, True)
            assert smaller > ops.SMEM_LIMIT
