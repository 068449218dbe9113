"""The port's int8 block quantizer against the reference package's.

On the CPU the port's wrappers (``repro_torch.kernels.quantize.ops``)
take their plain versions; these tests hold them, bit for bit, against
the reference's jnp oracle (``quantize_int8_2d_ref``), and against its
Pallas kernels through ``ops.quantize_int8`` / ``dequantize_int8``
(interpret mode on the CPU), on the cases of the reference's own kernel
and compression tests plus half-way ties, all-zero and NaN blocks, and
bf16 input. Inputs come from numpy seeds.

The Pallas path is jitted as one computation, and XLA's CPU compiler
turns its ``absmax / 127.0`` into a multiply by the reciprocal, which
can land one ulp from the division; the oracle and the port divide
(IEEE), as the CUDA kernel does. So against the Pallas path the scales
are held to 1 ulp, and q to equality in every block whose scale is
equal (a 1-ulp scale may move a value across a rounding boundary).

The CUDA kernels run only on the card, held against the same plain
versions by ``tests/test_torch_cuda_kernels.py`` (``gpu`` marker).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize.ops import dequantize_int8 as j_dequant
from repro.kernels.quantize.ops import quantize_int8 as j_quant
from repro.kernels.quantize.ref import quantize_int8_2d_ref
from repro_torch.kernels.quantize import ops, ref
from repro_torch.obs.metrics import REGISTRY

from test_torch_cases import quantize_inputs
from test_torch_cases import one_thread  # noqa: F401


def _port(x: np.ndarray, block: int):
    q, s = ops.quantize_int8(torch.tensor(x), block=block)
    return q.numpy(), s.numpy()


def _pallas(x: np.ndarray, block: int):
    q, s = j_quant(jnp.asarray(x), block=block)
    return np.asarray(q), np.asarray(s)


def _oracle(x: np.ndarray, block: int):
    """The reference's jnp oracle on x padded with zeros to whole blocks."""
    flat = np.pad(x.reshape(-1), (0, (-x.size) % block)).reshape(-1, block)
    q, s = quantize_int8_2d_ref(jnp.asarray(flat))
    return np.asarray(q).reshape(-1)[:x.size].reshape(x.shape), \
        np.asarray(s)[:, 0]


def _near_pallas(qt, st, qj, sj, block: int):
    """Scales within 1 ulp; q equal in the blocks whose scales are equal,
    and within 1 elsewhere (module docstring)."""
    np.testing.assert_array_max_ulp(st, sj, maxulp=1)
    same = np.repeat(st == sj, block)[:qt.size].reshape(qt.shape)
    np.testing.assert_array_equal(qt[same], qj[same])
    assert np.abs(qt.astype(int) - qj.astype(int)).max(initial=0) <= 1


@pytest.mark.parametrize("rows,block", [(8, 256), (16, 128), (8, 512)])
def test_2d_plain_version_matches_reference_oracle_bitwise(rows, block):
    x = (np.random.default_rng(4).standard_normal((rows * 4, block)) * 10
         ).astype(np.float32)
    qj, sj = quantize_int8_2d_ref(jnp.asarray(x))
    qt, st = ref.quantize_int8_2d_ref(torch.tensor(x))
    assert qt.dtype == torch.int8 and st.shape == (rows * 4, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    back = ref.dequantize_int8_2d_ref(qt, st).numpy()
    np.testing.assert_array_equal(back, np.asarray(qj, np.float32)
                                  * np.asarray(sj))


@pytest.mark.parametrize("case", [
    "normal_1024", "ragged_1000", "tiny_7_block4", "one_block_256",
    "scaled_4000", "ties", "zeros", "leaf_3d", "huge_and_tiny",
])
def test_wrapper_matches_oracle_bitwise_and_pallas_kernel(case):
    x, block = quantize_inputs(case)
    qt, st = _port(x, block)
    assert qt.shape == x.shape and qt.dtype == np.int8
    assert st.shape == (-(-x.size // block),)
    qo, so = _oracle(x, block)
    np.testing.assert_array_equal(qt, qo)
    np.testing.assert_array_equal(st, so)
    qj, sj = _pallas(x, block)
    _near_pallas(qt, st, qj, sj, block)
    # the inverse kernel: the same q and scales in both packages
    back = ops.dequantize_int8(torch.tensor(qj), torch.tensor(sj),
                               block=block).numpy()
    want = np.asarray(j_dequant(jnp.asarray(qj), jnp.asarray(sj),
                                block=block))
    assert back.shape == x.shape and back.dtype == np.float32
    np.testing.assert_array_equal(back, want)


def test_half_way_ties_round_to_even():
    """A block whose absmax is 127 has scale 1, so x / scale is x: the
    ties 2.5 and -2.5 round to 2 and -2, 3.5 and -3.5 to 4 and -4, as
    ``jnp.round`` rounds (``floor(x + 0.5)`` would give 3, -2, 4, -3)."""
    x, block = quantize_inputs("ties")
    q, s = _port(x, block)
    assert s[0] == 1.0
    np.testing.assert_array_equal(q[:9], [2, -2, 4, -4, 0, 0, 2, -2, 127])


def test_zero_block_has_unit_scale():
    x = np.zeros((8, 256), np.float32)
    q, s = _port(x, 256)
    assert np.all(q == 0) and np.all(s == 1.0)
    back = ops.dequantize_int8(torch.tensor(q), torch.tensor(s)).numpy()
    assert np.all(back == 0.0)


def test_nan_block_scale_follows_reference():
    """``amax`` keeps the NaN and ``NaN > 0`` is false, so the block's
    scale is 1.0 in both packages; q of the NaN itself is outside the
    contract, the finite values of its block are held."""
    x = np.random.default_rng(2).standard_normal(600).astype(np.float32)
    x[300] = np.nan
    qt, st = _port(x, 256)
    qo, so = _oracle(x, 256)
    np.testing.assert_array_equal(st, so)
    assert st[1] == 1.0 and _pallas(x, 256)[1][1] == 1.0
    finite = np.isfinite(x)
    np.testing.assert_array_equal(qt[finite], qo[finite])


def test_bf16_input_is_quantized_from_its_f32_values():
    x = (np.random.default_rng(6).standard_normal((3, 700)) * 4
         ).astype(np.float32)
    xb = torch.tensor(x).to(torch.bfloat16)
    qt, st = ops.quantize_int8(xb)
    qo, so = _oracle(xb.float().numpy(), 256)
    np.testing.assert_array_equal(qt.numpy(), qo)
    np.testing.assert_array_equal(st.numpy(), so)
    qj, sj = j_quant(jnp.asarray(x, jnp.bfloat16))
    _near_pallas(qt.numpy(), st.numpy(), np.asarray(qj), np.asarray(sj),
                 256)


@pytest.mark.parametrize("n", [1, 255, 257, 3999])
@pytest.mark.parametrize("seed", range(3))
def test_round_trip_error_bound(n, seed):
    """|x - dq(q(x))| <= absmax / 127 / 2 per block, any length (the
    reference's ``test_quantize_roundtrip_error_bound``)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3)
         ).astype(np.float32)
    q, s = ops.quantize_int8(torch.tensor(x))
    back = ops.dequantize_int8(q, s).numpy()
    bound = np.abs(x).max() / 127.0 * 0.5001 + 1e-6
    assert np.abs(back - x).max() <= bound * 1.01 + 1e-6


def test_plain_entry_points_equal_the_wrapper_on_the_cpu():
    x, block = quantize_inputs("ragged_1000")
    t = torch.tensor(x)
    q, s = ops.quantize_int8(t, block=block)
    q0, s0 = ops.quantize_int8_plain(t, block=block)
    assert torch.equal(q, q0) and torch.equal(s, s0)
    assert torch.equal(ops.dequantize_int8(q, s, block=block),
                       ops.dequantize_int8_plain(q, s, block=block))


def test_cpu_calls_do_not_count_launches():
    qc = REGISTRY.counter("kernels.quantize_int8.launches")
    dc = REGISTRY.counter("kernels.dequantize_int8.launches")
    n0, m0 = qc.value, dc.value
    q, s = ops.quantize_int8(torch.ones(300))
    ops.dequantize_int8(q, s)
    assert (qc.value, dc.value) == (n0, m0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, s = ops.quantize_int8(torch.ones(300))
    with pytest.raises(ValueError):
        ops.dequantize_int8(q, s[:1])
    with pytest.raises(TypeError):
        ops.dequantize_int8(q.to(torch.int32), s)
    with pytest.raises(ValueError):
        ops.quantize_int8(torch.ones(3), block=0)
