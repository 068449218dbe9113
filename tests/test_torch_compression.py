"""The port's gradient compressor against the reference package's.

``repro_torch.transfer.compression`` on the CPU (``use_pallas`` False:
the plain quantizer; True: the kernel wrappers, which take the plain
versions on the CPU) against ``repro.transfer.compression``'s plain jnp
path, bit for bit: quantize, dequantize, ``compress`` and 25 steps of
error feedback over a dict of several leaves. The reference's
``use_pallas=True`` path (its Pallas kernel in interpret mode) divides by
127 through a reciprocal multiply that XLA's CPU compiler substitutes,
one ulp from the division in some blocks (``test_torch_quantize``);
against it the 25 error-feedback steps are held to 1e-6 of each leaf's
largest value. The reference's own properties (error bound, zero
blocks, idempotence, bounded residual, preserved signal) are held on the
port.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.transfer import compression as jc
from repro_torch.transfer import compression as tc

from test_torch_cases import quantize_inputs
from test_torch_cases import one_thread  # noqa: F401


def _grads(seed: int) -> dict:
    """A multi-leaf gradient dict: nested, ragged leaf sizes."""
    rng = np.random.default_rng(seed)
    return {
        "embed": {"tok": rng.standard_normal((40, 24)) * 0.05},
        "blocks": {"wq": rng.standard_normal((3, 24, 2, 8)) * 0.02,
                   "ln1": rng.standard_normal((3, 24)) * 1e-3},
        "final_norm": rng.standard_normal(24) * 0.1,
    }


def _np_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _np_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _eq_trees(t_tree, j_tree):
    for k, v in j_tree.items():
        if isinstance(v, dict):
            _eq_trees(t_tree[k], v)
        else:
            np.testing.assert_array_equal(t_tree[k].numpy(), np.asarray(v),
                                          err_msg=k)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", ["normal_1024", "ragged_1000",
                                  "tiny_7_block4", "one_block_256", "zeros",
                                  "ties"])
def test_quantize_dequantize_compress_match_reference(case, use_pallas):
    x, block = quantize_inputs(case)
    qt, st = tc.quantize_int8_blockwise(torch.tensor(x), block,
                                        use_pallas=use_pallas)
    qj, sj = jc.quantize_int8_blockwise(jnp.asarray(x), block)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dt = tc.dequantize_int8_blockwise(qt, st, block)
    assert dt.shape == (x.size,)
    np.testing.assert_array_equal(
        dt.numpy(), np.asarray(jc.dequantize_int8_blockwise(qj, sj, block)))
    ct = tc.compress(torch.tensor(x), block, use_pallas=use_pallas)
    cj = jc.compress(jnp.asarray(x), block)
    assert ct.shape == x.shape and ct.dtype == torch.float32
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


@pytest.mark.parametrize("n,block", [(1024, 256), (1000, 256), (7, 4),
                                     (256, 256)])
def test_quantize_dequantize_error_bound(n, block):
    """|x - deq(q)| <= blockwise absmax / 127 / 2 (the reference's test)."""
    x = np.random.default_rng(0).normal(size=n).astype(np.float32)
    q, scales = tc.quantize_int8_blockwise(torch.tensor(x), block)
    assert q.shape == x.shape and q.dtype == torch.int8
    assert scales.shape[0] == -(-n // block)
    err = np.abs(tc.dequantize_int8_blockwise(q, scales, block).numpy() - x)
    for b in range(scales.shape[0]):
        lo, hi = b * block, min((b + 1) * block, n)
        assert err[lo:hi].max() <= np.abs(x[lo:hi]).max() / 127.0 * 0.5 + 1e-7


def test_compress_keeps_dtype_and_is_idempotent():
    x = torch.tensor(np.random.default_rng(1).normal(size=512),
                     dtype=torch.float32)
    y1 = tc.compress(x)
    assert torch.equal(tc.compress(y1), y1)
    xb = x.to(torch.bfloat16)
    yb = tc.compress(xb, use_pallas=True)
    assert yb.dtype == torch.bfloat16
    want = jc.compress(jnp.asarray(x.numpy(), jnp.bfloat16))
    np.testing.assert_array_equal(yb.float().numpy(),
                                  np.asarray(want, np.float32))


def _ef_runs(t_pallas: bool, j_pallas: bool):
    """25 error-feedback steps on both sides, fresh gradients each step
    (from numpy); yields (port sent, port residual, reference sent,
    reference residual) per step."""
    j_ef = t_ef = None
    for step in range(25):
        g = _np_tree(_grads(step), lambda a: a.astype(np.float32))
        jg = _np_tree(g, jnp.asarray)
        tg = _np_tree(g, torch.tensor)
        if step == 0:
            j_ef, t_ef = jc.init_error_feedback(jg), tc.init_error_feedback(tg)
        j_sent, j_ef = jc.compress_with_error_feedback(
            jg, j_ef, use_pallas=j_pallas)
        t_sent, t_ef = tc.compress_with_error_feedback(
            tg, t_ef, use_pallas=t_pallas)
        yield t_sent, t_ef, j_sent, j_ef


@pytest.mark.parametrize("use_pallas", [False, True])
def test_error_feedback_25_steps_match_reference_bitwise(use_pallas):
    for t_sent, t_ef, j_sent, j_ef in _ef_runs(use_pallas, False):
        _eq_trees(t_sent, j_sent)
        _eq_trees(t_ef, j_ef)
    assert jax.tree.structure(j_sent) == jax.tree.structure(
        _np_tree(t_sent, lambda t: 0))


def _leaf_pairs(t_tree, j_tree):
    for k, v in j_tree.items():
        if isinstance(v, dict):
            yield from _leaf_pairs(t_tree[k], v)
        else:
            yield k, t_tree[k].numpy(), np.asarray(v)


def test_error_feedback_25_steps_near_reference_pallas_path():
    """Against the Pallas path (module docstring) the two drift apart by
    the ulps of its scales, fed back step by step: sent gradients and
    residuals within 1e-6 of each leaf's largest sent value (measured
    4.1e-7 and 6.7e-7 over the 25 steps)."""
    for t_sent, t_ef, j_sent, j_ef in _ef_runs(True, True):
        for (k, ts, js), (_, te, je) in zip(_leaf_pairs(t_sent, j_sent),
                                            _leaf_pairs(t_ef, j_ef)):
            tol = 1e-6 * np.abs(js).max()
            np.testing.assert_allclose(ts, js, rtol=0, atol=tol, err_msg=k)
            np.testing.assert_allclose(te, je, rtol=0, atol=tol, err_msg=k)


def test_error_feedback_accumulation_bounded():
    """The carried residual stays within two quantization steps (the
    reference's test): the error does not accumulate."""
    rng = np.random.default_rng(3)
    g = {"w": torch.tensor(rng.normal(size=513) * 0.05, dtype=torch.float32)}
    ef = tc.init_error_feedback(g)
    assert torch.equal(ef["w"], torch.zeros(513))
    step_bound = float(g["w"].abs().max()) * 2.0 / 127.0 + 1e-6
    for _ in range(25):
        sent, ef = tc.compress_with_error_feedback(g, ef)
        assert float(ef["w"].abs().max()) <= 2.0 * step_bound
    assert sorted(sent) == sorted(ef) == ["w"]


def test_error_feedback_single_step_identity_and_signal():
    """sent + residual == corrected gradient; over 30 steps the sent sum
    is within 1% of n g (the reference's integration test)."""
    g = {"w": torch.tensor(np.random.default_rng(0).normal(size=257) * 0.1,
                           dtype=torch.float32)}
    ef = tc.init_error_feedback(g)
    sent, ef2 = tc.compress_with_error_feedback(g, ef)
    torch.testing.assert_close(sent["w"] + ef2["w"], g["w"], rtol=0,
                               atol=1e-6)
    total, ef, n = torch.zeros(257), tc.init_error_feedback(g), 30
    for _ in range(n):
        sent, ef = tc.compress_with_error_feedback(g, ef, use_pallas=True)
        total = total + sent["w"]
    rel = float(torch.linalg.norm(total - n * g["w"])
                / torch.linalg.norm(n * g["w"]))
    assert rel < 0.01
