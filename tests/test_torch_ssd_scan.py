"""The port's SSD scan against the reference package's.

On the CPU the port's wrapper takes its plain version (``repro_torch.
kernels.ssd_scan.ref``); these tests hold it against the reference's
Pallas kernel (interpret mode on the CPU) on every case of the reference's
own kernel tests, at their tolerances (1e-3 in f32, 1e-1 in bf16, absolute
and relative), check the final state against the token-by-token
recurrence, and put a ragged sequence through both wrappers' dt = 0
padding.

The CUDA kernel itself runs only on the card, held against the plain
version by ``tests/test_torch_cuda_kernels.py`` (``gpu`` marker).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as pallas_ssd_ops
from repro.kernels.ssd_scan.ssd_scan import ssd_scan_bhsp
from repro_torch.kernels.ssd_scan import ops, ref
from repro_torch.obs.metrics import REGISTRY

from test_torch_cases import ssd_inputs
from test_torch_cases import one_thread  # noqa: F401

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,h,s,p,n,q",
    [(1, 2, 64, 16, 16, 16), (2, 3, 128, 16, 32, 32), (1, 4, 256, 32, 64, 64)],
)
def test_ssd_matches_reference_sweep(dtype, b, h, s, p, n, q):
    x, dt, a, bm, cm = ssd_inputs(0, b, h, s, p, n)
    jd, td = _JNP[dtype], _TORCH[dtype]
    yk, sk = ssd_scan_bhsp(
        jnp.asarray(x, jd), jnp.asarray(dt, jd), jnp.asarray(a),
        jnp.asarray(bm, jd), jnp.asarray(cm, jd), chunk=q, interpret=True,
    )
    yr, sr = ref.ssd_scan_bhsp_ref(
        torch.tensor(x).to(td), torch.tensor(dt).to(td), torch.tensor(a),
        torch.tensor(bm).to(td), torch.tensor(cm).to(td), chunk=q,
    )
    assert yr.dtype == td and sr.dtype == torch.float32
    tol = 1e-3 if dtype == "float32" else 1e-1
    np.testing.assert_allclose(yr.float().numpy(), np.asarray(yk, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(sr.numpy(), np.asarray(sk), atol=tol, rtol=tol)


def test_ssd_state_continuity():
    """Final state of the wrapper == the recurrence run token by token."""
    b, h, s, p, n, q = 1, 1, 64, 8, 8, 16
    x, dt, a, bm, cm = ssd_inputs(3, b, h, s, p, n, layout="bshp")
    _, state = ops.ssd_scan(*(torch.tensor(t) for t in (x, dt, a, bm, cm)),
                            chunk=q)
    want = np.zeros((p, n))
    for t in range(s):
        d = float(dt[0, t, 0])
        want = want * np.exp(d * float(a[0])) + d * np.outer(x[0, t, 0],
                                                             bm[0, t])
    np.testing.assert_allclose(state[0, 0].numpy(), want, atol=1e-3)


@pytest.mark.parametrize("s,q", [(100, 32), (40, 16), (10, 256)])
def test_ssd_ragged_through_ops_matches_reference(s, q):
    """A sequence off the chunk grid: both wrappers pad with dt = 0."""
    arrays = ssd_inputs(5, 2, 3, s, 16, 32, layout="bshp")
    yj, sj = pallas_ssd_ops(*(jnp.asarray(t) for t in arrays), chunk=q)
    yt, st = ops.ssd_scan(*(torch.tensor(t) for t in arrays), chunk=q)
    assert yt.shape == (2, s, 3, 16)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-3,
                               rtol=1e-3)


def test_cpu_calls_do_not_count_and_other_devices_raise():
    arrays = [torch.tensor(t) for t in ssd_inputs(6, 1, 2, 32, 8, 8,
                                                layout="bshp")]
    n0 = REGISTRY.counter("kernels.ssd_scan.launches").value
    ops.ssd_scan(*arrays, chunk=16)
    assert REGISTRY.counter("kernels.ssd_scan.launches").value == n0
    with pytest.raises(ValueError):
        ops.ssd_scan(*(t.to("meta") for t in arrays), chunk=16)


@pytest.mark.parametrize("dtype,q,p,n,want", [
    (torch.bfloat16, 256, 64, 64, "wgmma"),    # Zamba2-7B's chunk, P, N
    (torch.bfloat16, 256, 64, 128, "wgmma"),
    (torch.bfloat16, 256, 32, 128, "wgmma"),
    (torch.bfloat16, 64, 32, 64, "wgmma"),
    (torch.float32, 256, 64, 64, "vector"),    # f32 keeps the vector units
    (torch.float32, 64, 32, 64, "vector"),
    (torch.bfloat16, 16, 16, 16, "vector"),    # the small test chunks
    (torch.bfloat16, 32, 16, 32, "vector"),
    (torch.bfloat16, 100, 64, 64, "vector"),   # a chunk cut to a short S
    (torch.bfloat16, 256, 64, 136, "vector"),  # state past 128
    (torch.bfloat16, 256, 12, 64, "vector"),   # head dim off the 8 grid
])
def test_kernel_routing_rule(dtype, q, p, n, want):
    """Which CUDA kernel a card call takes is a pure rule of type and
    shape: bf16 at the tensor-core kernel's shapes takes it, f32 and the
    other shapes the vector-unit kernel."""
    assert ops.kernel_for(dtype, q, p, n) == want


def test_named_kernel_entry_runs_only_on_the_card():
    arrays = [torch.tensor(t) for t in ssd_inputs(6, 1, 2, 64, 8, 8,
                                                layout="bshp")]
    with pytest.raises(ValueError, match="runs on the card"):
        ops.ssd_scan_on("vector", *arrays, chunk=64)
