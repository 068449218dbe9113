"""The port's flash attention against the reference package's.

On the CPU the port's wrapper takes its plain version (``repro_torch.
kernels.flash_attention.ref``); these tests hold it, through the
wrapper, against the reference's Pallas kernel (interpret mode on the
CPU) on every case of the reference's own kernel tests, at their
tolerances: 2e-5 in f32, 2e-2 in bf16 (the plain version casts the
softmax weights to bf16 before the product with v, as the reference's
oracle does; the Pallas kernel keeps them in f32).

The CUDA kernel itself runs only on the card, held against the plain
version by ``tests/test_torch_cuda_kernels.py`` (``gpu`` marker).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as pallas_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.obs.metrics import REGISTRY

from test_torch_cases import qkv
from test_torch_cases import one_thread  # noqa: F401

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(arrays, dtype, window=None, **blocks):
    """The reference pads S to its block multiple (``blocks``); the port
    attends over the S keys alone, which is the same causal function."""
    jx = [jnp.asarray(a, _JNP[dtype]) for a in arrays]
    tx = [torch.tensor(a).to(_TORCH[dtype]) for a in arrays]
    want = np.asarray(pallas_flash(*jx, causal=True, window=window,
                                   **blocks), np.float32)
    got = ops.flash_attention(*tx, causal=True, window=window)
    assert got.dtype == _TORCH[dtype]
    return got.float().numpy(), want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "b,s,h,kv,d,block",
    [
        (1, 128, 2, 2, 32, 64),   # MHA
        (2, 256, 4, 2, 64, 128),  # GQA 2:1
        (1, 192, 6, 2, 16, 64),   # seq not a multiple of the block (pad path)
        (1, 128, 8, 1, 32, 64),   # MQA
    ],
)
def test_flash_matches_reference_sweep(dtype, b, s, h, kv, d, block):
    got, want = _both(qkv(0, b, s, h, kv, d), dtype, block_q=block,
                      block_k=block)
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("window", [32, 64, 200])
def test_flash_matches_reference_window(window):
    got, want = _both(qkv(1, 1, 256, 2, 2, 32), "float32", window=window,
                      block_q=64, block_k=64)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_cpu_calls_do_not_count_and_other_devices_raise():
    q, k, v = (torch.tensor(a) for a in qkv(2, 1, 32, 2, 2, 16))
    n0 = REGISTRY.counter("kernels.flash_attention.launches").value
    ops.flash_attention(q, k, v)
    assert REGISTRY.counter("kernels.flash_attention.launches").value == n0
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError):
        ops.flash_attention(*meta)


@pytest.mark.parametrize(
    "dtype,d,kernel",
    [(torch.bfloat16, d, "wgmma") for d in (16, 64, 112, 128, 192)]
    + [(torch.float32, d, "vector") for d in (16, 64, 112, 128, 192)]
    + [(torch.bfloat16, d, "vector") for d in (8, 24, 100, 136)],
)
def test_kernel_for_routes_by_dtype_and_head_dim(dtype, d, kernel):
    """bf16 with D a multiple of 16 up to 192 takes the tensor-core
    kernel; f32 and every other bf16 D the vector-unit kernel."""
    assert ops.kernel_for(dtype, d) == kernel


def test_every_arch_head_dim_takes_the_tensor_core_kernel_in_bf16():
    from repro_torch.configs import archs

    dims = {a.head_dim for a in archs.ARCHS.values() if a.head_dim}
    assert {64, 112, 128, 192} <= dims
    assert {ops.kernel_for(torch.bfloat16, d) for d in dims} == {"wgmma"}


def test_wgmma_header_matches_its_generator():
    import importlib.util

    csrc = ops.LIBRARY.source.parent
    spec = importlib.util.spec_from_file_location(
        "gen_wgmma", csrc / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert (csrc / "wgmma_ops.cuh").read_text() == gen.render()
    assert set(gen.RS_WIDTHS) == set(range(16, ops.MAX_HEAD_DIM + 1, 16))


def test_naming_a_kernel_needs_card_tensors():
    q, k, v = (torch.tensor(a) for a in qkv(4, 1, 16, 2, 2, 16))
    with pytest.raises(ValueError):
        ops.flash_attention_on("vector", q, k, v)
    with pytest.raises(ValueError):
        ops.flash_attention_on("wgmma", q, k, v)
