"""Seeded numpy inputs shared by the port's kernel tests: the CPU tests
that hold the plain versions against the reference, and the ``gpu`` tests
that hold the CUDA kernels against the plain versions (which import no
jax, so they run on a card's machine without it)."""

from __future__ import annotations

import numpy as np


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
