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
