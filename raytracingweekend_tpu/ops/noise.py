"""Vectorized Perlin noise with deterministic lookup tables.

Vectorized rebuild of the reference's lazily-initialized static-table Perlin
implementation (reference: RayTracingWeekend/noise.h, noise.cpp). The 256-entry
tables are generated eagerly and deterministically with the same LCG family the
reference uses (std::minstd_rand, default seed 1 — noise.h:166-213), so the
textures are reproducible run-to-run without global mutable state. Evaluation
is fully batched: each of the 8 lattice corners is a static unrolled gather,
so a million-ray wavefront evaluates noise as 8 vector gathers + fused math.

Both interpolation modes of the reference enum (noise.h:100-150) and both
smoothstep variants (noise.h:9-20) are exposed; defaults match the active
reference configuration (PERLIN interpolation, Hermite-cubic smoothstep).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..utils.detrng import minstd_stream as _minstd_stream

__all__ = ["noise", "turb", "NOISE_TABLES"]

_SIZE = 256


def _make_tables():
    # ranfloat: 256 uniforms (noise.h:189-198)
    ranfloat = _minstd_stream(_SIZE)
    # ranvec: 256 normalized vectors from the [-1,1]^3 cube (noise.h:200-213).
    # g++ evaluates the vec3 constructor's three uniform(engine) arguments
    # RIGHT TO LEFT, so per vector the first draw is z — hence the [::-1].
    u = _minstd_stream(3 * _SIZE).reshape(_SIZE, 3)
    ranvec = -1.0 + 2.0 * u[:, ::-1]
    ranvec /= np.linalg.norm(ranvec, axis=-1, keepdims=True)
    # permutations: identity shuffled by Fisher-Yates (noise.h:166-187).
    # The reference constructs a FRESH default-seeded engine inside permute()
    # for each call, so perm_x == perm_y == perm_z — a quirk we replicate
    # verbatim for pixel parity with the oracle (the XOR hash at noise.h:137
    # still varies through its i/j/k arguments).
    p = np.arange(_SIZE, dtype=np.int64)
    stream = _minstd_stream(_SIZE)
    si = 0
    for i in range(_SIZE - 1, 0, -1):
        target = int(stream[si] * (i + 1))
        si += 1
        p[i], p[target] = p[target], p[i]
    perm = p.astype(np.int32)
    return (
        jnp.asarray(ranfloat, dtype=jnp.float32),
        jnp.asarray(ranvec, dtype=jnp.float32),
        jnp.asarray(perm),
        jnp.asarray(perm),
        jnp.asarray(perm),
    )


NOISE_TABLES = _make_tables()


def _smooth(x, smoother: bool):
    if smoother:
        # Perlin quintic smootherstep (noise.h:14-17, inactive variant)
        return x * x * x * (x * (x * 6.0 - 15.0) + 10.0)
    # Hermite cubic (noise.h:9-12, the active #define at noise.h:19)
    return x * x * (3.0 - 2.0 * x)


# Corner offsets (8, 1): unrolled as one batched axis so the whole lattice
# lookup is FOUR gathers (3 perm tables + 1 value table) instead of 32.
_DI = jnp.array([0, 0, 0, 0, 1, 1, 1, 1], jnp.int32)[:, None]
_DJ = jnp.array([0, 0, 1, 1, 0, 0, 1, 1], jnp.int32)[:, None]
_DK = jnp.array([0, 1, 0, 1, 0, 1, 0, 1], jnp.int32)[:, None]


def noise(p, mode: str = "perlin", smoother: bool = False):
    """Perlin noise in [-1, 1] for points p of shape (..., 3) (noise.h:89-151).

    mode: "perlin" (gradient-vector interpolation, the active reference mode),
    "trilinear" (scalar-table interpolation), or "none" (raw hash lookup).
    """
    ranfloat, ranvec, perm_x, perm_y, perm_z = NOISE_TABLES

    if mode == "none":
        i = (4.0 * p[..., 0]).astype(jnp.int32) & 255
        j = (4.0 * p[..., 1]).astype(jnp.int32) & 255
        k = (4.0 * p[..., 2]).astype(jnp.int32) & 255
        idx = perm_x[i] ^ perm_y[j] ^ perm_z[k]
        return ranfloat[idx]

    shape = p.shape[:-1]
    flat = p.reshape(-1, 3)
    pf = jnp.floor(flat)
    u = flat[:, 0] - pf[:, 0]
    v = flat[:, 1] - pf[:, 1]
    w = flat[:, 2] - pf[:, 2]
    i = pf[:, 0].astype(jnp.int32)
    j = pf[:, 1].astype(jnp.int32)
    k = pf[:, 2].astype(jnp.int32)

    uu = _smooth(u, smoother)[None]           # (1, N)
    vv = _smooth(v, smoother)[None]
    ww = _smooth(w, smoother)[None]

    idx = (perm_x[(i[None] + _DI) & 255]
           ^ perm_y[(j[None] + _DJ) & 255]
           ^ perm_z[(k[None] + _DK) & 255])            # (8, N)
    di = _DI.astype(p.dtype)
    dj = _DJ.astype(p.dtype)
    dk = _DK.astype(p.dtype)
    wgt = ((di * uu + (1 - di) * (1.0 - uu))
           * (dj * vv + (1 - dj) * (1.0 - vv))
           * (dk * ww + (1 - dk) * (1.0 - ww)))  # (8, N)
    if mode == "trilinear":
        accum = jnp.sum(wgt * ranfloat[idx], axis=0)
    else:  # perlin: dot(gradient, corner-relative offset)
        g = ranvec[idx]                         # (8, N, 3)
        rel = jnp.stack([u[None] - di, v[None] - dj, w[None] - dk], axis=-1)
        accum = jnp.sum(wgt * jnp.sum(g * rel, axis=-1), axis=0)
    return accum.reshape(shape)


def turb(p, depth: int = 7, mode: str = "perlin", smoother: bool = False):
    """7-octave |fBm| turbulence (noise.h:74-86): abs of the weighted sum.

    All octaves evaluate in ONE widened noise() call (points stacked along a
    new axis), so a full turbulence costs the same 4 gather ops as a single
    noise tap."""
    scales = (2.0 ** jnp.arange(depth, dtype=p.dtype)).reshape(
        (depth,) + (1,) * p.ndim)
    pts = p[None] * scales                      # (depth, ..., 3)
    vals = noise(pts, mode=mode, smoother=smoother)   # (depth, ...)
    weights = (0.5 ** jnp.arange(depth, dtype=p.dtype)).reshape(
        (depth,) + (1,) * (p.ndim - 1))
    return jnp.abs(jnp.sum(weights * vals, axis=0))
