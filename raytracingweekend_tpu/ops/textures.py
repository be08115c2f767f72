"""Wavefront texture evaluation over the type-coded texture table.

Vectorized replacement for the reference's virtual texture::value dispatch
(reference: texture.h:10-98). All rays evaluate all *present* texture types as
masked vector code and select by type code; scene-level static flags compile
out types a scene doesn't use. Checker children are resolved by one extra
masked pass (one level of nesting covers every reference use).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..models import scene_types as st
from . import noise as noise_mod


def _eval_non_checker(ti, u, v, p, scene: st.Scene):
    """Evaluate texture rows `ti` (N,) assuming they are not checkers."""
    tex = scene.textures
    out = tex.color[ti]  # TEX_CONSTANT (texture.h:16-27)

    if scene.has_noise_tex:
        scale = tex.scale[ti]
        mode = tex.noise_mode[ti]
        modes = scene.noise_modes or (st.NOISE_MARBLE, st.NOISE_SMOOTH,
                                      st.NOISE_TURB)
        nval = jnp.zeros(p.shape[:-1], p.dtype)
        if st.NOISE_MARBLE in modes:
            # marble: 0.5*(1+sin(scale*z + 10*turb(p)))  (texture.h:67)
            marble = 0.5 * (1.0 + jnp.sin(scale * p[..., 2]
                                          + 10.0 * noise_mod.turb(p)))
            nval = jnp.where(mode == st.NOISE_MARBLE, marble, nval)
        if st.NOISE_SMOOTH in modes:
            smooth = 0.5 * (1.0 + noise_mod.noise(p * scale[..., None]))
            nval = jnp.where(mode == st.NOISE_SMOOTH, smooth, nval)
        if st.NOISE_TURB in modes:
            turbv = noise_mod.turb(p * scale[..., None])
            nval = jnp.where(mode == st.NOISE_TURB, turbv, nval)
        out = jnp.where((tex.ttype[ti] == st.TEX_NOISE)[..., None],
                        nval[..., None] * jnp.ones((3,), dtype=out.dtype),
                        out)

    if scene.has_image_tex and tex.images is not None:
        img_id = tex.image_id[ti]
        hw = tex.image_hw[img_id]            # (N, 2) actual (ny, nx)
        ny = hw[..., 0]
        nx = hw[..., 1]
        # Nearest-neighbor byte lookup with v flip (texture.h:81-94).
        i = (u * nx).astype(jnp.int32)
        j = ((1.0 - v) * ny - 0.001).astype(jnp.int32)
        i = jnp.clip(i, 0, nx - 1)
        j = jnp.clip(j, 0, ny - 1)
        ival = scene.textures.images[img_id, j, i]           # (N, 3)
        out = jnp.where((tex.ttype[ti] == st.TEX_IMAGE)[..., None], ival, out)

    return out


def eval_texture(ti, u, v, p, scene: st.Scene):
    """texture::value(u, v, p) for per-ray texture indices ti (N,) -> (N, 3)."""
    val = _eval_non_checker(ti, u, v, p, scene)
    if scene.has_checker_tex:
        tex = scene.textures
        # sign of sin(10x)sin(10y)sin(10z) picks the child (texture.h:35-46)
        sines = (jnp.sin(10.0 * p[..., 0]) * jnp.sin(10.0 * p[..., 1])
                 * jnp.sin(10.0 * p[..., 2]))
        child = jnp.where(sines < 0, tex.odd[ti], tex.even[ti])
        cval = _eval_non_checker(child, u, v, p, scene)
        val = jnp.where((tex.ttype[ti] == st.TEX_CHECKER)[..., None], cval, val)
    return val
