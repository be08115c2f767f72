"""Packed per-primitive attribute rows for gather-light shading.

Hit resolution + shading naively needs ~15 (N,)-indexed gathers from small
tables
(sphere center/radius, rect transform, material type/fuzz/ref_idx, texture
type/colors/scale ...). This module flattens everything a ray needs after
intersection into TWO unified rows per primitive:

- geometry row (P, 16): per-kind layout (sphere centers/motion/radius, rect
  transform/extents), material index at a fixed lane;
- shading row (P, 16): the primitive's material attrs + its texture's attrs,
  with checker child colors baked in.

P = S + R + V rows (spheres, then rects, then media); the winning
primitive's global id is ``idx + kind offset``. Resolution and shading then
cost ONE gather each instead of fifteen.

The packing runs *inside* jit from the live Scene tables, so pytree surgery
(inverse rendering mutating texture colors, sphere radii, ...) flows
through automatically and gradients are preserved.

The packed path covers every reference scene. The one thing it cannot
express is a checker texture whose children are themselves procedural
(noise/image) — the reference never builds one (texture children are
constant_texture everywhere, Scene/scene.h); SceneBuilder sets
``needs_legacy_textures`` for such scenes and materials.shade falls back to
the gather-based texture evaluator.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..models import scene_types as st

# Geometry-row lanes (meaning depends on primitive kind).
G_MAT = 15          # material index, all kinds
# sphere lanes
GS_C0X, GS_C0Y, GS_C0Z = 0, 1, 2
GS_DCX, GS_DCY, GS_DCZ = 3, 4, 5
GS_T0, GS_IDT, GS_RAD = 6, 7, 8
# rect lanes
GR_OFFX, GR_OFFY, GR_OFFZ = 0, 1, 2
GR_COS, GR_SIN, GR_AXIS, GR_FLIP = 3, 4, 5, 6
GR_A0, GR_A1, GR_B0, GR_B1, GR_K = 7, 8, 9, 10, 11

# Shading-row lanes.
S_MTYPE, S_FUZZ, S_RIDX = 0, 1, 2
S_COL = 3           # 3..5 base/albedo/emission color (texture color)
S_TTYPE, S_SCALE, S_NMODE = 6, 7, 8
S_EVEN = 9          # 9..11 checker even color
S_ODD = 12          # 12..14 checker odd color
S_IMG = 15          # image atlas id

LANES = 16


def prim_offsets(scene: st.Scene):
    """(sphere_base, rect_base, media_base) row offsets into the packed
    tables."""
    S = scene.spheres.count()
    R = scene.rects.count()
    return 0, S, S + R


def pack_geometry(scene: st.Scene) -> jnp.ndarray:
    """(P, 16) float32 geometry rows. Runs under jit."""
    sph = scene.spheres
    dt = sph.time1 - sph.time0
    inv_dt = jnp.where(dt != 0, 1.0 / jnp.where(dt != 0, dt, 1.0), 0.0)
    dc = sph.center1 - sph.center0
    S = sph.count()
    g_s = jnp.zeros((S, LANES), jnp.float32)
    g_s = g_s.at[:, GS_C0X].set(sph.center0[:, 0])
    g_s = g_s.at[:, GS_C0Y].set(sph.center0[:, 1])
    g_s = g_s.at[:, GS_C0Z].set(sph.center0[:, 2])
    g_s = g_s.at[:, GS_DCX].set(dc[:, 0])
    g_s = g_s.at[:, GS_DCY].set(dc[:, 1])
    g_s = g_s.at[:, GS_DCZ].set(dc[:, 2])
    g_s = g_s.at[:, GS_T0].set(sph.time0)
    g_s = g_s.at[:, GS_IDT].set(inv_dt)
    g_s = g_s.at[:, GS_RAD].set(sph.radius)
    g_s = g_s.at[:, G_MAT].set(sph.mat.astype(jnp.float32))

    parts = [g_s]
    r = scene.rects
    R = r.count()
    if R:
        g_r = jnp.zeros((R, LANES), jnp.float32)
        g_r = g_r.at[:, GR_OFFX].set(r.offset[:, 0])
        g_r = g_r.at[:, GR_OFFY].set(r.offset[:, 1])
        g_r = g_r.at[:, GR_OFFZ].set(r.offset[:, 2])
        g_r = g_r.at[:, GR_COS].set(r.cos_t)
        g_r = g_r.at[:, GR_SIN].set(r.sin_t)
        g_r = g_r.at[:, GR_AXIS].set(r.axis.astype(jnp.float32))
        g_r = g_r.at[:, GR_FLIP].set(r.flip)
        g_r = g_r.at[:, GR_A0].set(r.a0)
        g_r = g_r.at[:, GR_A1].set(r.a1)
        g_r = g_r.at[:, GR_B0].set(r.b0)
        g_r = g_r.at[:, GR_B1].set(r.b1)
        g_r = g_r.at[:, GR_K].set(r.k)
        g_r = g_r.at[:, G_MAT].set(r.mat.astype(jnp.float32))
        parts.append(g_r)
    m = scene.media
    V = m.count()
    if V:
        g_m = jnp.zeros((V, LANES), jnp.float32)
        g_m = g_m.at[:, G_MAT].set(m.mat.astype(jnp.float32))
        parts.append(g_m)
    return jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


def _material_rows(scene: st.Scene) -> jnp.ndarray:
    """(M, 16) float32: material attrs + flattened texture attrs."""
    mats = scene.materials
    tex = scene.textures
    ti = mats.tex                                  # (M,) texture index
    M = ti.shape[0]
    rows = jnp.zeros((M, LANES), jnp.float32)
    rows = rows.at[:, S_MTYPE].set(mats.mtype.astype(jnp.float32))
    rows = rows.at[:, S_FUZZ].set(mats.fuzz)
    rows = rows.at[:, S_RIDX].set(mats.ref_idx)
    rows = rows.at[:, S_COL:S_COL + 3].set(tex.color[ti])
    rows = rows.at[:, S_TTYPE].set(tex.ttype[ti].astype(jnp.float32))
    rows = rows.at[:, S_SCALE].set(tex.scale[ti])
    rows = rows.at[:, S_NMODE].set(tex.noise_mode[ti].astype(jnp.float32))
    # checker children: bake the child CONSTANT colors (texture.h:35-46; all
    # reference checkers have constant children).
    rows = rows.at[:, S_EVEN:S_EVEN + 3].set(tex.color[tex.even[ti]])
    rows = rows.at[:, S_ODD:S_ODD + 3].set(tex.color[tex.odd[ti]])
    rows = rows.at[:, S_IMG].set(tex.image_id[ti].astype(jnp.float32))
    return rows


def pack_shading(scene: st.Scene) -> jnp.ndarray:
    """(P, 16) float32 shading rows aligned with pack_geometry's layout."""
    mat_rows = _material_rows(scene)               # (M, 16)
    cols = [mat_rows[scene.spheres.mat]]
    if scene.rects.count():
        cols.append(mat_rows[scene.rects.mat])
    if scene.media.count():
        cols.append(mat_rows[scene.media.mat])
    return jnp.concatenate(cols, axis=0) if len(cols) > 1 else cols[0]
