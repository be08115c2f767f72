"""Wavefront PDFs for one-sample MIS (reference: pdf.h, and the pdf_value /
random hooks at hittable.h:208-228, sphere.h:88-108, hittable_list.h:44-59).

The reference builds a shared_ptr pdf object graph per shading point
(mixture_pdf(cosine_pdf, hittable_pdf(lights))); here the lights list is a
small static table and every operation is batched over the whole wavefront:
`lights_pdf_value` averages the per-shape solid-angle PDFs (each of which
re-intersects its shape, exactly like the probe rays at hittable.h:214 /
sphere.h:92), and `lights_sample` picks a uniform light and samples it.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..models import scene_types as st
from . import linalg, sampling

_EPS_T = 0.001  # probe-ray lower bound (hittable.h:214, sphere.h:92)


def cosine_pdf_value(normal, direction):
    """cosine_pdf::value (pdf.h:20-24): cos(theta)/pi clamped at 0.
    `direction` need not be normalized."""
    cosine = linalg.dot(linalg.normalize(direction), linalg.normalize(normal))
    return jnp.where(cosine <= 0, 0.0, cosine / math.pi)


def cosine_pdf_sample(key, normal):
    """cosine_pdf::generate (pdf.h:26-29): cosine direction in the normal's
    ONB frame."""
    u, v, w = linalg.onb_from_w(normal)
    a = sampling.random_cosine_direction(key, normal.shape[:-1])
    return linalg.onb_local(u, v, w, a)


def _gather_light_rects(scene: st.Scene):
    """Rows of the rect table referenced by rect lights, padded-safe."""
    li = scene.lights.index
    is_rect = scene.lights.kind == st.LIGHT_RECT
    ri = jnp.where(is_rect, li, 0)
    r = scene.rects
    return is_rect, ri, r


def _rect_light_pdf(o, v, scene: st.Scene):
    """xz_rect::pdf_value (hittable.h:208-222) generalized to any axis code
    and baked transform. Returns (N, L)."""
    lights = scene.lights
    r = scene.rects
    L = lights.kind.shape[0]
    ri = jnp.where(lights.kind == st.LIGHT_RECT, lights.index, 0)  # (L,)

    # Move probe ray into each light rect's object space (component-wise —
    # no (N, L, 3) stacks, no gathers; see geometry._select_axis).
    from .geometry import _select_axis, plane_t

    off = r.offset[ri]            # (L, 3)
    c, s = r.cos_t[ri][None], r.sin_t[ri][None]
    shx = o[:, 0:1] - off[None, :, 0]                      # (N, L)
    shy = o[:, 1:2] - off[None, :, 1]
    shz = o[:, 2:3] - off[None, :, 2]
    ox = c * shx - s * shz
    oz = s * shx + c * shz
    dx = c * v[:, 0:1] - s * v[:, 2:3]
    dy = v[:, 1:2] * jnp.ones_like(dx)
    dz = s * v[:, 0:1] + c * v[:, 2:3]

    axis = r.axis[ri][None]                                # (1, L)
    o_a, o_b, o_n = _select_axis(axis, ox, shy, oz)
    d_a, d_b, d_n = _select_axis(axis, dx, dy, dz)
    t = plane_t(r.k[ri][None], o_n, d_n)
    pa = o_a + t * d_a
    pb = o_b + t * d_b
    hit = ((t > _EPS_T)
           & (pa >= r.a0[ri][None]) & (pa <= r.a1[ri][None])
           & (pb >= r.b0[ri][None]) & (pb <= r.b1[ri][None]))

    area = ((r.a1[ri] - r.a0[ri]) * (r.b1[ri] - r.b0[ri]))[None]
    v_len2 = linalg.length_squared(v)[:, None]
    # Missed probes are masked out below; the double-wheres keep their
    # (discarded) t, cosine and quotient finite in both autodiff passes,
    # or a masked cotangent becomes 0 * inf = NaN.
    t = jnp.where(hit, t, 0.0)
    dist2 = t * t * v_len2
    # cosine against the object-space normal; |dot| is rotation-invariant
    # so the transform does not change it (hittable.h:219). Hit probes have
    # d_n != 0, hence v_len2 > 0.
    cosine = jnp.abs(d_n) / jnp.sqrt(jnp.where(hit, v_len2, 1.0))
    denom = jnp.where(hit, jnp.maximum(cosine * area, 1e-20), 1.0)
    return jnp.where(hit, dist2 / denom, 0.0)


def _sphere_light_pdf(o, v, scene: st.Scene):
    """sphere::pdf_value (sphere.h:88-99): 1/solid-angle of the subtended
    cone, gated on the probe ray actually hitting. Returns (N, L)."""
    lights = scene.lights
    sph = scene.spheres
    si = jnp.where(lights.kind == st.LIGHT_SPHERE, lights.index, 0)  # (L,)
    c = sph.center0[si]            # (L, 3) — pdf uses the static center
    rad = sph.radius[si]           # (L,)

    oc = o[:, None, :] - c[None]                           # (N, L, 3)
    a = linalg.dot(v, v)[:, None]
    b = jnp.sum(oc * v[:, None, :], axis=-1)
    cc = jnp.sum(oc * oc, axis=-1) - (rad * rad)[None]
    disc = b * b - a * cc
    sq = linalg.safe_sqrt(disc)
    t_near = (-b - sq) / a
    t_far = (-b + sq) / a
    t = jnp.where(t_near > _EPS_T, t_near, t_far)
    hit = (disc > 0) & (t > _EPS_T)

    dist2 = jnp.sum(oc * oc, axis=-1)
    # Rows that are not sphere lights (rect lights read sphere row 0) and
    # probes from the centre itself are masked out; the double-where keeps
    # their r^2/dist2 finite so the masked cotangents stay 0, not 0*inf.
    valid = (lights.kind == st.LIGHT_SPHERE)[None] & (dist2 > 0)
    ctm = linalg.safe_sqrt(1.0 - (rad * rad)[None]
                           / jnp.where(valid, dist2, 1.0))
    solid_angle = 2.0 * math.pi * (1.0 - ctm)
    pdf = 1.0 / jnp.maximum(solid_angle, 1e-20)
    return jnp.where(hit & valid, pdf, 0.0)


def lights_pdf_value(o, v, scene: st.Scene):
    """hittable_list::pdf_value over the lights list (hittable_list.h:44-53):
    uniform average of per-light PDFs. o, v: (N, 3) -> (N,)."""
    lights = scene.lights
    if lights.num == 0:
        return jnp.zeros(o.shape[:-1], o.dtype)
    L = lights.kind.shape[0]
    N = o.shape[0]
    # Rect/sphere tables can be empty (0 rows); a kind with no table rows
    # cannot appear in the lights list, so those branches compile away.
    rect_pdf = (_rect_light_pdf(o, v, scene) if scene.rects.count()
                else jnp.zeros((N, L), o.dtype))
    sph_pdf = (_sphere_light_pdf(o, v, scene) if scene.spheres.count()
               else jnp.zeros((N, L), o.dtype))
    per_light = jnp.where((lights.kind == st.LIGHT_RECT)[None], rect_pdf,
                          sph_pdf)
    live = jnp.arange(lights.kind.shape[0]) < lights.num
    return jnp.sum(jnp.where(live[None], per_light, 0.0), axis=-1) / lights.num


# Packed light-row lanes (see _light_rows).
(_L_KIND, _L_A0, _L_A1, _L_B0, _L_B1, _L_K, _L_AXIS, _L_COS, _L_SIN,
 _L_OFFX, _L_OFFY, _L_OFFZ, _L_CX, _L_CY, _L_CZ, _L_RAD) = range(16)


def _light_rows(scene: st.Scene):
    """(L, 16) float32 rows holding each light's sampling attributes (rect
    extents/transform or sphere center/radius), so per-ray light sampling
    needs ONE row lookup instead of ~12 per-ray table gathers."""
    lights = scene.lights
    L = lights.kind.shape[0]
    rows = jnp.zeros((L, 16), jnp.float32)
    rows = rows.at[:, _L_KIND].set(lights.kind.astype(jnp.float32))
    if scene.rects.count():
        r = scene.rects
        ri = jnp.where(lights.kind == st.LIGHT_RECT, lights.index, 0)
        rows = rows.at[:, _L_A0].set(r.a0[ri])
        rows = rows.at[:, _L_A1].set(r.a1[ri])
        rows = rows.at[:, _L_B0].set(r.b0[ri])
        rows = rows.at[:, _L_B1].set(r.b1[ri])
        rows = rows.at[:, _L_K].set(r.k[ri])
        rows = rows.at[:, _L_AXIS].set(r.axis[ri].astype(jnp.float32))
        rows = rows.at[:, _L_COS].set(r.cos_t[ri])
        rows = rows.at[:, _L_SIN].set(r.sin_t[ri])
        rows = rows.at[:, _L_OFFX:_L_OFFZ + 1].set(r.offset[ri])
    if scene.spheres.count():
        sph = scene.spheres
        si = jnp.where(lights.kind == st.LIGHT_SPHERE, lights.index, 0)
        rows = rows.at[:, _L_CX:_L_CZ + 1].set(sph.center0[si])
        rows = rows.at[:, _L_RAD].set(sph.radius[si])
    return rows


def lights_sample(key, o, scene: st.Scene):
    """hittable_list::random over the lights list (hittable_list.h:55-59):
    pick a uniform light, then sample its direction-generating rule.
    Returns (N, 3) — unnormalized for rect lights (hittable.h:224-228),
    unit-cone directions for sphere lights (sphere.h:101-108)."""
    lights = scene.lights
    N = o.shape[0]
    k_pick, k_rect, k_sph = jax.random.split(key, 3)
    pick = sampling.random_int(k_pick, (N,), 0, lights.num - 1)
    row = _light_rows(scene)[pick]                          # (N, 16)
    kind = row[:, _L_KIND]

    # Rect sample: uniform point on the rect, mapped through its transform.
    ka, kb = jax.random.split(k_rect)
    ua = sampling.uniform(ka, (N,))
    ub = sampling.uniform(kb, (N,))
    pa = row[:, _L_A0] + ua * (row[:, _L_A1] - row[:, _L_A0])
    pb = row[:, _L_B0] + ub * (row[:, _L_B1] - row[:, _L_B0])
    kk = row[:, _L_K]
    axis = row[:, _L_AXIS]
    # object-space point by axis code
    px = jnp.where(axis == st.RECT_YZ, kk, pa)
    py = jnp.where(axis == st.RECT_XY, pb,
                   jnp.where(axis == st.RECT_XZ, kk, pa))
    pz = jnp.where(axis == st.RECT_XY, kk, pb)
    # rotate object->world (inverse of the ray transform) and translate
    c, s = row[:, _L_COS], row[:, _L_SIN]
    wx = c * px + s * pz
    wz = -s * px + c * pz
    point = (jnp.stack([wx, py, wz], axis=-1)
             + row[:, _L_OFFX:_L_OFFZ + 1])
    rect_dir = point - o

    # Sphere sample: cone toward the sphere (sphere.h:101-108).
    to_c = row[:, _L_CX:_L_CZ + 1] - o
    dist2 = linalg.length_squared(to_c)
    # padded/non-sphere rows have center 0 / radius 0; mask keeps them out
    safe = dist2 > 0
    dist2 = jnp.where(safe, dist2, 1.0)
    u, v, w = linalg.onb_from_w(jnp.where(safe[:, None], to_c,
                                          jnp.array([1.0, 0.0, 0.0])))
    local = sampling.random_to_sphere(k_sph, row[:, _L_RAD], dist2)
    sph_dir = linalg.onb_local(u, v, w, local)

    return jnp.where((kind == st.LIGHT_RECT)[:, None], rect_dir, sph_dir)


def mixture_sample_and_value(key, p, normal, scene: st.Scene):
    """The integrator's sampling step (RayTracingWeekend.cpp:117-124):
    p_mix = mixture(cosine_pdf(normal), hittable_pdf(lights, p)); draw one
    direction from the mixture and evaluate the mixture PDF at it.

    Returns (direction (N,3), pdf_val (N,)). With no lights registered the
    mixture degenerates to the pure material pdf (cpp:117-121 guard).
    """
    k_coin, k_cos, k_light = jax.random.split(key, 3)
    dir_cos = cosine_pdf_sample(k_cos, normal)
    if scene.lights.num == 0:
        return dir_cos, cosine_pdf_value(normal, dir_cos)
    coin = sampling.uniform(k_coin, p.shape[:-1]) < 0.5  # pdf.h:69-75
    dir_light = lights_sample(k_light, p, scene)
    direction = jnp.where(coin[:, None], dir_cos, dir_light)
    pdf_val = (0.5 * cosine_pdf_value(normal, direction)
               + 0.5 * lights_pdf_value(p, direction, scene))  # pdf.h:64-67
    return direction, pdf_val
