"""Wavefront closest-hit intersection over flat SoA primitive tables.

Replaces the reference's virtual-dispatch linear scan
(reference: hittable_list.h:11-37 and the per-class hit() methods in
sphere.h:46-81, hittable.h:149-267,299-404,430-479). Instead of one ray
chasing pointers through an object graph, a whole wavefront of N rays is
intersected against each primitive table at once:

- spheres: a lax.scan over fixed-size sphere blocks with a running
  (best_t, best_idx) carry, so peak memory is O(N x block) regardless of
  scene size and the quadratic-setup arithmetic fuses into the min/argmin
  reduction of each block;
- rects: a dense (N x R) test with the translate/rotate_y instancing baked
  into per-rect ray transforms (the reference's move-the-ray trick,
  hittable.h:294, vectorized);
- constant media: analytic convex entry/exit plus the stochastic scatter
  distance of hittable.h:463-474, expressed order-independently (see
  `hit_media`) so the result no longer depends on scan order like the
  reference's closest-so-far recursion did.

The reference's duplicated scan loop (hittable_list.h:16-34, 2x cost for the
same answer) and broken bvh_node (hittable.h:45-129, never instantiated) are
deliberately not reproduced.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp

from ..models import scene_types as st
from . import linalg, packing, sampling
from ..utils.pytree import pytree_dataclass


# Large finite sentinel: plays the role of std::numeric_limits<double>::max()
# at RayTracingWeekend.cpp:52 while staying float32-safe in arithmetic.
BIG = jnp.float32(3.0e37)

T_MIN = 0.001  # hit interval lower bound (RayTracingWeekend.cpp:52)

KIND_NONE = -1
KIND_SPHERE = 0
KIND_RECT = 1
KIND_MEDIUM = 2


@pytree_dataclass
class Hit:
    """Wavefront hit_record (hittable.h:16-29), SoA over N rays.

    `sattr` is the packed material+texture attribute row of the winning
    primitive (ops/packing.py) — prefetched here so shading needs no
    further table gathers. None when produced by paths that bypass packing.
    """
    hit: jnp.ndarray      # (N,) bool
    t: jnp.ndarray        # (N,)
    p: jnp.ndarray        # (N, 3)
    normal: jnp.ndarray   # (N, 3)
    u: jnp.ndarray        # (N,)
    v: jnp.ndarray        # (N,)
    mat: jnp.ndarray      # (N,) int32
    sattr: jnp.ndarray | None = None  # (N, 16) packed shading row


def _moving_center(spheres: st.Spheres, time, idx=None):
    """Sphere center at ray time (sphere.h:48 via movement_linear at
    sphere.h:22-25). `time` broadcasts against the selected sphere rows."""
    if idx is None:
        c0, c1 = spheres.center0, spheres.center1
        t0, t1 = spheres.time0, spheres.time1
    else:
        c0, c1 = spheres.center0[idx], spheres.center1[idx]
        t0, t1 = spheres.time0[idx], spheres.time1[idx]
    fac = (time - t0) / (t1 - t0)
    return c0 + fac[..., None] * (c1 - c0)


def _sphere_candidate_t(o, d, time, t_min, spheres: st.Spheres, moving: bool):
    """Per-(ray, sphere) candidate hit t, or BIG. (N, S).

    Implements the near-root-else-far-root rule of sphere.h:46-81,
    component-wise so no (N, S, 3) intermediate ever exists — everything is
    (N, S) elementwise work XLA fuses into the caller's min/argmin. The
    closest-so-far upper bound is applied by the caller's global min, which
    is equivalent because far > near always.
    """
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]            # (N, 1)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    cx = spheres.center0[None, :, 0]                        # (1, S)
    cy = spheres.center0[None, :, 1]
    cz = spheres.center0[None, :, 2]
    if moving:
        dc = spheres.center1 - spheres.center0
        dt = spheres.time1 - spheres.time0
        inv_dt = jnp.where(dt != 0, 1.0 / jnp.where(dt != 0, dt, 1.0), 0.0)
        frac = (time[:, None] - spheres.time0[None, :]) * inv_dt[None, :]
        cx = cx + frac * dc[None, :, 0]                     # (N, S)
        cy = cy + frac * dc[None, :, 1]
        cz = cz + frac * dc[None, :, 2]
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    a = dx * dx + dy * dy + dz * dz                         # (N, 1)
    b = ocx * dx + ocy * dy + ocz * dz                      # (N, S)
    cc = (ocx * ocx + ocy * ocy + ocz * ocz
          - (spheres.radius ** 2)[None, :])
    disc = b * b - a * cc
    sq = linalg.safe_sqrt(disc)
    inv_a = 1.0 / a
    t_near = (-b - sq) * inv_a
    t_far = (-b + sq) * inv_a
    t_cand = jnp.where(t_near > t_min, t_near, t_far)
    valid = (disc > 0) & (t_cand > t_min) & spheres.active[None, :]
    return jnp.where(valid, t_cand, BIG)


def _hit_spheres_xla(o, d, time, t_min, spheres: st.Spheres, moving: bool,
                     block: int = 256):
    """Closest sphere hit over 256-sphere blocks (see module docstring)."""
    S = spheres.count()
    N = o.shape[0]
    if S <= block:
        t_cand = _sphere_candidate_t(o, d, time, t_min, spheres, moving)
        best_t = jnp.min(t_cand, axis=-1)
        best_idx = jnp.argmin(t_cand, axis=-1).astype(jnp.int32)
        return best_t, best_idx

    assert S % block == 0, "builder pads sphere table to a block multiple"
    nblk = S // block

    def reshape(x):
        return x.reshape((nblk, block) + x.shape[1:])

    xs = st.Spheres(
        center0=reshape(spheres.center0), center1=reshape(spheres.center1),
        time0=reshape(spheres.time0), time1=reshape(spheres.time1),
        radius=reshape(spheres.radius), mat=reshape(spheres.mat),
        active=reshape(spheres.active))

    def body(carry, blk):
        best_t, best_i = carry
        sph_blk, base = blk
        t_cand = _sphere_candidate_t(o, d, time, t_min, sph_blk, moving)
        bt = jnp.min(t_cand, axis=-1)
        bi = jnp.argmin(t_cand, axis=-1).astype(jnp.int32)
        better = bt < best_t
        return (jnp.where(better, bt, best_t),
                jnp.where(better, base + bi, best_i)), None

    init = (jnp.full((N,), BIG), jnp.full((N,), -1, jnp.int32))
    bases = jnp.arange(nblk, dtype=jnp.int32) * block
    (best_t, best_i), _ = jax.lax.scan(body, init, (xs, bases))
    return best_t, best_i


def hit_spheres(o, d, time, t_min, spheres: st.Spheres, moving: bool,
                block: int = 256):
    """Closest sphere hit: (best_t (N,), best_idx (N,) int32).

    Misses return best_t = BIG (callers test ``best_t < BIG``).
    """
    N = o.shape[0]
    S = spheres.count()
    if S == 0:
        return jnp.full((N,), BIG), jnp.full((N,), -1, jnp.int32)
    return _hit_spheres_xla(o, d, time, t_min, spheres, moving, block)


def _rect_object_space_components(o, d, rects: st.Rects, transforms: bool):
    """Ray components in every rect's object space: translate by -offset
    (hittable.h:299-301) then rotate by the rotate_y frame
    (hittable.h:373-382). Returns 6 (N, R) component arrays — never an
    (N, R, 3) stack, so everything stays fusible elementwise work."""
    ox_w, oy, oz_w = o[:, 0:1], o[:, 1:2], o[:, 2:3]        # (N, 1)
    dx_w, dy, dz_w = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    if not transforms:
        return ox_w, oy, oz_w, dx_w, dy, dz_w               # broadcastable
    offx = rects.offset[None, :, 0]
    offy = rects.offset[None, :, 1]
    offz = rects.offset[None, :, 2]
    c, s = rects.cos_t[None, :], rects.sin_t[None, :]
    shx = ox_w - offx
    shz = oz_w - offz
    ox = c * shx - s * shz
    oz = s * shx + c * shz
    dx = c * dx_w - s * dz_w
    dz = s * dx_w + c * dz_w
    return ox, oy - offy, oz, dx, dy * jnp.ones_like(dx), dz


def _select_axis(axis, x, y, z):
    """Per-rect (a, b, n) component selection from the axis code without
    gathers: xy -> (x,y,z), xz -> (x,z,y), yz -> (y,z,x)
    (hittable.h:142-267). axis broadcasts as (1, R) against (N, R) comps."""
    a = jnp.where(axis == st.RECT_YZ, y, x)
    b = jnp.where(axis == st.RECT_XY, y, z)
    n = jnp.where(axis == st.RECT_XY, z, jnp.where(axis == st.RECT_XZ, y, x))
    return a, b, n


def plane_t(k, o_n, d_n):
    """Ray parameter where o_n + t*d_n == k; -1 (behind every t_min) for
    rays parallel to the plane. The double-where keeps both autodiff passes
    finite: a bare (k - o_n) / d_n puts 0/0 into the cotangents of lanes
    that the caller masks out."""
    nz = d_n != 0
    return jnp.where(nz, (k - o_n) / jnp.where(nz, d_n, 1.0), -1.0)


def hit_rects(o, d, t_min, rects: st.Rects, transforms: bool):
    """Closest axis-rect hit: (best_t (N,), best_idx (N,) int32).

    R is small in every reference scene (<= 16), so a dense (N x R) test is
    the simplest formulation.
    """
    N = o.shape[0]
    R = rects.count()
    if R == 0:
        return jnp.full((N,), BIG), jnp.full((N,), -1, jnp.int32)
    ox, oy, oz, dx, dy, dz = _rect_object_space_components(
        o, d, rects, transforms)
    axis = rects.axis[None, :]
    o_a, o_b, o_n = _select_axis(axis, ox, oy, oz)
    d_a, d_b, d_n = _select_axis(axis, dx, dy, dz)
    t = plane_t(rects.k[None, :], o_n, d_n)                 # (N, R)
    pa = o_a + t * d_a
    pb = o_b + t * d_b
    valid = (
        (t > t_min)
        & (pa >= rects.a0[None, :]) & (pa <= rects.a1[None, :])
        & (pb >= rects.b0[None, :]) & (pb <= rects.b1[None, :])
        & rects.active[None, :]
    )
    t_cand = jnp.where(valid, t, BIG)
    best_t = jnp.min(t_cand, axis=-1)
    best_idx = jnp.argmin(t_cand, axis=-1).astype(jnp.int32)
    return best_t, best_idx


def _medium_object_space_ray(o, d, media: st.Media):
    osh = o[:, None, :] - media.offset[None, :, :]
    c, s = media.cos_t[None, :], media.sin_t[None, :]
    ox = c * osh[..., 0] - s * osh[..., 2]
    oz = s * osh[..., 0] + c * osh[..., 2]
    dx = c * d[:, None, 0] - s * d[:, None, 2]
    dz = s * d[:, None, 0] + c * d[:, None, 2]
    o_rot = jnp.stack([ox, osh[..., 1], oz], axis=-1)
    d_rot = jnp.stack([dx, jnp.broadcast_to(d[:, None, 1], dx.shape), dz],
                      axis=-1)
    return o_rot, d_rot


def _boundary_entry_exit(o_rot, d_rot, media: st.Media):
    """Entry/exit params of each convex boundary over (-inf, inf), matching
    the two-pass boundary probing at hittable.h:438-449. Returns
    (entry (N,V), exit (N,V), hit (N,V))."""
    # Sphere boundary: quadratic roots.
    oc = o_rot - media.p0[None, :, :]
    a = jnp.sum(d_rot * d_rot, axis=-1)
    b = jnp.sum(oc * d_rot, axis=-1)
    r = media.p1[None, :, 0]
    cc = jnp.sum(oc * oc, axis=-1) - r * r
    disc = b * b - a * cc
    sq = linalg.safe_sqrt(disc)
    s_entry = (-b - sq) / a
    s_exit = (-b + sq) / a
    s_hit = disc > 0
    # Box boundary: slab method (aabb.h:17-47 generalized to signed range).
    inv = 1.0 / d_rot
    tt0 = (media.p0[None, :, :] - o_rot) * inv
    tt1 = (media.p1[None, :, :] - o_rot) * inv
    tlo = jnp.max(jnp.minimum(tt0, tt1), axis=-1)
    thi = jnp.min(jnp.maximum(tt0, tt1), axis=-1)
    b_hit = thi > tlo
    is_sphere = (media.kind[None, :] == st.MEDIUM_SPHERE)
    entry = jnp.where(is_sphere, s_entry, tlo)
    exit_ = jnp.where(is_sphere, s_exit, thi)
    hit = jnp.where(is_sphere, s_hit, b_hit)
    return entry, exit_, hit


def hit_media(key, o, d, t_min, media: st.Media):
    """Stochastic constant-medium candidate hit (hittable.h:430-479).

    The scatter point lies at entry + (-1/rho)*ln(U)/|d| along the ray and is
    valid only if it falls before the boundary exit; competition with other
    geometry happens through the caller's global min, which is exactly
    equivalent to the reference's closest-so-far clamping of rec2.t (see
    SURVEY.md §2.1 #10) but independent of primitive order.
    """
    N = o.shape[0]
    V = media.count()
    if V == 0:
        return jnp.full((N,), BIG), jnp.full((N,), -1, jnp.int32)
    o_rot, d_rot = _medium_object_space_ray(o, d, media)
    entry, exit_, bhit = _boundary_entry_exit(o_rot, d_rot, media)
    entry = jnp.maximum(entry, t_min)   # rec1.t clamps (hittable.h:452-461)
    dlen = jnp.sqrt(jnp.sum(d * d, axis=-1))[:, None]       # (N, 1)
    u = sampling.uniform(key, (N, V))
    # Guard log(0); uniform() is in [0,1).
    hit_distance = -(1.0 / media.density[None, :]) * jnp.log(
        jnp.maximum(u, 1e-38))
    t_cand = entry + hit_distance / dlen
    valid = bhit & (entry < exit_) & (t_cand < exit_) & media.active[None, :]
    t_cand = jnp.where(valid, t_cand, BIG)
    best_t = jnp.min(t_cand, axis=-1)
    best_idx = jnp.argmin(t_cand, axis=-1).astype(jnp.int32)
    return best_t, best_idx


def closest_hit(key, o, d, time, scene: st.Scene, t_min=T_MIN,
                want_uv: bool | None = None) -> Hit:
    """Full-scene closest hit for a wavefront of N rays.

    Returns a Hit with surface attributes (p, normal, u, v, mat) resolved
    from the winning primitive, replicating hit_record fill-in of the
    per-class hit() methods. uv is consumed only by image textures, so its
    arctan2/arcsin work is skipped unless the scene has one (hit.u/v read 0);
    pass want_uv=True to force it (the full hit_record contract,
    hittable.h:16-29).
    """
    if want_uv is None:
        want_uv = scene.has_image_tex
    N = o.shape[0]
    if scene.bvh is not None:
        from .bvh import hit_spheres_bvh
        st_t, st_i = hit_spheres_bvh(o, d, time, t_min, scene.spheres,
                                     scene.bvh, scene.has_moving_spheres)
    else:
        st_t, st_i = hit_spheres(o, d, time, t_min, scene.spheres,
                                 scene.has_moving_spheres)
    rc_t, rc_i = hit_rects(o, d, t_min, scene.rects, scene.has_rect_transforms)
    if scene.has_media:
        md_t, md_i = hit_media(key, o, d, t_min, scene.media)
    else:
        md_t = jnp.full((N,), BIG)
        md_i = jnp.full((N,), -1, jnp.int32)

    best_t = jnp.minimum(jnp.minimum(st_t, rc_t), md_t)
    kind = jnp.where(st_t == best_t, KIND_SPHERE,
                     jnp.where(rc_t == best_t, KIND_RECT, KIND_MEDIUM))
    hit = best_t < BIG
    kind = jnp.where(hit, kind, KIND_NONE)

    idx = jnp.where(kind == KIND_SPHERE, st_i,
                    jnp.where(kind == KIND_RECT, rc_i, md_i))
    idx = jnp.maximum(idx, 0)  # safe gather index for misses

    p_world = o + best_t[:, None] * d

    # --- packed attribute resolution ---
    # ONE row gather per table instead of ~15 small-table gathers; see
    # ops/packing.py.
    base_r = scene.spheres.count()
    base_v = base_r + scene.rects.count()
    prim = jnp.where(kind == KIND_SPHERE, idx,
                     jnp.where(kind == KIND_RECT, idx + base_r,
                               idx + base_v))
    # Miss rays land at idx + base_v, which is one past the end when the
    # scene has no media rows; clamp so they read an in-range row. Their
    # lanes are masked downstream, but masked forward values still produce
    # NaN *cotangents* (inf * 0 in the masked branches), so detach miss
    # rows from the tables in the backward pass.
    prim = jnp.clip(prim, 0, base_v + scene.media.count() - 1)
    geo = packing.pack_geometry(scene)[prim]                  # (N, 16)
    sattr = packing.pack_shading(scene)[prim]                 # (N, 16)
    geo = jnp.where(hit[:, None], geo, jax.lax.stop_gradient(geo))
    sattr = jnp.where(hit[:, None], sattr, jax.lax.stop_gradient(sattr))
    mat = jnp.where(hit, geo[:, packing.G_MAT].astype(jnp.int32), 0)

    is_s = kind == KIND_SPHERE
    is_r = kind == KIND_RECT

    # --- sphere normal / uv (sphere.h:56-77,115-122) ---
    cx = geo[:, packing.GS_C0X]
    cy = geo[:, packing.GS_C0Y]
    cz = geo[:, packing.GS_C0Z]
    if scene.has_moving_spheres:
        frac = (time - geo[:, packing.GS_T0]) * geo[:, packing.GS_IDT]
        cx = cx + frac * geo[:, packing.GS_DCX]
        cy = cy + frac * geo[:, packing.GS_DCY]
        cz = cz + frac * geo[:, packing.GS_DCZ]
    rad = geo[:, packing.GS_RAD]
    # safe reciprocal: non-sphere rows carry arbitrary lane values (possibly
    # 0); the double-where keeps both passes NaN-free under the mask.
    nz = rad != 0
    inv_r = jnp.where(nz, 1.0 / jnp.where(nz, rad, 1.0), 0.0)
    s_normal = (p_world - jnp.stack([cx, cy, cz], axis=-1)) * inv_r[:, None]
    if want_uv:
        s_u, s_v = sampling.get_sphere_uv(s_normal)
    else:
        s_u = s_v = jnp.zeros((N,), o.dtype)

    # --- rect normal / uv (hittable.h:149-267 + baked transforms) ---
    if scene.rects.count():
        axis = geo[:, packing.GR_AXIS]
        flip = geo[:, packing.GR_FLIP]
        zero = jnp.zeros_like(flip)
        nx_o = jnp.where(axis == st.RECT_YZ, flip, zero)
        ny_o = jnp.where(axis == st.RECT_XZ, flip, zero)
        nz_o = jnp.where(axis == st.RECT_XY, flip, zero)
        if scene.has_rect_transforms:
            rc = geo[:, packing.GR_COS]
            rs = geo[:, packing.GR_SIN]
            r_normal = jnp.stack([rc * nx_o + rs * nz_o, ny_o,
                                  -rs * nx_o + rc * nz_o], axis=-1)
        else:
            r_normal = jnp.stack([nx_o, ny_o, nz_o], axis=-1)
        if want_uv:
            if scene.has_rect_transforms:
                rc = geo[:, packing.GR_COS]
                rs = geo[:, packing.GR_SIN]
                shx = o[:, 0] - geo[:, packing.GR_OFFX]
                shy = o[:, 1] - geo[:, packing.GR_OFFY]
                shz = o[:, 2] - geo[:, packing.GR_OFFZ]
                ox_o = rc * shx - rs * shz
                oz_o = rs * shx + rc * shz
                dx_o = rc * d[:, 0] - rs * d[:, 2]
                dz_o = rs * d[:, 0] + rc * d[:, 2]
                px = ox_o + best_t * dx_o
                py = shy + best_t * d[:, 1]
                pz = oz_o + best_t * dz_o
            else:
                px = p_world[:, 0]
                py = p_world[:, 1]
                pz = p_world[:, 2]
            pa, pb, _ = _select_axis(axis, px, py, pz)
            a0 = geo[:, packing.GR_A0]
            a1 = geo[:, packing.GR_A1]
            b0 = geo[:, packing.GR_B0]
            b1 = geo[:, packing.GR_B1]
            da = a1 - a0
            db = b1 - b0
            nza = da != 0
            nzb = db != 0
            r_u = (pa - a0) * jnp.where(nza, 1.0 / jnp.where(nza, da, 1.0),
                                        0.0)
            r_v = (pb - b0) * jnp.where(nzb, 1.0 / jnp.where(nzb, db, 1.0),
                                        0.0)
        else:
            r_u = r_v = jnp.zeros((N,), o.dtype)
    else:
        r_normal = jnp.zeros((N, 3), o.dtype)
        r_u = r_v = jnp.zeros((N,), o.dtype)

    # medium normal: arbitrary (1,0,0) (hittable.h:469-473)
    m_normal = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], dtype=o.dtype),
                                (N, 3))

    normal = jnp.where(is_s[:, None], s_normal,
                       jnp.where(is_r[:, None], r_normal, m_normal))
    uu = jnp.where(is_s, s_u, jnp.where(is_r, r_u, 0.0))
    vv = jnp.where(is_s, s_v, jnp.where(is_r, r_v, 0.0))

    return Hit(hit=hit, t=best_t, p=p_world, normal=normal, u=uu, v=vv,
               mat=mat, sattr=sattr)


def hit_aabb(o, d, box_min, box_max, t_min, t_max):
    """Slab-method AABB test (aabb.h:17-47), batched. Returns (N,) bool.

    Kept for the BVH-culling path and to preserve the reference's unit-test
    surface (CppTest/unittest1.cpp:69-110).
    """
    inv = 1.0 / d
    t0 = (box_min - o) * inv
    t1 = (box_max - o) * inv
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    tmin = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    tmax = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    return tmax > tmin


def surrounding_box(min0, max0, min1, max1):
    """AABB union (aabb.h:49-62)."""
    return jnp.minimum(min0, min1), jnp.maximum(max0, max1)
