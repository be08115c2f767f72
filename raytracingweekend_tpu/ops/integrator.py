"""Wavefront path-tracing integrator.

Iterative reformulation of the recursive color() integrator
(reference: RayTracingWeekend.cpp:45-160). The depth-100 recursion becomes an
iterative bounce loop over a wavefront of N rays carrying
(origin, direction, throughput, radiance, active):

    radiance += throughput * emitted(vertex)
    throughput *= attenuation * scattering_pdf / pdf_val   (pdf materials)
    throughput *= attenuation                              (specular)

which telescopes to exactly the reference's
``emitted + atten * s_pdf * color(next) / pdf_val`` recursion.

Loop modes:
- "regen" (trace_regenerative): persistent slots that pull fresh camera
  rays as paths end — the default forward path;
- "tiled" (trace_tiled): per-pixel slots with dense accumulation;
- "while": lockstep lax.while_loop that stops once every ray has ended;
- "scan": fixed-depth lax.scan — reverse-mode differentiable, used by the
  inverse-rendering path.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models import scene_types as st
from . import linalg, materials, sampling
from .geometry import closest_hit

_WHITE = (1.0, 1.0, 1.0)
_BLUE = (0.5, 0.7, 1.0)


def _background(d, scene: st.Scene):
    """Miss shading (RayTracingWeekend.cpp:143-158)."""
    if scene.background == st.BG_BLACK:
        return jnp.zeros(d.shape, d.dtype)
    unit = linalg.normalize(d)
    t = 0.5 * (unit[..., 1] + 1.0)
    white = jnp.array(_WHITE, d.dtype)
    blue = jnp.array(_BLUE, d.dtype)
    # lerp(blue, white, t) with the reference's swapped-arg lerp
    # (vec3.h:84-87): (1-t)*white + t*blue.
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def _bounce(scene: st.Scene, base_key, bounce, o, d, time, tp, radiance,
            active, depth=None, rr_depth=None):
    """One wavefront bounce == one level of the color() recursion.

    With `rr_depth` set, Russian roulette terminates low-throughput paths
    past that depth with survival probability max(tp) (clamped), dividing
    the survivors' throughput by it — an unbiased tail cutoff the reference
    lacks (it hard-recurses to depth 100). This keeps wavefront slots from
    being held hostage by a few deep glass paths.
    """
    kb = jax.random.fold_in(base_key, bounce)
    k_med, k_shade = jax.random.split(kb)

    hit = closest_hit(k_med, o, d, time, scene)
    live = active & hit.hit
    miss = active & ~hit.hit

    bg = _background(d, scene)
    radiance = radiance + jnp.where(miss[:, None], tp * bg, 0.0)

    if scene.render_type == st.RENDER_NORMAL:
        # RenderType::Normal (cpp:135-136): shade 0.5*(normal+1), one bounce.
        radiance = radiance + jnp.where(live[:, None],
                                        0.5 * (hit.normal + 1.0), 0.0)
        active = jnp.zeros_like(active)
        return o, d, tp, radiance, active

    sr = materials.shade(k_shade, d, hit, scene)
    radiance = radiance + jnp.where(live[:, None], tp * sr.emitted, 0.0)
    tp = jnp.where(live[:, None], tp * sr.weight, tp)
    # Terminating on an all-zero throughput is an optimization the reference
    # lacks (it keeps recursing); the contribution is identically zero.
    alive = live & sr.scatter & jnp.any(tp > 0.0, axis=-1)
    if rr_depth is not None and depth is not None:
        p_cont = jnp.clip(jnp.max(tp, axis=-1), 0.05, 0.95)
        do_rr = alive & (depth >= rr_depth)
        u = sampling.uniform(jax.random.fold_in(kb, 7), do_rr.shape)
        survive = ~do_rr | (u < p_cont)
        tp = jnp.where((do_rr & survive)[:, None], tp / p_cont[:, None], tp)
        alive = alive & survive
    o = jnp.where(alive[:, None], hit.p, o)
    d = jnp.where(alive[:, None], sr.direction, d)
    return o, d, tp, radiance, alive


@partial(jax.jit, static_argnames=("max_depth", "mode"))
def trace(key, o, d, time, scene: st.Scene, max_depth: int = 100,
          mode: str = "while"):
    """Integrate radiance for N rays. Returns (N, 3).

    Depth semantics match cpp:42,47-48: at most `max_depth` scatter events,
    then the tail contributes 0.
    """
    N = o.shape[0]
    tp = jnp.ones((N, 3), o.dtype)
    radiance = jnp.zeros((N, 3), o.dtype)
    active = jnp.ones((N,), bool)

    if mode == "while":
        def cond(state):
            bounce, *_, act = state
            return (bounce < max_depth) & jnp.any(act)

        def body(state):
            bounce, oo, dd, tt, rad, act = state
            oo, dd, tt, rad, act = _bounce(scene, key, bounce, oo, dd, time,
                                           tt, rad, act)
            return bounce + 1, oo, dd, tt, rad, act

        state = (jnp.asarray(0), o, d, tp, radiance, active)
        state = jax.lax.while_loop(cond, body, state)
        return state[4]

    # "scan": fixed trip count, reverse-differentiable.
    def body(carry, bounce):
        oo, dd, tt, rad, act = carry
        oo, dd, tt, rad, act = _bounce(scene, key, bounce, oo, dd, time, tt,
                                       rad, act)
        return (oo, dd, tt, rad, act), None

    (oo, dd, tt, radiance, act), _ = jax.lax.scan(
        body, (o, d, tp, radiance, active), jnp.arange(max_depth))
    return radiance


def trace_regenerative(key, scene: st.Scene, nx: int, ny: int, spp: int,
                       max_depth: int = 100, n_slots: int = 1 << 19,
                       rr_depth: int | None = 4):
    """Path-regenerative wavefront integrator: the production forward path.

    The lockstep `trace` loop runs until the LAST path dies, so with a mean
    path length of ~5 and a few depth-50 glass paths, slot utilization decays
    to ~10% — 10x wasted vector work. Here each of `n_slots` persistent slots
    immediately pulls the next (pixel, sample) from a global counter when its
    path terminates (the wavefront formulation of Laine et al. 2013, built
    from lax.while_loop + masked scatter-adds instead of GPU queues), so
    slots stay busy until the launch's supply of new rays runs out. The
    tail after that still runs at full width (PERF.md measures it).

    Sampling matches main()'s jittered box filter (cpp:227-228): ray k of
    nx*ny*spp covers pixel k % n_pix at sample k // n_pix. RNG is keyed per
    (slot, iteration), which is a different — equally valid — stream than
    `trace`'s per-(ray, bounce) keys; images agree statistically, not
    bitwise.

    Returns (radiance sum image (ny, nx, 3), segment count ()).
    """
    from . import camera as camera_mod

    n_pix = nx * ny
    total = n_pix * spp
    n_slots = min(n_slots, total)

    def fresh_rays(k, ray_id, live):
        """Generate camera rays for global ray ids (slot-shaped)."""
        pix = ray_id % n_pix
        i = (pix % nx).astype(jnp.float32)
        j = (pix // nx).astype(jnp.float32)
        k_u, k_v, k_cam = jax.random.split(k, 3)
        u = (i + sampling.uniform(k_u, ray_id.shape)) / nx
        v = (j + sampling.uniform(k_v, ray_id.shape)) / ny
        o, d, t = camera_mod.get_rays(k_cam, scene.camera, u, v)
        pix = jnp.where(live, pix, n_pix)  # dummy accumulator row
        return pix.astype(jnp.int32), o, d, t

    k_init, k_loop = jax.random.split(key)
    ray0 = jnp.arange(n_slots, dtype=jnp.int32)
    pix, o, d, time = fresh_rays(k_init, ray0, ray0 < total)

    image = jnp.zeros((n_pix + 1, 3), jnp.float32)  # +1 dummy row
    tp = jnp.ones((n_slots, 3), jnp.float32)
    depth = jnp.zeros((n_slots,), jnp.int32)
    rad = jnp.zeros((n_slots, 3), jnp.float32)
    next_ray = jnp.asarray(n_slots, jnp.int32)
    segments = jnp.zeros((), jnp.float32)
    it0 = jnp.asarray(0, jnp.int32)

    def cond(state):
        (it, pix, *_rest) = state
        return jnp.any(pix < n_pix)

    def body(state):
        (it, pix, o, d, time, tp, depth, rad, image, next_ray, segments) = \
            state
        active = pix < n_pix
        segments = segments + jnp.sum(active.astype(jnp.float32))
        kb = jax.random.fold_in(k_loop, it)
        o2, d2, tp2, rad2, alive = _bounce(scene, kb, 0, o, d, time, tp, rad,
                                           active, depth=depth,
                                           rr_depth=rr_depth)
        depth = depth + 1
        alive = alive & (depth < max_depth)

        finished = active & ~alive
        # deposit finished paths (masked scatter-add; misses hit dummy row)
        dep_pix = jnp.where(finished, pix, n_pix)
        image = image.at[dep_pix].add(jnp.where(finished[:, None], rad2, 0.0))

        # regenerate: finished slots pull the next global ray ids
        rank = jnp.cumsum(finished.astype(jnp.int32)) - 1
        new_id = next_ray + rank
        take = finished & (new_id < total)
        next_ray = next_ray + jnp.sum(finished.astype(jnp.int32))

        kg = jax.random.fold_in(kb, 1)
        pix_n, o_n, d_n, t_n = fresh_rays(kg, jnp.where(take, new_id, 0),
                                          take)
        pix = jnp.where(alive, pix, jnp.where(take, pix_n, n_pix))
        o = jnp.where(alive[:, None], o2, o_n)
        d = jnp.where(alive[:, None], d2, d_n)
        time = jnp.where(alive, time, t_n)
        tp = jnp.where(alive[:, None], tp2, 1.0)
        rad = jnp.where(alive[:, None], rad2, 0.0)
        depth = jnp.where(alive, depth, 0)
        return (it + 1, pix, o, d, time, tp, depth, rad, image, next_ray,
                segments)

    state = (it0, pix, o, d, time, tp, depth, rad, image, next_ray, segments)
    state = jax.lax.while_loop(cond, body, state)
    image, segments = state[8], state[10]
    return image[:n_pix].reshape(ny, nx, 3), segments


def _block_linear_order(nx: int, ny: int, block: int = 32):
    """Pixel permutation: raster order over (block x block) tiles, raster
    within each tile. Consecutive indices cover compact 2D regions, so a
    tile of slots sees spatially-coherent content (similar path lengths) —
    the property the per-pixel-slot integrator's utilization depends on.
    Returns (order (n_pix,), inverse (n_pix,)) as numpy int32."""
    import numpy as np
    ys, xs = np.mgrid[0:ny, 0:nx]
    keys = (((ys // block) * ((nx + block - 1) // block) + (xs // block))
            * (block * block)
            + (ys % block) * block + (xs % block))
    order = np.argsort(keys.reshape(-1), kind="stable").astype(np.int32)
    inverse = np.empty_like(order)
    inverse[order] = np.arange(order.size, dtype=np.int32)
    return order, inverse


def trace_tiled(key, scene: st.Scene, nx: int, ny: int, spp: int,
                max_depth: int = 100, n_slots: int = 1 << 19,
                spp_per_slot: int | None = None,
                rr_depth: int | None = 4):
    """Tiled per-pixel-slot wavefront integrator — the scatter-free variant.

    trace_regenerative deposits finished paths with a random-index
    scatter-add. Here every slot is bound to ONE pixel for a whole launch:
    a tile of T = n_slots / k pixels runs k sample-parallel slots per pixel,
    each slot serially retracing its pixel for `spp_per_slot` samples. All
    accumulation is dense:

        slot_accum[slot]  += rad        (identity indices — elementwise)
        tile_image         = reshape(k, T, 3).sum(0)
        image              = dynamic_update_slice(image, tile_image, ...)

    Spatial coherence keeps utilization high: a tile's pixels see similar
    content, so their total work (spp_per_slot samples each, variance
    averaged out) is similar, and the per-tile while_loop exits early on
    cheap tiles. Tiles advance in an on-device scan — one compile, one
    launch per frame.

    Returns (radiance sum image (ny, nx, 3), segment count ()).
    """
    from . import camera as camera_mod

    import numpy as np

    n_pix = nx * ny
    if spp_per_slot is None:
        # target >= 8 samples per slot so path-length variance averages out
        spp_per_slot = max(min(spp, 8), spp // max(n_slots // n_pix, 1))
    while spp % spp_per_slot:
        spp_per_slot -= 1
    k = spp // spp_per_slot                 # sample-parallel slots per pixel
    # pixels per tile, at most the image (rounded up to 256)
    T = min(max(n_slots // k, 256), -(-n_pix // 256) * 256)
    slots = T * k
    n_tiles = -(-n_pix // T)
    n_pad = n_tiles * T
    # Block-linear pixel order: each tile covers compact 2D regions.
    order_np, _inv = _block_linear_order(nx, ny)
    order = jnp.asarray(
        np.pad(order_np, (0, n_pad - n_pix), constant_values=n_pix))

    def fresh_rays(kk, pix, sample_i, live):
        i = (pix % nx).astype(jnp.float32)
        j = (pix // nx).astype(jnp.float32)
        k_u, k_v, k_cam = jax.random.split(kk, 3)
        u = (i + sampling.uniform(k_u, pix.shape)) / nx
        v = (j + sampling.uniform(k_v, pix.shape)) / ny
        o, d, t = camera_mod.get_rays(k_cam, scene.camera, u, v)
        del sample_i, live
        return o, d, t

    def tile_body(carry, tile_idx):
        image, segments = carry
        base = tile_idx * T
        slot_entry = base + jnp.tile(jnp.arange(T, dtype=jnp.int32), k)
        pix = order[slot_entry]                                  # (slots,)
        valid_pix = pix < n_pix
        pix = jnp.minimum(pix, n_pix - 1)
        kt = jax.random.fold_in(key, tile_idx)

        o, d, time = fresh_rays(jax.random.fold_in(kt, 0), pix,
                                jnp.zeros_like(pix), valid_pix)
        tp = jnp.ones((slots, 3), jnp.float32)
        rad = jnp.zeros((slots, 3), jnp.float32)
        accum = jnp.zeros((slots, 3), jnp.float32)
        depth = jnp.zeros((slots,), jnp.int32)
        done = jnp.where(valid_pix, 0, spp_per_slot)  # samples completed
        it0 = jnp.asarray(0, jnp.int32)

        def cond(s):
            return jnp.any(s[-1] < spp_per_slot)

        def body(s):
            (it, o, d, time, tp, rad, accum, depth, segs, done_) = s
            active = done_ < spp_per_slot
            segs = segs + jnp.sum(active.astype(jnp.float32))
            kb = jax.random.fold_in(kt, it + 1)
            o2, d2, tp2, rad2, alive = _bounce(scene, kb, 0, o, d, time, tp,
                                               rad, active, depth=depth,
                                               rr_depth=rr_depth)
            depth = depth + 1
            alive = alive & (depth < max_depth)
            finished = active & ~alive
            accum = accum + jnp.where(finished[:, None], rad2, 0.0)
            done_ = done_ + finished.astype(jnp.int32)

            kg = jax.random.fold_in(kb, 1)
            o_n, d_n, t_n = fresh_rays(kg, pix, done_, finished)
            o = jnp.where(alive[:, None], o2, o_n)
            d = jnp.where(alive[:, None], d2, d_n)
            time = jnp.where(alive, time, t_n)
            tp = jnp.where(alive[:, None], tp2, 1.0)
            rad = jnp.where(alive[:, None], rad2, 0.0)
            depth = jnp.where(alive, depth, 0)
            return (it + 1, o, d, time, tp, rad, accum, depth, segs, done_)

        s = (it0, o, d, time, tp, rad, accum, depth,
             jnp.zeros((), jnp.float32), done)
        s = jax.lax.while_loop(cond, body, s)
        accum, segs = s[6], s[8]
        tile_img = accum.reshape(k, T, 3).sum(axis=0)          # dense reduce
        image = jax.lax.dynamic_update_slice(
            image, tile_img + jax.lax.dynamic_slice(image, (base, 0), (T, 3)),
            (base, 0))
        return (image, segments + segs), None

    image0 = jnp.zeros((n_pad, 3), jnp.float32)
    (image_blocked, segments), _ = jax.lax.scan(
        tile_body, (image0, jnp.zeros((), jnp.float32)),
        jnp.arange(n_tiles, dtype=jnp.int32))
    # blocked row b holds pixel order[b]; invert with one gather per frame
    image = image_blocked[jnp.asarray(_inv)]
    return image.reshape(ny, nx, 3), segments


def trace_with_stats(key, o, d, time, scene: st.Scene, max_depth: int = 100):
    """Like trace(mode="while") but also returns the total number of ray
    segments cast (sum over bounces of active rays) — the benchmark metric."""
    N = o.shape[0]

    def cond(state):
        bounce, *_, act, _count = state
        return (bounce < max_depth) & jnp.any(act)

    def body(state):
        bounce, oo, dd, tt, rad, act, count = state
        count = count + jnp.sum(act.astype(jnp.float32))
        oo, dd, tt, rad, act = _bounce(scene, key, bounce, oo, dd, time, tt,
                                       rad, act)
        return bounce + 1, oo, dd, tt, rad, act, count

    tp = jnp.ones((N, 3), o.dtype)
    radiance = jnp.zeros((N, 3), o.dtype)
    active = jnp.ones((N,), bool)
    state = (jnp.asarray(0), o, d, tp, radiance, active,
             jnp.zeros((), jnp.float32))
    state = jax.lax.while_loop(cond, body, state)
    return state[4], state[6]
