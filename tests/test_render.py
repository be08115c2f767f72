"""Integration tests of the full render path (reference oracle:
RayTracingWeekend.cpp:45-160 color() + main() loop)."""
import math

import numpy as np
import jax
import jax.numpy as jnp

from raytracingweekend_tpu.models import scene_types as st
from raytracingweekend_tpu.models.builder import SceneBuilder
from raytracingweekend_tpu.models.scenes import make_scene
from raytracingweekend_tpu.ops.integrator import trace
from raytracingweekend_tpu.render import render, render_chunk
from raytracingweekend_tpu.utils.config import RenderConfig


def _rays(o, d, n=1):
    o = jnp.tile(jnp.asarray([o], jnp.float32), (n, 1))
    d = jnp.tile(jnp.asarray([d], jnp.float32), (n, 1))
    t = jnp.zeros((n,), jnp.float32)
    return o, d, t


def test_background_gradient_formula():
    # Miss straight up: t=1 -> (0.5,0.7,1); straight down: t=0 -> white
    # (cpp:148-150 with the swapped lerp).
    b = SceneBuilder()
    b.sphere((0, -100, 0), 1.0, b.lambertian(b.constant((1, 1, 1))))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_GRADIENT)
    o, d, t = _rays((0, 0, 0), (0, 1, 0))
    rad = trace(jax.random.key(0), o, d, t, scene, max_depth=5)
    np.testing.assert_allclose(np.asarray(rad[0]), [0.5, 0.7, 1.0], atol=1e-5)
    o, d, t = _rays((0, 5, 0), (0, 1e-6, -1.0))  # horizontal: t ~ 0.5
    rad = trace(jax.random.key(0), o, d, t, scene, max_depth=5)
    np.testing.assert_allclose(np.asarray(rad[0]), [0.75, 0.85, 1.0],
                               atol=1e-4)


def test_black_background():
    b = SceneBuilder()
    b.sphere((0, -100, 0), 1.0, b.lambertian(b.constant((1, 1, 1))))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_BLACK)
    o, d, t = _rays((0, 0, 0), (0, 1, 0))
    rad = trace(jax.random.key(0), o, d, t, scene, max_depth=5)
    np.testing.assert_allclose(np.asarray(rad[0]), [0, 0, 0], atol=1e-7)


def test_lambertian_white_furnace():
    """A lambertian sphere under a *uniform* white sky returns exactly its
    albedo: cosine sampling weight spdf/pdf == 1 telescopes to albedo * 1.
    We approximate the uniform sky by setting both gradient endpoints equal
    via a custom check: use black bg + emissive enclosing shell instead."""
    b = SceneBuilder()
    albedo = (0.6, 0.4, 0.2)
    b.sphere((0, 0, -3), 1.0, b.lambertian(b.constant(albedo)))
    # Enclosing emissive shell. Positive radius: rays from inside hit the far
    # root traveling outward, so dot(outward normal, dir) > 0 and the
    # one-sided emission test (material.h:240-243) passes.
    b.sphere((0, 0, 0), 50.0, b.diffuse_light((1.0, 1.0, 1.0)))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_BLACK)
    n = 4096
    o, d, t = _rays((0, 0, 0), (0, 0, -1), n)
    rad = trace(jax.random.key(1), o, d, t, scene, max_depth=8)
    mean = np.asarray(rad).mean(axis=0)
    # Paths: hit sphere (throughput *= albedo * 1), bounce, eventually hit
    # shell (emit 1) possibly after re-hitting the sphere; first-order value
    # is albedo + O(albedo^2) interreflection, bounded by albedo/(1-albedo).
    lo = np.asarray(albedo)
    hi = lo / (1.0 - lo)
    assert (mean >= lo - 0.02).all(), mean
    assert (mean <= hi + 0.02).all(), mean


def test_emission_one_sided():
    # diffuse_light emits only when dot(normal, ray.dir) > 0
    # (material.h:238-244): a rect light seen from below (normal +y, ray
    # going up) emits; seen from above it is black.
    b = SceneBuilder()
    b.rect("xz", -1, 1, -1, 1, 0.0, b.diffuse_light((5.0, 5.0, 5.0)))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_BLACK)
    o, d, t = _rays((0, -2, 0), (0, 1, 0))
    up = trace(jax.random.key(0), o, d, t, scene, max_depth=3)
    np.testing.assert_allclose(np.asarray(up[0]), [5, 5, 5], atol=1e-4)
    o, d, t = _rays((0, 2, 0), (0, -1, 0))
    down = trace(jax.random.key(0), o, d, t, scene, max_depth=3)
    np.testing.assert_allclose(np.asarray(down[0]), [0, 0, 0], atol=1e-6)


def test_metal_mirror_reflection():
    # Fuzz-0 metal floor over black bg: a straight-down ray reflects straight
    # up into an emitter whose normal (+y, unflipped) satisfies the one-sided
    # test dot(normal, dir) > 0 — radiance = albedo * emission.
    b = SceneBuilder()
    b.rect("xz", -10, 10, -10, 10, 0.0, b.metal((0.8, 0.6, 0.4), 0.0))
    b.rect("xz", -1, 1, -1, 1, 10.0, b.diffuse_light((2.0, 2.0, 2.0)))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_BLACK)
    o, d, t = _rays((0.1, 5, 0.1), (0, -1, 0))
    rad = trace(jax.random.key(0), o, d, t, scene, max_depth=4)
    np.testing.assert_allclose(np.asarray(rad[0]),
                               [0.8 * 2, 0.6 * 2, 0.4 * 2], atol=1e-4)


def test_dielectric_straight_through_energy():
    # Glass sphere, ray through the center: all paths (reflect or refract)
    # carry attenuation 1; with gradient bg total radiance has mean ~ bg.
    b = SceneBuilder()
    b.sphere((0, 0, -3), 1.0, b.dielectric(1.5))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_GRADIENT)
    n = 4096
    o, d, t = _rays((0, 0, 0), (0, 0, -1), n)
    rad = np.asarray(trace(jax.random.key(2), o, d, t, scene, max_depth=50))
    assert rad.min() >= -1e-6
    assert rad.max() <= 1.0 + 1e-5  # bg max is 1
    assert rad.mean() > 0.5  # glass transmits most energy


def test_mis_unbiasedness_light_vs_cosine():
    """The MIS estimator (mixture pdf) and the pure cosine estimator target
    the same integral; their converged means must agree. This validates the
    whole book-3 machinery (pdf.h + cpp:117-132) end to end."""
    def build(lights_on):
        b = SceneBuilder()
        white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
        b.rect("xz", -5, 5, -5, 5, 0.0, white)
        h = b.rect("xz", -1.5, 1.5, -1.5, 1.5, 4.0,
                   b.diffuse_light((4.0, 4.0, 4.0)))
        if lights_on:
            b.add_light(h)
        b.camera((0, 1, 6), (0, 0.5, 0), (0, 1, 0), 60.0, 1.0, 0.0, 1.0)
        return b.build(background=st.BG_BLACK)

    cfg_mis = RenderConfig(nx=24, ny=24, spp=256, max_depth=8,
                           samples_per_launch=64, seed=3)
    img_mis = render(build(True), cfg_mis)
    cfg_cos = RenderConfig(nx=24, ny=24, spp=2048, max_depth=8,
                           samples_per_launch=256, seed=4)
    img_cos = render(build(False), cfg_cos)
    # Compare scene-average radiance (pixelwise would need far more spp).
    m1, m2 = img_mis.mean(), img_cos.mean()
    assert abs(m1 - m2) / m2 < 0.05, (m1, m2)


def test_normal_render_mode():
    b = SceneBuilder()
    b.sphere((0, 0, -2), 1.0, b.lambertian(b.constant((1, 0, 0))))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_GRADIENT,
                    render_type=st.RENDER_NORMAL)
    o, d, t = _rays((0, 0, 0), (0, 0, -1))
    rad = trace(jax.random.key(0), o, d, t, scene, max_depth=5)
    # normal (0,0,1) -> 0.5*(n+1) = (0.5,0.5,1) (cpp:135-136)
    np.testing.assert_allclose(np.asarray(rad[0]), [0.5, 0.5, 1.0], atol=1e-5)


def test_scan_and_while_modes_agree():
    scene = make_scene("dielectric", 1.0)
    n = 512
    o, d, t = _rays((0, 0, 0), (0, 0, -1), n)
    key = jax.random.key(5)
    r_while = trace(key, o, d, t, scene, max_depth=12, mode="while")
    r_scan = trace(key, o, d, t, scene, max_depth=12, mode="scan")
    np.testing.assert_allclose(np.asarray(r_while), np.asarray(r_scan),
                               atol=1e-5)


def test_render_chunk_shape_and_determinism():
    scene = make_scene("dielectric", 1.0)
    key = jax.random.key(0)
    a = render_chunk(scene, key, 16, 16, 2, 8, "while")
    b = render_chunk(scene, key, 16, 16, 2, 8, "while")
    assert a.shape == (16, 16, 3)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_full_render_small_cornell():
    cfg = RenderConfig(nx=16, ny=16, spp=8, max_depth=8,
                       samples_per_launch=4)
    scene = make_scene("cornell_box", 1.0)
    img = render(scene, cfg)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.05  # light visible


def test_regenerative_matches_lockstep_statistically():
    """The path-regenerative wavefront (trace_regenerative) and the lockstep
    loop integrate the same estimator; their converged images must agree."""
    from raytracingweekend_tpu.ops.integrator import trace_regenerative

    scene = make_scene("dielectric", 1.0)
    nx = ny = 12
    spp = 256
    key = jax.random.key(11)
    img_regen, segs = jax.jit(
        lambda k: trace_regenerative(k, scene, nx, ny, spp, max_depth=16,
                                     n_slots=4096))(key)
    img_regen = np.asarray(img_regen) / spp
    assert float(segs) > nx * ny * spp  # at least one segment per ray

    cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=16,
                       samples_per_launch=64, seed=12, loop_mode="while")
    img_lock = render(scene, cfg)
    # scene-mean agreement within MC error
    assert abs(img_regen.mean() - img_lock.mean()) / img_lock.mean() < 0.03
    # pixelwise within a few noise sigmas
    err = np.abs(img_regen - img_lock)
    tol = 0.05 + 4.0 * np.sqrt(np.maximum(img_lock, 0.0) / spp)
    assert (err <= tol).mean() > 0.99


def test_loop_modes_are_the_supported_four():
    import pytest

    from raytracingweekend_tpu import render as render_mod
    from raytracingweekend_tpu.utils.config import LOOP_MODES

    assert LOOP_MODES == ("regen", "tiled", "while", "scan")
    assert RenderConfig().loop_mode == "regen"
    with pytest.raises(ValueError, match="loop_mode"):
        render(make_scene("dielectric", 1.0),
               RenderConfig(nx=4, ny=4, spp=1, loop_mode="mega"))
    for removed in (["--mode", "auto"], ["--mode", "mega"],
                    ["--tile-lanes", "512"]):
        with pytest.raises(SystemExit):
            render_mod.main(removed)


def test_tiled_tile_is_capped_at_the_image():
    """A frame smaller than n_slots pixels runs as one tile of the image's
    size (rounded up to 256), not a wavefront of n_slots mostly-padding
    slots."""
    from raytracingweekend_tpu.ops.integrator import trace_tiled

    scene = make_scene("dielectric", 1.0)
    img, segs = trace_tiled(jax.random.key(0), scene, 8, 8, 4, max_depth=4)
    assert img.shape == (8, 8, 3)
    # every one of the 8*8*4 paths traced at least its camera segment,
    # and no padded slot was counted
    assert 8 * 8 * 4 <= float(segs) <= 8 * 8 * 4 * 4
