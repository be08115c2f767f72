"""Differentiable-rendering tests: gradients vs finite differences, and an
inverse-rendering recovery demo (BASELINE.md gradient targets)."""
import numpy as np
import jax
import jax.numpy as jnp

from raytracingweekend_tpu.models import scene_types as st
from raytracingweekend_tpu.models.builder import SceneBuilder
from raytracingweekend_tpu.grad import render_diff, l2_loss, fit_texture_colors

KEY = jax.random.key(0)


def _simple_scene(albedo=(0.5, 0.3, 0.7)):
    b = SceneBuilder()
    b.sphere((0, 0, -2), 1.0, b.lambertian(b.constant(albedo)))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60.0, 1.0, 0.0, 1.0)
    return b.build(background=st.BG_GRADIENT)


def _cornellish():
    b = SceneBuilder()
    white = b.lambertian(b.constant((0.73, 0.73, 0.73)))
    b.rect("xz", -5, 5, -5, 5, 0.0, white)
    h = b.rect("xz", -1.5, 1.5, -1.5, 1.5, 4.0,
               b.diffuse_light((4.0, 4.0, 4.0)))
    b.add_light(h)
    b.camera((0, 1, 6), (0, 0.5, 0), (0, 1, 0), 60.0, 1.0, 0.0, 1.0)
    return b.build(background=st.BG_BLACK)


def _grad_vs_fd(scene, leaf_path_set, leaf_path_get, eps, nx=8, ny=8, spp=8,
                max_depth=4, rtol=5e-2, atol=1e-4):
    """Check d(mean image)/d(theta) against central finite differences for a
    scalar parameter reached by get/set closures. The RNG key is fixed, so
    the renderer is deterministic and FD is exact up to float error."""
    def f(theta):
        sc = leaf_path_set(scene, theta)
        img = render_diff(sc, KEY, nx, ny, spp, max_depth)
        return jnp.mean(img)

    theta0 = leaf_path_get(scene)
    g = jax.grad(f)(theta0)
    fd = (f(theta0 + eps) - f(theta0 - eps)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(g), np.asarray(fd),
                               rtol=rtol, atol=atol)
    return g


def test_grad_albedo_matches_fd():
    scene = _simple_scene()

    def setter(sc, theta):
        colors = sc.textures.color.at[0, 0].set(theta)
        return sc.replace(textures=sc.textures.replace(color=colors))

    g = _grad_vs_fd(scene, setter, lambda sc: sc.textures.color[0, 0],
                    eps=1e-2)
    assert float(g) > 0.0  # brighter albedo -> brighter image


def test_grad_emission_matches_fd():
    scene = _cornellish()
    # texture index 1 is the light emission color (second texture declared)
    li = 1

    def setter(sc, theta):
        colors = sc.textures.color.at[li, 1].set(theta)
        return sc.replace(textures=sc.textures.replace(color=colors))

    g = _grad_vs_fd(scene, setter, lambda sc: sc.textures.color[li, 1],
                    eps=5e-2, max_depth=4)
    assert float(g) > 0.0


def test_grad_sphere_radius_matches_fd():
    # Geometry gradient through the quadratic solve and the reparameterized
    # ONB sampling frame. The camera fov is narrow (30 deg vs the sphere's
    # 30-deg angular radius) so every ray hits well inside the silhouette:
    # visibility is locally constant and FD measures exactly the continuous
    # terms AD computes. (At wide fov, FD is dominated by silhouette hit/miss
    # flips — a discontinuity AD cannot and should not see.)
    b = SceneBuilder()
    b.sphere((0, 0, -2), 1.0, b.lambertian(b.constant((0.5, 0.3, 0.7))))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 30.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_GRADIENT)

    def setter(sc, theta):
        r = sc.spheres.radius.at[0].set(theta)
        return sc.replace(spheres=sc.spheres.replace(radius=r))

    # eps must be large enough that the per-pixel radiance change clears the
    # float32 ulp floor (the gradient here is ~1e-5/unit radius); 0.05 keeps
    # the whole view inside the silhouette while giving FD ~25 ulp of signal.
    _grad_vs_fd(scene, setter, lambda sc: sc.spheres.radius[0], eps=5e-2,
                spp=16, rtol=0.15, atol=2e-6)


def test_grad_metal_fuzz_matches_fd():
    # fuzz is reparameterized (direction = reflected + fuzz * fixed ball
    # point), so with a fixed key the estimator is smooth in fuzz and FD
    # measures exactly what AD computes — provided no fuzzed reflection
    # crosses a hit/miss boundary. The narrow fov keeps hits near the front
    # of the sphere, where reflections point far from any silhouette, so the
    # estimator is locally smooth in fuzz.
    b = SceneBuilder()
    b.sphere((0, 0, -2), 1.0, b.metal((0.8, 0.8, 0.8), 0.3))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 20.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_GRADIENT)

    def setter(sc, theta):
        return sc.replace(materials=sc.materials.replace(
            fuzz=sc.materials.fuzz.at[0].set(theta)))

    g = _grad_vs_fd(scene, setter, lambda sc: sc.materials.fuzz[0],
                    eps=1e-2, spp=16, max_depth=2, rtol=0.1, atol=1e-5)
    assert np.isfinite(float(g))


def test_grad_sphere_center_matches_fd():
    # BASELINE.md names sphere centers as a gradient target. Narrow fov keeps
    # every ray inside the silhouette (same trick as the radius test), so
    # visibility is locally constant and FD sees only the continuous terms.
    b = SceneBuilder()
    b.sphere((0, 0, -2), 1.0, b.lambertian(b.constant((0.5, 0.3, 0.7))))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 30.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_GRADIENT)

    def setter(sc, theta):
        c = sc.spheres.center0.at[0, 0].set(theta)
        # static sphere: keep center1 == center0 (the motion lerp identity)
        return sc.replace(spheres=sc.spheres.replace(center0=c, center1=c))

    _grad_vs_fd(scene, setter, lambda sc: sc.spheres.center0[0, 0], eps=2e-2,
                spp=16, rtol=0.15, atol=2e-6)


def test_grad_dielectric_ior_matches_fd():
    # IOR gradient flows through Snell's law (refraction direction) and the
    # Schlick weight (material.h:142-225). The full estimator's only
    # IOR-discontinuities are the reflect/refract coin and TIR flips, so the
    # FD check runs at the shade level on rays that all refract (near-normal
    # incidence: reflect_prob ~ 0.04, drawn uniforms checked > 0.1): the
    # branch is pinned and FD measures exactly the Snell/Schlick derivative.
    from raytracingweekend_tpu.ops import geometry, materials, sampling

    b = SceneBuilder()
    b.sphere((0, 0, -2), 1.0, b.dielectric(1.5))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 30.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_GRADIENT)

    N = 16
    key = jax.random.key(3)
    o = jnp.zeros((N, 3))
    d = jnp.stack([jnp.linspace(-0.15, 0.15, N), jnp.zeros(N),
                   -jnp.ones(N)], axis=-1)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    time = jnp.zeros((N,))

    # The dielectric coin is the 3rd split of the shade key; restrict the
    # objective to rays whose drawn uniform is far from the ~0.04 reflect
    # probability, so the FD step cannot flip a branch. The mask is fixed
    # (key-derived, IOR-independent), so it does not affect the derivative.
    _, _, k_diel, _ = jax.random.split(key, 4)
    u_coin = sampling.uniform(k_diel, (N,))
    sel = np.asarray(u_coin) > 0.1
    assert sel.sum() >= N // 2

    def f(ior):
        sc = scene.replace(materials=scene.materials.replace(
            ref_idx=scene.materials.ref_idx.at[0].set(ior)))
        hit = geometry.closest_hit(key, o, d, time, sc)
        sr = materials.shade(key, d, hit, sc)
        # refracted directions bend with IOR; their mean x-component is a
        # smooth function of it
        return jnp.mean(sr.direction[:, 0], where=jnp.asarray(sel))

    ior0 = jnp.asarray(1.5)
    g = jax.grad(f)(ior0)
    eps = 1e-3
    fd = (f(ior0 + eps) - f(ior0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-3, atol=1e-6)
    assert abs(float(g)) > 1e-4  # refraction genuinely depends on IOR


def test_inverse_rendering_recovers_albedo():
    true_albedo = (0.2, 0.6, 0.4)
    target_scene = _simple_scene(true_albedo)
    target = render_diff(target_scene, KEY, 12, 12, 16, 4)

    start = _simple_scene((0.5, 0.5, 0.5))
    fitted, _ = fit_texture_colors(
        start, target, key=KEY, nx=12, ny=12, spp=16, max_depth=4,
        steps=60, lr=0.05)
    got = np.asarray(fitted.textures.color[0])
    np.testing.assert_allclose(got, true_albedo, atol=0.05)
    # The per-step loss uses fresh fold_in keys, so it floors at MC variance;
    # evaluated with the *target's* key the fitted scene must nearly re-render
    # the target exactly.
    final = float(l2_loss(fitted, target, KEY, 12, 12, 16, 4))
    assert final < 1e-4, final


def test_loss_is_jittable_and_decreasing():
    scene = _cornellish()
    target = render_diff(scene, KEY, 8, 8, 8, 4)
    dark = scene.replace(textures=scene.textures.replace(
        color=scene.textures.color * 0.5))
    l_dark = float(l2_loss(dark, target, KEY, 8, 8, 8, 4))
    l_true = float(l2_loss(scene, target, KEY, 8, 8, 8, 4))
    assert l_true < 1e-10
    assert l_dark > l_true


def _sphere_light_scene(lc=(0.0, 2.6, -2.8)):
    b = SceneBuilder()
    b.sphere((0.0, 0.0, -3.0), 0.8, b.lambertian(b.constant((0.5, 0.5, 0.5))))
    b.sphere((0, -100.8, -3.0), 100.0,
             b.lambertian(b.constant((0.6, 0.6, 0.6))))
    # negative radius -> inward normals: the reference's one-sided emission
    # (material.h:240, dot(normal, dir) > 0) means a sphere light must face
    # inward-out to be visible from outside.
    h = b.sphere(lc, -1.0, b.diffuse_light(b.constant((5.0, 5.0, 5.0))))
    b.add_light(h)
    b.camera((0, 0.2, 0.6), (0, 0, -3), (0, 1, 0), 45.0, 1.0, 0.0, 1.0)
    return b.build(background=st.BG_BLACK)


def test_lights_scene_gradients_finite_and_useful():
    """Regression: miss lanes used to carry p ~ o + 1e37*d into the light
    pdf/cone-sampling math, whose overflow (inf - inf, 0/0 ONB normalize)
    produced NaN primals that poisoned EVERY jax.grad through reverse-mode
    VJPs in any lights-registered scene (materials.shade now zeroes dead
    lanes' p; sampling.random_to_sphere uses safe_sqrt on the cone axis)."""
    base = _sphere_light_scene()

    def loss(cx, k):
        c0 = base.spheres.center0.at[2, 0].set(cx)
        c1 = base.spheres.center1.at[2, 0].set(cx)
        sc = base.replace(spheres=base.spheres.replace(center0=c0,
                                                       center1=c1))
        return jnp.mean(render_diff(sc, k, 12, 12, 8, 3))

    g = float(jax.grad(loss)(jnp.float32(0.0), jax.random.key(1)))
    assert np.isfinite(g) and g != 0.0, g

    # rect-light scene (cornell-style): emission gradient finite + positive
    cor = _cornellish()

    def loss_e(scale, k):
        col = cor.textures.color * scale
        sc = cor.replace(textures=cor.textures.replace(color=col))
        return jnp.mean(render_diff(sc, k, 8, 8, 8, 3))

    ge = float(jax.grad(loss_e)(jnp.float32(1.0), jax.random.key(2)))
    assert np.isfinite(ge) and ge > 0.0, ge


def test_fit_scene_params_recovers_light_position():
    """Inverse rendering over geometry: recover a (hidden, off-frame) light
    sphere's x/z position and emission from the shading it casts — gradients
    flow through the MIS light-sampling cone and pdf (BASELINE.md
    'sphere centers' + 'texture params' inverse-rendering target)."""
    from raytracingweekend_tpu.grad import fit_scene_params

    true_scene = _sphere_light_scene(lc=(0.9, 2.6, -2.4))
    target = render_diff(true_scene, KEY, 16, 16, 16, 3)
    start = _sphere_light_scene(lc=(-0.7, 2.6, -3.2))

    def get_params(sc):
        return sc.spheres.center0[2]

    def set_params(sc, c):
        # keep y pinned (y trades off against emission intensity)
        c = c.at[1].set(2.6)
        c0 = sc.spheres.center0.at[2].set(c)
        c1 = sc.spheres.center1.at[2].set(c)
        return sc.replace(spheres=sc.spheres.replace(center0=c0, center1=c1))

    fitted, loss = fit_scene_params(
        start, target, get_params=get_params, set_params=set_params,
        key=KEY, nx=16, ny=16, spp=16, max_depth=3, steps=60, lr=0.05)
    got = np.asarray(fitted.spheres.center0[2])
    np.testing.assert_allclose(got[[0, 2]], [0.9, -2.4], atol=0.25)
