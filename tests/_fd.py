"""Shared by the test_grad_fd_*.py files: the wavefront gradient
(grad.render_diff, "scan" mode) of the mean image w.r.t. one scene leaf
entry, against central finite differences with the same fixed RNG key.
A fixed key makes the estimator a deterministic function, so FD measures
exactly what AD computes as long as no visibility decision flips between
the two FD evaluations (seeds and eps were chosen so none does)."""
import jax
import jax.numpy as jnp
import numpy as np

from raytracingweekend_tpu.grad import render_diff
from raytracingweekend_tpu.models import scene_types as st
from raytracingweekend_tpu.models.builder import SceneBuilder


def grad_and_fd(scene, get, set_, idx, eps, seed, nx=8, ny=8, spp=8,
                max_depth=4):
    key = jax.random.key(seed)
    p0 = get(scene)

    def f(p):
        return jnp.mean(render_diff(set_(scene, p), key, nx, ny, spp,
                                    max_depth))

    g = np.asarray(jax.grad(f)(p0))
    assert np.isfinite(g).all()
    e = np.zeros(p0.shape, np.float32)
    e[idx] = eps
    fd = float((f(p0 + e) - f(p0 - e)) / (2 * eps))
    return float(g[idx]), fd


def mis_scene():
    """Constant-lambertian sphere under a rect light, black background:
    smooth gradients through the one-sample MIS machinery (cosine pdf mixed
    with the rect light's hittable pdf)."""
    b = SceneBuilder()
    red = b.lambertian(b.constant((0.8, 0.2, 0.2)))
    lightm = b.diffuse_light(b.constant((4.0, 4.0, 4.0)))
    b.sphere((0.0, 0.0, 0.0), 1.0, red)
    h = b.rect("xz", -1.0, 1.0, -1.0, 1.0, 2.5, lightm)
    b.add_light(h)
    b.camera((0, 1, 6), (0, 0, 0), (0, 1, 0), 30.0, 1.0, 0.0, 6.0,
             0.0, 1.0)
    return b.build(background=st.BG_BLACK, name="fd_mis")


def density_scene():
    """Marble-textured isotropic medium over a ground sphere: the scatter
    point m_in - log(U)/rho moves with rho, which moves the marble albedo,
    so radiance depends smoothly on the density."""
    b = SceneBuilder()
    iso = b.isotropic(b.noise(scale=2.0, mode=st.NOISE_MARBLE))
    b.constant_medium_sphere((0.0, 0.0, 0.0), 1.5, 1.2, iso)
    ground = b.lambertian(b.constant((0.4, 0.5, 0.6)))
    b.sphere((0.0, -101.5, 0.0), 100.0, ground)
    b.camera((0, 0.5, 6), (0, 0, 0), (0, 1, 0), 30.0, 1.0, 0.0, 6.0,
             0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name="fd_rho")
