"""Wavefront FD gradient checks for texture parameters: Perlin noise
scale, image texels, and the Cornell box's texture colors (walls and
light)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingweekend_tpu.grad import render_diff
from raytracingweekend_tpu.models.scenes import make_scene

from _fd import grad_and_fd


def test_noise_scale():
    """No path decision depends on albedo, so the marble chain
    sin(scale*z + 10*turb) differentiates cleanly."""
    g, fd = grad_and_fd(
        make_scene("two_perlin_spheres", 1.0), lambda s: s.textures.scale,
        lambda s, p: s.replace(textures=s.textures.replace(scale=p)),
        (0,), eps=1e-3, seed=0)
    np.testing.assert_allclose(g, fd, rtol=1e-2, atol=1e-6)


def test_image_texels():
    """Texels enter only through albedo; check the two texels with the
    largest gradient on the earth globe."""
    scene = make_scene("earth", 1.0)
    key = jax.random.key(0)
    p0 = scene.textures.images

    def f(p):
        sc = scene.replace(textures=scene.textures.replace(images=p))
        return jnp.mean(render_diff(sc, key, 8, 8, 8, 4))

    g = np.asarray(jax.grad(f)(p0))
    assert np.abs(g).sum() > 0.0
    for flat in np.argsort(np.abs(g).ravel())[::-1][:2]:
        idx = np.unravel_index(flat, g.shape)
        e = np.zeros(p0.shape, np.float32)
        e[idx] = 5e-3
        fd = float((f(p0 + e) - f(p0 - e)) / 1e-2)
        np.testing.assert_allclose(g[idx], fd, rtol=2e-2, atol=1e-7)


@pytest.mark.parametrize("entry", [(0, 0), (1, 0), (1, 1), (3, 2)])
def test_cornell_texture_colors(entry):
    """Wall, light and box colors of the flagship Cornell box (rects, MIS
    lights and the glass sphere on the path)."""
    g, fd = grad_and_fd(
        make_scene("cornell_box", 1.0), lambda s: s.textures.color,
        lambda s, p: s.replace(textures=s.textures.replace(color=p)),
        entry, eps=1e-2, seed=0)
    assert g != 0.0
    np.testing.assert_allclose(g, fd, rtol=1e-3, atol=1e-6)
