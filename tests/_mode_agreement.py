"""Shared by the test_loop_modes_*.py files: the forward loop modes must
agree statistically with the lockstep "while" loop (independent RNG
streams), plus the scene variants those files cover."""
import numpy as np

from raytracingweekend_tpu.models import scene_types as st
from raytracingweekend_tpu.models.builder import SceneBuilder
from raytracingweekend_tpu.render import render
from raytracingweekend_tpu.utils.config import RenderConfig
from raytracingweekend_tpu.utils.goldens import statistically_equal


def render_mode(scene, mode, seed, nx=16, ny=16, spp=16, max_depth=10):
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=max_depth,
                       samples_per_launch=spp, seed=seed, loop_mode=mode)
    return np.asarray(render(scene, cfg), np.float64)


def assert_agrees_with_while(scene, mode, **kw):
    ref = render_mode(scene, "while", seed=11, **kw)
    img = render_mode(scene, mode, seed=12, **kw)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01, img.mean()
    res = statistically_equal(img, ref, n_blocks=4)
    assert res["passed"], res


def noise_scene(mode):
    """Marble / smooth / turb Perlin display modes (texture.h:63-67) on a
    ground sphere and a ball."""
    b = SceneBuilder()
    tex = b.lambertian(b.noise(3.0, mode=mode))
    b.sphere((0, -1000, 0), 1000.0, tex)
    b.sphere((0, 1, 0), 1.0, tex)
    b.camera((6, 2, 5), (0, 1, 0), (0, 1, 0), 40.0, 1.0, 0.0, 10.0)
    return b.build(name=f"noise_{mode}")


def rect_noise_scene():
    """A noise-textured rect (planar uv + Perlin on a rect hit)."""
    b = SceneBuilder()
    b.sphere((0, -1000, 0), 1000.0,
             b.lambertian(b.constant((0.5, 0.5, 0.5))))
    b.rect("xy", -2.0, 2.0, 0.0, 2.5, -2.0,
           b.lambertian(b.noise(4.0, mode=st.NOISE_MARBLE)))
    b.camera((0, 1.2, 5), (0, 1, 0), (0, 1, 0), 45.0, 1.0, 0.0, 10.0)
    return b.build(name="rect_noise")


def image_on_medium_scene():
    """An image texture on an isotropic medium (uv pinned to (0, 0), as
    ops/geometry.hit_media leaves it)."""
    b = SceneBuilder()
    v = np.linspace(0.1, 0.9, 16)[:, None, None]
    tex = b.image(np.broadcast_to(v, (16, 32, 3)).copy())
    b.sphere((0, -100.5, -1), 100.0,
             b.lambertian(b.constant((0.6, 0.6, 0.6))))
    b.constant_medium_sphere((0, 0, -1), 0.7, 1.5, b.isotropic(tex))
    b.camera((0, 0, 1.5), (0, 0, -1), (0, 1, 0), 60.0, 1.0, 0.0, 2.5)
    return b.build(background=st.BG_GRADIENT, name="smoke_image")


def two_image_scene():
    """Two images of different sizes in one atlas: a sphere wearing image 0
    and a rect wearing image 1 (per-image padding and uv scaling)."""
    b = SceneBuilder()
    v = np.linspace(0.1, 0.9, 16)[:, None, None]
    h = np.linspace(0.9, 0.2, 16)[None, :, None]
    tex_a = b.image(np.broadcast_to(v, (16, 32, 3)).copy())
    tex_b = b.image(np.broadcast_to(h, (8, 16, 3)).copy())
    b.sphere((-0.6, 0.0, -1.0), 0.5, b.lambertian(tex_a))
    b.rect("xy", 0.1, 1.1, -0.5, 0.5, -1.2, b.lambertian(tex_b))
    b.sphere((0, -100.5, -1), 100.0,
             b.lambertian(b.constant((0.6, 0.6, 0.6))))
    b.camera((0, 0, 1.2), (0, 0, -1), (0, 1, 0), 70.0, 1.0, 0.0, 2.2)
    scene = b.build(background=st.BG_GRADIENT, name="two_images")
    assert scene.textures.images.shape[0] == 2
    return scene
