"""The sharded wavefront value_and_grad (parallel.mesh.sharded_value_and_grad)
on the virtual 8-device CPU mesh: it must equal the same estimator written
unsharded on one device, and drive fit_scene_params to convergence."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingweekend_tpu.grad import fit_scene_params, render_diff
from raytracingweekend_tpu.models.scenes import make_scene
from raytracingweekend_tpu.parallel.mesh import (make_mesh,
                                                 sharded_value_and_grad)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (holds the one-device reference)

NX, NY, SPP, DEPTH = 8, 16, 8, 3


def _set_colors(sc, p):
    return sc.replace(textures=sc.textures.replace(color=p))


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_matches_unsharded_estimator(dp, sp):
    scene = make_scene("cornell_box", NX / NY)
    target = jnp.full((NY, NX, 3), 0.2, jnp.float32)
    key = jax.random.key(5)
    vg = sharded_value_and_grad(scene, make_mesh(dp, sp), target,
                                set_params=_set_colors, nx=NX, ny=NY,
                                spp=SPP, max_depth=DEPTH)
    loss, g = vg(scene.textures.color, key)
    ref_loss, ref_g = chip_smoke._sharded_reference(
        scene, target, scene.textures.color, key, _set_colors, NX, NY, SPP,
        DEPTH, dp, sp)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(g), np.asarray(ref_g),
                               rtol=1e-4, atol=1e-7)
    assert np.abs(np.asarray(g)).sum() > 0.0


def test_fit_scene_params_on_mesh_converges():
    """Inverse rendering on a (4, 2) mesh: recover a sphere's albedo (the
    unsharded counterpart is test_grad.test_inverse_rendering_recovers_
    albedo)."""
    from raytracingweekend_tpu.models import scene_types as st
    from raytracingweekend_tpu.models.builder import SceneBuilder

    def ball(albedo):
        b = SceneBuilder()
        b.sphere((0, 0, -2), 1.0, b.lambertian(b.constant(albedo)))
        b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60.0, 1.0, 0.0, 1.0)
        return b.build(background=st.BG_GRADIENT)

    key = jax.random.key(0)
    true_albedo = (0.2, 0.6, 0.4)
    target = render_diff(ball(true_albedo), key, 12, 12, 16, 4)
    fitted, _ = fit_scene_params(
        ball((0.5, 0.5, 0.5)), target,
        get_params=lambda s: s.textures.color, set_params=_set_colors,
        postprocess=lambda p: jnp.clip(p, 0.0, None), key=key, nx=12,
        ny=12, spp=16, max_depth=4, steps=60, lr=0.05,
        mesh=make_mesh(4, 2))
    np.testing.assert_allclose(np.asarray(fitted.textures.color[0]),
                               true_albedo, atol=0.05)
