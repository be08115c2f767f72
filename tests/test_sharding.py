"""Multi-device sharding tests on the virtual 8-device CPU mesh
(the device-mesh replacement for the reference's PPL parallel_for,
RayTracingWeekend.cpp:186-193; SURVEY.md §2.3)."""
import numpy as np
import jax
import jax.numpy as jnp

from raytracingweekend_tpu.models.scenes import make_scene
from raytracingweekend_tpu.parallel.mesh import make_mesh, render_sharded
from raytracingweekend_tpu.render import render
from raytracingweekend_tpu.utils.config import RenderConfig


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_single_device_statistically():
    scene = make_scene("dielectric", 1.0)
    nx = ny = 16
    spp = 64
    mesh = make_mesh(dp=4, sp=2)
    img_sh = np.asarray(render_sharded(scene, mesh, jax.random.key(0),
                                       nx, ny, spp, max_depth=8))
    cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=8,
                       samples_per_launch=spp, seed=0)
    img_1 = render(scene, cfg)
    assert img_sh.shape == img_1.shape
    # Different RNG folding => different noise, same image in expectation.
    assert abs(img_sh.mean() - img_1.mean()) < 0.03
    assert np.abs(img_sh - img_1).mean() < 0.12


def test_sharded_output_is_row_sharded():
    scene = make_scene("dielectric", 1.0)
    mesh = make_mesh(dp=8, sp=1)
    out = render_sharded(scene, mesh, jax.random.key(0), 16, 16, 8,
                         max_depth=6)
    assert out.shape == (16, 16, 3)
    shardings = {s.device for s in out.addressable_shards}
    assert len(shardings) == 8


def test_sp_only_mesh_psum_path():
    scene = make_scene("dielectric", 1.0)
    mesh = make_mesh(dp=1, sp=8)
    out = np.asarray(render_sharded(scene, mesh, jax.random.key(1), 16, 16,
                                    16, max_depth=6))
    assert np.isfinite(out).all()
    assert out.mean() > 0.1


def test_sharded_determinism():
    scene = make_scene("dielectric", 1.0)
    mesh = make_mesh(dp=2, sp=2)
    a = np.asarray(render_sharded(scene, mesh, jax.random.key(2), 16, 16, 8,
                                  max_depth=6))
    b = np.asarray(render_sharded(scene, mesh, jax.random.key(2), 16, 16, 8,
                                  max_depth=6))
    np.testing.assert_array_equal(a, b)


def test_render_distributed_virtual_mesh():
    """distributed.render_distributed on the virtual 8-device mesh: full
    image assembled on the host, matching the plain sharded render."""
    import numpy as np
    from raytracingweekend_tpu.parallel import distributed

    scene = make_scene("dielectric", 1.0)
    key = jax.random.key(4)
    img = distributed.render_distributed(scene, key, 16, 16, spp=8,
                                         max_depth=5, sp=2)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert img.mean() > 0.1
