"""Opt-in float64 validation mode (utils/validation.py): the wavefront
integrator is dtype-polymorphic, so an f64 render must (a) come back in
float64 and (b) agree with the f32 render to float32-round-off-level
tolerance — the property that makes it a regression microscope.

Runs in a SUBPROCESS because jax_enable_x64 must be set before any array
exists (the main pytest process is f32)."""
import os
import subprocess
import sys

import pytest

_SCRIPT = r"""
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from raytracingweekend_tpu.models.scenes import make_scene
from raytracingweekend_tpu.render import render_chunk
from raytracingweekend_tpu.utils.validation import render_f64, scene_to_dtype

scene = make_scene("dielectric", 1.0)
key = jax.random.key(3)
img64 = render_f64(scene, key, 12, 12, 4, max_depth=6)
assert img64.dtype == jnp.float64, img64.dtype
img32 = render_chunk(scene_to_dtype(scene, jnp.float32), key, 12, 12, 4, 6)
assert img32.dtype == jnp.float32, img32.dtype
a = np.asarray(img64)
b = np.asarray(img32, np.float64)
# same keyed sample stream, same math: only accumulated f32 round-off
# separates them
rel = np.abs(a - b) / np.maximum(np.abs(a), 1e-3)
assert rel.max() < 5e-4, rel.max()
assert np.isfinite(a).all()
print("f64 ok", float(a.mean()), float(rel.max()))
"""


@pytest.mark.skipif(os.environ.get("RTW_SKIP_SUBPROC") == "1",
                    reason="subprocess tests disabled")
def test_f64_validation_mode():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "f64 ok" in out.stdout
