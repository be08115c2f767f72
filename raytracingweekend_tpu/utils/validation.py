"""Opt-in float64 validation mode.

The reference computes in double (vec3.h:39-43); this framework is
float32-first because that is the accelerator's native word (the
deviation is deliberate and measured — parity is proven at the 2%/4-sigma
gate against the f64 oracle). For CPU-side validation, though, an f64
render tightens golden tolerances by ~10x and catches subtle precision
regressions: the wavefront integrator is dtype-polymorphic, so casting the
scene pytree up and enabling jax_enable_x64 is sufficient.

Usage (x64 must be enabled before JAX arrays exist — run in a fresh
process, as tests/test_f64.py does):

    JAX_ENABLE_X64=1 python -c "
    from raytracingweekend_tpu.utils.validation import render_f64 ..."
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def scene_to_dtype(scene, dtype=jnp.float64):
    """Cast every floating leaf of the Scene pytree (int/bool leaves —
    material indices, type codes, active masks — stay untouched)."""
    def cast(x):
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating):
            return x.astype(dtype)
        return x
    return jax.tree.map(cast, scene)


def render_f64(scene, key, nx: int, ny: int, spp: int, max_depth: int = 50):
    """Double-precision wavefront render (requires jax_enable_x64).
    Returns the (ny, nx, 3) float64 radiance sums."""
    assert jax.config.read("jax_enable_x64"), (
        "enable x64 before creating arrays: JAX_ENABLE_X64=1 or "
        "jax.config.update('jax_enable_x64', True) at process start")
    from ..render import render_chunk

    return render_chunk(scene_to_dtype(scene), key, nx, ny, spp, max_depth)
