"""Differentiable rendering and inverse rendering.

The reference has no gradient story; this is the capability BASELINE.md adds
(pixel gradients allclose vs finite differences; inverse rendering by
gradient descent on scene parameters). Design (SURVEY.md §7 step 7):

- the forward path is the fixed-depth "scan" integrator, reverse-mode
  differentiable end to end;
- sampling is *reparameterized*: the raw uniform draws are parameter-free,
  so sampled directions are differentiable through the ONB frame, normals,
  and Snell's law (materials.shade). Only discrete *decisions* (hit/miss,
  material branch, mixture coin, dielectric reflect/refract coin) are
  comparisons with zero gradient — matching what fixed-key finite
  differences measure;
- with a fixed RNG key the whole renderer is a deterministic differentiable
  function, so gradients can be checked against finite differences exactly.

Scene parameters live in the Scene pytree, so `jax.grad` w.r.t. any subset
(texture colors, emission, fuzz, refractive index, sphere centers/radii)
works through `render_diff` via standard pytree surgery.

Gradients run through the wavefront integrator's "scan" mode; the forward
renderer's "regen" path is not differentiated.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

from .models import scene_types as st
from .ops import camera as camera_mod
from .ops import sampling
from .ops.integrator import trace


@partial(jax.jit, static_argnames=("nx", "ny", "spp", "max_depth"))
def render_diff(scene: st.Scene, key, nx: int, ny: int, spp: int,
                max_depth: int = 8):
    """Differentiable render: (ny, nx, 3) averaged over spp samples, using
    the scan-mode integrator. Deterministic in `key`."""
    n_pix = nx * ny
    n_rays = n_pix * spp
    pix = jnp.arange(n_pix, dtype=jnp.int32)
    i = jnp.tile(pix % nx, spp)
    j = jnp.tile(pix // nx, spp)
    k_u, k_v, k_cam, k_trace = jax.random.split(key, 4)
    u = (i.astype(jnp.float32) + sampling.uniform(k_u, (n_rays,))) / nx
    v = (j.astype(jnp.float32) + sampling.uniform(k_v, (n_rays,))) / ny
    o, d, t = camera_mod.get_rays(k_cam, scene.camera, u, v)
    rad = trace(k_trace, o, d, t, scene, max_depth=max_depth, mode="scan")
    return rad.reshape(spp, ny, nx, 3).mean(axis=0)


def l2_loss(scene: st.Scene, target, key, nx: int, ny: int, spp: int,
            max_depth: int = 8):
    img = render_diff(scene, key, nx, ny, spp, max_depth)
    return jnp.mean((img - target) ** 2)


def fit_scene_params(scene: st.Scene, target, *, get_params, set_params,
                     key, nx: int, ny: int, spp: int, max_depth: int = 8,
                     steps: int = 100, lr: float = 0.5,
                     postprocess=None,
                     log_fn: Callable[..., None] | None = None,
                     metrics_path: str | None = None, mesh=None):
    """Inverse rendering over ANY differentiable scene-parameter subset:
    Adam-descend the pixel L2 loss w.r.t. the pytree `get_params(scene)`
    returns (texture colors, emission, sphere centers/radii, fuzz, IOR —
    any Scene leaves; BASELINE.md's inverse-rendering configs).
    `set_params(scene, params)` writes the subset back; `postprocess`
    optionally projects params after each update (e.g. clip colors >= 0).
    Returns (fitted scene, final loss).

    log_fn(step, loss, grad_norm) is called per step (older two-argument
    callbacks still work); metrics_path appends one JSON line per step with
    {step, loss, grad_norm} (SURVEY.md §5 observability).

    With a (dp, sp) `mesh` (parallel.mesh.make_mesh), each step's loss and
    gradients come from parallel.mesh.sharded_value_and_grad: rows over
    "dp", samples over "sp", one gradient psum."""
    import inspect

    import optax

    params = get_params(scene)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    if mesh is not None:
        from .parallel.mesh import sharded_value_and_grad
        grad_fn = sharded_value_and_grad(
            scene, mesh, target, set_params=set_params, nx=nx, ny=ny,
            spp=spp, max_depth=max_depth)
    else:
        def loss_fn(p, k):
            return l2_loss(set_params(scene, p), target, k, nx, ny, spp,
                           max_depth)

        grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    legacy_log = (log_fn is not None
                  and len(inspect.signature(log_fn).parameters) < 3)
    want_gnorm = (log_fn is not None and not legacy_log) or metrics_path
    loss = None
    for step in range(steps):
        k = jax.random.fold_in(key, step)
        loss, g = grad_fn(params, k)
        # the float() is a device->host sync: only pay it when a consumer
        # asked for the gradient norm
        gnorm = (float(jnp.sqrt(sum(jnp.sum(x * x)
                                    for x in jax.tree.leaves(g))))
                 if want_gnorm else 0.0)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        if postprocess is not None:
            params = postprocess(params)
        if log_fn is not None:
            if legacy_log:
                log_fn(step, float(loss))
            else:
                log_fn(step, float(loss), gnorm)
        if metrics_path:
            import json
            with open(metrics_path, "a") as mf:
                mf.write(json.dumps({"step": step, "loss": float(loss),
                                     "grad_norm": gnorm}) + "\n")
    return set_params(scene, params), float(loss)


def fit_texture_colors(scene: st.Scene, target, *, key, nx: int, ny: int,
                       spp: int, max_depth: int = 8, steps: int = 100,
                       lr: float = 0.5,
                       log_fn: Callable[..., None] | None = None,
                       metrics_path: str | None = None):
    """Inverse-rendering demo: gradient-descend the texture color table to
    match a target image (fit_scene_params specialized to textures.color).
    Returns (fitted scene, final loss)."""
    return fit_scene_params(
        scene, target,
        get_params=lambda sc: sc.textures.color,
        set_params=lambda sc, p: sc.replace(
            textures=sc.textures.replace(color=p)),
        postprocess=lambda p: jnp.clip(p, 0.0, None),
        key=key, nx=nx, ny=ny, spp=spp, max_depth=max_depth,
        steps=steps, lr=lr, log_fn=log_fn, metrics_path=metrics_path)
