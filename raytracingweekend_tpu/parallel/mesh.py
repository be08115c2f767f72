"""Device-mesh scale-out for rendering and inverse rendering.

The reference's only parallelism is shared-memory PPL parallel_for over
rows x cols x samples with racy static RNGs (reference:
RayTracingWeekend.cpp:186-193,213-219; SURVEY.md §2.3). The device-mesh
equivalents here:

- mesh axis "dp": image row-tiles, embarrassingly parallel, output stays
  sharded (device-local canvas tiles);
- mesh axis "sp": samples-per-pixel shards, combined with one psum over the
  accumulator — the only cross-device traffic in forward rendering;
- gradient all-reduce for inverse rendering is the same psum applied to
  scene-parameter grads.

RNG is keyed per (tile, sample-shard) via fold_in, so sharded rendering is
deterministic and statistically independent across devices by construction —
the property the reference loses the moment it goes parallel.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models import scene_types as st
from ..ops import camera as camera_mod
from ..ops import sampling
from ..ops.integrator import trace, trace_with_stats

__all__ = ["make_mesh", "render_sharded", "sharded_value_and_grad"]


def make_mesh(dp: int = 1, sp: int = 1, devices=None) -> Mesh:
    """Build a (dp, sp) mesh over the available devices. dp shards image
    row-tiles; sp shards samples-per-pixel."""
    devices = devices if devices is not None else jax.devices()
    assert dp * sp <= len(devices), (
        f"need {dp * sp} devices, have {len(devices)}")
    arr = np.asarray(devices[: dp * sp]).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


def _tile_key(key, di, si):
    """Independent RNG stream for the (row-tile, sample-shard) block."""
    return jax.random.fold_in(jax.random.fold_in(key, di), si)


def _render_tile(scene: st.Scene, key, row0, nx: int, rows: int,
                 ny_total: int, spp_shard: int, max_depth: int, mode: str):
    """Render `rows` image rows starting at absolute row `row0` with
    spp_shard samples each. Returns (radiance sum (rows, nx, 3), segments);
    segments are counted in "while" mode only (0 otherwise)."""
    n_pix = rows * nx
    n_rays = n_pix * spp_shard
    pix = jnp.arange(n_pix, dtype=jnp.int32)
    i = jnp.tile(pix % nx, spp_shard)
    j = jnp.tile(pix // nx, spp_shard) + row0

    k_u, k_v, k_cam, k_trace = jax.random.split(key, 4)
    u = (i.astype(jnp.float32) + sampling.uniform(k_u, (n_rays,))) / nx
    v = (j.astype(jnp.float32) + sampling.uniform(k_v, (n_rays,))) / ny_total
    o, d, t = camera_mod.get_rays(k_cam, scene.camera, u, v)
    if mode == "while":
        rad, segs = trace_with_stats(k_trace, o, d, t, scene,
                                     max_depth=max_depth)
    else:
        rad = trace(k_trace, o, d, t, scene, max_depth=max_depth, mode=mode)
        segs = jnp.zeros((), jnp.float32)
    return rad.reshape(spp_shard, rows, nx, 3).sum(axis=0), segs


def _shard_dims(mesh: Mesh, ny: int, spp: int):
    dp = mesh.shape["dp"]
    sp = mesh.shape["sp"]
    assert ny % dp == 0, f"ny={ny} must divide by dp={dp}"
    assert spp % sp == 0, f"spp={spp} must divide by sp={sp}"
    return dp, sp, ny // dp, spp // sp


@partial(jax.jit, static_argnames=("mesh", "nx", "ny", "spp", "max_depth",
                                   "mode", "with_segments"))
def render_sharded(scene: st.Scene, mesh: Mesh, key, nx: int, ny: int,
                   spp: int, max_depth: int = 100, mode: str = "while",
                   with_segments: bool = False):
    """Render (ny, nx) at `spp` with rows sharded over mesh axis "dp" and
    samples over "sp". Returns the averaged canvas, sharded over rows (and,
    with `with_segments`, the path segments traced on all devices; "while"
    mode only).

    The scene pytree is replicated to every device; each device traces its
    (row-tile x sample-shard) block with an independent folded key; sample
    shards are combined with a single psum over "sp" (the spp-sharded pixel
    accumulation of SURVEY.md §2.3).
    """
    _dp, _sp, rows, spp_shard = _shard_dims(mesh, ny, spp)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P()),
             out_specs=(P("dp", None, None), P()), check_vma=False)
    def run(scene_rep, base_key):
        di = jax.lax.axis_index("dp")
        si = jax.lax.axis_index("sp")
        tile, segs = _render_tile(scene_rep, _tile_key(base_key, di, si),
                                  di * rows, nx, rows, ny, spp_shard,
                                  max_depth, mode)
        return (jax.lax.psum(tile, "sp"),
                jax.lax.psum(segs, ("dp", "sp")))

    canvas, segs = run(scene, key)
    if with_segments:
        return canvas / spp, segs
    return canvas / spp


def sharded_value_and_grad(scene: st.Scene, mesh: Mesh, target, *,
                           set_params, nx: int, ny: int, spp: int,
                           max_depth: int = 8):
    """Jitted (params, key) -> (loss, grads) of the pixel L2 loss between
    `target` (ny, nx, 3) and the "scan"-mode render of
    `set_params(scene, params)` — rows sharded over "dp", samples over "sp".

    Each device renders its (row-tile, sample-shard) block under a local
    VJP; the only collectives are the spp mean of the forward tiles, the
    loss sum over "dp" and one gradient psum over the whole mesh. The
    result equals running every block's VJP on one device with the same
    keys (`_tile_key`) and summing.
    """
    _dp, sp, rows, spp_shard = _shard_dims(mesh, ny, spp)
    n = ny * nx * 3

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(), P("dp", None, None)),
             out_specs=(P(), P()), check_vma=False)
    def step(params, scene_rep, base_key, target_tile):
        di = jax.lax.axis_index("dp")
        si = jax.lax.axis_index("sp")

        def tile_mean(p):
            tile, _ = _render_tile(set_params(scene_rep, p),
                                   _tile_key(base_key, di, si), di * rows,
                                   nx, rows, ny, spp_shard, max_depth,
                                   "scan")
            return tile / spp_shard

        img, vjp = jax.vjp(tile_mean, params)
        err = jax.lax.pmean(img, "sp") - target_tile
        (g,) = vjp((2.0 / (n * sp)) * err)
        loss = jax.lax.psum(jnp.sum(err * err), "dp") / n
        g = jax.tree.map(lambda x: jax.lax.psum(x, ("dp", "sp")), g)
        return loss, g

    step = jax.jit(step)
    return lambda params, key: step(params, scene, key, target)
