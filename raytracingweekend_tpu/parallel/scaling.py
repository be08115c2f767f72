"""Data-parallel scaling harness.

Times render_sharded at increasing dp widths on whatever devices exist and
reports samples/s per device plus efficiency vs dp=1. On a virtual CPU mesh
the absolute numbers say nothing about any accelerator; the harness there
only exercises the mesh / shard_map / psum code path.
"""
from __future__ import annotations

import time

import jax

from .mesh import make_mesh, render_sharded

__all__ = ["dp_scaling_report"]


def dp_scaling_report(scene, nx: int, ny: int, spp: int,
                      dps=(1, 2, 4, 8), sp: int = 1, max_depth: int = 8,
                      key=None, repeats: int = 1):
    """Returns a list of dicts: {dp, sp, seconds, samples_per_s,
    samples_per_s_per_device, efficiency_vs_dp1}."""
    key = jax.random.key(0) if key is None else key
    n_dev = len(jax.devices())
    rows = []
    base = None

    def run(mesh, k):
        return render_sharded(scene, mesh, k, nx, ny, spp,
                              max_depth=max_depth).block_until_ready()

    for dp in dps:
        if dp * sp > n_dev or ny % dp:
            continue
        mesh = make_mesh(dp, sp, jax.devices()[: dp * sp])
        run(mesh, key)  # warmup/compile
        t0 = time.perf_counter()
        for r in range(repeats):
            run(mesh, jax.random.fold_in(key, r + 1))
        dt = (time.perf_counter() - t0) / repeats
        sps = nx * ny * spp / dt
        per_dev = sps / (dp * sp)
        if base is None:
            base = per_dev
        rows.append(dict(dp=dp, sp=sp, seconds=dt,
                         samples_per_s=sps,
                         samples_per_s_per_device=per_dev,
                         efficiency_vs_dp1=per_dev / base))
    return rows
