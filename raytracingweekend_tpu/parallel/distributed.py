"""Multi-host distributed rendering (SURVEY.md §2.3, §5).

The reference has no networking of any kind (single process, PPL threads).
Here: `jax.distributed.initialize` forms one global runtime across
processes, a global (dp, sp) mesh spans ALL devices so the `shard_map`
renderer in mesh.py runs unchanged, and the image is gathered to every
host for output.

The only cross-chip traffic forward rendering needs is the spp-shard psum
of pixel accumulators ; inverse rendering adds the scene-parameter
gradient psum (mesh.sharded_value_and_grad). Ray tracing has no neighbor exchange — rays don't interact —
so there is no ring/halo communication to schedule.

The tests run it on a virtual CPU mesh (tests/test_sharding.py) and across
two CPU processes (tests/test_distributed.py); `chip_smoke.py --multi-gpu`
runs it over the local GPUs of one process.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

# NOTE: deliberately no eager intra-package imports here — initialize()
# must run before anything touches the XLA backend, and sibling modules
# build device arrays at import time (e.g. the Perlin tables). render_
# distributed imports its dependencies lazily.

__all__ = ["initialize", "global_mesh", "render_distributed"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the global JAX runtime. Pass the coordinator address
    (`host:port`), process count and this process's id. Idempotent."""
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def global_mesh(dp: int | None = None, sp: int = 1) -> Mesh:
    """(dp, sp) mesh over ALL devices of every process. dp defaults to
    whatever fills the device count."""
    devices = jax.devices()
    n = len(devices)
    if dp is None:
        assert n % sp == 0, (n, sp)
        dp = n // sp
    assert dp * sp == n, f"mesh {dp}x{sp} != {n} devices"
    return Mesh(np.asarray(devices).reshape(dp, sp), ("dp", "sp"))


def render_distributed(scene, key, nx: int, ny: int, spp: int,
                       max_depth: int = 100, sp: int = 1):
    """Render over every device of every host: image rows sharded over dp,
    spp over sp. Returns the full (ny, nx, 3) canvas gathered to each host
    (small: one image). Call from every process (SPMD)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .mesh import render_sharded

    mesh = global_mesh(sp=sp)
    out = render_sharded(scene, mesh, key, nx, ny, spp, max_depth=max_depth)
    # Replicate the row-sharded canvas (an all-gather over "dp") so every
    # process holds the whole image and np.asarray is legal on the global
    # array even when shards live on other hosts.
    rep = jax.jit(lambda x: x,
                  out_shardings=NamedSharding(mesh, P()))(out)
    return np.asarray(rep)
