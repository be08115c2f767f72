"""Worker process for the 2-process jax.distributed test.

Usage: python _distributed_worker.py PORT PROCESS_ID NUM_PROCESSES OUTDIR

Each process brings 4 virtual CPU devices into one 8-device global runtime,
renders the same frame SPMD, and dumps its gathered canvas for the parent
test to compare.
"""
import os
import sys


def main():
    port, pid, nproc, outdir = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")

    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # distributed is import-light by design; everything else (which builds
    # device arrays at import time) must wait until after initialize().
    from raytracingweekend_tpu.parallel import distributed

    distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())

    from raytracingweekend_tpu.models.scenes import make_scene

    scene = make_scene("dielectric", 1.0)
    img = distributed.render_distributed(scene, jax.random.key(0),
                                         32, 32, 8, max_depth=8, sp=2)
    np.save(os.path.join(outdir, f"canvas_{pid}.npy"), img)
    print(f"worker {pid} wavefront ok", flush=True)


if __name__ == "__main__":
    main()
