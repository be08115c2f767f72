"""Closest-hit benchmark: the dense XLA sphere scan vs the skip-link BVH.

Times `geometry._hit_spheres_xla` (every (ray, sphere) pair, fused by XLA
into the min/argmin reduction of each 256-sphere block) and
`bvh.hit_spheres_bvh` on the sphere tables of random_balls (485 spheres),
random_balls_large (3.6k) and random_balls_huge (14.4k), static and moving,
with camera rays of that scene. Reports rays/s and the dense scan's share of
the fp32 peak (FLOPS_PER_PAIR operations per pair over the card's
non-tensor fp32 rate). Prints the device and power limit first.

    python tools/bvh_bench.py [--rays 1048576] [--out results.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# fp32 operations per (ray, sphere) pair in _sphere_candidate_t plus the
# running reduction: oc 3, b 5, c 6, discriminant 3, sqrt 1 and its guard
# 2, the two roots 6, root select 2, validity 4, mask 1, min/argmin 2.
# Motion adds the time fraction 2 and the moved centre 6.
FLOPS_PER_PAIR = {False: 35, True: 43}
# Published non-tensor fp32 peak by device_kind (NVIDIA H100 SXM data
# sheet, 700 W).
FP32_PEAK = {"NVIDIA H100 80GB HBM3": 67e12}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--scenes",
                    default="random_balls,random_balls_large,"
                            "random_balls_huge")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--no-bvh", action="store_true")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from raytracingweekend_tpu.models.scenes import make_scene
    from raytracingweekend_tpu.ops import camera, geometry
    from raytracingweekend_tpu.ops.bvh import build_sphere_bvh, hit_spheres_bvh
    from raytracingweekend_tpu.utils import device
    from raytracingweekend_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    info = device.describe()
    print(f"device: {info} | {device.nvidia_smi_line()}", flush=True)
    peak = FP32_PEAK.get(info["kind"])
    N = args.rays

    def timed(fn):
        """(first call incl. compile, steady seconds per call)"""
        t0 = time.perf_counter()
        fn()[0].block_until_ready()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.repeats):
            out = fn()
        out[0].block_until_ready()
        return first, (time.perf_counter() - t0) / args.repeats

    for name in args.scenes.split(","):
        scene = make_scene(name, 1.5)
        k_u, k_v, k_c, k_m = jax.random.split(jax.random.key(0), 4)
        o, d, tm = camera.get_rays(k_c, scene.camera,
                                   jax.random.uniform(k_u, (N,)),
                                   jax.random.uniform(k_v, (N,)))
        base = scene.spheres
        n_real = int(base.active.sum())
        lift = jax.random.uniform(k_m, (base.count(), 1)) * jnp.array(
            [0.0, 0.5, 0.0])                     # book-1 style bounce
        for moving in (False, True):
            sph = base.replace(center1=base.center0 + lift) if moving \
                else base.replace(center1=base.center0)
            rows = []
            dense = jax.jit(lambda o, d, tm, s, mv=moving:
                            geometry._hit_spheres_xla(o, d, tm, 0.001, s, mv))
            first, dt = timed(lambda: dense(o, d, tm, sph))
            flops = N * sph.count() * FLOPS_PER_PAIR[moving]
            rows.append(dict(path="xla-dense", seconds=dt, rays_per_s=N / dt,
                             first_call_s=first,
                             tflops=flops / dt / 1e12,
                             fp32_peak_share=(flops / dt / peak
                                              if peak else None)))
            if not args.no_bvh:
                tree = build_sphere_bvh(sph)
                walk = jax.jit(lambda o, d, tm, s, t, mv=moving:
                               hit_spheres_bvh(o, d, tm, 0.001, s, t, mv))
                first, dt = timed(lambda: walk(o, d, tm, sph, tree))
                rows.append(dict(path="bvh-skiplink", seconds=dt,
                                 rays_per_s=N / dt, first_call_s=first))
            for r in rows:
                r.update(scene=name, spheres=n_real,
                         table_rows=sph.count(), moving=moving, rays=N,
                         device=info)
                share = r.get("fp32_peak_share")
                print(f"{name:18s} S={n_real:6d} moving={moving!s:5s} "
                      f"{r['path']:12s} {r['seconds'] * 1e3:9.3f} ms "
                      f"{r['rays_per_s'] / 1e6:10.2f} M rays/s (first call "
                      f"{r['first_call_s']:.2f} s)"
                      + (f"  {r['tflops']:.2f} TFLOP/s, fp32 peak share "
                         f"{share:.3f}" if share is not None else ""),
                      flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
