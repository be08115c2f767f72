"""Inverse-rendering step time: the wavefront value_and_grad.

    python tools/grad_bench.py [--scene cornell_box] [--nx 128 --ny 128 --spp 32]

Times one jitted `value_and_grad` of the pixel L2 loss (grad.l2_loss, the
"scan"-mode integrator) w.r.t. the scene's texture colors — the step
`grad.fit_scene_params` runs — with a fresh key per step, synced with
block_until_ready. Compile is reported separately. Prints the device and
power limit first and one JSON line last.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cornell_box")
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--ny", type=int, default=128)
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()

    import jax
    from raytracingweekend_tpu.grad import l2_loss, render_diff
    from raytracingweekend_tpu.models.scenes import make_scene
    from raytracingweekend_tpu.utils import device
    from raytracingweekend_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    info = device.describe()
    print(f"device: {info} | {device.nvidia_smi_line()}", flush=True)
    scene = make_scene(args.scene, args.nx / args.ny)
    key = jax.random.key(0)
    shape = (args.nx, args.ny, args.spp, args.max_depth)
    target = render_diff(scene, key, *shape)

    @jax.jit
    def step(colors, k):
        def loss(c):
            sc = scene.replace(textures=scene.textures.replace(color=c))
            return l2_loss(sc, target, k, *shape)
        return jax.value_and_grad(loss)(colors)

    colors = scene.textures.color * 0.5
    t0 = time.perf_counter()
    jax.block_until_ready(step(colors, key))
    compile_s = time.perf_counter() - t0
    keys = [jax.random.fold_in(key, r + 1) for r in range(args.repeats)]
    t0 = time.perf_counter()
    for k in keys:
        out = step(colors, k)
    jax.block_until_ready(out)
    step_s = (time.perf_counter() - t0) / args.repeats
    row = dict(scene=args.scene, nx=args.nx, ny=args.ny, spp=args.spp,
               max_depth=args.max_depth, first_step_s=compile_s,
               step_s=step_s, device=info)
    print(f"{args.scene} {args.nx}x{args.ny}x{args.spp} spp depth "
          f"{args.max_depth}: value_and_grad {step_s * 1e3:.2f} ms/step "
          f"(first call {compile_s:.2f} s)", flush=True)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
