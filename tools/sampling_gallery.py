"""Regenerate the diffuse-sampling comparison gallery.

The reference ships RayTracingWeekend/Sampling/*.png comparing its
historical lambertian sampling strategies (material.h:83-107); this script
renders the same comparison with ours: one Cornell-box frame per strategy
at equal sample count, so the noise difference (naive sampling vs cosine
pdf vs light-mixture MIS) is visible side by side.

    python tools/sampling_gallery.py [--nx 200] [--spp 64] [--out docs/gallery]
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

STRATEGIES = ("unit_sphere", "unit_vector", "hemisphere", "onb",
              "light_only", "mis")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=200)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--scene", default="cornell_box")
    ap.add_argument("--out", default="docs/gallery")
    ap.add_argument("--mode", default="regen")
    ap.add_argument("--platform", default="cpu",
                    help="jax platform (default cpu: doc renders should "
                         "not contend with chip jobs; pass 'default' "
                         "to keep the ambient backend)")
    args = ap.parse_args()

    if args.platform != "default":
        import jax
        jax.config.update("jax_platforms", args.platform)

    from raytracingweekend_tpu.models.scenes import make_scene
    from raytracingweekend_tpu.render import render
    from raytracingweekend_tpu.utils.config import RenderConfig
    from raytracingweekend_tpu.utils import image as image_mod

    os.makedirs(args.out, exist_ok=True)
    for strategy in STRATEGIES:
        scene = make_scene(args.scene, 1.0).replace(
            lambertian_strategy=strategy)
        cfg = RenderConfig(nx=args.nx, ny=args.nx, spp=args.spp,
                           max_depth=50, seed=5,
                           samples_per_launch=min(args.spp, 64),
                           loop_mode=args.mode)
        canvas = render(scene, cfg)
        out = os.path.join(args.out,
                           f"sampling_{STRATEGIES.index(strategy)}_"
                           f"{strategy}.png")
        image_mod.write_png(image_mod.postprocess(canvas), out)
        print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
