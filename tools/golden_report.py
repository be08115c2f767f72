"""Full golden parity report: every oracle golden at its own resolution and
spp, through render(), under the gates of utils/goldens.py.

    python tools/golden_report.py [--mode regen] [--out report.md]

Hours on a CPU; minutes on a GPU (chip_smoke.py runs the same comparison
as one of its phases). Exits non-zero when a scene fails.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write a markdown table")
    ap.add_argument("--mode", default="regen",
                    choices=("regen", "tiled", "while"))
    args = ap.parse_args()

    from raytracingweekend_tpu.models.scenes import make_scene
    from raytracingweekend_tpu.render import render
    from raytracingweekend_tpu.utils import device, goldens as G
    from raytracingweekend_tpu.utils.config import RenderConfig

    info = device.describe()
    card = device.nvidia_smi_line()
    print(f"device: {info} | {card}", flush=True)
    rows = []
    for name in sorted(G.GOLDENS):
        golden = G.load_golden(G.GOLDENS[name])
        ny, nx, _ = golden.shape
        spp = G.golden_spp(G.GOLDENS[name])
        cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=50,
                           samples_per_launch=min(spp, 512), seed=7,
                           loop_mode=args.mode)
        ours = np.asarray(render(make_scene(name, nx / ny), cfg))
        par = G.full_parity(golden, ours, spp)
        blk = G.blockwise(golden, ours, spp)
        ok = par["passed"] and blk["passed"]
        rows.append((name, nx, ny, spp, par, blk, ok))
        print(f"{name}: mean_rel={par['mean_rel']:.4f} z={par['mean_z']:.2f} "
              f"frac_ok={par['frac_ok']:.4f} worst_block="
              f"{blk['worst_ratio']:.2f} {'PASS' if ok else 'FAIL'}",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("# Golden parity report\n\n")
            f.write(f"- device: {info['kind']} ({card}); mode {args.mode}\n")
            f.write(f"- gates: mean rel err < {G.MEAN_REL_TOL}, mean z < "
                    f"{G.MEAN_Z_TOL}, pixels ok > {G.PIXEL_FRAC_OK}, "
                    f"blocks within 0.03 + {G.BLOCK_SIGMAS} sigma\n\n")
            f.write("| scene | res | spp | mean rel err | z | pixels ok | "
                    "worst block | result |\n|---|---|---|---|---|---|---|---|\n")
            for name, nx, ny, spp, par, blk, ok in rows:
                f.write(f"| {name} | {nx}x{ny} | {spp} | "
                        f"{par['mean_rel']:.4f} | {par['mean_z']:.2f} | "
                        f"{par['frac_ok']:.4f} | {blk['worst_ratio']:.2f} | "
                        f"{'PASS' if ok else 'FAIL'} |\n")
    return 0 if all(r[-1] for r in rows) else 1


if __name__ == "__main__":
    raise SystemExit(main())
