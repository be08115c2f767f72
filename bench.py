"""Benchmark: path segments/s on the book-1 final scene through render().

Workload: random_balls (~485 spheres, motion blur) at 1200x800, max depth
50 — the book-1 final-render geometry (Scene/scene.h:98-174) — traced by
the path `render()` serves by default ("regen"), launch by launch, with
each launch's image pulled to the host and accumulated. The metric counts
*path segments traced per second* (every bounce iteration counts its active
rays); compile time is reported separately as set-up.

Needs a GPU: it exits non-zero when JAX finds none. Prints the device on an
earlier line and exactly one JSON object as its last line.

    python bench.py
"""
from __future__ import annotations

import json
import sys
import time

from raytracingweekend_tpu.models.scenes import make_scene
from raytracingweekend_tpu.render import RenderStats, render
from raytracingweekend_tpu.utils import device
from raytracingweekend_tpu.utils.compile_cache import enable_compile_cache
from raytracingweekend_tpu.utils.config import RenderConfig

NX, NY = 1200, 800
MAX_DEPTH = 50
SPP_PER_LAUNCH = 8
TIMED_LAUNCHES = 8


def main():
    enable_compile_cache()
    info = device.describe()
    print(f"device: {info} | {device.nvidia_smi_line()}", flush=True)
    if info["platform"] != "gpu":
        print(json.dumps({"ok": False, "device": info,
                          "error": "no GPU backend"}))
        sys.exit(1)

    scene = make_scene("random_balls", NX / NY)
    cfg = RenderConfig(nx=NX, ny=NY, spp=SPP_PER_LAUNCH, max_depth=MAX_DEPTH,
                       samples_per_launch=SPP_PER_LAUNCH)
    t0 = time.perf_counter()
    render(scene, cfg)                         # compile + one launch
    compile_s = time.perf_counter() - t0

    stats = RenderStats()
    timed = RenderConfig(nx=NX, ny=NY, spp=SPP_PER_LAUNCH * TIMED_LAUNCHES,
                         max_depth=MAX_DEPTH,
                         samples_per_launch=SPP_PER_LAUNCH, seed=1)
    render(scene, timed, stats=stats)
    print(json.dumps({
        "metric": "segments_per_s",
        "value": stats.rays_per_s,
        "unit": "path segments/s",
        "segments": stats.segments,
        "trace_seconds": stats.trace_seconds,
        "launches": TIMED_LAUNCHES,
        "first_launch_seconds": compile_s,
        "device": info,
    }))


if __name__ == "__main__":
    main()
