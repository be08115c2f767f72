"""One jax.profiler trace of the flagship render, reduced to device busy /
idle share and the kernels that take the time.

    python tools/profile_flagship.py [--nx 1200 --ny 800] [--launches 2]
                                     [--dir chiprun_out/profile]

Warms up (compiles) random_balls at the given size through render(), then
traces `--launches` launches of 8 spp inside a TraceAnnotation named
"flagship_window", and reduces the trace: for each device plane, the union
of its op intervals over that window (busy share; idle = 1 - busy), the
ops by total time and by count (a kernel that runs once per while-loop
iteration gives the iterations per launch). Prints the device and power
limit first and one JSON line last.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WINDOW = "flagship_window"


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, launches: int, top: int = 12) -> dict:
    """Busy/idle share and op totals of each device plane of an
    .xplane.pb, over the host span named WINDOW."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    window = None
    for plane in data.planes:
        for line in plane.lines:
            for ev in line.events:
                if ev.name == WINDOW:
                    window = (ev.start_ns, ev.end_ns)
    assert window is not None, f"no {WINDOW} span in {path}"
    w0, w1 = window
    out = {"window_s": (w1 - w0) / 1e9, "planes": {}}
    for plane in data.planes:
        if "/device:" not in plane.name:
            continue
        res = {"lines": {}}
        names = [line.name for line in plane.lines]
        # op-level line: "XLA Ops" where the plugin writes one, else the
        # CUDA stream lines
        op_lines = (["XLA Ops"] if "XLA Ops" in names
                    else [n for n in names if n.startswith("Stream")])
        evs = []
        for line in plane.lines:
            these = [e for e in line.events
                     if e.end_ns > w0 and e.start_ns < w1]
            res["lines"][line.name] = len(these)
            if line.name in op_lines:
                evs += these
        if evs:
            busy = _union_ns((max(e.start_ns, w0), min(e.end_ns, w1))
                             for e in evs)
            tot, cnt = defaultdict(float), defaultdict(int)
            for e in evs:
                tot[e.name] += e.duration_ns / 1e9
                cnt[e.name] += 1
            res["busy_s"] = busy / 1e9
            res["idle_share"] = 1.0 - busy / (w1 - w0)
            res["op_seconds"] = sum(tot.values())
            res["top_by_time"] = sorted(tot.items(), key=lambda kv: -kv[1])[
                :top]
            res["top_by_count_per_launch"] = [
                (k, v / launches) for k, v in
                sorted(cnt.items(), key=lambda kv: -kv[1])[:top]]
        out["planes"][plane.name] = res
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=1200)
    ap.add_argument("--ny", type=int, default=800)
    ap.add_argument("--spl", type=int, default=8)
    ap.add_argument("--launches", type=int, default=2)
    ap.add_argument("--max-depth", type=int, default=50)
    ap.add_argument("--mode", default="regen")
    ap.add_argument("--dir", default=os.path.join("chiprun_out", "profile"))
    args = ap.parse_args()

    import jax
    from raytracingweekend_tpu.models.scenes import make_scene
    from raytracingweekend_tpu.render import RenderStats, render
    from raytracingweekend_tpu.utils import device
    from raytracingweekend_tpu.utils.compile_cache import enable_compile_cache
    from raytracingweekend_tpu.utils.config import RenderConfig

    enable_compile_cache()
    info = device.describe()
    print(f"device: {info} | {device.nvidia_smi_line()}", flush=True)
    scene = make_scene("random_balls", args.nx / args.ny)

    def cfg(spp, seed):
        return RenderConfig(nx=args.nx, ny=args.ny, spp=spp,
                            max_depth=args.max_depth,
                            samples_per_launch=args.spl, seed=seed,
                            loop_mode=args.mode)

    # compile the traced function: with stats, "while" runs
    # render_chunk_with_stats ("regen"/"tiled" report segments anyway)
    render(scene, cfg(args.spl, 0), stats=RenderStats())
    from raytracingweekend_tpu import render as render_mod
    chunk = {"regen": render_mod.render_chunk_regen,
             "tiled": render_mod.render_chunk_tiled}.get(
                 args.mode, render_mod.render_chunk_with_stats)
    mem = chunk.lower(scene, jax.random.key(0), args.nx, args.ny, args.spl,
                      args.max_depth).compile().memory_analysis()
    mem = {k: getattr(mem, k) for k in dir(mem) if k.endswith("in_bytes")}
    print(f"launch program memory: {mem}", flush=True)
    stats = RenderStats()
    with jax.profiler.trace(args.dir):
        with jax.profiler.TraceAnnotation(WINDOW):
            render(scene, cfg(args.spl * args.launches, 1), stats=stats)
    paths = sorted(glob.glob(os.path.join(args.dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    res = reduce_trace(paths[-1], args.launches)
    res.update(memory=mem, segments=stats.segments,
               segments_per_s=stats.rays_per_s,
               mode=args.mode, nx=args.nx, ny=args.ny, spl=args.spl,
               launches=args.launches, device=info)
    for name, p in res["planes"].items():
        if "idle_share" in p:
            print(f"{name}: busy {p['busy_s']:.4f} s of window "
                  f"{res['window_s']:.4f} s, idle share "
                  f"{p['idle_share']:.4f}", flush=True)
            for op, s in p["top_by_time"]:
                print(f"  {s:9.5f} s  {op}")
            for op, c in p["top_by_count_per_launch"][:5]:
                print(f"  {c:9.1f} /launch  {op}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
