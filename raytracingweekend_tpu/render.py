"""Top-level rendering API + CLI.

Replaces the reference's main() render loop (reference:
RayTracingWeekend.cpp:195-289): the triple-nested PPL parallel_for over
rows x cols x samples becomes one jitted wavefront launch per sample chunk —
every (pixel, sample) is a ray in a flat batch, jittered exactly like
cpp:227-228, traced, and box-filter accumulated (cpp:235-241). Accumulation
runs in the native C++ framebuffer (native/rtw_native.cpp) when built, with
checkpoint/resume the reference lacks (its canvas lives in RAM until the
final PPM dump, cpp:210,247); gamma-2 and PPM/PNG writing live in
utils.image / the native codecs.

Usage:
    python -m raytracingweekend_tpu.render --scene cornell_box --nx 400 \
        --ny 400 --spp 64 --out cornell.png
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .models import scene_types as st
from .models.scenes import make_scene, SCENES
from .ops import camera as camera_mod
from .ops import sampling
from .ops.integrator import (trace, trace_regenerative, trace_tiled,
                             trace_with_stats)
from .utils.compile_cache import enable_compile_cache
from .utils.config import LOOP_MODES, RenderConfig
from .utils import image as image_mod
from . import native


@partial(jax.jit, static_argnames=("nx", "ny", "chunk_spp", "max_depth",
                                   "mode"))
def render_chunk(scene: st.Scene, key, nx: int, ny: int, chunk_spp: int,
                 max_depth: int = 100, mode: str = "while"):
    """Trace chunk_spp jittered samples for every pixel; returns the radiance
    *sum* (ny, nx, 3) over the chunk (row 0 = image bottom, like the
    reference canvas at cpp:247)."""
    n_pix = nx * ny
    n_rays = n_pix * chunk_spp
    pix = jnp.arange(n_pix, dtype=jnp.int32)
    i = jnp.tile(pix % nx, chunk_spp)
    j = jnp.tile(pix // nx, chunk_spp)

    k_u, k_v, k_cam, k_trace = jax.random.split(key, 4)
    # Jittered subpixel sampling (cpp:227-228).
    u = (i.astype(jnp.float32) + sampling.uniform(k_u, (n_rays,))) / nx
    v = (j.astype(jnp.float32) + sampling.uniform(k_v, (n_rays,))) / ny

    o, d, t = camera_mod.get_rays(k_cam, scene.camera, u, v)
    rad = trace(k_trace, o, d, t, scene, max_depth=max_depth, mode=mode)
    return rad.reshape(chunk_spp, ny, nx, 3).sum(axis=0)


@partial(jax.jit, static_argnames=("nx", "ny", "chunk_spp", "max_depth"))
def render_chunk_with_stats(scene: st.Scene, key, nx: int, ny: int,
                            chunk_spp: int, max_depth: int = 100):
    """render_chunk + the number of path segments traced (the rays/s
    numerator)."""
    n_pix = nx * ny
    n_rays = n_pix * chunk_spp
    pix = jnp.arange(n_pix, dtype=jnp.int32)
    i = jnp.tile(pix % nx, chunk_spp)
    j = jnp.tile(pix // nx, chunk_spp)
    k_u, k_v, k_cam, k_trace = jax.random.split(key, 4)
    u = (i.astype(jnp.float32) + sampling.uniform(k_u, (n_rays,))) / nx
    v = (j.astype(jnp.float32) + sampling.uniform(k_v, (n_rays,))) / ny
    o, d, t = camera_mod.get_rays(k_cam, scene.camera, u, v)
    rad, segs = trace_with_stats(k_trace, o, d, t, scene, max_depth=max_depth)
    return rad.reshape(chunk_spp, ny, nx, 3).sum(axis=0), segs


@partial(jax.jit, static_argnames=("nx", "ny", "chunk_spp", "max_depth",
                                   "n_slots"))
def render_chunk_regen(scene: st.Scene, key, nx: int, ny: int,
                       chunk_spp: int, max_depth: int = 100,
                       n_slots: int = 1 << 19):
    """Radiance *sum* over chunk_spp samples/pixel via the path-regenerative
    wavefront (see integrator.trace_regenerative) — the fast forward path.
    Returns ((ny, nx, 3) sums, segment count)."""
    return trace_regenerative(key, scene, nx, ny, chunk_spp,
                              max_depth=max_depth, n_slots=n_slots)


@partial(jax.jit, static_argnames=("nx", "ny", "chunk_spp", "max_depth",
                                   "n_slots"))
def render_chunk_tiled(scene: st.Scene, key, nx: int, ny: int,
                       chunk_spp: int, max_depth: int = 100,
                       n_slots: int = 1 << 19):
    """Radiance sums via the scatter-free per-pixel-slot wavefront
    (integrator.trace_tiled). Returns ((ny, nx, 3) sums, segment count)."""
    return trace_tiled(key, scene, nx, ny, chunk_spp, max_depth=max_depth,
                       n_slots=n_slots)


@dataclass
class RenderStats:
    """Per-render observability (SURVEY.md §5 metrics rebuild): rays/s,
    spp progress, and a per-pixel Welford variance estimate over launch
    means (the MC convergence signal the reference never had)."""
    spp_done: int = 0
    segments: float = 0.0
    trace_seconds: float = 0.0
    # Welford accumulators over per-launch mean images.
    _n: int = 0
    _mean: np.ndarray | None = None
    _m2: np.ndarray | None = None

    @property
    def rays_per_s(self) -> float:
        return self.segments / self.trace_seconds if self.trace_seconds else 0.0

    def update_variance(self, launch_mean: np.ndarray):
        """Welford update with one launch's per-pixel mean radiance."""
        self._n += 1
        if self._mean is None:
            self._mean = launch_mean.astype(np.float64)
            self._m2 = np.zeros_like(self._mean)
            return
        delta = launch_mean - self._mean
        self._mean += delta / self._n
        self._m2 += delta * (launch_mean - self._mean)

    @property
    def pixel_variance(self) -> float:
        """Mean per-pixel variance of a single launch estimate (0 until two
        launches have completed)."""
        if self._n < 2:
            return 0.0
        return float((self._m2 / (self._n - 1)).mean())

    @property
    def mean_std_error(self) -> float:
        """Standard error of the accumulated per-pixel mean."""
        if self._n < 2:
            return 0.0
        return float(np.sqrt(self.pixel_variance / self._n))


def render(scene: st.Scene, cfg: RenderConfig, *, progress: bool = False,
           stats: RenderStats | None = None, metrics_path: str | None = None):
    """Render to a linear-radiance canvas (ny, nx, 3) float32, averaged over
    cfg.spp samples. Accumulation is chunked over samples so HBM stays
    bounded; the RNG is folded per launch so results are seed-deterministic
    and checkpoint/resume-safe.

    With cfg.checkpoint set, accumulation state (radiance sums + spp count)
    persists in the native framebuffer checkpoint; re-running the same config
    resumes where it left off. Each launch's RNG key depends only on the
    launch index, so a resumed render traces the same samples as an
    uninterrupted one. Its pixels agree to float round-off, not bitwise:
    "regen" deposits with scatter-add, whose summation order on a GPU
    follows its atomics and varies from run to run.
    """
    if cfg.loop_mode not in LOOP_MODES:
        raise ValueError(f"loop_mode {cfg.loop_mode!r} not in {LOOP_MODES}")
    key = jax.random.key(cfg.seed)
    chunk = min(cfg.samples_per_launch, cfg.spp)
    want_stats = stats is not None
    collect = stats if want_stats else RenderStats()

    fb = None
    acc = None
    done = 0
    if cfg.checkpoint and not native.available():
        raise RuntimeError(
            "cfg.checkpoint is set but the native runtime is unavailable "
            "(build it with `make -C native`); refusing to render without "
            "the requested checkpointing")
    if cfg.checkpoint and native.available():
        import os
        if os.path.exists(cfg.checkpoint):
            fb = native.Framebuffer.load(cfg.checkpoint)
            assert (fb.w, fb.h) == (cfg.nx, cfg.ny), (
                f"checkpoint is {fb.w}x{fb.h}, config wants "
                f"{cfg.nx}x{cfg.ny}")
            done = fb.spp
        else:
            fb = native.Framebuffer(cfg.nx, cfg.ny)
    elif native.available():
        fb = native.Framebuffer(cfg.nx, cfg.ny)
    else:
        acc = np.zeros((cfg.ny, cfg.nx, 3), np.float32)

    assert done % chunk == 0 or done >= cfg.spp, (
        "checkpoint spp not aligned with samples_per_launch")
    launch = done // chunk
    while done < cfg.spp:
        this = min(chunk, cfg.spp - done)
        t0 = time.perf_counter()
        if cfg.loop_mode in ("regen", "tiled"):
            chunk_fn = {"regen": render_chunk_regen,
                        "tiled": render_chunk_tiled}[cfg.loop_mode]
            part, segs = chunk_fn(
                scene, jax.random.fold_in(key, launch), cfg.nx, cfg.ny, this,
                cfg.max_depth)
            part = np.asarray(part)
            collect.segments += float(segs)
        elif want_stats:
            part, segs = render_chunk_with_stats(
                scene, jax.random.fold_in(key, launch), cfg.nx, cfg.ny, this,
                cfg.max_depth)
            part = np.asarray(part)
            collect.segments += float(segs)
        else:
            part = np.asarray(render_chunk(
                scene, jax.random.fold_in(key, launch), cfg.nx, cfg.ny, this,
                cfg.max_depth, cfg.loop_mode))
        launch_secs = time.perf_counter() - t0
        collect.trace_seconds += launch_secs
        if want_stats or metrics_path:
            # image-sized Welford pass; skip it (and its host transfer)
            # unless someone is actually consuming the statistics
            collect.update_variance(part / this)
        if fb is not None:
            fb.add(part, this)
        else:
            acc += part
        done += this
        launch += 1
        collect.spp_done = done
        if cfg.checkpoint and fb is not None:
            fb.save(cfg.checkpoint)
        if metrics_path:
            import json
            with open(metrics_path, "a") as mf:
                mf.write(json.dumps({
                    "launch": launch - 1, "spp_done": done,
                    "launch_seconds": round(launch_secs, 4),
                    "segments": collect.segments,
                    "rays_per_s": collect.rays_per_s,
                    "pixel_variance": collect.pixel_variance,
                    "mean_std_error": collect.mean_std_error,
                }) + "\n")
        if progress:
            rate = (f", {collect.rays_per_s / 1e6:.1f} M rays/s"
                    if want_stats else "")
            print(f"  spp {done}/{cfg.spp}{rate}", flush=True)

    if fb is not None:
        total = fb.spp
        out = fb.accumulator() / max(total, 1)
        fb.close()
        return out
    return acc / cfg.spp


def main(argv=None):
    """CLI entry. Returns the linear-radiance canvas it wrote."""
    enable_compile_cache()
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="cornell_box", choices=sorted(SCENES))
    p.add_argument("--nx", type=int, default=400)
    p.add_argument("--ny", type=int, default=400)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--max-depth", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples-per-launch", type=int, default=8)
    p.add_argument("--out", default="out.png")
    p.add_argument("--checkpoint", default=None,
                   help="framebuffer checkpoint path; rerun to resume")
    p.add_argument("--mode", default="regen", choices=LOOP_MODES,
                   help="integrator loop: regen = global path "
                        "regeneration, tiled = scatter-free per-pixel "
                        "slots, while/scan = lockstep")
    p.add_argument("--stats", action="store_true",
                   help="report rays/s per launch")
    p.add_argument("--normals", action="store_true",
                   help="RenderType::Normal debug shading (cpp:135-136)")
    p.add_argument("--debug-ray", action="store_true",
                   help="DEBUG_RAY analogue (cpp:38-43): trace one "
                        "center-pixel ray at depth 1 and print its radiance")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the render into "
                        "DIR (view with TensorBoard / xprof)")
    p.add_argument("--metrics", default=None, metavar="OUT.JSONL",
                   help="append one JSON line of metrics per launch "
                        "(spp, rays/s, pixel variance, std error)")
    args = p.parse_args(argv)

    cfg = RenderConfig(nx=args.nx, ny=args.ny, spp=args.spp,
                       max_depth=args.max_depth, seed=args.seed,
                       samples_per_launch=args.samples_per_launch,
                       checkpoint=args.checkpoint, loop_mode=args.mode)
    scene = make_scene(args.scene, cfg.aspect)
    if args.normals:
        scene = scene.replace(render_type=st.RENDER_NORMAL)

    if args.debug_ray:
        key = jax.random.key(cfg.seed)
        u = jnp.asarray([0.5], jnp.float32)
        v = jnp.asarray([0.5], jnp.float32)
        k_cam, k_tr = jax.random.split(key)
        o, d, t = camera_mod.get_rays(k_cam, scene.camera, u, v)
        rad = trace(k_tr, o, d, t, scene, max_depth=1)
        print(f"debug ray: origin={np.asarray(o[0])} dir={np.asarray(d[0])} "
              f"radiance={np.asarray(rad[0])}")
        return

    stats = RenderStats() if (args.stats or args.metrics) else None
    t0 = time.perf_counter()
    if args.profile:
        with jax.profiler.trace(args.profile):
            canvas = render(scene, cfg, progress=True, stats=stats,
                            metrics_path=args.metrics)
    else:
        canvas = render(scene, cfg, progress=True, stats=stats,
                        metrics_path=args.metrics)
    trace_ms = (time.perf_counter() - t0) * 1000.0

    t0 = time.perf_counter()
    out01 = image_mod.postprocess(canvas)
    if args.out.endswith(".ppm"):
        image_mod.write_ppm(out01, args.out)
    else:
        image_mod.write_png(out01, args.out)
    write_ms = (time.perf_counter() - t0) * 1000.0

    # Same self-report as cpp:279-280.
    print(f"Trace: {trace_ms:.0f}ms")
    print(f"Write: {write_ms:.0f}ms")
    if stats is not None:
        print(f"Rays/s: {stats.rays_per_s:.3e} "
              f"({stats.segments:.3e} segments)")
        print(f"Pixel variance: {stats.pixel_variance:.3e} "
              f"(mean std error {stats.mean_std_error:.3e})")
    print(f"wrote {args.out}")
    return canvas


if __name__ == "__main__":
    main()
