"""Smoke test of the renderer on a GPU, through the entry points users call.

    python chip_smoke.py               # one card: phases 1-5
    python chip_smoke.py --multi-gpu   # four cards: the multi-device phase

Phases (one process, every phase must pass):
  1. device     — JAX's default backend is a GPU; no fallback.
  2. flagship   — `render.main` (the CLI) on random_balls 1200x800, 32 spp,
                  8 spp per launch, max depth 50: first-launch seconds
                  (compile) and steady segments/s; canvas finite, PNG written.
  3. checkpoint — the reference's default job (cornell_box 400x400, 64 spp,
                  max depth 100) stopped half-way with --checkpoint and
                  resumed, vs an uninterrupted render of the same seed.
  4. parity     — the 7 oracle goldens at their own size and spp under the
                  full-mode gates of utils/goldens.py, and the loop modes
                  regen / tiled / while agreeing on cornell_box and
                  random_balls at 64x64.
  5. gradients  — grad.render_diff gradients (sphere radius, albedo) vs
                  central finite differences, then 5 Adam steps of
                  grad.fit_scene_params at 128x128x32 spp: the loss falls.
  --multi-gpu   — parallel.mesh.render_sharded at (dp, sp) = (4, 1) and
                  (2, 2), parallel.distributed.render_distributed over the
                  4 local cards, each vs a one-card render; the sharded
                  value_and_grad step vs the same estimator on one card.

Prints the card (nvidia-smi name and power limit), then one line per
measurement, and as its last line one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Exits non-zero (with "ok": false) when a phase fails or no GPU is found.
Outputs (PNGs, metrics) go to chiprun_out/smoke/.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "smoke")

# A resumed checkpoint traces the same samples as an uninterrupted render;
# "regen" deposits them with scatter-add, whose summation order on a GPU
# follows its atomics, so pixels agree to float32 round-off of a few
# hundred additions, not bitwise.
RESUME_RTOL = 1e-4
RESUME_ATOL = 1e-5
# Finite-difference checks (central FD with a fixed RNG key, so the
# estimator is deterministic): tolerances of tests/test_grad.py.
FD_RADIUS = dict(eps=5e-2, rtol=0.15, atol=2e-6)
FD_ALBEDO = dict(eps=1e-2, rtol=5e-2, atol=1e-4)
# Sharded vs one-card value_and_grad: same estimator and keys; only the
# order of the psum reductions differs.
SHARDED_GRAD_RTOL = 1e-4
SHARDED_GRAD_ATOL = 1e-6


class SmokeFailure(AssertionError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase_device() -> dict:
    from raytracingweekend_tpu.utils import device
    info = device.describe()
    check(info["platform"] == "gpu",
          f"JAX default backend is {info['platform']} ({info['kind']}), "
          f"not a GPU")
    return info


def phase_flagship(out_dir: str, nx: int = 1200, ny: int = 800,
                   spp: int = 32, spl: int = 8, max_depth: int = 50) -> dict:
    from raytracingweekend_tpu import render as render_mod

    metrics = os.path.join(out_dir, "flagship_metrics.jsonl")
    png = os.path.join(out_dir, "flagship.png")
    for path in (metrics, png):
        if os.path.exists(path):
            os.remove(path)
    canvas = render_mod.main([
        "--scene", "random_balls", "--nx", str(nx), "--ny", str(ny),
        "--spp", str(spp), "--samples-per-launch", str(spl),
        "--max-depth", str(max_depth), "--stats", "--metrics", metrics,
        "--out", png])
    check(canvas.shape == (ny, nx, 3), f"canvas shape {canvas.shape}")
    check(np.isfinite(canvas).all(), "flagship canvas has non-finite values")
    check(canvas.mean() > 0.05, f"flagship canvas is black ({canvas.mean()})")
    check(os.path.getsize(png) > 0, "flagship PNG not written")
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    check(len(rows) == spp // spl, f"{len(rows)} launches logged")
    segs = np.diff([0.0] + [r["segments"] for r in rows])
    secs = [r["launch_seconds"] for r in rows]
    res = dict(first_launch_s=secs[0], launches=len(rows),
               segments_per_launch=float(segs.mean()),
               canvas_mean=float(canvas.mean()))
    if len(rows) > 1:
        res["steady_segments_per_s"] = float(segs[1:].sum() / sum(secs[1:]))
        res["steady_launch_s"] = float(np.mean(secs[1:]))
    log(f"flagship random_balls {nx}x{ny} {spp} spp ({spl}/launch), depth "
        f"{max_depth}: first launch {secs[0]:.2f} s (compile + run); "
        f"steady {res.get('steady_segments_per_s', float('nan')):.4e} "
        f"segments/s over {len(rows) - 1} launches of "
        f"{res.get('steady_launch_s', float('nan')):.4f} s")
    return res


def phase_checkpoint(out_dir: str, nx: int = 400, ny: int = 400,
                     spp: int = 64, spl: int = 8,
                     max_depth: int = 100) -> dict:
    from raytracingweekend_tpu import native
    from raytracingweekend_tpu import render as render_mod

    check(native.available(), "native runtime unavailable: --checkpoint "
          "needs it (make -C native)")
    ckpt = os.path.join(out_dir, "cornell.ckpt")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    base = ["--scene", "cornell_box", "--nx", str(nx), "--ny", str(ny),
            "--max-depth", str(max_depth), "--samples-per-launch", str(spl),
            "--seed", "3"]

    def run(name, extra):
        t0 = time.perf_counter()
        img = render_mod.main(base + extra + [
            "--out", os.path.join(out_dir, f"cornell_{name}.png")])
        return img, time.perf_counter() - t0

    full, t_full = run("full", ["--spp", str(spp)])
    half, _ = run("half", ["--spp", str(spp // 2), "--checkpoint", ckpt])
    resumed, _ = run("resumed", ["--spp", str(spp), "--checkpoint", ckpt])
    check(np.isfinite(full).all() and full.mean() > 0.05,
          "cornell canvas empty or non-finite")
    err = np.abs(resumed - full)
    bound = RESUME_ATOL + RESUME_RTOL * np.abs(full)
    check((err <= bound).all(),
          f"resumed render differs from uninterrupted: max err "
          f"{err.max():.3e}, worst ratio {(err / bound).max():.2f}")
    check(not np.allclose(half, full), "half render equals the full one")
    log(f"checkpoint cornell_box {nx}x{ny} {spp} spp depth {max_depth}: "
        f"uninterrupted {t_full:.2f} s; resumed vs uninterrupted max abs "
        f"err {err.max():.3e} (gate {RESUME_ATOL} + {RESUME_RTOL}*|x|)")
    return dict(max_abs_err=float(err.max()), full_seconds=t_full)


def _render(name, nx, ny, spp, max_depth, seed, mode="regen", spl=None):
    from raytracingweekend_tpu.models.scenes import make_scene
    from raytracingweekend_tpu.render import render
    from raytracingweekend_tpu.utils.config import RenderConfig

    cfg = RenderConfig(nx=nx, ny=ny, spp=spp, max_depth=max_depth,
                       samples_per_launch=spl or spp, seed=seed,
                       loop_mode=mode)
    return np.asarray(render(make_scene(name, nx / ny), cfg), np.float64)


def phase_goldens(spp_scale: float = 1.0, names=None) -> dict:
    """Every oracle golden at its own resolution and spp (times
    spp_scale, for tiny CPU runs), under utils.goldens.full_parity and
    blockwise."""
    from raytracingweekend_tpu.utils import goldens as G

    out = {}
    for name in names or sorted(G.GOLDENS):
        fname = G.GOLDENS[name]
        golden = G.load_golden(fname)
        ny, nx, _ = golden.shape
        spp = max(int(G.golden_spp(fname) * spp_scale), 1)
        t0 = time.perf_counter()
        ours = _render(name, nx, ny, spp, 50, seed=7, spl=min(spp, 512))
        dt = time.perf_counter() - t0
        par = G.full_parity(golden, ours, spp)
        blk = G.blockwise(golden, ours, spp)
        out[name] = dict(par, block_worst_ratio=blk["worst_ratio"],
                         block_passed=blk["passed"], seconds=dt)
        log(f"golden {name} {nx}x{ny} {spp} spp: mean rel err "
            f"{par['mean_rel']:.4f} (<{G.MEAN_REL_TOL}), z "
            f"{par['mean_z']:.2f} (<{G.MEAN_Z_TOL}), pixels ok "
            f"{par['frac_ok']:.4f} (>{G.PIXEL_FRAC_OK}), worst block "
            f"{blk['worst_ratio']:.2f} of tol; {dt:.1f} s")
    bad = [n for n, r in out.items()
           if not (r["passed"] and r["block_passed"])]
    check(not bad, f"golden parity failed: {bad}")
    return out


def phase_loop_modes(nx: int = 64, ny: int = 64, spp: int = 64,
                     max_depth: int = 50, n_blocks: int = 8,
                     names=("cornell_box", "random_balls")) -> dict:
    """regen and tiled each agree with the lockstep while loop."""
    from raytracingweekend_tpu.utils.goldens import statistically_equal

    out = {}
    for name in names:
        ref = _render(name, nx, ny, spp, max_depth, seed=11, mode="while")
        for mode in ("regen", "tiled"):
            img = _render(name, nx, ny, spp, max_depth, seed=12, mode=mode)
            res = statistically_equal(img, ref, n_blocks=n_blocks)
            out[f"{name}/{mode}"] = res
            log(f"loop modes {name} {nx}x{ny} {spp} spp: {mode} vs while "
                f"z(mean) {res['z_mean']:.2f}, max z(block) "
                f"{res['z_block_max']:.2f} (gate < 5)")
    bad = [k for k, r in out.items() if not r["passed"]]
    check(not bad, f"loop modes disagree: {bad}")
    return out


def _fd_scene(fov: float, name: str):
    from raytracingweekend_tpu.models import scene_types as st
    from raytracingweekend_tpu.models.builder import SceneBuilder

    b = SceneBuilder()
    b.sphere((0, 0, -2), 1.0, b.lambertian(b.constant((0.5, 0.3, 0.7))))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), fov, 1.0, 0.0, 1.0)
    return b.build(background=st.BG_GRADIENT, name=name)


def _grad_vs_fd(scene, setter, theta0, tol, nx, ny, spp, max_depth=4):
    import jax
    import jax.numpy as jnp
    from raytracingweekend_tpu.grad import render_diff

    key = jax.random.key(0)

    def f(theta):
        return jnp.mean(render_diff(setter(scene, theta), key, nx, ny, spp,
                                    max_depth))

    eps = tol["eps"]
    g = float(jax.grad(f)(theta0))
    fd = float((f(theta0 + eps) - f(theta0 - eps)) / (2 * eps))
    ok = abs(g - fd) <= tol["atol"] + tol["rtol"] * abs(fd)
    return dict(grad=g, fd=fd, passed=bool(ok), **tol)


def phase_gradients(fd_nx: int = 8, fd_ny: int = 8, fd_spp: int = 16,
                    fit_nx: int = 128, fit_ny: int = 128, fit_spp: int = 32,
                    steps: int = 5) -> dict:
    import jax
    import jax.numpy as jnp
    from raytracingweekend_tpu.grad import (fit_scene_params, l2_loss,
                                           render_diff)
    from raytracingweekend_tpu.models.scenes import make_scene

    out = {}
    # Narrow fov keeps every ray inside the sphere's silhouette: visibility
    # is locally constant in the radius, so FD sees only what AD computes.
    sc = _fd_scene(30.0, "fd_radius")
    out["radius"] = _grad_vs_fd(
        sc, lambda s, r: s.replace(spheres=s.spheres.replace(
            radius=s.spheres.radius.at[0].set(r))),
        sc.spheres.radius[0], FD_RADIUS, fd_nx, fd_ny, fd_spp)
    sc = _fd_scene(60.0, "fd_albedo")
    out["albedo"] = _grad_vs_fd(
        sc, lambda s, a: s.replace(textures=s.textures.replace(
            color=s.textures.color.at[0, 0].set(a))),
        sc.textures.color[0, 0], FD_ALBEDO, fd_nx, fd_ny, fd_spp // 2)
    for k, r in out.items():
        log(f"gradient d mean/d {k}: AD {r['grad']:.6e} vs central FD "
            f"{r['fd']:.6e} (eps {r['eps']}, gate {r['atol']} + "
            f"{r['rtol']}*|FD|)")
    check(all(r["passed"] for r in out.values()), f"FD mismatch: {out}")

    # Inverse rendering: recover the Cornell reflectances from a render of
    # the true scene, starting from 0.5x (the light keeps its emission).
    # Each step draws fresh samples, so its loss carries MC noise; the gate
    # compares the loss under the target's own key (noise-free: the true
    # scene re-renders the target exactly) before and after the fit.
    scene = make_scene("cornell_box", fit_nx / fit_ny)
    key = jax.random.key(1)
    target = render_diff(scene, key, fit_nx, fit_ny, fit_spp, 8)
    colors = scene.textures.color
    is_light = colors.max(axis=1, keepdims=True) > 1.0
    start = scene.replace(textures=scene.textures.replace(
        color=jnp.where(is_light, colors, 0.5 * colors)))
    losses, stamps = [], []

    def log_fn(step, loss, gnorm):
        losses.append(loss)
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    fitted, _ = fit_scene_params(
        start, target, get_params=lambda s: s.textures.color,
        set_params=lambda s, p: s.replace(
            textures=s.textures.replace(color=p)),
        postprocess=lambda p: jnp.clip(p, 0.0, None), key=key,
        nx=fit_nx, ny=fit_ny, spp=fit_spp, max_depth=8, steps=steps,
        lr=0.05, log_fn=log_fn)
    first = stamps[0] - t0
    per_step = (float(np.mean(np.diff(stamps))) if len(stamps) > 1
                else float("nan"))
    before, after = (float(l2_loss(sc, target, key, fit_nx, fit_ny,
                                   fit_spp, 8)) for sc in (start, fitted))
    out["fit"] = dict(losses=losses, first_step_s=first, step_s=per_step,
                      loss_before=before, loss_after=after)
    log(f"fit_scene_params cornell_box {fit_nx}x{fit_ny}x{fit_spp} spp, "
        f"depth 8, {steps} Adam steps: step losses "
        f"{[f'{x:.5f}' for x in losses]}; first step {first:.2f} s "
        f"(compile), then {per_step:.4f} s/step; loss under the target's "
        f"key {before:.6f} -> {after:.6f}")
    check(np.isfinite(losses).all() and after < before,
          f"fit loss did not fall: {before} -> {after}")
    return out


def _sharded_reference(scene, target, params, key, set_params, nx, ny, spp,
                       max_depth, dp, sp):
    """The sharded step's estimator on one device: the same blocks, keys
    and loss, written as one unsharded function."""
    import jax
    import jax.numpy as jnp
    from raytracingweekend_tpu.parallel import mesh as mesh_mod

    rows, spp_shard = ny // dp, spp // sp

    def loss(p):
        sc = set_params(scene, p)
        total = 0.0
        for di in range(dp):
            m = sum(mesh_mod._render_tile(
                sc, mesh_mod._tile_key(key, di, si), di * rows, nx, rows,
                ny, spp_shard, max_depth, "scan")[0] for si in range(sp))
            m = m / (sp * spp_shard)
            total = total + jnp.sum((m - target[di * rows:(di + 1) * rows])
                                    ** 2)
        return total / target.size

    return jax.jit(jax.value_and_grad(loss))(params)


def phase_multi_gpu(nx: int = 1200, ny: int = 800, spp: int = 8,
                    max_depth: int = 50, grad_nx: int = 64,
                    grad_ny: int = 64, grad_spp: int = 8,
                    n_dev: int = 4, n_blocks: int = 8) -> dict:
    import jax
    from raytracingweekend_tpu.models.scenes import make_scene
    from raytracingweekend_tpu.parallel import distributed
    from raytracingweekend_tpu.parallel.mesh import (make_mesh,
                                                     render_sharded,
                                                     sharded_value_and_grad)
    from raytracingweekend_tpu.utils.goldens import statistically_equal

    devs = jax.devices()
    check(len(devs) >= n_dev, f"need {n_dev} devices, have {len(devs)}")
    scene = make_scene("random_balls", nx / ny)
    out = {}

    def timed(mesh, seed):
        key = jax.random.key(seed)
        render_sharded(scene, mesh, key, nx, ny, spp, max_depth=max_depth,
                       with_segments=True)[0].block_until_ready()  # compile
        t0 = time.perf_counter()
        img, segs = render_sharded(scene, mesh, jax.random.fold_in(key, 1),
                                   nx, ny, spp, max_depth=max_depth,
                                   with_segments=True)
        img = np.asarray(img.block_until_ready(), np.float64)
        return img, float(segs) / (time.perf_counter() - t0)

    one, rate1 = timed(make_mesh(1, 1, devs[:1]), 0)
    log(f"one card render_sharded random_balls {nx}x{ny} {spp} spp depth "
        f"{max_depth}: {rate1:.4e} segments/s")
    out["one_card_segments_per_s"] = rate1
    for dp, sp in ((n_dev, 1), (n_dev // 2, 2)):
        img, rate = timed(make_mesh(dp, sp, devs[:n_dev]), 1)
        agree = statistically_equal(img, one, n_blocks=n_blocks)
        eff = rate / (n_dev * rate1)
        out[f"dp{dp}_sp{sp}"] = dict(agree, segments_per_s=rate,
                                     per_card=rate / n_dev, efficiency=eff)
        log(f"render_sharded dp={dp} sp={sp}: {rate:.4e} segments/s, "
            f"{rate / n_dev:.4e} per card, efficiency vs one card "
            f"{eff:.3f}; vs one card z(mean) {agree['z_mean']:.2f}, max "
            f"z(block) {agree['z_block_max']:.2f}")
    img = np.asarray(distributed.render_distributed(
        scene, jax.random.key(2), nx, ny, spp, max_depth=max_depth, sp=2),
        np.float64)
    agree = statistically_equal(img, one, n_blocks=n_blocks)
    out["render_distributed"] = agree
    log(f"render_distributed over {len(devs)} local devices (sp=2): "
        f"vs one card z(mean) {agree['z_mean']:.2f}, max z(block) "
        f"{agree['z_block_max']:.2f}")
    check(all(v["passed"] for k, v in out.items() if isinstance(v, dict)),
          f"sharded renders disagree with one card: {out}")

    gscene = make_scene("cornell_box", grad_nx / grad_ny)
    set_p = lambda s, p: s.replace(textures=s.textures.replace(color=p))  # noqa: E731
    key = jax.random.key(3)
    target = np.zeros((grad_ny, grad_nx, 3), np.float32)
    dp, sp = n_dev // 2, 2
    vg = sharded_value_and_grad(gscene, make_mesh(dp, sp, devs[:n_dev]),
                                target, set_params=set_p, nx=grad_nx,
                                ny=grad_ny, spp=grad_spp, max_depth=8)
    loss, g = vg(gscene.textures.color, key)
    with jax.default_device(devs[0]):
        ref_loss, ref_g = _sharded_reference(
            gscene, target, gscene.textures.color, key, set_p, grad_nx,
            grad_ny, grad_spp, 8, dp, sp)
    g, ref_g = np.asarray(g), np.asarray(ref_g)
    gerr = float(np.abs(g - ref_g).max())
    out["sharded_grad"] = dict(loss=float(loss), ref_loss=float(ref_loss),
                               max_grad_err=gerr)
    log(f"sharded value_and_grad cornell_box {grad_nx}x{grad_ny}x{grad_spp} "
        f"on ({dp}, {sp}): loss {float(loss):.6e} vs one card "
        f"{float(ref_loss):.6e}; max |grad diff| {gerr:.3e} of max |grad| "
        f"{np.abs(ref_g).max():.3e}")
    check(np.allclose(float(loss), float(ref_loss), rtol=SHARDED_GRAD_RTOL)
          and np.allclose(g, ref_g, rtol=SHARDED_GRAD_RTOL,
                          atol=SHARDED_GRAD_ATOL),
          "sharded value_and_grad differs from the one-card step")
    return out


def run(multi_gpu: bool) -> dict:
    import jax
    from raytracingweekend_tpu import native
    from raytracingweekend_tpu.utils import device
    from raytracingweekend_tpu.utils.compile_cache import enable_compile_cache

    log(f"card: {device.nvidia_smi_line()}")
    log(f"jax {jax.__version__}; devices {jax.devices()}")
    info = phase_device()
    log(f"compile cache: {enable_compile_cache()}")
    log("native runtime (framebuffer, checkpoints): "
        + ("NOT built" if not native.available() else
           "built, with PNG/JPEG codecs" if native.has_codecs() else
           "built without PNG/JPEG codecs (no libpng/libjpeg headers); "
           "PNGs are written by the Python encoder"))
    os.makedirs(OUT_DIR, exist_ok=True)
    if multi_gpu:
        phase_multi_gpu()
    else:
        phase_flagship(OUT_DIR)
        phase_checkpoint(OUT_DIR)
        phase_goldens()
        phase_loop_modes()
        phase_gradients()
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    try:
        info = run(args.multi_gpu)
    except (SmokeFailure, ImportError) as e:
        log(f"FAILED: {e.__class__.__name__}: {e}")
        print(json.dumps({"ok": False, "error": str(e)}))
        return 1
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
