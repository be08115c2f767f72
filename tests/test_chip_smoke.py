"""chip_smoke.py on the CPU: it must refuse to report a result without a
GPU (also when it stands alone, without the package), and its phases must
run at tiny sizes."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

from raytracingweekend_tpu.utils import goldens as G  # noqa: E402


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_gpu():
    out = _run(ROOT, "chip_smoke.py")
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and "device" not in last


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(tmp_path, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_phase_device_rejects_cpu():
    with pytest.raises(cs.SmokeFailure, match="not a GPU"):
        cs.phase_device()


def test_phase_flagship_tiny(tmp_path):
    res = cs.phase_flagship(str(tmp_path), nx=24, ny=16, spp=4, spl=2,
                            max_depth=6)
    assert res["launches"] == 2
    assert res["steady_segments_per_s"] > 0
    assert (tmp_path / "flagship.png").stat().st_size > 0


def test_phase_checkpoint_tiny(tmp_path):
    res = cs.phase_checkpoint(str(tmp_path), nx=16, ny=16, spp=8, spl=2,
                              max_depth=8)
    assert res["max_abs_err"] <= cs.RESUME_ATOL


def test_phase_goldens_tiny():
    res = cs.phase_goldens(spp_scale=1 / 32, names=["dielectric", "earth"])
    assert set(res) == {"dielectric", "earth"}


def test_phase_gradients_tiny():
    # below ~64x64x8 spp the fit's per-step gradient noise can outweigh
    # three Adam steps of progress
    res = cs.phase_gradients(fd_nx=8, fd_ny=8, fd_spp=8, fit_nx=64,
                             fit_ny=64, fit_spp=8, steps=3)
    assert res["fit"]["loss_after"] < res["fit"]["loss_before"]


def test_phase_multi_gpu_on_virtual_devices():
    res = cs.phase_multi_gpu(nx=16, ny=16, spp=4, max_depth=6, grad_nx=8,
                             grad_ny=8, grad_spp=4, n_dev=4, n_blocks=2)
    assert res["sharded_grad"]["max_grad_err"] < 1e-5
    assert {"dp4_sp1", "dp2_sp2", "render_distributed"} <= set(res)


def test_full_parity_gate():
    golden = G.load_golden(G.GOLDENS["dielectric"])
    rng = np.random.default_rng(0)
    noisy = golden + rng.normal(0.0, 0.01, golden.shape)
    assert G.full_parity(golden, noisy, 4096)["passed"]
    assert not G.full_parity(golden, noisy * 1.05, 4096)["passed"]
    assert not G.blockwise(golden, golden + 0.2, 4096)["passed"]


def test_statistically_equal_gate():
    rng = np.random.default_rng(1)
    base = rng.uniform(0.2, 0.8, (16, 16, 3))
    a = base + rng.normal(0.0, 0.05, base.shape)
    b = base + rng.normal(0.0, 0.05, base.shape)
    assert G.statistically_equal(a, b, n_blocks=4)["passed"]
    biased = b.copy()
    biased[:4, :4] += 0.2                  # one wrong block
    assert not G.statistically_equal(a, biased, n_blocks=4)["passed"]
