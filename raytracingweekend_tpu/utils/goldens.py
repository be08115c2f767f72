"""Reference goldens and the statistical gates that compare a render with
them.

Goldens in tests/goldens/ are produced by tools/reference_oracle (a portable
serial driver over the unmodified reference headers — see its Makefile) at
high spp, float64. This renderer uses a different (threefry) RNG stream, so
agreement is statistical. Used by tests/test_golden.py (cheap sizes),
tools/golden_report.py and chip_smoke.py (the goldens' own size and spp).
tests/goldens/ also holds 128x128 goldens of cornell_box and random_balls
that no run uses yet.
"""
from __future__ import annotations

import os
import re

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "goldens")

GOLDENS = {
    "dielectric": "dielectric_32x32_4096spp.bin",
    "light_sample": "light_sample_32x32_4096spp.bin",
    "cornell_box": "cornell_box_32x32_8192spp.bin",
    "random_balls": "random_balls_32x32_2048spp.bin",
    # volume path: reference constant_medium + isotropic via the oracle's
    # smoke_scene (same book-2 ch.9 constants as models/scenes.py)
    "cornell_smoke": "cornell_smoke_32x32_8192spp.bin",
    # image-texture path: the oracle renders through the UNMODIFIED
    # reference image_texture (texture.h:73-98) fed the exact texel bytes
    # of tools/reference_oracle/earth.rtwi, which the earth scenes load
    "earth": "earth_32x32_4096spp.bin",
    "earth_rect": "earth_rect_32x32_4096spp.bin",
}

# Gate constants. Full mode (the golden's own resolution and spp):
MEAN_REL_TOL = 0.02       # scene-mean relative error
MEAN_Z_TOL = 4.0          # scene-mean error in combined standard errors
PIXEL_FRAC_OK = 0.995     # share of pixels within pixel_tol
# Blockwise (8x8 blocks of the 32x32 frame): 0.03 + BLOCK_SIGMAS sigma.
BLOCK_SIGMAS = 4.0


def golden_spp(filename: str) -> int:
    return int(re.search(r"_(\d+)spp\.bin$", filename).group(1))


def load_golden(filename: str) -> np.ndarray:
    """(ny, nx, 3) float64 radiance, row 0 = image bottom."""
    with open(os.path.join(GOLDEN_DIR, filename), "rb") as f:
        header = f.readline().decode()
        m = re.match(r"RTWO (\d+) (\d+)", header)
        nx, ny = int(m.group(1)), int(m.group(2))
        data = np.frombuffer(f.read(), dtype="<f8")
    return data.reshape(ny, nx, 3)


def full_parity(golden: np.ndarray, ours: np.ndarray, spp: int) -> dict:
    """Scene mean within MEAN_REL_TOL and within MEAN_Z_TOL combined MC
    standard errors, and > PIXEL_FRAC_OK of pixels within
    0.05 + 4*sqrt(golden/spp).

    The combined standard error of the mean difference is estimated from
    the per-pixel differences themselves: pixels are independent MC
    estimates, so SE = std(ours - golden) / sqrt(n_values)."""
    g = np.asarray(golden, np.float64)
    o = np.asarray(ours, np.float64)
    diff = o - g
    mean_rel = abs(diff.mean()) / max(g.mean(), 1e-6)
    se = diff.std() / np.sqrt(diff.size)
    z = abs(diff.mean()) / max(se, 1e-12)
    tol = 0.05 + 4.0 * np.sqrt(np.maximum(g, 0.0) / spp)
    frac_ok = float((np.abs(diff) <= tol).mean())
    return dict(mean_rel=float(mean_rel), mean_z=float(z),
                frac_ok=frac_ok,
                passed=bool(mean_rel < MEAN_REL_TOL and z < MEAN_Z_TOL
                            and frac_ok > PIXEL_FRAC_OK))


def blockwise(golden: np.ndarray, ours: np.ndarray, spp: int,
              n: int = 8) -> dict:
    """n x n block means vs the golden's, within 0.03 + BLOCK_SIGMAS
    sigma of the block mean (sigma^2 ~ golden / (pixels per block * spp))."""
    g = np.asarray(golden, np.float64)
    o = np.asarray(ours, np.float64)
    ny, nx, _ = g.shape

    def blk(a):
        return a.reshape(n, ny // n, n, nx // n, 3).mean(axis=(1, 3))

    per_block = (ny // n) * (nx // n)
    gb = blk(g)
    err = np.abs(blk(o) - gb)
    tol = 0.03 + BLOCK_SIGMAS * np.sqrt(np.maximum(gb, 0.0)
                                        / (per_block * spp))
    return dict(worst_ratio=float((err / tol).max()),
                n_bad=int((err > tol).sum()), passed=bool((err <= tol).all()))


def statistically_equal(a: np.ndarray, b: np.ndarray, n_blocks: int = 8,
                        z_tol: float = 5.0) -> dict:
    """Do two renders of one scene with independent RNG streams agree?

    The frame mean and each of n_blocks x n_blocks block means must differ
    by less than z_tol standard errors, estimated per region from the
    per-pixel differences (pixels are independent MC estimates)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    ny, nx, c = d.shape

    def z(x):
        x = x.reshape(-1, c)
        se = x.std(axis=0) / np.sqrt(x.shape[0])
        return np.abs(x.mean(axis=0)) / np.maximum(se, 1e-9)

    blocks = d.reshape(n_blocks, ny // n_blocks, n_blocks, nx // n_blocks, c)
    blocks = blocks.transpose(0, 2, 1, 3, 4).reshape(
        n_blocks * n_blocks, -1, c)
    zmax_block = max(float(z(blk).max()) for blk in blocks)
    zmean = float(z(d).max())
    return dict(z_mean=zmean, z_block_max=zmax_block,
                passed=bool(zmean < z_tol and zmax_block < z_tol))
