"""Edge-preserving denoise: an a-trous (hole-filled) bilateral filter.

The reference's sampling gallery commits a denoised comparison render
(/root/reference/RayTracingWeekend/Sampling/light_sampling_denoised.png, an
externally-denoised PNG with no code in the tree); this module is the
framework's own post-filter so the artifact is reproducible in-repo.

Vectorized formulation: each a-trous iteration is 25 shifted adds of the
whole image (B3-spline 5x5 stencil dilated by 2^i) with per-pixel range
weights — pure elementwise jnp, jit-compiles to fused elementwise code with no
gathers. Edge handling is clamp-to-edge via one pad per iteration.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["atrous_denoise", "firefly_clamp"]


def firefly_clamp(img, k: float = 2.0, floor: float = 0.05):
    """Suppress isolated Monte-Carlo fireflies: clamp each pixel to
    k x (its 8-neighbor mean) + floor. Outlier samples brighter than any
    neighborhood evidence cannot survive; real bright REGIONS (lights)
    are their own neighbors and pass through."""
    img = jnp.asarray(img, jnp.float32)
    ny, nx = img.shape[0], img.shape[1]
    padded = jnp.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    acc = jnp.zeros_like(img)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            acc = acc + padded[1 + dy: 1 + dy + ny, 1 + dx: 1 + dx + nx, :]
    return jnp.minimum(img, acc * (k / 8.0) + floor)

_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _shift(padded, dy, dx, step, ny, nx):
    """Clamp-to-edge shifted view of the padded image."""
    off = 2 * step
    return padded[off + dy * step: off + dy * step + ny,
                  off + dx * step: off + dx * step + nx, :]


def atrous_denoise(img, iterations: int = 3, sigma_color: float = 0.25):
    """Denoise an (ny, nx, 3) radiance/display image.

    Classic a-trous wavelet filtering (Dammertz et al. 2010) with a color
    range kernel: spatial weight = dilated B3 spline, range weight =
    exp(-|c_p - c_q|^2 / sigma_i^2) with sigma halved per iteration so
    later (wider) passes only average across ever-more-similar regions —
    Monte-Carlo speckle blends away while material/shadow edges survive.
    """
    img = jnp.asarray(img, jnp.float32)
    ny, nx = img.shape[0], img.shape[1]
    for i in range(iterations):
        step = 2 ** i
        sig2 = (sigma_color * (0.5 ** i)) ** 2
        pad = 2 * step
        padded = jnp.pad(img, ((pad, pad), (pad, pad), (0, 0)),
                         mode="edge")
        acc = jnp.zeros_like(img)
        wsum = jnp.zeros((ny, nx), jnp.float32)
        for dy, wy in zip((-2, -1, 0, 1, 2), _B3):
            for dx, wx in zip((-2, -1, 0, 1, 2), _B3):
                q = _shift(padded, dy, dx, step, ny, nx)
                d2 = jnp.sum((q - img) ** 2, axis=-1)
                w = (wy * wx) * jnp.exp(-d2 / jnp.float32(max(sig2, 1e-8)))
                acc = acc + q * w[..., None]
                wsum = wsum + w
        img = acc / wsum[..., None]
    return img


def denoise_png(in_path: str, out_path: str, iterations: int = 4,
                sigma_color: float = 0.35) -> None:
    """Read a committed gallery PNG, denoise in display space, write the
    pair artifact (the reference's denoised PNG is likewise a processed
    display image). Two firefly passes catch the 2-pixel speckle clusters
    MIS caustics leave at gallery sample counts."""
    from . import image as image_mod

    img = np.asarray(image_mod.read_png(in_path), np.float32)

    def run(x):
        x = firefly_clamp(firefly_clamp(x, 1.5, 0.02), 1.5, 0.02)
        return atrous_denoise(x, iterations, sigma_color)

    out = np.asarray(jax.jit(run)(img))
    image_mod.write_png(np.clip(out, 0.0, 1.0), out_path)
