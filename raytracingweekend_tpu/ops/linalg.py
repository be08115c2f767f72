"""3-vector math over arrays of shape (..., 3).

Vectorized reformulation of the reference's scalar vec3/onb layer
(reference: RayTracingWeekend/vec3.h, onb.h, material.h:10-49). Everything is
batched: a "vec3" is the trailing axis of a jnp array, so the whole module is
pure elementwise work that XLA fuses into surrounding kernels.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "dot", "cross", "length", "length_squared", "normalize", "lerp_ref",
    "reflect", "refract", "schlick", "onb_from_w", "onb_local", "vclamp",
    "safe_sqrt",
]


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt clamped at 0 with a NaN-free reverse pass.

    ``sqrt(max(x, 0))`` has derivative inf at the clamp, which turns masked
    lanes into NaN gradients (inf * 0); the double-where makes the clamped
    branch differentiate as a constant instead.
    """
    pos = x > 0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing xyz axis (vec3.h:52)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product (vec3.h:54-59)."""
    return jnp.cross(a, b)


def length_squared(v: jnp.ndarray) -> jnp.ndarray:
    return dot(v, v)


def length(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(length_squared(v))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Normalize over the trailing axis (vec3.h:61-67)."""
    return v / length(v)[..., None]


def vclamp(v: jnp.ndarray, lo, hi) -> jnp.ndarray:
    """Componentwise clamp (vec3.h:69-82)."""
    return jnp.clip(v, lo, hi)


def lerp_ref(frm: jnp.ndarray, to: jnp.ndarray, t) -> jnp.ndarray:
    """The reference's lerp with its *swapped* argument semantics.

    vec3.h:84-87 returns ``(1-t)*to + t*frm`` — i.e. t=0 yields `to` and t=1
    yields `frm`. Preserved verbatim because the background gradient
    (RayTracingWeekend.cpp:150) relies on this exact call convention.
    """
    t = jnp.asarray(t)[..., None] if jnp.ndim(t) == jnp.ndim(frm) - 1 else t
    return (1.0 - t) * to + t * frm


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection about normal n (material.h:10-13)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v: jnp.ndarray, n: jnp.ndarray, ni_over_nt: jnp.ndarray):
    """Snell refraction with total-internal-reflection detection.

    Mirrors material.h:17-39: direction `v` is normalized internally, `n` must
    point against the incident ray. Returns ``(refracted, can_refract)`` where
    `refracted` is only meaningful where `can_refract` is True (masked select
    replaces the reference's bool-return-plus-out-param).
    """
    uv = normalize(v)
    dt = dot(uv, n)
    ni_over_nt = jnp.asarray(ni_over_nt)
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    can_refract = disc > 0
    refr = (
        ni_over_nt[..., None] * (uv - n * dt[..., None])
        - n * safe_sqrt(disc)[..., None]
    )
    return refr, can_refract


def schlick(cosine: jnp.ndarray, ref_idx) -> jnp.ndarray:
    """Schlick Fresnel approximation (material.h:44-49)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def onb_from_w(n: jnp.ndarray):
    """Orthonormal basis from a (not necessarily unit) normal.

    Mirrors onb.h:32-38: w = normalize(n); pick helper axis by |w.x| > 0.9;
    v = normalize(w × a); u = w × v. Returns (u, v, w), each (..., 3).
    """
    w = normalize(n)
    ex = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], dtype=w.dtype), w.shape)
    ey = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0], dtype=w.dtype), w.shape)
    a = jnp.where(jnp.abs(w[..., 0:1]) > 0.9, ey, ex)
    v = normalize(jnp.cross(w, a))
    u = jnp.cross(w, v)
    return u, v, w


def onb_local(u: jnp.ndarray, v: jnp.ndarray, w: jnp.ndarray, a: jnp.ndarray):
    """Map tangent-space direction `a` to world space (onb.h:16-24)."""
    return a[..., 0:1] * u + a[..., 1:2] * v + a[..., 2:3] * w
