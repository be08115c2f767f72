"""Keyed, vectorized Monte Carlo samplers.

Replaces the reference's static-`std::minstd_rand` free
functions (reference: RayTracingWeekend/utility.h:14-82, camera.h:61-69).
Every sampler is a pure function of a threefry key and a batch shape, so the
reference's documented thread-safety race (RayTracingWeekend.cpp:188-189,213)
is impossible by construction and results are reproducible under any device
mesh or sharding.

Rejection loops (unit sphere / unit disk) are replaced by exact closed-form
equivalents — identical distributions, no data-dependent control flow, which
is what a vectorized XLA program needs. SURVEY.md §7 sanctions matching the RNG stream
statistically rather than bitwise.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from . import linalg

__all__ = [
    "uniform", "random_int", "random_in_unit_sphere", "random_unit_vector",
    "random_in_hemisphere", "random_cosine_direction", "random_to_sphere",
    "random_in_unit_disk", "get_sphere_uv",
]

_REAL = jnp.float32


def uniform(key, shape=(), a=0.0, b=1.0, dtype=_REAL):
    """U[a, b) — the batched analogue of utility.h:14-20 random_double."""
    return jax.random.uniform(key, shape, dtype=dtype, minval=a, maxval=b)


def random_int(key, shape, a, b):
    """Uniform integer in [a, b] inclusive.

    Matches utility.h:22-25: ``a + min(b - a, int((b - a + 1) * U))``.
    """
    u = uniform(key, shape)
    return a + jnp.minimum(b - a, ((b - a + 1) * u).astype(jnp.int32))


def random_unit_vector(key, shape=()):
    """Uniform direction on the unit sphere (utility.h:37-43), shape (..., 3)."""
    ka, kz = jax.random.split(key)
    a = uniform(ka, shape, 0.0, 2.0 * math.pi)
    z = uniform(kz, shape, -1.0, 1.0)
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return jnp.stack([r * jnp.cos(a), r * jnp.sin(a), z], axis=-1)


def random_in_unit_sphere(key, shape=()):
    """Uniform point in the unit ball.

    Closed-form equivalent of the rejection loop at utility.h:27-35:
    direction uniform on the sphere, radius ~ U^(1/3).
    """
    kd, kr = jax.random.split(key)
    d = random_unit_vector(kd, shape)
    r = uniform(kr, shape) ** (1.0 / 3.0)
    return d * r[..., None]


def random_in_hemisphere(key, normal):
    """Uniform point in the unit ball folded into the normal's hemisphere
    (utility.h:45-52). `normal` has shape (..., 3)."""
    p = random_in_unit_sphere(key, normal.shape[:-1])
    same = linalg.dot(p, normal) > 0.0
    return jnp.where(same[..., None], p, -p)


def random_cosine_direction(key, shape=()):
    """Cosine-weighted direction about +z (utility.h:54-67, book3 ch7.2)."""
    k1, k2 = jax.random.split(key)
    r1 = uniform(k1, shape)
    r2 = uniform(k2, shape)
    z = jnp.sqrt(jnp.maximum(1.0 - r2, 0.0))
    phi = 2.0 * math.pi * r1
    sq = jnp.sqrt(r2)
    return jnp.stack([jnp.cos(phi) * sq, jnp.sin(phi) * sq, z], axis=-1)


def random_to_sphere(key, radius, distance_squared):
    """Cone sample toward a sphere of `radius` at squared distance
    `distance_squared` (utility.h:69-82, book3 ch12.3). Batched over the
    shapes of radius/distance_squared; returns (..., 3) in cone-local frame."""
    shape = jnp.broadcast_shapes(jnp.shape(radius), jnp.shape(distance_squared))
    k1, k2 = jax.random.split(key)
    r1 = uniform(k1, shape)
    r2 = uniform(k2, shape)
    ctm = linalg.safe_sqrt(1.0 - radius * radius / distance_squared)
    z = 1.0 + r2 * (ctm - 1.0)
    phi = 2.0 * math.pi * r1
    # safe_sqrt, not sqrt(max(., 0)): a draw with r2 == 0 lands exactly on
    # the cone axis (z == 1), where d sqrt(1-z^2)/dz is inf — with z a
    # function of the light's center/radius that inf reaches jax.grad of
    # every geometry parameter as NaN (one bad lane poisons the whole
    # gradient). The double-where differentiates the axis lane as constant.
    s = linalg.safe_sqrt(1.0 - z * z)
    return jnp.stack([jnp.cos(phi) * s, jnp.sin(phi) * s, z], axis=-1)


def random_in_unit_disk(key, shape=()):
    """Uniform point in the unit disk (z = 0).

    Closed-form equivalent of the camera's rejection loop (camera.h:61-69):
    radius ~ sqrt(U), angle uniform.
    """
    kr, ka = jax.random.split(key)
    r = jnp.sqrt(uniform(kr, shape))
    a = uniform(ka, shape, 0.0, 2.0 * math.pi)
    z = jnp.zeros_like(r)
    return jnp.stack([r * jnp.cos(a), r * jnp.sin(a), z], axis=-1)


def get_sphere_uv(p):
    """(u, v) surface parameterization from a unit sphere point
    (utility.h:6-12 / sphere.h:115-122). `p` has shape (..., 3)."""
    phi = jnp.arctan2(p[..., 2], p[..., 0])
    theta = jnp.arcsin(jnp.clip(p[..., 1], -1.0, 1.0))
    u = 1.0 - (phi + math.pi) / (2.0 * math.pi)
    v = (theta + math.pi / 2.0) / math.pi
    return u, v
