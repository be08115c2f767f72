"""raytracingweekend_tpu — a differentiable Monte Carlo path tracer in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
silvesthu/RayTracingWeekend (Peter Shirley's *Ray Tracing in One Weekend*
books 1-3): wavefront path tracing with multiple importance sampling over
flat SoA scene tables, counter-based RNG, and pjit/shard_map scale-out over
device meshes.
"""

__version__ = "0.1.0"
