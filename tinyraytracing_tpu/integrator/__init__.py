"""Wavefront path-tracing integrator.

The reference's recursive estimator (shade() at
RayTracingOnCPU/pathTracing.cpp:3-102, unbounded Russian-roulette recursion)
becomes a fixed-depth ``lax.scan`` over bounce waves with survival masks and
throughput accumulators (no recursion, static shapes,
compiler-schedulable).
"""

from tinyraytracing_tpu.integrator.wavefront import trace

__all__ = ["trace"]
