"""ntracer_tpu: a GPU hyper-spatial (n-dimensional) ray tracer in JAX.

A from-scratch rebuild of the capabilities of NTracer (an SSE/AVX CPython
extension) as a JAX/XLA framework: scenes flatten to SoA device arrays,
whole tiles of rays advance in lockstep through vectorized intersection
and shading (with a Pallas walk kernel for the triangle pool on the GPU),
and multi-device rendering shards pixel tiles over a
``jax.sharding.Mesh``.

The public API mirrors the reference package: ``Color``, ``Material``,
``Channel``, ``ImageFormat``, ``CallbackRenderer``, ``BlockingRenderer``,
``NTracer``, ``CUBE``, ``SPHERE`` (reference lib/ntracer/__init__.py:8-9).
"""

from .render import (Color, Material, Channel, ImageFormat, CallbackRenderer,
                     BlockingRenderer)
from .wrapper import NTracer, CUBE, SPHERE
from . import render
from . import wrapper

__all__ = ["Color", "Material", "Channel", "ImageFormat", "CallbackRenderer",
           "BlockingRenderer", "NTracer", "CUBE", "SPHERE", "render",
           "wrapper"]

from ._version import __version__  # noqa: E402  (derived, not hardcoded)
