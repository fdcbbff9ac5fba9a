"""Render engine: scene flattening, the JAX wavefront trace, the GPU walk
kernel, packing.

The persistent compile cache is chosen here and nowhere else: where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself; otherwise the
cache lives in ``.jax_cache`` at the root of the checkout (a fixed path,
so later processes find what earlier ones compiled).
"""

import os

import jax

CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
