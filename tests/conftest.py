"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Sharding tests run on 8 virtual CPU devices; the walk kernel runs here in
Pallas interpret mode.  Checks that need the GPU carry the ``gpu`` marker
and skip on the CPU; on the card they run with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

from functools import partial  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def walk_interpret(monkeypatch):
    """Route opaque pools through the walk kernel, run by the Pallas
    interpreter: the kernel choice answers as it does on the GPU, and
    every kernel call passes ``interpret=True``."""
    from ntracer_tpu.engine import walk

    impl = walk.trace_impl
    monkeypatch.setattr(walk, "trace_impl",
                        lambda backend, d, transparent:
                        impl("gpu", d, transparent))
    monkeypatch.setattr(walk, "nearest_hit",
                        partial(walk.nearest_hit, interpret=True))
    monkeypatch.setattr(walk, "occluded",
                        partial(walk.occluded, interpret=True))
