"""Drop-in alias for the reference package name.

``ntracer`` re-exports :mod:`ntracer_tpu` so code written against the
original package (scripts, pickles, ``import ntracer.tracer4``) runs
unmodified on the JAX framework.
"""

import sys as _sys

import ntracer_tpu as _impl
from ntracer_tpu import (Color, Material, Channel, ImageFormat,
                         CallbackRenderer, BlockingRenderer, NTracer, CUBE,
                         SPHERE)
from ntracer_tpu import render, wrapper

__all__ = ["Color", "Material", "Channel", "ImageFormat", "CallbackRenderer",
           "BlockingRenderer", "NTracer", "CUBE", "SPHERE", "render",
           "wrapper"]

# register submodule aliases so "import ntracer.tracer4" etc. work and
# pickles referencing "ntracer.render" resolve
_sys.modules[__name__ + ".render"] = render
_sys.modules[__name__ + ".wrapper"] = wrapper

import ntracer_tpu.tracern as _tracern
_sys.modules[__name__ + ".tracern"] = _tracern
for _d in range(3, 9):
    _sys.modules[f"{__name__}.tracer{_d}"] = __import__(
        f"ntracer_tpu.tracer{_d}", fromlist=["__name__"])

import ntracer_tpu.pygame_render as _pygame_render
_sys.modules[__name__ + ".pygame_render"] = _pygame_render

import ntracer_tpu.wavefront_obj as _wavefront_obj
_sys.modules[__name__ + ".wavefront_obj"] = _wavefront_obj
