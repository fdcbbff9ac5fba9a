"""Generic (any-dimension) tracer module.

Equivalent of the reference's ``ntracer.tracern`` extension module
(src/tracern.cpp + ntracer_body.hpp with ``var::item_store``): every class
takes the dimension explicitly.  The specialized ``tracer3``..``tracer8``
modules re-export the same classes — here, per-dimension specialization is
jit static-shape caching rather than separately compiled extensions.
"""

from .api import (Vector, Matrix, MatrixProxy, Camera, CameraAxes, AABB,
                  BATCH_SIZE, dot, cross, screen_coord_to_ray)
from .primitives import (Primitive, PrimitiveBatch, Triangle, TriangleBatch,
                         Solid, PrimitivePrototype, TrianglePrototype,
                         TriangleBatchPrototype, SolidPrototype,
                         TrianglePointData, FrozenVectorView, RayIntersection,
                         PointLight, GlobalLight, CUBE, SPHERE)
from .kdnodes import KDNode, KDLeaf, KDBranch
from .scene import (CompositeScene, BoxScene, build_kdtree,
                    build_composite_scene, PointLightList, GlobalLightList)

__all__ = [
    "Vector", "Matrix", "MatrixProxy", "Camera", "CameraAxes", "AABB",
    "BATCH_SIZE", "dot", "cross", "screen_coord_to_ray",
    "Primitive", "PrimitiveBatch", "Triangle", "TriangleBatch", "Solid",
    "PrimitivePrototype", "TrianglePrototype", "TriangleBatchPrototype",
    "SolidPrototype", "TrianglePointData", "FrozenVectorView",
    "RayIntersection", "PointLight", "GlobalLight", "CUBE", "SPHERE",
    "KDNode", "KDLeaf", "KDBranch", "CompositeScene", "BoxScene",
    "build_kdtree", "build_composite_scene",
    "PointLightList", "GlobalLightList",
]
