"""Primitives (Triangle, TriangleBatch, Solid), prototypes and lights.

Scalar intersection math is a float32 NumPy port of the reference kernels
(/root/reference/src/tracer.hpp: ``hypercube_intersects`` 126-152,
``hypersphere_intersects`` 154-173, ``solid::intersects`` 251-276,
``triangle::intersects`` 411-440, ``triangle_batch::intersects`` 551-599).
These methods are the CPU oracle; the device engine re-implements the same math
vectorized over ray tiles in JAX.
"""

from __future__ import annotations

from collections.abc import Sequence as _Sequence

import numpy as np

from . import _vecmath as vm
from .api import (Vector, Matrix, AABB, BATCH_SIZE, ROUNDING_FUZZ,
                  _vector_arg, check_dimension)
from ._codec import encode_floats
from .render import (Material, _triangle_unpickle, _triangle_batch_unpickle,
                     _solid_unpickle)

f32 = np.float32
REAL_MAX = f32(np.finfo(np.float32).max)

CUBE = 1
SPHERE = 2


class FrozenVectorView:
    """Read-only sequence of Vectors (reference FrozenVectorView)."""

    __slots__ = ("_vecs",)

    def __init__(self, arrays):
        self._vecs = tuple(Vector._wrap(np.asarray(a, dtype=f32)) for a in arrays)

    def __len__(self):
        return len(self._vecs)

    def __getitem__(self, i):
        return self._vecs[i]

    def __iter__(self):
        return iter(self._vecs)


class RayIntersection:
    """Result of a primitive/k-d query (ntracer_body py_ray_intersection)."""

    __slots__ = ("dist", "origin", "normal", "primitive", "batch_index")

    def __init__(self, dist, origin, normal, primitive, batch_index=-1):
        self.dist = float(dist)
        self.origin = origin if isinstance(origin, Vector) else Vector._wrap(origin)
        self.normal = normal if isinstance(normal, Vector) else Vector._wrap(normal)
        self.primitive = primitive
        self.batch_index = int(batch_index)

    def __repr__(self):
        return (f"RayIntersection(dist={self.dist},origin={self.origin!r},"
                f"normal={self.normal!r},primitive={self.primitive!r},"
                f"batch_index={self.batch_index})")


def _material_arg(m) -> Material:
    if not isinstance(m, Material):
        raise TypeError("material must be a Material instance")
    return m


class Primitive:
    """Common base of Triangle and Solid (tracer.hpp primitive)."""

    _material: Material

    @property
    def material(self):
        return self._material

    def opaque(self):
        return self._material.opacity >= 1

    # subclass provides _intersect_raw(origin, direction, cutoff)
    def intersects(self, origin, direction):
        o = _vector_arg(origin, self.dimension)
        dvec = _vector_arg(direction, self.dimension)
        hit = self._intersect_raw(o, dvec, REAL_MAX)
        if hit is None:
            return None
        dist, p, n = hit
        return RayIntersection(dist, p, n, self, -1)


class PrimitiveBatch:
    """Common base of batch primitives (tracer.hpp primitive_batch)."""

    def intersects(self, origin, direction, index=-1):
        o = _vector_arg(origin, self.dimension)
        dvec = _vector_arg(direction, self.dimension)
        hit = self._intersect_raw(o, dvec, int(index), REAL_MAX)
        if hit is None:
            return None
        dist, p, n, lane = hit
        return RayIntersection(dist, p, n, self, lane)


class Triangle(Primitive):
    """A (d-1)-simplex stored as p1, face_normal, d-1 edge normals and the
    plane offset ``d`` (tracer.hpp:385-526)."""

    __slots__ = ("_p1", "_fn", "_en", "_d", "_material")

    def __init__(self, p1, face_normal, edge_normals, material):
        p1a = _vector_arg(p1)
        dim = check_dimension(p1a.shape[0])
        fna = _vector_arg(face_normal, dim)
        ens = [_vector_arg(e, dim) for e in edge_normals]
        if len(ens) != dim - 1:
            raise TypeError(f"expected {dim-1} edge normals, got {len(ens)}")
        self._p1 = p1a
        self._fn = fna
        self._en = np.stack(ens) if ens else np.zeros((0, dim), dtype=f32)
        self._d = f32(-vm.dot(fna, p1a))
        self._material = _material_arg(material)

    @property
    def dimension(self):
        return self._p1.shape[0]

    @property
    def p1(self):
        return Vector._wrap(self._p1)

    @property
    def face_normal(self):
        return Vector._wrap(self._fn)

    @property
    def edge_normals(self):
        return FrozenVectorView(self._en)

    @property
    def d(self):
        return float(self._d)

    @staticmethod
    def from_points(points, material):
        """Build from d points (tracer.hpp:442-462): face normal is the
        generalized cross of the edges; edge normal i is the cross with side
        i replaced by the face normal, divided by |N|^2."""
        pts = [(_vector_arg(p)) for p in points]
        dim = check_dimension(pts[0].shape[0])
        if len(pts) != dim:
            raise TypeError(f"expected {dim} points")
        p1 = pts[0]
        vsides = np.stack([pts[i + 1] - p1 for i in range(dim - 1)])
        n = vm.cross(vsides)
        sq = vm.square(n)
        ens = []
        for i in range(dim - 1):
            old = vsides[i].copy()
            vsides[i] = n
            r = vm.cross(vsides)
            vsides[i] = old
            ens.append((r / sq).astype(f32))
        return Triangle(p1, n, ens, material)

    def to_points(self):
        """Recover the d points (tracer.hpp:490-506)."""
        dim = self.dimension
        enorms = self._en.copy()
        points = [Vector._wrap(self._p1)]
        for i in range(dim - 1):
            old = enorms[i].copy()
            enorms[i] = self._fn
            r = vm.cross(enorms)
            enorms[i] = old
            points.append(Vector._wrap((r + self._p1).astype(f32)))
        return points

    def _intersect_raw(self, o, dvec, cutoff):
        """tracer.hpp:411-440 exactly."""
        denom = vm.dot(self._fn, dvec)
        if denom == 0:
            return None
        t = -(vm.dot(self._fn, o) + self._d) / denom
        if t <= 0 or t >= cutoff:
            return None
        p = (o + t * dvec).astype(f32)
        pside = (self._p1 - p).astype(f32)
        tot_area = f32(0)
        for i in range(self.dimension - 1):
            area = vm.dot(self._en[i], pside)
            if area < -ROUNDING_FUZZ or area > 1 + ROUNDING_FUZZ:
                return None
            tot_area += area
        if tot_area <= 1 + ROUNDING_FUZZ:
            n = vm.unit(self._fn)
            if denom > 0:
                n = -n
            return float(t), p, n
        return None

    def __repr__(self):
        return f"Triangle(dimension={self.dimension})"

    def __reduce__(self):
        rows = np.concatenate([self._p1[None, :], self._fn[None, :], self._en])
        return _triangle_unpickle, (self.dimension, encode_floats(rows),
                                    self._material)


class TriangleBatch(PrimitiveBatch):
    """SoA batch of BATCH_SIZE triangles (tracer.hpp:532-641).

    On the device the ray and triangle axes of the kernels play this role;
    the API class is kept for compatibility (BATCH_SIZE here is a fixed 8,
    not a SIMD register width).
    """

    __slots__ = ("_p1", "_fn", "_en", "_d", "_materials")

    def __init__(self, triangles):
        tris = list(triangles)
        if len(tris) != BATCH_SIZE:
            raise TypeError(f"expected exactly {BATCH_SIZE} triangles")
        if not all(isinstance(t, Triangle) for t in tris):
            raise TypeError("all items must be Triangle instances")
        dim = tris[0].dimension
        if not all(t.dimension == dim for t in tris):
            raise TypeError("all triangles must have the same dimension")
        # SoA: (B, d) and (d-1, B, d)
        self._p1 = np.stack([t._p1 for t in tris])
        self._fn = np.stack([t._fn for t in tris])
        self._en = np.stack([t._en for t in tris], axis=1)
        self._d = np.asarray([t._d for t in tris], dtype=f32)
        self._materials = tuple(t._material for t in tris)

    @property
    def dimension(self):
        return self._p1.shape[1]

    @property
    def material(self):
        return self._materials

    def opaque(self, index):
        return self._materials[index].opacity >= 1

    def __len__(self):
        return BATCH_SIZE

    def __getitem__(self, i):
        if i < 0 or i >= BATCH_SIZE:
            raise IndexError("index out of range")
        return Triangle(self._p1[i], self._fn[i], self._en[:, i], self._materials[i])

    def __iter__(self):
        return (self[i] for i in range(BATCH_SIZE))

    def _intersect_raw(self, o, dvec, index, cutoff):
        """tracer.hpp:551-599: one ray vs all lanes; skip lane ``index``."""
        denom = self._fn @ dvec  # (B,)
        mask = denom != 0
        with np.errstate(divide="ignore", invalid="ignore"):
            t = -((self._fn @ o) + self._d) / denom
        mask &= t >= 0
        p = o[None, :] + t[:, None] * dvec[None, :]  # (B, d)
        pside = self._p1 - p
        tot = np.zeros(BATCH_SIZE, dtype=f32)
        for i in range(self.dimension - 1):
            area = np.einsum("bd,bd->b", self._en[i], pside).astype(f32)
            mask &= area >= -ROUNDING_FUZZ
            tot += area
        mask &= tot <= 1 + ROUNDING_FUZZ
        t = np.where(mask, t, 0).astype(f32)

        min_t = f32(cutoff)
        r_index = -1
        for i in range(BATCH_SIZE):
            if i != index and t[i] and t[i] < min_t:
                min_t = t[i]
                r_index = i
        if r_index == -1:
            return None
        n = vm.unit(self._fn[r_index])
        if denom[r_index] > 0:
            n = -n
        return float(min_t), p[r_index].astype(f32), n, r_index

    def __repr__(self):
        return f"TriangleBatch(dimension={self.dimension})"

    def __reduce__(self):
        dim = self.dimension
        # rows: p1, face_normal, edge normals; each row is batch_size*dim wide
        rows = np.concatenate(
            [self._p1.reshape(1, BATCH_SIZE, dim),
             self._fn.reshape(1, BATCH_SIZE, dim),
             self._en], axis=0)
        return _triangle_batch_unpickle, (
            BATCH_SIZE, dim, encode_floats(rows), *self._materials)


def hypercube_intersects_raw(o, dvec, cutoff=REAL_MAX):
    """tracer.hpp:126-152.  Returns (dist, point, normal) or None."""
    d = o.shape[0]
    for i in range(d):
        if dvec[i]:
            ni = f32(1) if dvec[i] < 0 else f32(-1)
            dist = (ni - o[i]) / dvec[i]
            if dist > 0:
                p = np.empty(d, dtype=f32)
                p[i] = ni
                ok = True
                for j in range(d):
                    if i != j:
                        p[j] = dvec[j] * dist + o[j]
                        if abs(p[j]) > 1 + ROUNDING_FUZZ:
                            ok = False
                            break
                if ok:
                    if dist >= cutoff:
                        return None
                    return float(dist), p, vm.axis_vector(d, i, ni)
    return None


def hypersphere_intersects_raw(o, dvec, cutoff=REAL_MAX):
    """tracer.hpp:154-173."""
    a = vm.square(dvec)
    b = 2 * vm.dot(dvec, o)
    c = vm.square(o) - 1
    disc = b * b - 4 * a * c
    if disc < 0:
        return None
    dist = (-b - f32(np.sqrt(disc))) / (2 * a)
    if dist <= 0 or dist >= cutoff:
        return None
    p = (o + dvec * dist).astype(f32)
    return float(dist), p, p.copy()


class Solid(Primitive):
    """Hypercube or hypersphere under an affine transform (tracer.hpp:231-289)."""

    __slots__ = ("_type", "_orientation", "_inv_orientation", "_position",
                 "_material")

    def __init__(self, type, position, orientation, material):
        stype = int(type)
        if stype not in (CUBE, SPHERE):
            raise ValueError("type must be CUBE or SPHERE")
        if not isinstance(orientation, Matrix):
            orientation = Matrix(len(list(position)), orientation)
        pos = _vector_arg(position, orientation.dimension)
        self._type = stype
        self._orientation = orientation._m
        self._inv_orientation = vm.inverse(orientation._m)
        self._position = pos
        self._material = _material_arg(material)

    @property
    def type(self):
        return self._type

    @property
    def dimension(self):
        return self._position.shape[0]

    @property
    def orientation(self):
        return Matrix._wrap(self._orientation)

    @property
    def inv_orientation(self):
        return Matrix._wrap(self._inv_orientation)

    @property
    def position(self):
        return Vector._wrap(self._position)

    def cube_normal(self, axis):
        return self._inv_orientation[axis]

    def cube_component(self, axis):
        return self._orientation[:, axis]

    def _intersect_raw(self, o, dvec, cutoff):
        """tracer.hpp:251-276."""
        to = (self._inv_orientation @ o - self._position).astype(f32)
        td = (self._inv_orientation @ dvec).astype(f32)
        if self._type == CUBE:
            hit = hypercube_intersects_raw(to, td, cutoff)
        else:
            hit = hypersphere_intersects_raw(to, td, cutoff)
        if hit is None:
            return None
        dist, p, n = hit
        wp = (self._orientation @ (p + self._position)).astype(f32)
        wn = (self._orientation @ n).astype(f32)
        return dist, wp, wn

    def __repr__(self):
        return f"Solid(type={self._type},dimension={self.dimension})"

    def __reduce__(self):
        values = bytes([self._type]) + encode_floats(
            np.concatenate([self._orientation.ravel(), self._position]))
        return _solid_unpickle, (self.dimension, values, self._material)


# ---------------------------------------------------------------------------
# Prototypes (build-time only; tracer.hpp:1363-1439, ntracer_body.hpp:2641+)
# ---------------------------------------------------------------------------

class TrianglePointData:
    """(point, edge_normal) pair (triangle_point, tracer.hpp:1384-1390)."""

    __slots__ = ("point", "edge_normal")

    def __init__(self, point, edge_normal):
        self.point = point
        self.edge_normal = edge_normal


class PrimitivePrototype:
    """Base: AABB + primitive (tracer.hpp:1363-1373)."""

    @property
    def dimension(self):
        return self.boundary.dimension


class TrianglePrototype(PrimitivePrototype):
    """Triangle + per-point edge-normal view (ntracer_body.hpp:2641-2712)."""

    def __init__(self, points, material=None):
        if isinstance(points, Triangle):
            if material is not None:
                raise TypeError('if "points" is an instance of Triangle, '
                                '"material" must be None')
            tri = points
            pts = [p._a if isinstance(p, Vector) else _vector_arg(p)
                   for p in tri.to_points()]
        else:
            if material is None:
                raise TypeError('if "points" is not an instance of Triangle, '
                                '"material" cannot be None')
            pts = [(_vector_arg(p)) for p in points]
            dim = check_dimension(pts[0].shape[0])
            if len(pts) != dim:
                raise TypeError(f"expected {dim} points")
            tri = Triangle.from_points(pts, material)

        pa = np.stack(pts)
        self.boundary = AABB._wrap(pa.min(axis=0).astype(f32),
                                   pa.max(axis=0).astype(f32))
        self.primitive = tri
        self._points = pa
        # first point's edge normal = -(sum of the stored edge normals)
        # (ntracer_body.hpp:2706-2712)
        self._first_edge_normal = (-tri._en.sum(axis=0)).astype(f32)

    @property
    def face_normal(self):
        return self.primitive.face_normal

    @property
    def material(self):
        return self.primitive.material

    @property
    def point_data(self):
        tri = self.primitive
        items = [TrianglePointData(Vector._wrap(self._points[0]),
                                   Vector._wrap(self._first_edge_normal))]
        for i in range(1, tri.dimension):
            items.append(TrianglePointData(Vector._wrap(self._points[i]),
                                           Vector._wrap(tri._en[i - 1])))
        return tuple(items)

    @staticmethod
    def batch_from_points(points, material):
        """Vectorized construction of N TrianglePrototypes from an
        (N, d, d) array of points — the OBJ-scale load path (a 300k-tri
        mesh spends ~1 min in the per-object constructor; this path is
        ~30× cheaper).  Every field is BIT-IDENTICAL to the scalar
        constructor: the crosses use the same Crout-LU cofactor routine
        vectorized over the batch (vm.batched_cross) and the dot
        products route to the same BLAS kernel as ``np.dot``.

        ``material`` is one Material applied to all prototypes, or a
        length-N sequence.  Framework extension: the reference has no
        batch constructor (its C++ per-object ctor is cheap).  Returns a
        :class:`TrianglePrototypeSequence` — an immutable sequence that
        materializes ordinary TrianglePrototype objects lazily on access
        (indexing/iteration), so the scene-build pipeline, which consumes
        the shared field arrays directly, never pays the 2N-object
        construction cost (measured ~6 s of a 300k-triangle build)."""
        pts = np.ascontiguousarray(np.asarray(points, dtype=f32))
        if pts.ndim != 3 or pts.shape[1] != pts.shape[2]:
            raise TypeError("expected an (N, d, d) array of points")
        n, d, _ = pts.shape
        check_dimension(d)

        p1 = pts[:, 0, :]
        vsides = pts[:, 1:, :] - p1[:, None, :]            # (N, d-1, d)
        fn = vm.batched_cross(vsides)
        # rowwise np.dot via batched matmul (bitwise-equal BLAS kernel)
        sq = (fn[:, None, :] @ fn[:, :, None])[:, 0, 0].astype(f32)
        ens = np.empty((n, d - 1, d), dtype=f32)
        with np.errstate(divide="ignore", invalid="ignore"):
            for i in range(d - 1):
                old = vsides[:, i].copy()
                vsides[:, i] = fn
                ens[:, i] = (vm.batched_cross(vsides)
                             / sq[:, None]).astype(f32)
                vsides[:, i] = old
        dplane = (-(fn[:, None, :] @ p1[:, :, None])[:, 0, 0]).astype(f32)
        lo = pts.min(axis=1).astype(f32)
        hi = pts.max(axis=1).astype(f32)
        fen = (-ens.sum(axis=1)).astype(f32)

        seq = None
        if isinstance(material, (list, tuple)):
            if len(material) != n:
                raise TypeError(f"expected {n} materials")
            seq = [_material_arg(m) for m in material]
        else:
            mat = _material_arg(material)

        # shared source arrays: consumers that need ALL rows again (the
        # k-d batching pass) fancy-index these instead of re-stacking
        # 300k small views (group_primitives fast path)
        src = dict(p1=p1, fn=fn, en=ens, d=dplane, pts=pts, fen=fen,
                   lo=lo, hi=hi)
        return TrianglePrototypeSequence(
            src, None if seq is not None else mat, seq)


class TrianglePrototypeSequence(_Sequence):
    """Lazy, immutable sequence of TrianglePrototypes over one shared set
    of field arrays (the return type of
    :meth:`TrianglePrototype.batch_from_points`).

    ``seq[i]`` / iteration materialize (and cache) ordinary
    TrianglePrototype objects, bit-identical to the scalar constructor's
    — user code that indexes or loops sees exactly what a list would
    hold.  The scene-build pipeline (scene._build, kdtree.build_tree /
    group_primitives, native.build_tree_native) detects ``_src_arrays``
    and consumes the arrays directly, so a 300k-triangle build
    materializes only the handful of prototypes left ungrouped by the
    batching pass instead of 600k Python objects.

    Deliberately NOT a list: mutation (append/+=) is unsupported;
    ``seq + other`` returns a materialized plain list."""

    def __init__(self, src, mat, mats):
        self._src_arrays = src
        self._mat = mat            # shared Material (mats is None)
        self._mats = mats          # or per-prototype list
        self._cache = [None] * len(src["p1"])

    def __len__(self):
        return len(self._cache)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self._cache)))]
        n = len(self._cache)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("prototype index out of range")
        tp = self._cache[i]
        if tp is None:
            src = self._src_arrays
            tri = Triangle.__new__(Triangle)
            tri._p1 = src["p1"][i]
            tri._fn = src["fn"][i]
            tri._en = src["en"][i]
            tri._d = src["d"][i]
            tri._material = self._material_at(i)
            tp = TrianglePrototype.__new__(TrianglePrototype)
            tp.primitive = tri
            tp.boundary = AABB._wrap(src["lo"][i], src["hi"][i])
            tp._points = src["pts"][i]
            tp._first_edge_normal = src["fen"][i]
            tp._src = (src, i)
            self._cache[i] = tp
        return tp

    def _material_at(self, i):
        return self._mat if self._mats is None else self._mats[i]

    @property
    def dimension(self):
        return self._src_arrays["pts"].shape[2]

    def __add__(self, other):
        return list(self) + list(other)

    def __radd__(self, other):
        return list(other) + list(self)

    def __repr__(self):
        return (f"TrianglePrototypeSequence(len={len(self._cache)}, "
                f"dimension={self.dimension})")


class TriangleBatchPrototype(PrimitivePrototype):
    """SoA prototype over BATCH_SIZE TrianglePrototypes
    (tracer.hpp:1407-1439, ntracer_body.hpp:2768+)."""

    def __init__(self, t_prototypes):
        if isinstance(t_prototypes, TriangleBatch):
            protos = [TrianglePrototype(t) for t in t_prototypes]
            batch = t_prototypes
        else:
            protos = list(t_prototypes)
            if len(protos) != BATCH_SIZE:
                raise TypeError(f"expected exactly {BATCH_SIZE} triangle prototypes")
            if not all(isinstance(p, TrianglePrototype) for p in protos):
                raise TypeError("all items must be TrianglePrototype instances")
            batch = TriangleBatch([p.primitive for p in protos])

        start = protos[0].boundary._start.copy()
        end = protos[0].boundary._end.copy()
        for p in protos[1:]:
            start = np.minimum(start, p.boundary._start)
            end = np.maximum(end, p.boundary._end)
        self.boundary = AABB._wrap(start.astype(f32), end.astype(f32))
        self.primitive = batch
        self._protos = protos
        self._points = np.stack([p._points for p in protos], axis=1)  # (d, B, d)
        self._first_edge_normal = np.stack(
            [p._first_edge_normal for p in protos])  # (B, d)

    @property
    def dimension(self):
        return self.boundary.dimension

    @property
    def face_normal(self):
        return FrozenVectorView(self.primitive._fn)

    @property
    def material(self):
        return self.primitive.material

    @property
    def point_data(self):
        batch = self.primitive
        items = [TrianglePointData(FrozenVectorView(self._points[0]),
                                   FrozenVectorView(self._first_edge_normal))]
        for i in range(1, self.dimension):
            items.append(TrianglePointData(FrozenVectorView(self._points[i]),
                                           FrozenVectorView(batch._en[i - 1])))
        return tuple(items)


class SolidPrototype(PrimitivePrototype):
    """Solid + AABB (ntracer_body.hpp:2912-2960)."""

    def __init__(self, type, position, orientation, material):
        if not isinstance(orientation, Matrix):
            raise TypeError("orientation must be a Matrix")
        pos = _vector_arg(position, orientation.dimension)
        solid = Solid(type, pos, orientation, material)
        self.primitive = solid
        d = pos.shape[0]
        if solid.type == CUBE:
            extent = np.abs(solid._orientation).sum(axis=1).astype(f32)
            self.boundary = AABB._wrap((pos - extent).astype(f32),
                                       (pos + extent).astype(f32))
        else:
            start = np.empty(d, dtype=f32)
            end = np.empty(d, dtype=f32)
            for i in range(d):
                normal = vm.unit(solid._orientation[i])
                hi = vm.dot(vm.axis_vector(d, i, 1) - pos, normal)
                lo = vm.dot(vm.axis_vector(d, i, -1) - pos, normal)
                if lo > hi:
                    hi, lo = lo, hi
                end[i] = hi
                start[i] = lo
            self.boundary = AABB._wrap(start, end)

    @property
    def material(self):
        return self.primitive.material

    @property
    def position(self):
        return self.primitive.position

    @property
    def orientation(self):
        return self.primitive.orientation


# ---------------------------------------------------------------------------
# Lights (light.hpp, tracer.hpp:1678-1698)
# ---------------------------------------------------------------------------

class PointLight:
    """Point light with 1/r^(d-1) falloff (tracer.hpp:1678-1689)."""

    __slots__ = ("_position", "_color")

    def __init__(self, position, color=None):
        from .render import Color, read_color
        self._position = _vector_arg(position)
        self._color = read_color(color) if color is not None else Color(1, 1, 1)

    @property
    def position(self):
        return Vector._wrap(self._position)

    @property
    def color(self):
        return self._color

    @property
    def dimension(self):
        return self._position.shape[0]

    def strength(self, distance):
        return float(1 / np.power(f32(distance), self.dimension - 1))


class GlobalLight:
    """Directional light (tracer.hpp:1691-1698)."""

    __slots__ = ("_direction", "_color")

    def __init__(self, direction, color=None):
        from .render import Color, read_color
        self._direction = _vector_arg(direction)
        self._color = read_color(color) if color is not None else Color(1, 1, 1)

    @property
    def direction(self):
        return Vector._wrap(self._direction)

    @property
    def color(self):
        return self._color

    @property
    def dimension(self):
        return self._direction.shape[0]
