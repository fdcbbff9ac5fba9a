"""KD node API objects and the exact (scalar) traversal oracle.

``KDNode``/``KDBranch``/``KDLeaf`` mirror the reference's Python-visible tree
(ntracer_body.hpp KDNode/KDBranch/KDLeaf; traversal kernels
tracer.hpp:1159-1311).  The scalar traversal here is the correctness oracle
(and powers ``KDNode.intersects``/``occludes`` and
``Scene.calculate_color``); frame rendering uses the JAX engine, which
re-derives the same results from flattened arrays.
"""

from __future__ import annotations

import numpy as np

from .api import Vector, _vector_arg
from .primitives import (Triangle, TriangleBatch, Solid, Primitive,
                         RayIntersection)

f32 = np.float32
REAL_MAX = float(np.finfo(np.float32).max)
REAL_LOWEST = float(np.finfo(np.float32).min)


class KDNode:
    """Base node; enforces single-parent ownership
    (ntracer_body.hpp:1641-1653 ``acceptable_node``)."""

    __slots__ = ("_has_parent",)

    def __init__(self):
        self._has_parent = False

    def _claim(self):
        if self._has_parent:
            raise ValueError(
                "a k-d tree node cannot be a child of more than one node")
        self._has_parent = True

    # Python-level query API (ntracer_body.hpp:1412-1497)
    def intersects(self, origin, direction, t_near=REAL_LOWEST, t_far=REAL_MAX,
                   source=None, batch_index=-1):
        o = _vector_arg(origin)
        dvec = _vector_arg(direction, o.shape[0])
        skip = _SkipTarget(source, batch_index)
        state = _TraversalState(o, dvec, skip)
        did_hit = _intersects(self, state, f32(t_near), f32(t_far))
        r = [RayIntersection(h[0], h[1], h[2], h[3], h[4])
             for h in state.t_hits]
        if did_hit:
            r.append(RayIntersection(state.o_dist, state.o_point,
                                     state.o_normal, state.o_prim,
                                     state.o_index))
        return r

    def occludes(self, origin, direction, distance=REAL_MAX,
                 t_near=REAL_LOWEST, t_far=REAL_MAX, source=None,
                 batch_index=-1):
        o = _vector_arg(origin)
        dvec = _vector_arg(direction, o.shape[0])
        skip = _SkipTarget(source, batch_index)
        hits = []
        occ = _occludes(self, o, dvec, _safe_inv(dvec), f32(distance), skip,
                        hits, f32(t_near), f32(t_far))
        if occ:
            return True, None
        return False, [RayIntersection(h[0], h[1], h[2], h[3], h[4])
                       for h in hits]


class KDBranch(KDNode):
    """Inner node: axis/split/left/right (tracer.hpp:813-830).

    Copy/pickle clone the subtree (kd_node::clone tracer.hpp:799,
    ntracer_body.hpp:1594-1623) since children are single-parent."""

    __slots__ = ("axis", "split", "left", "right")

    def __copy__(self):
        return KDBranch(self.axis, self.split,
                        _clone(self.left), _clone(self.right))

    __deepcopy__ = lambda self, memo: self.__copy__()

    def __reduce__(self):
        return (KDBranch, (self.axis, self.split, _clone(self.left),
                           _clone(self.right)))

    def __init__(self, axis, split, left=None, right=None):
        super().__init__()
        for c in (left, right):
            if c is not None:
                if not isinstance(c, KDNode):
                    raise TypeError("child nodes must be KDNode instances or None")
                c._claim()
        self.axis = int(axis)
        self.split = float(f32(split))
        self.left = left
        self.right = right

    @property
    def dimension(self):
        for c in (self.left, self.right):
            if c is not None:
                return c.dimension
        return None


def _clone(node):
    return None if node is None else node.__copy__()


def _is_batch(p):
    return isinstance(p, TriangleBatch)


class KDLeaf(KDNode):
    """Leaf: a sequence of primitives, batches partitioned first
    (tracer.hpp:950-1151).  The partition is stable (the reference uses
    std::partition; only order among non-batches vs batches matters)."""

    __slots__ = ("_items", "batches")

    def __init__(self, primitives):
        super().__init__()
        prims = list(primitives)
        if not prims:
            raise ValueError("a KDLeaf cannot be empty")
        for p in prims:
            if not isinstance(p, (Primitive, TriangleBatch)):
                raise TypeError("all items must be primitives")
        batched = [p for p in prims if _is_batch(p)]
        rest = [p for p in prims if not _is_batch(p)]
        self._items = tuple(batched + rest)
        self.batches = len(batched)

    def __copy__(self):
        return KDLeaf(self._items)

    __deepcopy__ = lambda self, memo: self.__copy__()

    def __reduce__(self):
        return (KDLeaf, (list(self._items),))

    @property
    def dimension(self):
        return self._items[0].dimension

    def __len__(self):
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __iter__(self):
        return iter(self._items)


# ---------------------------------------------------------------------------
# Scalar traversal (tracer.hpp:1159-1311), ported exactly.
# Hits are tuples (dist, point, normal, primitive, batch_index).
# ---------------------------------------------------------------------------

class _SkipTarget:
    __slots__ = ("p", "index")

    def __init__(self, p, index):
        self.p = p
        self.index = int(index)


class _TraversalState:
    __slots__ = ("origin", "direction", "invdir", "skip", "o_dist", "o_point",
                 "o_normal", "o_prim", "o_index", "t_hits", "checked")

    def __init__(self, origin, direction, skip):
        self.origin = origin
        self.direction = direction
        self.invdir = _safe_inv(direction)
        self.skip = skip
        self.o_dist = f32(REAL_MAX)
        self.o_point = None
        self.o_normal = None
        self.o_prim = None
        self.o_index = -1
        self.t_hits = []
        self.checked = []  # identity list (prim_list, tracer.hpp:782)


def _safe_inv(direction):
    with np.errstate(divide="ignore"):
        return (f32(1) / direction).astype(f32)


def _trim(t_hits, dist, start):
    """trim_intersections (tracer.hpp:784-789)."""
    i = start
    while i < len(t_hits):
        if t_hits[i][0] >= dist:
            # swap-remove like quick_list::remove_at
            t_hits[i] = t_hits[-1]
            t_hits.pop()
        else:
            i += 1


def _leaf_intersects(leaf: KDLeaf, st: _TraversalState) -> bool:
    """kd_leaf<Store,true>::intersects (tracer.hpp:977-1086)."""
    h_start = len(st.t_hits)
    checked = st.checked
    skip = st.skip
    found = False

    for i, item in enumerate(leaf._items):
        if i < leaf.batches:
            if any(c is item for c in checked):
                continue
            index = skip.index if skip.p is item else -1
            hit = item._intersect_raw(st.origin, st.direction, index, st.o_dist)
            checked.append(item)
            if hit:
                dist, p, n, lane = hit
                if item._materials[lane].opacity >= 1:
                    st.o_dist = f32(dist)
                    st.o_point = p
                    st.o_normal = n
                    st.o_prim = item
                    st.o_index = lane
                    found = True
                else:
                    st.t_hits.append((dist, p, n, item, lane))
        else:
            if item is skip.p or any(c is item for c in checked):
                continue
            hit = item._intersect_raw(st.origin, st.direction, st.o_dist)
            checked.append(item)
            if hit:
                dist, p, n = hit
                if item.opaque():
                    st.o_dist = f32(dist)
                    st.o_point = p
                    st.o_normal = n
                    st.o_prim = item
                    st.o_index = -1
                    found = True
                else:
                    st.t_hits.append((dist, p, n, item, -1))

    if found:
        # Deviation from the reference: tracer.hpp:911/1084 trims against the
        # *last computed* dist (0 when the final item missed, dropping valid
        # transparent hits).  We trim against the final opaque distance,
        # which is the clearly intended semantics.
        _trim(st.t_hits, st.o_dist, h_start)
    return found


def _intersects(node, st: _TraversalState, t_near, t_far) -> bool:
    """kd_node_intersection::operator() (tracer.hpp:1179-1243)."""
    while node is not None:
        if isinstance(node, KDLeaf):
            return _leaf_intersects(node, st)

        axis = node.axis
        split = f32(node.split)
        d_axis = st.direction[axis]
        o_axis = st.origin[axis]

        if d_axis:
            if o_axis == split:
                node = node.right if d_axis > 0 else node.left
                continue

            t = (split - o_axis) * st.invdir[axis]

            if o_axis > split:
                n_near, n_far = node.right, node.left
            else:
                n_near, n_far = node.left, node.right

            if t < 0 or t > t_far:
                node = n_near
                continue
            if t < t_near:
                node = n_far
                continue

            if n_near is not None:
                h_start = len(st.t_hits)
                hit = _intersects(n_near, st, t_near, t)
                if (hit and st.o_dist <= t) or n_far is None:
                    return hit
                if hit:
                    # the intersection may lie in a farther division
                    # (primitives can span nodes) — tracer.hpp:1216-1231
                    if _intersects(n_far, st, t, t_far):
                        _trim(st.t_hits, st.o_dist, h_start)
                    return True

            assert n_far is not None
            node = n_far
            t_near = t
            continue

        node = node.right if o_axis >= split else node.left
    return False


def _leaf_occludes(leaf: KDLeaf, o, dvec, ldistance, skip, hits) -> bool:
    """kd_leaf<Store,true>::occludes (tracer.hpp:1088-1124)."""
    for i, item in enumerate(leaf._items):
        if i < leaf.batches:
            index = skip.index if skip.p is item else -1
            hit = item._intersect_raw(o, dvec, index, ldistance)
            if hit:
                dist, p, n, lane = hit
                if item._materials[lane].opacity >= 1:
                    return True
                hits.append((dist, p, n, item, lane))
        else:
            if item is skip.p:
                continue
            hit = item._intersect_raw(o, dvec, ldistance)
            if hit:
                dist, p, n = hit
                if item.opaque():
                    return True
                hits.append((dist, p, n, item, -1))
    return False


# The reference's occlusion walk returns "not occluded" whenever the near
# child misses and the split plane is closer than the light (tracer.hpp:1298)
# — for infinite-distance (global) lights that skips every far child, missing
# real occluders.  The port keeps it (reference-exact, the default); the
# device engine uses true any-hit semantics, and scripts/device_parity.py flips
# this flag to validate the engine against exact occlusion.
OCCLUDES_EARLY_OUT = True


def _occludes(node, o, dvec, invdir, ldistance, skip, hits, t_near, t_far) -> bool:
    """_occludes (tracer.hpp:1258-1307), ported exactly including the
    ``t < ldistance`` early-out (see OCCLUDES_EARLY_OUT)."""
    while node is not None:
        if isinstance(node, KDLeaf):
            return _leaf_occludes(node, o, dvec, ldistance, skip, hits)

        axis = node.axis
        split = f32(node.split)
        d_axis = dvec[axis]
        o_axis = o[axis]

        if d_axis:
            if o_axis == split:
                node = node.right if d_axis > 0 else node.left
                continue

            t = (split - o_axis) * invdir[axis]

            n_near, n_far = node.left, node.right
            if o_axis > split:
                n_near, n_far = node.right, node.left

            if t < 0 or t > t_far:
                node = n_near
                continue
            if t < t_near:
                node = n_far
                continue

            if n_near is not None:
                if n_far is None:
                    t_far = t
                    node = n_near
                    continue
                if _occludes(n_near, o, dvec, invdir, ldistance, skip, hits,
                             t_near, t):
                    return True

            assert n_far is not None
            if OCCLUDES_EARLY_OUT and t < ldistance:
                return False
            t_near = t
            node = n_far
            continue

        node = node.right if o_axis >= split else node.left
    return False
