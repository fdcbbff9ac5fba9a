"""Exact AABB-primitive tests and the SAH k-d tree builder.

Host-side (NumPy) port of the reference build pipeline:
  - separating-axis AABB/triangle tests  tracer.hpp:1465-1541
  - batch variants                        tracer.hpp:1543-1627
  - AABB/solid tests                      tracer.hpp:1629-1675
  - SAH split search                      tracer.hpp:1965-2054
  - node partitioning                     tracer.hpp:2284-2354
  - greedy triangle batching              tracer.hpp:2357-2427
  - build_kdtree                          tracer.hpp:2431-2455

The output feeds both the Python KD node objects (oracle traversal) and the
flattened device arrays for the device engine.  The hot path is the native C++
builder (ntracer_tpu/csrc/kd_builder.cpp), parallelized with a bounded thread pool like
the reference's kd_node_worker_pool (tracer.hpp:2131-2271) and controlled by
the user-visible ``extra_threads``; this NumPy implementation is the
fallback and stays single-threaded.
"""

from __future__ import annotations

import numpy as np

from . import _vecmath as vm
from .primitives import (TrianglePrototype, TriangleBatchPrototype,
                         SolidPrototype, CUBE, SPHERE)
from .api import AABB, BATCH_SIZE

f32 = np.float32

KD_DEFAULT_MAX_DEPTH = 25  # tracer.hpp:41 (batched variant)
KD_DEFAULT_SPLIT_THRESHOLD = 2  # tracer.hpp:44

# False (default) reproduces the reference's sphere-vs-AABB defect
# (tracer.hpp:1674) for bit-faithful tree builds; True uses the
# geometrically correct test so the ORACLE's tree agrees with the
# engine's global solid tests (see _aabb_solid and PARITY.md)
SOLID_AABB_EXACT = False


def default_cost_traversal(d: int) -> float:
    # tracer.hpp:1933-1941
    return {3: 0.0, 4: 1.0, 5: 8.0, 6: 500.0}.get(d, 700.0)


def default_cost_intersection(d: int) -> float:
    # tracer.hpp:1943-1948
    return 0.5 if d == 3 else 0.1


def _skip_dot(a, b, skip):
    """Dot product excluding one component (tracer.hpp:1448-1456)."""
    tot = f32(0)
    for i in range(a.shape[0]):
        if i != skip:
            tot += a[i] * b[i]
    return tot


def _tri_axes(proto):
    """Edge-normal axes in item order: first_edge_normal, then the stored
    edge normals (items()[i].edge_normal layout)."""
    tri = proto.primitive
    yield proto._first_edge_normal
    for i in range(tri._en.shape[0]):
        yield tri._en[i]


def _aabb_tri(start, end, proto: TrianglePrototype) -> bool:
    """tracer.hpp:1465-1512."""
    tb = proto.boundary
    if np.any(tb._start >= end) or np.any(tb._end <= start):
        return False

    d = start.shape[0]
    tri = proto.primitive
    pts = proto._points  # (d, d)
    n_offset = vm.dot(tri._fn, pts[0])
    origin = ((start + end) * f32(0.5)).astype(f32)
    po = vm.dot(origin, tri._fn)
    b_max = f32(np.sum(np.abs((end - start) / 2 * tri._fn)))
    b_min = po - b_max
    b_max += po
    if b_max < n_offset or b_min > n_offset:
        return False

    half = ((end - start) / 2).astype(f32)
    ax = np.concatenate([proto._first_edge_normal[None],
                         tri._en], axis=0).astype(f32)           # (a, d)

    # skip-dots vectorized over (point p, axis a, skipped dim j)
    full = np.einsum("pc,ac->pa", pts, ax, dtype=f32)
    term = pts[:, None, :] * ax[None, :, :]                      # (p, a, j)
    sd = full[:, :, None] - term
    t_min = sd.min(axis=0)                                       # (a, j)
    t_max = sd.max(axis=0)

    ofull = ax @ origin                                          # (a,)
    po2 = ofull[:, None] - origin[None, :] * ax                  # (a, j)

    habs = np.abs(half[None, :] * ax)                            # (a, j)
    b_rad = habs.sum(axis=1)[:, None] - habs
    # a zero radius means the axis is parallel to the skipped dimension and
    # the test is invalid (tracer.hpp:1505-1507)
    sep = (b_rad != 0) & ((po2 + b_rad <= t_min) | (po2 - b_rad >= t_max))
    return not sep.any()


def _aabb_tri_flat(start, end, proto: TrianglePrototype, skip: int) -> bool:
    """tracer.hpp:1514-1541."""
    d = start.shape[0]
    tb = proto.boundary
    for i in range(d):
        if i != skip and (tb._start[i] >= end[i] or tb._end[i] <= start[i]):
            return False

    origin = ((start + end) * f32(0.5)).astype(f32)
    pts = proto._points
    half = ((end - start) / 2).astype(f32)
    for i, axis in enumerate(_tri_axes(proto)):
        t_max = _skip_dot(pts[0], axis, skip)
        t_min = _skip_dot(pts[i if i else 1], axis, skip)
        if t_min > t_max:
            t_max, t_min = t_min, t_max
        po = _skip_dot(origin, axis, skip)
        b_max = f32(0)
        for k in range(d):
            if k != skip:
                b_max += abs(half[k] * axis[k])
        b_min = po - b_max
        b_max += po
        if b_max <= t_min or b_min >= t_max:
            return False
    return True


def _batch_axes(proto: TriangleBatchPrototype):
    batch = proto.primitive
    yield proto._first_edge_normal  # (B, d)
    for i in range(batch._en.shape[0]):
        yield batch._en[i]  # (B, d)


def _skip_dot_b(a, b, skip):
    """Lane-wise skip-dot for (B, d) arrays."""
    m = a * b
    return (m.sum(axis=-1) - m[..., skip]).astype(f32)


def _aabb_tri_batch(start, end, proto: TriangleBatchPrototype) -> bool:
    """tracer.hpp:1543-1591 — true unless every lane misses.

    Fully vectorized over (edge-axis a, skipped dim j, lane b): this is the
    SAH builder's hot test (thousands of calls per build)."""
    tb = proto.boundary
    if np.any(tb._start >= end) or np.any(tb._end <= start):
        return False

    d = start.shape[0]
    batch = proto.primitive
    pts = proto._points  # (d, B, d): point p, lane b, coord c
    n_offset = np.einsum("bd,bd->b", batch._fn, pts[0]).astype(f32)
    origin = ((start + end) * f32(0.5)).astype(f32)
    po = (batch._fn @ origin).astype(f32)
    b_max = np.sum(np.abs((end - start) / 2 * batch._fn), axis=1).astype(f32)
    b_min = po - b_max
    b_max = b_max + po
    miss = (b_max < n_offset) | (b_min > n_offset)
    if miss.all():
        return False

    half = ((end - start) / 2).astype(f32)
    ax = np.concatenate([proto._first_edge_normal[None],
                         batch._en], axis=0).astype(f32)  # (d, B, d)

    # skip-dots of every point against every axis with every dim skipped:
    # SD[p,a,j,b] = sum_{c != j} pts[p,b,c] * ax[a,b,c]
    full = np.einsum("pbc,abc->pab", pts, ax, dtype=f32)        # (d, a, B)
    term = np.einsum("pbj,abj->pajb", pts, ax, dtype=f32)       # (d, a, j, B)
    sd = full[:, :, None, :] - term
    t_min = sd.min(axis=0)                                      # (a, j, B)
    t_max = sd.max(axis=0)

    ofull = np.einsum("c,abc->ab", origin, ax, dtype=f32)       # (a, B)
    oterm = np.einsum("j,abj->ajb", origin, ax, dtype=f32)
    po2 = ofull[:, None, :] - oterm                             # (a, j, B)

    habs = np.abs(half[None, None, :] * ax)                     # (a, B, d)
    hfull = habs.sum(axis=2)                                    # (a, B)
    b_rad = hfull[:, None, :] - habs.transpose(0, 2, 1)         # (a, j, B)

    sep = (b_rad != 0) & ((po2 + b_rad <= t_min) | (po2 - b_rad >= t_max))
    miss = miss | sep.any(axis=(0, 1))
    return not miss.all()


def _aabb_tri_batch_flat(start, end, proto, skip: int) -> bool:
    """tracer.hpp:1593-1627, vectorized over (axis a, lane b)."""
    d = start.shape[0]
    tb = proto.boundary
    for i in range(d):
        if i != skip and (tb._start[i] >= end[i] or tb._end[i] <= start[i]):
            return False

    origin = ((start + end) * f32(0.5)).astype(f32)
    pts = proto._points                                          # (d, B, d)
    half = ((end - start) / 2).astype(f32)
    batch = proto.primitive
    ax = np.concatenate([proto._first_edge_normal[None],
                         batch._en], axis=0).astype(f32)         # (d, B, d)

    def skip_dot(v):  # v: (d, B, d) or broadcastable; -> (a, B)
        m = v * ax
        return (m.sum(axis=2) - m[:, :, skip]).astype(f32)

    tmp1 = skip_dot(pts[0][None])                                # (a, B)
    # per axis a, the second point is pts[a if a else 1]
    idx = np.arange(d)
    idx2 = np.where(idx == 0, 1, idx)
    p2 = pts[idx2]                                               # (a, B, d)
    m2 = p2 * ax
    tmp2 = (m2.sum(axis=2) - m2[:, :, skip]).astype(f32)
    t_max = np.maximum(tmp1, tmp2)
    t_min = np.minimum(tmp1, tmp2)

    po = skip_dot(origin[None, None, :])
    habs = np.abs(half[None, None, :] * ax)
    b_rad = habs.sum(axis=2) - habs[:, :, skip]
    miss = (po + b_rad <= t_min) | (po - b_rad >= t_max)
    return not miss.any(axis=0).all()


def _box_axis_test(solid, start, end, axis) -> bool:
    """tracer.hpp:1629-1639 — true when separated."""
    a_po = vm.dot(solid._position, axis)
    center = ((start + end) * f32(0.5)).astype(f32)
    b_po = vm.dot(center, axis)
    a_max = f32(0)
    for i in range(start.shape[0]):
        a_max += abs(vm.dot(solid._orientation[:, i], axis))
    b_max = f32(np.sum(np.abs((end - start) / 2 * axis)))
    return b_po + b_max < a_po - a_max or b_po - b_max > a_po + a_max


def _aabb_solid(start, end, proto: SolidPrototype) -> bool:
    """tracer.hpp:1641-1675."""
    solid = proto.primitive
    d = start.shape[0]
    if solid.type == CUBE:
        if np.any(end <= proto.boundary._start) or np.any(start >= proto.boundary._end):
            return False
        for i in range(d):
            normal = solid._inv_orientation[i].copy()
            if _box_axis_test(solid, start, end, normal):
                return False
            # project the normal onto each orthogonal hyperplane
            nsq = vm.square(normal)
            for j in range(d):
                axis = (normal * -normal[j]).astype(f32)
                axis[j] += nsq
                if _box_axis_test(solid, start, end, axis):
                    return False
        return True

    assert solid.type == SPHERE
    center = ((start + end) * f32(0.5)).astype(f32)
    box_p = (solid._position - solid._inv_orientation @ center).astype(f32)
    closest = np.zeros(d, dtype=f32)
    for i in range(d):
        component = (solid._orientation[i] * ((end[i] - start[i]) / 2)).astype(f32)
        c = vm.dot(box_p, component) / vm.square(component)
        c = f32(min(max(c, -1.0), 1.0))
        closest += c * component
    if SOLID_AABB_EXACT:
        # geometrically correct distance: sphere center minus the box's
        # closest point, both center-relative (matches the engine, which
        # tests solids against every ray regardless of cell membership)
        return vm.square((box_p - closest).astype(f32)) < 1
    # REFERENCE DEFECT (tracer.hpp:1674, verified against the compiled
    # C++ extension): `position - closest` compares the sphere's
    # absolute position with a CENTER-RELATIVE offset — correct only
    # when the cell is centered at the origin.  Subdivided cells drop
    # (or spuriously keep) the sphere, so the reference visibly clips
    # spheres at k-d planes while this package's engine renders them
    # whole (PARITY.md "solid k-d membership" deviation).
    return vm.square((solid._position - closest).astype(f32)) < 1


def aabb_intersects_prototype(start, end, proto) -> bool:
    if isinstance(proto, TrianglePrototype):
        return _aabb_tri(start, end, proto)
    if isinstance(proto, TriangleBatchPrototype):
        return _aabb_tri_batch(start, end, proto)
    if isinstance(proto, SolidPrototype):
        return _aabb_solid(start, end, proto)
    raise TypeError("object must be an instance of PrimitivePrototype")


def aabb_intersects_flat(start, end, proto, skip: int) -> bool:
    if isinstance(proto, TrianglePrototype):
        return _aabb_tri_flat(start, end, proto, skip)
    if isinstance(proto, TriangleBatchPrototype):
        return _aabb_tri_batch_flat(start, end, proto, skip)
    raise TypeError("object must be a triangle prototype")


# ---------------------------------------------------------------------------
# SAH split search (tracer.hpp:1965-2054)
# ---------------------------------------------------------------------------

class KDTreeParams:
    def __init__(self, dimension, max_depth=None, split_threshold=None,
                 traversal=None, intersection=None):
        self.max_depth = KD_DEFAULT_MAX_DEPTH if max_depth is None else int(max_depth)
        self.split_threshold = (KD_DEFAULT_SPLIT_THRESHOLD if split_threshold is None
                                else int(split_threshold))
        self.traversal = f32(default_cost_traversal(dimension)
                             if traversal is None else traversal)
        self.intersection = f32(default_cost_intersection(dimension)
                                if intersection is None else intersection)


def find_split(b_start, b_end, axis, contain_p, overlap_p, params):
    """Returns (found, pos).  Sweep over sorted start/end events."""
    d = b_start.shape[0]
    best_cost = f32(np.finfo(np.float32).max)
    pos = f32(0)

    cube_range = (b_end - b_start).astype(f32)
    side_area = f32(1)
    for i in range(d):
        if i != axis:
            side_area *= cube_range[i]

    shaft_area_factor = f32(0)
    for i in range(d):
        if i != axis:
            tmp = f32(1)
            for j in range(d):
                if j != i and j != axis:
                    tmp *= cube_range[j]
            shaft_area_factor += tmp

    area = side_area + shaft_area_factor * cube_range[axis]

    def split_cost(l_count, r_count, split):
        shaft_area = shaft_area_factor * (split - b_start[axis])
        l_area = side_area + shaft_area
        r_area = area - shaft_area
        return (params.traversal + params.intersection
                * (l_area / area * f32(l_count) + r_area / area * f32(r_count)))

    search = list(contain_p) + list(overlap_p)
    n = len(search)
    starts = np.asarray([p.boundary._start[axis] for p in search], dtype=f32)
    ends = np.asarray([p.boundary._end[axis] for p in search], dtype=f32)
    l_order = np.argsort(starts, kind="stable")
    r_order = np.argsort(ends, kind="stable")
    s_sorted = starts[l_order]
    e_sorted = ends[r_order]

    il = 1
    ir = 0
    last_split = s_sorted[0]
    last_il = 0
    found = False
    while il < n:
        split = min(s_sorted[il], e_sorted[ir])
        # not an optimization: needed for correct l/r counts
        if split != last_split:
            if b_end[axis] > last_split > b_start[axis]:
                cost = split_cost(last_il, n - ir, last_split)
                if cost < best_cost:
                    best_cost = cost
                    pos = last_split
                    found = True
            last_il = il
            last_split = split
        if s_sorted[il] <= e_sorted[ir]:
            il += 1
        else:
            ir += 1

    while ir < n:
        split = e_sorted[ir]
        if split != last_split:
            if b_end[axis] > last_split > b_start[axis]:
                cost = split_cost(n, n - ir, last_split)
                if cost < best_cost:
                    best_cost = cost
                    pos = last_split
                    found = True
            last_split = split
        ir += 1

    compare = f32(n)
    for i in range(d):
        compare *= b_end[i] - b_start[i]
    return (found and best_cost < compare), pos


def best_axis(b_start, b_end) -> int:
    widths = b_end - b_start
    return int(np.argmax(widths))


def _is_flat_skip(proto):
    """Flat-primitive axis handling (tracer.hpp:2326-2334)."""
    if isinstance(proto, (TrianglePrototype, TriangleBatchPrototype)):
        b = proto.boundary
        for i in range(b._start.shape[0]):
            if b._start[i] == b._end[i]:
                return i
    return -1


def _overlap_intersects(b_start, b_end, proto, skip, axis, right) -> bool:
    """tracer.hpp:2070-2087."""
    if skip < 0:
        return aabb_intersects_prototype(b_start, b_end, proto)
    if skip == axis:
        if right:
            return proto.boundary._start[axis] >= b_start[axis]
        return proto.boundary._start[axis] < b_end[axis]
    return aabb_intersects_flat(b_start, b_end, proto, skip)


def create_node(depth, b_start, b_end, contain_p, overlap_p, params, make_leaf,
                make_branch):
    """Recursive SAH build (tracer.hpp:2284-2354).

    ``make_leaf(protos)`` and ``make_branch(axis, split, left, right)``
    construct the output nodes, decoupling the builder from the node
    representation (Python KD objects or flat arrays).
    """
    depth += 1
    axis = best_axis(b_start, b_end)
    if not contain_p and not overlap_p:
        return None

    do_leaf = (depth >= params.max_depth
               or len(contain_p) + len(overlap_p) <= params.split_threshold)
    split = None
    if not do_leaf:
        found, split = find_split(b_start, b_end, axis, contain_p, overlap_p, params)
        do_leaf = not found
    if do_leaf:
        return make_leaf(list(contain_p) + list(overlap_p))

    l_contain, r_contain = [], []
    l_overlap, r_overlap = [], []

    for p in contain_p:
        if p.boundary._start[axis] < split:
            if p.boundary._end[axis] <= split:
                l_contain.append(p)
            else:
                l_overlap.append(p)
                r_overlap.append(p)
        else:
            r_contain.append(p)

    lb_end = b_end.copy()
    lb_end[axis] = split
    rb_start = b_start.copy()
    rb_start[axis] = split

    for p in overlap_p:
        skip = _is_flat_skip(p)
        if _overlap_intersects(b_start, lb_end, p, skip, axis, False):
            l_overlap.append(p)
            if _overlap_intersects(rb_start, b_end, p, skip, axis, True):
                r_overlap.append(p)
        else:
            r_overlap.append(p)

    left = create_node(depth, b_start, lb_end, l_contain, l_overlap, params,
                       make_leaf, make_branch)
    right = create_node(depth, rb_start, b_end, r_contain, r_overlap, params,
                        make_leaf, make_branch)
    return make_branch(axis, split, left, right)


# ---------------------------------------------------------------------------
# Greedy triangle batching (tracer.hpp:2357-2427)
# ---------------------------------------------------------------------------

def grouping_metric(a, b) -> float:
    combined = (np.maximum(a.boundary._end, b.boundary._end)
                - np.minimum(a.boundary._start, b.boundary._start)).astype(f32)
    d = combined.shape[0]
    m = f32(0)
    for i in range(d):
        surface = f32(1)
        for j in range(d):
            if i != j:
                surface *= combined[j]
        m += surface
    return float(m)


GROUP_WINDOW = 96  # candidate-scan bound; tests compare vs unbounded


def group_primitives(primitives):
    """Greedy grouping of TrianglePrototypes into TriangleBatchPrototypes
    minimizing combined-AABB surface.  Returns a new list."""
    if BATCH_SIZE <= 1 or not len(primitives):
        return list(primitives)

    # Lazy batch_from_points sequence: all-triangle, one shared source,
    # row i == index i — no object is touched at all on this path; only
    # the handful of prototypes left ungrouped are materialized at the
    # end (the 300k build's tail was exactly this object
    # materialization).
    lazy = getattr(primitives, "_src_arrays", None)
    if lazy is not None:
        starts0 = lazy["lo"]
        ends0 = lazy["hi"]
        is_tri0 = None
    else:
        # AABB rows for every prototype, fancy-indexed from the shared
        # source arrays when all prototypes come from one
        # batch_from_points call.  ONE pass collects the source ids, row
        # indices and triangle flags (four separate comprehensions here
        # were ~2 s of a 300k build).
        src0 = getattr(primitives[0], "_src", None)
        rows0_list = []
        is_tri0 = []
        shared = src0 is not None
        for p in primitives:
            is_tri0.append(isinstance(p, TrianglePrototype))
            if shared:
                s = getattr(p, "_src", None)
                if s is None or s[0] is not src0[0]:
                    shared = False
                else:
                    rows0_list.append(s[1])
        if shared:
            rows0 = np.asarray(rows0_list)
            starts0 = src0[0]["lo"][rows0]
            ends0 = src0[0]["hi"][rows0]
        else:
            starts0 = np.stack([p.boundary._start for p in primitives])
            ends0 = np.stack([p.boundary._end for p in primitives])

    axis = best_axis(starts0.min(axis=0), ends0.max(axis=0))

    # stable center sort (same key and tie order as sorted(key=center))
    centers = (starts0[:, axis] + ends0[:, axis]) * f32(0.5)
    perm = np.argsort(centers, kind="stable")
    items = None if lazy is not None else [primitives[i] for i in perm]
    starts = starts0[perm]
    ends = ends0[perm]

    # The reference scans every remaining prototype for each pivot (an O(n^2)
    # pass, tracer.hpp:2406-2423).  After the center sort, good batch mates
    # are nearby, so we bound the scan to a window; this only affects batch
    # quality (performance), never correctness.  Measured on a 1200-triangle
    # random scene (tests/test_api.py::test_group_window_quality): the
    # windowed pass BEATS the exhaustive scan's total combined-AABB
    # surface (0.92x) — the center sort steers pivots toward local mates.
    WINDOW = GROUP_WINDOW

    def window_metrics(pi, idxs):
        """grouping_metric (combined-AABB surface) vectorized over
        candidates, with leave-one-out products to tolerate zero extents."""
        comb = (np.maximum(ends[pi][None], ends[idxs])
                - np.minimum(starts[pi][None], starts[idxs])).astype(f32)
        n_, dd = comb.shape
        prefix = np.ones((n_, dd + 1), f32)
        suffix = np.ones((n_, dd + 1), f32)
        for k in range(dd):
            prefix[:, k + 1] = prefix[:, k] * comb[:, k]
            suffix[:, dd - 1 - k] = suffix[:, dd - k] * comb[:, dd - 1 - k]
        # surface term i = prod of all dims except i; accumulate
        # SEQUENTIALLY in f32 so the native ntr_group_select computes the
        # identical metric (numpy's pairwise sum diverges above 8 dims)
        loo = prefix[:, :dd] * suffix[:, 1:]
        m = np.zeros(n_, f32)
        for k in range(dd):
            m = m + loo[:, k]
        return m

    # Greedy selection with O(live) scans: a linked list over the LIVE
    # triangle candidates replaces re-walking consumed slots, and the
    # chosen groups are recorded as index lists so every
    # TriangleBatchPrototype is constructed in ONE vectorized pass at the
    # end (the per-batch np.stack constructor dominated large builds:
    # 22 s of a 27 s 300k-triangle scene build).  Selection order,
    # tie-breaking (stable sort = (metric, index)), and the early-exit
    # rule are IDENTICAL to the per-item loop this replaces.
    n = len(perm)
    # permute the single-pass flags rather than re-test 300k types
    is_tri = (np.ones(n, np.uint8) if lazy is not None
              else [is_tri0[i] for i in perm])

    # the selection loop lives in the native builder library when
    # available (ntr_group_select, bit-for-bit the same decisions —
    # pinned by tests); the Python loop below is the fallback
    from . import native as _native
    ng = _native.group_select(starts, ends, np.asarray(is_tri, np.uint8),
                              WINDOW, BATCH_SIZE)
    if ng is not None:
        groups = ng.tolist()
    else:
        nxt = list(range(1, n + 1))  # next live tri candidate >= slot+1
        prv = list(range(-1, n - 1))
        consumed = [False] * n
        groups = []                  # chosen indices incl pivot, per group

        def unlink(j):
            consumed[j] = True
            a, b = prv[j], nxt[j]
            if a >= 0:
                nxt[a] = b
            if b < n:
                prv[b] = a

        for pi in range(n):
            if consumed[pi] or not is_tri[pi]:
                continue
            idxs = []
            pj = nxt[pi]
            while pj < n and len(idxs) < WINDOW:
                if is_tri[pj]:
                    idxs.append(pj)
                pj = nxt[pj]
            if len(idxs) < BATCH_SIZE - 1:
                break
            idxs = np.asarray(idxs)
            metrics = window_metrics(pi, idxs)
            order = np.argsort(metrics, kind="stable")[:BATCH_SIZE - 1]
            chosen = [pi] + idxs[order].tolist()
            groups.append(chosen)
            for j in chosen:
                unlink(j)

    if not groups:
        if lazy is not None:
            return [primitives[int(i)] for i in perm]
        return list(items)

    # one vectorized construction pass for every batch
    garr = np.asarray(groups)
    if lazy is not None:
        # lazy input: all triangles, source row == original index
        src = lazy
        rows = perm
        gi = garr
        shared_mats = ((primitives._mat,) * BATCH_SIZE
                       if primitives._mats is None else None)
        p1_all = src["p1"][rows]
        fn_all = src["fn"][rows]
        en_all = src["en"][rows]
        dv_all = src["d"][rows]
        pt_all = src["pts"][rows]
        fe_all = src["fen"][rows]
    else:
        shared_mats = None
        tri_idx = [i for i in range(n) if is_tri[i]]
        pos = {i: k for k, i in enumerate(tri_idx)}
        srcs = {id(items[i]._src[0]) for i in tri_idx
                if getattr(items[i], "_src", None) is not None}
        if len(srcs) == 1 and all(getattr(items[i], "_src", None) is not None
                                  for i in tri_idx):
            # batch_from_points fast path: every prototype's fields are
            # rows of ONE shared array set — fancy-index it instead of
            # stacking 300k small views (~3 s at 300k triangles)
            src = items[tri_idx[0]]._src[0]
            rows = np.asarray([items[i]._src[1] for i in tri_idx])
            p1_all = src["p1"][rows]
            fn_all = src["fn"][rows]
            en_all = src["en"][rows]
            dv_all = src["d"][rows]
            pt_all = src["pts"][rows]
            fe_all = src["fen"][rows]
        else:
            p1_all = np.stack([items[i].primitive._p1 for i in tri_idx])
            fn_all = np.stack([items[i].primitive._fn for i in tri_idx])
            en_all = np.stack([items[i].primitive._en for i in tri_idx])
            dv_all = np.asarray([items[i].primitive._d for i in tri_idx],
                                dtype=f32)
            pt_all = np.stack([items[i]._points for i in tri_idx])
            fe_all = np.stack([items[i]._first_edge_normal
                               for i in tri_idx])
        gi = np.asarray([[pos[j] for j in chosen] for chosen in groups])

    g_p1 = p1_all[gi]                       # (G, B, d)
    g_fn = fn_all[gi]
    g_en = en_all[gi].transpose(0, 2, 1, 3)  # (G, d-1, B, d)
    g_dv = dv_all[gi]
    g_pt = pt_all[gi].transpose(0, 2, 1, 3)  # (G, d, B, d)
    g_fe = fe_all[gi]
    g_lo = starts[garr].min(axis=1).astype(f32)
    g_hi = ends[garr].max(axis=1).astype(f32)

    from .primitives import TriangleBatch
    batch_objs = []
    for g, chosen in enumerate(groups):
        batch = TriangleBatch.__new__(TriangleBatch)
        batch._p1 = g_p1[g]
        batch._fn = g_fn[g]
        batch._en = g_en[g]
        batch._d = g_dv[g]
        batch._materials = (shared_mats if shared_mats is not None else
                            tuple((primitives._mats[int(perm[j])]
                                   if lazy is not None
                                   else items[j].primitive._material)
                                  for j in chosen))
        bp = TriangleBatchPrototype.__new__(TriangleBatchPrototype)
        bp.primitive = batch
        bp.boundary = AABB._wrap(g_lo[g], g_hi[g])
        # the member prototypes; unread internally — kept None on the
        # lazy path so grouping never materializes per-triangle objects
        bp._protos = None if lazy is not None else [items[j]
                                                    for j in chosen]
        bp._points = g_pt[g]
        bp._first_edge_normal = g_fe[g]
        batch_objs.append(bp)

    if lazy is None:
        out = list(items)
        for g, chosen in enumerate(groups):
            out[chosen[0]] = batch_objs[g]
            for j in chosen[1:]:
                out[j] = None
        return [p for p in out if p is not None]

    # lazy output: keep pivot slots (→ batch) + unconsumed slots
    # (→ materialized leftover prototypes, at most ~WINDOW+BATCH of
    # them), and attach the native builder's input arrays so
    # build_tree_native never walks the objects either
    slot = np.full(n, -1, np.int64)
    slot[garr[:, 0]] = np.arange(len(groups))
    consumed = np.zeros(n, bool)
    consumed[garr.ravel()] = True
    kidx = np.flatnonzero((slot >= 0) | ~consumed)
    out = GroupedPrototypeList(
        batch_objs[slot[i]] if slot[i] >= 0 else primitives[int(perm[i])]
        for i in kidx)

    isb = slot[kidx] >= 0
    n_out = len(kidx)
    d = starts.shape[1]
    tri_count = np.where(isb, BATCH_SIZE, 1).astype(np.int32)
    off = np.zeros(n_out + 1, np.int64)
    np.cumsum(tri_count, out=off[1:])
    lane_rows = np.empty(off[-1], np.int64)
    bsel = np.flatnonzero(isb)
    if len(bsel):
        lanes = off[bsel][:, None] + np.arange(BATCH_SIZE)
        lane_rows[lanes.ravel()] = perm[garr[slot[kidx[bsel]]]].ravel()
    ssel = np.flatnonzero(~isb)
    if len(ssel):
        lane_rows[off[ssel]] = perm[kidx[ssel]]
    ent_lo = np.empty((n_out, d), f32)
    ent_hi = np.empty((n_out, d), f32)
    ent_lo[isb] = g_lo[slot[kidx[bsel]]] if len(bsel) else 0
    ent_hi[isb] = g_hi[slot[kidx[bsel]]] if len(bsel) else 0
    ent_lo[~isb] = starts[kidx[ssel]] if len(ssel) else 0
    ent_hi[~isb] = ends[kidx[ssel]] if len(ssel) else 0
    out._assembly = dict(src=lazy, b_start=ent_lo, b_end=ent_hi,
                         tri_count=tri_count, lane_rows=lane_rows)
    return out


class GroupedPrototypeList(list):
    """group_primitives output on the lazy path: a plain list of grouped
    prototypes plus ``_assembly`` — the native SAH builder's input arrays
    (per-entry AABBs, member counts, and source-row indices for the
    per-lane triangle data), precomputed here where everything is already
    in array form so native.build_tree_native skips its per-object
    stacking pass."""

    _assembly = None


def build_tree(prototypes, params: KDTreeParams, make_leaf, make_branch,
               group=True, extra_threads=-1):
    """Merge AABBs, group into batches, run the SAH build.

    Returns ``(b_start, b_end, root, grouped_prototypes)``.
    """
    if not len(prototypes):
        raise ValueError("cannot build tree from empty sequence")
    src = getattr(prototypes, "_src_arrays", None)
    if src is not None:
        # lazy batch_from_points sequence: merge the AABB rows directly.
        # ufunc.reduce is the same sequential left fold as the object
        # loop below, so the result is bit-identical (incl. ±0.0 ties).
        b_start = np.minimum.reduce(src["lo"], axis=0)
        b_end = np.maximum.reduce(src["hi"], axis=0)
    else:
        b_start = prototypes[0].boundary._start.copy()
        b_end = prototypes[0].boundary._end.copy()
        for p in prototypes[1:]:
            b_start = np.minimum(b_start, p.boundary._start)
            b_end = np.maximum(b_end, p.boundary._end)

    grouped = group_primitives(prototypes) if group else list(prototypes)

    # native C++ SAH builder (ntracer_tpu/csrc/kd_builder.cpp); NumPy fallback below
    from . import native
    root = native.build_tree_native(grouped, params, make_leaf, make_branch,
                                    extra_threads=extra_threads)
    if root is None:
        root = create_node(-1, b_start.copy(), b_end.copy(), grouped, [],
                           params, make_leaf, make_branch)
    return b_start, b_end, root, grouped
