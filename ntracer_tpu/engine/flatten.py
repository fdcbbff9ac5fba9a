"""Scene flattening: Python KD tree / primitives -> SoA device arrays.

The reference's pointer-chasing KDBranch/KDLeaf tree with per-primitive
virtual dispatch (tracer.hpp:792-1157) becomes, for the device engine:

  * one SoA triangle pool (every triangle from every TriangleBatch/Triangle,
    ordered by k-d leaf traversal so pool chunks are spatially coherent),
  * per-triangle AABBs (chunk AABBs derive from them for per-tile culling),
  * one SoA solid pool,
  * a material table and light arrays.

The pool is padded to a multiple of the chunk size with degenerate
triangles (zero face normal => zero denominator => never hit).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..kdnodes import KDLeaf
from ..primitives import Triangle, TriangleBatch, Solid

f32 = np.float32


@dataclass(frozen=True)
class SceneConfig:
    """Static (hashable) compile-time configuration for the jit kernels."""
    d: int
    n_tris: int
    n_solids: int
    n_point_lights: int
    n_global_lights: int
    shadows: bool
    camera_light: bool
    max_reflect_depth: int
    bg_axis: int
    has_transparency: bool
    has_reflectivity: bool
    max_transparent_hits: int
    # mesh axis name for a sharded triangle pool (tensor-parallel trace);
    # None on a single chip.  Set via dataclasses.replace by parallel.mesh.
    prim_axis: str | None = None


@dataclass
class FlatScene:
    """Host-side flattened scene (numpy); device transfer happens in the
    engine.  ``prim_objects`` maps device primitive ids back to API objects
    (triangle id -> (object, batch_index), then solids)."""
    config: SceneConfig
    arrays: dict
    prim_objects: list = field(default_factory=list)


def _walk_leaves(root):
    leaves = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, KDLeaf):
            leaves.append(node)
            return
        walk(node.left)
        walk(node.right)

    walk(root)
    return leaves


def triangle_vertices(p1: np.ndarray, fn: np.ndarray, en: np.ndarray) -> np.ndarray:
    """Vectorized ``to_points`` (tracer.hpp:490-506) for N triangles:
    (N,d),(N,d),(N,d-1,d) -> (N,d,d) vertex array.  Uses np.linalg.det for
    the generalized-cross minors (bounds use only — the API ``to_points``
    keeps the reference's exact scalar arithmetic)."""
    n, d = p1.shape
    verts = np.empty((n, d, d), dtype=f32)
    verts[:, 0] = p1
    for i in range(d - 1):
        rows = en.copy()
        rows[:, i] = fn
        # cross_: r[k] = sign * det(minor skipping column k of rows^T)
        cross = np.empty((n, d), dtype=f32)
        sign = 1.0 if d % 2 else -1.0
        for k in range(d):
            cols = [c for c in range(d) if c != k]
            # tmp[k'][j] = rows[j][k'] -> minor is rows[:, :, cols] transposed
            minor = rows[:, :, cols].transpose(0, 2, 1).astype(np.float64)
            cross[:, k] = (sign * np.linalg.det(minor)).astype(f32)
            sign = -sign
        verts[:, i + 1] = cross + p1
    return verts


def flatten_composite(scene, chunk: int = 512,
                      max_transparent_hits: int = 8) -> FlatScene:
    """Flatten a CompositeScene into device-ready arrays."""
    d = scene.dimension
    leaves = _walk_leaves(scene.root)

    materials = []
    mat_index = {}

    def mat_id(m):
        k = id(m)
        if k not in mat_index:
            mat_index[k] = len(materials)
            materials.append(m)
        return mat_index[k]

    tri_p1, tri_fn, tri_en, tri_dc, tri_mat = [], [], [], [], []
    tri_objects = []
    solids = []
    solid_objects = []
    sol_mat = []
    seen = set()

    for leaf in leaves:
        for item in leaf:
            if id(item) in seen:
                # a primitive spanning several leaves enters the pool once
                continue
            seen.add(id(item))
            if isinstance(item, TriangleBatch):
                for i in range(len(item)):
                    tri_p1.append(item._p1[i])
                    tri_fn.append(item._fn[i])
                    tri_en.append(item._en[:, i])
                    tri_dc.append(item._d[i])
                    tri_mat.append(mat_id(item._materials[i]))
                    tri_objects.append((item, i))
            elif isinstance(item, Triangle):
                tri_p1.append(item._p1)
                tri_fn.append(item._fn)
                tri_en.append(item._en)
                tri_dc.append(item._d)
                tri_mat.append(mat_id(item._material))
                tri_objects.append((item, -1))
            elif isinstance(item, Solid):
                solids.append(item)
                sol_mat.append(mat_id(item._material))
                solid_objects.append((item, -1))
            else:
                raise TypeError(f"unsupported primitive {type(item)!r}")

    n_tris = len(tri_p1)
    t_pad = max(chunk, ((n_tris + chunk - 1) // chunk) * chunk)

    if not materials:
        from ..render import Material
        materials.append(Material((0, 0, 0)))

    p1a = np.asarray(tri_p1, dtype=f32).reshape(n_tris, d)
    fna = np.asarray(tri_fn, dtype=f32).reshape(n_tris, d)
    ena = np.asarray(tri_en, dtype=f32).reshape(n_tris, max(d - 1, 1), d)

    if n_tris:
        verts = triangle_vertices(p1a, fna, ena)
        tri_lo = verts.min(axis=1)
        tri_hi = verts.max(axis=1)
    else:
        tri_lo = np.zeros((0, d), dtype=f32)
        tri_hi = np.zeros((0, d), dtype=f32)

    # Culling boxes: the union of the k-d CELLS whose leaves hold the
    # primitive.  The reference traversal tests a leaf's primitives
    # whenever the ray pierces the leaf's cell and accepts hits at ANY
    # distance (kd_leaf::intersects clips only by the running nearest, not
    # the cell, tracer.hpp:858-913) — so a degenerate sliver's
    # ROUNDING_FUZZ-wide plane test can produce "phantom" hits far outside
    # its own AABB anywhere inside a containing cell (measured on the
    # 120-cell).  Culling by anything tighter (the triangle AABB, even the
    # batch prototype box) erases hits the oracle finds; the cell union is
    # the exact conservative region.
    cell_lo = {}
    cell_hi = {}

    def _cells(node, lo, hi):
        if node is None:
            return
        if isinstance(node, KDLeaf):
            for item in node:
                k = id(item)
                if k in cell_lo:
                    np.minimum(cell_lo[k], lo, out=cell_lo[k])
                    np.maximum(cell_hi[k], hi, out=cell_hi[k])
                else:
                    cell_lo[k] = lo.copy()
                    cell_hi[k] = hi.copy()
            return
        l_hi = hi.copy()
        l_hi[node.axis] = min(hi[node.axis], node.split)
        r_lo = lo.copy()
        r_lo[node.axis] = max(lo[node.axis], node.split)
        _cells(node.left, lo, l_hi)
        _cells(node.right, r_lo, hi)

    _cells(scene._root, np.asarray(scene._boundary._start, f32).copy(),
           np.asarray(scene._boundary._end, f32).copy())

    # A margin-based inflation of the triangle box is NOT sufficient:
    # degenerate simplices have null directions (the edge-normal system is
    # rank-deficient), so their plane test accepts an unbounded prism —
    # measured as whole missing surface patches on the 120-cell.  The cell
    # union is the exact conservative region and is what the reference's
    # own traversal reaches.
    cull_lo = tri_lo.copy()
    cull_hi = tri_hi.copy()
    for pid, (obj, lane) in enumerate(tri_objects):
        k = id(obj)
        if k in cell_lo:
            cull_lo[pid] = cell_lo[k]
            cull_hi[pid] = cell_hi[k]

    arrays = {
        "tri_p1": _pad_rows(p1a, t_pad),
        "tri_fn": _pad_rows(fna, t_pad),
        "tri_en": _pad_rows(ena, t_pad),
        "tri_dc": _pad_rows(np.asarray(tri_dc, dtype=f32).reshape(n_tris), t_pad),
        "tri_mat": _pad_rows(np.asarray(tri_mat, dtype=np.int32).reshape(n_tris),
                             t_pad),
        "tri_lo": _pad_rows(tri_lo, t_pad),
        "tri_hi": _pad_rows(tri_hi, t_pad),
        "cull_lo": _pad_rows(cull_lo, t_pad),
        "cull_hi": _pad_rows(cull_hi, t_pad),
        "bound_start": scene._boundary._start.astype(f32),
        "bound_end": scene._boundary._end.astype(f32),
    }

    n_solids = len(solids)
    s_pad = max(n_solids, 1)
    sol_type = np.zeros(s_pad, dtype=np.int32)
    sol_orient = np.tile(np.eye(d, dtype=f32), (s_pad, 1, 1))
    sol_inv = np.tile(np.eye(d, dtype=f32), (s_pad, 1, 1))
    sol_pos = np.zeros((s_pad, d), dtype=f32)
    sol_mat_a = np.zeros(s_pad, dtype=np.int32)
    for i, s in enumerate(solids):
        sol_type[i] = s._type
        sol_orient[i] = s._orientation
        sol_inv[i] = s._inv_orientation
        sol_pos[i] = s._position
        sol_mat_a[i] = sol_mat[i]
    arrays.update(sol_type=sol_type, sol_orient=sol_orient, sol_inv=sol_inv,
                  sol_pos=sol_pos, sol_mat=sol_mat_a)

    arrays.update(
        mat_color=np.asarray([list(m.color) for m in materials], dtype=f32),
        mat_specular=np.asarray([list(m.specular) for m in materials], dtype=f32),
        mat_opacity=np.asarray([m.opacity for m in materials], dtype=f32),
        mat_refl=np.asarray([m.reflectivity for m in materials], dtype=f32),
        mat_spec_int=np.asarray([m.specular_intensity for m in materials], dtype=f32),
        mat_spec_exp=np.asarray([m.specular_exp for m in materials], dtype=f32),
    )

    # lights (padded to >= 1 with zero-color lights: zero contribution)
    L = len(scene.point_lights)
    pl_pos = np.zeros((max(L, 1), d), dtype=f32)
    pl_pos[:, 0] = 1  # avoid 0-distance degeneracies in padding entries
    pl_color = np.zeros((max(L, 1), 3), dtype=f32)
    for i, pl in enumerate(scene.point_lights):
        pl_pos[i] = pl._position
        pl_color[i] = list(pl.color)
    G = len(scene.global_lights)
    gl_dir = np.zeros((max(G, 1), d), dtype=f32)
    gl_color = np.zeros((max(G, 1), 3), dtype=f32)
    for i, gl in enumerate(scene.global_lights):
        gl_dir[i] = gl._direction
        gl_color[i] = list(gl.color)
    arrays.update(pl_pos=pl_pos, pl_color=pl_color, gl_dir=gl_dir,
                  gl_color=gl_color)

    has_transparency = any(m.opacity < 1 for m in materials)
    has_reflectivity = any(m.reflectivity != 0 for m in materials)

    config = SceneConfig(
        d=d,
        n_tris=t_pad,
        n_solids=n_solids,
        n_point_lights=L,
        n_global_lights=G,
        shadows=bool(scene.shadows),
        camera_light=bool(scene.camera_light),
        max_reflect_depth=int(scene.max_reflect_depth),
        bg_axis=int(scene.bg_gradient_axis),
        has_transparency=has_transparency,
        has_reflectivity=has_reflectivity,
        max_transparent_hits=max_transparent_hits,
    )
    return FlatScene(config=config, arrays=arrays,
                     prim_objects=tri_objects + solid_objects)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to length n with zeros."""
    if a.shape[0] == n:
        return a
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def kd_treelets(scene, flat: FlatScene, ck: int):
    """Cut the k-d tree into treelets of <= ``ck`` triangle slots, each with
    its DISJOINT cell box (the node's region of space, as carved by ancestor
    splits from the scene boundary).

    This is the device analogue of the reference's kd_node_intersection
    traversal (tracer.hpp:1179-1243): treelet cells partition space, so a
    ray only needs the treelets its line pierces, and front-to-back visit
    order allows per-ray early termination — unlike content-AABB chunks,
    which overlap heavily and prune almost nothing.  A primitive spanning
    several cells appears in each (exactly like k-d leaves, which share
    primitives across leaves — the kernel's skip/ids use dedup'd pool ids
    so duplicates behave as one primitive).

    Returns a list of (cell_lo (d,), cell_hi (d,), [pool ids]) with each
    id list <= ck.
    """
    d = scene.dimension
    # object identity -> dedup'd pool triangle ids (batches span BATCH ids)
    by_obj = {}
    for pid, (obj, _lane) in enumerate(flat.prim_objects):
        if isinstance(obj, (Triangle, TriangleBatch)):
            by_obj.setdefault(id(obj), []).append(pid)

    def leaf_ids(leaf):
        ids = []
        seen = set()
        for item in leaf:
            if isinstance(item, (Triangle, TriangleBatch)) \
                    and id(item) not in seen:
                seen.add(id(item))
                ids.extend(by_obj.get(id(item), ()))
        return ids

    def subtree_ids(node):
        if node is None:
            return []
        if isinstance(node, KDLeaf):
            return leaf_ids(node)
        seen = set()
        out = []
        for part in (subtree_ids(node.left), subtree_ids(node.right)):
            for pid in part:
                if pid not in seen:
                    seen.add(pid)
                    out.append(pid)
        return out

    treelets = []

    def walk(node, lo, hi):
        if node is None:
            return
        ids = subtree_ids(node)
        if not ids:
            return
        if len(ids) <= ck or isinstance(node, KDLeaf):
            for s in range(0, len(ids), ck):
                treelets.append((lo.copy(), hi.copy(), ids[s:s + ck]))
            return
        axis, split = node.axis, np.float32(node.split)
        l_hi = hi.copy()
        l_hi[axis] = min(hi[axis], split)
        r_lo = lo.copy()
        r_lo[axis] = max(lo[axis], split)
        walk(node.left, lo, l_hi)
        walk(node.right, r_lo, hi)

    lo = np.asarray(scene._boundary._start, np.float32).copy()
    hi = np.asarray(scene._boundary._end, np.float32).copy()
    walk(scene._root, lo, hi)
    del d
    return treelets
