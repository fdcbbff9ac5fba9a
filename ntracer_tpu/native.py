"""ctypes bridge to the native (C++) SAH k-d builder.

The reference builds its tree in multithreaded C++ (tracer.hpp:2131-2455);
our equivalent native component is ntracer_tpu/csrc/kd_builder.cpp, compiled on first
use (g++ is part of the image).  ntracer_tpu/kdtree.py calls
``build_tree_native`` and falls back to the NumPy builder when the library
is unavailable or ``NTRACER_NO_NATIVE`` is set.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

f32 = np.float32

_lock = threading.Lock()
_lib = None
_lib_tried = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "csrc", "kd_builder.cpp")


def _so_path():
    """The compiled library lives in ``build/`` at the root of the
    checkout (git-ignored)."""
    cache = os.path.join(os.path.dirname(os.path.dirname(_SRC)), "..",
                         "build")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(os.path.abspath(cache), "_ntr_native.so")


def get_lib():
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if os.environ.get("NTRACER_NO_NATIVE"):
            return None
        so = _so_path()
        try:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(_SRC)):
                # per-process temp name: concurrent first-use from several
                # processes must not interleave writes before the atomic
                # os.replace
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                     "-pthread", _SRC, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
        except Exception:
            return None

        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ntr_build.restype = ctypes.c_void_p
        lib.ntr_build.argtypes = [
            ctypes.c_int, ctypes.c_int, f32p, f32p, i32p, i32p, i32p,
            f32p, f32p, f32p, f32p, f32p, f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, i32p]
        lib.ntr_num_nodes.restype = ctypes.c_int32
        lib.ntr_num_nodes.argtypes = [ctypes.c_void_p]
        lib.ntr_num_items.restype = ctypes.c_int32
        lib.ntr_num_items.argtypes = [ctypes.c_void_p]
        lib.ntr_get_nodes.restype = None
        lib.ntr_get_nodes.argtypes = [ctypes.c_void_p, i32p, f32p, i32p,
                                      i32p, i32p, i32p, i32p]
        lib.ntr_free.restype = None
        lib.ntr_free.argtypes = [ctypes.c_void_p]
        try:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.ntr_group_select.restype = ctypes.c_int32
            lib.ntr_group_select.argtypes = [
                ctypes.c_int, ctypes.c_int, f32p, f32p, u8p,
                ctypes.c_int, ctypes.c_int, i32p]
            lib._has_group_select = True
        except AttributeError:   # pre-round-4 cached .so
            lib._has_group_select = False
        _lib = lib
        return _lib


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def group_select(starts, ends, is_tri, window, batch):
    """Native greedy grouping selection (ntr_group_select): returns an
    (G, batch) int32 array of prototype indices (pivot first) replicating
    kdtree.group_primitives' selection loop bit-for-bit, or None when the
    native library is unavailable (the caller keeps the Python loop)."""
    import ctypes as _ct
    lib = get_lib()
    if lib is None or not getattr(lib, "_has_group_select", False):
        return None
    n, d = starts.shape
    if d > 16 or n == 0:
        return None
    s = np.ascontiguousarray(starts, f32)
    e = np.ascontiguousarray(ends, f32)
    t = np.ascontiguousarray(is_tri, np.uint8)
    out = np.empty(n, np.int32)
    g = lib.ntr_group_select(
        n, d, _fp(s), _fp(e),
        t.ctypes.data_as(_ct.POINTER(_ct.c_uint8)), window, batch,
        _ip(out))
    if g < 0:
        return None
    return out[:g * batch].reshape(g, batch)


def build_tree_native(prototypes, params, make_leaf, make_branch,
                      extra_threads=-1):
    """Run the C++ SAH build over (already batch-grouped) prototypes.

    Returns the root node built via ``make_leaf``/``make_branch``, or None
    when the native library is unavailable."""
    from .primitives import (TrianglePrototype, TriangleBatchPrototype,
                             SolidPrototype)

    lib = get_lib()
    if lib is None:
        return None

    asm = getattr(prototypes, "_assembly", None)
    if asm is not None:
        # group_primitives' lazy path precomputed every input array
        # (all-triangle by construction — no solids, no SOLID_AABB_EXACT
        # concern); skip the per-object assembly loop entirely
        src = asm["src"]
        n = len(prototypes)
        d = src["pts"].shape[2]
        b_start = np.ascontiguousarray(asm["b_start"], f32)
        b_end = np.ascontiguousarray(asm["b_end"], f32)
        kind = np.zeros(n, np.int32)
        tri_count = np.ascontiguousarray(asm["tri_count"], np.int32)
        tri_offset = np.zeros(n, np.int32)
        np.cumsum(tri_count[:-1], out=tri_offset[1:])
        rows = asm["lane_rows"]
        pts = np.ascontiguousarray(src["pts"][rows], f32)
        axes = np.empty((len(rows), d, d), f32)
        axes[:, 0] = src["fen"][rows]
        axes[:, 1:] = src["en"][rows]
        fnormal = np.ascontiguousarray(src["fn"][rows], f32)
        sol_orient = np.zeros((n, d, d), f32)
        sol_inv = np.zeros((n, d, d), f32)
        sol_pos = np.zeros((n, d), f32)
        return _ntr_build_call(lib, prototypes, n, d, b_start, b_end, kind,
                               tri_offset, tri_count, pts, axes, fnormal,
                               sol_orient, sol_inv, sol_pos, params,
                               make_leaf, make_branch, extra_threads)

    from . import kdtree as _kdtree
    if _kdtree.SOLID_AABB_EXACT and any(
            isinstance(p, SolidPrototype) for p in prototypes):
        # exact solid-membership mode (a diagnostic/test mode — see
        # kdtree.SOLID_AABB_EXACT): the C++ builder only implements the
        # reference-faithful defect formula, so use the Python builder
        return None

    n = len(prototypes)
    d = prototypes[0].dimension

    b_start = np.empty((n, d), f32)
    b_end = np.empty((n, d), f32)
    kind = np.zeros(n, np.int32)
    tri_offset = np.zeros(n, np.int32)
    tri_count = np.zeros(n, np.int32)
    sol_orient = np.zeros((n, d, d), f32)
    sol_inv = np.zeros((n, d, d), f32)
    sol_pos = np.zeros((n, d), f32)

    # one classification pass, then VECTORIZED per-type assembly: the
    # per-lane append loop this replaces was most of the Python residue
    # of a 300k-triangle build
    tri_us, batch_us = [], []
    members = 0
    for u, p in enumerate(prototypes):
        b_start[u] = p.boundary._start
        b_end[u] = p.boundary._end
        if isinstance(p, TrianglePrototype):
            kind[u] = 0
            tri_offset[u] = members
            tri_count[u] = 1
            members += 1
            tri_us.append(u)
        elif isinstance(p, TriangleBatchPrototype):
            B = len(p.primitive)
            kind[u] = 0
            tri_offset[u] = members
            tri_count[u] = B
            members += B
            batch_us.append(u)
        elif isinstance(p, SolidPrototype):
            s = p.primitive
            kind[u] = s._type  # CUBE=1, SPHERE=2
            sol_orient[u] = s._orientation
            sol_inv[u] = s._inv_orientation
            sol_pos[u] = s._position
        else:
            return None  # unknown prototype: fall back to Python

    if members:
        pts = np.empty((members, d, d), f32)
        axes = np.empty((members, d, d), f32)
        fnormal = np.empty((members, d), f32)
        if tri_us:
            rows = np.asarray([tri_offset[u] for u in tri_us])
            pts[rows] = np.stack(
                [prototypes[u]._points for u in tri_us])
            axes[rows, 0] = np.stack(
                [prototypes[u]._first_edge_normal for u in tri_us])
            axes[rows, 1:] = np.stack(
                [prototypes[u].primitive._en for u in tri_us])
            fnormal[rows] = np.stack(
                [prototypes[u].primitive._fn for u in tri_us])
        if batch_us:
            B = len(prototypes[batch_us[0]].primitive)
            if any(len(prototypes[u].primitive) != B for u in batch_us):
                return None  # ragged batches: fall back to Python
            base = np.asarray([tri_offset[u] for u in batch_us])
            rows = (base[:, None] + np.arange(B)).reshape(-1)
            # (G, d, B, d) points -> per-lane (G*B, d, d)
            pts[rows] = np.stack(
                [prototypes[u]._points for u in batch_us]) \
                .transpose(0, 2, 1, 3).reshape(-1, d, d)
            axes_g = np.empty((len(batch_us), B, d, d), f32)
            axes_g[:, :, 0] = np.stack(
                [prototypes[u]._first_edge_normal for u in batch_us])
            axes_g[:, :, 1:] = np.stack(
                [prototypes[u].primitive._en for u in batch_us]) \
                .transpose(0, 2, 1, 3)
            axes[rows] = axes_g.reshape(-1, d, d)
            fnormal[rows] = np.stack(
                [prototypes[u].primitive._fn for u in batch_us]) \
                .reshape(-1, d)
        pts = np.ascontiguousarray(pts, dtype=f32)
        axes = np.ascontiguousarray(axes, dtype=f32)
        fnormal = np.ascontiguousarray(fnormal, dtype=f32)
    else:
        pts = np.zeros((1, d, d), f32)
        axes = np.zeros((1, d, d), f32)
        fnormal = np.zeros((1, d), f32)

    b_start = np.ascontiguousarray(b_start)
    b_end = np.ascontiguousarray(b_end)

    return _ntr_build_call(lib, prototypes, n, d, b_start, b_end, kind,
                           tri_offset, tri_count, pts, axes, fnormal,
                           sol_orient, sol_inv, sol_pos, params,
                           make_leaf, make_branch, extra_threads)


def _ntr_build_call(lib, prototypes, n, d, b_start, b_end, kind, tri_offset,
                    tri_count, pts, axes, fnormal, sol_orient, sol_inv,
                    sol_pos, params, make_leaf, make_branch, extra_threads):
    """Shared tail of build_tree_native: the ntr_build ctypes call and the
    make_leaf/make_branch node construction over its output."""
    root_out = np.zeros(1, np.int32)
    h = lib.ntr_build(
        n, d, _fp(b_start), _fp(b_end), _ip(kind), _ip(tri_offset),
        _ip(tri_count), _fp(pts), _fp(axes), _fp(fnormal), _fp(sol_orient),
        _fp(sol_inv), _fp(sol_pos), int(params.max_depth),
        int(params.split_threshold), float(params.traversal),
        float(params.intersection), int(extra_threads), _ip(root_out))
    if not h:
        return None
    try:
        n_nodes = lib.ntr_num_nodes(h)
        n_items = lib.ntr_num_items(h)
        axis = np.empty(n_nodes, np.int32)
        split = np.empty(n_nodes, f32)
        left = np.empty(n_nodes, np.int32)
        right = np.empty(n_nodes, np.int32)
        leaf_start = np.empty(n_nodes, np.int32)
        leaf_count = np.empty(n_nodes, np.int32)
        items = np.empty(max(n_items, 1), np.int32)
        lib.ntr_get_nodes(h, _ip(axis), _fp(split), _ip(left), _ip(right),
                          _ip(leaf_start), _ip(leaf_count), _ip(items))
    finally:
        lib.ntr_free(h)

    root = int(root_out[0])
    if root < 0:
        return None

    def build(i):
        if i < 0:
            return None
        if axis[i] < 0:
            sl = items[leaf_start[i]:leaf_start[i] + leaf_count[i]]
            return make_leaf([prototypes[u] for u in sl])
        return make_branch(int(axis[i]), float(split[i]),
                           build(int(left[i])), build(int(right[i])))

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        return build(root)
    finally:
        sys.setrecursionlimit(old)
