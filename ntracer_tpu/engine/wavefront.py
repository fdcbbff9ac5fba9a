"""JAX wavefront renderer: whole tiles of rays advance in lockstep.

This inverts the reference's one-recursive-ray-at-a-time design
(tracer.hpp:1856-1890): a tile of R rays is generated at once
(flat_origin_ray_source, tracer.hpp:60-76), traced against the SoA triangle
pool, and shaded vectorized (base_color, tracer.hpp:1768-1854).  The trace
takes one of two implementations, chosen per scene by
``walk.trace_impl``:

  * the walk kernel (``walk.py``, GPU): each block of rays walks spatial
    chunks of the pool front to back with per-block early exit — the
    analogue of the reference's near/far-ordered k-d traversal;
  * the XLA chunk scan (``trace_pool`` / ``occlusion`` below): a
    ``lax.scan`` over CHUNK-sized slabs in k-d leaf order, each with its
    own AABB, skipping a chunk with ``lax.cond`` when no ray of the tile
    can hit it.  It serves every backend, transparent pools (a fixed-K
    nearest-hits buffer) and pools the walk does not take.

Reflection recursion becomes a static bounce loop with per-ray color
weights; transparency keeps ``max_transparent_hits`` slots (the
reference's unbounded ``quick_list``).

All math is float32, matching the reference's ``real``; every matrix
product asks for ``Precision.HIGHEST`` (no TF32).

Known deviations from the scalar oracle (documented, all edge cases):
  * at most ``max_transparent_hits`` transparent surfaces per ray;
  * reflections spawn from the nearest opaque hit only — a material that is
    both transparent and reflective does not spawn reflection children for
    its transparent layers;
  * occlusion (shadow) queries use true any-hit semantics; the reference's
    kd walk has an early-out (tracer.hpp:1298) that can skip far-side
    occluders.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from . import chunks, walk
from .flatten import flatten_composite, SceneConfig

f32 = jnp.float32
CHUNK = 512
TILE = 32768  # rays per device dispatch

ROUNDING_FUZZ = np.float32(np.finfo(np.float32).eps * 10)
REAL_MAX = np.float32(np.finfo(np.float32).max)
LIGHT_THRESHOLD = np.float32(1.0 / 512.0)
INF = np.float32(np.inf)


def _unit(v):
    return v / jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))


def _powf(x, y):
    """C ``powf`` semantics for negative bases: integral exponents give a
    signed result (the reference's Blinn-Phong pow sees negative half-vector
    dots, tracer.hpp:1703); non-integral exponents give NaN, matching libm."""
    ax = jnp.abs(x)
    p = jnp.power(ax, y)
    y_int = jnp.floor(y) == y
    odd = jnp.mod(y, 2.0) != 0
    neg = x < 0
    sign = jnp.where(neg & y_int & odd, -1.0, 1.0)
    return jnp.where(neg & ~y_int, jnp.nan, sign * p)


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def _mm(a, b):
    """float32 matrix product at full precision (no TF32)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


# ---------------------------------------------------------------------------
# Ray generation
# ---------------------------------------------------------------------------

def make_rays(cam_origin, cam_t, fovI, half_w, half_h, xs, ys):
    """flat_origin_ray_source: dir = unit(fwd + right*fovI*(x-hw) - up*fovI*(y-hh))."""
    right, up, fwd = cam_t[0], cam_t[1], cam_t[2]
    dirs = (fwd[None, :]
            + right[None, :] * (fovI * (xs - half_w))[:, None]
            - up[None, :] * (fovI * (ys - half_h))[:, None])
    dirs = _unit(dirs)
    origins = jnp.broadcast_to(cam_origin, dirs.shape)
    return origins, dirs


# ---------------------------------------------------------------------------
# Triangle pool trace
# ---------------------------------------------------------------------------

def _chunk_planes(p1, fn, en):
    """Stack face+edge plane normals: (C,d),(C,d),(C,d-1,d) -> (C,d,d)
    where planes[:,0]=face normal, planes[:,1:]=edge normals."""
    return jnp.concatenate([fn[:, None, :], en], axis=1)


def _tri_chunk_test(o, dirs, p1, fn, en, dc, d):
    """Intersect R rays with a C-triangle chunk (tracer.hpp:411-440 /
    551-599 vectorized).  Returns (t, valid, denom): (R,C) each.

    The 2d plane dot products per ray-triangle pair come from two matmuls
    with contraction d: (R,d) @ (d, d*C).  The plane matrix is laid out
    plane-major so every downstream tensor is an (R, C) slice with the
    long C axis minor."""
    C = p1.shape[0]
    planes = _chunk_planes(p1, fn, en)            # (C, d, d)
    g = planes.transpose(1, 0, 2).reshape(d * C, d)   # plane-major rows
    # Precision.HIGHEST is required: a default-precision f32 matmul may
    # run in TF32 (~1e-3 relative error), which flips the
    # ROUNDING_FUZZ-tight edge tests on coplanar geometry.
    O = jax.lax.dot_general(o, g, (((1,), (1,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)   # (R, d*C)
    D = jax.lax.dot_general(dirs, g, (((1,), (1,)), ((), ())),
                            precision=jax.lax.Precision.HIGHEST,
                            preferred_element_type=jnp.float32)   # (R, d*C)

    denom = D[:, 0:C]                             # fn . dir
    t = -(O[:, 0:C] + dc[None, :]) / denom
    valid = (denom != 0) & (t > 0)

    # edge areas: a_i = e_i.p1 - e_i.o - t * e_i.dir, one (R, C) slab per edge
    ci = jnp.sum(planes[:, 1:, :] * p1[:, None, :], axis=-1)      # (C, d-1)
    tot = jnp.zeros_like(t)
    for i in range(1, d):
        a = ci[None, :, i - 1] - O[:, i * C:(i + 1) * C] \
            - t * D[:, i * C:(i + 1) * C]
        valid &= (a >= -ROUNDING_FUZZ) & (a <= 1 + ROUNDING_FUZZ)
        tot += a
    valid &= tot <= 1 + ROUNDING_FUZZ
    return t, valid, denom


def _chunk_arrays(arrs, cfg):
    """Reshape the triangle pool into (n_chunks, CHUNK, ...) plus per-chunk
    AABBs for culling."""
    d = cfg.d
    n = cfg.n_tris
    nc = n // CHUNK
    return dict(
        p1=arrs["tri_p1"].reshape(nc, CHUNK, d),
        fn=arrs["tri_fn"].reshape(nc, CHUNK, d),
        en=arrs["tri_en"].reshape(nc, CHUNK, max(d - 1, 1), d),
        dc=arrs["tri_dc"].reshape(nc, CHUNK),
        opacity=arrs["tri_opacity"].reshape(nc, CHUNK),
        lo=arrs["ck_lo"],
        hi=arrs["ck_hi"],
        nonempty=arrs["ck_nonempty"],
    )


def _slab_entry(o, dirs, lo, hi):
    """Conservative ray/AABB entry distance: (R,).  inf when missed.
    NaN-safe for zero direction components (0 * inf on parallel axes)."""
    big = np.float32(3e37)
    inv = jnp.where(dirs != 0, 1.0 / jnp.where(dirs != 0, dirs, 1.0), 0.0)
    a = (lo[None, :] - o) * inv
    b = (hi[None, :] - o) * inv
    par = dirs == 0
    inside = (o >= lo[None, :]) & (o <= hi[None, :])
    t0 = jnp.where(par, jnp.where(inside, -big, big), jnp.minimum(a, b))
    t1 = jnp.where(par, jnp.where(inside, big, -big), jnp.maximum(a, b))
    tn = jnp.max(t0, axis=-1)
    tf = jnp.min(t1, axis=-1)
    entry = jnp.maximum(tn, 0.0)
    hit = (tf >= entry) & (tf >= 0)
    return jnp.where(hit, entry, INF)


def _walk_ok(arrs):
    """The walk kernel traces the pool when its chunk layouts were built
    (``get_device_scene`` builds them where ``walk.trace_impl`` chose the
    walk: opaque pools on the GPU)."""
    return "walk_gt" in arrs


def _walk_dict(arrs):
    return {k[len("walk_"):]: v for k, v in arrs.items()
            if k.startswith("walk_")}


def _stat(stats, key, val):
    if stats is not None:
        stats[key] = stats.get(key, 0) + val


def primary_ctx(arrs, cfg, origin):
    """Per-frame context for shared-origin (primary) traces on the walk:
    front-to-back chunk order + per-position distance bounds
    (chunks.chunk_order) and the hoisted origin-dot rows
    (chunks.shared_rows).  Computed once per frame instead of once per
    ray group: chunk_order is an argsort and shared_rows touches the
    whole pool."""
    if not _walk_ok(arrs):
        return {}
    lay = _walk_dict(arrs)
    order, dmin = chunks.chunk_order(lay["klo"], lay["khi"], origin)
    return dict(order=order, dmin=dmin,
                sh=chunks.shared_rows(lay["gt"], lay["ci"], origin, cfg.d))


def trace_pool(arrs, cfg: SceneConfig, o, dirs, skip, shared_origin=None,
               active=None, stats=None, pctx=None):
    """Nearest-opaque + top-K transparent trace over the triangle pool and
    solids.  Returns a dict of per-ray results.

    ``shared_origin`` (d,) enables exact front-to-back chunk ordering +
    early traversal exit on the walk (valid when every ray starts there —
    primary rays).  ``active`` masks rays out of the trace entirely
    (bounce rays whose weight died); the walk skips blocks whose rays are
    all inactive.  ``stats`` (optional dict) accumulates instrumentation
    counters.  ``pctx`` (from primary_ctx) carries the frame-level
    shared-origin precomputes so per-group calls don't recompute them.

    Walk-path pools return the hit geometry lane-major (pointT/normalT,
    (d, R)) for the transposed pipeline; scan-path pools return it in
    rows (point/normal, (R, d)) for the row pipeline."""
    R = o.shape[0]
    d = cfg.d
    K = cfg.max_transparent_hits if cfg.has_transparency else 0
    n_live = R if active is None else jnp.sum(active.astype(jnp.int32))

    if _walk_ok(arrs):
        # the walk returns the winning SLOT; one gather of the
        # slot-indexed packed rows [fn(d), mat, local id] recovers the
        # id and the hit geometry together, lane-major
        if shared_origin is not None and pctx is None:
            pctx = primary_ctx(arrs, cfg, shared_origin)
        kw = {}
        if shared_origin is not None:
            kw = dict(order=pctx["order"], dmin=pctx["dmin"], sh=pctx["sh"])
        lay = _walk_dict(arrs)
        kt, slot, vis = walk.nearest_hit(lay, o, dirs, skip - arrs["tri_base"],
                                         d, active=active, **kw)
        _stat(stats, "rays_traced", n_live)
        _stat(stats, "chunks_visited", jnp.sum(vis))
        hit = slot >= 0
        t = jnp.where(hit, kt, REAL_MAX)
        rowT = lay["slot_pack"].T[:, jnp.where(hit, slot, 0)]
        pid = jnp.where(hit, rowT[d + 1].astype(jnp.int32) + arrs["tri_base"],
                        -1)
        dirsT = dirs.T
        pointT = o.T + t[None, :] * dirsT
        fnT = rowT[:d]
        denom = _dotT(fnT, dirsT)
        normalT = _unitT(fnT) * jnp.where(denom > 0, -1.0, 1.0)[None, :]
        res = dict(t=t, pid=pid, pointT=pointT, normalT=normalT,
                   mat=rowT[d].astype(jnp.int32))
        return _trace_finish_T(arrs, cfg, o, dirs, skip, res)

    ck = _chunk_arrays(arrs, cfg)
    nc = ck["p1"].shape[0]

    # primitive ids are GLOBAL: tri_base/sol_base offset this shard's pool
    # (both zero/n_tris on a single chip; see parallel.mesh for sharding)
    tri_base = arrs["tri_base"]
    ids_base = jnp.arange(CHUNK, dtype=jnp.int32)

    init = dict(
        t=jnp.full((R,), REAL_MAX, dtype=f32),
        pid=jnp.full((R,), -1, dtype=jnp.int32),
        nvis=jnp.int32(0),
    )
    if active is not None:
        init["t"] = jnp.where(active, init["t"], 0.0)
    if K:
        init["tt"] = jnp.full((R, K), INF, dtype=f32)
        init["tid"] = jnp.full((R, K), -1, dtype=jnp.int32)

    def chunk_step(carry, inputs):
        (p1, fn, en, dc, opacity, lo, hi, nonempty, cidx) = inputs

        entry = _slab_entry(o, dirs, lo, hi)
        pred = nonempty & jnp.any(entry < carry["t"])

        def run(carry):
            t, valid, _ = _tri_chunk_test(o, dirs, p1, fn, en, dc, d)
            ids = tri_base + cidx * CHUNK + ids_base
            valid &= ids[None, :] != skip[:, None]
            out = dict(carry)

            op_valid = valid & (opacity[None, :] >= 1)
            tm = jnp.where(op_valid, t, INF)
            ct = jnp.min(tm, axis=1)
            carg = jnp.argmin(tm, axis=1)
            upd = ct < carry["t"]
            out["t"] = jnp.where(upd, ct, carry["t"])
            out["pid"] = jnp.where(upd, ids[carg], carry["pid"])

            if K:
                tr_valid = valid & (opacity[None, :] < 1)
                tm2 = jnp.where(tr_valid, t, INF)
                # take the chunk's K nearest, then merge with the carry
                ctt, cargs = jax.lax.top_k(-tm2, K)
                ctt = -ctt
                cids = ids[cargs]
                allt = jnp.concatenate([carry["tt"], ctt], axis=1)
                alli = jnp.concatenate([carry["tid"], cids], axis=1)
                order = jnp.argsort(allt, axis=1)[:, :K]
                out["tt"] = jnp.take_along_axis(allt, order, axis=1)
                out["tid"] = jnp.take_along_axis(alli, order, axis=1)
            return out

        carry = jax.lax.cond(pred, run, lambda c: c, carry)
        carry["nvis"] = carry["nvis"] + pred.astype(jnp.int32)
        return carry, None

    xs = (ck["p1"], ck["fn"], ck["en"], ck["dc"], ck["opacity"],
          ck["lo"], ck["hi"], ck["nonempty"],
          jnp.arange(nc, dtype=jnp.int32))
    carry, _ = jax.lax.scan(lambda c, x: chunk_step(c, x), init, xs)
    _stat(stats, "chunks_visited", carry.pop("nvis"))
    _stat(stats, "rays_traced", n_live)
    return _trace_finish(arrs, cfg, o, dirs, skip, carry, K, R)


def _trace_finish(arrs, cfg, o, dirs, skip, carry, K, R):
    """Solids, cross-shard reduction and hit geometry for trace_pool."""
    d = cfg.d
    # --- solids (static loop; S is tiny) ---------------------------------
    for s in range(cfg.n_solids):
        st, sp, sn = _solid_test(arrs, s, o, dirs, d)
        sid = arrs["sol_base"] + s
        s_opaque = arrs["mat_opacity"][arrs["sol_mat"][s]] >= 1
        svalid = (st > 0) & (sid != skip)
        so_valid = svalid & s_opaque & (st < carry["t"])
        carry["t"] = jnp.where(so_valid, st, carry["t"])
        carry["pid"] = jnp.where(so_valid, sid, carry["pid"])
        if K:
            str_valid = svalid & ~s_opaque
            if cfg.prim_axis is not None:
                # solids are replicated across pool shards; insert once so
                # the cross-shard K-merge doesn't duplicate them
                str_valid &= jax.lax.axis_index(cfg.prim_axis) == 0
            tins = jnp.where(str_valid, st, INF)
            allt = jnp.concatenate([carry["tt"], tins[:, None]], axis=1)
            alli = jnp.concatenate(
                [carry["tid"], jnp.full((R, 1), sid, jnp.int32)], axis=1)
            order = jnp.argsort(allt, axis=1)[:, :K]
            carry["tt"] = jnp.take_along_axis(allt, order, axis=1)
            carry["tid"] = jnp.take_along_axis(alli, order, axis=1)

    point, normal, mat = _hit_geometry(arrs, cfg, o, dirs, carry["t"],
                                       carry["pid"])
    res = dict(t=carry["t"], pid=carry["pid"], point=point, normal=normal,
               mat=mat)

    if K:
        # per-slot payload (view-facing normal + material), gathered from
        # this shard's pool while the ids are still local
        tid = carry["tid"]
        local = jnp.clip(tid - arrs["tri_base"], 0, cfg.n_tris - 1)
        fnk = arrs["tri_fn"][local]                       # (R, K, d)
        denomk = jnp.sum(fnk * dirs[:, None, :], axis=-1)
        tnorm = _unit(fnk) * jnp.where(denomk > 0, -1.0, 1.0)[:, :, None]
        tmat = arrs["tri_mat"][local]
        for s in range(cfg.n_solids):
            st, sp, sn = _solid_test(arrs, s, o, dirs, d)
            sel = tid == (arrs["sol_base"] + s)
            tnorm = jnp.where(sel[:, :, None], sn[:, None, :], tnorm)
            tmat = jnp.where(sel, arrs["sol_mat"][s], tmat)
        res["tt"] = carry["tt"]
        res["tid"] = tid
        res["tnorm"] = tnorm
        res["tmat"] = tmat

    if cfg.prim_axis is not None:
        # tensor-parallel pool: every shard found its local winner with full
        # geometry; all_gather the candidates over ICI and take the global
        # argmin per ray (winner-take-all reduction).
        winner_keys = ("t", "pid", "point", "normal", "mat")
        g = {k: jax.lax.all_gather(res[k], cfg.prim_axis)
             for k in winner_keys}
        w = jnp.argmin(g["t"], axis=0)                       # (R,)
        for k in winner_keys:
            v = g[k]
            idx = w[None, ..., None] if v.ndim == 3 else w[None, ...]
            res[k] = jnp.take_along_axis(v, idx, axis=0)[0]

        if K:
            # merge the K-buffers (with payload) across shards: sort the
            # concatenated candidates by distance, keep the nearest K
            def merge(key, fill_ndim):
                v = jax.lax.all_gather(res[key], cfg.prim_axis)  # (P, R, K...)
                perm = (1, 0, 2) if v.ndim == 3 else (1, 0, 2, 3)
                v = v.transpose(perm)
                return v.reshape((R, -1) + v.shape[3:])          # (R, P*K...)

            allt = merge("tt", 2)
            order = jnp.argsort(allt, axis=1)[:, :K]
            res["tt"] = jnp.take_along_axis(allt, order, axis=1)
            res["tid"] = jnp.take_along_axis(merge("tid", 2), order, axis=1)
            res["tmat"] = jnp.take_along_axis(merge("tmat", 2), order, axis=1)
            res["tnorm"] = jnp.take_along_axis(
                merge("tnorm", 3), order[:, :, None], axis=1)

    res["hit"] = res["pid"] >= 0
    if K:
        tvalid = (res["tid"] >= 0) & (res["tt"] < res["t"][:, None])
        res["tid"] = jnp.where(tvalid, res["tid"], -1)
    return res


def _trace_finish_T(arrs, cfg, o, dirs, skip, res):
    """Solids and the cross-shard winner merge for the transposed trace
    path: the (k, R) twin of _trace_finish for opaque pools — the same f32
    operations in the same order, so values are unchanged (solid tests run
    in row layout and only their results are transposed; transposing is
    bit-exact, re-deriving the matmuls in (d, R) would not be).

    ``res`` carries t/pid/mat (R,) and pointT/normalT (d, R)."""
    d = cfg.d
    for s in range(cfg.n_solids):
        st, sp, sn = _solid_test(arrs, s, o, dirs, d)
        sid = arrs["sol_base"] + s
        s_opaque = arrs["mat_opacity"][arrs["sol_mat"][s]] >= 1
        svalid = (st > 0) & (sid != skip)
        so_valid = svalid & s_opaque & (st < res["t"])
        res["t"] = jnp.where(so_valid, st, res["t"])
        res["pid"] = jnp.where(so_valid, sid, res["pid"])
        res["pointT"] = jnp.where(so_valid[None, :], sp.T, res["pointT"])
        res["normalT"] = jnp.where(so_valid[None, :], sn.T, res["normalT"])
        res["mat"] = jnp.where(so_valid, arrs["sol_mat"][s], res["mat"])

    if cfg.prim_axis is not None:
        # tensor-parallel pool, lane-major twin of _trace_finish's merge:
        # all_gather keeps R on the minor axis ((P, R) / (P, k, R)), the
        # global winner is an argmin over the leading shard axis.
        g = {k: jax.lax.all_gather(res[k], cfg.prim_axis)
             for k in ("t", "pid", "mat", "pointT", "normalT")}
        w = jnp.argmin(g["t"], axis=0)                       # (R,)
        for k, v in g.items():
            idx = w[None, None, :] if v.ndim == 3 else w[None, :]
            res[k] = jnp.take_along_axis(v, idx, axis=0)[0]

    res["hit"] = res["pid"] >= 0
    return res


def _hit_geometry(arrs, cfg, o, dirs, t, pid):
    """Recover hit point, view-facing normal, and material index from a
    primitive id (gathers use this shard's local pool indices)."""
    d = cfg.d
    point = o + t[:, None] * dirs
    tri_id = jnp.clip(pid - arrs["tri_base"], 0, cfg.n_tris - 1)
    # one (R, d+1) gather for normal + material id (material ids are
    # exact in f32)
    row = arrs["tri_pack"][tri_id]
    fn = row[:, :d]
    mat = row[:, d].astype(jnp.int32)
    denom = _dot(fn, dirs)
    n_tri = _unit(fn) * jnp.where(denom > 0, -1.0, 1.0)[:, None]

    if cfg.n_solids:
        # solids write their own normal/point; recompute per solid and select
        normal = n_tri
        for s in range(cfg.n_solids):
            st, sp, sn = _solid_test(arrs, s, o, dirs, d)
            sel = pid == (arrs["sol_base"] + s)
            normal = jnp.where(sel[:, None], sn, normal)
            point = jnp.where(sel[:, None], sp, point)
            mat = jnp.where(sel, arrs["sol_mat"][s], mat)
        return point, normal, mat
    return point, n_tri, mat


def _solid_test(arrs, s, o, dirs, d):
    """Solid intersection for all rays (tracer.hpp:251-276; cube 126-152,
    sphere 154-173).  Returns (t, point, normal); t=inf on miss."""
    inv = arrs["sol_inv"][s]
    orient = arrs["sol_orient"][s]
    pos = arrs["sol_pos"][s]
    stype = arrs["sol_type"][s]

    to = _mm(o, inv.T) - pos[None, :]
    td = _mm(dirs, inv.T)

    # cube: first axis (in order) whose near face is hit inside bounds
    cube_t = jnp.full(o.shape[:1], INF, dtype=f32)
    cube_n = jnp.zeros_like(to)
    found = jnp.zeros(o.shape[:1], dtype=bool)
    for i in range(d):
        ni = jnp.where(td[:, i] < 0, 1.0, -1.0)
        dist = (ni - to[:, i]) / td[:, i]
        ok = (td[:, i] != 0) & (dist > 0)
        p = to + dist[:, None] * td
        for j in range(d):
            if j != i:
                ok &= jnp.abs(p[:, j]) <= 1 + ROUNDING_FUZZ
        take = ok & ~found
        cube_t = jnp.where(take, dist, cube_t)
        n_axis = jnp.zeros((o.shape[0], d), dtype=f32).at[:, i].set(ni)
        cube_n = jnp.where(take[:, None], n_axis, cube_n)
        found |= ok

    # sphere
    a = _dot(td, td)
    b = 2 * _dot(td, to)
    c = _dot(to, to) - 1
    disc = b * b - 4 * a * c
    sph_t = (-b - jnp.sqrt(jnp.maximum(disc, 0.0))) / (2 * a)
    sph_ok = (disc >= 0) & (sph_t > 0)
    sph_t = jnp.where(sph_ok, sph_t, INF)

    is_cube = stype == 1
    t = jnp.where(is_cube, cube_t, sph_t)
    p_obj = to + t[:, None] * td
    n_obj = jnp.where(is_cube, cube_n, p_obj)
    point = _mm(p_obj + pos[None, :], orient.T)
    normal = _mm(n_obj, orient.T)
    # the reference does not re-unit solid normals after the transform for
    # the cube path (normal.direction = orientation * axis); match that.
    return t, point, normal


# ---------------------------------------------------------------------------
# Occlusion (shadow) query: any opaque hit + transparency product
# ---------------------------------------------------------------------------

def occlusion(arrs, cfg: SceneConfig, o, dirs, ldist, skip, stats=None,
              clamp_exit=True):
    """Returns (blocked (R,), filt (R,)) — filt is the product of
    (1 - opacity) over transparent hits with 0 < t < ldist
    (light_reaches, tracer.hpp:1750-1766, with true any-hit semantics).

    Rays with ``ldist <= 0`` are inactive (shadow queries skipped by the
    caller's early-outs); the walk skips blocks whose rays are all
    inactive, and a batch with no live ray skips the walk entirely."""
    R = o.shape[0]
    d = cfg.d

    if _walk_ok(arrs):
        lay = _walk_dict(arrs)
        # No pool hit can lie beyond the pool AABB's exit distance, so the
        # exit is a valid finite cutoff: directional-light shadow rays
        # (ldist=REAL_MAX, tracer.hpp:1759) stop at the pool's edge
        # instead of walking every chunk.  Solids are tested against the
        # ORIGINAL ldist in _occlusion_finish.  Point-light queries arrive
        # with a finite ldist already (clamp_exit=False; clamping only
        # ever tightens).
        if clamp_exit:
            exit_t = chunks.scene_exit(o.T, dirs.T, lay["b_lo"],
                                       lay["b_hi"])
            pool_ldist = jnp.minimum(ldist, exit_t)
        else:
            pool_ldist = ldist
        live = pool_ldist > 0

        def run(_):
            blk, vis = walk.occluded(lay, o, dirs, pool_ldist,
                                     skip - arrs["tri_base"], d)
            return blk, jnp.sum(vis)

        def no_work(_):
            return jnp.zeros((R,), bool), jnp.int32(0)

        blk, nvis = jax.lax.cond(jnp.any(live), run, no_work, None)
        _stat(stats, "shadow_rays", jnp.sum(live.astype(jnp.int32)))
        _stat(stats, "occl_chunks_visited", nvis)
        carry = dict(blocked=blk, filt=jnp.ones((R,), f32))
        return _occlusion_finish(arrs, cfg, o, dirs, ldist, skip, carry)

    ck = _chunk_arrays(arrs, cfg)
    nc = ck["p1"].shape[0]
    ids_base = jnp.arange(CHUNK, dtype=jnp.int32)

    init = dict(blocked=jnp.zeros((R,), bool), filt=jnp.ones((R,), f32),
                nvis=jnp.int32(0))

    def chunk_step(carry, inputs):
        (p1, fn, en, dc, opacity, lo, hi, nonempty, cidx) = inputs
        entry = _slab_entry(o, dirs, lo, hi)
        pred = nonempty & jnp.any((entry < ldist) & ~carry["blocked"])

        def run(carry):
            t, valid, _ = _tri_chunk_test(o, dirs, p1, fn, en, dc, d)
            ids = arrs["tri_base"] + cidx * CHUNK + ids_base
            valid &= ids[None, :] != skip[:, None]
            valid &= t < ldist[:, None]
            blocked = carry["blocked"] | jnp.any(
                valid & (opacity[None, :] >= 1), axis=1)
            if cfg.has_transparency:
                tr = valid & (opacity[None, :] < 1)
                filt = carry["filt"] * jnp.prod(
                    jnp.where(tr, 1 - opacity[None, :], 1.0), axis=1)
            else:
                filt = carry["filt"]
            return dict(blocked=blocked, filt=filt, nvis=carry["nvis"])

        carry = jax.lax.cond(pred, run, lambda c: c, carry)
        carry["nvis"] = carry["nvis"] + pred.astype(jnp.int32)
        return carry, None

    xs = (ck["p1"], ck["fn"], ck["en"], ck["dc"], ck["opacity"],
          ck["lo"], ck["hi"], ck["nonempty"],
          jnp.arange(nc, dtype=jnp.int32))
    carry, _ = jax.lax.scan(chunk_step, init, xs)
    _stat(stats, "shadow_rays", jnp.sum((ldist > 0).astype(jnp.int32)))
    _stat(stats, "occl_chunks_visited", carry.pop("nvis"))
    return _occlusion_finish(arrs, cfg, o, dirs, ldist, skip, carry)


def _occlusion_finish(arrs, cfg, o, dirs, ldist, skip, carry):
    d = cfg.d
    for s in range(cfg.n_solids):
        st, _, _ = _solid_test(arrs, s, o, dirs, d)
        sid = arrs["sol_base"] + s
        svalid = (st > 0) & (st < ldist) & (sid != skip)
        if cfg.prim_axis is not None:
            # solids are replicated across the pool shards; count them once
            svalid &= jax.lax.axis_index(cfg.prim_axis) == 0
        s_op = arrs["mat_opacity"][arrs["sol_mat"][s]]
        carry["blocked"] |= svalid & (s_op >= 1)
        if cfg.has_transparency:
            carry["filt"] *= jnp.where(svalid & (s_op < 1), 1 - s_op, 1.0)

    blocked, filt = carry["blocked"], carry["filt"]
    if cfg.prim_axis is not None:
        blocked = jax.lax.psum(blocked.astype(jnp.int32), cfg.prim_axis) > 0
        if cfg.has_transparency:
            filt = jnp.prod(jax.lax.all_gather(filt, cfg.prim_axis), axis=0)
    return blocked, filt


# ---------------------------------------------------------------------------
# Shading (base_color, tracer.hpp:1768-1854)
# ---------------------------------------------------------------------------

def shade_local(arrs, cfg: SceneConfig, dirs, point, normal, pid, mi, depth,
                dyn, active=None, stats=None):
    """Local lighting of a batch of hit points.  Returns
    (local_color (R,3), child_coef (R,3), child_dir (R,d)).

    ``dyn`` carries the per-frame dynamic scene parameters (ambient, bg,
    etc.).  The reflection child is folded in by the caller's bounce loop:
    surface = local + child_coef * ray_color(child_dir).  ``pid`` is used
    only as the self-intersection skip for shadow rays; ``mi`` is the
    material index captured by the trace.

    ``active`` marks rays whose shading result will actually be used (the
    caller masks misses to background) — shadow queries are suppressed for
    inactive rays (the per-pixel early-outs of tracer.hpp:1750-1854),
    which with ray compaction makes them cost ~nothing."""
    R = dirs.shape[0]
    if "mat_pack" in arrs:
        # one (R, 10) row gather instead of five separate 1M-element
        # gathers; columns are
        # [color(3), specular(3), opacity, refl, spec_int, spec_exp]
        row = arrs["mat_pack"][mi]
        mc = row[:, 0:3]
        mspec = row[:, 3:6]
        refl = row[:, 7]
        spec_int = row[:, 8]
        spec_exp = row[:, 9]
    else:
        mc = arrs["mat_color"][mi]
        mspec = arrs["mat_specular"][mi]
        spec_int = arrs["mat_spec_int"][mi]
        spec_exp = arrs["mat_spec_exp"][mi]
        refl = arrs["mat_refl"][mi]

    light = jnp.zeros((R, 3), f32)
    specular = jnp.zeros((R, 3), f32)
    spec_a = jnp.zeros((R,), f32)

    def add_specular(specular, spec_a, filtered, light_dir, mask):
        # append_specular (tracer.hpp:1701-1707) runs only when the light
        # contributes AND specular_intensity != 0 — including its trailing
        # ``specular *= spec_a``, so every update is masked per ray.
        mask = mask & (spec_int != 0)
        h = _unit(light_dir - dirs)
        base = _powf(_dot(normal, h), spec_exp) * spec_int
        new_s = specular + mspec * filtered * (base * (1 - spec_a))[:, None]
        new_a = spec_a + base * (1 - spec_a)
        new_s = new_s * new_a[:, None]
        specular = jnp.where(mask[:, None], new_s, specular)
        spec_a = jnp.where(mask, new_a, spec_a)
        return specular, spec_a

    for li in range(cfg.n_point_lights):
        plp = arrs["pl_pos"][li]
        plc = arrs["pl_color"][li]
        lv = point - plp[None, :]
        dist = jnp.sqrt(_dot(lv, lv))
        lv = lv / dist[:, None]
        sine = _dot(normal, lv)
        strength = 1.0 / jnp.power(dist, cfg.d - 1)
        if cfg.shadows:
            want = (sine > 0) & (jnp.max(plc) * strength * sine > LIGHT_THRESHOLD)
            if active is not None:
                want &= active
            blocked, filt = occlusion(arrs, cfg, point, lv,
                                      jnp.where(want, dist, 0.0), pid,
                                      stats=stats, clamp_exit=False)
            ok = want & ~blocked
            filtered = plc[None, :] * filt[:, None] * strength[:, None]
            light += jnp.where(ok[:, None], filtered * sine[:, None], 0.0)
            specular, spec_a = add_specular(specular, spec_a, filtered, lv, ok)
        else:
            contrib = plc[None, :] * (strength * sine)[:, None]
            light += jnp.where((sine > 0)[:, None], contrib, 0.0)

    for gi in range(cfg.n_global_lights):
        gld = arrs["gl_dir"][gi]
        glc = arrs["gl_color"][gi]
        sine = -_dot(normal, gld[None, :])
        if cfg.shadows:
            want = sine > 0
            if active is not None:
                want &= active
            ld = jnp.broadcast_to(-gld, point.shape)
            blocked, filt = occlusion(
                arrs, cfg, point, ld,
                jnp.where(want, REAL_MAX, 0.0), pid, stats=stats)
            ok = want & ~blocked
            filtered = glc[None, :] * filt[:, None]
            light += jnp.where(ok[:, None], filtered * sine[:, None], 0.0)
            specular, spec_a = add_specular(specular, spec_a, filtered,
                                            ld, ok)
        else:
            light += jnp.where((sine > 0)[:, None],
                               glc[None, :] * sine[:, None], 0.0)

    sine = -_dot(dirs, normal)
    if cfg.camera_light:
        cl = jnp.maximum(sine, 0.0)
        light += cl[:, None]
        # camera-light specular block (tracer.hpp:1830-1838), masked like
        # add_specular.  The base is clamped non-negative, so plain
        # jnp.power equals _powf bit-for-bit without its negative-base
        # sign/NaN handling (~6 elementwise passes over the frame).
        mask = (sine > 0) & (spec_int != 0)
        base = jnp.power(jnp.maximum(sine, 0.0), spec_exp) * spec_int
        new_s = specular + mspec * (base * (1 - spec_a))[:, None]
        new_a = spec_a + base * (1 - spec_a)
        new_s = new_s * new_a[:, None]
        specular = jnp.where(mask[:, None], new_s, specular)
        spec_a = jnp.where(mask, new_a, spec_a)

    r0 = dyn["ambient"][None, :] + mc * light

    refl_on = (refl != 0) & (depth < cfg.max_reflect_depth)
    refl_eff = jnp.where(refl_on, refl, 0.0)
    local = specular + ((1 - spec_a) * (1 - refl_eff))[:, None] * r0
    child_coef = ((1 - spec_a) * refl_eff)[:, None] * mc
    child_dir = dirs - normal * (-2 * sine)[:, None]
    return local, child_coef, child_dir


# ---------------------------------------------------------------------------
# Transposed (k, R) post-trace pipeline
#
# The same math as the row pipeline over (k, R) tensors — R, the long
# axis, minor — so a small-k chain never becomes an (R, k) array with a
# tiny minor axis.  Every function below is the faithful transpose of its
# row twin: the same f32 operations applied per element in the same
# order, so values are unchanged.  It serves the walk-path scenes (opaque
# pools on the GPU: camera-lit, lit+shadowed, reflective, solids, prim
# shards); scan-path scenes take the row pipeline.  Which layout the GPU
# prefers per stage is not measured yet.
# ---------------------------------------------------------------------------


def _dotT(a, b):
    return jnp.sum(a * b, axis=0)


def _unitT(v):
    return v / jnp.sqrt(jnp.sum(v * v, axis=0, keepdims=True))


def background_T(cfg, dyn, dirsT):
    """Transpose of ``background``: (d, R) -> (3, R)."""
    intensity = dirsT[cfg.bg_axis]
    pos = (dyn["bg1"][:, None] * intensity[None, :]
           + dyn["bg2"][:, None] * (1 - intensity)[None, :])
    neg = (dyn["bg3"][:, None] * (-intensity)[None, :]
           + dyn["bg2"][:, None] * (1 + intensity)[None, :])
    return jnp.where((intensity >= 0)[None, :], pos, neg)


def aabb_distance_T(cfg, arrs, oT, dirsT):
    """Transpose of ``aabb_distance``: (d, R) inputs -> (R,)."""
    d = cfg.d
    bs, be = arrs["bound_start"], arrs["bound_end"]
    R = oT.shape[1]
    result = jnp.full((R,), -1.0, dtype=f32)
    found = jnp.zeros((R,), dtype=bool)
    for i in range(d):
        oo = jnp.where(dirsT[i] > 0, bs[i], be[i])
        dist = (oo - oT[i]) / dirsT[i]
        neg = dist < 0
        dist_eff = jnp.where(neg, 0.0, dist)
        ok = dirsT[i] != 0
        for j in range(d):
            v = dirsT[j] * dist_eff + oT[j]
            inside = (v < be[j]) & (v > bs[j])
            ok &= jnp.where((j == i) & ~neg, True, inside)
        take = ok & ~found
        result = jnp.where(take, dist_eff, result)
        found |= ok
    return result


def shade_local_T(arrs, cfg: SceneConfig, dirsT, pointT, normalT, pid, mi,
                  depth, dyn, active=None, stats=None):
    """Transpose of ``shade_local``: (d, R) geometry -> (3, R) colors,
    (3, R) child coefficients, (d, R) child directions.  Occlusion queries
    cross back to row layout at the kernel boundary (cheap transposes)."""
    R = dirsT.shape[1]
    if "mat_pack" in arrs:
        rowT = arrs["mat_pack"].T[:, mi]
        mc = rowT[0:3]
        mspec = rowT[3:6]
        refl = rowT[7]
        spec_int = rowT[8]
        spec_exp = rowT[9]
    else:
        mc = arrs["mat_color"][mi].T
        mspec = arrs["mat_specular"][mi].T
        spec_int = arrs["mat_spec_int"][mi]
        spec_exp = arrs["mat_spec_exp"][mi]
        refl = arrs["mat_refl"][mi]

    light = jnp.zeros((3, R), f32)
    specular = jnp.zeros((3, R), f32)
    spec_a = jnp.zeros((R,), f32)

    def add_specular(specular, spec_a, filteredT, light_dirT, mask):
        mask = mask & (spec_int != 0)
        h = _unitT(light_dirT - dirsT)
        base = _powf(_dotT(normalT, h), spec_exp) * spec_int
        new_s = specular + mspec * filteredT * (base * (1 - spec_a))[None, :]
        new_a = spec_a + base * (1 - spec_a)
        new_s = new_s * new_a[None, :]
        specular = jnp.where(mask[None, :], new_s, specular)
        spec_a = jnp.where(mask, new_a, spec_a)
        return specular, spec_a

    for li in range(cfg.n_point_lights):
        plp = arrs["pl_pos"][li]
        plc = arrs["pl_color"][li]
        lv = pointT - plp[:, None]
        dist = jnp.sqrt(_dotT(lv, lv))
        lv = lv / dist[None, :]
        sine = _dotT(normalT, lv)
        strength = 1.0 / jnp.power(dist, cfg.d - 1)
        if cfg.shadows:
            want = (sine > 0) & (jnp.max(plc) * strength * sine
                                 > LIGHT_THRESHOLD)
            if active is not None:
                want &= active
            blocked, filt = occlusion(arrs, cfg, pointT.T, lv.T,
                                      jnp.where(want, dist, 0.0), pid,
                                      stats=stats, clamp_exit=False)
            ok = want & ~blocked
            filteredT = plc[:, None] * filt[None, :] * strength[None, :]
            light += jnp.where(ok[None, :], filteredT * sine[None, :], 0.0)
            specular, spec_a = add_specular(specular, spec_a, filteredT,
                                            lv, ok)
        else:
            contrib = plc[:, None] * (strength * sine)[None, :]
            light += jnp.where((sine > 0)[None, :], contrib, 0.0)

    for gi in range(cfg.n_global_lights):
        gld = arrs["gl_dir"][gi]
        glc = arrs["gl_color"][gi]
        sine = -_dotT(normalT, gld[:, None])
        if cfg.shadows:
            want = sine > 0
            if active is not None:
                want &= active
            ldT = jnp.broadcast_to(-gld[:, None], pointT.shape)
            blocked, filt = occlusion(
                arrs, cfg, pointT.T, ldT.T,
                jnp.where(want, REAL_MAX, 0.0), pid, stats=stats)
            ok = want & ~blocked
            filteredT = glc[:, None] * filt[None, :]
            light += jnp.where(ok[None, :], filteredT * sine[None, :], 0.0)
            specular, spec_a = add_specular(specular, spec_a, filteredT,
                                            ldT, ok)
        else:
            light += jnp.where((sine > 0)[None, :],
                               glc[:, None] * sine[None, :], 0.0)

    sine = -_dotT(dirsT, normalT)
    if cfg.camera_light:
        cl = jnp.maximum(sine, 0.0)
        light += cl[None, :]
        mask = (sine > 0) & (spec_int != 0)
        base = jnp.power(jnp.maximum(sine, 0.0), spec_exp) * spec_int
        new_s = specular + mspec * (base * (1 - spec_a))[None, :]
        new_a = spec_a + base * (1 - spec_a)
        new_s = new_s * new_a[None, :]
        specular = jnp.where(mask[None, :], new_s, specular)
        spec_a = jnp.where(mask, new_a, spec_a)

    r0 = dyn["ambient"][:, None] + mc * light

    refl_on = (refl != 0) & (depth < cfg.max_reflect_depth)
    refl_eff = jnp.where(refl_on, refl, 0.0)
    local = specular + ((1 - spec_a) * (1 - refl_eff))[None, :] * r0
    child_coef = ((1 - spec_a) * refl_eff)[None, :] * mc
    child_dir = dirsT - normalT * (-2 * sine)[None, :]
    return local, child_coef, child_dir


def background(cfg, dyn, dirs):
    """tracer.hpp:1866-1867."""
    intensity = dirs[:, cfg.bg_axis]
    pos = (dyn["bg1"][None, :] * intensity[:, None]
           + dyn["bg2"][None, :] * (1 - intensity)[:, None])
    neg = (dyn["bg3"][None, :] * (-intensity)[:, None]
           + dyn["bg2"][None, :] * (1 + intensity)[:, None])
    return jnp.where((intensity >= 0)[:, None], pos, neg)


def aabb_distance(cfg, arrs, o, dirs):
    """tracer.hpp:1892-1918 vectorized: first axis in order whose boundary
    plane is hit within bounds; -1 when the AABB is missed."""
    d = cfg.d
    bs, be = arrs["bound_start"], arrs["bound_end"]
    result = jnp.full(o.shape[:1], -1.0, dtype=f32)
    found = jnp.zeros(o.shape[:1], dtype=bool)
    for i in range(d):
        oo = jnp.where(dirs[:, i] > 0, bs[i], be[i])
        dist = (oo - o[:, i]) / dirs[:, i]
        neg = dist < 0
        dist_eff = jnp.where(neg, 0.0, dist)
        ok = dirs[:, i] != 0
        for j in range(d):
            v = dirs[:, j] * dist_eff + o[:, j]
            inside = (v < be[j]) & (v > bs[j])
            # when dist was clamped to 0, axis i is checked too (skip == -1)
            ok &= jnp.where((j == i) & ~neg, True, inside)
        take = ok & ~found
        result = jnp.where(take, dist_eff, result)
        found |= ok
    return result


# ---------------------------------------------------------------------------
# Full per-tile ray color with bounce loop
# ---------------------------------------------------------------------------

def _ray_colors_T(arrs, cfg: SceneConfig, dyn, o, dirs, with_stats, pctx,
                  want_T=False):
    """Transposed bounce loop (same math as ray_colors; see the
    transposed-pipeline block).  Returns (R, 3) colors, or (3, R) when
    ``want_T`` (the device packer consumes channel rows directly)."""
    R = o.shape[0]
    out = jnp.zeros((3, R), f32)
    weight = jnp.ones((3, R), f32)
    active = jnp.ones((R,), bool)
    skip = jnp.full((R,), -1, jnp.int32)
    stats = {} if with_stats else None

    max_bounces = cfg.max_reflect_depth if cfg.has_reflectivity else 0

    for depth in range(max_bounces + 1):
        if stats is not None and depth > 0:
            _bounce_stats(stats, depth, active, walk.RAY_BLOCK)
        res = trace_pool(arrs, cfg, o, dirs, skip,
                         shared_origin=o[0] if depth == 0 else None,
                         active=None if depth == 0 else active,
                         stats=stats, pctx=pctx if depth == 0 else None)
        oT = o.T
        dirsT = dirs.T
        dist = aabb_distance_T(cfg, arrs, oT, dirsT)
        hit = res["hit"] & (dist >= 0)
        live = hit if depth == 0 else (hit & active)

        localT, child_coefT, child_dirT = shade_local_T(
            arrs, cfg, dirsT, res["pointT"], res["normalT"], res["pid"],
            res["mat"], depth, dyn, active=live, stats=stats)
        bgT = background_T(cfg, dyn, dirsT)
        color_hereT = jnp.where(hit[None, :], localT, bgT)

        out += jnp.where(active[None, :], weight * color_hereT, 0.0)

        if depth == max_bounces:
            break
        weight = weight * child_coefT
        active = active & hit & jnp.any(child_coefT > 0, axis=0)
        o = res["pointT"].T
        dirs = _unitT(child_dirT).T
        skip = res["pid"]

    outR = out if want_T else out.T
    if with_stats:
        return outR, {k: jnp.asarray(v) for k, v in stats.items()}
    return outR


def _bounce_stats(stats, depth, active, block=None):
    """Bounce-occupancy counters: live rays at this depth and, where the
    walk traces them in programs of ``block`` rays, live walk blocks.  A
    block with even one live ray pays for its walk, so few live rays per
    block would argue for compacting continuations across blocks before
    re-dispatch."""
    a32 = active.astype(jnp.int32)
    _stat(stats, f"bounce_live_rays_d{depth}", jnp.sum(a32))
    if block is None:
        return
    R = active.shape[0]
    rb = min(block, R)
    blk = jnp.max(a32.reshape(R // rb, rb), axis=1) if R % rb == 0 \
        else jnp.ones((1,), jnp.int32)
    _stat(stats, f"bounce_live_blocks_d{depth}", jnp.sum(blk))


def ray_colors(arrs, cfg: SceneConfig, dyn, o, dirs, with_stats=False,
               pctx=None):
    """Color of R rays (ray_color, tracer.hpp:1856-1883) with reflections
    unrolled into a weighted bounce loop.

    ``with_stats=True`` additionally returns a dict of instrumentation
    counters (rays traced, chunks visited, shadow rays — the analogue of
    the reference's PROFILE_CODE timers, instrumentation.hpp:4-53).
    ``pctx`` is the frame-level primary-trace context (primary_ctx)."""
    R = o.shape[0]
    if _walk_ok(arrs):
        return _ray_colors_T(arrs, cfg, dyn, o, dirs, with_stats, pctx)

    out = jnp.zeros((R, 3), f32)
    weight = jnp.ones((R, 3), f32)
    active = jnp.ones((R,), bool)
    skip = jnp.full((R,), -1, jnp.int32)
    stats = {} if with_stats else None

    max_bounces = cfg.max_reflect_depth if cfg.has_reflectivity else 0

    for depth in range(max_bounces + 1):
        if stats is not None and depth > 0:
            _bounce_stats(stats, depth, active)
        res = trace_pool(arrs, cfg, o, dirs, skip,
                         shared_origin=o[0] if depth == 0 else None,
                         active=None if depth == 0 else active,
                         stats=stats, pctx=pctx if depth == 0 else None)
        dist = aabb_distance(cfg, arrs, o, dirs)
        hit = res["hit"] & (dist >= 0)
        live = hit if depth == 0 else (hit & active)

        local, child_coef, child_dir = shade_local(
            arrs, cfg, dirs, res["point"], res["normal"], res["pid"],
            res["mat"], depth, dyn, active=live, stats=stats)
        bg = background(cfg, dyn, dirs)
        color_here = jnp.where(hit[:, None], local, bg)

        if cfg.has_transparency:
            color_here, weight_scale = _compose_transparent(
                arrs, cfg, dyn, o, dirs, res, hit, color_here, depth,
                stats=stats)
        else:
            weight_scale = jnp.ones((R,), f32)

        out += jnp.where(active[:, None], weight * color_here, 0.0)

        if depth == max_bounces:
            break
        weight = weight * child_coef * weight_scale[:, None]
        active = active & hit & jnp.any(child_coef > 0, axis=1)
        o = res["point"]
        dirs = _unit(child_dir)
        skip = res["pid"]

    if with_stats:
        return out, {k: jnp.asarray(v) for k, v in stats.items()}
    return out


def ray_colors_packable(arrs, cfg, dyn, o, dirs, pctx=None):
    """ray_colors variant for the packed frame path: returns
    (colors, is_T) where colors is (3, R) with is_T=True on the
    transposed pipeline (the packer reads channel rows directly —
    no final transpose) and (R, 3) otherwise."""
    if _walk_ok(arrs):
        return _ray_colors_T(arrs, cfg, dyn, o, dirs, False, pctx,
                             want_T=True), True
    return ray_colors(arrs, cfg, dyn, o, dirs, pctx=pctx), False


def _compose_transparent(arrs, cfg, dyn, o, dirs, res, hit, base_color,
                         depth, stats=None):
    """Far-to-near transparent composition (tracer.hpp:1870-1880) over the
    K nearest transparent hits.  Returns (color, weight_scale): the bounce
    loop multiplies the opaque child's weight by the total transmission."""
    K = cfg.max_transparent_hits
    color = base_color
    trans = jnp.ones(o.shape[:1], f32)
    # iterate far -> near (slot K-1 .. 0); slots are sorted ascending by t
    for k in range(K - 1, -1, -1):
        tid = res["tid"][:, k]
        tk = res["tt"][:, k]
        valid = tid >= 0
        safe_id = jnp.where(valid, tid, 0)
        point = o + tk[:, None] * dirs
        normal = res["tnorm"][:, k]
        mi = res["tmat"][:, k]
        local, _, _ = shade_local(arrs, cfg, dirs, point, normal, safe_id,
                                  mi, depth, dyn, active=valid, stats=stats)
        op = arrs["mat_opacity"][mi]
        new = local * op[:, None] + color * (1 - op)[:, None]
        color = jnp.where(valid[:, None], new, color)
        trans = jnp.where(valid, trans * (1 - op), trans)
    return color, trans


# ---------------------------------------------------------------------------
# jitted tile entry points + host-side strip renderers
# ---------------------------------------------------------------------------


# ray-block footprint: one walk block (walk.RAY_BLOCK rays) covers a
# compact TILE_W x TILE_H pixel tile, so its rays see few chunks
TILE_W = 8
TILE_H = walk.RAY_BLOCK // TILE_W
# rays per fused dispatch <= MAX_GROUP_TILES * TILE: bounds the XLA
# scan's two (R, d * CHUNK) float32 products per chunk
MAX_GROUP_TILES = 16


def _ray_coords(start, w, count=TILE):
    """Pixel coordinates for one ``count``-ray dispatch starting at linear
    pixel ``start`` (a multiple of ``count``... both multiples of the row
    length when the swizzle applies).

    When the frame geometry allows it, rays are ordered in TILE_W x TILE_H
    pixel tiles so each walk block covers a compact 2-D region (coherent
    rays -> tighter chunk culling).  Returns (xs, ys, swz) where ``swz``
    (or None) is
    a function permuting computed colors back to linear pixel order
    (reshape/transpose) before packing.
    """
    idx = start + jnp.arange(count, dtype=jnp.int32)
    if w % TILE_W == 0 and count % w == 0 and (count // w) % TILE_H == 0:
        j = jnp.arange(count, dtype=jnp.int32)
        tpr = w // TILE_W
        tile = j // (TILE_W * TILE_H)
        within = j % (TILE_W * TILE_H)
        x = (tile % tpr) * TILE_W + within % TILE_W
        y = (tile // tpr) * TILE_H + within // TILE_W
        xs = x.astype(f32)
        ys = (start // w + y).astype(f32)

        def unswz(colors):
            # tile order is axes (ty, tx, wy, wx); linear pixel order is
            # (ty, wy, tx, wx) — a reshape/transpose, not a gather
            rb = count // w // TILE_H
            c = colors.reshape(rb, tpr, TILE_H, TILE_W, -1)
            return c.transpose(0, 2, 1, 3, 4).reshape(count, -1)

        return xs, ys, unswz
    return (idx % w).astype(f32), (idx // w).astype(f32), None


@partial(jax.jit, static_argnames=("cfg",))
def _render_tile_composite(arrs, cfg, dyn, cam_origin, cam_t, fov_params,
                           xs, ys):
    fovI, half_w, half_h = fov_params
    o, dirs = make_rays(cam_origin, cam_t, fovI, half_w, half_h, xs, ys)
    return ray_colors(arrs, cfg, dyn, o, dirs)


@partial(jax.jit, static_argnames=("d",))
def _render_tile_box(d, cam_origin, cam_t, fov_params, xs, ys):
    """BoxScene pixel kernel (tracer.hpp:101-114)."""
    return _box_colors(d, cam_origin, cam_t, fov_params, xs, ys)




@partial(jax.jit, static_argnames=("cfg", "w", "n_tiles", "key"))
def _frame_packed_composite(arrs, cfg, dyn, cam_origin, cam_t, fov_params,
                            base, w, n_tiles, key):
    """A slab of the frame in one dispatch: lax.map over ray groups ->
    packed bytes.  Few launches + few device-to-host pulls per frame;
    slab-level pipelining overlaps compute with the pull of the previous
    slab."""
    from . import packing
    fovI, half_w, half_h = fov_params
    pctx = primary_ctx(arrs, cfg, cam_origin)

    # one fused dispatch per ray group (each walk call re-launches its
    # kernel, so groups are large); groups are capped so huge frames bound
    # their working-set memory
    group_tiles = min(n_tiles, MAX_GROUP_TILES)
    while n_tiles % group_tiles:
        group_tiles -= 1
    count = group_tiles * TILE

    def group(start):
        xs, ys, swz = _ray_coords(start, w, count)
        o, dirs = make_rays(cam_origin, cam_t, fovI, half_w, half_h, xs, ys)
        colors, is_T = ray_colors_packable(arrs, cfg, dyn, o, dirs,
                                           pctx=pctx)
        # key=None: wide-channel format — ship raw floats; pull_packed
        # packs them on the host with exact 64-bit math.  Otherwise pack
        # to a dense uint32 stream (the host views it as bytes) — same
        # bitstream as pack_device without the u8 relayout.  The tile
        # unswizzle permutes the packed per-pixel u32 words, not the
        # (R, 3) float colors — bit-identical; the transposed pipeline
        # hands the packer (3, R) channel rows directly (no final
        # transpose).
        if key is None:
            colors = colors.T if is_T else colors
            return colors if swz is None else swz(colors)
        return packing.pack_device_stream(colors, key, permute=swz,
                                          colors_T=is_T)

    n_groups = n_tiles // group_tiles
    if n_groups == 1:
        return group(base)
    starts = base + jnp.arange(n_groups, dtype=jnp.int32) * count
    out = jax.lax.map(group, starts)
    return out.reshape(-1, out.shape[-1])


@partial(jax.jit, static_argnames=("d", "w", "n_tiles", "key"))
def _frame_packed_box(d, cam_origin, cam_t, fov_params, base, w, n_tiles,
                      key):
    from . import packing
    group_tiles = min(n_tiles, MAX_GROUP_TILES)
    while n_tiles % group_tiles:
        group_tiles -= 1
    count = group_tiles * TILE

    def group(start):
        xs, ys, swz = _ray_coords(start, w, count)
        colors = _box_colors(d, cam_origin, cam_t, fov_params, xs, ys)
        if key is None:
            return colors if swz is None else swz(colors)
        return packing.pack_device_stream(colors, key, permute=swz)

    n_groups = n_tiles // group_tiles
    if n_groups == 1:
        return group(base)
    starts = base + jnp.arange(n_groups, dtype=jnp.int32) * count
    out = jax.lax.map(group, starts)
    return out.reshape(-1, out.shape[-1])


@partial(jax.jit, static_argnames=("cfg", "w", "n_tiles"))
def _frame_stats_composite(arrs, cfg, dyn, cam_origin, cam_t, fov_params,
                           w, n_tiles):
    """Instrumentation counters for one frame (no pixels pulled): rays
    traced, pool chunks visited/skipped, shadow rays issued — the
    per-stage analogue of the reference's PROFILE_CODE timers."""
    fovI, half_w, half_h = fov_params
    pctx = primary_ctx(arrs, cfg, cam_origin)

    def tile(start):
        xs, ys, _swz = _ray_coords(start, w)
        o, dirs = make_rays(cam_origin, cam_t, fovI, half_w, half_h, xs, ys)
        _, stats = ray_colors(arrs, cfg, dyn, o, dirs, with_stats=True,
                              pctx=pctx)
        return stats

    starts = jnp.arange(n_tiles, dtype=jnp.int32) * TILE
    stats = jax.lax.map(tile, starts)
    return {k: jnp.sum(v) for k, v in stats.items()}


def frame_stats(scene, width, height):
    """Host helper: per-stage counters for one frame of ``scene``."""
    cfg, device, _flat = get_device_scene(scene)
    fa = _frame_args(scene, width, height)
    n_tiles = -(-(width * height) // TILE)
    out = _frame_stats_composite(device, cfg, fa["dyn"], fa["cam"][0],
                                 fa["cam"][1], fa["fov"], width, n_tiles)
    return {k: int(v) for k, v in out.items()}


def frame_device_arrays(scene, fmt):
    """Dispatch one full frame on the default device as ONE program and
    return the packed device array WITHOUT pulling it to the host: the
    one-device reference that multi-device renders and tests compare
    with.  The renderers dispatch in slabs (``dispatch_packed``); time
    those to measure what a caller's frame costs on the device."""
    from . import packing
    fa = _frame_args(scene, fmt.width, fmt.height)
    cam_origin, cam_t = fa["cam"]
    fov = fa["fov"]
    key = packing.format_key(fmt)
    n_tiles = -(-(fmt.width * fmt.height) // TILE)
    if hasattr(scene, "_device_cache"):
        cfg, device, _flat = get_device_scene(scene)
        return _frame_packed_composite(device, cfg, fa["dyn"], cam_origin,
                                       cam_t, fov, _frame_base(fa, 0),
                                       fmt.width, n_tiles, key)
    return _frame_packed_box(scene.dimension, cam_origin, cam_t, fov,
                             _frame_base(fa, 0), fmt.width, n_tiles, key)


def _write_pixels(view, fmt, data, start_px, total):
    """Copy packed pixel bytes into the destination buffer, honoring
    ``fmt.pitch`` (non-contiguous rows)."""
    bpp = fmt.bytes_per_pixel
    count = min(data.shape[0], total - start_px)
    flat = data[:count].reshape(-1)
    if fmt.pitch == fmt.width * bpp:
        view[start_px * bpp:(start_px + count) * bpp] = flat.tobytes()
        return
    p = start_px
    off = 0
    while p < start_px + count:
        y, x = divmod(p, fmt.width)
        n = min(fmt.width - x, start_px + count - p)
        dst = y * fmt.pitch + x * bpp
        view[dst:dst + n * bpp] = flat[off:off + n * bpp].tobytes()
        off += n * bpp
        p += n


def dispatch_packed(scene, fmt):
    """Dispatch one full frame asynchronously; returns a list of
    ``(start_px, device_array)`` slabs whose pulls complete the frame.

    All scene state (geometry device arrays, camera, config) is captured
    by the dispatch — the caller may mutate the scene again as soon as
    this returns, which is what lets CallbackRenderer overlap frame N's
    device-to-host pull with frame N+1's compute."""
    from . import packing

    fa = _frame_args(scene, fmt.width, fmt.height)
    fov = fa["fov"]
    key = None if _needs_host_pack(fmt) else packing.format_key(fmt)
    cam_origin, cam_t = fa["cam"]

    total = fmt.width * fmt.height
    n_tiles = -(-total // TILE)

    # multi-chip: shard pixels over every device by default, mirroring the
    # reference renderer's threads = hardware cores (render.cpp:565-571)
    devs = jax.devices()
    if len(devs) > 1:
        from ..parallel import mesh as pmesh
        m = pmesh.make_mesh(len(devs), 1)
        per = -(-total // len(devs))
        per = -(-per // 512) * 512
        if per > TILE:
            per = -(-per // TILE) * TILE
        fn, arrs = pmesh.get_packed_renderer(scene, m, fmt.width, per, key)
        if arrs is None:
            dev = fn(cam_origin, cam_t, fov, _frame_base(fa, 0))
        else:
            dev = fn(arrs, fa["dyn"], cam_origin, cam_t, fov,
                     _frame_base(fa, 0))
        return [(0, dev)]

    # split into a few slabs so the next slab's compute overlaps the
    # previous slab's device-to-host pull; small frames use one slab (each
    # pull costs a host round trip)
    n_slabs = max(1, min(4, n_tiles // 4))
    per = -(-n_tiles // n_slabs)
    slab_tiles = []
    t0 = 0
    while t0 < n_tiles:
        slab_tiles.append((t0, min(per, n_tiles - t0)))
        t0 += per

    if hasattr(scene, "_device_cache"):
        cfg, device, _flat = get_device_scene(scene)
        return [(s0 * TILE,
                 _frame_packed_composite(device, cfg, fa["dyn"], cam_origin,
                                         cam_t, fov,
                                         _frame_base(fa, s0 * TILE),
                                         fmt.width, nt_, key))
                for s0, nt_ in slab_tiles]
    return [(s0 * TILE,
             _frame_packed_box(scene.dimension, cam_origin, cam_t, fov,
                               _frame_base(fa, s0 * TILE), fmt.width, nt_,
                               key))
            for s0, nt_ in slab_tiles]


def pull_packed(slabs, fmt, view, abort_check) -> bool:
    """Pull dispatched slabs into the writable byte ``view``; returns
    False when aborted (granularity: between slab pulls)."""
    from . import packing
    total = fmt.width * fmt.height
    for start_px, dev in slabs:
        if abort_check():
            return False
        data = np.asarray(dev)  # D2H; later slabs still computing
        if data.dtype == np.uint32:
            # dense packed stream (pack_device_stream): each row is 4
            # pixels' bytes as bpp little-endian uint32 words (XLA may
            # deliver the words column-major; relayout is a host memcpy)
            data = np.ascontiguousarray(data).view(np.uint8).reshape(
                -1, fmt.bytes_per_pixel)
        elif data.dtype != np.uint8:
            # wide-channel format: the dispatch shipped raw floats
            # (_needs_host_pack); pack bit-exactly here
            data = packing.pack_flat(data, fmt)
        _write_pixels(view, fmt, data, start_px, total)
    return True


def _needs_host_pack(fmt) -> bool:
    """Integer channels wider than 23 bits exceed what the device packer's
    float32 rounding correction can carry (packing.pack_device); those
    formats route to the bit-exact host packer (reference double math,
    render.cpp:396-466) so no format deviates by even one code.  The
    dispatch then ships raw float colors and pull_packed packs on the
    host — 12 bytes/pixel of link traffic instead of bytes_per_pixel,
    paid only by wide-channel formats."""
    return any((not ch.tfloat) and ch.bit_size > 23 for ch in fmt.channels)


def render_packed(scene, fmt, view, abort_check) -> bool:
    """Render a full frame into the writable byte ``view``.

    Returns False when aborted (abort granularity is the frame once the
    dispatch is in flight)."""
    import os
    import time
    if abort_check():
        return False
    profile = os.environ.get("NTRACER_PROFILE")
    t_dispatch = time.perf_counter()
    slabs = dispatch_packed(scene, fmt)
    ok = pull_packed(slabs, fmt, view, abort_check)
    if profile and ok:
        # instrumentation analogue of the reference's PROFILE_CODE timers
        print(f"[ntracer_tpu] frame {fmt.width}x{fmt.height}: "
              f"{len(slabs)} slab(s), compute+pull "
              f"{(time.perf_counter() - t_dispatch) * 1000:.1f} ms")
    return ok


def _box_colors(d, cam_origin, cam_t, fov_params, xs, ys):
    fovI, half_w, half_h = fov_params
    o, dirs = make_rays(cam_origin, cam_t, fovI, half_w, half_h, xs, ys)

    # hypercube_intersects against the unit cube at the origin
    found = jnp.zeros(o.shape[:1], bool)
    normal = jnp.zeros_like(o)
    for i in range(d):
        ni = jnp.where(dirs[:, i] < 0, 1.0, -1.0)
        dist = (ni - o[:, i]) / dirs[:, i]
        ok = (dirs[:, i] != 0) & (dist > 0)
        p = o + dist[:, None] * dirs
        for j in range(d):
            if j != i:
                ok &= jnp.abs(p[:, j]) <= 1 + ROUNDING_FUZZ
        take = ok & ~found
        n_axis = jnp.zeros_like(o).at[:, i].set(ni)
        normal = jnp.where(take[:, None], n_axis, normal)
        found |= ok

    sine = _dot(dirs, normal)
    v = jnp.where(sine <= 0, -sine, 0.0)
    hit_color = jnp.stack([v, v * 0.5, v * 0.5], axis=1)

    intensity = dirs[:, 0]
    miss_color = jnp.where((intensity > 0)[:, None],
                           jnp.stack([intensity] * 3, axis=1),
                           jnp.stack([jnp.zeros_like(intensity),
                                      -intensity, -intensity], axis=1))
    return jnp.where(found[:, None], hit_color, miss_color)


def _fov_params(w, h, fov):
    half_w = np.float32(w) / np.float32(2)
    half_h = np.float32(h) / np.float32(2)
    fovI = np.float32(np.tan(np.float32(fov) / np.float32(2)) / half_w)
    return fovI, half_w, half_h


def _strip_coords(fmt, y0, nrows):
    xs, ys = np.meshgrid(np.arange(fmt.width, dtype=np.float32),
                         np.arange(y0, y0 + nrows, dtype=np.float32))
    return xs.ravel(), ys.ravel()


def _tiled(fn, xs, ys):
    """Dispatch rays in TILE-sized (padded) batches to bound memory."""
    n = xs.shape[0]
    out = np.empty((n, 3), dtype=np.float32)
    for s in range(0, n, TILE):
        e = min(s + TILE, n)
        txs, tys = xs[s:e], ys[s:e]
        if e - s < TILE:
            pad = TILE - (e - s)
            txs = np.concatenate([txs, np.zeros(pad, np.float32)])
            tys = np.concatenate([tys, np.zeros(pad, np.float32)])
        colors = fn(txs, tys)
        out[s:e] = np.asarray(colors)[: e - s]
    return out


def walk_layouts(arrs, cull_lo, cull_hi, d):
    """The walk kernel's chunk layouts of a triangle pool, as ``walk_*``
    entries (numpy): spatial bins of the real triangles by centroid
    (near-disjoint chunk boxes, so front-to-back pruning prunes) and the
    slot-indexed packed rows [fn(d), mat, local id] that give the
    winner's id and hit geometry in ONE gather of the walk's slot
    output."""
    fn_norm = np.linalg.norm(arrs["tri_fn"], axis=1)
    bins = chunks.centroid_bins(cull_lo, cull_hi, fn_norm)
    lay = chunks.prepare_cells(
        bins, np.asarray(arrs["tri_p1"]), np.asarray(arrs["tri_fn"]),
        np.asarray(arrs["tri_en"]), np.asarray(arrs["tri_dc"]), cull_lo,
        cull_hi, d, np.asarray(arrs["tri_mat"]))
    return {"walk_" + k: v for k, v in lay.items()}


def get_device_scene(scene):
    """Flatten + device-put a CompositeScene, cached on the scene object.

    The cache holds only geometry-derived state; render flags (shadows,
    camera light, reflect depth, bg axis) are re-read from the scene every
    call so config setters never force a re-flatten/re-upload."""
    import dataclasses
    if scene._device_cache is None:
        flat = flatten_composite(scene, chunk=CHUNK)
        arrs = dict(flat.arrays)
        # per-triangle opacity + chunk AABBs for per-tile culling
        arrs["tri_opacity"] = arrs["mat_opacity"][arrs["tri_mat"]]
        # packed material rows: one shade-stage gather instead of five
        arrs["mat_pack"] = np.concatenate([
            np.asarray(arrs["mat_color"], np.float32),
            np.asarray(arrs["mat_specular"], np.float32),
            np.asarray(arrs["mat_opacity"], np.float32)[:, None],
            np.asarray(arrs["mat_refl"], np.float32)[:, None],
            np.asarray(arrs["mat_spec_int"], np.float32)[:, None],
            np.asarray(arrs["mat_spec_exp"], np.float32)[:, None],
        ], axis=1)
        # packed rows store integer ids as float32 — exact only below 2^24
        assert flat.config.n_tris < 2 ** 24, \
            "tri_pack stores ids as f32 (exact below 2^24)"
        arrs["tri_pack"] = np.concatenate([
            np.asarray(arrs["tri_fn"], np.float32),
            np.asarray(arrs["tri_mat"], np.float32)[:, None],
        ], axis=1)
        nc = flat.config.n_tris // CHUNK
        d = flat.config.d
        lo = np.zeros((nc, d), np.float32)
        hi = np.zeros((nc, d), np.float32)
        nonempty = np.zeros((nc,), bool)
        fn_norms = np.linalg.norm(arrs["tri_fn"], axis=1)
        for c in range(nc):
            sl = slice(c * CHUNK, (c + 1) * CHUNK)
            real = fn_norms[sl] > 0
            if real.any():
                lo[c] = arrs["cull_lo"][sl][real].min(axis=0)
                hi[c] = arrs["cull_hi"][sl][real].max(axis=0)
                nonempty[c] = True
        arrs["ck_lo"] = lo
        arrs["ck_hi"] = hi
        arrs["ck_nonempty"] = nonempty
        arrs["tri_base"] = np.int32(0)
        arrs["sol_base"] = np.int32(flat.config.n_tris)
        # the walk kernel's layouts, where it traces this pool
        if walk.trace_impl(jax.default_backend(), d,
                           flat.config.has_transparency) == "walk":
            arrs.update(walk_layouts(arrs, arrs["cull_lo"], arrs["cull_hi"],
                                     d))
        device = {k: jnp.asarray(v) for k, v in arrs.items()
                  if k not in ("tri_lo", "tri_hi", "cull_lo", "cull_hi")}
        scene._device_cache = (flat.config, device, flat)

    cfg, device, flat = scene._device_cache
    cfg = dataclasses.replace(
        cfg,
        shadows=bool(scene.shadows),
        camera_light=bool(scene.camera_light),
        max_reflect_depth=int(scene.max_reflect_depth),
        bg_axis=int(scene.bg_gradient_axis),
    )
    return cfg, device, flat


def _scene_dyn(scene):
    return dict(
        ambient=jnp.asarray(list(scene.ambient), dtype=f32),
        bg1=jnp.asarray(list(scene.bg1), dtype=f32),
        bg2=jnp.asarray(list(scene.bg2), dtype=f32),
        bg3=jnp.asarray(list(scene.bg3), dtype=f32),
    )


def _frame_args(scene, width, height):
    """Small per-frame dispatch arguments — dyn arrays, camera buffers,
    fov scalars, base-index scalars — cached on the scene, so a frame
    dispatch uploads nothing that did not change (each tiny conversion +
    upload is a host-to-device round trip).
    A cache hit reuses the SAME device buffers, so the dispatch is
    bit-identical to the uncached path by construction — no program or
    value changes, just fewer uploads.  Invalidation: any _mutate /
    _mutate_config bumps scene._version (full rebuild, including fov and
    the view size in the key); set_camera bumps scene._cam_version, so a
    camera-only change (the orbit-animation case) re-uploads just the
    two camera buffers.  The key also carries the VALUES of the small
    dyn inputs (fov, ambient, bg colors): they are plain writable
    Python attributes here (READONLY members in the reference,
    ntracer_body.hpp:713), so a direct ``scene.ambient = ...`` takes
    effect next frame.  NTRACER_NO_ARGCACHE=1 disables caching for
    A/Bs."""
    import os as _os
    no_cache = bool(_os.environ.get("NTRACER_NO_ARGCACHE"))
    key = (getattr(scene, "_version", -1), width, height,
           float(scene.fov),
           tuple(scene.ambient) if hasattr(scene, "ambient") else None,
           (tuple(scene.bg1), tuple(scene.bg2), tuple(scene.bg3))
           if hasattr(scene, "bg1") else None)
    c = None if no_cache else getattr(scene, "_frame_args_cache", None)
    if c is None or c["key"] != key:
        scene._set_view_size(width, height)
        fov = _fov_params(width, height, scene.fov)
        c = dict(key=key,
                 fov=tuple(jnp.asarray(x) for x in fov),
                 base={0: jnp.int32(0)},
                 dyn=(_scene_dyn(scene)
                      if hasattr(scene, "_device_cache") else None),
                 cam_key=None, cam=None)
        if not no_cache:
            scene._frame_args_cache = c
    cam_key = getattr(scene, "_cam_version", None)
    if c["cam"] is None or cam_key is None or c["cam_key"] != cam_key:
        c["cam"] = (jnp.asarray(scene._cam._origin),
                    jnp.asarray(scene._cam._t))
        c["cam_key"] = cam_key
    return c


def _frame_base(c, value):
    """Cached jnp.int32 slab base indices (one upload per distinct value
    per cache generation)."""
    b = c["base"].get(value)
    if b is None:
        b = c["base"][value] = jnp.int32(value)
    return b


def render_strip_composite(scene, fmt, y0, nrows):
    cfg, device, _flat = get_device_scene(scene)
    fa = _frame_args(scene, fmt.width, fmt.height)
    dyn = fa["dyn"]
    cam_origin, cam_t = fa["cam"]
    fov = fa["fov"]
    xs, ys = _strip_coords(fmt, y0, nrows)

    def fn(txs, tys):
        return _render_tile_composite(device, cfg, dyn, cam_origin, cam_t,
                                      fov, jnp.asarray(txs), jnp.asarray(tys))

    out = _tiled(fn, xs, ys)
    return out.reshape(nrows, fmt.width, 3)


def render_strip_box(scene, fmt, y0, nrows):
    fa = _frame_args(scene, fmt.width, fmt.height)
    cam_origin, cam_t = fa["cam"]
    fov = fa["fov"]
    xs, ys = _strip_coords(fmt, y0, nrows)

    def fn(txs, tys):
        return _render_tile_box(scene.dimension, cam_origin, cam_t, fov,
                                jnp.asarray(txs), jnp.asarray(tys))

    out = _tiled(fn, xs, ys)
    return out.reshape(nrows, fmt.width, 3)
