"""Spatial chunk layouts of the triangle pool for the walk kernel.

The pool is partitioned into chunks of ``CK`` triangles by a recursive
median split on triangle centroids (``centroid_bins``).  Each chunk keeps
its own AABB, so a block of rays can test the chunk box before it tests
the triangles in it, and primary rays (one shared origin) can visit the
chunks front to back and stop once every ray's nearest hit lies in front
of the next chunk (``chunk_order``): the analogue of the reference's
near/far-ordered k-d traversal with t-clipping (tracer.hpp:1179-1243).

Everything here runs once per scene on the host (numpy) except
``chunk_order``, ``shared_rows`` and ``scene_exit``, which run inside
the frame program.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

f32 = jnp.float32

CK = 64           # triangles per chunk (the walk kernel's tile width)

ROUNDING_FUZZ = np.float32(np.finfo(np.float32).eps * 10)
BIG = np.float32(3e37)


def centroid_bins(tri_lo, tri_hi, fn_norm, ck: int = CK):
    """Partition real triangles (non-degenerate AABBs) into spatial bins of
    <= ck by recursive median split on the widest centroid axis.  Unlike
    k-d treelets, every triangle lands in exactly ONE bin (no duplication);
    bin boxes are the exact union of member AABBs, so they are disjoint up
    to triangle extent — tight enough for front-to-back pruning on real
    meshes where triangles are small.

    Returns a list of (lo, hi, [pool ids])."""
    ids_all = np.nonzero(fn_norm > 0)[0]
    if len(ids_all) == 0:
        return []
    cent = (tri_lo + tri_hi) * 0.5
    out = []

    def rec(ids):
        if len(ids) <= ck:
            lo = tri_lo[ids].min(axis=0)
            hi = tri_hi[ids].max(axis=0)
            out.append((lo, hi, list(ids)))
            return
        c = cent[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        order = np.argsort(c[:, axis], kind="stable")
        h = len(ids) // 2
        rec(ids[order[:h]])
        rec(ids[order[h:]])

    # primitives whose box spans a large fraction of the scene (sliver
    # batches, walls) would drag any spatial bin's box out to near-global
    # and destroy the culling; give them dedicated always-visited bins
    diag = np.linalg.norm(tri_hi[ids_all] - tri_lo[ids_all], axis=1)
    scene_diag = np.linalg.norm(tri_hi[ids_all].max(axis=0)
                                - tri_lo[ids_all].min(axis=0))
    wide = diag > 0.35 * max(scene_diag, 1e-30)
    for s in range(0, int(wide.sum()), ck):
        ids = ids_all[wide][s:s + ck]
        out.append((tri_lo[ids].min(axis=0), tri_hi[ids].max(axis=0),
                    list(ids)))
    narrow = ids_all[~wide]
    if len(narrow):
        rec(narrow)
    return out


def prepare_cells(bins, tri_p1, tri_fn, tri_en, tri_dc, tri_lo, tri_hi, d,
                  tri_mat, ck: int = CK):
    """Chunk layouts from ``centroid_bins`` output (numpy arrays):

      ``gt``   (nc, d*d, ck) — plane rows: row p*d+c = coordinate c of
               plane p's normal (plane 0 = face normal, 1.. = edges);
               zero in padding slots (zero normal -> never a hit).
      ``ci``   (nc, d, ck) — row 0 = -dc (plane offset), rows 1..d-1 =
               edge offsets e_i . p1.
      ``ids``  (nc, ck) i32 — local pool id per slot, -2 in padding
               slots (never equal to a skip id).
      ``klo``/``khi`` (nc, d) — chunk AABBs; padding chunks inverted
               (+BIG/-BIG) so slab tests miss.
      ``b_lo``/``b_hi`` (d,) — pool AABB (nearest-hit cutoff).
      ``slot_pack`` (nc*ck, d+2) — per slot [fn(d), mat, local id]: the
               winner's id and hit geometry in ONE gather of the walk's
               slot output (ids and materials are exact in f32 below
               2^24).

    A pool with no real triangle gets one empty chunk."""
    nc = max(len(bins), 1)
    gt = np.zeros((nc, d * d, ck), np.float32)
    ci = np.zeros((nc, d, ck), np.float32)
    ids = np.full((nc, ck), -2, np.int32)
    klo = np.full((nc, d), BIG, np.float32)
    khi = np.full((nc, d), -BIG, np.float32)

    planes = np.concatenate([tri_fn[:, None, :], tri_en], axis=1)  # (T,d,d)
    eo = np.einsum("tid,td->ti", tri_en, tri_p1, dtype=np.float32)

    for k, (_lo, _hi, pids) in enumerate(bins):
        pids = np.asarray(pids, np.int64)
        n = len(pids)
        gt[k, :, :n] = planes[pids].reshape(n, d * d).T
        ci[k, 0, :n] = -tri_dc[pids]
        ci[k, 1:d, :n] = eo[pids].T
        ids[k, :n] = pids
        klo[k] = tri_lo[pids].min(axis=0)
        khi[k] = tri_hi[pids].max(axis=0)

    real = np.linalg.norm(tri_fn, axis=1) > 0
    if real.any():
        b_lo = tri_lo[real].min(axis=0)
        b_hi = tri_hi[real].max(axis=0)
    else:
        b_lo = np.zeros(d, np.float32)
        b_hi = np.zeros(d, np.float32)

    assert len(tri_fn) < 2 ** 24, "slot_pack stores ids as f32"
    sids = ids.reshape(-1).astype(np.int64)
    safe = np.clip(sids, 0, max(len(tri_fn) - 1, 0))
    sp = np.zeros((nc * ck, d + 2), np.float32)
    sp[:, :d] = np.where(sids[:, None] >= 0, tri_fn[safe], 0)
    sp[:, d] = np.where(sids >= 0, np.asarray(tri_mat)[safe], 0)
    sp[:, d + 1] = np.where(sids >= 0, sids, -1)
    return dict(gt=gt, ci=ci, ids=ids, klo=klo, khi=khi,
                b_lo=b_lo, b_hi=b_hi, slot_pack=sp)


def pad_cells(lay, n_chunks, ck: int = CK):
    """``prepare_cells`` layouts grown to ``n_chunks`` with empty chunks
    (per-shard layouts stack to one chunk count): inverted boxes (never
    entered), -2 ids (never a skip id), miss rows in the slot pack."""
    grow = n_chunks - lay["ids"].shape[0]

    def pad(a, fill, rows=grow):
        return np.concatenate(
            [a, np.full((rows,) + a.shape[1:], fill, a.dtype)])

    sp = pad(lay["slot_pack"], 0, grow * ck)
    sp[len(lay["slot_pack"]):, -1] = -1
    return dict(lay, gt=pad(lay["gt"], 0), ci=pad(lay["ci"], 0),
                ids=pad(lay["ids"], -2), klo=pad(lay["klo"], BIG),
                khi=pad(lay["khi"], -BIG), slot_pack=sp)


def chunk_order(klo, khi, origin):
    """Front-to-back chunk permutation + per-position lower bounds.

    ``origin`` (d,) is the shared ray origin (the camera for primary
    rays).  Returns (order (nc,) i32, dmin (nc,) f32) where dmin[k] is the
    exact minimum distance from ``origin`` to chunk order[k]'s AABB —
    a lower bound on any ray's entry distance, so the traversal can stop
    once every ray's best hit is nearer.  Empty chunks (inverted AABBs)
    sort last with dmin=BIG."""
    span_ok = klo <= khi                       # (nc, d) False for empties
    cl = jnp.minimum(klo, khi)
    ch = jnp.maximum(klo, khi)
    p = jnp.clip(origin[None, :], cl, ch)
    dv = jnp.where(span_ok, p - origin[None, :], 0.0)
    dist = jnp.sqrt(jnp.sum(dv * dv, axis=1))
    dist = jnp.where(jnp.all(span_ok, axis=1), dist, BIG)
    order = jnp.argsort(dist).astype(jnp.int32)
    return order, jnp.sort(dist)


def scene_exit(oT, dT, b_lo, b_hi):
    """Exit distance of each ray from the pool AABB (0 when missed), for
    lane-major (d, R) rays: no pool hit lies beyond it, so it is the
    nearest-hit walk's starting cutoff and a finite bound for
    directional-light shadow rays.  NaN-safe for zero direction
    components."""
    inv = jnp.where(dT != 0, 1.0 / jnp.where(dT != 0, dT, 1.0), 0.0)
    a = (b_lo[:, None] - oT) * inv
    b = (b_hi[:, None] - oT) * inv
    par = dT == 0
    inside = (oT >= b_lo[:, None]) & (oT <= b_hi[:, None])
    t0 = jnp.where(par, jnp.where(inside, -BIG, BIG), jnp.minimum(a, b))
    t1 = jnp.where(par, jnp.where(inside, BIG, -BIG), jnp.maximum(a, b))
    tn = jnp.max(t0, axis=0)
    tf = jnp.min(t1, axis=0)
    hit = (tf >= jnp.maximum(tn, 0.0)) & (tf >= 0)
    return jnp.where(hit, tf * (1 + 16 * ROUNDING_FUZZ), 0.0)


def shared_rows(gt, ci, origin, d):
    """Shared-origin per-slot rows: ``sh[k, p, s] = ci[k, p, s] - o.n_p``
    with the origin dots accumulated coordinate by coordinate — the same
    float ops as the walk's per-ray path, computed once per frame instead
    of once per (ray, slot) pair.  Returns (nc, d, ck)."""
    rows = []
    for p in range(d):
        acc = jnp.zeros(gt.shape[::2], f32)
        for c in range(d):
            acc = acc + origin[c] * gt[:, p * d + c, :]
        rows.append(ci[:, p, :] - acc)
    return jnp.stack(rows, axis=1)
