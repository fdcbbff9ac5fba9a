"""Chunk walk kernel for the GPU (Pallas through Triton).

One program walks one block of ``RAY_BLOCK`` rays over the chunk layouts
of ``chunks.py``.  Per chunk it tests the chunk's AABB against the rays of
the block and runs the (ray, triangle) tests only when at least one live
ray enters the box before its current cutoff:

  * nearest hit (``nearest_hit``): the cutoff is each ray's best t.
    Primary rays share one origin, so they visit chunks front to back
    (``chunks.chunk_order``) and the block leaves its loop once the next
    chunk's distance bound is >= the block's largest best t.  Secondary
    rays visit chunks in pool order and skip the ones their block misses.
  * any hit (``occluded``): the cutoff is each ray's light distance; the
    block leaves its loop once every live ray is blocked.

Blocks whose rays are all inactive (cutoff 0) do no work.  Pair tests are
float32 multiply-adds coordinate by coordinate, in the scalar oracle's
order (tracer.hpp:411-440); the contraction is d = 3..16 deep, far too
small for the tensor cores, and TF32 would flip the ROUNDING_FUZZ edge
tests.  The dimension is static and every coordinate loop is unrolled,
so any d up to ``MAX_D`` compiles with no padding.  The triangle rows are
read from device memory chunk by chunk; the pools of the benchmark scenes
fit in L2.

``trace_impl`` is the one place that decides between this kernel and the
plain XLA scan of ``wavefront.trace_pool`` / ``wavefront.occlusion``.
Only tests pass ``interpret=True``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .chunks import ROUNDING_FUZZ, scene_exit

f32 = jnp.float32
INF = np.float32(np.inf)

RAY_BLOCK = 32      # rays per program (swept 32/64/128 on an H100)
NUM_WARPS = 4
MAX_D = 16


def trace_impl(backend: str, d: int, transparent: bool) -> str:
    """Which implementation traces a pool of dimension ``d`` on
    ``backend`` (``jax.default_backend()``): ``"walk"`` (this kernel,
    compiled for the GPU) or ``"scan"`` (the XLA chunk scan, every other
    backend).  Transparent pools keep the scan: their K-nearest buffer
    has no GPU kernel yet."""
    if backend == "gpu" and not transparent and d <= MAX_D:
        return "walk"
    return "scan"


def _slab_entry(o, dv, klo_ref, khi_ref, idx, d):
    """Entry distance of each ray of the block into chunk ``idx``'s AABB
    (INF when missed).  NaN-safe for zero direction components."""
    big = np.float32(3e37)
    tn = None
    tf = None
    for c in range(d):
        lo = klo_ref[idx, c]
        hi = khi_ref[idx, c]
        par = dv[c] == 0
        inv = jnp.where(par, 0.0, 1.0 / jnp.where(par, 1.0, dv[c]))
        a = (lo - o[c]) * inv
        b = (hi - o[c]) * inv
        ins = (o[c] >= lo) & (o[c] <= hi)
        t0 = jnp.where(par, jnp.where(ins, -big, big), jnp.minimum(a, b))
        t1 = jnp.where(par, jnp.where(ins, big, -big), jnp.maximum(a, b))
        tn = t0 if tn is None else jnp.maximum(tn, t0)
        tf = t1 if tf is None else jnp.minimum(tf, t1)
    entry = jnp.maximum(tn, 0.0)
    return jnp.where((tf >= entry) & (tf >= 0), entry, INF)


def _pair_tests(o, dv, skip, gt_ref, ci_ref, ids_ref, idx, d, shared):
    """(t, valid) for every (ray, slot) pair of the block and chunk
    ``idx``: (RAY_BLOCK, CK) each.  With ``shared`` the chunk rows of
    ``ci_ref`` already hold ``ci - o.n_p`` for the one shared origin."""
    def dots(p):
        acc_o = None
        acc_d = None
        for c in range(d):
            g = gt_ref[idx, p * d + c, :][None, :]
            acc_d = dv[c][:, None] * g if acc_d is None \
                else acc_d + dv[c][:, None] * g
            if not shared:
                acc_o = o[c][:, None] * g if acc_o is None \
                    else acc_o + o[c][:, None] * g
        return acc_o, acc_d

    o0, denom = dots(0)
    c0 = ci_ref[idx, 0, :][None, :]
    t = c0 / denom if shared else (c0 - o0) / denom
    valid = (denom != 0) & (t > 0)
    tot = None
    for i in range(1, d):
        oi, di = dots(i)
        ci = ci_ref[idx, i, :][None, :]
        a = ci - t * di if shared else ci - oi - t * di
        valid &= (a >= -ROUNDING_FUZZ) & (a <= 1 + ROUNDING_FUZZ)
        tot = a if tot is None else tot + a
    if tot is not None:
        valid &= tot <= 1 + ROUNDING_FUZZ
    valid &= ids_ref[idx, :][None, :] != skip[:, None]
    return t, valid


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _walk_kernel(d, ck, rb, n_rays, nc, any_hit, ordered, shared,
                 o_ref, dir_ref, skip_ref, lim_ref, order_ref, dmin_ref,
                 klo_ref, khi_ref, gt_ref, ci_ref, ids_ref,
                 out_t_ref, out_id_ref, vis_ref):
    i = pl.program_id(0)
    r0 = i * rb
    rmask = (r0 + jnp.arange(rb, dtype=jnp.int32)) < n_rays
    rows = pl.ds(r0, rb)
    o = [plgpu.load(o_ref.at[c, rows], mask=rmask, other=0.0)
         for c in range(d)]
    dv = [plgpu.load(dir_ref.at[c, rows], mask=rmask, other=1.0)
          for c in range(d)]
    skip = plgpu.load(skip_ref.at[rows], mask=rmask, other=-1)
    # rays past the end get a zero cutoff: inactive, like masked rays
    lim = plgpu.load(lim_ref.at[rows], mask=rmask, other=0.0)

    if any_hit:
        def cond(carry):
            k, blocked, _ = carry
            return (k < nc) & _any((lim > 0) & (blocked == 0))

        def body(carry):
            k, blocked, vis = carry
            live = (lim > 0) & (blocked == 0)
            entry = _slab_entry(o, dv, klo_ref, khi_ref, k, d)
            go = _any(live & (entry < lim))

            def visit(blocked):
                t, valid = _pair_tests(o, dv, skip, gt_ref, ci_ref, ids_ref,
                                       k, d, False)
                valid &= t < lim[:, None]
                hit = jnp.max(valid.astype(jnp.int32), axis=1)
                return jnp.maximum(blocked, hit)

            blocked = jax.lax.cond(go, visit, lambda b: b, blocked)
            return k + 1, blocked, vis + go.astype(jnp.int32)

        _, blocked, vis = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.zeros((rb,), jnp.int32),
                         jnp.int32(0)))
        plgpu.store(out_id_ref.at[rows], blocked, mask=rmask)
    else:
        def cond(carry):
            k, best_t, _, _ = carry
            return (k < nc) & (jnp.max(best_t) > 0)

        def body(carry):
            k, best_t, best_id, vis = carry
            if ordered:
                idx = order_ref[k]
                # chunks are sorted by distance from the shared origin:
                # once the next one starts beyond every ray's best hit
                # (with a rounding margin), no later chunk can improve
                # any of them
                stop = dmin_ref[k] > jnp.max(best_t) * (1 + 16 * ROUNDING_FUZZ)
            else:
                idx = k
                stop = None
            entry = _slab_entry(o, dv, klo_ref, khi_ref, idx, d)
            go = _any(entry < best_t)
            if stop is not None:
                go = go & jnp.logical_not(stop)

            def visit(state):
                best_t, best_id = state
                t, valid = _pair_tests(o, dv, skip, gt_ref, ci_ref, ids_ref,
                                       idx, d, shared)
                tm = jnp.where(valid, t, INF)
                ct = jnp.min(tm, axis=1)
                carg = jnp.argmin(tm, axis=1).astype(jnp.int32)
                upd = ct < best_t
                return (jnp.where(upd, ct, best_t),
                        jnp.where(upd, idx * ck + carg, best_id))

            best_t, best_id = jax.lax.cond(go, visit, lambda s: s,
                                           (best_t, best_id))
            k = k + 1 if stop is None else jnp.where(stop, nc, k + 1)
            return k, best_t, best_id, vis + go.astype(jnp.int32)

        _, best_t, best_id, vis = jax.lax.while_loop(
            cond, body, (jnp.int32(0), lim, jnp.full((rb,), -1, jnp.int32),
                         jnp.int32(0)))
        plgpu.store(out_t_ref.at[rows], best_t, mask=rmask)
        plgpu.store(out_id_ref.at[rows], best_id, mask=rmask)
    plgpu.store(vis_ref.at[pl.ds(i, 1)], jnp.full((1,), vis, jnp.int32))


def _walk(lay, oT, dT, skip, lim, d, any_hit, order, dmin, ci, shared,
          interpret):
    R = oT.shape[1]
    nc, _, ck = lay["gt"].shape
    rb = RAY_BLOCK
    nb = pl.cdiv(R, rb)
    ordered = order is not None
    if not ordered:
        order = jnp.zeros((1,), jnp.int32)
        dmin = jnp.zeros((1,), f32)
    kernel = partial(_walk_kernel, d, ck, rb, R, nc, any_hit, ordered,
                     shared)
    out_t, out_id, vis = pl.pallas_call(
        kernel,
        grid=(nb,),
        out_shape=[jax.ShapeDtypeStruct((R,), f32),
                   jax.ShapeDtypeStruct((R,), jnp.int32),
                   jax.ShapeDtypeStruct((nb,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="ntracer_anyhit_walk" if any_hit else "ntracer_nearest_walk",
    )(oT, dT, skip, lim, order, dmin, lay["klo"], lay["khi"], lay["gt"],
      ci, lay["ids"])
    return out_t, out_id, vis


@partial(jax.jit, static_argnames=("d", "interpret"))
def nearest_hit(lay, o, dirs, skip, d, order=None, dmin=None, sh=None,
                active=None, interpret=False):
    """Nearest hit of R rays over the chunk layouts ``lay``.

    Returns (t (R,), slot (R,), visited (blocks,)): ``slot`` is the
    winning layout slot (chunk * CK + lane, -1 on a miss; the caller maps
    it through ``slot_pack``), ``visited`` the chunks each block tested.
    ``skip`` holds LOCAL pool ids (or -1).  ``order``/``dmin`` (from
    ``chunks.chunk_order``) select front-to-back order for rays that share
    one origin; ``sh`` (``chunks.shared_rows`` at that origin) replaces the
    per-ray origin dots.  ``active`` masks rays out of the walk."""
    oT, dT = o.T, dirs.T
    init_t = scene_exit(oT, dT, lay["b_lo"], lay["b_hi"])
    if active is not None:
        init_t = jnp.where(active, init_t, 0.0)
    ci = lay["ci"] if sh is None else sh
    return _walk(lay, oT, dT, skip, init_t, d, False, order, dmin, ci,
                 sh is not None, interpret)


@partial(jax.jit, static_argnames=("d", "interpret"))
def occluded(lay, o, dirs, ldist, skip, d, interpret=False):
    """Any hit with 0 < t < ldist over the chunk layouts.  Rays with
    ``ldist <= 0`` are inactive.  Returns (blocked (R,) bool, visited
    (blocks,))."""
    _, blocked, vis = _walk(lay, o.T, dirs.T, skip, ldist, d, True, None,
                            None, lay["ci"], False, interpret)
    return blocked != 0, vis
