"""Multi-device rendering over a 2-D ``jax.sharding.Mesh``.

The reference parallelizes with a native thread pool pulling 32x32 pixel
chunks off an atomic counter (render.cpp:324-563).  Here two independent
axes are sharded:

  * ``px``   — pixels (data parallel): each device renders a slab of rays;
               no communication until the frame gathers.
  * ``prim`` — the triangle pool (tensor parallel): each device traces its
               shard of the scene and the nearest-hit winner is reduced with
               an ``all_gather`` + argmin (see wavefront.trace_pool);
               occlusion reduces with ``psum``.

Scene arrays are replicated along ``px`` and sharded along ``prim``; rays
along ``px``.  This mirrors how a large scene that does not fit one
device's memory would deploy, and is exercised on a virtual CPU mesh in
tests and by ``dryrun_multichip``.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..engine import chunks, walk, wavefront
from ..engine.wavefront import CHUNK, make_rays, ray_colors

f32 = jnp.float32


def make_mesh(n_px: int, n_prim: int = 1, devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    if n_px * n_prim > len(devices):
        raise ValueError(f"mesh {n_px}x{n_prim} needs {n_px*n_prim} devices, "
                         f"have {len(devices)}")
    dev = np.asarray(devices[: n_px * n_prim]).reshape(n_px, n_prim)
    return Mesh(dev, ("px", "prim"))


def _pad_pool(arrs, cfg, n_prim):
    """Pad the triangle pool (and chunk AABBs) so it splits evenly into
    ``n_prim`` shards of whole chunks."""
    t = cfg.n_tris
    per = -(-t // (CHUNK * n_prim)) * CHUNK  # chunks per shard * CHUNK
    t_new = per * n_prim
    if t_new == t:
        return arrs, cfg, per
    grow = t_new - t
    out = dict(arrs)
    for k in ("tri_p1", "tri_fn", "tri_en", "tri_dc", "tri_mat",
              "tri_opacity", "tri_pack"):
        a = np.asarray(arrs[k])
        pad = [(0, grow)] + [(0, 0)] * (a.ndim - 1)
        out[k] = np.pad(a, pad)
    nc_new = t_new // CHUNK
    nc = t // CHUNK
    for k, fill in (("ck_lo", 0.0), ("ck_hi", 0.0), ("ck_nonempty", False)):
        a = np.asarray(arrs[k])
        pad = [(0, nc_new - nc)] + [(0, 0)] * (a.ndim - 1)
        out[k] = np.pad(a, pad, constant_values=fill)
    cfg = dataclasses.replace(cfg, n_tris=t_new)
    return out, cfg, per


_TRI_KEYS = ("tri_p1", "tri_fn", "tri_en", "tri_dc", "tri_mat",
             "tri_opacity", "tri_pack", "ck_lo", "ck_hi", "ck_nonempty")

def _shard_layouts(arrs, cull_lo, cull_hi, cfg, n_prim, per_shard):
    """Per-shard walk layouts: each shard's pool slice gets its own
    centroid-bin chunks with LOCAL slot ids, so the walk runs unchanged
    per shard under shard_map — the reference's scene kernel is likewise
    identical under any thread count (tracer.hpp:1179-1243).  Shards are
    padded to a common chunk count and stacked along a leading ``prim``
    axis.  Empty ({}) where the walk does not trace this pool."""
    d = cfg.d
    if walk.trace_impl(jax.default_backend(), d,
                       cfg.has_transparency) != "walk":
        return {}

    def shard(s):
        sl = slice(s * per_shard, (s + 1) * per_shard)
        return {k: np.asarray(v)[sl] for k, v in arrs.items()
                if k.startswith("tri_")}, cull_lo[sl], cull_hi[sl]

    per = [wavefront._walk_dict(wavefront.walk_layouts(*shard(s), d))
           for s in range(n_prim)]
    n_chunks = max(p["ids"].shape[0] for p in per)
    per = [chunks.pad_cells(p, n_chunks) for p in per]
    return {"walk_" + k: np.stack([p[k] for p in per]) for k in per[0]}


def build_sharded_renderer(scene, mesh: Mesh, tile: int):
    """Compile a frame-tile renderer sharded over ``mesh``.

    Returns ``(fn, arrs)`` where ``fn(arrs, dyn, cam_origin, cam_t,
    fov_params, xs, ys) -> (tile, 3)`` and xs/ys have length ``tile``
    (divisible by the px axis size)."""
    cfg, device, flat = wavefront.get_device_scene(scene)
    n_px = mesh.shape["px"]
    n_prim = mesh.shape["prim"]
    if tile % n_px:
        raise ValueError("tile size must divide evenly over the px axis")

    arrs = {k: np.asarray(v) for k, v in device.items()}
    arrs, cfg, per_shard = _pad_pool(arrs, cfg, n_prim)
    del arrs["tri_base"], arrs["sol_base"]
    # The FULL-pool walk layouts from get_device_scene are invalid under
    # shard_map (per-shard pool slices); rebuild them PER SHARD with local
    # ids instead, so the walk survives tensor-parallel pools.
    for k in [k for k in arrs if k.startswith("walk_")]:
        del arrs[k]
    t_new = per_shard * n_prim
    cull_lo = np.asarray(flat.arrays["cull_lo"])
    cull_hi = np.asarray(flat.arrays["cull_hi"])
    if cull_lo.shape[0] < t_new:
        grow = t_new - cull_lo.shape[0]
        cull_lo = np.pad(cull_lo, [(0, grow), (0, 0)])
        cull_hi = np.pad(cull_hi, [(0, grow), (0, 0)])
    arrs.update(_shard_layouts(arrs, cull_lo, cull_hi, cfg, n_prim,
                               per_shard))

    cfg_shard = dataclasses.replace(
        cfg,
        n_tris=per_shard,
        prim_axis="prim" if n_prim > 1 else None,
    )
    specs = {k: (P("prim") if k in _TRI_KEYS or k.startswith("walk_")
                 else P())
             for k in arrs}

    def shard_fn(arrs_l, dyn, cam_origin, cam_t, fov_params, xs, ys):
        arrs_l = dict(arrs_l)
        for k in arrs_l:
            if k.startswith("walk_"):
                arrs_l[k] = arrs_l[k][0]   # drop the size-1 shard axis
        if n_prim > 1:
            base = jax.lax.axis_index("prim").astype(jnp.int32) * per_shard
        else:
            base = jnp.int32(0)
        arrs_l["tri_base"] = base
        arrs_l["sol_base"] = jnp.int32(cfg.n_tris)
        fovI, half_w, half_h = fov_params
        o, dirs = make_rays(cam_origin, cam_t, fovI, half_w, half_h, xs, ys)
        return ray_colors(arrs_l, cfg_shard, dyn, o, dirs)

    dyn_spec = dict(ambient=P(), bg1=P(), bg2=P(), bg3=P())
    in_specs = (specs, dyn_spec, P(), P(), (P(), P(), P()),
                P("px"), P("px"))
    fn = shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                   out_specs=P("px", None), check_vma=False)
    return jax.jit(fn), arrs


def get_sharded_renderer(scene, mesh: Mesh, tile: int):
    """Cached ``build_sharded_renderer`` (re-tracing and compiling the
    shard_map per frame would dominate).  The cache lives on the scene (cleared by geometry mutation, like ``_device_cache``) and is keyed
    by mesh layout, tile size, and the static render config."""
    cfg, _, _ = wavefront.get_device_scene(scene)
    key = (tuple(d.id for d in mesh.devices.flat), mesh.axis_names, tile, cfg)
    cache = getattr(scene, "_mesh_cache", None)
    if cache is None or cache[0] is not scene._device_cache \
            or key not in cache[1]:
        if cache is None or cache[0] is not scene._device_cache:
            cache = (scene._device_cache, {})
            scene._mesh_cache = cache
        cache[1][key] = build_sharded_renderer(scene, mesh, tile)
    return cache[1][key]


def _shard_groups(per_shard):
    """Fused-dispatch geometry for one pixel shard: (n_groups, rays per
    group).  Mirrors wavefront._frame_packed_composite — one fused
    ray_colors call per group."""
    if per_shard % wavefront.TILE == 0:
        n_tiles = per_shard // wavefront.TILE
        gt = min(n_tiles, wavefront.MAX_GROUP_TILES)
        while n_tiles % gt:
            gt -= 1
        return n_tiles // gt, gt * wavefront.TILE
    return 1, per_shard


def _run_groups(group, base, n_groups, count):
    if n_groups == 1:
        return group(base)
    starts = base + jnp.arange(n_groups, dtype=jnp.int32) * count
    out = jax.lax.map(group, starts)
    return out.reshape(-1, out.shape[-1])


def build_packed_renderer(scene, mesh: Mesh, width, per_shard, key):
    """Frame renderer for the PRODUCTION path: pixels sharded over the
    ``px`` axis, per-shard ray indices generated on-device (no per-frame
    H2D), channel packing on-device per shard — only packed bytes cross
    the host link.  This is the multi-device equivalent of the reference
    renderer using all cores by default (render.cpp:565-571).

    Pool arrays stay replicated (``prim`` axis unused -> the walk layouts
    remain valid per shard).  Returns ``(fn, arrs)`` with
    ``fn(arrs, dyn, cam_origin, cam_t, fov_params, start) -> (n_px *
    per_shard, bpp) uint8``."""
    from ..engine import packing

    cfg, device, _ = wavefront.get_device_scene(scene)
    n_px = mesh.shape["px"]
    if per_shard % wavefront.TILE and per_shard > wavefront.TILE:
        raise ValueError("per_shard must be a multiple of TILE when tiled")

    arrs = {k: np.asarray(v) for k, v in device.items()}
    del arrs["tri_base"], arrs["sol_base"]
    # replicate the scene once at build time (cached) — re-uploading the
    # pool per frame would dominate
    arrs = jax.device_put(
        arrs, jax.sharding.NamedSharding(mesh, P()))
    n_groups, count = _shard_groups(per_shard)

    def shard_fn(arrs_l, dyn, cam_origin, cam_t, fov_params, start):
        arrs_l = dict(arrs_l)
        arrs_l["tri_base"] = jnp.int32(0)
        arrs_l["sol_base"] = jnp.int32(cfg.n_tris)
        fovI, half_w, half_h = fov_params
        base = start + jax.lax.axis_index("px").astype(jnp.int32) * per_shard
        pctx = wavefront.primary_ctx(arrs_l, cfg, cam_origin)

        def group(g0):
            # tiled swizzled ray order when the shard geometry allows it
            # (compact pixel tiles -> coherent walk blocks, like the
            # single-device path); the unswizzle permutes the packed words
            xs, ys, swz = wavefront._ray_coords(g0, width, count)
            o, dirs = make_rays(cam_origin, cam_t, fovI, half_w, half_h,
                                xs, ys)
            colors, is_T = wavefront.ray_colors_packable(
                arrs_l, cfg, dyn, o, dirs, pctx=pctx)
            # key=None: wide-channel format — the caller packs raw floats
            # on the host (wavefront._needs_host_pack)
            if key is None:
                colors = colors.T if is_T else colors
                return colors if swz is None else swz(colors)
            return packing.pack_device_stream(colors, key, permute=swz,
                                              colors_T=is_T)

        return _run_groups(group, base, n_groups, count)

    specs = {k: P() for k in arrs}
    dyn_spec = dict(ambient=P(), bg1=P(), bg2=P(), bg3=P())
    in_specs = (specs, dyn_spec, P(), P(), (P(), P(), P()), P())
    fn = shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                   out_specs=P("px", None), check_vma=False)
    return jax.jit(fn), arrs


def build_packed_box_renderer(scene, mesh: Mesh, width, per_shard, key):
    """BoxScene variant of build_packed_renderer."""
    from ..engine import packing

    n_px = mesh.shape["px"]
    d = scene.dimension
    n_groups, count = _shard_groups(per_shard)
    del n_px

    def shard_fn(cam_origin, cam_t, fov_params, start):
        base = start + jax.lax.axis_index("px").astype(jnp.int32) * per_shard

        def group(g0):
            xs, ys, swz = wavefront._ray_coords(g0, width, count)
            colors = wavefront._box_colors(d, cam_origin, cam_t, fov_params,
                                           xs, ys)
            if key is None:
                return colors if swz is None else swz(colors)
            return packing.pack_device_stream(colors, key, permute=swz)

        return _run_groups(group, base, n_groups, count)

    in_specs = (P(), P(), (P(), P(), P()), P())
    fn = shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                   out_specs=P("px", None), check_vma=False)
    return jax.jit(fn), None


def get_packed_renderer(scene, mesh: Mesh, width, per_shard, key):
    """Cached packed-frame renderer (see get_sharded_renderer for why)."""
    is_box = not hasattr(scene, "_device_cache")
    if is_box:
        cache_src = None
        cfg = ("box", scene.dimension)
    else:
        cfg, _, _ = wavefront.get_device_scene(scene)
        cache_src = scene._device_cache
    k = (tuple(d.id for d in mesh.devices.flat), mesh.axis_names,
         width, per_shard, key, cfg)
    cache = getattr(scene, "_packed_mesh_cache", None)
    if cache is None or cache[0] is not cache_src or k not in cache[1]:
        if cache is None or cache[0] is not cache_src:
            cache = (cache_src, {})
            scene._packed_mesh_cache = cache
        if is_box:
            cache[1][k] = build_packed_box_renderer(scene, mesh, width,
                                                    per_shard, key)
        else:
            cache[1][k] = build_packed_renderer(scene, mesh, width,
                                                per_shard, key)
    return cache[1][k]


def render_frame(scene, fmt, mesh: Mesh):
    """Render a full frame sharded over the mesh; returns (H, W, 3) f32."""
    n_px = mesh.shape["px"]
    total = fmt.width * fmt.height
    tile = -(-total // n_px) * n_px
    fn, arrs = get_sharded_renderer(scene, mesh, tile)

    xs, ys = np.meshgrid(np.arange(fmt.width, dtype=np.float32),
                         np.arange(fmt.height, dtype=np.float32))
    xs = np.pad(xs.ravel(), (0, tile - total))
    ys = np.pad(ys.ravel(), (0, tile - total))

    fa = wavefront._frame_args(scene, fmt.width, fmt.height)
    out = fn(arrs, fa["dyn"], fa["cam"][0], fa["cam"][1], fa["fov"],
             jnp.asarray(xs), jnp.asarray(ys))
    return np.asarray(out)[:total].reshape(fmt.height, fmt.width, 3)
