#!/usr/bin/env python
"""Smoke run of the renderer on an NVIDIA GPU, through the public API.

    python chip_smoke.py            # one card: every feature path
    python chip_smoke.py --multi    # four cards: the multi-device paths

One card (the default) renders, with ``BlockingRenderer`` at 1024x1024
8-bit RGB:

  * the reference's own benchmark, ``polytope.py 5 3 3 --benchmark``: the
    4-D 120-cell, fov 0.8, rotating camera at -4 on axis 2;
  * the 6-D lit scene (900 simplices, two point lights and a directional
    light, shadows on);
  * the reflective + shadowed 3-D scene;
  * the ~100k-triangle sphere mesh;
  * a transparent 3-D scene;
  * the analytic 10-D BoxScene at 1920x1080.

For each it prints the implementation that traced it (from
``walk.trace_impl``, the code's own choice), cold and warm frame times
from the caller's side, the on-device frame time (dispatches synchronised
with ``block_until_ready``), peak device memory so far, and a comparison
of sampled pixels against the scalar oracle (``scene._pixel_color``).
Then ``CallbackRenderer`` renders the flagship's orbit pipelined, frame
for frame equal to ``BlockingRenderer``; the walk kernel and the XLA
scan trace the flagship's 1M primary rays (nearest hit), and every
shadow ray of a frame of the reflective scene and of the flagship lit by
a point light (any hit), and the two are compared.

Tolerances.  The oracle runs in NumPy float32 with its own summation
order; the engine's sums run in XLA's GPU order (and the walk's
coordinate loops may contract into FMAs), so colours differ in the last
bits: float colours must agree within 1e-5 absolute.  No matrix product
may run in TF32 (every one asks for ``Precision.HIGHEST``); a TF32 product
(~1e-3 relative) would exceed that bound.  Every sample beyond it must
fall in a rounding class of ``scripts/frame_parity.py`` (an equal-t
coplanar tie, or a ROUNDING_FUZZ edge flip on the primary ray or a ray it
spawns); any other mismatch fails the phase.  Walk vs scan: t within
1e-5 relative and the same winning triangle, and the same any-hit
answer, except on classified rays.

``--multi`` (four cards joined all to all) renders the flagship at
2048x2048 with pixels sharded over the four cards, compared byte for byte
with a one-card render of the same frame, and the 100k mesh on a 2x2
px x prim mesh (the pool sharded over two cards, nearest hits reduced
with all_gather + argmin), compared with a one-card render.

The script needs the GPU: it exits non-zero where JAX finds none.  The
last line of its output is one JSON object with the device JAX reports.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

COLOR_TOL = 1e-5       # float colour vs the oracle (see the docstring)
T_RTOL = 1e-5          # walk vs scan hit distance
ORBIT_FRAMES = 4


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _peak_bytes():
    import jax
    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def _formats(w, h):
    from ntracer import ImageFormat, Channel
    rgb8 = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                              Channel(8, 0, 0, 1)])
    rgbf = ImageFormat(w, h, [Channel(32, 1, 0, 0, tfloat=True),
                              Channel(32, 0, 1, 0, tfloat=True),
                              Channel(32, 0, 0, 1, tfloat=True)])
    return rgb8, rgbf


def _render(scene, fmt):
    from ntracer import BlockingRenderer
    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer().render(buf, fmt, scene)
    return buf


def _impl(scene):
    """(implementation, dimension) the code chose for ``scene``."""
    import jax
    from ntracer_tpu.engine import walk, wavefront
    if not hasattr(scene, "_device_cache"):
        return "analytic box", scene.dimension
    cfg, dev, _ = wavefront.get_device_scene(scene)
    impl = walk.trace_impl(jax.default_backend(), cfg.d,
                           cfg.has_transparency)
    assert (impl == "walk") == wavefront._walk_ok(dev), impl
    return ("walk kernel" if impl == "walk" else "XLA scan"), cfg.d


def _sample_pixels(scene, img, w, h, n, rng):
    """n uniform pixels plus n pixels the scene covers (not background)."""
    import numpy as np
    xs = list(rng.randint(0, w, n))
    ys = list(rng.randint(0, h, n))
    if hasattr(scene, "_device_cache"):
        import jax.numpy as jnp
        from ntracer_tpu.engine import wavefront
        cfg, _, _ = wavefront.get_device_scene(scene)
        fa = wavefront._frame_args(scene, w, h)
        idx = jnp.arange(w * h, dtype=jnp.int32)
        _, dirs = wavefront.make_rays(fa["cam"][0], fa["cam"][1], *fa["fov"],
                                      (idx % w).astype(jnp.float32),
                                      (idx // w).astype(jnp.float32))
        bg = np.asarray(wavefront.background(cfg, fa["dyn"], dirs))
        fg = np.nonzero(np.abs(img.reshape(-1, 3)
                               - np.clip(bg, 0, 1)).max(axis=1) > 0)[0]
        pick = fg[rng.randint(0, len(fg), n)] if len(fg) else []
        xs += [int(p % w) for p in pick]
        ys += [int(p // w) for p in pick]
    return list(zip(map(int, xs), map(int, ys)))


def _oracle_check(scene, w, h, samples):
    """Float frame through the main path vs the scalar oracle."""
    import numpy as np
    import frame_parity as fp
    from ntracer_tpu import kdnodes

    # the engine uses true any-hit occlusion; the oracle's default ports
    # the reference's early-out defect (PARITY.md)
    kdnodes.OCCLUDES_EARLY_OUT = False
    _, rgbf = _formats(w, h)
    img = np.frombuffer(bytes(_render(scene, rgbf)),
                        ">f4").reshape(h, w, 3).astype(np.float32)
    pixels = _sample_pixels(scene, img, w, h, samples,
                            np.random.RandomState(0))
    scene._set_view_size(w, h)
    box = not hasattr(scene, "_device_cache")
    classify = fp.make_box_classifier(scene, w, h, quantization=False) \
        if box else (lambda x, y: fp.classify_pixel(scene, x, y, w, h))
    worst, classes = 0.0, {}
    for x, y in pixels:
        want = np.clip(np.asarray(scene._pixel_color(x, y), np.float32), 0, 1)
        err = float(np.abs(img[y, x] - want).max())
        if err > COLOR_TOL:
            v = classify(x, y)
            classes[v] = classes.get(v, 0) + 1
        else:
            worst = max(worst, err)
    return dict(samples=len(pixels), max_err_within_tol=worst,
                exceed=classes, unclassified=classes.get("genuine", 0))


def _frame_phase(name, build, w, h, samples):
    import numpy as np
    import scenes

    nt, scene, cam, dist = build()
    impl, d = _impl(scene)
    rgb8, _ = _formats(w, h)
    t0 = time.perf_counter()
    img8 = _render(scene, rgb8)
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(ORBIT_FRAMES):
        scenes.orbit(nt, scene, cam, dist, 2 * np.pi / ORBIT_FRAMES / 2)
        t0 = time.perf_counter()
        _render(scene, rgb8)
        warm.append(time.perf_counter() - t0)
    # on-device: the renderer's own dispatches, queued, one wait
    on_device_ms = scenes.device_frame_ms(scene, rgb8, ORBIT_FRAMES)
    oracle = _oracle_check(scene, w, h, samples)
    row = dict(phase=name, resolution=f"{w}x{h}", dimension=d, impl=impl,
               cold_frame_s=cold, warm_frame_ms=[t * 1e3 for t in warm],
               warm_frame_ms_mean=float(np.mean(warm)) * 1e3,
               on_device_frame_ms=on_device_ms,
               peak_device_bytes=_peak_bytes(),
               nonblack_px=int((np.frombuffer(bytes(img8), np.uint8)
                                .reshape(-1, 3).sum(axis=1) > 0).sum()),
               oracle=oracle)
    print(json.dumps(row), flush=True)
    return oracle["unclassified"] == 0


def _callback_orbit(build, w, h, frames=8):
    """CallbackRenderer, pipelined: every frame of an orbit is queued at
    once (each dispatch captures its camera, so the next frame's compute
    overlaps the previous frame's pull); each frame must equal the
    BlockingRenderer frame at the same camera, byte for byte."""
    import threading
    import numpy as np
    import scenes
    from ntracer import CallbackRenderer

    nt, scene, cam, dist = build()
    rgb8, _ = _formats(w, h)
    cams, want = [], []
    for _ in range(frames):
        cams.append(scene.get_camera())
        want.append(bytes(_render(scene, rgb8)))
        scenes.orbit(nt, scene, cam, dist, 2 * np.pi / frames)
    bufs = [bytearray(rgb8.pitch * rgb8.height) for _ in range(frames)]
    done = threading.Semaphore(0)
    renderer = CallbackRenderer()
    t0 = time.perf_counter()
    for k in range(frames):
        scene.set_camera(cams[k])
        renderer.begin_render(bufs[k], rgb8, scene, lambda r: done.release())
    for _ in range(frames):
        assert done.acquire(timeout=300), "CallbackRenderer stalled"
    ms = (time.perf_counter() - t0) * 1e3 / frames
    same = sum(bytes(b) == x for b, x in zip(bufs, want))
    print(json.dumps(dict(
        phase="CallbackRenderer pipelined orbit, 120-cell",
        resolution=f"{w}x{h}", frames=frames, pipelined_frame_ms=ms,
        frames_equal_to_blocking=same)), flush=True)
    return same == frames


def _walk_vs_scan(w, h):
    """The flagship's primary rays, traced by the walk and by the scan."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import frame_parity as fp
    import scenes
    from ntracer_tpu.engine import walk, wavefront

    nt, scene, cam, dist = scenes.cell120()
    cfg, dev, _ = wavefront.get_device_scene(scene)
    d = cfg.d
    lay = wavefront._walk_dict(dev)
    scan_dev = {k: v for k, v in dev.items() if not k.startswith("walk_")}
    scene._set_view_size(w, h)
    fov = wavefront._fov_params(w, h, scene.fov)
    R = w * h
    xs, ys, _ = wavefront._ray_coords(jnp.int32(0), w, R)
    cam_o = jnp.asarray(scene._cam._origin)
    o, dirs = wavefront.make_rays(cam_o, jnp.asarray(scene._cam._t), *fov,
                                  xs, ys)
    skip = jnp.full((R,), -1, jnp.int32)

    @jax.jit
    def by_walk(o, dirs):
        pctx = wavefront.primary_ctx(dev, cfg, cam_o)
        t, slot, _ = walk.nearest_hit(lay, o, dirs, skip, d,
                                      order=pctx["order"], dmin=pctx["dmin"],
                                      sh=pctx["sh"])
        gid = lay["slot_pack"][jnp.clip(slot, 0, None), d + 1]
        return (jnp.where(slot >= 0, t, wavefront.REAL_MAX),
                jnp.where(slot >= 0, gid.astype(jnp.int32), -1))

    group = R // 4      # the frame path's group size at 1024x1024

    @jax.jit
    def by_scan(o, dirs, skip):
        res = wavefront.trace_pool(scan_dev, cfg, o, dirs, skip)
        return res["t"], res["pid"]

    def scan_all():
        parts = [by_scan(o[s:s + group], dirs[s:s + group],
                         skip[s:s + group]) for s in range(0, R, group)]
        return tuple(jnp.concatenate(p) for p in zip(*parts))

    ms, out = {}, {}
    for label, fn in (("walk", lambda: by_walk(o, dirs)), ("scan", scan_all)):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        out[label] = [np.asarray(x) for x in jax.block_until_ready(fn())]
        ms[label] = (time.perf_counter() - t0) * 1e3
    (wt, wpid), (st, spid) = out["walk"], out["scan"]
    hit = (st < wavefront.REAL_MAX) | (wt < wavefront.REAL_MAX)
    t_off = hit & ~np.isclose(wt, st, rtol=T_RTOL, atol=0)
    id_off = (wpid != spid) & ~t_off
    bad = np.nonzero(t_off | id_off)[0]
    on, dn = np.asarray(o), np.asarray(dirs)
    classes = {}
    for r in bad:
        v = fp.classify_trace(scene, on[r], dn[r])
        classes[v] = classes.get(v, 0) + 1
    row = dict(phase="walk vs scan, flagship primary rays", rays=R,
               walk_ms=ms["walk"], scan_ms=ms["scan"],
               hits=int(hit.sum()), t_differs=int(t_off.sum()),
               id_differs_equal_t=int(id_off.sum()), classes=classes,
               unclassified=classes.get("genuine", 0),
               peak_device_bytes=_peak_bytes())
    print(json.dumps(row), flush=True)
    return row["unclassified"] == 0


def _cell120_lit():
    """The flagship with a white point light at +5 on axis 1 and shadows
    on: shadow rays leave a closed polytope surface, next to the faces
    that share its edges."""
    import scenes
    nt, scene, cam, dist = scenes.cell120()
    scene.add_light(nt.PointLight(nt.Vector.axis(1, 5), (1, 1, 1)))
    scene.set_shadows(True)
    return nt, scene, cam, dist


def _anyhit_walk_vs_scan(build, w, h):
    """Every shadow ray one frame of ``build``'s scene casts (each light,
    each bounce), exactly as the frame program makes them: the any-hit
    answer of the walk (``walk.occluded``, what the frame runs) against
    the XLA scan's (``wavefront.occlusion`` without walk layouts) on the
    same rays.  ``wavefront.occlusion`` is wrapped while the frame's
    ``ray_colors`` is traced, so each query also runs on the scan and
    both answers come back beside the ray."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import frame_parity as fp
    from ntracer_tpu.engine import wavefront

    nt, scene, cam, dist = build()
    cfg, dev, _ = wavefront.get_device_scene(scene)
    assert wavefront._walk_ok(dev) and cfg.shadows
    scan_dev = {k: v for k, v in dev.items() if not k.startswith("walk_")}
    fa = wavefront._frame_args(scene, w, h)
    count = min(w * h, 8 * wavefront.TILE)   # a 1024x1024 slab's group
    queries = []
    occlusion = wavefront.occlusion

    def both(arrs, cfg, o, dirs, ldist, skip, stats=None, clamp_exit=True):
        out = occlusion(arrs, cfg, o, dirs, ldist, skip, stats=stats,
                        clamp_exit=clamp_exit)
        scan, _ = occlusion(scan_dev, cfg, o, dirs, ldist, skip)
        queries.append((o, dirs, ldist, skip, out[0], scan))
        return out

    @jax.jit
    def group(start):
        queries.clear()
        xs, ys, _ = wavefront._ray_coords(start, w, count)
        o, dirs = wavefront.make_rays(fa["cam"][0], fa["cam"][1],
                                      *fa["fov"], xs, ys)
        wavefront.ray_colors(dev, cfg, fa["dyn"], o, dirs)
        return list(queries)

    wavefront.occlusion = both
    try:
        outs = [jax.device_get(group(jnp.int32(s)))
                for s in range(0, w * h, count)]
    finally:
        wavefront.occlusion = occlusion
    n_rays = n_diff = 0
    classes = {}
    for out in outs:
        for o, dirs, ldist, skip, walk_blk, scan_blk in out:
            live = ldist > 0
            n_rays += int(live.sum())
            for r in np.nonzero(live & (walk_blk != scan_blk))[0]:
                n_diff += 1
                v = fp.classify_occlusion(scene, o[r], dirs[r], ldist[r],
                                          skip[r])
                classes[v] = classes.get(v, 0) + 1
    row = dict(phase="walk vs scan any-hit, every shadow ray of a frame",
               scene=build.__name__, resolution=f"{w}x{h}",
               queries=sum(len(out) for out in outs) // len(outs),
               shadow_rays=n_rays, blocked_differs=n_diff, classes=classes,
               unclassified=classes.get("genuine", 0),
               peak_device_bytes=_peak_bytes())
    print(json.dumps(row), flush=True)
    return n_rays > 0 and row["unclassified"] == 0


def _one_card():
    import scenes

    ok = True
    for name, build, w, h in (
            ("120-cell {5,3,3} (polytope.py 5 3 3 --benchmark)",
             scenes.cell120, 1024, 1024),
            ("6-D lit + shadows", scenes.lit6, 1024, 1024),
            ("3-D reflective + shadows", scenes.reflective3, 1024, 1024),
            ("100k-triangle sphere mesh", scenes.mesh100k, 1024, 1024),
            ("3-D transparent + shadows", scenes.transparent3, 1024, 1024),
            ("10-D BoxScene", scenes.box10, 1920, 1080)):
        ok &= _frame_phase(name, build, w, h, samples=64)
    ok &= _callback_orbit(scenes.cell120, 1024, 1024)
    ok &= _walk_vs_scan(1024, 1024)
    ok &= _anyhit_walk_vs_scan(scenes.reflective3, 1024, 1024)
    ok &= _anyhit_walk_vs_scan(_cell120_lit, 1024, 1024)
    return ok


def _multi(flag_size=2048, mesh_size=1024, mesh_tris=100000):
    import jax
    import numpy as np
    import frame_parity as fp
    import scenes
    from ntracer_tpu.engine import wavefront
    from ntracer_tpu.parallel import mesh as pmesh

    assert len(jax.devices()) == 4, jax.devices()
    ok = True

    # flagship, pixels sharded over the four cards (the default renderer)
    w = h = flag_size
    nt, scene, cam, dist = scenes.cell120()
    rgb8, _ = _formats(w, h)
    t0 = time.perf_counter()
    multi = np.frombuffer(bytes(_render(scene, rgb8)), np.uint8)
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(ORBIT_FRAMES):
        t0 = time.perf_counter()
        multi = np.frombuffer(bytes(_render(scene, rgb8)), np.uint8)
        warm.append((time.perf_counter() - t0) * 1e3)
    single = np.asarray(wavefront.frame_device_arrays(scene, rgb8))
    single = np.ascontiguousarray(single).view(np.uint8).reshape(-1)
    single = single[:multi.size]
    diff = int((single.reshape(-1, 3) != multi.reshape(-1, 3))
               .any(axis=1).sum())
    print(json.dumps(dict(
        phase="flagship px-sharded over 4 cards vs 1 card",
        resolution=f"{w}x{h}", cold_frame_s=cold, warm_frame_ms=warm,
        pixels_differing=diff, bytes_identical=diff == 0,
        peak_device_bytes=_peak_bytes())), flush=True)
    ok &= diff == 0

    # 100k mesh on a 2x2 px x prim mesh vs one card
    w = h = mesh_size
    nt, scene, cam, dist = scenes.mesh100k(mesh_tris)

    class Fmt:
        width, height = w, h

    m = pmesh.make_mesh(2, 2)
    sharded = pmesh.render_frame(scene, Fmt, m)
    warm = []
    for _ in range(ORBIT_FRAMES):
        t0 = time.perf_counter()
        sharded = pmesh.render_frame(scene, Fmt, m)
        warm.append((time.perf_counter() - t0) * 1e3)
    single = wavefront.render_strip_composite(scene, Fmt, 0, h)
    err = np.abs(sharded - single).max(axis=2)
    off = np.argwhere(err > COLOR_TOL)
    classes = {}
    for y, x in off:
        v = fp.classify_pixel(scene, int(x), int(y), w, h)
        classes[v] = classes.get(v, 0) + 1
    print(json.dumps(dict(
        phase="100k mesh on a 2x2 px x prim mesh vs 1 card",
        resolution=f"{w}x{h}", warm_frame_ms=warm,
        max_abs_diff=float(err.max()), pixels_over_tol=int(len(off)),
        classes=classes, unclassified=classes.get("genuine", 0),
        peak_device_bytes=_peak_bytes())), flush=True)
    ok &= classes.get("genuine", 0) == 0
    return ok


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args()
    if not args.multi:
        # the single-card phases stay on one card even on a larger host
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))

    import jax
    if jax.default_backend() != "gpu":
        sys.exit("chip_smoke.py needs an NVIDIA GPU; JAX found "
                 f"{jax.default_backend()!r}")
    import ntracer  # noqa: F401  (fails outside a checkout of the repo)

    print(_card(), flush=True)
    print(f"jax {jax.__version__}", flush=True)
    ok = _multi() if args.multi else _one_card()
    if not ok:
        sys.exit("chip_smoke.py: a phase failed (see above)")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
