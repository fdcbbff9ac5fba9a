#!/usr/bin/env python
"""Walk kernel vs the XLA chunk scan on the GPU: trace only, same rays.

For each scene, the primary rays of a 1024x1024 frame (in the frame
path's tiled ray order) are traced by both implementations: nearest hit,
front-to-back for the walk.  Then shadow rays from the hit points toward
a point light (any hit).  Prints, per scene and per walk block shape, the
device time of each trace (``block_until_ready``, best of ``--reps``) and
how far the two results agree.  ``--profile`` also traces one scan call
with ``jax.profiler`` and prints the most frequent device events (shows
whether the scan's per-chunk ``lax.cond`` round-trips through the host).

``--e2e`` instead renders whole frames through the public renderer, once
with the walk (the program's own choice on the GPU) and once with the
scan (``walk.trace_impl`` replaced here, in this script, before the
scene's device arrays are built), interleaved walk, scan, scan, walk:
caller-side frame time (``BlockingRenderer``) and on-device frame time
(the renderer's dispatches queued, ``block_until_ready``).  Its default
scenes add the reflective scene, whose bounce and shadow rays are most of
its any-hit work.

    python scripts/walk_bench.py [--scenes cell120,lit6,mesh100k]
                                 [--blocks 32x4,64x4,128x4] [--reps 5]
    python scripts/walk_bench.py --e2e [--scenes cell120,lit6,mesh100k,reflective3]
                                 [--frames 3]
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402


TRACE_SCENES = "cell120,lit6,mesh100k"
E2E_SCENES = TRACE_SCENES + ",reflective3"


def _block(out):
    import jax
    for leaf in jax.tree_util.tree_leaves(out):
        leaf.block_until_ready()


def _timed(fn, reps):
    """(result, best seconds of ``reps`` warm calls; None when 0)."""
    out = fn()
    _block(out)
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _block(out)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return out, best


def _ms(sec):
    return None if sec is None else round(sec * 1e3, 3)


def _profile_events(fn, out_dir):
    """Device-plane event names of one traced call, most frequent first."""
    import glob
    import jax
    _block(fn())
    jax.profiler.start_trace(out_dir)
    _block(fn())
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(out_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    counts = collections.Counter()
    for plane in pd.planes:
        if "gpu" not in plane.name.lower():
            continue
        for line in plane.lines:
            for ev in line.events:
                counts[(line.name, ev.name[:60])] += 1
    return counts.most_common(12)


def _e2e(names, size, frames):
    """Whole frames with the walk vs the scan, per scene."""
    import jax
    import numpy as np
    import scenes
    from ntracer import ImageFormat, Channel, BlockingRenderer
    from ntracer_tpu.engine import walk, wavefront

    fmt = ImageFormat(size, size, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                                   Channel(8, 0, 0, 1)])
    choose = walk.trace_impl
    for name in names:
        built = {}
        for impl in ("walk", "scan"):
            walk.trace_impl = (choose if impl == "walk"
                               else (lambda *a: "scan"))
            nt, scene, cam, dist = getattr(scenes, name)()
            cfg, dev, _ = wavefront.get_device_scene(scene)
            assert wavefront._walk_ok(dev) == (impl == "walk")
            built[impl] = scene
        walk.trace_impl = choose
        buf = bytearray(fmt.pitch * fmt.height)
        times = {k: {"frame_ms": [], "on_device_ms": []} for k in built}
        for impl in ("walk", "scan"):          # compile both first
            BlockingRenderer().render(buf, fmt, built[impl])
        for impl in ("walk", "scan", "scan", "walk"):
            scene = built[impl]
            for _ in range(frames):
                t0 = time.perf_counter()
                BlockingRenderer().render(buf, fmt, scene)
                times[impl]["frame_ms"].append(
                    (time.perf_counter() - t0) * 1e3)
            times[impl]["on_device_ms"].append(
                scenes.device_frame_ms(scene, fmt, frames))
        row = {"scene": name, "size": size, "frames_per_turn": frames}
        for impl, t in times.items():
            row[impl] = {"frame_ms_median": float(np.median(t["frame_ms"])),
                         "frame_ms": t["frame_ms"],
                         "on_device_ms": t["on_device_ms"]}
        row["peak_bytes"] = (jax.devices()[0].memory_stats()
                             or {}).get("peak_bytes_in_use")
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", default=None,
                    help="default: cell120,lit6,mesh100k "
                         "(with --e2e: and reflective3)")
    ap.add_argument("--blocks", default="32x4,64x4,128x4")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import scenes
    from ntracer_tpu.engine import wavefront, chunks, walk

    if jax.default_backend() != "gpu":
        sys.exit("walk_bench.py measures the GPU; no GPU found")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    if args.e2e:
        return _e2e((args.scenes or E2E_SCENES).split(","), args.size,
                    args.frames)
    args.scenes = args.scenes or TRACE_SCENES

    W = H = args.size
    R = W * H
    group = 262144       # rays per dispatch of the frame path (one slab)
    for name in args.scenes.split(","):
        nt, scene, cam, _dist = getattr(scenes, name)()
        cfg, dev, flat = wavefront.get_device_scene(scene)
        scan_dev = {k: v for k, v in dev.items()
                    if not k.startswith("walk_")}
        a = flat.arrays
        d = cfg.d
        fn_norm = np.linalg.norm(a["tri_fn"], axis=1)
        fov = wavefront._fov_params(W, H, scene.fov)
        scene._set_view_size(W, H)
        cam_o = jnp.asarray(scene._cam._origin)
        cam_t = jnp.asarray(scene._cam._t)
        skip = jnp.full((R,), -1, jnp.int32)

        def grouped(fn, *xs):
            outs = [fn(*(x[s:s + group] for x in xs))
                    for s in range(0, R, group)]
            return jax.tree_util.tree_map(lambda *p: jnp.concatenate(p),
                                          *outs)

        def scan_nearest(o, dirs, skip):
            res = wavefront.trace_pool(scan_dev, cfg, o, dirs, skip)
            return res["t"], res["pid"]

        def scan_occ(o, dirs, ldist, skip):
            return wavefront.occlusion(scan_dev, cfg, o, dirs, ldist,
                                       skip)[0]

        scan_nearest = jax.jit(scan_nearest)
        scan_occ = jax.jit(scan_occ)
        bins = chunks.centroid_bins(a["cull_lo"], a["cull_hi"], fn_norm)

        for bi, blk in enumerate(args.blocks.split(",")):
            # the scan's time does not depend on the ray order: time it
            # once per scene, and only compare results for later blocks
            scan_reps = args.reps if bi == 0 else 0
            rb, nw = (int(v) for v in blk.split("x"))
            walk.RAY_BLOCK, walk.NUM_WARPS = rb, nw
            wavefront.TILE_W = 8
            wavefront.TILE_H = rb // wavefront.TILE_W
            walk.nearest_hit.clear_cache()
            walk.occluded.clear_cache()
            xs, ys, _ = wavefront._ray_coords(jnp.int32(0), W, R)
            o, dirs = jax.jit(wavefront.make_rays)(cam_o, cam_t, *fov, xs,
                                                   ys)
            (st, spid), scan_s = _timed(
                lambda: grouped(scan_nearest, o, dirs, skip), scan_reps)
            st, spid = np.asarray(st), np.asarray(spid)
            hit = spid >= 0
            # shadow rays toward a point light above the scene
            light = np.zeros(d, np.float32)
            light[1] = 5.0
            pts = np.asarray(o) + np.where(hit, st, 0)[:, None] \
                * np.asarray(dirs)
            lv = light[None, :] - pts
            ld = np.linalg.norm(lv, axis=1).astype(np.float32)
            lv = (lv / ld[:, None]).astype(np.float32)
            ld = np.where(hit, ld, 0).astype(np.float32)
            so, sd, sl, ss = map(jnp.asarray, (pts.astype(np.float32), lv,
                                               ld, np.where(hit, spid, -1)))
            socc, scan_occ_s = _timed(
                lambda: grouped(scan_occ, so, sd, sl, ss), scan_reps)
            socc = np.asarray(socc)

            lay = chunks.prepare_cells(bins, a["tri_p1"], a["tri_fn"],
                                       a["tri_en"], a["tri_dc"],
                                       a["cull_lo"], a["cull_hi"], d,
                                       a["tri_mat"])
            lay = {k: jnp.asarray(v) for k, v in lay.items()}

            @jax.jit
            def walk_nearest(o, dirs, skip, origin):
                order, dmin = chunks.chunk_order(lay["klo"], lay["khi"],
                                                 origin)
                sh = chunks.shared_rows(lay["gt"], lay["ci"], origin, d)
                t, slot, vis = walk.nearest_hit(lay, o, dirs, skip, d,
                                                order=order, dmin=dmin,
                                                sh=sh)
                gid = lay["slot_pack"][jnp.clip(slot, 0, None), d + 1]
                return (jnp.where(slot >= 0, t, jnp.float32(3.4e38)),
                        jnp.where(slot >= 0, gid.astype(jnp.int32), -1),
                        jnp.sum(vis)[None])

            @jax.jit
            def walk_occ(o, dirs, ldist, skip):
                return walk.occluded(lay, o, dirs, ldist, skip, d)

            t0 = time.perf_counter()
            _block(walk_nearest(o[:group], dirs[:group], skip[:group],
                                cam_o))
            compile_s = time.perf_counter() - t0
            (wt, wpid, wvis), walk_s = _timed(
                lambda: grouped(lambda *x: walk_nearest(*x, cam_o), o, dirs,
                                skip), args.reps)
            (wocc, ovis), walk_occ_s = _timed(
                lambda: grouped(walk_occ, so, sd, sl, ss), args.reps)
            wt, wpid, wocc = np.asarray(wt), np.asarray(wpid), \
                np.asarray(wocc)
            both = hit & (wpid >= 0)
            rel = np.abs(wt - st)[both] / np.maximum(st[both], 1e-30)
            print(json.dumps({
                "scene": name, "d": d, "n_tris": cfg.n_tris,
                "chunks": int(lay["gt"].shape[0]), "ck": chunks.CK,
                "ray_block": rb, "num_warps": nw,
                "tile": [wavefront.TILE_W, wavefront.TILE_H],
                "scan_nearest_ms": _ms(scan_s),
                "walk_nearest_ms": _ms(walk_s),
                "scan_anyhit_ms": _ms(scan_occ_s),
                "walk_anyhit_ms": _ms(walk_occ_s),
                "walk_compile_s": round(compile_s, 1),
                "hits": int(hit.sum()),
                "hit_mismatch": int((hit != (wpid >= 0)).sum()),
                "id_mismatch": int((spid != wpid).sum()),
                "t_mismatch_1e-5": int((rel > 1e-5).sum()),
                "t_max_rel": float(rel.max()) if rel.size else 0.0,
                "shadow_rays": int((ld > 0).sum()),
                "anyhit_mismatch": int((socc != wocc).sum()),
                "walk_chunk_visits": int(np.asarray(wvis).sum()),
                "walk_anyhit_visits": int(np.asarray(ovis).sum()),
                "peak_bytes": (jax.devices()[0].memory_stats()
                               or {}).get("peak_bytes_in_use"),
            }), flush=True)

        if args.profile:
            out_dir = os.path.join("chiprun_out", f"scan_profile_{name}")
            for (line, ev), n in _profile_events(
                    lambda: scan_nearest(o[:group], dirs[:group],
                                         skip[:group]), out_dir):
                print(json.dumps({"scene": name, "scan_profile_line": line,
                                  "event": ev, "count": n}), flush=True)


if __name__ == "__main__":
    main()
