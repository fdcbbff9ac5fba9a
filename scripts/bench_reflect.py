#!/usr/bin/env python
"""Reflective+shadowed scene benchmark + bounce-occupancy counters.

The reflective + shadowed scene (1000 random d=3 simplices, reflectivity
0.4, point light + shadows, 1024^2) with per-depth instrumentation: live
rays vs live walk blocks, so the secondary-ray occupancy question is
answered with data (a block with one live ray pays the full walk;
rays/block << RAY_BLOCK would argue for compacting continuations).

    python scripts/bench_reflect.py [--size 1024] [--rounds 4]

Prints one JSON line.  Counters are window-independent; the ms/frame is
min-of-rounds on whatever backend is active.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))



def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    from ntracer_tpu.engine import wavefront
    from ntracer_tpu.engine.walk import RAY_BLOCK

    import scenes
    _, scene, _, _ = scenes.reflective3()
    W = H = args.size

    # ---- counters (exact, window-independent) ----
    st = wavefront.frame_stats(scene, W, H)
    occ = {}
    total_rays = W * H
    bounce_rays = 0
    for d in range(1, 16):
        rk, bk = f"bounce_live_rays_d{d}", f"bounce_live_blocks_d{d}"
        if rk not in st:
            break
        bounce_rays += st[rk]
        occ[f"d{d}_rays"] = st[rk]
        if bk not in st:        # the XLA scan has no walk blocks
            continue
        occ[f"d{d}_blocks"] = st[bk]
        occ[f"d{d}_occupancy"] = round(st[rk] / max(st[bk] * RAY_BLOCK, 1), 4)
        # blocks a perfect cross-block compaction would dispatch instead
        occ[f"d{d}_blocks_compacted"] = -(-st[rk] // RAY_BLOCK)

    # ---- on-device frame time, min of interleaved rounds ----
    from ntracer import ImageFormat, Channel
    fmt = ImageFormat(W, H, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    best = min(scenes.device_frame_ms(scene, fmt, 1)
               for _ in range(args.rounds)) / 1e3

    traced = st.get("rays_traced", 0)
    shadow = st.get("shadow_rays", 0)
    out = {
        "scene": "reflective+shadowed d=3 n=1000",
        "size": args.size,
        "on_device_ms": round(best * 1000, 2),
        "rays_primary": total_rays,
        "rays_traced": traced,
        "shadow_rays": shadow,
        "mrays_s_all_types": round((traced + shadow) / best / 1e6, 2),
        "chunks_visited": st.get("chunks_visited", 0),
        "occl_chunks_visited": st.get("occl_chunks_visited", 0),
        **occ,
    }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
