#!/usr/bin/env python
"""The host path's two frame-level choices, measured on the GPU: the
per-frame argument cache and the 4-slab frame split.

    python scripts/host_path.py [--scene cell120] [--size 1024] [--frames 8]

For the rotating-camera frame loop of one scene it times, from the
caller's side, interleaved A, B, B, A:

  * ``BlockingRenderer`` frames with the argument cache on and off
    (``NTRACER_NO_ARGCACHE=1``, read per dispatch);
  * the default 4-slab dispatch + pull (``dispatch_packed`` /
    ``pull_packed``, later slabs compute while earlier ones cross to the
    host) against the whole frame as one dispatch and one pull
    (``frame_device_arrays``).

Prints the card's name and power limit, then one JSON line.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="cell120")
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()

    import jax
    import numpy as np
    import scenes
    from ntracer import ImageFormat, Channel, BlockingRenderer
    from ntracer_tpu.engine import wavefront

    if jax.default_backend() != "gpu":
        sys.exit("host_path.py measures the GPU; no GPU found")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)

    nt, scene, cam, dist = getattr(scenes, args.scene)()
    w = h = args.size
    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    buf = bytearray(fmt.pitch * fmt.height)
    view = memoryview(buf)
    incr = 2 * math.pi / args.frames

    def blocking():
        BlockingRenderer().render(buf, fmt, scene)

    def slabs4():
        wavefront.pull_packed(wavefront.dispatch_packed(scene, fmt), fmt,
                              view, lambda: False)

    def slab1():
        data = np.asarray(wavefront.frame_device_arrays(scene, fmt))
        data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        view[:] = data[:len(buf)].tobytes()

    def run(fn, env=None):
        if env:
            os.environ.update(env)
        try:
            t0 = time.perf_counter()
            for _ in range(args.frames):
                fn()
                scenes.orbit(nt, scene, cam, dist, incr)
            return (time.perf_counter() - t0) * 1e3 / args.frames
        finally:
            for k in env or {}:
                os.environ.pop(k)

    cases = {
        "argcache_on": (blocking, None),
        "argcache_off": (blocking, {"NTRACER_NO_ARGCACHE": "1"}),
        "slabs4": (slabs4, None),
        "slab1": (slab1, None),
    }
    for fn, env in cases.values():          # compile and warm every case
        run(fn, env)
    ms = {k: [] for k in cases}
    for a, b in (("argcache_on", "argcache_off"), ("slabs4", "slab1")):
        for k in (a, b, b, a):
            ms[k].append(run(*cases[k]))
    print(json.dumps({"scene": args.scene, "size": w,
                      "frames_per_turn": args.frames,
                      "ms_per_frame": ms,
                      "median": {k: float(np.median(v))
                                 for k, v in ms.items()}}), flush=True)


if __name__ == "__main__":
    main()
