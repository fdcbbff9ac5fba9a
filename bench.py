#!/usr/bin/env python
"""Flagship benchmark on the GPU: the 4-D 120-cell ({5,3,3}) at 1024x1024,
rotating camera — the reference's ``polytope.py 5 3 3 --benchmark``.

    python bench.py [--fast] [--reference-build DIR]

Prints the card's name and power limit, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", ...}.

Before timing, the engine-vs-oracle gate of scripts/device_parity.py runs
in this same process (one JAX process per card) and its mismatch count is
embedded, so a device-only numerics regression fails loudly here instead
of shipping a fast wrong kernel (``--fast`` skips it).
``vs_baseline`` compares with the C++ reference measured in the same run
from a build of it (scripts/build_reference.sh) given by
``--reference-build``; without one the baseline fields are null.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

W = H = 1024
FRAMES = 8


def measure_reference(build_dir):
    """C++ reference sec/frame on the flagship config from the build in
    ``build_dir``, or None."""
    lib = os.path.join(build_dir, "build", "lib.linux-x86_64-cpython-312")
    if not os.path.isdir(lib):
        return None
    env = dict(os.environ, SDL_VIDEODRIVER="dummy", PYTHONPATH=lib)
    p = subprocess.run(
        [sys.executable, os.path.join(build_dir, "scripts", "polytope.py"),
         "5", "3", "3", "--benchmark", "-s", f"{W}x{H}", "-f", "4"],
        timeout=1800, capture_output=True, text=True, env=env, cwd=build_dir)
    for line in p.stdout.splitlines():
        if line.startswith("time per frame:"):
            return float(line.split(":")[1].split()[0])
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="skip the device parity gate")
    ap.add_argument("--reference-build",
                    help="a build of the C++ reference "
                         "(scripts/build_reference.sh) to time alongside")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        sys.exit("bench.py measures the GPU; JAX found "
                 f"{jax.default_backend()!r}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)

    parity = None
    if not args.fast:
        import device_parity
        parity = device_parity.run()
    ref_sec = (measure_reference(args.reference_build)
               if args.reference_build else None)

    from ntracer import ImageFormat, Channel, BlockingRenderer
    from ntracer_tpu.engine import walk, wavefront
    import scenes

    nt, scene, camera, cam_distance = scenes.cell120()
    fmt = ImageFormat(W, H, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    buf = bytearray(fmt.pitch * fmt.height)
    renderer = BlockingRenderer()
    incr = 2 * math.pi / FRAMES

    def advance():
        scenes.orbit(nt, scene, camera, cam_distance, incr)

    # warmup (compile)
    renderer.render(buf, fmt, scene)
    advance()

    total = 0.0
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        renderer.render(buf, fmt, scene)
        total += time.perf_counter() - t0
        advance()
    sec_per_frame = total / FRAMES

    # on-device time: the renderer's dispatches for FRAMES frames around
    # the orbit, queued, then one wait on all of them (best of 2 passes)
    dev_sec = min(scenes.device_frame_ms(scene, fmt, FRAMES, advance)
                  for _pass in range(2)) / 1e3

    # per-stage counters, one frame at an orbit position
    counters = wavefront.frame_stats(scene, W, H)
    cfg, _, _ = wavefront.get_device_scene(scene)
    dev = jax.devices()[0]

    print(json.dumps({
        "metric": "120-cell 4D @1024^2 primary rays",
        "value": round((W * H) / dev_sec / 1e6, 3),
        "unit": "Mrays/s",
        "value_note": "on-device engine throughput; e2e fields below "
                      "include the device-to-host pull",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "trace_impl": walk.trace_impl(jax.default_backend(), cfg.d,
                                      cfg.has_transparency),
        "vs_baseline": round(ref_sec / dev_sec, 3) if ref_sec else None,
        "vs_baseline_e2e": round(ref_sec / sec_per_frame, 3)
        if ref_sec else None,
        "ref_sec_per_frame": ref_sec,
        "e2e_ms_per_frame": round(sec_per_frame * 1000, 3),
        "e2e_mrays": round((W * H) / sec_per_frame / 1e6, 3),
        "on_device_ms_per_frame": round(dev_sec * 1000, 3),
        "on_device_mrays": round((W * H) / dev_sec / 1e6, 3),
        "device_parity_mismatches": None if parity is None else sum(
            r["mismatches"] for r in parity["results"]),
        "device_parity_ok": None if parity is None else parity["ok"],
        "counters": counters,
    }))


if __name__ == "__main__":
    main()
