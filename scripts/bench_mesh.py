#!/usr/bin/env python
"""Large-mesh benchmark: a tessellated sphere of N triangles (the OBJ-scale
workload), rotating camera.  Prints one JSON line with e2e / on-device /
pipelined frame times.

    python scripts/bench_mesh.py [--tris 100000] [--size 1024x1024]
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from scenes import device_frame_ms, sphere_mesh  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tris", type=int, default=100000)
    ap.add_argument("--size", default="1024x1024")
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args()
    w, _, h = args.size.partition("x")
    w, h = int(w), int(h)

    from ntracer import (NTracer, Material, ImageFormat, Channel,
                         BlockingRenderer)
    import jax
    from ntracer_tpu.engine import walk, wavefront

    nt = NTracer(3)
    mat = Material((1, 0.6, 0.4))
    tris = sphere_mesh(args.tris)
    t0 = time.perf_counter()
    from ntracer_tpu.primitives import TrianglePrototype
    protos = TrianglePrototype.batch_from_points(tris, mat)
    t_proto = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = nt.build_composite_scene(protos)
    t_build = time.perf_counter() - t0
    cam = nt.Camera()
    cam.translate(nt.Vector(0, 0, -3))
    scene.set_camera(cam)

    cfg, device, _ = wavefront.get_device_scene(scene)
    impl = walk.trace_impl(jax.default_backend(), cfg.d,
                           cfg.has_transparency)

    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    buf = bytearray(fmt.pitch * fmt.height)
    r = BlockingRenderer()
    r.render(buf, fmt, scene)  # compile

    incr = 2 * math.pi / max(args.frames, 1)

    def advance():
        cam.transform(nt.Matrix.rotation(nt.Vector.axis(0),
                                         nt.Vector.axis(2), incr))
        cam.normalize()
        scene.set_camera(cam)

    total = 0.0
    for _ in range(args.frames):
        t0 = time.perf_counter()
        r.render(buf, fmt, scene)
        total += time.perf_counter() - t0
        advance()
    sec = total / args.frames

    dev_sec = device_frame_ms(scene, fmt, args.frames, advance) / 1e3

    print(json.dumps({
        "config": f"sphere mesh {len(tris)} tris {w}x{h}",
        "trace_impl": impl,
        "proto_s": round(t_proto, 2),
        "kd_build_s": round(t_build, 2),
        "ms_per_frame": round(sec * 1000, 2),
        "on_device_ms": round(dev_sec * 1000, 2),
        "on_device_mrays": round(w * h / dev_sec / 1e6, 3),
    }))


if __name__ == "__main__":
    main()
