#!/usr/bin/env python
"""Run the five benchmark configs and print one JSON line per config.

Works against either implementation:
    python scripts/bench_suite.py            # ntracer_tpu (GPU)
    PYTHONPATH=<reference build> python scripts/bench_suite.py --reference
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--reference", action="store_true",
                    help="drop the repo paths so the reference package loads")
parser.add_argument("--frames", type=int, default=8)
args = parser.parse_args()

if args.reference:
    sys.path = [p for p in sys.path if "repo" not in p]

import numpy as np  # noqa: E402
from ntracer import (NTracer, Material, ImageFormat, Channel,  # noqa: E402
                     BlockingRenderer)


def rgb_format(w, h):
    return ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                              Channel(8, 0, 0, 1)])


def rotating(nt, scene, camera, cam_distance, frames, fmt, buf, renderer):
    incr = 2 * math.pi / frames
    h = 1 / math.sqrt(nt.dimension - 1)
    total = 0.0
    for _ in range(frames):
        t0 = time.perf_counter()
        renderer.render(buf, fmt, scene)
        total += time.perf_counter() - t0
        a2 = camera.axes[0] * h + camera.axes[1] * h
        for i in range(nt.dimension - 3):
            a2 = a2 + camera.axes[i + 3] * h
        camera.transform(nt.Matrix.rotation(camera.axes[2], a2, incr))
        camera.normalize()
        camera.origin = camera.axes[2] * cam_distance
        scene.set_camera(camera)
    return total / frames


def pipelined_sec(nt, scene, camera, cam_distance, frames, fmt):
    """Cross-frame pipelining: dispatch frame N+1's compute before pulling
    frame N's bytes, so device compute overlaps the host-link transfer
    The reference's CallbackRenderer gets the same
    overlap from its worker threads."""
    if args.reference:
        return None
    import time as _t
    import numpy as np
    from ntracer_tpu.engine import wavefront

    incr = 2 * math.pi / frames
    hh = 1 / math.sqrt(nt.dimension - 1)

    def advance():
        a2 = camera.axes[0] * hh + camera.axes[1] * hh
        for i in range(nt.dimension - 3):
            a2 = a2 + camera.axes[i + 3] * hh
        camera.transform(nt.Matrix.rotation(camera.axes[2], a2, incr))
        camera.normalize()
        camera.origin = camera.axes[2] * cam_distance
        scene.set_camera(camera)

    out = np.empty((fmt.width * fmt.height * fmt.bytes_per_pixel,), np.uint8)
    dev = wavefront.frame_device_arrays(scene, fmt)  # warm/compile
    np.asarray(dev)
    t0 = _t.perf_counter()
    prev = None
    for _ in range(frames):
        dev = wavefront.frame_device_arrays(scene, fmt)   # dispatch N
        if prev is not None:
            data = np.asarray(prev)                       # pull N-1
            if data.dtype == np.uint32:   # dense packed stream (round 4)
                data = np.ascontiguousarray(data).view(np.uint8)
            out[:] = data.reshape(-1)[: out.size]
        prev = dev
        advance()
    data = np.asarray(prev)
    sec = (_t.perf_counter() - t0) / frames
    return sec


def on_device_sec(scene, fmt, frames):
    """Compute-only frame time: queue the renderer's dispatches, then wait
    on all of them (``block_until_ready``)."""
    if args.reference:
        return None
    import scenes
    return scenes.device_frame_ms(scene, fmt, frames) / 1e3


def box_config(d, w, h, frames):
    nt = NTracer(d)
    scene = nt.BoxScene()
    camera = nt.Camera()
    cam_distance = -math.sqrt(d) * 1.2
    camera.translate(nt.Vector.axis(2, cam_distance))
    scene.set_camera(camera)
    fmt = rgb_format(w, h)
    buf = bytearray(fmt.pitch * fmt.height)
    r = BlockingRenderer()
    r.render(buf, fmt, scene)  # warmup / compile
    sec = rotating(nt, scene, camera, cam_distance, frames, fmt, buf, r)
    dev = on_device_sec(scene, fmt, frames)
    pipe = pipelined_sec(nt, scene, camera, cam_distance, frames, fmt)
    return sec, dev, None, pipe


def report(name, w, h, sec, dev_sec=None, counters=None, pipe_sec=None):
    row = {
        "config": name,
        "ms_per_frame": round(sec * 1000, 2),
        "mrays_per_s": round(w * h / sec / 1e6, 3),
    }
    if dev_sec:
        row["on_device_ms"] = round(dev_sec * 1000, 2)
        row["on_device_mrays"] = round(w * h / dev_sec / 1e6, 3)
    if pipe_sec:
        row["pipelined_ms"] = round(pipe_sec * 1000, 2)
        row["pipelined_mrays"] = round(w * h / pipe_sec / 1e6, 3)
    if counters:
        row["counters"] = counters
    print(json.dumps(row), flush=True)


F = args.frames

# 1: 3-D cube, 320x240
report("3D cube 320x240", 320, 240, *box_config(3, 320, 240, F))

# 2: 4-D tesseract, 640x480 rotating animation
report("4D tesseract 640x480", 640, 480, *box_config(4, 640, 480, F))

# 3: 120-cell {5,3,3} @ 1024^2 (geometry differs per implementation's
#    own builder — both are ~3240 simplices)
if args.reference:
    t0 = time.perf_counter()
    os.system(
        f"cd /tmp/refbuild && SDL_VIDEODRIVER=dummy "
        f"PYTHONPATH={':'.join(sys.path)} python scripts/polytope.py 5 3 3 "
        f"--benchmark -s 1024x1024 -f {F}")
else:
    from polytope import polytope_vertices, hull_prototypes
    nt = NTracer(4)
    protos = hull_prototypes(nt, polytope_vertices([5, 3, 3]),
                             Material((1, 0.5, 0.5)))
    scene = nt.build_composite_scene(protos)
    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, -4.0))
    scene.set_camera(camera)
    fmt = rgb_format(1024, 1024)
    buf = bytearray(fmt.pitch * fmt.height)
    r = BlockingRenderer()
    r.render(buf, fmt, scene)
    sec = rotating(nt, scene, camera, -4.0, F, fmt, buf, r)
    from ntracer_tpu.engine import wavefront
    report("120-cell 4D 1024x1024", 1024, 1024, sec,
           on_device_sec(scene, fmt, F),
           wavefront.frame_stats(scene, 1024, 1024),
           pipelined_sec(nt, scene, camera, -4.0, F, fmt))

# 4: 6-D hypercube slice @ 1024^2
report("6D hypercube 1024x1024", 1024, 1024, *box_config(6, 1024, 1024, F))

# 4b: 6-D LIT scene — point lights + a directional light with shadows ON
# (the box configs are analytic and never exercise the occlusion
# queries).  Same RNG geometry under both
# implementations, built through each package's own builder.
def lit_config(d, w, h, frames, n=900, seed=3):
    nt = NTracer(d)
    mat = Material((0.9, 0.6, 0.3))
    rng = np.random.RandomState(seed)
    protos = []
    for _ in range(n):
        base = rng.uniform(-2, 2, d)
        pts = [nt.Vector(*(base + rng.uniform(-0.7, 0.7, d)))
               for _ in range(d)]
        protos.append(nt.TrianglePrototype(pts, mat))
    scene = nt.build_composite_scene(protos)
    camera = nt.Camera()
    cam_distance = -8.0
    camera.translate(nt.Vector.axis(2, cam_distance))
    scene.set_camera(camera)
    scene.add_light(nt.PointLight(nt.Vector.axis(1, 5), (1, 0.9, 0.7)))
    scene.add_light(nt.PointLight(nt.Vector.axis(0, -5), (0.4, 0.5, 0.9)))
    scene.add_light(nt.GlobalLight(nt.Vector.axis(1, -1), (0.2, 0.2, 0.3)))
    scene.set_shadows(True)
    fmt = rgb_format(w, h)
    buf = bytearray(fmt.pitch * fmt.height)
    r = BlockingRenderer()
    r.render(buf, fmt, scene)  # warmup / compile
    sec = rotating(nt, scene, camera, cam_distance, frames, fmt, buf, r)
    dev = on_device_sec(scene, fmt, frames)
    counters = None
    if not args.reference:
        from ntracer_tpu.engine import wavefront
        counters = wavefront.frame_stats(scene, w, h)
    pipe = pipelined_sec(nt, scene, camera, cam_distance, frames, fmt)
    return sec, dev, counters, pipe

report("6D lit+shadows 1024x1024", 1024, 1024,
       *lit_config(6, 1024, 1024, max(F // 2, 2)))

# 5: 10-D hypercube @ 1920x1080 (generic var-dimension path)
report("10D hypercube 1920x1080", 1920, 1080,
       *box_config(10, 1920, 1080, max(F // 2, 2)))
