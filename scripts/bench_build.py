#!/usr/bin/env python
"""Scene-build benchmark: prototypes + k-d build wall time for a
sphere_mesh(N) workload (the 300k-triangle scene build; reference
counterpart: tracer.hpp:2131-2354 build path driven
through build_composite_scene).

Works against either implementation:
    python scripts/bench_build.py [--tris 300000] [--rounds 2]
    PYTHONPATH=<reference build> python scripts/bench_build.py --reference

For our package, each round measures BOTH prototype paths interleaved
(window drift on this host is 2-3x across sessions — only same-window
ratios are meaningful):
  lazy — batch_from_points' TrianglePrototypeSequence (the default;
         the build pipeline consumes the shared arrays, objects are
         never created)
  list — list(batch_from_points(...)) (the materialized object path)
The reference has no batch constructor, so --reference times its
per-object TrianglePrototype ctor loop (that IS its load path).

Prints one JSON line per (round, variant).
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--reference", action="store_true",
                    help="drop the repo paths so the reference package loads")
parser.add_argument("--tris", type=int, default=300000)
parser.add_argument("--rounds", type=int, default=2)
args = parser.parse_args()

if args.reference:
    sys.path = [p for p in sys.path if "repo" not in p]

import numpy as np  # noqa: E402
from ntracer import NTracer, Material  # noqa: E402


def sphere_mesh(n_target):
    """Lat/long tessellated unit sphere (same mesh as bench_mesh.py)."""
    rows = max(4, int(math.sqrt(n_target / 4)))
    cols = 2 * rows
    th = np.linspace(0, math.pi, rows + 1)
    ph = np.linspace(0, 2 * math.pi, cols + 1)
    v = np.empty((rows + 1, cols + 1, 3), np.float32)
    v[..., 0] = np.sin(th)[:, None] * np.cos(ph)[None, :]
    v[..., 1] = np.sin(th)[:, None] * np.sin(ph)[None, :]
    v[..., 2] = np.cos(th)[:, None]
    tris = []
    for i in range(rows):
        for j in range(cols):
            a, b, c, d = v[i, j], v[i + 1, j], v[i + 1, j + 1], v[i, j + 1]
            if i:
                tris.append((a, b, c))
            if i != rows - 1:
                tris.append((a, c, d))
    tris = np.asarray(tris, np.float32)
    area = np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0],
                                   tris[:, 2] - tris[:, 0]), axis=1)
    return tris[area > 1e-10]


def measure(nt, mat, tris, variant):
    t0 = time.perf_counter()
    if variant == "reference":
        protos = [nt.TrianglePrototype([nt.Vector(*p) for p in t], mat)
                  for t in tris]
    else:
        from ntracer_tpu.primitives import TrianglePrototype
        protos = TrianglePrototype.batch_from_points(tris, mat)
        if variant == "list":
            protos = list(protos)
    t1 = time.perf_counter()
    scene = nt.build_composite_scene(protos)
    t2 = time.perf_counter()
    del scene
    return dict(variant=variant, prototypes_s=round(t1 - t0, 3),
                kd_build_s=round(t2 - t1, 3), total_s=round(t2 - t0, 3))


def main():
    nt = NTracer(3)
    mat = Material((1, 0.6, 0.4))
    tris = sphere_mesh(args.tris)
    variants = (["reference"] if args.reference else ["lazy", "list"])
    for r in range(args.rounds):
        for variant in variants:
            rec = measure(nt, mat, tris, variant)
            rec.update(round=r, tris=int(len(tris)))
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
