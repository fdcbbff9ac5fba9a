#!/usr/bin/env python
"""Display or benchmark a regular polytope given its Schläfli symbol.

JAX counterpart of the reference app (reference scripts/polytope.py):
same CLI (positional Schläfli components, --benchmark, --output, --frames,
--screen, --fov, --cam-dist, --no-special) and the same rotating-camera
benchmark loop, but the geometry construction is a kaleidoscope (Coxeter
mirror) build: vertices are the orbit of an initial point under the
reflection group, and the boundary is triangulated into (d-1)-simplices with
Qhull.  Star polytopes (fractional Schläfli components, e.g. {5/2,5}) are
built via star_prototypes for d=3 and d=4.
"""

import argparse
import math
import os
import subprocess
import sys
import time
from fractions import Fraction

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from ntracer import NTracer, Material, ImageFormat, Channel, BlockingRenderer


def schlafli_component(x):
    p, _, q = x.partition("/")
    p = int(p, 10)
    if p < 3:
        raise argparse.ArgumentTypeError("a component cannot be less than 3")
    if not q:
        return Fraction(p)
    q = int(q, 10)
    if q < 1 or q >= p or math.gcd(p, q) != 1:
        raise argparse.ArgumentTypeError("invalid star component p/q")
    return Fraction(p, q)


def positive_int(x):
    x = int(x, 10)
    if x < 1:
        raise argparse.ArgumentTypeError("a positive number is required")
    return x


def screen_size(x):
    w, _, h = x.partition("x")
    w, h = int(w, 10), int(h, 10)
    if w < 1 or h < 1:
        raise argparse.ArgumentTypeError("invalid screen size")
    return w, h


def fov_type(x):
    x = float(x)
    if x <= 0 or x >= 180:
        raise argparse.ArgumentTypeError("fov must be between 0 and 180 degrees")
    return x / 180 * math.pi


# ---------------------------------------------------------------------------
# Kaleidoscope construction
# ---------------------------------------------------------------------------

def mirror_normals(symbol):
    """Unit normals of the n Coxeter mirrors for {p1,...,p_{n-1}}: the Gram
    matrix has -cos(pi/p_i) between consecutive mirrors, 0 otherwise."""
    n = len(symbol) + 1
    gram = np.eye(n)
    for i, p in enumerate(symbol):
        c = -math.cos(math.pi / float(p))
        gram[i, i + 1] = gram[i + 1, i] = c
    # build normals row by row so that normal i has zeros above position i
    normals = np.zeros((n, n))
    for i in range(n):
        for j in range(i):
            normals[i, j] = (gram[i, j]
                             - normals[i, :j] @ normals[j, :j]) / normals[j, j]
        s = 1.0 - normals[i, :i] @ normals[i, :i]
        if s <= 0:
            raise ValueError("Schläfli symbol does not describe a finite polytope")
        normals[i, i] = math.sqrt(s)
    return normals


def _initial_vertex(normals):
    """Point on all mirrors except mirror 0, normalized."""
    a = normals[1:]
    _, _, vt = np.linalg.svd(a)
    v0 = vt[-1]
    return v0 / np.linalg.norm(v0)


def _reflect(v, m):
    return v - 2.0 * (v @ m) * m


def polytope_vertices(symbol):
    """Vertices as the orbit of the initial vertex under the mirror group."""
    normals = mirror_normals(symbol)
    v0 = _initial_vertex(normals)

    verts = [v0]
    seen = {tuple(np.round(v0, 6))}
    queue = [v0]
    while queue:
        v = queue.pop()
        for m in normals:
            r = _reflect(v, m)
            key = tuple(np.round(r, 6))
            if key not in seen:
                seen.add(key)
                verts.append(r)
                queue.append(r)
    return np.asarray(verts)


# ---------------------------------------------------------------------------
# Star polytopes (fractional Schläfli components).  The regular star
# polytopes only involve the pentagram {5/2}; faces are either convex
# polygons or pentagrams.  Faces are enumerated as the orbit of the initial
# face cycle under the reflection group; a pentagram face is triangulated
# by fanning its 10-point outline (5 vertices + 5 edge intersections) from
# the face center, and 4-D cells cone their faces from the cell centroid.
# ---------------------------------------------------------------------------

def _face_cycle(normals):
    """Ordered vertex cycle of the initial face: repeated rotation by the
    m0*m1 double reflection walks the polygon (star order for p/q)."""
    v0 = _initial_vertex(normals)
    cycle = [v0]
    cur = v0
    for _ in range(64):
        cur = _reflect(_reflect(cur, normals[0]), normals[1])
        if np.linalg.norm(cur - v0) < 1e-6:
            break
        cycle.append(cur)
    return np.asarray(cycle)


def _canon_cycle(cycle):
    """Canonical key of a face cycle (rotation/reflection invariant)."""
    pts = sorted(tuple(np.round(p, 5)) for p in cycle)
    return tuple(pts)


def _orbit_of_faces(cycle, normals):
    faces = {_canon_cycle(cycle): cycle}
    queue = [cycle]
    while queue:
        f = queue.pop()
        for m in normals:
            g = np.asarray([_reflect(v, m) for v in f])
            key = _canon_cycle(g)
            if key not in faces:
                faces[key] = g
                queue.append(g)
    return list(faces.values())


def _seg_intersect_2d(a0, a1, b0, b1):
    """Intersection of segments in 2-D face coordinates, or None."""
    r = a1 - a0
    s = b1 - b0
    den = r[0] * s[1] - r[1] * s[0]
    if abs(den) < 1e-12:
        return None
    q = b0 - a0
    t = (q[0] * s[1] - q[1] * s[0]) / den
    u = (q[0] * r[1] - q[1] * r[0]) / den
    if 1e-9 < t < 1 - 1e-9 and 1e-9 < u < 1 - 1e-9:
        return a0 + t * r
    return None


def _tess_face(cycle):
    """Triangulate a (possibly star) face into triangles (in d-space)."""
    p = len(cycle)
    center = cycle.mean(axis=0)
    # 2-D coordinates in the face plane
    b1 = cycle[0] - center
    b1 = b1 / np.linalg.norm(b1)
    b2 = None
    for v in cycle[1:]:
        w = v - center
        w = w - (w @ b1) * b1
        if np.linalg.norm(w) > 1e-9:
            b2 = w / np.linalg.norm(w)
            break
    uv = np.asarray([[(v - center) @ b1, (v - center) @ b2] for v in cycle])

    # collect the outline: vertices + interior edge-edge intersections
    pts2 = [uv[i] for i in range(p)]
    for i in range(p):
        for j in range(i + 1, p):
            x = _seg_intersect_2d(uv[i], uv[(i + 1) % p],
                                  uv[j], uv[(j + 1) % p])
            if x is not None:
                pts2.append(x)
    # dedup + angular sort around the center (the star region is
    # star-shaped wrt its center)
    uniq = []
    for q_ in pts2:
        if not any(np.linalg.norm(q_ - u) < 1e-7 for u in uniq):
            uniq.append(q_)
    uniq.sort(key=lambda q_: math.atan2(q_[1], q_[0]))

    tris = []
    m = len(uniq)
    for k in range(m):
        a = uniq[k]
        b = uniq[(k + 1) % m]
        pa = center + a[0] * b1 + a[1] * b2
        pb = center + b[0] * b1 + b[1] * b2
        tris.append(np.stack([center, pa, pb]))
    return tris


def star_prototypes(nt, symbol, material):
    """Boundary (d-1)-simplices of a star polytope.

    d=3: triangulated faces.  d=4: cells coned from their centroids over
    the triangulated faces (each face triangle + cell centroid = one
    tetrahedron)."""
    n = len(symbol) + 1
    normals = mirror_normals(symbol)
    cycle = _face_cycle(normals)
    faces = _orbit_of_faces(cycle, normals)

    if n == 3:
        tris = [t for f in faces for t in _tess_face(f)]
    elif n == 4:
        # initial cell = orbit of the initial face under <m0,m1,m2>
        cell_faces = {_canon_cycle(cycle): cycle}
        queue = [cycle]
        while queue:
            f = queue.pop()
            for m in normals[:3]:
                g = np.asarray([_reflect(v, m) for v in f])
                key = _canon_cycle(g)
                if key not in cell_faces:
                    cell_faces[key] = g
                    queue.append(g)
        cell0 = list(cell_faces.values())

        # cells = orbit of the cell (as a set of face keys) under the group
        def cell_key(cfaces):
            return tuple(sorted(_canon_cycle(f) for f in cfaces))

        cells = {cell_key(cell0): cell0}
        queue = [cell0]
        while queue:
            cf = queue.pop()
            for m in normals:
                g = [np.asarray([_reflect(v, m) for v in f]) for f in cf]
                key = cell_key(g)
                if key not in cells:
                    cells[key] = g
                    queue.append(g)

        tris = []
        for cf in cells.values():
            centroid = np.mean([f.mean(axis=0) for f in cf], axis=0)
            for f in cf:
                for t in _tess_face(f):
                    tris.append(np.concatenate([t, centroid[None]], axis=0))
    else:
        raise NotImplementedError(
            "star polytopes are supported for 3 and 4 dimensions")

    d = nt.dimension
    protos = []
    dropped = 0
    for t in tris:
        pts = t
        edges = pts[1:] - pts[0]
        gram = edges @ edges.T
        vol2 = np.linalg.det(gram)
        if not np.isfinite(vol2) or abs(vol2) < 1e-18:
            dropped += 1
            continue
        if pts.shape[1] < d:
            pts = np.concatenate(
                [pts, np.zeros((pts.shape[0], d - pts.shape[1]))], axis=1)
        protos.append(nt.TrianglePrototype(
            [nt.Vector(p) for p in pts], material))
    if dropped:
        print(f"(dropped {dropped} degenerate simplices)")
    return protos


def hull_prototypes(nt, verts, material):
    """Triangulate the boundary into (d-1)-simplices."""
    from scipy.spatial import ConvexHull

    d = nt.dimension
    ndim = verts.shape[1]
    if ndim == 2:
        # polygon: fan triangulation, embedded flat in 3-D
        order = np.argsort(np.arctan2(verts[:, 1], verts[:, 0]))
        v = verts[order]
        protos = []
        for i in range(1, len(v) - 1):
            pts = [np.append(v[0], 0), np.append(v[i], 0),
                   np.append(v[i + 1], 0)]
            protos.append(nt.TrianglePrototype(
                [nt.Vector(p) for p in pts], material))
        return protos

    hull = ConvexHull(verts)
    keep = []
    dropped = 0
    for simplex in hull.simplices:
        pts = verts[simplex]
        # Qhull triangulations of non-simplicial facets can emit zero-volume
        # slivers; their generalized cross (face normal) vanishes — drop them
        edges = pts[1:] - pts[0]
        gram = edges @ edges.T
        vol2 = np.linalg.det(gram)
        scale = np.prod(np.linalg.norm(edges, axis=1)) or 1.0
        if not np.isfinite(vol2) or abs(vol2) < (1e-6 * scale) ** 2:
            dropped += 1
            continue
        if ndim < d:
            pts = np.concatenate(
                [pts, np.zeros((pts.shape[0], d - ndim))], axis=1)
        keep.append(pts)
    if dropped:
        print(f"(dropped {dropped} degenerate simplices)")
    if not keep:
        return []
    from ntracer_tpu.primitives import TrianglePrototype
    # vectorized construction (fields bit-identical to the scalar ctor)
    return TrianglePrototype.batch_from_points(
        np.asarray(keep, dtype=np.float32), material)


# ---------------------------------------------------------------------------

def main():
    parser = argparse.ArgumentParser(
        description="Display a regular polytope given its Schläfli symbol.")
    parser.add_argument("schlafli", metavar="N", type=schlafli_component,
                        nargs="+", help="the Schläfli symbol components")
    parser.add_argument("-o", "--output", metavar="PATH",
                        help="save an animation to PATH instead of displaying")
    parser.add_argument("-t", "--type", metavar="TYPE", default="h264",
                        help='output type: "png" for image series, else an '
                             "ffmpeg video codec")
    parser.add_argument("-f", "--frames", metavar="F", type=positive_int,
                        default=160, help="number of frames")
    parser.add_argument("-s", "--screen", metavar="WIDTHxHEIGHT",
                        type=screen_size, default=(800, 600))
    parser.add_argument("-a", "--fov", metavar="FOV", type=fov_type,
                        default=0.8)
    parser.add_argument("-d", "--cam-dist", metavar="DIST", type=float,
                        default=4)
    parser.add_argument("--benchmark", action="store_true",
                        help="measure rendering speed")
    parser.add_argument("--no-special", action="store_true",
                        help="use the generic module even if a specialized "
                             "one exists")
    args = parser.parse_args()

    material = Material((1, 0.5, 0.5))
    nt = NTracer(max(len(args.schlafli) + 1, 3),
                 force_generic=args.no_special)

    timer = time.perf_counter

    if (nt.dimension >= 3 and args.schlafli[0] == 4
            and all(c == 3 for c in args.schlafli[1:])):
        cam_distance = -math.sqrt(nt.dimension) * args.cam_dist
        scene = nt.BoxScene()
        circumradius_sq = float(nt.dimension)
    else:
        print("building geometry...")
        t0 = timer()
        if any(c.denominator != 1 for c in args.schlafli):
            protos = star_prototypes(nt, args.schlafli, material)
            nverts = "-"
        else:
            verts = polytope_vertices([int(c) for c in args.schlafli])
            protos = hull_prototypes(nt, verts, material)
            nverts = len(verts)
        print("done in {0} seconds ({1} vertices, {2} simplices)".format(
            timer() - t0, nverts, len(protos)))

        circumradius_sq = 1.0
        cam_distance = -math.sqrt(circumradius_sq) * args.cam_dist

        print("partitioning scene...")
        t0 = timer()
        scene = nt.build_composite_scene(protos)
        print("done in {0} seconds".format(timer() - t0))

    camera = nt.Camera()
    camera.translate(nt.Vector.axis(2, cam_distance))
    scene.set_camera(camera)
    scene.set_fov(args.fov)

    incr = 2 * math.pi / args.frames
    hcoef = 1 / math.sqrt(nt.dimension - 1)

    def advance_camera():
        """Rotating-camera path (same as the reference benchmark loop)."""
        a2 = camera.axes[0] * hcoef + camera.axes[1] * hcoef
        for i in range(nt.dimension - 3):
            a2 = a2 + camera.axes[i + 3] * hcoef
        camera.transform(nt.Matrix.rotation(camera.axes[2], a2, incr))
        camera.normalize()
        camera.origin = camera.axes[2] * cam_distance
        scene.set_camera(camera)

    w, h = args.screen
    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    renderer = BlockingRenderer()
    buf = bytearray(fmt.pitch * fmt.height)

    if args.benchmark:
        # CallbackRenderer pipelining (the reference's --benchmark also
        # runs through CallbackRenderer, polytope.py:522-537): frame N+1
        # is dispatched with the advanced camera while frame N's bytes
        # are still crossing the host link, so the pull overlaps compute.
        import threading
        from ntracer import CallbackRenderer
        crenderer = CallbackRenderer()
        depth = 3
        bufs = [bytearray(fmt.pitch * fmt.height) for _ in range(depth)]
        sem = threading.Semaphore(depth)
        done = threading.Event()
        frames = 0

        def cb(_r):
            nonlocal frames
            frames += 1
            if frames == args.frames:
                done.set()
            sem.release()

        t0 = timer()
        for f in range(args.frames):
            if not sem.acquire(timeout=600):
                raise RuntimeError("render queue stalled (frame callback "
                                   "never fired)")
            crenderer.begin_render(bufs[f % depth], fmt, scene, cb)
            advance_camera()
        if not done.wait(timeout=600 + 10 * args.frames):
            raise RuntimeError(f"benchmark stalled at {frames}/"
                               f"{args.frames} frames")
        total = timer() - t0
        print("rendered {0} frame(s) in {1} seconds\n"
              "time per frame: {2} seconds\n"
              "frames per second: {3}".format(
                  frames, total, total / frames, frames / total))
        return

    if args.output is not None:
        if args.type == "png":
            try:
                from PIL import Image
            except ImportError:
                print("PNG output requires Pillow", file=sys.stderr)
                sys.exit(1)
            for f in range(args.frames):
                renderer.render(buf, fmt, scene)
                img = np.frombuffer(bytes(buf), np.uint8).reshape(h, w, 3)
                # the reference writes frame0000.png... into the output
                # DIRECTORY (polytope.py:650-652)
                Image.fromarray(img).save(
                    os.path.join(args.output, f"frame{f:04d}.png"))
                advance_camera()
                print(f"frame {f+1}/{args.frames}", end="\r")
            print()
        else:
            # the reference pipes 16-bit big-endian frames to the encoder
            # (rgb48be, reference polytope.py:597-608); the wide format
            # routes through the exact host packer
            fmt16 = ImageFormat(w, h, [Channel(16, 1, 0, 0),
                                       Channel(16, 0, 1, 0),
                                       Channel(16, 0, 0, 1)])
            buf16 = bytearray(fmt16.pitch * fmt16.height)
            # -an/-crf 10 match the reference encode settings
            # (polytope.py:610-612); yuv420p is kept for player
            # compatibility (the reference leaves libx264 at yuv444p)
            proc = subprocess.Popen(
                ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "rgb48be",
                 "-s", f"{w}x{h}", "-r", "60", "-i", "-", "-an",
                 "-c:v", args.type, "-crf", "10",
                 "-pix_fmt", "yuv420p", args.output],
                stdin=subprocess.PIPE)
            for f in range(args.frames):
                renderer.render(buf16, fmt16, scene)
                proc.stdin.write(bytes(buf16))
                advance_camera()
                print(f"frame {f+1}/{args.frames}", end="\r")
            proc.stdin.close()
            proc.wait()
            print()
        return

    # interactive pygame mode
    import pygame
    from ntracer.pygame_render import PygameRenderer, ON_COMPLETE

    pygame.display.init()
    surface = pygame.display.set_mode(args.screen)
    prender = PygameRenderer()
    running = [True]

    def start_render():
        running[0] = True
        prender.begin_render(surface, scene)

    start_render()
    clock = pygame.time.Clock()
    frame = 0
    while True:
        for e in pygame.event.get():
            if e.type == pygame.QUIT:
                pygame.quit()
                return
            if e.type == ON_COMPLETE:
                running[0] = False
                pygame.display.flip()
        if not running[0]:
            frame += 1
            advance_camera()
            start_render()
        clock.tick(60)


if __name__ == "__main__":
    main()
