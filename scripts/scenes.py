"""Benchmark scenes shared by chip_smoke.py, bench.py and the scripts.

Each builder returns ``(nt, scene, camera, cam_distance)``: the scene as a
user builds it through the public API, its camera, and the orbit radius
the rotating-camera loops use (``orbit``).  Geometry comes from fixed
seeds, so every run renders the same frames.
"""

import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from ntracer import NTracer, Material  # noqa: E402


def _random_simplices(nt, n, seed, mat, spread=2.0, size=0.7):
    d = nt.dimension
    rng = np.random.RandomState(seed)
    protos = []
    for _ in range(n):
        base = rng.uniform(-spread, spread, d)
        pts = [nt.Vector(*(base + rng.uniform(-size, size, d)))
               for _ in range(d)]
        protos.append(nt.TrianglePrototype(pts, mat))
    return protos


def _camera(nt, scene, dist, axis=2):
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(axis, dist))
    scene.set_camera(cam)
    return cam


def cell120():
    """The reference's own benchmark, ``polytope.py 5 3 3 --benchmark``:
    the 4-D 120-cell {5,3,3}, fov 0.8, camera at -4 on axis 2."""
    from polytope import polytope_vertices, hull_prototypes
    nt = NTracer(4)
    protos = hull_prototypes(nt, polytope_vertices([5, 3, 3]),
                             Material((1, 0.5, 0.5)))
    scene = nt.build_composite_scene(protos)
    scene.set_fov(0.8)
    return nt, scene, _camera(nt, scene, -4.0), -4.0


def lit6():
    """6-D lit scene: 900 simplices, two point lights and a directional
    light, shadows on."""
    nt = NTracer(6)
    protos = _random_simplices(nt, 900, 3, Material((0.9, 0.6, 0.3)))
    scene = nt.build_composite_scene(protos)
    cam = _camera(nt, scene, -8.0)
    scene.add_light(nt.PointLight(nt.Vector.axis(1, 5), (1, 0.9, 0.7)))
    scene.add_light(nt.PointLight(nt.Vector.axis(0, -5), (0.4, 0.5, 0.9)))
    scene.add_light(nt.GlobalLight(nt.Vector.axis(1, -1), (0.2, 0.2, 0.3)))
    scene.set_shadows(True)
    return nt, scene, cam, -8.0


def reflective3():
    """Reflective + shadowed 3-D scene: 1000 simplices, reflectivity 0.4,
    one point light, shadows on."""
    nt = NTracer(3)
    protos = _random_simplices(nt, 1000, 11,
                               Material((0.8, 0.8, 0.9), reflectivity=0.4),
                               spread=3.0, size=0.6)
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector(0, 0, -9))
    scene.set_camera(cam)
    scene.add_light(nt.PointLight(nt.Vector(0, 5, -2), (1, 0.9, 0.8)))
    scene.set_shadows(True)
    return nt, scene, cam, -9.0


def transparent3():
    """3-D scene with every tenth simplex transparent (opacity 0.45), a
    point light and shadows: the K-nearest transparent path."""
    nt = NTracer(3)
    rng = np.random.RandomState(35)
    glass = Material((0.9, 0.7, 0.4), opacity=0.45)
    solid = Material((1, 0.5, 0.5))
    protos = []
    for i in range(1000):
        base = rng.uniform(-2, 2, 3)
        pts = [nt.Vector(*(base + rng.uniform(-0.6, 0.6, 3)))
               for _ in range(3)]
        protos.append(nt.TrianglePrototype(pts, glass if i % 10 == 0
                                           else solid))
    scene = nt.build_composite_scene(protos)
    cam = _camera(nt, scene, -8.0)
    scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)))
    scene.set_shadows(True)
    return nt, scene, cam, -8.0


def sphere_mesh(n_target):
    """Lat/long tessellated unit sphere with ~n_target triangles."""
    rows = max(4, int(math.sqrt(n_target / 4)))
    cols = 2 * rows
    th = np.linspace(0, math.pi, rows + 1)
    ph = np.linspace(0, 2 * math.pi, cols + 1)
    v = np.empty((rows + 1, cols + 1, 3), np.float32)
    v[..., 0] = np.sin(th)[:, None] * np.cos(ph)[None, :]
    v[..., 1] = np.sin(th)[:, None] * np.sin(ph)[None, :]
    v[..., 2] = np.cos(th)[:, None]
    a = v[:-1, :-1]
    b = v[1:, :-1]
    c = v[1:, 1:]
    e = v[:-1, 1:]
    upper = np.stack([a, b, c], axis=2)[1:].reshape(-1, 3, 3)
    lower = np.stack([a, c, e], axis=2)[:-1].reshape(-1, 3, 3)
    tris = np.concatenate([upper, lower]).astype(np.float32)
    area = np.linalg.norm(np.cross(tris[:, 1] - tris[:, 0],
                                   tris[:, 2] - tris[:, 0]), axis=1)
    return tris[area > 1e-10]


def mesh100k(n_tris=100000):
    """Tessellated sphere of ~100k triangles (an OBJ-scale mesh), camera
    at -3 on axis 2."""
    from ntracer_tpu.primitives import TrianglePrototype
    nt = NTracer(3)
    protos = TrianglePrototype.batch_from_points(sphere_mesh(n_tris),
                                                 Material((1, 0.6, 0.4)))
    scene = nt.build_composite_scene(protos)
    return nt, scene, _camera(nt, scene, -3.0), -3.0


def box10():
    """The analytic 10-D hypercube (BoxScene)."""
    nt = NTracer(10)
    scene = nt.BoxScene()
    dist = -math.sqrt(10) * 1.2
    return nt, scene, _camera(nt, scene, dist), dist


def device_frame_ms(scene, fmt, frames, between=None):
    """On-device frame time of the renderers' own program: ``frames``
    frames dispatched as ``BlockingRenderer`` dispatches them
    (``wavefront.dispatch_packed``: the same slabs on the same devices),
    then one ``block_until_ready`` on all of them, with no pull to the
    host.  ``between()`` runs after each dispatch (e.g. moves the
    camera).  Milliseconds per frame."""
    import jax
    from ntracer_tpu.engine import wavefront

    jax.block_until_ready([a for _, a in wavefront.dispatch_packed(scene,
                                                                   fmt)])
    t0 = time.perf_counter()
    outs = []
    for _ in range(frames):
        outs += [a for _, a in wavefront.dispatch_packed(scene, fmt)]
        if between is not None:
            between()
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) * 1e3 / frames


def orbit(nt, scene, camera, cam_distance, incr):
    """Advance the rotating camera of polytope.py's benchmark loop by
    ``incr`` radians."""
    h = 1 / math.sqrt(nt.dimension - 1)
    a2 = camera.axes[0] * h + camera.axes[1] * h
    for i in range(nt.dimension - 3):
        a2 = a2 + camera.axes[i + 3] * h
    camera.transform(nt.Matrix.rotation(camera.axes[2], a2, incr))
    camera.normalize()
    camera.origin = camera.axes[2] * cam_distance
    scene.set_camera(camera)
