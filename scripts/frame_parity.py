#!/usr/bin/env python
"""Full-frame bit-parity gate: render the five BASELINE configs with BOTH
implementations (identical geometry + camera) and compare every 8-bit
pixel.  Writes PARITY_FRAMES.json with per-config diff statistics.

    python scripts/frame_parity.py [--ref-path PATH] [--out PARITY_FRAMES.json]

The reference renders in a subprocess (the two packages shadow the same
``ntracer`` module name); ntracer_tpu renders in-process on the default
backend (the GPU when available).

Expected outcome: identical except a small set of boundary pixels where
float32 summation-order differences flip a ROUNDING_FUZZ-tight edge test
or land on an exact 8-bit quantization boundary; the JSON records every
differing pixel count and the worst channel delta so the claim is
auditable rather than asserted.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

DEFAULT_REF = "/tmp/refbuild/build/lib.linux-x86_64-cpython-312"


def box_spec(d, w, h):
    cam_origin = np.zeros(d, np.float32)
    cam_origin[2] = -math.sqrt(d) * 1.2
    return dict(kind="box", d=d, width=w, height=h, fov=0.8,
                cam_origin=cam_origin,
                cam_axes=np.eye(d, dtype=np.float32))


def cell120_spec(w, h):
    from ntracer import NTracer, Material
    from polytope import polytope_vertices, hull_prototypes
    nt = NTracer(4)
    protos = hull_prototypes(nt, polytope_vertices([5, 3, 3]),
                             Material((1, 0.5, 0.5)))
    pts = np.asarray([pr._points for pr in protos], np.float32)
    cam_origin = np.array([0, 0, -4.0, 0], np.float32)
    return dict(kind="tris", d=4, width=w, height=h, fov=0.8,
                cam_origin=cam_origin, cam_axes=np.eye(4, dtype=np.float32),
                tri_points=pts, mat_color=np.array([1, 0.5, 0.5], np.float32))


def render_ours(spec):
    from ntracer import (NTracer, Material, ImageFormat, Channel,
                         BlockingRenderer)
    d = int(spec["d"])
    nt = NTracer(d)
    if spec["kind"] == "box":
        scene = nt.BoxScene()
        cam = scene.get_camera()
    else:
        mat = Material(tuple(float(c) for c in spec["mat_color"]))
        protos = [nt.TrianglePrototype([nt.Vector(*map(float, p))
                                        for p in tri], mat)
                  for tri in spec["tri_points"]]
        scene = nt.build_composite_scene(protos)
        scene.set_fov(float(spec["fov"]))
        cam = nt.Camera()
    cam.origin = nt.Vector(*map(float, spec["cam_origin"]))
    for i in range(d):
        cam.axes[i] = nt.Vector(*map(float, spec["cam_axes"][i]))
    scene.set_camera(cam)
    w, h = int(spec["width"]), int(spec["height"])
    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer().render(buf, fmt, scene)
    return np.frombuffer(bytes(buf), np.uint8).reshape(h, w, 3), scene


def render_ref(spec, ref_path):
    with tempfile.TemporaryDirectory() as td:
        spec_path = os.path.join(td, "spec.npz")
        out_path = os.path.join(td, "out.raw")
        np.savez(spec_path, **spec)
        env = dict(os.environ, PYTHONPATH=ref_path)
        env.pop("JAX_PLATFORMS", None)
        proc = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts/_ref_render.py"),
             spec_path, out_path],
            env=env, capture_output=True)
        w, h = int(spec["width"]), int(spec["height"])
        data = (np.fromfile(out_path, np.uint8)
                if os.path.exists(out_path) else np.zeros(0, np.uint8))
        if data.size != w * h * 3:
            # a short/absent file is a real failure; a bad exit code alone
            # is not (the C++ extension can segfault at interpreter
            # teardown on large scenes, after the frame is fully written)
            raise RuntimeError(
                f"reference render failed: rc={proc.returncode} "
                f"{proc.stderr.decode()[-500:]}")
        return data.reshape(h, w, 3)


def compare(name, ours, ref, classify=None):
    diff = ours.astype(np.int16) - ref.astype(np.int16)
    bad = np.any(diff != 0, axis=2)
    n_bad = int(bad.sum())
    ys, xs = np.nonzero(bad)
    out = {
        "config": name,
        "pixels": int(bad.size),
        "diff_pixels": n_bad,
        "diff_ppm": round(n_bad / bad.size * 1e6, 2),
        "max_channel_delta": int(np.abs(diff).max()),
        "bit_identical": n_bad == 0,
        "sample_coords": [[int(x), int(y)] for x, y in
                          list(zip(xs, ys))[:20]],
    }
    if classify is not None and n_bad:
        counts = {}
        genuine_coords = []
        for x, y in zip(xs, ys):
            verdict = classify(int(x), int(y))
            counts[verdict] = counts.get(verdict, 0) + 1
            if verdict == "genuine" and len(genuine_coords) < 20:
                genuine_coords.append([int(x), int(y)])
        out["classes"] = counts
        out["genuine"] = counts.get("genuine", 0)
        if genuine_coords:
            out["genuine_coords"] = genuine_coords
    print(json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# Mechanical diff-pixel classification: every differing
# pixel is arbitrated in exact scalar math.  Verdicts:
#   "tie"          — two primitives intersect the primary ray at (nearly)
#                    equal t (coplanar faces): the winner is summation-order
#                    dependent and both implementations are legitimate.
#   "fuzz-edge"    — the winning/nearest hit has an edge/total/plane test
#                    value within float32 rounding distance of its
#                    ROUNDING_FUZZ acceptance boundary, or float32 vs
#                    float64 evaluation picks different winners: a one-ulp
#                    difference flips the test (tracer.hpp:25, 411-440).
#   "quantization" — the exact color sits within rounding distance of an
#                    8-bit quantization boundary; a 1-ulp color difference
#                    (libm pow vs XLA pow) moves the byte by one.
#   "genuine"      — none of the above: a real implementation divergence.
# ---------------------------------------------------------------------------

ROUNDING_FUZZ = np.float32(np.finfo(np.float32).eps * 10)
EDGE_TOL = 4e-6          # |test value - boundary| regarded as rounding-fuzz
TIE_RTOL = 1e-5          # relative t gap regarded as a coplanar tie
QUANT_TOL = 2e-3         # |frac(c*255+0.5) - {0,1}| regarded as knife-edge


def _primary_ray(scene, x, y, w, h):
    from ntracer_tpu.engine import wavefront
    fovI, hw, hh = wavefront._fov_params(w, h, scene.fov)
    cam_t = np.asarray(scene._cam._t, np.float32)
    o = np.asarray(scene._cam._origin, np.float32)
    dv = (cam_t[2]
          + cam_t[0] * np.float32(fovI * (np.float32(x) - hw))
          - cam_t[1] * np.float32(fovI * (np.float32(y) - hh)))
    dv = dv.astype(np.float32)
    dv = dv / np.float32(np.sqrt(np.float32((dv * dv).sum())))
    return o, dv


def _pool_test(o, dv, p1, fn, en, dc, dtype):
    """Vectorized triangle test over the whole pool in the given dtype;
    returns (t, valid, margin) where margin is the distance of the closest
    edge/total test value to its acceptance boundary."""
    o = o.astype(dtype)
    dv = dv.astype(dtype)
    fn_ = fn.astype(dtype)
    en_ = en.astype(dtype)
    p1_ = p1.astype(dtype)
    dc_ = dc.astype(dtype)
    FUZZ = dtype(ROUNDING_FUZZ)

    denom = fn_ @ dv
    safe = np.where(denom != 0, denom, 1)
    t = -((fn_ @ o) + dc_) / safe
    valid = (denom != 0) & (t > 0)
    margin = np.full(len(fn_), np.inf, dtype)
    tot = np.zeros(len(fn_), dtype)
    for i in range(en.shape[1]):
        a = ((en_[:, i] * p1_).sum(1) - en_[:, i] @ o
             - t * (en_[:, i] @ dv))
        valid &= (a >= -FUZZ) & (a <= 1 + FUZZ)
        margin = np.minimum(margin, np.abs(a + FUZZ))
        margin = np.minimum(margin, np.abs(1 + FUZZ - a))
        tot += a
    valid &= tot <= 1 + FUZZ
    margin = np.minimum(margin, np.abs(1 + FUZZ - tot))
    return t, valid, margin


def make_tris_classifier(scene, w, h):
    from ntracer_tpu.engine import wavefront
    _, device, flat = wavefront.get_device_scene(scene)
    p1 = np.asarray(flat.arrays["tri_p1"])
    fn = np.asarray(flat.arrays["tri_fn"])
    en = np.asarray(flat.arrays["tri_en"])
    dc = np.asarray(flat.arrays["tri_dc"])
    real = np.linalg.norm(fn, axis=1) > 0
    scene._set_view_size(w, h)

    def classify(x, y):
        o, dv = _primary_ray(scene, x, y, w, h)
        t32, v32, m32 = _pool_test(o, dv, p1, fn, en, dc, np.float32)
        t64, v64, m64 = _pool_test(o, dv, p1, fn, en, dc, np.float64)
        v32 &= real
        v64 &= real

        win32 = int(np.where(v32, t32, np.inf).argmin()) if v32.any() else -1
        win64 = int(np.where(v64, t64, np.inf).argmin()) if v64.any() else -1
        if win32 >= 0:
            tmin = float(t32[win32])
            near = v32 & (t32 <= tmin * (1 + TIE_RTOL))
            if near.sum() >= 2:
                return "tie"
        if win32 != win64:
            return "fuzz-edge"
        # any primitive at/nearer than the winner whose test value sits on
        # the acceptance boundary can flip under reordered float32 math
        cutoff = float(t32[win32]) * (1 + TIE_RTOL) if win32 >= 0 else np.inf
        edge = real & (t32 > 0) & (t32 <= cutoff) & (m32 < EDGE_TOL)
        if edge.any():
            return "fuzz-edge"
        oc = np.asarray(scene._pixel_color(x, y), np.float32)
        fr = np.abs(oc * 255 + 0.5 - np.round(oc * 255 + 0.5))
        if (fr < QUANT_TOL).any():
            return "quantization"
        return "genuine"

    return classify


def _pool_arrays(scene):
    from ntracer_tpu.engine import wavefront
    cfg, _, flat = wavefront.get_device_scene(scene)
    a = {k: np.asarray(v) for k, v in flat.arrays.items()}
    a["real"] = np.linalg.norm(a["tri_fn"], axis=1) > 0
    a["opaque"] = a["mat_opacity"][a["tri_mat"]] >= 1
    return cfg, a


def _near_zero(t, scale):
    """Hits at the ray's own origin (neighbours of the surface a shadow or
    reflection ray leaves): their t > 0 test is a rounding coin-flip."""
    return np.abs(t) <= 1e-4 * max(scale, 1.0)


def _shadow_verdict(a, p, ld, dist, skip, scale):
    """'fuzz-edge' or None for one shadow ray from ``p`` along ``ld`` up
    to ``dist``, leaving primitive ``skip``: 'fuzz-edge' when its any-hit
    answer can flip under reordered float32 math (float32 and float64
    disagree, a hit before the light sits on a test boundary, or a
    neighbour of the surface it leaves is hit at t ~ 0)."""
    pool = (a["tri_p1"], a["tri_fn"], a["tri_en"], a["tri_dc"])
    s32, w32, n32 = _pool_test(p, ld, *pool, np.float32)
    s64, w64, _ = _pool_test(p, ld, *pool, np.float64)
    keep_s = a["real"] & (np.arange(len(s32)) != skip)
    b32 = keep_s & w32 & (s32 < dist)
    b64 = keep_s & w64 & (s64 < dist)
    if b32.any() != b64.any():
        return "fuzz-edge"
    edge = keep_s & (n32 < EDGE_TOL) & (s32 < dist * (1 + TIE_RTOL))
    zero = keep_s & _near_zero(s32, scale) & (n32 < 1e-3)
    if edge.any() or zero.any():
        return "fuzz-edge"
    return None


def _ray_verdict(cfg, a, o, dv, skip, depth):
    """'tie', 'fuzz-edge' or None for one ray and the rays it spawns
    (shadow rays toward every light when shadows are on, the reflection
    ray while the bounce depth allows), in the engine's conventions
    (wavefront.shade_local)."""
    pool = (a["tri_p1"], a["tri_fn"], a["tri_en"], a["tri_dc"])
    t32, v32, m32 = _pool_test(o, dv, *pool, np.float32)
    t64, v64, _ = _pool_test(o, dv, *pool, np.float64)
    keep = a["real"] & (np.arange(len(t32)) != skip)
    v32 &= keep
    v64 &= keep
    op32, op64 = v32 & a["opaque"], v64 & a["opaque"]
    win32 = int(np.where(op32, t32, np.inf).argmin()) if op32.any() else -1
    win64 = int(np.where(op64, t64, np.inf).argmin()) if op64.any() else -1
    if win32 >= 0:
        near = v32 & (t32 <= t32[win32] * (1 + TIE_RTOL))
        if near.sum() >= 2:
            return "tie"
    if win32 != win64:
        return "fuzz-edge"
    cutoff = float(t32[win32]) * (1 + TIE_RTOL) if win32 >= 0 else np.inf
    scale = float(np.abs(o).max())
    cand = keep & (t32 <= cutoff)
    if (cand & (t32 > 0) & (m32 < EDGE_TOL)).any() \
            or (cand & _near_zero(t32, scale) & (m32 < 1e-3)).any():
        return "fuzz-edge"
    if win64 < 0:
        return None

    p = (o + t64[win64] * dv).astype(np.float32)
    fn = a["tri_fn"][win64]
    normal = fn / np.linalg.norm(fn) * (-1 if fn @ dv > 0 else 1)
    if cfg.shadows:
        rays = []
        for pos in a["pl_pos"][:cfg.n_point_lights]:
            lv = p - pos
            dist = np.float32(np.linalg.norm(lv))
            rays.append(((lv / dist).astype(np.float32), dist))
        for gd in a["gl_dir"][:cfg.n_global_lights]:
            rays.append(((-gd).astype(np.float32), np.float32(np.inf)))
        for ld, dist in rays:
            v = _shadow_verdict(a, p, ld, dist, win64, scale)
            if v:
                return v
    refl = a["mat_refl"][a["tri_mat"][win64]]
    if refl != 0 and depth < cfg.max_reflect_depth:
        child = dv - normal * (2 * (dv @ normal))
        child = (child / np.linalg.norm(child)).astype(np.float32)
        return _ray_verdict(cfg, a, p, child, win64, depth + 1)
    return None


def classify_pixel(scene, x, y, w, h):
    """Verdict for a composite-scene pixel whose engine colour differs
    from the oracle's: 'tie' or 'fuzz-edge' when the primary ray or a ray
    it spawns meets one of the rounding classes above, else 'genuine'.
    Solids are not arbitrated."""
    cfg, a = _pool_arrays(scene)
    scene._set_view_size(w, h)
    o, dv = _primary_ray(scene, x, y, w, h)
    return _ray_verdict(cfg, a, o, dv, -1, 0) or "genuine"


def classify_trace(scene, o, dv):
    """Verdict for one ray whose nearest hit differs between two trace
    implementations: 'tie', 'fuzz-edge' or 'genuine'."""
    cfg, a = _pool_arrays(scene)
    return _ray_verdict(cfg, a, np.asarray(o, np.float32),
                        np.asarray(dv, np.float32), -1,
                        cfg.max_reflect_depth) or "genuine"


def classify_occlusion(scene, o, dv, ldist, skip):
    """Verdict for one shadow ray whose any-hit answer differs between
    two trace implementations: 'fuzz-edge' or 'genuine'."""
    _, a = _pool_arrays(scene)
    o = np.asarray(o, np.float32)
    return _shadow_verdict(a, o, np.asarray(dv, np.float32),
                           np.float32(ldist), int(skip),
                           float(np.abs(o).max())) or "genuine"


def make_box_classifier(scene, w, h, quantization=True):
    """``quantization=False`` for float colour comparisons, where the
    8-bit quantization class does not apply."""
    d = scene.dimension
    scene._set_view_size(w, h)

    def classify(x, y):
        o, dv = _primary_ray(scene, x, y, w, h)
        # hypercube_intersects face tests (tracer.hpp:126-152): a face
        # coordinate within rounding of the +-(1+FUZZ) bound flips
        for i in range(d):
            if dv[i] == 0:
                continue
            ni = np.float32(1.0 if dv[i] < 0 else -1.0)
            dist = np.float32((ni - o[i]) / dv[i])
            if dist <= 0:
                continue
            p = o + dist * dv
            for j in range(d):
                if j != i and abs(abs(float(p[j])) - float(1 + ROUNDING_FUZZ)) < EDGE_TOL:
                    return "fuzz-edge"
        if not quantization:
            return "genuine"
        oc = np.asarray(scene._pixel_color(x, y), np.float32)
        fr = np.abs(oc * 255 + 0.5 - np.round(oc * 255 + 0.5))
        if (fr < QUANT_TOL).any():
            return "quantization"
        return "genuine"

    return classify


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ref-path", default=DEFAULT_REF)
    ap.add_argument("--out", default=os.path.join(REPO, "PARITY_FRAMES.json"))
    ap.add_argument("--configs", default="1,2,3,4,5")
    args = ap.parse_args()

    specs = {
        "1": ("3D cube 320x240", box_spec(3, 320, 240)),
        "2": ("4D tesseract 640x480", box_spec(4, 640, 480)),
        "3": ("120-cell 4D 1024x1024", None),  # built lazily (slow)
        "4": ("6D hypercube 1024x1024", box_spec(6, 1024, 1024)),
        "5": ("10D hypercube 1920x1080", box_spec(10, 1920, 1080)),
    }
    results = []
    for key in args.configs.split(","):
        name, spec = specs[key]
        if spec is None:
            spec = cell120_spec(1024, 1024)
        ours, scene = render_ours(spec)
        ref = render_ref(spec, args.ref_path)
        w, h = int(spec["width"]), int(spec["height"])
        classify = (make_box_classifier(scene, w, h)
                    if spec["kind"] == "box"
                    else make_tris_classifier(scene, w, h))
        results.append(compare(name, ours, ref, classify))
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
