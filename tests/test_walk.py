"""The walk kernel (Pallas interpret mode on the CPU) against the XLA chunk
scan, its chunk layouts, the kernel choice, full-precision matrix
products in the frame program and the compile-cache placement."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ntracer_tpu.wrapper import NTracer
from ntracer_tpu.render import Material
from ntracer_tpu.engine import chunks, walk, wavefront

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REAL_MAX = wavefront.REAL_MAX


def _scene(d, n, seed=5, spread=2.0, size=0.8):
    nt = NTracer(d)
    rng = np.random.RandomState(seed)
    protos = []
    for _ in range(n):
        base = rng.uniform(-spread, spread, d)
        pts = [nt.Vector(*(base + rng.uniform(-size, size, d)))
               for _ in range(d)]
        protos.append(nt.TrianglePrototype(pts, Material((1, 0.5, 0.5))))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    return scene


def _layouts(scene):
    """(cfg, scan arrays, walk layouts) of ``scene``: the device arrays
    hold no walk layouts on the CPU, so they take the scan."""
    cfg, dev, flat = wavefront.get_device_scene(scene)
    assert not wavefront._walk_ok(dev)
    lay = wavefront.walk_layouts(flat.arrays, flat.arrays["cull_lo"],
                                 flat.arrays["cull_hi"], cfg.d)
    lay = {k[len("walk_"):]: jnp.asarray(v) for k, v in lay.items()}
    return cfg, dev, lay


def _primary(scene, side):
    scene._set_view_size(side, side)
    idx = np.arange(side * side)
    fov = wavefront._fov_params(side, side, scene.fov)
    return wavefront.make_rays(
        jnp.asarray(scene._cam._origin), jnp.asarray(scene._cam._t), *fov,
        jnp.asarray((idx % side).astype(np.float32)),
        jnp.asarray((idx // side).astype(np.float32)))


def _aimed_rays(scene, R, seed):
    """R rays from random points around the scene toward the centroids of
    random pool triangles, so most of them meet the pool."""
    _, _, flat = wavefront.get_device_scene(scene)
    a = flat.arrays
    real = np.nonzero(np.linalg.norm(a["tri_fn"], axis=1) > 0)[0]
    rng = np.random.RandomState(seed)
    d = a["tri_fn"].shape[1]
    pick = real[rng.randint(len(real), size=R)]
    # the centroid x solves fn.x = -dc and e_i.(p1 - x) = 1/d (every
    # barycentric edge coordinate of the pair test equal)
    m = np.concatenate([a["tri_fn"][pick][:, None], a["tri_en"][pick]],
                       axis=1).astype(np.float64)
    rhs = np.concatenate([-a["tri_dc"][pick][:, None],
                          np.einsum("tid,td->ti", a["tri_en"][pick],
                                    a["tri_p1"][pick]) - 1.0 / d], axis=1)
    tgt = np.linalg.solve(m, rhs[..., None])[..., 0]
    o = rng.normal(size=(R, d))
    o = 6 * o / np.linalg.norm(o, axis=1, keepdims=True)
    dv = tgt - o
    dist = np.linalg.norm(dv, axis=1)
    return (jnp.asarray(o.astype(np.float32)),
            jnp.asarray((dv / dist[:, None]).astype(np.float32)),
            dist.astype(np.float32))


def _walk_nearest(lay, o, dirs, skip, d, **kw):
    t, slot, vis = walk.nearest_hit(lay, o, dirs, skip, d, interpret=True,
                                    **kw)
    gid = np.asarray(lay["slot_pack"][jnp.clip(slot, 0, None), d + 1])
    slot = np.asarray(slot)
    return (np.where(slot >= 0, np.asarray(t), REAL_MAX),
            np.where(slot >= 0, gid.astype(np.int32), -1), np.asarray(vis))


def _assert_same_hits(t, pid, rt, rpid):
    """Same winner and t, except where two primitives tie in t."""
    np.testing.assert_array_equal(t >= REAL_MAX, rt >= REAL_MAX)
    hit = rt < REAL_MAX
    np.testing.assert_allclose(t[hit], rt[hit], rtol=1e-5)
    tie = np.isclose(t, rt, rtol=1e-5)
    assert np.all((pid == rpid) | tie)


@pytest.mark.parametrize("d", [3, 4, 5, 6, 8, 10])
def test_walk_nearest_matches_scan(d):
    """Primary rays (front-to-back, shared-origin rows) and secondary rays
    (pool order, per-ray origins) agree with the XLA scan."""
    scene = _scene(d, n=150 if d < 8 else 60)
    cfg, dev, lay = _layouts(scene)
    o, dirs = _primary(scene, 12)
    R = o.shape[0]
    skip = jnp.full((R,), -1, jnp.int32)
    ref = wavefront.trace_pool(dev, cfg, o, dirs, skip)
    rt, rpid = np.asarray(ref["t"]), np.asarray(ref["pid"])

    order, dmin = chunks.chunk_order(lay["klo"], lay["khi"], o[0])
    sh = chunks.shared_rows(lay["gt"], lay["ci"], o[0], d)
    t, pid, _ = _walk_nearest(lay, o, dirs, skip, d, order=order, dmin=dmin,
                              sh=sh)
    _assert_same_hits(t, pid, rt, rpid)

    # secondary rays: per-ray origins around the scene, pool order
    so, sd, _ = _aimed_rays(scene, R, d)
    ref = wavefront.trace_pool(dev, cfg, so, sd, skip)
    t, pid, _ = _walk_nearest(lay, so, sd, skip, d)
    assert (pid >= 0).any()
    _assert_same_hits(t, pid, np.asarray(ref["t"]), np.asarray(ref["pid"]))


@pytest.mark.parametrize("d", [3, 4, 5, 6, 8, 10])
def test_walk_anyhit_matches_scan(d):
    """Any-hit mode: the same blocked set as the scan's occlusion query,
    with inactive rays (ldist <= 0) and per-ray skip ids."""
    scene = _scene(d, n=150 if d < 8 else 60, seed=9)
    cfg, dev, lay = _layouts(scene)
    R = 200
    rng = np.random.RandomState(d)
    o, dirs, dist = _aimed_rays(scene, R, d)
    ldist = jnp.asarray((dist * rng.uniform(-0.2, 1.5, R)).astype(
        np.float32))
    skip = jnp.asarray(rng.randint(-1, cfg.n_tris, R).astype(np.int32))
    ref, _ = wavefront.occlusion(dev, cfg, o, dirs, ldist, skip)
    blocked, _ = walk.occluded(lay, o, dirs, ldist, skip, d, interpret=True)
    assert np.asarray(ref).any()
    np.testing.assert_array_equal(np.asarray(blocked), np.asarray(ref))
    assert not np.asarray(blocked)[np.asarray(ldist) <= 0].any()


def test_walk_skip_inactive_and_ragged_ray_count():
    """A ray count that is not a block multiple, rays masked inactive, and
    each ray skipping its own first hit (the self-intersection skip of
    secondary rays) all match the scan under the same skips."""
    d = 3
    scene = _scene(d, n=200, seed=3)
    cfg, dev, lay = _layouts(scene)
    o, dirs = _primary(scene, 10)
    R = 77
    assert R % walk.RAY_BLOCK
    o, dirs = o[:R], dirs[:R]
    skip0 = jnp.full((R,), -1, jnp.int32)
    first = wavefront.trace_pool(dev, cfg, o, dirs, skip0)["pid"]
    active = jnp.asarray(np.arange(R) % 5 != 0)
    ref = wavefront.trace_pool(dev, cfg, o, dirs, first, active=active)
    t, pid, _ = _walk_nearest(lay, o, dirs, first, d, active=active)
    rt = np.where(np.asarray(active), np.asarray(ref["t"]), REAL_MAX)
    rpid = np.where(np.asarray(active), np.asarray(ref["pid"]), -1)
    _assert_same_hits(t, pid, rt, rpid)
    assert (pid[~np.asarray(active)] == -1).all()
    first = np.asarray(first)
    assert (first >= 0).any() and (pid != first)[first >= 0].all()


def test_walk_dead_blocks_do_no_work():
    """Blocks whose rays are all inactive visit no chunk and miss."""
    d = 3
    scene = _scene(d, n=200, seed=3)
    cfg, dev, lay = _layouts(scene)
    o, dirs = _primary(scene, 8)
    R = o.shape[0]
    rb = walk.RAY_BLOCK
    active = jnp.asarray(np.arange(R) >= rb)      # block 0 dead
    t, pid, vis = _walk_nearest(lay, o, dirs, jnp.full((R,), -1, jnp.int32),
                                d, active=active)
    assert vis[0] == 0 and (vis[1:] > 0).any()
    assert (pid[:rb] == -1).all()
    blocked, ovis = walk.occluded(lay, o, dirs,
                                  jnp.where(active, 50.0, 0.0),
                                  jnp.full((R,), -1, jnp.int32), d,
                                  interpret=True)
    assert np.asarray(ovis)[0] == 0
    assert not np.asarray(blocked)[:rb].any()


def test_walk_one_chunk_pool():
    """A pool smaller than one chunk: one chunk, padded slots never hit."""
    d = 4
    scene = _scene(d, n=10, seed=2, spread=1.0)
    cfg, dev, lay = _layouts(scene)
    assert lay["gt"].shape[0] == 1
    assert (np.asarray(lay["ids"]) == -2).any()
    o, dirs, _ = _aimed_rays(scene, 100, 2)
    skip = jnp.full((o.shape[0],), -1, jnp.int32)
    ref = wavefront.trace_pool(dev, cfg, o, dirs, skip)
    t, pid, _ = _walk_nearest(lay, o, dirs, skip, d)
    assert (pid >= 0).any()
    _assert_same_hits(t, pid, np.asarray(ref["t"]), np.asarray(ref["pid"]))


def test_shared_origin_order_matches_pool_order():
    """Front-to-back order with the hoisted shared-origin rows gives the
    same hits as pool order with per-ray origin dots, and visits no more
    chunks."""
    d = 3
    scene = _scene(d, n=400, seed=4)
    cfg, dev, lay = _layouts(scene)
    o, dirs = _primary(scene, 16)
    skip = jnp.full((o.shape[0],), -1, jnp.int32)
    order, dmin = chunks.chunk_order(lay["klo"], lay["khi"], o[0])
    sh = chunks.shared_rows(lay["gt"], lay["ci"], o[0], d)
    t1, pid1, vis1 = _walk_nearest(lay, o, dirs, skip, d, order=order,
                                   dmin=dmin, sh=sh)
    t2, pid2, vis2 = _walk_nearest(lay, o, dirs, skip, d)
    _assert_same_hits(t1, pid1, t2, pid2)
    assert vis1.sum() <= vis2.sum()


@pytest.mark.parametrize("backend,d,transparent,impl", [
    ("cpu", 4, False, "scan"),
    ("cpu", 4, True, "scan"),
    ("gpu", 4, False, "walk"),
    ("gpu", 4, True, "scan"),
    ("gpu", walk.MAX_D + 1, False, "scan"),
])
def test_trace_impl_choice(backend, d, transparent, impl):
    assert walk.trace_impl(backend, d, transparent) == impl


def test_device_scene_builds_layouts_where_walk_chosen(walk_interpret):
    """get_device_scene builds walk layouts exactly where trace_impl
    chooses the walk: opaque pools yes, transparent pools no."""
    opaque = _scene(3, n=30)
    assert wavefront._walk_ok(wavefront.get_device_scene(opaque)[1])
    nt = NTracer(3)
    glass = Material((1, 1, 1), opacity=0.5)
    clear = nt.build_composite_scene([nt.TrianglePrototype(
        [nt.Vector(0, 0, 1), nt.Vector(1, 0, 1), nt.Vector(0, 1, 1)],
        glass)])
    assert not wavefront._walk_ok(wavefront.get_device_scene(clear)[1])


def test_centroid_bins_partition_real_triangles():
    """Every real triangle lands in exactly one bin of at most CK."""
    scene = _scene(3, n=500, seed=6)
    _, _, flat = wavefront.get_device_scene(scene)
    a = flat.arrays
    fn_norm = np.linalg.norm(a["tri_fn"], axis=1)
    bins = chunks.centroid_bins(a["cull_lo"], a["cull_hi"], fn_norm)
    ids = np.concatenate([b[2] for b in bins])
    assert max(len(b[2]) for b in bins) <= chunks.CK
    np.testing.assert_array_equal(np.sort(ids), np.nonzero(fn_norm > 0)[0])


def test_prepare_cells_pads_to_common_chunk_count():
    """Padding chunks have inverted boxes (never entered), -2 ids (never
    a skip id) and miss rows in the slot pack."""
    scene = _scene(3, n=100, seed=6)
    cfg, _, flat = wavefront.get_device_scene(scene)
    a = flat.arrays
    n = len(chunks.centroid_bins(a["cull_lo"], a["cull_hi"],
                                 np.linalg.norm(a["tri_fn"], axis=1)))
    lay = wavefront._walk_dict(
        wavefront.walk_layouts(a, a["cull_lo"], a["cull_hi"], 3))
    assert lay["gt"].shape[0] == n
    pad = chunks.pad_cells(lay, n + 2)
    for k in ("gt", "ci", "ids", "klo", "khi"):
        assert pad[k].shape[0] == n + 2
        np.testing.assert_array_equal(pad[k][:n], lay[k])
    np.testing.assert_array_equal(pad["slot_pack"][:n * chunks.CK],
                                  lay["slot_pack"])
    assert pad["slot_pack"].shape[0] == (n + 2) * chunks.CK
    assert (pad["klo"][n:] > pad["khi"][n:]).all()
    assert (pad["ids"][n:] == -2).all()
    assert (pad["gt"][n:] == 0).all() and (pad["ci"][n:] == 0).all()
    assert (pad["slot_pack"][n * chunks.CK:, 3 + 1] == -1).all()


def test_chunk_order_sorted_lower_bounds():
    """chunk_order sorts chunks by distance from the origin, and each
    bound is at most the distance to any point of its chunk box."""
    rng = np.random.RandomState(1)
    lo = rng.uniform(-3, 2, (20, 4)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 1, (20, 4)).astype(np.float32)
    lo[-1], hi[-1] = chunks.BIG, -chunks.BIG           # an empty chunk
    origin = np.array([0, 0, -6, 0], np.float32)
    order, dmin = map(np.asarray, chunks.chunk_order(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(origin)))
    assert (np.diff(dmin) >= 0).all() and order[-1] == 19
    for k, c in enumerate(order[:-1]):
        pts = rng.uniform(lo[c], hi[c], (50, 4))
        assert dmin[k] <= np.linalg.norm(pts - origin, axis=1).min() + 1e-5


def test_scene_exit_matches_reference():
    """scene_exit (lane-major rays) equals a plain per-ray slab test:
    the exit distance from the pool box, scaled by the rounding margin,
    0 for rays that miss it, including rays parallel to a box axis and
    rays starting inside the box."""
    f32 = np.float32
    rng = np.random.default_rng(7)
    for d in (3, 4, 6, 8):
        o = rng.normal(size=(257, d)).astype(f32)
        dirs = rng.normal(size=(257, d)).astype(f32)
        dirs[::7, 0] = 0.0
        o[::5] *= 0.05
        b_lo = np.full((d,), -1.5, f32)
        b_hi = np.full((d,), 1.5, f32)
        got = np.asarray(chunks.scene_exit(jnp.asarray(o.T),
                                           jnp.asarray(dirs.T),
                                           jnp.asarray(b_lo),
                                           jnp.asarray(b_hi)))
        for r in range(len(o)):
            tn, tf = -np.inf, np.inf
            for c in range(d):
                if dirs[r, c] == 0:
                    if not b_lo[c] <= o[r, c] <= b_hi[c]:
                        tn = np.inf
                    continue
                inv = f32(1) / dirs[r, c]
                a = (b_lo[c] - o[r, c]) * inv
                b = (b_hi[c] - o[r, c]) * inv
                tn, tf = max(tn, min(a, b)), min(tf, max(a, b))
            hit = tf >= max(tn, 0) and tf >= 0
            want = f32(tf * (1 + 16 * chunks.ROUNDING_FUZZ)) if hit else 0
            assert got[r] == want, (d, r)


def test_ray_colors_stats(walk_interpret):
    """with_stats returns the walk's instrumentation counters: rays
    traced, chunks visited by the primary walk and by the shadow walk."""
    scene = _scene(3, n=300, seed=5)
    nt = NTracer(3)
    scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)))
    scene.set_shadows(True)
    cfg, device, _ = wavefront.get_device_scene(scene)
    o, dirs = _primary(scene, 16)
    n = o.shape[0]
    colors, stats = wavefront.ray_colors(device, cfg,
                                         wavefront._scene_dyn(scene), o,
                                         dirs, with_stats=True)
    stats = {k: int(v) for k, v in stats.items()}
    assert colors.shape == (n, 3)
    assert stats["rays_traced"] == n
    assert stats["chunks_visited"] >= 1
    assert 0 < stats["shadow_rays"] <= n
    assert stats["occl_chunks_visited"] >= 1


def test_frame_program_matmuls_are_highest():
    """Every matrix product in the lowered frame program runs at
    Precision.HIGHEST: a default-precision float32 product may take TF32
    on the GPU, which flips ROUNDING_FUZZ edge tests and solid hits."""
    from ntracer_tpu.engine import packing
    from ntracer_tpu.kdnodes import KDLeaf
    from ntracer_tpu.primitives import CUBE
    from ntracer_tpu.render import ImageFormat, Channel

    nt = NTracer(3)
    protos = [nt.TrianglePrototype(
        [nt.Vector(0, 0, 1), nt.Vector(1, 0, 1), nt.Vector(0, 1, 1)],
        Material((1, 0.5, 0.5), reflectivity=0.3))]
    protos.append(nt.SolidPrototype(CUBE, nt.Vector(0.5, 0, -2),
                                    nt.Matrix.identity(),
                                    Material((0.4, 0.9, 0.6))))
    scene = nt.CompositeScene(nt.AABB((-6, -6, -6), (6, 6, 6)),
                              KDLeaf([p.primitive for p in protos]))
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)))
    scene.set_shadows(True)
    fmt = ImageFormat(32, 32, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                               Channel(8, 0, 0, 1)])
    cfg, device, _ = wavefront.get_device_scene(scene)
    fa = wavefront._frame_args(scene, 32, 32)
    text = wavefront._frame_packed_composite.lower(
        device, cfg, fa["dyn"], fa["cam"][0], fa["cam"][1], fa["fov"],
        jnp.int32(0), 32, 1, packing.format_key(fmt)).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert len(dots) >= 6          # pool planes + solid transforms
    assert all("HIGHEST" in ln for ln in dots), dots


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(env_dir, tmp_path):
    """The compile cache follows JAX_COMPILATION_CACHE_DIR when it is set
    and is otherwise ``.jax_cache`` at the root of the checkout."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_cache")
    if env_dir:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, ntracer_tpu.engine as e; "
         "print(jax.config.jax_compilation_cache_dir); print(e.CACHE_DIR)"],
        cwd=str(tmp_path), env=dict(env, PYTHONPATH=REPO),
        capture_output=True, text=True, check=True)
    assert out.stdout.split() == [want, want]


@pytest.mark.gpu
def test_walk_compiles_for_the_gpu():
    """The walk compiles for the card (no interpreter) and matches the
    scan there; chip_smoke.py runs the same comparison at full size."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run on the card "
                    "(python chip_smoke.py)")
    d = 4
    scene = _scene(d, n=300)
    cfg, dev, flat = wavefront.get_device_scene(scene)
    assert wavefront._walk_ok(dev)
    o, dirs = _primary(scene, 64)
    skip = jnp.full((o.shape[0],), -1, jnp.int32)
    scan_dev = {k: v for k, v in dev.items() if not k.startswith("walk_")}
    ref = wavefront.trace_pool(scan_dev, cfg, o, dirs, skip)
    lay = wavefront._walk_dict(dev)
    t, slot, _ = walk.nearest_hit(lay, o, dirs, skip, d)
    gid = np.asarray(lay["slot_pack"][jnp.clip(slot, 0, None), d + 1])
    slot = np.asarray(slot)
    _assert_same_hits(np.where(slot >= 0, np.asarray(t), REAL_MAX),
                      np.where(slot >= 0, gid.astype(np.int32), -1),
                      np.asarray(ref["t"]), np.asarray(ref["pid"]))
