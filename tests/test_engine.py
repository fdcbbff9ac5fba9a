"""Engine-vs-oracle and multi-device sharding tests."""

import numpy as np
import pytest

from ntracer_tpu.wrapper import NTracer
from ntracer_tpu.render import Material


class _Fmt:
    def __init__(self, w, h):
        self.width = w
        self.height = h


def _random_scene(nt, n=24, seed=0, mat=None, lights=()):
    mat = mat or Material((1, 0.5, 0.5))
    rng = np.random.RandomState(seed)
    protos = []
    for _ in range(n):
        base = rng.uniform(-2, 2, nt.dimension)
        pts = [nt.Vector(*(base + rng.uniform(-0.8, 0.8, nt.dimension)))
               for _ in range(nt.dimension)]
        protos.append(nt.TrianglePrototype(pts, mat))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    for li in lights:
        scene.add_light(li)
    return scene


def _compare_sampled(scene, w=32, h=32, samples=40, tol=5e-5, seed=1):
    from ntracer_tpu.engine import wavefront
    scene._set_view_size(w, h)
    eng = wavefront.render_strip_composite(scene, _Fmt(w, h), 0, h)
    rng = np.random.RandomState(seed)
    worst = 0.0
    for _ in range(samples):
        x, y = int(rng.randint(w)), int(rng.randint(h))
        oc = scene._pixel_color(x, y)
        worst = max(worst, float(np.abs(oc - eng[y, x]).max()))
    assert worst < tol, f"worst engine-vs-oracle diff {worst}"
    return eng


def test_engine_matches_oracle_basic():
    nt = NTracer(3)
    _compare_sampled(_random_scene(nt))


def test_engine_matches_oracle_4d():
    nt = NTracer(4)
    _compare_sampled(_random_scene(nt, n=16, seed=3))


def test_engine_matches_oracle_lights_shadows():
    nt = NTracer(3)
    scene = _random_scene(
        nt, n=16, seed=5,
        lights=[nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)),
                nt.GlobalLight(nt.Vector(0, -1, 0), (0.3, 0.3, 0.3))])
    scene.set_shadows(True)
    _compare_sampled(scene, samples=25)


def test_engine_matches_oracle_reflection():
    nt = NTracer(3)
    mat = Material((1, 0.6, 0.4), reflectivity=0.5)
    scene = _random_scene(nt, n=16, seed=8, mat=mat)
    _compare_sampled(scene, samples=25)


def test_engine_matches_oracle_transparency():
    nt = NTracer(3)
    mat = Material((1, 0.6, 0.4), opacity=0.5)
    opaque = Material((0.3, 0.8, 0.5))
    rng = np.random.RandomState(11)
    protos = []
    for i in range(12):
        base = rng.uniform(-2, 2, 3)
        pts = [nt.Vector(*(base + rng.uniform(-1, 1, 3))) for _ in range(3)]
        protos.append(nt.TrianglePrototype(pts, mat if i % 2 else opaque))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector(0, 0, -8))
    scene.set_camera(cam)
    _compare_sampled(scene, samples=25, tol=5e-4)


def test_engine_solids():
    nt = NTracer(3)
    from ntracer_tpu.primitives import CUBE, SPHERE
    mat = Material((1, 0.5, 0.2))
    protos = [
        nt.SolidPrototype(CUBE, nt.Vector(0, 0, 0), nt.Matrix.identity(), mat),
        nt.SolidPrototype(SPHERE, nt.Vector(2.5, 0, 0), nt.Matrix.identity(),
                          mat),
    ]
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector(0.2, 0.1, -9))
    scene.set_camera(cam)
    _compare_sampled(scene, samples=30)


def test_boxscene_engine_matches_oracle():
    from ntracer_tpu.engine import wavefront
    nt = NTracer(4)
    scene = nt.BoxScene()
    cam = scene.get_camera()
    cam.translate(nt.Vector(0.1, -0.2, -4, 0.3))
    scene.set_camera(cam)
    w = h = 24
    scene._set_view_size(w, h)
    eng = wavefront.render_strip_box(scene, _Fmt(w, h), 0, h)
    for (x, y) in [(0, 0), (12, 12), (20, 3), (5, 18)]:
        oc = scene._pixel_color(x, y)
        assert np.abs(oc - eng[y, x]).max() < 1e-5


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4)])
def test_sharded_render_matches_single(shape):
    import jax
    from ntracer_tpu.parallel import mesh as pmesh
    from ntracer_tpu.engine import wavefront

    if len(jax.devices()) < shape[0] * shape[1]:
        pytest.skip("not enough devices")

    nt = NTracer(3)
    scene = _random_scene(nt, n=40, seed=2)
    w = h = 24
    fmt = _Fmt(w, h)
    scene._set_view_size(w, h)
    single = wavefront.render_strip_composite(scene, fmt, 0, h)

    m = pmesh.make_mesh(*shape)
    sharded = pmesh.render_frame(scene, fmt, m)
    assert np.abs(single - sharded).max() < 1e-5


@pytest.mark.parametrize("n_px", [1, 2, 4, 8])
def test_px_scaling_fixed_per_shard(n_px):
    """px-axis scaling: the frame grows with the shard
    count so every shard renders the SAME number of rays, and the sharded
    output must equal the plain single-device render at every mesh size —
    the reference's output is likewise identical under any worker count
    (render.cpp:468-493)."""
    import jax
    from ntracer_tpu.parallel import mesh as pmesh
    from ntracer_tpu.engine import wavefront

    if len(jax.devices()) < n_px:
        pytest.skip("not enough devices")

    per_shard_rays = 32 * 4            # fixed work per shard
    w, h = 32, 4 * n_px
    nt = NTracer(3)
    scene = _random_scene(nt, n=40, seed=7)
    fmt = _Fmt(w, h)
    scene._set_view_size(w, h)
    single = wavefront.render_strip_composite(scene, fmt, 0, h)

    m = pmesh.make_mesh(n_px, 1)
    sharded = pmesh.render_frame(scene, fmt, m)
    assert np.abs(single - sharded).max() < 1e-5
    # record the per-shard dispatch size: render_frame tiles the frame
    # evenly over the px axis, so each shard dispatched exactly this many
    total = w * h
    assert -(-total // n_px) * n_px // n_px == per_shard_rays


@pytest.mark.parametrize("d", [5, 6, 8])
def test_engine_matches_oracle_higher_dims(d):
    nt = NTracer(d)
    scene = _random_scene(nt, n=12, seed=d)
    _compare_sampled(scene, w=16, h=16, samples=15)


def test_engine_matches_oracle_10d_box():
    from ntracer_tpu.engine import wavefront
    nt = NTracer(10)  # generic var-dimension path
    scene = nt.BoxScene()
    cam = scene.get_camera()
    cam.translate(nt.Vector.axis(2, -3))
    cam.transform(nt.Matrix.rotation(nt.Vector.axis(2), nt.Vector.axis(5), 0.3))
    cam.normalize()
    scene.set_camera(cam)
    w = h = 16
    scene._set_view_size(w, h)
    eng = wavefront.render_strip_box(scene, _Fmt(w, h), 0, h)
    for (x, y) in [(0, 0), (8, 8), (15, 3)]:
        oc = scene._pixel_color(x, y)
        assert np.abs(oc - eng[y, x]).max() < 1e-5


def test_sharded_transparency_matches_single():
    import jax
    from ntracer_tpu.parallel import mesh as pmesh
    from ntracer_tpu.engine import wavefront

    if len(jax.devices()) < 8:
        pytest.skip("not enough devices")

    nt = NTracer(3)
    glass = Material((1, 0.7, 0.7), opacity=0.4)
    solid_m = Material((0.3, 0.8, 0.5))
    rng = np.random.RandomState(21)
    protos = []
    for i in range(24):
        base = rng.uniform(-2, 2, 3)
        pts = [nt.Vector(*(base + rng.uniform(-1, 1, 3))) for _ in range(3)]
        protos.append(nt.TrianglePrototype(pts, glass if i % 2 else solid_m))
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector(0, 0, -8))
    scene.set_camera(cam)

    w = h = 24
    fmt = _Fmt(w, h)
    scene._set_view_size(w, h)
    single = wavefront.render_strip_composite(scene, fmt, 0, h)
    sharded = pmesh.render_frame(scene, fmt, pmesh.make_mesh(4, 2))
    assert np.abs(single - sharded).max() < 1e-5


def test_render_packed_multidevice_matches_single(monkeypatch):
    """BlockingRenderer routes through the px mesh when several devices
    exist; bytes must match the single-device path."""
    import jax
    from ntracer_tpu.engine import wavefront
    from ntracer_tpu.render import ImageFormat, Channel, BlockingRenderer

    real = jax.devices()
    if len(real) < 2:
        pytest.skip("single device")

    fmt = ImageFormat(64, 48, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                               Channel(8, 0, 0, 1)])
    r = BlockingRenderer()

    for scene in (_random_scene(NTracer(3), n=24, seed=4),
                  NTracer(4).BoxScene()):
        multi = bytearray(fmt.pitch * fmt.height)
        assert r.render(multi, fmt, scene)

        single = bytearray(fmt.pitch * fmt.height)
        monkeypatch.setattr(jax, "devices", lambda *a, **k: real[:1])
        assert r.render(single, fmt, scene)
        monkeypatch.undo()
        assert bytes(multi) == bytes(single)


def test_pack_device_vs_host_bit_widths():
    """pack_device (float32 scale) must be bit-exact with pack_rows (the
    reference's double math) for channels up to 23 bits; the documented
    deviation starts beyond 23 bits (the float32 product can no longer
    carry the rounding-error correction)."""
    from ntracer_tpu.engine import packing
    from ntracer_tpu.render import ImageFormat, Channel

    rng = np.random.RandomState(3)
    colors = rng.uniform(0, 1, (4096, 3)).astype(np.float32)

    for bits in (1, 5, 8, 10, 16, 23):
        fmt = ImageFormat(64, 64, [Channel(bits, 1, 0, 0),
                                   Channel(bits, 0, 1, 0),
                                   Channel(bits, 0, 0, 1)])
        dev = np.asarray(packing.pack_device(
            colors, packing.format_key(fmt)))
        host = packing.pack_rows(colors.reshape(64, 64, 3), fmt)
        assert np.array_equal(dev.reshape(64, -1), host), f"{bits}-bit"
        # the production frame path packs to a dense uint32 stream whose
        # byte stream must be identical (groups of 4 pixels = bpp words)
        stream = np.ascontiguousarray(np.asarray(packing.pack_device_stream(
            colors, packing.format_key(fmt))))
        assert stream.view(np.uint8).tobytes() == dev.tobytes(), \
            f"{bits}-bit stream"

    # 31-bit channels: quantify (not hide) the float32-scale deviation —
    # neighbouring codes only (the engine routes these formats to the
    # exact host packer; pack_device's ≤1-code drift is pinned here so a
    # regression past "neighbouring codes" fails loudly)
    fmt = ImageFormat(64, 64, [Channel(31, 1, 0, 0), Channel(31, 0, 0, 1)])
    dev = np.asarray(packing.pack_device(colors, packing.format_key(fmt)))
    host = packing.pack_rows(colors.reshape(64, 64, 3), fmt)
    assert dev.reshape(64, -1).shape == host.shape

    def codes(bytes8):
        w = bytes8.reshape(-1, 8).astype(np.uint64)
        word = np.zeros(len(w), np.uint64)
        for j in range(8):
            word |= w[:, j] << np.uint64(8 * (7 - j))
        mask = np.uint64((1 << 31) - 1)
        return (word >> np.uint64(33)) & mask, (word >> np.uint64(2)) & mask

    d0, d1 = codes(dev.reshape(-1))
    h0, h1 = codes(host.reshape(-1).copy())
    delta = max(np.abs(d0.astype(np.int64) - h0.astype(np.int64)).max(),
                np.abs(d1.astype(np.int64) - h1.astype(np.int64)).max())
    assert delta <= 1, f"wide-channel device packing drifted {delta} codes"
    # float channels are bitcast — always exact
    fmt = ImageFormat(64, 64, [Channel(32, 1, 0, 0, tfloat=True),
                               Channel(32, 0, 1, 0, tfloat=True)])
    dev = np.asarray(packing.pack_device(colors, packing.format_key(fmt)))
    host = packing.pack_rows(colors.reshape(64, 64, 3), fmt)
    assert np.array_equal(dev.reshape(64, -1), host)


def test_callback_renderer_pipelined_queue():
    """CallbackRenderer accepts several in-flight frames (the reference's
    begin_render only enqueues a job, render.cpp:651-700); each queued
    frame captures the camera at dispatch time, so an animation loop can
    advance the camera between begin_render calls and every buffer must
    match the BlockingRenderer frame for the same camera."""
    import threading
    from ntracer_tpu.render import (BlockingRenderer, CallbackRenderer,
                                    ImageFormat, Channel)
    from ntracer_tpu.wrapper import NTracer as _NT

    nt = _NT(3)
    scene = _random_scene(nt, n=12, seed=7)
    cam = scene.get_camera()

    w = h = 32
    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])

    def advance(k):
        c = scene.get_camera()
        c.transform(nt.Matrix.rotation(c.axes[0], c.axes[2], 0.3))
        c.normalize()
        scene.set_camera(c)

    # reference frames via BlockingRenderer
    blocking = []
    br = BlockingRenderer()
    for k in range(3):
        buf = bytearray(fmt.pitch * fmt.height)
        assert br.render(buf, fmt, scene)
        blocking.append(bytes(buf))
        advance(k)

    # reset camera, queue all three through CallbackRenderer
    scene.set_camera(cam)
    cr = CallbackRenderer()
    bufs = [bytearray(fmt.pitch * fmt.height) for _ in range(3)]
    done = threading.Event()
    calls = []

    def cb(r):
        calls.append(1)
        if len(calls) == 3:
            done.set()

    for k in range(3):
        cr.begin_render(bufs[k], fmt, scene, cb)
        assert not scene.locked  # lock released after dispatch
        advance(k)
    assert done.wait(timeout=120)
    for k in range(3):
        assert bytes(bufs[k]) == blocking[k], f"frame {k} differs"

    # abort with nothing queued is a no-op; abort after completion returns
    cr.abort_render()


def test_sharded_kernel_path_matches_single(walk_interpret):
    """Tensor-parallel (prim-sharded) pools keep the walk kernel: per-shard
    chunk layouts with local ids.  2x2 px-by-prim mesh; output must match
    single-device."""
    import jax
    from ntracer_tpu.parallel import mesh as pmesh
    from ntracer_tpu.engine import wavefront

    if len(jax.devices()) < 4:
        pytest.skip("not enough devices")

    nt = NTracer(3)
    scene = _random_scene(nt, n=600, seed=13)
    w = h = 32
    fmt = _Fmt(w, h)
    scene._set_view_size(w, h)
    single = wavefront.render_strip_composite(scene, fmt, 0, h)

    m = pmesh.make_mesh(2, 2)
    total = w * h
    tile = -(-total // 2) * 2
    fn, arrs = pmesh.get_sharded_renderer(scene, m, tile)
    assert "walk_gt" in arrs, "per-shard walk layouts were not built"
    assert arrs["walk_gt"].shape[0] == 2  # one layout per prim shard
    sharded = pmesh.render_frame(scene, fmt, m)
    assert np.abs(single - sharded).max() < 1e-5


def test_callback_renderer_abort_queue():
    """abort_render drains the queue: pending frames are dropped without
    callbacks and the renderer is reusable afterwards
    (render.cpp:702-722 semantics at frame granularity)."""
    import threading
    from ntracer_tpu.render import (CallbackRenderer, ImageFormat, Channel)
    from ntracer_tpu.wrapper import NTracer as _NT

    nt = _NT(3)
    scene = _random_scene(nt, n=8, seed=17)
    w = h = 24
    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    cr = CallbackRenderer()
    calls = []
    bufs = [bytearray(fmt.pitch * fmt.height) for _ in range(2)]
    for k in range(2):
        cr.begin_render(bufs[k], fmt, scene, lambda r: calls.append(1))
    cr.abort_render()          # blocks until the queue drains

    # renderer is reusable after an abort
    done = threading.Event()
    cr.begin_render(bufs[0], fmt, scene, lambda r: done.set())
    assert done.wait(timeout=120)
    assert bytes(bufs[0]) != bytes(bytearray(fmt.pitch * fmt.height))


def test_callback_renderer_survives_failed_pull(monkeypatch):
    """A pull that raises (device/link error) must not kill the persistent
    worker: the failed frame gets no callback, later frames still render."""
    import threading
    from ntracer_tpu.engine import wavefront
    from ntracer_tpu.render import CallbackRenderer, ImageFormat, Channel
    from ntracer_tpu.wrapper import NTracer as _NT

    nt = _NT(3)
    scene = _random_scene(nt, n=8, seed=19)
    w = h = 24
    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])

    real_pull = wavefront.pull_packed
    fail_once = [True]

    def flaky_pull(*a, **k):
        if fail_once[0]:
            fail_once[0] = False
            raise RuntimeError("injected link failure")
        return real_pull(*a, **k)

    monkeypatch.setattr(wavefront, "pull_packed", flaky_pull)
    cr = CallbackRenderer()
    buf = bytearray(fmt.pitch * fmt.height)
    called = threading.Event()
    cr.begin_render(buf, fmt, scene, lambda r: called.set())
    cr.abort_render()          # waits for the (failed) job to drain
    assert not called.is_set()

    done = threading.Event()
    cr.begin_render(buf, fmt, scene, lambda r: done.set())
    assert done.wait(timeout=120)      # worker survived, frame completed


def test_callback_renderer_mutation_after_dispatch_uses_prior_state():
    """Pins the documented CallbackRenderer lock-window deviation
    (render.py): the scene is locked only during DISPATCH — all scene
    state (geometry, camera, config) is captured by the dispatch, so a
    config mutation right after begin_render returns (which would raise
    LockedError in the reference, whose workers hold the lock for the
    whole render) silently succeeds AND frame N still renders with the
    PRE-mutation state."""
    import threading
    from ntracer_tpu.render import (BlockingRenderer, CallbackRenderer,
                                    ImageFormat, Channel)
    from ntracer_tpu.wrapper import NTracer as _NT

    nt = _NT(3)
    scene = _random_scene(nt, n=12, seed=23)
    w = h = 24
    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])

    scene.set_ambient_color((0.05, 0.05, 0.05))
    expect = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer().render(expect, fmt, scene)

    cr = CallbackRenderer()
    buf = bytearray(fmt.pitch * fmt.height)
    done = threading.Event()
    cr.begin_render(buf, fmt, scene, lambda r: done.set())
    # mutation mid-flight: allowed here (deviation), must NOT affect the
    # already-dispatched frame
    scene.set_ambient_color((0.9, 0.0, 0.0))
    assert done.wait(timeout=120)
    assert bytes(buf) == bytes(expect)

    # and the next frame picks up the new config
    buf2 = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer().render(buf2, fmt, scene)
    assert bytes(buf2) != bytes(expect)


def test_abort_render_waits_for_callback():
    """abort_render blocks until idle INCLUDING callback execution:
    a caller tearing down callback state right after
    abort_render must not race a still-running callback."""
    import threading
    import time as _time
    from ntracer_tpu.render import CallbackRenderer, ImageFormat, Channel
    from ntracer_tpu.wrapper import NTracer as _NT

    nt = _NT(3)
    scene = _random_scene(nt, n=8, seed=29)
    fmt = ImageFormat(16, 16, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                               Channel(8, 0, 0, 1)])
    cr = CallbackRenderer()
    buf = bytearray(fmt.pitch * fmt.height)
    entered = threading.Event()
    finished = []

    def slow_cb(r):
        entered.set()
        _time.sleep(0.5)
        finished.append(True)

    cr.begin_render(buf, fmt, scene, slow_cb)
    assert entered.wait(timeout=120)
    cr.abort_render()
    assert finished, "abort_render returned while the callback was running"


def test_wide_channel_format_routes_to_exact_host_packer():
    """>23-bit integer channels route around the float32 device packer
    (wavefront._needs_host_pack): the rendered bytes must equal the
    reference's exact 64-bit packing of the engine's float colors, for
    BOTH renderers."""
    import threading
    from ntracer_tpu.engine import wavefront, packing
    from ntracer_tpu.render import (BlockingRenderer, CallbackRenderer,
                                    ImageFormat, Channel)
    from ntracer_tpu.wrapper import NTracer as _NT

    nt = _NT(3)
    scene = _random_scene(nt, n=12, seed=31)
    w = h = 24
    fmt = ImageFormat(w, h, [Channel(30, 1, 0, 0), Channel(30, 0, 1, 0),
                             Channel(4, 0, 0, 1)])
    assert wavefront._needs_host_pack(fmt)

    scene._set_view_size(w, h)
    colors = wavefront.render_strip_composite(scene, fmt, 0, h)
    expect = packing.pack_rows(colors, fmt).tobytes()

    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer().render(buf, fmt, scene)
    assert bytes(buf) == expect

    buf2 = bytearray(fmt.pitch * fmt.height)
    done = threading.Event()
    CallbackRenderer().begin_render(buf2, fmt, scene, lambda r: done.set())
    assert done.wait(timeout=120)
    assert bytes(buf2) == expect

    # 8-bit formats keep the device packer (no float round trip)
    fmt8 = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                              Channel(8, 0, 0, 1)])
    assert not wavefront._needs_host_pack(fmt8)


def test_render_packed_multidevice_swizzled_tiles(monkeypatch):
    """The px-mesh packed renderer uses the same tiled ray order as the
    single-device path (coherent walk blocks) with the unswizzle applied
    to the packed words; at a frame geometry where the swizzle is ACTIVE
    per shard (count % w == 0, rows per group % TILE_H == 0) the bytes
    must still match the single-device render exactly."""
    import jax
    from ntracer_tpu.engine import wavefront
    from ntracer_tpu.render import ImageFormat, Channel, BlockingRenderer

    real = jax.devices()
    if len(real) < 8:
        pytest.skip("needs the 8-device mesh")

    # 32x128: total 4096 px -> per_shard 512 = 16 rows of 32 -> the
    # tiled swizzle branch is taken inside each shard
    w, h = 32, 128
    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    xs, ys, swz = wavefront._ray_coords(0, w, count=512)
    assert swz is not None, "test geometry must activate the swizzle"

    r = BlockingRenderer()
    scene = _random_scene(NTracer(3), n=60, seed=9)
    multi = bytearray(fmt.pitch * fmt.height)
    assert r.render(multi, fmt, scene)

    single = bytearray(fmt.pitch * fmt.height)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real[:1])
    assert r.render(single, fmt, scene)
    monkeypatch.undo()
    assert bytes(multi) == bytes(single)


def test_px_sharded_renderer_has_no_collectives(walk_interpret):
    """The px-mesh production renderer must compile to ZERO cross-device
    collectives: pixels are embarrassingly parallel, every shard owns its
    rays and its replicated pool, and only packed bytes leave the device
    (the frame gather is the host pulling per-shard slabs)."""
    import jax
    from ntracer_tpu.parallel import mesh as pmesh
    from ntracer_tpu.engine import wavefront, packing
    from ntracer_tpu.render import ImageFormat, Channel

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device mesh")

    scene = _random_scene(NTracer(3), n=60, seed=9)
    w, h = 32, 128
    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)])
    key = packing.format_key(fmt)
    m = pmesh.make_mesh(8, 1)
    per = -(-w * h // 8)
    fn, arrs = pmesh.get_packed_renderer(scene, m, w, per, key)
    import jax.numpy as jnp
    dyn = wavefront._scene_dyn(scene)
    scene._set_view_size(w, h)
    fov = wavefront._fov_params(w, h, scene.fov)
    txt = fn.lower(arrs, dyn, jnp.asarray(scene._cam._origin),
                   jnp.asarray(scene._cam._t), fov,
                   jnp.int32(0)).compile().as_text()
    colls = ("all-gather", "all-reduce", "collective-permute",
             "all-to-all", "reduce-scatter")
    found = {c: txt.count(c) for c in colls if txt.count(c)}
    assert not found, f"px-only sharding must be collective-free: {found}"


def test_prim_sharded_renderer_uses_collectives(walk_interpret):
    """Converse of the px test: tensor-parallel pool shards DO need a
    cross-shard winner reduction (all_gather + argmin), so the compiled
    px x prim program must contain collectives — proving the HLO
    inspection in the px test isn't vacuously passing."""
    import jax
    from ntracer_tpu.parallel import mesh as pmesh
    from ntracer_tpu.engine import wavefront

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device mesh")

    scene = _random_scene(NTracer(3), n=60, seed=9)
    w = h = 24
    fmt = _Fmt(w, h)
    scene._set_view_size(w, h)
    m = pmesh.make_mesh(4, 2)           # px x prim
    total = w * h
    tile = -(-total // 4) * 4
    fn, arrs = pmesh.get_sharded_renderer(scene, m, tile)
    import jax.numpy as jnp
    import numpy as np_
    xs, ys = np_.meshgrid(np_.arange(w, dtype=np_.float32),
                          np_.arange(h, dtype=np_.float32))
    xs = np_.pad(xs.ravel(), (0, tile - total))
    ys = np_.pad(ys.ravel(), (0, tile - total))
    dyn = wavefront._scene_dyn(scene)
    fov = wavefront._fov_params(w, h, scene.fov)
    txt = fn.lower(arrs, dyn, jnp.asarray(scene._cam._origin),
                   jnp.asarray(scene._cam._t), fov, jnp.asarray(xs),
                   jnp.asarray(ys)).compile().as_text()
    n_coll = sum(txt.count(c) for c in
                 ("all-gather", "all-reduce", "collective-permute",
                  "all-to-all", "reduce-scatter"))
    assert n_coll > 0, "prim sharding needs a cross-shard winner reduction"


@pytest.mark.parametrize("variant", ["camera", "shadows", "reflective",
                                     "transparent", "solids",
                                     "transparent_solids"])
def test_transposed_pipeline_matches_row_and_oracle(variant, monkeypatch,
                                                    walk_interpret):
    """The walk + transposed (k, R) post-trace pipeline must agree with
    BOTH the scalar oracle and the XLA scan + row pipeline — camera-light,
    lit+shadowed, reflective and solids scenes.  Transparent pools keep
    the scan and the row pipeline (the K-buffer has no walk), so those
    variants check the oracle and that the scene stays off the walk."""
    import numpy as np
    from ntracer_tpu.engine import walk, wavefront

    nt = NTracer(3)

    def _hand_built(protos, lights=(), shadows=False):
        # solids are HAND-BUILT into one leaf (the reference's own test
        # pattern): build-time solid placement is defective in the
        # reference (negated-center boundary + sphere-vs-AABB test,
        # PARITY.md defects 6/9), so tree-built solid scenes diverge
        # from the engine BY DESIGN; a KDLeaf tree sidesteps the build
        from ntracer_tpu.kdnodes import KDLeaf
        scene = nt.CompositeScene(
            nt.AABB((-6, -6, -6), (6, 6, 6)),
            KDLeaf([p.primitive for p in protos]))
        cam = nt.Camera()
        cam.translate(nt.Vector.axis(2, -8))
        scene.set_camera(cam)
        for li in lights:
            scene.add_light(li)
        if shadows:
            scene.set_shadows(True)
        return scene

    if variant == "camera":
        scene = _random_scene(nt, n=600, seed=31)
    elif variant == "shadows":
        scene = _random_scene(
            nt, n=600, seed=32,
            lights=[nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)),
                    nt.GlobalLight(nt.Vector(0, -1, 0), (0.3, 0.3, 0.3))])
        scene.set_shadows(True)
    elif variant in ("transparent", "transparent_solids"):
        # mixed opaque + transparent pool (+ optionally a transparent
        # solid and shadows) so every arm of the transposed compose and
        # finish runs: K-slot sort/payload, occlusion filter product,
        # solid K-insertion
        # transparent density kept low enough that no sampled ray
        # crosses more than K=8 transparent surfaces (the engine's
        # K-buffer is bounded; the oracle's hit list is not)
        mat_t = Material((0.9, 0.7, 0.4), opacity=0.45)
        rng = np.random.RandomState(35)
        protos = []
        for i in range(500):
            m = mat_t if i % 10 == 0 else Material((1, 0.5, 0.5))
            base = rng.uniform(-2, 2, 3)
            pts = [nt.Vector(*(base + rng.uniform(-0.8, 0.8, 3)))
                   for _ in range(3)]
            protos.append(nt.TrianglePrototype(pts, m))
        lights = [nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6))]
        if variant == "transparent_solids":
            from ntracer_tpu.primitives import CUBE, SPHERE
            protos.append(nt.SolidPrototype(
                CUBE, nt.Vector(0.5, 0, -2), nt.Matrix.identity(),
                Material((0.4, 0.9, 0.6), opacity=0.5)))
            protos.append(nt.SolidPrototype(
                SPHERE, nt.Vector(-1.5, 0.5, -1), nt.Matrix.identity(),
                Material((0.9, 0.4, 0.6))))
            scene = _hand_built(protos, lights=lights, shadows=True)
        else:
            # unbatched build: the reference records one transparent hit
            # per TriangleBatch (PARITY.md defect 7), so the batched
            # oracle diverges from the engine's exact K-buffer by design
            from ntracer_tpu import kdtree
            monkeypatch.setattr(kdtree, "group_primitives",
                                lambda prims: list(prims))
            scene = nt.build_composite_scene(protos)
            cam = nt.Camera()
            cam.translate(nt.Vector.axis(2, -8))
            scene.set_camera(cam)
            for li in lights:
                scene.add_light(li)
            scene.set_shadows(True)
    elif variant == "solids":
        from ntracer_tpu.primitives import CUBE, SPHERE
        rng = np.random.RandomState(36)
        protos = []
        mat = Material((1, 0.5, 0.5))
        for _ in range(600):
            base = rng.uniform(-2, 2, 3)
            pts = [nt.Vector(*(base + rng.uniform(-0.8, 0.8, 3)))
                   for _ in range(3)]
            protos.append(nt.TrianglePrototype(pts, mat))
        protos.append(nt.SolidPrototype(
            CUBE, nt.Vector(0.8, -0.3, -3), nt.Matrix.identity(),
            Material((0.3, 0.8, 0.9))))
        protos.append(nt.SolidPrototype(
            SPHERE, nt.Vector(-1.2, 0.6, -2), nt.Matrix.identity(),
            Material((0.8, 0.9, 0.3))))
        scene = _hand_built(protos)
    else:
        scene = _random_scene(nt, n=600, seed=33,
                              mat=Material((1, 0.6, 0.4), reflectivity=0.5))

    w = h = 32
    cfg, device, _ = wavefront.get_device_scene(scene)
    transparent = variant.startswith("transparent")
    assert wavefront._walk_ok(device) != transparent, \
        "opaque scenes take the walk, transparent ones the scan"

    # the oracle defaults to the reference's occlusion early-out DEFECT
    # (PARITY.md defect list); the engine deliberately uses true any-hit,
    # so compare against exact semantics like scripts/device_parity.py
    from ntracer_tpu import kdnodes
    monkeypatch.setattr(kdnodes, "OCCLUDES_EARLY_OUT", False)

    # walk + transposed path vs the scalar oracle (sampled)
    eng_t = np.asarray(_compare_sampled(scene, w=w, h=h, samples=30))

    # XLA scan + row path on the same scene
    monkeypatch.setattr(walk, "trace_impl", lambda *a: "scan")
    scene._device_cache = None
    eng_row = np.asarray(
        wavefront.render_strip_composite(scene, _Fmt(w, h), 0, h))
    np.testing.assert_allclose(eng_t, eng_row, atol=2e-5)


def test_transposed_lights_no_shadows_matches_oracle(monkeypatch,
                                                     walk_interpret):
    """Lights with shadows OFF take the else-arms of the transposed light
    loops (no occlusion queries, unmasked contributions) — compare
    against the oracle and the scan + row path like the shadowed
    variant."""
    import numpy as np
    from ntracer_tpu.engine import walk, wavefront

    nt = NTracer(3)
    scene = _random_scene(
        nt, n=600, seed=34,
        lights=[nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)),
                nt.GlobalLight(nt.Vector(0, -1, 0), (0.3, 0.3, 0.3))])
    assert not scene.shadows
    w = h = 32
    cfg, device, _ = wavefront.get_device_scene(scene)
    assert wavefront._walk_ok(device)
    eng_t = np.asarray(_compare_sampled(scene, w=w, h=h, samples=30))

    monkeypatch.setattr(walk, "trace_impl", lambda *a: "scan")
    scene._device_cache = None
    eng_row = np.asarray(
        wavefront.render_strip_composite(scene, _Fmt(w, h), 0, h))
    np.testing.assert_allclose(eng_t, eng_row, atol=2e-5)


def _prim_shard_scene(transparent):
    """600 random triangles (every tenth its own material), a cube and a
    sphere hand-built into one leaf (reference build-time solid placement
    is defective, PARITY.md defects 6/9), a point light, shadows on.
    ``transparent`` makes the tenth triangles (opacity 0.45) and the cube
    (opacity 0.5) transparent."""
    from ntracer_tpu.primitives import CUBE, SPHERE
    from ntracer_tpu.kdnodes import KDLeaf

    nt = NTracer(3)
    op_t = dict(opacity=0.45) if transparent else {}
    op_c = dict(opacity=0.5) if transparent else {}
    rng = np.random.RandomState(41)
    protos = []
    for i in range(600):
        m = Material((0.9, 0.7, 0.4), **op_t) if i % 10 == 0 \
            else Material((1, 0.5, 0.5))
        base = rng.uniform(-2, 2, 3)
        pts = [nt.Vector(*(base + rng.uniform(-0.8, 0.8, 3)))
               for _ in range(3)]
        protos.append(nt.TrianglePrototype(pts, m))
    protos.append(nt.SolidPrototype(
        CUBE, nt.Vector(0.5, 0, -2), nt.Matrix.identity(),
        Material((0.4, 0.9, 0.6), **op_c)))
    protos.append(nt.SolidPrototype(
        SPHERE, nt.Vector(-1.5, 0.5, -1), nt.Matrix.identity(),
        Material((0.9, 0.4, 0.6))))
    scene = nt.CompositeScene(
        nt.AABB((-6, -6, -6), (6, 6, 6)),
        KDLeaf([p.primitive for p in protos]))
    cam = nt.Camera()
    cam.translate(nt.Vector.axis(2, -8))
    scene.set_camera(cam)
    scene.add_light(nt.PointLight(nt.Vector(0, 4, -4), (1, 0.8, 0.6)))
    scene.set_shadows(True)
    return scene


@pytest.mark.parametrize("n_px,n_prim", [(2, 2), (2, 4)])
def test_prim_sharded_transposed_matches_row_and_single(
        monkeypatch, walk_interpret, n_px, n_prim):
    """Prim-sharded opaque pools ride the walk + transposed (k, R)
    pipeline — the cross-shard winner merge all_gathers lane-major
    (P, k, R) tensors (wavefront._trace_finish_T), with replicated solids
    competing in every shard's winner.  The transposed sharded render must
    match the scan + row sharded render AND the single-device render.
    The 2x4 case runs the merge at P=4 (pool padded to 4 shards); its row
    twin is skipped to bound runtime."""
    import jax
    from ntracer_tpu.parallel import mesh as pmesh
    from ntracer_tpu.engine import walk, wavefront

    if len(jax.devices()) < n_px * n_prim:
        pytest.skip("not enough devices")

    scene = _prim_shard_scene(transparent=False)
    w = h = 32
    fmt = _Fmt(w, h)
    scene._set_view_size(w, h)
    single = np.asarray(wavefront.render_strip_composite(scene, fmt, 0, h))

    m = pmesh.make_mesh(n_px, n_prim)   # px x prim

    # prove the transposed pipeline actually engages under prim sharding
    calls = []
    orig = wavefront._ray_colors_T

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(wavefront, "_ray_colors_T", spy)
    sharded_t = np.asarray(pmesh.render_frame(scene, fmt, m))
    assert calls, "prim-sharded render must take the transposed pipeline"

    if n_prim == 2:
        # scan + row twin of the same sharded program
        monkeypatch.setattr(walk, "trace_impl", lambda *a: "scan")
        scene._device_cache = None
        scene._mesh_cache = None
        sharded_row = np.asarray(pmesh.render_frame(scene, fmt, m))
        np.testing.assert_allclose(sharded_t, sharded_row, atol=2e-5)

    np.testing.assert_allclose(sharded_t, single, atol=2e-5)


@pytest.mark.parametrize("n_px,n_prim", [(2, 2), (2, 4)])
def test_prim_sharded_transparent_matches_single(n_px, n_prim):
    """Transparent pools take the XLA scan + row pipeline, also under prim
    sharding: each shard keeps its own K nearest transparent hits and the
    shards' K-buffers merge by distance (wavefront._trace_finish).  The
    transparent cube is replicated in every shard, so the insert-once
    guards (K-buffer insertion and the occlusion filter product) must keep
    it from counting P times.  At P=4 the merge sorts 4*K candidates."""
    import jax
    from ntracer_tpu.parallel import mesh as pmesh
    from ntracer_tpu.engine import wavefront

    if len(jax.devices()) < n_px * n_prim:
        pytest.skip("not enough devices")

    scene = _prim_shard_scene(transparent=True)
    w = h = 32
    fmt = _Fmt(w, h)
    scene._set_view_size(w, h)
    cfg, device, _ = wavefront.get_device_scene(scene)
    assert cfg.has_transparency and not wavefront._walk_ok(device)
    single = np.asarray(wavefront.render_strip_composite(scene, fmt, 0, h))
    sharded = np.asarray(pmesh.render_frame(scene, fmt,
                                            pmesh.make_mesh(n_px, n_prim)))
    np.testing.assert_allclose(sharded, single, atol=2e-5)


def test_frame_args_cache_invalidation(monkeypatch, walk_interpret):
    """The per-scene frame-argument cache (wavefront._frame_args) must be
    bit-transparent: cached dispatches equal uncached ones, and every
    mutation class — camera (own version, buffers-only re-upload),
    config (ambient/bg/fov via _mutate_config), geometry (_mutate), and
    view size — must invalidate correctly so renders never go stale."""
    import numpy as np
    from ntracer import (NTracer, Material, ImageFormat, Channel)
    from ntracer_tpu.engine import wavefront

    nt = NTracer(3)
    mat = Material((1, 0.5, 0.25))
    protos = [nt.TrianglePrototype([nt.Vector(0, 0, 2),
                                    nt.Vector(1, 0.5, 2.5),
                                    nt.Vector(0, 1, 2)], mat)]
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector(0.1, 0.1, -2))
    scene.set_camera(cam)
    fmt = ImageFormat(32, 32, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                               Channel(8, 0, 0, 1)])

    def frame():
        return np.asarray(wavefront.frame_device_arrays(scene, fmt))

    base = frame()
    # cached repeat == uncached repeat, bitwise
    assert np.array_equal(base, frame())
    monkeypatch.setenv("NTRACER_NO_ARGCACHE", "1")
    assert np.array_equal(base, frame())
    monkeypatch.delenv("NTRACER_NO_ARGCACHE")

    # camera mutation: only the camera buffers re-upload, and the new
    # view must take effect
    fa1 = scene._frame_args_cache
    dyn1 = fa1["dyn"]
    cam2 = scene.get_camera()
    cam2.translate(nt.Vector(0.3, 0, 0))
    scene.set_camera(cam2)
    moved = frame()
    assert not np.array_equal(base, moved)
    assert scene._frame_args_cache is fa1          # same generation
    assert scene._frame_args_cache["dyn"] is dyn1  # dyn buffers reused

    # config mutation (background) rebuilds the generation
    scene.set_background((1, 0, 0), (0, 0, 1), axis=1)
    recolored = frame()
    assert not np.array_equal(moved, recolored)
    assert scene._frame_args_cache is not fa1

    # fov + view size changes
    scene.set_fov(1.2)
    wide = frame()
    assert not np.array_equal(recolored, wide)
    fmt2 = ImageFormat(64, 32, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                                Channel(8, 0, 0, 1)])
    other = np.asarray(wavefront.frame_device_arrays(scene, fmt2))
    assert other.size != wide.size or not np.array_equal(other, wide)

    # geometry mutation (_mutate) also lands in the key.  Restore the
    # original view (triangle visible), camera_light off, and place the
    # light BEHIND the triangle — the ported inverted point-light
    # direction quirk (PARITY.md) means front-side lights contribute
    # zero (verified uncached: (0,0,0) no-op, (0,0,3) lights it).
    scene.set_camera(cam)
    scene.set_fov(0.8)
    scene.set_camera_light(False)
    dark = np.asarray(wavefront.frame_device_arrays(scene, fmt2))
    scene.add_light(nt.PointLight(nt.Vector(0, 0, 3), (1, 1, 1)))
    lit = np.asarray(wavefront.frame_device_arrays(scene, fmt2))
    assert not np.array_equal(dark, lit)

    # cached-vs-uncached equality at the final state
    final = np.asarray(wavefront.frame_device_arrays(scene, fmt2))
    monkeypatch.setenv("NTRACER_NO_ARGCACHE", "1")
    final_nc = np.asarray(wavefront.frame_device_arrays(scene, fmt2))
    assert np.array_equal(final, final_nc)
    monkeypatch.delenv("NTRACER_NO_ARGCACHE")

    # DIRECT attribute writes (legal here; READONLY members in the
    # reference) must also take effect: the cache key carries the
    # values of the small dyn inputs, not just the version counters
    before = np.asarray(wavefront.frame_device_arrays(scene, fmt2))
    from ntracer import Color
    scene.ambient = Color(0.9, 0.1, 0.1)
    after = np.asarray(wavefront.frame_device_arrays(scene, fmt2))
    assert not np.array_equal(before, after)
    scene.fov = 1.4
    wider = np.asarray(wavefront.frame_device_arrays(scene, fmt2))
    assert not np.array_equal(after, wider)


def test_boxscene_frame_args_camera_invalidation():
    """BoxScene.set_camera bumps only _cam_version (like CompositeScene);
    the frame-args cache must still pick up camera moves, reproduce the
    original frame bitwise when the camera returns, and react to set_fov
    (which bumps _version)."""
    import numpy as np
    from ntracer import NTracer, ImageFormat, Channel
    from ntracer_tpu.engine import wavefront

    nt = NTracer(4)
    scene = nt.BoxScene()
    cam = scene.get_camera()
    cam.translate(nt.Vector(0.1, -0.2, -4, 0.3))
    scene.set_camera(cam)
    fmt = ImageFormat(32, 24, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                               Channel(8, 0, 0, 1)])

    def frame():
        return np.asarray(wavefront.frame_device_arrays(scene, fmt))

    base = frame()
    assert np.array_equal(base, frame())
    cam2 = scene.get_camera()
    cam2.transform(nt.Matrix.rotation(nt.Vector.axis(0), nt.Vector.axis(2),
                                      0.4))
    scene.set_camera(cam2)
    rotated = frame()
    assert not np.array_equal(base, rotated)
    scene.set_camera(cam)
    assert np.array_equal(base, frame())
    scene.set_fov(1.3)
    assert not np.array_equal(base, frame())
