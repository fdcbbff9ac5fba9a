"""App-level flows: OBJ loading, scene copy, renderer contracts."""

import copy
import os
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "scripts"))

from ntracer_tpu.wrapper import NTracer
from ntracer_tpu.render import (Material, ImageFormat, Channel,
                                BlockingRenderer, LockedError)
from ntracer_tpu.wavefront_obj import load_obj, FileFormatError

OBJ = """\
# tiny tetrahedron
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
f 1 2 3
f 1 2 4
f 1 3 4
f 2 3 4
"""


def test_load_obj_and_render(tmp_path):
    path = tmp_path / "tet.obj"
    path.write_text(OBJ)
    nt = NTracer(3)
    protos = load_obj(str(path), nt)
    assert len(protos) == 4
    scene = nt.build_composite_scene(protos)
    cam = nt.Camera()
    cam.translate(nt.Vector(0.2, 0.2, -3))
    scene.set_camera(cam)
    fmt = ImageFormat(32, 32, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                               Channel(8, 0, 0, 1)])
    buf = bytearray(fmt.pitch * fmt.height)
    assert BlockingRenderer().render(buf, fmt, scene)
    img = np.frombuffer(bytes(buf), np.uint8).reshape(32, 32, 3)
    assert img.max() > 0


def test_load_obj_negative_indices(tmp_path):
    path = tmp_path / "neg.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    protos = load_obj(str(path))
    assert len(protos) == 1


def test_load_obj_bad(tmp_path):
    path = tmp_path / "bad.obj"
    path.write_text("v zero zero zero\n")
    with pytest.raises(FileFormatError):
        load_obj(str(path))


def test_load_obj_wrong_dimension(tmp_path):
    path = tmp_path / "t.obj"
    path.write_text(OBJ)
    with pytest.raises(ValueError):
        load_obj(str(path), NTracer(4))


def test_scene_copy():
    nt = NTracer(3)
    mat = Material((1, 0.5, 0.5))
    protos = [nt.TrianglePrototype([(0, 0, 1), (1, 0, 1), (0, 1, 1)], mat)]
    scene = nt.build_composite_scene(protos)
    scene.set_fov(1.1)
    scene.add_light(nt.PointLight(nt.Vector(0, 2, 0), (1, 1, 1)))
    c = copy.copy(scene)
    assert c.fov == scene.fov
    assert len(c.point_lights) == 1
    assert c.root is not scene.root
    # the copy renders independently while the original is locked
    scene._lock()
    try:
        with pytest.raises(LockedError):
            scene.set_fov(0.5)
        c.set_fov(0.5)  # copy unaffected by the original's lock
    finally:
        scene._unlock()


def test_pitched_and_reversed_formats():
    nt = NTracer(3)
    scene = nt.BoxScene()
    w, h = 16, 8
    fmt = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                             Channel(8, 0, 0, 1)], pitch=w * 3 + 13)
    buf = bytearray(fmt.pitch * h)
    assert BlockingRenderer().render(buf, fmt, scene)

    fmt_r = ImageFormat(w, h, [Channel(8, 1, 0, 0), Channel(8, 0, 1, 0),
                               Channel(8, 0, 0, 1)], reversed=True)
    buf_r = bytearray(fmt_r.pitch * h)
    assert BlockingRenderer().render(buf_r, fmt_r, scene)
    a = np.frombuffer(bytes(buf), np.uint8).reshape(h, fmt.pitch)[:, :w * 3]
    b = np.frombuffer(bytes(buf_r), np.uint8).reshape(h, w * 3)
    # reversed byte order per pixel
    assert np.array_equal(a.reshape(h, w, 3)[..., ::-1], b.reshape(h, w, 3))


def test_float_channel_format():
    nt = NTracer(3)
    scene = nt.BoxScene()
    w, h = 16, 8
    fmt = ImageFormat(w, h, [Channel(32, 1, 0, 0, tfloat=True)])
    buf = bytearray(fmt.pitch * h)
    assert BlockingRenderer().render(buf, fmt, scene)
    vals = np.frombuffer(bytes(buf), dtype=">f4").reshape(h, w)
    assert np.isfinite(vals).all() and vals.max() <= 1.0


def test_polytope_png_output(tmp_path):
    """polytope.py --output DIR -t png writes frame0000.png... into the
    directory (reference polytope.py:650-652; a path-concatenation bug
    once wrote mangled names next to the directory instead)."""
    import subprocess
    import sys

    out = tmp_path / "anim"
    out.mkdir()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SDL_VIDEODRIVER="dummy")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "polytope.py"),
         "4", "3", "--output", str(out), "-t", "png", "-s", "48x48",
         "-f", "1"],
        capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, r.stderr[-500:]
    files = sorted(p.name for p in out.iterdir())
    assert files == ["frame0000.png"]


def test_polytope_ffmpeg_pipe_rgb48be(tmp_path):
    """polytope.py --output FILE -t <codec> pipes 16-bit big-endian
    frames (rgb48be) to the encoder like the reference
    (polytope.py:597-608).  ffmpeg isn't in the image, so a stub on
    PATH dumps the raw pipe; the stream must decode as >u2 RGB whose
    high bytes match the 8-bit PNG frame of the same view within 1."""
    import subprocess
    import sys

    import numpy as np
    from PIL import Image

    w = h = 32
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SDL_VIDEODRIVER="dummy")

    png_dir = tmp_path / "png"
    png_dir.mkdir()
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "polytope.py"),
         "4", "3", "--output", str(png_dir), "-t", "png", "-s",
         f"{w}x{h}", "-f", "1"],
        capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, r.stderr[-500:]
    png = np.asarray(Image.open(png_dir / "frame0000.png"))

    fake_bin = tmp_path / "bin"
    fake_bin.mkdir()
    raw_out = tmp_path / "video.raw"
    stub = fake_bin / "ffmpeg"
    stub.write_text("#!/bin/sh\nfor a in \"$@\"; do out=\"$a\"; done\n"
                    "cat > \"$out\"\n")
    stub.chmod(0o755)
    env_v = dict(env, PATH=f"{fake_bin}:{env.get('PATH', '')}")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "polytope.py"),
         "4", "3", "--output", str(raw_out), "-t", "libx264", "-s",
         f"{w}x{h}", "-f", "1"],
        capture_output=True, text=True, timeout=900, env=env_v)
    assert r.returncode == 0, r.stderr[-500:]

    raw = raw_out.read_bytes()
    assert len(raw) == w * h * 6          # one rgb48be frame
    u16 = np.frombuffer(raw, ">u2").reshape(h, w, 3)
    assert u16.any()
    hi = (u16 >> 8).astype(np.int32)
    assert np.abs(hi - png.astype(np.int32)).max() <= 1


def test_polytope_benchmark_pipelined(tmp_path):
    """polytope.py --benchmark drives the pipelined CallbackRenderer path
    (several frames in flight); it must complete and report stats."""
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SDL_VIDEODRIVER="dummy")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "polytope.py"),
         "4", "3", "--benchmark", "-s", "48x48", "-f", "5"],
        capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, r.stderr[-500:]
    assert "rendered 5 frame(s)" in r.stdout
    assert "frames per second" in r.stdout


def test_hypercube_benchmark():
    """hypercube.py --benchmark renders the BoxScene animation and
    reports stats (the interactive UI is pygame-only; the benchmark mode
    is the CI-runnable slice)."""
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu",
               SDL_VIDEODRIVER="dummy")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "hypercube.py"),
         "-d", "4", "--benchmark", "-s", "48x48", "-f2", "3"],
        capture_output=True, text=True, timeout=900, env=env)
    assert r.returncode == 0, r.stderr[-500:]
    assert "rendered 3 frame(s)" in r.stdout
