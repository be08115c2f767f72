"""Native C++ runtime tests: image codecs and the accumulation framebuffer
with checkpoint/resume (native/rtw_native.cpp via ctypes)."""
import os

import numpy as np
import pytest

from raytracingweekend_tpu import native
from raytracingweekend_tpu.utils import image as image_mod

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library not built")


def _test_img(h=13, w=17):
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)


def test_png_roundtrip_native(tmp_path):
    img = _test_img()
    path = str(tmp_path / "t.png")
    native.write_png(path, img)
    back = native.read_png(path)
    np.testing.assert_array_equal(back, img)


def test_png_native_matches_python_reader(tmp_path):
    # Native-encoded files must decode identically through the pure-Python
    # fallback decoder (same bits on disk, two independent decoders).
    img = _test_img()
    path = str(tmp_path / "t.png")
    native.write_png(path, img)
    via_native = native.read_png(path)

    was = native._lib
    try:
        native._lib = None
        native._tried = True  # force the python fallback in utils.image
        py = image_mod.read_png(path)           # [0,1], bottom-up
    finally:
        native._lib = was
        native._tried = True
    py_u8 = np.round(py[::-1] * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(py_u8, via_native)


def test_jpeg_roundtrip_decode(tmp_path):
    # Encode a PNG, transcode to JPEG bytes is not available natively (decode
    # only), so synthesize a JPEG with libjpeg through a tiny C call is out of
    # scope: instead verify decode against a reference JPEG if one exists.
    earth = "/root/reference/RayTracingWeekend/earth.jpg"
    if not os.path.exists(earth):
        pytest.skip("no sample jpeg available")
    img = native.read_jpeg(earth)
    assert img.ndim == 3 and img.shape[2] == 3
    assert img.shape[0] > 100 and img.shape[1] > 100
    assert img.mean() > 10  # not all black


def test_load_image_jpeg_bottom_up():
    earth = "/root/reference/RayTracingWeekend/earth.jpg"
    if not os.path.exists(earth):
        pytest.skip("no sample jpeg available")
    img = image_mod.load_image(earth)
    assert img.dtype == np.float64
    assert 0.0 <= img.min() and img.max() <= 1.0
    raw = native.read_jpeg(earth).astype(np.float64) / 255.0
    np.testing.assert_allclose(img, raw[::-1], atol=1e-12)


def test_ppm_writers_match_python(tmp_path):
    img = _test_img(8, 9)
    p6 = str(tmp_path / "a.ppm")
    native.write_ppm(p6, img, binary=True)
    back = image_mod.read_ppm(p6)            # [0,1], bottom-up
    np.testing.assert_allclose(back[::-1], img / 255.0, atol=1/255/2)


def test_framebuffer_accumulate_resolve():
    h, w = 6, 8
    with native.Framebuffer(w, h) as fb:
        rng = np.random.default_rng(1)
        c1 = rng.random((h, w, 3)).astype(np.float32)
        c2 = rng.random((h, w, 3)).astype(np.float32)
        fb.add(c1, 2)
        fb.add(c2, 2)
        assert fb.spp == 4
        acc = fb.accumulator()
        np.testing.assert_allclose(acc, c1 + c2, rtol=1e-6)
        out = fb.resolve(flip_rows=True)
    mean = (c1 + c2) / 4.0
    expect = np.clip((255.99 * np.minimum(np.sqrt(mean), 1.0)).astype(int),
                     0, 255).astype(np.uint8)[::-1]
    np.testing.assert_array_equal(out, expect)


def test_framebuffer_checkpoint_roundtrip(tmp_path):
    h, w = 5, 7
    path = str(tmp_path / "fb.ckpt")
    rng = np.random.default_rng(2)
    c = rng.random((h, w, 3)).astype(np.float32)
    with native.Framebuffer(w, h) as fb:
        fb.add(c, 3)
        fb.save(path)
    fb2 = native.Framebuffer.load(path)
    assert (fb2.w, fb2.h, fb2.spp) == (w, h, 3)
    np.testing.assert_allclose(fb2.accumulator(), c, rtol=1e-6)
    fb2.close()


def test_render_resume_is_exact(tmp_path):
    """Interrupted render + resume == uninterrupted render, bit for bit."""
    import jax
    from raytracingweekend_tpu.models import scene_types as st
    from raytracingweekend_tpu.models.builder import SceneBuilder
    from raytracingweekend_tpu.render import render
    from raytracingweekend_tpu.utils.config import RenderConfig

    b = SceneBuilder()
    b.sphere((0, 0, -2), 0.7, b.lambertian(b.constant((0.6, 0.3, 0.2))))
    b.camera((0, 0, 0), (0, 0, -1), (0, 1, 0), 60.0, 1.0, 0.0, 1.0)
    scene = b.build(background=st.BG_GRADIENT)

    base = RenderConfig(nx=8, ny=8, spp=8, max_depth=3, samples_per_launch=2)
    full = render(scene, base)

    ckpt = str(tmp_path / "r.ckpt")
    half = RenderConfig(nx=8, ny=8, spp=4, max_depth=3, samples_per_launch=2,
                        checkpoint=ckpt)
    render(scene, half)
    rest = RenderConfig(nx=8, ny=8, spp=8, max_depth=3, samples_per_launch=2,
                        checkpoint=ckpt)
    resumed = render(scene, rest)
    np.testing.assert_array_equal(np.asarray(full), np.asarray(resumed))


def test_build_without_codecs(tmp_path):
    """Without the libpng/libjpeg headers the Makefile builds with
    -DRTW_NO_CODECS: PNG/JPEG calls fail with an error, has_codecs() is 0,
    and the framebuffer (checkpoints) still works."""
    import ctypes as C
    import shutil
    import subprocess

    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++ compiler is needed to build native/"
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native", "rtw_native.cpp")
    so = str(tmp_path / "librtw_nocodecs.so")
    subprocess.run([cxx, "-O1", "-std=c++17", "-fPIC", "-shared",
                    "-DRTW_NO_CODECS", src, "-o", so, "-pthread"],
                   check=True, capture_output=True, timeout=300)
    lib = C.CDLL(so)
    assert lib.rtw_has_codecs() == 0
    lib.rtw_write_png.argtypes = [C.c_char_p, C.c_void_p, C.c_int, C.c_int]
    assert lib.rtw_write_png(str(tmp_path / "x.png").encode(), None, 1,
                             1) == -1
    lib.rtw_last_error.restype = C.c_char_p
    assert b"RTW_NO_CODECS" in lib.rtw_last_error()
    lib.rtw_fb_create.restype = C.c_void_p
    lib.rtw_fb_create.argtypes = [C.c_int, C.c_int]
    lib.rtw_fb_spp.restype = C.c_longlong
    lib.rtw_fb_spp.argtypes = [C.c_void_p]
    lib.rtw_fb_add.argtypes = [C.c_void_p, C.POINTER(C.c_float),
                               C.c_longlong]
    lib.rtw_fb_destroy.argtypes = [C.c_void_p]
    fb = lib.rtw_fb_create(2, 2)
    chunk = np.ones((2, 2, 3), np.float32)
    lib.rtw_fb_add(fb, chunk.ctypes.data_as(C.POINTER(C.c_float)), 4)
    assert lib.rtw_fb_spp(fb) == 4
    lib.rtw_fb_destroy(fb)


def test_png_io_without_codecs(tmp_path, monkeypatch):
    """A library built without codecs (as on a host lacking the libpng
    headers) sends PNG writes and reads through the Python codec."""
    monkeypatch.setattr(native, "has_codecs", lambda: False)
    canvas = np.random.default_rng(0).uniform(0.0, 1.0, (6, 9, 3))
    path = str(tmp_path / "py.png")
    image_mod.write_png(canvas, path)
    back = image_mod.read_png(path)
    np.testing.assert_allclose(back, image_mod._quantize(canvas) / 255.0,
                               atol=1e-12)
