"""ctypes bindings for the C++ native runtime (native/rtw_native.cpp).

The reference's runtime is C++ (render driver + PPM writer + ImageMagick
shell-out, RayTracingWeekend.cpp:162-289); this module binds the framework's
native equivalent: libpng/libjpeg image codecs and the multithreaded
accumulation framebuffer with checkpoint/resume. Everything degrades
gracefully — `available()` is False when the shared library hasn't been
built (`make -C native`), `has_codecs()` is False when it was built without
libpng/libjpeg, and pure-Python fallbacks in utils.image take over.
"""
from __future__ import annotations

import ctypes as C
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SO = os.path.join(_HERE, "native", "librtw_native.so")

_lib: Optional[C.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", os.path.join(_HERE, "native")],
                       check=True, capture_output=True, timeout=120)
        return os.path.exists(_SO)
    except Exception:
        return False


def _load() -> Optional[C.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) and not _build():
        return None
    try:
        lib = C.CDLL(_SO)
    except OSError:
        return None

    u8p = C.POINTER(C.c_ubyte)
    f32p = C.POINTER(C.c_float)
    lib.rtw_last_error.restype = C.c_char_p
    lib.rtw_has_codecs.restype = C.c_int
    lib.rtw_write_png.argtypes = [C.c_char_p, u8p, C.c_int, C.c_int]
    lib.rtw_png_size.argtypes = [C.c_char_p, C.POINTER(C.c_int),
                                 C.POINTER(C.c_int)]
    lib.rtw_read_png.argtypes = [C.c_char_p, u8p, C.c_int, C.c_int]
    lib.rtw_jpeg_size.argtypes = lib.rtw_png_size.argtypes
    lib.rtw_read_jpeg.argtypes = lib.rtw_read_png.argtypes
    lib.rtw_write_ppm6.argtypes = lib.rtw_write_png.argtypes
    lib.rtw_write_ppm3.argtypes = lib.rtw_write_png.argtypes
    lib.rtw_fb_create.restype = C.c_void_p
    lib.rtw_fb_create.argtypes = [C.c_int, C.c_int]
    lib.rtw_fb_destroy.argtypes = [C.c_void_p]
    lib.rtw_fb_width.argtypes = [C.c_void_p]
    lib.rtw_fb_width.restype = C.c_int
    lib.rtw_fb_height.argtypes = [C.c_void_p]
    lib.rtw_fb_height.restype = C.c_int
    lib.rtw_fb_spp.argtypes = [C.c_void_p]
    lib.rtw_fb_spp.restype = C.c_longlong
    lib.rtw_fb_add.argtypes = [C.c_void_p, f32p, C.c_longlong]
    lib.rtw_fb_resolve.argtypes = [C.c_void_p, u8p, C.c_int]
    lib.rtw_fb_save.argtypes = [C.c_void_p, C.c_char_p]
    lib.rtw_fb_save.restype = C.c_int
    lib.rtw_fb_load.argtypes = [C.c_char_p]
    lib.rtw_fb_load.restype = C.c_void_p
    lib.rtw_fb_data.argtypes = [C.c_void_p]
    lib.rtw_fb_data.restype = f32p
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def has_codecs() -> bool:
    """True when the library was built with libpng/libjpeg (see Makefile)."""
    lib = _load()
    return lib is not None and bool(lib.rtw_has_codecs())


def _check(rc: int, what: str) -> None:
    if rc != 0:
        err = _load().rtw_last_error().decode()
        raise IOError(f"{what}: {err}")


def _as_u8(img: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(img, dtype=np.uint8)
    assert a.ndim == 3 and a.shape[2] == 3, a.shape
    return a


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(C.POINTER(C.c_ubyte))


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    """rgb_u8: (h, w, 3) uint8, row 0 = image top."""
    a = _as_u8(rgb_u8)
    h, w, _ = a.shape
    _check(_load().rtw_write_png(path.encode(), _u8ptr(a), w, h), "write_png")


def read_png(path: str) -> np.ndarray:
    lib = _load()
    w, h = C.c_int(), C.c_int()
    _check(lib.rtw_png_size(path.encode(), C.byref(w), C.byref(h)), "png_size")
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.rtw_read_png(path.encode(), _u8ptr(out), w.value, h.value),
           "read_png")
    return out


def read_jpeg(path: str) -> np.ndarray:
    lib = _load()
    w, h = C.c_int(), C.c_int()
    _check(lib.rtw_jpeg_size(path.encode(), C.byref(w), C.byref(h)),
           "jpeg_size")
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.rtw_read_jpeg(path.encode(), _u8ptr(out), w.value, h.value),
           "read_jpeg")
    return out


def write_ppm(path: str, rgb_u8: np.ndarray, binary: bool = True) -> None:
    a = _as_u8(rgb_u8)
    h, w, _ = a.shape
    fn = _load().rtw_write_ppm6 if binary else _load().rtw_write_ppm3
    _check(fn(path.encode(), _u8ptr(a), w, h), "write_ppm")


class Framebuffer:
    """Multithreaded accumulation framebuffer with checkpoint/resume.

    Accumulates per-chunk radiance *sums* (canvas layout: row 0 = image
    bottom); `resolve()` averages + gamma-2 + quantizes exactly like the
    reference postprocess (RayTracingWeekend.cpp:241-244,268-270) and flips
    rows to image order.
    """

    def __init__(self, w: int, h: int, _handle=None):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError("native library unavailable; run make -C native")
        self._fb = (_handle if _handle is not None
                    else self._lib.rtw_fb_create(w, h))
        self.w, self.h = w, h

    @classmethod
    def load(cls, path: str) -> "Framebuffer":
        lib = _load()
        fb = lib.rtw_fb_load(path.encode())
        if not fb:
            raise IOError(f"fb_load: {lib.rtw_last_error().decode()}")
        w, h = lib.rtw_fb_width(fb), lib.rtw_fb_height(fb)
        return cls(w, h, _handle=fb)

    @property
    def spp(self) -> int:
        return int(self._lib.rtw_fb_spp(self._fb))

    def add(self, chunk_sum: np.ndarray, chunk_spp: int) -> None:
        a = np.ascontiguousarray(chunk_sum, dtype=np.float32)
        assert a.shape == (self.h, self.w, 3), a.shape
        self._lib.rtw_fb_add(self._fb, a.ctypes.data_as(
            C.POINTER(C.c_float)), chunk_spp)

    def resolve(self, flip_rows: bool = True) -> np.ndarray:
        out = np.empty((self.h, self.w, 3), np.uint8)
        self._lib.rtw_fb_resolve(self._fb, _u8ptr(out), int(flip_rows))
        return out

    def save(self, path: str) -> None:
        rc = self._lib.rtw_fb_save(self._fb, path.encode())
        if rc != 0:
            raise IOError(f"fb_save: {self._lib.rtw_last_error().decode()}")

    def accumulator(self) -> np.ndarray:
        """Copy of the raw float32 accumulator (h, w, 3), canvas layout."""
        ptr = self._lib.rtw_fb_data(self._fb)
        n = self.h * self.w * 3
        return np.ctypeslib.as_array(ptr, shape=(n,)).reshape(
            self.h, self.w, 3).copy()

    def close(self) -> None:
        if self._fb:
            self._lib.rtw_fb_destroy(self._fb)
            self._fb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
