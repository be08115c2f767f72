"""Image I/O: gamma postprocess, PPM read/write, PNG read/write.

Replaces the reference's redirected-cout PPM dump + ImageMagick shell-out
(reference: RayTracingWeekend.cpp:252-286). Codecs dispatch to the native
C++ runtime (native/rtw_native.cpp via libpng/libjpeg — including the image
*decoder* the reference ships earth.jpg for but never implements,
texture.h:73-98) with dependency-free pure-Python fallbacks (PNG via zlib)
when the shared library hasn't been built.
"""
from __future__ import annotations

import struct as _struct
import zlib

import numpy as np

from .. import native as _native

__all__ = ["postprocess", "write_ppm", "read_ppm", "write_png", "read_png",
           "load_image"]


def postprocess(canvas: np.ndarray) -> np.ndarray:
    """Gamma-2 (sqrt) + clamp to [0, 1] (RayTracingWeekend.cpp:244)."""
    return np.minimum(np.sqrt(np.maximum(np.asarray(canvas, np.float64), 0.0)),
                      1.0)


def _quantize(canvas01: np.ndarray) -> np.ndarray:
    """int(255.99 * c) quantization (RayTracingWeekend.cpp:268-270)."""
    return (255.99 * np.asarray(canvas01, np.float64)).astype(np.int32).clip(
        0, 255).astype(np.uint8)


def write_ppm(canvas01: np.ndarray, path: str) -> None:
    """P3 PPM, rows written top of image first.

    `canvas01` is (ny, nx, 3) in [0,1] with row 0 at the image *bottom*
    (v grows upward), matching the reference canvas layout; the writer
    flips like cpp:261-275.
    """
    ny, nx, _ = canvas01.shape
    q = _quantize(canvas01)
    lines = [f"P3\n{nx} {ny}\n255\n"]
    for j in range(ny - 1, -1, -1):
        row = q[j]
        lines.append("\n".join(f"{r} {g} {b}" for r, g, b in row) + "\n")
    with open(path, "w") as f:
        f.write("".join(lines))


def read_ppm(path: str) -> np.ndarray:
    """Read P3/P6 PPM into float (ny, nx, 3) in [0,1], row 0 at image bottom."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"P3":
        tokens = []
        for line in data.decode().splitlines():
            line = line.split("#", 1)[0]
            tokens.extend(line.split())
        assert tokens[0] == "P3"
        nx, ny, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
        vals = np.array(tokens[4:4 + nx * ny * 3], dtype=np.float64)
        img = vals.reshape(ny, nx, 3) / maxval
    elif data[:2] == b"P6":
        # header: P6 <w> <h> <max>\n then binary
        idx = 0
        fields = []
        while len(fields) < 4:
            nl = data.index(b"\n", idx)
            line = data[idx:nl].split(b"#")[0]
            fields.extend(line.split())
            idx = nl + 1
        nx, ny, maxval = int(fields[1]), int(fields[2]), int(fields[3])
        raw = np.frombuffer(data[idx:idx + nx * ny * 3], dtype=np.uint8)
        img = raw.reshape(ny, nx, 3).astype(np.float64) / maxval
    else:
        raise ValueError("not a PPM file")
    return img[::-1].copy()  # file is top-down; canvas convention is bottom-up


def write_png(canvas01: np.ndarray, path: str) -> None:
    """8-bit RGB PNG. Same canvas convention as write_ppm (row 0 = bottom)."""
    ny, nx, _ = canvas01.shape
    q = _quantize(canvas01)[::-1]  # PNG rows are top-down
    if _native.has_codecs():
        _native.write_png(path, q)
        return
    raw = b"".join(b"\x00" + q[j].tobytes() for j in range(ny))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (_struct.pack(">I", len(payload)) + tag + payload
                + _struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = _struct.pack(">IIBBBBB", nx, ny, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _unfilter(raw: np.ndarray, ny: int, nx: int, nch: int) -> np.ndarray:
    """Undo PNG per-row filters (types 0-4)."""
    stride = nx * nch
    out = np.zeros((ny, stride), dtype=np.uint8)
    pos = 0
    for j in range(ny):
        ftype = raw[pos]
        row = raw[pos + 1: pos + 1 + stride].astype(np.int32)
        pos += 1 + stride
        prev = out[j - 1].astype(np.int32) if j > 0 else np.zeros(
            stride, np.int32)
        cur = np.zeros(stride, np.int32)
        if ftype == 0:
            cur = row
        elif ftype == 2:  # Up
            cur = (row + prev) & 0xFF
        else:
            for i in range(stride):
                a = cur[i - nch] if i >= nch else 0
                b = prev[i]
                c = prev[i - nch] if i >= nch else 0
                if ftype == 1:      # Sub
                    pred = a
                elif ftype == 3:    # Average
                    pred = (a + b) // 2
                else:               # Paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[i] = (row[i] + pred) & 0xFF
        out[j] = cur.astype(np.uint8)
    return out


def read_png(path: str) -> np.ndarray:
    """PNG reader (native libpng when built; else a minimal 8-bit
    non-interlaced pure-Python decoder). Returns float (ny, nx, 3) in [0,1],
    row 0 at image bottom."""
    if _native.has_codecs():
        pix = _native.read_png(path)
        return (pix.astype(np.float64) / 255.0)[::-1].copy()
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    nx = ny = depth = ctype = None
    while pos < len(data):
        (ln,) = _struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            nx, ny, depth, ctype, _, _, interlace = _struct.unpack(
                ">IIBBBBB", payload)
            assert depth == 8, "only 8-bit PNGs supported"
            assert interlace == 0, "interlaced PNGs not supported"
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), dtype=np.uint8)
    pix = _unfilter(raw, ny, nx, nch).reshape(ny, nx, nch)
    if nch == 1:
        pix = np.repeat(pix, 3, axis=-1)
    elif nch == 2:
        pix = np.repeat(pix[..., :1], 3, axis=-1)
    elif nch == 4:
        pix = pix[..., :3]
    return (pix.astype(np.float64) / 255.0)[::-1].copy()


def read_rtwi(path: str) -> np.ndarray:
    """Raw RGB8 texels as tools/export_texture_raw.py writes them for the
    reference oracle: b"RTWI <nx> <ny>\n" + nx*ny*3 bytes, row 0 = top."""
    with open(path, "rb") as f:
        magic, nx, ny = f.readline().split()
        if magic != b"RTWI":
            raise ValueError(f"bad RTWI header in {path!r}")
        nx, ny = int(nx), int(ny)
        data = np.frombuffer(f.read(), np.uint8)
    if data.size != nx * ny * 3:
        raise ValueError(f"short RTWI payload in {path!r}")
    return (data.reshape(ny, nx, 3).astype(np.float64) / 255.0)[::-1].copy()


def load_image(path: str) -> np.ndarray:
    """Load PNG, PPM, RTWI, or JPEG (native libjpeg) as float (ny, nx, 3),
    row 0 at image bottom — feed to SceneBuilder.image()."""
    low = path.lower()
    if low.endswith(".rtwi"):
        return read_rtwi(path)
    if low.endswith(".png"):
        return read_png(path)
    if low.endswith((".ppm",)):
        return read_ppm(path)
    if low.endswith((".jpg", ".jpeg")):
        if _native.has_codecs():
            pix = _native.read_jpeg(path)
            return (pix.astype(np.float64) / 255.0)[::-1].copy()
        raise ValueError(
            f"JPEG decoding needs the native runtime built with libjpeg: "
            f"make -C native "
            f"(for {path!r})")
    raise ValueError(f"unsupported image format for {path!r}")
