"""Image files without an image library: the port's PNG reader and writer.

`imread(path)` is what the ZJU loader and the evaluator read with:

  * `.png` through `read_png`, the port's own decoder (zlib + struct):
    8-bit depth, colour types 0 (grey), 2 (RGB), 4 (grey + alpha) and 6
    (RGBA), every row filter (None, Sub, Up, Average, Paeth), no
    interlace. It returns the arrays imageio returns for those files:
    (H, W) for grey, (H, W, C) otherwise, uint8. Anything else (16-bit,
    palette, interlaced) raises ValueError.
  * `.jpg` / `.jpeg` through imageio, as the JAX loader reads them; where
    imageio is not installed an ImportError names the file and the
    package.

`write_png` writes (H, W) grey or (H, W, C) uint8 pixels, C = 1-4, as an
8-bit PNG whose rows each take the filter type whose residuals have the
least sum of absolute values, libpng's default choice: its files have Sub,
Up, Average and Paeth rows as camera and mask PNGs do.

Rows are reconstructed by `png_unfilter.cc` (built at first use by
`native_loader.build_library`, called through ctypes without the GIL): the
Average and Paeth filters run along each row byte by byte.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

from .native_loader import BUILD_DIR, build_library

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# channels of each supported colour type
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOUR_TYPE = {c: t for t, c in _CHANNELS.items()}
UNFILTER_SOURCE = Path(__file__).resolve().parent / "png_unfilter.cc"
UNFILTER_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_unfilter_lib = None
_unfilter_lock = threading.Lock()


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _forward_filters(rows: np.ndarray, bpp: int) -> np.ndarray:
    """(5, H, stride) uint8 residuals of every row under filter types 0-4
    (PNG specification, section 9), from the (H, stride) image bytes."""
    x = rows.astype(np.int16)
    up = np.concatenate([np.zeros_like(x[:1]), x[:-1]], axis=0)
    left = np.concatenate([np.zeros_like(x[:, :bpp]), x[:, :-bpp]], axis=1)
    up_left = np.concatenate([np.zeros_like(up[:, :bpp]), up[:, :-bpp]], axis=1)
    p = left + up - up_left
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    preds = (0, left, up, (left + up) >> 1, paeth)
    return np.stack([(x - q).astype(np.uint8) for q in preds])


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) grey or (H, W, C) uint8 pixels (C = 1 grey, 2 grey +
    alpha, 3 RGB, 4 RGBA) as an 8-bit PNG, each row with the filter type of
    least sum of absolute residuals (residual bytes read as signed)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1-4) uint8 pixels, got "
                         f"{img.shape} {img.dtype}")
    H, W, C = img.shape
    residuals = _forward_filters(img.reshape(H, W * C), C)
    cost = np.abs(residuals.view(np.int8).astype(np.int32)).sum(axis=2)
    kinds = cost.argmin(axis=0).astype(np.uint8)
    data = np.concatenate([kinds[:, None], residuals[kinds, np.arange(H)]], axis=1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOUR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(data.tobytes()))
                + _chunk(b"IEND", b""))


def _unfilter_library() -> ctypes.CDLL:
    """png_unfilter.cc's ctypes handle, building it at the first call."""
    global _unfilter_lib
    with _unfilter_lock:
        if _unfilter_lib is None:
            lib = ctypes.CDLL(str(build_library(
                UNFILTER_SOURCE, BUILD_DIR / "libkpnerf_png.so", UNFILTER_FLAGS)))
            lib.kp_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                            ctypes.c_int64, ctypes.c_int64]
            lib.kp_png_unfilter.restype = ctypes.c_int64
            _unfilter_lib = lib
        return _unfilter_lib


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """(H, stride) reconstructed bytes from the (H, 1 + stride) filtered
    rows."""
    H, stride = raw.shape[0], raw.shape[1] - 1
    raw = np.ascontiguousarray(raw)
    out = np.empty((H, stride), np.uint8)
    bad = _unfilter_library().kp_png_unfilter(raw.ctypes.data, out.ctypes.data, H, stride, bpp)
    if bad >= 0:
        raise ValueError(f"row {bad}: unknown PNG filter type {raw[bad, 0]}")
    return out


def read_png_rows(path: str):
    """(rows, W, C) of an 8-bit, non-interlaced grey / RGB / grey + alpha /
    RGBA PNG: its (H, 1 + W * C) filtered rows, each a filter type byte and
    the row's residuals. Other PNGs raise ValueError."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {color}, interlace {interlace}: the "
            "port's PNG reader takes 8-bit grey / RGB / grey+alpha / RGBA without interlace")
    C = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * C):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected {H * (1 + W * C)}")
    return raw.reshape(H, 1 + W * C), W, C


def read_png(path: str) -> np.ndarray:
    """The pixels of an 8-bit, non-interlaced grey / RGB / grey + alpha /
    RGBA PNG: (H, W) uint8 for grey, else (H, W, C). Other PNGs raise
    ValueError."""
    rows, W, C = read_png_rows(path)
    pixels = _unfilter(rows, C)
    H = rows.shape[0]
    return pixels.reshape(H, W) if C == 1 else pixels.reshape(H, W, C)


def imread(path: str) -> np.ndarray:
    """An image file's pixels as uint8: PNG by `read_png`, JPEG by
    imageio."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        return read_png(path)
    if ext in (".jpg", ".jpeg"):
        try:
            import imageio.v2 as imageio
        except ImportError as e:
            raise ImportError(
                f"{path}: reading JPEG images needs the imageio package, which is not "
                "installed; convert the tree's images to PNG, which the port reads itself"
            ) from e
        return np.asarray(imageio.imread(path))
    raise ValueError(f"{path}: the port reads .png, .jpg and .jpeg images, not {ext!r}")
