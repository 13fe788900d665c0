"""The port's PNG reader / writer (`keypointnerf_torch/data/image_io.py`)
against imageio.

  * PNGs imageio writes (grey, grey + alpha, RGB, RGBA; its encoder picks
    None / Sub / Up / Paeth rows) and PNGs encoded here with every filter
    type row by row: `read_png` returns imageio's array bit for bit;
  * `write_png`'s files in every colour type, read back by both readers;
  * a JPEG without imageio raises ImportError naming the file and the
    package; a 16-bit, a palette or an interlaced PNG, or a row of an
    unknown filter type, raises ValueError.
"""
import builtins
import struct
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")
imageio = pytest.importorskip("imageio.v2")

from keypointnerf_torch.data.image_io import (  # noqa: E402
    PNG_SIGNATURE,
    imread,
    read_png,
    write_png,
)

CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}      # colour type -> channels


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth_pred(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(path, img, color, filters, depth=8, interlace=0):
    """An 8-bit PNG of `img` whose row y is filtered with filters[y % len]
    (the PNG spec's forward filters, written here independently of the
    reader)."""
    H, W = img.shape[:2]
    C = CHANNELS[color]
    rows = img.reshape(H, W * C).astype(np.int64)
    out = []
    prev = np.zeros(W * C, np.int64)
    for y in range(H):
        x, kind = rows[y], filters[y % len(filters)]
        left = np.concatenate([np.zeros(C, np.int64), x[:-C]])
        up_left = np.concatenate([np.zeros(C, np.int64), prev[:-C]])
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2,
                4: _paeth_pred(left, prev, up_left)}[kind]
        out.append(np.concatenate([[kind], (x - pred) % 256]).astype(np.uint8))
        prev = x
    ihdr = struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(np.concatenate(out).tobytes()))
                + _chunk(b"IEND", b""))


def _image(rng, C, H=23, W=31):
    """Smooth ramps with noise: every filter's predictor is exercised."""
    yy, xx = np.mgrid[:H, :W]
    planes = [(yy * 7 + xx * 3 * (c + 1)) % 256 for c in range(C)]
    base = np.stack(planes, -1)
    noisy = rng.integers(0, 256, base.shape)
    img = np.where(rng.random(base.shape) < 0.3, noisy, base).astype(np.uint8)
    return img[..., 0] if C == 1 else img


def _filter_types(path):
    return set(_raw_rows(path)[:, 0].tolist())


def _raw_rows(path):
    """The (H, 1 + stride) filtered rows of a PNG, parsed here apart from
    the reader."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        header = struct.unpack(">IIBBBBB", body) if tag == b"IHDR" else header
        idat += [body] if tag == b"IDAT" else []
    W, H, _, color, _, _, _ = header
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return raw.reshape(H, -1)


@pytest.mark.parametrize("color", sorted(CHANNELS))
def test_read_png_equals_imageio(tmp_path, color):
    """imageio's own PNGs and PNGs with every filter type, read bit-equal
    to imageio, in imageio's shapes."""
    rng = np.random.default_rng(color)
    img = _image(rng, CHANNELS[color])
    written = str(tmp_path / "imageio.png")
    imageio.imwrite(written, img)
    assert _filter_types(written) - {0} != set()     # imageio filters its rows
    got = read_png(written)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, imageio.imread(written))
    np.testing.assert_array_equal(got, img)
    for filters in ([0], [1], [2], [3], [4], [4, 3, 2, 1, 0]):
        path = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        encode_png(path, img, color, filters)
        assert _filter_types(path) == set(filters)
        got = imread(path)
        np.testing.assert_array_equal(got, imageio.imread(path))
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("color", sorted(CHANNELS))
def test_write_png_round_trip(tmp_path, color):
    """write_png's files in every colour type: read back by read_png and by
    imageio as the pixels written; their rows take more than one filter
    type, each the one of least cost."""
    rng = np.random.default_rng(2)
    img = _image(rng, CHANNELS[color], H=40, W=33)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    assert len(_filter_types(path)) > 1
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)
    cost = []       # (5, H): each filter type's cost of each row, from encode_png's rows
    for k in range(5):
        encode_png(str(tmp_path / f"f{k}.png"), img, color, [k])
        residuals = _raw_rows(str(tmp_path / f"f{k}.png"))[:, 1:].view(np.int8)
        cost.append(np.abs(residuals.astype(np.int32)).sum(axis=1))
    cost = np.stack(cost)
    chosen = _raw_rows(path)[:, 0]
    np.testing.assert_array_equal(cost[chosen, np.arange(len(chosen))], cost.min(axis=0))


def test_refusals(tmp_path, monkeypatch):
    """16-bit, palette and interlaced PNGs raise ValueError; a JPEG without
    imageio raises ImportError naming the file and the package."""
    img = np.zeros((4, 5), np.uint8)
    for name, kw in (("deep", dict(color=0, depth=16)), ("palette", dict(color=0)),
                     ("interlaced", dict(color=0, interlace=1))):
        path = str(tmp_path / f"{name}.png")
        encode_png(path, img, kw.pop("color"), [0], **kw)
        if name == "palette":      # colour type 3 in the header
            data = bytearray(open(path, "rb").read())
            data[25] = 3
            data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])) & 0xFFFFFFFF)
            open(path, "wb").write(bytes(data))
        with pytest.raises(ValueError, match="8-bit"):
            read_png(path)
    bad = str(tmp_path / "filter5.png")
    rows = np.zeros((4, 6), np.uint8)
    rows[:, 0] = [1, 2, 5, 0]         # a row of filter type 5 after Sub and Up rows
    with open(bad, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 0, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="row 2: unknown PNG filter type 5"):
        read_png(bad)
    jpg = str(tmp_path / "img.jpg")
    imageio.imwrite(jpg, np.zeros((8, 8, 3), np.uint8))
    assert imread(jpg).shape == (8, 8, 3)
    real_import = builtins.__import__

    def no_imageio(name, *args, **kwargs):
        if name.startswith("imageio"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    with pytest.raises(ImportError, match=r"img\.jpg.*imageio"):
        imread(jpg)
