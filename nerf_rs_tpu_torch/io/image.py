"""Image I/O: binary PPM (P6), PNG and RGBA buffers.

Quantization is the reference's: clamp to [0, 1], scale by 255, add 0.5,
truncate to u8. Pixels may be numpy arrays or tensors on any device.

PNG is read and written with ``zlib`` and numpy, so no imaging library is
needed: 8-bit RGB and RGBA, not interlaced, every row filter on read
(None, Sub, Up, Average, Paeth), filter None on write, CRCs checked.
Other PNGs (palette, grayscale, 16-bit, interlaced) are refused by name.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# The PNG colour types read (RGB, RGBA) -> channels, and the names of the others.
_PNG_CHANNELS = {2: 3, 6: 4}
_PNG_REFUSED = {0: "grayscale", 3: "palette", 4: "grayscale-with-alpha"}


def _to_numpy(pixels) -> np.ndarray:
    if isinstance(pixels, torch.Tensor):
        pixels = pixels.detach().cpu().numpy()
    return np.asarray(pixels, dtype=np.float32)


def quantize_u8(pixels) -> np.ndarray:
    """clamp(0,1) * 255 + 0.5, truncated — byte-identical to the reference."""
    return (np.clip(_to_numpy(pixels), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_ppm(path, pixels, height: int, width: int) -> None:
    """Binary P6 PPM writer."""
    rgb = quantize_u8(_to_numpy(pixels).reshape(height, width, 3))
    with open(path, "wb") as f:
        f.write(f"P6\n{width} {height}\n255\n".encode())
        f.write(rgb.tobytes())


def load_ppm(path) -> np.ndarray:
    """Read a binary P6 PPM into a float32 (H, W, 3) array in [0, 1]."""
    data = Path(path).read_bytes()
    # Header: magic, width, height, maxval — whitespace/comment tolerant.
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    if tokens[0] != b"P6":
        raise ValueError(f"not a binary PPM: magic {tokens[0]!r}")
    width, height, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    raw = np.frombuffer(data, dtype=np.uint8, count=width * height * 3, offset=i)
    return raw.reshape(height, width, 3).astype(np.float32) / float(maxval)


def pixels_to_rgba(pixels) -> np.ndarray:
    """Flat RGBA u8 buffer with A=255: the reference's quantization of
    (..., 3) pixels, interleaved with an opaque alpha."""
    rgb = quantize_u8(_to_numpy(pixels).reshape(-1, 3))
    rgba = np.empty((rgb.shape[0], 4), dtype=np.uint8)
    rgba[:, :3] = rgb
    rgba[:, 3] = 255
    return rgba.reshape(-1)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(pixels: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W, 4) u8 -> the bytes of an 8-bit RGB or RGBA PNG,
    every row with filter 0 (None), one IDAT chunk."""
    px = np.ascontiguousarray(pixels, dtype=np.uint8)
    height, width, channels = px.shape
    color = {3: 2, 4: 6}[channels]
    raw = np.concatenate([np.zeros((height, 1), np.uint8), px.reshape(height, -1)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def save_png(path, pixels, height: int, width: int) -> None:
    """PNG writer: ``pixels`` (H*W*C values, C = 3 or 4, in [0, 1])
    quantized as :func:`quantize_u8`, written by :func:`encode_png`."""
    Path(path).write_bytes(encode_png(quantize_u8(_to_numpy(pixels).reshape(height, width, -1))))


def _png_chunks(data: bytes, name: str):
    """(kind, body) of every chunk up to IEND, each CRC checked."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            break
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: CRC mismatch in its {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: truncated PNG (no IEND chunk)")


def _png_header(body: bytes, name: str):
    """(width, height, channels) from an IHDR chunk; refuses, by name,
    what :func:`decode_png` does not read."""
    width, height, depth, color, compression, filtering, interlace = struct.unpack(
        ">IIBBBBB", body)
    channels = _PNG_CHANNELS.get(color)
    refused = [None if channels else f"{_PNG_REFUSED.get(color, f'colour type {color}')} pixels",
               f"{depth}-bit samples" if depth != 8 else None,
               "interlaced (Adam7) rows" if interlace else None,
               f"compression method {compression}" if compression else None,
               f"filter method {filtering}" if filtering else None]
    refused = [r for r in refused if r]
    if refused:
        raise ValueError(f"{name}: unsupported PNG ({', '.join(refused)}); only 8-bit RGB and "
                         f"RGBA, not interlaced, are read")
    return width, height, channels


def _png_scan(data: bytes, name: str):
    """(width, height, channels, the IDAT stream) of a PNG this module reads."""
    header, idat = None, []
    for kind, body in _png_chunks(data, name):
        if kind == b"IHDR":
            header = _png_header(body, name)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    return (*header, b"".join(idat))


def _predict(kind, a, b, c):
    """The PNG filters' predictions of pixels from their left (a), upper
    (b) and upper-left (c) neighbours, int16: ``kind`` one filter type for
    all, or an (n, 1) array of one a row."""
    if not isinstance(kind, int):
        return np.choose(kind, [np.zeros((1, 1), np.int16), a, b, _predict(3, a, b, c),
                                _predict(4, a, b, c)])
    if kind == 4:
        ac, bc = a - c, b - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(ac + bc)
        return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    if kind == 3:
        return (a + b) >> 1
    return (0, a, b)[kind]


def _unfilter_wavefront(rows: np.ndarray, prev: np.ndarray, channels: int) -> np.ndarray:
    """Undo the filters of ``rows`` ((n, 1 + W * C) u8, each row's filter
    byte first), ``prev`` the row above the first (zeros at the top).

    Every filter predicts a pixel from its left, upper and upper-left
    neighbours, so pixel (y, x) needs only pixels of the anti-diagonals
    y + x - 1 and y + x - 2. The rows are skewed so that each
    anti-diagonal is one contiguous slice, ``skew[y + x + 2, y + 1]``
    holding pixel (y, x), and undone a diagonal at a time as array
    operations: n + W - 1 steps of numpy instead of n * W * C of Python.
    Slots that hold no pixel stay 0, which is what PNG reads beyond the
    image's left and top edges."""
    n = rows.shape[0]
    width = (rows.shape[1] - 1) // channels
    skew = np.zeros((n + width + 1, n + 1, channels), np.int16)
    filt = np.zeros_like(skew)

    def pixels(a):
        """(n, W, C) view of pixel (y, x) at a[y + x + 2, y + 1]."""
        st, sy, sc = a.strides
        return np.lib.stride_tricks.as_strided(a[2:, 1:], (n, width, channels),
                                               (st + sy, st, sc))

    pixels(filt)[...] = rows[:, 1:].reshape(n, width, channels)
    skew[1:width + 1, 0] = prev.reshape(width, channels)
    kinds = rows[:, :1].astype(np.int16)
    # One filter type in every row (the common case) skips the per-row
    # choice.
    uniform = int(kinds[0, 0]) if (kinds == kinds[0, 0]).all() else None
    for t in range(n + width - 1):
        y0, y1 = max(0, t - width + 1), min(n - 1, t) + 1
        pred = _predict(kinds[y0:y1] if uniform is None else uniform,
                        skew[t + 1, y0 + 1:y1 + 1], skew[t + 1, y0:y1], skew[t, y0:y1])
        skew[t + 2, y0 + 1:y1 + 1] = (filt[t + 2, y0 + 1:y1 + 1] + pred) & 0xFF
    return pixels(skew).astype(np.uint8).reshape(n, width * channels)


def decode_png(data: bytes, name: str = "PNG") -> np.ndarray:
    """The bytes of an 8-bit RGB or RGBA PNG, not interlaced -> (H, W, C)
    u8, C = 3 or 4: the array ``np.asarray(PIL.Image.open(...))`` gives,
    with zlib and numpy alone. Rows of filters None, Sub and Up are undone
    a row at a time; from the first Average or Paeth row on, whose bytes
    depend on their left neighbours through a non-linear predictor, a
    wavefront over the anti-diagonals undoes the rest
    (:func:`_unfilter_wavefront`)."""
    width, height, channels, stream = _png_scan(data, name)
    stride = width * channels
    raw = zlib.decompress(stream)
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{name}: {len(raw)} bytes of image data, expected "
                         f"{height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    if (rows[:, 0] > 4).any():
        y = int(np.argmax(rows[:, 0] > 4))
        raise ValueError(f"{name}: row {y} has unknown filter type {rows[y, 0]}")
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:
            out[y] = line.reshape(-1, channels).cumsum(axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y] = line + prev
        else:
            out[y:] = _unfilter_wavefront(rows[y:], prev, channels)
            break
        prev = out[y]
    return out.reshape(height, width, channels)


def load_png(path) -> np.ndarray:
    """Read an 8-bit RGB or RGBA PNG -> (H, W, C) u8, C = 3 or 4, through
    :func:`decode_png` (no pillow needed)."""
    return decode_png(Path(path).read_bytes(), str(path))
