"""PyTorch port, the nerf_synthetic dataset and PNG I/O against the JAX
package and pillow: ``data.BlenderDataset`` on the 2-frame 8x8 scene of
tests/test_data.py (rays and the batches it draws), and ``io/image.py``'s
zlib-and-numpy PNG reader and writer (every row filter, the refusals, no
pillow needed).

Origins, colours and batch indices must be bitwise the JAX package's; ray
directions come from two implementations of the same float32 arithmetic
and are held within 1e-6."""

import io
import json
import struct
import sys
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from nerf_rs_tpu.data import BlenderDataset as JaxBlenderDataset
from nerf_rs_tpu_torch.data import BlenderDataset
from nerf_rs_tpu_torch.io.image import decode_png, load_png, quantize_u8, save_png

DIRS_ATOL = 1e-6


def write_scene(root, channels: int = 4, writer: str = "pillow"):
    """tests/test_data.py's 2-frame 8x8 scene (RGBA, or RGB with
    ``channels=3``), written by pillow or by the port's save_png."""
    rng = np.random.default_rng(0)
    frames = []
    for i in range(2):
        img = (rng.uniform(0, 1, (8, 8, 4)) * 255).astype(np.uint8)[..., :channels]
        if writer == "pillow":
            Image.fromarray(img).save(root / f"r_{i}.png")
        else:
            save_png(root / f"r_{i}.png", img.astype(np.float32) / 255.0, 8, 8)
        theta = i * 0.7
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [4 * np.sin(theta), -4 * np.cos(theta), 1.0]
        fwd = -c2w[:3, 3] / np.linalg.norm(c2w[:3, 3])
        c2w[:3, 2] = -fwd
        right = np.cross(fwd, np.asarray([0, 0, 1.0], np.float32))
        right /= np.linalg.norm(right)
        c2w[:3, 0] = right
        c2w[:3, 1] = np.cross(right, fwd)
        frames.append({"file_path": f"r_{i}", "transform_matrix": c2w.tolist()})
    (root / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    return root


@pytest.mark.parametrize("channels, writer, white", [(4, "pillow", True), (4, "pillow", False),
                                                      (3, "pillow", True), (3, "port", True)])
def test_blender_dataset_equals_jax(tmp_path, channels, writer, white):
    """len, the frame origins, frame indices and colours bitwise; the ray
    directions within 1e-6 and unit."""
    root = write_scene(tmp_path, channels, writer)
    want = JaxBlenderDataset(root, white_background=white)
    got = BlenderDataset(root, white_background=white, device="cpu")
    assert len(got) == len(want) == 2 * 8 * 8
    assert (got.height, got.width) == (8, 8)
    for name in ("frame_origins", "frame_idx", "rgb"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.dirs.dtype == np.float32
    np.testing.assert_allclose(got.dirs, want.dirs, rtol=0, atol=DIRS_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got.dirs, axis=-1), 1.0, atol=1e-6)


def test_batches_equal_jax(tmp_path):
    """The first three batches(16, seed=3): origins and rgb bitwise, dirs
    within 1e-6, near and far; tensors on the dataset's device."""
    root = write_scene(tmp_path)
    want = JaxBlenderDataset(root).batches(16, seed=3)
    got = BlenderDataset(root, device="cpu").batches(16, seed=3)
    for _ in range(3):
        w, g = next(want), next(got)
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu" for v in g.values())
        for name in ("origins", "rgb"):
            np.testing.assert_array_equal(g[name].numpy(), np.asarray(w[name]), err_msg=name)
        np.testing.assert_allclose(g["dirs"].numpy(), np.asarray(w["dirs"]), rtol=0,
                                   atol=DIRS_ATOL)
        assert (float(g["near"]), float(g["far"])) == (float(w["near"]), float(w["far"]))


# ---- PNG ------------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_filtered(px: np.ndarray, filters, depth: int = 8, color=None, interlace: int = 0):
    """This test's own PNG encoder: row y of ``px`` (H, W, C) u8 filtered
    with ``filters[y % len(filters)]`` as the PNG specification defines
    the five filters, byte by byte; the header fields may be set to what
    the reader must refuse."""
    h, w, c = px.shape
    bpp, stride = c, w * c
    rows = px.reshape(h, stride).astype(int)
    raw = bytearray()
    for y in range(h):
        kind = filters[y % len(filters)]
        raw.append(kind)
        for i in range(stride):
            x = rows[y, i]
            a = rows[y, i - bpp] if i >= bpp else 0
            b = rows[y - 1, i] if y else 0
            cc = rows[y - 1, i - bpp] if y and i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[kind]
            raw.append((x - pred) % 256)
    color = {3: 2, 4: 6}[c] if color is None else color
    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(bytes(raw))) + _chunk(b"IEND", b""))


def pixels(channels: int, seed: int = 0) -> np.ndarray:
    """A 7x11 image with smooth ramps and noise, so each filter meets both
    small and wrapping differences."""
    rng = np.random.default_rng(seed)
    ramp = np.add.outer(np.arange(7) * 37, np.arange(11) * 23)[..., None] % 256
    return ((ramp + rng.integers(0, 256, (7, 11, channels)) * (rng.random((7, 11, 1)) < 0.3))
            % 256).astype(np.uint8)


@pytest.fixture
def no_pillow(monkeypatch):
    """``import PIL`` fails, as on a machine without pillow."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_load_png_equals_pillow_for_each_filter(tmp_path, monkeypatch, channels, kind):
    """A file whose rows all use one filter (and one that cycles through
    all five) reads as pillow reads it, through decode_png and through
    load_png with and without pillow."""
    px = pixels(channels, kind)
    for filters in ([kind], [kind, 0, 1, 2, 3, 4]):
        path = tmp_path / f"f{len(filters)}.png"
        path.write_bytes(encode_filtered(px, filters))
        want = np.asarray(Image.open(path))
        np.testing.assert_array_equal(want, px)
        for got in (decode_png(path.read_bytes()), load_png(path)):
            assert got.dtype == np.uint8 and got.shape == px.shape
            np.testing.assert_array_equal(got, want)
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "PIL", None)
            np.testing.assert_array_equal(load_png(path), want)


@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("shape", [(1, 1), (1, 13), (13, 1), (23, 40), (40, 23)])
def test_decode_png_mixed_filters_equals_pillow(shape, channels):
    """Each row with its own random filter, on images taller than wide,
    wider than tall, a row and a column: the anti-diagonal wavefront that
    undoes Average and Paeth rows (and every row after the first of them)
    reads what pillow reads."""
    rng = np.random.default_rng(shape[0] * 100 + shape[1] + channels)
    px = rng.integers(0, 256, (*shape, channels), dtype=np.uint8)
    px[: shape[0] // 2] //= 8                      # small differences as well as wrapping ones
    filters = [int(k) for k in rng.integers(0, 5, shape[0])]
    data = encode_filtered(px, filters)
    want = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(want, px)
    np.testing.assert_array_equal(decode_png(data), want)


@pytest.mark.parametrize("channels", [3, 4])
def test_save_png_read_back_by_pillow(tmp_path, channels):
    """save_png quantizes as quantize_u8 and writes a PNG that pillow
    reads back bitwise, and so does load_png without pillow."""
    rng = np.random.default_rng(channels)
    img = rng.uniform(-0.1, 1.1, size=(5, 9, channels)).astype(np.float32)
    save_png(tmp_path / "x.png", torch.from_numpy(img), 5, 9)
    pil = Image.open(tmp_path / "x.png")
    assert pil.mode == ("RGB" if channels == 3 else "RGBA")
    np.testing.assert_array_equal(np.asarray(pil), quantize_u8(img))
    np.testing.assert_array_equal(decode_png((tmp_path / "x.png").read_bytes()), quantize_u8(img))


def test_load_png_needs_no_pillow(tmp_path, no_pillow):
    """With pillow unimportable the port writes and reads a scene's PNGs
    and builds the dataset; the colours equal pillow's read of the same
    files (read before pillow went away)."""
    with pytest.raises(ImportError):
        import PIL  # noqa: F401
    px = pixels(4)
    (tmp_path / "a.png").write_bytes(encode_filtered(px, [4, 3, 1]))
    np.testing.assert_array_equal(load_png(tmp_path / "a.png"), px)
    root = write_scene(tmp_path, 3, writer="port")
    assert len(BlenderDataset(root, device="cpu")) == 128


def _pillow_png(img: Image.Image) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("case, data, words", [
    ("16-bit", encode_filtered(pixels(3), [0], depth=16), "16-bit"),
    ("palette", _pillow_png(Image.fromarray(pixels(3)).convert("P")), "palette"),
    ("interlaced", encode_filtered(pixels(3), [0], interlace=1), "interlaced"),
    ("grayscale", _pillow_png(Image.fromarray(pixels(3)[..., 0])), "grayscale"),
])
@pytest.mark.parametrize("pillow", [True, False])
def test_unsupported_png_refused_by_name(tmp_path, monkeypatch, case, data, words, pillow):
    """16-bit, palette, interlaced and grayscale files are refused with a
    message that names what is unsupported, with pillow present or not."""
    path = tmp_path / f"{case}.png"
    path.write_bytes(data)
    if not pillow:
        monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match=words):
        load_png(path)


def test_corrupt_png_refused(tmp_path):
    """A flipped byte fails its chunk's CRC; a file cut short has no IEND;
    other bytes are not a PNG."""
    data = bytearray(encode_filtered(pixels(3), [2]))
    data[40] ^= 1
    with pytest.raises(ValueError, match="CRC mismatch"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="truncated"):
        decode_png(encode_filtered(pixels(3), [2])[:-12])
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"P6\n1 1\n255\n\0\0\0")
