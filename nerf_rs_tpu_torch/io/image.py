"""Image output: binary PPM (P6), PNG and RGBA buffers.

Quantization is the reference's: clamp to [0, 1], scale by 255, add 0.5,
truncate to u8. Pixels may be numpy arrays or tensors on any device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


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


def save_png(path, pixels, height: int, width: int) -> None:
    """PNG writer; needs pillow, and raises ImportError where it is absent
    (write a PPM there instead)."""
    from PIL import Image

    rgb = quantize_u8(_to_numpy(pixels).reshape(height, width, 3))
    Image.fromarray(rgb, mode="RGB").save(path)
