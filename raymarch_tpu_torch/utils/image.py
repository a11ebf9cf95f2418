"""Image output: a copy of `raymarch_tpu.utils.image`, a dependency-free
PNG writer and an ASCII preview.

The reference displays frames in its interactive window; here rendered
images are arrays, and this module is the offscreen "viewer" (SURVEY.md
§2.2): write PNGs (pure zlib/struct, no imaging dependency) or dump a
terminal preview. Images may be numpy arrays or tensors on any device (read
to the host once). tests/test_torch_tape.py guards the copy against drift
(byte-identical `png_bytes`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _host(img):
    """A tensor on any device -> its numpy array; anything else as it is."""
    if hasattr(img, "detach") and hasattr(img, "cpu"):
        return img.detach().cpu().numpy()
    return img


def to_uint8(img) -> np.ndarray:
    """[H,W,3] float (linear-ish [0,1]) -> uint8."""
    a = np.asarray(_host(img), dtype=np.float32)
    return (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def png_bytes(img) -> bytes:
    """Encode an [H,W,3] float or uint8 array as RGB PNG bytes."""
    a = np.asarray(_host(img))
    if a.dtype != np.uint8:
        a = to_uint8(a)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"expected [H,W,3], got {a.shape}")
    h, w, _ = a.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    # Filter type 0 (None) per scanline.
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img) -> None:
    """Write an [H,W,3] float or uint8 array as an RGB PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def ascii_preview(img, width: int = 64) -> str:
    """Terminal luminance preview of an [H,W,3] image."""
    chars = " .:-=+*#%@"
    a = np.asarray(_host(img), dtype=np.float32)
    lum = a.mean(axis=-1)
    h, w = lum.shape
    sx = max(1, w // width)
    sy = max(1, int(sx * 2))
    rows = []
    for r in lum[::sy]:
        rows.append(
            "".join(
                chars[min(int(v * (len(chars) - 1) * 1.4), len(chars) - 1)]
                for v in r[::sx]
            )
        )
    return "\n".join(rows)
