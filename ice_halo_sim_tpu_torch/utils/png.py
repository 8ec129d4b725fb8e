"""Minimal dependency-free PNG writer (RGB8), stdlib zlib only."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(rgb: np.ndarray) -> bytes:
    """Encode an [H, W, 3] uint8 array as PNG bytes."""
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("encode_png expects [H, W, 3] uint8")
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    idat = zlib.compress(raw.tobytes(), 6)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", idat)
        + chunk(b"IEND", b"")
    )


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as a PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
