"""Minimal image output: PNG (pure zlib encoder) and PPM, and the
decoder of the PNGs written here (`png_pixels`), which checks them."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def png_bytes(rgb: np.ndarray) -> bytes:
    """Encodes an [H, W, 3] u8 array as PNG bytes."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    assert c == 3

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(
        b"\x00" + rgb[y].tobytes() for y in range(h)
    )
    out = b"\x89PNG\r\n\x1a\n"
    out += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += chunk(b"IDAT", zlib.compress(raw, 6))
    out += chunk(b"IEND", b"")
    return out


def png_pixels(data: bytes) -> np.ndarray:
    """Decodes an 8-bit RGB PNG whose rows all use filter 0 (what
    `png_bytes` writes) to its [H, W, 3] u8 array; raises ValueError
    for any other PNG."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            w, h, depth, kind = struct.unpack(">IIBB", data[pos + 8:pos + 18])
            if (depth, kind) != (8, 2):
                raise ValueError("not an 8-bit RGB PNG")
        elif tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if (rows[:, 0] != 0).any():
        raise ValueError("a row uses a PNG filter other than 0")
    return rows[:, 1:].reshape(h, w, 3)


def write_png(path, rgb: np.ndarray) -> None:
    """Writes an [H, W, 3] u8 array as a PNG file."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def write_ppm(path, rgb: np.ndarray) -> None:
    """Writes an [H, W, 3] u8 array as a binary PPM file."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgb.tobytes())
