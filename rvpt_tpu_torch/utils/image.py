"""Dependency-free PNG I/O.

The reference presents frames through a Vulkan swapchain blit
(src/rvpt/rvpt.cpp:956-964); headless rendering instead writes PNGs (and
the viewer/debug overlays become saved buffers, SURVEY.md §1 L6).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """Write an image to PNG.

    img: u8[H,W,3] / u8[H,W] or float arrays in [0,1] (converted with the same
    clamp-to-rgba8 rule as the reference's UNORM image store).
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(np.round(np.clip(img, 0.0, 1.0) * 255.0), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    h, w, c = img.shape
    assert c in (3, 4), f"expected RGB(A), got {c} channels"
    color_type = 2 if c == 3 else 6
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    out += _chunk(b"IDAT", zlib.compress(raw, 6))
    out += _chunk(b"IEND", b"")
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(out)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for 8-bit RGB/RGBA/gray, no interlace (enough to
    round-trip goldens written by :func:`write_png`)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", body
            )
            assert bit_depth == 8 and interlace == 0
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        row = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 2:  # up
            row = (row.astype(np.int32) + prev).astype(np.uint8)
        elif ftype in (1, 3, 4):  # sub / average / paeth need sequential scan
            row = _defilter_row(ftype, row, prev, channels)
        else:
            raise ValueError(f"unsupported filter {ftype}")
        out[y] = row
        prev = out[y]
    return out.reshape(h, w, channels)


def _defilter_row(ftype, row, prev, c):
    row = row.astype(np.int32)
    prev = prev.astype(np.int32)
    out = np.zeros_like(row)
    for i in range(len(row)):
        a = out[i - c] if i >= c else 0
        b = prev[i]
        cc = prev[i - c] if i >= c else 0
        if ftype == 1:
            out[i] = (row[i] + a) & 0xFF
        elif ftype == 3:
            out[i] = (row[i] + (a + b) // 2) & 0xFF
        else:
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
            out[i] = (row[i] + pr) & 0xFF
    return out.astype(np.uint8)
