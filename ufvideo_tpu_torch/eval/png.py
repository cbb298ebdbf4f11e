"""A lossless 8-bit PNG codec on ``zlib`` and numpy, so that the eval
harness reads frame directories and writes and reads mask PNGs on a machine
without cv2 or PIL.

Reads non-interlaced 8-bit grayscale, RGB and RGBA files with any of the
five row filters (None, Sub, Up, Average, Paeth); writes grayscale and RGB
with filter 0 (None). Anything else raises and names the file. Sub and Up
are vectorised; Average and Paeth need a sequential pass along each row, so
a file that uses them decodes slowly (about a second for a 480x640 RGB
frame), but exactly.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels: gray, RGB, RGBA


def _chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: PNG ends before IEND")


def _unfilter_average(raw: bytearray, prior: bytes, bpp: int) -> bytearray:
    for i in range(len(raw)):
        left = raw[i - bpp] if i >= bpp else 0
        raw[i] = (raw[i] + ((left + prior[i]) >> 1)) & 0xFF
    return raw


def _unfilter_paeth(raw: bytearray, prior: bytes, bpp: int) -> bytearray:
    for i in range(len(raw)):
        if i >= bpp:
            a, c = raw[i - bpp], prior[i - bpp]
        else:
            a = c = 0
        b = prior[i]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        raw[i] = (raw[i] + pred) & 0xFF
    return raw


def read_png(path: str) -> np.ndarray:
    """The pixels of an 8-bit PNG: [H, W] uint8 for grayscale, [H, W, 3] for
    RGB, [H, W, 4] for RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type {color}, interlace "
            f"{interlace}); this codec reads non-interlaced 8-bit gray, RGB and RGBA")
    ch = _CHANNELS[color]
    stride = w * ch
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: image data holds {len(raw)} bytes, not {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along the row, modulo 256
            cur = np.cumsum(line.reshape(w, ch), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind == 3:
            cur = np.frombuffer(_unfilter_average(bytearray(line.tobytes()),
                                                  prior.tobytes(), ch), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_unfilter_paeth(bytearray(line.tobytes()),
                                                prior.tobytes(), ch), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out.reshape(h, w) if ch == 1 else out.reshape(h, w, ch)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write [H, W] uint8 as grayscale or [H, W, 3] uint8 as RGB, every row
    with filter 0; ``level`` is zlib's."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"{path}: write_png takes [H, W] or [H, W, 3] uint8, not "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + img[0].size), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
