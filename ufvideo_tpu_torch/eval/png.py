"""A lossless PNG codec on ``zlib`` and numpy, so that the eval harness
reads frame directories and writes and reads mask PNGs on a machine without
cv2 or PIL.

Reads every PNG the format defines: grayscale, gray + alpha, RGB, RGBA and
palette images (``PLTE``, with or without ``tRNS``), at each bit depth the
colour type allows (1, 2, 4, 8, 16), plain or Adam7-interlaced, with any of
the five row filters (None, Sub, Up, Average, Paeth). Writes grayscale and RGB
at 8 bits with filter 0 (None). A file that is no PNG, or is corrupt, raises
and names the file. Sub and Up are vectorised; Average and Paeth need a
sequential pass along each row, so a file that uses them decodes slowly
(about a second for a 480x640 RGB frame), but exactly.

Two readings of a file reproduce the libraries the JAX package reads with:
``read_gray_png`` is ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` (the eval
scorer's ground truth), ``read_rgb_png`` is PIL's ``Image.open(path).convert(
"RGB")`` (a frame directory). The rules each follows were read off cv2 5.0
and PIL 12.1 on every colour type and depth (``tests/test_torch_eval_host.py``
holds them there).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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


# colour type -> channels: gray, RGB, palette index, gray + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _unfilter(rows: np.ndarray, ch_bytes: int, path: str) -> np.ndarray:
    """[h, 1 + stride] filtered rows → [h, stride] bytes; ``ch_bytes`` is
    the filters' byte distance (a whole pixel, at least one byte)."""
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along the row, modulo 256
            pad = -stride % ch_bytes
            cur = np.cumsum(np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(
                -1, ch_bytes), axis=0, dtype=np.uint8).reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = line + prior
        elif kind == 3:
            cur = np.frombuffer(_unfilter_average(bytearray(line.tobytes()),
                                                  prior.tobytes(), ch_bytes), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_unfilter_paeth(bytearray(line.tobytes()),
                                                prior.tobytes(), ch_bytes), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered [h, stride] bytes → [h, w, ch] samples (uint8, or uint16
    at depth 16), packed sub-byte samples taken most significant bit first."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    if depth == 16:
        return rows[:, :2 * w * ch].copy().view(">u2").astype(np.uint16).reshape(h, w, ch)
    bits = np.unpackbits(rows, axis=1)[:, :w * ch * depth].reshape(h, w * ch, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8).reshape(h, w, ch)


def decode_png(path: str):
    """A PNG's samples as stored → (samples [H, W, channels] uint8, or
    uint16 at bit depth 16; colour type; bit depth; palette [n, 3] uint8 or
    None; tRNS payload or None). Sub-byte samples keep their stored value."""
    try:
        return _decode(path)
    except (zlib.error, struct.error) as e:
        raise ValueError(f"{path}: corrupt PNG ({e})") from None


def _decode(path: str):
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, palette, trns = None, [], None, None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color] or interlace > 1:
        raise ValueError(f"{path}: not a valid PNG (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    if color == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    ch = _CHANNELS[color]
    ch_bytes = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    dtype = np.uint16 if depth == 16 else np.uint8
    out = np.zeros((h, w, ch), dtype)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue  # an empty pass holds no rows, not even filter bytes
        stride = -(-pw * ch * depth // 8)
        n = ph * (stride + 1)
        if pos + n > raw.size:
            raise ValueError(f"{path}: image data holds {raw.size} bytes, fewer than its "
                             "rows need")
        rows = _unfilter(raw[pos:pos + n].reshape(ph, stride + 1), ch_bytes, path)
        out[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += n
    if pos != raw.size:
        raise ValueError(f"{path}: image data holds {raw.size} bytes, not {pos}")
    return out, color, depth, palette, trns


def _palette_rgb(samples: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Palette indices [H, W, 1] → RGB; an index past the palette's end
    reads black."""
    full = np.zeros((256, 3), np.uint8)
    full[:len(palette)] = palette[:256]
    return full[samples[..., 0]]


def _scaled(v: np.ndarray, depth: int) -> np.ndarray:
    """1/2/4-bit gray samples spread over 0-255 (v · 255 / (2^depth − 1))."""
    return v * np.uint8(255 // ((1 << depth) - 1)) if depth < 8 else v


def read_png(path: str) -> np.ndarray:
    """The pixels of a PNG: [H, W] for grayscale, [H, W, 2] gray + alpha,
    [H, W, 3] RGB, [H, W, 4] RGBA; uint8, or uint16 at bit depth 16.
    1/2/4-bit gray is spread over 0-255; a palette image gives RGB, or RGBA
    with its ``tRNS`` alphas (255 past their end)."""
    img, color, depth, palette, trns = decode_png(path)
    if color == 3:
        rgb = _palette_rgb(img, palette)
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns[:256], np.uint8)
        return np.concatenate([rgb, alpha[img[..., 0]][..., None]], axis=-1)
    if color == 0:
        return _scaled(img[..., 0], depth)
    return img


def read_gray_png(path: str) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: [H, W] uint8. Alpha and
    ``tRNS`` are dropped; 16-bit samples keep their high byte; 1/2/4-bit gray
    is spread over 0-255; colour (a palette expanded first) becomes gray by
    cv2's fixed point: (19594·R + 38468·G + 7474·B) >> 16 at 8 bits, the
    same + 32768 at 16 bits, then the high byte."""
    img, color, depth, palette, _ = decode_png(path)
    if color == 3:
        img, color = _palette_rgb(img, palette), 2
    if color in (0, 4):
        g = img[..., 0]
        return (g >> 8).astype(np.uint8) if depth == 16 else _scaled(g, depth)
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    y = 19594 * r + 38468 * g + 7474 * b
    return ((y + 32768) >> 24 if depth == 16 else y >> 16).astype(np.uint8)


def read_rgb_png(path: str) -> np.ndarray:
    """PIL's ``Image.open(path).convert("RGB")``: [H, W, 3] uint8. Alpha and
    ``tRNS`` are dropped; a palette is looked up; 1/2/4-bit gray is spread
    over 0-255; 16-bit gray is clipped to 255 (PIL's ``I;16`` → ``L``), the
    other 16-bit types keep their high byte; gray is repeated."""
    img, color, depth, palette, _ = decode_png(path)
    if color == 3:
        return _palette_rgb(img, palette)
    if color in (0, 4):
        g = img[..., 0]
        if depth == 16:
            g = np.minimum(g, 255) if color == 0 else g >> 8
        g = _scaled(g, depth).astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=2)
    rgb = img[..., :3]
    return (rgb >> 8).astype(np.uint8) if depth == 16 else rgb


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
