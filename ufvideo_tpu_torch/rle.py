"""COCO run-length-encoded mask codec in numpy (a copy of
``ufvideo_tpu/rle.py`` without its native codec: column-major runs,
LEB128-like character-packed counts, the strings pycocotools writes).

Host code: the serving layer decodes request masks and encodes result masks
with it on the HTTP handler threads.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def _decode_counts(s: Union[str, bytes]) -> List[int]:
    """COCO compressed counts string → run lengths."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: List[int] = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_counts(counts: Sequence[int]) -> str:
    """Run lengths → COCO compressed counts string."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def decode(rle: Dict) -> np.ndarray:
    """RLE dict {'size': [h, w], 'counts': str|bytes|list} → uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = _decode_counts(counts)
    counts = np.asarray(counts, dtype=np.int64)
    values = np.zeros(len(counts), dtype=np.uint8)
    values[1::2] = 1  # runs alternate 0, 1, 0, 1, ...
    flat = np.repeat(values, counts)
    if flat.size != h * w:
        # counts that disagree with the size are corrupt (a size recorded
        # as [w, h], truncated counts): fail rather than tile or truncate
        raise ValueError(f"RLE counts sum to {flat.size}, expected h*w={h * w}")
    return flat.reshape((h, w), order="F")


def encode(mask: np.ndarray) -> Dict:
    """uint8/bool mask [h, w] → compressed RLE dict."""
    h, w = mask.shape
    flat = np.asarray(mask, dtype=np.uint8).reshape(-1, order="F")
    change = np.nonzero(np.diff(flat))[0] + 1  # run boundaries
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [flat.size]])
    runs = (ends - starts).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    return {"size": [h, w], "counts": _encode_counts(runs)}


def merge(rles: Sequence[Dict]) -> Dict:
    """Union of masks."""
    out = decode(rles[0])
    for r in rles[1:]:
        out |= decode(r)
    return encode(out)


def poly_to_rle(polys: Sequence[Sequence[float]], h: int, w: int) -> Dict:
    """Polygon(s) → RLE by rasterising with cv2 (imported here: the serving
    path needs it only for polygon annotations)."""
    import cv2

    mask = np.zeros((h, w), dtype=np.uint8)
    pts = [
        np.asarray(p, dtype=np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in polys
    ]
    cv2.fillPoly(mask, pts, 1)
    return encode(mask)


def ann_to_mask(mask_ann, h: int | None = None, w: int | None = None) -> np.ndarray:
    """Polygons, uncompressed RLE or compressed RLE → binary mask."""
    if isinstance(mask_ann, list):
        if h is None or w is None:
            raise ValueError("polygon annotations need explicit h/w to rasterize")
        return decode(poly_to_rle(mask_ann, h, w))
    return decode(mask_ann)
