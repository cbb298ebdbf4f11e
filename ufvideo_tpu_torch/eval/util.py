"""Eval-harness plumbing: rank sharding, per-rank JSONL files, mask PNGs.

The dataset is cut into contiguous chunks, one a rank, and each rank writes
``{output}_rank{r}.json`` as JSONL; the scorers merge the ranks' files by
glob. No collectives: the rank comes from ``RANK`` / ``WORLD_SIZE`` (as
torchrun sets them), so the same code runs as one process or many.
"""

from __future__ import annotations

import glob
import json
import math
import os
from typing import Any, Dict, List, Sequence

import numpy as np

from .png import read_gray_png, write_png


def get_rank_world() -> tuple:
    """(rank, world) from ``RANK`` / ``WORLD_SIZE``, else (0, 1)."""
    if "RANK" in os.environ:
        return int(os.environ["RANK"]), int(os.environ.get("WORLD_SIZE", 1))
    return 0, 1


def split_chunks(items: Sequence, n: int) -> List[Sequence]:
    """``n`` contiguous chunks of ceil(len / n) items (the last ones may be
    short or empty)."""
    size = math.ceil(len(items) / n)
    return [items[i * size : (i + 1) * size] for i in range(n)]


def get_chunk(items: Sequence, n: int, k: int) -> Sequence:
    chunks = split_chunks(items, n)
    return chunks[k] if k < len(chunks) else []


def rank_output_path(base: str, rank: int) -> str:
    root, ext = os.path.splitext(base)
    return f"{root}_rank{rank}{ext or '.json'}"


class JsonlWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "w")

    def write(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_all_ranks(base: str) -> List[Dict[str, Any]]:
    """Every rank's JSONL records, the files in name order."""
    root, ext = os.path.splitext(base)
    out: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(f"{root}_rank*{ext or '.json'}")):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
    return out


def save_mask_pngs(out_dir: str, sample_id, masks: np.ndarray) -> None:
    """One grayscale PNG a frame, ``{out_dir}/{sample_id}/{i}.png``: 255
    where the mask is > 0, else 0."""
    d = os.path.join(out_dir, str(sample_id))
    os.makedirs(d, exist_ok=True)
    for i, m in enumerate(masks):
        write_png(os.path.join(d, f"{i}.png"), (np.asarray(m) > 0).astype(np.uint8) * 255)


def load_mask_pngs(pred_dir: str, sample_id) -> List[np.ndarray]:
    """A sample's mask PNGs in frame order, as uint8 {0, 1} (> 127)."""
    d = os.path.join(pred_dir, str(sample_id))
    paths = sorted(
        glob.glob(os.path.join(d, "*.png")),
        key=lambda p: int(os.path.splitext(os.path.basename(p))[0]),
    )
    return [(read_gray_png(p) > 127).astype(np.uint8) for p in paths]
