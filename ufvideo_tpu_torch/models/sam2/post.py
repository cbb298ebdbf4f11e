"""Mask postprocessing on the host (own copy of
``ufvideo_tpu/models/sam2/post.py``). Hole filling is off by default and no
entry point of this package calls it; ``cv2`` is imported only inside it.
"""

from __future__ import annotations

import numpy as np


def fill_holes_in_mask_scores(mask: np.ndarray, max_area: int) -> np.ndarray:
    """Fill background connected components with area <= max_area by setting
    their scores to a small positive value (0.1)."""
    import cv2

    if max_area <= 0:
        return mask
    out = np.asarray(mask, np.float32).copy()
    background = (out <= 0).astype(np.uint8)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(background, 8)
    for comp in range(1, n):
        if stats[comp, cv2.CC_STAT_AREA] <= max_area:
            out[labels == comp] = 0.1
    return out
