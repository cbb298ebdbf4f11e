"""Host media loading and preprocessing, multimodal tokenization,
stop-string trimming and streamed text deltas: a copy of
``ufvideo_tpu/mm_utils.py``.

The loaders decode videos (cv2), gifs (imageio) and frame directories
(``.png`` frames through ``eval/png.py``, other images through PIL), sample
frames at segment midpoints or one a second, pad to square and preprocess
for SigLIP or SAM on the host with PIL's bicubic filter written out in
``resize_bicubic`` (the same pixels as PIL); their pixel outputs are float32
NHWC numpy arrays, as in the JAX package. The serving path's device
preprocessing is ``ops/image_pipeline.py`` (uint8 frames in). PIL, cv2 and
imageio are imported inside the functions that need them, so the module
imports on a machine that has none of them, and a directory of PNG frames
is loaded and preprocessed there.
"""

from __future__ import annotations

import functools
import math
import os
import sys
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .constants import MODAL_INDEX_MAP, NUM_FRAMES, NUM_FRAMES_PER_SECOND

# SigLIP so400m processor constants (HF SiglipImageProcessor config)
SIGLIP_SIZE = 384
SIGLIP_MEAN = np.array([0.5, 0.5, 0.5], np.float32)
SIGLIP_STD = np.array([0.5, 0.5, 0.5], np.float32)

# SAM preprocessing constants
SAM_SIZE = 1024
SAM_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
SAM_STD = np.array([58.395, 57.12, 57.375], np.float32)


# --------------------------------------------------------------------------
# frame sampling
# --------------------------------------------------------------------------

def frame_sample(
    duration: int,
    mode: str = "uniform",
    num_frames: Optional[int] = None,
    fps: Optional[float] = None,
) -> np.ndarray:
    """Segment midpoints in uniform mode; one frame a second in fps mode."""
    if mode == "uniform":
        assert num_frames is not None
        seg_size = float(duration - 1) / num_frames
        mids = [(seg_size * i + seg_size * (i + 1)) / 2 for i in range(num_frames)]
        return np.round(np.array(mids) + 1e-6).astype(int)
    if mode == "fps":
        assert fps is not None
        segment_len = min(int(fps) // NUM_FRAMES_PER_SECOND, duration)
        segment_len = max(segment_len, 1)
        return np.arange(segment_len // 2, duration, segment_len, dtype=int)
    raise ValueError(f"Unsupported frame sampling mode: {mode}")


# --------------------------------------------------------------------------
# decode backends
# --------------------------------------------------------------------------

def _read_video_cv2(path: str, indices: Sequence[int]) -> List[np.ndarray]:
    import cv2

    cap = cv2.VideoCapture(path)
    frames = {}
    want = sorted(set(int(i) for i in indices))
    pos = 0
    for target in want:
        if target != pos:
            cap.set(cv2.CAP_PROP_POS_FRAMES, target)
            pos = target
        ok, frame = cap.read()
        pos += 1
        if not ok:
            break
        frames[target] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    last = frames[max(frames)]
    return [frames.get(int(i), last) for i in indices]


def _video_meta_cv2(path: str) -> Tuple[float, int]:
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return float(fps), n


# --------------------------------------------------------------------------
# geometry / normalization
# --------------------------------------------------------------------------

def expand2square(img: np.ndarray, fill: Sequence[int]) -> np.ndarray:
    """Pad to square with the given RGB fill, centered."""
    h, w = img.shape[:2]
    if h == w:
        return img
    side = max(h, w)
    out = np.empty((side, side, 3), img.dtype)
    out[...] = np.asarray(fill, img.dtype)
    top = (side - h) // 2
    left = (side - w) // 2
    out[top : top + h, left : left + w] = img
    return out


# PIL's bicubic resampling (Pillow's Resample.c), written out so that the
# host preprocessing needs no PIL: a separable filter whose taps are rounded
# to fixed point with 22 fraction bits, a horizontal pass rounded to uint8,
# then a vertical pass. The sums are integers below 2**53, so float64
# products give them exactly, and the pixels equal PIL's.
_RESAMPLE_BITS = 22


def _bicubic_taps(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    a = -0.5
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


@functools.lru_cache(maxsize=16)
def _bicubic_matrix(in_size: int, out_size: int) -> "torch.Tensor":
    """[in_size, out_size] float64: PIL's fixed-point taps of each output
    pixel, in its input columns."""
    import torch

    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    count = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    k = np.arange(ksize)
    valid = k[None, :] < count[:, None]
    cols = k[None, :] + xmin[:, None]
    w = np.where(valid, _bicubic_taps((cols - center[:, None] + 0.5) * (1.0 / filterscale)),
                 0.0)
    total = np.zeros(out_size)
    for j in range(ksize):  # summed in PIL's order
        total = total + w[:, j]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    one = float(1 << _RESAMPLE_BITS)
    fixed = np.where(w < 0, np.trunc(-0.5 + w * one), np.trunc(0.5 + w * one))
    mat = np.zeros((in_size, out_size))
    mat[cols[valid], np.broadcast_to(np.arange(out_size)[:, None], cols.shape)[valid]] = \
        fixed[valid]
    return torch.from_numpy(mat)


def _round_resampled(acc: "torch.Tensor") -> "torch.Tensor":
    one = float(1 << _RESAMPLE_BITS)
    return acc.add_(one / 2).div_(one).floor_().clamp_(0, 255)


def resize_bicubic(frames: np.ndarray, size: int, chunk: int = 8) -> np.ndarray:
    """uint8 [T, H, W, 3] → uint8 [T, size, size, 3], equal to PIL's
    ``Image.resize((size, size), Image.BICUBIC)`` frame by frame; ``chunk``
    frames at a time (float64 on the host)."""
    import torch

    frames = np.asarray(frames, np.uint8)
    t, h, w, c = frames.shape
    out = np.empty((t, size, size, c), np.uint8)
    for i in range(0, t, chunk):
        x = torch.from_numpy(frames[i:i + chunk]).permute(0, 1, 3, 2).to(torch.float64)
        if w != size:
            x = _round_resampled(x @ _bicubic_matrix(w, size))  # [t, H, C, size]
        if h != size:
            n = x.shape[0]
            x = _round_resampled(_bicubic_matrix(h, size).T @ x.reshape(n, h, -1))
            x = x.reshape(n, size, c, size)
        out[i:i + chunk] = x.permute(0, 1, 3, 2).to(torch.uint8).numpy()
    return out


def _resize_frames(frames: Sequence[np.ndarray], size: int) -> np.ndarray:
    """Each frame bicubic-resized to size x size (frames of one shape go
    through ``resize_bicubic`` together)."""
    frames = [np.asarray(f).astype(np.uint8, copy=False) for f in frames]
    out = np.empty((len(frames), size, size, 3), np.uint8)
    by_shape = {}
    for i, f in enumerate(frames):
        by_shape.setdefault(f.shape, []).append(i)
    for idx in by_shape.values():
        out[idx] = resize_bicubic(np.stack([frames[i] for i in idx]), size)
    return out


def siglip_preprocess(
    frames: Sequence[np.ndarray], size: int = SIGLIP_SIZE
) -> np.ndarray:
    """uint8 RGB frames → [T, size, size, 3] float32, SigLIP-normalized."""
    out = _resize_frames(frames, size).astype(np.float32)
    return (out / 255.0 - SIGLIP_MEAN) / SIGLIP_STD


def sam_preprocess(
    frames: Sequence[np.ndarray], size: int = SAM_SIZE
) -> np.ndarray:
    """uint8 RGB frames → [T, size, size, 3] float32 for SAM2: direct resize
    (no padding), then the ImageNet-style normalisation."""
    out = _resize_frames(frames, size).astype(np.float32)
    return (out - SAM_MEAN) / SAM_STD


# --------------------------------------------------------------------------
# top-level loaders
# --------------------------------------------------------------------------

def load_frames(
    video_path: Union[str, np.ndarray, List],
    s: Optional[float] = None,
    e: Optional[float] = None,
    num_frames: Optional[int] = NUM_FRAMES,
    frame_idx: Optional[Sequence[int]] = None,
) -> Tuple[List[np.ndarray], Optional[List[np.ndarray]], int, int]:
    """Decode + sample frames.

    Returns (sampled uint8 RGB frames, dense frames at ``frame_idx`` for the
    SAM branch or None, original height, original width).
    """
    if isinstance(video_path, str):
        if s is not None and e is not None:
            s, e = max(s, 0.0), max(e, 0.0)
            if s > e:
                s, e = e, s
            elif s == e:
                e = s + 1

        if os.path.isdir(video_path):
            files = sorted(os.listdir(video_path))
            fps, n = 3.0, len(files)
            read = lambda idxs: [_read_frame_file(os.path.join(video_path, files[i]))
                                 for i in idxs]
        elif video_path.endswith(".gif"):
            import imageio

            reader = imageio.get_reader(video_path)
            gif_frames = [np.asarray(f)[..., :3] for f in reader]
            fps, n = 25.0, len(gif_frames)
            read = lambda idxs: [gif_frames[i] for i in idxs]
        else:
            fps, n = _video_meta_cv2(video_path)
            read = lambda idxs: _read_video_cv2(video_path, idxs)

        if n <= 0:
            # cv2 reports 0 frames for unreadable paths and for containers
            # without a frame count: name the path
            raise IOError(f"no decodable frames in {video_path!r} (n={n})")
        f_start = 0 if s is None else max(int(s * fps) - 1, 0)
        f_end = n - 1 if e is None else max(min(int(e * fps) - 1, n - 1), 0)
        f_start = min(f_start, f_end)  # s / e beyond the video clamp
        frame_indices = list(range(f_start, f_end + 1))
        duration = len(frame_indices)
        if num_frames is None:
            sampled = [frame_indices[i] for i in frame_sample(duration, "fps", fps=fps)]
        else:
            sampled = [
                frame_indices[i]
                for i in frame_sample(duration, "uniform", num_frames=num_frames)
            ]
        frames = read(sampled)
        dense = read(list(frame_idx)) if frame_idx is not None else None
    else:
        if isinstance(video_path, np.ndarray):
            arr = [video_path[i] for i in range(len(video_path))]
        elif isinstance(video_path[0], str):
            from PIL import Image

            arr = [np.asarray(Image.open(f).convert("RGB")) for f in video_path]
        else:
            arr = [_pil_or_array(f) for f in video_path]
        frames = arr
        dense = [arr[i] for i in frame_idx] if frame_idx is not None else None
        if num_frames is not None and len(frames) > num_frames:
            sel = frame_sample(len(frames), "uniform", num_frames=num_frames)
            frames = [frames[i] for i in sel]

    # zero-pad short videos
    while num_frames is not None and len(frames) < num_frames:
        frames.append(np.zeros_like(frames[-1]))
    if num_frames is not None:
        frames = frames[:num_frames]

    h, w = frames[0].shape[:2]
    return frames, dense, h, w


def _read_frame_file(path: str) -> np.ndarray:
    """One frame of a frame directory as uint8 RGB: a ``.png`` through the
    port's own codec (no PIL needed), anything else through PIL; the pixels
    are what PIL's ``convert("RGB")`` gives, in every PNG mode
    (``eval.png.read_rgb_png``)."""
    if path.lower().endswith(".png"):
        from .eval.png import read_rgb_png

        return read_rgb_png(path)
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def _pil_or_array(f) -> np.ndarray:
    """A PIL image as RGB, anything else through numpy. A PIL image exists
    only once ``PIL.Image`` is imported, so this imports nothing."""
    pil = sys.modules.get("PIL.Image")
    if pil is not None and isinstance(f, pil.Image):
        return np.asarray(f.convert("RGB"))
    return np.asarray(f)


def process_video(
    video_path,
    s: Optional[float] = None,
    e: Optional[float] = None,
    aspect_ratio: str = "pad",
    num_frames: Optional[int] = NUM_FRAMES,
    frame_idx: Optional[Sequence[int]] = None,
    image_size: int = SIGLIP_SIZE,
):
    """The whole video branch: returns (video [T, image_size, image_size, 3]
    f32, dense SigLIP frames or None, height, width, raw dense frames list).
    """
    frames, dense, h, w = load_frames(video_path, s, e, num_frames, frame_idx)
    fill = tuple(int(x * 255) for x in SIGLIP_MEAN)
    if aspect_ratio == "pad":
        frames = [expand2square(f, fill) for f in frames]
        video = siglip_preprocess(frames, image_size)
        dense_proc = (
            siglip_preprocess([expand2square(f, fill) for f in dense], image_size)
            if dense is not None
            else None
        )
    else:
        video = siglip_preprocess(frames, image_size)
        dense_proc = siglip_preprocess(dense, image_size) if dense is not None else None
    raw_dense = list(dense) if dense is not None else []
    return video, dense_proc, h, w, raw_dense


def process_image(
    image_path, aspect_ratio: str = "pad", image_size: int = SIGLIP_SIZE
) -> Tuple[np.ndarray, int, int, List[np.ndarray]]:
    """The image branch: one frame for SigLIP, four copies for SAM."""
    if isinstance(image_path, str):
        from PIL import Image

        img = np.asarray(Image.open(image_path).convert("RGB"))
    else:
        img = np.asarray(image_path)
    h, w = img.shape[:2]
    frame_list = [img.copy() for _ in range(4)]
    if aspect_ratio == "pad":
        img = expand2square(img, tuple(int(x * 255) for x in SIGLIP_MEAN))
    return siglip_preprocess([img], image_size), h, w, frame_list


# --------------------------------------------------------------------------
# multimodal tokenization
# --------------------------------------------------------------------------


def tokenizer_multimodal_token(
    prompt: str, tokenizer, multimodal_token: str = "<image>"
) -> List[int]:
    """Split on the modal tag and interleave its negative sentinel id."""
    idx = MODAL_INDEX_MAP.get(multimodal_token)
    if idx is None:
        return tokenizer(prompt, add_special_tokens=False).input_ids
    chunks = [
        tokenizer(c, add_special_tokens=False).input_ids
        for c in prompt.split(multimodal_token)
    ]
    input_ids: List[int] = []
    for i in range(1, 2 * len(chunks)):
        if i % 2 == 1:
            input_ids.extend(chunks[i // 2])
        else:
            input_ids.append(idx)
    return input_ids


def create_photo_grid(frames: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Tile T frames into a rows x cols grid image."""
    t, h, w, c = frames.shape
    grid = np.zeros((rows * h, cols * w, c), frames.dtype)
    for i in range(min(t, rows * cols)):
        r, cc = divmod(i, cols)
        grid[r * h : (r + 1) * h, cc * w : (cc + 1) * w] = frames[i]
    return grid


def trim_at_stop_strings(text: str, keywords: Sequence[str]) -> str:
    """Cut ``text`` at the earliest occurrence of any keyword."""
    cut = len(text)
    for kw in keywords:
        pos = text.find(kw)
        if pos != -1:
            cut = min(cut, pos)
    return text[:cut]


class TextDeltaStreamer:
    """Token ids pushed a chunk at a time → text deltas whose join equals the
    one-shot (stop-trimmed) decode.

    Cumulative decoding is append-only but for two hazards, both removed by
    holding an unemitted tail back:

    - a multi-byte character split across chunks decodes to a trailing
      U+FFFD that the next chunk rewrites: trailing replacement characters
      are never emitted before ``finish``;
    - a stop string spanning a chunk boundary would stream its prefix: the
      last ``len(longest stop) - 1`` characters are reserved, so a stop can
      only begin inside unemitted text.

    ``push(ids) -> (delta, stopped)`` per chunk; ``finish() -> delta``
    flushes the held tail when generation ends."""

    def __init__(self, tokenizer, stop_strings: Sequence[str] = ()):
        self._tok = tokenizer
        self._stops = [s for s in (stop_strings or []) if s]
        self._reserve = max((len(s) for s in self._stops), default=1) - 1
        self._ids: list = []
        self._sent = 0  # characters already emitted
        self.stopped = False

    def _decode(self) -> str:
        return self._tok.decode(self._ids, skip_special_tokens=True)

    def push(self, new_ids: Sequence[int]):
        self._ids.extend(int(i) for i in new_ids)
        text = self._decode()
        if self._stops and any(s in text for s in self._stops):
            text = trim_at_stop_strings(text, self._stops)
            self.stopped = True
            delta = text[self._sent:]
            self._sent = len(text)
            return delta, True
        end = len(text)
        while end > 0 and text[end - 1] == "\ufffd":
            end -= 1
        safe = max(self._sent, min(end, len(text) - self._reserve))
        delta = text[self._sent:safe]
        self._sent = safe
        return delta, False

    def finish(self) -> str:
        """The held tail (a trailing U+FFFD of generation that really ends
        mid-character is emitted here: the one-shot decode holds it too)."""
        text = self._decode()
        if self._stops and any(s in text for s in self._stops):
            text = trim_at_stop_strings(text, self._stops)
            self.stopped = True
        delta = text[self._sent:]
        self._sent = len(text)
        return delta

    def text(self) -> str:
        """The whole (stop-trimmed) text so far."""
        text = self._decode()
        if self._stops and any(s in text for s in self._stops):
            text = trim_at_stop_strings(text, self._stops)
        return text

    @property
    def ids(self) -> list:
        """Every token id pushed so far."""
        return list(self._ids)


def get_model_name_from_path(model_path: str) -> str:
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]
