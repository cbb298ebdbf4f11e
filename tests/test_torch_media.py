"""The port's host media loaders (``ufvideo_tpu_torch/mm_utils.py``) against
``ufvideo_tpu.mm_utils`` on the same files and arrays: frame sampling, an
mp4 (cv2), a gif (imageio), a frame directory (PIL), arrays and PIL
images, ``s`` / ``e`` windows and their clamps, short-video padding,
``frame_idx``, the image branch and the SigLIP / SAM host preprocessing.
Tolerance: exact (both packages run the same PIL and numpy code)."""

import numpy as np
import pytest

from ufvideo_tpu import mm_utils as jmm
from ufvideo_tpu_torch import mm_utils as mm


def _equal(got, want):
    """Nested tuples / lists / arrays / scalars equal element for element."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, type(want)) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """An mp4 of 23 frames at 10 fps, a gif of 9 frames and a directory of
    7 PNG frames, 30 x 40 RGB, written from seeded noise."""
    import cv2
    import imageio
    from PIL import Image

    root = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (23, 30, 40, 3), dtype=np.uint8)
    mp4 = str(root / "clip.mp4")
    writer = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (40, 30))
    for f in frames:
        writer.write(f)
    writer.release()
    gif = str(root / "clip.gif")
    imageio.mimsave(gif, list(frames[:9]), duration=0.04)
    frame_dir = root / "frames"
    frame_dir.mkdir()
    for i, f in enumerate(frames[:7]):
        Image.fromarray(f).save(frame_dir / f"{i:05d}.png")
    image = str(root / "image.png")
    Image.fromarray(frames[0, :, :24]).save(image)
    return dict(mp4=mp4, gif=gif, dir=str(frame_dir), image=image, frames=frames)


@pytest.mark.parametrize("duration,num_frames", [(23, 8), (5, 8), (100, 32), (1, 4)])
def test_frame_sample_uniform_equals_jax(duration, num_frames):
    _equal(mm.frame_sample(duration, "uniform", num_frames=num_frames),
           jmm.frame_sample(duration, "uniform", num_frames=num_frames))


@pytest.mark.parametrize("duration,fps", [(23, 10.0), (7, 3.0), (9, 25.0), (300, 29.97)])
def test_frame_sample_fps_equals_jax(duration, fps):
    _equal(mm.frame_sample(duration, "fps", fps=fps), jmm.frame_sample(duration, "fps", fps=fps))
    with pytest.raises(ValueError, match="Unsupported"):
        mm.frame_sample(duration, "random")


LOAD_CASES = [
    pytest.param("mp4", {}, id="mp4"),
    pytest.param("mp4", {"num_frames": None}, id="mp4-fps"),
    pytest.param("mp4", {"s": 0.5, "e": 1.5}, id="mp4-window"),
    pytest.param("mp4", {"s": 1.5, "e": 0.5}, id="mp4-window-swapped"),
    pytest.param("mp4", {"s": 1.0, "e": 1.0}, id="mp4-window-empty"),
    pytest.param("mp4", {"s": 50.0, "e": 60.0}, id="mp4-window-beyond-the-end"),
    pytest.param("mp4", {"num_frames": 40, "frame_idx": [0, 5, 22]}, id="mp4-padded-frame-idx"),
    pytest.param("gif", {"num_frames": 4}, id="gif"),
    pytest.param("dir", {"num_frames": 12, "frame_idx": [1, 6]}, id="frame-dir-padded"),
    pytest.param("dir", {"num_frames": 3, "s": 0.4, "e": 2.0}, id="frame-dir-window"),
    pytest.param("array", {"num_frames": 8, "frame_idx": [2, 3]}, id="array"),
    pytest.param("array-short", {"num_frames": 8}, id="array-padded"),
    pytest.param("list", {"num_frames": 4}, id="list-of-arrays"),
    pytest.param("pil", {"num_frames": 4}, id="list-of-pil-images"),
    pytest.param("paths", {"num_frames": 4}, id="list-of-paths"),
]


def _source(media, kind):
    import os

    from PIL import Image

    frames = media["frames"]
    return {
        "mp4": lambda: media["mp4"],
        "gif": lambda: media["gif"],
        "dir": lambda: media["dir"],
        "array": lambda: frames,
        "array-short": lambda: frames[:3],
        "list": lambda: list(frames[:6]),
        "pil": lambda: [Image.fromarray(f) for f in frames[:6]],
        "paths": lambda: [os.path.join(media["dir"], n) for n in sorted(os.listdir(media["dir"]))],
    }[kind]()


@pytest.mark.parametrize("kind,kw", LOAD_CASES)
def test_load_frames_equals_jax(media, kind, kw):
    got = mm.load_frames(_source(media, kind), **kw)
    want = jmm.load_frames(_source(media, kind), **kw)
    _equal(got, want)
    n = kw.get("num_frames", mm.NUM_FRAMES)
    if n is not None:
        assert len(got[0]) == n


@pytest.mark.parametrize("kind,kw", [
    pytest.param("mp4", {"num_frames": 6, "frame_idx": [0, 4]}, id="mp4-pad"),
    pytest.param("mp4", {"num_frames": 6, "aspect_ratio": "none", "frame_idx": [3]},
                 id="mp4-no-pad"),
    pytest.param("gif", {"num_frames": 5, "s": 0.0, "e": 0.2}, id="gif-window"),
    pytest.param("array", {"num_frames": 4, "image_size": 28}, id="array"),
])
def test_process_video_equals_jax(media, kind, kw):
    kw = dict(kw)
    kw.setdefault("image_size", 56)
    got = mm.process_video(_source(media, kind), **kw)
    _equal(got, jmm.process_video(_source(media, kind), **kw))
    assert got[0].dtype == np.float32 and got[0].shape[1:] == (kw["image_size"],) * 2 + (3,)


@pytest.mark.parametrize("aspect_ratio", ["pad", "none"])
def test_process_image_equals_jax(media, aspect_ratio):
    for src in (media["image"], media["frames"][3]):
        _equal(mm.process_image(src, aspect_ratio), jmm.process_image(src, aspect_ratio))


def test_siglip_and_sam_preprocess_equal_jax(media):
    frames = list(media["frames"][:2])
    _equal(mm.siglip_preprocess(frames, 56), jmm.siglip_preprocess(frames, 56))
    _equal(mm.sam_preprocess(frames, 64), jmm.sam_preprocess(frames, 64))
    sam = mm.sam_preprocess(frames[:1])
    _equal(sam, jmm.sam_preprocess(frames[:1]))
    assert sam.shape == (1, mm.SAM_SIZE, mm.SAM_SIZE, 3)
    for name in ("SIGLIP_SIZE", "SIGLIP_MEAN", "SIGLIP_STD", "SAM_SIZE", "SAM_MEAN", "SAM_STD"):
        _equal(getattr(mm, name), getattr(jmm, name))


def test_geometry_helpers_equal_jax(media):
    f = media["frames"][0]
    for img in (f, f[:, :17], f[:11]):
        _equal(mm.expand2square(img, (127, 127, 127)), jmm.expand2square(img, (127, 127, 127)))
    grid = media["frames"][:5]
    _equal(mm.create_photo_grid(grid, 2, 3), jmm.create_photo_grid(grid, 2, 3))
    for path in ("/ckpt/ufvideo-7b/", "runs/ufvideo/checkpoint-1200", "model"):
        assert mm.get_model_name_from_path(path) == jmm.get_model_name_from_path(path)


def test_unreadable_video_names_the_path(tmp_path):
    bad = str(tmp_path / "missing.mp4")
    with pytest.raises(IOError, match="missing.mp4"):
        mm.load_frames(bad)
