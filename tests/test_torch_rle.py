"""The port's COCO RLE codec (numpy only) against ``ufvideo_tpu.rle``, which
runs its native codec where it builds: the same counts strings, the same
decoded masks, polygons, ``merge``, and the error on corrupt counts.
Tolerance: exact (strings and integer masks)."""

import numpy as np
import pytest

from ufvideo_tpu import rle as jrle
from ufvideo_tpu_torch import rle


def _masks():
    rng = np.random.RandomState(0)
    return {
        "random-53x37": (rng.rand(53, 37) > 0.6).astype(np.uint8),
        "random-bool-480x640": rng.rand(480, 640) > 0.5,
        "sparse-31x17": (rng.rand(31, 17) > 0.97).astype(np.uint8),
        "zeros": np.zeros((8, 8), np.uint8),
        "ones": np.ones((8, 8), np.uint8),
        "eye": np.eye(16, dtype=np.uint8),
        "first-pixel-set": np.pad(np.ones((1, 1), np.uint8), ((0, 5), (0, 6))),
        "box-480x640": np.pad(np.ones((240, 214), np.uint8), ((120, 120), (213, 213))),
    }


MASKS = _masks()


@pytest.mark.parametrize("name", list(MASKS))
def test_encode_equals_jax_and_decode_round_trips(name):
    m = MASKS[name]
    got, want = rle.encode(m), jrle.encode(m)
    assert got == want
    np.testing.assert_array_equal(rle.decode(got), m.astype(np.uint8))
    np.testing.assert_array_equal(rle.decode(want), jrle.decode(want))


@pytest.mark.parametrize("name", ["random-53x37", "sparse-31x17", "eye", "first-pixel-set"])
def test_counts_codecs_equal_jax(name):
    """Compressed counts → runs → compressed counts, and decode of the
    uncompressed run list, equal to JAX's."""
    counts = jrle.encode(MASKS[name])["counts"]
    runs = rle._decode_counts(counts)
    assert runs == jrle._decode_counts(counts) == rle._decode_counts(counts.encode("ascii"))
    assert rle._encode_counts(runs) == jrle._encode_counts(runs) == counts
    h, w = MASKS[name].shape
    np.testing.assert_array_equal(rle.decode({"size": [h, w], "counts": runs}),
                                  jrle.decode({"size": [h, w], "counts": runs}))


def test_uncompressed_counts():
    ann = {"size": [4, 4], "counts": [3, 5, 8]}
    got = rle.ann_to_mask(ann)
    np.testing.assert_array_equal(got, jrle.ann_to_mask(ann))
    assert got.sum() == 5 and got.shape == (4, 4)


def test_merge_equals_jax():
    a = np.zeros((16, 16), np.uint8)
    a[:8] = 1
    b = np.zeros((16, 16), np.uint8)
    b[:, :8] = 1
    parts = [jrle.encode(a), jrle.encode(b), jrle.encode(MASKS["eye"])]
    got = rle.merge(parts)
    assert got == jrle.merge(parts)
    np.testing.assert_array_equal(rle.decode(got), a | b | MASKS["eye"])


@pytest.mark.parametrize("polys,h,w", [
    ([[1, 1, 14, 1, 7, 12]], 16, 16),
    ([[2.4, 3.6, 30.2, 5.1, 28.7, 20.9, 4.4, 18.2], [35, 2, 45, 2, 40, 12]], 24, 48),
])
def test_polygons_equal_jax(polys, h, w):
    assert rle.poly_to_rle(polys, h, w) == jrle.poly_to_rle(polys, h, w)
    got = rle.ann_to_mask(polys, h, w)
    np.testing.assert_array_equal(got, jrle.ann_to_mask(polys, h, w))
    assert 0 < got.sum() < h * w
    with pytest.raises(ValueError, match="explicit h/w"):
        rle.ann_to_mask(polys)


def test_corrupt_counts_raise_as_in_jax():
    """Counts that do not sum to h*w are refused, not tiled or truncated:
    runs that overflow the size (both codecs of the JAX package refuse
    them) and runs that fall short of it (here JAX's numpy path refuses
    them; its native codec returns the mask with the tail unwritten)."""
    counts = jrle.encode(MASKS["random-53x37"])["counts"]
    runs = jrle._decode_counts(counts)
    for size in ([53, 36], [37, 54]):
        with pytest.raises(ValueError, match="expected h\\*w"):
            rle.decode({"size": size, "counts": counts})
        with pytest.raises(ValueError, match="expected h\\*w"):
            jrle.decode({"size": size, "counts": runs})
    with pytest.raises(ValueError, match="expected h\\*w"):
        jrle.decode({"size": [53, 36], "counts": counts})
