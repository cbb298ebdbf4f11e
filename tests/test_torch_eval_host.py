"""The port's eval host modules (``ufvideo_tpu_torch/eval``: metrics, rank
plumbing, the PNG codec, the datasets, the scorers, the judge) against
``ufvideo_tpu.eval`` on the same inputs, made from a numpy seed, with no
model. cv2 and PIL are the oracles of the PNG codec, the dilation and the
nearest resize; everything is held exact unless a tolerance is stated.
"""

import argparse
import contextlib
import io
import json
import os
import struct
import subprocess
import sys
import textwrap
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from ufvideo_tpu import rle as jrle
from ufvideo_tpu.eval import datasets as jds
from ufvideo_tpu.eval import judge_description as jjd
from ufvideo_tpu.eval import metrics as jm
from ufvideo_tpu.eval import score_mcqa as jsm
from ufvideo_tpu.eval import score_seg as jss
from ufvideo_tpu.eval import score_tvg as jst
from ufvideo_tpu.eval import util as ju
from ufvideo_tpu_torch import mm_utils
from ufvideo_tpu_torch.eval import datasets as ds
from ufvideo_tpu_torch.eval import judge_description as jd
from ufvideo_tpu_torch.eval import metrics as m
from ufvideo_tpu_torch.eval import png
from ufvideo_tpu_torch.eval import score_mcqa as sm
from ufvideo_tpu_torch.eval import score_seg as ss
from ufvideo_tpu_torch.eval import score_tvg as st
from ufvideo_tpu_torch.eval import util as u

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch (the resize, nothing else here) on one thread: the suite's
    workers share the machine's cores."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
BF_TOL = 1e-12  # boundary F: the same integer counts, divided in the same order


def _blobs(rng, n, h, w):
    out = []
    for _ in range(n):
        mask = np.zeros((h, w), np.uint8)
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(3, max(4, h // 3))
        y, x = np.ogrid[:h, :w]
        mask[(y - cy) ** 2 + (x - cx) ** 2 <= r * r] = 1
        out.append(mask)
    return out


def _mask_pairs():
    rng = np.random.default_rng(0)
    pairs = {}
    for i, (a, b) in enumerate(zip(_blobs(rng, 4, 48, 64), _blobs(rng, 4, 48, 64))):
        pairs[f"blobs{i}"] = (a, b)
    pairs["noise"] = tuple((rng.random((2, 40, 52)) < 0.4).astype(np.uint8))
    edge = np.zeros((48, 64), np.uint8)
    edge[:, :20] = 1
    edge[0, :] = 1
    pairs["border"] = (edge, np.roll(edge, 3, axis=1))
    full = np.ones((30, 40), np.uint8)
    pairs["full-vs-border"] = (full, np.pad(np.ones((28, 38), np.uint8), 1))
    z = np.zeros((30, 40), np.uint8)
    pairs["empty-empty"] = (z, z)
    pairs["empty-gt"] = (z, pairs["blobs0"][0][:30, :40])
    pairs["empty-pred"] = (pairs["blobs0"][0][:30, :40], z)
    pairs["large"] = tuple(m.astype(np.uint8) for m in _blobs(rng, 2, 480, 640))
    return pairs


MASK_PAIRS = _mask_pairs()


@pytest.mark.parametrize("name", sorted(MASK_PAIRS))
def test_region_and_boundary_measures_equal_jax(name):
    gt, pred = MASK_PAIRS[name]
    assert m.region_similarity(gt, pred) == jm.region_similarity(gt, pred)
    assert abs(m.boundary_f_measure(gt, pred) - jm.boundary_f_measure(gt, pred)) <= BF_TOL
    for th in (0.02, 3):
        assert abs(m.boundary_f_measure(gt, pred, th) - jm.boundary_f_measure(gt, pred, th)) \
            <= BF_TOL
    got, want = m.j_and_f(gt, pred), jm.j_and_f(gt, pred)
    assert got[0] == want[0] and all(abs(a - b) <= BF_TOL for a, b in zip(got, want))
    stack = np.stack([gt, pred])
    np.testing.assert_array_equal(m.region_similarity(stack, stack[::-1]),
                                  jm.region_similarity(stack, stack[::-1]))


@pytest.mark.parametrize("radius", [0, 1, 3, 7, 12])
def test_dilation_equals_cv2(radius):
    rng = np.random.default_rng(radius)
    kernel = m._disk(radius)
    np.testing.assert_array_equal(kernel, jm._disk(radius))
    for shape in ((48, 64), (9, 5), (480, 640)):
        mask = (rng.random(shape) < 0.05).astype(np.uint8)
        mask[0, :] = mask[:, -1] = 1  # touching the border
        np.testing.assert_array_equal(m.dilate(mask, kernel), cv2.dilate(mask, kernel))


# the strings of tests/test_eval_metrics.py, and a few more
SPAN_CORPUS = [
    "The event happens at {<TEMP-012>, <TEMP-087>} in the video.",
    "{<TEMP-012>,<TEMP-087>,}",
    "box [<WIDTH-10>, <HEIGHT-20>, <WIDTH-90>, <HEIGHT-80>]",
    "span {1.2, 3.4} and box [0.1, 0.2, 0.3, 0.4]",
    "{ 5 , 9 }",
    "nothing to parse here",
    "<TEMP-000> only one",
    "[12, 34, 56, 78,]",
    "from <TEMP-010> to <TEMP-099>.",
    "{12.5, 30.0}",
    "no numbers",
    "at {<TEMP-012>, <TEMP-087>}.",
    "the span is {1.2, 3.4} ok",
    "between 3 and 7 seconds",
]


def test_span_and_box_parsers_equal_jax():
    for s in SPAN_CORPUS:
        for rt in (False, True):
            assert m.replace_and_normalize(s, rt) == jm.replace_and_normalize(s, rt), s
        norm = m.replace_and_normalize(s)
        assert m.parse_span_from_text(norm) == jm.parse_span_from_text(norm), s
        assert m.format_1d_box(norm) == jm.format_1d_box(norm), s
        assert m.format_2d_box(norm) == jm.format_2d_box(norm), s
        assert m.parse_temporal_span(s) == jm.parse_temporal_span(s), s


def test_mc_matching_iou_and_recall_equal_jax():
    opts = ["a red car", "a blue bike", "a green bus"]
    for pred in ("(B) a blue bike", "B.", "I think it is a green bus", "no idea", "Answer: (A)",
                 "A cat sits", "answer C", "", "(D) none"):
        for o in (opts, opts[:2], ["x"] * 5):
            assert m.match_mc_answer(pred, o) == jm.match_mc_answer(pred, o), (pred, o)
    recs = [{"pred": "A", "gt": "A"}, {"pred": "B", "gt": "C"}, {"pred": "C", "gt": "C"}]
    assert m.accuracy(recs) == jm.accuracy(recs) and m.accuracy([]) == jm.accuracy([])
    rng = np.random.default_rng(1)
    for _ in range(50):
        a, b = rng.uniform(0, 30, 2), rng.uniform(0, 30, 2)
        assert m.temporal_iou(a, b) == jm.temporal_iou(a, b)
    for spans in ([[0, 10], [5, 15]], [[0, 5], [5, 10]], [[2, 4], [2, 4]], [[3, 3], [3, 3]]):
        assert m.temporal_iou(*spans) == jm.temporal_iou(*spans)
    ious = list(rng.uniform(0, 1, 17)) + [0.3, 0.5, 0.7]
    assert m.recall_at_k(ious) == jm.recall_at_k(ious)
    assert m.recall_at_k([]) == jm.recall_at_k([])


def test_rank_plumbing_equals_jax(tmp_path, monkeypatch):
    for n_items in (0, 1, 7, 10, 33):
        items = list(range(n_items))
        for n in (1, 2, 3, 8):
            assert u.split_chunks(items, n) == ju.split_chunks(items, n)
            for k in range(n + 2):
                assert u.get_chunk(items, n, k) == ju.get_chunk(items, n, k)
    for base in ("out.json", "dir/out", "a.b/c.jsonl"):
        for r in (0, 3):
            assert u.rank_output_path(base, r) == ju.rank_output_path(base, r)
    for rank in (1, 0):
        w = u.JsonlWriter(str(tmp_path / "sub" / f"res_rank{rank}.json"))
        w.write({"rank": rank, "x": [1.5, None]})
        w.write({"rank": rank, "y": "z"})
        w.close()
    base = str(tmp_path / "sub" / "res.json")
    assert u.read_all_ranks(base) == ju.read_all_ranks(base) and len(u.read_all_ranks(base)) == 4
    monkeypatch.delenv("RANK", raising=False)
    assert u.get_rank_world() == (0, 1)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert u.get_rank_world() == ju.get_rank_world() == (3, 4)


def _png_filters(path):
    """The row filter types a PNG file uses."""
    data = open(path, "rb").read()
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        hdr = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else hdr
        idat += [body] if kind == b"IDAT" else []
        pos += 12 + n
    w, h, _, color = hdr[:4]
    stride = w * {0: 1, 2: 3, 6: 4}[color] + 1
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * stride] for y in range(h)}


def _test_images(seed):
    rng = np.random.default_rng(seed)
    ramp = (np.add.outer(np.arange(40), np.arange(52)) * 3 % 256).astype(np.uint8)
    return {
        "gray-noise": rng.integers(0, 256, (40, 52), np.uint8),
        "gray-ramp": ramp,
        "rgb-noise": rng.integers(0, 256, (40, 52, 3), np.uint8),
        "rgb-mixed": np.concatenate([rng.integers(0, 256, (16, 52, 3), np.uint8),
                                     np.stack([ramp[:24], ramp[:24] // 2, 255 - ramp[:24]], -1)]),
        "rgb-tall": rng.integers(0, 256, (97, 3, 3), np.uint8),
    }


def test_png_decode_equals_cv2_and_pil(tmp_path):
    """cv2 picks each row's filter adaptively: over these files every one of
    the five filters appears, and every decode equals cv2's and PIL's."""
    seen = set()
    for name, img in _test_images(0).items():
        for level in (0, 1, 9):
            p = str(tmp_path / f"{name}-{level}.png")
            cv2.imwrite(p, img if img.ndim == 2 else img[..., ::-1],
                        [cv2.IMWRITE_PNG_COMPRESSION, level])
            seen |= _png_filters(p)
            got = png.read_png(p)
            by_cv2 = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            by_cv2 = by_cv2 if by_cv2.ndim == 2 else by_cv2[..., ::-1]
            np.testing.assert_array_equal(got, by_cv2)
            np.testing.assert_array_equal(got, np.asarray(Image.open(p)))
            np.testing.assert_array_equal(got, img)
    assert seen == {0, 1, 2, 3, 4}
    rgba = np.random.default_rng(2).integers(0, 256, (20, 30, 4), np.uint8)
    Image.fromarray(rgba, "RGBA").save(tmp_path / "rgba.png")
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "rgba.png")), rgba)


def test_png_encode_round_trips(tmp_path):
    for name, img in _test_images(3).items():
        p = str(tmp_path / f"{name}.png")
        png.write_png(p, img)
        assert _png_filters(p) == {0}
        np.testing.assert_array_equal(png.read_png(p), img)
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
        by_cv2 = cv2.imread(p, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(by_cv2 if by_cv2.ndim == 2 else by_cv2[..., ::-1], img)


def test_png_refuses_what_it_does_not_read(tmp_path):
    """What is no PNG, or a corrupt one, raises and names the file (cv2 reads
    none of these either)."""
    header = lambda depth, color: png._chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, depth,
                                                                  color, 0, 0, 0))
    sig = b"\x89PNG\r\n\x1a\n"
    cases = {
        "corrupt.png": lambda p: open(p, "wb").write(sig + header(8, 0)[:-1] + b"x"),
        "notpng.png": lambda p: open(p, "wb").write(b"GIF89a..."),
        "depth3.png": lambda p: open(p, "wb").write(
            sig + header(3, 0) + png._chunk(b"IDAT", zlib.compress(bytes(32)))
            + png._chunk(b"IEND", b"")),
        "rgb4bit.png": lambda p: open(p, "wb").write(
            sig + header(4, 2) + png._chunk(b"IDAT", zlib.compress(bytes(104)))
            + png._chunk(b"IEND", b"")),
        "noplte.png": lambda p: open(p, "wb").write(
            sig + header(8, 3) + png._chunk(b"IDAT", zlib.compress(bytes(72)))
            + png._chunk(b"IEND", b"")),
        "short.png": lambda p: open(p, "wb").write(
            sig + header(8, 0) + png._chunk(b"IDAT", zlib.compress(bytes(40)))
            + png._chunk(b"IEND", b"")),
        "badzlib.png": lambda p: open(p, "wb").write(
            sig + header(8, 0) + png._chunk(b"IDAT", b"not zlib") + png._chunk(b"IEND", b"")),
    }
    for name, make in cases.items():
        p = str(tmp_path / name)
        make(p)
        assert cv2.imread(p, cv2.IMREAD_GRAYSCALE) is None, name
        for read in (png.read_png, png.read_gray_png, png.read_rgb_png):
            with pytest.raises(ValueError, match=name):
                read(p)
    with pytest.raises(ValueError):
        png.write_png(str(tmp_path / "f.png"), np.zeros((4, 4), np.float32))


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _raw_png(path, samples, depth, color, plte=None, trns=None, interlace=0):
    """A PNG written from its samples [H, W, C] as stored (filter 0), for the
    forms PIL does not write: Adam7, 2/4-bit gray, 16-bit colour."""
    h, w = samples.shape[:2]
    body = []
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        for row in sub.reshape(sub.shape[0], -1) if sub.size else ():
            if depth == 16:
                b = row.astype(">u2").tobytes()
            elif depth == 8:
                b = row.astype(np.uint8).tobytes()
            else:
                bits = np.unpackbits(row.astype(np.uint8)[:, None], axis=1)[:, 8 - depth:]
                b = np.packbits(bits.reshape(-1)).tobytes()
            body.append(b"\0" + b)
    chunks = png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if plte is not None:
        chunks += png._chunk(b"PLTE", np.asarray(plte, np.uint8).tobytes())
    if trns is not None:
        chunks += png._chunk(b"tRNS", trns)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunks + png._chunk(b"IDAT", zlib.compress(
            b"".join(body))) + png._chunk(b"IEND", b""))


def _pil_mode(mode, rng, h, w):
    """A PIL image of ``mode`` and its save options."""
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, (h, w)).astype(bool)), {}
    if mode == "I;16":
        return Image.fromarray(rng.integers(0, 65536, (h, w)).astype(np.uint16)), {}
    if mode.startswith("P"):
        im = Image.fromarray(rng.integers(0, 200, (h, w)).astype(np.uint8), "L").convert("P")
        im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tobytes())
        return im, ({"transparency": bytes(range(0, 250, 5))} if mode == "P-tRNS" else {})
    ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    a = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
    return Image.fromarray(a[..., 0] if ch == 1 else a, mode), {}


PIL_MODES = ["L", "LA", "P", "P-tRNS", "RGB", "RGBA", "1", "I;16"]
# (colour type, bit depth, interlace): the forms PIL does not write
RAW_FORMS = [(0, 2, 0), (0, 4, 0), (3, 2, 0), (3, 4, 1), (2, 16, 0), (6, 16, 1), (4, 16, 0),
             (0, 16, 1), (0, 1, 1), (2, 8, 1), (6, 8, 1), (4, 8, 1), (0, 8, 1)]


def _raw_form(path, color, depth, interlace, rng, h, w):
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    top = (1 << depth) if color != 3 else min(1 << depth, 40)
    samples = rng.integers(0, top, (h, w, ch))
    plte = rng.integers(0, 256, (40, 3)) if color == 3 else None
    trns = bytes(range(0, 200, 10)) if color == 3 and interlace else None
    _raw_png(path, samples, depth, color, plte, trns, interlace)


@pytest.mark.parametrize("form", PIL_MODES + [f"raw-{c}-{d}-{i}" for c, d, i in RAW_FORMS])
def test_png_modes_read_as_cv2_and_pil(tmp_path, form):
    """Every colour type, bit depth and interlace: the mask reader equals
    cv2's ``IMREAD_GRAYSCALE``, the frame reader PIL's ``convert("RGB")``
    (the two libraries read 16-bit gray otherwise: each is its reader's
    oracle), at an odd size that leaves Adam7 passes partial."""
    rng = np.random.default_rng(sum(map(ord, form)))
    p = str(tmp_path / "f.png")
    h, w = 19, 27
    if form.startswith("raw-"):
        _raw_form(p, *map(int, form.split("-")[1:]), rng, h, w)
    else:
        im, opts = _pil_mode(form, rng, h, w)
        im.save(p, **opts)
    gray = png.read_gray_png(p)
    want = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
    assert gray.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(gray, want)
    rgb = mm_utils._read_frame_file(p)
    with Image.open(p) as im:
        want = np.asarray(im.convert("RGB"))
    assert rgb.dtype == np.uint8 and rgb.shape == (h, w, 3)
    np.testing.assert_array_equal(rgb, want)


def test_mask_pngs_cross_packages(tmp_path):
    rng = np.random.default_rng(4)
    masks = np.stack(_blobs(rng, 3, 48, 64)).astype(bool)
    u.save_mask_pngs(str(tmp_path / "port"), "vid1", masks)
    ju.save_mask_pngs(str(tmp_path / "jax"), "vid1", masks)
    for root in ("port", "jax"):
        got, want = (u.load_mask_pngs(str(tmp_path / root), "vid1"),
                     ju.load_mask_pngs(str(tmp_path / root), "vid1"))
        assert len(got) == len(want) == 3
        for a, b, mk in zip(got, want, masks):
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, mk.astype(np.uint8))
    assert u.load_mask_pngs(str(tmp_path), "missing") == []


@pytest.mark.parametrize("src", [(48, 64), (7, 3), (480, 640), (37, 91)])
def test_nearest_resize_equals_cv2(src):
    mask = np.random.default_rng(sum(src)).integers(0, 2, src).astype(np.uint8)
    for dst in ((48, 64), (480, 640), (13, 7), (240, 320), (720, 1280), (3, 10), (1024, 1024)):
        np.testing.assert_array_equal(
            ss.resize_nearest(mask, *dst),
            cv2.resize(mask, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("src,size", [((480, 640), 384), ((480, 640), 1024), ((64, 64), 56),
                                      ((37, 91), 128), ((5, 3), 8), ((100, 7), 2)])
def test_bicubic_resize_equals_pil(src, size):
    frames = np.random.default_rng(size).integers(0, 256, (2,) + src + (3,), np.uint8)
    got = mm_utils.resize_bicubic(frames, size, chunk=1)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(
            g, np.asarray(Image.fromarray(f).resize((size, size), Image.BICUBIC)))


def _run_main(main, argv, monkeypatch, jax_side):
    """A scorer's printed lines: JAX's reads sys.argv, the port's takes argv."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if jax_side:
            monkeypatch.setattr(sys, "argv", ["scorer"] + argv)
            main()
        else:
            main(argv)
    return buf.getvalue()


def _ground_truth_in_other_modes(d, i, gts):
    """The same ground-truth masks as a palette image with ``tRNS``, RGB,
    16-bit gray, Adam7 gray + alpha and a 1-bit image, and a corrupt file in
    place of one frame (cv2 reads it as None, and so must the port)."""
    d.mkdir(exist_ok=True)
    for f, g in enumerate(gts):
        p, k = str(d / f"m{i}_{f}.png"), (3 * i + f) % 5
        if i == 2 and f == 1:
            open(p, "wb").write(b"\x89PNG\r\n\x1a\n broken")
        elif k == 0:
            Image.fromarray(g * 255).convert("P").save(p, transparency=0)
        elif k == 1:
            Image.fromarray(np.repeat(g[..., None] * 200, 3, axis=2)).save(p)
        elif k == 2:
            Image.fromarray(g.astype(np.uint16) * 40000).save(p)
        elif k == 3:
            _raw_png(p, np.stack([g * 255, np.full_like(g, 7)], -1), 8, 4, interlace=1)
        else:
            Image.fromarray(g.astype(bool)).save(p)


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """Two ranks' records of mvbench, q-bench, tvg and mevis outputs, and
    mask PNGs (one sample at another size than its ground truth, one
    without masks) with RLE and PNG ground truth."""
    root = tmp_path_factory.mktemp("scored")
    rng = np.random.default_rng(5)
    recs = {
        "mv": [{"id": i, "pred": "ABC"[i % 3], "gt": "ABCA"[i % 4],
                "task_type": ["action", "scene", ""][i % 3]} for i in range(9)],
        "qb": [{"id": i, "pred": p, "Answer": "(B) sitting", "type": t} for i, (p, t) in
               enumerate([("(B) yes", "Basic"), ("C) no", "Basic"), ("B. sure", "Future"),
                          ("", "Future"), ("b", "Basic")])],
        "tvg": [{"id": i, "vid": f"v{i % 3}", "pred": p, "gt": g} for i, (p, g) in enumerate([
            ("at {<TEMP-010>, <TEMP-060>}.", [0.2, 0.6]), ("{2.5, 7.0}", [3.0, 6.0]),
            ("nothing", [1.0, 4.0]), ("from 1 to 3", [0.1, 0.3])])] + [
            {"id": 9, "vid": "v0", "span": [0.1, 0.5], "pred": "", "gt": [0.2, 0.6]}],
        "seg": [{"id": f"m{i}"} for i in range(4)],
    }
    for name, rows in recs.items():
        for r in range(2):
            w = u.JsonlWriter(str(root / f"{name}_rank{r}.json"))
            for row in rows[r::2]:
                w.write(row)
            w.close()
    gt, gt_png = [], root / "gtpng"
    gt_png.mkdir()
    for i in range(4):
        h, w = (48, 64) if i != 1 else (96, 128)
        gts = _blobs(rng, 3, h, w)
        preds = _blobs(rng, 3, 48, 64)
        if i != 3:  # m3 has no prediction: dropped from the average
            u.save_mask_pngs(str(root / "masks"), f"m{i}", np.stack(preds))
        names = []
        for f, g in enumerate(gts):
            names.append(f"m{i}_{f}.png")
            cv2.imwrite(str(gt_png / names[-1]), g * 255)
        gt.append({"id": f"m{i}", "annotation": [jrle.encode(g) for g in gts[:2]] + [None],
                   "file_names": names[:2] + ["absent.png"]})
        _ground_truth_in_other_modes(root / "gtmodes", i, gts)
    (root / "gt.json").write_text(json.dumps(gt))
    (root / "durations.json").write_text(json.dumps({"v0": 10.0, "v1": 30.0}))
    return root


@pytest.mark.parametrize("case", ["mvbench", "qbench", "tvg", "seg-rle", "seg-png",
                                  "seg-png-modes", "seg-empty"])
def test_scorers_print_what_jax_prints(scored, case, monkeypatch):
    r = str(scored)
    argv, mains = {
        "mvbench": (["--pred-path", f"{r}/mv.json"], (sm.main, jsm.main)),
        "qbench": (["--pred-path", f"{r}/qb.json", "--format", "qbench"], (sm.main, jsm.main)),
        "tvg": (["--pred-path", f"{r}/tvg.json", "--durations", f"{r}/durations.json"],
                (st.main, jst.main)),
        "seg-rle": (["--pred-path", f"{r}/seg.json", "--pred-mask-root", f"{r}/masks",
                     "--gt", "rle", "--gt-file", f"{r}/gt.json"],
                    (ss.main, jss.main)),
        "seg-png": (["--pred-path", f"{r}/seg.json", "--pred-mask-root", f"{r}/masks",
                     "--gt", "png", "--gt-mask-root", f"{r}/gtpng", "--gt-file", f"{r}/gt.json"],
                    (ss.main, jss.main)),
        "seg-png-modes": (["--pred-path", f"{r}/seg.json", "--pred-mask-root", f"{r}/masks",
                           "--gt", "png", "--gt-mask-root", f"{r}/gtmodes", "--gt-file",
                           f"{r}/gt.json"], (ss.main, jss.main)),
        "seg-empty": (["--pred-path", f"{r}/seg.json", "--pred-mask-root", f"{r}/none"],
                      (ss.main, jss.main)),
    }[case]
    got = _run_main(mains[0], argv, monkeypatch, False)
    want = _run_main(mains[1], argv, monkeypatch, True)
    assert got == want and got.strip(), (got, want)


class _Msg:
    content = ("1. Subject Correspondence: 4\nExplanation: a\n"
               "2. Appearance Description: 3\nExplanation: b\n"
               "3. Temporal Description: 5\nExplanation: c\n"
               "4. Hallucination Detection: 2\nExplanation: d")


class _Client:
    """The JAX test's stub of the judge's client, which records the messages."""

    def __init__(self):
        self.seen = []
        client = self

        class _Completions:
            @staticmethod
            def create(**kw):
                assert "temperature" not in kw
                client.seen.append(kw)
                return type("R", (), {"choices": [type("C", (), {"message": _Msg()})()]})()

        self.chat = type("Chat", (), {"completions": _Completions()})()


def test_judge_equals_jax_with_a_stub_client(tmp_path, capsys):
    assert jd.SYSTEM_PROMPT == jjd.SYSTEM_PROMPT and jd.DIMENSIONS == jjd.DIMENSIONS
    ours, theirs = _Client(), _Client()
    verdict = jd.judge_one(ours, "gpt-4o", "a dog", "a brown dog")
    assert verdict == jjd.judge_one(theirs, "gpt-4o", "a dog", "a brown dog") == _Msg.content
    assert ours.seen == theirs.seen
    for text in (verdict, "Subject Correspondence：5 Appearance Description: 2.5 "
                 "Temporal Description: 1 Hallucination Detection: 0", "no scores", ""):
        assert jd.extract_scores(text) == jjd.extract_scores(text)
    judged = tmp_path / "judged.json"
    json.dump([{"id": 1, "pred": "x", "judge": verdict}, {"id": 2, "judge": "broken"}],
              open(judged, "w"))
    printed = []
    for mod, out in ((jd, "ours.json"), (jjd, "theirs.json")):
        mod.cmd_extract(argparse.Namespace(**{"in": str(judged), "out": str(tmp_path / out)}))
        mod.cmd_analyze(argparse.Namespace(**{"in": str(tmp_path / out)}))
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and "Average: 3.50" in printed[0]
    assert json.load(open(tmp_path / "ours.json")) == json.load(open(tmp_path / "theirs.json"))
    # the judge subcommand imports openai only when it runs
    with pytest.raises(ImportError):
        jd.cmd_judge(argparse.Namespace(pred_path=str(tmp_path / "x.json"), out="o",
                                        judge_model="m"))


N_RAW = 6


@pytest.fixture(scope="module")
def bench_data(tmp_path_factory):
    """cv2-written frame directories (one of 48x64, one square) and the
    question files of all eight benchmarks (the schemas of
    tests/test_eval_roundtrip.py)."""
    root = tmp_path_factory.mktemp("benchdata")
    rng = np.random.default_rng(6)
    sizes = ((48, 64), (40, 40))
    for v, (h, w) in enumerate(sizes):
        d = root / "videos" / f"vid{v}"
        d.mkdir(parents=True)
        for f in range(N_RAW):
            cv2.imwrite(str(d / f"{f:03d}.png"), rng.integers(0, 255, (h, w, 3), np.uint8))

    def seg(v):
        mask = np.zeros(sizes[v], np.uint8)
        mask[5 + v:20 + v, 6:30 - v] = 1
        return jrle.encode(mask)

    ann = lambda v: [{"1": {"segmentation": seg(v)}, "3": {"segmentation": seg(v)}},
                     {"4": {"segmentation": seg(v)}, "1": None}]
    files = {
        "seg": [{"id": f"s{v}", "video": f"vid{v}", "annotation": ann(v), "frame_idx": 1,
                 "caption": f"object {v}",
                 "conversations": [[{"from": "human", "value": "Describe <region>."}]]}
                for v in range(2)],
        "hqa": [{"id": f"h{v}", "video": f"vid{v}", "annotation": ann(v), "frame_idx": [1, 3],
                 "caption": "at {<TEMP-010>, <TEMP-060>}. object",
                 "conversations": [[{"from": "human", "value": "<video>\nDescribe."},
                                    {"from": "gpt", "value": "at {<TEMP-010>}. x"}]]}
                for v in range(2)] + [
            {"id": "h2", "video": "vid0", "frame_idx": 2,
             "conversations": [[{"from": "human", "value": "<video>\nQ"},
                                {"from": "gpt", "value": "gt caption"}]]}],
        "q": [{"id": f"q{v}", "video": f"vid{v}", "annotation": ann(v), "frame_idx": 1,
               "Question": "What is <region> doing?", "options": ["(A) run", "(B) sit"],
               "Answer": "(B) sit", "type": "Basic"} for v in range(2)],
        "mevis": [{"id": f"m{v}", "video": f"vid{v}", "conversations": [
            {"from": "human", "value": "<video>\nSegment it."},
            {"from": "gpt", "value": "It is [SEG]."}]} for v in range(2)],
        "mcqa": [{"id": f"c{v}", "task_type": "action", "bound": v == 1,
                  "data": {"video": f"vid{v}", "question": "Which?", "start": 0.5, "end": 1.5,
                           "candidates": ["red", "green", "blue"], "answer": "green"}}
                 for v in range(2)] + [{"question": "Q?", "video": "vid1",
                                        "candidates": ["a", "b"], "answer": "a"}],
        "tvg": [{"id": "t0", "video": "vid0", "query": "A Thing happens.", "timestamps": [0.2, 0.6]},
                {"image_id": "vid1", "caption": " Someone waves. ", "timestamp": [1.0, 2.0]}],
    }
    for name, obj in files.items():
        (root / f"{name}.json").write_text(json.dumps(obj))
    return root


BENCHES = [("pixrqa", "seg", None), ("pixhqa", "hqa", None), ("pixtrqa", "hqa", None),
           ("videorefer_d", "seg", "single"), ("videorefer_d", "seg", "multi"),
           ("videorefer_q", "q", "single"), ("videorefer_q", "q", "multi"),
           ("mevis", "mevis", None), ("mvbench", "mcqa", None), ("tvg", "tvg", None)]


def _assert_same(got, want, path="sample"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got.keys())
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


@pytest.mark.parametrize("bench,qfile,mode", BENCHES,
                         ids=[f"{b}-{m}" if m else b for b, _, m in BENCHES])
def test_benchmark_samples_equal_jax(bench_data, bench, qfile, mode):
    """Each dataset's sample dicts (pixel arrays, masks, ann_indices, frame,
    images_sam, question, gt, ...) equal the JAX adapter's on the same
    files, as ``run_benchmark`` builds both."""
    questions = json.loads((bench_data / f"{qfile}.json").read_text())
    vids = str(bench_data / "videos")
    kw = dict(num_frames=4, image_size=56)
    if bench == "mvbench":
        pair = (ds.MCQABenchmark(vids, questions, **kw), jds.MCQABenchmark(vids, questions, **kw))
    elif bench == "tvg":
        pair = (ds.TVGBenchmark(vids, questions, **kw), jds.TVGBenchmark(vids, questions, **kw))
    else:
        skw = dict(kw, sam_image_size=128)
        if bench != "mevis":
            skw.update(num_sam_frames=3, benchmark=bench, mode=mode)
        pair = (ds.SegReferBenchmark(vids, questions, **skw),
                jds.SegReferBenchmark(vids, questions, **skw))
    assert len(pair[0]) == len(pair[1]) == len(questions)
    for i in range(len(questions)):
        got, want = pair[0][i], pair[1][i]
        if bench not in ("mvbench", "tvg"):
            assert "images_sam" in want
        _assert_same(got, want)


def test_eval_imports_no_jax_cv2_or_pil():
    """In a fresh interpreter where jax, ufvideo_tpu, cv2, PIL, imageio and
    openai cannot be imported, the eval package and eval_smoke import, a
    directory of PNG frames written by the port's codec becomes a mevis
    sample, and the J&F scorer runs with its pool of two workers (forked
    here, where no JAX thread runs)."""
    script = textwrap.dedent(
        """
        import sys
        for name in ("jax", "flax", "ufvideo_tpu", "cv2", "PIL", "imageio", "openai"):
            sys.modules[name] = None
        import json, os, tempfile
        import numpy as np
        import ufvideo_tpu_torch.eval_smoke
        from ufvideo_tpu_torch import rle
        from ufvideo_tpu_torch.eval import (datasets, judge_description, metrics, png, run,
                                            score_mcqa, score_seg, score_tvg, util)
        root = tempfile.mkdtemp()
        rng = np.random.default_rng(0)
        os.makedirs(os.path.join(root, "v", "vid0"))
        for f in range(5):
            png.write_png(os.path.join(root, "v", "vid0", f"{f}.png"),
                          rng.integers(0, 256, (30, 40, 3), np.uint8))
        q = [{"id": "m0", "video": "vid0", "conversations": [
            {"from": "human", "value": "<video>\\nSegment."}, {"from": "gpt", "value": "[SEG]"}]}]
        s = datasets.SegReferBenchmark(os.path.join(root, "v"), q, num_frames=4, image_size=56,
                                       sam_image_size=64)[0]
        assert s["video"].shape == (4, 56, 56, 3) and s["images_sam"].shape == (4, 64, 64, 3)
        mask = np.zeros((4, 30, 40), bool)
        mask[:, 5:20, 8:30] = True
        util.save_mask_pngs(os.path.join(root, "masks"), "m0", mask)
        w = util.JsonlWriter(os.path.join(root, "out_rank0.json"))
        w.write({"id": "m0"})
        w.close()
        json.dump([{"id": "m0", "annotation": [rle.encode(m) for m in mask]}],
                  open(os.path.join(root, "gt.json"), "w"))
        score_seg.main(["--pred-path", os.path.join(root, "out.json"), "--pred-mask-root",
                        os.path.join(root, "masks"), "--gt-file", os.path.join(root, "gt.json"),
                        "--workers", "2"])
        assert metrics.boundary_f_measure(mask[0], mask[0]) == 1.0
        bad = [k for k in sys.modules if k in ("jax", "flax", "ufvideo_tpu", "cv2", "PIL")
               or k.startswith(("jax.", "flax.", "ufvideo_tpu.", "cv2.", "PIL."))]
        bad = [k for k in bad if sys.modules[k] is not None]
        assert not bad, bad
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env,
                       cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK") and "J&F: 100.00" in r.stdout
