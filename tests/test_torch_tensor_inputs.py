"""Frames, annotated frames, masks and SAM frames handed to the port as
tensors: ``mm_infer``, ``mm_infer_stream`` and ``mm_infer_batch`` give the
numpy input's tokens, text and masks. Here the tensors lie on the CPU;
``tests/test_torch_cuda.py`` runs the same cases with tensors on the card.
The JAX package takes device arrays on every input path (``np.asarray``
copies them to the host); the port takes a tensor as it is.

Tolerance: exact. The same values reach the same operations on the same
device either way.
"""

import numpy as np
import pytest
import torch

from ufvideo_tpu_torch.api import mm_infer, mm_infer_batch, mm_infer_stream, model_init
from ufvideo_tpu_torch.configs import tiny_config

LABEL = (30, 40)
CONV = [{"from": "human", "value": "<video>\nPlease segment the cat."},
        {"from": "gpt", "value": "It is [SEG]."}]


@pytest.fixture(scope="module")
def runtime():
    rt, _, tok = model_init(cfg=tiny_config(), device="cpu", seed=3)
    return rt, tok


def make_inputs(seed=0):
    """Raw uint8 frames (resized on the device), a float annotated frame,
    a float mask and preprocessed SAM frames (the device resize of uint8
    SAM frames goes to the full 1024, not tiny's 128)."""
    rng = np.random.default_rng(seed)
    return dict(
        video=rng.integers(0, 256, (4, 40, 52, 3), dtype=np.uint8),
        frame=rng.standard_normal((1, 56, 56, 3)).astype(np.float32),
        masks=(rng.random((1, 30, 44)) > 0.5).astype(np.float32),
        images_sam=rng.standard_normal((2, 128, 128, 3)).astype(np.float32),
    )


def as_tensors(inputs, device):
    return {k: torch.from_numpy(v).to(device) for k, v in inputs.items()}


def assert_same_result(got, want):
    """(text, out) or out dicts: text, tokens and every mask equal."""
    if isinstance(want, tuple):
        assert got[0] == want[0]
        got, want = got[1], want[1]
    assert got["output"] == want["output"]
    assert len(got["pred_masks"]) == len(want["pred_masks"])
    for g, w in zip(got["pred_masks"], want["pred_masks"]):
        assert isinstance(g, np.ndarray) and g.dtype == np.bool_
        np.testing.assert_array_equal(g, w)


def check_mm_infer(rt, tok, device):
    np_in = make_inputs(0)
    t_in = as_tensors(np_in, device)
    for inputs in (np_in, t_in):
        assert inputs["video"].shape == (4, 40, 52, 3)
    region = lambda d: dict(frame=d["frame"], masks=d["masks"], ann_indices=[[0]])
    ask = "What is <region> doing?"
    assert_same_result(mm_infer(t_in["video"], ask, rt, tok, max_new_tokens=4, **region(t_in)),
                       mm_infer(np_in["video"], ask, rt, tok, max_new_tokens=4, **region(np_in)))
    seg = lambda d: mm_infer(d["video"], CONV, rt, tok, choice=3, images_sam=d["images_sam"],
                             label_size=LABEL, seg=True)
    got, want = seg(t_in), seg(np_in)
    assert len(want["pred_masks"]) == 1 and want["pred_masks"][0].shape == (2, *LABEL)
    assert_same_result(got, want)


def check_mm_infer_stream(rt, tok, device):
    np_in = make_inputs(1)
    t_in = as_tensors(np_in, device)
    run = lambda d: list(mm_infer_stream(d["video"], "What is <region> doing?", rt, tok,
                                         frame=d["frame"], masks=d["masks"], chunk=2,
                                         max_new_tokens=5))
    want = run(np_in)
    assert want and run(t_in) == want


def check_mm_infer_batch(rt, tok, device):
    """A ``<region>`` question and two ``[SEG]`` requests (path B, one
    batched propagation over both): every input a tensor against every
    input numpy."""
    samples = []
    for seed, kind in ((2, "region"), (3, "seg"), (4, "seg")):
        np_in = make_inputs(seed)
        if kind == "region":
            np_in.pop("images_sam")
            np_in["ann_indices"] = [[0]]
            np_in["instruct"] = [{"from": "human", "value": "<video>\nWhat is <region> doing?"}]
        else:
            np_in.pop("frame"), np_in.pop("masks")
            np_in["instruct"], np_in["label_size"] = CONV, LABEL
        samples.append(np_in)
    tensors = [dict(s, **{k: torch.from_numpy(v).to(device) for k, v in s.items()
                          if isinstance(v, np.ndarray)}) for s in samples]
    want = mm_infer_batch(samples, rt, tok, choice=3, max_new_tokens=4)
    got = mm_infer_batch(tensors, rt, tok, choice=3, max_new_tokens=4)
    assert want[0][0] is not None and want[1][0] is None and len(want[2][1]["pred_masks"]) == 1
    for g, w in zip(got, want):
        assert_same_result(g, w)


@pytest.fixture
def no_numpy_view(monkeypatch):
    """``np.asarray`` of a tensor raises, as it does for a tensor on the card
    (``Tensor.__array__`` calls ``.numpy()``): the input path must take the
    tensor as it is. ``.numpy()`` itself stays (results come back through
    it)."""
    def refuse(self, *a, **k):
        raise TypeError("a tensor input went through numpy")

    monkeypatch.setattr(torch.Tensor, "__array__", refuse)


CHECKS = {"mm_infer": check_mm_infer, "mm_infer_stream": check_mm_infer_stream,
          "mm_infer_batch": check_mm_infer_batch}


@pytest.mark.parametrize("entry", list(CHECKS))
def test_entry_points_take_cpu_tensors(runtime, no_numpy_view, entry):
    CHECKS[entry](*runtime, "cpu")


def test_reversed_numpy_views_still_work(runtime):
    """Numpy views with negative strides (torch refuses them) go through a
    contiguous copy, as before."""
    rt, tok = runtime
    d = make_inputs(5)
    view = lambda a: a[::-1]
    got = mm_infer(view(d["video"]), "What happens?", rt, tok, max_new_tokens=3)
    want = mm_infer(np.ascontiguousarray(view(d["video"])), "What happens?", rt, tok,
                    max_new_tokens=3)
    assert_same_result(got, want)
    seg = lambda im: mm_infer(d["video"], CONV, rt, tok, choice=3, images_sam=im,
                              label_size=LABEL, seg=True)
    assert_same_result(seg(view(d["images_sam"])),
                       seg(np.ascontiguousarray(view(d["images_sam"]))))
