"""The plain reference against the program's plain path (every kernel's
plain PyTorch version, float32 on the CPU) at the tiny configuration, on the
same state dict: the video tokens, and the logits of each step of a greedy
generation through the program's KV cache. The test imports the program;
the reference does not."""

import numpy as np
import pytest
import torch

from benchmark.reference import checkpoint, model as ref
from benchmark.reference import prompt as ref_prompt

from conftest import TINY_FRAMES, tiny_model


def _runtime(quant):
    from benchmark.port import build_runtime

    m = tiny_model(quant)
    sd = checkpoint.make_state_dict(m, 11, "cpu", torch.float32)
    rt, tok = build_runtime(m, sd, "cpu")
    return m, sd, rt, tok


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_reference_follows_the_program(quant, tiny_frames):
    from ufvideo_tpu_torch.api import _assemble_input_ids, _video_pixels

    m, sd, rt, tok = _runtime(quant)
    frames = np.random.default_rng(1).integers(0, 256, TINY_FRAMES, dtype=np.uint8)
    question = "what happens next in the clip?"
    with torch.no_grad():
        video = rt.encode_video(_video_pixels(rt, frames, "video")[None])[0]
        want = ref.video_tokens(torch.from_numpy(frames), sd, m)
        assert video.shape[0] == ref.video_token_count(m)
        assert (video - want).abs().max() <= 1e-4 * want.abs().max()
        ids = _assemble_input_ids(question, 1, "<video>", tok)
        assert ids == ref_prompt.prompt_ids(question)
        tokens, hidden, _ = rt.generate(ids, video[None], max_new_tokens=12)
        got = rt.model.llm.logits(hidden[None])[0].float()[:, :m["llm"]["vocab_size"]]
        want = ref.served_logits([{"frames": torch.from_numpy(frames), "question": question,
                                   "served": tokens}], sd, m)[0]
    # int8 steps a rounding flips at a half move a logit by a step's share
    tol = (1e-3 if quant else 1e-5) * want.abs().max()
    assert (got - want).abs().max() <= tol
    assert ref_prompt.spliced_length(question, ref.video_token_count(m)) == \
        len(ids) - 1 + ref.video_token_count(m)


def test_state_dict_same_seed_same_weights():
    m = tiny_model()
    a = checkpoint.make_state_dict(m, 3, "cpu")
    b = checkpoint.make_state_dict(m, 3, "cpu")
    c = checkpoint.make_state_dict(m, 4, "cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
    assert all(t.dtype == torch.bfloat16 for t in a.values())


def test_state_dict_matches_the_program_names():
    """Every tensor the loader reads is drawn, and nothing it leaves unread
    but the layers the tap never runs."""
    from benchmark.port import build_runtime

    m = tiny_model()
    sd = checkpoint.make_state_dict(m, 3, "cpu", torch.float32)
    build_runtime(m, sd, "cpu")  # raises where a parameter is not written


def test_quantisers_are_the_configuration_s():
    w = torch.randn(6, 10)
    q = ref.int8_weight(w)
    scale = w.abs().amax(dim=1, keepdim=True) / 127
    assert torch.allclose(q, torch.round(w / scale) * scale)
    x = torch.randn(3, 10)
    assert (ref.int8_rows(x) - x).abs().max() <= x.abs().max() / 254 + 1e-7
