"""The port's host modules byte for byte against the JAX package, the
device contract of ``model_init``, and the rule that the port imports no
JAX and nothing of ``ufvideo_tpu``."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ufvideo_tpu import conversation as j_conv
from ufvideo_tpu import mm_utils as j_mm
from ufvideo_tpu import splicing as j_splice
from ufvideo_tpu import tokenization as j_tok
from ufvideo_tpu_torch import conversation, mm_utils, splicing, tokenization
from ufvideo_tpu_torch.api import _assemble_input_ids

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESSAGES = [
    [{"role": "user", "content": "<video>\nWhat happens in this video?"}],
    [{"role": "system", "content": "Be brief."}, {"role": "user", "content": "Hi"},
     {"role": "assistant", "content": "Hello"}, {"role": "user", "content": "ünï ✓"}],
]


@pytest.mark.parametrize("messages", MESSAGES)
@pytest.mark.parametrize("gen", [True, False])
def test_chat_template_identical(messages, gen):
    assert conversation.apply_chat_template(messages, gen) == j_conv.apply_chat_template(
        messages, gen
    )


@pytest.mark.parametrize("modal", ["<video>", "<image>", ""])
@pytest.mark.parametrize("choice", [1, 2, 3])
def test_prompt_assembly_and_tokens_identical(modal, choice):
    from ufvideo_tpu.api import _assemble_input_ids as j_assemble

    tok, jtok = tokenization.ByteTokenizer(), j_tok.ByteTokenizer()
    if choice == 3:
        instruct = [{"from": "human", "value": f"{modal}\nDescribe [SEG]."},
                    {"from": "gpt", "value": "It is <TEMP-042>."}]
    else:
        instruct = "What happens in this video? <region>"
    assert _assemble_input_ids(instruct, choice, modal, tok) == j_assemble(
        instruct, choice, modal, jtok
    )


def test_tokenizer_ids_and_decode_identical():
    tok, ids = tokenization.byte_tokenizer_with_ids()
    jtok, jids = j_tok.byte_tokenizer_with_ids()
    assert vars(ids) == vars(jids)
    assert len(tok) == len(jtok)
    text = "<|im_start|>user\n<region> [SEG] <TEMP-007> ü<|im_end|>"
    assert tok(text).input_ids == jtok(text).input_ids
    seq = tok(text).input_ids + [255, 195]
    for skip in (True, False):
        assert tok.decode(seq, skip) == jtok.decode(seq, skip)


def test_multimodal_tokenization_and_stop_trim_identical():
    tok = tokenization.ByteTokenizer()
    prompt = "a<video>b<video>\nc"
    for modal in ("<video>", "<image>", "<none>"):
        assert mm_utils.tokenizer_multimodal_token(prompt, tok, modal) == (
            j_mm.tokenizer_multimodal_token(prompt, tok, modal)
        )
    for text, kws in (("ab###cd", ["###"]), ("x</s>y###", ["###", "</s>"]), ("abc", ["z"])):
        assert mm_utils.trim_at_stop_strings(text, kws) == j_mm.trim_at_stop_strings(text, kws)


def test_plan_splice_identical():
    ids = [
        [1, 2, -201, 3, 257, 4, 257, 5],
        [7, -200, 8],
    ]
    kw = dict(num_video_tokens=6, region_token_counts=[[2, 4], []], region_token_id=257,
              max_seq_len=32, labels=[list(range(8)), [0, 1, 2]], region_stride=4)
    got, want = splicing.plan_splice(ids, **kw), j_splice.plan_splice(ids, **kw)
    for field in ("src_kind", "src_idx", "seq_lens", "text_ids", "labels", "text_pos_map"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    with pytest.raises(ValueError, match="overflows"):
        splicing.plan_splice(ids, **{**kw, "max_seq_len": 8})


def test_apply_splice_matches():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    plan = splicing.plan_splice(
        [[1, -201, 2, 257, 3]], num_video_tokens=3, region_token_counts=[[2]],
        region_token_id=257, max_seq_len=12, region_stride=4,
    )
    text = rng.standard_normal((1, 5, 8)).astype(np.float32)
    video = rng.standard_normal((1, 3, 8)).astype(np.float32)
    region = rng.standard_normal((1, 4, 8)).astype(np.float32)
    want = j_splice.apply_splice(*map(jnp.asarray, (text, video, region, plan.src_kind,
                                                     plan.src_idx)))
    got = splicing.apply_splice(*map(torch.from_numpy, (text, video, region, plan.src_kind,
                                                         plan.src_idx)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_model_init_needs_cuda_unless_cpu_is_asked():
    from ufvideo_tpu_torch import model_init
    from ufvideo_tpu_torch.configs import tiny_config

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_init(cfg=tiny_config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_init(cfg=tiny_config(), device="cuda:0")
    # the quantised runtime keeps the contract
    quant = tiny_config().replace(quant_llm="int8", quant_kv=True, quant_vision=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model_init(cfg=quant)
    rt, _, _ = model_init(cfg=quant, device="cpu")
    assert rt.device.type == "cpu" and rt.model.llm.lm_head.kernel_q.device.type == "cpu"


def test_port_imports_no_jax():
    """In a fresh interpreter where importing jax / flax fails, the port
    imports and runs a CPU forward, and loads no ufvideo_tpu module; with
    cv2 / PIL / imageio blocked too (the card's machine has none of them),
    the serving layer (the scheduler, the engine, both launchers), the RLE
    codec and the host media module import and build a sample from a JSON
    body."""
    script = textwrap.dedent(
        """
        import sys
        for name in ("jax", "flax", "cv2", "PIL", "imageio"):
            sys.modules[name] = None
        import numpy as np
        import ufvideo_tpu_torch
        from ufvideo_tpu_torch import engine, loadtest, mm_utils, rle, serve
        from ufvideo_tpu_torch import model_init, mm_infer
        from ufvideo_tpu_torch.configs import tiny_config
        rt, _, tok = model_init(cfg=tiny_config(), device="cpu", seed=1)
        frames = np.random.default_rng(0).standard_normal((4, 56, 56, 3)).astype(np.float32)
        text, out = mm_infer(frames, "What happens?", rt, tok, max_new_tokens=3)
        assert len(out["output"]) >= 1
        # the quantised referring path: quant.py, ops.quant_matmul, the q8
        # decode, the W8A8 block, the region encoder
        from ufvideo_tpu_torch import quant
        from ufvideo_tpu_torch.models import region_encoder
        from ufvideo_tpu_torch.ops import quant_matmul
        from ufvideo_tpu_torch.tokenization import parse_temporal_tokens
        mask = np.ones((1, 20, 20), np.float32)
        for kw in (dict(quant_llm="int8", quant_kv=True, quant_vision=True),
                   dict(quant_llm="int4")):
            rt, _, tok = model_init(cfg=tiny_config().replace(**kw), device="cpu", seed=1)
            text, out = mm_infer(frames, "Who is <region>?", rt, tok, masks=mask,
                                 frame=frames[:1], max_new_tokens=3)
            assert len(out["output"]) >= 1
        mask = np.eye(5, dtype=np.uint8)
        body = {"instruct": "Who is <region>?", "video_b64": serve.np_to_b64(frames),
                "masks_rle": [rle.encode(mask)], "frame_b64": serve.np_to_b64(frames[:1])}
        sample, _, _ = serve._build_sample(body, tiny_config())
        assert (sample["masks"][0] == mask).all() and sample["video"].shape == frames.shape
        assert mm_utils.frame_sample(10, num_frames=4).tolist() == [1, 3, 6, 8]
        bad = [m for m in sys.modules if m in ("jax", "flax", "ufvideo_tpu")
               or m.startswith(("jax.", "flax.", "ufvideo_tpu."))]
        bad = [m for m in bad if sys.modules[m] is not None]
        assert not bad, bad
        print("OK")
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), res.stderr


@pytest.mark.parametrize("kw,routing", [
    ({}, {}),
    (dict(quant_llm="int8", quant_kv=True, quant_vision=True), {}),
    (dict(quant_llm="int4"), {}),
    ({}, dict(siglip_ln_dtype="bf16", qpool_fused=False, hiera_stage_nb=4, hiera_gelu="poly")),
    (dict(quant_llm="int8", quant_kv=True, quant_vision=True),
     dict(siglip_int8_fused=False, sam2_int8_special=False)),
], ids=["float", "int8-kv8-w8a8", "int4", "routing-7a", "int8-routing-7b"])
def test_model_init_writes_every_parameter(monkeypatch, kw, routing):
    """Every parameter and buffer ``model_init`` allocates is drawn or set:
    each fresh allocation starts as a sentinel (NaN, or -128 in int8, which
    no quantised value takes), and none may survive. A tensor left as
    allocated holds whatever the memory held, finite on one run and NaN on
    the next."""
    from ufvideo_tpu_torch import model_init
    from ufvideo_tpu_torch.configs import VisionRouting, tiny_config

    real = torch.empty_like

    def sentinel(t, *a, **k):
        out = real(t, *a, **k)
        if out.is_floating_point():
            out.fill_(float("nan"))
        elif out.dtype == torch.int8:
            out.fill_(-128)
        return out

    monkeypatch.setattr(torch, "empty_like", sentinel)
    rt, _, _ = model_init(cfg=tiny_config().replace(**kw), device="cpu", seed=0,
                          routing=VisionRouting(**routing))
    left = [name for name, t in [*rt.model.named_parameters(), *rt.model.named_buffers()]
            if (t.is_floating_point() and not torch.isfinite(t).all())
            or (t.dtype == torch.int8 and bool((t == -128).any()))]
    assert not left
