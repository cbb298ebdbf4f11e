"""Checkpoint loading and export in the port held against the JAX package
on ``tiny_config()`` (CPU, float32): the port's exporter against JAX's, its
converter against JAX's converter loaded by ``load_jax_params`` (float,
int8 + int8 KV + W8A8 and int4), ``model_init(model_path=, sam_path=,
tokenizer_path=)`` against JAX's ``model_init`` through ``mm_infer``, the
file readers (the port reads ``.safetensors`` without the package), the
adapter and LoRA functions and the HF tokenizer. Every comparison is exact.

One port model drawn from a seed (module scope) is the source of every
checkpoint; no JAX model is drawn at random.
"""

import dataclasses
import json
import os
import struct
import sys

import jax
import numpy as np
import pytest
import torch

os.environ.setdefault("HF_HUB_OFFLINE", "1")  # the tokenizer is a local directory

from test_full_checkpoint import build_reference_style_sd
from ufvideo_tpu import checkpoints as jc
from ufvideo_tpu import export as jx
from ufvideo_tpu import quant as jq
from ufvideo_tpu import tokenization as jtokz
from ufvideo_tpu.api import _assemble_input_ids as j_assemble
from ufvideo_tpu.api import mm_infer as j_mm_infer
from ufvideo_tpu.api import model_init as j_model_init
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu_torch import checkpoints as pc
from ufvideo_tpu_torch import export as px
from ufvideo_tpu_torch import tokenization as ptokz
from ufvideo_tpu_torch.api import _assemble_input_ids, mm_infer, model_init
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.weights import load_jax_params

INT8 = dict(quant_llm="int8", quant_kv=True, quant_vision=True)
QUANT = {"int8-kv8-w8a8": INT8, "int4": dict(quant_llm="int4")}
FRAMES = np.random.default_rng(0).standard_normal((4, 56, 56, 3)).astype(np.float32)
SAM_FRAMES = np.random.default_rng(1).standard_normal((2, 128, 128, 3)).astype(np.float32)
SEG_CONV = [{"from": "human", "value": "<video>\nPlease segment the cat."},
            {"from": "gpt", "value": "It is [SEG]."}]


@pytest.fixture(scope="module")
def port():
    """(runtime, tokenizer, its full state dict) of a random tiny port model."""
    rt, _, tok = model_init(cfg=tiny_config(), device="cpu", seed=0)
    return rt, tok, px.export_full_checkpoint(rt.model)


@pytest.fixture(scope="module")
def saved(port, tmp_path_factory):
    """The port model written by ``save_hf_checkpoint`` (float32), the same
    without its SAM2 keys, and its SAM2 as a standalone ``.gamma`` .pt."""
    rt, _, sd = port
    root = tmp_path_factory.mktemp("ckpt")
    full, nosam = root / "full", root / "nosam"
    px.save_hf_checkpoint(str(full), rt.model)
    os.makedirs(nosam)
    torch.save({k: v for k, v in sd.items() if not k.startswith("model.mask_encoder.")},
               nosam / "pytorch_model.bin")
    pt = root / "sam2.pt"
    sam = px.rename_g_weight_to_gamma(px.export_sam2(rt.model.sam))
    torch.save({"model": {"model." + k: v for k, v in sam.items()}}, pt)
    return full, nosam, pt


def _params(model):
    return dict([*model.named_parameters(), *model.named_buffers()])


def _assert_models_equal(got, want):
    g, w = _params(got), _params(want)
    assert g.keys() == w.keys()
    bad = [k for k in w if g[k].dtype != w[k].dtype or not torch.equal(g[k], w[k])]
    assert not bad, bad[:8]


def _assert_sd_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
    bad = [k for k in want if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k])]
    assert not bad, bad[:8]


def _jax_model(sd, cfg, sam_sd=None, quant=None):
    """JAX ``convert_full_checkpoint`` (quantised as JAX ``model_init`` does)
    loaded into an empty port model by ``load_jax_params``."""
    jcfg = j_tiny_config()
    jcfg = dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm,
                                                             vocab_size=cfg.llm.vocab_size))
    params = jc.convert_full_checkpoint(sd, jcfg, sam_sd)
    if quant and quant.get("quant_llm"):
        bits = 4 if quant["quant_llm"] == "int4" else 8
        params["llm"] = jq.quantize_qwen2_params(params["llm"], bits=bits)
    if quant and quant.get("quant_vision"):
        params["vision"] = jq.quantize_vision_params(params["vision"])
        params["sam"] = jq.quantize_sam2_params(params["sam"])
    model = UFVideoModel.empty(cfg, "cpu")
    return load_jax_params(model, jax.tree.map(np.asarray, params))


def test_export_equals_jax_exporter(port):
    """The port's export (SAM2 with its mask downscaler) equals JAX's
    exporter run on JAX's conversion of it, key for key, value for value."""
    _, _, sd = port
    jcfg = j_tiny_config()
    want = jx.export_full_checkpoint(jc.convert_full_checkpoint(sd, jcfg), jcfg)
    _assert_sd_equal(sd, want)
    assert any(".sam_prompt_encoder.mask_downscaling.6." in k for k in sd)


@pytest.mark.parametrize("source", ["port-export", "reference-style-vocab-500"])
def test_converter_equals_jax_conversion(port, source):
    """Every parameter the port's converter writes equals JAX's conversion
    loaded by ``load_jax_params``; the reference-style checkpoint (vocabulary
    500, padded to 512 with zero rows, no SAM2 of its own) takes SAM2 from a
    separate state dict."""
    rt, _, sd = port
    sam_sd, cfg = None, tiny_config()
    if source != "port-export":
        jcfg = j_tiny_config()
        torch.manual_seed(0)
        sd = build_reference_style_sd(
            dataclasses.replace(jcfg, llm=dataclasses.replace(jcfg.llm, vocab_size=500)))
        sam_sd = px.export_sam2(rt.model.sam)
        cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, vocab_size=500))
    got = pc.convert_full_checkpoint(sd, cfg, sam_sd)
    _assert_models_equal(got, _jax_model(sd, cfg, sam_sd))
    if source != "port-export":
        assert not got.llm.embed_tokens.weight[500:].any()


@pytest.mark.parametrize("quant", list(QUANT.values()), ids=list(QUANT))
def test_quantised_load_equals_jax_quantise_after_load(port, quant):
    """A quantised configuration quantises each layer as it is written: its
    int8 / int4 leaves equal JAX's ``quantize_*_params`` after conversion."""
    _, _, sd = port
    cfg = tiny_config().replace(**quant)
    _assert_models_equal(pc.convert_full_checkpoint(sd, cfg), _jax_model(sd, cfg, quant=quant))


def _ids(rt, tok):
    return mm_infer(FRAMES, "What happens in this video?", rt, tok, max_new_tokens=6)[1]["output"]


@pytest.mark.parametrize("quant", [{}, INT8], ids=["float", "int8-kv8-w8a8"])
def test_model_init_on_a_saved_checkpoint(port, saved, quant):
    """``save_hf_checkpoint`` → JAX and port ``model_init(model_path=)``:
    the port's load equals the exported model (or its seeded quantised twin)
    parameter for parameter, and both packages' ``mm_infer`` give its
    greedy ids."""
    rt, tok, _ = port
    full, _, _ = saved
    if quant:
        ref, _, _ = model_init(cfg=tiny_config().replace(**quant), device="cpu", seed=0)
    else:
        ref = rt
    got, _, gtok = model_init(str(full), cfg=tiny_config().replace(**quant), device="cpu")
    _assert_models_equal(got.model, ref.model)
    want = _ids(ref, tok)
    assert _ids(got, gtok) == want
    jrt, _, jtok = j_model_init(str(full), cfg=j_tiny_config().replace(**quant))
    jout = j_mm_infer(FRAMES, "What happens in this video?", jrt, jtok, max_new_tokens=6)
    assert list(jout[1]["output"]) == want


def _seg_masks(rt, tok):
    return mm_infer(FRAMES, SEG_CONV, rt, tok, modal="video", choice=3, images_sam=SAM_FRAMES,
                    label_size=(30, 40), seg=True)["pred_masks"]


def test_model_init_takes_sam2_from_sam_path(port, saved):
    """A checkpoint without SAM2 plus the ``.gamma`` .pt loads the exported
    model bit for bit and segments as it does; the .pt's SAM2 comes before a
    checkpoint's own."""
    rt, tok, _ = port
    full, nosam, pt = saved
    got, _, gtok = model_init(str(nosam), cfg=tiny_config(), sam_path=str(pt), device="cpu")
    _assert_models_equal(got.model, rt.model)
    for a, b in zip(_seg_masks(got, gtok), _seg_masks(rt, tok), strict=True):
        np.testing.assert_array_equal(a, b)
    other, _, _ = model_init(cfg=tiny_config(), device="cpu", seed=5)
    pt5 = pt.parent / "sam2_seed5.pt"
    torch.save(px.rename_g_weight_to_gamma(px.export_sam2(other.model.sam)), pt5)
    got, _, _ = model_init(str(full), cfg=tiny_config(), sam_path=str(pt5), device="cpu")
    _assert_models_equal(got.model.sam, other.model.sam)
    _assert_models_equal(got.model.llm, rt.model.llm)


def test_checkpoint_without_sam2(monkeypatch, port, saved):
    """No SAM2 anywhere: the model keeps none, every parameter it keeps is
    written (each fresh allocation starts as a sentinel), and a ``[SEG]``
    request raises naming ``sam_path``; sam_path alone is refused."""
    _, nosam, pt = saved
    real = torch.empty_like

    def sentinel(t, *a, **k):
        out = real(t, *a, **k)
        if out.is_floating_point():
            out.fill_(float("nan"))
        elif out.dtype == torch.int8:
            out.fill_(-128)
        return out

    monkeypatch.setattr(torch, "empty_like", sentinel)
    for quant in ({}, INT8):
        rt, _, tok = model_init(str(nosam), cfg=tiny_config().replace(**quant), device="cpu")
        assert rt.model.sam is None
        left = [n for n, t in _params(rt.model).items()
                if (t.is_floating_point() and not torch.isfinite(t).all())
                or (t.dtype == torch.int8 and bool((t == -128).any()))]
        assert not left
        assert len(_ids(rt, tok)) >= 1
        with pytest.raises(RuntimeError, match="sam_path"):
            _seg_masks(rt, tok)
    with pytest.raises(ValueError, match="sam_path needs model_path"):
        model_init(cfg=tiny_config(), sam_path=str(pt), device="cpu")


def test_converter_refuses_an_incomplete_checkpoint(monkeypatch, port):
    """A missing key, a tensor of the wrong shape, a parameter no converter
    writes, and the export of a quantised model each raise."""
    from ufvideo_tpu_torch.models.sam2 import convert as sam2_convert

    _, _, sd = port
    short = {k: v for k, v in sd.items() if not k.endswith("layers.1.mlp.up_proj.weight")}
    with pytest.raises(KeyError, match="up_proj"):
        pc.convert_full_checkpoint(short, tiny_config())
    plan = sam2_convert.sam2_plan
    monkeypatch.setattr(sam2_convert, "sam2_plan", lambda sam: plan(sam)[:-1])
    with pytest.raises(KeyError, match="sam.no_obj_ptr"):
        pc.convert_full_checkpoint(sd, tiny_config())
    monkeypatch.undo()
    bad = dict(sd, **{"model.norm.weight": torch.ones(3)})
    with pytest.raises(ValueError, match="model.norm"):
        pc.convert_full_checkpoint(bad, tiny_config())
    with pytest.raises(ValueError, match="quantised"):
        px.export_full_checkpoint(pc.convert_full_checkpoint(sd, tiny_config().replace(**INT8)))


def _every_dtype():
    g = torch.Generator().manual_seed(0)
    f = torch.randn(3, 5, generator=g)
    return {
        "a.bf16": f.to(torch.bfloat16), "a.f16": f.half(), "a.f32": f,
        "b.f64": f.double().reshape(5, 3), "b.i64": torch.arange(-6, 6).reshape(2, 6),
        "b.i32": torch.arange(7, dtype=torch.int32) * -3, "c.i16": torch.arange(-4, 4, dtype=torch.int16),
        "c.i8": torch.tensor([-128, -1, 0, 127], dtype=torch.int8),
        "c.u8": torch.tensor([[0, 255], [7, 9]], dtype=torch.uint8),
        "c.bool": torch.tensor([True, False, True]), "c.scalar": torch.tensor(2.5),
        "c.empty": torch.zeros(0, 4),
    }


def test_safetensors_shards_read_without_the_package(tmp_path):
    """Two shards written by the ``safetensors`` package, with an index file,
    in every dtype the reader maps: the port's reader equals JAX's loader
    (which uses the package), and a single file too."""
    from safetensors.torch import save_file

    sd = _every_dtype()
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[::2],
              "model-00002-of-00002.safetensors": keys[1::2]}
    for name, ks in shards.items():
        save_file({k: sd[k] for k in ks}, str(tmp_path / name), metadata={"format": "pt"})
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps(
        {"weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    got = pc.load_torch_state_dict(str(tmp_path))
    _assert_sd_equal(got, jc.load_torch_state_dict(str(tmp_path)))
    _assert_sd_equal(got, sd)
    one = str(tmp_path / "model-00001-of-00002.safetensors")
    _assert_sd_equal(pc.load_torch_state_dict(one), jc.load_torch_state_dict(one))


def test_bin_shards_and_model_key(tmp_path):
    sd = _every_dtype()
    keys = sorted(sd)
    for i, ks in enumerate((keys[:5], keys[5:])):
        torch.save({k: sd[k] for k in ks}, tmp_path / f"pytorch_model-0000{i + 1}-of-00002.bin")
    _assert_sd_equal(pc.load_torch_state_dict(str(tmp_path)),
                         jc.load_torch_state_dict(str(tmp_path)))
    single = tmp_path / "single.pt"
    torch.save({"model": sd, "optimizer": {}}, single)
    _assert_sd_equal(pc.load_torch_state_dict(str(single)),
                         jc.load_torch_state_dict(str(single)))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        pc.load_torch_state_dict(str(tmp_path / "empty"))


def _write_safetensors(path, header, data=b""):
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["corrupt-header", "overlap", "unknown-dtype",
                                  "past-the-file", "short"])
def test_safetensors_reader_refuses_a_bad_file(tmp_path, case):
    p = tmp_path / "bad.safetensors"
    f32 = lambda a, b: {"dtype": "F32", "shape": [(b - a) // 4], "data_offsets": [a, b]}
    if case == "corrupt-header":
        p.write_bytes(struct.pack("<Q", 12) + b"{not json!!}" + bytes(8))
    elif case == "overlap":
        _write_safetensors(p, {"x": f32(0, 8), "y": f32(4, 12)}, bytes(12))
    elif case == "unknown-dtype":
        _write_safetensors(p, {"x": {"dtype": "X9", "shape": [2], "data_offsets": [0, 8]}},
                           bytes(8))
    elif case == "past-the-file":
        _write_safetensors(p, {"x": f32(0, 16)}, bytes(8))
    else:
        p.write_bytes(b"\x01\x02")
    with pytest.raises(ValueError, match="bad.safetensors") as e:
        pc.read_safetensors(str(p))
    if case in ("overlap", "unknown-dtype", "past-the-file"):
        assert "'x'" in str(e.value)


def test_sam2_checkpoint_and_adapters_equal_jax(port, saved, tmp_path):
    """``load_sam2_checkpoint`` on the ``.gamma`` .pt, and
    ``convert_base_plus_adapters`` with another model's ``save_adapter_bins``
    files, equal JAX's (the latter through ``load_jax_params``)."""
    rt, _, sd = port
    _, _, pt = saved
    _assert_sd_equal(pc.load_sam2_checkpoint(str(pt)), jc.load_sam2_checkpoint(str(pt)))
    other, _, _ = model_init(cfg=tiny_config(), device="cpu", seed=7)
    px.save_adapter_bins(str(tmp_path), other.model)
    proj, reg = str(tmp_path / "mm_projector.bin"), str(tmp_path / "region_encoder.bin")
    for path in (proj, reg):
        _assert_sd_equal(pc.load_adapter_weights(path), jc.load_adapter_weights(path))
    got = pc.convert_base_plus_adapters(sd, tiny_config(), proj, reg)
    jcfg = j_tiny_config()
    params = jc.convert_base_plus_adapters(sd, jcfg, proj, reg)
    want = load_jax_params(UFVideoModel.empty(tiny_config(), "cpu"),
                           jax.tree.map(np.asarray, params))
    _assert_models_equal(got, want)
    _assert_models_equal(got.projector, other.model.projector)
    _assert_models_equal(got.region, other.model.region)


def _peft_adapter(sd, r=8):
    g = torch.Generator().manual_seed(3)
    out = {}
    for i in (0, 1):
        for proj in ("q_proj", "v_proj"):
            base = f"base_model.model.model.layers.{i}.self_attn.{proj}"
            w = sd[f"model.layers.{i}.self_attn.{proj}.weight"]
            out[f"{base}.lora_A.weight"] = torch.randn(r, w.shape[1], generator=g) * 0.1
            out[f"{base}.lora_B.weight"] = torch.randn(w.shape[0], r, generator=g) * 0.1
    out["base_model.model.model.mm_projector.readout.0.bias"] = torch.randn(64, generator=g)
    return out


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_lora_merges_equal_jax(port, tmp_path, fmt):
    """PEFT-style adapters (alpha 16, r 8) on q / v of both layers plus a
    non-LoRA trainable: ``merge_lora`` and ``merge_lora_from_dir`` equal
    JAX's."""
    _, _, sd = port
    adapter = _peft_adapter(sd)
    _assert_sd_equal(pc.merge_lora(dict(sd), adapter, alpha=16.0, r=8),
                         jc.merge_lora(dict(sd), adapter, alpha=16.0, r=8))
    (tmp_path / "adapter_config.json").write_text(json.dumps({"lora_alpha": 16, "r": 8}))
    lora = {k: v for k, v in adapter.items() if ".lora_" in k}
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file(lora, str(tmp_path / "adapter_model.safetensors"))
    else:
        torch.save(lora, tmp_path / "adapter_model.bin")
    torch.save({k: v for k, v in adapter.items() if ".lora_" not in k},
               tmp_path / "non_lora_trainables.bin")
    got = pc.merge_lora_from_dir(dict(sd), str(tmp_path))
    _assert_sd_equal(got, jc.merge_lora_from_dir(dict(sd), str(tmp_path)))
    assert not torch.equal(got["model.layers.1.self_attn.v_proj.weight"],
                           sd["model.layers.1.self_attn.v_proj.weight"])


CHATML = (
    "{% for message in messages %}{% if loop.first and messages[0]['role'] != 'system' %}"
    "{{ '<|im_start|>system\\nYou are a helpful assistant.<|im_end|>\\n' }}{% endif %}"
    "{{ '<|im_start|>' + message['role'] + '\\n' + message['content'] + '<|im_end|>' + '\\n' }}"
    "{% endfor %}{% if add_generation_prompt %}{{ '<|im_start|>assistant\\n' }}{% endif %}"
)
WORDS = ("system You are a helpful assistant . user What happens in this video ? "
         "Please segment the cat It is").split()


@pytest.fixture(scope="module")
def hf_tokenizer_dir(tmp_path_factory):
    """A word-level HF tokenizer with Qwen's ChatML template, saved."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    specials = ["[UNK]", "<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    vocab = {w: i for i, w in enumerate(specials + sorted(set(WORDS)))}
    core = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    core.pre_tokenizer = pre_tokenizers.Whitespace()
    tok = PreTrainedTokenizerFast(
        tokenizer_object=core, unk_token="[UNK]", eos_token="<|im_end|>",
        pad_token="<|endoftext|>", additional_special_tokens=["<|im_start|>"])
    tok.chat_template = CHATML
    path = tmp_path_factory.mktemp("tokenizer")
    tok.save_pretrained(str(path))
    return path


def test_hf_tokenizer_equals_jax(hf_tokenizer_dir, saved):
    """JAX and port ``load_tokenizer``: the same special ids and prompt ids;
    ``model_init(tokenizer_path=)`` on both sides gives the same greedy ids."""
    tok, ids = ptokz.load_tokenizer(str(hf_tokenizer_dir))
    jtok, jids = jtokz.load_tokenizer(str(hf_tokenizer_dir))
    assert vars(ids) == vars(jids)
    assert ids.seg == ids.temporal_start + 100 == ids.region + 101
    for instruct, choice in (("What happens in this video?", 1), (SEG_CONV, 3)):
        got = _assemble_input_ids(instruct, choice, "<video>", tok)
        assert got == j_assemble(instruct, choice, "<video>", jtok)
    full = str(saved[0])
    rt, _, tok = model_init(full, cfg=tiny_config(), tokenizer_path=str(hf_tokenizer_dir),
                            device="cpu")
    assert rt.cfg.seg_token_id == ids.seg
    jrt, _, jtok = j_model_init(full, cfg=j_tiny_config(), tokenizer_path=str(hf_tokenizer_dir))
    want = j_mm_infer(FRAMES, "What happens in this video?", jrt, jtok, max_new_tokens=6)
    assert _ids(rt, tok) == list(want[1]["output"])


def test_hf_tokenizer_needs_transformers(monkeypatch, hf_tokenizer_dir):
    """Without ``transformers`` loading an HF tokenizer raises an
    ``ImportError`` naming the package: no fall-back to the byte tokenizer."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="'transformers'"):
        ptokz.load_tokenizer(str(hf_tokenizer_dir))
    with pytest.raises(ImportError, match="'transformers'"):
        model_init(cfg=tiny_config(), tokenizer_path=str(hf_tokenizer_dir), device="cpu")


def test_checkpoint_io_needs_neither_safetensors_nor_transformers(tmp_path):
    """In a fresh interpreter where ``jax``, ``ufvideo_tpu``, ``safetensors``
    and ``transformers`` cannot be imported (the card's machine has none of
    them), the port exports a model, writes a ``.safetensors`` copy by hand,
    and loads both through ``model_init(model_path=)``."""
    import subprocess
    import textwrap

    script = textwrap.dedent(f"""
        import json, struct, sys
        for name in ("jax", "flax", "ufvideo_tpu", "safetensors", "transformers"):
            sys.modules[name] = None
        import torch
        from ufvideo_tpu_torch import model_init
        from ufvideo_tpu_torch.configs import tiny_config
        from ufvideo_tpu_torch.export import export_full_checkpoint, save_hf_checkpoint
        rt, _, _ = model_init(cfg=tiny_config(), device="cpu", seed=2)
        save_hf_checkpoint({str(tmp_path / "bin")!r}, rt.model)
        sd = export_full_checkpoint(rt.model)
        header, blobs, at = {{}}, [], 0
        for k, t in sd.items():
            raw = t.contiguous().view(torch.uint8).numpy().tobytes()
            header[k] = {{"dtype": "F32", "shape": list(t.shape), "data_offsets": [at, at + len(raw)]}}
            blobs.append(raw)
            at += len(raw)
        head = json.dumps(header).encode()
        with open({str(tmp_path / "model.safetensors")!r}, "wb") as f:
            f.write(struct.pack("<Q", len(head)) + head + b"".join(blobs))
        want = dict(rt.model.named_parameters())
        for path in ({str(tmp_path / "bin")!r}, {str(tmp_path / "model.safetensors")!r}):
            got, _, _ = model_init(path, cfg=tiny_config(), device="cpu")
            for k, t in got.model.named_parameters():
                assert torch.equal(t, want[k]), k
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "ufvideo_tpu", "safetensors",
               "transformers") and sys.modules[m] is not None]
        assert not bad, bad
        print("OK")
    """)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    res = subprocess.run([sys.executable, "-c", script], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), res.stderr[-2000:]
