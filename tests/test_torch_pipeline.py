"""The port's GPipe pipeline against the JAX package's dense stack (oracles
``tests/test_pipeline.py`` and ``tests/test_train_pp_e2e.py``), CPU,
float32.

Four gloo ranks (``torch_parallel_child.py``, job ``pipeline``) on a
(data 2, pipe 2) mesh: the pipelined Qwen2 backbone of ``tests/test_pipeline.py``'s
TINY model (4 layers, 2 a stage) for M = 2 and 4 microbatches, the rows
split over data, against JAX's dense ``Qwen2LM.backbone``; the gradients of
``mean(h * h)`` with and without remat against ``jax.grad`` through the
dense stack; and the [SEG] Trainer with the LLM pipelined for three steps
against the one-process Trainer on the same global batch, each stage
holding its layers only, and its checkpoint resumed on one process.

Tolerances: ``tests/test_pipeline.py``'s (hidden 2e-5 relative / 1e-5
absolute, gradients 1e-5 / 1e-6); the Trainer's losses and grad norms
2e-5 relative (``tests/test_multihost.py``).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ufvideo_tpu.configs import Qwen2Config as JQwen2Config
from ufvideo_tpu.models.qwen2 import Qwen2LM as JQwen2LM
from ufvideo_tpu_torch.configs import Qwen2Config
from ufvideo_tpu_torch.models.qwen2 import Qwen2LM
from ufvideo_tpu_torch.parallel.pipeline import stage_range
from ufvideo_tpu_torch.train.seg_step import SegBatch, segmentation_loss_fn
from ufvideo_tpu_torch.train.trainer import Trainer

import torch_train_fixtures as fx
from test_torch_parallel import LR, REL, TOTAL, WARMUP_RATIO, _tc, collect, global_batch, spawn

TINY = dict(vocab_size=256, hidden_size=32, num_layers=4, num_heads=4, num_kv_heads=2,
            head_dim=8, intermediate_size=64, eos_token_id=2, pad_token_id=0)
B, S = 8, 12
HIDDEN_TOL = dict(rtol=2e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


class _Axis:
    """A mesh's axis names and sizes, no process group: what the port reads
    before it communicates."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, dim=None):
        return self._sizes[dim]


def _port_name(path) -> str:
    """A JAX Qwen2LM leaf path → the port's parameter name, without the
    layer index (the caller splits the stacked axis)."""
    keys = [str(getattr(k, "key", k)) for k in path]
    names = {"self_attn_qkv_proj": "qkv_proj", "self_attn_o_proj": "o_proj",
             "mlp_gate_proj": "gate_proj", "mlp_up_proj": "up_proj",
             "mlp_down_proj": "down_proj"}
    mod = names.get(keys[-2], keys[-2])
    leaf = "bias" if keys[-1] == "bias" else "weight"
    return f"{mod}.{leaf}" if keys[0] == "layers" else f"{keys[0]}.{leaf}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipeline"))
    jlm = JQwen2LM(JQwen2Config(**TINY), dtype=jnp.float32, param_dtype=jnp.float32)
    lm_params = jax.tree.map(np.asarray, jlm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    embeds = np.random.default_rng(1).standard_normal((B, S, TINY["hidden_size"])).astype(
        np.float32)
    # the [SEG] Trainer: the micro configuration with two LLM layers (one a stage)
    jcfg, pcfg, jtok, tok, ids = fx.micro_configs()
    jcfg = jcfg.replace(llm=dataclasses.replace(jcfg.llm, num_layers=2))
    pcfg = pcfg.replace(llm=dataclasses.replace(pcfg.llm, num_layers=2))
    params = fx.jax_params(jcfg)
    _, pb = global_batch(jcfg, pcfg, jtok, tok, ids)
    inp = dict(lm_cfg=Qwen2Config(**TINY), lm_params=lm_params, embeds=embeds, cfg=pcfg,
               state_dict=fx.port_model(pcfg, params).state_dict(), batch=pb, lr=LR,
               warmup_ratio=WARMUP_RATIO, total_steps=TOTAL)
    procs = spawn("pipeline", inp, out)
    try:
        positions = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))

        def hidden(p):
            return jlm.apply({"params": p}, jnp.asarray(embeds), positions,
                             jnp.full((B,), S, jnp.int32), mode="train",
                             method=JQwen2LM.backbone)[0]

        jhidden = np.asarray(jax.jit(hidden)(lm_params))
        jgrads = jax.jit(jax.grad(lambda p: jnp.mean(hidden(p) ** 2)))(lm_params)
        dense = Trainer(fx.port_model(pcfg, params), pcfg, _tc(os.path.join(out, "dense")),
                        loss_fn=segmentation_loss_fn)
        dense.train(dense.init_state(), [fx.torch_batch(pb, SegBatch)] * 3, max_steps=3)
        with open(os.path.join(out, "dense", "train_log.jsonl")) as f:
            dense_log = [json.loads(line) for line in f]
    finally:
        res, _ = collect(procs, "pipeline", out)
    res.update(pp_out=os.path.join(out, "pp"), pp_cfg=(pcfg, params),
               pp_batch=fx.torch_batch(pb, SegBatch))
    return res, jhidden, jgrads, dense_log


@pytest.mark.parametrize("m", [2, 4])
def test_pipelined_backbone_matches_the_dense_stack(runs, m):
    """(data 2, pipe 2): M microbatches of each data rank's rows through two
    stages of two layers; the gathered rows equal JAX's dense backbone."""
    res, jhidden, _, _ = runs
    np.testing.assert_allclose(res[f"hidden_m{m}"].numpy(), jhidden, **HIDDEN_TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_gradients_match_the_dense_stack(runs, remat):
    """Each layer's gradient from the stage that ran it (summed over the
    stages, the others hold zeros), every tensor summed over the data ranks,
    against ``jax.grad`` through the dense stack."""
    res, _, jgrads, _ = runs
    got = res[f"grads_remat{int(remat)}"]
    seen = set()
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        name = _port_name(path)
        g = np.asarray(g)
        if str(getattr(path[0], "key", path[0])) == "layers":
            for i in range(g.shape[0]):
                want = g[i].T if g.ndim == 3 else g[i]
                np.testing.assert_allclose(got[f"layers.{i}.{name}"].numpy(), want,
                                           **GRAD_TOL, err_msg=f"layers.{i}.{name}")
                seen.add(f"layers.{i}.{name}")
        elif name.startswith("norm."):
            np.testing.assert_allclose(got[name].numpy(), g, **GRAD_TOL, err_msg=name)
            seen.add(name)
    assert len(seen) == 4 * 8 + 1


@pytest.mark.parametrize("key", ["loss", "ce_loss", "mask_bce_loss", "grad_norm"])
def test_pipelined_trainer_matches_the_one_process_trainer(runs, key):
    """The [SEG] Trainer at (data 2, pipe 2), two microbatches of one row,
    three steps: each step's global metric is the one-process Trainer's."""
    res, _, _, dense = runs
    got = res["pp_log"]
    assert [r["step"] for r in got] == [1, 2, 3]
    for g, w in zip(got, dense):
        assert abs(g[key] - w[key]) <= REL * max(abs(w[key]), 1.0), (g["step"], key, g, w)


def test_each_stage_holds_its_layers_and_the_checkpoint_gathers_them(runs, tmp_path):
    """Stage s keeps layer s (the other on the meta device), and the
    Trainer's checkpoint-2, each layer gathered from its stage, resumes on
    one process to the one-process Trainer's step-3 loss."""
    import shutil

    res, _, _, dense = runs
    # rank r of (data 2, pipe 2) is stage r % 2
    assert res["pp_held"] == [[0], [1], [0], [1]]
    shutil.copytree(os.path.join(res["pp_out"], "checkpoint-2"),
                    tmp_path / "checkpoint-2")
    pcfg, params = res["pp_cfg"]
    tr = Trainer(fx.port_model(pcfg, params), pcfg, _tc(str(tmp_path)),
                 loss_fn=segmentation_loss_fn)
    state = tr.maybe_resume(tr.init_state())
    assert state.step == 2
    tr.train(state, [res["pp_batch"]], max_steps=3)
    with open(tmp_path / "train_log.jsonl") as f:
        (rec,) = [json.loads(line) for line in f]
    for key in ("loss", "grad_norm"):
        assert abs(rec[key] - dense[2][key]) <= REL * max(abs(dense[2][key]), 1.0), key


def test_pp_and_ring_are_mutually_exclusive():
    lm = Qwen2LM(Qwen2Config(**TINY))
    lm.set_pipeline(_Axis(data=1, pipe=2), "pipe", 2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        lm.set_ring(_Axis(fsdp=2), "fsdp")
    lm = Qwen2LM(Qwen2Config(**TINY))
    lm.set_ring(_Axis(fsdp=2), "fsdp")
    with pytest.raises(ValueError, match="mutually exclusive"):
        lm.set_pipeline(_Axis(pipe=2), "pipe", 2)


def test_layer_count_validation():
    with pytest.raises(ValueError, match="not divisible"):
        stage_range(6, 4, 0)
    assert list(stage_range(8, 4, 3)) == [6, 7]
    with pytest.raises(ValueError, match="not divisible"):
        Qwen2LM(Qwen2Config(**TINY)).set_pipeline(_Axis(pipe=3), "pipe", 2)
