"""The port's LoRA finetune against the JAX package's, CPU, float32, at the
micro configuration: three steps of ``make_lora_train_step`` at dropout 0
(the parameter-space merge) with the ``[SEG]`` loss, whose loss dicts,
gradients and trained tensors must agree; the forward term at rate 0
against the merge; the dropout draws' dependence on (seed, step) alone; the
PEFT files against JAX's and their load through ``merge_lora_from_dir`` and
``model_init(model_path=, adapter_path=)``.

JAX's side runs once: ``make_lora_train_step`` on a one-device mesh (its
step is its inner step behind a device_put of the batch). The adapters
start from JAX's PEFT init with B set non-zero, carried into the port by
``weights.load_jax_lora_state``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.parallel import create_mesh
from ufvideo_tpu.train import lora as jlora
from ufvideo_tpu.train import seg_step as jseg
from ufvideo_tpu.train import train_step as jts
from ufvideo_tpu_torch.api import model_init
from ufvideo_tpu_torch.checkpoints import merge_lora_from_dir
from ufvideo_tpu_torch.export import export_full_checkpoint, save_hf_checkpoint
from ufvideo_tpu_torch.models.qwen2 import LoRATerm, fold_in
from ufvideo_tpu_torch.train import lora as plora
from ufvideo_tpu_torch.train import seg_step as pseg
from ufvideo_tpu_torch.train import train_step as pts
from ufvideo_tpu_torch.weights import load_jax_lora_state

import torch_train_fixtures as fx

LR, TOTAL = 1e-3, 10
N_STEPS = 3
R, ALPHA = 4, 16.0
# as in test_torch_train_step.py: float32 sums in another order; moments
# relative to their tensor's largest entry; trained tensors by their change
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_REL = 2e-4
PARAM_REL = 5e-3


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg, jtok, tok, ids = fx.micro_configs()
    params = fx.jax_params(jcfg)
    jb, pb = fx.collated(jcfg, pcfg, jtok, tok, ids)
    return jcfg, pcfg, params, jb, pb


def _with_b(lora, seed=5):
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    lora = dict(lora)
    for k, name in zip(ks, ("q", "v")):
        lora[name] = {"a": lora[name]["a"],
                      "b": 0.05 * jax.random.normal(k, lora[name]["b"].shape)}
    return lora


@pytest.fixture(scope="module")
def runs(setup):
    jcfg, pcfg, params, jb, pb = setup
    lcfg = jlora.LoRAConfig(r=R, alpha=ALPHA, dropout=0.0)
    sam = JSAM2(jcfg.sam, dtype=jnp.float32, param_dtype=jnp.float32)
    mesh = create_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices("cpu")[:1])
    opt = jts.make_optimizer(LR, warmup_ratio=0.1, total_steps=TOTAL)
    init, step, _ = jlora.make_lora_train_step(
        JUFVideoModel(jcfg), opt, mesh, lcfg, loss_fn=jseg.make_seg_loss_fn(sam))
    state = init(jax.random.PRNGKey(1), params)
    state["trainable"]["lora"] = _with_b(state["trainable"]["lora"])
    start = jax.tree.map(np.asarray, state)
    batch = fx.jax_batch(jb, jseg.SegBatch)
    jm, mu0 = [], None
    with mesh:
        for i in range(N_STEPS):
            state, m = step(state, batch)
            jm.append({k: float(v) for k, v in m.items()})
            if i == 0:
                mu0 = jax.tree.map(np.asarray, state["opt_state"][1][0].mu)
    jend = jax.tree.map(np.asarray, state["trainable"])

    model = fx.port_model(pcfg, params)
    factors = load_jax_lora_state(model, start)
    plcfg = plora.LoRAConfig(r=R, alpha=ALPHA, dropout=0.0)
    popt = pts.make_optimizer(LR, warmup_ratio=0.1, total_steps=TOTAL)
    pinit, pstep = plora.make_lora_train_step(model, popt, plcfg, pseg.segmentation_loss_fn)
    pstate = pinit(lora=factors)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    pbatch = fx.torch_batch(pb, pseg.SegBatch)
    pm, pmu0 = [], None
    for i in range(N_STEPS):
        pstate, m = pstep(pstate, pbatch)
        pm.append({k: float(v) for k, v in m.items()})
        if i == 0:
            pmu0 = {n: t.clone() for n, t in pstate.opt_state["mu"].items()}
    return dict(jm=jm, mu0=mu0, jend=jend, start=start, pm=pm, pmu0=pmu0, model=model,
                pstate=pstate, before=before, params=params)


def _lora_named(tree) -> dict:
    return {f"lora.{m}.{k}": torch.from_numpy(np.asarray(tree[m][k]))
            for m in ("q", "v") for k in ("a", "b")}


def _non_lora_named(pcfg, params, tree) -> dict:
    """JAX non-LoRA subtrees → port names prefixed ``non_lora.``."""
    full = jax.tree.map(np.zeros_like, params)
    full.update(tree)
    named = fx.port_named(pcfg, full)
    return {f"non_lora.{n}": t for n, t in named.items()
            if n.split(".", 1)[0] in plora.NON_LORA_TRAINABLE}


def test_lora_loss_dicts_match_jax(runs):
    """Loss, ce, bce, dice, mask loss and grad_norm at each of three steps."""
    for i, (jm, pm) in enumerate(zip(runs["jm"], runs["pm"])):
        assert sorted(jm) == sorted(pm)
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], **LOSS_TOL, err_msg=f"{k} at step {i}")
    assert runs["pm"][2]["loss"] < runs["pm"][0]["loss"]


def test_lora_gradients_match_jax(setup, runs):
    """The gradient of every adapter factor and non-LoRA trainable (first
    moments after the lr-0 step); the text head gets its gradient through
    the frozen mask decoder."""
    pcfg, params = setup[1], setup[2]
    want = {**_lora_named(runs["mu0"]["lora"]),
            **_non_lora_named(pcfg, params, runs["mu0"]["non_lora"])}
    got = runs["pmu0"]
    assert sorted(got) == sorted(want)
    floor = 1e-3 * max(float(t.abs().max()) for t in want.values())
    for name, g in got.items():
        scale = max(float(want[name].abs().max()), floor)
        err = float((g - want[name]).abs().max()) / scale
        assert err <= GRAD_REL, f"{name}: gradient differs by {err:.2e} of its scale"
    for prefix in ("lora.q.a", "lora.v.b", "non_lora.text_fcs.", "non_lora.region.",
                   "non_lora.projector."):
        assert any(n.startswith(prefix) and float(g.abs().max()) > 0 for n, g in got.items())


def test_lora_three_steps_match_jax(setup, runs):
    """The factors and non-LoRA trainables after three steps; the base,
    the mask decoder included, is untouched."""
    pcfg, params = setup[1], setup[2]
    start = {**_lora_named(runs["start"]["trainable"]["lora"]),
             **_non_lora_named(pcfg, params, runs["start"]["trainable"]["non_lora"])}
    want = {**_lora_named(runs["jend"]["lora"]),
            **_non_lora_named(pcfg, params, runs["jend"]["non_lora"])}
    got = runs["pstate"].params
    for name, t in got.items():
        d_got, d_want = t.detach() - start[name], want[name] - start[name]
        assert float((d_got - d_want).norm()) <= PARAM_REL * float(d_want.norm()) + 1e-9, name
        np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=2 * LR, err_msg=name)
    model, before = runs["model"], runs["before"]
    for name, p in model.named_parameters():
        if name.split(".", 1)[0] not in plora.NON_LORA_TRAINABLE:
            assert not p.requires_grad and torch.equal(p.detach(), before[name]), name


def _lm(pcfg, seed=0, remat=False):
    import dataclasses

    from ufvideo_tpu_torch.models.qwen2 import Qwen2LM

    cfg = dataclasses.replace(pcfg.llm, num_layers=2, remat=remat)
    lm = Qwen2LM(cfg, dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    lm.reset_parameters(gen)
    lcfg = plora.LoRAConfig(r=R, alpha=ALPHA, dropout=0.0)
    lora = plora.init_lora_params(pcfg.replace(llm=cfg), lcfg, gen)
    for m in ("q", "v"):
        lora[m]["b"].normal_(0.0, 0.05, generator=gen)
    return lm, lora, lcfg


def _backbone(lm, term, s=7):
    embeds = lm.embed(torch.arange(3, 3 + 2 * s).reshape(2, s))
    pos = torch.arange(s).expand(2, s)
    return lm.backbone(embeds, pos, None, None, None, "train", term)[0]


def test_forward_term_at_rate_zero_matches_merge(setup):
    """q / v + scale·(h·A)·B at dropout 0 equals the parameter-space merge,
    and equals the model with the adapters merged into its weights."""
    pcfg = setup[1]
    lm, lora, lcfg = _lm(pcfg)
    with torch.no_grad():
        term = _backbone(lm, LoRATerm(lora, lcfg.scale, 0.0, merge=False))
        merged = _backbone(lm, LoRATerm(lora, lcfg.scale, 0.0, merge=True))
        base = _backbone(lm, None)
    torch.testing.assert_close(term, merged, rtol=1e-5, atol=1e-5)
    assert float((term - base).abs().max()) > 1e-3  # the adapters contribute

    class Wrap(torch.nn.Module):
        def __init__(self, llm):
            super().__init__()
            self.llm = llm

    plora.apply_lora(Wrap(lm), lora, lcfg)
    with torch.no_grad():
        torch.testing.assert_close(_backbone(lm, None), merged, rtol=1e-5, atol=1e-5)


def test_dropout_draws_depend_on_seed_and_step_only(setup):
    """Forward-term dropout: the same (seed, step) draws the same masks, in
    a fresh model too, and with each layer recomputed by remat (the
    gradients equal those without remat); another step draws others."""
    pcfg = setup[1]
    grads, outs = [], []
    for remat in (False, True):
        lm, lora, lcfg = _lm(pcfg, remat=remat)
        for m in ("q", "v"):
            for k in ("a", "b"):
                lora[m][k].requires_grad_(True)
        term = LoRATerm(lora, lcfg.scale, 0.5, merge=False, seed=fold_in(0, 2))
        out = _backbone(lm, term)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([lora[m][k].grad.clone() for m in ("q", "v") for k in ("a", "b")])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    for g0, g1 in zip(*grads):
        torch.testing.assert_close(g0, g1, rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        other = _backbone(lm, LoRATerm(lora, lcfg.scale, 0.5, merge=False, seed=fold_in(0, 3)))
    assert float((other - outs[0]).abs().max()) > 1e-4


def test_lora_checkpoint_files_match_jax_and_load(setup, runs, tmp_path):
    """``save_lora_checkpoint`` writes JAX's files (config, adapters,
    non-LoRA trainables); ``merge_lora_from_dir`` and
    ``model_init(model_path=, adapter_path=)`` load them into the model that
    ``merge_for_eval`` gives, whose forward they reproduce."""
    jcfg, pcfg, params = setup[0], setup[1], setup[2]
    model, state = runs["model"], runs["pstate"]
    jl = jax.tree.map(np.asarray, runs["jend"]["lora"])
    non_lora = plora.non_lora_state_dict(model)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jlora.save_lora_checkpoint(jdir, jl, jcfg, jlora.LoRAConfig(r=R, alpha=ALPHA, dropout=0.0),
                               non_lora)
    plora.save_lora_checkpoint(pdir, state.lora, pcfg,
                               plora.LoRAConfig(r=R, alpha=ALPHA, dropout=0.0), non_lora)
    for f in ("adapter_config.json",):
        assert json.load(open(os.path.join(pdir, f))) == json.load(open(os.path.join(jdir, f)))
    for f in ("adapter_model.bin", "non_lora_trainables.bin"):
        a, b = (torch.load(os.path.join(d, f), weights_only=True) for d in (pdir, jdir))
        assert sorted(a) == sorted(b)
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=2e-6 if "lora_" in k else 0)

    # the base (the untrained model) as a checkpoint, the adapter over it
    base = fx.port_model(pcfg, params)
    base_dir = str(tmp_path / "base")
    save_hf_checkpoint(base_dir, base)
    merged_sd = merge_lora_from_dir(export_full_checkpoint(base), pdir)
    rt, _, tok = model_init(base_dir, cfg=pcfg, device="cpu", adapter_path=pdir)
    plora.merge_for_eval(model, state, plora.LoRAConfig(r=R, alpha=ALPHA, dropout=0.0))
    loaded = dict(rt.model.named_parameters())
    for name, p in model.named_parameters():
        torch.testing.assert_close(loaded[name], p.detach(), rtol=1e-6, atol=1e-6,
                                   msg=lambda m: f"{name}: {m}")
    for i in range(pcfg.llm.num_layers):
        key = f"model.layers.{i}.self_attn.q_proj.weight"
        assert not torch.equal(merged_sd[key], export_full_checkpoint(base)[key])
