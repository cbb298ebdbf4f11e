"""The port's training step against the JAX package's, CPU, float32, at the
micro configuration of ``tests/test_train_e2e.py``: the four losses,
``select_seg_hidden``, the optimizer (schedule, clip, AdamW, groups) against
optax, ``sam_train_masks``, and the ``[SEG]`` + ``<region>`` step under the
reference's freezing policy: its loss dict, the gradient of every trainable
tensor and the parameters after three steps.

JAX's side runs once per module: one jitted ``_build_step`` (no mesh) for
each loss. Gradients are compared through the Adam first moments after the
first step, which runs at learning rate 0 (warmup from 0, read before the
count's increment) and so leaves the first moment at 0.1 × the clipped
gradient on both sides; ``grad_norm`` pins the scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu.models.sam2.video import sam_train_masks as j_sam_train_masks
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.train import losses as jl
from ufvideo_tpu.train import seg_step as jseg
from ufvideo_tpu.train import train_step as jts
from ufvideo_tpu_torch.models.sam2.video import sam_train_masks
from ufvideo_tpu_torch.train import losses as pl
from ufvideo_tpu_torch.train import seg_step as pseg
from ufvideo_tpu_torch.train import train_step as pts

import torch_train_fixtures as fx

LR, TOTAL, WARMUP_RATIO = 1e-3, 10, 0.1  # warmup 1: step 0 at lr 0, then cosine
N_STEPS = 3
# float32 on both sides, the same sums in another order
LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
# first moments (0.1 × clipped gradient), relative to the largest entry of
# the tensor, or to 1e-3 of the largest entry of any tensor where that is
# larger: a key projection's bias has a zero gradient in exact arithmetic
# (softmax ignores a shift shared by all keys), so both sides hold rounding
GRAD_REL = 2e-4
GRAD_FLOOR = 1e-3
# parameters after three steps, through the change of each tensor over the
# three steps: its norm against JAX's within 0.5%, each element within 2·lr.
# Adam divides by the root of the second moment, so an element whose
# gradients nearly cancel across steps turns a 1e-6 gradient difference into
# up to a few percent of lr (one element in thousands reads 3% of lr); a
# wrong learning rate, group, clip or step count moves whole tensors. A
# tensor whose gradient is rounding noise on both sides (under GRAD_FLOOR of
# the largest, a key bias) is moved by Adam by ~lr in the noise's sign: only
# the 2·lr bound applies to it
PARAM_REL = 5e-3
PARAM_ATOL = 2 * LR


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg, jtok, tok, ids = fx.micro_configs()
    params = fx.jax_params(jcfg)
    jb, pb = fx.collated(jcfg, pcfg, jtok, tok, ids)
    return jcfg, pcfg, params, jb, pb


def _jax_run(jcfg, params, jb, loss_fn, batch_cls):
    """JAX's ``_build_step`` under the reference policy, three steps:
    (metrics of each step, first moments after step 0, params after)."""
    model = JUFVideoModel(jcfg)
    mask = jts.freeze_mask(params)
    opt = jts.with_frozen(
        jts.make_optimizer(LR, warmup_ratio=WARMUP_RATIO, total_steps=TOTAL), mask)
    step = jax.jit(jts._build_step(model, opt, loss_fn, mask))
    state = jts.TrainState(jnp.zeros((), jnp.int32), params, opt.init(params))
    batch = fx.jax_batch(jb, batch_cls)
    metrics, mu0 = [], None
    for i in range(N_STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            mu0 = _first_moment(state.opt_state, params, mask)
    return metrics, mu0, jax.tree.map(np.asarray, state.params)


def _first_moment(opt_state, params, mask):
    """The trainable group's Adam mu, zeros at frozen leaves."""
    inner = opt_state.inner_states[True].inner_state  # (clip, adamw chain)
    mu = inner[1][0].mu
    return jax.tree.map(
        lambda m, p, t: np.asarray(m) if t else np.zeros(p.shape, np.float32),
        mu, params, mask, is_leaf=lambda x: isinstance(x, optax.MaskedNode))


def _port_run(pcfg, params, pb, loss_fn, batch_cls):
    model = fx.port_model(pcfg, params)
    trainable = pts.apply_freeze(model, pts.freeze_mask(model))
    opt = pts.make_optimizer(LR, warmup_ratio=WARMUP_RATIO, total_steps=TOTAL)
    init, step = pts.make_train_step(model, opt, loss_fn)
    state = init(trainable)
    batch = fx.torch_batch(pb, batch_cls)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics, mu0 = [], None
    for i in range(N_STEPS):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            mu0 = {n: t.clone() for n, t in state.opt_state["mu"].items()}
    return metrics, mu0, model, start


@pytest.fixture(scope="module")
def seg_runs(setup):
    jcfg, pcfg, params, jb, pb = setup
    sam = JSAM2(jcfg.sam, dtype=jnp.float32, param_dtype=jnp.float32)
    j = _jax_run(jcfg, params, jb, jseg.make_seg_loss_fn(sam), jseg.SegBatch)
    p = _port_run(pcfg, params, pb, pseg.segmentation_loss_fn, pseg.SegBatch)
    return j, p


@pytest.fixture(scope="module")
def lm_runs(setup):
    jcfg, pcfg, params, jb, pb = setup
    j = _jax_run(jcfg, params, jb, jts.language_model_loss_fn, jts.Batch)
    p = _port_run(pcfg, params, pb, pts.language_model_loss_fn, pts.Batch)
    return j, p


# ------------------------------------------------------------------ losses --

def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((2, 9, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 30, (2, 9)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 5] = -100
    pred = rng.standard_normal((5, 12, 16)).astype(np.float32) * 4
    gt = (rng.random((5, 12, 16)) > 0.6).astype(np.float32)
    valid = np.array([True, True, False, True, False])
    return logits, labels, pred, gt, valid


LOSSES = {
    # (JAX function of (x, ...), port function, which input is differentiated)
    "causal_lm_loss": (lambda x, a: jl.causal_lm_loss(x, a["labels"], 33),
                       lambda x, a: pl.causal_lm_loss(x, a["labels"], 33), "logits"),
    "dice_loss": (lambda x, a: jl.dice_loss(x, a["gt"], 3.0, valid=a["valid"]),
                  lambda x, a: pl.dice_loss(x, a["gt"], 3.0, valid=a["valid"]), "pred"),
    "sigmoid_ce_loss": (lambda x, a: jl.sigmoid_ce_loss(x, a["gt"], 3.0, valid=a["valid"]),
                        lambda x, a: pl.sigmoid_ce_loss(x, a["gt"], 3.0, valid=a["valid"]),
                        "pred"),
    "combined_mask_loss": (lambda x, a: sum(jl.combined_mask_loss(x, a["gt"], a["valid"])),
                           lambda x, a: sum(pl.combined_mask_loss(x, a["gt"], a["valid"])),
                           "pred"),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_and_its_gradient_match_jax(name):
    """Each loss and its gradient against JAX's (float32, 1e-5): the padded
    vocabulary masked, IGNORE_INDEX skipped, invalid masks contributing 0."""
    logits, labels, pred, gt, valid = _loss_inputs(1)
    jfn, pfn, wrt = LOSSES[name]
    x = logits if wrt == "logits" else pred
    ja = dict(labels=jnp.asarray(labels), gt=jnp.asarray(gt), valid=jnp.asarray(valid))
    pa = dict(labels=torch.from_numpy(labels), gt=torch.from_numpy(gt),
              valid=torch.from_numpy(valid))
    jv, jg = jax.value_and_grad(lambda t: jfn(t, ja))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    pv = pfn(xt, pa)
    pv.backward()
    np.testing.assert_allclose(float(pv.detach()), float(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)


def test_select_seg_hidden_matches_jax():
    """First [SEG] positions first, padded with invalid slots, as JAX's."""
    rng = np.random.default_rng(2)
    hidden = rng.standard_normal((3, 10, 4)).astype(np.float32)
    labels = rng.integers(0, 5, (3, 10)).astype(np.int32)
    labels[0, [2, 7, 9]] = 99
    labels[1, 4] = 99
    jp, jv = jseg.select_seg_hidden(jnp.asarray(hidden), jnp.asarray(labels), 99, 3)
    pp, pv = pseg.select_seg_hidden(torch.from_numpy(hidden), torch.from_numpy(labels), 99, 3)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))


# --------------------------------------------------------------- optimizer --

@pytest.mark.parametrize("grad_scale", [0.05, 20.0], ids=["unclipped", "clipped"])
def test_schedule_clip_adamw_match_optax(grad_scale):
    """Three steps of ``make_optimizer`` with a projector group, behind the
    freeze: the same parameters as optax after every step; step 0 moves
    nothing (lr 0); the clip is one global norm across both groups; frozen
    leaves keep their values."""
    rng = np.random.default_rng(3)
    shapes = {"projector": (4, 3), "llm": (5,), "region": (2, 2), "vision": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    mask = {k: k != "vision" for k in shapes}
    jopt = jts.with_frozen(jts.make_optimizer(
        1e-2, warmup_ratio=0.2, total_steps=8, mm_projector_lr=5e-2), mask)
    popt = pts.make_optimizer(1e-2, warmup_ratio=0.2, total_steps=8, mm_projector_lr=5e-2)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items() if mask[k]}
    pstate = popt.init(pp)
    for i in range(3):
        grads = {k: (grad_scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        norm = popt.update(pp, {k: torch.from_numpy(grads[k]) for k in pp}, pstate)
        want = np.sqrt(sum(float(np.sum(grads[k] ** 2)) for k in pp))
        np.testing.assert_allclose(float(norm), want, rtol=1e-6)
        for k in pp:
            # the learning rate is a float64 here, a float32 in optax: the
            # steps (up to 5e-2) agree to a few float32 ulps of the values
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=2e-6,
                                       err_msg=f"{k} after step {i}")
            if i == 0:
                np.testing.assert_array_equal(pp[k].numpy(), params[k])
        np.testing.assert_array_equal(np.asarray(jp["vision"]), params["vision"])
    assert popt.group("projector.w") == "projector" and popt.group("llm.w") == "base"


def test_freeze_mask_matches_jax(setup):
    """The port's policy flags every parameter as JAX's tree does: the
    towers frozen, SAM2's mask decoder trainable, the rest trainable."""
    jcfg, pcfg, params, _, _ = setup
    jmask = jts.freeze_mask(params)
    as_float = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params)
    model = fx.port_model(pcfg, params)
    pmask = pts.freeze_mask(model)
    for name, flag in fx.port_named(pcfg, as_float).items():
        assert bool(flag.flatten()[0]) == pmask[name], name
    assert any(pmask[n] for n in pmask if n.startswith("sam.sam_mask_decoder."))
    assert not any(pmask[n] for n in pmask if n.startswith(("vision.", "sam.image_encoder")))


# ------------------------------------------------------------------- steps --

def _check_metrics(j, p):
    for i, (jm, pm) in enumerate(zip(j[0], p[0])):
        assert sorted(jm) == sorted(pm)
        for k in jm:
            np.testing.assert_allclose(pm[k], jm[k], **LOSS_TOL, err_msg=f"{k} at step {i}")


def _check_first_moments(pcfg, j, p):
    want = fx.port_named(pcfg, j[1])
    got = p[1]
    assert got, "no trainable tensor"
    floor = GRAD_FLOOR * max(float(want[n].abs().max()) for n in got)
    for name, g in got.items():
        scale = max(float(want[name].abs().max()), floor)
        err = float((g - want[name]).abs().max()) / scale
        assert err <= GRAD_REL, f"{name}: gradient differs by {err:.2e} of its scale"


def _noise_only(pcfg, j) -> set:
    """Trainable tensors whose JAX gradient is under GRAD_FLOOR of the largest."""
    mu = fx.port_named(pcfg, j[1])
    top = max(float(t.abs().max()) for t in mu.values())
    return {n for n, t in mu.items() if float(t.abs().max()) < GRAD_FLOOR * top}


def _check_params(pcfg, j, p):
    want = fx.port_named(pcfg, j[2])
    noise = _noise_only(pcfg, j)
    _, _, model, start = p
    moved = 0
    for name, t in model.named_parameters():
        got = t.detach()
        if not t.requires_grad:
            assert torch.equal(got, start[name]), f"frozen {name} moved"
            assert torch.equal(want[name], start[name]), f"JAX moved frozen {name}"
            continue
        d_got, d_want = got - start[name], want[name] - start[name]
        scale = float(d_want.norm())
        moved += int(scale > 0)
        if name not in noise:
            assert float((d_got - d_want).norm()) <= PARAM_REL * scale, name
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
    assert moved > 0


def test_language_model_loss_step_matches_jax(setup, lm_runs):
    """``language_model_loss_fn`` through three steps: the loss dict and
    grad_norm of each step, the gradient of every trainable tensor, and the
    parameters after (the frozen tower unchanged)."""
    pcfg = setup[1]
    j, p = lm_runs
    _check_metrics(j, p)
    _check_first_moments(pcfg, j, p)
    _check_params(pcfg, j, p)


def test_seg_loss_dict_matches_jax(seg_runs):
    """``segmentation_loss_fn``: ce / bce / dice / mask / total and
    grad_norm at each of the three steps; step 1 repeats step 0 (lr 0)."""
    j, p = seg_runs
    _check_metrics(j, p)
    assert p[0][0] == pytest.approx(p[0][1], rel=1e-6)
    assert p[0][2]["loss"] < p[0][1]["loss"]


def test_seg_gradients_match_jax(setup, seg_runs):
    """The gradient of every trainable tensor, the SAM2 mask decoder, the
    text head and the region encoder among them."""
    pcfg = setup[1]
    j, p = seg_runs
    _check_first_moments(pcfg, j, p)
    for prefix in ("sam.sam_mask_decoder.", "text_fcs.", "region.", "projector.", "llm."):
        assert any(n.startswith(prefix) and float(g.abs().max()) > 0
                   for n, g in p[1].items()), prefix


def test_seg_three_steps_match_jax(setup, seg_runs):
    """Every parameter after three steps under the reference's policy."""
    _check_params(setup[1], *seg_runs)


def test_sam_train_masks_matches_jax(setup):
    """The training decode (no memory, language-prompted heads, a flat row
    batch) and its gradient with respect to the language embeddings."""
    jcfg, pcfg, params, _, _ = setup
    sam = JSAM2(jcfg.sam, dtype=jnp.float32, param_dtype=jnp.float32)
    rng = np.random.default_rng(4)
    h = jcfg.sam.sam_image_embedding_size
    c = jcfg.sam.sam_embed_dim
    s0 = rng.standard_normal((3, 4 * h, 4 * h, c // 8)).astype(np.float32)
    s1 = rng.standard_normal((3, 2 * h, 2 * h, c // 4)).astype(np.float32)
    s2 = rng.standard_normal((3, h, h, c)).astype(np.float32)
    lang = rng.standard_normal((3, 1, c)).astype(np.float32)

    def jf(lang_):
        out = j_sam_train_masks(sam, params["sam"], s0, s1, s2, lang_)
        return jnp.sum(jnp.tanh(out)), out

    (_, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(lang))
    model = fx.port_model(pcfg, params)
    lt = torch.from_numpy(lang).requires_grad_(True)
    out = sam_train_masks(model.sam, *(torch.from_numpy(a) for a in (s0, s1, s2)), lt)
    torch.tanh(out).sum().backward()
    assert out.shape == (3, 1, SAM := jcfg.sam.hiera.image_size, SAM)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), rtol=1e-3, atol=1e-4)
