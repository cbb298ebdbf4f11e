"""Two places where the port once differed from the JAX package, held
against it on the CPU (``tiny_config()`` sizes, float32).

- The W8A8 Hiera blocks with the bf16 polynomial GELU
  (``VisionRouting(hiera_gelu="poly_bf16")`` under ``quant_vision``). JAX's
  ``_gelu_poly_bf16`` returns bf16, and the W8A8 kernels' bodies quantise
  that bf16 output with ``_quant_rows_f32``, whose amax, scale and division
  then run in bf16. The port quantises it the same way
  (``quant_rows_bf16``). Off the TPU the JAX W8A8 ops run their XLA
  references; the whole block's (``w8a8_reference``) quantises in bf16 as
  the kernel does, while the tail's and the q-pool block's (``_qdot_ref``)
  cast to f32 first. So the JAX side here runs the W8A8 kernels in
  interpret mode: the quantiser equals JAX's value for value, each block
  agrees on the measure of ``_held`` (flipped int8 steps only), and the
  ``[SEG]`` masks of a quantised SAM2 are equal outside ``BAND`` of the
  threshold.
- A raw uint8 annotated ``frame``. The port resizes and normalises it as it
  does uint8 video frames; JAX encodes the 0-255 values as they come. The
  port's uint8 path is held against JAX fed ``siglip_preprocess_device``'s
  output: region tokens to ``TOL``, greedy tokens equal.

The JAX side takes ``UFVIDEO_HIERA_GELU`` from the environment at trace
time: it is set on the JAX side only, with ``jax.clear_caches()`` around it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu import quant as jq
from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.api import mm_infer as j_mm_infer
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu.models.sam2 import video as jvideo
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.ops import hiera_block as jhb
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch.api import UFVideoRuntime, mm_infer
from ufvideo_tpu_torch.configs import VisionRouting, tiny_config
from ufvideo_tpu_torch.models.sam2 import SAM2
from ufvideo_tpu_torch.models.sam2 import video as tvideo
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.ops import hiera_block as thb
from ufvideo_tpu_torch.ops import image_pipeline
from ufvideo_tpu_torch.ops.interp import resize_hw
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.weights import load_by_name, load_jax_params

TOL = 1e-4  # float region tokens: f32 sums in another order
TIGHT, BULK, MEAN, STEP = 1e-4, 0.95, 0.05, 0.25  # W8A8: as tests/test_torch_seg_quant.py
BAND, IN_BAND = 0.05, 0.25
LABEL = (48, 64)
POLY = "gelu_poly_bf16"


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _held(got, want, what, bulk=True):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    close = diff <= TIGHT + TIGHT * np.abs(want)
    print(f"{what}: {close.mean():.5f} within {TIGHT}, mean difference {diff.mean():.6f}, "
          f"largest {diff.max():.4f}")
    if bulk:  # one block; behind many, flips spread (tests/test_torch_seg_quant.py)
        assert close.mean() > BULK
    assert diff.mean() < MEAN
    assert diff.max() < STEP


# ---------------------------------------------- fault 1: the bf16 quantiser --

@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0])
def test_quant_rows_bf16_equals_jax_on_bf16_rows(scale):
    """Codes and scales value for value, the saturation at 128 included."""
    x = _randn(0, 512, 96) * scale * np.random.default_rng(1).uniform(0.1, 10, (512, 1))
    hb = jhb._gelu_poly_bf16(jnp.asarray(x, dtype=jnp.float32))
    assert hb.dtype == jnp.bfloat16
    want_q, want_s = jax.jit(jhb._quant_rows_f32)(hb)
    got_q, got_s = thb.quant_rows_bf16(torch.tensor(np.asarray(hb.astype(jnp.float32))))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s.astype(jnp.float32)))


def _qk(seed, din, dout):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (din, dout)).astype(np.int8),
            (np.abs(0.02 * rng.standard_normal(dout)) + 1e-4).astype(np.float32),
            (0.1 * rng.standard_normal(dout)).astype(np.float32))


def _ln(seed, c):
    return 1 + 0.1 * _randn(seed, c), 0.1 * _randn(seed + 1, c)


def _tail_params(c, a, mlp, seed):
    return (*_qk(seed, a, c), *_ln(seed + 1, c), *_qk(seed + 3, c, mlp), *_qk(seed + 4, mlp, c))


def _to_jax(params):
    return tuple(jnp.asarray(p) for p in params)


def _to_torch(params):
    return tuple(torch.from_numpy(p) for p in params)


@pytest.mark.parametrize("kernel", ["block", "tail", "qpool"])
def test_w8a8_kernels_with_the_bf16_polynomial_match_the_jax_kernels(kernel):
    """Each W8A8 kernel's plain version against the JAX kernel in interpret
    mode, ``act="gelu_poly_bf16"``: the rows after fc1 are quantised in
    bf16 on both sides. The f32 quantiser there (the port before) moves
    nearly every element (checked on the same inputs)."""
    if kernel == "block":
        n, s, c, heads, mlp = 2, 16, 32, 2, 128
        x = _randn(2, n, s, c)
        params = (*_ln(3, c), *_qk(5, c, 3 * c), *_qk(6, c, c), *_ln(7, c),
                  *_qk(9, c, mlp), *_qk(10, mlp, c))
        want = jhb.fused_block_w8a8(jnp.asarray(x), _to_jax(params), heads, c // heads,
                                    interpret=True, act=POLY)
        run = lambda act: thb.fused_block_w8a8_plain(torch.from_numpy(x), _to_torch(params),
                                                     heads, c // heads, act=act)
    elif kernel == "tail":
        n, s, c, a, mlp = 2, 16, 32, 48, 128
        shortcut, att = _randn(2, n, s, c), _randn(3, n, s, a)
        params = _tail_params(c, a, mlp, 4)
        want = jhb.fused_block_tail_w8a8(jnp.asarray(shortcut), jnp.asarray(att),
                                         _to_jax(params), interpret=True, act=POLY)
        run = lambda act: thb.fused_block_tail_w8a8_plain(
            torch.from_numpy(shortcut), torch.from_numpy(att), _to_torch(params), act=act)
    else:
        n, ws, cin, cout, heads, mlp = 2, 4, 16, 32, 2, 128
        hw = cout
        x = _randn(2, n, ws * ws, cin)
        params = (*_ln(3, cin), *_qk(5, cin, 3 * hw + cout), *_qk(6, hw, cout), *_ln(7, cout),
                  *_qk(9, cout, mlp), *_qk(10, mlp, cout))
        want = jhb.fused_qpool_block_w8a8(jnp.asarray(x), _to_jax(params), heads, hw // heads,
                                          0, (2, 2), interpret=True, act=POLY)
        run = lambda act: thb.fused_qpool_block_w8a8_plain(
            torch.from_numpy(x), _to_torch(params), heads, hw // heads, (2, 2), act=act)
    got = run(POLY)
    _held(got, want, f"W8A8 {kernel}, {POLY}")
    # the same values with the GELU output quantised in f32, as the port did
    f32 = thb._BF16_ACTS
    try:
        thb._BF16_ACTS = ()
        before = run(POLY).numpy()
    finally:
        thb._BF16_ACTS = f32
    close = np.abs(before - np.asarray(want)) <= TIGHT + TIGHT * np.abs(np.asarray(want))
    assert close.mean() < BULK


def _interpret_w8a8(mp):
    """Route the JAX W8A8 block, q-pool and tail through their kernels'
    bodies in interpret mode (they quantise as the port's kernels do)."""
    for name in ("fused_block_w8a8", "fused_qpool_block_w8a8", "fused_block_tail_w8a8"):
        real = getattr(jhb, name)
        mp.setattr(jhb, name, lambda *a, _r=real, interpret=False, **kw: _r(
            *a, interpret=True, **kw))


@pytest.fixture(scope="module")
def quant_sam_pair():
    """(JAX quantised SAM2 and tree, the port's SAM2 on the same tree under
    ``hiera_gelu="poly_bf16"``)."""
    jcfg = j_tiny_config().sam
    jm = JSAM2(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 128, 128, 3)))["params"])(
        jax.random.PRNGKey(1))
    leaves, treedef = jax.tree.flatten(params)
    rng = np.random.default_rng(1)
    params = jax.tree.unflatten(treedef, [
        np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32) for a in leaves])
    qparams = jq.quantize_sam2_params(params)
    jmq = JSAM2(jcfg, dtype=jnp.float32, param_dtype=jnp.float32, quant=True)
    model = SAM2(tiny_config().sam, dtype=torch.float32, quant=True,
                 routing=VisionRouting(hiera_gelu="poly_bf16")).eval()
    load_by_name(model, _np_tree(qparams))
    return jmq, qparams, model


def test_quantised_sam2_with_the_bf16_polynomial_segments_as_jax(quant_sam_pair):
    jmq, qparams, model = quant_sam_pair
    assert all(blk.act == POLY for blk in model.image_encoder_trunk.blocks)
    images = _randn(31, 3, 128, 128, 3)
    embeds = _randn(32, 2, 32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("UFVIDEO_HIERA_GELU", "poly_bf16")
        _interpret_w8a8(mp)
        jax.clear_caches()
        feats = jvideo.encode_video_frames(jmq, qparams, jnp.asarray(images))
        low = jvideo.propagate_video(jmq, qparams, feats, jnp.asarray(embeds)[:, None, :])
        want = np.asarray(jvideo.masks_to_video_res(low, *LABEL)).transpose(1, 0, 2, 3)
        want_fpn = jmq.apply({"params": qparams}, jnp.asarray(images[:1]),
                             method=JSAM2.forward_image)["backbone_fpn"]
    jax.clear_caches()
    with torch.no_grad():
        got_fpn = model.forward_image(torch.from_numpy(images[:1]))["backbone_fpn"]
        tf = tvideo.encode_video_frames(model, torch.from_numpy(images))
        tlow = tvideo.propagate_video(model, tf, torch.from_numpy(embeds)[:, None, :])
        got = tvideo.masks_to_video_res(tlow, *LABEL).permute(1, 0, 2, 3).numpy()
        logits = resize_hw(tlow.float(), *LABEL, "bilinear")[:, :, 0].permute(1, 0, 2, 3)
    for level, (g, w) in enumerate(zip(got_fpn, want_fpn)):
        _held(g, w, f"fpn level {level}", bulk=False)
    assert got.shape == want.shape == (2, 3, *LABEL)
    for g, w, lg in zip(got, want, logits.numpy()):
        band = np.abs(lg) < BAND
        print(f"masks: {int(band.sum())} of {band.size} pixels within {BAND}, "
              f"{int((g != w).sum())} differ, foreground share {w.mean():.3f}")
        assert (g == w)[~band].all()
        assert band.mean() < IN_BAND and 0.0 < w.mean() < 1.0


# ------------------------------------------- fault 2: uint8 annotated frames --

def _with_ids(cfg, ids):
    return cfg.replace(region_token_id=ids.region, seg_token_id=ids.seg,
                       temporal_token_start_id=ids.temporal_start)


@pytest.fixture(scope="module")
def float_runtimes():
    jtok, jids = j_byte_tokenizer()
    jcfg = _with_ids(j_tiny_config(), jids)
    params = jax.jit(JUFVideoModel(jcfg).init_params)(jax.random.PRNGKey(0))
    jrt = JRuntime(jcfg, dict(params), jids)
    tok, ids = byte_tokenizer_with_ids()
    cfg = _with_ids(tiny_config(), ids)
    model = UFVideoModel.empty(cfg, "cpu")
    load_jax_params(model, _np_tree(params))
    return (jrt, jtok), (UFVideoRuntime(cfg, model, ids, "cpu"), tok)


def test_uint8_annotated_frame_matches_jax_fed_the_preprocessed_frame(float_runtimes,
                                                                      monkeypatch):
    """The port resizes and normalises a uint8 ``frame`` (its documented
    deviation); JAX given that preprocessed frame gives the same region
    tokens and the same greedy tokens. ``siglip_preprocess_device`` resizes
    to the full tower's 384 pixels: here it resizes to the tiny tower's 56,
    the rest of it unchanged."""
    (jrt, jtok), (rt, tok) = float_runtimes
    size = rt.cfg.vision.image_size
    monkeypatch.setattr(image_pipeline, "siglip_preprocess_device",
                        lambda f, out_dtype=torch.bfloat16: image_pipeline.resize_normalize(
                            f, image_pipeline.SIGLIP_MEAN, image_pipeline.SIGLIP_STD,
                            size=size, rescale=True, out_dtype=out_dtype))
    rng = np.random.default_rng(23)
    frames = rng.standard_normal((4, size, size, 3)).astype(np.float32)
    ann = rng.integers(0, 256, (2, 40, 52, 3)).astype(np.uint8)
    masks = (rng.random((2, 30, 44)) > 0.5).astype(np.float32)
    pre = image_pipeline.siglip_preprocess_device(torch.from_numpy(ann),
                                                  out_dtype=torch.float32).numpy()
    assert pre.shape == (2, size, size, 3) and np.abs(pre).max() <= 1.0 + 1e-6
    got, got_counts = rt.pack_and_encode_regions(ann, masks, [[0, 1]])
    want, want_counts = jrt.pack_and_encode_regions(pre, masks, [[0, 1]])
    assert got_counts == want_counts == [2]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    question = "What is <region> doing?"
    kw = dict(masks=masks, ann_indices=[[0, 1]], max_new_tokens=8)
    text, out = mm_infer(frames, question, rt, tok, frame=ann, **kw)
    jtext, jout = j_mm_infer(frames, question, jrt, jtok, frame=pre, **kw)
    assert list(out["output"]) == list(jout["output"]) and text == jtext
