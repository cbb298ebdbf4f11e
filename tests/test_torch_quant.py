"""The port's quantisation against the JAX package, on the CPU.

Function by function (``quant.py``: int8 / packed-int4 values EQUAL, scales
to 1e-7), the plain version of each quantised kernel against the JAX kernel
as the JAX package's own tests run it on the CPU (Pallas interpret mode, or
the XLA reference next to it), and the quantised modules (``QuantLinear``,
``Qwen2LM(quant=...)``, ``greedy_generate(kv_quant=True)``, the W8A8 SigLIP
tower) on parameters quantised by JAX and carried across by
``load_jax_params``' loaders. Inputs come from a numpy seed, f32. The CUDA
kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu import quant as jq
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models import generate as jgen
from ufvideo_tpu.models import qwen2 as jqwen2
from ufvideo_tpu.models.siglip import SiglipVisionTower as JSiglip
from ufvideo_tpu.ops import hiera_block as jhb
from ufvideo_tpu.ops import quant_matmul as jqm
from ufvideo_tpu.ops.attention import decode_attention as j_decode_attention
from ufvideo_tpu.ops.decode_attention import ragged_decode_attention_q8 as j_ragged_q8
from ufvideo_tpu_torch import quant as tq
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models import generate as tgen
from ufvideo_tpu_torch.models import qwen2 as tqwen2
from ufvideo_tpu_torch.models.siglip import SiglipVisionTower
from ufvideo_tpu_torch.ops import attention as t_attention
from ufvideo_tpu_torch.ops import decode_attention as tda
from ufvideo_tpu_torch.ops import hiera_block as thb
from ufvideo_tpu_torch.ops import quant_matmul as tqm
from ufvideo_tpu_torch.weights import load_qwen2, load_siglip

SCALE_ATOL = 1e-7


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _kernel(seed, *shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


# ------------------------------------------------------------- quant.py --

@pytest.mark.parametrize("shape", [(64, 48), (3, 128, 40)], ids=["2d", "scan-stacked"])
def test_quantize_kernel_equals_jax(shape):
    w = _kernel(0, *shape)
    w[..., 5] = 0.0  # an all-zero column: the scale's floor
    want = jq.quantize_kernel(jnp.asarray(w))
    got = tq.quantize_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                               atol=SCALE_ATOL, rtol=0)
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32


@pytest.mark.parametrize("shape", [(128, 24), (2, 192, 16)], ids=["2d", "scan-stacked"])
def test_quantize_kernel4_and_packing_equal_jax(shape):
    w = _kernel(1, *shape)
    want = jq.quantize_kernel4(jnp.asarray(w), 64)
    got = tq.quantize_kernel4(torch.from_numpy(w), 64)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                               atol=SCALE_ATOL, rtol=0)
    unpacked = tq.unpack_int4(got["q"])
    np.testing.assert_array_equal(unpacked.numpy(), np.asarray(jq.unpack_int4(want["q"])))
    assert int(unpacked.min()) >= -7 and int(unpacked.max()) <= 7


def test_pack_unpack_int4_round_trip_over_the_whole_range():
    q = np.random.default_rng(2).integers(-8, 8, (2, 32, 12)).astype(np.int8)
    q[0, :16, 0] = np.arange(-8, 8)  # every value in the low and the high nibble
    q[0, 16:, 0] = np.arange(-8, 8)[::-1]
    packed = tq.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tq.unpack_int4(packed).numpy(), q)


def test_row_quantisers_equal_jax_each_with_its_own_formula():
    x = (np.random.default_rng(3).standard_normal((6, 40)) * 3).astype(np.float32)
    x[2] = 0.0  # an all-zero row meets each floor
    for got, want in (
        (tq.quantize_rows(torch.from_numpy(x)), jq.quantize_rows(jnp.asarray(x))),
        (thb.quant_rows_f32(torch.from_numpy(x)), jhb._quant_rows_f32(jnp.asarray(x))),
    ):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=SCALE_ATOL, rtol=0)
    kv = x.reshape(2, 3, 40)
    got, want = tqwen2.quantize_kv(torch.from_numpy(kv)), jqwen2.quantize_kv(jnp.asarray(kv))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=SCALE_ATOL, rtol=0)
    assert got[1].shape == (2, 3) and float(got[1][0, 2]) == 0.0


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_param_trees_equal_jax(bits):
    """The tree functions on the JAX LM's and tower's own parameter trees."""
    cfg = j_tiny_config()
    lm = jqwen2.Qwen2LM(cfg.llm, dtype=jnp.float32, param_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    want = _np(jq.quantize_qwen2_params(params, bits=bits))
    got = tq.quantize_qwen2_params(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params),
                                   bits=bits)
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), got))
    assert tree_w == tree_g
    for a, b in zip(flat_g, flat_w):
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=SCALE_ATOL, rtol=0)
    if bits == 8:
        tower = JSiglip(cfg.vision, dtype=jnp.float32, param_dtype=jnp.float32)
        vp = tower.init(jax.random.PRNGKey(1), jnp.zeros((1, 56, 56, 3)))["params"]
        want_v = _np(jq.quantize_vision_params(vp))
        got_v = tq.quantize_vision_params(
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), vp))
        a = got_v["layers"]["mlp"]["fc1"]["kernel_q"].numpy()
        np.testing.assert_array_equal(a, want_v["layers"]["mlp"]["fc1"]["kernel_q"])
        assert "kernel" in got_v["layers"]["layer_norm1"] or "scale" in got_v["layers"]["layer_norm1"]
        assert got_v["patch_embedding_kernel"].dtype == torch.float32


# -------------------------------------------- plain versions of kernels --

@pytest.mark.parametrize("rows,din,dout", [(1, 256, 512), (5, 128, 256)])
def test_int8_matvec_plain_matches_pallas_interpret(rows, din, dout):
    """rtol / atol 1e-3, the JAX test's: both sides take bf16 x and f32 sums."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((rows, din)).astype(np.float32)
    qd = jq.quantize_kernel(jnp.asarray(_kernel(5, din, dout)))
    want = np.asarray(jqm.int8_matvec(jnp.asarray(x), qd["q"], qd["scale"], interpret=True))
    got = tqm.int8_matvec(*_t(x, qd["q"], qd["scale"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
    # leading axes are kept
    got3 = tqm.int8_matvec_plain(*_t(x.reshape(rows, 1, din), qd["q"], qd["scale"]))
    assert got3.shape == (rows, 1, dout)


@pytest.mark.parametrize("rows,din,dout", [(1, 256, 512), (4, 128, 256)])
def test_int4_matmul_plain_matches_reference_and_pallas_interpret(rows, din, dout):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((rows, din)).astype(np.float32)
    qd = jq.quantize_kernel4(jnp.asarray(_kernel(7, din, dout)), 64)
    got = tqm.int4_matmul(*_t(x, qd["q"], qd["scale"]), 64).numpy()
    # the XLA reference: the same bf16 weights, f32 sums in another order
    ref = np.asarray(jqm.int4_matmul_reference(jnp.asarray(x), qd["q"], qd["scale"], 64))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the Pallas kernel folds the +8 bias and so rounds (w + 8)·s to bf16:
    # the JAX test's own limits (2e-2 of the max, median 2e-3)
    pallas = np.asarray(jqm.int4_matmul(jnp.asarray(x), qd["q"], qd["scale"], 64,
                                        interpret=True))
    err = np.abs(got - pallas) / np.abs(pallas).max()
    assert err.max() < 2e-2 and np.median(err) < 2e-3, (err.max(), np.median(err))


def test_dequantize_int4_is_what_the_jax_large_rows_route_multiplies_by():
    qd = jq.quantize_kernel4(jnp.asarray(_kernel(8, 128, 32)), 64)
    want = (np.asarray(jq.unpack_int4(qd["q"]), np.float32).reshape(2, 64, 32)
            * np.asarray(qd["scale"])[:, None, :]).reshape(128, 32)
    got = tqm.dequantize_int4(*_t(qd["q"], qd["scale"]), 64, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def _q8_case(seed, b, hkv, g, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv, g, d)).astype(np.float32)
    k8, ks = jqwen2.quantize_kv(jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32))
    v8, vs = jqwen2.quantize_kv(jnp.asarray(rng.standard_normal((b, hkv, s, d)), jnp.float32))
    return q, k8, v8, ks, vs


@pytest.mark.parametrize("b,hkv,g,s,d,lens", [
    pytest.param(2, 2, 7, 256, 32, [256, 77], id="g7-padded-to-8-row-shorter-than-cache"),
    pytest.param(1, 1, 4, 128, 64, [1], id="one-valid-position"),
])
def test_decode_q8_plain_matches_pallas_interpret(b, hkv, g, s, d, lens):
    """atol 1e-5 in f32: the same math, summed in another order."""
    q, k8, v8, ks, vs = _q8_case(9, b, hkv, g, s, d)
    lens = np.asarray(lens, np.int32)
    want = np.asarray(j_ragged_q8(
        jnp.asarray(q), k8, v8, ks, vs, jnp.asarray(lens), interpret=True))
    got = tda.ragged_decode_attention_q8(*_t(q, k8, v8, ks, vs, lens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # and through ops.attention.decode_attention, against the JAX entry point
    # as it runs off-TPU (dequantise, then plain attention)
    q4 = q.reshape(b, 1, hkv * g, d)
    want = np.asarray(j_decode_attention(
        jnp.asarray(q4), k8, v8, jnp.asarray(lens), k_scale=ks, v_scale=vs))
    got = t_attention.decode_attention(*_t(q4, k8, v8), torch.from_numpy(lens),
                                       k_scale=_t(ks)[0], v_scale=_t(vs)[0]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_decode_q8_plain_empty_row_gives_zero():
    """The port keeps its clamp on an empty row (the Pallas kernel returns the
    mean of V there; the main path never asks for one)."""
    q, k8, v8, ks, vs = _q8_case(10, 2, 1, 2, 128, 16)
    got = tda.ragged_decode_attention_q8_plain(
        *_t(q, k8, v8, ks, vs), torch.tensor([0, 5], dtype=torch.int32))
    assert float(got[0].abs().max()) == 0.0 and float(got[1].abs().max()) > 0.0


def _w8a8_params(seed, c, heads, mlp):
    """The parameter recipe of the JAX package's own W8A8 kernel test."""
    rng = np.random.default_rng(seed)
    hw = heads * (c // heads)
    nrm = lambda *s: rng.standard_normal(s).astype(np.float32)
    qk = lambda din, dout: (rng.integers(-127, 128, (din, dout)).astype(np.int8),
                            np.abs(0.02 * nrm(dout)) + 1e-4)
    wq, sq = qk(c, 3 * hw)
    wp, sp = qk(hw, c)
    w1, s1 = qk(c, mlp)
    w2, s2 = qk(mlp, c)
    return (1 + 0.1 * nrm(c), 0.1 * nrm(c), wq, sq, 0.1 * nrm(3 * hw), wp, sp, 0.1 * nrm(c),
            1 + 0.1 * nrm(c), 0.1 * nrm(c), w1, s1, 0.1 * nrm(mlp), w2, s2, 0.1 * nrm(c))


@pytest.mark.parametrize("n,s,c,heads", [(4, 64, 128, 2), (2, 128, 64, 4)])
def test_w8a8_plain_matches_reference_and_pallas_interpret(n, s, c, heads):
    # seed 21: inputs on which the Pallas kernel meets its own test's limits
    # against its reference. On most seeds its bf16 exp2 softmax flips one
    # re-quantise after the attention, which moves ~7 elements of this recipe
    # (random int8 weights: outputs of several hundred) by a step of ~20
    x = np.random.default_rng(21).standard_normal((n, s, c)).astype(np.float32)
    params = _w8a8_params(12, c, heads, 4 * c)
    jparams = tuple(jnp.asarray(p) for p in params)
    got = thb.fused_block_w8a8(torch.from_numpy(x), tuple(_t(*params)), heads, c // heads).numpy()
    # against the XLA reference: the same quantisation points from the same
    # f32 values; a value on a rounding boundary may still flip one int8 step
    # where the two frameworks' f32 sums differ in the last place, so the
    # bulk is held tight and every element to one quantisation step
    ref = np.asarray(jhb.w8a8_reference(jnp.asarray(x), jparams, heads, c // heads))
    close = np.abs(got - ref) <= 1e-4 + 1e-4 * np.abs(ref)
    assert close.mean() > 0.999, close.mean()
    np.testing.assert_allclose(got, ref, atol=2.0, rtol=5e-2)
    # against the Pallas kernel in interpret mode: the limits of the JAX test
    # of that kernel against its reference
    pallas = np.asarray(jhb.fused_block_w8a8(jnp.asarray(x), jparams, heads, c // heads,
                                             interpret=True))
    rel = np.abs(got - pallas) / (np.abs(pallas) + 1e-3)
    assert np.mean((np.abs(got - pallas) < 1e-3) | (rel < 1e-2)) > 0.999
    np.testing.assert_allclose(got, pallas, atol=2.0, rtol=5e-2)


# ---------------------------------------------------------------- modules --

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("rows", [1, 40])
def test_quant_linear_matches_jax_quant_dense(bits, rows):
    """Rows 1 (decode-shaped) and 40 (beyond the kernels' 32-row limit); on
    the CPU both take the dequantise-and-multiply route, as JAX does off-TPU.
    Limit 1e-5: f32 sums in another order."""
    din, dout = 128, 96
    w = _kernel(13, din, dout)
    bias = _kernel(14, dout)
    x = np.random.default_rng(15).standard_normal((rows, din)).astype(np.float32)
    qd = jq.quantize_kernel(jnp.asarray(w)) if bits == 8 else jq.quantize_kernel4(jnp.asarray(w))
    jparams = {"kernel_q": qd["q"], "kernel_scale": qd["scale"], "bias": jnp.asarray(bias)}
    dense = jqwen2.QuantDense(dout, use_bias=True, dtype=jnp.float32, bits=bits)
    want = np.asarray(dense.apply({"params": jparams}, jnp.asarray(x)))
    lin = tqwen2.QuantLinear(din, dout, True, torch.float32, bits=bits)
    with torch.no_grad():
        lin.kernel_q.copy_(_t(qd["q"])[0])
        lin.kernel_scale.copy_(_t(qd["scale"])[0])
        lin.bias.copy_(torch.from_numpy(bias))
    np.testing.assert_allclose(lin(torch.from_numpy(x)).numpy(), want, atol=1e-5, rtol=1e-5)
    # set_kernel quantises a float kernel to the same layer
    lin2 = tqwen2.QuantLinear(din, dout, False, torch.float32, bits=bits)
    lin2.set_kernel(torch.from_numpy(w))
    assert torch.equal(lin2.kernel_q, lin.kernel_q)


@pytest.fixture(scope="module", params=["int8", "int4"])
def quant_lms(request):
    """A JAX LM on parameters quantised by JAX, and the port's LM loaded
    from that tree."""
    quant = request.param
    jcfg = j_tiny_config().llm
    flm = jqwen2.Qwen2LM(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    fparams = flm.init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))["params"]
    qparams = jq.quantize_qwen2_params(fparams, bits=4 if quant == "int4" else 8)
    jlm = jqwen2.Qwen2LM(jcfg, dtype=jnp.float32, param_dtype=jnp.float32, quant=quant)
    lm = tqwen2.Qwen2LM(tiny_config().llm, dtype=torch.float32, quant=quant)
    load_qwen2(lm, _np(qparams))
    return quant, (jlm, qparams), lm.eval()


def test_quant_lm_logits_match_jax(quant_lms):
    """Limit 2e-4 on logits of magnitude ~1: f32 sums in another order
    through two layers."""
    _, (jlm, qparams), lm = quant_lms
    ids = np.random.default_rng(16).integers(3, 500, (2, 40)).astype(np.int32)
    want = np.asarray(jlm.apply({"params": qparams}, jnp.asarray(ids)))
    with torch.no_grad():
        x = lm.embed(torch.from_numpy(ids).long())
        pos = torch.arange(40).expand(2, 40)
        h, _ = lm.backbone(x, pos, None, None, None, "train")
        got = lm.logits(h).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_quant_greedy_generate_tokens_equal_jax(quant_lms, kv_quant):
    _, (jlm, qparams), lm = quant_lms
    rng = np.random.default_rng(17)
    embeds = rng.standard_normal((2, 24, 64)).astype(np.float32)
    lens = np.asarray([24, 17], np.int32)
    kw = dict(max_new_tokens=6, stop_ids=(2,), cache_max_len=32, vocab_size=512)
    want = jgen.greedy_generate(jlm, qparams, jnp.asarray(embeds), jnp.asarray(lens),
                                kv_quant=kv_quant, **kw)
    got = tgen.greedy_generate(lm, torch.from_numpy(embeds), torch.from_numpy(lens),
                               kv_quant=kv_quant, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.gen_lens.numpy(), np.asarray(want.gen_lens))
    np.testing.assert_allclose(got.hidden.numpy(), np.asarray(want.hidden), atol=2e-4, rtol=2e-4)


def test_make_kv_cache_quant_layout():
    cfg = tiny_config().llm
    cache = tqwen2.make_kv_cache(cfg, 2, 128, dtype=torch.float32, quant=True)
    want = jqwen2.make_kv_cache(j_tiny_config().llm, 2, 128, quant=True)
    assert set(cache) == set(want) == {"k", "v", "k_scale", "v_scale"}
    for name in cache:
        assert tuple(cache[name].shape) == tuple(want[name].shape)
    assert cache["k"].dtype == torch.int8 and cache["v_scale"].dtype == torch.float32


@pytest.fixture(scope="module")
def quant_towers():
    cfg = j_tiny_config().vision
    ftower = JSiglip(cfg, dtype=jnp.float32, param_dtype=jnp.float32)
    px = np.random.default_rng(18).standard_normal((2, 56, 56, 3)).astype(np.float32)
    qparams = jq.quantize_vision_params(
        ftower.init(jax.random.PRNGKey(3), jnp.asarray(px))["params"])
    jtower = JSiglip(cfg, dtype=jnp.float32, param_dtype=jnp.float32, quant=True)
    tower = SiglipVisionTower(tiny_config().vision, dtype=torch.float32, quant=True)
    load_siglip(tower, _np(qparams))
    with torch.no_grad():
        got = tower.eval()(torch.from_numpy(px)).numpy()
    return (jtower, qparams), px, got


def test_quant_siglip_tower_close_to_jax_unfused_branch(quant_towers):
    """Off-TPU the JAX tower takes its unfused ``W8A8Dense`` branch, which
    quantises from rounded LN outputs with another row formula: 5e-2, the
    limit of the JAX test that compares its two branches."""
    (jtower, qparams), px, got = quant_towers
    want = np.asarray(jtower.apply({"params": qparams}, jnp.asarray(px)))
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


def test_quant_siglip_tower_matches_jax_fused_route(quant_towers, monkeypatch):
    """The JAX tower on its fused route, with ``fused_block_w8a8`` patched to
    interpret mode from here as the JAX test does: the same quantisation
    points, so the bulk agrees to 1e-4 and every element within the JAX
    kernel test's one-step limits."""
    (jtower, qparams), px, got = quant_towers
    import ufvideo_tpu.models.siglip as sig

    real = jhb.fused_block_w8a8
    monkeypatch.setattr(
        jhb, "fused_block_w8a8",
        lambda x, p, h, d, interpret=False, **kw: real(x, p, h, d, interpret=True, **kw))
    monkeypatch.setattr(sig.jax, "default_backend", lambda: "tpu")
    want = np.asarray(jtower.apply({"params": qparams}, jnp.asarray(px)))
    close = np.abs(got - want) <= 1e-4 + 1e-4 * np.abs(want)
    assert close.mean() > 0.99, close.mean()
    np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)
