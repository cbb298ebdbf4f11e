"""The port's ring attention against the JAX package's (oracle
``tests/test_ring_attention.py``), CPU, float32.

Four gloo ranks (``torch_parallel_child.py``, job ``ring``) each hold one
block of the sequence: the output and the gradients of ``sum(out ** 2)``
with respect to q, k and v, gathered over the ranks, against JAX's
``ring_attention`` on a 4-shard mesh and ``jax.grad`` through it; causal or
not, with padded keys, and with a batch row whose keys are all masked.
Then the CE train step with the sequence split over fsdp (a ring of 2) and
the batch over data, (data 2, fsdp 2, tensor 1), and the LoRA step (dropout
0.05) on that layout, against the one-process steps on the same global
batch.

Tolerances: JAX's own test's 1e-5 (the same f32 online softmax, another
order of sums); the step's loss and grad norm within 2e-5 relative
(``tests/test_multihost.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.ops.ring_attention import ring_attention as j_ring_attention
from ufvideo_tpu.parallel import create_mesh as j_create_mesh
from ufvideo_tpu_torch.ops.ring_attention import ring_attention, ring_attention_plain
from ufvideo_tpu_torch.train import train_step as pts
from ufvideo_tpu_torch.train.lora import LoRAConfig, make_lora_train_step

import torch_train_fixtures as fx
from test_torch_parallel import LR, REL, TOTAL, WARMUP_RATIO, collect, global_batch, spawn

B, S, HQ, HKV, D = 2, 32, 4, 2, 16
TOL = dict(atol=1e-5, rtol=1e-5)
# (causal, kv_lens): the second batch row of "masked_row" has no valid key
CASES = {"full": (False, None), "causal": (True, None), "kv_lens": (True, [23, 32]),
         "masked_row": (False, [19, 0])}


def _qkv():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((B, S, HQ, D)).astype(np.float32),
            rng.standard_normal((B, S, HKV, D)).astype(np.float32),
            rng.standard_normal((B, S, HKV, D)).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring"))
    q, k, v = _qkv()
    jcfg, pcfg, jtok, tok, ids = fx.micro_configs()
    params = fx.jax_params(jcfg)
    _, pb = global_batch(jcfg, pcfg, jtok, tok, ids)
    inp = dict(cfg=pcfg, state_dict=fx.port_model(pcfg, params).state_dict(), batch=pb, lr=LR,
               warmup_ratio=WARMUP_RATIO, total_steps=TOTAL, q=q, k=k, v=v, ring_cases=CASES)
    procs = spawn("ring", inp, out)
    try:
        mesh = j_create_mesh(dp=1, fsdp=4, tp=1, devices=jax.devices("cpu")[:4])
        want = {}
        for case, (causal, lens) in CASES.items():
            lens = None if lens is None else jnp.asarray(lens, jnp.int32)

            def loss(q, k, v, causal=causal, lens=lens):
                o = j_ring_attention(q, k, v, mesh, axis="fsdp", causal=causal, kv_lens=lens)
                return jnp.sum(o ** 2), o

            grad = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))
            (_, o), grads = grad(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            want[case] = [np.asarray(o)] + [np.asarray(g) for g in grads]
        # the CE step on one process, on the same global batch
        model = fx.port_model(pcfg, params)
        opt = pts.make_optimizer(LR, warmup_ratio=WARMUP_RATIO, total_steps=TOTAL)
        init, step = pts.make_train_step(model, opt)
        state = init(pts.apply_freeze(model, pts.freeze_mask(model)))
        batch = fx.torch_batch(pb, pts.Batch)
        dense = []
        for _ in range(3):
            state, m = step(state, batch)
            dense.append({k: float(v) for k, v in m.items()})
        model = fx.port_model(pcfg, params)
        init, step = make_lora_train_step(model, opt, LoRAConfig())
        state = init(torch.Generator().manual_seed(0))
        dense_lora = []
        for _ in range(2):
            state, m = step(state, batch)
            dense_lora.append({k: float(v) for k, v in m.items()})
    finally:
        res, _ = collect(procs, "ring", out)
    return res, want, {"ring_step": dense, "ring_lora_step": dense_lora}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("part", ["out", "dq", "dk", "dv"])
def test_ring_attention_matches_jax(runs, case, part):
    res, want, _ = runs
    i = ["out", "dq", "dk", "dv"].index(part)
    np.testing.assert_allclose(res[case][i].numpy(), want[case][i], **TOL, err_msg=case)


def test_fully_masked_row_is_zero_and_passes_no_gradient(runs):
    res, _, _ = runs
    out, dq, dk, dv = (t.numpy() for t in res["masked_row"])
    assert not out[1].any() and not dq[1].any() and not dk[1].any() and not dv[1].any()
    assert out[0].any()


@pytest.mark.parametrize("case", list(CASES))
def test_one_rank_ring_is_the_plain_attention(case):
    """On one rank (no mesh) the ring is one block: the plain masked
    attention, forward and backward (the card checks this at 7B's shape)."""
    causal, lens = CASES[case]
    lens = None if lens is None else torch.tensor(lens)
    ins = [torch.from_numpy(x).requires_grad_(True) for x in _qkv()]
    ref = [torch.from_numpy(x).requires_grad_(True) for x in _qkv()]
    o = ring_attention(*ins, None, causal=causal, kv_lens=lens)
    p = ring_attention_plain(*ref, causal=causal, kv_lens=lens)
    torch.testing.assert_close(o, p, **TOL)
    (o ** 2).sum().backward()
    (p ** 2).sum().backward()
    for a, b in zip(ins, ref):
        torch.testing.assert_close(a.grad, b.grad, **TOL)


@pytest.mark.parametrize("key", ["loss", "ce_loss", "grad_norm"])
def test_ring_train_step_matches_one_process(runs, key):
    """Each rank runs its rows' block of positions (global RoPE positions,
    global ``kv_lens``, targets shifted before the split): three steps equal
    the one-process step's."""
    res, _, dense = runs
    got, want = res["ring_step"], dense["ring_step"]
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g[key] - w[key]) <= REL * max(abs(w[key]), 1.0), (i, key, g[key], w[key])


@pytest.mark.parametrize("key", ["loss", "grad_norm"])
def test_ring_lora_step_matches_one_process(runs, key):
    """LoRA with dropout under ring: each rank's dropout mask is its rows and
    its block of positions of the one-process mask, so two steps equal the
    one-process LoRA step's (B starts at zero: step 1's gradient and step
    2's loss see the masks)."""
    res, _, dense = runs
    got, want = res["ring_lora_step"], dense["ring_lora_step"]
    assert len(got) == len(want) == 2
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g[key] - w[key]) <= REL * max(abs(w[key]), 1.0), (i, key, g[key], w[key])


def test_ring_refuses_a_sequence_that_does_not_split():
    from ufvideo_tpu_torch.configs import tiny_config
    from ufvideo_tpu_torch.models.qwen2 import Qwen2LM

    class Axis:  # a 3-rank axis, no process group needed to refuse
        mesh_dim_names = ("fsdp",)

        def size(self, dim):
            return 3

        def get_local_rank(self, axis):
            return 0

    lm = Qwen2LM(tiny_config().llm, dtype=torch.float32)
    lm.set_ring(Axis(), "fsdp")
    with pytest.raises(ValueError, match="does not divide"):
        lm.seq_block(torch.zeros(1, 8, 4))
