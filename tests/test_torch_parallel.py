"""The port's parallelism layer against the JAX package's, CPU, float32:
the partition rules and their arithmetic at full width (oracle
``tests/test_parallel.py``), and four gloo processes (oracle
``tests/test_multihost.py``) running the sharded [SEG] Trainer against the
JAX package's one-process step on the same global batch.

The four ranks are spawned once for the module (``torch_parallel_child.py``,
no JAX in them) while the parent computes JAX's side; the checks below read
what they wrote. The global batch holds four samples with 10, 14, 18 and 22
valid targets, so a rank's mean is not the global mean: the losses must
divide by counts summed over the data ranks (trouble 3 of the port's
sharding) to equal JAX's.

Tolerances: losses and grad norms within ``tests/test_multihost.py``'s
2e-5 relative; the parameters after three steps as
``tests/test_torch_train_step.py`` holds the one-process port (change norm
within 0.5%, each element within 2·lr); logits within
``tests/test_parallel.py``'s 1e-4.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.configs import UFVideoConfig as JUFVideoConfig
from ufvideo_tpu.models.qwen2 import Qwen2LM as JQwen2LM
from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.parallel import create_mesh as j_create_mesh
from ufvideo_tpu.parallel import partition as jpart
from ufvideo_tpu.train import data as jdata
from ufvideo_tpu.train import seg_step as jseg
from ufvideo_tpu.train import trainer as jtrainer
from ufvideo_tpu_torch.configs import UFVideoConfig
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.parallel import mesh as pmesh
from ufvideo_tpu_torch.parallel import partition as ppart
from ufvideo_tpu_torch.train import data as pdata
from ufvideo_tpu_torch.train import trainer as ptrainer
from ufvideo_tpu_torch.train.seg_step import SegBatch, segmentation_loss_fn
from ufvideo_tpu_torch.train.trainer import TrainConfig, Trainer

import torch_train_fixtures as fx
from test_torch_train_step import LR, PARAM_ATOL, PARAM_REL, TOTAL, WARMUP_RATIO, _jax_run, \
    _noise_only

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_child.py")
WORLD = 4
REL = 2e-5  # tests/test_multihost.py
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_parallel.py
# the conversations of the global batch: 10, 14, 18 and 22 valid targets
CONVS = [[{"from": "human", "value": "<video>\n<region>: segment it." + " x" * i},
          {"from": "gpt", "value": "It is [SEG]." + " y" * (2 * i)}] for i in range(4)]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(job: str, inp: dict, out: str):
    """Start the four ranks; returns the processes (wait with ``collect``)."""
    path = os.path.join(out, "input.pt")
    torch.save(inp, path)
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, CHILD, job, str(r), str(WORLD), port, path, out],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def collect(procs, job: str, out: str, timeout: float = 600.0):
    """Wait for the ranks; the first that fails (or the deadline) stops the
    others, which would otherwise wait on it in a collective."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = [p for p in procs if p.poll() not in (None, 0)]
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            break
        time.sleep(0.2)
    for p in procs:
        p.wait()
    # a rank that failed by itself first, then those stopped for it
    for r in sorted(range(WORLD), key=lambda r: procs[r].returncode == -9):
        with open(os.path.join(out, f"rank{r}.log")) as f:
            log = f.read()[-4000:]
        assert procs[r].returncode == 0, f"rank {r} rc={procs[r].returncode}:\n{log}"
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return torch.load(os.path.join(out, f"{job}.pt"), weights_only=False), ranks


def global_batch(jcfg, pcfg, jtok, tok, ids):
    """(JAX batch dict, port batch dict) of the four samples."""
    js, ps = [], []
    for i, conv in enumerate(CONVS):
        jid, jlab = jdata.preprocess_conversation(
            jdata.normalize_modal_token(conv, "<video>"), jtok, "<video>")
        pid, plab = pdata.preprocess_conversation(
            pdata.normalize_modal_token(conv, "<video>"), tok, "<video>")
        assert (jid, jlab) == (pid, plab)
        arrs = fx._arrays(i, jcfg)
        js.append(jdata.TrainSample(jid, jlab, **arrs))
        ps.append(pdata.TrainSample(pid, plab, **arrs))
    jb = jdata.Collator(jcfg, ids.region, ids.seg)(js)
    pb = pdata.Collator(pcfg, ids.region, ids.seg)(ps)
    for k in jb:
        np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
    return jb, pb


def _tc(out: str, **kw) -> TrainConfig:
    return TrainConfig(output_dir=out, learning_rate=LR, warmup_ratio=WARMUP_RATIO,
                       total_steps=TOTAL, global_batch_size=4, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parallel"))
    jcfg, pcfg, jtok, tok, ids = fx.micro_configs()
    params = fx.jax_params(jcfg)
    jb, pb = global_batch(jcfg, pcfg, jtok, tok, ids)
    assert list((pb["labels"][:, 1:] != -100).sum(1)) == [10, 14, 18, 22]
    state_dict = fx.port_model(pcfg, params).state_dict()
    # step 1 on one process, saved: rank group B resumes from it
    one = Trainer(fx.port_model(pcfg, params), pcfg, _tc(os.path.join(out, "w1"), save_steps=1),
                  loss_fn=segmentation_loss_fn)
    batch = fx.torch_batch(pb, SegBatch)
    one.train(one.init_state(), [batch], max_steps=1)
    tp_ids = np.random.default_rng(1).integers(3, pcfg.llm.vocab_size, (2, 12))
    inp = dict(cfg=pcfg, state_dict=state_dict, batch=pb, lr=LR, warmup_ratio=WARMUP_RATIO,
               total_steps=TOTAL, ckpt1=os.path.join(out, "w1", "checkpoint-1"), tp_ids=tp_ids)
    procs = spawn("parallel", inp, out)
    try:
        sam = JSAM2(jcfg.sam, dtype=jnp.float32, param_dtype=jnp.float32)
        jax_run = _jax_run(jcfg, params, jb, jseg.make_seg_loss_fn(sam), jseg.SegBatch)
        jlm = JQwen2LM(jcfg.llm, dtype=jnp.float32, param_dtype=jnp.float32)
        jlogits = np.asarray(jlm.apply({"params": params["llm"]}, jnp.asarray(tp_ids)))
        # the LoRA step on one process, on the same rows
        lora = Trainer(fx.port_model(pcfg, params), pcfg,
                       _tc(os.path.join(out, "lora1"), lora=ptrainer.LoRAConfig()),
                       loss_fn=segmentation_loss_fn)
        lora.train(lora.init_state(), [batch] * 2, max_steps=2)
        with open(os.path.join(out, "lora1", "train_log.jsonl")) as f:
            lora_log = [json.loads(line) for line in f]
    finally:
        res, ranks = collect(procs, "parallel", out)
    return dict(out=out, jcfg=jcfg, pcfg=pcfg, params=params, jax=jax_run, jlogits=jlogits,
                res=res, ranks=ranks, lora_log=lora_log, batch=batch)


# ------------------------------------------------------------- the rules --

def test_partition_specs_match_jax():
    """The tiny composite's tree (and SAM2's): every leaf's spec equals
    JAX's, right-aligned on the stacked layer axis."""
    jcfg, pcfg, *_ = fx.micro_configs()
    shapes = fx.jax_params(jcfg)
    for jrules, prules in ((jpart.DEFAULT_RULES, ppart.DEFAULT_RULES),
                           (jpart.pipeline_rules(), ppart.pipeline_rules())):
        jspecs = jax.tree_util.tree_leaves_with_path(
            jpart.partition_specs(shapes, jrules),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        pspecs = dict(ppart._walk(ppart.partition_specs(shapes, prules)))
        assert len(jspecs) == len(pspecs)
        for path, spec in jspecs:
            key = jpart._path_str(path)
            assert tuple(pspecs[key]) == tuple(spec), key
    stacked = ppart.partition_specs(shapes)["llm"]["layers"]["self_attn_qkv_proj"]["kernel"]
    assert stacked == ppart.P(None, "fsdp", "tensor")


@pytest.fixture(scope="module")
def full_width():
    """The JAX tree of the full model (SAM2 included) as shapes, and the
    port's ``jax_shapes`` of a full-width model on the meta device."""
    jcfg = JUFVideoConfig()
    jshapes = dict(jax.eval_shape(JUFVideoModel(jcfg).init_params, jax.random.PRNGKey(0)))
    sam = JSAM2(jcfg.sam, dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    size = jcfg.sam.hiera.image_size
    jshapes["sam"] = jax.eval_shape(
        lambda k: sam.init(k, jnp.zeros((1, size, size, 3)))["params"], jax.random.PRNGKey(0))
    pshapes = ppart.jax_shapes(UFVideoModel.empty(UFVideoConfig(), "meta"))
    return jshapes, pshapes


def test_jax_shapes_match_the_jax_tree(full_width):
    """``jax_shapes`` of the port's full model holds JAX's paths, dtypes and
    element counts (a 1x1 convolution the port holds as a Linear keeps its
    [in, out] shape: the same bytes and the same last dimension)."""
    jshapes, pshapes = full_width
    jleaves = {jpart._path_str(p): l for p, l in jax.tree_util.tree_leaves_with_path(jshapes)}
    pleaves = dict(ppart._walk(pshapes))
    assert sorted(jleaves) == sorted(pleaves)
    for path, leaf in jleaves.items():
        got = pleaves[path]
        assert np.dtype(leaf.dtype).itemsize == got.dtype.itemsize, path
        assert int(np.prod(leaf.shape)) == int(np.prod(got.shape)), path
        assert leaf.shape[-1:] == tuple(got.shape[-1:]), path
        if len(leaf.shape) == len(got.shape):
            assert tuple(leaf.shape) == tuple(got.shape), path


@pytest.mark.parametrize("layout", [(1, 8, 1), (1, 4, 2), (2, 2, 2)])
def test_audit_and_per_chip_bytes_match_jax(full_width, layout):
    """At Qwen2-7B / SigLIP / Hiera-L widths: the same audit findings and
    the same bytes a chip."""
    jshapes, pshapes = full_width
    devs = (jax.devices() * 8)[:8]
    jmesh = j_create_mesh(*layout, devices=devs[:int(np.prod(layout))])
    pm = pmesh.MeshShape(*layout)
    jfind = jpart.audit_shardings(jshapes, jmesh)
    pfind = ppart.audit_shardings(pshapes, pm)
    assert [(f["path"], f["reason"]) for f in pfind] == [(f["path"], f["reason"]) for f in jfind]
    assert ppart.per_chip_state_bytes(pshapes, pm) == jpart.per_chip_state_bytes(jshapes, jmesh)
    one = ppart.per_chip_state_bytes(pshapes, pmesh.MeshShape())
    assert ppart.per_chip_state_bytes(pshapes, pm) <= 0.4 * one


def test_lower_train_step_places_the_full_finetune_state(full_width):
    """``abstract_train_state`` of a 7B-width model on the meta device: the
    parameters and AdamW's two moments each take the rules' specs, nothing
    falls back, and a chip holds three times the parameters' bytes (plus the
    step counter)."""
    from ufvideo_tpu_torch.train.train_step import lower_train_step

    m = pmesh.MeshShape(1, 8, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        state, specs = lower_train_step(UFVideoModel.empty(UFVideoConfig(), "meta"), m)
    assert state["params"] == full_width[1]
    for tree in (specs["params"], specs["opt_state"]["mu"], specs["opt_state"]["nu"]):
        assert tree["llm"]["layers"]["self_attn_qkv_proj"]["kernel"] == ppart.P(
            None, "fsdp", "tensor")
    one = ppart.per_chip_state_bytes(state["params"], m)
    assert ppart.per_chip_state_bytes(state, m) == 3 * one + 4


def test_audit_flags_nondivisible_big_param():
    tree = {"llm": {"layers": {"mlp_gate_proj": {"kernel": ppart.ShapeDtype(
        (28, 2_000_002, 3), torch.bfloat16)}}}}
    findings = ppart.audit_shardings(tree, pmesh.MeshShape(1, 4, 2))
    assert len(findings) == 1 and findings[0]["reason"] == "divisibility fallback"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        spec = ppart.shardings_for(tree, pmesh.MeshShape(1, 4, 2))
    assert spec["llm"]["layers"]["mlp_gate_proj"]["kernel"] == ppart.P()
    assert any("falling back to replication" in str(x.message) for x in w)


def test_qkv_rank_order_groups_each_ranks_heads():
    order = ppart.qkv_rank_order(nq=8, nkv=4, tp=2).tolist()
    assert order == [0, 1, 2, 3, 8, 9, 12, 13, 4, 5, 6, 7, 10, 11, 14, 15]


# ------------------------------------------------------- the four ranks --

def test_ranks_meet_from_both_sets_of_variables(runs):
    """Ranks 0-1 read UFVIDEO_NUM_PROCESSES / _PROCESS_ID / _COORDINATOR,
    ranks 2-3 torchrun's RANK / WORLD_SIZE / MASTER_*: one gloo world of 4,
    and no JAX in any rank."""
    for r, rec in enumerate(runs["ranks"]):
        assert rec == {"distributed": True, "rank": r, "world": WORLD, "backend": "gloo",
                       "jax_imported": False}


def _close(got, want, what):
    assert abs(got - want) <= REL * max(abs(want), 1.0), (what, got, want)


@pytest.mark.parametrize("key", ["loss", "ce_loss", "mask_bce_loss", "mask_dice_loss",
                                 "grad_norm"])
def test_sharded_steps_match_jax(runs, key):
    """(data 2, fsdp 2, tensor 1) from step 1, and (1, 2, 2) resumed at step
    1 from a one-process checkpoint: every step's global metric is JAX's
    one-process one."""
    jm = runs["jax"][0]
    logs = {"A": runs["res"]["A"]["log"], "B": runs["res"]["B"]["log"]}
    assert [r["step"] for r in logs["A"]] == [1, 2, 3]
    assert [r["step"] for r in logs["B"]] == [2, 3]
    for name, log in logs.items():
        for rec in log:
            _close(rec[key], jm[rec["step"] - 1][key], f"{name} step {rec['step']} {key}")


@pytest.mark.parametrize("run", ["A", "B"])
def test_sharded_parameters_after_three_steps_match_jax(runs, run):
    """Every trained tensor after step 3, gathered in the unsharded order
    (B's fused qkv rows were reordered rank by rank for tensor parallelism)."""
    pcfg = runs["pcfg"]
    j = runs["jax"]
    want = fx.port_named(pcfg, j[2])
    start = fx.port_named(pcfg, runs["params"])
    noise = _noise_only(pcfg, j)
    got = runs["res"][run]["params"]
    assert got and set(got) <= set(want)
    for name, t in got.items():
        d_got, d_want = t - start[name], want[name] - start[name]
        if name not in noise:
            assert float((d_got - d_want).norm()) <= PARAM_REL * float(d_want.norm()), name
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)


def test_tensor_parallel_export_equals_a_one_process_export(runs):
    """``Trainer.export_hf`` at (1, 2, 2) writes what a one-process model
    holding the same trained tensors exports, tensor for tensor."""
    from ufvideo_tpu_torch.export import export_full_checkpoint

    model = fx.port_model(runs["pcfg"], runs["params"])
    with torch.no_grad():
        named = dict(model.named_parameters())
        for n, t in runs["res"]["B"]["params"].items():
            named[n].copy_(t)
    want = export_full_checkpoint(model, runs["pcfg"])
    got = torch.load(os.path.join(runs["out"], "B_export", "pytorch_model.bin"),
                     weights_only=True)
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert torch.equal(got[k], t), k


@pytest.mark.parametrize("run", ["A", "B"])
def test_only_rank_zero_keeps_the_gathered_state(runs, run):
    """Every rank joins a save's gathers; rank 0 alone keeps the whole
    tensors, the others hold none of them."""
    kept = runs["res"][run]["kept"]
    assert kept == [len(runs["res"][run]["params"]), 0, 0, 0]


def test_tensor_parallel_forward_matches_jax(runs):
    """The LLM's logits with heads, MLP and vocabulary split over 2 ranks
    (the fused qkv rows reordered rank by rank) against JAX's dense ones."""
    np.testing.assert_allclose(runs["res"]["tp_logits"].numpy(), runs["jlogits"], **LOGIT_TOL)


def test_world_four_checkpoint_resumes_on_one_process(runs):
    """Checkpoint-2 of the (2, 2, 1) run, whole tensors in the unsharded
    order, resumes on one process: step 3's loss is JAX's."""
    out = os.path.join(runs["out"], "resume1")
    shutil.copytree(os.path.join(runs["out"], "A", "checkpoint-2"),
                    os.path.join(out, "checkpoint-2"))
    pcfg = runs["pcfg"]
    tr = Trainer(fx.port_model(pcfg, runs["params"]), pcfg, _tc(out),
                 loss_fn=segmentation_loss_fn)
    state = tr.maybe_resume(tr.init_state())
    assert state.step == 2
    tr.train(state, [runs["batch"]], max_steps=3)
    with open(os.path.join(out, "train_log.jsonl")) as f:
        (rec,) = [json.loads(line) for line in f]
    for key in ("loss", "grad_norm"):
        _close(rec[key], runs["jax"][0][2][key], f"resumed step 3 {key}")


@pytest.mark.parametrize("key", ["loss", "grad_norm"])
def test_lora_sharded_step_matches_one_process(runs, key):
    """The LoRA step (dropout 0.05) at (2, 2, 1) against the same step on
    one process: each rank draws its rows of the global batch's masks."""
    got = runs["res"]["lora"]["log"]
    assert len(got) == len(runs["lora_log"]) == 2
    for g, w in zip(got, runs["lora_log"]):
        _close(g[key], w[key], f"lora step {g['step']} {key}")


@pytest.mark.parametrize("pc,gbs", [(2, 4), (4, 8), (1, 4), (2, 6)])
def test_shard_order_for_process_matches_jax(pc, gbs):
    order = list(np.random.default_rng(pc * gbs).permutation(29))
    for pid in range(pc):
        want = jtrainer.shard_order_for_process(order, gbs, process_id=pid, process_count=pc)
        assert ptrainer.shard_order_for_process(order, gbs, process_id=pid,
                                                process_count=pc) == want


def test_shard_order_refuses_an_uneven_batch():
    with pytest.raises(ValueError):
        ptrainer.shard_order_for_process(list(range(12)), 6, process_id=0, process_count=4)


@pytest.mark.parametrize("env,want", [
    ({"UFVIDEO_NUM_PROCESSES": "4", "UFVIDEO_PROCESS_ID": "2",
      "UFVIDEO_COORDINATOR": "10.0.0.1:1234"}, (4, 2, 4, "tcp://10.0.0.1:1234")),
    ({"RANK": "3", "WORLD_SIZE": "8", "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "h",
      "MASTER_PORT": "1"}, (8, 3, 4, "env://")),
    ({}, None),
])
def test_environment_sets_read(monkeypatch, env, want):
    for k in ("UFVIDEO_NUM_PROCESSES", "UFVIDEO_PROCESS_ID", "UFVIDEO_COORDINATOR",
              "UFVIDEO_DIST_AUTO", "RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert pmesh._env_world() == want


def test_nccl_world_larger_than_the_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="a world of 2 .* 1 visible card"):
        pmesh.check_world_fits(2, "cuda")
    pmesh.check_world_fits(1, "cuda")
    pmesh.check_world_fits(8, "cpu")
