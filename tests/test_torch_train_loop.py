"""The port's training loop on the CPU: the dataset and ``Collator`` against
JAX's on one synthetic on-disk root, the grouped sample order against JAX's,
the ``Trainer`` (steps, the jsonl log, keep-N rotation, resume,
adapter-only artifacts, LoRA checkpoints), the checkpoint format, the
prefetch pipeline and the launcher in-process. Tiny configuration, random
weights; nothing is downloaded."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu.train import data as jdata
from ufvideo_tpu.train import trainer as jtrainer
from ufvideo_tpu_torch import rle
from ufvideo_tpu_torch.api import model_init
from ufvideo_tpu_torch.checkpoints import latest_checkpoint, load_params, save_params
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.train import data as pdata
from ufvideo_tpu_torch.train.__main__ import main as train_main
from ufvideo_tpu_torch.train.lora import LoRAConfig
from ufvideo_tpu_torch.train.prefetch import PrefetchLoader, device_prefetch, to_device
from ufvideo_tpu_torch.train.seg_step import SegBatch, make_seg_loss_fn
from ufvideo_tpu_torch.train.trainer import TrainConfig, Trainer, build_sample_order


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Four videos of six 40 × 56 frames: two [SEG] + <region> records with
    RLE annotations on two frames, a plain QA record, and one text-only."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.RandomState(0)
    records = []
    for vi in range(3):
        vdir = root / f"vid{vi}"
        vdir.mkdir()
        for fi in range(6):
            Image.fromarray(rng.randint(0, 255, (40, 56, 3), np.uint8)).save(
                vdir / f"{fi:03d}.jpg")
        mask = np.zeros((40, 56), np.uint8)
        mask[8 + vi:24, 10:30 + vi] = 1
        ann = {"1": {"segmentation": rle.encode(mask)},
               "4": {"segmentation": rle.encode(1 - mask)}}
        # short turns: the byte tokenizer spends a token a character, and the
        # tiny budget holds 128
        conv = ([{"from": "human", "value": "<video>\n<region>: segment."},
                 {"from": "gpt", "value": "Sure, [SEG]."}] if vi < 2 else
                [{"from": "human", "value": "What?\n<video>"},
                 {"from": "gpt", "value": "Nothing."}])
        records.append({"id": vi, "video": f"vid{vi}", "annotation": [ann],
                        "conversations": conv})
    records.append({"id": 3, "conversations": [
        {"from": "human", "value": "Say hi."}, {"from": "gpt", "value": "Hi there."}]})
    with open(root / "data.json", "w") as f:
        json.dump(records, f)
    return root


def _datasets(root):
    """Both packages' datasets on the root at the tiny budgets; the tower's
    size is SigLIP's 384, the size the JAX loaders always preprocess at (the
    port's take the configured one), and 338 video tokens need 512
    positions."""
    jtok, jids = j_byte_tokenizer()
    cfg = tiny_config()
    cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, image_size=384),
                      budget=dataclasses.replace(cfg.budget, max_seq_len=512))
    rt, _, tok = model_init(None, cfg=cfg, device="cpu")
    jcfg = j_tiny_config()
    jcfg = jcfg.replace(vision=dataclasses.replace(jcfg.vision, image_size=384),
                        budget=dataclasses.replace(jcfg.budget, max_seq_len=512),
                        region_token_id=jids.region, seg_token_id=jids.seg)
    jd = jdata.SupervisedVideoDataset([str(root / "data.json")], jtok, jcfg,
                                      video_root=str(root), seed=3)
    pd = pdata.SupervisedVideoDataset([str(root / "data.json")], tok, rt.cfg,
                                      video_root=str(root), seed=3)
    return (jd, jcfg, jids), (pd, rt, tok)


def test_dataset_and_collator_match_jax(root):
    """Every sample field and every collated array equal JAX's, the SAM
    frame draws and the region slots included."""
    (jd, jcfg, jids), (pd, rt, _) = _datasets(root)
    assert len(pd) == len(jd) == 4
    js = [jd[i] for i in range(len(jd))]
    ps = [pd[i] for i in range(len(pd))]
    for j, p in zip(js, ps):
        for field in ("input_ids", "labels", "ann_indices"):
            assert getattr(p, field) == getattr(j, field), field
        for field in ("video", "region_frames", "region_masks", "images_sam", "gt_masks"):
            a, b = getattr(p, field), getattr(j, field)
            assert (a is None) == (b is None), field
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=field)
    jb = jdata.Collator(jcfg, jids.region, jids.seg, loss_mask_size=32)(js[:2])
    pb = pdata.Collator(rt.cfg, rt.ids.region, rt.ids.seg, loss_mask_size=32)(ps[:2])
    assert sorted(jb) == sorted(pb)
    for k in jb:
        if k == "region_masks":  # the host grid resize sums in another order
            np.testing.assert_allclose(pb[k], jb[k], rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(pb[k], jb[k], err_msg=k)
    assert pb["obj_valid"].any() and pb["region_segments"].any()


def test_collator_nearest_resize_matches_the_rule():
    """Ground truth at another size goes to the batch's grid by the
    nearest-neighbour rule (floor(i · src / dst)) without cv2."""
    m = np.arange(35, dtype=np.float32).reshape(5, 7)
    got = pdata.resize_nearest(m, 3, 4)
    rows, cols = [0, 1, 3], [0, 1, 3, 5]
    np.testing.assert_array_equal(got, m[np.ix_(rows, cols)])
    assert pdata.resize_nearest(m, 5, 7) is m


@pytest.mark.parametrize("grouped", [True, False])
def test_sample_order_matches_jax(root, grouped):
    """``build_sample_order`` (grouped by modality and length, or a seeded
    permutation) and ``modality_length_groups`` equal JAX's."""
    (jd, _, _), (pd, _, _) = _datasets(root)
    jtc = jtrainer.TrainConfig(global_batch_size=2, group_by_modality_length=grouped, seed=4)
    ptc = TrainConfig(global_batch_size=2, group_by_modality_length=grouped, seed=4)
    assert [int(i) for i in build_sample_order(pd, ptc)] == \
        [int(i) for i in jtrainer.build_sample_order(jd, jtc)]
    lengths, mods = [5, 9, 2, 7, 3, 8, 1], [True, False, True, True, False, True, False]
    assert pdata.modality_length_groups(lengths, mods, 2, seed=1) == \
        jdata.modality_length_groups(lengths, mods, 2, seed=1)


def test_checkpoint_format_round_trips(tmp_path):
    """``save_params`` / ``load_params``: tensors (dtypes kept) and plain
    values, into a template in place; ``latest_checkpoint`` picks the
    highest step; a missing path raises."""
    tree = {"step": 7, "params": {"a": torch.randn(3, 2), "b": torch.arange(4)},
            "opt_state": {"count": 7, "mu": {"a": torch.randn(3, 2).bfloat16()}}}
    for step in (2, 10):
        save_params(str(tmp_path / f"checkpoint-{step}"), tree)
    (tmp_path / "checkpoint-x").mkdir()
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint-10")
    assert latest_checkpoint(str(tmp_path / "none")) is None
    plain = load_params(str(tmp_path / "checkpoint-10"))
    assert plain["step"] == 7 and plain["opt_state"]["mu"]["a"].dtype == torch.bfloat16
    tmpl = {"step": 0, "params": {"a": torch.zeros(3, 2), "b": torch.zeros(4, dtype=torch.int64)},
            "opt_state": {"count": 0, "mu": {"a": torch.zeros(3, 2, dtype=torch.bfloat16)}}}
    a = tmpl["params"]["a"]
    out = load_params(str(tmp_path / "checkpoint-10"), tmpl)
    assert out["params"]["a"] is a and torch.equal(a, tree["params"]["a"])
    assert out["step"] == 7 and torch.equal(tmpl["opt_state"]["mu"]["a"], tree["opt_state"]["mu"]["a"])
    with pytest.raises(KeyError):
        load_params(str(tmp_path / "checkpoint-10"), {"params": {"c": torch.zeros(1)}})


def _loader(root, rt, tok, tc):
    ds = pdata.SupervisedVideoDataset([str(root / "data.json")], tok, rt.cfg,
                                      video_root=str(root), seed=0)
    seg = [i for i in range(len(ds)) if "annotation" in ds.records[i]][:2]
    collator = pdata.Collator(rt.cfg, rt.ids.region, rt.ids.seg, loss_mask_size=32)
    loader = PrefetchLoader(seg * 4, ds.__getitem__, collator, batch_size=tc.global_batch_size)
    return device_prefetch(loader, lambda b: to_device(b, "cpu"))


@pytest.mark.parametrize("mode", ["policy", "adapters_only", "lora"])
def test_trainer_steps_rotates_resumes(root, tmp_path, mode):
    """Two Trainer steps through PrefetchLoader and device_prefetch: the log
    holds finite records of every metric; checkpoints rotate to the newest
    one; a fresh Trainer resumes at its step (adapter-only artifacts: the
    weights, step 0) and takes the next step from there; the towers stay
    frozen; adapter-only and LoRA runs write the reference's files;
    ``export_hf`` writes what ``model_init(model_path=)`` loads back."""
    rt, _, tok = model_init(None, cfg=tiny_config(), device="cpu")
    tc = TrainConfig(output_dir=str(tmp_path), learning_rate=1e-3, total_steps=4,
                     global_batch_size=2, save_steps=1, save_total_limit=1,
                     tune_adapters_only=mode == "adapters_only",
                     lora=LoRAConfig(r=4) if mode == "lora" else None)
    vision0 = rt.model.vision.layers[0].qkv_kernel.detach().clone()
    tr = Trainer(rt.model, rt.cfg, tc, loss_fn=make_seg_loss_fn())
    state = tr.train(tr.init_state(), _loader(root, rt, tok, tc), max_steps=2)
    assert state.step == 2
    recs = [json.loads(line) for line in open(tmp_path / "train_log.jsonl")]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert {"loss", "ce_loss", "mask_loss", "grad_norm"} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("checkpoint-")) == \
        ["checkpoint-2"]
    files = set(os.listdir(tmp_path / "checkpoint-2"))
    assert {"tensors.pt", "meta.json"} <= files
    if mode == "adapters_only":
        assert {"mm_projector.bin", "region_encoder.bin"} <= files
    if mode == "lora":
        assert {"adapter_config.json", "adapter_model.bin", "non_lora_trainables.bin"} <= files
    assert torch.equal(rt.model.vision.layers[0].qkv_kernel, vision0)

    proj = {n: p.detach().clone() for n, p in rt.model.projector.named_parameters()}
    rt2, _, _ = model_init(None, cfg=tiny_config(), device="cpu", seed=1)
    tr2 = Trainer(rt2.model, rt2.cfg, tc, loss_fn=make_seg_loss_fn())
    state2 = tr2.maybe_resume(tr2.init_state())
    for n, p in rt2.model.projector.named_parameters():
        assert torch.equal(p, proj[n]), n
    assert state2.step == (0 if mode == "adapters_only" else 2)
    if mode != "adapters_only":
        for n, t in state.params.items():
            assert torch.equal(state2.params[n], t.detach()), n
        assert state2.opt_state["count"] == 2
    state2 = tr2.train(state2, _loader(root, rt2, tok, tc), max_steps=state2.step + 1)
    assert np.isfinite(float(tr2.last_metrics["loss"]))
    if mode != "adapters_only":
        # the trained model (a LoRA run's adapters merged in) as a checkpoint
        # that model_init loads back as it is
        tr2.export_hf(state2, str(tmp_path / "hf"))
        rt3, _, _ = model_init(str(tmp_path / "hf"), cfg=tiny_config(), device="cpu")
        loaded = dict(rt3.model.named_parameters())
        for n, p in rt2.model.named_parameters():
            assert torch.equal(loaded[n], p.detach()), n


def test_killed_save_is_passed_over_on_resume(tmp_path, monkeypatch):
    """A save that dies mid-write leaves only ``checkpoint-{step}.tmp``: the
    newest whole checkpoint is the one resumed, and the next save clears the
    partial directory."""
    import ufvideo_tpu_torch.checkpoints as ckpts

    rt, _, _ = model_init(None, cfg=tiny_config(), device="cpu")
    tc = TrainConfig(output_dir=str(tmp_path), total_steps=4, save_total_limit=4)
    tr = Trainer(rt.model, rt.cfg, tc, loss_fn=make_seg_loss_fn())
    state = tr.init_state()
    state.step = 1
    tr.save(state)
    state.step = 2

    def killed(*args, **kwargs):
        raise KeyboardInterrupt("killed while writing")

    monkeypatch.setattr(ckpts.json, "dump", killed)
    with pytest.raises(KeyboardInterrupt):
        tr.save(state)
    monkeypatch.undo()
    assert (tmp_path / "checkpoint-2.tmp" / "tensors.pt").exists()
    assert not (tmp_path / "checkpoint-2").exists()
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint-1")
    rt2, _, _ = model_init(None, cfg=tiny_config(), device="cpu", seed=1)
    tr2 = Trainer(rt2.model, rt2.cfg, tc, loss_fn=make_seg_loss_fn())
    assert tr2.maybe_resume(tr2.init_state()).step == 1
    state.step = 3
    tr.save(state)
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("checkpoint-")) == \
        ["checkpoint-1", "checkpoint-3"]


def test_launcher_trains_one_step(root, tmp_path, capsys):
    """``python -m ufvideo_tpu_torch.train`` in-process on the tiny model:
    one step from the JSON root, a checkpoint, the final line; a mesh larger
    than the world (one process here) is refused naming both, and LoRA
    with a pipeline is refused."""
    out = tmp_path / "run"
    args = ["--tiny", "--device", "cpu", "--data-paths", str(root / "data.json"),
            "--video-root", str(root), "--output-dir", str(out), "--global-batch-size", "2",
            "--total-steps", "1", "--num-workers", "1"]
    assert train_main(args) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "rank 0 of 1 on cpu, unsharded" in lines
    assert lines[-1].startswith("done at step 1 ")
    assert latest_checkpoint(str(out)) == str(out / "checkpoint-1")
    for opt in ("--tp", "--pp"):
        with pytest.raises(SystemExit, match="needs 2 ranks; this run has a world of 1"):
            train_main(args + [opt, "2"])
    with pytest.raises(SystemExit):
        train_main(args + ["--pp", "2", "--lora"])
    assert "--lora trains on the dense stack" in capsys.readouterr().err
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_launcher_under_torchrun_matches_one_process(root, tmp_path, capsys):
    """``python -m torch.distributed.run --nproc_per_node 2 -m
    ufvideo_tpu_torch.train --fsdp 2`` over gloo: each rank collates its row
    of every global batch of 2 and the two steps' global losses are the
    one-process launcher's (within tests/test_multihost.py's 2e-5)."""
    import subprocess
    import sys

    records = json.loads((root / "data.json").read_text())[:2] * 2  # [SEG] batches only
    data = tmp_path / "seg.json"
    data.write_text(json.dumps(records))
    common = ["--tiny", "--device", "cpu", "--data-paths", str(data), "--video-root", str(root),
              "--global-batch-size", "2", "--total-steps", "2", "--num-workers", "1",
              "--save-steps", "2"]
    assert train_main(common + ["--output-dir", str(tmp_path / "one")]) == 0
    capsys.readouterr()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "ufvideo_tpu_torch.train", *common, "--fsdp", "2",
         "--output-dir", str(tmp_path / "two")],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "rank 0 of 2" in res.stdout and "rank 1 of 2" in res.stdout
    logs = {}
    for name in ("one", "two"):
        with open(tmp_path / name / "train_log.jsonl") as f:
            logs[name] = [json.loads(line) for line in f]
    assert [r["step"] for r in logs["two"]] == [1, 2]
    for a, b in zip(logs["two"], logs["one"]):
        for key in ("loss", "grad_norm"):
            assert abs(a[key] - b[key]) <= 2e-5 * max(abs(b[key]), 1.0), (key, a, b)
    assert latest_checkpoint(str(tmp_path / "two")) == str(tmp_path / "two" / "checkpoint-2")


def test_launcher_trains_one_lora_step(root, tmp_path, capsys):
    """``--lora``: one step of the reference's LoRA (r 8, alpha 16, dropout
    0.05, the forward-term step) and a checkpoint in PEFT's layout."""
    out = tmp_path / "run"
    args = ["--tiny", "--device", "cpu", "--data-paths", str(root / "data.json"),
            "--video-root", str(root), "--output-dir", str(out), "--global-batch-size", "2",
            "--total-steps", "1", "--num-workers", "1", "--lora"]
    assert train_main(args) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("done at step 1 ")
    ckpt = out / "checkpoint-1"
    assert {"adapter_config.json", "adapter_model.bin"} <= set(os.listdir(ckpt))
    acfg = json.loads((ckpt / "adapter_config.json").read_text())
    assert (acfg["r"], acfg["lora_alpha"], acfg["lora_dropout"]) == (8, 16.0, 0.05)


def test_to_device_builds_the_batch_kind():
    """A collated dict with a SAM branch becomes a ``SegBatch``, without one
    a ``Batch``, every field a tensor."""
    from ufvideo_tpu_torch.train.train_step import Batch

    base = {k: np.zeros((2, 3), np.int32) for k in
            ("text_ids", "src_kind", "src_idx", "labels")}
    base.update(pixels=np.zeros((2, 1, 4, 4, 3), np.float32), seq_lens=np.ones(2, np.int32))
    assert isinstance(to_device(base, "cpu"), Batch)
    seg = dict(base, images_sam=np.zeros((2, 1, 8, 8, 3), np.float32),
               gt_masks=np.zeros((2, 1, 1, 4, 4), np.float32), obj_valid=np.ones((2, 1), bool))
    b = to_device(seg, "cpu")
    assert isinstance(b, SegBatch) and b.region_frames is None
    assert all(torch.is_tensor(getattr(b, f)) for f in ("pixels", "images_sam", "obj_valid"))


def test_profile_trace_and_rank0_print(tmp_path, capsys):
    """``profile_trace`` writes a Chrome trace of its scope; ``rank0_print``
    prints without a process group; a disabled scope writes nothing."""
    from ufvideo_tpu_torch.utils.logging import profile_trace, rank0_print

    with profile_trace(str(tmp_path / "on")) as prof:
        torch.ones(8).sum()
    assert prof is not None and (tmp_path / "on" / "trace.json").stat().st_size > 0
    with profile_trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()
    rank0_print("step", 1)
    assert capsys.readouterr().out == "step 1\n"
