"""The port's benchmark runner (``ufvideo_tpu_torch.eval.run``) against
``ufvideo_tpu.eval.run`` on the CPU.

Runner parity: both packages' ``run_benchmark`` run every benchmark over the same files with
``mm_infer`` / ``mm_infer_batch`` replaced, in each, by the same
deterministic stub (text and masks derived from a digest of the call's
inputs, so any difference in the samples shows; the first batch call and
the third single call fail, so the per-sample fallback and a dropped sample
run too): the JSONL rows and the mask PNGs must be equal. The configuration
each ``--quant`` / ``--kv-quant`` / ``--prefill-chunk`` / ``--spec-decode``
combination builds is JAX's. End to end: a tiny runtime of each package on
the same weights (``load_jax_params``) through both ``run_benchmark``: mvbench at
``--batch 1`` (greedy text exactly) and mevis at ``--batch 2`` (masks bit for
bit outside the logit band of ``tests/test_torch_seg.py``), two samples
each, on a JAX tree from ``jax.eval_shape`` filled by numpy
(``tests/torch_train_fixtures.py``: no initialiser compile). Then
``eval_smoke`` on the CPU. Torch runs on one thread here: the shapes are
tiny, and the suite's workers share the machine's cores.
"""

import dataclasses
import hashlib
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_seg import BAND, _logits_at_label_size, _with_ids
from torch_train_fixtures import _fill, port_model
from ufvideo_tpu import rle as jrle
from ufvideo_tpu.api import UFVideoRuntime as JRuntime
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.eval import run as jrun
from ufvideo_tpu.eval import util as ju
from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu_torch.api import UFVideoRuntime, _assemble_input_ids, _encode_video_input
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.eval import run
from ufvideo_tpu_torch.eval import util as u
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids

N_VIDEOS = 5
N_END_TO_END = 2
H = W = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Five cv2-written frame directories and the question files of every
    benchmark (the schemas of tests/test_eval_roundtrip.py)."""
    root = tmp_path_factory.mktemp("evalrun")
    rng = np.random.default_rng(0)
    for v in range(N_VIDEOS):
        d = root / "videos" / f"vid{v}"
        d.mkdir(parents=True)
        for f in range(6):
            cv2.imwrite(str(d / f"{f:03d}.png"), rng.integers(0, 255, (H, W, 3), np.uint8))

    def region(v):
        mask = np.zeros((H, W), np.uint8)
        mask[10 + v:30 + v, 12:40] = 1
        return [{"1": {"segmentation": jrle.encode(mask)}, "3": {"segmentation": jrle.encode(mask)}}]

    files = {
        "seg": [{"id": f"s{v}", "video": f"vid{v}", "annotation": region(v), "frame_idx": 1,
                 "caption": f"object in video {v}",
                 "conversations": [[{"from": "human", "value": "Describe <region>."}]]}
                for v in range(N_VIDEOS)],
        "hqa": [{"id": f"s{v}", "video": f"vid{v}", "annotation": region(v), "frame_idx": [1, 3],
                 "caption": f"at {{<TEMP-010>, <TEMP-060>}}. object in video {v}",
                 "conversations": [[{"from": "human", "value": "<video>\nDescribe the scene."},
                                    {"from": "gpt", "value": "at {<TEMP-010>, <TEMP-060>}. x"}]]}
                for v in range(N_VIDEOS)],
        "q": [{"id": f"s{v}", "video": f"vid{v}", "annotation": region(v), "frame_idx": 1,
               "Question": "What is the object <region> doing?",
               "options": ["(A) running", "(B) sitting", "(C) flying"],
               "Answer": "(B) sitting", "type": "Basic Questions"} for v in range(N_VIDEOS)],
        "mevis": [{"id": f"m{v}", "video": f"vid{v}", "conversations": [
            {"from": "human", "value": "<video>\nSegment the moving object."},
            {"from": "gpt", "value": "Sure, it is [SEG]."}]} for v in range(N_VIDEOS)],
        "mcqa": [{"id": f"q{v}", "task_type": "action", "data": {
            "video": f"vid{v}", "question": "What color dominates?",
            "candidates": ["red", "green"], "answer": "red"}} for v in range(N_VIDEOS)],
        "tvg": [{"id": f"t{v}", "video": f"vid{v}", "query": "a thing happens",
                 "timestamps": [0.2, 0.6]} for v in range(N_VIDEOS)],
    }
    files["mcqa_e2e"] = files["mcqa"][:N_END_TO_END]
    files["mevis_e2e"] = files["mevis"][:N_END_TO_END]
    for name, obj in files.items():
        (root / f"{name}.json").write_text(json.dumps(obj))
    return root


def _digest(*parts) -> int:
    h = hashlib.sha1()
    for p in parts:
        if p is not None and hasattr(p, "shape"):
            a = np.ascontiguousarray(np.asarray(p))
            h.update(f"{a.dtype}{a.shape}".encode() + a.tobytes())
        else:
            h.update(json.dumps(p, sort_keys=True, default=str).encode())
    return int(h.hexdigest()[:12], 16)


class Stub:
    """``mm_infer`` / ``mm_infer_batch`` of either package, derived from the
    inputs: the text carries a letter, a temporal span and the segmentation
    boilerplate (what the emit rules cut); masks [T, H, W] from a seed for
    ``[SEG]``-input calls and for every other call with SAM frames whose
    digest is odd. The first batch call and the third single call raise."""

    def __init__(self):
        self.singles = self.batches = 0

    def _one(self, video, instruct, masks=None, ann_indices=None, frame=None, choice=1,
             images_sam=None, label_size=None, seg=False, **kw):
        d = _digest(video, instruct, masks, ann_indices, frame, choice, images_sam, label_size,
                    kw.get("max_new_tokens"))
        path_b = choice == 3 and "[SEG]" in json.dumps(instruct)
        pred_masks = []
        if images_sam is not None and (path_b or d % 2):
            rng = np.random.default_rng(d)
            pred_masks = [rng.random((len(images_sam),) + tuple(label_size)) < 0.3]
        if path_b:
            return None, {"output": None, "pred_masks": pred_masks, "gt_masks": masks}
        text = (f"({'ABC'[d % 3]}) answer {d % 97}. at {{<TEMP-{d % 50:03d}>, "
                f"<TEMP-{50 + d % 40:03d}>}}. The segmentation mask is [SEG].")
        return text, {"output": [d % 7, d % 11], "pred_masks": pred_masks}

    def mm_infer(self, video, instruct, model, tokenizer, modal="video", seg=False, **kw):
        assert model.stub and modal == "video"
        self.singles += 1
        if self.singles == 3:
            raise RuntimeError("the stub's third single call fails")
        text, out = self._one(video, instruct, seg=seg, **kw)
        return out if seg or text is None else (text, out)

    def mm_infer_batch(self, samples, model, tokenizer, modal="video", choice=1, **kw):
        assert model.stub and modal == "video"
        self.batches += 1
        if self.batches == 1:
            raise RuntimeError("the stub's first batch call fails")
        return [self._one(s["video"], s["instruct"], masks=s.get("masks"),
                          ann_indices=s.get("ann_indices"), frame=s.get("frame"), choice=choice,
                          images_sam=s.get("images_sam"), label_size=s.get("label_size"), **kw)
                for s in samples]


class _StubModel:
    stub = True

    class cfg:
        class vision:
            image_size = 56

        class sam:
            class hiera:
                image_size = 128


BENCHES = [("pixrqa", "seg", None), ("pixhqa", "hqa", None), ("pixtrqa", "hqa", None),
           ("videorefer_d", "seg", "single"), ("videorefer_d", "seg", "multi"),
           ("videorefer_q", "q", "single"), ("videorefer_q", "q", "multi"),
           ("mevis", "mevis", None), ("mvbench", "mcqa", None), ("tvg", "tvg", None)]


def _drive(mod, argv, runtime, monkeypatch, ranks=2):
    stub = Stub()
    monkeypatch.setattr(mod, "mm_infer", stub.mm_infer)
    monkeypatch.setattr(mod, "mm_infer_batch", stub.mm_infer_batch)
    args = mod.build_parser().parse_args(argv)
    for rank in range(ranks):
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", str(ranks))
        mod.run_benchmark(args, runtime=runtime)


def _mask_dirs(out):
    root = os.path.splitext(out)[0] + "_masks"
    if not os.path.isdir(root):
        return {}
    return {d: sorted(os.listdir(os.path.join(root, d))) for d in sorted(os.listdir(root))}


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("bench,qfile,mode", BENCHES,
                         ids=[f"{b}-{m}" if m else b for b, _, m in BENCHES])
def test_run_benchmark_rows_and_masks_equal_jax(data, tmp_path, monkeypatch, bench, qfile, mode,
                                          batch, capsys):
    outs = {}
    before = dict(run.FAILURES)
    for name, mod in (("port", run), ("jax", jrun)):
        out = str(tmp_path / name / f"{bench}.json")
        argv = ["--benchmark", bench, "--video-folder", str(data / "videos"),
                "--question-file", str(data / f"{qfile}.json"), "--output", out,
                "--num-chunks", "2", "--num-frames", "4", "--num-sam-frames", "3",
                "--max-new-tokens", "5", "--batch", str(batch)]
        _drive(mod, argv + (["--mode", mode] if mode else []),
               (_StubModel(), None, None), monkeypatch)
        outs[name] = out
    got, want = u.read_all_ranks(outs["port"]), ju.read_all_ranks(outs["jax"])
    assert got == want
    # rank 0: s0 s1 s2 (its third single call fails), rank 1: s3 s4
    assert len(got) == N_VIDEOS - 1
    failures = {k: run.FAILURES[k] - before.get(k, 0) for k in run.FAILURES}
    assert {k: n for k, n in failures.items() if n} == (
        {"batch": 1, "sample": 1} if batch == 2 else {"sample": 1})
    assert capsys.readouterr().err.count("Traceback") == sum(failures.values()) * 2
    dirs = _mask_dirs(outs["port"])
    assert dirs == _mask_dirs(outs["jax"])
    if bench in ("mevis", "pixrqa", "pixhqa", "pixtrqa", "videorefer_d", "videorefer_q"):
        assert dirs, "no sample wrote masks: the comparison says nothing"
    for sid in dirs:
        a = u.load_mask_pngs(os.path.splitext(outs["port"])[0] + "_masks", sid)
        b = ju.load_mask_pngs(os.path.splitext(outs["jax"])[0] + "_masks", sid)
        assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


COMBOS = [(q, kv, pc, sd) for q in ("", "int8", "int4") for kv in (False, True)
          for pc in (0, 3) for sd in (0, 4)]


@pytest.mark.parametrize("quant,kv,chunk,spec", COMBOS)
def test_serving_flags_build_jax_config(tmp_path, monkeypatch, quant, kv, chunk, spec):
    """``run_benchmark`` without a runtime asks ``model_init`` for the
    configuration JAX's asks for; the port's on this rank's card unless
    ``--device`` says otherwise."""
    seen = {}

    class Built(Exception):
        pass

    def capture(name):
        def model_init(path, cfg=None, device=None, **kw):
            seen[name] = (cfg, device, path, kw)
            raise Built
        return model_init

    monkeypatch.setattr(run, "model_init", capture("port"))
    monkeypatch.setattr(jrun, "model_init", capture("jax"))
    argv = ["--benchmark", "mvbench", "--video-folder", "v", "--question-file", "q.json",
            "--output", str(tmp_path / "o.json"), "--sam-path", "s.pt"]
    argv += (["--quant", quant] if quant else []) + (["--kv-quant"] if kv else [])
    argv += ["--prefill-chunk", str(chunk), "--spec-decode", str(spec)]
    monkeypatch.setenv("LOCAL_RANK", "1")
    for mod in (run, jrun):
        with pytest.raises(Built):
            mod.run_benchmark(mod.build_parser().parse_args(argv))
    (cfg, device, path, kw), (jcfg, _, jpath, jkw) = seen["port"], seen["jax"]
    assert device == "cuda:1" and path == jpath and kw == jkw
    if jcfg is None:
        assert cfg is None and not (quant or kv or chunk or spec)
        return
    for f in ("quant_llm", "quant_kv", "prefill_chunk", "spec_decode"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg == type(cfg)(**{f: getattr(jcfg, f) for f in
                               ("quant_llm", "quant_kv", "prefill_chunk", "spec_decode")})
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(Built):
        run.run_benchmark(run.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert seen["port"][1] == "cpu"
    assert run.rank_device("cuda") == "cuda"


@pytest.fixture(scope="module")
def runtimes():
    """A JAX tiny runtime and the port's on its weights, with the eval
    text budget (the byte tokenizer spends a token a character)."""
    budget = lambda c: c.replace(budget=dataclasses.replace(c.budget, max_seq_len=512,
                                                            max_text_len=384))
    jtok, jids = j_byte_tokenizer()
    jcfg = budget(_with_ids(j_tiny_config(), jids))
    sam = JSAM2(jcfg.sam, dtype=jnp.float32, param_dtype=jnp.float32)
    size = jcfg.sam.hiera.image_size
    shapes = dict(jax.eval_shape(JUFVideoModel(jcfg).init_params, jax.random.PRNGKey(0)))
    shapes["sam"] = jax.eval_shape(
        lambda k: sam.init(k, jnp.zeros((1, size, size, 3)))["params"], jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(0)), shapes)
    tok, ids = byte_tokenizer_with_ids()
    cfg = budget(_with_ids(tiny_config(), ids))
    jrt = JRuntime(jcfg, jax.tree.map(jnp.asarray, params), jids)
    return (jrt, None, jtok), (UFVideoRuntime(cfg, port_model(cfg, params), ids, "cpu"), None, tok)


def _run_both(runtimes, data, tmp_path, bench, qfile, batch, monkeypatch):
    outs = {}
    for (name, mod), rt in zip((("port", run), ("jax", jrun)), (runtimes[1], runtimes[0])):
        out = str(tmp_path / name / f"{bench}.json")
        monkeypatch.delenv("RANK", raising=False)
        args = mod.build_parser().parse_args([
            "--benchmark", bench, "--video-folder", str(data / "videos"),
            "--question-file", str(data / f"{qfile}.json"), "--output", out,
            "--num-frames", "4", "--max-new-tokens", "8", "--batch", str(batch)])
        mod.run_benchmark(args, runtime=rt)
        outs[name] = out
    return outs


def test_mvbench_end_to_end_equals_jax(runtimes, data, tmp_path, monkeypatch):
    before = sum(run.FAILURES.values())
    outs = _run_both(runtimes, data, tmp_path, "mvbench", "mcqa_e2e", 1, monkeypatch)
    got, want = u.read_all_ranks(outs["port"]), ju.read_all_ranks(outs["jax"])
    assert len(got) == N_END_TO_END and sum(run.FAILURES.values()) == before
    assert got == want  # the greedy text ("raw") exactly, hence the letter
    assert all(r["raw"] for r in got)


def test_mevis_batch_end_to_end_masks_equal_jax(runtimes, data, tmp_path, monkeypatch):
    """mevis (a [SEG] in the input) at --batch 2: every sample's mask PNGs
    equal JAX's wherever the port's upsampled logit lies outside the band
    around the threshold; the band holds under 1% of the pixels."""
    before = sum(run.FAILURES.values())
    outs = _run_both(runtimes, data, tmp_path, "mevis", "mevis_e2e", 2, monkeypatch)
    assert sum(run.FAILURES.values()) == before
    assert u.read_all_ranks(outs["port"]) == ju.read_all_ranks(outs["jax"])
    rt, _, tok = runtimes[1]
    with open(data / "mevis_e2e.json") as f:
        questions = json.load(f)
    ds = run.SegReferBenchmark(str(data / "videos"), questions, num_frames=4, image_size=56,
                               sam_image_size=128)
    shares = []
    for i, q in enumerate(questions):
        got = np.stack(u.load_mask_pngs(os.path.splitext(outs["port"])[0] + "_masks", q["id"]))
        want = np.stack(ju.load_mask_pngs(os.path.splitext(outs["jax"])[0] + "_masks", q["id"]))
        s = ds[i]
        ids = _assemble_input_ids(q["conversations"], 3, "<video>", tok)
        with torch.no_grad():
            hidden, plan = rt.forward_hidden_states(ids, _encode_video_input(rt, s["video"],
                                                                             "video"))
            pos = [int(plan.text_pos_map[0][t]) - 1 for t, x in enumerate(ids) if x == rt.ids.seg]
            logits = _logits_at_label_size(rt, hidden[0, pos], s["images_sam"], (H, W))[0]
        band = np.abs(logits) < BAND
        assert got.shape == want.shape == logits.shape == (4, H, W)
        assert (got == want)[~band].all() and band.mean() < 0.01
        shares.append(float(want.mean()))
    print(f"foreground shares {shares}")
    assert 0.0 < np.mean(shares) < 1.0  # the masks say something


def test_eval_smoke_on_the_cpu(capsys):
    from ufvideo_tpu_torch import eval_smoke

    out = eval_smoke.main(["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out and out["eval_smoke"] == "ok"
    assert out["mvbench_records"] == out["mevis_records"] == 2 and out["device"] == "cpu"
