"""The port's launchers against the JAX package's: ``python -m
ufvideo_tpu_torch.loadtest`` through ``tests/test_loadtest.py``'s two cases
(the engine with speculation, and the zero-LLM upper bracket of its
acceptance, labelled synthetic), and ``python -m ufvideo_tpu_torch.serve
--engine`` answering HTTP with JAX ``mm_infer``'s text on the same weights.
Both run on the CPU (``--device cpu``) with random tiny weights.

Tolerances: counts as ``tests/test_loadtest.py`` states them; text exactly.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import urllib.request

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("zero_llm", [False, True])
def test_loadtest_tiny_engine_spec(zero_llm):
    cmd = [sys.executable, "-m", "ufvideo_tpu_torch.loadtest", "--tiny", "--device", "cpu",
           "--mode", "engine", "--spec", "2", "--clients", "2", "--requests", "4",
           "--max-new", "12"]
    if zero_llm:
        cmd.append("--zero-llm")
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["completed"] == 4 and rec["errors"] == 0, rec
    spec = rec["backend_stats"]["spec"]
    assert spec["drafted"] > 0
    # a synthetic run never carries the plain name
    assert rec["zero_llm"] is zero_llm
    assert rec["name"] == ("serve_loadtest_zero_llm" if zero_llm else "serve_loadtest")
    if zero_llm:
        # constant logits: once the constant token is in the lookup window
        # every draft verifies
        assert spec["accepted"] >= 0.8 * spec["drafted"], spec


# The serve launcher in a child interpreter, run as ``python -m`` runs it
# (runpy, as __main__), with ``model_init`` wrapped to load the JAX tree the
# test saved: the child imports no JAX.
_CHILD = textwrap.dedent("""
    import runpy, sys
    import numpy as np
    from ufvideo_tpu_torch import api, weights

    flat = np.load(sys.argv[1])
    tree = {}
    for key in flat.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    real = api.model_init

    def model_init(*a, **k):
        rt, proc, tok = real(*a, **k)
        weights.load_jax_params(rt.model, tree)
        return rt, proc, tok

    api.model_init = model_init
    sys.argv = ["ufvideo_tpu_torch.serve"] + sys.argv[2:]
    runpy.run_module("ufvideo_tpu_torch.serve", run_name="__main__", alter_sys=True)
""")


def test_serve_launcher_engine_answers_as_jax(tmp_path):
    from ufvideo_tpu.api import UFVideoRuntime as JRuntime
    from ufvideo_tpu.api import mm_infer as j_mm_infer
    from ufvideo_tpu.configs import tiny_config as j_tiny_config
    from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
    from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
    from ufvideo_tpu_torch.serve import np_to_b64

    jtok, jids = j_byte_tokenizer()
    jcfg = j_tiny_config().replace(region_token_id=jids.region, seg_token_id=jids.seg,
                                   temporal_token_start_id=jids.temporal_start)
    params = jax.tree.map(np.asarray, dict(jax.jit(JUFVideoModel(jcfg).init_params)(
        jax.random.PRNGKey(2))))
    flat = {"/".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    np.savez(tmp_path / "params.npz", **flat)
    frames = np.random.default_rng(8).standard_normal((4, 56, 56, 3)).astype(np.float32)
    want, _ = j_mm_infer(frames, "What happens here?", JRuntime(jcfg, params, jids), jtok,
                         max_new_tokens=6)

    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(tmp_path / "params.npz"), "--tiny", "--device",
         "cpu", "--quant", "none", "--engine", "--port", "0", "--max-new-cap", "16"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        line = child.stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:") and "(engine," in line, (
            line, child.stderr.read() if child.poll() is not None else "")
        port = int(line.split()[2].rsplit(":", 1)[1])
        body = json.dumps({"instruct": "What happens here?", "video_b64": np_to_b64(frames),
                           "max_new_tokens": 6}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            got = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
        child.send_signal(signal.SIGINT)
        out, err = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.communicate()
    assert got["text"] == want and got["pred_masks_rle"] == []
    assert stats["admissions"] == stats["completed"] == 1 and stats["errors"] == 0
    assert child.returncode == 0, err[-2000:]
    assert out.strip().endswith("server stopped")
