"""Shared pieces of the benchmark's CPU tests: the repository's root on the
path, and a small cell (the tiny configuration, 4 frames of 40x52, short
questions) that drives the harness on the CPU."""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_FRAMES = [4, 40, 52, 3]
# the cells' traffic at the tiny budget
TINY_TRAFFIC = {"frames": TINY_FRAMES, "question_bytes": [10, 30], "stratum": 8, "clients": 4,
                "answer_tokens": {"dist": "uniform", "low": 4, "high": 8}}


def tiny_model(quant: bool = False) -> dict:
    from ufvideo_tpu_torch.configs import tiny_config

    from benchmark.port import config_dict

    m = config_dict(tiny_config())
    if quant:
        m.update(quant_llm="int8", quant_kv=True, quant_vision=True)
    return m


def tiny_spec(workload: str, limit: float = 1e-4, sample: int = 4):
    """A Spec of the named cell with the tiny configuration in place of the
    cell's (its quantisation and control kept), its traffic at the tiny
    budget, and a limit for float32."""
    from benchmark import harness

    sp = harness.spec(workload, json.load(open(os.path.join(ROOT, "BENCHMARK.json"))))
    model = dict(tiny_model(), **{k: sp.config["model"][k]
                                  for k in ("quant_llm", "quant_kv", "quant_vision")})
    params = dict(sp.params, **TINY_TRAFFIC)
    tiny_cell = {"engine": {"max_slots": 4, "max_new_cap": 16}, "traffic": {},
                 "check": {"sample": sample, "logit_gap": limit}}
    return harness.Spec(sp.workload, tiny_cell, {"model": model, "control": sp.config["control"]},
                        params, sp.end_to_end, sp.per_layer)


@pytest.fixture
def tiny_frames(monkeypatch):
    """The program resizes frames to SigLIP's 384 whatever the
    configuration: at the tiny tower's 56 the test resizes to 56."""
    import torch
    from ufvideo_tpu_torch.ops import image_pipeline as ip

    monkeypatch.setattr(ip, "siglip_preprocess_device",
                        lambda x, out_dtype=torch.bfloat16: ip.resize_normalize(
                            x, ip.SIGLIP_MEAN, ip.SIGLIP_STD, size=56, rescale=True,
                            out_dtype=out_dtype))
