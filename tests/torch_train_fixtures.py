"""Shared set-up of the training parity tests (``test_torch_train_*.py``):
the micro configuration of ``tests/test_train_e2e.py`` in both packages
(float32), one parameter tree for both, and a ``[SEG]`` + ``<region>``
sample collated by each package's ``Collator``.

The JAX tree's shapes come from ``jax.eval_shape`` (no initialiser compile)
and its values from numpy with a seed: fan-in-scaled normals for matrices,
small normals for vectors, ones (plus noise) for norm scales. Random values
cannot agree across frameworks otherwise; the tests carry this tree into the
port (``weights.load_jax_params``) and compare everything after it.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_cores  # noqa: F401  (one share of the cores a test worker)

from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu.models.sam2 import SAM2 as JSAM2
from ufvideo_tpu.models.ufvideo import UFVideoModel as JUFVideoModel
from ufvideo_tpu.tokenization import byte_tokenizer_with_ids as j_byte_tokenizer
from ufvideo_tpu.train import data as jdata
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models.ufvideo import UFVideoModel
from ufvideo_tpu_torch.tokenization import byte_tokenizer_with_ids
from ufvideo_tpu_torch.train import data as pdata
from ufvideo_tpu_torch.weights import load_jax_params

SAM_SIZE = 64
LABEL = (40, 60)
CONV = [
    {"from": "human", "value": "<video>\n<region>: segment it."},
    {"from": "gpt", "value": "It is [SEG]."},
]


def _micro(cfg, ids):
    return cfg.replace(
        vision=dataclasses.replace(cfg.vision, num_layers=2),
        llm=dataclasses.replace(cfg.llm, num_layers=1),
        budget=dataclasses.replace(cfg.budget, num_frames=2, num_frames_sam=1,
                                   max_seq_len=128),
        sam=dataclasses.replace(
            cfg.sam, hiera=dataclasses.replace(cfg.sam.hiera, image_size=SAM_SIZE),
            sam_image_embedding_size=SAM_SIZE // 16, mem_attn_rope_feat_sizes=(4, 4)),
        region_token_id=ids.region, seg_token_id=ids.seg,
        temporal_token_start_id=ids.temporal_start,
    )


def micro_configs():
    """(JAX cfg, port cfg, JAX tokenizer, port tokenizer, ids)."""
    jtok, jids = j_byte_tokenizer()
    tok, ids = byte_tokenizer_with_ids()
    return _micro(j_tiny_config(), jids), _micro(tiny_config(), ids), jtok, tok, ids


def _fill(rng):
    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale" or name.endswith("weight") and s.ndim == 1:
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if s.ndim <= 1:
            return (0.02 * rng.standard_normal(s.shape)).astype(np.float32)
        fan = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) / np.sqrt(fan)).astype(np.float32)
    return leaf


def jax_params(jcfg, seed: int = 0) -> dict:
    """The composite's tree plus ``sam``, numpy leaves."""
    model = JUFVideoModel(jcfg)
    sam = JSAM2(jcfg.sam, dtype=jnp.float32, param_dtype=jnp.float32)
    shapes = dict(jax.eval_shape(model.init_params, jax.random.PRNGKey(0)))
    shapes["sam"] = jax.eval_shape(
        lambda k: sam.init(k, jnp.zeros((1, SAM_SIZE, SAM_SIZE, 3)))["params"],
        jax.random.PRNGKey(1))
    return jax.tree_util.tree_map_with_path(_fill(np.random.default_rng(seed)), shapes)


def port_model(pcfg, params) -> UFVideoModel:
    """The port's model holding ``params``; the layers the JAX tree lacks
    (flax builds them lazily: the prompt encoder's mask downscaler) are 0."""
    model = UFVideoModel.empty(pcfg, "cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    load_jax_params(model, params)
    return model


def port_named(pcfg, tree) -> dict:
    """A JAX-shaped tree (params, or an optimizer moment with zeros at
    frozen leaves) → the port's tensors by parameter name, through the same
    loader that carries parameters across."""
    return {n: p.detach().clone() for n, p in port_model(pcfg, tree).named_parameters()}


def _arrays(seed: int, jcfg):
    rng = np.random.default_rng(seed)
    v = jcfg.vision.image_size
    mask = np.zeros(LABEL, np.float32)
    mask[6:30, 10:45] = 1.0
    return dict(
        video=rng.standard_normal((jcfg.budget.num_frames, v, v, 3)).astype(np.float32),
        region_frames=rng.standard_normal((1, v, v, 3)).astype(np.float32),
        region_masks=mask[None],
        ann_indices=[[0]],
        images_sam=rng.standard_normal(
            (jcfg.budget.num_frames_sam, SAM_SIZE, SAM_SIZE, 3)).astype(np.float32),
        gt_masks=np.stack([np.stack([mask] * jcfg.budget.num_frames_sam)]),
    )


def samples(jcfg, jtok, tok, n: int = 2, conv=CONV):
    """The same ``n`` samples as each package's ``TrainSample``."""
    jids, jlabels = jdata.preprocess_conversation(
        jdata.normalize_modal_token(conv, "<video>"), jtok, "<video>")
    ids, labels = pdata.preprocess_conversation(
        pdata.normalize_modal_token(conv, "<video>"), tok, "<video>")
    assert (ids, labels) == (jids, jlabels)
    arrs = [_arrays(i, jcfg) for i in range(n)]
    return ([jdata.TrainSample(jids, jlabels, **a) for a in arrs],
            [pdata.TrainSample(ids, labels, **a) for a in arrs])


def collated(jcfg, pcfg, jtok, tok, ids, n: int = 2):
    """(JAX batch dict, port batch dict) of numpy arrays, asserted equal."""
    js, ps = samples(jcfg, jtok, tok, n)
    jb = jdata.Collator(jcfg, ids.region, ids.seg)(js)
    pb = pdata.Collator(pcfg, ids.region, ids.seg)(ps)
    assert sorted(jb) == sorted(pb)
    for k in jb:
        np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
    return jb, pb


def torch_batch(pb: dict, cls):
    return cls(**{k: torch.from_numpy(np.ascontiguousarray(pb[k]))
                  for k in cls._fields if k in pb})


def jax_batch(jb: dict, cls):
    return cls(**{k: jnp.asarray(jb[k]) for k in cls._fields if k in jb})
