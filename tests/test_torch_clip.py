"""The port's CLIP tower (``models/clip.py``) and ``weights.convert_clip``
against ``ufvideo_tpu``'s on the same seeded inputs: the tower on the JAX
tower's parameters (3 layers, the -2 tap: 2 computed, width 64, image 56,
patch 14) within 1e-5 (f32), and the converter on a synthetic HF
CLIPVisionModel state dict against the JAX converter exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ufvideo_tpu.models import clip as jclip
from ufvideo_tpu.weights import convert_clip as j_convert_clip
from ufvideo_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionTower, quick_gelu
from ufvideo_tpu_torch.weights import TensorWriter, convert_clip, load_jax_clip_params

TINY = dict(hidden_size=64, intermediate_size=128, num_layers=3, num_heads=4, image_size=56,
            patch_size=14)
TOL = 1e-5


def _pixels(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, 56, 56, 3)).astype(np.float32)


@pytest.mark.parametrize("select_feature", ["patch", "cls_patch"])
def test_tower_equals_jax(select_feature):
    jcfg = jclip.CLIPVisionConfig(**TINY, select_feature=select_feature)
    jt = jclip.CLIPVisionTower(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    px = _pixels()
    params = jt.init(jax.random.PRNGKey(0), jnp.asarray(px))["params"]
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(px)))
    tower = CLIPVisionTower(CLIPVisionConfig(**TINY, select_feature=select_feature),
                            torch.float32)
    load_jax_clip_params(tower, jax.tree.map(np.asarray, params))
    got = tower(torch.from_numpy(px)).detach().numpy()
    assert got.shape == want.shape == (2, 16 + (select_feature != "patch"), 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _hf_state_dict(cfg, seed=1):
    """HF CLIPVisionModel key names and shapes, random values; every one of
    the model's layers and its post-LayerNorm (which the tap never reads)."""
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g) * 0.1
    c, m, p = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    sd = {"vision_model.embeddings.patch_embedding.weight": rn(c, 3, p, p),
          "vision_model.embeddings.class_embedding": rn(c),
          "vision_model.embeddings.position_embedding.weight": rn(cfg.num_patches + 1, c),
          "vision_model.embeddings.position_ids": torch.arange(cfg.num_patches + 1)[None],
          "vision_model.pre_layrnorm.weight": 1 + rn(c), "vision_model.pre_layrnorm.bias": rn(c),
          "vision_model.post_layernorm.weight": 1 + rn(c),
          "vision_model.post_layernorm.bias": rn(c)}
    for i in range(cfg.num_layers):
        lp = f"vision_model.encoder.layers.{i}"
        for n in ("layer_norm1", "layer_norm2"):
            sd[f"{lp}.{n}.weight"], sd[f"{lp}.{n}.bias"] = 1 + rn(c), rn(c)
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{lp}.self_attn.{n}.weight"], sd[f"{lp}.self_attn.{n}.bias"] = rn(c, c), rn(c)
        sd[f"{lp}.mlp.fc1.weight"], sd[f"{lp}.mlp.fc1.bias"] = rn(m, c), rn(m)
        sd[f"{lp}.mlp.fc2.weight"], sd[f"{lp}.mlp.fc2.bias"] = rn(c, m), rn(c)
    return sd


def test_convert_clip_equals_jax():
    cfg = CLIPVisionConfig(**TINY)
    sd = _hf_state_dict(cfg)
    want = CLIPVisionTower(cfg, torch.float32)
    load_jax_clip_params(want, j_convert_clip(sd, jclip.CLIPVisionConfig(**TINY)))
    got = CLIPVisionTower(cfg, torch.float32)
    w = TensorWriter()
    convert_clip(w, got, sd)
    w.check_all_written(got)
    ref = dict(want.named_parameters())
    for name, p in got.named_parameters():
        assert torch.equal(p, ref[name]), name
    px = torch.from_numpy(_pixels(3))
    torch.testing.assert_close(got(px), want(px), rtol=0, atol=0)


def test_config_and_quick_gelu():
    cfg = CLIPVisionConfig()
    assert (cfg.grid_size, cfg.num_patches, cfg.head_dim, cfg.num_encode_layers) == \
        (24, 576, 64, 23)
    with pytest.raises(ValueError):
        _ = dataclasses.replace(cfg, select_layer=3).num_encode_layers
    x = torch.linspace(-6, 6, 97)
    np.testing.assert_allclose(quick_gelu(x).numpy(), np.asarray(jclip.quick_gelu(
        jnp.asarray(x.numpy()))), atol=1e-6)
