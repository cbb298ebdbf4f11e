"""Checkpoint export: the port's modules → the reference's torch state dicts
(mirrors ``ufvideo_tpu/export.py``; the inverse of the converters in
``weights.py`` and ``models/sam2/convert.py``):

  1. full model checkpoints with the reference's key layout
     (``model.embed_tokens.weight`` … ``model.mask_encoder.sam2_model.*``),
     one ``pytorch_model.bin`` and a ``config.json``;
  2. adapter-only ``mm_projector.bin`` / ``region_encoder.bin``;
  3. a standalone SAM2 state dict, renamed to the ``.gamma`` flavour by
     ``rename_g_weight_to_gamma``.

Each tensor is copied off the device into a CPU tensor of its own, in its
parameter's dtype, as the exporter reaches it. The port's SAM2 always holds
the prompt encoder's dense-mask downscaler, so its export has the
reference's full key set. A quantised model is refused: the format holds
float weights (the JAX package exports no ``kernel_q`` either).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from .configs import Qwen2Config, UFVideoConfig
from .models.sam2.convert import hiera_plan, sam2_heads_plan
from .models.ufvideo import UFVideoModel
from .weights import plan_to_sd, projector_plan, qwen2_plan, region_plan, siglip_plan, \
    text_fcs_plan, to_host



def _refuse_quantised(cfg: UFVideoConfig) -> None:
    if cfg.quant_llm or cfg.quant_vision:
        raise ValueError(
            "export of a quantised model: the checkpoint format holds float weights; "
            "export the float model (model_init without quant_llm / quant_vision)")


def export_qwen2(lm, cfg: Qwen2Config) -> Dict[str, torch.Tensor]:
    """Qwen2 LM → HF Qwen2ForCausalLM state dict: vocabulary unpadded, the
    fused qkv split into q / k / v, no ``lm_head.weight`` when tied."""
    if hasattr(lm.lm_head, "kernel_q"):
        raise ValueError("export of a quantised LM: the checkpoint format holds float weights")
    v = cfg.vocab_size
    out = {"model.embed_tokens.weight": to_host(lm.embed_tokens.weight[:v])}
    out.update(plan_to_sd(qwen2_plan(lm)))
    if not cfg.tie_word_embeddings:
        out["lm_head.weight"] = to_host(lm.lm_head.weight[:v])
    return out


def export_siglip(tower) -> Dict[str, torch.Tensor]:
    """SigLIP tower → HF SiglipVisionModel state dict: the
    ``num_encode_layers`` layers the port holds (HF fills the rest with its
    init, which the −2 tap never reads)."""
    if tower.quant:
        raise ValueError("export of a W8A8 tower: the checkpoint format holds float weights")
    return plan_to_sd(siglip_plan(tower))


def export_projector(proj) -> Dict[str, torch.Tensor]:
    """Inverse of ``weights.convert_projector`` (timm RegStage naming). The
    port builds only the STC projector (the other types raise when built,
    ROADMAP.md queue 1 item 7)."""
    return plan_to_sd(projector_plan(proj))


def export_region_encoder(region) -> Dict[str, torch.Tensor]:
    return plan_to_sd(region_plan(region))


def export_text_hidden_fcs(text_fcs) -> Dict[str, torch.Tensor]:
    return plan_to_sd(text_fcs_plan(text_fcs))


def export_hiera(trunk, prefix: str = "image_encoder.trunk") -> Dict[str, torch.Tensor]:
    """Hiera trunk → its reference keys (qkv and proj as the port holds
    them: without the TPU's ``head_pad``)."""
    return plan_to_sd(hiera_plan(trunk, prefix))


def export_sam2(sam) -> Dict[str, torch.Tensor]:
    """SAM2 → the reference's module-space state dict (``.g_weight`` names;
    ``rename_g_weight_to_gamma`` gives the standalone ``.pt`` flavour)."""
    return {**export_hiera(sam.image_encoder_trunk), **plan_to_sd(sam2_heads_plan(sam))}


def rename_g_weight_to_gamma(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Module space → the standalone ``sam2_hiera_large.pt`` key space (the
    inverse of ``checkpoints.load_sam2_checkpoint``'s rename)."""
    return {k.replace(".g_weight", ".gamma"): v for k, v in sd.items()}


def export_full_checkpoint(model: UFVideoModel,
                           cfg: Optional[UFVideoConfig] = None) -> Dict[str, torch.Tensor]:
    """The model → the reference's full SFT state dict layout (inverse of
    ``checkpoints.convert_full_checkpoint``): the LLM at the top level, the
    tower under ``model.vision_tower.vision_tower.``, the projector under
    ``model.mm_projector.``, the region encoder, ``text_hidden_fcs`` and SAM2
    (when the model has one) under their ``model.`` paths."""
    cfg = cfg or model.cfg
    _refuse_quantised(cfg)
    out = export_qwen2(model.llm, cfg.llm)
    for prefix, part in (
        ("model.vision_tower.vision_tower.", export_siglip(model.vision)),
        ("model.mm_projector.", export_projector(model.projector)),
        ("model.region_encoder.", export_region_encoder(model.region)),
        ("model.", export_text_hidden_fcs(model.text_fcs)),
    ):
        out.update({prefix + k: v for k, v in part.items()})
    if model.sam is not None:
        out.update({f"model.mask_encoder.sam2_model.{k}": v
                    for k, v in export_sam2(model.sam).items()})
    return out


def save_hf_checkpoint(path: str, model: UFVideoModel,
                       cfg: Optional[UFVideoConfig] = None) -> None:
    """Write a reference-loadable checkpoint directory: one
    ``pytorch_model.bin`` (each tensor in its parameter's dtype) and a
    ``config.json`` with the fields the reference's loader reads."""
    cfg = cfg or model.cfg
    os.makedirs(path, exist_ok=True)
    sd = export_full_checkpoint(model, cfg)
    torch.save(sd, os.path.join(path, "pytorch_model.bin"))
    del sd
    config = {
        "architectures": ["VideoReferQwen2ForCausalLM"],
        "model_type": "videorefer_qwen2",
        "hidden_size": cfg.llm.hidden_size,
        "intermediate_size": cfg.llm.intermediate_size,
        "num_attention_heads": cfg.llm.num_heads,
        "num_key_value_heads": cfg.llm.num_kv_heads,
        "num_hidden_layers": cfg.llm.num_layers,
        "vocab_size": cfg.llm.vocab_size,
        "rms_norm_eps": cfg.llm.rms_norm_eps,
        "rope_theta": cfg.llm.rope_theta,
        "max_position_embeddings": cfg.llm.max_position_embeddings,
        "tie_word_embeddings": cfg.llm.tie_word_embeddings,
        "torch_dtype": str(cfg.param_dtype).removeprefix("torch."),
        # the reference's config-bus fields
        "mm_projector_type": cfg.projector.projector_type,
        "mm_vision_select_layer": cfg.vision.select_layer,
        "region_encoder_type": "onefusion",
        "num_frames": cfg.budget.num_frames,
        "seg_token_id": cfg.seg_token_id,
        "train_mask_decoder": False,
        "sam_out_dim": cfg.sam_out_dim,
        "ce_loss_weight": cfg.ce_loss_weight,
        "bce_loss_weight": cfg.bce_loss_weight,
        "dice_loss_weight": cfg.dice_loss_weight,
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


def save_adapter_bins(path: str, model: UFVideoModel) -> None:
    """Write the reference's adapter-only artifacts, ``mm_projector.bin``
    and ``region_encoder.bin``, with full module-path keys."""
    os.makedirs(path, exist_ok=True)
    for name, prefix, part in (
        ("mm_projector.bin", "model.mm_projector.", export_projector(model.projector)),
        ("region_encoder.bin", "model.region_encoder.", export_region_encoder(model.region)),
    ):
        torch.save({prefix + k: v for k, v in part.items()}, os.path.join(path, name))
