"""SAM2 state dict ↔ the port's SAM2 (mirrors
``ufvideo_tpu/models/sam2/convert.py``).

The state dict is the reference's module-space one: ``sam2_hiera_large.pt``
after ``checkpoints.load_sam2_checkpoint`` (``.gamma`` → ``.g_weight``), or
the ``model.mask_encoder.sam2_model.`` part of a full checkpoint. Each part
has a plan (``weights.Plan``: reference key, target, form); ``convert_sam2``
writes the model from the joined plan and ``export.export_sam2`` reads it
back. The port's layers keep torch's layouts, so most entries copy as they
are: the Hiera blocks' [in, out] holders take the reference's Linear
weights transposed (unpadded: the TPU's ``head_pad`` is not a layout here),
1x1 convolutions held as Linears drop their unit axes, the prompt
encoder's one-row embeddings become vectors, the position embeddings go
from [1, C, H, W] to [H, W, C]. The transposed convolutions of the mask
decoder keep torch's [in, out, kh, kw]. The prompt encoder's dense-mask
downscaler is a parameter set of the port's SAM2 like any other, so a
checkpoint must hold it.
"""

from __future__ import annotations

from typing import Mapping

from torch import nn

from ...weights import Plan, TensorWriter, plan_from_sd, same_names


def hiera_plan(trunk: nn.Module, prefix: str = "image_encoder.trunk") -> Plan:
    plan: Plan = [(f"{prefix}.patch_embed.proj", trunk.patch_embed, None),
                  (f"{prefix}.pos_embed", trunk.pos_embed, "chw"),
                  (f"{prefix}.pos_embed_window", trunk.pos_embed_window, "chw")]
    for i, blk in enumerate(trunk.blocks):
        bp = f"{prefix}.blocks.{i}"
        plan += [(f"{bp}.norm1", blk.norm1, None), (f"{bp}.attn.qkv", blk.attn.qkv, None),
                 (f"{bp}.attn.proj", blk.attn.proj, None), (f"{bp}.norm2", blk.norm2, None),
                 (f"{bp}.mlp.layers.0", blk.mlp_layers_0, None),
                 (f"{bp}.mlp.layers.1", blk.mlp_layers_1, None)]
        if getattr(blk, "proj", None) is not None:
            plan.append((f"{bp}.proj", blk.proj, None))
    return plan


def neck_plan(neck: nn.Module, prefix: str = "image_encoder.neck") -> Plan:
    return [(f"{prefix}.convs.{i}.conv", conv, "1x1") for i, conv in enumerate(neck.convs)]


def prompt_encoder_plan(pe: nn.Module, prefix: str = "sam_prompt_encoder") -> Plan:
    plan: Plan = [
        (f"{prefix}.pe_layer.positional_encoding_gaussian_matrix",
         pe.pe_layer.positional_encoding_gaussian_matrix, None),
        (f"{prefix}.not_a_point_embed.weight", pe.not_a_point_embed, "row"),
        (f"{prefix}.no_mask_embed.weight", pe.no_mask_embed, "row"),
    ]
    plan += [(f"{prefix}.point_embeddings.{i}.weight", t, "row")
             for i, t in enumerate(pe.point_embeddings)]
    plan += [(f"{prefix}.mask_downscaling.{i}", getattr(pe, f"mask_downscaling_{i}"),
              "1x1" if i == 6 else None) for i in (0, 1, 3, 4, 6)]
    return plan


def mask_decoder_plan(md: nn.Module, prefix: str = "sam_mask_decoder") -> Plan:
    plan: Plan = [(f"{prefix}.{n}.weight", getattr(md, n), None)
                  for n in ("obj_score_token", "iou_token", "mask_tokens")]
    plan += same_names(md.transformer, f"{prefix}.transformer")
    plan += [(f"{prefix}.output_upscaling.{i}", getattr(md, f"output_upscaling_{i}"), None)
             for i in (0, 1, 3)]
    for head in ("iou_prediction_head", "pred_obj_score_head", "output_hypernetworks_mlps"):
        plan += same_names(getattr(md, head), f"{prefix}.{head}")
    return plan


def memory_attention_plan(ma: nn.Module, prefix: str = "memory_attention") -> Plan:
    return same_names(ma, prefix)


def memory_encoder_plan(me: nn.Module, prefix: str = "memory_encoder") -> Plan:
    plan: Plan = [(f"{prefix}.pix_feat_proj", me.pix_feat_proj, "1x1"),
                  (f"{prefix}.out_proj", me.out_proj, "1x1")]
    for name, layer in me.mask_downsampler.named_children():  # encoder_0 … encoder_12
        i = int(name.removeprefix("encoder_"))
        plan.append((f"{prefix}.mask_downsampler.encoder.{i}", layer,
                     "1x1" if isinstance(layer, nn.Linear) else None))
    for i, blk in enumerate(me.fuser_layers):
        fp = f"{prefix}.fuser.layers.{i}"
        plan += [(f"{fp}.dwconv", blk.dwconv, None), (f"{fp}.norm", blk.norm, None),
                 (f"{fp}.pwconv1", blk.pwconv1, None), (f"{fp}.pwconv2", blk.pwconv2, None),
                 (f"{fp}.g_weight", blk.g_weight, None)]
    return plan


def sam2_plan(sam: nn.Module) -> Plan:
    """Every parameter of the port's SAM2 under its reference key."""
    return hiera_plan(sam.image_encoder_trunk) + sam2_heads_plan(sam)


def sam2_heads_plan(sam: nn.Module) -> Plan:
    """Every parameter of the port's SAM2 but the Hiera trunk's."""
    plan = neck_plan(sam.image_encoder_neck)
    plan += prompt_encoder_plan(sam.sam_prompt_encoder)
    plan += mask_decoder_plan(sam.sam_mask_decoder)
    plan += memory_attention_plan(sam.memory_attention)
    plan += memory_encoder_plan(sam.memory_encoder)
    plan += [("sam_mask_decoder.conv_s0", sam.conv_s0, "1x1"),
             ("sam_mask_decoder.conv_s1", sam.conv_s1, "1x1")]
    plan += same_names(sam.obj_ptr_proj, "obj_ptr_proj")
    plan += [(n, getattr(sam, n), None)
             for n in ("no_mem_embed", "no_mem_pos_enc", "maskmem_tpos_enc", "no_obj_ptr")]
    return plan


def convert_sam2(w: TensorWriter, sam: nn.Module, sd: Mapping) -> None:
    """A SAM2 state dict (module space, ``.g_weight`` names) → ``sam``; a
    W8A8 trunk quantises each dense layer as it is written."""
    plan_from_sd(w, sam2_plan(sam), sd)
