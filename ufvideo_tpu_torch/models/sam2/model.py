"""SAM2 top-level model: image encoder + heads + memory (mirrors
``ufvideo_tpu/models/sam2/model.py``, with the flags the UFVideo build
hard-codes baked in: the no-memory embedding added directly, high-res
features in the SAM heads, multimask output (also for tracking, 0..1
points), object pointers in the encoder (at most 16, past only, no temporal
position encoding), predicted object scores with a fixed no-object pointer,
the multimask token for the object pointer, and sigmoid scale / bias
20 / -10 for the memory encoder).

The memory bank interface has a fixed shape: callers pass stacked memory
feature maps plus validity masks (``video.py`` runs the propagation).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ...configs import SAM2Config, VisionRouting
from ...ops.interp import resize_hw
from .. import init
from .common import SamMLP, position_embedding_sine
from .hiera import FpnNeck, Hiera
from .memory import MemoryAttention, MemoryEncoder
from .prompt_mask import MaskDecoder, PromptEncoder


class SamHeadsOutput(NamedTuple):
    low_res_multimasks: torch.Tensor  # [B, M, 4H, 4W] float32 logits
    high_res_multimasks: torch.Tensor  # [B, M, 16H, 16W]
    ious: torch.Tensor  # [B, M]
    low_res_masks: torch.Tensor  # [B, 1, 4H, 4W] best mask
    high_res_masks: torch.Tensor  # [B, 1, 16H, 16W]
    obj_ptr: torch.Tensor  # [B, C]
    object_score_logits: torch.Tensor  # [B, 1]


def _upsample(masks: torch.Tensor, size: int) -> torch.Tensor:
    """Bilinear upsample [B, M, h, w] → [B, M, size, size], float32."""
    return resize_hw(masks.float(), size, size, "bilinear")


class SAM2(nn.Module):
    def __init__(self, cfg: SAM2Config, dtype: torch.dtype = torch.bfloat16,
                 quant: bool = False, routing: Optional[VisionRouting] = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.quant = quant
        c = cfg.sam_embed_dim
        # quant: only the trunk's blocks are W8A8 (the encode hot path);
        # patch embed, FPN, prompt / mask / memory heads stay float. The
        # routing picks the trunk's kernels (hiera.py)
        self.image_encoder_trunk = Hiera(cfg.hiera, dtype, quant, routing)
        self.image_encoder_neck = FpnNeck(cfg, dtype)
        self.sam_prompt_encoder = PromptEncoder(cfg, dtype)
        self.sam_mask_decoder = MaskDecoder(cfg, dtype)
        self.memory_attention = MemoryAttention(cfg, dtype)
        self.memory_encoder = MemoryEncoder(cfg, dtype)
        # high-res skip projections (1x1 convs), applied at encode time
        self.conv_s0 = nn.Linear(cfg.fpn_dim, c // 8, dtype=dtype)
        self.conv_s1 = nn.Linear(cfg.fpn_dim, c // 4, dtype=dtype)
        self.obj_ptr_proj = SamMLP(c, c, c, 3, dtype)
        p = lambda *shape: nn.Parameter(torch.empty(*shape, dtype=dtype))
        self.no_mem_embed = p(1, 1, c)
        self.no_mem_pos_enc = p(1, 1, c)
        self.maskmem_tpos_enc = p(cfg.num_maskmem, 1, 1, cfg.mem_dim)
        self.no_obj_ptr = p(1, c)

    def reset_own_parameters(self, gen: torch.Generator) -> None:
        for t in (self.no_mem_embed, self.no_mem_pos_enc, self.maskmem_tpos_enc,
                  self.no_obj_ptr):
            init.normal_(t, 0.02, gen)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random init with the JAX package's initialiser distributions."""
        init.reset_tree_(self, gen)

    # ------------------------------------------------------------------
    # image encoding
    # ------------------------------------------------------------------

    def forward_image(self, images: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """[B, S, S, 3] → three NHWC feature levels (s0 after conv_s0, s1
        after conv_s1, s2) and their sine position embeddings."""
        features, pos = self.image_encoder_neck(self.image_encoder_trunk(images))
        if self.cfg.scalp > 0:  # drop the lowest-resolution level(s)
            features = features[: -self.cfg.scalp]
            pos = pos[: -self.cfg.scalp]
        features = [self.conv_s0(features[0]), self.conv_s1(features[1]), features[2]]
        return {"backbone_fpn": features, "vision_pos_enc": pos}

    # ------------------------------------------------------------------
    # SAM heads
    # ------------------------------------------------------------------

    def forward_sam_heads(
        self,
        backbone_features: torch.Tensor,  # [B, H, W, C] memory-conditioned
        high_res_features: List[torch.Tensor],  # [(B, 4H, 4W, C/8), (B, 2H, 2W, C/4)]
        language_embd: Optional[torch.Tensor] = None,  # [B, 1, C]
        point_coords: Optional[torch.Tensor] = None,  # [B, P, 2]
        point_labels: Optional[torch.Tensor] = None,  # [B, P]
        mask_inputs: Optional[torch.Tensor] = None,  # [B, 16H, 16W, 1]
        multimask_output: bool = True,
        training: bool = False,  # gates the stability fallback
    ) -> SamHeadsOutput:
        cfg = self.cfg
        b = backbone_features.shape[0]
        dev = backbone_features.device
        if point_coords is None:
            point_coords = torch.zeros((b, 1, 2), dtype=torch.float32, device=dev)
            point_labels = -torch.ones((b, 1), dtype=torch.int32, device=dev)
        sparse, dense = self.sam_prompt_encoder(point_coords, point_labels, mask_inputs)
        if language_embd is not None:
            sparse = torch.cat([sparse, language_embd.to(sparse.dtype)], dim=1)

        masks, ious, sam_tokens, obj_logits = self.sam_mask_decoder(
            backbone_features, self.sam_prompt_encoder.dense_pe(), sparse, dense,
            high_res_features, multimask_output, apply_stability=not training,
        )
        # mask logits pass through raw even where the object score is <= 0;
        # the score only gates the object pointer below
        is_obj = obj_logits > 0
        high_res = _upsample(masks, cfg.hiera.image_size)

        if multimask_output:
            best = ious.argmax(dim=-1)
            bidx = torch.arange(b, device=dev)
            low_res_masks = masks[bidx, best][:, None]
            high_res_masks = high_res[bidx, best][:, None]
            sam_token = sam_tokens[bidx, best]
        else:
            low_res_masks, high_res_masks = masks, high_res
            sam_token = sam_tokens[:, 0]

        obj_ptr = self.obj_ptr_proj(sam_token)
        lam = is_obj.float()  # [B, 1]
        obj_ptr = lam * obj_ptr + (1.0 - lam) * self.no_obj_ptr.float()
        return SamHeadsOutput(
            masks, high_res, ious, low_res_masks, high_res_masks, obj_ptr, obj_logits
        )

    # ------------------------------------------------------------------
    # memory
    # ------------------------------------------------------------------

    def condition_on_memory(
        self,
        curr_feat: torch.Tensor,  # [B, HW, C] top-level features
        curr_pos: torch.Tensor,  # [B, HW, C]
        mem_feats: torch.Tensor,  # [B, M, HW, mem_dim]; slot 0 = cond, 1.. = newest..oldest
        mem_valid: torch.Tensor,  # [B, M] bool
        mem_tpos_idx: torch.Tensor,  # [M] int: index into maskmem_tpos_enc
        obj_ptrs: torch.Tensor,  # [B, P, C] pointer vectors
        ptr_valid: torch.Tensor,  # [B, P] bool
        feat_hw: Tuple[int, int],
    ) -> torch.Tensor:
        """Memory-conditioned features: invalid memory slots and pointers are
        masked out of the cross-attention instead of being dropped."""
        cfg = self.cfg
        b, m, hw, md = mem_feats.shape
        h, w = feat_hw
        c = cfg.sam_embed_dim
        dev = mem_feats.device

        spat_pos = position_embedding_sine(h, w, cfg.mem_dim, device=dev).reshape(1, 1, hw, md)
        tpos = self.maskmem_tpos_enc[mem_tpos_idx.long()].reshape(1, m, 1, md)
        mem_pos = (spat_pos + tpos).float().expand(b, m, hw, md).reshape(b, m * hw, md)
        memory = mem_feats.reshape(b, m * hw, md)

        # each C-dim pointer splits into C / mem_dim tokens
        p = obj_ptrs.shape[1]
        tok_per_ptr = c // cfg.mem_dim
        ptr_tokens = obj_ptrs.reshape(b, p * tok_per_ptr, cfg.mem_dim)
        ptr_mask = ptr_valid.repeat_interleave(tok_per_ptr, dim=1)

        kv = torch.cat([memory, ptr_tokens.to(memory.dtype)], dim=1)
        kv_pos = torch.cat([mem_pos, torch.zeros_like(ptr_tokens, dtype=torch.float32)], dim=1)
        kv_mask = torch.cat([mem_valid.repeat_interleave(hw, dim=1), ptr_mask], dim=1)

        dt = self.dtype
        return self.memory_attention(
            curr_feat.to(dt), curr_pos.to(dt), kv.to(dt), kv_pos.to(dt),
            num_obj_ptr_tokens=p * tok_per_ptr, kv_mask=kv_mask,
        )

    def no_memory_features(self, curr_feat: torch.Tensor) -> torch.Tensor:
        """Initial conditioning frame: add the no-memory embedding."""
        return curr_feat + self.no_mem_embed.to(curr_feat.dtype)

    def encode_memory(self, pix_feat: torch.Tensor, high_res_masks: torch.Tensor):
        """[B, H, W, C] features + [B, 16H, 16W, 1] mask logits →
        [B, H, W, mem_dim]."""
        cfg = self.cfg
        m = torch.sigmoid(high_res_masks.float())
        m = m * cfg.sigmoid_scale_for_mem_enc + cfg.sigmoid_bias_for_mem_enc
        return self.memory_encoder(pix_feat, m.to(self.dtype), skip_mask_sigmoid=True)
