"""SAM prompt encoder + mask decoder with the ``[SEG]`` language-embedding
extension (mirrors ``ufvideo_tpu/models/sam2/prompt_mask.py``): sparse
(point / box) and dense (mask) prompt embeddings, the two-way transformer,
hypernetwork mask prediction with high-res skip features, the IoU and
object-score heads, and the dynamic multimask-via-stability rule.

Point prompts are a padded array (label -1 = padding).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...configs import SAM2Config
from .common import (
    ChannelLayerNorm,
    ConvNHWC,
    ConvTransposeNHWC,
    LayerNorm32,
    PositionEmbeddingRandom,
    ProjAttention,
    SamMLP,
)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAM2Config, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg.sam_embed_dim
        p = lambda *shape: nn.Parameter(torch.empty(*shape, dtype=dtype))
        self.pe_layer = PositionEmbeddingRandom(c // 2, dtype)
        self.point_embeddings = nn.ParameterList(p(c) for _ in range(4))
        self.not_a_point_embed = p(c)
        self.no_mask_embed = p(c)
        mask_in = 16
        self.mask_downscaling_0 = ConvNHWC(1, mask_in // 4, 2, stride=2, dtype=dtype)
        self.mask_downscaling_1 = ChannelLayerNorm(mask_in // 4, dtype)
        self.mask_downscaling_3 = ConvNHWC(mask_in // 4, mask_in, 2, stride=2, dtype=dtype)
        self.mask_downscaling_4 = ChannelLayerNorm(mask_in, dtype)
        self.mask_downscaling_6 = nn.Linear(mask_in, c, dtype=dtype)  # 1x1 conv

    def reset_own_parameters(self, gen: torch.Generator) -> None:
        from .. import init

        for t in (*self.point_embeddings, self.not_a_point_embed, self.no_mask_embed):
            init.normal_(t, 1.0, gen)

    def dense_pe(self) -> torch.Tensor:
        """[H, W, C] positional grid for the image embedding."""
        s = self.cfg.sam_image_embedding_size
        return self.pe_layer.grid(s, s)

    def embed_points(self, coords: torch.Tensor, labels: torch.Tensor, pad: bool = True):
        """coords [B, P, 2] absolute pixels, labels [B, P] in {-1, 0, 1, 2, 3}."""
        if pad:
            b = coords.shape[0]
            coords = torch.cat([coords, coords.new_zeros((b, 1, 2))], dim=1)
            labels = torch.cat([labels, -labels.new_ones((b, 1))], dim=1)
        pts = (coords.float() + 0.5) / self.cfg.hiera.image_size
        pe = self.pe_layer(pts)
        emb = torch.where(labels[..., None] == -1, torch.zeros_like(pe), pe)
        table = torch.stack([self.not_a_point_embed, *self.point_embeddings]).float()
        emb = emb + table[(labels.long() + 1).clamp(0, 4)]
        return emb.to(self.dtype)

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """[B, 4s, 4s, 1] mask prompt → [B, s, s, C] dense embedding."""
        x = self.mask_downscaling_0(masks.to(self.dtype))
        x = F.gelu(self.mask_downscaling_1(x))
        x = self.mask_downscaling_3(x)
        x = F.gelu(self.mask_downscaling_4(x))
        return self.mask_downscaling_6(x)

    def no_mask_dense(self, batch: int) -> torch.Tensor:
        s = self.cfg.sam_image_embedding_size
        return self.no_mask_embed.to(self.dtype).expand(batch, s, s, -1)

    def forward(self, coords, labels, masks: Optional[torch.Tensor]):
        sparse = self.embed_points(coords, labels, pad=True)
        dense = self.embed_masks(masks) if masks is not None else self.no_mask_dense(
            coords.shape[0])
        return sparse, dense


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SAM2Config, skip_first_layer_pe: bool, dtype: torch.dtype):
        super().__init__()
        c = cfg.sam_embed_dim
        self.skip_first_layer_pe = skip_first_layer_pe
        attn = lambda ds: ProjAttention(c, 8, ds, dtype)
        ln = lambda: LayerNorm32(c, 1e-5, dtype)
        self.self_attn = attn(1)
        self.norm1 = ln()
        self.cross_attn_token_to_image = attn(2)
        self.norm2 = ln()
        self.mlp = SamMLP(c, 2048, c, 2, dtype)
        self.norm3 = ln()
        self.cross_attn_image_to_token = attn(2)
        self.norm4 = ln()

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = self.norm2(queries)

        queries = queries + self.mlp(queries)
        queries = self.norm3(queries)

        q = queries + query_pe
        k = keys + key_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        keys = self.norm4(keys)
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAM2Config, dtype: torch.dtype, depth: int = 2):
        super().__init__()
        c = cfg.sam_embed_dim
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(cfg, i == 0, dtype) for i in range(depth)
        )
        self.final_attn_token_to_image = ProjAttention(c, 8, 2, dtype)
        self.norm_final_attn = LayerNorm32(c, 1e-5, dtype)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / pe: [B, H, W, C]; point_embedding: [B, N, C]."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(b, h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = queries + self.final_attn_token_to_image(q, k, keys)
        return self.norm_final_attn(queries), keys


class MaskDecoder(nn.Module):
    """SAM mask decoder with the object-score token and the stability-based
    multimask fallback."""

    def __init__(self, cfg: SAM2Config, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        c = cfg.sam_embed_dim
        nm = self.num_mask_tokens = cfg.num_multimask_outputs + 1
        p = lambda *shape: nn.Parameter(torch.empty(*shape, dtype=dtype))
        self.obj_score_token = p(1, c)
        self.iou_token = p(1, c)
        self.mask_tokens = p(nm, c)
        self.transformer = TwoWayTransformer(cfg, dtype)
        self.output_upscaling_0 = ConvTransposeNHWC(c, c // 4, 2, stride=2, dtype=dtype)
        self.output_upscaling_1 = ChannelLayerNorm(c // 4, dtype)
        self.output_upscaling_3 = ConvTransposeNHWC(c // 4, c // 8, 2, stride=2, dtype=dtype)
        self.output_hypernetworks_mlps = nn.ModuleList(
            SamMLP(c, c, c // 8, 3, dtype) for _ in range(nm)
        )
        self.iou_prediction_head = SamMLP(
            c, cfg.iou_head_hidden_dim, nm, cfg.iou_head_depth, dtype, sigmoid_output=True
        )
        self.pred_obj_score_head = SamMLP(c, c, 1, 3, dtype)

    def reset_own_parameters(self, gen: torch.Generator) -> None:
        from .. import init

        for t in (self.obj_score_token, self.iou_token, self.mask_tokens):
            init.normal_(t, 1.0, gen)

    def forward(
        self,
        image_embeddings: torch.Tensor,  # [B, H, W, C]
        image_pe: torch.Tensor,  # [H, W, C]
        sparse_prompts: torch.Tensor,  # [B, N, C]
        dense_prompts: torch.Tensor,  # [B, H, W, C]
        high_res_features: List[torch.Tensor],  # [(B, 4H, 4W, C/8), (B, 2H, 2W, C/4)]
        multimask_output: bool,
        apply_stability: bool = True,
    ):
        dt = self.dtype
        b = sparse_prompts.shape[0]
        nm = self.num_mask_tokens
        out_tokens = torch.cat([self.obj_score_token, self.iou_token, self.mask_tokens]).to(dt)
        tokens = torch.cat(
            [out_tokens[None].expand(b, -1, -1), sparse_prompts.to(dt)], dim=1
        )
        src = image_embeddings.to(dt) + dense_prompts.to(dt)
        pos_src = image_pe[None].expand(src.shape).to(dt)

        hs, keys = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, 1]
        mask_tokens_out = hs[:, 2:2 + nm]
        src_out = keys.reshape(src.shape)

        feat_s0, feat_s1 = high_res_features
        up = self.output_upscaling_0(src_out) + feat_s1.to(dt)
        up = F.gelu(self.output_upscaling_1(up))
        up = F.gelu(self.output_upscaling_3(up) + feat_s0.to(dt))

        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            dim=1,
        )  # [B, nm, C/8]
        masks = torch.einsum("bnc,bhwc->bnhw", hyper_in.float(), up.float())
        iou_pred = self.iou_prediction_head(iou_token_out).float()
        object_score_logits = self.pred_obj_score_head(hs[:, 0]).float()

        if multimask_output:
            out_masks, out_iou = masks[:, 1:], iou_pred[:, 1:]
            sam_tokens_out = mask_tokens_out[:, 1:]
        elif apply_stability:
            out_masks, out_iou = self._dynamic_multimask_via_stability(masks, iou_pred)
            sam_tokens_out = mask_tokens_out[:, 0:1]
        else:
            out_masks, out_iou = masks[:, 0:1], iou_pred[:, 0:1]
            sam_tokens_out = mask_tokens_out[:, 0:1]
        return out_masks, out_iou, sam_tokens_out, object_score_logits

    @staticmethod
    def _dynamic_multimask_via_stability(all_masks, all_iou):
        """Single-mask output, falling back to the best multimask output
        where the single mask is unstable under a threshold shift."""
        delta, thresh = 0.05, 0.98
        multi, multi_iou = all_masks[:, 1:], all_iou[:, 1:]
        best = multi_iou.argmax(dim=-1)
        bidx = torch.arange(all_masks.shape[0], device=all_masks.device)
        best_masks = multi[bidx, best][:, None]
        best_iou = multi_iou[bidx, best][:, None]

        single, single_iou = all_masks[:, 0:1], all_iou[:, 0:1]
        flat = single.reshape(single.shape[0], -1)
        area_i = (flat > delta).sum(dim=-1).float()
        area_u = (flat > -delta).sum(dim=-1).float()
        stability = torch.where(area_u > 0, area_i / area_u.clamp_min(1.0),
                                torch.ones_like(area_u))
        is_stable = (stability >= thresh)[:, None]
        masks_out = torch.where(is_stable[..., None, None], single, best_masks)
        iou_out = torch.where(is_stable, single_iou, best_iou)
        return masks_out, iou_out
