"""Composite UFVideo model: SigLIP tower + projector (any type of
``build_projector``; STC-v35 by default) + region encoder + Qwen2 LM + the
``[SEG]`` text head + SAM2 (mirrors ``ufvideo_tpu/models/ufvideo.py``
``encode_video`` / ``encode_regions`` / ``splice_embeds`` / ``seg_embeddings``;
the JAX runtime keeps SAM2 beside the composite, here it is a member). ``cfg.quant_vision`` builds the SigLIP
tower and SAM2's Hiera trunk in W8A8, ``cfg.quant_llm`` the LM on
weight-only int8 / int4. The ``*_train`` methods are the same functions with
autograd recording, for ``train/``."""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

from ..configs import UFVideoConfig, VisionRouting
from ..splicing import apply_splice
from .projector import build_projector
from . import init
from .qwen2 import Qwen2LM
from .region_encoder import RegionProjector, extract_region_tokens
from .sam2 import SAM2
from .siglip import SiglipVisionTower


class TextHiddenFC(nn.Module):
    """``[SEG]`` hidden-state head: Linear → ReLU → Linear to sam_out_dim."""

    def __init__(self, hidden_size: int, out_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc0 = nn.Linear(hidden_size, hidden_size, dtype=dtype)
        self.fc1 = nn.Linear(hidden_size, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc1(torch.relu(self.fc0(x.to(self.dtype))))


class UFVideoModel(nn.Module):
    """``routing`` fixes the vision towers' kernels and modules when they are
    built (``VisionRouting``; the JAX package reads the same choices from
    its environment)."""

    def __init__(self, cfg: UFVideoConfig, routing: Optional[VisionRouting] = None):
        super().__init__()
        self.cfg = cfg
        self.routing = routing or VisionRouting()
        dt = cfg.param_dtype
        self.vision = SiglipVisionTower(
            cfg.vision, dtype=dt, quant=bool(cfg.quant_vision), routing=self.routing)
        self.projector = build_projector(cfg.projector, dtype=dt)
        self.region = RegionProjector(cfg.region, dtype=dt)
        self.llm = Qwen2LM(cfg.llm, dtype=dt, quant=cfg.quant_llm)
        self.text_fcs = TextHiddenFC(cfg.llm.hidden_size, cfg.sam_out_dim, dt)
        self.sam = SAM2(cfg.sam, dtype=dt, quant=bool(cfg.quant_vision), routing=self.routing)

    @classmethod
    def empty(cls, cfg: UFVideoConfig, device,
              routing: Optional[VisionRouting] = None) -> "UFVideoModel":
        """Uninitialised, frozen parameters on ``device`` (built on the meta
        device first, so no memory is filled twice)."""
        with torch.device("meta"):
            model = cls(cfg, routing)
        return model.to_empty(device=device).eval().requires_grad_(False)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random init with the JAX package's initialiser distributions."""
        self.vision.reset_parameters(gen)
        self.projector.reset_parameters(gen)
        self.llm.reset_parameters(gen)
        init.reset_tree_(self.text_fcs, gen)
        self.sam.reset_parameters(gen)
        # last, so that the modules above draw what they drew before the
        # region encoder was added
        init.reset_tree_(self.region, gen)

    def set_use_kernels(self, flag: bool) -> None:
        """Route every kernel call to its CUDA kernel (True, the default;
        CPU tensors still take the plain versions) or to the plain PyTorch
        version on any device (False)."""
        for m in self.modules():
            if hasattr(m, "use_kernels"):
                m.use_kernels = flag

    # The inference methods below run under ``torch.no_grad``; training
    # calls the ``*_train`` methods, which record a graph. A tower none of
    # whose parameters is trainable runs under ``no_grad`` there too (its
    # output is a constant of the step), so only the trained parts keep
    # activations. The inference methods are the train ones under no_grad:
    # the same arithmetic, so inference results do not move.

    def encode_video_train(self, pixels: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, 3] frames → [B, V, hidden] video tokens."""
        b, t, h, w, c = pixels.shape
        with grad_unless_frozen(self.vision):
            feats = self.vision(pixels.reshape(b * t, h, w, c))
        feats = feats.reshape(b, t, feats.shape[1], feats.shape[2])
        return self.projector(feats)

    def encode_regions_train(
        self,
        frame_pixels: torch.Tensor,  # [B, F, H, W, 3] annotated frames
        masks: torch.Tensor,  # [B, F, Hm, Wm]
        frame_valid: torch.Tensor,  # [B, F] bool
        region_segments: torch.Tensor,  # [B, R, F] bool
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ ([B, R·rt, hidden] region tokens, [B, R·rt] validity): tower
        encode of the annotated frames, mask pooling, static token merge,
        the region MLP."""
        b, f, h, w, c = frame_pixels.shape
        with grad_unless_frozen(self.vision):
            feats = self.vision(frame_pixels.reshape(b * f, h, w, c))
        feats = feats.reshape(b, f, feats.shape[1], feats.shape[2])
        rt = self.cfg.region.region_token_num
        tokens, valid = zip(*(
            extract_region_tokens(feats[i], masks[i], frame_valid[i], region_segments[i], rt)
            for i in range(b)
        ))
        tokens = torch.stack(tokens).reshape(b, -1, feats.shape[-1])  # [B, R·rt, C]
        return self.region(tokens), torch.stack(valid).reshape(b, -1)

    def splice_embeds_train(
        self,
        text_ids: torch.Tensor,  # [B, T] sentinel-free ids
        src_kind: torch.Tensor,  # [B, S]
        src_idx: torch.Tensor,  # [B, S]
        video_feats: Optional[torch.Tensor],
        region_feats: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        text_embeds = self.llm.embed(text_ids)
        return apply_splice(text_embeds, video_feats, region_feats, src_kind, src_idx)

    def seg_embeddings_train(self, hidden: torch.Tensor) -> torch.Tensor:
        """Final-layer hidden states → SAM prompt embeddings."""
        return self.text_fcs(hidden)

    encode_video = torch.no_grad()(encode_video_train)
    encode_regions = torch.no_grad()(encode_regions_train)
    splice_embeds = torch.no_grad()(splice_embeds_train)
    seg_embeddings = torch.no_grad()(seg_embeddings_train)


def grad_unless_frozen(*modules: nn.Module):
    """``no_grad`` where none of the modules' parameters is trainable; no
    scan of the parameters where autograd is off already (inference)."""
    if not torch.is_grad_enabled():
        return contextlib.nullcontext()
    trainable = any(p.requires_grad for m in modules for p in m.parameters())
    return contextlib.nullcontext() if trainable else torch.no_grad()
