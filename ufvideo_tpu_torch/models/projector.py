"""STC-v35 spatio-temporal connector (mirrors the ``stc_connector_v35``
path of ``ufvideo_tpu/models/projector.py``): RegStage(4) → Conv3d
(t, h, w) = (2, 2, 2) stride 2, padding 0 → SiLU → RegStage(4) → 2-layer MLP
readout with exact-erf GELU.

Activations stay NHWC / NDHWC, as in JAX. 1x1 convolutions are
``nn.Linear`` over channels; the depthwise 3x3 and the sampler are
``nn.Conv2d`` / ``nn.Conv3d`` (torch weight layouts) applied on permuted
views. The other projector types come with a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import ProjectorConfig
from . import init


def _ln32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """Channel LayerNorm computed in float32 (flax LayerNorm dtype=f32)."""
    return F.layer_norm(
        x.to(torch.float32), ln.normalized_shape, ln.weight.to(torch.float32),
        ln.bias.to(torch.float32), ln.eps,
    )


class RegBottleneck(nn.Module):
    """timm regnet.Bottleneck as the reference's RegStage builds it:
    bottle_ratio 1, depthwise 3x3, squeeze-excite with round(in_chs / 4)
    channels, channel LayerNorm, SiLU, 1x1 conv + LN shortcut on a channel
    change."""

    def __init__(self, in_chs: int, out_chs: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        rd = int(round(in_chs * 0.25))
        ln = lambda: nn.LayerNorm(out_chs, eps=1e-6, dtype=dtype)
        self.conv1 = nn.Linear(in_chs, out_chs, bias=False, dtype=dtype)
        self.conv1_ln = ln()
        self.conv2 = nn.Conv2d(
            out_chs, out_chs, 3, padding=1, groups=out_chs, bias=False, dtype=dtype
        )
        self.conv2_ln = ln()
        self.se_fc1 = nn.Linear(out_chs, rd, dtype=dtype)
        self.se_fc2 = nn.Linear(rd, out_chs, dtype=dtype)
        self.conv3 = nn.Linear(out_chs, out_chs, bias=False, dtype=dtype)
        self.conv3_ln = ln()
        self.downsample = self.downsample_ln = None
        if in_chs != out_chs:
            self.downsample = nn.Linear(in_chs, out_chs, bias=False, dtype=dtype)
            self.downsample_ln = ln()

    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in (self.conv1, self.se_fc1, self.se_fc2, self.conv3, self.downsample):
            if m is not None:
                init.linear_(m, gen)
        # depthwise kernel: fan_in = 3 * 3 * 1
        init.lecun_normal_(self.conv2.weight, 9, gen)
        for m in (self.conv1_ln, self.conv2_ln, self.conv3_ln, self.downsample_ln):
            if m is not None:
                init.norm_(m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, H, W, C]
        dt = self.dtype
        shortcut = x
        h = F.silu(_ln32(self.conv1_ln, self.conv1(x)).to(dt))
        h = self.conv2(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h = F.silu(_ln32(self.conv2_ln, h).to(dt))
        se = h.mean(dim=(1, 2), keepdim=True)
        se = self.se_fc2(F.silu(self.se_fc1(se)))
        h = h * torch.sigmoid(se)
        h = _ln32(self.conv3_ln, self.conv3(h)).to(dt)
        if self.downsample is not None:
            shortcut = _ln32(self.downsample_ln, self.downsample(shortcut)).to(dt)
        return F.silu(h + shortcut)


class RegStage(nn.Module):
    def __init__(self, depth: int, in_chs: int, out_chs: int, dtype: torch.dtype):
        super().__init__()
        self.blocks = nn.ModuleList(
            RegBottleneck(in_chs if i == 0 else out_chs, out_chs, dtype)
            for i in range(depth)
        )

    def reset_parameters(self, gen: torch.Generator) -> None:
        for blk in self.blocks:
            blk.reset_parameters(gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class STCConnector(nn.Module):
    """[B, T, N, D_enc] (N = grid² tokens per frame) → [B, T'·H'·W', D_llm]."""

    def __init__(self, cfg: ProjectorConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if cfg.projector_type != "stc_connector_v35":
            raise NotImplementedError(
                f"projector {cfg.projector_type!r}: only stc_connector_v35 is "
                "ported (ROADMAP.md queue 1)"
            )
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.hidden_size
        self.s1 = RegStage(cfg.depth, cfg.encoder_hidden_size, d, dtype)
        self.sampler = nn.Conv3d(d, d, cfg.downsample, stride=cfg.downsample, dtype=dtype)
        self.s2 = RegStage(cfg.depth, d, d, dtype)
        self.readout = nn.ModuleList(
            nn.Linear(d, d, dtype=dtype) for _ in range(cfg.mlp_depth)
        )

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.s1.reset_parameters(gen)
        w = self.sampler.weight
        init.lecun_normal_(w, w[0].numel(), gen)
        with torch.no_grad():
            self.sampler.bias.zero_()
        self.s2.reset_parameters(gen)
        for fc in self.readout:
            init.linear_(fc, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, n, c = x.shape
        hw = int(round(n ** 0.5))
        if hw * hw != n:
            raise ValueError(f"{n} tokens per frame is not a square grid")
        x = self.s1(x.reshape(b * t, hw, hw, c).to(self.dtype))
        x = x.reshape(b, t, hw, hw, -1)
        # Conv3d stride = kernel, padding 0: trailing odd rows are dropped
        x = self.sampler(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        x = F.silu(x)
        _, nt, nh, nw, d = x.shape
        x = self.s2(x.reshape(b * nt, nh, nw, d)).reshape(b, nt * nh * nw, d)
        x = self.readout[0](x)
        for fc in self.readout[1:]:
            x = fc(F.gelu(x, approximate="none"))  # torch nn.GELU(): exact erf
        return x
