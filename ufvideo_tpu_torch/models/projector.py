"""The vision-language connectors (mirrors ``ufvideo_tpu/models/projector.py``),
built by ``build_projector`` from the configuration's ``projector_type``:

- ``STCConnector``, the STC family: RegStage(depth) → a (t, h, w) sampler →
  SiLU → RegStage(depth) → MLP readout with exact-erf GELU. The sampler is a
  Conv3d, stride = kernel, padded by 1 on each axis for ``stc_connector`` and
  ``spatial_conv`` and by 0 for ``stc_connector_v35`` (the default: (2, 2, 2));
  ``stp_connector`` and ``spatial_pool`` average-pool the window instead (no
  padding). ``spatial_*`` keep every frame (dt 1) and have no RegStages.
- ``LinearProjector`` for ``linear`` / ``mlpNx_gelu``: the frames' mean, then
  ``fc0`` and [GELU, ``fc{2i}``] for i < N.

Activations stay NHWC / NDHWC, as in JAX. 1x1 convolutions are
``nn.Linear`` over channels; the depthwise 3x3 and the sampler are
``nn.Conv2d`` / ``nn.Conv3d`` (torch weight layouts) applied on permuted
views.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..configs import STC_TYPES, ProjectorConfig
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


def _readout(fcs: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """fc0, then [exact GELU, fc] for each further layer (torch
    ``Sequential(Linear, [GELU, Linear]*)``; ``nn.GELU()`` is erf's)."""
    x = fcs[0](x)
    for fc in fcs[1:]:
        x = fc(F.gelu(x, approximate="none"))
    return x


def _dense_stack(depth: int, d_in: int, d: int, dtype: torch.dtype) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(d_in if i == 0 else d, d, dtype=dtype) for i in range(depth))


class STCConnector(nn.Module):
    """[B, T, N, D_enc] (N = grid² tokens per frame) → [B, T'·H'·W', D_llm]
    for every STC-family type (``configs.STC_TYPES``)."""

    def __init__(self, cfg: ProjectorConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        t = cfg.projector_type
        if t not in STC_TYPES:
            raise ValueError(f"STCConnector builds {STC_TYPES}, not {t!r}")
        self.cfg = cfg
        self.dtype = dtype
        spatial = t in ("spatial_conv", "spatial_pool")
        depth = 0 if spatial else cfg.depth
        dt, dh, dw = cfg.downsample
        self.window = (1 if spatial else dt, dh, dw)
        self.pool = t in ("stp_connector", "spatial_pool")
        d, enc = cfg.hidden_size, cfg.encoder_hidden_size
        # the RegStages exist only where depth > 0
        self.s1 = RegStage(depth, enc, d, dtype) if depth else None
        width = d if depth else enc
        self.sampler = None
        if not self.pool:
            pad = 1 if t in ("stc_connector", "spatial_conv") else 0
            self.sampler = nn.Conv3d(width, d, self.window, stride=self.window, padding=pad,
                                     dtype=dtype)
            width = d
        self.s2 = RegStage(depth, d, d, dtype) if depth else None
        self.readout = _dense_stack(cfg.mlp_depth, width, d, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        if self.s1 is not None:
            self.s1.reset_parameters(gen)
        if self.sampler is not None:
            w = self.sampler.weight
            init.lecun_normal_(w, w[0].numel(), gen)
            with torch.no_grad():
                self.sampler.bias.zero_()
        if self.s2 is not None:
            self.s2.reset_parameters(gen)
        for fc in self.readout:
            init.linear_(fc, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, n, c = x.shape
        hw = int(round(n ** 0.5))
        if hw * hw != n:
            raise ValueError(f"{n} tokens per frame is not a square grid")
        x = x.reshape(b * t, hw, hw, c).to(self.dtype)
        if self.s1 is not None:
            x = self.s1(x)
        x = x.reshape(b, t, hw, hw, -1).permute(0, 4, 1, 2, 3)
        # stride = window: trailing rows that fill no window are dropped
        if self.pool:  # the window's mean in f32, rounded once
            x = F.avg_pool3d(x.float(), self.window, stride=self.window).to(self.dtype)
        else:
            x = self.sampler(x)
        x = F.silu(x).permute(0, 2, 3, 4, 1)
        _, nt, nh, nw, d = x.shape
        x = x.reshape(b * nt, nh, nw, d)
        if self.s2 is not None:
            x = self.s2(x)
        return _readout(self.readout, x.reshape(b, nt * nh * nw, d))


class LinearProjector(nn.Module):
    """``linear`` / ``mlpNx_gelu``: [B, T, N, D_enc] → the mean over T (f32
    sums of the working-type values, as JAX's mean of bf16 accumulates) →
    ``fc0`` and [exact GELU, ``fc{2i}``] → [B, N, D_llm]."""

    def __init__(self, cfg: ProjectorConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if not cfg.linear_layers:
            raise ValueError(f"LinearProjector builds linear / mlpNx_gelu, not "
                             f"{cfg.projector_type!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.fcs = _dense_stack(cfg.linear_layers, cfg.encoder_hidden_size, cfg.hidden_size,
                                dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for fc in self.fcs:
            init.linear_(fc, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).float().mean(dim=1).to(self.dtype)
        return _readout(self.fcs, x)


def build_projector(cfg: ProjectorConfig, dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    """The connector of ``cfg.projector_type`` (the JAX ``build_projector``;
    an unknown type raises)."""
    return (LinearProjector if cfg.linear_layers else STCConnector)(cfg, dtype)
