"""Plain float32 reference of video QA in UFVideo-7B: frames → bicubic resize
and normalisation → SigLIP-SO400M up to the ``hidden_states[-2]`` tap → the
STC-v35 connector → the video tokens spliced into the prompt → Qwen2 over the
prompt and the served tokens → logits at the served tokens' positions.

Plain PyTorch in float32 with TF32 off (``fp32_matmuls``), no kernels, no
cache, no batching of unequal rows; it reads the benchmark's state dict
(``checkpoint.py``) and works out for itself what the program derives: the
resized frames, the splice positions, and, for a quantised configuration,
the int8 weights and scales, the W8A8 tower's row quantisation and the int8
cache's per-position scales. Each layer's weights are cast to float32 when
the layer runs, so the float copy of the model never exists whole.

A quantised configuration is reproduced as the program defines it:
- ``quant_llm`` int8: every projection of the LLM and ``lm_head`` on
  weights rounded per output column to int8 (scale = max(amax / 127, 1e-8)
  over the input axis, of the weights as stored);
- ``quant_vision``: each SigLIP dense product on int8 weights (as above) and
  int8 rows of its input (scale = max(amax / 127, 1e-8) over the row), the
  rows taken from the float LayerNorm outputs, the attention output and the
  GELU output;
- ``quant_kv``: the prompt attends its own float keys and values (the
  prefill); every served position attends keys and values rounded per
  position and head to int8 (scale = amax / 127).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .checkpoint import encode_layers
from .prompt import VIDEO, prompt_ids

F32 = torch.float32
SIGLIP_PREFIX = "model.vision_tower.vision_tower.vision_model"
STC_PREFIX = "model.mm_projector"


@contextlib.contextmanager
def fp32_matmuls():
    """float32 products computed in float32: TF32 off for matmuls and
    convolutions while the reference runs, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


# ---------------------------------------------------------------- frames --

def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic kernel with a = -0.5 at distance ``x`` >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x < 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))


def resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] bicubic resampling of one axis: half-pixel centres, the
    kernel widened by the shrink factor (antialias), each output's weights
    normalised to sum 1."""
    scale = n_in / n_out
    widen = max(scale, 1.0)
    centre = (torch.arange(n_out, dtype=F32, device=device) + 0.5) * scale - 0.5
    dist = (centre[None, :] - torch.arange(n_in, dtype=F32, device=device)[:, None]).abs()
    w = _keys_cubic(dist / widen)
    return w / w.sum(dim=0, keepdim=True)


def preprocess(frames_u8: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 [T, H, W, 3] → [T, size, size, 3]: resized, rounded and clamped
    to the byte range, scaled to [0, 1], normalised with mean = std = 0.5."""
    x = frames_u8.to(F32)
    _, h, w, _ = x.shape
    if h != size:
        x = torch.einsum("thwc,hH->tHwc", x, resize_matrix(h, size, x.device))
    if w != size:
        x = torch.einsum("thwc,wW->thWc", x, resize_matrix(w, size, x.device))
    x = torch.clamp(torch.round(x), 0.0, 255.0) / 255.0
    return (x - 0.5) / 0.5


# ----------------------------------------------------------- quantisers --

def int8_weight(w: torch.Tensor) -> torch.Tensor:
    """[out, in] weight → its int8 rounding per output row, in float32."""
    wf = w.to(F32)
    scale = (wf.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(wf / scale).clamp(-127, 127) * scale


def int8_rows(x: torch.Tensor) -> torch.Tensor:
    """Activation rows → their int8 rounding per row, in float32."""
    scale = (x.abs().amax(dim=-1, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(x / scale) * scale


def int8_positions(x: torch.Tensor) -> torch.Tensor:
    """Keys or values [..., D] → their int8 rounding per position and head."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    return torch.round(x / scale.clamp_min(1e-12)) * scale


def _linear(x, w, b=None, quant_w=False, quant_x=False):
    w = int8_weight(w) if quant_w else w.to(F32)
    if quant_x:
        x = int8_rows(x)
    y = x @ w.t()
    return y if b is None else y + b.to(F32)


def _layer_norm(x, sd, name, eps):
    return F.layer_norm(x, (x.shape[-1],), sd[f"{name}.weight"].to(F32),
                        sd[f"{name}.bias"].to(F32), eps)


# --------------------------------------------------------------- SigLIP --

def siglip(pixels: torch.Tensor, sd: Dict[str, torch.Tensor], vision: dict,
           quant: bool) -> torch.Tensor:
    """[T, S, S, 3] normalised frames → [T, grid², hidden] features of the
    tap layer."""
    p, c, heads = vision["patch_size"], vision["hidden_size"], vision["num_heads"]
    eps, hd = vision["layer_norm_eps"], c // heads
    pre = SIGLIP_PREFIX
    x = F.conv2d(pixels.permute(0, 3, 1, 2), sd[f"{pre}.embeddings.patch_embedding.weight"].to(F32),
                 sd[f"{pre}.embeddings.patch_embedding.bias"].to(F32), stride=p)
    t = x.shape[0]
    x = x.flatten(2).transpose(1, 2)  # [T, N, C], row-major patches
    x = x + sd[f"{pre}.embeddings.position_embedding.weight"].to(F32)[None]
    n = x.shape[1]
    for i in range(encode_layers(vision)):
        lp = f"{pre}.encoder.layers.{i}"
        lin = lambda h, name: _linear(h, sd[f"{lp}.{name}.weight"], sd[f"{lp}.{name}.bias"],
                                      quant, quant)
        h = _layer_norm(x, sd, f"{lp}.layer_norm1", eps)
        q, k, v = (lin(h, f"self_attn.{m}").view(t, n, heads, hd).transpose(1, 2)
                   for m in ("q_proj", "k_proj", "v_proj"))
        probs = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
        o = (probs @ v).transpose(1, 2).reshape(t, n, c)
        x = x + lin(o, "self_attn.out_proj")
        h = _layer_norm(x, sd, f"{lp}.layer_norm2", eps)
        h = F.gelu(lin(h, "mlp.fc1"), approximate="tanh")
        x = x + lin(h, "mlp.fc2")
    return x


# -------------------------------------------------------------- STC-v35 --

def _chan_ln(x, sd, name):
    return _layer_norm(x, sd, name, 1e-6)


def _conv1x1(x, sd, name, bias=False):
    w = sd[f"{name}.weight"].to(F32)
    y = x @ w.reshape(w.shape[0], -1).t()
    return y + sd[f"{name}.bias"].to(F32) if bias else y


def _reg_block(x: torch.Tensor, sd, name: str) -> torch.Tensor:
    """timm RegNet bottleneck on NHWC: 1x1 → LN → SiLU, depthwise 3x3 → LN →
    SiLU, squeeze-excite (mean → 1x1 → SiLU → 1x1 → sigmoid gate), 1x1 →
    LN, plus the shortcut (1x1 + LN where the width changes), SiLU."""
    h = F.silu(_chan_ln(_conv1x1(x, sd, f"{name}.conv1.conv"), sd, f"{name}.conv1.bn"))
    dw = sd[f"{name}.conv2.conv.weight"].to(F32)
    h = F.conv2d(h.permute(0, 3, 1, 2), dw, padding=1, groups=dw.shape[0]).permute(0, 2, 3, 1)
    h = F.silu(_chan_ln(h, sd, f"{name}.conv2.bn"))
    se = h.mean(dim=(1, 2), keepdim=True)
    se = _conv1x1(F.silu(_conv1x1(se, sd, f"{name}.se.fc1", True)), sd, f"{name}.se.fc2", True)
    h = h * torch.sigmoid(se)
    h = _chan_ln(_conv1x1(h, sd, f"{name}.conv3.conv"), sd, f"{name}.conv3.bn")
    if f"{name}.downsample.conv.weight" in sd:
        x = _chan_ln(_conv1x1(x, sd, f"{name}.downsample.conv"), sd, f"{name}.downsample.bn")
    return F.silu(h + x)


def stc_connector(feats: torch.Tensor, sd, proj: dict) -> torch.Tensor:
    """[T, N, C_enc] features of one video → [T'·H'·W', hidden] video tokens:
    RegStage → Conv3d sampler (stride = kernel, no padding) → SiLU →
    RegStage → Linear, exact GELU, Linear."""
    t, n, _ = feats.shape
    g = math.isqrt(n)
    pre = STC_PREFIX
    x = feats.reshape(t, g, g, -1)
    for i in range(proj["depth"]):
        x = _reg_block(x, sd, f"{pre}.s1.b{i + 1}")
    x = F.conv3d(x.permute(3, 0, 1, 2)[None], sd[f"{pre}.sampler.0.weight"].to(F32),
                 sd[f"{pre}.sampler.0.bias"].to(F32), stride=tuple(proj["downsample"]))
    x = F.silu(x[0]).permute(1, 2, 3, 0)  # [T', H', W', D]
    for i in range(proj["depth"]):
        x = _reg_block(x, sd, f"{pre}.s2.b{i + 1}")
    x = x.reshape(-1, x.shape[-1])
    for i in range(proj["mlp_depth"]):
        if i:
            x = F.gelu(x, approximate="none")
        x = _linear(x, sd[f"{pre}.readout.{2 * i}.weight"], sd[f"{pre}.readout.{2 * i}.bias"])
    return x


def video_token_count(model: dict) -> int:
    """Video tokens of one video: the sampler's (t, h, w) grid, stride =
    kernel, trailing rows that fill no window dropped."""
    g = model["vision"]["image_size"] // model["vision"]["patch_size"]
    dt, dh, dw = model["projector"]["downsample"]
    return (model["budget"]["num_frames"] // dt) * (g // dh) * (g // dw)


def video_tokens(frames_u8: torch.Tensor, sd, model: dict) -> torch.Tensor:
    """uint8 [T, H, W, 3] → [V, hidden] video tokens."""
    pixels = preprocess(frames_u8, model["vision"]["image_size"])
    feats = siglip(pixels, sd, model["vision"], bool(model["quant_vision"]))
    return stc_connector(feats, sd, model["projector"])


# ---------------------------------------------------------------- Qwen2 --

def _rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w.to(F32)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split rotary embedding of [S, heads, D] at positions 0..S-1."""
    s, _, d = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=F32, device=x.device) / d)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, rows: slice) -> torch.Tensor:
    """Causal attention of query rows ``rows`` over keys up to each row;
    q [S, Hq, D], k / v [S, Hkv, D] → [len(rows), Hq·D]."""
    hq, hkv, d = q.shape[1], k.shape[1], q.shape[2]
    qr = q[rows].transpose(0, 1)  # [Hq, R, D]
    kk = k.repeat_interleave(hq // hkv, dim=1).transpose(0, 1)
    vv = v.repeat_interleave(hq // hkv, dim=1).transpose(0, 1)
    scores = (qr @ kk.transpose(-1, -2)) * d ** -0.5
    pos = torch.arange(k.shape[0], device=q.device)
    qpos = torch.arange(rows.start, rows.stop, device=q.device)
    scores = scores.masked_fill(pos[None, None, :] > qpos[None, :, None], float("-inf"))
    return (torch.softmax(scores, dim=-1) @ vv).transpose(0, 1).reshape(len(qpos), hq * d)


def _rows_in_chunks(fn, x: torch.Tensor, rows: int = 8192) -> torch.Tensor:
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def qwen2_logits(embeds: Sequence[torch.Tensor], prompt_lens: Sequence[int],
                 sd: Dict[str, torch.Tensor], llm: dict, quant_llm, quant_kv: bool
                 ) -> List[torch.Tensor]:
    """Each sequence [S_i, hidden] (its prompt, then its served tokens but
    the last) → logits [S_i - P_i + 1, vocab] at positions P_i - 1 ..
    S_i - 1: the prediction of each served token."""
    if quant_llm not in (False, None, "int8", True, 8):
        raise ValueError(f"the reference runs bf16 or int8 weights, not {quant_llm!r}")
    qw = bool(quant_llm)
    hq, hkv, hd = llm["num_heads"], llm["num_kv_heads"], llm["head_dim"]
    eps, theta = llm["rms_norm_eps"], llm["rope_theta"]
    lens = [int(e.shape[0]) for e in embeds]
    x = torch.cat([e.to(F32) for e in embeds])
    for i in range(llm["num_layers"]):
        p = f"model.layers.{i}"
        w = {m: (int8_weight if qw else lambda t: t.to(F32))(sd[f"{p}.{m}.weight"])
             for m in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                       "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj", "mlp.down_proj")}
        h = _rms_norm(x, sd[f"{p}.input_layernorm.weight"], eps)
        q, k, v = (h @ w[f"self_attn.{m}_proj"].t() + sd[f"{p}.self_attn.{m}_proj.bias"].to(F32)
                   for m in "qkv")
        outs, off = [], 0
        for n, plen in zip(lens, prompt_lens):
            qi = _rope(q[off:off + n].view(n, hq, hd), theta)
            ki = _rope(k[off:off + n].view(n, hkv, hd), theta)
            vi = v[off:off + n].view(n, hkv, hd)
            if quant_kv:  # the prompt attends float k / v, served positions the int8 cache
                outs += [_attend(qi, ki[:plen], vi[:plen], slice(0, plen)),
                         _attend(qi, int8_positions(ki), int8_positions(vi), slice(plen, n))]
            else:
                outs.append(_attend(qi, ki, vi, slice(0, n)))
            off += n
        del q, k, v
        x = x + torch.cat(outs) @ w["self_attn.o_proj"].t()
        h = _rms_norm(x, sd[f"{p}.post_attention_layernorm.weight"], eps)
        x = x + _rows_in_chunks(
            lambda r: (F.silu(r @ w["mlp.gate_proj"].t()) * (r @ w["mlp.up_proj"].t()))
            @ w["mlp.down_proj"].t(), h)
        del w, h
    out, off = [], 0
    head = int8_weight(sd["lm_head.weight"]) if qw else sd["lm_head.weight"].to(F32)
    for n, plen in zip(lens, prompt_lens):
        last = _rms_norm(x[off + plen - 1:off + n], sd["model.norm.weight"], eps)
        out.append(last @ head.t())
        off += n
    return out


def splice(question: str, served: Sequence[int], vtokens: torch.Tensor, sd) -> tuple:
    """The sequence the LLM reads: the prompt's text embeddings with the video
    tokens at the ``<video>`` tag, then the served tokens but the last (each
    is predicted from the positions before it) → ([S, hidden], prompt length)."""
    ids = prompt_ids(question)
    at = ids.index(VIDEO)
    table = sd["model.embed_tokens.weight"]
    emb = lambda t: table[torch.as_tensor(t, dtype=torch.long, device=table.device)].to(F32)
    parts = [emb(ids[:at]), vtokens.to(F32), emb(ids[at + 1:])]
    plen = sum(int(t.shape[0]) for t in parts)
    if len(served) > 1:
        parts.append(emb(list(served[:-1])))
    return torch.cat(parts), plen


def served_logits(requests: Sequence[dict], sd, model: dict) -> List[torch.Tensor]:
    """Each request ``{"frames": uint8 [T, H, W, 3] tensor, "question": str,
    "served": [token ids]}`` → logits [len(served), vocab] predicting each
    served token from the prompt and the served tokens before it."""
    with fp32_matmuls(), torch.no_grad():
        seqs, plens = [], []
        for r in requests:
            vt = video_tokens(r["frames"], sd, model)
            seq, plen = splice(r["question"], r["served"], vt, sd)
            seqs.append(seq)
            plens.append(plen)
            del vt
        return qwen2_logits(seqs, plens, sd, model["llm"], model["quant_llm"],
                            bool(model["quant_kv"]))
