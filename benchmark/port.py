"""Everything the benchmark takes from the program under test
(``ufvideo_tpu_torch``): its configuration type, its checkpoint loader, its
runtime, its serving engine and the engine's counters. Nothing else of the
benchmark imports the program.

The runtime is built the way ``api.model_init`` builds it from a checkpoint:
``checkpoints.convert_full_checkpoint`` writes the benchmark's state dict into
``UFVideoModel.empty`` on the device (quantising each layer as it is written
for a quantised configuration), with the byte tokenizer's special ids in the
configuration."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ufvideo_tpu_torch import configs as port_configs
from ufvideo_tpu_torch.api import UFVideoRuntime
from ufvideo_tpu_torch.checkpoints import convert_full_checkpoint
from ufvideo_tpu_torch.engine import StreamingEngine
from ufvideo_tpu_torch.tokenization import ByteTokenizer, byte_tokenizer_with_ids

CHAR_BASE = 0x10000  # a served token's character: chr(CHAR_BASE + id)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TokenCharTokenizer(ByteTokenizer):
    """The byte tokenizer (same vocabulary, same ids, same encoding) with a
    decode that gives every id one character of its own, special ids too:
    a stream's text is then its token ids, one per character, so the client
    knows how many tokens each streamed delta carries and which. The byte
    tokenizer itself decodes every id above the byte range to nothing, which
    random weights emit almost always; a served model's tokenizer decodes
    every token to text."""

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        return "".join(chr(CHAR_BASE + int(i)) for i in ids)


def text_ids(text: str):
    return [ord(c) - CHAR_BASE for c in text]


def port_config(model: Dict[str, Any], overrides: Dict[str, Any] = None):
    """``configs/<name>.json``'s ``model`` (with ``overrides`` on its top
    level: a control's quantisation) → the program's ``UFVideoConfig``."""
    m = dict(model, **(overrides or {}))
    dtype = _DTYPES[m["dtype"]]
    proj = dict(m["projector"], downsample=tuple(m["projector"]["downsample"]))
    return port_configs.UFVideoConfig(
        vision=port_configs.SiglipVisionConfig(**m["vision"]),
        llm=port_configs.Qwen2Config(**m["llm"]),
        projector=port_configs.ProjectorConfig(**proj),
        region=port_configs.RegionEncoderConfig(**m["region"]),
        budget=port_configs.MultimodalBudget(**m["budget"]),
        sam_out_dim=m["sam_out_dim"], compute_dtype=dtype, param_dtype=dtype,
        quant_llm=m["quant_llm"], quant_kv=bool(m["quant_kv"]),
        quant_vision=bool(m["quant_vision"]))


def config_dict(cfg) -> Dict[str, Any]:
    """The other way: a ``UFVideoConfig`` → the ``model`` dict (tests build
    the small configuration so)."""
    d = {k: dataclasses.asdict(getattr(cfg, k))
         for k in ("vision", "llm", "projector", "region", "budget")}
    d["llm"] = {k: v for k, v in d["llm"].items() if k != "remat"}
    d["projector"]["downsample"] = list(d["projector"]["downsample"])
    inv = {v: k for k, v in _DTYPES.items()}
    return dict(d, sam_out_dim=cfg.sam_out_dim, dtype=inv[cfg.compute_dtype],
                quant_llm=cfg.quant_llm, quant_kv=cfg.quant_kv, quant_vision=cfg.quant_vision)


def build_kernels() -> None:
    """Compile the program's CUDA sources together, before their first use
    would compile them one at a time (a no-op once built; without the
    program's build module each kernel still builds on its first use)."""
    try:
        from ufvideo_tpu_torch._build import build
    except ImportError:
        return
    build()


def build_runtime(model: Dict[str, Any], state_dict, device, overrides=None):
    """(runtime, tokenizer) with the state dict's weights on ``device``."""
    _, ids = byte_tokenizer_with_ids()
    cfg = port_config(model, overrides).replace(
        region_token_id=ids.region, seg_token_id=ids.seg,
        temporal_token_start_id=ids.temporal_start)
    net = convert_full_checkpoint(state_dict, cfg, device=device)
    return UFVideoRuntime(cfg, net, ids, torch.device(device)), TokenCharTokenizer()


def make_engine(rt, tokenizer, engine: Dict[str, Any]) -> StreamingEngine:
    return StreamingEngine(rt, tokenizer, **engine)

