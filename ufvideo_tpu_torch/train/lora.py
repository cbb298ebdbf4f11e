"""LoRA adapter training (mirrors ``ufvideo_tpu/train/lora.py``).

PEFT LoRA on the LLM's q_proj / v_proj (r 8, alpha 16, dropout 0.05: the
reference's settings) while the projector, the region encoder and the text
head stay trainable and are saved apart as ``non_lora_trainables``. Every
other parameter is frozen, SAM2's mask decoder included; gradients still
pass through it to the text head.

Two forms of the same adapters, as in the JAX package:

  - dropout 0: the parameter-space merge, the layer runs on
    W + (alpha / r)·[Aq·Bq | 0 | Av·Bv] (the form serving uses);
  - dropout > 0: PEFT's forward term, q / v += scale·(drop(h)·A)·B inside the
    decoder layers, with each step's dropout drawn from (seed, step) alone,
    so a resumed run draws what an unbroken one does.

The factors are float32 tensors, layer axis first: A [L, hidden, r], B
[L, r, out]. Checkpoints are PEFT's on-disk format (``adapter_config.json``,
``adapter_model.bin``, ``non_lora_trainables.bin``), which
``checkpoints.merge_lora_from_dir`` reads.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import torch

from ..configs import UFVideoConfig
from ..models.qwen2 import LoRATerm, fold_in, lora_qkv_delta
from ..models.ufvideo import UFVideoModel
from .train_step import AdamW, MeshStep, TrainState, language_model_loss_fn, run_step

# the non-LoRA modules that stay trainable in a LoRA finetune
NON_LORA_TRAINABLE = ("projector", "region", "text_fcs")
Factors = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    r: int = 8
    alpha: float = 16.0
    dropout: float = 0.05  # > 0: the forward-term step

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def init_lora_params(cfg: UFVideoConfig, lcfg: LoRAConfig, gen: torch.Generator) -> Factors:
    """PEFT's init on the generator's device: A uniform in ±1/sqrt(hidden)
    (kaiming-uniform), B zeros; q's A drawn first."""
    llm = cfg.llm
    L, h = llm.num_layers, llm.hidden_size
    qd = llm.num_heads * llm.head_dim
    kvd = llm.num_kv_heads * llm.head_dim
    bound = h ** -0.5
    dev = gen.device

    def a():
        return torch.empty((L, h, lcfg.r), device=dev).uniform_(-bound, bound, generator=gen)

    qa, va = a(), a()
    return {"q": {"a": qa, "b": torch.zeros((L, lcfg.r, qd), device=dev)},
            "v": {"a": va, "b": torch.zeros((L, lcfg.r, kvd), device=dev)}}


def lora_names(lora: Factors) -> Dict[str, torch.Tensor]:
    """The factors by flat name (``lora.q.a`` …), the optimizer's view."""
    return {f"lora.{m}.{k}": lora[m][k] for m in ("q", "v") for k in ("a", "b")}


@torch.no_grad()
def apply_lora(model: UFVideoModel, lora: Factors, lcfg: LoRAConfig) -> UFVideoModel:
    """Merge the adapters into the LLM's fused qkv weights in place: W ←
    W + (scale·[Aq·Bq | 0 | Av·Bv]) cast to W's dtype, the sum the
    parameter-space step trains through. Returns ``model``."""
    for i, layer in enumerate(model.llm.layers):
        w = layer.qkv_proj.weight
        nkv = layer.cfg.num_kv_heads * layer.cfg.head_dim
        w.add_(lora_qkv_delta(lora["q"]["a"][i], lora["q"]["b"][i], lora["v"]["a"][i],
                              lora["v"]["b"][i], nkv, lcfg.scale, w.dtype).t())
    return model


def split_trainable(model: UFVideoModel) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(frozen base, non-LoRA trainables): a disjoint split of the model's
    parameters by top-level module."""
    base, non_lora = {}, {}
    for name, p in model.named_parameters():
        (non_lora if name.split(".", 1)[0] in NON_LORA_TRAINABLE else base)[name] = p
    return base, non_lora


def merge_for_eval(model: UFVideoModel, state: TrainState, lcfg: LoRAConfig) -> UFVideoModel:
    """The effective model of a LoRA state: the model already holds the
    trained non-LoRA modules, so this merges the adapters (in place)."""
    return apply_lora(model, state.lora, lcfg)


def make_lora_train_step(model: UFVideoModel, optimizer: AdamW, lcfg: LoRAConfig,
                         loss_fn=None, seed: int = 0, *, mesh=None, batch_spec=None):
    """(init, step) like ``make_train_step``, but the optimizer sees only
    the LoRA factors and the non-LoRA trainables. ``init(gen, lora=None)``
    freezes the rest of the model and draws the factors from ``gen`` (or
    takes ``lora``). Dropout 0 trains through the merge, dropout > 0 the
    forward term with the step's masks drawn from ``fold_in(seed, step)``
    for the global batch.

    With ``mesh`` it returns (init, step, shard_state) as
    ``make_train_step`` does: the frozen base and the non-LoRA trainables
    are sharded over data / fsdp, the factors stay whole on every rank with
    their gradients summed over the data ranks (tensor and pipeline
    parallelism are refused: the merge adds to whole qkv rows, and the
    adapters run on the dense stack)."""
    loss_fn = loss_fn or language_model_loss_fn

    def init(gen: Optional[torch.Generator] = None, lora: Optional[Factors] = None) -> TrainState:
        model.requires_grad_(False)
        _, non_lora = split_trainable(model)
        lora = lora if lora is not None else init_lora_params(model.cfg, lcfg, gen)
        params = lora_names(lora)
        params.update({f"non_lora.{n}": p for n, p in non_lora.items()})
        for p in params.values():
            p.requires_grad_(True)
        return TrainState(0, params, optimizer.init(params), lora)

    def term(state: TrainState, rows=(0, 0)) -> LoRATerm:
        return LoRATerm(state.lora, lcfg.scale, lcfg.dropout, merge=lcfg.dropout == 0.0,
                        seed=fold_in(seed, state.step), rows=rows)

    if mesh is None:
        def step(state: TrainState, batch, grad_hook=None):
            return run_step(state, optimizer, lambda: loss_fn(model, batch, lora=term(state)),
                            grad_hook)

        return init, step

    placed = MeshStep(model, mesh, batch_spec)
    if placed.replicas > 1:
        raise ValueError("LoRA over a mesh shards over data / fsdp only: tensor and pipe "
                         "must be 1")

    def sharded_step(state: TrainState, batch, grad_hook=None):
        placed.check_rows(batch)
        b = batch[0].shape[0]
        lora = term(state, (placed.data_rank * b, placed.data_size * b))
        return placed.run(state, optimizer, lambda root: root(loss_fn, batch, lora=lora),
                          grad_hook)

    return init, sharded_step, placed.shard_state


# ---------------------------------------------------------------------------
# PEFT-format checkpoints
# ---------------------------------------------------------------------------

def non_lora_state_dict(model: UFVideoModel) -> Dict[str, torch.Tensor]:
    """The non-LoRA trainables under PEFT's keys (``base_model.model.`` +
    the reference's module paths), on the host."""
    from ..export import export_projector, export_region_encoder, export_text_hidden_fcs

    out = {}
    for prefix, part in (("model.mm_projector.", export_projector(model.projector)),
                         ("model.region_encoder.", export_region_encoder(model.region)),
                         ("model.", export_text_hidden_fcs(model.text_fcs))):
        out.update({"base_model.model." + prefix + k: v for k, v in part.items()})
    return out


def save_lora_checkpoint(
    out_dir: str,
    lora: Factors,
    cfg: UFVideoConfig,
    lcfg: LoRAConfig,
    non_lora_sd: Optional[Dict[str, torch.Tensor]] = None,
) -> None:
    """``adapter_config.json`` + ``adapter_model.bin`` (A as [r, in], B as
    [out, r] a layer, float32) + ``non_lora_trainables.bin`` when given."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump({
            "peft_type": "LORA",
            "r": lcfg.r,
            "lora_alpha": lcfg.alpha,
            "lora_dropout": lcfg.dropout,
            "target_modules": ["q_proj", "v_proj"],
            "bias": "none",
            "task_type": "CAUSAL_LM",
        }, f)
    sd = {}
    for name in ("q", "v"):
        a = lora[name]["a"].detach().float().cpu()
        b = lora[name]["b"].detach().float().cpu()
        for layer in range(a.shape[0]):
            key = f"base_model.model.model.layers.{layer}.self_attn.{name}_proj"
            sd[key + ".lora_A.weight"] = a[layer].t().contiguous()
            sd[key + ".lora_B.weight"] = b[layer].t().contiguous()
    torch.save(sd, os.path.join(out_dir, "adapter_model.bin"))
    if non_lora_sd:
        torch.save(dict(non_lora_sd), os.path.join(out_dir, "non_lora_trainables.bin"))
