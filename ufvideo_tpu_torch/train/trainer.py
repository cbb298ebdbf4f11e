"""Training loop on one device: stepping, checkpoints, resume, metrics log
(mirrors ``ufvideo_tpu/train/trainer.py``; one process on one card, the
multi-process sample sharding waits for the parallelism slice, ROADMAP.md).

Grouped sampling, a separate projector learning rate, periodic checkpoints
with keep-N rotation, adapter-only artifacts when only the adapters are
saved, auto-resume and a per-step loss-dict log (``train_log.jsonl``).
``TrainConfig.lora`` trains PEFT LoRA adapters instead of the reference's
freezing policy (``train/lora.py``); its checkpoints hold the PEFT files
beside the state.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Iterable, List, Optional

import numpy as np
import torch

from ..checkpoints import latest_checkpoint, load_params, save_params
from ..configs import UFVideoConfig
from ..models.ufvideo import UFVideoModel
from .data import SupervisedVideoDataset, modality_length_groups
from .lora import (LoRAConfig, make_lora_train_step, merge_for_eval, non_lora_state_dict,
                   save_lora_checkpoint)
from .train_step import (TrainState, apply_freeze, freeze_mask, language_model_loss_fn,
                         make_optimizer, make_train_step)

ADAPTERS = ("projector", "region")


@dataclass
class TrainConfig:
    output_dir: str = "checkpoints"
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    warmup_ratio: float = 0.03
    total_steps: int = 10_000
    global_batch_size: int = 8
    save_steps: int = 100
    save_total_limit: int = 4
    log_steps: int = 1
    grad_clip: float = 1.0
    group_by_modality_length: bool = True
    tune_adapters_only: bool = False
    # the reference's freezing policy: vision tower + SAM2 frozen
    frozen_modules: tuple = ("vision", "sam")
    # but SAM2's mask decoder trains (the reference's default)
    train_mask_decoder: bool = True
    seed: int = 0
    # PEFT LoRA on q / v instead of the policy above
    lora: Optional[LoRAConfig] = None


class Trainer:
    def __init__(self, model: UFVideoModel, cfg: UFVideoConfig, train_cfg: TrainConfig,
                 loss_fn=None):
        """``loss_fn(model, batch, lora=None)``: default the CE loss;
        ``seg_step.segmentation_loss_fn`` adds the ``[SEG]`` mask loss."""
        self.model = model
        self.cfg = cfg
        self.tc = train_cfg
        self.optimizer = make_optimizer(
            train_cfg.learning_rate, warmup_ratio=train_cfg.warmup_ratio,
            total_steps=train_cfg.total_steps, grad_clip=train_cfg.grad_clip,
            mm_projector_lr=train_cfg.mm_projector_lr)
        self.loss_fn = loss_fn or language_model_loss_fn
        self._log_path = os.path.join(train_cfg.output_dir, "train_log.jsonl")
        # called with each step's gradients by name, before the update
        self.grad_hook = None
        self.last_metrics = None
        if train_cfg.lora is not None:
            self.init_fn, self.step_fn = make_lora_train_step(
                model, self.optimizer, train_cfg.lora, self.loss_fn, seed=train_cfg.seed)
        else:
            self.init_fn, self.step_fn = make_train_step(model, self.optimizer, self.loss_fn)

    # ---------------- state ----------------

    def init_state(self, lora=None) -> TrainState:
        """Freeze by the policy (or by LoRA's split) and start the optimizer.
        LoRA factors come from a generator seeded with ``seed`` on the
        model's device unless ``lora`` is given."""
        if self.tc.lora is not None:
            dev = next(self.model.parameters()).device
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.tc.seed)
            return self.init_fn(gen, lora)
        if self.tc.frozen_modules:
            mask = freeze_mask(self.model, self.tc.frozen_modules,
                               train_sam_mask_decoder=self.tc.train_mask_decoder)
        else:
            mask = {n: True for n, _ in self.model.named_parameters()}
        return self.init_fn(apply_freeze(self.model, mask))

    def _tree(self, state: TrainState) -> dict:
        return {"step": state.step, "params": state.params, "opt_state": state.opt_state}

    def _adapters(self) -> dict:
        return {n: p for n, p in self.model.named_parameters()
                if n.split(".", 1)[0] in ADAPTERS}

    def maybe_resume(self, state: TrainState) -> TrainState:
        ckpt = latest_checkpoint(self.tc.output_dir)
        if ckpt is None:
            return state
        if self.tc.tune_adapters_only:
            # adapter-only artifacts hold the projector and region encoder:
            # the weights come back, the step and optimizer restart at 0
            load_params(ckpt, {"params": self._adapters()})
            print(f"resumed adapter weights from {ckpt} "
                  "(adapter-only artifact: step/optimizer state restart at 0)")
            return state
        tree = load_params(ckpt, self._tree(state))
        state.step = int(tree["step"])
        state.opt_state["count"] = int(tree["opt_state"]["count"])
        print(f"resumed from {ckpt} at step {state.step}")
        return state

    # ---------------- checkpointing ----------------

    def save(self, state: TrainState) -> None:
        """Write ``checkpoint-{step}`` whole or not at all: the files go into
        ``checkpoint-{step}.tmp``, renamed into place once all are written,
        so a run killed mid-write leaves a directory that
        ``latest_checkpoint`` passes over."""
        final = os.path.join(self.tc.output_dir, f"checkpoint-{state.step}")
        path = final + ".tmp"
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        if self.tc.tune_adapters_only:
            from ..export import save_adapter_bins

            save_params(path, {"params": self._adapters()})
            save_adapter_bins(path, self.model)
        else:
            save_params(path, self._tree(state))
            if self.tc.lora is not None:
                save_lora_checkpoint(path, state.lora, self.cfg, self.tc.lora,
                                     non_lora_state_dict(self.model))
        shutil.rmtree(final, ignore_errors=True)  # a second save at the same step
        os.replace(path, final)
        self._rotate()

    def export_hf(self, state: TrainState, path: str) -> None:
        """The trained model as a reference-loadable checkpoint
        (``export.save_hf_checkpoint``); a LoRA run's adapters are merged
        into the model first (in place)."""
        from ..export import save_hf_checkpoint

        if self.tc.lora is not None:
            merge_for_eval(self.model, state, self.tc.lora)
        save_hf_checkpoint(path, self.model, self.cfg)

    def _rotate(self) -> None:
        for d in os.listdir(self.tc.output_dir):  # what a killed save left
            if d.startswith("checkpoint-") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.tc.output_dir, d), ignore_errors=True)
        ckpts = sorted(
            (d for d in os.listdir(self.tc.output_dir)
             if d.startswith("checkpoint-") and d.split("-")[-1].isdigit()),
            key=lambda d: int(d.split("-")[-1]))
        while len(ckpts) > self.tc.save_total_limit:
            shutil.rmtree(os.path.join(self.tc.output_dir, ckpts.pop(0)), ignore_errors=True)

    # ---------------- loop ----------------

    def train(self, state: TrainState, batches: Iterable,
              max_steps: Optional[int] = None) -> TrainState:
        """Step through ``batches`` (on the model's device) up to
        ``max_steps`` (default ``total_steps``); each record of the log
        holds the step, the seconds since the start and every metric."""
        os.makedirs(self.tc.output_dir, exist_ok=True)
        max_steps = max_steps or self.tc.total_steps
        t0 = time.time()
        with open(self._log_path, "a") as log:
            for batch in batches:
                if state.step >= max_steps:
                    break
                state, metrics = self.step_fn(state, batch, self.grad_hook)
                if state.step % self.tc.log_steps == 0:
                    rec = {"step": state.step, "time": round(time.time() - t0, 2),
                           **{k: float(v) for k, v in metrics.items()}}
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                self.last_metrics = metrics
                if state.step % self.tc.save_steps == 0:
                    self.save(state)
        return state


def build_sample_order(dataset: SupervisedVideoDataset, tc: TrainConfig) -> List[int]:
    """Grouped sample order (the reference's grouped sampler). Length is the
    conversation's word count, the reference's modality-length proxy."""
    lengths = [
        sum(len(str(s.get("value", "")).split())
            for s in r.get("conversations", []) if isinstance(s, dict)) or 1
        for r in dataset.records
    ]
    modalities = [("video" in r or "image" in r) for r in dataset.records]
    if tc.group_by_modality_length:
        return modality_length_groups(lengths, modalities, tc.global_batch_size, seed=tc.seed)
    rng = np.random.RandomState(tc.seed)
    return list(rng.permutation(len(lengths)))
