"""Training loop: stepping, checkpoints, resume, metrics log (mirrors
``ufvideo_tpu/train/trainer.py``), on one card or over a mesh.

``Trainer(mesh=)`` runs the sharded step (``train_step.make_train_step``'s
mesh form): each rank feeds its rows of every global batch
(``shard_order_for_process``), a checkpoint holds whole tensors in the
unsharded order (every rank gathers, rank 0 writes), so a checkpoint
written over R ranks resumes on one and the other way round, and rank 0
alone writes the log and rotates.

Grouped sampling, a separate projector learning rate, periodic checkpoints
with keep-N rotation, adapter-only artifacts when only the adapters are
saved, auto-resume and a per-step loss-dict log (``train_log.jsonl``).
``TrainConfig.lora`` trains PEFT LoRA adapters instead of the reference's
freezing policy (``train/lora.py``); its checkpoints hold the PEFT files
beside the state.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import time
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoints import latest_checkpoint, load_params, save_params
from ..configs import UFVideoConfig
from ..models.ufvideo import UFVideoModel
from ..parallel.partition import full_param, load_full, sharded_root
from .data import SupervisedVideoDataset, modality_length_groups
from .lora import (LoRAConfig, make_lora_train_step, merge_for_eval, non_lora_state_dict,
                   save_lora_checkpoint)
from .train_step import (TrainState, apply_freeze, freeze_mask, language_model_loss_fn,
                         make_optimizer, make_train_step, model_param_name)

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
                 loss_fn=None, mesh=None):
        """``loss_fn(model, batch, lora=None)``: default the CE loss;
        ``seg_step.segmentation_loss_fn`` adds the ``[SEG]`` mask loss.
        ``mesh``: a ``DeviceMesh`` (``parallel.create_mesh``) to shard the
        model and the step over."""
        self.model = model
        self.mesh = mesh
        self.rank0 = mesh is None or dist.get_rank() == 0
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
        placement = {} if mesh is None else {"mesh": mesh}
        if train_cfg.lora is not None:
            fns = make_lora_train_step(model, self.optimizer, train_cfg.lora, self.loss_fn,
                                       seed=train_cfg.seed, **placement)
        else:
            fns = make_train_step(model, self.optimizer, self.loss_fn, **placement)
        self.init_fn, self.step_fn = fns[:2]
        self.shard_state = fns[2] if mesh is not None else None

    # ---------------- state ----------------

    def init_state(self, lora=None) -> TrainState:
        """Freeze by the policy (or by LoRA's split) and start the optimizer.
        LoRA factors come from a generator seeded with ``seed`` on the
        model's device unless ``lora`` is given."""
        if self.tc.lora is not None:
            dev = next(self.model.parameters()).device
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.tc.seed)
            state = self.init_fn(gen, lora)
        else:
            if self.tc.frozen_modules:
                mask = freeze_mask(self.model, self.tc.frozen_modules,
                                   train_sam_mask_decoder=self.tc.train_mask_decoder)
            else:
                mask = {n: True for n, _ in self.model.named_parameters()}
            state = self.init_fn(apply_freeze(self.model, mask))
        return state if self.mesh is None else self.shard_state(state)

    def _tree(self, state: TrainState) -> dict:
        """The state as saved: whole tensors in the unsharded order (a
        gather on every rank over a mesh, kept on rank 0 alone)."""
        if self.mesh is None:
            return {"step": state.step, "params": state.params, "opt_state": state.opt_state}
        opt = state.opt_state
        return {"step": state.step, "params": self._whole_tensors(state.params),
                "opt_state": {"count": opt["count"], "mu": self._whole_tensors(opt["mu"]),
                              "nu": self._whole_tensors(opt["nu"])}}

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
            adapters = self._adapters()
            if self.mesh is None:
                load_params(ckpt, {"params": adapters})
            else:
                saved = load_params(ckpt)["params"]
                for n, t in adapters.items():
                    load_full(self.model, n, t, saved[n])
            if self.rank0:
                print(f"resumed adapter weights from {ckpt} "
                      "(adapter-only artifact: step/optimizer state restart at 0)")
            return state
        if self.mesh is None:
            tree = load_params(ckpt, self._tree(state))
        else:  # whole tensors in, this rank's parts kept
            tree = load_params(ckpt)
            opt = state.opt_state
            for group, tensors in (("params", state.params), ("mu", opt["mu"]),
                                   ("nu", opt["nu"])):
                saved = tree[group] if group == "params" else tree["opt_state"][group]
                for n, t in tensors.items():
                    load_full(self.model, model_param_name(n), t, saved[n])
        state.step = int(tree["step"])
        state.opt_state["count"] = int(tree["opt_state"]["count"])
        if self.rank0:
            print(f"resumed from {ckpt} at step {state.step}")
        return state

    # ---------------- checkpointing ----------------

    def save(self, state: TrainState) -> None:
        """Write ``checkpoint-{step}`` whole or not at all: the files go into
        ``checkpoint-{step}.tmp``, renamed into place once all are written,
        so a run killed mid-write leaves a directory that
        ``latest_checkpoint`` passes over. Over a mesh every rank joins the
        gathers, rank 0 keeps the tensors and writes the files a one-process
        run writes, the others wait."""
        if self.tc.tune_adapters_only:
            tree = {"params": self._whole_tensors(self._adapters())}
        else:
            tree = self._tree(state)
        with self._whole_root() as model:
            if self.rank0:
                self._write(state, tree, model)
        if self.mesh is not None:
            dist.barrier()

    def _write(self, state: TrainState, tree: dict, model: UFVideoModel) -> None:
        final = os.path.join(self.tc.output_dir, f"checkpoint-{state.step}")
        path = final + ".tmp"
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        save_params(path, tree)
        if self.tc.tune_adapters_only:
            from ..export import save_adapter_bins

            save_adapter_bins(path, model)
        elif self.tc.lora is not None:
            save_lora_checkpoint(path, state.lora, self.cfg, self.tc.lora,
                                 non_lora_state_dict(model))
        shutil.rmtree(final, ignore_errors=True)  # a second save at the same step
        os.replace(path, final)
        self._rotate()

    def _whole_tensors(self, tensors: dict) -> dict:
        """The whole tensors on rank 0's host, one at a time; every rank
        joins each gather, the others drop what they gathered (an empty
        dict there)."""
        if self.mesh is None:
            return tensors
        out = {}
        for n, t in tensors.items():
            whole = full_param(self.model, model_param_name(n), t)
            if self.rank0:
                out[n] = whole.cpu()
        return out

    @contextlib.contextmanager
    def _whole_root(self):
        """The model with the root unit's parameters whole on every rank
        (the towers' stems, projector, region encoder, ``text_fcs``, SAM2's
        heads: what the adapter and LoRA files read)."""
        root = sharded_root(self.model)
        if root is None:
            yield self.model
            return
        root.unshard()
        try:
            yield self.model
        finally:
            root.reshard()

    def export_hf(self, state: TrainState, path: str) -> None:
        """The trained model as a reference-loadable checkpoint
        (``export.save_hf_checkpoint``); a LoRA run's adapters are merged
        into the model first (in place). Over a mesh the model is gathered
        into a copy on rank 0's host (the other ranks drop each gathered
        tensor)."""
        from ..export import save_hf_checkpoint

        model = self.model
        if self.mesh is not None:
            whole = self._whole_tensors(dict(model.named_parameters()))
            if not self.rank0:
                dist.barrier()
                return
            whole.update({n: b.cpu() for n, b in model.named_buffers()})  # never sharded
            model = UFVideoModel.empty(self.cfg, "cpu", routing=self.model.routing)
            model.load_state_dict(whole)
        if self.tc.lora is not None:
            merge_for_eval(model, state, self.tc.lora)
        save_hf_checkpoint(path, model, self.cfg)
        if self.mesh is not None:
            dist.barrier()

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
        # rank 0 alone writes the log (the metrics are global on every rank)
        with open(self._log_path, "a") if self.rank0 else contextlib.nullcontext() as log:
            for batch in batches:
                if state.step >= max_steps:
                    break
                state, metrics = self.step_fn(state, batch, self.grad_hook)
                if log is not None and state.step % self.tc.log_steps == 0:
                    rec = {"step": state.step, "time": round(time.time() - t0, 2),
                           **{k: float(v) for k, v in metrics.items()}}
                    log.write(json.dumps(rec) + "\n")
                    log.flush()
                self.last_metrics = metrics
                if state.step % self.tc.save_steps == 0:
                    self.save(state)
        return state


def shard_order_for_process(order: Sequence[int], global_batch_size: int,
                            process_id: Optional[int] = None,
                            process_count: Optional[int] = None) -> List[int]:
    """A process's slice of a global sample order (the reference's
    DistributedSampler): every global batch of ``global_batch_size``
    consecutive samples is split process-contiguously, process p taking
    rows [p·local, (p+1)·local), so R processes consume exactly the batches
    one process would. Over a mesh pass the data rank and the number of data
    ranks (``parallel.mesh.axis_coordinate``); the defaults are the world's
    rank and size."""
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    if process_id is None:
        process_id = dist.get_rank() if dist.is_initialized() else 0
    if process_count == 1:
        return list(order)
    if global_batch_size % process_count != 0:
        raise ValueError(f"global batch {global_batch_size} % {process_count} processes")
    local = global_batch_size // process_count
    out: List[int] = []
    for i in range(0, len(order) - global_batch_size + 1, global_batch_size):
        out.extend(order[i + process_id * local:i + (process_id + 1) * local])
    return out


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
