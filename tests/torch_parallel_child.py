"""One rank of the port's multi-process CPU checks (gloo), for
``tests/test_torch_parallel.py``, ``tests/test_torch_ring_attention.py`` and
``tests/test_torch_pipeline.py``; not a test module, and it imports no JAX.

    python tests/torch_parallel_child.py <job> <rank> <world> <port> <input.pt> <out dir>

Ranks 0 and 1 meet through the JAX package's variables
(``UFVIDEO_NUM_PROCESSES`` / ``UFVIDEO_PROCESS_ID`` / ``UFVIDEO_COORDINATOR``),
the others through torchrun's (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT``): one rendezvous from both sets. Rank 0 writes
``<out>/<job>.pt``; every rank writes ``<out>/rank<r>.json``.

Jobs: ``parallel`` (the sharded [SEG] Trainer at (data 2, fsdp 2, tensor 1)
from the start, at (1, 2, 2) resumed from a one-process checkpoint and
exported, a tensor-parallel forward at (2, 1, 2), the LoRA step at
(2, 2, 1)) and
``ring`` (ring attention over a 4-rank axis, forward and backward, and the
CE and LoRA steps with the sequence over fsdp at (2, 2, 1)) and ``pipeline`` (the
GPipe backbone at (data 2, pipe 2): hidden states, gradients with and
without remat, and the [SEG] Trainer with the LLM pipelined).
"""

import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from ufvideo_tpu_torch.models.ufvideo import UFVideoModel  # noqa: E402
from ufvideo_tpu_torch.parallel.mesh import (P, axis_coordinate, create_mesh,  # noqa: E402
                                             maybe_initialize_distributed)
from ufvideo_tpu_torch.parallel.partition import full_param, shard_params  # noqa: E402
from ufvideo_tpu_torch.train.lora import LoRAConfig  # noqa: E402
from ufvideo_tpu_torch.train.seg_step import SegBatch, segmentation_loss_fn  # noqa: E402
from ufvideo_tpu_torch.train.train_step import Batch, model_param_name  # noqa: E402
from ufvideo_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402


def model_from(inp) -> UFVideoModel:
    model = UFVideoModel.empty(inp["cfg"], "cpu")
    model.load_state_dict(inp["state_dict"])
    return model


def rows_of(batch: dict, mesh, axes, cls):
    """This rank's rows of the global batch (process-contiguous)."""
    r, n = axis_coordinate(mesh, axes)
    b = next(iter(batch.values())).shape[0] // n
    return cls(**{k: torch.from_numpy(np.ascontiguousarray(batch[k][r * b:(r + 1) * b]))
                  for k in cls._fields if k in batch})


def train(inp, out, layout, name, resume=None, lora=None, steps=3, export=False):
    """The [SEG] Trainer over ``layout``; rank 0 returns the log records and
    the trained tensors gathered; ``export`` writes ``<out>/<name>_export``."""
    mesh = create_mesh(*layout, device="cpu")
    tc = TrainConfig(output_dir=os.path.join(out, name), learning_rate=inp["lr"],
                     warmup_ratio=inp["warmup_ratio"], total_steps=inp["total_steps"],
                     global_batch_size=4, save_steps=2, save_total_limit=2, lora=lora)
    if dist.get_rank() == 0 and resume is not None:
        shutil.copytree(resume, os.path.join(tc.output_dir, os.path.basename(resume)))
    dist.barrier()
    trainer = Trainer(model_from(inp), inp["cfg"], tc, loss_fn=segmentation_loss_fn, mesh=mesh)
    state = trainer.maybe_resume(trainer.init_state())
    batch = rows_of(inp["batch"], mesh, ("data", "fsdp"), SegBatch)
    state = trainer.train(state, [batch] * steps, max_steps=steps)
    params = {n: full_param(trainer.model, model_param_name(n), p).detach().clone()
              for n, p in state.params.items()}
    # the trained tensors each rank keeps of a save's gathers
    kept = [None] * dist.get_world_size()
    dist.all_gather_object(kept, len(trainer._tree(state)["params"]))
    if export:
        trainer.export_hf(state, os.path.join(out, f"{name}_export"))
    if dist.get_rank() != 0:
        return None
    with open(os.path.join(tc.output_dir, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    return {"log": log, "params": params if lora is None else None, "kept": kept}


def tp_forward(inp):
    """The LLM's logits under tensor parallelism over 2 ranks."""
    mesh = create_mesh(2, 1, 2, device="cpu")
    model = model_from(inp)
    root = shard_params(model, mesh)
    ids = torch.from_numpy(inp["tp_ids"])

    def logits(m, ids):
        b, s = ids.shape
        pos = torch.arange(s, dtype=torch.int32).expand(b, s)
        hidden, _ = m.llm.backbone(m.llm.embed(ids), pos, None, None, None, "train")
        return m.llm.logits(hidden)

    with torch.no_grad():
        return root(logits, ids)


def job_parallel(inp, out):
    res = {"A": train(inp, out, (2, 2, 1), "A"),
           "B": train(inp, out, (1, 2, 2), "B", resume=inp["ckpt1"], export=True),
           "tp_logits": tp_forward(inp),
           "lora": train(inp, out, (2, 2, 1), "lora", lora=LoRAConfig(), steps=2)}
    return res


def job_ring(inp, out):
    from ufvideo_tpu_torch.ops.ring_attention import ring_attention
    from ufvideo_tpu_torch.train import train_step as pts

    mesh = create_mesh(1, 4, 1, device="cpu")
    r, n = axis_coordinate(mesh, ("fsdp",))
    res = {}
    for case, (causal, lens) in inp["ring_cases"].items():
        q, k, v = (torch.from_numpy(inp[x]) for x in "qkv")
        c = q.shape[1] // n
        blocks = [t[:, r * c:(r + 1) * c].clone().requires_grad_(True) for t in (q, k, v)]
        o = ring_attention(*blocks, mesh, "fsdp", causal=causal,
                           kv_lens=None if lens is None else torch.tensor(lens))
        (o ** 2).sum().backward()
        parts = [o.detach()] + [t.grad for t in blocks]
        gathered = []
        for part in parts:
            bufs = [torch.empty_like(part) for _ in range(n)]
            dist.all_gather(bufs, part.contiguous())
            gathered.append(torch.cat(bufs, dim=1))
        res[case] = gathered

    # the CE step with the sequence over fsdp (ring of 2), the batch over data
    mesh = create_mesh(2, 2, 1, device="cpu")
    model = model_from(inp)
    model.llm.set_ring(mesh, "fsdp")
    opt = pts.make_optimizer(inp["lr"], warmup_ratio=inp["warmup_ratio"],
                             total_steps=inp["total_steps"])
    trainable = pts.apply_freeze(model, pts.freeze_mask(model))
    init, step, shard_state = pts.make_train_step(model, opt, mesh=mesh, batch_spec=P("data"))
    state = shard_state(init(trainable))
    batch = rows_of(inp["batch"], mesh, ("data",), Batch)
    metrics = []
    for _ in range(3):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    res["ring_step"] = metrics

    # the LoRA step on the same layout: its dropout masks are the global
    # batch's, cut to this rank's rows and block of positions
    from ufvideo_tpu_torch.train.lora import LoRAConfig, make_lora_train_step

    model = model_from(inp)
    model.llm.set_ring(mesh, "fsdp")
    init, step, shard_state = make_lora_train_step(model, opt, LoRAConfig(), mesh=mesh,
                                                   batch_spec=P("data"))
    state = shard_state(init(torch.Generator().manual_seed(0)))
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    res["ring_lora_step"] = metrics
    return res


def job_pipeline(inp, out):
    """(data 2, pipe 2): the pipelined backbone's hidden states for M = 2
    and 4, its gradients with and without remat (every layer's summed over
    the stages, every tensor over the data ranks), and the [SEG] Trainer
    with the LLM pipelined."""
    from ufvideo_tpu_torch.models.qwen2 import Qwen2LM
    from ufvideo_tpu_torch.parallel.pipeline import pipeline_backbone
    from ufvideo_tpu_torch.weights import load_qwen2

    mesh = create_mesh(2, 1, 1, pp=2, device="cpu")
    pipe, data = mesh.get_group("pipe"), mesh.get_group("data")
    r, n = axis_coordinate(mesh, ("data",))
    lm = Qwen2LM(inp["lm_cfg"], dtype=torch.float32)
    load_qwen2(lm, inp["lm_params"])
    embeds = torch.from_numpy(inp["embeds"])
    b, s = embeds.shape[:2]
    rows = slice(r * b // n, (r + 1) * b // n)
    pos = torch.arange(s, dtype=torch.int32).expand(b // n, s)
    res = {}

    def gather(t):
        bufs = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(bufs, t.contiguous(), group=data)
        return torch.cat(bufs)

    for m in (2, 4):
        with torch.no_grad():
            h = pipeline_backbone(lm, embeds[rows], pos, None, mesh, num_microbatches=m)
        res[f"hidden_m{m}"] = gather(h)
    for remat in (False, True):
        lm.zero_grad(set_to_none=True)
        h = pipeline_backbone(lm, embeds[rows], pos, None, mesh, num_microbatches=2,
                              remat=remat)
        ((h * h).sum() / (b * s * h.shape[-1])).backward()
        grads = {}
        for name, p in lm.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if name.startswith("layers."):
                dist.all_reduce(g, group=pipe)
            dist.all_reduce(g, group=data)
            grads[name] = g.clone()
        res[f"grads_remat{int(remat)}"] = grads

    # the [SEG] Trainer at (data 2, pipe 2), the LLM's two layers pipelined,
    # one a stage; checkpoint-2 gathers each layer from its stage
    tc = TrainConfig(output_dir=os.path.join(out, "pp"), learning_rate=inp["lr"],
                     warmup_ratio=inp["warmup_ratio"], total_steps=inp["total_steps"],
                     global_batch_size=4, save_steps=2)
    model = model_from(inp)
    model.llm.set_pipeline(mesh, "pipe", 2)
    trainer = Trainer(model, inp["cfg"], tc, loss_fn=segmentation_loss_fn, mesh=mesh)
    batch = rows_of(inp["batch"], mesh, ("data", "fsdp"), SegBatch)
    trainer.train(trainer.init_state(), [batch] * 3, max_steps=3)
    held = [i for i, layer in enumerate(model.llm.layers)
            if not next(layer.parameters()).is_meta]
    held_all = [None] * dist.get_world_size()
    dist.all_gather_object(held_all, held)
    if dist.get_rank() == 0:
        with open(os.path.join(tc.output_dir, "train_log.jsonl")) as f:
            res["pp_log"] = [json.loads(line) for line in f]
        res["pp_held"] = held_all
    return res


def main():
    job, rank, world, port, inp_path, out = sys.argv[1:7]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if rank < 2:
        os.environ.update(UFVIDEO_NUM_PROCESSES=str(world), UFVIDEO_PROCESS_ID=str(rank),
                          UFVIDEO_COORDINATOR=f"127.0.0.1:{port}")
    else:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=port, LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    distributed = maybe_initialize_distributed(device="cpu")
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"distributed": distributed, "rank": dist.get_rank(),
                   "world": dist.get_world_size(), "backend": dist.get_backend(),
                   "jax_imported": "jax" in sys.modules}, f)
    inp = torch.load(inp_path, weights_only=False)
    res = {"parallel": job_parallel, "ring": job_ring, "pipeline": job_pipeline}[job](inp, out)
    if rank == 0:
        torch.save(res, os.path.join(out, f"{job}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
