"""Training launcher (the port of ``scripts/train.py``): the reference's
knobs (data path mix, lr / projector lr, warmup ratio, frames, save cadence,
gradient checkpointing), plus PEFT LoRA at the reference's r 8, alpha 16,
dropout 0.05 (``--lora``), on one card or over a mesh of them::

    python -m ufvideo_tpu_torch.train --data-paths a.json b.json \\
        --video-root data/ --model-path <hf checkpoint> \\
        --sam-path sam2_hiera_large.pt --output-dir checkpoints/run1

    # smoke: random tiny weights on the CPU
    python -m ufvideo_tpu_torch.train --tiny --device cpu \\
        --data-paths data.json --video-root data/ --global-batch-size 2 \\
        --total-steps 1

    # N cards: one process a card, the JAX launcher's mesh options
    python -m torch.distributed.run --nproc_per_node N -m ufvideo_tpu_torch.train \\
        --fsdp -1 --tp 1 --data-paths a.json --video-root data/ ...

Batches with a SAM branch train the ``[SEG]`` loss, the others the CE loss.
Under ``torch.distributed.run`` (or the JAX package's ``UFVIDEO_NUM_PROCESSES``
/ ``UFVIDEO_PROCESS_ID`` / ``UFVIDEO_COORDINATOR``) each process joins the
rendezvous (NCCL on the cards, gloo with ``--device cpu``; a world larger
than the cards this host can see raises), builds the (data, fsdp, tensor)
mesh of ``--dp --fsdp --tp`` (the JAX launcher's defaults: 1, -1 = the
rest, 1) and trains the sharded Trainer on its rows of each global batch;
a mesh that does not cover the world raises, naming both. A world of one
with every axis 1 trains the unsharded step, as without the launcher. ``--pp`` above 1
adds a ``pipe`` axis and runs the LLM's layers as the GPipe schedule in
``--microbatches`` microbatches (default 2 × stages; the global batch over
the microbatches must divide the data axes). It runs on the card unless
``--device cpu`` is given; the package is not installed, so run it from the
checkout's root.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m ufvideo_tpu_torch.train",
                                description="train UFVideo on one card or a mesh of them")
    p.add_argument("--data-paths", nargs="+", required=True)
    p.add_argument("--video-root", default="")
    p.add_argument("--model-path", default="")
    p.add_argument("--sam-path", default="")
    p.add_argument("--tokenizer-path", default="")
    p.add_argument("--output-dir", default="checkpoints/run")
    p.add_argument("--learning-rate", type=float, default=2e-5)
    p.add_argument("--mm-projector-lr", type=float, default=None)
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--global-batch-size", type=int, default=8)
    p.add_argument("--total-steps", type=int, default=10_000)
    p.add_argument("--save-steps", type=int, default=100)
    p.add_argument("--save-total-limit", type=int, default=4)
    p.add_argument("--num-frames", type=int, default=0, help="0: the config's (32)")
    p.add_argument("--num-frames-sam", type=int, default=0, help="0: the config's (4)")
    p.add_argument("--tune-adapters-only", action="store_true")
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--no-gradient-checkpointing", action="store_true",
                   help="keep every layer's activations (the reference trains with "
                        "gradient checkpointing)")
    p.add_argument("--lora", action="store_true",
                   help="PEFT LoRA on q / v (r 8, alpha 16, dropout 0.05)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true", help="random tiny-config weights")
    p.add_argument("--device", default="cuda",
                   help="where the model trains: the card unless 'cpu' is given")
    p.add_argument("--dp", type=int, default=1, help="data-parallel ranks")
    p.add_argument("--fsdp", type=int, default=-1,
                   help="ranks sharding parameters, gradients and moments (-1: the rest)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel ranks")
    p.add_argument("--pp", type=int, default=1,
                   help="pipeline stages: the LLM's layers run as a GPipe schedule over a "
                        "'pipe' mesh axis; the layer count must divide by it")
    p.add_argument("--microbatches", type=int, default=0,
                   help="pipeline microbatches (default: 2x pipeline stages; the global "
                        "batch must divide by it)")
    args = p.parse_args(argv)
    if args.pp > 1 and args.lora:
        p.error("--lora trains on the dense stack: it takes no --pp")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch.distributed as dist

    from ..parallel.mesh import (axis_coordinate, axis_sizes, create_mesh, local_rank,
                                 maybe_initialize_distributed, mesh_layout)

    layout = (args.dp, args.fsdp, args.tp)
    try:  # before the rendezvous: a layout that cannot cover the world stops here
        mesh_layout(*layout, pp=args.pp, device=args.device)
    except ValueError as e:
        raise SystemExit(f"python -m ufvideo_tpu_torch.train: {e}") from None
    maybe_initialize_distributed(device=args.device)
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    mesh = None  # one rank of layout 1: the unsharded step (FSDP2 would only cost)
    if world > 1 or (*layout, args.pp) not in ((1, -1, 1, 1), (1, 1, 1, 1)):
        mesh = create_mesh(*layout, pp=args.pp, device=args.device)
    device = args.device
    if dist.is_initialized() and device == "cuda":
        device = f"cuda:{local_rank()}"
    data_rank, data_size = axis_coordinate(mesh, ("data", "fsdp")) if mesh else (0, 1)
    print(f"rank {rank} of {world} on {device}, "
          + (f"mesh {axis_sizes(mesh)}" if mesh is not None else "unsharded"), flush=True)

    from ..api import model_init
    from ..configs import UFVideoConfig, tiny_config
    from .data import Collator, SupervisedVideoDataset
    from .lora import LoRAConfig
    from .prefetch import PrefetchLoader, device_prefetch, to_device
    from .seg_step import make_seg_loss_fn
    from .trainer import TrainConfig, Trainer, build_sample_order, shard_order_for_process

    cfg = tiny_config() if args.tiny else UFVideoConfig()
    cfg = cfg.replace(
        budget=dataclasses.replace(
            cfg.budget,
            num_frames=args.num_frames or cfg.budget.num_frames,
            num_frames_sam=args.num_frames_sam or cfg.budget.num_frames_sam),
        llm=dataclasses.replace(cfg.llm, remat=not args.no_gradient_checkpointing),
    )
    rt, _, tokenizer = model_init(
        args.model_path or None, cfg=cfg, device=device,
        tokenizer_path=args.tokenizer_path or None, sam_path=args.sam_path or None)
    if args.tiny:  # float32 widths: the plain versions, as the tiny server runs
        rt.model.set_use_kernels(False)
    if args.pp > 1:
        # the same parameters, the layers re-scheduled as a pipeline
        n_mb = args.microbatches or 2 * args.pp
        if args.global_batch_size % n_mb != 0:
            raise SystemExit(f"--global-batch-size {args.global_batch_size} must be "
                             f"divisible by --microbatches {n_mb}")
        if (args.global_batch_size // n_mb) % data_size != 0:
            raise SystemExit(f"per-microbatch rows {args.global_batch_size // n_mb} must "
                             f"divide the data axes (data*fsdp = {data_size})")
        rt.model.llm.set_pipeline(mesh, "pipe", n_mb)
    tc = TrainConfig(
        output_dir=args.output_dir,
        learning_rate=args.learning_rate,
        mm_projector_lr=args.mm_projector_lr,
        warmup_ratio=args.warmup_ratio,
        total_steps=args.total_steps,
        global_batch_size=args.global_batch_size,
        save_steps=args.save_steps,
        save_total_limit=args.save_total_limit,
        tune_adapters_only=args.tune_adapters_only,
        seed=args.seed,
        lora=LoRAConfig() if args.lora else None,
    )
    trainer = Trainer(rt.model, rt.cfg, tc, loss_fn=make_seg_loss_fn(), mesh=mesh)
    dataset = SupervisedVideoDataset(args.data_paths, tokenizer, rt.cfg,
                                     video_root=args.video_root, seed=args.seed)
    collator = Collator(rt.cfg, rt.ids.region, rt.ids.seg)
    # each process decodes and collates its rows of every global batch
    order = shard_order_for_process(build_sample_order(dataset, tc), tc.global_batch_size,
                                    data_rank, data_size)
    loader = PrefetchLoader(order, dataset.__getitem__, collator,
                            batch_size=tc.global_batch_size // data_size,
                            num_workers=args.num_workers)
    state = trainer.maybe_resume(trainer.init_state())
    try:
        state = trainer.train(
            state, device_prefetch(loader, lambda b: to_device(b, rt.device)))
    finally:
        loader.close()
    trainer.save(state)
    metrics = {k: round(float(v), 6) for k, v in (trainer.last_metrics or {}).items()}
    print(f"done at step {state.step} {metrics}", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
