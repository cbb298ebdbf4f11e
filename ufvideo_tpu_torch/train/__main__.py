"""Training launcher (the port of ``scripts/train.py``), one process on one
card: the reference's knobs (data path mix, lr / projector lr, warmup ratio,
frames, save cadence, gradient checkpointing), plus PEFT LoRA at the
reference's r 8, alpha 16, dropout 0.05 (``--lora``)::

    python -m ufvideo_tpu_torch.train --data-paths a.json b.json \\
        --video-root data/ --model-path <hf checkpoint> \\
        --sam-path sam2_hiera_large.pt --output-dir checkpoints/run1

    # smoke: random tiny weights on the CPU
    python -m ufvideo_tpu_torch.train --tiny --device cpu \\
        --data-paths data.json --video-root data/ --global-batch-size 2 \\
        --total-steps 1

Batches with a SAM branch train the ``[SEG]`` loss, the others the CE loss.
The mesh options of the JAX launcher (``--dp --fsdp --tp --pp
--microbatches``) are refused: data, tensor and pipeline parallelism come
with the parallelism slice (ROADMAP.md queue 1 item 5). It runs on the card
unless ``--device cpu`` is given; the package is not installed, so run it
from the checkout's root.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

# the JAX launcher's mesh options and their one-device values
MESH_DEFAULTS = {"dp": (1,), "fsdp": (-1, 1), "tp": (1,), "pp": (1,), "microbatches": (0,)}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m ufvideo_tpu_torch.train",
                                description="train UFVideo on one card")
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
    for name, (default, *_) in MESH_DEFAULTS.items():
        p.add_argument(f"--{name}", type=int, default=default, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    bad = [f"--{n} {getattr(args, n)}" for n, ok in MESH_DEFAULTS.items()
           if getattr(args, n) not in ok]
    if bad:
        p.error(f"{', '.join(bad)}: this launcher trains on one card; data, tensor and "
                "pipeline parallelism come with ROADMAP.md queue 1 item 5")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

    from ..api import model_init
    from ..configs import UFVideoConfig, tiny_config
    from .data import Collator, SupervisedVideoDataset
    from .lora import LoRAConfig
    from .prefetch import PrefetchLoader, device_prefetch, to_device
    from .seg_step import make_seg_loss_fn
    from .trainer import TrainConfig, Trainer, build_sample_order

    cfg = tiny_config() if args.tiny else UFVideoConfig()
    cfg = cfg.replace(
        budget=dataclasses.replace(
            cfg.budget,
            num_frames=args.num_frames or cfg.budget.num_frames,
            num_frames_sam=args.num_frames_sam or cfg.budget.num_frames_sam),
        llm=dataclasses.replace(cfg.llm, remat=not args.no_gradient_checkpointing),
    )
    rt, _, tokenizer = model_init(
        args.model_path or None, cfg=cfg, device=args.device,
        tokenizer_path=args.tokenizer_path or None, sam_path=args.sam_path or None)
    if args.tiny:  # float32 widths: the plain versions, as the tiny server runs
        rt.model.set_use_kernels(False)
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
    trainer = Trainer(rt.model, rt.cfg, tc, loss_fn=make_seg_loss_fn())
    dataset = SupervisedVideoDataset(args.data_paths, tokenizer, rt.cfg,
                                     video_root=args.video_root, seed=args.seed)
    collator = Collator(rt.cfg, rt.ids.region, rt.ids.seg)
    loader = PrefetchLoader(build_sample_order(dataset, tc), dataset.__getitem__, collator,
                            batch_size=tc.global_batch_size, num_workers=args.num_workers)
    state = trainer.maybe_resume(trainer.init_state())
    try:
        state = trainer.train(
            state, device_prefetch(loader, lambda b: to_device(b, rt.device)))
    finally:
        loader.close()
    trainer.save(state)
    metrics = {k: round(float(v), 6) for k, v in (trainer.last_metrics or {}).items()}
    print(f"done at step {state.step} {metrics}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
