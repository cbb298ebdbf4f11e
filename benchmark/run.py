"""The benchmark of ``ufvideo_tpu_torch`` on one card: one run of one cell.

    python3 benchmark/run.py --workload qa-describe.int8 --seed 1234 --seconds 51 --trace 0

Run from the root of a checkout. Prints a few readings on standard error, the
numbers the check compared beside their limits last there, and one JSON line
last on standard output. ``--trace 1`` reports the cell's per-layer metrics
from a profiled window instead of its end-to-end ones. ``--control 1`` runs
the configuration's control (a lower precision) in the program's place and
checks it against the same reference: such a run has to come out not correct.
It exits 2 without a result where CUDA or the cell's cards are missing, and 3
where the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ufvideo_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def caches() -> None:
    """Build and kernel caches inside the checkout, at fixed paths (the
    program's own CUDA build cache is ``ufvideo_tpu_torch/_build/``)."""
    base = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ["USE_FLAX"] = "0"  # a library that could load JAX by itself does not


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else \
        f"nvidia-smi failed: {out.stderr.strip()[:200]}"


def loaded_jax() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    caches()
    # the checkout's root, and not this folder, on the path: the folder's
    # modules are imported as ``benchmark.*`` and shadow nothing
    sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    import torch

    from benchmark import harness

    sp = harness.spec(args.workload)
    chips = int(sp.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out = harness.run(sp, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START,
                      control=bool(args.control), log=log)
    found = loaded_jax()
    if found:
        log(f"the process loaded {found}: the benchmark measures the port alone; no result")
        return 3
    for name, c in out["check"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
