"""The one traffic generator: a traffic mix (``traffic/<mix>.json``) and a
cell's parameters (``cells/<cell>.json``'s ``traffic``) → the run's requests,
from ``--seed`` alone.

Every seed gets the same work in another order: the requests come in blocks
of ``stratum``, and each block holds the same ``stratum`` quantiles of every
drawn size (arrival gap, question length, answer length), each set shuffled
by the seed. The content is the seed's own: the question's letters and the
frames, which are windows of one pool of random bytes at offsets no two
requests share, so each request carries a video no other request carried.

Parameters (the mix's, then the cell's over them):
- ``loop``: ``open`` (arrivals on a schedule, ``rate`` a second, exponential
  gaps) or ``closed`` (``clients`` each sending its next request when the
  last one is answered);
- ``question_bytes``: [low, high], uniform;
- ``answer_tokens``: ``{"dist": "uniform", "low", "high"}`` or
  ``{"dist": "lognormal", "median", "sigma", "low", "high"}`` (clipped);
- ``frames``: [T, H, W, 3] uint8 frames a request;
- ``stream``: whether the client streams its reply;
- ``stratum``: the block length.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List

import numpy as np

ALPHABET = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz    ", dtype=np.uint8)
SEED_MASK = (1 << 64) - 1

# independent streams of one seed (a schedule's letters come from its stream + 1000);
# a closed loop's n-th further block of requests draws from STREAM_MORE + n
STREAM_SIZES, STREAM_POOL, STREAM_WARMUP, STREAM_SAMPLE = range(4)
STREAM_MORE = 100


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & SEED_MASK, stream])


@dataclass
class Request:
    index: int
    question: str
    max_new: int
    offset: int  # the frames' offset in the pool
    due: float  # seconds after the window opens (open loop; 0 for closed)


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _answer_sizes(spec: Dict[str, Any], u: np.ndarray) -> np.ndarray:
    if spec["dist"] == "uniform":
        lo, hi = spec["low"], spec["high"]
        return np.minimum(lo + np.floor(u * (hi - lo + 1)), hi).astype(int)
    if spec["dist"] == "lognormal":
        z = np.array([statistics.NormalDist().inv_cdf(float(x)) for x in u])
        sizes = np.round(spec["median"] * np.exp(spec["sigma"] * z))
        return np.clip(sizes, spec["low"], spec["high"]).astype(int)
    raise ValueError(f"unknown answer distribution {spec['dist']!r}")


def video_bytes(params: Dict[str, Any]) -> int:
    return math.prod(params["frames"])


def pool_bytes(params: Dict[str, Any]) -> int:
    """The pool holds two videos' bytes: room for many distinct windows."""
    return 2 * video_bytes(params)


def make_pool(params: Dict[str, Any], seed: int) -> np.ndarray:
    return rng(seed, STREAM_POOL).integers(0, 256, pool_bytes(params), dtype=np.uint8)


def frames(pool: np.ndarray, params: Dict[str, Any], req: Request) -> np.ndarray:
    """The request's frames: a view of the pool, no copy."""
    n = video_bytes(params)
    return pool[req.offset:req.offset + n].reshape(params["frames"])


def requests(params: Dict[str, Any], seed: int, count: int, stream: int = STREAM_SIZES,
             avoid: Iterable[int] = ()) -> List[Request]:
    """``count`` requests (rounded up to whole blocks) in sending order, their
    frames at none of the offsets in ``avoid``."""
    k = int(params["stratum"])
    blocks = -(-count // k)
    sizes, text = rng(seed, stream), rng(seed, stream + 1000)
    u = _quantiles(k)
    lo_q, hi_q = params["question_bytes"]
    q_block = np.round(lo_q + u * (hi_q - lo_q)).astype(int)
    a_block = _answer_sizes(params["answer_tokens"], u)
    gap_block = -np.log1p(-u)
    gap_block = gap_block / gap_block.mean()  # a block's mean gap is exactly 1 / rate
    open_loop = params["loop"] == "open"
    span = pool_bytes(params) - video_bytes(params)
    offsets: List[int] = []
    seen = set(avoid)
    while len(offsets) < blocks * k:
        for o in sizes.integers(0, span, blocks * k).tolist():
            if o not in seen and len(offsets) < blocks * k:
                seen.add(o)
                offsets.append(o)
    out: List[Request] = []
    t = 0.0
    for b in range(blocks):
        qs, ans = sizes.permutation(q_block), sizes.permutation(a_block)
        gaps = sizes.permutation(gap_block) / params["rate"] if open_loop else np.zeros(k)
        for j in range(k):
            i = b * k + j
            t += float(gaps[j])
            letters = ALPHABET[text.integers(0, len(ALPHABET), int(qs[j]) - 1)]
            letters[0] = ord("w")  # no leading space
            question = letters.tobytes().decode("ascii") + "?"
            out.append(Request(i, question, int(ans[j]), offsets[i], t if open_loop else 0.0))
    return out


def more(params: Dict[str, Any], seed: int, n: int, start: int,
         avoid: Iterable[int]) -> List[Request]:
    """A closed loop's ``n``-th further block of ``stratum`` requests, for a
    run that sends more than it drew at first: the same sizes as every block,
    indexed from ``start``, its frames at none of the offsets in ``avoid``."""
    block = requests(params, seed, int(params["stratum"]), stream=STREAM_MORE + n, avoid=avoid)
    return [dataclasses.replace(r, index=start + j) for j, r in enumerate(block)]
