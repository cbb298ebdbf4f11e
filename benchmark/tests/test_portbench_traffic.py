"""The generator gives the same requests for the same seed, others for
another seed, the same set of sizes to every seed, and frames no two
requests share."""

import numpy as np
import pytest

from benchmark import generator

OPEN = {"loop": "open", "rate": 3.0, "stratum": 16, "question_bytes": [40, 400],
        "frames": [32, 480, 640, 3], "stream": False,
        "answer_tokens": {"dist": "uniform", "low": 4, "high": 16}}
CLOSED = dict(OPEN, loop="closed", stratum=32, clients=32, stream=True,
              answer_tokens={"dist": "lognormal", "median": 192, "sigma": 0.5,
                             "low": 64, "high": 448})
SEEDS = [0, 7, 2**31 + 12345]


@pytest.mark.parametrize("params", [OPEN, CLOSED], ids=["open", "closed"])
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_requests(params, seed):
    assert generator.requests(params, seed, 64) == generator.requests(params, seed, 64)


@pytest.mark.parametrize("params", [OPEN, CLOSED], ids=["open", "closed"])
def test_other_seed_other_requests_same_sizes(params):
    a, b = (generator.requests(params, s, 64) for s in SEEDS[:2])
    assert [r.question for r in a] != [r.question for r in b]
    assert [r.max_new for r in a] != [r.max_new for r in b]
    k = params["stratum"]
    for i in range(0, 64, k):  # each block: the same sizes, in another order
        assert sorted(r.max_new for r in a[i:i + k]) == sorted(r.max_new for r in b[i:i + k])
        assert sorted(len(r.question) for r in a[i:i + k]) == \
            sorted(len(r.question) for r in b[i:i + k])


def test_open_loop_rate_and_sizes():
    reqs = generator.requests(OPEN, 5, 160)
    gaps = np.diff([0.0] + [r.due for r in reqs])
    assert gaps.min() > 0
    assert reqs[15].due == pytest.approx(16 / OPEN["rate"])  # a block's mean gap is 1 / rate
    assert {r.max_new for r in reqs} <= set(range(4, 17))
    assert all(40 <= len(r.question.encode()) <= 400 for r in reqs)


def test_closed_loop_sizes_clipped_around_the_median():
    sizes = [r.max_new for r in generator.requests(CLOSED, 5, 64)]
    assert min(sizes) >= 64 and max(sizes) <= 448
    assert 180 <= float(np.median(sizes)) <= 205


def test_frames_unique_and_avoided():
    reqs = generator.requests(OPEN, 9, 256)
    offsets = [r.offset for r in reqs]
    assert len(set(offsets)) == len(offsets)
    warm = generator.requests(OPEN, 9, 16, stream=generator.STREAM_WARMUP, avoid=offsets)
    assert not {r.offset for r in warm} & set(offsets)
    small = dict(OPEN, frames=[2, 4, 4, 3])
    pool = generator.make_pool(small, 9)
    r = generator.requests(small, 9, 1)[0]
    f = generator.frames(pool, small, r)
    assert f.shape == (2, 4, 4, 3) and f.dtype == np.uint8
    assert np.shares_memory(f, pool)
    assert np.array_equal(pool, generator.make_pool(small, 9))


def test_further_blocks_same_sizes_new_frames():
    first = generator.requests(CLOSED, 5, 64)
    used = {r.offset for r in first}
    block = generator.more(CLOSED, 5, 0, 64, used)
    assert block == generator.more(CLOSED, 5, 0, 64, used)
    assert [r.index for r in block] == list(range(64, 96))
    assert sorted(r.max_new for r in block) == sorted(r.max_new for r in first[:32])
    assert not {r.offset for r in block} & used
    assert [r.question for r in block] != [r.question for r in generator.more(CLOSED, 5, 1, 96, used)]
