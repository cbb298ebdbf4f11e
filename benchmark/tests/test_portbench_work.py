"""The operations and bytes of ``benchmark/work`` reproduce PERF.md section
6's "bound ms" column at its shapes."""

import pytest

from benchmark.work import decode_attention, flash_attention, peaks, quant_matvec, siglip_block


def ms(nbytes, flops=0.0):
    return peaks.bound_s(nbytes, flops) * 1e3


CASES = {
    # SigLIP layer x [32,729,1152], 16 heads of 72, MLP 4304
    "siglip_block": (lambda: ms(*siglip_block.block(32, 729, 1152, 4304, 16, 72)), 0.7975),
    # q [1,2816,28,128] k/v [1,2816,4,128] causal, kv_lens 2770 (every query row)
    "flash_prefill": (lambda: ms(*flash_attention.causal(2770, 28, 4, 128, rows=2816)), 0.0575),
    "decode_bf16_b1": (lambda: ms(*decode_attention.step([2771], 28, 4, 128, False)), 0.0017),
    "decode_bf16_b4": (lambda: ms(*decode_attention.step([2944, 1, 1500, 129], 28, 4, 128,
                                                          False)), 0.0028),
    "decode_bf16_b8": (lambda: ms(*decode_attention.step(
        [2785, 1, 2794, 2819, 1, 2848, 1, 2851], 28, 4, 128, False)), 0.0087),
    "decode_q8_b1": (lambda: ms(*decode_attention.step([2800], 28, 4, 128, True)), 0.0009),
    "decode_q8_b8": (lambda: ms(*decode_attention.step(
        [2785, 1, 2794, 2819, 1, 2848, 1, 2851], 28, 4, 128, True)), 0.0045),
    "int8_qkv_rows1": (lambda: ms(quant_matvec.product(3584, 4608, 1)[0]), 0.0049),
    "int8_down_rows32": (lambda: ms(quant_matvec.product(18944, 3584, 32)[0]), 0.0208),
    "int8_lm_head_rows32": (lambda: ms(quant_matvec.product(3584, 152064, 32)[0]), 0.1687),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bound_ms(name):
    got, want = CASES[name][0](), CASES[name][1]
    assert round(got, 4) == pytest.approx(want, abs=1e-4)


def test_valid_rows_need_less_than_padded_rows():
    valid = flash_attention.causal(2770, 28, 4, 128)[1]
    padded = flash_attention.causal(2770, 28, 4, 128, rows=2816)[1]
    assert valid == 4 * 28 * 128 * 2770 * 2771 // 2 < padded


def test_int8_step_reads_every_weight_once():
    llm = dict(hidden_size=3584, head_dim=128, num_heads=28, num_kv_heads=4,
               intermediate_size=18944, num_layers=28)
    nbytes, _ = quant_matvec.step(llm, 152064)
    weights = 28 * 3584 * (4608 + 3584 + 2 * 18944) + 18944 * 3584 * 28 + 3584 * 152064
    assert weights < nbytes < weights * 1.001
