"""The traced window's readings on a hand-made list of device operations:
busy time as the union of intervals, a family's seconds by symbol, the top
operations, and the idle gaps named by the host's samples and their
neighbours."""

import pytest

from benchmark.tracing import DeviceTrace, merged, short_name
from benchmark.work import decode_attention, flash_attention, quant_matvec, siglip_block

FLASH_128 = "void ufv::flash_fwd_kernel<128, 2, 128>(ufv::AttnMaps, ufv::AttnArgs, int)"
FLASH_80 = "void ufv::flash_fwd_kernel<80, 2, 64>(ufv::AttnMaps, ufv::AttnArgs, int)"
GEMM = "void (anonymous namespace)::gemm_pp_kernel<0>(CUtensorMap, CUtensorMap, float const*)"
DECODE = "void (anonymous namespace)::decode_partial_kernel<__nv_bfloat16>(int)"
MATVEC = "void (anonymous namespace)::rows_kernel<8, 4>(__nv_bfloat16 const*, signed char const*)"
CUBLAS = "nvjet_tst_192x192_64x4_1x2_h_bz_coopB_TNN"


def _trace():
    t = DeviceTrace("ufvideo_tpu_torch")
    t.events = [(GEMM, 0, 100), (FLASH_80, 50, 150), (CUBLAS, 300, 400),
                (FLASH_128, 1000, 1100), (DECODE, 1100, 1200), (MATVEC, 1500, 1600)]
    t.sampler.samples = [(200, "engine.py:_step"), (250, "engine.py:_step"),
                         (260, "generate.py:decode_chunk"), (700, "engine.py:_admit_loop")]
    t.window_s = 2e-6
    return t


def test_merged_and_busy():
    assert merged([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
    assert _trace().busy_s() == pytest.approx(550e-9)


def test_symbols_pick_their_family_only():
    t = _trace()
    assert t.device_seconds(siglip_block.SYMBOLS) == pytest.approx(200e-9)
    assert t.device_seconds(flash_attention.SYMBOLS) == pytest.approx(100e-9)
    assert t.device_seconds(decode_attention.SYMBOLS) == pytest.approx(100e-9)
    assert t.device_seconds(quant_matvec.SYMBOLS) == pytest.approx(100e-9)


def test_top_ops_and_idle_gaps():
    t = _trace()
    assert [n for n, _ in t.top_ops(2)] == ["gemm_pp_kernel<0>", "flash_fwd_kernel<80>"]
    gaps = t.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([600e-9, 300e-9, 150e-9])
    assert gaps[0][0] == "host: engine.py:_admit_loop | nvjet_tst_192x192_64x4_1x2_h_bz_coopB_TNN" \
        " -> flash_fwd_kernel<128>"
    assert gaps[2][0].startswith("host: engine.py:_step | flash_fwd_kernel<80> -> nvjet")


@pytest.mark.parametrize("name, short", [
    (FLASH_128, "flash_fwd_kernel<128>"), (GEMM, "gemm_pp_kernel<0>"), (CUBLAS, CUBLAS),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD (Pageable -> Device)"),
])
def test_short_name(name, short):
    assert short_name(name) == short
