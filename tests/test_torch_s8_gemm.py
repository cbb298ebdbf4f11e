"""The int8 product of the int8-rate probe (and of the W8A8 blocks) on the
CPU: the plain versions the card's TMA + wgmma s8 GEMM is held against.

- ``round_clip_s8_plain`` (the probe's x on its way to the GEMM) against the
  JAX probe's formula ``clip(round(x), -127, 127)`` at ties and past the
  clip, with zeros in the padded columns K..Kp;
- the probe's plain product against the body of the JAX probe's Pallas
  kernel (``_pallas_dot_kernel``) at every K the W8A8 blocks use;
- the GEMM's operand layout (x rounded into [M, Kp], the weights transposed
  into [N, Kp], both zero past K) gives the same int32 sums.

int32 sums are exact: every comparison is equality. The card's kernels:
``tests/test_torch_cuda.py``.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ufvideo_tpu_torch.probe_int8_rate import probe_step, probe_step_plain, round_clip_s8_plain

# the K of every int8 product in the W8A8 blocks: Hiera C 144 / 288 / 576 /
# 1152, its MLP 576 / 1152 / 2304 / 4608, SigLIP C 1152 and MLP 4304
BLOCK_K = (144, 288, 576, 1152, 2304, 4304, 4608)
TIES = (0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 126.5, -126.5, 127.5, -127.5, 128.0, -128.0,
        300.0, -300.0)


def _pad32(k: int) -> int:
    return -(-k // 32) * 32


@pytest.fixture(scope="module")
def jprobe():
    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "probe_int8_rate.py"
    spec = importlib.util.spec_from_file_location("jax_probe_int8_rate_s8", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(rng, m, k):
    """bf16 [m, k] of scale 40 (ties of .5 are common above 64), the listed
    ties and clipped values at the head of row 0."""
    x = (40 * rng.standard_normal((m, k))).astype(ml_dtypes.bfloat16)
    x[0, :len(TIES)] = TIES
    return x


@pytest.mark.parametrize("k", (16, 144, 4304))
def test_round_clip_s8_plain_matches_the_jax_formula(k):
    rng = np.random.default_rng(k)
    x = _x(rng, 9, k)
    kp = _pad32(k)
    got = round_clip_s8_plain(torch.from_numpy(x.astype(np.float32)).bfloat16(), kp)
    want = np.asarray(jnp.clip(jnp.round(jnp.asarray(x).astype(jnp.float32)), -127, 127)
                      .astype(jnp.int8))
    assert got.dtype == torch.int8 and got.shape == (9, kp)
    np.testing.assert_array_equal(got[:, :k].numpy(), want)
    assert not got[:, k:].any()
    # half to even, then the clip
    np.testing.assert_array_equal(
        got[0, :len(TIES)].numpy(),
        [0, 0, 2, -2, 2, -2, 126, -126, 127, -127, 127, -127, 127, -127])


@pytest.mark.parametrize("k", BLOCK_K)
def test_probe_s8_plain_matches_the_jax_probe_kernel_body(jprobe, k):
    rng = np.random.default_rng(100 + k)
    x = _x(rng, 12, k)
    w = rng.integers(-127, 128, (k, 34)).astype(np.int8)
    out = np.zeros((12, 34), np.int32)
    jprobe._pallas_dot_kernel(x, w, out, quant=True)
    got = probe_step(torch.from_numpy(x.astype(np.float32)).bfloat16(), torch.from_numpy(w), True)
    assert probe_step.launches == 0
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), out)


@pytest.mark.parametrize("k", BLOCK_K)
def test_s8_gemm_operand_layout_keeps_the_sums(k):
    """qa [M, Kp] · bt [N, Kp]ᵀ with both zero past K, the operands the
    kernel's TMA boxes read, equals the probe's plain product."""
    rng = np.random.default_rng(200 + k)
    x = torch.from_numpy(_x(rng, 7, k).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.integers(-127, 128, (k, 22)).astype(np.int8))
    kp = _pad32(k)
    qa = round_clip_s8_plain(x, kp)
    bt = torch.nn.functional.pad(w.t(), (0, kp - k))
    got = (qa.double() @ bt.double().t()).to(torch.int32)
    assert torch.equal(got, probe_step_plain(x, w, True))
