"""Gradients through the hand-written kernels (``ops/autograd.py``), on the
CPU: a recording stand-in takes the kernel's place. The forward calls the
stand-in once and nothing else; the backward calls only the plain version,
and its gradients equal plain autograd's. Each of the eight wrappers with a
JAX ``custom_vjp`` routes a CUDA call through the helper with its own kernel
and plain version; each wrapper without one raises on an input that
requires a gradient (checked on meta tensors: the check comes before any
device work) and not under ``torch.no_grad``. The card cases are in
``tests/test_torch_cuda.py``."""

import pytest
import torch

from ufvideo_tpu_torch import probe_int8_rate
from ufvideo_tpu_torch.ops import (
    autograd, decode_attention, flash_attention, hiera_block, quant_matmul, vit_attention,
    window_attention)


def _rand(gen, *shape):
    return torch.randn(*shape, generator=gen)


def _block_params(gen, c, hw, mlp, front=None):
    """(ln1_s, ln1_b, w_front, b_front, wproj, bproj, ln2_s, ln2_b, w1, b1,
    w2, b2); ``front`` is the front product's width (3·hw by default)."""
    front = front or 3 * hw
    cout = c if front == 3 * hw else front - 3 * hw
    return (1 + 0.1 * _rand(gen, c), 0.1 * _rand(gen, c), _rand(gen, c, front) / c ** 0.5,
            0.1 * _rand(gen, front), _rand(gen, hw, cout) / hw ** 0.5, 0.1 * _rand(gen, cout),
            1 + 0.1 * _rand(gen, cout), 0.1 * _rand(gen, cout),
            _rand(gen, cout, mlp) / cout ** 0.5, 0.1 * _rand(gen, mlp),
            _rand(gen, mlp, cout) / mlp ** 0.5, 0.1 * _rand(gen, cout))


def _cases():
    """name → (module, CUDA implementation's name, plain version, a function
    of a generator making the args, kwargs)."""
    return {
        "flash_attention": (
            flash_attention, "_flash_attention_cuda", flash_attention.flash_attention_plain,
            lambda g: (_rand(g, 1, 5, 4, 8), _rand(g, 1, 5, 2, 8), _rand(g, 1, 5, 2, 8)),
            dict(causal=True, kv_lens=torch.tensor([4]), kv_mask=None, scale=None)),
        "fused_hiera_block": (
            hiera_block, "_hiera_block_cuda", hiera_block.fused_hiera_block_plain,
            lambda g: (_rand(g, 2, 4, 16), _block_params(g, 16, 16, 32), 2, 8, "gelu_exact",
                       1e-6), {}),
        "fused_hiera_stage": (
            hiera_block, "_hiera_stage_cuda", hiera_block.fused_hiera_stage_plain,
            lambda g: (_rand(g, 2, 4, 16), [_block_params(g, 16, 16, 32) for _ in range(2)],
                       2, 8, "gelu_exact", 1e-6), {}),
        "fused_ln_matmul": (
            hiera_block, "_ln_matmul_cuda", hiera_block.fused_ln_matmul_plain,
            lambda g: (_rand(g, 2, 4, 16), 1 + 0.1 * _rand(g, 16), 0.1 * _rand(g, 16),
                       _rand(g, 16, 24) / 4, 0.1 * _rand(g, 24), 1e-6), {}),
        "fused_block_tail": (
            hiera_block, "_block_tail_cuda", hiera_block.fused_block_tail_plain,
            lambda g: (_rand(g, 2, 4, 16), _rand(g, 2, 4, 16),
                       _block_params(g, 16, 16, 32)[4:], "gelu_exact", 1e-6), {}),
        "fused_qpool_block": (
            hiera_block, "_qpool_block_cuda", hiera_block.fused_qpool_block_plain,
            lambda g: (_rand(g, 2, 16, 16), _block_params(g, 16, 16, 32, front=72), 2, 8,
                       (2, 2), "gelu_exact", 1e-6), {}),
        "fused_window_attention": (
            window_attention, "_window_attention_cuda",
            window_attention.fused_window_attention_plain,
            lambda g: (_rand(g, 3, 4, 48), 2, 8), {}),
        "mha_full_attention_packed": (
            vit_attention, "_mha_packed_cuda", vit_attention.mha_full_attention_packed_plain,
            lambda g: (_rand(g, 2, 6, 48), 2, 8), {}),
    }


CASES = _cases()


def _leaves(tree, out):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _leaves(t, out)
    elif torch.is_tensor(tree) and tree.is_floating_point():
        out.append(tree)
    return out


def _args(name, seed=0):
    _, _, _, make_args, kw = CASES[name]
    args = make_args(torch.Generator().manual_seed(seed))
    for t in _leaves(args, []):
        t.requires_grad_(True)
    return args, kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_launches_backward_recomputes_plain(name):
    """The stand-in runs once in the forward; the backward runs the plain
    version once and never the stand-in; gradients equal plain autograd."""
    _, _, plain, _, _ = CASES[name]
    calls = []

    def kernel(*a, **k):
        calls.append("kernel")
        with torch.no_grad():
            return plain(*a, **k)

    def plain_counted(*a, **k):
        calls.append("plain")
        return plain(*a, **k)

    args, kw = _args(name)
    out = autograd.kernel_with_plain_backward(kernel, plain_counted, *args, **kw)
    assert calls == ["kernel"] and out.grad_fn is not None
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(9))
    grads = torch.autograd.grad(out, _leaves(args, []), g_out)
    assert calls == ["kernel", "plain"]

    ref_args, _ = _args(name)
    ref = torch.autograd.grad(plain(*ref_args, **kw), _leaves(ref_args, []), g_out)
    assert len(grads) == len(ref) > 0
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_is_skipped_without_grad(name):
    """No graph wanted (no_grad, or no input requiring one): the kernel is
    called directly and its output returned as it is."""
    _, _, plain, _, _ = CASES[name]
    args, kw = _args(name)
    sentinel = torch.zeros(1)
    with torch.no_grad():
        assert autograd.kernel_with_plain_backward(lambda *a, **k: sentinel, plain,
                                                   *args, **kw) is sentinel


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_routes_card_calls_through_the_helper(name, monkeypatch):
    """The public wrapper hands a non-CPU call to the helper with its own
    CUDA implementation and plain version (meta tensors: nothing runs)."""
    module, impl, plain, _, _ = CASES[name]
    seen = {}

    def capture(kernel, plain_fn, *a, **k):
        seen.update(kernel=kernel, plain=plain_fn)
        return "captured"

    monkeypatch.setattr(module, "kernel_with_plain_backward", capture)
    args, kw = _args(name)
    meta = _to_meta(args)
    public = getattr(module, name)
    kw = {k: (v.to("meta") if torch.is_tensor(v) else v) for k, v in kw.items()}
    assert public(*meta, **kw) == "captured"
    assert seen == {"kernel": getattr(module, impl), "plain": plain}


def _to_meta(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_meta(t) for t in tree)
    if torch.is_tensor(tree):
        return tree.detach().to("meta").requires_grad_(tree.requires_grad)
    return tree


def _m(*shape, dtype=torch.float32, grad=False):
    return torch.empty(*shape, dtype=dtype, device="meta", requires_grad=grad)


NO_BACKWARD = {
    "ragged_decode_attention": lambda g: decode_attention.ragged_decode_attention(
        _m(1, 2, 2, 8, grad=g), _m(1, 2, 16, 8), _m(1, 2, 16, 8),
        _m(1, dtype=torch.int32)),
    "ragged_decode_attention_q8": lambda g: decode_attention.ragged_decode_attention_q8(
        _m(1, 2, 2, 16, grad=g), _m(1, 2, 16, 16, dtype=torch.int8),
        _m(1, 2, 16, 16, dtype=torch.int8), _m(1, 2, 16), _m(1, 2, 16),
        _m(1, dtype=torch.int32)),
    "int8_matvec": lambda g: quant_matmul.int8_matvec(
        _m(1, 16, grad=g), _m(16, 8, dtype=torch.int8), _m(8)),
    "int4_matmul": lambda g: quant_matmul.int4_matmul(
        _m(1, 16, grad=g), _m(8, 8, dtype=torch.int8), _m(2, 8), 8),
    "probe_step": lambda g: probe_int8_rate.probe_step(_m(4, 16, grad=g), _m(16, 8), False),
    "fused_block_w8a8": lambda g: hiera_block.fused_block_w8a8(
        _m(1, 4, 16, grad=g), tuple(_m(1) for _ in range(16)), 2, 8),
    "fused_ln_matmul_w8a8": lambda g: hiera_block.fused_ln_matmul_w8a8(
        _m(1, 4, 16, grad=g), _m(16), _m(16), _m(16, 8, dtype=torch.int8), _m(8), _m(8)),
    "fused_block_tail_w8a8": lambda g: hiera_block.fused_block_tail_w8a8(
        _m(1, 4, 16, grad=g), _m(1, 4, 16), tuple(_m(1) for _ in range(11))),
    "fused_qpool_block_w8a8": lambda g: hiera_block.fused_qpool_block_w8a8(
        _m(1, 16, 16, grad=g), tuple(_m(1) for _ in range(16)), 2, 8),
}


@pytest.mark.parametrize("name", sorted(NO_BACKWARD))
def test_wrapper_without_backward_refuses_a_grad_input(name):
    """A wrapper with no backward raises on an input requiring a gradient,
    before any device work; without one it goes on (here to the device
    check, which a meta tensor fails)."""
    with pytest.raises(RuntimeError, match="has no backward"):
        NO_BACKWARD[name](True)
    with pytest.raises(ValueError, match="device"):
        NO_BACKWARD[name](False)
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        NO_BACKWARD[name](True)
