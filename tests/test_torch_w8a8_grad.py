"""Gradients through the four W8A8 kernels on the CPU against the JAX
package's: each JAX W8A8 kernel carries a ``custom_vjp`` whose backward is a
straight-through estimator (the vjp of the float function on weights
dequantised as ``w · s``), which ``jax.grad`` takes whatever the forward
runs; here the JAX kernels run in interpret mode. The port routes its plain
W8A8 forward through the same rule. The int8 weights get no gradient; the
activations, LayerNorm parameters, biases and scales do. Then a tiny W8A8
SigLIP tower end to end, the JAX tower on its fused route (as
tests/test_torch_slice.py runs it).

Limit: every gradient within 2e-4 of its tensor's largest entry (f32; the
two frameworks sum in other orders)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ufvideo_tpu.models.siglip as jsig
import ufvideo_tpu.ops.hiera_block as jhb
from ufvideo_tpu import quant as jq
from ufvideo_tpu.configs import tiny_config as j_tiny_config
from ufvideo_tpu_torch.configs import tiny_config
from ufvideo_tpu_torch.models.siglip import SiglipVisionTower
from ufvideo_tpu_torch.ops import hiera_block as hb
from ufvideo_tpu_torch.weights import load_siglip

LIMIT = 2e-4


def _qk(rng, din, dout):
    """(int8 weight [in, out], f32 column scales, bias)."""
    return (rng.integers(-127, 128, (din, dout)).astype(np.int8),
            (np.abs(0.01 * rng.standard_normal(dout)) + 1e-3).astype(np.float32),
            (0.1 * rng.standard_normal(dout)).astype(np.float32))


def _ln(rng, c):
    return ((1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            (0.1 * rng.standard_normal(c)).astype(np.float32))


def _floats(tree):
    """Paths (tuples of indices) of the float leaves of nested tuples."""
    if isinstance(tree, (tuple, list)):
        return [(i, *p) for i, t in enumerate(tree) for p in _floats(t)]
    return [()] if np.asarray(tree).dtype.kind == "f" else []


def _put(tree, path, value):
    if not path:
        return value
    items = list(tree)
    items[path[0]] = _put(items[path[0]], path[1:], value)
    return tuple(items)


def _get(tree, path):
    for i in path:
        tree = tree[i]
    return tree


def _jax_grads(fn, args, g):
    """vjp of ``fn(*args)`` with cotangent ``g`` at every float leaf."""
    paths = _floats(args)

    def f(*floats):
        a = args
        for p, v in zip(paths, floats):
            a = _put(a, p, v)
        return fn(*a)

    _, vjp = jax.vjp(f, *(jnp.asarray(_get(args, p)) for p in paths))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _torch_grads(fn, args, g):
    paths = _floats(args)
    conv = lambda t: (tuple(conv(x) for x in t) if isinstance(t, tuple)
                      else torch.from_numpy(np.array(t)))
    a = conv(args)
    leaves = [_get(a, p).requires_grad_(True) for p in paths]
    out = fn(*a)
    assert out.grad_fn is not None
    return [t.numpy() for t in torch.autograd.grad(out, leaves, torch.from_numpy(g))]


def _assert_grads(got, want):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, i
        scale = float(np.abs(b).max())
        assert scale > 0, f"gradient {i} is zero"
        err = float(np.abs(a - b).max())
        assert err <= LIMIT * scale, f"gradient {i}: {err} against {LIMIT} x {scale}"


def _block(rng, cin, cout, hw, mlp, front):
    return (*_ln(rng, cin), *_qk(rng, cin, front), *_qk(rng, hw, cout), *_ln(rng, cout),
            *_qk(rng, cout, mlp), *_qk(rng, mlp, cout))


def _case(name):
    """(JAX function, the port's wrapper, args, output shape)."""
    rng = np.random.default_rng(60)
    x = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    if name == "fused_block_w8a8":
        n, s, c, heads = 4, 16, 32, 2
        args = (x(n, s, c), _block(rng, c, c, c, 4 * c, 3 * c))
        return (functools.partial(jhb.fused_block_w8a8, num_heads=heads, head_dim=c // heads,
                                  interpret=True, act="gelu_tanh"),
                functools.partial(hb.fused_block_w8a8, num_heads=heads, head_dim=c // heads,
                                  act="gelu_tanh"), args, (n, s, c))
    if name == "fused_qpool_block_w8a8":
        n, ws, cin, cout, heads = 2, 4, 16, 32, 2
        hw = cout
        args = (x(n, ws * ws, cin), _block(rng, cin, cout, hw, 4 * cout, 3 * hw + cout))
        return (lambda a, p: jhb.fused_qpool_block_w8a8(a, p, heads, hw // heads, 0, (2, 2),
                                                        interpret=True),
                lambda a, p: hb.fused_qpool_block_w8a8(a, p, heads, hw // heads, (2, 2)),
                args, (n, ws * ws // 4, cout))
    if name == "fused_ln_matmul_w8a8":
        n, s, c, d = 2, 16, 32, 48
        args = (x(n, s, c), *_ln(rng, c), *_qk(rng, c, d))
        return (lambda *a: jhb.fused_ln_matmul_w8a8(*a, interpret=True),
                hb.fused_ln_matmul_w8a8, args, (n, s, d))
    n, s, a, c = 2, 16, 48, 32
    args = (x(n, s, c), x(n, s, a), (*_qk(rng, a, c), *_ln(rng, c), *_qk(rng, c, 4 * c),
                                     *_qk(rng, 4 * c, c)))
    return (lambda sc, at, p: jhb.fused_block_tail_w8a8(sc, at, p, interpret=True),
            hb.fused_block_tail_w8a8, args, (n, s, c))


@pytest.mark.parametrize("name", ["fused_block_w8a8", "fused_qpool_block_w8a8",
                                  "fused_ln_matmul_w8a8", "fused_block_tail_w8a8"])
def test_w8a8_kernel_gradients_equal_jax(name):
    jfn, tfn, args, shape = _case(name)
    g = np.random.default_rng(61).standard_normal(shape).astype(np.float32)
    want = _jax_grads(jfn, args, g)
    got = _torch_grads(tfn, args, g)
    _assert_grads(got, want)
    assert getattr(hb, name).launches == 0


def test_w8a8_siglip_tower_gradients_equal_jax(monkeypatch):
    """The tiny W8A8 tower (3 layers of 32 on 4 frames of 56²): gradients of
    the pixels and of every float parameter, the JAX tower on its fused
    route (``fused_block_w8a8`` in interpret mode)."""
    jcfg = j_tiny_config().vision
    jt = jsig.SiglipVisionTower(jcfg, dtype=jnp.float32, param_dtype=jnp.float32, quant=True)
    px = np.random.default_rng(62).standard_normal((4, 56, 56, 3)).astype(np.float32)
    ft = jsig.SiglipVisionTower(jcfg, dtype=jnp.float32, param_dtype=jnp.float32)
    params = jq.quantize_vision_params(ft.init(jax.random.PRNGKey(3), jnp.asarray(px))["params"])
    params = jax.tree.map(np.asarray, params)
    real = jhb.fused_block_w8a8
    monkeypatch.setattr(jhb, "fused_block_w8a8", lambda x, p, h, d, head_pad=0, interpret=False,
                        *rest, **kw: real(x, p, h, d, head_pad, True, *rest, **kw))
    monkeypatch.setattr(jsig.jax, "default_backend", lambda: "tpu")

    flat, tree = jax.tree_util.tree_flatten(params)
    fl = [i for i, v in enumerate(flat) if v.dtype.kind == "f"]

    def jfn(pixels, *floats):
        leaves = list(flat)
        for i, v in zip(fl, floats):
            leaves[i] = v
        return jt.apply({"params": jax.tree_util.tree_unflatten(tree, leaves)}, pixels)

    out, vjp = jax.vjp(jfn, jnp.asarray(px), *(jnp.asarray(flat[i]) for i in fl))
    g = np.random.default_rng(63).standard_normal(out.shape).astype(np.float32)
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]

    # the JAX gradients laid out as the port's parameters: loaded into a
    # second tower as if they were weights (the int8 leaves keep theirs)
    gleaves = list(flat)
    for i, w in zip(fl, want[1:]):
        gleaves[i] = w
    grad_tower = SiglipVisionTower(tiny_config().vision, dtype=torch.float32, quant=True)
    load_siglip(grad_tower, jax.tree_util.tree_unflatten(tree, gleaves))

    tower = SiglipVisionTower(tiny_config().vision, dtype=torch.float32, quant=True)
    load_siglip(tower, params)
    named = [(n, p) for n, p in tower.named_parameters() if p.is_floating_point()]
    for _, p in named:
        p.requires_grad_(True)
    pixels = torch.from_numpy(px).requires_grad_(True)
    got_out = tower(pixels)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), atol=1e-4, rtol=1e-4)
    got = torch.autograd.grad(got_out, [pixels, *(p for _, p in named)], torch.from_numpy(g))
    ref = dict(grad_tower.named_parameters())
    # 3 + 12 leaves a layer: JAX stacks the layers, the port does not
    assert len(fl) == 15 and len(named) == 3 + 12 * tiny_config().vision.num_encode_layers
    _assert_grads([t.numpy() for t in got],
                  [want[0], *(ref[n].detach().numpy() for n, _ in named)])
