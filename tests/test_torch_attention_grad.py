"""Gradients of the port's fused attention (the autograd Function: K1
forward, K2 backward) against the JAX package's.

On the CPU the Function runs its two plain twins (``attention_reference``
and ``attention_backward_reference``, the step-by-step copy of K2's
math).  Each case goes through ``jax.grad`` of the Pallas pair in
interpret mode (``fused_short_attention(..., interpret=True)``) and of
``_xla_attention``, with the same seeded numpy inputs and, for dropout,
the same keep mask handed to the port.  Bar: 1e-5 (fp32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu.ops import attention as jax_attention
from clip_lite_torch.ops.attention import (
    MASK_VALUE,
    attention_backward,
    attention_backward_reference,
    attention_forward,
    attention_reference,
    dropout_keep_mask,
    fused_short_attention,
    philox_keep_mask,
)
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


HD = 64
TOL = dict(rtol=1e-5, atol=1e-5)
# (B, S, NH): even B, so the JAX wrapper takes its Pallas kernel.
SHAPES = [(2, 1, 1), (4, 30, 2), (2, 17, 3), (2, 256, 1)]


def _case(b, s, nh, seed=0):
    rng = np.random.RandomState(seed)
    qkv = (rng.randn(b, s, 3 * nh * HD) * 0.5).astype(np.float32)
    lengths = rng.randint(1, s + 1, b)
    lengths[0] = s
    mask = np.arange(s)[None, :] < lengths[:, None]
    bias = ((1.0 - mask) * MASK_VALUE).astype(np.float32)
    w = rng.randn(b, s, nh * HD).astype(np.float32)  # loss = sum(out * w)
    return qkv, bias, w


def _jax_grad(fn, qkv, bias, w):
    return np.asarray(jax.grad(lambda x: jnp.sum(fn(x) * w))(jnp.asarray(qkv)))


def _port_grad(qkv, bias, w, nh, rate, keep):
    x = torch.from_numpy(qkv).requires_grad_()
    out = fused_short_attention(x, torch.from_numpy(bias), nh,
                                dropout_rate=rate, deterministic=rate == 0.0,
                                keep_mask=keep)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(w))
    return x.grad.numpy()


@pytest.mark.parametrize("rate", [0.0, 0.3], ids=["rate0", "rate0.3"])
@pytest.mark.parametrize("b,s,nh", SHAPES, ids=[f"{b}x{s}x{nh}" for b, s, nh in SHAPES])
def test_grad_matches_jax_pallas_interpret(b, s, nh, rate):
    qkv, bias, w = _case(b, s, nh)
    key = jax.random.PRNGKey(5)
    keep = None
    if rate:
        # The JAX wrapper's own seed draw and interpret-mode keep mask.
        seed = jax.random.randint(key, (1,), -2 ** 31, 2 ** 31 - 1,
                                  dtype=jnp.int32)
        keep = torch.from_numpy(np.asarray(
            jax_attention._external_keep_mask(seed, b, nh, s, rate)))
    ref = _jax_grad(lambda x: jax_attention.fused_short_attention(
        x, jnp.asarray(bias), nh, dropout_rate=rate,
        dropout_rng=key if rate else None, deterministic=rate == 0.0,
        interpret=True), qkv, bias, w)
    np.testing.assert_allclose(_port_grad(qkv, bias, w, nh, rate, keep), ref,
                               **TOL)


@pytest.mark.parametrize("rate", [0.0, 0.3], ids=["rate0", "rate0.3"])
@pytest.mark.parametrize("b,s,nh", SHAPES, ids=[f"{b}x{s}x{nh}" for b, s, nh in SHAPES])
def test_grad_matches_jax_xla(b, s, nh, rate):
    qkv, bias, w = _case(b, s, nh, seed=1)
    key = jax.random.PRNGKey(7)
    keep = None
    if rate:
        keep = torch.from_numpy(np.asarray(
            jax.random.bernoulli(key, 1.0 - rate, (b, nh, s, s))))
    ref = _jax_grad(lambda x: jax_attention._xla_attention(
        x, jnp.asarray(bias), nh, rate, key if rate else None), qkv, bias, w)
    np.testing.assert_allclose(_port_grad(qkv, bias, w, nh, rate, keep), ref,
                               **TOL)


def test_backward_twin_matches_autograd_of_forward_twin():
    """K2's step-by-step twin against torch autograd through K1's twin."""
    qkv, bias, w = _case(4, 30, 2, seed=2)
    keep = philox_keep_mask(11, 4, 2, 30, 0.1)
    x = torch.from_numpy(qkv).requires_grad_()
    attention_reference(x, torch.from_numpy(bias), 2, 0.1, keep).backward(
        torch.from_numpy(w))
    twin, dbias = attention_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(bias), torch.from_numpy(w), 2,
        0.1, keep)
    np.testing.assert_allclose(twin.numpy(), x.grad.numpy(), **TOL)
    assert dbias is None  # a key bias gets no gradient


# The full (B, NH, S, S) bias (MPNet): dqkv and dbias against jax.grad
# with respect to both.  Bar 1e-4, the JAX package's own between its two
# paths (tests/test_attention.py::test_full_bias_grads_match_xla).
FULL_TOL = dict(rtol=1e-4, atol=1e-4)
FULL_SHAPES = [(4, 30, 2), (2, 17, 3)]


def _full_case(b, s, nh, seed=0):
    qkv, key_bias, w = _case(b, s, nh, seed)
    rel = np.random.RandomState(seed + 100).randn(1, nh, s, s) * 0.5
    return qkv, (rel + key_bias[:, None, None, :]).astype(np.float32), w


def _jax_full_grads(fn, qkv, bias, w):
    grads = jax.grad(lambda x, y: jnp.sum(fn(x, y) * w), argnums=(0, 1))(
        jnp.asarray(qkv), jnp.asarray(bias))
    return [np.asarray(g) for g in grads]


def _port_full_grads(qkv, bias, w, nh, rate, keep):
    x = torch.from_numpy(qkv).requires_grad_()
    y = torch.from_numpy(bias).requires_grad_()
    fused_short_attention(x, y, nh, dropout_rate=rate, deterministic=rate == 0.0,
                          keep_mask=keep).backward(torch.from_numpy(w))
    assert y.grad.dtype == torch.float32 and y.grad.shape == y.shape
    return [x.grad.numpy(), y.grad.numpy()]


@pytest.mark.parametrize("rate", [0.0, 0.3], ids=["rate0", "rate0.3"])
@pytest.mark.parametrize("b,s,nh", FULL_SHAPES,
                         ids=[f"{b}x{s}x{nh}" for b, s, nh in FULL_SHAPES])
def test_full_bias_grads_match_jax_pallas_interpret(b, s, nh, rate):
    qkv, bias, w = _full_case(b, s, nh)
    key = jax.random.PRNGKey(5)
    keep = None
    if rate:
        seed = jax.random.randint(key, (1,), -2 ** 31, 2 ** 31 - 1,
                                  dtype=jnp.int32)
        keep = torch.from_numpy(np.asarray(
            jax_attention._external_keep_mask(seed, b, nh, s, rate)))
    ref = _jax_full_grads(lambda x, y: jax_attention.fused_short_attention(
        x, y, nh, dropout_rate=rate, dropout_rng=key if rate else None,
        deterministic=rate == 0.0, interpret=True), qkv, bias, w)
    for got, want in zip(_port_full_grads(qkv, bias, w, nh, rate, keep), ref):
        np.testing.assert_allclose(got, want, **FULL_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.3], ids=["rate0", "rate0.3"])
@pytest.mark.parametrize("b,s,nh", FULL_SHAPES,
                         ids=[f"{b}x{s}x{nh}" for b, s, nh in FULL_SHAPES])
def test_full_bias_grads_match_jax_xla(b, s, nh, rate):
    qkv, bias, w = _full_case(b, s, nh, seed=1)
    key = jax.random.PRNGKey(7)
    keep = None
    if rate:
        keep = torch.from_numpy(np.asarray(
            jax.random.bernoulli(key, 1.0 - rate, (b, nh, s, s))))
    ref = _jax_full_grads(lambda x, y: jax_attention._xla_attention(
        x, y, nh, rate, key if rate else None), qkv, bias, w)
    for got, want in zip(_port_full_grads(qkv, bias, w, nh, rate, keep), ref):
        np.testing.assert_allclose(got, want, **FULL_TOL)


def test_full_bias_backward_twin_matches_autograd_of_forward_twin():
    """K2's twin returns dbias = ds in fp32, unscaled: torch autograd of
    K1's twin with respect to the bias."""
    qkv, bias, w = _full_case(4, 30, 2, seed=2)
    keep = philox_keep_mask(11, 4, 2, 30, 0.1)
    x = torch.from_numpy(qkv).requires_grad_()
    y = torch.from_numpy(bias).requires_grad_()
    attention_reference(x, y, 2, 0.1, keep).backward(torch.from_numpy(w))
    dqkv, dbias = attention_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(bias), torch.from_numpy(w), 2,
        0.1, keep)
    assert dbias.dtype == torch.float32
    np.testing.assert_allclose(dqkv.numpy(), x.grad.numpy(), **TOL)
    np.testing.assert_allclose(dbias.numpy(), y.grad.numpy(), **TOL)


def test_cuda_less_tensor_gets_grad_fn_and_counts_no_launch():
    """The repaired fault: the wrapper's output carries a gradient, and on
    the CPU neither kernel is counted."""
    qkv, bias, w = _case(2, 12, 2)
    k1, k2 = fused_short_attention.launches, attention_backward.launches
    got = _port_grad(qkv, bias, w, 2, 0.0, None)
    assert np.abs(got).sum() > 0
    assert (fused_short_attention.launches, attention_backward.launches) == (k1, k2)


def test_seeded_dropout_same_mask_both_directions():
    """With a seed and no mask, both directions draw Philox's mask: the
    Function equals the twins given that mask explicitly."""
    qkv, bias, w = _case(2, 20, 2, seed=3)
    keep = dropout_keep_mask(1234, 2, 2, 20, 0.2)
    x = torch.from_numpy(qkv).requires_grad_()
    out = fused_short_attention(x, torch.from_numpy(bias), 2, dropout_rate=0.2,
                                deterministic=False, seed=1234)
    out.backward(torch.from_numpy(w))
    np.testing.assert_allclose(
        out.detach().numpy(),
        attention_forward(torch.from_numpy(qkv), torch.from_numpy(bias), 2,
                          dropout_rate=0.2, keep_mask=keep).numpy(), **TOL)
    np.testing.assert_allclose(
        x.grad.numpy(),
        attention_backward(torch.from_numpy(qkv), torch.from_numpy(bias),
                           torch.from_numpy(w), 2, dropout_rate=0.2,
                           keep_mask=keep)[0].numpy(), **TOL)


def test_philox_mask_keep_rate_and_seeds():
    a = philox_keep_mask(7, 8, 4, 30, 0.1)
    assert a.shape == (8, 4, 30, 30) and a.dtype == torch.bool
    assert abs(a.float().mean().item() - 0.9) < 0.01  # 28,800 draws
    assert torch.equal(a, philox_keep_mask(7, 8, 4, 30, 0.1))
    assert not torch.equal(a, philox_keep_mask(8, 8, 4, 30, 0.1))
    # A seed above 2**32 reaches the key's high word.
    assert not torch.equal(philox_keep_mask(7 + 2 ** 32, 8, 4, 30, 0.1), a)


@pytest.mark.parametrize("key,counter,first", [
    (0, (0, 0, 0, 0), 0x6627E8D5),
    (2 ** 64 - 1, (2 ** 32 - 1,) * 4, 0x408F276D),
    (0xA4093822 | 0x299F31D0 << 32,
     (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), 0xD16CFE09),
])
def test_philox_matches_known_answers(key, counter, first):
    """Philox4x32-10's published known-answer vectors (Random123,
    kat_vectors: key words low first, counter words c0..c3, first output
    word) pin the numpy twin, and so the CUDA function it copies."""
    from clip_lite_torch.ops import attention as port

    c0, c1, c2, c3 = (np.array([c], np.uint64) for c in counter)
    assert int(port._philox_bits(key, c3, c2, c1, c0)[0]) == first
