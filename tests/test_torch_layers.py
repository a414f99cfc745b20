"""The port's shared layers (clip_lite_torch/ops/layers.py) and projection
heads (ops/loss.py) against flax, with the weights passed through the
weight bridge.  Bar: 1e-5 in fp32."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu.ops import layers as jl
from clip_lite_tpu.ops import loss as jloss
from clip_lite_torch import bridge
from clip_lite_torch.ops import layers as tl
from clip_lite_torch.ops import loss as tloss

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _load(module, variables):
    module.load_state_dict(bridge.convert(_np(variables), module))
    return module


def _perturb_stats(variables, seed):
    """Non-trivial BN parameters and running statistics."""
    rng = np.random.RandomState(seed)
    out = _np(variables)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("mean", "bias"):
                tree[k] = rng.randn(*v.shape).astype(np.float32) * 0.3
            elif k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    walk(out)
    return out


@pytest.fixture(scope="module")
def x():
    return np.random.RandomState(0).randn(6, 24).astype(np.float32)


def test_linear_matches_flax(x):
    mod = jl.Linear(16)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = _load(tl.Linear(24, 16), v)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(mod.apply(v, jnp.asarray(x))), **TOL)


def test_linear_init_is_torch_default():
    lin = tl.Linear(400, 300)
    lin.init_weights(torch.Generator().manual_seed(0))
    bound = 1 / 20.0
    for t in (lin.weight, lin.bias):
        assert t.abs().max() <= bound
        assert t.abs().max() > 0.95 * bound


def test_batchnorm_eval_matches_flax(x):
    mod = jl.BatchNorm(use_running_average=True)
    v = _perturb_stats(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    port = _load(tl.BatchNorm(24), v).eval()
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(mod.apply(v, jnp.asarray(x))), **TOL)


def test_batchnorm_train_matches_flax(x):
    """Batch statistics normalize; running stats move by momentum 0.1 (flax
    decay 0.9) towards the biased batch variance."""
    mod = jl.BatchNorm(use_running_average=False)
    v = _perturb_stats(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    ref, upd = mod.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = _load(tl.BatchNorm(24), v).train()
    out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    stats = _np(upd["batch_stats"]["BatchNorm_0"])
    np.testing.assert_allclose(port.running_mean.numpy(), stats["mean"], **TOL)
    np.testing.assert_allclose(port.running_var.numpy(), stats["var"], **TOL)


def test_layernorm_matches_flax(x):
    mod = jl.LayerNorm()
    v = _perturb_stats(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    port = _load(tl.LayerNorm(24), v)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(mod.apply(v, jnp.asarray(x))), **TOL)


def test_l2_normalize_matches_flax(x):
    xs = x.copy()
    xs[0] = 0.0  # the eps floor: a zero row stays zero
    np.testing.assert_allclose(tl.l2_normalize(torch.from_numpy(xs)).numpy(),
                               np.asarray(jl.l2_normalize(jnp.asarray(xs))),
                               **TOL)


def test_milinear_block_matches_flax(x):
    mod = jloss.MILinearBlock(units=32)
    v = _perturb_stats(mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                train=False), 4)
    port = _load(tloss.MILinearBlock(24, 32), v).eval()
    np.testing.assert_allclose(
        port(torch.from_numpy(x)).detach().numpy(),
        np.asarray(mod.apply(v, jnp.asarray(x), train=False)), **TOL)


def test_shortcut_init_is_noisy_identity():
    block = tloss.MILinearBlock(24, 32)
    tl.init_weights(block, torch.Generator().manual_seed(0))
    w = block.shortcut.weight.detach()  # (units, feature_sz)
    assert torch.equal(torch.diagonal(w), torch.ones(24))
    off = w.clone()
    off[torch.arange(24), torch.arange(24)] = 0.0
    assert off.abs().max() <= 0.01


def test_prior_discriminator_matches_flax(x):
    mod = jloss.PriorDiscriminator()
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = _load(tloss.PriorDiscriminator(24), v)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(mod.apply(v, jnp.asarray(x))), **TOL)


def test_bf16_compute_keeps_fp32_params(x):
    """Under AMP a layer computes in bf16 and keeps fp32 parameters; its
    normalizations still take fp32 statistics."""
    lin = tl.Linear(24, 16, compute_dtype=torch.bfloat16)
    ln = tl.LayerNorm(16, compute_dtype=torch.bfloat16)
    for m in (lin, ln):
        m.init_weights(torch.Generator().manual_seed(0))
    y = ln(lin(torch.from_numpy(x)))
    assert lin.weight.dtype == torch.float32 and y.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(
        torch.nn.functional.linear(torch.from_numpy(x), lin.weight, lin.bias),
        (16,))
    np.testing.assert_allclose(y.float().detach().numpy(),
                               ref.detach().numpy(), rtol=0, atol=5e-2)
