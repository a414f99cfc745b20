"""The port's JSD InfoMax objective (clip_lite_torch/ops/loss.py) against
the JAX package's ``JSDInfoMaxLoss.apply``: the same parameters (bridged),
features and prior noise.  The noise is injected by replacing
``jax.random.uniform`` for the test's duration with a function that
returns the test's numpy arrays by shape; the port takes the same arrays
as ``prior_noise``.  Bar: 1e-5 on the components, 1e-4 on gradients and
BatchNorm running statistics (fp32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu.ops import loss as jloss
from clip_lite_tpu.parallel import collectives as jcollectives
from clip_lite_torch import bridge
from clip_lite_torch.ops.layers import StepRNG
from clip_lite_torch.ops.loss import JSDInfoMaxLoss
from clip_lite_torch.parallel.collectives import roll_shifted_left

B, IMG, TXT = 8, 24, 16
COMPONENTS = ("total_loss", "cross_modal_loss", "visual_loss", "textual_loss")


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    feats = {"image": rng.randn(B, IMG).astype(np.float32),
             "text": rng.randn(B, TXT).astype(np.float32)}
    noise = {"image": rng.uniform(size=(B, IMG)).astype(np.float32),
             "text": rng.uniform(size=(B, TXT)).astype(np.float32)}
    jmod = jloss.JSDInfoMaxLoss(image_dim=IMG, text_dim=TXT, image_prior=True,
                                text_prior=True, negatives="global",
                                prior_weight=0.1)
    variables = jmod.init({"params": jax.random.PRNGKey(0),
                           "prior": jax.random.PRNGKey(1)},
                          jnp.asarray(feats["image"]), jnp.asarray(feats["text"]),
                          train=False)
    variables = jax.tree.map(np.asarray, variables)
    return jmod, variables, feats, noise


def inject_uniform(monkeypatch, noise):
    """Replace ``jax.random.uniform`` by a lookup of the test's arrays by
    shape; other shapes (flax's shape checks of initialisers) go to the
    real function."""
    by_shape = {v.shape: v for v in noise.values()}
    real = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) in by_shape:
            return jnp.asarray(by_shape[tuple(shape)])
        return real(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", uniform)


def _jax_run(monkeypatch, jmod, variables, feats, noise):
    inject_uniform(monkeypatch, noise)

    def total(params, img, txt):
        out, mutated = jmod.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            img, txt, train=True, mutable=["batch_stats"],
            rngs={"prior": jax.random.PRNGKey(2)})
        return out["total_loss"], (out, mutated["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(
        total, argnums=(0, 1, 2), has_aux=True))(
        variables["params"], jnp.asarray(feats["image"]),
        jnp.asarray(feats["text"]))
    return jax.tree.map(np.asarray, (out, stats, grads))


def _port(variables):
    port = JSDInfoMaxLoss(IMG, TXT, image_prior=True, text_prior=True,
                          negatives="global", prior_weight=0.1)
    port.load_state_dict(bridge.convert(variables, port))
    return port


def test_objective_matches_jax(monkeypatch, case):
    jmod, variables, feats, noise = case
    out, stats, (gparams, gimg, gtxt) = _jax_run(monkeypatch, jmod, variables,
                                                 feats, noise)
    port = _port(variables).train()
    img = torch.from_numpy(feats["image"]).requires_grad_()
    txt = torch.from_numpy(feats["text"]).requires_grad_()
    got = port(img, txt, prior_noise={k: torch.from_numpy(v)
                                      for k, v in noise.items()})
    got["total_loss"].backward()
    for name in COMPONENTS:
        np.testing.assert_allclose(got[name].item(), out[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(img.grad.numpy(), gimg, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(txt.grad.numpy(), gtxt, rtol=1e-4, atol=1e-6)
    # Parameter gradients, mapped onto the port's names by the bridge.
    want = bridge.convert({"params": gparams, "batch_stats": stats}, port)
    params = dict(port.named_parameters())
    assert len(params) > 20
    for key, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[key].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    # The heads' BN running statistics after one train-mode call: both
    # critic calls moved them, in the same order.
    want = bridge.convert({"params": variables["params"], "batch_stats": stats},
                          port)
    buffers = dict(port.named_buffers())
    assert len(buffers) == 4
    for key, buf in buffers.items():
        np.testing.assert_allclose(buf.numpy(), want[key].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    once = _port(variables).train()
    with torch.no_grad():
        once.global_d(torch.from_numpy(feats["image"]),
                      torch.from_numpy(feats["text"]))
    assert not np.allclose(
        once.global_d.img_block.nonlinear_bn.running_mean.numpy(),
        port.global_d.img_block.nonlinear_bn.running_mean.numpy())


def test_eval_mode_matches_jax(monkeypatch, case):
    jmod, variables, feats, noise = case
    inject_uniform(monkeypatch, noise)
    ref = jmod.apply(variables, jnp.asarray(feats["image"]),
                     jnp.asarray(feats["text"]), train=False,
                     rngs={"prior": jax.random.PRNGKey(2)})
    port = _port(variables).eval()
    with torch.no_grad():
        got = port(*(torch.from_numpy(feats[k]) for k in ("image", "text")),
                   prior_noise={k: torch.from_numpy(v) for k, v in noise.items()})
    for name in COMPONENTS:
        np.testing.assert_allclose(got[name].item(), float(ref[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_noise_from_step_rng_and_refusals(case):
    _, variables, feats, _ = case
    port = _port(variables).eval()
    img, txt = (torch.from_numpy(feats[k]) for k in ("image", "text"))
    with torch.no_grad():
        a = port(img, txt, rng=StepRNG(0, 3, "cpu"))["total_loss"]
        b = port(img, txt, rng=StepRNG(0, 3, "cpu"))["total_loss"]
        c = port(img, txt, rng=StepRNG(0, 4, "cpu"))["total_loss"]
        assert a.item() == b.item() != c.item()
        with pytest.raises(ValueError):
            port(img, txt)  # priors with no noise and no generator
        with pytest.raises(ValueError, match="both"):  # half of cluster mode
            port(img, txt, neg_text_features=txt, rng=StepRNG(0, 0, "cpu"))
        with pytest.raises(ValueError):  # a loss built without visual SSL
            port(img, txt, aug_image_features=img, rng=StepRNG(0, 0, "cpu"))


@pytest.mark.parametrize("scope", ["local", "global"])
def test_roll_matches_jax(scope):
    x = np.arange(15, dtype=np.float32).reshape(5, 3)
    want = np.asarray(jcollectives.roll_shifted_left(jnp.asarray(x), "data",
                                                     scope))
    np.testing.assert_array_equal(roll_shifted_left(torch.from_numpy(x),
                                                    scope).numpy(), want)
    with pytest.raises(ValueError):
        roll_shifted_left(torch.from_numpy(x), "galaxy")
