"""The port's towers against the JAX package's, with seeded flax weights
passed through the weight bridge.  Bar: 1e-4 in fp32 (deep stacks sum in
another order than XLA)."""

import contextlib
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu.models import bert as jbert
from clip_lite_tpu.models import resnet as jresnet
from clip_lite_torch import bridge
from clip_lite_torch.models import bert as tbert
from clip_lite_torch.models import resnet as tresnet
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _threefry():
    """JAX's default PRNG for this module's JAX initialisations: another
    test in the same process may have switched it (``RNG_IMPL`` "rbg"),
    which gives other seeded weights."""
    with jax.default_prng_impl("threefry2x32"):
        yield


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _perturb_bn(variables, seed):
    """Seeded non-trivial BN scale/bias and running statistics."""
    rng = np.random.RandomState(seed)
    out = _np(variables)

    def walk(tree, in_bn):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, in_bn or k == "bn")
            elif in_bn and k in ("mean", "bias"):
                tree[k] = rng.randn(*v.shape).astype(np.float32) * 0.1
            elif in_bn and k in ("var", "scale"):
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    walk(out, False)
    return out


@functools.cache
def _resnet(name):
    """The width-8 JAX ResNet and its seeded variables with perturbed BN,
    shared by the eval and training tests.  The init is jitted: flax's
    eager init compiles op by op, several times as slow."""
    jmod = jresnet.RESNETS[name](width=8)
    v = jax.jit(lambda x: jmod.init(jax.random.PRNGKey(0), x, train=False))(
        jnp.zeros((1, 32, 32, 3), jnp.float32))
    return jmod, _perturb_bn(v, 1)


@pytest.mark.parametrize("name", ["resnet50", "resnet18"])
def test_resnet_eval_matches_jax(name):
    """JAX runs its space-to-depth stem, the port the plain 7x7/s2 conv."""
    images = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    jmod, v = _resnet(name)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        v, jnp.asarray(images))
    port = tresnet.RESNETS[name](width=8)
    port.load_state_dict(bridge.convert(v, port))
    out = port.eval()(torch.from_numpy(images))
    assert out.shape == ref.shape == (2, port.feature_size)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


# Training mode: ResNet-50 at width 8 has 8-channel bottlenecks and, at
# 32 px, BatchNorm over the 8 values of a 1x1 map in its last stage.  Its
# gradients at these seeded weights are ill-conditioned: fp32 rounding
# alone moves them by about 1e-3 (measured), so its fp32 bar is 3e-3.  In
# float64 the two packages agree to 1e-6 (the test after this one), so the
# gap is rounding, not a different function.  ResNet-18 keeps 1e-4.
# ``python tests/test_torch_models.py`` prints how far each package's fp32
# gradients lie from the float64 ones.
TRAIN_TOL = {"resnet18": 1e-4, "resnet50": 3e-3}


class _Float64Numpy(types.ModuleType):
    """``jax.numpy`` with ``float32`` read as ``float64``: the JAX ResNet
    names its compute and parameter types ``jnp.float32``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _train_mode(name, batch=8, crop=32, float64=False):
    """Features and parameter gradients of sum(features * w) in training
    mode, from the JAX ResNet and from the port, with the same weights
    (:func:`_resnet`) and inputs: ``(jax_out, jax_grads, jax_stats,
    port_out, port)``.  ``float64`` runs both in float64."""
    rng = np.random.RandomState(0)
    jmod, v = _resnet(name)
    port = tresnet.RESNETS[name](width=8)
    port.load_state_dict(bridge.convert(v, port))
    dt = np.float64 if float64 else np.float32
    images = rng.randn(batch, crop, crop, 3).astype(dt)
    w = rng.randn(batch, port.feature_size).astype(dt)

    def loss(params):
        out, mutated = jmod.apply(
            {"params": params, "batch_stats": v["batch_stats"]},
            jnp.asarray(images), train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mutated["batch_stats"])

    with contextlib.ExitStack() as stack:
        if float64:
            stack.enter_context(jax.enable_x64(True))
            stack.enter_context(pytest.MonkeyPatch.context()).setattr(
                jresnet, "jnp", _Float64Numpy("jnp"))
        params = jax.tree.map(lambda a: jnp.asarray(a, dt), v["params"])
        (_, (ref, stats)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params)
        ref, grads, stats = np.asarray(ref, np.float64), _np(grads), _np(stats)
    if float64:
        for p in port.parameters():
            p.data = p.data.double()
        for m in port.modules():
            if hasattr(m, "compute_dtype"):
                m.compute_dtype = torch.float64
    out = port.train()(torch.from_numpy(images))
    (out * torch.from_numpy(w)).sum().backward()
    return ref, grads, stats, out.detach().double().numpy(), port


def _assert_train_mode_matches(name, tol, **kwargs):
    ref, grads, stats, out, port = _train_mode(name, **kwargs)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol * np.abs(ref).max())
    want = bridge.convert({"params": grads, "batch_stats": stats}, port)
    for key, p in port.named_parameters():
        g = want[key].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=tol,
                                   atol=tol * np.abs(g).max(), err_msg=key)
    for key, buf in port.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[key].numpy(), rtol=tol,
                                   atol=tol, err_msg=key)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_resnet_train_grads_match_jax(name):
    """Train-mode BatchNorm (batch statistics, running statistics moved),
    features and the gradients of every parameter for sum(features * w)."""
    _assert_train_mode_matches(name, TRAIN_TOL[name])


@pytest.mark.parametrize("batch,crop", [(8, 32), (16, 64)])
def test_resnet50_train_grads_match_jax_float64(batch, crop):
    """As above, both packages in float64 (the JAX grads rounded to fp32
    by the bridge), at the fp32 test's size and at 16 images of 64 px."""
    _assert_train_mode_matches("resnet50", 1e-6, batch=batch, crop=crop,
                               float64=True)


def test_bert_eval_matches_jax_pallas_kernel():
    """2 layers, hidden 128, 2 heads; the JAX tower runs the fused Pallas
    kernel in interpret mode, the port its attention wrapper."""
    b, s, vocab = 4, 12, 128
    rng = np.random.RandomState(0)
    ids = rng.randint(103, vocab, (b, s)).astype(np.int32)
    lengths = np.array([12, 9, 5, 2])
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    ids = ids * mask
    jmod = jbert.BertModel(vocab_size=vocab, hidden_size=128,
                           num_hidden_layers=2, num_heads=2,
                           intermediate_size=512, fused_attention="true")
    v = jax.jit(lambda i, m: jmod.init(jax.random.PRNGKey(0), i, m))(
        jnp.asarray(ids), jnp.asarray(mask))
    seq_ref, pooled_ref = jax.jit(jmod.apply)(v, jnp.asarray(ids),
                                              jnp.asarray(mask))
    port = tbert.BertModel(vocab_size=vocab, hidden_size=128,
                           num_hidden_layers=2, num_heads=2,
                           intermediate_size=512, fused_attention="true")
    port.load_state_dict(bridge.convert(_np(v), port))
    seq, pooled = port.eval()(torch.from_numpy(ids).long(),
                              torch.from_numpy(mask).long())
    np.testing.assert_allclose(seq.detach().numpy(), np.asarray(seq_ref),
                               **TOL)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(pooled_ref),
                               **TOL)


def test_frozen_image_tower_stays_in_eval():
    """MODEL.VISUAL.FROZEN: the backbone keeps eval-mode BatchNorm and takes
    no gradients even when the model is put in training mode."""
    from clip_lite_torch.models.image_encoder import ImageEncoder

    enc = ImageEncoder("resnet18", frozen=True, width=8).train()
    assert enc.training and not enc.backbone.training
    assert not any(p.requires_grad for p in enc.parameters())
    assert ImageEncoder("resnet18", width=8).train().backbone.training


if __name__ == "__main__":
    # Readings for the bars above: how far each package's fp32 training-mode
    # gradients lie from the port's float64 ones, as max|g - g64| over all
    # parameters / max|g64| ("max"), the largest such ratio of one
    # parameter ("worst"), and the gradients' global norm.  Run from the
    # root of the repo: JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_models.py
    for name in ("resnet18", "resnet50"):
        for batch, crop in ((8, 32), (16, 64)):
            *_, port64 = _train_mode(name, batch, crop, float64=True)
            g64 = {k: p.grad.numpy() for k, p in port64.named_parameters()}
            _, jgrads, jstats, _, port32 = _train_mode(name, batch, crop)
            runs = {"port fp32": {k: p.grad.double().numpy()
                                  for k, p in port32.named_parameters()}}
            jax32 = bridge.convert({"params": jgrads, "batch_stats": jstats},
                                   port32)
            runs["JAX fp32"] = {k: jax32[k].double().numpy() for k in g64}
            scale = max(np.abs(g).max() for g in g64.values())
            norm64 = np.sqrt(sum((g ** 2).sum() for g in g64.values()))
            for label, g in runs.items():
                diffs = {k: np.abs(g[k] - g64[k]).max() for k in g64}
                worst = max(diffs, key=lambda k: diffs[k] / np.abs(g64[k]).max())
                norm = np.sqrt(sum((x ** 2).sum() for x in g.values()))
                print(f"{name} batch {batch} crop {crop} {label} vs float64: "
                      f"max {max(diffs.values()) / scale:.3e}, worst "
                      f"{diffs[worst] / np.abs(g64[worst]).max():.3e} ({worst}), "
                      f"global norm {norm} vs {norm64}")
