"""The port's towers against the JAX package's, with seeded flax weights
passed through the weight bridge.  Bar: 1e-4 in fp32 (deep stacks sum in
another order than XLA)."""

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

TOL = dict(rtol=1e-4, atol=1e-4)


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


@pytest.mark.parametrize("name", ["resnet50", "resnet18"])
def test_resnet_eval_matches_jax(name):
    """JAX runs its space-to-depth stem, the port the plain 7x7/s2 conv."""
    images = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    jmod = jresnet.RESNETS[name](width=8)
    v = _perturb_bn(jmod.init(jax.random.PRNGKey(0), jnp.asarray(images),
                              train=False), 1)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        v, jnp.asarray(images))
    port = tresnet.RESNETS[name](width=8)
    port.load_state_dict(bridge.convert(v, port))
    out = port.eval()(torch.from_numpy(images))
    assert out.shape == ref.shape == (2, port.feature_size)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


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
    v = jmod.init(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
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
