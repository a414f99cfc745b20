"""The model zoo (``clip_lite_torch/models/zoo.py``) against the JAX
package's ``models/zoo.py`` on the CPU: one member of each backbone family,
the classifier heads and the distillation modules, from the same seeded
variables (bridged) on the same seeded NHWC inputs; and one training step
of ``zoo::resnet8`` as the visual tower of the flagship cut to a tiny
size, against the JAX step.

Bars (relative to the largest value, fp32): eval mode 1e-5; train mode
(batch statistics) 1e-4 for a tower's output and 5e-4 for the per-stage
maps of ``return_features`` (ResNet50's last stage reaches 2.2e-4 at these
weights: 16 bottlenecks, each normalizing by the statistics of two
images); the running statistics after a train pass 1e-4 (they take the
batch variances); a module 1e-5.
The grouped and depthwise convolutions (MobileNetV2, ShuffleV1/V2) need
no wider bar.  The complete sweep over every ``model_dict`` entry is the
JAX package's own ``tests/test_zoo.py`` (``slow``); here each family runs
once."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu.models import zoo as jzoo
from clip_lite_torch import bridge
from clip_lite_torch.models import zoo
from clip_lite_torch.models.image_encoder import BACKBONES, ImageEncoder
from torch_matrix import (
    FLAGSHIP,
    assert_steps_match,
    jax_steps,
    port_steps,
    rel,
    seeded_variables,
)
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

FAMILIES = ["resnet8", "ResNet50", "wrn_16_1", "vgg8", "MobileNetV2",
            "ShuffleV1", "ShuffleV2"]


def _images(b=2, size=32, c=3, seed=0):
    return np.random.RandomState(seed).standard_normal(
        (b, size, size, c)).astype(np.float32)


def _port(module, variables):
    module.load_state_dict(bridge.convert(variables, module))
    return module


@pytest.mark.parametrize("name", FAMILIES)
def test_backbone_matches_jax(name):
    """Eval logits, train logits and every ``return_features`` map, and the
    BatchNorm running statistics the train pass leaves."""
    jm = jzoo.model_dict[name](num_classes=10)
    x = _images()
    v = seeded_variables(jm, x, train=False)

    @jax.jit
    def run(v, x):
        logits = jm.apply(v, x, train=False)
        (feats, train_logits), new = jm.apply(
            v, x, train=True, return_features=True, mutable=["batch_stats"])
        return logits, feats, train_logits, new["batch_stats"]

    logits, feats, train_logits, stats = jax.tree.map(np.asarray, run(v, x))
    pm = _port(zoo.model_dict[name](num_classes=10), v)
    assert pm.feature_size == jm.feature_size
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
        got_feats, got_train = pm.train()(torch.from_numpy(x),
                                          return_features=True)
    assert rel(got, logits) < 1e-5
    assert rel(got_train, train_logits) < 1e-4
    assert len(got_feats) == len(feats)
    for i, (a, b) in enumerate(zip(got_feats, feats)):
        assert a.shape == b.shape, i
        assert rel(a, b) < 5e-4, (i, rel(a, b))
    want = bridge.convert({"params": v["params"], "batch_stats": stats}, pm)
    for key, value in pm.state_dict().items():
        if "running" in key:
            assert rel(value, want[key]) < 1e-4, key


def test_channel_shuffle_matches_jax():
    x = _images(2, 5, 12)
    want = np.asarray(jzoo.channel_shuffle(jnp.asarray(x), 3))
    got = zoo.channel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 3)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def _heads():
    """(name, JAX module, port constructor taking ``in_features`` or
    ``in_channels``, input, JAX call keywords)."""
    flat, maps = _images(2, 1, 64)[:, 0, 0], _images(2, 8, 16, seed=1)
    return [
        ("LinearClassifier", jzoo.LinearClassifierHead(10),
         functools.partial(zoo.LinearClassifierHead, 64, 10), flat,
         dict(train=False)),
        ("NonLinearClassifier", jzoo.NonLinearClassifierHead(10),
         functools.partial(zoo.NonLinearClassifierHead, 64, 10), flat,
         dict(train=False)),
        ("Conv4", jzoo.Conv4(10), functools.partial(zoo.Conv4, 10),
         _images(), dict(train=False)),
        ("Conv4MP", jzoo.Conv4MP(10), functools.partial(zoo.Conv4MP, 10),
         _images(), dict(train=False)),
        ("Embed", jzoo.Embed(32), functools.partial(zoo.Embed, 8 * 8 * 16, 32),
         maps, {}),
        ("LinearEmbed", jzoo.LinearEmbed(32),
         functools.partial(zoo.LinearEmbed, 8 * 8 * 16, 32), maps, {}),
        ("MLPEmbed", jzoo.MLPEmbed(32),
         functools.partial(zoo.MLPEmbed, 8 * 8 * 16, 32), maps, {}),
        ("Regress", jzoo.Regress(32),
         functools.partial(zoo.Regress, 8 * 8 * 16, 32), maps, {}),
        ("ConvReg", jzoo.ConvReg(32), functools.partial(zoo.ConvReg, 16, 32),
         maps, dict(train=False)),
        ("Paraphraser", jzoo.Paraphraser(0.5),
         functools.partial(zoo.Paraphraser, 16, 0.5), maps, dict(train=False)),
        ("Translator", jzoo.Translator(0.5, 24),
         functools.partial(zoo.Translator, 16, 0.5, 24), maps,
         dict(train=False)),
        ("Connector", jzoo.Connector(24), functools.partial(zoo.Connector, 16, 24),
         maps, dict(train=False)),
        # 8 -> 3: the antialiased shrink.
        ("PoolEmbed", jzoo.PoolEmbed(32, 3),
         functools.partial(zoo.PoolEmbed, 16, 32, 3), maps, {}),
    ]


@pytest.mark.parametrize("case", _heads(), ids=lambda c: c[0])
def test_head_matches_jax(case):
    _, jm, ctor, x, kw = case
    v = seeded_variables(jm, x, **kw)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, x: jm.apply(v, x, **kw))(v, x))
    pm = _port(ctor(), v).eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        assert rel(a, b) < 1e-5


def test_train_mode_heads_match_jax():
    """ConvReg and Paraphraser in training (batch statistics), and
    ``flatten_features`` in NHWC order."""
    x = _images(2, 8, 16, seed=2)
    for jm, pm in ((jzoo.ConvReg(32), zoo.ConvReg(16, 32)),
                   (jzoo.Paraphraser(0.5), zoo.Paraphraser(16, 0.5))):
        v = seeded_variables(jm, x, train=False)
        want, _ = jm.apply(v, x, train=True, mutable=["batch_stats"])
        with torch.no_grad():
            got = _port(pm, v).train()(torch.from_numpy(x))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert rel(a, np.asarray(b)) < 1e-5
    np.testing.assert_array_equal(
        zoo.flatten_features(torch.from_numpy(x)).numpy(),
        np.asarray(jzoo.flatten_features(jnp.asarray(x))))


def test_zoo_backbones_registered():
    """Every JAX ``zoo::`` tower is a port backbone, a feature extractor of
    the same width, and keeps per-rank BatchNorm under ``bn_mode`` sync."""
    from clip_lite_tpu.models.image_encoder import BACKBONES as JBACKBONES

    assert {k for k in BACKBONES if k.startswith("zoo::")} == \
        {k for k in JBACKBONES if k.startswith("zoo::")}
    assert set(zoo.model_dict) == set(jzoo.model_dict)
    enc = ImageEncoder("zoo::resnet8", bn_mode="sync")
    assert enc.feature_size == 64
    assert not any(getattr(m, "sync", False) for m in enc.modules())
    assert ImageEncoder("vgg11_bn", bn_mode="sync").backbone.bn0.sync


def _batch(rng, b=8, crop=32, length=8):
    lengths = rng.randint(2, length + 1, b)
    return {"image": rng.randn(b, crop, crop, 3).astype(np.float32),
            "input_ids": rng.randint(1, 128, (b, length)).astype(np.int32),
            "attention_mask": (np.arange(length)[None, :] < lengths[:, None]
                               ).astype(np.int32)}


TINY_TEXT = ["AMP", False, "DATA.IMAGE_CROP_SIZE", 32,
             "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 1,
             "MODEL.TEXTUAL.HIDDEN_SIZE", 128, "DATA.MAX_CAPTION_LENGTH", 8,
             "MODEL.TEXTUAL.VOCAB_SIZE", 128, "MODEL.TEXTUAL.DROPOUT", 0.0,
             "OPTIM.WARMUP_STEPS", 0, "OPTIM.NUM_ITERATIONS", 20,
             "OPTIM.CNN_LR", 0.002]


def test_zoo_training_step_matches_jax():
    """One step of the flagship with ``zoo::resnet8`` (64-d features) and a
    one-layer BERT of 128, no warmup: the loss components and grad norm,
    the gradients and the state after the step at 1e-4; but the image tower's
    gradients at 5e-2 of each tensor's largest.  There JAX's fp32 is what
    strays: given the same gradient from the loss, its layer1 gradients lie
    3.6e-2 from the port's tower evaluated in float64 (flax's BatchNorm
    takes the variance as E[x^2] - E[x]^2, which cancels on the post-ReLU
    maps, and the loss's gradient is nearly the same for every image, so
    little survives the normalization's backward), the port's fp32 ones
    6e-6."""
    overrides = ["MODEL.VISUAL.NETWORK_NAME", "zoo::resnet8",
                 "MODEL.VISUAL.FEATURE_SIZE", 64] + TINY_TEXT
    rng = np.random.RandomState(0)
    batches = [_batch(rng)]
    noise = {"image": rng.uniform(size=(8, 64)).astype(np.float32),
             "text": rng.uniform(size=(8, 128)).astype(np.float32)}
    ref = jax_steps(FLAGSHIP, overrides, batches, noise)
    port = port_steps(FLAGSHIP, overrides, batches, noise, ref["variables"])
    assert_steps_match(port, ref, image_grad_rel=5e-2)
