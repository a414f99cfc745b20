"""VGG (``clip_lite_torch/models/vgg.py``) against the JAX package's
``models/vgg.py`` on the CPU: every depth with and without BatchNorm, from
the same seeded variables (bridged; the classifier's 120M weights shared
by the cases) on the same seeded images, in eval mode and in training
with the classifier's dropout masks injected into both; the resize to
7x7; and two training steps of the flagship with ``vgg11`` and the glove
text mode against the JAX steps.

Bars (relative to the largest value, fp32): a tower's output 1e-4 (its
fc1 sums 25,088 products), the running statistics after a train pass
1e-4, the resize 1e-6.  ``fc1`` reads the 7x7 map in (h, w, c) order in
both packages; a (c, h, w) flatten moves the output by its whole size, so
the parity cases catch it."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu.models import text_encoder as jtext_encoder
from clip_lite_tpu.models import vgg as jvgg
from clip_lite_torch import bridge
from clip_lite_torch.models import text_encoder
from clip_lite_torch.models import vgg
from torch_matrix import (
    FLAGSHIP,
    assert_steps_match,
    jax_steps,
    keep_masks,
    port_steps,
    rel,
    seeded_variables,
)
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

B = 2
_CLASSIFIER: dict = {}  # the seeded fc1-fc3, shared by every case


@pytest.mark.parametrize("size,shape", [((13, 11), (7, 7)), ((2, 2), (7, 7)),
                                        ((9, 7), (4, 3)), ((7, 7), (7, 7))],
                         ids=["shrink", "grow", "mixed", "identity"])
def test_resize_linear_matches_jax(size, shape):
    """``jax.image.resize(..., "linear")``, which antialiases a side that
    shrinks, against ``F.interpolate(antialias=True)`` on the NCHW map."""
    x = np.random.default_rng(0).standard_normal((2, *size, 5), np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *shape, 5),
                                       method="linear"))
    got = vgg.resize_linear(torch.from_numpy(x).permute(0, 3, 1, 2), shape)
    assert rel(got.permute(0, 2, 3, 1), want) < 1e-6


@pytest.mark.parametrize("name,px", [
    ("vgg11", 32), ("vgg13", 32), ("vgg16", 32), ("vgg19", 32),
    ("vgg11_bn", 64), ("vgg13_bn", 32), ("vgg16_bn", 32), ("vgg19_bn", 64)])
def test_vgg_matches_jax(name, px):
    """Eval output, train output (dropout 0.5 with the masks injected) and
    the BatchNorm running statistics the train pass leaves.  At 32 px the
    last map is 1x1 and at 64 px 2x2, each brought up to 7x7."""
    jm = jvgg.VGGS[name]()
    x = np.random.default_rng(1).standard_normal((B, px, px, 3), np.float32)
    v = seeded_variables(jm, x, train=False, cache=_CLASSIFIER)
    masks = keep_masks([(B, 4096)], seed=2)
    real = jax.random.bernoulli
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p=0.5, shape=None: jnp.asarray(
                       masks[tuple(shape)]))

        @jax.jit
        def run(v, x):
            out = jm.apply(v, x, train=False)
            train_out, new = jm.apply(v, x, train=True, mutable=["batch_stats"],
                                      rngs={"dropout": jax.random.PRNGKey(0)})
            return out, train_out, new.get("batch_stats", {})

        out, train_out, stats = jax.tree.map(np.asarray, run(v, x))
    assert jax.random.bernoulli is real
    pm = vgg.VGGS[name]()
    pm.load_state_dict(bridge.convert(v, pm))
    assert pm.feature_size == jm.feature_size == 1000

    class Masks:  # the StepRNG's keep_mask, drawing the injected masks
        device = torch.device("cpu")

        def keep_mask(self, shape, rate):
            assert rate == 0.5
            return torch.from_numpy(masks[tuple(shape)])

    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
        got_train = pm.train()(torch.from_numpy(x), rng=Masks())
    assert rel(got, out) < 1e-4
    assert rel(got_train, train_out) < 1e-4
    want = bridge.convert({"params": v["params"], "batch_stats": stats}, pm)
    for key, value in pm.state_dict().items():
        if "running" in key:
            assert rel(value, want[key]) < 1e-4, key


def test_vgg_backward_matches_jax():
    """``vgg11`` in training, dropout masks injected: the gradients of every
    weight for a seeded gradient of the output, at 1e-5 of the largest.
    Without BatchNorm: behind batch statistics over a few values a
    channel, flax's E[x^2] - E[x]^2 variance leaves JAX's own fp32
    gradients percents from exact (``tests/test_torch_zoo.py``); the
    BatchNorm backward is held in the ResNets' gradient tests
    (``tests/test_torch_models.py``)."""
    jm = jvgg.VGGS["vgg11"]()
    x = np.random.default_rng(4).standard_normal((4, 32, 32, 3), np.float32)
    up = np.random.default_rng(5).standard_normal((4, 1000), np.float32)
    v = seeded_variables(jm, x, train=False, cache=_CLASSIFIER)
    masks = keep_masks([(4, 4096)], seed=6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p=0.5, shape=None: jnp.asarray(
                       masks[tuple(shape)]))

        def f(params):
            out, _ = jm.apply({"params": params,
                               "batch_stats": v["batch_stats"]}, x, train=True,
                              mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
            return (out * up).sum()

        grads = jax.tree.map(np.asarray, jax.jit(jax.grad(f))(v["params"]))
    pm = vgg.VGGS["vgg11"]()
    pm.load_state_dict(bridge.convert(v, pm))

    class Masks:
        device = torch.device("cpu")

        def keep_mask(self, shape, rate):
            return torch.from_numpy(masks[tuple(shape)])

    (pm.train()(torch.from_numpy(x), rng=Masks())
     * torch.from_numpy(up)).sum().backward()
    want = bridge.convert({"params": grads,
                           "batch_stats": v["batch_stats"]}, pm)
    scale = max(float(p.grad.abs().max()) for p in pm.parameters())
    for name, p in pm.named_parameters():
        assert float((p.grad - want[name]).abs().max()) < 1e-5 * scale, name


def test_vgg_init_follows_flax():
    """The port's own initialisation draws flax's distributions: conv
    weights LeCun normal (truncated at two std), zero conv biases, the
    classifier torch's uniform."""
    from clip_lite_torch.ops.layers import init_weights

    m = init_weights(vgg.VGGS["vgg11_bn"](), torch.Generator().manual_seed(0))
    w = m.conv2.weight  # 3x3 x 128 in
    std = (1 / (9 * 128)) ** 0.5
    assert abs(float(w.std()) / std - 1) < 0.02
    assert float(w.abs().max()) <= 2 * std / vgg._TRUNC_STD + 1e-7
    assert float(m.conv2.bias.abs().max()) == 0.0
    assert float(m.bn2.weight.min()) == 1.0
    bound = 1 / (7 * 7 * 512) ** 0.5
    assert float(m.fc1.weight.abs().max()) <= bound * (1 + 1e-6)


GLOVE_VOCAB, GLOVE_DIM = 96, 24


class _JaxGlove(jtext_encoder.TextEncoder):
    glove_vocab_size: int = GLOVE_VOCAB
    glove_dim: int = GLOVE_DIM


def small_glove(mp) -> None:
    """Both packages' glove table at GLOVE_VOCAB x GLOVE_DIM, for the
    factories (400,002 x 300 by default)."""
    mp.setattr(jtext_encoder, "TextEncoder", _JaxGlove)
    mp.setattr(text_encoder, "TextEncoder", functools.partial(
        text_encoder.TextEncoder, glove_vocab_size=GLOVE_VOCAB,
        glove_dim=GLOVE_DIM))


def glove_batch(rng, b=8, crop=32, length=8):
    lengths = rng.randint(3, length + 1, b)
    tokens = rng.randint(4, GLOVE_VOCAB, (b, length)).astype(np.int32)
    tokens[np.arange(length)[None, :] >= lengths[:, None]] = 0  # <pad>
    return {"image": rng.randn(b, crop, crop, 3).astype(np.float32),
            "caption_tokens": tokens}


def test_vgg_glove_training_step_matches_jax():
    """Two steps of the flagship with ``vgg11`` (1000-d features, dropout
    0.5 with the masks injected) and the glove text mode (a frozen table
    of GLOVE_VOCAB x GLOVE_DIM, mean-pooled), no warmup: each step's loss
    components and grad norm, the first step's gradients (the frozen
    table's zero) and the state after the second at 1e-4, but the VGG's gradients at
    1e-2 of each tensor's largest: the loss's gradient into the 1000
    features is nearly the same for every image and small, and what the
    convs receive of it lies 5e-3 apart in the two packages' fp32 here,
    where the tower's backward alone agrees to 1e-5
    (:func:`test_vgg_backward_matches_jax`).  The table moved, by coupled
    L2 and momentum alone, as JAX's did."""
    overrides = ["AMP", False, "MODEL.VISUAL.NETWORK_NAME", "vgg11",
                 "MODEL.VISUAL.FEATURE_SIZE", 1000,
                 "MODEL.TEXTUAL.NAME", "glove", "DATA.NAME", "glove",
                 "MODEL.TEXTUAL.FEATURE_SIZE", GLOVE_DIM,
                 "DATA.IMAGE_CROP_SIZE", 32, "DATA.MAX_CAPTION_LENGTH", 8,
                 "OPTIM.WARMUP_STEPS", 0, "OPTIM.NUM_ITERATIONS", 20,
                 "OPTIM.CNN_LR", 0.002]
    rng = np.random.RandomState(0)
    batches = [glove_batch(rng) for _ in range(2)]
    noise = {"image": rng.uniform(size=(8, 1000)).astype(np.float32),
             "text": rng.uniform(size=(8, GLOVE_DIM)).astype(np.float32)}
    masks = keep_masks([(8, 4096)], seed=3)
    ref = jax_steps(FLAGSHIP, overrides, batches, noise, patch=small_glove,
                    masks=masks, cache=_CLASSIFIER)
    port = port_steps(FLAGSHIP, overrides, batches, noise, ref["variables"],
                      patch=small_glove, masks=masks)
    assert_steps_match(port, ref, image_grad_rel=1e-2)
    table = "text_encoder.embedding.weight"
    assert float(port["grads"][table].abs().max()) == 0.0
    before = bridge.convert(ref["variables"], port["state"].model)[table]
    moved = port["state"].model.state_dict()[table] - before
    assert float(moved.abs().max()) > 0.0


def test_vgg_checkpoint_round_trip(tmp_path):
    """A ``vgg11_bn`` pretraining model in the JAX checkpoint format, both
    ways, as model-only snapshots (a full training state would write
    three copies of the classifier's 120M weights): the port's snapshot of
    seeded weights loads in the JAX package as those weights, leaf for
    leaf, and the JAX package's snapshot of them loads in the port's
    ``EncoderBundle``."""
    from clip_lite_tpu import engine as jengine
    from clip_lite_tpu.config import Config as JConfig
    from clip_lite_tpu.factories import PretrainingModelFactory as JFactory
    from clip_lite_tpu.utils import checkpointing as jckpt
    from clip_lite_torch.config import Config
    from clip_lite_torch.engine import create_train_state
    from clip_lite_torch.eval_utils import EncoderBundle
    from clip_lite_torch.utils.checkpointing import CheckpointManager
    from test_torch_checkpointing import _assert_trees_identical

    over = ["AMP", False, "MODEL.VISUAL.NETWORK_NAME", "vgg11_bn",
            "MODEL.VISUAL.FEATURE_SIZE", 1000, "DATA.IMAGE_CROP_SIZE", 32,
            "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 1, "MODEL.TEXTUAL.HIDDEN_SIZE",
            64, "MODEL.TEXTUAL.VOCAB_SIZE", 128, "DATA.MAX_CAPTION_LENGTH", 8]
    sample = {"image": np.zeros((1, 32, 32, 3), np.float32),
              "input_ids": np.zeros((1, 8), np.int32),
              "attention_mask": np.ones((1, 8), np.int32)}
    v = seeded_variables(JFactory.from_config(JConfig(FLAGSHIP, over)), sample,
                         train=False, cache=_CLASSIFIER)
    cfg = Config(FLAGSHIP, over)
    state = create_train_state(cfg, device="cpu",
                               state_dict=bridge.from_jax_variables(v, cfg))
    path = CheckpointManager(str(tmp_path / "port"), state=state).climax_step(2)
    _assert_trees_identical(
        jax.tree.map(np.asarray, jckpt.load_model_variables(path)), v)
    del state
    snapshot = jckpt.CheckpointManager(str(tmp_path / "jax"), state=(
        jengine.TrainState(step=np.asarray(3, np.int32), params=v["params"],
                           batch_stats=v["batch_stats"], opt_state=()))
    ).climax_step(3)
    bundle = EncoderBundle(cfg, snapshot, batch_size=2, device="cpu")
    want = bridge.convert(v, bundle.model)
    for name, value in bundle.model.state_dict().items():
        assert torch.equal(value, want[name]), name
