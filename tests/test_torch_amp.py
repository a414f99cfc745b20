"""The port's AMP training step (bf16 compute, fp32 parameters) against the
JAX package's: how far the first step's gradients in bf16 lie from those
in fp32, in each package, from the same weights (the JAX initialisation,
bridged), batch and prior noise.  The two packages round at other places
(XLA's fusions, PyTorch's kernels), so their bf16 gradients differ from
each other; what must agree is how far bf16 moves each from its fp32
step.

Bar: bf16 against fp32, over four batches, the port's shift of the loss
(root mean square) and of BERT's QKV weight gradients (1 - cosine and
max relative difference of the worst layer, means), each at most twice
JAX's.  It bounds the rounding of the whole AMP path, not each rounding
point: one batch's loss moves by a mean of bf16 noise.

Readings at more sizes (the flagship's ResNet-50 included, whose bf16
rounding at initialisation moves the text tower's gradients far more
than BERT's own does):
``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_amp.py``."""

import os

import numpy as np
import pytest
import torch

import jax

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.engine import create_train_state, make_train_step
from clip_lite_torch.factories import PretrainingModelFactory
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
FACTOR = 2.0
N_BATCHES = 4


@pytest.fixture(autouse=True, scope="module")
def _threefry():
    """JAX's default PRNG for this module's JAX initialisations: another
    test in the same process may have switched it (``RNG_IMPL`` "rbg"),
    which gives other seeded weights."""
    with jax.default_prng_impl("threefry2x32"):
        yield


def _inject_uniform(mp, noise):
    by_shape = {v.shape: v for v in noise.values()}
    real = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) in by_shape:
            return jax.numpy.asarray(by_shape[tuple(shape)])
        return real(key, shape, *args, **kwargs)

    mp.setattr(jax.random, "uniform", uniform)


def first_steps(net="resnet18", width=8, crop=32, layers=2, hidden=128,
                batch=8, length=8, n_batches=N_BATCHES):
    """The loss and BERT's QKV weight gradients (by layer) of a first
    training step on each of ``n_batches`` seeded batches:
    ``{(package, amp): [(loss, [tensor, ...]), ...]}`` for package
    "jax"/"port" and AMP off/on, with the plain attention and dropout
    off."""
    overrides = ["MODEL.VISUAL.NETWORK_NAME", net, "MODEL.VISUAL.WIDTH", width,
                 "DATA.IMAGE_CROP_SIZE", crop,
                 "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", layers,
                 "MODEL.TEXTUAL.HIDDEN_SIZE", hidden,
                 "DATA.MAX_CAPTION_LENGTH", length,
                 "MODEL.TEXTUAL.DROPOUT", 0.0,
                 "MODEL.TEXTUAL.FUSED_ATTENTION", "false"]
    rng = np.random.RandomState(0)
    vocab = Config(FLAGSHIP).MODEL.TEXTUAL.VOCAB_SIZE
    batches = []
    for _ in range(n_batches):
        lengths = rng.randint(2, length + 1, batch)
        batches.append({
            "image": rng.randn(batch, crop, crop, 3).astype(np.float32),
            "input_ids": rng.randint(1, vocab, (batch, length)).astype(np.int32),
            "attention_mask": (np.arange(length)[None, :] < lengths[:, None]
                               ).astype(np.int32)})
    variables, out = None, {}
    for amp in (False, True):
        jcfg, cfg = (JConfig(FLAGSHIP, overrides + ["AMP", amp]),
                     Config(FLAGSHIP, overrides + ["AMP", amp]))
        model = JModelFactory.from_config(jcfg)
        if variables is None:
            keys = {k: jax.random.PRNGKey(i)
                    for i, k in enumerate(("params", "prior", "dropout"))}
            variables = jax.tree.map(np.asarray, dict(jax.jit(
                lambda b: model.init(keys, b, train=False))(
                    jax.tree.map(lambda a: a[:1], batches[0]))))
            with torch.device("meta"):
                shapes = PretrainingModelFactory.from_config(cfg)
            feature = {"image": shapes.image_encoder.feature_size,
                       "text": shapes.text_encoder.feature_size}
            noise = {k: rng.uniform(size=(batch, n)).astype(np.float32)
                     for k, n in feature.items()}
        key = jax.random.PRNGKey(0)

        def loss(params, data):
            out, _ = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                data, train=True, mutable=["batch_stats"],
                rngs={"prior": key, "dropout": key})
            return out["loss"]

        with pytest.MonkeyPatch.context() as mp:
            _inject_uniform(mp, noise)
            grad_fn = jax.jit(jax.value_and_grad(loss))
            jax_steps = [grad_fn(variables["params"], data) for data in batches]
        out["jax", amp], out["port", amp] = [], []
        for data, (jloss, jgrads) in zip(batches, jax_steps):
            state = create_train_state(cfg, device="cpu",
                                       state_dict=bridge.from_jax_variables(
                                           variables, cfg))
            _, metrics = make_train_step(cfg)(state, data, prior_noise={
                k: torch.from_numpy(v) for k, v in noise.items()})
            want = bridge.convert({"params": jax.tree.map(np.asarray, jgrads),
                                   "batch_stats": variables["batch_stats"]},
                                  state.model)
            names = [n for n, _ in state.model.named_parameters()
                     if n.endswith("qkv.weight")]
            params = dict(state.model.named_parameters())
            out["jax", amp].append(
                (float(jloss), [want[n].double() for n in names]))
            out["port", amp].append((metrics["total_loss"].item(),
                                     [params[n].grad.double() for n in names]))
    return out


def distance(a, b):
    """How far the steps ``a`` lie from the steps ``b`` (lists over the
    same batches): the loss's relative difference (root mean square over
    the batches), and over the layers' QKV gradients the largest
    1 - cosine and max|a - b| / max|b| (means over the batches)."""
    loss, cos, rel = [], [], []
    for (loss_a, ga), (loss_b, gb) in zip(a, b):
        loss.append((loss_a - loss_b) / loss_b)
        cos.append(max(1.0 - torch.nn.functional.cosine_similarity(
            x.flatten(), y.flatten(), dim=0).item() for x, y in zip(ga, gb)))
        rel.append(max(((x - y).abs().max() / y.abs().max()).item()
                       for x, y in zip(ga, gb)))
    return dict(loss=float(np.sqrt(np.mean(np.square(loss)))),
                one_minus_cos=float(np.mean(cos)), rel=float(np.mean(rel)))


def test_bf16_moves_port_as_far_as_jax():
    steps = first_steps()
    same = distance(steps["port", False], steps["jax", False])
    assert same["loss"] < 1e-5 and same["one_minus_cos"] < 1e-6 \
        and same["rel"] < 1e-3
    port = distance(steps["port", True], steps["port", False])
    jax_ = distance(steps["jax", True], steps["jax", False])
    assert jax_["one_minus_cos"] > 0  # bf16 rounds
    for k in port:
        assert port[k] <= FACTOR * jax_[k], (k, port, jax_)


if __name__ == "__main__":
    SIZES = [dict(), dict(layers=12, hidden=256, batch=32, length=30),
             dict(layers=4, hidden=768, batch=32, length=30),
             dict(net="resnet50"),
             dict(net="resnet50", width=16, crop=64, layers=4, hidden=256,
                  batch=16, length=30)]
    for size in SIZES:
        g = first_steps(**size)
        print(size or "default (ResNet-18 width 8, 32 px; BERT 2 x 128; 8 x 8)")
        for label, a, b in (("JAX  bf16 vs JAX  fp32", ("jax", True), ("jax", False)),
                            ("port bf16 vs port fp32", ("port", True), ("port", False)),
                            ("port bf16 vs JAX  bf16", ("port", True), ("jax", True)),
                            ("port fp32 vs JAX  fp32", ("port", False), ("jax", False))):
            print(f"  {label}: {distance(g[a], g[b])}")
