"""The critics and the self-supervised terms of the port against the JAX
package, on the CPU.

* ``JSDInfoMaxLoss`` for each critic type (``dot``, ``concat``,
  ``condot``, ``dotcon``) with each combination of the visual and textual
  SSL terms, from the same (bridged) parameters, features, augmented
  features and prior noise: every component at 1e-5, the features'
  gradients at 1e-4 and the heads' BatchNorm statistics after one
  training call at 1e-4 (fp32).
* Two SSL train steps (visual and textual on, ``concat``) on uint8 images
  and uint8 augmented views, JAX's prior noise and the augmentation draws
  of both views injected: metrics at every step and the final state at
  1e-4, the image tower's BatchNorm statistics moved twice a step.
* The datasets' ``aug_*`` views (the Python path) against the JAX
  datasets' under the same seed, through the loaders, bucket trim
  included; the device cache's ``ssl_aug`` crop against its plain twin.
* An SSL model's checkpoint across the packages, byte for byte both ways
  (the dot critics' heads as the flagship's checkpoints carry them).
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu import engine as jengine
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_tpu.ops import loss as jloss
from clip_lite_tpu.utils import checkpointing as jckpt
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_tpu.data.device_cache import DeviceDataCache as JDeviceDataCache
from clip_lite_torch.data.device_cache import DecodedCorpus, DeviceDataCache
from clip_lite_torch.engine import create_train_state, make_train_step, metrics_to_floats
from clip_lite_torch.ops.loss import (
    CRITICS,
    GlobalDiscriminator,
    GlobalDiscriminatorDot,
    JSDInfoMaxLoss,
)
from clip_lite_torch.utils.checkpointing import CheckpointManager
from test_torch_data_pipeline import LEVEL, TINY as DATA_TINY, _loaders, overrides
from test_torch_data_pipeline import corpus  # noqa: F401  (fixture)
from test_torch_device_cache import CACHE, CROP as CACHE_CROP, B as CACHE_B
from test_torch_device_cache import dataset  # noqa: F401  (fixture)
from test_torch_image_ops import jax_aug_draws
from test_torch_loss import inject_uniform
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
B, IMG, TXT = 8, 24, 16
COMPONENTS = ("total_loss", "cross_modal_loss", "visual_loss", "textual_loss")
SSL = {"none": (False, False), "visual": (True, False),
       "textual": (False, True), "both": (True, True)}


@pytest.fixture(autouse=True, scope="module")
def _threefry():
    """JAX's default PRNG for this module's JAX initialisations (another
    test in the same process may have switched it)."""
    with jax.default_prng_impl("threefry2x32"):
        yield


# -- the loss ----------------------------------------------------------------

def _features():
    rng = np.random.RandomState(0)
    feats = {k: rng.randn(B, d).astype(np.float32) for k, d in
             (("image", IMG), ("text", TXT), ("aug_image", IMG),
              ("aug_text", TXT))}
    noise = {"image": rng.uniform(size=(B, IMG)).astype(np.float32),
             "text": rng.uniform(size=(B, TXT)).astype(np.float32)}
    return feats, noise


def _jax_loss(critic, visual, textual):
    return jloss.JSDInfoMaxLoss(
        image_dim=IMG, text_dim=TXT, critic_type=critic, image_prior=True,
        text_prior=True, visual_self_supervised=visual,
        textual_self_supervised=textual, negatives="global", prior_weight=0.1)


@functools.lru_cache(maxsize=None)
def _jax_variables(critic):
    """The JAX loss's initial variables for ``critic`` with both SSL terms,
    made once for the critic's four cases (a case without a term drops
    its critic's subtree; flax draws each module's parameters from its
    own path, so the rest are what that case's init would give)."""
    feats, _ = _features()
    f = {k: jnp.asarray(v) for k, v in feats.items()}
    return jax.tree.map(np.asarray, _jax_loss(critic, True, True).init(
        {"params": jax.random.PRNGKey(0), "prior": jax.random.PRNGKey(1)},
        image_features=f["image"], text_features=f["text"],
        aug_image_features=f["aug_image"], aug_text_features=f["aug_text"],
        train=False))


@pytest.mark.parametrize("ssl", sorted(SSL))
@pytest.mark.parametrize("critic", sorted(CRITICS))
def test_loss_matches_jax(monkeypatch, critic, ssl):
    visual, textual = SSL[ssl]
    feats, noise = _features()
    names = ["image", "text"] + ["aug_image"] * visual + ["aug_text"] * textual
    jmod = _jax_loss(critic, visual, textual)

    def kwargs(values):
        d = dict(zip(names, values))
        return dict(image_features=d["image"], text_features=d["text"],
                    aug_image_features=d.get("aug_image"),
                    aug_text_features=d.get("aug_text"))

    inputs = [jnp.asarray(feats[n]) for n in names]
    dropped = {k for k, on in (("visual_d", visual), ("textual_d", textual))
               if not on}
    variables = {col: {k: v for k, v in tree.items() if k not in dropped}
                 for col, tree in _jax_variables(critic).items()}
    # The injected noise has no parameter's shape, so the initialisers draw
    # as they would.
    inject_uniform(monkeypatch, noise)

    def run(*values):
        """One training call's components, BatchNorm statistics and
        features' gradients.  Run eagerly: the cases share their ops,
        whose compiles JAX keeps, where a jit of each case compiles anew
        (the file ran 1.6x as long)."""
        def total(*x):
            out, mutated = jmod.apply(
                variables, **kwargs(x), train=True, mutable=["batch_stats"],
                rngs={"prior": jax.random.PRNGKey(2)})
            return out["total_loss"], (out, mutated.get("batch_stats", {}))

        (_, (out, stats)), grads = jax.value_and_grad(
            total, argnums=tuple(range(len(values))), has_aux=True)(*values)
        return out, stats, grads

    out, stats, grads = jax.tree.map(np.asarray, run(*inputs))

    port = JSDInfoMaxLoss(IMG, TXT, critic_type=critic, image_prior=True,
                          text_prior=True, visual_self_supervised=visual,
                          textual_self_supervised=textual, negatives="global",
                          prior_weight=0.1)
    kinds = {"global_d": CRITICS[critic][0]}
    if visual:
        kinds["visual_d"] = CRITICS[critic][1]
    if textual:
        kinds["textual_d"] = CRITICS[critic][1]
    for attr, kind in kinds.items():
        want = GlobalDiscriminatorDot if kind == "dot" else GlobalDiscriminator
        assert isinstance(getattr(port, attr), want), attr
    assert (port.visual_d is None) != visual
    assert (port.textual_d is None) != textual
    port.load_state_dict(bridge.convert(variables, port))
    port.train()
    tensors = [torch.from_numpy(feats[n]).requires_grad_() for n in names]
    got = port(**kwargs(tensors), prior_noise={
        k: torch.from_numpy(v) for k, v in noise.items()})
    got["total_loss"].backward()
    for name in COMPONENTS:
        np.testing.assert_allclose(got[name].item(), float(out[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert (got["visual_loss"].item() != 0.0) == visual
    assert (got["textual_loss"].item() != 0.0) == textual
    for n, t, g in zip(names, tensors, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-6, err_msg=n)
    want = bridge.convert({"params": variables["params"],
                           "batch_stats": jax.tree.map(np.asarray, stats)}, port)
    for key, buf in port.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[key].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def test_projection_needs_a_dot_critic():
    port = JSDInfoMaxLoss(IMG, TXT, critic_type="condot")
    with pytest.raises(TypeError, match="concat critic"):
        port.project_image(torch.zeros(2, IMG))
    with pytest.raises(ValueError, match="critic type"):
        JSDInfoMaxLoss(IMG, TXT, critic_type="bilinear")
    dotcon = JSDInfoMaxLoss(IMG, TXT, critic_type="dotcon")
    assert dotcon.project_text(torch.zeros(2, TXT)).shape == (2, 2048)


# -- the train step ------------------------------------------------------------

# tests/test_torch_train.py's TRAIN, shallower: ResNet-18 at width 8, one
# BERT layer of 128, both SSL terms with the concat critics.
STEP = ["AMP", False, "MODEL.VISUAL.NETWORK_NAME", "resnet18",
        "MODEL.VISUAL.FEATURE_SIZE", 512, "MODEL.VISUAL.WIDTH", 8,
        "DATA.IMAGE_CROP_SIZE", 32, "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 1,
        "MODEL.TEXTUAL.HIDDEN_SIZE", 128, "DATA.MAX_CAPTION_LENGTH", 8,
        "MODEL.TEXTUAL.VOCAB_SIZE", 128, "MODEL.TEXTUAL.DROPOUT", 0.0,
        "OPTIM.WARMUP_STEPS", 1, "OPTIM.NUM_ITERATIONS", 20,
        "OPTIM.CNN_LR", 0.002, "MODEL.LOSS.TYPE", "concat",
        "MODEL.VISUAL.SELF_SUPERVISED", True,
        "MODEL.TEXTUAL.SELF_SUPERVISED", True]
# 16 pairs: at 8 the tiny ResNet's gradients are ill-conditioned (fp32
# rounding moved the grad norm of step 2 by 2.2e-4 between the packages,
# from the same parameters, with every loss component within 1e-7); at 16
# the three steps' grad norms agree within 1.1e-6.
STEPS, L, STEP_B = 2, 8, 16
IMG_DIM, TXT_DIM = 64, 128  # prior noise, told apart by its shape


def _u8_batch(rng, b=STEP_B):
    def caption():
        lengths = rng.randint(2, L + 1, b)
        return (rng.randint(1, 128, (b, L)).astype(np.int32),
                (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32))

    ids, mask = caption()
    aug_ids, aug_mask = caption()
    return {"image": rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8),
            "aug_image": rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8),
            "input_ids": ids, "attention_mask": mask,
            "aug_input_ids": aug_ids, "aug_attention_mask": aug_mask}


def jax_ssl_draws(key, step: int, b: int) -> dict:
    """The draws of JAX's step ``step`` for ``image`` and ``aug_image``:
    ``_maybe_device_preprocess`` splits its key once for each, in that
    order."""
    _, _, rng = jax.random.split(jax.random.fold_in(key, step), 3)
    out = {}
    for name in ("image", "aug_image"):
        rng, sub = jax.random.split(rng)
        out[name] = jax_aug_draws(sub, b)
    return out


@pytest.fixture(scope="module")
def jax_ssl():
    """The JAX package's SSL model (``STEP``), optimizer and initial
    state."""
    jcfg = JConfig(FLAGSHIP, STEP)
    model = JModelFactory.from_config(jcfg)
    tx = JOptimizerFactory.from_config(jcfg)
    sample = jax.tree.map(lambda a: a[:1], _u8_batch(np.random.RandomState(1)))
    for k in ("image", "aug_image"):
        sample[k] = sample[k].astype(np.float32)
    state = jax.jit(lambda b: jengine.create_train_state(model, tx, b, seed=0))(
        sample)
    return model, tx, state


def test_ssl_steps_match_jax(monkeypatch, jax_ssl):
    model, tx, state = jax_ssl
    rng = np.random.RandomState(0)
    batches = [_u8_batch(rng) for _ in range(STEPS)]
    noise = {"image": rng.uniform(size=(STEP_B, IMG_DIM)).astype(np.float32),
             "text": rng.uniform(size=(STEP_B, TXT_DIM)).astype(np.float32)}
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    assert {"visual_d", "textual_d"} <= set(variables["params"]["loss"])
    key = jax.random.PRNGKey(0)
    inject_uniform(monkeypatch, noise)
    step = jax.jit(jengine.make_train_step(model, tx))
    want = []
    for batch in batches:
        state, m = step(state, batch, key)
        want.append(jax.tree.map(float, jax.device_get(m)))
    monkeypatch.undo()
    final = jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats})

    cfg = Config(FLAGSHIP, STEP + ["MODEL.TEXTUAL.FUSED_ATTENTION", "true"])
    pstate = create_train_state(cfg, device="cpu",
                                state_dict=bridge.from_jax_variables(variables,
                                                                     cfg))
    train_step = make_train_step(cfg)
    stats0 = {k: v.clone() for k, v in pstate.model.named_buffers()}
    for i, batch in enumerate(batches):
        pstate, m = train_step(pstate, batch, prior_noise={
            k: torch.from_numpy(v) for k, v in noise.items()},
            aug_draws=jax_ssl_draws(key, i, STEP_B))
        got = metrics_to_floats(m)
        for name in COMPONENTS + ("grad_norm",):
            np.testing.assert_allclose(got[name], want[i][name], rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i + 1} {name}")
        assert got["visual_loss"] != 0.0 and got["textual_loss"] != 0.0
    model_sd = pstate.model.state_dict()
    expected = bridge.convert(final, pstate.model)
    for name, value in model_sd.items():
        np.testing.assert_allclose(value.numpy(), expected[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    moved = [k for k in stats0 if k.startswith("image_encoder")
             and not torch.equal(stats0[k], model_sd[k])]
    assert moved


# -- the data ------------------------------------------------------------------

def _same_ssl_batch(ours, theirs, keys):
    assert set(ours) == set(theirs) == keys
    for k in keys - {"image", "aug_image"}:
        np.testing.assert_array_equal(ours[k].numpy(), theirs[k], err_msg=k)
    for k in keys & {"image", "aug_image"}:
        diff = np.abs(ours[k].numpy().astype(np.float64) - theirs[k])
        assert diff.max() <= LEVEL, k
    if "aug_image" in keys:
        assert not np.array_equal(ours["image"].numpy(),
                                  ours["aug_image"].numpy())


@pytest.mark.parametrize("ssl", ["visual", "textual", "both"])
def test_dataset_views_match_jax(corpus, ssl):  # noqa: F811
    visual, textual = SSL[ssl]
    over = overrides(corpus, "MODEL.VISUAL.SELF_SUPERVISED", visual,
                     "MODEL.TEXTUAL.SELF_SUPERVISED", textual,
                     "DATA.SEQ_BUCKETS", [8, 12])
    keys = {"image_id", "image", "input_ids", "attention_mask"}
    keys |= {"aug_image"} if visual else set()
    keys |= {"aug_input_ids", "aug_attention_mask"} if textual else set()
    ours, theirs = _loaders(over)
    for a, b, _ in zip(ours, theirs, range(3)):
        _same_ssl_batch(a, b, keys)
        if textual:  # another caption of the same image
            assert not np.array_equal(a["input_ids"].numpy(),
                                      a["aug_input_ids"].numpy())


def test_random_dataset_views_match_jax():
    over = ["MODEL.NAME", "random", "MODEL.VISUAL.SELF_SUPERVISED", True,
            "MODEL.TEXTUAL.SELF_SUPERVISED", True] + DATA_TINY
    ours, theirs = _loaders(over)
    keys = {"image_id", "image", "input_ids", "attention_mask", "aug_image",
            "aug_input_ids", "aug_attention_mask"}
    for a, b, _ in zip(ours, theirs, range(2)):
        _same_ssl_batch(a, b, keys)


@pytest.fixture(scope="module")
def cache_corpus(dataset):  # noqa: F811
    return DecodedCorpus(*JDeviceDataCache._load_host(
        dataset, CACHE, np.arange(len(dataset))))


def test_cache_ssl_aug_is_its_twin(cache_corpus):
    """The second view: the same items' tiles, cropped at offsets drawn
    after the first view's from the same (seed, step) generator."""
    cache = DeviceDataCache(cache_corpus, batch_size=CACHE_B, cache_size=CACHE,
                            crop_size=CACHE_CROP, seed=3, ssl_aug=True,
                            device="cpu")
    plain = DeviceDataCache(cache_corpus, batch_size=CACHE_B, cache_size=CACHE,
                            crop_size=CACHE_CROP, seed=3, device="cpu")
    tiles = torch.as_tensor(cache_corpus.images)
    ids = torch.as_tensor(np.asarray(cache_corpus.image_ids))
    for step in (0, 5):
        batch, first = cache.batch_at(step), plain.batch_at(step)
        assert set(batch) == set(first) | {"aug_image"}
        for k in first:  # the first view is the plain cache's batch
            assert torch.equal(batch[k], first[k]), k
        # The twin: the cache's draws replayed, then plain slicing.
        g = cache._generator(step)
        span = CACHE - CACHE_CROP + 1
        idx = torch.randint(0, len(ids), (CACHE_B,), generator=g)
        torch.rand((CACHE_B,), generator=g)
        torch.randint(0, span, (CACHE_B, 2), generator=g)
        off = torch.randint(0, span, (CACHE_B, 2), generator=g)
        twin = torch.stack([tiles[i, r:r + CACHE_CROP, c:c + CACHE_CROP]
                            for i, (r, c) in zip(idx.tolist(), off.tolist())])
        assert torch.equal(batch["aug_image"], twin)
        assert torch.equal(batch["image_id"], ids[idx])
        assert not torch.equal(batch["aug_image"], batch["image"])


# -- checkpoints ---------------------------------------------------------------

def test_ssl_checkpoint_round_trips_byte_for_byte(tmp_path, jax_ssl):
    """A JAX SSL state (the concat critics ``global_d``, ``visual_d`` and
    ``textual_d``) saved by the JAX manager loads into the port, whose
    save at the same iteration is the same file; JAX loads the port's file
    and saves it again, byte for byte."""
    _, _, state = jax_ssl
    loss_params = state.params["loss"]
    for critic in ("global_d", "visual_d", "textual_d"):
        assert set(loss_params[critic]) == {"l0", "l1", "l2"}, critic
    jax_file = jckpt.CheckpointManager(str(tmp_path / "jax"),
                                       state=state).step(3)

    cfg = Config(FLAGSHIP, STEP)
    pstate = create_train_state(cfg, device="cpu")
    manager = CheckpointManager(str(tmp_path / "port"), state=pstate)
    assert manager.load(jax_file) == 3
    port_file = manager.step(3)
    with open(jax_file, "rb") as a, open(port_file, "rb") as b:
        assert a.read() == b.read()

    jmanager = jckpt.CheckpointManager(str(tmp_path / "again"), state=state)
    assert jmanager.load(port_file) == 3
    again = jckpt.CheckpointManager(
        str(tmp_path / "again"), state=jmanager.restored("state")).step(3)
    with open(port_file, "rb") as a, open(again, "rb") as b:
        assert a.read() == b.read()
