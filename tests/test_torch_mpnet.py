"""The MPNet text tower (clip_lite_torch/models/mpnet.py) and the slice
that runs it, against the JAX package.

- ``relative_position_bucket``: equal, integer for integer.
- ``MPNetModel`` at hidden 128, 2 heads of 64, 2 layers, vocab 1000:
  sequence and pooled outputs at 1e-4 (eval mode), for ids padded with
  MPNet's pad id 1 and with the hashing tokenizer's 0 (which MPNet counts
  as a position, in both packages); gradients at 1e-4, the relative bias
  table's at 1e-3 (the JAX package's own bar between its fused and plain
  paths, tests/test_attention.py::test_mpnet_fused_rel_bias_gradient).
  The port runs both its attention paths: the autograd Function (K1/K2's
  CPU twins, with the full bias) and the plain attention.
- The slice: the flagship config with ``MODEL.TEXTUAL.NETWORK_NAME
  microsoft/mpnet-base`` cut to one MPNet layer (its width is fixed at
  768), a width-8 ResNet-18 and 4 pairs of 32 px, with and without the
  TRANSFORM head.  From the JAX initialisation, bridged: the text
  embeddings and their projection at 1e-4; three training steps (dropout
  off, the same prior noise) at rtol 1e-4 on the loss components and
  grad_norm at every step and on every parameter after the last step,
  the relative bias table and the unused pooler included.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_tpu.models.bert import masked_mean_pooling as jax_mean_pooling
from clip_lite_tpu.models.mpnet import MPNetModel as JMPNetModel
from clip_lite_tpu.models.mpnet import relative_position_bucket as jax_bucket
from clip_lite_tpu.optim import param_paths
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.factories import PretrainingModelFactory
from clip_lite_torch.models.bert import masked_mean_pooling
from clip_lite_torch.models.mpnet import (
    MPNetModel,
    relative_bucket_grid,
    relative_position_bucket,
)
from clip_lite_torch.ops.attention import attention_backward, fused_short_attention
from test_torch_train import COMPONENTS, FLAGSHIP, TOL, TRAIN, jax_run, run_port
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


SMALL = dict(vocab_size=1000, hidden_size=128, num_heads=2,
             num_hidden_layers=2, intermediate_size=512, dropout_rate=0.0)
TABLE = "relative_attention_bias.weight"
# MPNet's norms and biases kept out of weight decay, so that a wrong path
# (bridge.jax_path) would decay other parameters than the JAX package.
NO_DECAY = r".*transformer.*(_ln\..*|\.bias)"
MPNET = TRAIN + ["MODEL.TEXTUAL.NETWORK_NAME", "microsoft/mpnet-base",
                 "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 1, "OPTIM.NO_DECAY", NO_DECAY]
SLICE_B, SLICE_STEPS, TEXT_FEATURES = 4, 3, 96


@pytest.fixture(autouse=True, scope="module")
def _threefry():
    """JAX's default PRNG for this module's JAX initialisations (see
    tests/test_torch_train.py)."""
    with jax.default_prng_impl("threefry2x32"):
        yield


def test_relative_buckets_match_jax():
    rel = np.arange(-512, 513)
    ours = relative_position_bucket(torch.from_numpy(rel)).numpy()
    theirs = np.asarray(jax_bucket(jnp.asarray(rel, jnp.int32)))
    # Every bucket but 16: a key after the query at distance 0 cannot be.
    assert ours.dtype == np.int64 and set(ours) == set(range(32)) - {16}
    np.testing.assert_array_equal(ours, theirs)


def test_masked_mean_pooling_matches_jax():
    rng = np.random.RandomState(0)
    seq = rng.randn(3, 7, 5).astype(np.float32)
    mask = (np.arange(7)[None, :] < np.array([[7], [2], [0]])).astype(np.int32)
    np.testing.assert_allclose(
        masked_mean_pooling(torch.from_numpy(seq), torch.from_numpy(mask)).numpy(),
        np.asarray(jax_mean_pooling(jnp.asarray(seq), jnp.asarray(mask))),
        rtol=1e-6, atol=1e-7)


def _ids(pad: int):
    """(3, 12) ids in [2, 1000) with 12, 7 and 3 real tokens, padded with
    ``pad``."""
    rng = np.random.RandomState(1)
    ids = rng.randint(2, 1000, (3, 12)).astype(np.int32)
    mask = (np.arange(12)[None, :] < np.array([[12], [7], [3]])).astype(np.int32)
    return np.where(mask == 1, ids, pad).astype(np.int32), mask


@pytest.fixture(scope="module")
def small_mpnet():
    model = JMPNetModel(**SMALL, fused_attention="false")
    ids, mask = _ids(1)
    variables = jax.jit(lambda i, m: model.init(jax.random.PRNGKey(0), i, m))(
        ids, mask)
    return model, jax.tree.map(np.asarray, dict(variables))


def _port_small(variables, fused: str) -> MPNetModel:
    model = MPNetModel(**SMALL, fused_attention=fused)
    model.load_state_dict(bridge.convert(variables, model))
    return model


@pytest.mark.parametrize("fused", ["true", "false"], ids=["fused", "plain"])
@pytest.mark.parametrize("pad", [1, 0], ids=["pad1", "pad0"])
def test_mpnet_outputs_match_jax(small_mpnet, pad, fused):
    jmodel, variables = small_mpnet
    ids, mask = _ids(pad)
    seq, pooled = jmodel.apply(variables, ids, mask, deterministic=True)
    port = _port_small(variables, fused).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    for a, b in zip(got, (seq, pooled)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fused", ["true", "false"], ids=["fused", "plain"])
@pytest.mark.parametrize("pad", [1, 0], ids=["pad1", "pad0"])
def test_mpnet_grads_match_jax(small_mpnet, pad, fused):
    """The loss reads the sequence and the pooled output; every parameter's
    gradient, the relative bias table's (the sum of both layers' dbias)
    included."""
    jmodel, variables = small_mpnet
    ids, mask = _ids(pad)
    rng = np.random.RandomState(2)
    w_seq = rng.randn(3, 12, 128).astype(np.float32)
    w_pool = rng.randn(3, 128).astype(np.float32)

    def loss(params):
        seq, pooled = jmodel.apply({"params": params}, ids, mask,
                                   deterministic=True)
        return jnp.sum(seq * w_seq) + jnp.sum(pooled * w_pool)

    want = bridge.convert({"params": jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss))(variables["params"]))},
        _port_small(variables, fused))
    port = _port_small(variables, fused).train()
    k1, k2 = fused_short_attention.launches, attention_backward.launches
    seq, pooled = port(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    ((seq * torch.from_numpy(w_seq)).sum()
     + (pooled * torch.from_numpy(w_pool)).sum()).backward()
    assert (fused_short_attention.launches, attention_backward.launches) == (k1, k2)
    grads = dict(port.named_parameters())
    assert set(grads) == set(want)
    for name, p in grads.items():
        tol = 1e-3 if name == TABLE else 1e-4
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=tol, atol=tol, err_msg=name)
    assert np.abs(grads[TABLE].grad.numpy()).max() > 1e-3


def test_mpnet_position_ids_count_pad_zero():
    """The hashing tokenizer pads with 0, not MPNet's 1: padded slots get
    counted positions in both packages, and the output at real tokens
    still differs from a pad-1 batch nowhere (padding is masked as keys)."""
    model = _port_small_random()
    ids1, mask = _ids(1)
    ids0, _ = _ids(0)
    with torch.no_grad():
        a, _ = model(torch.from_numpy(ids1).long(), torch.from_numpy(mask).long())
        b, _ = model(torch.from_numpy(ids0).long(), torch.from_numpy(mask).long())
    real = torch.from_numpy(mask).bool()
    torch.testing.assert_close(a[real], b[real], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(a[~real], b[~real])


def test_mpnet_trains_after_serving():
    """The bucket grid is cached per (length, device): one first built
    under inference mode (EncoderBundle) still serves a training step."""
    relative_bucket_grid.cache_clear()
    model = _port_small_random()
    ids, mask = (torch.from_numpy(a).long() for a in _ids(1))
    with torch.inference_mode():
        model(ids, mask)
    seq, _ = model.train()(ids, mask)
    seq.sum().backward()
    assert model.relative_attention_bias.weight.grad is not None


def _port_small_random() -> MPNetModel:
    from clip_lite_torch.ops.layers import init_weights

    return init_weights(MPNetModel(**SMALL, fused_attention="true"),
                        torch.Generator().manual_seed(0)).eval()


# ---- the slice -----------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True],
                ids=["mean-pooled", "transform-head"])
def mpnet_reference(request):
    """The JAX run of the tiny MPNet flagship (one compile of its step;
    the first step's gradients are not taken, the final state holds every
    step's), with the TRANSFORM head at FEATURE_SIZE 96 or without it
    (768)."""
    transform = request.param
    train = MPNET + (["MODEL.TEXTUAL.TRANSFORM", True,
                      "MODEL.TEXTUAL.FEATURE_SIZE", TEXT_FEATURES]
                     if transform else [])
    run = jax_run(train, b=SLICE_B, img_dim=64, steps=SLICE_STEPS,
                  txt_dim=TEXT_FEATURES if transform else 768, first_grads=False)
    return dict(run, train=train, transform=transform)


@pytest.fixture(scope="module")
def mpnet_port_run(mpnet_reference):
    return run_port(mpnet_reference, train=mpnet_reference["train"])


def test_slice_text_embeddings_match_jax(mpnet_reference):
    train = mpnet_reference["train"]
    jmodel = JModelFactory.from_config(JConfig(FLAGSHIP, train))
    variables = mpnet_reference["variables"]
    batch = {k: mpnet_reference["val_batch"][k]
             for k in ("input_ids", "attention_mask")}

    @jax.jit
    def jax_text(v, b):
        feats = jmodel.apply(v, b, method=jmodel.encode_text)
        return feats, jmodel.apply(v, feats, method=jmodel.project_text)

    want = jax_text(variables, batch)
    cfg = Config(FLAGSHIP, train)
    model = PretrainingModelFactory.from_config(cfg)
    model.load_state_dict(bridge.from_jax_variables(variables, cfg))
    model.eval()
    with torch.no_grad():
        feats = model.encode_text({k: torch.from_numpy(v).long()
                                   for k, v in batch.items()})
        proj = model.project_text(feats)
    width = TEXT_FEATURES if mpnet_reference["transform"] else 768
    assert feats.shape == (SLICE_B, width) and model.text_encoder.feature_size == width
    for got, ref in zip((feats, proj), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_slice_steps_match_jax(mpnet_reference, mpnet_port_run):
    for i, (got, want) in enumerate(zip(mpnet_port_run["metrics"],
                                        mpnet_reference["metrics"])):
        for name in COMPONENTS + ("grad_norm",):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i + 1} {name}")
    assert mpnet_port_run["state"].step == SLICE_STEPS


def test_slice_unused_pooler_gets_no_grad(mpnet_port_run):
    """The pooler is not on the sentence embedding's path: no gradient
    (JAX's is zero); the relative bias table gets one through dbias."""
    grads = mpnet_port_run["grads"]
    assert float(grads["text_encoder.transformer.pooler.weight"].abs().max()) == 0
    assert float(grads[f"text_encoder.transformer.{TABLE}"].abs().max()) > 0


def test_slice_final_state_matches_jax(mpnet_reference, mpnet_port_run):
    """Every parameter after three steps, the relative bias table and the
    pooler (moved by weight decay, momentum and Lookahead alone)
    included."""
    model = mpnet_port_run["state"].model
    want = bridge.convert(mpnet_reference["final"], model)
    start = bridge.convert(mpnet_reference["variables"], model)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
    for name in (TABLE, "pooler.weight"):
        key = f"text_encoder.transformer.{name}"
        assert not torch.equal(got[key], start[key]), key


def test_slice_jax_paths_and_decay_sets_agree(mpnet_reference, mpnet_port_run):
    """Every port parameter's JAX-style path is a leaf of the JAX tree, one
    to one (MPNet's norms have no wrapper level), so OPTIM.NO_DECAY spares
    the same parameters in both packages."""
    model = mpnet_port_run["state"].model
    names = [n for n, _ in model.named_parameters()]
    paths = {n: bridge.jax_path(model, n) for n in names}
    jax_paths = param_paths(mpnet_reference["variables"]["params"])
    assert set(paths.values()) == set(jax_paths) and len(paths) == len(jax_paths)
    assert paths[f"text_encoder.transformer.layer_0.attn_ln.weight"] == \
        "text_encoder.transformer.layer_0.attn_ln.scale"
    pattern = re.compile(NO_DECAY)
    jax_decayed = {p for p in jax_paths if not pattern.match(p)}
    decayed = {paths[n] for n in mpnet_port_run["state"].optimizer.decayed_names()}
    assert decayed == jax_decayed
    spared = set(jax_paths) - jax_decayed
    assert "text_encoder.transformer.emb_ln.scale" in spared
    assert "text_encoder.transformer.relative_attention_bias.embedding" in decayed


def test_text_modes_without_data_layer_raise():
    """The glove and sbert modes (ported with their data layer) build their
    own towers whatever NETWORK_NAME says, MPNet's here, as the JAX
    package's do; a mode that is none of the four raises."""
    for mode, width in (("glove", 300), ("sbert", 768)):
        with torch.device("meta"):  # GloVe's 400,002 x 300 table
            model = PretrainingModelFactory.from_config(
                Config(FLAGSHIP, MPNET + ["MODEL.TEXTUAL.NAME", mode]))
        assert model.text_encoder.feature_size == width
        assert not hasattr(model.text_encoder, "transformer")
    with pytest.raises(ValueError, match="skipthought"):
        PretrainingModelFactory.from_config(
            Config(FLAGSHIP, MPNET + ["MODEL.TEXTUAL.NAME", "skipthought"]))
