"""The weight bridge (clip_lite_torch/bridge.py): a flax {params,
batch_stats} tree of the tiny flagship config maps onto the port's
state_dict, every leaf used once and every port key filled."""

import copy
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import PretrainingModelFactory as JFactory
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.factories import PretrainingModelFactory

FLAGSHIP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs", "fs_bs1024_ni250k.yaml")
TINY = ["AMP", False, "MODEL.VISUAL.WIDTH", 8, "DATA.IMAGE_CROP_SIZE", 32,
        "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 2, "MODEL.TEXTUAL.HIDDEN_SIZE", 128,
        "DATA.MAX_CAPTION_LENGTH", 8, "MODEL.TEXTUAL.VOCAB_SIZE", 128]


@pytest.fixture(scope="module")
def variables():
    model = JFactory.from_config(JConfig(FLAGSHIP, TINY))
    sample = {"image": jnp.zeros((1, 32, 32, 3)),
              "input_ids": jnp.zeros((1, 8), jnp.int32),
              "attention_mask": jnp.ones((1, 8), jnp.int32)}
    v = model.init({"params": jax.random.PRNGKey(0),
                    "prior": jax.random.PRNGKey(1),
                    "dropout": jax.random.PRNGKey(2)}, sample, train=False)
    return jax.tree.map(np.asarray, {"params": v["params"],
                                     "batch_stats": v["batch_stats"]})


@pytest.fixture(scope="module")
def config():
    return Config(FLAGSHIP, TINY)


def test_every_leaf_used_once_and_every_key_filled(variables, config):
    sd = bridge.from_jax_variables(variables, config)
    model = PretrainingModelFactory.from_config(config)
    assert set(sd) == set(model.state_dict())
    assert len(sd) == len(jax.tree.leaves(variables))
    model.load_state_dict(sd)  # strict: no missing or unexpected keys


def test_layout_conversions(variables, config):
    sd = bridge.from_jax_variables(variables, config)
    p, st = variables["params"], variables["batch_stats"]
    stem = p["image_encoder"]["backbone"]["stem"]["conv"]["kernel"]  # HWIO
    assert stem.shape == (7, 7, 3, 8)
    w = sd["image_encoder.backbone.stem.conv.weight"].numpy()  # OIHW
    np.testing.assert_array_equal(w, stem.transpose(3, 2, 0, 1))
    pw = p["image_encoder"]["backbone"]["layer1_0"]["block1"]["conv"]["kernel"]
    assert pw.shape[:2] == (1, 1)
    np.testing.assert_array_equal(
        sd["image_encoder.backbone.layer1_0.block1.conv.weight"].numpy()[:, :, 0, 0],
        pw[0, 0].T)
    qkv = p["text_encoder"]["transformer"]["layer_0"]["qkv"]["kernel"]
    assert qkv.shape == (128, 384)
    np.testing.assert_array_equal(
        sd["text_encoder.transformer.layer_0.qkv.weight"].numpy(), qkv.T)
    bn = st["loss"]["global_d"]["img_block"]["nonlinear_bn"]["BatchNorm_0"]
    np.testing.assert_array_equal(
        sd["loss.global_d.img_block.nonlinear_bn.running_var"].numpy(),
        bn["var"])
    np.testing.assert_array_equal(
        sd["text_encoder.transformer.embeddings.word.weight"].numpy(),
        p["text_encoder"]["transformer"]["embeddings"]["word"]["embedding"])
    assert sd["loss.global_d.temperature"].shape == ()


def test_unused_leaf_raises(variables, config):
    v = copy.deepcopy(variables)
    v["params"]["loss"]["global_d"]["extra"] = {"kernel": np.zeros((2, 2))}
    with pytest.raises(KeyError, match="does not have"):
        bridge.from_jax_variables(v, config)


def test_unfilled_key_raises(variables, config):
    v = copy.deepcopy(variables)
    del v["batch_stats"]["image_encoder"]["backbone"]["stem"]["bn"]["var"]
    with pytest.raises(KeyError, match="no JAX leaf"):
        bridge.from_jax_variables(v, config)


def test_shape_mismatch_raises(variables, config):
    v = copy.deepcopy(variables)
    v["params"]["loss"]["prior_d"]["l0"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        bridge.from_jax_variables(v, config)


def test_unknown_collection_raises(variables, config):
    v = dict(variables, cache={})
    with pytest.raises(KeyError, match="collections"):
        bridge.from_jax_variables(v, config)

