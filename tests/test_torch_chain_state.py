"""The optimizer state of ``OPTIM.FUSED: false`` (the optax chain's layout)
in the port, against the JAX package's chain on the CPU.

Under ``FUSED: false`` the JAX package trains with the optax chain of its
``optim/__init__.py`` (clip, decayed weights with their mask, momentum or
Adam, the per-group LR schedule, Lookahead around them); the port keeps
its fused optimizer and reads and writes the chain's layout
(``optim/fused.py``: ``chain_parts``, ``chain_state``, ``fused_fields``).
For SGD and AdamW, each with Lookahead on and off, and SGD with the clip
and the weight decay off (so the chain's indices move):

* a JAX checkpoint whose chain state is seeded (momentum or moments,
  slow weights, counters 7 and 4) loads into the port exactly, and the
  port's own checkpoint of it is identical to it, leaf for leaf;
* one update after the load (seeded gradients, a Lookahead sync step)
  equals the JAX chain's ``tx.update`` at 1e-5, parameters and the new
  chain state both;
* the port's checkpoint after that update loads in the JAX
  ``CheckpointManager`` under the chain's target, every leaf the port's.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from clip_lite_tpu import engine as jengine
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.optim.lookahead import \
    slow_params_from_state as jslow_params_from_state
from clip_lite_tpu.utils import checkpointing as jckpt
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.engine import create_train_state, to_jax_tree
from clip_lite_torch.optim.fused import chain_parts, slow_params_from_state
from clip_lite_torch.utils import msgpack_io
from clip_lite_torch.utils.checkpointing import CheckpointManager
from test_torch_train import FLAGSHIP, TRAIN
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


VARIANTS = {
    "sgd_lookahead": [],
    "sgd": ["OPTIM.LOOKAHEAD.USE", False],
    "adamw_lookahead": ["OPTIM.OPTIMIZER_NAME", "adamw"],
    "adamw": ["OPTIM.OPTIMIZER_NAME", "adamw", "OPTIM.LOOKAHEAD.USE", False],
    "sgd_no_clip_no_decay": ["OPTIM.CLIP_GRAD_NORM", 0.0,
                             "OPTIM.WEIGHT_DECAY", 0.0],
}
PARTS = {"sgd_lookahead": ("clip", "decay", "trace", "schedule"),
         "sgd": ("clip", "decay", "trace", "schedule"),
         "adamw_lookahead": ("clip", "adam", "decay", "schedule"),
         "adamw": ("clip", "adam", "decay", "schedule"),
         "sgd_no_clip_no_decay": ("trace", "schedule")}
COUNT, LA_COUNT, STEP = 7, 4, 9  # the next update is a Lookahead sync (k 5)


def _overrides(variant):
    return TRAIN + ["OPTIM.FUSED", False, *VARIANTS[variant]]


@pytest.fixture(scope="module")
def variables():
    """The tiny flagship's variables (the port's seeded initialisation), as
    the JAX tree of numpy arrays."""
    state = create_train_state(Config(FLAGSHIP, TRAIN), device="cpu")
    return bridge.to_jax_variables(state.model.state_dict(), state.model)


def _seeded_chain(tx, params, rng):
    """``tx.init(params)`` with every float leaf drawn from ``rng`` (the
    second moments positive), the chain's counts COUNT and Lookahead's
    LA_COUNT."""
    template = tx.init(jax.tree.map(jnp.asarray, params))

    def draw(path, leaf):
        leaf = np.asarray(leaf)
        if leaf.dtype == np.int32:
            return np.asarray(LA_COUNT if path[-1].key == "step_count"
                              else COUNT, np.int32)
        x = np.asarray(rng.randn(*leaf.shape), np.float32)
        return np.abs(x) if any(getattr(k, "key", None) == "nu"
                                for k in path) else x

    tree = jax.tree_util.tree_map_with_path(
        draw, serialization.to_state_dict(template))
    return serialization.from_state_dict(template, tree)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def case(request, variables, tmp_path_factory):
    """One variant: the JAX TrainState with a seeded chain state, its
    checkpoint written by the JAX manager, and the JAX chain."""
    variant = request.param
    jcfg = JConfig(FLAGSHIP, _overrides(variant))
    tx = JOptimizerFactory.from_config(jcfg)
    rng = np.random.RandomState(sorted(VARIANTS).index(variant))
    state = jengine.TrainState(
        step=np.asarray(STEP, np.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=_seeded_chain(tx, variables["params"], rng))
    directory = str(tmp_path_factory.mktemp(variant))
    path = jckpt.CheckpointManager(directory, state=state).step(11)
    grads = jax.tree.map(lambda p: np.asarray(0.1 * rng.randn(*p.shape),
                                              np.float32), variables["params"])
    return dict(variant=variant, tx=tx, state=state, path=path, grads=grads,
                cfg=Config(FLAGSHIP, _overrides(variant)))


def _leaves(tree, path=()):
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _assert_identical(got, want, **tol):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):  # an empty state
            assert got[key] == {}, key
            continue
        g = np.asarray(bridge.to_numpy(got[key]) if isinstance(
            got[key], torch.Tensor) else got[key])
        w = np.asarray(want[key])
        assert (g.dtype, g.shape) == (w.dtype, w.shape), key
        if tol:
            np.testing.assert_allclose(g, w, err_msg="/".join(key), **tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg="/".join(key))


def _loaded(case, tmp_path):
    state = create_train_state(case["cfg"], device="cpu")
    manager = CheckpointManager(str(tmp_path), state=state)
    assert manager.load(case["path"]) == 11
    return state, manager


def test_chain_parts_follow_the_config(case):
    assert chain_parts(case["cfg"].OPTIM) == PARTS[case["variant"]]
    stored = msgpack_io.read(case["path"])["state"]["opt_state"]
    chain = stored["inner_state"] if "step_count" in stored else stored
    assert sorted(chain) == [str(i) for i in range(len(PARTS[case["variant"]]))]


def test_jax_chain_checkpoint_loads_and_writes_back_identical(case, tmp_path):
    state, manager = _loaded(case, tmp_path)
    opt = state.optimizer
    assert (state.step, opt.count, opt.la_count) == (
        STEP, COUNT, LA_COUNT if opt.lookahead else COUNT)
    stored = msgpack_io.read(case["path"])["state"]
    slow = slow_params_from_state(stored["opt_state"])
    want_slow = jslow_params_from_state(case["state"].opt_state)
    assert (slow is None) == (want_slow is None) == (not opt.lookahead)
    if opt.lookahead:
        _assert_identical(bridge.to_jax_params(
            slow_params_from_state(opt), state.model), slow)
        _assert_identical(slow, jax.tree.map(np.asarray, want_slow))
    # The port's file of the loaded state is the JAX file, leaf for leaf.
    _assert_identical(msgpack_io.read(manager.step(11))["state"], stored)


def test_one_update_matches_the_jax_chain_and_resumes_in_jax(case, tmp_path):
    state, manager = _loaded(case, tmp_path)
    by_name = bridge.from_jax_params(case["grads"], state.model)
    for name, p in state.model.named_parameters():
        p.grad = by_name[name].clone()
    state.optimizer.step()
    state.step += 1

    jstate = case["state"]
    params = jax.tree.map(jnp.asarray, jstate.params)
    updates, opt_state = jax.jit(case["tx"].update)(
        jax.tree.map(jnp.asarray, case["grads"]), jstate.opt_state, params)
    params = optax.apply_updates(params, updates)
    ours = to_jax_tree(state)
    tol = dict(rtol=1e-5, atol=1e-5)
    _assert_identical(ours["params"], jax.tree.map(np.asarray, params), **tol)
    _assert_identical(ours["opt_state"], jax.tree.map(
        np.asarray, serialization.to_state_dict(opt_state)), **tol)

    # The port's checkpoint resumes in the JAX manager under the chain.
    path = manager.step(12)
    jmanager = jckpt.CheckpointManager(str(tmp_path / "jax"), state=jstate)
    assert jmanager.load(path) == 12
    restored = serialization.to_state_dict(jmanager.restored("state"))
    _assert_identical(jax.tree.map(np.asarray, restored),
                      msgpack_io.read(path)["state"])
    assert int(restored["step"]) == STEP + 1
