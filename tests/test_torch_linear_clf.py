"""The port's linear probe / fine-tune eval (clip_lite_torch/linear_clf.py)
against the JAX package's (clip_lite_tpu/linear_clf.py), on the CPU.

* Steps: from one initial tree (the JAX ``LinearClassifier``'s, threefry
  init, seeded BatchNorm statistics, bridged into the port), three probe
  steps (``--frozen``) and three fine-tune steps on the same seeded
  batches give the JAX step's parameters, BatchNorm statistics and
  losses at 1e-4 (the bar of tests/test_torch_train.py), under the
  downstream config's SGD with coupled weight decay and Lookahead (a sync
  within the three steps).  Every parameter takes OPTIM.LR in both, and
  the frozen backbone moves in both (weight decay, momentum, Lookahead).
  The JAX step is ``linear_clf.main``'s ``train_step`` on one device.
* The CLI on a synthetic ImageNet tree with ``--device cpu`` from a JAX
  pretraining checkpoint: prints ``{"top1": ...}``, and writes
  checkpoints under ``<dir>/linear_clf`` that the JAX package's
  ``load_model_variables`` reads, in the JAX ``LinearClassifier``'s tree
  (``backbone/backbone/...``, ``fc``, every leaf's shape), the frozen
  backbone's BatchNorm statistics those of the pretraining checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import clip_lite_tpu.linear_clf as jlc
from clip_lite_tpu import engine as jengine
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import VisualBackboneFactory as JBackboneFactory
from clip_lite_tpu.utils import checkpointing as jckpt
from clip_lite_torch import bridge
from clip_lite_torch import linear_clf
from clip_lite_torch.config import Config
from clip_lite_torch.engine import TrainState
from clip_lite_torch.factories import OptimizerFactory, VisualBackboneFactory
from test_torch_downstream_data import CROP, write_imagenet
from test_torch_eval_cli import FLAGSHIP, PRETRAIN, jax_checkpoint

DOWN = ["OPTIM.LR", 0.05, "OPTIM.NUM_ITERATIONS", 10,
        "OPTIM.WARMUP_STEPS", 1, "OPTIM.LOOKAHEAD.STEPS", 2,
        "OPTIM.BATCH_SIZE", 8]
B, K, STEPS = 8, 5, 3
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def keep_prng_impl():
    impl = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", impl)


def _batches():
    rng = np.random.default_rng(0)
    return [{"image": rng.standard_normal((B, CROP, CROP, 3), np.float32),
             "label": rng.integers(0, K, B).astype(np.int32)}
            for _ in range(STEPS)]


def _jax_step(model, tx):
    """``linear_clf.main``'s ``train_step`` on one device (no bound data
    axis: no psum, no pmean), with the fused optimizer."""

    def train_step(state, batch):
        def loss_fn(p):
            logits, mutated = model.apply(
                {"params": p, "batch_stats": state.batch_stats},
                batch["image"], train=True, mutable=["batch_stats"])
            return jlc.cross_entropy(logits, batch["label"]), mutated
        (loss, mutated), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        new_params, opt_state, _ = tx.apply(grads, state.opt_state,
                                            state.params)
        return state.replace(
            step=state.step + 1, params=new_params,
            batch_stats=mutated.get("batch_stats", {}),
            opt_state=opt_state), loss

    return jax.jit(train_step)


def _leaves(tree, path=(), leaf=np.asarray):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,), leaf)
    else:
        yield "/".join(path), leaf(tree)


@pytest.mark.parametrize("frozen", [True, False], ids=["probe", "finetune"])
def test_steps_match_jax(frozen):
    jcfg, jdown = JConfig(FLAGSHIP, [str(v) for v in PRETRAIN]), \
        JConfig(None, [str(v) for v in DOWN])
    jmodel = jlc.LinearClassifier(backbone=JBackboneFactory.from_config(jcfg),
                                  num_classes=K, frozen=frozen)
    batches = _batches()
    with jax.default_prng_impl("threefry2x32"):
        variables = jax.jit(lambda x: jmodel.init(
            jax.random.PRNGKey(0), x, train=False))(batches[0]["image"][:2])
    rng = np.random.RandomState(2)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(
            rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
            else 0.1 * rng.randn(*v.shape), np.float32),
        variables["batch_stats"])
    params = jax.tree.map(np.asarray, variables["params"])
    tx = JOptimizerFactory.from_config(jdown)
    jstate = jengine.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                                batch_stats=stats, opt_state=tx.init(params))

    cfg, down = Config(FLAGSHIP, PRETRAIN), Config(None, DOWN)
    model = linear_clf.LinearClassifier(VisualBackboneFactory.from_config(cfg),
                                        K, frozen=frozen)
    model.load_state_dict(bridge.convert(
        {"params": params, "batch_stats": stats}, model))
    optimizer = OptimizerFactory.from_config(down, model)
    assert {g.lr for g in optimizer.groups} == {0.05}
    state = TrainState(step=0, model=model, optimizer=optimizer)

    jstep, step = _jax_step(jmodel, tx), linear_clf.make_train_step()
    for batch in batches:
        jstate, jloss = jstep(jstate, batch)
        state, loss = step(state, batch)
        np.testing.assert_allclose(float(loss), float(jloss), **TOL)
    assert state.step == int(jstate.step) == STEPS

    mine = bridge.to_jax_variables(state.model.state_dict(), state.model,
                                   lambda t: t.detach().numpy())
    for part, want_tree in (("params", jstate.params),
                            ("batch_stats", jstate.batch_stats)):
        got, want = dict(_leaves(mine[part])), dict(_leaves(want_tree))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)
    # Frozen or not, the backbone's weights moved; its statistics only when
    # fine-tuning.
    kernel = "backbone/backbone/stem/conv/kernel"
    assert not np.array_equal(dict(_leaves(mine["params"]))[kernel],
                              dict(_leaves(params))[kernel])
    moved = not np.array_equal(
        dict(_leaves(mine["batch_stats"]))["backbone/backbone/stem/bn/mean"],
        dict(_leaves(stats))["backbone/backbone/stem/bn/mean"])
    assert moved is not frozen


def test_cli_probe_on_imagenet_tree(tmp_path, capsys):
    with jax.default_prng_impl("threefry2x32"):
        ckpt = jax_checkpoint(tmp_path / "pretrain")
    root = write_imagenet(str(tmp_path), n_train=4, n_val=2)
    args = linear_clf.parser.parse_args([str(a) for a in (
        "--device", "cpu", "--serialization-dir", tmp_path / "out",
        "--cpu-workers", 2, "--pretrain-config", FLAGSHIP,
        "--pretrain-config-override", *PRETRAIN, "--checkpoint-path", ckpt,
        "--frozen", "--log-every", 1, "--checkpoint-every", 2,
        "--config-override", "DATA.ROOT", root, "DATA.IMAGE_CROP_SIZE", CROP,
        "OPTIM.BATCH_SIZE", 4, "OPTIM.NUM_ITERATIONS", 4,
        "OPTIM.WARMUP_STEPS", 1)])
    top1 = linear_clf.main(args)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        {"top1": top1}
    assert 0.0 <= top1 <= 100.0
    directory = tmp_path / "out" / "linear_clf"
    assert {"checkpoint_2.msgpack", "checkpoint_4.msgpack",
            "checkpoint_best.msgpack"} <= set(os.listdir(directory))
    variables = jckpt.load_model_variables(
        str(directory / "checkpoint_4.msgpack"))
    assert jckpt.peek_iteration(str(directory / "checkpoint_4.msgpack")) == 4
    assert set(variables["params"]) == {"backbone", "fc"}
    assert variables["params"]["fc"]["kernel"].shape == (64, 3)
    # The tree of the JAX LinearClassifier, every leaf's shape included.
    jmodel = jlc.LinearClassifier(
        backbone=JBackboneFactory.from_config(
            JConfig(FLAGSHIP, [str(v) for v in PRETRAIN])), num_classes=3)
    shapes = jax.eval_shape(lambda x: jmodel.init(
        jax.random.PRNGKey(0), x, train=False),
        jnp.zeros((1, CROP, CROP, 3)))
    for part in ("params", "batch_stats"):
        got = dict(_leaves(variables[part], leaf=np.shape))
        assert got == dict(_leaves(shapes[part], leaf=lambda v: v.shape))
    # The frozen backbone's statistics are the pretraining checkpoint's.
    pre = jckpt.load_model_variables(ckpt)
    np.testing.assert_array_equal(
        variables["batch_stats"]["backbone"]["backbone"]["stem"]["bn"]["var"],
        pre["batch_stats"]["image_encoder"]["backbone"]["stem"]["bn"]["var"])
