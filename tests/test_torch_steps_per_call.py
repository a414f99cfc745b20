"""Several train steps a call (``PARALLEL.STEPS_PER_CALL`` K > 1) in the port,
against the port at K = 1 and against the JAX package, on the CPU at the
tiny flagship of ``tests/test_torch_train.py``.

* The port at K = 2 equals the port at K = 1 bit for bit after six steps,
  with dropout on: every draw is keyed by the step count, as JAX folds
  its key by ``state.step`` inside the scan.  A call's metrics are the
  K-step means of the components and the last step's ``grad_norm``.
* Against JAX's ``make_scanned_train_step`` (two calls of two steps,
  dropout off, the same prior noise): parameters and ``grad_norm`` at the
  bars the JAX package's own ``tests/test_scanned_step.py`` holds the
  scan against sequential steps to (rtol 1e-2 and atol 2e-3; rtol 5e-3),
  the loss components at 1e-4.
* The CLIs at K = 2 with ``NUM_ITERATIONS`` 5: the port's writes the
  ``metrics.jsonl`` iterations and the checkpoint names the JAX CLI
  writes, the overshoot included (the last call runs steps 5 and 6, and
  the final checkpoint, named 5, holds step 6); resumed at K = 2 from its
  checkpoint_4, it ends in the uninterrupted run's state bit for bit.
* Two gloo ranks at K = 2 (each its shard of two global batches a call)
  against JAX's two-device mesh: metrics and final weights at 1e-4.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

import torch_dist_workers as workers
from clip_lite_tpu import engine as jengine
from clip_lite_tpu import train as jtrain
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_tpu.parallel.mesh import create_mesh, shard_stacked_batch
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.engine import (
    create_train_state,
    make_scanned_train_step,
    make_train_step,
    metrics_to_floats,
)
from test_torch_cli import _args, _ckpt_dir, _state, corpus  # noqa: F401
from test_torch_train import B, FLAGSHIP, TRAIN, _batch, _inject_uniform
from clip_lite_torch.train import main
from clip_lite_torch.utils import msgpack_io
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


K, CALLS = 2, 2
# zoo::resnet8 (64-d features) and one text layer, where the JAX package's
# own scan test takes it: XLA compiles each JAX program here in seconds.
SMALL = ["MODEL.VISUAL.NETWORK_NAME", "zoo::resnet8",
         "MODEL.VISUAL.FEATURE_SIZE", 64, "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 1]
COMPONENTS = ("total_loss", "cross_modal_loss", "visual_loss", "textual_loss")


@pytest.fixture(autouse=True, scope="module")
def _threefry():
    with jax.default_prng_impl("threefry2x32"):
        yield


def _tensors(state):
    out = {f"model.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for attr in ("trace", "slow"):
        out.update({f"{attr}.{k}": v.clone()
                    for k, v in state.optimizer._by_name(attr).items()})
    return out


def test_two_steps_a_call_equal_one_bit_for_bit():
    cfg1 = Config(FLAGSHIP, TRAIN + ["MODEL.TEXTUAL.DROPOUT", 0.1])
    cfg2 = Config(FLAGSHIP, TRAIN + ["MODEL.TEXTUAL.DROPOUT", 0.1,
                                     "PARALLEL.STEPS_PER_CALL", K])
    rng = np.random.RandomState(0)
    batches = [_batch(rng) for _ in range(6)]
    one, two = (create_train_state(c, device="cpu") for c in (cfg1, cfg2))
    step1, seen = make_train_step(cfg1), []

    def observed(state, batch):  # a caller's wrapper, as the CLI's
        seen.append(state.step + 1)
        return make_train_step(cfg2)(state, batch)

    step2 = make_scanned_train_step(cfg2, observed)
    singles, calls = [], []
    for batch in batches:
        one, m = step1(one, batch)
        singles.append(m)
    for i in range(0, 6, K):
        two, m = step2(two, batches[i:i + K])
        calls.append(metrics_to_floats(m))
    assert one.step == two.step == 6 and seen == [1, 2, 3, 4, 5, 6]
    a, b = _tensors(one), _tensors(two)
    assert a.keys() == b.keys()
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    for c, got in enumerate(calls):
        pair = singles[K * c:K * (c + 1)]
        for name in COMPONENTS:
            assert got[name] == float(torch.stack(
                [m[name] for m in pair]).mean()), name
        assert got["grad_norm"] == float(pair[-1]["grad_norm"])
    with pytest.raises(ValueError, match="takes 2 batches"):
        step2(two, batches[:1])


def _jax_model(train):
    jcfg = JConfig(FLAGSHIP, train)
    return jcfg, JModelFactory.from_config(jcfg), JOptimizerFactory.from_config(
        jcfg)


def _jax_init(model, tx, batch):
    sample = jax.tree.map(lambda a: a[:1], batch)
    return jax.jit(lambda b: jengine.create_train_state(model, tx, b, seed=0))(
        sample)


def _close_state(got: dict, want: dict, **tol):
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(want[name]),
                                   err_msg=name, **tol)


def test_scanned_call_matches_jax_make_scanned_train_step():
    rng = np.random.RandomState(1)
    batches = [_batch(rng) for _ in range(K * CALLS)]
    noise = {"image": rng.uniform(size=(B, 64)).astype(np.float32),
             "text": rng.uniform(size=(B, 128)).astype(np.float32)}
    train = TRAIN + SMALL + ["PARALLEL.STEPS_PER_CALL", K]
    _, model, tx = _jax_model(train)
    state = _jax_init(model, tx, batches[0])
    cfg = Config(FLAGSHIP, train)
    port = create_train_state(cfg, device="cpu", state_dict=bridge.from_jax_variables(
        jax.tree.map(np.asarray, {"params": state.params,
                                  "batch_stats": state.batch_stats}), cfg))
    step = make_scanned_train_step(cfg)
    scanned = jax.jit(jengine.make_scanned_train_step(model, tx,
                                                      steps_per_call=K))
    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        _inject_uniform(mp, noise)
        for c in range(CALLS):
            calls = batches[K * c:K * (c + 1)]
            state, want = scanned(state, jengine.stack_batches(calls), key)
            port, got = step(port, calls, prior_noise=[
                {k: torch.from_numpy(v) for k, v in noise.items()}] * K)
            got, want = metrics_to_floats(got), jax.tree.map(float, want)
            for name in COMPONENTS:
                np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                           atol=1e-6, err_msg=f"{c} {name}")
            # JAX's own bar for the scan's last grad_norm against its
            # sequential steps (XLA schedules the scanned body otherwise):
            # 0.44% in the second call here, where the port's sequential
            # steps hold JAX's at 1e-4 (tests/test_torch_train.py).
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=5e-3, err_msg=f"{c} grad_norm")
    assert port.step == int(state.step) == K * CALLS
    want = bridge.convert(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}), port.model)
    _close_state({k: v.numpy() for k, v in port.model.state_dict().items()},
                 {k: v.numpy() for k, v in want.items()}, rtol=1e-2, atol=2e-3)


# The CLIs at K 2 over 5 iterations: calls end at 2, 4 and 6.  Logs at 4
# and 6 (every 3), a val sweep and checkpoint at 4 (every 4), a climax
# snapshot at 6 (past 80%, every 3), the final checkpoint named 5.
CLI = SMALL + ["OPTIM.NUM_ITERATIONS", 5, "PARALLEL.STEPS_PER_CALL", K,
               "PARALLEL.NUM_DEVICES", 1]
CLI_FLAGS = ("--log-every", 3, "--climax-freq", 3)


def _cli_args(corpus, out, flags=()):  # noqa: F811
    args = _args(corpus, out, extra=CLI, flags=CLI_FLAGS + tuple(flags))
    args.checkpoint_every = 4
    return args


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [(r["split"], r["iteration"]) for r in map(json.loads, f)]


def _files(directory):
    return sorted(f for f in os.listdir(directory) if f.endswith(".msgpack"))


def test_cli_cadence_and_overshoot_match_the_jax_cli_and_resume(
        corpus, tmp_path):  # noqa: F811
    args = _cli_args(corpus, tmp_path / "port")
    state = main(args)
    assert state.step == 6  # the last call ran past NUM_ITERATIONS
    jargs = jtrain.parser.parse_args([str(a) for a in (
        "--config", FLAGSHIP, "--serialization-dir", tmp_path / "jax",
        "--checkpoint-every", 4, "--cpu-workers", 0, *CLI_FLAGS,
        "--config-override", "DATA.ROOT", corpus, *args.config_override[2:])])
    with pytest.MonkeyPatch.context() as mp:
        # The JAX writer's TensorBoard sink (tensorflow's import and its
        # summaries take half a minute here) is not what is compared.
        mp.setitem(sys.modules, "tensorflow", None)
        jtrain.main(jargs)
    jdir = str(jargs.serialization_dir) + JConfig(
        jargs.config, list(jargs.config_override)).RUN_ID
    want = [("train", 4), ("val", 4), ("train", 6)]
    assert _records(tmp_path / "port") == _records(tmp_path / "jax") == want
    assert _files(_ckpt_dir(args)) == _files(jdir) == [
        "checkpoint_4.msgpack", "checkpoint_5.msgpack",
        "checkpoint_best.msgpack", "climax_model_6.msgpack"]
    for d in (_ckpt_dir(args), jdir):
        stored = msgpack_io.read(os.path.join(d, "checkpoint_5.msgpack"))
        assert (int(stored["iteration"]), int(stored["state"]["step"])) == (5, 6)

    # A resume at K 2 from checkpoint_4: one call (steps 5 and 6), the
    # uninterrupted run's state bit for bit.
    final = _state(state)
    del state
    resumed = main(_cli_args(corpus, tmp_path / "resumed", [
        "--resume-from", os.path.join(_ckpt_dir(args),
                                      "checkpoint_4.msgpack")]))
    assert resumed.step == 6
    got = _state(resumed)
    assert [k for k in final if not torch.equal(final[k], got[k])] == []


def test_two_ranks_at_two_steps_a_call_match_jax_mesh(tmp_path):
    rng = np.random.RandomState(0)
    batches = [_batch(rng, 16, 32) for _ in range(K * CALLS)]
    noise = {"image": rng.uniform(size=(8, 64)).astype(np.float32),
             "text": rng.uniform(size=(8, 128)).astype(np.float32)}
    train = workers.TRAIN + SMALL + ["PARALLEL.STEPS_PER_CALL", K]
    _, model, tx = _jax_model(train)
    state = _jax_init(model, tx, batches[0])
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    cfg = Config(FLAGSHIP, train)
    torch.save(dict(state_dict=bridge.from_jax_variables(variables, cfg),
                    overrides=train[len(workers.TRAIN):],
                    batches=batches,
                    noise={k: torch.from_numpy(v) for k, v in noise.items()}),
               os.path.join(tmp_path, "inputs.pt"))
    workers.spawn(workers.steps_per_call_ranks, 2, str(tmp_path))

    mesh = create_mesh(2)
    step = jengine.compile_train_step(model, tx, mesh, donate=False,
                                      steps_per_call=K)
    key, metrics = jax.random.PRNGKey(0), []
    with pytest.MonkeyPatch.context() as mp:
        _inject_uniform(mp, noise)
        for c in range(CALLS):
            stacked = shard_stacked_batch(
                jengine.stack_batches(batches[K * c:K * (c + 1)]), mesh)
            state, m = step(state, stacked, key)
            metrics.append(jax.tree.map(float, jax.device_get(m)))
    want = bridge.convert(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}),
        create_train_state(cfg, device="cpu").model)
    for rank in workers.load(str(tmp_path), "steps_per_call", 2):
        assert rank["step"] == K * CALLS
        for c, (got, exp) in enumerate(zip(rank["metrics"], metrics)):
            for name in COMPONENTS + ("grad_norm",):
                np.testing.assert_allclose(got[name], exp[name], rtol=1e-4,
                                           atol=1e-6, err_msg=f"{c} {name}")
        _close_state({k: v.numpy() for k, v in rank["state_dict"].items()},
                     {k: v.numpy() for k, v in want.items()},
                     rtol=1e-4, atol=1e-4)
