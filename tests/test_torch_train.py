"""The training slice as a whole: six steps of the flagship config cut to a
tiny size, through the JAX package's engine and the port's, from the same
weights (the JAX initialisation, bridged) on the same batches and the same
prior noise.  Also the eval step, the first step's gradients, the train
loop's cadence, ``Timer`` and ``MetricsWriter``.

The prior noise is injected into JAX by replacing ``jax.random.uniform``
with a lookup of the test's arrays by shape while the steps are traced
(so every step sees the same noise); the port takes the same arrays as
``prior_noise``.  Dropout is off (``MODEL.TEXTUAL.DROPOUT 0``): JAX keys
and torch generators never draw alike.  The port runs its attention both
through the autograd Function (K1/K2's CPU twins) and the plain version.

Bar: loss components and ``grad_norm`` rtol 1e-4 at every step; every
parameter, BatchNorm statistic and Lookahead slow weight after the last
step 1e-4 (fp32, AMP off).

The uint8 case: three steps and the eval step on uint8 batches, which
both engines augment and normalize on the device
(``_maybe_device_preprocess``).  JAX's augmentation draws are reproduced
from ``fold_in(key, step)`` -> ``split(..., 3)`` -> the split of
``engine.py:77`` and passed to the port as ``aug_draws``; metrics at
rtol 1e-4 at every step.

Resume across the packages: the JAX run saves a checkpoint after step 3
through the JAX ``CheckpointManager``; the port resumes from it through
``train_loop(resume_from=...)`` and runs steps 4-6, across the Lookahead
sync after step 5, to JAX's final state at the same bar."""

import json
import logging
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu import engine as jengine
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_tpu.optim import param_paths
from clip_lite_tpu.train import crossed_interval as jcrossed_interval
from clip_lite_tpu.utils.checkpointing import CheckpointManager as JCheckpointManager
from clip_lite_tpu.utils.loggers import MetricsWriter as JMetricsWriter
from clip_lite_tpu.utils.timers import Timer as JTimer
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.engine import (
    create_train_state,
    make_eval_step,
    make_scanned_train_step,
    make_train_step,
    metrics_to_floats,
)
from clip_lite_torch.train import crossed_interval, train_loop
from clip_lite_torch.utils.checkpointing import CheckpointManager
from clip_lite_torch.utils.loggers import MetricsWriter
from clip_lite_torch.utils.timers import Timer, device_mem_usage_mb
from test_torch_image_ops import jax_aug_draws
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
# tests/test_torch_slice.py's TINY, with dropout off and a warmup of two
# steps, so that steps 2-6 move the parameters (step 1 runs at LR 0), and
# ResNet-18 for ResNet-50.  ResNet-50 at width 8 has ill-conditioned
# gradients at these seeded weights: fp32 rounding alone moves them, in
# either package, by 1e-4 to 6e-4 of the largest one at 8 images of 32 px
# and by 2e-2 to 4e-2 at 16 of 64 px (``python tests/test_torch_models.py``
# prints the readings).  Over these six steps with ResNet-50 the port
# drifts as far from itself, with every pixel moved by one ulp, as from
# JAX: losses and grad_norm by up to 3e-1 in a step, parameters by more
# than their own size; with ResNet-18 by 2e-6 and 3e-5
# (``python tests/test_torch_train.py`` prints the readings).  No 1e-4 bar
# survives that; in float64 the two ResNet-50s agree to 1e-6
# (tests/test_torch_models.py::test_resnet50_train_grads_match_jax_float64).
TRAIN = ["AMP", False, "MODEL.VISUAL.NETWORK_NAME", "resnet18",
         "MODEL.VISUAL.FEATURE_SIZE", 512,
         "MODEL.VISUAL.WIDTH", 8, "DATA.IMAGE_CROP_SIZE", 32,
         "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 2, "MODEL.TEXTUAL.HIDDEN_SIZE", 128,
         "DATA.MAX_CAPTION_LENGTH", 8, "MODEL.TEXTUAL.VOCAB_SIZE", 128,
         "MODEL.TEXTUAL.DROPOUT", 0.0, "OPTIM.WARMUP_STEPS", 2,
         "OPTIM.NUM_ITERATIONS", 20, "OPTIM.LOOKAHEAD.STEPS", 5,
         # Flagship CNN_LR 0.2 is chaotic on 8 random pairs: from step 3 the
         # two packages' fp32 rounding grows into percents of the stem's
         # weights, and at 0.02 (tests/test_engine.py's stable value for its
         # descent check) into 3e-3 by step 6.  At 0.002 the image tower
         # stays inside the 1e-4 bar.
         "OPTIM.CNN_LR", 0.002]
B, L, CROP, STEPS = 8, 8, 32, 6
RESUME_AT = 3  # the JAX run's checkpoint, the port's resume point
U8_STEPS = 3
IMG_DIM = 8 * 8  # ResNet-18's 8 x width channels at width 8
COMPONENTS = ("total_loss", "cross_modal_loss", "visual_loss", "textual_loss")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _threefry():
    """JAX's default PRNG for this module's JAX initialisations: another
    test in the same process may have switched it (``RNG_IMPL`` "rbg"),
    which gives other seeded weights."""
    with jax.default_prng_impl("threefry2x32"):
        yield


def _batch(rng, b=B, crop=CROP):
    lengths = rng.randint(2, L + 1, b)
    return {"image": rng.randn(b, crop, crop, 3).astype(np.float32),
            "input_ids": rng.randint(1, 128, (b, L)).astype(np.int32),
            "attention_mask": (np.arange(L)[None, :] < lengths[:, None]
                               ).astype(np.int32)}


def _batch_u8(rng, b=B, crop=CROP):
    batch = _batch(rng, b, crop)
    batch["image"] = rng.randint(0, 256, (b, crop, crop, 3)).astype(np.uint8)
    return batch


def jax_step_aug_draws(key, step: int, b: int):
    """The augmentation draws of JAX's train step ``step`` (0-based) for
    the ``image`` of a uint8 batch of ``b``."""
    _, _, aug_rng = jax.random.split(jax.random.fold_in(key, step), 3)
    _, sub = jax.random.split(aug_rng)
    return jax_aug_draws(sub, b)


def _inject_uniform(mp, noise):
    by_shape = {v.shape: v for v in noise.values()}
    real = jax.random.uniform

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) in by_shape:
            return jnp.asarray(by_shape[tuple(shape)])
        return real(key, shape, *args, **kwargs)

    mp.setattr(jax.random, "uniform", uniform)


def jax_run(train=TRAIN, b=B, crop=CROP, img_dim=IMG_DIM, uint8=False,
            steps=None, txt_dim=128, first_grads=True, checkpoint_dir=None):
    """The JAX run of ``steps`` steps (default ``STEPS``, ``U8_STEPS`` on
    uint8 pixels when ``uint8``) on ``b`` seeded pairs of ``crop`` px, with
    ``img_dim``/``txt_dim`` wide prior noise for the towers' features:
    initial variables, per-step metrics, first-step grads (float batches
    only, unless ``first_grads`` is false), final state, the eval step's
    components, the augmentation draws (uint8 only) and, given a
    ``checkpoint_dir``, the path of the checkpoint the JAX
    ``CheckpointManager`` wrote there after step ``RESUME_AT``."""
    rng = np.random.RandomState(0)
    make = _batch_u8 if uint8 else _batch
    steps = steps or (U8_STEPS if uint8 else STEPS)
    batches = [make(rng, b, crop) for _ in range(steps)]
    val_batch = make(rng, b, crop)
    jcfg = JConfig(FLAGSHIP, train)
    model = JModelFactory.from_config(jcfg)
    tx = JOptimizerFactory.from_config(jcfg)
    sample = jax.tree.map(lambda a: a[:1], batches[0])
    sample["image"] = sample["image"].astype(np.float32)
    # Jitted: flax's eager init compiles op by op, three times as slow.
    state = jax.jit(lambda b: jengine.create_train_state(model, tx, b, seed=0))(
        sample)
    noise = {"image": rng.uniform(size=(b, img_dim)).astype(np.float32),
             "text": rng.uniform(size=(b, txt_dim)).astype(np.float32)}
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        _inject_uniform(mp, noise)

        def loss_fn(params):
            out, _ = model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                batches[0], train=True, mutable=["batch_stats"],
                rngs={"prior": key, "dropout": key})
            return out["loss"]

        grads = None if uint8 or not first_grads else jax.tree.map(
            np.asarray, jax.jit(jax.grad(loss_fn))(state.params))
        step = jax.jit(jengine.make_train_step(model, tx))
        metrics, checkpoint = [], None
        for i, batch in enumerate(batches):
            state, m = step(state, batch, key)
            metrics.append(jax.tree.map(float, jax.device_get(m)))
            if checkpoint_dir and i + 1 == RESUME_AT:
                checkpoint = JCheckpointManager(checkpoint_dir,
                                                state=state).step(i + 1)
        evals = jax.tree.map(float, jax.device_get(jax.jit(
            jengine.make_eval_step(model))(state, val_batch, key)))
    final = jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats})
    slow = jax.tree.map(np.asarray, state.opt_state.slow_params)
    draws = [jax_step_aug_draws(key, i, b) for i in range(steps)] \
        if uint8 else None
    return dict(batches=batches, val_batch=val_batch, noise=noise,
                variables=variables, grads=grads, metrics=metrics,
                evals=evals, final=final, slow=slow, draws=draws,
                checkpoint=checkpoint)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return jax_run(checkpoint_dir=str(tmp_path_factory.mktemp("jax_ckpt")))


def run_port(reference, train=TRAIN, fused="true"):
    """The port's run from the JAX run's initial variables, batches, noise
    and augmentation draws (if any), with FUSED_ATTENTION ``fused``."""
    cfg = Config(FLAGSHIP, train + ["MODEL.TEXTUAL.FUSED_ATTENTION", fused])
    state = create_train_state(cfg, device="cpu", state_dict=bridge.from_jax_variables(
        reference["variables"], cfg))
    noise = {k: torch.from_numpy(v) for k, v in reference["noise"].items()}
    step = make_train_step(cfg)
    draws = reference.get("draws") or [None] * len(reference["batches"])
    metrics, first_grads = [], None
    for batch, aug in zip(reference["batches"], draws):
        state, m = step(state, batch, prior_noise=noise,
                        aug_draws=None if aug is None else {"image": aug})
        metrics.append(metrics_to_floats(m))
        if first_grads is None:  # an unused parameter (MPNet's pooler) has none
            first_grads = {n: torch.zeros_like(p) if p.grad is None
                           else p.grad.clone()
                           for n, p in state.model.named_parameters()}
    evals = metrics_to_floats(make_eval_step(cfg)(
        state, reference["val_batch"], prior_noise=noise))
    return dict(cfg=cfg, state=state, metrics=metrics, grads=first_grads,
                evals=evals)


@pytest.fixture(scope="module", params=["true", "false"],
                ids=["fused-attention", "plain-attention"])
def port_run(request, reference):
    return run_port(reference, fused=request.param)


def test_step_metrics_match_jax(reference, port_run):
    for i, (got, want) in enumerate(zip(port_run["metrics"],
                                        reference["metrics"])):
        for name in COMPONENTS + ("grad_norm",):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i + 1} {name}")
    assert port_run["state"].step == STEPS


def test_first_step_grads_match_jax(reference, port_run):
    want = bridge.convert({"params": reference["grads"],
                           "batch_stats": reference["variables"]["batch_stats"]},
                          port_run["state"].model)
    grads = port_run["grads"]
    assert len(grads) > 100
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_final_state_matches_jax(reference, port_run):
    model = port_run["state"].model
    want = bridge.convert(reference["final"], model)
    got = model.state_dict()
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
    slow = bridge.convert({"params": reference["slow"],
                           "batch_stats": reference["final"]["batch_stats"]},
                          model)
    for name, value in port_run["state"].optimizer.slow_state().items():
        np.testing.assert_allclose(value.numpy(), slow[name].numpy(),
                                   err_msg=name, **TOL)


def test_resume_from_jax_checkpoint_matches_jax(reference, tmp_path):
    """The port, from random weights, resumes from the JAX run's checkpoint
    after step 3 and runs steps 4-6 (the Lookahead sync after step 5) on
    the same batches and prior noise: every step's metrics and the final
    state, slow weights included, match JAX's continuation."""
    cfg = Config(FLAGSHIP, TRAIN + ["MODEL.TEXTUAL.FUSED_ATTENTION", "true"])
    state = create_train_state(cfg, device="cpu")
    noise = {k: torch.from_numpy(v) for k, v in reference["noise"].items()}
    train_step, metrics = make_train_step(cfg), []

    def step(st, batch):
        st, m = train_step(st, batch, prior_noise=noise)
        metrics.append(metrics_to_floats(m))
        return st, m

    state = train_loop(state, step, iter(reference["batches"][RESUME_AT:]),
                       STEPS, manager=CheckpointManager(str(tmp_path),
                                                        state=state),
                       resume_from=reference["checkpoint"])
    assert state.step == state.optimizer.count == state.optimizer.la_count \
        == STEPS
    for i, (got, want) in enumerate(zip(metrics,
                                        reference["metrics"][RESUME_AT:])):
        for name in COMPONENTS + ("grad_norm",):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       atol=1e-6,
                                       err_msg=f"step {RESUME_AT + i + 1} {name}")
    assert len(metrics) == STEPS - RESUME_AT
    model = state.model
    want = bridge.convert(reference["final"], model)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)
    slow = bridge.convert({"params": reference["slow"],
                           "batch_stats": reference["final"]["batch_stats"]},
                          model)
    for name, value in state.optimizer.slow_state().items():
        np.testing.assert_allclose(value.numpy(), slow[name].numpy(),
                                   err_msg=name, **TOL)


def test_eval_step_matches_jax(reference, port_run):
    for name in COMPONENTS:
        np.testing.assert_allclose(port_run["evals"][name],
                                   reference["evals"][name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def reference_u8():
    return jax_run(uint8=True)


def test_uint8_steps_match_jax(reference_u8):
    """Flip, colour jitter and normalize on the device, given JAX's draws:
    every step's metrics, and the eval step (normalize only), match."""
    port = run_port(reference_u8)
    assert port["state"].step == U8_STEPS
    flips = [int(d.flip.sum()) for d in reference_u8["draws"]]
    applies = [int(d.apply.sum()) for d in reference_u8["draws"]]
    assert 0 < sum(flips) < U8_STEPS * B and 0 < sum(applies) < U8_STEPS * B
    for i, (got, want) in enumerate(zip(port["metrics"],
                                        reference_u8["metrics"])):
        for name in COMPONENTS + ("grad_norm",):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i + 1} {name}")
    for name in COMPONENTS:
        np.testing.assert_allclose(port["evals"][name],
                                   reference_u8["evals"][name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_uint8_steps_use_their_draws(reference_u8):
    """Without JAX's draws the port draws its own from the StepRNG, and the
    first step's loss moves away from JAX's."""
    cfg = Config(FLAGSHIP, TRAIN + ["MODEL.TEXTUAL.FUSED_ATTENTION", "true"])
    state = create_train_state(cfg, device="cpu", state_dict=bridge.from_jax_variables(
        reference_u8["variables"], cfg))
    noise = {k: torch.from_numpy(v) for k, v in reference_u8["noise"].items()}
    _, m = make_train_step(cfg)(state, reference_u8["batches"][0],
                                prior_noise=noise)
    assert metrics_to_floats(m)["total_loss"] != pytest.approx(
        reference_u8["metrics"][0]["total_loss"], rel=1e-4)


def test_jax_paths_and_decay_sets_agree(reference, port_run):
    """Every port parameter's JAX-style path is a leaf of the JAX tree,
    one to one, so a NO_DECAY pattern selects the same parameters."""
    model = port_run["state"].model
    paths = {bridge.jax_path(model, n) for n, _ in model.named_parameters()}
    assert paths == set(param_paths(reference["variables"]["params"]))


def test_step_draws_are_a_function_of_seed_and_step(reference):
    """With dropout on and no injected noise, two runs from the same state
    give the same metrics; another RANDOM_SEED gives others."""
    def run(seed):
        cfg = Config(FLAGSHIP, TRAIN + ["MODEL.TEXTUAL.DROPOUT", 0.1,
                                        "MODEL.TEXTUAL.FUSED_ATTENTION", "true",
                                        "RANDOM_SEED", seed])
        state = create_train_state(cfg, device="cpu", state_dict=bridge.from_jax_variables(
            reference["variables"], cfg))
        step = make_train_step(cfg)
        return [metrics_to_floats(step(state, b)[1])["total_loss"]
                for b in reference["batches"][:2]]

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c


def test_train_loop_cadence(reference, tmp_path, caplog):
    cfg = Config(FLAGSHIP, TRAIN)
    state = create_train_state(cfg, device="cpu", state_dict=bridge.from_jax_variables(
        reference["variables"], cfg))
    writer = MetricsWriter(str(tmp_path))
    with caplog.at_level(logging.INFO, logger="clip_lite_torch"):
        state = train_loop(state, make_train_step(cfg),
                           iter(reference["batches"]), 5, log_every=2,
                           eval_step=make_eval_step(cfg),
                           val_batches=[reference["val_batch"]] * 2,
                           checkpoint_every=4, writer=writer)
    writer.close()
    assert state.step == 5
    with open(tmp_path / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [(r["iteration"], r["split"]) for r in records] == [
        (2, "train"), (4, "train"), (4, "val")]
    assert set(records[0]) == {"iteration", "split", "grad_norm", *COMPONENTS}
    assert all(np.isfinite(r["total_loss"]) for r in records)
    assert sum("VAL @ 4" in r.message for r in caplog.records) == 1


@pytest.mark.parametrize("interval", [1, 3, 10, 500])
@pytest.mark.parametrize("steps_per_call", [1, 2, 4])
def test_crossed_interval_matches_jax(interval, steps_per_call):
    for iteration in range(0, 1200, steps_per_call):
        assert crossed_interval(iteration, interval, steps_per_call) == \
            jcrossed_interval(iteration, interval, steps_per_call)


def test_timer_matches_jax(monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    ours, theirs = Timer(start_from=3, total_iterations=40, window_size=4), \
        JTimer(start_from=3, total_iterations=40, window_size=4)
    assert ours.eta_hhmm == theirs.eta_hhmm == "N/A"
    for _ in range(7):
        for t in (ours, theirs):
            t.tic()
            t.toc()
        assert ours.stats == theirs.stats
        assert ours.avg_iter_time == theirs.avg_iter_time


def test_metrics_writer_matches_jax(tmp_path):
    records = [(5, {"total_loss": np.float32(0.5), "grad_norm": 2.0}, "train"),
               (10, {"total_loss": 0.25}, "val")]
    ours = MetricsWriter(str(tmp_path / "ours"))
    theirs = JMetricsWriter(str(tmp_path / "theirs"), use_tensorboard=False,
                            use_wandb=False)
    for step, metrics, split in records:
        ours.write(step, metrics, split=split)
        theirs.write(step, metrics, split=split)
    ours.close()
    theirs.close()
    assert (tmp_path / "ours" / "metrics.jsonl").read_text() == \
        (tmp_path / "theirs" / "metrics.jsonl").read_text()


def test_unported_options_raise(reference, caplog):
    # PARALLEL.STEPS_PER_CALL 2: two steps a call over a list of two batches
    # (tests/test_torch_steps_per_call.py holds them against JAX's scan).
    k2 = Config(FLAGSHIP, TRAIN + ["PARALLEL.STEPS_PER_CALL", 2])
    k2_state, k2_metrics = make_scanned_train_step(k2)(
        create_train_state(k2, device="cpu"), reference["batches"][:2])
    assert k2_state.step == 2 and np.isfinite(
        float(k2_metrics["total_loss"]))
    # PARALLEL.ZERO1 on one rank: the replicated update and a warning, as
    # the JAX package does on a one-device mesh.
    tuned = Config(os.path.join(ROOT, "configs", "fs_tpu_tuned.yaml"), TRAIN)
    assert tuned.PARALLEL.ZERO1
    with caplog.at_level(logging.WARNING, logger="clip_lite_torch"):
        tuned_state = create_train_state(tuned, device="cpu")
        make_train_step(tuned)
    assert tuned_state.step == 0
    assert any("ZERO1" in r.message for r in caplog.records)
    cfg = Config(FLAGSHIP, TRAIN)
    state = create_train_state(cfg, device="cpu", state_dict=bridge.from_jax_variables(
        reference["variables"], cfg))
    # Hard negatives need their images and masks too.
    batch = dict(reference["batches"][0], neg_input_ids=np.zeros((B, L), np.int32))
    with pytest.raises(KeyError, match="neg_image"):
        make_train_step(cfg)(state, batch)
    assert device_mem_usage_mb("cpu") == 0


if __name__ == "__main__":
    # Readings behind the choice of ResNet-18 above: the same six steps with
    # the test's ResNet-18 and with the flagship's ResNet-50, at the test's
    # 8 pairs of 32 px (width 8) and at 16 pairs of 64 px (width 16); the
    # port against JAX, and against itself on the same batches with every
    # pixel moved by at most one fp32 ulp (times 1 + 2^-23), a change the
    # size of one rounding.
    # Per step, the largest |a - b| / |b| over the loss components and
    # grad_norm; after the last step, the largest max|a - b| / max|b| of
    # one parameter or statistic, and how many tensors miss the test's 1e-4
    # bar.  Run from the root of the repo:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_train.py
    def gap(a, b_metrics, b_state):
        steps = [max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-6)
                     for k in COMPONENTS + ("grad_norm",))
                 for x, y in zip(a["metrics"], b_metrics)]
        final, missed = 0.0, 0
        for name, value in a["state"].model.state_dict().items():
            x, y = value.double().numpy(), b_state[name].double().numpy()
            final = max(final, np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
            missed += not np.allclose(x, y, **TOL)
        return (f"per step {[f'{x:.2e}' for x in steps]}; final state "
                f"{final:.2e}, {missed} of {len(b_state)} tensors outside "
                "rtol/atol 1e-4")

    SIZES = [("resnet18", 8, B, CROP), ("resnet50", 8, B, CROP),
             ("resnet50", 16, 16, 64)]
    with jax.default_prng_impl("threefry2x32"):
        for net, width, b, crop in SIZES:
            train = TRAIN + ["MODEL.VISUAL.NETWORK_NAME", net,
                             "MODEL.VISUAL.WIDTH", width,
                             "DATA.IMAGE_CROP_SIZE", crop]
            ref = jax_run(train, b, crop, (8 if net == "resnet18" else 32) * width)
            port = run_port(ref, train)
            ulp = run_port(dict(ref, batches=[
                dict(x, image=x["image"] * np.float32(1 + 2 ** -23))
                for x in ref["batches"]]), train)
            print(f"{net} width {width}, {b} pairs of {crop} px")
            print("  port vs JAX:          ", gap(port, ref["metrics"], bridge.convert(
                ref["final"], port["state"].model)))
            print("  port, pixels +1 ulp:  ", gap(ulp, port["metrics"],
                                                   port["state"].model.state_dict()))
