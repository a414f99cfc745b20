"""Multi-GPU training's modules, held against the JAX package on the CPU:
ranks are spawned gloo processes (``tests/torch_dist_workers.py``, torch
on one thread each); JAX runs in this process on the conftest's virtual
CPU devices, on a mesh of as many devices as there are ranks.

* Four ranks: the global roll's values and gradients equal JAX's
  ``roll_shifted_left`` under ``shard_map`` exactly; the JSD loss with
  global negatives, averaged over the ranks, equals the one-process loss
  on the global batch at 1e-6 (after JAX ``tests/test_collectives.py:28,
  75``).
* Two ranks, three steps of the tiny flagship (fp32, dropout off, the
  prior noise injected into both packages), from the JAX initialisation
  through ``bridge.py``, on the same global batches: against JAX's
  ``compile_train_step`` (local BatchNorm) and ``compile_zero1_train_step``
  (sync BatchNorm) on a two-device mesh, every step's metrics and the
  final parameters and BatchNorm statistics at 1e-4; in the port, ZeRO-1
  against the replicated update at 1e-6, for both BatchNorm modes.
* Sync BatchNorm alone: the ranks' halves against flax's
  ``BatchNorm(axis_name=...)`` under ``shard_map``, output and gradients
  at 1e-5.
* Input: the host loader's shards make up the global batch (after JAX
  ``tests/test_distributed.py:111-136``); the device cache's two
  placements give the same batches.
* Checkpoints: the two-rank ZeRO-1 run's checkpoint is written by rank 0
  alone; it loads in one port process (the two-rank state, the
  optimizer's slices gathered) and in the JAX package's manager, and a
  world of one resumed from it takes the next step exactly as a process
  handed that state in memory does (after JAX
  ``tests/test_multihost_e2e.py:140``).
* Rank 0 alone writes metrics and the config dump; each rank logs to a
  file of its own.
* The quality protocol's corpus is the JAX campaign's.
"""

import os
import re
import shlex

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from jax.sharding import PartitionSpec as P

import torch_dist_workers as workers
from clip_lite_tpu import engine as jengine
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_tpu.parallel.collectives import roll_shifted_left as jroll
from clip_lite_tpu.parallel.mesh import create_mesh, shard_batch as jshard
from clip_lite_tpu.parallel.zero1 import (
    compile_zero1_train_step,
    create_zero1_opt_state,
)
from clip_lite_tpu.utils.checkpointing import CheckpointManager as JCheckpointManager
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.engine import create_train_state, make_train_step, \
    metrics_to_floats
from clip_lite_torch.ops.layers import BatchNorm, init_weights
from clip_lite_torch.ops.loss import JSDInfoMaxLoss
from clip_lite_torch.scripts import quality_protocol
from clip_lite_torch.utils.checkpointing import CheckpointManager
from test_torch_train import _batch, _inject_uniform

ROOT = workers.ROOT
B, STEPS, IMG_DIM, TXT_DIM = 16, 3, 64, 128
COMPONENTS = ("total_loss", "cross_modal_loss", "visual_loss", "textual_loss")


@pytest.fixture(autouse=True, scope="module")
def _threefry():
    with jax.default_prng_impl("threefry2x32"):
        yield


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


# -- four ranks ---------------------------------------------------------
@pytest.fixture(scope="module")
def four(tmp_path_factory):
    rng = np.random.RandomState(0)
    workdir = str(tmp_path_factory.mktemp("four"))
    loss = init_weights(JSDInfoMaxLoss(image_dim=64, text_dim=48,
                                       image_prior=False, text_prior=False,
                                       negatives="global"),
                        torch.Generator().manual_seed(0))
    for p in loss.parameters():
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.asarray(rng.randn(*p.shape), np.float32))
                    * 0.1)
    inputs = dict(x=torch.from_numpy(rng.randn(16, 3).astype(np.float32)),
                  w=torch.from_numpy(rng.randn(16, 3).astype(np.float32)),
                  img=torch.from_numpy(rng.randn(32, 64).astype(np.float32)),
                  txt=torch.from_numpy(rng.randn(32, 48).astype(np.float32)),
                  loss_state=loss.state_dict())
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    workers.spawn(workers.roll_and_loss, 4, workdir)
    return dict(inputs=inputs, loss=loss,
                ranks=workers.load(workdir, "roll", 4))


def test_global_roll_and_its_gradient_match_jax(four):
    x, w = four["inputs"]["x"].numpy(), four["inputs"]["w"].numpy()
    mesh = create_mesh(4)

    def f(xs):
        return jroll(xs, "data", "global")

    out = _shard_map(f, mesh, P("data"), P("data"))(jnp.asarray(x))
    grad = jax.grad(lambda xs: jnp.sum(
        _shard_map(f, mesh, P("data"), P("data"))(xs) * w))(jnp.asarray(x))
    ranks = four["ranks"]
    got = torch.cat([r["out"] for r in ranks]).numpy()
    np.testing.assert_array_equal(got, np.asarray(out))
    np.testing.assert_array_equal(got, np.roll(x, -1, axis=0))
    np.testing.assert_array_equal(
        torch.cat([r["grad"] for r in ranks]).numpy(), np.asarray(grad))
    # Local negatives stay in the rank's rows.
    for r, rank in enumerate(ranks):
        np.testing.assert_array_equal(rank["local"].numpy(),
                                      np.roll(x[r * 4:(r + 1) * 4], -1, 0))
    # One exchange forward, one backward, on every rank.
    assert all(rank["counts"]["send_recv"] == 2 for rank in ranks)


def test_global_negatives_loss_over_ranks_equals_one_process(four):
    loss = four["loss"].eval()
    with torch.no_grad():
        single = loss(four["inputs"]["img"], four["inputs"]["txt"])
    for rank in four["ranks"]:
        np.testing.assert_allclose(float(rank["loss_mean"]),
                                   float(single["total_loss"]), rtol=1e-6)
    # Each rank's own loss pairs its last row with the next rank's first.
    assert len({float(r["loss"]) for r in four["ranks"]}) == 4


# -- two ranks ----------------------------------------------------------
def _jax_setup():
    rng = np.random.RandomState(0)
    batches = [_batch(rng, B, 32) for _ in range(STEPS)]
    noise = {"image": rng.uniform(size=(B // 2, IMG_DIM)).astype(np.float32),
             "text": rng.uniform(size=(B // 2, TXT_DIM)).astype(np.float32)}
    jcfg = JConfig(workers.FLAGSHIP, workers.TRAIN)
    model = JModelFactory.from_config(jcfg)
    tx = JOptimizerFactory.from_config(jcfg)
    sample = jax.tree.map(lambda a: a[:1], batches[0])
    state = jax.jit(lambda b: jengine.create_train_state(model, tx, b, seed=0))(
        sample)
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    return batches, noise, variables


def jax_run(bn, zero1, batches, noise, variables):
    """JAX's steps on a two-device mesh: per-step metrics and the final
    variables."""
    jcfg = JConfig(workers.FLAGSHIP, workers.TRAIN + [
        "MODEL.VISUAL.BN_MODE", bn, "PARALLEL.ZERO1", zero1])
    model = JModelFactory.from_config(jcfg)
    tx = JOptimizerFactory.from_config(jcfg)
    mesh = create_mesh(2)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jengine.TrainState(
        step=jnp.zeros([], jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params))
    if zero1:
        state = state.replace(opt_state=create_zero1_opt_state(params, mesh))
        step = compile_zero1_train_step(model, jcfg, mesh, params)
    else:
        step = jengine.compile_train_step(model, tx, mesh, donate=False)
    key, metrics = jax.random.PRNGKey(0), []
    with pytest.MonkeyPatch.context() as mp:
        _inject_uniform(mp, noise)
        for batch in batches:
            state, m = step(state, jshard(batch, mesh), key)
            metrics.append(jax.tree.map(float, jax.device_get(m)))
    return metrics, jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    batches, noise, variables = _jax_setup()
    workdir = str(tmp_path_factory.mktemp("two"))
    cfg = Config(workers.FLAGSHIP, workers.TRAIN)
    rng = np.random.RandomState(1)
    bn_x = rng.randn(8, 6, 3, 3).astype(np.float32) * 2 + 1
    inputs = dict(
        state_dict=bridge.from_jax_variables(variables, cfg),
        batches=batches,
        noise={k: torch.from_numpy(v) for k, v in noise.items()},
        bn_x=torch.from_numpy(bn_x),
        bn_w=torch.from_numpy(rng.randn(*bn_x.shape).astype(np.float32)),
        bn_scale=torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)),
        bn_bias=torch.from_numpy(rng.randn(6).astype(np.float32)),
        corpus=workers.synthetic_corpus())
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    workers.spawn(workers.two_ranks, 2, workdir)
    return dict(workdir=workdir, inputs=inputs, noise=noise,
                batches=batches, variables=variables, cfg=cfg)


def _ranks(two, name):
    return workers.load(two["workdir"], name, 2)


def _assert_state(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(want[name]),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("bn,zero1", [("local", False), ("sync", True)],
                         ids=["local-replicated", "sync-zero1"])
def test_two_rank_steps_match_jax_mesh(two, bn, zero1):
    metrics, final = jax_run(bn, zero1, two["batches"], two["noise"],
                             two["variables"])
    name = f"{bn}_{'zero1' if zero1 else 'replicated'}"
    ranks = _ranks(two, name)
    assert [r["optimizer"] for r in ranks] == \
        ["Zero1Optimizer" if zero1 else "FusedOptimizer"] * 2
    for rank in ranks:
        for i, (got, want) in enumerate(zip(rank["metrics"], metrics)):
            for key in COMPONENTS + ("grad_norm",):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                           atol=1e-6,
                                           err_msg=f"step {i + 1} {key}")
    model = create_train_state(two["cfg"], device="cpu").model
    want = bridge.convert(final, model)
    for rank in ranks:
        _assert_state(rank["state_dict"], {k: v.numpy()
                                           for k, v in want.items()},
                      rtol=1e-4, atol=1e-4)
    # The ranks hold one state.
    _assert_state(ranks[1]["state_dict"], ranks[0]["state_dict"], rtol=0,
                  atol=0)


@pytest.mark.parametrize("bn", ["local", "sync"])
def test_zero1_equals_replicated_update(two, bn):
    n_bn = sum(isinstance(m, BatchNorm) for m in create_train_state(
        two["cfg"], device="cpu").model.image_encoder.modules())
    zero1, replicated = _ranks(two, f"{bn}_zero1"), _ranks(two,
                                                           f"{bn}_replicated")
    for z, r in zip(zero1, replicated):
        for i, (got, want) in enumerate(zip(z["metrics"], r["metrics"])):
            for key in COMPONENTS:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                           err_msg=f"step {i + 1} {key}")
            # The norm is summed in another order: ZeRO-1 sums the slices'
            # squares, the replicated update takes torch._foreach_norm,
            # whose CPU kernel sums a 4M-element gradient in float32 with a
            # relative error of about 1e-5.  Each against the float64 norm
            # of the mean gradient: ZeRO-1 at 1e-6, the replicated at 1e-4.
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm64"],
                                       rtol=1e-6, err_msg=f"step {i + 1}")
            np.testing.assert_allclose(want["grad_norm"], want["grad_norm64"],
                                       rtol=1e-4, err_msg=f"step {i + 1}")
        _assert_state(z["state_dict"], r["state_dict"], rtol=1e-6, atol=1e-6)
        _assert_state(z["slow"], r["slow"], rtol=1e-6, atol=1e-6)
        # A step: the global roll's exchange forward and backward, one
        # all-reduce of statistics and metrics (with the gradients in the
        # replicated step), ZeRO-1's reduce-scatter, norm and all-gather,
        # and sync BatchNorm's statistics forward and backward.
        sync = 2 * n_bn if bn == "sync" else 0
        assert z["collectives"] == [{"send_recv": 2, "all_reduce": 2 + sync,
                                     "reduce_scatter": 1,
                                     "all_gather": 1}] * STEPS
        assert r["collectives"] == [{"send_recv": 2,
                                     "all_reduce": 1 + sync}] * STEPS


def test_sync_batchnorm_matches_flax_axis_name(two):
    inputs = two["inputs"]
    x = inputs["bn_x"].numpy().transpose(0, 2, 3, 1)  # flax is NHWC
    w = inputs["bn_w"].numpy().transpose(0, 2, 3, 1)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                       axis_name="data")
    variables = {"params": {"scale": inputs["bn_scale"].numpy(),
                            "bias": inputs["bn_bias"].numpy()},
                 "batch_stats": {"mean": np.zeros(6, np.float32),
                                 "var": np.ones(6, np.float32)}}
    mesh = create_mesh(2)

    def local(params, xs, ws):
        out, mutated = bn.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                xs, mutable=["batch_stats"])
        return jax.lax.psum(jnp.sum(out * ws), "data"), (
            out, mutated["batch_stats"])

    fn = _shard_map(local, mesh, (P(), P("data"), P("data")),
                    (P(), (P("data"), P())))
    (_, (out, stats)), (dparams, dx) = jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True)(variables["params"], x, w)
    ranks = _ranks(two, "bn")
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat([r["out"] for r in ranks]).numpy(),
                               nchw(out), **tol)
    np.testing.assert_allclose(torch.cat([r["dx"] for r in ranks]).numpy(),
                               nchw(dx), **tol)
    for r in ranks:
        np.testing.assert_allclose(r["dscale"].numpy(), dparams["scale"],
                                   **tol)
        np.testing.assert_allclose(r["dbias"].numpy(), dparams["bias"], **tol)
        np.testing.assert_allclose(r["running_mean"].numpy(), stats["mean"],
                                   **tol)
        np.testing.assert_allclose(r["running_var"].numpy(), stats["var"],
                                   **tol)


def test_loader_shards_partition_the_global_batch(two):
    from clip_lite_torch.data.pipeline import DataLoader, infinite_batches

    stream = infinite_batches(DataLoader(workers.IdDataset(), 8, shuffle=True, drop_last=True,
                                         num_workers=1, seed=7,
                                         background=False))
    full = [next(stream)["image_id"].numpy() for _ in range(6)]
    stream.close()
    ranks = _ranks(two, "input")
    for i, want in enumerate(full):
        got = np.concatenate([r["loader"][i] for r in ranks])
        np.testing.assert_array_equal(got, want)
        assert len(ranks[0]["loader"][i]) == 4


def test_cache_placements_give_equal_batches(two):
    from clip_lite_torch.data.device_cache import shard_layout

    ranks = _ranks(two, "input")
    take, valid, m = shard_layout(13, 2, 3)
    assert sorted(set(take.tolist())) == list(range(13))
    for r, rank in enumerate(ranks):
        sharded, replicated = rank["caches"]["sharded"], \
            rank["caches"]["replicated"]
        np.testing.assert_array_equal(sharded["rows"], take[r * m:(r + 1) * m])
        np.testing.assert_array_equal(replicated["rows"], take)
        assert replicated["bytes"] == 2 * sharded["bytes"]
        for a, b in zip(sharded["batches"], replicated["batches"]):
            assert sorted(a) == sorted(b)
            for k in a:
                assert torch.equal(a[k], b[k]), k
            # Each rank draws from its own block only.
            block = set((100 + take[r * m:r * m + valid[r]]).tolist())
            assert set(a["image_id"].tolist()) <= block
            assert a["image"].shape == (4, 8, 8, 3)
            assert a["input_ids"].shape[1] == 6  # the corpus-wide bucket


def test_metrics_and_config_dump_on_rank0_logs_on_each(two):
    """Rank 0 writes the metrics and the config dump; every rank logs to
    its own suffixed file (after JAX ``tests/test_distributed.py:91,
    177``)."""
    files = [sorted(os.listdir(os.path.join(two["workdir"],
                                            f"files_rank{r}")))
             for r in range(2)]
    assert files[0] == ["log_pretrain_h0.txt", "metrics.jsonl",
                        "pretrain_config.yaml"]
    assert files[1] == ["log_pretrain_h1.txt"]


def test_zero1_checkpoint_written_by_rank0_loads_and_resumes(two, tmp_path):
    workdir = two["workdir"]
    rank0 = [os.path.join(root, f)
             for root, _, files in os.walk(os.path.join(workdir, "ckpt_rank0"))
             for f in files]
    assert [os.path.basename(p) for p in rank0] == \
        [f"checkpoint_{workers.CHECKPOINT_AT}.msgpack"]
    assert not os.path.exists(os.path.join(workdir, "ckpt_rank1"))
    path = rank0[0]
    ranks = _ranks(two, "sync_zero1")
    after = ranks[0]["after"]

    # One port process loads it: the two-rank state after its step 2, the
    # optimizer's slices gathered.
    cfg = Config(workers.FLAGSHIP, workers.TRAIN + [
        "MODEL.VISUAL.BN_MODE", "sync", "PARALLEL.ZERO1", True])
    state = create_train_state(cfg, device="cpu")
    manager = CheckpointManager(str(tmp_path / "resume"), state=state)
    assert manager.load(path) == workers.CHECKPOINT_AT
    state = manager.restored("state")
    assert state.step == state.optimizer.count == workers.CHECKPOINT_AT
    _assert_state(state.model.state_dict(), after["model"], rtol=0, atol=0)
    opt = state.optimizer.jax_state(lambda d: d)
    for field in ("trace", "slow_params"):
        _assert_state(opt[field], after["optimizer"][field], rtol=0, atol=0)
    assert (int(opt["count"]), int(opt["la_count"])) == \
        (int(after["optimizer"]["count"]), int(after["optimizer"]["la_count"]))

    # The JAX package's manager reads it into its own TrainState.
    jcfg = JConfig(workers.FLAGSHIP, workers.TRAIN)
    tx = JOptimizerFactory.from_config(jcfg)
    params = jax.tree.map(jnp.asarray, two["variables"]["params"])
    jstate = jengine.TrainState(step=jnp.zeros([], jnp.int32), params=params,
                                batch_stats=two["variables"]["batch_stats"],
                                opt_state=tx.init(params))
    jmanager = JCheckpointManager(str(tmp_path / "jax"), state=jstate)
    assert jmanager.load(path) == workers.CHECKPOINT_AT
    loaded = jmanager.restored("state")
    got = bridge.convert({"params": loaded.params,
                          "batch_stats": loaded.batch_stats}, state.model)
    _assert_state(after["model"], {k: v.numpy() for k, v in got.items()},
                  rtol=0, atol=0)
    assert int(loaded.opt_state.count) == workers.CHECKPOINT_AT

    # Resumed at a world of one, it takes step 3 on the whole global batch
    # (the noise of both ranks' rows) as a process handed the two-rank
    # state in memory does.  (Not the two-rank step itself: the loss's
    # critics normalize over each rank's rows, in JAX too.)
    noise = {k: torch.cat([v, v]) for k, v in two["inputs"]["noise"].items()}
    held = create_train_state(cfg, device="cpu",
                              state_dict=after["model"])
    held.optimizer.load_jax_state(after["optimizer"], lambda d: d)
    held.step = workers.CHECKPOINT_AT
    step = make_train_step(cfg)
    results = [step(s, two["batches"][-1], prior_noise=noise)
               for s in (state, held)]
    (a, ma), (b, mb) = results
    assert metrics_to_floats(ma) == metrics_to_floats(mb)
    _assert_state(a.model.state_dict(), b.model.state_dict(), rtol=0, atol=0)
    assert a.step == a.optimizer.count == a.optimizer.la_count == STEPS


# -- the quality protocol's corpus --------------------------------------
def test_quality_protocol_corpus_is_the_jax_campaigns():
    """``quality_protocol.SYNTH`` is ``make_synth_data``'s arguments in
    ``clip_lite_tpu/scripts/run_quality_r5.sh`` (its output directory
    aside), with the seed that script leaves at its default, 0."""
    script = open(os.path.join(ROOT, "clip_lite_tpu", "scripts",
                               "run_quality_r5.sh")).read()
    call = re.search(r"clip_lite_tpu\.scripts\.make_synth_data(.*?)>>",
                     script.replace("\\\n", " "), re.S).group(1)
    args = shlex.split(call)
    at = args.index("--output-dir")
    del args[at:at + 2]
    pairs = dict(zip(args[::2], args[1::2]))
    synth = dict(zip(quality_protocol.SYNTH[::2], quality_protocol.SYNTH[1::2]))
    assert pairs == {"--train-n": "6000", "--val-n": "500"}
    assert synth == dict(pairs, **{"--seed": "0"})
