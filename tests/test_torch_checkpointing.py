"""Checkpoints in the port (clip_lite_torch/utils/checkpointing.py) against
the JAX package's own (clip_lite_tpu/utils/checkpointing.py), in its
msgpack format, on the CPU.

* The port's counterparts of every case of tests/test_checkpointing.py:
  round trip, rotation, best metric, climax snapshots, latest, atomic
  writes, tolerant loads, async writes (not torn by the next in-place
  update, failures re-raised by ``wait``).
* Across the packages: a tiny flagship ``TrainState`` from the JAX
  package, with non-trivial ``trace``, ``slow_params``, BatchNorm
  statistics and counters, saved by the JAX ``CheckpointManager``, loads
  into the port exactly; the port's checkpoint loads with the JAX
  ``CheckpointManager.load`` and ``load_model_variables``, every leaf
  exactly equal in value, shape and dtype; ``EncoderBundle`` from one
  checkpoint agrees between the packages at 1e-4 (fp32).
* The bridge's inverse: ``convert(to_jax_variables(sd)) == sd`` for BERT
  and MPNet, channels_last included.
* Resume in the port: N steps equal k steps, save, load into a fresh
  state, N - k steps, bit for bit, for float32 and uint8 batches.
* ``train_loop``'s cadence writes the files the JAX driver's rules give.
"""

import os
import threading

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from flax import serialization

from clip_lite_tpu import engine as jengine
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.data.tokenizers import HashingTokenizer as JTokenizer
from clip_lite_tpu.eval_utils import EncoderBundle as JBundle
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_tpu.train import crossed_interval as jcrossed_interval
from clip_lite_tpu.utils import checkpointing as jckpt
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.data.device_cache import DecodedCorpus, DeviceDataCache
from clip_lite_torch.data.tokenizers import HashingTokenizer
from clip_lite_torch.engine import (
    TrainState,
    create_train_state,
    load_jax_tree,
    make_train_step,
    to_jax_tree,
)
from clip_lite_torch.eval_utils import EncoderBundle
from clip_lite_torch.factories import PretrainingModelFactory
from clip_lite_torch.ops.image_ops import AugDraws
from clip_lite_torch.ops.layers import BatchNorm, init_weights
from clip_lite_torch.optim.fused import (
    FusedOptimizer,
    chain_state,
    slow_params_from_state,
)
from clip_lite_torch.train import train_loop
from clip_lite_torch.utils import checkpointing as ckpt_mod
from clip_lite_torch.utils import msgpack_io
from clip_lite_torch.utils.checkpointing import (
    CheckpointManager,
    latest_checkpoint,
    load_model_variables,
    peek_iteration,
)
from test_torch_train import B, FLAGSHIP, L, TRAIN

CROP = 32
CAPTIONS = ["a dog runs on the beach", "two cats", "a red car parked by a "
            "long wall in the city at night", "people", "a plate of food"]


class _Tiny(nn.Module):
    """A Dense and a BatchNorm: a TrainState as small as the JAX test's."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(3, 4)
        self.norm = BatchNorm(4)


def tiny_state(value=1.0):
    model = _Tiny()
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            t.fill_(value)
    optimizer = FusedOptimizer(model, Config(FLAGSHIP, TRAIN), lambda c: 1.0)
    optimizer.count = 7
    return TrainState(step=3, model=model, optimizer=optimizer)


def _weight(state) -> float:
    return float(state.model.dense.weight[0, 0])


def test_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path), state=tiny_state(2.5))
    path = m.step(10)
    target = tiny_state(0.0)
    target.step, target.optimizer.count = 0, 0
    m2 = CheckpointManager(str(tmp_path), state=target)
    assert m2.load(path) == 10 and peek_iteration(path) == 10
    restored = m2.restored("state")
    assert restored is target  # in place
    assert torch.equal(restored.model.dense.weight, torch.full((4, 3), 2.5))
    assert torch.equal(restored.model.norm.running_var, torch.full((4,), 2.5))
    assert restored.step == 3 and restored.optimizer.count == 7


def test_rotation(tmp_path):
    m = CheckpointManager(str(tmp_path), keep_recent=2, state=tiny_state())
    for it in (1, 2, 3, 4):
        m.step(it)
    files = sorted(os.listdir(tmp_path))
    assert "checkpoint_1.msgpack" not in files
    assert "checkpoint_2.msgpack" not in files
    assert "checkpoint_3.msgpack" in files and "checkpoint_4.msgpack" in files


def test_best_metric_min_mode(tmp_path):
    m = CheckpointManager(str(tmp_path), state=tiny_state(1.0))
    m.step(1, metric=5.0)
    m.checkpointables["state"] = tiny_state(2.0)
    m.step(2, metric=3.0)  # better
    m.checkpointables["state"] = tiny_state(9.0)
    m.step(3, metric=4.0)  # worse; best stays from it=2
    best = str(tmp_path / "checkpoint_best.msgpack")
    variables = load_model_variables(best)
    np.testing.assert_array_equal(variables["params"]["dense"]["kernel"],
                                  np.full((3, 4), 2.0, np.float32))
    with open(best, "rb") as a, open(tmp_path / "checkpoint_2.msgpack",
                                     "rb") as b:
        assert a.read() == b.read()  # the same bytes


def test_climax_model_only(tmp_path):
    m = CheckpointManager(str(tmp_path), state=tiny_state(3.0))
    path = m.climax_step(42)
    assert path.endswith("climax_model_42.msgpack")
    assert set(msgpack_io.read(path)) == {"params", "batch_stats", "iteration"}
    variables = load_model_variables(path)
    np.testing.assert_array_equal(variables["params"]["dense"]["kernel"],
                                  np.full((3, 4), 3.0, np.float32))
    np.testing.assert_array_equal(
        variables["batch_stats"]["norm"]["BatchNorm_0"]["mean"],
        np.full(4, 3.0, np.float32))
    assert "opt_state" not in variables


def test_latest_checkpoint(tmp_path):
    m = CheckpointManager(str(tmp_path), state=tiny_state())
    m.step(5)
    m.step(20)
    m.climax_step(99)  # climax snapshots are not "latest" candidates
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint_20.msgpack")
    assert latest_checkpoint(str(tmp_path / "empty")) is None


def test_no_partial_files_on_disk(tmp_path):
    m = CheckpointManager(str(tmp_path), state=tiny_state())
    m.step(1, metric=1.0)
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_load_tolerates_extra_checkpointables(tmp_path):
    """A file with more checkpointables than the manager knows loads."""
    extra = {"x": torch.ones(3), "y": np.arange(2)}
    m = CheckpointManager(str(tmp_path), state=tiny_state(), extra=extra)
    path = m.step(7)
    m2 = CheckpointManager(str(tmp_path), state=tiny_state(0.0))
    assert m2.load(path) == 7
    target = {"x": torch.zeros(3), "y": np.zeros(2)}
    m3 = CheckpointManager(str(tmp_path), extra=target)
    assert m3.load(path) == 7
    assert m3.restored("extra")["x"] is target["x"]  # tensors in place
    assert torch.equal(target["x"], torch.ones(3))
    np.testing.assert_array_equal(m3.restored("extra")["y"], np.arange(2))


def test_async_writes_roundtrip_and_best(tmp_path):
    """Async mode: step() returns at once, wait() drains, best tracking
    runs in save order on the worker."""
    m = CheckpointManager(str(tmp_path), async_writes=True,
                          state=tiny_state(1.0))
    assert m.async_writes
    assert not CheckpointManager(str(tmp_path), state=tiny_state()).async_writes
    p1 = m.step(10, metric=0.9)
    m.checkpointables["state"] = tiny_state(2.0)
    p2 = m.step(20, metric=0.5)     # better -> becomes best
    m.checkpointables["state"] = tiny_state(3.0)
    p3 = m.step(30, metric=0.7)     # worse -> best unchanged
    m.wait()
    for p in (p1, p2, p3):
        assert os.path.exists(p)
    best = str(tmp_path / "checkpoint_best.msgpack")
    loader = CheckpointManager(str(tmp_path), state=tiny_state(0.0))
    assert loader.load(best) == 20
    assert _weight(loader.restored("state")) == 2.0
    # load() on the async manager itself drains the queue first
    m.checkpointables["state"] = tiny_state(9.0)
    p4 = m.step(40)
    assert m.load(p4) == 40


def test_async_step_is_not_torn_by_the_next_update(tmp_path, monkeypatch):
    """The worker must write the state as it was when step() returned: the
    next train step updates the same tensors in place.  Simulated by
    overwriting every tensor, gated so that it lands before the worker's
    copy to the host."""
    release = threading.Event()
    real_to_host = ckpt_mod._Staging.to_host

    def gated_to_host(self):
        assert release.wait(timeout=30)
        return real_to_host(self)

    monkeypatch.setattr(ckpt_mod._Staging, "to_host", gated_to_host)
    state = tiny_state(4.5)
    m = CheckpointManager(str(tmp_path), async_writes=True, state=state)
    p1 = m.step(11)
    with torch.no_grad():
        for t in list(state.model.parameters()) + list(state.model.buffers()):
            t.fill_(-1.0)
        for t in state.optimizer.slow_state().values():
            t.fill_(-1.0)
    state.step = state.optimizer.count = 99
    release.set()
    m.wait()
    loader = CheckpointManager(str(tmp_path), state=tiny_state(0.0))
    assert loader.load(p1) == 11
    restored = loader.restored("state")
    assert _weight(restored) == 4.5 and restored.step == 3
    assert restored.optimizer.count == 7
    assert all(float(t.flatten()[0]) == 4.5
               for t in restored.optimizer.slow_state().values())

    # The same for climax (model-only) snapshots.
    release.clear()
    with torch.no_grad():
        state.model.dense.weight.fill_(6.25)
    p2 = m.climax_step(12)
    with torch.no_grad():
        state.model.dense.weight.fill_(-1.0)
    release.set()
    m.wait()
    np.testing.assert_array_equal(
        load_model_variables(p2)["params"]["dense"]["kernel"],
        np.full((3, 4), 6.25, np.float32))


def test_async_write_failure_is_raised_on_wait(tmp_path, monkeypatch):
    m = CheckpointManager(str(tmp_path), async_writes=True,
                          state=tiny_state())

    def boom(path, tree):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.msgpack_io, "write", boom)
    m.step(10)
    with pytest.raises(OSError, match="disk full"):
        m.wait()


def _jax_tiny_state(value=1.0):
    return jengine.TrainState(
        step=jnp.asarray(3, jnp.int32),
        params={"layer": {"w": jnp.full((4,), value)}},
        batch_stats={"layer": {"mean": jnp.zeros(4)}},
        opt_state=(jnp.asarray(7, jnp.int32), {"m": jnp.ones(2)}))


def test_final_checkpoint_survives_keep_recent_one(tmp_path):
    """With keep_recent 1, a final save at an iteration just saved (the
    loop's final ``step(NUM_ITERATIONS)`` when ``checkpoint_every`` divides
    it) keeps its file in the port.  The JAX package's rotation deletes
    the file it has just written, which leaves no checkpoint at all (a
    deliberate difference, ROADMAP Queue 3; the rotation is otherwise the
    same, see the cadence test)."""
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    m = CheckpointManager(str(port), keep_recent=1, state=tiny_state())
    jm = jckpt.CheckpointManager(str(jax_dir), keep_recent=1,
                                 state=_jax_tiny_state())
    for manager in (m, jm):
        for it in (5, 10, 10):
            manager.step(it)
    assert sorted(os.listdir(port)) == ["checkpoint_10.msgpack"]
    assert os.listdir(jax_dir) == []


# -- resume ----------------------------------------------------------------

N, K = 6, 3  # six steps, or three, a save and three more (Lookahead at 5)


def _float_batches(n=N):
    rng = np.random.RandomState(5)
    return [{"image": rng.randn(B, CROP, CROP, 3).astype(np.float32),
             "input_ids": rng.randint(1, 128, (B, L)).astype(np.int32),
             "attention_mask": (np.arange(L)[None] < rng.randint(
                 2, L + 1, (B, 1))).astype(np.int32)} for _ in range(n)]


def _u8(batches):
    rng = np.random.RandomState(6)
    return [dict(b, image=rng.randint(0, 256, b["image"].shape).astype(
        np.uint8)) for b in batches]


def _cache():
    rng = np.random.RandomState(7)
    n = 12
    ids = [rng.randint(1, 128, (3, L)).astype(np.int32) for _ in range(n)]
    mask = [(np.arange(L)[None] < rng.randint(2, L + 1, (3, 1))).astype(
        np.int32) for _ in range(n)]
    corpus = DecodedCorpus(rng.randint(0, 256, (n, 40, 40, 3)).astype(np.uint8),
                           ids, mask, np.full(n, 3), np.arange(n))
    return DeviceDataCache(corpus, B, cache_size=40, crop_size=CROP, seed=2,
                           device="cpu")


def _draws(step):
    rng = np.random.RandomState(100 + step)
    u = torch.from_numpy(rng.uniform(size=(6, B)).astype(np.float32))
    return AugDraws(flip=u[0] < 0.5, apply=u[1] < 0.8,
                    brightness=0.6 + 0.8 * u[2], contrast=0.6 + 0.8 * u[3],
                    saturation=0.6 + 0.8 * u[4], hue=0.2 * u[5] - 0.1)


@pytest.mark.parametrize("kind", ["float32", "uint8-cache", "uint8-draws"])
def test_resume_is_bit_for_bit(kind, tmp_path):
    """N steps, against K steps, a checkpoint, a fresh state loaded from it
    and N - K steps: every parameter, statistic, optimizer buffer and
    counter equal, with dropout on.  uint8 batches come from a
    DeviceDataCache (resumed through ``set_start``, augmentation draws from
    the step's StepRNG) or from a list with injected draws."""
    cfg = _port_config("MODEL.TEXTUAL.DROPOUT", 0.1)
    train_step = make_train_step(cfg)
    step = train_step
    if kind == "uint8-draws":
        def step(st, batch):
            return train_step(st, batch, aug_draws={"image": _draws(st.step)})

    def source(start):
        if kind == "uint8-cache":
            return _cache()  # train_loop sets its start on a resume
        batches = _float_batches() if kind == "float32" else _u8(
            _float_batches())
        return iter(batches[start:])

    whole = train_loop(create_train_state(cfg, device="cpu"), step, source(0),
                       N)
    first = create_train_state(cfg, device="cpu")
    manager = CheckpointManager(str(tmp_path / "first"), state=first)
    train_loop(first, step, source(0), K, checkpoint_every=K, manager=manager)
    path = str(tmp_path / "first" / f"checkpoint_{K}.msgpack")
    fresh = create_train_state(cfg, device="cpu")
    with torch.no_grad():  # nothing of the seeded init may survive the load
        for t in fresh.model.state_dict().values():
            t.fill_(0.25)
    resumed = train_loop(fresh, step, source(K), N, manager=CheckpointManager(
        str(tmp_path / "second"), state=fresh), resume_from=path)
    assert resumed is fresh and resumed.step == whole.step == N
    _assert_state_dicts_equal(resumed.model.state_dict(),
                              whole.model.state_dict())
    for attr in ("trace", "slow"):
        _assert_state_dicts_equal(resumed.optimizer._by_name(attr),
                                  whole.optimizer._by_name(attr))
    assert (resumed.optimizer.count, resumed.optimizer.la_count) == (N, N)
    assert (whole.optimizer.count, whole.optimizer.la_count) == (N, N)


# -- across the packages ---------------------------------------------------

def _sample_batch():
    return {"image": np.zeros((1, CROP, CROP, 3), np.float32),
            "input_ids": np.zeros((1, L), np.int32),
            "attention_mask": np.ones((1, L), np.int32)}


@pytest.fixture(scope="module")
def jax_state():
    """The tiny flagship's JAX TrainState (fused optimizer, SGD + Lookahead)
    with seeded trace, slow weights and BatchNorm statistics, step 9,
    count 7 and la_count 4, all set from numpy."""
    jcfg = JConfig(FLAGSHIP, TRAIN)
    assert jcfg.OPTIM.FUSED and jcfg.OPTIM.LOOKAHEAD.USE
    model = JModelFactory.from_config(jcfg)
    tx = JOptimizerFactory.from_config(jcfg)
    with jax.default_prng_impl("threefry2x32"):
        # Jitted: flax's eager init compiles op by op, three times as slow.
        state = jax.jit(lambda b: jengine.create_train_state(
            model, tx, b, seed=0))(_sample_batch())
    rng = np.random.RandomState(0)

    def seeded(tree):
        return jax.tree.map(
            lambda p: np.asarray(rng.randn(*p.shape), np.float32), tree)

    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(
            rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
            else 0.1 * rng.randn(*v.shape), np.float32), state.batch_stats)
    return state.replace(
        step=np.asarray(9, np.int32), batch_stats=stats,
        opt_state=state.opt_state._replace(
            trace=seeded(state.params), slow_params=seeded(state.params),
            count=np.asarray(7, np.int32), la_count=np.asarray(4, np.int32)))


def _port_config(*extra):
    return Config(FLAGSHIP, TRAIN + ["MODEL.TEXTUAL.FUSED_ATTENTION", "true",
                                     *extra])


def _assert_state_dicts_equal(got, want):
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


@pytest.fixture(scope="module")
def jax_checkpoint(jax_state, tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("jax_ckpt"))
    return jckpt.CheckpointManager(directory, state=jax_state).step(11)


def test_jax_checkpoint_resumes_in_the_port(jax_state, jax_checkpoint, tmp_path):
    cfg = _port_config()
    state = create_train_state(cfg, device="cpu")
    manager = CheckpointManager(str(tmp_path), state=state)
    assert manager.load(jax_checkpoint) == 11
    variables = jax.tree.map(np.asarray, {"params": jax_state.params,
                                          "batch_stats": jax_state.batch_stats})
    _assert_state_dicts_equal(state.model.state_dict(),
                              bridge.convert(variables, state.model))
    opt = jax_state.opt_state
    for field, got in (("trace", state.optimizer._by_name("trace")),
                       ("slow_params", slow_params_from_state(state.optimizer))):
        _assert_state_dicts_equal(got, bridge.from_jax_params(
            jax.tree.map(np.asarray, getattr(opt, field)), state.model))
    assert (state.step, state.optimizer.count, state.optimizer.la_count) == \
        (9, 7, 4)


def _state_dict_of(tree):
    """A TrainState tree as a nested dict of numpy (flax's state dict)."""
    return jax.tree.map(np.asarray, serialization.to_state_dict(tree))


def _assert_trees_identical(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_identical(got[k], want[k], f"{path}/{k}")
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.fixture(scope="module")
def port_checkpoint(jax_checkpoint, tmp_path_factory):
    """The port's state loaded from the JAX checkpoint and moved one step,
    saved (full and climax) by the port; channels_last weights, as on the
    card."""
    cfg = _port_config()
    state = create_train_state(cfg, device="cpu")
    directory = str(tmp_path_factory.mktemp("port_ckpt"))
    manager = CheckpointManager(directory, state=state)
    manager.load(jax_checkpoint)
    state, _ = make_train_step(cfg)(state, _float_batches()[0])
    state.model.to(memory_format=torch.channels_last)
    assert any(p.ndim == 4 and not p.is_contiguous()
               for p in state.model.parameters())
    return dict(state=state, full=manager.step(12),
                climax=manager.climax_step(12))


def test_port_checkpoint_loads_in_jax(jax_state, port_checkpoint, tmp_path):
    state = port_checkpoint["state"]
    want = jax.tree.map(lambda t: bridge.to_numpy(t) if isinstance(
        t, torch.Tensor) else t, to_jax_tree(state))
    assert int(want["step"]) == 10 and int(want["opt_state"]["count"]) == 8
    manager = jckpt.CheckpointManager(str(tmp_path), state=jax_state)
    assert manager.load(port_checkpoint["full"]) == 12
    restored = manager.restored("state")
    # The JAX target's tree, leaf for leaf in shape and dtype ...
    _assert_trees_identical(
        jax.tree.map(lambda x: np.zeros(np.shape(x), np.asarray(x).dtype),
                     _state_dict_of(restored)),
        jax.tree.map(lambda x: np.zeros(np.shape(x), np.asarray(x).dtype),
                     _state_dict_of(jax_state)))
    # ... holding exactly the port's values.
    _assert_trees_identical(_state_dict_of(restored), want)
    variables = bridge.to_jax_variables(state.model.state_dict(), state.model)
    for path in ("full", "climax"):
        _assert_trees_identical(
            jax.tree.map(np.asarray, jckpt.load_model_variables(
                port_checkpoint[path])), variables)
    assert jckpt.peek_iteration(port_checkpoint["climax"]) == 12


def test_fused_opt_state_only(jax_state, jax_checkpoint, tmp_path):
    """The optax chain's opt state (what the JAX package writes under
    OPTIM.FUSED false) loads as the fused one does, whatever the port's
    OPTIM.FUSED; a chain or a fused state of another optimizer config
    raises, naming why."""
    state = create_train_state(_port_config(), device="cpu")
    tree = msgpack_io.read(jax_checkpoint)["state"]
    fused = create_train_state(_port_config(), device="cpu")
    load_jax_tree(fused, tree)
    chain = dict(tree, opt_state=chain_state(
        tree["opt_state"], state.optimizer.chain_parts, True))
    assert set(chain["opt_state"]) == {"inner_state", "slow_params",
                                       "step_count"}
    load_jax_tree(state, chain)
    for attr in ("trace", "slow"):
        _assert_state_dicts_equal(state.optimizer._by_name(attr),
                                  fused.optimizer._by_name(attr))
    assert (state.optimizer.count, state.optimizer.la_count) == (7, 4)
    other = dict(tree, opt_state={"0": {}, "1": tree["opt_state"]["trace"]})
    with pytest.raises(ValueError, match="another OPTIM config"):
        load_jax_tree(state, other)
    adam = create_train_state(_port_config("OPTIM.OPTIMIZER_NAME", "adamw"),
                              device="cpu")
    with pytest.raises(ValueError, match="another OPTIM config"):
        load_jax_tree(adam, tree)
    assert slow_params_from_state(create_train_state(_port_config(
        "OPTIM.LOOKAHEAD.USE", False), device="cpu").optimizer) is None


@pytest.mark.parametrize("project,normalize", [(True, True), (True, False),
                                               (False, True), (False, False)])
def test_encoder_bundle_from_checkpoint_matches_jax(port_checkpoint, project,
                                                    normalize):
    """The port's EncoderBundle and the JAX package's on the port's
    checkpoint: the fast weights, with and without the projection heads and
    the normalisation.  Bar: 1e-4, relative and of the largest value
    (unnormalized, the seeded tiny ResNet's features in eval mode reach 1e7,
    where a fixed atol would measure fp32's order of sums)."""
    path = port_checkpoint["full"]
    ours = EncoderBundle(_port_config(), path, 4, project, normalize,
                         device="cpu")
    theirs = JBundle(JConfig(FLAGSHIP, TRAIN), checkpoint_path=path,
                     batch_size=4, project=project, normalize=normalize)

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * max(1.0, np.abs(want).max()))

    images = np.random.RandomState(0).randn(5, CROP, CROP, 3).astype(np.float32)
    got, want = ours.encode_images(images), theirs.encode_images(images)
    assert got.shape == want.shape == (5, 2048 if project else 64)
    close(got, want)
    close(ours.encode_image_batches([{"image": images[:3]}, images[3:]]),
          theirs.encode_image_batches([{"image": images[:3]}, images[3:]]))
    got = ours.encode_texts(CAPTIONS, HashingTokenizer(128, L))
    want = theirs.encode_texts(CAPTIONS, JTokenizer(128, L))
    assert got.shape == want.shape == (5, 2048 if project else 128)
    close(got, want)
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    # The fast weights: the state's parameters, not its slow ones.
    fast = EncoderBundle(_port_config(), batch_size=4, device="cpu",
                         state_dict=port_checkpoint["state"].model.state_dict())
    np.testing.assert_array_equal(
        EncoderBundle(_port_config(), path, 4, device="cpu").encode_images(
            images), fast.encode_images(images))
    with pytest.raises(ValueError):
        EncoderBundle(_port_config(), path, state_dict={}, device="cpu")


@pytest.mark.parametrize("text", ["bert", "mpnet"])
@pytest.mark.parametrize("memory_format", [torch.contiguous_format,
                                           torch.channels_last])
def test_bridge_round_trip(jax_state, text, memory_format):
    overrides = (["MODEL.TEXTUAL.NETWORK_NAME", "microsoft/mpnet-base"]
                 if text == "mpnet" else [])
    model = PretrainingModelFactory.from_config(_port_config(*overrides))
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(memory_format=memory_format)
    sd = model.state_dict()
    variables = bridge.to_jax_variables(sd, model)
    _assert_state_dicts_equal(bridge.convert(variables, model), sd)
    named = dict(model.named_parameters())
    params = bridge.to_jax_params(named, model)
    _assert_state_dicts_equal(bridge.from_jax_params(params, model),
                              {k: p.detach() for k, p in named.items()})
    if text == "bert":  # the JAX package's tree, path for path
        _assert_trees_identical(
            jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), variables),
            jax.tree.map(lambda x: np.zeros(np.shape(x), np.asarray(x).dtype),
                         {"params": jax_state.params,
                          "batch_stats": jax_state.batch_stats}))
    for leaf in jax.tree.leaves(variables):
        assert leaf.flags.c_contiguous


# -- the loop's cadence ----------------------------------------------------

def _metric(iteration):
    return float((iteration * 7) % 5)


def _jax_driver_files(directory, checkpoint_every, climax_freq, n,
                      keep_recent, monkeypatch):
    """The files the JAX driver's loop writes (``train.py:339-371``: a
    checkpoint with the val metric at each ``checkpoint_every``, a climax
    snapshot at each ``climax_freq`` past 80%, a final checkpoint), through
    the JAX CheckpointManager; its loop body cannot be called alone, so its
    rules are restated here with its ``crossed_interval``."""
    written = []
    real = jckpt._atomic_write

    def recording(path, data):
        written.append(os.path.basename(path))
        real(path, data)

    monkeypatch.setattr(jckpt, "_atomic_write", recording)
    manager = jckpt.CheckpointManager(directory, keep_recent=keep_recent,
                                      state=_jax_tiny_state())
    for iteration in range(1, n + 1):
        if jcrossed_interval(iteration, checkpoint_every):
            manager.step(iteration, metric=_metric(iteration))
        if iteration / n > 0.8 and jcrossed_interval(iteration, climax_freq):
            manager.climax_step(iteration)
    manager.step(n)
    manager.wait()
    monkeypatch.setattr(jckpt, "_atomic_write", real)
    return written


@pytest.mark.parametrize("checkpoint_every,climax_freq,n,keep_recent", [
    (5, 1, 10, 2), (3, 2, 10, 1), (4, 3, 20, 3), (7, 4, 30, 2),
    (10000, 1000, 7, 100)])
def test_train_loop_cadence_matches_jax_driver(tmp_path, monkeypatch,
                                               checkpoint_every, climax_freq,
                                               n, keep_recent):
    def fake_step(st, batch):
        st.step += 1
        return st, {}

    def fake_eval(st, batch, index=0):
        return {"total_loss": torch.tensor(_metric(st.step))}

    state = tiny_state()
    state.step = 0
    manager = CheckpointManager(str(tmp_path / "port"),
                                keep_recent=keep_recent, state=state)
    train_loop(state, fake_step, iter(range(n)), n, log_every=10 ** 6,
               eval_step=fake_eval, val_batches=[None],
               checkpoint_every=checkpoint_every, climax_freq=climax_freq,
               manager=manager)
    jax_dir = str(tmp_path / "jax")
    written = _jax_driver_files(jax_dir, checkpoint_every, climax_freq, n,
                                keep_recent, monkeypatch)
    assert [os.path.basename(w["path"]) for w in manager.written] == [
        w for w in written if w != "checkpoint_best.msgpack"]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(jax_dir))
    if "checkpoint_best.msgpack" in written:
        assert peek_iteration(str(tmp_path / "port" / "checkpoint_best.msgpack")
                              ) == peek_iteration(os.path.join(
                                  jax_dir, "checkpoint_best.msgpack"))
