"""The cluster hard-negative curriculum of the port against the JAX
package, on the CPU, over a tiny synthetic corpus (``make_synth_data``,
``coco_preprocess``) and its cluster maps (``scripts/cluster.py`` over a
seeded ``--embeddings-file``).

* ``CocoCaptionsClusteredDataset``: item for item the JAX dataset's (the
  pixels within one grey level, as the other dataset comparisons hold
  them; token ids, masks and the negative's caption exactly) over a k
  schedule that reloads the maps twice (k 2, 3, 4).
* ``infinite_batches`` calls ``set_iteration`` with each batch's
  iteration before that batch loads, in the background and the
  synchronous stream.
* The cluster-mode loss: every component and the features' gradients
  against ``JSDInfoMaxLoss`` at 1e-5, for the ``dot`` and ``concat``
  critics (fp32).
* Two train steps on (pair, negative) batches at tiny widths (ResNet-18
  at width 8, two BERT layers): uint8 images and negatives augmented on
  the device with JAX's draws, JAX's prior noise, dropout off; the
  metrics and the final state at 1e-4 against the JAX step from the same
  (bridged) weights.
* ``kmeans``: JAX's assignments and centres given JAX's initial centres;
  ``cluster.py``'s three pickles equal the JAX script's for one
  ``--embeddings-file``, JAX's initial centres handed over.
* The training CLI switches to the clustered loaders at
  NEGATIVE_SAMPLING_START_ITERATION (the batch halves in items, each with
  its negative), and a resume at or past it starts in cluster mode.
* ``quality_campaign --families sweep --sweep-device cpu`` over the run's
  checkpoint: the sweep's JSON.
* ``quality_protocol``'s ``data`` and ``seed0`` stages, shrunk to a tiny
  corpus and run on the CPU: the JSON it assembles, its band check, and a
  failing stage recorded and reported by its exit code.
"""

import json
import os
import pickle
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu import engine as jengine
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import (
    NegativeSamplingDatasetFactory as JNegativeFactory,
)
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_tpu.ops import loss as jloss
from clip_lite_tpu.scripts import cluster as jcluster
from clip_lite_torch import bridge
from clip_lite_torch import train as cli
from clip_lite_torch.config import Config
from clip_lite_torch.data.pipeline import DataLoader, infinite_batches
from clip_lite_torch.engine import (
    create_train_state, make_train_step, metrics_to_floats)
from clip_lite_torch.factories import NegativeSamplingDatasetFactory
from clip_lite_torch.ops.loss import JSDInfoMaxLoss
from clip_lite_torch.scripts import cluster, coco_preprocess, make_synth_data
from clip_lite_torch.scripts import quality_campaign, quality_protocol
from test_torch_data_pipeline import LEVEL
from test_torch_image_ops import jax_aug_draws
from test_torch_loss import inject_uniform
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
N_TRAIN, N_VAL, EMB = 24, 8, 6
COMPONENTS = ("total_loss", "cross_modal_loss", "visual_loss", "textual_loss")


@pytest.fixture(autouse=True, scope="module")
def _threefry():
    """JAX's default PRNG for this module's JAX draws (another test in the
    same process may have switched it)."""
    with jax.default_prng_impl("threefry2x32"):
        yield


def _embeddings(n, seed):
    """Four blobs of ``n`` points in EMB dimensions."""
    rng = np.random.RandomState(seed)
    centres = rng.randn(4, EMB) * 3
    return (centres[rng.randint(4, size=n)]
            + rng.randn(n, EMB)).astype(np.float32)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The corpus (COCO tree, CLRec records, the zero-shot tree) and the
    port's cluster maps, k 2-4, for both splits."""
    root = str(tmp_path_factory.mktemp("synth"))
    make_synth_data.main(make_synth_data.parser.parse_args([
        "--output-dir", root, "--train-n", str(N_TRAIN), "--val-n",
        str(N_VAL), "--zeroshot-per-class", "1", "--probe-train-per-class",
        "0", "--voc-trainval", "0", "--voc-test", "0", "--gender-n", "0",
        "--image-size", "48"]))
    for split in ("train", "val"):
        coco_preprocess.main(coco_preprocess.parser.parse_args([
            "--data-root", os.path.join(root, "coco"), "--split", split,
            "--output-dir", os.path.join(root, "serialized")]))
        emb = os.path.join(root, f"emb_{split}.npy")
        np.save(emb, _embeddings(N_TRAIN if split == "train" else N_VAL, 1))
        cluster.main(cluster.parser.parse_args([
            "--coco-root", os.path.join(root, "coco"), "--split", split,
            "--output-dir", os.path.join(root, "clusters"),
            "--min-clusters", "2", "--max-clusters", "4", "--iters", "10",
            "--embeddings-file", emb, "--device", "cpu"]))
    return root


def _overrides(root, *extra):
    return ["MODEL.NAME", "captions", "DATA.ROOT",
            os.path.join(root, "serialized"),
            "DATA.NEGATIVE_SAMPLING", "clusters",
            "DATA.NEGATIVE_SAMPLING_START_ITERATION", 0,
            "OPTIM.NUM_ITERATIONS", 10,
            "DATA.CLUSTER_PATH", os.path.join(root, "clusters"),
            "DATA.COCO_ROOT", os.path.join(root, "coco"),
            "DATA.IMAGE_CROP_SIZE", 32, "DATA.MAX_CAPTION_LENGTH", 16,
            "MODEL.TEXTUAL.VOCAB_SIZE", 512] + list(extra)


# -- the dataset ---------------------------------------------------------------

def test_clustered_dataset_matches_jax(synth):
    over = _overrides(synth)
    ours = NegativeSamplingDatasetFactory.from_config(Config(FLAGSHIP, over))
    theirs = JNegativeFactory.from_config(JConfig(FLAGSHIP, over))
    assert len(ours) == len(theirs) == N_TRAIN
    assert ours.cluster_options == theirs.cluster_options == [2, 3, 4]
    keys = {"image_id", "image", "input_ids", "attention_mask", "neg_image",
            "neg_input_ids", "neg_attention_mask"}
    # k follows the schedule from 0 to 10 over the options 2-4.
    for iteration, k in ((0, 2), (7, 3), (10, 4)):
        ours.set_iteration(iteration)
        theirs.set_iteration(iteration)
        for idx in range(N_TRAIN):
            a, b = ours[idx], theirs[idx]
            assert set(a) == set(b) == keys
            for key in keys - {"image", "neg_image"}:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            for key in ("image", "neg_image"):
                assert a[key].dtype == np.float32
                assert np.abs(a[key].astype(np.float64) - b[key]).max() <= LEVEL
        assert ours.current_cluster_num == theirs.current_cluster_num == k
        # The negative is another image of the same cluster.
        cmap, members = ours._current_maps()
        assert all(len(m) > 1 for m in members.values())
        assert sorted(cmap) == list(range(N_TRAIN))


def test_reload_is_atomic_under_threads(synth):
    """Items drawn on more threads than cores, switching often, while the
    schedule moves k back and forth: every item finds its image and a
    negative in the maps it read (a half-built member list would raise)."""
    ds = NegativeSamplingDatasetFactory.from_config(
        Config(FLAGSHIP, _overrides(synth)))
    errors, done = [], []

    def draw(n):
        try:
            for j in range(40):
                ds.set_iteration((0, 10, 7)[(n + j) % 3])
                item = ds[(n * 7 + j) % N_TRAIN]
                assert item["neg_image"].shape == (32, 32, 3)
            done.append(n)
        except Exception as e:  # noqa: BLE001 - collected for the assert
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=draw, args=(n,))
                   for n in range(2 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(done) == len(threads)


class _Recorder:
    """A dataset that records the iteration it was told before each item."""

    def __init__(self, n=10):
        self.n, self.iteration, self.seen = n, None, []

    def set_iteration(self, iteration):
        self.iteration = iteration

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        self.seen.append(self.iteration)
        return {"x": np.int64(self.iteration)}

    @staticmethod
    def collate_fn(items):
        return {"x": np.stack([d["x"] for d in items])}


@pytest.mark.parametrize("background", [True, False])
def test_set_iteration_precedes_each_batch(background):
    ds = _Recorder()
    loader = DataLoader(ds, 3, shuffle=True, num_workers=2, prefetch=2,
                        background=background)
    stream = infinite_batches(loader, start_iteration=5)
    for i in range(7):  # across the epochs of 3 batches
        batch = next(stream)
        assert batch["x"].tolist() == [5 + i] * 3
    stream.close()
    assert ds.iteration >= 11


# -- the loss ------------------------------------------------------------------

B, IMG, TXT = 8, 24, 16


@pytest.mark.parametrize("critic", ["dot", "concat"])
def test_cluster_loss_matches_jax(monkeypatch, critic):
    rng = np.random.RandomState(0)
    names = ("image", "text", "neg_image", "neg_text")
    feats = {k: rng.randn(B, IMG if "image" in k else TXT).astype(np.float32)
             for k in names}
    noise = {"image": rng.uniform(size=(B, IMG)).astype(np.float32),
             "text": rng.uniform(size=(B, TXT)).astype(np.float32)}
    jmod = jloss.JSDInfoMaxLoss(image_dim=IMG, text_dim=TXT,
                                critic_type=critic, image_prior=True,
                                text_prior=True, negatives="global",
                                prior_weight=0.1)
    f = [jnp.asarray(feats[k]) for k in names]

    def kwargs(x):
        return dict(zip(("image_features", "text_features",
                         "neg_image_features", "neg_text_features"), x))

    variables = jax.tree.map(np.asarray, jmod.init(
        {"params": jax.random.PRNGKey(0), "prior": jax.random.PRNGKey(1)},
        **kwargs(f), train=False))
    inject_uniform(monkeypatch, noise)

    def total(*x):
        out, mutated = jmod.apply(variables, **kwargs(x), train=True,
                                  mutable=["batch_stats"],
                                  rngs={"prior": jax.random.PRNGKey(2)})
        return out["total_loss"], (out, mutated.get("batch_stats", {}))

    (_, (out, stats)), grads = jax.value_and_grad(
        total, argnums=(0, 1, 2, 3), has_aux=True)(*f)
    out, grads = jax.tree.map(np.asarray, (out, grads))

    port = JSDInfoMaxLoss(IMG, TXT, critic_type=critic, image_prior=True,
                          text_prior=True, negatives="global",
                          prior_weight=0.1)
    port.load_state_dict(bridge.convert(variables, port))
    port.train()
    tensors = [torch.from_numpy(feats[k]).requires_grad_() for k in names]
    got = port(**kwargs(tensors), prior_noise={
        k: torch.from_numpy(v) for k, v in noise.items()})
    got["total_loss"].backward()
    for name in COMPONENTS:
        np.testing.assert_allclose(got[name].item(), float(out[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name, t, g in zip(names, tensors, grads):
        assert np.abs(g).max() > 0, name  # both terms reach every input
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    want = bridge.convert({"params": variables["params"],
                           "batch_stats": jax.tree.map(np.asarray, stats)}, port)
    for key, buf in port.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[key].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


# -- the train step --------------------------------------------------------------

STEP = ["AMP", False, "MODEL.VISUAL.NETWORK_NAME", "resnet18",
        "MODEL.VISUAL.FEATURE_SIZE", 512, "MODEL.VISUAL.WIDTH", 8,
        "DATA.IMAGE_CROP_SIZE", 32, "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 2,
        "MODEL.TEXTUAL.HIDDEN_SIZE", 128, "DATA.MAX_CAPTION_LENGTH", 8,
        "MODEL.TEXTUAL.VOCAB_SIZE", 128, "MODEL.TEXTUAL.DROPOUT", 0.0,
        "OPTIM.WARMUP_STEPS", 1, "OPTIM.NUM_ITERATIONS", 20,
        "OPTIM.CNN_LR", 0.002]
STEPS, L, STEP_B = 2, 8, 16
IMG_DIM, TXT_DIM = 64, 128  # prior noise, told apart by its shape


def _pair_batch(rng, b=STEP_B):
    def caption():
        lengths = rng.randint(2, L + 1, b)
        return (rng.randint(1, 128, (b, L)).astype(np.int32),
                (np.arange(L)[None, :] < lengths[:, None]).astype(np.int32))

    ids, mask = caption()
    neg_ids, neg_mask = caption()
    return {"image": rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8),
            "neg_image": rng.randint(0, 256, (b, 32, 32, 3)).astype(np.uint8),
            "input_ids": ids, "attention_mask": mask,
            "neg_input_ids": neg_ids, "neg_attention_mask": neg_mask}


def _jax_draws(key, step: int, b: int) -> dict:
    """JAX's step ``step`` draws for ``image`` and ``neg_image``:
    ``_maybe_device_preprocess`` splits its key once for each, in that
    order."""
    _, _, rng = jax.random.split(jax.random.fold_in(key, step), 3)
    out = {}
    for name in ("image", "neg_image"):
        rng, sub = jax.random.split(rng)
        out[name] = jax_aug_draws(sub, b)
    return out


def test_cluster_steps_match_jax(monkeypatch):
    jcfg = JConfig(FLAGSHIP, STEP)
    model = JModelFactory.from_config(jcfg)
    tx = JOptimizerFactory.from_config(jcfg)
    rng = np.random.RandomState(0)
    batches = [_pair_batch(rng) for _ in range(STEPS)]
    sample = jax.tree.map(lambda a: a[:1], batches[0])
    for k in ("image", "neg_image"):
        sample[k] = sample[k].astype(np.float32)
    state = jax.jit(lambda b: jengine.create_train_state(model, tx, b,
                                                         seed=0))(sample)
    noise = {"image": rng.uniform(size=(STEP_B, IMG_DIM)).astype(np.float32),
             "text": rng.uniform(size=(STEP_B, TXT_DIM)).astype(np.float32)}
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
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
    pstate = create_train_state(cfg, device="cpu", state_dict=(
        bridge.from_jax_variables(variables, cfg)))
    train_step = make_train_step(cfg)
    for i, batch in enumerate(batches):
        pstate, m = train_step(pstate, batch, prior_noise={
            k: torch.from_numpy(v) for k, v in noise.items()},
            aug_draws=_jax_draws(key, i, STEP_B))
        got = metrics_to_floats(m)
        for name in COMPONENTS + ("grad_norm",):
            np.testing.assert_allclose(got[name], want[i][name], rtol=1e-4,
                                       atol=1e-6, err_msg=f"step {i + 1} {name}")
    expected = bridge.convert(final, pstate.model)
    for name, value in pstate.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), expected[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


# -- k-means and cluster.py ----------------------------------------------------------

def _jax_init(n, k, seed=0):
    """The initial centres' rows that the JAX kmeans draws."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                        replace=False))


@pytest.mark.parametrize("k", [2, 5])
def test_kmeans_matches_jax(k):
    x = _embeddings(300, 2)
    want_assign, want_centres = jcluster.kmeans(x, k, 12)
    assign, centres = cluster.kmeans(x, k, 12, init=_jax_init(len(x), k),
                                     device="cpu")
    np.testing.assert_array_equal(assign, want_assign)
    np.testing.assert_allclose(centres, want_centres, rtol=1e-5, atol=1e-5)


def test_kmeans_keeps_empty_clusters():
    x = np.float32([[0, 0], [0, 0], [10, 10], [10, 11]])
    assign, centres = cluster.kmeans(x, 3, 3, init=[0, 1, 2], device="cpu")
    assert assign.tolist() == [0, 0, 2, 2]  # centre 1 ties with 0, loses
    np.testing.assert_array_equal(centres, [[0, 0], [0, 0], [10, 10.5]])


def test_cluster_pickles_match_jax(synth, tmp_path, monkeypatch):
    coco = os.path.join(synth, "coco")
    emb = os.path.join(synth, "emb_train.npy")
    args = ["--coco-root", coco, "--split", "train", "--min-clusters", "2",
            "--max-clusters", "4", "--iters", "10", "--embeddings-file", emb]
    jcluster.main(jcluster.parser.parse_args(
        args + ["--output-dir", str(tmp_path / "theirs")]))
    real = cluster.kmeans
    monkeypatch.setattr(cluster, "kmeans", lambda x, k, iters, **kw: real(
        x, k, iters, init=_jax_init(len(x), k), **kw))
    cluster.main(cluster.parser.parse_args(
        args + ["--output-dir", str(tmp_path / "ours"), "--device", "cpu"]))
    names = sorted(os.listdir(tmp_path / "theirs"))
    assert names == sorted(os.listdir(tmp_path / "ours"))
    assert len(names) == 5
    for name in names:
        with open(tmp_path / "ours" / name, "rb") as a, \
                open(tmp_path / "theirs" / name, "rb") as b:
            assert pickle.load(a) == pickle.load(b), name


# -- the CLI and the campaign --------------------------------------------------------

CLI_TINY = ["AMP", False, "MODEL.VISUAL.NETWORK_NAME", "resnet18",
            "MODEL.VISUAL.WIDTH", 8, "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 1,
            "MODEL.TEXTUAL.HIDDEN_SIZE", 64, "MODEL.TEXTUAL.VOCAB_SIZE", 128,
            "OPTIM.BATCH_SIZE", 8, "OPTIM.NUM_ITERATIONS", 4,
            "OPTIM.WARMUP_STEPS", 1]


def _cli_args(synth, out, start, flags=()):
    over = _overrides(synth, *CLI_TINY,
                      "DATA.NEGATIVE_SAMPLING_START_ITERATION", start)
    return cli.parser.parse_args([str(a) for a in (
        "--device", "cpu", "--config", FLAGSHIP, "--serialization-dir", out,
        "--checkpoint-every", 2, "--log-every", 1, "--cpu-workers", 2,
        *flags, "--config-override", *over)])


def _recorded_run(monkeypatch, args):
    """main(args) and, per step, its batch's image rows and keys."""
    seen = []
    real = cli.make_train_step

    def make_step(cfg):
        step = real(cfg)

        def recorded(state, batch):
            seen.append((state.step + 1, batch["image"].shape[0],
                         "neg_image" in batch))
            return step(state, batch)
        return recorded

    monkeypatch.setattr(cli, "make_train_step", make_step)
    state = cli.main(args)
    monkeypatch.setattr(cli, "make_train_step", real)
    return state, seen


@pytest.fixture(scope="module")
def switched_run(synth, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    out = str(tmp_path_factory.mktemp("run"))
    try:
        state, seen = _recorded_run(mp, _cli_args(synth, out, 2))
    finally:
        mp.undo()
    return out, state, seen


def test_cli_switches_to_clusters(switched_run):
    out, state, seen = switched_run
    assert state.step == 4
    assert seen == [(1, 8, False), (2, 4, True), (3, 4, True), (4, 4, True)]
    log = open(os.path.join(out, "log_pretrain.txt")).read()
    assert "Switching to clustered hard-negative sampling (iteration 2)" in log
    metrics = [json.loads(line) for line in
               open(os.path.join(out, "metrics.jsonl"))]
    assert [m["iteration"] for m in metrics if m["split"] == "val"] == [2, 4]
    assert all(np.isfinite(m["total_loss"]) and np.isfinite(
        m.get("grad_norm", 0.0)) for m in metrics)


@pytest.mark.parametrize("start", [2, 4])
def test_cli_resume_starts_in_the_phase_of_its_iteration(
        synth, switched_run, tmp_path, monkeypatch, start):
    run_dir = switched_run[0]
    ckpt = [os.path.join(d, "checkpoint_2.msgpack")
            for d, _, files in os.walk(run_dir)
            if "checkpoint_2.msgpack" in files][0]
    _, seen = _recorded_run(monkeypatch, _cli_args(
        synth, str(tmp_path), start, ["--resume-from", ckpt]))
    if start == 2:  # at the switch: clusters from the first step
        assert seen == [(3, 4, True), (4, 4, True)]
    else:  # past the resume point: step 3 normal, the switch at 4
        assert seen == [(3, 8, False), (4, 4, True)]


def test_quality_campaign_sweep(synth, switched_run, tmp_path):
    out = str(tmp_path / "q.json")
    quality_campaign.main(quality_campaign.parser.parse_args([
        "--run-dir", switched_run[0], "--synth-root", synth, "--output", out,
        "--work-dir", str(tmp_path / "work"), "--families", "sweep",
        "--sweep-device", "cpu", "--retrieval-checkpoints", "1"]))
    result = json.load(open(out))
    assert sorted(result["checkpoints"]) == ["4"]
    entry = result["checkpoints"]["4"]
    assert 0 <= entry["retrieval"]["r_mean"] <= 100
    assert 0 <= entry["zero_shot"]["zero_shot_top1"] <= 100
    assert sorted(result["val_loss"]) == ["2", "4"]
    assert sorted(result["seconds"]) == ["retrieval_4", "zero_shot_4"]
    assert "failures" not in result and result["final"] == {}


def test_quality_protocol_stages_and_band(tmp_path, monkeypatch):
    """The protocol's ``data`` and ``seed0`` stages at a tiny size on the
    CPU (its constants shrunk), then a ``clusters`` stage that cannot find
    its checkpoint: the JSON after each call, and the exit codes."""
    reference = tmp_path / "reference.json"
    band = {"mean": 50.0, "std": 25.0}
    reference.write_text(json.dumps({"spread": {
        step: {"retrieval_r_mean": band, "zero_shot_top1": band}
        for step in ("2", "4")}}))  # "4": a step the run does not reach
    tiny = {"SYNTH": ["--seed", "0", "--train-n", 16, "--val-n", 8,
                      "--zeroshot-per-class", 1, "--probe-train-per-class", 0,
                      "--voc-trainval", 0, "--voc-test", 0, "--gender-n", 0,
                      "--image-size", 48],
            "PROTOCOL": CLI_TINY + ["DATA.IMAGE_CROP_SIZE", 32,
                                    "DATA.CACHE_IMAGE_SIZE", 40],
            "ITERATIONS": 2, "CHECKPOINT_EVERY": 2, "LOG_EVERY": 1,
            "CLUSTER_START": 1, "DEVICE": "cpu",
            "REFERENCE": str(reference)}
    for name, value in tiny.items():
        monkeypatch.setattr(quality_protocol, name, value)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the CLIs' processes
    monkeypatch.chdir(ROOT)
    output = str(tmp_path / "q.json")

    def protocol(stages):
        return quality_protocol.main(quality_protocol.parser.parse_args([
            "--work-dir", str(tmp_path / "work"), "--output", output,
            "--stages", stages]))

    assert protocol("data,seed0") == 0
    result = json.load(open(output))
    assert sorted(result["stages"]) == ["data", "seed0"]
    assert "failures" not in result
    seed0 = result["stages"]["seed0"]
    assert seed0["rc"] == 0 and not seed0["cut"]
    assert seed0["step_time"]["readings"] >= 1
    assert sorted(seed0["metrics"]["val"]) == ["2"]
    checkpoints = seed0["campaign"]["checkpoints"]
    assert sorted(checkpoints) == ["2"]
    assert sorted(result["jax_band"]["seed0"]) == ["2"]
    for step, entry in checkpoints.items():
        got = result["jax_band"]["seed0"][step]
        want = {"retrieval_r_mean": entry["retrieval"]["r_mean"],
                "zero_shot_top1": entry["zero_shot"]["zero_shot_top1"]}
        for metric, value in want.items():
            assert got[metric] == {"value": value, "band": [0.0, 100.0],
                                   "within": 0 <= value <= 100}

    assert protocol("clusters") == 1
    result = json.load(open(output))
    assert "checkpoint_1" in result["failures"]["clusters"]
    assert sorted(result["stages"]) == ["data", "seed0"]
