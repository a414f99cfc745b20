"""The port's training CLI (``python -m clip_lite_torch.train``, called as
``main(parser.parse_args([...]))``) on the CPU, at a tiny flagship
(ResNet-18 at width 8, one BERT layer of 64, crop 32) over a tiny CLRec
corpus written by the port's ClRecWriter.

* 4 iterations with ``--checkpoint-every 2`` write checkpoint_2,
  checkpoint_4, pretrain_config.yaml, the log and the metrics; the JAX
  package's ``peek_iteration`` and ``load_model_variables`` read the
  checkpoints, which hold the run's final weights.
* A run resumed from checkpoint_2 ends in the same state, bit for bit, as
  the uninterrupted run: through the host loader and through
  DATA.DEVICE_CACHE.  On the CPU every draw and every batch is a function
  of (seed, step).
* MODEL.NAME json trains from ALBEF-style json files over JPEG images.
* Each refusal raises and names its item of ROADMAP Queue 1 (the native
  path over ndarray records names the JPEG records it needs); without
  ``--device cpu`` and with no CUDA the CLI raises."""

import os

import numpy as np
import pytest
import torch

from clip_lite_tpu.utils import checkpointing as jckpt
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.train import main, parser
from test_torch_data_pipeline import write_corpus
from test_torch_downstream_data import write_json_pretraining

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
TUNED = os.path.join(ROOT, "configs", "fs_tpu_tuned.yaml")
TINY = ["MODEL.NAME", "captions", "AMP", False,
        "MODEL.VISUAL.NETWORK_NAME", "resnet18", "MODEL.VISUAL.WIDTH", 8,
        "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 1, "MODEL.TEXTUAL.HIDDEN_SIZE", 64,
        "MODEL.TEXTUAL.VOCAB_SIZE", 256, "DATA.MAX_CAPTION_LENGTH", 12,
        "DATA.IMAGE_CROP_SIZE", 32, "OPTIM.BATCH_SIZE", 4,
        "OPTIM.NUM_ITERATIONS", 4, "OPTIM.WARMUP_STEPS", 1,
        "OPTIM.LOOKAHEAD.STEPS", 3, "MODEL.TEXTUAL.DROPOUT", 0.1]
CACHE = ["DATA.DEVICE_CACHE", True, "DATA.NATIVE_PIPELINE", False,
         "DATA.CACHE_IMAGE_SIZE", 40]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("cli_corpus"), n_train=14,
                        n_val=5)


def _args(corpus, out, config=FLAGSHIP, extra=(), flags=()):
    return parser.parse_args([str(a) for a in (
        "--device", "cpu", "--config", config, "--serialization-dir", out,
        "--checkpoint-every", 2, "--log-every", 1, "--cpu-workers", 2,
        *flags, "--config-override", "DATA.ROOT", corpus, *TINY, *extra)])


def _ckpt_dir(args):
    return str(args.serialization_dir) + Config(
        args.config, list(args.config_override)).RUN_ID


def _state(state):
    out = {f"model.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}
    for attr in ("trace", "slow"):
        out.update({f"{attr}.{k}": v.clone()
                    for k, v in state.optimizer._by_name(attr).items()})
    return out


def _bit_equal(a, b):
    assert a.keys() == b.keys()
    return [k for k in a if not torch.equal(a[k], b[k])]


@pytest.mark.parametrize("path", ["loader", "cache"])
def test_cli_trains_checkpoints_and_resumes_bit_for_bit(corpus, tmp_path, path):
    extra = CACHE + ["DATA.SEQ_BUCKETS", [8, 12]] if path == "cache" else ()
    config = TUNED if path == "cache" else FLAGSHIP
    args = _args(corpus, tmp_path / "a", config, extra)
    state = main(args)
    ckpt = _ckpt_dir(args)
    assert state.step == 4
    files = set(os.listdir(ckpt))
    assert {"checkpoint_2.msgpack", "checkpoint_4.msgpack"} <= files
    for name in ("pretrain_config.yaml", "log_pretrain.txt", "metrics.jsonl"):
        assert os.path.getsize(tmp_path / "a" / name) > 0
    log = (tmp_path / "a" / "log_pretrain.txt").read_text()
    assert "VAL @ 2" in log and "VAL @ 4" in log and "Done: 4" in log
    if path == "cache":
        assert "Device-resident dataset cache: 14 items" in log

    # The JAX package reads the port CLI's checkpoints.
    last = os.path.join(ckpt, "checkpoint_4.msgpack")
    assert jckpt.peek_iteration(os.path.join(ckpt, "checkpoint_2.msgpack")) == 2
    assert jckpt.peek_iteration(last) == 4
    jvars = jckpt.load_model_variables(last)
    mine = bridge.to_jax_variables(state.model.state_dict(), state.model,
                                   lambda t: t.detach().numpy())
    for part in ("params", "batch_stats"):
        flat_j = dict(_leaves(jvars[part]))
        flat_m = dict(_leaves(mine[part]))
        assert flat_j.keys() == flat_m.keys()
        for k in flat_j:
            np.testing.assert_array_equal(np.asarray(flat_j[k]), flat_m[k])

    final = _state(state)
    del state
    resumed_args = _args(corpus, tmp_path / "b", config, extra,
                         ["--resume-from",
                          os.path.join(ckpt, "checkpoint_2.msgpack")])
    resumed = main(resumed_args)
    assert resumed.step == 4
    assert _bit_equal(_state(resumed), final) == []
    assert "Resumed from" in (tmp_path / "b" / "log_pretrain.txt").read_text()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


REFUSALS = {
    # The cluster curriculum runs (tests/test_torch_clusters.py), once
    # scripts/cluster.py has written its maps: this corpus has none.
    "clusters": (["DATA.NEGATIVE_SAMPLING", "clusters",
                  "DATA.NEGATIVE_SAMPLING_START_ITERATION", 1], (),
                 "cluster.py", FileNotFoundError),
    # Pretrained towers load (tests/test_torch_pretrained.py): a file that
    # is not there is named.
    "pretrained": (["MODEL.VISUAL.PRETRAINED", True,
                    "MODEL.VISUAL.PRETRAINED_PATH", "r50.npz"], (), "r50.npz",
                   FileNotFoundError),
    # Several steps a call run (tests/test_torch_steps_per_call.py), through
    # the host loader: the device cache refuses them, as the JAX CLI does.
    "steps_per_call": (["PARALLEL.STEPS_PER_CALL", 2] + CACHE, (),
                       "STEPS_PER_CALL > 1", ValueError),
    # The native path runs (tests/test_torch_native.py), on JPEG records
    # only: this corpus holds ndarray images.
    "native_pipeline": (["DATA.NATIVE_PIPELINE", True], (), "JPEG records",
                        TypeError),
    # The glove and sbert modes train through the host loader
    # (tests/test_torch_pretrained.py): the device cache holds token ids.
    "glove": (["DATA.NAME", "glove"] + CACHE, (), "host loader", ValueError),
    # SSL runs (tests/test_torch_ssl.py), but not on the native batch path
    # without the device cache: that path makes no augmented views.
    "ssl": (["MODEL.VISUAL.SELF_SUPERVISED", True, "DATA.NATIVE_PIPELINE",
             True], (), "no augmented views"),
    # Multi-GPU training runs one process a card
    # (tests/test_torch_distributed.py): --num-devices must be the world
    # size, --num-hosts needs a rendezvous, and the JAX package's virtual
    # CPU devices have no counterpart.
    "num_devices": ([], ("--num-devices", "2"), "world size", ValueError),
    "num_hosts": ([], ("--num-hosts", "2"), "coordinator-address",
                  ValueError),
    "virtual_devices": ([], ("--virtual-devices", "8"), "virtual CPU mesh"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_name_their_item(corpus, tmp_path, case):
    extra, flags, item, *error = REFUSALS[case]
    with pytest.raises(error[0] if error else NotImplementedError, match=item):
        main(_args(corpus, tmp_path, extra=extra, flags=flags))


def test_cli_trains_from_json_files(corpus, tmp_path):
    path = write_json_pretraining(str(tmp_path), n=8)
    args = _args(corpus, tmp_path / "a", extra=[
        "MODEL.NAME", "json", "DATA.JSON_FILES_TRAIN", [path],
        "DATA.JSON_FILES_VAL", [path], "OPTIM.NUM_ITERATIONS", 2])
    state = main(args)
    assert state.step == 2
    log = (tmp_path / "a" / "log_pretrain.txt").read_text()
    assert "VAL @ 2" in log and "Done: 2" in log
    assert os.path.exists(os.path.join(_ckpt_dir(args),
                                       "checkpoint_2.msgpack"))


JAX_REFUSALS = {
    "zero1_steps": ["PARALLEL.ZERO1", True, "PARALLEL.STEPS_PER_CALL", 2],
    "buckets_steps": ["DATA.SEQ_BUCKETS", [8], "PARALLEL.STEPS_PER_CALL", 2],
    "cache_clusters": CACHE + ["DATA.NEGATIVE_SAMPLING", "clusters"],
    "cache_text_ssl": CACHE + ["MODEL.TEXTUAL.SELF_SUPERVISED", True],
    "placement": CACHE + ["DATA.CACHE_PLACEMENT", "striped"],
}


@pytest.mark.parametrize("case", sorted(JAX_REFUSALS))
def test_jax_cli_refusals(corpus, tmp_path, case):
    with pytest.raises(ValueError):
        main(_args(corpus, tmp_path, extra=JAX_REFUSALS[case]))


def test_cuda_by_default(corpus, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(corpus, tmp_path)
    args.device = parser.get_default("device")
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args)
