"""The port's downstream eval CLIs (``python -m clip_lite_torch.{retrieval,
zero_shot,voc_clf,bias_eda,voc_det}``, called as ``main(parser.parse_args(
[...]))`` with ``--device cpu``) against the JAX package's on one JAX
checkpoint of a tiny flagship (ResNet-18 at width 8, two BERT layers of
64, fp32) and the synthetic JPEG trees of tests/test_torch_downstream_data.py:

* retrieval: the image and text embeddings within 1e-4 of JAX's, and
  ``itm_eval`` of the port's similarities gives JAX's recall JSON;
* zero-shot: the same top-1;
* bias_eda ``--prompt``: the bias scores within 1e-4, and the port reads
  the JAX run's cached feature pickles;
* voc_det: the Detectron2 pickle has JAX's keys and exactly its arrays;
* voc_clf: features within 1e-4, the mAP within 0.1 points of JAX's
  (sklearn there, the port's own SVM here); where a class's chosen cost
  differs, both CV APs are printed;
* every CLI runs on CUDA by default and raises without it;
* retrieval ``--weight-init clip`` on a tiny random CLIP directory gives
  the JAX CLI's JSON (transformers' Flax CLIP there, the port's towers
  and tokenizer here), recalls exactly.
"""

import json
import logging
import os
import pickle
import shutil

import jax
import numpy as np
import pytest
import torch

import clip_lite_tpu.bias_eda as jbias
import clip_lite_tpu.retrieval as jretrieval
import clip_lite_tpu.voc_clf as jvoc_clf
import clip_lite_tpu.voc_det as jvoc_det
import clip_lite_tpu.zero_shot as jzero_shot
import clip_lite_torch.bias_eda as bias
import clip_lite_torch.linear_clf as linear_clf
import clip_lite_torch.retrieval as retrieval
import clip_lite_torch.voc_clf as voc_clf
import clip_lite_torch.voc_det as voc_det
import clip_lite_torch.zero_shot as zero_shot
from clip_lite_tpu import engine as jengine
from clip_lite_tpu import eval_utils as jeval_utils
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_tpu.utils import checkpointing as jckpt
from clip_lite_torch import eval_utils
from test_torch_clip import VISION_257, VISION_577, write_clip_dir
from test_torch_downstream_data import (
    CROP,
    write_coco,
    write_gender,
    write_imagenet,
    write_voc,
)
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
# The JAX package's TokenizerFactory gives the hashing tokenizer a vocab of
# 30522 whatever the config, the port's MODEL.TEXTUAL.VOCAB_SIZE: at 30522
# the two give the same ids.
PRETRAIN = ["AMP", False, "MODEL.VISUAL.NETWORK_NAME", "resnet18",
            "MODEL.VISUAL.WIDTH", 8, "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 2,
            "MODEL.TEXTUAL.HIDDEN_SIZE", 64, "MODEL.TEXTUAL.VOCAB_SIZE", 30522,
            "DATA.MAX_CAPTION_LENGTH", 12, "DATA.IMAGE_CROP_SIZE", CROP]
TOL = 1e-4


def jax_checkpoint(path_dir, overrides=PRETRAIN):
    """A JAX TrainState of the tiny flagship (threefry init) with seeded
    BatchNorm statistics, written by the JAX CheckpointManager; returns
    the checkpoint's path."""
    jcfg = JConfig(FLAGSHIP, [str(v) for v in overrides])
    model = JModelFactory.from_config(jcfg)
    tx = JOptimizerFactory.from_config(jcfg)
    length = jcfg.DATA.MAX_CAPTION_LENGTH
    sample = {"image": np.zeros((1, CROP, CROP, 3), np.float32),
              "input_ids": np.zeros((1, length), np.int32),
              "attention_mask": np.ones((1, length), np.int32)}
    with jax.default_prng_impl("threefry2x32"):
        state = jax.jit(lambda b: jengine.create_train_state(
            model, tx, b, seed=0))(sample)
    rng = np.random.RandomState(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, v: np.asarray(
            rng.uniform(0.5, 1.5, v.shape) if path[-1].key == "var"
            else 0.1 * rng.randn(*v.shape), np.float32), state.batch_stats)
    return jckpt.CheckpointManager(str(path_dir), state=state.replace(
        batch_stats=stats)).step(1)


@pytest.fixture(autouse=True)
def keep_prng_impl():
    """The JAX CLIs switch the default PRNG to RNG_IMPL (rbg); later tests
    in the worker keep theirs."""
    impl = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", impl)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_trees"))
    with jax.default_prng_impl("threefry2x32"):
        ckpt = jax_checkpoint(tmp_path_factory.mktemp("ckpt"))
    return dict(ckpt=ckpt, coco=write_coco(root, n=8),
                imagenet=write_imagenet(root), voc=write_voc(root),
                gender=write_gender(root, n=10))


def _argv(setup, tmp_path, data_root, *extra, batch=4, ckpt=True, jax_run=False,
          crop=CROP):
    argv = ["--serialization-dir", str(tmp_path / ("jax" if jax_run else "port")),
            "--cpu-workers", 2, "--pretrain-config", FLAGSHIP,
            "--pretrain-config-override", *PRETRAIN]
    if ckpt:
        argv += ["--checkpoint-path", setup["ckpt"]]
    if batch:
        argv += ["--batch-size", batch]
    argv += [*extra, "--config-override", "DATA.ROOT", data_root,
             "DATA.IMAGE_CROP_SIZE", crop]
    if not jax_run:
        argv += ["--device", "cpu"]
    return [str(a) for a in argv]


def _run_both(module, jmodule, setup, tmp_path, data_root, *extra, **kw):
    theirs = jmodule.main(jmodule.parser.parse_args(
        _argv(setup, tmp_path, data_root, *extra, jax_run=True, **kw)))
    ours = module.main(module.parser.parse_args(
        _argv(setup, tmp_path, data_root, *extra, **kw)))
    return ours, theirs


def _record(monkeypatch, cls, name, store):
    real = getattr(cls, name)

    def wrapper(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        store.setdefault(name, []).append(np.asarray(out))
        return out

    monkeypatch.setattr(cls, name, wrapper)


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_retrieval_matches_jax(setup, tmp_path, monkeypatch, capsys):
    ours_emb, jax_emb = {}, {}
    for cls, store in ((eval_utils.EncoderBundle, ours_emb),
                       (jeval_utils.EncoderBundle, jax_emb)):
        for name in ("encode_texts", "encode_image_batches"):
            _record(monkeypatch, cls, name, store)
    ours, theirs = _run_both(retrieval, jretrieval, setup, tmp_path,
                             setup["coco"])
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == ours
    for name in ("encode_texts", "encode_image_batches"):
        _close(ours_emb[name][0], jax_emb[name][0])
    images, texts = ours_emb["encode_image_batches"][0], \
        ours_emb["encode_texts"][0]
    assert images.shape == (8, 2048) and texts.shape == (21, 2048)
    sims = images @ texts.T
    dataset = retrieval.DownstreamDatasetFactory.from_config(
        retrieval.Config(None, ["DATA.ROOT", setup["coco"],
                                "DATA.IMAGE_CROP_SIZE", CROP]), split="val")
    assert eval_utils.itm_eval(sims, sims.T, dataset.txt2img,
                               dataset.img2txt) == theirs == ours


def test_zero_shot_matches_jax(setup, tmp_path, capsys):
    ours, theirs = _run_both(zero_shot, jzero_shot, setup, tmp_path,
                             setup["imagenet"])
    assert ours == theirs
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        {"zero_shot_top1": theirs}


def test_bias_eda_prompt_matches_jax(setup, tmp_path, capsys):
    cache = str(tmp_path / "cache")
    prompt = ["--prompt", "a photo of a doctor"]
    theirs = jbias.main(jbias.parser.parse_args(_argv(
        setup, tmp_path, setup["gender"], *prompt, "--cache-dir", cache,
        jax_run=True)))
    ours = bias.main(bias.parser.parse_args(_argv(
        setup, tmp_path, setup["gender"], *prompt)))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {k: v for k, v in ours.items()
                       if not k.startswith("top_")}
    assert ours.keys() == theirs.keys()
    for k, v in theirs.items():
        if isinstance(v, float):
            assert abs(ours[k] - v) <= TOL, k
    assert ours["prompt"] == theirs["prompt"]
    # The JAX run's cached features, read by the port.
    cached = bias.main(bias.parser.parse_args(_argv(
        setup, tmp_path, setup["gender"], *prompt, "--cache-dir", cache)))
    for k in ("men_mean_sim", "women_mean_sim", "bias_gap"):
        assert abs(cached[k] - theirs[k]) <= TOL, k
    assert cached["top_men"] == theirs["top_men"]
    with open(os.path.join(cache, "men_data_val.pkl"), "rb") as f:
        assert sorted(pickle.load(f)) == [301, 303, 305, 307, 309]


def test_voc_det_export_matches_jax(setup, tmp_path):
    paths = {}
    for name, module in (("port", voc_det), ("jax", jvoc_det)):
        paths[name] = str(tmp_path / f"{name}.pkl")
        module.main(module.parser.parse_args(_argv(
            setup, tmp_path, "unused", "--output", paths[name], batch=0,
            jax_run=name == "jax")))
    with open(paths["port"], "rb") as f:
        ours = pickle.load(f)
    with open(paths["jax"], "rb") as f:
        theirs = pickle.load(f)
    assert ours.keys() == theirs.keys()
    assert ours["matching_heuristics"] is theirs["matching_heuristics"] is True
    assert list(ours["model"]) == list(theirs["model"])
    assert len(ours["model"]) == 5 * (1 + 16 + 3)  # stem, 8 blocks x 2, 3 projections
    for k, v in theirs["model"].items():
        assert ours["model"][k].dtype == np.float32, k
        np.testing.assert_array_equal(ours["model"][k], v, err_msg=k)


def test_voc_clf_matches_jax(setup, tmp_path, monkeypatch, capsys):
    feats = {"port": [], "jax": []}
    logs = {"port": [], "jax": []}

    class Recorder:
        def __init__(self, lines, real):
            self.lines, self.real = lines, real

        def info(self, msg, *args):
            self.lines.append(msg % args)
            self.real.info(msg, *args)

    for name, module in (("port", voc_clf), ("jax", jvoc_clf)):
        real_extract, real_svm = module.extract_features, module.svm_map

        def extract(*a, _real=real_extract, _out=feats[name], **kw):
            out = _real(*a, **kw)
            _out.append(out)
            return out

        def svm_map(*a, _real=real_svm, _lines=logs[name], **kw):
            a = list(a)
            a[6] = Recorder(_lines, a[6])
            return _real(*a, **kw)

        monkeypatch.setattr(module, "extract_features", extract)
        monkeypatch.setattr(module, "svm_map", svm_map)
    ours, theirs = _run_both(voc_clf, jvoc_clf, setup, tmp_path, setup["voc"])
    assert list(ours) == list(theirs) == [setup["ckpt"]]
    for (f, lab), (jf, jlab) in zip(feats["port"], feats["jax"]):
        _close(f, jf)
        np.testing.assert_array_equal(lab, jlab)
    assert feats["port"][0][0].shape == (24, 64)  # ResNet-18 at width 8
    chosen = {}
    for name in ("port", "jax"):
        chosen[name] = [line.split(", test AP")[0] for line in logs[name]
                        if line.startswith("class ")]
    for a, b in zip(chosen["port"], chosen["jax"]):
        if a.split(", CV AP")[0] != b.split(", CV AP")[0]:
            print(f"chosen cost differs: port {a}; JAX {b}")
    m, jm = ours[setup["ckpt"]], theirs[setup["ckpt"]]
    assert abs(m - jm) <= 0.1, (m, jm)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ours
    with open(tmp_path / "port" / "voc07_mAP.txt") as f:
        assert f.read().startswith(setup["ckpt"] + "\t")


CLIS = {"retrieval": retrieval, "zero_shot": zero_shot, "voc_clf": voc_clf,
        "bias_eda": bias, "voc_det": voc_det, "linear_clf": linear_clf}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cuda_by_default(setup, tmp_path, monkeypatch, name):
    module = CLIS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = ["--output", str(tmp_path / "x.pkl")] if name == "voc_det" else []
    args = module.parser.parse_args(_argv(
        setup, tmp_path, setup["coco"], *extra,
        batch=0 if name in ("voc_det", "linear_clf") else 4))
    args.device = module.parser.get_default("device")
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(args)


def test_svm_map_fits_where_its_caller_says(monkeypatch):
    """svm_map has no default device: called as the JAX package's is, it
    raises, and asked for CUDA without a card it raises as the CLIs do."""
    x = np.eye(4)
    labels = np.array([[1], [0], [1], [0]])
    logger = logging.getLogger("test")
    with pytest.raises(TypeError, match="device"):
        voc_clf.svm_map(x, labels, x, labels, [1.0], 2, logger)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        voc_clf.svm_map(x, labels, x, labels, [1.0], 2, logger, "cuda")
    got = voc_clf.svm_map(x, labels, x, labels, [1.0], 2, logger, "cpu")
    assert got == 100.0


@pytest.mark.parametrize("vision", [VISION_257, VISION_577],
                         ids=["vision_s257", "vision_s577"])
def test_clip_weight_init_past_256_tokens(setup, tmp_path, capsys, monkeypatch,
                                          vision):
    """``--weight-init clip`` on tiny random CLIP directories whose vision
    tower has ViT-L/14's 257 and ViT-L/14-336's 577 tokens (64 and 96 px
    crops of 4 px patches, ``DATA.IMAGE_CROP_SIZE`` at the image size):
    the port's CLI runs end to end and its image and text embeddings equal
    the JAX CLI's (transformers' FlaxCLIPModel) at TOL.  Their recalls are
    not compared: at these widths a random tower maps every image within
    1e-3 of one point, so captions tie between images at fp32's rounding
    and the order of a tie decides a recall."""
    clip_dir = write_clip_dir(str(tmp_path / "clip"), vision=vision)
    embeds = {}
    for name, module in (("port", retrieval), ("jax", jretrieval)):
        for method in ("encode_texts", "encode_image_batches"):
            _record(monkeypatch, module.ClipComparisonBundle, method,
                    embeds.setdefault(name, {}))
    ours, theirs = _run_both(retrieval, jretrieval, setup, tmp_path,
                             setup["coco"], "--weight-init", "clip",
                             "--checkpoint-path", clip_dir, ckpt=False,
                             crop=vision["image_size"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ours
    assert ours.keys() == theirs.keys()
    assert all(0.0 <= v <= 100.0 for v in ours.values())
    for method in ("encode_texts", "encode_image_batches"):
        (got,), (want,) = embeds["port"][method], embeds["jax"][method]
        _close(got, want)


def test_clip_weight_init_raises_naming_its_item(setup, tmp_path, capsys):
    """``--weight-init clip`` on a tiny random CLIP directory
    (tests/test_torch_clip.py's, 32 px images): the port's JSON is the JAX
    CLI's (transformers' FlaxCLIPModel and CLIPTokenizerFast), recalls
    exactly; a directory without Flax weights raises, naming the files."""
    clip_dir = write_clip_dir(str(tmp_path / "clip"))
    flags = ("--weight-init", "clip", "--checkpoint-path", clip_dir)
    ours, theirs = _run_both(retrieval, jretrieval, setup, tmp_path,
                             setup["coco"], *flags, ckpt=False)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == ours == theirs
    bare = tmp_path / "config_only"
    bare.mkdir()
    shutil.copy(os.path.join(clip_dir, "config.json"), bare)
    args = retrieval.parser.parse_args(_argv(
        setup, tmp_path, setup["coco"], "--weight-init", "clip",
        "--checkpoint-path", str(bare), ckpt=False))
    with pytest.raises(FileNotFoundError, match="flax_model.msgpack"):
        retrieval.main(args)
