"""The glove and precomputed-sbert text modes against the JAX package on
the CPU: ``GloveTokenizer`` and its factory, ``generate_word_dict`` (the
JSON byte for byte), the datasets' glove and sbert items over CLRec
records and the random dataset, the loader's batches of them, the glove
and sbert towers (the frozen table's zero gradient, the optional
transform MLP), the GloVe helpers, ``EncoderBundle``'s text input in both
modes, and the glove model's checkpoint round trip in the JAX format.

Bars: ids, tokens and files exact; images within one level of the
normalized scale (OpenCV against the port's stand-ins, as
``tests/test_torch_data_pipeline.py``); towers and embeddings 1e-5
relative (fp32); checkpoints leaf for leaf.  The two glove training steps
against JAX's are ``tests/test_torch_vgg.py``'s (with ``vgg11``)."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

import jax

from clip_lite_tpu import engine as jengine
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.data import datasets as jdatasets
from clip_lite_tpu.data import tokenizers as jtokenizers
from clip_lite_tpu.eval_utils import EncoderBundle as JEncoderBundle
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import PretrainingModelFactory as JFactory
from clip_lite_tpu.models import text_encoder as jtext_encoder
from clip_lite_tpu.scripts import generate_word_dict as jgenerate_word_dict
from clip_lite_tpu.utils import checkpointing as jckpt
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.data import datasets, pipeline
from clip_lite_torch.data import transforms as T
from clip_lite_torch.data.readers import ClRecWriter
from clip_lite_torch.data.tokenizers import GloveTokenizer
from clip_lite_torch.engine import create_train_state, to_jax_tree
from clip_lite_torch.eval_utils import EncoderBundle
from clip_lite_torch.factories import PretrainingDatasetFactory, TokenizerFactory
from clip_lite_torch.models import text_encoder
from clip_lite_torch.scripts import generate_word_dict
from clip_lite_torch.utils.checkpointing import CheckpointManager
from test_torch_checkpointing import _assert_trees_identical, _state_dict_of
from test_torch_data_pipeline import LEVEL, WORDS
from test_torch_vgg import GLOVE_DIM, GLOVE_VOCAB, small_glove
from torch_matrix import FLAGSHIP, rel, seeded_variables
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

L, N = 12, 8


def _captions(rng, n=5):
    return [" ".join(rng.choice(list(WORDS) + ["zebra's", "Left", "UFO"],
                                rng.integers(3, 16))) for _ in range(n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """COCO caption annotations (train, val), a GloVe text file holding
    some of their words, a word dictionary, and CLRec records in the glove
    and sbert modes (five 768-d encodings a record, one record without)."""
    root = tmp_path_factory.mktemp("text_modes")
    rng = np.random.default_rng(0)
    os.makedirs(root / "annotations")
    for split in ("train", "val"):
        anns = [{"image_id": i, "id": 10 * i + j, "caption": c}
                for i in range(20) for j, c in enumerate(_captions(rng))]
        with open(root / "annotations" / f"captions_{split}2017.json", "w") as f:
            json.dump({"annotations": anns}, f)
    with open(root / "glove.txt", "w") as f:
        for w in list(WORDS[::2]) + ["zebra's"]:
            f.write(w + " " + " ".join(f"{v:.4f}" for v in rng.normal(size=6))
                    + "\n")
    word_dict = generate_word_dict.main(argparse.Namespace(
        coco_root=str(root), splits=["train"], glove_path=None, min_count=1,
        output=str(root / "word_dict.json")))
    for mode in ("glove", "sbert"):
        with ClRecWriter(str(root / f"coco_train_{mode}2017.clrec")) as w:
            for i in range(N):
                rec = {"image_id": i, "captions": _captions(rng),
                       "image": rng.integers(0, 256, (48 + 8 * (i % 2), 40, 3),
                                             dtype=np.uint8)}
                if mode == "sbert" and i != N - 1:
                    rec["caption_encodings"] = rng.standard_normal(
                        (5, 768)).astype(np.float32)
                w.append(rec)
    return dict(root=str(root), word_dict=word_dict,
                word_dict_path=str(root / "word_dict.json"),
                glove=str(root / "glove.txt"))


def test_glove_tokenizer_matches_jax(files):
    theirs = jtokenizers.GloveTokenizer(files["word_dict_path"])
    ours = GloveTokenizer(files["word_dict_path"])
    assert ours.word_dict == theirs.word_dict and len(ours) == len(theirs)
    rng = np.random.default_rng(1)
    for caption in _captions(rng, 20) + ["an unseen zyzzyva, LEFT!"]:
        assert ours.encode(caption) == theirs.encode(caption)
        assert ours.decode(ours.encode(caption)) == \
            theirs.decode(theirs.encode(caption))
    assert ours.pad_id == theirs.pad_id == 0
    # The specials appended, in order, where a dictionary lacks them.
    partial = {"dog": 0, "<eos>": 1}
    ours = GloveTokenizer(word_dict=dict(partial))
    theirs = jtokenizers.GloveTokenizer(word_dict=dict(partial))
    assert ours.word_dict == theirs.word_dict == {
        "dog": 0, "<eos>": 1, "<start>": 2, "<unk>": 3, "<pad>": 4}
    assert ours.encode("dog cat") == theirs.encode("dog cat") == [0, 3]
    cfg = Config(FLAGSHIP, ["MODEL.TEXTUAL.NAME", "glove",
                            "MODEL.TEXTUAL.WORD_DICT_PATH",
                            files["word_dict_path"]])
    tok = TokenizerFactory.from_config(cfg)
    assert isinstance(tok, GloveTokenizer)
    assert tok.word_dict == files["word_dict"]


@pytest.mark.parametrize("glove,min_count,splits", [
    (False, 1, ["train", "val"]), (True, 1, ["train", "val"]),
    (True, 3, ["val"])], ids=["all-words", "glove-filter", "min-count"])
def test_generate_word_dict_matches_jax(files, tmp_path, glove, min_count,
                                        splits):
    args = dict(coco_root=files["root"], splits=splits,
                glove_path=files["glove"] if glove else None,
                min_count=min_count)
    ours = generate_word_dict.main(argparse.Namespace(
        **args, output=str(tmp_path / "ours" / "word_dict.json")))
    theirs = jgenerate_word_dict.main(argparse.Namespace(
        **args, output=str(tmp_path / "theirs.json")))
    assert ours == theirs
    assert list(ours)[:4] == ["<pad>", "<start>", "<eos>", "<unk>"]
    with open(tmp_path / "ours" / "word_dict.json", "rb") as a, \
            open(tmp_path / "theirs.json", "rb") as b:
        assert a.read() == b.read()
    if glove:
        kept = set(ours) - {"<pad>", "<start>", "<eos>", "<unk>"}
        assert "zebra's" in kept and kept <= set(WORDS[::2]) | {"zebra's"}


def _kwargs(files, mode, **extra):
    return dict(data_root=files["root"], split="train", mode=mode,
                max_caption_length=L, word_dict_path=files["word_dict_path"],
                **extra)


def _same_items(ours, theirs, keys):
    assert set(ours) == set(theirs) == set(keys) | {"image_id", "image"}
    for k in keys + ("image_id",):
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert np.abs(ours["image"].astype(np.float64) - theirs["image"]).max() \
        <= LEVEL


GLOVE_KEYS = ("caption_tokens", "noitpac_tokens", "caption_lengths")


@pytest.mark.parametrize("textual_ssl", [False, True])
def test_glove_items_match_jax(files, textual_ssl):
    """Records and the random dataset, in two epochs: the caption draw,
    ``<start>`` ids ``<eos>`` cut to L and padded with ``<pad>``, the
    reversed ids and the length; the SSL caption draws (which the glove
    mode makes and drops, as JAX does) keep the streams aligned."""
    kw = dict(image_transform=T.DEFAULT_IMAGE_TRANSFORM,
              textual_self_supervised=textual_ssl)
    for cls, jcls in ((datasets.CocoCaptionsDataset,
                       jdatasets.CocoCaptionsDataset),
                      (datasets.RandomDataset, jdatasets.RandomDataset)):
        ours = cls(**_kwargs(files, "glove", **kw))
        theirs = jcls(**_kwargs(files, "glove", **kw))
        for epoch in (0, 1):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            for i in range(4):
                _same_items(ours[i], theirs[i], GLOVE_KEYS)
    item = ours[0]
    n = int(item["caption_lengths"])
    assert item["caption_tokens"][0] == 1 and item["caption_tokens"][n - 1] == 2
    np.testing.assert_array_equal(item["noitpac_tokens"][:n],
                                  item["caption_tokens"][:n][::-1])
    assert ours.caption_max_token_lengths() is None


def test_sbert_items_match_jax(files):
    """One of a record's five encodings drawn as JAX draws it, the random
    dataset's N(0, 1) vector; a record without encodings raises in both."""
    for cls, jcls in ((datasets.CocoCaptionsDataset,
                       jdatasets.CocoCaptionsDataset),
                      (datasets.RandomDataset, jdatasets.RandomDataset)):
        ours, theirs = cls(**_kwargs(files, "sbert")), \
            jcls(**_kwargs(files, "sbert"))
        for i in range(N - 1):
            _same_items(ours[i], theirs[i], ("caption_encodings",))
    records = datasets.CocoCaptionsDataset(**_kwargs(files, "sbert"))
    with pytest.raises(ValueError, match="caption_encodings"):
        records[N - 1]
    with pytest.raises(ValueError, match="caption_encodings"):
        jdatasets.CocoCaptionsDataset(**_kwargs(files, "sbert"))[N - 1]


def test_loader_batches_carry_the_mode_keys(files):
    """The factory (which hands the glove datasets MODEL.TEXTUAL.
    WORD_DICT_PATH) and the host loader give the step glove and sbert
    batches; bucketing leaves them as they are."""
    common = ["MODEL.NAME", "captions", "DATA.ROOT", files["root"],
              "DATA.IMAGE_CROP_SIZE", 32, "DATA.MAX_CAPTION_LENGTH", L,
              "DATA.SEQ_BUCKETS", [8], "MODEL.TEXTUAL.WORD_DICT_PATH",
              files["word_dict_path"]]
    for mode, keys in (("glove", GLOVE_KEYS), ("sbert", ("caption_encodings",))):
        cfg = Config(FLAGSHIP, common + ["DATA.NAME", mode,
                                         "MODEL.TEXTUAL.NAME", mode])
        ds = PretrainingDatasetFactory.from_config(cfg, "train", device="cpu")
        if mode == "sbert":
            ds.reader._indices = ds.reader._indices[:N - 1]
        loader = pipeline.DataLoader(ds, 3, shuffle=True, seed=1,
                                     drop_last=True, background=False)
        batches = list(loader)
        assert len(batches) == (N - (mode == "sbert")) // 3
        for batch in batches:
            assert set(batch) == {"image_id", "image", *keys}
            assert tuple(batch["image"].shape) == (3, 32, 32, 3)
        if mode == "glove":
            assert batches[0]["caption_tokens"].shape == (3, L)
            assert int(batches[0]["caption_tokens"].max()) > 3  # real words
        else:
            assert batches[0]["caption_encodings"].shape == (3, 768)


@pytest.mark.parametrize("mode,transform,train_embeddings", [
    ("glove", False, False), ("glove", True, False), ("glove", False, True),
    ("sbert", False, False), ("sbert", True, False)])
def test_tower_matches_jax(mode, transform, train_embeddings):
    """The tower's output and, through a seeded gradient of it, every
    parameter's gradient: the frozen table's is zero in both."""
    kw = dict(mode=mode, transform_embedding=transform, txt_enc_dim=32,
              train_embeddings=train_embeddings)
    if mode == "glove":
        kw.update(glove_vocab_size=GLOVE_VOCAB, glove_dim=GLOVE_DIM)
    jm = jtext_encoder.TextEncoder(**kw)
    rng = np.random.default_rng(2)
    batch = ({"caption_tokens": rng.integers(0, GLOVE_VOCAB, (4, L)).astype(
        np.int32)} if mode == "glove" else
        {"caption_encodings": rng.standard_normal((4, 768), np.float32)})
    v = seeded_variables(jm, batch, train=False)
    out = np.asarray(jm.apply(v, batch, train=True))
    up = rng.standard_normal(out.shape, np.float32)
    grads = jax.tree.map(np.asarray, jax.grad(lambda p: (jm.apply(
        {"params": p}, batch, train=True) * up).sum())(v["params"]))
    pm = text_encoder.TextEncoder(**kw)
    pm.load_state_dict(bridge.convert(v, pm))
    assert pm.feature_size == jm.feature_size
    got = pm.train()({k: torch.from_numpy(a) for k, a in batch.items()})
    assert rel(got.detach(), out) < 1e-5
    if not got.requires_grad:  # nothing of the tower trains
        assert not transform and not train_embeddings
        assert not any(a.any() for a in jax.tree.leaves(grads))
        return
    (got * torch.from_numpy(up)).sum().backward()
    want = bridge.convert({"params": grads}, pm)
    for name, p in pm.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if name == "embedding.weight" and not train_embeddings:
            assert p.grad is None and not np.asarray(want[name]).any()
            continue
        assert rel(g, want[name]) < 1e-5, name


def test_glove_helpers_match_jax(files, tmp_path):
    word_dict = text_encoder.load_word_dict(files["word_dict_path"])
    assert word_dict == jtext_encoder.load_word_dict(files["word_dict_path"])
    ours = text_encoder.load_glove_matrix(files["glove"], word_dict, seed=3)
    theirs = jtext_encoder.load_glove_matrix(files["glove"], word_dict, seed=3)
    np.testing.assert_array_equal(ours, theirs)
    enc = text_encoder.TextEncoder(mode="glove", glove_vocab_size=len(word_dict),
                                   glove_dim=6)
    sd = text_encoder.glove_text_encoder_params(enc.state_dict(), ours)
    np.testing.assert_array_equal(sd["embedding.weight"].numpy(), ours)
    with pytest.raises(ValueError):
        text_encoder.glove_text_encoder_params(enc.state_dict(), ours[:-1])


TINY = ["AMP", False, "MODEL.VISUAL.NETWORK_NAME", "resnet18",
        "MODEL.VISUAL.WIDTH", 8, "DATA.IMAGE_CROP_SIZE", 32,
        "DATA.MAX_CAPTION_LENGTH", L]


@pytest.mark.parametrize("mode", ["glove", "sbert"])
def test_encoder_bundle_text_input_matches_jax(files, tmp_path, mode):
    """The bundle's text path per mode, projected and normalized, both
    bundles from one JAX model snapshot of seeded weights: glove captions
    through the word dictionary (``encode_texts``, as JAX's bundle pads
    them), sbert vectors (``encode_caption_encodings``) against the JAX
    model's ``encode_text`` and ``project_text``."""
    over = TINY + ["MODEL.TEXTUAL.NAME", mode,
                   "MODEL.TEXTUAL.WORD_DICT_PATH", files["word_dict_path"]]
    with pytest.MonkeyPatch.context() as mp:
        small_glove(mp)
        jcfg = JConfig(FLAGSHIP, over)
        model = JFactory.from_config(jcfg)
        sample = {"image": np.zeros((1, 32, 32, 3), np.float32)}
        sample.update({"caption_tokens": np.zeros((1, L), np.int32)}
                      if mode == "glove" else
                      {"caption_encodings": np.zeros((1, 768), np.float32)})
        v = seeded_variables(model, sample, train=False)
        snapshot = jckpt.CheckpointManager(str(tmp_path), state=jengine.TrainState(
            step=np.asarray(1, np.int32), params=v["params"],
            batch_stats=v["batch_stats"], opt_state=())).climax_step(1)
        jb = JEncoderBundle(jcfg, snapshot, batch_size=4)
        cfg = Config(FLAGSHIP, over)
        ours = EncoderBundle(cfg, snapshot, batch_size=4, device="cpu")
    if mode == "glove":
        tok = TokenizerFactory.from_config(cfg)
        texts = _captions(np.random.default_rng(4), 6)
        got = ours.encode_texts(texts, tok)
        want = jb.encode_texts(texts, jtokenizers.GloveTokenizer(
            files["word_dict_path"]))
    else:
        vectors = np.random.default_rng(4).standard_normal((6, 768), np.float32)
        got = ours.encode_caption_encodings(vectors)

        @jax.jit
        def encode(variables, x):
            from clip_lite_tpu.ops.layers import l2_normalize

            feats = model.apply(variables, {"caption_encodings": x},
                                method=model.encode_text)
            return l2_normalize(model.apply(variables, feats,
                                            method=model.project_text))

        want = np.asarray(encode(v, vectors))
        with pytest.raises(ValueError, match="SentenceTransformer"):
            ours.encode_texts(["a dog"], None)
    assert got.shape == want.shape
    assert rel(got, want) < 1e-5


def test_glove_checkpoint_round_trip(tmp_path):
    """A glove model's training state (the table, its momentum and slow
    weights included) written by the port loads in the JAX package's
    CheckpointManager leaf for leaf; the JAX package's checkpoint of other
    weights and momenta resumes in the port leaf for leaf, and its model
    snapshot loads in the port's ``EncoderBundle``."""
    over = TINY + ["MODEL.TEXTUAL.NAME", "glove"]
    with pytest.MonkeyPatch.context() as mp:
        small_glove(mp)
        cfg = Config(FLAGSHIP, over)
        state = create_train_state(cfg, device="cpu")
        jcfg = JConfig(FLAGSHIP, over)
        model, tx = JFactory.from_config(jcfg), JOptimizerFactory.from_config(jcfg)
        sample = {"image": np.zeros((1, 32, 32, 3), np.float32),
                  "caption_tokens": np.zeros((1, L), np.int32)}
        v = seeded_variables(model, sample, train=False)
    assert v["params"]["text_encoder"]["embedding"]["embedding"].shape == \
        (GLOVE_VOCAB, GLOVE_DIM)
    target = jengine.TrainState(step=np.asarray(0, np.int32), params=v["params"],
                                batch_stats=v["batch_stats"],
                                opt_state=tx.init(v["params"]))
    with torch.no_grad():
        for p in state.optimizer.groups[0].trace:
            p.normal_()
    path = CheckpointManager(str(tmp_path / "port"), state=state).step(3)
    manager = jckpt.CheckpointManager(str(tmp_path / "jax"), state=target)
    assert manager.load(path) == 3
    want = jax.tree.map(lambda t: bridge.to_numpy(t) if isinstance(
        t, torch.Tensor) else t, to_jax_tree(state))
    _assert_trees_identical(_state_dict_of(manager.restored("state")), want)
    # The JAX package's full checkpoint of other weights and momenta, and
    # its model snapshot, in the port.
    target = target.replace(step=np.asarray(4, np.int32),
                            opt_state=target.opt_state._replace(
                                trace=jax.tree.map(lambda p: 0.5 * p,
                                                   v["params"])))
    jax_manager = jckpt.CheckpointManager(str(tmp_path / "jax"), state=target)
    full, snapshot = jax_manager.step(4), jax_manager.climax_step(4)
    with pytest.MonkeyPatch.context() as mp:
        small_glove(mp)
        resumed = create_train_state(cfg, device="cpu")
        assert CheckpointManager(str(tmp_path / "back"),
                                 state=resumed).load(full) == 4
        bundle = EncoderBundle(cfg, snapshot, batch_size=2, device="cpu")
    _assert_trees_identical(
        jax.tree.map(lambda t: bridge.to_numpy(t) if isinstance(
            t, torch.Tensor) else t, to_jax_tree(resumed)),
        _state_dict_of(target))
    got = bundle.model.state_dict()
    want = bridge.convert(v, bundle.model)
    for name in want:
        assert torch.equal(got[name], want[name]), name
