"""The inference slice as a whole: the flagship config cut to a tiny size
goes through the JAX package's EncoderBundle and the port's, with the same
weights (a JAX checkpoint for one, bridged for the other), and retrieval
scoring on top.  Also: the port's own copies (config, tokenizer, recalls)
agree with the JAX package's, and the port imports nothing of JAX.

Bar: 1e-4 on the projected, normalized embeddings (fp32, AMP off)."""

import ast
import glob
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax import serialization

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.data.tokenizers import HashingTokenizer as JTokenizer
from clip_lite_tpu.eval_utils import EncoderBundle as JBundle
from clip_lite_tpu.eval_utils import itm_eval as jitm_eval
from clip_lite_tpu.factories import PretrainingModelFactory as JFactory
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.data.tokenizers import HashingTokenizer
from clip_lite_torch.eval_utils import EncoderBundle, _chunked, itm_eval
from clip_lite_torch.retrieval import score_retrieval

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
TINY = ["AMP", False, "MODEL.VISUAL.WIDTH", 8, "DATA.IMAGE_CROP_SIZE", 32,
        "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 2, "MODEL.TEXTUAL.HIDDEN_SIZE", 128,
        "DATA.MAX_CAPTION_LENGTH", 8, "MODEL.TEXTUAL.VOCAB_SIZE", 128]
CAPTIONS = ["a dog runs on the beach", "two cats", "a red car parked by a "
            "long wall in the city at night", "people", "a plate of food",
            "a man rides a horse"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(tree, rng):
    """Seeded non-trivial BatchNorm running statistics."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb(v, rng)
        elif k == "mean":
            tree[k] = rng.randn(*v.shape).astype(np.float32) * 0.1
        elif k == "var":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    jcfg = JConfig(FLAGSHIP, TINY)
    sample = {"image": jnp.zeros((1, 32, 32, 3)),
              "input_ids": jnp.zeros((1, 8), jnp.int32),
              "attention_mask": jnp.ones((1, 8), jnp.int32)}
    model = JFactory.from_config(jcfg)
    # Jitted: flax's eager init compiles op by op, several times as slow.
    v = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(0), "prior": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, x, train=False))(sample)
    v = jax.tree.map(np.asarray, {"params": v["params"],
                                  "batch_stats": v["batch_stats"]})
    _perturb(v["batch_stats"], np.random.RandomState(1))
    path = str(tmp_path_factory.mktemp("ckpt") / "climax.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(v))
    jax_bundle = JBundle(jcfg, checkpoint_path=path, batch_size=4)
    cfg = Config(FLAGSHIP, TINY)
    port = EncoderBundle(cfg, state_dict=bridge.from_jax_variables(v, cfg),
                         batch_size=4, device="cpu")
    return jax_bundle, port


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).randn(6, 32, 32, 3).astype(np.float32)


def test_image_embeddings_match(bundles, images):
    jax_bundle, port = bundles
    ref = jax_bundle.encode_images(images)
    out = port.encode_images(images)
    assert out.shape == ref.shape == (6, 2048)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-5)


def test_text_embeddings_match(bundles):
    jax_bundle, port = bundles
    ref = jax_bundle.encode_texts(CAPTIONS, JTokenizer(128, 8))
    out = port.encode_texts(CAPTIONS, HashingTokenizer(128, 8))
    assert out.shape == ref.shape == (6, 2048)
    np.testing.assert_allclose(out, ref, **TOL)


def test_retrieval_recalls_equal(bundles, images):
    jax_bundle, port = bundles
    txt2img = {i: i for i in range(6)}
    img2txt = {i: [i] for i in range(6)}
    recalls, img_emb, txt_emb = score_retrieval(
        port, images, CAPTIONS, HashingTokenizer(128, 8), txt2img, img2txt)
    ji = jax_bundle.encode_images(images)
    jt = jax_bundle.encode_texts(CAPTIONS, JTokenizer(128, 8))
    sims = ji @ jt.T
    assert recalls == jitm_eval(sims, sims.T, txt2img, img2txt)
    np.testing.assert_allclose(img_emb @ txt_emb.T, sims, **TOL)


def test_itm_eval_copy_matches_jax():
    rng = np.random.RandomState(3)
    sims = rng.randn(7, 14)
    img2txt = {i: [2 * i, 2 * i + 1] for i in range(7)}
    txt2img = {t: t // 2 for t in range(14)}
    assert itm_eval(sims, sims.T, txt2img, img2txt) == jitm_eval(
        sims, sims.T, txt2img, img2txt)


def test_tokenizer_copy_matches_jax():
    for vocab, length in [(128, 8), (30522, 30), (999, 5)]:
        ours, theirs = HashingTokenizer(vocab, length), JTokenizer(vocab, length)
        assert ours(CAPTIONS) == theirs(CAPTIONS)
        assert ours(CAPTIONS[0]) == theirs(CAPTIONS[0])


def test_tokenizer_factory_stays_inside_vocab(monkeypatch):
    """Without a cached HF tokenizer the factory falls back to hashing,
    into MODEL.TEXTUAL.VOCAB_SIZE ids."""
    from clip_lite_torch.factories import TokenizerFactory

    monkeypatch.setitem(sys.modules, "transformers", None)  # import fails
    tok = TokenizerFactory.from_config(Config(FLAGSHIP, TINY))
    ids = np.asarray(tok(CAPTIONS, max_length=8)["input_ids"])
    assert isinstance(tok, HashingTokenizer) and ids.shape == (6, 8)
    assert ids.max() < 128


def test_chunked_tail_padding():
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return x * 2

    out = _chunked(fn, 4, np.arange(10, dtype=np.float32).reshape(10, 1))
    np.testing.assert_allclose(out[:, 0], np.arange(10) * 2)
    assert calls == [4, 4, 4]


@pytest.mark.parametrize("path", [None] + sorted(
    glob.glob(os.path.join(ROOT, "configs", "*.yaml"))),
    ids=lambda p: "defaults" if p is None else os.path.basename(p))
def test_config_copy_matches_jax(path):
    overrides = ["MODEL.TEXTUAL.FUSED_ATTENTION", False, "OPTIM.LR_STEPS", [1, 2]]
    assert Config(path, overrides)._C.to_dict() == \
        JConfig(path, overrides)._C.to_dict()


_FORBIDDEN = {"jax", "flax", "optax", "clip_lite_tpu", "jaxlib", "msgpack",
              "cv2", "lmdb", "sklearn"}


def _port_sources():
    files = sorted(glob.glob(os.path.join(ROOT, "clip_lite_torch", "**", "*.py"),
                             recursive=True))
    return files + [os.path.join(ROOT, "chip_smoke.py")]


def test_port_imports_no_jax():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [(os.path.relpath(path, ROOT), n) for n in names
                          if n.split(".")[0] in _FORBIDDEN]
    assert len(_port_sources()) > 15
    assert offenders == []
