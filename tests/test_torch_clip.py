"""``retrieval --weight-init clip`` in the port (``models/clip.py``, the
``ClipBPETokenizer`` of ``data/tokenizers.py``, ``retrieval.py``'s
``ClipComparisonBundle``) against transformers' ``FlaxCLIPModel`` and
``CLIPTokenizerFast``, which the JAX package's bundle runs, on the CPU.

A tiny random ``FlaxCLIPModel`` (head_dim 64, two layers a tower, 32 px
images of 8 px patches) is saved with ``save_pretrained`` to a temporary
directory, with a synthetic byte-level vocabulary and merges (learned on
a few captions) saved through ``CLIPTokenizerFast``:

* the port's ids and masks equal the fast tokenizer's at max_length 77 on
  captions with unicode letters, digits, apostrophes, punctuation, runs of
  white space, special tokens written in them, and over 77 tokens;
* the text and image features equal ``get_text_features`` and
  ``get_image_features`` at 1e-4, with ``eos_token_id`` 2 (the legacy
  pooling at the highest id) and the default (the first end token), the
  weights read from ``flax_model.msgpack`` and from the sharded
  ``flax_model.msgpack.index.json`` form; the fused attention wrapper
  (K1's CPU twin) and the plain one give the same features;
* the retrieval CLI's JSON equals the JAX CLI's ``main`` on a COCO tree,
  recalls exactly.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch

import jax

from clip_lite_torch.data.tokenizers import ClipBPETokenizer, bytes_to_unicode
from clip_lite_torch.models.clip import load_clip_model, read_flax_weights

transformers = pytest.importorskip("transformers")

SPECIALS = ("<|startoftext|>", "<|endoftext|>")
CORPUS = ("a man riding a horse on the beach", "two dogs playing with a ball",
          "a plate of pizza and salad", "the children are waiting for the bus",
          "a woman holding an umbrella in the rain", "a cat on a red sofa")
CAPTIONS = [
    "A man riding a horse.",
    "Two  dogs,\tplaying   with 3 balls!!",
    "It's a café: they're waiting... (don't go)",
    "Ωμέγα καλημέρα, naïve Zürich 東京 12½ ünïcödé",
    "'quoted' words; a-b-c / x_y 100% #tag @user",
    " ".join(["pizza"] * 90),  # over 77 tokens
    "",
    "a man <|endoftext|> riding x<|startoftext|>y A <|ENDOFTEXT|> b",
]
TEXT = dict(hidden_size=64, num_attention_heads=1, num_hidden_layers=2,
            intermediate_size=128, max_position_embeddings=77)
VISION = dict(hidden_size=128, num_attention_heads=2, num_hidden_layers=2,
              intermediate_size=256, image_size=32, patch_size=8)


def learn_merges(words, n_merges):
    """Byte-level BPE merges learned greedily on ``words`` (most frequent
    pair first, ties broken by the pair)."""
    chars = bytes_to_unicode()
    seqs = collections.Counter()
    for w in words:
        s = [chars[b] for b in w.encode()]
        seqs[tuple(s[:-1] + [s[-1] + "</w>"])] += 1
    merges = []
    for _ in range(n_merges):
        pairs = collections.Counter()
        for seq, n in seqs.items():
            for pair in zip(seq, seq[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = min(pairs, key=lambda p: (-pairs[p], p))
        merges.append(best)
        new = collections.Counter()
        for seq, n in seqs.items():
            out, i = [], 0
            while i < len(seq):
                if i + 1 < len(seq) and (seq[i], seq[i + 1]) == best:
                    out.append(seq[i] + seq[i + 1])
                    i += 2
                else:
                    out.append(seq[i])
                    i += 1
            new[tuple(out)] += n
        seqs = new
    return merges


def write_clip_tokenizer(directory):
    chars = list(bytes_to_unicode().values())
    merges = learn_merges(" ".join(CORPUS).split(), 120)
    # The special tokens among the others, so that the legacy pooling (the
    # highest id of a row) and the end token's position differ.
    tokens = (chars + list(SPECIALS) + [c + "</w>" for c in chars]
              + [a + b for a, b in merges])
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    os.makedirs(directory, exist_ok=True)
    vocab_file = os.path.join(directory, "vocab.json")
    merges_file = os.path.join(directory, "merges.txt")
    with open(vocab_file, "w") as f:
        json.dump(vocab, f)
    with open(merges_file, "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges))
    tok = transformers.CLIPTokenizerFast(vocab_file=vocab_file,
                                         merges_file=merges_file)
    tok.save_pretrained(directory)
    return vocab


def write_clip_dir(directory, eos_token_id=None, shard=False,
                   vision=VISION):
    """A tiny random FlaxCLIPModel (seed 0) and its tokenizer, saved."""
    vocab = write_clip_tokenizer(directory)
    text = dict(TEXT, vocab_size=len(vocab), eos_token_id=(
        vocab[SPECIALS[1]] if eos_token_id is None else eos_token_id))
    config = transformers.CLIPConfig(text_config=text, vision_config=vision,
                                     projection_dim=32)
    with jax.default_prng_impl("threefry2x32"):
        model = transformers.FlaxCLIPModel(config, seed=0)
    model.save_pretrained(directory, max_shard_size="300KB" if shard
                          else "10GB")
    return directory


@pytest.fixture(scope="module")
def clip_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    return {"legacy": write_clip_dir(str(root / "legacy"), eos_token_id=2),
            "eos": write_clip_dir(str(root / "eos"), shard=True)}


def test_tokenizer_matches_clip_tokenizer_fast(clip_dirs):
    path = clip_dirs["eos"]
    fast = transformers.CLIPTokenizerFast.from_pretrained(
        path, local_files_only=True)
    want = fast(CAPTIONS, padding="max_length", truncation=True,
                max_length=77, return_tensors="np")
    got = ClipBPETokenizer(path)(CAPTIONS)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"],
                                  want["attention_mask"])
    assert got["attention_mask"][5].all()  # truncated to 77
    assert got["input_ids"].shape == (len(CAPTIONS), 77)


def _jax_features(path, ids, mask, images):
    model = transformers.FlaxCLIPModel.from_pretrained(path,
                                                       local_files_only=True)
    text = model.get_text_features(input_ids=ids, attention_mask=mask)
    image = model.get_image_features(
        pixel_values=np.transpose(images, (0, 3, 1, 2)))
    return np.asarray(text), np.asarray(image)


@pytest.mark.parametrize("kind", ["legacy", "eos"])
def test_features_match_flax_clip(clip_dirs, kind):
    path = clip_dirs[kind]
    assert os.path.exists(os.path.join(
        path, "flax_model.msgpack.index.json" if kind == "eos"
        else "flax_model.msgpack"))
    tok = ClipBPETokenizer(path)(CAPTIONS)
    images = np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)
    want_text, want_image = _jax_features(path, tok["input_ids"],
                                          tok["attention_mask"], images)
    ids, eot = tok["input_ids"], tok["input_ids"][0, -1]
    at_eot = (ids == eot).argmax(-1)
    assert len(set(at_eot)) > 1 and (ids.argmax(-1) != at_eot).any()
    for fused in ("true", "false"):
        model = load_clip_model(path, device="cpu", fused_attention=fused)
        assert model.text.eos_token_id == (2 if kind == "legacy" else eot)
        np.testing.assert_array_equal(
            model.text.pooled_index(torch.from_numpy(ids)).numpy(),
            ids.argmax(-1) if kind == "legacy" else at_eot)
        with torch.no_grad():
            text = model.get_text_features(
                torch.from_numpy(tok["input_ids"]),
                torch.from_numpy(tok["attention_mask"])).numpy()
            image = model.get_image_features(torch.from_numpy(images)).numpy()
        np.testing.assert_allclose(text, want_text, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(image, want_image, rtol=1e-4, atol=1e-4)
        assert text.shape == (len(CAPTIONS), 32) and image.shape == (3, 32)
    with pytest.raises(ValueError, match="patches"):
        model.get_image_features(torch.zeros(1, 40, 40, 3))


def test_sharded_weights_equal_the_single_file(clip_dirs, tmp_path):
    sharded = read_flax_weights(clip_dirs["eos"])
    model = transformers.FlaxCLIPModel.from_pretrained(
        clip_dirs["eos"], local_files_only=True)
    flat = dict(jax.tree_util.tree_flatten_with_path(model.params)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(sharded)[0])
    assert flat.keys() == got.keys()
    for k in flat:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(flat[k]))
