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
  ``flax_model.msgpack.index.json`` form, and with vision towers of
  ViT-L/14's 257 and ViT-L/14-336's 577 tokens (64 and 96 px images of
  4 px patches); the fused attention wrapper (K1's CPU twin) and the
  plain one give the same features;
* openai/clip-vit-large-patch14's config.json and its 336 px form build
  the towers at their published widths;
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
from clip_lite_torch.models.clip import (
    ClipModel,
    load_clip_model,
    read_clip_config,
    read_flax_weights,
)
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)


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
# Vision towers at ViT-L/14's sequence length (16 x 16 patches + 1 = 257)
# and ViT-L/14-336's (24 x 24 + 1 = 577), at tiny widths: past the 256 of
# the JAX kernel (transformers' attention there) and of the port's
# CUDA-core kernel (its key-tiled 3xTF32 kernel on the card).
VISION_257 = dict(VISION, image_size=64, patch_size=4)
VISION_577 = dict(VISION, image_size=96, patch_size=4)
# openai/clip-vit-large-patch14's config.json (the widths and what the
# port reads; transformers fills in the rest), and its 336 px form.
VIT_L14_CONFIG = {
    "projection_dim": 768,
    "text_config": dict(hidden_size=768, intermediate_size=3072,
                        num_attention_heads=12, num_hidden_layers=12,
                        max_position_embeddings=77, vocab_size=49408,
                        hidden_act="quick_gelu", layer_norm_eps=1e-5,
                        eos_token_id=2),
    "vision_config": dict(hidden_size=1024, intermediate_size=4096,
                          num_attention_heads=16, num_hidden_layers=24,
                          image_size=224, patch_size=14, hidden_act="quick_gelu",
                          layer_norm_eps=1e-5)}


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
            "eos": write_clip_dir(str(root / "eos"), shard=True),
            "vision_s257": write_clip_dir(str(root / "s257"), vision=VISION_257),
            "vision_s577": write_clip_dir(str(root / "s577"), eos_token_id=2,
                                          vision=VISION_577)}


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


@pytest.mark.parametrize("kind", ["legacy", "eos", "vision_s257", "vision_s577"])
def test_features_match_flax_clip(clip_dirs, kind):
    """Both towers against FlaxCLIPModel's at 1e-4, through the fused
    attention wrapper (K1's CPU twin; on the card the 3xTF32 route at 77
    tokens, and for the vision towers of 257 and 577 tokens the key-tiled
    one) and the plain one."""
    path = clip_dirs[kind]
    assert os.path.exists(os.path.join(
        path, "flax_model.msgpack.index.json" if kind == "eos"
        else "flax_model.msgpack"))
    tok = ClipBPETokenizer(path)(CAPTIONS)
    size = {"vision_s257": 64, "vision_s577": 96}.get(kind, 32)
    images = np.random.RandomState(0).randn(3, size, size, 3).astype(np.float32)
    want_text, want_image = _jax_features(path, tok["input_ids"],
                                          tok["attention_mask"], images)
    ids, eot = tok["input_ids"], tok["input_ids"][0, -1]
    at_eot = (ids == eot).argmax(-1)
    assert len(set(at_eot)) > 1 and (ids.argmax(-1) != at_eot).any()
    for fused in ("true", "false"):
        model = load_clip_model(path, device="cpu", fused_attention=fused)
        legacy = kind in ("legacy", "vision_s577")
        assert model.text.eos_token_id == (2 if legacy else eot)
        assert model.vision.num_positions == {
            "vision_s257": 257, "vision_s577": 577}.get(kind, 17)
        np.testing.assert_array_equal(
            model.text.pooled_index(torch.from_numpy(ids)).numpy(),
            ids.argmax(-1) if legacy else at_eot)
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


def test_load_clip_model_runs_on_the_card_unless_asked(clip_dirs):
    """The card by default: with no device on a box without CUDA it raises
    before reading a weight; ``device="cpu"`` loads (the test above)."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_clip_model(clip_dirs["legacy"])


@pytest.mark.parametrize("image_size,positions", [(224, 257), (336, 577)])
def test_vit_l14_published_configs_build(tmp_path, image_size, positions):
    """openai/clip-vit-large-patch14's config.json, and its 336 px form,
    build the port's towers at their published widths (on the meta device:
    no weights): vision 1024 wide, 24 layers of 16 heads over 257 or 577
    positions, text 768 wide, 12 layers of 12 heads, projection 768."""
    config = dict(VIT_L14_CONFIG, vision_config=dict(
        VIT_L14_CONFIG["vision_config"], image_size=image_size))
    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(config, model_type="clip"), f)
    cfg = read_clip_config(str(tmp_path))
    with torch.device("meta"):
        model = ClipModel(cfg)
    vision, text = model.vision, model.text
    assert vision.num_positions == positions
    assert vision.position_embedding.shape == (positions, 1024)
    assert vision.patch_embedding.weight.shape == (1024, 3, 14, 14)
    assert len(vision.layers) == 24 and len(text.layers) == 12
    assert {layer.num_heads for layer in vision.layers} == {16}
    assert {layer.num_heads for layer in text.layers} == {12}
    assert vision.layers[0].fc1.weight.shape == (4096, 1024)
    assert text.layers[0].qkv.weight.shape == (3 * 768, 768)
    assert vision.visual_projection.weight.shape == (768, 1024)
    assert text.text_projection.weight.shape == (768, 768)
    assert text.eos_token_id == 2
