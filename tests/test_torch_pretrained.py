"""Pretrained towers from local files (``clip_lite_torch/models/
pretrained.py``) against the JAX package on the CPU: the torchvision
ResNet, Hugging Face BERT and MPNet importers on synthetic state_dicts
in those layouts (seeded; ``transformers`` is left out, as it loads
TensorFlow for 20 s), ``apply_pretrained_weights`` on ``.pt`` and ``.npz``
files, the refusal of a non-ResNet visual tower, and the training CLI
starting from such files.

Bars: imported weights exact, each the JAX importer's (a copy, or the
same concatenation of q, k and v)."""

import os

import numpy as np
import pytest
import torch

import jax

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import PretrainingModelFactory as JFactory
from clip_lite_tpu.models import bert as jbert
from clip_lite_tpu.models import mpnet as jmpnet
from clip_lite_tpu.models import resnet as jresnet
from clip_lite_tpu.models.pretrained import (
    apply_pretrained_weights as japply_pretrained_weights,
)
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.engine import create_train_state
from clip_lite_torch.models import pretrained
from clip_lite_torch.models.bert import BertModel
from clip_lite_torch.models.image_encoder import torchvision_resnet_state_dict
from clip_lite_torch.models.mpnet import MPNetModel
from clip_lite_torch.models.resnet import resnet18, resnet50
from clip_lite_torch.ops.layers import init_weights
from clip_lite_torch.train import main, parser
from test_torch_data_pipeline import write_corpus
from torch_matrix import FLAGSHIP, seeded_variables
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

HIDDEN, LAYERS, VOCAB = 64, 2, 128


def _seeded(module, seed=0):
    return init_weights(module, torch.Generator().manual_seed(seed))


def _torchvision(net=resnet18, width=8, seed=0):
    """A seeded port ResNet and its weights in torchvision's layout, with
    seeded BatchNorm statistics, ``fc`` and ``num_batches_tracked`` as a
    torchvision checkpoint holds them."""
    tower = _seeded(net(width=width), seed)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, b in tower.named_buffers():
            b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    sd = {k: torch.from_numpy(v) for k, v in
          torchvision_resnet_state_dict(tower).items()}
    for k in [k for k in sd if k.endswith("running_var")]:
        sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    sd["fc.weight"] = torch.zeros(10, tower.feature_size)
    sd["fc.bias"] = torch.zeros(10)
    return tower, sd


@pytest.mark.parametrize("net,stages", [(resnet18, [2, 2, 2, 2]),
                                        (resnet50, [3, 4, 6, 3])],
                         ids=["resnet18", "resnet50"])
def test_resnet_importer_matches_jax(net, stages):
    """The import is the inverse of the port's torchvision export, and the
    JAX importer's tree bridged onto the port tower gives the same keys
    and values."""
    tower, sd = _torchvision(net)
    got = pretrained.import_torch_resnet_state_dict(sd)
    want = tower.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tree = jax.tree.map(np.asarray, jresnet.import_torch_resnet_state_dict(
        {k: v.numpy() for k, v in sd.items()}, stages))
    tree["params"].pop("fc")
    theirs = bridge.convert(tree, tower)
    for k in want:
        assert torch.equal(got[k], theirs[k]), k
    with pytest.raises(KeyError, match="classifier.0.weight"):
        pretrained.import_torch_resnet_state_dict(
            dict(sd, **{"classifier.0.weight": torch.zeros(1)}))


def _hf_bert(seed=0, layers=LAYERS + 1):
    """A Hugging Face ``BertModel`` state_dict of a seeded port BERT with
    one layer more than the towers take, and HF's ``position_ids``
    buffer."""
    port = _seeded(BertModel(vocab_size=VOCAB, hidden_size=HIDDEN,
                             num_hidden_layers=layers, num_heads=1,
                             intermediate_size=4 * HIDDEN), seed)
    sd = pretrained.export_hf_bert_state_dict(port)
    sd["embeddings.position_ids"] = torch.arange(512)[None]
    return sd


def _hf_mpnet(seed=0, layers=1):
    """A seeded state_dict in Hugging Face ``MPNetModel``'s keys and
    shapes, with its ``mpnet.`` prefix."""
    g = torch.Generator().manual_seed(seed)
    shapes = {"embeddings.word_embeddings.weight": (30527, 768),
              "embeddings.position_embeddings.weight": (514, 768),
              "embeddings.LayerNorm.weight": (768,),
              "embeddings.LayerNorm.bias": (768,),
              "encoder.relative_attention_bias.weight": (32, 12),
              "pooler.dense.weight": (768, 768), "pooler.dense.bias": (768,)}
    for i in range(layers):
        p = f"encoder.layer.{i}"
        for name, (o, n) in (("attention.attn.q", (768, 768)),
                             ("attention.attn.k", (768, 768)),
                             ("attention.attn.v", (768, 768)),
                             ("attention.attn.o", (768, 768)),
                             ("intermediate.dense", (3072, 768)),
                             ("output.dense", (768, 3072))):
            shapes[f"{p}.{name}.weight"] = (o, n)
            shapes[f"{p}.{name}.bias"] = (o,)
        for name in ("attention.LayerNorm", "output.LayerNorm"):
            shapes[f"{p}.{name}.weight"] = shapes[f"{p}.{name}.bias"] = (768,)
    return {f"mpnet.{k}": 0.02 * torch.randn(v, generator=g)
            for k, v in shapes.items()}


def test_bert_importer_matches_jax():
    """A HF-layout BERT state_dict with one layer more than the tower (the
    importer takes the first LAYERS), with its ``bert.`` prefix: the port's
    keys equal the JAX importer's tree bridged onto the port tower, q, k
    and v land in ``qkv`` in that order, and the export inverts the
    import."""
    hf = _hf_bert()
    sd = {f"bert.{k}": v for k, v in hf.items()}
    got = pretrained.import_hf_bert_state_dict(sd, LAYERS)
    port = BertModel(vocab_size=VOCAB, hidden_size=HIDDEN, num_hidden_layers=
                     LAYERS, num_heads=1, intermediate_size=4 * HIDDEN)
    port.load_state_dict(got)
    tree = jax.tree.map(np.asarray, jbert.import_hf_bert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, LAYERS))
    theirs = bridge.convert(tree, port)
    for k, v in port.state_dict().items():
        assert torch.equal(v, theirs[k]), k
    assert torch.equal(got["layer_1.qkv.weight"][HIDDEN:2 * HIDDEN],
                       hf["encoder.layer.1.attention.self.key.weight"])
    back = pretrained.export_hf_bert_state_dict(port)
    assert "encoder.layer.2.output.dense.weight" not in back
    for k, v in back.items():
        assert torch.equal(v, hf[k]), k


def test_mpnet_importer_matches_jax():
    sd = _hf_mpnet()
    got = pretrained.import_hf_mpnet_state_dict(sd, 1)
    port = MPNetModel(num_hidden_layers=1)
    port.load_state_dict(got)
    tree = jax.tree.map(np.asarray, jmpnet.import_hf_mpnet_state_dict(
        {k: v.numpy() for k, v in sd.items()}, 1))
    theirs = bridge.convert(tree, port)
    for k, v in port.state_dict().items():
        assert torch.equal(v, theirs[k]), k
    assert torch.equal(got["layer_0.qkv.bias"][-768:],
                       sd["mpnet.encoder.layer.0.attention.attn.v.bias"])


TINY = ["AMP", False, "MODEL.VISUAL.NETWORK_NAME", "resnet18",
        "MODEL.VISUAL.WIDTH", 8, "MODEL.VISUAL.FEATURE_SIZE", 64,
        "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", LAYERS,
        "MODEL.TEXTUAL.HIDDEN_SIZE", HIDDEN, "MODEL.TEXTUAL.VOCAB_SIZE", VOCAB,
        "DATA.IMAGE_CROP_SIZE", 32, "DATA.MAX_CAPTION_LENGTH", 12]


@pytest.fixture(scope="module")
def tower_files(tmp_path_factory):
    """A torchvision-layout ResNet-18 (width 8) as ``.pt`` wrapped in
    ``{"state_dict": ...}`` and as ``.npz``, and a HF BERT as ``.pt``."""
    root = tmp_path_factory.mktemp("towers")
    tower, sd = _torchvision(seed=3)
    torch.save({"state_dict": sd}, root / "rn18.pt")
    np.savez(root / "rn18.npz", **{k: v.numpy() for k, v in sd.items()})
    hf = _hf_bert(seed=4, layers=LAYERS)
    torch.save(hf, root / "bert.pt")
    return dict(tower=tower, sd=sd, hf=hf,
                pt=str(root / "rn18.pt"), npz=str(root / "rn18.npz"),
                bert=str(root / "bert.pt"))


@pytest.mark.parametrize("visual", ["pt", "npz"])
def test_apply_pretrained_weights_matches_jax(tower_files, visual):
    """Both towers spliced into the pretraining model: the port's model
    holds the files' tensors, as the JAX function's variables do (bridged),
    and the rest of the model is untouched."""
    over = TINY + ["MODEL.VISUAL.PRETRAINED", True,
                   "MODEL.VISUAL.PRETRAINED_PATH", tower_files[visual],
                   "MODEL.TEXTUAL.PRETRAINED", True,
                   "MODEL.TEXTUAL.PRETRAINED_PATH", tower_files["bert"]]
    jcfg = JConfig(FLAGSHIP, over)
    jmodel = JFactory.from_config(jcfg)
    sample = {"image": np.zeros((1, 32, 32, 3), np.float32),
              "input_ids": np.ones((1, 12), np.int32),
              "attention_mask": np.ones((1, 12), np.int32)}
    v = seeded_variables(jmodel, sample, train=False)
    cfg = Config(FLAGSHIP, over)
    state = create_train_state(cfg, device="cpu",
                               state_dict=bridge.from_jax_variables(v, cfg))
    spliced = jax.tree.map(np.asarray, japply_pretrained_weights(v, jcfg))
    # JAX keeps the file's classifier beside its chopped tower, unused.
    spliced["params"]["image_encoder"]["backbone"].pop("fc")
    want = bridge.convert(spliced, state.model)
    assert pretrained.pretrained_requested(cfg)
    pretrained.apply_pretrained_weights(state.model, cfg)
    got = state.model.state_dict()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tower = tower_files["tower"].state_dict()
    for k, t in tower.items():
        assert torch.equal(got[f"image_encoder.backbone.{k}"], t), k
    assert torch.equal(got["text_encoder.transformer.embeddings.word.weight"],
                       tower_files["hf"]["embeddings.word_embeddings.weight"])


def test_non_resnet_pretrained_rejected(tmp_path):
    """As ``tests/test_pretrained.py::test_non_resnet_pretrained_rejected``:
    a VGG (and a zoo tower) cannot take a torchvision ResNet file, in
    either package; nor can a text mode without a transformer."""
    path = str(tmp_path / "x.pt")
    torch.save({}, path)
    for name in ("vgg19", "zoo::resnet8"):
        over = ["MODEL.VISUAL.NETWORK_NAME", name,
                "MODEL.VISUAL.PRETRAINED", True,
                "MODEL.VISUAL.PRETRAINED_PATH", path]
        with pytest.raises(ValueError, match="ResNets"):
            japply_pretrained_weights({"params": {}, "batch_stats": {}},
                                      JConfig(override_list=over))
        with pytest.raises(ValueError, match="ResNets"):
            pretrained.apply_pretrained_weights(None, Config(override_list=over))
    cfg = Config(FLAGSHIP, TINY + ["MODEL.TEXTUAL.NAME", "sbert",
                                   "MODEL.TEXTUAL.PRETRAINED", True,
                                   "MODEL.TEXTUAL.PRETRAINED_PATH", path])
    state = create_train_state(cfg, device="cpu")
    with pytest.raises(ValueError, match="no transformer"):
        pretrained.apply_pretrained_weights(state.model, cfg)


def test_cli_starts_from_pretrained_files(tower_files, tmp_path):
    """``python -m clip_lite_torch.train`` with both towers' files
    (finetune_sbert), two steps at learning rates of 0: the weights stay
    as loaded, and the Lookahead slow weights start from them."""
    corpus = write_corpus(tmp_path, n_train=8, n_val=4)
    args = parser.parse_args([str(a) for a in (
        "--device", "cpu", "--serialization-dir", tmp_path / "out",
        "--checkpoint-every", 100, "--log-every", 1, "--cpu-workers", 1,
        "--config-override", "MODEL.NAME", "captions", "DATA.ROOT", corpus,
        *TINY, "MODEL.TEXTUAL.NAME", "finetune_sbert",
        "MODEL.VISUAL.PRETRAINED", True,
        "MODEL.VISUAL.PRETRAINED_PATH", tower_files["npz"],
        "MODEL.TEXTUAL.PRETRAINED", True,
        "MODEL.TEXTUAL.PRETRAINED_PATH", tower_files["bert"],
        "OPTIM.BATCH_SIZE", 4, "OPTIM.NUM_ITERATIONS", 2,
        "OPTIM.WARMUP_STEPS", 1, "OPTIM.CNN_LR", 0.0, "OPTIM.TRANS_LR", 0.0,
        "OPTIM.LR", 0.0)])
    state = main(args)
    got = state.model.state_dict()
    slow = state.optimizer.slow_state()
    for k, t in tower_files["tower"].state_dict().items():
        if "running" not in k:
            key = f"image_encoder.backbone.{k}"
            assert torch.equal(got[key], t) and torch.equal(slow[key], t), k
    word = "text_encoder.transformer.embeddings.word.weight"
    assert torch.equal(got[word],
                       tower_files["hf"]["embeddings.word_embeddings.weight"])
    assert os.path.exists(tmp_path / "out" / "log_pretrain.txt")
