"""Pretrained towers from local files, the counterpart of the JAX
package's ``models/pretrained.py``.

The reference loads ImageNet towers from torchvision and text towers from
the Hugging Face hub; with no network, both come from local files:

  MODEL.VISUAL.PRETRAINED + MODEL.VISUAL.PRETRAINED_PATH
      a torchvision-layout ResNet state_dict (``conv1``, ``bn1``,
      ``layer{s}.{b}.conv{i}``/``.bn{i}``, ``.downsample.0``/``.1``)
  MODEL.TEXTUAL.PRETRAINED + MODEL.TEXTUAL.PRETRAINED_PATH
      a Hugging Face ``BertModel`` or ``MPNetModel`` state_dict (keys with
      or without their ``bert.``/``mpnet.`` prefix)

as ``.pt``/``.pth`` (``torch.save``, read with ``weights_only=True``, a
``{"state_dict": ...}`` wrapper unwrapped) or ``.npz``.  The importers
map such a state_dict onto the port's modules' keys; BERT's and MPNet's
separate q, k and v projections become the fused ``qkv``.
:func:`export_hf_bert_state_dict` goes the other way for a BERT tower
(the files of the tests and of the card's check).
:func:`apply_pretrained_weights` loads both towers into a pretraining
model in place, as the JAX function splices them into its variables; a
visual tower that is not a ResNet raises, as there.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

logger = logging.getLogger("clip_lite_torch")

_RESNET_RENAMES = (
    (r"^conv1\.weight$", r"stem.conv.weight"),
    (r"^bn1\.(\w+)$", r"stem.bn.\1"),
    (r"^layer(\d)\.(\d+)\.conv(\d)\.weight$", r"layer\1_\2.block\3.conv.weight"),
    (r"^layer(\d)\.(\d+)\.bn(\d)\.(\w+)$", r"layer\1_\2.block\3.bn.\4"),
    (r"^layer(\d)\.(\d+)\.downsample\.0\.weight$", r"layer\1_\2.shortcut.conv.weight"),
    (r"^layer(\d)\.(\d+)\.downsample\.1\.(\w+)$", r"layer\1_\2.shortcut.bn.\3"),
)


def _tensor(v) -> torch.Tensor:
    return v.detach().float().cpu() if isinstance(v, torch.Tensor) else \
        torch.from_numpy(np.array(v, np.float32))


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A state_dict file as CPU tensors: ``.npz``, or ``.pt``/``.pth``
    through ``torch.load(weights_only=True)``, unwrapping ``state_dict``."""
    if path.endswith(".npz"):
        with np.load(path) as f:
            return {k: torch.from_numpy(f[k]) for k in f.files}
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return dict(obj)


def import_torch_resnet_state_dict(state_dict: Mapping) -> Dict[str, torch.Tensor]:
    """A torchvision-layout ResNet state_dict on the port ResNet's keys
    (``stem.conv``, ``layer{s}_{b}.block{i}``, ``.shortcut``), the inverse
    of ``image_encoder.torchvision_resnet_state_dict``.  The classifier
    ``fc`` and ``num_batches_tracked`` are dropped (the tower has neither);
    any other key raises."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if key.startswith("fc.") or key.endswith("num_batches_tracked"):
            continue
        for pattern, repl in _RESNET_RENAMES:
            if re.match(pattern, key):
                out[re.sub(pattern, repl, key)] = _tensor(value)
                break
        else:
            raise KeyError(f"{key}: not a torchvision ResNet key")
    return out


def _hf_layers(sd: Dict[str, torch.Tensor], num_layers: int, names: dict,
               ) -> Dict[str, torch.Tensor]:
    """The transformer layers 0..num_layers-1 of an HF state_dict on the
    port's ``layer_{i}`` keys; ``names`` gives the HF prefix of q, k, v,
    the attention output and its LayerNorm, under ``encoder.layer.{i}``."""
    out: Dict[str, torch.Tensor] = {}
    for i in range(num_layers):
        p, d = f"encoder.layer.{i}", f"layer_{i}"
        for leaf in ("weight", "bias"):
            out[f"{d}.qkv.{leaf}"] = torch.cat(
                [sd[f"{p}.{names[x]}.{leaf}"] for x in "qkv"], 0)
            for port, hf in (("attn_out", names["o"]), ("attn_ln", names["ln"]),
                             ("intermediate", "intermediate.dense"),
                             ("output", "output.dense"),
                             ("out_ln", "output.LayerNorm")):
                out[f"{d}.{port}.{leaf}"] = sd[f"{p}.{hf}.{leaf}"]
    if "pooler.dense.weight" in sd:
        out["pooler.weight"] = sd["pooler.dense.weight"]
        out["pooler.bias"] = sd["pooler.dense.bias"]
    return out


def _strip(state_dict: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {k.replace(prefix, ""): _tensor(v) for k, v in state_dict.items()}


def import_hf_bert_state_dict(state_dict: Mapping,
                              num_layers: int) -> Dict[str, torch.Tensor]:
    """A Hugging Face ``BertModel`` state_dict on the port ``BertModel``'s
    keys: its first ``num_layers`` layers, q, k and v concatenated into
    ``qkv``, the pooler where the file has one."""
    sd = _strip(state_dict, "bert.")
    out = {
        "embeddings.word.weight": sd["embeddings.word_embeddings.weight"],
        "embeddings.position.weight": sd["embeddings.position_embeddings.weight"],
        "embeddings.token_type.weight":
            sd["embeddings.token_type_embeddings.weight"],
        "embeddings.ln.weight": sd["embeddings.LayerNorm.weight"],
        "embeddings.ln.bias": sd["embeddings.LayerNorm.bias"],
    }
    out.update(_hf_layers(sd, num_layers, {
        "q": "attention.self.query", "k": "attention.self.key",
        "v": "attention.self.value", "o": "attention.output.dense",
        "ln": "attention.output.LayerNorm"}))
    return out


def import_hf_mpnet_state_dict(state_dict: Mapping,
                               num_layers: int) -> Dict[str, torch.Tensor]:
    """A Hugging Face ``MPNetModel`` state_dict on the port
    ``MPNetModel``'s keys (the relative attention bias table included)."""
    sd = _strip(state_dict, "mpnet.")
    out = {
        "word.weight": sd["embeddings.word_embeddings.weight"],
        "position.weight": sd["embeddings.position_embeddings.weight"],
        "emb_ln.weight": sd["embeddings.LayerNorm.weight"],
        "emb_ln.bias": sd["embeddings.LayerNorm.bias"],
        "relative_attention_bias.weight":
            sd["encoder.relative_attention_bias.weight"],
    }
    out.update(_hf_layers(sd, num_layers, {
        "q": "attention.attn.q", "k": "attention.attn.k",
        "v": "attention.attn.v", "o": "attention.attn.o",
        "ln": "attention.LayerNorm"}))
    return out


def export_hf_bert_state_dict(bert: nn.Module) -> Dict[str, torch.Tensor]:
    """A port ``BertModel``'s weights in Hugging Face ``BertModel``'s
    layout and names, CPU tensors: the inverse of
    :func:`import_hf_bert_state_dict`."""
    sd = {k: v.detach().float().cpu().contiguous()
          for k, v in bert.state_dict().items()}
    out = {
        "embeddings.word_embeddings.weight": sd["embeddings.word.weight"],
        "embeddings.position_embeddings.weight":
            sd["embeddings.position.weight"],
        "embeddings.token_type_embeddings.weight":
            sd["embeddings.token_type.weight"],
        "embeddings.LayerNorm.weight": sd["embeddings.ln.weight"],
        "embeddings.LayerNorm.bias": sd["embeddings.ln.bias"],
    }
    for i, name in enumerate(bert.layer_names):
        p = f"encoder.layer.{i}"
        for leaf in ("weight", "bias"):
            q, k, v = sd[f"{name}.qkv.{leaf}"].chunk(3, 0)
            for hf, t in (("attention.self.query", q), ("attention.self.key", k),
                          ("attention.self.value", v),
                          ("attention.output.dense", sd[f"{name}.attn_out.{leaf}"]),
                          ("attention.output.LayerNorm",
                           sd[f"{name}.attn_ln.{leaf}"]),
                          ("intermediate.dense", sd[f"{name}.intermediate.{leaf}"]),
                          ("output.dense", sd[f"{name}.output.{leaf}"]),
                          ("output.LayerNorm", sd[f"{name}.out_ln.{leaf}"])):
                out[f"{p}.{hf}.{leaf}"] = t.contiguous()
    if "pooler.weight" in sd:
        out["pooler.dense.weight"] = sd["pooler.weight"]
        out["pooler.dense.bias"] = sd["pooler.bias"]
    return out


def pretrained_requested(config) -> bool:
    """Whether ``config`` names a pretrained tower's file."""
    vis, txt = config.MODEL.VISUAL, config.MODEL.TEXTUAL
    return bool((vis.PRETRAINED and vis.get("PRETRAINED_PATH"))
                or (txt.PRETRAINED and txt.get("PRETRAINED_PATH")))


@torch.no_grad()
def apply_pretrained_weights(model: nn.Module, config) -> nn.Module:
    """Load the pretrained towers that ``config`` names into the
    pretraining model ``model`` (a ``VLInfoModel``), in place and on its
    device: the visual ResNet (weights and BatchNorm statistics) and the
    BERT or MPNet transformer; every key of a tower must be filled.  The
    caller builds the optimizer afterwards, as the JAX CLI re-initialises
    its optimizer state for the loaded params.  Returns ``model``."""
    from clip_lite_torch.models.resnet import RESNETS

    vis = config.MODEL.VISUAL
    if vis.PRETRAINED and vis.get("PRETRAINED_PATH"):
        if vis.NETWORK_NAME not in RESNETS:
            raise ValueError("Pretrained loading supports ResNets, got "
                             f"{vis.NETWORK_NAME!r}")
        tower = import_torch_resnet_state_dict(
            load_torch_state_dict(vis.PRETRAINED_PATH))
        model.image_encoder.backbone.load_state_dict(tower)
        logger.info("Loaded pretrained visual tower from %s",
                    vis.PRETRAINED_PATH)

    txt = config.MODEL.TEXTUAL
    if txt.PRETRAINED and txt.get("PRETRAINED_PATH"):
        transformer = getattr(model.text_encoder, "transformer", None)
        if transformer is None:
            raise ValueError(f"text mode {txt.NAME!r} has no transformer to "
                             "load pretrained weights into")
        sd = load_torch_state_dict(txt.PRETRAINED_PATH)
        importer = (import_hf_mpnet_state_dict if "mpnet" in txt.NETWORK_NAME
                    else import_hf_bert_state_dict)
        transformer.load_state_dict(importer(sd, txt.NUM_HIDDEN_LAYERS))
        logger.info("Loaded pretrained text tower from %s",
                    txt.PRETRAINED_PATH)
    return model
