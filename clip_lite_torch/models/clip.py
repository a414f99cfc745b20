"""OpenAI CLIP's text and vision towers, for ``retrieval --weight-init
clip``: the counterpart of transformers' ``FlaxCLIPModel``
(``get_text_features``, ``get_image_features``) that the JAX package's
``retrieval.py::ClipComparisonBundle`` reads from a local Hugging Face
directory.  The card's machine has no transformers, so the port keeps its
own: :func:`load_clip_model` builds both towers from the directory's
``config.json`` and reads the Flax weights (``flax_model.msgpack``, or
the shards that ``flax_model.msgpack.index.json`` names) through
``utils/msgpack_io.py``, Flax's (in, out) ``Dense`` kernels and HWIO
patch conv transposed into torch's layout.

Both towers are pre-LayerNorm transformers (eps from ``config.json``)
with QuickGELU (x * sigmoid(1.702 x); another ``hidden_act`` raises):

- vision: a patch conv without bias over the NHWC image, a class
  embedding and learned positions, ``pre_layrnorm`` (transformers'
  spelling), the layers, ``post_layernorm`` on the class token, and
  ``visual_projection`` without bias;
- text: token and position embeddings, the layers under the causal mask
  combined with the padding mask, ``final_layer_norm``, the pooled token
  (where ``text_config.eos_token_id`` is the legacy 2, the highest id of
  each row, ``input_ids.argmax(-1)``; else the first position holding
  ``eos_token_id``), and ``text_projection`` without bias.

Attention goes through K1 (``ops/attention.py``): q, k and v are packed
into its ``qkv`` layout, as ``models/pretrained.py`` packs BERT's; the
vision tower takes a zero key bias, the text tower the causal and padding
mask as a full (B, NH, S, S) bias whose masked entries hold float32's
minimum, as ``modeling_flax_clip.py`` builds it (no row is fully masked:
the start token is never padding).  Both towers compute in float32, as
``FlaxCLIPModel`` does by default, so on the card K1 takes its CUDA-core
route.  ``fused_attention`` (``"auto"``, ``"true"``, ``"false"``) picks
K1 or its plain twin, as ``MODEL.TEXTUAL.FUSED_ATTENTION`` does for BERT.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch
from torch import nn

from clip_lite_torch.ops.attention import (
    attention_reference,
    fused_short_attention,
    resolve_fused_flag,
)
from clip_lite_torch.ops.layers import LayerNorm, Linear
from clip_lite_torch.utils import msgpack_io

# CLIPTextConfig's and CLIPVisionConfig's defaults (openai/clip-vit-base-
# patch32's widths): transformers writes only the values that differ.
TEXT_DEFAULTS = dict(vocab_size=49408, hidden_size=512, intermediate_size=2048,
                     num_hidden_layers=12, num_attention_heads=8,
                     max_position_embeddings=77, hidden_act="quick_gelu",
                     layer_norm_eps=1e-5, eos_token_id=49407)
VISION_DEFAULTS = dict(hidden_size=768, intermediate_size=3072,
                       num_hidden_layers=12, num_attention_heads=12,
                       num_channels=3, image_size=224, patch_size=32,
                       hidden_act="quick_gelu", layer_norm_eps=1e-5)
PROJECTION_DIM = 512
LEGACY_EOS_TOKEN_ID = 2  # before transformers PR 24773: pool at the max id
_NEG = float(np.finfo(np.float32).min)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def read_clip_config(path: str) -> dict:
    """``{"text": ..., "vision": ..., "projection_dim": ...}`` from the
    directory's ``config.json``, with transformers' defaults for what it
    leaves out."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    text = {**TEXT_DEFAULTS, **cfg.get("text_config", {})}
    vision = {**VISION_DEFAULTS, **cfg.get("vision_config", {})}
    for tower in (text, vision):
        if tower["hidden_act"] != "quick_gelu":
            raise ValueError(f"CLIP hidden_act {tower['hidden_act']!r}: the "
                             "port has quick_gelu")
    return {"text": text, "vision": vision,
            "projection_dim": cfg.get("projection_dim", PROJECTION_DIM)}


class ClipLayer(nn.Module):
    """One pre-LayerNorm block: x + attn(ln1(x)), then x + mlp(ln2(x)); the
    q, k and v projections packed into one (3D, D) ``qkv``."""

    def __init__(self, width: int, num_heads: int, intermediate: int,
                 eps: float, fused_attention: str):
        super().__init__()
        self.num_heads = num_heads
        self.fused_attention = fused_attention
        self.layer_norm1 = LayerNorm(width, eps)
        self.qkv = Linear(width, 3 * width)
        self.out_proj = Linear(width, width)
        self.layer_norm2 = LayerNorm(width, eps)
        self.fc1 = Linear(width, intermediate)
        self.fc2 = Linear(intermediate, width)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """x: (B, S, D) fp32; bias: (B, S) key bias or (B, NH, S, S)."""
        qkv = self.qkv(self.layer_norm1(x)).contiguous()
        if resolve_fused_flag(self.fused_attention, x.device):
            ctx = fused_short_attention(qkv, bias, self.num_heads)
        else:
            ctx = attention_reference(qkv, bias, self.num_heads)
        x = x + self.out_proj(ctx)
        return x + self.fc2(quick_gelu(self.fc1(self.layer_norm2(x))))


class _Tower(nn.Module):
    def __init__(self, cfg: dict, fused_attention: str):
        super().__init__()
        self.layers = nn.ModuleList(
            ClipLayer(cfg["hidden_size"], cfg["num_attention_heads"],
                      cfg["intermediate_size"], cfg["layer_norm_eps"],
                      fused_attention)
            for _ in range(cfg["num_hidden_layers"]))

    def encode(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, bias)
        return x


class ClipVisionTower(_Tower):
    def __init__(self, cfg: dict, projection_dim: int, fused_attention: str):
        super().__init__(cfg, fused_attention)
        d, p = cfg["hidden_size"], cfg["patch_size"]
        self.patch_size = p
        self.num_positions = (cfg["image_size"] // p) ** 2 + 1
        self.patch_embedding = nn.Conv2d(cfg["num_channels"], d, p, stride=p,
                                         bias=False)
        self.class_embedding = nn.Parameter(torch.empty(d))
        self.position_embedding = nn.Parameter(
            torch.empty(self.num_positions, d))
        self.pre_layrnorm = LayerNorm(d, cfg["layer_norm_eps"])
        self.post_layernorm = LayerNorm(d, cfg["layer_norm_eps"])
        self.visual_projection = Linear(d, projection_dim, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, C) float32, normalized -> (B, projection_dim)."""
        patches = self.patch_embedding(images.permute(0, 3, 1, 2))
        x = patches.flatten(2).transpose(1, 2)  # (B, h * w, D), row-major
        if x.shape[1] + 1 != self.num_positions:
            raise ValueError(
                f"CLIP's vision tower takes {self.num_positions - 1} patches "
                f"of {self.patch_size} px, got {x.shape[1]} from images of "
                f"{tuple(images.shape[1:3])}")
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + self.position_embedding
        x = self.pre_layrnorm(x)
        bias = torch.zeros(x.shape[:2], dtype=torch.float32, device=x.device)
        x = self.encode(x, bias)
        return self.visual_projection(self.post_layernorm(x[:, 0]))


def text_bias(attention_mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The causal mask combined with the padding mask as a full (B, NH, S,
    S) float32 score bias: 0 where query i sees key j (j <= i and j real),
    float32's minimum elsewhere."""
    b, s = attention_mask.shape
    causal = torch.ones(s, s, dtype=torch.bool,
                        device=attention_mask.device).tril()
    seen = causal[None] & attention_mask.bool()[:, None, :]
    bias = torch.where(seen, 0.0, _NEG).to(torch.float32)
    return bias[:, None].expand(b, num_heads, s, s).contiguous()


class ClipTextTower(_Tower):
    def __init__(self, cfg: dict, projection_dim: int, fused_attention: str):
        super().__init__(cfg, fused_attention)
        d = cfg["hidden_size"]
        self.num_heads = cfg["num_attention_heads"]
        self.eos_token_id = cfg["eos_token_id"]
        self.token_embedding = nn.Embedding(cfg["vocab_size"], d)
        self.position_embedding = nn.Embedding(
            cfg["max_position_embeddings"], d)
        self.final_layer_norm = LayerNorm(d, cfg["layer_norm_eps"])
        self.text_projection = Linear(d, projection_dim, bias=False)

    def pooled_index(self, input_ids: torch.Tensor) -> torch.Tensor:
        if self.eos_token_id == LEGACY_EOS_TOKEN_ID:
            return input_ids.argmax(-1)
        return (input_ids == self.eos_token_id).int().argmax(-1)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> torch.Tensor:
        """(B, S) ids and mask -> (B, projection_dim)."""
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.token_embedding(input_ids) + self.position_embedding(pos)
        x = self.final_layer_norm(
            self.encode(x, text_bias(attention_mask, self.num_heads)))
        rows = torch.arange(x.shape[0], device=x.device)
        return self.text_projection(x[rows, self.pooled_index(input_ids)])


class ClipModel(nn.Module):
    """The two towers; ``get_text_features`` and ``get_image_features``
    are transformers' ``FlaxCLIPModel`` methods of the same names (the
    projected, unnormalized features)."""

    def __init__(self, config: dict, fused_attention: str = "auto"):
        super().__init__()
        proj = config["projection_dim"]
        self.text = ClipTextTower(config["text"], proj, fused_attention)
        self.vision = ClipVisionTower(config["vision"], proj, fused_attention)

    def get_text_features(self, input_ids, attention_mask) -> torch.Tensor:
        return self.text(input_ids, attention_mask)

    def get_image_features(self, images) -> torch.Tensor:
        return self.vision(images)


def read_flax_weights(path: str) -> dict:
    """The Flax params tree of a transformers directory:
    ``flax_model.msgpack``, or the shards of
    ``flax_model.msgpack.index.json`` (each a part of the tree), merged."""
    single = os.path.join(path, "flax_model.msgpack")
    if os.path.exists(single):
        tree = msgpack_io.read(single)
    else:
        index = os.path.join(path, "flax_model.msgpack.index.json")
        if not os.path.exists(index):
            raise FileNotFoundError(f"{path} has neither flax_model.msgpack "
                                    "nor flax_model.msgpack.index.json")
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        tree = {}
        for shard in shards:
            _merge(tree, msgpack_io.read(os.path.join(path, shard)))
    if set(tree) == {"params"}:
        tree = tree["params"]
    return tree


def _merge(into: dict, tree: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v)
        else:
            into[k] = v


def _f32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _dense(tree: dict, prefix: str) -> Dict[str, torch.Tensor]:
    out = {f"{prefix}.weight": _f32(tree["kernel"]).t()}
    if "bias" in tree:
        out[f"{prefix}.bias"] = _f32(tree["bias"])
    return out


def _norm(tree: dict, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _f32(tree["scale"]),
            f"{prefix}.bias": _f32(tree["bias"])}


def _layers(encoder: dict, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    layers = encoder["layers"]
    for i in range(len(layers)):
        layer, name = layers[str(i)], f"{prefix}.layers.{i}"
        attn = layer["self_attn"]
        out[f"{name}.qkv.weight"] = torch.cat(
            [_f32(attn[p]["kernel"]).t() for p in ("q_proj", "k_proj", "v_proj")])
        out[f"{name}.qkv.bias"] = torch.cat(
            [_f32(attn[p]["bias"]) for p in ("q_proj", "k_proj", "v_proj")])
        out.update(_dense(attn["out_proj"], f"{name}.out_proj"))
        out.update(_norm(layer["layer_norm1"], f"{name}.layer_norm1"))
        out.update(_norm(layer["layer_norm2"], f"{name}.layer_norm2"))
        out.update(_dense(layer["mlp"]["fc1"], f"{name}.fc1"))
        out.update(_dense(layer["mlp"]["fc2"], f"{name}.fc2"))
    return out


def state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """:class:`ClipModel`'s state_dict from ``FlaxCLIPModel``'s params."""
    text, vision = params["text_model"], params["vision_model"]
    emb = vision["embeddings"]
    out = {
        "text.token_embedding.weight":
            _f32(text["embeddings"]["token_embedding"]["embedding"]),
        "text.position_embedding.weight":
            _f32(text["embeddings"]["position_embedding"]["embedding"]),
        # HWIO -> (out, in, h, w)
        "vision.patch_embedding.weight":
            _f32(emb["patch_embedding"]["kernel"]).permute(3, 2, 0, 1),
        "vision.class_embedding": _f32(emb["class_embedding"]),
        "vision.position_embedding":
            _f32(emb["position_embedding"]["embedding"]),
        **_norm(text["final_layer_norm"], "text.final_layer_norm"),
        **_norm(vision["pre_layrnorm"], "vision.pre_layrnorm"),
        **_norm(vision["post_layernorm"], "vision.post_layernorm"),
        **_dense(params["text_projection"], "text.text_projection"),
        **_dense(params["visual_projection"], "vision.visual_projection"),
        **_layers(text["encoder"], "text"),
        **_layers(vision["encoder"], "vision"),
    }
    return {k: v.contiguous() for k, v in out.items()}


def load_clip_model(path: str, device="cpu",
                    fused_attention: str = "auto") -> ClipModel:
    """The CLIP model of the local transformers directory ``path``
    (``config.json`` and the Flax weights), on ``device``, in eval mode."""
    model = ClipModel(read_clip_config(path), fused_attention)
    model.load_state_dict(state_dict_from_flax(read_flax_weights(path)))
    return model.to(device).eval()


__all__ = ["ClipModel", "load_clip_model", "quick_gelu", "read_clip_config",
           "read_flax_weights", "state_dict_from_flax", "text_bias"]
