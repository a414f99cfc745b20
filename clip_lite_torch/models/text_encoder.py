"""Text tower wrapper, the counterpart of the JAX package's
``models/text_encoder.py``, in its four modes:

* ``glove``: an embedding table of ``glove_vocab_size`` x ``glove_dim``
  (400,002 x 300, GloVe 42B's words and specials), looked up and
  mean-pooled over every token position in fp32.  Unless
  ``train_embeddings``, the lookup is detached, as JAX's
  ``stop_gradient``: the table stays a parameter of the optimizer's groups
  with a zero gradient, so coupled L2, momentum and Lookahead move it as
  they move JAX's (``requires_grad_(False)`` would leave it still).
* ``sbert``: precomputed 768-d sentence vectors (``caption_encodings``)
  pass through.
* ``train_sbert`` and ``finetune_sbert``: a transformer, MPNet for a
  ``model_name`` that contains ``"mpnet"`` (768 wide, its vocabulary and
  width fixed by ``MPNetModel``'s defaults, as in the JAX package), BERT
  otherwise; pretrained weights come from local files through
  ``models/pretrained.py``.  The sentence embedding is BERT's pooler
  output for a BERT name, the masked mean of the sequence output for any
  other (MPNet).

``transform_embedding`` adds the two-layer head fc1, ReLU, fc2 at
``txt_enc_dim``.  :func:`load_glove_matrix`, :func:`load_word_dict` and
:func:`glove_text_encoder_params` are the JAX module's GloVe helpers; as
there, the training CLI does not call them (``MODEL.TEXTUAL.LOAD_GLOVE``
reaches no code).
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clip_lite_torch.models.bert import BertModel, masked_mean_pooling
from clip_lite_torch.models.mpnet import MPNetModel
from clip_lite_torch.ops.layers import Linear, StepRNG

MODES = ("glove", "sbert", "train_sbert", "finetune_sbert")
SBERT_DIM = 768


class TextEncoder(nn.Module):
    def __init__(self, mode: str = "train_sbert",
                 transform_embedding: bool = False, txt_enc_dim: int = 512,
                 model_name: str = "bert-base-uncased",
                 num_hidden_layers: int = 12, vocab_size: int = 30522,
                 compute_dtype: torch.dtype = torch.float32,
                 fused_attention: str = "auto",
                 transformer_dropout: float = 0.1, hidden_size: int = 768,
                 glove_dim: int = 300, glove_vocab_size: int = 400002,
                 train_embeddings: bool = False):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"Unknown text encoder mode {mode!r}")
        self.mode = mode
        self.train_embeddings = train_embeddings
        self.mean_pooling = False
        if mode == "glove":
            self.embedding = nn.Embedding(glove_vocab_size, glove_dim)
            width = glove_dim
        elif mode == "sbert":
            width = SBERT_DIM
        elif "mpnet" in model_name:
            self.transformer = MPNetModel(
                num_hidden_layers=num_hidden_layers, compute_dtype=compute_dtype,
                fused_attention=fused_attention, dropout_rate=transformer_dropout)
            width = self.transformer.hidden_size
        else:
            h = hidden_size
            self.transformer = BertModel(
                vocab_size=vocab_size, hidden_size=h, num_heads=max(1, h // 64),
                intermediate_size=4 * h, num_hidden_layers=num_hidden_layers,
                compute_dtype=compute_dtype, fused_attention=fused_attention,
                dropout_rate=transformer_dropout)
            width = h
        if mode in ("train_sbert", "finetune_sbert"):
            self.mean_pooling = not ("bert" in model_name
                                     and "mpnet" not in model_name)
        self.transform_embedding = transform_embedding
        if transform_embedding:
            self.fc1 = Linear(width, txt_enc_dim)
            self.fc2 = Linear(txt_enc_dim, txt_enc_dim)
        self.feature_size = txt_enc_dim if transform_embedding else width

    def init_weights(self, generator: torch.Generator) -> None:
        if self.mode == "glove":  # flax nn.Embed's: N(0, 1 / dim)
            dim = self.embedding.embedding_dim
            nn.init.normal_(self.embedding.weight.data, 0.0, dim ** -0.5,
                            generator=generator)

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[StepRNG] = None) -> torch.Tensor:
        """batch by mode: glove ``caption_tokens`` (B, L) int; sbert
        ``caption_encodings`` (B, 768) float; otherwise ``input_ids`` and
        ``attention_mask`` (B, L) int.  Returns the (B, feature_size) fp32
        sentence embedding.  ``rng``: the step's draws, which dropout needs
        in training."""
        if self.mode == "glove":
            x = self.embedding(batch["caption_tokens"].long())
            if not self.train_embeddings:
                x = x.detach()
            x = x.float().mean(dim=1)
        elif self.mode == "sbert":
            x = batch["caption_encodings"].float()
        else:
            seq, pooled = self.transformer(
                batch["input_ids"], attention_mask=batch.get("attention_mask"),
                rng=rng)
            x = (masked_mean_pooling(seq, batch["attention_mask"])
                 if self.mean_pooling else pooled)
        if self.transform_embedding:
            x = self.fc2(F.relu(self.fc1(x)))
        return x.float()


def load_glove_matrix(glove_path: str, word_dict: dict,
                      seed: int = 0) -> np.ndarray:
    """The (len(word_dict), dim) float32 table: a word's GloVe vector where
    the text file has it, N(0, 0.6) from ``RandomState(seed)`` otherwise,
    drawn in the dictionary's order (the JAX helper's draws)."""
    glove = {}
    dim = None
    with open(glove_path, "r") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            glove[parts[0]] = np.asarray(parts[1:], dtype=np.float32)
            dim = len(parts) - 1
    rng = np.random.RandomState(seed)
    matrix = np.zeros((len(word_dict), dim), dtype=np.float32)
    for word, idx in word_dict.items():
        vec = glove.get(word)
        matrix[idx] = vec if vec is not None else rng.normal(
            scale=0.6, size=(dim,))
    return matrix


def glove_text_encoder_params(state_dict: Dict[str, torch.Tensor],
                              matrix: np.ndarray,
                              prefix: str = "") -> Dict[str, torch.Tensor]:
    """A shallow copy of ``state_dict`` (a glove TextEncoder's, or a whole
    model's with ``prefix`` ``"text_encoder."``) with the embedding table
    replaced by ``matrix``."""
    out = dict(state_dict)
    key = f"{prefix}embedding.weight"
    if key not in out:
        raise KeyError(f"{key}: not a glove text tower's state_dict")
    if tuple(out[key].shape) != tuple(matrix.shape):
        raise ValueError(f"{key} is {tuple(out[key].shape)}, the matrix "
                         f"{tuple(matrix.shape)}")
    out[key] = torch.as_tensor(np.asarray(matrix, np.float32),
                               device=out[key].device)
    return out


def load_word_dict(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
