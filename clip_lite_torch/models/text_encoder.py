"""Text tower wrapper, the counterpart of the JAX package's
``models/text_encoder.py``.

The ``train_sbert`` and ``finetune_sbert`` modes build a transformer
trained from scratch (pretrained weights come through ``bridge.py``):
MPNet for a ``model_name`` that contains ``"mpnet"`` (768 wide, its
vocabulary and width fixed by ``MPNetModel``'s defaults, as in the JAX
package), BERT otherwise.  The sentence embedding is BERT's pooler output
for a BERT name, the masked mean of the sequence output for any other
(MPNet).  ``transform_embedding`` adds the two-layer head fc1, ReLU, fc2
at ``txt_enc_dim``.  The ``glove`` and precomputed ``sbert`` modes, with
their word dictionaries and sentence vectors, wait for ROADMAP Queue 1,
item 7.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from clip_lite_torch.models.bert import BertModel, masked_mean_pooling
from clip_lite_torch.models.mpnet import MPNetModel
from clip_lite_torch.ops.layers import Linear, StepRNG


class TextEncoder(nn.Module):
    def __init__(self, mode: str = "train_sbert",
                 transform_embedding: bool = False, txt_enc_dim: int = 512,
                 model_name: str = "bert-base-uncased",
                 num_hidden_layers: int = 12, vocab_size: int = 30522,
                 compute_dtype: torch.dtype = torch.float32,
                 fused_attention: str = "auto",
                 transformer_dropout: float = 0.1, hidden_size: int = 768):
        super().__init__()
        if mode not in ("train_sbert", "finetune_sbert"):
            raise NotImplementedError(
                f"text mode {mode!r} is not ported yet: glove and precomputed "
                "sbert, with their word dictionaries and sentence vectors, "
                "wait for ROADMAP Queue 1, item 7")
        if "mpnet" in model_name:
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
        self.mean_pooling = not ("bert" in model_name and "mpnet" not in model_name)
        self.transform_embedding = transform_embedding
        if transform_embedding:
            self.fc1 = Linear(width, txt_enc_dim)
            self.fc2 = Linear(txt_enc_dim, txt_enc_dim)
        self.feature_size = txt_enc_dim if transform_embedding else width

    def forward(self, batch: Dict[str, torch.Tensor],
                rng: Optional[StepRNG] = None) -> torch.Tensor:
        """batch: input_ids, attention_mask (B, L) int.  Returns the
        (B, feature_size) fp32 sentence embedding.  ``rng``: the step's
        draws, which dropout needs in training."""
        seq, pooled = self.transformer(batch["input_ids"],
                                       attention_mask=batch.get("attention_mask"),
                                       rng=rng)
        x = (masked_mean_pooling(seq, batch["attention_mask"])
             if self.mean_pooling else pooled)
        if self.transform_embedding:
            x = self.fc2(F.relu(self.fc1(x)))
        return x.float()
