"""Text tower wrapper, the counterpart of the JAX package's
``models/text_encoder.py``.

This slice ports the ``train_sbert`` BERT path: a BERT trained from
scratch whose sentence embedding is the pooler output.  The other modes
(``glove``, precomputed ``sbert``, MPNet, the TRANSFORM head) are queued
in ROADMAP.md (Queue 1, "The rest of the model matrix").
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from clip_lite_torch.models.bert import BertModel


class TextEncoder(nn.Module):
    def __init__(self, mode: str = "train_sbert",
                 transform_embedding: bool = False,
                 model_name: str = "bert-base-uncased",
                 num_hidden_layers: int = 12, vocab_size: int = 30522,
                 compute_dtype: torch.dtype = torch.float32,
                 fused_attention: str = "auto",
                 transformer_dropout: float = 0.1, hidden_size: int = 768):
        super().__init__()
        if mode not in ("train_sbert", "finetune_sbert") or "mpnet" in model_name \
                or transform_embedding:
            raise NotImplementedError(
                f"text mode {mode!r} / {model_name!r} (transform="
                f"{transform_embedding}) is not ported yet: only the BERT "
                "train_sbert path is (ROADMAP Queue 1, the rest of the "
                "model matrix)")
        h = hidden_size
        self.transformer = BertModel(
            vocab_size=vocab_size, hidden_size=h, num_heads=max(1, h // 64),
            intermediate_size=4 * h, num_hidden_layers=num_hidden_layers,
            compute_dtype=compute_dtype, fused_attention=fused_attention,
            dropout_rate=transformer_dropout)
        self.feature_size = h

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """batch: input_ids, attention_mask (B, L) int.  Returns the
        (B, hidden) fp32 pooler output."""
        _, pooled = self.transformer(batch["input_ids"],
                                     attention_mask=batch.get("attention_mask"))
        return pooled
