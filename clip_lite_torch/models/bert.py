"""BERT text tower, the counterpart of the JAX package's ``models/bert.py``.

Same architecture contract: embeddings (word + position + token type,
LayerNorm eps 1e-12), a fused (H, 3H) QKV projection, the token-flattened
(B*S, H) encoder stack, exact GELU, post-LN residual blocks and a tanh
pooler over the first token.  Padding enters as the additive key bias
``(1 - mask) * MASK_VALUE``.  Dense layers and embeddings are initialised
N(0, 0.02) with zero biases.  Module names follow the JAX parameter tree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clip_lite_torch.ops.attention import (
    MASK_VALUE,
    attention_reference,
    fused_short_attention,
    resolve_fused_flag,
)
from clip_lite_torch.ops.layers import LayerNorm, Linear, normal_init, zeros_init

bert_dense_init = normal_init(0.02)


def _dense(in_features: int, out_features: int,
           compute_dtype: torch.dtype) -> Linear:
    return Linear(in_features, out_features, compute_dtype=compute_dtype,
                  weight_init=bert_dense_init, bias_init=zeros_init)


class BertEmbeddings(nn.Module):
    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 max_position: int = 512, type_vocab_size: int = 2,
                 dropout_rate: float = 0.1, layer_norm_eps: float = 1e-12,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.word = nn.Embedding(vocab_size, hidden_size)
        self.position = nn.Embedding(max_position, hidden_size)
        self.token_type = nn.Embedding(type_vocab_size, hidden_size)
        self.ln = LayerNorm(hidden_size, layer_norm_eps)
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype

    def init_weights(self, generator: torch.Generator) -> None:
        for emb in (self.word, self.position, self.token_type):
            bert_dense_init(emb.weight.data, generator)

    def forward(self, input_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        s = input_ids.shape[1]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(s, device=input_ids.device)[None, :]
        x = self.word(input_ids) + self.position(pos) + self.token_type(
            token_type_ids)
        x = F.dropout(self.ln(x), self.dropout_rate, self.training)
        return x.to(self.compute_dtype)


class BertLayer(nn.Module):
    def __init__(self, hidden_size: int = 768, num_heads: int = 12,
                 intermediate_size: int = 3072, dropout_rate: float = 0.1,
                 layer_norm_eps: float = 1e-12,
                 compute_dtype: torch.dtype = torch.float32,
                 fused_attention: str = "auto"):
        super().__init__()
        h, dt = hidden_size, compute_dtype
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.compute_dtype = dt
        self.fused_attention = fused_attention
        self.qkv = _dense(h, 3 * h, dt)
        self.attn_out = _dense(h, h, dt)
        self.attn_ln = LayerNorm(h, layer_norm_eps, dt)
        self.intermediate = _dense(h, intermediate_size, dt)
        self.output = _dense(intermediate_size, h, dt)
        self.out_ln = LayerNorm(h, layer_norm_eps, dt)

    def forward(self, x: torch.Tensor, mask_bias: torch.Tensor) -> torch.Tensor:
        """x: (B*S, H); mask_bias: (B, S) fp32."""
        b, s = mask_bias.shape
        h = x.shape[-1]
        rate = self.dropout_rate if self.training else 0.0
        xin = x.to(self.compute_dtype)
        qkv = self.qkv(xin).view(b, s, 3 * h)
        if resolve_fused_flag(self.fused_attention, qkv.device):
            ctx = fused_short_attention(qkv, mask_bias, self.num_heads,
                                        dropout_rate=rate,
                                        deterministic=not self.training)
        else:
            ctx = attention_reference(qkv, mask_bias, self.num_heads, rate)
        attn = F.dropout(self.attn_out(ctx.view(b * s, h)), rate, self.training)
        x = self.attn_ln(xin + attn)
        inter = F.gelu(self.intermediate(x))
        out = F.dropout(self.output(inter), rate, self.training)
        return self.out_ln(x + out)


class BertModel(nn.Module):
    """Returns (sequence_output fp32, pooled_output fp32)."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 num_hidden_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, max_position: int = 512,
                 type_vocab_size: int = 2, dropout_rate: float = 0.1,
                 layer_norm_eps: float = 1e-12,
                 compute_dtype: torch.dtype = torch.float32,
                 add_pooler: bool = True, fused_attention: str = "auto"):
        super().__init__()
        self.hidden_size = hidden_size
        self.embeddings = BertEmbeddings(
            vocab_size, hidden_size, max_position, type_vocab_size,
            dropout_rate, layer_norm_eps, compute_dtype)
        self.layer_names = []
        for i in range(num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(
                hidden_size, num_heads, intermediate_size, dropout_rate,
                layer_norm_eps, compute_dtype, fused_attention))
            self.layer_names.append(f"layer_{i}")
        self.pooler = (_dense(hidden_size, hidden_size, torch.float32)
                       if add_pooler else None)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        mask_bias = (1.0 - attention_mask.float()) * MASK_VALUE
        b, s = input_ids.shape
        x = self.embeddings(input_ids, token_type_ids).view(b * s, -1)
        for name in self.layer_names:
            x = getattr(self, name)(x, mask_bias)
        sequence_output = x.view(b, s, self.hidden_size).float()
        pooled = None
        if self.pooler is not None:
            pooled = torch.tanh(self.pooler(sequence_output[:, 0]))
        return sequence_output, pooled
