"""MPNet text tower, the counterpart of the JAX package's ``models/mpnet.py``.

The reference's alternative text transformer (``MPNetConfig()`` defaults:
768 wide, 12 layers of 12 heads, FFN 3072, vocab 30527, 514 positions),
trained from scratch.  What sets it apart from BERT:

- position ids that skip the pad token 1, RoBERTa-style; no token types;
- one relative position bias table (32 T5 buckets, max distance 128, one
  value per head) shared by all layers, added with the padding bias into a
  full (B, NH, S, S) fp32 score bias that is built once per forward; the
  attention kernels take it whole, and K2 returns its gradient;
- LayerNorm eps 1e-5; the sentence embedding is the masked mean of the
  sequence output (``models/text_encoder.py``), so the pooler runs but
  gets no gradient.

The JAX package's ``MPNetLayer`` computes what the port's
:class:`~clip_lite_torch.models.bert.BertLayer` does (fp32 LayerNorm and
exact GELU, each rounded once to the compute type) under the full bias,
so its layers are ``BertLayer`` at eps 1e-5.  Module and parameter names
follow the flax tree, so ``bridge.convert`` maps it.  Dropout follows
BERT's (:class:`StepRNG` draws).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from clip_lite_torch.models.bert import BertLayer, _dense, bert_dense_init
from clip_lite_torch.ops.attention import MASK_VALUE
from clip_lite_torch.ops.layers import LayerNorm, StepRNG, dropout


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """T5-style signed log buckets of ``memory - query`` positions
    (``mpnet.py:28-45`` of the JAX package), with the same fp32 ``log``
    and truncation."""
    n = -relative_position
    num_buckets //= 2
    ret = (n < 0).long() * num_buckets
    n = n.abs()
    max_exact = num_buckets // 2
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).long()
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_if_large)


@functools.lru_cache(maxsize=None)
def relative_bucket_grid(seq: int, num_buckets: int,
                         device: torch.device) -> torch.Tensor:
    """The (seq, seq) bucket of every (query, key) pair on ``device``,
    computed once on the host: the device's ``log`` never decides a
    bucket, and no step copies it again.  Built outside inference mode,
    so that training may index with it after serving cached it."""
    with torch.inference_mode(False):
        pos = torch.arange(seq)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                           num_buckets)
        return buckets.to(device)


class MPNetModel(nn.Module):
    """Returns (sequence_output fp32, pooled_output fp32)."""

    def __init__(self, vocab_size: int = 30527, hidden_size: int = 768,
                 num_hidden_layers: int = 12, num_heads: int = 12,
                 intermediate_size: int = 3072, max_position: int = 514,
                 pad_token_id: int = 1, relative_attention_num_buckets: int = 32,
                 dropout_rate: float = 0.1, layer_norm_eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32,
                 fused_attention: str = "auto"):
        super().__init__()
        self.hidden_size = hidden_size
        self.pad_token_id = pad_token_id
        self.num_buckets = relative_attention_num_buckets
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        self.word = nn.Embedding(vocab_size, hidden_size)
        self.position = nn.Embedding(max_position, hidden_size)
        self.emb_ln = LayerNorm(hidden_size, layer_norm_eps)
        self.relative_attention_bias = nn.Embedding(
            relative_attention_num_buckets, num_heads)
        self.layer_names: List[str] = []
        for i in range(num_hidden_layers):
            self.add_module(f"layer_{i}", BertLayer(
                hidden_size, num_heads, intermediate_size, dropout_rate,
                layer_norm_eps, compute_dtype, fused_attention))
            self.layer_names.append(f"layer_{i}")
        self.pooler = _dense(hidden_size, hidden_size, torch.float32)

    def init_weights(self, generator: torch.Generator) -> None:
        for emb in (self.word, self.position, self.relative_attention_bias):
            bert_dense_init(emb.weight.data, generator)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                rng: Optional[StepRNG] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        b, s = input_ids.shape
        # Pad stays at pad_token_id; real tokens count up from it + 1.
        not_pad = (input_ids != self.pad_token_id).long()
        position_ids = torch.cumsum(not_pad, dim=1) * not_pad + self.pad_token_id
        x = self.emb_ln(self.word(input_ids) + self.position(position_ids))
        rate = self.dropout_rate if self.training else 0.0
        x = dropout(x, rate, rng).to(self.compute_dtype).view(b * s, -1)

        # (1, NH, S, S) relative bias + (B, 1, 1, S) padding bias: one
        # contiguous (B, NH, S, S) tensor shared by every layer, so autograd
        # sums the layers' dbias into the table.  The sum takes the layout
        # of its inputs, so the permuted table is made contiguous first.
        buckets = relative_bucket_grid(s, self.num_buckets, input_ids.device)
        rel = self.relative_attention_bias(buckets).permute(2, 0, 1)
        rel = rel.contiguous()[None]
        pad = (1.0 - attention_mask.float())[:, None, None, :] * MASK_VALUE
        bias = rel + pad
        for name in self.layer_names:
            x = getattr(self, name)(x, bias, rng)
        sequence_output = x.view(b, s, self.hidden_size).float()
        pooled = torch.tanh(self.pooler(sequence_output[:, 0]))
        return sequence_output, pooled
