"""Tokenizers: a Hugging Face tokenizer when one is cached locally, else a
deterministic hashing tokenizer with BERT's special-token contract.

Own copy of the JAX package's ``HashingTokenizer`` and
``get_hf_tokenizer``: the same captions give the same ids in both
packages.  ``transformers`` is optional and never reaches the network.
"""

from __future__ import annotations

import hashlib
import logging
import re
from typing import List, Optional

logger = logging.getLogger("clip_lite_torch")

_WORD_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?")


def simple_word_tokenize(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


class HashingTokenizer:
    """Deterministic offline stand-in for a WordPiece tokenizer.

    PAD=0, UNK=100, CLS=101, SEP=102; words hash (md5) into
    [999, vocab_size), or [103, vocab_size) for a vocab of 999 or less.
    """

    pad_token_id = 0
    cls_token_id = 101
    sep_token_id = 102

    def __init__(self, vocab_size: int = 30522, max_length: int = 30):
        if vocab_size < 104:
            raise ValueError(
                f"vocab_size {vocab_size} < 104 cannot hold the BERT "
                "special tokens (PAD=0, UNK=100, CLS=101, SEP=102)")
        self.vocab_size = vocab_size
        self.max_length = max_length
        self._word_base = 999 if vocab_size > 999 else 103

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return self._word_base + (h % (self.vocab_size - self._word_base))

    def __call__(self, text, padding="max_length", truncation=True,
                 max_length: Optional[int] = None, **kw) -> dict:
        max_length = max_length or self.max_length
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        all_ids, all_masks = [], []
        for t in texts:
            ids = [self.cls_token_id]
            ids += [self._word_id(w) for w in simple_word_tokenize(t)]
            ids = ids[: max_length - 1] + [self.sep_token_id]
            mask = [1] * len(ids)
            pad = max_length - len(ids)
            all_ids.append(ids + [self.pad_token_id] * pad)
            all_masks.append(mask + [0] * pad)
        if single:
            return {"input_ids": all_ids[0], "attention_mask": all_masks[0]}
        return {"input_ids": all_ids, "attention_mask": all_masks}


def get_hf_tokenizer(name: str = "bert-base-uncased", max_length: int = 30,
                     vocab_size: Optional[int] = None):
    """The HF tokenizer ``name`` if it is in the local cache, else a
    :class:`HashingTokenizer` whose ids stay inside ``vocab_size`` (the
    model's embedding table, MODEL.TEXTUAL.VOCAB_SIZE)."""
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
    except (ImportError, OSError, ValueError):
        logger.warning("HF tokenizer %r is not in the local cache; using the "
                       "deterministic HashingTokenizer.", name)
        return HashingTokenizer(vocab_size=vocab_size or 30522,
                                max_length=max_length)
    tok.model_max_length = max_length
    if vocab_size is not None and tok.vocab_size > vocab_size:
        raise ValueError(
            f"Tokenizer {name!r} has vocab {tok.vocab_size} > "
            f"MODEL.TEXTUAL.VOCAB_SIZE {vocab_size}; raise "
            f"MODEL.TEXTUAL.VOCAB_SIZE to at least {tok.vocab_size}.")
    return tok
