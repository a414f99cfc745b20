"""Tokenizers: a Hugging Face tokenizer when one is cached locally, else a
deterministic hashing tokenizer with BERT's special-token contract; the
word-dictionary tokenizer of the glove text mode; SentencePiece BPE; and
CLIP's byte-level BPE (``ClipBPETokenizer``, for ``retrieval
--weight-init clip``).

Own copy of the JAX package's ``GloveTokenizer``, ``HashingTokenizer``,
``SentencePieceBPETokenizer`` and ``get_hf_tokenizer``: the same captions
give the same ids in both packages.  ``transformers`` is optional and
never reaches the network; ``ClipBPETokenizer`` gives what transformers'
``CLIPTokenizerFast`` gives, without it.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import unicodedata
from typing import List, Optional

import numpy as np

logger = logging.getLogger("clip_lite_torch")

_WORD_RE = re.compile(r"[a-z0-9]+(?:'[a-z]+)?")


def simple_word_tokenize(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


class GloveTokenizer:
    """A word dictionary's tokenizer (``word_dict.json``, from
    ``scripts/generate_word_dict.py``, or ``word_dict`` itself): word ->
    id, an unknown word -> ``<unk>``; the specials ``<start>``, ``<eos>``,
    ``<unk>`` and ``<pad>`` are appended, in that order, where the
    dictionary lacks them."""

    def __init__(self, word_dict_path: Optional[str] = None,
                 word_dict: Optional[dict] = None):
        if word_dict is None:
            with open(word_dict_path) as f:
                word_dict = json.load(f)
        self.word_dict = word_dict
        for special in ("<start>", "<eos>", "<unk>", "<pad>"):
            if special not in self.word_dict:
                self.word_dict[special] = len(self.word_dict)

    def __len__(self) -> int:
        return len(self.word_dict)

    def token_to_id(self, token: str) -> int:
        return self.word_dict.get(token, self.word_dict["<unk>"])

    def encode(self, caption: str) -> List[int]:
        return [self.token_to_id(w) for w in simple_word_tokenize(caption)]

    def decode(self, ids: List[int]) -> str:
        rev = {v: k for k, v in self.word_dict.items()}
        return " ".join(rev.get(i, "<unk>") for i in ids)

    @property
    def pad_id(self) -> int:
        return self.word_dict["<pad>"]


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


class SentencePieceBPETokenizer:
    """SentencePiece BPE tokenizer (the JAX package's ``data/tokenizers.py:116-160``).

    Pickle-safe: the processor re-opens lazily after fork/pickle.  The
    sentencepiece package is optional in this environment; constructing
    without it raises with instructions.
    """

    SP_SPACE = "▁"

    def __init__(self, model_path: str):
        self.model_path = model_path
        self._sp = None

    def _processor(self):
        if self._sp is None:
            try:
                import sentencepiece as sp
            except ImportError as e:
                raise ImportError(
                    "SentencePieceBPETokenizer needs the sentencepiece "
                    "package (not in this environment); use GloveTokenizer "
                    "or an HF tokenizer instead.") from e
            self._sp = sp.SentencePieceProcessor()
            self._sp.Load(self.model_path)
        return self._sp

    def __len__(self):
        return self._processor().get_piece_size()

    def token_to_id(self, token: str) -> int:
        return self._processor().piece_to_id(token)

    def id_to_token(self, idx: int) -> str:
        return self._processor().id_to_piece(idx)

    def encode(self, text: str) -> List[int]:
        return self._processor().encode_as_ids(" " + text.strip())

    def decode(self, ids: List[int]) -> str:
        pieces = [self.id_to_token(i) for i in ids]
        return "".join(pieces).replace(self.SP_SPACE, " ").strip()

    def __getstate__(self):
        return {"model_path": self.model_path}

    def __setstate__(self, state):
        self.__init__(state["model_path"])


def bytes_to_unicode() -> dict:
    """GPT-2's byte-level alphabet: each byte -> a printable character
    (the printable Latin-1 bytes map to themselves, the others to code
    points from 256 up)."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    chars, extra = list(keep), 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + extra)
            extra += 1
    return dict(zip(keep, map(chr, chars)))


# Unicode's White_Space property: what the fast tokenizer's \s matches.
_WHITE_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f"
                         "\u205f\u3000" + "".join(map(chr, range(0x2000, 0x200B))))
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(c: str) -> str:
    """'L' (a letter), 'N' (a number), ' ' (white space) or '' (other)."""
    if c in _WHITE_SPACE:
        return " "
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else ""


def clip_normalize(text: str) -> str:
    """The CLIP fast tokenizer's normalizer: NFC, each run of white space
    to one space, lowercase."""
    text = unicodedata.normalize("NFC", text)
    text = "".join(" " if c in _WHITE_SPACE else c for c in text)
    return re.sub(" +", " ", text).lower()


def clip_pretokenize(text: str) -> List[str]:
    """The CLIP fast tokenizer's pre-tokenizer on normalized text: the
    matches of ``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
    in order (the rest, white space, dropped).  The letter and number
    classes come from ``unicodedata``'s general categories."""
    words, i, n = [], 0, len(text)
    while i < n:
        kind = _char_class(text[i])
        contraction = next((c for c in _CONTRACTIONS
                            if text.startswith(c, i)), None)
        if contraction:
            j = i + len(contraction)
        elif kind == " ":
            i += 1
            continue
        elif kind == "N":
            j = i + 1
        else:  # a run of letters, or of what is neither
            j = i + 1
            while j < n and _char_class(text[j]) == kind:
                j += 1
        words.append(text[i:j])
        i = j
    return words


def _special(files: List[dict], name: str, default: str) -> str:
    for tokens in files:
        value = tokens.get(name)
        if isinstance(value, dict):
            value = value.get("content")
        if isinstance(value, str):
            return value
    return default


class ClipBPETokenizer:
    """CLIP's byte-level BPE tokenizer, read from a local transformers
    directory (``vocab.json``, ``merges.txt``, and the special tokens of
    ``special_tokens_map.json`` or ``tokenizer_config.json``): what
    ``CLIPTokenizerFast`` gives with ``padding="max_length",
    truncation=True, max_length=77``, without transformers or ``regex``.
    Text goes through :func:`clip_normalize`; the special tokens written
    in it become their ids (the fast tokenizer matches its added tokens
    on normalized text); the rest goes through :func:`clip_pretokenize`,
    each word's UTF-8 bytes through :func:`bytes_to_unicode`, with
    ``</w>`` on its last symbol, then BPE merges in rank order (GPT-2's
    rule), a symbol outside the vocabulary as the unknown token; at most
    ``max_length - 2`` ids kept, between the start and end tokens, then
    the pad token to ``max_length``."""

    def __init__(self, path: str, max_length: int = 77):
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            self.vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = [tuple(line.split()) for line in f.read().split("\n")
                      if line and not line.startswith("#version")]
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        files = []
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            if os.path.exists(os.path.join(path, name)):
                with open(os.path.join(path, name), encoding="utf-8") as f:
                    files.append(json.load(f))
        eot = "<|endoftext|>"
        specials = {name: _special(files, f"{name}_token", default)
                    for name, default in (("bos", "<|startoftext|>"),
                                          ("eos", eot), ("pad", eot),
                                          ("unk", eot))}
        self.bos_token_id, self.eos_token_id, self.pad_token_id, \
            self.unk_token_id = (self.vocab[specials[k]]
                                 for k in ("bos", "eos", "pad", "unk"))
        self.special_ids = {t: self.vocab[t] for t in specials.values()}
        self._special_re = re.compile("(" + "|".join(
            map(re.escape, sorted(self.special_ids, key=len, reverse=True)))
            + ")")
        self.max_length = max_length
        self.byte_char = bytes_to_unicode()
        self._cache: dict = {}

    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        symbols = list(word[:-1]) + [word[-1] + "</w>"]
        while len(symbols) > 1:
            pairs = set(zip(symbols, symbols[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(symbols):
                if i + 1 < len(symbols) and (symbols[i], symbols[i + 1]) == best:
                    merged.append(symbols[i] + symbols[i + 1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        self._cache[word] = symbols
        return symbols

    def encode(self, text: str) -> List[int]:
        """The ids of ``text``, without the start and end tokens."""
        ids = []
        for part in self._special_re.split(clip_normalize(text)):
            if part in self.special_ids:
                ids.append(self.special_ids[part])
                continue
            for word in clip_pretokenize(part):
                chars = "".join(self.byte_char[b] for b in word.encode("utf-8"))
                ids += [self.vocab.get(t, self.unk_token_id)
                        for t in self._bpe(chars)]
        return ids

    def __call__(self, texts: List[str]) -> dict:
        """``input_ids`` and ``attention_mask``, (N, max_length) int64."""
        n = self.max_length
        ids = np.full((len(texts), n), self.pad_token_id, np.int64)
        mask = np.zeros((len(texts), n), np.int64)
        for row, text in enumerate(texts):
            tokens = ([self.bos_token_id] + self.encode(text)[:n - 2]
                      + [self.eos_token_id])
            ids[row, :len(tokens)] = tokens
            mask[row, :len(tokens)] = 1
        return {"input_ids": ids, "attention_mask": mask}


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
