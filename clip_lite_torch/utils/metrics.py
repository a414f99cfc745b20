"""Evaluation metrics, the port's copy of the JAX package's
``utils/metrics.py``: the streaming top-k accuracy of the classification
evals, and the captioning scorers: a pure-Python PTB3 tokenizer
(``ptb3_tokens``, ``ptb_tokenize``), CIDEr-D (``CiderScorer``), SPICE
through the official Java scorer as a subprocess (``spice_score``, which
raises unless ``spice_available()``: a JVM and the jar named by
``CLIP_LITE_SPICE_JAR``), and ``CocoCaptionsEvaluator``, which reports
``"SPICE": None`` where the Java toolchain is absent.  No eval CLI of
either package calls the captioning scorers.
"""

from __future__ import annotations

import math
import os
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

import numpy as np


class TopkAccuracy:
    """Streaming top-k accuracy over (logits, labels) batches, in percent."""

    def __init__(self, top_k: int = 1):
        self.top_k = top_k
        self.reset()

    def reset(self) -> None:
        self.num_correct = 0
        self.num_total = 0

    def __call__(self, predictions, labels) -> None:
        predictions = np.asarray(predictions)
        labels = np.asarray(labels)
        if self.top_k == 1:
            top = predictions.argmax(-1)[..., None]
        else:
            top = np.argpartition(-predictions, self.top_k - 1,
                                  axis=-1)[..., : self.top_k]
        correct = (top == labels[..., None]).any(-1)
        self.num_correct += int(correct.sum())
        self.num_total += int(correct.size)

    def get_metric(self, reset: bool = False) -> float:
        value = 100.0 * self.num_correct / max(1, self.num_total)
        if reset:
            self.reset()
        return value


# Tokens the reference strips after tokenizing (reference:
# utils/metrics.py:166-171).  Quirk preserved EXACTLY: the list holds
# UPPERCASE bracket escapes ("-LRB-", ...) while `-lowerCase` output is
# lowercase ("-lrb-"), so bracket escapes are never actually stripped by
# the reference either.
_REF_PUNCTS = frozenset([
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-", ".", "?",
    "!", ",", ":", "-", "--", "...", ";",
])

_QUOTE_MAP = {"‘": "'", "’": "'", "“": '"', "”": '"',
              "…": "...", "–": "--", "—": "--"}
_BRACKETS = {"(": "-lrb-", ")": "-rrb-", "[": "-lsb-", "]": "-rsb-",
             "{": "-lcb-", "}": "-rcb-"}

# Assimilated forms split by the Penn Treebank tokenizer (the classic
# tokenizer.sed list; CoreNLP's splitAssimilations covers the same set).
_ASSIM = {"cannot": ("can", "not"), "gonna": ("gon", "na"),
          "gotta": ("got", "ta"), "wanna": ("wan", "na"),
          "lemme": ("lem", "me"), "gimme": ("gim", "me"),
          "d'ye": ("d'", "ye"), "more'n": ("more", "'n"),
          "'tis": ("'t", "is"), "'twas": ("'t", "was")}

_CONTRACTION = re.compile(r"(?<=[a-z])(n't|'ll|'re|'ve|'s|'m|'d)$")


def ptb3_tokens(caption: str) -> List[str]:
    """Penn-Treebank-3 tokenization of one caption, lowercased —
    a pure-Python reimplementation of what the reference gets from
    ``PTBTokenizer -preserveLines -lowerCase`` via the CoreNLP jar
    (reference: utils/metrics.py:129-160): bracket escaping to
    -lrb-/-rrb-/..., directional-quote conversion to \\`\\`/'', clitic
    splits (n't 'll 're 've 's 'm 'd), treebank assimilation splits,
    number-internal commas/colons kept whole (1,000 / 3:30), final
    sentence period split off, ellipsis as one token.

    Validated against a frozen golden set of CoreNLP-tokenized
    caption-style sentences (tests/test_metrics.py) — the round-4
    "tokenizer caveat" closure.  Known non-COCO divergences, accepted:
    no americanization (colour -> color) and no sentence-final
    abbreviation handling (both absent from caption text).
    """
    s = caption.lower().replace("\n", " ")
    for src, dst in _QUOTE_MAP.items():
        s = s.replace(src, dst)
    # Directional double quotes: opening after start/space/open-bracket.
    s = re.sub(r'(^|[ \(\[{])"', r"\1 `` ", s)
    s = s.replace('"', " '' ")
    for src, dst in _BRACKETS.items():
        s = s.replace(src, f" {dst} ")
    s = s.replace("...", " ... ")
    # Always-separated symbols.
    s = re.sub(r"[?!]", r" \g<0> ", s)
    s = re.sub(r"[;@#$&]", r" \g<0> ", s)
    s = s.replace("--", " -- ")
    # Comma / colon separate EXCEPT between digits (1,000 / 3:30 whole).
    s = re.sub(r"(?<!\d),|,(?!\d)", " , ", s)
    s = re.sub(r"(?<!\d):|:(?!\d)", " : ", s)
    s = re.sub(r"(\d)%", r"\1 % ", s)

    out: List[str] = []
    words = s.split()
    for i, w in enumerate(words):
        last = i == len(words) - 1
        out.extend(_split_word(w, sentence_final=last))
    return out


def _split_word(w: str, sentence_final: bool) -> List[str]:
    """Split one whitespace-delimited chunk into PTB tokens."""
    if not w:
        return []
    if w in ("''", "``", "--", "...", "-") or w in _BRACKETS.values():
        return [w]
    if w in _ASSIM:
        return list(_ASSIM[w])
    # Trailing sentence period: split off unless the word carries
    # internal periods (u.s., e.g.) or is pure periods already.
    if w.endswith(".") and w != "." and "." not in w[:-1]:
        return _split_word(w[:-1], False) + ["."]
    # Possessive-after-s / bare trailing apostrophe: dogs' -> dogs '
    if w.endswith("'") and len(w) > 1:
        return _split_word(w[:-1], False) + ["'"]
    m = _CONTRACTION.search(w)
    if m and len(w) > len(m.group(1)):
        return [w[: m.start()], m.group(1)]
    return [w]


def ptb_tokenize(caption: str) -> List[str]:
    """PTB3 tokens with the reference's punctuation-token strip applied
    (reference: utils/metrics.py:166-178) — the token stream the CIDEr
    n-grams are computed over."""
    return [t for t in ptb3_tokens(caption) if t not in _REF_PUNCTS]


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1))


class CiderScorer:
    """CIDEr-D: tf-idf weighted n-gram cosine similarity with length
    penalty (Vedantam et al. 2015), n = 1..4, sigma = 6."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, ground_truth: Dict[str, List[str]],
                      predictions: Dict[str, List[str]]) -> float:
        """ground_truth/predictions: id -> list of captions (predictions
        have one). Returns mean CIDEr-D x 100 (reference scales by 100 in
        reporting)."""
        ids = list(predictions.keys())
        # Document frequencies over reference sets.
        doc_freq = [defaultdict(int) for _ in range(self.n)]
        gt_ngrams = {}
        for img_id in ids:
            per_ref = [
                [_ngrams(ptb_tokenize(ref), k + 1) for k in range(self.n)]
                for ref in ground_truth[img_id]
            ]
            gt_ngrams[img_id] = per_ref
            for k in range(self.n):
                seen = set()
                for ref in per_ref:
                    seen |= set(ref[k].keys())
                for g in seen:
                    doc_freq[k][g] += 1
        log_num_images = math.log(max(1, len(ids)))

        def tfidf_vec(counts_per_n, length):
            vecs, norms = [], []
            for k in range(self.n):
                vec = {}
                norm = 0.0
                for g, cnt in counts_per_n[k].items():
                    df = math.log(max(1.0, doc_freq[k][g]))
                    w = cnt * (log_num_images - df)
                    vec[g] = w
                    norm += w * w
                vecs.append(vec)
                norms.append(math.sqrt(norm))
            return vecs, norms

        scores = []
        for img_id in ids:
            cand_tokens = ptb_tokenize(predictions[img_id][0])
            cand_counts = [_ngrams(cand_tokens, k + 1) for k in range(self.n)]
            cand_vec, cand_norm = tfidf_vec(cand_counts, len(cand_tokens))

            img_score = np.zeros(self.n)
            for ref_counts in gt_ngrams[img_id]:
                ref_vec, ref_norm = tfidf_vec(ref_counts, None)
                ref_len = sum(ref_counts[0].values())
                delta = len(cand_tokens) - ref_len
                for k in range(self.n):
                    # CIDEr-D: clipped candidate counts in the dot product.
                    num = 0.0
                    for g, w in cand_vec[k].items():
                        if g in ref_vec[k]:
                            num += min(w, ref_vec[k][g]) * ref_vec[k][g]
                    if cand_norm[k] and ref_norm[k]:
                        sim = num / (cand_norm[k] * ref_norm[k])
                    else:
                        sim = 0.0
                    sim *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
                    img_score[k] += sim
            img_score /= max(1, len(gt_ngrams[img_id]))
            scores.append(10.0 * img_score.mean())  # CIDEr-D convention
        return 100.0 * float(np.mean(scores)) / 10.0


def spice_available(jar_path: str = None) -> bool:
    """Whether the SPICE scorer can run here: a JVM on PATH plus the
    SPICE jar (point ``CLIP_LITE_SPICE_JAR`` at spice-1.0.jar)."""
    import shutil

    jar = jar_path or os.environ.get("CLIP_LITE_SPICE_JAR", "")
    return bool(shutil.which("java")) and os.path.isfile(jar)


def spice_score(predictions: Dict[str, List[str]],
                ground_truth: Dict[str, List[str]],
                jar_path: str = None) -> float:
    """SPICE via the official Java scorer as a subprocess
    (reference: utils/metrics.py:271-310).  Requires a JVM and the jar
    (CLIP_LITE_SPICE_JAR); call :func:`spice_available` first — this
    raises RuntimeError when the toolchain is missing.
    """
    import json
    import subprocess
    import tempfile

    jar = jar_path or os.environ.get("CLIP_LITE_SPICE_JAR", "")
    if not spice_available(jar):
        raise RuntimeError(
            "SPICE needs a JVM and CLIP_LITE_SPICE_JAR=<spice-1.0.jar>")
    records = [{"image_id": k, "test": predictions[k][0],
                "refs": list(ground_truth[k])} for k in ground_truth]
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "in.json")
        outp = os.path.join(tmp, "out.json")
        cache = os.path.join(tmp, "cache")
        os.makedirs(cache, exist_ok=True)
        with open(inp, "w") as f:
            json.dump(records, f)
        subprocess.check_call(
            ["java", "-jar", "-Xmx8G", jar, inp, "-cache", cache,
             "-out", outp, "-subset", "-silent"])
        with open(outp) as f:
            results = json.load(f)
    return float(np.mean([float(item["scores"]["All"]["f"])
                          for item in results]))


class CocoCaptionsEvaluator:
    """Caption evaluation harness (reference: utils/metrics.py:76-126).

    Returns ``{"CIDEr": float, "SPICE": float | None, "tokenizer":
    "ptb3"}`` — the reference contract computes both scores; SPICE needs
    the Java toolchain (:func:`spice_available`), and when it is absent
    the key is reported as ``None`` (machine-readable "not computed")
    rather than dropped, so downstream result parsing keeps working
    either way.

    Captions are tokenized with :func:`ptb_tokenize` — a pure-Python
    PTB3 tokenizer matching the CoreNLP ``PTBTokenizer -preserveLines
    -lowerCase`` subprocess the reference shells out to, including its
    punctuation-strip protocol and its bracket-escape case quirk
    (reference: utils/metrics.py:129-178), pinned by a frozen golden set
    in tests/test_metrics.py.  Scores are protocol-comparable to
    reference-produced CIDEr numbers.
    """

    def __init__(self, ground_truth: Dict[str, List[str]],
                 spice_jar: str = None):
        self.ground_truth = {str(k): list(v) for k, v in ground_truth.items()}
        self.spice_jar = spice_jar

    def evaluate(self, preds: List[dict]) -> Dict[str, float]:
        """preds: [{"image_id": ..., "caption": str}, ...]"""
        predictions = {str(p["image_id"]): [p["caption"]] for p in preds}
        gt = {k: self.ground_truth[k] for k in predictions}
        cider = CiderScorer().compute_score(gt, predictions)
        spice = (100.0 * spice_score(predictions, gt, self.spice_jar)
                 if spice_available(self.spice_jar) else None)
        return {"CIDEr": cider, "SPICE": spice, "tokenizer": "ptb3"}


__all__ = ["CiderScorer", "CocoCaptionsEvaluator", "TopkAccuracy", "ptb3_tokens",
           "ptb_tokenize", "spice_available", "spice_score"]
