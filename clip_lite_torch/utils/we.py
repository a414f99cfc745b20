"""Embedding debiasing for the bias analysis (Bolukbasi-style), the port's
copy of the JAX package's ``utils/we.py``: a gender direction as the top
principal component of the differences within definitional prompt pairs
encoded by the text tower, and its projection removed from embeddings.
numpy, float64."""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np


def pca_components(matrix: np.ndarray, num_components: int = 10):
    """The top ``num_components`` principal components of a (N, D) matrix
    and their explained-variance ratios, by SVD of the centred data."""
    x = matrix - matrix.mean(axis=0, keepdims=True)
    _, s, vt = np.linalg.svd(x, full_matrices=False)
    k = min(num_components, vt.shape[0])
    explained = (s ** 2) / max(1e-12, (s ** 2).sum())
    return vt[:k], explained[:k]


def do_pca(pairs: Sequence[Tuple[str, str]],
           encode_fn: Callable[[List[str]], np.ndarray],
           num_components: int = 10):
    """Bias-subspace PCA over definitional pairs: ``encode_fn`` maps
    prompts to (N, D) embeddings; both members of each pair are centred on
    the pair's mean, and the principal directions of the residuals span
    the subspace."""
    flat: List[str] = [p for pair in pairs for p in pair]
    vecs = np.asarray(encode_fn(flat), np.float64)
    rows = []
    for i in range(0, len(flat), 2):
        a, b = vecs[i], vecs[i + 1]
        center = (a + b) / 2
        rows.append(a - center)
        rows.append(b - center)
    return pca_components(np.asarray(rows), num_components)


def drop(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``u`` without its projection onto the direction ``v``."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    return u - v * (u @ v) / (v @ v)


def gender_direction(pairs, encode_fn) -> np.ndarray:
    """The top bias component of the definitional pairs."""
    components, _ = do_pca(pairs, encode_fn)
    return components[0]


def debias(embeddings: np.ndarray, direction: np.ndarray) -> np.ndarray:
    """A batch of embeddings without their projections onto
    ``direction``."""
    embeddings = np.atleast_2d(np.asarray(embeddings, np.float64))
    proj = (embeddings @ direction)[:, None] * direction / (
        direction @ direction)
    return embeddings - proj


DEFAULT_DEFINITIONAL_PAIRS = [
    ["a photo of a woman", "a photo of a man"],
    ["a photo of a girl", "a photo of a boy"],
    ["a photo of a mother", "a photo of a father"],
    ["a photo of a daughter", "a photo of a son"],
    ["she is walking", "he is walking"],
    ["a female person", "a male person"],
]

__all__ = ["DEFAULT_DEFINITIONAL_PAIRS", "debias", "do_pca", "drop",
           "gender_direction", "pca_components"]
