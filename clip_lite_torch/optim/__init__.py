"""Optimizer construction: the parameter-group rules of the JAX package's
``optim/__init__.py``.

Group LR (``optim/__init__.py:57-67`` there): a parameter whose name
holds ``image_encoder`` gets ``CNN_LR``, one holding ``text_encoder``
``TRANS_LR``, every other ``LR``.  The port's names keep both substrings.

Weight decay skips the parameters whose JAX-style path
(:func:`clip_lite_torch.bridge.jax_path`) matches ``OPTIM.NO_DECAY``, so a
pattern selects the same parameters in both packages.  The default
pattern ``.*textual.(...)`` matches no parameter in either (a quirk of
the reference, kept): weight decay applies everywhere unless the user
supplies a pattern that matches.
"""

from __future__ import annotations

import re
from typing import Callable, Optional


def make_lr_fn(cnn_lr: float, trans_lr: float,
               base_lr: float) -> Callable[[str], float]:
    """name -> peak LR, by the group rule."""

    def lr_for(name: str) -> float:
        if "image_encoder" in name:
            return cnn_lr
        if "text_encoder" in name:
            return trans_lr
        return base_lr

    return lr_for


def make_decays_fn(no_decay: Optional[str]) -> Callable[[str], bool]:
    """JAX-style path -> whether weight decay applies to it."""
    pattern = re.compile(no_decay) if no_decay else None
    return lambda path: not (pattern and pattern.match(path))
