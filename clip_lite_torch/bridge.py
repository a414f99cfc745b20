"""Weight bridge: a flax ``{params, batch_stats}`` tree -> a port state_dict.

The tree arrives as nested dicts of numpy arrays (``jax.device_get`` of
the variables, or a decoded checkpoint), so this module imports neither
jax nor flax.  The port's modules carry the flax path names, so a leaf's
key is its path joined with dots, with the flax wrapper levels of the
shared layers (``BatchNorm_0``, ``LayerNorm_0``) dropped and the leaf
renamed:

  Dense ``kernel`` (in, out)          -> ``weight`` (out, in)
  conv ``kernel`` HWIO                 -> ``weight`` OIHW (1x1 convs are
                                          stored (1, 1, Cin, Cout); the
                                          stem's 7x7 is ``stem/conv/kernel``)
  ``embedding``, LN/BN ``scale``       -> ``weight``
  BN ``mean`` / ``var``                -> ``running_mean`` / ``running_var``

BERT's fused ``qkv`` (H, 3H) is an ordinary Dense.  Every leaf must be
used exactly once and every port key filled, with matching shapes.

:func:`jax_path` goes the other way for one key: the JAX package's dotted
path of a port parameter, so that a path regex written for the JAX
package (``OPTIM.NO_DECAY``) selects the same parameters in the port.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch import nn

from clip_lite_torch.config import Config
from clip_lite_torch.models.bert import BertEmbeddings, BertLayer
from clip_lite_torch.models.mpnet import MPNetModel
from clip_lite_torch.models.resnet import ConvBN
from clip_lite_torch.ops.layers import BatchNorm, LayerNorm

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias", "mean": "running_mean", "var": "running_var",
               "temperature": "temperature"}
_WRAPPER_LEVELS = {"BatchNorm_0", "LayerNorm_0"}
# The port's norm layers held by these modules are flax's own in the JAX
# package, with no wrapper level in their path; all others are the
# package's wrappers around flax's, one ``BatchNorm_0``/``LayerNorm_0``
# level deeper.  MPNet's layers are BertLayers.
_FLAX_NORM_OWNERS = (ConvBN, BertEmbeddings, BertLayer, MPNetModel)
_COLLECTIONS = ("params", "batch_stats")


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def convert(variables: dict, module: nn.Module) -> Dict[str, torch.Tensor]:
    """Map ``variables`` onto the state_dict of ``module`` (which may live
    on the ``meta`` device: only its keys and shapes are read)."""
    expected = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise KeyError(f"unknown variable collections {sorted(extra)}")
    out: Dict[str, torch.Tensor] = {}
    for collection in _COLLECTIONS:
        for path, leaf in _leaves(variables.get(collection, {})):
            *mods, name = [p for p in path if p not in _WRAPPER_LEVELS]
            if name not in _LEAF_NAMES:
                raise KeyError(f"{collection}/{'/'.join(path)}: unknown leaf")
            key = ".".join(mods + [_LEAF_NAMES[name]])
            arr = np.asarray(leaf, np.float32)
            if name == "kernel":
                arr = arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
            if key in out:
                raise KeyError(f"{collection}/{'/'.join(path)}: {key} filled twice")
            if key not in expected:
                raise KeyError(f"{collection}/{'/'.join(path)} maps to {key}, "
                               "which the port model does not have")
            if arr.shape != expected[key]:
                raise ValueError(f"{key}: shape {arr.shape} from "
                                 f"{'/'.join(path)}, port wants {expected[key]}")
            out[key] = torch.from_numpy(arr.copy())  # C order, 0-d kept
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port keys with no JAX leaf: {missing}")
    return out


def jax_path(module: nn.Module, key: str) -> str:
    """The JAX package's dotted path (``optim._path_str`` of its
    parameter tree) of the state_dict key ``key`` of ``module``."""
    *mods, leaf = key.split(".")
    owner = module.get_submodule(".".join(mods))
    if isinstance(owner, (BatchNorm, LayerNorm)) and not isinstance(
            module.get_submodule(".".join(mods[:-1])), _FLAX_NORM_OWNERS):
        mods.append(f"{type(owner).__name__}_0")
    if leaf == "weight":
        leaf = ("scale" if isinstance(owner, (BatchNorm, LayerNorm))
                else "embedding" if isinstance(owner, nn.Embedding)
                else "kernel")
    else:
        leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
    return ".".join(mods + [leaf])


def from_jax_variables(variables: dict, config: Config) -> Dict[str, torch.Tensor]:
    """State dict of the port's pretraining model for ``config`` from the
    JAX package's variables of the same config."""
    from clip_lite_torch.factories import PretrainingModelFactory

    with torch.device("meta"):
        model = PretrainingModelFactory.from_config(config)
    return convert(variables, model)
