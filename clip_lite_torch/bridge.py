"""Weight bridge between a flax ``{params, batch_stats}`` tree and a port
state_dict, both ways.

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

BERT's fused ``qkv`` (H, 3H) is an ordinary Dense; grouped convs keep
flax's (kh, kw, Cin / groups, Cout), torch's (Cout, Cin / groups, kh, kw).
The glove table is ``text_encoder/embedding/embedding``.  Every leaf must
be used exactly once and every port key filled, with matching shapes.

:func:`jax_path` goes the other way for one key: the JAX package's dotted
path of a port parameter, so that a path regex written for the JAX
package (``OPTIM.NO_DECAY``) selects the same parameters in the port.
:func:`to_jax_variables` inverts :func:`convert` for a whole state_dict,
wrapper levels and kernel layouts included; :func:`to_jax_params` and
:func:`from_jax_params` do the same for tensors keyed by parameter name
alone (the optimizer's per-parameter buffers, which follow the params
tree in the JAX package).
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clip_lite_torch.config import Config
from clip_lite_torch.models import zoo
from clip_lite_torch.models.bert import BertEmbeddings, BertLayer
from clip_lite_torch.models.mpnet import MPNetModel
from clip_lite_torch.models.resnet import ConvBN
from clip_lite_torch.models.vgg import VGG
from clip_lite_torch.ops.layers import BatchNorm, LayerNorm

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias", "mean": "running_mean", "var": "running_var",
               "temperature": "temperature"}
_WRAPPER_LEVELS = {"BatchNorm_0", "LayerNorm_0"}
# The port's norm layers held by these modules are flax's own in the JAX
# package, with no wrapper level in their path; all others are the
# package's wrappers around flax's, one ``BatchNorm_0``/``LayerNorm_0``
# level deeper.  MPNet's layers are BertLayers.  VGG and the model zoo
# hold flax's BatchNorm directly.
_FLAX_NORM_OWNERS = (ConvBN, BertEmbeddings, BertLayer, MPNetModel, VGG,
                     zoo.ConvBN, zoo.WRNBlock, zoo.WideResNet)
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
    return _convert(variables, {k: tuple(v.shape)
                                for k, v in module.state_dict().items()})


def from_jax_params(params: dict, module: nn.Module) -> Dict[str, torch.Tensor]:
    """A tree that follows the JAX params tree (an optimizer's ``trace``,
    ``nu`` or ``slow_params``) as tensors keyed by the parameter names of
    ``module``."""
    return _convert({"params": params}, {k: tuple(p.shape)
                                         for k, p in module.named_parameters()})


def _convert(variables: dict, expected: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
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
            with warnings.catch_warnings():  # read-only arrays: copied below
                warnings.simplefilter("ignore", UserWarning)
                t = torch.from_numpy(np.asarray(leaf, np.float32))
            if name == "kernel":  # torch's transposing copy is numpy's 4x
                t = t.t() if t.ndim == 2 else t.permute(3, 2, 0, 1)
            if key in out:
                raise KeyError(f"{collection}/{'/'.join(path)}: {key} filled twice")
            if key not in expected:
                raise KeyError(f"{collection}/{'/'.join(path)} maps to {key}, "
                               "which the port model does not have")
            if tuple(t.shape) != expected[key]:
                raise ValueError(f"{key}: shape {tuple(t.shape)} from "
                                 f"{'/'.join(path)}, port wants {expected[key]}")
            out[key] = t.clone(memory_format=torch.contiguous_format)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port keys with no JAX leaf: {missing}")
    return out


def jax_layout(leaf: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the JAX leaf named ``leaf`` holds it, a view: a Dense
    ``kernel`` (in, out), a conv ``kernel`` HWIO; other leaves as they
    are."""
    if leaf != "kernel":
        return t
    return t.t() if t.ndim == 2 else t.permute(2, 3, 1, 0)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A C-order numpy copy of ``t`` on the host, whatever its device and
    strides (CUDA convs are ``channels_last``)."""
    return t.detach().contiguous().cpu().numpy()


def to_jax_params(tensors: Dict[str, torch.Tensor], module: nn.Module,
                  leaf: Callable[[torch.Tensor], object] = to_numpy) -> dict:
    """Tensors keyed by state_dict keys of ``module`` as a nested dict by
    their JAX paths, each in the JAX layout and passed through ``leaf``
    (by default a C-order numpy copy)."""
    items, modules = [], dict(module.named_modules())
    for key, t in tensors.items():
        path = jax_path(module, key, modules).split(".")
        items.append((path, leaf(jax_layout(path[-1], t))))
    return _nest(items)


def to_jax_variables(state_dict: Dict[str, torch.Tensor], module: nn.Module,
                     leaf: Callable[[torch.Tensor], object] = to_numpy) -> dict:
    """The inverse of :func:`convert`: the JAX package's ``{params,
    batch_stats}`` of ``module``'s ``state_dict``."""
    params = {k for k, _ in module.named_parameters()}
    return {"params": to_jax_params(
                {k: t for k, t in state_dict.items() if k in params}, module,
                leaf),
            "batch_stats": to_jax_params(
                {k: t for k, t in state_dict.items() if k not in params},
                module, leaf)}


def _nest(items: Iterable[Tuple[list, object]]) -> dict:
    tree: dict = {}
    for path, value in items:
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        if path[-1] in node:
            raise KeyError(f"{'.'.join(path)} filled twice")
        node[path[-1]] = value
    return tree


def jax_path(module: nn.Module, key: str,
             modules: Optional[Dict[str, nn.Module]] = None) -> str:
    """The JAX package's dotted path (``optim._path_str`` of its
    parameter tree) of the state_dict key ``key`` of ``module``;
    ``modules``, ``dict(module.named_modules())``, saves the lookups when
    many keys are mapped."""
    *mods, leaf = key.split(".")
    get = modules.__getitem__ if modules is not None else module.get_submodule
    owner = get(".".join(mods))
    if isinstance(owner, (BatchNorm, LayerNorm)) and not isinstance(
            get(".".join(mods[:-1])), _FLAX_NORM_OWNERS):
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
