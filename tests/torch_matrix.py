"""Helpers of the model-matrix parity tests (``tests/test_torch_{vgg,zoo,
text_modes,pretrained}.py``): seeded variables for a flax module without
running its initialisers, the relative distance the bars read, the
injection of dropout keep masks into both packages, and one or two
training steps of a config through the JAX engine and the port's from the
same weights, batches and prior noise."""

from __future__ import annotations

import contextlib
import os
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu import engine as jengine
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.engine import (
    create_train_state,
    make_train_step,
    metrics_to_floats,
)
from clip_lite_torch.ops.layers import StepRNG
from test_torch_loss import inject_uniform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
COMPONENTS = ("total_loss", "cross_modal_loss", "visual_loss", "textual_loss")


def _torch(x) -> torch.Tensor:
    """A tensor or array as a tensor, without a copy (read-only arrays are
    only read)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(x))


def rel(a, b) -> float:
    """max |a - b| / max |b|: the bars' distance."""
    a, b = _torch(a).float(), _torch(b).float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def seeded_variables(module, *args, seed: int = 0,
                     cache: Optional[dict] = None, **kwargs) -> dict:
    """``{params, batch_stats}`` of ``module`` for ``args`` filled from a
    seeded numpy generator, without running flax's initialisers (which
    cost seconds for VGG's 130M weights): kernels N(0, 1 / fan-in), norm
    scales and variances in [0.75, 1.25), embeddings N(0, 1), other leaves
    N(0, 0.01).  Leaves of a million elements or more are kept in
    ``cache`` by their module's name, leaf name and shape, and taken from
    it when there (VGG's classifier, the same in every depth and inside a
    pretraining model)."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda *a: module.init(
        {"params": key, "prior": key, "dropout": key}, *a, **kwargs), *args)
    rng = np.random.default_rng(seed)

    def fill(name, shape):
        if name == "kernel":
            return rng.standard_normal(shape, np.float32) / np.float32(
                np.sqrt(np.prod(shape[:-1])))
        if name in ("scale", "var"):
            return 0.75 + 0.5 * rng.random(shape, np.float32)
        if name == "embedding":
            return rng.standard_normal(shape, np.float32)
        return 0.1 * rng.standard_normal(shape, np.float32)

    def leaf(path, s):
        if cache is None or np.prod(s.shape) < 1_000_000:
            return fill(path[-1].key, s.shape)
        k = (jax.tree_util.keystr(path[-2:]), s.shape)
        if k not in cache:
            cache[k] = fill(path[-1].key, s.shape)
        return cache[k]

    out = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {"params": out.get("params", {}),
            "batch_stats": out.get("batch_stats", {})}


def keep_masks(shapes, seed: int = 0, rate: float = 0.5) -> Dict[tuple, np.ndarray]:
    """A seeded keep mask for each shape."""
    rng = np.random.RandomState(seed)
    return {tuple(s): rng.random_sample(s) >= rate for s in shapes}


@contextlib.contextmanager
def injected_masks(masks: Dict[tuple, np.ndarray]):
    """flax's ``Dropout`` (through ``jax.random.bernoulli``) and the port's
    ``StepRNG.keep_mask`` draw ``masks[shape]`` for the shapes it holds."""
    real_bernoulli, real_keep = jax.random.bernoulli, StepRNG.keep_mask

    def bernoulli(key, p=0.5, shape=None, *args, **kwargs):
        if shape is not None and tuple(shape) in masks:
            return jnp.asarray(masks[tuple(shape)])
        return real_bernoulli(key, p, shape, *args, **kwargs)

    def keep_mask(self, shape, rate):
        if tuple(shape) in masks:
            return torch.from_numpy(masks[tuple(shape)]).to(self.device)
        return real_keep(self, shape, rate)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        mp.setattr(StepRNG, "keep_mask", keep_mask)
        yield


def jax_steps(config_path: str, overrides: list, batches: List[dict],
              noise: Dict[str, np.ndarray], patch: Optional[Callable] = None,
              masks: Optional[dict] = None, cache: Optional[dict] = None
              ) -> dict:
    """The JAX engine's steps over ``batches`` from seeded variables
    (:func:`seeded_variables`), the prior noise injected (and ``masks``, if
    any): the variables, the first step's gradients, per-step metrics and
    the final ``{params, batch_stats}``.
    ``patch(monkeypatch)`` runs first (e.g. to shrink the glove table);
    ``cache`` goes to :func:`seeded_variables`."""
    with pytest.MonkeyPatch.context() as mp, \
            (injected_masks(masks) if masks else contextlib.nullcontext()):
        if patch is not None:
            patch(mp)
        jcfg = JConfig(config_path, overrides)
        model = JModelFactory.from_config(jcfg)
        tx = JOptimizerFactory.from_config(jcfg)
        sample = jax.tree.map(lambda a: a[:1], batches[0])
        sample["image"] = sample["image"].astype(np.float32)
        variables = seeded_variables(model, sample, train=False, cache=cache)
        inject_uniform(mp, noise)
        key = jax.random.PRNGKey(0)
        step = jengine.make_train_step(model, tx)

        state = jengine.TrainState(
            step=jnp.zeros([], jnp.int32), params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=jax.jit(tx.init)(variables["params"]))
        # The first step's own keys (engine.py:88-90), so that a dropout
        # that is not injected draws alike in both passes.
        prior, drop, _ = jax.random.split(jax.random.fold_in(key, 0), 3)

        def loss_fn(params, batch):
            out, _ = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                batch, train=True, mutable=["batch_stats"],
                rngs={"prior": prior, "dropout": drop})
            return out["loss"]

        grads = jax.jit(jax.grad(loss_fn))(state.params, batches[0])
        jstep, metrics = jax.jit(step), []
        for batch in batches:  # one compile, however many steps
            state, m = jstep(state, batch, key)
            metrics.append(m)
        metrics, final = jax.device_get((metrics, {
            "params": state.params, "batch_stats": state.batch_stats}))
    return dict(variables=variables, grads=jax.tree.map(np.asarray, grads),
                metrics=[jax.tree.map(float, m) for m in metrics],
                final=jax.tree.map(np.asarray, final))


def port_steps(config_path: str, overrides: list, batches: List[dict],
               noise: Dict[str, np.ndarray], variables: dict,
               patch: Optional[Callable] = None,
               masks: Optional[dict] = None) -> dict:
    """The port's steps from the JAX run's ``variables``, the same batches,
    noise and masks: the state, per-step metrics, the first step's
    gradients (zero where a parameter has none)."""
    with pytest.MonkeyPatch.context() as mp, \
            (injected_masks(masks) if masks else contextlib.nullcontext()):
        if patch is not None:
            patch(mp)
        cfg = Config(config_path, overrides)
        state = create_train_state(cfg, device="cpu", state_dict=
                                   bridge.from_jax_variables(variables, cfg))
        step = make_train_step(cfg)
        prior = {k: torch.from_numpy(v) for k, v in noise.items()}
        metrics, grads = [], None
        for batch in batches:
            state, m = step(state, batch, prior_noise=prior)
            metrics.append(metrics_to_floats(m))
            if grads is None:
                grads = {n: torch.zeros_like(p) if p.grad is None
                         else p.grad.clone()
                         for n, p in state.model.named_parameters()}
    return dict(cfg=cfg, state=state, metrics=metrics, grads=grads)


def assert_close(got, want, rtol: float, atol: float, name: str) -> None:
    """|got - want| <= atol + rtol |want| everywhere (numpy's rule, in torch,
    which is fast on VGG's 100M-element tensors)."""
    got, want = _torch(got).float(), _torch(want).float()
    err = (got - want).abs_().sub_(want.abs().mul_(rtol))
    assert float(err.max()) <= atol, (name, float((got - want).abs().max()))


def assert_steps_match(port: dict, ref: dict, tol: float = 1e-4,
                       grad_tol: float = 1e-4,
                       image_grad_rel: Optional[float] = None) -> None:
    """Every step's loss components and grad norm at ``tol`` (relative);
    each first-step gradient within ``grad_tol`` of the largest gradient
    (with ``image_grad_rel``, the image tower's within that of its own
    largest element instead); every parameter and BatchNorm statistic
    after the last step at ``tol``."""
    for i, (got, want) in enumerate(zip(port["metrics"], ref["metrics"])):
        for name in COMPONENTS + ("grad_norm",):
            np.testing.assert_allclose(got[name], want[name], rtol=tol,
                                       atol=1e-6, err_msg=f"step {i + 1} {name}")
    model = port["state"].model
    modules = dict(model.named_modules())

    def jax_leaf(tree: dict, name: str, t: torch.Tensor):
        """``t`` and the JAX tree's leaf of port key ``name`` in the port's
        layout (torch's transposing copy: VGG's fc1 has 100M elements)."""
        path = bridge.jax_path(model, name, modules).split(".")
        for part in path:
            tree = tree[part]
        leaf = _torch(tree)
        if path[-1] == "kernel":
            leaf = leaf.t() if leaf.ndim == 2 else leaf.permute(3, 2, 0, 1)
        return t, leaf.contiguous()

    scale = max(float(g.abs().max()) for g in port["grads"].values())
    for name, g in port["grads"].items():
        g, want = jax_leaf(ref["grads"], name, g)
        if image_grad_rel and name.startswith("image_encoder."):
            assert rel(g, want) < image_grad_rel, (name, rel(g, want))
        else:
            assert_close(g, want, grad_tol, grad_tol * scale, name)
    params = {k for k, _ in model.named_parameters()}
    for name, value in model.state_dict().items():
        tree = ref["final"]["params" if name in params else "batch_stats"]
        assert_close(*jax_leaf(tree, name, value), tol, tol, name)
