"""The port's optimizer (clip_lite_torch/optim) against the JAX package's:
the four LR schedules, and the fused update (global-norm clip, coupled L2
or AdamW decay, momentum, per-group LR x schedule, Lookahead sync) on a
small parameter tree for 12 steps.  Bar: 1e-6 (fp32).

The tree has one parameter group per LR rule (``image_encoder``,
``text_encoder``, the rest) and leaves of every kind the JAX path names
(``kernel``, ``scale``, ``embedding``, ``bias``, a bare leaf), so the
``NO_DECAY`` pattern sees the same path in both packages."""

import re

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.optim import schedules as jschedules
from clip_lite_tpu.optim.fused import build_fused_optimizer as jbuild
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.factories import LRSchedulerFactory, OptimizerFactory
from clip_lite_torch.ops.layers import BatchNorm, LayerNorm, Linear
from clip_lite_torch.optim import schedules

TOL = dict(rtol=1e-6, atol=1e-6)
STEPS = 12

SCHEDULE_CASES = [
    ("none", dict(total_steps=40, warmup_steps=7)),
    ("multistep", dict(total_steps=40, warmup_steps=7, milestones=[10, 25],
                       gamma=0.3)),
    ("linear", dict(total_steps=40, warmup_steps=7)),
    ("cosine", dict(total_steps=40, warmup_steps=7, min_mult=0.05)),
    ("cosine", dict(total_steps=40, warmup_steps=0)),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULE_CASES)])
def test_schedules_match_jax(name, kwargs):
    ours = schedules.SCHEDULES[name](**kwargs)
    theirs = jschedules.SCHEDULES[name](**kwargs)
    steps = range(kwargs["total_steps"] + 1)
    got = np.array([ours(i) for i in steps])
    np.testing.assert_allclose(got, [float(theirs(i)) for i in steps], **TOL)
    # torch's f(i - 1) convention: the first step runs at 0 during warmup.
    assert got[0] == (0.0 if kwargs["warmup_steps"] else 1.0)


def test_scheduler_factory_matches_jax():
    overrides = ["OPTIM.LR_DECAY_NAME", "multistep", "OPTIM.LR_STEPS", [30, 60],
                 "OPTIM.WARMUP_STEPS", 10, "OPTIM.NUM_ITERATIONS", 90]
    ours = LRSchedulerFactory.from_config(Config(override_list=overrides))
    from clip_lite_tpu.factories import LRSchedulerFactory as JFactory

    theirs = JFactory.from_config(JConfig(override_list=overrides))
    np.testing.assert_allclose([ours(i) for i in range(91)],
                               [float(theirs(i)) for i in range(91)], **TOL)


class _Tower(nn.Module):
    def __init__(self, embedding: bool):
        super().__init__()
        self.fc = Linear(6, 5)
        self.bn = BatchNorm(5)
        self.ln = LayerNorm(5)
        self.emb = nn.Embedding(7, 5) if embedding else None


class _Tree(nn.Module):
    """Three LR groups: image_encoder (CNN_LR), text_encoder (TRANS_LR),
    loss (LR)."""

    def __init__(self):
        super().__init__()
        self.image_encoder = _Tower(embedding=False)
        self.text_encoder = _Tower(embedding=True)
        self.loss = nn.Module()
        self.loss.head = Linear(5, 3)
        self.loss.temperature = nn.Parameter(torch.empty(()))


def _tree_and_grads(seed=0):
    rng = np.random.RandomState(seed)
    model = _Tree()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.from_numpy(np.asarray(rng.randn(*p.shape), np.float32)))
    # Gradients large enough that the clip at 10 is active on every step.
    grads = [{n: np.asarray(rng.randn(*p.shape) * 4.0, np.float32)
              for n, p in model.named_parameters()} for _ in range(STEPS)]
    return model, grads


def _nest(flat):
    tree = {}
    for path, value in flat.items():
        *mods, leaf = path.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(value)
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out.update(_flatten(v, path + ".") if isinstance(v, dict)
                   else {path: np.asarray(v)})
    return out


OPT_CASES = [
    ("sgd", ""),
    ("sgd", None),  # the default pattern, which matches nothing
    ("sgd", r".*(BatchNorm_0|LayerNorm_0|ln)\.(scale|bias)$"),
    ("adamw", None),
    ("adamw", r".*(bias|temperature|embedding)$"),
]


@pytest.mark.parametrize("opt,no_decay", OPT_CASES,
                         ids=[f"{o}-{i}" for i, (o, _) in enumerate(OPT_CASES)])
def test_fused_update_matches_jax(opt, no_decay):
    overrides = ["OPTIM.OPTIMIZER_NAME", opt, "OPTIM.WARMUP_STEPS", 3,
                 "OPTIM.NUM_ITERATIONS", 20, "OPTIM.CNN_LR", 0.2,
                 "OPTIM.TRANS_LR", 0.01, "OPTIM.LR", 0.05,
                 "OPTIM.WEIGHT_DECAY", 0.01]
    if no_decay is not None:
        overrides += ["OPTIM.NO_DECAY", no_decay]
    cfg, jcfg = Config(override_list=overrides), JConfig(override_list=overrides)
    model, grads = _tree_and_grads()
    names = {n: bridge.jax_path(model, n) for n, _ in model.named_parameters()}
    params = _nest({names[n]: p.detach().numpy().copy()
                    for n, p in model.named_parameters()})

    opt_port = OptimizerFactory.from_config(cfg, model)
    tx = jbuild(jcfg)
    state = tx.init(params)
    apply = jax.jit(tx.apply)
    decayed = set(opt_port.decayed_names())
    if no_decay:
        # The pattern reaches some leaves and spares others, the same ones
        # in both packages.
        pattern = re.compile(no_decay)
        spared = {n for n, path in names.items() if pattern.match(path)}
        assert spared and decayed and decayed == set(names) - spared
    else:
        assert decayed == set(names)
    for i, step_grads in enumerate(grads):
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(step_grads[n])
        gnorm = opt_port.step()
        params, state, jnorm = apply(
            _nest({names[n]: g for n, g in step_grads.items()}), state, params)
        np.testing.assert_allclose(gnorm.item(), float(jnorm), rtol=1e-6)
        assert float(jnorm) > cfg.OPTIM.CLIP_GRAD_NORM  # the clip acts
        want = _flatten(params)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[names[n]],
                                       err_msg=f"step {i + 1}: {n}", **TOL)
    assert opt_port.count == STEPS and int(state.count) == STEPS
    # Two Lookahead syncs (steps 5 and 10) lie behind; the slow weights agree.
    slow = _flatten(state.slow_params)
    for n, s in opt_port.slow_state().items():
        np.testing.assert_allclose(s.numpy(), slow[names[n]], err_msg=n, **TOL)


def test_lookahead_sync_cadence():
    """params == slow right after every k-th step, and only then."""
    cfg = Config(override_list=["OPTIM.WARMUP_STEPS", 0,
                                "OPTIM.NUM_ITERATIONS", 20])
    model, grads = _tree_and_grads(1)
    opt = OptimizerFactory.from_config(cfg, model)
    for i, step_grads in enumerate(grads[:11]):
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(step_grads[n])
        opt.step()
        synced = all(torch.equal(p, opt.slow_state()[n])
                     for n, p in model.named_parameters())
        assert synced == ((i + 1) % 5 == 0), i + 1


def test_unknown_optimizer_raises():
    model, _ = _tree_and_grads()
    with pytest.raises(KeyError):
        OptimizerFactory.from_config(
            Config(override_list=["OPTIM.OPTIMIZER_NAME", "lamb"]), model)
