"""A reading, not a test: the port's training path against the JAX
package's over a few hundred steps on the CPU, at the round-5 quality
protocol's optimizer settings (``configs/fs_tpu_tuned.yaml``: SGD with
momentum, Lookahead, cosine decay after a warmup of a twentieth of the
run, CNN LR 0.025, LR and TRANS_LR 1.25e-4 or ``--lr``; the dot critic
with both priors) cut to a tiny width (ResNet at width 8, BERT of two
layers 128 wide, 16 pairs of 32 px a step, dropout off), in fp32 or,
with ``--amp``, in both packages' bf16 mixed precision.

The batch stream is learnable: each caption's tokens pick seeded image
patterns, and the image is their mean plus noise.  Both packages start
from the JAX initialisation (bridged) and see the same batches and prior
noise.  The image tower is chaotic at these rates (a one-rounding change
of the pixels grows into parameters that differ by their own size within
a few hundred steps), so no one run can be held to the JAX one step for
step.  The reading sets the port's gap to JAX beside its gap to itself
with every pixel scaled by 1 + 2^-23 (one fp32 ulp) or, with ``--amp``,
by 1 + 2^-8 (about one bf16 rounding): the mean loss over each tenth of
the run, the largest relative loss gap in it, each parameter's and
statistic's drift at the end, and the L2 norm of each part of the model.
A fault of the port's training path shows as a gap to JAX beyond the
one-ulp gap; a gap within it says nothing finer than the chaos allows.

Run from the root of the repo (two to three minutes at 300 steps):
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_drift_reading.py \\
        [--steps 300] [--net resnet18] [--amp] [--lr 1.25e-4]
"""

import argparse
import os
import sys
import time

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from clip_lite_tpu import engine as jengine  # noqa: E402
from clip_lite_tpu.config import Config as JConfig  # noqa: E402
from clip_lite_tpu.factories import (  # noqa: E402
    OptimizerFactory as JOptimizerFactory,
    PretrainingModelFactory as JModelFactory,
)
from clip_lite_torch import bridge  # noqa: E402
from clip_lite_torch.config import Config  # noqa: E402
from clip_lite_torch.engine import (  # noqa: E402
    create_train_state, make_train_step, metrics_to_floats)
from test_torch_train import _inject_uniform  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUNED = os.path.join(ROOT, "configs", "fs_tpu_tuned.yaml")
B, L, CROP, VOCAB, WIDTH, TEXT_DIM = 16, 8, 32, 128, 8, 128


def overrides(net: str, steps: int, amp: bool, lr: float) -> list:
    return ["AMP", amp, "MODEL.VISUAL.NETWORK_NAME", net,
            "MODEL.VISUAL.WIDTH", WIDTH,
            "MODEL.VISUAL.FEATURE_SIZE", image_dim(net),
            "DATA.IMAGE_CROP_SIZE", CROP, "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 2,
            "MODEL.TEXTUAL.HIDDEN_SIZE", TEXT_DIM,
            "DATA.MAX_CAPTION_LENGTH", L, "MODEL.TEXTUAL.VOCAB_SIZE", VOCAB,
            "MODEL.TEXTUAL.DROPOUT", 0.0, "DATA.SEQ_BUCKETS", "[]",
            "OPTIM.BATCH_SIZE", B, "OPTIM.CNN_LR", 0.025,
            "OPTIM.TRANS_LR", lr, "OPTIM.LR", lr,
            "OPTIM.WARMUP_STEPS", max(1, steps // 20),
            "OPTIM.NUM_ITERATIONS", steps]


def image_dim(net: str) -> int:
    return (8 if net == "resnet18" else 32) * WIDTH


def learnable_batches(rng, steps: int) -> list:
    """Captions of 2-8 tokens; each image the mean of its tokens' seeded
    patterns, doubled, plus noise of half a unit."""
    patterns = rng.randn(VOCAB, CROP, CROP, 3).astype(np.float32)
    out = []
    for _ in range(steps):
        lengths = rng.randint(2, L + 1, B)
        ids = rng.randint(1, VOCAB, (B, L)).astype(np.int32)
        mask = (np.arange(L)[None] < lengths[:, None]).astype(np.int32)
        image = (patterns[ids] * mask[..., None, None, None]).sum(1) \
            / mask.sum(1)[:, None, None, None]
        image = 2 * image + 0.5 * rng.randn(B, CROP, CROP, 3)
        out.append({"image": image.astype(np.float32), "input_ids": ids,
                    "attention_mask": mask})
    return out


def jax_run(train: list, batches: list, noise: dict):
    """The initial variables, per-step metrics and final variables."""
    cfg = JConfig(TUNED, train)
    model = JModelFactory.from_config(cfg)
    tx = JOptimizerFactory.from_config(cfg)
    sample = jax.tree.map(lambda a: a[:1], batches[0])
    state = jax.jit(lambda b: jengine.create_train_state(model, tx, b, seed=0))(
        sample)
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    key = jax.random.PRNGKey(0)
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        _inject_uniform(mp, noise)
        step = jax.jit(jengine.make_train_step(model, tx))
        for batch in batches:
            state, m = step(state, batch, key)
            metrics.append(jax.tree.map(float, jax.device_get(m)))
    final = jax.tree.map(np.asarray, {"params": state.params,
                                      "batch_stats": state.batch_stats})
    return variables, metrics, final


def port_run(train: list, variables: dict, batches: list, noise: dict):
    cfg = Config(TUNED, train)
    state = create_train_state(cfg, device="cpu", state_dict=(
        bridge.from_jax_variables(variables, cfg)))
    prior = {k: torch.from_numpy(v) for k, v in noise.items()}
    step = make_train_step(cfg)
    metrics = []
    for batch in batches:
        state, m = step(state, batch, prior_noise=prior)
        metrics.append(metrics_to_floats(m))
    return state, metrics


def drift(a: dict, b: dict) -> list:
    """Each tensor's max |a - b| / max |b|, smallest first, with its name."""
    out = []
    for name, value in a.items():
        x = np.asarray(value, np.float64)
        y = np.asarray(b[name], np.float64)
        if x.size > 1:
            out.append((np.abs(x - y).max() / max(np.abs(y).max(), 1e-30),
                        name))
    return sorted(out)


def norms(state_dict: dict) -> dict:
    """The L2 norm of each top-level part, its BatchNorm statistics apart."""
    sums = {}
    for name, value in state_dict.items():
        part = name.split(".")[0] + ("/bn_stats" if "running" in name else "")
        sums[part] = sums.get(part, 0.0) + float(
            (np.asarray(value, np.float64) ** 2).sum())
    return {k: round(v ** 0.5, 4) for k, v in sorted(sums.items())}


def main(steps: int, net: str, amp: bool, lr: float) -> None:
    train = overrides(net, steps, amp, lr)
    ulp = np.float32(1 + 2.0 ** (-8 if amp else -23))
    rng = np.random.RandomState(0)
    batches = learnable_batches(rng, steps)
    noise = {"image": rng.uniform(size=(B, image_dim(net))).astype(np.float32),
             "text": rng.uniform(size=(B, TEXT_DIM)).astype(np.float32)}
    t0 = time.perf_counter()
    with jax.default_prng_impl("threefry2x32"):
        variables, j_metrics, j_final = jax_run(train, batches, noise)
    t1 = time.perf_counter()
    port, p_metrics = port_run(train, variables, batches, noise)
    nudged, u_metrics = port_run(train, variables, [
        dict(b, image=b["image"] * ulp) for b in batches], noise)
    t2 = time.perf_counter()
    jax_sd = {k: v.numpy() for k, v in bridge.convert(
        j_final, port.model).items()}
    port_sd = {k: v.float().numpy()
               for k, v in port.model.state_dict().items()}
    ulp_sd = {k: v.float().numpy()
              for k, v in nudged.model.state_dict().items()}
    window = max(1, steps // 10)

    def means(ms):
        loss = [m["total_loss"] for m in ms]
        return [f"{np.mean(loss[i:i + window]):.5f}"
                for i in range(0, steps, window)]

    def gaps(ms, ref):
        rel = [abs(a["total_loss"] - b["total_loss"]) / abs(b["total_loss"])
               for a, b in zip(ms, ref)]
        return [f"{max(rel[i:i + window]):.1e}"
                for i in range(0, steps, window)]

    print(f"{net} at width {WIDTH}, {'bf16' if amp else 'fp32'}, LR {lr}, "
          f"{steps} steps of {B} pairs of {CROP} px (JAX {t1 - t0:.1f} s, "
          f"the two port runs {t2 - t1:.1f} s)")
    print("  mean loss a tenth: JAX      ", means(j_metrics))
    print("                     port     ", means(p_metrics))
    print("                     port+ulp ", means(u_metrics))
    print("  largest relative loss gap a tenth: port-JAX ",
          gaps(p_metrics, j_metrics))
    print("                                     ulp-port ",
          gaps(u_metrics, p_metrics))
    for label, d in (("port-JAX", drift(port_sd, jax_sd)),
                     ("ulp-port", drift(ulp_sd, port_sd))):
        print(f"  drift at the end, {label}: median "
              f"{np.median([x for x, _ in d]):.2e}, largest {d[-1][0]:.2e} "
              f"({d[-1][1]})")
    print("  norms: initial ", norms(bridge.from_jax_variables(
        variables, Config(TUNED, train))))
    print("         JAX     ", norms(jax_sd))
    print("         port    ", norms(port_sd))
    print("         port+ulp", norms(ulp_sd))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--net", default="resnet18")
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--lr", type=float, default=1.25e-4,
                        help="LR and TRANS_LR (the text tower's and the "
                             "heads'); the flagship's is 1e-3")
    args = parser.parse_args()
    main(args.steps, args.net, args.amp, args.lr)
