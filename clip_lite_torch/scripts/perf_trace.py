"""Per-op trace attribution for a training step, the profiling CLI: the
counterpart of the JAX package's ``scripts/perf_trace.py``.

Companion of ``train.py --profile-dir``: builds the train step for a
config (the JAX script's flagship overrides, on one card), times
``--steps`` steps on one fixed batch, traces 3 more (after one in the
profiler's warm-up) with
``torch.profiler``, and prints the per-component and per-category device
time and bytes tables, the roofline and the device's busy and idle time
a step (``utils/trace.py``), or one JSON line with ``--json``.  Images
are ``DATA.IMAGE_CROP_SIZE`` pixels a side (224 in the flagship).

Usage (flagship, bs128, on the card):
    python -m clip_lite_torch.scripts.perf_trace
    python -m clip_lite_torch.scripts.perf_trace --batch 256 \
        --override MODEL.TEXTUAL.NUM_HIDDEN_LAYERS 6
On the CPU (a tiny model; no roofline, the host's ops in place of the
kernels):
    python -m clip_lite_torch.scripts.perf_trace --device cpu --batch 4 \
        --seq 8 --json --override MODEL.VISUAL.NETWORK_NAME resnet18 \
        MODEL.VISUAL.WIDTH 8 MODEL.TEXTUAL.NUM_HIDDEN_LAYERS 1 \
        MODEL.TEXTUAL.HIDDEN_SIZE 64 DATA.IMAGE_CROP_SIZE 32
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--override", nargs="*", default=[],
                   help="dotted config overrides (KEY VALUE ...)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--seq", type=int, default=30)
    p.add_argument("--steps", type=int, default=10,
                   help="timed steps (trace uses 3)")
    p.add_argument("--trace-dir", default=os.path.join(
        tempfile.gettempdir(), "clip_lite_torch_perf_trace"))
    p.add_argument("--json", action="store_true",
                   help="print ONE JSON line instead of tables")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from clip_lite_torch.config import Config
    from clip_lite_torch.engine import create_train_state, make_train_step
    from clip_lite_torch.eval_utils import resolve_device
    from clip_lite_torch.utils.trace import trace_step_roofline

    device = resolve_device(args.device)
    overrides = [
        "MODEL.VISUAL.NETWORK_NAME", "resnet50",
        "MODEL.VISUAL.FEATURE_SIZE", 2048,
        "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 12,
        "OPTIM.BATCH_SIZE", args.batch,
        "OPTIM.WARMUP_STEPS", 10, "OPTIM.NUM_ITERATIONS", 1000,
        "MODEL.LOSS.NEGATIVES", "global",
    ] + list(args.override)
    cfg = Config(args.config, overrides)

    state = create_train_state(cfg, device=device)
    step = make_train_step(cfg)
    rng = np.random.RandomState(0)
    b, s, crop = args.batch, args.seq, cfg.DATA.IMAGE_CROP_SIZE
    batch = {
        "image": np.asarray(rng.randn(b, crop, crop, 3), np.float32),
        "input_ids": np.asarray(
            rng.randint(0, cfg.MODEL.TEXTUAL.VOCAB_SIZE, (b, s)), np.int32),
        "attention_mask": np.ones((b, s), np.int32),
    }
    batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}

    for _ in range(3):  # warm-up
        state, m = step(state, batch)
    _ = float(m["total_loss"])  # sync

    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, m = step(state, batch)
    _ = float(m["total_loss"])
    step_ms = (time.perf_counter() - t0) / args.steps * 1e3

    n_trace = 3

    def run(n=n_trace):
        nonlocal state
        for _ in range(n):
            state, mm = step(state, batch)
        _ = float(mm["total_loss"])

    summary = trace_step_roofline(run, n_trace, args.trace_dir, device,
                                  warmup_fn=lambda: run(1))
    out = {"step_ms": round(step_ms, 2),
           "img_per_sec": round(b / step_ms * 1e3, 1), **summary}
    if args.json:
        print(json.dumps(out))
        return out
    print(f"step: {out['step_ms']} ms = {out['img_per_sec']} img/s")
    print(f"device time/step: {summary['measured_ms']} ms | busy "
          f"{summary['busy_ms']} ms of a {summary['window_ms']} ms window "
          f"(idle share {summary['idle_share']}) | rooflines: "
          f"flops {summary['flops_roofline_ms']} ms, "
          f"bytes {summary['bytes_roofline_ms']} ms, "
          f"per-op max {summary['per_op_roofline_ms']} ms "
          f"(opaque {summary['opaque_ms']} ms)")
    print(f"HBM traffic/step: {summary['total_gbytes_per_step']} GB, "
          f"{summary['total_gflops_per_step']} GFLOP")
    for title, table in (("component", summary["by_component"]),
                         ("category", summary["by_category"])):
        print(f"\nby {title}:")
        for k, v in table.items():
            print(f"  {k:<28} {v['ms']:>8.3f} ms  {v['gbytes']:>8.3f} GB"
                  f"  x{v['n']}")
    return out


if __name__ == "__main__":
    main()
