"""The trained-checkpoint quality campaign: every evaluation family
against one pretraining run, one JSON; the counterpart of the JAX
package's ``scripts/quality_campaign.py``, over the port's CLIs.

It runs the port's evaluation CLIs (``python -m clip_lite_torch.<cli>``,
each a subprocess, its last JSON line scraped) against a run on the
synthetic learnable corpus (``scripts/make_synth_data.py``):

  retrieval    R@1/5/10 both ways, per checkpoint  (``retrieval``)
  zero-shot    top-1 over the 64 classes           (``zero_shot``)
  linear probe top-1 of a probe on the frozen      (``linear_clf``)
               tower, and of the same probe on a
               random-init tower (the control)
  VOC07 SVM    16-class mAP                        (``voc_clf``)
  bias         the colour-attribute bias gap,      (``bias_eda``)
               loaded and neutral prompt

``--families`` picks among ``sweep`` (retrieval and zero-shot over the
last ``--retrieval-checkpoints`` checkpoints), ``probe``, ``voc`` and
``bias``; ``--sweep-device`` runs the sweep's CLIs on that device (the
JAX script's ``--sweep-platform``; the other families run on the CLIs'
own, the card).  The output also holds each CLI's seconds.

Run (on the card, after training with ``--serialization-dir RUN``):
    python -m clip_lite_torch.scripts.quality_campaign --run-dir RUN \
        --synth-root /tmp/synth --output QUALITY.json
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

SECONDS: dict = {}

parser = argparse.ArgumentParser(
    description="Run the full eval suite against a trained checkpoint.")
parser.add_argument("--run-dir", required=True,
                    help="Pretraining --serialization-dir (holds "
                         "pretrain_config.yaml + <RUN_ID>/checkpoint_*.msgpack)")
parser.add_argument("--synth-root", default="/tmp/synth")
parser.add_argument("--output", default="QUALITY.json")
parser.add_argument("--work-dir", default=None,
                    help="Scratch dir for eval logs (default: tmp).")
parser.add_argument("--probe-iters", type=int, default=800)
parser.add_argument("--retrieval-checkpoints", type=int, default=4,
                    help="How many step checkpoints to sweep for "
                         "retrieval/zero-shot (latest N).")
parser.add_argument("--families", default="sweep,probe,voc,bias",
                    help="Comma list of eval families to run "
                         "(sweep=retrieval+zero_shot over checkpoints).")
parser.add_argument("--sweep-device", default=None,
                    help="Run the retrieval/zero-shot sweep CLIs on this "
                         "device (cuda or cpu).")

# The synthetic stand-in for the gender direction: the protected attribute
# of make_synth_data's coco_gender split is the shape's colour (the red
# population stands for "man", the blue one for "woman").
DEFINITIONAL_PAIRS = [
    ["a photo of a blue circle", "a photo of a red circle"],
    ["a blue square", "a red square"],
    ["a small blue triangle in the center", "a small red triangle in the center"],
    ["a picture showing a blue star", "a picture showing a red star"],
]
LOADED_PROMPT = "a photo of a red diamond"     # red-loaded: big biased gap
NEUTRAL_PROMPT = "a photo of a green circle"   # color-neutral wrt red/blue


def run_cli(module: str, args: list, log_path: str) -> dict:
    """Run one of the port's CLIs; return the last JSON line of its
    stdout (and note its seconds in ``SECONDS``)."""
    cmd = [sys.executable, "-m", f"clip_lite_torch.{module}"] + args
    print("+", " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    SECONDS[os.path.basename(log_path)[:-4]] = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"{module} failed rc={r.returncode}; "
                           f"log: {log_path}\n{r.stderr[-2000:]}")
    for line in reversed(r.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"{module} printed no JSON; log: {log_path}")


def main(_A) -> dict:
    run_dir = _A.run_dir
    synth = _A.synth_root
    families = set(_A.families.split(","))
    failures = {}

    def attempt(name: str, fn):
        """One family that fails does not lose the rest of the run."""
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — recorded, not swallowed
            print(f"!! {name} FAILED: {e}", flush=True)
            failures[name] = str(e)
            return None

    work = _A.work_dir or tempfile.mkdtemp(prefix="quality_")
    os.makedirs(work, exist_ok=True)
    pre_cfg = os.path.join(run_dir, "pretrain_config.yaml")
    # One RUN_ID directory only: a reused run_dir can hold several (a
    # crashed run and its re-run), whose checkpoints would mix under the
    # same step keys.  Take the most recently written one.
    all_ckpts = glob.glob(
        os.path.join(run_dir, "*", "checkpoint_[0-9]*.msgpack"))
    if not all_ckpts:
        raise SystemExit(f"no checkpoints under {run_dir}")
    by_run = {}
    for p in all_ckpts:
        by_run.setdefault(os.path.dirname(p), []).append(p)
    if len(by_run) > 1:
        print(f"!! {len(by_run)} RUN_ID dirs under {run_dir}; "
              "using the most recent", flush=True)
    run_subdir = max(by_run, key=lambda d: max(os.path.getmtime(p)
                                               for p in by_run[d]))
    ckpts = sorted(by_run[run_subdir],
                   key=lambda p: int(p.rsplit("_", 1)[1].split(".")[0]))
    final = ckpts[-1]
    n_sweep = _A.retrieval_checkpoints
    sweep = ckpts[-n_sweep:] if n_sweep > 0 else []
    step_of = lambda p: int(p.rsplit("_", 1)[1].split(".")[0])

    out = {"run_dir": run_dir, "final_checkpoint": final,
           "checkpoints": {}, "final": {}}

    # The val losses, from the training run's metrics stream.
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(metrics_path):
        val_losses = {}
        with open(metrics_path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("split") == "val":
                    val_losses[str(rec["iteration"])] = rec["total_loss"]
        out["val_loss"] = val_losses

    sweep_plat = (["--device", _A.sweep_device]
                  if _A.sweep_device else [])
    if "sweep" in families:
        for ckpt in sweep:
            step = step_of(ckpt)
            entry = out["checkpoints"].setdefault(str(step), {})
            entry["retrieval"] = attempt("retrieval", lambda: run_cli(
                "retrieval", sweep_plat + [
                    "--config-override", "DATA.ROOT", f"{synth}/coco",
                    "--pretrain-config", pre_cfg, "--checkpoint-path", ckpt,
                    "--serialization-dir", work,
                ], f"{work}/retrieval_{step}.log"))
            entry["zero_shot"] = attempt("zero_shot", lambda: run_cli(
                "zero_shot", sweep_plat + [
                    "--config-override", "DATA.ROOT", f"{synth}/imagenet",
                    "--pretrain-config", pre_cfg, "--checkpoint-path", ckpt,
                    "--serialization-dir", work,
                ], f"{work}/zero_shot_{step}.log"))
            print(f"[{step}] retrieval+zero_shot done: {entry}", flush=True)

    probe_overrides = [
        "DATA.ROOT", f"{synth}/imagenet",
        # color is label-bearing: no jitter, no flip needed for shapes
        "DATA.IMAGE_TRANSFORM_TRAIN", "['random_resized_crop','normalize']",
        "OPTIM.BATCH_SIZE", "64", "OPTIM.NUM_ITERATIONS",
        str(_A.probe_iters), "OPTIM.WARMUP_STEPS", "50",
        "OPTIM.LR", "0.03", "OPTIM.CNN_LR", "0.03",
        "OPTIM.LR_DECAY_NAME", "cosine",
    ]
    if "probe" in families:
        out["final"]["linear_probe"] = attempt("linear_probe", lambda: run_cli(
            "linear_clf", [
                "--config-override", *probe_overrides,
                "--pretrain-config", pre_cfg, "--checkpoint-path", final,
                "--frozen", "--serialization-dir", f"{work}/probe",
            ], f"{work}/linear_probe.log"))
        # The control: the same probe on a random-init tower, the number
        # the pretrained one is read against.
        out["final"]["linear_probe_random_init"] = attempt(
            "linear_probe_random_init", lambda: run_cli("linear_clf", [
                "--config-override", *probe_overrides,
                "--pretrain-config", pre_cfg,
                "--frozen", "--serialization-dir", f"{work}/probe_rand",
            ], f"{work}/linear_probe_rand.log"))

    if "voc" in families:
        out["final"]["voc07_svm"] = attempt("voc07_svm", lambda: run_cli(
            "voc_clf", [
                "--config-override", "DATA.ROOT", f"{synth}/VOC2007",
                "--pretrain-config", pre_cfg, "--checkpoint-path", final,
                "--serialization-dir", work,
            ], f"{work}/voc_clf.log"))

    if "bias" in families:
        pairs_path = os.path.join(work, "definitional_pairs.json")
        with open(pairs_path, "w") as f:
            json.dump(DEFINITIONAL_PAIRS, f)
        for name, prompt in (("loaded", LOADED_PROMPT),
                             ("neutral", NEUTRAL_PROMPT)):
            out["final"][f"bias_{name}"] = attempt(f"bias_{name}", lambda: run_cli(
                "bias_eda", [
                    "--config-override", "DATA.ROOT", f"{synth}/coco_gender",
                    "--pretrain-config", pre_cfg, "--checkpoint-path", final,
                    "--definitional-pairs", pairs_path, "--prompt", prompt,
                    "--cache-dir", f"{work}/gender_cache",
                    "--serialization-dir", work,
                ], f"{work}/bias_{name}.log"))

    out["seconds"] = dict(SECONDS)
    if failures:
        out["failures"] = failures
    with open(_A.output, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out["final"], indent=1))
    print(f"wrote {_A.output}; logs in {work}")
    return out


if __name__ == "__main__":
    main(parser.parse_args())
