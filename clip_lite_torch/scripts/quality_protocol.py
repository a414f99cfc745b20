"""The quality protocol of the JAX package's round-5 campaign, on the card
through the port's CLIs, into one JSON: the synthetic corpus, seeded
10k-step runs of ``configs/fs_tpu_tuned.yaml`` through the device cache
(batch 128, CNN LR 0.025, LR and TRANS_LR 1.25e-4, warmup 500, a
checkpoint every 2500; the JAX ``campaign_worker.py:74-89``), each swept
by ``quality_campaign`` (retrieval and zero-shot at every checkpoint),
the heavy families on seed 0's last checkpoint, the cluster leg
(``cluster.py`` on seed 0's checkpoint at 7500, k 2-10, both splits,
then that run resumed into the cluster curriculum through the host
loader) and the visual SSL leg.  The protocol's values are this module's
constants.

Each stage is a subprocess of a port CLI (``python -m clip_lite_torch...``),
its output kept under ``--work-dir``; the JSON (``--output``) is written
again after every stage, so that a run cut short keeps what it finished.
A stage that fails is recorded under ``failures``, the next one runs, and
the script exits 1 at the end.  Each seed's retrieval ``r_mean`` and
zero-shot top-1 are set against the JAX package's three-seed spread at
the same step (``QUALITY_r05.json``), mean ± 2 std (``jax_band``).

Stages (``--stages``, in the order given): ``data`` (make_synth_data with
the JAX orchestration's arguments, ``SYNTH``: 6,000 training and 500 val
scenes from seed 0, as ``clip_lite_tpu/scripts/run_quality_r5.sh`` makes
them; coco_preprocess of both splits), ``seed0``,
``seed1``, ... (train and sweep), ``heavy`` (probe, VOC07 SVM, bias on
seed 0), ``clusters`` (the cluster leg, run for at most
``--cluster-seconds``; its loss stream is what it reached), ``ssl`` (the
visual SSL run, for at most ``--ssl-seconds``, then swept).

Run (on the card):
    python -m clip_lite_torch.scripts.quality_protocol --work-dir /tmp/q \\
        --output QUALITY.json --stages data,seed0,heavy,clusters
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import subprocess
import sys
import time

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--work-dir", required=True)
parser.add_argument("--output", required=True)
parser.add_argument("--stages", default="data,seed0,heavy,clusters")
parser.add_argument("--cluster-seconds", type=float, default=1500.0)
parser.add_argument("--ssl-seconds", type=float, default=900.0)

CONFIG = "configs/fs_tpu_tuned.yaml"
PROTOCOL = ["OPTIM.BATCH_SIZE", "128", "OPTIM.CNN_LR", "0.025",
            "OPTIM.TRANS_LR", "0.000125", "OPTIM.LR", "0.000125",
            "OPTIM.WARMUP_STEPS", "500"]
ITERATIONS, CHECKPOINT_EVERY, LOG_EVERY = 10000, 2500, 100
CLUSTER_START = 7500  # seed 0's checkpoint that the cluster leg resumes
# make_synth_data's arguments: those of the JAX campaign's corpus (every
# split is drawn from one generator in order, so the scene count fixes the
# val and zero-shot scenes too)
SYNTH = ["--seed", "0", "--train-n", "6000", "--val-n", "500"]
REFERENCE = "QUALITY_r05.json"  # the JAX package's three seeds
DEVICE = None  # every CLI's device: None for theirs, the card


def run(cmd: list, log_path: str, timeout=None) -> dict:
    """``python -m <cmd>``, its output to ``log_path``; its seconds, exit
    code and whether the time limit ended it."""
    full = [sys.executable, "-m"] + [str(c) for c in cmd]
    print("+", " ".join(full), flush=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        try:
            rc = subprocess.run(full, stdout=log, stderr=subprocess.STDOUT,
                                timeout=timeout).returncode
            cut = False
        except subprocess.TimeoutExpired:
            rc, cut = None, True
    out = {"seconds": time.perf_counter() - t0, "rc": rc, "cut": cut}
    if rc not in (0, None) or (rc is None and not cut):
        with open(log_path) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"{cmd[0]} failed ({out}); log {log_path}:\n{tail}")
    return out


def metrics_stream(run_dir: str) -> dict:
    """The run's metrics.jsonl by split: iteration -> losses."""
    out = {"train": {}, "val": {}}
    path = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(path):
        for line in open(path):
            rec = json.loads(line)
            out[rec.pop("split")][str(rec.pop("iteration"))] = rec
    return out


def step_times(log_path: str) -> dict:
    """The training log's "Time/iter" readings (each the mean of the 20
    steps before it): their median, min and max, and how many."""
    times = [float(t) for t in re.findall(r"Time/iter ([0-9.]+)s",
                                          open(log_path).read())]
    if not times:
        return {}
    return {"median_s": statistics.median(times), "min_s": min(times),
            "max_s": max(times), "readings": len(times)}


def band_check(out: dict, reference: str) -> dict:
    """Each seed's retrieval ``r_mean`` and zero-shot top-1 at every swept
    checkpoint against the JAX package's three-seed spread there
    (``reference``'s ``spread``): mean - 2 std to mean + 2 std."""
    with open(reference) as f:
        spread = json.load(f)["spread"]
    checks = {}
    for name, stage in out["stages"].items():
        for step, entry in stage.get("campaign", {}).get("checkpoints",
                                                          {}).items():
            if step not in spread or not name.startswith("seed"):
                continue
            got = {"retrieval_r_mean": (entry.get("retrieval") or {}).get(
                       "r_mean"),
                   "zero_shot_top1": (entry.get("zero_shot") or {}).get(
                       "zero_shot_top1")}
            for metric, value in got.items():
                ref = spread[step][metric]
                lo, hi = ref["mean"] - 2 * ref["std"], ref["mean"] + 2 * ref["std"]
                checks.setdefault(name, {}).setdefault(step, {})[metric] = dict(
                    value=value, band=[lo, hi],
                    within=value is not None and lo <= value <= hi)
    return checks


def checkpoint(run_dir: str, step: int) -> str:
    found = sorted(glob.glob(os.path.join(run_dir, "*",
                                          f"checkpoint_{step}.msgpack")))
    if not found:
        raise FileNotFoundError(f"no checkpoint_{step} under {run_dir}")
    return found[-1]


def main(_A) -> int:
    """Run the stages; 1 if any failed, else 0."""
    work = os.path.abspath(_A.work_dir)
    synth = os.path.join(work, "synth")
    os.makedirs(work, exist_ok=True)
    out = {"stages": {}}
    if os.path.exists(_A.output):
        with open(_A.output) as f:
            out = json.load(f)
    out["protocol"] = {
        "description": "the JAX package's round-5 quality protocol "
                       "(fs_tpu_tuned, synthetic corpus, batch 128, 10k "
                       "iterations) through the port's CLIs",
        "corpus": [str(a) for a in SYNTH]}
    failures = out.setdefault("failures", {})
    try:  # the card's name and power limit, beside every time here
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    except OSError:
        out["card"] = None
    dev = ["--device", DEVICE] if DEVICE else []

    def save():
        with open(_A.output, "w") as f:
            json.dump(out, f, indent=1)

    def train(name, extra, resume=None, timeout=None):
        run_dir = os.path.join(work, name)
        cmd = ["clip_lite_torch.train", *dev, "--config", CONFIG,
               "--serialization-dir", run_dir,
               "--checkpoint-every", CHECKPOINT_EVERY,
               "--log-every", LOG_EVERY, "--config-override",
               "DATA.ROOT", os.path.join(synth, "serialized"),
               *PROTOCOL, "OPTIM.NUM_ITERATIONS", ITERATIONS, *extra]
        if resume:
            cmd += ["--resume-from", resume]
        log = os.path.join(work, f"{name}.log")
        res = run(cmd, log, timeout)
        res["step_time"] = step_times(log)
        res["metrics"] = metrics_stream(run_dir)
        return run_dir, res

    def sweep(run_dir, name, families="sweep", n=4):
        result = os.path.join(work, f"{name}_{families.replace(',', '_')}.json")
        res = run(["clip_lite_torch.scripts.quality_campaign", "--run-dir",
                   run_dir, "--synth-root", synth, "--output", result,
                   "--work-dir", os.path.join(work, f"evals_{name}"),
                   "--families", families, "--retrieval-checkpoints", n,
                   *(["--sweep-device", DEVICE] if DEVICE else [])],
                  os.path.join(work, f"{name}_{families}.log"))
        with open(result) as f:
            return dict(json.load(f), campaign_seconds=res["seconds"])

    def stage(name, fn):
        print(f"== stage {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out["stages"][name] = fn()
            out["stages"][name]["stage_seconds"] = time.perf_counter() - t0
            failures.pop(name, None)
        except Exception as e:  # noqa: BLE001 - recorded, the next runs
            print(f"!! stage {name} failed: {e}", flush=True)
            failures[name] = str(e)[-3000:]
        save()

    def data():
        res = {"make_synth_data": run(
            ["clip_lite_torch.scripts.make_synth_data", "--output-dir", synth,
             *SYNTH], os.path.join(work, "synth.log"))}
        for split in ("train", "val"):
            res[f"coco_preprocess_{split}"] = run(
                ["clip_lite_torch.scripts.coco_preprocess", "--data-root",
                 os.path.join(synth, "coco"), "--split", split, "--mode",
                 "train_sbert", "--output-dir",
                 os.path.join(synth, "serialized"), "--short-edge", 256],
                os.path.join(work, f"preprocess_{split}.log"))
        return res

    def seed(n):
        def fn():
            run_dir, res = train(f"seed{n}", [
                "RANDOM_SEED", n, "DATA.DEVICE_CACHE", True,
                "DATA.CACHE_HOST_DIR", os.path.join(synth, "host_cache")])
            res["campaign"] = sweep(run_dir, f"seed{n}")
            return res
        return fn

    def heavy():
        return sweep(os.path.join(work, "seed0"), "seed0", "probe,voc,bias")

    def clusters():
        seed0 = os.path.join(work, "seed0")
        ckpt = checkpoint(seed0, CLUSTER_START)
        res = {"resumed_from": ckpt}
        for split in ("train", "val"):
            log = os.path.join(work, f"cluster_{split}.log")
            res[f"cluster_{split}"] = run(
                ["clip_lite_torch.scripts.cluster", *dev, "--coco-root",
                 os.path.join(synth, "coco"), "--split", split,
                 "--output-dir", os.path.join(synth, "clusters"),
                 "--min-clusters", 2, "--max-clusters", 10,
                 "--pretrain-config",
                 os.path.join(seed0, "pretrain_config.yaml"),
                 "--checkpoint-path", ckpt], log)
            res[f"cluster_{split}"]["summary"] = json.loads(
                open(log).read().strip().splitlines()[-1])
        _, res["train"] = train("clusters", [
            "RANDOM_SEED", 0, "DATA.NEGATIVE_SAMPLING", "clusters",
            "DATA.NEGATIVE_SAMPLING_START_ITERATION", CLUSTER_START,
            "DATA.CLUSTER_PATH", os.path.join(synth, "clusters"),
            "DATA.COCO_ROOT", os.path.join(synth, "coco")],
            resume=ckpt, timeout=_A.cluster_seconds)
        return res

    def ssl():
        run_dir, res = train("ssl", [
            "RANDOM_SEED", 0, "DATA.DEVICE_CACHE", True,
            "DATA.CACHE_HOST_DIR", os.path.join(synth, "host_cache"),
            "MODEL.VISUAL.SELF_SUPERVISED", True], timeout=_A.ssl_seconds)
        res["campaign"] = sweep(run_dir, "ssl")
        return res

    stages = {"data": data, "heavy": heavy, "clusters": clusters, "ssl": ssl}
    for name in _A.stages.split(","):
        if name.startswith("seed"):
            stage(name, seed(int(name[4:])))
        else:
            stage(name, stages[name])
    out["jax_band"] = band_check(out, REFERENCE)
    if not failures:
        out.pop("failures")
    save()
    print(json.dumps({k: sorted(v) if isinstance(v, dict) else v
                      for k, v in out["stages"].items()}))
    if failures:
        print(f"!! failed stages: {sorted(failures)}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(parser.parse_args()))
