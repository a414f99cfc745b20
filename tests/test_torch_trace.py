"""The port's step trace (clip_lite_torch/utils/trace.py, ``train.py
--profile-dir`` and ``scripts/perf_trace.py``) on the CPU.

* A tiny SSL train step on uint8 images traced with ``torch.profiler``:
  every component range is in the trace, the host's aten ops carry their
  scope, and the kernel-named ranges count the calls the step makes
  (K1 and K2 once a layer a text pass, K3's fused pass once an image
  batch).
* The parser's device path on a hand-made trace in the profiler's format
  (kernels linked to their launches by correlation id, the backward
  linked to its forward op by the flow events): scopes, flops on the
  longest kernel of an op, busy time, idle gaps, overlap, the step split.
* ``roofline_summary`` against the JAX package's on the same op list.
* ``device_specs`` knows the H100 SXM and raises for any other card.
* ``train --profile-dir --device cpu`` traces five steps after three and
  leaves the final checkpoint byte for byte as a run without the trace;
  ``perf_trace --device cpu --json`` prints one JSON line.
"""

import json
import os
import statistics

import numpy as np
import pytest
import torch

from clip_lite_tpu.utils import trace as jtrace
from clip_lite_torch.config import Config
from clip_lite_torch.engine import create_train_state, make_train_step
from clip_lite_torch.scripts import perf_trace
from clip_lite_torch.train import main, parser
from clip_lite_torch.utils import trace as T
from test_torch_cli import TINY, _args, _ckpt_dir
from test_torch_cli import corpus  # noqa: F401  (fixture)
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
B, L, CROP, LAYERS = 4, 8, 32, 2
COMPONENT_RANGES = ("train_step", "device_preprocess", "image_encoder",
                    "text_encoder", "loss", "backward", "optimizer")


# -- a traced step on the CPU --------------------------------------------------

@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """Two SSL steps (visual and textual on) of a tiny flagship on uint8
    batches, traced; with the wrappers' expected calls."""
    cfg = Config(FLAGSHIP, [
        "AMP", False, "MODEL.VISUAL.NETWORK_NAME", "resnet18",
        "MODEL.VISUAL.WIDTH", 8, "DATA.IMAGE_CROP_SIZE", CROP,
        "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", LAYERS,
        "MODEL.TEXTUAL.HIDDEN_SIZE", 64, "DATA.MAX_CAPTION_LENGTH", L,
        "MODEL.TEXTUAL.VOCAB_SIZE", 128, "MODEL.TEXTUAL.FUSED_ATTENTION", "true",
        "MODEL.VISUAL.SELF_SUPERVISED", True,
        "MODEL.TEXTUAL.SELF_SUPERVISED", True])
    state = create_train_state(cfg, device="cpu")
    step = make_train_step(cfg)
    rng = np.random.RandomState(0)

    def batch():
        ids = rng.randint(1, 128, (B, L)).astype(np.int32)
        return {"image": rng.randint(0, 256, (B, CROP, CROP, 3)).astype(np.uint8),
                "aug_image": rng.randint(0, 256, (B, CROP, CROP, 3)
                                         ).astype(np.uint8),
                "input_ids": ids, "attention_mask": np.ones((B, L), np.int32),
                "aug_input_ids": ids[::-1].copy(),
                "aug_attention_mask": np.ones((B, L), np.int32)}

    batches = [batch(), batch()]

    def run():
        nonlocal state
        for b in batches:
            state, _ = step(state, b)

    path = T.capture_trace(run, str(tmp_path_factory.mktemp("trace")), "cpu")
    return T.Trace(path), len(batches)


def test_cpu_trace_holds_every_component_range(cpu_trace):
    tr, steps = cpu_trace
    names = [e["name"] for e in tr.host if e["cat"] == "user_annotation"]
    for name in COMPONENT_RANGES:
        assert name in names, name
    assert names.count("train_step") == steps
    assert len(tr.ranges("train_step")) == steps
    ops = tr.ops()
    assert ops and {o["category"] for o in ops} == {"host"}
    summary = T.roofline_summary(ops, steps)
    assert {"resnet", "bert", "loss", "optimizer", "input"} <= set(
        summary["by_component"])
    assert summary["flops_roofline_ms"] is None
    assert summary["total_gflops_per_step"] > 0  # with_flops counted matmuls
    assert 0 < summary["busy_ms"] <= summary["window_ms"]
    # Backward ops carry their forward op's scope.
    scopes = {o["scope"] for o in ops}
    assert any(s.startswith("train_step/image_encoder/backward") for s in scopes)
    assert any(s.startswith("train_step/text_encoder/backward") for s in scopes)
    split = T.step_split(tr, ops=ops)
    assert len(split) == steps
    host = T.host_ranges(tr)
    assert {"device_preprocess", "image_encoder", "text_encoder", "loss",
            "backward", "optimizer", "other"} <= set(host)
    assert sum(host.values()) == pytest.approx(
        statistics.mean(s["enqueue_ms"] for s in split))
    for s in split:
        assert 0 < s["busy_ms"] <= s["window_ms"] and s["enqueue_ms"] > 0


def test_kernel_ranges_count_the_step_calls(cpu_trace):
    """Per step: two text passes (the caption and its SSL view) of LAYERS
    layers each way, and K3's fused pass for the image and its view."""
    tr, steps = cpu_trace
    calls = {k: len(tr.ranges(k)) for k in T.KERNEL_RANGES}
    assert calls == {"K1 attention_fwd": 2 * LAYERS * steps,
                     "K2 attention_bwd": 2 * LAYERS * steps,
                     "K3 normalize_u8": 0,
                     "K3 augment_normalize_u8": 2 * steps,
                     "crop_resize_flip_u8": 0}
    scoped = {o["scope"] for o in tr.ops()}
    assert "train_step/text_encoder/K1 attention_fwd" in scoped
    assert "train_step/text_encoder/backward/K2 attention_bwd" in scoped
    assert "train_step/device_preprocess/K3 augment_normalize_u8" in scoped


def test_scope_costs_nothing_untraced():
    assert not torch.autograd._profiler_enabled()
    assert not isinstance(T.scope("x"), torch.profiler.record_function)


# -- the device path on a hand-made trace --------------------------------------

def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def _kernel(name, ts, dur, corr, stream=7):
    return _x("kernel", name, ts, dur, tid=stream, correlation=corr,
              stream=stream)


def hand_made_trace():
    """Two steps of 100 us on the host's thread 1; autograd's thread 2
    runs step 1's backward; a decode stream 9 runs nvJPEG's kernel."""
    ev = [
        _x("user_annotation", "train_step", 0, 40),
        _x("user_annotation", "text_encoder", 2, 20),
        _x("cpu_op", "aten::addmm", 3, 10, flops=2e9),
        _x("cuda_runtime", "cudaLaunchKernel", 4, 1, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=2),
        _x("user_annotation", "K1 attention_fwd", 14, 4),
        _x("cuda_runtime", "cudaLaunchKernel", 15, 1, correlation=3),
        _x("user_annotation", "optimizer", 30, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 31, 1, correlation=4),
        _x("cuda_runtime", "cudaStreamSynchronize", 36, 3),
        _x("cuda_runtime", "cudaMemcpyAsync", 1, 1),
        _x("cuda_runtime", "cudaMemcpyAsync", 1, 1, tid=3),  # another thread
        # The backward of the addmm on autograd's thread.
        _x("cpu_op", "autograd::engine::evaluate_function: AddmmBackward0",
           20, 10, tid=2),
        _x("cpu_op", "AddmmBackward0", 21, 4, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 22, 1, tid=2, correlation=5),
        _x("cpu_op", "aten::sum", 26, 3, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 27, 1, tid=2, correlation=6),
        {"ph": "s", "cat": "fwdbwd", "name": "fwdbwd", "id": 1, "pid": 1,
         "tid": 1, "ts": 3},
        {"ph": "f", "cat": "fwdbwd", "name": "fwdbwd", "id": 1, "pid": 1,
         "tid": 2, "ts": 21, "bp": "e"},
        _x("user_annotation", "train_step", 100, 30),
        _x("cuda_runtime", "cudaLaunchKernel", 101, 1, correlation=7),
        _kernel("ampere_gemm", 10, 20, 1),
        _kernel("elementwise", 30, 5, 2),
        _kernel("void attention_fwd_tc_kernel<64>", 35, 5, 3),
        _kernel("gemm_grad", 40, 10, 5),
        _kernel("reduce", 50, 2, 6),
        _kernel("multi_tensor_apply", 60, 10, 4),
        _kernel("elementwise", 110, 20, 7),
        _kernel("void nvjpeg::batchedDctQuantInvJpegKernel", 55, 10, 99,
                stream=9),
        _x("gpu_memcpy", "Memcpy HtoD", 0, 8, tid=7, correlation=98,
           bytes=3.35e6),
    ]
    return {"traceEvents": ev}


def test_parse_device_trace():
    tr = T.Trace(hand_made_trace())
    ops = {(o["name"], o["ts_us"]): o for o in tr.ops()}
    assert len(ops) == 9
    assert ops["ampere_gemm", 10]["scope"] == "train_step/text_encoder"
    assert ops["ampere_gemm", 10]["flops"] == 2e9  # the longer of its two
    assert ops["elementwise", 30]["flops"] == 0.0
    assert ops["void attention_fwd_tc_kernel<64>", 35]["scope"] == \
        "train_step/text_encoder/K1 attention_fwd"
    # Backward: the node and the engine's work beside it.
    assert ops["gemm_grad", 40]["scope"] == "train_step/text_encoder/backward"
    assert ops["reduce", 50]["scope"] == "train_step/text_encoder/backward"
    assert ops["multi_tensor_apply", 60]["scope"] == "train_step/optimizer"
    nv = ops["void nvjpeg::batchedDctQuantInvJpegKernel", 55]
    assert nv["scope"] == "" and nv["stream"] == 9
    assert ops["Memcpy HtoD", 0]["category"] == "memcpy"
    assert T.kernel_counts(tr.ops())["K1 attention_fwd"] == 1
    assert T.component_of("train_step/text_encoder/backward") == "bert"
    assert T.component_of("") == "unattributed"

    summary = T.roofline_summary(tr.ops(), 2, 989.0, 3350.0)
    # Kernels busy over [10, 52), [55, 70) and [110, 130) us, over 2 steps.
    assert T.busy_intervals(tr.ops()) == [(10, 52), (55, 70), (110, 130)]
    assert summary["busy_ms"] == round(77 / 2e3, 3)
    assert summary["flops_roofline_ms"] == pytest.approx(
        round(2e9 / 989e12 * 1e3 / 2, 3), abs=1e-6)
    assert summary["by_component"]["bert"]["n"] == 2  # 5 over 2 steps
    split = T.step_split(tr)
    assert [s["enqueue_ms"] for s in split] == [0.04, 0.03]
    assert split[0]["window_ms"] == pytest.approx(0.1)
    assert split[0]["busy_ms"] == pytest.approx(0.057)
    assert split[1]["window_ms"] == pytest.approx(0.03)  # to the last kernel
    assert split[1]["busy_ms"] == pytest.approx(0.02)
    host = T.host_ranges(tr)
    assert host == pytest.approx({"text_encoder": 0.01, "optimizer": 0.0025,
                                  "other": 0.035 - 0.0125})
    gaps = T.idle_gaps(tr, top=2)
    assert [g["gap_ms"] for g in gaps] == pytest.approx([0.04, 0.003])
    assert gaps[0]["start_ms"] == pytest.approx(0.07)
    assert T.sync_ms(tr) == {"cudaStreamSynchronize": 0.003,
                             "cudaMemcpyAsync": 0.001}
    assert T.overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert T.union_us([(3, 5), (0, 4), (6, 7)]) == [(0, 5), (6, 7)]


def test_roofline_summary_matches_jax():
    rng = np.random.RandomState(0)
    scopes = ["train_step/image_encoder/backbone", "text_encoder/layer_0",
              "train_step/loss/global_d", "lookahead", "", "elsewhere"]
    ops = []
    for i in range(40):
        ops.append({"name": f"k{i}", "scope": scopes[i % len(scopes)],
                    "category": ("kernel", "memcpy", "memset")[i % 3],
                    "dur_us": float(rng.uniform(1, 100)),
                    "flops": float(rng.choice([0.0, rng.uniform(1e6, 1e10)])),
                    "bytes": float(rng.choice([0.0, rng.uniform(1e3, 1e8)])),
                    "ts_us": float(10 * i), "stream": 7, "correlation": i})
    jops = [dict(o, tf_op=o["scope"]) for o in ops]
    got = T.roofline_summary(ops, 4, 197.0, 819.0)
    want = jtrace.roofline_summary(jops, 4, 197.0, 819.0)
    for key, value in want.items():
        assert got[key] == value, key


def test_device_specs(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert T.device_specs("cuda:0") == (989.0, 3350.0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="unknown card"):
        T.device_specs("cuda:0")
    with pytest.raises(ValueError):
        T.device_specs("cpu")
    # Where the JAX function prints and returns None, the port raises.
    with pytest.raises(RuntimeError, match="no ops"):
        T.trace_step_roofline(lambda: None, 1, str(tmp_path / "t"), "cpu")


# -- the CLIs --------------------------------------------------------------------

def test_train_profile_dir_changes_no_result(corpus, tmp_path):  # noqa: F811
    """The trace goes into the run's own serialization directory, beside
    what the run and the user put there, and takes nothing of it away."""
    steps = ["OPTIM.NUM_ITERATIONS", 8]
    plain = _args(corpus, tmp_path / "plain", extra=steps)
    plain.checkpoint_every = 100
    run_dir = tmp_path / "traced"
    run_dir.mkdir()
    (run_dir / "notes.txt").write_text("kept")
    traced = _args(corpus, run_dir, extra=steps,
                   flags=("--profile-dir", str(run_dir)))
    traced.checkpoint_every = 100
    main(plain)
    main(traced)
    files = [os.path.join(_ckpt_dir(a), "checkpoint_8.msgpack")
             for a in (plain, traced)]
    with open(files[0], "rb") as a, open(files[1], "rb") as b:
        assert a.read() == b.read()
    tr = T.Trace(str(run_dir / "trace.json.gz"))
    assert len(tr.ranges("train_step")) == 5
    assert (run_dir / "notes.txt").read_text() == "kept"
    metrics = (run_dir / "metrics.jsonl").read_text().splitlines()
    assert json.loads(metrics[0])["iteration"] < 4  # written before the trace
    log = (run_dir / "log_pretrain.txt").read_text()
    assert "Profiler trace written" in log and "(steps 4..8)" in log
    assert parser.get_default("profile_dir") is None


def test_trace_replaces_only_its_own_file(tmp_path):
    """capture_trace writes ``trace.json.gz`` into a directory that holds
    other files (a trace of its own among them), replaces that one file
    and leaves the rest, leaving no file of its own behind but the trace."""
    (tmp_path / "trace.json").write_text("a user's file")
    (tmp_path / "trace.json.gz").write_text("an old trace")
    path = T.capture_trace(lambda: torch.ones(3).sum(), str(tmp_path), "cpu")
    assert path == str(tmp_path / "trace.json.gz")
    assert sorted(os.listdir(tmp_path)) == ["trace.json", "trace.json.gz"]
    assert (tmp_path / "trace.json").read_text() == "a user's file"
    assert any(e["name"] == "aten::sum" for e in T.Trace(path).host)


def test_perf_trace_cpu_json(capsys, tmp_path):
    out = perf_trace.main([
        "--device", "cpu", "--batch", "2", "--seq", "6", "--steps", "1",
        "--json", "--trace-dir", str(tmp_path / "t"), "--override",
        *[str(x) for x in TINY if x not in ("MODEL.NAME", "captions")]])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(out))
    assert out["n_steps"] == 3 and out["step_ms"] > 0
    assert out["busy_ms"] > 0 and out["per_op_roofline_ms"] is None
    assert {"resnet", "bert", "optimizer"} <= set(out["by_component"])


def test_warm_up_is_not_in_the_trace(tmp_path):
    """What runs in the profiler's warm-up stays out of the trace; what
    runs after :func:`record_trace` is in it, with no range of the
    profiler's own in its scopes."""
    x = torch.ones(3)

    def run():
        with T.scope("measured"):
            x.sum()

    tr = T.Trace(T.capture_trace(run, str(tmp_path), "cpu",
                                 warmup_fn=lambda: x.prod()))
    names = {e["name"] for e in tr.host}
    assert "aten::sum" in names and "aten::prod" not in names
    assert {o["scope"] for o in tr.ops()} == {"measured"}
