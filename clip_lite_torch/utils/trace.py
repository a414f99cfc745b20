"""Step traces on ``torch.profiler``: capture, per-op parse and roofline,
the counterpart of the JAX package's ``utils/trace.py``.

* :func:`capture_trace` runs a callable under ``torch.profiler.profile``
  (the CPU activity, and the CUDA activity on a CUDA device, shapes and
  flops recorded), after another in the profiler's warm-up, and writes a
  Chrome trace, the flops of each aten op added to its event, as
  ``trace.json.gz``; :func:`start_trace`, :func:`record_trace` and
  :func:`stop_trace` do the same around a stretch of a loop;
* :func:`parse_trace_ops` gives the device's events (kernels, copies,
  sets) with their duration, start, stream, correlation id, the scope of
  the ranges they were launched in and the flops of the aten op that
  launched them; on a trace of the CPU alone, the host's innermost aten
  ops in their place;
* :func:`roofline_summary` sets the measured device time beside two
  floors, flops over the peak rate and the per-op max(flops / peak,
  bytes / HBM rate), and adds the device's busy time (the union of its
  kernels) and the trace's window, so that the idle share can be read;
* :func:`step_split`, :func:`host_ranges`, :func:`idle_gaps`,
  :func:`sync_ms` and :func:`overlap_us` split a trace by the step
  ranges.

Scopes.  The port's code opens ``torch.profiler.record_function`` ranges
while a profiler runs (:func:`scope`, :func:`traced`; nothing otherwise):
``train_step``, ``device_preprocess``, ``image_encoder``,
``text_encoder``, ``loss``, ``backward`` and ``optimizer`` in the step,
``next_batch`` around the loop's fetch, and one named after each
hand-written kernel in its wrapper (:data:`KERNEL_RANGES`).  A kernel's
scope is the path of the ranges around its launch.  Backward work runs on
autograd's own thread outside those ranges; its scope is the scope of the
forward op that made its autograd node (the trace's forward-backward flow
events), then ``backward``, then the ranges inside the node (K2's).  A
thread started before the profiler (a loader's) records no ranges, so
its kernels have an empty scope (``unattributed``).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import gzip
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch

# Dense bf16 tensor-core peak (TFLOP/s) and HBM rate (GB/s), by the name
# torch.cuda.get_device_name gives.
DEVICE_SPECS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3350.0),  # H100 SXM5
}

DEVICE_CATEGORIES = {"kernel": "kernel", "gpu_memcpy": "memcpy",
                     "gpu_memset": "memset"}
_HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_BACKWARD_NODE = "autograd::engine::evaluate_function"
_KERNEL_LAUNCH = re.compile(r"Launch(Cooperative)?Kernel")

# The kernels written for the port, by the name of their wrapper's range,
# and a pattern of their device names.
KERNEL_RANGES = {
    "K1 attention_fwd": r"attention_fwd(_tc)?_kernel",
    "K2 attention_bwd": r"attention_bwd(_tc)?_kernel",
    "K3 normalize_u8": r"(?<!augment_)normalize_kernel",
    "K3 augment_normalize_u8": r"augment_normalize_kernel",
    "crop_resize_flip_u8": r"crop_resize_flip_kernel",
}

TraceLike = Union[str, dict, "Trace"]


def device_specs(device) -> Tuple[float, float]:
    """(peak bf16 TFLOP/s, HBM GB/s) of the CUDA ``device``; raises for a
    card the table does not know (no card is assumed)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no roofline for {device}: the rates are a card's")
    name = torch.cuda.get_device_name(device)
    if name not in DEVICE_SPECS:
        raise KeyError(f"unknown card {name!r}: add its dense bf16 peak and "
                       "memory rate to DEVICE_SPECS")
    return DEVICE_SPECS[name]


def scope(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs,
    else a context that does nothing (no host time on the untraced
    path)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def traced(name: str) -> Callable:
    """Decorate a function to run inside :func:`scope` ``name``: a kernel
    wrapper's range, around its launch on the card and its twin on the
    CPU alike."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with scope(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def start_trace(device="cuda"):
    """Start a ``torch.profiler.profile`` of the CPU activity, and of the
    CUDA activity on a CUDA ``device``, shapes and flops recorded, in its
    warm-up: the tracers are on and nothing is kept until
    :func:`record_trace`; stop it with :func:`stop_trace`.  The card's
    tracer can lose the first kernels launched after it is switched on,
    so run a step of the same work in the warm-up (a trace begun without
    one lost up to a dozen kernels of its first step)."""
    prof_ = torch.profiler
    activities = [prof_.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(prof_.ProfilerActivity.CUDA)
    prof = prof_.profile(activities=activities, record_shapes=True,
                         with_flops=True,
                         schedule=prof_.schedule(wait=0, warmup=1, active=1))
    prof.start()
    return prof


def record_trace(prof, device="cuda") -> None:
    """Begin to keep the events of ``prof`` (from :func:`start_trace`); on
    a CUDA ``device`` after a synchronize, so that no kernel of the
    warm-up runs inside the record."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    prof.step()


def stop_trace(prof, outdir: str, device="cuda") -> str:
    """Stop ``prof`` (on a CUDA ``device`` after a synchronize, so that
    every kernel launched is in the trace) and write its trace as
    ``outdir/trace.json.gz``, making ``outdir`` where it is missing and
    touching nothing else in it; returns the path."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(outdir, exist_ok=True)
    fd, raw = tempfile.mkstemp(prefix=".trace-", suffix=".json", dir=outdir)
    os.close(fd)
    try:
        prof.export_chrome_trace(raw)
        with open(raw) as f:
            data = json.load(f)
    finally:
        os.remove(raw)
    # The Chrome export leaves out the flops; the profiler's events carry
    # them under their correlation id, the trace's "External id".
    flops = {e.correlation_id(): e.flops()
             for e in prof.profiler.kineto_results.events() if e.flops()}
    for e in data.get("traceEvents", []):
        args = e.get("args")
        if e.get("cat") == "cpu_op" and args \
                and args.get("External id") in flops:
            args["flops"] = flops[args["External id"]]
    path = os.path.join(outdir, "trace.json.gz")
    with gzip.open(path, "wt", compresslevel=1) as f:
        json.dump(data, f)
    return path


def capture_trace(run_fn: Callable[[], None], outdir: str, device="cuda",
                  warmup_fn: Optional[Callable[[], None]] = None) -> str:
    """Run ``warmup_fn`` (if any) in the profiler's warm-up
    (:func:`start_trace`), then ``run_fn`` in its record
    (:func:`record_trace`), and return the path of the trace,
    ``outdir/trace.json.gz`` (:func:`stop_trace`)."""
    prof = start_trace(device)
    try:
        if warmup_fn is not None:
            warmup_fn()
        record_trace(prof, device)
        run_fn()
    except BaseException:
        prof.stop()
        raise
    return stop_trace(prof, outdir, device)


def read_trace(path: str) -> dict:
    """A Chrome trace, ``.json`` or ``.json.gz``."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


class Trace:
    """A parsed trace: host spans with their parents, device events with
    the host span that launched them."""

    def __init__(self, trace: Union[str, dict]):
        data = read_trace(trace) if isinstance(trace, str) else trace
        events = [e for e in data.get("traceEvents", [])
                  if e.get("ph") == "X" and "dur" in e]
        # The profiler's own step range (its schedule's) is no scope.
        self.host = [e for e in events if e.get("cat") in _HOST_CATEGORIES
                     and not e.get("name", "").startswith("ProfilerStep#")]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
        self._parent = self._parents(self.host)
        self._at = {(e["tid"], e["ts"]): i for i, e in enumerate(self.host)
                    if e["cat"] == "cpu_op"}
        self._launch = {e["args"]["correlation"]: i
                        for i, e in enumerate(self.host)
                        if e["cat"] in ("cuda_runtime", "cuda_driver")
                        and "correlation" in e.get("args", {})}
        self._forward = self._flows(data.get("traceEvents", []))
        self._scopes: Dict[int, Tuple[str, ...]] = {}

    @staticmethod
    def _parents(host: List[dict]) -> List[Optional[int]]:
        """The innermost enclosing span on the same thread, by time."""
        parent: List[Optional[int]] = [None] * len(host)
        by_tid = defaultdict(list)
        for i, e in enumerate(host):
            by_tid[e["tid"]].append(i)
        for idx in by_tid.values():
            idx.sort(key=lambda i: (host[i]["ts"], -host[i]["dur"]))
            stack: List[int] = []
            for i in idx:
                ts = host[i]["ts"]
                while stack and host[stack[-1]]["ts"] + host[stack[-1]]["dur"] <= ts:
                    stack.pop()
                parent[i] = stack[-1] if stack else None
                stack.append(i)
        return parent

    def _flows(self, raw: List[dict]) -> Dict[int, int]:
        """Backward node span -> the forward op span that made it."""
        start, end = {}, {}
        for e in raw:
            if e.get("cat") == "fwdbwd" and e.get("ph") in ("s", "f"):
                (start if e["ph"] == "s" else end)[e["id"]] = (e["tid"], e["ts"])
        out = {}
        for fid, at in end.items():
            if fid in start and at in self._at and start[fid] in self._at:
                node, forward = self._at[at], self._at[start[fid]]
                out[node] = forward
                # The engine's own work for the node (summing a broadcast
                # gradient, accumulating an input's) runs beside the node
                # op, inside its evaluate_function span.
                parent = self._parent[node]
                if parent is not None and self.host[parent]["name"].startswith(
                        _BACKWARD_NODE):
                    out[parent] = forward
        return out

    def chain(self, i: Optional[int]) -> Iterable[int]:
        while i is not None:
            yield i
            i = self._parent[i]

    def scope_of(self, i: Optional[int]) -> Tuple[str, ...]:
        """The ranges around host span ``i``, outermost first; across an
        autograd node, the forward op's scope, then ``backward``."""
        if i is None:
            return ()
        if i in self._scopes:
            return self._scopes[i]
        inner: List[str] = []
        out: Tuple[str, ...] = ()
        for j in self.chain(i):
            e = self.host[j]
            if j in self._forward:
                out = self.scope_of(self._forward[j]) + ("backward",)
                break
            if e["cat"] == "user_annotation":
                inner.append(e["name"])
        out = out + tuple(reversed(inner))
        self._scopes[i] = out
        return out

    def lost_launches(self) -> List[int]:
        """The host spans of kernel launches whose kernel the trace lacks,
        in time order (a complete trace has none)."""
        seen = {e.get("args", {}).get("correlation") for e in self.device}
        return sorted((i for c, i in self._launch.items() if c not in seen
                       and _KERNEL_LAUNCH.search(self.host[i]["name"])),
                      key=lambda i: self.host[i]["ts"])

    def launcher(self, event: dict) -> Optional[int]:
        return self._launch.get(event.get("args", {}).get("correlation"))

    def flops_owner(self, i: Optional[int]) -> Optional[int]:
        for j in self.chain(i):
            if self.host[j].get("args", {}).get("flops"):
                return j
        return None

    def leaf_ops(self) -> List[int]:
        """Host aten ops with no aten op inside them."""
        has_child = {self._parent[i] for i, e in enumerate(self.host)
                     if e["cat"] == "cpu_op"}
        return [i for i, e in enumerate(self.host)
                if e["cat"] == "cpu_op" and i not in has_child]

    def ops(self) -> List[Dict]:
        if self.device:
            units = [(e, self.launcher(e), DEVICE_CATEGORIES[e["cat"]])
                     for e in self.device]
        else:
            units = [(self.host[i], i, "host") for i in self.leaf_ops()]
        ops, owners = [], defaultdict(list)
        for e, launcher, category in units:
            args = e.get("args", {})
            ops.append({
                "name": e.get("name", ""),
                "scope": "/".join(self.scope_of(launcher)),
                "category": category,
                "ts_us": float(e["ts"]),
                "dur_us": float(e["dur"]),
                "stream": args.get("stream", e.get("tid")),
                "correlation": args.get("correlation",
                                        args.get("External id")),
                "flops": 0.0,
                "bytes": float(args.get("bytes", 0.0) or 0.0),
            })
            owner = self.flops_owner(launcher)
            if owner is not None:
                owners[owner].append(len(ops) - 1)
        # An aten op's flops go to the longest unit it launched; the
        # others stay opaque.
        for owner, idx in owners.items():
            longest = max(idx, key=lambda k: ops[k]["dur_us"])
            ops[longest]["flops"] = float(self.host[owner]["args"]["flops"])
        return ops

    def ranges(self, name: str) -> List[dict]:
        """The host ranges named ``name``, in time order."""
        return sorted((e for e in self.host
                       if e["cat"] == "user_annotation" and e["name"] == name),
                      key=lambda e: e["ts"])


def _trace(trace: TraceLike) -> Trace:
    return trace if isinstance(trace, Trace) else Trace(trace)


def parse_trace_ops(trace: TraceLike) -> List[Dict]:
    """The device's events of a trace (a path to ``.json`` or
    ``.json.gz``, the loaded dict, or a :class:`Trace`): ``[{name, scope,
    category (kernel, memcpy, memset), ts_us, dur_us, stream,
    correlation, flops, bytes}]``.  ``flops`` is the ``with_flops`` count
    of the nearest aten op around the launch, given to the longest event
    that op launched (0 for the rest: opaque); ``bytes`` is a copy's
    size (0 for a kernel).  On a trace with no device events (the CPU
    alone) the host's innermost aten ops, with category ``host``."""
    return _trace(trace).ops()


_COMPONENT_RULES = (
    # Matched against the scope, e.g.
    # "train_step/text_encoder/backward/K2 attention_bwd".
    ("bert", re.compile(r"text_encoder|transformer|Bert|MPNet")),
    ("resnet", re.compile(r"image_encoder|backbone|ResNet|VGG")),
    ("loss", re.compile(r"(^|/)loss(/|$)|critic|discriminator|global_d")),
    ("optimizer", re.compile(r"optimizer|lookahead|sgd|adam")),
    ("input", re.compile(r"device_preprocess|crop_resize|decode")),
    ("unattributed", re.compile(r"^$")),
)


def component_of(scope: str) -> str:
    for name, rx in _COMPONENT_RULES:
        if rx.search(scope):
            return name
    return "other"


def union_us(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, merged, in order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_intervals(ops: List[Dict]) -> List[Tuple[float, float]]:
    """The union of the kernels' intervals (of the host ops on a CPU
    trace)."""
    return union_us((o["ts_us"], o["ts_us"] + o["dur_us"]) for o in ops
                    if o["category"] in ("kernel", "host"))


def clipped_us(merged: Sequence[Tuple[float, float]], lo: float,
               hi: float) -> float:
    """The length of the merged intervals inside [lo, hi)."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


def overlap_us(a: Sequence[Tuple[float, float]],
               b: Sequence[Tuple[float, float]]) -> float:
    """The length of the intersection of two unions of intervals."""
    a, b = union_us(a), union_us(b)
    total, j = 0.0, 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            total += max(0.0, min(hi, b[k][1]) - max(lo, b[k][0]))
            k += 1
    return total


def roofline_summary(ops: List[Dict], n_steps: int,
                     peak_tflops: Optional[float] = None,
                     hbm_gbps: Optional[float] = None,
                     window_us: Optional[float] = None) -> Dict:
    """Aggregate a trace's ops into per-step times against the floors, as
    the JAX package's ``roofline_summary``: an op's floor is max(flops /
    peak, min(bytes / HBM rate, its duration)), and an op with neither
    flops nor bytes (most kernels: the profiler counts flops for matrix
    products and convolutions only) is priced at its measured duration
    and summed into ``opaque_ms``.  Adds ``busy_ms`` (the union of the
    kernels' intervals), ``window_ms`` (``window_us``, by default the
    ops' span) and ``idle_share`` = 1 - busy / window.  Without rates (a
    CPU trace) the roofline keys are None."""
    per = 1e3 * n_steps
    measured_us = sum(o["dur_us"] for o in ops)
    rated = peak_tflops is not None and hbm_gbps is not None
    flops_us = bytes_us = bound_us = opaque_us = 0.0
    for o in ops:
        if o["flops"] == 0.0 and o["bytes"] == 0.0:
            opaque_us += o["dur_us"]
            bound_us += o["dur_us"]
        elif rated:
            f_us = o["flops"] / (peak_tflops * 1e6)
            b_us = min(o["bytes"] / (hbm_gbps * 1e3), o["dur_us"])
            flops_us += f_us
            bytes_us += b_us
            bound_us += max(f_us, b_us)
    busy = busy_intervals(ops)
    busy_us = sum(b - a for a, b in busy)
    if window_us is None:
        window_us = (max(o["ts_us"] + o["dur_us"] for o in ops)
                     - min(o["ts_us"] for o in ops)) if ops else 0.0

    by_cat = defaultdict(lambda: {"ms": 0.0, "gbytes": 0.0, "n": 0})
    by_comp = defaultdict(lambda: {"ms": 0.0, "gbytes": 0.0, "n": 0})
    for o in ops:
        for key, table in ((o["category"], by_cat),
                           (component_of(o["scope"]), by_comp)):
            table[key]["ms"] += o["dur_us"] / per
            table[key]["gbytes"] += o["bytes"] / 1e9 / n_steps
            table[key]["n"] += 1

    def _round(table):
        return {k: {"ms": round(v["ms"], 3), "gbytes": round(v["gbytes"], 3),
                    "n": v["n"] // n_steps}
                for k, v in sorted(table.items(), key=lambda kv: -kv[1]["ms"])}

    def floor(us):
        return round(us / per, 3) if rated else None

    return {
        "n_steps": n_steps,
        "measured_ms": round(measured_us / per, 3),
        "flops_roofline_ms": floor(flops_us),
        "bytes_roofline_ms": floor(bytes_us),
        "per_op_roofline_ms": floor(bound_us) if rated else None,
        "opaque_ms": round(opaque_us / per, 3),
        "busy_ms": round(busy_us / per, 3),
        "window_ms": round(window_us / per, 3),
        "idle_share": round(1.0 - busy_us / window_us, 4) if window_us else None,
        "total_gbytes_per_step": round(
            sum(o["bytes"] for o in ops) / 1e9 / n_steps, 3),
        "total_gflops_per_step": round(
            sum(o["flops"] for o in ops) / 1e9 / n_steps, 3),
        "by_category": _round(by_cat),
        "by_component": _round(by_comp),
    }


def step_split(trace: TraceLike, step: str = "train_step",
               ops: Optional[List[Dict]] = None) -> List[Dict]:
    """Per ``step`` range of the trace: ``enqueue_ms`` (the range on the
    host), ``window_ms`` (from its start to the next step's start; the
    last to the end of the last kernel), ``busy_ms`` (the kernels' union
    inside the window) and ``idle_share``."""
    tr = _trace(trace)
    ops = tr.ops() if ops is None else ops
    busy = busy_intervals(ops)
    ranges = tr.ranges(step)
    if not ranges:
        raise ValueError(f"no {step!r} range in the trace")
    end = max([b for _, b in busy] + [r["ts"] + r["dur"] for r in ranges])
    out = []
    for k, r in enumerate(ranges):
        lo = r["ts"]
        hi = ranges[k + 1]["ts"] if k + 1 < len(ranges) else end
        b = clipped_us(busy, lo, hi)
        out.append({"enqueue_ms": r["dur"] / 1e3, "window_ms": (hi - lo) / 1e3,
                    "busy_ms": b / 1e3,
                    "idle_share": 1.0 - b / (hi - lo) if hi > lo else 0.0})
    return out


def host_ranges(trace: TraceLike, step: str = "train_step") -> Dict[str, float]:
    """Where the host's time in the ``step`` ranges goes: ms a step in
    each range directly inside them (``device_preprocess``,
    ``image_encoder``, ...), and in none of them (``other``)."""
    tr = _trace(trace)
    ranges = {id(r) for r in tr.ranges(step)}
    n = len(ranges)
    if not n:
        raise ValueError(f"no {step!r} range in the trace")
    out: Dict[str, float] = defaultdict(float)
    total = 0.0
    for i, e in enumerate(tr.host):
        if id(e) in ranges:
            total += e["dur"]
            continue
        p = tr._parent[i]
        if e["cat"] == "user_annotation" and p is not None \
                and id(tr.host[p]) in ranges:
            out[e["name"]] += e["dur"] / 1e3 / n
    out["other"] = total / 1e3 / n - sum(out.values())
    return dict(out)


def idle_gaps(trace: TraceLike, top: int = 5, step: str = "train_step",
              ops: Optional[List[Dict]] = None) -> List[Dict]:
    """The ``top`` longest gaps between the kernels' busy intervals inside
    the ``step`` ranges' windows, each with the host spans on the step's
    thread that overlap it most (``host``: [(name, overlap ms)], the
    innermost spans)."""
    tr = _trace(trace)
    ops = tr.ops() if ops is None else ops
    busy = busy_intervals(ops)
    ranges = tr.ranges(step)
    if not ranges or not busy:
        return []
    lo, hi = ranges[0]["ts"], max(b for _, b in busy)
    tid = ranges[0]["tid"]
    gaps = [(a, b) for (_, a), (b, _) in zip(busy, busy[1:])
            if a >= lo and b <= hi]
    gaps.sort(key=lambda g: g[0] - g[1])
    spans = [(i, e) for i, e in enumerate(tr.host) if e["tid"] == tid]
    has_child = {tr._parent[i] for i, _ in spans}
    leaves = [e for i, e in spans if i not in has_child]
    starts = sorted(range(len(leaves)), key=lambda k: leaves[k]["ts"])
    keys = [leaves[k]["ts"] for k in starts]
    out = []
    for a, b in gaps[:top]:
        seen = defaultdict(float)
        first = max(0, bisect.bisect_left(keys, a) - 1)
        for k in starts[first:bisect.bisect_right(keys, b)]:
            e = leaves[k]
            o = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
            if o > 0:
                seen[e["name"]] += o
        host = sorted(seen.items(), key=lambda kv: -kv[1])[:3]
        out.append({"start_ms": (a - lo) / 1e3, "gap_ms": (b - a) / 1e3,
                    "host": [(n, round(v / 1e3, 4)) for n, v in host]})
    return out


def sync_ms(trace: TraceLike, step: str = "train_step") -> Dict[str, float]:
    """The host's time in the runtime calls that can block it: the
    synchronisations (``cuda*Synchronize``) and the copies (``cudaMemcpy*``:
    a copy from or to pageable memory returns when it is done), in ms by
    call name, on the thread of the ``step`` ranges (every thread where
    the trace has none)."""
    tr = _trace(trace)
    ranges = tr.ranges(step)
    out = defaultdict(float)
    for e in tr.host:
        if e["cat"] == "cuda_runtime" and (
                "Synchronize" in e["name"] or e["name"].startswith("cudaMemcpy")
        ) and (not ranges or e["tid"] == ranges[0]["tid"]):
            out[e["name"]] += e["dur"] / 1e3
    return dict(out)


def kernel_counts(ops: List[Dict]) -> Dict[str, int]:
    """Events of each of the port's kernels (:data:`KERNEL_RANGES`) among
    the device ops, by their range's name."""
    return {name: sum(1 for o in ops if o["category"] == "kernel"
                      and re.search(rx, o["name"]))
            for name, rx in KERNEL_RANGES.items()}


def trace_step_roofline(step_fn: Callable[[], None], n_steps: int,
                        outdir: str, device="cuda",
                        warmup_fn: Optional[Callable[[], None]] = None) -> Dict:
    """Trace ``step_fn`` (which runs ``n_steps`` steps; ``warmup_fn`` in
    the profiler's warm-up before it) and return its roofline summary,
    with the window from the first ``train_step`` range to the last
    kernel where the trace has those ranges; raises when the trace holds
    no ops."""
    device = torch.device(device)
    rates = device_specs(device) if device.type == "cuda" else (None, None)
    tr = Trace(capture_trace(step_fn, outdir, device, warmup_fn))
    ops = tr.ops()
    if not ops:
        raise RuntimeError(f"the trace under {outdir} holds no ops")
    window = None
    if tr.ranges("train_step"):
        window = sum(s["window_ms"] for s in step_split(tr, ops=ops)) * 1e3
    return roofline_summary(ops, n_steps, *rates, window_us=window)


__all__ = ["DEVICE_SPECS", "KERNEL_RANGES", "Trace", "busy_intervals",
           "capture_trace", "clipped_us", "component_of", "device_specs",
           "host_ranges", "idle_gaps", "kernel_counts", "overlap_us", "parse_trace_ops",
           "read_trace", "record_trace", "roofline_summary", "scope", "start_trace",
           "step_split", "stop_trace", "sync_ms", "trace_step_roofline", "traced", "union_us"]
