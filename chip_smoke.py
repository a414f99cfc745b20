#!/usr/bin/env python3
"""Drive the PyTorch port (clip_lite_torch) on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases; any failure raises and exits non-zero, and no phase's error is
caught:

1. Environment: the card's name and power limit, torch and CUDA versions;
   TF32 and reduced-precision bf16 reductions off, so fp32 references are
   fp32.
2. Build: every kernel of the slice from clip_lite_torch/ops/csrc, one
   nvcc per source, all started together.
3. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, in fp32 and bf16; the kernel's, the
   plain version's and the library call's times; the least time the card
   could take (bytes over 3.35 TB/s or operations over the peak rate).
4. Main path: the flagship model (configs/fs_bs1024_ni250k.yaml:
   ResNet-50 at 224 px, BERT-12/768 over 30 tokens, 2048-d projection
   heads, AMP bf16) with seeded random weights, as an EncoderBundle on the
   card, scores retrieval on 256 seeded images and captions at batch 128.
   Launch counts are set to 0 just before and read just after.  Checks:
   finite unit-norm (256, 2048) embeddings, K1 launched 12 layers x 2
   text batches, and the text embeddings against the same model with
   FUSED_ATTENTION false (the plain attention) in bf16 and in fp32.
   Then images/s and captions/s through the bundle.
5. One JSON line listing every ported kernel; then the device line last.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs" / "fs_bs1024_ni250k.yaml"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per second
TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
# Text embeddings, fused K1 against the plain attention, same weights:
# bf16 may flip a rounding where the fp32 sums' order differs, and that
# carries through 12 layers; fp32 differs only in the sums' order.
TEXT_TOL = {"bfloat16": dict(max_abs=1e-2, min_cos=0.999),
            "float32": dict(max_abs=1e-4, min_cos=0.99999)}
N_ITEMS, BATCH = 256, 128
WORDS = ("a an the man woman child dog cat horse bus train car plate pizza "
         "table street city field beach kitchen red blue white black small "
         "large young old two three sitting standing riding eating holding "
         "walking parked next to on in with near under of at while").split()


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, args_list, iters=40, warmup=5) -> float:
    """Mean ms per call over ``iters`` calls, cycling through
    ``args_list`` (copies whose total exceeds the 50 MB L2, so every call
    reads its inputs from device memory)."""
    for i in range(warmup):
        fn(*args_list[i % len(args_list)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_environment() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def phase_build() -> None:
    from clip_lite_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(["attention_fwd"])
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(logs) or 'none (cached)'}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")


def phase_attention() -> dict:
    """K1 at the flagship text batch: (128, 30, 2304), 12 heads of 64."""
    from clip_lite_torch.ops.attention import (
        MASK_VALUE, attention_reference, fused_short_attention)

    b, s, nh, hd = BATCH, 30, 12, 64
    h = nh * hd
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv32 = torch.randn(b, s, 3 * h, device="cuda", generator=g)
    # Caption-like lengths: keys 25..29 are padding on every row, more on most.
    lengths = torch.randint(1, 26, (b,), device="cuda", generator=g)
    keep = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
    bias = (1.0 - keep.float()) * MASK_VALUE
    mask4 = keep[:, None, None, :]

    def library(qkv):
        q, k, v = qkv.view(b, s, 3, nh, hd).permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask4)

    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        qkv = qkv32.to(dtype)
        out = fused_short_attention(qkv, bias, nh)
        ref = attention_reference(qkv, bias, nh)
        lib = library(qkv).transpose(1, 2).reshape(b, s, h)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lib_err = (lib.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
        copies = [(qkv.clone(),) for _ in range(4)]
        ms = time_ms(lambda x: fused_short_attention(x, bias, nh), copies)
        plain_ms = time_ms(lambda x: attention_reference(x, bias, nh), copies)
        library_ms = time_ms(library, copies)
        item = qkv.element_size()
        n_bytes = qkv.numel() * item + bias.numel() * 4 + b * s * h * item
        n_ops = 4 * b * nh * s * s * hd  # two products, 2 operations a MAC
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype]
        name = str(dtype).replace("torch.", "")
        result[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=1e3 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        log(f"K1 {name}: max|kernel-plain| {err} (tol {TOLS[dtype]}), "
            f"max|library-plain| {lib_err}; kernel {ms} ms, plain "
            f"{plain_ms} ms, library {library_ms} ms, bound "
            f"{result[name]['bound_ms']} ms ({result[name]['bound_by']}: "
            f"{n_bytes} bytes, {n_ops} operations)")
    return result


def captions(rng: np.random.Generator, n: int) -> list:
    lengths = rng.integers(3, 36, n)  # some exceed the 30 tokens and truncate
    return [" ".join(rng.choice(WORDS, k)) for k in lengths]


def text_agreement(a: np.ndarray, b: np.ndarray) -> dict:
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    return dict(max_abs=float(np.abs(a - b).max()), min_cos=float(cos.min()))


def check_embeddings(name: str, emb: np.ndarray) -> None:
    if emb.shape != (N_ITEMS, 2048) or not np.isfinite(emb).all():
        raise AssertionError(f"{name}: shape {emb.shape}, finite "
                             f"{np.isfinite(emb).all()}")
    norm_err = float(np.abs(np.linalg.norm(emb, axis=1) - 1.0).max())
    if norm_err > 1e-4:
        raise AssertionError(f"{name}: norms off 1 by {norm_err}")


def phase_main_path() -> dict:
    from clip_lite_torch.config import Config
    from clip_lite_torch.data.tokenizers import HashingTokenizer
    from clip_lite_torch.eval_utils import EncoderBundle
    from clip_lite_torch.ops.attention import fused_short_attention
    from clip_lite_torch.retrieval import score_retrieval

    cfg = Config(str(FLAGSHIP))
    bundle = EncoderBundle(cfg, batch_size=BATCH, device="cuda")
    n_layers = cfg.MODEL.TEXTUAL.NUM_HIDDEN_LAYERS
    log(f"model: {cfg.MODEL.VISUAL.NETWORK_NAME} + BERT-{n_layers}/"
        f"{cfg.MODEL.TEXTUAL.HIDDEN_SIZE}, AMP {cfg.AMP} {cfg.DTYPE}, "
        f"{sum(p.numel() for p in bundle.model.parameters())} parameters")
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_ITEMS, 224, 224, 3), dtype=np.float32)
    texts = captions(rng, N_ITEMS)
    tok = HashingTokenizer(cfg.MODEL.TEXTUAL.VOCAB_SIZE,
                           cfg.DATA.MAX_CAPTION_LENGTH)
    txt2img = {i: i for i in range(N_ITEMS)}
    img2txt = {i: [i] for i in range(N_ITEMS)}
    # Warm-up (cuDNN algorithm choice, allocator), outside the counted run.
    bundle.encode_images(images[:BATCH])
    bundle.encode_texts(texts[:BATCH], tok)
    torch.cuda.synchronize()

    fused_short_attention.launches = 0
    t0 = time.perf_counter()
    recalls, img_emb, txt_emb = score_retrieval(bundle, images, texts, tok,
                                                txt2img, img2txt)
    wall = time.perf_counter() - t0
    launches = {"attention_fwd": fused_short_attention.launches}
    log(f"main path: score_retrieval of {N_ITEMS} images + {N_ITEMS} captions "
        f"in {wall} s; launches {launches}; recalls "
        f"{json.dumps({k: float(v) for k, v in recalls.items()})}")
    check_embeddings("image embeddings", img_emb)
    check_embeddings("text embeddings", txt_emb)
    expected = n_layers * math.ceil(N_ITEMS / BATCH)
    if launches["attention_fwd"] != expected:
        raise AssertionError(f"K1 launched {launches['attention_fwd']} times, "
                             f"expected {expected}")
    if not all(0.0 <= float(v) <= 100.0 for v in recalls.values()):
        raise AssertionError(f"recalls out of range: {recalls}")

    # The text path once more through the plain attention on the card, with
    # the same weights: bf16 as on the main path, then both in fp32.
    state = bundle.model.state_dict()
    plain = EncoderBundle(Config(str(FLAGSHIP), ["MODEL.TEXTUAL.FUSED_ATTENTION",
                                                 "false"]),
                          state_dict=state, device="cuda")
    agree = {"bfloat16": text_agreement(txt_emb, plain.encode_texts(texts, tok))}
    del plain
    fp32 = [EncoderBundle(Config(str(FLAGSHIP), ["AMP", False,
                                                 "MODEL.TEXTUAL.FUSED_ATTENTION",
                                                 flag]),
                          state_dict=state, device="cuda").encode_texts(texts, tok)
            for flag in ("true", "false")]
    agree["float32"] = text_agreement(*fp32)
    for dt, got in agree.items():
        tol = TEXT_TOL[dt]
        log(f"text embeddings, K1 vs plain attention, {dt}: {got} (tol {tol})")
        if got["max_abs"] > tol["max_abs"] or got["min_cos"] < tol["min_cos"]:
            raise AssertionError(f"{dt} text embeddings disagree: {got}")

    img_s, txt_s = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        bundle.encode_images(images)
        img_s.append(N_ITEMS / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        bundle.encode_texts(texts, tok)
        txt_s.append(N_ITEMS / (time.perf_counter() - t0))
    log(f"throughput at batch {BATCH} (numpy in, numpy out): images/s "
        f"{img_s} (median {statistics.median(img_s)}), captions/s {txt_s} "
        f"(median {statistics.median(txt_s)})")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run",
              file=sys.stderr)
        return 1
    import clip_lite_torch

    if Path(clip_lite_torch.__file__).resolve().parents[1] != ROOT:
        raise RuntimeError("run chip_smoke.py from the root of a checkout")
    phase_environment()
    phase_build()
    k1 = phase_attention()
    launches = phase_main_path()
    kernels = [dict(name="attention_fwd (K1)", route="cuda",
                    source="clip_lite_torch/ops/csrc/attention_fwd.cu",
                    replaces="clip_lite_tpu/ops/attention.py:95",
                    launches=launches["attention_fwd"], **k1["bfloat16"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
