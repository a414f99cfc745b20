"""Where K1's float32 kernel (the 3xTF32 route) spends its time, on the card.

Builds ``ops/csrc/attention_fwd.cu`` once as it is and once with each of
its ablation cuts (``-DK1_TF32X3_CUT=<n>``, the ``Tf32Cut`` values the
source names), all nvcc runs started together into ``build/k1_ablation/``,
and times every build's ``attention_fwd_tf32x3`` on the card alone
(``chip_smoke.device_ms``, inputs from ``chip_smoke.l2_spilling_copies``)
at CLIP's two shapes: the vision tower's qkv (128, 50, 2304), 12 heads, a
zero key bias, and the text tower's (128, 77, 1536), 8 heads, the causal
and padding mask as the full bias.  The cuts:

- ``one_product``: TF32 alone, two of each tile's three products gone;
- ``no_kv_copies``: k and v never copied into shared memory;
- ``no_stores``: the context never written (the compiler then drops the
  context's products too, whose only use the stores are);
- ``exact_softmax``: ``expf`` and a division per element in place of
  ``__expf`` and one reciprocal a row.

A cut build computes a wrong result by design; only the full build is
held against the plain version.  Beside them, the ceiling of the
instruction the products use: a kernel of nothing but independent
``mma.sync.m16n8k8 .tf32`` products (eight accumulators a warp, eight
warps a block, eight blocks an SM), in TFLOP/s.  Prints the card's name
and power limit, then one JSON line a shape and one for the ceiling.
Run from the root of a checkout:

    python -m clip_lite_torch.scripts.k1_fp32_ablation
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "clip_lite_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "k1_ablation"
# Each build by its K1_TF32X3_CUT value (attention_fwd.cu's Tf32Cut).
CUTS = {"base": 0, "one_product": 1, "no_kv_copies": 2, "no_stores": 3,
        "exact_softmax": 4}
CEILING_SOURCE = r"""
#include <cuda_runtime.h>
#include "mma.cuh"

__global__ void __launch_bounds__(256) mma_ceiling(float* out, int iters) {
  uint32_t a[4], b0, b1;
  for (int i = 0; i < 4; ++i) mma::cvt_tf32(a[i], 1.0f + threadIdx.x * 1e-3f + i);
  mma::cvt_tf32(b0, 0.5f);
  mma::cvt_tf32(b1, 0.25f);
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) mma::mma_tf32(c[k], a, b0, b1);
  }
  float sum = 0.f;
  for (int k = 0; k < 8; ++k) sum += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int launch_mma_ceiling(float* out, int blocks, int iters, void* stream) {
  mma_ceiling<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def build() -> Dict[str, ctypes.CDLL]:
    """Every cut's library by name, and the ceiling's under "ceiling"."""
    from clip_lite_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "ceiling.cu").write_text(CEILING_SOURCE)
    nvcc = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC)]
    jobs = {name: [f"-DK1_TF32X3_CUT={cut}", str(CSRC / "attention_fwd.cu")]
            for name, cut in CUTS.items()}
    jobs["ceiling"] = [str(OUT / "ceiling.cu")]
    procs = {name: subprocess.Popen(
        [*nvcc, "-o", str(OUT / f"{name}.so"), *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, args in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
        if name == "ceiling":
            libs[name].launch_mma_ceiling.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        else:
            libs[name].attention_fwd_tf32x3.argtypes = (
                [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                + [ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
                   ctypes.c_uint64, ctypes.c_void_p])
    return libs


def mma_ceiling_tflops(lib) -> float:
    """TFLOP/s of independent mma.sync m16n8k8 TF32 products across the
    card: 8 blocks an SM of 8 warps, each warp 8 accumulators."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    lib.launch_mma_ceiling(out.data_ptr(), blocks, 64, stream)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if lib.launch_mma_ceiling(out.data_ptr(), blocks, iters, stream):
        raise RuntimeError("the ceiling kernel did not launch")
    end.record()
    end.synchronize()
    flops = 2.0 * 16 * 8 * 8 * 8 * iters * blocks * 8  # 8 mma a warp, 8 warps
    return flops / (start.elapsed_time(end) * 1e-3) / 1e12


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_fp32_ablation: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from clip_lite_torch.models.clip import text_bias
    from clip_lite_torch.ops.attention import attention_reference

    chip_smoke.phase_environment()  # the card's name and power limit
    libs = build()
    g = torch.Generator(device="cuda").manual_seed(14)
    for shape, b, s, nh in (("vision", 128, 50, 12), ("text", 128, 77, 8)):
        qkv = torch.randn(b, s, 3 * nh * 64, device="cuda", generator=g)
        if shape == "text":
            lengths = torch.randint(2, s + 1, (b,), device="cuda", generator=g)
            mask = torch.arange(s, device="cuda")[None] < lengths[:, None]
            bias = text_bias(mask.long(), nh)
        else:
            bias = torch.zeros(b, s, device="cuda")
        copies = chip_smoke.l2_spilling_copies(qkv, bias)
        row = dict(shape=[b, s, 3 * nh * 64], heads=nh,
                   bias="full" if bias.ndim == 4 else "key")
        for name in CUTS:

            def run(x, m, lib=libs[name]):
                out = torch.empty(b, s, nh * 64, device="cuda")
                err = lib.attention_fwd_tf32x3(
                    x.data_ptr(), m.data_ptr(), None, out.data_ptr(), b, s, nh,
                    64, 0, int(m.ndim == 4), 0, 0, 1.0, 0,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
                return out
            if name == "base":
                row["max_abs_err"] = (run(qkv, bias) - attention_reference(
                    qkv, bias, nh)).abs().max().item()
            row[f"{name}_ms_device"] = chip_smoke.device_ms(run, copies)
        print(json.dumps(row), flush=True)
        del copies
    print(json.dumps({"mma_sync_tf32_tflops": mma_ceiling_tflops(
        libs["ceiling"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
