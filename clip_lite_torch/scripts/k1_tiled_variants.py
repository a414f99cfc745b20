"""K1's key-tiled float32 kernel against the forms it was chosen over, on the card.

Builds ``ops/csrc/attention_fwd.cu`` as it is and in six other forms of
its key-tiled 3xTF32 kernel (``attention_fwd_tf32x3_tiled``), each an edit
of the source's text that this script asserts it finds, all nvcc runs
started together into ``build/k1_tiled_variants/``:

- ``one_score_chain``: the scores in one accumulator, 24 products a chain,
  in place of two of 12 (the even and the odd 8-dim chunks);
- ``chunk_fresh``: each 8-key chunk's three products of P V in a fresh
  accumulator added to the context, in place of one a tile;
- ``chained``: P V chained into the context over all of S (3 S / 8
  products), the form whose distance from float64 grows with S;
- ``branchy``: the last tile's chunk tests in every tile;
- ``keys64``: tiles of 64 keys in place of 32;
- ``min_blocks3``: registers bounded for three blocks an SM (168);

and three cuts, whose output is wrong by design, to see where the time
goes: ``no_exp`` (the exponentials), ``no_qk`` (the products of the
scores) and ``no_pv`` (those of the context).

Each build's kernel runs at the vision towers' shapes, a zero key bias:
ViT-B/16's qkv (128, 197, 2304), 12 heads; ViT-L/14's (128, 257, 3072)
and ViT-L/14-336's (128, 577, 3072), 16 heads.  Per form it prints ptxas'
registers and spills, the card's time alone (``chip_smoke.device_ms``,
inputs from ``chip_smoke.l2_spilling_copies``), the largest difference
from the plain version and the distance from float64 as a multiple of
the plain version's (``chip_smoke.float64_forward``); beside them
``scaled_dot_product_attention``'s time.  Prints the card's name and power
limit first, then one JSON line a shape.  Run from the root of a
checkout:

    python -m clip_lite_torch.scripts.k1_tiled_variants
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "clip_lite_torch" / "ops" / "csrc"
OUT = ROOT / "build" / "k1_tiled_variants"
MARK = "// ---- key-tiled 3xTF32 route"

ONE_SCORE_CHAIN = [
    ("tf32x3_product(kc & 1 ? s_odd[n] : s[n], ab, as, bb, bs);",
     "tf32x3_product(s[n], ab, as, bb, bs);")]
CHUNK_FRESH = [
    ("        tf32x3_product(ot[np], ab, as, bb, bs);\n",
     "        float c[4] = {};\n        tf32x3_product(c, ab, as, bb, bs);\n"
     "#pragma unroll\n        for (int e = 0; e < 4; ++e) o[np][e] += c[e];\n")]
CHAINED = [
    ("        tf32x3_product(ot[np], ab, as, bb, bs);\n",
     "        tf32x3_product(o[np], ab, as, bb, bs);\n")]
BRANCHY = [("if (!kTail || n < chunks)", "if (n < chunks)"),
           ("if (!kTail || kc < chunks)", "if (kc < chunks)"),
           ("const int chunks = kTail ? min(kTiledNT, (S - key0 + 7) / 8) : kTiledNT;",
            "const int chunks = min(kTiledNT, (S - key0 + 7) / 8);")]
KEYS64 = [("constexpr int kTiledKeys = 32;", "constexpr int kTiledKeys = 64;")]
MIN_BLOCKS3 = [("__launch_bounds__(kTiledThreads)\nattention_fwd_tf32x3_tiled_kernel",
                "__launch_bounds__(kTiledThreads, 3)\nattention_fwd_tf32x3_tiled_kernel")]
NO_EXP = [("const float p = __expf(s[n][e] - mx[e >> 1]);",
           "const float p = s[n][e] - mx[e >> 1];")]
NO_QK = [("tf32x3_product(kc & 1 ? s_odd[n] : s[n], ab, as, bb, bs);", "")]
NO_PV = [("        tf32x3_product(ot[np], ab, as, bb, bs);\n", "")]
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "base": [], "one_score_chain": ONE_SCORE_CHAIN, "chunk_fresh": CHUNK_FRESH,
    "chained": CHAINED, "branchy": BRANCHY, "keys64": KEYS64,
    "min_blocks3": MIN_BLOCKS3, "no_exp": NO_EXP, "no_qk": NO_QK, "no_pv": NO_PV}
SHAPES = (("vit_b16", 197, 768, 12), ("vit_l14", 257, 1024, 16),
          ("vit_l14_336", 577, 1024, 16))


def source(edits: List[Tuple[str, str]]) -> str:
    """attention_fwd.cu with each (old, new) edit made in its key-tiled
    route; every old text must occur there."""
    head, tail = (CSRC / "attention_fwd.cu").read_text().split(MARK)
    for old, new in edits:
        if old not in tail:
            raise AssertionError(f"not in the key-tiled route: {old!r}")
        tail = tail.replace(old, new)
    return head + MARK + tail


def build() -> Tuple[Dict[str, ctypes.CDLL], Dict[str, str]]:
    """Each form's library and ptxas' lines on its key-tiled kernels."""
    from clip_lite_torch.ops import _build

    procs = {}
    for name, edits in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for header in CSRC.glob("*.cuh"):
            shutil.copy(header, d)
        (d / "attention_fwd.cu").write_text(source(edits))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "attention_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        lines = log.splitlines()
        ptxas[name] = "; ".join(
            re.sub(r"\s+", " ", lines[i + k]).strip()
            for i, line in enumerate(lines) if "tiled_kernel" in line
            for k in (1, 2) if i + k < len(lines)
            and ("registers" in lines[i + k] or "spill" in lines[i + k]))
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        lib.attention_fwd_tf32x3_tiled.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
            + [ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint64,
               ctypes.c_void_p])
        libs[name] = lib
    return libs, ptxas


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("k1_tiled_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from clip_lite_torch.ops.attention import attention_reference

    chip_smoke.phase_environment()  # the card's name and power limit
    libs, ptxas = build()
    print(json.dumps({"ptxas": ptxas}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(19)
    for key, s, width, nh in SHAPES:
        b = 128
        qkv = torch.randn(b, s, 3 * width, device="cuda", generator=g)
        bias = torch.zeros(b, s, device="cuda")
        ref = attention_reference(qkv, bias, nh)
        exact = chip_smoke.float64_forward(qkv, bias, nh)
        plain_f64 = (ref.double() - exact).abs().max().item()
        copies = chip_smoke.l2_spilling_copies(qkv, bias)

        def library(x, m):
            q, k, v = x.view(b, s, 3, nh, 64).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(q, k, v)

        row = dict(shape=[b, s, 3 * width], heads=nh,
                   sdpa_ms_device=chip_smoke.device_ms(library, copies))
        for name, lib in libs.items():

            def run(x, m, lib=lib, name=name):
                out = torch.empty(b, s, width, device="cuda")
                err = lib.attention_fwd_tf32x3_tiled(
                    x.data_ptr(), m.data_ptr(), None, out.data_ptr(), b, s, nh,
                    64, 0, 0, 0, 0, 1.0, 0, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
                return out
            out = run(qkv, bias)
            row[name] = dict(
                ms_device=chip_smoke.device_ms(run, copies),
                max_abs_err=(out - ref).abs().max().item(),
                float64_vs_plain=(out.double() - exact).abs().max().item() / plain_f64)
            del out
        print(json.dumps({key: row}), flush=True)
        del qkv, ref, exact, copies
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
