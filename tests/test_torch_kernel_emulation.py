"""K1's and K2's CUDA sources, every route, run on the CPU against their
plain twins.

Only the card runs the kernels for real (tests/test_torch_cuda.py,
chip_smoke.py).  This file checks their index math on the CPU: g++
compiles ``clip_lite_torch/ops/csrc/attention_{fwd,bwd}.cu`` against the
emulated CUDA of ``tests/cuda_emulation.py`` (one thread per CUDA thread,
barriers for ``__syncthreads`` and ``__syncwarp``, warp collectives for
``__shfl_xor_sync``), with three textual substitutions:

- the bodies of ``mma.cuh``'s inline-PTX helpers become emulated
  collectives that follow the PTX ISA's fragment layouts (``ldmatrix``,
  ``mma.sync`` m16n8k16 bf16 and m16n8k8 TF32) and an exact ``cvt.rna``
  to TF32;
- each ``extern __shared__`` array becomes a pointer to the emulated
  block's memory;
- each ``kernel<<<grid, block, smem, stream>>>(args)`` becomes
  ``emu_launch(kernel, grid, block, smem, stream, args)``.

The C entry points then run on CPU tensors' pointers.  This says nothing
of the PTX's syntax, the card's memory model or speed.  It skips where
g++ with C++20's ``<barrier>`` is missing.
"""

import ctypes
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from cuda_emulation import (
    CSRC,
    emulate_cp_async,
    emulation_dir,
    gxx,
    replace_body,
    rewrite_launches,
)

from clip_lite_torch.ops.attention import (
    MASK_VALUE,
    attention_backward_reference,
    attention_float64,
    attention_reference,
    dropout_threshold,
    philox_keep_mask,
)

# As on the card (tests/test_torch_cuda.py): bf16 may flip one rounding
# where the fp32 sums' order differs; dbias is fp32 on both sides.
TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The inline-PTX helpers of mma.cuh, emulated (its cp.async ones by
# cuda_emulation.emulate_cp_async).  ldmatrix: lanes 8m..8m+7
# give the rows of matrix m; lane (g, t) = (lane / 4, lane % 4) receives
# row g, columns 2t, 2t+1 (transposed: rows 2t, 2t+1, column g).  mma: A
# register r of lane (g, t) holds A[g + 8 (r % 2)][2t + 8 (r / 2) + {0, 1}],
# B register r holds B[2t + 8r + {0, 1}][g], C element e holds
# C[g + 8 (e / 2)][2t + e % 2].  TF32 mma: A register r of lane (g, t)
# holds A[g + 8 (r % 2)][t + 4 (r / 2)], B register r holds B[t + 4r][g],
# C as above; each product of two TF32 values is exact in fp32, and the sum
# is fp32's, in k order (an operand's low 13 bits are not read).  cvt.rna.tf32.f32: to nearest, ties away from zero
# (the magnitude's bits plus half of the 13 dropped ones), low 13 bits 0;
# NaN kept.
PTX_BODIES = {
    "ldmatrix_x4": r"""{
  Warp& w = my_warp();
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  w.ptr[lane] = p;
  w.bar->arrive_and_wait();
  for (int m = 0; m < 4; ++m) {
    const uint16_t* row = (const uint16_t*)w.ptr[8 * m + g];
    r[m] = (uint32_t)row[2 * t] | ((uint32_t)row[2 * t + 1] << 16);
  }
  w.bar->arrive_and_wait();
}""",
    "ldmatrix_x4_trans": r"""{
  Warp& w = my_warp();
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  w.ptr[lane] = p;
  w.bar->arrive_and_wait();
  for (int m = 0; m < 4; ++m) {
    const uint16_t* r0 = (const uint16_t*)w.ptr[8 * m + 2 * t];
    const uint16_t* r1 = (const uint16_t*)w.ptr[8 * m + 2 * t + 1];
    r[m] = (uint32_t)r0[g] | ((uint32_t)r1[g] << 16);
  }
  w.bar->arrive_and_wait();
}""",
    "mma_bf16": r"""{
  Warp& w = my_warp();
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  w.bar->arrive_and_wait();
  auto half = [](uint32_t v, int k) {
    return __bfloat162float(__nv_bfloat16{(uint16_t)((k & 1) ? v >> 16 : v & 0xffffu)});
  };
  auto A = [&](int row, int k) {
    return half(w.a[(row % 8) * 4 + (k % 8) / 2][(k >= 8) * 2 + (row >= 8)], k);
  };
  auto B = [&](int k, int col) { return half(w.b[col * 4 + (k % 8) / 2][k >= 8], k); };
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = c[e];
    for (int k = 0; k < 16; ++k) acc += A(row, k) * B(k, col);
    c[e] = acc;
  }
  w.bar->arrive_and_wait();
}""",
    "cvt_tf32": r"""{
  const uint32_t u = __float_as_uint(x);
  r = (u & 0x7fffffffu) > 0x7f800000u ? u : (u + 0x1000u) & 0xffffe000u;
}""",
    "mma_tf32": r"""{
  Warp& w = my_warp();
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  w.b[lane][0] = b0;
  w.b[lane][1] = b1;
  w.bar->arrive_and_wait();
  auto tf32 = [](uint32_t v) { return __uint_as_float(v & 0xffffe000u); };
  auto A = [&](int row, int k) {
    return tf32(w.a[(row % 8) * 4 + k % 4][(k >= 4) * 2 + (row >= 8)]);
  };
  auto B = [&](int k, int col) { return tf32(w.b[col * 4 + k % 4][k >= 4]); };
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = c[e];
    for (int k = 0; k < 8; ++k) acc += A(row, k) * B(k, col);
    c[e] = acc;
  }
  w.bar->arrive_and_wait();
}""",
}


def _emulated_sources(out: Path) -> None:
    mma = emulate_cp_async((CSRC / "mma.cuh").read_text())
    for name, body in PTX_BODIES.items():
        mma = replace_body(mma, name, body)
    (out / "mma.cuh").write_text(mma)
    shutil.copy(CSRC / "attention_common.cuh", out)
    smem = {"extern __shared__ __align__(16) unsigned char smem_raw[];":
            "unsigned char* smem_raw = emu_block_smem();",
            "extern __shared__ float smem[];":
            "float* smem = (float*)emu_block_smem();"}
    for name in ("attention_fwd", "attention_bwd"):
        src = (CSRC / f"{name}.cu").read_text()
        for old, new in smem.items():
            src = src.replace(old, new)
        (out / f"{name}.cu").write_text(rewrite_launches(src, f"{name}.cu"))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = emulation_dir(tmp_path_factory)
    _emulated_sources(out)
    loaded = {}
    for name in ("attention_fwd", "attention_bwd"):
        r = gxx(out, out / f"{name}.cu", out / f"lib{name}.so")
        assert r.returncode == 0, r.stderr[-4000:]
        loaded[name] = ctypes.CDLL(str(out / f"lib{name}.so"))
    drop = [ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_uint64,
            ctypes.c_void_p]
    fwd, bwd = loaded["attention_fwd"], loaded["attention_bwd"]
    for fn in (fwd.attention_fwd, fwd.attention_fwd_tc, fwd.attention_fwd_tf32x3,
               fwd.attention_fwd_tf32x3_tiled, fwd.attention_fwd_tc_tiled):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + drop
    for fn in (bwd.attention_bwd, bwd.attention_bwd_tc):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + drop
    bwd.attention_bwd_tiled.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                                        + drop)
    return fwd, bwd


def _case(b, s, nh, full, dtype, seed=0):
    g = torch.Generator().manual_seed(1000 * s + nh + seed)
    qkv = torch.randn(b, s, 3 * nh * 64, generator=g).to(dtype)
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    key_bias = (1.0 - (torch.arange(s)[None] < lengths[:, None]).float()) * MASK_VALUE
    bias = key_bias
    if full:
        bias = (torch.randn(1, nh, s, s, generator=g) * 0.5
                + key_bias[:, None, None, :]).contiguous()
    grad = torch.randn(b, s, nh * 64, generator=g).to(dtype)
    return qkv, bias, grad


def _run(libs, route, qkv, bias, grad, nh, rate, seed=31):
    """Both kernels of ``route`` on CPU pointers: (out, dqkv, dbias)."""
    fwd, bwd = libs
    b, s, _ = qkv.shape
    full = bias.ndim == 4
    drop = ((1, dropout_threshold(rate), float(torch.tensor(1.0 / (1.0 - rate))), seed)
            if rate else (0, 0, 1.0, 0))
    code = DTYPE_CODES[qkv.dtype]
    out = torch.empty(b, s, nh * 64, dtype=qkv.dtype)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias) if full else None
    tc = route == "tensor_core"
    err = (fwd.attention_fwd_tc if tc else fwd.attention_fwd)(
        qkv.data_ptr(), bias.data_ptr(), None, out.data_ptr(), b, s, nh, 64, code,
        int(full), *drop, None)
    assert err == 0
    err = (bwd.attention_bwd_tc if tc else bwd.attention_bwd)(
        qkv.data_ptr(), bias.data_ptr(), grad.data_ptr(), None, dqkv.data_ptr(),
        None if dbias is None else dbias.data_ptr(), b, s, nh, 64, code, int(full),
        *drop, None)
    assert err == 0
    return out, dqkv, dbias


def _check(got, qkv, bias, grad, nh, rate, seed=31):
    out, dqkv, dbias = got
    b, s, _ = qkv.shape
    keep = philox_keep_mask(seed, b, nh, s, rate) if rate else None
    ref = attention_reference(qkv, bias, nh, rate, keep)
    dref, dbias_ref = attention_backward_reference(qkv, bias, grad, nh, rate, keep)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[qkv.dtype])
    torch.testing.assert_close(dqkv.float(), dref.float(), **TOLS[qkv.dtype])
    if bias.ndim == 4:
        torch.testing.assert_close(dbias, dbias_ref, **TOLS[torch.float32])
    return (ref, dref, dbias_ref), keep


# The tiling's edges: one row, one over a tile, between tiles, full tiles;
# the full bias with dropout at each, the key bias without at one.
TC_CASES = [(1, True, 0.1), (17, True, 0.1), (30, True, 0.1), (64, True, 0.1),
            (30, False, 0.0)]


@pytest.mark.parametrize("s,full,rate", TC_CASES,
                         ids=[f"S{s}-{'full' if f else 'key'}-rate{r}"
                              for s, f, r in TC_CASES])
def test_tensor_core_route_matches_reference(libs, s, full, rate):
    """The tensor-core K1 and K2 (bf16) at the edges of their 16-row tiles
    against the twins, and within twice the twins' distance from the
    float64 evaluation of the same function."""
    nh = 2
    qkv, bias, grad = _case(2, s, nh, full, torch.bfloat16)
    got = _run(libs, "tensor_core", qkv, bias, grad, nh, rate)
    twins, keep = _check(got, qkv, bias, grad, nh, rate)
    exact = attention_float64(qkv, bias, grad, nh, rate, keep)
    for k, t, e in zip(got, twins, exact):
        if e is not None:
            assert ((k.double() - e).abs().max()
                    <= 2.0 * (t.double() - e).abs().max())


def test_cuda_core_route_matches_reference(libs):
    """The CUDA-core K1 and K2 (fp32, the exact parity checks' route) under
    a full bias with dropout, S off the warp's multiple."""
    nh = 2
    qkv, bias, grad = _case(2, 17, nh, True, torch.float32)
    _check(_run(libs, "cuda_core", qkv, bias, grad, nh, 0.1), qkv, bias, grad,
           nh, 0.1)


def test_tensor_core_entry_points_refuse_what_they_do_not_take(libs):
    """fp32, S > 64 and misaligned pointers are refused before any launch."""
    fwd, bwd = libs
    qkv, bias, grad = _case(1, 65, 1, False, torch.bfloat16)
    out = torch.empty(1, 65, 64, dtype=torch.bfloat16)
    dqkv = torch.empty_like(qkv)
    for s, code, offset, want in ((65, 1, 0, 1), (64, 0, 0, 1), (30, 1, 2, 716)):
        assert fwd.attention_fwd_tc(qkv.data_ptr() + offset, bias.data_ptr(), None,
                                    out.data_ptr(), 1, s, 1, 64, code, 0, 0, 0,
                                    1.0, 0, None) == want
        assert bwd.attention_bwd_tc(qkv.data_ptr() + offset, bias.data_ptr(),
                                    grad.data_ptr(), None, dqkv.data_ptr(), None, 1,
                                    s, 1, 64, code, 0, 0, 0, 1.0, 0, None) == want


# The 3xTF32 route (float32 K1): one row, one over a tile, CLIP's vision
# (key bias, no dropout) and text (full bias) lengths, and the limit.
TF32_CASES = [(1, True, 0.1), (17, True, 0.1), (50, False, 0.0), (77, True, 0.1),
              (80, True, 0.1)]


@pytest.mark.parametrize("s,full,rate", TF32_CASES,
                         ids=[f"S{s}-{'full' if f else 'key'}-rate{r}"
                              for s, f, r in TF32_CASES])
def test_tf32x3_route_matches_reference(libs, s, full, rate, record_property):
    """The 3xTF32 K1 (float32) against its twin at fp32's bar, given the
    kernels' Philox mask, and within four times the twin's distance from
    the float64 evaluation of the same function, plus 2^-21 of the
    output's size (both distances recorded)."""
    fwd, _ = libs
    nh, b, seed = 2, 2, 31
    qkv, bias, grad = _case(b, s, nh, full, torch.float32)
    out = torch.empty(b, s, nh * 64)
    drop = ((1, dropout_threshold(rate), float(torch.tensor(1.0 / (1.0 - rate))),
             seed) if rate else (0, 0, 1.0, 0))
    assert fwd.attention_fwd_tf32x3(qkv.data_ptr(), bias.data_ptr(), None,
                                    out.data_ptr(), b, s, nh, 64, 0, int(full),
                                    *drop, None) == 0
    keep = philox_keep_mask(seed, b, nh, s, rate) if rate else None
    ref = attention_reference(qkv, bias, nh, rate, keep)
    torch.testing.assert_close(out, ref, **TOLS[torch.float32])
    exact = attention_float64(qkv, bias, grad, nh, rate, keep)[0]
    kernel, twin = ((x.double() - exact).abs().max().item() for x in (out, ref))
    record_property("float64_distance", {"kernel": kernel, "twin": twin})
    # 3xTF32 leaves out small.small and the split's rest, 2^-22 of a
    # product where fp32 rounds at 2^-24: at most 4x the twin's distance,
    # plus one product's split error where the twin is exact (p = 1).
    assert kernel <= 4.0 * twin + 2.0 ** -21 * exact.abs().max().item()


def test_tf32x3_entry_point_refuses_what_it_does_not_take(libs):
    """The 3xTF32 entry point refuses bf16, S > 80 and misaligned pointers
    before any launch."""
    fwd, _ = libs
    qkv, bias, _ = _case(1, 81, 1, False, torch.float32)
    out = torch.empty(1, 81, 64)
    for s, code, offset, want in ((81, 0, 0, 1), (30, 1, 0, 1), (30, 0, 4, 716)):
        assert fwd.attention_fwd_tf32x3(qkv.data_ptr() + offset, bias.data_ptr(),
                                        None, out.data_ptr(), 1, s, 1, 64, code,
                                        0, 0, 0, 1.0, 0, None) == want


# The key-tiled 3xTF32 route (float32 K1 above 80): one over the limit of
# the route above (two key tiles, the second of 17 keys; two query
# blocks, the second with two warps of rows), a tail of 2 keys and of one
# warp of rows, and ViT-L/14's 257 (a last key tile of one key, a last
# query block of one row); each with both biases, with and without
# dropout.
TILED_CASES = [(s, full, rate) for s in (81, 130, 257) for full in (False, True)
               for rate in (0.0, 0.1)]


def _tiled_case(b, s, nh, full):
    """qkv and bias: item 0 all padding (every key of its rows at
    MASK_VALUE), item 1's keys real in every key tile, its last three
    padding; a full bias adds N(0, 0.25) per head."""
    g = torch.Generator().manual_seed(s)
    qkv = torch.randn(b, s, 3 * nh * 64, generator=g)
    key_bias = torch.zeros(b, s)
    key_bias[0] = MASK_VALUE
    key_bias[1:, s - 3:] = MASK_VALUE
    if not full:
        return qkv, key_bias
    return qkv, (torch.randn(b, nh, s, s, generator=g) * 0.5
                 + key_bias[:, None, None, :]).contiguous()


@pytest.mark.parametrize("s,full,rate", TILED_CASES,
                         ids=[f"S{s}-{'full' if f else 'key'}-rate{r}"
                              for s, f, r in TILED_CASES])
def test_tf32x3_tiled_route_matches_reference(libs, s, full, rate,
                                              record_property):
    """The key-tiled 3xTF32 K1 (float32) against its twin at fp32's bar,
    given the kernels' Philox mask, and within four times the twin's
    distance from the float64 evaluation plus 2^-21 of the output's size
    (both distances recorded), batch item 0 all padding (every key at
    MASK_VALUE: a uniform softmax, in the online form too)."""
    fwd, _ = libs
    nh, b, seed = 1, 2, 31
    qkv, bias = _tiled_case(b, s, nh, full)
    out = torch.empty(b, s, nh * 64)
    drop = ((1, dropout_threshold(rate), float(torch.tensor(1.0 / (1.0 - rate))),
             seed) if rate else (0, 0, 1.0, 0))
    assert fwd.attention_fwd_tf32x3_tiled(qkv.data_ptr(), bias.data_ptr(), None,
                                          out.data_ptr(), b, s, nh, 64, 0,
                                          int(full), *drop, None) == 0
    keep = philox_keep_mask(seed, b, nh, s, rate) if rate else None
    ref = attention_reference(qkv, bias, nh, rate, keep)
    torch.testing.assert_close(out, ref, **TOLS[torch.float32])
    exact = attention_float64(qkv, bias, torch.zeros_like(out), nh, rate, keep)[0]
    kernel, twin = ((x.double() - exact).abs().max().item() for x in (out, ref))
    record_property("float64_distance", {"kernel": kernel, "twin": twin})
    assert kernel <= 4.0 * twin + 2.0 ** -21 * exact.abs().max().item()


def test_tf32x3_tiled_entry_point_refuses_what_it_does_not_take(libs):
    """The key-tiled 3xTF32 entry point refuses bf16, S <= 80 (the route
    above's), S > 1024 and misaligned pointers before any launch."""
    fwd, _ = libs
    qkv, bias, _ = _case(1, 1025, 1, False, torch.float32)
    out = torch.empty(1, 1025, 64)
    for s, code, offset, want in ((1025, 0, 0, 1), (80, 0, 0, 1), (130, 1, 0, 1),
                                  (130, 0, 4, 716)):
        assert fwd.attention_fwd_tf32x3_tiled(
            qkv.data_ptr() + offset, bias.data_ptr(), None, out.data_ptr(), 1, s,
            1, 64, code, 0, 0, 0, 1.0, 0, None) == want


# The key-tiled routes above 256 tokens, where training and bf16 take them:
# bf16 K1 on the key-tiled tensor-core kernel, fp32 K1 on the key-tiled
# 3xTF32 one, and K2 on its key-tiled pair of kernels in both types.
# S = 257 (a last key tile of one key, a last row block of one row) and
# 300 (tails of 12 and 44 in bf16's tiles, 12 in fp32's); both biases,
# dropout on and off; item 0 all padding.  Two fp32 cases: each takes
# about 17 s here (K2's fp32 tiles of 16 rows, three products each).
LONG_CASES = [(257, False, 0.1, torch.bfloat16), (257, True, 0.0, torch.bfloat16),
              (300, True, 0.1, torch.bfloat16), (300, False, 0.0, torch.bfloat16),
              (257, True, 0.1, torch.float32), (300, False, 0.0, torch.float32)]


def _run_long(libs, qkv, bias, grad, nh, rate, seed=31):
    """K1 on its training route above 256 and K2 on the key-tiled one:
    (out, dqkv, dbias)."""
    fwd, bwd = libs
    b, s, _ = qkv.shape
    full = bias.ndim == 4
    drop = ((1, dropout_threshold(rate), float(torch.tensor(1.0 / (1.0 - rate))), seed)
            if rate else (0, 0, 1.0, 0))
    code = DTYPE_CODES[qkv.dtype]
    out = torch.empty(b, s, nh * 64, dtype=qkv.dtype)
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(bias) if full else None
    stats = torch.empty(b, nh, s, 3)
    k1 = (fwd.attention_fwd_tc_tiled if qkv.dtype == torch.bfloat16
          else fwd.attention_fwd_tf32x3_tiled)
    assert k1(qkv.data_ptr(), bias.data_ptr(), None, out.data_ptr(), b, s, nh, 64,
              code, int(full), *drop, None) == 0
    assert bwd.attention_bwd_tiled(
        qkv.data_ptr(), bias.data_ptr(), grad.data_ptr(), None, dqkv.data_ptr(),
        None if dbias is None else dbias.data_ptr(), stats.data_ptr(), b, s, nh, 64,
        code, int(full), *drop, None) == 0
    return out, dqkv, dbias


@pytest.mark.parametrize("s,full,rate,dtype", LONG_CASES,
                         ids=[f"S{s}-{'full' if f else 'key'}-rate{r}-"
                              f"{str(d).replace('torch.', '')}"
                              for s, f, r, d in LONG_CASES])
def test_key_tiled_training_routes_match_reference(libs, s, full, rate, dtype,
                                                   record_property):
    """K1 and K2 past 256 tokens against their twins at the dtype's bar
    (dbias at fp32's), given the kernels' Philox mask, and against the
    float64 evaluation of the same function: bf16 within twice the twins'
    distance (the online softmax rounds the unnormalised probabilities, the
    twin the normalised ones); fp32 within four times plus 2^-21 of each
    output's size (3xTF32 leaves out 2^-22 of each product).  Item 0 is
    all padding: every key at MASK_VALUE, a uniform softmax in the online
    form and in both K2 kernels."""
    nh, b, seed = 1, 2, 31
    qkv, bias = _tiled_case(b, s, nh, full)
    qkv = qkv.to(dtype)
    grad = torch.randn(b, s, nh * 64,
                       generator=torch.Generator().manual_seed(s + 1)).to(dtype)
    got = _run_long(libs, qkv, bias, grad, nh, rate, seed)
    twins, keep = _check(got, qkv, bias, grad, nh, rate, seed)
    exact = attention_float64(qkv, bias, grad, nh, rate, keep)
    distances = {}
    for name, k, t, e in zip(("out", "dqkv", "dbias"), got, twins, exact):
        if e is None:
            continue
        kernel, twin = ((x.double() - e).abs().max().item() for x in (k, t))
        distances[name] = {"kernel": kernel, "twin": twin}
        if dtype == torch.bfloat16:
            assert kernel <= 2.0 * twin, (name, kernel, twin)
        else:
            assert kernel <= 4.0 * twin + 2.0 ** -21 * e.abs().max().item(), (
                name, kernel, twin)
    record_property("float64_distance", distances)


def test_key_tiled_entry_points_refuse_what_they_do_not_take(libs):
    """The key-tiled tensor-core K1 refuses fp32, S > 1024 and misaligned
    pointers; the key-tiled K2 refuses S > 1024, a dtype it has no kernel
    for, a null stats tensor and misaligned pointers: before any launch."""
    fwd, bwd = libs
    qkv, bias, grad = _case(1, 1025, 1, False, torch.bfloat16)
    out = torch.empty(1, 1025, 64, dtype=torch.bfloat16)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(1, 1, 1025, 3)
    for s, code, offset, want in ((1025, 1, 0, 1), (300, 0, 0, 1), (300, 1, 2, 716)):
        assert fwd.attention_fwd_tc_tiled(
            qkv.data_ptr() + offset, bias.data_ptr(), None, out.data_ptr(), 1, s, 1,
            64, code, 0, 0, 0, 1.0, 0, None) == want
    for s, code, offset, st, want in ((1025, 1, 0, stats.data_ptr(), 1),
                                      (300, 2, 0, stats.data_ptr(), 1),
                                      (300, 1, 0, None, 1),
                                      (300, 1, 2, stats.data_ptr(), 716)):
        assert bwd.attention_bwd_tiled(
            qkv.data_ptr() + offset, bias.data_ptr(), grad.data_ptr(), None,
            dqkv.data_ptr(), None, st, 1, s, 1, 64, code, 0, 0, 0, 1.0, 0,
            None) == want


def test_tf32_split_rounds_to_nearest_ties_away(tmp_path_factory):
    """mma.cuh's split_tf32 on the emulated cvt.rna: big is x rounded to
    TF32, to nearest with ties away from zero, small the rest in TF32, both
    with their low 13 bits 0, and big + small within 2^-22 of x; ties,
    signs, the top of the range, infinities and NaN included."""
    out = emulation_dir(tmp_path_factory)
    _emulated_sources(out)
    (out / "split.cc").write_text(
        '#include "cuda_runtime.h"\n#include "mma.cuh"\n'
        'extern "C" void split(const float* x, uint32_t* big, uint32_t* small, int n) {\n'
        '  for (int i = 0; i < n; ++i) mma::split_tf32(x[i], big[i], small[i]);\n'
        '}\n')
    r = gxx(out, out / "split.cc", out / "libsplit.so")
    assert r.returncode == 0, r.stderr[-4000:]
    lib = ctypes.CDLL(str(out / "libsplit.so"))
    rng = np.random.default_rng(0)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, 20000, dtype=np.uint64).astype(np.uint32),
        # Ties (low 13 bits 0x1000) and their neighbours, both signs.
        (rng.integers(0, 2 ** 19, 300, dtype=np.uint32) << 13) + np.uint32(0x1000),
        (rng.integers(0, 2 ** 19, 300, dtype=np.uint32) << 13) + np.uint32(0x0fff),
        np.array([0x7f7fffff, 0xff7fffff, 0x7f800000, 0xff800000, 0x7fc00000,
                  0x00001000, 0x80001000, 0x00000fff, 0], np.uint32)])
    x = bits.view(np.float32)
    big = np.empty_like(bits)
    small = np.empty_like(bits)
    lib.split(ctypes.c_void_p(x.ctypes.data), ctypes.c_void_p(big.ctypes.data),
              ctypes.c_void_p(small.ctypes.data), len(x))
    nan = np.isnan(x)
    assert np.isnan(big.view(np.float32)[nan]).all()
    b, sm, xb = big[~nan], small[~nan], bits[~nan]
    # Ties away from zero: the magnitude's bits plus half of the dropped ones.
    want = ((xb.astype(np.uint64) + 0x1000) & 0xffffe000).astype(np.uint32)
    np.testing.assert_array_equal(b, want)
    assert not (b & 0x1fff).any() and not (sm & 0x1fff).any()
    # Where x - big is a normal number (|x| >= 2^-100) and big finite.
    xs = x[~nan].astype(np.float64)
    normal = np.isfinite(b.view(np.float32)) & (np.abs(xs) >= 2.0 ** -100)
    xn = xs[normal]
    rest = xn - b.view(np.float32)[normal] - sm.view(np.float32)[normal]
    assert len(xn) > 10000
    assert (np.abs(rest) <= 2.0 ** -22 * np.abs(xn)).all()
