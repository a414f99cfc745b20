"""Multi-head self-attention over packed QKV for short sequences.

``fused_short_attention`` is the wrapper of K1, the hand-written CUDA
kernel in ``csrc/attention_fwd.cu`` (the port of the JAX package's Pallas
``_attention_fwd_kernel``).  ``attention_reference`` is its plain PyTorch
version: the CPU tests use it, the wrapper takes it for CPU tensors, and
``chip_smoke.py`` holds the kernel against it on the card.

Layout contract, as in the JAX package: q/k/v arrive packed as the fused
projection's output (B, S, 3*NH*HD), head h of q/k/v in lanes
[h*HD, (h+1)*HD) of each third; the context leaves as (B, S, NH*HD).
Semantics: additive fp32 score bias (``MASK_VALUE`` on padded keys), fp32
softmax, probabilities cast to the compute type before the context
product, fp32 accumulation.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

MASK_VALUE = float(np.finfo(np.float32).min) * 0.5
MAX_SEQ = 256
HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                        dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch attention on the packed layout; ``bias`` is the
    (B, S) fp32 key bias."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout lands with the training slice "
            "(ROADMAP Queue 2, K1 dropout)")
    b, s, three_h = qkv.shape
    hidden = three_h // 3
    hd = hidden // num_heads
    q, k, v = qkv.view(b, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores / math.sqrt(hd) + bias[:, None, None, :],
                          dim=-1)
    ctx = torch.matmul(probs.to(qkv.dtype), v)  # (B, NH, S, HD)
    return ctx.transpose(1, 2).reshape(b, s, hidden)


@functools.cache
def _kernel() -> ctypes.CDLL:
    from clip_lite_torch.ops import _build

    lib = _build.load("attention_fwd")
    lib.attention_fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.attention_fwd.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def fused_short_attention(qkv: torch.Tensor, mask_bias: torch.Tensor,
                          num_heads: int, *, dropout_rate: float = 0.0,
                          deterministic: bool = True) -> torch.Tensor:
    """Multi-head self-attention over packed QKV through K1.

    Args:
      qkv: (B, S, 3*H) fused projection output, float32 or bfloat16.
      mask_bias: (B, S) float32 additive key bias (0 on real tokens,
        ``MASK_VALUE`` on padding).
      num_heads: number of heads; H / num_heads must be 64.
      dropout_rate, deterministic: attention dropout; only rate 0 (or
        ``deterministic=True``) is supported yet.

    CPU tensors take :func:`attention_reference`.  CUDA tensors launch the
    kernel or raise; every launch adds one to
    ``fused_short_attention.launches``.
    """
    rate = 0.0 if deterministic else float(dropout_rate)
    if rate > 0.0:
        raise NotImplementedError(
            "attention dropout in K1 lands with the training slice "
            "(ROADMAP Queue 2)")
    if mask_bias.ndim != 2:
        raise NotImplementedError(
            "K1 takes a (B, S) key bias; the full (B, NH, S, S) bias "
            "variant is queued for MPNet (ROADMAP Queue 2)")
    b, s, three_h = qkv.shape
    hidden = three_h // 3
    if s > MAX_SEQ:
        raise ValueError(f"K1 covers sequences up to {MAX_SEQ}, got {s}")
    if qkv.device.type == "cpu":
        return attention_reference(qkv, mask_bias, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"K1 takes float32 or bfloat16 qkv, got {qkv.dtype}")
    if mask_bias.dtype != torch.float32 or mask_bias.device != qkv.device:
        raise TypeError("mask_bias must be float32 on the device of qkv")
    if three_h % 3 or hidden != num_heads * HEAD_DIM:
        raise ValueError(f"K1 needs head_dim {HEAD_DIM}: got width {three_h} "
                         f"for {num_heads} heads")
    if mask_bias.shape != (b, s) or b == 0 or s == 0:
        raise ValueError(f"bad shapes qkv {tuple(qkv.shape)}, "
                         f"mask_bias {tuple(mask_bias.shape)}")
    if not (qkv.is_contiguous() and mask_bias.is_contiguous()):
        raise ValueError("K1 takes contiguous qkv and mask_bias")
    out = torch.empty((b, s, hidden), dtype=qkv.dtype, device=qkv.device)
    lib = _kernel()
    with torch.cuda.device(qkv.device):
        err = lib.attention_fwd(
            qkv.data_ptr(), mask_bias.data_ptr(), out.data_ptr(), b, s,
            num_heads, HEAD_DIM, _DTYPE_CODES[qkv.dtype],
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("K1 launch failed: "
                           + lib.kernel_error_string(err).decode())
    fused_short_attention.launches += 1
    return out


fused_short_attention.launches = 0


def resolve_fused_flag(flag, device) -> bool:
    """Resolve the tri-state MODEL.TEXTUAL.FUSED_ATTENTION value: "auto"
    takes the kernel for tensors on CUDA; "true"/"false" (or a bool) force
    the fused wrapper on or off."""
    if isinstance(flag, str):
        low = flag.lower()
        if low == "auto":
            return torch.device(device).type == "cuda"
        return low in ("true", "1", "yes")
    return bool(flag)


__all__ = ["fused_short_attention", "attention_reference",
           "resolve_fused_flag", "MASK_VALUE"]
