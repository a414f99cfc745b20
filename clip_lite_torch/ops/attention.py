"""Multi-head self-attention over packed QKV, up to 1024 tokens.

Two hand-written CUDA kernels, the port of the JAX package's Pallas pair
(``clip_lite_tpu/ops/attention.py``):

- K1, ``csrc/attention_fwd.cu``: scores, bias, softmax, dropout and
  context in one launch; wrapper :func:`attention_forward`.
- K2, ``csrc/attention_bwd.cu``: the recompute backward (probabilities and
  dropout mask regenerated, nothing saved but the inputs), and for a full
  bias its gradient; wrapper :func:`attention_backward`.

:func:`fused_short_attention` ties them together as a
``torch.autograd.Function``, in the role of the JAX package's
``jax.custom_vjp`` ``_fused``.  Each kernel has a plain PyTorch twin in
this module (:func:`attention_reference`,
:func:`attention_backward_reference`, and :func:`philox_keep_mask` for
the dropout mask): the wrappers take the twins for CPU tensors, and
``chip_smoke.py`` holds the kernels against them on the card.

Layout contract, as in the JAX package: q/k/v arrive packed as the fused
projection's output (B, S, 3*NH*HD), head h of q/k/v in lanes
[h*HD, (h+1)*HD) of each third; the context leaves as (B, S, NH*HD).
Semantics: additive fp32 score bias, fp32 softmax, dropout (keep /
(1 - rate)), probabilities cast to the compute type before the context
product, fp32 accumulation.  The bias is either a (B, S) key bias (0 on
real tokens, ``MASK_VALUE`` on padding; BERT), which gets no gradient, or
a full (B, NH, S, S) per-head bias (MPNet's relative position bias plus
padding), whose gradient ``dbias`` is the fp32 score gradient ``ds``
before the ``1 / sqrt(HD)`` of the q.k product (``attention.py:167-173``
of the JAX package).

Dropout draws: the keep decision for element (b, h, i, j) is Philox's
function of (seed, b, h, i, j) (``csrc/attention_common.cuh``), the same
in K1, K2 and the CPU twin; tests may pass an explicit keep mask instead.

Routes on the card, one function: :func:`attention_route` picks one for
each kernel by dtype, S and, for float32 K1, whether K2 will take the
output's gradient.  bfloat16 at S <= ``TC_MAX_SEQ`` (64) takes the
tensor-core kernels (``attention_fwd_tc``/``attention_bwd_tc``: products
on ``mma.sync``, every qkv and g byte read once).  float32 K1 at
S <= ``TF32X3_MAX_SEQ`` (80) outside training takes the 3xTF32 kernel
(``attention_fwd_tf32x3``: each fp32 product as three TF32 products on
``mma.sync``, to about 2^-21 of it; plain TF32 would change the numbers),
and above 80 the key-tiled 3xTF32 kernel (``attention_fwd_tf32x3_tiled``:
keys streamed through shared memory in tiles, an online softmax; CLIP's
vision towers at 197, 257 and 577).  Up to ``MAX_SEQ`` (256) the rest
takes the CUDA-core kernels (``attention_fwd``/``attention_bwd``: fp32
products, a head staged whole): float32 K2, float32 K1 in training (K2
regenerates that kernel's probabilities), and bfloat16 above 64.  Above
256, up to ``TILED_MAX_SEQ`` (1024), every kernel streams: bfloat16 K1
takes the key-tiled tensor-core kernel (``attention_fwd_tc_tiled``),
float32 K1 in training the key-tiled 3xTF32 one, and K2 in either type
its key-tiled pair (``attention_bwd_tiled``: one kernel by query rows,
one by key columns, the 3xTF32 scores of K1's kernel in float32), so
BERT and MPNet train and serve at their 512 and 514 positions.  The
choice is never a fallback: a refused launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from clip_lite_torch.utils.trace import traced

MASK_VALUE = float(np.finfo(np.float32).min) * 0.5
MAX_SEQ = 256
TC_MAX_SEQ = 64
TF32X3_MAX_SEQ = 80
TILED_MAX_SEQ = 1024
HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF


def dropout_threshold(rate: float) -> int:
    """Keep iff 32 random bits >= this (``attention.py:268`` of the JAX
    package)."""
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def _inv_keep(rate: float) -> float:
    return float(np.float32(1.0 / (1.0 - rate)))


def _philox_bits(seed: int, b, h, i, j) -> np.ndarray:
    """First output word of Philox4x32-10 on counter (j, i, h, b) (uint64
    arrays holding 32-bit words) and key (seed low, seed high): numpy's
    twin of ``philox_bits`` in ``csrc/attention_common.cuh`` (64-bit
    products of 32-bit words are exact in uint64)."""
    c0, c1, c2, c3 = j, i, h, b
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & _M32, (k1 + 0xBB67AE85) & _M32
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ np.uint64(k0),
                          p1 & np.uint64(_M32),
                          (p0 >> np.uint64(32)) ^ c3 ^ np.uint64(k1),
                          p0 & np.uint64(_M32))
    return c0


def philox_keep_mask(seed: int, batch: int, num_heads: int, seq: int,
                     rate: float) -> torch.Tensor:
    """(B, NH, S, S) bool keep mask of seed ``seed``: the plain twin of the
    kernels' draw, kept iff the element's bits >= the rate's threshold."""
    b, h, i, j = np.meshgrid(*(np.arange(n, dtype=np.uint64)
                               for n in (batch, num_heads, seq, seq)),
                             indexing="ij")
    bits = _philox_bits(seed, b, h, i, j)
    return torch.from_numpy(bits >= np.uint64(dropout_threshold(rate)))


def _heads(qkv: torch.Tensor, num_heads: int):
    b, s, three_h = qkv.shape
    hd = three_h // 3 // num_heads
    return qkv.view(b, s, 3, num_heads, hd).permute(2, 0, 3, 1, 4)


def _probs(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    add = bias if bias.ndim == 4 else bias[:, None, None, :]
    return torch.softmax(scores / math.sqrt(q.shape[-1]) + add, dim=-1)


def _drop(x: torch.Tensor, rate: float, keep: Optional[torch.Tensor]):
    if rate <= 0.0:
        return x
    if keep is None:
        raise ValueError("attention dropout needs a keep mask")
    return torch.where(keep.bool(), x * _inv_keep(rate), 0.0)


def attention_reference(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                        dropout_rate: float = 0.0,
                        keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch attention on the packed layout, K1's twin; ``bias`` is
    the (B, S) fp32 key bias or the full (B, NH, S, S) fp32 bias,
    ``keep_mask`` the (B, NH, S, S) keep mask that dropout at
    ``dropout_rate`` > 0 needs."""
    b, s, three_h = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    probs = _drop(_probs(q, k, bias), dropout_rate, keep_mask)
    ctx = torch.matmul(probs.to(qkv.dtype), v)  # (B, NH, S, HD)
    return ctx.transpose(1, 2).reshape(b, s, three_h // 3)


def attention_backward_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                 g: torch.Tensor, num_heads: int,
                                 dropout_rate: float = 0.0,
                                 keep_mask: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K2's twin, step by step: ``(dqkv, dbias)`` of
    :func:`attention_reference` for the output gradient ``g`` (B, S, H).
    ``dqkv`` in the compute type of ``qkv``: probabilities and ``ds`` in
    fp32; ``p_d`` and ``ds / sqrt(HD)`` rounded to the compute type before
    their products; fp32 accumulation and one rounding at the output.
    ``dbias`` is ``ds`` itself, fp32 (B, NH, S, S), for a full bias, and
    None for a key bias."""
    cdt = qkv.dtype
    b, s, three_h = qkv.shape
    q, k, v = _heads(qkv, num_heads)
    gh = g.to(cdt).view(b, s, num_heads, -1).transpose(1, 2).float()
    probs = _probs(q, k, bias)
    pd = _drop(probs, dropout_rate, keep_mask).to(cdt).float()
    dv = torch.matmul(pd.transpose(-1, -2), gh)
    dp = _drop(torch.matmul(gh, v.float().transpose(-1, -2)), dropout_rate,
               keep_mask)
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    dbias = ds if bias.ndim == 4 else None
    ds = (ds * (1.0 / math.sqrt(q.shape[-1]))).to(cdt).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dqkv = torch.stack([dq, dk, dv])  # (3, B, NH, S, HD)
    return dqkv.permute(1, 3, 0, 2, 4).reshape(b, s, three_h).to(cdt), dbias


def attention_float64(qkv: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
                      num_heads: int, dropout_rate: float = 0.0,
                      keep_mask: Optional[torch.Tensor] = None):
    """K1's and K2's function evaluated in float64 from the same inputs and
    keep mask, with no rounding in between: ``(out, dqkv, dbias)``, dbias
    None for a key bias; ``dqkv`` and ``dbias`` by autograd through the
    float64 forward.  A bar that does not depend on the order of sums: the
    checks hold a kernel's distance from it against its twin's.  For tests
    and checks; no path of the system calls it."""
    full = bias.ndim == 4
    with torch.enable_grad():
        x = qkv.detach().double().requires_grad_()
        y = bias.detach().double().requires_grad_(full)
        b, s, three_h = qkv.shape
        q, k, v = _heads(x, num_heads)
        add = y if full else y[:, None, None, :]
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2))
                              / math.sqrt(q.shape[-1]) + add, dim=-1)
        if dropout_rate > 0.0:
            probs = torch.where(keep_mask.bool(), probs / (1.0 - dropout_rate),
                                0.0)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, three_h // 3)
        grads = torch.autograd.grad(out, (x, y) if full else (x,),
                                    g.to(qkv.dtype).double())
    return out.detach(), grads[0], grads[1] if full else None


def attention_route(dtype: torch.dtype, seq: int, kernel: str,
                    training: bool = False) -> str:
    """The route a CUDA launch of ``kernel`` (``"forward"``, K1, or
    ``"backward"``, K2) at compute type ``dtype`` and sequence length
    ``seq`` takes: ``"tensor_core"`` for bfloat16 at ``seq <= TC_MAX_SEQ``
    (bf16 products on ``mma.sync``, a block stages its head whole);
    ``"tf32x3"`` for float32 K1 at ``seq <= TF32X3_MAX_SEQ`` unless
    ``training`` (3xTF32 products on ``mma.sync``), ``"tf32x3_tiled"``
    for it above (the key-tiled 3xTF32 kernel), and for float32 K1 in
    training above ``MAX_SEQ``; ``"tensor_core_tiled"`` for bfloat16 K1
    above ``MAX_SEQ`` (the key-tiled bf16 kernel); ``"tiled"`` for K2 in
    either type above ``MAX_SEQ`` (its key-tiled pair of kernels); else
    ``"cuda_core"`` (fp32 products, up to ``MAX_SEQ``): float32 K2,
    float32 K1 in training (K2 takes the gradient and regenerates this
    kernel's probabilities), and bfloat16 at 64 < ``seq``.  The streaming
    routes take up to ``TILED_MAX_SEQ``."""
    if dtype == torch.bfloat16 and seq <= TC_MAX_SEQ:
        return "tensor_core"
    if kernel == "forward" and dtype == torch.float32 and not training:
        return "tf32x3" if seq <= TF32X3_MAX_SEQ else "tf32x3_tiled"
    if seq <= MAX_SEQ:
        return "cuda_core"
    if kernel == "backward":
        return "tiled"
    return "tf32x3_tiled" if dtype == torch.float32 else "tensor_core_tiled"


_TILED_ROUTES = ("tf32x3_tiled", "tensor_core_tiled", "tiled")


def max_seq(route: str) -> int:
    """The longest sequence the kernel of ``route`` takes: the key-tiled
    kernels stream (``TILED_MAX_SEQ``); the others stage a head whole
    (``MAX_SEQ``)."""
    return TILED_MAX_SEQ if route in _TILED_ROUTES else MAX_SEQ


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    from clip_lite_torch.ops import _build

    lib = _build.load(name)
    dropout_args = [ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
                    ctypes.c_uint64, ctypes.c_void_p]
    if name == "attention_fwd":
        lib.routes = {"cuda_core": lib.attention_fwd,
                      "tensor_core": lib.attention_fwd_tc,
                      "tf32x3": lib.attention_fwd_tf32x3,
                      "tf32x3_tiled": lib.attention_fwd_tf32x3_tiled,
                      "tensor_core_tiled": lib.attention_fwd_tc_tiled}
        for fn in lib.routes.values():
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + dropout_args
            fn.restype = ctypes.c_int
        lib.attention_dropout_mask.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 3
            + [ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p])
        lib.attention_dropout_mask.restype = ctypes.c_int
    else:
        lib.routes = {"cuda_core": lib.attention_bwd,
                      "tensor_core": lib.attention_bwd_tc,
                      "tiled": lib.attention_bwd_tiled}
        for route, fn in lib.routes.items():
            # The key-tiled pair takes its row statistics' scratch too.
            pointers = 7 if route == "tiled" else 6
            fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 6
                           + dropout_args)
            fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                keep_mask: Optional[torch.Tensor]):
    """Raise on what the kernels do not take; return the keep mask as a
    contiguous int8 tensor (or None)."""
    b, s, three_h = qkv.shape
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernels take float32 or bfloat16 qkv, "
                        f"got {qkv.dtype}")
    if bias.dtype != torch.float32 or bias.device != qkv.device:
        raise TypeError("mask_bias must be float32 on the device of qkv")
    if three_h % 3 or three_h // 3 != num_heads * HEAD_DIM:
        raise ValueError(f"the attention kernels need head_dim {HEAD_DIM}: got "
                         f"width {three_h} for {num_heads} heads")
    if b == 0 or s == 0:
        raise ValueError(f"empty qkv {tuple(qkv.shape)}")
    if keep_mask is None:
        return None
    if keep_mask.shape != (b, num_heads, s, s) or keep_mask.device != qkv.device:
        raise ValueError(f"keep_mask must be (B, NH, S, S) = "
                         f"{(b, num_heads, s, s)} on the device of qkv")
    return keep_mask.to(torch.int8).contiguous()


def _dropout_args(rate: float, seed: int):
    if rate <= 0.0:
        return 0, 0, 1.0, 0
    return 1, dropout_threshold(rate), _inv_keep(rate), int(seed)


_ROUTE_NAMES = {"cuda_core": "", "tensor_core": " (tensor-core route)",
                "tf32x3": " (3xTF32 route)",
                "tf32x3_tiled": " (key-tiled 3xTF32 route)",
                "tensor_core_tiled": " (key-tiled tensor-core route)",
                "tiled": " (key-tiled route)"}


def _raise_on(lib: ctypes.CDLL, err: int, kernel: str,
              route: str = "cuda_core") -> None:
    if err:
        raise RuntimeError(f"{kernel}{_ROUTE_NAMES[route]} launch failed: "
                           + lib.kernel_error_string(err).decode())


def _check_seq(qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
               kernel: str = "forward", training: bool = False) -> None:
    """The contract of both devices, so that the CPU tests hold callers to
    what the kernels take: the length limit of the route that
    :func:`attention_route` picks for ``kernel`` and ``training``."""
    b, s, _ = qkv.shape
    if tuple(bias.shape) not in ((b, s), (b, num_heads, s, s)):
        raise ValueError(f"mask_bias must be (B, S) = {(b, s)} or (B, NH, S, S) "
                         f"= {(b, num_heads, s, s)}, got {tuple(bias.shape)}")
    if not (qkv.is_contiguous() and bias.is_contiguous()):
        raise ValueError("the attention kernels take contiguous tensors")
    route = attention_route(qkv.dtype, s, kernel, training)
    if s > max_seq(route):
        raise ValueError(f"the attention kernels cover sequences up to "
                         f"{max_seq(route)} on the {route} route ({qkv.dtype} "
                         f"{kernel}{', training' if training else ''}), got {s}")
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {qkv.device}")


def _keep_for_cpu(qkv, num_heads, rate, seed, keep_mask):
    if rate <= 0.0 or keep_mask is not None:
        return keep_mask
    b, s, _ = qkv.shape
    return philox_keep_mask(seed, b, num_heads, s, rate)


def _launch_fwd(qkv: torch.Tensor, mask_bias: torch.Tensor, num_heads: int,
                rate: float, seed: int, keep_mask: Optional[torch.Tensor],
                route: str) -> torch.Tensor:
    """Launch K1 on CUDA tensors on ``route`` (``"cuda_core"``,
    ``"tensor_core"``, ``"tf32x3"``, ``"tf32x3_tiled"`` or
    ``"tensor_core_tiled"``) and count the launch.
    :func:`attention_forward` picks the route by :func:`attention_route`;
    ``chip_smoke.py`` names the CUDA-core kernel to time it beside the
    others."""
    keep = _check_cuda(qkv, mask_bias, num_heads, keep_mask)
    b, s, three_h = qkv.shape
    out = torch.empty((b, s, three_h // 3), dtype=qkv.dtype, device=qkv.device)
    lib = _library("attention_fwd")
    launch = lib.routes[route]
    with torch.cuda.device(qkv.device):
        err = launch(
            qkv.data_ptr(), mask_bias.data_ptr(),
            None if keep is None else keep.data_ptr(), out.data_ptr(), b, s,
            num_heads, HEAD_DIM, _DTYPE_CODES[qkv.dtype],
            int(mask_bias.ndim == 4), *_dropout_args(rate, seed),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "K1", route)
    fused_short_attention.launches += 1
    fused_short_attention.tc_launches += route == "tensor_core"
    fused_short_attention.tf32x3_launches += route == "tf32x3"
    fused_short_attention.tf32x3_tiled_launches += route == "tf32x3_tiled"
    fused_short_attention.tc_tiled_launches += route == "tensor_core_tiled"
    return out


def _launch_bwd(qkv: torch.Tensor, mask_bias: torch.Tensor, g: torch.Tensor,
                num_heads: int, rate: float, seed: int,
                keep_mask: Optional[torch.Tensor], route: str
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch K2 on CUDA tensors (``g`` contiguous, in the type of
    ``qkv``) on ``route`` (``"cuda_core"``, ``"tensor_core"`` or
    ``"tiled"``: its two kernels, one launch of K2), and count the launch:
    as :func:`_launch_fwd`."""
    keep = _check_cuda(qkv, mask_bias, num_heads, keep_mask)
    b, s, three_h = qkv.shape
    if g.shape != (b, s, three_h // 3) or g.device != qkv.device:
        raise ValueError(f"g must be (B, S, H) = {(b, s, three_h // 3)} on the "
                         "device of qkv")
    full = mask_bias.ndim == 4
    dqkv = torch.empty_like(qkv)
    dbias = torch.empty_like(mask_bias) if full else None
    # The key-tiled pair's scratch: each query row's softmax max, sum and
    # D, written by its first kernel and read by its second.
    stats = ([torch.empty((b, num_heads, s, 3), dtype=torch.float32,
                          device=qkv.device).data_ptr()]
             if route == "tiled" else [])
    lib = _library("attention_bwd")
    launch = lib.routes[route]
    with torch.cuda.device(qkv.device):
        err = launch(
            qkv.data_ptr(), mask_bias.data_ptr(), g.data_ptr(),
            None if keep is None else keep.data_ptr(), dqkv.data_ptr(),
            None if dbias is None else dbias.data_ptr(), *stats, b, s,
            num_heads, HEAD_DIM, _DTYPE_CODES[qkv.dtype], int(full),
            *_dropout_args(rate, seed),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "K2", route)
    attention_backward.launches += 1
    attention_backward.tc_launches += route == "tensor_core"
    attention_backward.tiled_launches += route == "tiled"
    return dqkv, dbias


@traced("K1 attention_fwd")
def attention_forward(qkv: torch.Tensor, mask_bias: torch.Tensor,
                      num_heads: int, *, dropout_rate: float = 0.0,
                      seed: int = 0,
                      keep_mask: Optional[torch.Tensor] = None,
                      training: bool = False) -> torch.Tensor:
    """K1's wrapper (no autograd): the context of ``qkv`` (B, S, 3H) under
    the fp32 bias ``mask_bias``, (B, S) or (B, NH, S, S), with attention
    dropout at ``dropout_rate`` drawn from Philox(``seed``) or taken from
    ``keep_mask``; ``training``: K2 will take the output's gradient.

    CPU tensors take :func:`attention_reference`.  CUDA tensors launch K1
    on the route :func:`attention_route` picks, or raise; every launch
    adds one to ``fused_short_attention.launches``, and one on the
    tensor-core route to ``fused_short_attention.tc_launches`` too, one on
    the 3xTF32 route to ``fused_short_attention.tf32x3_launches``, one on
    the key-tiled 3xTF32 route to
    ``fused_short_attention.tf32x3_tiled_launches``, one on the key-tiled
    tensor-core route to ``fused_short_attention.tc_tiled_launches``.
    """
    _check_seq(qkv, mask_bias, num_heads, "forward", training)
    rate = float(dropout_rate)
    if qkv.device.type == "cpu":
        keep = _keep_for_cpu(qkv, num_heads, rate, seed, keep_mask)
        return attention_reference(qkv, mask_bias, num_heads, rate, keep)
    return _launch_fwd(qkv, mask_bias, num_heads, rate, seed, keep_mask,
                       attention_route(qkv.dtype, qkv.shape[1], "forward",
                                       training))


@traced("K2 attention_bwd")
def attention_backward(qkv: torch.Tensor, mask_bias: torch.Tensor,
                       g: torch.Tensor, num_heads: int, *,
                       dropout_rate: float = 0.0, seed: int = 0,
                       keep_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K2's wrapper: ``(dqkv, dbias)`` for the output gradient ``g`` of
    :func:`attention_forward` with the same arguments (``g`` is cast to
    the compute type first).  ``dqkv`` (B, S, 3H) in the type of ``qkv``;
    ``dbias`` the fp32 (B, NH, S, S) gradient of a full bias, None for a
    key bias.

    CPU tensors take :func:`attention_backward_reference`.  CUDA tensors
    launch K2 on the route :func:`attention_route` picks, or raise; every
    launch adds one to ``attention_backward.launches``, and one on the
    tensor-core route to ``attention_backward.tc_launches`` too, one on the
    key-tiled route to ``attention_backward.tiled_launches``.
    """
    _check_seq(qkv, mask_bias, num_heads, "backward")
    rate = float(dropout_rate)
    g = g.to(qkv.dtype).contiguous()
    if qkv.device.type == "cpu":
        keep = _keep_for_cpu(qkv, num_heads, rate, seed, keep_mask)
        return attention_backward_reference(qkv, mask_bias, g, num_heads,
                                            rate, keep)
    return _launch_bwd(qkv, mask_bias, g, num_heads, rate, seed, keep_mask,
                       attention_route(qkv.dtype, qkv.shape[1], "backward"))


def dropout_keep_mask(seed: int, batch: int, num_heads: int, seq: int,
                      rate: float, device="cpu") -> torch.Tensor:
    """The (B, NH, S, S) bool keep mask that K1 and K2 draw for ``seed``:
    written by the kernels' own entry point on CUDA, by
    :func:`philox_keep_mask` on the CPU.  For tests and checks; the
    training path never materialises it."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox_keep_mask(seed, batch, num_heads, seq, rate)
    keep = torch.empty((batch, num_heads, seq, seq), dtype=torch.int8,
                       device=device)
    lib = _library("attention_fwd")
    with torch.cuda.device(device):
        err = lib.attention_dropout_mask(
            keep.data_ptr(), batch, num_heads, seq, dropout_threshold(rate),
            int(seed), torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "dropout mask")
    return keep.view(torch.bool)


class _FusedAttention(torch.autograd.Function):
    """K1 forward, K2 backward; saves ``qkv``, ``bias`` and the dropout
    seed (and the keep mask only when the caller gave one).  A full bias
    gets K2's ``dbias`` as its gradient.  K1 launches as in training where
    an input needs its gradient."""

    @staticmethod
    def forward(ctx, qkv, bias, num_heads, rate, seed, keep_mask):
        ctx.save_for_backward(qkv, bias, keep_mask)
        ctx.args = (num_heads, rate, seed)
        return attention_forward(qkv, bias, num_heads, dropout_rate=rate,
                                 seed=seed, keep_mask=keep_mask,
                                 training=any(ctx.needs_input_grad[:2]))

    @staticmethod
    def backward(ctx, g):
        qkv, bias, keep_mask = ctx.saved_tensors
        num_heads, rate, seed = ctx.args
        dqkv, dbias = attention_backward(qkv, bias, g, num_heads,
                                         dropout_rate=rate, seed=seed,
                                         keep_mask=keep_mask)
        return dqkv, dbias, None, None, None, None


def fused_short_attention(qkv: torch.Tensor, mask_bias: torch.Tensor,
                          num_heads: int, *, dropout_rate: float = 0.0,
                          deterministic: bool = True, seed: Optional[int] = None,
                          keep_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Multi-head self-attention over packed QKV, differentiable: K1
    forward, K2 backward.

    Args:
      qkv: (B, S, 3*H) fused projection output, float32 or bfloat16.
      mask_bias: float32 additive score bias: (B, S) on keys (0 on real
        tokens, ``MASK_VALUE`` on padding), which gets no gradient, or a
        full (B, NH, S, S) per-head bias (MPNet's relative position bias
        plus padding), which gets ``dbias`` from K2.
      num_heads: number of heads; H / num_heads must be 64 on CUDA.
      dropout_rate, deterministic: attention-probability dropout, off when
        ``deterministic``.
      seed: the dropout draw's key (an int below 2**64); required when
        dropout is active and no ``keep_mask`` is given.
      keep_mask: optional (B, NH, S, S) keep mask replacing Philox's draw
        (the parity tests' hook).

    CPU tensors run the plain twins in both directions; CUDA tensors launch
    the kernels, on the route :func:`attention_route` picks, or raise.
    """
    rate = 0.0 if deterministic else float(dropout_rate)
    # Training as _FusedAttention.forward will see it: K2 takes the
    # gradient, and K1 runs on its training route.
    _check_seq(qkv, mask_bias, num_heads, "forward",
               torch.is_grad_enabled()
               and (qkv.requires_grad or mask_bias.requires_grad))
    if rate > 0.0 and seed is None and keep_mask is None:
        raise ValueError("attention dropout needs a seed or a keep mask")
    if rate <= 0.0:
        keep_mask = None
    return _FusedAttention.apply(qkv, mask_bias, num_heads, rate,
                                 0 if seed is None else int(seed), keep_mask)


fused_short_attention.launches = 0
fused_short_attention.tc_launches = 0
fused_short_attention.tf32x3_launches = 0
fused_short_attention.tf32x3_tiled_launches = 0
fused_short_attention.tc_tiled_launches = 0
attention_backward.launches = 0
attention_backward.tc_launches = 0
attention_backward.tiled_launches = 0


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


__all__ = ["fused_short_attention", "attention_forward", "attention_backward",
           "attention_reference", "attention_backward_reference",
           "attention_float64", "attention_route", "dropout_keep_mask",
           "philox_keep_mask", "resolve_fused_flag", "max_seq", "MASK_VALUE",
           "TC_MAX_SEQ", "TF32X3_MAX_SEQ", "TILED_MAX_SEQ"]
