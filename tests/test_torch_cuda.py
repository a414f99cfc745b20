"""K1 and K2, the CUDA attention kernels, against their plain versions on
the card: forward and backward, with dropout off and on (Philox masks),
under a (B, S) key bias and under MPNet's full (B, NH, S, S) bias, whose
gradient dbias K2 returns.  Every route: the tensor-core kernels (bf16 at
S <= 64, checked at the edges of their tiling, and against the float64
evaluation of the same function), fp32 K1's 3xTF32 kernels (S <= 80, and
the key-tiled one above, up to 1024), the CUDA-core kernels (fp32
training and K2 up to 256, bf16 at 64 < S <= 256, and bf16 below when
launched directly) and, past 256 tokens, the key-tiled routes of training
(bf16 K1's key-tiled tensor-core kernel, fp32 K1's key-tiled 3xTF32 one,
K2's key-tiled pair in both types, up to 1024), with the dispatch between
them.
K3, the normalize kernel, against its plain version bit for bit; K3's
fused flip + colour jitter + normalize pass against the plain composition;
the on-device preprocessing and the device-resident cache on the card;
the host loader's pinned batches, copied to the card.
Checkpoints of a state on the card: an asynchronous save taken while the
next step runs equals a synchronous save of the same step, bit for bit,
and a checkpoint written from channels_last CUDA tensors loads in a CPU
process.
The native JPEG batch path: crop_resize_flip_u8 against its plain twin
bit for bit, nvJPEG's tiles within the decode bars of the twin's, and the
background loader's first losses equal to the foreground loader's.
The step trace: each hand-written kernel's events in a traced SSL step
equal its wrapper's launches, inside its wrapper's range; and the SSL
step through the kernels against the step through their plain twins.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.  The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from clip_lite_torch.config import Config
from clip_lite_torch.data.device_cache import DecodedCorpus, DeviceDataCache
from clip_lite_torch.engine import create_train_state, make_train_step
from clip_lite_torch.models.bert import BertModel
from clip_lite_torch.models.mpnet import MPNetModel
from clip_lite_torch.ops.attention import (
    MASK_VALUE,
    _launch_bwd,
    _launch_fwd,
    attention_backward,
    attention_backward_reference,
    attention_float64,
    attention_forward,
    attention_reference,
    attention_route,
    dropout_keep_mask,
    fused_short_attention,
    philox_keep_mask,
)
from clip_lite_torch.ops.image_ops import (
    AugDraws,
    augment_reference,
    device_preprocess,
    random_flip,
)
from clip_lite_torch.ops.layers import StepRNG, init_weights
from clip_lite_torch.ops.normalize import (
    augment_normalize_u8,
    normalize_reference,
    normalize_u8,
)
from clip_lite_torch.utils import checkpointing as ckpt_mod
from clip_lite_torch.utils.checkpointing import CheckpointManager

pytestmark = pytest.mark.cuda

# fp32: both sides sum exact fp32 products, in another order.  bf16: the
# probabilities and the output are rounded to bf16 on both sides, so a
# difference in the fp32 sums can flip one rounding (torch.testing's bf16
# rtol, 1.6e-2).
TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5),
        torch.bfloat16: dict(rtol=1.6e-2, atol=1e-2)}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _inputs(device, b, s, nh, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * nh * 64, device=device, generator=g)
    lengths = torch.randint(1, s + 1, (b,), device=device, generator=g)
    mask = torch.arange(s, device=device)[None, :] < lengths[:, None]
    return qkv, (1.0 - mask.float()) * MASK_VALUE


SHAPES = [(128, 30, 12), (3, 1, 2), (5, 33, 4), (2, 256, 2), (1, 64, 1),
          (7, 17, 12)]
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["fp32", "bf16"])


@DTYPES
@pytest.mark.parametrize("b,s,nh", SHAPES)
def test_kernel_matches_reference(device, dtype, b, s, nh):
    qkv, bias = _inputs(device, b, s, nh)
    qkv = qkv.to(dtype)
    before = fused_short_attention.launches
    out = fused_short_attention(qkv, bias, nh)
    torch.cuda.synchronize()
    assert fused_short_attention.launches == before + 1
    ref = attention_reference(qkv, bias, nh)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


def test_padded_keys_ignored(device):
    qkv, bias = _inputs(device, 16, 30, 12)
    bias[:, 20:] = MASK_VALUE
    out1 = fused_short_attention(qkv, bias, 12)
    poked = qkv.clone()
    poked[:, 20:, 768:] += 5.0
    out2 = fused_short_attention(poked, bias, 12)
    torch.testing.assert_close(out1[:, :20], out2[:, :20], rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take(device):
    qkv, bias = _inputs(device, 4, 30, 12)
    with pytest.raises(TypeError):
        fused_short_attention(qkv.half(), bias, 12)
    with pytest.raises(ValueError):
        fused_short_attention(qkv[:, ::2], bias[:, ::2], 12)  # not contiguous
    with pytest.raises(ValueError):
        fused_short_attention(qkv, bias, 6)  # head_dim 128


def test_bert_fused_matches_plain_on_card(device):
    ids = torch.randint(103, 500, (8, 30), device=device)
    mask = (torch.arange(30, device=device)[None, :]
            < torch.randint(2, 31, (8, 1), device=device)).long()
    outs = []
    for flag in ("true", "false"):
        model = BertModel(vocab_size=500, hidden_size=128, num_hidden_layers=2,
                          num_heads=2, intermediate_size=512,
                          fused_attention=flag)
        init_weights(model, torch.Generator().manual_seed(0))
        outs.append(model.eval().to(device)(ids * mask, mask))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@DTYPES
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("b,s,nh", SHAPES)
def test_backward_kernel_matches_reference(device, dtype, rate, b, s, nh):
    """K2 against its step-by-step twin, given the Philox mask that the
    kernels' own entry point writes for the same seed."""
    qkv, bias = _inputs(device, b, s, nh)
    qkv = qkv.to(dtype)
    g = torch.randn(b, s, nh * 64, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    seed = 12345
    keep = dropout_keep_mask(seed, b, nh, s, rate, device) if rate else None
    before = attention_backward.launches
    dqkv, dbias = attention_backward(qkv, bias, g, nh, dropout_rate=rate,
                                     seed=seed)
    torch.cuda.synchronize()
    assert attention_backward.launches == before + 1 and dbias is None
    ref, _ = attention_backward_reference(qkv, bias, g, nh, rate, keep)
    assert dqkv.dtype == dtype and dqkv.shape == qkv.shape
    torch.testing.assert_close(dqkv.float(), ref.float(), **TOLS[dtype])
    if rate:
        out = attention_forward(qkv, bias, nh, dropout_rate=rate, seed=seed)
        torch.testing.assert_close(
            out.float(), attention_reference(qkv, bias, nh, rate, keep).float(),
            **TOLS[dtype])


def _full_bias(device, key_bias, nh, seed=3):
    """MPNet's kind of bias: a (1, NH, S, S) table plus the key bias,
    added into one contiguous (B, NH, S, S) tensor."""
    s = key_bias.shape[1]
    rel = torch.randn(1, nh, s, s, device=device,
                      generator=torch.Generator(device=device).manual_seed(seed))
    return rel * 0.5 + key_bias[:, None, None, :]


# dbias is fp32 in both (ds before the 1/sqrt(HD) and the cast), from
# products of the same values summed in another order: fp32's bar whatever
# the compute type.
@DTYPES
@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("b,s,nh", SHAPES)
def test_full_bias_kernels_match_reference(device, dtype, rate, b, s, nh):
    """K1 and K2 with the full bias against their twins, given the Philox
    mask that the kernels' own entry point writes; dbias included."""
    qkv, key_bias = _inputs(device, b, s, nh)
    bias = _full_bias(device, key_bias, nh)
    qkv = qkv.to(dtype)
    g = torch.randn(b, s, nh * 64, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    seed = 4321
    keep = dropout_keep_mask(seed, b, nh, s, rate, device) if rate else None
    k1, k2 = fused_short_attention.launches, attention_backward.launches
    out = attention_forward(qkv, bias, nh, dropout_rate=rate, seed=seed)
    dqkv, dbias = attention_backward(qkv, bias, g, nh, dropout_rate=rate,
                                     seed=seed)
    torch.cuda.synchronize()
    assert (fused_short_attention.launches, attention_backward.launches) == \
        (k1 + 1, k2 + 1)
    ref = attention_reference(qkv, bias, nh, rate, keep)
    dref, dbias_ref = attention_backward_reference(qkv, bias, g, nh, rate, keep)
    assert out.dtype == dqkv.dtype == dtype
    assert dbias.dtype == torch.float32 and dbias.shape == bias.shape
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
    torch.testing.assert_close(dqkv.float(), dref.float(), **TOLS[dtype])
    torch.testing.assert_close(dbias, dbias_ref, **TOLS[torch.float32])


def _kernel_within_twice_the_twin(pairs, exact):
    """Each (kernel, twin) output lies from the float64 value of the same
    function: the kernel's max error at most twice the twin's, a bar that
    does not depend on the order of either's sums."""
    for (got, twin), want in zip(pairs, exact):
        if want is None:
            continue
        k_err = (got.double() - want).abs().max().item()
        t_err = (twin.double() - want).abs().max().item()
        assert k_err <= 2.0 * t_err, (k_err, t_err)


TC_SEQS = [16, 17, 20, 32, 48, 63, 64, 65]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("full", [False, True], ids=["key_bias", "full_bias"])
@pytest.mark.parametrize("nh", [1, 12])
@pytest.mark.parametrize("s", TC_SEQS)
def test_bf16_route_edges_match_reference(device, s, nh, full, rate):
    """bf16 at the edges of the tensor-core tiling (S a multiple of 16, one
    over, one under, and 65, which takes the CUDA-core route): K1 and K2
    against their twins given the kernels' Philox mask, dbias at fp32's
    bar, and all of them within twice the twins' distance from float64."""
    b = 3
    qkv, key_bias = _inputs(device, b, s, nh, seed=s)
    bias = _full_bias(device, key_bias, nh) if full else key_bias
    qkv = qkv.bfloat16()
    g = torch.randn(b, s, nh * 64, device=device,
                    generator=torch.Generator(device=device).manual_seed(1)
                    ).bfloat16()
    seed = 2468
    keep = dropout_keep_mask(seed, b, nh, s, rate, device) if rate else None
    tc = fused_short_attention.tc_launches, attention_backward.tc_launches
    out = attention_forward(qkv, bias, nh, dropout_rate=rate, seed=seed)
    dqkv, dbias = attention_backward(qkv, bias, g, nh, dropout_rate=rate,
                                     seed=seed)
    torch.cuda.synchronize()
    on_tc = int(s <= 64)
    assert (fused_short_attention.tc_launches - tc[0],
            attention_backward.tc_launches - tc[1]) == (on_tc, on_tc)
    ref = attention_reference(qkv, bias, nh, rate, keep)
    dref, dbias_ref = attention_backward_reference(qkv, bias, g, nh, rate, keep)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[torch.bfloat16])
    torch.testing.assert_close(dqkv.float(), dref.float(), **TOLS[torch.bfloat16])
    assert (dbias is None) == (not full)
    if full:
        torch.testing.assert_close(dbias, dbias_ref, **TOLS[torch.float32])
    _kernel_within_twice_the_twin(
        [(out, ref), (dqkv, dref), (dbias, dbias_ref)],
        attention_float64(qkv, bias, g, nh, rate, keep))


def test_dispatch_sends_bf16_to_the_tensor_cores_up_to_64(device):
    """The route by kernel, dtype and S, read from the per-route launch
    counts: bf16 at S = 64 takes the tensor cores, at S = 65 the CUDA
    cores; fp32 K1 at S = 30 the 3xTF32 kernel and fp32 K2 the CUDA cores,
    and the bf16 tensor-core kernels refuse fp32: the launch raises and
    counts nothing."""
    for dtype, s, on_tc, on_tf32 in ((torch.bfloat16, 64, 1, 0),
                                     (torch.bfloat16, 65, 0, 0),
                                     (torch.float32, 30, 0, 1)):
        assert attention_route(dtype, s, "forward") == (
            "tensor_core" if on_tc else "tf32x3" if on_tf32 else "cuda_core")
        assert attention_route(dtype, s, "backward") == ("tensor_core" if on_tc
                                                         else "cuda_core")
        qkv, bias = _inputs(device, 2, s, 12)
        qkv = qkv.to(dtype)
        g = torch.randn(2, s, 768, device=device).to(dtype)
        counts = (fused_short_attention.launches, fused_short_attention.tc_launches,
                  fused_short_attention.tf32x3_launches,
                  attention_backward.launches, attention_backward.tc_launches)
        attention_forward(qkv, bias, 12)
        attention_backward(qkv, bias, g, 12)
        assert (fused_short_attention.launches - counts[0],
                fused_short_attention.tc_launches - counts[1],
                fused_short_attention.tf32x3_launches - counts[2],
                attention_backward.launches - counts[3],
                attention_backward.tc_launches - counts[4]) == (
                    1, on_tc, on_tf32, 1, on_tc)
    qkv, bias = _inputs(device, 2, 30, 12)
    before = fused_short_attention.launches, attention_backward.launches
    with pytest.raises(RuntimeError):
        _launch_fwd(qkv, bias, 12, 0.0, 0, None, route="tensor_core")
    with pytest.raises(RuntimeError):
        _launch_bwd(qkv, bias, torch.zeros(2, 30, 768, device=device), 12, 0.0,
                    0, None, route="tensor_core")
    assert (fused_short_attention.launches, attention_backward.launches) == before


# The 3xTF32 route's tiling: one row, one over a key tile, the flagship's
# 30, CLIP's 50 (vision), 64, CLIP's 77 (text), the limit, and one over it
# (the key-tiled route).
TF32_SEQS = [1, 9, 17, 30, 50, 64, 77, 80, 81]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("full", [False, True], ids=["key_bias", "full_bias"])
@pytest.mark.parametrize("s", TF32_SEQS)
def test_tf32x3_route_matches_reference(device, s, full, rate):
    """fp32 K1 on the 3xTF32 route (S <= 80; 81 on the key-tiled route)
    against its twin at fp32's bar, given the kernels' Philox mask, counted
    on its route, and within four times the twin's distance from float64
    (3xTF32 leaves out 2^-22 of each product, fp32 rounds at 2^-24), plus
    2^-21 of the output's size."""
    b, nh = 3, 12
    qkv, key_bias = _inputs(device, b, s, nh, seed=s)
    bias = _full_bias(device, key_bias, nh) if full else key_bias
    seed = 1357
    keep = dropout_keep_mask(seed, b, nh, s, rate, device) if rate else None
    before = (fused_short_attention.launches, fused_short_attention.tf32x3_launches,
              fused_short_attention.tf32x3_tiled_launches)
    out = attention_forward(qkv, bias, nh, dropout_rate=rate, seed=seed)
    torch.cuda.synchronize()
    on_route = int(s <= 80)
    assert attention_route(torch.float32, s, "forward") == (
        "tf32x3" if on_route else "tf32x3_tiled")
    assert (fused_short_attention.launches - before[0],
            fused_short_attention.tf32x3_launches - before[1],
            fused_short_attention.tf32x3_tiled_launches - before[2]) == (
                1, on_route, 1 - on_route)
    ref = attention_reference(qkv, bias, nh, rate, keep)
    torch.testing.assert_close(out, ref, **TOLS[torch.float32])
    exact = attention_float64(qkv, bias, torch.zeros_like(out), nh, rate, keep)[0]
    k_err, t_err = ((x.double() - exact).abs().max().item() for x in (out, ref))
    # Where the twin is exact (one key: p = 1), one product's split error.
    floor = 2.0 ** -21 * exact.abs().max().item()
    assert k_err <= 4.0 * t_err + floor, (k_err, t_err)


def test_tf32x3_route_refuses_what_it_does_not_take(device):
    """The 3xTF32 kernel refuses bf16, S > 80 and a qkv not 16-byte
    aligned: each launch raises and counts nothing."""
    qkv, bias = _inputs(device, 2, 81, 4)
    flat = torch.randn(2 * 30 * 768 + 1, device=device)
    shifted = flat[1:].view(2, 30, 768)  # contiguous, 4 bytes off 16
    before = fused_short_attention.launches, fused_short_attention.tf32x3_launches
    for x, b in ((qkv.bfloat16(), bias), (qkv, bias),
                 (shifted, bias[:, :30].contiguous())):
        with pytest.raises(RuntimeError, match="3xTF32 route"):
            _launch_fwd(x, b, 4, 0.0, 0, None, route="tf32x3")
    assert (fused_short_attention.launches,
            fused_short_attention.tf32x3_launches) == before


# The key-tiled 3xTF32 route: one over the route above (a second key tile
# of 17 keys), ViT-B/16's 197 (a last tile of 5), ViT-L/14's 257 (a last
# key tile of one key and a last query block of one row), ViT-L/14-336's
# 577, and the cap.
TILED_SEQS = [81, 197, 257, 577, 1024]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("full", [False, True], ids=["key_bias", "full_bias"])
@pytest.mark.parametrize("s", TILED_SEQS)
def test_tf32x3_tiled_route_matches_reference(device, s, full, rate):
    """fp32 K1 on the key-tiled 3xTF32 route (80 < S <= 1024) against its
    twin at fp32's bar, given the kernels' Philox mask, counted on its
    route, and within four times the twin's distance from float64 plus
    2^-21 of the output's size, item 0 all padding (every key at
    MASK_VALUE: a uniform softmax, in the online form too)."""
    b, nh = 3, 12
    qkv, key_bias = _inputs(device, b, s, nh, seed=s)
    key_bias[0] = MASK_VALUE
    bias = _full_bias(device, key_bias, nh) if full else key_bias
    seed = 2468
    keep = dropout_keep_mask(seed, b, nh, s, rate, device) if rate else None
    before = (fused_short_attention.launches, fused_short_attention.tf32x3_launches,
              fused_short_attention.tf32x3_tiled_launches)
    out = attention_forward(qkv, bias, nh, dropout_rate=rate, seed=seed)
    torch.cuda.synchronize()
    assert attention_route(torch.float32, s, "forward") == "tf32x3_tiled"
    assert (fused_short_attention.launches - before[0],
            fused_short_attention.tf32x3_launches - before[1],
            fused_short_attention.tf32x3_tiled_launches - before[2]) == (1, 0, 1)
    ref = attention_reference(qkv, bias, nh, rate, keep)
    torch.testing.assert_close(out, ref, **TOLS[torch.float32])
    exact = attention_float64(qkv, bias, torch.zeros_like(out), nh, rate, keep)[0]
    k_err, t_err = ((x.double() - exact).abs().max().item() for x in (out, ref))
    floor = 2.0 ** -21 * exact.abs().max().item()
    assert k_err <= 4.0 * t_err + floor, (k_err, t_err)


def test_tf32x3_tiled_route_refuses_what_it_does_not_take(device):
    """The key-tiled 3xTF32 kernel refuses bf16, S <= 80 (the 3xTF32
    route's), S > 1024 and a qkv not 16-byte aligned: each launch raises
    and counts nothing."""
    qkv, bias = _inputs(device, 2, 1025, 4)
    flat = torch.randn(2 * 130 * 768 + 1, device=device)
    shifted = flat[1:].view(2, 130, 768)  # contiguous, 4 bytes off 16
    short = qkv[:, :80].contiguous(), bias[:, :80].contiguous()
    mid = qkv[:, :130].contiguous(), bias[:, :130].contiguous()
    before = (fused_short_attention.launches,
              fused_short_attention.tf32x3_tiled_launches)
    for x, b in ((mid[0].bfloat16(), mid[1]), short, (qkv, bias),
                 (shifted, mid[1])):
        with pytest.raises(RuntimeError, match="key-tiled 3xTF32 route"):
            _launch_fwd(x, b, 4, 0.0, 0, None, route="tf32x3_tiled")
    assert (fused_short_attention.launches,
            fused_short_attention.tf32x3_tiled_launches) == before


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("full", [False, True], ids=["key_bias", "full_bias"])
@pytest.mark.parametrize("s", [30, 77, 197])
def test_float32_training_forward_takes_the_cuda_core_kernel(device, s, full, rate):
    """fp32 K1 in training (an input needs its gradient) launches the
    CUDA-core kernel, the one whose probabilities K2 regenerates: nothing
    counted on either 3xTF32 route, and its output that kernel's bit for
    bit under the same Philox draws."""
    b, nh, seed = 3, 12, 97
    qkv, key_bias = _inputs(device, b, s, nh, seed=s)
    bias = _full_bias(device, key_bias, nh) if full else key_bias
    before = (fused_short_attention.launches, fused_short_attention.tf32x3_launches,
              fused_short_attention.tf32x3_tiled_launches)
    out = fused_short_attention(qkv.requires_grad_(), bias, nh, dropout_rate=rate,
                                deterministic=False, seed=seed)
    torch.cuda.synchronize()
    assert (fused_short_attention.launches - before[0],
            fused_short_attention.tf32x3_launches - before[1],
            fused_short_attention.tf32x3_tiled_launches - before[2]) == (1, 0, 0)
    want = _launch_fwd(qkv.detach(), bias, nh, rate, seed, None, route="cuda_core")
    assert torch.equal(out.detach(), want)


@pytest.mark.parametrize("full", [False, True], ids=["key_bias", "full_bias"])
def test_cuda_core_route_in_bf16_matches_reference(device, full):
    """The CUDA-core kernels, launched for bf16 at S <= 64 (chip_smoke's
    timing of the old route), still match their twins there."""
    b, s, nh = 5, 33, 4
    qkv, key_bias = _inputs(device, b, s, nh)
    bias = _full_bias(device, key_bias, nh) if full else key_bias
    qkv = qkv.bfloat16()
    g = torch.randn(b, s, nh * 64, device=device).bfloat16()
    tc = fused_short_attention.tc_launches, attention_backward.tc_launches
    out = _launch_fwd(qkv, bias, nh, 0.1, 3, None, route="cuda_core")
    dqkv, dbias = _launch_bwd(qkv, bias, g, nh, 0.1, 3, None, route="cuda_core")
    torch.cuda.synchronize()
    assert (fused_short_attention.tc_launches, attention_backward.tc_launches) == tc
    keep = dropout_keep_mask(3, b, nh, s, 0.1, device)
    dref, dbias_ref = attention_backward_reference(qkv, bias, g, nh, 0.1, keep)
    torch.testing.assert_close(
        out.float(), attention_reference(qkv, bias, nh, 0.1, keep).float(),
        **TOLS[torch.bfloat16])
    torch.testing.assert_close(dqkv.float(), dref.float(), **TOLS[torch.bfloat16])
    if full:
        torch.testing.assert_close(dbias, dbias_ref, **TOLS[torch.float32])


# Past 256 tokens every route streams: bf16 K1 the key-tiled tensor-core
# kernel, fp32 K1 in training the key-tiled 3xTF32 one, K2 its key-tiled
# pair.  ViT-L/14's 257 (a last key tile of one key, a last row block of
# one row), 300, BERT's 512 and the cap.
LONG_SEQS = [257, 300, 512, 1024]


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["rate0", "rate0.1"])
@pytest.mark.parametrize("full", [False, True], ids=["key_bias", "full_bias"])
@DTYPES
@pytest.mark.parametrize("s", LONG_SEQS)
def test_key_tiled_training_routes_match_reference(device, s, dtype, full, rate):
    """Training past 256 tokens through the autograd Function: K1 and K2
    counted on their key-tiled routes, the output, dqkv and (a full bias)
    dbias against the twins given the kernels' Philox mask (dbias at fp32's
    bar), and against the float64 evaluation of the same function: bf16
    within twice the twins' distance, fp32 within four times plus 2^-21 of
    each output's size.  Item 0 all padding: every key at MASK_VALUE."""
    b, nh, seed = 2, 4, 8642
    qkv, key_bias = _inputs(device, b, s, nh, seed=s)
    key_bias[0] = MASK_VALUE
    bias = _full_bias(device, key_bias, nh) if full else key_bias
    qkv = qkv.to(dtype)
    g = torch.randn(b, s, nh * 64, device=device,
                    generator=torch.Generator(device=device).manual_seed(2)
                    ).to(dtype)
    keep = dropout_keep_mask(seed, b, nh, s, rate, device) if rate else None
    k1_route = "tensor_core_tiled" if dtype == torch.bfloat16 else "tf32x3_tiled"
    assert attention_route(dtype, s, "forward", training=True) == k1_route
    assert attention_route(dtype, s, "backward") == "tiled"
    counter = "tc_tiled_launches" if dtype == torch.bfloat16 else \
        "tf32x3_tiled_launches"
    before = (fused_short_attention.launches,
              getattr(fused_short_attention, counter),
              attention_backward.launches, attention_backward.tiled_launches)
    x, y = qkv.clone().requires_grad_(), bias.clone().requires_grad_(full)
    out = fused_short_attention(x, y, nh, dropout_rate=rate,
                                deterministic=rate == 0.0, seed=seed)
    out.backward(g)
    torch.cuda.synchronize()
    assert (fused_short_attention.launches - before[0],
            getattr(fused_short_attention, counter) - before[1],
            attention_backward.launches - before[2],
            attention_backward.tiled_launches - before[3]) == (1, 1, 1, 1)
    ref = attention_reference(qkv, bias, nh, rate, keep)
    dref, dbias_ref = attention_backward_reference(qkv, bias, g, nh, rate, keep)
    got = (out.detach(), x.grad, y.grad if full else None)
    torch.testing.assert_close(got[0].float(), ref.float(), **TOLS[dtype])
    torch.testing.assert_close(got[1].float(), dref.float(), **TOLS[dtype])
    if full:
        torch.testing.assert_close(got[2], dbias_ref, **TOLS[torch.float32])
    exact = attention_float64(qkv, bias, g, nh, rate, keep)
    for k, t, e in zip(got, (ref, dref, dbias_ref), exact):
        if e is None:
            continue
        k_err = (k.double() - e).abs().max().item()
        t_err = (t.double() - e).abs().max().item()
        if dtype == torch.bfloat16:
            assert k_err <= 2.0 * t_err, (k_err, t_err)
        else:
            assert k_err <= 4.0 * t_err + 2.0 ** -21 * e.abs().max().item(), (
                k_err, t_err)


def test_key_tiled_routes_refuse_what_they_do_not_take(device):
    """The key-tiled tensor-core K1 refuses fp32, S > 1024 and a qkv not
    16-byte aligned; the key-tiled K2 refuses S > 1024 and a qkv not
    16-byte aligned: each launch raises and counts nothing.  The wrappers
    raise at 1025 before any launch."""
    qkv, bias = _inputs(device, 2, 1025, 4)
    g = torch.zeros(2, 1025, 256, device=device)
    flat = torch.randn(2 * 300 * 768 + 2, device=device).bfloat16()
    shifted = flat[2:].view(2, 300, 768)  # contiguous, 4 bytes off 16
    mid = qkv[:, :300].contiguous(), bias[:, :300].contiguous()
    before = (fused_short_attention.launches, fused_short_attention.tc_tiled_launches,
              attention_backward.launches, attention_backward.tiled_launches)
    for x, b in ((mid[0], mid[1]), (qkv.bfloat16(), bias), (shifted, mid[1])):
        with pytest.raises(RuntimeError, match="key-tiled tensor-core route"):
            _launch_fwd(x, b, 4, 0.0, 0, None, route="tensor_core_tiled")
    for x, b, y in ((qkv.bfloat16(), bias, g.bfloat16()),
                    (shifted, mid[1], g[:, :300].bfloat16().contiguous())):
        with pytest.raises(RuntimeError, match="key-tiled route"):
            _launch_bwd(x, b, y, 4, 0.0, 0, None, route="tiled")
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="1024"):
            fused_short_attention(qkv.to(dtype), bias, 4)
        with pytest.raises(ValueError, match="1024"):
            attention_backward(qkv.to(dtype), bias, g, 4)
    assert (fused_short_attention.launches, fused_short_attention.tc_tiled_launches,
            attention_backward.launches, attention_backward.tiled_launches) == before


def test_full_bias_autograd_function_launches_k2_with_dbias(device):
    """A full bias that requires grad gets K2's dbias through the autograd
    Function, equal to autograd through the plain version."""
    qkv, key_bias = _inputs(device, 16, 30, 12)
    bias = _full_bias(device, key_bias, 12)
    x, y = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    k1, k2 = fused_short_attention.launches, attention_backward.launches
    out = fused_short_attention(x, y, 12, dropout_rate=0.1, deterministic=False,
                                seed=9)
    w = torch.randn_like(out)
    (out * w).sum().backward()
    assert (fused_short_attention.launches, attention_backward.launches) == \
        (k1 + 1, k2 + 1)
    x2, y2 = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    keep = dropout_keep_mask(9, 16, 12, 30, 0.1, device)
    (attention_reference(x2, y2, 12, 0.1, keep) * w).sum().backward()
    torch.testing.assert_close(x.grad, x2.grad, **TOLS[torch.float32])
    torch.testing.assert_close(y.grad, y2.grad, **TOLS[torch.float32])


def test_full_bias_wrapper_rejects_what_the_kernels_do_not_take(device):
    qkv, key_bias = _inputs(device, 4, 30, 12)
    bias = _full_bias(device, key_bias, 12)
    before = fused_short_attention.launches, attention_backward.launches
    with pytest.raises(ValueError):  # a broadcast view, not contiguous
        fused_short_attention(qkv, bias[:1].expand(4, -1, -1, -1), 12)
    with pytest.raises(ValueError):
        fused_short_attention(qkv, bias[:, :, :, :29], 12)
    with pytest.raises(TypeError):
        fused_short_attention(qkv, bias.double(), 12)
    assert (fused_short_attention.launches, attention_backward.launches) == before


def test_mpnet_training_fused_matches_plain_on_card(device):
    """A 2-layer MPNetModel in training mode (dropout 0, fp32): outputs and
    every parameter's gradient, the relative bias table's included,
    through K1/K2 with the full bias and through the plain attention."""
    ids = torch.randint(2, 500, (8, 30), device=device)
    mask = (torch.arange(30, device=device)[None, :]
            < torch.randint(2, 31, (8, 1), device=device)).long()
    runs = []
    for flag in ("true", "false"):
        model = MPNetModel(vocab_size=500, hidden_size=128, num_hidden_layers=2,
                           num_heads=2, intermediate_size=512, dropout_rate=0.0,
                           fused_attention=flag)
        init_weights(model, torch.Generator().manual_seed(0))
        model = model.train().to(device)
        k1, k2 = fused_short_attention.launches, attention_backward.launches
        seq, pooled = model(ids * mask + (1 - mask), mask)
        (seq.square().sum() + pooled.sum()).backward()
        launched = (fused_short_attention.launches - k1,
                    attention_backward.launches - k2)
        assert launched == ((2, 2) if flag == "true" else (0, 0))
        runs.append((seq, {n: p.grad for n, p in model.named_parameters()}))
    (a, ga), (b, gb) = runs
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert ga["relative_attention_bias.weight"].abs().max() > 0
    for name in ga:
        torch.testing.assert_close(ga[name], gb[name], rtol=1e-4, atol=1e-4,
                                   msg=name)


def test_dropout_mask_matches_cpu_twin_and_rate(device):
    """The kernels' Philox mask equals numpy's twin bit for bit; its keep
    fraction over 1.38 M draws lies within 0.002 of 0.9; another seed
    draws another mask."""
    keep = dropout_keep_mask(99, 128, 12, 30, 0.1, device)
    assert keep.dtype == torch.bool and keep.shape == (128, 12, 30, 30)
    assert torch.equal(keep.cpu(), philox_keep_mask(99, 128, 12, 30, 0.1))
    assert abs(keep.float().mean().item() - 0.9) < 0.002
    assert torch.equal(keep, dropout_keep_mask(99, 128, 12, 30, 0.1, device))
    assert not torch.equal(keep, dropout_keep_mask(100, 128, 12, 30, 0.1, device))


def test_autograd_function_launches_k2(device):
    """The repaired fault: a CUDA tensor that requires grad gets its
    gradient from K2, equal to autograd through the plain version."""
    qkv, bias = _inputs(device, 16, 30, 12)
    x = qkv.clone().requires_grad_()
    k1, k2 = fused_short_attention.launches, attention_backward.launches
    out = fused_short_attention(x, bias, 12, dropout_rate=0.1,
                                deterministic=False, seed=7)
    assert out.grad_fn is not None
    w = torch.randn_like(out)
    (out * w).sum().backward()
    assert (fused_short_attention.launches, attention_backward.launches) == \
        (k1 + 1, k2 + 1)
    y = qkv.clone().requires_grad_()
    keep = dropout_keep_mask(7, 16, 12, 30, 0.1, device)
    (attention_reference(y, bias, 12, 0.1, keep) * w).sum().backward()
    torch.testing.assert_close(x.grad, y.grad, **TOLS[torch.float32])


def test_bert_training_step_fused_matches_plain_on_card(device):
    """A 2-layer BertModel in training mode (dropout 0, fp32): pooled
    output and every parameter's gradient through K1/K2 and through the
    plain attention agree."""
    ids = torch.randint(103, 500, (8, 30), device=device)
    mask = (torch.arange(30, device=device)[None, :]
            < torch.randint(2, 31, (8, 1), device=device)).long()
    runs = []
    for flag in ("true", "false"):
        model = BertModel(vocab_size=500, hidden_size=128, num_hidden_layers=2,
                          num_heads=2, intermediate_size=512, dropout_rate=0.0,
                          fused_attention=flag)
        init_weights(model, torch.Generator().manual_seed(0))
        model = model.train().to(device)
        _, pooled = model(ids * mask, mask)
        pooled.square().sum().backward()
        runs.append((pooled, {n: p.grad for n, p in model.named_parameters()}))
    (a, ga), (b, gb) = runs
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for name in ga:
        torch.testing.assert_close(ga[name], gb[name], rtol=1e-4, atol=1e-4,
                                   msg=name)


K3_SHAPES = [(2, 7, 8, 3), (3, 5, 5, 3), (1, 224, 224, 3), (4, 1, 1, 3)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["to-fp32", "to-bf16"])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32],
                         ids=["u8", "fp32"])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_k3_matches_reference_bit_for_bit(device, in_dtype, out_dtype, shape):
    """Ragged sizes (not a multiple of four pixels) take the scalar tail;
    a batch that starts one image into a larger tensor may be misaligned
    for the vector loads and takes the scalar loop."""
    g = torch.Generator(device=device).manual_seed(0)
    big = (shape[0] + 1,) + shape[1:]
    if in_dtype == torch.uint8:
        full = torch.randint(0, 256, big, dtype=torch.uint8, device=device,
                             generator=g)
    else:
        full = torch.rand(big, device=device, generator=g) * 255.0
    for x in (full[:-1], full[1:]):
        before = normalize_u8.launches
        out = normalize_u8(x, out_dtype)
        torch.cuda.synchronize()
        assert normalize_u8.launches == before + 1
        ref = normalize_reference(x, out_dtype)
        assert out.dtype == out_dtype and out.shape == x.shape
        assert out.is_contiguous()
        assert torch.equal(out, ref)


def test_k3_output_is_channels_last_for_the_stem(device):
    x = torch.randint(0, 256, (2, 16, 16, 3), dtype=torch.uint8, device=device)
    assert normalize_u8(x).permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)


def test_k3_rejects_what_it_does_not_take(device):
    x = torch.randint(0, 256, (2, 4, 4, 3), dtype=torch.uint8, device=device)
    before = normalize_u8.launches
    with pytest.raises(ValueError):
        normalize_u8(torch.zeros(2, 4, 4, 4, dtype=torch.uint8, device=device))
    with pytest.raises(TypeError):
        normalize_u8(x.half())
    with pytest.raises(TypeError):
        normalize_u8(x, torch.float16)
    with pytest.raises(ValueError):
        normalize_u8(x[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        normalize_u8(x[:0])  # empty
    assert normalize_u8.launches == before


def test_device_preprocess_launches_k3_once(device):
    """With draws, one launch of K3's fused pass and none of the standalone
    K3, whether the jitter is on or off; without draws, the standalone K3
    once.  Each against the CPU's plain composition."""
    x = torch.randint(0, 256, (8, 32, 32, 3), dtype=torch.uint8, device=device)
    draws = AugDraws.sample(StepRNG(0, 0, device), 8)
    cpu_draws = AugDraws(*(getattr(draws, f).cpu() for f in (
        "flip", "apply", "brightness", "contrast", "saturation", "hue")))
    for use_draws, jitter in ((True, False), (True, True), (False, True)):
        before = normalize_u8.launches, augment_normalize_u8.launches
        out = device_preprocess(x, draws if use_draws else None, flip=True,
                                color_jitter=jitter)
        torch.cuda.synchronize()
        assert (normalize_u8.launches - before[0],
                augment_normalize_u8.launches - before[1]) == (
                    (0, 1) if use_draws else (1, 0))
        assert out.dtype == torch.float32 and out.shape == x.shape
        cpu = device_preprocess(x.cpu(), cpu_draws if use_draws else None,
                                flip=True, color_jitter=jitter)
        torch.testing.assert_close(out.cpu(), cpu, rtol=0, atol=1e-4)


def _twin_means(x, draws, flip):
    """The plain composition's contrast means (random_color_jitter's)."""
    if flip:
        x = random_flip(x, draws.flip)
    return (x.float() * draws.brightness.view(-1, 1, 1, 1)).mean(dim=(1, 2, 3))


# Odd sizes (images off a 16-byte boundary, a short last block), the
# flagship crop, one pixel an image, rows too wide to stage in shared
# memory.
FUSED_SHAPES = [(3, 7, 9, 3), (5, 33, 17, 3), (2, 224, 224, 3), (4, 1, 1, 3),
                (1, 3, 75001, 3)]


@pytest.mark.parametrize("flip,jitter", [(True, True), (True, False),
                                         (False, True), (False, False)])
@pytest.mark.parametrize("shape", FUSED_SHAPES)
def test_fused_pass_matches_plain_composition(device, shape, flip, jitter):
    """K3's fused pass against the plain composition on the card, given the
    same draws (apply taking both values): within 1e-4 on the normalized
    output with its own contrast means, within 1e-5 given the twin's."""
    g = torch.Generator(device=device).manual_seed(sum(shape))
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                      generator=g)
    draws = AugDraws.sample(StepRNG(1, 2, device), shape[0])
    draws.flip = torch.arange(shape[0], device=device) % 2 == 0
    draws.apply = torch.arange(shape[0], device=device) % 3 != 1
    got = augment_normalize_u8(x, draws, flip, jitter)
    want = augment_reference(x, draws, flip, jitter)
    assert got.dtype == torch.float32 and got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    means = _twin_means(x, draws, flip)
    got = augment_normalize_u8(x, draws, flip, jitter, means)
    want = augment_reference(x, draws, flip, jitter, means)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_fused_pass_output_is_channels_last_for_the_stem(device):
    x = torch.randint(0, 256, (2, 16, 16, 3), dtype=torch.uint8, device=device)
    draws = AugDraws.sample(StepRNG(0, 0, device), 2)
    out = augment_normalize_u8(x, draws)
    assert out.is_contiguous() and out.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)


def test_fused_pass_rejects_what_it_does_not_take(device):
    x = torch.randint(0, 256, (2, 4, 4, 3), dtype=torch.uint8, device=device)
    draws = AugDraws.sample(StepRNG(0, 0, device), 2)
    before = augment_normalize_u8.launches
    with pytest.raises(ValueError):
        augment_normalize_u8(x[:, ::2], draws)  # not contiguous
    with pytest.raises(ValueError):
        augment_normalize_u8(x[:0], draws)  # empty
    with pytest.raises(TypeError):
        augment_normalize_u8(x.float(), draws)
    with pytest.raises(ValueError):
        augment_normalize_u8(torch.cat([x, x]), draws)  # batch of 4, draws of 2
    cpu_draws = AugDraws(*(getattr(draws, f).cpu() for f in (
        "flip", "apply", "brightness", "contrast", "saturation", "hue")))
    with pytest.raises(ValueError):
        augment_normalize_u8(x, cpu_draws)  # draws on another device
    assert augment_normalize_u8.launches == before


def test_fused_pass_makes_no_host_sync(device):
    """The draws are read on the card: no .item(), .cpu() or pageable copy
    (torch raises on any synchronizing call in this mode)."""
    x = torch.randint(0, 256, (4, 24, 24, 3), dtype=torch.uint8, device=device)
    draws = AugDraws.sample(StepRNG(0, 0, device), 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = device_preprocess(x, draws, flip=True, color_jitter=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()


def test_device_cache_batches_are_a_function_of_seed_and_step(device):
    rng = np.random.default_rng(0)
    n, cache, crop = 40, 48, 32
    tiles = torch.randint(0, 256, (n, cache, cache, 3), dtype=torch.uint8,
                          device=device)
    lengths = rng.integers(2, 9, (n, 3))
    mask = (np.arange(10) < lengths[..., None]).astype(np.int32)
    ids = rng.integers(1, 100, (n, 3, 10)).astype(np.int32) * mask
    corpus = DecodedCorpus(tiles, list(ids), list(mask),
                           np.full(n, 3, np.int32), np.arange(n))
    dc = DeviceDataCache(corpus, batch_size=16, cache_size=cache,
                         crop_size=crop, seq_buckets=[12, 20], seed=1,
                         device=device)
    a, b, c = dc.batch_at(5), dc.batch_at(5), dc.batch_at(6)
    assert a["image"].device.type == "cuda" and a["image"].dtype == torch.uint8
    assert a["image"].shape == (16, crop, crop, 3)
    assert a["input_ids"].shape == (16, 10)  # bucket 12, cut to the 10 tokens
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["image"], c["image"])
    # Each crop is a window of its tile.
    for j in range(16):
        tile = tiles[a["image_id"][j]]
        assert any(torch.equal(a["image"][j], tile[y:y + crop, x:x + crop])
                   for y in range(cache - crop + 1)
                   for x in range(cache - crop + 1))


class _Items:
    """Twelve float32 images and ids, numbered."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        return {"image": np.full((8, 8, 3), i, np.float32),
                "image_id": np.int64(i)}

    def collate_fn(self, items):
        return {k: np.stack([d[k] for d in items]) for k in items[0]}


def test_loader_batches_are_pinned_and_reach_the_card(device):
    """Each batch in its own pinned buffers, copied without blocking."""
    from clip_lite_torch.data.pipeline import DataLoader, infinite_batches
    from clip_lite_torch.engine import _to_device

    loader = DataLoader(_Items(), 4, shuffle=False, pin_memory=True)
    stream = infinite_batches(loader)
    batches = [next(stream) for _ in range(5)]
    stream.close()
    assert all(t.is_pinned() for b in batches for t in b.values())
    assert batches[0]["image"].data_ptr() != batches[1]["image"].data_ptr()
    on_card = [_to_device(b, device) for b in batches]
    torch.cuda.synchronize()
    for b, c in zip(batches, on_card):
        assert c["image"].device.type == "cuda"
        assert torch.equal(c["image"].cpu(), b["image"])
    assert on_card[3]["image_id"].tolist() == [0, 1, 2, 3]  # the second epoch


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "configs", "fs_bs1024_ni250k.yaml")
# The flagship cut to a tiny size, as the CPU tests cut it (AMP on).
TINY = ["MODEL.VISUAL.NETWORK_NAME", "resnet18", "MODEL.VISUAL.FEATURE_SIZE",
        512, "MODEL.VISUAL.WIDTH", 8, "DATA.IMAGE_CROP_SIZE", 32,
        "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 2, "MODEL.TEXTUAL.HIDDEN_SIZE", 128,
        "DATA.MAX_CAPTION_LENGTH", 8, "MODEL.TEXTUAL.VOCAB_SIZE", 128,
        "OPTIM.WARMUP_STEPS", 2]


def _tiny_run(device, steps):
    cfg = Config(FLAGSHIP, TINY)
    state = create_train_state(cfg, device=device)
    rng = np.random.default_rng(0)
    batch = {"image": rng.standard_normal((8, 32, 32, 3), dtype=np.float32),
             "input_ids": rng.integers(1, 128, (8, 8)).astype(np.int32),
             "attention_mask": np.ones((8, 8), np.int32)}
    step = make_train_step(cfg)
    for _ in range(steps):
        state, _ = step(state, batch)
    return state, lambda st: step(st, batch)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_async_save_during_the_next_step_equals_a_sync_save(
        device, tmp_path, monkeypatch):
    """The worker's copy to the host is held until the next step has run
    (its in-place updates included): the file still holds the state as it
    was when ``step()`` returned."""
    state, step = _tiny_run(device, 2)
    sync = CheckpointManager(str(tmp_path / "sync"), async_writes=False,
                             state=state).step(2)
    release = threading.Event()
    real_to_host = ckpt_mod._Staging.to_host

    def gated(self):
        assert release.wait(timeout=60)
        return real_to_host(self)

    monkeypatch.setattr(ckpt_mod._Staging, "to_host", gated)
    manager = CheckpointManager(str(tmp_path / "async"), state=state)
    assert manager.async_writes
    path = manager.step(2)
    state, _ = step(state)
    torch.cuda.synchronize()
    assert manager.in_flight
    release.set()
    manager.wait()
    assert _read(path) == _read(sync)
    after = CheckpointManager(str(tmp_path / "after"), async_writes=False,
                              state=state).step(2)
    assert _read(after) != _read(sync)  # the next step did move the state


def test_checkpoint_from_channels_last_cuda_loads_in_a_cpu_process(
        device, tmp_path):
    state, _ = _tiny_run(device, 3)
    assert any(p.ndim == 4 and not p.is_contiguous()
               and p.is_contiguous(memory_format=torch.channels_last)
               for p in state.model.parameters())
    path = CheckpointManager(str(tmp_path), state=state).step(3)
    want = str(tmp_path / "want.pt")
    torch.save({"model": {k: v.cpu() for k, v in
                          state.model.state_dict().items()},
                "trace": {k: v.cpu() for k, v in
                          state.optimizer._by_name("trace").items()},
                "slow": {k: v.cpu() for k, v in
                         state.optimizer.slow_state().items()}}, want)
    script = f"""
import torch
from clip_lite_torch.config import Config
from clip_lite_torch.engine import create_train_state
from clip_lite_torch.utils.checkpointing import CheckpointManager
assert not torch.cuda.is_available()
state = create_train_state(Config({FLAGSHIP!r}, {json.dumps(TINY)}),
                           device="cpu")
assert CheckpointManager({str(tmp_path / "cpu")!r}, state=state).load(
    {path!r}) == 3
want = torch.load({want!r})
got = {{"model": state.model.state_dict(),
        "trace": state.optimizer._by_name("trace"),
        "slow": state.optimizer.slow_state()}}
for part in want:
    assert set(got[part]) == set(want[part]), part
    for k, v in want[part].items():
        assert torch.equal(got[part][k], v), (part, k)
assert (state.step, state.optimizer.count, state.optimizer.la_count) == \
    (3, 3, 3)
print("loaded on the CPU")
"""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert "loaded on the CPU" in out.stdout


# ---------------------------------------------------------------------------
# The native JPEG batch path: crop_resize_flip_u8, nvJPEG, the loader
# ---------------------------------------------------------------------------

def _photo(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f, p = rng.uniform(0.005, 0.08, 6), rng.uniform(0, 6, 3)
    img = np.stack([np.sin(xx * f[c] + p[c]) * np.cos(yy * f[3 + c])
                    for c in range(3)], axis=-1)
    return np.clip((img + 1) * 127.5 + rng.normal(0, 4, img.shape),
                   0, 255).astype(np.uint8)


def _jpeg(image, **kw) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _crop_boxes(n, seed):
    from clip_lite_torch.data import native

    boxes = native.random_resized_crop_boxes(np.random.default_rng(seed), n)
    boxes[0::5] = -1.0                       # the whole image
    boxes[1::5] = (0.999, 0.0, 1.0, 0.001)   # 1 x 1 at a corner
    boxes[2::5] = (0.6, 0.7, 1.0, 1.0)       # against two borders
    return boxes


# Sizes at full scale and at the emulated tests' (test_torch_native.py):
# COCO's 375 x 500 (1,500-byte rows), odd widths and heights (rows and
# images at odd bytes), 640 x 640 (d = 2 for a whole image at 224), sources
# smaller than the tile (up-sampling) and over twice it (down-sampling).
CROP_SHAPES = [(1, 1), (5, 9), (64, 80), (120, 90), (375, 500), (333, 499),
               (640, 640), (427, 640), (480, 640), (17, 3), (1281, 961)]


@pytest.mark.parametrize("n,size", [(1, 1), (7, 17), (128, 224), (16, 256),
                                    (600, 3),
                                    (1024, 224),  # two launches of 800, 224
                                    (256, 256),  # a chunk of the cache
                                    (1601, 3)])  # three launches
def test_crop_resize_flip_matches_twin_bit_for_bit(device, n, size):
    """The kernel against its twin bit for bit on seeded images of
    CROP_SHAPES (every 11th a failed decode) under train, whole, 1 x 1 and
    border boxes; flips off, alternate and with blocks of 1, 2, 4 and 8 in
    turn (ragged at the far edges); the arena at an odd address and the
    tiles at an odd offset in a larger tensor, whose other bytes stay."""
    from clip_lite_torch.data import native

    sizes = np.array([(0, 0) if i % 11 == 10 else
                      CROP_SHAPES[i % len(CROP_SHAPES)] for i in range(n)],
                     np.int32)
    offsets, nbytes = native.arena_offsets(sizes)
    g = torch.Generator(device=device).manual_seed(n * size)
    arena = torch.randint(0, 256, (nbytes + 1,), dtype=torch.uint8,
                          device=device, generator=g)[1:]
    boxes = _crop_boxes(n, n)
    blocks = np.array([1, 2, 4, 8], np.int32)[np.arange(n) % 4]
    for flips, denoms in ((np.zeros(n, np.uint8), None),
                          ((np.arange(n) % 2).astype(np.uint8), blocks),
                          ((np.arange(n) % 2).astype(np.uint8), None)):
        before = native.crop_resize_flip_u8.launches
        got = native.crop_resize_flip_u8(arena, offsets, sizes, boxes, flips,
                                         size, denoms=denoms)
        want = native.crop_resize_flip_reference(arena, offsets, sizes, boxes,
                                                 flips, size, denoms)
        torch.cuda.synchronize()
        assert native.crop_resize_flip_u8.launches == before + -(-n // 800)
        assert got.shape == (n, size, size, 3) and torch.equal(got, want)
    out = torch.full((2 * n * size * size * 3 + 1,), 7, dtype=torch.uint8,
                     device=device)
    tiles = out[1 + n * size * size * 3:].view(n, size, size, 3)
    native.crop_resize_flip_u8(arena, offsets, sizes, boxes, flips, size,
                               out=tiles)
    assert torch.equal(tiles, want)
    assert (out[:1 + n * size * size * 3] == 7).all()


def test_crop_resize_flip_refuses_what_it_does_not_take(device):
    """A denom other than 1, 2, 4 or 8, an image past the arena's end and a
    tile over the kernel's largest raise before a launch."""
    from clip_lite_torch.data import native

    sizes = np.array([(4, 5), (6, 7)], np.int32)
    offsets, nbytes = native.arena_offsets(sizes)
    arena = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    boxes, flips = native.full_image_boxes(2), np.zeros(2, np.uint8)
    before = native.crop_resize_flip_u8.launches
    with pytest.raises(ValueError, match="denom"):
        native.crop_resize_flip_u8(arena, offsets, sizes, boxes, flips, 8,
                                   denoms=np.array([1, 3], np.int32))
    with pytest.raises(ValueError, match="arena"):
        native.crop_resize_flip_u8(arena[:-1], offsets, sizes, boxes, flips, 8)
    with pytest.raises(ValueError, match="pixels a side"):
        native.crop_resize_flip_u8(arena, offsets, sizes, boxes, flips,
                                   native._library().crop_max_size() + 1)
    assert native.crop_resize_flip_u8.launches == before


def test_nvjpeg_tiles_within_the_decode_bars(device):
    """nvJPEG + the kernel against the twin at nvJPEG's full resolution,
    averaged over blocks of the JAX core's scale where it takes one (the
    256 x 192 source's whole image at 64):
    mean |d| <= 1 level and PSNR >= 40 dB per tile, per JPEG kind; CMYK,
    bytes that are no JPEG and a JPEG cut inside a header fail, as in the
    JAX core, and leave the batch's other tiles whole."""
    import io

    from PIL import Image

    from clip_lite_torch.data import native

    kinds = {
        "420": [_jpeg(_photo(96, 128, s), quality=90) for s in range(3)],
        "422": [_jpeg(_photo(128, 96, s), quality=90, subsampling=1)
                for s in range(3)],
        "444": [_jpeg(_photo(96, 96, s), quality=90, subsampling=0)
                for s in range(3)],
        "progressive": [_jpeg(_photo(96, 128, s), quality=90,
                              progressive=True) for s in range(3)],
        "greyscale": [_jpeg(_photo(96, 128, s)[..., 0], quality=90)
                      for s in range(3)],
        "scaled": [_jpeg(_photo(192, 256, s), quality=90) for s in range(3)],
    }
    buf = io.BytesIO()
    Image.fromarray(_photo(40, 48, 0)).convert("CMYK").save(buf, "JPEG")
    cut = _jpeg(_photo(40, 48, 1), quality=90)
    # CMYK and no JPEG fail at the header; the one cut inside its scan
    # header fails the batch's decode, and alone.
    failing = [buf.getvalue(), b"\xff\xd8" + bytes(64),
               cut[:cut.index(b"\xff\xda") + 5]]
    for kind, jpegs in kinds.items():
        n = len(jpegs)
        boxes, flips = _crop_boxes(n, 5), (np.arange(n) % 2).astype(np.uint8)
        before = native.nvjpeg_decode.launches
        tiles, failures = native.decode_crop_batch(jpegs + failing, 64,
                                                   np.concatenate(
                                                       [boxes, boxes[:3]]),
                                                   np.concatenate(
                                                       [flips, flips[:3]]))
        assert native.nvjpeg_decode.launches == before + 1
        assert failures == 3 and not tiles[n:].any()
        images = [native.decode_rgb(j, b, 64, scaled=False)
                  for j, b in zip(jpegs, boxes)]
        arena, offsets, sizes = native.pack_arena(images)
        denoms = native.scale_denoms(boxes, sizes, 64)
        assert (denoms[0] > 1) == (kind == "scaled")  # boxes[0]: whole
        twin = native.crop_resize_flip_reference(arena, offsets, sizes, boxes,
                                                 flips, 64, denoms)
        d = (tiles[:n].double().cpu() - twin.double()).flatten(1)
        mse = (d ** 2).mean(1)
        psnr = 10 * torch.log10(255.0 ** 2 / mse.clamp_min(1e-12))
        assert d.abs().mean(1).max() <= 1.0 and psnr.min() >= 40.0, kind


def _jpeg_corpus(root, n_train=48, n_val=8):
    from clip_lite_torch.data.readers import ClRecWriter

    rng = np.random.default_rng(0)
    words = "a the man dog cat bus red blue small two on in with".split()
    for split, n in (("train", n_train), ("val", n_val)):
        path = os.path.join(str(root), f"coco_{split}_train_sbert2017.clrec")
        with ClRecWriter(path) as w:
            for i in range(n):
                w.append({"image_id": i, "image": _jpeg(
                    _photo(96 + 8 * (i % 3), 128, i), quality=90),
                    "captions": [" ".join(rng.choice(words, 5))
                                 for _ in range(3)]})
    return str(root)


def test_background_native_loader_losses_equal_foreground(device, tmp_path):
    """The native batches decoded on the producer's own stream, handed to
    the step's stream through an event: the first 5 losses equal those of
    the same run with the decode in the consumer's thread, bit for bit
    (deterministic algorithms), so no step reads a tile before its decode
    has finished or after its memory went to another decode."""
    from clip_lite_torch.data import native
    from clip_lite_torch.data.pipeline import DataLoader, infinite_batches
    from clip_lite_torch.factories import PretrainingDatasetFactory

    root = _jpeg_corpus(tmp_path)
    cfg = Config(FLAGSHIP, TINY + [
        "MODEL.NAME", "captions", "DATA.ROOT", root,
        "DATA.NATIVE_PIPELINE", True])
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    losses = {}
    try:
        for background in (False, True):
            ds = PretrainingDatasetFactory.from_config(cfg, "train",
                                                       device=device)
            loader = DataLoader(ds, 8, shuffle=True, seed=3, prefetch=3,
                                background=background, pin_memory=True)
            state = create_train_state(cfg, device=device)
            step = make_train_step(cfg)
            stream = infinite_batches(loader)
            before = native.crop_resize_flip_u8.launches
            run = []
            for _ in range(5):
                batch = next(stream)
                assert batch["image"].is_cuda and \
                    batch["image"].dtype == torch.uint8
                state, metrics = step(state, batch)
                run.append(metrics["total_loss"].item())
            stream.close()
            assert native.crop_resize_flip_u8.launches >= before + 5
            losses[background] = run
    finally:
        torch.use_deterministic_algorithms(flags[0], warn_only=flags[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            flags[2:]
    assert all(np.isfinite(losses[True]))
    assert losses[True] == losses[False]


# -- the step trace and the SSL terms on the card ------------------------------

SSL_SMALL = ["MODEL.VISUAL.NETWORK_NAME", "resnet18", "MODEL.VISUAL.WIDTH", 16,
             "DATA.IMAGE_CROP_SIZE", 64, "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 2,
             "MODEL.TEXTUAL.DROPOUT", 0.0, "MODEL.LOSS.TYPE", "concat",
             "MODEL.VISUAL.SELF_SUPERVISED", True,
             "MODEL.TEXTUAL.SELF_SUPERVISED", True]


def _ssl_batch(device, b=16, crop=64, s=30):
    g = torch.Generator(device=device).manual_seed(3)

    def caption():
        ids = torch.randint(103, 30000, (b, s), device=device, generator=g)
        lengths = torch.randint(4, s + 1, (b, 1), device=device, generator=g)
        mask = (torch.arange(s, device=device)[None, :] < lengths).int()
        return (ids * mask).int(), mask

    image = torch.randint(0, 256, (2, b, crop, crop, 3), device=device,
                          generator=g, dtype=torch.uint8)
    (ids, mask), (aug_ids, aug_mask) = caption(), caption()
    return {"image": image[0], "aug_image": image[1], "input_ids": ids,
            "attention_mask": mask, "aug_input_ids": aug_ids,
            "aug_attention_mask": aug_mask}


def _counters():
    return {"K1 attention_fwd": fused_short_attention,
            "K2 attention_bwd": attention_backward,
            "K3 normalize_u8": normalize_u8,
            "K3 augment_normalize_u8": augment_normalize_u8}


def test_trace_kernel_events_equal_the_wrappers_launches(device, tmp_path):
    """Two SSL steps (AMP bf16: the tensor-core route) under the profiler,
    after one in its warm-up: each hand-written kernel's events in the
    trace equal its wrapper's launches in those steps, every one inside
    its wrapper's range (K2's under the forward's scope, then
    ``backward``), and every launch the trace records has its kernel."""
    import re

    from clip_lite_torch.utils import trace as T

    cfg = Config(FLAGSHIP, SSL_SMALL)
    state = create_train_state(cfg, device=device)
    step = make_train_step(cfg)
    batch = _ssl_batch(device)
    state, _ = step(state, batch)
    counters = _counters()

    def run(n=2):
        nonlocal state
        for _ in range(n):
            state, _ = step(state, batch)

    def warm_up():
        run(1)
        for c in counters.values():
            c.launches = 0

    tr = T.Trace(T.capture_trace(run, str(tmp_path / "t"), device, warm_up))
    assert tr.lost_launches() == []
    ops = tr.ops()
    launches = {k: c.launches for k, c in counters.items()}
    assert launches == {"K1 attention_fwd": 8, "K2 attention_bwd": 8,
                        "K3 normalize_u8": 0, "K3 augment_normalize_u8": 4}
    counts = T.kernel_counts(ops)
    assert {k: counts[k] for k in launches} == launches
    for name, rx in T.KERNEL_RANGES.items():
        for o in ops:
            if o["category"] == "kernel" and re.search(rx, o["name"]):
                assert name in o["scope"], (name, o["scope"])
    scopes = {o["scope"] for o in ops}
    assert "train_step/text_encoder/backward/K2 attention_bwd" in scopes
    summary = T.roofline_summary(ops, 2, *T.device_specs(device))
    assert summary["by_component"].get("unattributed", {"ms": 0})["ms"] \
        < 0.05 * summary["measured_ms"]
    assert 0 < summary["busy_ms"] <= summary["window_ms"]


def test_ssl_step_kernels_match_twins_on_card(device, monkeypatch):
    """One SSL step (visual and textual on, concat critics, fp32) through
    K1/K2 and K3's fused pass: the pass's images of the image and its view
    against its plain composition on the same draws within 1e-4
    (chip_smoke.py's FUSED_ATOL), and the step against one through the
    plain attention fed the same images, from the same state and batch,
    at chip_smoke.py phase 7's fp32 bars on the loss, the grad norm and
    every QKV weight gradient."""
    import clip_lite_torch.ops.image_ops as image_ops

    batch = _ssl_batch(device)
    made = []

    def recorded(images, draws, flip=True, color_jitter=True):
        made.append(augment_normalize_u8(images, draws, flip, color_jitter))
        twin = augment_reference(images, draws, flip, color_jitter)
        assert (made[-1] - twin).abs().max().item() <= 1e-4
        return made[-1]

    def replayed(images, draws, flip=True, color_jitter=True):
        return made.pop(0)

    runs, state_dict = [], None
    for kernels in (True, False):
        cfg = Config(FLAGSHIP, SSL_SMALL + [
            "AMP", False, "MODEL.TEXTUAL.FUSED_ATTENTION",
            str(kernels).lower()])
        state = create_train_state(cfg, device=device, state_dict=state_dict)
        if state_dict is None:
            state_dict = {k: v.detach().cpu()
                          for k, v in state.model.state_dict().items()}
        monkeypatch.setattr(image_ops, "augment_normalize_u8",
                            recorded if kernels else replayed)
        for c in _counters().values():
            c.launches = 0
        state, metrics = make_train_step(cfg)(state, batch)
        assert (augment_normalize_u8.launches, fused_short_attention.launches,
                attention_backward.launches) == ((2, 4, 4) if kernels
                                                 else (0, 0, 0))
        layers = state.model.text_encoder.transformer
        runs.append(({k: float(v) for k, v in metrics.items()},
                     [getattr(layers, n).qkv.weight.grad.clone()
                      for n in layers.layer_names]))
    assert made == []
    (ma, ga), (mb, gb) = runs
    assert ma["visual_loss"] > 0 and ma["textual_loss"] > 0
    for k in ("total_loss", "grad_norm"):
        assert abs(ma[k] - mb[k]) <= 1e-5 * abs(mb[k]), k
    for x, y in zip(ga, gb):
        assert ((x - y).abs().max() / y.abs().max()).item() <= 1e-3
        assert torch.nn.functional.cosine_similarity(
            x.flatten(), y.flatten(), dim=0).item() >= 0.99999
