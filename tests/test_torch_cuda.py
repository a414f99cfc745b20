"""K1, the CUDA attention kernel, against its plain version on the card.

These tests need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.  The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from clip_lite_torch.models.bert import BertModel
from clip_lite_torch.ops.attention import (
    MASK_VALUE,
    attention_reference,
    fused_short_attention,
)
from clip_lite_torch.ops.layers import init_weights

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,nh", [(128, 30, 12), (3, 1, 2), (5, 33, 4),
                                    (2, 256, 2), (1, 64, 1), (7, 17, 12)])
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
