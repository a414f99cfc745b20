"""The port's attention (clip_lite_torch/ops/attention.py) against the JAX
package's: the Pallas kernel in interpret mode and its XLA formulation.

Seeded numpy inputs go through both packages.  On the CPU the port's
wrapper takes its plain version (the CUDA kernel itself is checked on the
card by tests/test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clip_lite_tpu.ops import attention as jax_attention
from clip_lite_torch.eval_utils import EncoderBundle
from clip_lite_torch.config import Config
from clip_lite_torch.ops.attention import (
    MASK_VALUE,
    attention_reference,
    fused_short_attention,
    resolve_fused_flag,
)

B, S, NH, HD = 4, 30, 12, 64
H = NH * HD


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    qkv = (rng.randn(B, S, 3 * H) * 0.3).astype(np.float32)
    mask = np.ones((B, S), np.float32)
    mask[:, 25:] = 0.0  # padded tail
    bias = ((1 - mask) * MASK_VALUE).astype(np.float32)
    return qkv, bias


def _jax_kernel(qkv, bias):
    return jax_attention.fused_short_attention(
        jnp.asarray(qkv), jnp.asarray(bias), NH, deterministic=True,
        interpret=True)


def _jax_xla(qkv, bias):
    return jax_attention._xla_attention(jnp.asarray(qkv), jnp.asarray(bias),
                                        NH, 0.0, None)


def _port_wrapper(qkv, bias):
    return fused_short_attention(torch.from_numpy(qkv), torch.from_numpy(bias),
                                 NH)


def _port_reference(qkv, bias):
    return attention_reference(torch.from_numpy(qkv), torch.from_numpy(bias), NH)


@pytest.mark.parametrize("port_fn", [_port_wrapper, _port_reference],
                         ids=["wrapper", "reference"])
@pytest.mark.parametrize("jax_fn", [_jax_kernel, _jax_xla],
                         ids=["pallas_interpret", "xla"])
def test_forward_matches_jax(inputs, port_fn, jax_fn):
    qkv, bias = inputs
    np.testing.assert_allclose(port_fn(qkv, bias).numpy(),
                               np.asarray(jax_fn(qkv, bias)),
                               rtol=1e-5, atol=1e-5)


def test_mask_value_matches_jax():
    assert MASK_VALUE == jax_attention.MASK_VALUE


def test_padding_keys_ignored(inputs):
    qkv, bias = inputs
    out1 = _port_wrapper(qkv, bias)
    poked = qkv.copy()
    poked[:, 25:, H:2 * H] += 7.0  # keys of padded positions
    poked[:, 25:, 2 * H:] -= 3.0  # and their values
    out2 = _port_wrapper(poked, bias)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-5, atol=1e-6)


def test_bf16_reference_rounds_like_jax(inputs):
    """In bf16 the probabilities are cast to the compute type before the
    context product, as in the JAX XLA path; both round the same way up to
    the order of the fp32 sums."""
    qkv, bias = inputs
    qkv16 = qkv.astype(jnp.bfloat16)
    ref = np.asarray(jax_attention._xla_attention(
        jnp.asarray(qkv16), jnp.asarray(bias), NH, 0.0, None)).astype(np.float32)
    port = attention_reference(
        torch.from_numpy(qkv16.astype(np.float32)).bfloat16(),
        torch.from_numpy(bias), NH)
    assert port.dtype == torch.bfloat16
    # Two bf16 ulps at |x| < 1 (2**-8 each): the sums' order differs.
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=0, atol=2 ** -7)


def test_rate_above_zero_raises(inputs):
    qkv, bias = (torch.from_numpy(a) for a in inputs)
    with pytest.raises(NotImplementedError):
        fused_short_attention(qkv, bias, NH, dropout_rate=0.1,
                              deterministic=False)
    with pytest.raises(NotImplementedError):
        attention_reference(qkv, bias, NH, dropout_rate=0.1)
    # Eval mode ignores the rate, as in the JAX package.
    fused_short_attention(qkv, bias, NH, dropout_rate=0.1, deterministic=True)


def test_unsupported_shapes_raise(inputs):
    qkv, bias = (torch.from_numpy(a) for a in inputs)
    with pytest.raises(NotImplementedError):
        fused_short_attention(qkv, torch.zeros(B, NH, S, S), NH)
    with pytest.raises(ValueError):
        fused_short_attention(torch.zeros(1, 257, 3 * H), torch.zeros(1, 257), NH)


def test_wrapper_without_kernel_device_raises(inputs):
    """A tensor on neither the CPU nor CUDA has no path: no fallback."""
    qkv, bias = (torch.from_numpy(a).to("meta") for a in inputs)
    before = fused_short_attention.launches
    with pytest.raises(ValueError):
        fused_short_attention(qkv, bias, NH)
    assert fused_short_attention.launches == before


def test_cpu_path_counts_no_launch(inputs):
    before = fused_short_attention.launches
    _port_wrapper(*inputs)
    assert fused_short_attention.launches == before


def test_entry_point_defaults_to_cuda():
    """EncoderBundle runs on CUDA unless asked for the CPU, and raises when
    CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present; the CUDA-less error cannot show")
    cfg = Config(override_list=["MODEL.VISUAL.NETWORK_NAME", "resnet18",
                                "MODEL.VISUAL.WIDTH", 8,
                                "MODEL.TEXTUAL.NUM_HIDDEN_LAYERS", 1,
                                "MODEL.TEXTUAL.HIDDEN_SIZE", 64,
                                "MODEL.TEXTUAL.VOCAB_SIZE", 128])
    with pytest.raises(RuntimeError, match="CUDA"):
        EncoderBundle(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        EncoderBundle(cfg, device="cuda")


@pytest.mark.parametrize("flag,device,expected", [
    ("auto", "cpu", False), ("auto", "cuda", True), ("true", "cpu", True),
    ("false", "cuda", False), (True, "cpu", True), ("AUTO", "cuda", True),
])
def test_resolve_fused_flag(flag, device, expected):
    assert resolve_fused_flag(flag, device) is expected
