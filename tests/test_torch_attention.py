"""The port's attention (clip_lite_torch/ops/attention.py) against the JAX
package's: the Pallas kernel in interpret mode and its XLA formulation.

Seeded numpy inputs go through both packages.  On the CPU the port's
wrapper takes its plain version (the CUDA kernel itself is checked on the
card by tests/test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu.ops import attention as jax_attention
from clip_lite_torch.eval_utils import EncoderBundle
from clip_lite_torch.config import Config
from clip_lite_torch.ops.attention import (
    MASK_VALUE,
    MAX_SEQ,
    TC_MAX_SEQ,
    TF32X3_MAX_SEQ,
    TILED_MAX_SEQ,
    _raise_on,
    attention_backward,
    attention_backward_reference,
    attention_float64,
    attention_forward,
    attention_reference,
    attention_route,
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


@pytest.fixture(scope="module")
def full_bias_inputs(inputs):
    """MPNet's kind of bias: a per-head (NH, S, S) table plus padding."""
    qkv, key_bias = inputs
    rel = np.random.RandomState(2).randn(1, NH, S, S).astype(np.float32) * 0.5
    return qkv, (rel + key_bias[:, None, None, :]).astype(np.float32)


@pytest.mark.parametrize("port_fn", [_port_wrapper, _port_reference],
                         ids=["wrapper", "reference"])
@pytest.mark.parametrize("jax_fn", [_jax_kernel, _jax_xla],
                         ids=["pallas_interpret", "xla"])
def test_full_bias_forward_matches_jax(full_bias_inputs, port_fn, jax_fn):
    qkv, bias = full_bias_inputs
    assert bias.shape == (B, NH, S, S)
    np.testing.assert_allclose(port_fn(qkv, bias).numpy(),
                               np.asarray(jax_fn(qkv, bias)),
                               rtol=1e-5, atol=1e-5)


def test_full_bias_padding_keys_ignored(full_bias_inputs):
    qkv, bias = full_bias_inputs
    poked = qkv.copy()
    poked[:, 25:, H:] += 7.0  # keys and values of padded positions
    np.testing.assert_allclose(_port_wrapper(qkv, bias).numpy(),
                               _port_wrapper(poked, bias).numpy(),
                               rtol=1e-5, atol=1e-6)


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
    """Dropout without a seed or a keep mask has no draw to make."""
    qkv, bias = (torch.from_numpy(a) for a in inputs)
    with pytest.raises(ValueError):
        fused_short_attention(qkv, bias, NH, dropout_rate=0.1,
                              deterministic=False)
    with pytest.raises(ValueError):
        attention_reference(qkv, bias, NH, dropout_rate=0.1)
    # Eval mode ignores the rate, as in the JAX package.
    fused_short_attention(qkv, bias, NH, dropout_rate=0.1, deterministic=True)


def test_unsupported_shapes_raise(inputs):
    qkv, bias = (torch.from_numpy(a) for a in inputs)
    with pytest.raises(ValueError):  # a malformed full bias
        fused_short_attention(qkv, torch.zeros(B, NH, S, S + 1), NH)
    with pytest.raises(ValueError):  # a broadcast view, as on the card
        fused_short_attention(qkv, torch.zeros(1, NH, S, S).expand(B, -1, -1, -1),
                              NH)
    # Above the limit of the route the card would take: every route above
    # MAX_SEQ streams up to TILED_MAX_SEQ, fp32 and bf16, with a gradient
    # or without.
    cap = TILED_MAX_SEQ + 1
    with pytest.raises(ValueError):
        fused_short_attention(torch.zeros(1, cap, 3 * H), torch.zeros(1, cap), NH)
    with pytest.raises(ValueError):
        fused_short_attention(torch.zeros(1, cap, 3 * H, dtype=torch.bfloat16),
                              torch.zeros(1, cap), NH)
    with pytest.raises(ValueError):  # training: K2 takes the gradient
        fused_short_attention(torch.zeros(1, cap, 3 * H, requires_grad=True),
                              torch.zeros(1, cap), NH)


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


@pytest.mark.parametrize("dtype,seq,route", [
    (torch.bfloat16, 1, "tensor_core"), (torch.bfloat16, 16, "tensor_core"),
    (torch.bfloat16, 17, "tensor_core"), (torch.bfloat16, 20, "tensor_core"),
    (torch.bfloat16, 30, "tensor_core"), (torch.bfloat16, 63, "tensor_core"),
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 65, "cuda_core"),
    (torch.bfloat16, 256, "cuda_core"), (torch.float32, 1, "cuda_core"),
    (torch.float32, 30, "cuda_core"), (torch.float32, 64, "cuda_core"),
    (torch.float32, 65, "cuda_core"), (torch.bfloat16, 257, "tiled"),
    (torch.bfloat16, 512, "tiled"), (torch.float32, 257, "tiled"),
    (torch.float32, 1024, "tiled"),
])
def test_attention_route(dtype, seq, route):
    """K2's route, and bf16 K1's: bf16 at S <= 64 takes the tensor cores;
    fp32 K2 takes the CUDA cores up to 256 (plain TF32 would change its
    numbers), and so does bf16 at 64 < S <= 256; above 256 K2 takes its
    key-tiled pair in either type, and bf16 K1 its key-tiled tensor-core
    kernel."""
    assert TC_MAX_SEQ == 64 and MAX_SEQ == 256
    assert attention_route(dtype, seq, "backward") == route
    if dtype == torch.bfloat16:
        assert attention_route(dtype, seq, "forward") == (
            "tensor_core_tiled" if route == "tiled" else route)


@pytest.mark.parametrize("seq,route", [
    (1, "tf32x3"), (17, "tf32x3"), (30, "tf32x3"), (50, "tf32x3"),
    (64, "tf32x3"), (77, "tf32x3"), (80, "tf32x3"), (81, "tf32x3_tiled"),
    (197, "tf32x3_tiled"), (256, "tf32x3_tiled"), (257, "tf32x3_tiled"),
    (577, "tf32x3_tiled"), (1024, "tf32x3_tiled"),
])
def test_float32_forward_route(seq, route):
    """fp32 K1 takes the 3xTF32 kernel up to S = 80 (CLIP's 77 among them)
    for inference and the key-tiled 3xTF32 kernel above (ViT-B/16's 197,
    ViT-L/14's 257, ViT-L/14-336's 577, up to its cap of 1024); in
    training the CUDA cores up to 256 (the CUDA-core K2 regenerates that
    kernel's probabilities) and the key-tiled 3xTF32 kernel above (the
    key-tiled K2 regenerates its 3xTF32 scores); fp32 K2 stays on the CUDA
    cores up to 256 and takes its key-tiled pair above."""
    assert TF32X3_MAX_SEQ == 80 and TILED_MAX_SEQ == 1024
    long = seq > MAX_SEQ
    assert attention_route(torch.float32, seq, "forward") == route
    assert attention_route(torch.float32, seq, "forward", training=True) == (
        "tf32x3_tiled" if long else "cuda_core")
    assert attention_route(torch.float32, seq, "backward") == (
        "tiled" if long else "cuda_core")
    assert attention_route(torch.bfloat16, seq, "forward", training=True) == \
        attention_route(torch.bfloat16, seq, "forward")


@pytest.mark.parametrize("kernel,route,name", [
    ("K1", "cuda_core", "K1"), ("K1", "tensor_core", "K1 (tensor-core route)"),
    ("K1", "tf32x3", "K1 (3xTF32 route)"),
    ("K1", "tf32x3_tiled", "K1 (key-tiled 3xTF32 route)"),
    ("K1", "tensor_core_tiled", "K1 (key-tiled tensor-core route)"),
    ("K2", "cuda_core", "K2"),
    ("K2", "tensor_core", "K2 (tensor-core route)"),
    ("K2", "tiled", "K2 (key-tiled route)"),
])
def test_failed_launch_names_its_kernel_and_route(kernel, route, name):
    """A refused launch raises with its kernel, its route and the CUDA
    error's text; a launch that returned 0 raises nothing and asks the
    library for no text."""
    asked = []

    class Lib:
        def kernel_error_string(self, err):
            asked.append(err)
            return b"invalid argument"

    _raise_on(Lib(), 0, kernel, route)
    assert asked == []
    with pytest.raises(RuntimeError) as raised:
        _raise_on(Lib(), 1, kernel, route)
    assert str(raised.value) == f"{name} launch failed: invalid argument"
    assert asked == [1]


@pytest.mark.parametrize("seq", [30, 65])
def test_cpu_wrappers_take_the_twins_on_either_route(seq):
    """bf16 CPU tensors take the twins exactly whether the card would send
    them to the tensor cores (S = 30) or the CUDA cores (S = 65), in both
    directions, and count no launch on either route."""
    rng = np.random.RandomState(seq)
    qkv = torch.from_numpy(rng.randn(B, seq, 3 * H).astype(np.float32)).bfloat16()
    bias = torch.zeros(B, seq)
    bias[0, seq // 2:] = MASK_VALUE
    g = torch.from_numpy(rng.randn(B, seq, H).astype(np.float32))
    counts = (fused_short_attention.launches, fused_short_attention.tc_launches,
              fused_short_attention.tf32x3_launches,
              attention_backward.launches, attention_backward.tc_launches)
    torch.testing.assert_close(attention_forward(qkv, bias, NH),
                               attention_reference(qkv, bias, NH),
                               rtol=0, atol=0)
    dqkv, dbias = attention_backward(qkv, bias, g, NH)
    want, _ = attention_backward_reference(qkv, bias, g.bfloat16(), NH)
    torch.testing.assert_close(dqkv, want, rtol=0, atol=0)
    assert dbias is None
    assert counts == (fused_short_attention.launches,
                      fused_short_attention.tc_launches,
                      fused_short_attention.tf32x3_launches,
                      attention_backward.launches, attention_backward.tc_launches)


@pytest.mark.parametrize("full", [False, True], ids=["key_bias", "full_bias"])
def test_float64_evaluation_matches_jax(inputs, full_bias_inputs, full):
    """The float64 bar of the bf16 kernels computes the same function: on
    fp32 inputs its output, dqkv and (for a full bias) dbias equal JAX's
    XLA attention and its VJP, given the same keep mask."""
    qkv, bias = full_bias_inputs if full else inputs
    rate = 0.1
    key = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - rate, (B, NH, S, S)))
    g = np.random.RandomState(3).randn(B, S, H).astype(np.float32)
    out, dqkv, dbias = attention_float64(
        torch.from_numpy(qkv), torch.from_numpy(bias), torch.from_numpy(g), NH,
        rate, torch.from_numpy(keep))
    assert out.dtype == dqkv.dtype == torch.float64
    assert (dbias is not None) == full
    jax_out, vjp = jax.vjp(lambda x, y: jax_attention._xla_attention(
        x, y, NH, rate, key), jnp.asarray(qkv), jnp.asarray(bias))
    jax_dqkv, jax_dbias = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dqkv.numpy(), np.asarray(jax_dqkv), rtol=1e-4,
                               atol=1e-5)
    if full:
        np.testing.assert_allclose(dbias.numpy(), np.asarray(jax_dbias),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seq", [257, 577, TILED_MAX_SEQ])
def test_sequence_limits_follow_the_route(seq):
    """The CPU wrappers hold callers to the limit of the route the card
    would take: above MAX_SEQ (256) every route streams, so fp32 K1 with
    and without a gradient, fp32 K2 and bf16 K1 and K2 equal their twins
    up to the key-tiled kernels' cap, and each raises one above it."""
    assert MAX_SEQ == 256
    rng = np.random.RandomState(seq)
    nh = 1
    qkv = torch.from_numpy(rng.randn(1, seq, 3 * 64).astype(np.float32))
    bias = torch.zeros(1, seq)
    g = torch.from_numpy(rng.randn(1, seq, 64).astype(np.float32))
    with torch.no_grad():
        out = fused_short_attention(qkv, bias, nh)
    torch.testing.assert_close(out, attention_reference(qkv, bias, nh),
                               rtol=0, atol=0)
    for x in (qkv, qkv.bfloat16()):
        for training in (False, True):
            torch.testing.assert_close(
                attention_forward(x, bias, nh, training=training),
                attention_reference(x, bias, nh), rtol=0, atol=0)
        got = attention_backward(x, bias, g, nh)
        want = attention_backward_reference(x, bias, g.to(x.dtype), nh)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        assert got[1] is None and want[1] is None
    trained = fused_short_attention(qkv.clone().requires_grad_(), bias, nh)
    torch.testing.assert_close(trained.detach(), out, rtol=0, atol=0)
    long = torch.zeros(1, TILED_MAX_SEQ + 1, 3 * 64)
    long_bias = torch.zeros(long.shape[:2])
    long_g = torch.zeros(1, TILED_MAX_SEQ + 1, 64)
    with pytest.raises(ValueError, match="tf32x3_tiled"):
        attention_forward(long, long_bias, nh)
    with pytest.raises(ValueError, match="tf32x3_tiled"):
        attention_forward(long, long_bias, nh, training=True)
    with pytest.raises(ValueError, match="tf32x3_tiled"):
        fused_short_attention(long.clone().requires_grad_(), long_bias, nh)
    with pytest.raises(ValueError, match="tiled"):
        attention_backward(long, long_bias, long_g, nh)
    with pytest.raises(ValueError, match="tensor_core_tiled"):
        attention_forward(long.bfloat16(), long_bias, nh)
    with pytest.raises(ValueError, match="tiled"):
        attention_backward(long.bfloat16(), long_bias, long_g, nh)


@pytest.fixture(scope="module")
def long_inputs():
    """Above the JAX kernel's 256, where its wrapper takes XLA: seeded qkv
    at S = 257 and 300 (two items, two heads of 64), a key bias with
    padding at the tail of item 1, and a full bias adding N(0, 0.25) per
    head."""
    out = {}
    for s in (257, 300):
        rng = np.random.RandomState(s)
        qkv = (rng.randn(2, s, 3 * 128) * 0.3).astype(np.float32)
        key = np.zeros((2, s), np.float32)
        key[1, s - 40:] = MASK_VALUE
        full = (rng.randn(2, 2, s, s) * 0.5 + key[:, None, None, :]).astype(
            np.float32)
        out[s] = qkv, key, full
    return out


@pytest.mark.parametrize("full", [False, True], ids=["key_bias", "full_bias"])
@pytest.mark.parametrize("seq", [257, 300])
def test_long_float32_forward_matches_jax(long_inputs, seq, full):
    """The port's fp32 forward above 256 (the key-tiled route on the card,
    its twin here) against the JAX package's fused_short_attention, which
    falls back to XLA there, at fp32's 1e-5; the wrapper equals its twin
    and counts no launch on the CPU."""
    qkv, key, full_bias = long_inputs[seq]
    bias = full_bias if full else key
    want = np.asarray(jax_attention.fused_short_attention(
        jnp.asarray(qkv), jnp.asarray(bias), 2, deterministic=True,
        interpret=True))
    counts = (fused_short_attention.launches,
              fused_short_attention.tf32x3_tiled_launches)
    with torch.no_grad():
        got = fused_short_attention(torch.from_numpy(qkv),
                                    torch.from_numpy(bias), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, attention_reference(
        torch.from_numpy(qkv), torch.from_numpy(bias), 2), rtol=0, atol=0)
    assert counts == (fused_short_attention.launches,
                      fused_short_attention.tf32x3_tiled_launches)
