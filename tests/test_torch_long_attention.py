"""The port above 256 tokens against the JAX package, which runs there on
XLA (its wrapper falls back to ``_xla_attention`` above 256).

On the card the port takes its key-tiled kernels there: bf16 K1 the
key-tiled tensor-core kernel, fp32 K1 in training the key-tiled 3xTF32
one, K2 its key-tiled pair in either type (tests/test_torch_cuda.py and
chip_smoke.py hold them against these twins).  Here, on the CPU, the
wrappers take the twins, and these tests hold the contract the kernels
meet on the card against JAX: the attention's output and gradients at
S = 257, 300 and 512, a 2-layer BERT at 300 tokens loaded through the
bridge, and one training step at 300 tokens.  Inputs are seeded numpy
arrays handed to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clip_lite_tpu import engine as jengine
from clip_lite_tpu.config import Config as JConfig
from clip_lite_tpu.factories import OptimizerFactory as JOptimizerFactory
from clip_lite_tpu.factories import PretrainingModelFactory as JModelFactory
from clip_lite_tpu.models import bert as jbert
from clip_lite_tpu.ops import attention as jax_attention
from clip_lite_torch import bridge
from clip_lite_torch.config import Config
from clip_lite_torch.engine import create_train_state, make_train_step, metrics_to_floats
from clip_lite_torch.models import bert as tbert
from clip_lite_torch.ops.attention import (
    MASK_VALUE,
    MAX_SEQ,
    attention_route,
    fused_short_attention,
)
from test_torch_train import COMPONENTS, FLAGSHIP, TRAIN, _inject_uniform
from torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

NH, HD = 2, 64
# tests/test_torch_attention_grad.py's bars: fp32 1e-5 under a key bias;
# 1e-4 for dqkv and dbias under a full bias, the JAX package's own bar
# between its two paths there.
TOL = dict(rtol=1e-5, atol=1e-5)
FULL_TOL = dict(rtol=1e-4, atol=1e-4)


def _case(s, full, seed=0):
    """Two items, two heads of 64: qkv N(0, 0.25), item 1's last 40 keys
    padding (MASK_VALUE), a full bias adding N(0, 0.25) per head; the
    output's cotangent N(0, 1)."""
    rng = np.random.RandomState(seed + s)
    qkv = (rng.randn(2, s, 3 * NH * HD) * 0.5).astype(np.float32)
    key = np.zeros((2, s), np.float32)
    key[1, s - 40:] = MASK_VALUE
    bias = key
    if full:
        bias = (rng.randn(2, NH, s, s) * 0.5 + key[:, None, None, :]).astype(
            np.float32)
    w = rng.randn(2, s, NH * HD).astype(np.float32)
    return qkv, bias, w


def _jax_vjp(qkv, bias, w):
    out, vjp = jax.vjp(lambda x, y: jax_attention.fused_short_attention(
        x, y, NH, deterministic=True, interpret=True),
        jnp.asarray(qkv), jnp.asarray(bias))
    dqkv, dbias = vjp(jnp.asarray(w, out.dtype))
    return np.asarray(out, np.float32), np.asarray(dqkv, np.float32), np.asarray(dbias)


def _port_vjp(qkv, bias, w, dtype=torch.float32):
    full = bias.ndim == 4
    x = torch.from_numpy(qkv).to(dtype).requires_grad_()
    y = torch.from_numpy(bias).requires_grad_(full)
    out = fused_short_attention(x, y, NH)
    out.backward(torch.from_numpy(w).to(dtype))
    return (out.detach().float().numpy(), x.grad.float().numpy(),
            None if y.grad is None else y.grad.numpy())


@pytest.mark.parametrize("full", [False, True], ids=["key_bias", "full_bias"])
@pytest.mark.parametrize("seq", [257, 300, 512])
def test_long_attention_and_gradients_match_jax(seq, full):
    """fp32 above 256 with a gradient (the card's key-tiled 3xTF32 K1 in
    training and the key-tiled K2): the output, dqkv and, under a full
    bias, dbias against ``jax.vjp`` of the JAX package's
    fused_short_attention; counted on no route on the CPU."""
    assert seq > MAX_SEQ
    assert attention_route(torch.float32, seq, "forward", training=True) == \
        "tf32x3_tiled"
    assert attention_route(torch.float32, seq, "backward") == "tiled"
    qkv, bias, w = _case(seq, full)
    counts = (fused_short_attention.launches,
              fused_short_attention.tf32x3_tiled_launches)
    out, dqkv, dbias = _port_vjp(qkv, bias, w)
    assert counts == (fused_short_attention.launches,
                      fused_short_attention.tf32x3_tiled_launches)
    want_out, want_dqkv, want_dbias = _jax_vjp(qkv, bias, w)
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(dqkv, want_dqkv, **(FULL_TOL if full else TOL))
    if full:
        np.testing.assert_allclose(dbias, want_dbias, **FULL_TOL)
    else:
        assert dbias is None


@pytest.mark.parametrize("full", [False, True], ids=["key_bias", "full_bias"])
def test_long_bf16_attention_matches_jax(full):
    """bf16 at S = 300 (the card's key-tiled tensor-core K1 and key-tiled
    K2): the two packages round to bf16 at other places (the port where
    its kernels do: the probabilities and ds / sqrt(HD) before their
    products, the outputs once), so they do not agree to the bit.  Bar:
    each of the port's output, dqkv and dbias lies no further than twice
    as far from JAX's fp32 result as JAX's own bf16 result does (a bar
    that does not depend on where each rounds), and within four bf16 ulps
    at 1 (2^-6) of JAX's bf16 output."""
    qkv, bias, w = _case(300, full, seed=1)
    qkv = np.asarray(jnp.asarray(qkv, jnp.bfloat16).astype(jnp.float32))
    w = np.asarray(jnp.asarray(w, jnp.bfloat16).astype(jnp.float32))
    exact = _jax_vjp(qkv, bias, w)
    jax16 = _jax_vjp(np.asarray(jnp.asarray(qkv, jnp.bfloat16)), bias,
                     np.asarray(jnp.asarray(w, jnp.bfloat16)))
    port = _port_vjp(qkv, bias, w, torch.bfloat16)
    for name, p, j, e in zip(("out", "dqkv", "dbias"), port, jax16, exact):
        if not full and name == "dbias":
            assert p is None
            continue
        port_err = np.abs(p - e).max()
        jax_err = np.abs(j - e).max()
        assert port_err <= 2.0 * jax_err, (name, port_err, jax_err)
    np.testing.assert_allclose(port[0], jax16[0], rtol=0, atol=2 ** -6)


def test_bert_past_256_tokens_matches_jax():
    """A 2-layer BERT (hidden 128, two heads of 64) over 300 tokens with
    FUSED_ATTENTION true, the JAX tower's variables loaded through the
    bridge: the sequence and pooled outputs and every parameter's gradient
    of a seeded linear loss against JAX's at 1e-4 (the gradients at 1e-4
    of the largest)."""
    b, s, vocab = 2, 300, 128
    rng = np.random.RandomState(300)
    lengths = np.array([300, 217])
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    ids = rng.randint(103, vocab, (b, s)).astype(np.int32) * mask
    w_seq = rng.randn(b, s, 128).astype(np.float32)
    w_pooled = rng.randn(b, 128).astype(np.float32)
    kwargs = dict(vocab_size=vocab, hidden_size=128, num_hidden_layers=2,
                  num_heads=2, intermediate_size=512, fused_attention="true")
    jmod = jbert.BertModel(**kwargs)
    v = jax.jit(lambda i, m: jmod.init(jax.random.PRNGKey(0), i, m))(
        jnp.asarray(ids), jnp.asarray(mask))

    def loss(params):
        seq, pooled = jmod.apply({"params": params}, jnp.asarray(ids),
                                 jnp.asarray(mask))
        return jnp.sum(seq * w_seq) + jnp.sum(pooled * w_pooled), (seq, pooled)

    (_, (seq_ref, pooled_ref)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(v["params"])
    port = tbert.BertModel(**kwargs)
    port.load_state_dict(bridge.convert(jax.tree.map(np.asarray, v), port))
    port.eval()
    seq, pooled = port(torch.from_numpy(ids).long(), torch.from_numpy(mask).long())
    ((seq * torch.from_numpy(w_seq)).sum()
     + (pooled * torch.from_numpy(w_pooled)).sum()).backward()
    np.testing.assert_allclose(seq.detach().numpy(), np.asarray(seq_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(pooled_ref),
                               rtol=1e-4, atol=1e-4)
    want = bridge.convert({"params": jax.tree.map(np.asarray, grads)}, port)
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(g.abs().max()) for g in got.values())
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


LONG_TRAIN = TRAIN + ["DATA.MAX_CAPTION_LENGTH", 300,
                      "MODEL.TEXTUAL.FUSED_ATTENTION", "true"]


def test_training_step_past_256_tokens_matches_jax():
    """One training step of the tiny flagship (ResNet-18 at width 8 and
    32 px, BERT-2/128, dropout off) on tests/test_torch_train.py's eight
    pairs, of 300 tokens here, from the JAX state's variables: the step's
    metrics at that file's bars (rtol 1e-4, atol 1e-6), and every
    parameter's gradient at 1e-4 of the largest."""
    b, s = 8, 300
    rng = np.random.RandomState(7)
    lengths = np.array([300, 300, 260, 257, 200, 120, 30, 9])
    batch = {"image": rng.randn(b, 32, 32, 3).astype(np.float32),
             "input_ids": rng.randint(1, 128, (b, s)).astype(np.int32),
             "attention_mask": (np.arange(s)[None, :] < lengths[:, None]
                                ).astype(np.int32)}
    noise = {"image": rng.uniform(size=(b, 64)).astype(np.float32),
             "text": rng.uniform(size=(b, 128)).astype(np.float32)}
    jcfg = JConfig(FLAGSHIP, LONG_TRAIN)
    model = JModelFactory.from_config(jcfg)
    tx = JOptimizerFactory.from_config(jcfg)
    sample = jax.tree.map(lambda a: a[:1], batch)
    state = jax.jit(lambda x: jengine.create_train_state(model, tx, x, seed=0))(
        sample)
    variables = jax.tree.map(np.asarray, {"params": state.params,
                                          "batch_stats": state.batch_stats})
    key = jax.random.PRNGKey(0)
    with pytest.MonkeyPatch.context() as mp:
        _inject_uniform(mp, noise)

        def loss_fn(params):
            out, _ = model.apply(
                {"params": params, "batch_stats": state.batch_stats},
                batch, train=True, mutable=["batch_stats"],
                rngs={"prior": key, "dropout": key})
            return out["loss"]

        grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(state.params))
        _, metrics = jax.jit(jengine.make_train_step(model, tx))(state, batch, key)
    metrics = jax.tree.map(float, jax.device_get(metrics))

    cfg = Config(FLAGSHIP, LONG_TRAIN)
    port = create_train_state(cfg, device="cpu",
                              state_dict=bridge.from_jax_variables(variables, cfg))
    port, got = make_train_step(cfg)(
        port, batch, prior_noise={k: torch.from_numpy(v) for k, v in noise.items()})
    got = metrics_to_floats(got)
    for name in COMPONENTS + ("grad_norm",):
        np.testing.assert_allclose(got[name], metrics[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    want = bridge.convert({"params": grads,
                           "batch_stats": variables["batch_stats"]}, port.model)
    port_grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                  for n, p in port.model.named_parameters()}
    scale = max(float(g.abs().max()) for g in port_grads.values())
    for name, g in port_grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)
