"""The port's msgpack reader and writer (clip_lite_torch/utils/msgpack_io.py)
against flax's ``msgpack_serialize`` and ``msgpack_restore``, which write
and read the JAX package's checkpoints: the same bytes for the same tree,
and each side reads the other's output, chunked leaves included.  The
module imports neither ``msgpack`` nor ``flax``."""

import ast
import os

import numpy as np
import pytest
import torch

from flax import serialization

from clip_lite_torch.utils import msgpack_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(seed=0):
    """Every leaf type of a checkpoint: int32, int64 and float32 arrays,
    0-d arrays, a numpy scalar, empty maps, plain numbers and wide maps."""
    rng = np.random.default_rng(seed)
    return {
        "state": {
            "step": np.asarray(7, np.int32),
            "params": {"dense": {"kernel": rng.standard_normal(
                (3, 5)).astype(np.float32),
                "bias": np.zeros((5,), np.float32)},
                "conv": {"kernel": rng.standard_normal(
                    (3, 3, 2, 4)).astype(np.float32)},
                "temperature": np.asarray(0.07, np.float32)},
            "opt_state": {"count": np.asarray(3, np.int32),
                          "la_count": np.asarray(-2, np.int32),
                          "nu": {}, "slow_params": {},
                          "ids": np.arange(-3, 300, 7, dtype=np.int64)},
            "wide": {str(i): np.full((i % 3,), i, np.int32)
                     for i in range(40)},
        },
        "iteration": np.int64(123456789012),
        "float32_scalar": np.float32(2.5),
        "numbers": {"a": 1, "b": -33, "c": 200, "d": 70000, "e": -70000,
                    "f": 2 ** 40, "g": 1.5, "h": True, "i": None, "j": "x" * 40},
        "big": rng.standard_normal((300, 70)).astype(np.float32),
        "empty": np.zeros((0, 4), np.float32),
    }


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                      and isinstance(b, np.ndarray))
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).shape == np.asarray(b).shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


def test_pack_gives_flax_bytes():
    tree = _tree()
    assert msgpack_io.pack(tree) == serialization.msgpack_serialize(tree)


@pytest.mark.parametrize("length", [0, 1, 4, 5, 16, 17, 255, 256, 65535,
                                    65536])
def test_pack_gives_flax_bytes_at_every_header_size(length):
    """Arrays whose ext payload crosses fixext16, ext8/16/32 and bin8/16/32,
    and maps and strs across their header sizes."""
    tree = {"u8": np.arange(length, dtype=np.uint8) % 251,
            "map": {f"k{i:05d}": i for i in range(min(length, 20))},
            "s" * max(1, length % 300): np.int32(length)}
    assert msgpack_io.pack(tree) == serialization.msgpack_serialize(tree)


def test_unpack_reads_flax_output():
    tree = _tree(1)
    got = msgpack_io.unpack(serialization.msgpack_serialize(tree))
    _assert_trees_equal(got, serialization.msgpack_restore(
        serialization.msgpack_serialize(tree)))
    _assert_trees_equal(got, tree)
    assert got["iteration"] == 123456789012 and isinstance(
        got["iteration"], np.int64)


def test_flax_restores_port_output(tmp_path):
    tree = _tree(2)
    path = str(tmp_path / "ckpt.msgpack")
    size = msgpack_io.write(path, tree)
    with open(path, "rb") as f:
        data = f.read()
    assert size == len(data) and not os.path.exists(path + ".tmp")
    _assert_trees_equal(serialization.msgpack_restore(data), tree)
    _assert_trees_equal(msgpack_io.read(path), tree)


def test_chunked_leaves_both_ways(monkeypatch):
    """flax splits a leaf above MAX_CHUNK_SIZE bytes into flat chunks; made
    small here to force it.  The port reads flax's chunks and, with the
    same limit, writes flax's bytes."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 256)
    tree = _tree(3)
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    _assert_trees_equal(msgpack_io.unpack(data), tree)
    assert msgpack_io.pack(tree) == data
    _assert_trees_equal(serialization.msgpack_restore(msgpack_io.pack(tree)),
                        tree)


def test_arrays_are_views_of_the_file(tmp_path):
    path = str(tmp_path / "ckpt.msgpack")
    msgpack_io.write(path, _tree())
    got = msgpack_io.read(path)
    kernel = got["state"]["params"]["conv"]["kernel"]
    assert not kernel.flags.owndata and kernel.flags.writeable
    assert kernel.base is not None


def test_torch_leaves_bfloat16_and_strides():
    """A CPU tensor is written as its C-order numpy array would be, whatever
    its strides; bfloat16 (flax's dtype name ``bfloat16``) comes back as a
    torch tensor with the same bits."""
    x = torch.randn(2, 3, 4, 5)
    cl = x.to(memory_format=torch.channels_last)
    assert msgpack_io.pack({"x": cl}) == serialization.msgpack_serialize(
        {"x": x.numpy()})
    bf = torch.randn(3, 7).bfloat16()
    back = msgpack_io.unpack(msgpack_io.pack({"b": bf, "s": bf[0, 0]}))
    assert back["b"].dtype == torch.bfloat16 and torch.equal(back["b"], bf)
    assert back["s"].shape == () and torch.equal(back["s"], bf[0, 0])
    import ml_dtypes  # flax's own bfloat16

    flax_bf = serialization.msgpack_restore(msgpack_io.pack({"b": bf}))["b"]
    assert flax_bf.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(flax_bf.astype(np.float32),
                                  bf.float().numpy())


def test_refuses_what_it_cannot_write_or_read():
    with pytest.raises(TypeError):
        msgpack_io.pack({1: np.zeros(2)})
    with pytest.raises(TypeError):
        msgpack_io.pack({"a": object()})
    with pytest.raises(ValueError):
        msgpack_io.unpack(msgpack_io.pack({"a": np.zeros(3)})[:-1])


def test_msgpack_io_imports_neither_msgpack_nor_flax():
    path = os.path.join(ROOT, "clip_lite_torch", "utils", "msgpack_io.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert names and not [n for n in names if n.split(".")[0] in
                          ("msgpack", "flax", "jax", "clip_lite_tpu")]
