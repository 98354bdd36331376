"""`repro_torch.bridge` crossing bf16 leaves bit for bit, on the CPU.

numpy has no bfloat16: the bridge hands a bf16 tensor over as its 2-byte
words in a `|V2` array (what `np.savez` writes for a JAX bf16 leaf, and
what `np.load` gives back), and reads both that and ml_dtypes' bfloat16
(what `np.asarray` gives for a JAX bf16 array) back as torch.bfloat16.
Exact: every comparison is of bytes.
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import bridge


def _jax_bf16(seed: int, shape) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def test_bf16_tree_round_trip_matches_jax_bytes():
    ref = {"emb": _jax_bf16(0, (7, 5)), "blocks": ({"w": _jax_bf16(1, (3,))},
                                                   _jax_bf16(2, ()))}
    tree = bridge.tree_from_numpy(ref)
    assert all(t.dtype == torch.bfloat16 for t in (
        tree["emb"], tree["blocks"][0]["w"], tree["blocks"][1]))
    back = bridge.tree_to_numpy(tree)
    for got, want in ((back["emb"], ref["emb"]),
                      (back["blocks"][0]["w"], ref["blocks"][0]["w"]),
                      (back["blocks"][1], ref["blocks"][1])):
        assert got.dtype.kind == "V" and got.dtype.itemsize == 2
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    again = bridge.tree_from_numpy(back)
    assert torch.equal(again["emb"].view(torch.int16),
                       tree["emb"].view(torch.int16))


def test_bf16_words_are_what_savez_writes_for_jax():
    """np.savez of the JAX leaf and of the bridge's words: the same
    `|V2` entry, and np.load's words come back as the same bf16."""
    want = _jax_bf16(3, (4, 6))
    words = bridge.tensor_to_array(bridge.array_to_tensor(want))
    bufs = []
    for a in (want, words):
        buf = io.BytesIO()
        np.savez(buf, x=a)
        buf.seek(0)
        with np.load(buf) as f:
            bufs.append(f["x"])
    assert bufs[0].dtype == bufs[1].dtype == np.dtype("V2")
    assert bufs[0].tobytes() == bufs[1].tobytes() == want.tobytes()
    t = bridge.array_to_tensor(bufs[0])
    assert t.dtype == torch.bfloat16
    assert torch.equal(t.float(), torch.from_numpy(
        np.array(jnp.asarray(want, jnp.float32))))


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8, np.int8,
                                   np.bool_, np.float16])
def test_other_dtypes_cross_unchanged(dtype):
    a = (np.arange(12).reshape(3, 4) % 5).astype(dtype)
    t = bridge.array_to_tensor(a)
    back = bridge.tensor_to_array(t)
    assert back.dtype == a.dtype
    np.testing.assert_array_equal(back, a)
