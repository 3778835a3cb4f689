"""Port checkpoint store and managers (`repro_torch.checkpoint`) vs the
reference `repro.checkpoint`.

Round trip (bf16 included), the atomic LATEST pointer, retention, a
partial chunk entry read as missing, the flattener's leaf order against
`jax.tree_util`'s, and each package reading the other's entries."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro_torch.checkpoint import CheckpointManager, ChunkStore
from repro_torch.checkpoint.store import (_flatten, _unflatten, has_named,
                                          latest_step, restore_checkpoint,
                                          restore_named, save_checkpoint,
                                          save_named)

CPU = "cpu"


class Pair(NamedTuple):
    left: object
    right: object


def _nested(leaf):
    """A nested dict / tuple / list / NamedTuple / None tree whose leaves
    are ``leaf(i)`` in the order jax visits them."""
    it = iter(range(100))
    return {"z": (leaf(next(it)), [leaf(next(it)), None]),
            "a": Pair(leaf(next(it)), {"y": leaf(next(it)),
                                      "b": leaf(next(it))}),
            "m": None, "k": [(leaf(next(it)),)]}


def test_flattener_order_equals_jax_tree_util():
    tree = _nested(lambda i: np.full((2,), i, np.int32))
    want = [int(x[0]) for x in jax.tree_util.tree_leaves(tree)]
    got = [int(x[0]) for x in _flatten(tree)]
    assert got == want and len(got) == 6
    back = _unflatten(tree, [torch.tensor(i) for i in range(6)])
    again = [int(x) for x in _flatten(back)]
    assert again == list(range(6))
    assert isinstance(back["a"], Pair) and back["m"] is None
    assert list(back) == list(tree)            # caller's key order kept


def test_save_restore_roundtrip_bf16(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3).to(torch.bfloat16),
            "b": {"c": torch.ones((4,), dtype=torch.float32),
                  "d": torch.tensor([1, -2, 3], dtype=torch.int32)},
            "e": (torch.tensor([2 ** 40], dtype=torch.int64),
                  torch.tensor([0.1], dtype=torch.float64))}
    save_checkpoint(tmp_path, 7, tree, {"note": "x"})
    assert latest_step(tmp_path) == 7
    restored, manifest = restore_checkpoint(tmp_path, tree, device=CPU)
    assert manifest["step"] == 7 and manifest["metadata"]["note"] == "x"
    assert manifest["dtypes"][0] == "bfloat16"
    for x, y in zip(_flatten(tree), _flatten(restored)):
        assert x.dtype == y.dtype and y.device.type == "cpu"
        assert torch.equal(x, y)


def test_restore_keeps_a_0d_leaf_0d(tmp_path):
    """A scalar leaf (the optimizer's step counter) comes back with shape
    (), not (1,)."""
    tree = {"step": torch.tensor(5, dtype=torch.int32),
            "x": torch.tensor(0.5, dtype=torch.bfloat16)}
    save_checkpoint(tmp_path, 1, tree)
    restored, _ = restore_checkpoint(tmp_path, tree, device=CPU)
    for name, t in tree.items():
        assert restored[name].shape == () and torch.equal(restored[name], t)


def test_atomicity_latest_pointer(tmp_path):
    tree = {"a": torch.zeros(2)}
    save_checkpoint(tmp_path, 1, tree)
    save_checkpoint(tmp_path, 2, tree)
    (tmp_path / "step_3").mkdir()                 # partial: no manifest
    (tmp_path / ".LATEST.tmp").write_text("step_3")
    assert latest_step(tmp_path) == 2
    (tmp_path / "LATEST").write_text("step_3")    # pointer at a wreck
    assert latest_step(tmp_path) is None
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".tmp")]


def test_manager_retention_and_restore(tmp_path):
    mgr = CheckpointManager(tmp_path, every_steps=2, keep=2)
    assert [mgr.should_save(s) for s in (0, 1, 2, 3, 4)] == \
        [False, False, True, False, True]
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor([s])})
    assert sorted(p.name for p in tmp_path.glob("step_*")) == \
        ["step_3", "step_4"]
    assert mgr.latest() == 4
    (x,), manifest = mgr.restore((torch.tensor([0]),), device=CPU)
    assert int(x) == 4 and manifest["step"] == 4


def test_chunk_store_ignores_partial_entries(tmp_path):
    store = ChunkStore(tmp_path)
    store.save("abc123", [np.arange(4.0)], metadata={"kind": "rate"})
    assert store.has("abc123") and store.keys() == ["abc123"]
    (tmp_path / "chunk_abc123" / "manifest.json").unlink()
    assert not store.has("abc123") and store.keys() == []
    store.save("abc123", [np.arange(4.0)])       # re-save over the wreck
    (loaded,) = store.load("abc123")
    np.testing.assert_array_equal(loaded, np.arange(4.0))
    store.clear()
    assert not store.has("abc123")
    assert ChunkStore(tmp_path / "missing").keys() == []


def test_entries_cross_between_packages(tmp_path):
    """An entry the reference wrote is read by the port, and the other
    way round: same leaves, same shapes and dtypes, same metadata."""
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((3, 4)).astype(np.float32),
              rng.integers(-5, 5, (7,)).astype(np.int32),
              np.float32(2.5), np.array([True, False])]
    ref_store.save_named(tmp_path, "from_ref",
                         {"a": [jnp.asarray(x) for x in leaves]},
                         metadata={"k": 1})
    got, manifest = restore_named(tmp_path, "from_ref")
    assert has_named(tmp_path, "from_ref") and manifest["metadata"] == {"k": 1}
    save_named(tmp_path, "from_port",
               {"a": [torch.from_numpy(np.asarray(x)) for x in leaves]},
               metadata={"k": 2})
    back, ref_manifest = ref_store.restore_named(tmp_path, "from_port")
    assert ref_store.has_named(tmp_path, "from_port")
    assert ref_manifest["metadata"] == {"k": 2}
    assert ref_manifest["shapes"] == manifest["shapes"]
    for want, a, b in zip(leaves, got, back):
        want = np.asarray(want)
        for x in (a, b):
            assert x.dtype == want.dtype and x.shape == want.shape
            np.testing.assert_array_equal(x, want)


def test_reference_step_checkpoint_restores_in_the_port(tmp_path):
    """A step checkpoint the reference saved (bf16 leaf included) restores
    through the port's `restore_checkpoint` onto torch dtypes."""
    tree = {"w": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)
            .astype(jnp.bfloat16), "n": jnp.asarray([3], jnp.int32)}
    ref_store.save_checkpoint(tmp_path, 5, tree)
    like = {"w": torch.zeros((2, 3), dtype=torch.bfloat16),
            "n": torch.zeros((1,), dtype=torch.int32)}
    got, manifest = restore_checkpoint(tmp_path, like, device=CPU)
    assert manifest["step"] == 5
    assert got["w"].dtype == torch.bfloat16 and got["n"].dtype == torch.int32
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert int(got["n"][0]) == 3


def test_restore_rejects_a_structure_mismatch(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.zeros(1), "b": torch.ones(1)})
    with pytest.raises(ValueError, match="2 leaves, expected 1"):
        restore_checkpoint(tmp_path, {"a": torch.zeros(1)}, device=CPU)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", {"a": torch.zeros(1)},
                           device=CPU)
