"""The port's checkpoints (``repro_torch.train.checkpoint``): the
reference's ``tests/test_checkpoint.py`` cases on the port's module, and
the shared on-disk layout — a tree saved by either package (fp32, bf16 and
int32 leaves) is restored by the other bit for bit."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_pin import one_thread  # noqa: F401

from repro.train import checkpoint as ref_ckpt

from repro_torch.train import checkpoint as ckpt


def _tree():
    return {"a": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16),
                       "c": torch.tensor(3, dtype=torch.int32)}}


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 3, t, {"note": "hi"})
    out, meta = ckpt.restore(str(tmp_path), t)
    assert meta == {"note": "hi"}
    assert torch.equal(out["a"], t["a"])
    assert out["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["nested"]["b"], t["nested"]["b"])
    assert out["nested"]["c"].dtype == torch.int32 and int(
        out["nested"]["c"]) == 3


def test_versioning_and_latest(tmp_path):
    t = _tree()
    for s in (1, 5, 3):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.list_steps(str(tmp_path)) == [1, 3, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    out, _ = ckpt.restore(str(tmp_path), t, step=3)
    assert out is not None


def test_torn_write_is_invisible(tmp_path):
    """A crash mid-write leaves only *.tmp — restore never sees it."""
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    torn = tmp_path / "step_000000002.tmp"
    os.makedirs(torn)
    (torn / "arrays.npz").write_bytes(b"garbage")
    assert ckpt.latest_step(str(tmp_path)) == 1
    ckpt.restore(str(tmp_path), t)              # restores step 1, no error


def test_no_checkpoint_raises(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), _tree())


def test_corruption_detected(tmp_path):
    t = _tree()
    path = ckpt.save(str(tmp_path), 7, t)
    payload = os.path.join(path, "arrays.npz")
    data = bytearray(open(payload, "rb").read())
    data[len(data) // 2] ^= 0xFF
    open(payload, "wb").write(bytes(data))
    with pytest.raises(IOError, match="hash mismatch"):
        ckpt.restore(str(tmp_path), t)


def test_shape_mismatch_detected(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    bad = dict(t)
    bad["a"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), bad)


def test_missing_leaf_detected(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    bigger = dict(t)
    bigger["extra"] = torch.zeros(3)
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), bigger)


def test_idempotent_resave(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 2, t)
    ckpt.save(str(tmp_path), 2, t)              # no error, one entry
    assert ckpt.list_steps(str(tmp_path)) == [2]


def test_manifest_contents(tmp_path):
    t = _tree()
    path = ckpt.save(str(tmp_path), 4, t, {"cursor": {"step": 4}})
    m = json.load(open(os.path.join(path, "manifest.json")))
    assert m["step"] == 4
    assert m["metadata"]["cursor"]["step"] == 4
    assert m["leaves"]["nested/b"]["dtype"] == "bfloat16"
    assert m["leaves"]["a"] == {"shape": [3, 4], "dtype": "float32"}
    assert len(m["sha256"]) == 64


def test_named_tuple_leaves_restore_their_type(tmp_path):
    from repro_torch.train.optim import AdamWConfig, adamw_init
    st = adamw_init({"w": torch.ones(2, 2)}, AdamWConfig())
    st.m["w"].fill_(0.5)
    ckpt.save(str(tmp_path), 1, {"opt": st})
    out, _ = ckpt.restore(str(tmp_path), {"opt": adamw_init(
        {"w": torch.ones(2, 2)}, AdamWConfig())})
    assert type(out["opt"]) is type(st)
    assert torch.equal(out["opt"].m["w"], st.m["w"])


# ---------------------------------------------------- across the packages
def _values(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    return a, b, np.int32(-5)


def test_reference_checkpoint_restores_bitwise_in_port(tmp_path):
    a, b, c = _values()
    ref_tree = {"a": jnp.asarray(a),
                "nested": {"b": jnp.asarray(b).astype(jnp.bfloat16),
                           "c": jnp.asarray(c)}}
    ref_ckpt.save(str(tmp_path), 9, ref_tree, {"cursor": {"step": 9}})
    template = {"a": torch.zeros(3, 4),
                "nested": {"b": torch.zeros(7, dtype=torch.bfloat16),
                           "c": torch.zeros((), dtype=torch.int32)}}
    out, meta = ckpt.restore(str(tmp_path), template)
    assert meta == {"cursor": {"step": 9}}
    np.testing.assert_array_equal(_bits(out["a"]), a)
    np.testing.assert_array_equal(
        _bits(out["nested"]["b"]),
        np.asarray(ref_tree["nested"]["b"]).view(np.uint16))
    assert out["nested"]["c"].dtype == torch.int32
    assert int(out["nested"]["c"]) == -5


def test_port_checkpoint_restores_bitwise_in_reference(tmp_path):
    a, b, c = _values(1)
    port_tree = {"a": torch.from_numpy(a),
                 "nested": {"b": torch.from_numpy(b).to(torch.bfloat16),
                            "c": torch.tensor(c)}}
    ckpt.save(str(tmp_path), 4, port_tree, {"note": "port"})
    template = {"a": jnp.zeros((3, 4)),
                "nested": {"b": jnp.zeros(7, jnp.bfloat16),
                           "c": jnp.zeros((), jnp.int32)}}
    out, meta = ref_ckpt.restore(str(tmp_path), template)
    assert meta == {"note": "port"}
    np.testing.assert_array_equal(np.asarray(out["a"]), a)
    assert out["nested"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(out["nested"]["b"]).view(
        np.uint16), _bits(port_tree["nested"]["b"]))
    assert out["nested"]["c"].dtype == jnp.int32
    assert int(out["nested"]["c"]) == -5
