"""The port's checkpoint manager against the reference's
(``src/repro/checkpoint/manager.py``): the same files for the same tree,
byte for byte, so a checkpoint written by either package restores in the
other; a bf16 leaf written by the reference restores in the port (the
reference's own restore refuses it); save ordering, GC and the shape
check; and a crash and resume that ends bitwise where the straight run
ends."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import Transformer as RefTransformer
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import train
from repro_torch.models import params_from_numpy
from repro_torch.runtime import FaultInjector
from repro_torch.tree import leaves


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These steps are made of small ops: one intra-op thread runs them
    fastest, and keeps the file fast beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_train_state():
    """The reference's fp32 AdamW train state of reduced qwen2.5-14b after
    one update (m, v and step not at their initial values)."""
    cfg = ref_reduced(ref_get_config("qwen2.5-14b"))
    params = RefTransformer(cfg).init(jax.random.key(0))
    opt = ref_adamw()
    state = opt.init(params)
    grads = jax.tree.map(lambda p: 0.01 * jnp.ones_like(p), params)
    params, state = opt.update(grads, state, params)
    return {"params": params, "opt": state}


def _to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_same_tree_gives_the_same_files(tmp_path):
    """Both packages write byte-identical ``.npy`` files and manifests
    (``treedef`` included: the port prints a tree of dicts as
    ``jax.tree_util`` does)."""
    tree = _ref_train_state()
    RefCheckpointManager(tmp_path / "ref").save(3, tree, extra={"x": 1},
                                                blocking=True)
    CheckpointManager(tmp_path / "port").save(3, _to_port(tree),
                                              extra={"x": 1},
                                              blocking=True)
    ref = _files(tmp_path / "ref" / "step_0000000003")
    port = _files(tmp_path / "port" / "step_0000000003")
    assert sorted(ref) == sorted(port)
    assert len(ref) == len(jax.tree.leaves(tree)) + 1
    for name in ref:
        assert ref[name] == port[name], name
    manifest = json.loads(port["manifest.json"])
    assert manifest["leaves"][0]["key"] == "opt/m/embed"
    assert manifest["leaves"][-1]["key"] == "params/layers/ln2"


def test_reference_saves_port_restores(tmp_path):
    tree = _ref_train_state()
    RefCheckpointManager(tmp_path).save(7, tree, extra={"data_index": 7},
                                        blocking=True)
    target = _to_port(jax.tree.map(jnp.zeros_like, tree))
    step, got, extra = CheckpointManager(tmp_path).restore_latest(target)
    assert step == 7 and extra == {"data_index": 7}
    for want, g in zip(jax.tree.leaves(tree), leaves(got)):
        want = np.asarray(want)
        assert g.dtype == torch.from_numpy(want.copy()).dtype
        np.testing.assert_array_equal(g.numpy(), want)


def test_port_saves_reference_restores(tmp_path):
    tree = _ref_train_state()
    CheckpointManager(tmp_path).save(9, _to_port(tree),
                                     extra={"data_index": 9},
                                     blocking=True)
    target = jax.tree.map(jnp.zeros_like, tree)
    step, got, extra = RefCheckpointManager(tmp_path).restore_latest(target)
    assert step == 9 and extra == {"data_index": 9}
    for want, g in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        assert g.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(want))


def _bf16_tree():
    rng = np.random.default_rng(3)
    return {"w": jnp.asarray(rng.standard_normal((4, 5)), jnp.bfloat16),
            "step": jnp.asarray(2, jnp.int32)}


def test_bf16_leaf_from_reference_restores_in_port(tmp_path):
    tree = _bf16_tree()
    RefCheckpointManager(tmp_path / "ref").save(1, tree, blocking=True)
    manifest = json.loads((tmp_path / "ref" / "step_0000000001" /
                           "manifest.json").read_text())
    assert manifest["leaves"][1]["dtype"] == "bfloat16"
    got, _ = CheckpointManager(tmp_path / "ref").restore(
        1, {"step": torch.zeros((), dtype=torch.int32),
            "w": torch.zeros((4, 5), dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  np.asarray(tree["w"]).view(np.int16))
    assert int(got["step"]) == 2
    # the port writes the same bytes
    CheckpointManager(tmp_path / "port").save(1, _to_port(tree),
                                              blocking=True)
    assert _files(tmp_path / "ref" / "step_0000000001") == \
        _files(tmp_path / "port" / "step_0000000001")


def test_reference_restore_refuses_its_own_bf16_leaf(tmp_path):
    """The reference limit the port works around (ROADMAP Queue 3): numpy
    reads the ``<V2`` payload back as ``|V2``, which JAX does not take."""
    RefCheckpointManager(tmp_path).save(1, _bf16_tree(), blocking=True)
    with pytest.raises(TypeError):
        RefCheckpointManager(tmp_path).restore(1, _bf16_tree())


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.standard_normal((8, 8))
                                             .astype(np.float32)),
                       "b": torch.from_numpy(rng.standard_normal(8)
                                             .astype(np.float32))},
            "opt": {"m": {"w": torch.zeros(8, 8), "b": torch.ones(8)},
                    "step": torch.tensor(3, dtype=torch.int32)}}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    mgr.save(10, tree, extra={"data_index": 10}, blocking=True)
    step, restored, extra = mgr.restore_latest(tree)
    assert step == 10 and extra["data_index"] == 10
    for a, b in zip(leaves(tree), leaves(restored)):
        assert torch.equal(a, b)


def test_save_is_a_snapshot(tmp_path):
    """The optimizer updates tensors in place after a save: the files hold
    the values at ``save``."""
    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    want = tree["params"]["w"].clone()
    mgr.save(1, tree)
    tree["params"]["w"].add_(1.0)
    mgr.wait()
    got, _ = mgr.restore(1, tree)
    assert torch.equal(got["params"]["w"], want)


def test_restore_places_leaves(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, _tree(), blocking=True)
    meta = {"params": {k: torch.empty(v.shape, device="meta")
                       for k, v in _tree()["params"].items()},
            "opt": _tree()["opt"]}
    got, _ = mgr.restore(1, meta)
    assert all(t.device.type == "cpu" for t in leaves(got))
    got, _ = mgr.restore(1, _tree(), device="cpu")
    assert all(t.device.type == "cpu" for t in leaves(got))


def test_async_save_ordering(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=10)
    for s in (1, 2, 3):
        mgr.save(s, _tree(s))
    mgr.wait()
    assert mgr.all_steps() == [1, 2, 3]
    assert mgr.latest_step() == 3
    got, _ = mgr.restore(2, _tree())
    assert torch.equal(got["params"]["w"], _tree(2)["params"]["w"])


def test_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in range(5):
        mgr.save(s, _tree(s), blocking=True)
    assert mgr.all_steps() == [3, 4]


def test_restore_rejects_shape_mismatch(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.zeros(4, 4)}, blocking=True)
    with pytest.raises(ValueError):
        mgr.restore(1, {"w": torch.zeros(8, 8)})
    with pytest.raises(KeyError):
        mgr.restore(1, {"u": torch.zeros(4, 4)})


def test_restore_latest_of_nothing(tmp_path):
    assert CheckpointManager(tmp_path).restore_latest(_tree()) is None


def test_restart_bitwise_equivalence(tmp_path):
    """Train 8 steps straight vs (train, crash at step 6, resume from the
    step-4 checkpoint and its data cursor, finish): the params are bitwise
    equal.  B = 8, S = 64 and two threads make the embedding's backward
    large enough to run in parallel on the host, where indexing's
    scatter would add a token's rows in any order."""
    torch.set_num_threads(2)
    cfg = reduced(get_config("internlm2-20b"))
    kw = dict(steps=8, batch=8, seq=64, ckpt_every=4, log_every=100,
              device="cpu")
    out_a = train(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    inj = FaultInjector((6,))
    with pytest.raises(RuntimeError, match="injected failure at step 6"):
        train(cfg, ckpt_dir=str(tmp_path / "b"), injector=inj, **kw)
    assert CheckpointManager(tmp_path / "b").latest_step() == 4
    out_b = train(cfg, ckpt_dir=str(tmp_path / "b"), injector=inj, **kw)
    for a, b in zip(leaves(out_a["params"]), leaves(out_b["params"])):
        assert torch.equal(a, b)
