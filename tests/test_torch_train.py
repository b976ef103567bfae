"""The port's training path against the reference's, on ``reduced()``
configs with the same weights (the reference's init, carried across by
``params_from_numpy``) and the same ``SyntheticLM`` batches:
``make_train_step`` for all ten archs, with flash on reduced
qwen2.5-14b, the kernels without a backward raising in both packages,
``build_cell`` with gradient accumulation, the per-layer recompute, and
the driver (``launch.train``) and its benchmark.

Tolerances: losses within 1e-4 relative each step; params within 1e-4
normwise (‖Δ‖/‖p‖ over the whole tree) after three steps.  AdamW's
first steps move each param by about lr·sign(g), so a gradient near 0 in
both packages can move a param apart by 2·lr: elementwise comparison
would fail for no fault.
"""
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeSpec as RefShapeSpec
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.launch.steps import build_cell as ref_build_cell
from repro.launch.steps import input_specs as ref_input_specs
from repro.launch.train import make_train_step as ref_make_train_step
from repro.models import Transformer as RefTransformer
from repro.optim import default_optimizer as ref_default_optimizer
from repro_torch.configs import ALL_ARCHS, SHAPES, ShapeSpec, get_config
from repro_torch.configs import reduced
from repro_torch.data import SyntheticLM
from repro_torch.launch import steps
from repro_torch.launch.train import main, make_train_step, train
from repro_torch.models import Transformer, params_from_numpy
from repro_torch.optim import default_optimizer
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tuple(cfg.name for cfg in ALL_ARCHS)
LOSS_RTOL = 1e-4
PARAM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These steps are made of small ops: one intra-op thread runs them
    fastest, and keeps the file fast beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _numpy_params(name: str):
    cfg = ref_reduced(ref_get_config(name))
    return jax.tree.map(np.asarray,
                        RefTransformer(cfg).init(jax.random.key(0)))


def _batches(name, n=3, B=2, S=32):
    src = SyntheticLM(reduced(get_config(name)), B, S, seed=1)
    return [src.batch_at(i) for i in range(n)]


def _normwise(ref_tree, port_tree) -> float:
    num = den = 0.0
    for a, t in zip(jax.tree.leaves(ref_tree), leaves(port_tree)):
        a = np.asarray(a, np.float64)
        num += float(((a - t.detach().double().numpy()) ** 2).sum())
        den += float((a ** 2).sum())
    return (num / den) ** 0.5


def _run_both(name, use_pallas=False):
    """Three steps of each package's ``make_train_step`` from the same
    weights.  Returns the (ref, port) losses and the final trees."""
    jcfg, cfg = ref_reduced(ref_get_config(name)), reduced(get_config(name))
    tree = _numpy_params(name)
    rp = jax.tree.map(jnp.asarray, tree)
    ropt = ref_default_optimizer(jcfg)
    rs = ropt.init(rp)
    rstep = ref_make_train_step(RefTransformer(jcfg, use_pallas=use_pallas),
                                ropt)
    tp = params_from_numpy(tree, "cpu")
    topt = default_optimizer(cfg)
    assert topt.name == ropt.name
    ts = topt.init(tp)
    tstep = make_train_step(Transformer(cfg, use_pallas=use_pallas), topt)
    losses = []
    for b in _batches(name):
        rp, rs, rm = rstep(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tstep(tp, ts, {k: torch.from_numpy(v)
                                    for k, v in b.items()})
        losses.append((float(rm["loss"]), float(tm["loss"])))
        assert float(tm["ce"]) == pytest.approx(float(rm["ce"]),
                                                rel=LOSS_RTOL)
    return losses, (rp, rs), (tp, ts)


@pytest.mark.parametrize("name", ARCHS)
def test_train_step_matches_reference(name):
    losses, (rp, rs), (tp, ts) = _run_both(name)
    for want, got in losses:
        assert np.isfinite(got)
        assert got == pytest.approx(want, rel=LOSS_RTOL)
    assert _normwise(rp, tp) <= PARAM_TOL
    assert _normwise(rs, ts) <= PARAM_TOL * 10   # v ~ g², m ~ g: noisier
    assert int(ts["step"]) == 3


def test_train_step_with_flash_matches_reference():
    """Reduced qwen2.5-14b with ``use_pallas=True``: the reference's flash
    in interpret mode with its ``custom_vjp``, the port's flash Function
    on its plain forward with the same blockwise backward."""
    losses, (rp, _), (tp, _) = _run_both("qwen2.5-14b", use_pallas=True)
    for want, got in losses:
        assert got == pytest.approx(want, rel=LOSS_RTOL)
    assert _normwise(rp, tp) <= PARAM_TOL
    plain = _run_both("qwen2.5-14b")[0]
    for (_, a), (_, b) in zip(losses, plain):
        assert a == pytest.approx(b, rel=LOSS_RTOL)


@pytest.mark.parametrize("name", ["rwkv6-3b", "recurrentgemma-2b"])
def test_kernels_without_backward_raise_in_both(name):
    """wkv6 and rglru_scan have no backward in the reference: its
    ``jax.grad`` through them raises, and so does the port's loss under
    grad, instead of returning gradients that skip the kernels."""
    jcfg, cfg = ref_reduced(ref_get_config(name)), reduced(get_config(name))
    b = _batches(name, n=1)[0]
    rp = jax.tree.map(jnp.asarray, _numpy_params(name))
    with pytest.raises(AssertionError):
        jax.value_and_grad(RefTransformer(jcfg, use_pallas=True).loss,
                           has_aux=True)(rp, {k: jnp.asarray(v)
                                              for k, v in b.items()})
    tp = params_from_numpy(_numpy_params(name), "cpu")
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    step = make_train_step(Transformer(cfg, use_pallas=True),
                           default_optimizer(cfg))
    with pytest.raises(NotImplementedError, match="use_pallas=False"):
        step(tp, default_optimizer(cfg).init(tp), tb)
    # the forward alone runs the kernels, as before
    fresh = params_from_numpy(_numpy_params(name), "cpu")
    loss, _ = Transformer(cfg, use_pallas=True).loss(fresh, tb)
    assert np.isfinite(float(loss))


def test_build_cell_grad_accum_matches_reference():
    """``grad_accum=2`` against the reference's cell on a 1×1
    ("data", "model") mesh of the one CPU device."""
    name = "internlm2-20b"
    jcfg, cfg = ref_reduced(ref_get_config(name)), reduced(get_config(name))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ref_cell = ref_build_cell(jcfg, RefShapeSpec("t", "train", 32, 4), mesh,
                              grad_accum=2)
    cell = steps.build_cell(cfg, ShapeSpec("t", "train", 32, 4),
                            grad_accum=2)
    assert cell.donate == (0, 1)
    assert cell.meta["optimizer"] == ref_cell.meta["optimizer"] == "adamw"
    rfn = ref_cell.jitted()
    rp = jax.tree.map(jnp.asarray, _numpy_params(name))
    rs = ref_default_optimizer(jcfg).init(rp)
    tp = params_from_numpy(_numpy_params(name), "cpu")
    ts = default_optimizer(cfg).init(tp)
    src = SyntheticLM(cfg, 4, 32, seed=2)
    for i in range(2):
        b = src.batch_at(i)
        rp, rs, rm = rfn(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = cell.fn(tp, ts, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=LOSS_RTOL)
        assert float(tm["ce"]) == pytest.approx(float(rm["ce"]),
                                                rel=LOSS_RTOL)
        assert float(tm["aux"]) == float(rm["aux"]) == 0.0
    assert _normwise(rp, tp) <= PARAM_TOL


def test_grad_accum_equals_one_batch():
    """Two micro-batches of two rows: the same loss and gradient as the
    batch of four at once, to fp32 rounding."""
    cfg = reduced(get_config("qwen2.5-14b"))
    model = Transformer(cfg)
    b = {k: torch.from_numpy(v) for k, v in
         SyntheticLM(cfg, 4, 32, seed=3).batch_at(0).items()}
    one = steps.value_and_grad(model, params_from_numpy(
        _numpy_params("qwen2.5-14b"), "cpu"), b)
    two = steps.value_and_grad(model, params_from_numpy(
        _numpy_params("qwen2.5-14b"), "cpu"), b, grad_accum=2)
    assert float(two[0]) == pytest.approx(float(one[0]), rel=1e-6)
    for g1, g2 in zip(leaves(one[2]), leaves(two[2])):
        assert g2.dtype == torch.float32
        torch.testing.assert_close(g2, g1, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["qwen2.5-14b", "recurrentgemma-2b",
                                  "rwkv6-3b", "qwen3-moe-30b-a3b"])
def test_per_layer_recompute_changes_no_gradient(name, monkeypatch):
    """Each layer (griffin: period and tail layer) runs under
    ``torch.utils.checkpoint`` when autograd records, as the reference's
    per-layer ``jax.checkpoint``: the gradients are bitwise those of
    keeping every activation (the checkpoint replaced by a plain call)."""
    from repro_torch.models import transformer as tr
    cfg = reduced(get_config(name))
    b = {k: torch.from_numpy(v) for k, v in _batches(name, 1)[0].items()}
    calls = []

    def plain_call(fn, *args, **kw):
        calls.append(fn)
        return fn(*args)
    grads = []
    for recompute in (True, False):
        if not recompute:
            monkeypatch.setattr(tr, "checkpoint", plain_call)
        p = params_from_numpy(_numpy_params(name), "cpu")
        loss, _, g = steps.value_and_grad(Transformer(cfg), p, b)
        grads.append((loss, leaves(g)))
    kinds = cfg.layer_kinds()
    assert len(calls) == (kinds.count("attn") + cfg.n_layers % 3
                          if cfg.layer_pattern == "griffin"
                          else cfg.n_layers)
    assert torch.equal(grads[0][0], grads[1][0])
    for a, c in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, c)


def test_loss_builds_no_graph_without_grad():
    cfg = reduced(get_config("recurrentgemma-2b"))
    params = Transformer(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    b = {k: torch.from_numpy(v) for k, v in
         _batches("recurrentgemma-2b", 1)[0].items()}
    loss, metrics = Transformer(cfg, use_pallas=True).loss(params, b)
    assert loss.grad_fn is None and not loss.requires_grad
    for p in leaves(params):
        p.requires_grad_(True)
    loss, _ = Transformer(cfg).loss(params, b)
    assert loss.grad_fn is not None
    with torch.no_grad():
        loss, _ = Transformer(cfg, use_pallas=True).loss(params, b)
    assert loss.grad_fn is None


def test_train_loss_decreases():
    """The reference's ``test_train_loss_decreases`` on the port: CE on
    the learnable synthetic stream drops by > 0.15 nats over 120 steps
    (best of the last four logs against the first)."""
    import tempfile
    cfg = reduced(get_config("internlm2-20b"))
    with tempfile.TemporaryDirectory() as d:
        out = train(cfg, steps=120, batch=8, seq=64, ckpt_dir=d,
                    ckpt_every=1000, log_every=10, device="cpu")
    losses = [v for _, v in out["losses"]]
    assert min(losses[-4:]) < losses[0] - 0.15, losses


@pytest.mark.parametrize("shape", sorted(REF_SHAPES))
@pytest.mark.parametrize("name", ["qwen2.5-14b", "musicgen-large"])
def test_input_specs_match_reference(name, shape):
    want = ref_input_specs(ref_get_config(name), REF_SHAPES[shape])
    got = steps.input_specs(get_config(name), SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).replace("torch.", "") == \
            str(want[k].dtype), k


def test_cell_abstract_args_match_reference_trees():
    cfg = get_config("qwen2.5-14b")
    cell = steps.build_cell(cfg, SHAPES["train_4k"])
    aparams, aopt, abatch = cell.args_abstract
    want = RefTransformer(ref_get_config("qwen2.5-14b")).abstract_params()
    got = leaves(aparams)
    assert [tuple(t.shape) for t in got] == \
        [w.shape for w in jax.tree.leaves(want)]
    assert all(t.device.type == "meta" for t in got + leaves(aopt))
    assert sorted(aopt) == ["m", "step", "v"]


def test_prefill_and_decode_cells():
    """The serving cells are the model's prefill and decode_step with a
    greedy argmax."""
    cfg = reduced(get_config("qwen2.5-14b"))
    params = params_from_numpy(_numpy_params("qwen2.5-14b"), "cpu")
    tokens = torch.from_numpy(_batches("qwen2.5-14b", 1)[0]["tokens"])
    pre = steps.build_cell(cfg, ShapeSpec("p", "prefill", 48, 2))
    logits, cache = pre.fn(params, {"tokens": tokens})
    want, _ = Transformer(cfg).prefill(params, {"tokens": tokens},
                                       max_seq=48)
    assert torch.equal(logits, want)
    dec = steps.build_cell(cfg, ShapeSpec("d", "decode", 48, 2))
    assert dec.donate == (1,)
    pos = torch.full((2,), 32, dtype=torch.int32)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    tok, cache = dec.fn(params, cache, {"tokens": nxt}, pos)
    assert tok.dtype == torch.int32 and tok.shape == (2,)


@pytest.mark.parametrize("kw", [{"moe_ep": True}, {"fsdp_layers": True},
                                {"seq_shard": True}, {"mesh": object()}])
def test_mesh_cells_wait_for_the_mesh(kw):
    """The sharding options need a mesh, and a mesh is a DeviceMesh
    (the mesh cells themselves: tests/test_torch_mesh.py)."""
    err = TypeError if "mesh" in kw else ValueError
    with pytest.raises(err, match="mesh"):
        steps.build_cell(reduced(get_config("qwen2.5-14b")),
                         ShapeSpec("t", "train", 32, 2), **kw)


def test_lower_waits_for_the_mesh():
    """Off a mesh, ``lower`` traces the step on ``meta`` tensors: the
    per-device bytes and FLOPs of one device, no collective."""
    cfg = reduced(get_config("qwen2.5-14b"))
    cell = steps.build_cell(cfg, ShapeSpec("t", "train", 32, 2))
    low = cell.lower()
    n_params = sum(p.numel() for p in leaves(cell.args_abstract[0]))
    assert low["param_bytes"] == 4 * n_params
    assert low["opt_bytes"] == 8 * n_params + 4     # m, v fp32 + the step
    assert low["collectives"] == [] and low["flops"] > 0


def test_main_restarts_and_finishes(tmp_path, capsys):
    out = main(["--arch", "rwkv6-3b", "--reduced", "--steps", "6",
                "--batch", "2", "--seq", "16", "--ckpt-every", "2",
                "--ckpt-dir", str(tmp_path), "--fail-at", "3",
                "--device", "cpu"])
    text = capsys.readouterr().out
    assert "FAILURE (injected failure at step 3)" in text
    assert "resumed from step 2" in text and "restarts=1" in text
    assert out["final_step"] == 6


def test_train_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: train runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(reduced(get_config("internlm2-20b")), steps=1, batch=1,
              seq=8, ckpt_dir=str(tmp_path))


def test_train_overlap_benchmark_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tc"))
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        import port_train_overlap as bench
    finally:
        sys.path.pop(0)
    r = bench.run(device="cpu", steps=2)
    assert r["t_sync_ms"] > 0 and r["t_planned_ms"] > 0
    assert np.isfinite(r["final_loss"])
    e = bench.run_plan_executor(n_steps=4, reps=1, device="cpu")
    assert e["auto_candidates"] > 0 and e["t_auto_ms"] > 0
    assert e["speedup_compiled"] > 0 and not e["auto_cache_hit"]


def test_a_step_leaves_nothing_to_the_cyclic_collector():
    """With the cyclic garbage collector off, a train step frees its
    gradients and temporaries as it returns: nothing of it waits in a
    reference cycle (which on a card would hold a step's gradients, 4 GB
    at qwen2.5-14b's 2 layers, until the collector ran)."""
    import gc
    cfg = reduced(get_config("qwen2.5-14b"))
    params = params_from_numpy(_numpy_params("qwen2.5-14b"), "cpu")
    opt = default_optimizer(cfg)
    state = opt.init(params)
    step = make_train_step(Transformer(cfg, use_pallas=True), opt)
    batch = {k: torch.from_numpy(v) for k, v in
             _batches("qwen2.5-14b", 1)[0].items()}

    def live():
        return sum(o.numel() for o in gc.get_objects()
                   if isinstance(o, torch.Tensor))
    step(params, state, batch)          # the first step sets requires_grad
    gc.collect()
    gc.disable()
    try:
        before = live()
        out = step(params, state, batch)
        del out
        assert live() == before
    finally:
        gc.enable()
