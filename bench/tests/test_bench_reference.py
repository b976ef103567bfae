"""The plain reference against ``repro_torch`` at a tiny size on the CPU:
the dense loss, its gradients and an AdamW step; RWKV-6's prefill then
decode against its full forward; the reference handed bfloat16 leaves
against the same leaves copied to float32 first."""
import numpy as np
import pytest
import torch

from bench.drivers.common import tree_map
from bench.program import arch, flat
from bench.reference import AdamW, make_params, model_for
from bench.tests import tiny


def _dense_cfg():
    return tiny.cell("internlm2-20b.train-4k")["cfg"]


def _rwkv_cfg():
    return tiny.cell("rwkv6-3b.serve-chat")["cfg"]


def _batch(V, S=32, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.integers(0, V, (2, S + 1)).astype(np.int32))
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def test_dense_loss_gradients_and_adamw_step():
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import Transformer
    from repro_torch.optim import adamw
    cfg = _dense_cfg()
    b = _batch(cfg["vocab"])
    model = Transformer(arch(cfg), use_pallas=True)
    p = make_params(cfg, 3, "cpu", torch.float32)
    ref = model_for(cfg)
    rp = make_params(cfg, 3, "cpu", torch.float32)
    keys = list(flat(rp))
    rl = [flat(rp)[k] for k in keys]
    for t in rl:
        t.requires_grad_(True)
    loss = ref.loss(rp, b["tokens"], b["labels"])
    grads = torch.autograd.grad(loss, rl)
    pl, _, pgrads = value_and_grad(model, p, b)
    assert float(pl) == pytest.approx(float(loss.detach()), rel=1e-6)
    pg = flat(pgrads)
    for k, g in zip(keys, grads):
        assert torch.allclose(pg[k], g, rtol=1e-4, atol=1e-6), k
    # one AdamW step each, from the same values, in float32
    opt = adamw()
    state = opt.init(p)
    step = make_train_step(model, opt)
    p2, state, _ = step(p, state, b)
    radam = AdamW(param_dtype=torch.float32)
    m, v = radam.init(rl)
    with torch.no_grad():
        radam.step(rl, grads, m, v)
    for k, t in zip(keys, rl):
        assert torch.allclose(flat(p2)[k].detach(), t, rtol=1e-5,
                              atol=1e-7), k
        assert torch.allclose(flat(state["m"])[k], m[keys.index(k)],
                              rtol=1e-4, atol=1e-9), k


def test_rwkv6_prefill_then_decode_against_the_full_forward():
    from repro_torch.models import Transformer
    cfg = _rwkv_cfg()
    model = Transformer(arch(cfg))
    p = make_params(cfg, 4, "cpu", torch.float32)
    toks = _batch(cfg["vocab"], S=12, seed=1)["tokens"]
    full = model_for(cfg).logits(make_params(cfg, 4, "cpu", torch.float32),
                                 toks)
    L = 7
    logits, cache = model.prefill(p, {"tokens": toks[:, :L]}, max_seq=16)
    got = [logits]
    for t in range(L, toks.shape[1]):
        pos = torch.full((2,), t, dtype=torch.int32)
        logits, cache = model.decode_step(p, cache, {"tokens": toks[:, t]},
                                          pos)
        got.append(logits)
    got = torch.stack(got, dim=1)
    want = full[:, L - 1:]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), \
        (got - want).abs().max()


def test_dense_serving_logits_against_the_full_forward():
    from repro_torch.models import Transformer
    cfg = _dense_cfg()
    model = Transformer(arch(cfg))
    p = make_params(cfg, 5, "cpu", torch.float32)
    toks = _batch(cfg["vocab"], S=10, seed=2)["tokens"]
    full = model_for(cfg).logits(make_params(cfg, 5, "cpu", torch.float32),
                                 toks)
    logits, cache = model.prefill(p, {"tokens": toks[:, :6]}, max_seq=16)
    assert torch.allclose(logits, full[:, 5], rtol=1e-4, atol=1e-4)
    for t in range(6, toks.shape[1]):
        pos = torch.full((2,), t, dtype=torch.int32)
        logits, cache = model.decode_step(p, cache, {"tokens": toks[:, t]},
                                          pos)
        assert torch.allclose(logits, full[:, t], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("precision", ["fp32", "fp8"])
@pytest.mark.parametrize("name", ["internlm2-20b.train-4k",
                                  "rwkv6-3b.serve-chat"])
def test_reference_in_the_served_type_is_the_fp32_reference(name,
                                                             precision):
    """Leaves cast as each layer reaches them give the logits of the tree
    copied whole to float32 first, bit for bit (the cast is exact), the
    fp8 control's too."""
    cfg = tiny.cell(name, dtype="bfloat16")["cfg"]
    p = make_params(cfg, 6, "cpu", torch.bfloat16)
    assert {t.dtype for t in flat(p).values()} == {torch.bfloat16}
    toks = _batch(cfg["vocab"], S=12, seed=3)["tokens"]
    ref = model_for(cfg, precision)
    with torch.no_grad():
        streamed = ref.logits(p, toks)
        whole = ref.logits(tree_map(lambda t: t.float(), p), toks)
    assert streamed.dtype == torch.float32
    assert torch.equal(streamed, whole)
