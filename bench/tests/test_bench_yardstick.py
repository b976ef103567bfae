"""The yardstick's counts against numbers worked out by hand."""
import pytest

from bench import harness, yardstick as Y

INTERNLM = harness.cell("internlm2-20b.train-4k")["cfg"]


def test_flash_forward_at_the_train_cell():
    # 4 · B · H · D · S(S+1)/2 with B=1, H=48, D=128, S=4096
    assert Y.flash_fwd_flops(1, 4096, 48, 128) == 4 * 48 * 128 * 8390656
    assert Y.flash_fwd_flops(1, 4096, 48, 128) == 206208761856
    # q, o: 4096·48·128 each; k, v: 4096·8·128 each; bf16
    assert Y.flash_fwd_bytes(1, 4096, 48, 8, 128) == 2 * 4096 * 128 * 112
    assert Y.flash_bwd_flops(1, 4096, 48, 128) == 2.5 * 206208761856
    assert Y.flash_bwd_bytes(1, 4096, 48, 8, 128) == 2 * 4096 * 128 * 224


def test_bound_is_the_larger_term():
    assert Y.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert Y.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    # causal flash at 4096 is compute-bound: 0.2085 ms
    b = Y.bound_s(Y.flash_fwd_flops(1, 4096, 48, 128),
                  Y.flash_fwd_bytes(1, 4096, 48, 8, 128))
    assert b == pytest.approx(206208761856 / 989e12)


def test_internlm2_cut_params_and_step_flops():
    # per layer: attention 88,080,384 + FFN 301,989,888 in products, and
    # 2 norms of 6,144; embedding and head 568,590,336 each; final norm
    assert Y.dense_matmul_params(INTERNLM) == 6 * 390070272 + 568590336
    assert Y.dense_params(INTERNLM) == \
        6 * (390070272 + 12288) + 2 * 568590336 + 6144
    assert Y.dense_params(INTERNLM) == 3477682176
    # 6·N·T + 12·H·D·(S/2)·T·L = 7.1490e13 + 3.7108e12
    flops = Y.train_step_flops(INTERNLM, 1, 4096)
    assert flops == 6 * 2909011968 * 4096 + 12 * 48 * 128 * 2048 * 4096 * 6
    assert flops == pytest.approx(7.5203e13, rel=1e-4)


def test_matches_the_program_params():
    from repro_torch.models import Transformer
    from bench.program import arch, flat
    params = flat(Transformer(arch(INTERNLM)).abstract_params())
    assert sum(t.numel() for t in params.values()) == \
        Y.dense_params(INTERNLM)
