"""The traffic generator: determinism per seed, the mix's proportions,
the same work under every seed."""
import numpy as np
import pytest

from bench import harness, traffic

CHAT = harness.cell("rwkv6-3b.serve-chat")["work"]["traffic"]


def test_same_seed_same_requests():
    a = traffic.serve_requests(CHAT, 65536, 30, 2 ** 33 + 1)
    b = traffic.serve_requests(CHAT, 65536, 30, 2 ** 33 + 1)
    assert [(r["arrival_s"], r["max_new_tokens"], r["prompt"].tolist())
            for r in a] == [(r["arrival_s"], r["max_new_tokens"],
                             r["prompt"].tolist()) for r in b]


def test_seeds_share_the_work_in_another_order():
    # the schedule's seed reorders the same lengths and arrival gaps
    a = traffic.serve_requests(dict(CHAT, order_seed=1), 65536, 30, 1)
    b = traffic.serve_requests(dict(CHAT, order_seed=2), 65536, 30, 1)
    for key in ("max_new_tokens",):
        assert sorted(r[key] for r in a) == sorted(r[key] for r in b)
        assert [r[key] for r in a] != [r[key] for r in b]
    assert sorted(len(r["prompt"]) for r in a) == \
        sorted(len(r["prompt"]) for r in b)
    ga = np.sort(np.diff([0.0] + [r["arrival_s"] for r in a]))
    gb = np.sort(np.diff([0.0] + [r["arrival_s"] for r in b]))
    assert np.allclose(ga, gb)


def test_an_order_seed_fixes_the_schedule_and_not_the_tokens():
    p = dict(CHAT, order_seed=5)
    a = traffic.serve_requests(p, 65536, 30, 1)
    b = traffic.serve_requests(p, 65536, 30, 2)
    assert [(r["arrival_s"], r["max_new_tokens"], len(r["prompt"]))
            for r in a] == [(r["arrival_s"], r["max_new_tokens"],
                             len(r["prompt"])) for r in b]
    assert a[0]["prompt"].tolist() != b[0]["prompt"].tolist()


@pytest.mark.parametrize("key,mix", [("prompt", "prompt_lens"),
                                     ("max_new_tokens", "output_lens")])
def test_mix_proportions(key, mix):
    reqs = traffic.serve_requests(CHAT, 65536, 40, 7)
    n = len(reqs)
    assert n == round(CHAT["rate_rps"] * 40)
    vals = [len(r[key]) if key == "prompt" else r[key] for r in reqs]
    for v, w in CHAT[mix]:
        assert abs(vals.count(v) - w * n) <= 1


def test_poisson_rate_and_window():
    reqs = traffic.serve_requests(dict(CHAT, rate_rps=10.0), 100, 20, 3)
    t = [r["arrival_s"] for r in reqs]
    assert len(t) == 200 and t == sorted(t)
    assert 18.0 < t[-1] < 22.0
    assert all(0 <= int(x) < 100 for r in reqs for x in r["prompt"])


def test_on_off_bursts_keep_the_mean_rate():
    p = dict(CHAT, rate_rps=4.0, on_s=1.0, off_s=3.0)
    t = traffic.arrivals(p, 400, np.random.default_rng(0))
    assert np.all(np.mod(t, 4.0) < 1.0)        # nothing in off periods
    assert 90 < t[-1] < 110                    # 400 requests at 4/s


def test_token_batches():
    src = traffic.TokenBatches({"batch": 2, "seq": 16}, 50, 9)
    a, b = src.batch_at(0), src.batch_at(1)
    assert a["tokens"].shape == (2, 16) and a["tokens"].dtype == np.int32
    assert np.array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert not np.array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"][0], a["tokens"][1])
    assert np.array_equal(src.batch_at(0)["tokens"], a["tokens"])
    assert src.tokens_per_step == 32
