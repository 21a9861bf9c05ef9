"""Traffic is a function of the seed: the same seed gives the same
batches and requests, another seed other contents; a chat mix offers
every seed the same set of lengths and gaps, in another order, drawn as
the quantiles of the mix's distributions."""
from __future__ import annotations

import json

import numpy as np
import pytest

from perfbench_small_cells import BENCH, LM

from harness import common

SEED = 2 ** 31 + 12345
CHAT = json.loads((BENCH / "traffic" / "lmsys-chat.json").read_text())


def test_token_pool_deterministic():
    mix = {"generator": "token_pool", "batch": 3, "seq": 8, "pool": 2}
    make = common.generator(mix)
    a = make(mix, LM, SEED, 0.0, "cpu")
    b = make(mix, LM, SEED, 0.0, "cpu")
    c = make(mix, LM, 7, 0.0, "cpu")
    assert np.array_equal(a[1]["tokens"], b[1]["tokens"])
    assert not np.array_equal(a[0]["tokens"], c[0]["tokens"])
    assert np.array_equal(a[0]["tokens"][:, 1:], a[0]["labels"][:, :-1])
    assert a[0]["tokens"].max() < LM["vocab_size"]


def test_chat_same_work_every_seed_in_another_order():
    make = common.generator(CHAT)
    a = make(CHAT, LM, SEED, 30.0)
    b = make(CHAT, LM, SEED, 30.0)
    c = make(CHAT, LM, 99, 30.0)
    n = int(round(CHAT["rate_per_s"] * 30.0))
    assert len(a) == len(c) == n
    assert [r.arrival for r in a] == [r.arrival for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    for key in (lambda r: len(r.prompt), lambda r: r.gen):
        assert sorted(map(key, a)) == sorted(map(key, c))
        assert list(map(key, a)) != list(map(key, c))
    gaps = lambda rs: np.diff([0.0] + [r.arrival for r in rs])
    np.testing.assert_allclose(np.sort(gaps(a)), np.sort(gaps(c)))
    assert not np.allclose(gaps(a), gaps(c))
    assert a[-1].arrival == pytest.approx(30.0)
    assert all(x.arrival < y.arrival for x, y in zip(a, a[1:]))
    assert not np.array_equal(a[0].prompt, c[0].prompt)
    p, g = CHAT["prompt_tokens"], CHAT["gen_tokens"]
    assert all(p["min"] <= len(r.prompt) <= p["max"] for r in a)
    assert all(g["min"] <= r.gen <= g["max"] for r in a)
    assert all(r.prompt.max() < LM["vocab_size"] for r in a)


@pytest.mark.parametrize("kind", ["prompt_tokens", "gen_tokens"])
def test_chat_lengths_are_the_mix_quantiles(kind):
    """Many requests' lengths: the log-normal's median and mean (the
    source's), the clipped tail aside."""
    import importlib
    chat = importlib.import_module("traffic.chat")
    spec = CHAT[kind]
    x = chat.lengths(spec, 20000)
    median = spec["mean"] * np.exp(-0.5 * spec["sigma"] ** 2)
    assert np.median(x) == pytest.approx(median, rel=0.02)
    assert x.min() >= spec["min"] and x.max() <= spec["max"]
    unclipped = chat.lengths(dict(spec, min=0, max=10 ** 9), 20000)
    assert unclipped.mean() == pytest.approx(spec["mean"], rel=0.02)


@pytest.mark.parametrize("shape", [1.0, 0.25])
def test_chat_gaps_have_mean_one_and_the_shape_spread(shape):
    import importlib
    chat = importlib.import_module("traffic.chat")
    g = chat.gaps(shape, 20000)
    assert g.mean() == pytest.approx(1.0, rel=0.01)
    # a gamma of this shape has a coefficient of variation 1 / sqrt(shape)
    assert g.std() == pytest.approx(shape ** -0.5, rel=0.05)
