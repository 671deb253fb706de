"""Each mix's calls drawn from a seed: the same seed the same inputs,
every seed the same work."""
import collections
import json
from pathlib import Path

import pytest
import torch

from bench.harness import traffic

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
PREFILL = sorted(p.stem for p in TRAFFIC.glob("*.json")
                 if json.loads(p.read_text())["kind"] == "prefill")
SEEDS = (0, 2 ** 31 + 5, -7, 3 ** 45)


def load(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


@pytest.mark.parametrize("name", PREFILL)
def test_prefill_blocks_hold_the_mix(name):
    t = load(name)
    want = collections.Counter({(e["batch"], e["seq"]): e["count"]
                                for e in t["block"]})
    n = sum(want.values())
    orders = set()
    for seed in SEEDS:
        plan = traffic.plan(t, 1000, seed, "cpu")
        for blk in range(3):
            got = collections.Counter(plan.shape(blk * n + j)
                                      for j in range(n))
            assert got == want
        orders.add(tuple(plan.shape(j) for j in range(2 * n)))
        budget = {b * s for b, s in want}
        assert len(budget) == 1, "every call carries the same tokens"
    assert len(orders) > 1, "the order depends on the seed"


@pytest.mark.parametrize("name", PREFILL)
def test_prefill_tokens_from_the_seed(name):
    t = traffic.resolve(load(name), smoke=True)
    a = traffic.plan(t, 512, 2 ** 31 + 9, "cpu")
    b = traffic.plan(t, 512, 2 ** 31 + 9, "cpu")
    c = traffic.plan(t, 512, 2 ** 31 + 10, "cpu")
    for i in range(5):
        ta, tb = a.batch(i)["tokens"], b.batch(i)["tokens"]
        assert a.shape(i) == b.shape(i)
        assert ta.shape == (a.shape(i)[1], a.shape(i)[0])
        assert torch.equal(ta, tb)
        assert int(ta.min()) >= 0 and int(ta.max()) < 512
    assert not torch.equal(a.batch(0)["tokens"], c.batch(0)["tokens"]) or \
        a.shape(0) != c.shape(0)
    warm = a.warm_batch(a.shape(0), 0)["tokens"]
    assert not torch.equal(warm, a.batch(0)["tokens"])


def test_train_batches_zipf_documents():
    t = traffic.resolve(load("train-32x2048"), smoke=True)
    vocab = 50280
    plan = traffic.plan(t, vocab, 2 ** 33 + 1, "cpu")
    b0, b1 = plan.batch(0), plan.batch(1)
    assert b0["tokens"].shape == (t["seq"], t["batch"])
    assert torch.equal(b0["labels"][:-1], b0["tokens"][1:])
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert torch.equal(b0["tokens"], traffic.plan(
        t, vocab, 2 ** 33 + 1, "cpu").batch(0)["tokens"])
    big = traffic.Tokens({"dist": "zipf"}, vocab, "cpu")
    rows = big.draw(11, (4096, 4))
    assert int(rows.min()) >= 0 and int(rows.max()) < vocab
    for col in range(4):                        # Zipf: a few ids dominate
        counts = torch.bincount(rows[:, col], minlength=vocab)
        top = counts.topk(10).values.sum().item() / 4096
        assert 0.15 < top < 0.45
    tops = {int(rows[:, c].bincount().argmax()) for c in range(4)}
    assert len(tops) > 1, "each row its own permutation"
