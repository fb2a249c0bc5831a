"""The traffic generator: the same seed gives the same requests, every
seed the same work in another order."""

import collections
import itertools

from benchmark.traffic import generator

BIG = 2 ** 31 + 12345  # seeds past 32 signed bits are allowed


def _take(mix, seed, n):
    return list(itertools.islice(generator.requests(generator.load(mix), seed), n))


def test_requests_repeat_by_seed():
    for mix in ("txt2img-1024-b4", "music-b4", "music-solo"):
        assert _take(mix, BIG, 40) == _take(mix, BIG, 40)
        assert _take(mix, BIG, 40) != _take(mix, BIG + 1, 40)


def test_every_seed_asks_for_the_same_work():
    for mix in ("txt2img-1024-b4", "music-b4"):
        cycle = generator.load(mix)["cycle"]

        def work(seed):
            reqs = _take(mix, seed, 3 * cycle)
            return collections.Counter((len(r["prompt"].split()), r.get("max_steps"), r.get("top_k")) for r in reqs
                                       if r.get("top_k", 0) != 1), sum(r.get("top_k") == 1 for r in reqs)

        words = {s: collections.Counter(len(r["prompt"].split()) for r in _take(mix, s, cycle)) for s in (1, BIG)}
        assert words[1] == words[BIG]
        if "max_steps" in generator.load(mix):
            steps = {s: sorted(r["max_steps"] for r in _take(mix, s, cycle)) for s in (1, BIG)}
            assert steps[1] == steps[BIG]
            assert work(1)[1] == work(BIG)[1] == 3 * cycle // generator.load(mix)["greedy_every"]


def test_mix_shapes():
    r = _take("txt2img-1024-b4", 7, 1)[0]
    assert (r["width"], r["height"], r["steps"], r["batch_size"]) == (1024, 1024, 4, 4)
    steps = [r["max_steps"] for r in _take("music-b4", 7, 8)]
    assert min(steps) == 250 and max(steps) == 750
    assert {r["max_steps"] for r in _take("music-solo", 7, 8)} == {500}
    warm = generator.warmup(generator.load("music-b4"), 7)
    assert [(w["max_steps"], w["top_k"], w["n_samples"]) for w in warm] == [(750, 250, 4), (16, 1, 4)]
    (warm,) = generator.warmup(generator.load("txt2img-1024-b4"), 7)
    assert (warm["width"], warm["batch_size"], warm["steps"]) == (1024, 4, 4)
    assert all(2 <= len(r["prompt"].split()) <= 11 for r in _take("music-b4", BIG, 64))


def test_paired_durations_even_out_every_two_requests():
    reqs = _take("music-b4", BIG, 32)
    sums = {a["max_steps"] + b["max_steps"] for a, b in zip(reqs[::2], reqs[1::2])}
    assert sums == {1000}
    assert sorted(r["max_steps"] for r in reqs[:8]) == [250, 321, 393, 464, 536, 607, 679, 750]
