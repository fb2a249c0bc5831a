"""The one traffic generator: it reads a mix's parameters from
`benchmark/traffic/<mix>.json` and yields the requests of one closed-loop
client, drawn from the run's seed.

Requests come in cycles of `cycle`. Every cycle holds the same multiset of
sizes, evenly spread over each parameter's [low, high] range (prompt word
counts, music durations), in an order drawn from the seed, so that every
seed asks for the same work. `paired: true` orders a cycle's durations as
pairs of the k-th shortest and k-th longest, so that a window holding part
of a cycle asks for about the same work whatever the seed. Each request
gets a prompt drawn from the word list and a seed of its own. `greedy_every: n` makes every n-th request of a
cycle greedy (top_k 1), so that its tokens can be judged against the
reference's logits.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
WORDS = HERE.parent / "assets" / "words.txt"


def load(mix: str) -> dict:
    return json.loads((HERE / f"{mix}.json").read_text())


def _spread(lo_hi, n: int):
    lo, hi = lo_hi if isinstance(lo_hi, list) else (lo_hi, lo_hi)
    return np.rint(np.linspace(lo, hi, n)).astype(int)


def _paired(sizes, rng):
    """The sorted sizes as pairs of the k-th smallest and k-th largest, the
    pairs and the two in each in an order drawn from the seed: every two
    requests from a cycle's start ask for the same work."""
    n = len(sizes)
    pairs = [(sizes[i], sizes[n - 1 - i]) for i in range(n // 2)]
    flips = rng.integers(0, 2, n // 2)
    return [x for j in rng.permutation(n // 2) for x in (pairs[j][::-1] if flips[j] else pairs[j])]


def requests(spec: dict, seed: int, words=None):
    """Yield request dicts forever: {"index", "prompt", "seed", and the
    endpoint's parameters}."""
    words = words or WORDS.read_text().split()
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    n = spec["cycle"]
    index = 0
    while True:
        order = rng.permutation(n)
        lengths = _spread(spec["prompt_words"], n)[order]
        steps = None
        if spec.get("paired"):
            steps = _paired(_spread(spec["max_steps"], n), rng)
        elif "max_steps" in spec:
            steps = _spread(spec["max_steps"], n)[rng.permutation(n)]
        for i in range(n):
            req = {"index": index, "endpoint": spec["endpoint"],
                   "prompt": " ".join(rng.choice(words, size=int(lengths[i]))),
                   "seed": int(rng.integers(0, 1 << 30))}
            if spec["endpoint"] == "txt2img":
                req.update(width=spec["width"], height=spec["height"], steps=spec.get("steps"),
                           batch_size=spec["batch_size"])
            else:
                greedy = spec.get("greedy_every") and i % spec["greedy_every"] == 0
                req.update(max_steps=int(steps[i]), n_samples=spec["n_samples"],
                           top_k=1 if greedy else spec["top_k"], temperature=spec["temperature"],
                           guidance=spec["guidance"])
            yield req
            index += 1


def warmup(spec: dict, seed: int) -> list:
    """Requests of the mix's own shapes, from a stream apart from the
    measured one: for music the longest duration sampled as the mix samples
    (so the largest buffers are set up), then a short greedy one where the
    mix has greedy requests, so that every kernel the window launches has
    run once."""
    req = next(requests(dict(spec, cycle=1, paired=False, greedy_every=None), seed ^ 0x5EED))
    if "max_steps" not in spec:
        return [req]
    req["max_steps"] = int(_spread(spec["max_steps"], 2)[-1])
    return [req] + ([dict(req, max_steps=16, top_k=1)] if spec.get("greedy_every") else [])
