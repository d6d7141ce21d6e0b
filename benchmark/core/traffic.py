"""The one traffic generator: it reads a mix's parameters from
`benchmark/traffic/<name>.json` and yields the requests of one client
in a closed loop. One kind of mix so far:

- "descent": each request is a set of shape parameters. The run's seed
  draws the true parameters (`true`), from which the benchmark's
  reference makes the target, and a start (`start`) for every descent;
  after `restart_every` steps a descent restarts from a new start, and
  in between each request takes the parameters that the previous step
  returned.

A new kind is a class here with `next(prev)` and an entry in `KINDS`.
"""

from __future__ import annotations

import numpy as np


def _uniform(rng, lo_hi):
    lo, hi = lo_hi
    return float(rng.uniform(lo, hi))


class Descent:
    """The requests of a "descent" mix for one seed."""

    def __init__(self, mix: dict, seed: int):
        self.rng = np.random.default_rng(seed)
        self.every = int(mix["restart_every"])
        self.truth = {p: _uniform(self.rng, r) for p, r in mix["true"].items()}
        self.start = mix["start"]
        self.k = 0

    def next(self, prev=None) -> dict:
        if self.k % self.every == 0 or prev is None:
            params = {p: _uniform(self.rng, r) for p, r in self.start.items()}
        else:
            params = dict(prev["params"])
        self.k += 1
        return {"n": self.k - 1, "params": params}


KINDS = {"descent": Descent}


def make(mix: dict, seed: int):
    return KINDS[mix["kind"]](mix, seed)
