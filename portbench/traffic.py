"""The one traffic generator every mix file goes through.

A mix (``traffic/<mix>.json``) lists entries.  An entry's list-valued keys
expand by their product into items, and its ``weight`` is shared equally
by them.  Counts are made whole in the least block where every share is
exact, and the schedule repeats that block, shuffled anew from the seed
each time: every seed sends the same set of requests in another order, so
a seed changes no amount of work.
"""
from __future__ import annotations

import itertools
import math
import time
from fractions import Fraction
from typing import Dict, Iterator, List, Tuple

import numpy as np


def expand(entries: List[Dict]) -> List[Tuple[Dict, int]]:
    """(item, count in one block) for every item of every entry."""
    shares = []
    for entry in entries:
        entry = dict(entry)
        weight = Fraction(entry.pop("weight", 1))
        keys = [k for k, v in entry.items() if isinstance(v, list)]
        for combo in itertools.product(*(entry[k] for k in keys)):
            shares.append(({**entry, **dict(zip(keys, combo))}, weight))
        n_items = math.prod(len(entry[k]) for k in keys)
        shares[len(shares) - n_items:] = [
            (item, w / n_items) for item, w in shares[len(shares) - n_items:]]
    scale = math.lcm(*(s.denominator for _, s in shares))
    return [(item, int(s * scale)) for item, s in shares]


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the seed (``stream`` tells the uses
    apart); any whole seed, however large."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def schedule(counted: List[Tuple[Dict, int]], seed: int
             ) -> Iterator[Tuple[int, Dict]]:
    """(request index, item) forever: block after block, each a fresh
    permutation of the counted items."""
    block = np.repeat(np.arange(len(counted)), [c for _, c in counted])
    gen = rng(seed, 1)
    index = 0
    while True:
        for k in gen.permutation(block):
            yield index, counted[k][0]
            index += 1


def block_size(counted: List[Tuple[Dict, int]]) -> int:
    return sum(c for _, c in counted)


def timed(schedule: Iterator[Tuple[int, Dict]], seconds: float, block: int
          ) -> Iterator[Tuple[int, Dict]]:
    """The schedule until ``seconds`` have passed and a block is whole:
    every run sends whole blocks, the same set of requests whatever the
    seed."""
    t0 = time.perf_counter()
    for i, item in schedule:
        yield i, item
        if (i + 1) % block == 0 and time.perf_counter() - t0 >= seconds:
            return
