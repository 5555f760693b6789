"""The one traffic generator: whole counts, the same schedule under the
same seed, the same set of requests under every seed."""
import collections
import itertools

import pytest

from portbench import traffic


def grid_counted(bench, cell="bplg.grid"):
    config = bench.config(bench.cell(cell))
    mix = [{"n": config["families"][e["family"]]["sizes"], **e}
           for e in bench.traffic(bench.cell(cell))["mix"]]
    return traffic.expand(mix)


def test_grid_block_gives_each_family_an_equal_share(bench):
    counted = grid_counted(bench)
    assert len(counted) == 24
    assert traffic.block_size(counted) == 1260
    share = collections.Counter()
    for item, count in counted:
        share[item["family"]] += count
    assert set(share.values()) == {420}


def test_prefill_block_follows_the_weights(bench):
    counted = traffic.expand(bench.traffic(bench.cell("mamba2.prefill"))
                             ["mix"])
    assert [(i["length"], c) for i, c in counted] == [(2048, 1)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_same_seed_same_schedule(bench, seed):
    counted = grid_counted(bench)
    a = [i["n"] for _, i in itertools.islice(traffic.schedule(counted, seed),
                                             3000)]
    b = [i["n"] for _, i in itertools.islice(traffic.schedule(counted, seed),
                                             3000)]
    assert a == b


def test_seeds_change_the_order_not_the_work(bench):
    counted = grid_counted(bench)
    n = traffic.block_size(counted)

    def block(seed):
        return [(i["family"], i["variant"], i["n"]) for _, i in
                itertools.islice(traffic.schedule(counted, seed), n)]
    a, b = block(1), block(2**31 + 1)
    assert a != b
    assert collections.Counter(a) == collections.Counter(b)


def test_rng_streams_differ_and_repeat():
    assert traffic.rng(5, 1).integers(1 << 30) == \
        traffic.rng(5, 1).integers(1 << 30)
    assert traffic.rng(5, 1).integers(1 << 30) != \
        traffic.rng(5, 2).integers(1 << 30)


def test_timed_closes_at_a_whole_block(bench):
    counted = traffic.expand(bench.traffic(bench.cell("mamba2.prefill"))
                             ["mix"])
    got = list(traffic.timed(traffic.schedule(counted, 3), 0.0, 10))
    assert [i for i, _ in got] == list(range(10))
