"""The readers of a sharded cell, rank by rank: the exchange's device ms
(the least rank's NCCL time a step) and the ranks' wait share on
hand-made per-rank traces, read in four threads that gather as the ranks
do; a rank's share of the lazy update counted from the whole batch's ids
in its blocks of the tables; and the one-card reading of K8's roofline
unchanged on a saved trace."""

from __future__ import annotations

import json
import os
import threading

import pytest

from conftest import tiny_cell

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


class _Group:
    """``gather`` over ``n`` threads, as the harness's gloo group gathers
    over the ranks: each gets every rank's value in rank order."""

    def __init__(self, n: int):
        self.values = [None] * n
        self.barrier = threading.Barrier(n, timeout=30)

    def gather_for(self, rank: int):
        def gather(value):
            self.values[rank] = value
            self.barrier.wait()
            out = list(self.values)
            self.barrier.wait()
            return out
        return gather


ALL_TO_ALL = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"
ALL_REDUCE = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage)"


def _events(collectives, other_us=50.0, names=(ALL_TO_ALL, ALL_REDUCE)):
    """A rank's device trace of two steps: per step one 'other' kernel and
    the step's collectives, ``collectives`` (µs, in the order they ran,
    two a step), with ``names`` in turn."""
    events, t = [], 0.0
    for step in range(2):
        kernels = [("void at::native::elementwise_kernel<128, 2>(int, Func)", other_us)]
        kernels += [(names[i], collectives[2 * step + i]) for i in range(2)]
        for name, dur in kernels:
            events.append({"ph": "X", "cat": "kernel", "name": name, "ts": t, "dur": dur})
            t += dur + 10.0
    return events


# each rank's four collectives (µs): the last to join, who reads the
# transfer alone, is rank 1, 3, 0 and 2 in turn; transfer 100 + 40 + 100
# + 40 = 280 µs over 2 steps
RANKS = [[300.0, 90.0, 100.0, 60.0],
         [100.0, 50.0, 400.0, 80.0],
         [200.0, 70.0, 250.0, 40.0],
         [500.0, 40.0, 300.0, 45.0]]


def _read_on_ranks(metric: str, traces):
    """``metric`` read on len(traces) ranks at once, rank r's trace
    ``traces[r]`` (events); each rank's reading."""
    from harness import cells
    from harness.runner import Run
    from harness.trace import Trace

    cell = tiny_cell("autoint.train")
    n = len(traces)
    group = _Group(n)
    out = [None] * n

    def rank(r):
        run = Run(cell.m, "train", cell.counts, Trace(traces[r]), [{}, {}], 0.01,
                  n, r, group.gather_for(r))
        out[r] = cells.load("autoint.train.dp4").reader(metric).read(run)

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    return out


def test_exchange_ms_sums_each_collectives_least_rank():
    """0.14 ms a step: the least of each collective over the ranks, not
    the least rank's total (rank 2: 0.28 ms a step)."""
    got = _read_on_ranks("exchange_ms.train", [_events(c) for c in RANKS])
    assert got == pytest.approx([0.14] * 4)


def test_rank_wait_share_is_the_mean_wait_over_the_traced_step():
    """A rank's wait is its NCCL time less the transfer (280 µs over the
    two steps), over its traced step (its window over 2 steps: 50 µs of
    other kernels, its collectives and 30 µs of gaps a step, less the
    last gap); the mean over the ranks."""
    got = _read_on_ranks("rank_wait_share.train", [_events(c) for c in RANKS])
    waits = [(sum(c) - 280.0) / 2 for c in RANKS]
    steps = [(2 * (50.0 + 30.0) + sum(c) - 10.0) / 2 for c in RANKS]
    want = 100.0 * sum(w / s for w, s in zip(waits, steps)) / 4
    assert got == pytest.approx([want] * 4)


def test_no_nccl_kernel_no_exchange_metric():
    traces = [_events([0.0] * 4, names=("void other_kernel()", "void other_kernel()")),
              _events(RANKS[1])]
    assert _read_on_ranks("exchange_ms.train", traces) == [None, None]
    assert _read_on_ranks("rank_wait_share.train", traces) == [None, None]


def test_collectives_that_do_not_pair_up_read_nothing():
    """Ranks whose NCCL kernels differ in name or number in order cannot
    be read collective by collective: no metric."""
    swapped = [_events(RANKS[0]), _events(RANKS[1], names=(ALL_REDUCE, ALL_TO_ALL))]
    assert _read_on_ranks("exchange_ms.train", swapped) == [None, None]
    fewer = [_events(RANKS[0]), _events(RANKS[1])[:-1]]
    assert _read_on_ranks("rank_wait_share.train", fewer) == [None, None]


def test_one_card_reads_no_exchange():
    from harness import cells
    from harness.runner import Run
    from harness.trace import Trace

    cell = tiny_cell("autoint.train")
    run = Run(cell.m, "train", cell.counts, Trace(_events(RANKS[0])), [{}], 0.01, 1)
    for metric in ("exchange_ms.train", "rank_wait_share.train"):
        assert cells.load("autoint.train.dp4").reader(metric).read(run) is None


def test_table_blocks_are_the_programs_storage_blocks():
    """A rank's block of a table is a quarter of the storage the program
    keeps it in: 265,000 rows of 8 padded to 265,216 on 4 ranks (to 4 x
    lcm(16, 14)), 66,304 rows a rank; the whole table without a shard."""
    from harness import peaks

    assert peaks.storage_rows(265000, 8, 4) == 265216
    assert peaks.storage_rows(265000, 8, 1) == 265104
    assert [peaks.table_shard(265000, 8, (r, 4)) for r in range(4)] == [
        (r * 66304, 66304) for r in range(4)]
    assert peaks.storage_rows(1000, 128, 4) == 1000
    assert peaks.table_shard(10, 8, None) == (0, 10)


def test_storage_rows_are_the_programs():
    """``storage_rows`` agrees with the program's engine on the rows of a
    table stored alone, packed, on 1, 2 and 4 ranks."""
    from recommendsystem_tpu_torch.embedding.engine import EmbeddingFeatures
    from recommendsystem_tpu_torch.embedding.feature_column import (category_column,
                                                                     embedding_column)
    from harness import peaks

    for rows, dim in ((265000, 8), (81920, 32), (1000, 4), (777, 127), (777, 200)):
        for world in (1, 2, 4):
            col = embedding_column(category_column("t", rows), dim, combiner="mean", name="s")
            eng = EmbeddingFeatures([col], num_shards=world)
            assert eng.storage["t"][0] == peaks.storage_rows(rows, dim, world), (rows, dim, world)


@pytest.mark.parametrize("name", ["autoint.train", "staytime.train"])
def test_shard_counts_add_up_to_the_whole_count(name):
    """Each rank's lazy update counts the whole batch's live rows in its
    blocks and its blocks' rows: over the ranks, the one-card count's
    operations, and its bytes with 4 bytes more for each row of padding
    the ranks' storages add to a table.  staytime keeps its tables two
    to a storage, which the shard count does not follow: none."""
    from harness import peaks
    from harness.traffic import Traffic

    cell = tiny_cell(name)
    gen = Traffic(cell.model, cell.m, cell.traffic, 2 ** 31 + 77, "cpu")
    whole = gen.batch(0, 256)
    one = cell.counts.kernel(cell.m, "sparse_update", whole)
    parts = [cell.counts.kernel(cell.m, "sparse_update", whole, shard=(r, 4)) for r in range(4)]
    assert cell.counts.kernel(cell.m, "field_attention_bwd", whole, shard=(0, 4)) is None
    if name == "staytime.train":
        assert parts == [None] * 4 and one is not None
        return
    rows, dim = cell.m["bucket_size"], cell.m["dim"]
    pad = 4 * (peaks.storage_rows(rows, dim, 4) - rows) * len(cell.m["slots"])
    assert (sum(p[0] for p in parts), sum(p[1] for p in parts)) == (one[0] + pad, one[1])
    assert len(set(parts)) > 1


def test_one_card_k8_reading_is_unchanged_on_a_saved_trace():
    """The one-card reader gives what it gave before it read shards: 100
    x the least time of two tiny steps' K8 work over the saved trace's 8 µs
    of K8 (5.436223880597015, the value before)."""
    from harness import cells
    from harness.runner import Run
    from harness.trace import Trace
    from harness.traffic import Traffic

    cell = tiny_cell("autoint.train")
    gen = Traffic(cell.model, cell.m, cell.traffic, 2 ** 31 + 5171, "cpu")
    with open(os.path.join(DATA, "k8_trace.json")) as f:
        trace = Trace(json.load(f)["traceEvents"])
    run = Run(cell.m, "train", cell.counts, trace, [gen.batch(i, 64) for i in range(2)], 0.01, 1)
    got = cells.load("autoint.train").reader("sparse_update_roofline.train").read(run)
    assert got == 5.436223880597015


def test_exchange_kernels_count_as_idle():
    """The device idle share counts the NCCL kernels, which spin while a
    rank waits, as idle; the trace's busy time still holds them.  Two
    steps of 50 µs of other work in a window of 2 x (80 + 400) - 10 µs."""
    from harness import cells
    from harness.runner import Run
    from harness.trace import Trace

    cell = tiny_cell("autoint.train")
    trace = Trace(_events([300.0, 100.0, 300.0, 100.0]))
    run = Run(cell.m, "train", cell.counts, trace, [{}, {}], 0.01, 1)
    got = cells.load("autoint.train").reader("device_idle_share.train").read(run)
    assert got == pytest.approx(100.0 * (1.0 - 100.0 / 950.0))
    assert trace.busy_s == pytest.approx(900e-6)
