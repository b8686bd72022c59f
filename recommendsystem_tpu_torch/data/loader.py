"""Dataset pipeline: files -> per-worker shard -> interleave -> batch ->
parse -> prefetch -> device.

Counterpart of ``recommendsystem_tpu/data/loader.py``, which replaces
``tn.data.list_files`` + the tf.data graph of ``staytime/parse.py:73-92``:
date-partitioned file listing, worker sharding
(``ds.shard(tn.core.shard_num(), tn.core.self_shard_id())``), cycle/block
interleave of TFRecord shards, batching, a parse map, and a background
prefetch thread.

The copy to the card is the port's own: under JAX the parse emits numpy and
``jit`` copies the arguments, while the port's steps take tensors on the
bundle's device.  ``dataset_reader(..., device="cuda")`` pins each parsed
batch in the prefetch thread and copies it with ``non_blocking=True`` on the
consumer's current stream when the consumer takes it, so the copy overlaps
the card's work and neither side waits for the card.
"""

from __future__ import annotations

import fnmatch
import os
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import torch

from ..core.device import resolve_device
from ..core.mesh import process_count, process_index
from ..embedding.engine import IdBatch
from .tfrecord import read_tfrecord


def list_files(data_dir: str, days: Optional[Sequence[str]] = None,
               match_pattern: str = "*") -> List[str]:
    """Date-partitioned listing: ``data_dir/<day>/<files>`` (tn.data.list_files).

    With ``days=None`` lists ``data_dir`` itself.  Sorted for determinism.
    """
    out: List[str] = []
    if days:
        for day in days:
            day_dir = os.path.join(data_dir, str(day))
            if not os.path.isdir(day_dir):
                continue
            for name in sorted(os.listdir(day_dir)):
                if fnmatch.fnmatch(name, match_pattern):
                    out.append(os.path.join(day_dir, name))
    else:
        for name in sorted(os.listdir(data_dir)):
            if fnmatch.fnmatch(name, match_pattern):
                out.append(os.path.join(data_dir, name))
    return out


def shard_files(files: Sequence[str], num_shards: Optional[int] = None,
                index: Optional[int] = None) -> List[str]:
    """Worker-rank file sharding, the data-parallel boundary
    (``staytime/parse.py:77-79``): file i goes to shard ``i % num_shards``.
    The defaults are the process group's size and this process's rank
    (``core.mesh.process_count`` / ``process_index``: 1 and 0 where no
    group is initialised)."""
    num_shards = process_count() if num_shards is None else num_shards
    index = process_index() if index is None else index
    return [f for i, f in enumerate(files) if i % num_shards == index]


def interleave_records(files: Sequence[str], cycle_length: int = 4,
                       block_length: int = 8,
                       reader: Callable[[str], Iterator[bytes]] = read_tfrecord
                       ) -> Iterator[bytes]:
    """tf.data-style deterministic interleave: round-robin over up to
    ``cycle_length`` open files, ``block_length`` records at a time."""
    pending = list(files)
    active: List[Iterator[bytes]] = []
    while pending or active:
        while len(active) < cycle_length and pending:
            active.append(reader(pending.pop(0)))
        if not active:
            return
        nxt: List[Iterator[bytes]] = []
        for it in active:
            alive = True
            for _ in range(block_length):
                try:
                    yield next(it)
                except StopIteration:
                    alive = False
                    break
            if alive:
                nxt.append(it)
        active = nxt


def batched(it: Iterable, batch_size: int, drop_remainder: bool = False
            ) -> Iterator[list]:
    buf: list = []
    for item in it:
        buf.append(item)
        if len(buf) == batch_size:
            yield buf
            buf = []
    if buf and not drop_remainder:
        yield buf


class Prefetcher:
    """Background-thread prefetch (tf.data ``prefetch(AUTOTUNE)`` analog).
    An error raised by the source surfaces to the consumer, after the items
    produced before it."""

    _SENTINEL = object()

    def __init__(self, it: Iterable, buffer_size: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, args=(iter(it),),
                                        daemon=True)
        self._thread.start()

    def _run(self, it):
        try:
            for item in it:
                self._q.put(item)
        except BaseException as e:      # surface worker errors to the consumer
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], item):
    """``fn`` applied to every tensor of a batch item (tuples, lists, dicts
    and IdBatches of tensors); anything else (numpy extras, None, strings)
    passes through."""
    if isinstance(item, torch.Tensor):
        return fn(item)
    if isinstance(item, IdBatch):
        return IdBatch(rows=fn(item.rows), mask=fn(item.mask))
    if isinstance(item, dict):
        return {k: map_tensors(fn, v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(map_tensors(fn, v) for v in item)
    return item


def balance_batches(it: Iterable, batch_size: int):
    """tn.data.BalanceDataset analog (``staytime/parse.py:89``): keep every
    worker stepping in lockstep by padding short final batches up to
    ``batch_size`` with repeated rows whose sample_weight is zeroed, so the
    steps see one batch shape and padded rows add nothing to the loss.  The
    repeated rows are real ids: they add to the tables' show counts, as in
    the JAX package.  Works on tensors on any device, with no host sync."""

    def pad_leaf(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n == batch_size:
            return x
        return torch.cat([x] * -(-batch_size // n))[:batch_size]

    for item in it:
        batch, dense, labels, weight = item[0], item[1], item[2], item[3]
        n = weight.shape[0]
        if n < batch_size:
            batch = map_tensors(pad_leaf, batch)
            dense = None if dense is None else map_tensors(pad_leaf, dense)
            labels = map_tensors(pad_leaf, labels)
            weight = pad_leaf(weight).clone()
            weight[n:] = 0.0
        yield (batch, dense, labels, weight) + tuple(item[4:])


def dataset_reader(data_dir: str, dates: Sequence[str], match_pattern: str,
                   batch_size: int,
                   parse_fn: Callable[[List[bytes]], object],
                   cycle_length: int = 4, block_length: int = 8,
                   num_shards: Optional[int] = None,
                   shard_index: Optional[int] = None,
                   drop_remainder: bool = True,
                   prefetch: int = 2, device="cuda") -> Iterator:
    """The full ``staytime/parse.py:73-92`` pipeline shape, yielding
    ``parse_fn``'s items with their tensors on ``device`` (``"cuda"`` by
    default; ``"cpu"`` leaves them where the parse made them).  On a card the
    prefetch thread pins each item and the consumer's ``next`` queues its
    copy on the consumer's current stream: from pinned memory a
    ``non_blocking`` copy is queued there and the host goes on."""
    dev = resolve_device(device)
    files = list_files(data_dir, days=dates, match_pattern=match_pattern)
    files = shard_files(files, num_shards, shard_index)
    records = interleave_records(files, cycle_length, block_length)
    parsed = (parse_fn(raw_batch) for raw_batch in
              batched(records, batch_size, drop_remainder))
    if dev.type == "cpu":
        return iter(Prefetcher(parsed, buffer_size=prefetch))
    pinned = (map_tensors(torch.Tensor.pin_memory, item) for item in parsed)
    return (map_tensors(lambda t: t.to(dev, non_blocking=True), item)
            for item in Prefetcher(pinned, buffer_size=prefetch))
