#!/usr/bin/env python3
"""Where the host time of the grouped K1 and K3 calls goes, on one CUDA card.

    python3 scripts/torch_profile_group_host.py [--batch 256] [--calls 2000]

For each batch size: builds autoint's 24 mean columns with 5 ids (the
full-width bundle, seeded random weights), then times on the host clock
``calls`` calls of ``packed.fold_mean_group`` over the 24 members, and of
each piece of it in turn: the members' checks, the outputs' allocation (and,
beside it, one allocation for all the outputs cut into views), the
descriptor words (the members' pointers and sizes), their packing into one
byte string, and the launch itself (the C launcher and its error check);
and the layers above the launch: the launcher alone (allocation, words,
launch: ``packed.fold_mean_launch``), the custom op
``recommendsystem_tpu_torch::fold_mean_group`` on the members' lists (the
launcher behind the op's dispatch, no checks), and the same launcher
registered through the low-level ``torch.library.Library`` (a dispatcher
kernel with no ``custom_op`` wrapper), each under
``torch.inference_mode()`` as a predict call runs it.
The same for ``packed.unfold_mean_scatter_group`` (no allocation).  Each
number is the median of 5 windows, µs a call.  At the default batch a
call's device time (about 5 µs) is far below its host time, so the card's
queue stays short and the clock reads the host alone; at a batch whose
device time passes the host's, the full calls wait on the queue.  Prints
one JSON line per batch size, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_profile_common import card as card_name  # noqa: E402


def _us(fn, calls: int) -> float:
    """Median of 5 windows of ``calls`` calls, host µs a call."""
    fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        windows.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(windows)


def _fold_pieces(items):
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.kernels._build import check, count_launch, library
    from recommendsystem_tpu_torch.kernels._build import stream_handle

    device = items[0][0].device
    lib = library("fold")
    outs = [torch.empty((ids.shape[0] // l, t.shape[1]), device=device)
            for t, ids, _, _, l in items]

    def checks():
        for table, ids, mask, c, l in items:
            packed._check_fold_args(table, ids, mask)

    def alloc():
        return [torch.empty((ids.shape[0] // l, t.shape[1]), dtype=torch.float32,
                            device=device) for t, ids, _, _, l in items]

    shapes = [(ids.shape[0] // l, t.shape[1]) for t, ids, _, _, l in items]
    starts = [0]
    for r, d in shapes:                 # each start 16-byte aligned
        starts.append(starts[-1] + (r * d + 3) // 4 * 4)

    def alloc_one():
        flat = torch.empty(starts[-1], dtype=torch.float32, device=device)
        return [flat[s:s + r * d].view(r, d) for s, (r, d) in zip(starts, shapes)]

    def words():
        w = []
        for (table, ids, mask, c, l), out in zip(items, outs):
            w += (table.data_ptr(), ids.data_ptr(), mask.data_ptr(), out.data_ptr(),
                  c, l, ids.shape[0] // (c * l), table.shape[1], packed._is_bf16(table))
        return w

    desc = words()
    fmt = packed._pack_words(len(desc))
    blob = fmt.pack(*desc)

    def launch():
        with torch.cuda.device(device):
            check(lib, lib.fold_mean_group(blob, len(items), stream_handle(device)),
                  "fold_mean")
        count_launch("fold_mean")

    lists = [list(x) for x in zip(*items)]
    op = torch.ops.recommendsystem_tpu_torch.fold_mean_group
    low = _low_level_fold_op()

    def inference(fn):
        def run():
            with torch.inference_mode():
                return fn()
        return run

    return {"call": lambda: packed.fold_mean_group(items), "checks": checks,
            "alloc": alloc, "alloc_one": alloc_one, "words": words, "pack": lambda: fmt.pack(*desc),
            "launch": launch,
            "launcher": inference(lambda: packed.fold_mean_launch(items)),
            "op": inference(lambda: op(*lists)),
            "library_op": inference(lambda: low(*lists))}


_LOW_LEVEL = []


def _low_level_fold_op():
    """K1's launcher as a dispatcher kernel of an op defined through the
    low-level ``torch.library.Library``, defined once a process."""
    from recommendsystem_tpu_torch.embedding import packed

    if not _LOW_LEVEL:
        lib = torch.library.Library("rs_group_host", "DEF")
        lib.define("fold_mean_group(Tensor[] tables, Tensor[] ids, Tensor[] masks, "
                   "int[] cs, int[] ls) -> Tensor[]")
        lib.impl("fold_mean_group", lambda *a: packed.fold_mean_launch(list(zip(*a))), "CUDA")
        _LOW_LEVEL.append((lib, torch.ops.rs_group_host.fold_mean_group.default))
    return _LOW_LEVEL[0][1]


def _unfold_pieces(items):
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.kernels._build import check, count_launch, library
    from recommendsystem_tpu_torch.kernels._build import stream_handle

    device = items[0][2].device
    lib = library("unfold_scatter")

    def checks():
        for grads, counts, g, ids, mask, l in items:
            packed._check_unfold_args(grads, counts, g, ids, mask)

    def words():
        w = []
        for grads, counts, g, ids, mask, l in items:
            w += (grads.data_ptr(), counts.data_ptr(), g.data_ptr(), ids.data_ptr(),
                  mask.data_ptr(), l, g.shape[0], g.shape[1])
        return w

    desc = words()
    fmt = packed._pack_words(len(desc))
    blob = fmt.pack(*desc)

    def launch():
        with torch.cuda.device(device):
            check(lib, lib.unfold_mean_group_f32(blob, len(items), stream_handle(device)),
                  "unfold_mean")
        count_launch("unfold_mean")

    return {"call": lambda: packed.unfold_mean_scatter_group(items), "checks": checks,
            "words": words, "pack": lambda: fmt.pack(*desc), "launch": launch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[256])
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import create_train_state

    card = card_name()
    print(card, flush=True)
    bundle = create_model("autoint", device="cuda")
    state = create_train_state(bundle, seed=0)
    eng = bundle.embedding
    for b in args.batch:
        batch = synthetic_batch(bundle, b, seed=b, ids_per_feature=5)[0]
        plans = packed.plan_segments(eng, batch)
        folds, unfolds = [], []
        gen = torch.Generator(device="cuda").manual_seed(b)
        for skey, segs in sorted(plans.items()):
            ids, mask = packed.storage_stream(eng, skey, segs, batch)
            (seg,) = segs
            folds.append((state.tables[skey]["w"], ids, mask, len(seg.keys), seg.l))
            d = eng.storage[skey][1]
            views = packed.accumulator_views(eng.accumulator(skey, "cuda"), d)
            unfolds.append(views + (torch.randn((b, d), generator=gen, device="cuda"),
                                    ids, mask, seg.l))
        row = {"batch": b, "members": len(folds), "calls": args.calls,
               "fold_mean_group_us": {k: _us(f, args.calls)
                                      for k, f in _fold_pieces(folds).items()},
               "unfold_mean_scatter_group_us": {k: _us(f, args.calls)
                                                for k, f in _unfold_pieces(unfolds).items()},
               "card": card}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
