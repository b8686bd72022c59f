#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 14     # one phase alone (14, 15, 16, 17 or 18)

1. builds the port's CUDA kernels from ``recommendsystem_tpu_torch/csrc/``
   (one nvcc per source, all at once);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving and train paths give it (batch buckets 8, 200 and 256,
   and 65536; the field-attention forward as the train step launches it,
   with its log-sum-exp, held to the plain version's output and lse, also
   at F = 175 and at B = 65536 with dropout 0.2 (F = 24 and 175); its
   backward, checked bit-identical over two launches; the unfold-scatter at
   B = 4096 and 65536; the folds and the unfold-scatter also as the steps
   launch them, one grouped call over autoint's 24 columns at B = 256 and
   65536 with 5 ids (K1, K3) or 1 (K2), tables and accumulators out of L2,
   and over a group of mixed widths and lengths and a group of 65 members
   (two fold launches, one unfold-scatter); the per-row unfold-scatter (K4) as the 1-id step
   launches it, one grouped call over autoint's 24 columns at B = 4096 and
   65536, timed in turns with the 24 per-column launches it replaces; the
   lazy Adam as one grouped pass over autoint's 24 full storages, and over a
   group of mixed widths), and times kernel,
   plain version and a library
   yardstick that the port never calls: device time per call (``ms``, calls
   run back to back behind a spin kernel) and, for the kernel, the host's
   time to issue one call (``host_ms``);
3. drives the serving path: the full-width autoint ``ScoringService`` (24
   tables of 265,000 rows x 8, seeded random weights; its InteractingLayer
   through K6) answers requests
   through ``score()`` and over HTTP, with counts of kernel launches set to 0
   just before and read just after; a second service with one id per feature
   drives the single-id fold; scores are checked finite, in [1e-6, 1],
   unchanged by padding, and equal to the same service run on the CPU
   through the plain versions;
4. times the predict step at batch 65536;
5. drives the train path: the full-width packed train step (B = 65536,
   attention dropout 0.2, so the InteractingLayer takes K5f and K5b; lazy
   Adam on the tables, dense Adam) for a few
   steps with 5 ids per feature and with 1, counts set to 0 just before and
   read just after; checks the loss finite, t and show equal to the live
   counts, and one lazy-Adam launch and one attention backward a step (and
   with 5 ids one grouped fold and one grouped unfold-scatter);
   holds two steps on the card to the same two steps on the CPU through
   the plain versions (B = 4096, same step seeds, same dropout, a batch
   from each seed of ``CHECK_SEEDS``; ``witness`` puts every entry past a
   ``TRAIN_*`` tolerance down to a ReLU input within rounding of 0 on the
   entry's own path (for a dense entry: the CPU step from the card's
   state with the card's side of each such flip gives the card's
   gradient) or a gradient within rounding of 0, and the check fails on
   any entry it cannot explain); times
   the step as the median of 3 windows, each ending in a synchronize and a
   host fetch of the last loss;
6. drives the staytime serving path: the DIN-pool kernel against its plain
   version on the model's strided views (B = 8, 256 and 16384, T = 50,
   rows of all-0 masks and of full length), and its gathered entry as the
   predict step launches it (the full-width table out of L2, rows of all-0
   masks over nonzero padding rows), timed beside the path it replaces (K2
   then K7 on K2's rows); the fold of the 46 single-id segments as one
   grouped K2 call and of one behaviour sequence (16384 x 50); then the
   full-width staytime ``ScoringService`` (91 tables of 81,924 x 32 in 46
   storages, 3 behaviour sequences of 50, seeded random weights) through
   ``score()`` and over HTTP, counts set to 0 just before and read just
   after, some requests without sequence features: K1 and K7, no K2 with
   5 ids; the three heads checked finite and in range, unchanged by padding
   and equal to the same service on the CPU; then the predict step's
   launches per call (5 ids: one K1, no K2, three K7; 1 id: no K1, one K2,
   three K7) and its examples/s at B = 16384;
7. drives the fused InteractingLayer (K6): the kernel against its plain
   version at F = 24 (B = 8, 256, 65536), F = 40 (B = 32768) and F = 180
   (B = 8192), timed beside the layer's transposed path (projections, K5f,
   LayerNorm: what K6 replaces), and its autograd Function's gradients
   against the plain version's at B = 256; then, counts set to 0 just
   before and read just after, the full-width ctr (24 tables of 265,000 x
   48) and multi_head (40 tables of 265,000 x 8) ``ScoringService`` through
   ``score()`` and over HTTP, each held to the CPU plain path and unchanged
   by padding; full-width autoint served through the transposed path
   against phase 3's scores; last the predict steps of autoint (B = 65536),
   ctr and multi_head (B = 32768) and the 212-feature ctr shape (B = 8192,
   32,768-id buckets, one id per column), each with K6 and through the
   transposed path, timed in turns, with launches per call, and held to the
   CPU at B = 64;
8. drives the train step of ctr (24 slots of 48-wide rows, B = 32768, 5
   ids: one K1, K3, K5f, K5b and K8 a step), the 212-feature ctr (F = 180,
   56-wide rows in 36 storages, B = 8192, one id a column: one K2, 180 K4,
   one K5f, K5b and K8 a step), multi_head (B = 32768) and finish (B =
   32768: one K1, K3 and K8, no K5), each in its own window of counts held
   to those launches (the 212-feature ctr's 180 single-id columns take one
   grouped K4 launch; its grouped call is timed in turns with the 180
   per-column launches it replaced), with losses and the L1L2 penalty finite and t and
   show equal to the live counts; times each step; times K3, K4 and K8 at
   D 48, 56 and 32 and K5f and K5b at F 40 and 180 with dropout as these
   steps launch them; holds two card steps of each model to the CPU plain
   path at a smaller bucket and B = 64 (same step seeds, same dropout,
   each batch seed of ``CHECK_SEEDS``, as in phase 5); then
   full-width finish serving (40 tables of 25,600 x 32) through ``score()``
   and over HTTP, scores in (0, 1), unchanged by padding and equal to the
   CPU's, and its predict step at B = 32768 (5 ids: one K1; 1 id: one K2);
9. drives rough_rank at the JAX defaults (49 mean columns of 16-d rows over
   25,600-id buckets in 25 storages, PLE towers, CrossNet teacher, the dense
   flag 4575; B = 32768): a counted train window with 5 ids (one K1, K3 and
   K8 a step) and one with 1 id (one K2, K4 and K8), losses finite, t and
   show equal to the live counts, examples/s; K1, K3, K4 and K8 at its
   shapes; two card steps held to the CPU at 2,048-id buckets and B = 64;
   the service over buckets 8-256 with the flag in the requests (student
   and teacher in (0, 1), the card equal to the CPU), and its predict step
   at B = 32768 (one K1); then the stacked-expert variants of ctr,
   multi_head and staytime, one serving call each at a small size, card
   against CPU;
10. trains staytime at full width (the default ``StaytimeConfig``: 91 mean
   columns of 32-d rows over 81,920-id buckets and 3 sequences of 50 in 46
   storages, sparse AdaGrad, B = 16384): a counted window with 5 ids (one
   K1, K2, K3, K4 and K9 and three K7 a step) and one with 1 id (one K2,
   K4 and K9, three K7), losses finite, show equal to the live counts and
   g2sum grown on the live rows alone, examples/s; the lazy AdaGrad pass
   K9 over the 46 storages against its plain version with bound and
   library times, and over mixed groups (one of 65 storages: two
   launches), timed with their bounds; K3 over the 91 mean columns (one launch) and K4 over the
   sequences and over the 94 single-id and sequence columns; two card
   steps held to the CPU at 2,048-id buckets and B = 64, with 5 ids and
   with 1;
11. drives the eval path of every model at full width and its train batch
   (autoint B = 65536, phase 3's bundle; ctr, multi_head, finish and
   rough_rank B = 32768; the 212-feature ctr B = 8192; staytime B = 16384
   with 5 ids and with 1): ``evaluate`` over two batches in a window of
   counts, held to the predict step's launches a call (``EVAL_LAUNCHES``:
   no K3-K5, K8 or K9), AUC, accuracy and bin accuracy in [0, 1] and COPC,
   CTR, MAE and MSE finite; the host syncs of an eval step and of a
   predict call (none allowed); eval and predict steps timed in turns; the
   metric update alone by CUDA events; at B = 64 and each ``CHECK_SEEDS``
   the card's outputs held to the CPU plain path's and its metric states
   to the CPU metric functions on the card's own outputs (counts exact,
   sums rtol 1e-6); ``dump_predict`` with the labels at B = 256, its
   scores parsed and held to the predict step's; the AUC update alone at
   B = 65536 and 32768 against the CPU's; then staytime's streaming GAUC
   over three batches with the reference example's mixed engines (the
   step's launches; its histograms and ``oor`` equal to the card's and the
   CPU's updates on the predict step's outputs; the saturating bins of
   +-1e10, +-inf and NaN on the card and the CPU; offline against
   streaming in a collision-free case; the updates' times);
12. drives the daily path at full width: two days of staytime TFRecord
   shards (2 x 2,048 records a day, the default ``StaytimeConfig``'s 91
   slots, 1-5 ids each) written through the port's codec; the Python
   loader (parse, pin, copy to the card) and the C++ loader timed over one
   day, their first batches equal; ``python -m
   recommendsystem_tpu_torch.train.daily``'s ``main`` with ``--backtest
   --evict-min-show 1 --predict-out`` at B = 1024 in a window of counts
   (each step ``fit`` takes held to ``STAYTIME_TRAIN_LAUNCHES[5]`` and timed
   by CUDA events; the marker, a checkpoint a day, a second run that trains
   nothing, the last checkpoint equal to the returned state bit for bit,
   ``backtest.jsonl``'s keys and finite values, a dump line a record); one
   day of finish (the ctr parse, K8); the checkpoint's bytes, save and
   restore seconds; the server's ``main --checkpoint`` on a free port
   (``/healthz`` the restored step, ``/score`` of 200 rows equal to a
   service over the restored state); the checkpoint restored onto the CPU,
   one predict call held to the card's;
13. drives storage precision at full width: staytime with
   ``table_dtype="auto"`` (46 storages of 32-wide bf16 rows) served through
   ``score()`` and over HTTP and held to the CPU, its predict step's
   launches a call, two counted train windows (5 ids and 1, B = 16384)
   held to ``STAYTIME_TRAIN_LAUNCHES``, ``evaluate`` held to
   ``EVAL_LAUNCHES``; autoint with bf16 tables and bf16 moments (B = 65536)
   in two counted windows held to phase 5's launches a step, served and
   held to the CPU; K1, K2, K7's gathering entry, K8 (bf16 moments and
   float32 ones) and K9 over the bf16 tables against their plain versions,
   each bf16 entry they store by the bf16 rule (``_bf16_off``: the plain
   version's float32 value rounded, or one ulp from it at a rounding
   midpoint), timed with bounds on bf16 bytes and the library yardsticks;
   two card steps of each model held to the CPU one step at a time
   (``hold_bf16_to_cpu``); one step of each classic sparse update
   (``scatter``, ``dense``, the packed step over ``packed=False``
   storages, the touched-rows update) held to the CPU with its launches
   (``classic_paths``); the server's ``main --table-dtype auto`` answering
   ``/score`` as the service does;
14. drives the bf16 compute policy at full width (``bf16_compute_path``):
   K6, K5f (dropout 0.2), K5b and both K7 entries (over a float32 and a
   bf16 table) on bf16 inputs against their plain versions, timed with
   bounds on bf16 bytes beside the float32 kernel; autoint under the
   policy served (K6 on bf16) and held to the CPU plain path of the same
   policy, its predict and eval launches, a counted train window at B =
   65536 (K5f and K5b on bf16) held to phase 5's launches a step; ctr (B =
   32768) and staytime (B = 16384) trained in counted windows held to the
   float32 launches; staytime's predict call (the gathering K7 rounding
   a float32 table) held to the CPU; staytime ``"auto"`` served, held to
   the CPU and evaluated; train and predict ms against float32 in turns;
   each training model's loss and dense gradients held to the CPU's at the
   CPU tests' bf16 tolerances (``hold_policy_to_cpu``); the server's
   ``main --compute-dtype bf16`` and one day of ``daily.main
   --compute-dtype bf16``;
15. drives the serving export (``export_path``): full-width autoint (5
   ids) and staytime (5 ids and 1) exported with ``train/export.py`` at B
   = 256 and at their predict batches (65536, 16384), saved, loaded in
   this process and scored; each exported graph holds the kernels as
   custom-op nodes and no table gather; each loaded program's outputs
   equal the predict step's on the card and the CPU plain path's
   (``SCORE_TOL``), and its launches a call equal the predict call's
   (``EXPORT_LAUNCHES``); autoint exported once more under the bf16
   compute policy and held to the bf16 predict step; loaded program and
   predict step timed in turns (host clock, windows ending in a
   synchronize); each custom op's host µs against its launcher called
   directly, under ``inference_mode`` and ``no_grad``;
16. drives the sharded mode (``sharded_path``) on a one-rank NCCL group
   from ``core.mesh.create_mesh()``: full-width autoint (B = 65536) and
   staytime (B = 16384, float32 and ``"auto"`` tables) through the
   sharded packed step, the exchange's drop report 0, its launches a step
   held to ``SHARDED_LAUNCHES`` (the local step's and one more grouped K2
   and K4: the owners' side of the pull and of the push) and its losses to
   the local step's, the
   two timed in turns; the sharded step held to the CPU's local step by
   ``witness`` at ``CHECK_SEEDS``; one sharded scatter step; staytime's
   sharded predict call (K7 gathering from the exchanged rows) held to the
   local one; K5f and K5b with a non-zero sample offset against their
   plain versions;
17. drives tensor and expert parallelism (``mesh2d_path``) on a data 1 x
   model 2 mesh of two processes on the one card (a gloo world and model
   group over the card's tensors, staged through the host; one-rank NCCL
   data groups): full-width ctr (B = 32768) with ``tensor_parallel=True``
   (24 column-split kernels) and rough_rank with ``stacked_experts=True``
   and ``expert_shardings`` (B = 32768), each rank's window held to the
   local step's losses and, gathered, its state, launches a step held to
   ``MESH2D_LAUNCHES``, the model replicas' tables bit-equal, the drop
   report 0, the two steps timed in turns with the collectives' bytes;
   ctr's predict call and eval step under the placements held to the
   local ones; ctr's tensor-parallel step held to the CPU by ``witness``
   at ``CHECK_SEEDS``; the sharded checkpoint from ``fit`` restored onto
   the ranks and locally, bit for bit.
18. trains autoint on the Criteo path (``criteo_quality_path``) at the
   configuration of ``AUC_PARITY.json`` through
   ``scripts/torch_auc_parity_criteo.py``'s functions: 120,000 training
   and 20,000 test rows of its synthetic Criteo file written and parsed
   once, 39 mean columns (26 categorical of 2 ids, 13 integer of 1) over
   50,000-row tables, B 512, dropout 0.2; one train step's launches held
   to ``CRITEO_TRAIN_LAUNCHES`` (one K1, K2, K3, K4, K5f, K5b and K8) and
   one predict call's to ``CRITEO_PREDICT_LAUNCHES`` (one K1, K2 and K6),
   no host sync in either; two card steps held to the CPU by ``witness``
   at B 64 and ``CHECK_SEEDS``; seed 0 trained for 3 epochs (702 steps)
   in float32, bf16 storage and bf16 compute, each run's launches held to
   its steps and predict calls: the float32 test AUC within
   ``CRITEO_AUC_BOUND`` of the JAX mean and its trained predict outputs
   equal to the CPU's, the bf16 modes' AUC above ``CRITEO_MIN_AUC``.

Prints the card's name and power limit, one JSON line each for the autoint
predict step, the train step, the staytime predict step, the predict
steps with and without K6 (``interacting_predict``), the phase-8 train
steps with finish's predict step (``tower_train``), rough_rank's train
and predict steps (``rough_rank``), staytime's train steps
(``staytime_train``), the eval path's times (``eval``), the daily
path's loader, train-step and checkpoint numbers (``daily``), phase
13's table sizes, train steps and classic-update launches (``bf16``),
phase 14's train and predict times under the policy (``bf16_compute``) and
phase 15's loaded-program and predict-step times and dispatch µs
(``export``), phase 16's sharded and local step times (``sharded``), phase
17's 2-D and local step times, collectives and checkpoint (``mesh2d``),
phase 18's trained AUC, logloss and examples/s (``criteo_quality``), then
``{"kernels": ...}`` (10 kernels), and last
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Any failure ends the run with a traceback
and a non-zero exit; without CUDA it exits non-zero before printing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12        # float32 outside the tensor cores
FULL_BUCKET = 265000
SERVE_BUCKETS = (8, 200, 256)
BIG_BATCH = 65536
FOLD_TOL = 1e-6                   # a sum of <= 5 float32 products, other order
FOLD_SUM_ULPS = 2                 # grouped folds: FOLD_TOL + 2 L 2^-24 sum |m row|
ATTN_TOL = 2e-5                   # softmax over <= 175 keys, 4-term dots
SCORE_TOL = dict(rtol=1e-5, atol=2e-6)   # float32 products in another order
GRAD_TOL = dict(rtol=1e-4, atol=2e-5)    # attention gradients: sums over <= 175 fields
# a bf16 gradient: the float32 value of GRAD_TOL rounded once on each side,
# so one bf16 ulp (2^-7 relative at most) apart at a rounding midpoint
BF16_GRAD_TOL = dict(rtol=2.0 ** -7 + 1e-4, atol=2e-5)
UNFOLD_TOL = 1e-5                 # atomics add each row's gradients in another order
ADAM_W_TOL = 1e-7                 # powf against PyTorch's pow: one ulp of a bias correction
ADAM_M_RTOL = 1e-6
ADAGRAD_W_TOL = 1e-6              # K9: the squares summed in another order than the host's mean
ADAGRAD_G2_RTOL = 1e-6
DROPOUT = 0.2
TRAIN_STEPS = 3
TRAIN_CHECK_BATCH = 4096
# card against CPU after two train steps: losses as the CPU tests hold the
# port to the JAX package; weights, params and moments with room for the
# atomics' and the matmuls' other order of summation (see PERF.md)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_W_ATOL = 1e-5
TRAIN_MOMENT_TOL = dict(rtol=1e-3, atol=1e-8)
DIN_TOL = 2e-5                    # softmax over T = 50, 64-term dots, other order
DIN_BATCHES = (8, 256, 16384)
STAYTIME_BATCH = 16384
EV_TOL = dict(rtol=1e-5)          # expected value: a sum of 400 products
EV_MAX = 180.5                    # the last bin centre
INTER_TOL = dict(rtol=2e-5, atol=2e-5)   # K6: the JAX package's own tolerance for it
INTER_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
INTER_CASES = ((24, 8), (24, 256), (24, BIG_BATCH), (40, 32768), (180, 8192))  # (F, B)
CTR_BATCH = 32768                 # bench.py:357-358
CTR212_BATCH = 8192               # bench.py:325-327
CTR212_BUCKET = 32768
CHECK_BATCH = 64
FINISH_BATCH = 32768              # finish's train batch (bench.py:359)
ROUGH_BATCH = 32768               # rough_rank's train batch (bench.py:337, 360)
ROUGH_CHECK_BUCKET = 2048         # the card-vs-CPU train check's buckets
TOWER_CHECK_BATCH = 64
# every card-vs-CPU train check draws its batch from each of these seeds
CHECK_SEEDS = (31, 32, 33)
# the kink witness (``witness``): a ReLU input on either side of 0 between
# the card and the CPU is a kink where both values lie within KINK_RTOL of
# the call's largest |input| (or within the call's largest difference
# elsewhere); two gradients of one tensor agree within rounding where they
# differ by at most GRAD_ROUND of the tensor's largest |gradient|
KINK_RTOL = 1e-4
GRAD_ROUND = 1e-5
STAYTIME_CHECK_BUCKET = 2048      # staytime's card-vs-CPU train check

OUT_DIR = "chiprun_out"


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def _spin_cycles_per_ms() -> float:
    """Clock cycles per ms of ``torch.cuda._sleep``'s spin kernel."""
    torch.cuda._sleep(1_000_000)            # warm-up launch
    start, end = _events()
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    end.synchronize()
    return 50_000_000 / start.elapsed_time(end)


def timed(fn, iters: int, cycles_per_ms: float):
    """(device ms, host ms) of one call, over ``iters`` back-to-back calls
    after one warm-up call.

    Host ms is the time the host takes to issue a call.  For device ms the
    calls are queued behind a spin kernel that outlasts their issue, so the
    card runs them back to back and the CUDA events see the device time of
    the calls, not the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = _events()
    torch.cuda._sleep(int(min(2e3, 1.5 * host_ms + 1.0) * cycles_per_ms))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms / iters


def _dtype_name(t) -> str:
    """"bf16" or "fp32": a case's table type."""
    return "bf16" if t.dtype == torch.bfloat16 else "fp32"


def _float32_twins(tstates):
    """float32 copies of storages' states: the plain update of a twin
    stores the float32 values that a bf16 update rounds."""
    return [{"w": t["w"].float().clone(), "opt": {n: x.float().clone() for n, x in t["opt"].items()},
             "show": t["show"].clone()} for t in tstates]


def _check_bf16(got, twin, atol, rtol, what):
    """A kernel's bf16 quantity against the plain version's float32 value
    before rounding (a twin's): the bf16 rule (``_bf16_off``)."""
    off = _bf16_off(got, twin, atol, rtol)
    if bool(off.any()):
        raise AssertionError(f"{what}: {int(off.sum())} bf16 entries off the plain "
                             f"version's rounding")


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fold_case(name, tables, ids, mask, c, l, cycles_per_ms):
    """One K1 (l > 1) or K2 (l == 1) comparison at the given stream.  The
    comparison reads ``tables[0]``; the timed calls take the tables in turn,
    so that each call finds its table out of L2 (24 tables of 8.5 MB), as a
    predict step does."""
    from recommendsystem_tpu_torch.embedding import packed

    b = ids.shape[0] // (c * l)
    d = tables[0].shape[1]
    calls = [0]

    def table(first=False):
        calls[0] = 0 if first else calls[0] + 1
        return tables[calls[0] % len(tables)]

    if l == 1:
        kernel = lambda: packed.fold_rows(table(), ids, mask)          # noqa: E731
        plain = lambda: packed.fold_rows_plain(table(), ids, mask)     # noqa: E731
    else:
        kernel = lambda: packed.fold_mean(table(), ids, mask, c, l)    # noqa: E731
        plain = lambda: packed.fold_mean_plain(table(), ids, mask, c, l)  # noqa: E731
    got = packed.fold_mean(table(True), ids, mask, c, l)
    want = packed.fold_mean_plain(table(True), ids, mask, c, l)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= FOLD_TOL:
        raise AssertionError(f"{name} b={b}: max abs err {err} > {FOLD_TOL}")
    # yardstick: one embedding_bag call computing the same sums (b-major bags)
    bags = ids.view(c, l, b).permute(0, 2, 1).reshape(c * b, l).contiguous()
    wts = mask.view(c, l, b).permute(0, 2, 1).reshape(c * b, l).contiguous()
    library = lambda: torch.nn.functional.embedding_bag(          # noqa: E731
        bags, table(), mode="sum", per_sample_weights=wts)
    lib_err = float((torch.nn.functional.embedding_bag(
        bags, table(True), mode="sum", per_sample_weights=wts) - want).abs().max())
    live = mask != 0
    uniq = int(torch.unique(ids[live]).numel())
    nbytes = ids.numel() * 4 + mask.numel() * 4 + uniq * d * 4 + c * b * d * 4
    ops = 2 * int(live.sum()) * d
    bms, by = bound(nbytes, ops)
    iters = 240 if b <= 256 else 48
    ms, host_ms = timed(kernel, iters, cycles_per_ms)
    return {"name": name, "b": b, "c": c, "l": l, "d": d, "max_abs_err": err,
            "ms": ms, "host_ms": host_ms,
            "plain_ms": timed(plain, iters, cycles_per_ms)[0],
            "library_ms": timed(library, iters, cycles_per_ms)[0],
            "library_max_abs_err": lib_err,
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops}


def _batch_chunks(b, h, f):
    """The plain attention versions materialise (h, F, F, B) tensors: run
    them in batch chunks of at most ~1 GB each."""
    chunk = max(1, min(b, (1 << 30) // (4 * h * f * f)))
    return [slice(i, i + chunk) for i in range(0, b, chunk)]


def attention_case(h, dh, f, b, seed, cycles_per_ms, rate=0.0, dtype=torch.float32):
    """K5f at ``rate`` as the train step launches it, with the log-sum-exp
    for K5b (``FieldAttentionFunction.forward``): output and lse against
    ``field_attention_fwd_plain``'s; with dropout the kernel and the plain
    version draw the same Philox mask from the same seed.  ``dtype`` bf16:
    q, k, v in bf16 (the bf16 compute policy), o and lse float32, bytes
    counted at bf16, and the float32 kernel on the same values widened timed
    beside it (``fp32_ms``)."""
    from recommendsystem_tpu_torch.kernels.field_attention import _fwd, field_attention_fwd_plain

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.relu(torch.randn((h, dh, f, b), generator=g, device="cuda")).to(dtype)
               for _ in range(3))
    dseed = (seed << 32) | 1

    def plain():
        return [field_attention_fwd_plain(q[..., c], k[..., c], v[..., c], dseed, rate)
                for c in _batch_chunks(b, h, f)]

    kernel = lambda: _fwd(q, k, v, dseed, rate, want_lse=True)     # noqa: E731
    got, got_lse = kernel()
    # the plain version's chunks restart the sample index of the mask:
    # compare on the first chunk only where dropout is on
    if rate == 0.0:
        outs = plain()
        want = torch.cat([o for o, _ in outs], dim=3)
        want_lse = torch.cat([s for _, s in outs], dim=2)
    else:
        c0 = _batch_chunks(b, h, f)[0]
        want, want_lse = field_attention_fwd_plain(
            q[..., c0].contiguous(), k[..., c0].contiguous(), v[..., c0].contiguous(),
            dseed, rate)
    torch.cuda.synchronize()
    n = want.shape[3]
    err = float((got[..., :n] - want).abs().max())
    lse_err = float((got_lse[..., :n] - want_lse).abs().max())
    if not (err <= ATTN_TOL and lse_err <= ATTN_TOL):
        raise AssertionError(f"field_attention F={f} b={b} rate={rate}: "
                             f"max abs err {err}, lse {lse_err}")
    # yardstick: SDPA on a (h*B, F, dh) view, laid out outside the timing
    q3, k3, v3 = (x.permute(0, 3, 2, 1).reshape(h * b, f, dh).contiguous()
                  for x in (q, k, v))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q3, k3, v3, dropout_p=rate)
    lib_err = None
    if rate == 0.0:
        lib_out = library().reshape(h, b, f, dh).permute(0, 3, 2, 1)
        lib_err = float((lib_out - want).abs().max())
    # q, k, v read once, o and lse written once
    nbytes = (3 * q.element_size() + 4) * h * dh * f * b + 4 * h * f * b
    ops = 4 * h * dh * f * f * b + 4 * h * f * f * b   # dots + softmax
    bms, by = bound(nbytes, ops)
    iters = 200 if b <= 256 else 20
    ms, host_ms = timed(kernel, iters, cycles_per_ms)
    fp32_ms = None
    if dtype != torch.float32:
        q32, k32, v32 = (x.float() for x in (q, k, v))
        fp32_ms = timed(lambda: _fwd(q32, k32, v32, dseed, rate, want_lse=True), iters,
                        cycles_per_ms)[0]
        del q32, k32, v32
    return {"name": "field_attention", "dtype": _dtype_name(q), "fp32_ms": fp32_ms,
            "b": b, "f": f, "h": h, "dh": dh,
            "rate": rate, "lse": True, "max_abs_err": max(err, lse_err),
            "out_max_abs_err": err, "lse_max_abs_err": lse_err,
            "ms": ms, "host_ms": host_ms,
            "plain_ms": timed(plain, max(2, iters // 10), cycles_per_ms)[0],
            "library_ms": timed(library, iters, cycles_per_ms)[0],
            "library_max_abs_err": lib_err,
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops}


def attention_bwd_case(h, dh, f, b, seed, cycles_per_ms, rate=DROPOUT, dtype=torch.float32):
    """K5b against its plain version (the explicit formulas, batch-chunked
    like the forward's), at ``rate`` with the mask regenerated from the
    seed; yardstick: SDPA's backward on the (h*B, F, dh) view (at rate 0:
    SDPA's dropout draws other bits).  ``dtype`` bf16: q, k, v and dq, dk,
    dv in bf16 (o, lse and do float32), each gradient within one bf16 ulp
    of the plain version's (``BF16_GRAD_TOL``), bytes at bf16, and the
    float32 kernel on the widened values timed beside it (``fp32_ms``)."""
    from recommendsystem_tpu_torch.kernels.field_attention import (
        field_attention_bwd, field_attention_bwd_reference, field_attention_fwd_plain)

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((h, dh, f, b), generator=g, device="cuda")
                   for _ in range(4))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    dseed = (seed << 32) | 1
    chunks = _batch_chunks(b, h, f)
    # inputs of the backward: o and lse of the first chunk's plain forward,
    # where the chunk's sample indices are the kernel's
    c0 = chunks[0]
    qc, kc, vc, doc = (x[..., c0].contiguous() for x in (q, k, v, do))
    oc, lsec = field_attention_fwd_plain(qc, kc, vc, dseed, rate)
    got = field_attention_bwd(qc, kc, vc, oc, lsec, doc, dseed, rate)
    again = field_attention_bwd(qc, kc, vc, oc, lsec, doc, dseed, rate)
    want = field_attention_bwd_reference(qc, kc, vc, oc, lsec, doc, dseed, rate)
    torch.cuda.synchronize()
    err = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(),
                                   **(GRAD_TOL if dtype == torch.float32 else BF16_GRAD_TOL))
    if not all(torch.equal(a, c) for a, c in zip(got, again)):
        raise AssertionError(f"field_attention_bwd F={f} b={b}: two launches differ")
    # timing at the full batch: o and lse from the plain forward per chunk
    o = torch.empty(q.shape, device="cuda")
    lse = torch.empty((h, f, b), device="cuda")
    for c in chunks:
        o[..., c], lse[..., c] = field_attention_fwd_plain(
            q[..., c].contiguous(), k[..., c].contiguous(), v[..., c].contiguous(),
            dseed, rate)
    kernel = lambda: field_attention_bwd(q, k, v, o, lse, do, dseed, rate)  # noqa: E731

    def plain():
        return [field_attention_bwd_reference(
            q[..., c], k[..., c], v[..., c], o[..., c], lse[..., c], do[..., c],
            dseed, rate) for c in chunks]

    q3, k3, v3, do3 = (x.permute(0, 3, 2, 1).reshape(h * b, f, dh).contiguous()
                       .requires_grad_(x is not do) for x in (q, k, v, do))
    do3 = do3.to(q3.dtype)
    out3 = torch.nn.functional.scaled_dot_product_attention(q3, k3, v3)
    library = lambda: torch.autograd.grad(out3, (q3, k3, v3), do3,  # noqa: E731
                                          retain_graph=True)
    # reads q, k, v, o, do and lse once, writes dq, dk, dv once; per
    # (head, query, key, sample): scores, dp, and the dq, dk, dv terms
    # (2 dh flops each), the exponential and the softmax-gradient terms
    nbytes = (6 * q.element_size() + 8) * h * dh * f * b + 4 * h * f * b
    ops = (10 * dh + 5) * h * f * f * b
    bms, by = bound(nbytes, ops)
    iters = 20
    ms, host_ms = timed(kernel, iters, cycles_per_ms)
    fp32_ms = None
    if dtype != torch.float32:
        q32, k32, v32 = (x.float() for x in (q, k, v))
        fp32_ms = timed(lambda: field_attention_bwd(q32, k32, v32, o, lse, do, dseed, rate),
                        iters, cycles_per_ms)[0]
        del q32, k32, v32
    return {"name": "field_attention_bwd", "dtype": _dtype_name(q), "fp32_ms": fp32_ms,
            "b": b, "f": f, "h": h, "dh": dh,
            "rate": rate, "max_abs_err": err, "deterministic": True,
            "ms": ms, "host_ms": host_ms,
            "plain_ms": timed(plain, 2, cycles_per_ms)[0],
            "library_ms": timed(library, iters, cycles_per_ms)[0],
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops}


def _payload(g, mask):
    """(E, D) per-entry grads and (E,) mask -> (E, D+1) [grad | count]
    rows, zero where the mask is not > 0: what the yardstick's one
    ``index_add_`` adds."""
    live = (mask > 0).to(g.dtype)[:, None]
    return torch.cat([g * live, live], dim=1)


def _check_unfold(got, want, d, what):
    """Gradient sums within UNFOLD_TOL, counts equal; returns the max abs
    error of the sums."""
    (gg, gc), (wg, wc) = (_acc_views(got, d), _acc_views(want, d))
    err = float((gg - wg).abs().max()) if gg.numel() else 0.0
    if not err <= UNFOLD_TOL or not torch.equal(gc, wc):
        raise AssertionError(f"{what}: max abs err {err}, counts "
                             f"{float((gc - wc).abs().max())}")
    return err


def _acc_views(acc, d):
    from recommendsystem_tpu_torch.embedding.packed import accumulator_views

    return accumulator_views(acc, d)


def _flat(grads, counts):
    """The flat accumulator (a copy) of the views ``_acc_views`` gave."""
    return torch.cat([grads.reshape(-1), counts.reshape(-1)])


def _unfold_bytes_ops(ids, mask, b, d):
    """ids and mask read once, the gradient once, each touched accumulator
    row read and written once; one add per live entry and lane."""
    live = mask > 0
    uniq = int(torch.unique(ids[live]).numel())
    return 8 * ids.numel() + 4 * b * d + 2 * 4 * (d + 1) * uniq, int(live.sum()) * (d + 1)


def unfold_case(name, eng, skey, batch, cycles_per_ms):
    """K3 (5 ids) or K4 (1 id) on one full-width column's stream: the
    column's gradient added into a zeroed accumulator (rows*(D+1) floats,
    gradient block then counts), against the plain version (two
    ``index_add_``); yardstick: one ``index_add_`` of the prebuilt (E, D+1)
    [grad | count] payload into a (rows, D+1) buffer."""
    from recommendsystem_tpu_torch.embedding import packed

    plans = packed.plan_segments(eng, batch, storages={skey})
    (seg,) = plans[skey]
    ids, mask = packed.storage_stream(eng, skey, plans[skey], batch)
    rows, d = eng.storage[skey]
    b = ids.shape[0] // seg.l
    g = torch.randn((b, d), generator=torch.Generator(device="cuda").manual_seed(b),
                    device="cuda")
    got = torch.zeros(rows * (d + 1), device="cuda")
    want = torch.zeros(rows * (d + 1), device="cuda")
    gv, wv = _acc_views(got, d), _acc_views(want, d)
    if seg.l == 1:
        kernel = lambda: packed.unfold_rows_scatter(*gv, g, ids, mask)  # noqa: E731
        plain = lambda: packed.unfold_rows_scatter_plain(*wv, g, ids, mask)  # noqa: E731
        payload = _payload(g, mask)
    else:
        kernel = lambda: packed.unfold_mean_scatter(*gv, g, ids, mask, seg.l)  # noqa: E731
        plain = lambda: packed.unfold_mean_scatter_plain(*wv, g, ids, mask, seg.l)  # noqa: E731
        payload = _payload(g.repeat(seg.l, 1), mask)
    kernel()
    plain()
    torch.cuda.synchronize()
    err = _check_unfold(got, want, d, f"{name} b={b}")
    lids = ids.long()
    lib_acc = torch.zeros((rows, d + 1), device="cuda")
    library = lambda: lib_acc.index_add_(0, lids, payload)         # noqa: E731
    live = mask > 0
    n_live = int(live.sum())
    uniq = int(torch.unique(ids[live]).numel())
    nbytes, ops = _unfold_bytes_ops(ids, mask, b, d)
    bms, by = bound(nbytes, ops)
    iters = 48
    ms, host_ms = timed(kernel, iters, cycles_per_ms)
    return {"name": name, "b": b, "l": seg.l, "d": d, "live": n_live, "rows_touched": uniq,
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": timed(plain, iters, cycles_per_ms)[0],
            "library_ms": timed(library, iters, cycles_per_ms)[0],
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops}


def _storage_streams(bundle, b, seed, ids_per_feature=5):
    """Per storage of a bundle whose storages hold one segment each
    (autoint's 24 and ctr's 24 of one column each, finish's 40): the
    storage key, its stream (ids, mask) and its segment, for a batch of
    ``b``."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.embedding import packed

    eng = bundle.embedding
    batch = synthetic_batch(bundle, b, seed=seed, ids_per_feature=ids_per_feature)[0]
    plans = packed.plan_segments(eng, batch)
    out = []
    for skey in sorted(plans):
        (seg,) = plans[skey]
        ids, mask = packed.storage_stream(eng, skey, plans[skey], batch)
        out.append((skey, ids, mask, seg))
    return out


def _alternate(sets):
    """A function that returns the members of ``sets`` in turn: timed calls
    alternate between two copies of their tables or accumulators, so that
    each call finds its own out of L2 (24 tables of 8.5 MB or accumulators
    of 9.5 MB: 204-229 MB a call, against 50 MB of L2)."""
    turn = [0]

    def pick():
        turn[0] ^= 1
        return sets[turn[0]]
    return pick


def _check_fold_group(got, items, what):
    """Each member of a grouped fold against its plain version: within
    FOLD_TOL plus FOLD_SUM_ULPS * L units of 2^-24 of each output's sum of
    |mask * row| over its L slots (either side's float32 sum of L products,
    in its own order, lies within L such units of the exact sum).  Returns
    the max abs error."""
    from recommendsystem_tpu_torch.embedding import packed

    err = 0.0
    for out, (table, ids, mask, c, l) in zip(got, items):
        if not out.numel():
            continue
        diff = (out - packed.fold_mean_plain(table, ids, mask, c, l)).abs()
        scale = packed.fold_mean_plain(table.abs(), ids, mask.abs(), c, l)
        excess = float((diff - FOLD_SUM_ULPS * l * 2.0 ** -24 * scale).max())
        if not excess <= FOLD_TOL:
            raise AssertionError(f"{what}: error {excess} above the sums' bound "
                                 f"> {FOLD_TOL}")
        err = max(err, float(diff.max()))
    return err


def fold_group_case(bundle, state, b, cycles_per_ms):
    """K1 as the predict and train steps launch it: one grouped call over
    all 24 autoint mean columns (5 ids) at batch ``b``, against the plain
    version of each column on the card.  Bound: the sum of the per-column
    bounds (``fold_case``'s formula); yardstick: 24 ``embedding_bag``
    calls, one a column."""
    from recommendsystem_tpu_torch.embedding import packed

    streams = _storage_streams(bundle, b, seed=b + 11)
    items = [(state.tables[skey]["w"], ids, mask, len(seg.keys), seg.l)
             for skey, ids, mask, seg in streams]
    pick = _alternate([items, [(t.clone(), i, m, c, l) for t, i, m, c, l in items]])
    return fold_items_case(f"fold_mean group b={b}", items, b, pick, cycles_per_ms)


def fold_items_case(what, items, b, pick, cycles_per_ms):
    """K1 as a step launches it: one grouped call over ``items`` ((table,
    ids, mask, c, l) members of batch ``b``), against the plain version of
    each member on the card.  ``pick`` returns the members of the timed
    calls in turn (copies of the tables, so that each call finds its
    tables out of L2).  Bound: the sum of the per-member bounds
    (``fold_case``'s formula, the table's rows at its own width); yardstick:
    one ``embedding_bag`` a member."""
    from recommendsystem_tpu_torch.embedding import packed

    got = packed.fold_mean_group(items)
    err = _check_fold_group(got, items, what)
    bags = []
    for table, ids, mask, c, l in items:
        bags.append((ids.view(c, l, b).permute(0, 2, 1).reshape(c * b, l).contiguous(),
                     mask.view(c, l, b).permute(0, 2, 1).reshape(c * b, l).contiguous()
                     .to(table.dtype)))

    def library():
        for (bag, wts), item in zip(bags, pick()):
            torch.nn.functional.embedding_bag(bag, item[0], mode="sum",
                                              per_sample_weights=wts)

    bound_ms, nbytes, ops = 0.0, 0, 0
    for table, ids, mask, c, l in items:
        live = mask != 0
        uniq = int(torch.unique(ids[live]).numel())
        d = table.shape[1]
        one = (ids.numel() * 4 + mask.numel() * 4 + uniq * d * table.element_size()
               + c * b * d * 4, 2 * int(live.sum()) * d)
        bound_ms += bound(*one)[0]
        nbytes, ops = nbytes + one[0], ops + one[1]
    iters = 240 if b <= 256 else 48
    # the plain version and the yardstick issue 24 or more launches a call:
    # at most 16 calls are queued behind the spin kernel, inside the card's
    # queue of pending launches, so that the events read device time
    few = 16
    ms, host_ms = timed(lambda: packed.fold_mean_group(pick()), iters, cycles_per_ms)
    return {"name": "fold_mean", "group": len(items), "b": b,
            "l": sorted({it[4] for it in items}), "d": sorted({it[0].shape[1] for it in items}),
            "dtype": _dtype_name(items[0][0]),
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": timed(lambda: [packed.fold_mean_plain(*it) for it in pick()],
                              few, cycles_per_ms)[0],
            "library_ms": timed(library, few, cycles_per_ms)[0],
            "library": f"{len(items)} x embedding_bag",
            "bound_ms": bound_ms, "bound_by": bound(nbytes, ops)[1],
            "bytes": nbytes, "ops": ops}


def _check_rows_group(got, items, what):
    """Each member of a grouped per-row fold against its plain version:
    equal (one product, rounded once on either side).  Returns the max abs
    error."""
    from recommendsystem_tpu_torch.embedding import packed

    err = 0.0
    for out, item in zip(got, items):
        want = packed.fold_rows_plain(*item)
        if out.shape != want.shape:
            raise AssertionError(f"{what}: shape {tuple(out.shape)}, expected "
                                 f"{tuple(want.shape)}")
        if out.numel():
            err = max(err, float((out - want).abs().max()))
    if err != 0.0:
        raise AssertionError(f"{what}: max abs err {err}, expected 0")
    return err


def rows_group_case(what, items, pick, cycles_per_ms):
    """K2 as a step launches it: one grouped call over ``items`` ((table,
    ids, mask) members), against the plain version of each member on the
    card.  ``pick`` returns the members of the timed calls in turn (copies
    of the tables, so that each call finds its tables out of L2).  Bound:
    each member's ids, mask, unique live rows and output once; yardstick:
    one ``embedding_bag`` a member (bags of one, the mask as weights)."""
    from recommendsystem_tpu_torch.embedding import packed

    got = packed.fold_rows_group(items)
    torch.cuda.synchronize()
    err = _check_rows_group(got, items, what)
    bags = [(ids.view(-1, 1), mask.view(-1, 1).to(table.dtype)) for table, ids, mask in items]

    def library():
        for (bag, wts), item in zip(bags, pick()):
            torch.nn.functional.embedding_bag(bag, item[0], mode="sum",
                                              per_sample_weights=wts)

    bound_ms, nbytes, ops = 0.0, 0, 0
    for table, ids, mask in items:
        live = mask != 0
        uniq = int(torch.unique(ids[live]).numel())
        d = table.shape[1]
        one = (ids.numel() * 8 + uniq * d * table.element_size() + ids.numel() * d * 4,
               int(live.sum()) * d)
        bound_ms += bound(*one)[0]
        nbytes, ops = nbytes + one[0], ops + one[1]
    e = max(ids.numel() for _, ids, _ in items)
    iters = 240 if e <= 256 else 48
    few = 16           # launches queued behind the spin kernel: see fold_group_case
    ms, host_ms = timed(lambda: packed.fold_rows_group(pick()), iters, cycles_per_ms)
    return {"name": "fold_rows", "case": what, "group": len(items),
            "dtype": _dtype_name(items[0][0]),
            "e": [ids.numel() for _, ids, _ in items][:3],
            "d": sorted({t.shape[1] for t, _, _ in items}),
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": timed(lambda: [packed.fold_rows_plain(*it) for it in pick()],
                              few, cycles_per_ms)[0],
            "library_ms": timed(library, few, cycles_per_ms)[0],
            "library": f"{len(items)} x embedding_bag",
            "bound_ms": bound_ms, "bound_by": bound(nbytes, ops)[1],
            "bytes": nbytes, "ops": ops}


def autoint_rows_case(bundle, state, b, cycles_per_ms):
    """K2 over autoint's 24 single-id columns (one a storage, D 8) at batch
    ``b``, tables alternating between two copies (204 MB a call)."""
    streams = _storage_streams(bundle, b, seed=b + 21, ids_per_feature=1)
    items = [(state.tables[skey]["w"], ids, mask) for skey, ids, mask, _ in streams]
    pick = _alternate([items, [(t.clone(), i, m) for t, i, m in items]])
    case = rows_group_case(f"autoint 24 columns, 1 id, b={b}", items, pick, cycles_per_ms)
    case["b"] = b
    return case


def unfold_group_case(bundle, b, cycles_per_ms):
    """K3 as the train step launches it: one grouped call over all the mean
    columns (5 ids; autoint's 24 of D 8, ctr's 24 of D 48, finish's 40 of
    D 32, staytime's 91 of D 32 in 46 storages) at batch ``b``, each
    column's gradient into its storage's accumulator, against the plain
    version on the card.  Bound: the sum of the per-column bounds
    (``unfold_case``'s formula); yardstick: one ``index_add_`` call of a
    prebuilt payload a column."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.embedding import packed

    eng = bundle.embedding
    batch = synthetic_batch(bundle, b, seed=b + 12)[0]
    plans = packed.plan_segments(eng, batch)
    gen = torch.Generator(device="cuda").manual_seed(b + 13)
    items, libs, accs = [], [], []
    for skey in sorted(plans):
        rows, d = eng.storage[skey]
        ids, mask = packed.storage_stream(eng, skey, plans[skey], batch)
        acc = torch.zeros(rows * (d + 1), device="cuda")
        accs.append(acc)
        lib_acc = torch.zeros((rows, d + 1), device="cuda")
        for seg in plans[skey]:
            if seg.kind != "mean" or seg.l == 1:
                continue
            for ci in range(len(seg.keys)):          # a member a column
                part = slice(seg.start + ci * seg.l * b, seg.start + (ci + 1) * seg.l * b)
                g = torch.randn((b, d), generator=gen, device="cuda")
                items.append((*_acc_views(acc, d), g, ids[part], mask[part], seg.l))
                libs.append((lib_acc, ids[part].long(),
                             _payload(g.repeat(seg.l, 1), mask[part])))
    packed.unfold_mean_scatter_group(items)
    d = items[0][2].shape[1]
    # a member's grads view starts its storage's accumulator
    wants = {acc.data_ptr(): torch.zeros_like(acc) for acc in accs}
    for grads, _, g, ids, mask, l in items:
        packed.unfold_mean_scatter_plain(*_acc_views(wants[grads.data_ptr()], d),
                                         g, ids, mask, l)
    err = max(_check_unfold(acc, wants[acc.data_ptr()], d, f"unfold_mean group b={b}")
              for acc in accs)
    others = {acc.data_ptr(): _acc_views(torch.zeros_like(acc), d) for acc in accs}
    pick = _alternate([items, [(*others[gr.data_ptr()], g, i, m, l)
                               for gr, _, g, i, m, l in items]])

    def library():
        for acc, lids, payload in libs:
            acc.index_add_(0, lids, payload)

    bound_ms, nbytes, ops = 0.0, 0, 0
    for _, _, g, ids, mask, l in items:
        one = _unfold_bytes_ops(ids, mask, b, g.shape[1])
        bound_ms += bound(*one)[0]
        nbytes, ops = nbytes + one[0], ops + one[1]
    iters = 240 if b <= 256 else 48
    few = 16           # launches queued behind the spin kernel: see fold_group_case
    ms, host_ms = timed(lambda: packed.unfold_mean_scatter_group(pick()), iters,
                        cycles_per_ms)
    return {"name": "unfold_mean", "group": len(items), "b": b, "l": items[0][5],
            "d": sorted({it[2].shape[1] for it in items}),
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": timed(lambda: [packed.unfold_mean_scatter_plain(*it) for it in pick()],
                              few, cycles_per_ms)[0],
            "library_ms": timed(library, few, cycles_per_ms)[0],
            "library": f"{len(items)} x index_add_",
            "bound_ms": bound_ms, "bound_by": bound(nbytes, ops)[1],
            "bytes": nbytes, "ops": ops}


def _unfold_rows_members(bundle, batch, seed):
    """K4's members as the train step hands them to its one grouped call:
    every single-id column and every sequence column of ``batch``, one
    member a column, each column's random (entries, D) gradient into its
    storage's zeroed accumulator (members of one storage share it).
    Returns (members, [(accumulator, D)])."""
    from recommendsystem_tpu_torch.embedding import packed

    eng = bundle.embedding
    plans = packed.plan_segments(eng, batch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    items, accs = [], []
    for skey in sorted(plans):
        rows, d = eng.storage[skey]
        ids, mask = packed.storage_stream(eng, skey, plans[skey], batch)
        acc = torch.zeros(rows * (d + 1), device="cuda")
        accs.append((acc, d))
        views = _acc_views(acc, d)
        for seg in plans[skey]:
            if seg.kind == "mean" and seg.l != 1:
                continue                               # K3's
            b = seg.size // len(seg.keys)
            for ci in range(len(seg.keys)):
                part = slice(seg.start + ci * b, seg.start + (ci + 1) * b)
                items.append((*views, torch.randn((b, d), generator=gen, device="cuda"),
                              ids[part], mask[part]))
    return items, accs


def unfold_rows_group_case(what, bundle, b, seed, cycles_per_ms, ipf=1):
    """K4 as the train step launches it since it is grouped: one call over
    every single-id and sequence column of a batch of ``b`` with ``ipf``
    ids a mean column (the 212-feature ctr's 180, autoint's 24, staytime's
    91 and 3 sequences with 1 id, its 3 sequences with 5), each into its
    storage's accumulator, against the plain version on the card; timed in
    turns with the per-column launches it replaces (``unfold_rows_scatter``
    a column, a group of one each: the kernel and launch a column that the
    step made before), accumulators alternating between two copies so that
    each call finds its own out of L2.  Bound: the sum of the per-column
    bounds (``unfold_case``'s formula); yardstick: one ``index_add_`` of a
    prebuilt payload a column."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.kernels import launch_counts

    batch = synthetic_batch(bundle, b, seed=seed, ids_per_feature=ipf)[0]
    items, accs = _unfold_rows_members(bundle, batch, seed + 1)
    before = launch_counts()["unfold_rows"]
    packed.unfold_rows_scatter_group(items)
    torch.cuda.synchronize()
    launches = launch_counts()["unfold_rows"] - before
    if launches != 1:
        raise AssertionError(f"{what}: {len(items)} members took {launches} launches, not 1")
    # a member's grads view starts its storage's accumulator
    wants = {acc.data_ptr(): torch.zeros_like(acc) for acc, _ in accs}
    for grads, _, g, ids, mask in items:
        want = wants[grads.data_ptr()]
        packed.unfold_rows_scatter_plain(*_acc_views(want, g.shape[1]), g, ids, mask)
    err = max(_check_unfold(acc, wants[acc.data_ptr()], d, f"unfold_rows group, {what}")
              for acc, d in accs)
    others = {acc.data_ptr(): _acc_views(torch.zeros_like(acc), d) for acc, d in accs}
    sets = [items, [(*others[gr.data_ptr()], g, i, m) for gr, _, g, i, m in items]]
    pick = _alternate(sets)
    libs = []
    lib_accs = {}
    for grads, _, g, ids, mask in items:
        key = grads.data_ptr()
        if key not in lib_accs:
            lib_accs[key] = torch.zeros((grads.shape[0], g.shape[1] + 1), device="cuda")
        libs.append((lib_accs[key], ids.long(), _payload(g, mask)))

    def library():
        for acc, lids, payload in libs:
            acc.index_add_(0, lids, payload)

    def per_column():
        for item in pick():
            packed.unfold_rows_scatter(*item)

    bound_ms, nbytes, ops = 0.0, 0, 0
    for _, _, g, ids, mask in items:
        one = _unfold_bytes_ops(ids, mask, g.shape[0], g.shape[1])
        bound_ms += bound(*one)[0]
        nbytes, ops = nbytes + one[0], ops + one[1]
    iters = 48
    few = 4            # calls of one launch a member queued behind the spin kernel
    grouped, columns = [], []
    for kind in ("grouped", "columns", "columns", "grouped"):
        if kind == "grouped":
            grouped.append(timed(lambda: packed.unfold_rows_scatter_group(pick()), iters,
                                 cycles_per_ms))
        else:
            columns.append(timed(per_column, few, cycles_per_ms))
    return {"name": "unfold_rows", "case": what, "group": len(items), "b": b, "l": 1,
            "d": sorted({it[2].shape[1] for it in items}), "storages": len(accs),
            "max_abs_err": err, "ms": min(m for m, _ in grouped),
            "ms_runs": [m for m, _ in grouped], "host_ms": min(h for _, h in grouped),
            "host_ms_runs": [h for _, h in grouped],
            "per_column_ms_runs": [m for m, _ in columns],
            "per_column_host_ms_runs": [h for _, h in columns],
            "plain_ms": timed(lambda: [packed.unfold_rows_scatter_plain(*it) for it in pick()],
                              2, cycles_per_ms)[0],
            "library_ms": timed(library, few, cycles_per_ms)[0],
            "library": f"{len(items)} x index_add_",
            "bound_ms": bound_ms, "bound_by": bound(nbytes, ops)[1],
            "bytes": nbytes, "ops": ops}


def _group_members(members, rows, seed):
    """Random (table, ids, mask, c, l) fold members (unscaled normal rows)
    and (grads, counts, g, ids, mask, l) unfold members of the (D, L, B)
    shapes given, c = 2 and 1; ragged live counts, padding id 0 with mask
    0."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    folds, unfolds = [], []
    for d, l, b in members:
        for c in (2, 1):
            lens = torch.randint(0, l + 1, (c, 1, b), generator=gen, device="cuda")
            mask = (torch.arange(l, device="cuda")[None, :, None] < lens).float()
            ids = (torch.randint(0, rows, (c, l, b), generator=gen, device="cuda",
                                 dtype=torch.int32) * mask.int())
            if c == 2:
                folds.append((torch.randn((rows, d), generator=gen, device="cuda"),
                              ids.reshape(-1), mask.reshape(-1), c, l))
            else:
                unfolds.append((*_acc_views(torch.zeros(rows * (d + 1), device="cuda"), d),
                                torch.randn((b, d), generator=gen, device="cuda"),
                                ids.reshape(-1), mask.reshape(-1), l))
    return folds, unfolds


def group_check_case(name, members, launches):
    """Grouped K1, K2 (the same members' streams, one row an entry) and K3
    over the members given, against their plain versions, with the
    launches each must take (``launches``: {kernel: launches})."""
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.kernels import launch_counts

    folds, unfolds = _group_members(members, rows=20011, seed=len(members))
    rows = [(table, ids, mask) for table, ids, mask, _, _ in folds]
    before = launch_counts()
    got = packed.fold_mean_group(folds)
    got_rows = packed.fold_rows_group(rows)
    packed.unfold_mean_scatter_group(unfolds)
    torch.cuda.synchronize()
    after = launch_counts()
    for k, n in launches.items():
        if after[k] - before[k] != n:
            raise AssertionError(f"{name}: {k} launched {after[k] - before[k]} times, "
                                 f"not {n}")
    err = _check_fold_group(got, folds, f"fold_mean {name}")
    rerr = _check_rows_group(got_rows, rows, f"fold_rows {name}")
    uerr = 0.0
    for grads, counts, g, ids, mask, l in unfolds:
        want = torch.zeros_like(_flat(grads, counts))
        packed.unfold_mean_scatter_plain(*_acc_views(want, g.shape[1]), g, ids, mask, l)
        uerr = max(uerr, _check_unfold(_flat(grads, counts), want, g.shape[1],
                                       f"unfold_mean {name}"))
    return [{"name": "fold_mean", "check": name, "members": len(folds), "b": 0,
             "max_abs_err": err},
            {"name": "fold_rows", "check": name, "members": len(rows), "b": 0,
             "max_abs_err": rerr},
            {"name": "unfold_mean", "check": name, "members": len(unfolds), "b": 0,
             "max_abs_err": uerr}]


# the mixed group: D 8, 16, 32 and 48, L 2, 5 and 10, one empty column
MIXED_GROUP = ((8, 5, 4096), (16, 2, 300), (32, 10, 1000), (48, 5, 256), (8, 10, 0),
               (48, 2, 777))
GROUP_65 = tuple((8 * (1 + i % 3), 2 + i % 9, 64 + 7 * i) for i in range(65))


def _check_adam(got, want, before, acc0, accs, what, twins=None):
    """K8's result against the plain version's: w within ADAM_W_TOL, m and v
    within ADAM_M_RTOL (bf16 ones by the bf16 rule against ``twins``, the
    plain version's float32 values), t and show exact, rows with count 0
    bit-identical, every accumulator left zero.  Returns the max abs error
    of w."""
    err = 0.0
    for i, (g, w, b, a0, a) in enumerate(zip(got, want, before, acc0, accs)):
        err = max(err, float((g["w"].float() - w["w"].float()).abs().max()))
        if g["w"].dtype == torch.bfloat16:
            _check_bf16(g["w"], twins[i]["w"], ADAM_W_TOL, 0.0, f"{what} w")
        else:
            torch.testing.assert_close(g["w"], w["w"], rtol=0, atol=ADAM_W_TOL)
        for n in ("m", "v"):
            if g["opt"][n].dtype == torch.bfloat16:
                _check_bf16(g["opt"][n], twins[i]["opt"][n], 0.0, ADAM_M_RTOL, f"{what} {n}")
            else:
                torch.testing.assert_close(g["opt"][n], w["opt"][n], rtol=ADAM_M_RTOL, atol=0)
        for x, y in ((g["opt"]["t"], w["opt"]["t"]), (g["show"], w["show"])):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        dead = _acc_views(a0, g["w"].shape[1])[1][:, 0] == 0
        for x, y in ((g["w"], b["w"]), (g["opt"]["m"], b["opt"]["m"]),
                     (g["opt"]["v"], b["opt"]["v"]), (g["opt"]["t"], b["opt"]["t"]),
                     (g["show"], b["show"])):
            if not torch.equal(x[dead], y[dead]):
                raise AssertionError(f"{what}: a row with count 0 changed")
        if a.any():
            raise AssertionError(f"{what}: sparse_adam_update left an accumulator non-zero")
    return err


def _adam_bytes(acc0, dims, sizes=None):
    """A live row reads acc (D+1), w, m, v (D each), t and show, and writes
    all of them; a row with count 0 reads its count.  ``sizes``: each
    storage's bytes a value of w and of m and v (default float32's 4)."""
    nbytes = ops = 0
    for i, (a, d) in enumerate(zip(acc0, dims)):
        sw, sm = sizes[i] if sizes else (4, 4)
        cnt = _acc_views(a, d)[1]
        live = int((cnt > 0).sum())
        nbytes += (live * (4 * (2 * (d + 1) + 4) + 2 * d * (sw + 2 * sm))
                   + (cnt.shape[0] - live) * 4)
        ops += live * d * 14
    return nbytes, ops


def adam_case(eng, tables, batch, cycles_per_ms):
    """K8 as the train step issues it: one grouped pass over every storage
    (autoint's or ctr's 24, the 212-feature ctr's 36, finish's 40), with
    the counts and gradients that one train batch
    leaves in the accumulators, against the plain ``SparseAdam.update`` on
    each storage in turn; also one storage alone.  The pass clears the
    accumulators, so each timed call first restores them with one copy
    (the accumulators are views of one buffer): ``ms`` is the time of
    restore + pass less the time of the restore alone.  Yardstick: one
    ``torch.optim.Adam`` (foreach) step over the same tables as dense
    parameters, a non-lazy update."""
    from recommendsystem_tpu_torch.embedding import packed

    skeys = sorted(tables)
    plans = packed.plan_segments(eng, batch, storages=set(skeys))
    dims = [eng.storage[k][1] for k in skeys]
    sizes = [eng.storage[k][0] * (eng.storage[k][1] + 1) for k in skeys]
    flat0 = torch.zeros(sum(sizes), device="cuda")
    acc0 = list(flat0.split(sizes))
    gen = torch.Generator(device="cuda").manual_seed(3)
    for skey, a, d in zip(skeys, acc0, dims):
        (seg,) = plans[skey]
        ids, mask = packed.storage_stream(eng, skey, plans[skey], batch)
        g = torch.randn((ids.shape[0] // seg.l, d), generator=gen, device="cuda") * 1e-3
        packed.unfold_mean_scatter_plain(*_acc_views(a, d), g, ids, mask, seg.l)
    flat = flat0.clone()
    accs = list(flat.split(sizes))
    opt = eng.sparse_opt
    before = [tables[k] for k in skeys]
    got = [_to(t, "cuda") for t in before]
    want = [_to(t, "cuda") for t in before]
    packed.sparse_adam_update_group(opt, got, accs)
    for w, a in zip(want, acc0):
        packed.sparse_adam_update_plain(opt, w, a.clone())
    twins = _float32_twins(before)
    for w, a in zip(twins, acc0):
        packed.sparse_adam_update_plain(dataclasses.replace(opt, state_dtype=torch.float32),
                                        w, a.clone())
    torch.cuda.synchronize()
    err = _check_adam(got, want, before, acc0, accs,
                      f"sparse_adam_update ({len(skeys)} storages)", twins)
    del twins

    def restore():
        flat.copy_(flat0)

    def kernel():
        restore()
        packed.sparse_adam_update_group(opt, got, accs)

    def single():
        accs[0].copy_(acc0[0])
        packed.sparse_adam_update(opt, got[0], accs[0])

    def plain():
        restore()
        for w, a in zip(want, accs):
            packed.sparse_adam_update_plain(opt, w, a)

    params = [torch.nn.Parameter(t["w"].clone()) for t in before]
    for p, a, d in zip(params, acc0, dims):
        p.grad = _acc_views(a, d)[0].to(p.dtype, copy=True)
    dense = torch.optim.Adam(params, lr=opt.learning_rate, foreach=True)
    sizes = [(t["w"].element_size(), t["opt"]["m"].element_size()) for t in before]
    nbytes, ops = _adam_bytes(acc0, dims, sizes)
    bms, by = bound(nbytes, ops)
    one_bytes, one_ops = _adam_bytes(acc0[:1], dims[:1], sizes[:1])
    iters = 24
    ms_restore = timed(restore, iters, cycles_per_ms)[0]
    ms_restore1 = timed(lambda: accs[0].copy_(acc0[0]), iters, cycles_per_ms)[0]
    ms, host_ms = timed(kernel, iters, cycles_per_ms)
    single_ms, single_host_ms = timed(single, iters, cycles_per_ms)
    return {"name": "sparse_adam_update", "storages": len(skeys),
            "dtype": _dtype_name(before[0]["w"]),
            "moments": _dtype_name(before[0]["opt"]["m"]),
            "b": next(iter(batch.values())).rows.shape[0],
            "rows": sum(eng.storage[k][0] for k in skeys), "d": sorted(set(dims)),
            "live_rows": sum(int((_acc_views(a, d)[1] > 0).sum())
                             for a, d in zip(acc0, dims)),
            "max_abs_err": err, "ms": ms - ms_restore, "restore_ms": ms_restore,
            "host_ms": host_ms,
            "single_storage": {"ms": single_ms - ms_restore1, "restore_ms": ms_restore1,
                               "host_ms": single_host_ms,
                               "bound_ms": bound(one_bytes, one_ops)[0]},
            "plain_ms": timed(plain, 4, cycles_per_ms)[0] - ms_restore,
            "library_ms": timed(dense.step, iters, cycles_per_ms)[0],
            "library": "torch.optim.Adam(foreach=True), dense over the tables",
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops}


def adam_mixed_case():
    """K8 over one group of storages of D 8, 48, 56, 3 and 1 (rows odd,
    100,003 to 2,001; a third of the rows live, the D = 1 storage all
    dead) against the plain version: the grouped launch with storages of
    other widths than autoint's."""
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.embedding.optimizers import SparseAdam

    gen = torch.Generator(device="cuda").manual_seed(17)
    before, acc0 = [], []
    for rows, d, live in ((100003, 8, 0.3), (30001, 48, 0.3), (20011, 56, 0.3),
                          (5003, 3, 0.3), (2001, 1, 0.0)):
        cnt = torch.where(torch.rand((rows, 1), generator=gen, device="cuda") < live,
                          torch.randint(1, 5, (rows, 1), generator=gen, device="cuda"),
                          0).float()
        acc0.append(torch.cat([(torch.randn((rows, d), generator=gen, device="cuda")
                                * 1e-2 * (cnt > 0)).reshape(-1), cnt.reshape(-1)]))
        before.append({
            "w": torch.randn((rows, d), generator=gen, device="cuda"),
            "opt": {"m": torch.randn((rows, d), generator=gen, device="cuda") * 1e-3,
                    "v": torch.rand((rows, d), generator=gen, device="cuda") * 1e-5,
                    "t": torch.randint(0, 4, (rows, 1), generator=gen, device="cuda").float()},
            "show": torch.randint(0, 9, (rows, 1), generator=gen, device="cuda").float()})
    opt = SparseAdam(learning_rate=1e-3)
    got = [_to(t, "cuda") for t in before]
    want = [_to(t, "cuda") for t in before]
    accs = [a.clone() for a in acc0]
    packed.sparse_adam_update_group(opt, got, accs)
    for w, a in zip(want, acc0):
        packed.sparse_adam_update_plain(opt, w, a.clone())
    torch.cuda.synchronize()
    err = _check_adam(got, want, before, acc0, accs, "sparse_adam_update (mixed D)")
    return {"name": "sparse_adam_update", "b": 0, "d": [8, 48, 56, 3, 1],
            "max_abs_err": err}


def _check_adagrad(got, want, before, acc0, accs, what, twins=None):
    """K9's result against the plain version's: w within ADAGRAD_W_TOL (a
    bf16 w by the bf16 rule against ``twins``, the plain version's float32
    values), g2sum within ADAGRAD_G2_RTOL, show exact, rows with count 0
    bit-identical, every accumulator left zero.  Returns the max abs error
    of w."""
    err = 0.0
    for i, (g, w, b, a0, a) in enumerate(zip(got, want, before, acc0, accs)):
        if g["w"].numel():
            err = max(err, float((g["w"].float() - w["w"].float()).abs().max()))
        if g["w"].dtype == torch.bfloat16:
            _check_bf16(g["w"], twins[i]["w"], ADAGRAD_W_TOL, 0.0, f"{what} w")
        else:
            torch.testing.assert_close(g["w"], w["w"], rtol=0, atol=ADAGRAD_W_TOL)
        torch.testing.assert_close(g["opt"]["g2sum"], w["opt"]["g2sum"],
                                   rtol=ADAGRAD_G2_RTOL, atol=0)
        torch.testing.assert_close(g["show"], w["show"], rtol=0, atol=0)
        dead = _acc_views(a0, g["w"].shape[1])[1][:, 0] == 0
        for x, y in ((g["w"], b["w"]), (g["opt"]["g2sum"], b["opt"]["g2sum"]),
                     (g["show"], b["show"])):
            if not torch.equal(x[dead], y[dead]):
                raise AssertionError(f"{what}: a row with count 0 changed")
        if a.any():
            raise AssertionError(f"{what}: sparse_adagrad_update left an accumulator non-zero")
    return err


def _adagrad_bytes(acc0, dims, sizes=None):
    """A live row reads G and its count and writes them back zero, reads and
    writes w, g2sum and show: 4 (2 D + 6) + 2 D sw B (sw: the bytes of a
    value of w, each storage's in ``sizes``, default float32's 4); a row
    with count 0 reads its count.  Operations: D squares and adds, a
    quotient, an add and a root, and a product, quotient and difference a
    lane."""
    nbytes = ops = 0
    for i, (a, d) in enumerate(zip(acc0, dims)):
        sw = sizes[i] if sizes else 4
        cnt = _acc_views(a, d)[1]
        live = int((cnt > 0).sum())
        nbytes += live * (4 * (2 * d + 6) + 2 * d * sw) + (cnt.shape[0] - live) * 4
        ops += live * (5 * d + 3)
    return nbytes, ops


def _train_accumulators(eng, skeys, batch, seed):
    """One flat buffer of the accumulators of ``skeys`` (views of it, in
    order) holding what one train batch leaves there: random gradients of
    each column's activations (scale 1e-2) scattered by the plain K3 and
    K4 with their counts."""
    from recommendsystem_tpu_torch.embedding import packed

    plans = packed.plan_segments(eng, batch, storages=set(skeys))
    dims = [eng.storage[k][1] for k in skeys]
    sizes = [eng.storage[k][0] * (eng.storage[k][1] + 1) for k in skeys]
    flat0 = torch.zeros(sum(sizes), device="cuda")
    accs = list(flat0.split(sizes))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for skey, a, d in zip(skeys, accs, dims):
        if skey not in plans:
            continue
        ids, mask = packed.storage_stream(eng, skey, plans[skey], batch)
        views = _acc_views(a, d)
        for seg in plans[skey]:
            if seg.kind == "mean" and seg.l > 1:
                b = seg.size // (len(seg.keys) * seg.l)
                for ci in range(len(seg.keys)):
                    part = slice(seg.start + ci * seg.l * b, seg.start + (ci + 1) * seg.l * b)
                    g = torch.randn((b, d), generator=gen, device="cuda") * 1e-2
                    packed.unfold_mean_scatter_plain(*views, g, ids[part], mask[part], seg.l)
            else:
                part = slice(seg.start, seg.start + seg.size)
                g = torch.randn((seg.size, d), generator=gen, device="cuda") * 1e-2
                packed.unfold_rows_scatter_plain(*views, g, ids[part], mask[part])
    return flat0, accs, dims, sizes


def adagrad_case(eng, tables, batch, cycles_per_ms):
    """K9 as the train step issues it: one grouped pass over every storage
    (staytime's 46), with the counts and gradients that one train batch
    leaves in the accumulators (``_train_accumulators``), against
    ``sparse_adagrad_update_plain`` on each storage in turn.  The pass
    clears the accumulators, so each timed call first restores them with
    one copy (the accumulators are views of one buffer): ``ms`` is the time
    of restore + pass less the time of the restore alone.  Yardstick, not
    the same function: one ``torch.optim.Adagrad`` (foreach) step over the
    same tables as dense parameters (per-element state, every row)."""
    from recommendsystem_tpu_torch.embedding import packed

    skeys = sorted(tables)
    flat0, acc0, dims, sizes = _train_accumulators(eng, skeys, batch, seed=23)
    flat = flat0.clone()
    accs = list(flat.split(sizes))
    opt = eng.sparse_opt
    before = [tables[k] for k in skeys]
    got = [_to(t, "cuda") for t in before]
    want = [_to(t, "cuda") for t in before]
    packed.sparse_adagrad_update_group(opt, got, accs)
    for w, a in zip(want, acc0):
        packed.sparse_adagrad_update_plain(opt, w, a.clone())
    twins = _float32_twins(before)
    for w, a in zip(twins, acc0):
        packed.sparse_adagrad_update_plain(opt, w, a.clone())
    torch.cuda.synchronize()
    err = _check_adagrad(got, want, before, acc0, accs,
                         f"sparse_adagrad_update ({len(skeys)} storages)", twins)
    del twins

    def restore():
        flat.copy_(flat0)

    def kernel():
        restore()
        packed.sparse_adagrad_update_group(opt, got, accs)

    def plain():
        restore()
        for w, a in zip(want, accs):
            packed.sparse_adagrad_update_plain(opt, w, a)

    params = [torch.nn.Parameter(t["w"].clone()) for t in before]
    for p, a, d in zip(params, acc0, dims):
        p.grad = _acc_views(a, d)[0].to(p.dtype, copy=True)
    dense = torch.optim.Adagrad(params, lr=opt.learning_rate,
                                initial_accumulator_value=opt.initial_g2sum, foreach=True)
    nbytes, ops = _adagrad_bytes(acc0, dims, [t["w"].element_size() for t in before])
    bms, by = bound(nbytes, ops)
    iters = 24
    ms_restore = timed(restore, iters, cycles_per_ms)[0]
    ms, host_ms = timed(kernel, iters, cycles_per_ms)
    return {"name": "sparse_adagrad_update", "storages": len(skeys),
            "dtype": _dtype_name(before[0]["w"]),
            "b": next(iter(batch.values())).rows.shape[0],
            "rows": sum(eng.storage[k][0] for k in skeys), "d": sorted(set(dims)),
            "live_rows": sum(int((_acc_views(a, d)[1] > 0).sum())
                             for a, d in zip(acc0, dims)),
            "max_abs_err": err, "ms": ms - ms_restore, "restore_ms": ms_restore,
            "host_ms": host_ms,
            "plain_ms": timed(plain, 4, cycles_per_ms)[0] - ms_restore,
            "library_ms": timed(dense.step, iters, cycles_per_ms)[0],
            "library": "torch.optim.Adagrad(foreach=True) over the tables: not the same "
                       "function (dense, per-element state)",
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops}


def adagrad_mixed_case(cycles_per_ms):
    """K9 over groups of storages of D 8, 16, 32, 48 and 3 (odd rows, a
    third of them live), one empty and one with no live row, in one launch,
    and over a group of 65 storages in two, against the plain version; each
    group timed as ``adagrad_case`` times the 46 storages (its accumulators
    views of one buffer, restored by one copy before each call), with its
    bound and ``torch.optim.Adagrad`` over its tables as the yardstick."""
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.embedding.optimizers import SparseAdaGrad
    from recommendsystem_tpu_torch.kernels import launch_counts

    gen = torch.Generator(device="cuda").manual_seed(19)
    opt = SparseAdaGrad(learning_rate=0.05)
    shapes = ((100003, 8, 0.3), (30001, 16, 0.3), (0, 32, 0.3), (20011, 32, 0.3),
              (5003, 48, 0.3), (2001, 3, 0.3), (4099, 32, 0.0))
    out = []
    for group, launches in ((shapes, 1), ([(301 + 7 * i, (8, 16, 32, 48)[i % 4], 0.3)
                                           for i in range(65)], 2)):
        before, acc0 = [], []
        for rows, d, live in group:
            cnt = torch.where(torch.rand((rows, 1), generator=gen, device="cuda") < live,
                              torch.randint(1, 5, (rows, 1), generator=gen, device="cuda"),
                              0).float()
            acc0.append(torch.cat([(torch.randn((rows, d), generator=gen, device="cuda")
                                    * 1e-2 * (cnt > 0)).reshape(-1), cnt.reshape(-1)]))
            before.append({
                "w": torch.rand((rows, d), generator=gen, device="cuda") * 0.2 - 0.1,
                "opt": {"g2sum": torch.rand((rows, 1), generator=gen, device="cuda") + 0.1},
                "show": torch.randint(0, 9, (rows, 1), generator=gen, device="cuda").float()})
        got = [_to(t, "cuda") for t in before]
        want = [_to(t, "cuda") for t in before]
        accs = [a.clone() for a in acc0]
        n0 = launch_counts()["sparse_adagrad_update"]
        packed.sparse_adagrad_update_group(opt, got, accs)
        torch.cuda.synchronize()
        if launch_counts()["sparse_adagrad_update"] - n0 != launches:
            raise AssertionError(f"sparse_adagrad_update: {len(group)} storages took "
                                 f"{launch_counts()['sparse_adagrad_update'] - n0} launches")
        for w, a in zip(want, acc0):
            packed.sparse_adagrad_update_plain(opt, w, a.clone())
        err = _check_adagrad(got, want, before, acc0, accs,
                             f"sparse_adagrad_update ({len(group)} mixed)")

        dims = [d for _, d, _ in group]
        sizes = [a.numel() for a in acc0]
        flat0 = torch.cat(acc0)
        flat = flat0.clone()
        views = list(flat.split(sizes))

        def restore():
            flat.copy_(flat0)

        def kernel():
            restore()
            packed.sparse_adagrad_update_group(opt, got, views)

        def plain():
            restore()
            for w, a in zip(want, views):
                packed.sparse_adagrad_update_plain(opt, w, a)

        params = [torch.nn.Parameter(t["w"].clone()) for t in before if t["w"].numel()]
        for p, a, d in zip(params, [a for a in acc0 if a.numel()],
                           [d for (r, d, _) in group if r]):
            p.grad = _acc_views(a, d)[0].to(p.dtype, copy=True)
        dense = torch.optim.Adagrad(params, lr=opt.learning_rate,
                                    initial_accumulator_value=opt.initial_g2sum, foreach=True)
        nbytes, ops = _adagrad_bytes(acc0, dims)
        bms, by = bound(nbytes, ops)
        ms_restore = timed(restore, 24, cycles_per_ms)[0]
        ms, host_ms = timed(kernel, 24, cycles_per_ms)
        out.append({"name": "sparse_adagrad_update", "b": 0, "group": "mixed",
                    "storages": len(group), "d": sorted(set(dims)), "launches": launches,
                    "rows": sum(r for r, _, _ in group),
                    "live_rows": sum(int((_acc_views(a, d)[1] > 0).sum())
                                     for a, d in zip(acc0, dims)),
                    "max_abs_err": err, "ms": ms - ms_restore, "restore_ms": ms_restore,
                    "host_ms": host_ms,
                    "plain_ms": timed(plain, 4, cycles_per_ms)[0] - ms_restore,
                    "library_ms": timed(dense.step, 24, cycles_per_ms)[0],
                    "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops})
    return out


def din_ops(positions, b, h, dtype):
    """Multiply-adds x 2 the DIN pool needs: in float32 the folded form
    (h * 16 + 16 + h per scored position, 2 * h * 16 per sample; the TPU
    kernel's count of the unfolded features, ``din_pallas.py:64-67``,
    overstates them); in bf16 the features q - f and q * f are rounded
    before the product, so only the query's block folds: 3 * h * 16 + 16 +
    h per position, h * 16 per sample."""
    if dtype == torch.float32:
        return 2 * positions * (h * 16 + 16 + h) + 2 * b * (2 * h * 16)
    return 2 * positions * (3 * h * 16 + 16 + h) + 2 * b * (h * 16)


def din_case(b, seed, cycles_per_ms, dtype=torch.float32):
    """K7 against ``din_pool_plain`` on the model's views: query and facts
    the first 16 lanes of 32-lane rows, T = 50; row 0's mask all 0 over
    nonzero facts, every fourth row of full length.  Bound: the operations
    of ``din_ops``; bytes: facts, mask, query, weights and output once.
    ``dtype`` bf16: query, facts and weights in bf16 (the bf16 compute
    policy), the float32 kernel on the widened values timed beside it."""
    from recommendsystem_tpu_torch.kernels.din import din_pool, din_pool_plain

    t, h = 50, 16
    g = torch.Generator(device="cuda").manual_seed(seed)
    query = torch.randn((b, 2 * h), generator=g, device="cuda").to(dtype)[:, :h]
    facts = torch.randn((b, t, 2 * h), generator=g, device="cuda").to(dtype)[:, :, :h]
    lens = torch.randint(1, t + 1, (b,), generator=g, device="cuda")
    lens[::4] = t
    lens[0] = 0
    mask = (torch.arange(t, device="cuda")[None, :] < lens[:, None]).float()
    w1 = torch.randn((4 * h, 16), generator=g, device="cuda") * 0.2
    b1, w2, b2 = (torch.randn(shape, generator=g, device="cuda") * 0.3
                  for shape in ((16,), (16, 1), (1,)))
    w1, b1, w2, b2 = (w.to(dtype) for w in (w1, b1, w2, b2))
    args = (query, facts, mask, w1, b1, w2, b2)
    got = din_pool(*args)
    want = din_pool_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    mean_err = float((got[0] - facts[0].float().mean(dim=0)).abs().max())
    if not (err <= DIN_TOL and mean_err <= DIN_TOL):
        raise AssertionError(f"din_pool b={b}: max abs err {err}, all-masked row "
                             f"{mean_err}")
    es = facts.element_size()
    nbytes = es * (b * t * h + b * h) + 4 * (b * t + b * h) + es * (4 * h * 16 + 16 + 16 + 1)
    ops = din_ops(b * t, b, h, dtype)
    bms, by = bound(nbytes, ops)
    iters = 240 if b <= 256 else 48
    ms, host_ms = timed(lambda: din_pool(*args), iters, cycles_per_ms)
    fp32_ms = None
    if dtype != torch.float32:
        wide = [x.float() if x.is_floating_point() else x for x in args]
        fp32_ms = timed(lambda: din_pool(*wide), iters, cycles_per_ms)[0]
    return {"name": "din_pool", "dtype": _dtype_name(facts), "fp32_ms": fp32_ms,
            "b": b, "t": t, "h": h, "max_abs_err": err,
            "all_masked_row_err": mean_err, "ms": ms, "host_ms": host_ms,
            "plain_ms": timed(lambda: din_pool_plain(*args), iters, cycles_per_ms)[0],
            "library_ms": None, "bound_ms": bms, "bound_by": by, "bytes": nbytes,
            "ops": ops}


def din_gather_case(bundle, state, b, seed, cycles_per_ms, facts_dtype=torch.float32):
    """K7 as the predict step launches it: ``din_pool_gather`` on the first
    behaviour sequence of a full-width staytime batch (T = 50, the
    storage's (163,848 x 32) table, the facts lanes 0-16 of each row, the
    query the first 16 lanes of 32-lane rows, the model's seeded pool
    weights), against its plain version on the card.  Every third row's
    mask is all 0 over its ids (padding over nonzero rows), so its output
    must be 0.  The timed calls take four copies of the table in turn (84
    MB), so that each finds its table out of L2.  Timed beside it: the
    path it replaces, K2 (``fold_rows``) then K7 on the K2 rows
    (``din_pool``).  Bound: ids and mask, the unique live half-rows (64
    bytes), query and output once; operations as ``din_case``, but for the
    live positions only (a masked one needs no score).  ``facts_dtype``
    bf16: the bf16 compute policy's pool (bf16 query and weights, each fact
    rounded to bf16 as it is read), the float32 pool on the same table
    timed beside it (``fp32_ms``) in place of the replaced path."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.kernels.din import (din_pool, din_pool_gather,
                                                       din_pool_gather_plain)

    eng = bundle.embedding
    batch = synthetic_batch(bundle, b, seed=seed, ids_per_feature=5)[0]
    plans = packed.plan_segments(eng, batch)
    skey, seg = next((k, g) for k in sorted(plans) for g in plans[k] if g.kind == "seq")
    ids, mask = packed.storage_stream(eng, skey, plans[skey], batch)
    part = slice(seg.start, seg.start + seg.size)
    t = seg.l
    ids, mask = ids[part].view(b, t), mask[part].view(b, t).clone()
    mask[::3] = 0.0
    dead = mask.sum(dim=1) == 0
    table = state.tables[skey]["w"]
    if not float(table[ids[dead].long()].abs().amax(dim=-1).min()) > 0.0:
        raise AssertionError("din_pool_gather case: a padding id over a zero row")
    h = 16
    g = torch.Generator(device="cuda").manual_seed(seed)
    query32 = torch.randn((b, 2 * h), generator=g, device="cuda")
    query = query32.to(facts_dtype)[:, :h]
    query32 = query32[:, :h]
    (slot,) = seg.keys
    pool = "din_" + slot.removeprefix("seq_")
    weights32 = [state.params[f"{pool}.{n}"] for n in ("w1", "b1", "w2", "b2")]
    weights = [w.to(facts_dtype) for w in weights32]
    lanes = (0, h)
    with torch.inference_mode():
        got = din_pool_gather(query, table, ids, mask, lanes, *weights, facts_dtype=facts_dtype)
        want = din_pool_gather_plain(query, table, ids, mask, lanes, *weights,
                                     facts_dtype=facts_dtype)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not (err <= DIN_TOL and not got[dead].any()):
            raise AssertionError(f"din_pool_gather b={b}: max abs err {err}, rows of "
                                 f"all-0 masks {float(got[dead].abs().max())}")
        tables = [table] + [table.clone() for _ in range(3)]
        turn = [0]

        def pick():
            turn[0] = (turn[0] + 1) % len(tables)
            return tables[turn[0]]

        flat_ids, flat_mask = ids.reshape(-1), mask.reshape(-1)

        def parent_path():
            rows = packed.fold_rows(pick(), flat_ids, flat_mask).view(b, t, -1)
            return din_pool(query, rows[:, :, 0:h], mask, *weights)

        live = mask != 0
        uniq = int(torch.unique(ids[live]).numel())
        es = query.element_size()
        nbytes = (4 * (2 * b * t + b * h) + es * b * h + uniq * h * table.element_size()
                  + sum(es * w.numel() for w in weights))
        # only a live position needs its score
        ops = din_ops(int(live.sum()), b, h, facts_dtype)
        bms, by = bound(nbytes, ops)
        iters = 240 if b <= 256 else 48
        ms, host_ms = timed(lambda: din_pool_gather(query, pick(), ids, mask, lanes,
                                                    *weights, facts_dtype=facts_dtype),
                            iters, cycles_per_ms)
        path_ms = path_host_ms = fp32_ms = None
        if facts_dtype == torch.float32:
            path_ms, path_host_ms = timed(parent_path, iters, cycles_per_ms)
        else:
            fp32_ms = timed(lambda: din_pool_gather(query32, pick(), ids, mask, lanes,
                                                    *weights32), iters, cycles_per_ms)[0]
        plain_ms = timed(lambda: din_pool_gather_plain(query, pick(), ids, mask, lanes,
                                                       *weights, facts_dtype=facts_dtype),
                         iters, cycles_per_ms)[0]
    return {"name": "din_pool", "entry": "gather", "b": b, "t": t, "h": h,
            "dtype": _dtype_name(table), "compute": _dtype_name(query), "fp32_ms": fp32_ms,
            "rows_all_masked": int(dead.sum()), "live": int(live.sum()),
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "path_ms": path_ms, "path_host_ms": path_host_ms,
            "path": "fold_rows + din_pool (the path before this entry)",
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "ops": ops}


def staytime_fold_case(bundle, state, cycles_per_ms):
    """K1 as the staytime predict and train steps launch it at B = 16384
    with 5 ids: one grouped call over the 46 mean segments (a storage's
    mean columns of one L fold as one member), its tables out of L2 on
    every call (477-954 MB)."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.embedding import packed

    eng, b = bundle.embedding, STAYTIME_BATCH
    batch = synthetic_batch(bundle, b, seed=61, ids_per_feature=5)[0]
    plans = packed.plan_segments(eng, batch)
    means = []
    for skey in sorted(plans):
        ids, mask = packed.storage_stream(eng, skey, plans[skey], batch)
        for seg in plans[skey]:
            if seg.kind == "mean":
                part = slice(seg.start, seg.start + seg.size)
                means.append((state.tables[skey]["w"], ids[part], mask[part],
                              len(seg.keys), seg.l))
    if len(means) != 46:
        raise AssertionError(f"staytime: {len(means)} mean segments, expected 46")
    return fold_items_case(f"staytime 46 mean segments, b={b}", means, b, lambda: means,
                           cycles_per_ms)


def staytime_rows_cases(bundle, state, cycles_per_ms):
    """K2 as the staytime predict step launches it at B = 16384: one
    grouped call over the 46 single-id mean segments (one a storage, D 32,
    966 MB of tables: out of L2 on every call), and one sequence member of
    16384 x 50 entries (the path before ``din_pool_gather``; its table's
    four copies alternate)."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.embedding import packed

    eng = bundle.embedding
    b = STAYTIME_BATCH
    batch = synthetic_batch(bundle, b, seed=31, ids_per_feature=1)[0]
    plans = packed.plan_segments(eng, batch)
    singles, seqs = [], []
    for skey in sorted(plans):
        ids, mask = packed.storage_stream(eng, skey, plans[skey], batch)
        for seg in plans[skey]:
            part = slice(seg.start, seg.start + seg.size)
            item = (state.tables[skey]["w"], ids[part], mask[part])
            (singles if seg.kind == "mean" else seqs).append(item)
    if len(singles) != 46 or len(seqs) != 3:
        raise AssertionError(f"staytime: {len(singles)} single-id and {len(seqs)} "
                             f"sequence segments, expected 46 and 3")
    cases = [rows_group_case(f"staytime 46 single-id segments, b={b}", singles,
                             lambda: singles, cycles_per_ms)]
    table, ids, mask = seqs[0]
    copies = [table] + [table.clone() for _ in range(3)]
    turn = [0]

    def pick():
        turn[0] = (turn[0] + 1) % len(copies)
        return [(copies[turn[0]], ids, mask)]

    cases.append(rows_group_case(f"staytime sequence, {b} x {ids.numel() // b}",
                                 [seqs[0]], pick, cycles_per_ms))
    for c in cases:
        c["b"] = b
    return cases


def staytime_rows(rng, n, slots, seq_slots):
    """Request rows of raw feasigns for every staytime slot: 1..5 ids per
    feature, one feature in five left out, and every third row without its
    sequence features (the DIN pools then see all-0 masks)."""
    rows = []
    for i in range(n):
        row = {}
        for s in slots:
            if rng.uniform() < 0.8 and not (i % 3 == 0 and s in seq_slots):
                row[s] = [int(x) for x in rng.integers(0, 1 << 40, rng.integers(1, 6))]
        rows.append(row)
    return rows


def check_staytime_scores(scores, n):
    from recommendsystem_tpu_torch.models.staytime import T_LONG, T_SHORT, T_STAY

    ev = np.asarray(scores[T_STAY])
    if ev.shape != (n,) or not np.all(np.isfinite(ev)) or ev.min() < 0 or ev.max() > EV_MAX:
        raise AssertionError(f"bad expected values: shape {ev.shape}, range "
                             f"[{np.nanmin(ev)}, {np.nanmax(ev)}]")
    for task in (T_SHORT, T_LONG):
        p = np.asarray(scores[task])
        if p.shape != (n,) or not np.all(np.isfinite(p)) or p.min() <= 0 or p.max() >= 1:
            raise AssertionError(f"bad {task}: shape {p.shape}, range "
                                 f"[{np.nanmin(p)}, {np.nanmax(p)}]")


def assert_heads_close(got, want, what):
    """Every head of ``got`` equal to ``want``'s: ``SCORE_TOL``, or
    ``EV_TOL`` for staytime's expected value."""
    from recommendsystem_tpu_torch.models.staytime import T_STAY

    if set(got) != set(want):
        raise AssertionError(f"{what}: heads {sorted(got)} against {sorted(want)}")
    for task in got:
        np.testing.assert_allclose(np.asarray(got[task]), np.asarray(want[task]),
                                   err_msg=f"{what}: {task}",
                                   **(EV_TOL if task == T_STAY else SCORE_TOL))


def _cpu_state(state):
    """The weights of ``state`` on the CPU, for the plain path's services."""
    from recommendsystem_tpu_torch.train.state import TrainState

    return TrainState(params={k: v.cpu() for k, v in state.params.items()}, opt_state=None,
                      tables={k: {"w": t["w"].cpu()} for k, t in state.tables.items()})


def staytime_path(card, cycles_per_ms):
    """K7 against its plain version, then full-width staytime serving with
    its own window of launch counts, then its predict step at B = 16384."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
    from recommendsystem_tpu_torch.serving import ScoringService
    from recommendsystem_tpu_torch.train import make_predict_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    out = {"card": card}
    bundle = create_model("staytime", device="cuda")
    state = create_train_state(bundle, seed=5)
    out["cases"] = [din_case(b, 70 + b, cycles_per_ms) for b in DIN_BATCHES]
    out["cases"] += [din_gather_case(bundle, state, b, 80 + b, cycles_per_ms)
                     for b in DIN_BATCHES]
    out["cases"] += staytime_rows_cases(bundle, state, cycles_per_ms)
    out["cases"].append(staytime_fold_case(bundle, state, cycles_per_ms))
    for c in out["cases"]:
        log(json.dumps(c))
    eng = bundle.embedding
    out["storages"] = len(eng.storage)
    out["table_bytes"] = sum(r * d * 4 for r, d in eng.storage.values())
    cfg = StaytimeConfig()
    rng = np.random.default_rng(8)
    rows200 = staytime_rows(rng, 200, cfg.slots, cfg.seq_slots)

    torch.cuda.synchronize()
    reset_launch_counts()
    svc = ScoringService(bundle, state, max_batch=256, ids_per_feature=5)
    svc.warmup()
    s200 = svc.score(rows200)
    s3 = svc.score(rows200[:3])
    over_http = http_score(svc, rows200[:50])
    torch.cuda.synchronize()
    serving = launch_counts()
    out["serve_launches"] = serving
    log("staytime serving launches:", json.dumps(serving))
    # 5 ids: the mean segments fold in K1, the sequences go to K7, which
    # gathers them (no K2; the 1-id predict call below requires K2)
    for name in ("fold_mean", "din_pool"):
        if serving[name] < 1:
            raise AssertionError(f"{name} was not launched on the staytime serving path")

    check_staytime_scores(s200, 200)
    assert_heads_close(s3, {k: v[:3] for k, v in s200.items()}, "bucket 8 vs 256")
    assert_heads_close(over_http["scores"], {k: v[:50] for k, v in s200.items()},
                          "over HTTP")
    cpu_bundle = create_model("staytime", device="cpu")
    cpu_state = _cpu_state(state)
    cpu_svc = ScoringService(cpu_bundle, cpu_state, max_batch=256, ids_per_feature=5,
                             device="cpu")
    assert_heads_close(s200, cpu_svc.score(rows200), "card vs CPU")

    # predict step: launches per call, agreement with the CPU, examples/s
    step = make_predict_step(bundle)
    per_call = {}
    for ipf in (1, 5):
        batch = synthetic_batch(bundle, STAYTIME_BATCH, seed=9, ids_per_feature=ipf)[0]
        step(state, batch)
        torch.cuda.synchronize()
        reset_launch_counts()
        pred = step(state, batch)
        torch.cuda.synchronize()
        per_call[f"ids{ipf}"] = launch_counts()
    out["launches_per_call"] = per_call
    want = {"ids5": {"fold_mean": 1, "fold_rows": 0, "din_pool": 3},
            "ids1": {"fold_mean": 0, "fold_rows": 1, "din_pool": 3}}
    for key, counts in want.items():
        for name, n in counts.items():
            if per_call[key][name] != n:
                raise AssertionError(f"staytime predict {key}: {name} launched "
                                     f"{per_call[key][name]} times, expected {n}")
    n = STAYTIME_BATCH
    got = {k: v.squeeze(1).cpu().numpy() for k, v in pred.items()}
    check_staytime_scores(got, n)
    cpu_batch = {k: v.to("cpu") for k, v in batch.items()}
    cpu_pred = make_predict_step(cpu_bundle)(cpu_state, cpu_batch)
    assert_heads_close(got, {k: v.squeeze(1).numpy() for k, v in cpu_pred.items()},
                          f"predict b={n}, card vs CPU")
    iters = 20
    for _ in range(3):
        step(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    out["predict"] = {"metric": "torch_staytime_predict_examples_per_sec",
                      "unit": "examples/s", "value": n / dt, "batch": n,
                      "ids_per_feature": 5, "ms_per_call": dt * 1e3,
                      "launches_per_call": per_call, "card": card}
    return out


def raw_rows(rng, n, max_ids, slots=tuple(str(1000 + s) for s in range(24))):
    """Request rows of raw int64 feasigns: 1..max_ids ids per feature, with
    one feature in five left out."""
    rows = []
    for _ in range(n):
        row = {}
        for s in slots:
            if rng.uniform() < 0.8:
                k = int(rng.integers(1, max_ids + 1))
                row[s] = [int(x) for x in rng.integers(0, 1 << 40, k)]
        rows.append(row)
    return rows


def check_scores(scores, n):
    s = np.asarray(scores)
    if s.shape != (n,) or not np.all(np.isfinite(s)) or s.min() < 1e-6 or s.max() > 1.0:
        raise AssertionError(f"bad scores: shape {s.shape}, range "
                             f"[{np.nanmin(s)}, {np.nanmax(s)}]")


def http_score(svc, rows, dense=None):
    """``rows`` (and ``dense``, where given) POSTed to a server of ``svc``
    on a free local port, after its health check; the reply."""
    from recommendsystem_tpu_torch.serving import serve

    httpd = serve(svc, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            if json.loads(r.read())["status"] != "ok":
                raise AssertionError("healthz not ok")
        body = {"rows": rows} if dense is None else {"rows": rows, "dense": dense}
        req = urllib.request.Request(f"{base}/score",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


def _to(tree, device):
    """A copy of a state tree (dicts of tensors and ints) on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=True)
    return tree


def _ratio(got, want, atol, rtol):
    """|got - want| / (atol + rtol |want|) per element, float64: within the
    tolerance, as ``np.testing.assert_allclose`` takes it, is at most 1.  The
    shapes must be equal; a NaN or an infinity on either side is past the
    tolerance (ratio inf), as are unequal entries where both tolerances
    are 0."""
    got, want = (torch.as_tensor(x, dtype=torch.float64) for x in (got, want))
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} against {tuple(want.shape)}")
    diff = (got - want).abs()
    r = torch.where(diff == 0, 0.0, diff / (atol + rtol * want.abs()))
    bad = ~(torch.isfinite(got) & torch.isfinite(want) & torch.isfinite(r))
    return torch.where(bad, torch.inf, r)


def _margin(got, want, atol, rtol):
    """(largest ``_ratio``, how many elements are past 1, largest
    |got - want|)."""
    r = _ratio(got, want, atol, rtol)
    diff = (torch.as_tensor(got, dtype=torch.float64)
            - torch.as_tensor(want, dtype=torch.float64)).abs()
    return float(r.max()), int((~(r <= 1)).sum()), float(diff.max())


def two_train_steps(bundle, cpu_bundle, b, ipf, seed, record=None, on_init=None,
                    steps=2, init=None, first=0, sparse_update=None, on_step=None,
                    card_step=None):
    """Two train steps on the card and the same two on the CPU through the
    plain versions, from one seeded state and one batch of ``b`` drawn from
    ``seed`` (same step seeds, same dropout); the card's two first.
    ``record(side)``, where given, is a context that each side's steps run
    in ("card", then "cpu"); ``on_init``, where given, sees the CPU's
    initial state before any step; ``on_step(side)`` is called before each
    step.  ``steps`` steps in place of two, from ``init`` (a state, copied
    to each side) in place of the seeded state, the first with step seed 40
    + ``first``, by the train step's ``sparse_update``.  ``card_step(bundle,
    sparse_update)``, where given, makes the card's step in place of
    ``make_train_step`` (the sharded step of phase 16).  Returns (card
    state, CPU state, card infos, CPU infos)."""
    from contextlib import nullcontext

    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.train import make_train_step
    from recommendsystem_tpu_torch.train.state import TrainState, create_train_state

    fields = ("params", "opt_state", "tables", "step")
    if init is None:
        init = create_train_state(bundle, seed=3)
    gstate = TrainState(**{f: _to(getattr(init, f), bundle.device) for f in fields})
    cstate = TrainState(**{f: _to(getattr(init, f), "cpu") for f in fields})
    if on_init is not None:
        on_init(cstate)
    out = []
    for side, bnd, state in (("card", bundle, gstate), ("cpu", cpu_bundle, cstate)):
        batch, dense, labels, weight = synthetic_batch(bnd, b, seed=seed, ids_per_feature=ipf)
        step = (card_step(bnd, sparse_update) if side == "card" and card_step
                else make_train_step(bnd, sparse_update=sparse_update))
        infos = []
        with record(side) if record else nullcontext():
            for i in range(steps):
                if on_step is not None:
                    on_step(side)
                state, info = step(state, batch, labels, weight, dense, seed=40 + first + i)
                infos.append(info)
        out.append((state, infos))
    (gstate, ginfos), (cstate, cinfos) = out
    return gstate, cstate, ginfos, cinfos


def _bf16_off(got, want, atol, rtol):
    """Where a bf16 quantity ``got`` breaks the bf16 rule against the float32
    values ``want`` that it should store: an entry must equal ``want``
    rounded to nearest even, or lie one bf16 ulp from it with ``want``
    within ``atol + rtol |want|`` (a float32 tolerance) of the midpoint
    between the two, where either rounding is right.  A bool mask."""
    want = torch.as_tensor(want, dtype=torch.float32)
    rounded = want.to(torch.bfloat16)
    differ = got != rounded
    g, r, p = got.double(), rounded.double(), want.double()
    bits = lambda x: x.float().view(torch.int32).to(torch.int64) >> 16   # noqa: E731
    adjacent = (torch.sign(g) == torch.sign(r)) & ((bits(g) - bits(r)).abs() == 1)
    near = (p - (g + r) / 2).abs() <= atol + rtol * p.abs()
    return differ & ~(adjacent & near)


def _table_tols(name):
    """(atol, rtol) of a table quantity: w TRAIN_W_ATOL, the optimizer's
    moments and g2sum TRAIN_MOMENT_TOL; t and show exact."""
    if name == "w":
        return TRAIN_W_ATOL, 0.0
    if name in ("t", "show"):
        return 0.0, 0.0
    return TRAIN_MOMENT_TOL["atol"], TRAIN_MOMENT_TOL["rtol"]


def _table_quantities(tstate):
    """{name: (rows, ...) tensor} of one storage: w, show and each field of
    the sparse optimizer's own state (Adam's m, v, t; AdaGrad's g2sum)."""
    return {"w": tstate["w"], "show": tstate["show"], **tstate["opt"]}


def _past(gstate, cstate, ginfos, cinfos):
    """Where two card steps differ from the CPU's past the ``TRAIN_*``
    tolerances (``_ratio`` above 1): {"loss": [(name, step)], "params":
    {name: (entries past, bool mask)}, "tables": {(quantity, storage):
    (rows past, bool row mask)}}, and the margins of every quantity
    (``_margin``: largest ratio, elements past, largest difference)."""
    if set(gstate.params) != set(cstate.params) or set(gstate.tables) != set(cstate.tables):
        raise AssertionError("the card's state and the CPU's hold other parameters or tables")
    parts, past = {}, {"loss": [], "params": {}, "tables": {}}
    for i, (ginfo, cinfo) in enumerate(zip(ginfos, cinfos)):
        for name in ("loss", "regularization"):
            m = _margin(float(ginfo[name]), float(cinfo[name]), 0.0, TRAIN_LOSS_RTOL)
            parts.setdefault(name, []).append(m)
            if m[1]:
                past["loss"].append((name, i + 1))
    for k, v in cstate.params.items():
        got = gstate.params[k].cpu()
        parts.setdefault("params", []).append(_margin(got, v, TRAIN_W_ATOL, 0.0))
        over = ~(_ratio(got, v, TRAIN_W_ATOL, 0.0) <= 1)
        if over.any():
            past["params"][k] = (int(over.sum()), over)
    for skey, ct in cstate.tables.items():
        gq = _table_quantities(_to(gstate.tables[skey], "cpu"))
        cq = _table_quantities(ct)
        if set(gq) != set(cq):
            raise AssertionError(f"{skey}: the card's optimizer state holds {sorted(gq)}, "
                                 f"the CPU's {sorted(cq)}")
        for name, want in cq.items():
            parts.setdefault(name, []).append(_margin(gq[name], want, *_table_tols(name)))
            over = ~(_ratio(gq[name], want, *_table_tols(name)) <= 1)
            rows = over.reshape(over.shape[0], -1).any(dim=1)
            if rows.any():
                past["tables"][(name, skey)] = (int(rows.sum()), rows)
    margins = {n: {"margin": max(p[0] for p in ps), "past": sum(p[1] for p in ps),
                   "max_diff": max(p[2] for p in ps)} for n, ps in parts.items()}
    return past, margins


class _Recorder(TorchFunctionMode):
    """Records a host copy of the input of every ``torch.relu`` call, by
    side (``side``: "card" or "cpu", set by ``at``)."""

    def __init__(self):
        super().__init__()
        self.relu = {"card": [], "cpu": []}
        self.side = None

    def at(self, side):
        self.side = side
        return self

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.relu, torch.nn.functional.relu, torch.Tensor.relu):
            self.relu[self.side].append(args[0].detach().to("cpu", copy=True))
        return func(*args, **(kwargs or {}))


def _sample_of(shape, index, b):
    """The sample an element of a ReLU input belongs to: the batch is the
    leading dim of the towers' (B, ...), the second of stacked experts' (E,
    B, ...), and the last, batch-minor, of the InteractingLayer's (U, F B)
    and (U, F, B)."""
    for axis in (0, 1):
        if len(shape) > axis + 1 and shape[axis] == b:
            return int(index[axis])
    return int(index[-1]) % b


def _recorded_steps(bundle, cpu_bundle, b, ipf, seed, **steps_kw):
    """``two_train_steps`` (``steps_kw`` passed on) with each side's ReLU
    inputs, dense gradients (as the dense optimizer takes them) and table
    gradients recorded, a list a step: G by storage, as the lazy pass
    takes it; as the touched-rows update's payloads sum it; or, on the
    classic paths, as ``sparse_opt.update`` takes it (the gradient of a
    whole float32 table)."""
    from recommendsystem_tpu_torch.embedding import packed

    rec = _Recorder()
    grads = {"card": [], "cpu": []}
    tables = {"card": [], "cpu": []}
    for side, bnd in (("card", bundle), ("cpu", cpu_bundle)):
        update = bnd.dense_optimizer.update_

        def record(params, g, state, side=side, update=update):
            grads[side].append({k: v.detach().cpu() for k, v in g.items()})
            return update(params, g, state)

        object.__setattr__(bnd.dense_optimizer, "update_", record)   # a frozen dataclass
    real_group, real_rows = packed.sparse_update_group, packed.row_update_packed_storage
    inside = [False]          # the plain lazy pass calls sparse_opt.update: not again

    def put(w, g):
        tables[rec.side][-1][id(w)] = g.detach().float().to("cpu", copy=True)

    def record_tables(opt, tstates, accs):
        tstates, accs = list(tstates), list(accs)
        for ts, acc in zip(tstates, accs):
            put(ts["w"], packed.accumulator_views(acc, ts["w"].shape[1])[0])
        inside[0] = True
        try:
            return real_group(opt, tstates, accs)
        finally:
            inside[0] = False

    def record_rows(opt, tstate, ids, pay):
        d = tstate["w"].shape[1]
        put(tstate["w"], torch.zeros((tstate["w"].shape[0], d), device=pay.device).index_add_(
            0, ids.long(), pay[:, :d].float()))
        return real_rows(opt, tstate, ids, pay)

    def recording(opt):
        real = opt.update

        def update(w, grad, state, row_mask):
            if not inside[0]:
                put(w, grad)
            return real(w, grad, state, row_mask)
        return update

    opts = {id(bnd.embedding.sparse_opt): bnd.embedding.sparse_opt
            for bnd in (bundle, cpu_bundle)}
    for opt in opts.values():
        object.__setattr__(opt, "update", recording(opt))
    packed.sparse_update_group = record_tables
    packed.row_update_packed_storage = record_rows
    init = []
    try:
        out = two_train_steps(bundle, cpu_bundle, b, ipf, seed, record=rec.at,
                              on_init=lambda st: init.append(_to(vars(st), "cpu")),
                              on_step=lambda side: tables[side].append({}), **steps_kw)
    finally:
        packed.sparse_update_group, packed.row_update_packed_storage = real_group, real_rows
        for opt in opts.values():
            object.__delattr__(opt, "update")
        for bnd in (bundle, cpu_bundle):
            if "update_" in vars(bnd.dense_optimizer):
                object.__delattr__(bnd.dense_optimizer, "update_")
    for side, st in (("card", out[0]), ("cpu", out[1])):
        names = {id(t["w"]): skey for skey, t in st.tables.items()}
        tables[side] = [{names[k]: v for k, v in step.items()} for step in tables[side]]
    return out, rec.relu, grads, tables, init[0]


def _replay(cpu_bundle, init, grads, tables, batch):
    """The CPU's plain updates (dense Adam, the engine's lazy pass) applied
    to the card's recorded gradients, step by step, from the initial state:
    what the card's state must be if its updates are right.  The tables
    replay in float32 (bf16 ones widened, Adam's moments kept float32): a
    bf16 table's replay is the float32 value it must round.  Returns
    (params, dense optimizer state, tables)."""
    from recommendsystem_tpu_torch.embedding import SparseAdam, packed

    params, opt_state = _to(init["params"], "cpu"), _to(init["opt_state"], "cpu")
    tstates = {k: {"w": t["w"].float(), "opt": {n: x.float() for n, x in t["opt"].items()},
                   "show": t["show"].clone()} for k, t in _to(init["tables"], "cpu").items()}
    eng = cpu_bundle.embedding
    opt = eng.sparse_opt
    if isinstance(opt, SparseAdam):
        opt = dataclasses.replace(opt, state_dtype=torch.float32)
    counts = eng.row_counts(batch)
    for g in grads:
        params, opt_state = cpu_bundle.dense_optimizer.update_(params, _to(g, "cpu"), opt_state)
    for step in tables:
        keys = sorted(step)
        accs = [torch.cat([step[k].reshape(-1), counts[k].reshape(-1)]) for k in keys]
        packed.sparse_update_group(opt, [tstates[k] for k in keys], accs)
    return params, opt_state, tstates


class _KinkedRelu(TorchFunctionMode):
    """Each ReLU call of one CPU train step takes the card's side of every
    element whose sign differs from the card's recorded input at that call
    (``card``: the step's list of the card's ReLU inputs): the card's value
    and the card's gate (its input > 0), so that the step computes with the
    card's kinks and with its own values elsewhere."""

    def __init__(self, card):
        super().__init__()
        self.card, self.calls = card, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.relu, torch.nn.functional.relu, torch.Tensor.relu):
            x, g = args[0], self.card[self.calls].to(args[0].dtype)
            self.calls += 1
            flip = (x > 0) != (g > 0)
            if bool(flip.any()):
                out = torch.where(flip, (g > 0).to(x.dtype) * (x + (g - x).detach()), out)
        return out


def _state_before(cpu_bundle, init, grads, tables, batch):
    """The card's state entering the step after ``grads`` and ``tables``
    (the card's recorded gradients of the steps before it) on the CPU: the
    initial state with those steps' updates replayed (``_replay``), each
    tensor in its initial type."""
    from recommendsystem_tpu_torch.train.state import TrainState

    start = _to(init, "cpu")
    if not grads:
        return TrainState(**start)
    params, opt_state, tstates = _replay(cpu_bundle, start, grads, tables, batch)
    out = {}
    for k, t in start["tables"].items():
        r = tstates[k]
        out[k] = {"w": r["w"].to(t["w"].dtype), "show": r["show"].to(t["show"].dtype),
                  "opt": {n: r["opt"][n].to(x.dtype) for n, x in t["opt"].items()}}
    return TrainState(params=params, opt_state=opt_state, tables=out,
                      step=start["step"] + len(grads))


def _kinked_grads(cpu_bundle, state, card_relu, b, ipf, seed, step_seed, sparse_update):
    """The dense gradients (as the dense Adam takes them) of one CPU train
    step from ``state`` on the batch of ``seed``, with the card's kinks of
    that step (``_KinkedRelu`` over ``card_relu``)."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.train import make_train_step

    batch, dense, labels, weight = synthetic_batch(cpu_bundle, b, seed=seed,
                                                   ids_per_feature=ipf)
    got, update = [], cpu_bundle.dense_optimizer.update_

    def record(params, g, st):
        got.append({k: v.detach().cpu() for k, v in g.items()})
        return update(params, g, st)

    object.__setattr__(cpu_bundle.dense_optimizer, "update_", record)   # a frozen dataclass
    try:
        kinked = _KinkedRelu(card_relu)
        with kinked:
            make_train_step(cpu_bundle, sparse_update=sparse_update)(
                state, batch, labels, weight, dense, seed=step_seed)
    finally:
        object.__delattr__(cpu_bundle.dense_optimizer, "update_")
    if kinked.calls != len(card_relu):
        raise AssertionError(f"the kinked CPU step called ReLU {kinked.calls} times, the "
                             f"card's step {len(card_relu)}")
    return got[0]


def _beyond_rounding(card, cpu):
    """Where a gradient (one tensor, one step) differs between the card and
    the CPU by more than GRAD_ROUND of the tensor's largest |gradient| on
    the CPU: by more than two float32 sums of the same terms in other
    orders differ."""
    scale = float(cpu.abs().max()) if cpu.numel() else 0.0
    return (card - cpu).abs() > GRAD_ROUND * scale


def witness(bundle, cpu_bundle, b, ipf, seed, steps=2, init=None, first=0,
            sparse_update=None, keep_state=False, card_step=None):
    """One draw of two card and two CPU train steps, with every entry past
    its ``TRAIN_*`` tolerance put down to a cause or listed as unexplained.

    A ReLU input whose sign differs between the card and the CPU (a flip)
    is a kink where both values lie within KINK_RTOL of its call's largest
    |input| or within the largest difference between the sides among the
    call's elements that did not flip; a kink sends one sample's gradient
    through one unit on one side only.  Where step 1 had a kink, every flip
    of step 2 counts as one: the sides start step 2 apart by more than
    rounding.  Every other flip is unexplained.  The gradients are
    compared step by step (``_beyond_rounding``): dense ones as the dense
    Adam takes them, a table row's as the lazy pass takes them (G).  The
    card's updates are replayed on the CPU (``_replay``: the plain dense
    Adam and lazy pass applied to the card's own gradients from the initial
    state); where the card's state differs from the replay past a
    ``TRAIN_*`` tolerance, its update is at fault, and that is never
    explained.  Then, the updates being right:
      - an entry (a dense parameter's, or a table row) whose gradients agree
        within rounding in both steps is explained: the update turns a
        rounding of a small gradient into a visible step (Adam's m /
        sqrt(v) makes any gradient a step of about the learning rate);
      - a table row whose gradients differ beyond rounding is explained
        where a sample that looks it up has a kink;
      - a dense entry whose gradients differ beyond rounding is explained
        where the kinks on its own path account for it: at every step
        where they differ, the CPU's step from the card's state entering
        it (``_state_before``: the card's updates of the steps before,
        replayed) with the card's side of that step's flips
        (``_KinkedRelu``) gives the card's gradient within rounding
        (``_kinked_grads``); a kink elsewhere in the step explains
        nothing;
      - a loss or penalty past rtol TRAIN_LOSS_RTOL, a t or show that
        differs, a flip that is not a kink, and any other entry past its
        tolerance are unexplained.
    A bf16 table quantity is held to the replay by the bf16 rule
    (``_bf16_off``) at its ``TRAIN_*`` tolerance; in a one-step draw a bf16
    entry past its tolerance is explained as a rounding where the card's
    and the CPU's stored values both keep the rule against the replay (the
    card's float32 value before rounding): each is the replay rounded, or
    one bf16 ulp from it with the replay within the quantity's tolerance of
    the midpoint, where two float32 values within that tolerance of each
    other may round apart.  ``steps``, ``init``,
    ``first``, ``sparse_update`` and ``card_step`` go to
    ``two_train_steps``; with
    ``keep_state`` the CPU's state after the steps is returned too, as
    ``cpu_state``.  Returns the draw's margins, its explanations by cause,
    the unexplained entries (none where the draw passes), and the gradients
    of the first unexplained ones."""
    from recommendsystem_tpu_torch.data import synthetic_batch

    (gstate, cstate, ginfos, cinfos), relu, grads, tables, init = _recorded_steps(
        bundle, cpu_bundle, b, ipf, seed, steps=steps, init=init, first=first,
        sparse_update=sparse_update, card_step=card_step)
    past, margins = _past(gstate, cstate, ginfos, cinfos)
    out = {"margins": margins, "explained": {}, "unexplained": [], "details": []}
    if keep_state:
        out["cpu_state"] = cstate
    if not (past["loss"] or past["params"] or past["tables"]):
        return out
    unexplained, explained, details = out["unexplained"], out["explained"], out["details"]
    unexplained += [f"{name} at step {step}" for name, step in past["loss"]]

    # the card's updates against the CPU's plain updates of the card's own
    # gradients: a fault in an update is never explained
    batch = synthetic_batch(cpu_bundle, b, seed=seed, ids_per_feature=ipf)[0]
    rparams, _, rtables = _replay(cpu_bundle, init, grads["card"], tables["card"], batch)
    for k, v in rparams.items():
        n = int((~(_ratio(gstate.params[k].cpu(), v, TRAIN_W_ATOL, 0.0) <= 1)).sum())
        if n:
            unexplained.append(f"param {k}: the card's update of its own gradients differs "
                               f"from the plain one in {n} entries")
    for skey, rt in rtables.items():
        gq, rq = _table_quantities(_to(gstate.tables[skey], "cpu")), _table_quantities(rt)
        for name, want in rq.items():
            if gq[name].dtype == torch.bfloat16:
                n = int(_bf16_off(gq[name], want, *_table_tols(name)).sum())
            else:
                n = int((~(_ratio(gq[name], want, *_table_tols(name)) <= 1)).sum())
            if n:
                unexplained.append(f"{skey} {name}: the card's update of its own gradients "
                                   f"differs from the plain one in {n} entries")

    gs, cs = relu["card"], relu["cpu"]
    if len(gs) != len(cs) or len(gs) % steps or any(g.shape != c.shape for g, c in zip(gs, cs)):
        raise AssertionError("the card and the CPU called ReLU on other shapes")
    per_step = len(gs) // steps
    kinks = {s: set() for s in range(1, steps + 1)}
    flips = {s: [] for s in range(1, steps + 1)}
    for i, (g, c) in enumerate(zip(gs, cs)):
        flipped = (g > 0) != (c > 0)
        if not flipped.any():
            continue
        step = i // per_step + 1
        scale = float(c.abs().max())
        near = max(KINK_RTOL * scale, float(torch.where(flipped, 0.0, (g - c).abs()).max()))
        for idx in flipped.nonzero().tolist():
            gv, cv = float(g[tuple(idx)]), float(c[tuple(idx)])
            f = {"step": step, "call": i % per_step, "shape": list(g.shape),
                 "sample": _sample_of(g.shape, idx, b), "card": gv, "cpu": cv,
                 "scale": scale, "near": near}
            flips[step].append(f)
            # step 2 starts from what step 1's kinks set apart: its flips
            # follow from them
            if max(abs(gv), abs(cv)) <= near or any(kinks[s] for s in range(1, step)):
                kinks[step].add(f["sample"])
            else:
                unexplained.append(f"step {step}: a ReLU input flipped far from 0: {f}")
    out["kinks"] = {f"step{k}": sorted(v) for k, v in kinks.items()}
    out["flips"] = {f"step{k}": v[:6] for k, v in flips.items()}

    def note(cause):
        explained[cause] = explained.get(cause, 0) + 1

    # table rows, and the samples that look each up
    eng = cpu_bundle.embedding
    readers = {}
    for key, col in eng.columns.items():
        if key not in batch:
            continue
        skey, offset, _ = eng.table_map[col.categorical_column.key]
        rows, mask = batch[key].rows.long() + offset, batch[key].mask > 0
        for smp, r in mask.nonzero().tolist():
            readers.setdefault((skey, int(rows[smp, r])), set()).add(smp)
    kinked = set().union(*kinks.values())
    beyond = {skey: [_beyond_rounding(gt[skey], ct[skey]).any(dim=1) if skey in ct else None
                     for gt, ct in zip(tables["card"], tables["cpu"])]
              for skey in cstate.tables}
    for (name, skey), (_, rows) in past["tables"].items():
        rounding = None
        gq = _table_quantities(gstate.tables[skey])[name].cpu()
        if gq.dtype == torch.bfloat16 and steps == 1:
            # rows whose every difference is one rounding apart: the card's
            # float32 value (the replay's) lies within the quantity's
            # tolerance of the midpoint between the card's and the CPU's
            # bf16 values, which the CPU's float32 value lies as close to
            cq = _table_quantities(cstate.tables[skey])[name]
            rq = _table_quantities(rtables[skey])[name]
            off = _bf16_off(gq, rq, *_table_tols(name)) | (
                _bf16_off(cq, rq, *_table_tols(name)) & (gq != cq))
            rounding = ~off.reshape(off.shape[0], -1).any(dim=1)
        for r in rows.nonzero().flatten().tolist():
            if name in ("t", "show"):
                unexplained.append(f"{skey} {name} row {r} differs")
            elif rounding is not None and bool(rounding[r]):
                note(f"table {name}, bf16 rounding")
            elif not any(bool(m[r]) for m in beyond[skey] if m is not None):
                note(f"table {name}, gradients within rounding")
            elif readers.get((skey, r), set()) & kinked:
                note(f"table {name}, kink")
            else:
                unexplained.append(f"{skey} {name} row {r} (samples "
                                   f"{sorted(readers.get((skey, r), set()))})")
    # dense entries: where the gradients differ beyond rounding at a step,
    # the CPU's step from the card's state entering it (the card's updates
    # replayed) with the card's kinks of that step must give the card's
    # gradient within rounding: the kinks on the entry's own path (the
    # units that feed it, and those it feeds) account for it
    kinked = {}

    def kinked_beyond(t, k):
        """Where the card's gradients of step t (0-based) differ beyond
        rounding from the kinked CPU step's."""
        if t not in kinked:
            state = _state_before(cpu_bundle, init, grads["card"][:t], tables["card"][:t],
                                  batch)
            sim = _kinked_grads(cpu_bundle, state, gs[t * per_step:(t + 1) * per_step], b,
                                ipf, seed, 40 + first + t, sparse_update)
            kinked[t] = {n: _beyond_rounding(grads["card"][t][n], v) for n, v in sim.items()}
        return kinked[t][k]

    for k, (_, over) in past["params"].items():
        differ = [_beyond_rounding(gg[k], cg[k]) for gg, cg in zip(grads["card"], grads["cpu"])]
        for idx in over.nonzero().tolist():
            differs = [t for t, m in enumerate(differ) if bool(m[tuple(idx)])]
            if not differs:
                note("param, gradients within rounding")
            elif not any(bool(kinked_beyond(t, k)[tuple(idx)]) for t in differs):
                note("param, the card's kinks on its path")
            else:
                unexplained.append(f"param {k}{idx}")
                if len(details) < 8:
                    details.append({"param": k, "index": idx, "grads": [
                        {"card": float(gg[k][tuple(idx)]), "cpu": float(cg[k][tuple(idx)]),
                         "tensor_max": float(cg[k].abs().max()),
                         "beyond_kinked": bool(kinked_beyond(t, k)[tuple(idx)])}
                        for t, (gg, cg) in enumerate(zip(grads["card"], grads["cpu"]))]})
    return out


def hold_card_to_cpu(bundle, cpu_bundle, b, ipf, what, card_step=None):
    """``witness`` at each batch seed of CHECK_SEEDS: two card steps against
    the same two CPU steps, failing unless every quantity is within its
    ``TRAIN_*`` tolerance or every entry past it is explained (a kink, or
    gradients that agree within rounding, the card's updates being right).
    Logs each draw's margins and explanations; returns them by seed.
    ``card_step`` goes to ``witness``."""
    draws = {}
    for seed in CHECK_SEEDS:
        w = witness(bundle, cpu_bundle, b, ipf, seed, card_step=card_step)
        draws[seed] = w
        log(f"{what} train card vs cpu, B {b}, seed {seed}:", json.dumps(w))
        if w["unexplained"]:
            raise AssertionError(f"{what}, seed {seed}: two card steps differ from the CPU's "
                                 f"past the TRAIN_* tolerances where no kink explains it: "
                                 f"{w['unexplained'][:20]}")
    return draws


def train_path(bundle, cpu_bundle, card):
    """The packed train step at full width.  Counted window: a fresh state
    takes ``TRAIN_STEPS`` steps on one B = 65536 batch with 5 ids per
    feature (K1, K3, K5f/K5b at dropout 0.2, K8), then another fresh state
    with 1 id (K2, K4); after each, t and show must equal the live counts.
    Then two steps on the card against the same two on the CPU through the
    plain versions, and the step timed."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.train import make_train_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    eng = bundle.embedding
    step = make_train_step(bundle)
    out = {"batch": BIG_BATCH, "dropout": DROPOUT, "card": card}
    data = {ipf: synthetic_batch(bundle, BIG_BATCH, seed=20 + ipf, ids_per_feature=ipf)
            for ipf in (5, 1)}
    torch.cuda.synchronize()
    reset_launch_counts()
    per_run, losses = {}, {}
    for ipf in (5, 1):
        before = launch_counts()
        state = create_train_state(bundle, seed=2)
        batch, dense, labels, weight = data[ipf]
        run_losses = []
        for i in range(TRAIN_STEPS):
            state, info = step(state, batch, labels, weight, dense, seed=i)
            run_losses.append(info["loss"])
        torch.cuda.synchronize()
        after = launch_counts()
        per_run[ipf] = {k: after[k] - before[k] for k in after}
        losses[ipf] = [float(x) for x in run_losses]
        if not all(np.isfinite(losses[ipf])):
            raise AssertionError(f"train loss not finite: {losses[ipf]}")
        counts = eng.row_counts(batch)
        for skey, tstate in state.tables.items():
            if not (torch.equal(tstate["show"], TRAIN_STEPS * counts[skey])
                    and torch.equal(tstate["opt"]["t"],
                                    TRAIN_STEPS * (counts[skey] > 0).float())):
                raise AssertionError(f"{skey}: t or show differ from the live counts")
    out["launches"] = launch_counts()
    out["launches_per_step"] = {f"ids{ipf}": {k: v / TRAIN_STEPS for k, v in c.items()}
                                for ipf, c in per_run.items()}
    out["losses"] = {f"ids{ipf}": v for ipf, v in losses.items()}
    log("train launches:", json.dumps(out["launches"]))
    for name, ipf in (("fold_mean", 5), ("unfold_mean", 5), ("field_attention", 5),
                      ("field_attention_bwd", 5), ("sparse_adam_update", 5),
                      ("fold_rows", 1), ("unfold_rows", 1)):
        if per_run[ipf][name] < 1:
            raise AssertionError(f"{name} was not launched on the train path")
    # one grouped lazy-Adam pass and one attention backward a step; with 5
    # ids one grouped fold and one grouped unfold-scatter, with 1 one grouped
    # per-row fold and one grouped per-row unfold-scatter
    for ipf, names in ((5, ("sparse_adam_update", "field_attention_bwd", "fold_mean",
                            "unfold_mean")),
                       (1, ("sparse_adam_update", "field_attention_bwd", "fold_rows",
                            "unfold_rows"))):
        for name in names:
            if out["launches_per_step"][f"ids{ipf}"][name] != 1:
                raise AssertionError(f"{name}: {out['launches_per_step'][f'ids{ipf}'][name]} "
                                     f"launches a step with {ipf} ids, not 1")

    # two steps on the card against the same two on the CPU (plain versions)
    t0 = time.perf_counter()
    out["card_vs_cpu"] = hold_card_to_cpu(bundle, cpu_bundle, TRAIN_CHECK_BATCH, 5, "autoint")
    out["cpu_check_s"] = time.perf_counter() - t0

    # throughput: median of 3 windows, each ending in a host fetch of the loss
    batch, dense, labels, weight = data[5]
    ms, windows = train_ms(step, create_train_state(bundle, seed=4), batch, labels, weight,
                           dense)
    out.update({"metric": "torch_autoint_ctr_train_examples_per_sec", "unit": "examples/s",
                "value": BIG_BATCH / ms * 1e3, "ms_per_step": ms, "window_ms": windows})
    return out


def train_ms(step, state, batch, labels, weight, dense, per_window=8):
    """Ms a train step: 3 warm-up steps, then the median of 3 windows of
    ``per_window`` steps, each ending in a host fetch of the last loss and a
    synchronize.  Returns (ms, each window's ms)."""
    seed = 0
    for _ in range(3):
        state, info = step(state, batch, labels, weight, dense, seed=seed)
        seed += 1
    float(info["loss"])
    windows = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(per_window):
            state, info = step(state, batch, labels, weight, dense, seed=seed)
            seed += 1
        float(info["loss"])
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / per_window * 1e3)
    return sorted(windows)[1], windows


def _interacting_inputs(b, f, seed, requires_grad=False):
    from recommendsystem_tpu_torch.kernels.interacting import PARAM_NAMES

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, f, 8), generator=g, device="cuda")
    p = {n: torch.randn((8, 8) if n.startswith("w") else (8,), generator=g,
                        device="cuda") * (0.5 if n.startswith("w") else 0.2)
         for n in PARAM_NAMES}
    p["gamma"] = p["gamma"] + 1.0
    if requires_grad:
        for t in [x, *p.values()]:
            t.requires_grad_()
    return x, p


def without_k6(bundle):
    """``bundle`` with its InteractingLayer run through the layer's
    transposed path (projections, K5f, LayerNorm), the path K6 replaces:
    the yardstick of phase 7."""
    layer = bundle.module.interacting
    layer.forward = layer.forward_transposed
    return bundle


def interacting_case(f, b, seed, cycles_per_ms, h=2, dtype=torch.float32):
    """K6 against its plain version at (B, F), and the layer's transposed
    path (projections, K5f, LayerNorm) on the same weights as the
    yardstick: no single PyTorch call computes the function, so
    ``library_ms`` is None.  Bound: x read and the output written once, the
    parameters once; 4 projections of 2*D*U per field and 2*H*F*dh*2 per
    field for the scores and the weighted sum (the JAX kernel's
    ``CostEstimate``).  ``dtype`` bf16: x and the parameters in bf16 (the
    bf16 compute policy's first iteration), bytes at bf16, the float32
    kernel on the widened values timed beside it (``fp32_ms``) in place of
    the transposed path."""
    from recommendsystem_tpu_torch.kernels.interacting import (
        interacting_attention, interacting_attention_plain)
    from recommendsystem_tpu_torch.nn import InteractingLayer

    d = u = 8
    x32, p32 = _interacting_inputs(b, f, seed)
    x, p = x32.to(dtype), {n: t.to(dtype) for n, t in p32.items()}
    got = interacting_attention(x, p, h, 1e-3)
    want = interacting_attention_plain(x, p, h, 1e-3)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **INTER_TOL)
    es = x.element_size()
    nbytes = es * b * f * d + 4 * b * f * u + es * (4 * d * u + 6 * u)
    ops = 2 * b * f * d * u * 4 + 2 * b * h * f * f * (u // h) * 2
    bms, by = bound(nbytes, ops)
    iters = 240 if b <= 256 else 20
    ms, host_ms = timed(lambda: interacting_attention(x, p, h, 1e-3), iters, cycles_per_ms)
    out = {"name": "interacting_attention", "dtype": _dtype_name(x), "b": b, "f": f, "h": h,
           "max_abs_err": err, "ms": ms, "host_ms": host_ms,
           "plain_ms": timed(lambda: interacting_attention_plain(x, p, h, 1e-3),
                             16 if b <= 256 else 2, cycles_per_ms)[0],
           "library_ms": None, "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops}
    if dtype != torch.float32:
        out["fp32_ms"] = timed(lambda: interacting_attention(x32, p32, h, 1e-3), iters,
                               cycles_per_ms)[0]
        return out
    layer = InteractingLayer(d, unit_num=u, head_num=h, use_dropout=True, device="cuda")
    names = {"gamma": "ln_scale", "beta": "ln_bias"}
    with torch.no_grad():
        for k, v in p.items():
            getattr(layer, names.get(k, k)).copy_(v)

    def unfused():
        with torch.inference_mode():
            return layer.forward_transposed(x)

    # the plain version and the transposed path issue some 20-30 kernels a
    # call: at most ~500 launches are queued behind the spin kernel, inside
    # the card's queue of pending launches, so the card runs them back to
    # back and the events read device time, not the host's issue pace
    unfused_ms, unfused_host_ms = timed(unfused, 16 if b <= 256 else 20, cycles_per_ms)
    out.update(unfused_ms=unfused_ms, unfused_host_ms=unfused_host_ms,
               unfused_max_abs_err=float((unfused() - want).abs().max()))
    return out


def interacting_grad_check():
    """The autograd Function (K6 forward, the plain version's recomputed
    backward) against autograd through the plain version, B = 256, F = 24."""
    from recommendsystem_tpu_torch.kernels.interacting import (
        PARAM_NAMES, interacting_attention, interacting_attention_plain)

    x, p = _interacting_inputs(256, 24, 123, requires_grad=True)
    do = torch.randn((256, 24, 8), generator=torch.Generator(device="cuda").manual_seed(5),
                     device="cuda")
    wrt = [x] + [p[n] for n in PARAM_NAMES]
    out = interacting_attention(x, p)
    if not type(out.grad_fn).__name__.startswith("InteractingAttentionFunction"):
        raise AssertionError("interacting_attention did not take its Function")
    got = torch.autograd.grad(out, wrt, do)
    want = torch.autograd.grad(interacting_attention_plain(x, p, 2, 1e-3), wrt, do)
    err = 0.0
    for name, a, w in zip(["x", *PARAM_NAMES], got, want):
        torch.testing.assert_close(a, w, **INTER_GRAD_TOL, msg=lambda m: f"d{name}: {m}")
        err = max(err, float((a - w).abs().max()))
    return {"b": 256, "f": 24, "max_abs_err": err}


def check_heads(scores, n, lo, hi, what):
    """Every head finite, of n scores, within [lo, hi]."""
    for task, v in scores.items():
        a = np.asarray(v).reshape(-1)
        if a.shape != (n,) or not np.all(np.isfinite(a)) or a.min() < lo or a.max() > hi:
            raise AssertionError(f"{what} {task}: shape {a.shape}, range "
                                 f"[{np.nanmin(a)}, {np.nanmax(a)}]")


def fused_service_run(name, bundle, state, cpu_bundle, rows, lo, hi, dense=None):
    """``score()`` at buckets 256 and 8 and over HTTP, the heads checked
    in [lo, hi], and the CPU plain path's scores of the same rows;
    ``dense``: the rows' dense fields, where the model takes some."""
    from recommendsystem_tpu_torch.serving import ScoringService

    def part(n):
        return None if dense is None else dense[:n]

    svc = ScoringService(bundle, state, max_batch=256, ids_per_feature=5)
    svc.warmup()
    full = svc.score(rows, dense)
    three = svc.score(rows[:3], part(3))
    over_http = http_score(svc, rows[:50], part(50))["scores"]
    check_heads(full, len(rows), lo, hi, name)
    assert_heads_close(three, {k: v[:3] for k, v in full.items()}, f"{name} bucket 8 vs 256")
    assert_heads_close(over_http, {k: v[:50] for k, v in full.items()}, f"{name} over HTTP")
    cpu = ScoringService(cpu_bundle, _cpu_state(state), max_batch=256, ids_per_feature=5,
                         device="cpu").score(rows, dense)
    assert_heads_close(full, cpu, f"{name} card vs CPU")
    return full


def predict_pair(name, fused_bundle, unfused_bundle, cpu_bundle, state, batch,
                 check_batch, lo, hi, card, iters=10):
    """One model's predict step with K6 and through the transposed path
    (``unfused_bundle``), on one state and one batch: launches per call, the
    two steps' scores against each other, the
    fused step against the CPU plain path at ``check_batch``, and the host
    time per call (a window of ``iters`` calls ending in a synchronize),
    three windows of each in turns."""
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.train import make_predict_step

    steps = {"fused": make_predict_step(fused_bundle),
             "unfused": make_predict_step(unfused_bundle)}
    per_call, outs = {}, {}
    for kind, step in steps.items():
        step(state, batch)
        torch.cuda.synchronize()
        reset_launch_counts()
        outs[kind] = {k: v.squeeze(1).cpu().numpy() for k, v in step(state, batch).items()}
        torch.cuda.synchronize()
        per_call[kind] = {k: v for k, v in launch_counts().items() if v}
    b = next(iter(outs["fused"].values())).shape[0]
    if per_call["fused"].get("interacting_attention") != 1 or "field_attention" in per_call["fused"]:
        raise AssertionError(f"{name} fused predict: launches {per_call['fused']}")
    if per_call["unfused"].get("field_attention") != 1 or \
            "interacting_attention" in per_call["unfused"]:
        raise AssertionError(f"{name} unfused predict: launches {per_call['unfused']}")
    check_heads(outs["fused"], b, lo, hi, f"{name} predict")
    assert_heads_close(outs["fused"], outs["unfused"], f"{name} predict, K6 vs K5")
    small = steps["fused"](state, check_batch)
    cpu_out = make_predict_step(cpu_bundle)(_cpu_state(state),
                                            {k: v.to("cpu") for k, v in check_batch.items()})
    assert_heads_close({k: v.cpu().numpy() for k, v in small.items()},
                       {k: v.numpy() for k, v in cpu_out.items()},
                       f"{name} predict b={CHECK_BATCH}, card vs CPU")
    windows = {"fused": [], "unfused": []}
    for order in (("unfused", "fused"), ("fused", "unfused"), ("unfused", "fused")):
        for kind in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                steps[kind](state, batch)
            torch.cuda.synchronize()
            windows[kind].append((time.perf_counter() - t0) / iters * 1e3)
    return {"batch": b, "ms_per_call": {k: sorted(v)[1] for k, v in windows.items()},
            "window_ms": windows, "launches_per_call": per_call, "card": card}


def interacting_path(card, cycles_per_ms, autoint, cpu_autoint, rows200, autoint_scores):
    """Phase 7: K6 against its plain version; ctr and multi_head serving in
    one window of launch counts; autoint served through the transposed path;
    the predict steps with K6 and through the transposed path.  ``autoint``
    is (bundle, state) of phase 3, whose scores of ``rows200`` (through K6)
    are ``autoint_scores``; ``cpu_autoint`` its CPU bundle."""
    from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.autoint import TASK
    from recommendsystem_tpu_torch.serving import ScoringService
    from recommendsystem_tpu_torch.train.state import create_train_state

    out = {"card": card}
    out["cases"] = [interacting_case(f, b, 300 + f + b, cycles_per_ms)
                    for f, b in INTER_CASES]
    for c in out["cases"]:
        log(json.dumps(c))
    out["grad_check"] = interacting_grad_check()
    log("interacting gradients:", json.dumps(out["grad_check"]))

    def bundles(name, **kw):
        # the CPU bundle runs K6's plain version
        return {"fused": create_model(name, device="cuda", **kw),
                "unfused": without_k6(create_model(name, device="cuda", **kw)),
                "cpu": create_model(name, device="cpu", **kw)}

    ctr = bundles("ctr")
    mh = bundles("multi_head")
    ctr_state = create_train_state(ctr["fused"], seed=6)
    mh_state = create_train_state(mh["fused"], seed=7)
    rng = np.random.default_rng(10)
    ctr_rows = raw_rows(rng, 200, 5)
    mh_rows = raw_rows(rng, 200, 5, tuple(str(2000 + s) for s in range(40)))
    a_unfused = without_k6(create_model("autoint", bucket_size=FULL_BUCKET, device="cuda"))

    # the main path of this phase: one window of counts
    torch.cuda.synchronize()
    reset_launch_counts()
    fused_service_run("ctr", ctr["fused"], ctr_state, ctr["cpu"], ctr_rows, 1e-6, 1.0)
    fused_service_run("multi_head", mh["fused"], mh_state, mh["cpu"], mh_rows, 0.0, 1.0)
    torch.cuda.synchronize()
    serving = launch_counts()
    out["serve_launches"] = serving
    log("ctr and multi_head serving launches:", json.dumps(serving))
    if serving["interacting_attention"] < 1 or serving["fold_mean"] < 1:
        raise AssertionError("interacting_attention or fold_mean was not launched on "
                             "the ctr and multi_head serving paths")
    if serving["field_attention"] != 0:
        raise AssertionError("the ctr and multi_head serving paths launched field_attention")
    a_svc = ScoringService(a_unfused, autoint[1], max_batch=256, ids_per_feature=5)
    a_svc.warmup()
    np.testing.assert_allclose(a_svc.score(rows200)[TASK], autoint_scores,
                               err_msg="autoint K6 vs K5", **SCORE_TOL)

    # predict steps with K6 and without
    ctr212 = bundles("ctr", cfg=synthetic_ctr_config(num_slots=180, num_bias=32),
                     bucket_size=CTR212_BUCKET)
    ctr212_state = create_train_state(ctr212["fused"], seed=8)
    a = {"fused": autoint[0], "unfused": a_unfused, "cpu": cpu_autoint}
    runs = (("autoint", a, autoint[1], BIG_BATCH, 5, 1e-6, 1.0),
            ("ctr", ctr, ctr_state, CTR_BATCH, 5, 1e-6, 1.0),
            ("multi_head", mh, mh_state, CTR_BATCH, 5, 0.0, 1.0),
            ("ctr212", ctr212, ctr212_state, CTR212_BATCH, {}, 1e-6, 1.0))
    out["predict"] = {}
    for name, bset, state, b, ipf, lo, hi in runs:
        batch = synthetic_batch(bset["fused"], b, seed=40, ids_per_feature=ipf)[0]
        check = synthetic_batch(bset["fused"], CHECK_BATCH, seed=41, ids_per_feature=ipf)[0]
        out["predict"][name] = predict_pair(name, bset["fused"], bset["unfused"], bset["cpu"],
                                            state, batch, check, lo, hi, card)
        for kind, counts in out["predict"][name]["launches_per_call"].items():
            if ipf == 5 and counts.get("fold_mean") != 1:
                raise AssertionError(f"{name} {kind} predict: fold_mean launched "
                                     f"{counts.get('fold_mean')} times, not 1")
            # one id a column: one grouped K2 call (36 launches before it)
            if ipf != 5 and counts.get("fold_rows") != 1:
                raise AssertionError(f"{name} {kind} predict: fold_rows launched "
                                     f"{counts.get('fold_rows')} times, not 1")
        log(f"{name} predict:", json.dumps(out["predict"][name]))
    out["predict"]["ctr212"]["config"] = "synthetic_ctr_config(num_slots=180, num_bias=32)"
    return out


def tower_train_path(card, cycles_per_ms):
    """Phase 8: the packed train step of ctr (24 slots of 48-wide rows, B =
    32768, 5 ids), the 212-feature ctr (F = 180, 56-wide rows in 36
    storages, B = 8192, one id a column), multi_head (B = 32768) and finish
    (B = 32768), at full width, with dropout 0.2 where the model has it.
    Per model: a counted window of ``TRAIN_STEPS`` steps from a fresh state
    (counts set to 0 just before, read just after, held to the launches a
    step must take); losses and ``regularization`` finite, t and show equal
    to the live counts; the step's ms; the kernels at the shapes this model
    gives them (K3, K4, K8 at D 48, 56, 32; K5f and K5b at F 40 and 180);
    then two steps on the card held to the CPU at a smaller bucket and
    batch.  Returns the summed counts of the windows with the rest."""
    from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import make_train_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    mean = {"fold_mean": 1, "unfold_mean": 1, "sparse_adam_update": 1}
    attn = {"field_attention": 1, "field_attention_bwd": 1}
    ctr212 = {"cfg": synthetic_ctr_config(num_slots=180, num_bias=32)}
    # (label, model, factory kwargs, batch, ids a column, the card-vs-CPU
    # bucket, launches a step)
    runs = (("ctr", "ctr", {}, CTR_BATCH, 5, 16384, {**mean, **attn}),
            ("ctr212", "ctr", {**ctr212, "bucket_size": CTR212_BUCKET}, CTR212_BATCH, {},
             4096, {"fold_rows": 1, "unfold_rows": 1, "sparse_adam_update": 1, **attn}),
            ("multi_head", "multi_head", {}, CTR_BATCH, 5, 16384, {**mean, **attn}),
            ("finish", "finish", {}, FINISH_BATCH, 5, 8192, mean))
    out = {"card": card, "launches": None, "train": {}, "cases": []}
    for label, name, kw, b, ipf, check_bucket, want in runs:
        bundle = create_model(name, device="cuda", **kw)
        eng = bundle.embedding
        step = make_train_step(bundle)
        batch, dense, labels, weight = synthetic_batch(bundle, b, seed=50, ids_per_feature=ipf)
        state = create_train_state(bundle, seed=9)
        torch.cuda.synchronize()
        reset_launch_counts()
        infos = []
        for i in range(TRAIN_STEPS):
            state, info = step(state, batch, labels, weight, dense, seed=i)
            infos.append(info)
        torch.cuda.synchronize()
        counts = launch_counts()
        out["launches"] = {k: (out["launches"] or {}).get(k, 0) + v for k, v in counts.items()}
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items() if v}
        if per_step != want:
            raise AssertionError(f"{label} train: launches a step {per_step}, expected {want}")
        losses = [[float(i["loss"]), float(i["regularization"])] for i in infos]
        if not (np.all(np.isfinite(losses)) and all(r > 0 for _, r in losses)):
            raise AssertionError(f"{label} train: losses and regularization {losses}")
        live = eng.row_counts(batch)
        for skey, tstate in state.tables.items():
            if not (torch.equal(tstate["show"], TRAIN_STEPS * live[skey])
                    and torch.equal(tstate["opt"]["t"], TRAIN_STEPS * (live[skey] > 0).float())):
                raise AssertionError(f"{label} {skey}: t or show differ from the live counts")
        ms, windows = train_ms(step, state, batch, labels, weight, dense, per_window=5)
        res = {"metric": f"torch_{label}_train_examples_per_sec", "unit": "examples/s",
               "value": b / ms * 1e3, "ms_per_step": ms, "window_ms": windows, "batch": b,
               "storages": len(eng.storage), "d": sorted({d for _, d in eng.storage.values()}),
               "launches_per_step": per_step, "losses_and_regularization": losses}
        log(f"{label} train:", json.dumps(res))

        # the kernels at this model's shapes, K8 on the trained tables
        cases = []
        if label in ("ctr", "finish"):
            cases.append(unfold_group_case(bundle, b, cycles_per_ms))
        if label == "ctr212":
            # K4: one column, as each of the 180 launches a step took before
            # it was grouped, and the grouped call over all 180
            key = sorted(batch)[0]
            skey = eng.table_map[eng.columns[key].categorical_column.key][0]
            cases.append(unfold_case("unfold_rows", eng, skey, {key: batch[key]}, cycles_per_ms))
            cases.append(unfold_rows_group_case("ctr212, 180 columns", bundle, b, 60,
                                                cycles_per_ms))
        if label != "multi_head":
            cases.append(adam_case(eng, state.tables, batch, cycles_per_ms))
        if label in ("ctr212", "multi_head"):
            f = 180 if label == "ctr212" else 40
            cases.append(attention_case(2, 4, f, b, 200 + f, cycles_per_ms, rate=DROPOUT))
            cases.append(attention_bwd_case(2, 4, f, b, 210 + f, cycles_per_ms))
        del state
        for c in cases:
            c["model"] = label
            log(json.dumps(c))
        out["cases"] += cases

        small = dict(kw, bucket_size=check_bucket)
        res["card_vs_cpu"] = hold_card_to_cpu(
            create_model(name, device="cuda", **small), create_model(name, device="cpu", **small),
            TOWER_CHECK_BATCH, ipf, label)
        out["train"][label] = res
        del bundle, step, batch, dense, labels, weight
        torch.cuda.empty_cache()
    return out


def finish_serving_path(card):
    """Phase 8, serving: the full-width finish ``ScoringService`` (40
    tables of 25,600 x 32, one a storage) through ``score()`` and over HTTP
    in one window of counts, scores in (0, 1), unchanged by padding and
    equal to the CPU plain path's; then the predict step's launches per
    call at B = 32768 (5 ids: one K1; 1 id: one K2), held to the CPU at B =
    64, and its examples/s."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import make_predict_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    bundle = create_model("finish", device="cuda")
    cpu_bundle = create_model("finish", device="cpu")
    state = create_train_state(bundle, seed=11)
    rows = raw_rows(np.random.default_rng(12), 200, 5, tuple(str(3000 + s) for s in range(40)))
    torch.cuda.synchronize()
    reset_launch_counts()
    scores = fused_service_run("finish", bundle, state, cpu_bundle, rows, 0.0, 1.0)
    torch.cuda.synchronize()
    serving = launch_counts()
    log("finish serving launches:", json.dumps(serving))
    if serving["fold_mean"] < 1 or any(v for k, v in serving.items() if k != "fold_mean"):
        raise AssertionError(f"finish serving launched {serving}, expected fold_mean only")
    for task, v in scores.items():
        if not (0.0 < min(v) and max(v) < 1.0):
            raise AssertionError(f"finish {task}: scores outside (0, 1)")

    step = make_predict_step(bundle)
    per_call, launches, batches = {}, dict(serving), {}
    for ipf, want in ((5, {"fold_mean": 1}), (1, {"fold_rows": 1})):
        batch = batches[ipf] = synthetic_batch(bundle, FINISH_BATCH, seed=13,
                                               ids_per_feature=ipf)[0]
        step(state, batch)
        torch.cuda.synchronize()
        reset_launch_counts()
        pred = step(state, batch)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = {k: launches[k] + v for k, v in counts.items()}
        per_call[f"ids{ipf}"] = {k: v for k, v in counts.items() if v}
        if per_call[f"ids{ipf}"] != want:
            raise AssertionError(f"finish predict, {ipf} ids: launches {per_call[f'ids{ipf}']}")
        check_heads({k: v.squeeze(1).cpu().numpy() for k, v in pred.items()}, FINISH_BATCH,
                    0.0, 1.0, f"finish predict, {ipf} ids")
        check = synthetic_batch(bundle, CHECK_BATCH, seed=14, ids_per_feature=ipf)[0]
        cpu_out = make_predict_step(cpu_bundle)(_cpu_state(state),
                                                {k: v.to("cpu") for k, v in check.items()})
        assert_heads_close({k: v.cpu().numpy() for k, v in step(state, check).items()},
                           {k: v.numpy() for k, v in cpu_out.items()},
                           f"finish predict b={CHECK_BATCH}, {ipf} ids, card vs CPU")
    batch = batches[5]
    windows = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            step(state, batch)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 10 * 1e3)
    ms = sorted(windows)[1]
    return {"launches": launches, "serve_launches": serving,
            "predict": {"metric": "torch_finish_predict_examples_per_sec",
                        "unit": "examples/s", "value": FINISH_BATCH / ms * 1e3,
                        "ms_per_call": ms, "window_ms": windows, "batch": FINISH_BATCH,
                        "ids_per_feature": 5, "launches_per_call": per_call, "card": card}}


def _rough_rows(rng, n):
    """rough_rank request rows (its 49 default slots, 1-5 raw ids each,
    one feature in five left out) and their dense fields: the flag 4575 at
    0 or 1, every third request with none (the service then takes 0)."""
    from recommendsystem_tpu_torch.models.rough_rank import FLAG_SLOT

    slots = tuple(str(s) for s in range(1560, 1590)) + tuple(str(s) for s in range(1591, 1610))
    rows = raw_rows(rng, n, 5, slots)
    dense = [{} if i % 3 == 2 else {FLAG_SLOT: float(rng.integers(0, 2))} for i in range(n)]
    return rows, dense


def rough_rank_path(card, cycles_per_ms):
    """Phase 9: rough_rank at the JAX defaults (49 mean columns of 16-d
    rows over 25,600-id buckets in 25 storages, the dense flag 4575, B =
    32768).  Train: a counted window of ``TRAIN_STEPS`` steps with 5 ids
    (one K1, K3 and K8 a step, nothing else) and one with 1 id (one K2, K4
    and K8), losses finite, t and show equal to the live counts; the step's
    examples/s; two card steps held to the CPU at ``ROUGH_CHECK_BUCKET``
    and B = 64.  The kernels at its shapes (K1 and K3 grouped over the 49
    columns, K4 grouped at 1 id, K8 over the 25 storages).  Serve: the
    service over buckets 8-256 with the flag in the requests, through
    ``score()`` and over HTTP, student and teacher in (0, 1), the card
    equal to the CPU; the predict step's launches and examples/s at B =
    32768."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import make_predict_step, make_train_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    bundle = create_model("rough_rank", device="cuda")
    eng = bundle.embedding
    step = make_train_step(bundle)
    out = {"card": card, "batch": ROUGH_BATCH, "storages": len(eng.storage),
           "rows": sorted({r for r, _ in eng.storage.values()}), "train": {}}
    data = {ipf: synthetic_batch(bundle, ROUGH_BATCH, seed=70 + ipf, ids_per_feature=ipf)
            for ipf in (5, 1)}
    want = {5: {"fold_mean": 1, "unfold_mean": 1, "sparse_adam_update": 1},
            1: {"fold_rows": 1, "unfold_rows": 1, "sparse_adam_update": 1}}
    launches = None
    for ipf in (5, 1):
        batch, dense, labels, weight = data[ipf]
        state = create_train_state(bundle, seed=12)
        torch.cuda.synchronize()
        reset_launch_counts()
        infos = []
        for i in range(TRAIN_STEPS):
            state, info = step(state, batch, labels, weight, dense, seed=i)
            infos.append(info)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = {k: (launches or {}).get(k, 0) + v for k, v in counts.items()}
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items() if v}
        if per_step != want[ipf]:
            raise AssertionError(f"rough_rank train, {ipf} ids: launches a step {per_step}, "
                                 f"expected {want[ipf]}")
        losses = [{k: float(v) for k, v in i.items()} for i in infos]
        if not all(np.isfinite(list(x.values())).all() for x in losses):
            raise AssertionError(f"rough_rank train, {ipf} ids: losses {losses}")
        live = eng.row_counts(batch)
        for skey, tstate in state.tables.items():
            if not (torch.equal(tstate["show"], TRAIN_STEPS * live[skey])
                    and torch.equal(tstate["opt"]["t"], TRAIN_STEPS * (live[skey] > 0).float())):
                raise AssertionError(f"rough_rank {skey}: t or show differ from the live counts")
        ms, windows = train_ms(step, state, batch, labels, weight, dense, per_window=5)
        out["train"][f"ids{ipf}"] = {
            "metric": "torch_rough_rank_train_examples_per_sec", "unit": "examples/s",
            "value": ROUGH_BATCH / ms * 1e3, "ms_per_step": ms, "window_ms": windows,
            "batch": ROUGH_BATCH, "launches_per_step": per_step, "losses": losses}
        log(f"rough_rank train, {ipf} ids:", json.dumps(out["train"][f"ids{ipf}"]))
        if ipf == 5:
            tables = state.tables
    out["launches"] = launches

    # the kernels at rough_rank's shapes
    cases = [fold_group_case(bundle, create_train_state(bundle, seed=13), ROUGH_BATCH,
                             cycles_per_ms),
             unfold_group_case(bundle, ROUGH_BATCH, cycles_per_ms),
             unfold_rows_group_case("rough_rank, 49 columns", bundle, ROUGH_BATCH, 74,
                                    cycles_per_ms),
             adam_case(eng, tables, data[5][0], cycles_per_ms)]
    for c in cases:
        c["model"] = "rough_rank"
        log(json.dumps(c))
    out["cases"] = cases
    del tables

    small = {"bucket_size": ROUGH_CHECK_BUCKET}
    out["card_vs_cpu"] = {f"ids{ipf}": hold_card_to_cpu(
        create_model("rough_rank", device="cuda", **small),
        create_model("rough_rank", device="cpu", **small), TOWER_CHECK_BATCH, ipf,
        f"rough_rank {ipf} ids") for ipf in (5, 1)}

    # serving: buckets 8-256, the flag in the requests
    state = create_train_state(bundle, seed=14)
    cpu_bundle = create_model("rough_rank", device="cpu")
    rows, dense = _rough_rows(np.random.default_rng(15), 200)
    torch.cuda.synchronize()
    reset_launch_counts()
    scores = fused_service_run("rough_rank", bundle, state, cpu_bundle, rows, -np.inf, np.inf,
                               dense)
    torch.cuda.synchronize()
    serving = launch_counts()
    log("rough_rank serving launches:", json.dumps(serving))
    if serving["fold_mean"] < 1 or any(v for k, v in serving.items() if k != "fold_mean"):
        raise AssertionError(f"rough_rank serving launched {serving}, expected fold_mean only")
    if set(scores) != {"student", "teacher", "user_emb", "item_emb"}:
        raise AssertionError(f"rough_rank serves {sorted(scores)}")
    for task in ("student", "teacher"):
        if not (0.0 < min(scores[task]) and max(scores[task]) < 1.0):
            raise AssertionError(f"rough_rank {task}: scores outside (0, 1)")
    out["serve_launches"] = serving

    predict = make_predict_step(bundle)
    batch, pdense = synthetic_batch(bundle, ROUGH_BATCH, seed=16)[:2]
    predict(state, batch, pdense)
    torch.cuda.synchronize()
    reset_launch_counts()
    pred = predict(state, batch, pdense)
    torch.cuda.synchronize()
    per_call = {k: v for k, v in launch_counts().items() if v}
    if per_call != {"fold_mean": 1}:
        raise AssertionError(f"rough_rank predict: launches {per_call}")
    check_heads({k: pred[k].squeeze(1).cpu().numpy() for k in ("student", "teacher")},
                ROUGH_BATCH, 0.0, 1.0, "rough_rank predict")
    check, cdense = synthetic_batch(bundle, CHECK_BATCH, seed=17)[:2]
    cpu_out = make_predict_step(cpu_bundle)(
        _cpu_state(state), {k: v.to("cpu") for k, v in check.items()},
        {k: v.cpu() for k, v in cdense.items()})
    assert_heads_close({k: v.cpu().numpy() for k, v in predict(state, check, cdense).items()},
                       {k: v.numpy() for k, v in cpu_out.items()},
                       f"rough_rank predict b={CHECK_BATCH}, card vs CPU")
    windows = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            predict(state, batch, pdense)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / 10 * 1e3)
    ms = sorted(windows)[1]
    out["predict"] = {"metric": "torch_rough_rank_predict_examples_per_sec",
                      "unit": "examples/s", "value": ROUGH_BATCH / ms * 1e3,
                      "ms_per_call": ms, "window_ms": windows, "batch": ROUGH_BATCH,
                      "launches_per_call": per_call, "card": card}
    out["launches"] = {k: v + serving[k] + per_call.get(k, 0) for k, v in launches.items()}
    return out


def stacked_serving_path():
    """The stacked-expert variants of ctr, multi_head and staytime, each at
    a small size (4096-id buckets; staytime's sequences of 8): one serving
    call of 64 requests on the card against the same on the CPU.  Returns
    the launch counts of the three calls."""
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
    from recommendsystem_tpu_torch.serving import ScoringService
    from recommendsystem_tpu_torch.train.state import create_train_state

    rng = np.random.default_rng(18)
    cfg = StaytimeConfig(bucket_size=4096, seq_max_len=8)
    runs = (("ctr", {"bucket_size": 4096}, raw_rows(rng, 64, 5)),
            ("multi_head", {"bucket_size": 4096},
             raw_rows(rng, 64, 5, tuple(str(2000 + s) for s in range(40)))),
            ("staytime", {"cfg": cfg}, staytime_rows(rng, 64, cfg.slots, cfg.seq_slots)))
    torch.cuda.synchronize()
    reset_launch_counts()
    for name, kw, rows in runs:
        bundle = create_model(name, stacked_experts=True, device="cuda", **kw)
        cpu_bundle = create_model(name, stacked_experts=True, device="cpu", **kw)
        state = create_train_state(bundle, seed=19)
        got = ScoringService(bundle, state, max_batch=256, ids_per_feature=5).score(rows)
        want = ScoringService(cpu_bundle, _cpu_state(state), max_batch=256, ids_per_feature=5,
                              device="cpu").score(rows)
        assert_heads_close(got, want, f"stacked {name}, card vs CPU")
        if name == "staytime":
            check_staytime_scores(got, len(rows))
        else:
            check_heads(got, len(rows), 0.0, 1.0, f"stacked {name}")
    torch.cuda.synchronize()
    counts = launch_counts()
    log("stacked serving launches:", json.dumps(counts))
    for k in ("fold_mean", "interacting_attention", "din_pool"):
        if counts[k] < 1:
            raise AssertionError(f"stacked serving did not launch {k}")
    return counts


# launches a staytime train step must take, by ids a mean column: K1 folds
# the 91 mean columns (5 ids) and K2 the 3 sequences of 50 (with 1 id the
# 91 single-id columns too), K7 pools each sequence on the facts given, K3
# scatters the mean columns (one launch of up to 512), K4 the sequences
# (and the single-id columns), K9 updates the 46 storages
STAYTIME_TRAIN_LAUNCHES = {
    5: {"fold_mean": 1, "fold_rows": 1, "din_pool": 3, "unfold_mean": 1, "unfold_rows": 1,
        "sparse_adagrad_update": 1},
    1: {"fold_rows": 1, "din_pool": 3, "unfold_rows": 1, "sparse_adagrad_update": 1}}


def staytime_train_path(card, cycles_per_ms):
    """Phase 10: the staytime train step at full width (the default
    ``StaytimeConfig``: 91 mean columns of 32-d rows over 81,920-id buckets
    and 3 sequences of 50 in 46 storages, sparse AdaGrad, B = 16384).  A
    counted window of ``TRAIN_STEPS`` steps with 5 ids and one with 1 id,
    each from a fresh state and held to ``STAYTIME_TRAIN_LAUNCHES``; losses
    finite, show equal to the live counts, g2sum grown on live rows and
    untouched on the others; examples/s.  The kernels at its shapes: K9
    over the 46 storages with bound and library times, K9 over mixed
    groups, K3 over the 91 mean columns, K4 over the 3 sequences (5 ids)
    and over the 94 single-id and sequence columns (1 id).  Then two card
    steps held to the CPU at ``STAYTIME_CHECK_BUCKET`` and B = 64, with 5
    ids and with 1, over ``CHECK_SEEDS``."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
    from recommendsystem_tpu_torch.train import make_train_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    bundle = create_model("staytime", device="cuda")
    eng = bundle.embedding
    init_g2 = eng.sparse_opt.initial_g2sum
    step = make_train_step(bundle)
    b = STAYTIME_BATCH
    out = {"card": card, "batch": b, "storages": len(eng.storage),
           "rows": sum(r for r, _ in eng.storage.values()), "train": {}}
    launches = None
    for ipf in (5, 1):
        batch, dense, labels, weight = synthetic_batch(bundle, b, seed=90 + ipf,
                                                       ids_per_feature=ipf)
        state = create_train_state(bundle, seed=22)
        torch.cuda.synchronize()
        reset_launch_counts()
        infos = []
        for i in range(TRAIN_STEPS):
            state, info = step(state, batch, labels, weight, dense, seed=i)
            infos.append(info)
        torch.cuda.synchronize()
        counts = launch_counts()
        launches = {k: (launches or {}).get(k, 0) + v for k, v in counts.items()}
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items() if v}
        if per_step != STAYTIME_TRAIN_LAUNCHES[ipf]:
            raise AssertionError(f"staytime train, {ipf} ids: launches a step {per_step}, "
                                 f"expected {STAYTIME_TRAIN_LAUNCHES[ipf]}")
        losses = [{k: float(v) for k, v in i.items()} for i in infos]
        if not all(np.isfinite(list(x.values())).all() for x in losses):
            raise AssertionError(f"staytime train, {ipf} ids: losses {losses}")
        live = eng.row_counts(batch)
        for skey, tstate in state.tables.items():
            hit = live[skey] > 0
            g2 = tstate["opt"]["g2sum"]
            if not (torch.equal(tstate["show"], TRAIN_STEPS * live[skey])
                    and bool((g2[~hit] == init_g2).all()) and bool((g2[hit] >= init_g2).all())):
                raise AssertionError(f"staytime {skey}: show or g2sum differ from the live "
                                     f"counts")
        ms, windows = train_ms(step, state, batch, labels, weight, dense, per_window=5)
        out["train"][f"ids{ipf}"] = {
            "metric": "torch_staytime_train_examples_per_sec", "unit": "examples/s",
            "value": b / ms * 1e3, "ms_per_step": ms, "window_ms": windows, "batch": b,
            "launches_per_step": per_step, "losses": losses}
        log(f"staytime train, {ipf} ids:", json.dumps(out["train"][f"ids{ipf}"]))
        if ipf == 5:
            tables, batch5 = state.tables, batch
        del state
    out["launches"] = launches

    cases = [adagrad_case(eng, tables, batch5, cycles_per_ms),
             *adagrad_mixed_case(cycles_per_ms),
             unfold_group_case(bundle, b, cycles_per_ms),
             unfold_rows_group_case("staytime, 3 sequences, 5 ids", bundle, b, 95,
                                    cycles_per_ms, ipf=5),
             unfold_rows_group_case("staytime, 94 columns, 1 id", bundle, b, 96,
                                    cycles_per_ms, ipf=1)]
    del tables, batch5
    for c in cases:
        c["model"] = "staytime"
        log(json.dumps(c))
    out["cases"] = cases
    torch.cuda.empty_cache()

    small = {"cfg": StaytimeConfig(bucket_size=STAYTIME_CHECK_BUCKET)}
    gsmall = create_model("staytime", device="cuda", **small)
    csmall = create_model("staytime", device="cpu", **small)
    out["card_vs_cpu"] = {f"ids{ipf}": hold_card_to_cpu(gsmall, csmall, TOWER_CHECK_BATCH, ipf,
                                                        f"staytime {ipf} ids")
                          for ipf in (5, 1)}
    return out


# -- phase 11: the eval path ---------------------------------------------------
EVAL_BATCHES = 2                  # batches an evaluate() call in the counted window
EVAL_SUM_RTOL = 1e-6              # metric sums: float32 sums of <= 64 terms, other order
DUMP_BATCH = 256
GAUC_BATCHES = 3
# the eval step launches the predict step's kernels and no other
EVAL_LAUNCHES = {
    "k6": {"fold_mean": 1, "interacting_attention": 1},
    "k6_rows": {"fold_rows": 1, "interacting_attention": 1},
    "mean": {"fold_mean": 1},
    "staytime5": {"fold_mean": 1, "din_pool": 3},
    "staytime1": {"fold_rows": 1, "din_pool": 3}}
# XLA's float-to-int32 conversion saturates: these predictions fall into
# these bins of 8 over [0, 1) (NaN bin 0); 8 of them lie outside the range
ODD_PREDS = (1e10, -1e10, float("inf"), -float("inf"), float("nan"), 3.7, -0.5, 0.999999,
             1.0, 0.0, -1e-30, 0.5)
ODD_BINS = (7, 0, 7, 0, 0, 7, 0, 7, 7, 0, 0, 4)
ODD_OOR = 8.0
# the collision-free case agrees with the offline GAUC as
# tests/test_streaming_gauc.py holds them end to end
GAUC_AGREE = 0.02


def _count_syncs(fn):
    """The host syncs of one call of ``fn``, counted under
    ``torch.cuda.set_sync_debug_mode("warn")``: for each, the last
    "file:line" frames of the Python stack that reached it.  (The first
    use of the debug mode in a process reports one sync of its own, from
    ``torch/cuda/__init__.py``: count each call twice.)"""
    import traceback
    import warnings

    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            syncs.append(" < ".join(f"{os.path.relpath(f.filename)}:{f.lineno}"
                                    for f in traceback.extract_stack()[-7:-1][::-1]))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return syncs


def _batch_to(item, device):
    """(batch, dense_inputs, labels, weight) copied to ``device``."""
    batch, dense, labels, weight = item
    return ({k: v.to(device) for k, v in batch.items()},
            None if dense is None else {k: v.to(device) for k, v in dense.items()},
            {k: v.to(device) for k, v in labels.items()}, weight.to(device))


def _check_metric_values(values, what):
    """AUC, accuracy and bin accuracy in [0, 1]; COPC, CTR, MAE, MSE finite."""
    for task, ms in values.items():
        for name, v in ms.items():
            ok = (0.0 <= v <= 1.0) if name in ("auc", "acc", "bin_acc") else np.isfinite(v)
            if not ok:
                raise AssertionError(f"{what} {task} {name} = {v}")


def _check_states(got, want, what):
    """Card states against the CPU's: counts exact (the weights are 1 and
    the labels 0 or 1), sums of outputs at ``EVAL_SUM_RTOL``."""
    counts = {"correct", "total", "tp", "fp", "tn", "fn", "label", "n"}
    for task, states in want.items():
        for i, (g, w) in enumerate(zip(got[task], states)):
            for k in w:
                gk, wk = g[k].cpu().numpy(), w[k].numpy()
                if k in counts:
                    np.testing.assert_array_equal(gk, wk, err_msg=f"{what} {task} #{i} {k}")
                else:
                    np.testing.assert_allclose(gk, wk, rtol=EVAL_SUM_RTOL,
                                               err_msg=f"{what} {task} #{i} {k}")


def eval_model(label, bundle, state, cpu_bundle, b, ipf, want, cycles_per_ms):
    """One model's eval path at its train batch ``b``: ``evaluate`` over
    ``EVAL_BATCHES`` batches in a window of counts (held to ``want`` a
    step, as the predict step's one call), the metric values in range;
    host syncs of one eval step and one predict call; eval and predict
    steps timed in turns; the metric update alone by CUDA events; two
    sides at B = 64 and each ``CHECK_SEEDS``: the card's outputs against
    the CPU plain path's, the card's metric states against the CPU metric
    functions on the card's own outputs; ``dump_predict`` with ``need_y``
    at B = 256 held to the predict step's scores."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.train import (dump_predict, evaluate, make_eval_step,
                                                 make_predict_step)
    from recommendsystem_tpu_torch.train import metrics as M

    step, pstep = make_eval_step(bundle), make_predict_step(bundle)
    data = [synthetic_batch(bundle, b, seed=110 + i, ids_per_feature=ipf)
            for i in range(EVAL_BATCHES)]
    batch, dense, labels, weight = data[0]
    states0 = M.init_metrics(bundle.metrics, bundle.device)
    step(state, batch, labels, weight, dense, states0)
    pstep(state, batch, dense)
    torch.cuda.synchronize()

    reset_launch_counts()
    values = evaluate(bundle, data, state)
    torch.cuda.synchronize()
    counts = launch_counts()
    per_step = {k: v / EVAL_BATCHES for k, v in counts.items() if v}
    reset_launch_counts()
    pstep(state, batch, dense)
    torch.cuda.synchronize()
    per_predict = {k: v for k, v in launch_counts().items() if v}
    if per_step != want or per_predict != want:
        raise AssertionError(f"{label} eval: launches a step {per_step}, a predict call "
                             f"{per_predict}, expected {want}")
    _check_metric_values(values, f"{label} evaluate")

    runs = {"predict": lambda: pstep(state, batch, dense),
            "eval": lambda: step(state, batch, labels, weight, dense, states0)}
    # each counted twice, in turns; the second count is the steady one
    syncs = {}
    for kind in ("predict", "eval", "predict", "eval"):
        syncs[kind] = _count_syncs(runs[kind])
    if syncs["eval"] or syncs["predict"]:
        raise AssertionError(f"{label}: host syncs of an eval step {syncs['eval']}, of a "
                             f"predict call {syncs['predict']}")

    windows = {"predict": [], "eval": []}
    for order in (("predict", "eval"), ("eval", "predict"), ("predict", "eval")):
        for kind in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                runs[kind]()
            torch.cuda.synchronize()
            windows[kind].append((time.perf_counter() - t0) / 5 * 1e3)
    ms = {k: sorted(v)[1] for k, v in windows.items()}
    with torch.inference_mode():
        outs = step(state, batch, labels, weight, dense, states0)[1]
        update = lambda: M.update_metrics(bundle.metrics, states0,   # noqa: E731
                                          {t: labels[t] for t in bundle.metrics},
                                          {t: outs[t] for t in bundle.metrics}, weight)
        update_ms, update_host_ms = timed(update, 10, cycles_per_ms)

    # card against CPU
    cpu_state = _cpu_state(state)
    cpu_step = make_eval_step(cpu_bundle)
    for seed in CHECK_SEEDS:
        item = synthetic_batch(bundle, CHECK_BATCH, seed=seed, ids_per_feature=ipf)
        g_states, g_out = step(state, item[0], item[2], item[3], item[1],
                               M.init_metrics(bundle.metrics, bundle.device))
        cb, cd, cl, cw = _batch_to(item, "cpu")
        _, c_out = cpu_step(cpu_state, cb, cl, cw, cd, M.init_metrics(cpu_bundle.metrics, "cpu"))
        for k in c_out:
            np.testing.assert_allclose(g_out[k].cpu().numpy(), c_out[k].numpy(),
                                       err_msg=f"{label} eval b={CHECK_BATCH} seed {seed}: {k}",
                                       **SCORE_TOL)
        want_states = M.update_metrics(cpu_bundle.metrics,
                                       M.init_metrics(cpu_bundle.metrics, "cpu"),
                                       {t: cl[t] for t in cpu_bundle.metrics},
                                       {t: g_out[t].cpu() for t in cpu_bundle.metrics}, cw)
        _check_states(g_states, want_states, f"{label} seed {seed}")

    # dump_predict with the labels, held to the predict step's scores
    items = [synthetic_batch(bundle, DUMP_BATCH, seed=120 + i, ids_per_feature=ipf)
             for i in range(2)]
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"dump_{label}.tsv")
    n = dump_predict(bundle, items, state, path, need_y=True)
    with open(path) as fh:
        rows = [line.rstrip("\n").split("\t") for line in fh]
    os.remove(path)
    preds = [pstep(state, it[0], it[1]) for it in items]
    tasks = sorted(preds[0])
    width = 1 + len(tasks) + sum(t in items[0][2] for t in tasks)
    if n != 2 * DUMP_BATCH or len(rows) != n or any(len(r) != width for r in rows):
        raise AssertionError(f"{label} dump_predict: {n} rows of {len(rows[0])} columns, "
                             f"expected {2 * DUMP_BATCH} of {width}")
    for j, t in enumerate(tasks):
        got = np.array([float(r[1 + j]) for r in rows])
        ref = np.concatenate([p[t].reshape(DUMP_BATCH, -1)[:, 0].cpu().numpy() for p in preds])
        np.testing.assert_allclose(got, ref, err_msg=f"{label} dump_predict {t}", **SCORE_TOL)
    return {"batch": b, "ids_per_feature": ipf if isinstance(ipf, int) else "1 a column",
            "launches_per_step": per_step, "launches_per_predict": per_predict,
            "launches": counts, "values": values,
            "eval_ms": ms["eval"], "predict_ms": ms["predict"], "window_ms": windows,
            "eval_examples_per_s": b / ms["eval"] * 1e3,
            "predict_examples_per_s": b / ms["predict"] * 1e3,
            "metric_update_ms": update_ms, "metric_update_host_ms": update_host_ms,
            "syncs_per_eval_step": len(syncs["eval"]),
            "syncs_per_predict": len(syncs["predict"]), "syncs_at": syncs, "dump_rows": n}


def auc_update_case(b, seed, device, cycles_per_ms):
    """The AUC update alone at batch ``b`` on ``device`` by CUDA events (it
    builds (200, B) temporaries), against the CPU's on the same inputs."""
    from recommendsystem_tpu_torch.train import metrics as M

    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.integers(0, 2, (b, 1)).astype(np.float32))
    p = torch.from_numpy(rng.uniform(0, 1, (b, 1)).astype(np.float32))
    m = M.auc()
    s0 = m.init(device)
    yd, pd = y.to(device), p.to(device)
    got = m.update(s0, yd, pd)
    want = m.update(m.init("cpu"), y, p)
    for k in want:
        np.testing.assert_array_equal(got[k].cpu().numpy(), want[k].numpy(), err_msg=k)
    ms, host_ms = timed(lambda: m.update(s0, yd, pd), 20, cycles_per_ms)
    t = M.auc_thresholds().shape[0]
    return {"name": "auc_update", "b": b, "ms": ms, "host_ms": host_ms,
            "bytes_min": 2 * b * 4 + 4 * 2 * t * 4, "temporaries_bytes": 6 * t * b * 4}


def gauc_path(bundle, state, cycles_per_ms):
    """Streaming GAUC on full-width staytime over ``GAUC_BATCHES`` batches
    of B = 16384, user ids from a seeded generator, the reference example's
    mixed engines (``examples/train_staytime_gauc.py:69-74``): the GAUC
    step's launches (the predict step's); its states equal to the card's
    updates on the predict step's outputs, and those equal to the CPU's on
    the same outputs; saturating bins on the card and the CPU; the
    collision-free case, offline against streaming; the updates' times."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models.staytime import T_LONG, T_SHORT, T_STAY
    from recommendsystem_tpu_torch.train import (StreamingGauc, StreamingSpearmanGauc,
                                                 evaluate_gauc, evaluate_gauc_streaming,
                                                 make_gauc_eval_step, make_predict_step)

    b, dev = STAYTIME_BATCH, bundle.device
    tasks = (T_STAY, T_SHORT, T_LONG)
    stay = dict(pred_lo=-20.0, pred_hi=181.0, label_lo=0.0, label_hi=161.0)
    gauc = {T_STAY: StreamingSpearmanGauc(**stay), T_SHORT: StreamingGauc(4096, 256),
            T_LONG: StreamingGauc(4096, 256)}
    rng = np.random.default_rng(130)
    items = [(*synthetic_batch(bundle, b, seed=131 + i), {"user_id": rng.integers(0, 1 << 40, b)})
             for i in range(GAUC_BATCHES)]
    step = make_gauc_eval_step(bundle, gauc, tasks=tasks)
    pstep = make_predict_step(bundle)
    users = [torch.from_numpy(it[4]["user_id"]).to(dev) for it in items]
    step(state, items[0][0], items[0][1], items[0][2], users[0],
         {t: gauc[t].init(dev) for t in tasks})
    torch.cuda.synchronize()
    reset_launch_counts()
    states = {t: gauc[t].init(dev) for t in tasks}
    for it, u in zip(items, users):
        states = step(state, it[0], it[1], it[2], u, states)
    torch.cuda.synchronize()
    counts = launch_counts()
    per_step = {k: v / GAUC_BATCHES for k, v in counts.items() if v}
    if per_step != EVAL_LAUNCHES["staytime5"]:
        raise AssertionError(f"staytime GAUC step: launches a step {per_step}")

    card = {t: gauc[t].init(dev) for t in tasks}
    cpu = {t: gauc[t].init("cpu") for t in tasks}
    for it, u in zip(items, users):
        out = pstep(state, it[0], it[1])
        for t in tasks:
            pred = out[t].reshape(b, -1)[:, -1]
            y = it[2][t].reshape(b, -1)[:, -1]
            card[t] = gauc[t].update(card[t], y, pred, u)
            cpu[t] = gauc[t].update(cpu[t], y.cpu(), pred.cpu(), u.cpu())
    for t in tasks:
        for k in cpu[t]:
            np.testing.assert_array_equal(states[t][k].cpu().numpy(), card[t][k].cpu().numpy(),
                                          err_msg=f"GAUC step against the updates: {t} {k}")
            np.testing.assert_array_equal(card[t][k].cpu().numpy(), cpu[t][k].numpy(),
                                          err_msg=f"GAUC card against CPU: {t} {k}")
    values = {t: float(gauc[t].compute(states[t])) for t in tasks}
    oor = {t: float(states[t]["oor"]) for t in (T_SHORT, T_LONG)}

    # saturating bins, card and CPU
    odd = torch.tensor(ODD_PREDS, dtype=torch.float32)
    y = (torch.arange(odd.numel()) % 2).float()
    u = torch.arange(odd.numel())
    g = StreamingGauc(num_buckets=16, num_bins=8, hash_ids=False)
    sides = {d: g.update(g.init(d), y.to(d), odd.to(d), u.to(d)) for d in (dev, "cpu")}
    for d, s in sides.items():
        bins = (s["pos"] + s["neg"]).argmax(1)[:odd.numel()].cpu().tolist()
        if bins != list(ODD_BINS) or float(s["oor"]) != ODD_OOR:
            raise AssertionError(f"saturating bins on {d}: {bins}, oor {float(s['oor'])}")
    sp = StreamingSpearmanGauc(num_buckets=4, pred_bins=8, label_bins=8, hash_ids=False, **stay)
    hs = [sp.update(sp.init(d), (odd * 50).to(d), (odd * 100).to(d), (u % 3).to(d))["hist"].cpu()
          for d in (dev, "cpu")]
    if not torch.equal(hs[0], hs[1]):
        raise AssertionError("saturating Spearman bins: card and CPU differ")

    # collision-free: one user a bucket, narrow bins
    rng = np.random.default_rng(140)
    free = [(*it[:4], {"user_id": rng.integers(0, 64, b)}) for it in items]
    offline = evaluate_gauc(bundle, free, state, spearman_tasks=(T_STAY,))
    streaming = evaluate_gauc_streaming(
        bundle, free, state, tasks=tasks,
        gauc={T_STAY: StreamingSpearmanGauc(num_buckets=64, pred_bins=1024, label_bins=1024,
                                            hash_ids=False, **stay),
              T_SHORT: StreamingGauc(64, 65536, hash_ids=False),
              T_LONG: StreamingGauc(64, 65536, hash_ids=False)})
    for t in tasks:
        if not abs(offline[t] - streaming[t]) < GAUC_AGREE:
            raise AssertionError(f"collision-free GAUC {t}: offline {offline[t]}, "
                                 f"streaming {streaming[t]}")

    out = pstep(state, items[0][0], items[0][1])
    times = []
    for t, what in ((T_SHORT, "StreamingGauc(4096, 256)"),
                    (T_STAY, "StreamingSpearmanGauc(1024, 32, 32)")):
        pred = out[t].reshape(b, -1)[:, -1].contiguous()
        y = items[0][2][t].reshape(b, -1)[:, -1].contiguous()
        s0 = gauc[t].init(dev)
        ms, host_ms = timed(lambda: gauc[t].update(s0, y, pred, users[0]), 20, cycles_per_ms)
        times.append({"name": "gauc_update", "engine": what, "b": b, "ms": ms,
                      "host_ms": host_ms})
    return {"batches": GAUC_BATCHES, "batch": b, "launches": counts,
            "launches_per_step": per_step, "values": values, "oor": oor,
            "collision_free": {"offline": offline, "streaming": streaming},
            "update_times": times}


def eval_path(card, cycles_per_ms, autoint):
    """Phase 11: the eval path of every model at its train batch
    (``eval_model``), the AUC update alone at B = 65536 and 32768, and
    staytime's streaming GAUC (``gauc_path``).  ``autoint`` is phase 3's
    (bundle, state, CPU bundle), reused; the others are built here, one at a
    time.  Returns the summed counts of the windows with the rest."""
    from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train.state import create_train_state

    ctr212 = {"cfg": synthetic_ctr_config(num_slots=180, num_bias=32),
              "bucket_size": CTR212_BUCKET}
    # (label, model, factory kwargs, batch, ids a column, launches a step)
    runs = (("ctr", "ctr", {}, CTR_BATCH, 5, EVAL_LAUNCHES["k6"]),
            ("multi_head", "multi_head", {}, CTR_BATCH, 5, EVAL_LAUNCHES["k6"]),
            ("finish", "finish", {}, FINISH_BATCH, 5, EVAL_LAUNCHES["mean"]),
            ("rough_rank", "rough_rank", {}, ROUGH_BATCH, 5, EVAL_LAUNCHES["mean"]),
            ("ctr212", "ctr", ctr212, CTR212_BATCH, {}, EVAL_LAUNCHES["k6_rows"]),
            ("staytime", "staytime", {}, STAYTIME_BATCH, 5, EVAL_LAUNCHES["staytime5"]))
    out = {"card": card, "models": {}}
    launches = None

    def add(counts):
        nonlocal launches
        launches = {k: (launches or {}).get(k, 0) + v for k, v in counts.items()}

    a_bundle, a_state, a_cpu = autoint
    res = out["models"]["autoint"] = eval_model("autoint", a_bundle, a_state, a_cpu,
                                                BIG_BATCH, 5, EVAL_LAUNCHES["k6"],
                                                cycles_per_ms)
    add(res["launches"])
    log("autoint eval:", json.dumps(res))
    for label, name, kw, b, ipf, want in runs:
        bundle = create_model(name, device="cuda", **kw)
        cpu_bundle = create_model(name, device="cpu", **kw)
        state = create_train_state(bundle, seed=100)
        res = out["models"][label] = eval_model(label, bundle, state, cpu_bundle, b, ipf,
                                                want, cycles_per_ms)
        add(res["launches"])
        log(f"{label} eval:", json.dumps(res))
        if label == "staytime":
            res = out["models"]["staytime_1id"] = eval_model(
                "staytime_1id", bundle, state, cpu_bundle, b, 1, EVAL_LAUNCHES["staytime1"],
                cycles_per_ms)
            add(res["launches"])
            log("staytime, 1 id, eval:", json.dumps(res))
            out["gauc"] = gauc_path(bundle, state, cycles_per_ms)
            add(out["gauc"]["launches"])
            log("staytime GAUC:", json.dumps(out["gauc"]))
        del bundle, cpu_bundle, state
        torch.cuda.empty_cache()
    out["auc_update"] = [auc_update_case(b, 150 + i, a_bundle.device, cycles_per_ms)
                         for i, b in enumerate((BIG_BATCH, CTR_BATCH))]
    log("AUC update:", json.dumps(out["auc_update"]))
    out["launches"] = launches
    return out


# -- phase 12: the daily path -------------------------------------------------
DAILY_DAYS = ("20260801", "20260802")
DAILY_SHARDS = 2                  # TFRecord shards a day
DAILY_PER_SHARD = 2048            # records a shard
DAILY_BATCH = 1024
DAILY_PREDICT_BATCH = 64          # the card's predict call held to the CPU's
FINISH_DAILY_LAUNCHES = {"fold_mean": 1, "unfold_mean": 1, "sparse_adam_update": 1}


def _daily_records(root, day, make, seed):
    """``DAILY_SHARDS`` TFRecord shards of ``DAILY_PER_SHARD`` records under
    ``root/day``, each record ``make(rng, i)`` encoded by the port's
    ``encode_example``."""
    from recommendsystem_tpu_torch.data.example_proto import encode_example
    from recommendsystem_tpu_torch.data.tfrecord import write_tfrecord

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, day))
    for p in range(DAILY_SHARDS):
        write_tfrecord(os.path.join(root, day, f"part-{p:05d}"),
                       [encode_example(make(rng, p * DAILY_PER_SHARD + i))
                        for i in range(DAILY_PER_SHARD)])


def _slot_ids(rng, slots, feats, present=0.9):
    """1-5 raw feasigns for each slot, one slot in ten left out."""
    ids = rng.integers(0, 1 << 62, (len(slots), 5))
    n = rng.integers(1, 6, len(slots))
    keep = rng.uniform(size=len(slots)) < present
    for j, s in enumerate(slots):
        if keep[j]:
            feats[s] = ids[j, :n[j]].tolist()
    return feats


def _staytime_record(slots, day):
    def make(rng, i):
        return _slot_ids(rng, slots, {
            "extra_info": [(f"{day}-{i}" if i % 7 else
                            f"{day}-{i}_video_homepage_landing").encode()],
            "video_duration": [int(rng.integers(5_000, 60_000))],
            "watch_duration": [int(rng.integers(0, 60_000))]})
    return make


def _finish_record(slots, day):
    def make(rng, i):
        return _slot_ids(rng, slots, {"label": [int(rng.integers(0, 2))],
                                      "extra_info": [f"{day}-{i}".encode()]})
    return make


class _StepRecorder:
    """Wraps ``harness.make_train_step`` so that each step ``fit`` takes
    records its launches (the counts before and after the call, host-side)
    and two CUDA events around it, recorded on the stream with no host
    sync: after the run, each step's device-timeline ms."""

    def __init__(self):
        self.steps = []

    def wrap(self, make):
        from recommendsystem_tpu_torch.kernels import launch_counts

        def make_recorded(bundle, mode="local", **kwargs):
            step = make(bundle, mode, **kwargs)

            def recorded(state, batch, *args, **kwargs):
                before = launch_counts()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = step(state, batch, *args, **kwargs)
                end.record()
                after = launch_counts()
                self.steps.append(({k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}, start, end,
                                   next(iter(batch.values())).rows.shape[0]))
                return out
            return recorded
        return make_recorded

    def times_ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for _, s, e, _ in self.steps]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _assert_same_state(got, want, what):
    """Every tensor of two train states bit for bit, the ints equal."""
    if got.step != want.step or got.opt_state["count"] != want.opt_state["count"]:
        raise AssertionError(f"{what}: step or Adam count differ")
    g = dict(_leaves({"p": got.params, "o": got.opt_state, "t": got.tables}))
    w = dict(_leaves({"p": want.params, "o": want.opt_state, "t": want.tables}))
    if g.keys() != w.keys():
        raise AssertionError(f"{what}: the states hold other entries")
    for k, v in w.items():
        same = torch.equal(g[k], v) if isinstance(v, torch.Tensor) else g[k] == v
        if not same:
            raise AssertionError(f"{what}: {k} differs")


def _daily_run(name, data, state_dir, days, extra, want_launches, recorder):
    """``daily.main`` over ``days`` with ``extra`` flags in a window of
    counts, then the checks every run shares: each step's launches, the
    marker, a checkpoint a day, a second run that trains nothing.  Returns
    (final state, the window's counts, the run's wall s)."""
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.train import daily

    argv = ["--model", name, "--data-dir", data, "--state-dir", state_dir,
            "--batch-size", str(DAILY_BATCH), "--today", days[-1], "--log-every", "2",
            *extra]
    torch.cuda.synchronize()
    reset_launch_counts()
    first = len(recorder.steps)
    t0 = time.perf_counter()
    state = daily.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if daily.main(argv) is not None:
        raise AssertionError(f"daily {name}: a second run trained again")
    counts = launch_counts()
    steps = recorder.steps[first:]
    per_day = DAILY_SHARDS * DAILY_PER_SHARD // DAILY_BATCH
    if len(steps) != per_day * len(days) or state.step != len(steps):
        raise AssertionError(f"daily {name}: {len(steps)} steps, state at {state.step}")
    for i, (got, _, _, rows) in enumerate(steps):
        if got != want_launches or rows != DAILY_BATCH:
            raise AssertionError(f"daily {name}, step {i}: launches {got} over {rows} "
                                 f"rows, expected {want_launches}")
    if daily.read_marker(state_dir) != days[-1]:
        raise AssertionError(f"daily {name}: marker {daily.read_marker(state_dir)}")
    ckpts = sorted(os.listdir(os.path.join(state_dir, "ckpt")), key=int)
    if ckpts != [str(per_day * (i + 1)) for i in range(len(days))]:
        raise AssertionError(f"daily {name}: checkpoints {ckpts}")
    return state, counts, wall


def daily_path(card):
    """Phase 12: the daily training path at full width.  Two days of
    staytime records (``DAILY_SHARDS`` shards of ``DAILY_PER_SHARD`` a day:
    the default ``StaytimeConfig``'s 91 slots, 1-5 ids each, watch
    duration and extra info) written by the port's ``encode_example`` and
    ``write_tfrecord``; the Python loader (parse, pin, copy to the card)
    and the C++ loader timed over one day, their first batches equal;
    ``train.daily.main`` with ``--backtest --evict-min-show 1
    --predict-out`` at B = ``DAILY_BATCH`` (each step's launches
    ``STAYTIME_TRAIN_LAUNCHES[5]``, the marker, a checkpoint a day, a
    second run a no-op, the last checkpoint equal to the returned state bit
    for bit, ``backtest.jsonl`` with the JAX keys and finite values, a dump
    line a record); one day of finish (the ctr parse, K8); the checkpoint
    saved and restored, timed; the server's ``main --checkpoint`` on a free
    port answering ``/healthz`` with the restored step and ``/score`` for
    200 rows equal to a service over the restored state; the checkpoint
    restored onto the CPU, one predict call held to the card's.  Returns
    the summed counts of the windows with the rest."""
    import shutil
    import tempfile

    from recommendsystem_tpu_torch.data.loader import dataset_reader, list_files
    from recommendsystem_tpu_torch.data.native_loader import NativeRecordLoader, get_lib
    from recommendsystem_tpu_torch.data.parse import make_staytime_parse_fn
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.staytime import T_STAY
    from recommendsystem_tpu_torch.serving import ScoringService
    from recommendsystem_tpu_torch.train import harness, make_predict_step
    from recommendsystem_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                            save_checkpoint)
    from recommendsystem_tpu_torch.train.state import create_train_state

    out = {"card": card, "batch": DAILY_BATCH, "records_a_day": DAILY_SHARDS * DAILY_PER_SHARD}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_daily_")
    recorder = _StepRecorder()
    real_make = harness.make_train_step
    launches = None

    def add(counts):
        nonlocal launches
        launches = {k: (launches or {}).get(k, 0) + v for k, v in counts.items()}

    try:
        cpu_bundle = create_model("staytime", device="cpu")
        slots = cpu_bundle.config.slots
        data = os.path.join(tmp, "staytime")
        t0 = time.perf_counter()
        for i, day in enumerate(DAILY_DAYS):
            _daily_records(data, day, _staytime_record(slots, day), seed=120 + i)
        out["write_s"] = time.perf_counter() - t0

        # the data plane alone over one day: the Python loader to the card,
        # the C++ loader to host tensors
        parse_fn = make_staytime_parse_fn(cpu_bundle.embedding)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        py = list(dataset_reader(data, DAILY_DAYS[:1], "part-*", DAILY_BATCH, parse_fn,
                                 device="cuda"))
        torch.cuda.synchronize()
        py_s = time.perf_counter() - t0
        files = list_files(data, days=DAILY_DAYS[:1], match_pattern="part-*")
        t0 = time.perf_counter()
        get_lib()                        # the one g++ build, outside the timed read
        native_build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        native = list(NativeRecordLoader(files, cpu_bundle.embedding, DAILY_BATCH,
                                         scalar_features=["watch_duration"]))
        native_s = time.perf_counter() - t0
        n = out["records_a_day"]
        if sum(b[3].shape[0] for b in py) != n or sum(
                b["1568"].rows.shape[0] for b, _ in native) != n:
            raise AssertionError("the loaders did not read every record of the day")
        for key, ib in py[0][0].items():
            if not (torch.equal(ib.rows.cpu(), native[0][0][key].rows)
                    and torch.equal(ib.mask.cpu(), native[0][0][key].mask)):
                raise AssertionError(f"the C++ loader's {key} differs from the Python's")
        out["loader"] = {"python_examples_per_s": n / py_s, "python_s": py_s,
                         "native_examples_per_s": n / native_s, "native_s": native_s,
                         "native_build_s": native_build_s}
        del py, native

        harness.make_train_step = recorder.wrap(real_make)
        state_dir = os.path.join(tmp, "staytime_state")
        pred = os.path.join(tmp, "staytime_pred.tsv")
        state, counts, wall = _daily_run(
            "staytime", data, state_dir, DAILY_DAYS,
            ["--backtest", "--evict-min-show", "1", "--predict-out", pred],
            STAYTIME_TRAIN_LAUNCHES[5], recorder)
        add(counts)
        step_ms = recorder.times_ms()
        out["staytime"] = {"launches": counts, "wall_s": wall, "step_ms": step_ms,
                           "train_examples_per_s": DAILY_BATCH / float(np.median(step_ms)) * 1e3,
                           "day_examples_per_s": len(DAILY_DAYS) * n / wall}
        bundle = create_model("staytime", device="cuda")
        keys = {"day", "step"} | {f"{t}/{m.name}" for t, ms in bundle.metrics.items()
                                  for m in ms}
        lines = [json.loads(x) for x in
                 open(os.path.join(state_dir, "backtest.jsonl")).read().splitlines()]
        if ([x["day"] for x in lines] != list(DAILY_DAYS[1:]) or set(lines[0]) != keys
                or not all(np.isfinite(v) for k, v in lines[0].items() if k != "day")):
            raise AssertionError(f"staytime backtest.jsonl: {lines}")
        out["staytime"]["backtest"] = lines
        dump = [x.split("\t") for x in open(pred).read().splitlines()]
        if len(dump) != n or len({r[0] for r in dump}) != n or not all(
                len(r) == 4 and all(np.isfinite(float(v)) for v in r[1:]) for r in dump):
            raise AssertionError(f"staytime dump: {len(dump)} lines, first {dump[:2]}")

        # the checkpoint: the last one equals the returned state; a save and
        # a restore timed
        ckpt = os.path.join(state_dir, "ckpt")
        target = create_train_state(bundle, seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = restore_checkpoint(ckpt, target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        _assert_same_state(restored, state, "staytime checkpoint")
        del target
        t0 = time.perf_counter()
        saved = save_checkpoint(os.path.join(tmp, "timed"), state)
        save_s = time.perf_counter() - t0
        out["checkpoint"] = {"bytes": os.path.getsize(os.path.join(saved, "state.pt")),
                             "save_s": save_s, "restore_s": restore_s}
        shutil.rmtree(os.path.join(tmp, "timed"))
        del state

        # one day of finish through the ctr parse and K8
        fdata = os.path.join(tmp, "finish")
        fslots = [str(s) for s in range(3000, 3040)]
        _daily_records(fdata, DAILY_DAYS[0], _finish_record(fslots, DAILY_DAYS[0]), seed=130)
        fstate_dir = os.path.join(tmp, "finish_state")
        fpred = os.path.join(tmp, "finish_pred.tsv")
        fstate, counts, fwall = _daily_run(
            "finish", fdata, fstate_dir, DAILY_DAYS[:1],
            ["--backtest", "--evict-min-show", "1", "--predict-out", fpred],
            FINISH_DAILY_LAUNCHES, recorder)
        add(counts)
        fstep_ms = recorder.times_ms()[len(step_ms):]
        fbundle = create_model("finish", device="cuda")
        _assert_same_state(restore_checkpoint(os.path.join(fstate_dir, "ckpt"),
                                              create_train_state(fbundle, seed=0)),
                           fstate, "finish checkpoint")
        fdump = open(fpred).read().splitlines()
        if len(fdump) != n:
            raise AssertionError(f"finish dump: {len(fdump)} lines")
        out["finish"] = {"launches": counts, "wall_s": fwall, "step_ms": fstep_ms,
                         "train_examples_per_s": DAILY_BATCH / float(np.median(fstep_ms)) * 1e3}
        del fstate, fbundle
        harness.make_train_step = real_make

        # the server's main serves the staytime checkpoint
        rows = staytime_rows(np.random.default_rng(12), 200, slots,
                             cpu_bundle.config.seq_slots)
        torch.cuda.synchronize()
        reset_launch_counts()
        health, scored = serve_main(["--model", "staytime", "--checkpoint", ckpt], rows)
        torch.cuda.synchronize()
        counts = launch_counts()
        add(counts)
        if health != {"status": "ok", "model": "staytime", "step": restored.step}:
            raise AssertionError(f"server: healthz {health}")
        want = ScoringService(bundle, restored, max_batch=256).score(rows)
        check_staytime_scores(scored["scores"], 200)
        for task in want:
            np.testing.assert_allclose(scored["scores"][task], want[task], **SCORE_TOL,
                                       err_msg=f"served {task}")
        out["serving"] = {"launches": counts, "healthz": health}

        # the same checkpoint on the CPU
        cpu_state = restore_checkpoint(ckpt, create_train_state(cpu_bundle, seed=0))
        batch, dense, _, _ = synthetic_batch(cpu_bundle, DAILY_PREDICT_BATCH, seed=13)
        cpu_out = make_predict_step(cpu_bundle)(cpu_state, batch, dense)
        card_out = make_predict_step(bundle)(restored, {k: v.to(bundle.device) for k, v in
                                                        batch.items()}, dense)
        for task, v in cpu_out.items():
            np.testing.assert_allclose(card_out[task].cpu().numpy(), v.numpy(), **SCORE_TOL,
                                       err_msg=f"CPU restore {task}")
        if not np.isfinite(card_out[T_STAY].cpu().numpy()).all():
            raise AssertionError("card predictions not finite")
    finally:
        harness.make_train_step = real_make
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    return out


# -- phase 13: bf16 tables and moments; the classic sparse updates ----------
BF16_TRAIN_BATCH = {"staytime": STAYTIME_BATCH, "autoint": BIG_BATCH, "ctr": CTR_BATCH}
CLASSIC_BUCKET = 4001             # autoint's tables off both packings: no storage packs


def _table_bytes(state):
    """Bytes of w and of each of the sparse optimizer's fields and show,
    summed over a state's tables."""
    out = {}
    for t in state.tables.values():
        for name, x in [("w", t["w"]), *t["opt"].items(), ("show", t["show"])]:
            out[name] = out.get(name, 0) + x.numel() * x.element_size()
    return out


def hold_bf16_to_cpu(bundle, cpu_bundle, b, ipf, what):
    """Two card steps over bf16 tables held to the CPU, each from one state
    on both sides: the first from the seeded state, the second from the
    CPU's state after the first (an entry the two round to neighbouring
    bf16 values would set every later step of its samples apart by more
    than rounding).  Each step is one ``witness`` draw at batch seed
    ``CHECK_SEEDS[0]``: its entries past a ``TRAIN_*`` tolerance explained
    (a bf16 entry one rounding apart is one whose gradients agree within
    rounding), the card's updates replayed on the CPU in float32 and its
    bf16 entries held to the replay by the bf16 rule.  Returns the draws."""
    draws, init = [], None
    for i in range(2):
        w = witness(bundle, cpu_bundle, b, ipf, CHECK_SEEDS[0], steps=1, init=init, first=i,
                    keep_state=True)
        init = w.pop("cpu_state")
        draws.append(w)
        log(f"{what} bf16 train card vs cpu, B {b}, step {i + 1}:", json.dumps(w))
        if w["unexplained"]:
            raise AssertionError(f"{what} bf16, step {i + 1}: the card's step differs from "
                                 f"the CPU's where nothing explains it: {w['unexplained'][:20]}")
    return draws


def _bf16_train_windows(bundle, ipfs, want, seed):
    """A counted window of ``TRAIN_STEPS`` steps for each ``ipfs``, each from
    a fresh state, its launches a step held to ``want[ipf]`` (the float32
    model's), its losses finite; the share of the live rows' stored w
    entries that the first step changed (a bf16 entry keeps its value where
    its update is below half its ulp); the 5-id window timed.  Returns
    (per-ipf results, the launches, the 5-id window's state and batch)."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.train import make_train_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    step = make_train_step(bundle)
    b = BF16_TRAIN_BATCH[bundle.name]
    out, launches = {}, {}
    for ipf in ipfs:
        batch, dense, labels, weight = synthetic_batch(bundle, b, seed=seed + ipf,
                                                       ids_per_feature=ipf)
        state = create_train_state(bundle, seed=seed)
        w0 = {k: t["w"].clone() for k, t in state.tables.items()}
        torch.cuda.synchronize()
        reset_launch_counts()
        infos = []
        for i in range(TRAIN_STEPS):
            state, info = step(state, batch, labels, weight, dense, seed=i)
            infos.append(info)
            if i == 0:
                w1 = {k: t["w"].clone() for k, t in state.tables.items()}
        torch.cuda.synchronize()
        counts = launch_counts()
        live = bundle.embedding.row_counts(batch)
        entries = sum(int((live[k] > 0).sum()) * w0[k].shape[1] for k in w0)
        moved = sum(int((w1[k] != w0[k]).sum()) for k in w0)
        del w0, w1
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        per_step = {k: v / TRAIN_STEPS for k, v in counts.items() if v}
        if per_step != {k: v for k, v in want[ipf].items() if v}:
            raise AssertionError(f"{bundle.name} bf16, {ipf} ids: launches a step {per_step}, "
                                 f"the float32 model's {want[ipf]}")
        losses = [float(i["loss"]) for i in infos]
        if not np.isfinite(losses).all():
            raise AssertionError(f"{bundle.name} bf16, {ipf} ids: losses {losses}")
        out[f"ids{ipf}"] = {"launches_per_step": per_step, "losses": losses, "batch": b,
                            "w_live_entries": entries, "w_moved_step1": moved}
        if ipf == 5:
            ms, windows = train_ms(step, state, batch, labels, weight, dense, per_window=5)
            out["ids5"].update({"metric": f"torch_{bundle.name}_bf16_train_examples_per_sec",
                                "unit": "examples/s", "value": b / ms * 1e3,
                                "ms_per_step": ms, "window_ms": windows})
            kept = state, batch
        log(f"{bundle.name} bf16 train, {ipf} ids:", json.dumps(out[f"ids{ipf}"]))
    return (out, launches, *kept)


def _count(fn):
    """``fn()``'s launches, between a synchronize before and after."""
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, launch_counts()


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def serve_main(argv, rows):
    """``serving.server.main(argv)`` on a free local port (``--port``
    added) in a thread: its ``/healthz`` and its reply to ``rows`` POSTed to
    ``/score``, then the server shut down."""
    from recommendsystem_tpu_torch.serving import server

    started, ready = {}, threading.Event()
    real_serve = server.serve

    def serve(service, port=8000, host="127.0.0.1"):
        started["httpd"] = real_serve(service, port, host)
        ready.set()
        return started["httpd"]

    server.serve = serve
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    thread = threading.Thread(target=server.main, args=(argv + ["--port", str(port)],),
                              daemon=True)
    thread.start()
    try:
        if not ready.wait(300):
            raise AssertionError("the server did not start")
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        req = urllib.request.Request(f"{base}/score", data=json.dumps({"rows": rows}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            scored = json.loads(r.read())
    finally:
        server.serve = real_serve
        if "httpd" in started:
            started["httpd"].shutdown()
            started["httpd"].server_close()
        thread.join(60)
    if thread.is_alive():
        raise AssertionError("the server did not stop")
    return health, scored


def classic_paths(card):
    """One train step of each classic sparse update on the card, held to the
    same step on the CPU (``witness``, B = 64, batch seed
    ``CHECK_SEEDS[0]``), autoint at 2,048-id buckets: ``sparse_update=
    "scatter"``; ``"dense"``; the packed step over an engine built with
    ``packed=False`` at ``CLASSIC_BUCKET`` (no storage packs: the step's
    in-step classic gather and scatter); the touched-rows update
    (``row_update_min_rows = 0``).  Each in its own window of counts: the
    classic updates launch no K1-K4 or K8 (the tower's K5f and K5b still
    run); the touched-rows update folds by K1 and launches no K3 or K8."""
    from recommendsystem_tpu_torch.embedding import EmbeddingFeatures, packed
    from recommendsystem_tpu_torch.models import create_model

    def pair(bucket, **engine_kw):
        out = []
        for dev in ("cuda", "cpu"):
            bnd = create_model("autoint", bucket_size=bucket, device=dev)
            if engine_kw:
                eng = bnd.embedding
                bnd.embedding = EmbeddingFeatures(list(eng.columns.values()), eng.sparse_opt,
                                                  group_tables=True,
                                                  max_group_bytes=eng.max_group_bytes,
                                                  **engine_kw)
            out.append(bnd)
        return out

    sparse = ("fold_mean", "fold_rows", "unfold_mean", "unfold_rows", "sparse_adam_update")
    unpacked = pair(CLASSIC_BUCKET, packed=False)
    if packed.storages_packed(unpacked[0].embedding)[0]:
        raise AssertionError("classic paths: a storage of the packed=False engine packs")
    rows_mode = pair(ROUGH_CHECK_BUCKET)
    for bnd in rows_mode:
        bnd.embedding.row_update_min_rows = 0
    cases = (("scatter", pair(ROUGH_CHECK_BUCKET), "scatter", dict.fromkeys(sparse, 0)),
             ("dense", pair(ROUGH_CHECK_BUCKET), "dense", dict.fromkeys(sparse, 0)),
             ("packed, packed=False", unpacked, "packed", dict.fromkeys(sparse, 0)),
             ("touched rows", rows_mode, "packed",
              {"unfold_mean": 0, "unfold_rows": 0, "sparse_adam_update": 0}))
    out, launches = {}, {}
    for name, (gb, cb), update, want in cases:
        w, counts = _count(lambda: witness(gb, cb, TOWER_CHECK_BATCH, 5, CHECK_SEEDS[0],
                                           steps=1, sparse_update=update))
        _add(launches, counts)
        log(f"classic path {name}, card vs cpu:", json.dumps(w), json.dumps(counts))
        if w["unexplained"]:
            raise AssertionError(f"classic path {name}: the card's step differs from the "
                                 f"CPU's where nothing explains it: {w['unexplained'][:20]}")
        wrong = {k: counts[k] for k, v in want.items() if counts[k] != v}
        if wrong or counts["field_attention_bwd"] < 1 or (
                name == "touched rows" and counts["fold_mean"] < 1):
            raise AssertionError(f"classic path {name}: launches {counts}")
        out[name] = {"margins": w["margins"], "explained": w["explained"],
                     "launches": {k: v for k, v in counts.items() if v}}
    return out, launches


def bf16_path(card, cycles_per_ms, autoint_launches):
    """Phase 13: storage precision at full width.  Staytime with
    ``table_dtype="auto"`` (all 46 storages of 32-wide rows in bf16, sparse
    AdaGrad): serving through ``score()`` and over HTTP held to the CPU,
    its predict step's launches a call; two counted train windows (5 ids
    and 1, B = 16384) held to ``STAYTIME_TRAIN_LAUNCHES``; ``evaluate`` held
    to ``EVAL_LAUNCHES``; K1, K2, K7 and K9 at its shapes over the bf16
    tables with bounds on bf16 bytes; two card steps held to the CPU at
    2,048-id buckets (``hold_bf16_to_cpu``).  Autoint with bf16 tables and
    bf16 moments (24 x 265,104 x 8): two counted train windows (B = 65536)
    held to the float32 model's launches a step (``autoint_launches``,
    phase 5's), serving held to the CPU, K8 (bf16 w with bf16 moments and
    with float32 ones), K1 and K2 at its shapes, two card steps held to the
    CPU.  Then the classic sparse updates (``classic_paths``) and the
    server's ``main --table-dtype auto``."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.autoint import TASK
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
    from recommendsystem_tpu_torch.serving import ScoringService
    from recommendsystem_tpu_torch.train import evaluate, make_predict_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    out = {"card": card, "tables": {}, "train": {}}
    launches, cases = {}, []

    # -- staytime, table_dtype="auto" --------------------------------------
    st = create_model("staytime", table_dtype="auto", device="cuda")
    st_cpu = create_model("staytime", table_dtype="auto", device="cpu")
    if {t for t in (st.embedding.storage_dtype(d) for _, d in st.embedding.storage.values())} \
            != {torch.bfloat16}:
        raise AssertionError("staytime auto: a storage is not bf16")
    state = create_train_state(st, seed=0)
    out["tables"]["staytime_auto"] = {
        **_table_bytes(state), "w_fp32": sum(r * d * 4 for r, d in st.embedding.storage.values()),
        "storages": len(st.embedding.storage),
        "rows": sum(r for r, _ in st.embedding.storage.values())}
    cfg = StaytimeConfig()
    rows200 = staytime_rows(np.random.default_rng(13), 200, cfg.slots, cfg.seq_slots)

    def serve_staytime():
        svc = ScoringService(st, state, max_batch=256, ids_per_feature=5)
        svc.warmup()
        return svc.score(rows200), http_score(svc, rows200[:50])

    (s200, over_http), counts = _count(serve_staytime)
    _add(launches, counts)
    check_staytime_scores(s200, 200)
    assert_heads_close(over_http["scores"], {k: v[:50] for k, v in s200.items()}, "over HTTP")
    cpu_state = _cpu_state(state)
    assert_heads_close(s200, ScoringService(st_cpu, cpu_state, max_batch=256, ids_per_feature=5,
                                            device="cpu").score(rows200), "bf16 card vs CPU")
    per_call = {}
    step = make_predict_step(st)
    for ipf, want in ((5, EVAL_LAUNCHES["staytime5"]), (1, EVAL_LAUNCHES["staytime1"])):
        batch = synthetic_batch(st, 256, seed=14, ids_per_feature=ipf)[0]
        pred, counts = _count(lambda: step(state, batch))
        _add(launches, counts)
        per_call[f"ids{ipf}"] = {k: v for k, v in counts.items() if v}
        if per_call[f"ids{ipf}"] != want:
            raise AssertionError(f"staytime bf16 predict, {ipf} ids: {per_call[f'ids{ipf}']}")
    cpu_pred = make_predict_step(st_cpu)(cpu_state, {k: v.to("cpu") for k, v in batch.items()})
    assert_heads_close({k: v.squeeze(1).cpu().numpy() for k, v in pred.items()},
                       {k: v.squeeze(1).numpy() for k, v in cpu_pred.items()},
                       "bf16 predict, card vs CPU")
    out["staytime_serve"] = {"launches": {k: v for k, v in launches.items() if v},
                             "predict_launches_per_call": per_call}
    del cpu_state, cpu_pred

    res, counts, tstate, batch5 = _bf16_train_windows(st, (5, 1), STAYTIME_TRAIN_LAUNCHES, 90)
    _add(launches, counts)
    out["train"]["staytime_auto"] = res
    eval_data = [synthetic_batch(st, STAYTIME_BATCH, seed=70 + i) for i in range(EVAL_BATCHES)]
    values, counts = _count(lambda: evaluate(st, eval_data, tstate))
    _add(launches, counts)
    per_step = {k: v / EVAL_BATCHES for k, v in counts.items() if v}
    if per_step != EVAL_LAUNCHES["staytime5"]:
        raise AssertionError(f"staytime bf16 eval: launches a step {per_step}")
    _check_metric_values(values, "staytime bf16 evaluate")
    out["staytime_eval"] = {"launches_per_step": per_step, "batch": STAYTIME_BATCH}
    del eval_data

    # its kernels over the bf16 tables, as its steps launch them
    b = STAYTIME_BATCH
    st_cases = [staytime_fold_case(st, tstate, cycles_per_ms),
                *staytime_rows_cases(st, tstate, cycles_per_ms),
                din_gather_case(st, tstate, b, 62, cycles_per_ms),
                adagrad_case(st.embedding, tstate.tables, batch5, cycles_per_ms)]
    for c in st_cases:
        c.update(model="staytime auto", b=c.get("b", b))
    cases += st_cases
    del tstate, batch5, state
    torch.cuda.empty_cache()
    small = {"cfg": StaytimeConfig(bucket_size=STAYTIME_CHECK_BUCKET), "table_dtype": "auto"}
    out["staytime_card_vs_cpu"] = hold_bf16_to_cpu(
        create_model("staytime", device="cuda", **small),
        create_model("staytime", device="cpu", **small), TOWER_CHECK_BATCH, 5, "staytime auto")
    del st, st_cpu
    torch.cuda.empty_cache()

    # -- autoint, bf16 tables and bf16 moments ------------------------------
    bf16 = dict(table_dtype=torch.bfloat16, opt_state_dtype=torch.bfloat16)
    ai = create_model("autoint", bucket_size=FULL_BUCKET, device="cuda", **bf16)
    want = {int(k.removeprefix("ids")): v for k, v in autoint_launches.items()}
    res, counts, astate, _ = _bf16_train_windows(ai, (5, 1), want, 80)
    _add(launches, counts)
    out["train"]["autoint_bf16"] = res
    out["tables"]["autoint_bf16"] = {
        **_table_bytes(astate),
        "w_fp32": sum(r * d * 4 for r, d in ai.embedding.storage.values()),
        "storages": len(ai.embedding.storage),
        "rows": sum(r for r, _ in ai.embedding.storage.values())}
    rng = np.random.default_rng(15)
    rows = raw_rows(rng, 200, 5)

    def serve_autoint():
        svc = ScoringService(ai, astate, max_batch=256, ids_per_feature=5)
        svc.warmup()
        return svc.score(rows)[TASK]

    scores, counts = _count(serve_autoint)
    _add(launches, counts)
    if counts["fold_mean"] < 1 or counts["interacting_attention"] < 1:
        raise AssertionError(f"autoint bf16 serving: launches {counts}")
    check_scores(scores, 200)
    ai_cpu = create_model("autoint", bucket_size=FULL_BUCKET, device="cpu", **bf16)
    np.testing.assert_allclose(scores, ScoringService(
        ai_cpu, _cpu_state(astate), max_batch=256, ids_per_feature=5,
        device="cpu").score(rows)[TASK], **SCORE_TOL)
    out["autoint_serve"] = {"launches": {k: v for k, v in counts.items() if v}}
    del ai_cpu
    # K8 over bf16 moments and over float32 ones; K1 and K2 at the train batch
    f32_moments = {k: {**t, "opt": {**t["opt"], "m": t["opt"]["m"].float(),
                                    "v": t["opt"]["v"].float()}}
                   for k, t in astate.tables.items()}
    abatch = synthetic_batch(ai, BIG_BATCH, seed=5)[0]      # phase 2's K8 batch
    ai_cases = [adam_case(ai.embedding, astate.tables, abatch, cycles_per_ms)]
    # the plain version keeps the moments' type by the optimizer's state_dtype
    real_opt = ai.embedding.sparse_opt
    ai.embedding.sparse_opt = dataclasses.replace(real_opt, state_dtype=torch.float32)
    try:
        ai_cases.append(adam_case(ai.embedding, f32_moments, abatch, cycles_per_ms))
    finally:
        ai.embedding.sparse_opt = real_opt
    del f32_moments
    ai_cases += [fold_group_case(ai, astate, BIG_BATCH, cycles_per_ms),
                 autoint_rows_case(ai, astate, BIG_BATCH, cycles_per_ms)]
    for c in ai_cases:
        c["model"] = "autoint bf16"
    cases += ai_cases
    del astate, abatch, ai
    torch.cuda.empty_cache()
    small = dict(bucket_size=ROUGH_CHECK_BUCKET, **bf16)
    out["autoint_card_vs_cpu"] = hold_bf16_to_cpu(
        create_model("autoint", device="cuda", **small),
        create_model("autoint", device="cpu", **small), TOWER_CHECK_BATCH, 5, "autoint bf16")

    # -- the classic sparse updates; the server's --table-dtype ------------
    out["classic"], counts = classic_paths(card)
    _add(launches, counts)
    served, counts = _count(lambda: serve_main(
        ["--model", "staytime", "--table-dtype", "auto"], rows200))
    _add(launches, counts)
    health, scored = served
    if health != {"status": "ok", "model": "staytime", "step": 0}:
        raise AssertionError(f"server --table-dtype auto: healthz {health}")
    check_staytime_scores(scored["scores"], 200)
    assert_heads_close(scored["scores"], s200, "server --table-dtype auto")
    out["server"] = {"launches": {k: v for k, v in counts.items() if v}}
    for c in cases:
        log(json.dumps(c))
    out["cases"] = cases
    out["launches"] = launches
    return out


# -- phase 14: the bf16 compute policy ---------------------------------------
# the CPU tests' bf16 tolerances (tests/test_torch_bf16_compute.py): outputs
# of a bf16 tower (bf16 roundings of intermediates that may fall on either
# side of a midpoint), losses, and each dense gradient's relative L2 error
POLICY_OUT_TOL = dict(rtol=2e-2, atol=5e-3)
POLICY_LOSS_RTOL = 1e-2
POLICY_GRAD_REL_L2 = 2e-2
POLICY_ZERO_GRAD = 1e-6           # a gradient of 0 in exact arithmetic (DIN b2)


def _assert_policy_close(got, want, what):
    """Heads (dicts of arrays) within ``POLICY_OUT_TOL``."""
    for task in want:
        np.testing.assert_allclose(np.asarray(got[task]), np.asarray(want[task]),
                                   **POLICY_OUT_TOL, err_msg=f"{what} {task}")


def _policy_loss_and_grads(bundle, state, batch, labels, weight, dense, seed):
    """The training loss and every dense gradient of one bf16-policy step
    (the step's own loss function, on the classic lookup), on the CPU."""
    from recommendsystem_tpu_torch.nn import regularized_kernels
    from recommendsystem_tpu_torch.train import step as step_mod

    eng = bundle.embedding
    embs = eng.lookup(eng.weights(state.tables), batch)
    params = {k: p.detach().requires_grad_() for k, p in state.params.items()}
    loss, _ = step_mod._model_outputs_and_loss(bundle, params, embs, labels, weight, dense,
                                               True, seed, regularized_kernels(bundle.module))
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), {k: g.detach().float().cpu() for k, g in zip(params, grads)}


def hold_policy_to_cpu(name, kw, seed=CHECK_SEEDS[0]):
    """The bf16 policy's training loss and dense gradients on the card held
    to the CPU plain path of the same policy, from one seeded state, at B =
    ``TOWER_CHECK_BATCH`` and the step's dropout: the loss within
    ``POLICY_LOSS_RTOL`` and each gradient's relative L2 error within
    ``POLICY_GRAD_REL_L2`` (the DIN scorer's b2, whose gradient is 0 in
    exact arithmetic, and parameters outside the graph, below
    ``POLICY_ZERO_GRAD`` of the largest gradient on both sides); then one
    packed train step on each side, its losses held the same way."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import make_train_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    gb = create_model(name, compute_dtype=torch.bfloat16, device="cuda", **kw)
    cb = create_model(name, compute_dtype=torch.bfloat16, device="cpu", **kw)
    gstate = create_train_state(gb, seed=3)
    cstate = dataclasses.replace(gstate, params=_to(gstate.params, "cpu"),
                                 opt_state=_to(gstate.opt_state, "cpu"),
                                 tables=_to(gstate.tables, "cpu"))
    batch, dense, labels, weight = synthetic_batch(cb, TOWER_CHECK_BATCH, seed=seed)
    gbatch = {k: v.to("cuda") for k, v in batch.items()}
    gdense, glabels, gweight = (None if x is None else _to(x, "cuda")
                                for x in (dense, labels, weight))
    gloss, ggrads = _policy_loss_and_grads(gb, gstate, gbatch, glabels, gweight, gdense, 7)
    closs, cgrads = _policy_loss_and_grads(cb, cstate, batch, labels, weight, dense, 7)
    if not abs(gloss - closs) <= POLICY_LOSS_RTOL * abs(closs):
        raise AssertionError(f"{name} bf16 policy: loss {gloss} on the card, {closs} on the CPU")
    scale = max(float(g.norm()) for g in cgrads.values())
    worst, worst_key = 0.0, None
    for k, cg in cgrads.items():
        gg = ggrads[k]
        zero = (k.startswith("din_") and k.endswith(".b2")) or not bool(cg.any())
        if zero:
            if max(float(gg.norm()), float(cg.norm())) > POLICY_ZERO_GRAD * scale:
                raise AssertionError(f"{name} bf16 policy {k}: gradient norms {float(gg.norm())}, "
                                     f"{float(cg.norm())}, expected 0 up to rounding")
            continue
        err = float((gg - cg).norm() / cg.norm())
        if err >= worst:
            worst, worst_key = err, k
        if err > POLICY_GRAD_REL_L2:
            raise AssertionError(f"{name} bf16 policy {k}: gradient relative L2 error {err}")
    gs, ginfo = make_train_step(gb)(gstate, gbatch, glabels, gweight, gdense, seed=7)
    cs, cinfo = make_train_step(cb)(cstate, batch, labels, weight, dense, seed=7)
    step_loss = (float(ginfo["loss"]), float(cinfo["loss"]))
    if not abs(step_loss[0] - step_loss[1]) <= POLICY_LOSS_RTOL * abs(step_loss[1]):
        raise AssertionError(f"{name} bf16 policy step: losses {step_loss}")
    if {p.dtype for p in gs.params.values()} != {torch.float32}:
        raise AssertionError(f"{name} bf16 policy: a master param is not float32")
    return {"loss": [gloss, closs], "step_loss": list(step_loss),
            "worst_grad_rel_l2": worst, "worst_grad": worst_key, "batch": TOWER_CHECK_BATCH}


def _policy_pair_ms(bundle, b, ipf, seed):
    """Train-step ms of ``bundle`` under float32 and under its bf16 policy,
    in turns (float32, bf16, bf16, float32) on one batch and state."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.train import make_train_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    f32 = dataclasses.replace(bundle, compute_dtype=torch.float32)
    batch, dense, labels, weight = synthetic_batch(bundle, b, seed=seed, ids_per_feature=ipf)
    state = create_train_state(bundle, seed=seed)
    steps = {"fp32": make_train_step(f32), "bf16": make_train_step(bundle)}
    ms = {"fp32": [], "bf16": []}
    for kind in ("fp32", "bf16", "bf16", "fp32"):
        ms[kind].append(train_ms(steps[kind], state, batch, labels, weight, dense,
                                 per_window=5)[0])
    return {k: {"ms_per_step": v, "examples_per_s": [b / x * 1e3 for x in v]}
            for k, v in ms.items()}


def _policy_predict_ms(bundle, state, b, seed, iters=10):
    """Predict-call ms under float32 and the bf16 policy in turns, host
    clock, windows ending in a synchronize."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.train import make_predict_step

    batch, dense, _, _ = synthetic_batch(bundle, b, seed=seed)
    steps = {"fp32": make_predict_step(dataclasses.replace(bundle, compute_dtype=torch.float32)),
             "bf16": make_predict_step(bundle)}
    ms = {"fp32": [], "bf16": []}
    for kind in ("fp32", "bf16", "bf16", "fp32"):
        steps[kind](state, batch, dense)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            steps[kind](state, batch, dense)
        torch.cuda.synchronize()
        ms[kind].append((time.perf_counter() - t0) / iters * 1e3)
    return {k: {"ms_per_call": v, "examples_per_s": [b / x * 1e3 for x in v]}
            for k, v in ms.items()}


def bf16_compute_path(card, cycles_per_ms, want):
    """Phase 14: the bf16 compute policy at full width.  K6, K5f (dropout
    0.2), K5b and both K7 entries (over a float32 and a bf16 table) on bf16
    inputs against their plain versions, timed with bounds on bf16 bytes
    beside the float32 kernel.  Autoint under the policy: served (K6 on
    bf16) and held to the CPU plain path of the same policy, its predict
    call's and ``evaluate``'s launches, a counted train window at B = 65536
    (K5f and K5b on bf16) held to the float32 model's launches a step
    (``want``), predict and train ms against float32 in turns.  Ctr (B =
    32768) and staytime (B = 16384, K7 on given bf16 facts) the same way in
    training; staytime's predict call (the gathering K7 rounding a float32
    table) held to the CPU; staytime ``"auto"`` under the policy served,
    held to the CPU and evaluated.  Each training model's loss and dense
    gradients held to the CPU's (``hold_policy_to_cpu``).  Then the
    server's ``main --compute-dtype bf16 --table-dtype auto`` and one day of
    ``daily.main --compute-dtype bf16`` (finish)."""
    import shutil
    import tempfile

    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.autoint import TASK
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
    from recommendsystem_tpu_torch.serving import ScoringService
    from recommendsystem_tpu_torch.train import evaluate, harness, make_predict_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    bf16 = torch.bfloat16
    out = {"card": card, "train": {}, "predict": {}, "card_vs_cpu": {}}
    launches = {}
    cases = [interacting_case(24, BIG_BATCH, 141, cycles_per_ms, dtype=bf16),
             attention_case(2, 4, 24, BIG_BATCH, 142, cycles_per_ms, rate=DROPOUT, dtype=bf16),
             attention_bwd_case(2, 4, 24, BIG_BATCH, 143, cycles_per_ms, dtype=bf16),
             din_case(STAYTIME_BATCH, 144, cycles_per_ms, dtype=bf16)]

    # -- autoint: served, evaluated, trained ---------------------------------
    ai = create_model("autoint", bucket_size=FULL_BUCKET, compute_dtype=bf16, device="cuda")
    astate = create_train_state(ai, seed=0)
    rows = raw_rows(np.random.default_rng(16), 200, 5)

    def serve_autoint():
        svc = ScoringService(ai, astate, max_batch=256, ids_per_feature=5)
        svc.warmup()
        return (np.asarray(svc.score(rows)[TASK]),
                np.asarray(http_score(svc, rows[:50])["scores"][TASK]))

    (scores, over_http), counts = _count(serve_autoint)
    _add(launches, counts)
    if counts["fold_mean"] < 1 or counts["interacting_attention"] < 1:
        raise AssertionError(f"autoint bf16 policy serving: launches {counts}")
    check_scores(scores, 200)
    np.testing.assert_allclose(over_http, scores[:50], **SCORE_TOL)
    ai_cpu = create_model("autoint", bucket_size=FULL_BUCKET, compute_dtype=bf16, device="cpu")
    cpu_scores = np.asarray(ScoringService(ai_cpu, _cpu_state(astate), max_batch=256,
                                           ids_per_feature=5, device="cpu").score(rows)[TASK])
    np.testing.assert_allclose(scores, cpu_scores, **POLICY_OUT_TOL)
    f32_scores = np.asarray(ScoringService(dataclasses.replace(ai, compute_dtype=torch.float32),
                                           astate, max_batch=256,
                                           ids_per_feature=5).score(rows)[TASK])
    out["autoint_serve"] = {
        "launches": {k: v for k, v in counts.items() if v},
        "max_abs_gap_to_cpu": float(np.abs(scores - cpu_scores).max()),
        "max_abs_gap_to_fp32": float(np.abs(scores - f32_scores).max())}
    del ai_cpu
    step = make_predict_step(ai)
    batch = synthetic_batch(ai, 256, seed=17)[0]
    _, counts = _count(lambda: step(astate, batch))
    _add(launches, counts)
    if {k: v for k, v in counts.items() if v} != EVAL_LAUNCHES["k6"]:
        raise AssertionError(f"autoint bf16 policy predict: launches {counts}")
    eval_data = [synthetic_batch(ai, BIG_BATCH, seed=170 + i) for i in range(EVAL_BATCHES)]
    values, counts = _count(lambda: evaluate(ai, eval_data, astate))
    _add(launches, counts)
    if {k: v / EVAL_BATCHES for k, v in counts.items() if v} != EVAL_LAUNCHES["k6"]:
        raise AssertionError(f"autoint bf16 policy eval: launches {counts}")
    _check_metric_values(values, "autoint bf16 policy evaluate")
    del eval_data
    out["predict"]["autoint"] = _policy_predict_ms(ai, astate, BIG_BATCH, 18)
    res, counts, _, _ = _bf16_train_windows(ai, (5,), {5: want["autoint"]}, 81)
    _add(launches, counts)
    out["train"]["autoint"] = {**res["ids5"], "in_turns": _policy_pair_ms(ai, BIG_BATCH, 5, 82)}
    del astate, ai
    torch.cuda.empty_cache()

    # -- ctr: trained ---------------------------------------------------------
    ctr = create_model("ctr", compute_dtype=bf16, device="cuda")
    res, counts, _, _ = _bf16_train_windows(ctr, (5,), {5: want["ctr"]}, 83)
    _add(launches, counts)
    out["train"]["ctr"] = {**res["ids5"], "in_turns": _policy_pair_ms(ctr, CTR_BATCH, 5, 84)}
    del ctr
    torch.cuda.empty_cache()

    # -- staytime, float32 tables: predict (the gathering K7 rounding the
    # float32 facts) held to the CPU; trained (K7 on given bf16 facts) -------
    st = create_model("staytime", compute_dtype=bf16, device="cuda")
    sstate = create_train_state(st, seed=0)
    st_cpu = create_model("staytime", compute_dtype=bf16, device="cpu")
    step = make_predict_step(st)
    batch = synthetic_batch(st, 256, seed=19, ids_per_feature=5)[0]
    pred, counts = _count(lambda: step(sstate, batch))
    _add(launches, counts)
    if {k: v for k, v in counts.items() if v} != EVAL_LAUNCHES["staytime5"]:
        raise AssertionError(f"staytime bf16 policy predict: launches {counts}")
    cpu_pred = make_predict_step(st_cpu)(_cpu_state(sstate),
                                         {k: v.to("cpu") for k, v in batch.items()})
    _assert_policy_close({k: v.squeeze(1).cpu().numpy() for k, v in pred.items()},
                         {k: v.squeeze(1).numpy() for k, v in cpu_pred.items()},
                         "staytime bf16 policy predict, card vs CPU")
    del st_cpu, cpu_pred
    cases.append(din_gather_case(st, sstate, STAYTIME_BATCH, 145, cycles_per_ms,
                                 facts_dtype=bf16))
    out["predict"]["staytime"] = _policy_predict_ms(st, sstate, STAYTIME_BATCH, 20)
    del sstate
    res, counts, _, _ = _bf16_train_windows(st, (5,), STAYTIME_TRAIN_LAUNCHES, 85)
    _add(launches, counts)
    out["train"]["staytime"] = {**res["ids5"],
                                "in_turns": _policy_pair_ms(st, STAYTIME_BATCH, 5, 86)}
    del st
    torch.cuda.empty_cache()

    # -- staytime "auto" under the policy: served, held to the CPU, evaluated
    sta = create_model("staytime", table_dtype="auto", compute_dtype=bf16, device="cuda")
    astate = create_train_state(sta, seed=0)
    cfg = StaytimeConfig()
    rows200 = staytime_rows(np.random.default_rng(21), 200, cfg.slots, cfg.seq_slots)

    def serve_staytime():
        svc = ScoringService(sta, astate, max_batch=256, ids_per_feature=5)
        svc.warmup()
        return svc.score(rows200), http_score(svc, rows200[:50])["scores"]

    (s200, over_http), counts = _count(serve_staytime)
    _add(launches, counts)
    if counts["din_pool"] < 1 or counts["fold_mean"] < 1:
        raise AssertionError(f"staytime auto bf16 policy serving: launches {counts}")
    check_staytime_scores(s200, 200)
    assert_heads_close(over_http, {k: v[:50] for k, v in s200.items()}, "over HTTP")
    sta_cpu = create_model("staytime", table_dtype="auto", compute_dtype=bf16, device="cpu")
    _assert_policy_close(s200, ScoringService(sta_cpu, _cpu_state(astate), max_batch=256,
                                              ids_per_feature=5, device="cpu").score(rows200),
                         "staytime auto bf16 policy, card vs CPU")
    del sta_cpu
    cases.append(din_gather_case(sta, astate, STAYTIME_BATCH, 146, cycles_per_ms,
                                 facts_dtype=bf16))
    eval_data = [synthetic_batch(sta, STAYTIME_BATCH, seed=171 + i) for i in range(EVAL_BATCHES)]
    values, counts = _count(lambda: evaluate(sta, eval_data, astate))
    _add(launches, counts)
    if {k: v / EVAL_BATCHES for k, v in counts.items() if v} != EVAL_LAUNCHES["staytime5"]:
        raise AssertionError(f"staytime auto bf16 policy eval: launches {counts}")
    _check_metric_values(values, "staytime auto bf16 policy evaluate")
    out["staytime_auto_serve"] = {"launches": {k: v for k, v in counts.items() if v}}
    del eval_data, astate, sta
    torch.cuda.empty_cache()

    # -- the card held to the CPU: loss and dense gradients -----------------
    small = {"autoint": {"bucket_size": ROUGH_CHECK_BUCKET},
             "ctr": {"bucket_size": ROUGH_CHECK_BUCKET},
             "staytime": {"cfg": StaytimeConfig(bucket_size=STAYTIME_CHECK_BUCKET)}}
    for name, kw in small.items():
        res, counts = _count(lambda: hold_policy_to_cpu(name, kw))
        _add(launches, counts)
        out["card_vs_cpu"][name] = res
        log(f"{name} bf16 policy card vs cpu:", json.dumps(res))

    # -- the command lines ----------------------------------------------------
    served, counts = _count(lambda: serve_main(
        ["--model", "staytime", "--table-dtype", "auto", "--compute-dtype", "bf16"], rows200))
    _add(launches, counts)
    health, scored = served
    if health != {"status": "ok", "model": "staytime", "step": 0}:
        raise AssertionError(f"server --compute-dtype bf16: healthz {health}")
    check_staytime_scores(scored["scores"], 200)
    assert_heads_close(scored["scores"], s200, "server --compute-dtype bf16")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_policy_")
    recorder = _StepRecorder()
    real_make = harness.make_train_step
    try:
        fdata = os.path.join(tmp, "finish")
        fslots = [str(s) for s in range(3000, 3040)]
        _daily_records(fdata, DAILY_DAYS[0], _finish_record(fslots, DAILY_DAYS[0]), seed=140)
        harness.make_train_step = recorder.wrap(real_make)
        fstate, counts, wall = _daily_run("finish", fdata, os.path.join(tmp, "finish_state"),
                                          DAILY_DAYS[:1], ["--compute-dtype", "bf16"],
                                          FINISH_DAILY_LAUNCHES, recorder)
        _add(launches, counts)
        if {p.dtype for p in fstate.params.values()} != {torch.float32}:
            raise AssertionError("daily --compute-dtype bf16: a master param is not float32")
        out["daily"] = {"wall_s": wall, "step_ms": recorder.times_ms(),
                        "launches": {k: v for k, v in counts.items() if v}}
    finally:
        harness.make_train_step = real_make
        shutil.rmtree(tmp, ignore_errors=True)
    for c in cases:
        log(json.dumps(c))
    out["cases"] = cases
    out["launches"] = launches
    return out


# -- phase 15: the serving export -------------------------------------------

EXPORT_BUCKET = 256
# the launches a call of each exported predict function makes, as the
# predict step makes them (5 ids a feature: one grouped K1; 1 id: one
# grouped K2; K6 on autoint, three gathering K7 on staytime)
EXPORT_LAUNCHES = {
    ("autoint", 5): {"fold_mean": 1, "interacting_attention": 1},
    ("staytime", 5): {"fold_mean": 1, "din_pool": 3},
    ("staytime", 1): {"fold_rows": 1, "din_pool": 3},
}
EXPORT_OP_NODES = {
    ("autoint", 5): {"fold_mean_group": 1, "interacting_attention": 1},
    ("staytime", 5): {"fold_mean_group": 1, "din_pool_gather": 3},
    ("staytime", 1): {"fold_rows_group": 1, "din_pool_gather": 3},
}
EXPORT_GATHERS = ("aten.index.Tensor", "aten.embedding.default", "aten.index_select.default",
                  "aten.gather.default", "aten.take.default")


def _op_nodes(program):
    """{op: nodes} of the port's custom ops in an exported program's graph."""
    from recommendsystem_tpu_torch.kernels import _ops

    counts = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith(_ops.NAMESPACE + "."):
            counts[target.split(".")[1]] = counts.get(target.split(".")[1], 0) + 1
    return counts


def _table_gathers(program):
    """The aten gathers of an exported graph that read a table input."""
    tables = {n for n in program.graph.nodes
              if n.op == "placeholder" and n.name.startswith("tables_w")}
    return [str(n) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target) in EXPORT_GATHERS
            and any(a in tables for a in n.args if isinstance(a, torch.fx.Node))]


def _turns_ms(calls, iters):
    """ms a call of each of ``calls`` ({name: fn}), in turns (a, b, b, a),
    host clock, each window of ``iters`` calls after one warm-up call and
    ending in a synchronize."""
    (a, fa), (b, fb) = calls.items()
    ms = {a: [], b: []}
    for name, fn in ((a, fa), (b, fb), (b, fb), (a, fa)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) / iters * 1e3)
    return ms


def _record_op_args(fn):
    """fn() with every custom-op call's arguments recorded: [(op, args)]."""
    from recommendsystem_tpu_torch.kernels import _ops

    real, seen = _ops.op, []

    def recording(name):
        def call(*args):
            seen.append((name, args))
            return real(name)(*args)
        return call

    _ops.op = recording
    try:
        fn()
    finally:
        _ops.op = real
    return seen


def _launcher(name, args):
    """The launcher an op's CUDA implementation calls, on the op's args."""
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.kernels import din, interacting

    if name == "fold_mean_group":
        return lambda: packed.fold_mean_launch(list(zip(*args)))
    if name == "fold_rows_group":
        return lambda: packed.fold_rows_launch(list(zip(*args)))
    if name == "din_pool_gather":
        q, table, ids, mask, lo, hi, *w, facts_dtype = args
        return lambda: din.din_pool_gather_launch(q, table, ids, mask, (lo, hi), *w,
                                                  facts_dtype)
    if name == "interacting_attention":
        x, *p, head_num, ln_eps = args
        return lambda: interacting.interacting_launch(
            x, dict(zip(interacting.PARAM_NAMES, p)), head_num, ln_eps)
    raise KeyError(name)


def dispatch_cost(predict, cycles_per_ms, iters=200):
    """Host µs a call of each custom op on one predict call's arguments,
    against its launcher called directly (the same kernel, no dispatch), in
    turns (op, launcher, launcher, op), under ``torch.inference_mode()``
    (as the predict step and the loaded program call them) and under
    ``torch.no_grad()`` (where the op's autograd layer checks each tensor);
    device µs of both as ``timed`` gives them."""
    from recommendsystem_tpu_torch.kernels import _ops

    out = {}
    for name, args in _record_op_args(predict):
        if name in out:
            continue
        op = lambda a=args, n=name: _ops.op(n)(*a)       # noqa: E731
        direct = _launcher(name, args)
        out[name] = {}
        for mode, ctx in (("inference_mode", torch.inference_mode),
                          ("no_grad", torch.no_grad)):
            host = {"op": [], "launcher": []}
            dev = {}
            with ctx():
                for kind, fn in (("op", op), ("launcher", direct), ("launcher", direct),
                                 ("op", op)):
                    d, h = timed(fn, iters, cycles_per_ms)
                    host[kind].append(h * 1e3)
                    dev[kind] = d * 1e3
            out[name][mode] = {"host_us": host, "device_us": dev, "dispatch_us": float(
                np.mean(host["op"]) - np.mean(host["launcher"]))}
    return out


def export_case(label, bundle, state, cpu_bundle, cpu_state, b, ipf, key, tmp, total,
                want_step=None):
    """Export ``bundle``'s predict function at batch ``b`` (``ipf`` ids a
    feature), save it under ``tmp``, load it back in this process and
    score: its graph holds the custom-op nodes of ``key`` and no table
    gather; its outputs equal the predict step's on the card and the CPU
    plain path's (SCORE_TOL); its launches a call equal the predict call's
    and ``EXPORT_LAUNCHES[key]``; the two timed in turns.  Every launch of
    the case is added to ``total``."""
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.train import make_predict_step
    from recommendsystem_tpu_torch.train.export import (export_serving, load_program,
                                                        load_serving, weights_of)

    batch, dense, _, _ = synthetic_batch(bundle, b, seed=b + ipf + 15, ids_per_feature=ipf)
    path = os.path.join(tmp, f"{label}_b{b}_ids{ipf}")
    t0 = time.perf_counter()
    export_serving(bundle, state, batch, dense, path=path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with open(os.path.join(path, "model.pt2"), "rb") as fh:
        blob = fh.read()
    serve = load_serving(blob)
    load_s = time.perf_counter() - t0
    with open(os.path.join(path, "signature.json")) as fh:
        sig = json.load(fh)
    if sig["model"] != bundle.name or sig["batch_columns"] != {
            k: list(v.rows.shape) for k, v in batch.items()}:
        raise AssertionError(f"{label}: signature.json {sig}")
    program = load_program(blob)
    nodes, gathers = _op_nodes(program), _table_gathers(program)
    if nodes != EXPORT_OP_NODES[key] or gathers:
        raise AssertionError(f"{label} b={b}: the exported graph holds {nodes} and table "
                             f"gathers {gathers}, expected {EXPORT_OP_NODES[key]} and none")
    weights = weights_of(state)
    step = want_step or make_predict_step(bundle)
    _add(total, _count(lambda: (serve(weights, state.params, batch, dense),   # warm-up
                                step(state, batch, dense)))[1])
    got, loaded_launches = _count(lambda: serve(weights, state.params, batch, dense))
    want, step_launches = _count(lambda: step(state, batch, dense))
    _add(total, loaded_launches)
    _add(total, step_launches)
    loaded_launches = {k: v for k, v in loaded_launches.items() if v}
    step_launches = {k: v for k, v in step_launches.items() if v}
    if loaded_launches != step_launches or loaded_launches != EXPORT_LAUNCHES[key]:
        raise AssertionError(f"{label} b={b}: the loaded program launched {loaded_launches}, "
                             f"the predict call {step_launches}, expected "
                             f"{EXPORT_LAUNCHES[key]}")
    if set(got) != set(want):
        raise AssertionError(f"{label}: outputs {sorted(got)} against {sorted(want)}")
    cpu_batch = {k: v.to("cpu") for k, v in batch.items()}
    cpu_dense = _to(dense, "cpu") if dense is not None else None
    cpu_want = make_predict_step(cpu_bundle)(cpu_state, cpu_batch, cpu_dense)
    for k in want:
        np.testing.assert_allclose(got[k].cpu().numpy(), want[k].cpu().numpy(),
                                   err_msg=f"{label} {k}", **SCORE_TOL)
        np.testing.assert_allclose(got[k].cpu().numpy(), cpu_want[k].numpy(),
                                   err_msg=f"{label} {k} (CPU)", **SCORE_TOL)
        if not bool(torch.isfinite(got[k]).all()):
            raise AssertionError(f"{label} {k}: non-finite scores")
    ms, timed_launches = _count(lambda: _turns_ms(
        {"predict_step": lambda: step(state, batch, dense),
         "loaded": lambda: serve(weights, state.params, batch, dense)},
        iters=20 if b <= EXPORT_BUCKET else 10))
    _add(total, timed_launches)
    case = {"model": label, "b": b, "ids_per_feature": ipf, "export_s": export_s,
            "load_s": load_s, "artifact_bytes": len(blob), "op_nodes": nodes,
            "launches_per_call": loaded_launches, "ms_per_call": ms,
            "examples_per_s": {k: [b / x * 1e3 for x in v] for k, v in ms.items()}}
    log(f"export {label} b={b} ids={ipf}:", json.dumps(case))
    return case


def export_path(card, cycles_per_ms):
    """Phase 15: the serving export at full width.  Autoint (24 tables of
    265,104 x 8, 5 ids) and staytime (46 storages, 5 ids and 1) exported at
    B 256 and at their predict batches (65536, 16384), saved, loaded in
    this process and scored (``export_case``); autoint once more under the
    bf16 compute policy, held to the bf16 predict step; the custom ops'
    dispatch cost against their launchers at B 256.  ``launches`` sums the
    counted windows of the cases (each set to 0 just before and read just
    after); the dispatch measurement's launches (op against launcher) are
    not in it."""
    import tempfile

    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train import make_predict_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    t_phase = time.perf_counter()
    out = {"cases": [], "card": card, "dispatch": {}, "launches": {}}

    def run(*args, **kw):
        out["cases"].append(export_case(*args, total=out["launches"], **kw))

    def dispatch(name, predict):
        out["dispatch"][name] = dispatch_cost(predict, cycles_per_ms)

    with tempfile.TemporaryDirectory() as tmp:
        autoint = create_model("autoint", bucket_size=FULL_BUCKET, device="cuda")
        state = create_train_state(autoint, seed=15)
        cpu_autoint = create_model("autoint", bucket_size=FULL_BUCKET, device="cpu")
        cpu_state = _cpu_state(state)
        for b in (EXPORT_BUCKET, BIG_BATCH):
            run("autoint", autoint, state, cpu_autoint, cpu_state, b, 5, ("autoint", 5), tmp)
        bf16 = create_model("autoint", bucket_size=FULL_BUCKET, device="cuda",
                            compute_dtype=torch.bfloat16)
        cpu_bf16 = create_model("autoint", bucket_size=FULL_BUCKET, device="cpu",
                                compute_dtype=torch.bfloat16)
        run("autoint_bf16", bf16, state, cpu_bf16, cpu_state, EXPORT_BUCKET, 5,
            ("autoint", 5), tmp, want_step=make_predict_step(bf16))
        batch = synthetic_batch(autoint, EXPORT_BUCKET, seed=5)[0]
        dispatch("autoint", lambda: make_predict_step(autoint)(state, batch))
        del autoint, bf16, state, cpu_autoint, cpu_bf16, cpu_state

        staytime = create_model("staytime", device="cuda")
        state = create_train_state(staytime, seed=15)
        cpu_staytime = create_model("staytime", device="cpu")
        cpu_state = _cpu_state(state)
        for ipf in (5, 1):
            for b in (EXPORT_BUCKET, STAYTIME_BATCH):
                run("staytime", staytime, state, cpu_staytime, cpu_state, b, ipf,
                    ("staytime", ipf), tmp)
        for ipf in (5, 1):
            batch, dense, _, _ = synthetic_batch(staytime, EXPORT_BUCKET, seed=6,
                                                 ids_per_feature=ipf)
            dispatch(f"staytime_ids{ipf}",
                     lambda: make_predict_step(staytime)(state, batch, dense))
        del staytime, state, cpu_staytime, cpu_state
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log("export dispatch:", json.dumps(out["dispatch"]))
    return out


# -- phase 16: the sharded mode on a one-rank NCCL group ------------------------
# launches a step of the sharded packed step on one rank: the local step's,
# one more grouped K2 (``fold_rows``: the owners gather the rows asked of
# them) and one more grouped K4 (``unfold_rows``: the owners add the
# [grad | count] rows that the push brought into their accumulators; the
# senders' K3 and K4 write each entry into its slot of the send buffer)
SHARDED_LAUNCHES = {
    "autoint": {"fold_mean": 1, "fold_rows": 1, "unfold_mean": 1, "unfold_rows": 1,
                "field_attention": 1, "field_attention_bwd": 1, "sparse_adam_update": 1},
    "staytime": {"fold_mean": 1, "fold_rows": 2, "din_pool": 3, "unfold_mean": 1,
                 "unfold_rows": 2, "sparse_adagrad_update": 1}}
# staytime's sharded predict call, 5 ids: the owners' K2, then K1 and the
# three K7 gathering from the rows received
SHARDED_PREDICT_LAUNCHES = {"fold_mean": 1, "fold_rows": 1, "din_pool": 3}
SAMPLE0 = 3 * BIG_BATCH + 5       # a rank's first global sample, for K5f and K5b


def sample_offset_case(seed=61, h=2, dh=4, f=24, b=4096):
    """K5f and K5b with a non-zero sample offset (``SAMPLE0``: the dropout
    counter of a rank's rows starts at their first global sample) against
    their plain versions on the same inputs, dropout 0.2: o and lse within
    ATTN_TOL, dq, dk and dv within GRAD_TOL; the plain mask at SAMPLE0
    differs from the one at 0.  Through ``field_attention``'s autograd
    Function, as the train step takes them."""
    from recommendsystem_tpu_torch.kernels import field_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((h, dh, f, b), generator=g, device="cuda") for _ in range(4))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    o = fa.field_attention(*leaves, seed, DROPOUT, sample0=SAMPLE0)
    o.backward(do)
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    po = fa.field_attention_reference(*cpu, seed, DROPOUT, SAMPLE0)
    po.backward(do.cpu())
    errs = {"o": float((o.detach().cpu() - po.detach()).abs().max())}
    if errs["o"] > ATTN_TOL:
        raise AssertionError(f"K5f with sample offset {SAMPLE0}: {errs}")
    for name, got, want in zip(("dq", "dk", "dv"), leaves, cpu):
        torch.testing.assert_close(got.grad.cpu(), want.grad, **GRAD_TOL, msg=f"K5b {name}")
        errs[name] = float((got.grad.cpu() - want.grad).abs().max())
    at0 = fa.field_attention_reference(*cpu, seed, DROPOUT, 0)
    if torch.equal(at0, po):
        raise AssertionError("the sample offset leaves the dropout mask as it was")
    return {"name": "field_attention sample offset", "sample0": SAMPLE0, "b": b, "f": f,
            "max_abs_err": errs}


def _step_window(step, bundle, batch, dense, labels, weight, steps=TRAIN_STEPS):
    """``steps`` steps from a fresh state, in a window of counts: (state,
    launches a step, losses)."""
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.train.state import create_train_state

    state = create_train_state(bundle, seed=2)
    torch.cuda.synchronize()
    reset_launch_counts()
    infos = []
    for i in range(steps):
        state, info = step(state, batch, labels, weight, dense, seed=i)
        infos.append(info)
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(i["loss"]) for i in infos]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train loss not finite: {losses}")
    return state, counts, losses


def sharded_path(card):
    """Phase 16: the sharded mode (``mode="sharded"``) on a one-rank NCCL
    group from ``core.mesh.create_mesh()``, the card sending each rank's
    requests to itself through NCCL.  Full-width autoint (B = 65536, 5 ids,
    dropout 0.2) and staytime (B = 16384, 5 ids, float32 tables and
    ``"auto"``): ``a2a_drop_report`` reads 0; a window of counts of the
    local packed step and one of the sharded step from the same state and
    batch, the sharded held to ``SHARDED_LAUNCHES`` a step and to the
    local step's losses (TRAIN_LOSS_RTOL), t and show equal to the live
    counts; the two steps timed in turns (local, sharded, sharded,
    local).  Then the sharded step held to the local packed step on the
    CPU by ``witness`` at ``CHECK_SEEDS`` (autoint at TRAIN_CHECK_BATCH,
    staytime at STAYTIME_CHECK_BUCKET and B = 64); one sharded ``scatter``
    step; staytime's sharded predict call (K7 gathering from the received
    rows) held to the local one and to ``SHARDED_PREDICT_LAUNCHES``; K5f
    and K5b with a sample offset against their plain versions.  Destroys
    the group at the end."""
    import torch.distributed as dist

    from recommendsystem_tpu_torch.core.mesh import create_mesh
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
    from recommendsystem_tpu_torch.train import make_predict_step, make_train_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    t_phase = time.perf_counter()
    mesh = create_mesh("cuda")
    out = {"card": card, "ranks": mesh.size, "backend": dist.get_backend(), "train": {}}
    launches = {}

    def sharded(bnd, upd=None):
        return make_train_step(bnd, mode="sharded", sparse_update=upd, mesh=mesh)

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    try:
        for name, model, kw, b in (
                ("autoint", "autoint", {"bucket_size": FULL_BUCKET}, BIG_BATCH),
                ("staytime", "staytime", {}, STAYTIME_BATCH),
                ("staytime_auto", "staytime", {"table_dtype": "auto"}, STAYTIME_BATCH)):
            bundle = create_model(model, device="cuda", **kw)
            eng = bundle.embedding
            batch, dense, labels, weight = synthetic_batch(bundle, b, seed=70, ids_per_feature=5)
            drops = eng.a2a_drop_report(batch, mesh)
            if any(r["rows"] for r in drops.values()):
                raise AssertionError(f"{name}: the one-rank exchange dropped {drops}")
            local, shard = make_train_step(bundle), sharded(bundle)
            lstate, lcounts, llosses = _step_window(local, bundle, batch, dense, labels, weight)
            sstate, scounts, slosses = _step_window(shard, bundle, batch, dense, labels, weight)
            add(scounts)
            per_step = {k: v / TRAIN_STEPS for k, v in scounts.items() if v}
            local_step = {k: v / TRAIN_STEPS for k, v in lcounts.items() if v}
            if per_step != SHARDED_LAUNCHES[model]:
                raise AssertionError(f"{name} sharded: launches a step {per_step}, expected "
                                     f"{SHARDED_LAUNCHES[model]}")
            np.testing.assert_allclose(slosses, llosses, rtol=TRAIN_LOSS_RTOL,
                                       err_msg=f"{name}: sharded against local losses")
            live = eng.row_counts(batch)
            for skey, tstate in sstate.tables.items():
                if not torch.equal(tstate["show"], TRAIN_STEPS * live[skey]):
                    raise AssertionError(f"{name} {skey}: show differs from the live counts")
                if "t" in tstate["opt"] and not torch.equal(
                        tstate["opt"]["t"], TRAIN_STEPS * (live[skey] > 0).float()):
                    raise AssertionError(f"{name} {skey}: t differs from the live counts")
            per_window = 8 if model == "autoint" else 5
            turns = []
            for which, step, st in (("local", local, lstate), ("sharded", shard, sstate),
                                    ("sharded", shard, sstate), ("local", local, lstate)):
                ms, _ = train_ms(step, st, batch, labels, weight, dense, per_window=per_window)
                turns.append((which, ms))
            ms = {w: sorted(m for x, m in turns if x == w) for w in ("local", "sharded")}
            out["train"][name] = {
                "batch": b, "ids_per_feature": 5, "launches_per_step": per_step,
                "local_launches_per_step": local_step, "losses": slosses,
                "local_losses": llosses, "in_turns_ms": turns,
                "sharded_ms": sum(ms["sharded"]) / 2, "local_ms": sum(ms["local"]) / 2,
                "drop_report_rows": sum(r["rows"] for r in drops.values())}
            log(f"sharded train {name}:", json.dumps(out["train"][name]))
            if name == "autoint":
                # one scatter step, its show the live counts
                st = create_train_state(bundle, seed=2)
                st, info = sharded(bundle, "scatter")(st, batch, labels, weight, dense, seed=0)
                if not np.isfinite(float(info["loss"])):
                    raise AssertionError("sharded scatter step: loss not finite")
                for skey, tstate in st.tables.items():
                    if not torch.equal(tstate["show"], live[skey]):
                        raise AssertionError(f"sharded scatter {skey}: show differs")
                out["scatter_loss"] = float(info["loss"])
            if name == "staytime":
                predict = make_predict_step(bundle, mode="sharded", mesh=mesh)
                want = make_predict_step(bundle)(sstate, batch, dense)
                predict(sstate, batch, dense)
                torch.cuda.synchronize()
                reset_launch_counts()
                got = predict(sstate, batch, dense)
                torch.cuda.synchronize()
                counts = launch_counts()
                add(counts)
                per_call = {k: v for k, v in counts.items() if v}
                if per_call != SHARDED_PREDICT_LAUNCHES:
                    raise AssertionError(f"staytime sharded predict: launches {per_call}, "
                                         f"expected {SHARDED_PREDICT_LAUNCHES}")
                for task, w in want.items():
                    np.testing.assert_allclose(got[task].float().cpu().numpy(),
                                               w.float().cpu().numpy(), **SCORE_TOL,
                                               err_msg=f"sharded predict {task}")
                out["predict_launches"] = per_call
            del bundle, eng, lstate, sstate, local, shard
            torch.cuda.empty_cache()

        # the sharded step held to the local packed step on the CPU
        autoint = create_model("autoint", bucket_size=FULL_BUCKET, device="cuda")
        cpu_autoint = create_model("autoint", bucket_size=FULL_BUCKET, device="cpu")
        out["card_vs_cpu"] = {"autoint": hold_card_to_cpu(
            autoint, cpu_autoint, TRAIN_CHECK_BATCH, 5, "autoint sharded", card_step=sharded)}
        del autoint, cpu_autoint
        small = {"cfg": StaytimeConfig(bucket_size=STAYTIME_CHECK_BUCKET)}
        out["card_vs_cpu"]["staytime"] = hold_card_to_cpu(
            create_model("staytime", device="cuda", **small),
            create_model("staytime", device="cpu", **small), TOWER_CHECK_BATCH, 5,
            "staytime sharded", card_step=sharded)
        out["cases"] = [sample_offset_case()]
        log(json.dumps(out["cases"][0]))
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _sharded_line(out):
    """Phase 16's JSON line: each model's sharded and local ms a step and
    launches a step, the predict call's launches, the phase's seconds."""
    return {"train": {m: {k: r[k] for k in ("batch", "sharded_ms", "local_ms",
                                             "launches_per_step", "local_launches_per_step",
                                             "drop_report_rows")}
                      for m, r in out["train"].items()},
            "predict_launches": out["predict_launches"], "ranks": out["ranks"],
            "backend": out["backend"], "phase_s": out["phase_s"], "card": out["card"]}


# -- phase 17: tensor and expert parallelism on a 2-D mesh ----------------------
MESH2D_RANKS = 2                  # one data index x a model axis of 2, on one card
# launches a step of each rank's sharded step on the 2-D mesh: the one-rank
# sharded step's (phase 16): K1, the owners' K2, K3, the owners' K4 and K8,
# and ctr's K5f and K5b; the 212-feature ctr (one id a column) K2 and K4 in
# place of K1 and K3; staytime K9 in place of K8, the sequences' K2 and K4
# and the DIN pools' K7 (SHARDED_LAUNCHES)
_CTR_2D = {"fold_mean": 1, "fold_rows": 1, "unfold_mean": 1, "unfold_rows": 1,
           "field_attention": 1, "field_attention_bwd": 1, "sparse_adam_update": 1}
MESH2D_LAUNCHES = {
    "ctr": _CTR_2D,
    "rough_rank": {"fold_mean": 1, "fold_rows": 1, "unfold_mean": 1, "unfold_rows": 1,
                   "sparse_adam_update": 1},
    "staytime": SHARDED_LAUNCHES["staytime"],
    "ctr212": {"fold_rows": 2, "unfold_rows": 2, "field_attention": 1,
               "field_attention_bwd": 1, "sparse_adam_update": 1},
    "ctr_bf16": _CTR_2D}
# the sharded predict call and eval step: ctr's owners' K2, then K1 and K6;
# staytime's owners' K2, K1 and the three K7 gathering from the rows received
MESH2D_PREDICT_LAUNCHES = {
    "ctr": {"fold_mean": 1, "fold_rows": 1, "interacting_attention": 1},
    "staytime": SHARDED_PREDICT_LAUNCHES}
# a sharded state against the local one: the CPU tests' tolerances
# (``tests/torch_sharded_common.py``: PARAM_TOL, TABLE_TOL)
MESH2D_PARAM_TOL = dict(rtol=5e-4, atol=1e-5)
MESH2D_TABLE_TOL = dict(rtol=5e-4, atol=1e-6)
# under the bf16 compute policy the 2-D step against the local one: each
# loss's relative error, and the relative L2 error of each gradient and of
# each storage's float32 update after step 1 (``_hold_policy``).  The sound
# step read at most 8.5e-5 on the losses, 1.4e-4 on the gradients and
# 2.9e-4 on the updates on the H100; a column Dense that rounds each rank's
# part of x's gradient to bf16 before the sum reads 1.2e-2 on the updates
# (scripts/torch_mesh2d_hold_check.py, on the CPU)
MESH2D_POLICY_LOSS_RTOL = 1e-3
MESH2D_POLICY_REL_L2 = 2e-3
# twins' float32 values this close take the bf16 rule (BF16_RTOL of
# tests/test_torch_bf16_tables.py)
MESH2D_BF16_RTOL = 1e-6
# the cases traced and timed at two steps a turn (the others one)
MESH2D_TRACED = ("ctr", "rough_rank")
# the params the JAX rule splits over a model axis of 2 (tp_min_dim 64;
# ``tests/test_torch_tensor_parallel_placements.py``)
MESH2D_TP_KERNELS = {"ctr": 24, "staytime": 22, "ctr212": 25, "ctr_bf16": 24}
MESH2D_TIMEOUT_S = 900


def _clone_tree(x):
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    return x.clone() if isinstance(x, torch.Tensor) else x


def _window_on(step, state, batch, dense, labels, weight, steps=TRAIN_STEPS, keep=()):
    """``steps`` steps from ``state`` in a window of counts: (state,
    launches, losses, infos, {i: a host copy of the state entering step i}
    for each 0-based step i of ``keep``)."""
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    infos, kept = [], {}
    for i in range(steps):
        if i in keep:
            kept[i] = _state_on(state, "cpu")
        state, info = step(state, batch, labels, weight, dense, seed=i)
        infos.append(info)
    torch.cuda.synchronize()
    counts = launch_counts()
    losses = [float(i["loss"]) for i in infos]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train loss not finite: {losses}")
    return state, counts, losses, infos, kept


def _state_on(state, device):
    """A copy of a ``TrainState`` on ``device``."""
    from recommendsystem_tpu_torch.train.state import TrainState

    return TrainState(params=_to(state.params, device), opt_state=_to(state.opt_state, device),
                      tables=_to(state.tables, device), step=_to(state.step, device))


class _GradRecorder:
    """Records, a step at a time, the dense gradients as the dense Adam
    takes them and each storage's gradient rows as the lazy pass takes them
    (the accumulator's (rows, D) block, copied to the host), for the side
    set by ``side``: what ``_hold_state`` explains an entry past its
    tolerance by."""

    def __init__(self, bundle):
        self.bundle, self.which = bundle, None
        self.dense, self.tables = {}, {}

    def side(self, which):
        self.which = which
        self.dense[which], self.tables[which] = [], []
        return self

    def __enter__(self):
        from recommendsystem_tpu_torch.embedding import packed

        opt = self.bundle.dense_optimizer
        real_update, real_group = opt.update_, packed.sparse_update_group

        def update(params, grads, state):
            self.dense[self.which].append({k: g.detach().clone() for k, g in grads.items()})
            self.tables[self.which].append({})
            return real_update(params, grads, state)

        def group(o, tstates, accs):
            tstates, accs = list(tstates), list(accs)
            for ts, acc in zip(tstates, accs):
                rows = packed.accumulator_views(acc, ts["w"].shape[1])[0]
                self.tables[self.which][-1][id(ts["w"])] = rows.detach().to("cpu", copy=True)
            return real_group(o, tstates, accs)

        self._undo = (opt, real_group)
        object.__setattr__(opt, "update_", update)       # a frozen dataclass
        packed.sparse_update_group = group
        return self

    def __exit__(self, *exc):
        from recommendsystem_tpu_torch.embedding import packed

        opt, real_group = self._undo
        object.__delattr__(opt, "update_")
        packed.sparse_update_group = real_group

    def by_storage(self, which, tables):
        """The recorded table gradients of ``which``, keyed by storage."""
        names = {id(t["w"]): skey for skey, t in tables.items()}
        return [{names[k]: v for k, v in step.items()} for step in self.tables[which]]


class _KinkFinder(TorchFunctionMode):
    """The ReLU calls of the local window and of the 2-D window, counted
    (``calls``).  With ``flips``, both windows' inputs are kept (``local``
    on the card, ``mine`` on the host) and each 2-D call's flips are found
    against the
    local call of the same place (an expert shard's input against its
    experts' rows of the local one): a flip whose two values lie within
    KINK_RTOL of the call's largest |input|, or within the largest
    difference among the call's elements that did not flip, is a kink, as
    ``witness`` counts one; once a step had a kink, the flips of the steps
    after it count as kinks (their states are apart by more than rounding).
    ``kinks``: the samples with a kink; ``kinked_step``: the first step
    with one; ``far``: every other flip."""

    def __init__(self, model_rank, b, steps, flips=True):
        super().__init__()
        self.model_rank, self.b, self.steps, self.flips = model_rank, b, steps, flips
        self.local, self.mine, self.side = [], [], None
        self.calls = {"local": 0, "2d": 0}
        self.kinks, self.far, self.kinked_step = set(), [], None

    def at(self, side):
        self.side = side
        return self

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.relu, torch.nn.functional.relu, torch.Tensor.relu):
            x = args[0].detach()
            if self.flips and self.side == "local":
                self.local.append(x.clone())
            elif self.flips:
                self._flips(x, self.calls["2d"])
                self.mine.append(x.to("cpu", copy=True))
            self.calls[self.side] += 1
        return func(*args, **(kwargs or {}))

    def _flips(self, g, i):
        c = self.local[i]
        step = i // (len(self.local) // self.steps) + 1
        if c.shape != g.shape:          # a shard of the experts: its rows
            c = c.narrow(0, self.model_rank * g.shape[0], g.shape[0])
        flipped = (g > 0) != (c > 0)
        if not bool(flipped.any()):
            return
        near = max(KINK_RTOL * float(c.abs().max()),
                   float(torch.where(flipped, 0.0, (g - c).abs()).max()))
        for idx in flipped.nonzero().tolist():
            gv, cv = float(g[tuple(idx)]), float(c[tuple(idx)])
            sample = _sample_of(g.shape, idx, self.b)
            if max(abs(gv), abs(cv)) <= near or (self.kinked_step or step) < step:
                self.kinks.add(sample)
                self.kinked_step = min(self.kinked_step or step, step)
            else:
                self.far.append({"step": step, "shape": list(g.shape), "sample": sample,
                                 "2d": gv, "local": cv, "near": near})


def _past_tol(got, want, rtol, atol):
    """Where ``got`` lies past ``want``'s tolerance (``np.isclose``'s rule)."""
    got, want = got.float(), want.float()
    return (got - want).abs() > atol + rtol * want.abs()


def _zero_grad(steps):
    """Whether a dense param's gradient is 0 in exact arithmetic on both
    sides at every step (staytime's DIN ``b2``: each side's is rounding
    noise): at most POLICY_ZERO_GRAD of the step's largest gradient norm.
    ``steps``: [(2-D gradients, local gradients, name)] a step."""
    for a, b, name in steps:
        scale = max(float(g.norm()) for g in b.values())
        if max(float(a[name].norm()), float(b[name].norm())) > POLICY_ZERO_GRAD * scale:
            return False
    return True


def _held_leaves(got, want):
    """(label, kind, key, got's tensor, want's, tolerance) of every dense
    param (MESH2D_PARAM_TOL) and Adam moment and every table quantity but
    t and show (MESH2D_TABLE_TOL) of ``want``; ``kind`` and ``key`` name
    the gradient that moves it (``grads[kind][side][step][key]``)."""
    for k, v in want.params.items():
        yield k, "dense", k, got.params[k], v, MESH2D_PARAM_TOL
    for m in ("mu", "nu"):
        for k, v in want.opt_state[m].items():
            yield f"{m} {k}", "dense", k, got.opt_state[m][k], v, MESH2D_TABLE_TOL
    for skey, t in want.tables.items():
        mine = _table_quantities(got.tables[skey])
        for q, v in _table_quantities(t).items():
            if q not in ("t", "show"):
                yield f"{skey} {q}", "tables", skey, mine[q], v, MESH2D_TABLE_TOL


def _apart(a, b, like):
    """Where gradient ``a`` differs from ``b`` beyond rounding, as a mask
    of ``like``'s shape on its device (a row's (rows, 1) quantity:
    anywhere in the row)."""
    m = _beyond_rounding(a.float(), b.float().to(a.device))
    if m.shape != like.shape:
        m = m.any(dim=-1, keepdim=True)
    return m.reshape(like.shape).to(like.device)


def _steps_apart(got, want, grads):
    """{label: (its entries past their tolerance, [a step's mask of those
    whose 2-D and local gradients differ beyond rounding])} of the entries
    ``_hold_state`` must explain, and {label: entries} of the dense params
    whose gradient is 0 in exact arithmetic (``_zero_grad``)."""
    out, zero = {}, {}
    for label, kind, key, g, w, tol in _held_leaves(got, want):
        bad = _past_tol(g, w, **tol)
        if not bool(bad.any()):
            continue
        steps = list(zip(grads[kind]["2d"], grads[kind]["local"]))
        if kind == "dense" and _zero_grad([(a, b, key) for a, b in steps]):
            zero[label] = int(bad.sum())
            continue
        out[label] = (bad, [_apart(a[key], b[key], bad) & bad for a, b in steps])
    return out, zero


def _hold_state(got, want, what, grads, apart, replays):
    """A gathered sharded state against the local one: params and the Adam
    moments at MESH2D_PARAM_TOL / MESH2D_TABLE_TOL, tables (w and the
    sparse optimizer's state) at MESH2D_TABLE_TOL, show and t equal.  An
    entry past its tolerance (``apart``: ``_steps_apart``'s) is explained
    where its gradients on the two sides agree within rounding at every
    step (``_beyond_rounding``: Adam turns a rounding of a gradient near 0
    into a visible step), or where, at every step at which they differ
    beyond rounding, the local step from the 2-D state entering it with
    the 2-D step's kinks (``replays``: {0-based step: its gradients,
    ``_kinked_replay``}) gives the 2-D gradient within rounding: the kinks
    on the entry's own path and the state they set apart account for it,
    and nothing else does.  A dense param whose gradient is 0 in exact
    arithmetic is explained (``_zero_grad``: Adam moves it by each side's
    rounding noise).  ``grads``: {"dense" and "tables": {"2d" and "local":
    [{name: gradient} a step]}}.  Returns the entries past a tolerance and
    how each was explained; raises on any other."""
    out = {"past": 0, "rounding": 0, "kink": 0, "zero_grad": 0}
    apart, zero = apart
    out["zero_grad"] = sum(zero.values())
    leaves = {label: (kind, key) for label, kind, key, *_ in _held_leaves(got, want)}
    for label, (bad, steps) in apart.items():
        kind, key = leaves[label]
        n, diff, left = int(bad.sum()), torch.zeros_like(bad), torch.zeros_like(bad)
        for t, m in enumerate(steps):
            if bool(m.any()):
                diff |= m
                left |= m & _apart(grads[kind]["2d"][t][key], replays[t][kind][key], bad)
        if bool(left.any()):
            seen = []
            for i in left.nonzero()[:3].tolist():
                i = tuple(i)
                seen.append({"index": list(i), "steps": [
                    {"2d": float(a[key][i]), "local": float(b[key][i]),
                     "replay": float(replays[t][kind][key][i]) if t in replays else None}
                    for t, (a, b) in enumerate(zip(grads[kind]["2d"], grads[kind]["local"]))]})
            raise AssertionError(f"{what} {label}: {int(left.sum())} of {n} entries past their "
                                 f"tolerance with gradients apart beyond rounding that the "
                                 f"local step with the 2-D step's kinks does not give: {seen}")
        out["past"] += n
        out["rounding"] += n - int(diff.sum())
        out["kink"] += int(diff.sum())
    out["past"] += out["zero_grad"]
    for skey, t in want.tables.items():
        g = got.tables[skey]
        if not torch.equal(g["show"], t["show"]):
            raise AssertionError(f"{what} {skey}: show differs from the local step's")
        if "t" in t["opt"] and not torch.equal(g["opt"]["t"], t["opt"]["t"]):
            raise AssertionError(f"{what} {skey}: t differs from the local step's")
    return out


def _replicas_equal(tables, mesh) -> bool:
    """Whether the model ranks of this data index hold the same bits in
    every table leaf: each storage's bytes gathered over the model group and
    compared, the verdict agreed over it."""
    import torch.distributed as dist

    from recommendsystem_tpu_torch.core.model_axis import all_gather

    same = True
    for t in tables.values():
        mine = torch.cat([x.reshape(-1).view(torch.uint8)
                          for x in (t["w"], *t["opt"].values(), t["show"])])
        parts = all_gather(mine, 0, mesh.model_group, mesh.model).view(mesh.model, -1)
        same = same and all(torch.equal(p, mine) for p in parts)
        del mine, parts
    flag = torch.tensor([float(same)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.model_group)
    return bool(flag.item())


def _digest(tree, prefix=""):
    """{leaf name: a 64-bit position-weighted sum of its bits}: equal
    tensors give equal digests, and a flipped bit changes its leaf's."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_digest(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            x = v.contiguous().reshape(-1)
            x = x.view(torch.int32 if x.element_size() == 4 else torch.int16).to(torch.int64)
            w = torch.arange(x.numel(), device=x.device, dtype=torch.int64)
            w = w * -7046029254386353131 + 1442695040888963407
            out[f"{prefix}{k}"] = [int((x * w).sum()), tuple(v.shape), str(v.dtype)]
        else:
            out[f"{prefix}{k}"] = v
    return out


def _turns_on(pairs, batch, dense, labels, weight, steps=2):
    """Each (name, step, state) of ``pairs`` in turn: one warm-up step,
    then ms a step over ``steps`` steps ending in a synchronize."""
    turns = []
    for which, step, state in pairs:
        state, info = step(state, batch, labels, weight, dense, seed=90)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            state, info = step(state, batch, labels, weight, dense, seed=91 + i)
        float(info["loss"])
        torch.cuda.synchronize()
        turns.append((which, (time.perf_counter() - t0) / steps * 1e3))
    return turns


def _busy_share(step, state, batch, dense, labels, weight, steps=2):
    """``steps`` steps under ``torch.profiler``: the kernels' device ms a
    step, the traced wall ms a step (host clock, ending in a synchronize),
    their ratio (the busy share) and the kernels a step."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            state, info = step(state, batch, labels, weight, dense, seed=95 + i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    busy_us, kernels = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = next((float(getattr(e, a)) for a in ("self_device_time_total",
                                                   "self_cuda_time_total")
                   if hasattr(e, a)), 0.0)
        if us > 0:
            busy_us += us
            kernels += e.count
    busy_ms = busy_us / steps / 1e3
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "busy_share": busy_ms / wall_ms,
            "kernels": kernels / steps}


class _WholeAdam:
    """The dense Adam of a tensor-parallel step taken on whole tensors: the
    shards the step hands it gathered over the model group, the bundle's own
    ``dense_optimizer.update_`` (looked up at each call, where the witness
    records the gradients it is given) on the whole, and this rank's part
    written back into its shards.  Adam is elementwise, so the shards end
    as the sharded Adam leaves them; the witness sees whole gradients."""

    def __init__(self, bundle, mesh, shardings):
        self.bundle, self.mesh, self.sh = bundle, mesh, shardings

    def _whole(self, x, placement):
        from recommendsystem_tpu_torch.core.model_axis import all_gather

        if not placement.model_axis:
            return x
        return all_gather(x, placement.dim, self.mesh.model_group, self.mesh.model)

    def update_(self, params, grads, state):
        sh = self.sh.params
        wp = {k: self._whole(v, sh[k]) for k, v in params.items()}
        wg = {k: self._whole(v, sh[k]) for k, v in grads.items()}
        ws = {"count": state["count"],
              **{m: {k: self._whole(v, sh[k]) for k, v in state[m].items()}
                 for m in ("mu", "nu")}}
        wp, ws = self.bundle.dense_optimizer.update_(wp, wg, ws)
        for k, v in params.items():
            v.copy_(sh[k].local_part(wp[k]))
        for m in ("mu", "nu"):
            for k, v in state[m].items():
                v.copy_(sh[k].local_part(ws[m][k]))
        state["count"] = ws["count"]
        return params, state


def _tp_card_step(mesh):
    """``card_step`` for ``witness``: the tensor-parallel step on whole
    states.  The step cuts this rank's columns of the state it is given
    (the tables pass as they are: the data axis is 1, so a rank's rows are
    the table), takes the sharded step with ``_WholeAdam``, and gathers the
    dense state back; the tables it returns are the tensors it was given,
    updated in place, as the witness's recorders key them."""
    from recommendsystem_tpu_torch.train import make_train_step
    from recommendsystem_tpu_torch.train.state import (TrainState, create_train_state,
                                                       gather_state, state_shardings)

    if mesh.size != 1:
        raise ValueError("the witness's tensor-parallel step takes a data axis of 1")

    def make(bnd, sparse_update):
        sh = state_shardings(bnd, create_train_state(bnd, seed=0), mesh, tensor_parallel=True)
        proxy = dataclasses.replace(bnd, dense_optimizer=_WholeAdam(bnd, mesh, sh))
        step = make_train_step(proxy, mode="sharded", sparse_update=sparse_update, mesh=mesh,
                               shardings=sh)

        def cut(tree, placements):
            if isinstance(tree, dict):
                return {k: cut(v, placements[k]) for k, v in tree.items()}
            if not isinstance(tree, torch.Tensor):
                return tree
            return placements.local_part(tree).clone()

        def run(state, batch, labels, weight=None, dense=None, seed=0):
            shards = TrainState(params=cut(state.params, sh.params),
                                opt_state=cut(state.opt_state, sh.opt_state),
                                tables=state.tables, step=state.step)
            new, info = step(shards, batch, labels, weight, dense, seed=seed)
            whole = gather_state(bnd, TrainState(new.params, new.opt_state, {}, new.step),
                                 mesh, sh)
            return TrainState(params=whole.params, opt_state=whole.opt_state,
                              tables=new.tables, step=new.step), info
        return run
    return make


def _whole_on(w, kept):
    """A host copy of a 2-D rank's state made whole on the card: its dense
    shards gathered over the model group, its tables as they are (the data
    axis is 1: a rank's rows are the whole tables).  A collective."""
    from recommendsystem_tpu_torch.train.state import gather_state

    if w.mesh.size != 1:
        raise ValueError("phase 17's holds take a data axis of 1")
    dev = w.bundle.device
    dense = gather_state(w.bundle, _state_on(dataclasses.replace(kept, tables={}), dev), w.mesh,
                         w.sh)
    return dataclasses.replace(dense, tables=_to(kept.tables, dev))


def _kinked_replay(w, t):
    """The gradients ({"dense": whole, as the dense Adam takes them;
    "tables": each storage's rows, as the lazy pass takes them}) of the
    local step ``t`` (0-based; its window's seed) from the 2-D state
    entering it (``w.kept[t]``, its dense shards gathered) with the 2-D
    step's kinks of that step: ``_KinkedRelu`` over the 2-D ReLU inputs
    (``w.relu.mine``; an expert shard's gathered over the model group).  A
    collective: every model rank calls it."""
    from recommendsystem_tpu_torch.core.model_axis import all_gather
    from recommendsystem_tpu_torch.train import make_train_step

    mesh, dev, per = w.mesh, w.bundle.device, len(w.relu.mine) // TRAIN_STEPS
    card = [x.to(dev) if x.shape == c.shape
            else all_gather(x.to(dev), 0, mesh.model_group, mesh.model)
            for x, c in zip(w.relu.mine[t * per:(t + 1) * per],
                            w.relu.local[t * per:(t + 1) * per])]
    whole = _whole_on(w, w.kept[t])
    rec, kinked = _GradRecorder(w.bundle), _KinkedRelu(card)
    with rec.side("replay"), kinked:
        make_train_step(w.bundle)(whole, w.batch, w.labels, w.weight, w.dense, seed=t)
    if kinked.calls != len(card):
        raise AssertionError(f"{w.name}: the replayed step called ReLU {kinked.calls} times, "
                             f"the 2-D step {len(card)}")
    return {"dense": rec.dense["replay"][0], "tables": rec.by_storage("replay", whole.tables)[0]}


@dataclasses.dataclass
class _Window2D:
    """One case's two windows from one state and batch, for its hold:
    the losses, the recorded gradients (``grads``, the 2-D dense ones
    gathered whole), the local state after the window and the 2-D one
    gathered, the host copies of the states entering the steps (``kept``
    2-D, ``lkept`` local) and the ReLU calls (``relu``)."""
    name: str
    bundle: object
    mesh: object
    sh: object
    batch: dict
    dense: object
    labels: dict
    weight: object
    relu: _KinkFinder
    losses: list
    llosses: list
    grads: dict
    lstate: object
    gathered: object
    kept: dict
    lkept: dict


def _agreed(mesh, name, check):
    """``check()``'s result where it passes on every model rank: its
    verdict agreed over the model group, so that every rank raises
    together where one refuses (the ranks then leave no collective half
    entered)."""
    import torch.distributed as dist

    try:
        out, err = check(), None
    except AssertionError as e:
        out, err = None, e
    flag = torch.tensor([float(err is not None)])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.model_group)
    if err is not None:
        raise err
    if flag.item():
        raise AssertionError(f"{name}: another model rank refused its hold")
    return out


def _hold_float32(w):
    """A float32 case's 2-D window against its local one: the losses at
    TRAIN_LOSS_RTOL, every ReLU flip a kink, and the state by
    ``_hold_state``, its entries past their tolerances held to the kinked
    replay (``_kinked_replay``) at each step where some differ beyond
    rounding; the steps replayed, and the verdict, are agreed over the
    model group."""
    import torch.distributed as dist

    relu = w.relu
    apart = _steps_apart(w.gathered, w.lstate, w.grads)
    flags = torch.zeros(TRAIN_STEPS)
    for _, steps in apart[0].values():
        flags += torch.tensor([float(m.any()) for m in steps])
    dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=w.mesh.model_group)
    replays = {t: _kinked_replay(w, t) for t in range(TRAIN_STEPS) if flags[t] > 0}

    def check():
        if relu.far:
            raise AssertionError(f"{w.name}: ReLU inputs flipped far from 0 between the 2-D "
                                 f"and the local step: {relu.far[:5]}")
        np.testing.assert_allclose(w.losses, w.llosses, rtol=TRAIN_LOSS_RTOL,
                                   err_msg=f"{w.name}: 2-D step against local losses")
        held = _hold_state(w.gathered, w.lstate, w.name, w.grads, apart, replays)
        held.update(kinked_samples=len(relu.kinks), kinked_step=relu.kinked_step,
                    replayed_steps=[t + 1 for t in sorted(replays)])
        return held
    return _agreed(w.mesh, w.name, check)


def _rel_l2(a, b):
    b = b.float()
    return float((a.float() - b).norm() / b.norm())


def _hold_policy(w):
    """A case under the bf16 compute policy, its 2-D window against its
    local one: each step's loss within MESH2D_POLICY_LOSS_RTOL, each dense
    gradient and each storage's gradient rows within
    MESH2D_POLICY_REL_L2 relative L2 at every step; and the state
    after step 1, where both sides start from one state: each side's dense
    params and Adam moments are its own dense Adam of its own gradients
    (MESH2D_PARAM_TOL / MESH2D_TABLE_TOL); each side stores in its bf16
    w, m and v its own float32 lazy Adam of its own gradient rows rounded
    once (``_bf16_off`` at the card's table tolerances); the two float32
    updates (w's change, m, v) agree within MESH2D_POLICY_REL_L2; and
    where they agree within MESH2D_BF16_RTOL the 2-D's stored entry keeps
    the bf16 rule against the local's float32 value.  The tables are held
    on model index 0: the 2-D step's replicas store its update (the sync
    broadcasts it; ``_replicas_equal`` holds them bit-equal), while
    another replica's own gradient rows differ from it where a card's
    atomics summed a bf16 gradient in another order.  Returns the largest
    relative L2 errors and the entries the rule decided."""
    after = {"local": _state_on(w.lkept[1], w.bundle.device), "2d": _whole_on(w, w.kept[1])}
    return _agreed(w.mesh, w.name, lambda: _policy_checks(w, after))


def _policy_checks(w, after):
    """``_hold_policy``'s checks on this rank, ``after``: each side's state
    after step 1, gathered whole."""
    from recommendsystem_tpu_torch.train.state import TrainState

    if not np.allclose(w.losses, w.llosses, rtol=MESH2D_POLICY_LOSS_RTOL, atol=0):
        raise AssertionError(f"{w.name}: 2-D losses {w.losses}, local {w.llosses}")
    worst = {"loss": max(abs(a - b) / abs(b) for a, b in zip(w.losses, w.llosses)),
             "dense": 0.0, "tables": 0.0, "update": 0.0}
    for kind in ("dense", "tables"):
        for a, b in zip(w.grads[kind]["2d"], w.grads[kind]["local"]):
            for k, want in b.items():
                if not bool(want.any()):
                    if bool(a[k].any()):
                        raise AssertionError(f"{w.name} {k}: a gradient where the local is 0")
                    continue
                err = _rel_l2(a[k], want)
                worst[kind] = max(worst[kind], err)
                if err > MESH2D_POLICY_REL_L2:
                    raise AssertionError(f"{w.name} {k}: gradient relative L2 error {err}")
    dev, init = w.bundle.device, w.lkept[0]
    eng, ruled = w.bundle.embedding, 0
    opt32 = dataclasses.replace(eng.sparse_opt, state_dtype=torch.float32)
    counts = eng.row_counts(w.batch)
    tables = init.tables if w.mesh.model_rank == 0 else {}
    f32 = {}
    for side, st in after.items():
        params, opt = w.bundle.dense_optimizer.update_(
            _to(init.params, dev), w.grads["dense"][side][0], _to(init.opt_state, dev))
        for label, _, _, g, want, tol in _held_leaves(st, TrainState(params, opt, {})):
            if bool(_past_tol(g, want, **tol).any()):
                raise AssertionError(f"{w.name} {side} {label}: not the dense Adam of its own "
                                     f"gradients after step 1")
        rows = w.grads["tables"][side][0]
        for skey, t0 in tables.items():
            t0 = _to(t0, dev)
            pw, pst = opt32.update(t0["w"].float(), rows[skey].to(dev),
                                   {n: x.float() for n, x in t0["opt"].items()},
                                   (counts[skey].reshape(-1, 1) > 0).float())
            f32[side, skey] = {"w": pw, **pst}
            for q in ("w", "m", "v"):
                stored = _table_quantities(st.tables[skey])[q]
                off = _bf16_off(stored, f32[side, skey][q], *_table_tols(q))
                if bool(off.any()):
                    i = off.nonzero()[:3]
                    raise AssertionError(
                        f"{w.name} {side} {skey} {q}: {int(off.sum())} entries not its "
                        f"float32 update of its own gradient rows rounded once, e.g. at "
                        f"{i.tolist()}: stored {stored[i[:, 0], i[:, 1]].float().tolist()}, "
                        f"float32 {f32[side, skey][q][i[:, 0], i[:, 1]].tolist()}")
        del rows
    for skey, t0 in tables.items():
        w0 = t0["w"].to(dev).float()
        for q in ("w", "m", "v"):
            p2, pl = f32["2d", skey][q], f32["local", skey][q]
            base = w0 if q == "w" else 0.0
            if bool((pl - base).any()):
                err = _rel_l2(p2 - base, pl - base)
                worst["update"] = max(worst["update"], err)
                if err > MESH2D_POLICY_REL_L2:
                    raise AssertionError(f"{w.name} {skey} {q}: float32 updates apart by "
                                         f"{err} relative L2")
            close = torch.isclose(p2, pl, rtol=MESH2D_BF16_RTOL, atol=0.0)
            stored = _table_quantities(after["2d"].tables[skey])[q]
            if bool((_bf16_off(stored, pl, *_table_tols(q)) & close).any()):
                raise AssertionError(f"{w.name} {skey} {q}: the 2-D step's bf16 entry breaks "
                                     f"the bf16 rule against the local float32 update")
            ruled += int(((stored != pl.to(stored.dtype)) & close).sum())
        for side in ("2d", "local"):
            del f32[side, skey]
    return {"worst_rel": worst, "bf16_rule_entries": ruled}


def _mesh2d_model(mesh, card, name, model, kw, b, ipf, placement):
    """One case of phase 17 on this rank: its placements, a window of the
    local step and one of the 2-D sharded step from one state and batch,
    held to each other (``_hold_float32``; under the bf16 compute policy
    ``_hold_policy``), each step's ReLU calls counted on both sides;
    launches, replicas, drops, the two steps timed in turns (two steps a
    turn and traced where MESH2D_TRACED lists the case, else one,
    untraced); the predict call and the eval step where
    MESH2D_PREDICT_LAUNCHES lists the case; for ctr also a scatter step's
    collectives."""
    import torch.distributed as dist

    from recommendsystem_tpu_torch.core import model_axis
    from recommendsystem_tpu_torch.core.mesh import local_batch
    from recommendsystem_tpu_torch.core.model_axis import all_gather
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.nn import expert_shardings
    from recommendsystem_tpu_torch.train import (make_eval_step, make_predict_step,
                                                 make_train_step)
    from recommendsystem_tpu_torch.train import metrics as M
    from recommendsystem_tpu_torch.train.state import (create_train_state, gather_state,
                                                       merge_shardings, shard_state,
                                                       state_shardings)

    bundle = create_model(model, device="cuda", num_shards=mesh.size, **kw)
    eng = bundle.embedding
    policy = bundle.compute_dtype != torch.float32
    whole = create_train_state(bundle, seed=2)
    if placement == "tensor":
        sh = state_shardings(bundle, whole, mesh, tensor_parallel=True)
        rule = sum(1 for v in whole.params.values()
                   if v.ndim == 2 and v.shape[-1] >= 64 and v.shape[-1] % mesh.model == 0)
        split = {k: p.kind for k, p in sh.params.items() if p.model_axis}
        if not (len(split) == rule == MESH2D_TP_KERNELS[name]
                and set(split.values()) == {"column"}):
            raise AssertionError(f"{name}: {len(split)} column placements, the JAX rule "
                                 f"gives {rule}")
    else:
        sh = merge_shardings(state_shardings(bundle, whole, mesh),
                             expert_shardings(whole.params, mesh))
        split = {k: p.kind for k, p in sh.params.items() if p.model_axis}
        stacks = {k: whole.params[k].shape[0] for k in split}
        if sorted(set(stacks.values())) != [4, 8] or len(split) != 8:
            raise AssertionError(f"{name}: expert placements {stacks}")
    batch, dense, labels, weight = local_batch(
        synthetic_batch(bundle, b, seed=70, ids_per_feature=ipf), mesh)
    drops = eng.a2a_drop_report(batch, mesh)
    if any(r["rows"] for r in drops.values()):
        raise AssertionError(f"{name}: the exchange dropped {drops}")
    state = shard_state(bundle, whole, mesh, sh)
    for k, kind in split.items():
        want = list(whole.params[k].shape)
        want[-1 if kind == "column" else 0] //= mesh.model
        if list(state.params[k].shape) != want:
            raise AssertionError(f"{name} {k}: shard {tuple(state.params[k].shape)}")
    local = make_train_step(bundle)
    step2d = make_train_step(bundle, mode="sharded", mesh=mesh, shardings=sh)
    rec = _GradRecorder(bundle)
    # under the policy a ReLU input differs between the sides by bf16
    # roundings, and the hold reads gradients and the state after step 1;
    # in float32 the hold replays the local step from any 2-D state
    relu = _KinkFinder(mesh.model_rank, b, TRAIN_STEPS, flips=not policy)
    lkeep, keep = ((0, 1), (1,)) if policy else ((), tuple(range(TRAIN_STEPS)))
    with rec.side("local"), relu.at("local"):
        lstate, lcounts, llosses, _, lkept = _window_on(local, whole, batch, dense, labels,
                                                        weight, keep=lkeep)
    model_axis.reset_collective_stats()
    with rec.side("2d"), relu.at("2d"):
        state, counts, losses, infos, kept = _window_on(step2d, state, batch, dense, labels,
                                                        weight, keep=keep)
    stats = model_axis.collective_stats()
    if not relu.calls["local"] or relu.calls["2d"] != relu.calls["local"]:
        raise AssertionError(f"{name}: the 2-D step called ReLU {relu.calls['2d']} times, "
                             f"the local step {relu.calls['local']}")
    per_step = {k: v / TRAIN_STEPS for k, v in counts.items() if v}
    if per_step != MESH2D_LAUNCHES[name]:
        raise AssertionError(f"{name} 2-D step: launches a step {per_step}, expected "
                             f"{MESH2D_LAUNCHES[name]}")
    regs = [float(i["regularization"]) for i in infos]
    equal = _replicas_equal(state.tables, mesh)
    if not equal:
        raise AssertionError(f"{name}: the model replicas' tables differ")
    gathered = gather_state(bundle, state, mesh, sh)
    grads = {"dense": {"local": rec.dense["local"],
                       "2d": [{k: all_gather(g, sh.params[k].dim, mesh.model_group, mesh.model)
                               if sh.params[k].model_axis else g for k, g in step.items()}
                              for step in rec.dense["2d"]]},
             "tables": {"local": rec.by_storage("local", lstate.tables),
                        "2d": rec.by_storage("2d", state.tables)}}
    hold = _hold_policy if policy else _hold_float32
    held = hold(_Window2D(name, bundle, mesh, sh, batch, dense, labels, weight, relu, losses,
                          llosses, grads, lstate, gathered, kept, lkept))
    del grads, rec, relu, kept, lkept
    res = {"batch": b, "placement": placement, "split_leaves": len(split),
           "launches_per_step": per_step,
           "local_launches_per_step": {k: v / TRAIN_STEPS for k, v in lcounts.items() if v},
           "losses": losses, "local_losses": llosses, "regularization": regs,
           "replicas_equal": equal, "drop_report_rows": sum(r["rows"] for r in drops.values()),
           "past_tolerance": held,
           "collectives_per_step": {k: v / TRAIN_STEPS for k, v in stats.items()},
           "launches": counts}
    if name in MESH2D_PREDICT_LAUNCHES:
        tp_pred = make_predict_step(bundle, mode="sharded", mesh=mesh, shardings=sh)
        want = make_predict_step(bundle)(gathered, batch, dense)
        tp_pred(state, batch, dense)
        torch.cuda.synchronize()
        reset_launch_counts()
        got = tp_pred(state, batch, dense)
        torch.cuda.synchronize()
        pcounts = launch_counts()
        for task, w in want.items():
            np.testing.assert_allclose(got[task].float().cpu().numpy(), w.float().cpu().numpy(),
                                       **SCORE_TOL, err_msg=f"{name} 2-D predict {task}")
        tp_eval = make_eval_step(bundle, mode="sharded", mesh=mesh, shardings=sh)
        zero = M.init_metrics(bundle.metrics, bundle.device)
        lstates, _ = make_eval_step(bundle)(gathered, batch, labels, weight, dense, zero)
        reset_launch_counts()
        states, _ = tp_eval(state, batch, labels, weight, dense,
                            M.init_metrics(bundle.metrics, bundle.device))
        torch.cuda.synchronize()
        ecounts = launch_counts()
        values, lvalues = (M.compute_metrics(bundle.metrics, s) for s in (states, lstates))
        for task, ms in lvalues.items():
            for metric, v in ms.items():
                np.testing.assert_allclose(float(values[task][metric]), float(v), **SCORE_TOL,
                                           err_msg=f"{name} 2-D eval {task} {metric}")
        for what, c in (("predict", pcounts), ("eval", ecounts)):
            per_call = {k: v for k, v in c.items() if v}
            if per_call != MESH2D_PREDICT_LAUNCHES[name]:
                raise AssertionError(f"{name} 2-D {what}: launches {per_call}, expected "
                                     f"{MESH2D_PREDICT_LAUNCHES[name]}")
            res[f"{what}_launches"] = per_call
            res["launches"] = {k: res["launches"].get(k, 0) + c.get(k, 0)
                               for k in set(res["launches"]) | set(c)}
    del gathered
    traced = name in MESH2D_TRACED
    turns = _turns_on((("local", local, lstate), ("2d", step2d, state), ("2d", step2d, state),
                       ("local", local, lstate)), batch, dense, labels, weight,
                      steps=2 if traced else 1)
    res["in_turns_ms"] = turns
    if traced:
        res["profile"] = {which: _busy_share(st, sd, batch, dense, labels, weight)
                          for which, st, sd in (("local", local, lstate),
                                                ("2d", step2d, state))}
    res["mesh2d_ms"] = sum(ms for w, ms in turns if w == "2d") / 2
    res["local_ms"] = sum(ms for w, ms in turns if w == "local") / 2
    if name == "ctr":
        # the scatter update's sync: only the rows it wrote (the packed
        # update's: the rows its owners were asked for)
        scatter = make_train_step(bundle, mode="sharded", sparse_update="scatter", mesh=mesh,
                                  shardings=sh)
        torch.cuda.synchronize()
        model_axis.reset_collective_stats()
        state, _ = scatter(state, batch, labels, weight, dense, seed=7)
        torch.cuda.synchronize()
        res["scatter_collectives_per_step"] = model_axis.collective_stats()
    res["final_replicas_equal"] = _replicas_equal(state.tables, mesh)
    if not res["final_replicas_equal"]:
        raise AssertionError(f"{name}: the model replicas' tables differ after the turns")
    dist.barrier()
    del bundle, eng, whole, state, lstate, local, step2d
    torch.cuda.empty_cache()
    return res


def _mesh2d_checkpoint(mesh, ckpt):
    """``fit(mode="sharded", checkpoint_dir=ckpt, checkpoint_every=2)`` for 2
    steps of full-width ctr, tensor-parallel; the checkpoint restored onto
    the ranks against their shards bit for bit; a sharded save and restore
    timed; the gathered state's digests for the parent's local restore."""
    from recommendsystem_tpu_torch.core.mesh import local_batch
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from recommendsystem_tpu_torch.train.harness import fit
    from recommendsystem_tpu_torch.train.state import (create_train_state, gather_state,
                                                       state_shardings)

    bundle = create_model("ctr", device="cuda", num_shards=mesh.size)
    sh = state_shardings(bundle, create_train_state(bundle, seed=0), mesh, tensor_parallel=True)
    data = []
    for i in range(2):
        b, d, l, w = local_batch(synthetic_batch(bundle, CTR_BATCH, seed=80 + i,
                                                 ids_per_feature=5), mesh)
        data.append((b, d, l, w))
    state = fit(bundle, data, steps=2, seed=0, mesh=mesh, mode="sharded", log_every=0,
                shardings=sh, checkpoint_dir=ckpt, checkpoint_every=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = restore_checkpoint(ckpt, state, mesh=mesh, shardings=sh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    _assert_same_state(restored, state, "the sharded checkpoint restored onto the ranks")
    del restored
    t0 = time.perf_counter()
    save_checkpoint(ckpt, state, mesh=mesh, shardings=sh)
    save_s = time.perf_counter() - t0
    whole = gather_state(bundle, state, mesh, sh)
    out = {"step": int(state.step), "restore_s": restore_s, "save_s": save_s,
           "bytes": os.path.getsize(os.path.join(ckpt, str(int(state.step)), "state.pt")),
           "digest": _digest({"params": whole.params, "opt_state": whole.opt_state,
                              "tables": whole.tables, "step": int(whole.step)})}
    del bundle, state, whole
    torch.cuda.empty_cache()
    return out


def _mesh2d_rank(rank, world, store, tmp, card):
    """One rank of phase 17 in a process of its own: joins the gloo group
    of ``world`` ranks through the file ``store``, builds the data 1 x
    model 2 mesh on the card, runs the phase's models, the witness and the
    checkpoint, and writes what it found to ``tmp/rank{rank}.json``."""
    import torch.distributed as dist
    from datetime import timedelta

    from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
    from recommendsystem_tpu_torch.core.mesh import create_mesh
    from recommendsystem_tpu_torch.models import create_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=MESH2D_TIMEOUT_S))
    try:
        mesh = create_mesh("cuda", model_parallel=world)
        out = {"rank": rank, "data_index": mesh.rank, "model_index": mesh.model_rank,
               "backends": {"world": dist.get_backend(), "data": dist.get_backend(mesh.group),
                            "model": dist.get_backend(mesh.model_group)}, "train": {}}
        bf16 = {"table_dtype": torch.bfloat16, "opt_state_dtype": torch.bfloat16,
                "compute_dtype": torch.bfloat16}
        ctr212 = {"cfg": synthetic_ctr_config(num_slots=180, num_bias=32),
                  "bucket_size": CTR212_BUCKET}
        for name, model, kw, b, ipf, placement in (
                ("ctr", "ctr", {}, CTR_BATCH, 5, "tensor"),
                ("rough_rank", "rough_rank", {"stacked_experts": True}, ROUGH_BATCH, 5,
                 "expert"),
                ("staytime", "staytime", {}, STAYTIME_BATCH, 5, "tensor"),
                ("ctr212", "ctr", ctr212, CTR212_BATCH, {}, "tensor"),
                ("ctr_bf16", "ctr", bf16, CTR_BATCH, 5, "tensor")):
            out["train"][name] = _mesh2d_model(mesh, card, name, model, kw, b, ipf, placement)
            log(f"rank {rank} 2-D {name}:", json.dumps(
                {k: v for k, v in out["train"][name].items() if k != "launches"}))
        small = {"bucket_size": 16384}          # phase 8's ctr card-vs-CPU bucket
        out["card_vs_cpu"] = hold_card_to_cpu(
            create_model("ctr", device="cuda", **small), create_model("ctr", device="cpu", **small),
            TOWER_CHECK_BATCH, 5, f"rank {rank} ctr tensor-parallel",
            card_step=_tp_card_step(mesh))
        out["checkpoint"] = _mesh2d_checkpoint(mesh, os.path.join(tmp, "ckpt"))
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def mesh2d_path(card):
    """Phase 17: tensor and expert parallelism on a data 1 x model 2 mesh of
    two processes on the one card (``_mesh2d_rank`` each, started from a
    ``spawn`` context).  NCCL refuses two ranks on one device, so the world
    and the model group are gloo's over the card's tensors (the model
    axis's collectives staged through pinned host memory,
    ``core.model_axis``) and each one-rank data group NCCL's (the
    exchange's all-to-alls).  Full-width ctr (B = 32768, 5 ids, attention
    dropout 0.2) with ``tensor_parallel=True`` and rough_rank with
    ``stacked_experts=True`` and ``expert_shardings`` (B = 32768); then,
    tensor-parallel at one step a turn, staytime (B = 16384, 5 ids, 46
    storages, K9), the 212-feature ctr (B = 8192, one id a column, K2 and
    K4) and ctr with bf16 tables, moments and compute (B = 32768): each
    rank's placements, a window of the local step and one of the 2-D step
    from one state and batch (``_hold_float32``: losses at
    TRAIN_LOSS_RTOL, the gathered state at the CPU tests' tolerances, an
    entry past them only where the local step with the 2-D step's kinks
    gives its 2-D gradients; ``_hold_policy`` under bf16: losses,
    gradients, and the state after step 1),
    launches a step held to ``MESH2D_LAUNCHES``, the model replicas'
    tables bit-equal, the drop report 0, the collectives' bytes and staged
    host seconds a step, the two steps in turns (local, 2-D, 2-D, local);
    ctr's and staytime's predict call and eval step under the placements
    held to the local ones; a ctr scatter step's sync bytes; ctr's
    tensor-parallel step held to the CPU's local step by ``witness`` at
    CHECK_SEEDS (B = 64); the sharded checkpoint from ``fit`` restored onto
    the ranks and, here, locally onto the card, bit for bit.  Any failure
    in a rank fails the phase."""
    import multiprocessing as mp
    import shutil
    import tempfile

    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.train.checkpoint import restore_checkpoint
    from recommendsystem_tpu_torch.train.state import create_train_state

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()            # the ranks share the card with this process
    tmp = tempfile.mkdtemp(prefix="mesh2d.")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mesh2d_rank,
                             args=(r, MESH2D_RANKS, os.path.join(tmp, "store"), tmp, card))
                 for r in range(MESH2D_RANKS)]
        for p in procs:
            p.start()
        deadline = time.perf_counter() + MESH2D_TIMEOUT_S
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed or time.perf_counter() > deadline:
                for p in procs:
                    p.kill()
                    p.join()
                raise AssertionError(f"phase 17: a rank failed (exit codes "
                                     f"{[p.exitcode for p in procs]})")
            procs[0].join(timeout=1.0)
        codes = [p.exitcode for p in procs]
        if codes != [0] * MESH2D_RANKS:
            raise AssertionError(f"phase 17: ranks exited {codes}")
        ranks = []
        for r in range(MESH2D_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
        out = ranks[0]
        # the sharded checkpoint restored here, locally on the card
        bundle = create_model("ctr", device="cuda")
        t0 = time.perf_counter()
        restored = restore_checkpoint(os.path.join(tmp, "ckpt"), create_train_state(bundle,
                                                                                  seed=1))
        torch.cuda.synchronize()
        out["checkpoint"]["local_restore_s"] = time.perf_counter() - t0
        got = _digest({"params": restored.params, "opt_state": restored.opt_state,
                       "tables": restored.tables, "step": int(restored.step)})
        got = json.loads(json.dumps(got))
        if got != out["checkpoint"]["digest"]:
            raise AssertionError("the sharded checkpoint restored locally differs from the "
                                 "state gathered from the ranks")
        del bundle, restored
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["checkpoint"].pop("digest")
    out["checkpoint"]["local_restore_equal"] = True
    launches = {}
    for r in ranks:
        for m in r["train"].values():
            for k, v in m["launches"].items():
                launches[k] = launches.get(k, 0) + v
    out["launches"] = launches
    out["rank1"] = {name: {k: ranks[1]["train"][name][k] for k in (
        "launches_per_step", "collectives_per_step", "replicas_equal")}
        for name in ranks[1]["train"]}
    out["card"] = card
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def _mesh2d_line(out):
    """Phase 17's JSON line: each model's 2-D and local ms a step,
    launches a step and collectives a step, the checkpoint's numbers, the
    phase's seconds."""
    return {"train": {m: {k: r[k] for k in (
        "batch", "placement", "split_leaves", "mesh2d_ms", "local_ms", "launches_per_step",
        "collectives_per_step", "scatter_collectives_per_step", "replicas_equal",
        "drop_report_rows", "past_tolerance", "profile") if k in r}
        for m, r in out["train"].items()},
        "predict_launches": {m: r["predict_launches"] for m, r in out["train"].items()
                             if "predict_launches" in r},
        "checkpoint": out["checkpoint"], "backends": out["backends"],
        "phase_s": out["phase_s"], "card": out["card"]}


# phase 18: the Criteo path of scripts/torch_auc_parity_criteo.py.  A train
# step over the 39 columns (26 categorical of 2 ids, 13 integer of 1)
# launches one of each training kernel, a predict call K1, K2 and K6
CRITEO_TRAIN_LAUNCHES = {"fold_mean": 1, "fold_rows": 1, "unfold_mean": 1, "unfold_rows": 1,
                         "field_attention": 1, "field_attention_bwd": 1,
                         "sparse_adam_update": 1}
CRITEO_PREDICT_LAUNCHES = {"fold_mean": 1, "fold_rows": 1, "interacting_attention": 1}
CRITEO_AUC_BOUND = 0.003          # one seed's test AUC against the JAX 3-seed mean
CRITEO_MIN_AUC = 0.70             # the bf16 modes: a model that learned
CRITEO_PREDICT_CHECK = 4          # test batches of the trained state held to the CPU


def _auc_parity_script():
    """``scripts/torch_auc_parity_criteo.py`` as a module (its functions are
    shared, not copied)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_auc_parity_criteo.py")
    spec = importlib.util.spec_from_file_location("torch_auc_parity_criteo", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _only(counts):
    return {k: v for k, v in counts.items() if v}


def criteo_quality_path(card):
    """Phase 18: the port's autoint trained on the Criteo path at the
    configuration of ``AUC_PARITY.json`` (``torch_auc_parity_criteo.py``'s
    constants: 120,000 training and 20,000 test rows written and parsed
    once, 39 columns over 50,000-row tables, B 512, dropout 0.2).  The
    launches of one train step and one predict call held to
    ``CRITEO_TRAIN_LAUNCHES`` and ``CRITEO_PREDICT_LAUNCHES``, with no host
    sync in either; two card steps held to the CPU by ``witness`` at B 64
    and each of ``CHECK_SEEDS`` (categorical columns 2 ids, integer ones 1,
    as the parse pads them); then seed 0 trained for 3 epochs (702 steps)
    in each mode, every run's launches held to 702 steps and 39 predict
    calls: float32's test AUC within ``CRITEO_AUC_BOUND`` of the JAX mean,
    its trained state's predict outputs equal to the CPU's (``SCORE_TOL``);
    bf16 storage and bf16 compute finite with AUC above
    ``CRITEO_MIN_AUC``, their deltas reported."""
    import tempfile

    from recommendsystem_tpu_torch.data.criteo import CAT_SLOTS, INT_SLOTS
    from recommendsystem_tpu_torch.train import make_predict_step, make_train_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    q = _auc_parity_script()
    t_phase = time.perf_counter()
    with open(q.JAX_RECORD) as fh:
        jax_means = json.load(fh)["summary"]["jax"]
    out = {"card": card, "jax": jax_means}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_criteo_") as root:
        train_path, test_path = q.write_files(root, q.N_TRAIN, q.N_TEST)
        embedding = q.make_bundle("float32", "cpu").embedding
        train_b = q.load_batches(train_path, embedding, "cuda")
        test_b = q.load_batches(test_path, embedding, "cuda")
    out["data_s"] = time.perf_counter() - t0
    out["batches"] = {"train": len(train_b), "test": len(test_b)}
    widths = {k: v.rows.shape[1] for k, v in train_b[0][0].items()}
    if widths != {**{s: 1 for s in INT_SLOTS}, **{s: 2 for s in CAT_SLOTS}}:
        raise AssertionError(f"criteo batch widths {widths}")
    log(f"criteo: {len(train_b)} train and {len(test_b)} test batches in "
        f"{out['data_s']:.1f} s")

    # one train step and one predict call: exact launches, no host sync
    bundle = q.make_bundle("float32", "cuda")
    cpu_bundle = q.make_bundle("float32", "cpu")
    step, predict = make_train_step(bundle), make_predict_step(bundle)
    state = create_train_state(bundle, seed=5)
    (batch, labels, weight), test_batch = train_b[0], test_b[0][0]
    state, _ = step(state, batch, labels, weight, None, seed=0)
    predict(state, test_batch)
    total = {}
    (state, _), per_step = _count(lambda: step(state, batch, labels, weight, None, seed=1))
    _, per_call = _count(lambda: predict(state, test_batch))
    out["launches_per_step"], out["launches_per_call"] = _only(per_step), _only(per_call)
    if out["launches_per_step"] != CRITEO_TRAIN_LAUNCHES:
        raise AssertionError(f"criteo train step launched {out['launches_per_step']}, "
                             f"expected {CRITEO_TRAIN_LAUNCHES}")
    if out["launches_per_call"] != CRITEO_PREDICT_LAUNCHES:
        raise AssertionError(f"criteo predict call launched {out['launches_per_call']}, "
                             f"expected {CRITEO_PREDICT_LAUNCHES}")
    _add(total, per_step)
    _add(total, per_call)
    runs = {"train": lambda: step(state, batch, labels, weight, None, seed=2),
            "predict": lambda: predict(state, test_batch)}
    syncs = {}
    for kind in ("train", "predict", "train", "predict"):     # the second is the steady one
        syncs[kind] = _count_syncs(runs[kind])
    out["syncs"] = {k: len(v) for k, v in syncs.items()}
    if syncs["train"] or syncs["predict"]:
        raise AssertionError(f"criteo host syncs: a train step {syncs['train']}, a predict "
                             f"call {syncs['predict']}")

    # two card steps against the CPU plain path, the parse's widths
    t0 = time.perf_counter()
    ipf = {s: 2 for s in CAT_SLOTS}            # unlisted (integer) columns take 1 id
    out["card_vs_cpu"] = hold_card_to_cpu(bundle, cpu_bundle, CHECK_BATCH, ipf, "criteo")
    out["cpu_check_s"] = time.perf_counter() - t0

    # trained runs, seed 0, each in a window of counts
    want = {k: len(train_b) * q.EPOCHS * v for k, v in CRITEO_TRAIN_LAUNCHES.items()}
    _add(want, {k: len(test_b) * v for k, v in CRITEO_PREDICT_LAUNCHES.items()})
    out["runs"] = {}
    for mode in q.MODES:
        (r, trained), counts = _count(lambda: q.run(mode, 0, train_b, test_b, "cuda"))
        r["launches"] = _only(counts)
        out["runs"][mode] = r
        log(f"criteo {mode} seed 0:", json.dumps(r))
        if r["launches"] != want:
            raise AssertionError(f"criteo {mode} run launched {r['launches']}, expected {want}")
        _add(total, counts)
        if mode == "float32":
            if abs(r["auc"] - jax_means["auc_mean"]) > CRITEO_AUC_BOUND:
                raise AssertionError(f"criteo float32 test AUC {r['auc']:.5f} is more than "
                                     f"{CRITEO_AUC_BOUND} from the JAX mean "
                                     f"{jax_means['auc_mean']:.5f}")
            cpu_state = _cpu_state(trained)
            cpu_predict = make_predict_step(cpu_bundle)
            for b, _, _ in test_b[:CRITEO_PREDICT_CHECK]:
                got = predict(trained, b)[q.TASK].cpu().numpy()
                cpu_b = {k: v.to("cpu") for k, v in b.items()}
                np.testing.assert_allclose(got, cpu_predict(cpu_state, cpu_b)[q.TASK].numpy(),
                                           **SCORE_TOL)
        elif not r["auc"] > CRITEO_MIN_AUC:
            raise AssertionError(f"criteo {mode} test AUC {r['auc']:.5f} <= {CRITEO_MIN_AUC}")
        r["auc_delta_jax"] = r["auc"] - jax_means["auc_mean"]
        r["logloss_delta_jax"] = r["logloss"] - jax_means["logloss_mean"]
        r["auc_delta_float32"] = r["auc"] - out["runs"]["float32"]["auc"]
        r["logloss_delta_float32"] = r["logloss"] - out["runs"]["float32"]["logloss"]
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"criteo phase: {out['phase_s']:.1f} s")
    return out


def _criteo_line(out):
    """Phase 18's JSON line: each run's quality and speed, the launches."""
    return {"runs": {m: {k: r[k] for k in (
        "auc", "logloss", "auc_delta_jax", "logloss_delta_jax", "auc_delta_float32",
        "logloss_delta_float32", "steps", "train_s", "examples_per_s")}
        for m, r in out["runs"].items()},
        "launches_per_step": out["launches_per_step"],
        "launches_per_call": out["launches_per_call"], "syncs": out["syncs"],
        "data_s": out["data_s"], "phase_s": out["phase_s"], "card": out["card"]}


def phase18_alone(card) -> int:
    """``--phase 18``: build the kernels and run phase 18 alone, its JSON
    line printed; no kernels line and no ok line (a whole run gives them)."""
    from recommendsystem_tpu_torch.kernels import build_all

    build_all()
    out = criteo_quality_path(card)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_phase18.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({"criteo_quality": _criteo_line(out)}), flush=True)
    return 0


def phase17_alone(card) -> int:
    """``--phase 17``: build the kernels and run phase 17 alone, its JSON
    line printed; no kernels line and no ok line (a whole run gives them)."""
    from recommendsystem_tpu_torch.kernels import build_all

    build_all()
    out = mesh2d_path(card)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_phase17.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({"mesh2d": _mesh2d_line(out)}), flush=True)
    return 0


def phase16_alone(card) -> int:
    """``--phase 16``: build the kernels and run phase 16 alone, its JSON
    line printed; no kernels line and no ok line (a whole run gives them)."""
    from recommendsystem_tpu_torch.kernels import build_all

    build_all()
    out = sharded_path(card)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_phase16.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({"sharded": _sharded_line(out)}), flush=True)
    return 0


def phase15_alone(card) -> int:
    """``--phase 15``: build the kernels and run phase 15 alone, its JSON
    line printed; no kernels line and no ok line (a whole run gives them)."""
    from recommendsystem_tpu_torch.kernels import build_all

    build_all()
    out = export_path(card, _spin_cycles_per_ms())
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_phase15.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({"export": _export_line(out)}), flush=True)
    return 0


def _export_line(out):
    """Phase 15's JSON line: each case's ms and launches, the dispatch cost."""
    return {"predict": [{k: c[k] for k in ("model", "b", "ids_per_feature", "ms_per_call",
                                          "launches_per_call", "export_s", "load_s")}
                        for c in out["cases"]],
            "dispatch_us": {m: {op: {mode: d[mode]["dispatch_us"] for mode in d}
                                for op, d in v.items()}
                            for m, v in out["dispatch"].items()},
            "phase_s": out["phase_s"], "card": out["card"]}


# the float32 launches a step of the train steps phase 14 holds its windows
# to, for ``--phase 14`` alone (phases 5 and 8 measure them in a whole run)
PACKED_MEAN_ATTN_LAUNCHES = {"fold_mean": 1, "unfold_mean": 1, "field_attention": 1,
                             "field_attention_bwd": 1, "sparse_adam_update": 1}


def phase14_alone(card) -> int:
    """``--phase 14``: build the kernels and run phase 14 alone, its JSON
    line printed; no kernels line and no ok line (a whole run gives them)."""
    from recommendsystem_tpu_torch.kernels import build_all

    build_all()
    out = bf16_compute_path(card, _spin_cycles_per_ms(),
                            {"autoint": PACKED_MEAN_ATTN_LAUNCHES,
                             "ctr": PACKED_MEAN_ATTN_LAUNCHES})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_phase14.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps({"bf16_compute": {k: out[k] for k in ("train", "predict",
                                                          "card_vs_cpu")}}), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available; this script runs on a card")
        return 2
    from recommendsystem_tpu_torch.data import synthetic_batch
    from recommendsystem_tpu_torch.embedding import packed
    from recommendsystem_tpu_torch.kernels import (build_all, launch_counts,
                                                   reset_launch_counts)
    from recommendsystem_tpu_torch.models import create_model
    from recommendsystem_tpu_torch.models.autoint import TASK
    from recommendsystem_tpu_torch.serving import ScoringService
    from recommendsystem_tpu_torch.train import make_predict_step
    from recommendsystem_tpu_torch.train.state import create_train_state

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 as the CPU computes it
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if sys.argv[1:] == ["--phase", "14"]:
        return phase14_alone(card)
    if sys.argv[1:] == ["--phase", "15"]:
        return phase15_alone(card)
    if sys.argv[1:] == ["--phase", "16"]:
        return phase16_alone(card)
    if sys.argv[1:] == ["--phase", "17"]:
        return phase17_alone(card)
    if sys.argv[1:] == ["--phase", "18"]:
        return phase18_alone(card)

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build_logs = build_all()
    report["build_s"] = time.perf_counter() - t0
    for name, text in build_logs.items():
        log(f"--- nvcc {name} ---\n{text.strip()}")
    log(f"kernels built in {report['build_s']:.1f} s")

    # -- 2. kernels against their plain versions -----------------------------
    bundle = create_model("autoint", bucket_size=FULL_BUCKET, device="cuda")
    state = create_train_state(bundle, seed=0)
    eng = bundle.embedding
    skeys = sorted(eng.storage)          # 24 storages of one table each
    tables = [state.tables[k]["w"] for k in skeys]
    cycles_per_ms = _spin_cycles_per_ms()
    cases = []
    for b in SERVE_BUCKETS + (BIG_BATCH,):
        for ipf, name in ((5, "fold_mean"), (1, "fold_rows")):
            batch, _, _, _ = synthetic_batch(bundle, b, seed=b + ipf,
                                             ids_per_feature=ipf)
            plans = packed.plan_segments(eng, batch, storages={skeys[0]})
            (seg,) = plans[skeys[0]]
            ids, mask = packed.storage_stream(eng, skeys[0], plans[skeys[0]], batch)
            cases.append(fold_case(name, tables, ids, mask, len(seg.keys), seg.l,
                                   cycles_per_ms))
        for f in (24, 175):
            cases.append(attention_case(2, 4, f, b, f + b, cycles_per_ms))
    # the train path's kernels, at the train batch
    for b in (4096, BIG_BATCH):
        for ipf, name in ((5, "unfold_mean"), (1, "unfold_rows")):
            batch = synthetic_batch(bundle, b, seed=b + ipf + 1, ids_per_feature=ipf)[0]
            cases.append(unfold_case(name, eng, skeys[0], batch, cycles_per_ms))
    # K1 and K3 as the steps launch them: one grouped call over 24 columns
    for b in (256, BIG_BATCH):
        cases.append(fold_group_case(bundle, state, b, cycles_per_ms))
        cases.append(autoint_rows_case(bundle, state, b, cycles_per_ms))
        cases.append(unfold_group_case(bundle, b, cycles_per_ms))
    # K4 as the 1-id train step launches it: one grouped call over 24 columns
    for b in (4096, BIG_BATCH):
        cases.append(unfold_rows_group_case(f"autoint 24 columns, b={b}", bundle, b, b + 31,
                                            cycles_per_ms))
    cases += group_check_case("mixed", MIXED_GROUP,
                              {"fold_mean": 1, "fold_rows": 1, "unfold_mean": 1})
    # the folds take 64 members a launch, K3 512
    cases += group_check_case("65 members", GROUP_65,
                              {"fold_mean": 2, "fold_rows": 2, "unfold_mean": 1})
    batch = synthetic_batch(bundle, BIG_BATCH, seed=5)[0]
    cases.append(adam_case(eng, state.tables, batch, cycles_per_ms))
    cases.append(adam_mixed_case())
    cases.append(attention_case(2, 4, 175, BIG_BATCH, 98, cycles_per_ms, rate=DROPOUT))
    cases.append(attention_case(2, 4, 24, BIG_BATCH, 99, cycles_per_ms, rate=DROPOUT))
    cases.append(attention_bwd_case(2, 4, 24, BIG_BATCH, 7, cycles_per_ms))
    cases.append(attention_bwd_case(2, 4, 175, 8192, 8, cycles_per_ms))
    for c in cases:
        log(json.dumps(c))
    report["cases"] = cases

    # -- 3. the main path: full-width autoint serving ------------------------
    rng = np.random.default_rng(0)
    rows200 = raw_rows(rng, 200, 5)
    cpu_state = _cpu_state(state)
    cpu_bundle = create_model("autoint", bucket_size=FULL_BUCKET, device="cpu")

    rows_single = raw_rows(rng, 100, 1)
    # one window of counts for the whole main path: both services
    reset_launch_counts()
    svc = ScoringService(bundle, state, max_batch=256, ids_per_feature=5)
    svc.warmup()
    s200 = svc.score(rows200)[TASK]
    s3 = svc.score(rows200[:3])[TASK]
    over_http = http_score(svc, rows200[:50])
    serve5 = launch_counts()
    svc1 = ScoringService(bundle, state, max_batch=256, ids_per_feature=1)
    svc1.warmup()
    s1 = svc1.score(rows_single)[TASK]
    serving = launch_counts()
    serve1 = {k: serving[k] - serve5[k] for k in serving}

    check_scores(s200, 200)
    np.testing.assert_allclose(s3, s200[:3], **SCORE_TOL)     # padding 200->256 vs 3->8
    np.testing.assert_allclose(over_http["scores"][TASK], s200[:50], **SCORE_TOL)
    cpu_svc = ScoringService(cpu_bundle, cpu_state, max_batch=256,
                             ids_per_feature=5, device="cpu")
    np.testing.assert_allclose(s200, cpu_svc.score(rows200)[TASK], **SCORE_TOL)
    check_scores(s1, 100)
    cpu_svc1 = ScoringService(cpu_bundle, cpu_state, max_batch=256,
                              ids_per_feature=1, device="cpu")
    np.testing.assert_allclose(s1, cpu_svc1.score(rows_single)[TASK], **SCORE_TOL)
    report["serve_launches"] = {"main_path": serving, "ids_per_feature_5": serve5,
                                "ids_per_feature_1": serve1}
    log("serving launches:", json.dumps(report["serve_launches"]))
    for kname, counts in (("fold_mean", serve5), ("interacting_attention", serve5),
                          ("fold_rows", serve1)):
        if counts[kname] < 1:
            raise AssertionError(f"{kname} was not launched on the serving path")

    # -- 4. predict step: launches per call and throughput --------------------
    step = make_predict_step(bundle)
    per_call = {}
    for ipf in (1, 5):
        for b in (256, BIG_BATCH):
            batch, _, _, _ = synthetic_batch(bundle, b, seed=7, ids_per_feature=ipf)
            step(state, batch)
            torch.cuda.synchronize()
            reset_launch_counts()
            out = step(state, batch)[TASK]
            torch.cuda.synchronize()
            per_call[f"b{b}_ids{ipf}"] = launch_counts()
    for b in (256, BIG_BATCH):
        for ipf, name in ((5, "fold_mean"), (1, "fold_rows")):
            if per_call[f"b{b}_ids{ipf}"][name] != 1:
                raise AssertionError(f"autoint predict b={b}: {name} launched "
                                     f"{per_call[f'b{b}_ids{ipf}'][name]} times, not 1")
    check_scores(out.squeeze(1).cpu().numpy(), BIG_BATCH)   # b 65536, 5 ids
    cpu_batch = {k: v.to("cpu") for k, v in batch.items()}
    cpu_out = make_predict_step(cpu_bundle)(cpu_state, cpu_batch)[TASK]
    np.testing.assert_allclose(out.cpu().numpy(), cpu_out.numpy(), **SCORE_TOL)
    iters = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(state, batch)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    report["predict"] = {"batch": BIG_BATCH, "ms_per_call": dt * 1e3,
                         "examples_per_s": BIG_BATCH / dt,
                         "launches_per_call": per_call,
                         "card": card}
    print(json.dumps({"predict": report["predict"]}), flush=True)

    # -- 5. the main path: the full-width packed train step -------------------
    del svc, svc1, cpu_svc, cpu_svc1
    report["train"] = train_path(bundle, cpu_bundle, card)
    training = report["train"]["launches"]
    print(json.dumps({k: report["train"][k] for k in (
        "metric", "value", "unit", "ms_per_step", "window_ms", "batch",
        "launches_per_step", "card")}), flush=True)

    # -- 6. the main path: full-width staytime serving ------------------------
    report["staytime"] = staytime_path(card, cycles_per_ms)
    staytime = report["staytime"]["serve_launches"]
    cases += report["staytime"]["cases"]
    print(json.dumps({"staytime_predict": report["staytime"]["predict"]}), flush=True)

    # -- 7. the main path: K6 on the ctr, multi_head and autoint paths --------
    report["interacting"] = interacting_path(card, cycles_per_ms, (bundle, state),
                                             cpu_bundle, rows200, s200)
    interacting = report["interacting"]["serve_launches"]
    cases += report["interacting"]["cases"]
    print(json.dumps({"interacting_predict": report["interacting"]["predict"]}), flush=True)

    # -- 8. the main path: ctr, multi_head and finish training; finish serving
    report["towers"] = tower_train_path(card, cycles_per_ms)
    report["finish"] = finish_serving_path(card)
    towers = {k: v + report["finish"]["launches"][k]
              for k, v in report["towers"]["launches"].items()}
    cases += report["towers"]["cases"]
    print(json.dumps({"tower_train": {k: {f: v[f] for f in (
        "metric", "value", "unit", "ms_per_step", "window_ms", "batch", "launches_per_step")}
        for k, v in report["towers"]["train"].items()},
        "finish_predict": report["finish"]["predict"], "card": card}), flush=True)

    # -- 9. the main path: rough_rank training and serving; stacked experts --
    report["rough_rank"] = rough_rank_path(card, cycles_per_ms)
    rough = report["rough_rank"]["launches"]
    cases += report["rough_rank"]["cases"]
    stacked = report["stacked_serving"] = stacked_serving_path()
    print(json.dumps({"rough_rank": {
        "train": {k: {f: v[f] for f in ("metric", "value", "unit", "ms_per_step", "window_ms",
                                         "batch", "launches_per_step")}
                  for k, v in report["rough_rank"]["train"].items()},
        "predict": report["rough_rank"]["predict"]}, "card": card}), flush=True)

    # -- 10. the main path: full-width staytime training ---------------------
    report["staytime_train"] = staytime_train_path(card, cycles_per_ms)
    staytime_train = report["staytime_train"]["launches"]
    cases += report["staytime_train"]["cases"]
    print(json.dumps({"staytime_train": {
        k: {f: v[f] for f in ("metric", "value", "unit", "ms_per_step", "window_ms", "batch",
                              "launches_per_step")}
        for k, v in report["staytime_train"]["train"].items()}, "card": card}), flush=True)

    # -- 11. the main path: the eval path of every model; streaming GAUC -----
    report["eval"] = eval_path(card, cycles_per_ms, (bundle, state, cpu_bundle))
    evaluation = report["eval"]["launches"]
    print(json.dumps({"eval": {
        "models": {k: {f: v[f] for f in (
            "batch", "ids_per_feature", "eval_examples_per_s", "predict_examples_per_s",
            "eval_ms", "predict_ms", "metric_update_ms", "syncs_per_eval_step",
            "syncs_per_predict", "launches_per_step")}
            for k, v in report["eval"]["models"].items()},
        "auc_update": report["eval"]["auc_update"],
        "gauc_update": report["eval"]["gauc"]["update_times"], "card": card}}), flush=True)

    # -- 12. the main path: the daily trainer, the checkpoint, the server ----
    report["daily"] = daily_path(card)
    daily = report["daily"]["launches"]
    print(json.dumps({"daily": {
        "loader": report["daily"]["loader"], "checkpoint": report["daily"]["checkpoint"],
        **{m: {f: report["daily"][m][f] for f in ("train_examples_per_s", "step_ms", "wall_s")}
           for m in ("staytime", "finish")},
        "staytime_day_examples_per_s": report["daily"]["staytime"]["day_examples_per_s"],
        "batch": DAILY_BATCH, "card": card}}), flush=True)

    # -- 13. the main path: bf16 tables and moments; the classic updates ------
    report["bf16"] = bf16_path(card, cycles_per_ms, report["train"]["launches_per_step"])
    bf16 = report["bf16"]["launches"]
    cases += report["bf16"]["cases"]
    print(json.dumps({"bf16": {
        "tables": report["bf16"]["tables"],
        "train": {m: {k: {f: v.get(f) for f in ("value", "ms_per_step", "batch",
                                                "launches_per_step", "w_live_entries",
                                                "w_moved_step1")}
                      for k, v in r.items()} for m, r in report["bf16"]["train"].items()},
        "classic": {k: v["launches"] for k, v in report["bf16"]["classic"].items()},
        "card": card}}), flush=True)

    # -- 14. the main path: the bf16 compute policy ---------------------------
    report["bf16_compute"] = bf16_compute_path(card, cycles_per_ms, {
        "autoint": report["train"]["launches_per_step"]["ids5"],
        "ctr": report["towers"]["train"]["ctr"]["launches_per_step"]})
    compute = report["bf16_compute"]["launches"]
    cases += report["bf16_compute"]["cases"]
    print(json.dumps({"bf16_compute": {
        "train": {m: {"value": r["value"], "ms_per_step": r["ms_per_step"], "batch": r["batch"],
                      "launches_per_step": r["launches_per_step"], "in_turns": r["in_turns"]}
                  for m, r in report["bf16_compute"]["train"].items()},
        "predict": report["bf16_compute"]["predict"],
        "card_vs_cpu": report["bf16_compute"]["card_vs_cpu"], "card": card}}), flush=True)

    # -- 15. the main path: the serving export, loaded and scored ------------
    report["export"] = export_path(card, cycles_per_ms)
    exported = report["export"]["launches"]
    print(json.dumps({"export": _export_line(report["export"])}), flush=True)

    # -- 16. the main path: the sharded mode on a one-rank NCCL group --------
    report["sharded"] = sharded_path(card)
    sharded = report["sharded"]["launches"]
    print(json.dumps({"sharded": _sharded_line(report["sharded"])}), flush=True)

    # -- 17. the main path: tensor and expert parallelism on a 2-D mesh -------
    report["mesh2d"] = mesh2d_path(card)
    mesh2d = report["mesh2d"]["launches"]
    print(json.dumps({"mesh2d": _mesh2d_line(report["mesh2d"])}), flush=True)

    # -- 18. the main path: autoint trained on the Criteo path ---------------
    report["criteo"] = criteo_quality_path(card)
    criteo = report["criteo"]["launches"]
    print(json.dumps({"criteo_quality": _criteo_line(report["criteo"])}), flush=True)

    # -- report ----------------------------------------------------------------
    # the serving folds at the largest serving bucket, the train kernels
    # (K5 among them: the serving paths take K6) at the train batch, the
    # last case there being K5f with dropout; attention at autoint's F = 24;
    # the DIN pool at the staytime bulk batch; K6 at autoint's predict batch
    # and F = 24
    headline = {}
    fp32 = [c for c in cases
            if c.get("dtype", "fp32") == "fp32" and c.get("compute", "fp32") == "fp32"]
    for c in fp32:
        serve = c["name"] in ("fold_mean", "fold_rows")
        want_b = STAYTIME_BATCH if c["name"] == "din_pool" else (
            256 if serve else BIG_BATCH)
        # K1, K2, K3 and K4: their grouped call over autoint's 24 columns, as
        # the steps launch them; K7 as the predict step launches it,
        # gathering its facts
        grouped = (c["name"] not in ("fold_mean", "fold_rows", "unfold_mean", "unfold_rows")
                   or c.get("group") == 24)
        if c["name"] == "din_pool":
            grouped = c.get("entry") == "gather"
        if c["name"] == "sparse_adagrad_update":
            if c.get("storages") == 46:        # staytime's train step
                headline[c["name"]] = c
            continue
        if c.get("b", BIG_BATCH) == want_b and c.get("f", 24) == 24 and grouped:
            headline[c["name"]] = c
    sources = {"fold_mean": ("recommendsystem_tpu_torch/csrc/fold.cu",
                             "recommendsystem_tpu/embedding/packed.py:273"),
               "fold_rows": ("recommendsystem_tpu_torch/csrc/fold.cu",
                             "recommendsystem_tpu/embedding/packed.py:327"),
               "field_attention": (
                   "recommendsystem_tpu_torch/csrc/field_attention.cu",
                   "recommendsystem_tpu/kernels/field_attention_pallas.py:98"),
               "field_attention_bwd": (
                   "recommendsystem_tpu_torch/csrc/field_attention.cu",
                   "recommendsystem_tpu/kernels/field_attention_pallas.py:111"),
               "unfold_mean": ("recommendsystem_tpu_torch/csrc/unfold_scatter.cu",
                               "recommendsystem_tpu/embedding/packed.py:365"),
               "unfold_rows": ("recommendsystem_tpu_torch/csrc/unfold_scatter.cu",
                               "recommendsystem_tpu/embedding/packed.py:416"),
               "sparse_adam_update": ("recommendsystem_tpu_torch/csrc/sparse_adam.cu",
                                      "recommendsystem_tpu/embedding/packed.py:1099"),
               "din_pool": ("recommendsystem_tpu_torch/csrc/din_pool.cu",
                            "recommendsystem_tpu/kernels/din_pallas.py:72"),
               "interacting_attention": (
                   "recommendsystem_tpu_torch/csrc/interacting.cu",
                   "recommendsystem_tpu/kernels/interacting_pallas.py:107"),
               "sparse_adagrad_update": ("recommendsystem_tpu_torch/csrc/sparse_adagrad.cu",
                                         "recommendsystem_tpu/embedding/optimizers.py:99")}
    kernels = []
    for name, (source, replaces) in sources.items():
        c = headline[name]
        launches = (serving[name] + training[name] + staytime[name] + interacting[name]
                    + towers[name] + rough[name] + stacked[name] + staytime_train[name]
                    + evaluation[name] + daily[name] + bf16.get(name, 0)
                    + compute.get(name, 0) + exported.get(name, 0)
                    + sharded.get(name, 0) + mesh2d.get(name, 0) + criteo.get(name, 0))
        if launches < 1:
            raise AssertionError(f"{name} was not launched on the main paths")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in fp32 if x["name"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "host_ms": c["host_ms"], "b": c.get("b", BIG_BATCH)})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
