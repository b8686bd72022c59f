#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

1. builds the port's CUDA kernels from ``recommendsystem_tpu_torch/csrc/``
   (one nvcc per source, all at once);
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it (batch buckets 8, 200 and 256, and
   65536; field attention also at F = 175), and times kernel, plain version
   and a library yardstick that the port never calls: device time per call
   (``ms``, calls run back to back behind a spin kernel) and, for the
   kernel, the host's time to issue one call (``host_ms``);
3. drives the main path: the full-width autoint ``ScoringService`` (24
   tables of 265,000 rows x 8, seeded random weights) answers requests
   through ``score()`` and over HTTP, with counts of kernel launches set to 0
   just before and read just after; a second service with one id per feature
   drives the single-id fold; scores are checked finite, in [1e-6, 1],
   unchanged by padding, and equal to the same service run on the CPU
   through the plain versions;
4. times the predict step at batch 65536.

Prints the card's name and power limit, one JSON line ``{"kernels": ...}``,
and last ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Any failure ends the run with a traceback
and a non-zero exit; without CUDA it exits non-zero before printing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12        # float32 outside the tensor cores
FULL_BUCKET = 265000
SERVE_BUCKETS = (8, 200, 256)
BIG_BATCH = 65536
FOLD_TOL = 1e-6                   # a sum of <= 5 float32 products, other order
ATTN_TOL = 2e-5                   # softmax over <= 175 keys, 4-term dots
SCORE_TOL = dict(rtol=1e-5, atol=2e-6)   # float32 products in another order

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


def attention_case(h, dh, f, b, seed, cycles_per_ms):
    from recommendsystem_tpu_torch.kernels.field_attention import (
        field_attention, field_attention_reference)

    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.relu(torch.randn((h, dh, f, b), generator=g, device="cuda"))
               for _ in range(3))
    # the plain version materialises (h, F, F, B) scores: run it in batch
    # chunks of at most ~1 GB each
    chunk = max(1, min(b, (1 << 30) // (4 * h * f * f)))

    def plain():
        return torch.cat([field_attention_reference(q[..., i:i + chunk],
                                                    k[..., i:i + chunk],
                                                    v[..., i:i + chunk])
                          for i in range(0, b, chunk)], dim=3)

    kernel = lambda: field_attention(q, k, v)                     # noqa: E731
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not err <= ATTN_TOL:
        raise AssertionError(f"field_attention F={f} b={b}: max abs err {err}")
    # yardstick: SDPA on a (h*B, F, dh) view, laid out outside the timing
    q3, k3, v3 = (x.permute(0, 3, 2, 1).reshape(h * b, f, dh).contiguous()
                  for x in (q, k, v))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q3, k3, v3)
    lib_out = library().reshape(h, b, f, dh).permute(0, 3, 2, 1)
    lib_err = float((lib_out - want).abs().max())
    nbytes = 16 * h * dh * f * b
    ops = 4 * h * dh * f * f * b + 4 * h * f * f * b   # dots + softmax
    bms, by = bound(nbytes, ops)
    iters = 200 if b <= 256 else 20
    ms, host_ms = timed(kernel, iters, cycles_per_ms)
    return {"name": "field_attention", "b": b, "f": f, "h": h, "dh": dh,
            "max_abs_err": err, "ms": ms, "host_ms": host_ms,
            "plain_ms": timed(plain, max(2, iters // 10), cycles_per_ms)[0],
            "library_ms": timed(library, iters, cycles_per_ms)[0],
            "library_max_abs_err": lib_err,
            "bound_ms": bms, "bound_by": by, "bytes": nbytes, "ops": ops}


def raw_rows(rng, n, max_ids):
    """Request rows of raw int64 feasigns: 1..max_ids ids per feature, with
    one feature in five left out."""
    rows = []
    for _ in range(n):
        row = {}
        for s in range(24):
            if rng.uniform() < 0.8:
                k = int(rng.integers(1, max_ids + 1))
                row[str(1000 + s)] = [int(x) for x in rng.integers(0, 1 << 40, k)]
        rows.append(row)
    return rows


def check_scores(scores, n):
    s = np.asarray(scores)
    if s.shape != (n,) or not np.all(np.isfinite(s)) or s.min() < 1e-6 or s.max() > 1.0:
        raise AssertionError(f"bad scores: shape {s.shape}, range "
                             f"[{np.nanmin(s)}, {np.nanmax(s)}]")


def http_score(svc, rows):
    from recommendsystem_tpu_torch.serving import serve

    httpd = serve(svc, port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            if json.loads(r.read())["status"] != "ok":
                raise AssertionError("healthz not ok")
        req = urllib.request.Request(f"{base}/score",
                                     data=json.dumps({"rows": rows}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)


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
    from recommendsystem_tpu_torch.train.state import TrainState, create_train_state

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

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
    for c in cases:
        log(json.dumps(c))
    report["cases"] = cases

    # -- 3. the main path: full-width autoint serving ------------------------
    rng = np.random.default_rng(0)
    rows200 = raw_rows(rng, 200, 5)
    cpu_state = TrainState(
        params={k: v.cpu() for k, v in state.params.items()}, opt_state=None,
        tables={k: {"w": t["w"].cpu()} for k, t in state.tables.items()})
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
    for kname, counts in (("fold_mean", serve5), ("field_attention", serve5),
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

    # -- report ----------------------------------------------------------------
    headline = {}
    for c in cases:   # the largest serving bucket, at autoint's F = 24
        if c["b"] == 256 and c.get("f", 24) == 24:
            headline[c["name"]] = c
    sources = {"fold_mean": ("recommendsystem_tpu_torch/csrc/fold.cu",
                             "recommendsystem_tpu/embedding/packed.py:273"),
               "fold_rows": ("recommendsystem_tpu_torch/csrc/fold.cu",
                             "recommendsystem_tpu/embedding/packed.py:327"),
               "field_attention": (
                   "recommendsystem_tpu_torch/csrc/field_attention.cu",
                   "recommendsystem_tpu/kernels/field_attention_pallas.py:98")}
    kernels = []
    for name, (source, replaces) in sources.items():
        c = headline[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": serving[name],
            "max_abs_err": max(x["max_abs_err"] for x in cases if x["name"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "host_ms": c["host_ms"], "b": 256})
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
