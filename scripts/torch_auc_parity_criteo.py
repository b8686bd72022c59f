#!/usr/bin/env python3
"""Trained quality of the port: its autoint trained on a synthetic file in
the Criteo layout, test AUC and logloss, against the JAX package's.

    python3 scripts/torch_auc_parity_criteo.py [--mode all] [--seeds 0 1 2]
        [--epochs 3] [--n-train 120000] [--n-test 20000]
        [--device cuda] [--out AUC_PARITY_TORCH.json]

The port's counterpart of the JAX side of ``scripts/auc_parity_criteo.py``,
with its constants: the same two files (``write_synthetic_criteo``, seed 0
for training, seed 99 for test; written into a directory of this run's
own), 39 mean columns of width 8 over 50,000-row tables, attention
dropout 0.2, B 512 with the remainder dropped, 3 epochs, sparse Adam at
1e-2 and dense Adam at 3e-3, seeds 0, 1 and 2.  Each seed seeds the initial
state (``create_train_state``) and the stream of step seeds (dropout;
``harness.seed_stream``), so the runs are independent, as the JAX script's
are: the claim is parity within run-to-run variance.  The modes:

- ``float32``: ``criteo_autoint(dim=8, bucket_size=50000, sparse_lr=1e-2,
  dense_lr=3e-3)``;
- ``bf16_storage``: the same with ``table_dtype=torch.bfloat16`` and
  ``opt_state_dtype=torch.bfloat16`` (not ``"auto"``, which stores bf16
  only for D >= 32 and so would store float32 at D 8);
- ``bf16_compute``: ``compute_dtype=torch.bfloat16`` over float32 tables.

Every batch is parsed once and moved to the device before the timed loop.
The test AUC is the exact rank (Mann-Whitney) AUC with ties averaged, as
``sklearn.metrics.roc_auc_score`` computes it; the logloss clips p to
[1e-6, 1 - 1e-6], as the JAX script does.

Bounds, fixed before the first run, held where the run has the JAX
script's configuration (the sizes above and seeds 0, 1 and 2):

- float32: |mean AUC - JAX mean| <= 0.002 and |mean logloss - JAX mean| <=
  0.002, the JAX means from ``AUC_PARITY.json``'s ``summary.jax``
  (0.77401 and 0.57236; their 3-seed std is 0.0005, so 0.002 is about 5
  sigma of a difference of two 3-seed means).  The script exits 1 where
  float32 misses either.
- bf16 modes: the same 0.002 against the port's float32 means.  A miss is
  printed and written under ``findings``; it does not fail the run.

Writes ``AUC_PARITY_TORCH.json`` at the repo root (``--out``) and never
``AUC_PARITY.json``, which it reads.  Runs on the card unless ``--device
cpu`` is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TASK = "video_id_rank_skip_model"
N_TRAIN, N_TEST = 120_000, 20_000
BATCH = 512
EPOCHS = 3
BUCKET = 50_000
LR_SPARSE, LR_DENSE = 1e-2, 3e-3
SEEDS = (0, 1, 2)
DIM = 8
TRAIN_SEED, TEST_SEED = 0, 99
MODES = ("float32", "bf16_storage", "bf16_compute")
BOUND = 0.002
JAX_RECORD = os.path.join(REPO, "AUC_PARITY.json")
OUT = os.path.join(REPO, "AUC_PARITY_TORCH.json")


def mode_kwargs(mode: str) -> dict:
    """The ``criteo_autoint`` arguments of a mode beyond the float32 ones."""
    return {"float32": {},
            "bf16_storage": {"table_dtype": torch.bfloat16,
                             "opt_state_dtype": torch.bfloat16},
            "bf16_compute": {"compute_dtype": torch.bfloat16}}[mode]


def make_bundle(mode: str, device, bucket: int = BUCKET, **kwargs):
    from recommendsystem_tpu_torch.data.criteo import criteo_autoint

    return criteo_autoint(dim=DIM, bucket_size=bucket, sparse_lr=LR_SPARSE,
                          dense_lr=LR_DENSE, device=device, **mode_kwargs(mode), **kwargs)


def write_files(root: str, n_train: int, n_test: int):
    """(train path, test path) written under ``root`` with the port's
    ``write_synthetic_criteo``: seed 0 for training, 99 for test."""
    from recommendsystem_tpu_torch.data.criteo import write_synthetic_criteo

    paths = (os.path.join(root, "criteo_train.tsv"), os.path.join(root, "criteo_test.tsv"))
    write_synthetic_criteo(paths[0], n_train, seed=TRAIN_SEED)
    write_synthetic_criteo(paths[1], n_test, seed=TEST_SEED)
    return paths


def load_batches(path: str, embedding, device, batch_size: int = BATCH):
    """Every full batch of ``path`` as (batch, labels, weight) on ``device``,
    parsed once."""
    from recommendsystem_tpu_torch.data.criteo import criteo_dataset

    return [({k: v.to(device) for k, v in b.items()}, {TASK: l[TASK].to(device)},
             w.to(device))
            for b, _, l, w, _ in criteo_dataset(path, batch_size, embedding)]


def exact_auc(y, p) -> float:
    """The rank (Mann-Whitney) AUC of scores ``p`` for binary labels ``y``,
    tied scores given their average rank: ``roc_auc_score``'s value."""
    y = np.asarray(y, np.float64).ravel() > 0.5
    p = np.asarray(p, np.float64).ravel()
    order = np.argsort(p, kind="mergesort")
    _, first, counts = np.unique(p[order], return_index=True, return_counts=True)
    ranks = np.empty(len(p), np.float64)
    ranks[order] = np.repeat(first + (counts + 1) / 2.0, counts)
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC needs both classes among the labels")
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def logloss(y, p) -> float:
    """Mean binary cross-entropy with p clipped to [1e-6, 1 - 1e-6]."""
    y = np.asarray(y, np.float64).ravel()
    p = np.clip(np.asarray(p, np.float64).ravel(), 1e-6, 1 - 1e-6)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log1p(-p)))


def predict(bundle, state, batches):
    """(labels, scores) of every batch as float64 numpy, one host copy."""
    from recommendsystem_tpu_torch.train import make_predict_step

    step = make_predict_step(bundle)
    scores = torch.cat([step(state, b)[TASK].reshape(-1) for b, _, _ in batches])
    labels = torch.cat([l[TASK].reshape(-1) for _, l, _ in batches])
    return labels.double().cpu().numpy(), scores.double().cpu().numpy()


def train(bundle, state, batches, epochs: int, seed: int, device):
    """``epochs`` passes of the train step over ``batches`` in order, step
    seeds drawn from ``harness.seed_stream(seed + 1000)`` (a seeded
    ``torch.Generator``).  Returns
    (state, each step's loss, the loop's wall seconds: the clock stops after
    a synchronize)."""
    from recommendsystem_tpu_torch.train import make_train_step
    from recommendsystem_tpu_torch.train.harness import seed_stream

    step = make_train_step(bundle)
    seeds = seed_stream(seed + 1000)
    losses = []
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(epochs):
        for b, l, w in batches:
            state, info = step(state, b, l, w, None, seed=next(seeds))
            losses.append(info["loss"])
    _sync(device)
    seconds = time.perf_counter() - t0
    return state, torch.stack(losses).cpu().numpy(), seconds


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(mode: str, seed: int, train_batches, test_batches, device, epochs: int = EPOCHS):
    """One trained run: a fresh state from ``seed``, ``epochs`` over the
    training batches, then the test AUC and logloss."""
    from recommendsystem_tpu_torch.train.state import create_train_state

    bundle = make_bundle(mode, device)
    state = create_train_state(bundle, seed=seed)
    state, losses, seconds = train(bundle, state, train_batches, epochs, seed, device)
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"{mode} seed {seed}: a train loss is not finite")
    y, p = predict(bundle, state, test_batches)
    if not np.all(np.isfinite(p)):
        raise FloatingPointError(f"{mode} seed {seed}: a test score is not finite")
    steps = len(losses)
    examples = steps * next(iter(train_batches[0][0].values())).rows.shape[0]
    return {"mode": mode, "seed": seed, "auc": exact_auc(y, p), "logloss": logloss(y, p),
            "steps": steps, "train_s": seconds, "examples_per_s": examples / seconds,
            "last_loss": float(losses[-1])}, state


def device_info(device) -> dict:
    """The card's name and power limit (``nvidia-smi``, or the device name
    where it is absent) and the torch and CUDA versions."""
    card = None
    if torch.device(device).type == "cuda":
        try:
            card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True, text=True,
                                  check=True).stdout.strip()
        except (OSError, subprocess.CalledProcessError):
            card = torch.cuda.get_device_name(0)
    return {"device": str(device), "card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def summarize(runs, jax, full: bool):
    """Per mode: means, stds, the deltas to the JAX means and to the port's
    float32 means, and where each bound is held.  Returns (summary,
    findings, float32 failed)."""
    summary, findings, failed = {}, [], False
    for mode in MODES:
        rs = [r for r in runs if r["mode"] == mode]
        if not rs:
            continue
        aucs, lls = [r["auc"] for r in rs], [r["logloss"] for r in rs]
        summary[mode] = {"auc_mean": float(np.mean(aucs)), "auc_std": float(np.std(aucs)),
                         "logloss_mean": float(np.mean(lls)),
                         "logloss_std": float(np.std(lls)), "n": len(rs)}
    for mode, s in summary.items():
        s["auc_delta_jax"] = s["auc_mean"] - jax["auc_mean"]
        s["logloss_delta_jax"] = s["logloss_mean"] - jax["logloss_mean"]
        if "float32" in summary:
            f = summary["float32"]
            s["auc_delta_float32"] = s["auc_mean"] - f["auc_mean"]
            s["logloss_delta_float32"] = s["logloss_mean"] - f["logloss_mean"]
        against = "jax" if mode == "float32" else "float32"
        if not full or f"auc_delta_{against}" not in s:
            s["bound"] = None
            continue
        held = (abs(s[f"auc_delta_{against}"]) <= BOUND
                and abs(s[f"logloss_delta_{against}"]) <= BOUND)
        s["bound"] = {"against": against, "limit": BOUND, "held": held}
        if not held:
            text = (f"{mode}: mean AUC {s['auc_mean']:.5f}, logloss {s['logloss_mean']:.5f}; "
                    f"past {BOUND} of the {against} means (AUC delta "
                    f"{s[f'auc_delta_{against}']:+.5f}, logloss delta "
                    f"{s[f'logloss_delta_{against}']:+.5f})")
            findings.append(text)
            failed = failed or mode == "float32"
    return summary, findings, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", choices=MODES + ("all",), default="all")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--n-train", type=int, default=N_TRAIN)
    ap.add_argument("--n-test", type=int, default=N_TEST)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: this script runs on one (--device cpu for the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False      # float32 as the CPU computes it
        torch.backends.cudnn.allow_tf32 = False
    modes = MODES if args.mode == "all" else (args.mode,)
    with open(JAX_RECORD) as fh:
        jax = json.load(fh)["summary"]["jax"]
    full = ((args.n_train, args.n_test, args.epochs, tuple(args.seeds))
            == (N_TRAIN, N_TEST, EPOCHS, SEEDS))

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="torch_auc_parity_") as root:
        train_path, test_path = write_files(root, args.n_train, args.n_test)
        embedding = make_bundle("float32", "cpu").embedding    # the parse hashes by it
        train_b = load_batches(train_path, embedding, device)
        test_b = load_batches(test_path, embedding, device)
    data_s = time.perf_counter() - t0
    print(f"{len(train_b)} train batches x {args.epochs} epochs, {len(test_b)} test batches "
          f"({data_s:.1f} s to write and parse)", flush=True)

    if device.type == "cuda":
        from recommendsystem_tpu_torch.kernels import build_all

        build_all()                  # the kernels' nvcc, outside the first run's clock
    info = device_info(device)
    runs = []
    for mode in modes:
        for seed in args.seeds:
            r, _ = run(mode, seed, train_b, test_b, device, args.epochs)
            r.update(info)
            runs.append(r)
            print(f"{mode} seed {seed}: AUC {r['auc']:.5f}  logloss {r['logloss']:.5f}  "
                  f"({r['steps']} steps, {r['train_s']:.1f} s, "
                  f"{r['examples_per_s']:.0f} examples/s)", flush=True)
    summary, findings, failed = summarize(runs, jax, full)
    out = {"config": {"n_train": args.n_train, "n_test": args.n_test, "batch": BATCH,
                      "epochs": args.epochs, "bucket": BUCKET, "lr_sparse": LR_SPARSE,
                      "lr_dense": LR_DENSE, "seeds": list(args.seeds),
                      "graph": "autoint 39-slot criteo, d=8, u=8, h=2, mlp(32,16), "
                               "dropout 0.2"},
           "jax": jax, "bounds_held": full, "data_s": data_s, **info,
           "runs": runs, "summary": summary, "findings": findings}
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(summary, indent=1))
    for text in findings:
        print("finding:", text, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
