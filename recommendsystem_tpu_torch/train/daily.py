"""Day-incremental trainer.

Counterpart of ``recommendsystem_tpu/train/daily.py``, the platform
``main.py`` the reference implies but does not ship (SURVEY §2.9:
``create_model_func`` / ``parse_input_func`` are the platform contract;
``trained_delta_days`` at ``rank/multi_head/model.py:9`` implies
day-partitioned incremental state).

    python -m recommendsystem_tpu_torch.train.daily \\
        --model staytime --data-dir /data --state-dir /ckpt \\
        --batch-size 8192 [--today 20260817] [--predict-out preds.tsv] \\
        [--device cpu]

Per run: compute the untrained days from the state dir's marker, stream each
day's TFRecord shards (pinned and copied to the card as they are taken),
fit incrementally from the latest checkpoint, evict rarely seen rows, save
a checkpoint + the day marker, optionally dump predictions for the last
day.  ``--backtest`` evaluates each day before training on it.  The port
runs on the card unless ``--device cpu``.  ``--table-dtype`` (fp32, bf16,
auto) stores the tables as the JAX trainer's flag does, and passes to the
model's factory; ``--compute-dtype bf16`` trains the dense tower under the
bf16 compute policy, as the JAX trainer's flag does (master params, the
loss and the optimizers stay float32).
"""

from __future__ import annotations

import argparse
import inspect
import json
import logging
import os
from typing import Optional

import torch

from ..data.loader import balance_batches, dataset_reader
from ..data.parse import make_ctr_parse_fn, make_staytime_parse_fn
from ..models import MODEL_REGISTRY, create_model
from ..models.base import compute_dtype_kwargs, table_dtype_kwargs
from ..utils.dates import trained_delta_days
from .checkpoint import save_checkpoint
from .harness import dump_predict, evaluate, fit

log = logging.getLogger("recommendsystem_tpu_torch.daily")

MARKER = "last_trained_day.json"


def read_marker(state_dir: str) -> Optional[str]:
    path = os.path.join(state_dir, MARKER)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)["last_trained_day"]
    return None


def write_marker(state_dir: str, day: str) -> None:
    with open(os.path.join(state_dir, MARKER), "w") as f:
        json.dump({"last_trained_day": day}, f)


def build_parse_fn(bundle, args):
    if bundle.name == "staytime":
        return make_staytime_parse_fn(bundle.embedding,
                                      ids_per_feature=args.ids_per_feature)
    task = next(iter(bundle.losses))
    return make_ctr_parse_fn(bundle.embedding, label_key=args.label_key,
                             task_name=task,
                             ids_per_feature=args.ids_per_feature,
                             dense_keys=tuple(bundle.dense_input_keys))


def main(argv=None):
    """Train the untrained days; returns the final state (None when there
    was nothing to train)."""
    ap = argparse.ArgumentParser(description="day-incremental trainer")
    ap.add_argument("--model", required=True, choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--state-dir", required=True)
    ap.add_argument("--match-pattern", default="part-*")
    ap.add_argument("--batch-size", type=int, default=4096)
    ap.add_argument("--bucket-size", type=int, default=None)
    ap.add_argument("--ids-per-feature", type=int, default=5)
    ap.add_argument("--label-key", default="label")
    ap.add_argument("--today", default=None)
    ap.add_argument("--max-days", type=int, default=30)
    ap.add_argument("--predict-out", default=None)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--evict-min-show", type=float, default=-1.0,
                    help="after each day, zero table rows seen fewer than "
                         "this many times (feature_drop_show analog; -1 off)")
    ap.add_argument("--backtest", action="store_true",
                    help="progressive validation: before training each day, "
                         "evaluate the current model on that day's data and "
                         "append metrics to <state-dir>/backtest.jsonl")
    ap.add_argument("--table-dtype", choices=["fp32", "bf16", "auto"],
                    default="fp32",
                    help="embedding table storage: fp32, bf16, or auto (bf16 "
                         "for rows of 32 or more)")
    ap.add_argument("--compute-dtype", choices=["fp32", "bf16"],
                    default="fp32",
                    help="dense-tower mixed-precision policy")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, force=True)

    kwargs = {"device": args.device, **table_dtype_kwargs(args.table_dtype),
              **compute_dtype_kwargs(args.compute_dtype)}
    if args.bucket_size:
        if "bucket_size" not in inspect.signature(MODEL_REGISTRY[args.model]).parameters:
            ap.error(f"--bucket-size: model {args.model!r} takes no bucket size")
        kwargs["bucket_size"] = args.bucket_size
    bundle = create_model(args.model, **kwargs)
    parse_fn = build_parse_fn(bundle, args)

    last = read_marker(args.state_dir)
    days = trained_delta_days(last, today=args.today, max_days=args.max_days)
    days = [d for d in days
            if os.path.isdir(os.path.join(args.data_dir, d))]
    if not days:
        log.info("nothing to train: last=%s", last)
        return None

    os.makedirs(args.state_dir, exist_ok=True)
    ckpt_dir = os.path.join(args.state_dir, "ckpt")
    state = None

    def reader(day, **kw):
        return dataset_reader(args.data_dir, [day], args.match_pattern,
                              args.batch_size, parse_fn, device=bundle.device, **kw)

    for day in days:
        if args.backtest and state is not None:
            metrics = evaluate(bundle,
                               ((b, d, l, w) for b, d, l, w, _ in
                                reader(day, drop_remainder=False)),
                               state)
            rec = {"day": day, "step": int(state.step)}
            for task, ms in metrics.items():
                for name, v in ms.items():
                    rec[f"{task}/{name}"] = round(float(v), 6)
            with open(os.path.join(args.state_dir, "backtest.jsonl"), "a") as bf:
                bf.write(json.dumps(rec) + "\n")
            log.info("backtest %s: %s", day, rec)
        log.info("training day %s", day)
        ds = balance_batches(((b, d, l, w) for b, d, l, w, _ in reader(day)),
                             args.batch_size)
        state = fit(bundle, ds, state=state, log_every=args.log_every,
                    checkpoint_dir=ckpt_dir, resume=(state is None))
        if args.evict_min_show >= 0:
            gen = torch.Generator(device=bundle.device).manual_seed(0)
            bundle.embedding.evict(state.tables, args.evict_min_show, gen)
            log.info("evicted rows with show < %s", args.evict_min_show)
        save_checkpoint(ckpt_dir, state)
        write_marker(args.state_dir, day)
        log.info("day %s done at step %d", day, state.step)

    if args.predict_out and state is not None:
        n = dump_predict(bundle, reader(days[-1]), state, args.predict_out)
        log.info("dumped %d predictions to %s", n, args.predict_out)
    return state


if __name__ == "__main__":
    main()
