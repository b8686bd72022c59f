"""Example: train the ctr production model of the PyTorch port from a
model_parameter.json config on synthetic data, on one CUDA card (or the
CPU, where every kernel runs as its plain PyTorch version).

    python examples/torch_train_ctr.py --steps 200 --batch-size 4096
    python examples/torch_train_ctr.py --steps 4 --batch-size 64 --device cpu
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from recommendsystem_tpu_torch.core.config import (load_model_parameter_json,
                                                   synthetic_ctr_config)
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.train import evaluate, fit


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "ctr_model_parameter.json"))
    ap.add_argument("--model", default="ctr", choices=["ctr", "autoint"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--bucket-size", type=int, default=65536)
    ap.add_argument("--sparse-lr", type=float, default=5e-5)
    ap.add_argument("--dense-lr", type=float, default=5e-5)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    args = ap.parse_args(argv)

    kwargs = dict(cfg=load_model_parameter_json(args.config), bucket_size=args.bucket_size,
                  sparse_lr=args.sparse_lr, dense_lr=args.dense_lr, device=args.device)
    if args.model == "autoint":
        # autoint needs uniform field widths; strip bias features
        kwargs["cfg"] = synthetic_ctr_config(num_slots=24, emb_sizes=(8,), num_bias=0)
    bundle = create_model(args.model, **kwargs)

    ds = (synthetic_batch(bundle, args.batch_size, seed=i) for i in range(args.steps))
    logging.basicConfig(level=logging.INFO)
    state = fit(bundle, ds, steps=args.steps, log_every=20,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=0 if not args.checkpoint_dir else 100)

    metrics = evaluate(bundle, (synthetic_batch(bundle, args.batch_size, seed=10_000 + i)
                                for i in range(4)), state)
    for task, ms in metrics.items():
        print(task, {k: round(float(v), 4) for k, v in ms.items()})
    return metrics


if __name__ == "__main__":
    main()
