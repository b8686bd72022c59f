"""Example: train the staytime multi-task model of the PyTorch port (DIN
sequences and the 400-bin expected-value head) and evaluate per-user GAUC
with the streaming engine, on synthetic data, on one CUDA card (or the
CPU, where every kernel runs as its plain PyTorch version).

    python examples/torch_train_staytime_gauc.py --steps 100 --batch-size 512

Mixed precision, as the daily trainer spells it: bf16 table storage and the
bf16 compute policy:

    python examples/torch_train_staytime_gauc.py --table-dtype bf16 --compute-dtype bf16
"""

import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.base import compute_dtype_kwargs, table_dtype_kwargs
from recommendsystem_tpu_torch.models.staytime import T_LONG, T_SHORT, T_STAY, StaytimeConfig
from recommendsystem_tpu_torch.train import fit
from recommendsystem_tpu_torch.train.gauc_eval import evaluate_gauc_streaming
from recommendsystem_tpu_torch.train.streaming_gauc import StreamingGauc, StreamingSpearmanGauc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--bucket-size", type=int, default=4096)
    ap.add_argument("--seq-max-len", type=int, default=16)
    ap.add_argument("--num-users", type=int, default=64)
    ap.add_argument("--table-dtype", choices=["fp32", "bf16", "auto"], default="fp32",
                    help="embedding table storage: fp32, bf16, or auto (bf16 for rows "
                         "of 32 or more)")
    ap.add_argument("--compute-dtype", choices=["fp32", "bf16"], default="fp32",
                    help="dense-tower mixed-precision policy")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, force=True)
    cfg = StaytimeConfig(bucket_size=args.bucket_size, seq_max_len=args.seq_max_len)
    bundle = create_model("staytime", cfg=cfg, device=args.device,
                          **table_dtype_kwargs(args.table_dtype),
                          **compute_dtype_kwargs(args.compute_dtype))

    ds = (synthetic_batch(bundle, args.batch_size, seed=i) for i in range(args.steps))
    state = fit(bundle, ds, steps=args.steps, log_every=20)

    # eval with user ids carried in extras -> streaming per-user GAUC on the
    # binary heads (shortplay, longplay); the state stays on the device
    def eval_ds():
        rng = np.random.default_rng(0)
        for i in range(8):
            b, d, l, w = synthetic_batch(bundle, args.batch_size, seed=100_000 + i)
            users = rng.integers(0, args.num_users, args.batch_size)
            yield b, d, l, w, {"user_id": users}

    # mixed engines in one pass: ROC GAUC for the binary heads, spearman
    # (inversion) GAUC for the continuous EV head, whose output spans the bin
    # range (-19..180.5 s) and whose label column is wt seconds clipped at 160
    gaucs = evaluate_gauc_streaming(
        bundle, eval_ds(), state, tasks=(T_STAY, T_SHORT, T_LONG),
        gauc={T_STAY: StreamingSpearmanGauc(pred_lo=-20.0, pred_hi=181.0,
                                            label_lo=0.0, label_hi=161.0),
              T_SHORT: StreamingGauc(num_buckets=4096, num_bins=256),
              T_LONG: StreamingGauc(num_buckets=4096, num_bins=256)})
    for task, g in sorted(gaucs.items()):
        kind = "spearman-inv" if task == T_STAY else "roc"
        print(f"GAUC[{task}] ({kind}) = {g:.4f}")
    return gaucs


if __name__ == "__main__":
    main()
