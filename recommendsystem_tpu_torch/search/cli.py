"""CLI entry points for the offline fusion search.

Replaces the reference's launchers: ``pso/pso.py:168-183`` (argv NGEN /
popsize over a local score log) and ``gaussain/gaussian_process.py:404-430``
+ ``gaussain/gaussian.sh`` (Spark job over a Hive dump; here a CSV/parquet
file + multiprocessing, with the same per-cohort runs: all users, coin
users, non-coin users and the GAUC group-size filter).

Usage:
    python -m recommendsystem_tpu_torch.search.cli pso LOGFILE [NGEN] [POPSIZE]
    python -m recommendsystem_tpu_torch.search.cli gp  DUMP.csv [--coin-col is_coin_user]
"""

from __future__ import annotations

import argparse

MERGE_LABEL_THRESHOLDS = {   # gaussian_process.py:390-402
    "comment": 0.00149,
    "commentshow": 0.0179,
    "follow": 0.1426,
    "head": 0.3036,
    "share": 0.0048,
}


def merge_label(row) -> int:
    for label, thr in MERGE_LABEL_THRESHOLDS.items():
        if row[label + "_score"] >= thr:
            return 1
    return 0


def run_pso(args) -> None:
    from .pso import PSO
    from .reader import Reader

    data = Reader(args.input).parse_lines(sample_rate=args.sample_rate)
    pso = PSO(ngen=args.ngen, pop_size=args.popsize, data=data)
    pso.base_auc()
    best_fit, best_pos = pso.main()
    print("best fitness:", best_fit)
    print("best params:", list(best_pos))


def run_gp(args) -> None:
    import pandas as pd

    from .gauc import GaucEngine, default_bound_x, filter_user_group_sizes
    from .gp import GPSearch

    df = pd.read_csv(args.input)
    if "is_interaction_user" not in df and all(
            f"{h}_score" in df for h in MERGE_LABEL_THRESHOLDS):
        df["is_interaction_user"] = df.apply(merge_label, axis=1)

    print("before filter:{}".format(len(df)))
    keep = filter_user_group_sizes(df["user_id"].to_numpy())
    df = df[keep]
    print("after filter:{}".format(len(df)))

    def cohort(frame, is_coin, name):
        bound = default_bound_x()
        heads = list(bound.keys())
        scores = {h: frame[f"{h}_score"].to_numpy(float) for h in heads}
        labels = {h: frame[f"{h}_label"].to_numpy(float) for h in heads}
        eng = GaucEngine(scores=scores, labels=labels,
                         user_ids=frame["user_id"].to_numpy(),
                         bound_x=bound, num_buckets=args.buckets)
        search = GPSearch(eng, is_coin_user=is_coin, pop_size=args.popsize,
                          ngen=args.ngen, gaussian_ngen=args.gaussian_ngen,
                          parallel=args.parallel)
        params, y = search.run()
        print("%s, %s, Best Result: y=%.5f" % (name, is_coin, y))
        for m, p in params.items():
            print("  %s: %s" % (m, p))

    cohort(df, False, "all user")
    if args.coin_col in df:
        cohort(df[df[args.coin_col] == 1], True, "coin_user")
        cohort(df[df[args.coin_col] == 0], False, "non_coin_user")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="fusion-weight search")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("pso")
    p.add_argument("input")
    p.add_argument("ngen", nargs="?", type=int, default=2)      # pso.py:169
    p.add_argument("popsize", nargs="?", type=int, default=64)  # pso.py:170
    p.add_argument("--sample-rate", type=float, default=0.1)
    p.set_defaults(fn=run_pso)

    g = sub.add_parser("gp")
    g.add_argument("input")
    g.add_argument("--coin-col", default="is_coin_user")
    g.add_argument("--popsize", type=int, default=100)
    g.add_argument("--ngen", type=int, default=10)
    g.add_argument("--gaussian-ngen", type=int, default=200)
    g.add_argument("--buckets", type=int, default=64)
    g.add_argument("--parallel", action="store_true")
    g.set_defaults(fn=run_gp)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
