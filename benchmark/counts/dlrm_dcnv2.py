"""FLOPs and compulsory bytes of the DLRM-DCNv2 configuration, from its
shapes and a batch's own ids (whatever implements the step).

FLOPs: the products of the forward, 2 m n k each: the bottom MLP, each
cross layer's two products through its rank (x V, then W), the top MLP
and its unit; three times the forward for a train step (the backward's
two products a forward one).  The sum pooling's adds and the elementwise
work are left out.  Bytes: ids and masks read once, the dense features
read once, each distinct live row read once; in training each updated
row's w and AdaGrad accumulator read and written, and the dense params
with their Adam moments read and written; the outputs written.
Activations are not counted.
"""

from __future__ import annotations

from harness import peaks


def width(m: dict) -> int:
    """The interaction's width: the bottom output and the 26 pooled rows."""
    return (len(m["tables"]) + 1) * m["dim"]


def _layers(m: dict):
    """(in, out) of every product applied once a sample."""
    out, w = [], m["dense_features"]
    for unit in m["bottom"]:
        out.append((w, unit))
        w = unit
    f = width(m)
    out += [(f, m["cross_rank"]), (m["cross_rank"], f)] * m["cross_layers"]
    w = f
    for unit in m["top"]:
        out.append((w, unit))
        w = unit
    return out


def flops_per_example(m: dict) -> int:
    return 2 * sum(i * o for i, o in _layers(m))


def dense_params(m: dict) -> int:
    """Weights and biases of every layer; a cross layer's V has no bias."""
    n = sum(i * o for i, o in _layers(m))
    n += sum(m["bottom"]) + sum(m["top"]) + m["cross_layers"] * width(m)
    return n


def _live(m, batch):
    return {t: peaks.live_rows([(batch["ids"][t], batch["mask"][t])]) for t in m["tables"]}


def step(m: dict, entry: str, batch: dict):
    """(FLOPs, bytes) of one step of ``entry`` ("train" or "predict")."""
    b = next(iter(batch["ids"].values())).shape[0]
    d = m["dim"]
    n_ids = sum(v.numel() for v in batch["ids"].values())
    live = sum(_live(m, batch).values())
    flops = b * flops_per_example(m)
    nbytes = 8 * n_ids + live * d * 4 + b * m["dense_features"] * 4 + b * 4
    if entry == "train":
        flops *= 3
        nbytes += live * 2 * (d * 4 + 4)
        nbytes += dense_params(m) * 3 * 2 * 4
    return flops, nbytes


def kernel(m: dict, name: str, batch: dict, shard=None):
    """(bytes, operations) of one step's calls of kernel ``name``, or None
    where this configuration's step has no such kernel.  A sharded step
    (``shard``) is not counted: the configuration runs on one card.

    - ``sparse_update``: K9 over every table, each a storage of its own
      (``peaks.sparse_adagrad`` over its live rows);
    - ``dcn_cross``: K10 at every cross layer: g, x0 and u read and du and
      x0's gradient written, 5 x B x F floats, and db's F floats written;
      a product and an add for each of du, x0's share and db."""
    if shard is not None:
        return None
    b = next(iter(batch["ids"].values())).shape[0]
    if name == "sparse_update":
        nbytes = ops = 0
        for t, live in _live(m, batch).items():
            one = peaks.sparse_adagrad(live, m[f"rows_{t}"], m["dim"])
            nbytes, ops = nbytes + one[0], ops + one[1]
        return nbytes, ops
    if name == "dcn_cross":
        f = width(m)
        return m["cross_layers"] * (5 * b * f * 4 + f * 4), m["cross_layers"] * 4 * b * f
    return None
