"""FLOPs and compulsory bytes of the staytime configuration, from its shapes
and a batch's own ids (whatever implements the step).

FLOPs: the products of the forward (2 m n k each): the DIN scorers over
the live positions of each sequence and their weighted sums, SENet, the
FFM projections, the PPNet gates and experts, the MMoE gates and
mixtures, DeepCross, the 400-bin head and its expected value, the towers;
three times the forward for a train step.  Bytes: ids and masks read
once; each distinct live row read once; in training each updated row's w
and AdaGrad accumulator read and written, and the dense params with their
Adam moments read and written; the outputs written.
"""

from __future__ import annotations

from harness import peaks
from reference import staytime as model


def _widths(m: dict):
    g = m["general"]
    concat = (g * (len(m["slots"]) + 1 + len(m["user_slots"]) + len(m["seq_slots"]))
              + m["ffm_dim"] * len(m["user_slots"]) * len(m["item_slots"]))
    gate = (m["dim"] - g) * len(m["bias_slots"])
    return concat, gate


def _layers(m: dict):
    """(in, out) of every product applied once a sample, and of the DIN
    scorer applied once a live position."""
    g, f = m["general"], len(m["slots"])
    concat, gate = _widths(m)
    per_sample = [(f * g, f // m["senet_reduction"]), (f // m["senet_reduction"], f)]
    per_sample += [(g, m["ffm_dim"])] * (2 * len(m["user_slots"]) * len(m["item_slots"]))
    for _ in range(m["num_experts"]):
        width = concat
        for unit in m["deep_hidden_units"]:
            per_sample += [(gate, unit), (unit, unit), (width, unit)]
            width = unit
    expert = m["deep_hidden_units"][-1]
    for _ in range(m["num_tasks"]):
        width = concat
        for unit in m["mmoe_units"]:
            per_sample.append((width, unit))
            width = unit
        per_sample += [(width, m["num_experts"]), (m["num_experts"], expert)]
    per_sample += [(concat, 1)] * m["dcn_layers"]
    per_sample += [(expert + concat, m["bins"]), (m["bins"], 1), (expert, 1), (2, 1),
                   (expert, 1), (2, 1)]
    per_position = [(4 * g, m["din_hidden"]), (m["din_hidden"], 1), (1, g)]
    return per_sample, per_position


def dense_params(m: dict) -> int:
    """Weights and biases of every layer (the mixtures, the FM terms and
    the fixed bin centres carry none): per-sample layers but the mixtures'
    and the expected value's products, DeepCross's (D,) biases beside its
    (D, 1) kernels, and each DIN scorer."""
    per_sample, per_position = _layers(m)
    concat, _ = _widths(m)
    mixture = (m["num_experts"], m["deep_hidden_units"][-1])
    n = sum(i * o + o for i, o in per_sample if (i, o) not in (mixture, (m["bins"], 1)))
    n += m["dcn_layers"] * (concat - 1)
    n += len(m["seq_slots"]) * sum(i * o + o for i, o in per_position[:2])
    return n


def _live(m, batch):
    return {t: peaks.live_rows([(batch["ids"][k], batch["mask"][k])
                                for k, tk, _, _ in model.columns(m) if tk == t])
            for t in model.tables(m)}


def step(m: dict, entry: str, batch: dict):
    """(FLOPs, bytes) of one step of ``entry`` ("train" or "predict")."""
    b = next(iter(batch["ids"].values())).shape[0]
    per_sample, per_position = _layers(m)
    positions = sum(int(batch["mask"][f"seq_{s}"].sum()) for s in m["seq_slots"])
    flops = (2 * b * sum(i * o for i, o in per_sample)
             + 2 * positions * sum(i * o for i, o in per_position))
    n_ids = sum(v.numel() for v in batch["ids"].values())
    live = _live(m, batch)
    d = m["dim"]
    nbytes = 8 * n_ids + sum(live.values()) * d * 4 + b * 3 * 4
    if entry == "train":
        flops *= 3
        nbytes += sum(live.values()) * 2 * (d * 4 + 4)
        nbytes += dense_params(m) * 3 * 2 * 4
    return flops, nbytes


def kernel(m: dict, name: str, batch: dict, shard=None):
    """(bytes, operations) of one step's calls of kernel ``name``, or None
    where this configuration's step has no such kernel.  A rank's calls of
    a sharded step (``shard``, (rank, world)) are not counted: the program
    keeps this configuration's tables two to a storage (its 30 MiB
    group cap), so a rank's block of a storage spans parts of its
    tables, which ``peaks.table_shard`` does not follow."""
    b = next(iter(batch["ids"].values())).shape[0]
    d, g = m["dim"], m["general"]
    if shard is not None:
        return None
    if name == "sparse_update":
        nbytes = ops = 0
        for live in _live(m, batch).values():
            one = peaks.sparse_adagrad(live, m["bucket_size"], d)
            nbytes, ops = nbytes + one[0], ops + one[1]
        return nbytes, ops
    if name == "fold_mean":
        nbytes = ops = 0
        for t in model.tables(m):
            parts = [(batch["ids"][k], batch["mask"][k])
                     for k, tk, kind, _ in model.columns(m) if tk == t and kind == "mean"]
            n_ids = sum(ids.numel() for ids, _ in parts)
            n_live = sum(int((mask > 0).sum()) for _, mask in parts)
            one = peaks.fold_mean(n_ids, n_live, peaks.live_rows(parts), d, b * len(parts))
            nbytes, ops = nbytes + one[0], ops + one[1]
        return nbytes, ops
    if name == "din_pool":
        nbytes = ops = 0
        t = m["seq_max_len"]
        weights = 4 * g * m["din_hidden"] + 2 * m["din_hidden"] + 1
        for s in m["seq_slots"]:
            ids, mask = batch["ids"][f"seq_{s}"], batch["mask"][f"seq_{s}"]
            one = peaks.din_pool_gather(b, t, g, int((mask > 0).sum()),
                                        peaks.live_rows([(ids, mask)]), weights)
            nbytes, ops = nbytes + one[0], ops + one[1]
        return nbytes, ops
    return None
