"""The one general generator of the benchmark's traffic.

A traffic mix is a JSON file ``traffic/<name>.json`` of parameters; this
module reads it and makes the mix's batches on the device from the seed:

- ``ids``: ``{"dist": "zipf", "exponent": s}`` draws a column's ids by rank
  with P(rank r) proportional to (r + 1)^-s over its table's bucket, then
  maps each rank through a random permutation of the table's rows (one a
  table: a behaviour sequence and its slot share their hot rows);
  ``{"dist": "uniform"}`` draws every row alike;
- ``mean_ids``: [lo, hi], a mean column's live ids a sample, uniform; the
  column is padded to the configuration's ``ids_per_column``;
- ``seq_len``: [lo, hi], a behaviour sequence's live length, uniform,
  padded to ``seq_max_len``; padded positions carry id 0 and mask 0;
- labels follow ``reference/<config>.labels``: each sample draws a hidden
  engagement e ~ U(0, 1); a ``click`` is Bernoulli(sigmoid(4 e - 2)) with
  15 % of labels flipped; ``staytime``, ``shortplay`` and ``longplay``
  come from one watch time of e 60 s U(0.5, 1.5): > 7 s, > 18 s, and the
  400-bin Gaussian-smoothed (sigma 4 bins) distribution of the time cut at
  160 s with the time as a 401st column.  Sample weights are 1.
- ``dense``, only for a configuration whose reference defines ``dense(m)``
  (its dense-feature keys and widths): ``{"mu": mu, "sigma": sigma}``
  draws each feature as a non-negative integer count
  floor(exp(mu + sigma z)), z ~ N(0, 1), a discretised log-normal, and
  passes it as log(1 + count), as the DLRM loader passes Criteo's counts.  The batch
  then carries ``dense``: {key: (rows, width) float32}.

Rows ``[row0, row0 + rows)`` of batch ``index`` come from a generator
seeded by (seed, index, row0), so a rank of a sharded cell makes its own
rows and the reference makes the whole batch from the same draws.  The
dense features come from a generator of their own, seeded by (seed,
index, row0, ``DENSE_TAG``), so the other draws are the same whether a
configuration has dense features or not.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

_M64 = (1 << 64) - 1
BIN_LEFT, BIN_WIDTH, BINS, SIGMA = -19.0, 0.5, 400, 4.0
DENSE_TAG = 0x64656E7365


def mix(*words: int) -> int:
    """splitmix64 over ``words``: a seed below 2**63 for torch."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (w & _M64)) & _M64
        h = (h + 0x9E3779B97F4A7C15) & _M64
        z = h
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        h = z ^ (z >> 31)
    return h >> 1


class Traffic:
    """The batches of one mix for one configuration on one device."""

    def __init__(self, model, m: dict, traffic: dict, seed: int, device):
        self.model, self.m, self.t = model, m, traffic
        self.seed, self.device = seed, torch.device(device)
        self.columns = model.columns(m)
        self.tables = model.tables(m)
        gen = torch.Generator(device=self.device).manual_seed(mix(seed, 0x7065726D))
        # one permutation of the rows and one rank CDF a table, in table order
        self.perm: Dict[str, torch.Tensor] = {}
        self.cdf: Dict[int, torch.Tensor] = {}
        ids = traffic["ids"]
        for tkey in sorted(self.tables):
            rows = self.tables[tkey][0]
            self.perm[tkey] = torch.randperm(rows, generator=gen, device=self.device)
            if ids["dist"] == "zipf" and rows not in self.cdf:
                w = torch.arange(1, rows + 1, dtype=torch.float64,
                                 device=self.device).pow(-float(ids["exponent"]))
                cdf = torch.cumsum(w, 0)
                self.cdf[rows] = cdf / cdf[-1]
        if ids["dist"] not in ("zipf", "uniform"):
            raise ValueError(f"ids dist {ids['dist']!r}: expected 'zipf' or 'uniform'")
        self.dense = model.dense(m) if hasattr(model, "dense") else {}
        if self.dense:
            law = traffic.get("dense")
            if law is None or not {"mu", "sigma"} <= set(law):
                raise ValueError("the configuration has dense features: the mix needs "
                                 "\"dense\": {\"mu\": .., \"sigma\": ..}")

    def _ranks(self, rows: int, shape, gen) -> torch.Tensor:
        if self.t["ids"]["dist"] == "uniform":
            return torch.randint(0, rows, shape, generator=gen, device=self.device)
        u = torch.rand(shape, generator=gen, dtype=torch.float64, device=self.device)
        return torch.searchsorted(self.cdf[rows], u).clamp_(max=rows - 1)

    def batch(self, index: int, rows: int, row0: int = 0) -> dict:
        """Rows [row0, row0 + rows) of batch ``index``."""
        gen = torch.Generator(device=self.device).manual_seed(mix(self.seed, index, row0))
        dev = self.device
        engagement = torch.rand((rows,), generator=gen, device=dev)
        ids, masks = {}, {}
        for key, tkey, kind, width in self.columns:
            lo, hi = self.t["mean_ids"] if kind == "mean" else self.t["seq_len"]
            lens = torch.randint(lo, hi + 1, (rows,), generator=gen, device=dev)
            mask = (torch.arange(width, device=dev)[None, :] < lens[:, None]).float()
            rank = self._ranks(self.tables[tkey][0], (rows, width), gen)
            ids[key] = (self.perm[tkey][rank] * mask.long()).int()
            masks[key] = mask
        labels = {}
        kinds = self.model.labels(self.m)
        if "click" in kinds.values():
            p = torch.sigmoid(engagement * 4.0 - 2.0)
            click = (torch.rand((rows,), generator=gen, device=dev) < p).float()[:, None]
            flip = torch.rand((rows, 1), generator=gen, device=dev) < 0.15
            labels_click = torch.where(flip, 1.0 - click, click)
        if {"staytime", "shortplay", "longplay"} & set(kinds.values()):
            wt_ms = torch.floor(engagement.double() * 60000.0 * (
                0.5 + torch.rand((rows,), generator=gen, device=dev).double()))
            stay = staytime_labels(wt_ms)
        for task, kind in kinds.items():
            labels[task] = labels_click if kind == "click" else stay[kind]
        out = {"ids": ids, "mask": masks, "labels": labels,
               "weight": torch.ones((rows, 1), device=dev)}
        if self.dense:
            out["dense"] = self._dense(index, rows, row0)
        return out

    def _dense(self, index: int, rows: int, row0: int) -> Dict[str, torch.Tensor]:
        """log(1 + count) of each dense feature, the counts drawn from the
        mix's discretised log-normal, keys in sorted order."""
        law = self.t["dense"]
        gen = torch.Generator(device=self.device).manual_seed(
            mix(self.seed, index, row0, DENSE_TAG))
        out = {}
        for key in sorted(self.dense):
            z = torch.randn((rows, self.dense[key]), generator=gen, device=self.device)
            count = torch.floor(torch.exp(z * float(law["sigma"]) + float(law["mu"])))
            out[key] = torch.log1p(count)
        return out


def staytime_labels(wt_ms: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's label engineering from watch times in ms (copied
    from the program's ``data/staytime_labels.py``, in torch)."""
    short = (wt_ms > 7000).float()[:, None]
    long_ = (wt_ms > 18000).float()[:, None]
    wt = torch.clamp(wt_ms.float() / 1000.0, max=160.0)[:, None]
    bins = torch.arange(BINS, dtype=torch.float32, device=wt.device) * BIN_WIDTH + BIN_LEFT
    width = (180.5 - BIN_LEFT) / (BINS - 1)
    dist = torch.exp(torch.square(bins[None, :] - wt) / (-2 * SIGMA ** 2))
    dist = dist / (math.sqrt(2 * math.pi) * SIGMA) * width
    return {"staytime": torch.cat([dist, wt], dim=-1), "shortplay": short, "longplay": long_}
