"""Minimal online scoring service of the port.

Counterpart of ``recommendsystem_tpu/serving/server.py``: accept JSON rows
of RAW feasigns, hash and pad them on the host, run the predict step on the
card, return the named scores.

    python -m recommendsystem_tpu_torch.serving.server --model autoint --port 8000
    python -m recommendsystem_tpu_torch.serving.server --model staytime --port 8000
    python -m recommendsystem_tpu_torch.serving.server --model ctr --port 8000
    python -m recommendsystem_tpu_torch.serving.server --model finish --port 8000
    python -m recommendsystem_tpu_torch.serving.server --model staytime \
        --checkpoint /state/ckpt --port 8000

    POST /score  {"rows": [{"1000": [123456789], ...}, ...]}
    ->           {"scores": {"<task>": [..]}, "batch": N}

One score per served head: staytime answers its expected watch time and
its shortplay and longplay probabilities under their task names, ctr its
two click heads, multi_head its seven, finish its finish rate.  A
sequence column and the mean column of the same slot read one request
feature, as in the JAX package, so a sequence slot carries at most
``ids_per_feature`` ids.

Requests pad to the smallest power-of-two batch bucket up to ``max_batch``,
so the kernels see a few fixed shapes.  ``--checkpoint DIR`` serves the
latest state that ``train.checkpoint.save_checkpoint`` wrote under DIR (the
daily trainer's ``<state-dir>/ckpt``); without it the weights are seed 0's.
The bf16 flags come with a later slice of the port.
"""

from __future__ import annotations

import argparse
import inspect
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.parse import pad_ids
from ..embedding.engine import IdBatch, validate_batch
from ..models import MODEL_REGISTRY, create_model
from ..models.base import ModelBundle
from ..train.checkpoint import restore_checkpoint
from ..train.state import TrainState, create_train_state
from ..train.step import make_predict_step

log = logging.getLogger("recommendsystem_tpu_torch.serving")


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class ScoringService:
    """Scores raw-feasign rows with ``bundle`` and ``state`` on ``device``
    (``"cuda"`` unless the caller asks for the CPU; raises where CUDA is
    absent)."""

    def __init__(self, bundle: ModelBundle, state: TrainState,
                 max_batch: int = 256, ids_per_feature: int = 5,
                 min_bucket: int = 8, device="cuda"):
        self.device = resolve_device(device)
        if not _same_device(bundle.device, self.device):
            raise ValueError(f"bundle lives on {bundle.device}, the service "
                             f"on {self.device}")
        self.bundle = bundle
        self.state = state
        self.max_batch = max_batch
        self.ids_per_feature = ids_per_feature
        self.buckets = []
        b = min_bucket
        while b < max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(max_batch)
        self._predict = make_predict_step(bundle)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")

    def _make_batch(self, rows: List[Dict[str, List[int]]],
                    bucket: int) -> Dict[str, IdBatch]:
        batch = {}
        for key, col in self.bundle.embedding.columns.items():
            fkey = col.categorical_column.key
            values = [r.get(fkey, []) for r in rows]
            values += [[]] * (bucket - len(values))
            max_len = col.seq_max_len if col.is_sequence else self.ids_per_feature
            # never silently truncate a request: an over-wide row would lose
            # ids and return a plausible-but-wrong score
            for i, v in enumerate(values):
                if len(v) > max_len:
                    raise ValueError(
                        f"row {i}: feature {fkey!r} has {len(v)} ids, compiled "
                        f"width is {max_len} (split the request or raise "
                        f"ids_per_feature/seq_max_len)")
            batch[key] = pad_ids(values, max_len, col.categorical_column.hash_ids)
        # the fold kernels read table rows unchecked: corrupt ids fail here,
        # on the host, before the batch moves to the card
        validate_batch(self.bundle.embedding, batch)
        return {k: v.to(self.device) for k, v in batch.items()}

    def warmup(self) -> None:
        """Run every batch bucket once, so that the first real request pays
        no kernel build or first-launch cost."""
        import time
        for b in self.buckets:
            t0 = time.perf_counter()
            self.score([{} for _ in range(b)])
            log.info("warmed bucket %d in %.1fs", b, time.perf_counter() - t0)

    def score(self, rows: List[Dict[str, List[int]]],
              dense: Optional[List[Dict[str, float]]] = None
              ) -> Dict[str, List[float]]:
        if not rows:
            return {}
        bucket = self._bucket_for(len(rows))
        batch = self._make_batch(rows, bucket)
        dense_inputs = None
        if self.bundle.dense_input_keys:
            dense_inputs = {}
            for k in self.bundle.dense_input_keys:
                col = [(d or {}).get(k, 0.0) for d in (dense or [{}] * len(rows))]
                col += [0.0] * (bucket - len(col))
                dense_inputs[k] = torch.tensor(col, dtype=torch.float32,
                                               device=self.device).reshape(-1, 1)
        out = self._predict(self.state, batch, dense_inputs)
        n = len(rows)
        return {task: v.cpu().numpy()[:n].reshape(n, -1)[:, 0].tolist()
                for task, v in out.items()}


def _make_handler(service: ScoringService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug(fmt, *args)

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "model": service.bundle.name,
                                  "step": int(service.state.step)})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/score":
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                rows = req.get("rows", [])
                scores = service.score(rows, req.get("dense"))
                self._reply(200, {"scores": scores, "batch": len(rows)})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:   # malformed payloads must not kill serving
                log.exception("score failed")
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(service: ScoringService, port: int = 8000, host: str = "127.0.0.1"):
    httpd = ThreadingHTTPServer((host, port), _make_handler(service))
    log.info("scoring %s on %s:%d", service.bundle.name, host, port)
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description="online scoring service")
    ap.add_argument("--model", required=True, choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--checkpoint", default=None,
                    help="directory of checkpoints to serve (the latest step)")
    ap.add_argument("--bucket-size", type=int, default=None)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' for the plain versions")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO, force=True)
    kwargs = {}
    if args.bucket_size:
        factory = inspect.signature(MODEL_REGISTRY[args.model])
        if "bucket_size" not in factory.parameters:
            ap.error(f"--bucket-size: model {args.model!r} takes no bucket size")
        kwargs["bucket_size"] = args.bucket_size
    bundle = create_model(args.model, device=args.device, **kwargs)
    state = create_train_state(bundle, seed=0)
    if args.checkpoint:
        state = restore_checkpoint(args.checkpoint, state)
        log.info("restored checkpoint at step %d", state.step)
    service = ScoringService(bundle, state, max_batch=args.max_batch,
                             device=args.device)
    service.warmup()
    serve(service, port=args.port).serve_forever()


if __name__ == "__main__":
    main()
