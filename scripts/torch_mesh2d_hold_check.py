#!/usr/bin/env python3
"""What phase 17's hold of the 2-D step against the local step passes and
what it refuses, shown on the CPU.

    python3 scripts/torch_mesh2d_hold_check.py

runs ``chip_smoke._mesh2d_model`` (phase 17's cases: placements, a window
of the local step and one of the 2-D step from one state and batch, the
hold, the predict and eval calls, the turns) on two gloo ranks (data 1 x
model 2) on the CPU, at phase 17's widths over small tables (512-id
buckets; the 212-feature ctr 256) and B 256 (staytime and the 212-feature
ctr 128), and prints one JSON line: for each variant and case, the hold's
readings, or the message it refused with.  The variants:

- ``sound``: the cases as they are;
- ``kinks``: every ReLU input of the 2-D step within KINK_AT of its call's
  largest |input| takes the other sign (its gradient path unchanged), a
  kink at every step from step 1; the float32 hold must explain each
  entry past its tolerance by the kinked replay;
- ``grad_fault``: the 2-D step's gradient through half of each ReLU's
  units scaled by 1.01, its values unchanged; the float32 hold must refuse
  it;
- ``rank_rounding``: a column-split ``Dense`` that rounds each model
  rank's part of x's gradient to bf16 before the sum (what
  ``nn.mlp._ColumnProductF32`` repairs); the bf16 hold must refuse it,
  and with its limits lifted (``rank_rounding_reading``) it reads what the
  fault gives, beside ``sound``'s reading.

The kernels run their plain versions on the CPU, so the launch
expectations are set aside; nothing else of the hold is.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINK_AT = 1e-5
VARIANTS = {"sound": ("ctr", "rough_rank", "staytime", "ctr212", "ctr_bf16"),
            "kinks": ("ctr", "rough_rank", "staytime"),
            "grad_fault": ("ctr",),
            "rank_rounding": ("ctr_bf16",),
            "rank_rounding_reading": ("ctr_bf16",)}


def _cases():
    from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
    from recommendsystem_tpu_torch.models.staytime import StaytimeConfig

    bf16 = {"table_dtype": torch.bfloat16, "opt_state_dtype": torch.bfloat16,
            "compute_dtype": torch.bfloat16, "bucket_size": 512}
    return {"ctr": ("ctr", {"bucket_size": 512}, 256, 5, "tensor"),
            "rough_rank": ("rough_rank", {"stacked_experts": True, "bucket_size": 512}, 256, 5,
                           "expert"),
            "staytime": ("staytime", {"cfg": StaytimeConfig(bucket_size=512)}, 128, 5,
                         "tensor"),
            "ctr212": ("ctr", {"cfg": synthetic_ctr_config(num_slots=180, num_bias=32),
                               "bucket_size": 256}, 128, {}, "tensor"),
            "ctr_bf16": ("ctr", bf16, 256, 5, "tensor")}


def _relu_mode(variant):
    """The variant's change to each ReLU input of the 2-D step."""
    from torch.overrides import TorchFunctionMode

    relus = (torch.relu, torch.nn.functional.relu, torch.Tensor.relu)

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in relus:
                x = args[0]
                if variant == "kinks":
                    v = x.detach()
                    near = (v.abs() < KINK_AT * v.abs().max()).to(x.dtype)
                    x = x + (-2 * x * near).detach()
                else:
                    m = torch.zeros_like(x)
                    m[..., :x.shape[-1] // 2] = 1e-2
                    x = x + (x * m - (x * m).detach())
                args = (x,) + tuple(args[1:])
            return func(*args, **(kwargs or {}))
    return Mode


def _rank(r, world, store, out):
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    import recommendsystem_tpu_torch.models as models
    import recommendsystem_tpu_torch.train as train
    from recommendsystem_tpu_torch.core.mesh import create_mesh
    from recommendsystem_tpu_torch.core.model_axis import sum_over_model
    from recommendsystem_tpu_torch.nn import mlp

    torch.set_num_threads(2)
    torch.cuda.synchronize = lambda *a, **k: None
    create_model, make_train_step = models.create_model, train.make_train_step
    column_backward = mlp._ColumnProductF32.backward
    limits = (cs.MESH2D_POLICY_LOSS_RTOL, cs.MESH2D_POLICY_REL_L2)
    models.create_model = lambda model, device="cuda", **kw: create_model(model, device="cpu",
                                                                         **kw)
    cs._busy_share = lambda *a, **k: {}
    for table in (cs.MESH2D_LAUNCHES, cs.MESH2D_PREDICT_LAUNCHES):
        for name in table:
            table[name] = {}

    def rank_rounding(ctx, g):
        x, kernel = ctx.saved_tensors
        gx = sum_over_model((g @ kernel.float().t()).to(x.dtype), ctx.mesh)
        gk = (x.reshape(-1, x.shape[-1]).float().t()
              @ g.reshape(-1, g.shape[-1])).to(kernel.dtype)
        return gx, gk

    def patch(variant):
        mlp._ColumnProductF32.backward = staticmethod(
            rank_rounding if variant.startswith("rank_rounding") else column_backward)
        cs.MESH2D_POLICY_LOSS_RTOL, cs.MESH2D_POLICY_REL_L2 = (
            (math.inf, math.inf) if variant == "rank_rounding_reading" else limits)
        if variant not in ("kinks", "grad_fault"):
            train.make_train_step = make_train_step
            return
        mode = _relu_mode(variant)

        def faulted(bundle, *a, **kw):
            step = make_train_step(bundle, *a, **kw)
            if (a[0] if a else kw.get("mode", "local")) != "sharded":
                return step

            def run(*sa, **skw):
                with mode():
                    return step(*sa, **skw)
            return run
        train.make_train_step = faulted

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=r, world_size=world)
    results = {}
    try:
        mesh = create_mesh("cpu", model_parallel=world)
        cases = _cases()
        for variant, names in VARIANTS.items():
            patch(variant)
            for name in names:
                model, kw, b, ipf, placement = cases[name]
                try:
                    res = cs._mesh2d_model(mesh, None, name, model, kw, b, ipf, placement)
                    results.setdefault(variant, {})[name] = res["past_tolerance"]
                except AssertionError as e:
                    results.setdefault(variant, {})[name] = {"refused": str(e)[:2000]}
        if r == 0:
            with open(out, "w") as fh:
                json.dump(results, fh)
    finally:
        dist.destroy_process_group()


def run(tmp=None):
    """Every variant's readings or refusals, from two gloo ranks."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp() if tmp is None else str(tmp)
    out = os.path.join(tmp, "hold.json")
    mp.start_processes(_rank, args=(2, os.path.join(tmp, "store"), out), nprocs=2,
                       start_method="spawn")
    with open(out) as fh:
        return json.load(fh)


if __name__ == "__main__":
    print(json.dumps(run()))
