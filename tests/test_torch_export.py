"""The port's serving export (``train/export.py``) against the JAX export.

For all six models, weights come from one JAX state through
``bridge.from_jax_numpy``; ``export_serving`` then ``load_serving`` on the
CPU must give the port's ``make_predict_step`` outputs, the JAX
``make_serving_fn``'s and the JAX ``load_serving``'s, at rtol 1e-5, atol
2e-6 (float32 products summed in another order); ``signature.json`` must
equal the JAX one key for key.  The exported graph must hold the kernels as
custom-op nodes (``kernels/_ops.py``), with no ``aten`` gather of a table in
their place; the artifact holds no weights; loading works in a fresh
process that imports only the port, and makes no ``weights_only=False``
fallback.  Sizes as the JAX tests': autoint over 256-id buckets at B 8,
staytime ``StaytimeConfig(bucket_size=128, seq_max_len=4)``, the others
over 128-id buckets at B 4."""

import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.models.staytime import StaytimeConfig as JaxStaytimeConfig
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train import export as jax_export
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.kernels import _ops
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.nn import InteractingLayer
from recommendsystem_tpu_torch.train import create_train_state, make_predict_step
from recommendsystem_tpu_torch.train.export import (export_program, export_serving,
                                                    load_program, load_serving,
                                                    weights_of)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STAY = dict(bucket_size=128, seq_max_len=4)
MODELS = {     # JAX factory kwargs, port factory kwargs, batch
    "autoint": (dict(bucket_size=256), dict(bucket_size=256), 8),
    "ctr": (dict(bucket_size=128), dict(bucket_size=128), 4),
    "multi_head": (dict(bucket_size=128), dict(bucket_size=128), 4),
    "finish": (dict(bucket_size=128), dict(bucket_size=128), 4),
    "rough_rank": (dict(bucket_size=128), dict(bucket_size=128), 4),
    "staytime": (dict(cfg=JaxStaytimeConfig(**_STAY)), dict(cfg=StaytimeConfig(**_STAY)), 4),
}
# the custom-op nodes of each model's exported predict function (5 ids a
# feature: one grouped K1; K6 where the InteractingLayer takes it; three
# gathering K7 for staytime's sequences)
OP_NODES = {
    "autoint": {"fold_mean_group": 1, "interacting_attention": 1},
    "ctr": {"fold_mean_group": 1, "interacting_attention": 1},
    "multi_head": {"fold_mean_group": 1, "interacting_attention": 1},
    "finish": {"fold_mean_group": 1},
    "rough_rank": {"fold_mean_group": 1},
    "staytime": {"fold_mean_group": 1, "din_pool_gather": 3},
}
GATHERS = ("aten.index.Tensor", "aten.embedding.default", "aten.index_select.default",
           "aten.gather.default", "aten.take.default")
_CASES = {}


def _case(name, **port_kw):
    """(JAX bundle, JAX state, JAX batch and dense, port bundle, port state,
    port batch and dense), the port's state bridged from the JAX one."""
    key = (name, tuple(sorted(port_kw.items())))
    if key not in _CASES:
        jkw, pkw, b = MODELS[name]
        jbundle = jax_create_model(name, **jkw)
        pbundle = create_model(name, device="cpu", **pkw, **port_kw)
        jb, jd, _, _ = jax_synthetic_batch(jbundle, b, seed=1)
        jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(4), jb, dense_inputs=jd)
        pstate = bridge.from_jax_numpy(
            pbundle, jax.tree.map(np.asarray, jstate.params),
            {k: np.asarray(v) for k, v in jbundle.embedding.weights(jstate.tables).items()})
        pb, pd, _, _ = synthetic_batch(pbundle, b, seed=1)
        for k, v in jb.items():      # the two packages draw the same batch
            np.testing.assert_array_equal(pb[k].rows.numpy(), np.asarray(v.rows), err_msg=k)
            np.testing.assert_array_equal(pb[k].mask.numpy(), np.asarray(v.mask), err_msg=k)
        _CASES[key] = (jbundle, jstate, jb, jd, pbundle, pstate, pb, pd)
    return _CASES[key]


def _close(got, want, what):
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), err_msg=f"{what} {k}",
                                   **TOL)


def _op_nodes(program):
    counts = {}
    for node in program.graph.nodes:
        target = str(node.target)
        if node.op == "call_function" and target.startswith(_ops.NAMESPACE + "."):
            name = target.split(".")[1]
            counts[name] = counts.get(name, 0) + 1
    return counts


def _table_gathers(program):
    """The graph's aten gathers that read a table input."""
    tables = {n for n in program.graph.nodes
              if n.op == "placeholder" and n.name.startswith("tables_w")}
    return [str(n) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target) in GATHERS
            and any(a in tables for a in n.args if isinstance(a, torch.fx.Node))]


@pytest.mark.parametrize("name", list(MODELS))
def test_loaded_program_matches_predict_step_and_jax(name, tmp_path):
    jbundle, jstate, jb, jd, pbundle, pstate, pb, pd = _case(name)
    blob = export_serving(pbundle, pstate, pb, pd, path=str(tmp_path / "port"))
    assert (tmp_path / "port" / "model.pt2").read_bytes() == blob
    got = load_serving(blob)(weights_of(pstate), pstate.params, pb, pd)
    _close(got, make_predict_step(pbundle)(pstate, pb, pd), f"{name}: predict step")

    jweights = jbundle.embedding.weights(jstate.tables)
    _close(got, jax_export.make_serving_fn(jbundle)(jweights, jstate.params, jb, jd),
           f"{name}: JAX make_serving_fn")
    jblob = jax_export.export_serving(jbundle, jstate, jb, jd, path=str(tmp_path / "jax"))
    _close(got, jax_export.load_serving(jblob)(jweights, jstate.params, jb, jd),
           f"{name}: JAX load_serving")
    port_sig = json.loads((tmp_path / "port" / "signature.json").read_text())
    jax_sig = json.loads((tmp_path / "jax" / "signature.json").read_text())
    assert port_sig == jax_sig


@pytest.mark.parametrize("name", list(MODELS))
def test_exported_graph_holds_the_kernels(name):
    *_, pbundle, pstate, pb, pd = _case(name)
    program = export_program(pbundle, pstate, pb, pd)
    assert _op_nodes(program) == OP_NODES[name]
    assert _table_gathers(program) == []
    # the artifact holds no weights: the tables and params are inputs
    assert dict(program.state_dict) == {}
    assert sum(t.numel() for t in program.constants.values()) <= 401   # staytime's bins


def test_interacting_layer_outside_kernel_takes_exports_k5f():
    """A layer of 16 units is no width K6 takes: its transposed path's K5f
    is one op node, and the loaded program equals the eager layer."""

    class Tower(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.layer = InteractingLayer(16, unit_num=16, head_num=2)

        def forward(self, x):
            return self.layer(x)

    torch.manual_seed(0)
    tower, x = Tower(), torch.randn(5, 6, 16)
    with torch.no_grad():
        program = torch.export.export(tower, (x,), strict=False)
        want = tower(x)
    assert _op_nodes(program) == {"field_attention_fwd": 1}
    with torch.no_grad():
        got = program.module()(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_loaded_program_is_static_in_the_batch():
    """One artifact per bucket, as the JAX export: a batch of another size
    raises, naming the input."""
    *_, pbundle, pstate, pb, pd = _case("autoint")
    serve = load_serving(export_serving(pbundle, pstate, pb, pd))
    other, dense, _, _ = synthetic_batch(pbundle, 16, seed=2)
    with pytest.raises(RuntimeError, match="rows.shape"):
        serve(weights_of(pstate), pstate.params, other, dense)


def test_bf16_compute_export_matches_the_bf16_predict_step():
    *_, pbundle, pstate, pb, pd = _case("autoint", compute_dtype=torch.bfloat16)
    assert pbundle.compute_dtype == torch.bfloat16
    got = load_serving(export_serving(pbundle, pstate, pb, pd))(
        weights_of(pstate), pstate.params, pb, pd)
    want = make_predict_step(pbundle)(pstate, pb, pd)
    assert all(v.dtype == torch.float32 for v in got.values())
    _close(got, want, "autoint bf16")


def test_loading_makes_no_weights_only_fallback(monkeypatch):
    """Loading goes through ``torch.load(weights_only=True)`` alone, also
    for a program that keeps its example inputs (IdBatch among them): every
    ``torch.load`` call of the loader is recorded."""
    *_, pbundle, pstate, pb, pd = _case("autoint")
    program = export_program(pbundle, pstate, pb, pd)
    program.example_inputs = ((weights_of(pstate), pstate.params, pb, pd), {})
    buf = io.BytesIO()
    torch.export.save(program, buf)
    calls, real = [], torch.load

    def spy(*args, **kwargs):
        calls.append(kwargs.get("weights_only"))
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "load", spy)
    loaded = load_program(buf.getvalue())
    assert calls and all(w is True for w in calls), calls
    assert loaded.example_inputs[0][2].keys() == pb.keys()
    calls.clear()
    load_serving(export_serving(pbundle, pstate, pb, pd))
    assert all(w is True for w in calls), calls


@pytest.mark.parametrize("name", ["autoint", "staytime"])
def test_load_in_a_fresh_process_that_imports_only_the_port(name, tmp_path):
    *_, pbundle, pstate, pb, pd = _case(name)
    export_serving(pbundle, pstate, pb, pd, path=str(tmp_path))
    want = make_predict_step(pbundle)(pstate, pb, pd)
    torch.save({"weights": weights_of(pstate), "params": pstate.params,
                "batch": {k: (v.rows, v.mask) for k, v in pb.items()}, "dense": pd,
                "want": want}, tmp_path / "inputs.pt")
    script = f"""
import sys, torch
from recommendsystem_tpu_torch.embedding import IdBatch
from recommendsystem_tpu_torch.train.export import load_serving
d = torch.load({str(tmp_path / "inputs.pt")!r})
batch = {{k: IdBatch(*v) for k, v in d["batch"].items()}}
got = load_serving(open({str(tmp_path / "model.pt2")!r}, "rb").read())(
    d["weights"], d["params"], batch, d["dense"])
assert set(got) == set(d["want"])
for k, v in d["want"].items():
    torch.testing.assert_close(got[k], v, rtol=1e-5, atol=2e-6)
bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "flax"))
       or m == "recommendsystem_tpu" or m.startswith("recommendsystem_tpu.")]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]
