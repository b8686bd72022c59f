"""bf16 under a model axis: ctr with bf16 tables, bf16 Adam moments and the
bf16 compute policy, tensor-parallel on a data 2 x model 2 mesh of 4 gloo
ranks, against the JAX package's TP step built the same way.

One step from one bridged state (``torch_sharded_common.bridged_case``,
24 kernels column-split).  The JAX training InteractingLayer takes its
flash path through the stand-in of ``tests/test_torch_bf16_compute.py``
(the reference on the widened bf16 projections, dropout off: the JAX K5
refuses bf16 inputs), as the port's layer takes its K5 path at a dropout
rate of 0; nothing in the JAX package changes.  At the policy's
tolerances (``tests/test_torch_bf16_compute.py``):

- the loss and ``regularization`` rtol 1e-2 of the JAX TP step's;
- each dense gradient as the port's dense Adam takes it (the split ones
  gathered whole) within 2e-2 relative L2 of ``jax.grad`` of the JAX loss
  on the TP-placed state;
- the stored bf16 entries (w, m, v): each package's float32 values
  before rounding come from its float32 twin (the same step, the same
  policy, float32 tables and moments, from the same state widened); each
  package stores its twin's value rounded once (exact); the twins' w
  updates and moments agree across the packages within 2e-2 relative L2;
  every entry whose twins agree to 1e-6 relative follows the bf16 rule of
  ``tests/test_torch_bf16_tables.py`` (``assert_bf16_rule``: equal, or one
  ulp apart across a midpoint); t and show exact; the master params and
  Adam moments float32;
- the model replicas' bf16 tables bit for bit;
- a column-split bf16 ``Dense``: x's gradient is the float32 sum of the
  model ranks' partial products rounded once to bf16 (the fault this test
  found: each rank's partial was rounded before the sum).

One spawn of 4 ranks runs the step, its twin and the ``Dense``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from recommendsystem_tpu.kernels import field_attention_pallas as jfa
from recommendsystem_tpu.kernels import flags as jflags
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.train import step as jstep_mod
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.models import create_model
from test_torch_bf16_compute import _flash_stand_in
from test_torch_bf16_tables import BF16_RTOL, _f32, assert_bf16_rule
from test_torch_bf16_train import _bridge, _jax_twin_state
from test_torch_tensor_parallel import KW
from torch_sharded_common import bridged_case, jax_tp_steps, run_ranks

torch.set_num_threads(1)
DATA, MODEL = 2, 2
LOSS_RTOL = 1e-2
GRAD_REL_L2 = 2e-2
BF = torch.bfloat16
BF16_KW = dict(KW, compute_dtype=BF, table_dtype=BF, opt_state_dtype=BF)
JAX_BF16_KW = dict(KW, compute_dtype=jnp.bfloat16, table_dtype=jnp.bfloat16,
                   opt_state_dtype=jnp.bfloat16)


def _jax_flash(mp):
    """The JAX training InteractingLayer on its flash path, through the
    stand-in (test-side)."""
    mp.setattr(jfa, "field_attention", _flash_stand_in)
    mp.setattr(jfa, "eligible", lambda *a: True)
    mp.setattr(jflags, "use_flash", lambda: True)


def _jax_grads(jbundle, jstate, batch, mesh, shardings):
    """``jax.grad`` of the JAX loss on the whole batch, the params placed as
    the TP step places them."""
    jb, jd, jl, jw = batch
    embs = jbundle.embedding.lookup(jbundle.embedding.weights(jstate.tables), jb)
    data = NamedSharding(mesh, P("data"))
    embs, jl, jw = (jax.device_put(x, jax.tree.map(lambda _: data, x)) for x in (embs, jl, jw))

    def loss(p):
        return jstep_mod._model_outputs_and_loss(
            jbundle, p, embs, jl, jw, jd, True, {"dropout": jax.random.PRNGKey(0)})[0]

    params = jax.device_put(jstate.params, shardings.params)
    return bridge._flatten(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params)))


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    rec = {}

    def steps(jbundle, jstate, batches, n, upd):
        rec["state"], rec["batches"] = jstate, batches
        return jax_tp_steps(jbundle, jstate, batches, n, upd, model=MODEL, record=rec)

    with pytest.MonkeyPatch.context() as mp:
        _jax_flash(mp)
        jbundle, jstate, jinfos, case = bridged_case(
            "ctr", BF16_KW, DATA, 8 * DATA, seeds=[1], jkw=JAX_BF16_KW, jax_steps=steps,
            model_parallel=MODEL, tensor_parallel=True, record_grads=True)
        jgrads = _jax_grads(jbundle, rec["state"], rec["batches"][0], rec["mesh"],
                            rec["shardings"])
        # the float32 twins: the same step and policy over float32 tables and
        # moments, from the same state widened
        twin_kw = dict(KW, compute_dtype=BF)
        jtwin = jax_create_model("ctr", num_shards=DATA, **dict(KW, compute_dtype=jnp.bfloat16))
        jtwin.embedding.packed_state = False
        classic = jax.device_get(jbundle.embedding.classic_state(rec["state"].tables))
        jt_state = _jax_twin_state(jtwin, rec["state"], classic)
        jt_state, _ = jax_tp_steps(jtwin, jt_state, rec["batches"], DATA, model=MODEL)
    ptwin = create_model("ctr", device="cpu", num_shards=DATA, **twin_kw)
    tstate = _bridge(ptwin, rec["state"], classic, float32=True)
    twin_case = dict(case, kwargs=twin_kw, record_grads=False,
                     state={"params": tstate.params, "opt_state": tstate.opt_state,
                            "tables": tstate.tables, "step": 0})
    column = _column_case()
    result, twin, dense = run_ranks(DATA * MODEL, [case, twin_case, column],
                                    tmp_path_factory.mktemp("tp_bf16"))
    return dict(jbundle=jbundle, jstate=jstate, jinfos=jinfos, jgrads=jgrads, init=classic,
                jtwin=jax.device_get(jtwin.embedding.classic_state(jt_state.tables)),
                result=result, twin=twin, column=(column, dense))


def _column_case(b=64, n_in=48, n_out=64, seed=5):
    """A bf16 ``Dense`` split by columns over the model axis: bf16 x,
    kernel and bias, a float32 cotangent (``dot_f32`` gives float32)."""
    rng = np.random.default_rng(seed)
    rand = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    return {"kind": "column_dense", "model_parallel": MODEL, "x": rand(b, n_in).to(BF),
            "kernel": rand(n_in, n_out).to(BF), "bias": rand(n_out).to(BF),
            "cotangent": rand(b, n_out)}


def test_column_dense_rounds_the_summed_x_gradient_once(group):
    """x's bf16 gradient through a column-split ``Dense`` is the float32
    sum of the model ranks' partial products rounded to bf16 once, as the
    JAX transpose of the split ``preferred_element_type=float32`` product
    rounds it, not the sum of each rank's partial rounded to bf16 (which
    differs from it here, and put 1,896 of the TP ctr step's bf16 moment
    entries past float32 rounding of JAX's, against 37 now)."""
    case, got = group["column"]
    per = case["kernel"].shape[1] // MODEL
    parts = [case["cotangent"][:, r * per:(r + 1) * per].contiguous()
             @ case["kernel"][:, r * per:(r + 1) * per].float().t() for r in range(MODEL)]
    want = (parts[0] + parts[1]).to(BF)
    assert got["x_grad"].dtype == BF
    assert torch.equal(got["x_grad"], want)
    rounded_each = (parts[0].to(BF).float() + parts[1].to(BF).float()).to(BF)
    assert not torch.equal(rounded_each, want)
    whole = case["x"].float() @ case["kernel"].float() + case["bias"].float()
    assert got["output"].dtype == torch.float32
    torch.testing.assert_close(got["output"], whole, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got["kernel_grad"].float(),
                               (case["x"].float().t() @ case["cotangent"]),
                               rtol=2.0 ** -7, atol=1e-6)


def test_loss_matches_the_jax_tp_step(group):
    got, want = group["result"]["infos"][0], group["jinfos"][0]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    assert group["result"]["replicas_equal"]
    assert sum(v == "column" for v in group["result"]["placements"].values()) == 24


def test_dense_gradients_match_jax_grad(group):
    got, want = group["result"]["grads"][0], group["jgrads"]
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32, k
        if not w.any():
            assert not g.any(), k
            continue
        err = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert err <= GRAD_REL_L2, (k, err)


def _leaf(entry, name):
    return entry["w"] if name == "w" else entry["opt"][name]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_stored_bf16_entries_follow_the_bf16_rule(group):
    """Each package stores its float32 twin's value rounded once to bf16
    (exact); the twins' float32 w updates and moments agree across the
    packages within the policy's relative L2; and every entry whose twins
    agree to float32 rounding (BF16_RTOL) follows the bf16 rule.  (Under
    the policy the cotangents of the embedding activations are bf16, so a
    package's rounding of one to the other side of a midpoint moves a row's
    gradient by a bf16 ulp: there the twins differ by more than the rule's
    premise allows, and the relative L2 holds them.)"""
    port, twin = group["result"]["state"], group["twin"]["state"]
    jc = jax.device_get(group["jbundle"].embedding.classic_state(group["jstate"].tables))
    jt, init = group["jtwin"], group["init"]
    ruled = outside = 0
    for skey, want in jc.items():
        got = port["tables"][skey]
        assert got["w"].dtype == got["opt"]["m"].dtype == got["opt"]["v"].dtype == BF
        for name in ("w", "m", "v"):
            g, w = _leaf(got, name), _leaf(want, name)
            p, j = _leaf(twin["tables"][skey], name), _leaf(jt[skey], name)
            what = f"{skey} {name}"
            assert torch.equal(g, p.to(BF)), what
            np.testing.assert_array_equal(_f32(w), _f32(jnp.asarray(j).astype(jnp.bfloat16)),
                                          err_msg=what)
            base = _f32(_leaf(init[skey], name)) if name == "w" else 0.0
            assert _rel_l2(_f32(p) - base, _f32(j) - base) <= GRAD_REL_L2, what
            close = np.isclose(_f32(p), _f32(j), rtol=BF16_RTOL, atol=0.0)
            outside += int((~close).sum())
            ruled += assert_bf16_rule(g[torch.from_numpy(close)], _f32(w)[close],
                                      _f32(p)[close], _f32(j)[close], what=what)
        np.testing.assert_array_equal(_f32(got["show"]), _f32(want["show"]), err_msg=skey)
        np.testing.assert_array_equal(_f32(got["opt"]["t"]), _f32(want["opt"]["t"]),
                                      err_msg=skey)
    assert {p.dtype for p in port["params"].values()} == {torch.float32}
    assert {p.dtype for p in port["opt_state"]["mu"].values()} == {torch.float32}
    print(f"{ruled} bf16 entries needed the rule; {outside} entries' twins differ past "
          f"float32 rounding")
