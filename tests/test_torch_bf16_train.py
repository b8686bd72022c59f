"""bf16 tables (and bf16 Adam moments) through the port's packed train step,
against the JAX package's: autoint with bf16 tables and bf16 moments (K8's
plain version over both), finish with bf16 tables (float32 moments) and
staytime with ``table_dtype="auto"`` (every 32-wide storage bf16; K9's
plain version); and the port's packed step against its own scatter step
over bf16 tables (the JAX package's ``tests/test_packed.py``
``test_bf16_tables_pack_and_match_scatter``: bit-equal).

Each of 3 steps starts from the same state in both packages: the JAX
package's state before the step, carried across by ``bridge`` (bf16 arrays
as they are); the JAX trajectory is the reference.  Every bf16 entry is
held to the bf16 rule of ``tests/test_torch_bf16_tables.py``
(``assert_bf16_rule``), with each package's float32 values before rounding
from its float32 twin (the same step over a float32 copy of the same
state), and the test reports how many entries needed the rule.  A bf16
moment may also differ by at most MOMENT_TOL's atol (1e-9) before rounding:
the float32 moments of the two packages agree no closer where a gradient
lies within rounding of 0 (a sum of terms that cancel).  float32
quantities keep the float32 tolerances of ``tests/test_torch_autoint_train.py``:
losses rtol 1e-5; dense params atol 1e-5; float32 moments and g2sum rtol
1e-4, atol 1e-9; t and show exact.  A free 3-step run of the port (no
re-synchronising) holds its losses to JAX's at rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.embedding import packed as jpk
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.models.staytime import StaytimeConfig as JaxStaytimeConfig
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.state import TrainState as JaxTrainState
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.train import create_train_state, make_train_step
from test_torch_autoint_train import ATOL, LOSS_RTOL, MOMENT_TOL, NO_DROPOUT, _flat
from test_torch_bf16_tables import _f32, assert_bf16_rule
from test_torch_staytime_serving import CFG16, HIDDEN

torch.set_num_threads(1)
BATCH = 16
FREE_LOSS_RTOL = 1e-4
BF16 = {"bf16": (jnp.bfloat16, torch.bfloat16), "auto": ("auto", "auto")}


def _make(name, table, moments, twin=False):
    """(JAX bundle, port bundle) of ``name`` with ``table`` / ``moments``
    keys of ``BF16`` (None: float32); ``twin``: both float32, the twin."""
    kw = {"autoint": dict(bucket_size=256, model_param=NO_DROPOUT),
          "finish": dict(bucket_size=256),
          "staytime": dict(deep_hidden_units=HIDDEN)}[name]
    jkw, pkw = dict(kw), dict(kw)
    if name == "staytime":
        jkw["cfg"], pkw["cfg"] = JaxStaytimeConfig(**CFG16), StaytimeConfig(**CFG16)
    if not twin:
        for arg, key in (("table_dtype", table), ("opt_state_dtype", moments)):
            if key is not None:
                jkw[arg], pkw[arg] = BF16[key]
    return jax_create_model(name, **jkw), create_model(name, device="cpu", **pkw)


def _classic(jbundle, jstate):
    return jax.device_get(jbundle.embedding.classic_state(jstate.tables))


def _bridge(pbundle, jstate, classic, float32=False):
    tables = jax.tree.map(lambda a: np.asarray(a, np.float32), classic) if float32 else classic
    return bridge.from_jax_numpy(pbundle, jax.tree.map(np.asarray, jstate.params), tables,
                                 step=int(jstate.step),
                                 opt_state=jax.tree.map(np.asarray, jstate.opt_state))


def _jax_twin_state(jtwin, jstate, classic):
    """The JAX twin's state: ``jstate`` with every table array float32, in
    the layout the twin's engine keeps each storage in."""
    eng = jtwin.embedding
    tables = {}
    for skey, entry in classic.items():
        entry32 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), entry)
        tables[skey] = eng._store_entry(skey, entry32, jpk.is_packed_state(jstate.tables[skey]))
    return JaxTrainState(params=jstate.params, opt_state=jstate.opt_state, tables=tables,
                         step=jstate.step)


def _compare(pstate, jc, twin, jtwin_c, jparams):
    """One step's states: bf16 entries by the rule, float32 ones by the
    float32 tolerances.  Returns the count of entries that needed the
    rule."""
    ruled = 0
    for skey, want in jc.items():
        got, tw, jt = pstate.tables[skey], twin.tables[skey], jtwin_c[skey]
        fields = [("w", got["w"], want["w"], tw["w"], jt["w"]),
                  ("show", got["show"], want["show"], None, None)] + [
            (n, got["opt"][n], want["opt"][n], tw["opt"][n], jt["opt"][n]) for n in want["opt"]]
        for name, g, w, p, j in fields:
            what = f"{skey} {name}"
            assert (g.dtype == torch.bfloat16) == (np.asarray(w).dtype.name == "bfloat16"), what
            if g.dtype == torch.bfloat16:
                # a moment also within MOMENT_TOL's atol: the float32
                # moments of the two packages agree no closer where a
                # gradient is within rounding of 0
                ruled += assert_bf16_rule(g, w, p, j, what=what,
                                          atol=0.0 if name == "w" else MOMENT_TOL["atol"])
            elif name in ("t", "show"):
                np.testing.assert_array_equal(_f32(g), _f32(w), err_msg=what)
            elif name == "w":
                np.testing.assert_allclose(_f32(g), _f32(w), rtol=0, atol=ATOL, err_msg=what)
            else:
                np.testing.assert_allclose(_f32(g), _f32(w), **MOMENT_TOL, err_msg=what)
    jp = _flat(jax.device_get(jparams))
    for k, v in jp.items():
        np.testing.assert_allclose(pstate.params[k].numpy(), v, rtol=0, atol=ATOL, err_msg=k)
    return ruled


CASES = [("autoint", "bf16", "bf16", 5), ("autoint", "bf16", "bf16", 1),
         ("finish", "bf16", None, 5), ("staytime", "auto", None, 5),
         ("staytime", "auto", None, 1)]


@pytest.mark.parametrize("name,table,moments,ipf", CASES)
def test_bf16_packed_steps_match_jax(name, table, moments, ipf):
    jbundle, pbundle = _make(name, table, moments)
    jtwin, ptwin = _make(name, table, moments, twin=True)
    if moments is not None:
        # the JAX engine keeps bf16 moments in the classic layout: so does its twin
        jtwin.embedding.packed_state = False
    eng = pbundle.embedding
    assert all(t == torch.bfloat16 for t in (eng.storage_dtype(d) for _, d in
                                             eng.storage.values()))
    jb, jd, jl, jw = jax_synthetic_batch(jbundle, BATCH, seed=3, ids_per_feature=ipf)
    pb, pd, pl, pw = synthetic_batch(pbundle, BATCH, seed=3, ids_per_feature=ipf)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(0), jb)
    jstep = jax_make_train_step(jbundle, donate=False, sparse_update="packed")
    jtstep = jax_make_train_step(jtwin, donate=False, sparse_update="packed")
    pstep, tstep = make_train_step(pbundle), make_train_step(ptwin)
    free = _bridge(pbundle, jstate, _classic(jbundle, jstate))
    reset_launch_counts()
    ruled, free_losses, jlosses = 0, [], []
    for i in range(3):
        classic = _classic(jbundle, jstate)
        pstate = _bridge(pbundle, jstate, classic)
        twin = _bridge(ptwin, jstate, classic, float32=True)
        jt_state = _jax_twin_state(jtwin, jstate, classic)
        assert pstate.tables[next(iter(pstate.tables))]["w"].dtype == torch.bfloat16
        jstate, jinfo = jstep(jstate, jb, jl, jw, jd, jax.random.PRNGKey(i))
        jt_state, _ = jtstep(jt_state, jb, jl, jw, jd, jax.random.PRNGKey(i))
        pstate, pinfo = pstep(pstate, pb, pl, pw, pd, seed=i)
        twin, _ = tstep(twin, pb, pl, pw, pd, seed=i)
        free, finfo = pstep(free, pb, pl, pw, pd, seed=i)
        np.testing.assert_allclose(float(pinfo["loss"]), float(jinfo["loss"]), rtol=LOSS_RTOL)
        ruled += _compare(pstate, _classic(jbundle, jstate), twin, _classic(jtwin, jt_state),
                          jstate.params)
        free_losses.append(float(finfo["loss"]))
        jlosses.append(float(jinfo["loss"]))
    np.testing.assert_allclose(free_losses, jlosses, rtol=FREE_LOSS_RTOL)
    assert set(launch_counts().values()) == {0}
    print(f"{name} {table}/{moments} ids {ipf}: {ruled} bf16 entries needed the rule")


def test_bf16_tables_pack_and_match_scatter():
    """bf16 storages take the fold path (``storages_packed`` admits them),
    and the packed step equals the classic scatter step bit for bit over 2
    steps: both round the same float32 update to bf16 (the JAX package's
    test of the same name)."""
    bundle = create_model("autoint", bucket_size=250, table_dtype=torch.bfloat16, device="cpu")
    pk, classic = packed.storages_packed(bundle.embedding)
    assert pk and not classic
    batch, dense, labels, weight = synthetic_batch(bundle, 16, seed=0)
    out = {}
    for mode in ("packed", "scatter"):
        state = create_train_state(bundle, seed=0)
        step = make_train_step(bundle, sparse_update=mode)
        losses = []
        for i in range(2):
            state, info = step(state, batch, labels, weight, dense, seed=i)
            losses.append(float(info["loss"]))
        out[mode] = (state, losses)
    np.testing.assert_allclose(out["packed"][1], out["scatter"][1], rtol=1e-5)
    for skey, t in out["scatter"][0].tables.items():
        assert out["packed"][0].tables[skey]["w"].dtype == torch.bfloat16
        assert torch.equal(out["packed"][0].tables[skey]["w"], t["w"]), skey
