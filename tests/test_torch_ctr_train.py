"""The port's packed train step on ctr against the JAX package's.

Both start from the same state, carried across by ``bridge.from_jax_numpy``
(dense params, optax's Adam state, the tables' classic per-row view), and
take 3 steps on one batch with attention dropout off on both sides (the two
packages draw other dropout bits): at ctr's default widths (24 slots of
48-wide rows, 5 ids a column), once with the InteractingLayer as the eval
path takes it (K6's plain version) and once through its transposed K5
path, as a training step with dropout takes it on the card; and at the
212-feature shape (``synthetic_ctr_config(num_slots=180, num_bias=32)``,
F = 180, 56-wide rows, one id a column).  The loss includes the L1L2
penalties of the six regularized Dense layers; ``regularization`` is
held to the JAX step's.  Tolerances as ``tests/test_torch_autoint_train.py``:
losses and ``regularization`` rtol 1e-5; weights atol 1e-5; moments rtol
1e-4, atol 1e-9; t and show exact.  Buckets of 256 ids, B = 32.

Each runs at batch seeds 3 and 4.  Float32 steps of a ReLU tower can meet
a kink: a ReLU input within rounding of 0 that lies above 0 in one package
and below it in the other sends one sample's gradient through a unit on
one side only (at seed 3 one does, at the 212-feature shape).  So an entry
past its tolerance passes only where such a kink explains it, by the rule
of ``chip_smoke.witness``: every ReLU input of the port's step is paired
with the JAX step's (each input handed to ``jax.debug.callback`` inside
the jitted step, whose roundings an eager forward does not share); a flip (the signs differ) is a kink where both values lie
within ``KINK_RTOL`` of the call's largest |input| or within the largest
difference between the packages among the call's elements that did not
flip, and every flip of a step after a kink counts as one; any other flip
fails the test.  A table row past a tolerance is explained where a sample
that reads it had a kink; a dense entry where any step had one.  Losses,
``regularization``, t and show are never explained.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from torch.overrides import TorchFunctionMode

from chip_smoke import GRAD_ROUND, KINK_RTOL, _sample_of

from recommendsystem_tpu.core.config import synthetic_ctr_config as jax_synthetic_ctr_config
from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.nn import mlp as jax_mlp
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train.step import make_train_step as jax_make_train_step
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.train import make_train_step
from recommendsystem_tpu_torch.kernels.interacting import (PARAM_NAMES,
                                                           interacting_attention_plain)
from test_torch_autoint_train import ATOL, LOSS_RTOL, MOMENT_TOL, _flat

_K6_OP = (torch.ops.recommendsystem_tpu_torch.interacting_attention,
          torch.ops.recommendsystem_tpu_torch.interacting_attention.default)

torch.set_num_threads(1)
BUCKET = 256
BATCH = 32


def bridged(jbundle, pbundle, ids_per_feature=5, seed=4, key=0):
    """(JAX state, batch, labels, weights), (port state, batch, labels,
    weights): a fresh JAX state, carried across whole, and one batch drawn
    alike on both sides."""
    jb, _, jl, jw = jax_synthetic_batch(jbundle, BATCH, seed=seed,
                                        ids_per_feature=ids_per_feature)
    pb, _, pl, pw = synthetic_batch(pbundle, BATCH, seed=seed,
                                    ids_per_feature=ids_per_feature)
    jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(key), jb)
    pstate = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        jax.device_get(jbundle.embedding.classic_state(jstate.tables)),
        opt_state=jax.tree.map(np.asarray, jstate.opt_state))
    return (jstate, jb, jl, jw), (pstate, pb, pl, pw)


def jax_steps(jbundle, jax_side, sample_weight=None, steps=3):
    """The JAX state after ``steps`` packed steps and each step's info."""
    jstate, jb, jl, jw = jax_side
    jstep = jax_make_train_step(jbundle, donate=False, sparse_update="packed")
    infos = []
    for i in range(steps):
        jstate, info = jstep(jstate, jb, jl, jw if sample_weight is None else sample_weight,
                             None, jax.random.PRNGKey(i))
        infos.append(jax.device_get(info))
    return jstate, infos


def port_steps_match(pbundle, port_side, jinfos, sample_weight=None):
    """Takes as many port steps as ``jinfos`` has, each step's loss,
    per-task losses and ``regularization`` held to the JAX step's; returns
    the port state.  The CPU launches no kernel."""
    pstate, pb, pl, pw = port_side
    step = make_train_step(pbundle)
    reset_launch_counts()
    for i, jinfo in enumerate(jinfos):
        pstate, pinfo = step(pstate, pb, pl, pw if sample_weight is None else sample_weight,
                             None, seed=i)
        assert set(pinfo) == set(jinfo)
        for name, want in jinfo.items():
            assert pinfo[name].ndim == 0, name
            np.testing.assert_allclose(float(pinfo[name]), float(want), rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {name}")
        assert float(pinfo["regularization"]) > 0.0
    assert pstate.step == len(jinfos)
    assert set(launch_counts().values()) == {0}
    return pstate


class _ReluInputs(TorchFunctionMode):
    """Records a copy of the input of every ReLU the port calls.  K6 is an
    opaque custom op, whose implementation runs outside the mode: its CPU
    implementation, the plain version, is run here in the mode instead, so
    that its ReLUs are recorded too."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.relu, torch.nn.functional.relu, torch.Tensor.relu):
            self.calls.append(args[0].detach().clone().numpy())
        if func in _K6_OP and args[0].device.type == "cpu":
            x, *p, head_num, ln_eps = args
            with self:
                return interacting_attention_plain(x, dict(zip(PARAM_NAMES, p)), head_num,
                                                   ln_eps)
        return func(*args, **(kwargs or {}))


def _in_jax_layout(p, shape):
    """A port ReLU input laid out as the JAX call of ``shape`` lays it out:
    the same, or the InteractingLayer's batch-minor transposes ((B F, U) ->
    (U, F B); (B, F, U) -> (U, F, B)); None where neither fits."""
    if p.shape == shape:
        return p
    if p.ndim == 3 and p.shape[::-1] == shape:
        return p.transpose(2, 1, 0)
    if p.ndim == 2 and p.shape[::-1] == shape and p.shape[0] % BATCH == 0:
        n, u = p.shape
        return p.reshape(BATCH, n // BATCH, u).transpose(2, 1, 0).reshape(u, n)
    return None


def _paired(port_calls, jax_calls):
    """Each JAX ReLU input with the port's that computes it: of the port's
    calls not yet paired that take the JAX call's layout, the one whose
    values lie nearest (the median difference, so that a kinked sample's
    entries do not count), which must be within 1e-4 of the call's largest
    |input|."""
    free = list(range(len(port_calls)))
    pairs = []
    for j in jax_calls:
        scale = max(float(np.abs(j).max()), 1e-30)
        near = []
        for k in free:
            p = _in_jax_layout(port_calls[k], j.shape)
            if p is not None:
                near.append((float(np.median(np.abs(p - j))) / scale, k, p))
        assert near, f"no ReLU call of the port takes the JAX call's shape {j.shape}"
        dist, k, p = min(near, key=lambda x: x[0])
        assert dist <= 1e-4, f"the port's nearest ReLU call to the JAX {j.shape} is {dist} off"
        pairs.append((p, j))
        free.remove(k)
    assert not free, f"{len(free)} ReLU calls of the port have no JAX counterpart"
    return pairs


def kinked_samples(port_steps, jax_steps):
    """{step: samples with a kink}, by ``chip_smoke.witness``'s rule, over
    the steps' paired ReLU inputs; fails on a flip that is no kink."""
    kinks = {}
    for step, (pcalls, jcalls) in enumerate(zip(port_steps, jax_steps), 1):
        earlier = any(kinks.values())
        kinks[step] = set()
        for p, j in _paired(pcalls, jcalls):
            flipped = (p > 0) != (j > 0)
            if not flipped.any():
                continue
            near = max(KINK_RTOL * float(np.abs(j).max()),
                       float(np.where(flipped, 0.0, np.abs(p - j)).max()))
            for idx in zip(*np.nonzero(flipped)):
                pv, jv = float(p[idx]), float(j[idx])
                # a step after a kink starts from states apart by more than
                # rounding: its flips follow from it
                assert earlier or max(abs(pv), abs(jv)) <= near, (
                    f"step {step}: a ReLU input of shape {j.shape} flipped far from 0: "
                    f"port {pv}, JAX {jv}, near {near}")
                kinks[step].add(_sample_of(j.shape, idx, BATCH))
    return kinks


def _jax_step_grads(jbundle, jstates):
    """Each JAX step's gradients, recovered from the first moments before
    and after it, g = (m' - b1 m) / (1 - b1), as float64: a table row's as
    the lazy pass took it (one batch: the same rows live in every step), a
    dense entry's as Adam took it."""
    eng = jbundle.embedding
    b1s, b1d = eng.sparse_opt.beta1, 0.9      # the JAX factories' Adam b1
    moments = [({k: np.asarray(t["opt"]["m"], np.float64) for k, t in
                 jax.device_get(eng.classic_state(s.tables)).items()},
                {k: np.asarray(v, np.float64) for k, v in
                 _flat(jax.device_get(s.opt_state[0].mu)).items()}) for s in jstates]
    return [({k: (t1[k] - b1s * t0[k]) / (1 - b1s) for k in t1},
             {k: (d1[k] - b1d * d0[k]) / (1 - b1d) for k in d1})
            for (t0, d0), (t1, d1) in zip(moments, moments[1:])]


def _differs(gp, gj):
    """Where a gradient (one tensor, one step) differs between the packages
    by more than ``GRAD_ROUND`` of its largest |value| (``chip_smoke.
    _beyond_rounding``)."""
    return np.abs(gp - gj) > GRAD_ROUND * np.abs(gj).max()


def _first_apart(pgrads, jgrads, pick):
    """Per entry, the first step (1-based) whose gradients differ beyond
    rounding between the packages, 0 where none does; ``pick(grads)``
    selects the tensor."""
    first = None
    for step, (p, j) in enumerate(zip(pgrads, jgrads), 1):
        apart = _differs(pick(p), pick(j))
        first = np.where(apart, step, 0) if first is None else np.where(
            (first == 0) & apart, step, first)
    return first


def _nest(flat):
    out = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def assert_port_updates_replay(jbundle, jstate0, pstate, pgrads, counts):
    """The JAX package's updates applied to the port's own gradients, step
    by step from the initial state (the witness's replay): the JAX lazy
    Adam (``SparseAdam.update``) on each storage's accumulated gradient and
    optax's Adam on the dense ones.  The port's state must equal the replay
    at the tolerances: a fault in an update is never explained."""
    eng = jbundle.embedding
    tables = jax.device_get(eng.classic_state(jstate0.tables))
    params, opt_state = jstate0.params, jstate0.opt_state
    for table_grads, dense_grads in pgrads:
        for skey, g in table_grads.items():
            live = (counts[skey].numpy() > 0).astype(np.float32)
            w, st = eng.sparse_opt.update(tables[skey]["w"], g.astype(np.float32),
                                          tables[skey]["opt"], live)
            tables[skey] = {"w": np.asarray(w), "opt": jax.device_get(st)}
        updates, opt_state = jbundle.dense_optimizer.update(
            _nest({k: v.astype(np.float32) for k, v in dense_grads.items()}),
            opt_state, params)
        params = optax.apply_updates(params, updates)
    for skey, want in tables.items():
        got = pstate.tables[skey]
        np.testing.assert_allclose(got["w"].numpy(), want["w"], rtol=0, atol=ATOL,
                                   err_msg=f"{skey} w: the port's update of its gradients")
        for name in ("m", "v"):
            np.testing.assert_allclose(got["opt"][name].numpy(), want["opt"][name],
                                       **MOMENT_TOL, err_msg=f"{skey} {name}: the update")
        np.testing.assert_array_equal(got["opt"]["t"].numpy(), want["opt"]["t"])
    for k, v in _flat(jax.device_get(params)).items():
        np.testing.assert_allclose(pstate.params[k].numpy(), v, rtol=0, atol=ATOL,
                                   err_msg=f"{k}: the port's Adam of its gradients")


def assert_states_match_or_kinked(jbundle, jstate, pstate, batch, kinks, pgrads, jgrads):
    """``_assert_states_match``'s tolerances; an entry past them passes only
    as ``chip_smoke.witness`` explains it (the updates being right,
    ``assert_port_updates_replay``): its gradients agree within rounding in
    every step (an update turns a rounding of a small gradient into a
    visible step), or they first differ in a step after one with a kink
    (the sides start that step apart by more than rounding, as the witness
    counts every flip of such a step), or in a step with a kink where, for a
    table row, a sample that reads it has one.  t, show and Adam's count
    exact."""
    eng = jbundle.embedding
    before = {s: any(kinks[k] for k in kinks if k < s) for s in kinks}
    upto = {s: set().union(*(kinks[k] for k in kinks if k <= s)) for s in kinks}
    readers = {}
    for key, ib in batch.items():
        skey, offset, _ = eng.table_map[eng.columns[key].categorical_column.key]
        for smp, r in zip(*np.nonzero(ib.mask.numpy() > 0)):
            readers.setdefault((skey, int(ib.rows[smp, r]) + offset), set()).add(int(smp))
    jc = jax.device_get(eng.classic_state(jstate.tables))
    assert set(jc) == set(pstate.tables)
    for skey, want in jc.items():
        got = pstate.tables[skey]
        np.testing.assert_array_equal(got["opt"]["t"].numpy(), want["opt"]["t"], err_msg=skey)
        np.testing.assert_array_equal(got["show"].numpy(), want["show"], err_msg=skey)
        entries = _first_apart(pgrads, jgrads, lambda g: g[0][skey])
        first = np.where(entries > 0, entries, np.inf).min(axis=1)   # a row's first step
        for name, g, w, tol in (("w", got["w"], want["w"], dict(rtol=0, atol=ATOL)),
                                ("m", got["opt"]["m"], want["opt"]["m"], MOMENT_TOL),
                                ("v", got["opt"]["v"], want["opt"]["v"], MOMENT_TOL)):
            g = g.numpy()
            past = ~np.isclose(g, w, **tol)
            for r in np.nonzero(past.any(axis=1))[0]:
                f = first[r]
                assert f == np.inf or before[int(f)] or readers.get(
                    (skey, int(r)), set()) & upto[int(f)], (
                    f"{skey} {name} row {r}: past its tolerance, its gradients apart beyond "
                    f"rounding from step {f} with no kink before and no kinked reader "
                    f"(largest difference {np.abs(g[r] - w[r]).max()})")
    jp = _flat(jax.device_get(jstate.params))
    assert set(jp) == set(pstate.params)
    for k, v in jp.items():
        past = ~np.isclose(pstate.params[k].numpy(), v, rtol=0, atol=ATOL)
        first = _first_apart(pgrads, jgrads, lambda g: g[1][k])
        for idx in zip(*np.nonzero(past)):
            f = int(first[idx])
            assert f == 0 or upto[f], (
                f"{k}{list(idx)}: past atol {ATOL}, its gradients apart beyond rounding "
                f"from step {f}, with no kink by then")
    assert pstate.opt_state["count"] == int(jstate.opt_state[0].count)


def witnessed_steps(jbundle, pbundle, jax_side, port_side, jstate, jinfos, jstates,
                    jax_relu, monkeypatch):
    """The port's 3 steps (``port_steps_match``) with their ReLU inputs and
    gradients recorded (the dense ones as Adam takes them, the tables' as
    the lazy pass takes them), the replay of its updates, then the states
    held to the JAX state by ``assert_states_match_or_kinked``; returns
    {step: kinked samples}."""
    tables = port_side[0].tables
    names = {id(t["w"]): skey for skey, t in tables.items()}
    grads = []
    real_group = packed.sparse_update_group
    adam = type(pbundle.dense_optimizer)
    real_dense = adam.update_

    def record_tables(opt, tstates, accs):
        tstates, accs = list(tstates), list(accs)
        grads.append(({names[id(ts["w"])]: packed.accumulator_views(
            acc, ts["w"].shape[1])[0].double().numpy().copy()
            for ts, acc in zip(tstates, accs)}, grads.pop()[1]))
        return real_group(opt, tstates, accs)

    def record_dense(self, params, g, state):
        grads.append((None, {k: v.double().numpy().copy() for k, v in g.items()}))
        return real_dense(self, params, g, state)

    rec = _ReluInputs()
    with monkeypatch.context() as m:
        m.setattr(packed, "sparse_update_group", record_tables)
        m.setattr(adam, "update_", record_dense)
        with rec:
            pstate = port_steps_match(pbundle, port_side, jinfos)
    per_step = len(rec.calls) // len(jinfos)
    port_relu = [rec.calls[i * per_step:(i + 1) * per_step] for i in range(len(jinfos))]
    kinks = kinked_samples(port_relu, jax_relu)
    counts = pbundle.embedding.row_counts(port_side[1])
    assert_port_updates_replay(jbundle, jstates[0], pstate, grads, counts)
    assert_states_match_or_kinked(jbundle, jstate, pstate, port_side[1], kinks, grads,
                                  _jax_step_grads(jbundle, jstates + [jstate]))
    return kinks


def jax_steps_with_states(jbundle, jax_side, steps=3):
    """``jax_steps``, the JAX state before each step, and each step's ReLU
    inputs in call order: ``jax.nn.relu`` and the Dense layers' "relu"
    hand what they see to ``jax.debug.callback`` inside the jitted step.
    So they are the inputs of the computation whose gradients the witness
    compares: XLA compiles the step with other roundings than an eager
    forward, and a ReLU input within rounding of 0 can lie on the other
    side of it there (the 212-feature shape at batch seed 3 has one in
    sample 10, which an eager forward does not show)."""
    jstate, jb, jl, jw = jax_side
    real = jax.nn.relu
    calls = {}

    def relu(x):
        i = len(calls)
        calls[i] = None
        jax.debug.callback(lambda v, i=i: calls.__setitem__(i, np.asarray(v)), x)
        return real(x)

    states, infos, relu_inputs = [], [], []
    old, jax_mlp.ACTIVATIONS["relu"], jax.nn.relu = jax_mlp.ACTIVATIONS["relu"], relu, relu
    try:
        jstep = jax_make_train_step(jbundle, donate=False, sparse_update="packed")
        for i in range(steps):
            states.append(jstate)
            calls.clear()
            jstate, info = jstep(jstate, jb, jl, jw, None, jax.random.PRNGKey(i))
            infos.append(jax.device_get(info))
            assert calls and all(v is not None for v in calls.values()), (
                "a ReLU input of the JAX step was not recorded")
            relu_inputs.append([calls[k] for k in range(len(calls))])
    finally:
        jax_mlp.ACTIVATIONS["relu"], jax.nn.relu = old, real
    return jstate, infos, states, relu_inputs


@pytest.mark.parametrize("seed", [3, 4])
def test_three_steps_match_jax_at_default_widths(monkeypatch, seed):
    jbundle = jax_create_model("ctr", bucket_size=BUCKET, attention_dropout_rate=0.0)
    pbundle = create_model("ctr", bucket_size=BUCKET, attention_dropout_rate=0.0,
                           device="cpu")
    assert {d for _, d in pbundle.embedding.storage.values()} == {48}
    jside, pside = bridged(jbundle, pbundle, seed=seed)
    jstate, jinfos, jstates, jrelu = jax_steps_with_states(jbundle, jside)
    witnessed_steps(jbundle, pbundle, jside, pside, jstate, jinfos, jstates, jrelu,
                    monkeypatch)
    # the same steps through the layer's transposed K5 path
    layer = pbundle.module.interacting
    monkeypatch.setattr(layer, "forward", layer.forward_transposed)
    _, pside = bridged(jbundle, pbundle, seed=seed)
    witnessed_steps(jbundle, pbundle, jside, pside, jstate, jinfos, jstates, jrelu,
                    monkeypatch)


@pytest.mark.parametrize("seed", [3, 4])
def test_three_steps_match_jax_at_the_212_feature_shape(monkeypatch, seed):
    jbundle = jax_create_model("ctr", cfg=jax_synthetic_ctr_config(num_slots=180, num_bias=32),
                               bucket_size=BUCKET, attention_dropout_rate=0.0)
    pbundle = create_model("ctr", cfg=synthetic_ctr_config(num_slots=180, num_bias=32),
                           bucket_size=BUCKET, attention_dropout_rate=0.0, device="cpu")
    assert sum(1 for n, _ in pbundle.module.named_children()
               if n.startswith("emb_linear_map_")) == 180
    assert {d for _, d in pbundle.embedding.storage.values()} == {56}
    jside, pside = bridged(jbundle, pbundle, ids_per_feature={}, seed=seed)
    assert all(v.rows.shape == (BATCH, 1) for v in pside[1].values())
    jstate, jinfos, jstates, jrelu = jax_steps_with_states(jbundle, jside)
    witnessed_steps(jbundle, pbundle, jside, pside, jstate, jinfos, jstates, jrelu,
                    monkeypatch)


def test_relu_recorder_sees_the_interacting_layer_as_its_plain_version():
    """``_ReluInputs`` runs K6's op as its plain version in the mode: on a
    training call of the InteractingLayer (the K6 path, through its
    autograd Function) it records the same ReLU inputs, in the same count
    and order, as ``interacting_attention_plain`` called directly, and the
    backward's recompute records none."""
    from recommendsystem_tpu_torch.nn.interacting import InteractingLayer

    torch.manual_seed(0)
    layer = InteractingLayer(8, unit_num=8, head_num=2, device="cpu")
    x = torch.randn(4, 6, 8, requires_grad=True)
    rec = _ReluInputs()
    with rec:
        out = layer(x, training=True)
        out.square().sum().backward()
    direct = _ReluInputs()
    p = {"wq": layer.wq, "bq": layer.bq, "wk": layer.wk, "bk": layer.bk, "wv": layer.wv,
         "bv": layer.bv, "wr": layer.wr, "br": layer.br, "gamma": layer.ln_scale,
         "beta": layer.ln_bias}
    with direct, torch.no_grad():
        want = interacting_attention_plain(x, p, 2, layer.ln_epsilon)
    assert len(rec.calls) == len(direct.calls) == 5
    for got, exp in zip(rec.calls, direct.calls):
        np.testing.assert_array_equal(got, exp)
    np.testing.assert_array_equal(out.detach().numpy(), want.numpy())
