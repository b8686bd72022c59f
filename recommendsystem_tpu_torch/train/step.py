"""Train, eval and predict steps of the port.

Counterpart of ``recommendsystem_tpu/train/step.py``, local mode:

- ``make_train_step`` takes the JAX package's three sparse updates
  (``sparse_update=``):
  - ``"packed"`` (the default): fused gather and fold with no gradient
    (K1 / K2), autograd of the loss with respect to the dense parameters
    and the folded activations (the InteractingLayer's attention runs K5f
    forward and K5b backward), dense Adam, then the unfold-scatter (K3 /
    K4) and the lazy pass of the engine's sparse optimizer over the tables
    (K8 for ``SparseAdam``, K9 for staytime's ``SparseAdaGrad``).  The
    columns of storages that ``packed.storages_packed`` rejects take the
    classic gather, combine and scatter within the same step, as in the JAX
    package; where the ``packed.state_packable`` storages reach the
    engine's ``row_update_min_rows``, they take the touched-rows update;
  - ``"scatter"``: the classic gather, autograd with respect to its float32
    (B, L, D) activations, then ``flatten_raw_grads`` and
    ``apply_gradients_scatter``;
  - ``"dense"``: the classic lookup differentiated with respect to the
    stored weights, then ``apply_gradients`` over whole tables;
- ``make_scan_train_step`` runs it over K batches in a Python loop, in
  place of the JAX package's ``lax.scan`` driver;
- ``make_predict_step`` is the fused lookup (sequence columns deferred to
  the DIN pool; the classic lookup for an engine built with
  ``packed=False``, as the JAX package chooses), the dense tower in the
  bundle's compute dtype and the bundle's ``predict_view``;
- ``make_eval_step`` is the predict step's lookup and tower, then the
  bundle's streaming metrics on the full outputs;
- ``total_loss_fn`` is the loss of the classic lookup and the tower, as
  the JAX function of that name computes it.

Tables may be stored in bfloat16 and Adam's moments too (the engine's
``table_dtype``, ``SparseAdam.state_dtype``); every lookup gives float32
and every update computes in float32.  The dense tower runs in the
bundle's ``compute_dtype``: float32, or the JAX package's bf16 policy,
which ``apply_model`` alone applies, in every step (predict, eval, and
train with each sparse update): the floating params, the embedding
activations and ``dense_inputs`` are cast to bf16 at use, inside the
autograd graph, and the outputs back to float32, so the master params, the
loss, the metrics and both optimizers stay float32, and the gradients that
reach the float32 params, the folded activations (K3 / K4) and the classic
scatter are the bf16 cotangents widened.  The L1L2 penalty is taken on the
cast kernels, as the JAX layers sow it from the bf16 kernels they hold.

Keras-compile semantics as in the JAX package: the loss is the sum over
tasks of ``loss_weight * loss``, where a loss that returns a scalar is taken
as it is (autoint's ``cross_entropy_sum_mean``, so its sample weights do not
reach it) and a per-sample loss is the sample-weighted mean, plus the L1L2
kernel penalties that the JAX layers sow into their ``"losses"``
collection: ``nn.kernel_penalty`` over ``nn.regularized_kernels`` of the
module (the kernels of every ``Dense`` with a ``kernel_regularizer``, of
``DNN`` and ``CrossNet`` with an ``l2_reg``, stacked kernels included).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Dict, Optional, Sequence, Union

import torch
from torch.func import functional_call

from ..embedding import packed as packed_mod
from ..embedding.optimizers import SparseAdaGrad, SparseAdam
from ..nn import kernel_penalty, regularized_kernels
from . import metrics as M
from .state import TrainState

if TYPE_CHECKING:
    from ..models.base import ModelBundle


def cast_floating(tree, dtype: torch.dtype):
    """The floating tensors of a nest of dicts, lists and tuples cast to
    ``dtype`` (``.to``, inside the autograd graph); bool masks and integer
    ids pass through, and a ``SequenceRows`` handle takes ``dtype`` as its
    facts' type: the JAX ``_cast_floating``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, packed_mod.SequenceRows):
        return dataclasses.replace(tree, dtype=dtype)
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def _policy(bundle: "ModelBundle") -> Optional[torch.dtype]:
    """The compute dtype to cast to, or None for a float32 tower."""
    dtype = bundle.compute_dtype
    return None if dtype == torch.float32 else dtype


def apply_model(bundle: "ModelBundle", params, embs, dense_inputs=None,
                training: bool = False, seed: int = 0):
    """Apply the bundle's module to ``params`` under its compute dtype, the
    one place every step applies the tower (``recommendsystem_tpu/train/
    step.py:36-54``): with bf16 the floating params, the embedding
    activations and ``dense_inputs`` are cast at use and the outputs back
    to float32; with float32 nothing is cast.  ``seed`` draws a training
    step's dropout."""
    dtype = _policy(bundle)
    if dtype is not None:
        params = cast_floating(params, dtype)
    return _apply_cast(bundle, params, embs, dense_inputs, training, seed)


def _apply_cast(bundle, params, embs, dense_inputs, training, seed):
    """``apply_model`` on params already in the compute dtype."""
    dtype = _policy(bundle)
    if dtype is not None:
        embs = cast_floating(embs, dtype)
        dense_inputs = cast_floating(dense_inputs, dtype)
    kwargs = {"training": training}
    if training:
        kwargs["seed"] = seed
    if dense_inputs is not None:
        kwargs["dense_inputs"] = dense_inputs
    out = functional_call(bundle.module, params, (embs,), kwargs)
    return out if dtype is None else cast_floating(out, torch.float32)


def _weighted_task_loss(loss_fn, y, pred, sample_weight):
    """Keras loss reduction: scalar losses pass through; per-sample /
    per-element losses are (sample-weighted) means."""
    raw = loss_fn(y, pred)
    if raw.ndim == 0:
        return raw
    if sample_weight is not None:
        w = sample_weight.reshape(raw.shape[0], *([1] * (raw.ndim - 1)))
        w = w.expand(raw.shape)
        return (raw * w).sum() / torch.clamp(w.sum(), min=1e-12)
    return raw.mean()


def _model_outputs_and_loss(bundle, params, embs, labels, sample_weight,
                            dense_inputs, training, seed, penalized):
    """The outputs and the loss; ``penalized`` is
    ``nn.regularized_kernels(bundle.module)``: when it is empty, the loss
    has no penalty term and ``regularization`` is None.  The penalty is
    taken on the params in the compute dtype (a float32 0-d tensor)."""
    dtype = _policy(bundle)
    cparams = params if dtype is None else cast_floating(params, dtype)
    outputs = _apply_cast(bundle, cparams, embs, dense_inputs, training, seed)
    loss = 0.0
    task_losses = {}
    for task, loss_fn in bundle.losses.items():
        lw = (bundle.loss_weights or {}).get(task, 1.0)
        tl = _weighted_task_loss(loss_fn, labels[task], outputs[task],
                                 sample_weight)
        task_losses[task] = tl
        loss = loss + lw * tl
    reg = None
    if penalized:
        reg = kernel_penalty(penalized, cparams).float()
        loss = loss + reg
    return loss, {"task_losses": task_losses, "regularization": reg,
                  "outputs": outputs}


def _check_mode(mode: str) -> None:
    if mode != "local":
        raise NotImplementedError(f"mode {mode!r}: the sharded modes come "
                                  f"with a later slice of the port")


def _seed_of(seed: Union[int, torch.Generator]) -> int:
    """A step seed below 2**32: ``seed`` itself, or drawn from a
    ``torch.Generator`` (the port's stand-in for the JAX ``rngs``)."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 1 << 32, (), generator=seed, dtype=torch.int64))
    return int(seed)


def total_loss_fn(bundle: "ModelBundle", params, table_weights, batch, labels,
                  sample_weight=None, dense_inputs=None, training: bool = True,
                  seed: Union[int, torch.Generator] = 0, mode: str = "local"):
    """The loss of ``params`` and the stored ``table_weights`` ({storage:
    (rows, D)}) on one batch, as ``recommendsystem_tpu/train/step.py:69-77``
    computes it: the classic ``lookup`` (differentiable in the weights),
    then the tower under the bundle's compute dtype and the Keras loss
    with the L1L2 penalty.  ``seed`` (an int below 2**32, or a
    ``torch.Generator`` to draw it from) stands for the JAX ``rngs``: it
    draws the dropout of a training call.  Returns ``(loss, aux)``, aux
    holding ``task_losses``, ``regularization`` (a 0-d tensor, 0 for a
    module with no penalty, as JAX sums an empty collection) and
    ``outputs``.  Any mode but ``"local"`` raises ``NotImplementedError``."""
    _check_mode(mode)
    embs = bundle.embedding.lookup(table_weights, batch)
    loss, aux = _model_outputs_and_loss(bundle, params, embs, labels, sample_weight,
                                        dense_inputs, training, _seed_of(seed),
                                        regularized_kernels(bundle.module))
    if aux["regularization"] is None:
        aux["regularization"] = torch.zeros((), device=loss.device)
    return loss, aux


SPARSE_UPDATES = ("packed", "scatter", "dense")


def _leaves(tensors):
    """Fresh leaves that need a gradient, sharing the tensors' storage."""
    return [t.detach().requires_grad_() for t in tensors]


def _store_tables(tables, new) -> None:
    """Copy the classic update paths' new state into ``tables`` in place,
    each tensor in its own type (the train step updates its state in
    place)."""
    for skey, nt in new.items():
        tstate = tables[skey]
        if nt is tstate:
            continue
        for name in ("w", "show"):
            tstate[name].copy_(nt[name])
        for name, t in tstate["opt"].items():
            t.copy_(nt["opt"][name])


def make_train_step(bundle: "ModelBundle", mode: str = "local",
                    sparse_update: Optional[str] = None) -> Callable:
    """Returns ``step(state, batch, labels, sample_weight=None,
    dense_inputs=None, seed=0) -> (state, info)``.  ``sparse_update`` is
    ``"packed"`` (the default, as in the JAX package), ``"scatter"`` or
    ``"dense"`` (module docstring); another name raises ``ValueError``.
    The packed update needs a lazy pass of the engine's sparse optimizer:
    ``SparseAdam`` (K8) or ``SparseAdaGrad`` (K9); any other raises
    ``NotImplementedError``.

    ``batch`` holds IdBatches and ``labels`` {task: (B, 1)} tensors on the
    bundle's device; ``seed`` (an int below 2**32) draws the step's
    attention dropout.  The step updates ``state``'s tables (w, the sparse
    optimizer's state, show; each in its storage type), dense parameters
    and Adam moments in place, where the JAX package donates them, and
    returns a ``TrainState`` over the same tensors with ``step + 1``.
    ``info`` holds the loss, the per-task losses and the L1L2 penalty
    (``regularization``; for a module with none, one 0 made when the step
    is built) as 0-d tensors on the device (read them when needed: reading
    waits for the step).

    A dense parameter that does not reach the loss (multi_head's eighth
    expert's bias; its kernel reaches it through its penalty alone) gets a
    zero gradient, as ``jax.grad`` gives it, so Adam moves it as optax
    does: not at all while its moments are 0."""
    _check_mode(mode)
    sparse_update = "packed" if sparse_update is None else sparse_update
    if sparse_update not in SPARSE_UPDATES:
        raise ValueError(f"sparse_update {sparse_update!r}: expected one of "
                         f"{', '.join(SPARSE_UPDATES)}")
    eng = bundle.embedding
    if sparse_update == "packed" and not isinstance(eng.sparse_opt,
                                                    (SparseAdam, SparseAdaGrad)):
        raise NotImplementedError(
            f"sparse optimizer {type(eng.sparse_opt).__name__}: the packed "
            f"train step has a lazy pass for SparseAdam (K8) and SparseAdaGrad "
            f"(K9) only")
    penalized = regularized_kernels(bundle.module)
    no_penalty = torch.zeros((), device=bundle.device)

    def loss_and_grads(state, embs, leaves, labels, sample_weight, dense_inputs,
                       seed):
        """The loss, its aux, and the gradients of the dense params (a
        dict) and of ``leaves`` (a list), the params' taken as fresh
        leaves of ``state.params``."""
        params = {k: p.detach().requires_grad_() for k, p in state.params.items()}
        loss, aux = _model_outputs_and_loss(bundle, params, embs(), labels,
                                            sample_weight, dense_inputs,
                                            True, seed, penalized)
        grads = torch.autograd.grad(loss, list(params.values()) + leaves,
                                    allow_unused=True, materialize_grads=True)
        return loss, aux, dict(zip(params, grads[:len(params)])), list(grads[len(params):])

    def finish(state, loss, aux, gp):
        """Dense Adam in place; the new state and the step's info."""
        with torch.no_grad():
            new_params = {k: p.detach() for k, p in state.params.items()}
            new_params, opt_state = bundle.dense_optimizer.update_(
                new_params, gp, state.opt_state)
        info = {"loss": loss.detach(),
                **{f"loss/{t}": v.detach()
                   for t, v in aux["task_losses"].items()},
                "regularization": (no_penalty if aux["regularization"] is None
                                   else aux["regularization"].detach())}
        return TrainState(params=new_params, opt_state=opt_state,
                          tables=state.tables, step=state.step + 1), info

    def step_packed(state: TrainState, batch, labels, sample_weight=None,
                    dense_inputs=None, seed: int = 0):
        pk, _ = packed_mod.storages_packed(eng)
        plans = packed_mod.plan_segments(eng, batch, storages=set(pk))
        classic_batch = packed_mod.classic_columns(eng, batch, plans)
        # stage 1 (no gradient): fused gather + fold; the classic gather for
        # the storages that cannot pack
        with torch.no_grad():
            ctx = packed_mod.gather_fold(eng, state.tables, batch, plans)
            raw = (eng.gather_raw(eng.weights(state.tables), classic_batch)
                   if classic_batch else {})
        acts = {skey: _leaves(c["acts"]) for skey, c in ctx.items()}
        raw = dict(zip(raw, _leaves(raw.values())))

        def embs():
            out = packed_mod.combine_from_acts(
                eng, plans, {s: {"acts": a} for s, a in acts.items()}, batch)
            out.update(eng.combine_raw(raw, classic_batch))
            return out

        # stage 2: autograd w.r.t. the dense params, the folded acts and the
        # classic activations
        act_list = [a for skey in acts for a in acts[skey]]
        loss, aux, gp, g_leaves = loss_and_grads(
            state, embs, act_list + list(raw.values()), labels, sample_weight,
            dense_inputs, seed)
        it = iter(g_leaves)
        g_acts = {skey: [next(it) for _ in acts[skey]] for skey in acts}
        g_raw = {k: next(it) for k in raw}

        new_state, info = finish(state, loss, aux, gp)
        with torch.no_grad():
            # stage 3 (no gradient): unfold-scatter + lazy pass, in place
            packed_mod.apply_gradients_packed(eng, state.tables, g_acts, plans, ctx,
                                              batch)
            if classic_batch:
                flat = eng.flatten_raw_grads(g_raw, classic_batch)
                _store_tables(state.tables, eng.apply_gradients_scatter(state.tables, flat))
        return new_state, info

    def step_scatter(state: TrainState, batch, labels, sample_weight=None,
                     dense_inputs=None, seed: int = 0):
        with torch.no_grad():
            raw = eng.gather_raw(eng.weights(state.tables), batch)
        raw = dict(zip(raw, _leaves(raw.values())))
        loss, aux, gp, g_raw = loss_and_grads(
            state, lambda: eng.combine_raw(raw, batch), list(raw.values()), labels,
            sample_weight, dense_inputs, seed)
        new_state, info = finish(state, loss, aux, gp)
        with torch.no_grad():
            flat = eng.flatten_raw_grads(dict(zip(raw, g_raw)), batch)
            _store_tables(state.tables, eng.apply_gradients_scatter(state.tables, flat))
        return new_state, info

    def step_dense(state: TrainState, batch, labels, sample_weight=None,
                   dense_inputs=None, seed: int = 0):
        weights = dict(zip(state.tables, _leaves(t["w"] for t in state.tables.values())))
        # the gradient of a bf16 table arrives in bf16: the cotangent of
        # its cast to float32 in the gather, as in the JAX package
        loss, aux, gp, g_w = loss_and_grads(
            state, lambda: eng.lookup(weights, batch), list(weights.values()), labels,
            sample_weight, dense_inputs, seed)
        new_state, info = finish(state, loss, aux, gp)
        with torch.no_grad():
            new = eng.apply_gradients(state.tables, dict(zip(weights, g_w)),
                                      eng.row_counts(batch))
            _store_tables(state.tables, new)
        return new_state, info

    return {"packed": step_packed, "scatter": step_scatter,
            "dense": step_dense}[sparse_update]


def make_scan_train_step(bundle: "ModelBundle", mode: str = "local",
                         sparse_update: Optional[str] = None) -> Callable:
    """Multi-step driver: returns ``run(state, batches, labels,
    sample_weights, dense_inputs, seeds) -> (state, infos)`` over K steps,
    each data argument a sequence of K (``sample_weights`` and
    ``dense_inputs`` may be None), ``infos`` each step's scalars stacked,
    e.g. ``infos["loss"][k]``.  A Python loop over ``make_train_step``
    (``sparse_update`` passed through): the
    same K steps one by one give the same result.  (A CUDA graph of the
    step is the Hopper counterpart of the JAX package's one-dispatch scan;
    it comes with a later slice.)"""
    body = make_train_step(bundle, mode, sparse_update)

    def run(state: TrainState, batches: Sequence, labels: Sequence,
            sample_weights: Optional[Sequence] = None,
            dense_inputs: Optional[Sequence] = None,
            seeds: Sequence[int] = ()):
        k = len(batches)
        if not (len(labels) == len(seeds) == k):
            raise ValueError(f"{k} batches, {len(labels)} labels and "
                             f"{len(seeds)} seeds: expected one of each per step")
        infos: Dict[str, list] = {}
        for i in range(k):
            state, info = body(
                state, batches[i], labels[i],
                None if sample_weights is None else sample_weights[i],
                None if dense_inputs is None else dense_inputs[i], seeds[i])
            for name, val in info.items():
                infos.setdefault(name, []).append(val)
        return state, {name: torch.stack(vals) for name, vals in infos.items()}

    return run


def _lookup_for_mode(bundle, tables, batch, mode: str = "local"):
    """The fused lookup with sequences deferred, or the classic lookup for
    an engine built with ``packed=False``, as the JAX package chooses."""
    _check_mode(mode)
    eng = bundle.embedding
    if eng.packed:
        return packed_mod.lookup_packed(eng, tables, batch, defer_sequences=True)
    return eng.lookup(eng.weights(tables), batch)


def make_eval_step(bundle: "ModelBundle", mode: str = "local") -> Callable:
    """Returns ``step(state, batch, labels, sample_weight, dense_inputs,
    metric_states) -> (metric_states, outputs)`` under
    ``torch.inference_mode()``: the predict step's lookup (so the same
    kernels launch), the tower with ``training=False``, then
    ``metrics.update_metrics`` over ``bundle.metrics`` on the full outputs
    (not ``predict_view``: staytime's stay head is scored on its train
    output, the distribution and the value).  ``sample_weight``: None, one
    (B, 1) tensor, or {task: tensor}.  ``metric_states`` come from
    ``metrics.init_metrics(bundle.metrics, bundle.device)``; the step makes
    no host sync."""

    def step(state: TrainState, batch, labels, sample_weight, dense_inputs,
             metric_states):
        with torch.inference_mode():
            embs = _lookup_for_mode(bundle, state.tables, batch, mode)
            outputs = apply_model(bundle, state.params, embs, dense_inputs,
                                  training=False)
            y = {t: labels[t] for t in bundle.metrics}
            preds = {t: outputs[t] for t in bundle.metrics}
            metric_states = M.update_metrics(bundle.metrics, metric_states, y, preds,
                                             sample_weight)
        return metric_states, outputs

    return step


def make_predict_step(bundle: "ModelBundle", mode: str = "local") -> Callable:
    """Returns ``step(state, batch, dense_inputs) -> {task: (B, 1)}``,
    running under ``torch.inference_mode()``; ``batch`` holds IdBatches of
    tensors on the bundle's device.  The lookup defers the sequence
    columns: the model gets ``SequenceRows`` handles for them, and the DIN
    pool (K7) gathers the rows it reads."""

    def step(state: TrainState, batch, dense_inputs=None):
        with torch.inference_mode():
            embs = _lookup_for_mode(bundle, state.tables, batch, mode)
            outputs = apply_model(bundle, state.params, embs, dense_inputs,
                                  training=False)
            return bundle.predict_view(outputs)

    return step
