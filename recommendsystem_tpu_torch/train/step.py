"""Train, eval and predict steps of the port.

Counterpart of ``recommendsystem_tpu/train/step.py``, in both of its
modes: ``"local"`` (one process holds every table) and ``"sharded"``
(below):

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

The sharded mode (``mode="sharded", mesh=``, a ``core.mesh.Mesh``) is the
JAX package's data-parallel step over row-sharded tables, one process per
rank: each rank passes its row shards of the tables (``train.state.
shard_state``), its rows of the batch (``core.mesh.local_batch``) and the
whole replicated dense state, and calls the step with the same seed.  The
lookups pull rows from their owners and the sparse updates push gradients
to them (``embedding/engine.py``, ``packed.gather_fold_sharded``,
``packed.apply_gradients_packed_sharded``); K1-K4 and K8/K9 run over the
exchanged buffers and the rank's shards.  The loss is the whole batch's,
as the JAX step takes it over the global batch: a rank's term of a
per-sample loss is the sum of its weighted losses over the all-reduced
weight sum (or the global count), a scalar loss (a mean over the batch)
is divided by the number of ranks, and the L1L2 penalty enters on rank 0
alone; the dense gradients are all-reduced with SUM, so every rank applies
the same Adam to the same gradient and the params stay replicated bit for
bit.  The attention dropout numbers a rank's samples from its first global
sample (``kernels.field_attention.sample_offset``), so a sharded step draws
the masks of the local step on the whole batch.  ``info`` holds the whole
batch's losses on every rank.  The eval step sums its metric increments
over the ranks; the predict step gives the rank's rows.

On a 2-D mesh (``create_mesh(model_parallel=M)``) the steps take the
state's placements (``shardings=``: ``state_shardings(...,
tensor_parallel=True)``, ``nn.expert_shardings`` merged by
``merge_shardings``) and each rank passes its shards of the split leaves.
Everything above runs over the data axis (``mesh.group``): the loss's
sums, the dense all-reduce (the model ranks of one data index hold the
same rows, so a sum over every rank would count each gradient M times),
the dropout counter (model ranks of one data index draw the same masks).
The layers run under ``core.model_axis.use(mesh)`` and call the model
group's collectives for the column shards and the experts they read
(``nn/mlp.py``, ``nn/moe_stacked.py``); a split leaf that no layer reads
as a shard goes through ``gather_leaf`` before the module sees it.  A
penalized kernel's shard contributes its own L1L2 term, summed over the
model group for the value (``regularization`` is the whole kernel's).
Dense Adam runs on each shard as on a whole tensor.  Each model rank runs
its data group's exchange and sparse update over the same row shards;
then model index 0's rows that the update may have written are broadcast
over the model group (``core.model_axis.sync_replicas``): the packed
update's, the rows its owners were asked for; the scatter update's, the
rows a real entry reached; the dense update's, every row of the shard.
So the replicas stay bit-equal where the card's atomics add in another
order.

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
import torch.distributed as dist
from torch.func import functional_call

from ..core import model_axis
from ..core.mesh import Mesh
from ..embedding import packed as packed_mod
from ..embedding.engine import check_mode as _check_mode
from ..embedding.optimizers import SparseAdaGrad, SparseAdam
from ..kernels import field_attention as fa
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


@dataclasses.dataclass(frozen=True)
class _ModelAxis:
    """What a step on a mesh with a model axis does besides the 1-D
    step: ``gather`` the split leaves that no layer reads as shards (with
    their placements), ``split`` the names of every split param."""

    mesh: Mesh
    gather: Dict[str, object]
    split: frozenset


def _shard_reads(module) -> Dict[str, Optional[str]]:
    """{param name: the placement kind its layer reads it as a shard of}
    over ``module``, from each layer's ``model_axis_reads()``; a module's
    entry wins over its children's (None: read whole)."""
    reads: Dict[str, Optional[str]] = {}
    for name, mod in module.named_modules():          # parents first
        found = getattr(mod, "model_axis_reads", None)
        if found is None:
            continue
        for local, kind in found().items():
            reads.setdefault(f"{name}.{local}" if name else local, kind)
    return reads


def _model_axis(bundle, mesh: Optional[Mesh], shardings) -> Optional[_ModelAxis]:
    """The model-axis plan of a step, None without a model axis."""
    if mesh is None or mesh.model == 1:
        return None
    split = {} if shardings is None else {
        k: p for k, p in shardings.params.items() if p.model_axis}
    reads = _shard_reads(bundle.module)
    return _ModelAxis(mesh=mesh,
                      gather={k: p for k, p in split.items() if reads.get(k) != p.kind},
                      split=frozenset(split))


def apply_model(bundle: "ModelBundle", params, embs, dense_inputs=None,
                training: bool = False, seed: int = 0, axis: Optional[_ModelAxis] = None):
    """Apply the bundle's module to ``params`` under its compute dtype, the
    one place every step applies the tower (``recommendsystem_tpu/train/
    step.py:36-54``): with bf16 the floating params, the embedding
    activations and ``dense_inputs`` are cast at use and the outputs back
    to float32; with float32 nothing is cast.  ``seed`` draws a training
    step's dropout; ``axis`` is a step's model-axis plan (module
    docstring)."""
    dtype = _policy(bundle)
    if dtype is not None:
        params = cast_floating(params, dtype)
    return _apply_cast(bundle, params, embs, dense_inputs, training, seed, axis)


def _apply_cast(bundle, params, embs, dense_inputs, training, seed, axis=None):
    """``apply_model`` on params already in the compute dtype."""
    if axis is not None and axis.gather:
        params = {k: model_axis.gather_leaf(v, axis.gather[k]) if k in axis.gather else v
                  for k, v in params.items()}
    dtype = _policy(bundle)
    if dtype is not None:
        embs = cast_floating(embs, dtype)
        dense_inputs = cast_floating(dense_inputs, dtype)
    kwargs = {"training": training}
    if training:
        kwargs["seed"] = seed
    if dense_inputs is not None:
        kwargs["dense_inputs"] = dense_inputs
    with model_axis.use(None if axis is None else axis.mesh):
        out = functional_call(bundle.module, params, (embs,), kwargs)
    return out if dtype is None else cast_floating(out, torch.float32)


def _weighted_task_loss(loss_fn, y, pred, sample_weight, mesh: Optional[Mesh] = None):
    """Keras loss reduction: scalar losses pass through; per-sample /
    per-element losses are (sample-weighted) means.  With a ``mesh`` the
    rank's term of the whole batch's loss: the sums over its rows divided
    by the weight sum all-reduced over the ranks (or the global count), a
    scalar loss (a mean over the rank's rows) by the number of ranks."""
    raw = loss_fn(y, pred)
    n = 1 if mesh is None else mesh.size
    if raw.ndim == 0:
        return raw if n == 1 else raw / n
    if sample_weight is not None:
        w = sample_weight.reshape(raw.shape[0], *([1] * (raw.ndim - 1)))
        w = w.expand(raw.shape)
        total = w.sum()
        if mesh is not None:
            dist.all_reduce(total, group=mesh.group)
        return (raw * w).sum() / torch.clamp(total, min=1e-12)
    return raw.mean() if mesh is None else raw.sum() / (raw.numel() * n)


def _penalty(penalized, params, axis: Optional[_ModelAxis]) -> torch.Tensor:
    """The L1L2 penalty (a float32 0-d tensor): with split kernels, each
    shard's term summed over the model group (its gradient the rank's own)
    plus the whole kernels' terms."""
    if axis is None or not axis.split:
        return kernel_penalty(penalized, params).float()
    whole: Dict = {}
    split: Dict = {}
    for reg, names in penalized.items():
        for n in names:
            (split if n in axis.split else whole).setdefault(reg, []).append(n)
    total = (kernel_penalty(whole, params).float() if whole
             else torch.zeros((), device=next(iter(params.values())).device))
    if split:
        total = total + model_axis.sum_over_model(kernel_penalty(split, params).float(),
                                                  axis.mesh)
    return total


def _model_outputs_and_loss(bundle, params, embs, labels, sample_weight,
                            dense_inputs, training, seed, penalized,
                            mesh: Optional[Mesh] = None, axis: Optional[_ModelAxis] = None):
    """The outputs and the loss; ``penalized`` is
    ``nn.regularized_kernels(bundle.module)``: when it is empty, the loss
    has no penalty term and ``regularization`` is None.  The penalty is
    taken on the params in the compute dtype (a float32 0-d tensor).  With
    a ``mesh``, the rank's term of the loss (``_weighted_task_loss``), the
    penalty in rank 0's alone; ``regularization`` is the penalty on every
    rank."""
    dtype = _policy(bundle)
    cparams = params if dtype is None else cast_floating(params, dtype)
    outputs = _apply_cast(bundle, cparams, embs, dense_inputs, training, seed, axis)
    loss = 0.0
    task_losses = {}
    for task, loss_fn in bundle.losses.items():
        lw = (bundle.loss_weights or {}).get(task, 1.0)
        tl = _weighted_task_loss(loss_fn, labels[task], outputs[task],
                                 sample_weight, mesh)
        task_losses[task] = tl
        loss = loss + lw * tl
    reg = None
    if penalized:
        reg = _penalty(penalized, cparams, axis)
        if mesh is None or mesh.rank == 0:
            loss = loss + reg
    return loss, {"task_losses": task_losses, "regularization": reg,
                  "outputs": outputs}


def _all_reduce_flat(tensors, mesh: Mesh):
    """``tensors`` (float32) summed over the ranks in one all-reduce;
    returns new tensors of their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    return [part.view(t.shape) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def _first_sample(batch, mesh: Optional[Mesh]) -> int:
    """The global index of this rank's first row of ``batch``."""
    if mesh is None:
        return 0
    return mesh.rank * next(iter(batch.values())).rows.shape[0]


def _seed_of(seed: Union[int, torch.Generator]) -> int:
    """A step seed below 2**32: ``seed`` itself, or drawn from a
    ``torch.Generator`` (the port's stand-in for the JAX ``rngs``)."""
    if isinstance(seed, torch.Generator):
        return int(torch.randint(0, 1 << 32, (), generator=seed, dtype=torch.int64))
    return int(seed)


def total_loss_fn(bundle: "ModelBundle", params, table_weights, batch, labels,
                  sample_weight=None, dense_inputs=None, training: bool = True,
                  seed: Union[int, torch.Generator] = 0, mode: str = "local",
                  mesh: Optional[Mesh] = None):
    """The loss of ``params`` and the stored ``table_weights`` ({storage:
    (rows, D)}) on one batch, as ``recommendsystem_tpu/train/step.py:69-77``
    computes it: the classic ``lookup`` (differentiable in the weights),
    then the tower under the bundle's compute dtype and the Keras loss
    with the L1L2 penalty.  ``seed`` (an int below 2**32, or a
    ``torch.Generator`` to draw it from) stands for the JAX ``rngs``: it
    draws the dropout of a training call.  Returns ``(loss, aux)``, aux
    holding ``task_losses``, ``regularization`` (a 0-d tensor, 0 for a
    module with no penalty, as JAX sums an empty collection) and
    ``outputs``.  ``mode="sharded"`` (with ``mesh``) takes this rank's
    row shards and rows of the batch and gives the rank's term of the loss
    (the sum over the ranks is the loss; the module docstring)."""
    _check_mode(mode, mesh)
    embs = bundle.embedding.lookup(table_weights, batch, mode, mesh)
    with fa.sample_offset(_first_sample(batch, mesh if mode == "sharded" else None)):
        loss, aux = _model_outputs_and_loss(
            bundle, params, embs, labels, sample_weight, dense_inputs, training,
            _seed_of(seed), regularized_kernels(bundle.module),
            mesh if mode == "sharded" else None)
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


def _check_shardings(shardings, sharded: bool) -> None:
    if shardings is not None and not sharded:
        raise ValueError("shardings= places a sharded state: it needs mode='sharded' "
                         "and a mesh")


def _sync_tables(tables, touched, mesh: Optional[Mesh]) -> None:
    """The model replicas of ``tables`` made bit-equal after an update
    (``model_axis.sync_replicas``): ``touched`` {storage: its local rows
    the step may have written, or None for every row}.  Nothing without a
    model axis."""
    if mesh is None or mesh.model == 1:
        return
    model_axis.sync_replicas({k: tables[k] for k in touched},
                             {k: r for k, r in touched.items() if r is not None}, mesh)


def make_train_step(bundle: "ModelBundle", mode: str = "local",
                    sparse_update: Optional[str] = None,
                    mesh: Optional[Mesh] = None, shardings=None) -> Callable:
    """Returns ``step(state, batch, labels, sample_weight=None,
    dense_inputs=None, seed=0) -> (state, info)``.  ``sparse_update`` is
    ``"packed"`` (the default, as in the JAX package), ``"scatter"`` or
    ``"dense"`` (module docstring); another name raises ``ValueError``.
    The packed update needs a lazy pass of the engine's sparse optimizer:
    ``SparseAdam`` (K8) or ``SparseAdaGrad`` (K9); any other raises
    ``NotImplementedError``.  ``mode="sharded"`` with ``mesh`` is the
    data-parallel step over row-sharded tables (module docstring); every
    rank calls it with its shards, its rows of the batch and the same
    ``seed``; on a 2-D mesh ``shardings`` is the state's placements (a
    ``TrainState`` of them; module docstring).

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
    _check_mode(mode, mesh)
    sharded = mode == "sharded"
    _check_shardings(shardings, sharded)
    mesh = mesh if sharded else None
    axis = _model_axis(bundle, mesh, shardings)
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

    def loss_and_grads(state, batch, embs, leaves, labels, sample_weight, dense_inputs,
                       seed):
        """The loss, its aux, and the gradients of the dense params (a
        dict; sharded: summed over the ranks) and of ``leaves`` (a list),
        the params' taken as fresh leaves of ``state.params``."""
        params = {k: p.detach().requires_grad_() for k, p in state.params.items()}
        with fa.sample_offset(_first_sample(batch, mesh)):
            loss, aux = _model_outputs_and_loss(bundle, params, embs(), labels,
                                                sample_weight, dense_inputs,
                                                True, seed, penalized, mesh, axis)
            grads = torch.autograd.grad(loss, list(params.values()) + leaves,
                                        allow_unused=True, materialize_grads=True)
        gp = list(grads[:len(params)])
        if sharded:
            gp = _all_reduce_flat(gp, mesh)
        return loss, aux, dict(zip(params, gp)), list(grads[len(params):])

    def finish(state, loss, aux, gp):
        """Dense Adam in place; the new state and the step's info (sharded:
        the whole batch's losses)."""
        with torch.no_grad():
            new_params = {k: p.detach() for k, p in state.params.items()}
            new_params, opt_state = bundle.dense_optimizer.update_(
                new_params, gp, state.opt_state)
            losses = [loss.detach()] + [v.detach() for v in aux["task_losses"].values()]
            if sharded:
                losses = _all_reduce_flat([t.float() for t in losses], mesh)
        info = {"loss": losses[0],
                **{f"loss/{t}": v for t, v in zip(aux["task_losses"], losses[1:])},
                "regularization": (no_penalty if aux["regularization"] is None
                                   else aux["regularization"].detach())}
        return TrainState(params=new_params, opt_state=opt_state,
                          tables=state.tables, step=state.step + 1), info

    def step_packed(state: TrainState, batch, labels, sample_weight=None,
                    dense_inputs=None, seed: int = 0):
        pk, _ = packed_mod.storages_packed(eng)
        plans = packed_mod.plan_segments(eng, batch, storages=set(pk))
        classic_batch = packed_mod.classic_columns(eng, batch, plans)
        # stage 1 (no gradient): fused gather + fold (sharded: over the rows
        # pulled from their owners); the classic gather for the storages
        # that cannot pack
        with torch.no_grad():
            if sharded:
                ctx = packed_mod.gather_fold_sharded(eng, state.tables, batch, plans, mesh)
            else:
                ctx = packed_mod.gather_fold(eng, state.tables, batch, plans)
            raw = (eng.gather_raw(eng.weights(state.tables), classic_batch, mode, mesh)
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
            state, batch, embs, act_list + list(raw.values()), labels, sample_weight,
            dense_inputs, seed)
        it = iter(g_leaves)
        g_acts = {skey: [next(it) for _ in acts[skey]] for skey in acts}
        g_raw = {k: next(it) for k in raw}

        new_state, info = finish(state, loss, aux, gp)
        with torch.no_grad():
            # stage 3 (no gradient): unfold-scatter (sharded: pushed to the
            # owners) + lazy pass, in place
            if sharded:
                packed_mod.apply_gradients_packed_sharded(eng, state.tables, g_acts, plans,
                                                          ctx, batch, mesh)
            else:
                packed_mod.apply_gradients_packed(eng, state.tables, g_acts, plans, ctx,
                                                  batch)
            # under a model axis: the rows each storage's owners were asked
            # for this step, and the rows the classic columns' update wrote
            touched = (None if axis is None else
                       {k: torch.unique(c["plan"].recv_rows.long()) for k, c in ctx.items()})
            if classic_batch:
                new_tables, written = _scatter_update(state.tables, g_raw, classic_batch)
                _store_tables(state.tables, new_tables)
                if touched is not None:
                    for k, r in written.items():
                        touched[k] = r if k not in touched else torch.unique(
                            torch.cat([touched[k], r]))
            if touched is not None:
                _sync_tables(state.tables, touched, mesh)
        return new_state, info

    def _scatter_update(tables, g_raw, batch):
        """The classic scatter update: (its new tables, {storage: the local
        rows it wrote} where sharded, else None)."""
        if sharded:
            return eng.apply_gradients_scatter_sharded(tables, g_raw, batch, mesh)
        return eng.apply_gradients_scatter(tables, eng.flatten_raw_grads(g_raw, batch)), None

    def step_scatter(state: TrainState, batch, labels, sample_weight=None,
                     dense_inputs=None, seed: int = 0):
        with torch.no_grad():
            raw = eng.gather_raw(eng.weights(state.tables), batch, mode, mesh)
        raw = dict(zip(raw, _leaves(raw.values())))
        loss, aux, gp, g_raw = loss_and_grads(
            state, batch, lambda: eng.combine_raw(raw, batch), list(raw.values()), labels,
            sample_weight, dense_inputs, seed)
        new_state, info = finish(state, loss, aux, gp)
        with torch.no_grad():
            new_tables, written = _scatter_update(state.tables, dict(zip(raw, g_raw)), batch)
            _store_tables(state.tables, new_tables)
            if axis is not None:
                _sync_tables(state.tables, written, mesh)
        return new_state, info

    def step_dense(state: TrainState, batch, labels, sample_weight=None,
                   dense_inputs=None, seed: int = 0):
        weights = dict(zip(state.tables, _leaves(t["w"] for t in state.tables.values())))
        # the gradient of a bf16 table arrives in bf16: the cotangent of
        # its cast to float32 in the gather, as in the JAX package
        loss, aux, gp, g_w = loss_and_grads(
            state, batch, lambda: eng.lookup(weights, batch, mode, mesh),
            list(weights.values()), labels, sample_weight, dense_inputs, seed)
        new_state, info = finish(state, loss, aux, gp)
        with torch.no_grad():
            counts = (eng.row_counts_sharded(batch, mesh) if sharded
                      else eng.row_counts(batch))
            new = eng.apply_gradients(state.tables, dict(zip(weights, g_w)), counts)
            _store_tables(state.tables, new)
            _sync_tables(state.tables, dict.fromkeys(state.tables), mesh)
        return new_state, info

    return {"packed": step_packed, "scatter": step_scatter,
            "dense": step_dense}[sparse_update]


def make_scan_train_step(bundle: "ModelBundle", mode: str = "local",
                         sparse_update: Optional[str] = None,
                         mesh: Optional[Mesh] = None, shardings=None) -> Callable:
    """Multi-step driver: returns ``run(state, batches, labels,
    sample_weights, dense_inputs, seeds) -> (state, infos)`` over K steps,
    each data argument a sequence of K (``sample_weights`` and
    ``dense_inputs`` may be None), ``infos`` each step's scalars stacked,
    e.g. ``infos["loss"][k]``.  A Python loop over ``make_train_step``
    (``mode``, ``sparse_update``, ``mesh`` and ``shardings`` passed through): the
    same K steps one by one give the same result.  (A CUDA graph of the
    step is the Hopper counterpart of the JAX package's one-dispatch scan;
    it comes with a later slice.)"""
    body = make_train_step(bundle, mode, sparse_update, mesh, shardings)

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


def _lookup_for_mode(bundle, tables, batch, mode: str = "local",
                     mesh: Optional[Mesh] = None):
    """The fused lookup with sequences deferred, or the classic lookup for
    an engine built with ``packed=False``, as the JAX package chooses;
    sharded, the same over the rows pulled from their owners.  (The JAX
    package's sharded predict and eval steps take the classic sharded
    lookup: one function, which the port computes with its kernels.)"""
    eng = bundle.embedding
    if mode == "sharded":
        if eng.packed:
            return packed_mod.lookup_packed_sharded(eng, tables, batch, mesh,
                                                    defer_sequences=True)
        return eng.lookup(eng.weights(tables), batch, mode, mesh)
    if eng.packed:
        return packed_mod.lookup_packed(eng, tables, batch, defer_sequences=True)
    return eng.lookup(eng.weights(tables), batch)


def _sum_over_ranks(metrics, states, increments, mesh: Mesh):
    """``states`` plus the increments of every rank: one all-reduce of the
    increments (float32 sums and counts, as every metric state is)."""
    leaves = [inc[k] for task in metrics for inc in increments[task] for k in sorted(inc)]
    it = iter(_all_reduce_flat([t.float() for t in leaves], mesh))
    return {task: [{k: st[k] + next(it).to(st[k].dtype) for k in sorted(inc)}
                   for st, inc in zip(states[task], increments[task])]
            for task in metrics}


def make_eval_step(bundle: "ModelBundle", mode: str = "local",
                   mesh: Optional[Mesh] = None, shardings=None) -> Callable:
    """Returns ``step(state, batch, labels, sample_weight, dense_inputs,
    metric_states) -> (metric_states, outputs)`` under
    ``torch.inference_mode()``: the predict step's lookup (so the same
    kernels launch), the tower with ``training=False``, then
    ``metrics.update_metrics`` over ``bundle.metrics`` on the full outputs
    (not ``predict_view``: staytime's stay head is scored on its train
    output, the distribution and the value).  ``sample_weight``: None, one
    (B, 1) tensor, or {task: tensor}.  ``metric_states`` come from
    ``metrics.init_metrics(bundle.metrics, bundle.device)``; the step makes
    no host sync.  Sharded (``mode="sharded", mesh=``): each rank passes
    its shards and rows; the states it gets back hold the whole batch's
    increments (summed over the ranks), the outputs are its rows'; on a 2-D
    mesh ``shardings`` as ``make_train_step`` takes it."""
    _check_mode(mode, mesh)
    _check_shardings(shardings, mode == "sharded")
    axis = _model_axis(bundle, mesh if mode == "sharded" else None, shardings)

    def step(state: TrainState, batch, labels, sample_weight, dense_inputs,
             metric_states):
        with torch.inference_mode():
            embs = _lookup_for_mode(bundle, state.tables, batch, mode, mesh)
            outputs = apply_model(bundle, state.params, embs, dense_inputs,
                                  training=False, axis=axis)
            y = {t: labels[t] for t in bundle.metrics}
            preds = {t: outputs[t] for t in bundle.metrics}
            if mode == "sharded":
                zero = M.init_metrics(bundle.metrics, outputs[next(iter(preds))].device)
                inc = M.update_metrics(bundle.metrics, zero, y, preds, sample_weight)
                metric_states = _sum_over_ranks(bundle.metrics, metric_states, inc, mesh)
            else:
                metric_states = M.update_metrics(bundle.metrics, metric_states, y, preds,
                                                 sample_weight)
        return metric_states, outputs

    return step


def make_predict_step(bundle: "ModelBundle", mode: str = "local",
                      mesh: Optional[Mesh] = None, shardings=None) -> Callable:
    """Returns ``step(state, batch, dense_inputs) -> {task: (B, 1)}``,
    running under ``torch.inference_mode()``; ``batch`` holds IdBatches of
    tensors on the bundle's device.  The lookup defers the sequence
    columns: the model gets ``SequenceRows`` handles for them, and the DIN
    pool (K7) gathers the rows it reads.  Sharded (``mode="sharded",
    mesh=``): each rank passes its shards and rows and gets its rows'
    outputs; K7 gathers its facts from the rows the exchange brought.  On a
    2-D mesh ``shardings`` as ``make_train_step`` takes it."""
    _check_mode(mode, mesh)
    _check_shardings(shardings, mode == "sharded")
    axis = _model_axis(bundle, mesh if mode == "sharded" else None, shardings)

    def step(state: TrainState, batch, dense_inputs=None):
        with torch.inference_mode():
            embs = _lookup_for_mode(bundle, state.tables, batch, mode, mesh)
            outputs = apply_model(bundle, state.params, embs, dense_inputs,
                                  training=False, axis=axis)
            return bundle.predict_view(outputs)

    return step
