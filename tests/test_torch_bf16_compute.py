"""The bf16 compute policy of the port against the JAX package's.

The JAX package's ``compute_dtype=bfloat16`` casts the floating params, the
embedding activations and ``dense_inputs`` to bf16 at use and the outputs
back to float32 (``recommendsystem_tpu/train/step.py:36-54``); most of its
products take ``preferred_element_type=float32``, so a bf16 x bf16 product
comes out float32 and later layers multiply float32 activations by
bf16-rounded weights, while its Pallas kernels take bf16 inputs and return
float32.  The port follows that kernel chain.  Here, at small widths, on
the same numpy-seeded inputs and on params carried by ``bridge``:

- K6 and K7's plain versions on bf16 inputs against the JAX
  ``interacting_attention`` and ``din_pool`` in interpret mode (outputs,
  bf16 gradients), K7's gathering entry rounding a float32 table's facts,
  and K5f / K5b's plain versions on bf16 q, k, v against the JAX
  ``field_attention_reference`` on the same values widened, its gradients
  rounded to bf16 (the JAX K5 refuses bf16 inputs: a reference-side fact,
  recorded by its own test);
- the dtype of every output of every layer of ``nn/`` and of each model's
  module under bf16 inputs and bf16-cast params, equal to the JAX layer's;
- the predict step of all six models against JAX ``apply_model`` under the
  policy and ``set_backend("pallas")`` (so that JAX takes K6 and K7 as the
  port does), and the policy really on: the port's largest gap to JAX bf16
  at most half of JAX bf16's gap to JAX float32;
- one packed train step of each model: the loss, and each dense gradient of
  the loss against ``jax.grad`` of the JAX loss.  JAX's flash path (K5)
  points at a stand-in inside the test, the reference on widened inputs
  with dropout off (the port's layer takes its K5 path at rate 0); nothing
  in the JAX package changes;
- the JAX package's own bf16 test ported; the server's and the daily
  trainer's ``--compute-dtype bf16``.

Tolerances: K6 and K7 outputs rtol 2e-5, atol 2e-6 (the same float32 math
on the same widened values, summed in another order); K5f and its lse atol
2e-6; a bf16 gradient within one bf16 ulp (rtol 2**-7) of JAX's, which
rounds the float32 sum once as the port does, plus atol 1e-6 for float32
sums in another order that cancel; K6 and K7 gradients, whose JAX
cotangents are rounded once per use and summed in bf16, rtol 2e-2 (a few
bf16 ulps) and atol 1e-4.  Layer and model outputs, and predict outputs:
rtol 2e-2, atol 5e-3 (bf16 roundings of intermediates that may fall on
the other side of a rounding midpoint).  Train: loss rtol 1e-2, each dense
gradient's relative L2 error at most 2e-2, but for one kind of gradient,
which is 0 in exact arithmetic: the DIN scorer's ``b2`` shifts every score
of a softmax alike, so the loss does not depend on it, and each side's
gradient of it is rounding noise (~1e-11 here); both are held to at most
1e-6 of the step's largest gradient norm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from recommendsystem_tpu import nn as jnn
from recommendsystem_tpu.core.config import synthetic_ctr_config as jax_synthetic_ctr_config
from recommendsystem_tpu.data import synthetic_batch as jax_synthetic_batch
from recommendsystem_tpu.kernels import field_attention_pallas as jfa
from recommendsystem_tpu.kernels import flags as jflags
from recommendsystem_tpu.kernels import set_backend
from recommendsystem_tpu.kernels.din_pallas import din_pool as jax_din_pool
from recommendsystem_tpu.kernels.interacting_pallas import \
    interacting_attention as jax_interacting_attention
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.models.staytime import StaytimeConfig as JaxStaytimeConfig
from recommendsystem_tpu.nn import din as jax_din
from recommendsystem_tpu.nn import fm as jax_fm
from recommendsystem_tpu.nn import senet as jax_senet
from recommendsystem_tpu.nn import dcn as jax_dcn
from recommendsystem_tpu.nn import ppnet as jax_ppnet
from recommendsystem_tpu.train import create_train_state as jax_create_train_state
from recommendsystem_tpu.train import step as jstep_mod
from recommendsystem_tpu_torch import bridge
from recommendsystem_tpu_torch import nn as pnn
from recommendsystem_tpu_torch.core.config import synthetic_ctr_config
from recommendsystem_tpu_torch.data import synthetic_batch
from recommendsystem_tpu_torch.embedding import packed
from recommendsystem_tpu_torch.kernels import launch_counts, reset_launch_counts
from recommendsystem_tpu_torch.kernels.din import (din_pool, din_pool_gather,
                                                   din_pool_gather_plain, din_pool_plain)
from recommendsystem_tpu_torch.kernels.field_attention import (
    field_attention, field_attention_bwd, field_attention_fwd_plain)
from recommendsystem_tpu_torch.kernels.interacting import (PARAM_NAMES,
                                                           interacting_attention)
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.autoint import TASK
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig
from recommendsystem_tpu_torch.train import (create_train_state, evaluate, fit,
                                             make_predict_step, make_train_step)
from recommendsystem_tpu_torch.train import step as pstep_mod
from recommendsystem_tpu_torch.train.step import apply_model

torch.set_num_threads(1)
BF = torch.bfloat16
KERNEL_TOL = dict(rtol=2e-5, atol=2e-6)
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)
BF16_GRAD_TOL = dict(rtol=2e-2, atol=1e-4)
OUT_TOL = dict(rtol=2e-2, atol=5e-3)
LOSS_RTOL = 1e-2
GRAD_REL_L2 = 2e-2
ZERO_GRAD = 1e-6


def _np32(x):
    """A torch or JAX array as a float32 numpy array (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16_pair(x):
    """numpy float32 -> (JAX bf16, torch bf16) of the same values."""
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(BF)


@pytest.fixture
def pallas():
    set_backend("pallas")
    try:
        yield
    finally:
        set_backend(None)


# -- kernel level ------------------------------------------------------------

@pytest.mark.parametrize("head_num", [1, 2])
def test_k6_plain_on_bf16_matches_the_jax_kernel(head_num):
    rng = np.random.default_rng(head_num)
    b, f, d = 6, 5, 8
    x = rng.standard_normal((b, f, d)).astype(np.float32)
    raw = {n: (rng.standard_normal((d, d)) if n.startswith("w")
               else rng.standard_normal(d)).astype(np.float32) for n in PARAM_NAMES}
    raw["gamma"] = 1.0 + 0.1 * raw["gamma"]
    jx, px = _bf16_pair(x)
    jp, pp = {}, {}
    for n, v in raw.items():
        jp[n], pp[n] = _bf16_pair(v)
    want, vjp = jax.vjp(lambda xx, pr: jax_interacting_attention(xx, pr, head_num, 1e-3), jx, jp)
    px.requires_grad_()
    for t in pp.values():
        t.requires_grad_()
    got = interacting_attention(px, pp, head_num, 1e-3)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(_np32(got), _np32(want), **KERNEL_TOL)
    cot = rng.standard_normal(got.shape).astype(np.float32)
    jgx, jgp = vjp(jnp.asarray(cot))
    grads = torch.autograd.grad(got, [px] + [pp[n] for n in PARAM_NAMES], torch.from_numpy(cot))
    assert jgx.dtype == jnp.bfloat16 and grads[0].dtype == BF
    np.testing.assert_allclose(_np32(grads[0]), _np32(jgx), **BF16_GRAD_TOL)
    for n, g in zip(PARAM_NAMES, grads[1:]):
        assert g.dtype == BF and jgp[n].dtype == jnp.bfloat16, n
        np.testing.assert_allclose(_np32(g), _np32(jgp[n]), **BF16_GRAD_TOL, err_msg=n)


def _din_inputs(seed, b=6, t=7, h=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h)).astype(np.float32)
    facts = rng.standard_normal((b, t, h)).astype(np.float32)
    mask = (rng.uniform(size=(b, t)) < 0.7).astype(np.float32)
    mask[1] = 0.0                                          # an all-0 row
    w = [(0.3 * rng.standard_normal(s)).astype(np.float32)
         for s in ((4 * h, 16), (16,), (16, 1), (1,))]
    return q, facts, mask, w


def test_k7_plain_on_bf16_matches_the_jax_kernel():
    q, facts, mask, w = _din_inputs(0)
    (jq, pq), (jf, pf) = _bf16_pair(q), _bf16_pair(facts)
    jw, pw = zip(*(_bf16_pair(x) for x in w))
    jm, pm = jnp.asarray(mask), torch.from_numpy(mask)
    want, vjp = jax.vjp(lambda a, b_, *ws: jax_din_pool(a, b_, jm, *ws), jq, jf, *jw)
    ins = [pq, pf, *pw]
    for t in ins:
        t.requires_grad_()
    got = din_pool(pq, pf, pm, *pw)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(_np32(got), _np32(want), **KERNEL_TOL)
    # the plain version rounds q - f and q * f to bf16: not the float32 math
    widened = din_pool_plain(*(t.detach().float() for t in (pq, pf)), pm,
                             *(t.detach().float() for t in pw))
    assert not torch.allclose(got.detach(), widened, rtol=0, atol=1e-7)
    cot = np.random.default_rng(9).standard_normal(got.shape).astype(np.float32)
    jgrads = vjp(jnp.asarray(cot))
    grads = torch.autograd.grad(got, ins, torch.from_numpy(cot))
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        assert g.dtype == BF and jg.dtype == jnp.bfloat16, i
        np.testing.assert_allclose(_np32(g), _np32(jg), **BF16_GRAD_TOL, err_msg=str(i))


@pytest.mark.parametrize("table_dtype", [torch.float32, BF])
def test_k7_gather_takes_the_facts_in_the_compute_dtype(table_dtype):
    """The gathering entry with ``facts_dtype=bf16`` is ``din_pool`` over the
    gathered facts cast to bf16 (a float32 table's lanes rounded, a bf16
    table's exact), which the JAX kernel computes on the same facts."""
    q, _, mask, w = _din_inputs(1, b=5, t=6)
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.standard_normal((40, 32)).astype(np.float32)).to(table_dtype)
    ids = torch.from_numpy(rng.integers(0, 40, (5, 6)).astype(np.int32))
    pm = torch.from_numpy(mask)
    pq = torch.from_numpy(q).to(BF)
    pw = [torch.from_numpy(x).to(BF) for x in w]
    got = din_pool_gather(pq, table, ids, pm, (16, 32), *pw, facts_dtype=BF)
    facts = (pm[..., None] * table[ids.long()].float())[:, :, 16:32].to(BF)
    torch.testing.assert_close(got, din_pool_plain(pq, facts, pm, *pw), rtol=0, atol=0)
    want = jax_din_pool(jnp.asarray(q).astype(jnp.bfloat16),
                        jnp.asarray(facts.float().numpy()).astype(jnp.bfloat16),
                        jnp.asarray(mask), *(jnp.asarray(x).astype(jnp.bfloat16) for x in w))
    np.testing.assert_allclose(_np32(got), _np32(want), **KERNEL_TOL)
    torch.testing.assert_close(
        got, din_pool_gather_plain(pq, table, ids, pm, (16, 32), *pw, facts_dtype=BF))
    # a handle carries the facts' type to the pool
    handle = packed.SequenceRows(table, ids, pm, (0, 32), dtype=BF).lanes(16, 32)
    pool = pnn.DINPool(16)
    params = {"w1": pw[0], "b1": pw[1], "w2": pw[2], "b2": pw[3]}
    torch.testing.assert_close(functional_call(pool, params, (pq, handle)), got)


def _qkv(seed, h=2, dh=4, f=6, b=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((h, dh, f, b)).astype(np.float32) for _ in range(3)]


def test_k5_plain_on_bf16_matches_the_jax_reference_widened():
    qkv = _qkv(3)
    tq, tk, tv = (torch.from_numpy(x).to(BF) for x in qkv)
    wide = [jnp.asarray(t.float().numpy()) for t in (tq, tk, tv)]
    want, vjp = jax.vjp(jfa.field_attention_reference, *wide)
    o, lse = field_attention_fwd_plain(tq, tk, tv)
    assert o.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=0, atol=2e-6)
    s = np.einsum("hdfb,hdgb->hfgb", *(np.asarray(w, np.float64) for w in wide[:2])) / 2.0
    np.testing.assert_allclose(lse.numpy(), np.log(np.exp(s).sum(axis=2)), rtol=0, atol=2e-6)
    do = np.random.default_rng(4).standard_normal(o.shape).astype(np.float32)
    jgrads = [np.asarray(g.astype(jnp.bfloat16).astype(jnp.float32))
              for g in vjp(jnp.asarray(do))]
    bwd = field_attention_bwd(tq, tk, tv, o, lse, torch.from_numpy(do))
    # the Function: K5f, then K5b as its backward
    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = field_attention(*ins)
    assert out.dtype == torch.float32
    fn = torch.autograd.grad(out, ins, torch.from_numpy(do))
    for g, f_, jg in zip(bwd, fn, jgrads):
        assert g.dtype == f_.dtype == BF
        np.testing.assert_allclose(_np32(g), jg, **BF16_ULP)
        torch.testing.assert_close(f_, g, rtol=0, atol=0)


@pytest.mark.reference_fact
def test_jax_k5f_refuses_bf16_inputs():
    """A fact of the reference, not of the port: the JAX field-attention
    kernel stores its scores in float32 scratch and refuses bf16 q, k, v
    (on float32 it runs).  Should a later JAX change take them, this test
    fails and the port's K5 semantics need another look."""
    qkv = [jnp.asarray(x) for x in _qkv(5, f=8, b=128)]
    jfa.field_attention(*qkv, 0, 0.0)
    with pytest.raises(Exception, match="dtype"):
        jfa.field_attention(*(x.astype(jnp.bfloat16) for x in qkv), 0, 0.0)


# -- layer level: dtype maps ----------------------------------------------------

def _load(player, params):
    flat = bridge._flatten(jax.tree.map(np.asarray, params))
    assert set(flat) == {n for n, _ in player.named_parameters()}
    with torch.no_grad():
        for n, p in player.named_parameters():
            p.copy_(torch.from_numpy(np.array(flat[n])))


def _leaves(out):
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    if isinstance(out, (list, tuple)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _to_jax(x):
    if isinstance(x, dict):
        return {k: _to_jax(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_jax(v) for v in x)
    if x.dtype == np.bool_:
        return jnp.asarray(x)
    return jnp.asarray(x).astype(jnp.bfloat16)


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    if x.dtype == np.bool_:
        return torch.from_numpy(x)
    return torch.from_numpy(x).to(BF)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _gated_jax():
    """The JAX ``stacked_gated_experts`` as a flax module."""
    import flax.linen as fnn

    class Gated(fnn.Module):
        @fnn.compact
        def __call__(self, x, gate):
            return jnn.stacked_gated_experts(3, (16, 8), x, gate)

    return Gated()


class _PortGated(torch.nn.Module):
    """The port's stack of gated experts as a model keeps it (``experts``),
    (B, E, D) as the JAX function returns it."""

    def __init__(self, n):
        super().__init__()
        self.experts = pnn.stacked_gated_experts(3, (16, 8), n, 10)

    def forward(self, x, gate):
        return self.experts(x, gate).transpose(0, 1)


def _layer_cases():
    """name -> (flax layer, port layer, inputs as numpy (float32 cast to
    bf16; bool as it is), JAX kwargs, port kwargs)."""
    b, n = 6, 24
    slots = ("a", "b", "c", "d")
    slot_inputs = {s: _rand(20 + i, b, 16) for i, s in enumerate(slots)}
    din_mask = np.random.default_rng(7).uniform(size=(b, 5)) < 0.7
    gated = {"gate": _rand(31, b, 10)}
    return {
        "Dense": (jnn.Dense(12, activation="relu"), pnn.Dense(n, 12, "relu"),
                  [_rand(1, b, n)], {}, {}),
        "MultiLayerDense": (jnn.MultiLayerDense(units=(16, 8)),
                            pnn.MultiLayerDense(n, (16, 8)), [_rand(2, b, n)], {}, {}),
        "DNN": (jnn.DNN((16, 8), output_activation="softmax"),
                pnn.DNN(n, (16, 8), output_activation="softmax"), [_rand(3, b, n)], {}, {}),
        "DeepCrossLayer": (jax_dcn.DeepCrossLayer(num_layer=3), pnn.DeepCrossLayer(n),
                           [_rand(4, b, n)], {}, {}),
        "CrossNet": (jnn.CrossNet(layer_num=2), pnn.CrossNet(n, layer_num=2),
                     [_rand(5, b, n)], {}, {}),
        "FMLayer3D": (jax_fm.FMLayer3D(), pnn.FMLayer3D(), [_rand(6, b, 5, 8)], {}, {}),
        "DeepFMLayer": (jax_fm.DeepFMLayer(), pnn.DeepFMLayer(n), [_rand(7, b, n)], {}, {}),
        "FFMBlock": (jax_fm.FFMBlock(ffm_slots=((slots[:2], slots[2:], 8),)),
                     pnn.FFMBlock(((slots[:2], slots[2:], 8),), {s: 16 for s in slots}),
                     [slot_inputs], {}, {}),
        "SENet_mean": (jax_senet.SENet(squeeze="mean"), pnn.SENet(4, 16, squeeze="mean"),
                       [[slot_inputs[s] for s in slots]], {}, {}),
        "SENet_concat": (jax_senet.SENet(squeeze="concat"),
                         pnn.SENet(4, 16, squeeze="concat"),
                         [[slot_inputs[s] for s in slots]], {}, {}),
        "GateTower": (jnn.GateTower(12, hidden_units=20), pnn.GateTower(n, 12, hidden_units=20),
                      [_rand(8, b, n)], {}, {}),
        "PPNetGateBank": (jax_ppnet.PPNetGateBank(splits=(8, 4)),
                          pnn.PPNetGateBank(n, (8, 4)), [_rand(9, b, n)], {}, {}),
        "MMOE": (jnn.MMOE(num_tasks=2, num_experts=3, expert_dnn_units=(16,)),
                 pnn.MMOE(n, num_tasks=2, num_experts=3, expert_dnn_units=(16,)),
                 [_rand(10, b, n)], {}, {}),
        "PLE": (jnn.PLE(num_tasks=2, num_shared_experts=2, num_specific_experts=2),
                pnn.PLE(n, num_tasks=2, num_shared_experts=2, num_specific_experts=2),
                [_rand(11, b, n)], {}, {}),
        "MMOEStacked": (jnn.MMOEStacked(num_tasks=2, num_experts=3),
                        pnn.MMOEStacked(n, num_tasks=2, num_experts=3), [_rand(12, b, n)], {}, {}),
        "PLEStacked": (jnn.PLEStacked(num_tasks=2), pnn.PLEStacked(n, num_tasks=2),
                       [_rand(13, b, n)], {}, {}),
        "GatedExpert": (_gated_jax(), _PortGated(n),
                        [_rand(14, b, n), gated["gate"]], {}, {}),
        "Similarity": (jnn.Similarity(), pnn.Similarity(), [[_rand(15, b, 8), _rand(16, b, 8)]],
                       {}, {}),
        "DINPool": (jax_din.DINPool(hidden=16), pnn.DINPool(16),
                    [_rand(17, b, 16), _rand(18, b, 5, 16), din_mask], {}, {}),
        "DINAttention": (jax_din.DINAttention(hidden_units=(8, 1)),
                         pnn.DINAttention(16, hidden_units=(8, 1)),
                         [_rand(19, b, 3, 16), _rand(21, b, 5, 16), _rand(22, b, 5, 16),
                          din_mask], {}, {}),
        "InteractingLayer_K6": (jnn.InteractingLayer(layer_num=2, unit_num=8, head_num=2),
                                pnn.InteractingLayer(8, layer_num=2, unit_num=8, head_num=2),
                                [_rand(23, b, 5, 8)], {}, {}),
    }


LAYERS = sorted(_layer_cases())


@pytest.mark.parametrize("name", LAYERS)
def test_layer_output_dtypes_match_jax_under_bf16(name, pallas):
    """Each output's dtype under bf16 inputs and bf16-cast params equals
    the JAX layer's (with its kernels: ``set_backend("pallas")``), and its
    values are close."""
    jlayer, player, inputs, jkw, pkw = _layer_cases()[name]
    f32_in = jax.tree.map(lambda x: jnp.asarray(x), inputs)
    params = jlayer.init(jax.random.PRNGKey(0), *f32_in, **jkw).get("params", {})
    _load(player, params)
    jparams = jax.tree.map(lambda p: p.astype(jnp.bfloat16), params)
    want = _leaves(jlayer.apply({"params": jparams}, *_to_jax(inputs), **jkw))
    pparams = {k: p.detach().to(BF) for k, p in player.named_parameters()}
    got = _leaves(functional_call(player, pparams, tuple(_to_torch(inputs)), pkw))
    assert len(got) == len(want)
    jdt = [str(w.dtype) for w in want]
    pdt = [str(g.dtype).removeprefix("torch.") for g in got]
    assert pdt == jdt, name
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np32(g), _np32(w), **OUT_TOL, err_msg=name)


def test_fm_cross_term_dtypes_match_jax():
    xs = [_rand(40 + i, 6, 16) for i in range(4)]
    want = jax_fm.fm_cross_term([jnp.asarray(x).astype(jnp.bfloat16) for x in xs])
    got = pnn.fm_cross_term([torch.from_numpy(x).to(BF) for x in xs])
    for g, w in zip(got, want):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_allclose(_np32(g), _np32(w), **OUT_TOL)


def test_dot_helpers_keep_the_jax_result_types():
    a, b = torch.randn(3, 4).to(BF), torch.randn(4, 2).to(BF)
    assert pnn.dot_f32(a, b).dtype == torch.float32
    torch.testing.assert_close(pnn.dot_f32(a, b), a.float() @ b.float())
    assert pnn.dot_f32(a.float(), b).dtype == torch.float32
    assert pnn.matmul_promoted(a, b).dtype == BF
    assert pnn.matmul_promoted(a.float(), b).dtype == torch.float32
    assert pnn.einsum_f32("ij,jk->ik", a, b).dtype == torch.float32


# -- model level ----------------------------------------------------------------

_S16 = tuple(str(9000 + i) for i in range(16))
_STAY16 = dict(
    slots=_S16, seq_slots=(_S16[8], _S16[9], _S16[10]), user_slots=_S16[0:4],
    item_slots=_S16[4:8],
    bias_slots=(_S16[0], _S16[2], _S16[4], _S16[6], _S16[11], _S16[12]),
    seq_query=((_S16[8], _S16[4]), (_S16[9], _S16[5]), (_S16[10], _S16[6])),
    seq_max_len=5, bucket_size=64)
_FINISH = tuple(str(3000 + i) for i in range(12))
NO_DROPOUT = {"interact": {"layer_num": 1, "unit_num": 8, "head_num": 2,
                           "use_dropout": False, "dropout_rate": 0.2, "use_res": True}}
MODELS = {
    "autoint": (dict(bucket_size=256, model_param=NO_DROPOUT),) * 2,
    "ctr": (dict(cfg=jax_synthetic_ctr_config(num_slots=8, num_bias=4), bucket_size=256,
                 attention_dropout_rate=0.0),
            dict(cfg=synthetic_ctr_config(num_slots=8, num_bias=4), bucket_size=256,
                 attention_dropout_rate=0.0)),
    "multi_head": (dict(slots=tuple(str(2000 + i) for i in (5, 0, 3, 1, 4, 2)),
                        bucket_size=256),) * 2,
    "finish": (dict(slots=_FINISH, bias_slots=_FINISH[:4], bucket_size=256),) * 2,
    "rough_rank": (dict(user_slots=tuple(str(s) for s in range(1560, 1564)),
                        item_slots=tuple(str(s) for s in range(1591, 1594)),
                        bucket_size=256),) * 2,
    "staytime": (dict(cfg=JaxStaytimeConfig(**_STAY16), deep_hidden_units=(16, 8)),
                 dict(cfg=StaytimeConfig(**_STAY16), deep_hidden_units=(16, 8))),
}
B = 32
_PAIRS = {}


def _pair(name):
    """(JAX bf16 bundle, JAX state, port bf16 bundle, port state): one
    state, bridged.  The port's InteractingLayer trains on its K5 path at a
    dropout rate of 0, as the JAX layer trains on its flash path (bf16
    projections, then K5) through the stand-in, which draws no dropout;
    both serve through K6."""
    if name not in _PAIRS:
        jkw, pkw = MODELS[name]
        jbundle = jax_create_model(name, compute_dtype=jnp.bfloat16, **jkw)
        pbundle = create_model(name, compute_dtype=BF, device="cpu", **pkw)
        assert pbundle.compute_dtype == BF
        layer = getattr(pbundle.module, "interacting", None)
        if layer is not None:
            layer.use_dropout, layer.dropout_rate = True, 0.0
        jb, jd, _, _ = jax_synthetic_batch(jbundle, 8, seed=0)
        jstate = jax_create_train_state(jbundle, jax.random.PRNGKey(4), jb, dense_inputs=jd)
        pstate = bridge.from_jax_numpy(
            pbundle, jax.tree.map(np.asarray, jstate.params),
            jax.device_get(jbundle.embedding.classic_state(jstate.tables)),
            opt_state=jax.tree.map(np.asarray, jstate.opt_state))
        _PAIRS[name] = (jbundle, jstate, pbundle, pstate)
    return _PAIRS[name]


def _flash_stand_in(q, k, v, seed, rate=0.0, interpret=None):
    """The JAX flash attention's stand-in: the reference on the inputs
    widened (the JAX kernel refuses bf16), dropout off."""
    return jfa.field_attention_reference(*(x.astype(jnp.float32) for x in (q, k, v)))


@pytest.fixture
def jax_flash(monkeypatch, pallas):
    """JAX's training InteractingLayer on its flash path, through the
    stand-in (test-side: nothing in the JAX package changes)."""
    monkeypatch.setattr(jfa, "field_attention", _flash_stand_in)
    monkeypatch.setattr(jfa, "eligible", lambda *a: True)
    monkeypatch.setattr(jflags, "use_flash", lambda: True)


@pytest.mark.parametrize("name", list(MODELS))
def test_module_output_dtypes_match_jax(name, pallas):
    """The modules' own outputs (before the policy casts them back) under
    bf16 params and activations: each head's dtype equals JAX's."""
    jbundle, jstate, pbundle, pstate = _pair(name)
    jb, jd, _, _ = jax_synthetic_batch(jbundle, 8, seed=2)
    pb, pd, _, _ = synthetic_batch(pbundle, 8, seed=2)
    jembs = jbundle.embedding.lookup(jbundle.embedding.weights(jstate.tables), jb)
    jcast = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                         if jnp.issubdtype(x.dtype, jnp.floating) else x,
                         (jstate.params, jembs, jd))
    kw = {} if jd is None else {"dense_inputs": jcast[2]}
    want = jbundle.module.apply({"params": jcast[0]}, jcast[1], training=False, **kw)
    pembs = pbundle.embedding.lookup(pbundle.embedding.weights(pstate.tables), pb)
    cast = pstep_mod.cast_floating
    pkw = {} if pd is None else {"dense_inputs": cast(pd, BF)}
    got = functional_call(pbundle.module, cast(pstate.params, BF), (cast(pembs, BF),),
                          {"training": False, **pkw})
    assert set(got) == set(want)
    for task in want:
        assert str(got[task].dtype).removeprefix("torch.") == str(want[task].dtype), task


@pytest.mark.parametrize("name", list(MODELS))
def test_predict_step_matches_jax_bf16(name, pallas):
    jbundle, jstate, pbundle, pstate = _pair(name)
    jb, jd, _, _ = jax_synthetic_batch(jbundle, B, seed=21)
    pb, pd, _, _ = synthetic_batch(pbundle, B, seed=21)
    want = jstep_mod.make_predict_step(jbundle)(jstate, jb, jd)
    want32 = jstep_mod.make_predict_step(dataclasses.replace(jbundle, compute_dtype=None))(
        jstate, jb, jd)
    reset_launch_counts()
    got = make_predict_step(pbundle)(pstate, pb, pd)
    assert set(launch_counts().values()) == {0}
    assert set(got) == set(want)
    gap_port, gap_policy = 0.0, 0.0
    for task in want:
        assert got[task].dtype == torch.float32
        g, w, w32 = _np32(got[task]), _np32(want[task]), _np32(want32[task])
        np.testing.assert_allclose(g, w, **OUT_TOL, err_msg=task)
        gap_port = max(gap_port, float(np.abs(g - w).max()))
        gap_policy = max(gap_policy, float(np.abs(w - w32).max()))
    assert gap_policy > 0.0
    assert gap_port <= 0.5 * gap_policy, (gap_port, gap_policy)


def _dense_grads_jax(jbundle, jstate, jb, jd, jl, jw):
    embs = jbundle.embedding.lookup(jbundle.embedding.weights(jstate.tables), jb)

    def loss(p):
        return jstep_mod._model_outputs_and_loss(
            jbundle, p, embs, jl, jw, jd, True, {"dropout": jax.random.PRNGKey(0)})[0]

    return bridge._flatten(jax.tree.map(np.asarray, jax.grad(loss)(jstate.params)))


def _dense_grads_port(pbundle, pstate, pb, pd, pl, pw):
    eng = pbundle.embedding
    embs = eng.lookup(eng.weights(pstate.tables), pb)
    params = {k: p.detach().requires_grad_() for k, p in pstate.params.items()}
    loss, _ = pstep_mod._model_outputs_and_loss(
        pbundle, params, embs, pl, pw, pd, True, 0, pnn.regularized_kernels(pbundle.module))
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                materialize_grads=True)
    return dict(zip(params, grads))


@pytest.mark.parametrize("name", list(MODELS))
def test_train_step_matches_jax_bf16(name, jax_flash):
    jbundle, jstate, pbundle, _ = _pair(name)
    pstate = bridge.from_jax_numpy(
        pbundle, jax.tree.map(np.asarray, jstate.params),
        jax.device_get(jbundle.embedding.classic_state(jstate.tables)),
        opt_state=jax.tree.map(np.asarray, jstate.opt_state))
    jb, jd, jl, jw = jax_synthetic_batch(jbundle, B, seed=5)
    pb, pd, pl, pw = synthetic_batch(pbundle, B, seed=5)
    want = _dense_grads_jax(jbundle, jstate, jb, jd, jl, jw)
    got = _dense_grads_port(pbundle, pstate, pb, pd, pl, pw)
    assert set(got) == set(want)
    scale = max(np.linalg.norm(w) for w in want.values())
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32, k
        if k.startswith("din_") and k.endswith(".b2"):
            # a gradient of 0 in exact arithmetic: rounding noise on both sides
            assert max(np.linalg.norm(w), float(g.norm())) <= ZERO_GRAD * scale, k
            continue
        if not w.any():           # a parameter outside the graph: 0 on both sides
            assert not g.any(), k
            continue
        err = np.linalg.norm(g.numpy() - w) / np.linalg.norm(w)
        assert err <= GRAD_REL_L2, (k, err, np.linalg.norm(w))
    jtrain = jstep_mod.make_train_step(jbundle, donate=False, sparse_update="packed")
    jstate2, jinfo = jtrain(jstate, jb, jl, jw, jd, jax.random.PRNGKey(0))
    pstate2, pinfo = make_train_step(pbundle)(pstate, pb, pl, pw, pd, seed=0)
    np.testing.assert_allclose(float(pinfo["loss"]), float(jinfo["loss"]), rtol=LOSS_RTOL)
    assert pinfo["loss"].dtype == pinfo["regularization"].dtype == torch.float32
    assert {p.dtype for p in pstate2.params.values()} == {torch.float32}
    assert {p.dtype for p in pstate2.opt_state["mu"].values()} == {torch.float32}


def test_every_sparse_update_takes_the_policy():
    """The packed, scatter and dense train steps share ``apply_model``: under
    the policy, from one state and batch, their losses agree and so do the
    dense params they update (float32 masters), up to float32 sums in
    another order."""
    bundle = create_model("autoint", bucket_size=256, compute_dtype=BF, device="cpu")
    state = create_train_state(bundle, seed=2)
    batch, dense, labels, weight = synthetic_batch(bundle, B, seed=9)
    out = {}
    for update in ("packed", "scatter", "dense"):
        start = dataclasses.replace(
            state, params={k: p.clone() for k, p in state.params.items()},
            opt_state={k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v)
                       for k, v in state.opt_state.items()},
            tables={k: {"w": t["w"].clone(), "show": t["show"].clone(),
                        "opt": {n: x.clone() for n, x in t["opt"].items()}}
                    for k, t in state.tables.items()})
        out[update] = make_train_step(bundle, sparse_update=update)(
            start, batch, labels, weight, dense, seed=1)
    loss, params = float(out["packed"][1]["loss"]), out["packed"][0].params
    for update in ("scatter", "dense"):
        new, info = out[update]
        np.testing.assert_allclose(float(info["loss"]), loss, rtol=1e-6)
        for k, p in new.params.items():
            assert p.dtype == torch.float32
            torch.testing.assert_close(p, params[k], rtol=0, atol=1e-7)


# -- the JAX package's own bf16 test, ported; the command lines --------------

def _dataset(bundle, n_batches, batch_size=64, seed0=0):
    for i in range(n_batches):
        yield synthetic_batch(bundle, batch_size, seed=seed0 + i)


def test_bf16_compute_policy_tracks_float32_and_learns():
    """``tests/test_train.py::test_bf16_compute_policy`` in the port: master
    params stay float32, outputs come back float32 within 3e-2 of the
    float32 model's, and ``fit`` then ``evaluate`` learns (AUC > 0.6)."""
    b32 = create_model("autoint", bucket_size=512, sparse_lr=5e-2, dense_lr=1e-2,
                       device="cpu")
    b16 = create_model("autoint", bucket_size=512, compute_dtype=BF, sparse_lr=5e-2,
                       dense_lr=1e-2, device="cpu")
    batch = synthetic_batch(b32, 64)[0]
    state = create_train_state(b32, seed=0)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    embs = b32.embedding.lookup(b32.embedding.weights(state.tables), batch)
    out32 = apply_model(b32, state.params, embs)
    out16 = apply_model(b16, state.params, embs)
    assert out16[TASK].dtype == torch.float32
    np.testing.assert_allclose(out16[TASK].numpy(), out32[TASK].numpy(), atol=3e-2)
    assert not torch.equal(out16[TASK], out32[TASK])
    state = fit(b16, _dataset(b16, 40), log_every=0)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    m = evaluate(b16, _dataset(b16, 6, seed0=2000), state)
    assert m[TASK]["auc"] > 0.6


def test_server_builds_a_bf16_compute_bundle(monkeypatch, tmp_path):
    """``--compute-dtype bf16`` with ``--table-dtype``, and with
    ``--checkpoint``: a float32 bundle's checkpoint restores into the
    policy's bundle, whose params stay float32."""
    from recommendsystem_tpu_torch.serving import server
    from recommendsystem_tpu_torch.train import save_checkpoint

    served = []

    class Server:
        def __init__(self, svc):
            served.append(svc)

        def serve_forever(self):
            pass

    monkeypatch.setattr(server, "serve", lambda svc, port=0: Server(svc))
    server.main(["--model", "finish", "--bucket-size", "64", "--device", "cpu",
                 "--max-batch", "8", "--compute-dtype", "bf16", "--table-dtype", "bf16"])
    (svc,) = served
    assert svc.bundle.compute_dtype == BF
    assert {t["w"].dtype for t in svc.state.tables.values()} == {BF}
    assert {p.dtype for p in svc.state.params.values()} == {torch.float32}
    state = create_train_state(create_model("finish", bucket_size=64, device="cpu"), seed=5)
    save_checkpoint(str(tmp_path / "ckpt"), dataclasses.replace(state, step=3))
    server.main(["--model", "finish", "--bucket-size", "64", "--device", "cpu",
                 "--max-batch", "8", "--compute-dtype", "bf16", "--checkpoint",
                 str(tmp_path / "ckpt")])
    restored = served[-1].state
    assert served[-1].bundle.compute_dtype == BF and restored.step == 3
    for k, p in state.params.items():
        assert restored.params[k].dtype == torch.float32
        torch.testing.assert_close(restored.params[k], p, rtol=0, atol=0)


def test_daily_builds_a_bf16_compute_bundle(monkeypatch, tmp_path):
    from recommendsystem_tpu_torch.train import daily

    made = []

    def create(name, **kw):
        made.append(create_model(name, **kw))
        return made[-1]

    monkeypatch.setattr(daily, "create_model", create)
    assert daily.main(["--model", "finish", "--data-dir", "/nonexistent", "--state-dir",
                       str(tmp_path), "--bucket-size", "64", "--device", "cpu",
                       "--compute-dtype", "bf16", "--today", "20260802"]) is None
    assert [b.compute_dtype for b in made] == [BF]
