"""Criteo TSV support of the port against the JAX package's: line parsing
and log2 bucketization, the parse function's batches (exactly equal), the
39-slot autoint bundle, and a short ``fit`` on a synthetic file in the
Criteo layout that must learn its planted signal, as
``tests/test_criteo.py`` requires of the JAX package (AUC > 0.65 on the
training file)."""

import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import criteo as jcriteo
from recommendsystem_tpu_torch.data import criteo
from recommendsystem_tpu_torch.train import evaluate, fit

torch.set_num_threads(1)


def _lines():
    ints = [str(2 ** i) for i in range(13)]
    cats = [format(i + 1, "x") for i in range(26)]
    return ["\t".join(["1"] + ints + cats),
            "0\t\t5" + "\t" * 37 + "ff",
            "1\t0\t-3" + "\t" * 37,
            "0"]


@pytest.mark.parametrize("line", _lines())
def test_parse_line_equals_jax(line):
    got = criteo.parse_line(line)
    assert got == jcriteo.parse_line(line)
    assert len(got[1]) == 39


def test_buckets_and_empty_fields():
    label, feats = criteo.parse_line(_lines()[0])
    assert label == 1.0 and feats[3] == [3] and feats[10] == [10] and feats[13] == [1]
    _, feats = criteo.parse_line(_lines()[1])
    assert feats[0] == [] and feats[1] == [2] and feats[38] == [0xFF] and feats[20] == []


def test_parse_fn_equals_jax(tmp_path):
    path = str(tmp_path / "criteo.tsv")
    criteo.write_synthetic_criteo(path, 300, seed=1)
    jpath = str(tmp_path / "jax.tsv")
    jcriteo.write_synthetic_criteo(jpath, 300, seed=1)
    assert open(path).read() == open(jpath).read()
    peng = criteo.criteo_embedding(bucket_size=512)
    jeng = jcriteo.criteo_embedding(bucket_size=512)
    got = list(criteo.criteo_dataset(path, 128, peng, drop_remainder=False))
    want = list(jcriteo.criteo_dataset(path, 128, jeng, drop_remainder=False))
    assert len(got) == len(want) == 3
    for (b, d, l, w, e), (jb, jd, jl, jw, je) in zip(got, want):
        assert d is None and jd is None and e == je == {}
        assert set(b) == set(jb)
        for k in jb:
            np.testing.assert_array_equal(b[k].rows.numpy(), jb[k].rows, err_msg=k)
            np.testing.assert_array_equal(b[k].mask.numpy(), jb[k].mask, err_msg=k)
        for t in jl:
            np.testing.assert_array_equal(l[t].numpy(), jl[t])
        np.testing.assert_array_equal(w.numpy(), jw)
    assert got[0][0]["i1"].rows.shape == (128, 1) and got[0][0]["c1"].rows.shape == (128, 2)


def test_criteo_autoint_builds():
    from recommendsystem_tpu_torch.embedding.optimizers import SparseAdam
    bundle = criteo.criteo_autoint(bucket_size=4096, device="cpu")
    jbundle = jcriteo.criteo_autoint(bucket_size=4096)
    assert bundle.name == "autoint" and len(bundle.embedding.columns) == 39
    assert set(bundle.embedding.columns) == set(criteo.ALL_SLOTS)
    assert bundle.embedding.storage == jbundle.embedding.storage
    assert isinstance(bundle.embedding.sparse_opt, SparseAdam)
    eng = criteo.criteo_embedding()
    assert eng.storage == jcriteo.criteo_embedding().storage


def test_fit_learns_the_planted_signal(tmp_path):
    path = str(tmp_path / "criteo.tsv")
    criteo.write_synthetic_criteo(path, 2048, seed=0)
    assert len(open(path).readline().split("\t")) == 40
    bundle = criteo.criteo_autoint(bucket_size=4096, sparse_lr=5e-2, dense_lr=1e-2,
                                   device="cpu")

    def ds():
        return ((b, d, l, w) for b, d, l, w, _ in
                criteo.criteo_dataset(path, 128, bundle.embedding))

    state = fit(bundle, ds(), log_every=0)
    assert state.step == 16
    auc = evaluate(bundle, ds(), state)["video_id_rank_skip_model"]["auc"]
    assert auc > 0.65, f"criteo AUC {auc}"
