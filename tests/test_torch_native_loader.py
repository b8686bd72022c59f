"""The port's binding of the C++ record loader (``native/recloader.cc``).

The library builds at first use into the port's ``_build/`` (nothing here
is skipped: where it cannot build, the tests fail with the compiler's
output).  Two processes that build it into one empty directory at once
both load a whole library.  Its splitmix64 and CRC equal the Python ones;
its batches equal the JAX package's pure-Python pipeline (interleave,
decode, pad) on the same files, exactly.  The JAX package's own binding is
never called here: it builds in place in ``native/``.
"""

import ctypes
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from recommendsystem_tpu.data.loader import batched as jbatched
from recommendsystem_tpu.data.loader import interleave_records as jinterleave
from recommendsystem_tpu.data.parse import decode_batch as jdecode_batch
from recommendsystem_tpu.data.parse import examples_to_batch as jexamples_to_batch
from recommendsystem_tpu.data.tfrecord import read_tfrecord as jread_tfrecord
from recommendsystem_tpu.embedding import EmbeddingFeatures as JaxEngine
from recommendsystem_tpu.embedding import SparseAdam as JaxSparseAdam
from recommendsystem_tpu.embedding import category_column as jcat
from recommendsystem_tpu.embedding import embedding_column as jemb
from recommendsystem_tpu_torch.data import native_loader
from recommendsystem_tpu_torch.data.example_proto import encode_example
from recommendsystem_tpu_torch.data.native_loader import (NativeBuildError,
                                                          NativeRecordLoader,
                                                          NativeRecordWriter)
from recommendsystem_tpu_torch.data.tfrecord import (crc32c, read_tfrecord,
                                                     write_tfrecord)
from recommendsystem_tpu_torch.embedding import (EmbeddingFeatures, category_column,
                                                 embedding_column)
from recommendsystem_tpu_torch.embedding.feature_column import _splitmix64

ROOT = Path(__file__).resolve().parent.parent


def engines(slots=("10", "11"), bucket=1000, seq_slot="10", seq_len=6):
    """The same columns in both packages: a mean column a slot and a
    sequence column over ``seq_slot``'s feature."""
    pcols, jcols = [], []
    for s in slots:
        pcols.append(embedding_column(category_column(s, bucket), 8, combiner="mean"))
        jcols.append(jemb(jcat(s, bucket), 8, combiner="mean"))
        if s == seq_slot:
            pcols.append(embedding_column(category_column(s, bucket), 8, combiner=None,
                                          seq_max_len=seq_len, name=f"seq_{s}"))
            jcols.append(jemb(jcat(s, bucket), 8, combiner=None, seq_max_len=seq_len,
                              name=f"seq_{s}"))
    return EmbeddingFeatures(pcols), JaxEngine(jcols, JaxSparseAdam())


def write_files(tmp_path, n_files=3, per_file=11, seed=0):
    rng = np.random.default_rng(seed)
    files = []
    for fi in range(n_files):
        recs = []
        for _ in range(per_file):
            feats = {"watch_duration": [int(rng.integers(0, 60000))]}
            for s in ("10", "11"):
                if rng.uniform() < 0.9:
                    feats[s] = rng.integers(0, 2 ** 62, rng.integers(1, 9)).tolist()
            recs.append(encode_example(feats))
        path = str(tmp_path / f"part-{fi}.tfrecord")
        write_tfrecord(path, recs)
        files.append(path)
    return files


def test_build_lands_in_the_ports_build_dir():
    path = native_loader.build()
    assert path.parent == ROOT / "recommendsystem_tpu_torch" / "_build"
    assert path.exists() and path.name.startswith("librecloader-")
    assert native_loader.get_lib().rec_crc32c(b"123456789", 9) == 0xE3069283


_BUILDER = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    from recommendsystem_tpu_torch.data import native_loader as nl
    nl.BUILD_DIR = Path(sys.argv[1])
    go = Path(sys.argv[2])
    while not go.exists():
        time.sleep(0.01)
    print(nl.get_lib().rec_crc32c(b"123456789", 9))
""")


def test_two_builds_at_once_both_load(tmp_path):
    """Two processes build into one empty directory at the same moment:
    each compiles to a file of its own and moves it into place, so each
    loads a whole library and no temporary file is left behind."""
    build_dir, go = tmp_path / "build", tmp_path / "go"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, str(build_dir), str(go)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    go.write_text("")
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == str(0xE3069283)
    assert [f.name for f in build_dir.iterdir()] == [native_loader.library_path().name]


def test_missing_compiler_raises_a_named_error(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path / "no-such-dir"))
    with pytest.raises(NativeBuildError, match="g\\+\\+"):
        native_loader.build()


def test_failed_compile_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / "recloader.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_loader, "SOURCE", bad)
    with pytest.raises(NativeBuildError, match="error"):
        native_loader.build()
    assert list((tmp_path / "build").iterdir()) == []     # no half-built file


@pytest.mark.parametrize("v", [0, 1, 2 ** 62, 123456789, 2 ** 63, 2 ** 64 - 1])
def test_splitmix64_matches_python(v):
    got = native_loader.get_lib().rec_splitmix64(ctypes.c_uint64(v))
    assert got == int(_splitmix64(np.array([v], dtype=np.uint64))[0])


@pytest.mark.parametrize("data", [b"", b"123456789", b"\x00" * 32, bytes(range(256)) * 3])
def test_crc32c_matches_python(data):
    assert native_loader.get_lib().rec_crc32c(data, len(data)) == crc32c(data)


@pytest.mark.parametrize("batch_size,cycle,block", [(8, 1, 100), (5, 2, 3), (16, 4, 8)])
def test_batches_equal_the_jax_python_pipeline(tmp_path, batch_size, cycle, block):
    peng, jeng = engines()
    files = write_files(tmp_path)
    loader = NativeRecordLoader(files, peng, batch_size=batch_size, ids_per_feature=4,
                                scalar_features=["watch_duration"],
                                cycle_length=cycle, block_length=block)
    got = list(loader)
    raw = list(jinterleave(files, cycle_length=cycle, block_length=block))
    want = [(jexamples_to_batch(jdecode_batch(rb), jeng, 4), jdecode_batch(rb))
            for rb in jbatched(raw, batch_size)]
    assert len(got) == len(want)
    assert sum(b["10"].rows.shape[0] for b, _ in got) == 33
    for (nb, scal), (pb, examples) in zip(got, want):
        assert set(nb) == set(pb)
        for key in pb:
            assert isinstance(nb[key].rows, torch.Tensor)
            assert nb[key].rows.dtype == torch.int32 and nb[key].mask.dtype == torch.float32
            np.testing.assert_array_equal(nb[key].rows.numpy(), pb[key].rows, key)
            np.testing.assert_array_equal(nb[key].mask.numpy(), pb[key].mask, key)
        assert scal["watch_duration"].dtype == torch.int64
        np.testing.assert_array_equal(scal["watch_duration"].numpy(),
                                      [e["watch_duration"][0] for e in examples])


def test_corrupt_record_stops_cleanly(tmp_path):
    peng, _ = engines()
    files = write_files(tmp_path, n_files=1, per_file=5)
    raw = bytearray(open(files[0], "rb").read())
    raw[30] ^= 0xFF     # a byte inside the first record's payload
    open(files[0], "wb").write(bytes(raw))
    loader = NativeRecordLoader(files, peng, batch_size=4, verify_crc=True)
    assert sum(b["10"].rows.shape[0] for b, _ in loader) < 5


def test_fuzzed_records_do_not_crash_the_parser(tmp_path):
    """Random bytes framed as valid TFRecords: every record is consumed,
    the two good ones parse as the Python codec parses them."""
    peng, jeng = engines()
    rng = np.random.default_rng(7)
    good = encode_example({"10": [1, 2], "11": [3], "watch_duration": [5]})
    recs = [good] + [bytes(rng.integers(0, 256, rng.integers(1, 120), dtype=np.uint8))
                     for _ in range(200)] + [good]
    path = str(tmp_path / "fuzz.tfrecord")
    write_tfrecord(path, recs)
    batches = list(NativeRecordLoader([path], peng, batch_size=32,
                                      scalar_features=["watch_duration"]))
    assert sum(b["10"].rows.shape[0] for b, _ in batches) == 202
    want = jexamples_to_batch(jdecode_batch([good]), jeng, 5)
    for key in want:
        np.testing.assert_array_equal(batches[0][0][key].rows[0].numpy(), want[key].rows[0])
        np.testing.assert_array_equal(batches[-1][0][key].rows[-1].numpy(), want[key].rows[0])


def test_writer_round_trips(tmp_path):
    path = str(tmp_path / "w.tfrecord")
    recs = [b"alpha", b"", b"x" * 500, encode_example({"5": [1, 2, 3]})]
    with NativeRecordWriter(path) as w:
        for r in recs:
            w.write(r)
    assert list(read_tfrecord(path, verify_crc=True)) == recs
    assert list(jread_tfrecord(path, verify_crc=True)) == recs
    other = str(tmp_path / "p.tfrecord")
    write_tfrecord(other, recs)
    assert open(other, "rb").read() == open(path, "rb").read()
    with pytest.raises(IOError, match="cannot open"):
        NativeRecordWriter(str(tmp_path / "no-such-dir" / "x"))
