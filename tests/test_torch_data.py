"""The port's data plane against the JAX package's: TFRecord framing and
CRC, the tf.Example codec, file listing, sharding and interleave, the
prefetcher, ``balance_batches`` and the staytime and ctr parse functions.

Every comparison is exact: both packages do the same integer and string
work on the host (splitmix64 hashing, padding, the staytime label formula
in numpy float32), so ids, masks, labels, weights, dense inputs and extras
must be equal to the bit.  The port's batches are CPU tensors, the JAX
package's numpy.  ``write_staytime_day`` and ``write_ctr_day`` are shared
with the other data-plane tests.
"""

import os

import numpy as np
import pytest
import torch

from recommendsystem_tpu.data import example_proto as jproto
from recommendsystem_tpu.data import loader as jloader
from recommendsystem_tpu.data import parse as jparse
from recommendsystem_tpu.data import tfrecord as jtfr
from recommendsystem_tpu.models import create_model as jax_create_model
from recommendsystem_tpu.models.staytime import StaytimeConfig as JaxStaytimeConfig
from recommendsystem_tpu_torch.data import example_proto as proto
from recommendsystem_tpu_torch.data import loader
from recommendsystem_tpu_torch.data import parse
from recommendsystem_tpu_torch.data import tfrecord as tfr
from recommendsystem_tpu_torch.embedding import IdBatch
from recommendsystem_tpu_torch.models import create_model
from recommendsystem_tpu_torch.models.staytime import StaytimeConfig

torch.set_num_threads(1)
DAYS = ("20260801", "20260802")
STAYTIME_SMALL = dict(bucket_size=128, seq_max_len=4)


def staytime_record(rng, slots, i, day="d"):
    feats = {"extra_info": [(f"{day}-req{i}" if i % 5 else
                             f"x_video_homepage_landing_{i}").encode()],
             "video_duration": [int(rng.integers(5_000, 60_000))],
             "watch_duration": [int(rng.integers(0, 60_000))]}
    for s in slots:
        if rng.uniform() < 0.9:           # some slots absent from a record
            feats[s] = rng.integers(0, 2 ** 62, rng.integers(1, 7)).tolist()
    return feats


def ctr_record(rng, slots, i, day="d", dense_keys=()):
    feats = {"label": [int(rng.integers(0, 2))],
             "extra_info": [f"{day}-{i}".encode()]}
    for k in dense_keys:
        feats[k] = [float(np.float32(rng.uniform(-1, 1)))]
    for s in slots:
        if rng.uniform() < 0.9:
            feats[s] = rng.integers(0, 2 ** 62, rng.integers(1, 7)).tolist()
    return feats


def _write_day(root, day, shards, per_shard, make, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, day), exist_ok=True)
    for p in range(shards):
        recs = [proto.encode_example(make(rng, p * per_shard + i))
                for i in range(per_shard)]
        tfr.write_tfrecord(os.path.join(root, day, f"part-{p:05d}"), recs)


def write_staytime_day(root, day, slots, shards=2, per_shard=40, seed=0):
    _write_day(root, day, shards, per_shard,
               lambda rng, i: staytime_record(rng, slots, i, day), seed)


def write_ctr_day(root, day, slots, shards=2, per_shard=40, seed=0, dense_keys=()):
    _write_day(root, day, shards, per_shard,
               lambda rng, i: ctr_record(rng, slots, i, day, dense_keys), seed)


# -- TFRecord and CRC ---------------------------------------------------------

@pytest.mark.parametrize("data,want", [(b"", 0x0), (b"\x00" * 32, 0x8A9136AA),
                                       (b"123456789", 0xE3069283)])
def test_crc32c_known_vectors(data, want):
    assert tfr.crc32c(data) == jtfr.crc32c(data) == want      # RFC 3720
    assert tfr.masked_crc32c(data) == jtfr.masked_crc32c(data)


@pytest.mark.parametrize("writer,reader", [(tfr, jtfr), (jtfr, tfr)],
                         ids=["port_to_jax", "jax_to_port"])
def test_tfrecord_round_trip_across_packages(tmp_path, writer, reader):
    recs = [b"hello", b"", b"x" * 1000, bytes(range(256))]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert writer.write_tfrecord(a, recs) == 4
    assert list(reader.read_tfrecord(a, verify_crc=True)) == recs
    reader.write_tfrecord(b, recs)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("offset", [9, 14])        # the length's CRC, the data
def test_tfrecord_corruption_detected_by_both(tmp_path, offset):
    path = str(tmp_path / "a")
    tfr.write_tfrecord(path, [b"hello world"])
    raw = bytearray(open(path, "rb").read())
    raw[offset] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    for mod in (tfr, jtfr):
        with pytest.raises(IOError):
            list(mod.read_tfrecord(path, verify_crc=True))


def test_truncated_record_raises(tmp_path):
    path = str(tmp_path / "a")
    tfr.write_tfrecord(path, [b"hello world"])
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-6])
    with pytest.raises(IOError, match="truncated"):
        list(tfr.read_tfrecord(path))


# -- tf.Example ---------------------------------------------------------------

EXAMPLES = [
    {"slot_1": [1, 2, 3], "neg": [-5], "big": [2 ** 62], "top": [2 ** 63 - 1],
     "low": [-2 ** 63]},
    {"wt": [1.5, 2.5, -0.0], "name": [b"abc", b"def"], "s": ["unicode é"]},
    {"empty": [], "one": [0], "f": [float(np.float32(0.1))]},
    {},
]


@pytest.mark.parametrize("feats", EXAMPLES)
def test_encode_example_bytes_equal(feats):
    enc = proto.encode_example(feats)
    assert enc == jproto.encode_example(feats)
    want = jproto.decode_example(enc)
    assert proto.decode_example(enc) == want
    assert proto.decode_example(jproto.encode_example(feats)) == want


def test_decode_reads_unpacked_and_unknown_fields():
    """Unpacked int64 and float values and fields the codec does not know
    (skipped) decode alike in both packages."""
    def varint(v):
        out = bytearray()
        while True:
            b, v = v & 0x7F, v >> 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    def field(num, wire, payload):
        head = varint(num << 3 | wire)
        return head + (varint(len(payload)) + payload if wire == 2 else payload)

    ints = field(1, 0, varint(7)) + field(1, 0, varint(9))
    floats = field(1, 5, np.float32(0.5).tobytes())
    feat_i = field(3, 2, ints)
    feat_f = field(2, 2, floats)
    entry = lambda k, f: field(1, 2, field(1, 2, k) + field(2, 2, f) + field(7, 0, varint(3)))
    data = field(1, 2, entry(b"i", feat_i) + entry(b"f", feat_f)) + field(5, 0, varint(1))
    assert proto.decode_example(data) == jproto.decode_example(data) == {"i": [7, 9], "f": [0.5]}


# -- listing, sharding, interleave, prefetch ------------------------------------

def _records_days(tmp_path):
    for day in DAYS:
        os.makedirs(tmp_path / day)
        for i in range(3):
            tfr.write_tfrecord(str(tmp_path / day / f"part-{i}"),
                               [f"{day}-{i}-{j}".encode() for j in range(4 + i)])
        (tmp_path / day / "_SUCCESS").write_text("")
    return str(tmp_path)


@pytest.mark.parametrize("days,pattern", [(DAYS, "part-*"), (DAYS[1:], "*"),
                                          (("20260799",) + DAYS, "part-[02]")])
def test_list_files_equals_jax(tmp_path, days, pattern):
    root = _records_days(tmp_path)
    got = loader.list_files(root, days=days, match_pattern=pattern)
    assert got == jloader.list_files(root, days=days, match_pattern=pattern)
    assert got
    assert loader.list_files(os.path.join(root, DAYS[0])) == \
        jloader.list_files(os.path.join(root, DAYS[0]))


@pytest.mark.parametrize("num_shards,index", [(2, 0), (2, 1), (4, 3)])
def test_shard_files_equals_jax(tmp_path, num_shards, index):
    files = loader.list_files(_records_days(tmp_path), days=DAYS)
    got = loader.shard_files(files, num_shards, index)
    assert got == jloader.shard_files(files, num_shards, index)
    assert loader.shard_files(files) == files        # one process: every file


@pytest.mark.parametrize("cycle,block", [(1, 100), (2, 2), (4, 3), (6, 1)])
def test_interleave_order_equals_jax(tmp_path, cycle, block):
    files = loader.list_files(_records_days(tmp_path), days=DAYS, match_pattern="part-*")
    got = list(loader.interleave_records(files, cycle, block))
    assert got == list(jloader.interleave_records(files, cycle, block))
    assert sorted(got) == sorted(r for f in files for r in tfr.read_tfrecord(f))


def test_batched_and_prefetch():
    assert [len(b) for b in loader.Prefetcher(loader.batched(range(10), 4))] == [4, 4, 2]
    assert [len(b) for b in loader.batched(range(10), 4, drop_remainder=True)] == [4, 4]


def test_prefetcher_surfaces_errors():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    it = iter(loader.Prefetcher(gen(), buffer_size=1))
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_dataset_reader_on_a_card_raises_without_one(tmp_path):
    """The reader runs on the card by default: with no CUDA it raises, it
    does not stay on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loader.dataset_reader(str(tmp_path), DAYS, "*", 4, lambda r: r)


# -- parsing ------------------------------------------------------------------

def _assert_item_equal(got, want):
    """A port item (tensors) equal to a JAX item (numpy) to the bit."""
    batch, dense, labels, weight = got[:4]
    jbatch, jdense, jlabels, jweight = want[:4]
    assert set(batch) == set(jbatch)
    for k in jbatch:
        assert isinstance(batch[k].rows, torch.Tensor)
        assert batch[k].rows.dtype == torch.int32 and batch[k].mask.dtype == torch.float32
        np.testing.assert_array_equal(batch[k].rows.numpy(), jbatch[k].rows, err_msg=k)
        np.testing.assert_array_equal(batch[k].mask.numpy(), jbatch[k].mask, err_msg=k)
    assert (dense is None) == (jdense is None)
    for k in jdense or {}:
        np.testing.assert_array_equal(dense[k].numpy(), jdense[k], err_msg=k)
    assert set(labels) == set(jlabels)
    for k in jlabels:
        assert labels[k].dtype == torch.float32
        np.testing.assert_array_equal(labels[k].numpy(), jlabels[k], err_msg=k)
    np.testing.assert_array_equal(weight.numpy(), jweight)
    if len(want) > 4:
        extras, jextras = got[4], want[4]
        assert set(extras) == set(jextras)
        for k in jextras:
            assert isinstance(extras[k], np.ndarray)
            np.testing.assert_array_equal(extras[k], jextras[k], err_msg=k)


def staytime_pair():
    jb = jax_create_model("staytime", cfg=JaxStaytimeConfig(**STAYTIME_SMALL))
    pb = create_model("staytime", cfg=StaytimeConfig(**STAYTIME_SMALL), device="cpu")
    return jb, pb


@pytest.mark.parametrize("ids_per_feature", [5, 2])
def test_staytime_parse_equals_jax(tmp_path, ids_per_feature):
    jb, pb = staytime_pair()
    slots = pb.config.slots
    for i, day in enumerate(DAYS):
        write_staytime_day(str(tmp_path), day, slots, seed=i)
    jfn = jparse.make_staytime_parse_fn(jb.embedding, ids_per_feature=ids_per_feature)
    pfn = parse.make_staytime_parse_fn(pb.embedding, ids_per_feature=ids_per_feature)
    args = (str(tmp_path), DAYS, "part-*", 24)
    want = list(jloader.dataset_reader(*args, parse_fn=jfn, drop_remainder=False))
    got = list(loader.dataset_reader(*args, parse_fn=pfn, drop_remainder=False,
                                     device="cpu"))
    assert len(got) == len(want) == 7                  # 160 records, the last 16
    for g, w in zip(got, want):
        _assert_item_equal(g, w)
    assert got[0][0]["seq_2125"].rows.shape == (24, 4)
    assert got[0][0]["2125"].rows.shape == (24, ids_per_feature)
    assert got[0][3].max() == 5.0                      # homepage traffic weighs 5


def test_ctr_parse_equals_jax_with_dense_inputs(tmp_path):
    jb = jax_create_model("finish", bucket_size=256)
    pb = create_model("finish", bucket_size=256, device="cpu")
    slots = [str(s) for s in range(3000, 3040)]
    dense_keys = ("4575", "4576")
    write_ctr_day(str(tmp_path), DAYS[0], slots, dense_keys=dense_keys)
    kw = dict(label_key="label", task_name="t", ids_per_feature=3, dense_keys=dense_keys)
    jfn = jparse.make_ctr_parse_fn(jb.embedding, **kw)
    pfn = parse.make_ctr_parse_fn(pb.embedding, **kw)
    files = loader.list_files(str(tmp_path), days=DAYS)
    raw = list(loader.interleave_records(files))
    for rb in loader.batched(raw, 32):
        _assert_item_equal(pfn(rb), jfn(rb))


def test_balance_batches_equals_jax(tmp_path):
    jb, pb = staytime_pair()
    write_staytime_day(str(tmp_path), DAYS[0], pb.config.slots, shards=1, per_shard=13)
    jfn = jparse.make_staytime_parse_fn(jb.embedding)
    pfn = parse.make_staytime_parse_fn(pb.embedding)
    raw = list(loader.interleave_records(loader.list_files(str(tmp_path), days=DAYS)))
    items = [pfn(rb) for rb in loader.batched(raw, 8)]
    jitems = [jfn(rb) for rb in loader.batched(raw, 8)]
    got = list(loader.balance_batches(items, 8))
    want = list(jloader.balance_batches(jitems, 8))
    assert [g[3].shape[0] for g in got] == [8, 8]
    for g, w in zip(got, want):
        _assert_item_equal(g, w)
    w = got[1][3]
    assert w[5:].sum() == 0 and w[:5].sum() == items[1][3].sum()   # pad rows weightless
    # a short batch of tensors and a dense dict, as the ctr parse gives them
    dense = {"d": torch.arange(3.0).reshape(3, 1)}
    ids = {"c": IdBatch(rows=torch.arange(6, dtype=torch.int32).reshape(3, 2),
                        mask=torch.ones(3, 2))}
    (b2, d2, l2, w2), = loader.balance_batches(
        [(ids, dense, {"t": torch.ones(3, 1)}, torch.ones(3, 1))], 7)
    np.testing.assert_array_equal(d2["d"][:, 0].numpy(), [0, 1, 2, 0, 1, 2, 0])
    np.testing.assert_array_equal(b2["c"].rows[:, 0].numpy(), [0, 2, 4, 0, 2, 4, 0])
    np.testing.assert_array_equal(w2[:, 0].numpy(), [1, 1, 1, 0, 0, 0, 0])


def test_malformed_records_equal_jax():
    good = proto.encode_example({"5": [1, 2]})
    rng = np.random.default_rng(3)
    garbage = [bytes(rng.integers(0, 256, 37, dtype=np.uint8)) for _ in range(40)]
    raw = [good] + garbage + [good, b"\x0a\xff", b"\x0a\x05\x0a\x03\x0a\x01"]
    got = parse.decode_batch(raw)
    assert got == jparse.decode_batch(raw)
    assert got[0] == {"5": [1, 2]} and got[41] == {"5": [1, 2]}
    assert len(got) == len(raw) and {} in got
    # the parse keeps the batch's shape: a malformed row has no live ids
    jb, pb = staytime_pair()
    item = parse.make_staytime_parse_fn(pb.embedding)(raw)
    _assert_item_equal(item, jparse.make_staytime_parse_fn(jb.embedding)(raw))
    empty = [i for i, d in enumerate(got) if d == {}]
    assert not item[0]["1568"].mask[empty].any()
