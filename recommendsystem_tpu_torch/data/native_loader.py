"""ctypes binding of the C++ record loader (``native/recloader.cc``).

Counterpart of ``recommendsystem_tpu/data/native_loader.py``.  The C++
source does TFRecord framing, tf.Example parsing, splitmix64 hashing and
static-shape padding with a background prefetch thread, the role
tensornet's C++ readers play in the reference stack; its splitmix64 and
CRC are bit for bit the Python ones (``embedding/feature_column.py``,
``data/tfrecord.py``).

The library is built at first use, never at import: ``g++ -O3 -std=c++17
-shared -fPIC -pthread`` into the git-ignored ``_build/`` beside the
package (where ``kernels/_build.py`` puts the CUDA libraries), under a name
that hashes the source and the flags.  The compiler writes a file of its
own and ``os.replace`` moves it into place, so builds that run at once in
several processes each load a whole library.  There is no fallback: where
``g++`` is missing or the build fails, ``NativeBuildError`` carries the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from ..embedding.engine import EmbeddingFeatures, IdBatch
from ..kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "recloader.cc"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


class NativeBuildError(RuntimeError):
    """The C++ loader could not be built; the message holds the compiler's
    output."""


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"librecloader-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """The built library's path, compiling it first if it is not there."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:                 # no compiler on the PATH
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{' '.join(cmd)} exited {proc.returncode}:\n"
                               f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)                 # atomic: a reader sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    lib.rec_loader_create.restype = ctypes.c_void_p
    lib.rec_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.rec_loader_next.restype = ctypes.c_int
    lib.rec_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))]
    lib.rec_loader_destroy.restype = None
    lib.rec_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.rec_splitmix64.restype = ctypes.c_uint64
    lib.rec_splitmix64.argtypes = [ctypes.c_uint64]
    lib.rec_crc32c.restype = ctypes.c_uint32
    lib.rec_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.rec_writer_create.restype = ctypes.c_void_p
    lib.rec_writer_create.argtypes = [ctypes.c_char_p]
    lib.rec_writer_write.restype = ctypes.c_int
    lib.rec_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_size_t]
    lib.rec_writer_destroy.restype = None
    lib.rec_writer_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeRecordLoader:
    """Iterates (batch, scalars) from TFRecord files via the C++ loader.

    ``batch`` is {column_key: IdBatch} of CPU tensors; ``scalars`` is
    {name: (B,) int64 CPU tensor}.  Short final batches are emitted with
    their true count.  A record that fails its CRC ends the stream there.
    """

    def __init__(self, files: Sequence[str], embedding: EmbeddingFeatures,
                 batch_size: int, ids_per_feature: int = 5,
                 scalar_features: Sequence[str] = (),
                 cycle_length: int = 4, block_length: int = 8,
                 verify_crc: bool = True):
        self._handle = None
        self._lib = lib = get_lib()
        self.embedding = embedding
        self.batch_size = batch_size
        self.scalar_features = list(scalar_features)

        self.columns = list(embedding.columns.items())
        feat_names, buckets, max_lens = [], [], []
        for key, col in self.columns:
            feat_names.append(col.categorical_column.key.encode())
            buckets.append(col.categorical_column.bucket_size)
            max_lens.append(col.seq_max_len if col.is_sequence else ids_per_feature)
        self.max_lens = max_lens

        n = len(feat_names)
        paths = (ctypes.c_char_p * len(files))(*[f.encode() for f in files])
        names = (ctypes.c_char_p * n)(*feat_names)
        bks = (ctypes.c_int64 * n)(*buckets)
        mls = (ctypes.c_int * n)(*max_lens)
        scal = (ctypes.c_char_p * max(len(self.scalar_features), 1))(
            *[s.encode() for s in self.scalar_features])

        self._handle = lib.rec_loader_create(
            paths, len(files), names, bks, mls, n, scal,
            len(self.scalar_features), batch_size, cycle_length, block_length,
            1 if verify_crc else 0)
        self._rows_out = (ctypes.POINTER(ctypes.c_int32) * n)()
        self._mask_out = (ctypes.POINTER(ctypes.c_float) * n)()
        self._scal_out = (ctypes.POINTER(ctypes.c_int64) *
                          max(len(self.scalar_features), 1))()

    def __iter__(self) -> Iterator[Tuple[Dict[str, IdBatch], Dict[str, torch.Tensor]]]:
        return self

    def __next__(self):
        if self._handle is None:
            raise StopIteration
        count = self._lib.rec_loader_next(self._handle, self._rows_out,
                                          self._mask_out, self._scal_out)
        if count == 0:
            self.close()
            raise StopIteration

        def take(ptr, shape):
            # the loader reuses its buffers: copy the live rows out
            return torch.from_numpy(np.ctypeslib.as_array(ptr, shape=shape)[:count].copy())

        batch: Dict[str, IdBatch] = {}
        for i, (key, _) in enumerate(self.columns):
            shape = (self.batch_size, self.max_lens[i])
            batch[key] = IdBatch(rows=take(self._rows_out[i], shape),
                                 mask=take(self._mask_out[i], shape))
        scalars = {name: take(self._scal_out[i], (self.batch_size,))
                   for i, name in enumerate(self.scalar_features)}
        return batch, scalars

    def close(self):
        if self._handle is not None:
            self._lib.rec_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativeRecordWriter:
    """C++ TFRecord writer (crc32c-framed), the write twin of the loader."""

    def __init__(self, path: str):
        self._handle = None
        self._lib = get_lib()
        self._handle = self._lib.rec_writer_create(path.encode())
        if not self._handle:
            raise IOError(f"cannot open {path}")

    def write(self, record: bytes) -> None:
        if not self._lib.rec_writer_write(self._handle, record, len(record)):
            raise IOError("short write")

    def close(self):
        if self._handle:
            self._lib.rec_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
