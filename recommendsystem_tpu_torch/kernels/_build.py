"""Build, load and count the port's CUDA kernels.

Each source ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), in ``_build/`` beside the package, named by a hash of the
sources and flags so that an edited source is rebuilt.  It is loaded with
``ctypes``.  Nothing is built when a module is imported: the first launch of
a kernel builds its library, and ``build_all()`` builds every source at once,
one ``nvcc`` per source, all started together.

Every C launcher returns ``cudaGetLastError()``; ``check`` raises when that
is not 0.  ``count_launch`` is called by each wrapper where it launches its
kernel and nowhere else, so a run can show which kernels its path reached.
A CUDA graph's capture counts its launches without running them: the
capture takes them back (``set_launch_counts``) and each replay adds them
(``add_launches``), so a replayed step counts what an eager one does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_U = ctypes.c_uint
# C entry points per source: name -> argtypes (pointers and the stream as
# c_void_p, so that ctypes does not cut them to 32 bits)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "fold": {
        "fold_mean_group": [_P, _I, _P],
        "fold_rows_group": [_P, _I, _P],
        "fold_max_members": [],
    },
    "field_attention": {
        "field_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _F,
                                _I, _P, _U, _F, _U, _I, _P],
        "field_attention_bwd": [_P] * 10 + [_I, _I, _I, _L, _F, _I, _P, _U,
                                            _F, _U, _I, _P],
    },
    "unfold_scatter": {
        "unfold_mean_group_f32": [_P, _I, _P],
        "unfold_rows_group_f32": [_P, _I, _P],
        "unfold_max_members": [],
    },
    "sparse_adam": {
        "sparse_adam_group": [_P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _P],
        "sparse_adam_max_storages": [],
        "sparse_adam_max_d": [],
    },
    "sparse_adagrad": {
        "sparse_adagrad_group": [_P, _P, _P, _P, _I, _F, _P],
        "sparse_adagrad_max_storages": [],
        "sparse_adagrad_max_d": [],
    },
    "din_pool": {
        "din_pool": [_P] * 8 + [_L, _I, _L, _L, _L, _L, _L, _I, _P],
        "din_pool_gather": [_P] * 9 + [_L, _I, _L, _I, _I, _I, _I, _P],
    },
    "interacting": {
        "interacting_attention": [_P] * 12 + [_L, _I, _I, _F, _F, _I, _I, _P],
    },
    "dcn_cross": {
        "dcn_cross_bwd": [_P] * 6 + [_L, _L, _I, _I, _P],
    },
}

# the float types the kernels take as inputs under the bf16 compute policy
FLOATS = (torch.float32, torch.bfloat16)

KERNELS = ("fold_mean", "fold_rows", "field_attention", "field_attention_bwd",
           "unfold_mean", "unfold_rows", "sparse_adam_update", "din_pool",
           "interacting_attention", "sparse_adagrad_update", "dcn_cross")
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Put the counts back to ``counts`` (a ``launch_counts()``)."""
    _launches.update(counts)


def add_launches(counts: Dict[str, int]) -> None:
    """Count ``counts`` more launches ({kernel: n}): a replayed graph's."""
    for name, n in counts.items():
        _launches[name] += n


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    digest = hashlib.sha1()
    for src in sorted(CSRC.glob("*.cu*")):   # the .cu and the shared header
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one nvcc
    per source, all running at once.  Returns each new build's compiler
    output (``-Xptxas -v``: registers, shared memory and spills per kernel);
    raises with that output if a build fails."""
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)       # atomic: a reader sees all or nothing
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.rs_error_string.argtypes = [ctypes.c_int]
    lib.rs_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.rs_error_string(code).decode()})")


def require(t, what: str, dtype, shape=None, device=None) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` (a dtype, or
    a tuple of the dtypes a kernel takes there) and of ``shape`` and on
    ``device`` where given: what every kernel takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype}, expected "
                        + " or ".join(str(d) for d in dtypes))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, for a launcher's stream."""
    return torch.cuda.current_stream(device).cuda_stream
