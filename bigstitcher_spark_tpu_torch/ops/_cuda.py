"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ctypes. Nothing
is built when a module is imported: the first launch builds (or
:func:`build_all` builds every library at once, one ``nvcc`` per source,
all started together). Libraries land in ``csrc/build/`` under a name
keyed by a hash of the sources and flags, so an edited source rebuilds; a
file lock keeps concurrent processes from racing on one build.

There is no fallback: a missing ``nvcc``, a failed build or a failed load
raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(CSRC, "build")
SOURCES = ("composite", "shift", "gather", "convert", "sep", "downsample",
           "pcm", "fft", "solve", "dog", "descriptors", "ransac", "intensity",
           "cg", "nonrigid", "epilogue", "shard")
HEADERS = ("fusion_common.cuh", "fit3d.cuh", "reduce.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_D = ctypes.c_double


class BstCompositeView(ctypes.Structure):
    """Mirror of ``struct BstCompositeView`` in ``csrc/composite.cu`` (144
    bytes: two pointers, then 4-byte fields)."""

    _fields_ = [("tile", _VP), ("grid", _VP)]
    _fields_ += [(name, _I * 3) for name in ("a", "b", "n", "pad", "tshape")]
    _fields_ += [("kind", _I), ("table_off", _I), ("ctab_off", _I)]
    _fields_ += [(name, _F * 3) for name in ("frac", "diag", "off")]
    _fields_ += [("unused", _I * 4)]


# C signatures of the launchers: every pointer and the stream are c_void_p
_SIGNATURES = {
    "composite": {
        "bst_composite": [_VP] + [_I] * 3 + [_VP, _VP] + [_I] * 8
                         + [_F, _F] + [_I] * 6 + [_VP, _VP],
    },
    "shift": {
        "bst_fuse_block_shift_batch": [_VP, _I, _VP, _VP, _VP] + [_I] * 14
                                      + [_VP, _VP, _VP],
        "bst_fuse_volume_scan": [_VP] + [_I] * 4 + [_VP] * 6 + [_I] * 9
                                + [_VP, _VP],
    },
    "gather": {
        "bst_fuse_block_batch": [_VP, _I, _I, _I, _I] + [_VP] * 7 + [_I] * 6
                                + [_VP, _VP, _I, _I, _I] + [_I] * 5
                                + [_VP, _VP, _VP],
    },
    "convert": {
        "bst_convert_intensity": [_VP, _I64, _F, _F, _I, _VP, _VP],
    },
    "sep": {
        "bst_fuse_block_sep_batch": [_VP, _I, _I, _I, _I] + [_VP] * 4
                                    + [_I] * 13 + [_VP, _VP, _VP],
    },
    "downsample": {
        "bst_downsample": [_VP] + [_I] * 11 + [_I, _VP] + [_I] * 7 + [_VP],
    },
    "pcm": {
        "bst_pcm_window": [_VP] + [_I] * 5 + [_VP, _VP, _I, _VP, _VP, _VP],
        "bst_pcm_cross_power": [_VP, _VP, _I, _I64, _I, _VP, _VP, _VP],
        "bst_pcm_peaks_topk": [_VP] + [_I] * 8 + [_VP] * 5,
    },
    "fft": {
        "bst_fft_pow2": [_VP, _VP, _VP, _I, _I, _I64, _I64, _I, _F, _VP],
    },
    "solve": {
        "bst_relax_moments": [_VP] * 8 + [_I, _I, _VP, _VP, _VP, _VP],
        "bst_relax_fit": [_VP, _VP, _I, _VP, _VP, _I, _I, _I, _D, _D, _VP,
                          _VP, _VP],
        "bst_relax_error": [_VP] * 9 + [_I, _I] + [_VP] * 5,
        "bst_relax_converge": [_VP, _VP, _I, _I, _VP, _I, _D, _I, _VP, _VP],
        "bst_relax_error_converge": [_VP] * 7 + [_I, _I] + [_VP] * 5
                                    + [_I, _D, _I, _VP, _VP],
    },
    "dog": {
        "bst_dog_blur": [_VP] + [_I] * 6 + [_VP] + [_I] * 6 + [_VP, _VP],
        "bst_dog_extrema": [_VP, _VP] + [_I] * 4 + [_VP] * 3 + [_I] * 7
                           + [_VP] * 6,
        "bst_dog_topk": [_VP] * 3 + [_I] * 6 + [_VP] * 3,
        "bst_dog_localize": [_VP] + [_I] * 4 + [_VP, _VP, _I, _VP, _VP, _VP],
    },
    "descriptors": {
        "bst_knn_descriptors": [_VP, _VP] + [_I] * 5 + [_VP] + [_I] * 6
                               + [_VP] * 7,
        "bst_ratio_center": [_VP, _I, _I, _VP, _I, _VP, _VP],
        "bst_ratio_mma_probe": [_VP, _VP, _I, _I, _VP, _VP],
        "bst_ratio_match": [_VP, _I, _VP, _I, _I, _VP, _F, _VP] + [_I] * 4
                           + [_VP] * 9,
    },
    "ransac": {
        "bst_ransac_score": [_VP, _VP, _I, _VP, _I, _I, _I, _F] + [_I] * 4
                            + [_VP] * 5,
        "bst_ransac_refit": [_VP, _VP, _I, _VP, _D, _I, _I, _I, _D, _I, _I]
                            + [_VP] * 6,
    },
    "intensity": {
        "bst_linefit_ransac": [_VP, _VP, _VP, _I, _I, _VP, _I, _F]
                              + [_VP] * 6,
    },
    "cg": {
        "bst_cg_spmv": [_I, _I, _I] + [_VP] * 10 + [_I, _VP],
        "bst_cg_update": [_I, _I] + [_VP] * 9,
    },
    "shard": {
        "bst_shard_sum_blocks": [_I64],
        "bst_shard_sum": [_I64, _I] + [_VP] * 6 + [_I, _VP, _VP, _VP],
    },
    "epilogue": {
        "bst_block_epilogue": [_VP] * 3 + [_I] * 4 + [_F, _F] + [_I] * 3
                              + [_VP] * 5 + [_I, _I, _VP],
    },
    "nonrigid": {
        "bst_nonrigid_fuse_batch": [_VP, _I, _I, _I, _I, _VP, _I, _I, _I]
                                   + [_VP] * 9 + [_I] * 6 + [_I] * 5
                                   + [_VP, _VP, _VP],
    },
}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "kernels are built from csrc/ at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def _start_build(name: str):
    """Start ``nvcc`` for one source into a temporary file; returns
    (process, tmp path, final path, lock file) or None when up to date."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = library_path(name)
    lock = open(os.path.join(BUILD_DIR, f"{name}.lock"), "w")
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            lock.close()
            return None
        tmp = f"{out}.tmp{os.getpid()}"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    except BaseException:
        lock.close()
        raise
    return proc, tmp, out, lock


def _finish_build(name: str, job) -> str:
    proc, tmp, out, lock = job
    try:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)
        with open(out + ".log", "w") as f:
            f.write(log)
        return log
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
        lock.close()


def build_all(names=SOURCES) -> dict:
    """Build every library that is not yet built, all ``nvcc`` processes
    started together. Returns {name: seconds of its build, 0.0 if cached}."""
    t0 = time.perf_counter()
    jobs = {n: _start_build(n) for n in names}
    took = {}
    for n, job in jobs.items():
        if job is not None:
            _finish_build(n, job)
        took[n] = time.perf_counter() - t0 if job is not None else 0.0
    return took


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all((name,))
    lib = ctypes.CDLL(library_path(name))
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    lib.bst_error_string.argtypes = [_I]
    lib.bst_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, ret: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if ret != 0:
        msg = lib.bst_error_string(ret).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({ret}: {msg})")


def ptxas_report(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said when the library was built."""
    p = library_path(name) + ".log"
    if not os.path.exists(p):
        return ""
    with open(p) as f:
        return f.read()
