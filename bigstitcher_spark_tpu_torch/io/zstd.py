"""zstd frames through a ctypes binding to the system ``libzstd.so.1``.

The JAX package gets zstd from tensorstore and the ``zstandard`` module;
the port needs neither. The library is looked up at first use, and a
missing library raises there: nothing falls back to another codec.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    names = ["libzstd.so.1", ctypes.util.find_library("zstd")]
    errors = []
    for name in filter(None, names):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError as e:
            errors.append(str(e))
    else:
        raise RuntimeError(
            "zstd compression needs the system library libzstd.so.1, which "
            f"could not be loaded ({'; '.join(errors) or 'not found'})")
    sz, vp = ctypes.c_size_t, ctypes.c_void_p
    lib.ZSTD_compressBound.argtypes = [sz]
    lib.ZSTD_compressBound.restype = sz
    lib.ZSTD_compress.argtypes = [vp, sz, vp, sz, ctypes.c_int]
    lib.ZSTD_compress.restype = sz
    lib.ZSTD_decompress.argtypes = [vp, sz, vp, sz]
    lib.ZSTD_decompress.restype = sz
    lib.ZSTD_isError.argtypes = [sz]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getErrorName.argtypes = [sz]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    return lib


def _check(lib, ret: int, what: str) -> int:
    if lib.ZSTD_isError(ret):
        raise ValueError(f"zstd {what} failed: "
                         f"{lib.ZSTD_getErrorName(ret).decode()}")
    return ret


def compress(data: bytes, level: int = 0) -> bytes:
    """One zstd frame of ``data`` (level 0 is zstd's default level)."""
    lib = _lib()
    src = bytes(data)
    cap = lib.ZSTD_compressBound(len(src))
    dst = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(dst, cap, src, len(src), int(level)),
               "compress")
    return dst.raw[:n]


def decompress(data: bytes, size: int) -> bytes:
    """Decode zstd frames whose content is at most ``size`` bytes."""
    lib = _lib()
    src = bytes(data)
    dst = ctypes.create_string_buffer(max(int(size), 1))
    n = _check(lib, lib.ZSTD_decompress(dst, len(dst), src, len(src)),
               "decompress")
    return dst.raw[:n]
