"""Path handling for storage roots: local paths and ``file://`` only.

The JAX package (``io/uris.py``) also reaches ``s3://``, ``gs://`` and
``memory://`` through tensorstore's kvstore drivers; the port reads and
writes the local file system with the standard library, and refuses other
schemes with :class:`~bigstitcher_spark_tpu_torch.NotYetPorted`.
"""

from __future__ import annotations

import os

from .. import NotYetPorted


def has_scheme(path: str | os.PathLike) -> bool:
    p = str(path)
    return "://" in p and not p.startswith("file://")


def strip_file_scheme(path: str | os.PathLike) -> str:
    """``file:///x`` -> ``/x``; other paths unchanged."""
    p = str(path)
    return p[len("file://"):] if p.startswith("file://") else p


def local_path(path: str | os.PathLike) -> str:
    """The local file-system path of ``path``; remote URIs raise."""
    if has_scheme(path):
        scheme = str(path).split("://", 1)[0]
        raise NotYetPorted(f"{scheme}:// storage roots")
    return strip_file_scheme(path)


def join(base: str | os.PathLike, *parts: str) -> str:
    cleaned = [p.strip("/") for p in parts if p and p.strip("/")]
    return os.path.join(local_path(base), *cleaned)


def dirname(path: str | os.PathLike) -> str:
    return os.path.dirname(local_path(path))


def normpath(path: str | os.PathLike) -> str:
    return os.path.normpath(local_path(path))
