"""The shard sum (K29): the reduction of the sharded global solves.

Port of the ``lax.psum`` of the JAX programs ``_build_relax_fn``
(``shard_map`` at ``bigstitcher_spark_tpu/ops/solve.py:428``: each sweep's
segment moments and error sums, the per-link error sums) and
``_build_cg_fn`` (``shard_map`` at :600: each matvec's data term). Each
shard computes its partial sums on its own mesh device; :func:`shard_sum`
adds them on one device, in shard order:

    out = ((p_0 + p_1) + ... + p_{S-1}) [+ rep]

every add rounded on its own, and optionally takes ``dot = out . v`` into
a one-element state slot (the CG's p.Ap) in a fixed order. On CUDA it
launches K29 (``csrc/shard.cu``) or raises; on the CPU it runs
:func:`shard_sum_plain`, which adds in the same order (bitwise the same
sum; its dot is ``torch.dot``). The relax layout puts all of a tile's rows
on one shard and keeps every tile's entry on every shard (zeros where the
shard owns none), so the shard sum of a relax partial is bitwise the
one-device segment sum.

A partial that lies on another device than ``out`` is first copied to
``out``'s device (:func:`part_pointers`): torch's peer copy, which orders
itself against both devices' current streams by CUDA events (no host
sync). On a mesh that repeats one device there is no copy. The relax's
sweeps do not launch K29: the sharded forms of K12 and K14
(``ops/solve.py``) take the moments' and error sums' partials through the
same copy and add them in K29's order as they load them.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _cuda
from .fusion import _stream

MAX_SHARDS = 64    # csrc/shard.cu kMaxShards
THREADS = 256      # K29's block
MAX_BLOCKS = 1024  # K29's grid at most


def shard_sum_blocks(n: int) -> int:
    """K29's grid for ``n`` elements: a block per 256, 1 to 1024 (a
    grid-stride loop past that); one dot partial a block."""
    return max(1, min(-(-int(n) // THREADS), MAX_BLOCKS))


def _need(t, name, dtype, numel, device, same_device=True):
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected "
                         f"{numel}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if same_device and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.device.type != device.type:
        raise ValueError(f"{name} is on {t.device}, expected a "
                         f"{device.type} device")


def check_parts(parts: Sequence[torch.Tensor], n: int,
                device: torch.device) -> None:
    """1 to 64 float64 contiguous partials of ``n`` elements each, on
    devices of ``device``'s type."""
    S = len(parts)
    if not 1 <= S <= MAX_SHARDS:
        raise ValueError(f"{S} shards: the shard sum takes 1 to {MAX_SHARDS}")
    if n == 0:
        raise ValueError("the shard sum of an empty buffer")
    for d, p in enumerate(parts):
        _need(p, f"part {d}", torch.float64, n, device, same_device=False)


def part_pointers(parts: Sequence[torch.Tensor], dev: torch.device):
    """(the partials on ``dev``, the address of a host array of their S
    device pointers): what a launcher copies into its kernel's parameters.
    A partial on another device is copied to ``dev`` first (a two-way
    event barrier between the devices' current streams, inside torch's
    peer copy). Keep the list alive until the launch is queued."""
    local = [p if p.device == dev else
             torch.empty(p.shape, dtype=p.dtype, device=dev).copy_(
                 p, non_blocking=True) for p in parts]
    ptrs = (ctypes.c_void_p * len(local))(*(p.data_ptr() for p in local))
    return local, ctypes.cast(ptrs, ctypes.c_void_p)


def _check(parts: Sequence[torch.Tensor], out: torch.Tensor, rep, v, dot,
           done, ticket) -> None:
    """K29's input contract, on any device: :func:`check_parts`; ``rep`` and
    ``v`` of ``out``'s element count on ``out``'s device; ``dot`` one
    float64 and ``done`` / ``ticket`` one int32 there; ``v`` and ``dot``
    together."""
    n = out.numel()
    check_parts(parts, n, out.device)

    def need(t, name, dtype, numel):
        _need(t, name, dtype, numel, out.device)

    need(out, "out", torch.float64, n)
    if rep is not None:
        need(rep, "rep", torch.float64, n)
    if (v is None) != (dot is None):
        raise ValueError("v and dot go together")
    if v is not None:
        need(v, "v", torch.float64, n)
        need(dot, "dot", torch.float64, 1)
    if done is not None:
        need(done, "done", torch.int32, 1)
    if ticket is not None:
        need(ticket, "ticket", torch.int32, 1)


def shard_sum_plain(parts: Sequence[torch.Tensor], out: torch.Tensor,
                    rep: torch.Tensor | None = None,
                    v: torch.Tensor | None = None,
                    dot: torch.Tensor | None = None,
                    done: torch.Tensor | None = None,
                    ticket: torch.Tensor | None = None) -> torch.Tensor:
    """K29's twin: ``out = ((p_0 + p_1) + ...) [+ rep]`` in shard order and
    ``dot = out . v`` (``torch.dot``); nothing once ``done`` is set.
    ``ticket`` is K29's and unused here."""
    _check(parts, out, rep, v, dot, done, ticket)
    if done is not None and bool(done.reshape(())):
        return out
    s = parts[0].to(out.device).reshape(out.shape).clone()
    for p in parts[1:]:
        s = s + p.to(out.device).reshape(out.shape)
    if rep is not None:
        s = s + rep.reshape(out.shape)
    out.copy_(s)
    if v is not None:
        dot.copy_(torch.dot(out.reshape(-1), v.reshape(-1)).reshape(dot.shape))
    return out


def shard_sum(parts: Sequence[torch.Tensor], out: torch.Tensor,
              rep: torch.Tensor | None = None, v: torch.Tensor | None = None,
              dot: torch.Tensor | None = None,
              done: torch.Tensor | None = None,
              ticket: torch.Tensor | None = None) -> torch.Tensor:
    """K29 (``csrc/shard.cu``) on CUDA, :func:`shard_sum_plain` on the CPU.
    ``done``: a one-element int32 flag (the solve's state) that makes the
    launch return at once when set; ``ticket``: a one-element int32 that is
    0, K29's last-block ticket for the dot (reset by the launch; allocated
    when not given). Returns ``out``."""
    if out.device.type == "cpu":
        return shard_sum_plain(parts, out, rep, v, dot, done, ticket)
    _check(parts, out, rep, v, dot, done, ticket)
    dev, n = out.device, out.numel()
    local, ptrs = part_pointers(parts, dev)
    partials = None
    if v is not None:
        partials = torch.empty(shard_sum_blocks(n), dtype=torch.float64,
                               device=dev)
        if ticket is None:
            ticket = torch.zeros(1, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _cuda.load("shard")
    ret = lib.bst_shard_sum(
        n, len(local), ptrs, ptr(rep),
        out.data_ptr(), ptr(v), ptr(dot), ptr(partials),
        0 if partials is None else int(partials.numel()), ptr(ticket),
        ptr(done), _stream(dev))
    _cuda.check(lib, ret, "shard_sum")
    shard_sum.launches += 1
    return out


shard_sum.launches = 0

KERNEL_WRAPPERS = {"shard_sum": shard_sum}
