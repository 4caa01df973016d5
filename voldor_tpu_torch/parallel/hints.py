"""Mesh hooks of the hot modules (port of ``voldor_tpu/parallel/hints.py``).

This module imports nothing of the port, so the compute modules can import
it without a cycle.

The JAX package marks its hot tensors with ``shard_hint`` and lets GSPMD
partition the jitted solve. Here the partitioning is explicit: the compute
modules ask for the devices of a mesh axis (``axis_devices``), cut a tensor
into one slice per device (``split``), and bring the slices back to the
mesh's first device (``gather``). Like ``shard_hint`` (``hints.py:32-44``),
every hook is the identity unless a mesh was activated with
``active_mesh(...)`` and that mesh carries the named axis with more than
one device along it.

A mesh is any object with ``axis_names`` and ``axis_devices(axis)`` (the
devices along ``axis``, every other axis at index 0): ``parallel/mesh.py``'s
``Mesh``.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_ACTIVE: list = []


@contextmanager
def active_mesh(mesh):
    """Activate ``mesh`` for the hooks during the enclosed calls."""
    _ACTIVE.append(mesh)
    try:
        yield
    finally:
        _ACTIVE.pop()


def axis_devices(axis: str) -> list[torch.device] | None:
    """The devices along ``axis`` of the active mesh; None without an
    active mesh, when it lacks the axis, or when one device spans it."""
    if not _ACTIVE:
        return None
    mesh = _ACTIVE[-1]
    if axis not in mesh.axis_names:
        return None
    devs = mesh.axis_devices(axis)
    return devs if len(devs) > 1 else None


def bounds(n: int, parts: int) -> list[tuple[int, int]]:
    """[start, stop) of ``parts`` near-equal slices of range(n), the larger
    ones first (``torch.tensor_split``'s cut)."""
    q, r = divmod(n, parts)
    out, start = [], 0
    for i in range(parts):
        stop = start + q + (1 if i < r else 0)
        out.append((start, stop))
        start = stop
    return out


def split(x: torch.Tensor, devices, dim: int) -> list[torch.Tensor]:
    """``x`` cut along ``dim`` into one contiguous slice per device, each on
    its device. A slice that is already contiguous on its device is a view
    of ``x``, not a copy."""
    dim = dim % x.dim()
    out = []
    for dev, (a, b) in zip(devices, bounds(x.shape[dim], len(devices))):
        out.append(x.narrow(dim, a, b - a).to(dev).contiguous())
    return out


def gather(parts, dim: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Write the slices ``parts`` (as ``split`` cut them along ``dim``) into
    ``out``, on its device. A part that is a view of ``out`` at its own
    place is left where it is. Without ``out`` the slices are joined on the
    first part's device, and a single part is returned as it is."""
    if out is None:
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(parts[0].device) for p in parts], dim)
    dim = dim % out.dim()
    for part, (a, b) in zip(parts, bounds(out.shape[dim], len(parts))):
        dst = out.narrow(dim, a, b - a)
        if part.device != dst.device or part.data_ptr() != dst.data_ptr():
            dst.copy_(part)
    return out

