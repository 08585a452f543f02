"""Ghost-cell halo exchange, the CFL reduction, the frame gather and the
gauges' gather over the ranks of a mesh.

Counterpart of ``pyclaw_tpu/parallel/halo.py`` (``extend_local :54-98``)
and of the reductions in ``pyclaw_tpu/parallel/solver.py`` (``lax.pmax``
``:264-281``), a rebuild of the reference's DMDA ``globalToLocal``
BOX-stencil scatter:

  - per sharded dim, one ``dist.batch_isend_irecv``: the low face goes to
    the lower neighbour and the high face to the upper one;
  - axes one after another on the already extended array, so the corner
    ghosts that the transverse terms read come with the faces;
  - a periodic BC takes the ring's wrap; a physical BC (extrap, wall, a
    custom BC's placeholder) makes its ghosts on the rank that owns the
    boundary, from the port's serial ghost slices (``bc.py``), and no
    face crosses the wrap;
  - a mesh axis of one rank makes its ghosts locally, exactly as the
    serial ``bc.extend`` (``torch.distributed`` refuses a send to
    oneself).

The backend shows in one place, :func:`_staged`: ``gloo`` sends and
receives CPU tensors only, so under it a tensor on a card goes through
pinned host memory.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from ..bc import BC, _ghost_slices


def _backend():
    return dist.get_backend() if dist.is_initialized() else None


def check_device(device):
    """Raise unless ranks on ``device`` can talk over the process group's
    backend: NCCL moves CUDA tensors only."""
    if _backend() == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"the NCCL backend needs the ranks on CUDA cards, "
                         f"not on {device}")


def _staged(t):
    """True when ``t`` must travel through host memory: a tensor on a
    card under ``gloo``."""
    return t.is_cuda and _backend() == "gloo"


def _to_wire(t):
    """``t`` as the backend takes it: contiguous, and in pinned host
    memory when :func:`_staged`."""
    t = t.contiguous()
    if not _staged(t):
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _recv_buffer(like):
    if _staged(like):
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty_like(like, memory_format=torch.contiguous_format)


def _from_wire(t, like):
    return t.to(like.device, non_blocking=True) if _staged(like) else t


def _exchange(q, axis, g, mesh, d, periodic):
    """(from_lower, from_upper): the lower neighbour's high face and the
    upper neighbour's low face (``g`` entries along ``axis``), or None
    where this rank owns a physical boundary (no face crosses the wrap
    of a non-periodic axis)."""
    n = q.shape[axis]
    take_lo = periodic or not mesh.owns(d, 0)
    take_hi = periodic or not mesh.owns(d, 1)
    ops = []
    # the sends in the order (up, down) and the receives in the order
    # (from below, from above), so that with two ranks on a periodic
    # axis, where both neighbours are one rank, the messages pair up
    if take_hi:
        ops.append(dist.P2POp(dist.isend, _to_wire(q.narrow(axis, n - g, g)),
                              mesh.upper[d], tag=0))
    if take_lo:
        ops.append(dist.P2POp(dist.isend, _to_wire(q.narrow(axis, 0, g)),
                              mesh.lower[d], tag=1))
    face = q.narrow(axis, 0, g)
    lo = _recv_buffer(face) if take_lo else None
    hi = _recv_buffer(face) if take_hi else None
    if take_lo:
        ops.append(dist.P2POp(dist.irecv, lo, mesh.lower[d], tag=0))
    if take_hi:
        ops.append(dist.P2POp(dist.irecv, hi, mesh.upper[d], tag=1))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return ((None if lo is None else _from_wire(lo, q)),
            (None if hi is None else _from_wire(hi, q)))


def extend_local(q, num_ghost, bc_lower, bc_upper, mesh,
                 wall_reflects=True):
    """This rank's block ``q`` (num_eqn, *local_cells) with ghost cells on
    every spatial axis: the matching slice of the serial ``bc.extend`` of
    the global array."""
    g = num_ghost
    for d in range(q.ndim - 1):
        axis = 1 + d
        normal = (1 + d) if wall_reflects else None
        from_lo = from_hi = None
        if mesh.shape[d] > 1:
            from_lo, from_hi = _exchange(q, axis, g, mesh, d,
                                         bc_lower[d] == BC.periodic)
        lo = (from_lo if from_lo is not None else
              _ghost_slices(q, axis, g, bc_lower[d], 0, normal))
        hi = (from_hi if from_hi is not None else
              _ghost_slices(q, axis, g, bc_upper[d], 1, normal))
        q = torch.cat([lo, q, hi], dim=axis)
    return q


def reduce_max(cfl):
    """The step's CFL (a 0-d tensor) maximised over the ranks, as a 0-d
    tensor on its device.  A NaN becomes +inf first: ``lax.pmax`` carries
    a NaN, a backend's MAX may drop it, and a step blown up on one rank
    must be rejected on all of them."""
    c = torch.where(torch.isnan(cfl), math.inf, cfl).reshape(1)
    if not dist.is_initialized():
        return c.reshape(())
    wire = _to_wire(c)
    dist.all_reduce(wire, op=dist.ReduceOp.MAX)
    return _from_wire(wire, c).reshape(())


def gather(block, mesh, num_cells):
    """The global array (numpy, num_eqn x num_cells) of every rank's
    ``block``, on every rank: one ``all_gather``."""
    if not dist.is_initialized():
        parts = [block]
    else:
        wire = _to_wire(block)
        parts = [torch.empty_like(wire) for _ in range(mesh.size)]
        dist.all_gather(parts, wire)
    host = torch.stack(parts).cpu().numpy()
    out = np.empty((block.shape[0], *num_cells), dtype=host.dtype)
    for r in range(mesh.size):
        coords = np.unravel_index(r, mesh.shape)
        out[mesh.block(num_cells, coords)] = host[r]
    return out


def gather_cells(block, mesh, num_cells, cells):
    """q at the global cell indices ``cells`` (numpy, num_eqn x
    len(cells)) on every rank, from each rank's ``block``: the rank whose
    block holds a cell reads it, and one ``all_gather`` of each rank's
    reads (zeros where it holds no cell) brings them to every rank."""
    sizes = [n // m for n, m in zip(num_cells, mesh.shape)]
    local = torch.zeros((block.shape[0], len(cells)), dtype=block.dtype,
                        device=block.device)
    owners = []
    for j, idx in enumerate(cells):
        coords = tuple(int(i) // b for i, b in zip(idx, sizes))
        owners.append(int(np.ravel_multi_index(coords, mesh.shape)))
        if owners[-1] == mesh.rank:
            local[:, j] = block[(slice(None),) + tuple(
                int(i) - c * b for i, c, b in zip(idx, coords, sizes))]
    if not dist.is_initialized():
        parts = [local]
    else:
        wire = _to_wire(local)
        parts = [torch.empty_like(wire) for _ in range(mesh.size)]
        dist.all_gather(parts, wire)
    host = torch.stack(parts).cpu().numpy()      # (ranks, num_eqn, cells)
    return np.stack([host[r, :, j] for j, r in enumerate(owners)], axis=1)
