"""Boundary conditions: functional ghost-cell extension.

Counterpart of ``pyclaw_tpu/bc.py:extend`` (a rebuild of reference
``src/pyclaw/solver.py — BC enum + Solver._apply_bcs``).  ``extend()``
concatenates ghost slices onto ``q`` one dimension at a time (x, then y,
then z), so corner ghosts are consistent.  The result equals the JAX
package's bit for bit (tests/test_torch_bc.py).

BC kinds (same numeric ids as the reference):
  custom=0   user callback fills the ghost band
  extrap=1   zero-order extrapolation (edge replication)
  periodic=2 wrap-around
  wall=3     solid wall: mirror cells and negate the normal-momentum
             component (component ``1+idim`` by convention)

Custom callbacks have the signature
``fn(state, dim_index, t, qbc, auxbc, num_ghost) -> qbc``.

The JAX package's ``extend_aligned`` is not ported: it exists only to
meet Mosaic's DMA alignment on the TPU.
"""

from __future__ import annotations

import torch


class BC:
    """Boundary-condition ids (reference solver.py — class BC)."""
    custom = 0
    extrap = 1
    periodic = 2
    wall = 3


def _ghost_slices(q, axis, num_ghost, kind, side, normal_comp):
    """Ghost band (``num_ghost`` entries along ``axis``) for one side
    (0 = lower, 1 = upper) of one axis.  ``normal_comp`` is the
    q-component negated at a wall (None for aux arrays)."""
    g = num_ghost
    n = q.shape[axis]
    if kind == BC.periodic:
        return q.narrow(axis, n - g, g) if side == 0 else q.narrow(axis, 0, g)
    if kind in (BC.extrap, BC.custom):
        # custom: placeholder (edge replication); the user callback
        # overwrites the band afterwards.
        edge = q.narrow(axis, 0, 1) if side == 0 else q.narrow(axis, n - 1, 1)
        reps = [1] * q.ndim
        reps[axis] = g
        return edge.repeat(*reps)
    if kind == BC.wall:
        band = q.narrow(axis, 0, g) if side == 0 else q.narrow(axis, n - g, g)
        band = torch.flip(band, dims=(axis,))
        if normal_comp is not None and q.shape[0] > normal_comp:
            sign = torch.ones((q.shape[0],) + (1,) * (q.ndim - 1),
                              dtype=q.dtype, device=q.device)
            sign[normal_comp] = -1.0
            band = band * sign
        return band
    raise ValueError(f"unknown BC kind {kind}")


def extend(q, num_ghost, bc_lower, bc_upper, wall_reflects=True):
    """Extend q with ghost cells on every spatial axis.

    q: (num_eqn|num_aux, *cells) tensor.  bc_lower/bc_upper: per-dimension
    BC ids.  wall_reflects: negate normal momentum (True for q, False for
    aux).  Returns qbc with every spatial axis grown by 2*num_ghost."""
    num_dim = q.ndim - 1
    for d in range(num_dim):
        axis = 1 + d
        normal = (1 + d) if wall_reflects else None
        lo = _ghost_slices(q, axis, num_ghost, bc_lower[d], 0, normal)
        hi = _ghost_slices(q, axis, num_ghost, bc_upper[d], 1, normal)
        q = torch.cat([lo, q, hi], dim=axis)
    return q
