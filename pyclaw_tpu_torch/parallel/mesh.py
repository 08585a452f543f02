"""The mesh of ranks for domain decomposition.

Counterpart of ``pyclaw_tpu/parallel/mesh.py`` (a rebuild of reference
PETSc ``DMDA.create`` topology setup): grid dimensions map onto mesh axes
named after the spatial dims ('x', 'y', 'z'), and the ranks lie on the
mesh in C order, as ``np.array(devices).reshape(shape)`` lays out the
JAX package's devices.  Each rank holds one block of the grid and talks
to the lower and upper neighbour of each axis (a ring: the last rank's
upper neighbour is the first, which a periodic BC uses).
"""

from __future__ import annotations

import math

import numpy as np

from .distributed import process_count, process_index

AXIS_NAMES = ("x", "y", "z")


def _factor(n, num_dim):
    """Split n devices into num_dim near-square factors (largest first)."""
    if num_dim == 1:
        return [n]
    best = None
    if num_dim == 2:
        for a in range(1, n + 1):
            if n % a == 0:
                b = n // a
                score = abs(a - b)
                if best is None or score < best[0]:
                    best = (score, [a, b])
        return best[1]
    # 3D: greedy cube-ish factorization
    a = round(n ** (1 / 3))
    while a > 1 and n % a != 0:
        a -= 1
    rest = _factor(n // a, 2)
    return sorted([a] + rest, reverse=True)


class Mesh:
    """``shape`` ranks on the axes ``axis_names``; this rank's ``coords``,
    and per axis its ``lower`` and ``upper`` ring neighbours (ranks)."""

    def __init__(self, shape, rank):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = AXIS_NAMES[:len(self.shape)]
        self.size = math.prod(self.shape)
        self.rank = int(rank)
        self.coords = tuple(int(c) for c in
                            np.unravel_index(self.rank, self.shape))
        self.lower = tuple(self._neighbour(d, -1)
                           for d in range(len(self.shape)))
        self.upper = tuple(self._neighbour(d, 1)
                           for d in range(len(self.shape)))

    def _neighbour(self, d, step):
        c = list(self.coords)
        c[d] = (c[d] + step) % self.shape[d]
        return int(np.ravel_multi_index(tuple(c), self.shape))

    def owns(self, d, side):
        """True when this rank holds the physical boundary ``side`` (0
        lower, 1 upper) of axis ``d``."""
        return self.coords[d] == (0 if side == 0 else self.shape[d] - 1)

    def block(self, num_cells, coords=None):
        """The index of the block of the rank at ``coords`` (this one by
        default) in an array (num_eqn, *num_cells)."""
        coords = self.coords if coords is None else coords
        sl = [slice(None)]
        for c, n, m in zip(coords, num_cells, self.shape):
            b = n // m
            sl.append(slice(c * b, (c + 1) * b))
        return tuple(sl)


def make_mesh(num_dim, mesh_shape=None, world_size=None):
    """The mesh of ``world_size`` ranks (default: the process group's) for
    a ``num_dim``-dimensional grid, near-square by default."""
    n = process_count() if world_size is None else int(world_size)
    if mesh_shape is None:
        mesh_shape = _factor(n, num_dim)
    if math.prod(mesh_shape) != n:
        raise ValueError(f"mesh_shape {mesh_shape} != {n} devices")
    if len(mesh_shape) != num_dim:
        raise ValueError("mesh_shape length must equal num_dim")
    return Mesh(mesh_shape, process_index())
