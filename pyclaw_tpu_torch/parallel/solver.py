"""Distributed solver classes: the port's serial solvers on a mesh of
ranks.

Counterpart of ``pyclaw_tpu/parallel/solver.py`` (PetClaw's solver shims:
the subclasses swap the communication seams, not the data model).  Each
rank runs the serial step, and through it the hand kernels, on its own
block of the grid:

  - ``_ghosts``: the halo exchange (:func:`halo.extend_local`) in place
    of the serial ``bc.extend``, for q and (without the wall reflection)
    for aux;
  - ``_finalize_step``: the step's CFL maximised over the ranks, one
    ``all_reduce`` of a 0-d tensor, a NaN made +inf first;
  - ``_block_of`` / ``_pull``: every rank holds the global ``State``, as
    every JAX host runs the same program; a push copies this rank's block
    of q and aux to its device, a pull assembles the global q on every
    rank with one ``all_gather`` and marks the state with this rank's
    block (``state.q_block``, which the sharded frame format writes);
  - ``write_gauge_values``: the rank whose block holds a gauge's cell
    reads it, and one ``all_gather`` an accepted step brings the values
    to every rank (the JAX traced loop gathers them from the global
    array); rank 0 writes the gauge files (``parallel.controller``).

The overlay takes the host loop: each attempted step is a halo exchange
per stage (per sweep with ``dimensional_split``), the kernel, one
reduction and one readback.  A ``before_step`` hook gets the global
``state.q`` before each step, as in the JAX host loop: the loop pulls
(the gather), calls the hook on every rank and pushes this rank's block
back, so an edit the hook makes to q takes effect (the hook must make the
same edit on every rank).  A ``step_source`` marked ``global_grid`` (one
that closes over an array of the whole grid, as
``riemann.shallow_sphere.make_sphere_source``'s) is refused at setup:
the JAX overlay runs the step source inside its shard_map'd step
(``pyclaw_tpu/classic/solver.py:72, 85-87``,
``pyclaw_tpu/parallel/solver.py:231``), where such a hook meets a block,
so neither package takes it.  The JAX package's interior/boundary-band
overlap (``_wrap_bc_kernel``) is not ported: its Pallas backend forces
the blocking form, and the port's kernels take that backend's place.  A
block the overlay cannot take raises at setup; nothing falls back.
"""

from __future__ import annotations

from .. import classic, sharpclaw
from . import halo
from .mesh import make_mesh


class _DistributedMixin:
    """The mesh and the seams of the serial solver that the overlay
    replaces.  Custom BC callbacks (``user_bc_lower`` and the others)
    keep the serial signature and run on the ranks that own that
    physical boundary only, on the rank's extended block: a callback
    must not depend on the absolute position along a sharded axis.  This
    gives the JAX package's result, where the callback runs on every
    shard and only the boundary owners keep it."""

    distributed = True

    def __init__(self, riemann_solver=None, mesh=None, device=None):
        super().__init__(riemann_solver, device=device)
        self.mesh = mesh

    # -- the halo exchange ---------------------------------------------
    def _ghosts(self, arr, lower, upper, wall_reflects):
        return halo.extend_local(arr, self.num_ghost, lower, upper,
                                 self.mesh, wall_reflects=wall_reflects)

    def _owns_boundary(self, d, side):
        return self.mesh.owns(d, side)

    # -- the CFL reduction, and the checks of the decomposition ----------
    def _finalize_step(self, step_fn, state):
        # a source hook that closes over an array of the whole grid (the
        # sphere's latitudes) would meet a rank's block: refused, never run
        # with another answer (the JAX overlay has no such run either)
        if getattr(getattr(self, "step_source", None), "global_grid", False):
            raise NotImplementedError(
                "a step_source on the global grid under the overlay: the "
                "hook closes over an array of the whole grid and would meet "
                "this rank's block, as it would in the JAX package's "
                "overlay (ROADMAP.md, Queue 3)")
        if self.mesh is None:
            self.mesh = make_mesh(self.num_dim)
        mesh = self.mesh
        if len(mesh.shape) != self.num_dim:
            raise ValueError(f"mesh of shape {mesh.shape} for a "
                             f"{self.num_dim}-dimensional grid")
        halo.check_device(self.device)
        for d, nshards in enumerate(mesh.shape):
            cells = state.patch.num_cells_global[d]
            nm = mesh.axis_names[d]
            if cells % nshards != 0:
                raise ValueError(
                    f"num_cells[{d}]={cells} not divisible by mesh axis "
                    f"{nm}={nshards}")
            if cells // nshards < self.num_ghost:
                raise ValueError(
                    f"local block along dim {d} ({cells // nshards}) smaller "
                    f"than num_ghost={self.num_ghost}")

        def step(q, aux, dt, t, out=None):
            q_new, cfl = step_fn(q, aux, dt, t, out=out)
            return q_new, halo.reduce_max(cfl)
        return step

    # -- frames: this rank's block to its device, the global q back ------
    def _block_of(self, arr):
        return None if arr is None else arr[self.mesh.block(arr.shape[1:])]

    def _pull(self, state):
        cells = state.patch.num_cells_global
        state.q = halo.gather(self._q_dev, self.mesh, cells)
        state.q_block = (self.mesh, state.q[self.mesh.block(cells)])

    def write_gauge_values(self, state):
        cells = state.patch.grid.gauge_indices
        if not cells:
            return
        vals = halo.gather_cells(self._q_dev, self.mesh,
                                 state.patch.num_cells_global, cells)
        for num in range(len(cells)):
            state.gauge_data.append((num, state.t, vals[:, num].copy()))


class ClawSolver1D(_DistributedMixin, classic.ClawSolver1D):
    pass


class ClawSolver2D(_DistributedMixin, classic.ClawSolver2D):
    pass


class ClawSolver3D(_DistributedMixin, classic.ClawSolver3D):
    pass


class SharpClawSolver1D(_DistributedMixin, sharpclaw.SharpClawSolver1D):
    pass


class SharpClawSolver2D(_DistributedMixin, sharpclaw.SharpClawSolver2D):
    pass


class SharpClawSolver3D(_DistributedMixin, sharpclaw.SharpClawSolver3D):
    pass
