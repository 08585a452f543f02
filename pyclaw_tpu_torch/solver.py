"""Solver base: time stepping, BC policy, CFL accept/reject.

Counterpart of ``pyclaw_tpu/solver.py`` (``BC``, ``Solver``: settings,
BC sizing and extension, the evolve loop), a rebuild of reference
``src/pyclaw/solver.py — class Solver``.

``evolve_to_time`` follows the arithmetic of the JAX package's traced
loop (``solver.py:302-341``): ``dt_try = min(dt, tend - t)``; accept when
the CFL is finite and <= ``cfl_max``; next dt ``min(dt_max,
dt_try*cfl_desired/cfl)``, or ``dt_try*0.5`` when the CFL is not finite
or not positive.  Time bookkeeping stays in float64 and the step gets dt
in q's dtype.  Here the loop runs on the host with one CFL readback per
step; q stays on the device between steps.
"""

from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from .bc import BC, extend
from .cfl import CFL
from .config import resolve_device, torch_dtype

logger = logging.getLogger("pyclaw.solver")

__all__ = ["BC", "Solver"]


def _not_ported(what):
    """The error an option of the JAX package that the port does not take
    yet raises at setup; ``what`` names its ROADMAP.md item."""
    return NotImplementedError(
        f"{what} is not ported to pyclaw_tpu_torch yet (ROADMAP.md, "
        f"Queue 1: '{what}')")


class Solver:
    def __init__(self, riemann_solver=None, device=None):
        self.device = resolve_device(device)
        self.dt_initial = 0.1
        self.dt_variable = True
        self.dt_max = 1e99
        self.dt = self.dt_initial
        self.max_steps = 10000
        self.cfl_max = 1.0
        self.cfl_desired = 0.9
        self.num_ghost = 2
        self.fwave = False
        self.before_step = None
        self.rp = riemann_solver
        self.cfl = CFL()
        self.status = {"cflmax": 0.0, "dtmin": float("inf"),
                       "dtmax": 0.0, "numsteps": 0, "numrejected": 0,
                       "wall_time": 0.0, "cell_updates": 0,
                       "cell_updates_per_sec": 0.0}
        self.verbosity = 0
        self.logger = logger

        # per-dimension BC settings; sized at setup from the domain
        self.bc_lower = []
        self.bc_upper = []
        self.aux_bc_lower = []
        self.aux_bc_upper = []
        self.user_bc_lower = None
        self.user_bc_upper = None
        self.user_aux_bc_lower = None
        self.user_aux_bc_upper = None

        self._is_set_up = False
        self._q_dev = None
        self._aux_dev = None
        self._step_fn = None

    # -- all_bcs sugar (reference solver.py — all_bcs property) --------
    @property
    def all_bcs(self):
        return self.bc_lower, self.bc_upper

    @all_bcs.setter
    def all_bcs(self, bc_kind):
        n = len(self.bc_lower) or getattr(self, "num_dim", 1)
        self.bc_lower = [bc_kind] * n
        self.bc_upper = [bc_kind] * n

    @staticmethod
    def _weak_params(problem_data):
        """problem_data with numpy scalars turned into Python numbers, so
        an np.float64 constant never promotes a float32 run."""
        return {k: (v.item() if isinstance(v, np.generic) else v)
                for k, v in problem_data.items()}

    def _size_bc_lists(self, num_dim):
        for name in ("bc_lower", "bc_upper"):
            lst = getattr(self, name)
            if not lst:
                setattr(self, name, [BC.extrap] * num_dim)
            elif len(lst) != num_dim:
                if len(lst) == 1:
                    setattr(self, name, lst * num_dim)
                else:
                    raise ValueError(f"{name} has wrong length")
        for name in ("aux_bc_lower", "aux_bc_upper"):
            lst = getattr(self, name)
            if not lst:
                setattr(self, name, [BC.extrap] * num_dim)
            elif len(lst) == 1 and num_dim > 1:
                setattr(self, name, lst * num_dim)
        for d in range(num_dim):
            lo, up = self.bc_lower[d], self.bc_upper[d]
            if (lo == BC.periodic) != (up == BC.periodic):
                raise ValueError(
                    f"dimension {d}: periodic BCs must be set on both sides")

    # ------------------------------------------------------------------
    def setup(self, solution):
        """Subclasses build their step function here."""
        raise NotImplementedError

    # aux arrays and a capacity function: only the solvers that set this
    # take them (ClawSolver1D, ClawSolver2D, ClawSolver3D,
    # SharpClawSolver1D); the others raise under their ROADMAP items
    takes_aux = False

    def _check_setup(self, state):
        """The checks of every solver's setup: the Riemann solver fits the
        state, and no option that the port does not take yet is set."""
        if self.rp is None:
            raise ValueError("no Riemann solver attached")
        if state.num_eqn != self.rp.num_eqn:
            raise ValueError(
                f"State.num_eqn={state.num_eqn} but Riemann solver "
                f"{self.rp.name} has num_eqn={self.rp.num_eqn}")
        for key in self.rp.requires:
            if key not in state.problem_data:
                raise ValueError(f"problem_data missing '{key}' required by "
                                 f"{self.rp.name}")
        if self.before_step is not None:
            raise _not_ported("before_step")
        if state.patch.grid.gauge_indices:
            raise _not_ported("gauges")
        if state.aux is not None and not self.takes_aux:
            raise _not_ported("aux")
        if state.index_capa >= 0:
            if not self.takes_aux:
                raise _not_ported("capacity")
            if state.aux is None or state.index_capa >= state.aux.shape[0]:
                raise ValueError(f"index_capa={state.index_capa} names no "
                                 "row of state.aux")

    def _extend_bc(self, q, aux, t, state):
        """Ghost-cell extension + custom-BC callbacks: (qbc, auxbc).  aux
        is extended on every step, without the wall reflection, as in the
        JAX package (``pyclaw_tpu/solver.py:_extend_bc``)."""
        g = self.num_ghost
        qbc = extend(q, g, self.bc_lower, self.bc_upper, wall_reflects=True)
        auxbc = None
        if aux is not None:
            auxbc = extend(aux, g, self.aux_bc_lower, self.aux_bc_upper,
                           wall_reflects=False)
            for d in range(self.num_dim):
                if (self.aux_bc_lower[d] == BC.custom
                        and self.user_aux_bc_lower is not None):
                    auxbc = self.user_aux_bc_lower(state, d, t, qbc, auxbc, g)
            for d in range(self.num_dim):
                if (self.aux_bc_upper[d] == BC.custom
                        and self.user_aux_bc_upper is not None):
                    auxbc = self.user_aux_bc_upper(state, d, t, qbc, auxbc, g)
        for d in range(self.num_dim):
            if self.bc_lower[d] == BC.custom:
                if self.user_bc_lower is None:
                    raise ValueError("bc_lower is custom but user_bc_lower "
                                     "is not set")
                qbc = self.user_bc_lower(state, d, t, qbc, auxbc, g)
            if self.bc_upper[d] == BC.custom:
                if self.user_bc_upper is None:
                    raise ValueError("bc_upper is custom but user_bc_upper "
                                     "is not set")
                qbc = self.user_bc_upper(state, d, t, qbc, auxbc, g)
        return qbc, auxbc

    def step(self, solution):
        """One step of self.dt on the device state; sets the cached CFL."""
        state = solution.states[0]
        q, cfl = self._step_fn(self._q_dev, self._aux_dev, self.dt, state.t)
        self._q_dev = q
        self.cfl.update_global_max(float(cfl))

    # ------------------------------------------------------------------
    def _push(self, state):
        """q and aux to the device, once per evolve_to_time; aux stays
        there for every step of it."""
        self._q_dev = torch.as_tensor(
            np.ascontiguousarray(state.q),
            dtype=torch_dtype(state.q.dtype)).to(self.device)
        self._aux_dev = None if state.aux is None else torch.as_tensor(
            np.ascontiguousarray(state.aux),
            dtype=torch_dtype(state.q.dtype)).to(self.device)

    def _pull(self, state):
        state.q = self._q_dev.cpu().numpy().copy()

    def accept_reject_step(self, cfl):
        if self.dt_variable and not math.isfinite(cfl):
            return False  # NaN/inf CFL (blown-up trial step): always reject
        return (not self.dt_variable) or cfl <= self.cfl_max

    def evolve_to_time(self, solution, tend=None):
        """Advance to tend (or by one accepted step when tend is None),
        timing the loop for the cell-updates/s counter."""
        ns0 = self.status["numsteps"]
        t_wall = time.perf_counter()
        try:
            return self._evolve_to_time(solution, tend)
        finally:
            elapsed = time.perf_counter() - t_wall
            cells = 1
            for n in solution.states[0].q.shape[1:]:
                cells *= int(n)
            self.status["wall_time"] += elapsed
            self.status["cell_updates"] += \
                (self.status["numsteps"] - ns0) * cells
            if self.status["wall_time"] > 0.0:
                self.status["cell_updates_per_sec"] = (
                    self.status["cell_updates"] / self.status["wall_time"])

    def _evolve_to_time(self, solution, tend=None):
        state = solution.states[0]
        if not self._is_set_up:
            self.setup(solution)
        take_one_step = tend is None
        if not self.dt_variable and not take_one_step:
            n = (tend - state.t) / self.dt
            if abs(n - round(n)) > 1e-6:
                raise ValueError(
                    "With dt_variable=False, tend-tstart must be an "
                    "integer multiple of dt")

        self._push(state)
        q = self._q_dev
        kdtype = state.q.dtype.type      # dt as the kernel sees it
        t = float(state.t)
        dt = float(self.dt)
        ns = nr = 0
        cm, dmin, dmax = 0.0, float("inf"), 0.0

        def more():
            if ns + nr >= self.max_steps:
                return False
            return ns == 0 if take_one_step else t < tend - 1e-12

        while more():
            dt_try = dt if take_one_step else min(dt, tend - t)
            q_new, cfl_t = self._step_fn(q, self._aux_dev,
                                         float(kdtype(dt_try)),
                                         float(kdtype(t)))
            cfl = float(cfl_t)           # the one host readback per step
            ok = self.accept_reject_step(cfl)
            if ok:
                q = q_new
                t = t + dt_try
                ns += 1
                cm = max(cm, cfl)
                dmin = min(dmin, dt_try)
                dmax = max(dmax, dt_try)
                if self.verbosity >= 3:
                    logger.info("step %d: t=%g dt=%g cfl=%g",
                                self.status["numsteps"] + ns, t, dt_try, cfl)
            else:
                nr += 1
                if self.verbosity >= 2:
                    logger.info("rejecting step: cfl=%g > %g", cfl,
                                self.cfl_max)
            if self.dt_variable:
                if math.isfinite(cfl) and cfl > 0.0:
                    dt = min(self.dt_max, dt_try * self.cfl_desired / cfl)
                else:
                    dt = dt_try * 0.5

        self._q_dev = q
        if (ns == 0) if take_one_step else (t < tend - 1e-12):
            raise Exception(
                f"Unable to reach tend={tend} within {self.max_steps} "
                f"steps (t={t}, accepted={ns}, rejected={nr})")
        state.t = t if take_one_step else tend
        self.dt = dt
        self.cfl.update_global_max(cm)
        self.status["numsteps"] += ns
        self.status["numrejected"] += nr
        self.status["cflmax"] = max(self.status["cflmax"], cm)
        if ns > 0:
            self.status["dtmin"] = min(self.status["dtmin"], dmin)
            self.status["dtmax"] = max(self.status["dtmax"], dmax)
        self._pull(state)
        return self.status
