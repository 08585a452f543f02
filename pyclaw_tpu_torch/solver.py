"""Solver base: time stepping, BC policy, CFL accept/reject.

Counterpart of ``pyclaw_tpu/solver.py`` (``BC``, ``Solver``: settings,
BC sizing and extension, the evolve loop), a rebuild of reference
``src/pyclaw/solver.py — class Solver``.

The device loop follows the arithmetic of the JAX package's traced loop
(``solver.py:302-341``): ``dt_try = min(dt, tend - t)``; accept when the
CFL is finite and <= ``cfl_max``; next dt ``min(dt_max,
dt_try*cfl_desired/cfl)``, or ``dt_try*0.5`` when the CFL is not finite
or not positive.  One-step calls, ``before_step`` runs and the
host-sequenced solvers (``_host_sequenced``: SharpClaw's multistep
integrators) follow the JAX package's host loop (``solver.py:458-503``),
which those calls take there too and which differs where a clipped step
is rejected: the step is clipped when ``t + dt > tend - 1e-14``, a
rejected step's next dt comes from the dt before the clip, a zero CFL
keeps dt, and the loop ends at ``t >= tend - 1e-14``; an attempted step
(:meth:`Solver._attempt`) may take a smaller dt than it was given, which
the loop reads back.  ``traced_evolve = False`` keeps the traced loop's
rule, where the JAX package takes its host loop's: in the port it is the
host replay of the device loop, held to it bit for bit
(``tests/test_torch_evolve.py::test_host_loop_equals_device_loop``,
``chip_smoke.py`` [4h]), and the overlay's host loop keeps it as the JAX
overlay's traced loop.  Time bookkeeping stays in float64 and the step gets dt
in q's dtype.  It dispatches as the JAX package's ``_evolve_to_time``
(``:434-505``): with ``tend`` given and no ``before_step``, the device
loop (:class:`_DeviceLoop`, the counterpart of ``_make_evolve_fn`` and
``_evolve_traced``: a CUDA-graph replay of one attempted step, one host
readback per batch of steps); one-step calls, ``before_step``, the
host-sequenced solvers and ``traced_evolve = False`` take the host loop,
with one CFL readback per attempted step.  q stays on the device between steps; frames move
through pinned host memory (``_push``/``_pull``).
"""

from __future__ import annotations

import gc
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
        # the device loop's counters over this solver's calls (see
        # _DeviceLoop): output frames, host readbacks, attempted steps
        # (eager or replayed), attempts after the loop's end, captures,
        # and the host seconds of the eager warm-up attempts and of the
        # captures
        self.loop_stats = {"frames": 0, "readbacks": 0, "attempts": 0,
                           "after_end": 0, "captures": 0, "warmup_s": 0.0,
                           "capture_s": 0.0}

        # per-dimension BC settings; sized at setup from the domain
        self.bc_lower = []
        self.bc_upper = []
        self.aux_bc_lower = []
        self.aux_bc_upper = []
        self.user_bc_lower = None
        self.user_bc_upper = None
        self.user_aux_bc_lower = None
        self.user_aux_bc_upper = None

        # device gauge-series buffer length per evolve call (see
        # _make_evolve_fn); raise it for runs with >2048 steps per
        # output frame that need every gauge sample
        self.gauge_buffer_len = 2048

        self._is_set_up = False
        self._q_dev = None
        self._aux_dev = None
        self._q_host = None     # (ndarray, pinned tensor) of the last pull
        self._aux_stage = None  # pinned copy of the caller's aux (CUDA)
        self._aux_copied = None  # event: the last copy from it has ended
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

    def _check_setup(self, state):
        """The checks of every solver's setup: the Riemann solver fits the
        state, and a capacity function names a row of aux."""
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
        if state.index_capa >= 0 and (state.aux is None or
                                      state.index_capa >= state.aux.shape[0]):
            raise ValueError(f"index_capa={state.index_capa} names no row "
                             "of state.aux")

    # a solver whose steps keep a history on the host (SharpClaw's
    # multistep integrators) takes the host loop with the JAX host
    # loop's dt rule
    _host_sequenced = False

    # the parallel overlay (pyclaw_tpu_torch/parallel) runs this solver's
    # step on each rank's block: it sets this (the overlay takes the host
    # loop) and replaces the three hooks below, _finalize_step (the CFL
    # reduction) and _pull (the gather)
    distributed = False

    def _ghosts(self, arr, lower, upper, wall_reflects):
        """``arr`` with its ghost cells on every spatial axis: the serial
        ``bc.extend``; the overlay's halo exchange takes its place."""
        return extend(arr, self.num_ghost, lower, upper,
                      wall_reflects=wall_reflects)

    def _block_of(self, arr):
        """This process's block of a global array (num_eqn|num_aux, *cells)
        of the state, or None for None: all of it in serial."""
        return arr

    def _owns_boundary(self, d, side):
        """True when this process holds the physical boundary ``side`` (0
        lower, 1 upper) of dimension ``d``, where a custom BC callback
        runs: always in serial."""
        return True

    def _extend_bc(self, q, aux, t, state):
        """Ghost-cell extension + custom-BC callbacks: (qbc, auxbc).  aux
        is extended on every step, without the wall reflection, as in the
        JAX package (``pyclaw_tpu/solver.py:_extend_bc``)."""
        g = self.num_ghost
        qbc = self._ghosts(q, self.bc_lower, self.bc_upper, True)
        auxbc = None
        if aux is not None:
            auxbc = self._ghosts(aux, self.aux_bc_lower, self.aux_bc_upper,
                                 False)
            for d in range(self.num_dim):
                if (self.aux_bc_lower[d] == BC.custom
                        and self.user_aux_bc_lower is not None
                        and self._owns_boundary(d, 0)):
                    auxbc = self.user_aux_bc_lower(state, d, t, qbc, auxbc, g)
            for d in range(self.num_dim):
                if (self.aux_bc_upper[d] == BC.custom
                        and self.user_aux_bc_upper is not None
                        and self._owns_boundary(d, 1)):
                    auxbc = self.user_aux_bc_upper(state, d, t, qbc, auxbc, g)
        for d in range(self.num_dim):
            if self.bc_lower[d] == BC.custom:
                if self.user_bc_lower is None:
                    raise ValueError("bc_lower is custom but user_bc_lower "
                                     "is not set")
                if self._owns_boundary(d, 0):
                    qbc = self.user_bc_lower(state, d, t, qbc, auxbc, g)
            if self.bc_upper[d] == BC.custom:
                if self.user_bc_upper is None:
                    raise ValueError("bc_upper is custom but user_bc_upper "
                                     "is not set")
                if self._owns_boundary(d, 1):
                    qbc = self.user_bc_upper(state, d, t, qbc, auxbc, g)
        return qbc, auxbc

    def _finalize_step(self, step_fn, state):
        """The step function the solver runs, from the one its setup
        built: ``step_fn`` itself in serial; the overlay adds the CFL
        reduction over its ranks."""
        return step_fn

    def _attempt(self, q, dt, t, kdtype):
        """One attempted step of the host loop from q at t with dt (dt and
        t handed to the step in q's dtype ``kdtype``): (q_new, cfl as a
        float, the dt the step took)."""
        q_new, cfl = self._step_fn(q, self._aux_dev, float(kdtype(dt)),
                                   float(kdtype(t)))
        return q_new, float(cfl), dt

    def step(self, solution):
        """One step of self.dt on the device state; sets the cached CFL."""
        state = solution.states[0]
        q, cfl = self._step_fn(self._q_dev, self._aux_dev, self.dt, state.t)
        self._q_dev = q
        self.cfl.update_global_max(float(cfl))

    # -- frames: q and aux to and from the device -----------------------
    def _host_buffer(self, shape, dtype):
        """A host tensor for a frame copy: pinned with a CUDA device (the
        caching host allocator recycles its blocks), else plain."""
        return torch.empty(shape, dtype=dtype,
                           pin_memory=self.device.type == "cuda")

    def _to_device(self, src, dev, non_blocking=False):
        """Host tensor ``src`` into ``dev``, which is reused when it has
        src's shape and dtype (so the device loop's buffers keep their
        addresses)."""
        if (dev is None or dev.shape != src.shape or dev.dtype != src.dtype
                or dev.device != self.device):
            dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        dev.copy_(src, non_blocking=non_blocking)
        return dev

    def _push(self, state):
        """q and aux to the device, once per evolve_to_time; aux stays
        there for every step of it.  Whatever the host wrote into either,
        in place or by replacing the array, reaches the device: q that is
        still the array of the last pull copies asynchronously from its
        pinned memory, any other q through pageable memory; with a CUDA
        device the caller's aux is copied into a pinned buffer the solver
        owns and from there asynchronously (state.aux stays the caller's
        array)."""
        dtype = torch_dtype(state.q.dtype)
        q, aux = self._block_of(state.q), self._block_of(state.aux)
        held = self._q_host
        if held is not None and q is held[0]:
            self._q_dev = self._to_device(held[1], self._q_dev, True)
        else:
            self._q_dev = self._to_device(torch.as_tensor(
                np.ascontiguousarray(q), dtype=dtype), self._q_dev)
        if aux is None:
            self._aux_dev = None
            return
        if self.device.type != "cuda":
            self._aux_dev = self._to_device(torch.as_tensor(
                np.ascontiguousarray(aux), dtype=dtype), self._aux_dev)
            return
        stage = self._aux_stage
        if (stage is None or tuple(stage.shape) != aux.shape
                or stage.dtype != dtype):
            stage = self._aux_stage = self._host_buffer(aux.shape, dtype)
        elif self._aux_copied is not None:
            self._aux_copied.synchronize()
        stage.numpy()[...] = aux
        self._aux_dev = self._to_device(stage, self._aux_dev, True)
        self._aux_copied = torch.cuda.Event()
        self._aux_copied.record(torch.cuda.current_stream(self.device))

    def _pull(self, state):
        """q from the device into a new host array (pinned with a CUDA
        device): one copy, and the next push copies from it again."""
        q = self._q_dev
        host = self._host_buffer(q.shape, q.dtype)
        host.copy_(q, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self._q_host = (host.numpy(), host)
        state.q = self._q_host[0]

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

    # -- the device loop --------------------------------------------------
    def _make_evolve_fn(self, state=None):
        """The device loop of this solver's step (:class:`_DeviceLoop`),
        the counterpart of the JAX package's ``_make_evolve_fn``
        (``pyclaw_tpu/solver.py:267-362``): the whole accept/reject loop
        on the device, one host readback per batch of attempted steps.

        Semantics match the JAX package's traced loop, corner included:
        when a final clipped step (dt -> tend-t) is rejected, the next dt
        is derived from the clipped value (the host loop derives it from
        the dt before the clip, as the JAX package's host loop does)."""
        return _DeviceLoop(self, state, self._q_dev, self._aux_dev)

    def _can_use_traced_evolve(self, state):
        return (not self.distributed and self.before_step is None
                and getattr(self, "traced_evolve", True))

    def _evolve_traced(self, solution, tend):
        state = solution.states[0]
        loop = getattr(self, "_evolve_fn", None)
        if loop is None or not loop.fits(self, state):
            loop = self._evolve_fn = self._make_evolve_fn(state)
        t, dt, ns, nr, cm, dmin, dmax_ = loop.run(self._q_dev, state.t,
                                                   self.dt, tend)
        self._q_dev = loop.current()
        if t < tend - 1e-12:
            raise Exception(
                f"Unable to reach tend={tend} within {self.max_steps} "
                f"steps (t={t}, accepted={ns}, rejected={nr})")
        state.t = tend
        self.dt = dt
        if state.patch.grid.gauge_indices and ns > 0:
            n_rec = ns
            nbuf = loop.gauge_len
            if n_rec > nbuf:
                logger.warning(
                    "gauge buffer overflow: %d accepted steps > "
                    "gauge_buffer_len=%d; later samples dropped — raise "
                    "solver.gauge_buffer_len", n_rec, nbuf)
                n_rec = nbuf
            # copies: the loop's buffers take the next frame's samples
            gt_h = loop.gt[:n_rec].cpu().numpy().copy()
            gq_h = loop.gq[:n_rec].cpu().numpy().copy()  # (n_rec, m, ng)
            for i in range(n_rec):
                for num in range(gq_h.shape[2]):
                    state.gauge_data.append((num, float(gt_h[i]),
                                             gq_h[i, :, num]))
        self.cfl.update_global_max(cm)
        self.status["numsteps"] += ns
        self.status["numrejected"] += nr
        self.status["cflmax"] = max(self.status["cflmax"], cm)
        if ns > 0:
            self.status["dtmin"] = min(self.status["dtmin"], dmin)
            self.status["dtmax"] = max(self.status["dtmax"], dmax_)
        return self.status

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

        if not take_one_step and self._can_use_traced_evolve(state):
            status = self._evolve_traced(solution, tend)
            self._pull(state)
            return status

        # the host loop: one-step calls, before_step, traced_evolve=False,
        # the host-sequenced solvers and the overlay; one CFL readback per
        # attempted step.  The dt rule of the JAX host loop for one-step
        # calls, before_step and the host-sequenced solvers (the calls that
        # take that loop in both packages), the traced loop's otherwise
        # (the module's docstring says why)
        jax_host = (take_one_step or self.before_step is not None
                    or self._host_sequenced)
        end_tol = 1e-14 if jax_host else 1e-12
        q = self._q_dev
        kdtype = state.q.dtype.type      # dt as the kernel sees it
        t = float(state.t)
        dt = float(self.dt)
        ns = nr = 0
        cm, dmin, dmax = 0.0, float("inf"), 0.0

        def more():
            if ns + nr >= self.max_steps:
                return False
            return ns == 0 if take_one_step else t < tend - end_tol

        while more():
            if self.before_step is not None:
                # the hook may change the host q: round-trip it
                self._q_dev = q
                state.t = t
                self._pull(state)
                self.before_step(self, state)
                self._push(state)
                q = self._q_dev
            if take_one_step:
                dt_try = dt
            elif jax_host:
                dt_try = tend - t if t + dt > tend - 1e-14 else dt
            else:
                dt_try = min(dt, tend - t)
            # the one host readback per step; the dt the step took
            q_new, cfl, dt_try = self._attempt(q, dt_try, t, kdtype)
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
                if state.patch.grid.gauge_indices:
                    self._q_dev = q
                    state.t = t
                    self.write_gauge_values(state)
            else:
                nr += 1
                if self.verbosity >= 2:
                    logger.info("rejecting step: cfl=%g > %g", cfl,
                                self.cfl_max)
            if self.dt_variable:
                base = dt if jax_host and not ok else dt_try
                if math.isfinite(cfl) and cfl > 0.0:
                    dt = min(self.dt_max, base * self.cfl_desired / cfl)
                elif jax_host and math.isfinite(cfl):
                    dt = base
                else:
                    dt = base * 0.5

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

    # -- gauges (reference solver.py — write_gauge_values) --------------
    def write_gauge_values(self, state):
        grid = state.patch.grid
        if not grid.gauge_indices:
            return
        q = self._q_dev
        for num, idx in enumerate(grid.gauge_indices):
            vals = q[(slice(None),) + tuple(idx)].cpu().numpy().copy()
            state.gauge_data.append((num, state.t, vals))


class _DeviceLoop:
    """The JAX package's ``lax.while_loop`` of attempted steps
    (``pyclaw_tpu/solver.py:302-360``) on device tensors.

    The loop state lives on the device: two q buffers, t, dt, tend, the
    accepted and rejected counts ns and nr, the CFL maximum cm, dmin, dmax
    and, with gauges, the gauge buffers gt (gauge_len + 1,) and gq
    (gauge_len + 1, num_eqn, num_gauges), whose last slot takes what the
    JAX loop's ``mode="drop"`` drops.  :meth:`attempt` performs one
    attempted step: the JAX loop's ``body`` with every update masked by its
    ``cond`` (t < tend - 1e-12 and ns + nr < max_steps), so an attempt
    after the loop's end changes nothing.  It reads q from one buffer and
    the step writes the other; a rejected step copies its input over its
    output (``ops.restore``), so an accepted step costs no copy of q.

    On a CUDA device the first attempt runs eagerly (the warm-up), then
    the two attempts (buffer 0 -> 1 and 1 -> 0) are captured as two CUDA
    graphs sharing one memory pool.  The host replays them in turns N
    times, reads (t, dt, ns, nr, cm, dmin, dmax) back in one small copy,
    and repeats until the loop has ended.  N (:meth:`_batch`) is the
    number of attempts that reach tend without passing it when dt grows
    by each attempt as it grew over the last batch, at least 1 and at
    most the attempts max_steps leaves: the last, clipped step takes a
    batch of its own rather than a whole step replayed after the end.  A
    capture or replay that fails raises.  On the CPU the same attempt runs
    eagerly N times.  The wrappers count the launches they make or
    capture; a replay runs on the device alone and counts nothing.

    It counts into the solver's ``loop_stats``: frames, readbacks,
    attempts (eager or replayed), attempts after the end (those whose cond
    was false), captures, and the seconds of the warm-ups and captures."""

    def __init__(self, solver, state, q_dev, aux_dev):
        self.key = self._key(solver, state, q_dev, aux_dev)
        self.step = solver._step_fn
        self.cfl_max = solver.cfl_max
        self.cfl_desired = solver.cfl_desired
        self.dt_max = solver.dt_max
        self.dt_variable = solver.dt_variable
        self.max_steps = solver.max_steps
        dev = q_dev.device
        self.cuda = dev.type == "cuda"
        self.q = [torch.empty_like(q_dev), torch.empty_like(q_dev)]
        self.cur = 0
        self.aux = aux_dev
        f64 = torch.float64

        def scalar(dtype=f64):
            return torch.zeros((), dtype=dtype, device=dev)
        self.t, self.dt, self.tend = scalar(), scalar(), scalar()
        self.cm, self.dmin, self.dmax = scalar(), scalar(), scalar()
        self.ns, self.nr = scalar(torch.int64), scalar(torch.int64)
        self.gauge_len = 0
        self.gidx = None
        self.gt = self.gq = None
        gauges = state.patch.grid.gauge_indices if state is not None else []
        if gauges:
            gidx = np.asarray(gauges)                    # (ng, ndim)
            self.gidx = (slice(None),) + tuple(
                torch.as_tensor(gidx[:, d], device=dev)
                for d in range(gidx.shape[1]))
            self.gauge_len = min(self.max_steps, solver.gauge_buffer_len)
            self.gt = torch.zeros((self.gauge_len + 1,), dtype=f64,
                                  device=dev)
            self.gq = torch.zeros((self.gauge_len + 1, q_dev.shape[0],
                                   len(gauges)), dtype=q_dev.dtype,
                                  device=dev)
        self.graphs = None
        self.growth = None    # dt's factor an attempt over the last batch
        self.host = (torch.empty((7,), dtype=f64, pin_memory=True)
                     if self.cuda else None)
        self.stats = solver.loop_stats

    @staticmethod
    def _key(solver, state, q_dev, aux_dev):
        gauges = state.patch.grid.gauge_indices if state is not None else []
        return (q_dev.device, tuple(q_dev.shape), q_dev.dtype,
                id(aux_dev), id(solver._step_fn), solver.cfl_max,
                solver.cfl_desired, solver.dt_max, solver.dt_variable,
                solver.max_steps, solver.gauge_buffer_len,
                tuple(tuple(int(i) for i in g) for g in gauges))

    def fits(self, solver, state):
        """True when this loop serves the solver's step, state and
        settings as they are now (else the solver builds another)."""
        return self.key == self._key(solver, state, solver._q_dev,
                                     solver._aux_dev)

    def current(self):
        return self.q[self.cur]

    # -- one attempted step: the JAX loop's body, masked by its cond ----
    def attempt(self, src, dst):
        from .ops import restore
        f64 = torch.float64
        active = ((self.t < self.tend - 1e-12)
                  & (self.ns + self.nr < self.max_steps))
        dt_try = torch.minimum(self.dt, self.tend - self.t)
        # time bookkeeping stays in float64; the kernel sees dt and t
        # rounded to q's dtype
        kd = src.dtype
        _, cfl = self.step(src, self.aux, dt_try.to(kd).to(f64),
                           self.t.to(kd).to(f64), out=dst)
        # the CFL is a maximum of |s| dt/dx: >= 0, or NaN or +inf from a
        # blown-up step, which the comparisons below reject as the JAX
        # loop's isfinite does
        cfl = cfl.to(f64)
        ok = active & (cfl <= self.cfl_max) if self.dt_variable else active
        restore.restore(dst, src, ok)
        if self.gidx is not None:
            # an accepted step's sample at slot ns; the rest, and steps
            # past the buffer, go to the spare last slot
            slot = torch.where(ok & (self.ns < self.gauge_len), self.ns,
                               self.gauge_len).reshape(1)
            self.gt.index_copy_(0, slot, (self.t + dt_try).reshape(1))
            self.gq.index_copy_(0, slot, dst[self.gidx].unsqueeze(0))
        torch.where(ok, self.t + dt_try, self.t, out=self.t)
        self.ns.add_(ok)
        self.nr.add_(active ^ ok)           # ok implies active
        torch.where(ok, torch.maximum(self.cm, cfl), self.cm, out=self.cm)
        torch.where(ok, torch.minimum(self.dmin, dt_try), self.dmin,
                    out=self.dmin)
        torch.where(ok, torch.maximum(self.dmax, dt_try), self.dmax,
                    out=self.dmax)
        if self.dt_variable:
            good = (cfl > 0.0) & (cfl < math.inf)
            grown = torch.clamp(dt_try * self.cfl_desired / cfl,
                                max=self.dt_max)
            new = torch.where(good, grown, dt_try * 0.5)
            torch.where(active, new, self.dt, out=self.dt)

    # -- the host side ----------------------------------------------------
    def _capture(self):
        """Capture the two attempts as CUDA graphs sharing one memory pool,
        on a side stream (``capture_begin``/``capture_end``: without the
        synchronize, garbage collection and cache flushes of the
        ``torch.cuda.graph`` context).  The garbage collector is off
        meanwhile: a collection could free an old loop's graphs, and a
        graph's destruction inside a capture invalidates it.  A failed
        capture raises."""
        dev = self.q[0].device
        graphs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        pool = None
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                for i in (0, 1):
                    graphs[i].capture_begin(pool=pool)
                    try:
                        self.attempt(self.q[i], self.q[1 - i])
                    except BaseException:
                        try:
                            graphs[i].capture_end()
                        except RuntimeError:
                            pass        # the error that stopped it stands
                        raise
                    graphs[i].capture_end()
                    pool = graphs[i].pool()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graphs = graphs
        self.stats["captures"] += 1

    def _attempts(self, n):
        """n attempted steps: replays of the graphs on CUDA (after the
        eager warm-up and the capture, the first time), eager attempts on
        the CPU."""
        for _ in range(n):
            src, dst = self.q[self.cur], self.q[1 - self.cur]
            if not self.cuda:
                self.attempt(src, dst)
            elif self.graphs is None:
                t0 = time.perf_counter()
                self.attempt(src, dst)
                torch.cuda.current_stream(src.device).synchronize()
                t1 = time.perf_counter()
                self._capture()
                torch.cuda.current_stream(src.device).synchronize()
                self.stats["warmup_s"] += t1 - t0
                self.stats["capture_s"] += time.perf_counter() - t1
            else:
                self.graphs[self.cur].replay()
            self.cur = 1 - self.cur
            self.stats["attempts"] += 1

    def _read(self):
        """(t, dt, ns, nr, cm, dmin, dmax) of the loop state: one small
        copy to the host."""
        f64 = torch.float64
        packed = torch.stack([self.t, self.dt, self.ns.to(f64),
                              self.nr.to(f64), self.cm, self.dmin,
                              self.dmax])
        if self.cuda:
            self.host.copy_(packed, non_blocking=True)
            torch.cuda.current_stream(packed.device).synchronize()
            packed = self.host
        v = packed.tolist()
        self.stats["readbacks"] += 1
        return v[0], v[1], int(v[2]), int(v[3]), v[4], v[5], v[6]

    def _batch(self, rest, dt, left):
        """The attempts of the next batch, at least 1 and at most ``left``.
        k: the attempts that reach ``rest`` (tend - t) without passing it
        if dt keeps growing by r an attempt, the factor of the last batch
        (rest / dt when it did not grow).  A k above 64 is cut to 7/8 of
        it, and one above 8 to half when there is no growth to go by
        (before the first batch, or after dt fell): dt's growth often
        speeds up inside a frame, and an attempt after the end costs a
        whole step where one more batch costs one readback."""
        r = self.growth
        if dt <= 0.0:
            k = 1
        elif r is not None and r > 1.0:
            k = math.floor(math.log1p(rest / dt * (r - 1.0)) / math.log(r))
        else:
            k = math.floor(rest / dt)
        if r is None and k > 8:
            k //= 2
        elif k > 64:
            k -= math.ceil(k / 8)
        return min(max(1, k), left)

    def run(self, q_dev, t0, dt0, tend):
        """The loop from (q_dev, t0, dt0) to tend: returns (t, dt, ns, nr,
        cm, dmin, dmax), with q in :meth:`current`."""
        if q_dev is not self.q[self.cur]:
            self.q[self.cur].copy_(q_dev)
        self.t.fill_(float(t0))
        self.dt.fill_(float(dt0))
        self.tend.fill_(float(tend))
        self.ns.zero_()
        self.nr.zero_()
        self.cm.zero_()
        self.dmin.fill_(1e99)
        self.dmax.zero_()
        self.stats["frames"] += 1
        t, dt, ns, nr = float(t0), float(dt0), 0, 0
        res = (t, dt, ns, nr, 0.0, 1e99, 0.0)
        attempts = 0
        while t < tend - 1e-12 and ns + nr < self.max_steps:
            n = self._batch(tend - t, dt, self.max_steps - ns - nr)
            self._attempts(n)
            attempts += n
            res = self._read()
            # dt's factor an attempt over the batch (at least 1); none
            # when dt fell by more than 1% (a rejection, a faster wave),
            # after which it often grows back.  A batch that ended the
            # loop took the clipped step, whose dt says nothing of the
            # flow: the next frame keeps the growth known before it.
            if res[0] < tend - 1e-12:
                ratio = res[1] / dt if dt > 0.0 else 0.0
                self.growth = (max(ratio, 1.0) ** (1.0 / n)
                               if ratio >= 0.99 else None)
            t, dt, ns, nr = res[:4]
        self.stats["after_end"] += attempts - (ns + nr)
        return res
