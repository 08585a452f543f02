"""Classic Clawpack solvers: the 1D sweep and the 2D and 3D unsplit CTU
paths.

Counterpart of ``pyclaw_tpu/classic/solver.py`` (``ClawSolver :30-107``,
``ClawSolver1D :109-131``, ``ClawSolver2D :134-168``, ``_soa_eligible
:387-398``, ``ClawSolver3D :401-528``), a rebuild of reference
``src/pyclaw/classic/solver.py``.  ``setup`` builds one step function
``_step_fn(q, aux, dt, t, out=None) -> (q_new, cfl)`` (dt and t Python
floats or 0-d tensors; ``out`` the buffer of q_new or None): BC extension
of q (and aux),
then ``ops.sweep.step1`` (1D: aux, capacity, f-waves),
``ops.tiled2d.step2_rows`` (2D, the SoA Euler step),
``ops.tiled2d.step2_rows_generic`` (2D, the generic AoS step: aux,
capacity, f-waves), ``ops.tiled2d.step3_xy`` (3D Euler) or
``ops.tiled2d.step3_xy_generic`` (3D, the generic AoS step: aux, capacity,
f-waves), which launch the CUDA kernel on a CUDA tensor and run the plain
PyTorch version on a CPU tensor.  With ``dimensional_split = True`` the 2D
and 3D step is one ``classic/kernels.py:step1_dir`` sweep an axis, each
after its own BC fill (plain PyTorch on every device, as the JAX package
runs it through XLA).  ``step_source`` is split around the step, Godunov
or Strang (``source_split``), as in the JAX package.

Options of the JAX package that this slice does not port raise
``NotImplementedError`` at setup, naming their ROADMAP.md item.
"""

from __future__ import annotations

import torch

from ..ops import _build, sweep, tiled2d
from ..solver import Solver, _not_ported
from . import kernels


class ClawSolver(Solver):
    num_dim = None

    def __init__(self, riemann_solver=None, device=None):
        super().__init__(riemann_solver, device=device)
        self.limiters = [1]           # per-wave limiter ids (tvd.minmod)
        self.order = 2
        self.source_split = 1         # 1=Godunov, 2=Strang
        self.step_source = None
        self.cfl_max = 1.0
        self.cfl_desired = 0.9
        self.num_ghost = 2

    # ------------------------------------------------------------------
    def _mthlim(self):
        lims = self.limiters
        if not isinstance(lims, (list, tuple)):
            lims = [lims]
        nw = self.rp.num_waves
        if len(lims) == 1:
            return tuple(lims) * nw
        if len(lims) != nw:
            raise ValueError("limiters must have length 1 or num_waves")
        return tuple(lims)

    def setup(self, solution):
        state = solution.states[0]
        self._check_setup(state)
        self._size_bc_lists(self.num_dim)
        if self.dt_initial is not None:
            self.dt = self.dt_initial
        self._step_fn = self._finalize_step(self._make_full_step(state),
                                            state)
        self._is_set_up = True

    def _make_hyperbolic_step(self, state):
        raise NotImplementedError

    def _make_full_step(self, state):
        """The hyperbolic step with the source hook split around it, as
        the JAX package's ``_make_full_step`` (``classic/solver.py:78-97``):
        ``step_source(solver, state, q, dt) -> q_new``, a function of torch
        operations, over dt/2 before and after the step (Strang,
        ``source_split = 2``) or over dt after it (Godunov, 1).  The hook
        gets dt as a 0-d float64 tensor on q's device (the device loop's
        own, or the host loop's float made one), so on the card it is
        captured with the step in the device loop's CUDA graphs; a hook
        that reads a tensor back to the host fails that capture, which
        raises."""
        hyper = self._make_hyperbolic_step(state)
        src = self.step_source
        if src is None:
            return hyper
        split = self.source_split
        if split not in (1, 2):
            raise ValueError(f"source_split must be 1 (Godunov) or 2 "
                             f"(Strang), got {split}")

        def full(q, aux, dt, t, out=None):
            if not isinstance(dt, torch.Tensor):
                dt = torch.tensor(dt, dtype=torch.float64, device=q.device)
            if split == 2:
                q = src(self, state, q, dt / 2.0)
            q_new, cfl = hyper(q, aux, dt, t)
            q_new = src(self, state, q_new, dt if split == 1 else dt / 2.0)
            return _build.plain_out((q_new, cfl), out)
        return full

    def _make_split_step(self, state, deltas):
        """Dimensional splitting (Godunov, one sweep an axis in order, as
        ``pyclaw_tpu/classic/solver.py:169-183, 447-460``): before each
        sweep the BCs are filled again, custom callbacks included, at the
        step's t, and each sweep is ``classic/kernels.py:step1_dir``; the
        step's CFL is the largest sweep's.  A sweep's q between two sweeps
        is a new tensor (in the device loop's graph pool on the card); the
        last one is copied into ``out``."""
        rp = self.rp
        if rp.rp is None:
            raise ValueError(f"Riemann solver {rp.name} has no rp hook")
        params = self._weak_params(state.problem_data)
        mthlim = self._mthlim()
        order = self.order
        fwave = self.fwave
        index_capa = state.index_capa
        g = self.num_ghost

        def step_fn(q, aux, dt, t, out=None):
            cfl = None
            for ixy, dxi in enumerate(deltas):
                qbc, auxbc = self._extend_bc(q, aux, t, state)
                q, c = kernels.step1_dir(qbc, auxbc, dt, dxi, ixy, rp.rp,
                                         params, mthlim, order, fwave,
                                         index_capa, g)
                cfl = c if cfl is None else torch.maximum(cfl, c)
            return _build.plain_out((q, cfl), out)
        return step_fn


class ClawSolver1D(ClawSolver):
    """1D classic solver (step1.f90 path): Riemann solve, limiter,
    correction flux and update in one sweep.  Takes aux arrays, a capacity
    function (``state.index_capa``) and ``fwave``."""
    num_dim = 1

    def _make_hyperbolic_step(self, state):
        rp = self.rp
        if rp.rp is None:
            raise ValueError(f"Riemann solver {rp.name} has no rp hook")
        params = self._weak_params(state.problem_data)
        mthlim = self._mthlim()
        order = self.order
        fwave = self.fwave
        index_capa = state.index_capa
        g = self.num_ghost
        dx = state.patch.delta[0]
        sweep.check_options(mthlim, order, rp.num_waves, g)

        def step_fn(q, aux, dt, t, out=None):
            qbc, auxbc = self._extend_bc(q, aux, t, state)
            return sweep.step1(qbc, auxbc, dt, dx, rp, params, mthlim, order,
                               fwave, index_capa, g, out=out)
        return step_fn


class ClawSolver2D(ClawSolver):
    """2D unsplit classic solver with transverse corner transport
    (step2.f90/flux2.f90 path).  ``transverse_waves`` ∈ {0, 1, 2}: 0 =
    donor-cell, 1 = corner transport of the first-order fluctuations,
    2 = also of the second-order correction waves.  Takes aux arrays, a
    capacity function (``state.index_capa``) and ``fwave``.

    With ``dimensional_split = True`` the step is an x then a y sweep
    (:meth:`ClawSolver._make_split_step`).  Otherwise: the Euler 4-wave
    system on the SoA route
    (:meth:`_soa_eligible`) runs ``ops.tiled2d.step2_rows``
    (``csrc/step2_ctu.cu``); every other system with an ``rp`` and an
    ``rpt`` hook runs ``ops.tiled2d.step2_rows_generic``, which on the
    card launches ``csrc/step2_aos.cu`` for the systems of
    ``ops.tiled2d.AOS_SYSTEMS``: the shallow-water systems
    (``shallow_roe_with_efix_2D``, ``shallow_bathymetry_fwave_2D``,
    ``sw_aug_2D``), ``acoustics_2D``, ``vc_acoustics_2D``, the Euler 4- and
    5-wave systems, ``advection_2D``, ``vc_advection_2D``,
    ``vc_advection_fwave_2D``, ``kpp_2D``, ``burgers_2D`` and the two
    records without ``rpt``, ``psystem_2D`` and ``shallow_sphere_fwave_2D``
    (no transverse pass), and raises for any other."""
    num_dim = 2

    def __init__(self, riemann_solver=None, device=None):
        super().__init__(riemann_solver, device=device)
        self.dimensional_split = False
        self.transverse_waves = 2
        self.use_soa = True

    def _make_hyperbolic_step(self, state):
        if self.dimensional_split:
            return self._make_split_step(state, tuple(state.patch.delta))
        if self.num_ghost != 2:
            raise ValueError("the 2D CTU step needs num_ghost=2")
        params = self._weak_params(state.problem_data)
        mthlim = self._mthlim()
        order = self.order
        tw = self.transverse_waves
        g = self.num_ghost
        dx, dy = state.patch.delta
        if self._soa_eligible(state):
            tiled2d.check_options(mthlim, order, tw)

            def step_fn(q, aux, dt, t, out=None):
                qbc, _ = self._extend_bc(q, aux, t, state)
                return tiled2d.step2_rows(qbc, dt, dx, dy, params, mthlim,
                                          order, g, tw, out=out)
            return step_fn

        # the generic AoS step (any system with AoS hooks; on the card the
        # systems of tiled2d.AOS_SYSTEMS, the wrapper raises for others); a
        # record without rpt runs no transverse pass, whatever
        # transverse_waves says (pyclaw_tpu/classic/kernels.py:237)
        rp = self.rp
        if rp.rp is None:
            raise _not_ported("generic AoS 2D step")
        tiled2d.check_options(mthlim, order, tw, rp.num_waves,
                              "step2_rows_generic")
        fwave = self.fwave
        index_capa = state.index_capa

        def step_fn(q, aux, dt, t, out=None):
            qbc, auxbc = self._extend_bc(q, aux, t, state)
            return tiled2d.step2_rows_generic(qbc, auxbc, dt, dx, dy, rp,
                                              params, mthlim, order, fwave,
                                              index_capa, g, tw, out=out)
        return step_fn

    def _soa_eligible(self, state):
        """The JAX package's test (``classic/solver.py:387-398``): the SoA
        CTU step covers the no-aux / no-capacity / wave-form case of a
        solver with SoA hooks.  The port's SoA kernel (``csrc/
        step2_ctu.cu``) covers the Euler 4-wave system only:
        ``acoustics_2D`` and ``euler_5wave_2D``, which have SoA hooks too
        and run on the JAX package's SoA body, take the generic route here
        (``csrc/step2_aos.cu``, the same step to roundoff), as the Euler
        4-wave system does with aux, a capacity function, f-waves or
        ``use_soa=False``."""
        if self.use_soa is False:
            return False
        return (self.rp.rpn_soa is not None
                and self.rp.name == "euler_4wave_2D"
                and state.aux is None
                and state.index_capa < 0
                and not self.fwave
                and (self.transverse_waves == 0
                     or self.rp.rpt_soa is not None))


class ClawSolver3D(ClawSolver):
    """3D unsplit classic solver (step3.f90/flux3.f90 path): the full
    Langseth-LeVeque corner transport, single-transverse (rpt3) terms plus
    double-transverse (rptt3) corner-of-corner terms.  ``transverse_waves``
    as in 2D; without an rptt hook the unsplit step with
    ``transverse_waves >= 2`` is refused, as in the JAX package.  Takes aux
    arrays, a capacity function (``state.index_capa``) and ``fwave``.

    The step: ``euler_3D`` runs ``ops.tiled2d.step3_xy``
    (``csrc/step3_ctu.cu``), with or without a capacity function or
    f-waves (Euler reads no other aux); the systems of
    ``ops.tiled2d.STEP3_SYSTEMS`` (``vc_acoustics_3D``, ``acoustics_3D``,
    ``advection_3D``, ``burgers_3D``: every 3D record of the JAX package
    but Euler) run ``ops.tiled2d.step3_xy_generic``
    (``csrc/step3_aos.cu``).  Any other 3D record is refused at setup."""
    num_dim = 3

    def __init__(self, riemann_solver=None, device=None):
        super().__init__(riemann_solver, device=device)
        self.dimensional_split = False
        self.transverse_waves = 2
        self.cfl_max = 1.0
        self.cfl_desired = 0.9

    def setup(self, solution):
        if (not self.dimensional_split and self.transverse_waves >= 2
                and self.rp is not None and self.rp.rptt is None):
            raise ValueError(
                f"Riemann solver {self.rp.name} has no rptt (double-"
                "transverse) hook: 3D unsplit CTU would be unstable. "
                "Set solver.dimensional_split = True or "
                "transverse_waves < 2 with a reduced CFL.")
        super().setup(solution)

    def _make_hyperbolic_step(self, state):
        if self.dimensional_split:
            return self._make_split_step(state, tuple(state.patch.delta))
        rp = self.rp
        is_euler = rp.name == "euler_3D"
        if not is_euler and rp.name not in tiled2d.STEP3_SYSTEMS:
            raise NotImplementedError(
                f"the 3D step of {rp.name} is not ported to "
                "pyclaw_tpu_torch yet (ROADMAP.md, Queue 1 item 10)")
        if self.num_ghost != 2:
            raise ValueError("the 3D CTU step needs num_ghost=2")
        params = self._weak_params(state.problem_data)
        mthlim = self._mthlim()
        order = self.order
        tw = self.transverse_waves
        g = self.num_ghost
        fwave = self.fwave
        index_capa = state.index_capa
        dx, dy, dz = state.patch.delta
        if is_euler:
            tiled2d.check_options(mthlim, order, tw, 5, "step3_xy")

            def step_fn(q, aux, dt, t, out=None):
                qbc, auxbc = self._extend_bc(q, aux, t, state)
                return tiled2d.step3_xy(qbc, dt, dx, dy, dz, params, mthlim,
                                        order, g, tw, auxbc=auxbc,
                                        index_capa=index_capa, fwave=fwave,
                                        out=out)
            return step_fn

        tiled2d.check_options(mthlim, order, tw, rp.num_waves,
                              "step3_xy_generic")

        def step_fn(q, aux, dt, t, out=None):
            qbc, auxbc = self._extend_bc(q, aux, t, state)
            return tiled2d.step3_xy_generic(qbc, auxbc, dt, dx, dy, dz, rp,
                                            params, mthlim, order, fwave,
                                            index_capa, g, tw, out=out)
        return step_fn
