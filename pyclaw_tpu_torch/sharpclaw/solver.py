"""SharpClaw method-of-lines solvers in 1D, 2D and 3D.

Counterpart of ``pyclaw_tpu/sharpclaw/solver.py`` (``_CFL_DEFAULTS :40``,
``SharpClawSolver :47-148`` without the multistep integrators,
``_soa_eligible :151-163``, ``_make_dq :165-293``, ``_make_step
:300-347`` for Euler, SSP33 and SSP104, ``SharpClawSolver1D/2D/3D
:501-509``), a rebuild of reference ``src/pyclaw/sharpclaw/solver.py``.
``setup`` builds one step function ``_step_fn(q, aux, dt, t, out=None)
-> (q_new, cfl)`` (dt and t Python floats or 0-d tensors; ``out`` the
buffer of q_new or None, which the last stage combine writes).  Each RK
stage extends the BCs and takes one of two routes, as the JAX package
does:

* the SoA route (:meth:`SharpClawSolver._soa_eligible`: 2D, WENO,
  ``char_decomp=0``, no aux or capacity, a system with SoA hooks, and
  ``use_soa``): ``ops.tiled2d.dq_rows``, one launch of
  ``csrc/dq2_weno5.cu`` (the Euler 4-wave or the acoustics instance);
* every other case: ``sharpclaw/kernels.py:dq_1d`` in 1D,
  ``kernels.dq_nd`` (its sweeps along each axis) in 2D and 3D, for any
  registered system with an ``rp`` hook, with aux, a capacity function,
  ``char_decomp`` 0-4 and the positivity fallback; the componentwise
  WENO5 reconstruction ``ops.weno.weno5`` launches ``csrc/weno5.cu``
  on a CUDA tensor, ``char_decomp`` 1-4 reconstructs in plain PyTorch.

On a CPU tensor both routes run their plain PyTorch versions.  The
stage combines are plain tensor operations, as the JAX package leaves
them to XLA.  The row tiling of the JAX package (``dq_nd_tiled``,
``soa_tile_rows``) fits the TPU's VMEM and gives the same bits; it is
not ported.

Options of the JAX package that the port does not take yet raise
``NotImplementedError`` at setup, naming their ROADMAP.md item.
"""

from __future__ import annotations

import torch

from ..config import torch_dtype
from ..ops import tiled2d
from ..solver import Solver, _not_ported
from . import kernels

_CFL_DEFAULTS = {
    "Euler": (0.45, 0.5),
    "SSP33": (0.9, 1.0),
    "SSP104": (2.45, 2.5),
}


class SharpClawSolver(Solver):
    num_dim = None

    def __init__(self, riemann_solver=None, device=None):
        super().__init__(riemann_solver, device=device)
        self.time_integrator = "SSP104"
        self.lim_type = 2
        self.weno_order = 5
        self.tfluct_solver = False
        self.dq_src = None
        self.call_before_step_each_stage = False
        self.char_decomp = 0
        self.use_soa = True
        # never set True, as in the JAX package: setup always takes the
        # integrator's CFL defaults (ROADMAP.md, Queue 3)
        self._cfl_set_by_user = False

    @property
    def _weno_ghost(self):
        if self.lim_type == 2:
            return (self.weno_order + 1) // 2
        return 2

    def _check_ported(self):
        if self.time_integrator not in _CFL_DEFAULTS:
            raise _not_ported("time_integrator RK/SSPLMMk2/SSPLMMk3/LMM")
        if self.lim_type != 2:
            raise _not_ported("lim_type=1")
        if self.weno_order != 5:
            raise _not_ported("weno_order 7-17")
        # the JAX package's checks (sharpclaw/solver.py:187-192)
        if self.char_decomp in (2, 3, 4) and self.rp.evec is None:
            raise ValueError(f"char_decomp={self.char_decomp} needs an evec "
                             f"hook on Riemann solver {self.rp.name}")
        if self.char_decomp not in (0, 1, 2, 3, 4):
            raise ValueError(f"char_decomp={self.char_decomp} not supported "
                             "(0 componentwise, 1 wave, 2 characteristic, "
                             "3 transmission, 4 interface-basis)")
        if self.tfluct_solver:
            raise _not_ported("tfluct_solver")
        if self.call_before_step_each_stage:
            raise _not_ported("call_before_step_each_stage")

    def _soa_eligible(self, state):
        """The JAX package's test (``sharpclaw/solver.py:151-163``): the
        SoA dq covers 2D componentwise WENO with no aux, capacity or
        tfluct, for a system with SoA hooks."""
        if self.use_soa is False:
            return False
        return (self.num_dim == 2
                and self.lim_type == 2
                and self.char_decomp == 0
                and not self.tfluct_solver
                and state.aux is None
                and state.index_capa < 0
                and self.rp.rpn_soa is not None)

    def setup(self, solution):
        state = solution.states[0]
        self._check_setup(state)
        self._check_ported()
        self.num_ghost = self._weno_ghost
        self._size_bc_lists(self.num_dim)
        if not self._cfl_set_by_user:
            self.cfl_desired, self.cfl_max = _CFL_DEFAULTS[
                self.time_integrator]
        if self.dt_initial is not None:
            self.dt = self.dt_initial
        self._step_fn = self._finalize_step(self._make_step(state), state)
        self._is_set_up = True

    # ------------------------------------------------------------------
    def _make_dq(self, state):
        """fn(q, aux, dt, t) -> (dq over the interior with dt included,
        cfl): :meth:`_make_hyperbolic_dq`, plus ``dt * dq_src(solver,
        state, q, dt, t)`` when the solver has a ``dq_src`` hook (a
        function of torch operations; dt and t as the step gets them), as
        on each of the JAX package's routes (``sharpclaw/solver.py:238-243,
        264-269, 292-297``)."""
        base = self._make_hyperbolic_dq(state)
        dq_src = self.dq_src
        if dq_src is None:
            return base

        def dq(q, aux, dt, t):
            d, cfl = base(q, aux, dt, t)
            return d + dt * dq_src(self, state, q, dt, t), cfl
        return dq

    def _make_hyperbolic_dq(self, state):
        """fn(q, aux, dt, t) -> (dq, cfl) of the hyperbolic part: BC
        extension, then one dq_rows (the SoA route), dq_1d (1D) or dq_nd
        (2D, 3D) call."""
        params = self._weak_params(state.problem_data)
        weno_order = self.weno_order
        g = self.num_ghost
        rp = self.rp
        if self._soa_eligible(state):
            dx, dy = state.patch.delta

            def dq_soa(q, aux, dt, t):
                qbc, _ = self._extend_bc(q, aux, t, state)
                return tiled2d.dq_rows(qbc, dt, dx, dy, params, weno_order,
                                       g, rp=rp)
            return dq_soa
        if rp.rp is None:
            raise ValueError(f"Riemann solver {rp.name} has no rp hook")
        lim_type = self.lim_type
        index_capa = state.index_capa
        char_decomp = self.char_decomp
        if self.num_dim == 1:
            fn, delta = kernels.dq_1d, state.patch.delta[0]
        else:
            fn, delta = kernels.dq_nd, tuple(state.patch.delta)

        def dq(q, aux, dt, t):
            qbc, auxbc = self._extend_bc(q, aux, t, state)
            return fn(qbc, auxbc, dt, delta, rp.rp, params, lim_type,
                      weno_order, index_capa, g, positivity=rp.positivity,
                      flux=rp.flux, char_decomp=char_decomp, evec=rp.evec)
        return dq

    def _make_step(self, state):
        dq = self._make_dq(state)
        kdtype = state.q.dtype.type

        def stage_t(t, dt, c, div=1.0):
            """t + c*dt/div in q's dtype, as the JAX package computes the
            stage times (they reach only the BCs): a Python float, or with
            t and dt 0-d tensors (the device loop) a float64 0-d tensor of
            the same value."""
            if isinstance(t, torch.Tensor):
                kd = torch_dtype(state.q.dtype)
                return (t.to(kd) + dt.to(kd) * c / div).to(torch.float64)
            return float(kdtype(t) + kdtype(c) * kdtype(dt) / kdtype(div))

        if self.time_integrator == "Euler":
            def step(q, aux, dt, t, out=None):
                d, cfl = dq(q, aux, dt, t)
                return torch.add(q, d, out=out), cfl

        elif self.time_integrator == "SSP33":
            def step(q, aux, dt, t, out=None):
                d1, c1 = dq(q, aux, dt, t)
                q1 = q + d1
                d2, c2 = dq(q1, aux, dt, stage_t(t, dt, 1.0))
                q2 = 0.75 * q + 0.25 * (q1 + d2)
                d3, c3 = dq(q2, aux, dt, stage_t(t, dt, 0.5))
                qn = torch.add(q / 3.0, (2.0 / 3.0) * (q2 + d3), out=out)
                return qn, torch.maximum(c1, torch.maximum(c2, c3))

        else:  # SSP104: Ketcheson's low-storage 2-register scheme
            def step(q, aux, dt, t, out=None):
                # the CFL carry is a function of q, so a NaN in q still
                # reaches the accept/reject test
                cfl = q.reshape(-1)[0] * 0.0
                s1 = q
                for i in range(5):
                    d, c = dq(s1, aux, dt, stage_t(t, dt, i, 6.0))
                    s1 = s1 + d / 6.0
                    cfl = torch.maximum(cfl, c)
                s2 = q / 25.0 + (9.0 / 25.0) * s1
                s1 = 15.0 * s2 - 5.0 * s1
                for i in range(4):
                    d, c = dq(s1, aux, dt, stage_t(t, dt, i + 6, 6.0))
                    s1 = s1 + d / 6.0
                    cfl = torch.maximum(cfl, c)
                d, c = dq(s1, aux, dt, stage_t(t, dt, 1.0))
                qn = torch.add(s2 + 0.6 * s1, 0.1 * d, out=out)
                return qn, torch.maximum(cfl, c)
        return step


class SharpClawSolver1D(SharpClawSolver):
    num_dim = 1


class SharpClawSolver2D(SharpClawSolver):
    num_dim = 2


class SharpClawSolver3D(SharpClawSolver):
    num_dim = 3
