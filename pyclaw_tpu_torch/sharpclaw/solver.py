"""SharpClaw method-of-lines solvers in 1D, 2D and 3D.

Counterpart of ``pyclaw_tpu/sharpclaw/solver.py`` (``_CFL_DEFAULTS :40``,
``SharpClawSolver :47-148``, ``_soa_eligible :151-163``, ``_make_dq
:165-298``, ``_make_step :300-388`` for Euler, SSP33, SSP104 and RK, the
multistep methods ``_lmm_coeffs :405``, ``_omega_min :418``,
``_lmm_step :421``, ``_generic_lmm_step :451``, ``accept_reject_step
:473``, ``step :481``, ``_can_use_traced_evolve :495``,
``SharpClawSolver1D/2D/3D :501-510``), a rebuild of reference
``src/pyclaw/sharpclaw/solver.py``.  ``setup`` builds one step function
``_step_fn(q, aux, dt, t, out=None) -> (q_new, cfl)`` (dt and t Python
floats or 0-d tensors; ``out`` the buffer of q_new or None, which the
last stage combine writes) for the one-step integrators (Euler, SSP33,
SSP104 and ``RK``, an explicit Butcher tableau ``a``, ``b`` and ``c``,
``c`` the row sums of ``a`` when None), which the device loop replays
as CUDA graphs.  Each stage extends the BCs and takes one of two routes,
as the JAX package does:

* the SoA route (:meth:`SharpClawSolver._soa_eligible`: 2D, WENO,
  ``char_decomp=0``, no aux, capacity or ``tfluct_solver``, a system with
  SoA hooks, and ``use_soa``): ``ops.tiled2d.dq_rows``, one launch of
  ``csrc/dq2_weno5.cu`` (WENO5) or ``csrc/dq2_weno.cu`` (orders 7-17),
  each with an Euler 4-wave, an Euler 5-wave and an acoustics instance;
* every other case: ``sharpclaw/kernels.py:dq_1d`` in 1D,
  ``kernels.dq_nd`` (its sweeps along each axis) in 2D and 3D, for any
  registered system with an ``rp`` hook, with aux, a capacity function,
  ``lim_type`` 0/1/2 (``tvd_limiter`` for 1), ``char_decomp`` 0-4, a
  ``tfluct`` hook and the positivity fallback; the componentwise WENO5
  reconstruction ``ops.weno.weno5`` launches ``csrc/weno5.cu`` on a CUDA
  tensor, every other reconstruction is plain PyTorch.

The multistep integrators (``SSPLMMk2``, ``SSPLMMk3`` with variable
steps, and ``LMM`` with the user's ``lmm_alpha`` and ``lmm_beta`` at a
fixed step) keep a history of device tensors (q, f = dq/dt, dt),
start with SSP104 steps, and are sequenced on the host as in the JAX
package: they take the host loop with the JAX host loop's dt rule
(``Solver._host_sequenced``), and a step may lower ``self.dt`` (the
Omega floor of ``_lmm_step``), which the loop reads back.  A rejected
step restores the history.  ``call_before_step_each_stage`` is accepted
and ignored, as the JAX package stores it and never reads it.

On a CPU tensor every route runs its plain PyTorch version.  The stage
combines are plain tensor operations, as the JAX package leaves them to
XLA.  The row tiling of the JAX package (``dq_nd_tiled``,
``soa_tile_rows``) fits the TPU's VMEM and gives the same bits; it is
not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import torch_dtype
from ..ops import tiled2d
from ..solver import Solver
from . import kernels

_CFL_DEFAULTS = {
    "Euler": (0.45, 0.5),
    "SSP33": (0.9, 1.0),
    "SSP104": (2.45, 2.5),
}
_MULTISTEP = ("SSPLMMk2", "SSPLMMk3", "LMM")


class SharpClawSolver(Solver):
    num_dim = None

    def __init__(self, riemann_solver=None, device=None):
        super().__init__(riemann_solver, device=device)
        self.time_integrator = "SSP104"
        self.lim_type = 2
        self.weno_order = 5
        self.tvd_limiter = 4           # MC, used when lim_type == 1
        self.tfluct_solver = False
        # fn(ixy, ql, qr, aux_l, aux_r, params) -> adq, torch operations
        self.tfluct = None
        self.dq_src = None
        self.call_before_step_each_stage = False
        self.char_decomp = 0
        self.use_soa = True
        # never set True, as in the JAX package: setup always takes the
        # integrator's CFL defaults (ROADMAP.md, Queue 3)
        self._cfl_set_by_user = False
        # 'RK': the explicit Butcher tableau (reference attrs a, b, c)
        self.a = None
        self.b = None
        self.c = None
        # SSPLMMk2 / SSPLMMk3: the steps of the method
        self.lmm_steps = 4
        self._lmm_history = None
        self._lmm_hist_backup = None
        # 'LMM': the user's coefficients, oldest first
        self.lmm_alpha = None
        self.lmm_beta = None

    @property
    def _weno_ghost(self):
        if self.lim_type == 2:
            return (self.weno_order + 1) // 2
        return 2

    @property
    def _host_sequenced(self):
        return self.time_integrator in _MULTISTEP

    def _check_options(self):
        """The JAX package's checks of ``char_decomp``
        (``sharpclaw/solver.py:187-192``)."""
        if self.char_decomp in (2, 3, 4) and self.rp.evec is None:
            raise ValueError(f"char_decomp={self.char_decomp} needs an evec "
                             f"hook on Riemann solver {self.rp.name}")
        if self.char_decomp not in (0, 1, 2, 3, 4):
            raise ValueError(f"char_decomp={self.char_decomp} not supported "
                             "(0 componentwise, 1 wave, 2 characteristic, "
                             "3 transmission, 4 interface-basis)")

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
        self._check_options()
        self.num_ghost = self._weno_ghost
        self._size_bc_lists(self.num_dim)
        if (not self._cfl_set_by_user
                and self.time_integrator in _CFL_DEFAULTS):
            self.cfl_desired, self.cfl_max = _CFL_DEFAULTS[
                self.time_integrator]
        if self.dt_initial is not None:
            self.dt = self.dt_initial
        if self.time_integrator == "LMM":
            if self.lmm_alpha is None or self.lmm_beta is None:
                raise ValueError(
                    "time_integrator='LMM' needs solver.lmm_alpha and "
                    "solver.lmm_beta (explicit multistep coefficients, "
                    "oldest-first); or pick one of Euler, SSP33, SSP104, "
                    "RK, SSPLMMk2, SSPLMMk3")
            if self.dt_variable:
                raise ValueError(
                    "time_integrator='LMM' uses constant-step "
                    "coefficients; set solver.dt_variable = False "
                    "(SSPLMMk2/SSPLMMk3 support variable steps)")
            a = np.asarray(self.lmm_alpha, dtype=float)
            b = np.asarray(self.lmm_beta, dtype=float)
            if a.shape != b.shape or a.ndim != 1 or len(a) < 1:
                raise ValueError("lmm_alpha and lmm_beta must be 1-D "
                                 "arrays of equal length")
            if abs(a.sum() - 1.0) > 1e-12:
                raise ValueError(f"lmm_alpha must sum to 1 (consistency); "
                                 f"got {a.sum()}")
            self.lmm_steps = len(a)
        elif (self.time_integrator in ("SSPLMMk2", "SSPLMMk3")
              and self.dt_variable and not self._cfl_set_by_user):
            # half the SSP coefficient of the optimal constant-step
            # method (the JAX package's measured bound with WENO5)
            k = self.lmm_steps
            order = 2 if self.time_integrator == "SSPLMMk2" else 3
            c_ssp = max(1e-6, (k - order) / (k - 1))
            self.cfl_max = 0.5 * c_ssp
            self.cfl_desired = 0.45 * c_ssp
        if self._host_sequenced:
            self._dq_fn = self._finalize_step(self._make_dq_step(state),
                                              state)
            self._starter_fn = self._finalize_step(
                self._make_step(state, "SSP104"), state)
            self._lmm_history = []
            self._lmm_hist_backup = None
        else:
            self._step_fn = self._finalize_step(self._make_step(state),
                                                state)
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

    def _make_dq_step(self, state):
        """:meth:`_make_dq` in the step's signature (``out`` unused), for
        the multistep methods' history."""
        dq = self._make_dq(state)

        def dq_step(q, aux, dt, t, out=None):
            return dq(q, aux, dt, t)
        return dq_step

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
        tvd_limiter = self.tvd_limiter
        # a user tfluct replaces the in-cell fluctuation, and with it the
        # record's flux
        tfluct = self.tfluct if self.tfluct_solver else None
        flux = None if self.tfluct_solver else rp.flux
        if self.num_dim == 1:
            fn, delta = kernels.dq_1d, state.patch.delta[0]
        else:
            fn, delta = kernels.dq_nd, tuple(state.patch.delta)

        def dq(q, aux, dt, t):
            qbc, auxbc = self._extend_bc(q, aux, t, state)
            return fn(qbc, auxbc, dt, delta, rp.rp, params, lim_type,
                      weno_order, index_capa, g, positivity=rp.positivity,
                      flux=flux, char_decomp=char_decomp, evec=rp.evec,
                      tfluct=tfluct, tvd_limiter=tvd_limiter)
        return dq

    def _make_step(self, state, integrator=None):
        dq = self._make_dq(state)
        integrator = integrator or self.time_integrator
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

        if integrator == "Euler":
            def step(q, aux, dt, t, out=None):
                d, cfl = dq(q, aux, dt, t)
                return torch.add(q, d, out=out), cfl

        elif integrator == "SSP33":
            def step(q, aux, dt, t, out=None):
                d1, c1 = dq(q, aux, dt, t)
                q1 = q + d1
                d2, c2 = dq(q1, aux, dt, stage_t(t, dt, 1.0))
                q2 = 0.75 * q + 0.25 * (q1 + d2)
                d3, c3 = dq(q2, aux, dt, stage_t(t, dt, 0.5))
                qn = torch.add(q / 3.0, (2.0 / 3.0) * (q2 + d3), out=out)
                return qn, torch.maximum(c1, torch.maximum(c2, c3))

        elif integrator == "SSP104":
            # Ketcheson's low-storage 2-register scheme
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

        elif integrator == "RK":
            step = self._make_rk_step(dq, stage_t)
        else:
            raise NotImplementedError(
                f"time_integrator {integrator!r} not ported yet "
                "(Euler, SSP33, SSP104, RK, SSPLMMk2, SSPLMMk3 available)")
        return step

    def _make_rk_step(self, dq, stage_t):
        """The generic explicit Runge-Kutta step of the Butcher tableau
        (``a``, ``b``, ``c``; the JAX package's RK branch, ``:348-376``):
        stage i at t + c_i dt on q + sum_j a_ij k_j (zero a_ij skipped),
        then q + sum_i b_i k_i (zero b_i skipped), the last term written
        into ``out``; the CFL the maximum over the stages."""
        if self.a is None or self.b is None:
            raise ValueError("time_integrator='RK' needs solver.a and "
                             "solver.b (Butcher tableau)")
        A = np.asarray(self.a, dtype=float)
        b = np.asarray(self.b, dtype=float)
        c = (np.asarray(self.c, dtype=float) if self.c is not None
             else A.sum(axis=1))
        nstage = len(b)
        nonzero = [i for i in range(nstage) if b[i] != 0.0]

        def step(q, aux, dt, t, out=None):
            ks = []
            cfl = None
            for i in range(nstage):
                yi = q
                for j in range(i):
                    if A[i, j] != 0.0:
                        yi = yi + float(A[i, j]) * ks[j]
                d, cc = dq(yi, aux, dt, stage_t(t, dt, float(c[i])))
                ks.append(d)
                cfl = cc if cfl is None else torch.maximum(cfl, cc)
            if not nonzero:
                return (q if out is None else out.copy_(q)), cfl
            qn = q
            for i in nonzero[:-1]:
                qn = qn + float(b[i]) * ks[i]
            last = nonzero[-1]
            return torch.add(qn, float(b[last]) * ks[last], out=out), cfl
        return step

    # -- the multistep methods, sequenced on the host ---------------------
    # Optimal explicit SSP k-step methods with variable step sizes
    # (reference SSPLMMk2/k3).  With Omega = (t_n - t_{n-k+1}) / h, the
    # sum of the previous k-1 steps over the current one:
    #   order 2: ak = 1/Omega^2, a0 = 1-ak, b0 = (Omega+1)/Omega
    #   order 3: ak = (3*Omega+2)/Omega^3, a0 = 1-ak,
    #            b0 = ((Omega+1)/Omega)^2, bk = (Omega+1)/Omega^2
    # in u^{n+1} = a0 u^n + ak u^{n-k+1} + h (b0 f^n + bk f^{n-k+1}).
    # a0 >= 0 needs Omega > 1 (order 2) / Omega >= 2 (order 3):
    # _lmm_step lowers dt to keep Omega above that floor.
    def _lmm_coeffs(self, omega):
        if self.lmm_steps < 3:
            raise ValueError("SSPLMM needs lmm_steps >= 3")
        if self.time_integrator == "SSPLMMk2":
            ak = 1.0 / omega ** 2
            return 1.0 - ak, ak, (omega + 1.0) / omega, 0.0
        ak = (3.0 * omega + 2.0) / omega ** 3
        a0 = 1.0 - ak
        b0 = ((omega + 1.0) / omega) ** 2
        bk = (omega + 1.0) / omega ** 2
        return a0, ak, b0, bk

    @property
    def _omega_min(self):
        return 1.001 if self.time_integrator == "SSPLMMk2" else 2.001

    def _lmm_step(self, q, t, kdtype):
        """One SSPLMM step of ``self.dt`` (which it may lower) from q at
        t: (q_new, cfl as a float).  History entries are (q, f, dt) with
        f = dq/dt, so variable steps rescale cleanly; until k-1 exist the
        step is SSP104's."""
        k = self.lmm_steps
        hist = self._lmm_history
        self._lmm_hist_backup = list(hist)   # restored on a rejection
        aux = self._aux_dev
        if len(hist) < k - 1:
            d, cfl = self._dq_fn(q, aux, float(kdtype(self.dt)),
                                 float(kdtype(t)))
            hist.append((q, d / self.dt, self.dt))
            q_new, cfl = self._starter_fn(q, aux, float(kdtype(self.dt)),
                                          float(kdtype(t)))
            return q_new, float(cfl)
        if self.dt_variable:
            # keep Omega above the positivity floor
            sum_prev = sum(h[2] for h in hist)
            self.dt = min(self.dt, sum_prev / self._omega_min)
        omega = sum(h[2] for h in hist) / self.dt
        a0, ak, b0, bk = self._lmm_coeffs(omega)
        d, cfl = self._dq_fn(q, aux, float(kdtype(self.dt)),
                             float(kdtype(t)))
        hist.append((q, d / self.dt, self.dt))
        q_old, f_old, _ = hist.pop(0)       # u^{n-k+1}, f^{n-k+1}
        q_new = a0 * q + ak * q_old + b0 * d
        if bk != 0.0:
            q_new = q_new + (bk * self.dt) * f_old
        return q_new, float(cfl)

    def _generic_lmm_step(self, q, t, kdtype):
        """One step of the user's explicit LMM (``lmm_alpha``,
        ``lmm_beta``, oldest first) from q at t: (q_new, cfl as a float);
        SSP104 until the history holds k entries."""
        k = self.lmm_steps
        hist = self._lmm_history
        self._lmm_hist_backup = list(hist)
        aux = self._aux_dev
        kdt, kt = float(kdtype(self.dt)), float(kdtype(t))
        d, cfl = self._dq_fn(q, aux, kdt, kt)
        hist.append((q, d / self.dt, self.dt))
        del hist[:-k]
        if len(hist) < k:
            q_new, cfl = self._starter_fn(q, aux, kdt, kt)
            return q_new, float(cfl)
        q_new = None
        for (qi, fi, _), ai, bi in zip(hist, self.lmm_alpha, self.lmm_beta):
            term = float(ai) * qi + (float(bi) * self.dt) * fi
            q_new = term if q_new is None else q_new + term
        return q_new, float(cfl)

    def _attempt(self, q, dt, t, kdtype):
        """The host loop's attempted step; a multistep step sets
        ``self.dt`` to dt, may lower it, and the loop reads it back."""
        if not self._host_sequenced:
            return super()._attempt(q, dt, t, kdtype)
        self.dt = dt
        fn = (self._generic_lmm_step if self.time_integrator == "LMM"
              else self._lmm_step)
        q_new, cfl = fn(q, t, kdtype)
        return q_new, cfl, self.dt

    def accept_reject_step(self, cfl):
        ok = super().accept_reject_step(cfl)
        if (not ok and self._host_sequenced
                and self._lmm_hist_backup is not None):
            self._lmm_history = self._lmm_hist_backup
        return ok

    def step(self, solution):
        state = solution.states[0]
        if not self._host_sequenced:
            return super().step(solution)
        q, cfl, _ = self._attempt(self._q_dev, self.dt, state.t,
                                  state.q.dtype.type)
        self._q_dev = q
        self.cfl.update_global_max(cfl)

    def _can_use_traced_evolve(self, state):
        if self._host_sequenced:
            return False  # the multistep history is sequenced on the host
        return super()._can_use_traced_evolve(state)


class SharpClawSolver1D(SharpClawSolver):
    num_dim = 1


class SharpClawSolver2D(SharpClawSolver):
    num_dim = 2


class SharpClawSolver3D(SharpClawSolver):
    num_dim = 3
