"""State: the solution arrays on one patch.

Copy of the JAX package's ``state.py`` (numpy only), a rebuild of
reference ``src/pyclaw/state.py — class State`` (:~1-550; SURVEY.md
§2.1).  Key behavioral parity:

  - ``q`` has shape ``(num_eqn, *num_cells)`` and ``aux`` has shape
    ``(num_aux, *num_cells)`` (same logical layout as the reference).
  - ``problem_data`` is a dict of physics scalars, read once at solver
    setup (the reference's cparam common block).
  - ``index_capa`` selects the capacity-function row of ``aux`` (−1 = none).
  - derived quantities ``p``/``F`` via user hooks ``compute_p``/``compute_F``.

Mutability model: ``state.q`` is a **host numpy array** the user fills in
place (exactly like the reference).  Solvers move it to device at the start
of ``evolve_to_time`` and write the result back at the end; all per-step
compute stays on device.
"""

from __future__ import annotations

import numpy as np

from .config import default_dtype


class State:
    def __init__(self, geom, num_eqn, num_aux=0, dtype=None):
        # Accept Domain or Patch like the reference (state.py :~80).
        from .geometry import Domain, Patch
        if isinstance(geom, Domain):
            self.patch = geom.patches[0]
        elif isinstance(geom, Patch):
            self.patch = geom
        else:
            raise ValueError("State needs a Domain or Patch")

        self.num_eqn = int(num_eqn)
        self.num_aux = int(num_aux)
        self.t = 0.0
        self.problem_data = {}
        self.index_capa = -1
        self.dtype = np.dtype(default_dtype() if dtype is None
                              else np.dtype(dtype).name)

        shape = (self.num_eqn,) + tuple(self.patch.num_cells_global)
        self.q = np.zeros(shape, dtype=self.dtype)
        if self.num_aux > 0:
            self.aux = np.zeros((self.num_aux,) + tuple(self.patch.num_cells_global),
                                dtype=self.dtype)
        else:
            self.aux = None

        # Derived-quantity hooks (reference state.py :~400):
        # compute_p(state) fills state.p; compute_F(state) fills state.F.
        self.compute_p = None
        self.p = None
        self.compute_F = None
        self.F = None
        self.keep_gauges = False
        # (gauge number, t, q at the gauge's cell) per accepted step,
        # recorded by the solver; the controller writes them at the end
        self.gauge_data = []

    # ------------------------------------------------------------------
    @property
    def grid(self):
        return self.patch.grid

    @property
    def num_dim(self):
        return self.patch.num_dim

    @property
    def mp(self):
        return 0 if self.p is None else self.p.shape[0]

    @property
    def mF(self):
        return 0 if self.F is None else self.F.shape[0]

    @property
    def capa(self):
        """Capacity function array κ (view into aux) or None."""
        if self.index_capa < 0:
            return None
        return self.aux[self.index_capa]

    # ------------------------------------------------------------------
    def is_valid(self):
        """NaN / shape validity check (reference state.py — is_valid :~500)."""
        if not np.all(np.isfinite(np.asarray(self.q))):
            return False
        if self.aux is not None and not np.all(np.isfinite(np.asarray(self.aux))):
            return False
        return True

    def get_q_global(self):
        return np.asarray(self.q)

    def get_aux_global(self):
        return None if self.aux is None else np.asarray(self.aux)

    def set_num_ghost(self, num_ghost):
        # Reference allocates qbc workspaces here; the port's BC extension
        # allocates per step, so nothing to do.  Kept for API parity.
        self.num_ghost = num_ghost

    # Derived quantities -----------------------------------------------
    def get_q_p(self):
        if self.compute_p is None:
            return None
        self.p = np.zeros_like(self.q) if self.p is None else self.p
        self.compute_p(self)
        return self.p

    def __repr__(self):
        return (f"State(num_eqn={self.num_eqn}, num_aux={self.num_aux}, "
                f"t={self.t}, shape={self.q.shape})")

    def __deepcopy__(self, memo):
        import copy
        new = State(self.patch, self.num_eqn, self.num_aux, dtype=self.dtype)
        new.t = self.t
        new.q = np.array(self.q, copy=True)
        if self.aux is not None:
            new.aux = np.array(self.aux, copy=True)
        new.problem_data = copy.deepcopy(self.problem_data, memo)
        new.index_capa = self.index_capa
        new.compute_p = self.compute_p
        new.compute_F = self.compute_F
        return new
