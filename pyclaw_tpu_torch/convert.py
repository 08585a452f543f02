"""Carry a run across from plain numpy and dicts.

Builds the port's :class:`Solution` from arrays and copies a solver's
settings, so a run of the JAX package and a run of this one can start
from the same state.  Nothing here imports the JAX package: the inputs
are numpy arrays, numbers and dicts (``solver_settings`` reads the
attributes of any solver object by name).
"""

from __future__ import annotations

import numpy as np

from .geometry import Domain
from .solution import Solution
from .state import State

SETTINGS = ("limiters", "order", "transverse_waves", "bc_lower",
            "bc_upper", "aux_bc_lower", "aux_bc_upper", "fwave", "cfl_max",
            "cfl_desired", "dt_initial", "dt_max", "dt_variable",
            "max_steps", "time_integrator", "weno_order", "lim_type",
            "char_decomp", "dimensional_split", "use_soa", "tvd_limiter",
            "a", "b", "c", "lmm_steps", "lmm_alpha", "lmm_beta",
            "tfluct_solver")


def solution_from_arrays(q, problem_data, lower, upper, num_cells, t=0.0,
                         aux=None, index_capa=-1):
    """Solution on Domain(lower, upper, num_cells) holding a copy of
    ``q`` (num_eqn, *num_cells), in q's dtype, at time ``t``; with ``aux``
    (num_aux, *num_cells) a copy of it in q's dtype, and ``index_capa``
    its capacity row (-1: none)."""
    q = np.asarray(q)
    domain = Domain(list(lower), list(upper), list(num_cells))
    if tuple(q.shape[1:]) != tuple(domain.patch.num_cells_global):
        raise ValueError(f"q shape {q.shape} does not match num_cells "
                         f"{num_cells}")
    num_aux = 0 if aux is None else np.asarray(aux).shape[0]
    state = State(domain, q.shape[0], num_aux, dtype=q.dtype)
    state.q = np.array(q, copy=True)
    if aux is not None:
        aux = np.asarray(aux)
        if aux.shape[1:] != q.shape[1:]:
            raise ValueError(f"aux shape {aux.shape} does not match q "
                             f"shape {q.shape}")
        state.aux = np.array(aux, dtype=q.dtype, copy=True)
    state.index_capa = int(index_capa)
    state.t = float(t)
    state.problem_data = {k: (v.item() if isinstance(v, np.generic) else v)
                          for k, v in problem_data.items()}
    return Solution(state, domain)


def solver_settings(solver):
    """The settings of ``solver`` (any object with these attributes) as a
    plain dict of Python values.  A ``tfluct`` hook is a function of the
    other package's arrays and is not carried: the caller sets the
    port's own."""
    out = {}
    for key in SETTINGS:
        if hasattr(solver, key):
            val = getattr(solver, key)
            out[key] = list(val) if isinstance(val, (list, tuple)) else val
    return out


def apply_solver_settings(solver, settings):
    """Set each key of ``settings`` (see :data:`SETTINGS`) on ``solver``;
    returns the solver."""
    unknown = set(settings) - set(SETTINGS)
    if unknown:
        raise ValueError(f"unknown solver settings {sorted(unknown)}")
    for key, val in settings.items():
        setattr(solver, key, list(val) if isinstance(val, (list, tuple))
                else val)
    if "dt_initial" in settings:
        solver.dt = settings["dt_initial"]
    return solver
