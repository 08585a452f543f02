"""Fortran-binary frame reader (fort.bXXXX).

Copy of the JAX package's ``fileio/binary.py`` (numpy only; ``read_t``
from the port's ``fileio/ascii.py``), a rebuild of reference
``src/pyclaw/fileio/binary.py`` (:~1-150; SURVEY.md §2.5): READ-ONLY support for raw double-precision dumps produced by
AMRClaw/GeoClaw (fort.bXXXX alongside an ascii fort.tXXXX header and a
fort.qXXXX patch-header file).  Single-patch only.
"""

from __future__ import annotations

import os

import numpy as np

from .ascii import read_t


def read(solution, frame, path, file_prefix="fort", read_aux=False,
         options=None):
    from ..geometry import Dimension, Domain, Patch
    from ..state import State

    t, num_eqn, nstates, num_aux, num_dim, _ = read_t(frame, path,
                                                      file_prefix)
    # patch geometry from the ascii fort.q header
    qname = os.path.join(path, f"{file_prefix}.q{frame:04d}")
    vals = []
    with open(qname) as f:
        for line in f:
            parts = line.split()
            if parts:
                vals.append(parts[0])
    ncells = [int(v) for v in vals[2:2 + num_dim]]
    lowers = [float(v) for v in vals[2 + num_dim:2 + 2 * num_dim]]
    deltas = [float(v) for v in vals[2 + 2 * num_dim:2 + 3 * num_dim]]

    names = ("x", "y", "z")
    dims = [Dimension(lo, lo + d * n, n, name=names[i])
            for i, (lo, d, n) in enumerate(zip(lowers, deltas, ncells))]
    domain = Domain([Patch(dims)])
    state = State(domain, num_eqn, num_aux)
    state.t = t

    bname = os.path.join(path, f"{file_prefix}.b{frame:04d}")
    raw = np.fromfile(bname, dtype=np.float64)
    expected = num_eqn * int(np.prod(ncells))
    if raw.size != expected:
        raise ValueError(f"fort.b size {raw.size} != expected {expected}")
    state.q = np.ascontiguousarray(
        raw.reshape((num_eqn,) + tuple(ncells), order="F"))

    solution.states = [state]
    solution.domain = domain
    return solution
