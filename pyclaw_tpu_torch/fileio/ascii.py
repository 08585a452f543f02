"""Clawpack classic ascii frame format (fort.tXXXX / fort.qXXXX / fort.aXXXX).

Copy of the JAX package's ``fileio/ascii.py`` (the writer, native and
plain, and the reader), a rebuild of reference ``src/pyclaw/fileio/ascii.py`` (:~1-300; SURVEY.md
§2.5): per frame a ``fort.tXXXX`` header (t, num_eqn, nstates, num_aux,
num_dim, num_ghost) and a ``fort.qXXXX`` data file (per patch: patch_index,
AMR_level, per-dim num_cells / lower / delta, then q in column-major cell
loops, ``%18.8e`` fields).  This is the interchange format consumed by
visclaw and by the regression golden files, so field widths and line
structure follow the reference layout.
"""

from __future__ import annotations

import io
import os

import numpy as np


def _fname(prefix, frame, ext):
    return f"{prefix}.{ext}{frame:04d}"


def write(solution, frame, path, file_prefix="fort", write_aux=False,
          options=None, write_p=False):
    state = solution.states[0]
    patch = solution.domain.patches[0]

    # fort.tXXXX ------------------------------------------------------
    with open(os.path.join(path, _fname(file_prefix, frame, "t")), "w") as f:
        f.write("%18.8e     time\n" % state.t)
        f.write("%5i                  num_eqn\n" %
                (state.mp if write_p else state.num_eqn))
        f.write("%5i                  nstates\n" % len(solution.states))
        f.write("%5i                  num_aux\n" % state.num_aux)
        f.write("%5i                  num_dim\n" % patch.num_dim)
        f.write("%5i                  num_ghost\n" % 0)

    # fort.qXXXX ------------------------------------------------------
    q = state.get_q_p() if write_p else np.asarray(state.q)
    _write_data_file(os.path.join(path, _fname(file_prefix, frame, "q")),
                     patch, q)

    if write_aux and state.aux is not None:
        _write_data_file(os.path.join(path, _fname(file_prefix, frame, "a")),
                         patch, np.asarray(state.aux))


def _write_data_file(fname, patch, q):
    """Patch header + q array, the cells by the native C++ writer
    (``pyclaw_tpu_torch._native``, byte-identical to the Python loops of
    :func:`_write_data_file_plain`); a failed build of it raises."""
    from .. import _native
    hdr = io.StringIO()
    _write_patch_header(hdr, patch)
    _native.write_ascii(fname, hdr.getvalue(), q)


def _write_data_file_plain(fname, patch, q):
    """:func:`_write_data_file` by the Python loops: the plain version,
    which the tests and ``chip_smoke.py`` hold the native writer to."""
    with open(fname, "w") as f:
        _write_patch_header(f, patch)
        _write_array(f, q)


def _write_patch_header(f, patch):
    f.write("%5i                  patch_number\n" % patch.patch_index)
    f.write("%5i                  AMR_level\n" % patch.level)
    for dim in patch.dimensions:
        f.write("%5i                  m%s\n" % (dim.num_cells, dim.name))
    for dim in patch.dimensions:
        f.write("%18.8e     %slow\n" % (dim.lower, dim.name))
    for dim in patch.dimensions:
        f.write("%18.8e     d%s\n" % (dim.delta, dim.name))
    f.write("\n")


def _write_array(f, q):
    """Write q(num_eqn, *cells): one line of num_eqn fields per cell,
    first spatial index fastest; blank line after each pencil (and an extra
    one per plane in 3D), matching the reference/Fortran layout."""
    num_dim = q.ndim - 1
    if num_dim == 1:
        for i in range(q.shape[1]):
            f.write(" ".join("%18.8e" % v for v in q[:, i]) + "\n")
    elif num_dim == 2:
        for j in range(q.shape[2]):
            for i in range(q.shape[1]):
                f.write(" ".join("%18.8e" % v for v in q[:, i, j]) + "\n")
            f.write("\n")
    elif num_dim == 3:
        for k in range(q.shape[3]):
            for j in range(q.shape[2]):
                for i in range(q.shape[1]):
                    f.write(" ".join("%18.8e" % v for v in q[:, i, j, k]) + "\n")
                f.write("\n")
            f.write("\n")
    else:
        raise ValueError(f"unsupported num_dim={num_dim}")


# ----------------------------------------------------------------------
def read_t(frame, path, file_prefix="fort"):
    """Parse fort.tXXXX → (t, num_eqn, nstates, num_aux, num_dim, num_ghost).
    Mirrors reference ascii.read_t."""
    fname = os.path.join(path, _fname(file_prefix, frame, "t"))
    vals = []
    with open(fname) as f:
        for line in f:
            parts = line.split()
            if parts:
                vals.append(parts[0])
    t = float(vals[0])
    num_eqn, nstates, num_aux, num_dim, num_ghost = (int(v) for v in vals[1:6])
    return t, num_eqn, nstates, num_aux, num_dim, num_ghost


def read(solution, frame, path, file_prefix="fort", read_aux=False,
         options=None):
    from ..geometry import Dimension, Domain, Patch
    from ..state import State

    t, num_eqn, nstates, num_aux, num_dim, _ = read_t(frame, path, file_prefix)

    fname = os.path.join(path, _fname(file_prefix, frame, "q"))
    with open(fname) as f:
        lines = [ln for ln in f.read().splitlines()]

    pos = 0

    def next_tokens():
        nonlocal pos
        while pos < len(lines) and not lines[pos].split():
            pos += 1
        toks = lines[pos].split()
        pos += 1
        return toks

    int(next_tokens()[0])   # patch_number
    int(next_tokens()[0])   # AMR_level
    ncells = [int(next_tokens()[0]) for _ in range(num_dim)]
    lowers = [float(next_tokens()[0]) for _ in range(num_dim)]
    deltas = [float(next_tokens()[0]) for _ in range(num_dim)]

    names = ("x", "y", "z")
    dims = [Dimension(lo, lo + d * n, n, name=names[i])
            for i, (lo, d, n) in enumerate(zip(lowers, deltas, ncells))]
    domain = Domain([Patch(dims)])
    state = State(domain, num_eqn, num_aux)
    state.t = t

    data = []
    while pos < len(lines):
        toks = lines[pos].split()
        pos += 1
        if toks:
            data.append([float(v) for v in toks])
    arr = np.array(data)  # (ncells_total, num_eqn), first index fastest
    q = arr.T.reshape((num_eqn,) + tuple(ncells), order="F")
    state.q = np.ascontiguousarray(q)

    if read_aux and num_aux > 0:
        aname = os.path.join(path, _fname(file_prefix, frame, "a"))
        if os.path.exists(aname):
            with open(aname) as f:
                alines = f.read().splitlines()
            nonblank = [ln for ln in alines if ln.split()]
            # skip the patch header rows (2 + 3*num_dim "value name" rows)
            adata = [[float(v) for v in ln.split()]
                     for ln in nonblank[2 + 3 * num_dim:]]
            aux = np.array(adata).T.reshape((num_aux,) + tuple(ncells), order="F")
            state.aux = np.ascontiguousarray(aux)

    solution.states = [state]
    solution.domain = domain
    return solution
