"""NetCDF frame format.

Copy of the JAX package's ``fileio/netcdf.py`` (numpy and scipy only), a
rebuild of reference ``src/pyclaw/fileio/netcdf.py`` (:~1-250; SURVEY.md
§2.5).  The reference uses the netCDF4 (HDF5-backed) library; both
packages write **NetCDF-3 64-bit-offset classic format** through scipy's
pure-Python implementation instead, so no netCDF4 library is needed, and
every netcdf tool chain (ncdump, xarray, netCDF4, ...) reads the files.

Layout: one file per frame ``claw{frame:04d}.nc``; global attributes carry
t / geometry / problem_data scalars; per-patch variables ``patch<i>_q``
(and ``_aux``) with dimensions ``(num_eqn, x, y, z)``.  Frames double as
checkpoints (complete restart state, SURVEY.md §5.4).
"""

from __future__ import annotations

import os

import numpy as np


def _fname(prefix, frame):
    return f"{prefix}{frame:04d}.nc"


def write(solution, frame, path, file_prefix="claw", write_aux=False,
          options=None, write_p=False):
    from scipy.io import netcdf_file
    state = solution.states[0]
    patch = solution.domain.patches[0]
    fname = os.path.join(path, _fname(file_prefix, frame))
    with netcdf_file(fname, "w", version=2) as f:
        # the JAX package's tag, so that both packages write the same bytes
        # for the same state
        f.history = "pyclaw_tpu netcdf frame"
        # scipy encodes bare python floats as NC_FLOAT; force double
        f.t = np.asarray([state.t], dtype=np.float64)
        f.num_eqn = np.int32(state.num_eqn)
        f.num_aux = np.int32(state.num_aux)
        f.num_dim = np.int32(patch.num_dim)
        f.patch_index = np.int32(patch.patch_index)
        f.level = np.int32(patch.level)
        f.num_cells = np.asarray(patch.num_cells_global, dtype=np.int32)
        f.lower = np.asarray(patch.lower_global, dtype=np.float64)
        f.delta = np.asarray(patch.delta, dtype=np.float64)
        f.dim_names = ",".join(d.name for d in patch.dimensions)
        f.index_capa = np.int32(state.index_capa)
        for k, v in state.problem_data.items():
            if isinstance(v, bool):
                setattr(f, f"pd_bool_{k}", np.int32(v))
            elif isinstance(v, int):
                setattr(f, f"pd_int_{k}", np.int32(v))
            elif isinstance(v, float):
                setattr(f, f"pd_float_{k}",
                        np.asarray([v], dtype=np.float64))

        f.createDimension("num_eqn", state.num_eqn)
        for d, n in zip(patch.dimensions, patch.num_cells_global):
            f.createDimension(d.name, n)
        dim_tuple = ("num_eqn",) + tuple(d.name for d in patch.dimensions)

        q = state.get_q_p() if write_p else np.asarray(state.q)
        vq = f.createVariable(f"patch{patch.patch_index}_q", "d", dim_tuple)
        vq[:] = np.ascontiguousarray(q, dtype=np.float64)
        if write_aux and state.aux is not None:
            f.createDimension("num_aux", state.num_aux)
            aux_tuple = ("num_aux",) + tuple(d.name
                                             for d in patch.dimensions)
            va = f.createVariable(f"patch{patch.patch_index}_aux", "d",
                                  aux_tuple)
            va[:] = np.ascontiguousarray(np.asarray(state.aux),
                                         dtype=np.float64)


def read(solution, frame, path, file_prefix="claw", read_aux=True,
         options=None):
    from scipy.io import netcdf_file

    from ..geometry import Dimension, Domain, Patch
    from ..state import State

    fname = os.path.join(path, _fname(file_prefix, frame))
    with netcdf_file(fname, "r", mmap=False) as f:
        num_dim = int(f.num_dim)
        ncells = [int(v) for v in np.atleast_1d(f.num_cells)]
        lowers = [float(v) for v in np.atleast_1d(f.lower)]
        deltas = [float(v) for v in np.atleast_1d(f.delta)]
        names = f.dim_names
        if isinstance(names, bytes):
            names = names.decode()
        names = names.split(",")
        assert len(ncells) == num_dim
        dims = [Dimension(lo, lo + d * n, n, name=nm)
                for lo, d, n, nm in zip(lowers, deltas, ncells, names)]
        domain = Domain([Patch(dims)])
        state = State(domain, int(f.num_eqn), int(f.num_aux))
        state.t = float(np.atleast_1d(f.t)[0])
        state.index_capa = int(getattr(f, "index_capa", -1))
        pidx = int(f.patch_index)
        # NetCDF stores big-endian doubles; torch takes native order only
        state.q = np.array(f.variables[f"patch{pidx}_q"][:], dtype=np.float64)
        if read_aux and f"patch{pidx}_aux" in f.variables:
            state.aux = np.array(f.variables[f"patch{pidx}_aux"][:],
                                 dtype=np.float64)
        for k in dir(f):
            if k.startswith("pd_bool_"):
                state.problem_data[k[8:]] = bool(getattr(f, k))
            elif k.startswith("pd_int_"):
                state.problem_data[k[7:]] = int(getattr(f, k))
            elif k.startswith("pd_float_"):
                state.problem_data[k[9:]] = float(
                    np.atleast_1d(getattr(f, k))[0])
    solution.states = [state]
    solution.domain = domain
    return solution
