"""HDF5 frame format.

Copy of the JAX package's ``fileio/hdf5.py`` (numpy and ``h5py``, which
is imported inside ``write`` and ``read``), a rebuild of reference
``src/pyclaw/fileio/hdf5.py`` (:~1-250; SURVEY.md §2.5): one group per
patch, datasets ``q`` (and ``aux``), geometry in group attributes.  Frames double as checkpoints (q, t, geometry — complete
restart state, SURVEY.md §5.4).
"""

from __future__ import annotations

import os

import numpy as np


def _fname(prefix, frame):
    return f"{prefix}{frame:04d}.hdf5"


def write(solution, frame, path, file_prefix="claw", write_aux=False,
          options=None, write_p=False):
    import h5py
    state = solution.states[0]
    patch = solution.domain.patches[0]
    fname = os.path.join(path, _fname(file_prefix, frame))
    with h5py.File(fname, "w") as f:
        grp = f.create_group(f"patch{patch.patch_index}")
        grp.attrs["t"] = state.t
        grp.attrs["num_eqn"] = state.num_eqn
        grp.attrs["num_aux"] = state.num_aux
        grp.attrs["patch_index"] = patch.patch_index
        grp.attrs["level"] = patch.level
        grp.attrs["num_dim"] = patch.num_dim
        grp.attrs["num_cells"] = patch.num_cells_global
        grp.attrs["lower"] = patch.lower_global
        grp.attrs["delta"] = patch.delta
        grp.attrs["dim_names"] = [d.name for d in patch.dimensions]
        grp.attrs["index_capa"] = state.index_capa
        # persist problem_data scalars (restart convenience beyond the
        # reference, which requires re-setting them by hand)
        for k, v in state.problem_data.items():
            if isinstance(v, (int, float, bool)):
                grp.attrs[f"pd_{k}"] = v
        q = state.get_q_p() if write_p else np.asarray(state.q)
        grp.create_dataset("q", data=q, compression="gzip")
        if write_aux and state.aux is not None:
            grp.create_dataset("aux", data=np.asarray(state.aux),
                               compression="gzip")


def read(solution, frame, path, file_prefix="claw", read_aux=True,
         options=None):
    import h5py
    from ..geometry import Dimension, Domain, Patch
    from ..state import State

    fname = os.path.join(path, _fname(file_prefix, frame))
    with h5py.File(fname, "r") as f:
        grp = f[list(f.keys())[0]]
        num_dim = int(grp.attrs["num_dim"])
        ncells = [int(v) for v in grp.attrs["num_cells"]]
        lowers = [float(v) for v in grp.attrs["lower"]]
        deltas = [float(v) for v in grp.attrs["delta"]]
        names = [str(v) for v in grp.attrs["dim_names"]]
        dims = [Dimension(lo, lo + d * n, n, name=nm)
                for lo, d, n, nm in zip(lowers, deltas, ncells, names)]
        domain = Domain([Patch(dims)])
        state = State(domain, int(grp.attrs["num_eqn"]),
                      int(grp.attrs["num_aux"]))
        state.t = float(grp.attrs["t"])
        state.index_capa = int(grp.attrs.get("index_capa", -1))
        state.q = np.array(grp["q"])
        if read_aux and "aux" in grp:
            state.aux = np.array(grp["aux"])
        for k, v in grp.attrs.items():
            if k.startswith("pd_"):
                state.problem_data[k[3:]] = v.item() if hasattr(v, "item") else v
    solution.states = [state]
    solution.domain = domain
    return solution
