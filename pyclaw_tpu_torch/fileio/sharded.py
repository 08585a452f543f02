"""Sharded frame format: collective IO without a global gather.

Counterpart of ``pyclaw_tpu/fileio/sharded.py``, a rebuild of reference
``src/petclaw/fileio/petsc.py`` (:~1-250; SURVEY.md §2.6 seam #3, §5.8
"collective IO"): each rank of the parallel overlay writes its own block
of q into one hdf5 file, tagged with the block's global index, and
process 0 writes a JSON index carrying t / geometry / the full shard
table, which it computes from the mesh without communication.  Shard
``k`` is rank ``k`` of the mesh (C order, ``parallel/mesh.py``), as the
JAX writer numbers the shards of its devices.

The seam is ``state.q_block = (mesh, block)``, this rank's block of q on
that mesh (the counterpart of the JAX package's ``state.q_dev``): the
overlay's pull sets it after each frame's steps
(``parallel/solver.py``), and ``parallel/io.py:write_sharded`` for a
block it is given.  Without it (a serial run, or the t=0 frame before
any step) process 0 writes one shard covering everything, as the JAX
writer does for a host array.

Format on disk (frame 7, default prefix):
    shard0007.json            index: t, num_eqn, num_cells, lower, delta,
                              problem_data, shard table
    shard0007_p000.h5 ...     one dataset "q" (+"aux") per shard

aux is sliced along the spatial axes only, with all its rows: the JAX
writer and reader slice its first axis to ``num_eqn`` as well, which
drops rows of an aux with more rows than q (and the JAX reader then
fails on the port's shards of such an aux).

``read`` reassembles the global array on the host (restart path,
SURVEY.md §3.4): every process reads the full table, so a restart needs
the shard files visible on a shared filesystem (the reference's PETSc
Viewer assumption as well).  ``h5py`` is imported inside ``write`` and
``read``.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _index_name(prefix, frame):
    return f"{prefix}{frame:04d}.json"


def _shard_name(prefix, frame, k):
    return f"{prefix}{frame:04d}_p{k:03d}.h5"


def _block(slices, shape):
    starts = tuple(sl.start or 0 for sl in slices)
    stops = tuple(sl.stop if sl.stop is not None else dim
                  for sl, dim in zip(slices, shape))
    return starts, stops


def _shard_table(shape, mesh):
    """The shard table [(start, stop), ...] of an array of ``shape``
    (num_eqn, *num_cells): one block a rank of ``mesh`` in rank order, or
    one shard covering everything without a mesh."""
    if mesh is None:
        return [([0] * len(shape), list(shape))]
    table = []
    for r in range(mesh.size):
        coords = tuple(int(c) for c in np.unravel_index(r, mesh.shape))
        starts, stops = _block(mesh.block(shape[1:], coords), shape)
        table.append((list(starts), list(stops)))
    return table


def write(solution, frame, path, file_prefix="shard", write_aux=False,
          options=None, write_p=False):
    """Write this process's shard and, on process 0, the index; returns
    the index (the same on every process)."""
    import h5py

    from ..parallel.distributed import process_index

    state = solution.states[0]
    patch = solution.domain.patches[0]
    if write_p:
        raise NotImplementedError("write_p with the sharded format: compute "
                                  "p on the restart side instead")

    held = getattr(state, "q_block", None)
    mesh = None if held is None else held[0]
    shape = (state.num_eqn, *patch.num_cells_global)
    table = _shard_table(shape, mesh)
    main = (process_index() if mesh is None else mesh.rank) == 0
    aux = state.aux if write_aux else None

    def _write_one(k, starts, stops, data):
        sl = tuple(slice(a, b) for a, b in zip(starts, stops))
        with h5py.File(os.path.join(path,
                                    _shard_name(file_prefix, frame, k)),
                       "w") as f:
            f.create_dataset("q", data=data)
            if aux is not None:
                # every row of aux: the table's first axis spans q's rows
                f.create_dataset("aux", data=np.asarray(aux)[
                    (slice(None),) + sl[1:]])
            f.attrs["start"] = starts
            f.attrs["stop"] = stops

    if mesh is not None:
        _write_one(mesh.rank, *table[mesh.rank], np.asarray(held[1]))
    elif main:   # host array (e.g. the t=0 frame before any step)
        _write_one(0, *table[0], np.asarray(state.q))

    index = {
        "t": float(state.t),
        "num_eqn": state.num_eqn,
        "num_aux": state.num_aux,
        "num_cells": list(patch.num_cells_global),
        "lower": list(patch.lower_global),
        "delta": list(patch.delta),
        "problem_data": {k: v for k, v in state.problem_data.items()
                         if isinstance(v, (int, float, bool, str))},
        "shards": [{"file": _shard_name(file_prefix, frame, k),
                    "start": starts, "stop": stops}
                   for k, (starts, stops) in enumerate(table)],
    }
    if main:
        with open(os.path.join(path, _index_name(file_prefix, frame)),
                  "w") as f:
            json.dump(index, f)
    return index


def read(solution, frame, path, file_prefix="shard", read_aux=False,
         options=None):
    import h5py

    from ..geometry import Dimension, Domain
    from ..state import State

    with open(os.path.join(path, _index_name(file_prefix, frame))) as f:
        index = json.load(f)

    num_cells = index["num_cells"]
    lower = index["lower"]
    delta = index["delta"]
    dims = [Dimension(lo, lo + n * d, n, name=nm)
            for lo, n, d, nm in zip(lower, num_cells, delta,
                                    ("x", "y", "z"))]
    domain = Domain(dims)
    state = State(domain, index["num_eqn"], index["num_aux"])
    state.t = index["t"]
    state.problem_data.update(index.get("problem_data", {}))

    shape = (index["num_eqn"],) + tuple(num_cells)
    q = np.empty(shape)
    filled = np.zeros(tuple(num_cells), dtype=bool)
    aux = None
    for sh in index["shards"]:
        with h5py.File(os.path.join(path, sh["file"]), "r") as f:
            data = np.array(f["q"])
            if read_aux and "aux" in f:
                if aux is None:
                    aux = np.empty((index["num_aux"],) + tuple(num_cells))
                asl = (slice(None),) + tuple(
                    slice(a, b) for a, b in zip(sh["start"][1:],
                                                sh["stop"][1:]))
                aux[asl] = np.array(f["aux"])
        sl = tuple(slice(a, b) for a, b in zip(sh["start"], sh["stop"]))
        q[sl] = data
        filled[sl[1:]] = True
    if not filled.all():
        raise ValueError("sharded frame is incomplete (missing shards for "
                         "part of the domain)")
    state.q = q
    if aux is not None:
        state.aux = aux

    solution.states = [state]
    solution.domain = domain
    return solution
