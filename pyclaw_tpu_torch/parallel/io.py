"""Distributed frame IO: thin functional wrappers over the real backend.

Counterpart of ``pyclaw_tpu/parallel/io.py``.  The collective-IO seam
(reference ``src/petclaw/fileio/petsc.py``; SURVEY.md §2.6 seam #3,
§5.8) lives in ``pyclaw_tpu_torch.fileio.sharded`` and is wired into
Controller/Solution as ``output_format='sharded'`` /
``file_format='sharded'``.  These wrappers keep the direct array-level
API for tools and tests: where the JAX package takes a sharded
``jax.Array``, :func:`write_sharded` takes this rank's block and the
mesh it lies on.
"""

from __future__ import annotations

import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from ..fileio import sharded


def write_sharded(q_block, mesh, state, frame, path, file_prefix="shard"):
    """Write ``q_block`` (this rank's block of the global q on ``mesh``,
    ``mesh.block``; a tensor on any device or an array) as its shard, and
    on rank 0 the index; returns the index."""
    if torch.is_tensor(q_block):
        q_block = q_block.detach().cpu().numpy()
    sol = SimpleNamespace(states=[state],
                          domain=SimpleNamespace(patches=[state.patch]))
    old = getattr(state, "q_block", None)
    state.q_block = (mesh, np.asarray(q_block))
    try:
        return sharded.write(sol, frame, path, file_prefix=file_prefix)
    finally:
        state.q_block = old


def read_sharded(frame, path, file_prefix="shard"):
    """Reassemble a sharded frame -> (q_global ndarray, meta dict)."""
    from ..solution import Solution
    sol = Solution()
    sharded.read(sol, frame, path, file_prefix=file_prefix)
    with open(os.path.join(path, f"{file_prefix}{frame:04d}.json")) as f:
        meta = json.load(f)
    return sol.q, meta
