"""pyclaw_tpu_torch.bc.extend must equal pyclaw_tpu.bc.extend bit for
bit, for every BC kind in 1D, 2D and 3D."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import bc as jbc
from pyclaw_tpu_torch import bc as tbc

KINDS = (tbc.BC.custom, tbc.BC.extrap, tbc.BC.periodic, tbc.BC.wall)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pairs(num_dim):
    """Per-dimension (lower, upper) kinds, periodic paired on both sides,
    cycling through every kind on every axis and side."""
    cases = []
    for lo, up in itertools.product(KINDS, KINDS):
        if (lo == tbc.BC.periodic) != (up == tbc.BC.periodic):
            continue
        cases.append(([lo] * num_dim, [up] * num_dim))
    if num_dim > 1:   # mixed kinds across axes
        cases.append(([tbc.BC.wall, tbc.BC.periodic, tbc.BC.extrap][:num_dim],
                      [tbc.BC.extrap, tbc.BC.periodic, tbc.BC.wall][:num_dim]))
    return cases


@pytest.mark.parametrize("num_dim,wall_reflects", [
    (1, True), (2, True), (3, True), (2, False)])
def test_extend_matches_jax_bitwise(num_dim, wall_reflects):
    rng = np.random.default_rng(num_dim)
    shape = ((3 + num_dim,) + (7, 5, 4)[:num_dim])
    q = rng.standard_normal(shape)
    for lower, upper in _pairs(num_dim):
        ref = np.asarray(jbc.extend(jnp.asarray(q), 2, lower, upper,
                                    wall_reflects=wall_reflects))
        got = tbc.extend(torch.from_numpy(q), 2, lower, upper,
                         wall_reflects=wall_reflects).numpy()
        assert got.shape == ref.shape
        assert np.array_equal(got, ref), (lower, upper)


def test_extend_float32_keeps_dtype():
    q = np.random.default_rng(5).standard_normal((4, 6, 3)).astype(
        np.float32)
    got = tbc.extend(torch.from_numpy(q), 2, [tbc.BC.wall] * 2,
                     [tbc.BC.extrap] * 2)
    ref = np.asarray(jbc.extend(jnp.asarray(q), 2, [jbc.BC.wall] * 2,
                                [jbc.BC.extrap] * 2))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), ref)
