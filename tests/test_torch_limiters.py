"""Every TVD limiter id (0-21) of the port against the JAX package's, over
a theta/nu grid, to 1e-15."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu.limiters import tvd as jtvd
from pyclaw_tpu_torch.limiters import tvd as ttvd


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _grid():
    theta = np.concatenate([np.linspace(-3.0, 5.0, 161),
                            [0.0, 1.0, -1.0, 2.0, 1e-12, -1e-12]])
    nu = np.array([0.0, 1e-9, 0.05, 0.3, 0.5, 0.8, 0.99, 1.0, 1.2])
    return np.meshgrid(theta, nu, indexing="ij")


def test_cfl_limiter_ids_match():
    assert ttvd.CFL_LIMITER_IDS == jtvd.CFL_LIMITER_IDS


@pytest.mark.parametrize("lid", range(22))
def test_phi_matches_jax(lid):
    theta, nu = _grid()
    if lid in jtvd.CFL_LIMITER_IDS:
        ref = np.asarray(jtvd._phi_cfl(lid, jnp.asarray(theta),
                                       jnp.asarray(nu)))
    else:
        ref = np.asarray(jtvd._phi(lid, jnp.asarray(theta)))
    got = ttvd.limiter_phi_one(lid, torch.from_numpy(theta),
                               torch.from_numpy(nu)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-15, atol=1e-15)


def test_unknown_id_raises():
    with pytest.raises(NotImplementedError):
        ttvd.limiter_phi_one(22, torch.zeros(3), torch.zeros(3))
