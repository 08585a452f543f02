"""Card-only tests: the CUDA kernel against its plain PyTorch version at
small shapes.  Whether a card is present is decided inside the fixture,
so every process collects the same tests; without a card they skip.

    python -m pytest --noconftest tests/test_torch_gpu.py -q   # with a card
"""

import numpy as np
import pytest
import torch

from pyclaw_tpu_torch import bc
from pyclaw_tpu_torch.classic import soa
from pyclaw_tpu_torch.ops import tiled2d
from pyclaw_tpu_torch.riemann import euler

PARAMS = {"gamma": 1.4}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _qbc(seed, nx, ny, dtype, dev):
    rng = np.random.default_rng(seed)
    rho = 0.5 + rng.random((nx, ny))
    u, v = rng.standard_normal((nx, ny)), rng.standard_normal((nx, ny))
    p = 0.5 + rng.random((nx, ny))
    q = np.stack([rho, rho * u, rho * v, p / 0.4 + 0.5 * rho * (u * u + v * v)])
    q = torch.as_tensor(q, dtype=dtype, device=dev)
    return bc.extend(q, 2, [bc.BC.extrap] * 2, [bc.BC.wall] * 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,ny,order,tw,lim", [
    (80, 80, 2, 2, 3), (100, 37, 2, 1, 4), (33, 17, 1, 0, 10),
    (5, 130, 2, 2, 10)])
def test_kernel_matches_plain(card, nx, ny, order, tw, lim, dtype):
    qbc = _qbc(nx + ny, nx, ny, dtype, card)
    dt = float(np.dtype(str(dtype).split(".")[1]).type(0.2 / max(nx, ny)))
    before = tiled2d.step2_rows.launches
    qk, ck = tiled2d.step2_rows(qbc, dt, 1 / nx, 1 / ny, PARAMS, (lim,) * 4,
                                order, transverse_waves=tw)
    torch.cuda.synchronize()
    assert tiled2d.step2_rows.launches == before + 1
    qp, cp = soa.step2_soa(qbc, dt, 1 / nx, 1 / ny, euler._rpn2_euler_soa,
                           euler._rpt2_euler_soa, PARAMS, (lim,) * 4, order,
                           2, tw, euler._prefactor_euler_2d_soa)
    assert qk.dtype == dtype and qk.shape == (4, nx, ny)
    rel = float((qk - qp).abs().max() / qp.abs().max())
    assert rel <= TOL[dtype]
    assert abs(float(ck) - float(cp)) <= TOL[dtype] * float(cp)


@pytest.mark.gpu
def test_kernel_rejects_noncontiguous(card):
    qbc = _qbc(1, 16, 16, torch.float64, card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tiled2d.step2_rows(qbc, 1e-3, 0.1, 0.1, PARAMS, (3,) * 4, 2)
