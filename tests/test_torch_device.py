"""Without a card, the port's default device raises; it never runs on the
CPU unless the caller asks for it."""

import pytest
import torch

import pyclaw_tpu_torch as pyclaw
from pyclaw_tpu_torch import config, riemann
from pyclaw_tpu_torch.examples import euler_2d_quadrants as ex


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def no_card(monkeypatch):
    """Behave as a machine without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda():
    assert config.default_device() == "cuda"


def test_default_device_solver_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="cuda"):
        pyclaw.ClawSolver2D(riemann.euler_4wave_2D)


def test_default_device_example_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.setup(mx=8, my=8, outdir=None)


def test_explicit_cpu_device_runs(no_card):
    claw = ex.setup(mx=8, my=8, outdir=None, device="cpu")
    claw.tfinal = 0.05
    claw.num_output_times = 1
    claw.run()
    assert claw.solver.device.type == "cpu"
    assert claw.solution.state.is_valid()


def test_cuda_tensor_without_card_is_not_run_on_cpu(no_card):
    """step2_rows decides by the tensor's device: a non-CPU tensor goes to
    the kernel path, which refuses what it cannot launch."""
    from pyclaw_tpu_torch.ops import tiled2d
    q = torch.zeros(4, 9, 9, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tiled2d.step2_rows(q, 0.01, 0.1, 0.1, {"gamma": 1.4}, (3,) * 4, 2)


def test_unported_options_raise():
    claw = ex.setup(mx=8, my=8, outdir=None, device="cpu")
    # dimensional_split is taken (no longer refused)
    claw.solver.dimensional_split = True
    claw.solver.setup(claw.solution)
    # before_step is taken (the host loop runs it)
    claw = ex.setup(mx=8, my=8, outdir=None, device="cpu")
    claw.solver.before_step = lambda solver, state: None
    claw.solver.setup(claw.solution)
    # SSPLMMk3 is taken (sequenced on the host, as in the JAX package)
    claw = ex.setup(mx=8, my=8, outdir=None, device="cpu",
                    solver_type="sharpclaw", time_integrator="SSPLMMk3")
    claw.solver.setup(claw.solution)
    assert claw.solver._host_sequenced
    assert not claw.solver._can_use_traced_evolve(claw.solution.state)
    # an unknown integrator raises as in the JAX package
    # (sharpclaw/solver.py:384-387)
    claw = ex.setup(mx=8, my=8, outdir=None, device="cpu",
                    solver_type="sharpclaw", time_integrator="SSP22")
    with pytest.raises(NotImplementedError,
                       match="time_integrator 'SSP22' not ported yet"):
        claw.solver.setup(claw.solution)


def test_default_device_sharpclaw_raises_without_card(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.setup(mx=8, my=8, outdir=None, solver_type="sharpclaw")


def test_explicit_cpu_device_runs_sharpclaw(no_card):
    claw = ex.setup(mx=8, my=8, outdir=None, device="cpu",
                    solver_type="sharpclaw")
    claw.tfinal = 0.05
    claw.num_output_times = 1
    claw.run()
    assert claw.solver.device.type == "cpu"
    assert claw.solution.state.is_valid()


def test_cuda_tensor_without_card_is_not_run_on_cpu_dq(no_card):
    """dq_rows decides by the tensor's device, as step2_rows does."""
    from pyclaw_tpu_torch.ops import tiled2d
    q = torch.zeros(4, 12, 12, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tiled2d.dq_rows(q, 0.01, 0.1, 0.1, {"gamma": 1.4})
    # order 7 has a kernel now (csrc/dq2_weno.cu): the device decides
    with pytest.raises(ValueError, match="unsupported device"):
        tiled2d.dq_rows(q, 0.01, 0.1, 0.1, {"gamma": 1.4}, weno_order=7,
                        num_ghost=4)
    # an order without a kernel, or a system without one, raises before
    q19 = torch.zeros(4, 21, 21, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="weno_order=19 has no kernel"):
        tiled2d.dq_rows(q19, 0.01, 0.1, 0.1, {"gamma": 1.4}, weno_order=19,
                        num_ghost=10)
    with pytest.raises(NotImplementedError, match="has no kernel"):
        tiled2d.dq_rows(q, 0.01, 0.1, 0.1, {"gamma": 1.4}, weno_order=7,
                        num_ghost=4, rp=riemann.shallow_roe_with_efix_2D)
