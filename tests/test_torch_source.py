"""Source terms, the port against the JAX package (CPU, float64).

* ``examples/advection_reaction.py`` (q_t + u q_x = -lambda q): classic
  with ``step_source`` split Godunov (``source_split=1``) and Strang (2),
  and SharpClaw with ``dq_src``, through both packages'
  ``Controller.run``: the same accepted steps, q within 1e-12 of max|q|,
  and near the exact solution exp(-lambda t) q0(x - u t);
* the CPU device loop runs the source inside each attempted step, as the
  card's CUDA graphs do: the hook is called once (Godunov) or twice
  (Strang) an attempt, with dt a 0-d float64 tensor, and the host loop
  (``traced_evolve = False``) gives the same bits;
* ``riemann.shallow_sphere.make_sphere_source`` against the JAX package's
  hook on a seeded state, and a ``source_split`` other than 1 or 2 is
  refused at setup.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyclaw_tpu
from pyclaw_tpu.riemann import shallow_sphere as jsphere
from pyclaw_tpu_torch.examples import advection_reaction as tar
from pyclaw_tpu_torch.ops import sweep, weno
from pyclaw_tpu_torch.riemann import shallow_sphere as tsphere

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import advection_reaction as jar  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


CASES = [("classic", 1), ("classic", 2), ("sharpclaw", 2)]


@pytest.mark.parametrize("solver_type,split", CASES)
def test_advection_reaction_matches_jax(solver_type, split):
    claw = tar.setup(solver_type=solver_type, source_split=split,
                     outdir=None, device="cpu", dtype=np.float64)
    jclaw = jar.setup(solver_type=solver_type, source_split=split,
                      outdir=None)
    before = (sweep.step1.launches, weno.weno5.launches)
    status = claw.run()
    jstatus = jclaw.run()
    assert (sweep.step1.launches, weno.weno5.launches) == before
    assert status["numsteps"] == jstatus["numsteps"] >= 50
    assert claw.solution.t == pytest.approx(1.0, abs=1e-12)
    assert _rel(claw.solution.q, jclaw.solution.q) <= 1e-12
    # one period of the periodic advection: the pulse decayed by exp(-1)
    x = claw.solution.domain.grid.x.centers
    exact = np.exp(-1.0) * np.exp(-100.0 * (x - 0.5) ** 2)
    assert np.abs(claw.solution.q[0] - exact).max() < 0.02


@pytest.mark.parametrize("solver_type,split", CASES)
def test_device_loop_runs_the_source_in_each_attempt(solver_type, split):
    dts = []

    def counted(claw):
        s = claw.solver
        name = "step_source" if solver_type == "classic" else "dq_src"
        hook = getattr(s, name)

        def wrapped(*args):
            dts.append(args[3])
            return hook(*args)
        setattr(s, name, wrapped)
        return claw

    claws = [counted(tar.setup(solver_type=solver_type, source_split=split,
                               outdir=None, device="cpu", dtype=np.float64))
             for _ in range(2)]
    claws[0].solver.traced_evolve = False
    host = claws[0].run()
    n_host = len(dts)
    dts.clear()
    claws[1].run()
    stats = claws[1].solver.loop_stats
    assert stats["attempts"] == host["numsteps"] + host["numrejected"] > 0
    per = (split if solver_type == "classic" else 10)   # SSP104 stages
    assert len(dts) == per * stats["attempts"] == n_host
    assert all(isinstance(d, torch.Tensor) and d.dim() == 0
               and d.dtype == torch.float64 for d in dts)
    np.testing.assert_array_equal(claws[0].solution.q, claws[1].solution.q)


def test_sphere_source_matches_jax():
    rng = np.random.default_rng(3)
    domain = pyclaw_tpu.Domain([0.0, -1.0], [2.0 * np.pi, 1.0], [12, 10])
    h = 0.8 + 0.4 * rng.random((12, 10))
    q = np.stack([h, h * rng.standard_normal((12, 10)),
                  h * rng.standard_normal((12, 10))])
    kw = dict(radius=1.3, omega=0.5, grav=9.81)
    src_t = tsphere.make_sphere_source(domain.grid, **kw)
    src_j = jsphere.make_sphere_source(domain.grid, **kw)
    assert src_t.global_grid
    out_t = src_t(None, None, torch.from_numpy(q),
                  torch.tensor(0.05, dtype=torch.float64))
    out_j = jax.jit(lambda q: src_j(None, None, q, 0.05))(jnp.asarray(q))
    assert out_t.dtype == torch.float64
    assert _rel(out_t.numpy(), out_j) <= 1e-13


def test_source_split_is_checked():
    claw = tar.setup(source_split=3, outdir=None, device="cpu")
    with pytest.raises(ValueError, match="source_split"):
        claw.solver.setup(claw.solution)
