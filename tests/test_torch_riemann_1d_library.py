"""The 1D Riemann library of the port against the JAX package's, float64
on the CPU: the ten records that run on ``csrc/step1.cu``'s systems 6-15
(shallow_roe_with_efix_1D, shallow_hlle_1D, shallow_bathymetry_fwave_1D,
psystem_1D, vc_advection_1D, vc_advection_fwave_1D,
acoustics_variable_1D, burgers_1D, traffic_1D, mhd_1D).

* each record's metadata and hooks against the JAX record's;
* ``rp`` and every hook the record sets (``flux``, ``evec``,
  ``positivity``) on seeded states (``ops/time_kernels.py:
  library_state``: velocities of both signs, so the transonic and sign
  branches are taken) against the jitted JAX functions, to 1e-12 of each
  output's max magnitude; the p-system with both stress laws, Burgers
  with and without its entropy fix, traffic with each way of naming
  umax;
* ``classic/kernels.py:step1`` (the plain version of ``csrc/step1.cu``)
  on each record, in every variant it runs with (order 1 and 2, with and
  without a capacity function, wave and f-wave form), against the JAX
  package's ``step1``, CFL included, and on one variant each against the
  Pallas kernel ``step1_pallas`` in interpret mode;
* the wrapper's guard: on a tensor that is not on the CPU (here the
  meta device) a record without a ``step1.cu`` system raises before any
  launch, and never runs the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu.classic import kernels as jk
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.classic import kernels as tk
from pyclaw_tpu_torch.ops import sweep
from pyclaw_tpu_torch.ops.time_kernels import LIBRARY_1D, library_state

NAMES = list(LIBRARY_1D)
# (record, problem_data) of the rp and hook cases: each record's example
# values, and the other branches of the p-system, Burgers and traffic
RP_CASES = ([(name, LIBRARY_1D[name]) for name in NAMES]
            + [("psystem_1D", {"stress_relation": "linear"}),
               ("burgers_1D", {"efix": False}),
               ("traffic_1D", {"efix_umax": 1.3, "umax": 0.8}),
               ("traffic_1D", {})])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_records_match_jax():
    for name in NAMES:
        t, j = triemann.ALL[name], jriemann.ALL[name]
        assert (t.num_dim, t.num_eqn, t.num_waves) == (j.num_dim, j.num_eqn,
                                                        j.num_waves)
        for hook in ("rpt", "rptt", "flux", "evec", "positivity",
                     "rpn_soa", "prefactor"):
            assert ((getattr(t, hook) is None)
                    == (getattr(j, hook) is None)), (name, hook)
        assert t.requires == j.requires
        assert name in sweep.SYSTEMS_1D
    # every record of the JAX package, and a step1.cu system for each 1D one
    assert set(triemann.ALL) == set(jriemann.ALL)
    assert len(triemann.ALL) == 35
    assert sorted(sweep.SYSTEMS_1D.values()) == list(range(16))
    assert set(sweep.SYSTEMS_1D) == {n for n, r in jriemann.ALL.items()
                                     if r.num_dim == 1}


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    scale = np.abs(b).max()
    assert np.abs(a - b).max() <= tol * (scale if scale > 0 else 1.0)


def _interfaces(name, n, seed):
    q, aux = library_state(name, n, seed)
    j = (jnp.asarray(q[:, :-1]), jnp.asarray(q[:, 1:]),
         None if aux is None else jnp.asarray(aux[:, :-1]),
         None if aux is None else jnp.asarray(aux[:, 1:]))
    t = tuple(None if a is None else torch.from_numpy(np.array(a))
              for a in j)
    return q, aux, j, t


@pytest.mark.parametrize("name,params", RP_CASES,
                         ids=[f"{n}-{p}" for n, p in RP_CASES])
def test_rp_matches_jax(name, params):
    q, aux, jin, tin = _interfaces(name, 97, 3)
    jrp = jax.jit(lambda ql, qr, al, ar: jriemann.ALL[name].rp(
        0, ql, qr, al, ar, params))
    ref = jrp(*jin)
    out = triemann.ALL[name].rp(0, *tin, params)
    assert len(out) == len(ref) == 4
    for a, b in zip(out, ref):
        _close(a.numpy(), b)
    # the transonic and sign branches were taken
    s = np.asarray(ref[1])
    assert (s < 0).any() and (s > 0).any()


@pytest.mark.parametrize("name,params", RP_CASES,
                         ids=[f"{n}-{p}" for n, p in RP_CASES])
def test_hooks_match_jax(name, params):
    q, aux = library_state(name, 61, 5)
    qj = jnp.asarray(q)
    aj = None if aux is None else jnp.asarray(aux)
    qt = torch.from_numpy(q)
    at = None if aux is None else torch.from_numpy(aux)
    t, j = triemann.ALL[name], jriemann.ALL[name]
    ran = 0
    if j.flux is not None:
        _close(t.flux(0, qt, at, params).numpy(),
               jax.jit(lambda q: j.flux(0, q, aj, params))(qj))
        ran += 1
    if j.evec is not None:
        for a, b in zip(t.evec(0, qt, at, params),
                        jax.jit(lambda q: j.evec(0, q, aj, params))(qj)):
            _close(a.numpy(), b)
        ran += 1
    if j.positivity is not None:
        pos = np.asarray(jax.jit(lambda q: j.positivity(q, aj, params))(qj))
        assert np.array_equal(t.positivity(qt, at, params).numpy(), pos)
        ran += 1
    assert ran == sum(getattr(j, h) is not None
                      for h in ("flux", "evec", "positivity"))


def test_mhd_positivity_sees_a_negative_pressure():
    q, _ = library_state("mhd_1D", 8, 1)
    q[6, 3] = 0.0                            # energy below the magnetic
    q[0, 5] = -0.1
    ok = triemann.mhd_1D.positivity(torch.from_numpy(q), None,
                                    LIBRARY_1D["mhd_1D"]).numpy()
    assert not ok[3] and not ok[5] and ok[[0, 1, 2, 4, 6, 7]].all()


def _padded_state(name, n, seed):
    """Ghost-padded q (num_eqn, n) and aux: the record's aux rows, then a
    positive capacity row (its index is the record's aux row count)."""
    q, aux = library_state(name, n, seed)
    cap = 0.7 + 0.6 * np.random.default_rng(seed + 1).random((1, n))
    aux = cap if aux is None else np.vstack([aux, cap])
    return np.ascontiguousarray(q), np.ascontiguousarray(aux)


# every variant (capacity x form) and both orders: (order, limiter,
# capacity, f-waves); limiters MC 4, van Leer 3, minmod 1 and the
# CFL-dependent 10 (order 2 without either runs in every example route of
# tests/test_torch_1d_library_examples.py)
VARIANTS = [(1, 4, False, False), (2, 3, True, False), (2, 10, False, True),
            (2, 1, True, True)]


@pytest.mark.parametrize("variant", VARIANTS, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_plain_step1_matches_jax_step1(name, variant):
    order, lim, capa, fwave = variant
    n = 40
    q, aux = _padded_state(name, n + 4, 11 * order + lim)
    capa_row = sweep.AUX_ROWS_1D.get(name, 0) if capa else -1
    dt, dx = 0.02 / n, 1.0 / n
    params = LIBRARY_1D[name]
    rp_t, rp_j = triemann.ALL[name], jriemann.ALL[name]
    lims = (lim,) * rp_t.num_waves
    q_t, c_t = tk.step1(torch.from_numpy(q), torch.from_numpy(aux), dt, dx,
                        rp_t.rp, params, lims, order, fwave, capa_row, 2)
    q_j, c_j = jk.step1(jnp.asarray(q), jnp.asarray(aux), dt, dx, rp_j.rp,
                        params, lims, order, fwave, capa_row, 2)
    _close(q_t.numpy(), q_j)
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


@pytest.mark.parametrize("name", NAMES)
def test_plain_step1_matches_step1_pallas(name):
    from pyclaw_tpu.ops import step1_pallas
    n = 24
    q, aux = _padded_state(name, n + 4, 5)
    capa_row = sweep.AUX_ROWS_1D.get(name, 0)
    lim, fwave = 4, name in ("shallow_bathymetry_fwave_1D", "psystem_1D",
                             "vc_advection_fwave_1D")
    rp_j = jriemann.ALL[name]
    lims = (lim,) * rp_j.num_waves
    params = LIBRARY_1D[name]
    q_j, c_j = step1_pallas(jnp.asarray(q), jnp.asarray(aux), 1e-3, 1 / n,
                            rp_j.rp, params, lims, 2, fwave, capa_row, 2)
    q_t, c_t = tk.step1(torch.from_numpy(q), torch.from_numpy(aux), 1e-3,
                        1 / n, triemann.ALL[name].rp, params, lims, 2, fwave,
                        capa_row, 2)
    _close(q_t.numpy(), q_j)
    assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


def test_wrapper_refuses_a_record_without_a_system_off_the_cpu():
    """Every 1D record of the JAX package has a step1.cu system; a record
    that has none raises on a tensor off the CPU (here the meta device,
    which no kernel and no plain version takes), before any launch and
    without running the plain version; on a CPU tensor it runs the plain
    version."""
    rp = triemann.euler_with_efix_1D
    other = triemann.RiemannSolver("other_1D", 1, 3, 3, rp.rp)
    before = sweep.step1.launches
    args = (1e-3, 0.05, other, {"gamma": 1.4}, (4,) * 3, 2, False, -1)
    with pytest.raises(NotImplementedError, match="other_1D"):
        sweep.step1(torch.ones(3, 9, device="meta"), None, *args)
    with pytest.raises(NotImplementedError, match="no system"):
        sweep.build_takes(None, other)
    # a known record off the CPU and off CUDA: refused by the device check
    with pytest.raises(ValueError, match="unsupported device"):
        sweep.step1(torch.ones(3, 9, device="meta"), None, 1e-3, 0.05, rp,
                    {"gamma": 1.4}, (4,) * 3, 2, False, -1)
    q = torch.ones(3, 9, dtype=torch.float64)
    q[2] = 2.5
    out, cfl = sweep.step1(q, None, *args)
    assert out.shape == (3, 5) and sweep.step1.launches == before
