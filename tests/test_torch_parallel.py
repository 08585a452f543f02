"""The parallel overlay (pyclaw_tpu_torch/parallel) on the CPU: four gloo
ranks, one process each, against the port's serial run and the JAX
package's overlay.

One spawn of four ranks (``torch.multiprocessing``, the spawn start
method, a ``file://`` store) runs every case of ``CASES`` in float64 and
writes the gathered q and the step counts; inside it each rank also
checks ``halo.extend_local`` against the serial ``bc.extend`` of the
global array, the CFL reduction of a NaN, and the rank-0 frame output.
Each case must then equal the port's serial run bit for bit, and each
but ``SERIAL_ONLY`` match the JAX overlay (``pyclaw_tpu.parallel``, blocking halo form) on a mesh
of the same shape over 4 of the 8 virtual devices to 1e-12 relative,
with the same steps.  The rank function imports no JAX; JAX is imported
only inside the reference helpers.  The cases follow
tests/test_parallel.py, test_parallel_custom_bc.py and
test_pallas_distributed.py.
"""

import importlib.util
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import pyclaw_tpu_torch
from pyclaw_tpu_torch import bc as tbc
from pyclaw_tpu_torch import convert, parallel, util
from pyclaw_tpu_torch.examples import acoustics_3d_heterogeneous as tacou3d
from pyclaw_tpu_torch.examples import euler_1d_shocktube as tsod
from pyclaw_tpu_torch.examples import euler_2d_quadrants as tquad
from pyclaw_tpu_torch.examples import euler_3d as teuler3d
from pyclaw_tpu_torch.parallel import halo
from pyclaw_tpu_torch.parallel import mesh as tmesh

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
RANKS = 4
SPAWN_LIMIT_S = 240


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---- the cases: one setup function for the three packages -------------
#
# ``pkg`` is pyclaw_tpu_torch or pyclaw_tpu, ``ex`` the package's example
# module (or None), ``solver(cls, rp)`` makes the solver: serial, the
# port's overlay or the JAX overlay.

def _controller(pkg, solver, sol, tfinal):
    claw = pkg.Controller()
    claw.solution, claw.solver = sol, solver
    claw.tfinal, claw.num_output_times = tfinal, 1
    claw.output_format = None
    return claw


def _acoustics_1d(bc):
    def build(pkg, ex, solver):
        s = solver("ClawSolver1D", pkg.riemann.acoustics_1D)
        domain = pkg.Domain([0.0], [1.0], [128])
        state = pkg.State(domain, 2)
        state.problem_data.update(rho=1.0, bulk=1.0, zz=1.0, cc=1.0, u=1.0)
        x = domain.grid.x.centers
        state.q[0, :] = np.exp(-100.0 * (x - 0.5) ** 2)
        state.q[1, :] = 0.0
        s.all_bcs = bc
        return _controller(pkg, s, pkg.Solution(state, domain), 0.2)
    return build


def _acoustics_2d(bc):
    def build(pkg, ex, solver):
        s = solver("ClawSolver2D", pkg.riemann.acoustics_2D)
        domain = pkg.Domain([-1.0, -1.0], [1.0, 1.0], [64, 64])
        state = pkg.State(domain, 3)
        state.problem_data.update(rho=1.0, bulk=4.0, zz=2.0, cc=2.0)
        x, y = domain.grid.c_centers
        r = np.sqrt(x ** 2 + y ** 2)
        state.q[0] = np.where(np.abs(r - 0.5) <= 0.2,
                              1.0 + np.cos(np.pi * (r - 0.5) / 0.2), 0.0)
        state.q[1:] = 0.0
        s.all_bcs = bc
        s.limiters = [4]
        s.transverse_waves = 2
        return _controller(pkg, s, pkg.Solution(state, domain), 0.1)
    return build


def _from_example(cls, rp, tfinal, dt_initial=None, **kw):
    """The package's example, its solver swapped for ``solver(cls, rp)``
    with the same settings (and ``dt_initial`` when given)."""
    def build(pkg, ex, solver):
        dev = {"device": "cpu"} if pkg is pyclaw_tpu_torch else {}
        claw = ex.setup(outdir=None, **kw, **dev)
        s = solver(cls, getattr(pkg.riemann, rp))
        convert.apply_solver_settings(s, convert.solver_settings(claw.solver))
        if dt_initial is not None:
            convert.apply_solver_settings(s, {"dt_initial": dt_initial})
        claw.solver = s
        claw.tfinal, claw.num_output_times = tfinal, 1
        return claw
    return build


def _shallow_aux_capacity(pkg, ex, solver):
    """Bathymetry f-waves over a bump, with a capacity row (aux[1],
    index_capa 1), wall/extrap in x and periodic in y (aux: extrap/wall
    in x)."""
    s = solver("ClawSolver2D", pkg.riemann.shallow_bathymetry_fwave_2D)
    s.fwave = True
    s.limiters = [pkg.limiters.tvd.MC]
    s.bc_lower = [pkg.BC.wall, pkg.BC.periodic]
    s.bc_upper = [pkg.BC.extrap, pkg.BC.periodic]
    s.aux_bc_lower = [pkg.BC.extrap, pkg.BC.periodic]
    s.aux_bc_upper = [pkg.BC.wall, pkg.BC.periodic]
    domain = pkg.Domain([-1.0, -1.0], [1.0, 1.0], [32, 32])
    state = pkg.State(domain, 3, num_aux=2)
    state.problem_data["grav"] = 9.8
    x, y = domain.grid.c_centers
    b = 0.5 * np.exp(-10.0 * (x ** 2 + y ** 2))
    state.aux[0] = b
    state.aux[1] = 1.0 + 0.3 * np.sin(3.0 * x) * np.cos(2.0 * y)
    state.index_capa = 1
    eta = 1.0 + 0.05 * np.exp(-50.0 * ((x + 0.4) ** 2 + y ** 2))
    state.q[0] = eta - b
    state.q[1] = 0.1 * state.q[0]
    state.q[2] = 0.0
    return _controller(pkg, s, pkg.Solution(state, domain), 0.1)


INFLOW = (0.8, 0.4, 0.0)


def _inflow_lower_torch(state, dim, t, qbc, auxbc, g):
    qbc = qbc.clone()
    vals = torch.tensor(INFLOW, dtype=qbc.dtype).reshape(3, 1, 1)
    if dim == 0:
        qbc[:, :g, :] = vals
    else:
        qbc[:, :, :g] = vals
    return qbc


def _custom_bc(pkg, ex, solver):
    """An inflow through a custom lower x boundary, fixed dt (after
    tests/test_parallel_custom_bc.py)."""
    s = solver("ClawSolver2D", pkg.riemann.acoustics_2D)
    s.bc_lower = [pkg.BC.custom, pkg.BC.extrap]
    s.bc_upper = [pkg.BC.extrap, pkg.BC.extrap]
    if pkg is pyclaw_tpu_torch:
        s.user_bc_lower = _inflow_lower_torch
    else:
        import jax.numpy as jnp

        def inflow(state, dim, t, qbc, auxbc, g):
            vals = jnp.asarray(INFLOW, qbc.dtype).reshape(3, 1, 1)
            if dim == 0:
                return qbc.at[:, :g, :].set(vals)
            return qbc.at[:, :, :g].set(vals)
        s.user_bc_lower = inflow
    s.dt_initial = 5e-4
    s.dt_variable = False
    domain = pkg.Domain([0.0, 0.0], [1.0, 1.0], [32, 32])
    state = pkg.State(domain, 3)
    state.problem_data.update(rho=1.0, bulk=4.0, zz=2.0, cc=2.0)
    x, y = domain.grid.c_centers
    state.q[0] = np.exp(-60.0 * ((x - 0.4) ** 2 + (y - 0.5) ** 2))
    state.q[1:] = 0.0
    return _controller(pkg, s, pkg.Solution(state, domain), 0.02)


def _split(build):
    """``build``'s case run with dimensional splitting."""
    def split(pkg, ex, solver):
        claw = build(pkg, ex, solver)
        claw.solver.dimensional_split = True
        return claw
    return split


def _psystem_split(pkg, ex, solver):
    """The layered p-system of examples/psystem_2d.py (f-waves, MC, split:
    the record has no rpt) at 32^2 to t=0.2, without its gauges."""
    s = solver("ClawSolver2D", pkg.riemann.psystem_2D)
    s.fwave = True
    s.dimensional_split = True
    s.limiters = [pkg.limiters.tvd.MC]
    s.bc_lower = s.bc_upper = [pkg.BC.extrap, pkg.BC.wall]
    s.aux_bc_lower = s.aux_bc_upper = [pkg.BC.extrap] * 2
    domain = pkg.Domain([-1.0, -1.0], [1.0, 1.0], [32, 32])
    state = pkg.State(domain, 3, num_aux=2)
    state.problem_data["stress_relation"] = "exp"
    x, y = domain.grid.c_centers
    layer = (np.floor(4.0 * (y + 1.0)) % 2) == 0
    state.aux[0] = np.where(layer, 4.0, 1.0)
    state.aux[1] = np.where(layer, 4.0, 1.0)
    state.q[0] = 0.5 * np.exp(-50.0 * ((x - 0.2) ** 2 + y ** 2))
    state.q[1:] = 0.0
    return _controller(pkg, s, pkg.Solution(state, domain), 0.2)


def _advection_source(pkg, ex, solver):
    """Advection-reaction (examples/advection_reaction.py, classic, MC,
    Strang): a pointwise step_source, which runs on each rank's block."""
    s = solver("ClawSolver1D", pkg.riemann.advection_1D)
    s.limiters = [pkg.limiters.tvd.MC]
    s.source_split = 2
    if pkg is pyclaw_tpu_torch:
        s.step_source = lambda solver, state, q, dt: q * torch.exp(-dt)
    else:
        import jax.numpy as jnp
        s.step_source = lambda solver, state, q, dt: q * jnp.exp(-dt)
    s.all_bcs = pkg.BC.periodic
    domain = pkg.Domain([0.0], [1.0], [160])
    state = pkg.State(domain, 1)
    state.problem_data["u"] = 1.0
    x = domain.grid.x.centers
    state.q[0] = np.exp(-100.0 * (x - 0.5) ** 2)
    return _controller(pkg, s, pkg.Solution(state, domain), 0.2)


def _with(build, **attrs):
    """``build``'s case with ``attrs`` set on its solver (SharpClaw's
    options, a before_step hook)."""
    def set_attrs(pkg, ex, solver):
        claw = build(pkg, ex, solver)
        for key, val in attrs.items():
            setattr(claw.solver, key, val)
        return claw
    return set_attrs


RK4 = dict(time_integrator="RK",
           a=[[0, 0, 0, 0], [0.5, 0, 0, 0], [0, 0.5, 0, 0], [0, 0, 1.0, 0]],
           b=[1 / 6, 1 / 3, 1 / 3, 1 / 6])

# three gauges of the quadrants at 64^2 on the (2, 2) mesh: one inside
# rank 1's block, one on the corner cell (32, 32) of rank 3's, one on
# the grid's corner cell (63, 0) (rank 2's)
GAUGES = [(0.1, 0.7), (32.5 / 64, 32.5 / 64), (63.5 / 64, 0.5 / 64)]
# the cell a before_step hook damps (seeded), and by how much a step
DAMPED = tuple(int(i) for i in np.random.default_rng(21).integers(0, 64, 2))


def _damp_one_cell(solver, state):
    """before_step: damp one cell of the global q in place (the same edit
    on every rank)."""
    state.q[(slice(None),) + DAMPED] *= 0.97


def _gauges(build):
    """``build``'s case with GAUGES on its grid."""
    def with_gauges(pkg, ex, solver):
        claw = build(pkg, ex, solver)
        claw.solution.state.grid.add_gauges(GAUGES)
        return claw
    return with_gauges


BC = pyclaw_tpu_torch.BC
_QUADRANTS = _from_example("ClawSolver2D", "euler_4wave_2D", 0.1, mx=64,
                           my=64)
# name -> (setup function, mesh shape, example module name or None)
CASES = {
    **{f"acoustics_1d_{k}": (_acoustics_1d(v), (RANKS,), None)
       for k, v in (("periodic", BC.periodic), ("extrap", BC.extrap),
                    ("wall", BC.wall))},
    **{f"acoustics_2d_{k}": (_acoustics_2d(v), (2, 2), None)
       for k, v in (("periodic", BC.periodic), ("extrap", BC.extrap),
                    ("wall", BC.wall))},
    "quadrants_classic": (_QUADRANTS, (2, 2), "euler_2d_quadrants"),
    # gauges (one all_gather an accepted step) and a before_step hook on
    # the global q (the host loop's pull and push around it)
    "quadrants_gauges": (_gauges(_QUADRANTS), (2, 2), "euler_2d_quadrants"),
    "quadrants_before_step": (_with(_QUADRANTS,
                                    before_step=_damp_one_cell),
                              (2, 2), "euler_2d_quadrants"),
    "quadrants_sharpclaw": (
        _from_example("SharpClawSolver2D", "euler_4wave_2D", 0.1, mx=32,
                      my=32, solver_type="sharpclaw", dt_initial=1e-3),
        (2, 2), "euler_2d_quadrants"),
    "sod_sharpclaw": (
        _from_example("SharpClawSolver1D", "euler_with_efix_1D", 0.1, nx=160,
                      solver_type="sharpclaw", dt_initial=1e-3),
        (RANKS,), "euler_1d_shocktube"),
    # the other SharpClaw options: WENO order 7, RK4 (the device loop in
    # serial), SSPLMMk3 (the host loop in both)
    "sod_weno7": (
        _with(_from_example("SharpClawSolver1D", "euler_with_efix_1D", 0.1,
                            nx=160, solver_type="sharpclaw",
                            dt_initial=1e-3), weno_order=7),
        (RANKS,), "euler_1d_shocktube"),
    "quadrants_rk4": (
        _with(_from_example("SharpClawSolver2D", "euler_4wave_2D", 0.05,
                            mx=32, my=32, solver_type="sharpclaw",
                            dt_initial=1e-3), dt_variable=False, **RK4),
        (2, 2), "euler_2d_quadrants"),
    "quadrants_ssplmmk3": (
        _from_example("SharpClawSolver2D", "euler_4wave_2D", 0.05, mx=32,
                      my=32, solver_type="sharpclaw",
                      time_integrator="SSPLMMk3", dt_initial=2e-3),
        (2, 2), "euler_2d_quadrants"),
    # the example's own dt_initial (0.1): six rejected attempts whose
    # blown-up stages reach the CFL reduction (NaN made +inf); held to the
    # serial port only (SERIAL_ONLY)
    "sod_sharpclaw_example_dt": (
        _from_example("SharpClawSolver1D", "euler_with_efix_1D", 0.1, nx=160,
                      solver_type="sharpclaw"),
        (RANKS,), "euler_1d_shocktube"),
    "euler_3d": (
        _from_example("ClawSolver3D", "euler_3D", 0.2, mx=16, my=16, mz=16),
        (2, 2, 1), "euler_3d"),
    "euler_3d_sharpclaw": (
        _from_example("SharpClawSolver3D", "euler_3D", 0.1, mx=12, my=12,
                      mz=12, solver_type="sharpclaw", dt_initial=1e-3),
        (2, 2, 1), "euler_3d"),
    "shallow_aux_capacity": (_shallow_aux_capacity, (2, 2), None),
    "custom_bc": (_custom_bc, (2, 2), None),
    # dimensional splitting: each sweep's halo exchange
    "acoustics_2d_split": (_split(_acoustics_2d(BC.wall)), (2, 2), None),
    "psystem_split": (_psystem_split, (2, 2), None),
    "acoustics_3d_split": (
        _from_example("ClawSolver3D", "vc_acoustics_3D", 0.2, mx=16, my=16,
                      mz=16, dimensional_split=True),
        (2, 2, 1), "acoustics_3d_heterogeneous"),
    "advection_source": (_advection_source, (RANKS,), None),
}

PORT_EXAMPLES = {"euler_2d_quadrants": tquad, "euler_1d_shocktube": tsod,
                 "euler_3d": teuler3d,
                 "acoustics_3d_heterogeneous": tacou3d}


def _port_claw(name, distributed):
    build, shape, exname = CASES[name]

    def solver(cls, rp):
        if distributed:
            return getattr(parallel, cls)(
                rp, mesh=parallel.make_mesh(len(shape), shape), device="cpu")
        return getattr(pyclaw_tpu_torch, cls)(rp, device="cpu")
    return build(pyclaw_tpu_torch, PORT_EXAMPLES.get(exname), solver)


def _run(claw):
    """(q, accepted steps, the next dt) of claw.run()."""
    status = claw.run()
    return np.array(claw.solution.q), status["numsteps"], claw.solver.dt


def _gauge_rows(claw):
    """The run's gauge series as rows (gauge number, t, q at the cell)."""
    return np.array([[num, t, *vals]
                     for num, t, vals in claw.solution.state.gauge_data])


# ---- what each rank runs --------------------------------------------------

def _random_global(rng, shape):
    return torch.as_tensor(rng.standard_normal(shape))


# (mesh shape, bc_lower, bc_upper) of the extend_local checks: every kind
# in 2D and 3D, on sharded and unsharded axes, with and without the wall
# reflection
HALO_CHECKS = [
    ((2, 2), [BC.periodic] * 2, [BC.periodic] * 2),
    ((2, 2), [BC.extrap] * 2, [BC.extrap] * 2),
    ((2, 2), [BC.wall] * 2, [BC.wall] * 2),
    ((2, 2), [BC.custom, BC.wall], [BC.extrap, BC.custom]),
    ((4, 1), [BC.wall, BC.periodic], [BC.extrap, BC.periodic]),
    ((2, 2, 1), [BC.wall, BC.periodic, BC.extrap],
     [BC.extrap, BC.periodic, BC.wall]),
    ((1, 2, 2), [BC.periodic, BC.wall, BC.custom],
     [BC.periodic, BC.extrap, BC.wall]),
    ((2, 1, 2), [BC.extrap, BC.periodic, BC.periodic],
     [BC.wall, BC.periodic, BC.periodic]),
]


def _halo_checks(rank):
    """max |extend_local - the matching slice of bc.extend| for each of
    HALO_CHECKS, with and without the wall reflection (g = 2 and 3)."""
    out = []
    for i, (shape, lower, upper) in enumerate(HALO_CHECKS):
        mesh = tmesh.Mesh(shape, rank)
        cells = tuple(6 * m for m in shape)
        rng = np.random.default_rng(i)
        q = _random_global(rng, (4, *cells))
        for g, reflect in ((2, True), (3, False)):
            full = tbc.extend(q, g, lower, upper, wall_reflects=reflect)
            block = mesh.block(cells)
            local = halo.extend_local(q[block].contiguous(), g, lower, upper,
                                      mesh, wall_reflects=reflect)
            want = full[(slice(None),) + tuple(
                slice(s.start, s.stop + 2 * g) for s in block[1:])]
            out.append(float((local - want).abs().max()))
    return np.array(out)


def _nan_check(rank):
    """The overlay's step on the quadrants with a NaN in one rank's block:
    (the reduced CFL, whether the step is accepted) on this rank."""
    claw = _port_claw("quadrants_classic", True)
    solver, sol = claw.solver, claw.solution
    solver.setup(sol)
    if rank == 2:
        block = solver.mesh.block(sol.state.patch.num_cells_global)
        sol.state.q[block][0, 3, 4] = np.nan
    solver._push(sol.state)
    _, cfl = solver._step_fn(solver._q_dev, None, 1e-3, 0.0)
    cfl = float(cfl)
    return np.array([cfl, float(solver.accept_reject_step(cfl))])


def _frames(rank, outdir):
    """acoustics 2D through parallel.Controller, ascii frames into this
    rank's own directory."""
    claw = _port_claw("acoustics_2d_periodic", True)
    ctrl = parallel.Controller()
    ctrl.solution, ctrl.solver = claw.solution, claw.solver
    ctrl.tfinal, ctrl.num_output_times = 0.05, 2
    ctrl.output_format = "ascii"
    ctrl.outdir = os.path.join(outdir, f"frames_rank{rank}")
    ctrl.run()


# the sharded run (after tests/test_distributed_controller.py): acoustics
# 2D, periodic, 32^2, a fixed dt, frames at T1 and T2, with GAUGES
SHARDED_DT, T1, T2 = 5e-4, 0.01, 0.02


def _sharded_claw(solver, outdir, fmt=None, solution=None):
    """The sharded run's Controller (the overlay's when ``solver`` is an
    overlay solver), in ``fmt`` (the Controller's default when None), from
    ``solution`` when given (a restart)."""
    pkg = parallel if solver.distributed else pyclaw_tpu_torch
    solver.all_bcs = BC.periodic
    solver.dt_initial = SHARDED_DT
    solver.dt_variable = False
    if solution is None:
        domain = pyclaw_tpu_torch.Domain([0.0, 0.0], [1.0, 1.0], [32, 32])
        state = pyclaw_tpu_torch.State(domain, 3)
        state.problem_data.update(rho=1.0, bulk=4.0, zz=2.0, cc=2.0)
        x, y = domain.grid.c_centers
        state.q[0] = np.exp(-80.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
        state.q[1:] = 0.0
        domain.grid.add_gauges(GAUGES)
        solution = pyclaw_tpu_torch.Solution(state, domain)
    claw = pkg.Controller()
    claw.solver, claw.solution = solver, solution
    # frames at T1 and T2, and from a restart (at T1) the one at T2: the
    # restart's steps are then the uninterrupted run's from T1
    claw.tfinal = T2
    claw.num_output_times = round((T2 - solution.t) / T1)
    claw.outdir, claw.keep_copy = outdir, True
    if fmt is not None:
        claw.output_format = fmt
    return claw


def _sharded(rank, outdir):
    """The sharded run on the (2, 2) mesh in the overlay's default format
    into ``sharded/``, then a restart from its frame 1 to T2 into
    ``sharded_rst/``; rank 0 writes the restart's q."""
    def solver():
        return parallel.ClawSolver2D(pyclaw_tpu_torch.riemann.acoustics_2D,
                                     mesh=parallel.make_mesh(2, (2, 2)),
                                     device="cpu")
    claw = _sharded_claw(solver(), os.path.join(outdir, "sharded"))
    assert claw.output_format == "sharded"
    claw.run()
    torch.distributed.barrier()          # every rank's shards are written
    restart = pyclaw_tpu_torch.Solution(1, path=os.path.join(outdir,
                                                             "sharded"),
                                        file_format="sharded")
    rst = _sharded_claw(solver(), os.path.join(outdir, "sharded_rst"),
                        "sharded", solution=restart)
    rst.run()
    if rank == 0:
        np.save(os.path.join(outdir, "sharded_restart.npy"), rst.solution.q)


def _rank_main(rank, store, outdir):
    torch.set_num_threads(1)
    parallel.init_distributed("gloo", "file://" + store, RANKS, rank)
    try:
        for name in CASES:
            claw = _port_claw(name, True)
            q, ns, dt = _run(claw)
            if rank == 0:
                st = claw.solver.status
                np.savez(os.path.join(outdir, f"{name}.npz"), q=q, ns=ns,
                         nr=st["numrejected"], dt=dt,
                         cell_updates=st["cell_updates"],
                         gauges=_gauge_rows(claw))
        np.savez(os.path.join(outdir, f"checks_rank{rank}.npz"),
                 halo=_halo_checks(rank), nan=_nan_check(rank))
        _frames(rank, outdir)
        if importlib.util.find_spec("h5py") is not None:
            _sharded(rank, outdir)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run _rank_main on four gloo ranks once; the directory of what they
    wrote."""
    out = tmp_path_factory.mktemp("ranks")
    ctx = mp.start_processes(_rank_main,
                             args=(str(out / "store"), str(out)),
                             nprocs=RANKS, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_LIMIT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not end within {SPAWN_LIMIT_S} s")
    return out


# ---- the comparisons ------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_ranks_equal_the_serial_run(ranks, name):
    got = np.load(ranks / f"{name}.npz")
    claw = _port_claw(name, False)
    q, ns, dt = _run(claw)
    st = claw.solver.status
    assert (int(got["ns"]), int(got["nr"]), float(got["dt"])) == (
        ns, st["numrejected"], dt)
    # the global grid drives the counter on every rank
    assert int(got["cell_updates"]) == st["cell_updates"]
    assert ns > 0
    if name in SERIAL_ONLY:        # through the rejected blown-up stages
        assert st["numrejected"] > 0
    np.testing.assert_array_equal(got["q"], q)
    # the gauge series (the serial run's from the device loop's buffers,
    # the ranks' from the owners' reads), bit for bit
    gauges = _gauge_rows(claw)
    np.testing.assert_array_equal(got["gauges"], gauges)
    if name == "quadrants_gauges":
        assert gauges.shape == (3 * ns, 2 + 4)


def _jax_overlay(name):
    """(q, accepted steps, next dt, gauge rows) of the case on the JAX
    package's overlay, on a mesh of the case's shape over 4 of the 8
    virtual devices (the blocking halo form the port runs)."""
    import jax

    import pyclaw_tpu
    from pyclaw_tpu import limiters, riemann  # noqa: F401
    from pyclaw_tpu import parallel as jparallel
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    build, shape, exname = CASES[name]
    ex = None if exname is None else __import__(exname)
    assert ex is None or (os.path.dirname(os.path.realpath(ex.__file__))
                          == os.path.realpath(EXAMPLES))
    mesh = jparallel.make_mesh(len(shape), shape,
                               devices=jax.devices()[:RANKS])

    def solver(cls, rp):
        s = getattr(jparallel, cls)(rp, mesh=mesh)
        s.overlap_halo = False
        return s
    claw = build(pyclaw_tpu, ex, solver)
    return (*_run(claw), _gauge_rows(claw))


# The SharpClaw cases start at dt_initial = 1e-3: from the examples' 0.1
# the first attempts are rejected on a blown-up stage, where the JAX
# overlay's run already differs from the JAX serial run (2.8e-5 relative
# on the Sod case).  The port's serial SharpClaw run is itself 2.1e-11
# (Sod, 16 steps) and 4.5e-12 (quadrants, 4 steps) relative from the JAX
# serial run: the WENO stages' roundoff grows through the shocks
# (tests/test_torch_sharpclaw.py holds whole runs at 1e-6).  There the
# JAX overlay equals the JAX serial run bit for bit, so the ranks'
# distance from it is the serial port's own (the ranks equal the serial
# port bit for bit: test_ranks_equal_the_serial_run), held here to the
# next power of ten above it.
SERIAL_GAP = {"quadrants_sharpclaw": 1e-11, "sod_sharpclaw": 1e-10}
# the cases held to the serial port alone: from the example's dt_initial
# the JAX overlay differs from the JAX serial run (above)
SERIAL_ONLY = ("sod_sharpclaw_example_dt",)
# the cases held to the serial port alone because they are conditioned:
# WENO order 7 on the Sod tube's piecewise-constant data moves by 1.7e-7
# to 2.8e-7 under one-ulp moves of the JAX run's own initial state
# (ROADMAP.md, Queue 3; tests/test_torch_sharpclaw_options.py holds the
# serial port to that spread), so the JAX overlay's dt and q differ from
# the ranks' by more than 1e-12 (its dt by 9e-10 relative)
CONDITIONED = ("sod_weno7",)


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n not in SERIAL_ONLY + CONDITIONED])
def test_ranks_match_the_jax_overlay(ranks, name):
    got = np.load(ranks / f"{name}.npz")
    q, ns, dt, jgauges = _jax_overlay(name)
    assert int(got["ns"]) == ns
    assert abs(float(got["dt"]) - dt) <= 1e-12 * dt
    rel = np.abs(got["q"] - q).max() / np.abs(q).max()
    assert rel <= SERIAL_GAP.get(name, 1e-12)
    if name == "custom_bc":        # the inflow reached the interior
        assert abs(q[0, 0, 16]) > 1e-8
    if name == "quadrants_gauges":
        rows, jrows = got["gauges"], jgauges
        assert rows.shape == jrows.shape == (3 * ns, 6)
        np.testing.assert_array_equal(rows[:, 0], jrows[:, 0])
        assert np.abs(rows[:, 1:] - jrows[:, 1:]).max() <= 1e-12 * max(
            1.0, np.abs(jrows[:, 2:]).max())


@pytest.mark.parametrize("rank", range(RANKS))
def test_extend_local_equals_the_serial_extension(ranks, rank):
    err = np.load(ranks / f"checks_rank{rank}.npz")["halo"]
    assert err.shape == (2 * len(HALO_CHECKS),)
    assert err.max() == 0.0


def test_a_nan_on_one_rank_is_rejected_on_all(ranks):
    for rank in range(RANKS):
        cfl, accepted = np.load(ranks / f"checks_rank{rank}.npz")["nan"]
        assert cfl == np.inf and accepted == 0.0


def test_rank0_writes_the_serial_frames(ranks, tmp_path):
    claw = _port_claw("acoustics_2d_periodic", False)
    ctrl = pyclaw_tpu_torch.Controller()
    ctrl.solution, ctrl.solver = claw.solution, claw.solver
    ctrl.tfinal, ctrl.num_output_times = 0.05, 2
    ctrl.output_format = "ascii"
    ctrl.outdir = str(tmp_path)
    ctrl.run()
    want = sorted(os.listdir(tmp_path))
    assert "fort.q0002" in want
    assert sorted(os.listdir(ranks / "frames_rank0")) == want
    for name in want:
        assert ((ranks / "frames_rank0" / name).read_bytes()
                == (tmp_path / name).read_bytes())
    for rank in range(1, RANKS):
        d = ranks / f"frames_rank{rank}"
        assert not d.exists() or not os.listdir(d)


def test_sharded_frames_gauges_and_restart(ranks, tmp_path):
    """The overlay's default format on four ranks: one shard at t=0 (the
    host frame, before any step) and four a later frame, rank 0's index
    and gauge files and nothing else.  The JAX package's reader
    reassembles each frame equal to the serial port run bit for bit, the
    gauge files equal the serial run's byte for byte, and the run
    restarted from the sharded frame 1 equals the uninterrupted serial run
    (model: tests/test_distributed_controller.py:54-95)."""
    pytest.importorskip("h5py")
    import pyclaw_tpu
    from pyclaw_tpu.fileio import sharded as jsharded
    ser = _sharded_claw(
        pyclaw_tpu_torch.ClawSolver2D(pyclaw_tpu_torch.riemann.acoustics_2D,
                                      device="cpu"),
        str(tmp_path), "ascii")
    ser.run()
    d = ranks / "sharded"
    want = (["_gauges", "shard0000.json", "shard0000_p000.h5"]
            + [f"shard{f:04d}{x}" for f in (1, 2)
               for x in [".json"] + [f"_p{k:03d}.h5" for k in range(4)]])
    assert sorted(os.listdir(d)) == want
    for frame in (0, 1, 2):
        sol = pyclaw_tpu.Solution()
        jsharded.read(sol, frame, str(d))
        assert sol.t == ser.frames[frame].t
        np.testing.assert_array_equal(np.asarray(sol.q), ser.frames[frame].q)
        assert sol.state.problem_data["bulk"] == 4.0
    names = sorted(os.listdir(d / "_gauges"))
    assert names == [f"gauge{k}.txt" for k in range(3)]
    for name in names:
        assert ((d / "_gauges" / name).read_bytes()
                == (tmp_path / "_gauges" / name).read_bytes())
    assert ser.solver.status["numsteps"] == round(T2 / SHARDED_DT)
    np.testing.assert_array_equal(np.load(ranks / "sharded_restart.npy"),
                                  ser.solution.q)
    assert sorted(os.listdir(ranks / "sharded_rst"))[-1] == "shard0001_p003.h5"


# ---- checks in one process ------------------------------------------------

def test_factor_and_mesh_shapes_match_the_jax_package():
    from pyclaw_tpu.parallel.mesh import _factor
    for n in range(1, 9):
        for num_dim in (1, 2, 3):
            assert tmesh._factor(n, num_dim) == _factor(n, num_dim)
            mesh = parallel.make_mesh(num_dim, world_size=n)
            assert list(mesh.shape) == _factor(n, num_dim)
            assert mesh.axis_names == ("x", "y", "z")[:num_dim]
            assert mesh.coords == (0,) * num_dim
    with pytest.raises(ValueError, match="devices"):
        parallel.make_mesh(2, (3, 2), world_size=4)
    with pytest.raises(ValueError, match="num_dim"):
        parallel.make_mesh(2, (4,), world_size=4)


def test_mesh_coordinates_and_neighbours():
    """Ranks in C order, as the JAX package lays out its devices, and the
    ring neighbours of each axis."""
    devices = np.arange(12).reshape(3, 2, 2)
    for rank in range(12):
        m = tmesh.Mesh((3, 2, 2), rank)
        assert devices[m.coords] == rank
        for d in range(3):
            for step, got in ((1, m.upper[d]), (-1, m.lower[d])):
                c = list(m.coords)
                c[d] = (c[d] + step) % m.shape[d]
                assert got == devices[tuple(c)]
        assert m.owns(0, 0) == (m.coords[0] == 0)
        assert m.owns(0, 1) == (m.coords[0] == 2)


def _jax_refusal(cells, shape, cls="ClawSolver2D", rp="acoustics_2D"):
    import jax

    import pyclaw_tpu
    from pyclaw_tpu import riemann  # noqa: F401
    from pyclaw_tpu import parallel as jparallel
    s = getattr(jparallel, cls)(
        getattr(pyclaw_tpu.riemann, rp),
        mesh=jparallel.make_mesh(len(shape), shape,
                                 devices=jax.devices()[:RANKS]))
    domain = pyclaw_tpu.Domain([0.0] * len(cells), [1.0] * len(cells),
                               list(cells))
    state = pyclaw_tpu.State(domain, s.rp.num_eqn)
    with pytest.raises(ValueError) as err:
        s.setup(pyclaw_tpu.Solution(state, domain))
    return str(err.value)


@pytest.mark.parametrize("cells,shape", [((30, 32), (4, 1)),
                                         ((32, 6), (1, 4))])
def test_refusals_carry_the_jax_messages(cells, shape):
    s = parallel.ClawSolver2D(pyclaw_tpu_torch.riemann.acoustics_2D,
                              mesh=tmesh.Mesh(shape, 0), device="cpu")
    domain = pyclaw_tpu_torch.Domain([0.0, 0.0], [1.0, 1.0], list(cells))
    state = pyclaw_tpu_torch.State(domain, 3)
    with pytest.raises(ValueError) as err:
        s.setup(pyclaw_tpu_torch.Solution(state, domain))
    assert str(err.value) == _jax_refusal(cells, shape)
    assert "not divisible" in str(err.value) or "num_ghost" in str(err.value)


def test_init_distributed_without_a_launcher(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert parallel.init_distributed() == (0, 1)
    assert (parallel.process_index(), parallel.process_count()) == (0, 1)
    assert parallel.is_main_process()
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        parallel.init_distributed()
    with pytest.raises(ValueError, match="go together"):
        parallel.init_distributed("gloo", world_size=2)


def _one_process_overlay(name):
    """The case's serial run with the overlay's solver (no mesh given: one
    rank without a process group)."""
    claw = _port_claw(name, False)
    s = parallel.ClawSolver2D(claw.solver.rp, device="cpu")
    convert.apply_solver_settings(s, convert.solver_settings(claw.solver))
    claw.solver = s
    return claw


def test_one_process_overlay_equals_the_serial_run():
    """A world of one rank without a process group: every ghost is made
    locally, the reduction is the identity."""
    q, ns, dt = _run(_port_claw("acoustics_2d_wall", False))
    claw = _one_process_overlay("acoustics_2d_wall")
    got = _run(claw)
    s = claw.solver
    assert s.mesh.shape == (1, 1) and s.distributed
    assert not s._can_use_traced_evolve(claw.solution.state)
    assert got[1:] == (ns, dt)
    np.testing.assert_array_equal(got[0], q)


def test_the_example_runs_the_overlay_from_its_arguments(monkeypatch,
                                                         capsys):
    """examples.euler_3d's command line with use_parallel=True and no
    launcher: init_distributed is a no-op, the overlay runs on one rank
    and gives the serial run's steps."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    args = ["mx=8", "my=8", "mz=8", "outdir=None", "device=cpu"]
    util.run_app_from_main(teuler3d.setup, args + ["use_parallel=True"])
    util.run_app_from_main(teuler3d.setup, args)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and "'numsteps': " in out[0]
    steps = [line.split("'numsteps': ")[1].split(",")[0] for line in out]
    assert steps[0] == steps[1]


def test_what_the_overlay_refuses(monkeypatch, tmp_path):
    # before_step and gauges, once refused under the overlay, run: in a
    # world of one rank they give the serial run bit for bit
    q, ns, dt = _run(_port_claw("acoustics_2d_extrap", False))
    serial = _port_claw("acoustics_2d_extrap", False)
    serial.solver.before_step = _damp_one_cell
    serial.solution.state.grid.add_gauges(GAUGES)
    want = _run(serial)
    claw = _one_process_overlay("acoustics_2d_extrap")
    claw.solver.before_step = _damp_one_cell
    claw.solution.state.grid.add_gauges(GAUGES)
    got = _run(claw)
    assert got[1:] == want[1:] and not np.array_equal(want[0], q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(_gauge_rows(claw), _gauge_rows(serial))
    # a step source on the global grid stays refused, as the JAX overlay
    # has no such run (ROADMAP.md, Queue 3)
    claw = _one_process_overlay("acoustics_2d_extrap")
    claw.solver.step_source = lambda solver, state, q, dt: q
    claw.solver.step_source.global_grid = True
    with pytest.raises(NotImplementedError, match="global grid"):
        claw.run()
    # the overlay's SharpClawSolver3D runs: in a world of one rank it
    # gives the serial SharpClaw run bit for bit
    claws = [teuler3d.setup(mx=6, my=6, mz=6, outdir=None, device="cpu",
                            solver_type="sharpclaw", use_parallel=p)
             for p in (False, True)]
    assert isinstance(claws[1].solver, parallel.SharpClawSolver3D)
    got = [_run(c) for c in claws]
    assert got[0][1:] == got[1][1:] and got[0][1] >= 2
    np.testing.assert_array_equal(got[0][0], got[1][0])
    monkeypatch.setattr(halo, "_backend", lambda: "nccl")
    with pytest.raises(ValueError, match="NCCL"):
        halo.check_device("cpu")
    monkeypatch.undo()
    # 'sharded', the overlay's default format, once refused, writes the
    # frames: one shard each in a world of one rank, as the serial q
    pytest.importorskip("h5py")
    claw = _port_claw("acoustics_2d_extrap", False)
    ctrl = parallel.Controller()
    ctrl.solution, ctrl.solver = claw.solution, claw.solver
    ctrl.tfinal, ctrl.num_output_times = 0.01, 1
    ctrl.outdir = str(tmp_path)
    assert ctrl.output_format == "sharded"
    ctrl.run()
    assert sorted(os.listdir(tmp_path)) == [
        "shard0000.json", "shard0000_p000.h5", "shard0001.json",
        "shard0001_p000.h5"]
    back = pyclaw_tpu_torch.Solution(1, path=str(tmp_path),
                                     file_format="sharded")
    np.testing.assert_array_equal(back.q, ctrl.solution.q)
