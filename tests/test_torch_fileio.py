"""pyclaw_tpu_torch/fileio and _native: every frame format against the
JAX package's, in both directions.

Each format round-trips in the port (1D/2D/3D, with and without aux and
problem_data, to the tolerances of tests/test_io.py), and in the same
test a frame the port wrote reads back through ``pyclaw_tpu.Solution``
and a frame the JAX package wrote through the port's.  The native ascii
writer is byte-identical to the port's plain (Python) writer and to the
JAX package's output; the netcdf file is byte-identical to the JAX one.
A restart from a frame continues as the JAX restart from the same frame
(f64: equal steps, 1e-12), and with a fixed dt bit for bit as the
uninterrupted run.  The sharded format on four ranks is in
tests/test_torch_parallel.py; here each rank's shard is written from one
process through ``parallel.io.write_sharded``.
"""

import os
import sys

import numpy as np
import pytest
import torch

import pyclaw_tpu_torch as pt
from pyclaw_tpu_torch import _native
from pyclaw_tpu_torch.examples import advection_1d as tadv
from pyclaw_tpu_torch.examples import euler_2d_quadrants as tquad
from pyclaw_tpu_torch.fileio import ascii as tascii
from pyclaw_tpu_torch.parallel import io as tpio
from pyclaw_tpu_torch.parallel import mesh as tmesh

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
FORMATS = ("ascii", "hdf5", "netcdf", "sharded")
# the formats that keep problem_data
KEEPS_PD = ("hdf5", "netcdf", "sharded")
PD = {"gamma": 1.4, "steps": 7, "flag": True}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax():
    import pyclaw_tpu
    return pyclaw_tpu


def _needs(fmt):
    if fmt in ("hdf5", "sharded"):
        pytest.importorskip("h5py")


def _data(num_dim, num_aux, seed=7):
    cells = {1: [32], 2: [16, 24], 3: [6, 5, 4]}[num_dim]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, *cells))
    aux = rng.standard_normal((num_aux, *cells)) if num_aux else None
    return ([0.0, -1.0, 2.0][:num_dim], [1.0, 1.0, 3.5][:num_dim], cells,
            q, aux)


def _solution(pkg, num_dim, num_aux, problem_data):
    """The same state in either package: seeded q (and aux), t=0.725."""
    lower, upper, cells, q, aux = _data(num_dim, num_aux)
    domain = pkg.Domain(lower, upper, cells)
    state = pkg.State(domain, 3, num_aux=num_aux)
    state.q[...] = q
    if num_aux:
        state.aux[...] = aux
    state.t = 0.725
    if problem_data:
        state.problem_data.update(PD)
    return pkg.Solution(state, domain)


def _check(got, want, fmt, num_aux, problem_data):
    """``got`` (read back) holds ``want``'s frame: q, aux, t, geometry and
    problem_data, to the format's tolerance (ascii is %18.8e)."""
    tol = 1e-7 if fmt == "ascii" else 0.0
    assert abs(got.t - want.t) < 1e-12
    np.testing.assert_allclose(np.asarray(got.q), np.asarray(want.q),
                               rtol=tol, atol=tol)
    if num_aux:
        np.testing.assert_allclose(np.asarray(got.aux),
                                   np.asarray(want.aux), rtol=tol, atol=tol)
    assert got.domain.num_dim == want.domain.num_dim
    gtol = 1e-7 if fmt == "ascii" else 1e-12
    for d1, d2 in zip(want.domain.grid.dimensions,
                      got.domain.grid.dimensions):
        assert d1.num_cells == d2.num_cells
        assert abs(d1.lower - d2.lower) < gtol
        assert abs(d1.delta - d2.delta) < gtol
    if problem_data and fmt in KEEPS_PD:
        for k, v in PD.items():
            got_v = got.state.problem_data[k]
            assert got_v == v and type(got_v) is type(v), (k, got_v)


def test_valid_formats_equal_the_jax_tuple():
    from pyclaw_tpu.fileio import VALID_FORMATS
    assert pt.fileio.VALID_FORMATS == VALID_FORMATS
    for fmt in VALID_FORMATS:
        assert (pt.Solution._io_module(fmt).__name__
                == f"pyclaw_tpu_torch.fileio.{fmt}")


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("num_dim", [1, 2, 3])
@pytest.mark.parametrize("num_aux,problem_data", [(0, False), (2, True)])
def test_round_trip_and_cross_reads(tmp_path, fmt, num_dim, num_aux,
                                    problem_data):
    _needs(fmt)
    jax_pkg = _jax()
    mine = _solution(pt, num_dim, num_aux, problem_data)
    theirs = _solution(jax_pkg, num_dim, num_aux, problem_data)
    kw = dict(file_format=fmt, write_aux=bool(num_aux))
    rk = dict(file_format=fmt, read_aux=bool(num_aux))
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    mine.write(3, path=port_dir, **kw)
    theirs.write(3, path=jax_dir, **kw)
    # the port's frame in the port, in the JAX package; the JAX frame in
    # the port
    _check(pt.Solution(3, path=port_dir, **rk), mine, fmt, num_aux,
           problem_data)
    _check(jax_pkg.Solution(3, path=port_dir, **rk), mine, fmt, num_aux,
           problem_data)
    _check(pt.Solution(3, path=jax_dir, **rk), theirs, fmt, num_aux,
           problem_data)
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))


def test_sharded_aux_with_more_rows_than_q(tmp_path):
    """The port keeps every row of aux in a shard; the JAX writer keeps
    num_eqn of them (its table's first axis), so it is not compared."""
    pytest.importorskip("h5py")
    sol = _solution(pt, 2, 5, False)
    sol.write(0, path=str(tmp_path), file_format="sharded", write_aux=True)
    back = pt.Solution(0, path=str(tmp_path), file_format="sharded",
                       read_aux=True)
    np.testing.assert_array_equal(back.aux, sol.aux)
    np.testing.assert_array_equal(back.q, sol.q)


def _extreme_q(shape, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape)
    q.flat[::17] *= 1e200
    q.flat[1::23] *= 1e-200
    q.flat[2::29] = -0.0
    q.flat[3::31] = np.nan
    q.flat[4::37] = np.inf
    q.flat[5::41] = -np.inf
    return q


@pytest.mark.parametrize("num_dim", [1, 2, 3])
def test_native_ascii_is_byte_identical(tmp_path, num_dim):
    """The native writer's fort.q (and fort.a) against the port's plain
    writer and the JAX package's frame, with negative zeros, huge and
    tiny magnitudes, inf and nan (model: tests/test_io.py:176)."""
    jax_pkg = _jax()
    cells = {1: [37], 2: [11, 7], 3: [5, 7, 3]}[num_dim]
    lower, upper = [0.0, -1.0, 2.0][:num_dim], [1.0, 1.0, 3.0][:num_dim]
    frames, states = [], []
    for pkg in (pt, jax_pkg):
        domain = pkg.Domain(lower, upper, cells)
        state = pkg.State(domain, 2, num_aux=1)
        state.q[...] = _extreme_q(state.q.shape)
        state.aux[...] = _extreme_q(state.aux.shape, seed=4)
        d = tmp_path / pkg.__name__
        pkg.Solution(state, domain).write(1, str(d), file_format="ascii",
                                          write_aux=True)
        frames.append(d)
        states.append(state)
    state = states[0]
    patch = state.patch
    tascii._write_data_file_plain(str(tmp_path / "plain.q"), patch, state.q)
    native = (frames[0] / "fort.q0001").read_bytes()
    assert native == (tmp_path / "plain.q").read_bytes()
    for name in ("fort.t0001", "fort.q0001", "fort.a0001"):
        assert (frames[0] / name).read_bytes() == (frames[1] / name
                                                   ).read_bytes()
    # a float32 q (a frame of an f32 run) is widened exactly, as the plain
    # writer's %18.8e widens it
    with np.errstate(over="ignore"):
        q32 = state.q.astype(np.float32)
    tascii._write_data_file(str(tmp_path / "n32.q"), patch, q32)
    tascii._write_data_file_plain(str(tmp_path / "p32.q"), patch, q32)
    assert ((tmp_path / "n32.q").read_bytes()
            == (tmp_path / "p32.q").read_bytes())


def test_netcdf_is_byte_identical(tmp_path):
    """The same state gives the same bytes in both packages (the same
    scipy writer, attributes in the same order, the JAX package's history
    tag)."""
    jax_pkg = _jax()
    for pkg in (pt, jax_pkg):
        sol = _solution(pkg, 2, 2, True)
        sol.write(4, path=str(tmp_path / pkg.__name__), file_format="netcdf",
                  write_aux=True)
    a, b = ((tmp_path / n / "claw0004.nc").read_bytes()
            for n in ("pyclaw_tpu_torch", "pyclaw_tpu"))
    assert a[:4] == b"CDF\x02" and a == b


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No fallback: a writer that cannot be built raises, at the first
    frame written."""
    bad = tmp_path / "src"
    bad.mkdir()
    (bad / "fastio.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "HERE", str(bad))
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path / "build"))
    sol = _solution(pt, 1, 0, False)
    with pytest.raises(RuntimeError, match="build of .*fastio.cpp failed"):
        sol.write(0, path=str(tmp_path / "out"), file_format="ascii")
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _native.get_io_lib()
    assert not os.path.exists(tmp_path / "build" / "libclawio.so")


def _binary_frame(path, q, frame=4):
    """A raw fort.b (f64, Fortran order) with the port's ascii headers
    (fort.t, and the fort.q whose patch header the reader takes)."""
    domain = pt.Domain([0.0, 0.0], [1.0, 1.0], list(q.shape[1:]))
    state = pt.State(domain, q.shape[0])
    state.q[...] = q
    state.t = 0.25
    state.problem_data["gamma"] = 1.4
    pt.Solution(state, domain).write(frame, path=path, file_format="ascii")
    np.asarray(q, dtype=np.float64).ravel(order="F").tofile(
        os.path.join(path, f"fort.b{frame:04d}"))


def test_binary_reads_in_both_packages_and_restarts(tmp_path):
    """A Fortran-binary frame reads back exactly in the port and in the
    JAX package, and a step from it equals the same step from the state
    in memory.  The geometry comes from the %18.8e ascii header, so the
    grid's widths are dyadic (1/32, 1/16), which the header keeps
    exactly."""
    claw = tquad.setup(mx=32, my=16, outdir=None, device="cpu",
                       dtype=np.float64)
    q0 = claw.solution.q.copy()
    _binary_frame(str(tmp_path), q0)
    got = pt.Solution(4, path=str(tmp_path), file_format="binary")
    theirs = _jax().Solution(4, path=str(tmp_path), file_format="binary")
    np.testing.assert_array_equal(got.q, q0)
    np.testing.assert_array_equal(np.asarray(theirs.q), q0)
    assert got.t == theirs.t == 0.25
    assert got.patch.num_cells_global == [32, 16]

    claw.solution.t = 0.25
    claw.solver.evolve_to_time(claw.solution)        # one step
    read = tquad.setup(mx=32, my=16, outdir=None, device="cpu",
                       dtype=np.float64)
    got.state.problem_data.update(read.solution.state.problem_data)
    read.solution = got
    read.solver.evolve_to_time(read.solution)
    assert read.solver.status["numsteps"] == 1
    assert read.solution.t == claw.solution.t
    np.testing.assert_array_equal(read.solution.q, claw.solution.q)


# (ascii keeps no problem_data, so a restart from it needs them set again)
@pytest.mark.parametrize("fmt", ["netcdf", "hdf5", "sharded"])
def test_restart_continues_as_the_jax_restart(tmp_path, fmt):
    """advection_1d (nx=64) writes frames to t=1; the port and the JAX
    package each restart from frame 5 of the port's files and run to t=1:
    the same steps, q to 1e-12 (model: tests/test_io.py:64)."""
    _needs(fmt)
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    import advection_1d as jadv
    jax_pkg = _jax()
    claw = tadv.setup(nx=64, outdir=str(tmp_path), device="cpu")
    claw.output_format = fmt
    claw.run()
    q_full = claw.solution.q.copy()
    port = tadv.setup(nx=64, outdir=None, device="cpu")
    port.solution = pt.Solution(5, path=str(tmp_path), file_format=fmt)
    status = port.run()
    theirs = jadv.setup(nx=64, outdir=None)
    theirs.solution = jax_pkg.Solution(5, path=str(tmp_path),
                                       file_format=fmt)
    # the JAX netcdf reader keeps the file's big-endian doubles, which
    # jnp.asarray refuses (a JAX-side fault, ROADMAP.md Queue 3; the
    # port's reader returns native order): the same values, native
    theirs.solution.state.q = np.asarray(theirs.solution.q,
                                         dtype=np.float64)
    jstatus = theirs.run()
    assert abs(port.solution.t - 1.0) < 1e-12
    assert status["numsteps"] == jstatus["numsteps"] > 0
    q = np.asarray(theirs.solution.q)
    assert np.abs(port.solution.q - q).max() <= 1e-12 * np.abs(q).max()
    # a restart resets dt to dt_initial: close to the run it left
    assert np.abs(port.solution.q - q_full).max() < 2e-2


def test_fixed_dt_restart_equals_the_uninterrupted_run(tmp_path):
    """With a fixed dt that divides the frame interval, the run restarted
    from netcdf frame 2 equals the uninterrupted run bit for bit (the
    device loop on the CPU)."""
    def fixed(claw):
        claw.solver.dt_variable = False
        claw.solver.dt_initial = 0.2 / 40
        claw.tfinal, claw.num_output_times = 0.4, 4
        return claw

    claw = fixed(tquad.setup(mx=32, my=32, outdir=str(tmp_path),
                             device="cpu", dtype=np.float64))
    claw.output_format = ["netcdf", "ascii"]
    claw.run()
    again = fixed(tquad.setup(mx=32, my=32, outdir=None, device="cpu",
                              dtype=np.float64))
    again.solution = pt.Solution(2, path=str(tmp_path),
                                 file_format="netcdf")
    assert again.solution.t == 0.2
    again.num_output_times = 2
    status = again.run()
    assert status["numsteps"] == 40
    assert again.solution.t == claw.solution.t
    np.testing.assert_array_equal(again.solution.q, claw.solution.q)


def test_sharded_blocks_written_rank_by_rank(tmp_path):
    """Four ranks' blocks on a (2, 2) mesh, each written through
    parallel.io.write_sharded as its rank would (one process): four shard
    files and rank 0's index, reassembled equal by the port and by the JAX
    reader."""
    pytest.importorskip("h5py")
    from pyclaw_tpu.fileio import sharded as jsharded
    sol = _solution(pt, 2, 2, True)
    state = sol.state
    cells = state.patch.num_cells_global
    for rank in (3, 1, 2, 0):
        mesh = tmesh.Mesh((2, 2), rank)
        block = torch.as_tensor(state.q[mesh.block(cells)])
        index = tpio.write_sharded(block, mesh, state, 7, str(tmp_path))
        assert os.path.exists(tmp_path / "shard0007.json") == (rank == 0)
    names = sorted(os.listdir(tmp_path))
    assert names == ["shard0007.json"] + [f"shard0007_p{k:03d}.h5"
                                          for k in range(4)]
    assert [s["start"] for s in index["shards"]] == [
        [0, 0, 0], [0, 0, 12], [0, 8, 0], [0, 8, 12]]
    q, meta = tpio.read_sharded(7, str(tmp_path))
    np.testing.assert_array_equal(q, state.q)
    assert meta == index and meta["problem_data"] == PD
    theirs = _jax().Solution()
    jsharded.read(theirs, 7, str(tmp_path))
    np.testing.assert_array_equal(np.asarray(theirs.q), state.q)
    assert getattr(state, "q_block", None) is None
