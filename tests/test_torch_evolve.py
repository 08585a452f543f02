"""The device loop on the CPU: the port's ``_DeviceLoop`` (one attempted
step, run eagerly N times between host readbacks, as the card replays it
as a CUDA graph) against the JAX package's traced loop
(``_make_evolve_fn`` / ``_evolve_traced``, jitted on the CPU), in float64.

* Sod classic, Sod SharpClaw and the 2D quadrants (classic, 32^2) to a
  short tfinal in two frames: q to 1e-12 of max|q|; numsteps and t
  equal; dt, cflmax, dtmin and dtmax to 1e-12 (the two packages' steps
  agree to roundoff, and dt comes from the step's CFL);
* the clipped corner (dt_initial > tend - t, the clipped first step
  rejected, the next dt derived from the clipped value; with before_step
  from the dt before the clip, as the JAX package's host loop), max_steps
  exhausted (the same exception text), dt_variable=False;
* gauges: gauge_data against the JAX package's, the overflow warning of a
  small gauge_buffer_len, and the controllers' gauge files;
* before_step changing state.q in place, against the JAX package's host
  loop; a q the host replaced, and one it changed in place, between two
  evolve_to_time calls; the same of aux (the heterogeneous acoustics
  example at 6^3, the port alone: state.aux stays the caller's array);
* the host loop (traced_evolve=False) against the device loop: equal bits
  and counts; attempts after the loop's end change nothing;
* the guarded restore (``ops/restore.py``; ``csrc/restore.cu`` compiled
  by ``g++`` as its host emulation).
"""

import copy
import ctypes
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import pyclaw_tpu_torch
from pyclaw_tpu_torch.examples import euler_1d_shocktube as tsod
from pyclaw_tpu_torch.examples import euler_2d_quadrants as tquad
from pyclaw_tpu_torch.ops import restore

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples"))

import euler_1d_shocktube as jsod  # noqa: E402
import euler_2d_quadrants as jquad  # noqa: E402

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# name -> (JAX example setup, port example setup, kwargs, tfinal)
CASES = {
    "sod_classic": (jsod.setup, tsod.setup,
                    dict(nx=100, solver_type="classic"), 0.1),
    "sod_sharpclaw": (jsod.setup, tsod.setup,
                      dict(nx=64, solver_type="sharpclaw"), 0.05),
    "quadrants_classic": (jquad.setup, tquad.setup, dict(mx=32, my=32),
                          0.1),
}


def _pair(name, frames=2, **solver_attrs):
    """The JAX and the port controller of case ``name`` with ``frames``
    output frames, no output files, and ``solver_attrs`` on both
    solvers."""
    jsetup, tsetup, kw, tfinal = CASES[name]
    claws = (jsetup(outdir=None, **kw), tsetup(outdir=None, device="cpu",
                                               **kw))
    for claw in claws:
        claw.tfinal = tfinal
        claw.num_output_times = frames
        for k, v in solver_attrs.items():
            setattr(claw.solver, k, v)
    return claws


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _same_run(jclaw, claw, with_rejected=None):
    js, ts = jclaw.solver.status, claw.solver.status
    assert ts["numsteps"] == js["numsteps"]
    if with_rejected is not None:
        assert ts["numrejected"] == with_rejected
    assert claw.solution.t == jclaw.solution.t
    assert abs(claw.solver.dt - jclaw.solver.dt) <= TOL * jclaw.solver.dt
    for key in ("cflmax", "dtmin", "dtmax"):
        assert abs(ts[key] - js[key]) <= TOL * abs(js[key])
    assert _rel(claw.solution.q, jclaw.solution.q) <= TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_loop_matches_jax_traced_loop(name):
    jclaw, claw = _pair(name)
    jclaw.run()
    claw.run()
    _same_run(jclaw, claw)
    stats = claw.solver.loop_stats
    assert stats["frames"] == 2 and stats["captures"] == 0   # the CPU
    st = claw.solver.status
    assert stats["attempts"] == (st["numsteps"] + st["numrejected"]
                                 + stats["after_end"])
    assert stats["readbacks"] <= 5 * stats["frames"]


def test_clipped_corner_matches_jax():
    """dt_initial 0.1 > tend - t = 0.05: the first step is clipped and
    rejected, and the next dt comes from the clipped value, as in the JAX
    package's traced loop: 0.05 * 0.9 / cfl, not 0.1 * 0.9 / cfl."""
    jclaw, claw = _pair("sod_classic", frames=1)
    for c in (jclaw, claw):
        c.tfinal = 0.05
        c.solver.dt_initial = 0.1
        c.solver.max_steps = 1
    evolve = jclaw.solver
    evolve.setup(jclaw.solution)
    q, t, dt_j, ns, nr, *_ = evolve._make_evolve_fn(jclaw.solution.state)(
        jclaw.solution.state.q, None, 0.0, 0.1, 0.05)
    assert (int(ns), int(nr)) == (0, 1)
    with pytest.raises(Exception, match="accepted=0, rejected=1"):
        claw.run()
    loop = claw.solver._evolve_fn
    assert float(loop.dt) == pytest.approx(float(dt_j), rel=TOL)
    # and the whole run to 0.05 as the JAX package's
    jclaw, claw = _pair("sod_classic", frames=1)
    for c in (jclaw, claw):
        c.tfinal = 0.05
        c.solver.dt_initial = 0.1
        c.run()
    _same_run(jclaw, claw)
    assert claw.solver.status["numrejected"] >= 1


def test_each_loop_follows_the_jax_loop_of_its_rule():
    """The clipped corner (dt_initial 0.1 > tend - t = 0.05, the clipped
    first step rejected) under each dt rule.  With before_step (a no-op)
    both packages run their host loop, whose next dt comes from the dt
    before the clip (0.1 * 0.9 / cfl); the port matches the JAX host loop.
    The device loop and the host loop under traced_evolve=False (the
    device loop's host replay, held to it bit for bit) match the JAX
    traced loop, whose next dt comes from the clipped value.  The two
    rules give different runs."""
    def hook(solver, state):
        pass

    runs = {}
    for how in ("device", "traced_evolve=False", "before_step"):
        jclaw, claw = _pair("sod_classic", frames=1, dt_initial=0.1)
        if how == "traced_evolve=False":
            claw.solver.traced_evolve = False
        if how == "before_step":
            jclaw.solver.before_step = claw.solver.before_step = hook
        for c in (jclaw, claw):
            c.tfinal = 0.05
            c.run()
        _same_run(jclaw, claw)
        assert claw.solver.status["numrejected"] >= 1
        assert ((getattr(claw.solver, "_evolve_fn", None) is None)
                == (how != "device"))
        runs[how] = claw
    assert np.array_equal(runs["device"].solution.q,
                          runs["traced_evolve=False"].solution.q)
    assert runs["device"].solver.dt != runs["before_step"].solver.dt
    assert not np.array_equal(runs["device"].solution.q,
                              runs["before_step"].solution.q)


def test_max_steps_exhausted_raises_as_jax():
    messages = []
    for claw in _pair("sod_classic", frames=1, max_steps=5):
        with pytest.raises(Exception, match="Unable to reach tend") as exc:
            claw.run()
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    assert "accepted=" in messages[1] and "rejected=" in messages[1]


def test_fixed_dt_matches_jax():
    jclaw, claw = _pair("sod_classic", frames=2, dt_variable=False,
                        dt_initial=0.001)
    jclaw.run()
    claw.run()
    _same_run(jclaw, claw, with_rejected=0)
    assert claw.solver.status["numsteps"] == 100


def _gauged(claw, n):
    claw.solution.state.grid.add_gauges([(-0.2,), (0.05,), (0.3,)])
    claw.solver.gauge_buffer_len = n
    return claw


def test_gauges_match_jax():
    jclaw, claw = (_gauged(c, 2048) for c in _pair("sod_classic"))
    jclaw.run()
    claw.run()
    _same_run(jclaw, claw)
    jg, tg = jclaw.solution.state.gauge_data, claw.solution.state.gauge_data
    assert len(tg) == len(jg) == 3 * jclaw.solver.status["numsteps"]
    for (jn, jt, jv), (tn, tt, tv) in zip(jg, tg):
        assert tn == jn and abs(tt - jt) <= TOL * abs(jt)
        assert np.abs(np.asarray(tv) - np.asarray(jv)).max() <= TOL


def test_gauge_overflow_warns_as_jax(caplog):
    jclaw, claw = (_gauged(c, 4) for c in _pair("sod_classic", frames=1))
    with caplog.at_level(logging.WARNING, logger="pyclaw.solver"):
        jclaw.run()
        claw.run()
    warned = [r.getMessage() for r in caplog.records
              if "gauge buffer overflow" in r.getMessage()]
    assert len(warned) == 2 and warned[0] == warned[1]
    jg, tg = jclaw.solution.state.gauge_data, claw.solution.state.gauge_data
    assert len(tg) == len(jg) == 3 * 4
    for (jn, jt, jv), (tn, tt, tv) in zip(jg, tg):
        assert tn == jn and abs(tt - jt) <= TOL * abs(jt)
        assert np.abs(np.asarray(tv) - np.asarray(jv)).max() <= TOL


def test_gauge_files_match_jax(tmp_path):
    """The controllers write the same gauge files from the same series."""
    jclaw, claw = (_gauged(c, 2048) for c in _pair("sod_classic"))
    jclaw.run()
    texts = []
    for c, sub in ((jclaw, "jax"), (claw, "port")):
        c.outdir = str(tmp_path / sub)
        c.output_format = "ascii"
        c.solution.state.gauge_data = list(
            jclaw.solution.state.gauge_data)
        c._write_gauges()
        gdir = os.path.join(c.outdir, "_gauges")
        texts.append({n: open(os.path.join(gdir, n)).read()
                      for n in sorted(os.listdir(gdir))})
    assert sorted(texts[0]) == ["gauge0.txt", "gauge1.txt", "gauge2.txt"]
    assert texts[0] == texts[1]
    # and the port's own run writes its series there
    claw.solution.state.gauge_data = []
    claw.run()
    claw._write_gauges()
    rows = open(os.path.join(claw.outdir, "_gauges", "gauge1.txt")).read()
    assert len(rows.splitlines()) == claw.solver.status["numsteps"]


def test_before_step_matches_jax_host_loop():
    """A hook that changes state.q in place each step: the port's host
    loop against the JAX package's."""
    def hook(solver, state):
        state.q[1] *= 0.999

    jclaw, claw = _pair("sod_classic", before_step=hook)
    jclaw.run()
    claw.run()
    _same_run(jclaw, claw)
    assert getattr(claw.solver, "_evolve_fn", None) is None  # host loop


@pytest.mark.parametrize("how", ["replaced", "in_place"])
def test_host_changed_q_reaches_the_next_step(how):
    """Between two evolve_to_time calls the host replaces q, or changes it
    in place: the next call starts from it, in both packages."""
    jclaw, claw = _pair("quadrants_classic")
    for c in (jclaw, claw):
        c.solver.setup(c.solution)
        c.solver.evolve_to_time(c.solution, 0.05)
        state = c.solution.state
        if how == "replaced":
            state.q = state.q * 1.01
        else:
            state.q[0] *= 1.01
        c.solver.evolve_to_time(c.solution, 0.1)
    _same_run(jclaw, claw)
    # not the run without the change
    _, plain = _pair("quadrants_classic")
    plain.run()
    assert _rel(claw.solution.q, plain.solution.q) > 1e-4


def _het_two_calls(device, how):
    """The port's heterogeneous acoustics example at 6^3 in float64,
    evolved to t = 0.1 and then to 0.2.  Between the two calls the sound
    speed row of aux is raised by 10%: ``how`` = "replaced" (a new array),
    "in_place" (through the array the caller took before the first call),
    "fresh" (a new array of the changed values into a new State object's
    aux slot, the reference) or None (no change).  Returns (q, the
    caller's aux array, state.aux after the second call)."""
    from pyclaw_tpu_torch.examples import acoustics_3d_heterogeneous as ex
    claw = ex.setup(mx=6, my=6, mz=6, outdir=None, device=device,
                    dtype=np.float64)
    state = claw.solution.state
    held = state.aux
    claw.solver.setup(claw.solution)
    claw.solver.evolve_to_time(claw.solution, 0.1)
    if how == "replaced":
        state.aux = state.aux * np.array([1.0, 1.1])[:, None, None, None]
    elif how == "in_place":
        held[1] *= 1.1
    elif how == "fresh":
        changed = np.array(held, copy=True)
        changed[1] *= 1.1
        state.aux = changed
    claw.solver.evolve_to_time(claw.solution, 0.2)
    return np.array(state.q, copy=True), held, state.aux


@pytest.mark.parametrize("how", ["replaced", "in_place"])
def test_host_changed_aux_reaches_the_next_step(how):
    """Between two evolve_to_time calls the host replaces aux, or changes
    in place the array it held before the first: the second call steps
    with the changed aux (bit-equal to a reference that hands it a fresh
    array), and state.aux is the caller's array, not a copy."""
    q, held, aux = _het_two_calls("cpu", how)
    q_ref, _, _ = _het_two_calls("cpu", "fresh")
    q_same, _, _ = _het_two_calls("cpu", None)
    assert np.array_equal(q, q_ref)
    assert _rel(q, q_same) > 1e-6
    if how == "in_place":
        assert aux is held


@pytest.mark.parametrize("name", ["sod_classic", "quadrants_classic"])
def test_host_loop_equals_device_loop(name):
    claws = _pair(name)[1], _pair(name)[1]
    claws[0].solver.traced_evolve = False
    for c in claws:
        c.run()
    assert np.array_equal(claws[0].solution.q, claws[1].solution.q)
    s0, s1 = claws[0].solver.status, claws[1].solver.status
    for key in ("numsteps", "numrejected", "cflmax", "dtmin", "dtmax"):
        assert s0[key] == s1[key]
    assert claws[0].solver.dt == claws[1].solver.dt
    assert getattr(claws[0].solver, "_evolve_fn", None) is None


def test_attempts_after_the_end_change_nothing():
    claw = _pair("sod_classic", frames=1)[1]
    claw.run()
    loop = claw.solver._evolve_fn
    before = [t.clone() for t in (loop.current(), loop.t, loop.dt, loop.ns,
                                  loop.nr, loop.cm, loop.dmin, loop.dmax)]
    loop._attempts(3)
    after = (loop.current(), loop.t, loop.dt, loop.ns, loop.nr, loop.cm,
             loop.dmin, loop.dmax)
    for a, b in zip(before, after):
        assert torch.equal(a, b)


def test_frames_keep_their_arrays():
    """Each pull hands out a new array: an earlier frame's q is not
    overwritten by the next, and keep_copy frames differ."""
    claw = _pair("sod_classic")[1]
    claw.keep_copy = True
    claw.solver.setup(claw.solution)
    claw.solver.evolve_to_time(claw.solution, 0.05)
    q1 = claw.solution.state.q
    q1_copy = q1.copy()
    claw.solver.evolve_to_time(claw.solution, 0.1)
    assert claw.solution.state.q is not q1
    assert np.array_equal(q1, q1_copy)
    assert q1.flags.writeable


@pytest.mark.parametrize("ok", [True, False])
def test_restore_plain(ok):
    dst = torch.arange(10, dtype=torch.float64)
    src = -torch.arange(10, dtype=torch.float64)
    want = dst.clone() if ok else src.clone()
    out = restore.restore(dst, src, torch.tensor(ok))
    assert out is dst and torch.equal(dst, want)
    with pytest.raises(ValueError, match="bool 0-d"):
        restore.restore(dst, src, torch.tensor(1.0))


@pytest.fixture(scope="module")
def restore_host(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "restore", str(tmp_path_factory.mktemp("restore_host")))
    lib.restore_host.argtypes = restore.RESTORE_ARGTYPES
    lib.restore_host.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("nbytes", [4, 16, 100, 4096 + 12, 2 ** 20 + 8])
def test_restore_kernel_source_on_host(restore_host, nbytes):
    """csrc/restore.cu's grid-stride loops (16-byte chunks and the byte
    tail, on the card's grid for 132 SMs) copy every byte on a rejected
    step and none on an accepted one."""
    rng = np.random.default_rng(nbytes)
    src = rng.integers(0, 256, nbytes, dtype=np.uint8)
    for ok in (True, False):
        dst = rng.integers(0, 256, nbytes, dtype=np.uint8)
        dst0 = dst.copy()
        flag = np.array([ok])
        assert restore_host.restore_host(dst.ctypes.data, src.ctypes.data,
                                         flag.ctypes.data, nbytes) == 0
        assert np.array_equal(dst, dst0 if ok else src)


def test_solvers_take_gauges_and_before_step():
    for solver_type in ("classic", "sharpclaw"):
        claw = tquad.setup(mx=8, my=8, outdir=None, device="cpu",
                           solver_type=solver_type)
        claw.solution.state.grid.add_gauges([(0.5, 0.5)])
        claw.solver.before_step = lambda solver, state: None
        claw.solver.setup(claw.solution)
        c = copy.deepcopy(claw.solution.state)
        assert c.gauge_data == []
