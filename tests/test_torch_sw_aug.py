"""The augmented 1D shallow-water solver with wetting and drying
(``sw_aug_1D``) and the dry dam break, the port against the JAX package.

* ``_rp1_sw_aug`` against the JAX function, 1e-12 relative, on seeded
  states whose interfaces take every branch of ``_sw_aug_core``: wet/wet,
  wet/dry and dry/wet (the Ritter front), a wall on either side, both
  dry, and depths below the dry tolerance that are not zero;
* the kernel's own source (``csrc/step1.cu``'s sw_aug instance: the
  bathymetry row staged beside q), compiled for the host, against the
  plain step on the same states, float32 and float64, several tiles;
* the dry dam break at nx=200 against tests/golden/dam_break_dry_1d.npz
  in float64 (1e-8), with h >= 0 in every frame and the mass conserved
  until the front reaches the boundary;
* what the wrapper refuses, and the example's dimension=2.
"""

import ctypes
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyclaw_tpu import riemann as jriemann
from pyclaw_tpu_torch import riemann as triemann
from pyclaw_tpu_torch.classic import kernels as tk
from pyclaw_tpu_torch.examples import dam_break_dry as tex
from pyclaw_tpu_torch.ops import sweep

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PARAMS = {"grav": 9.8, "dry_tolerance": 1e-5}
DRY = PARAMS["dry_tolerance"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(seed, n, dtype=np.float64):
    """Seeded (q (2, n), aux (1, n)): each cell wet (h 0.2 .. 1.2, either
    velocity), dry (h = 0) on a low bottom, dry on a high bottom (above
    any neighbour's surface: a wall), or damp (0 < h < dry_tolerance)."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, n)
    h = np.where(kind == 0, 0.2 + rng.random(n),
                 np.where(kind == 3, DRY * rng.random(n), 0.0))
    b = np.where(kind == 2, 2.0 + rng.random(n), 0.3 * rng.random(n))
    hu = h * rng.standard_normal(n)
    return (np.ascontiguousarray(np.stack([h, hu]).astype(dtype)),
            np.ascontiguousarray(b[None].astype(dtype)))


def _branches(q, aux):
    """The branches of _sw_aug_core that the interfaces of (q, aux) take."""
    h_l, h_r, b_l, b_r = q[0, :-1], q[0, 1:], aux[0, :-1], aux[0, 1:]
    wet_l, wet_r = h_l > DRY, h_r > DRY
    wall_r = ~wet_r & wet_l & (h_l + b_l <= b_r)
    wall_l = ~wet_l & wet_r & (h_r + b_r <= b_l)
    return {"wet/wet": wet_l & wet_r,
            "front right": wet_l & ~wet_r & ~wall_r,
            "front left": wet_r & ~wet_l & ~wall_l,
            "wall right": wall_r, "wall left": wall_l,
            "both dry": ~wet_l & ~wet_r,
            "damp": (h_l > 0) & ~wet_l}


def test_the_states_take_every_branch():
    q, aux = _state(0, 200)
    for name, hit in _branches(q, aux).items():
        assert hit.sum() >= 3, name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rp1_sw_aug_matches_jax(seed):
    q, aux = _state(seed, 200)
    args = (q[:, :-1], q[:, 1:], aux[:, :-1], aux[:, 1:])
    out_t = triemann.sw_aug_1D.rp(0, *map(torch.from_numpy, args), PARAMS)
    out_j = jax.jit(lambda *a: jriemann.sw_aug_1D.rp(0, *a, PARAMS))(*args)
    for a, b in zip(out_t, out_j):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
    wave, s, amdq, apdq = (a.numpy() for a in out_t)
    br = _branches(q, aux)
    # no fluctuation enters a dry wall cell; first order at fronts
    assert not amdq[:, br["wall left"]].any()
    assert not apdq[:, br["wall right"]].any()
    assert not wave[:, :, ~br["wet/wet"]].any()
    assert not s[:, br["both dry"]].any()


def test_positivity_hook_matches_jax():
    q, aux = _state(4, 50)
    ok_t = triemann.sw_aug_1D.positivity(torch.from_numpy(q), None, PARAMS)
    ok_j = jriemann.sw_aug_1D.positivity(jnp.asarray(q), None, PARAMS)
    assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))


def test_plain_step_matches_jax_step1():
    from pyclaw_tpu.classic import kernels as jk
    q, aux = _state(5, 64)
    for order, lim in ((1, 1), (2, 4)):
        args = (2e-3, 10 / 60)
        q_t, c_t = tk.step1(torch.from_numpy(q), torch.from_numpy(aux),
                            *args, triemann.sw_aug_1D.rp, PARAMS,
                            (lim, lim), order, True, -1, 2)
        q_j, c_j = jax.jit(lambda a, b: jk.step1(
            a, b, *args, jriemann.sw_aug_1D.rp, PARAMS, (lim, lim), order,
            True, -1, 2))(q, aux)
        q_j = np.asarray(q_j)
        assert np.abs(q_t.numpy() - q_j).max() <= 1e-12 * np.abs(q_j).max()
        assert abs(float(c_t) - float(c_j)) <= 1e-12 * float(c_j)


# ---- the kernel's source on the host ---------------------------------------
@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the kernel emulation")
    from pyclaw_tpu_torch.ops import _build
    lib = _build.build_host_emulation(
        "step1", str(tmp_path_factory.mktemp("step1_host")),
        opt="-O0")
    for name in ("step1_host_f32", "step1_host_f64"):
        fn = getattr(lib, name)
        fn.argtypes = sweep.STEP1_ARGTYPES
        fn.restype = ctypes.c_int
    lib.step1_blocks.argtypes = [ctypes.c_int] * 2
    lib.step1_blocks.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("n", [7, 252, 505])
@pytest.mark.parametrize("order,lim", [(1, 1), (2, 1), (2, 4)])
def test_kernel_source_on_host_matches_plain(host_kernel, order, lim, n,
                                             dtype, tol):
    rp = triemann.sw_aug_1D
    assert sweep.build_takes(host_kernel, rp)
    q, aux = _state(n + lim, n + 4, dtype)
    dx = 10.0 / n
    dt = float(dtype(2e-3 * dx))
    fn = (host_kernel.step1_host_f64 if dtype == np.float64
          else host_kernel.step1_host_f32)
    out = np.empty((2, n), dtype)
    cfl_blocks = np.full(host_kernel.step1_blocks(n + 4, 2), np.nan, dtype)
    rc = fn(q.ctypes.data, aux.ctypes.data, out.ctypes.data,
            cfl_blocks.ctypes.data, n + 4, 2, sweep.SYSTEMS_1D[rp.name], -1,
            1, ctypes.byref(ctypes.c_double(dt)), dx,
            *sweep.system_params(rp, PARAMS), order, lim, lim, 0)
    assert rc == 0 and np.isfinite(cfl_blocks).all()
    q_p, c_p = tk.step1(torch.from_numpy(q), torch.from_numpy(aux), dt, dx,
                        rp.rp, PARAMS, (lim, lim), order, True, -1, 2)
    q_p = q_p.numpy()
    assert np.abs(out - q_p).max() <= tol * np.abs(q_p).max()
    assert abs(float(cfl_blocks.max()) - float(c_p)) <= tol * float(c_p)


def test_wrapper_takes_the_system():
    assert sweep.system_params(triemann.sw_aug_1D, {"grav": 9.8}) == (
        9.8, 1e-8)
    assert sweep.AUX_ROWS_1D["sw_aug_1D"] == 1
    q, aux = _state(6, 20)
    before = sweep.step1.launches
    q_w, c_w = sweep.step1(torch.from_numpy(q), torch.from_numpy(aux), 1e-3,
                           0.05, triemann.sw_aug_1D, PARAMS, (1, 1), 2, True,
                           -1)
    assert sweep.step1.launches == before           # CPU: the plain version
    q_p, c_p = tk.step1(torch.from_numpy(q), torch.from_numpy(aux), 1e-3,
                        0.05, triemann.sw_aug_1D.rp, PARAMS, (1, 1), 2, True,
                        -1, 2)
    assert torch.equal(q_w, q_p) and float(c_w) == float(c_p)


# ---- the dry dam break ----------------------------------------------------
def test_dam_break_dry_matches_golden_and_stays_positive():
    ref = np.load(os.path.join(GOLDEN, "dam_break_dry_1d.npz"))
    claw = tex.setup(nx=200, outdir=None, device="cpu", dtype=np.float64)
    claw.keep_copy = True
    mass0 = claw.solution.q[0].sum()
    status = claw.run()
    assert abs(claw.solution.t - float(ref["t"])) < 1e-10
    q = claw.solution.q
    assert np.abs(q - ref["q"]).max() / np.abs(ref["q"]).max() <= 1e-8
    assert status["numrejected"] >= 1 and status["numsteps"] > 100
    assert len(claw.frames) == 5
    for frame in claw.frames:
        assert frame.q[0].min() >= 0.0
    # the water has not left through the ends by the first frame
    assert abs(claw.frames[1].q[0].sum() - mass0) <= 1e-12 * mass0


def test_what_the_example_refuses():
    """dimension=2 (the radial analog on sw_aug_2D), refused before its
    system was ported, runs: h >= 0 in every frame, and the JAX example's
    steps and q."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "examples"))
    import dam_break_dry as jex
    claw = tex.setup(nx=16, dimension=2, outdir=None, device="cpu",
                     dtype=np.float64)
    jclaw = jex.setup(nx=16, dimension=2, outdir=None)
    claw.tfinal = jclaw.tfinal = 0.5
    assert claw.run()["numsteps"] == jclaw.run()["numsteps"]
    assert claw.solver.transverse_waves == 0
    for frame in claw.frames:
        assert frame.q[0].min() >= 0.0
    q_j = np.asarray(jclaw.solution.q)
    assert np.abs(claw.solution.q - q_j).max() <= 1e-12 * np.abs(q_j).max()
