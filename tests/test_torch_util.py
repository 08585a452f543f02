"""pyclaw_tpu_torch/util.py: the examples' command line against the JAX
package's ``run_app_from_main``."""

import os
import subprocess
import sys

import numpy as np
import pytest

from pyclaw_tpu import util as jutil
from pyclaw_tpu_torch import util
from pyclaw_tpu_torch.examples import advection_1d

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("token", ["3", "-2", "0.25", "1e-3", "True", "true",
                                   "False", "false", "None", "float32",
                                   "./_output", "sharpclaw"])
def test_values_are_read_as_the_jax_package_reads_them(token):
    got, want = util._coerce(token), jutil._coerce(token)
    assert got == want and type(got) is type(want)


def test_the_arguments_reach_setup(capsys):
    status = util.run_app_from_main(
        advection_1d.setup, ["nx=40", "outdir=None", "device=cpu",
                             "use_petsc=True", "dtype=float64"])
    assert capsys.readouterr().out.strip() == str(status)
    want = advection_1d.setup(nx=40, outdir=None, device="cpu").run()
    for key in ("numsteps", "numrejected", "cflmax", "dtmin", "dtmax",
                "cell_updates"):
        assert status[key] == want[key]


def test_what_the_command_line_refuses(tmp_path, capsys):
    with pytest.raises(ValueError, match="key=value"):
        util.run_app_from_main(advection_1d.setup, ["nx"])
    # htmlplot, once refused as 'plotting', writes the frames' pages with
    # the example's setplot (as the JAX package's command line does)
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from pyclaw_tpu_torch.examples import kpp
    out = str(tmp_path / "kpp")
    status = util.run_app_from_main(
        kpp.setup, ["mx=16", "my=16", "device=cpu", f"outdir={out}",
                    "htmlplot"], setplot=kpp.setplot)
    assert capsys.readouterr().out.strip() == str(status)
    pngs = sorted(f for f in os.listdir(os.path.join(out, "_plots"))
                  if f.endswith(".png"))
    assert pngs == [f"frame{i:04d}_q.png" for i in range(11)]


@pytest.mark.parametrize("mode,tol", [("reltol", 0.05), ("abstol", 1e-3),
                                      ("delta", 1e-3)])
def test_check_diff_matches_the_jax_package(mode, tol):
    rng = np.random.default_rng(5)
    expected = rng.standard_normal(40)
    for scale in (1e-5, 1e-2, 1.0):
        test = expected + scale * rng.standard_normal(40)
        got = util.check_diff(expected, test, **{mode: tol})
        want = jutil.check_diff(expected, test, **{mode: tol})
        assert (got is None) == (want is None)
        if got is not None:
            assert got[2] == want[2]
            np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError, match="reltol, abstol, or delta"):
        util.check_diff(expected, expected)


def test_gen_variants_and_test_app_match_the_jax_package():
    """One callable per entry of kernel_languages, as in the JAX package;
    the key is dropped before the port's example (the device picks the
    kernel), and a verifier's failure raises AssertionError."""
    seen = []

    def app(**kw):
        seen.append(kw)
        return advection_1d.setup(**kw)

    def verify(claw):
        x = claw.solution.domain.grid.x.centers
        expected = np.exp(-100.0 * (np.minimum((x - 0.75) % 1.0,
                                               1.0 - (x - 0.75) % 1.0)) ** 2)
        return util.check_diff(expected, claw.solution.q[0], reltol=0.05)

    tests = list(util.gen_variants(app, verify,
                                   kernel_languages=("xla", "pallas"),
                                   solver_type="classic", nx=64,
                                   device="cpu"))
    assert len(tests) == len(list(jutil.gen_variants(
        app, verify, kernel_languages=("xla", "pallas"), nx=64))) == 2
    for t in tests:
        assert t() is None
    assert seen == [dict(nx=64, solver_type="classic", device="cpu",
                         outdir=None)] * 2
    with pytest.raises(AssertionError, match="verification failed: "
                                             "relative error"):
        util.test_app(app, lambda claw: util.check_diff(
            np.ones(64), claw.solution.q[0], reltol=1e-3),
            dict(nx=64, device="cpu", kernel_language="xla"))


def test_an_example_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "pyclaw_tpu_torch.examples.euler_3d",
         "mx=8", "my=8", "mz=8", "outdir=None", "device=cpu"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    assert "'numsteps': " in out.stdout.splitlines()[-1]
