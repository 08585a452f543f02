"""pyclaw_tpu_torch/util.py: the examples' command line against the JAX
package's ``run_app_from_main``."""

import os
import subprocess
import sys

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


def test_what_the_command_line_refuses():
    with pytest.raises(ValueError, match="key=value"):
        util.run_app_from_main(advection_1d.setup, ["nx"])
    with pytest.raises(NotImplementedError, match="'plotting'"):
        util.run_app_from_main(advection_1d.setup, ["htmlplot"])


def test_an_example_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    out = subprocess.run(
        [sys.executable, "-m", "pyclaw_tpu_torch.examples.euler_3d",
         "mx=8", "my=8", "mz=8", "outdir=None", "device=cpu"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    assert "'numsteps': " in out.stdout.splitlines()[-1]
