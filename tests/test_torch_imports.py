"""No file of pyclaw_tpu_torch, and not chip_smoke.py, imports jax or
pyclaw_tpu (an AST scan of every import statement, including the ones
inside functions, and of importlib calls with a literal name)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "pyclaw_tpu")


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "pyclaw_tpu_torch")):
        out += [os.path.join(dirpath, n) for n in sorted(names)
                if n.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_the_scan_sees_every_module():
    names = [os.path.relpath(f, ROOT) for f in _files()]
    assert "chip_smoke.py" in names
    assert os.path.join("pyclaw_tpu_torch", "ops", "tiled2d.py") in names
    for new in (("sharpclaw", "soa.py"), ("sharpclaw", "solver.py"),
                ("sharpclaw", "__init__.py"), ("limiters", "recon.py"),
                ("classic", "kernels.py"), ("examples", "euler_3d.py"),
                ("riemann", "shallow.py"),
                ("examples", "shallow_2d_radial.py"), ("ops", "sweep.py"),
                ("ops", "weno.py"), ("sharpclaw", "kernels.py"),
                ("riemann", "advection.py"), ("riemann", "acoustics.py"),
                ("examples", "advection_1d.py"),
                ("examples", "acoustics_1d.py"),
                ("examples", "euler_1d_shocktube.py"),
                ("riemann", "acoustics_var.py"),
                ("examples", "acoustics_3d_heterogeneous.py"),
                ("plot.py",), ("_native", "__init__.py"),
                ("fileio", "netcdf.py"), ("fileio", "hdf5.py"),
                ("fileio", "binary.py"), ("fileio", "sharded.py"),
                ("parallel", "io.py")):
        assert os.path.join("pyclaw_tpu_torch", *new) in names
    assert len(names) >= 45


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = [n for n in _imported(tree) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_frame_io_resolves_to_the_port():
    """Solution picks its IO module by format name at run time, which the
    scan cannot see: it must load the port's module, not the JAX one."""
    from pyclaw_tpu_torch.fileio import VALID_FORMATS
    from pyclaw_tpu_torch.solution import Solution
    for fmt in VALID_FORMATS:
        assert (Solution._io_module(fmt).__name__
                == f"pyclaw_tpu_torch.fileio.{fmt}")


def test_the_scan_catches_a_forbidden_import():
    tree = ast.parse("def f():\n    from pyclaw_tpu.fileio import ascii\n"
                     "import importlib\nimportlib.import_module('jax')\n")
    assert [n for n in _imported(tree) if _forbidden(n)] == [
        "pyclaw_tpu.fileio", "jax"]
