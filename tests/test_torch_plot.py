"""pyclaw_tpu_torch/plot.py and Controller.plot: the port's frames drawn
with matplotlib (model: tests/test_plot_and_misc.py:12-36), and the same
frames drawn by the JAX package's plot module, PNG for PNG."""

import os

import numpy as np
import pytest
import torch

import pyclaw_tpu_torch as pt
from pyclaw_tpu_torch import plot
from pyclaw_tpu_torch.examples import acoustics_2d as tac2
from pyclaw_tpu_torch.examples import advection_1d as tadv
from pyclaw_tpu_torch.examples import kpp as tkpp
from pyclaw_tpu_torch.examples import shock_forward_step as tfs

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pngs(plotdir):
    return sorted(f for f in os.listdir(plotdir) if f.endswith(".png"))


@pytest.mark.parametrize("fmt", ["ascii", "netcdf"])
def test_html_plot_draws_the_jax_packages_pages(tmp_path, fmt):
    """advection_1d's three frames: an index.html and a PNG a frame, and
    the JAX package's html_plot draws the same PNGs from the port's
    frames."""
    from pyclaw_tpu import plot as jplot
    claw = tadv.setup(nx=32, outdir=str(tmp_path / "out"), device="cpu")
    claw.num_output_times = 2
    claw.output_format = fmt
    claw.run()
    plotdir = plot.html_plot(outdir=str(tmp_path / "out"), file_format=fmt)
    files = os.listdir(plotdir)
    assert "index.html" in files and len(_pngs(plotdir)) == 3
    theirs = str(tmp_path / "jax_plots")
    pd = jplot._resolve_plotdata(str(tmp_path / "out"), fmt, None)
    pd.plotdir = theirs
    jplot.html_plot(outdir=str(tmp_path / "out"), file_format=fmt,
                    setplot=lambda plotdata: pd)
    assert _pngs(theirs) == _pngs(plotdir)
    for name in _pngs(plotdir):
        assert (open(os.path.join(plotdir, name), "rb").read()
                == open(os.path.join(theirs, name), "rb").read()), name


def test_plot_frame_2d():
    claw = tac2.setup(mx=16, my=16, outdir=None, device="cpu")
    claw.tfinal = 0.05
    claw.run()
    ax = plot.plot_frame(claw.solution)
    assert ax is not None and ax.get_title() == "t = 0.0500"
    with pytest.raises(NotImplementedError, match="3D"):
        domain = pt.Domain([0.0] * 3, [1.0] * 3, [2, 2, 2])
        plot.plot_frame(pt.Solution(pt.State(domain, 1), domain))


def test_controller_plot_and_the_examples_setplot(tmp_path, monkeypatch):
    """Controller.plot renders every frame (interactive_plot, plt.show a
    no-op under Agg) with the example's setplot; kpp's and the forward
    step's setplot draw their figures."""
    import matplotlib.pyplot as plt
    shown = []
    monkeypatch.setattr(plt, "show", lambda: shown.append(1))
    claw = tkpp.setup(mx=16, my=16, outdir=str(tmp_path / "kpp"),
                      device="cpu")
    claw.tfinal, claw.num_output_times = 0.1, 2
    claw.run()
    claw.plot(setplot=tkpp.setplot)
    assert len(shown) == 3
    plt.close("all")
    plotdir = plot.html_plot(outdir=str(tmp_path / "kpp"),
                             setplot=tkpp.setplot)
    assert _pngs(plotdir) == [f"frame{i:04d}_q.png" for i in range(3)]
    fs = tfs.setup(mx=30, my=10, tfinal=0.02, num_output_times=1,
                   outdir=str(tmp_path / "fs"), device="cpu")
    fs.run()
    pd = tfs.setplot(plot.ClawPlotData(str(tmp_path / "fs")))
    figs = pd.render_frame(1)
    assert sorted(figs) == ["Density", "Schlieren"]
    assert np.isfinite(figs["Density"].axes[0].collections[0].get_array()
                       ).all()
    plt.close("all")
