"""Frame plotting with a visclaw-compatible ``setplot`` API.

Copy of the JAX package's ``plot.py`` (numpy, and matplotlib imported
inside the functions that draw): it reads frames through the port's
``Solution`` (host numpy arrays), so it plots what any run of the port
wrote, on the card or on the CPU.

The reference delegates plotting to the external visclaw package
(``src/pyclaw/plot.py`` :~1-90 just forwards to ``visclaw.Iplotclaw`` /
plotpages); its examples each define ``setplot(plotdata)`` configuring
``ClawPlotData -> plotfigure -> plotaxes -> plotitem`` objects.  This
module implements that configuration surface on matplotlib for the
common item types (``1d_plot``, ``1d_fill_between``, ``2d_pcolor``,
``2d_contour``, ``2d_schlieren``) so reference setplot functions port
unchanged, plus the same entry-point names (``interactive_plot``,
``html_plot``).
"""

from __future__ import annotations

import os

import numpy as np


# ----------------------------------------------------------------------
# visclaw-style configuration objects
# ----------------------------------------------------------------------
class ClawPlotItem:
    def __init__(self, plot_type="1d_plot"):
        self.plot_type = plot_type
        self.plot_var = 0          # component index or callable(current_data)
        self.plot_var2 = None      # lower curve for 1d_fill_between
        self.plotstyle = "-"
        self.color = None
        self.pcolor_cmap = "viridis"
        self.pcolor_cmin = None
        self.pcolor_cmax = None
        self.add_colorbar = True
        self.contour_levels = None
        self.contour_nlevels = 20
        self.contour_colors = "k"
        self.schlieren_cmap = "gray"
        self.show = True
        self.kwargs = {}

    # -- rendering ------------------------------------------------------
    def _var(self, current_data, which):
        if callable(which):
            return np.asarray(which(current_data))
        return np.asarray(current_data.q[which])

    def render(self, ax, current_data):
        if not self.show:
            return
        cd = current_data
        var = self._var(cd, self.plot_var)
        if self.plot_type == "1d_plot":
            ax.plot(cd.x, var, self.plotstyle, color=self.color,
                    **self.kwargs)
        elif self.plot_type == "1d_fill_between":
            lower = (self._var(cd, self.plot_var2)
                     if self.plot_var2 is not None else 0.0)
            ax.fill_between(cd.x, var, lower, color=self.color,
                            **self.kwargs)
        elif self.plot_type == "2d_pcolor":
            m = ax.pcolormesh(cd.x, cd.y, var, cmap=self.pcolor_cmap,
                              vmin=self.pcolor_cmin, vmax=self.pcolor_cmax,
                              shading="auto", **self.kwargs)
            if self.add_colorbar:
                ax.figure.colorbar(m, ax=ax)
        elif self.plot_type == "2d_contour":
            levels = (self.contour_levels if self.contour_levels is not None
                      else self.contour_nlevels)
            ax.contour(cd.x, cd.y, var, levels=levels,
                       colors=self.contour_colors, **self.kwargs)
        elif self.plot_type == "2d_schlieren":
            gx, gy = np.gradient(var)
            ax.pcolormesh(cd.x, cd.y, np.sqrt(gx ** 2 + gy ** 2),
                          cmap=self.schlieren_cmap, shading="auto",
                          **self.kwargs)
        else:
            raise ValueError(f"unknown plot_type {self.plot_type!r}")


class ClawPlotAxes:
    def __init__(self, title=""):
        self.title = title
        self.xlimits = "auto"
        self.ylimits = "auto"
        self.scaled = False
        self.afteraxes = None      # callable(current_data)
        self.plotitem_dict = {}

    def new_plotitem(self, name=None, plot_type="1d_plot"):
        item = ClawPlotItem(plot_type)
        self.plotitem_dict[name or f"item{len(self.plotitem_dict)}"] = item
        return item

    def render(self, ax, current_data):
        current_data.plotaxes = self
        for item in self.plotitem_dict.values():
            item.render(ax, current_data)
        ax.set_title(f"{self.title}   t = {current_data.t:.4f}")
        if self.xlimits != "auto":
            ax.set_xlim(self.xlimits)
        if self.ylimits != "auto":
            ax.set_ylim(self.ylimits)
        if self.scaled:
            ax.set_aspect("equal")
        if self.afteraxes is not None:
            current_data.plotaxes_obj = ax
            self.afteraxes(current_data)


class ClawPlotFigure:
    def __init__(self, name, figno):
        self.name = name
        self.figno = figno
        self.kwargs = {}
        self.show = True
        self.plotaxes_dict = {}

    def new_plotaxes(self, name=None):
        axes = ClawPlotAxes()
        self.plotaxes_dict[name or f"axes{len(self.plotaxes_dict)}"] = axes
        return axes


class CurrentData:
    """Bag passed to plot_var/afteraxes callables (visclaw convention):
    q, aux, t, frameno, x (, y), var, user."""

    def __init__(self, solution, frameno):
        grid = solution.domain.grid
        self.solution = solution
        self.q = np.asarray(solution.q)
        self.aux = (np.asarray(solution.states[0].aux)
                    if solution.states[0].aux is not None else None)
        self.t = solution.t
        self.frameno = frameno
        self.user = {}
        if solution.domain.num_dim == 1:
            self.x = grid.dimensions[0].centers
        elif solution.domain.num_dim >= 2:
            cc = grid.c_centers
            self.x, self.y = cc[0], cc[1]


class ClawPlotData:
    def __init__(self, outdir="./_output", file_format="ascii"):
        self.outdir = outdir
        self.plotdir = None
        self.file_format = file_format
        self.plotfigure_dict = {}
        self._frame_cache = {}

    def new_plotfigure(self, name=None, figno=None):
        name = name or f"fig{len(self.plotfigure_dict)}"
        figno = figno if figno is not None else len(self.plotfigure_dict) + 1
        fig = ClawPlotFigure(name, figno)
        self.plotfigure_dict[name] = fig
        return fig

    def getframe(self, frameno):
        if frameno not in self._frame_cache:
            from .solution import Solution
            self._frame_cache[frameno] = Solution(
                frameno, path=self.outdir, file_format=self.file_format)
        return self._frame_cache[frameno]

    def clearfigures(self):
        self.plotfigure_dict = {}

    # -- rendering ------------------------------------------------------
    def render_frame(self, frameno):
        """Render every plotfigure for one frame -> {name: mpl Figure}."""
        import matplotlib.pyplot as plt
        solution = self.getframe(frameno)
        figs = {}
        for name, pfig in self.plotfigure_dict.items():
            if not pfig.show:
                continue
            n = max(1, len(pfig.plotaxes_dict))
            fig, axs = plt.subplots(n, 1, squeeze=False, **pfig.kwargs)
            for ax, paxes in zip(axs[:, 0], pfig.plotaxes_dict.values()):
                cd = CurrentData(solution, frameno)
                paxes.render(ax, cd)
            figs[name] = fig
        return figs


def _default_plotdata(outdir, file_format, component=0):
    """When no setplot is given: one figure, one item (line / pcolor)."""
    from .solution import Solution
    sol = Solution(0, path=outdir, file_format=file_format)
    pd = ClawPlotData(outdir, file_format)
    fig = pd.new_plotfigure("q%d" % component)
    axes = fig.new_plotaxes()
    item = axes.new_plotitem(
        plot_type="1d_plot" if sol.domain.num_dim == 1 else "2d_pcolor")
    item.plot_var = component
    return pd


def _resolve_plotdata(outdir, file_format, setplot, component=0):
    if setplot is None:
        return _default_plotdata(outdir, file_format, component)
    pd = ClawPlotData(outdir, file_format)
    return setplot(pd) or pd


def _count_frames(outdir, file_format="ascii"):
    from .solution import Solution
    n = 0
    while True:
        try:
            Solution(n, path=outdir, file_format=file_format)
        except FileNotFoundError:
            return n
        n += 1


def plot_frame(solution, component=0, ax=None):
    """Single-frame convenience plot (line in 1D, pcolormesh in 2D)."""
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    q = solution.q
    grid = solution.domain.grid
    if solution.domain.num_dim == 1:
        ax.plot(grid.dimensions[0].centers, q[component])
    elif solution.domain.num_dim == 2:
        x, y = grid.c_centers
        ax.pcolormesh(x, y, q[component], shading="auto")
    else:
        raise NotImplementedError("3D plotting: slice manually")
    ax.set_title(f"t = {solution.t:.4f}")
    return ax


def html_plot(outdir="./_output", file_format="ascii", component=0,
              setplot=None):
    """Write PNGs for every frame/figure + an index.html into
    <outdir>/_plots (the reference's visclaw plotpages path)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    pd = _resolve_plotdata(outdir, file_format, setplot, component)
    plotdir = pd.plotdir or os.path.join(outdir, "_plots")
    os.makedirs(plotdir, exist_ok=True)
    nframes = _count_frames(outdir, file_format)
    fignames = [n for n, f in pd.plotfigure_dict.items() if f.show]
    files = {}
    for i in range(nframes):
        for name, fig in pd.render_frame(i).items():
            fname = f"frame{i:04d}_{name}.png"
            fig.savefig(os.path.join(plotdir, fname), dpi=100)
            plt.close(fig)
            files[(i, name)] = fname
    with open(os.path.join(plotdir, "index.html"), "w") as f:
        f.write("<html><body><table>\n")
        f.write("<tr>" + "".join(f"<th>{n}</th>" for n in fignames)
                + "</tr>\n")
        for i in range(nframes):
            f.write("<tr>" + "".join(
                f'<td><img src="{files[(i, n)]}" width="400"></td>'
                for n in fignames) + "</tr>\n")
        f.write("</table></body></html>\n")
    return plotdir


def interactive_plot(outdir="./_output", file_format="ascii", setplot=None):
    """Show every frame's figures (the reference's Iplotclaw loop,
    non-interactive backends just render)."""
    import matplotlib.pyplot as plt
    pd = _resolve_plotdata(outdir, file_format, setplot)
    for i in range(_count_frames(outdir, file_format)):
        pd.render_frame(i)
        plt.show()
