"""Grid geometry: Dimension / Patch / Grid / Domain.

Copy of the JAX package's ``geometry.py`` (numpy only), itself a rebuild
of the reference data model in ``src/pyclaw/geometry.py`` (Dimension
:~60-260, Patch :~260-420, Grid :~420-760, Domain :~760-900, line numbers
approximate; see SURVEY.md §2.1).  Geometry is *static host-side metadata*
(numpy): the solver reads it once at setup.  Cell arrays (`q`, `aux`) live
in :class:`pyclaw_tpu_torch.state.State` as host numpy arrays.

Arrays returned here are numpy (host); they parameterize ICs and aux
fields, which the user builds once and the solver moves to the device.
"""

from __future__ import annotations

import numpy as np

DEFAULT_DIM_NAMES = ("x", "y", "z")


class Dimension:
    """One coordinate dimension of a logically rectangular grid.

    Mirrors reference ``pyclaw.geometry.Dimension`` (geometry.py :~60):
    lower/upper physical extents, number of cells, cell width ``delta``,
    cell-center and edge coordinate arrays, with-ghost variants.

    >>> d = Dimension(0.0, 1.0, 4, name='x')
    >>> d.delta
    0.25
    >>> d.centers
    array([0.125, 0.375, 0.625, 0.875])
    >>> d.edges
    array([0.  , 0.25, 0.5 , 0.75, 1.  ])
    >>> d.centers_with_ghost(1)
    array([-0.125,  0.125,  0.375,  0.625,  0.875,  1.125])
    """

    def __init__(self, lower, upper, num_cells, name="x", units=None):
        if num_cells <= 0:
            raise ValueError("num_cells must be positive")
        if upper <= lower:
            raise ValueError("upper must exceed lower")
        self.lower = float(lower)
        self.upper = float(upper)
        self.num_cells = int(num_cells)
        self.name = name
        self.units = units

    @property
    def delta(self):
        return (self.upper - self.lower) / self.num_cells

    @property
    def centers(self):
        return self.lower + (np.arange(self.num_cells) + 0.5) * self.delta

    @property
    def edges(self):
        return self.lower + np.arange(self.num_cells + 1) * self.delta

    # The reference also exposes `nodes` as an alias for edges.
    nodes = edges

    def centers_with_ghost(self, num_ghost):
        n = self.num_cells
        return self.lower + (np.arange(-num_ghost, n + num_ghost) + 0.5) * self.delta

    def edges_with_ghost(self, num_ghost):
        n = self.num_cells
        return self.lower + np.arange(-num_ghost, n + num_ghost + 1) * self.delta

    def __repr__(self):
        return (f"Dimension {self.name}: (num_cells,delta,[lower,upper]) = "
                f"({self.num_cells},{self.delta},[{self.lower},{self.upper}])")


class Grid:
    """Coordinate arrays (computational and physical) for a patch.

    Mirrors reference ``Grid`` (geometry.py :~420): ``c_centers``/``c_edges``
    are computational coordinates (ndim meshgrid arrays); ``p_centers`` /
    ``p_edges`` map through the user `mapc2p` callable (mapped grids,
    e.g. annulus/sphere examples).  Also owns gauges.
    """

    def __init__(self, dimensions):
        if isinstance(dimensions, Dimension):
            dimensions = [dimensions]
        self.dimensions = list(dimensions)
        self.mapc2p = None  # user callable: mapc2p(grid, *c_arrays) -> p_arrays
        self.gauges = []            # list of physical-space points
        self.gauge_indices = []     # cell index tuple per gauge
        self.gauge_dir_name = "_gauges"

    @property
    def num_dim(self):
        return len(self.dimensions)

    @property
    def num_cells(self):
        return [d.num_cells for d in self.dimensions]

    @property
    def delta(self):
        return [d.delta for d in self.dimensions]

    @property
    def lower(self):
        return [d.lower for d in self.dimensions]

    @property
    def upper(self):
        return [d.upper for d in self.dimensions]

    def __getattr__(self, name):
        # grid.x, grid.y, grid.z like the reference
        for d in self.__dict__.get("dimensions", []):
            if d.name == name:
                return d
        raise AttributeError(name)

    # -- computational coordinates ------------------------------------
    @property
    def c_centers(self):
        return np.meshgrid(*[d.centers for d in self.dimensions], indexing="ij")

    @property
    def c_edges(self):
        return np.meshgrid(*[d.edges for d in self.dimensions], indexing="ij")

    def c_centers_with_ghost(self, num_ghost):
        return np.meshgrid(
            *[d.centers_with_ghost(num_ghost) for d in self.dimensions],
            indexing="ij")

    def c_edges_with_ghost(self, num_ghost):
        return np.meshgrid(
            *[d.edges_with_ghost(num_ghost) for d in self.dimensions],
            indexing="ij")

    # -- physical coordinates (mapped grids) --------------------------
    def _map(self, c_arrays):
        if self.mapc2p is None:
            return c_arrays
        out = self.mapc2p(self, *c_arrays)
        if isinstance(out, (list, tuple)):
            return list(out)
        return [out]

    @property
    def p_centers(self):
        return self._map(self.c_centers)

    @property
    def p_edges(self):
        return self._map(self.c_edges)

    # -- gauges -------------------------------------------------------
    def add_gauges(self, gauge_coords):
        """Register gauge points (physical coords); mirrors reference
        Grid.add_gauges (geometry.py :~700)."""
        for coords in gauge_coords:
            idx = tuple(
                int(np.clip((c - d.lower) // d.delta, 0, d.num_cells - 1))
                for c, d in zip(np.atleast_1d(coords), self.dimensions))
            self.gauges.append(list(np.atleast_1d(coords)))
            self.gauge_indices.append(idx)

    def __repr__(self):
        return f"Grid({self.dimensions!r})"


class Patch:
    """One logically rectangular patch of the domain.

    Mirrors reference ``Patch`` (geometry.py :~260).  In serial runs the
    domain has exactly one patch covering the global grid.
    """

    def __init__(self, dimensions):
        if isinstance(dimensions, Dimension):
            dimensions = [dimensions]
        self.dimensions = list(dimensions)
        self.grid = Grid(self.dimensions)
        self.patch_index = 1
        self.level = 1  # AMR-ready, always 1 here (like serial pyclaw)

    @property
    def num_dim(self):
        return len(self.dimensions)

    @property
    def num_cells_global(self):
        return [d.num_cells for d in self.dimensions]

    @property
    def lower_global(self):
        return [d.lower for d in self.dimensions]

    @property
    def upper_global(self):
        return [d.upper for d in self.dimensions]

    @property
    def delta(self):
        return [d.delta for d in self.dimensions]

    @property
    def name(self):
        return [d.name for d in self.dimensions]

    def __getattr__(self, name):
        for d in self.__dict__.get("dimensions", []):
            if d.name == name:
                return d
        raise AttributeError(name)

    def __repr__(self):
        return f"Patch({self.dimensions!r})"


class Domain:
    """Collection of patches (serial: exactly one).

    Mirrors reference ``Domain`` (geometry.py :~760) including the
    convenience constructor::

        Domain([0., 0.], [1., 1.], [100, 100])
        Domain([dim_x, dim_y])
        Domain(dim_x)
    """

    def __init__(self, *args):
        if len(args) == 3:
            lowers, uppers, ncells = args
            lowers = np.atleast_1d(lowers)
            uppers = np.atleast_1d(uppers)
            ncells = np.atleast_1d(ncells)
            dims = [
                Dimension(lo, up, int(n), name=DEFAULT_DIM_NAMES[i])
                for i, (lo, up, n) in enumerate(zip(lowers, uppers, ncells))
            ]
            self.patches = [Patch(dims)]
        elif len(args) == 1:
            arg = args[0]
            if isinstance(arg, Patch):
                self.patches = [arg]
            elif isinstance(arg, Dimension):
                self.patches = [Patch([arg])]
            elif isinstance(arg, (list, tuple)):
                if all(isinstance(a, Patch) for a in arg):
                    self.patches = list(arg)
                elif all(isinstance(a, Dimension) for a in arg):
                    self.patches = [Patch(list(arg))]
                else:
                    raise ValueError("Domain(list): need Patches or Dimensions")
            else:
                raise ValueError(f"cannot build Domain from {arg!r}")
        else:
            raise ValueError("Domain takes 1 or 3 arguments")

    @property
    def patch(self):
        return self.patches[0]

    @property
    def grid(self):
        return self.patches[0].grid

    @property
    def num_dim(self):
        return self.patches[0].num_dim

    def __repr__(self):
        return f"Domain({self.patches!r})"
