"""Solution: container of State(s) + Domain, with frame IO.

Rebuild of reference ``src/pyclaw/solution.py — class Solution`` (:~1-400;
SURVEY.md §2.1).  Overloaded constructor forms supported:

    Solution(state, domain)
    Solution(num_eqn, domain)           # allocates an empty State
    Solution(frame_number, path=..., file_format=...)   # read a frame

``write``/``read`` dispatch by format name to ``pyclaw_tpu_torch.fileio.<fmt>``
(resolved from this package's own name, never the JAX package's);
every written frame is a complete checkpoint (q, t, geometry) enabling the
reference's restart pattern (SURVEY.md §3.4, §5.4).
"""

from __future__ import annotations

import copy
import importlib
import os

from .geometry import Domain
from .state import State


class Solution:
    def __init__(self, *args, **kwargs):
        self.states = []
        self.domain = None
        frame = kwargs.pop("frame", None)

        if len(args) == 2:
            a, b = args
            if isinstance(a, State) and isinstance(b, Domain):
                self.states = [a]
                self.domain = b
            elif isinstance(a, int) and isinstance(b, Domain):
                self.states = [State(b, a, kwargs.get("num_aux", 0))]
                self.domain = b
            else:
                raise ValueError("Solution(state, domain) or Solution(num_eqn, domain)")
        elif len(args) == 1 and isinstance(args[0], int) and frame is None:
            # Solution(frame_number, path=..., file_format=...)
            self.read(args[0],
                      path=kwargs.get("path", "./_output"),
                      file_format=kwargs.get("file_format", "ascii"),
                      file_prefix=kwargs.get("file_prefix", None),
                      read_aux=kwargs.get("read_aux", False))
        elif len(args) == 0:
            pass
        else:
            raise ValueError(f"bad Solution constructor args: {args}")

    # -- proxy properties to the base state (reference _get_base_state) --
    @property
    def state(self):
        return self.states[0]

    @property
    def patch(self):
        return self.domain.patches[0]

    @property
    def grid(self):
        return self.domain.grid

    @property
    def q(self):
        return self.states[0].q

    @property
    def aux(self):
        return self.states[0].aux

    @property
    def t(self):
        return self.states[0].t

    @t.setter
    def t(self, value):
        self.states[0].t = value

    def __getattr__(self, name):
        if name in ("num_eqn", "num_aux", "problem_data", "num_dim",
                    "index_capa", "capa"):
            return getattr(self.states[0], name)
        raise AttributeError(name)

    def __copy__(self):
        return self.__class__(copy.copy(self.states[0]), self.domain)

    def __deepcopy__(self, memo):
        new = Solution(copy.deepcopy(self.states[0], memo), self.domain)
        return new

    # ------------------------------------------------------------------
    @staticmethod
    def _io_module(file_format):
        return importlib.import_module(f"{__package__}.fileio.{file_format}")

    def write(self, frame, path="./_output", file_format="ascii",
              file_prefix=None, write_aux=False, options=None, write_p=False):
        os.makedirs(path, exist_ok=True)
        formats = file_format if isinstance(file_format, (list, tuple)) else [file_format]
        for fmt in formats:
            mod = self._io_module(fmt)
            kwargs = dict(write_aux=write_aux, options=options or {},
                          write_p=write_p)
            if file_prefix is not None:
                kwargs["file_prefix"] = file_prefix
            mod.write(self, frame, path, **kwargs)

    def read(self, frame, path="./_output", file_format="ascii",
             file_prefix=None, read_aux=False, options=None):
        mod = self._io_module(file_format)
        kwargs = dict(read_aux=read_aux, options=options or {})
        if file_prefix is not None:
            kwargs["file_prefix"] = file_prefix
        mod.read(self, frame, path, **kwargs)
        return self
