"""Process-aware Controller: the petclaw/controller.py equivalent.

Counterpart of ``pyclaw_tpu/parallel/controller.py``.  Every rank runs the
same orchestration loop and holds the global q after each frame
(``parallel.solver``'s pull); rank 0 writes the gather formats
('ascii'), the other ranks write nothing and log at ERROR (gauges raise
under the overlay).
The JAX package's default format, 'sharded' (each rank writes its own
block), is not ported yet and raises.
"""

from __future__ import annotations

import logging

from .. import controller as _serial
from ..solver import _not_ported
from .distributed import is_main_process


class Controller(_serial.Controller):
    def __init__(self):
        super().__init__()
        self.output_format = "sharded"

    def _write(self, frame):
        if self.output_format is None:
            return
        fmts = (list(self.output_format)
                if isinstance(self.output_format, (list, tuple))
                else [self.output_format])
        if "sharded" in fmts:
            raise _not_ported("sharded frames")
        if is_main_process():
            super()._write(frame)

    def _configure_logging(self):
        super()._configure_logging()
        if not is_main_process():
            for name in ("pyclaw.controller", "pyclaw.solver", "pyclaw.io"):
                logging.getLogger(name).setLevel(logging.ERROR)
