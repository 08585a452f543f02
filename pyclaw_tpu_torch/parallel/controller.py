"""Process-aware Controller: the petclaw/controller.py equivalent.

Counterpart of ``pyclaw_tpu/parallel/controller.py``.  Every rank runs the
same orchestration loop and holds the global q after each frame
(``parallel.solver``'s pull); file-creating side effects and log chatter
happen on rank 0 only, except the collective format, where each rank
writes its own shard:

  - ``output_format='sharded'`` (the default, like petclaw's 'petsc'):
    every rank writes its block through ``fileio.sharded``, and rank 0
    the index;
  - the gather formats ('ascii', 'hdf5', 'netcdf'), the derived-quantity
    (``compute_p``) and functional (``compute_F``) output: rank 0 only;
  - gauges and log output: rank 0 only.

Restart from a sharded frame:  ``Solution(k, path=..., file_format='sharded')``.
"""

from __future__ import annotations

import logging

from .. import controller as _serial
from .distributed import is_main_process


class Controller(_serial.Controller):
    def __init__(self):
        super().__init__()
        self.output_format = "sharded"

    def _write(self, frame):
        if self.output_format is None:
            return
        if is_main_process():
            super()._write(frame)
            return
        fmts = (self.output_format
                if isinstance(self.output_format, (list, tuple))
                else [self.output_format])
        if "sharded" in fmts:
            self.solution.write(frame, **self._frame_kwargs(frame,
                                                            "sharded"))

    def _write_gauges(self):
        if not is_main_process():
            return
        super()._write_gauges()

    def _configure_logging(self):
        super()._configure_logging()
        if not is_main_process():
            for name in ("pyclaw.controller", "pyclaw.solver", "pyclaw.io"):
                logging.getLogger(name).setLevel(logging.ERROR)
