"""Frame IO backends: format-name → module dispatch, lazy import.

Counterpart of ``pyclaw_tpu/fileio``.  This slice ports ``ascii`` (the
clawpack classic fort.t/fort.q format), read and write; the other formats
are queued in ROADMAP.md.
"""

VALID_FORMATS = ("ascii",)
