"""CFL accumulator.

Copy of the JAX package's ``cfl.py``, a rebuild of reference
``src/pyclaw/cfl.py — class CFL`` (:~1-45).  Serial runs only in this
slice: the host-side object is a plain cache of the last step's CFL.
The seam is kept so a distributed reduction can take its place later.
"""


class CFL:
    def __init__(self):
        self._local_max = 0.0
        self._global_max = 0.0

    def get_cached_max(self):
        return self._global_max

    def set_local_max(self, v):
        self._local_max = float(v)

    def update_global_max(self, v=None):
        # Serial: global max == local max.
        if v is not None:
            self._local_max = float(v)
        self._global_max = self._local_max
        return self._global_max
