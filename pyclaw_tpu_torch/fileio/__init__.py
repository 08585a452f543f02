"""Frame IO backends: format-name → module dispatch, lazy import.

Counterpart of ``pyclaw_tpu/fileio``, the same five formats: ``ascii``
(the clawpack classic fort.t/fort.q format, written by the native C++
writer of ``pyclaw_tpu_torch._native``), ``hdf5`` (``h5py``), ``netcdf``
(NetCDF-3 64-bit offset via ``scipy.io``), ``binary`` (read support for
Fortran-binary frames) and ``sharded`` (one ``h5py`` file per rank of
the parallel overlay, and a JSON index).  ``h5py`` is imported inside
the functions that use it, so the other formats work without it.
"""

VALID_FORMATS = ("ascii", "hdf5", "netcdf", "binary", "sharded")
