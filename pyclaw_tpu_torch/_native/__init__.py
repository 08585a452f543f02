"""Host-native (C++) frame writer, loaded with ctypes.

Counterpart of ``pyclaw_tpu/_native``: ``fastio.cpp`` (a copy of the JAX
package's) formats the ascii format's ``fort.q`` fields.  It is compiled
at first use, never at import, with ``g++ -O2 -shared -fPIC`` into
``build/native/`` at the root of the checkout (beside the kernels'
``build/kernels/``, listed in ``.gitignore``), and rebuilt when the
source is newer than the library, as ``ops/_build.py`` rebuilds the
kernels.  A missing compiler or a failed build raises: unlike the JAX
loader, nothing falls back to the Python writer, and no environment
variable selects it.  The Python writer stays as the plain version
(``fileio/ascii.py:_write_data_file_plain``), which only the tests and
``chip_smoke.py`` call, to compare the two.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(HERE)), "build",
                         "native")

_lib = None
_lock = threading.Lock()


def _build():
    """The path of ``libclawio.so``, built from ``fastio.cpp`` when it is
    missing or older than the source.  Each process compiles into a file
    of its own and renames it into place, so builders racing in parallel
    processes leave one whole library."""
    src = os.path.join(HERE, "fastio.cpp")
    out = os.path.join(BUILD_DIR, "libclawio.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native frame writer of "
                           "pyclaw_tpu_torch is built with g++ at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    proc = subprocess.run([cxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                           src, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {src} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_io_lib():
    """ctypes handle to the native IO library, built at the first call;
    raises when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.claw_write_ascii.restype = ctypes.c_int
            lib.claw_write_ascii.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.c_long,
            ]
            _lib = lib
    return _lib


def write_ascii(fname, header, q):
    """Write ``header`` (the patch header's text) and then q (num_eqn,
    *cells), 1 to 3 spatial dimensions, as the ascii format's cell lines
    into ``fname``."""
    num_dim = np.ndim(q) - 1
    if not 1 <= num_dim <= 3:
        raise ValueError(f"unsupported num_dim={num_dim}")
    qc = np.ascontiguousarray(q, dtype=np.float64)
    shape = list(qc.shape[1:]) + [1] * (3 - num_dim)
    rc = get_io_lib().claw_write_ascii(
        fname.encode(), header.encode(),
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        qc.shape[0], shape[0], shape[1], shape[2], num_dim)
    if rc != 0:
        raise OSError(f"the native writer could not write {fname}")
