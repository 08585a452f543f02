"""Build the CUDA sources of ``csrc/`` at first use and load them.

Route: ``nvcc`` into a shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The
library goes to ``build/kernels/`` at the root of the checkout (listed
in ``.gitignore``) and is rebuilt when its source is newer.  A missing
``nvcc`` or a failed build raises: nothing falls back to the plain
PyTorch version.

:func:`build_host_emulation` compiles the same source with the host C++
compiler, without CUDA: the kernel's phases then run block by block on
the CPU, which lets the CPU tests check the kernel's index algebra.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> (ctypes.CDLL, compiler report); one build per process
_loaded = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "pyclaw_tpu_torch are built with nvcc at first use")
    return path


def _compile(cmd, src, out):
    """Run ``cmd`` (which writes ``out + '.tmp'``), then move the result
    into place; returns the compiler's report."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        return "(cached build)"
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build of {src} failed:\n{proc.stderr}")
    os.replace(out + ".tmp", out)
    return proc.stdout + proc.stderr


def load(name):
    """ctypes handle of ``csrc/<name>.cu`` built for sm_90a."""
    if name not in _loaded:
        src = os.path.join(CSRC, f"{name}.cu")
        out = os.path.join(BUILD_DIR, f"lib{name}.so")
        report = _compile([_nvcc(), *NVCC_FLAGS, "-o", out + ".tmp", src],
                          src, out)
        _loaded[name] = (ctypes.CDLL(out), report)
    return _loaded[name][0]


def build_report(name):
    """The ``-Xptxas -v`` report (registers, shared memory, spills) of the
    build that :func:`load` made in this process."""
    load(name)
    return _loaded[name][1]


def build_host_emulation(name, out_dir):
    """ctypes handle of ``csrc/<name>.cu`` compiled as plain C++ by the
    host compiler (its ``__CUDACC__``-free branch) into ``out_dir``."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler for the kernel emulation")
    src = os.path.join(CSRC, f"{name}.cu")
    out = os.path.join(out_dir, f"lib{name}_host.so")
    proc = subprocess.run([cxx, "-x", "c++", "-std=c++17", "-O1", "-shared",
                           "-fPIC", "-ffp-contract=off", "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {src} failed:\n{proc.stderr}")
    return ctypes.CDLL(out)
