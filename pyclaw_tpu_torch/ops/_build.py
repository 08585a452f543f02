"""Build the CUDA sources of ``csrc/`` at first use and load them.

Route: ``nvcc`` into a shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  The
library goes to ``build/kernels/`` at the root of the checkout (listed
in ``.gitignore``) and is rebuilt when its source, or a shared header
``csrc/*.cuh``, is newer.  A missing
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
# Per-source flags.  step2_aos.cu, step3_aos.cu and step1.cu round every
# operation as their plain versions' PyTorch operations do (no fused
# multiply-add): the f-wave correction 0.5 sign(s), the f-wave split
# s < 0, the entropy fix's transonic tests and the limiter's upwind choice
# jump where a speed crosses zero, so a one-ulp difference in a speed near
# zero would move the result by a whole wave.  weno5.cu rounds as its
# plain version too.  step3_ctu.cu keeps its contractions (the bits of its
# wave form rest on them); its f-wave variant sums the speed that feeds
# sign(s) with rounding intrinsics instead (csrc/euler3d.cuh).
EXTRA_NVCC_FLAGS = {"step2_aos": ["-fmad=false"], "step3_aos": ["-fmad=false"],
                    "step1": ["-fmad=false"], "weno5": ["-fmad=false"]}

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


def _newest_source(src):
    """mtime of ``src`` or of the newest shared header in ``csrc/``."""
    headers = [os.path.join(CSRC, n) for n in os.listdir(CSRC)
               if n.endswith(".cuh")]
    return max(os.path.getmtime(p) for p in [src, *headers])


def load_all(names):
    """ctypes handles of ``csrc/<name>.cu`` for each of ``names``, built
    for sm_90a: one nvcc per stale source, all started together."""
    procs = {}
    for name in names:
        if name in _loaded:
            continue
        src = os.path.join(CSRC, f"{name}.cu")
        out = os.path.join(BUILD_DIR, f"lib{name}.so")
        if (os.path.exists(out)
                and os.path.getmtime(out) >= _newest_source(src)):
            _loaded[name] = (ctypes.CDLL(out), "(cached build)")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs[name] = (src, out, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, *EXTRA_NVCC_FLAGS.get(name, []), "-o",
             out + ".tmp", src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (src, out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"build of {src} failed:\n{stderr}")
            continue
        os.replace(out + ".tmp", out)
        _loaded[name] = (ctypes.CDLL(out), stdout + stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_loaded[name][0] for name in names]


def load(name):
    """ctypes handle of ``csrc/<name>.cu`` built for sm_90a."""
    return load_all([name])[0]


def build_report(name):
    """The ``-Xptxas -v`` report (registers, shared memory, spills) of the
    build that :func:`load` made in this process."""
    load(name)
    return _loaded[name][1]


def build_host_emulation(name, out_dir, opt="-O1"):
    """ctypes handle of ``csrc/<name>.cu`` compiled as plain C++ by the
    host compiler (its ``__CUDACC__``-free branch) into ``out_dir``, at
    optimisation level ``opt`` (``-O0`` compiles a source with many
    template variants in a third of the time)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler for the kernel emulation")
    src = os.path.join(CSRC, f"{name}.cu")
    out = os.path.join(out_dir, f"lib{name}_host.so")
    proc = subprocess.run([cxx, "-x", "c++", "-std=c++17", opt, "-shared",
                           "-fPIC", "-ffp-contract=off", "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {src} failed:\n{proc.stderr}")
    return ctypes.CDLL(out)
