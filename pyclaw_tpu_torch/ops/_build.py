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

The wrappers' common arguments: :func:`bind_dt` and :func:`dt_arg` (dt
as a pointer to device memory), :func:`out_tensor` and :func:`plain_out`
(a step's output buffer); :func:`counted` counts a launch.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

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
# plain version too, and so does dq2_weno.cu (WENO orders 7-17), so that
# its edge states and CFL are the plain version's.  step3_ctu.cu keeps its
# contractions (the bits of its
# wave form rest on them); its f-wave variant sums the speed that feeds
# sign(s) with rounding intrinsics instead (csrc/euler3d.cuh).
EXTRA_NVCC_FLAGS = {"step2_aos": ["-fmad=false"], "step3_aos": ["-fmad=false"],
                    "step1": ["-fmad=false"], "weno5": ["-fmad=false"],
                    "dq2_weno": ["-fmad=false"]}

# name -> (ctypes.CDLL, compiler report); one build per process
_loaded = {}
# name -> seconds from the start of load_all's builds to the end of that
# source's nvcc (the builds run together: the slowest sets the wall)
build_seconds = {}


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
    start = time.perf_counter()
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
    results = {}

    def wait(name, proc):
        results[name] = proc.communicate()
        build_seconds[name] = time.perf_counter() - start
    waiters = [threading.Thread(target=wait, args=(name, p[2]))
               for name, p in procs.items()]
    for w in waiters:
        w.start()
    for w in waiters:
        w.join()
    for name, (src, out, proc) in procs.items():
        stdout, stderr = results[name]
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


# ---- arguments ------------------------------------------------------------

def bind_dt(lib, entries, argtypes, index):
    """Set the argument types of the entries ``entries`` of the ctypes
    handle ``lib`` to ``argtypes`` (dt, at ``index``, a pointer to device
    memory) and a stream; returns ``lib``."""
    types = list(argtypes)
    types[index] = ctypes.c_void_p
    for name in entries:
        fn = getattr(lib, name)
        fn.argtypes = types + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def dt_arg(dt, like):
    """(pointer, tensor) for the dt of a launch on ``like``'s device: a
    pointer to a float64 0-d tensor on that device, which the caller keeps
    until the launch is enqueued.  ``dt`` is a Python float or a 0-d
    tensor, exact in the kernel's type; a CUDA graph replays the launch
    with the tensor's value of each replay."""
    import torch
    if isinstance(dt, torch.Tensor):
        t = dt.to(device=like.device, dtype=torch.float64)
    else:
        t = torch.full((), float(dt), dtype=torch.float64, device=like.device)
    return t.data_ptr(), t


def counted(fn):
    """Count one launch of wrapper ``fn``'s kernel (or of a kernel whose
    counts a namespace with the same two attributes keeps), made just now
    on the current stream: one more in ``fn.launches`` (the host's count of
    launches made or captured into a CUDA graph), and, when
    ``fn.device_launches`` holds a device counter
    (:func:`pyclaw_tpu_torch.ops.count_on_device`), one more there on the
    same stream, so that a graph's replay counts its launches too."""
    fn.launches += 1
    if fn.device_launches is not None:
        fn.device_launches.add_(1)


def out_tensor(name, out, shape, like):
    """``out`` checked to be a contiguous tensor of ``shape`` on ``like``'s
    device and of its dtype (a step's output buffer, so the solver's device
    loop can alternate two), or a new one when it is None."""
    import torch
    if out is None:
        return torch.empty(shape, dtype=like.dtype, device=like.device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != like.dtype
            or out.device != like.device or not out.is_contiguous()):
        raise ValueError(f"{name}: out must be a contiguous {like.dtype} "
                         f"tensor of shape {tuple(shape)} on {like.device}")
    return out


def plain_out(result, out):
    """A plain version's (q, cfl) with q copied into ``out`` when given."""
    q, cfl = result
    if out is None:
        return q, cfl
    out.copy_(q)
    return out, cfl
