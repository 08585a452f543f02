"""Drive pyclaw_tpu_torch on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. the card: name, nvidia-smi name and power limit;
  2. the build of every kernel from the checkout's sources (nvcc, sm_90a),
     with the ptxas report (registers, shared memory, spills);
  3. each kernel against its plain PyTorch version on the card, over the
     quadrants initial condition and a seeded random admissible state,
     grids 1024^2, 80^2, 128^2 and 100x37, float32 and float64,
     transverse_waves 0/1/2, order 1/2, limiters {3, 4, 10};
  4. the main path: examples.euler_2d_quadrants.setup(mx=1024, my=1024,
     float32) through Controller.run() to tfinal=0.8, with the kernel's
     launch count read around it;
  5. the 80^2 and 128^2 quadrants goldens (tests/golden/*.npz) on the
     card, float32 and float64;
  6. timing at 1024^2 (CUDA events): kernel, plain version, bound; then
     the main path to t=0.1 under torch.profiler (device busy share,
     device time by kernel, host time by operation);
  7. the JSON lines: a kernels record, the card line, and the result.

It needs one card and exits non-zero, printing no result, without one.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Memory rate and peak operation rates of one H100 SXM (NVIDIA data sheet;
# non-tensor-core float32 and float64), used for the bound.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# Operations per cell of one CTU step (order 2, transverse_waves 2, van
# Leer), counted from csrc/step2_ctu.cu with each add, multiply, min/max,
# divide, sqrt and rsqrt as one, each interface quantity counted once
# (the halo recomputation between blocks is overhead, not work):
#   per interface (one x and one y per cell): Roe averages and wave
#   strengths 71, waves 22, limiter (dot products 56, phi 20) 76,
#   fluctuations and correction flux 152, rpt2 inputs 8, two rpt2
#   splits 282, CFL 8 -> 619; two interfaces 1238;
#   fold and update per cell 88.
FLOPS_PER_CELL = 2 * 619 + 88

TOL_REL = {"float32": 1e-5, "float64": 1e-12}        # one step, vs plain
GOLDEN_TOL = {"float32": 1e-3, "float64": 1e-8}      # tools/tpu_validate


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def random_state(rng, nx, ny, gamma=1.4):
    """A seeded admissible Euler state (positive density and pressure)."""
    rho = 0.5 + rng.random((nx, ny))
    u = 0.5 * rng.standard_normal((nx, ny))
    v = 0.5 * rng.standard_normal((nx, ny))
    p = 0.5 + rng.random((nx, ny))
    return np.stack([rho, rho * u, rho * v,
                     p / (gamma - 1.0) + 0.5 * rho * (u * u + v * v)])


def quadrants_state(nx, ny):
    from pyclaw_tpu_torch.examples import euler_2d_quadrants as ex
    return ex.setup(mx=nx, my=ny, outdir=None, device="cpu").solution.q


def padded(q_np, dtype, dev):
    import torch
    from pyclaw_tpu_torch import bc
    q = torch.as_tensor(q_np, dtype=dtype, device=dev)
    return bc.extend(q, 2, [bc.BC.extrap] * 2, [bc.BC.extrap] * 2)


def compare_kernel(dev, grids, seed=0):
    """Kernel vs plain version, one step each, on the card."""
    import torch
    from pyclaw_tpu_torch.classic import soa
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.riemann import euler
    rng = np.random.default_rng(seed)
    params = {"gamma": 1.4}
    worst = {"float32": 0.0, "float64": 0.0}
    worst_cfl = {"float32": 0.0, "float64": 0.0}
    main_abs_err = None
    ncase = 0
    for nx, ny in grids:
        inputs = {"quadrants": quadrants_state(nx, ny),
                  "random": random_state(rng, nx, ny)}
        dx, dy = 1.0 / nx, 1.0 / ny
        for iname, q_np in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                qbc = padded(q_np, dtype, dev)
                dt = float(np.dtype(tname).type(0.2 / max(nx, ny)))
                for order in (1, 2):
                    for tw in (0, 1, 2):
                        for lim in (3, 4, 10):
                            ml = (lim,) * 4
                            qk, ck = tiled2d.step2_rows(qbc, dt, dx, dy,
                                                        params, ml, order,
                                                        2, tw)
                            qp, cp = soa.step2_soa(
                                qbc, dt, dx, dy, euler._rpn2_euler_soa,
                                euler._rpt2_euler_soa, params, ml, order, 2,
                                tw, euler._prefactor_euler_2d_soa)
                            torch.cuda.synchronize()
                            scale = float(qp.abs().max())
                            abs_err = float((qk - qp).abs().max())
                            rel = abs_err / scale
                            dcfl = abs(float(ck) - float(cp))
                            ok = (np.isfinite(rel) and rel <= TOL_REL[tname]
                                  and dcfl <= TOL_REL[tname] * float(cp))
                            if not ok:
                                fail(f"kernel vs plain {nx}x{ny} {iname} "
                                     f"{tname} order={order} tw={tw} "
                                     f"lim={lim}: rel err {rel:.3e}, "
                                     f"cfl {float(ck)!r} vs {float(cp)!r}")
                            worst[tname] = max(worst[tname], rel)
                            worst_cfl[tname] = max(worst_cfl[tname], dcfl)
                            if ((nx, ny, iname, tname, order, tw, lim)
                                    == (1024, 1024, "quadrants", "float32",
                                        2, 2, 3)):
                                main_abs_err = abs_err
                            ncase += 1
        print(f"  compare {nx}x{ny}: max rel err f32 {worst['float32']:.3e}"
              f" f64 {worst['float64']:.3e}; max |dcfl| f32 "
              f"{worst_cfl['float32']:.3e} f64 {worst_cfl['float64']:.3e}",
              flush=True)
    return worst, worst_cfl, main_abs_err, ncase


def run_quadrants(dev, n, dtype, tfinal=0.8):
    """examples.euler_2d_quadrants through Controller.run(); returns
    (claw, status, wall seconds)."""
    import torch
    from pyclaw_tpu_torch.examples import euler_2d_quadrants as ex
    claw = ex.setup(mx=n, my=n, dtype=dtype, outdir=None, device=dev)
    claw.tfinal = tfinal
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def time_ms(fn, iters, warm=5):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timing(dev, n=1024):
    """Kernel, plain version and bound at n^2 on the quadrants state."""
    import torch
    from pyclaw_tpu_torch.classic import soa
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.riemann import euler
    params = {"gamma": 1.4}
    q_np = quadrants_state(n, n)
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc = padded(q_np, dtype, dev)
        dt = float(np.dtype(tname).type(0.2 / n))
        h = 1.0 / n

        def kern():
            return tiled2d.step2_rows(qbc, dt, h, h, params, (3,) * 4, 2,
                                      num_ghost=2, transverse_waves=2)

        def plain():
            return soa.step2_soa(qbc, dt, h, h, euler._rpn2_euler_soa,
                                 euler._rpt2_euler_soa, params, (3,) * 4, 2,
                                 2, transverse_waves=2,
                                 prefactor_soa=euler._prefactor_euler_2d_soa)
        ms = time_ms(kern, 200)
        plain_ms = time_ms(plain, 20, warm=2)
        ms_again = time_ms(kern, 200)
        item = qbc.element_size()
        nbytes = qbc.numel() * item + 4 * n * n * item
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = FLOPS_PER_CELL * n * n / PEAK_FLOPS[tname] * 1e3
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "plain_ms": plain_ms,
                      "bytes": nbytes, "flops": FLOPS_PER_CELL * n * n,
                      "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms > ops_ms
                      else "operations"}
        print(f"  timing {n}^2 {tname}: kernel {ms:.4f} ms (repeat "
              f"{ms_again:.4f}), plain {plain_ms:.4f} ms, bound "
              f"{max(bytes_ms, ops_ms):.4f} ms (bytes {bytes_ms:.4f}, "
              f"operations {ops_ms:.4f}), library_ms null", flush=True)
    return out


def profile_main_path(dev, n=1024, tfinal=0.1):
    """The main path (Controller.run, quadrants n^2 float32) to `tfinal`,
    once on the host clock alone and once under torch.profiler: the
    device busy share of a main-path step, device time by kernel, and
    host time by operation (the latter inflated by the profiler)."""
    import torch

    def run():
        _, status, wall = run_quadrants(dev, n, np.float32, tfinal)
        return status["numsteps"] + status["numrejected"], wall

    steps, wall = run()                    # without the profiler
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        steps_prof, wall_prof = run()
    if steps_prof != steps:
        fail(f"profiled main path took {steps_prof} steps, not {steps}")
    dev_rows, host_rows = [], []
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            self_dev = getattr(ev, "self_device_time_total", None)
            if self_dev is None:
                self_dev = getattr(ev, "self_cuda_time_total", 0.0)
            dev_rows.append((self_dev, ev.key, ev.count))
        else:
            host_rows.append((ev.self_cpu_time_total, ev.key, ev.count))
    dev_rows.sort(reverse=True)
    host_rows.sort(reverse=True)
    step_ms = wall / steps * 1e3
    if not dev_rows:
        print("  profile: torch.profiler shows no device time; the kernel "
              "times above (CUDA events) stand alone", flush=True)
        return {"steps": steps, "step_ms": step_ms,
                "device_busy_share": None}
    device_us = sum(r[0] for r in dev_rows) / steps
    busy_share = device_us / (step_ms * 1e3)
    print(f"  profile main path {n}^2 f32 to t={tfinal}: {steps} steps, "
          f"{step_ms:.4f} ms/step wall ({wall_prof / steps * 1e3:.4f} under "
          f"the profiler), device kernels {device_us:.2f} us/step, device "
          f"busy share {busy_share:.4f}", flush=True)
    for self_dev, key, count in dev_rows[:6]:
        print(f"    device {self_dev / steps:10.3f} us/step  {count:6d}x  "
              f"{key[:60]}")
    for self_cpu, key, count in host_rows[:6]:
        print(f"    host   {self_cpu / steps:10.3f} us/step  {count:6d}x  "
              f"{key[:60]}")
    return {"steps": steps, "step_ms": step_ms,
            "step_ms_profiled": wall_prof / steps * 1e3,
            "device_us_per_step": device_us,
            "device_busy_share": busy_share,
            "kernels_us_per_step": {k[:60]: s / steps
                                    for s, k, _ in dev_rows[:6]},
            "host_us_per_step_profiled": {k[:60]: s / steps
                                          for s, k, _ in host_rows[:6]}}


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    sys.path.insert(0, ROOT)
    from pyclaw_tpu_torch.ops import _build, tiled2d

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {kind}; nvidia-smi: {card}; torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    # [2] build every kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    report = _build.build_report("step2_ctu")
    lib = _build.load("step2_ctu")
    print(f"[2] built csrc/step2_ctu.cu for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s; shared memory per block "
          f"f32 {lib.step2_ctu_smem_bytes(0)} B, f64 "
          f"{lib.step2_ctu_smem_bytes(1)} B", flush=True)
    for line in report.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "smem")):
            print("    " + line.strip())

    # [3] kernel against its plain version
    t0 = time.perf_counter()
    worst, worst_cfl, main_abs_err, ncase = compare_kernel(
        dev, [(1024, 1024), (80, 80), (128, 128), (100, 37)])
    print(f"[3] kernel vs plain: {ncase} cases, max rel err f32 "
          f"{worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{worst['float64']:.3e} (tol {TOL_REL['float64']}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # [4] the main path, with the launch count read around it
    tiled2d.step2_rows.launches = 0
    claw, status, wall = run_quadrants(dev, 1024, np.float32)
    launches = tiled2d.step2_rows.launches
    ns, nr = status["numsteps"], status["numrejected"]
    q = claw.solution.q
    print(f"[4] main path 1024^2 f32 to t={claw.solution.t}: {ns} accepted "
          f"+ {nr} rejected steps, {launches} kernel launches, "
          f"{wall:.3f} s wall, {ns * 1024 * 1024 / wall:.4e} "
          f"cell-updates/s", flush=True)
    if launches == 0 or launches != ns + nr:
        fail(f"launches {launches} != accepted {ns} + rejected {nr}")
    if nr < 1:
        fail("the first step at dt_initial=0.1 should be rejected")
    if q.shape != (4, 1024, 1024) or not np.all(np.isfinite(q)):
        fail("main path result is not finite (4, 1024, 1024)")
    if not claw.solution.state.is_valid():
        fail("state.is_valid() is False after the main path")
    if abs(claw.solution.t - 0.8) > 1e-12:
        fail(f"main path ended at t={claw.solution.t}")

    # [5] goldens on the card
    golden = {}
    for n, name in ((80, "euler_2d_quadrants"),
                    (128, "euler_2d_quadrants_128")):
        ref = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))
        for tname, dtype in (("float32", np.float32),
                             ("float64", np.float64)):
            c, st, w = run_quadrants(dev, n, dtype)
            rel = float(np.max(np.abs(c.solution.q.astype(np.float64)
                                      - ref["q"]))
                        / np.max(np.abs(ref["q"])))
            golden[f"{name}:{tname}"] = rel
            print(f"[5] golden {name} {tname}: rel err {rel:.3e} (tol "
                  f"{GOLDEN_TOL[tname]}), {st['numsteps']} steps, "
                  f"{w:.3f} s", flush=True)
            if not rel <= GOLDEN_TOL[tname]:
                fail(f"golden {name} {tname}: {rel} > {GOLDEN_TOL[tname]}")
            if abs(c.solution.t - float(ref["t"])) > 1e-10:
                fail(f"golden {name} {tname}: t={c.solution.t}")

    # [6] timing and a profile window
    tm = timing(dev)
    prof = profile_main_path(dev)

    f32, f64 = tm["float32"], tm["float64"]
    record = {
        "name": "step2_ctu", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/step2_ctu.cu",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:113",
        "replaces_function": "step2_pallas_rows",
        "launches": launches, "max_abs_err": main_abs_err,
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": None,
        "shape": [4, 1028, 1028], "dtype": "float32",
        "ms_f64": f64["ms"], "plain_ms_f64": f64["plain_ms"],
        "bound_ms_f64": f64["bound_ms"], "bound_by_f64": f64["bound_by"],
        "max_rel_err_f64": worst["float64"],
        "max_rel_err_f32": worst["float32"],
    }
    summary = {"main_path": {"accepted": ns, "rejected": nr,
                             "wall_s": wall,
                             "cell_updates_per_s": ns * 1024 * 1024 / wall},
               "golden_rel_err": golden, "timing": tm, "profile": prof,
               "card": card, "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": [record], **summary}, f, indent=1)
    print(json.dumps(summary))
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
