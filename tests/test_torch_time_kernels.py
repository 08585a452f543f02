"""The CPU side of ``pyclaw_tpu_torch/ops/time_kernels.py``, the script
that times builds of one kernel against each other on a card: its
variant syntax, its reading of ``cuobjdump -sass``, and its timed cases
(shared with chip_smoke.py), which must call each wrapper as the main
path's solver does."""

import os

import numpy as np
import pytest
import torch

from pyclaw_tpu_torch.ops import tiled2d
from pyclaw_tpu_torch.ops import time_kernels as tk

SASS = """
        code for sm_90a
                Function : _Z6kernelIfEvv
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   FFMA R2, R3, R4, R5 ;
        /*0020*/              @!P0 BRA 0x80 ;
        /*0030*/                   FFMA.FTZ R2, R3, R4, R5 ;
        /*0040*/                   EXIT ;
                Function : _Z6kernelIdEvv
        /*0000*/                   DFMA R2, R4, R6, R8 ;
        /*0010*/               @P1 MUFU.RCP64H R3, R5 ;
"""


def test_parse_variant():
    label, root, source, flags = tk._parse_variant(
        "probe=build/parent:-prec-div=false,-DNDEBUG")
    assert label == "probe"
    assert root == os.path.abspath("build/parent")
    assert source is None
    assert flags == ["-prec-div=false", "-DNDEBUG"]
    assert tk._parse_variant("new=.")[2:] == (None, [])
    # another source of the root for the same case
    assert tk._parse_variant("old=build/parent@step3_aos") == (
        "old", os.path.abspath("build/parent"), "step3_aos", [])


def _first_call(monkeypatch, name, claw):
    """The arguments of the first call of ``tiled2d.<name>`` in a run,
    without ``out`` (the device loop's output buffer, not the case's)."""
    seen = []
    real = getattr(tiled2d, name)

    def spy(*args, **kwargs):
        seen.append((args, {k: v for k, v in kwargs.items() if k != "out"}))
        return real(*args, **kwargs)
    monkeypatch.setattr(tiled2d, name, spy)
    claw.run()
    assert seen
    return seen[0]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_dq_case_is_the_sharpclaw_path(monkeypatch):
    from pyclaw_tpu_torch.examples import euler_2d_quadrants as ex
    n = 12
    claw = ex.setup(mx=n, my=n, outdir=None, device="cpu",
                    solver_type="sharpclaw", dtype="float64")
    claw.tfinal = 0.01
    args, kwargs = _first_call(monkeypatch, "dq_rows", claw)
    qbc, case = tk.dq_case(n, torch.float64, "cpu")
    assert torch.equal(args[0], qbc)
    # the system, which the solver names: the case's is dq_rows's default
    assert kwargs.pop("rp") is tiled2d.euler.euler_4wave_2D
    # dt is the controller's; the rest is the case's
    assert args[2:] + tuple(kwargs.values()) == case[1:] + (5, 3)


def test_step2_ctu_case_is_the_classic_quadrants_path(monkeypatch):
    from pyclaw_tpu_torch.examples import euler_2d_quadrants as ex
    n = 12
    claw = ex.setup(mx=n, my=n, outdir=None, device="cpu", dtype="float64")
    claw.tfinal = 0.01
    args, kwargs = _first_call(monkeypatch, "step2_rows", claw)
    qbc, case = tk.step2_ctu_case(n, torch.float64, "cpu")
    assert torch.equal(args[0], qbc)
    path = args[2:] + tuple(kwargs.values())
    # dt is the controller's; the rest is the case's
    assert path[:3] == case[1:4] and tuple(path[3]) == case[4]
    assert path[4:] == case[5:]


def test_step3_ctu_case_is_the_euler_3d_path(monkeypatch):
    from pyclaw_tpu_torch.examples import euler_3d as ex
    n = 6
    claw = ex.setup(mx=n, my=n, mz=n, outdir=None, device="cpu",
                    dtype="float64")
    claw.tfinal = 0.01
    args, kwargs = _first_call(monkeypatch, "step3_xy", claw)
    qbc, case = tk.step3_ctu_case(n, torch.float64, "cpu")
    assert torch.equal(args[0], qbc)
    # the solver names the capacity function and the form: none here
    assert kwargs == {"auxbc": None, "index_capa": -1, "fwave": False}
    path = args[2:]
    assert path[:4] == case[1:5] and tuple(path[4]) == case[5]
    assert path[5:] == case[6:]
    # the case on another state of the path pads that state
    q = claw.solution.q
    assert torch.equal(tk.step3_ctu_case(n, torch.float64, "cpu", q)[0]
                       [(slice(None),) + (slice(2, -2),) * 3],
                       torch.as_tensor(q))


def test_step3_aos_case_is_the_heterogeneous_path(monkeypatch):
    from pyclaw_tpu_torch.examples import acoustics_3d_heterogeneous as ex
    n = 6
    claw = ex.setup(mx=n, my=n, mz=n, outdir=None, device="cpu",
                    dtype="float64")
    claw.tfinal = 0.01
    args, kwargs = _first_call(monkeypatch, "step3_xy_generic", claw)
    qbc, auxbc, case = tk.step3_aos_case(n, torch.float64, "cpu")
    assert torch.equal(args[1], auxbc)
    inner = (slice(None),) + (slice(2, -2),) * 3
    assert torch.equal(args[0][inner], qbc[inner])
    path = args[3:] + tuple(kwargs.values())
    assert path[:4] == case[1:5]            # dx, dy, dz, the system
    assert tiled2d.step3_system_scalars(path[3], path[4]) == \
        tiled2d.step3_system_scalars(case[4], case[5])
    assert tuple(path[5]) == case[6] and path[6:] == case[7:]


def test_step3_aos_euler_case_is_the_euler_capacity_path(monkeypatch):
    """The Euler capacity case (time_kernels.euler3d_capa_case, the case
    step3_aos's Euler system was timed on before the path moved to
    step3_ctu) is examples.euler_3d with the capacity function of
    euler_3d.add_capacity, as chip_smoke.py's [4g] path runs it: one call
    of step3_xy with that aux row as the capacity function."""
    from pyclaw_tpu_torch.examples import euler_3d as ex
    n = 6
    claw = ex.setup(mx=n, my=n, mz=n, outdir=None, device="cpu",
                    dtype="float64")
    ex.add_capacity(claw.solution.state)
    claw.tfinal = 0.01
    args, kwargs = _first_call(monkeypatch, "step3_xy", claw)
    qbc, auxbc, case = tk.euler3d_capa_case(n, torch.float64, "cpu")
    assert torch.equal(args[0], qbc)
    assert torch.equal(kwargs.pop("auxbc"), auxbc)
    assert kwargs == {"index_capa": 0, "fwave": False}
    kappa = auxbc[0, 2:-2, 2:-2, 2:-2]
    assert 0.75 <= float(kappa.min()) and float(kappa.max()) <= 1.25
    assert torch.equal(kappa, kappa.transpose(0, 1))
    path = args[2:]
    assert path[:4] == case[1:5]            # dx, dy, dz, gamma
    assert tuple(path[4]) == case[5] and path[5:] == case[6:]
    # the case on another state of the path pads that state
    q = claw.solution.q
    assert torch.equal(tk.euler3d_capa_case(n, torch.float64, "cpu", q)[0]
                       [(slice(None),) + (slice(2, -2),) * 3],
                       torch.as_tensor(q))


def test_step2_aos_case_is_the_shallow_path(monkeypatch):
    """step2_aos's case is examples.shallow_2d_radial's first step, as
    chip_smoke.py's [4d] path runs it."""
    from pyclaw_tpu_torch.examples import shallow_2d_radial as ex
    n = 12
    claw = ex.setup(mx=n, my=n, outdir=None, device="cpu", dtype="float64")
    claw.tfinal = 0.01
    args, kwargs = _first_call(monkeypatch, "step2_rows_generic", claw)
    qbc, case = tk.step2_aos_case(n, torch.float64, "cpu")
    assert torch.equal(args[0], qbc) and args[1] is None is case[0]
    path = args[3:] + tuple(kwargs.values())
    # dt is the controller's; the rest is the case's
    assert path[:3] == case[2:5] and path[3] == case[5]
    assert tuple(path[4]) == case[6] and path[5:] == case[7:]


def test_step2_aos_acoustics_case_is_the_acoustics_path(monkeypatch):
    """step2_aos's acoustics case is examples.acoustics_2d's first step,
    as chip_smoke.py's [4j] path runs it."""
    from pyclaw_tpu_torch.examples import acoustics_2d as ex
    n = 12
    claw = ex.setup(mx=n, my=n, outdir=None, device="cpu", dtype="float64")
    claw.tfinal = 0.01
    args, kwargs = _first_call(monkeypatch, "step2_rows_generic", claw)
    qbc, case = tk.step2_aos_acoustics_case(n, torch.float64, "cpu")
    assert torch.equal(args[0], qbc) and args[1] is None is case[0]
    path = args[3:] + tuple(kwargs.values())
    # dt is the controller's; the rest is the case's
    assert path[:3] == case[2:5] and path[3] == case[5]
    assert tuple(path[4]) == case[6] and path[5:] == case[7:]


@pytest.mark.parametrize("name,module", [
    ("kpp_2D", "kpp"), ("vc_acoustics_2D", "acoustics_2d_interface"),
    ("vc_advection_2D", "advection_2d")])
def test_step2_aos_scalar_case_is_the_example_path(monkeypatch, name,
                                                   module):
    """step2_aos's case of each scalar or variable-coefficient system with
    an example is that example's first step (its state, aux, deltas,
    limiters, options), as chip_smoke.py's [4s]-[4u] run it."""
    import importlib
    ex = importlib.import_module(f"pyclaw_tpu_torch.examples.{module}")
    n = 12
    claw = ex.setup(mx=n, my=n, outdir=None, device="cpu", dtype="float64")
    claw.tfinal = 0.01
    args, kwargs = _first_call(monkeypatch, "step2_rows_generic", claw)
    qbc, case = tk.step2_aos_scalar_case(name, n, torch.float64, "cpu")
    assert torch.equal(args[0], qbc)
    assert (args[1] is None is case[0]) or torch.equal(args[1], case[0])
    path = args[3:] + tuple(kwargs.values())
    # dt is the controller's; the rest is the case's
    assert path[:3] == case[2:5] and path[3] == case[5]
    assert tuple(path[4]) == case[6] and path[5:] == case[7:]


def test_step1_case_is_the_classic_sod_path(monkeypatch):
    """step1's case is the classic Sod path's first step, as chip_smoke.py's
    [4e] runs it (examples.euler_1d_shocktube, ClawSolver1D, MC)."""
    from pyclaw_tpu_torch.examples import euler_1d_shocktube as ex
    from pyclaw_tpu_torch.ops import sweep
    n = 40
    claw = ex.setup(nx=n, solver_type="classic", outdir=None, device="cpu",
                    dtype="float64")
    claw.tfinal = 0.01
    seen = []
    real = sweep.step1

    def spy(*args, **kwargs):
        seen.append(args + tuple(v for k, v in kwargs.items() if k != "out"))
        return real(*args, **kwargs)
    monkeypatch.setattr(sweep, "step1", spy)
    claw.run()
    path = seen[0]
    qbc, case = tk.step1_case(n, torch.float64, "cpu")
    assert torch.equal(path[0], qbc) and path[1] is None is case[0]
    # dt is the controller's; the rest is the case's
    assert path[3:5] == case[2:4]
    assert sweep.system_params(path[4], path[5]) == \
        sweep.system_params(case[3], case[4])
    assert tuple(path[6]) == case[5] and path[7:] == case[6:]


def test_step1_dam_case_is_the_dam_break_configuration(monkeypatch):
    """step1's "dam" case takes the dry dam break's configuration
    (examples.dam_break_dry: sw_aug_1D, grav, dry_tolerance, minmod,
    f-waves, the beach in aux) on a seeded wet/dry state, whose depths
    stay nonnegative and whose interfaces include dry and wet ones."""
    from pyclaw_tpu_torch.examples import dam_break_dry as ex
    from pyclaw_tpu_torch.ops import sweep
    n = 40
    claw = ex.setup(nx=n, outdir=None, device="cpu", dtype="float64")
    claw.tfinal = 0.01
    seen = []
    real = sweep.step1

    def spy(*args, **kwargs):
        seen.append(args + tuple(v for k, v in kwargs.items() if k != "out"))
        return real(*args, **kwargs)
    monkeypatch.setattr(sweep, "step1", spy)
    claw.run()
    path = seen[0]
    qbc, case = tk.step1_case(n, torch.float64, "cpu", "dam")
    assert qbc.shape == path[0].shape and case[0].shape == path[1].shape
    # the beach (the path's aux) is the case's
    assert torch.equal(case[0], path[1])
    assert path[3] == case[2] and path[4] is case[3]
    assert sweep.system_params(path[4], path[5]) == \
        sweep.system_params(case[3], case[4])
    assert tuple(path[6]) == case[5] and path[7:] == case[6:]
    h = qbc[0].numpy()
    assert h.min() == 0.0 and (h > 0.2).mean() > 0.5
    assert tk.CASES_1D["dam"] == ("dam", 2 ** 20)


def test_weno5_case_is_the_sharpclaw_sod_path(monkeypatch):
    """weno5's case is the SharpClaw Sod path's first input to weno5 (the
    initial state with three extrapolated ghost cells, (3, n + 6))."""
    from pyclaw_tpu_torch.examples import euler_1d_shocktube as ex
    from pyclaw_tpu_torch.ops import weno
    n = 40
    claw = ex.setup(nx=n, solver_type="sharpclaw", outdir=None,
                    device="cpu", dtype="float64")
    claw.tfinal = 0.001
    seen = []
    real = weno.weno5

    def spy(q, *args, **kwargs):
        seen.append(q.clone())
        return real(q, *args, **kwargs)
    monkeypatch.setattr(weno, "weno5", spy)
    claw.run()
    q = tk.weno5_case(n, torch.float64, "cpu")
    assert q.shape == (3, n + 6) and torch.equal(seen[0], q)


def test_smooth_state_keeps_its_bounds():
    """The smooth timed state: seeded, rho and p in 0.8 .. 1.2, |u| <= 0.4
    with both signs, and no two neighbouring cells equal (every interface
    carries waves)."""
    n = 4096
    q = tk.smooth_state(n)
    assert q.shape == (3, n) and np.array_equal(q, tk.smooth_state(n))
    rho, u = q[0], q[1] / q[0]
    p = 0.4 * (q[2] - 0.5 * rho * u * u)
    assert 0.8 <= rho.min() and rho.max() <= 1.2
    assert 0.8 <= p.min() and p.max() <= 1.2
    assert np.abs(u).max() <= 0.4 and u.min() < 0.0 < u.max()
    assert (np.diff(q, axis=1) != 0.0).all()


def test_outputs_of_a_step_and_of_weno5():
    q, cfl = torch.ones(3, 4), torch.tensor(0.5)
    out, c = tk._outputs((q, cfl))
    assert out is q and c == 0.5
    out, c = tk._outputs((q, 2 * q))
    assert out.shape == (2, 3, 4) and c is None
    assert torch.equal(out[1], 2 * q)


def test_parse_sass_counts_opcodes_per_entry():
    hist = tk.parse_sass(SASS)
    assert set(hist) == {"_Z6kernelIfEvv", "_Z6kernelIdEvv"}
    count, ops = hist["_Z6kernelIfEvv"]
    assert count == 5
    assert dict(ops) == {"MOV": 1, "FFMA": 2, "BRA": 1, "EXIT": 1}
    assert dict(hist["_Z6kernelIdEvv"][1]) == {"DFMA": 1, "MUFU": 1}


@pytest.mark.parametrize("path,size", [
    ("quadrants", {"mx": 12, "my": 12}),
    ("euler3d", {"mx": 6, "my": 6, "mz": 6}),
    ("shallow", {"mx": 12, "my": 12}),
    ("euler3d_capa", {"mx": 6, "my": 6, "mz": 6}),
    ("sharpclaw", {"mx": 12, "my": 12, "solver_type": "sharpclaw"}),
    ("sharpclaw_weno7", {"mx": 12, "my": 12, "solver_type": "sharpclaw",
                         "solver": {"weno_order": 7}}),
    ("sod", {"nx": 40, "solver_type": "classic"}),
    ("sod_sharpclaw", {"nx": 40, "solver_type": "sharpclaw"}),
    ("het", {"mx": 6, "my": 6, "mz": 6}),
    ("shock_bubble", {"mx": 24, "my": 8}),
    ("quadrants_aos", {"mx": 12, "my": 12, "solver": {"use_soa": False}}),
    ("shock_bubble_sharpclaw", {"mx": 24, "my": 8,
                                "solver_type": "sharpclaw"}),
    ("burgers3d", {"mx": 6, "my": 6, "mz": 6}),
    ("psystem_unsplit", {"mx": 12, "my": 12, "dimensional_split": False}),
    ("swirl", {"mx": 12, "my": 12})])
def test_time_paths_runs_each_path_in_its_own_process(path, size):
    """ops/time_paths.py's timed run (a fresh process importing the
    package from a root), on the CPU at a small size."""
    from pyclaw_tpu_torch.ops import time_paths
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rec = time_paths.run_one(root, path, device="cpu", size=size,
                             tfinal=0.02)
    assert rec["accepted"] >= 1 and rec["rejected"] >= 0
    assert rec["wall_s"] > 0 and rec["cell_updates_per_s"] > 0
    # the wrappers count launches of the kernel only, never on the CPU
    assert rec["launches"] == 0
    # the timed run's device loop: no graph on the CPU
    loop = rec["loop"]
    assert loop["frames"] >= 1 and loop["captures"] == 0
    assert loop["readbacks"] >= loop["frames"]
    assert loop["attempts"] == (loop["after_end"] + rec["accepted"]
                                + rec["rejected"])


# A ptxas -v report of two instances of csrc/dq2_weno.cu and a function
# that is not an entry
PTXAS = """
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__a29add1a_11_dq2_weno_cu_963421ad15dq2_weno_kernelINS_6Euler5ELi9EdEEvNS_4ArgsIT_T1_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__a29add1a_11_dq2_weno_cu_963421ad15dq2_weno_kernelINS_6Euler5ELi9EdEEvNS_4ArgsIT_T1_EE
    64 bytes stack frame, 208 bytes spill stores, 268 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 64 bytes cumulative stack size, 32 bytes smem
ptxas info    : Function properties for _ZN44_GLOBAL__N__a29add1a_11_dq2_weno_cu_963421ad10weno_edgesILi9EdEENS_5EdgesIT0_EEPKS2_i
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__a29add1a_11_dq2_weno_cu_963421ad15dq2_weno_kernelINS_9AcousticsELi4EfEEvNS_4ArgsIT_T1_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__a29add1a_11_dq2_weno_cu_963421ad15dq2_weno_kernelINS_9AcousticsELi4EfEEvNS_4ArgsIT_T1_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 47 registers, used 1 barriers, 16 bytes smem
"""


@pytest.mark.parametrize("instance,resources", [
    (("euler_5wave_2D", 17, "float64"),
     {"registers": 96, "stack": 64, "spill_stores": 208,
      "spill_loads": 268}),
    (("acoustics_2D", 7, "float32"),
     {"registers": 47, "stack": 0, "spill_stores": 0, "spill_loads": 0}),
    (None, {"registers": None, "stack": 0, "spill_stores": 8,
            "spill_loads": 8})])
def test_ptxas_resources_of_dq_weno_instances(instance, resources):
    """Each function of a ptxas report with its registers (entries only),
    stack frame and spill bytes; the instance of csrc/dq2_weno.cu that a
    mangled entry name is (None for another function)."""
    found = {tk.dq_weno_instance(fn): rec
             for fn, rec in tk.ptxas_resources(PTXAS).items()}
    assert found[instance] == resources


# A ptxas -v report of four of csrc/step2_aos.cu's entries: an Euler
# 5-wave instance (float64, 11x15, capacity, f-waves), a psystem_2D one
# (float32, 16x32, f-waves), a vc_advection_fwave_2D one (the generic
# design) and a shallow-water one
PTXAS_AOS = """
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__565f0220_12_step2_aos_cu_0279f50516step2_aos_kernelINS_9Psystem2DEfLi16ELi32ELb0ELb1EEEvNS_4ArgsIT0_NT_3ParIS3_EEXcl4nlimIS4_EEEEE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__565f0220_12_step2_aos_cu_0279f50516step2_aos_kernelINS_9Psystem2DEfLi16ELi32ELb0ELb1EEEvNS_4ArgsIT0_NT_3ParIS3_EEXcl4nlimIS4_EEEEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__565f0220_12_step2_aos_cu_0279f50516step2_aos_kernelINS_18VcAdvectionFwave2DEfLi12ELi15ELb0ELb1EEEvNS_4ArgsIT0_NT_3ParIS3_EEXcl4nlimIS4_EEEEE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__565f0220_12_step2_aos_cu_0279f50516step2_aos_kernelINS_18VcAdvectionFwave2DEfLi12ELi15ELb0ELb1EEEvNS_4ArgsIT0_NT_3ParIS3_EEXcl4nlimIS4_EEEEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 38 registers, used 1 barriers, 16 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__565f0220_12_step2_aos_cu_0279f50516step2_aos_kernelINS_10EulerAoS2DILi5EEEdLi11ELi15ELb1ELb1EEEvNS_4ArgsIT0_NT_3ParIS4_EEXcl4nlimIS5_EEEEE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__565f0220_12_step2_aos_cu_0279f50516step2_aos_kernelINS_10EulerAoS2DILi5EEEdLi11ELi15ELb1ELb1EEEvNS_4ArgsIT0_NT_3ParIS4_EEXcl4nlimIS5_EEEEE
    16 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes cumulative stack size, 32 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__565f0220_12_step2_aos_cu_0279f50516step2_aos_kernelINS_16ShallowRoeEfix2DEfLi12ELi15ELb0ELb0EEEvNS_4ArgsIT0_NT_3ParIS3_EEXcl4nlimIS4_EEEEE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__565f0220_12_step2_aos_cu_0279f50516step2_aos_kernelINS_16ShallowRoeEfix2DEfLi12ELi15ELb0ELb0EEEvNS_4ArgsIT0_NT_3ParIS3_EEXcl4nlimIS4_EEEEE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 61 registers, used 1 barriers, 16 bytes smem
"""


@pytest.mark.parametrize("instance,resources", [
    (("euler_5wave_2D", "float64", True, True),
     {"registers": 128, "stack": 16, "spill_stores": 24,
      "spill_loads": 24}),
    (("psystem_2D", "float32", False, True),
     {"registers": 40, "stack": 0, "spill_stores": 0, "spill_loads": 0}),
    (None, {"registers": 61, "stack": 0, "spill_stores": 0,
            "spill_loads": 0})])
def test_ptxas_resources_of_step2_aos_euler_instances(instance, resources):
    """The instance of csrc/step2_aos.cu of a design of its own (Euler,
    psystem_2D, vc_advection_2D) that a mangled entry name is, (system,
    type, capacity, f-waves), and its resources from the report (None
    for another system's entry: vc_advection_fwave_2D's and shallow
    water's are the generic design's)."""
    found = {}
    for fn, rec in tk.ptxas_resources(PTXAS_AOS).items():
        key = tk.step2_aos_instance(fn)
        found.setdefault(key, []).append(rec)
    assert resources in found[instance]
    assert len(found) == 3 and len(found[None]) == 2


def _sass_build(ns, base, op="DFMA R2"):
    """cuobjdump -sass text of a build: two entries in anonymous namespace
    ``ns``, at address ``base``, with encodings."""
    return f"""
        code for sm_90a
                Function : _ZN12_GLOBAL__N__{ns}_1kIfEvv
        /*{base:04x}*/                   MOV R1, c[0x0][0x28] ;   /* 0x00000a0000017a02 */
                                                                 /* 0x000fe40000000f00 */
        /*{base + 16:04x}*/              @!P0 BRA 0x80 ;          /* 0x0000000000008947 */
                Function : _ZN12_GLOBAL__N__{ns}_1kIdEvv
        /*{base:04x}*/                   {op}, R4, R6, R8 ;       /* 0x0000000604027229 */
"""


def test_sass_digests_compare_builds_entry_by_entry():
    """Two builds' entries compare equal when their instructions are,
    whatever the address comments, the encodings and the anonymous
    namespace's name of each build; one changed instruction makes its
    entry differ."""
    a = tk.sass_digests(_sass_build("1f0a", 0))
    b = tk.sass_digests(_sass_build("2e9b", 0x100).replace(
        "0x000fe4", "0x000fe5"))
    assert sorted(a) == ["_ZN12_GLOBAL__N__1kIdEvv",
                         "_ZN12_GLOBAL__N__1kIfEvv"]
    assert tk.sass_compare(a, b) == (sorted(a), [])
    c = tk.sass_digests(_sass_build("2e9b", 0, op="DFMA R4"))
    assert tk.sass_compare(a, c) == (["_ZN12_GLOBAL__N__1kIfEvv"],
                                     ["_ZN12_GLOBAL__N__1kIdEvv"])
    assert tk.sass_compare({"x": "1"}, {"y": "1"}) == ([], ["x", "y"])


@pytest.mark.parametrize("label,name", [("euler4 ragged", "euler_4wave_2D"),
                                        ("euler5 ragged", "euler_5wave_2D")])
def test_step2_aos_euler_ragged_cases(label, name):
    """time_kernels step2_aos times each Euler instance also on a ragged
    grid, no multiple of either type's tile, with its full-size case's
    arguments."""
    assert label in tk._step2_aos_call(torch.float64, "cpu", n=8)
    qbc, args = tk.step2_aos_euler_ragged_case(name, torch.float64, "cpu")
    nx, ny = tk.EULER_RAGGED
    assert nx % 11 and nx % 12 and ny % 15
    assert qbc.shape == (5 if name == "euler_5wave_2D" else 4, nx + 4,
                         ny + 4)
    assert args[4].name == name and args[2] == args[3] == 1.0 / nx


@pytest.mark.parametrize("label", sorted(tk.OWN_VARIANTS))
def test_step2_aos_own_variant_cases(label):
    """time_kernels step2_aos times psystem_2D and vc_advection_2D also in
    their other variants (transverse_waves, a capacity row appended to
    aux, f-waves) on their path's state: the path's case but for those."""
    assert label in tk._step2_aos_call(torch.float64, "cpu", n=8)
    name, tw, capa, fwave = tk.OWN_VARIANTS[label]
    qbc, args = tk.step2_aos_variant_case(label, 8, torch.float64, "cpu")
    base = (tk.step2_aos_scalar_case if name in tk.SCALAR_CASES
            else tk.step2_aos_no_trans_case)(name, 8, torch.float64, "cpu")
    naux = base[1][0].shape[0]
    assert torch.equal(qbc, base[0]) and args[4].name == name
    assert args[0].shape[0] == naux + capa and args[9] == (naux if capa
                                                           else -1)
    assert torch.equal(args[0][:naux], base[1][0])
    assert args[8] == fwave and args[11] == tw
    assert args[1:8] == base[1][1:8] and args[10] == base[1][10]


@pytest.mark.parametrize("order", tk.WENO_ORDERS)
@pytest.mark.parametrize("name", tk.DQ_WENO_SYSTEMS)
def test_dq_weno_cases_are_the_chip_smoke_cases(order, name):
    """time_kernels dq2_weno times each instance on chip_smoke.py's [4y]
    cases (dq_weno_case): its 1024^2 (Euler 5-wave 2048x512) state and the
    ragged 250x171 one, on which the Euler systems take the positivity
    fallback; the states are made only when a variant is timed on
    them."""
    makes = tk._dq_weno_call(torch.float64, "cpu")
    assert len(makes) == 2 * len(tk.WENO_ORDERS) * len(tk.DQ_WENO_SYSTEMS)
    assert {f"{order} {name}", f"{order} {name} ragged"} <= set(makes)
    k = (order + 1) // 2
    rp = tk.dq_weno_rp(name)
    qbc, dt, dx, dy = tk.dq_weno_case(name, order, "float64", "cpu",
                                      big=False)
    assert qbc.shape == (rp.num_eqn, 250 + 2 * k, 171 + 2 * k)
    assert (dt, dx, dy) == (0.3 / 250, 1.0 / 250, 1.0 / 171)
    if rp.positivity is not None:
        from pyclaw_tpu_torch.sharpclaw import soa
        assert soa.fallback_count(qbc, tk.dq_weno_params(name),
                                  rp.positivity, order) > 0


def test_dq_weno_kernel_is_a_choice():
    """The kernel dq2_weno and --only parse; a run needs a card."""
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tk.main(["dq2_weno", "new=.", "--only", "7 euler_4wave_2D"])


# A ptxas -v report of the redesigned instances: dq2_weno5.cu's Euler
# 5-wave (float64) and step3_aos.cu's burgers_3D (float32, capacity, no
# f-waves), and an entry of another system of each
PTXAS_REDESIGNED = """
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c1d2e3f_12_dq2_weno5_cu_4a5b6c7d16dq2_weno5_kernelINS_6Euler5EdEEvNS_4ArgsIT_T0_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__0c1d2e3f_12_dq2_weno5_cu_4a5b6c7d16dq2_weno5_kernelINS_6Euler5EdEEvNS_4ArgsIT_T0_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 32 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__0c1d2e3f_12_dq2_weno5_cu_4a5b6c7d16dq2_weno5_kernelINS_6Euler4EfEEvNS_4ArgsIT_T0_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__0c1d2e3f_12_dq2_weno5_cu_4a5b6c7d16dq2_weno5_kernelINS_6Euler4EfEEvNS_4ArgsIT_T0_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 71 registers, used 1 barriers, 16 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__5e6f7a8b_12_step3_aos_cu_9c0d1e2f16step3_aos_kernelINS_9Burgers3DEfLb1ELb0EEEvNS_4ArgsIT0_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__5e6f7a8b_12_step3_aos_cu_9c0d1e2f16step3_aos_kernelINS_9Burgers3DEfLb1ELb0EEEvNS_4ArgsIT0_EE
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 8 bytes cumulative stack size, 76 bytes smem
ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__5e6f7a8b_12_step3_aos_cu_9c0d1e2f16step3_aos_kernelINS_13VcAcoustics3DEdLb0ELb1EEEvNS_4ArgsIT0_EE' for 'sm_90a'
ptxas info    : Function properties for _ZN45_GLOBAL__N__5e6f7a8b_12_step3_aos_cu_9c0d1e2f16step3_aos_kernelINS_13VcAcoustics3DEdLb0ELb1EEEvNS_4ArgsIT0_EE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 152 bytes smem
"""


@pytest.mark.parametrize("parse,instance,resources", [
    (tk.dq2_weno5_instance, ("euler_5wave_2D", "float64"),
     {"registers": 80, "stack": 0, "spill_stores": 0, "spill_loads": 0}),
    (tk.dq2_weno5_instance, ("euler_4wave_2D", "float32"),
     {"registers": 71, "stack": 0, "spill_stores": 0, "spill_loads": 0}),
    (tk.step3_aos_instance, ("burgers_3D", "float32", True, False),
     {"registers": 64, "stack": 8, "spill_stores": 4, "spill_loads": 4}),
    (tk.step3_aos_instance, ("vc_acoustics_3D", "float64", False, True),
     {"registers": 128, "stack": 0, "spill_stores": 0, "spill_loads": 0})])
def test_ptxas_resources_of_redesigned_instances(parse, instance,
                                                 resources):
    """The instance of csrc/dq2_weno5.cu ((system, type)) or of
    csrc/step3_aos.cu ((system, type, capacity, f-waves)) that a mangled
    entry name is, and its resources from the report; another kernel's
    entry is None to each parser."""
    found = {parse(fn): rec
             for fn, rec in tk.ptxas_resources(PTXAS_REDESIGNED).items()}
    assert found[instance] == resources
    assert len([k for k in found if k is not None]) == 2


def test_dq2_weno5_cases_cover_the_paths_shape_and_a_ragged_grid():
    """time_kernels dq2_weno5 times the Euler 5-wave instance at 2048x512,
    at the [4q] SharpClaw path's 1024x256 and on a ragged 250x171 state of
    several tiles that takes the positivity fallback, each with its CFL
    partials; the states are made only when a variant is timed on them."""
    from pyclaw_tpu_torch.sharpclaw import soa
    makes = tk._dq_call(torch.float64, "cpu", n=16)
    assert set(makes) == {"", "euler5", "euler5 path", "euler5 ragged"}
    qbc, args, rp = tk.dq_euler5_case(512, torch.float32, "cpu")
    assert qbc.shape == (5, 1024 + 6, 256 + 6) and rp.num_eqn == 5
    qbc, args, rp = tk.dq_euler5_ragged_case(torch.float64, "cpu")
    assert qbc.shape == (5, 250 + 6, 171 + 6)
    assert 250 % 16 and 171 % 16 and rp.name == "euler_5wave_2D"
    assert soa.fallback_count(qbc, args[3], rp.positivity, 5) > 0


def test_step3_aos_burgers_cases_are_chip_smokes_options():
    """time_kernels step3_aos times burgers_3D on every option of [3o]:
    the run's at 192^3 on the pulse, the others there too, and every one
    on a ragged grid of several 8x8x8 tiles on a state of either sign,
    with a capacity row where the option has one."""
    makes = tk._step3_aos_call(torch.float64, "cpu", n=8)
    n = len(tk.BURGERS3D_OPTS)
    assert len(makes) == 2 + (n - 1) + n
    assert all(f"burgers ragged v{k}" in makes for k in range(n))
    assert tk.BURGERS3D_OPTS[0] == (2, 2, 4, -1, False, True)
    nx, ny, nz = tk.BURGERS3D_RAGGED
    assert nx > 16 and ny > 8 and nz > 8 and nx % 8 and ny % 8 and nz % 8
    for k, (tw, order, lim, capa, fwave, efix) in enumerate(
            tk.BURGERS3D_OPTS):
        qbc, auxbc, args = tk.step3_aos_burgers_variant_case(
            k, tk.BURGERS3D_RAGGED, torch.float64, "cpu")
        assert qbc.shape == (1, nx + 4, ny + 4, nz + 4)
        assert float(qbc.min()) < 0.0 < float(qbc.max())
        assert (auxbc is None) == (capa < 0)
        assert args[4].name == "burgers_3D" and args[5] == {"efix": efix}
        assert args[6:] == ((lim,), order, fwave, capa, 2, tw)
    qbc, auxbc, args = tk.step3_aos_burgers_variant_case(
        0, (8, 8, 8), torch.float32, "cpu")
    ref = tk.step3_aos_burgers_case(8, torch.float32, "cpu")
    assert torch.equal(qbc, ref[0]) and auxbc is None
