"""Controller: run orchestration and frame output.

Counterpart of ``pyclaw_tpu/controller.py``, a rebuild of reference
``src/pyclaw/controller.py — class Controller`` (:~1-600; SURVEY.md §2.1,
call stack §3.1).  Behavioral parity: output
styles 1/2/3, keep_copy frames, output_format (name, list, or None),
write_aux_init/always, derived-quantity output (compute_p / file_prefix_p),
returns solver.status from run().
"""

from __future__ import annotations

import copy
import logging
import os

logger = logging.getLogger("pyclaw.controller")


class Controller:
    def __init__(self):
        self.solver = None
        self.solution = None
        self.tfinal = 1.0
        self.output_style = 1
        self.num_output_times = 10
        self.out_times = []
        self.nstepout = 1
        self.keep_copy = False
        self.frames = []
        self.output_format = "ascii"
        self.outdir = "./_output"
        self.output_file_prefix = None
        self.write_aux_init = False
        self.write_aux_always = False
        self.output_options = {}
        self.compute_p = None
        self.file_prefix_p = "claw_p"
        # functional output (reference controller.py F_path/compute_F):
        # compute_F(state) fills state.F (num_F, *cells); each frame
        # appends "t sum(F_0) sum(F_1) ..." to <outdir>/<F_file_name>.txt
        self.compute_F = None
        self.F_file_name = "F"
        self.verbosity = 3
        self.check_validity = False
        # observability: set to a directory path to wrap the whole run in
        # torch.profiler; the Chrome trace (<profile_dir>/trace.json)
        # covers every kernel launch and host step.
        self.profile_dir = None

    @property
    def num_eqn(self):
        return self.solution.state.num_eqn

    def _output_times(self):
        t0 = self.solution.t
        if self.output_style == 1:
            dt_out = (self.tfinal - t0) / self.num_output_times
            return [t0 + (i + 1) * dt_out for i in range(self.num_output_times)]
        elif self.output_style == 2:
            return list(self.out_times)
        elif self.output_style == 3:
            return None  # every nstepout steps
        raise ValueError(f"bad output_style {self.output_style}")

    def _frame_kwargs(self, frame, file_format):
        """Solution.write's keywords for frame ``frame`` in
        ``file_format``."""
        kwargs = dict(file_format=file_format,
                      path=self.outdir,
                      write_aux=(self.write_aux_always or
                                 (frame == 0 and self.write_aux_init)),
                      options=self.output_options)
        if self.output_file_prefix is not None:
            kwargs["file_prefix"] = self.output_file_prefix
        return kwargs

    def _write(self, frame):
        if self.output_format is None:
            return
        self.solution.write(frame, **self._frame_kwargs(frame,
                                                        self.output_format))
        if self.compute_p is not None:
            self.solution.state.compute_p = self.compute_p
            self.solution.write(frame, path=self.outdir,
                                file_format=self.output_format,
                                file_prefix=self.file_prefix_p, write_p=True)
        self._write_F(frame)

    def _write_F(self, frame):
        """Append the functional values for this frame (reference
        controller.py F_path handling): one line 't F_0 F_1 ...' where
        F_i = cell sum of row i of compute_F's output."""
        import numpy as np
        state = self.solution.state
        compute_F = self.compute_F or state.compute_F
        if compute_F is None:
            return
        state.compute_F = compute_F
        compute_F(state)
        if state.F is None:
            return
        F = np.asarray(state.F)
        sums = F.reshape(F.shape[0], -1).sum(axis=1)
        mode = "w" if frame == 0 else "a"
        with open(os.path.join(self.outdir,
                               f"{self.F_file_name}.txt"), mode) as f:
            f.write(" ".join(f"{v:.15e}" for v in
                             [self.solution.t, *sums]) + "\n")

    def _configure_logging(self):
        """Wire verbosity to the named logger hierarchy (reference
        log.config / SURVEY.md §5.5: pyclaw.controller / pyclaw.solver /
        pyclaw.io loggers; level driven by controller.verbosity)."""
        level = {0: logging.ERROR, 1: logging.WARNING, 2: logging.INFO,
                 3: logging.INFO}.get(min(self.verbosity, 3), logging.DEBUG)
        for name in ("pyclaw.controller", "pyclaw.solver", "pyclaw.io"):
            logging.getLogger(name).setLevel(level)
        if self.solver is not None:
            self.solver.verbosity = self.verbosity

    def run(self):
        if self.profile_dir is None:
            return self._run()
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.solver is not None and self.solver.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            status = self._run()
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.profile_dir,
                                              "trace.json"))
        return status

    def _run(self):
        if self.solver is None or self.solution is None:
            raise ValueError("Controller needs solver and solution")
        self._configure_logging()
        if not self.solver._is_set_up:
            self.solver.setup(self.solution)

        if self.output_format is not None:
            os.makedirs(self.outdir, exist_ok=True)

        frame = 0
        if self.keep_copy:
            self.frames.append(copy.deepcopy(self.solution))
        self._write(frame)

        if self.output_style in (1, 2):
            for tout in self._output_times():
                self.solver.evolve_to_time(self.solution, tout)
                frame += 1
                if self.keep_copy:
                    self.frames.append(copy.deepcopy(self.solution))
                if self.check_validity and not self.solution.state.is_valid():
                    raise Exception(f"invalid solution at t={self.solution.t}")
                self._write(frame)
        else:  # output_style == 3: every nstepout steps
            nsteps = 0
            while self.solution.t < self.tfinal - 1e-14:
                self.solver.evolve_to_time(self.solution)
                nsteps += 1
                if nsteps % self.nstepout == 0:
                    frame += 1
                    if self.keep_copy:
                        self.frames.append(copy.deepcopy(self.solution))
                    self._write(frame)

        self._write_gauges()
        status = self.solver.status
        logger.info("run finished: %s", status)
        return status

    def _write_gauges(self):
        """Dump recorded gauge time series to <outdir>/_gauges/gauge<N>.txt
        (reference: per-step file appends from write_gauge_values; here the
        series is buffered on device by the device loop and written once
        at the end — same file contents, one IO event)."""
        state = self.solution.state
        if not state.gauge_data or self.output_format is None:
            return
        gdir = os.path.join(self.outdir,
                            state.patch.grid.gauge_dir_name)
        os.makedirs(gdir, exist_ok=True)
        series = {}
        for num, t, vals in state.gauge_data:
            series.setdefault(num, []).append((t, vals))
        for num, rows in series.items():
            with open(os.path.join(gdir, f"gauge{num}.txt"), "w") as f:
                for t, vals in rows:
                    f.write(" ".join(f"{v:.15e}" for v in
                                     [t, *list(vals)]) + "\n")

    def plot(self, setplot=None):
        """Show this run's frames (``plot.interactive_plot``; needs
        matplotlib)."""
        from . import plot
        plot.interactive_plot(outdir=self.outdir,
                              file_format=self.output_format,
                              setplot=setplot)
