"""Drive pyclaw_tpu_torch on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. the card: name, nvidia-smi name and power limit;
  2. the build of every kernel from the checkout's sources (nvcc, sm_90a,
     one nvcc per source, all started together), with the ptxas report
     (registers, shared memory, spills), and each instance of
     csrc/dq2_weno.cu's shared memory and resident blocks per SM;
  (every main path runs on the device loop: solver.py's _DeviceLoop
     replays one attempted step as a CUDA graph.  Every wrapper's count
     and its device counter (ops.count_on_device: one more on the card's
     stream right after each launch, so a replay counts) are set to 0
     just before each main path and read just after: the wrappers count
     the launches they make or capture (an eager warm-up attempt and two
     captured ones a capture), the device counters the launches the card
     ran, the kernel's per attempted step times the attempts, the
     accepted, the rejected and those after the loop's end, and one
     restore each; the kernels line gives the device counters' count);
  3. step2_ctu against its plain PyTorch version on the card, over the
     quadrants initial condition and a seeded random admissible state,
     grids 1024^2, 80^2, 128^2, 100x37 and 64x100, float32 and float64,
     transverse_waves 0/1/2, order 1/2, limiters {3, 4, 10};
  3b. dq2_weno5 against its plain version (one dq each), over the
     quadrants state, a seeded random admissible state and a seeded state
     whose WENO edges go non-positive (the positivity fallback), same
     grids and dtypes, and 7x5 (less than a tile) and 600x700 (ragged,
     more tiles than resident blocks);
  3c. step3_ctu against its plain PyTorch version (one step each), over
     the euler_3d initial state and a seeded random admissible state with
     velocities in all three directions: the main configuration
     (transverse_waves 2, order 2, MC) at 192^3, and transverse_waves
     0/1/2 x order 1/2 x limiters {4, 3, 10} at 16^3, 33x17x9 and 5x40x7,
     float32 and float64;
  3d. step2_aos against its plain PyTorch version (one step each), over
     the radial dam break state, the radial acoustics pulse and a seeded
     random wet state, grids 1024^2, 60^2, 125^2, 64x100 and 100x37,
     float32 and float64: the shallow-water Roe solver for
     transverse_waves 0/1/2 x order 1/2, bathymetry f-waves with aux,
     with and without a capacity function, and the acoustics instance
     (two waves) for transverse_waves 0/1/2 x order 1/2 x {MC, minmod};
  3e. step1 against its plain PyTorch version (one step each): the five
     1D systems (advection, acoustics, Euler with and without the entropy
     fix, HLLE) at n in {1, 7, 251, 252, 253, 255, 256, 257, 505, 800,
     100003} on seeded
     random states (and the Sod state at 800), order 1/2 with MC, van
     Leer and the CFL-dependent id 10; advection with a non-uniform
     capacity function and with the f-wave form; then sw_aug_1D (f-waves,
     the bottom in aux) at n in {1, 7, 251, 252, 253, 500, 505, 100003} on
     seeded wet/dry states that take every branch of the augmented solver
     (wet/wet, the Ritter fronts, walls on either side, both dry, damp
     cells) and on the dry dam break's first state at 500, order 1/2 with
     minmod and MC; float32 and float64, the CFL equal bit for bit;
  3f. weno5 against its plain version at (1, 5), (3, 806), (4, 37, 131),
     the small tile's edges (3, 127), (3, 129), (65537, 4), the large
     tile's edges ((257, 1023), (257, 1024), (257, 1025), (129, 2051) in
     f32 and (513, 511), (513, 512), (513, 513), (257, 1027) in f64) and
     (3, 2^20+6): seeded random data, constant data (finite in float32
     too) and the Sod state padded for SharpClaw;
  3g. step3_aos against its plain PyTorch version (one step each), over
     the layered-medium state of examples.acoustics_3d_heterogeneous and a
     seeded random state with aux in 1 +- 0.2 and a capacity row: the main
     configuration (heterogeneous acoustics, transverse_waves 1, order 2,
     MC) at 192^3, and each system (vc_acoustics_3D, acoustics_3D,
     advection_3D) for transverse_waves 0/1/(2 where the system has
     rptt3) x (order, limiter) in {(1, MC), (2, MC), (2, van Leer), (2,
     id 10)} x with and without a capacity function (and the f-wave form
     on advection) at 16^3, 33x17x9, 5x40x7 and 3x5x2 (less than a tile),
     and the main configuration at 45x70x50 (ragged on every axis, more
     tiles than resident blocks), float32 and float64;
  3h. step3_ctu's capacity and f-wave variants against the plain version
     (one step each), over the slice's state (examples.euler_3d with the capacity function
     kappa = 1 + 0.25 cos(pi x) cos(pi y) cos(pi z)) and a seeded random
     admissible state with velocities in all three directions and a
     capacity row in 0.7 .. 1.3: the main configuration (capacity,
     transverse_waves 2, order 2, MC) at 192^3 and 45x70x50, and
     transverse_waves 0/1/2 x (order, limiter) in {(1, MC), (2, MC), (2,
     van Leer), (2, id 10)} x {f-waves without aux, capacity, capacity
     with f-waves} at 16^3, 33x17x9, 5x40x7 and 3x5x2, float32 and
     float64;
  3i. restore (the device loop's guarded restore, csrc/restore.cu)
     against torch.where, an accepted and a rejected step, at the paths'
     shapes and odd sizes, equal bit for bit;
  3j. dq2_weno5's acoustics instance against its plain version
     (sharpclaw/soa.py:dq_2d_soa with acoustics_2D's SoA hooks; one dq
     each), over a seeded random state and the radial pulse of
     examples.acoustics_2d, grids 1024^2, 1000x997 and 17x33, float32 and
     float64, the CFL to the same tolerance;
  3k. weno5 against its plain version on the SharpClaw 3D path's shapes:
     (5, 198^3) with each axis moved last and made contiguous, as dq_nd
     calls it, over the Euler 3D example's first state and a seeded
     random one, float32 and float64;
  3l. step2_aos's instances of this slice against the plain version (one
     step each): the Euler 4-wave system on the quadrants state and a
     seeded random admissible state, the Euler 5-wave system on the
     shock-bubble state and a seeded random state with a tracer (speeds
     crossing zero), sw_aug_2D on seeded wet/dry states that take every
     branch of the augmented solver and on the radial-bump state (the
     bottom in aux), at 1024^2, 60^2, 100x37, 64x100, 7x5 and 600x700,
     float32 and float64: transverse_waves 0/1/2 x order 1/2 with MC, van
     Leer and id 10 with a capacity row, and the f-wave form (four of
     these at 1024^2 and 600x700);
  3m. dq2_weno5's Euler 5-wave instance against its plain version (one dq
     each) on [3b]'s grids and kinds of state, each with a tracer;
  3n. step2_aos's scalar and variable-coefficient instances (advection_2D,
     vc_advection_2D, vc_advection_fwave_2D, vc_acoustics_2D, kpp_2D,
     burgers_2D) against the plain version (one step each) at 1024^2, 7x5
     (less than a tile) and 600x700 (ragged, several tiles), on each
     run's first state and a seeded random one (aux jumping along both
     axes across the tiles' edges; Burgers with transonic interfaces),
     float32 and float64, transverse_waves 0/1/2, order 1/2, MC, minmod
     and the CFL-dependent id 10, a capacity row, the f-wave form,
     Burgers with and without the entropy fix;
  3o. step3_aos's burgers_3D instance against the plain version at 192^3,
     17x13x9 and 3x5x2, on the pulse and a seeded random state, float32
     and float64;
  4. the classic main path: examples.euler_2d_quadrants.setup(mx=1024,
     my=1024, float32) through Controller.run() to tfinal=0.8, with the
     kernel's launch count read around it;
  4b. the SharpClaw path: the same setup with solver_type="sharpclaw"
     (WENO5, SSP104) through Controller.run() to tfinal=0.8, with
     dq2_weno5's launch count read around it (10 per attempted step);
  4c. the 3D path: examples.euler_3d.setup(mx=my=mz=192, float32)
     through Controller.run() to tfinal=0.2, with step3_ctu's launch count
     read around it (1 per attempted step);
  4d. the shallow-water path: examples.shallow_2d_radial.setup(mx=1024,
     my=1024, float32) through Controller.run() to tfinal=1.0, with
     step2_aos's launch count read around it (1 per attempted step), mass
     conservation and the x/y mirror symmetry of the depth;
  4e. the 1D Sod path: examples.euler_1d_shocktube.setup(nx=800, float32)
     to t=0.2, classic (ClawSolver1D, MC) and SharpClaw (WENO5, SSP104),
     each with every launch count set to 0 just before it and read just
     after (step1: 1 per attempted step; weno5: 10), against the same run
     in float64, with the change of mass and energy;
  4f. the 3D heterogeneous-acoustics path:
     examples.acoustics_3d_heterogeneous.setup(mx=my=mz=192, float32)
     through Controller.run() to tfinal=0.8, every launch count set to 0
     just before it and read just after (step3_aos: 1 per attempted step;
     no other kernel);
  4g. the 3D Euler capacity path: examples.euler_3d.setup(mx=my=mz=192,
     float32) with the capacity function of [3h] (one aux row, index_capa
     0) through Controller.run() to tfinal=0.2, every launch count set to
     0 just before it and read just after (step3_ctu, its capacity
     variant: 1 per attempted step; step3_aos and every other kernel: 0);
  4h. the device loop against the host loop (traced_evolve = False) on
     each of the eight main paths at a reduced size (quadrants and shallow
     256^2, SharpClaw 128^2, the 3D paths 48^3, Sod 800): q equal bit for
     bit, the same accepted and rejected steps, the launch counts of each
     (the wrappers' and the device counters'), the readbacks per output
     frame and the attempts after the end; then each path at full size on the
     device loop and on the host loop, in turns, without the profiler
     (the walls, and the device loop's warm-up and capture seconds);
  4i. gauges (on the device loop) and before_step (on the host loop) on
     the card against the CPU: the Sod tube, classic, 200 cells, float64;
  4j. the acoustics path: examples.acoustics_2d.setup(mx=my=1024,
     float32) through Controller.run() to t=0.12, every launch count set
     to 0 just before it and read just after (step2_aos, its acoustics
     instance: 1 per attempted step), one capture, the x/y mirror symmetry
     of p;
  4k. the dry dam break: examples.dam_break_dry.setup(nx=500) to t=2.0 in
     float32 (launch counts around it; step1, its sw_aug instance: 1 per
     attempted step) and float64: h >= 0 in every frame, the mass
     conserved to roundoff until the rarefaction nears the left end;
  4l. the Sod tube with SharpClaw char_decomp=2 at 800 cells in float32 to
     t=0.2 (the whole stage is plain PyTorch: no kernel launch but one
     restore an attempted step), against the same run in float64;
  4o. the SharpClaw 3D path: examples.euler_3d.setup(mx=my=mz=192,
     solver_type="sharpclaw", float32) through Controller.run() to t=0.2
     (SharpClawSolver3D: sharpclaw/kernels.py:dq_nd, weno5.cu on every
     axis of every stage), every launch count set to 0 just before it and
     read just after (weno5: 30 per attempted step, restore 1, no other
     kernel); the wall and the card's peak memory; q finite with rho > 0
     and p > 0; then the same run in float64: the problem's symmetry
     under each exchange of two axes (the momentum components swapped with
     them) to 1e-5 of max|q|, and the float32 run within 1e-3 of it
     (relative L1; the scheme amplifies the float32 roundoff of the
     mirrored sums far above 1e-5: SHARP3D_SYM_TOL);
  4p. the SharpClaw routes of the other examples on the generic dq, float32,
     every launch count set to 0 just before each and read just after:
     acoustics_2d at 1024^2 to t=0.12 (the SoA route: dq2_weno5's
     acoustics instance, 10 per attempted step; p mirror-symmetric),
     shallow_2d_radial at 1024^2 to t=1.0 (the generic dq in 2D: weno5, 20
     per attempted step; h > 0) and acoustics_3d_heterogeneous at 128^3 to
     t=0.8 (the generic dq with aux and the second Riemann solve: weno5,
     30);
  4q. the slice's path: examples.shock_bubble (euler_5wave_2D, MC, the
     generic CTU step: step2_aos's Euler 5-wave instance, 1 launch an
     attempted step) at 2048x512 f32 to t=0.6 through Controller.run(),
     and its SharpClaw route at 1024x256 f32 to t=0.6 (dq2_weno5's Euler
     5-wave instance, 10 an attempted step), every launch count set to 0
     just before each and read just after: the steps, the wall, the peak
     memory, rho > 0, p > 0 and the tracer's sum within 1e-3 of its
     start; the quadrants off the SoA route (use_soa=False: step2_aos's
     Euler 4-wave instance) at 1024^2 f32 to t=0.8 beside [4]'s run (max
     and relative L1 difference) and both routes at 128^2 in float64;
  4r. sw_aug_2D: examples.radial_bump_bathymetry at 1024^2 f32 to t=0.3
     (h > 0, the y mirror symmetry), its lake at rest at 1024^2 in
     float32 and float64 (machine-still), examples.dam_break_dry with
     dimension=2 at 500^2 f32 to t=0.5 (the mass kept; the least h over
     the frames reported and held to the JAX package's own run's, which
     goes below 0 at this grid), each with every launch count set to 0
     just before it and read just after (step2_aos's sw_aug instance, 1
     an attempted step);
  4s. examples.kpp at 1024^2 f32 to t=1.0, classic (minmod,
     transverse_waves 2, CFL 0.45 / 0.5: step2_aos's kpp_2D instance, 1
     an attempted step; q within its initial range) and SharpClaw at 512^2
     (the generic dq: weno5 20 an attempted step);
  4t. examples.acoustics_2d_interface at 1024^2 f32 to t=0.6, classic MC
     (step2_aos's vc_acoustics_2D instance; p's y mirror symmetry),
     SharpClaw at 512^2 (weno5 20 an attempt) and SharpClaw with
     char_decomp=2 at 256^2 (plain PyTorch: restore only);
  4u. examples.advection_2d at 1024^2 f32 to t=2.0 (vc_advection_2D on
     the swirl's edge velocities, transverse_waves 0), advection_2D (u =
     1, v = 0.5, periodic) and vc_advection_fwave_2D (the swirl's cell
     velocities, a capacity row, f-waves) at 1024^2 f32 to t=0.25, each
     keeping its (capacity-weighted) mass;
  4v. burgers_2D on a Gaussian pulse at 1024^2 and burgers_3D at 192^3
     (CFL 0.45 / 0.5), periodic, MC, float32 and float64 to t=0.4
     (step2_aos's and
     step3_aos's Burgers instances): the mass kept, the float64 runs'
     diagonal (2D) and x <-> y (3D) symmetry gated; each of [4s]-[4v]'s
     runs with every launch count set to 0 just before it and read just
     after;
  4w. dimensional splitting and source terms: step2_aos's psystem_2D and
     shallow_sphere_fwave_2D instances (no transverse pass) against the
     plain step (the unsplit runs' first states and seeded ones, f32 and
     f64); examples.psystem_2d at 1024^2 to t=1.0 and
     examples.shallow_sphere at 1024x512 with its Strang source to t=1.0,
     each split (x and y sweeps of plain PyTorch; the sphere's source and
     custom BCs in the device loop's graphs) and unsplit (the instance, 1
     launch an attempted step, CFL 0.2 / 0.25), f32 and f64 (the
     p-system's x mirror symmetry on both routes, its gauges; the
     sphere's TC2 drift, its f32 drift at 128x64 against the CPU's);
     examples.shock_forward_step at 600x200 f32 to t=0.5, classic split
     and SharpClaw (dq2_weno5 10 an attempt), on the host loop of its
     before_step; examples.acoustics_3d_heterogeneous split at 128^3 f32
     to t=0.8; examples.advection_reaction at 2^20 cells (lambda 1000) to
     t=1e-3, Godunov and Strang (step1 1 an attempt) and dq_src (weno5 10
     an attempt), each against the exact solution; launches and device
     ms a step of the split and unsplit routes (torch.profiler, to
     t=0.02); the split and source routes at small grids on the card
     against the CPU in f64 (equal steps, 1e-12); each run with every
     launch count set to 0 just before it and read just after;
  4y. the other SharpClaw options: the quadrants with SharpClaw at WENO
     order 7 at 1024^2 f32 to t=0.8 on the device loop (the SoA route:
     csrc/dq2_weno.cu's dq2_weno7, 10 launches an attempted step, no
     dq2_weno5), its profile to t=0.1, and its float64 run at 256^2 to
     t=0.02 against its plain version on the card (a conditioned run:
     equal steps gated, the distance a reading); one
     dq of each of
     dq2_weno.cu's 36 instances (orders 7-17; Euler 4-wave, acoustics,
     Euler 5-wave; f32, f64) against sharpclaw/soa.py:dq_2d_soa at 1024^2
     (Euler 5-wave 2048x512) and on a ragged 250x171 state that takes the
     positivity fallback (TOL_REL, the CFL equal bit for bit), and each on
     a short path of its system (128^2; 10 launches an attempted step);
     the quadrants at 1024^2 f32 (WENO5) to t=0.1 with RK4 on the device
     loop and SSPLMMk2, SSPLMMk3 and LMM (Adams-Bashforth 3, fixed dt) on
     the host loop (no attempt after the end), each against its plain run
     on the card at 128^2 in float64 (conditioned, as the order-7 run); a
     smooth periodic Euler wave at 128^2 in float64 to t=0.01 at WENO
     orders 7 and 17 and with each integrator, on the kernels and on
     their plain versions on the card, gated at 1e-12 with equal steps;
     the Sod tube with lim_type=1 and
     char_decomp 0-4 and with lim_type=0, the quadrants with lim_type=1
     at 512^2 (plain PyTorch: no WENO kernel) and the tfluct advection
     case, each float64 run on the card against the CPU; every launch
     count set to 0 just before each run and read just after; its
     phase_seconds;
  4z. frames and restarts on the classic main path: the quadrants at
     1024^2 f32 to t=0.8 through Controller.run() with four frames in
     ascii (the native C++ writer), netcdf and, where h5py imports, hdf5,
     equal bit for bit to the same run without files (the same steps and
     step2_ctu launches); every frame read back (netcdf and hdf5 bit for
     bit, ascii within %18.8e); the native writer's fort.q of a 256^2
     frame byte-identical to the plain (Python) writer's, each writer's
     ms; each format's host ms a 1024^2 frame (the pull from the card and
     the write); the fixed-dt run (dt 0.2/800) restarted from its netcdf
     frame 2 (t=0.4) equal bit for bit to the uninterrupted one, and a
     variable-dt restart's steps; a Fortran-binary frame of a seeded state
     read back exactly and stepped once on the card, equal to the step
     from memory; hdf5 and plotting reported as not run where h5py or
     matplotlib is missing;
  4m. the parallel overlay (pyclaw_tpu_torch/parallel) in a world of one
     NCCL rank (init_distributed on a file:// store):
     parallel.ClawSolver3D on examples.euler_3d.setup(mx=my=mz=192,
     float32) to t=0.2, equal bit for bit to [4c]'s serial q with the
     same accepted and rejected steps, one step3_ctu launch an attempted
     step on the card (the overlay takes the host loop) and no other
     kernel;
  4n. four ranks of the overlay (NCCL with one card a rank when the
     machine has four, else gloo with the four ranks on the one card,
     decided before any rank starts; the ranks are spawned after [2]
     built the kernels): Euler 3D 192^3 on (2,2,1) to t=0.2, the classic
     quadrants 1024^2 on (2,2) to t=0.1, the SharpClaw quadrants 256^2 on
     (2,2) to t=0.05, Sod (classic) at 800 cells on (4,) to t=0.2 and
     SharpClaw Euler 3D 64^3 on (2,2,1) to t=0.1, and the classic
     quadrants 256^2 on (2,2) to t=0.1 with three gauges (one on the
     corner cell of rank 3's block; ascii frames and, where h5py imports,
     sharded ones) and with a before_step hook that damps one seeded cell
     of the global q, all float32, each
     equal bit for bit to the serial card run of the same setup with the
     same steps, each rank's device counters holding its
     kernel's launches per attempted step times the attempts; the gauge
     series bit for bit and rank 0's gauge and frame files byte for byte
     as the serial run's, the last sharded frame reassembled equal to the
     serial q (reported as not run without h5py); the walls
     beside the serial ones (the cost of the exchange, not a scaling
     figure);
  5v. the golden validator (pyclaw_tpu_torch/validate.py, the port of
     tools/tpu_validate.py): its ten cases on the card in float32 at the
     tool's tolerances and in float64 at 1e-8 (it took over the goldens of
     the earlier phases [5], [5c], [5d] and three of [5e], at the same
     tolerances); the two pairs that the JAX package's own run misses
     under one-ulp moves (the dry dam break in float32, the char_decomp
     Sod tube in float64: CONDITIONED) are reported not ok when they miss,
     and must stay within a fixed bound taken from those readings;
  5d. a lake at rest over a bump (bathymetry f-waves) at 1024^2 float32,
     which must stay at rest to roundoff;
  5e. the two 1D goldens the validator has no case for (acoustics_1d,
     euler_1d_sod) on the card, float32 and float64;
  5f. the heterogeneous path's correctness (no golden exists): the 32^3
     run to t=0.8 on the card in float64 against the same run on the
     CPU's plain step (equal steps, 1e-10); the 192^3 float32 run against
     a 192^3 float64 run on the card (relative L1); the x <-> y mirror
     symmetry of p; and the uniform-medium oracle (vc_acoustics_3D with
     rho = c = 1 against acoustics_3D, transverse_waves 1, 16^3 to t=0.2);
  5g. the Euler capacity path's correctness (no golden exists): the 32^3
     run to t=0.2 on the card in float64 against the same run on the CPU's
     plain step (equal steps, 1e-10); the kappa = 1 oracle (the capacity
     variant of step3_ctu with kappa = 1 against its variant without a
     capacity function, 32^3 float64, equal steps, 1e-12); the 192^3
     float32 run against a 192^3
     float64 run on the card (relative L1); the x <-> y mirror symmetry of
     rho; the change of the capacity-weighted mass; the boundary cells
     unchanged (the front has not reached them);
  5s. SharpClaw in 3D on the card against the same run on the CPU in
     float64: Euler 3D at 24^3 to t=0.1 and heterogeneous acoustics at
     24^3 to t=0.2, equal steps, q to 1e-12 of max|q|;
  5b. SharpClaw quadrants at 80^2 on the card against the same run on the
     CPU (the plain path the CPU tests tie to the JAX package): float64 at
     t=0.2 and t=0.8, float32 at t=0.8;
  5x. shock_bubble at 80x20 to t=0.1 (classic and SharpClaw) and the 2D
     dry dam break at 40^2 to t=0.5 (h >= 0) on the card against the same
     runs on the CPU in float64: equal steps, q to 1e-12 of max|q|; the
     dam break to t=2.0 reported beside them (ill-conditioned: a one-ulp
     move of its initial state moves the JAX run by up to 4.8e-2);
  5y. [4s]-[4v]'s runs at small grids (the examples at 40^2, advection_2d
     at 48^2, Burgers at 48^2 and 12^3) on the card against the same runs
     on the CPU in float64: equal steps, q to 1e-12 of max|q|;
  6. timing at 1024^2 (CUDA events): each 2D kernel, its plain version,
     its bound, and step3_ctu the same at 192^3 (on the 3D path's first
     input and, the kernel alone, on its last); step1 on the Sod state at
     n = 800 and 2^20 and on a seeded smooth state at 2^20, weno5 on the
     same states padded for SharpClaw ((3, 806), (3, 2^20+6)), step1's
     sw_aug instance on a seeded wet/dry state at 2^20, each also
     with its device time from torch.profiler and its share of the bound;
     step2_ctu, dq2_weno5 and
     step3_ctu also by the profiler; step3_aos, its plain version and
     its bound at 192^3 on the heterogeneous path's first input, and the
     kernel on its last; the same for step3_ctu's capacity variant on the
     Euler capacity path's first input and last state; step2_aos (its
     shallow-water and its acoustics instance, each on its path's first
     input) also by the profiler; then
     each 2D path to t=0.1, the 3D Euler path to t=0.02, the heterogeneous
     path to t=0.8, the Euler capacity path to t=0.02, the classic Sod path to t=0.2 and the SharpClaw one to
     t=0.01, the acoustics path to t=0.12, the dry dam break to t=0.5 and
     the char_decomp Sod path to t=0.01 under torch.profiler (device busy
     share, launches per step,
     device time by kernel and by group: kernel, BC extension of q and
     aux, CFL reduction, frame copies; host time by operation), each on
     the device loop and on the host loop; restore at (4, 1024, 1024) f32,
     accepted and rejected, against torch.where; dq2_weno5's acoustics
     instance at 1024^2 on the radial pulse and weno5 at (5, 198^3) on each
     axis of the Euler 3D state (events, profiler, plain, bound), and
     [4o]'s path to t=0.02 under torch.profiler on the device loop; the
     instances of this slice (step2_aos Euler 4-wave on the quadrants at
     1024^2, Euler 5-wave on the shock bubble at 2048x512, sw_aug_2D on
     the radial bump at 1024^2; dq2_weno5 Euler 5-wave on the shock
     bubble at 2048x512) by events and the profiler, beside their plain
     versions and bounds; the same for the instances of [3n] and [3o],
     each on its run's first input (1024^2, 192^3), and for [4w]'s two
     instances on their unsplit runs' first inputs (1024^2, 1024x512);
     each of dq2_weno.cu's 36 instances on its 1024^2 case (events, the
     profiler, the plain version, the bound and its share);
  7. the JSON lines: a kernels record, the card line, and the result.

It needs one card and exits non-zero, printing no result, without one.
"""

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from pyclaw_tpu_torch.ops import count_on_device
# the timers and the timed states, shared with the variant timer
from pyclaw_tpu_torch.ops.time_kernels import (
    CASES_1D, device_ms_per_call, dq_case, euler3d_capa_case,
    euler3d_capa_state, euler3d_state, events_ms as time_ms, het_state,
    padded, padded_1d, padded3, padded3_aux, quadrants_state, shallow_state,
    sod_state, step1_case, step2_aos_case, step2_ctu_case, step3_aos_case,
    step3_ctu_case, weno5_case, acoustics_state, step2_aos_acoustics_case,
    dam_state, DAM_PARAMS, shock_bubble_state, radial_bump_state,
    step2_aos_euler4_case, step2_aos_euler5_case, step2_aos_sw_aug_case,
    dq_euler5_case, SCALAR_CASES, example_state, fwave_capacity,
    gaussian_state, step2_aos_scalar_case, step3_aos_burgers_case,
    swirl_cell_velocities, NO_TRANS_CASES, step2_aos_no_trans_case,
    LIBRARY_1D, LIBRARY_OPTS, library_case, library_state, random_state,
    WENO_ORDERS, DQ_WENO_SYSTEMS, dq_weno_rp, dq_weno_params, dq_weno_case,
    ptxas_resources, dq_weno_instance, step2_aos_instance,
    dq2_weno5_instance, step3_aos_instance, BURGERS3D_OPTS)

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
#   splits 279 (what the two share once: H - (u^2 + v^2) 4, g1/a2 1,
#   1/(2a) 2; each split's strengths 18, waves 20, speeds 2, up/down
#   sums 96), CFL 8 -> 616; two interfaces 1232;
#   fold and update per cell 88 (each face's transverse fold once: x 24,
#   y 24; the update 40).
FLOPS_PER_CELL = 2 * 616 + 88

# Operations per cell of one SharpClaw dq (WENO5, Euler 4-wave), counted
# from csrc/dq2_weno5.cu in the same way, each interface counted once (the
# ring of edge states and the ghost-band CFL solves are overhead, not
# work).  Per direction: WENO5 of four components (smoothness indicators
# 33, candidate values 34, weights 42 in f32 / 31 in f64: 109 / 98 each)
# 436 / 392; two positivity tests 20; one Roe solve per interface (Roe
# averages and strengths 74 / 72, waves 22, fluctuations 64, CFL 12)
# 172 / 170; two fluxes and their difference 32 / 30; the direction's
# part of dq 12 -> 672 / 624; the sum of the two parts 4.
FLOPS_PER_CELL_DQ = {"float32": 2 * 672 + 4, "float64": 2 * 624 + 4}

# The same for the acoustics instance of csrc/dq2_weno5.cu.  Per
# direction: WENO5 of three components 327 / 294; one solve per interface
# (jumps 2, strengths 6, waves 3, the fluctuations of the two nonzero
# components 20, CFL 5) 36; two fluxes and their difference 7; the
# direction's part of dq 9 -> 379 / 346; the sum of the two parts 3.
# About 32 operations per byte in float32: operations bound it, as Euler.
FLOPS_PER_CELL_DQ_ACOUSTICS = {"float32": 2 * 379 + 3,
                               "float64": 2 * 346 + 3}

# Operations per cell of one 3D CTU step (order 2, transverse_waves 2,
# MC), counted from csrc/step3_ctu.cu and csrc/euler3d.cuh in the same
# way, each interface quantity counted once (the halo interfaces, the
# neighbour waves the limiter rebuilds and the kinetic energy each split
# recomputes are overhead, not work).  Per sweep direction, per interface:
# the Roe average 54, sqrt and wave strengths 35 (89); the waves 28; the
# limiter (one 5-wave dot product with the neighbour 45, norms 45, theta
# and MC phi 45) 135; amdq/apdq 140 and the correction flux 75; the
# fluctuations to split 10; CFL 15; cq into the flux 5; the cell's
# fluctuation term 15 -> 512.  The eigensystem of the splits: its Roe
# average in the fixed order shares the normal one's rsqrt, division and
# velocities, and along x (the same order) all of it: x 2 (1/(2a)),
# y and z 38 each (the order-dependent kinetic energies, pressures,
# enthalpy and a2 34, sqrt, g1/a2, 1/(2a)) -> 78 a cell.  Per (sweep,
# transverse) pair: 2 rpt3 + 4 rptt3 splits of 139 each (strengths 23,
# waves and speeds 26, the up/down sums 90), the rptt3 scaling 20 (of the
# split's input), the gathers into the E-flux 40 and into the F-flux 100
# -> 994; two pairs per direction.  The update 50 per cell.
FLOPS_PER_CELL_3D = 3 * (512 + 2 * 994) + 78 + 50

# Operations per cell of one generic CTU step of the shallow-water Roe
# solver (order 2, transverse_waves 2, MC, no capacity), counted from
# csrc/step2_aos.cu and csrc/shallow2d.cuh in the same way, each interface
# quantity counted once (the neighbour's dot product and the halo
# interfaces are overhead, not work; the two rpt2 splits of an interface
# share its Roe average, which the normal solve's count holds).  Per interface (one x and one y per cell): the Roe average 19,
# jumps 3, strengths 13, waves 4, the entropy fix 39, amdq/apdq 33 (the
# normal solve, 111); the limiter of three waves (norm 5, dot product 5,
# theta 3, MC 6, nu 2, select 1, coefficient 4) 78; the correction flux
# 15; the fluctuations to split 6; two rpt2 splits of 71 (strengths 13,
# waves 4, the up/down sums 54) and v +- c 2, 144; CFL 3 -> 357; two
# interfaces 714.  The fold and update per cell 78.
FLOPS_PER_CELL_AOS = 2 * 357 + 78

# The same for the acoustics instance of csrc/step2_aos.cu
# (csrc/acoustics2d.cuh; order 2, transverse_waves 2, MC, no capacity).
# Per interface: the normal solve (jumps 2, strengths 6, waves 3, amdq/apdq
# 6) 17; the limiter of two waves with two nonzero components (norm 3, dot
# product 3, theta 3, MC 6, nu 2, select 1, coefficient 4) 44; the
# correction flux 7; the fluctuations to split 6; two rpt2 splits of 13
# (strengths 7, the four parts 6) 26; CFL 2 -> 102; two interfaces 204.
# The fold and update per cell 78, as for shallow water.  About 12
# operations per byte in float32 and 6 in float64: bytes bound it.
FLOPS_PER_CELL_AOS_ACOUSTICS = 2 * 102 + 78


def capacity_ops_per_cell_3d(p, rptt, tw):
    """Operations per cell a capacity function adds to one 3D CTU step
    (csrc/step3_aos.cu, or step3_ctu.cu's capacity variant for Euler) of
    a system with p waves: per cell the three
    dt/(dD kappa) 6; per interface the averaged dt/(dD kappa) 2 and 2 p in
    the CFL; with transverse waves, per (sweep, transverse) pair and
    fluctuation the two gather coefficients 2 and, with transverse_waves 2
    and a system that has rptt3, each of its two splits' coefficient 1."""
    per_fluct = 2 + (2 if tw >= 2 and rptt else 0)
    transverse = 2 * 2 * per_fluct if tw > 0 else 0
    return 3 * (2 + 2 * p + transverse) + 6


def flops_per_cell_3d_aos(name, tw, capa=False):
    """Operations per cell of one generic 3D CTU step of system ``name``
    (order 2, MC) with ``tw`` transverse_waves, with or without a capacity
    function (:func:`capacity_ops_per_cell_3d`), counted from
    csrc/step3_aos.cu and csrc/acoustics3d.cuh in the same way, each
    interface quantity counted once (the halo interfaces, the second dot
    product of each interface pair and the neighbours' splits are
    overhead, not work).  Per sweep direction, per interface: the normal
    solve (vc acoustics 23, acoustics 19, advection 5, Burgers 9 on its
    common branch: the jump, the average speed 2, the split 4, the
    transonic test 2); per wave the
    limiter (norm and one dot product 2 (2 m - 1), theta 3, MC 6, nu 2,
    the coefficient 6, the select 1); the correction flux m (2 p - 1); cq
    into the flux m; CFL 3 p; the cell's fluctuation term 3 m; with
    transverse_waves 2 the fluctuations to split 2 m.  Per (sweep,
    transverse) pair and fluctuation: the split (vc acoustics 15,
    acoustics 12, advection and Burgers 4) and the E-flux gather 5 m; with
    transverse_waves 2 and a system that has rptt3, two double-transverse
    splits, each with its scaling 2 m and its F-flux gather 5 m.  The
    update 10 m per cell.  m equations, p waves."""
    capa_ops = 0
    m, p, rpn, split, rptt = {
        "vc_acoustics_3D": (4, 2, 23, 15, False),
        "acoustics_3D": (4, 2, 19, 12, True),
        "advection_3D": (1, 1, 5, 4, True),
        "burgers_3D": (1, 1, 9, 4, True)}[name]
    if capa:
        capa_ops = capacity_ops_per_cell_3d(p, rptt, tw)
    limiter = 2 * (2 * m - 1) + 3 + 6 + 2 + 6 + 1
    normal = (rpn + p * limiter + m * (2 * p - 1) + m + 3 * p + 3 * m
              + (2 * m if tw >= 2 else 0))
    per_fluct = split + 5 * m
    if tw >= 2 and rptt:
        per_fluct += 2 * (split + 2 * m + 5 * m)
    transverse = 2 * 2 * per_fluct if tw > 0 else 0
    return 3 * (normal + transverse) + 10 * m + capa_ops

# Operations per cell of one 3D Euler CTU step with a capacity function
# (step3_ctu.cu's capacity variant; order 2, MC, transverse_waves 2): the
# step's work and what the capacity function adds to it (7628 + 90)
FLOPS_PER_CELL_3D_CAPA = FLOPS_PER_CELL_3D + capacity_ops_per_cell_3d(
    5, True, 2)

TOL_REL = {"float32": 1e-5, "float64": 1e-12}        # one step, vs plain
# A state with positivity fallbacks is ill-conditioned: edge densities
# near zero come from cancellation, and the sound speed grows as
# 1/sqrt(rho), so a one-ulp difference (the kernel's FMA contraction
# against one rounding per PyTorch operation) can grow by orders of
# magnitude at a few cells.  There the float32 kernel is held to
# ULP_FACTOR times the plain version's own change when its input
# moves by one ulp (measured on the same state), or TOL_REL if larger;
# float64 stays at TOL_REL.
ULP_FACTOR = 4.0
GOLDEN_TOL = {"float32": 1e-3, "float64": 1e-8}      # tools/tpu_validate
# a lake at rest in float32 stays at rest to this (absolute, in units of
# the depth 1 and of the momentum): roundoff of the well-balanced f-waves
LAKE_TOL = 1e-5
# SharpClaw run on the card against the same run on the CPU (80^2): a
# whole run amplifies one-ulp differences through the shocks, so only the
# short horizon is held tightly (max relative); t=0.8 in relative L1 and
# a loose max relative.  At 80^2 the run's own sensitivity at t=0.2 is
# already near 1e-5 (the CFL of the rejected first steps, taken in a
# blown-up stage, sets the next dt): there the gate is ULP_FACTOR times
# the CPU run's own change when its initial state moves by one ulp, or
# the tolerance below if larger.
SHARP_RUN_TOL = {"t0.2_max": 1e-6, "t0.8_l1": 1e-4, "t0.8_max": 1e-2}
# The heterogeneous-acoustics path (no golden): the 32^3 float64 run on the
# card against the same run on the CPU's plain step (max relative); the
# 192^3 float32 run against the 192^3 float64 run on the card (relative
# L1: float32 roundoff through ~170 linear steps); the x <-> y mirror
# symmetry of p in float64 and the uniform-medium oracle (absolute, as
# tests/test_3d.py:167, 197)
HET_TOL = {"card_vs_cpu_f64": 1e-10, "f32_vs_f64_l1": 1e-4,
           "mirror_f64": 1e-11, "uniform_f64": 1e-11}


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


def compare_dq(dev, grids, seed=1):
    """dq2_weno5 vs its plain version, one dq each, on the card."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.riemann import euler
    from pyclaw_tpu_torch.sharpclaw import soa as sc_soa
    rng = np.random.default_rng(seed)
    params = {"gamma": 1.4}
    worst = {"float32": 0.0, "float64": 0.0}
    main_abs_err = None
    ncase = 0
    for nx, ny in grids:
        inputs = {"quadrants": quadrants_state(nx, ny),
                  "random": random_state(rng, nx, ny),
                  "fallback": random_state(rng, nx, ny, pockets=0.05)}
        dx, dy = 1.0 / nx, 1.0 / ny
        for iname, q_np in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                qbc = padded(q_np, dtype, dev, num_ghost=3)
                dt = float(np.dtype(tname).type(0.6 / max(nx, ny)))
                dk, ck = tiled2d.dq_rows(qbc, dt, dx, dy, params)

                def plain(qin):
                    return sc_soa.dq_2d_soa(
                        qin, dt, dx, dy, euler._rpn2_euler_soa, params, 5,
                        3, positivity=euler.euler_4wave_2D.positivity,
                        flux_soa=euler._flux_euler_2d_soa)
                dp, cp = plain(qbc)
                torch.cuda.synchronize()
                abs_err = float((dk - dp).abs().max())
                rel = abs_err / float(dp.abs().max())
                dcfl = abs(float(ck) - float(cp))
                tol, nfall, sens = TOL_REL[tname], 0, None
                if iname == "fallback":
                    nfall = sc_soa.fallback_count(
                        qbc, params, euler.euler_4wave_2D.positivity)
                    # the plain version's own change under a one-ulp move
                    # of its input
                    r = torch.as_tensor(rng.uniform(-1.0, 1.0, qbc.shape),
                                        dtype=dtype, device=dev)
                    dpp, _ = plain(qbc * (1.0 + torch.finfo(dtype).eps * r))
                    sens = float((dpp - dp).abs().max() / dp.abs().max())
                    if tname == "float32":
                        tol = max(tol, ULP_FACTOR * sens)
                ok = (np.isfinite(rel) and rel <= tol
                      and dcfl <= TOL_REL[tname] * float(cp)
                      and dk.shape == (4, nx, ny))
                if iname == "fallback" and nfall == 0:
                    fail(f"dq {nx}x{ny} fallback state: no cell fell back")
                if not ok:
                    fail(f"dq2_weno5 vs plain {nx}x{ny} {iname} {tname}: "
                         f"rel err {rel:.3e} (tol {tol:.3e}), cfl "
                         f"{float(ck)!r} vs {float(cp)!r}")
                worst[tname] = max(worst[tname], rel)
                if (nx, ny, iname, tname) == (1024, 1024, "quadrants",
                                              "float32"):
                    main_abs_err = abs_err
                ncase += 1
                print(f"  dq {nx}x{ny} {iname:9s} {tname}: rel err "
                      f"{rel:.3e} (tol {tol:.1e}), |dcfl| {dcfl:.3e}"
                      + (f"; {nfall} cells fell back, one-ulp input "
                         f"change moves the plain version by {sens:.3e}"
                         if nfall else ""), flush=True)
    return worst, main_abs_err, ncase


def random_state3(rng, nx, ny, nz, gamma=1.4):
    """A seeded admissible 3D Euler state with velocities in all three
    directions."""
    n = (nx, ny, nz)
    rho = 0.5 + rng.random(n)
    u, v, w = (0.5 * rng.standard_normal(n) for _ in range(3))
    p = 0.5 + rng.random(n)
    return np.stack([rho, rho * u, rho * v, rho * w,
                     p / (gamma - 1.0) + 0.5 * rho * (u * u + v * v + w * w)])


def plain_step3(qbc, dt, deltas, lims, order, tw):
    from pyclaw_tpu_torch.classic import kernels
    from pyclaw_tpu_torch.riemann import euler
    rp = euler.euler_3D
    return kernels.step3(qbc, None, dt, *deltas, rp.rp, rp.rpt, rp.rptt,
                         {"gamma": 1.4}, lims, order, False, -1, 2, tw,
                         rp.prefactor)


def compare_step3(dev, n_main=192, seed=2):
    """step3_ctu vs its plain version, one step each, on the card: the
    main configuration at n_main^3, the option matrix at small grids."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    worst_cfl = {"float32": 0.0, "float64": 0.0}
    main_abs_err = None
    ncase = 0
    matrix = [(tw, order, lim) for tw in (0, 1, 2) for order in (1, 2)
              for lim in (4, 3, 10)]
    for shape, cases in (((n_main,) * 3, [(2, 2, 4)]),
                         ((16, 16, 16), matrix), ((33, 17, 9), matrix),
                         ((5, 40, 7), matrix)):
        inputs = {"euler_3d": euler3d_state(*shape),
                  "random": random_state3(rng, *shape)}
        deltas = tuple(2.0 / n for n in shape)
        for iname, q_np in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                qbc = padded3(q_np, dtype, dev)
                dt = float(np.dtype(tname).type(0.3 * min(deltas)))
                for tw, order, lim in cases:
                    ml = (lim,) * 5
                    qk, ck = tiled2d.step3_xy(qbc, dt, *deltas, {"gamma": 1.4},
                                              ml, order, 2, tw)
                    qp, cp = plain_step3(qbc, dt, deltas, ml, order, tw)
                    torch.cuda.synchronize()
                    abs_err = float((qk - qp).abs().max())
                    rel = abs_err / float(qp.abs().max())
                    dcfl = abs(float(ck) - float(cp))
                    if not (np.isfinite(rel) and rel <= TOL_REL[tname]
                            and dcfl <= TOL_REL[tname] * float(cp)
                            and tuple(qk.shape) == (5,) + shape):
                        fail(f"step3_ctu vs plain {shape} {iname} {tname} "
                             f"order={order} tw={tw} lim={lim}: rel err "
                             f"{rel:.3e}, cfl {float(ck)!r} vs {float(cp)!r}")
                    worst[tname] = max(worst[tname], rel)
                    worst_cfl[tname] = max(worst_cfl[tname],
                                           dcfl / float(cp))
                    if (shape[0], iname, tname) == (n_main, "euler_3d",
                                                    "float32"):
                        main_abs_err = abs_err
                    if shape[0] == n_main:
                        print(f"  step3 {shape} {iname:8s} {tname}: rel err "
                              f"{rel:.3e}, cfl rel {dcfl / float(cp):.3e}",
                              flush=True)
                    ncase += 1
                    del qk, qp
                del qbc
                torch.cuda.empty_cache()
        print(f"  compare step3 {shape}: max rel err f32 "
              f"{worst['float32']:.3e} f64 {worst['float64']:.3e}; max cfl "
              f"rel f32 {worst_cfl['float32']:.3e} f64 "
              f"{worst_cfl['float64']:.3e}", flush=True)
    return worst, worst_cfl, main_abs_err, ncase


def run_euler3d(dev, n, dtype, tfinal=0.2, **kw):
    """examples.euler_3d through Controller.run() (``kw``: more of its
    setup keywords, ``solver_type``); returns (claw, status, wall
    seconds)."""
    import torch
    from pyclaw_tpu_torch.examples import euler_3d as ex
    claw = ex.setup(mx=n, my=n, mz=n, dtype=dtype, outdir=None, device=dev,
                    **kw)
    claw.tfinal = tfinal
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def run_quadrants(dev, n, dtype, tfinal=0.8, solver_type="classic",
                  keep_copy=False, perturb_seed=None):
    """examples.euler_2d_quadrants through Controller.run(); returns
    (claw, status, wall seconds).  With ``perturb_seed``, the initial
    state is first moved by one ulp (relative, seeded uniform in
    [-1, 1])."""
    import torch
    from pyclaw_tpu_torch.examples import euler_2d_quadrants as ex
    claw = ex.setup(mx=n, my=n, dtype=dtype, outdir=None, device=dev,
                    solver_type=solver_type)
    claw.tfinal = tfinal
    claw.keep_copy = keep_copy
    if perturb_seed is not None:
        state = claw.solution.state
        r = np.random.default_rng(perturb_seed).uniform(-1.0, 1.0,
                                                        state.q.shape)
        eps = np.finfo(state.q.dtype).eps
        state.q = (state.q * (1.0 + eps * r)).astype(state.q.dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def bound_of(nbytes, flops, tname):
    """The least time of the card for ``nbytes`` moved and ``flops``
    done in ``tname``: the larger of the two times, and which it is."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[tname] * 1e3
    return {"bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms > ops_ms else "operations"}


def timing(dev, n=1024):
    """Kernel (CUDA events and the profiler's device time), plain version
    and bound at n^2 on the quadrants state (the classic path's first
    input, ops/time_kernels.py:step2_ctu_case)."""
    import torch
    from pyclaw_tpu_torch.classic import soa
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.riemann import euler
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc, args = step2_ctu_case(n, dtype, dev)
        dt, h, _, params, lims, order, _, tw = args

        def kern():
            return tiled2d.step2_rows(qbc, *args)

        def plain():
            return soa.step2_soa(qbc, dt, h, h, euler._rpn2_euler_soa,
                                 euler._rpt2_euler_soa, params, lims, order,
                                 2, transverse_waves=tw,
                                 prefactor_soa=euler._prefactor_euler_2d_soa)
        ms = time_ms(kern, 200)
        plain_ms = time_ms(plain, 20, warm=2)
        ms_again = time_ms(kern, 200)
        dev_ms, dev_n = device_ms_per_call(kern, "step2_ctu_kernel", 20)
        item = qbc.element_size()
        b = bound_of(qbc.numel() * item + 4 * n * n * item,
                     FLOPS_PER_CELL * n * n, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, **b}
        print(f"  timing {n}^2 {tname}: kernel {ms:.4f} ms (repeat "
              f"{ms_again:.4f}; on the device {dev_ms} ms, {dev_n} launches "
              f"profiled), plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), share "
              f"of bound {b['bound_ms'] / ms:.4f}, library_ms null",
              flush=True)
    return out


def timing_dq(dev, n=1024):
    """dq2_weno5, its plain version and its bound at n^2 on the quadrants
    state."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.riemann import euler
    from pyclaw_tpu_torch.sharpclaw import soa as sc_soa
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc, args = dq_case(n, dtype, dev)
        dt, h, _, params = args

        def kern():
            return tiled2d.dq_rows(qbc, *args)

        def plain():
            return sc_soa.dq_2d_soa(
                qbc, dt, h, h, euler._rpn2_euler_soa, params, 5, 3,
                positivity=euler.euler_4wave_2D.positivity,
                flux_soa=euler._flux_euler_2d_soa)

        ms = time_ms(kern, 100)
        plain_ms = time_ms(plain, 10, warm=2)
        ms_again = time_ms(kern, 100)
        dev_ms, dev_n = device_ms_per_call(kern, "dq2_weno5_kernel", 20)
        item = qbc.element_size()
        b = bound_of(qbc.numel() * item + 4 * n * n * item,
                     FLOPS_PER_CELL_DQ[tname] * n * n, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, **b}
        print(f"  timing dq {n}^2 {tname}: kernel {ms:.4f} ms (repeat "
              f"{ms_again:.4f}; on the device {dev_ms} ms, {dev_n} launches "
              f"profiled), plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), share "
              f"of bound {b['bound_ms'] / ms:.4f}, library_ms null",
              flush=True)
    return out


def timing_step3(dev, n=192, q_last=None):
    """step3_ctu (CUDA events and the profiler's device time), its plain
    version and its bound at n^3 on the euler_3d initial state (the main
    path's first input, ops/time_kernels.py:step3_ctu_case); with
    ``q_last`` (the path's final q, from [4c]) the kernel's time on that
    state too."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc, args = step3_ctu_case(n, dtype, dev)
        dt, deltas, lims, order, tw = args[0], args[1:4], args[5], \
            args[6], args[8]

        def kern():
            return tiled2d.step3_xy(qbc, *args)

        def plain():
            return plain_step3(qbc, dt, deltas, lims, order, tw)

        ms = time_ms(kern, 20, warm=2)
        plain_ms = time_ms(plain, 3, warm=1)
        ms_again = time_ms(kern, 20, warm=2)
        dev_ms, dev_n = device_ms_per_call(kern, "step3_ctu_kernel", 10)
        item = qbc.element_size()
        b = bound_of(qbc.numel() * item + 5 * n ** 3 * item,
                     FLOPS_PER_CELL_3D * n ** 3, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, **b}
        if q_last is not None:
            qbc = step3_ctu_case(n, dtype, dev, q_last)[0]
            out[tname]["ms_last_state"] = time_ms(kern, 20, warm=2)
            out[tname]["device_ms_last_state"] = device_ms_per_call(
                kern, "step3_ctu_kernel", 10)[0]
            print(f"  timing step3 {n}^3 {tname} on the path's last state: "
                  f"kernel {out[tname]['ms_last_state']:.4f} ms (on the "
                  f"device {out[tname]['device_ms_last_state']} ms)",
                  flush=True)
        print(f"  timing step3 {n}^3 {tname}: kernel {ms:.4f} ms (repeat "
              f"{ms_again:.4f}; on the device {dev_ms} ms, {dev_n} launches "
              f"profiled), plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), share "
              f"of bound {b['bound_ms'] / ms:.4f}, library_ms null",
              flush=True)
        del qbc
        torch.cuda.empty_cache()
    return out


SW_PARAMS = {"grav": 1.0}
ROE, BATHY = "shallow_roe_with_efix_2D", "shallow_bathymetry_fwave_2D"
ACOUSTICS_2D = "acoustics_2D"
# each system's problem_data in [3d] (acoustics: examples.acoustics_2d's)
AOS_PARAMS = {ROE: SW_PARAMS, BATHY: SW_PARAMS,
              ACOUSTICS_2D: {"rho": 1.0, "bulk": 4.0, "zz": 2.0, "cc": 2.0}}
# (system, fwave, index_capa, transverse_waves, order, limiter) of [3d];
# the acoustics instance (two waves) at orders 1 and 2, every
# transverse_waves, MC and minmod
AOS_CASES = ([(ROE, False, -1, tw, order, 4) for tw in (0, 1, 2)
              for order in (1, 2)]
             + [(BATHY, True, -1, 2, 2, 4), (BATHY, True, 1, 2, 2, 10)]
             + [(ACOUSTICS_2D, False, -1, tw, order, lim) for tw in (0, 1, 2)
                for order in (1, 2) for lim in (4, 1)])


def random_wet_state(rng, nx, ny):
    """A seeded wet shallow-water state with velocities of either sign
    (transonic interfaces included), and aux: bathymetry, and a
    non-uniform capacity function."""
    h = 0.5 + rng.random((nx, ny))
    u = rng.standard_normal((nx, ny))
    v = rng.standard_normal((nx, ny))
    aux = np.stack([0.3 * rng.random((nx, ny)),
                    0.7 + 0.6 * rng.random((nx, ny))])
    return np.stack([h, h * u, h * v]), aux


def plain_aos(qbc, auxbc, dt, dx, dy, name, fwave, capa, tw, order, lim):
    from pyclaw_tpu_torch import riemann
    rp = riemann.ALL[name]
    return plain_step2(qbc, auxbc, dt, dx, dy, rp, AOS_PARAMS[name],
                       (lim,) * rp.num_waves, order, fwave, capa, tw)


def compare_aos(dev, grids, seed=3):
    """step2_aos vs its plain version, one step each, on the card: the
    shallow-water instances on the radial dam break state and a seeded
    random wet state, the acoustics instance on the radial pulse of
    examples.acoustics_2d and a seeded random state.  Returns (worst
    relative error, worst CFL error, the main configuration's max abs
    error (shallow, acoustics), cases)."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import tiled2d
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    worst_cfl = {"float32": 0.0, "float64": 0.0}
    main_abs_err = {}
    ncase = 0
    for nx, ny in grids:
        q_rand, aux_np = random_wet_state(rng, nx, ny)
        inputs = {"dam_break": shallow_state(nx, ny), "random": q_rand,
                  "pulse": acoustics_state(nx, ny)}
        dx, dy = 5.0 / nx, 5.0 / ny
        for iname, q_np in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                qbc = padded(q_np, dtype, dev)
                auxbc = padded(aux_np, dtype, dev)
                dt = float(np.dtype(tname).type(0.1 * min(dx, dy)))
                for name, fwave, capa, tw, order, lim in AOS_CASES:
                    if (iname == "pulse") != (name == ACOUSTICS_2D) and \
                            iname != "random":
                        continue
                    rp = riemann.ALL[name]
                    lims = (lim,) * rp.num_waves
                    args = (qbc, auxbc, dt, dx, dy, rp, AOS_PARAMS[name],
                            lims, order, fwave, capa, 2, tw)
                    qk, ck = tiled2d.step2_rows_generic(*args)
                    qp, cp = plain_aos(qbc, auxbc, dt, dx, dy, name, fwave,
                                       capa, tw, order, lim)
                    torch.cuda.synchronize()
                    abs_err = float((qk - qp).abs().max())
                    rel = abs_err / float(qp.abs().max())
                    dcfl = abs(float(ck) - float(cp)) / float(cp)
                    if not (np.isfinite(rel) and rel <= TOL_REL[tname]
                            and dcfl <= TOL_REL[tname]
                            and tuple(qk.shape) == (3, nx, ny)):
                        fail(f"step2_aos vs plain {nx}x{ny} {iname} {tname} "
                             f"{name} fwave={fwave} capa={capa} tw={tw} "
                             f"order={order} lim={lim}: rel err {rel:.3e}, "
                             f"cfl {float(ck)!r} vs {float(cp)!r}")
                    worst[tname] = max(worst[tname], rel)
                    worst_cfl[tname] = max(worst_cfl[tname], dcfl)
                    if ((nx, ny, iname, tname, tw, order, lim)
                            == (1024, 1024, "dam_break", "float32", 2, 2, 4)
                            and name == ROE):
                        main_abs_err["shallow"] = abs_err
                    if ((nx, ny, iname, tname, tw, order, lim)
                            == (1024, 1024, "pulse", "float32", 2, 2, 4)):
                        main_abs_err["acoustics"] = abs_err
                    ncase += 1
                    del qk, qp
        print(f"  compare step2_aos {nx}x{ny}: max rel err f32 "
              f"{worst['float32']:.3e} f64 {worst['float64']:.3e}; max cfl "
              f"rel f32 {worst_cfl['float32']:.3e} f64 "
              f"{worst_cfl['float64']:.3e}", flush=True)
    return worst, worst_cfl, main_abs_err, ncase


def run_shallow(dev, n, dtype, tfinal=1.0, **kw):
    """examples.shallow_2d_radial through Controller.run() (``kw``: more
    of its setup keywords); returns (claw, status, wall seconds)."""
    import torch
    from pyclaw_tpu_torch.examples import shallow_2d_radial as ex
    claw = ex.setup(mx=n, my=n, dtype=dtype, outdir=None, device=dev, **kw)
    claw.tfinal = tfinal
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def lake_at_rest(dev, n, dtype, tfinal):
    """A lake at rest (h + b = 1, u = v = 0) over a Gaussian bump on
    shallow_bathymetry_fwave_2D, through Controller.run(); returns
    (max |eta - eta0|, max |hu|, |hv|, the device loop's counters)."""
    import pyclaw_tpu_torch as pyclaw
    from pyclaw_tpu_torch import riemann
    solver = pyclaw.ClawSolver2D(riemann.shallow_bathymetry_fwave_2D,
                                 device=dev)
    solver.fwave = True
    solver.limiters = [pyclaw.limiters.tvd.MC]
    solver.all_bcs = pyclaw.BC.extrap
    domain = pyclaw.Domain([-1.0, -1.0], [1.0, 1.0], [n, n])
    state = pyclaw.State(domain, 3, num_aux=1, dtype=dtype)
    state.problem_data["grav"] = 9.8
    x, y = domain.grid.c_centers
    state.aux[0] = 0.5 * np.exp(-10.0 * (x ** 2 + y ** 2))
    state.q[0] = 1.0 - state.aux[0]
    eta0 = state.q[0] + state.aux[0]
    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal, claw.num_output_times = tfinal, 1
    claw.output_format = None
    status = claw.run()
    q = claw.solution.q
    return (float(np.abs(q[0] + claw.solution.aux[0] - eta0).max()),
            float(np.abs(q[1:]).max()), dict(claw.solver.loop_stats))


def timing_aos(dev, n=1024, system=ROE):
    """step2_aos (CUDA events and the profiler's device time), its plain
    version and its bound on the first input of the system's path
    (ops/time_kernels.py): the radial dam break at n^2 (shallow water,
    step2_aos_case), the radial pulse at n^2 (acoustics,
    step2_aos_acoustics_case), the quadrants at n^2 (Euler 4-wave,
    step2_aos_euler4_case), the shock bubble at 2n x n/2 (Euler 5-wave,
    step2_aos_euler5_case) or the radial bump at n^2 with its bottom in
    aux (sw_aug_2D, step2_aos_sw_aug_case)."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    case, flops = {
        ROE: (step2_aos_case, FLOPS_PER_CELL_AOS),
        ACOUSTICS_2D: (step2_aos_acoustics_case,
                       FLOPS_PER_CELL_AOS_ACOUSTICS),
        EULER4: (step2_aos_euler4_case, FLOPS_PER_CELL_AOS_EULER4),
        EULER5: (step2_aos_euler5_case, FLOPS_PER_CELL_AOS_EULER5),
        SW_AUG: (step2_aos_sw_aug_case, FLOPS_PER_CELL_AOS_SW_AUG)}[system]
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc, args = case(n, dtype, dev)
        auxbc, dt, dx, dy, rp, params, lims, order, fwave, capa, _, tw = args

        def kern():
            return tiled2d.step2_rows_generic(qbc, *args)

        def plain():
            return plain_step2(qbc, auxbc, dt, dx, dy, rp, params, lims,
                               order, fwave, capa, tw)

        ms = time_ms(kern, 200)
        plain_ms = time_ms(plain, 20, warm=2)
        ms_again = time_ms(kern, 200)
        dev_ms, dev_n = device_ms_per_call(kern, "step2_aos_kernel", 20)
        item = qbc.element_size()
        cells = (qbc.shape[1] - 4) * (qbc.shape[2] - 4)
        aux_bytes = 0 if auxbc is None else auxbc.numel() * item
        b = bound_of(qbc.numel() * item + aux_bytes
                     + rp.num_eqn * cells * item, flops * cells, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, "shape": list(qbc.shape), **b}
        print(f"  timing step2_aos {system} {tuple(qbc.shape)} {tname}: "
              f"kernel {ms:.4f} ms (repeat "
              f"{ms_again:.4f}; on the device {dev_ms} ms, {dev_n} launches "
              f"profiled), plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), share "
              f"of bound {b['bound_ms'] / ms:.4f}, library_ms null",
              flush=True)
    return out


# ---- the 3D heterogeneous-acoustics path: step3_aos ---------------------

PARAMS_3D = {"u": 0.7, "v": -0.4, "w": 0.3, "zz": 1.3, "cc": 0.8}
# (order, limiter) of [3g]: first order, MC, van Leer and the CFL-dependent
# id 10
STEP3_AOS_LIMS = ((1, 4), (2, 4), (2, 3), (2, 10))
SYSTEMS_3D = ("vc_acoustics_3D", "acoustics_3D", "advection_3D")


def step3_aos_matrix():
    """(system, transverse_waves, order, limiter, index_capa, fwave) of
    [3g] at the small grids."""
    out = []
    for name in SYSTEMS_3D:
        tws = (0, 1) if name == "vc_acoustics_3D" else (0, 1, 2)
        fwaves = (False, True) if name == "advection_3D" else (False,)
        for tw in tws:
            for order, lim in STEP3_AOS_LIMS:
                for capa in (-1, 2):
                    for fwave in fwaves:
                        out.append((name, tw, order, lim, capa, fwave))
    return out


def plain_step3_aos(qbc, auxbc, dt, deltas, name, lims, order, fwave, capa,
                    tw, params=None):
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.classic import kernels
    rp = riemann.ALL[name]
    return kernels.step3(qbc, auxbc, dt, *deltas, rp.rp, rp.rpt, rp.rptt,
                         PARAMS_3D if params is None else params, lims,
                         order, fwave, capa, 2, tw)


def compare_step3_aos(dev, n_main=192, seed=6):
    """step3_aos vs its plain version, one step each, on the card: the main
    configuration at n_main^3, the matrix of each system at small grids.
    Every input carries a third aux row, a capacity function in 0.7 .. 1.3
    (index_capa = 2)."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import tiled2d
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    worst_cfl = {"float32": 0.0, "float64": 0.0}
    main_abs_err = None
    ncase = 0
    matrix = step3_aos_matrix()
    main = [("vc_acoustics_3D", 1, 2, 4, -1, False)]
    # beside the path's grid and the first port's: a grid smaller than one
    # tile in either type, and one ragged on every axis with more tiles
    # than the card holds at once (the main configuration)
    for shape, cases in (((n_main,) * 3, main), ((16, 16, 16), matrix),
                         ((33, 17, 9), matrix), ((5, 40, 7), matrix),
                         ((3, 5, 2), matrix), ((45, 70, 50), main)):
        kappa = 0.7 + 0.6 * rng.random((1,) + shape)
        q_het, aux_het = het_state(*shape)
        inputs = {"layered": (q_het, np.concatenate([aux_het, kappa])),
                  "random": (rng.standard_normal((4,) + shape),
                             np.concatenate([
                                 1.0 + 0.2 * (2.0 * rng.random((2,) + shape)
                                              - 1.0), kappa]))}
        deltas = tuple(2.0 / n for n in shape)
        for iname, (q_np, aux_np) in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                qbc4 = padded3(q_np, dtype, dev).contiguous()
                auxbc = padded3_aux(aux_np, dtype, dev).contiguous()
                dt = float(np.dtype(tname).type(0.3 * min(deltas)))
                for name, tw, order, lim, capa, fwave in cases:
                    rp = riemann.ALL[name]
                    qbc = qbc4 if rp.num_eqn == 4 else qbc4[:1].contiguous()
                    lims = (lim,) * rp.num_waves
                    qk, ck = tiled2d.step3_xy_generic(
                        qbc, auxbc, dt, *deltas, rp, PARAMS_3D, lims, order,
                        fwave, capa, 2, tw)
                    qp, cp = plain_step3_aos(qbc, auxbc, dt, deltas, name,
                                             lims, order, fwave, capa, tw)
                    torch.cuda.synchronize()
                    abs_err = float((qk - qp).abs().max())
                    rel = abs_err / float(qp.abs().max())
                    dcfl = abs(float(ck) - float(cp)) / float(cp)
                    if not (np.isfinite(rel) and rel <= TOL_REL[tname]
                            and dcfl <= TOL_REL[tname]
                            and tuple(qk.shape) == (rp.num_eqn,) + shape):
                        fail(f"step3_aos vs plain {shape} {iname} {tname} "
                             f"{name} tw={tw} order={order} lim={lim} "
                             f"capa={capa} fwave={fwave}: rel err {rel:.3e}, "
                             f"cfl {float(ck)!r} vs {float(cp)!r}")
                    worst[tname] = max(worst[tname], rel)
                    worst_cfl[tname] = max(worst_cfl[tname], dcfl)
                    if (shape[0], iname, tname) == (n_main, "layered",
                                                    "float32"):
                        main_abs_err = abs_err
                    if shape[0] == n_main:
                        print(f"  step3_aos {shape} {iname:7s} {tname}: rel "
                              f"err {rel:.3e}, cfl rel {dcfl:.3e}", flush=True)
                    ncase += 1
                    del qk, qp
                del qbc4, auxbc
                torch.cuda.empty_cache()
        print(f"  compare step3_aos {shape}: max rel err f32 "
              f"{worst['float32']:.3e} f64 {worst['float64']:.3e}; max cfl "
              f"rel f32 {worst_cfl['float32']:.3e} f64 "
              f"{worst_cfl['float64']:.3e}", flush=True)
    return worst, worst_cfl, main_abs_err, ncase


def run_het(dev, n, dtype, tfinal=0.8, **kw):
    """examples.acoustics_3d_heterogeneous through Controller.run(); returns
    (claw, status, wall seconds)."""
    import torch
    from pyclaw_tpu_torch.examples import acoustics_3d_heterogeneous as ex
    claw = ex.setup(mx=n, my=n, mz=n, dtype=dtype, outdir=None, device=dev,
                    **kw)
    claw.tfinal = tfinal
    claw.num_output_times = 1
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return claw, dict(status), time.perf_counter() - t0


def homogeneous_run(dev, n, tfinal):
    """acoustics_3D with zz = cc = 1 and the heterogeneous example's
    settings and pulse (tests/test_3d.py:180-196), float64."""
    import pyclaw_tpu_torch as pyclaw
    from pyclaw_tpu_torch import riemann
    solver = pyclaw.ClawSolver3D(riemann.acoustics_3D, device=dev)
    solver.transverse_waves = 1
    solver.cfl_desired, solver.cfl_max = 0.45, 0.5
    solver.limiters = [pyclaw.limiters.tvd.MC]
    solver.all_bcs = pyclaw.BC.extrap
    domain = pyclaw.Domain([-1.0] * 3, [1.0] * 3, [n] * 3)
    state = pyclaw.State(domain, 4)
    state.problem_data["zz"] = 1.0
    state.problem_data["cc"] = 1.0
    x, y, z = domain.grid.c_centers
    state.q[0] = 5.0 * np.exp(-40.0 * (x ** 2 + y ** 2 + (z + 0.5) ** 2))
    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal, claw.num_output_times = tfinal, 1
    claw.output_format = None
    claw.run()
    return claw.solution.q


def het_checks(dev, q192_f32, n=192):
    """[5f]: the 32^3 float64 run on the card against the CPU's plain step;
    the n^3 float32 run (q192_f32, from [4f]) against an n^3 float64 card
    run; the x <-> y mirror symmetry of p in float64; the uniform-medium
    oracle."""
    out = {}
    c_k, st_k, w_k = run_het(dev, 32, np.float64)
    c_c, st_c, w_c = run_het("cpu", 32, np.float64)
    q_k, q_c = c_k.solution.q, c_c.solution.q
    steps_k = (st_k["numsteps"], st_k["numrejected"])
    steps_c = (st_c["numsteps"], st_c["numrejected"])
    out["card_vs_cpu_f64"] = float(np.abs(q_k - q_c).max()
                                   / np.abs(q_c).max())
    out["steps_card_32"], out["steps_cpu_32"] = steps_k, steps_c
    out["wall_card_32_s"], out["wall_cpu_32_s"] = w_k, w_c
    mirror32 = float(np.abs(q_k[0] - q_k[0].transpose(1, 0, 2)).max())
    c64, st64, w64 = run_het(dev, n, np.float64)
    q64 = c64.solution.q
    q32 = q192_f32.astype(np.float64)
    out["f32_vs_f64_l1"] = float(np.mean(np.abs(q32 - q64))
                                 / np.mean(np.abs(q64)))
    out["f32_vs_f64_max"] = float(np.abs(q32 - q64).max() / np.abs(q64).max())
    out["f64_steps_192"] = (st64["numsteps"], st64["numrejected"])
    out["f64_wall_192_s"] = w64
    mirror192 = float(np.abs(q64[0] - q64[0].transpose(1, 0, 2)).max())
    out["mirror_f64"] = max(mirror32, mirror192)
    del c64, q64
    c_vc, _, _ = run_het(dev, 16, np.float64, 0.2, rho_bot=1.0, c_bot=1.0)
    q_h = homogeneous_run(dev, 16, 0.2)
    out["uniform_f64"] = float(np.abs(c_vc.solution.q - q_h).max())
    print(f"[5f] het 32^3 f64 card vs cpu: max rel "
          f"{out['card_vs_cpu_f64']:.3e} (tol {HET_TOL['card_vs_cpu_f64']}), "
          f"steps card {steps_k}, cpu {steps_c} (wall {w_k:.3f} s, "
          f"{w_c:.3f} s); {n}^3 f32 vs f64 on the card: rel L1 "
          f"{out['f32_vs_f64_l1']:.3e} (tol {HET_TOL['f32_vs_f64_l1']}), "
          f"max rel {out['f32_vs_f64_max']:.3e}, f64 steps "
          f"{out['f64_steps_192']} in {w64:.3f} s; max |p - p^T| f64 "
          f"{mirror32:.3e} (32^3), {mirror192:.3e} ({n}^3) (tol "
          f"{HET_TOL['mirror_f64']}); uniform medium vs acoustics_3D 16^3 "
          f"f64 max abs {out['uniform_f64']:.3e} (tol "
          f"{HET_TOL['uniform_f64']})", flush=True)
    if steps_k != steps_c:
        fail(f"het 32^3 f64: steps card {steps_k} != cpu {steps_c}")
    if not (np.all(np.isfinite(q_k)) and q_k.shape == (4, 32, 32, 32)):
        fail("het 32^3 f64 on the card is not finite (4, 32, 32, 32)")
    for key, val in out.items():
        if key in HET_TOL and not val <= HET_TOL[key]:
            fail(f"het {key}: {val} > {HET_TOL[key]}")
    return out


def timing_step3_aos(dev, n=192, q_last=None):
    """step3_aos (the path's configuration: heterogeneous acoustics,
    transverse_waves 1, order 2, MC), its plain version and its bound at
    n^3 on the heterogeneous path's first input; with ``q_last`` (the
    path's final q, from [4f]) the kernel's time on that state too: the
    first state is zero away from the pulse, and the kernel's time
    depends on the data."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc, auxbc, args = step3_aos_case(n, dtype, dev)
        dt, deltas, rp = args[0], args[1:4], args[4]

        def kern():
            return tiled2d.step3_xy_generic(qbc, auxbc, *args)

        def plain():
            return plain_step3_aos(qbc, auxbc, dt, deltas, rp.name, (4, 4), 2,
                                   False, -1, 1)

        ms = time_ms(kern, 20, warm=2)
        plain_ms = time_ms(plain, 3, warm=1)
        ms_again = time_ms(kern, 20, warm=2)
        dev_ms, dev_n = device_ms_per_call(kern, "step3_aos_kernel", 10)
        item = qbc.element_size()
        b = bound_of((qbc.numel() + auxbc.numel() + 4 * n ** 3) * item,
                     flops_per_cell_3d_aos(rp.name, 1) * n ** 3, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, **b}
        if q_last is not None:
            qbc = padded3(q_last, dtype, dev).contiguous()
            out[tname]["ms_last_state"] = time_ms(kern, 20, warm=2)
            out[tname]["device_ms_last_state"] = device_ms_per_call(
                kern, "step3_aos_kernel", 10)[0]
            print(f"  timing step3_aos {n}^3 {tname} on the path's last "
                  f"state: kernel {out[tname]['ms_last_state']:.4f} ms (on "
                  f"the device {out[tname]['device_ms_last_state']} ms)",
                  flush=True)
        print(f"  timing step3_aos {n}^3 {tname}: kernel {ms:.4f} ms (repeat "
              f"{ms_again:.4f}; on the device {dev_ms} ms, {dev_n} launches "
              f"profiled), plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), share "
              f"of bound {b['bound_ms'] / ms:.4f}, library_ms null",
              flush=True)
        del qbc, auxbc
        torch.cuda.empty_cache()
    return out


# ---- the 3D Euler capacity path: step3_ctu's capacity variant -----------

# (index_capa, fwave) of [3h]: f-waves without aux, a capacity function,
# both
EULER_CAPA_FORMS = ((-1, True), (0, False), (0, True))
# The Euler capacity path (no golden): the 32^3 float64 run on the card
# against the same run on the CPU's plain step, and the kappa = 1 oracle
# against the no-capacity path (two variants of step3_ctu.cu; the
# capacity one divides dt by dD kappa in the working type and scales the
# rptt3 parts by (dt/(6 dE)) (dt/(dD kappa)) where the other rounds dt/dD
# and dt^2/(6 dD dE) from doubles: roundoff) (max relative); the 192^3
# float32 run
# against the 192^3 float64 run on the card (relative L1, as [5f]); the
# x <-> y mirror symmetry of rho in float64 (absolute, as [5f]); the
# change of the capacity-weighted mass sum(kappa rho) dV (relative): each
# update telescopes, so it moves by roundoff only while the front stays
# inside (float32: per-cell roundoff of ~1e-7 over ~50 steps, summed in
# float64; float64 the same at 1e-16); the change of q on the boundary
# cells (max, relative to max |q|) shows the front has not reached them
EULER_CAPA_TOL = {"card_vs_cpu_f64": 1e-10, "kappa1_vs_ctu_f64": 1e-12,
                  "f32_vs_f64_l1": 1e-4, "mirror_f64": 1e-11,
                  "mass_f32": 1e-5, "mass_f64": 1e-12,
                  "boundary_f32": 1e-6}


def euler_capa_matrix():
    """(transverse_waves, order, limiter, index_capa, fwave) of [3h] at
    the small grids."""
    return [(tw, order, lim, capa, fwave) for tw in (0, 1, 2)
            for order, lim in STEP3_AOS_LIMS
            for capa, fwave in EULER_CAPA_FORMS]


def random_euler_capa(rng, shape):
    """A seeded admissible Euler state with velocities of both signs in
    all three directions, and a capacity row in 0.7 .. 1.3."""
    q = random_state3(rng, *shape)
    return q, 0.7 + 0.6 * rng.random((1,) + shape)


def compare_step3_capa(dev, n_main=192, seed=8):
    """step3_ctu's capacity and f-wave variants vs the plain version, one
    step each, on the card: the main configuration (capacity,
    transverse_waves 2, order 2, MC) at n_main^3, the matrix at small
    grids, on the slice's state (the euler_3d state with its capacity
    function) and a seeded random one."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.classic import kernels
    from pyclaw_tpu_torch.ops import tiled2d
    rp = riemann.euler_3D
    params = {"gamma": 1.4}
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    worst_cfl = {"float32": 0.0, "float64": 0.0}
    main_abs_err = None
    ncase = 0
    matrix = euler_capa_matrix()
    main = [(2, 2, 4, 0, False)]
    for shape, cases in (((n_main,) * 3, main), ((16, 16, 16), matrix),
                         ((33, 17, 9), matrix), ((5, 40, 7), matrix),
                         ((3, 5, 2), matrix), ((45, 70, 50), main)):
        inputs = {"slice": euler3d_capa_state(*shape),
                  "random": random_euler_capa(rng, shape)}
        deltas = tuple(2.0 / n for n in shape)
        for iname, (q_np, aux_np) in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                qbc = padded3(q_np, dtype, dev).contiguous()
                auxbc = padded3_aux(aux_np, dtype, dev).contiguous()
                dt = float(np.dtype(tname).type(0.3 * min(deltas)))
                for tw, order, lim, capa, fwave in cases:
                    aux = auxbc if capa >= 0 else None
                    lims = (lim,) * 5
                    qk, ck = tiled2d.step3_xy(
                        qbc, dt, *deltas, params, lims, order, 2, tw,
                        auxbc=aux, index_capa=capa, fwave=fwave)
                    qp, cp = kernels.step3(
                        qbc, aux, dt, *deltas, rp.rp, rp.rpt, rp.rptt,
                        params, lims, order, fwave, capa, 2, tw,
                        rp.prefactor)
                    torch.cuda.synchronize()
                    abs_err = float((qk - qp).abs().max())
                    rel = abs_err / float(qp.abs().max())
                    dcfl = abs(float(ck) - float(cp)) / float(cp)
                    if not (np.isfinite(rel) and rel <= TOL_REL[tname]
                            and dcfl <= TOL_REL[tname]
                            and tuple(qk.shape) == (5,) + shape):
                        fail(f"step3_ctu capacity vs plain {shape} {iname} "
                             f"{tname} tw={tw} order={order} lim={lim} "
                             f"capa={capa} fwave={fwave}: rel err "
                             f"{rel:.3e}, cfl {float(ck)!r} vs "
                             f"{float(cp)!r}")
                    worst[tname] = max(worst[tname], rel)
                    worst_cfl[tname] = max(worst_cfl[tname], dcfl)
                    if (shape[0], iname, tname) == (n_main, "slice",
                                                    "float32"):
                        main_abs_err = abs_err
                    if shape[0] == n_main:
                        print(f"  step3_ctu capacity {shape} {iname:6s} "
                              f"{tname}: rel err {rel:.3e}, cfl rel "
                              f"{dcfl:.3e}", flush=True)
                    ncase += 1
                    del qk, qp
                del qbc, auxbc
                torch.cuda.empty_cache()
        print(f"  compare step3_ctu capacity {shape}: max rel err f32 "
              f"{worst['float32']:.3e} f64 {worst['float64']:.3e}; max cfl "
              f"rel f32 {worst_cfl['float32']:.3e} f64 "
              f"{worst_cfl['float64']:.3e}", flush=True)
    return worst, worst_cfl, main_abs_err, ncase


def run_euler3d_capa(dev, n, dtype, tfinal=0.2, kappa=None):
    """examples.euler_3d with its capacity function (add_capacity; or the
    constant ``kappa``) through Controller.run(); returns (claw, status,
    wall seconds)."""
    import torch
    from pyclaw_tpu_torch.examples import euler_3d as ex
    claw = ex.setup(mx=n, my=n, mz=n, dtype=dtype, outdir=None, device=dev)
    ex.add_capacity(claw.solution.state)
    if kappa is not None:
        claw.solution.state.aux[:] = kappa
    claw.tfinal = tfinal
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return claw, dict(status), time.perf_counter() - t0


def capacity_mass(q, aux):
    """sum(kappa rho) in float64 (dV is constant)."""
    return float(np.sum(aux[0].astype(np.float64) * q[0].astype(np.float64)))


def boundary_change(q, q0):
    """max |q - q0| over the outermost layer of cells, over max |q0|."""
    edge = np.zeros(q.shape[1:], bool)
    edge[[0, -1]] = True
    edge[:, [0, -1]] = True
    edge[:, :, [0, -1]] = True
    return float(np.abs(q[:, edge].astype(np.float64) - q0[:, edge]).max()
                 / np.abs(q0).max())


def euler_capa_checks(dev, q192_f32, n=192):
    """[5g]: the 32^3 float64 run on the card against the CPU's plain step;
    the kappa = 1 oracle against the no-capacity path at 32^3 in float64;
    the n^3 float32 run (q192_f32, from [4g]) against an n^3 float64 card
    run; the x <-> y mirror symmetry of rho in float64; the change of the
    capacity-weighted mass and of the boundary cells."""
    out = {}
    c_k, st_k, w_k = run_euler3d_capa(dev, 32, np.float64)
    c_c, st_c, w_c = run_euler3d_capa("cpu", 32, np.float64)
    q_k, q_c = c_k.solution.q, c_c.solution.q
    steps_k = (st_k["numsteps"], st_k["numrejected"])
    steps_c = (st_c["numsteps"], st_c["numrejected"])
    out["card_vs_cpu_f64"] = float(np.abs(q_k - q_c).max()
                                   / np.abs(q_c).max())
    out["steps_card_32"], out["steps_cpu_32"] = steps_k, steps_c
    out["wall_card_32_s"], out["wall_cpu_32_s"] = w_k, w_c
    mirror32 = float(np.abs(q_k[0] - q_k[0].transpose(1, 0, 2)).max())
    # kappa = 1 through step3_ctu's capacity variant against its variant
    # without a capacity function
    c_1, st_1, _ = run_euler3d_capa(dev, 32, np.float64, kappa=1.0)
    c_e, st_e, _ = run_euler3d(dev, 32, np.float64)
    steps_1 = (st_1["numsteps"], st_1["numrejected"])
    steps_e = (st_e["numsteps"], st_e["numrejected"])
    out["kappa1_vs_ctu_f64"] = float(
        np.abs(c_1.solution.q - c_e.solution.q).max()
        / np.abs(c_e.solution.q).max())
    out["steps_kappa1"], out["steps_ctu"] = steps_1, steps_e
    c64, st64, w64 = run_euler3d_capa(dev, n, np.float64)
    q64, aux64 = c64.solution.q, c64.solution.state.aux
    q0, aux0 = euler3d_capa_state(n, n, n)
    q32 = q192_f32.astype(np.float64)
    out["f32_vs_f64_l1"] = float(np.mean(np.abs(q32 - q64))
                                 / np.mean(np.abs(q64)))
    out["f32_vs_f64_max"] = float(np.abs(q32 - q64).max() / np.abs(q64).max())
    out["f64_steps_192"] = (st64["numsteps"], st64["numrejected"])
    out["f64_wall_192_s"] = w64
    mirror192 = float(np.abs(q64[0] - q64[0].transpose(1, 0, 2)).max())
    out["mirror_f64"] = max(mirror32, mirror192)
    m0_32 = capacity_mass(q0.astype(np.float32), aux0.astype(np.float32))
    m0_64 = capacity_mass(q0, aux0)
    out["mass_f32"] = abs(capacity_mass(q192_f32, aux0.astype(np.float32))
                          - m0_32) / m0_32
    out["mass_f64"] = abs(capacity_mass(q64, aux64) - m0_64) / m0_64
    out["boundary_f32"] = boundary_change(q192_f32, q0.astype(np.float32))
    out["boundary_f64"] = boundary_change(q64, q0)
    print(f"[5g] euler capacity 32^3 f64 card vs cpu: max rel "
          f"{out['card_vs_cpu_f64']:.3e} (tol "
          f"{EULER_CAPA_TOL['card_vs_cpu_f64']}), steps card {steps_k}, cpu "
          f"{steps_c} (wall {w_k:.3f} s, {w_c:.3f} s); kappa = 1 vs the "
          f"no-capacity variant 32^3 f64: max rel "
          f"{out['kappa1_vs_ctu_f64']:.3e} (tol "
          f"{EULER_CAPA_TOL['kappa1_vs_ctu_f64']}), steps {steps_1} vs "
          f"{steps_e}; {n}^3 f32 vs f64 on the card: rel L1 "
          f"{out['f32_vs_f64_l1']:.3e} (tol "
          f"{EULER_CAPA_TOL['f32_vs_f64_l1']}), max rel "
          f"{out['f32_vs_f64_max']:.3e}, f64 steps {out['f64_steps_192']} in "
          f"{w64:.3f} s; max |rho - rho^T| f64 {mirror32:.3e} (32^3), "
          f"{mirror192:.3e} ({n}^3) (tol {EULER_CAPA_TOL['mirror_f64']}); "
          f"change of sum(kappa rho) f32 {out['mass_f32']:.3e} (tol "
          f"{EULER_CAPA_TOL['mass_f32']}), f64 {out['mass_f64']:.3e} (tol "
          f"{EULER_CAPA_TOL['mass_f64']}); boundary cells' change f32 "
          f"{out['boundary_f32']:.3e} (tol {EULER_CAPA_TOL['boundary_f32']}),"
          f" f64 {out['boundary_f64']:.3e}", flush=True)
    if steps_k != steps_c:
        fail(f"euler capacity 32^3 f64: steps card {steps_k} != cpu "
             f"{steps_c}")
    if steps_1 != steps_e:
        fail(f"euler kappa = 1 32^3 f64: steps {steps_1} != no-capacity "
             f"path {steps_e}")
    if not (np.all(np.isfinite(q_k)) and q_k.shape == (5, 32, 32, 32)):
        fail("euler capacity 32^3 f64 on the card is not finite "
             "(5, 32, 32, 32)")
    for key, val in out.items():
        if key in EULER_CAPA_TOL and not val <= EULER_CAPA_TOL[key]:
            fail(f"euler capacity {key}: {val} > {EULER_CAPA_TOL[key]}")
    return out


def timing_step3_capa(dev, n=192, q_last=None):
    """step3_ctu's capacity variant (the capacity path's configuration:
    capacity, transverse_waves 2, order 2, MC), its plain version and its
    bound at n^3 on the path's first input
    (ops/time_kernels.py:euler3d_capa_case); with ``q_last`` (the path's
    final q, from [4g]) the kernel's time on that state too."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.classic import kernels
    rp = riemann.euler_3D
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc, auxbc, args = euler3d_capa_case(n, dtype, dev)
        dt, deltas, params = args[0], args[1:4], args[4]

        def kern():
            return tiled2d.step3_xy(qbc, *args, auxbc=auxbc, index_capa=0)

        def plain():
            return kernels.step3(qbc, auxbc, dt, *deltas, rp.rp, rp.rpt,
                                 rp.rptt, params, args[5], 2, False, 0, 2,
                                 2, rp.prefactor)

        ms = time_ms(kern, 10, warm=2)
        plain_ms = time_ms(plain, 2, warm=1)
        ms_again = time_ms(kern, 10, warm=2)
        dev_ms, dev_n = device_ms_per_call(kern, "step3_ctu_kernel", 10)
        item = qbc.element_size()
        b = bound_of((qbc.numel() + auxbc.numel() + 5 * n ** 3) * item,
                     FLOPS_PER_CELL_3D_CAPA * n ** 3, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, **b}
        if q_last is not None:
            qbc = euler3d_capa_case(n, dtype, dev, q_last)[0]
            out[tname]["ms_last_state"] = time_ms(kern, 10, warm=2)
            out[tname]["device_ms_last_state"] = device_ms_per_call(
                kern, "step3_ctu_kernel", 10)[0]
            print(f"  timing step3_ctu capacity {n}^3 {tname} on the "
                  f"path's last state: kernel "
                  f"{out[tname]['ms_last_state']:.4f} ms (on the device "
                  f"{out[tname]['device_ms_last_state']} ms)", flush=True)
        print(f"  timing step3_ctu capacity {n}^3 {tname}: kernel {ms:.4f} ms "
              f"(repeat {ms_again:.4f}; on the device {dev_ms} ms, {dev_n} "
              f"launches profiled), plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), share "
              f"of bound {b['bound_ms'] / ms:.4f}, library_ms null",
              flush=True)
        del qbc, auxbc
        torch.cuda.empty_cache()
    return out


# ---- the 1D paths: step1 (classic sweep) and weno5 (SharpClaw recon) ----

# Operations per cell of one classic 1D step of euler_with_efix_1D (order
# 2, MC, no capacity), counted from csrc/step1.cu and csrc/systems1d.cuh in
# the same way, each interface counted once (the halo interfaces are
# overhead, not work), the entropy fix on its common, non-transonic
# branch.  Per interface: the Roe average 24 (the cell's part, sqrt(rho),
# mom/sqrt(rho) and H, 11, once a cell; the average of two parts 13);
# strengths, waves and speeds 37; the entropy fix (three sound speeds 30:
# the cell's once and the two middle states', the two middle states 6,
# the transonic tests and split speeds 13) and amdq/apdq 33, 82; the
# limiter of three waves (norm and two dot products 15, the upwind choice
# and theta 3, nu 2, MC 6, the coefficient 6) 96; the correction flux 15;
# CFL 6 -> 260.  Per cell: the update 18 and the CFL reduction 1.
FLOPS_PER_CELL_STEP1 = 24 + 37 + 82 + 96 + 15 + 6 + 18 + 1

# Operations per cell of one step1 sweep of the augmented shallow-water
# solver (csrc/systems1d.cuh: SwAug1D; order 2, minmod, f-waves), counted
# in the same way, one interface a cell: the Riemann solve 115 (wet and
# wall tests and the extended states 18, sound speeds and the Roe-type
# average 16, Einfeldt and Ritter speeds 14, the augmented flux jump 22,
# the HLLE split 17, the f-waves, amdq and apdq with their dry and wall
# selects 28); the limiter of two waves (norm, dot product, theta,
# minmod, nu, the sign coefficient) 38; the correction flux 6; CFL 4; the
# update 12.  Nine operations per byte in float32 (q 2 and the bottom
# read, q 2 written): bytes bound it.
FLOPS_PER_CELL_SW_AUG = 115 + 38 + 6 + 4 + 12

# Operations per entry of one WENO5 reconstruction (left and right edge
# values), counted from csrc/weno5.cu and csrc/weno5.cuh, each term that
# neighbouring entries share counted once: smoothness indicators 23 (one
# curvature term 5, the three other squares and sums 18), candidate values
# 24 (four, each 5 and a division), the weights and the two weighted sums
# 42 in float32 (the normalised-beta branch) and 31 in float64.  A
# constant stencil needs only the weighted sums; bytes bound the kernel
# either way.
FLOPS_PER_ENTRY_WENO5 = {"float32": 23 + 24 + 42, "float64": 23 + 24 + 31}

SYSTEMS_1D = ("advection_1D", "acoustics_1D", "euler_with_efix_1D",
              "euler_roe_1D", "euler_hlle_1D")
PARAMS_1D = {"u": 0.7, "zz": 1.3, "cc": 0.8, "gamma": 1.4}
# interior lengths of [3e]: one cell, less than, equal to and more than
# one tile of 252 (csrc/step1.cu: TILE) and the first port's 256, two
# tiles and a cell, the main path's 800 and a long odd one
STEP1_NS = (1, 7, 251, 252, 253, 255, 256, 257, 505, 800, 100003)
# (order, limiter) of [3e]: first order, MC, van Leer and the CFL-dependent
# id 10
STEP1_LIMS = ((1, 4), (2, 4), (2, 3), (2, 10))
# advection's extra (order, limiter, index_capa, fwave) cases: a
# non-uniform capacity function, and the f-wave branch
STEP1_ADVECTION_EXTRA = ((2, 4, 0, False), (2, 10, 0, False),
                         (2, 4, -1, True), (2, 10, 0, True))
# sw_aug_1D in [3e]: interior lengths (the dry dam break's 500 among them)
# and (order, limiter): first order, minmod (the example's) and MC, all
# in the f-wave form the solver needs
SW_AUG_NS = (1, 7, 251, 252, 253, 500, 505, 100003)
SW_AUG_LIMS = ((1, 1), (2, 1), (2, 4))
# shapes of [3f]: the small tile (csrc/weno5.cu: weno5_tile, 128
# entries) at the path's (3, 806), on short rows, at its edges and on rows
# past the grid's 65535, and the large tile's edges (1024 entries in f32,
# 512 in f64): a row one short of, equal to and one past a tile, two
# tiles and three entries; and the timed (3, 2^20 + 6)
WENO5_SHAPES = ((1, 5), (3, 806), (4, 37, 131), (3, 127), (3, 129),
                (65537, 4), (257, 1023), (257, 1024), (257, 1025),
                (129, 2051), (513, 511), (513, 512), (513, 513),
                (257, 1027), (3, 2 ** 20 + 6))
# the 1D goldens on the card that the validator ([5v]) has no case for:
# (golden, example module, setup keywords, float32 tolerance), held to
# 1e-3 (advection_1d, advection_1d_sharpclaw and euler_1d_sod_sharpclaw
# are validator cases, at the same tolerances and t check)
GOLDENS_1D = (
    ("acoustics_1d", "acoustics_1d", dict(nx=100), 1e-3),
    ("euler_1d_sod", "euler_1d_shocktube",
     dict(nx=200, solver_type="classic"), 1e-3))
# the two (case, type) pairs of the validator that no run can be held to
# at the tolerance: the JAX package's own run, from its initial state moved
# by one ulp, misses their goldens by 3.2e-4 to 4.75e-2 (the dry dam break
# in float32, 16 of 30 seeds above its 2e-3) and by 5.0e-9 to 2.20e-8 (the
# char_decomp Sod tube in float64, 23 of 30 above 1e-8) on the CPU
# (`python tests/test_torch_validate.py`).  [5v] holds each to the largest
# of those readings, a fixed bound; every other pair to the tolerance.
CONDITIONED = {("dam_break_dry_1d", "float32"): 4.8e-2,
               ("euler_1d_sod_chardecomp", "float64"): 2.2e-8}
# the Sod path at 800 cells in float32 against the same run in float64 on
# the card (relative L1, max relative) and the change of mass and energy
# (relative; no wave reaches the ends by t=0.2).  The plain versions on
# the CPU give 1.8e-7 / 8.5e-7 / 2.3e-8 (classic) and 9.0e-6 / 9.9e-5 /
# 7.8e-6 (SharpClaw, whose float32 weights and positivity fallback move
# mass by roundoff); the gates leave a factor of ten or more.
SOD_RUN_TOL = {"classic": (1e-5, 1e-4, 1e-6),
               "sharpclaw": (1e-4, 1e-3, 1e-4)}
# [4i]: the Sod tube in float64 on the card against the CPU, with gauges
# and with before_step (max relative, as [5f]'s card against the CPU)
LOOP_HOOK_TOL = 1e-10


def random_state_1d(rng, name, m, seed):
    """A seeded ghost-padded 1D state (num_eqn, m) of system ``name`` and
    its aux rows with a positive capacity row after them.  Euler states
    have velocities of either sign, so some interfaces are transonic (the
    entropy fix's branches).  A library system's state is
    ops/time_kernels.py:library_state's (admissible, the transonic and
    sign branches taken) and its capacity row is drawn from ``seed``, not
    from ``rng``, so the five systems' states stay as they were."""
    if name in LIBRARY_1D:
        q, aux = library_state(name, m, seed)
        cap = 0.7 + 0.6 * np.random.default_rng(seed).random((1, m))
        return q, cap if aux is None else np.vstack([aux, cap])
    if name.startswith("euler"):
        rho = 0.3 + rng.random(m)
        u = 1.5 * rng.standard_normal(m)
        p = 0.2 + rng.random(m)
        q = np.stack([rho, rho * u, p / 0.4 + 0.5 * rho * u * u])
    else:
        q = rng.standard_normal((2 if name == "acoustics_1D" else 1, m))
    return q, 0.7 + 0.6 * rng.random((1, m))


def random_sw_aug_state(rng, m):
    """A seeded ghost-padded state (2, m) of sw_aug_1D and its bottom (1,
    m): each cell wet (depth 0.2 .. 1.2, either velocity), dry on a low
    bottom, dry on a high bottom (above any neighbour's surface: a wall)
    or damp (0 < h < dry_tolerance), so that the interfaces take every
    branch of the augmented solver."""
    kind = rng.integers(0, 4, m)
    dry = DAM_PARAMS["dry_tolerance"]
    h = np.where(kind == 0, 0.2 + rng.random(m),
                 np.where(kind == 3, dry * rng.random(m), 0.0))
    b = np.where(kind == 2, 2.0 + rng.random(m), 0.3 * rng.random(m))
    return np.stack([h, h * rng.standard_normal(m)]), b[None]


def params_1d(name):
    """The physics scalars of [3e]'s cases of system ``name``."""
    if name == "sw_aug_1D":
        return DAM_PARAMS
    return LIBRARY_1D.get(name, PARAMS_1D)


def plain_step1(qbc, auxbc, dt, dx, name, lims, order, fwave, capa,
                params=None):
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.classic import kernels
    params = params_1d(name) if params is None else params
    return kernels.step1(qbc, auxbc, dt, dx, riemann.ALL[name].rp,
                         params, lims, order, fwave, capa, 2)


def step1_vs_plain(qbc, auxbc, dt, dx, name, lims, order, fwave, capa,
                   params=None):
    """step1 and its plain version on one input: (q, cfl) of each."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import sweep
    rp = riemann.ALL[name]
    params = params_1d(name) if params is None else params
    args = (qbc, auxbc, dt, dx, rp, params, lims, order, fwave, capa)
    qk, ck = sweep.step1(*args)
    qp, cp = plain_step1(qbc, auxbc, dt, dx, name, lims, order, fwave, capa,
                         params)
    torch.cuda.synchronize()
    return qk, ck, qp, cp


# [3e]'s cases of the library systems (step1.cu ids 6-15): (order,
# limiter, capacity, f-waves), limiter 0 the system's example's; the four
# variants (capacity x form) each launch
LIBRARY_STEP1_CASES = ((1, 0, False, False), (2, 0, False, False),
                       (2, 10, True, False), (2, 0, False, True),
                       (2, 1, True, True))
# the other branches [3e] takes: the p-system's linear stress law,
# Burgers without its entropy fix
LIBRARY_VARIANTS = {"psystem_1D": {"stress_relation": "linear"},
                    "burgers_1D": {"efix": False}}


def step1_cases(name):
    """[3e]'s cases of 1D system ``name``: (the sets of physics scalars it
    runs with, dt / dx, its (order, limiter, index_capa, fwave) cases, the
    case of its main configuration, None for none).  The five systems:
    STEP1_LIMS, advection with STEP1_ADVECTION_EXTRA too, dt = 0.1 dx.
    The library systems: LIBRARY_STEP1_CASES with the example's limiter
    and the capacity row after the aux rows, with the example's scalars
    and the other branch of LIBRARY_VARIANTS, dt = 0.05 dx (CFL below
    0.5); the main configuration is the example's (order 2, its limiter
    and form, no capacity)."""
    from pyclaw_tpu_torch.ops import sweep
    if name not in LIBRARY_1D:
        cases = [(order, lim, -1, False) for order, lim in STEP1_LIMS]
        if name == "advection_1D":
            cases += list(STEP1_ADVECTION_EXTRA)
        return [PARAMS_1D], 0.1, cases, None
    lim_ex, fwave_ex = LIBRARY_OPTS[name]
    naux = sweep.AUX_ROWS_1D.get(name, 0)
    cases = [(order, lim or lim_ex, naux if capa else -1, fwave)
             for order, lim, capa, fwave in LIBRARY_STEP1_CASES]
    plist = [LIBRARY_1D[name]] + ([LIBRARY_VARIANTS[name]]
                                  if name in LIBRARY_VARIANTS else [])
    return plist, 0.05, cases, (2, lim_ex, -1, fwave_ex)


def compare_step1(dev, seed=4):
    """step1 vs its plain version, one step each, on the card: the five 1D
    systems and the ten library systems at every n of STEP1_NS (seeded
    states, random_state_1d; the Sod state too at n = 800) in the cases
    of :func:`step1_cases`.  Then sw_aug_1D at every n of SW_AUG_NS on
    seeded wet/dry states (random_sw_aug_state) and, at 500, the dry dam
    break's first state.  The CFL must be equal bit for bit.  Returns
    (worst relative error, max abs error at the main configurations (Sod,
    sw_aug, each library system at the largest n), cases)."""
    import torch
    from pyclaw_tpu_torch import riemann
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    main_abs_err = {}
    ncase = 0

    def check(label, n, nq, tname, qk, ck, qp, cp):
        abs_err = float((qk - qp).abs().max())
        scale = float(qp.abs().max())
        rel = abs_err / scale if scale > 0.0 else abs_err
        if not (np.isfinite(rel) and rel <= TOL_REL[tname]
                and float(ck) == float(cp) and tuple(qk.shape) == (nq, n)):
            fail(f"step1 vs plain {label}: rel err {rel:.3e}, cfl "
                 f"{float(ck)!r} vs {float(cp)!r}")
        worst[tname] = max(worst[tname], rel)
        return abs_err
    for n in STEP1_NS:
        dx = 1.0 / n
        for k, name in enumerate(SYSTEMS_1D + tuple(LIBRARY_1D)):
            rp = riemann.ALL[name]
            q_np, aux_np = random_state_1d(rng, name, n + 4, 100 * n + k)
            inputs = {"random": q_np}
            if n == 800 and name == "euler_with_efix_1D":
                inputs["sod"] = padded_1d(sod_state(n), torch.float64,
                                          "cpu", 2).numpy()
            plist, dt_dx, cases, main = step1_cases(name)
            for iname, qn in inputs.items():
                for tname, dtype in (("float32", torch.float32),
                                     ("float64", torch.float64)):
                    qbc = torch.as_tensor(qn, dtype=dtype, device=dev)
                    auxbc = torch.as_tensor(aux_np, dtype=dtype, device=dev)
                    dt = float(np.dtype(tname).type(dt_dx * dx))
                    for params in plist:
                        ptxt = f" {params}" if name in LIBRARY_1D else ""
                        for case in cases:
                            order, lim, capa, fwave = case
                            lims = (lim,) * rp.num_waves
                            res = step1_vs_plain(qbc, auxbc, dt, dx, name,
                                                 lims, order, fwave, capa,
                                                 params)
                            abs_err = check(
                                f"n={n} {name}{ptxt} {iname} {tname} "
                                f"order={order} lim={lim} capa={capa} "
                                f"fwave={fwave}", n, rp.num_eqn, tname, *res)
                            if (iname, tname, order, lim) == ("sod",
                                                              "float32", 2,
                                                              4):
                                main_abs_err["sod"] = abs_err
                            if (case == main and tname == "float32"
                                    and n == STEP1_NS[-1]
                                    and params is plist[0]):
                                main_abs_err[name] = abs_err
                            ncase += 1
        print(f"  compare step1 n={n}: max rel err f32 "
              f"{worst['float32']:.3e} f64 {worst['float64']:.3e}; the CFL "
              f"equal in every case", flush=True)
    for n in SW_AUG_NS:
        dx = 10.0 / n
        q_np, aux_np = random_sw_aug_state(rng, n + 4)
        inputs = {"random": (q_np, aux_np)}
        if n == 500:
            from pyclaw_tpu_torch.examples import dam_break_dry as ex
            st = ex.setup(nx=n, outdir=None, device="cpu").solution.state
            inputs["dam"] = tuple(padded_1d(a, torch.float64, "cpu",
                                            2).numpy()
                                  for a in (st.q, st.aux))
        for iname, (qn, an) in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                qbc = torch.as_tensor(qn, dtype=dtype, device=dev)
                auxbc = torch.as_tensor(an, dtype=dtype, device=dev)
                dt = float(np.dtype(tname).type(0.02 * dx))
                for order, lim in SW_AUG_LIMS:
                    res = step1_vs_plain(qbc, auxbc, dt, dx, "sw_aug_1D",
                                         (lim, lim), order, True, -1)
                    abs_err = check(f"n={n} sw_aug_1D {iname} {tname} "
                                    f"order={order} lim={lim}", n, 2, tname,
                                    *res)
                    if (iname, tname, order, lim) == ("dam", "float32", 2,
                                                      1):
                        main_abs_err["sw_aug"] = abs_err
                    ncase += 1
        print(f"  compare step1 sw_aug_1D n={n}: max rel err f32 "
              f"{worst['float32']:.3e} f64 {worst['float64']:.3e}; the CFL "
              f"equal in every case", flush=True)
    print(f"  compare step1 (every system): max rel err f32 "
          f"{worst['float32']:.3e} f64 {worst['float64']:.3e}", flush=True)
    return worst, main_abs_err, ncase


def compare_weno5(dev, seed=5):
    """weno5 vs its plain version on the card: seeded random data at every
    shape of WENO5_SHAPES, the Sod state padded for SharpClaw at (3, 806),
    and constant data, which must stay finite in float32 too."""
    import torch
    from pyclaw_tpu_torch.limiters import recon
    from pyclaw_tpu_torch.ops import weno
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    main_abs_err = None
    ncase = 0
    for shape in WENO5_SHAPES:
        inputs = {"random": rng.standard_normal(shape),
                  "constant": np.full(shape, 0.5)}
        if shape == (3, 806):
            inputs["sod"] = padded_1d(sod_state(800), torch.float64, "cpu",
                                      3).numpy()
        for iname, q_np in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                q = torch.as_tensor(q_np, dtype=dtype, device=dev)
                lk, rk = weno.weno5(q)
                lp, rp = recon.weno5(q)
                torch.cuda.synchronize()
                abs_err = max(float((lk - lp).abs().max()),
                              float((rk - rp).abs().max()))
                rel = abs_err / max(float(lp.abs().max()),
                                    float(rp.abs().max()))
                finite = bool(torch.isfinite(lk).all()
                              and torch.isfinite(rk).all())
                if not (finite and rel <= TOL_REL[tname]
                        and lk.shape == rk.shape == q.shape):
                    fail(f"weno5 vs plain {shape} {iname} {tname}: rel err "
                         f"{rel:.3e}, finite {finite}")
                worst[tname] = max(worst[tname], rel)
                if (iname, tname) == ("sod", "float32"):
                    main_abs_err = abs_err
                ncase += 1
        print(f"  compare weno5 {shape}: max rel err f32 "
              f"{worst['float32']:.3e} f64 {worst['float64']:.3e}; constant "
              f"data finite", flush=True)
    return worst, main_abs_err, ncase


def run_sod(dev, n, dtype, solver_type, tfinal=0.2, char_decomp=0):
    """examples.euler_1d_shocktube through Controller.run(); returns
    (claw, status, wall seconds)."""
    import torch
    from pyclaw_tpu_torch.examples import euler_1d_shocktube as ex
    claw = ex.setup(nx=n, solver_type=solver_type, dtype=dtype, outdir=None,
                    device=dev, char_decomp=char_decomp)
    claw.tfinal = tfinal
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def kernel_counts():
    """The launch counts of every kernel wrapper, by kernel."""
    from pyclaw_tpu_torch.ops import kernel_wrappers
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def reset_kernel_counts():
    """Every wrapper's launch count, and its device counter where it has
    one, to 0."""
    from pyclaw_tpu_torch.ops import kernel_wrappers
    for fn in kernel_wrappers().values():
        fn.launches = 0
        if fn.device_launches is not None:
            fn.device_launches.zero_()


def counted_run(run, within=contextlib.nullcontext):
    """``run()`` (a path's Controller.run: (claw, status, wall)) inside the
    context ``within()`` with every wrapper's launch count and device
    counter set to 0 just before it and read just after: (claw, status,
    wall, the wrappers' counts of the launches they made or captured, the
    device counters' counts of the launches the card ran, a graph's
    replays included).  Needs the device counters
    (``ops.count_on_device``), whose increments the wall includes."""
    import torch
    from pyclaw_tpu_torch.ops import kernel_wrappers
    reset_kernel_counts()
    with within():
        claw, status, wall = run()
    torch.cuda.synchronize()
    ran = {k: int(fn.device_launches)
           for k, fn in kernel_wrappers().items()}
    return claw, status, wall, kernel_counts(), ran


def sod_path(dev, n=800):
    """[4e]: the Sod path at n cells in float32, classic and SharpClaw
    SSP104, each with every launch count set to 0 just before it and read
    just after; then each against the same run in float64 on the card,
    and the change of mass and energy."""
    q0 = sod_state(n)
    out = {}
    for solver_type in ("classic", "sharpclaw"):
        claw, status, wall, counts, ran = counted_run(
            lambda: run_sod(dev, n, np.float32, solver_type))
        ns, nr = status["numsteps"], status["numrejected"]
        q = claw.solution.q.astype(np.float64)
        ref, st64, wall64 = run_sod(dev, n, np.float64, solver_type)
        q64 = ref.solution.q
        l1 = float(np.mean(np.abs(q - q64)) / np.mean(np.abs(q64)))
        mx_rel = float(np.max(np.abs(q - q64)) / np.max(np.abs(q64)))
        cons = max(abs(float(np.sum(q[k])) - float(np.sum(q0[k])))
                   / float(np.sum(q0[k])) for k in (0, 2))
        kernel, per_step = (("step1", 1) if solver_type == "classic"
                            else ("weno5", 10))
        status = dict(status)
        res = {"accepted": ns, "rejected": nr, "wall_s_counted": wall,
               "launches": ran, "wrapper_counts": counts,
               "f64_accepted": st64["numsteps"],
               "f64_rejected": st64["numrejected"], "f64_wall_s": wall64,
               "vs_f64_l1": l1, "vs_f64_max": mx_rel,
               "mass_energy_change": cons}
        out[solver_type] = res
        print(f"[4e] sod {solver_type} {n} f32 to t={claw.solution.t}: {ns} "
              f"accepted + {nr} rejected steps, {ran[kernel]} {kernel} "
              f"launches the card ran ({ran}; the wrappers' counts "
              f"{counts}), {wall:.3f} s wall with the device counters; "
              f"against float64 "
              f"({st64['numsteps']} + {st64['numrejected']} steps, "
              f"{wall64:.3f} s): rel L1 {l1:.3e}, max rel {mx_rel:.3e}; "
              f"mass/energy change {cons:.3e}", flush=True)
        res["loop"] = check_path_launches(f"sod {solver_type}", claw, status,
                                          counts, kernel, per_step,
                                          ran=ran)
        if nr < 1:
            fail(f"sod {solver_type}: the first step at dt_initial=0.1 "
                 f"should be rejected")
        if q.shape != (3, n) or not np.all(np.isfinite(q)):
            fail(f"sod {solver_type}: result is not finite (3, {n})")
        if np.min(q[0]) <= 0.0 or abs(claw.solution.t - 0.2) > 1e-12:
            fail(f"sod {solver_type}: a non-positive density or t="
                 f"{claw.solution.t}")
        tol_l1, tol_max, tol_cons = SOD_RUN_TOL[solver_type]
        if not (l1 <= tol_l1 and mx_rel <= tol_max and cons <= tol_cons):
            fail(f"sod {solver_type} f32 vs f64: rel L1 {l1}, max rel "
                 f"{mx_rel}, mass/energy change {cons}")
    return out


def goldens_1d(dev):
    """[5e]: the 1D goldens of GOLDENS_1D on the card, float32 and
    float64."""
    import importlib
    out = {}
    for name, module, kwargs, tol32 in GOLDENS_1D:
        ex = importlib.import_module(f"pyclaw_tpu_torch.examples.{module}")
        ref = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npz"))
        for tname, dtype, tol in (("float32", np.float32, tol32),
                                  ("float64", np.float64,
                                   GOLDEN_TOL["float64"])):
            claw = ex.setup(outdir=None, device=dev, dtype=dtype, **kwargs)
            st = claw.run()
            q = claw.solution.q.astype(np.float64)
            rel = float(np.max(np.abs(q - ref["q"]))
                        / np.max(np.abs(ref["q"])))
            out[f"{name}:{tname}"] = rel
            print(f"[5e] golden {name} {tname}: rel err {rel:.3e} (tol "
                  f"{tol}), {st['numsteps']} + {st['numrejected']} steps",
                  flush=True)
            if not rel <= tol:
                fail(f"golden {name} {tname}: {rel} > {tol}")
            if abs(claw.solution.t - float(ref["t"])) > 1e-10:
                fail(f"golden {name} {tname}: t={claw.solution.t}")
    return out


def timing_1d(dev):
    """step1 and weno5 on the states of ``CASES_1D`` (the Sod state at
    2^20 and at the path's 800 cells, a seeded smooth state at 2^20; 2
    ghost cells for step1, 3 for weno5 as the SharpClaw path pads them):
    the time of a wrapper call (CUDA events), the kernel's device time
    (torch.profiler), the plain version, the bound and its share of the
    device time, float32 and float64.  Keys: "800:float32" and the like
    on the Sod state, "smooth 1048576:float32" on the smooth one."""
    import torch
    from pyclaw_tpu_torch.classic import kernels
    from pyclaw_tpu_torch.limiters import recon
    from pyclaw_tpu_torch.ops import sweep, weno
    out = {"step1": {}, "weno5": {}}
    for state, n in CASES_1D.values():
        prefix = "" if state == "sod" else f"{state} "
        for tname, dtype in (("float32", torch.float32),
                             ("float64", torch.float64)):
            item = torch.finfo(dtype).bits // 8
            iters = 200 if n == 800 else 50
            qbc, args = step1_case(n, dtype, dev, state)
            # bytes: q (and the dam break's bottom) read, q written
            nbytes = (qbc.numel() + (0 if args[0] is None
                                     else args[0].numel())
                      + qbc.shape[0] * n) * item
            flops = (FLOPS_PER_CELL_SW_AUG if state == "dam"
                     else FLOPS_PER_CELL_STEP1)
            kerns = {
                "step1": (lambda: sweep.step1(qbc, *args),
                          lambda: kernels.step1(qbc, *args[:3],
                                                args[3].rp, *args[4:]),
                          "step1_kernel", bound_of(nbytes, flops * n, tname),
                          list(qbc.shape))}
            if state != "dam":
                q = weno5_case(n, dtype, dev, state)
                kerns["weno5"] = (
                    lambda: weno.weno5(q), lambda: recon.weno5(q),
                    "weno5_kernel",
                    bound_of(3 * q.numel() * item,
                             FLOPS_PER_ENTRY_WENO5[tname] * q.numel(), tname),
                    list(q.shape))
            for name, (kern, plain, needle, bound, shape) in kerns.items():
                ms = time_ms(kern, iters)
                plain_ms = time_ms(plain, iters // 5, warm=2)
                ms_again = time_ms(kern, iters)
                dev_ms, dev_n = device_ms_per_call(kern, needle)
                share = (bound["bound_ms"] / dev_ms if dev_ms else None)
                rec = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                       "device_launches_profiled": dev_n,
                       "plain_ms": plain_ms, "shape": shape,
                       "share_of_device": share, **bound}
                out[name][f"{prefix}{n}:{tname}"] = rec
                print(f"  timing {name} {state} {tuple(shape)} {tname}: "
                      f"wrapper call {ms:.4f} ms (repeat {ms_again:.4f}), "
                      f"kernel on the device {dev_ms} ms ({dev_n} launches "
                      f"profiled), plain {plain_ms:.4f} ms, bound "
                      f"{rec['bound_ms']:.6f} ms ({rec['bound_by']}; bytes "
                      f"{rec['bytes_ms']:.6f}, operations "
                      f"{rec['ops_ms']:.6f}), share of the device time "
                      f"{share}, library_ms null", flush=True)
    return out


# device kernels grouped by what launched them (by kernel name)
DEVICE_GROUPS = (("kernel", ("step2_ctu", "dq2_weno5", "dq2_weno_kernel",
                             "step3_ctu", "step2_aos", "step1_kernel",
                             "weno5_kernel", "step3_aos")),
                 ("bc_extension", ("CatArrayBatchedCopy", "copy_kernel")),
                 ("cfl_reduction", ("reduce_kernel", "maximum")),
                 ("memcpy", ("Memcpy", "Memset")))


def device_group(key):
    for group, needles in DEVICE_GROUPS:
        if any(k in key for k in needles):
            return group
    return "elementwise"     # stage combines and other arithmetic


def smooth_keys(tm):
    """The record keys of a 1D kernel's timing on the smooth state at 2^20
    (timing_1d), each type's device time and share of the bound."""
    out = {}
    for tname, suffix in (("float32", ""), ("float64", "_f64")):
        rec = tm[f"smooth {2 ** 20}:{tname}"]
        out[f"device_ms_smooth{suffix}"] = rec["device_ms"]
        out[f"share_smooth{suffix}"] = rec["share_of_device"]
    return out


def profile_main_path(label, run_path):
    """A main path, driven by ``run_path()`` (a Controller.run through
    run_quadrants or run_euler3d, returning (claw, status, wall)), once on
    the host clock alone and once under torch.profiler: the device busy
    share of a step, device time by kernel and by group, and host time by
    operation (the latter inflated by the profiler)."""
    import torch

    def run():
        _, status, wall = run_path()
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
    launches = sum(r[2] for r in dev_rows) / steps
    busy_share = device_us / (step_ms * 1e3)
    groups = {}
    for self_dev, key, _ in dev_rows:
        g = device_group(key)
        groups[g] = groups.get(g, 0.0) + self_dev / steps
    print(f"  profile {label}: "
          f"{steps} steps, {step_ms:.4f} ms/step wall "
          f"({wall_prof / steps * 1e3:.4f} under the profiler), device "
          f"kernels {device_us:.2f} us/step in {launches:.1f} launches, "
          f"device busy share {busy_share:.4f}", flush=True)
    print("    device us/step by group: " + ", ".join(
        f"{g} {v:.2f}" for g, v in sorted(groups.items(),
                                          key=lambda kv: -kv[1])))
    for self_dev, key, count in dev_rows[:8]:
        print(f"    device {self_dev / steps:10.3f} us/step  {count:6d}x  "
              f"{key[:60]}")
    for self_cpu, key, count in host_rows[:6]:
        print(f"    host   {self_cpu / steps:10.3f} us/step  {count:6d}x  "
              f"{key[:60]}")
    return {"steps": steps, "step_ms": step_ms,
            "step_ms_profiled": wall_prof / steps * 1e3,
            "device_us_per_step": device_us,
            "device_launches_per_step": launches,
            "device_busy_share": busy_share,
            "device_us_per_step_by_group": groups,
            "kernels_us_per_step": {k[:60]: s / steps
                                    for s, k, _ in dev_rows[:8]},
            "host_us_per_step_profiled": {k[:60]: s / steps
                                          for s, k, _ in host_rows[:6]}}


def profile_loops(label, run_path):
    """profile_main_path of a path on the device loop (its default) and
    on the host loop (``traced_evolve = False``), in turns."""
    out = {"graph": profile_main_path(label + ", device loop", run_path)}
    with host_loop():
        out["host"] = profile_main_path(label + ", host loop", run_path)
    return out


def sharp_card_vs_cpu(dev, n=80):
    """SharpClaw quadrants at n^2 to t=0.8 (frames at 0.2, 0.4, 0.6, 0.8)
    on the card, on the CPU, and on the CPU from a state moved by one ulp
    (the run's own rounding sensitivity), float64 and float32; returns
    the comparison per dtype."""
    out = {}
    for tname, dtype in (("float64", np.float64), ("float32", np.float32)):
        runs = {}
        for label, where, seed in (("card", dev, None), ("cpu", "cpu", None),
                                   ("cpu_ulp", "cpu", 7)):
            c, st, w = run_quadrants(where, n, dtype, 0.8, "sharpclaw",
                                     keep_copy=True, perturb_seed=seed)
            if abs(c.frames[1].t - 0.2) > 1e-12 or abs(c.solution.t - 0.8) \
                    > 1e-12:
                fail(f"sharpclaw {n}^2 {tname} on {where}: frame times "
                     f"{[f.t for f in c.frames]}")
            runs[label] = (c.frames[1].q, c.solution.q,
                           (st["numsteps"], st["numrejected"]), w)

        def max_rel(a, b):
            return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))

        def l1_rel(a, b):
            return float(np.mean(np.abs(a - b)) / np.mean(np.abs(b)))
        (q2_k, q8_k, steps_k, w_k) = runs["card"]
        (q2_c, q8_c, steps_c, w_c) = runs["cpu"]
        (q2_u, q8_u, steps_u, _) = runs["cpu_ulp"]
        res = {"t0.2_max": max_rel(q2_k, q2_c),
               "t0.8_max": max_rel(q8_k, q8_c), "t0.8_l1": l1_rel(q8_k, q8_c),
               "ulp_t0.2_max": max_rel(q2_u, q2_c),
               "ulp_t0.8_max": max_rel(q8_u, q8_c),
               "ulp_t0.8_l1": l1_rel(q8_u, q8_c),
               "steps_card": steps_k, "steps_cpu": steps_c,
               "steps_cpu_ulp": steps_u,
               "wall_card_s": w_k, "wall_cpu_s": w_c}
        tol = dict(SHARP_RUN_TOL)
        tol["t0.2_max"] = max(tol["t0.2_max"],
                              ULP_FACTOR * res["ulp_t0.2_max"])
        res["tol"] = tol
        out[tname] = res
        print(f"[5b] sharpclaw {n}^2 {tname} card vs cpu: t=0.2 max rel "
              f"{res['t0.2_max']:.3e} (tol {tol['t0.2_max']:.3e}); t=0.8 "
              f"rel L1 {res['t0.8_l1']:.3e}, max rel {res['t0.8_max']:.3e}; "
              f"cpu vs cpu from a one-ulp move: t=0.2 max rel "
              f"{res['ulp_t0.2_max']:.3e}, t=0.8 rel L1 "
              f"{res['ulp_t0.8_l1']:.3e}, max rel {res['ulp_t0.8_max']:.3e}; "
              f"steps (accepted, rejected) card {steps_k}, cpu {steps_c}, "
              f"cpu moved {steps_u}; wall card {w_k:.3f} s, cpu {w_c:.3f} s",
              flush=True)
        if not (np.all(np.isfinite(q8_k)) and q8_k.shape == (4, n, n)):
            fail(f"sharpclaw {n}^2 {tname} on the card is not finite")
        checks = ["t0.8_l1", "t0.8_max"]
        if tname == "float64":
            checks.append("t0.2_max")
            if steps_k != steps_c:
                fail(f"sharpclaw {n}^2 f64: steps card {steps_k} != cpu "
                     f"{steps_c}")
        for key in checks:
            if not res[key] <= tol[key]:
                fail(f"sharpclaw {n}^2 {tname} card vs cpu: {key} "
                     f"{res[key]} > {tol[key]}")
    return out


# ---- the paths of this slice: acoustics 2D, the dry dam break, the Sod
# tube with char_decomp; the validator -----------------------------------

def run_acoustics(dev, n, dtype, tfinal=0.12, **kw):
    """examples.acoustics_2d through Controller.run() (``kw``: more of its
    setup keywords); returns (claw, status, wall seconds)."""
    import torch
    from pyclaw_tpu_torch.examples import acoustics_2d as ex
    claw = ex.setup(mx=n, my=n, dtype=dtype, outdir=None, device=dev, **kw)
    claw.tfinal = tfinal
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def run_dam(dev, n, dtype, tfinal=2.0):
    """examples.dam_break_dry (dimension 1) through Controller.run(), every
    frame kept; returns (claw, status, wall seconds)."""
    import torch
    from pyclaw_tpu_torch.examples import dam_break_dry as ex
    claw = ex.setup(nx=n, dtype=dtype, outdir=None, device=dev)
    claw.tfinal = tfinal
    claw.keep_copy = True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def acoustics_path(dev, n=1024):
    """[4j]: the acoustics path at n^2 in float32 to t=0.12 on the device
    loop, every launch count set to 0 just before it and read just after
    (step2_aos: 1 per attempted step), with the quadrants path's gates
    (the first step rejected, one capture, the attempts after the end,
    the readbacks a frame) and the x <-> y mirror symmetry of p."""
    claw, status, wall, counts, ran = counted_run(
        lambda: run_acoustics(dev, n, np.float32))
    ns, nr = status["numsteps"], status["numrejected"]
    loop = check_path_launches("acoustics path", claw, status, counts,
                               "step2_aos", 1, ran=ran)
    q = claw.solution.q
    mirror = float(np.abs(q[0] - q[0].T).max() / np.abs(q[0]).max())
    per_frame = loop["readbacks"] / loop["frames"]
    print(f"[4j] acoustics_2d path {n}^2 f32 to t={claw.solution.t}: {ns} "
          f"accepted + {nr} rejected steps, {ran['step2_aos']} step2_aos "
          f"launches the card ran ({ran}; the wrappers' counts {counts}), "
          f"{wall:.3f} s wall with the device counters; device loop {loop}, "
          f"{per_frame:.2f} readbacks a frame; max |p - p^T| / max |p| "
          f"{mirror:.3e}", flush=True)
    if nr < 1:
        fail("acoustics path: the first step at dt_initial=0.1 should be "
             "rejected")
    if q.shape != (3, n, n) or not np.all(np.isfinite(q)):
        fail(f"acoustics path: result is not finite (3, {n}, {n})")
    if abs(claw.solution.t - 0.12) > 1e-12 or loop["captures"] != 1:
        fail(f"acoustics path: ended at t={claw.solution.t}, "
             f"{loop['captures']} captures")
    if not mirror <= 1e-4:
        fail(f"acoustics path: mirror asymmetry {mirror}")
    return {"accepted": ns, "rejected": nr, "wall_s_counted": wall,
            "launches": ran, "wrapper_counts": counts, "loop": loop,
            "readbacks_per_frame": per_frame, "mirror_asymmetry": mirror}


# [4k]: the dry dam break's mass in the frames at t <= 1.0, before the
# rarefaction's head (sqrt(g) = 3.1 a unit of time from x = 0) and its
# numerical spread reach the left end at x = -5 (no flux crosses either end
# before), to roundoff: relative change per type (the plain version on the
# CPU: 4.5e-16 in float64, 5.1e-7 in float32)
DAM_MASS_TOL = {"float32": 1e-5, "float64": 1e-12}


def dam_path(dev, n=500):
    """[4k]: the dry dam break at n cells to t=2.0, float32 (every launch
    count set to 0 just before it and read just after; step1: 1 per
    attempted step) and float64: h >= 0 in every frame, the mass conserved
    to roundoff in the frames at t <= 1.0, and the float32 run against
    the float64 one (reported)."""
    out = {}
    q64 = None
    for tname, dtype in (("float32", np.float32), ("float64", np.float64)):
        if tname == "float32":
            claw, status, wall, counts, ran = counted_run(
                lambda: run_dam(dev, n, dtype))
            loop = check_path_launches("dam break path", claw, status,
                                       counts, "step1", 1, ran=ran)
        else:
            claw, status, wall = run_dam(dev, n, dtype)
            loop, ran, counts = dict(claw.solver.loop_stats), None, None
        ns, nr = status["numsteps"], status["numrejected"]
        frames = claw.frames
        mass0 = float(np.sum(frames[0].q[0], dtype=np.float64))
        hmin = min(float(f.q[0].min()) for f in frames)
        mass = max(abs(float(np.sum(f.q[0], dtype=np.float64)) - mass0)
                   / mass0 for f in frames if f.t <= 1.0)
        q = claw.solution.q.astype(np.float64)
        rec = {"accepted": ns, "rejected": nr, "wall_s_counted": wall,
               "launches": ran, "wrapper_counts": counts, "loop": loop,
               "frames": [f.t for f in frames], "h_min": hmin,
               "mass_change": mass}
        if tname == "float32":
            q32 = q
        else:
            q64 = q
        out[tname] = rec
        print(f"[4k] dam_break_dry path {n} {tname} to t={claw.solution.t}: "
              f"{ns} accepted + {nr} rejected steps"
              + (f", {ran['step1']} step1 launches the card ran ({ran}; the "
                 f"wrappers' counts {counts})" if ran else "")
              + f", {wall:.3f} s wall; device loop {loop}; min h over the "
              f"frames {hmin!r}, mass change to t=1.0 {mass:.3e}", flush=True)
        if nr < 1 or abs(claw.solution.t - 2.0) > 1e-12 or len(frames) != 5:
            fail(f"dam break path {tname}: {nr} rejected steps, t="
                 f"{claw.solution.t}, {len(frames)} frames")
        if q.shape != (2, n) or not np.all(np.isfinite(q)):
            fail(f"dam break path {tname}: result is not finite (2, {n})")
        if not (hmin >= 0.0 and mass <= DAM_MASS_TOL[tname]):
            fail(f"dam break path {tname}: min h {hmin}, mass change {mass}")
        del claw
    out["f32_vs_f64_max"] = float(np.max(np.abs(q32 - q64))
                                  / np.max(np.abs(q64)))
    out["f32_vs_f64_l1"] = float(np.mean(np.abs(q32 - q64))
                                 / np.mean(np.abs(q64)))
    print(f"    dam_break_dry f32 against f64: max rel "
          f"{out['f32_vs_f64_max']:.3e}, rel L1 {out['f32_vs_f64_l1']:.3e}",
          flush=True)
    return out


def chardecomp_path(dev, n=800):
    """[4l]: the Sod tube with SharpClaw char_decomp=2 at n cells in float32
    to t=0.2 on the device loop, every launch count set to 0 just before it
    and read just after: the whole stage is plain PyTorch (no kernel of
    the port; one restore an attempted step); against the same run in
    float64 on the card (SOD_RUN_TOL's SharpClaw gates), the change of
    mass and energy."""
    q0 = sod_state(n)
    claw, status, wall, counts, ran = counted_run(
        lambda: run_sod(dev, n, np.float32, "sharpclaw", char_decomp=2))
    ns, nr = status["numsteps"], status["numrejected"]
    loop = check_path_launches("sod chardecomp", claw, status, counts, None,
                               0, ran=ran)
    q = claw.solution.q.astype(np.float64)
    ref, st64, wall64 = run_sod(dev, n, np.float64, "sharpclaw",
                                char_decomp=2)
    q64 = ref.solution.q
    l1 = float(np.mean(np.abs(q - q64)) / np.mean(np.abs(q64)))
    mx_rel = float(np.max(np.abs(q - q64)) / np.max(np.abs(q64)))
    cons = max(abs(float(np.sum(q[k])) - float(np.sum(q0[k])))
               / float(np.sum(q0[k])) for k in (0, 2))
    print(f"[4l] sod sharpclaw char_decomp=2 {n} f32 to t={claw.solution.t}: "
          f"{ns} accepted + {nr} rejected steps, launches the card ran "
          f"{ran} (the wrappers' counts {counts}), {wall:.3f} s wall with "
          f"the device counters; device loop {loop}; against float64 "
          f"({st64['numsteps']} + {st64['numrejected']} steps, {wall64:.3f} "
          f"s): rel L1 {l1:.3e}, max rel {mx_rel:.3e}; mass/energy change "
          f"{cons:.3e}", flush=True)
    if nr < 1 or q.shape != (3, n) or not np.all(np.isfinite(q)):
        fail(f"sod chardecomp: {nr} rejected steps, or not finite (3, {n})")
    if np.min(q[0]) <= 0.0 or abs(claw.solution.t - 0.2) > 1e-12:
        fail(f"sod chardecomp: a non-positive density or t="
             f"{claw.solution.t}")
    tol_l1, tol_max, tol_cons = SOD_RUN_TOL["sharpclaw"]
    if not (l1 <= tol_l1 and mx_rel <= tol_max and cons <= tol_cons):
        fail(f"sod chardecomp f32 vs f64: rel L1 {l1}, max rel {mx_rel}, "
             f"mass/energy change {cons}")
    return {"accepted": ns, "rejected": nr, "wall_s_counted": wall,
            "launches": ran, "wrapper_counts": counts, "loop": loop,
            "f64_accepted": st64["numsteps"], "f64_wall_s": wall64,
            "vs_f64_l1": l1, "vs_f64_max": mx_rel,
            "mass_energy_change": cons}


def validator_phase(dev):
    """[5v]: pyclaw_tpu_torch.validate on the card, its ten cases in float32
    at tools/tpu_validate.py's tolerances and in float64 at 1e-8: every
    (case, type) ok, but the two of CONDITIONED, which the validator
    reports not ok when they miss and which must stay within their bound
    with the golden's t."""
    from pyclaw_tpu_torch import validate
    out = {}
    for dtype in ("float32", "float64"):
        res = validate.validate(device=dev, dtype=dtype)
        for name, rec in res.items():
            if "error" in rec:
                fail(f"[5v] {name} {dtype}: {rec['error']}")
            bound = CONDITIONED.get((name, dtype))
            print(f"[5v] golden {name} {dtype}: rel err "
                  f"{rec['rel_err']:.3e} (tol {rec['tol']}"
                  + (f", bound {bound}" if bound else "")
                  + f"), t={rec['t']}, {rec['seconds']:.3f} s, ok "
                  f"{rec['ok']}", flush=True)
            if not (rec["ok"] or (bound is not None and rec["t_ok"]
                                  and rec["rel_err"] <= bound)):
                fail(f"[5v] {name} {dtype}: {rec}")
            out[f"{name}:{dtype}"] = rec
    print("[5v] validator, ok at the tolerance: " + ", ".join(
        f"{dtype} {sum(r['ok'] for k, r in out.items() if k.endswith(dtype))}"
        f" of {len(validate.CASES)}" for dtype in ("float32", "float64"))
        + "; not ok, within the bound: " + (", ".join(
            k for k, r in out.items() if not r["ok"]) or "none"), flush=True)
    return out


# ---- SharpClaw on the generic dq: [3j], [3k], [4o], [4p], [5s] ------------

# [3j]: the grids of the acoustics instance of dq2_weno5.cu
DQ_ACOUSTICS_GRIDS = ((1024, 1024), (1000, 997), (17, 33))
ACOUSTICS_PARAMS = AOS_PARAMS[ACOUSTICS_2D]
# [3k]: weno5 on the three moved layouts of the SharpClaw 3D path's state
# (5, 198^3), each axis moved last and made contiguous as dq_nd does
WENO5_3D_N = 198
# [4o]: the SharpClaw Euler 3D path (n^3 float32 to t=0.2) and the same
# run in float64.  The problem is symmetric under each exchange of two
# axes; the mirrored problem sums the axes' parts in another order and its
# Roe averages take the transverse velocities in another order, so the
# runs are symmetric to roundoff as the scheme amplifies it, not to bits.
# WENO5 with SSP104 amplifies it by about 1e7 on this blast by t=0.2 at
# 192^3: the float64 run's asymmetry is 8.4e-10 there, the float32 run's
# 3.9e-3 (this phase, on the card), and the CPU's plain path in float32
# at 96^3 shows 4.5e-4 (tests/test_torch_sharpclaw3d.py --roundoff).  So
# the symmetry gate is the float64 run's, and the float32 run is held to
# the float64 one in relative L1 (3.7e-4 at 192^3), a bound that a wrong
# kernel or axis would pass by orders of magnitude
SHARP3D_N = 192
SHARP3D_TFINAL = 0.2
SHARP3D_SYM_TOL = 1e-5
SHARP3D_F32_L1_TOL = 1e-3
# [5s]: the card against the CPU in float64 (equal steps; q to this of
# max|q|: the plain operations and the kernel round as on the CPU up to
# the card's rsqrt and its fused operations)
SHARP3D_CARD_CPU_TOL = 1e-12


def compare_dq_acoustics(dev, seed=10):
    """[3j]: the acoustics instance of dq2_weno5 against its plain version
    (sharpclaw/soa.py:dq_2d_soa with acoustics_2D's SoA hooks) on the
    card, one dq each: a seeded random state and the example's radial
    pulse on each of DQ_ACOUSTICS_GRIDS, float32 and float64; dq to
    TOL_REL of max|dq| (in float32 to [3b]'s roundoff bound: at least
    ULP_FACTOR times the plain version's own change under a one-ulp move
    of its input, since on a smooth state dq is a small difference of
    the fluctuations and fluxes and the kernel's fused operations round
    it otherwise) and the CFL to TOL_REL relative."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.sharpclaw import soa as sc_soa
    rp = riemann.acoustics_2D
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    worst_cfl = {"float32": 0.0, "float64": 0.0}
    main_abs_err = None
    ncase = 0
    for nx, ny in DQ_ACOUSTICS_GRIDS:
        inputs = {"random": rng.standard_normal((3, nx, ny)),
                  "pulse": acoustics_state(nx, ny)}
        dx, dy = 2.0 / nx, 2.0 / ny
        for iname, q_np in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                qbc = padded(q_np, dtype, dev, num_ghost=3)
                dt = float(np.dtype(tname).type(0.6 / max(nx, ny)))
                dk, ck = tiled2d.dq_rows(qbc, dt, dx, dy, ACOUSTICS_PARAMS,
                                         rp=rp)
                def plain(qin):
                    return sc_soa.dq_2d_soa(qin, dt, dx, dy, rp.rpn_soa,
                                            ACOUSTICS_PARAMS, 5, 3,
                                            flux_soa=rp.flux_soa)
                dp, cp = plain(qbc)
                torch.cuda.synchronize()
                abs_err = float((dk - dp).abs().max())
                rel = abs_err / float(dp.abs().max())
                rel_cfl = abs(float(ck) - float(cp)) / float(cp)
                tol, sens = TOL_REL[tname], None
                if tname == "float32":
                    r = torch.as_tensor(rng.uniform(-1.0, 1.0, qbc.shape),
                                        dtype=dtype, device=dev)
                    dpp, _ = plain(qbc * (1.0 + torch.finfo(dtype).eps * r))
                    sens = float((dpp - dp).abs().max() / dp.abs().max())
                    tol = max(tol, ULP_FACTOR * sens)
                if not (np.isfinite(rel) and rel <= tol
                        and rel_cfl <= TOL_REL[tname]
                        and dk.shape == (3, nx, ny)):
                    fail(f"[3j] dq2_weno5 acoustics vs plain {nx}x{ny} "
                         f"{iname} {tname}: rel err {rel:.3e} (tol "
                         f"{tol:.3e}), cfl {float(ck)!r} vs {float(cp)!r}")
                worst[tname] = max(worst[tname], rel)
                worst_cfl[tname] = max(worst_cfl[tname], rel_cfl)
                if (nx, ny, iname, tname) == (1024, 1024, "pulse",
                                              "float32"):
                    main_abs_err = abs_err
                ncase += 1
                print(f"  dq acoustics {nx}x{ny} {iname:6s} {tname}: rel "
                      f"err {rel:.3e} (tol {tol:.1e}), cfl rel "
                      f"{rel_cfl:.3e}" + (f"; a one-ulp input change moves "
                                          f"the plain version by {sens:.3e}"
                                          if sens is not None else ""),
                      flush=True)
    return worst, worst_cfl, main_abs_err, ncase


def sharp3d_state(n):
    """q of examples.euler_3d at n^3 (a CPU array)."""
    from pyclaw_tpu_torch.examples import euler_3d as ex
    return ex.setup(mx=n, my=n, mz=n, outdir=None, device="cpu").solution.q


def weno5_3d_inputs(dtype, dev, seed=11):
    """[3k]'s states at (5, n^3), n = WENO5_3D_N (the SharpClaw 3D path's
    ghost-padded size): the path's first state padded by extrapolation
    (as its BCs pad it) and a seeded random one."""
    import torch
    n = WENO5_3D_N
    first = padded3(sharp3d_state(n - 6), dtype, dev)
    first = torch.nn.functional.pad(first[None], (1, 1, 1, 1, 1, 1),
                                    mode="replicate")[0].contiguous()
    rng = np.random.default_rng(seed)
    return {"first": first,
            "random": torch.as_tensor(random_state3(rng, n, n, n),
                                      dtype=dtype, device=dev)}


def compare_weno5_3d(dev):
    """[3k]: weno5 against its plain version (limiters/recon.py:weno5) on
    each of the three moved layouts (every axis moved last, contiguous) of
    [3k]'s (5, 198^3) states, float32 and float64, to TOL_REL of the
    edge values' max: the rows of 198 entries take the kernel's branch of
    large arrays (weno5_tile)."""
    import torch
    from pyclaw_tpu_torch.limiters import recon
    from pyclaw_tpu_torch.ops import weno
    worst = {"float32": 0.0, "float64": 0.0}
    main_abs_err = None
    ncase = 0
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        for iname, q in weno5_3d_inputs(dtype, dev).items():
            for axis in range(3):
                qm = q.movedim(1 + axis, -1).contiguous()
                lk, rk = weno.weno5(qm)
                lp, rp = recon.weno5(qm)
                torch.cuda.synchronize()
                abs_err = max(float((lk - lp).abs().max()),
                              float((rk - rp).abs().max()))
                rel = abs_err / max(float(lp.abs().max()),
                                    float(rp.abs().max()))
                if not (np.isfinite(rel) and rel <= TOL_REL[tname]):
                    fail(f"[3k] weno5 vs plain {iname} axis {axis} {tname}: "
                         f"rel err {rel:.3e}")
                worst[tname] = max(worst[tname], rel)
                if (tname, iname, axis) == ("float32", "first", 0):
                    main_abs_err = abs_err
                ncase += 1
                del lk, rk, lp, rp, qm
        print(f"  weno5 3D pencils (5, {WENO5_3D_N}^3) {tname}: max rel err "
              f"{worst[tname]:.3e} on {ncase} cases so far", flush=True)
    return worst, main_abs_err, ncase


def axis_asymmetry(q):
    """max over the three exchanges of two axes of |q - q mirrored| (the
    matching momentum components swapped too), relative to max|q|: the
    Euler 3D example is symmetric under each."""
    worst = 0.0
    for a, b in ((0, 1), (0, 2), (1, 2)):
        m = np.swapaxes(q, 1 + a, 1 + b).copy()
        m[[1 + a, 1 + b]] = m[[1 + b, 1 + a]]
        worst = max(worst, float(np.abs(m - q).max()))
    return worst / float(np.abs(q).max())


def euler3d_pressure(q, gamma=1.4):
    return (gamma - 1.0) * (q[4] - 0.5 * (q[1] ** 2 + q[2] ** 2 + q[3] ** 2)
                            / q[0])


def sharpclaw3d_path(dev, n=SHARP3D_N, tfinal=SHARP3D_TFINAL):
    """[4o]: examples.euler_3d with solver_type="sharpclaw" at n^3 in
    float32 through Controller.run() on the device loop, every launch count
    set to 0 just before it and read just after: weno5 30 launches an
    attempted step (10 stages, 3 axes) on the card's counter, restore
    once, no other kernel; the steps, the wall, the peak of the card's
    memory; q finite with rho > 0 and p > 0.  Then the same run in
    float64: symmetric under each exchange of two axes (the momentum
    components swapped with them) to SHARP3D_SYM_TOL of max|q|, and the
    float32 run within SHARP3D_F32_L1_TOL of it (relative L1); the
    float32 run's own asymmetry is reported (see SHARP3D_SYM_TOL)."""
    import torch
    torch.cuda.reset_peak_memory_stats(dev)
    claw, status, wall, counts, ran = counted_run(
        lambda: run_euler3d(dev, n, np.float32, tfinal,
                            solver_type="sharpclaw"))
    peak = torch.cuda.max_memory_allocated(dev)
    ns, nr = status["numsteps"], status["numrejected"]
    loop = check_path_launches("sharpclaw euler_3d path", claw, status,
                               counts, "weno5", 30, ran=ran)
    q = claw.solution.q
    t_end = claw.solution.t
    del claw
    asym = axis_asymmetry(q)
    p = euler3d_pressure(q.astype(np.float64))
    print(f"[4o] sharpclaw euler_3d path {n}^3 f32 SSP104 to t={t_end}: "
          f"{ns} accepted + {nr} rejected steps ({loop['attempts']} "
          f"attempted), {ran['weno5']} weno5 launches the card ran (30 x "
          f"attempts; {ran}; the wrappers' counts {counts}), {wall:.3f} s "
          f"wall with the device counters, peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; device loop {loop}; min rho "
          f"{float(q[0].min()):.4f}, min p {float(p.min()):.4f}, axis "
          f"asymmetry {asym:.3e}", flush=True)
    if q.shape != (5, n, n, n) or not np.all(np.isfinite(q)):
        fail(f"[4o]: result is not finite (5, {n}, {n}, {n})")
    if not (float(q[0].min()) > 0.0 and float(p.min()) > 0.0):
        fail("[4o]: rho or p not positive")
    if abs(t_end - tfinal) > 1e-12:
        fail(f"[4o]: ended at t={t_end}")
    c64, st64, wall64 = run_euler3d(dev, n, np.float64, tfinal,
                                    solver_type="sharpclaw")
    q64 = c64.solution.q
    del c64
    asym64 = axis_asymmetry(q64)
    l1 = float(np.abs(q - q64).sum() / np.abs(q64).sum())
    print(f"[4o] the same in f64: {st64['numsteps']} + "
          f"{st64['numrejected']} steps, {wall64:.3f} s wall; axis "
          f"asymmetry {asym64:.3e} (tol {SHARP3D_SYM_TOL}); f32 vs f64 "
          f"relative L1 {l1:.3e} (tol {SHARP3D_F32_L1_TOL}), max "
          f"{float(np.abs(q - q64).max() / np.abs(q64).max()):.3e}",
          flush=True)
    if not (asym64 <= SHARP3D_SYM_TOL and l1 <= SHARP3D_F32_L1_TOL):
        fail(f"[4o]: f64 axis asymmetry {asym64} or f32 vs f64 L1 {l1}")
    return {"n": n, "tfinal": tfinal, "accepted": ns, "rejected": nr,
            "wall_s_counted": wall, "peak_bytes": peak,
            "launches": ran, "wrapper_counts": counts, "loop": loop,
            "axis_asymmetry_f32": asym, "axis_asymmetry_f64": asym64,
            "f64_steps": [st64["numsteps"], st64["numrejected"]],
            "f64_wall_s": wall64, "f32_vs_f64_l1": l1}


def sharpclaw_routes(dev, n2=1024, n3=128):
    """[4p]: the SharpClaw routes of the 2D and 3D examples besides
    [4o]'s, float32 on the device loop, every launch count set to 0 just
    before each and read just after: acoustics_2d at n2^2 to t=0.12 (the
    SoA route, dq2_weno5's acoustics instance, 10 launches an attempted
    step), shallow_2d_radial at n2^2 to t=1.0 (the generic dq in 2D,
    weno5 20 an attempt; h > 0) and acoustics_3d_heterogeneous at n3^3
    to t=0.8 (the generic dq in 3D with aux and no flux hook, the second
    Riemann solve; weno5 30 an attempt).  The acoustics run's x <-> y
    asymmetry of p is reported, not gated: the float32 SharpClaw run of
    this example is itself 1.2e-2 from the float64 one at 1024^2 (max,
    relative; the plain path on the CPU, tests/test_torch_sharpclaw3d.py
    --roundoff, which is symmetric bit for bit where the kernel's fused
    operations round x and y otherwise)."""
    cases = {
        "acoustics_2d": (lambda: run_acoustics(dev, n2, np.float32,
                                               solver_type="sharpclaw"),
                         "dq2_weno5", 10, (3, n2, n2), 0.12),
        "shallow_2d_radial": (lambda: run_shallow(dev, n2, np.float32,
                                                  solver_type="sharpclaw"),
                              "weno5", 20, (3, n2, n2), 1.0),
        "acoustics_3d_heterogeneous": (
            lambda: run_het(dev, n3, np.float32, solver_type="sharpclaw"),
            "weno5", 30, (4, n3, n3, n3), 0.8)}
    out = {}
    for name, (run, kernel, per, shape, tfinal) in cases.items():
        claw, status, wall, counts, ran = counted_run(run)
        ns, nr = status["numsteps"], status["numrejected"]
        loop = check_path_launches(f"[4p] {name}", claw, status, counts,
                                   kernel, per, ran=ran)
        q = claw.solution.q
        rec = {"accepted": ns, "rejected": nr, "wall_s_counted": wall,
               "launches": ran, "wrapper_counts": counts, "loop": loop}
        if name == "acoustics_2d":
            rec["mirror_asymmetry"] = float(np.abs(q[0] - q[0].T).max()
                                            / np.abs(q[0]).max())
        if name == "shallow_2d_radial":
            rec["min_h"] = float(q[0].min())
        print(f"[4p] sharpclaw {name} {'x'.join(map(str, shape[1:]))} f32 "
              f"to t={claw.solution.t}: {ns} accepted + {nr} rejected steps, "
              f"{ran[kernel]} {kernel} launches the card ran ({per} x "
              f"attempts; {ran}), {wall:.3f} s wall with the device "
              f"counters; device loop {loop}; "
              + ", ".join(f"{k} {v:.3e}" for k, v in rec.items()
                          if k in ("mirror_asymmetry", "min_h")), flush=True)
        if q.shape != shape or not np.all(np.isfinite(q)):
            fail(f"[4p] {name}: result is not finite {shape}")
        if abs(claw.solution.t - tfinal) > 1e-12:
            fail(f"[4p] {name}: ended at t={claw.solution.t}")
        if rec.get("min_h", 1.0) <= 0.0:
            fail(f"[4p] {name}: {rec}")
        out[name] = rec
        del claw
    return out


def sharpclaw3d_card_vs_cpu(dev, n=24):
    """[5s]: SharpClaw Euler 3D (to t=0.1) and heterogeneous acoustics 3D
    (to t=0.2) at n^3 in float64 on the card against the same runs on the
    CPU (the plain path the CPU tests tie to the JAX package): equal
    steps, q to SHARP3D_CARD_CPU_TOL of max|q|."""
    out = {}
    for name, run, tfinal in (
            ("euler_3d", lambda d, t: run_euler3d(d, n, np.float64, t,
                                                  solver_type="sharpclaw"),
             0.1),
            ("acoustics_3d_heterogeneous",
             lambda d, t: run_het(d, n, np.float64, t,
                                  solver_type="sharpclaw"), 0.2)):
        runs = {}
        for where in (dev, "cpu"):
            claw, status, _ = run(where, tfinal)
            runs[str(where)] = (claw.solution.q, status["numsteps"],
                                status["numrejected"], claw.solution.t)
        (q_k, ns_k, nr_k, t_k), (q_c, ns_c, nr_c, t_c) = runs.values()
        rel = float(np.abs(q_k - q_c).max() / np.abs(q_c).max())
        out[name] = {"rel": rel, "steps": [ns_k, nr_k],
                     "cpu_steps": [ns_c, nr_c]}
        print(f"[5s] sharpclaw {name} {n}^3 f64 to t={t_k} card vs cpu: max "
              f"rel {rel:.3e} (tol {SHARP3D_CARD_CPU_TOL}), steps {ns_k} + "
              f"{nr_k} (cpu {ns_c} + {nr_c})", flush=True)
        if (ns_k, nr_k, t_k) != (ns_c, nr_c, t_c) or not (
                rel <= SHARP3D_CARD_CPU_TOL):
            fail(f"[5s] {name}: the card's run differs from the CPU's: "
                 f"{out[name]}")
    return out


def timing_dq_acoustics(dev, n=1024):
    """[6]: the acoustics instance of dq2_weno5, its plain version and its
    bound at n^2 on the example's radial pulse (dt = 0.6 dx / c)."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.sharpclaw import soa as sc_soa
    rp = riemann.acoustics_2D
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc = padded(acoustics_state(n, n), dtype, dev, num_ghost=3)
        h = 2.0 / n
        dt = float(np.dtype(tname).type(0.3 * h))

        def kern():
            return tiled2d.dq_rows(qbc, dt, h, h, ACOUSTICS_PARAMS, rp=rp)

        def plain():
            return sc_soa.dq_2d_soa(qbc, dt, h, h, rp.rpn_soa,
                                    ACOUSTICS_PARAMS, 5, 3,
                                    flux_soa=rp.flux_soa)

        ms = time_ms(kern, 100)
        plain_ms = time_ms(plain, 10, warm=2)
        ms_again = time_ms(kern, 100)
        dev_ms, dev_n = device_ms_per_call(kern, "dq2_weno5_kernel", 20)
        item = qbc.element_size()
        b = bound_of(qbc.numel() * item + 3 * n * n * item,
                     FLOPS_PER_CELL_DQ_ACOUSTICS[tname] * n * n, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, **b}
        print(f"  timing dq acoustics {n}^2 {tname}: kernel {ms:.4f} ms "
              f"(repeat {ms_again:.4f}; on the device {dev_ms} ms, {dev_n} "
              f"launches profiled), plain {plain_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), share "
              f"of bound {b['bound_ms'] / ms:.4f}, library_ms null",
              flush=True)
    return out


def timing_weno5_3d(dev):
    """[6]: weno5 at the SharpClaw 3D path's shape, (5, 198^3) with each
    axis moved last (the path's first state): a wrapper call (CUDA
    events), the kernel's device time (torch.profiler), the plain version
    and the bound (each entry read once, both edge values written once),
    float32 and float64; by axis, and their mean."""
    import torch
    from pyclaw_tpu_torch.limiters import recon
    from pyclaw_tpu_torch.ops import weno
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        q = weno5_3d_inputs(dtype, dev)["first"]
        recs = []
        for axis in range(3):
            qm = q.movedim(1 + axis, -1).contiguous()
            ms = time_ms(lambda: weno.weno5(qm), 20)
            plain_ms = time_ms(lambda: recon.weno5(qm), 3, warm=1)
            dev_ms, dev_n = device_ms_per_call(lambda: weno.weno5(qm),
                                               "weno5_kernel", 10)
            recs.append((ms, plain_ms, dev_ms))
            del qm
        item = q.element_size()
        b = bound_of(3 * q.numel() * item,
                     FLOPS_PER_ENTRY_WENO5[tname] * q.numel(), tname)
        dev_mean = (None if any(r[2] is None for r in recs)
                    else sum(r[2] for r in recs) / 3)
        out[tname] = {"ms": sum(r[0] for r in recs) / 3,
                      "plain_ms": sum(r[1] for r in recs) / 3,
                      "device_ms": dev_mean,
                      "by_axis": [{"ms": r[0], "plain_ms": r[1],
                                   "device_ms": r[2]} for r in recs],
                      "shape": list(q.shape), **b}
        print(f"  timing weno5 (5, {WENO5_3D_N}^3) {tname}: wrapper call by "
              f"axis {[round(r[0], 4) for r in recs]} ms, on the device "
              f"{[r[2] for r in recs]} ms, plain "
              f"{[round(r[1], 3) for r in recs]} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), share "
              f"of the device time "
              f"{None if dev_mean is None else b['bound_ms'] / dev_mean}, "
              f"library_ms null", flush=True)
    return out


# ---- the 2D Euler family off the SoA route and sw_aug_2D: [3l], [3m],
# [4q], [4r], [5x] and their part of [6] -----------------------------------

EULER4, EULER5, SW_AUG = "euler_4wave_2D", "euler_5wave_2D", "sw_aug_2D"
EULER_PARAMS = {"gamma": 1.4}
SW_AUG_PARAMS = {"grav": 9.8, "dry_tolerance": 1e-3}
# [3l]: the grids (1024^2, the host tests' grids, less than a tile and one
# ragged on both axes with more tiles than resident blocks), and the options
# (transverse_waves, order, limiter, index_capa >= 0 for a capacity row,
# fwave): [3d]'s matrix of transverse_waves and order with MC, van Leer
# and id 10 with and without a capacity function, and the f-wave form
# (sw_aug_2D takes f-waves in every case); the large grids take four
NEW_AOS_GRIDS = ((1024, 1024), (60, 60), (100, 37), (64, 100), (7, 5),
                 (600, 700))
NEW_AOS_OPTS = ([(tw, order, 4, -1, False) for tw in (0, 1, 2)
                 for order in (1, 2)]
                + [(2, 2, 4, 0, False), (1, 2, 3, 0, False),
                   (2, 2, 10, -1, True), (2, 2, 4, 0, True)])
NEW_AOS_OPTS_LARGE = [(2, 2, 4, -1, False), (1, 1, 4, -1, False),
                      (2, 2, 4, 0, False), (2, 2, 10, -1, True)]

# Operations per cell of one generic CTU step of the Euler 4-wave system
# (csrc/step2_aos.cu with csrc/euler2d_aos.cuh; order 2, transverse_waves
# 2, MC, no capacity): the same function as step2_ctu.cu's, counted as
# row 1's FLOPS_PER_CELL (each interface quantity once).  The 5-wave
# system adds its tracer's: per interface phi_hat 5 (sqrt(rho) and phi a
# cell: 2 a cell), the tracer parts of three waves 3, the fifth wave 3,
# its fluctuation component (4 waves' terms and the fifth speed's split)
# 16, the limiter of the fifth wave 18 and the tracer component of the
# norms and dot products of three waves 12, the correction flux's tracer
# component 11, the fluctuation to split 2, the splits' tracer lines 8,
# the CFL 2 -> 80; per cell the fold and update of a fifth component 22.
FLOPS_PER_CELL_AOS_EULER4 = FLOPS_PER_CELL
FLOPS_PER_CELL_AOS_EULER5 = FLOPS_PER_CELL + 2 * 80 + 22 + 2
# The sw_aug_2D instance (csrc/sw_aug2d.cuh; order 2, transverse_waves 2,
# minmod, f-waves, no capacity), counted from its own operations in the
# same way, each select one: per interface the normal solve (the wet
# tests and velocities 8, the dry-state machinery of _sw_aug_core 77, the
# shear wave 11, the f-waves and their frontal selects 17, the
# fluctuations with their wall selects 36) 149; the limiter of three
# waves 78; the correction flux 15; the fluctuations to split 6; the
# split's Roe average with its wet selects 29 and two splits of 77 (the
# shallow-water split's 71 and its wet selects) 154; v +- c 2; CFL 3 ->
# 436; two interfaces 872.  The fold and update per cell 78.
FLOPS_PER_CELL_AOS_SW_AUG = 2 * 436 + 78
# The Euler 5-wave instance of csrc/dq2_weno5.cu: FLOPS_PER_CELL_DQ and,
# per direction, WENO5 of the tracer (109 / 98), phi_hat 9, the tracer
# parts of the waves and the fifth wave 6, its fluctuation component 16,
# the CFL 2, its flux and difference 3 and its part of dq 3 (148 / 137);
# the sum of its two parts 1
FLOPS_PER_CELL_DQ_EULER5 = {"float32": 2 * (672 + 148) + 5,
                            "float64": 2 * (624 + 137) + 5}
# [4q]: the classic quadrants off the SoA route against the SoA run.  The
# two plain routes on the CPU at 128^2 to t=0.8 (the same 243 + 1 steps)
# differ by 4.59e-15 (float64, max relative; 1.64e-6 in float32): the
# card's two kernels at 128^2 in float64 are held to 10 times that; at
# 1024^2 in float32 (the slice's run) the relative L1 difference is held
# to SHARP_RUN_TOL's 1e-4, as a whole float32 run on the card is against
# another route elsewhere
ROUTES_CPU_F64_MAX = 4.59e-15
ROUTES_TOL = {"f64_128_max": 10 * ROUTES_CPU_F64_MAX,
              "f32_1024_l1": SHARP_RUN_TOL["t0.8_l1"]}
# [4q]: the tracer's sum to its start (the JAX package's check,
# tests/test_examples_tail.py:88-101); [5x]: the card against the CPU in
# float64
TRACER_TOL = 1e-3
CARD_VS_CPU_TOL = 1e-12
# [5x]: the 2D dry dam break at 40^2 is held card against CPU to t=0.5;
# to t=2.0 (its tfinal) it is reported only: there a one-ulp move of the
# initial state moves the JAX package's own run by 3.0e-2 to 4.8e-2 (max
# relative, five seeds, the CPU, float64) and the port's plain run by
# 2.6e-2 to 6.9e-2, and the two packages' runs differ by 4.5e-2 (134 and
# 129 steps); PyTorch's CPU sqrt in float64 rounds 0.7% of its entries
# one ulp from the correctly rounded value the card and the kernel
# return, so the card and the CPU part in the first steps
DAM2D_CONDITIONED_T = 2.0
# [4r]: the 2D dry dam break at 500^2 to t=0.5 does not keep h >= 0: the
# JAX package's own run of examples/dam_break_dry.py (dimension=2, the
# CPU, float64) reaches min h -1.7372e-3 in its frames, the port's plain
# path on the CPU -2.114e-4 (float32) and -3.340e-4 (float64); at 100^2
# and 200^2 both keep h >= 0 exactly (to t=0.5; to t=2.0 the 40^2 runs
# of both packages reach -1.3e-2).  The card's min h is held to the JAX
# run's; [5x] holds h >= 0 exactly on its 40^2 run to t=0.5
DAM2D_JAX_MIN_H = -1.7372e-3


def euler_state_tracer(rng, nx, ny, pockets=0.0, speed=1.5):
    """A seeded admissible Euler state (5, nx, ny) with velocities of
    ``speed`` times a standard normal (u - a and u + a cross zero) and a
    tracer rho phi, phi in [0, 1) and zero in about half of the cells;
    with ``pockets`` > 0 that share of the cells are low-density pockets
    (rho = p = 0.05, as :func:`random_state`'s)."""
    shape = (nx, ny)
    rho = 0.5 + rng.random(shape)
    u = speed * rng.standard_normal(shape)
    v = speed * rng.standard_normal(shape)
    p = 0.5 + rng.random(shape)
    if pockets > 0.0:
        pocket = rng.random(shape) < pockets
        rho = np.where(pocket, 0.05, rho)
        p = np.where(pocket, 0.05, p)
    phi = rng.random(shape) * (rng.random(shape) < 0.5)
    return np.stack([rho, rho * u, rho * v,
                     p / 0.4 + 0.5 * rho * (u * u + v * v), rho * phi])


def sw_aug_wet_dry_state(rng, nx, ny):
    """A seeded wet/dry state (3, nx, ny) and its bottom (nx, ny) that take
    every branch of the augmented solver: a quarter of the cells dry on a
    bottom above or below the wet neighbours' surface (walls and fronts),
    a tenth damp (below the dry tolerance), the rest wet with velocities
    of either sign."""
    dry = rng.random((nx, ny)) < 0.25
    h = np.where(dry, 0.0, 0.2 + rng.random((nx, ny)))
    h = np.where(rng.random((nx, ny)) < 0.1, 5e-4, h)
    b = np.where(dry, 0.5 + rng.random((nx, ny)), 0.3 * rng.random((nx, ny)))
    q = np.stack([h, h * rng.standard_normal((nx, ny)),
                  h * rng.standard_normal((nx, ny))])
    return q, b


def new_aos_inputs(rng, nx, ny):
    """{system: {state: (q, bottom or None)}} of [3l] at nx x ny."""
    q_bump, aux_bump = radial_bump_state(nx, ny)
    return {
        EULER4: {"quadrants": (quadrants_state(nx, ny), None),
                 "random": (euler_state_tracer(rng, nx, ny)[:4], None)},
        EULER5: {"shock_bubble": (shock_bubble_state(nx, ny), None),
                 "random": (euler_state_tracer(rng, nx, ny), None)},
        SW_AUG: {"wet_dry": sw_aug_wet_dry_state(rng, nx, ny),
                 "radial_bump": (q_bump, aux_bump[0])}}


def plain_step2(qbc, auxbc, dt, dx, dy, rp, params, lims, order, fwave,
                capa, tw):
    """classic/kernels.py:step2 with system rp's AoS hooks and prefactor:
    the plain version of step2_aos."""
    from pyclaw_tpu_torch.classic import kernels
    return kernels.step2(qbc, auxbc, dt, dx, dy, rp.rp, rp.rpt, params, lims,
                         order, fwave, capa, 2, tw, rp.prefactor)


def compare_aos_new(dev, seed=12):
    """[3l]: step2_aos's Euler 4-wave, Euler 5-wave and sw_aug_2D instances
    against the plain version, one step each, over NEW_AOS_GRIDS, two
    states a system, float32 and float64, with a capacity row in aux.
    Returns (worst relative error, worst CFL error, each system's main
    configuration's max abs error (1024^2 f32, its first state, the first
    option), cases)."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import tiled2d
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    worst_cfl = {"float32": 0.0, "float64": 0.0}
    main_abs_err = {}
    ncase = 0
    for nx, ny in NEW_AOS_GRIDS:
        opts = NEW_AOS_OPTS_LARGE if nx * ny > 2e5 else NEW_AOS_OPTS
        kappa = 0.7 + 0.6 * rng.random((nx, ny))
        dx, dy = 1.0 / nx, 1.0 / ny
        for name, inputs in new_aos_inputs(rng, nx, ny).items():
            rp = riemann.ALL[name]
            params = SW_AUG_PARAMS if name == SW_AUG else EULER_PARAMS
            for iname, (q_np, b_np) in inputs.items():
                rows = ([] if b_np is None else [b_np]) + [kappa]
                capa_row = len(rows) - 1
                for tname, dtype in (("float32", torch.float32),
                                     ("float64", torch.float64)):
                    qbc = padded(q_np, dtype, dev)
                    auxbc = padded(np.stack(rows), dtype, dev)
                    dt = float(np.dtype(tname).type(0.05 * min(dx, dy)))
                    for tw, order, lim, capa, fwave in opts:
                        capa = capa_row if capa >= 0 else -1
                        fwave = fwave or name == SW_AUG
                        lims = (lim,) * rp.num_waves
                        args = (qbc, auxbc, dt, dx, dy, rp, params, lims,
                                order, fwave, capa)
                        qk, ck = tiled2d.step2_rows_generic(*args, 2, tw)
                        qp, cp = plain_step2(*args, tw)
                        torch.cuda.synchronize()
                        abs_err = float((qk - qp).abs().max())
                        rel = abs_err / float(qp.abs().max())
                        dcfl = abs(float(ck) - float(cp)) / float(cp)
                        if not (np.isfinite(rel) and rel <= TOL_REL[tname]
                                and dcfl <= TOL_REL[tname]
                                and tuple(qk.shape) == (rp.num_eqn, nx, ny)):
                            fail(f"[3l] step2_aos vs plain {nx}x{ny} {name} "
                                 f"{iname} {tname} tw={tw} order={order} "
                                 f"lim={lim} capa={capa} fwave={fwave}: rel "
                                 f"err {rel:.3e}, cfl {float(ck)!r} vs "
                                 f"{float(cp)!r}")
                        worst[tname] = max(worst[tname], rel)
                        worst_cfl[tname] = max(worst_cfl[tname], dcfl)
                        if ((nx, tname, (tw, order, lim)) == (1024, "float32",
                                                               (2, 2, 4))
                                and capa < 0 and name not in main_abs_err):
                            main_abs_err[name] = abs_err
                        ncase += 1
                        del qk, qp
        print(f"  [3l] step2_aos Euler 4/5-wave, sw_aug_2D {nx}x{ny}: max "
              f"rel err f32 {worst['float32']:.3e} f64 "
              f"{worst['float64']:.3e}; max cfl rel f32 "
              f"{worst_cfl['float32']:.3e} f64 {worst_cfl['float64']:.3e}",
              flush=True)
    return worst, worst_cfl, main_abs_err, ncase


def compare_dq_euler5(dev, grids, seed=13):
    """[3m]: dq2_weno5's Euler 5-wave instance against its plain version
    (sharpclaw/soa.py:dq_2d_soa with euler_5wave_2D's SoA hooks), one dq
    each, over [3b]'s grids and kinds of state, each with a tracer: the
    shock-bubble state, a seeded random admissible state and one with
    low-density pockets (the positivity fallback; float32 held to
    ULP_FACTOR times the plain version's own change under a one-ulp move
    of its input where larger, as [3b])."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.sharpclaw import soa as sc_soa
    rp = riemann.euler_5wave_2D
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    main_abs_err = None
    ncase = 0
    for nx, ny in grids:
        # pockets in a twentieth of the cells, a quarter on a grid of less
        # than a tile (a twentieth of 35 cells may leave none inside)
        pockets = 0.05 if nx * ny > 256 else 0.25
        inputs = {"shock_bubble": shock_bubble_state(nx, ny),
                  "random": euler_state_tracer(rng, nx, ny, speed=0.5),
                  "fallback": euler_state_tracer(rng, nx, ny,
                                                 pockets=pockets, speed=0.5)}
        dx, dy = 1.0 / nx, 1.0 / ny
        for iname, q_np in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                qbc = padded(q_np, dtype, dev, num_ghost=3)
                dt = float(np.dtype(tname).type(0.3 / max(nx, ny)))
                dk, ck = tiled2d.dq_rows(qbc, dt, dx, dy, EULER_PARAMS,
                                         rp=rp)

                def plain(qin):
                    return sc_soa.dq_2d_soa(
                        qin, dt, dx, dy, rp.rpn_soa, EULER_PARAMS, 5, 3,
                        positivity=rp.positivity, flux_soa=rp.flux_soa)
                dp, cp = plain(qbc)
                torch.cuda.synchronize()
                abs_err = float((dk - dp).abs().max())
                rel = abs_err / float(dp.abs().max())
                dcfl = abs(float(ck) - float(cp))
                tol, nfall, sens = TOL_REL[tname], 0, None
                if iname == "fallback":
                    nfall = sc_soa.fallback_count(qbc, EULER_PARAMS,
                                                  rp.positivity)
                    r = torch.as_tensor(rng.uniform(-1.0, 1.0, qbc.shape),
                                        dtype=dtype, device=dev)
                    dpp, _ = plain(qbc * (1.0 + torch.finfo(dtype).eps * r))
                    sens = float((dpp - dp).abs().max() / dp.abs().max())
                    if tname == "float32":
                        tol = max(tol, ULP_FACTOR * sens)
                    if nfall == 0:
                        fail(f"[3m] dq {nx}x{ny} fallback state: no cell "
                             f"fell back")
                if not (np.isfinite(rel) and rel <= tol
                        and dcfl <= TOL_REL[tname] * float(cp)
                        and dk.shape == (5, nx, ny)):
                    fail(f"[3m] dq2_weno5 euler5 vs plain {nx}x{ny} {iname} "
                         f"{tname}: rel err {rel:.3e} (tol {tol:.3e}), cfl "
                         f"{float(ck)!r} vs {float(cp)!r}")
                worst[tname] = max(worst[tname], rel)
                if (nx, ny, iname, tname) == (1024, 1024, "shock_bubble",
                                              "float32"):
                    main_abs_err = abs_err
                ncase += 1
                print(f"  [3m] dq2_weno5 euler5 {nx}x{ny} {iname:12s} "
                      f"{tname}: rel err {rel:.3e} (tol {tol:.1e}), |dcfl| "
                      f"{dcfl:.3e}"
                      + (f"; {nfall} cells fell back, one-ulp input change "
                         f"moves the plain version by {sens:.3e}"
                         if nfall else ""), flush=True)
    return worst, main_abs_err, ncase


def run_example(dev, module, dtype, tfinal, tweak=None, keep_copy=False,
                **kw):
    """pyclaw_tpu_torch.examples.<module> through Controller.run() to
    ``tfinal`` (None: the example's) (``kw``: its setup keywords;
    ``tweak(claw)`` before the run); returns (claw, status, wall
    seconds)."""
    import importlib
    import torch
    ex = importlib.import_module(f"pyclaw_tpu_torch.examples.{module}")
    claw = ex.setup(outdir=None, device=dev, dtype=dtype, **kw)
    if tfinal is not None:
        claw.tfinal = tfinal
    claw.keep_copy = keep_copy
    if tweak is not None:
        tweak(claw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def euler_checks(label, q, tracer0=None):
    """rho > 0 and p > 0 in every cell of an Euler state q, and the
    tracer's sum within TRACER_TOL of ``tracer0``; returns (min rho, min p,
    the tracer's relative change)."""
    rho = q[0].astype(np.float64)
    p = 0.4 * (q[3] - 0.5 * (q[1].astype(np.float64) ** 2 + q[2] ** 2)
               / rho)
    change = (None if tracer0 is None
              else abs(float(np.sum(q[4], dtype=np.float64)) - tracer0)
              / tracer0)
    if not (np.all(np.isfinite(q)) and rho.min() > 0.0 and p.min() > 0.0
            and (change is None or change <= TRACER_TOL)):
        fail(f"{label}: min rho {rho.min()}, min p {p.min()}, tracer "
             f"change {change}")
    return float(rho.min()), float(p.min()), change


def shock_bubble_path(dev, n=(2048, 512), n_sharp=(1024, 256)):
    """[4q]: the slice's path, examples.shock_bubble (euler_5wave_2D, MC)
    classic at 2048x512 f32 to t=0.6 on the device loop (step2_aos's Euler
    5-wave instance, 1 launch an attempted step; restore 1), and
    SharpClaw at 1024x256 f32 to t=0.6 (dq2_weno5's Euler 5-wave instance,
    10 an attempt), every launch count set to 0 just before each and read
    just after: the steps, the wall and the peak memory; rho > 0, p > 0 and
    the tracer's sum kept."""
    import torch
    out = {}
    for solver_type, (mx, my), kernel, per in (
            ("classic", n, "step2_aos", 1),
            ("sharpclaw", n_sharp, "dq2_weno5", 10)):
        tracer0 = float(np.sum(shock_bubble_state(mx, my)[4],
                               dtype=np.float64))
        torch.cuda.reset_peak_memory_stats(dev)
        claw, status, wall, counts, ran = counted_run(
            lambda: run_example(dev, "shock_bubble", np.float32, 0.6,
                                mx=mx, my=my, solver_type=solver_type))
        peak = torch.cuda.max_memory_allocated(dev)
        ns, nr = status["numsteps"], status["numrejected"]
        loop = check_path_launches(f"[4q] shock_bubble {solver_type}", claw,
                                   status, counts, kernel, per, ran=ran)
        q = claw.solution.q
        if q.shape != (5, mx, my) or abs(claw.solution.t - 0.6) > 1e-12:
            fail(f"[4q] shock_bubble {solver_type}: shape {q.shape}, t "
                 f"{claw.solution.t}")
        rho_min, p_min, tracer = euler_checks(
            f"[4q] shock_bubble {solver_type}", q, tracer0)
        rec = {"shape": [5, mx, my], "accepted": ns, "rejected": nr,
               "wall_s_counted": wall, "launches": ran,
               "wrapper_counts": counts, "loop": loop,
               "peak_memory_bytes": int(peak), "min_rho": rho_min,
               "min_p": p_min, "tracer_change": tracer,
               "cell_updates_per_s": ns * mx * my / wall}
        out[solver_type] = rec
        print(f"[4q] shock_bubble {solver_type} {mx}x{my} f32 to "
              f"t={claw.solution.t}: {ns} accepted + {nr} rejected steps, "
              f"{ran[kernel]} {kernel} launches the card ran ({per} x "
              f"attempts; {ran}; the wrappers' counts {counts}), "
              f"{wall:.3f} s wall with the device counters, peak memory "
              f"{peak / 2 ** 20:.1f} MiB; device loop {loop}; min rho "
              f"{rho_min:.4e}, min p {p_min:.4e}, tracer sum change "
              f"{tracer:.3e} (tol {TRACER_TOL})", flush=True)
        del claw
    return out


def quadrants_routes(dev, q_soa, steps_soa, n=1024):
    """[4q]: the classic quadrants off the SoA route (use_soa=False: the
    generic step, step2_aos's Euler 4-wave instance, 1 launch an attempted
    step) at n^2 f32 to t=0.8 beside [4]'s SoA run (step2_ctu): the steps,
    the max and relative L1 difference (gated at ROUTES_TOL); then both
    routes at 128^2 in float64 on the card (gated at 10 times the CPU's
    two plain routes' difference)."""
    def off_soa(claw):
        claw.solver.use_soa = False
    claw, status, wall, counts, ran = counted_run(
        lambda: run_example(dev, "euler_2d_quadrants", np.float32, 0.8,
                            tweak=off_soa, mx=n, my=n))
    loop = check_path_launches("[4q] quadrants off the SoA route", claw,
                               status, counts, "step2_aos", 1, ran=ran)
    q = claw.solution.q.astype(np.float64)
    q_soa = q_soa.astype(np.float64)
    rec = {"accepted": status["numsteps"], "rejected": status["numrejected"],
           "steps_soa": list(steps_soa), "wall_s_counted": wall,
           "launches": ran, "wrapper_counts": counts, "loop": loop,
           "f32_max_rel": float(np.abs(q - q_soa).max()
                                / np.abs(q_soa).max()),
           "f32_l1_rel": float(np.abs(q - q_soa).mean()
                               / np.abs(q_soa).mean())}
    del claw
    runs = {}
    for soa in (True, False):
        def route(claw, soa=soa):
            claw.solver.use_soa = soa
        c, st, _ = run_example(dev, "euler_2d_quadrants", np.float64, 0.8,
                               tweak=route, mx=128, my=128)
        runs[soa] = (c.solution.q, (st["numsteps"], st["numrejected"]))
    rec["f64_128_max_rel"] = float(np.abs(runs[False][0] - runs[True][0])
                                   .max() / np.abs(runs[True][0]).max())
    rec["f64_128_steps"] = [runs[True][1], runs[False][1]]
    rec["tol"] = ROUTES_TOL
    print(f"[4q] quadrants {n}^2 f32 to t=0.8 off the SoA route: "
          f"{rec['accepted']} accepted + {rec['rejected']} rejected steps "
          f"(the SoA run {steps_soa}), {ran['step2_aos']} step2_aos "
          f"launches the card ran ({ran}), {wall:.3f} s wall; against the "
          f"SoA run: max rel {rec['f32_max_rel']:.3e}, rel L1 "
          f"{rec['f32_l1_rel']:.3e} (tol {ROUTES_TOL['f32_1024_l1']}); "
          f"128^2 f64 the two kernels: max rel {rec['f64_128_max_rel']:.3e} "
          f"(tol {ROUTES_TOL['f64_128_max']:.3e}), steps "
          f"{rec['f64_128_steps']}", flush=True)
    if not (np.all(np.isfinite(q))
            and rec["f32_l1_rel"] <= ROUTES_TOL["f32_1024_l1"]
            and rec["f64_128_max_rel"] <= ROUTES_TOL["f64_128_max"]
            and runs[True][1] == runs[False][1]):
        fail(f"[4q] quadrants off the SoA route: {rec}")
    return rec


def sw_aug_paths(dev, n=1024, n_dam=500):
    """[4r]: sw_aug_2D on the card, float32 unless named, every launch
    count set to 0 just before each run and read just after (step2_aos's
    sw_aug instance, 1 launch an attempted step): radial_bump_bathymetry
    at n^2 to t=0.3 (h > 0, the y -> -y mirror symmetry of h); the lake at
    rest over its bump at n^2 to t=0.05 in float32 and float64 (machine-
    still: LAKE_TOL in float32, 1e-12 in float64); dam_break_dry with
    dimension=2 at n_dam^2 to t=0.5 (the mass kept to DAM_MASS_TOL, the
    least h over the frames no lower than the JAX package's own run's,
    DAM2D_JAX_MIN_H; h >= 0 is reported)."""
    out = {}
    claw, status, wall, counts, ran = counted_run(
        lambda: run_example(dev, "radial_bump_bathymetry", np.float32, 0.3,
                            mx=n, my=n))
    loop = check_path_launches("[4r] radial_bump_bathymetry", claw, status,
                               counts, "step2_aos", 1, ran=ran)
    q = claw.solution.q
    mirror = float(np.abs(q[0] - q[0][:, ::-1]).max() / np.abs(q[0]).max())
    rec = {"accepted": status["numsteps"], "rejected": status["numrejected"],
           "wall_s_counted": wall, "launches": ran, "loop": loop,
           "min_h": float(q[0].min()), "mirror_asymmetry": mirror}
    print(f"[4r] radial_bump_bathymetry {n}^2 f32 to t={claw.solution.t}: "
          f"{rec['accepted']} accepted + {rec['rejected']} rejected steps, "
          f"{ran['step2_aos']} step2_aos launches the card ran ({ran}), "
          f"{wall:.3f} s wall; min h {rec['min_h']:.4e}, max |h(x,y) - "
          f"h(x,-y)| / max h {mirror:.3e}", flush=True)
    if not (q.shape == (3, n, n) and np.all(np.isfinite(q))
            and rec["min_h"] > 0.0 and mirror <= 1e-4
            and abs(claw.solution.t - 0.3) <= 1e-12):
        fail(f"[4r] radial_bump_bathymetry: {rec}")
    out["radial_bump"] = rec
    del claw
    for tname, dtype, tol in (("float32", np.float32, LAKE_TOL),
                              ("float64", np.float64, 1e-12)):
        claw, status, wall, counts, ran = counted_run(
            lambda: run_example(dev, "radial_bump_bathymetry", dtype, 0.05,
                                mx=n, my=n, perturb=0.0))
        loop = check_path_launches(f"[4r] lake at rest {tname}", claw,
                                   status, counts, "step2_aos", 1, ran=ran)
        q, b = claw.solution.q, claw.solution.aux[0]
        drift = float(np.abs(q[0].astype(np.float64) + b - 1.0).max())
        mom = float(np.abs(q[1:]).max())
        out[f"lake_{tname}"] = {"attempts": loop["attempts"],
                                "eta_drift": drift, "momentum": mom,
                                "launches": ran}
        print(f"[4r] sw_aug lake at rest {n}^2 {tname} to t=0.05: "
              f"{loop['attempts']} attempted steps, {ran['step2_aos']} "
              f"step2_aos launches the card ran; max |eta - 1| {drift:.3e}, "
              f"max |hu|, |hv| {mom:.3e} (tol {tol})", flush=True)
        if not (drift <= tol and mom <= tol):
            fail(f"[4r] lake at rest {tname}: {out[f'lake_{tname}']}")
        del claw
    claw, status, wall, counts, ran = counted_run(
        lambda: run_example(dev, "dam_break_dry", np.float32, 0.5,
                            keep_copy=True, nx=n_dam, dimension=2))
    loop = check_path_launches("[4r] dam_break_dry 2D", claw, status,
                               counts, "step2_aos", 1, ran=ran)
    frames = claw.frames
    mass0 = float(np.sum(frames[0].q[0], dtype=np.float64))
    hmin = min(float(f.q[0].min()) for f in frames)
    mass = max(abs(float(np.sum(f.q[0], dtype=np.float64)) - mass0) / mass0
               for f in frames)
    rec = {"accepted": status["numsteps"], "rejected": status["numrejected"],
           "wall_s_counted": wall, "launches": ran, "loop": loop,
           "frames": [f.t for f in frames], "h_min": hmin,
           "mass_change": mass}
    print(f"[4r] dam_break_dry dimension=2 {n_dam}^2 f32 to "
          f"t={claw.solution.t}: {rec['accepted']} accepted + "
          f"{rec['rejected']} rejected steps, {ran['step2_aos']} step2_aos "
          f"launches the card ran ({ran}), {wall:.3f} s wall; min h over "
          f"the frames {hmin!r} (h >= 0: {hmin >= 0.0}; the JAX package's "
          f"own run {DAM2D_JAX_MIN_H}), mass change {mass:.3e} (tol "
          f"{DAM_MASS_TOL['float32']})", flush=True)
    if not (np.all(np.isfinite(claw.solution.q))
            and hmin >= DAM2D_JAX_MIN_H
            and mass <= DAM_MASS_TOL["float32"]
            and abs(claw.solution.t - 0.5) <= 1e-12):
        fail(f"[4r] dam_break_dry 2D: {rec}")
    out["dam_break_dry_2d"] = rec
    return out


def card_vs_cpu_new(dev):
    """[5x]: the card against the CPU's plain path in float64 (equal steps,
    q to CARD_VS_CPU_TOL of max|q|): shock_bubble at 80x20 to t=0.1,
    classic and SharpClaw, and dam_break_dry with dimension=2 at 40^2 to
    t=0.5 (h >= 0 exactly in the card's final state); the dam break to
    t=2.0 is reported, not held (DAM2D_CONDITIONED_T)."""
    out = {}
    for label, module, tfinal, kw in (
            ("shock_bubble classic", "shock_bubble", 0.1,
             dict(mx=80, my=20)),
            ("shock_bubble sharpclaw", "shock_bubble", 0.1,
             dict(mx=80, my=20, solver_type="sharpclaw")),
            ("dam_break_dry 2D", "dam_break_dry", 0.5,
             dict(nx=40, dimension=2)),
            ("dam_break_dry 2D (conditioned)", "dam_break_dry",
             DAM2D_CONDITIONED_T, dict(nx=40, dimension=2))):
        runs = {}
        for where in (dev, "cpu"):
            c, st, w = run_example(where, module, np.float64, tfinal, **kw)
            runs[str(where)] = (c.solution.q, (st["numsteps"],
                                               st["numrejected"]), w)
        (q_k, s_k, w_k), (q_c, s_c, w_c) = runs[str(dev)], runs["cpu"]
        rel = float(np.abs(q_k - q_c).max() / np.abs(q_c).max())
        out[label] = {"max_rel": rel, "steps_card": s_k, "steps_cpu": s_c,
                      "wall_card_s": w_k, "wall_cpu_s": w_c}
        print(f"[5x] {label} f64 to t={tfinal} card vs cpu: max rel "
              f"{rel:.3e} (tol {CARD_VS_CPU_TOL}), steps card {s_k}, cpu "
              f"{s_c}; wall card {w_k:.3f} s, cpu {w_c:.3f} s", flush=True)
        if module == "dam_break_dry":
            out[label]["min_h"] = float(q_k[0].min())
            out[label]["min_h_cpu"] = float(q_c[0].min())
        if tfinal == DAM2D_CONDITIONED_T:
            print(f"    (reported, not held: the run is ill-conditioned; min h "
                  f"card {out[label]['min_h']:.4e}, cpu "
                  f"{out[label]['min_h_cpu']:.4e})", flush=True)
            continue
        if not (s_k == s_c and rel <= CARD_VS_CPU_TOL
                and out[label].get("min_h", 0.0) >= 0.0):
            fail(f"[5x] {label}: {out[label]}")
    return out


def timing_dq_euler5(dev, n=1024):
    """[6]: the Euler 5-wave instance of dq2_weno5, its plain version and
    its bound on the shock-bubble state at 2n x n/2 (the cells of n^2;
    ops/time_kernels.py:dq_euler5_case)."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.sharpclaw import soa as sc_soa
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc, args, rp = dq_euler5_case(n, dtype, dev)
        dt, h, _, params = args

        def kern():
            return tiled2d.dq_rows(qbc, *args, rp=rp)

        def plain():
            return sc_soa.dq_2d_soa(qbc, dt, h, h, rp.rpn_soa, params, 5, 3,
                                    positivity=rp.positivity,
                                    flux_soa=rp.flux_soa)

        ms = time_ms(kern, 100)
        plain_ms = time_ms(plain, 10, warm=2)
        ms_again = time_ms(kern, 100)
        dev_ms, dev_n = device_ms_per_call(kern, "dq2_weno5_kernel", 20)
        item = qbc.element_size()
        cells = (qbc.shape[1] - 6) * (qbc.shape[2] - 6)
        b = bound_of(qbc.numel() * item + 5 * cells * item,
                     FLOPS_PER_CELL_DQ_EULER5[tname] * cells, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, "shape": list(qbc.shape), **b}
        print(f"  timing dq euler5 {tuple(qbc.shape)} {tname}: kernel "
              f"{ms:.4f} ms (repeat {ms_again:.4f}; on the device {dev_ms} "
              f"ms, {dev_n} launches profiled), plain {plain_ms:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), share "
              f"of bound {b['bound_ms'] / ms:.4f}, library_ms null",
              flush=True)
    return out


# ---- the scalar and variable-coefficient systems: [3n], [3o], [4s]-[4v],
# [5y] and their timings in [6] ---------------------------------------------

# the six step2_aos instances of this slice, in the order of
# ops/time_kernels.py:SCALAR_CASES (each timed on its run's first input)
SCALAR_2D = tuple(SCALAR_CASES)
# each system's problem_data in [3n] (Burgers takes its efix per option)
SCALAR_PARAMS = {"advection_2D": {"u": 0.7, "v": -0.4}}
# [3n]: the path's grid, one less than a tile and one ragged on both axes
# with more tiles than resident blocks; (transverse_waves, order, limiter,
# index_capa, fwave): every transverse_waves and order, MC, minmod and the
# CFL-dependent id 10, a capacity row (aux's last), the f-wave form
# (vc_advection_fwave_2D always); Burgers without the entropy fix on the
# second option
SCALAR_GRIDS = ((1024, 1024), (7, 5), (600, 700))
SCALAR_OPTS = [(2, 2, 4, -1, False), (1, 2, 1, 0, False),
               (0, 1, 4, -1, False), (2, 2, 10, 0, True),
               (0, 2, 10, 0, False), (1, 1, 1, -1, False)]
SCALAR_OPTS_LARGE = [(2, 2, 4, -1, False), (1, 2, 1, 0, False),
                     (0, 1, 10, 0, True)]
# [3o]: burgers_3D's grids (the path's, a ragged one of several tiles and
# one less than a tile); its options (transverse_waves, order, limiter,
# index_capa, fwave, efix) are ops/time_kernels.py:BURGERS3D_OPTS, which
# times each of them too
BURGERS3D_GRIDS = ((192, 192, 192), (17, 13, 9), (3, 5, 2))
BURGERS3D_OPTS_LARGE = BURGERS3D_OPTS[:2]
# Operations per cell of one generic CTU step of each scalar instance of
# csrc/step2_aos.cu (csrc/scalar2d.cuh; order 2, the run's limiter and
# transverse_waves), counted in the same way as FLOPS_PER_CELL_AOS, each
# interface quantity counted once, a sin or cos as one operation.  Per
# interface: the normal solve (advection 5: the jump, min, max and two
# products; kpp 11 and its per-cell sin and cos 2 a cell; Burgers 9 on
# its common branch: the jump, the average speed 2, the split 4, the
# transonic test 2; the f-wave form 7: the flux jump 3, the speed 2, two
# selects); the limiter of the one wave (norm 1, dot product 1, theta 1,
# the limiter 3-8, nu 2, select 1, the coefficient 4: 16 with MC, 13 with
# minmod, 14 with van Leer); the correction flux 1; with transverse waves
# the fluctuations to split 2 and two splits of 4 (kpp: the average state
# and its cos or sin 3 more); CFL 2.  The fold and update per cell 26
# (the shallow-water 78 over three equations); a capacity row adds 4 a
# cell and 2 an interface.  Each moves 8 B a cell in float32 (q read and
# written), 16 B with two aux rows: 4-14 operations per byte, below the
# card's 20 (and 10 in float64): bytes bound every one of them.  The
# heterogeneous acoustics instance: the constant-coefficient count
# FLOPS_PER_CELL_AOS_ACOUSTICS with its one-sided impedances (the normal
# solve's denominator 1 more, each split's 2 more: 6 an interface).
FLOPS_PER_CELL_SCALAR = {
    "advection_2D": 2 * (5 + 14 + 1 + 2 + 8 + 2) + 26,
    "vc_advection_2D": 2 * (5 + 14 + 1 + 2) + 26,       # transverse_waves 0
    "vc_advection_fwave_2D": 2 * (7 + 16 + 1 + 2 + 8 + 2 + 2) + 26 + 4,
    "vc_acoustics_2D": FLOPS_PER_CELL_AOS_ACOUSTICS + 2 * 6,
    "kpp_2D": 2 * (11 + 13 + 1 + 2 + 8 + 3 + 2) + 26 + 2,
    "burgers_2D": 2 * (9 + 16 + 1 + 2 + 8 + 2) + 26}
# [4s]-[4v]: the runs' bounds on q, where the scheme keeps one: kpp
# (minmod) and the swirl (van Leer, donor-cell corners) stay within their
# initial range to this (absolute)
SCALAR_RANGE_TOL = 1e-3
# [4u], [4v]: the runs conserve their (capacity-weighted) mass to this
# (relative; no flux crosses the boundary: periodic, or velocities that
# vanish there): float64 to 1e-12; float32 to 1e-4, since each update
# rounds, and the swirl's many small ones against q near 1 drift with the
# steps (the plain version on the CPU: 6.3e-7 at 256^2, 3.0e-6 at 512^2
# to t=2.0, float64 1.6e-15); the float64 Burgers runs keep their
# diagonal (2D) and x <-> y (3D) symmetry to 1e-10 (absolute, q in [0, 1];
# the plain version at 48^2: 1e-11, tests/test_2d_examples.py); the
# interface run's float32 p keeps its y -> -y mirror symmetry to 1e-4
# (relative, as [4r]'s radial bump)
SCALAR_MASS_TOL = {"float32": 1e-4, "float64": 1e-12}
SCALAR_SYM_TOL = 1e-10
SCALAR_MIRROR_TOL = 1e-4


def scalar_random_state(rng, name, nx, ny):
    """A seeded (q, aux of the system's two aux rows or None) of system
    ``name`` at nx x ny: states of either sign (Burgers: transonic
    interfaces; kpp around its initial 14 pi / 4 and pi / 4); the
    advection velocities of either sign, positive (Z, c) for acoustics,
    each jumping across rows and columns 12 | 13 and 15 | 16 (the tiles'
    edges of both types) and random elsewhere."""
    rp_neq = {"vc_acoustics_2D": 3}.get(name, 1)
    if name == "kpp_2D":
        q = (np.where(rng.random((1, nx, ny)) < 0.5, 14.0 * np.pi / 4.0,
                      np.pi / 4.0) + 0.3 * rng.standard_normal((1, nx, ny)))
    else:
        q = rng.standard_normal((rp_neq, nx, ny))
    if name in ("advection_2D", "kpp_2D", "burgers_2D"):
        return q, None
    if name == "vc_acoustics_2D":
        aux = 1.0 + 0.5 * rng.random((2, nx, ny))
    else:
        aux = rng.standard_normal((2, nx, ny))
    aux[:, 12:] *= 2.5
    aux[:, 13:] *= 0.5
    aux[:, :, 15:] *= 3.0
    aux[:, :, 16:] *= 0.4
    return q, aux


def scalar_path_state(name, nx, ny):
    """(q, the system's two aux rows or None) of the run of system
    ``name`` at nx x ny: its example's or run's initial state
    (ops/time_kernels.py:SCALAR_CASES)."""
    if name == "kpp_2D":
        return example_state("kpp", nx, ny)
    if name == "vc_acoustics_2D":
        return example_state("acoustics_2d_interface", nx, ny)
    if name == "vc_advection_2D":
        return example_state("advection_2d", nx, ny)
    if name == "burgers_2D":
        return gaussian_state((nx, ny)), None
    q = example_state("advection_2d", nx, ny)[0]
    if name == "advection_2D":
        return q, None
    return q, swirl_cell_velocities(nx, ny)


def compare_scalar(dev, seed=14):
    """[3n]: step2_aos's six scalar and variable-coefficient instances
    against the plain version, one step each, over SCALAR_GRIDS, the run's
    first state and a seeded random one a system, float32 and float64, a
    capacity row in aux (its last).  Returns (worst relative error, worst
    CFL error, each system's main configuration's max abs error (1024^2
    f32, the run's state, the first option), cases)."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import tiled2d
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    worst_cfl = {"float32": 0.0, "float64": 0.0}
    main_abs_err = {}
    ncase = 0
    for nx, ny in SCALAR_GRIDS:
        opts = SCALAR_OPTS_LARGE if nx * ny > 2e5 else SCALAR_OPTS
        kappa = 0.7 + 0.6 * rng.random((nx, ny))
        dx, dy = 1.0 / nx, 1.0 / ny
        for name in SCALAR_2D:
            rp = riemann.ALL[name]
            inputs = {"path": scalar_path_state(name, nx, ny),
                      "random": scalar_random_state(rng, name, nx, ny)}
            for iname, (q_np, a_np) in inputs.items():
                rows = ([] if a_np is None else list(a_np[:2])) + [kappa]
                capa_row = len(rows) - 1
                for tname, dtype in (("float32", torch.float32),
                                     ("float64", torch.float64)):
                    qbc = padded(q_np, dtype, dev)
                    auxbc = padded(np.stack(rows), dtype, dev)
                    dt = float(np.dtype(tname).type(0.05 * min(dx, dy)))
                    for k, (tw, order, lim, capa, fwave) in enumerate(opts):
                        capa = capa_row if capa >= 0 else -1
                        fwave = fwave or name == "vc_advection_fwave_2D"
                        params = dict(SCALAR_PARAMS.get(name, {}),
                                      efix=k != 1)
                        args = (qbc, auxbc, dt, dx, dy, rp, params,
                                (lim,) * rp.num_waves, order, fwave, capa)
                        qk, ck = tiled2d.step2_rows_generic(*args, 2, tw)
                        qp, cp = plain_step2(*args, tw)
                        torch.cuda.synchronize()
                        abs_err = float((qk - qp).abs().max())
                        rel = abs_err / max(float(qp.abs().max()), 1e-300)
                        dcfl = abs(float(ck) - float(cp)) / float(cp)
                        if not (np.isfinite(rel) and rel <= TOL_REL[tname]
                                and dcfl <= TOL_REL[tname]
                                and tuple(qk.shape) == (rp.num_eqn, nx, ny)):
                            fail(f"[3n] step2_aos vs plain {nx}x{ny} {name} "
                                 f"{iname} {tname} tw={tw} order={order} "
                                 f"lim={lim} capa={capa} fwave={fwave}: rel "
                                 f"err {rel:.3e}, cfl {float(ck)!r} vs "
                                 f"{float(cp)!r}")
                        worst[tname] = max(worst[tname], rel)
                        worst_cfl[tname] = max(worst_cfl[tname], dcfl)
                        if ((nx, tname, iname, k) == (1024, "float32",
                                                      "path", 0)):
                            main_abs_err[name] = abs_err
                        ncase += 1
                        del qk, qp
        print(f"  [3n] step2_aos scalar instances {nx}x{ny}: max rel err "
              f"f32 {worst['float32']:.3e} f64 {worst['float64']:.3e}; max "
              f"cfl rel f32 {worst_cfl['float32']:.3e} f64 "
              f"{worst_cfl['float64']:.3e}", flush=True)
    return worst, worst_cfl, main_abs_err, ncase


def compare_burgers3d(dev, seed=15):
    """[3o]: step3_aos's burgers_3D instance against the plain version, one
    step each, over BURGERS3D_GRIDS, the Burgers 3D run's first state (the
    pulse) and a seeded random one of either sign (transonic interfaces),
    float32 and float64, a capacity row in aux.  Returns (worst relative
    error, worst CFL error, the max abs error at 192^3 f32 on the pulse
    with the first option, cases)."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import tiled2d
    rp = riemann.burgers_3D
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    worst_cfl = {"float32": 0.0, "float64": 0.0}
    main_abs_err = None
    ncase = 0
    for shape in BURGERS3D_GRIDS:
        opts = BURGERS3D_OPTS_LARGE if shape[0] > 100 else BURGERS3D_OPTS
        kappa = 0.7 + 0.6 * rng.random((1,) + shape)
        d = tuple(1.0 / n for n in shape)
        inputs = {"path": gaussian_state(shape),
                  "random": rng.standard_normal((1,) + shape)}
        for iname, q_np in inputs.items():
            for tname, dtype in (("float32", torch.float32),
                                 ("float64", torch.float64)):
                qbc = padded3(q_np, dtype, dev).contiguous()
                auxbc = padded3_aux(kappa, dtype, dev).contiguous()
                dt = float(np.dtype(tname).type(0.05 * min(d)))
                for k, (tw, order, lim, capa, fwave, efix) in enumerate(opts):
                    args = (qbc, auxbc, dt, *d, rp, {"efix": efix}, (lim,),
                            order, fwave, capa)
                    qk, ck = tiled2d.step3_xy_generic(*args, 2, tw)
                    qp, cp = plain_step3_aos(qbc, auxbc, dt, d, rp.name,
                                             (lim,), order, fwave, capa, tw,
                                             params={"efix": efix})
                    torch.cuda.synchronize()
                    abs_err = float((qk - qp).abs().max())
                    rel = abs_err / float(qp.abs().max())
                    dcfl = abs(float(ck) - float(cp)) / float(cp)
                    if not (np.isfinite(rel) and rel <= TOL_REL[tname]
                            and dcfl <= TOL_REL[tname]
                            and tuple(qk.shape) == (1,) + shape):
                        fail(f"[3o] step3_aos burgers_3D vs plain {shape} "
                             f"{iname} {tname} tw={tw} order={order} "
                             f"lim={lim} capa={capa} fwave={fwave} efix="
                             f"{efix}: rel err {rel:.3e}, cfl {float(ck)!r} "
                             f"vs {float(cp)!r}")
                    worst[tname] = max(worst[tname], rel)
                    worst_cfl[tname] = max(worst_cfl[tname], dcfl)
                    if (shape[0], tname, iname, k) == (192, "float32",
                                                       "path", 0):
                        main_abs_err = abs_err
                    ncase += 1
                    del qk, qp
        print(f"  [3o] step3_aos burgers_3D {shape}: max rel err f32 "
              f"{worst['float32']:.3e} f64 {worst['float64']:.3e}; max cfl "
              f"rel f32 {worst_cfl['float32']:.3e} f64 "
              f"{worst_cfl['float64']:.3e}", flush=True)
    return worst, worst_cfl, main_abs_err, ncase


def scalar_claw(dev, name, n, dtype, tfinal):
    """The runs of this slice that no example holds, built through the
    port's API as a user would: ``advection_2D`` (u = 1, v = 0.5,
    periodic, van Leer) on advection_2d's disk; ``vc_advection_fwave_2D``
    (the swirl's cell velocities, a capacity row in aux[2], fwave=True,
    MC, CFL 0.45 / 0.5, extrapolation BCs) on the same disk;
    ``burgers_2D`` / ``burgers_3D`` (the pulse of gaussian_state, periodic,
    MC; in 3D CFL 0.45 / 0.5).  n cells an axis, to ``tfinal``."""
    import pyclaw_tpu_torch as pyclaw
    dim = 3 if name == "burgers_3D" else 2
    cls = pyclaw.ClawSolver3D if dim == 3 else pyclaw.ClawSolver2D
    solver = cls(getattr(pyclaw.riemann, name), device=dev)
    domain = pyclaw.Domain([0.0] * dim, [1.0] * dim, [n] * dim)
    num_aux = 3 if name == "vc_advection_fwave_2D" else 0
    state = pyclaw.State(domain, 1, num_aux=num_aux, dtype=dtype)
    if name.startswith("burgers"):
        solver.limiters = [pyclaw.limiters.tvd.MC]
        solver.all_bcs = pyclaw.BC.periodic
        state.q[0] = gaussian_state((n,) * dim)[0]
    else:
        state.q[0] = example_state("advection_2d", n, n)[0][0]
    if name == "burgers_3D":
        # at the default CFL (0.9 / 1.0) the 3D step overshoots once the
        # shock forms at 192^3 (max q 1.69 by t=0.25), and so does its
        # plain version (the card and the CPU's plain path agree to 2.6e-14
        # at 64^3, where its rejected steps begin); kpp.py's CFL 0.45 / 0.5
        # keeps it within [0, 1]
        solver.cfl_desired, solver.cfl_max = 0.45, 0.5
    if name == "advection_2D":
        solver.limiters = [pyclaw.limiters.tvd.vanleer]
        solver.all_bcs = pyclaw.BC.periodic
        state.problem_data["u"], state.problem_data["v"] = 1.0, 0.5
    if name == "vc_advection_fwave_2D":
        solver.fwave = True
        solver.limiters = [pyclaw.limiters.tvd.MC]
        solver.cfl_desired, solver.cfl_max = 0.45, 0.5
        solver.all_bcs = pyclaw.BC.extrap
        solver.aux_bc_lower = [pyclaw.BC.extrap] * 2
        solver.aux_bc_upper = [pyclaw.BC.extrap] * 2
        state.aux[:2] = swirl_cell_velocities(n, n)
        state.aux[2] = fwave_capacity(n, n)
        state.index_capa = 2
    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = tfinal
    claw.num_output_times = 1
    claw.outdir = None
    claw.output_format = None
    return claw


def run_scalar(dev, name, n, dtype, tfinal):
    """:func:`scalar_claw` through Controller.run(); returns (claw, status,
    wall seconds)."""
    import torch
    claw = scalar_claw(dev, name, n, dtype, tfinal)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def scalar_mass(q, kappa=None):
    """sum(kappa q[0]) in float64 (kappa 1 when None)."""
    q0 = q[0].astype(np.float64)
    return float(np.sum(q0 if kappa is None else q0 * kappa))


def scalar_run(label, run, kernel, per, shape, tfinal, graph=True):
    """One run of this slice on the device loop (``graph`` False: on the
    host loop, which before_step takes), every launch count set to 0 just
    before it and read just after: the launches (``kernel`` per attempted
    step, restore once on the device loop; ``kernel`` None for a path of
    plain PyTorch), the steps, the wall, the loop's counters; q finite of
    ``shape`` at ``tfinal``.  Returns (claw, its record)."""
    claw, status, wall, counts, ran = counted_run(run)
    ns, nr = status["numsteps"], status["numrejected"]
    loop = check_path_launches(label, claw, status, counts, kernel, per,
                               graph=graph, ran=ran)
    q = claw.solution.q
    if (q.shape != shape or not np.all(np.isfinite(q))
            or abs(claw.solution.t - tfinal) > 1e-12):
        fail(f"{label}: q {q.shape} finite {np.all(np.isfinite(q))}, t "
             f"{claw.solution.t}")
    rec = {"accepted": ns, "rejected": nr, "wall_s_counted": wall,
           "launches": ran, "wrapper_counts": counts, "loop": loop,
           "cell_updates_per_s": ns * int(np.prod(shape[1:])) / wall,
           "q_min": float(q.min()), "q_max": float(q.max())}
    print(f"{label} to t={claw.solution.t}: {ns} accepted + {nr} rejected "
          f"steps, {ran.get(kernel, 0) if kernel else 0} {kernel} launches "
          f"the card ran ({per} x attempts; {ran}), {wall:.3f} s wall with "
          f"the device counters; device loop {loop}; q in "
          f"[{rec['q_min']:.6g}, {rec['q_max']:.6g}]", flush=True)
    return claw, rec


def in_range(label, rec, lo, hi):
    """Fail unless the run's q stayed in [lo, hi] to SCALAR_RANGE_TOL."""
    if not (rec["q_min"] >= lo - SCALAR_RANGE_TOL
            and rec["q_max"] <= hi + SCALAR_RANGE_TOL):
        fail(f"{label}: q in [{rec['q_min']}, {rec['q_max']}], not in "
             f"[{lo}, {hi}] to {SCALAR_RANGE_TOL}")


def kpp_path(dev, n=1024, n_sharp=512):
    """[4s]: examples.kpp in float32 to t=1.0: classic at n^2 (minmod,
    transverse_waves 2, CFL 0.45 / 0.5; step2_aos's kpp_2D instance, 1
    launch an attempted step), q within its initial range [pi/4, 14 pi/4];
    SharpClaw at n_sharp^2 (the generic dq, weno5 20 an attempt)."""
    out = {}
    claw, out["classic"] = scalar_run(
        f"[4s] kpp classic {n}^2 f32",
        lambda: run_example(dev, "kpp", np.float32, 1.0, mx=n, my=n),
        "step2_aos", 1, (1, n, n), 1.0)
    in_range("[4s] kpp classic", out["classic"], np.pi / 4, 3.5 * np.pi)
    del claw
    claw, out["sharpclaw"] = scalar_run(
        f"[4s] kpp sharpclaw {n_sharp}^2 f32",
        lambda: run_example(dev, "kpp", np.float32, 1.0, mx=n_sharp,
                            my=n_sharp, solver_type="sharpclaw"),
        "weno5", 20, (1, n_sharp, n_sharp), 1.0)
    return out


def interface_path(dev, n=1024, n_sharp=512, n_cd=256):
    """[4t]: examples.acoustics_2d_interface in float32 to t=0.6: classic
    MC at n^2 (step2_aos's vc_acoustics_2D instance, 1 launch an
    attempted step; p keeps its y -> -y mirror symmetry to
    SCALAR_MIRROR_TOL), SharpClaw at n_sharp^2 (the generic dq with aux,
    weno5 20 an attempt) and SharpClaw with char_decomp=2 at n_cd^2 (the
    characteristic reconstruction through the record's evec, plain
    PyTorch: no kernel of the port but restore)."""
    out = {}
    for label, kw, kernel, per, m in (
            ("classic", {}, "step2_aos", 1, n),
            ("sharpclaw", {"solver_type": "sharpclaw"}, "weno5", 20,
             n_sharp),
            ("sharpclaw char_decomp=2", {"solver_type": "sharpclaw"}, None,
             0, n_cd)):
        def tweak(claw, label=label):
            if "char_decomp" in label:
                claw.solver.char_decomp = 2
        claw, rec = scalar_run(
            f"[4t] acoustics_2d_interface {label} {m}^2 f32",
            lambda kw=kw, m=m, tweak=tweak: run_example(
                dev, "acoustics_2d_interface", np.float32, 0.6, tweak=tweak,
                mx=m, my=m, **kw), kernel, per, (3, m, m), 0.6)
        p = claw.solution.q[0].astype(np.float64)
        rec["mirror_asymmetry"] = float(np.abs(p - p[:, ::-1]).max()
                                        / np.abs(p).max())
        print(f"    max |p(x, y) - p(x, -y)| / max |p| "
              f"{rec['mirror_asymmetry']:.3e}"
              + (f" (tol {SCALAR_MIRROR_TOL})" if label == "classic"
                 else " (reported)"), flush=True)
        if label == "classic" and rec["mirror_asymmetry"] > SCALAR_MIRROR_TOL:
            fail(f"[4t] classic: {rec}")
        out[label] = rec
        del claw
    return out


def advection_paths(dev, n=1024):
    """[4u]: the three advection instances in float32, each with its
    (capacity-weighted) mass kept to SCALAR_MASS_TOL: examples.advection_2d
    at n^2 to t=2.0 (vc_advection_2D on the swirl's edge velocities,
    transverse_waves 0, van Leer: q within [0, 1]); advection_2D (u = 1,
    v = 0.5, periodic, van Leer) at n^2 to t=0.25 and vc_advection_fwave_2D
    (the swirl's cell velocities, a capacity row, f-waves, MC) at n^2 to
    t=0.25; step2_aos 1 launch an attempted step each."""
    out = {}
    disk = example_state("advection_2d", n, n)[0].astype(np.float32)
    kappa = fwave_capacity(n, n).astype(np.float32).astype(np.float64)
    for label, run, tfinal, kap in (
            ("advection_2d (vc_advection_2D)",
             lambda: run_example(dev, "advection_2d", np.float32, 2.0,
                                 mx=n, my=n), 2.0, None),
            ("advection_2D", lambda: run_scalar(dev, "advection_2D", n,
                                                np.float32, 0.25), 0.25,
             None),
            ("vc_advection_fwave_2D",
             lambda: run_scalar(dev, "vc_advection_fwave_2D", n, np.float32,
                                0.25), 0.25, kappa)):
        claw, rec = scalar_run(f"[4u] {label} {n}^2 f32", run, "step2_aos",
                               1, (1, n, n), tfinal)
        mass0 = scalar_mass(disk, kap)
        mass = scalar_mass(claw.solution.q, kap)
        rec["mass_change"] = abs(mass - mass0) / abs(mass0)
        print(f"    mass change {rec['mass_change']:.3e} (tol "
              f"{SCALAR_MASS_TOL['float32']})", flush=True)
        if rec["mass_change"] > SCALAR_MASS_TOL["float32"]:
            fail(f"[4u] {label}: {rec}")
        if "vc_advection_2D" in label:
            in_range(f"[4u] {label}", rec, 0.0, 1.0)
        out[label.split()[0]] = rec
        del claw
    return out


def burgers_paths(dev, n2=1024, n3=192, t2=0.4, t3=0.4):
    """[4v]: burgers_2D on the pulse at n2^2 to t2 and burgers_3D at n3^3
    to t3 (CFL 0.45 / 0.5), periodic, MC, float32 and float64 (step2_aos's
    and step3_aos's
    Burgers instances, 1 launch an attempted step): the mass kept to
    SCALAR_MASS_TOL; the float64 runs' diagonal (2D) and x <-> y (3D)
    symmetry to SCALAR_SYM_TOL (the JAX package's gate of
    tests/test_2d_examples.py:198-215); the float32 run's relative L1
    distance from the float64 one reported."""
    out = {}
    for name, n, tfinal, kernel in (("burgers_2D", n2, t2, "step2_aos"),
                                    ("burgers_3D", n3, t3, "step3_aos")):
        dim = 3 if name == "burgers_3D" else 2
        shape = (1,) + (n,) * dim
        runs = {}
        for tname, dtype in (("float32", np.float32),
                             ("float64", np.float64)):
            mass0 = scalar_mass(gaussian_state((n,) * dim).astype(dtype))
            claw, rec = scalar_run(
                f"[4v] {name} {n}^{dim} {tname}",
                lambda dtype=dtype: run_scalar(dev, name, n, dtype, tfinal),
                kernel, 1, shape, tfinal)
            q = claw.solution.q[0].astype(np.float64)
            rec["mass_change"] = abs(scalar_mass(q[None]) - mass0) / mass0
            rec["symmetry"] = float(np.abs(q - np.swapaxes(q, 0, 1)).max())
            print(f"    mass change {rec['mass_change']:.3e} (tol "
                  f"{SCALAR_MASS_TOL[tname]}); max |q - q^T| "
                  f"{rec['symmetry']:.3e}"
                  + (f" (tol {SCALAR_SYM_TOL})" if tname == "float64"
                     else " (reported)"), flush=True)
            if (rec["mass_change"] > SCALAR_MASS_TOL[tname]
                    or (tname == "float64"
                        and rec["symmetry"] > SCALAR_SYM_TOL)):
                fail(f"[4v] {name} {tname}: {rec}")
            runs[tname] = q
            out[f"{name}:{tname}"] = rec
            del claw
        l1 = float(np.abs(runs["float32"] - runs["float64"]).mean()
                   / np.abs(runs["float64"]).mean())
        out[f"{name}:f32_vs_f64_l1"] = l1
        print(f"    {name} f32 against f64: rel L1 {l1:.3e}", flush=True)
    return out


def scalar_card_vs_cpu(dev):
    """[5y]: this slice's runs on the card against the same runs on the
    CPU's plain path in float64 (equal steps, q to CARD_VS_CPU_TOL of
    max|q|): the three examples on their routes at 40^2 (advection_2d at
    48^2), advection_2D and vc_advection_fwave_2D at 40^2, burgers_2D at
    48^2 and burgers_3D at 12^3."""
    out = {}
    cases = (
        ("kpp classic", lambda d: run_example(d, "kpp", np.float64, 1.0,
                                              mx=40, my=40)),
        ("kpp sharpclaw", lambda d: run_example(
            d, "kpp", np.float64, 1.0, mx=40, my=40,
            solver_type="sharpclaw")),
        ("acoustics_2d_interface classic", lambda d: run_example(
            d, "acoustics_2d_interface", np.float64, 0.6, mx=40, my=40)),
        ("acoustics_2d_interface sharpclaw", lambda d: run_example(
            d, "acoustics_2d_interface", np.float64, 0.6, mx=40, my=40,
            solver_type="sharpclaw")),
        ("advection_2d", lambda d: run_example(d, "advection_2d", np.float64,
                                               2.0, mx=48, my=48)),
        ("advection_2D", lambda d: run_scalar(d, "advection_2D", 40,
                                              np.float64, 0.25)),
        ("vc_advection_fwave_2D", lambda d: run_scalar(
            d, "vc_advection_fwave_2D", 40, np.float64, 0.25)),
        ("burgers_2D", lambda d: run_scalar(d, "burgers_2D", 48, np.float64,
                                            0.4)),
        ("burgers_3D", lambda d: run_scalar(d, "burgers_3D", 12, np.float64,
                                            0.5)))
    for label, run in cases:
        runs = {}
        for where in (dev, "cpu"):
            c, st, w = run(where)
            runs[str(where)] = (c.solution.q, (st["numsteps"],
                                               st["numrejected"]), w)
        (q_k, s_k, w_k), (q_c, s_c, w_c) = runs[str(dev)], runs["cpu"]
        rel = float(np.abs(q_k - q_c).max() / np.abs(q_c).max())
        out[label] = {"max_rel": rel, "steps_card": s_k, "steps_cpu": s_c,
                      "wall_card_s": w_k, "wall_cpu_s": w_c}
        print(f"[5y] {label} f64 card vs cpu: max rel {rel:.3e} (tol "
              f"{CARD_VS_CPU_TOL}), steps card {s_k}, cpu {s_c}; wall card "
              f"{w_k:.3f} s, cpu {w_c:.3f} s", flush=True)
        if not (s_k == s_c and rel <= CARD_VS_CPU_TOL):
            fail(f"[5y] {label}: {out[label]}")
    return out


def timing_scalar(dev, name, n=1024):
    """[6]: step2_aos's instance of system ``name`` (CUDA events and the
    profiler's device time), its plain version and its bound on its run's
    first input at n^2 (ops/time_kernels.py:step2_aos_scalar_case)."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc, args = step2_aos_scalar_case(name, n, dtype, dev)
        auxbc, dt, dx, dy, rp, params, lims, order, fwave, capa, _, tw = args

        def kern():
            return tiled2d.step2_rows_generic(qbc, *args)

        def plain():
            return plain_step2(qbc, auxbc, dt, dx, dy, rp, params, lims,
                               order, fwave, capa, tw)

        ms = time_ms(kern, 200)
        plain_ms = time_ms(plain, 20, warm=2)
        ms_again = time_ms(kern, 200)
        dev_ms, dev_n = device_ms_per_call(kern, "step2_aos_kernel", 20)
        item = qbc.element_size()
        cells = (qbc.shape[1] - 4) * (qbc.shape[2] - 4)
        aux_bytes = 0 if auxbc is None else auxbc.numel() * item
        b = bound_of(qbc.numel() * item + aux_bytes
                     + rp.num_eqn * cells * item,
                     FLOPS_PER_CELL_SCALAR[name] * cells, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, "shape": list(qbc.shape), **b}
        print(f"  timing step2_aos {name} {tuple(qbc.shape)} {tname}: "
              f"kernel {ms:.4f} ms (repeat {ms_again:.4f}; on the device "
              f"{dev_ms} ms, {dev_n} launches profiled), plain "
              f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}; bytes {b['bytes_ms']:.4f}, operations "
              f"{b['ops_ms']:.4f}), share of bound {b['bound_ms'] / ms:.4f}, "
              f"library_ms null", flush=True)
    return out


def timing_burgers3d(dev, n=192):
    """[6]: step3_aos's burgers_3D instance (the Burgers 3D run's
    configuration: transverse_waves 2, order 2, MC), its plain version and
    its bound at n^3 on the run's first input
    (ops/time_kernels.py:step3_aos_burgers_case)."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc, auxbc, args = step3_aos_burgers_case(n, dtype, dev)
        dt, deltas, rp, params = args[0], args[1:4], args[4], args[5]

        def kern():
            return tiled2d.step3_xy_generic(qbc, auxbc, *args)

        def plain():
            return plain_step3_aos(qbc, auxbc, dt, deltas, rp.name, (4,), 2,
                                   False, -1, 2, params=params)

        ms = time_ms(kern, 20, warm=2)
        plain_ms = time_ms(plain, 3, warm=1)
        ms_again = time_ms(kern, 20, warm=2)
        dev_ms, dev_n = device_ms_per_call(kern, "step3_aos_kernel", 10)
        item = qbc.element_size()
        b = bound_of((qbc.numel() + n ** 3) * item,
                     flops_per_cell_3d_aos(rp.name, 2) * n ** 3, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, "shape": list(qbc.shape), **b}
        print(f"  timing step3_aos burgers_3D {n}^3 {tname}: kernel "
              f"{ms:.4f} ms (repeat {ms_again:.4f}; on the device {dev_ms} "
              f"ms, {dev_n} launches profiled), plain {plain_ms:.4f} ms, "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}; bytes "
              f"{b['bytes_ms']:.4f}, operations {b['ops_ms']:.4f}), share "
              f"of bound {b['bound_ms'] / ms:.4f}, library_ms null",
              flush=True)
        del qbc
        torch.cuda.empty_cache()
    return out


# ---- dimensional splitting and source terms: [4w] and its timings in [6]

# step2_aos's instances without a transverse solver, in the order of
# ops/time_kernels.py:NO_TRANS_CASES (each timed on its unsplit run's first
# input)
NO_TRANS_2D = tuple(NO_TRANS_CASES)
# Operations per cell of one generic CTU step of each of them (order 2,
# MC, f-waves, no transverse pass), counted from csrc/psystem2d.cuh,
# csrc/shallow_sphere2d.cuh and csrc/step2_aos.cu in the same way as
# FLOPS_PER_CELL_AOS, each interface quantity counted once, an exp or a
# sqrt as one operation.  psystem_2D: per cell its u, v, sigma, z and c
# (two divisions, the exp law's product, exp, subtraction and product,
# two products or quotients and two square roots: 10); per interface the
# normal solve (the jumps 4, the denominator 1, the strengths 6, the
# waves 3, the speed 1: 15), the limiter of two waves of two nonzero
# components 44 (as the acoustics instance's), the correction flux 7,
# CFL 2; the update 30 (three equations, no transverse fold).
# shallow_sphere_fwave_2D: per cell hu/h, hv/h, sqrt(h) and p (5); per
# interface the normal solve (h_bar 2, the Roe velocities 10, c 2, the
# fluxes 4 and along theta their six kappa products (3 an interface on
# average), the flux jumps 5, the strengths 9, the waves 6, the split by
# the speeds' signs 21: 64), the limiter of three waves 78 (as the
# shallow-water instance's), the correction flux 15, CFL with capacity
# 12, the capacity's average 2; the update 30 and the capacity's dt/(dx
# kappa), dt/(dy kappa) 4.  In float32 the p-system moves 32 B a cell (q
# and its two aux rows read, q written), the sphere 28 B (q and kappa,
# aux row 1, read, q written; it reads no other aux row): 5.5 and 13.6
# operations per byte, below the card's 20 (and 10 in float64): bytes
# bound both.
FLOPS_PER_CELL_NO_TRANS = {
    "psystem_2D": 10 + 2 * (15 + 44 + 7 + 2) + 30,
    "shallow_sphere_fwave_2D": 5 + 2 * (64 + 78 + 15 + 12 + 2) + 30 + 4}
# [4w]'s kernel check: the unsplit run's grid, one less than a tile and one
# ragged on both axes with more tiles than resident blocks; (the
# transverse_waves passed, which the instance ignores, order, limiter,
# index_capa, the p-system's stress law)
NO_TRANS_GRIDS = {"psystem_2D": ((1024, 1024), (7, 5), (600, 700)),
                  "shallow_sphere_fwave_2D": ((1024, 512), (7, 5),
                                              (600, 700))}
NO_TRANS_OPTS = [(2, 2, 4, -1, "exp"), (1, 2, 1, 1, "linear"),
                 (0, 1, 10, 1, "exp")]
# [4w]'s runs: the p-system to its example's t=1.0 and the sphere to
# t=1.0 (a 25th of its example's revolution), the forward step to t=0.5,
# the 3D acoustics to its example's t=0.8, advection-reaction to t=1e-3
# with lambda = 1000 (the decay e^-1 over 1165 steps at 2^20 cells)
PSYSTEM_T, SPHERE_T, FSTEP_T, REACTION_T, REACTION_LAM = 1.0, 1.0, 0.5, \
    1e-3, 1000.0
# [4w]: the p-system runs keep the x -> -x mirror symmetry of their
# strain (absolute, eps in [0, 0.5]) to MIRROR_TOL_F64 in float64 and
# MIRROR_TOL_F32 in float32.  Each split sweep's sums are mirror-exact (0
# on the card).  The unsplit step without transverse terms amplifies its
# roundoff (its second-order corrections are unstable at every Courant
# number, the limiter bounds them; examples/psystem_2d.py): at CFL 0.45 on
# the card at 1024^2 2.2e-9 in f64 and 2.1e-2 in f32.  Its route runs at
# CFL 0.2 / 0.25, where the CPU's plain path reads, by
# tests/test_torch_split.py --unsplit: f64 3.3e-16 at 256^2 and 8.3e-16
# at 1024^2, f32 1.6e-7 at 256^2, 3.9e-7 at 512^2 and 5.4e-7 at 1024^2
# (the card at 1024^2: f64 1.1e-15, f32 6.9e-7, on an H100 80GB HBM3 at
# 700 W); the sphere's float64 TC2 depth drifts by at most
# test_shallow_sphere.py's 0.05 (relative);
# the float32 split run's drift on the card at SPHERE_SMALL within
# SPHERE_F32_DRIFT of the same float32 run's on the CPU's plain path
# (relative: float32 roundoff moves the drift, the card's operations
# must move it as the CPU's do; they differed by 1.2e-5 on an H100 80GB
# HBM3 at 700 W; tests/test_torch_split.py holds the CPU's float32 drift
# to the JAX run's; the 1024x512 float32 drifts are reported);
# advection-reaction ends within REACTION_TOL of the exact solution
# e^(-lambda t) q0(x - t) (absolute, q0 in [0, 1]: the float32 decay
# factor's rounding, ~6e-8 a step over 1165 steps, and the advection
# error)
MIRROR_TOL_F64, MIRROR_TOL_F32 = 1e-10, 1e-5
SPHERE_DRIFT_TOL, SPHERE_F32_DRIFT, SPHERE_SMALL = 0.05, 1e-3, (128, 64)
REACTION_TOL = 1e-3


def no_trans_state(rng, name, nx, ny):
    """A seeded (q, aux) of system ``name`` at nx x ny: the p-system's
    strain of either sign, rho and K in (0.5, 3.5); the sphere's depths
    near 1 and velocities of either sign, aux rows in (0.5, 1), each
    jumping across rows 12 | 13 and columns 15 | 16."""
    n = (nx, ny)
    if name == "psystem_2D":
        q = np.stack([0.3 * rng.standard_normal(n), rng.standard_normal(n),
                      rng.standard_normal(n)])
        aux = 0.5 + 3.0 * rng.random((2,) + n)
    else:
        h = 0.8 + 0.4 * rng.random(n)
        q = np.stack([h, h * rng.standard_normal(n),
                      h * rng.standard_normal(n)])
        aux = 0.5 + 0.5 * rng.random((2,) + n)
    aux[:, 12:] *= 1.3
    aux[:, :, 15:] *= 0.8
    return q, aux


def compare_no_trans(dev, seed=16):
    """[4w]: step2_aos's psystem_2D and shallow_sphere_fwave_2D instances
    against the plain version (classic/kernels.py:step2 with rpt=None),
    one step each, over NO_TRANS_GRIDS and NO_TRANS_OPTS, the unsplit
    run's first state (its grid) and a seeded random one, float32 and
    float64.  Returns (worst relative error, worst CFL error, each
    system's main configuration's max abs error (its run's grid, f32, the
    run's state, the first option), cases)."""
    import torch
    from pyclaw_tpu_torch import riemann
    from pyclaw_tpu_torch.ops import tiled2d
    rng = np.random.default_rng(seed)
    worst = {"float32": 0.0, "float64": 0.0}
    worst_cfl = {"float32": 0.0, "float64": 0.0}
    main_abs_err = {}
    ncase = 0
    for name in NO_TRANS_2D:
        rp = riemann.ALL[name]
        for gi, (nx, ny) in enumerate(NO_TRANS_GRIDS[name]):
            opts = NO_TRANS_OPTS[:2] if nx * ny > 2e5 else NO_TRANS_OPTS
            inputs = {"random": no_trans_state(rng, name, nx, ny)}
            if gi == 0:
                qbc0, args0 = step2_aos_no_trans_case(name, nx, torch.float64,
                                                      "cpu")
                inputs["path"] = (qbc0[:, 2:-2, 2:-2].numpy(),
                                  args0[0][:, 2:-2, 2:-2].numpy())
            dx, dy = 1.0 / nx, 1.0 / ny
            for iname, (q_np, a_np) in inputs.items():
                for tname, dtype in (("float32", torch.float32),
                                     ("float64", torch.float64)):
                    qbc = padded(q_np, dtype, dev)
                    auxbc = padded(a_np, dtype, dev)
                    dt = float(np.dtype(tname).type(0.05 * min(dx, dy)))
                    for k, (tw, order, lim, capa, law) in enumerate(opts):
                        params = {"grav": 1.0, "stress_relation": law}
                        args = (qbc, auxbc, dt, dx, dy, rp, params,
                                (lim,) * rp.num_waves, order, True, capa)
                        qk, ck = tiled2d.step2_rows_generic(*args, 2, tw)
                        qp, cp = plain_step2(*args, tw)
                        torch.cuda.synchronize()
                        abs_err = float((qk - qp).abs().max())
                        rel = abs_err / max(float(qp.abs().max()), 1e-300)
                        dcfl = abs(float(ck) - float(cp)) / float(cp)
                        if not (np.isfinite(rel) and rel <= TOL_REL[tname]
                                and dcfl <= TOL_REL[tname]
                                and tuple(qk.shape) == (rp.num_eqn, nx, ny)):
                            fail(f"[4w] step2_aos vs plain {nx}x{ny} {name} "
                                 f"{iname} {tname} tw={tw} order={order} "
                                 f"lim={lim} capa={capa} law={law}: rel "
                                 f"err {rel:.3e}, cfl {float(ck)!r} vs "
                                 f"{float(cp)!r}")
                        worst[tname] = max(worst[tname], rel)
                        worst_cfl[tname] = max(worst_cfl[tname], dcfl)
                        if (gi, tname, iname, k) == (0, "float32", "path", 0):
                            main_abs_err[name] = abs_err
                        ncase += 1
                        del qk, qp
    print(f"[4w] step2_aos vs plain (psystem_2D, shallow_sphere_fwave_2D, "
          f"no transverse pass): {ncase} cases, max rel err f32 "
          f"{worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{worst['float64']:.3e} (tol {TOL_REL['float64']}); max cfl rel "
          f"f32 {worst_cfl['float32']:.3e}, f64 {worst_cfl['float64']:.3e}",
          flush=True)
    return worst, worst_cfl, main_abs_err, ncase


def mirror_x(q0):
    """max |f(x, y) - f(-x, y)| of a field on a grid symmetric in x."""
    q0 = np.asarray(q0, dtype=np.float64)
    return float(np.abs(q0 - q0[::-1]).max())


def psystem_runs(dev, n=1024):
    """[4w] psystem_2d at n^2 to PSYSTEM_T, float32 and float64: the split
    route (the example's: x and y sweeps of plain PyTorch, gauges on the
    device loop) and the unsplit one (step2_aos's psystem_2D instance, 1
    launch an attempted step, CFL 0.2 / 0.25); each run's x mirror
    symmetry of the strain to MIRROR_TOL_F64 / MIRROR_TOL_F32; the gauges
    recorded."""
    out = {}
    for route, split, kernel, per in (("split", True, None, 0),
                                      ("unsplit", False, "step2_aos", 1)):
        for tname, dtype in (("float32", np.float32),
                             ("float64", np.float64)):
            claw, rec = scalar_run(
                f"[4w] psystem_2d {route} {n}^2 {tname}",
                lambda dtype=dtype, split=split: run_example(
                    dev, "psystem_2d", dtype, PSYSTEM_T, mx=n, my=n,
                    dimensional_split=split), kernel, per, (3, n, n),
                PSYSTEM_T)
            rec["mirror_x"] = mirror_x(claw.solution.q[0])
            rec["gauge_samples"] = len(claw.solution.state.gauge_data)
            tol = MIRROR_TOL_F64 if tname == "float64" else MIRROR_TOL_F32
            print(f"    max |eps(x, y) - eps(-x, y)| {rec['mirror_x']:.3e} "
                  f"(tol {tol}); {rec['gauge_samples']} gauge samples",
                  flush=True)
            if (rec["mirror_x"] > tol
                    or rec["gauge_samples"] != 2 * rec["accepted"]):
                fail(f"[4w] psystem_2d {route} {tname}: {rec}")
            out[f"{route}:{tname}"] = rec
            del claw
    return out


def sphere_runs(dev, n=(1024, 512)):
    """[4w] shallow_sphere at n to SPHERE_T with the Strang source, float32
    and float64: the split route (the example's; the source hook and the
    custom q and aux BCs inside the device loop's CUDA graphs) and the
    unsplit one (step2_aos's shallow_sphere_fwave_2D instance, 1 launch
    an attempted step, CFL 0.2 / 0.25); h > 0; the TC2 depth's drift, the
    float64 runs' within SPHERE_DRIFT_TOL; the float32 split run at
    SPHERE_SMALL on the card and on the CPU, their drifts within
    SPHERE_F32_DRIFT of each other."""
    import importlib
    ex = importlib.import_module("pyclaw_tpu_torch.examples.shallow_sphere")

    def depth0(mx, my):
        return ex.setup(mx=mx, my=my, outdir=None,
                        device="cpu").solution.state.q[0].copy()

    def drift_of(q, h0):
        return float(np.abs(q[0].astype(np.float64) - h0).max() / h0.max())

    h0 = depth0(*n)
    out = {}
    small = {}
    for where in (dev, "cpu"):
        claw, _, _ = run_example(where, "shallow_sphere", np.float32,
                                 SPHERE_T, mx=SPHERE_SMALL[0],
                                 my=SPHERE_SMALL[1])
        small[str(where)] = drift_of(claw.solution.q, depth0(*SPHERE_SMALL))
    rel = abs(small[str(dev)] - small["cpu"]) / small["cpu"]
    out["f32_drift_small"] = {"card": small[str(dev)], "cpu": small["cpu"],
                              "rel": rel}
    print(f"[4w] shallow_sphere split {SPHERE_SMALL[0]}x{SPHERE_SMALL[1]} "
          f"f32 to t={SPHERE_T}: TC2 depth drift card {small[str(dev)]:.6e}, "
          f"cpu {small['cpu']:.6e}, rel {rel:.3e} (tol {SPHERE_F32_DRIFT})",
          flush=True)
    if rel > SPHERE_F32_DRIFT:
        fail(f"[4w] shallow_sphere f32 drift: {out['f32_drift_small']}")
    for route, split, kernel, per in (("split", True, None, 0),
                                      ("unsplit", False, "step2_aos", 1)):
        drift = {}
        for tname, dtype in (("float32", np.float32),
                             ("float64", np.float64)):
            claw, rec = scalar_run(
                f"[4w] shallow_sphere {route} {n[0]}x{n[1]} {tname}",
                lambda dtype=dtype, split=split: run_example(
                    dev, "shallow_sphere", dtype, SPHERE_T, mx=n[0],
                    my=n[1], dimensional_split=split), kernel, per,
                (3,) + n, SPHERE_T)
            rec["drift"] = drift[tname] = drift_of(claw.solution.q, h0)
            rec["h_min"] = float(claw.solution.q[0].min())
            rec["captures"] = rec["loop"]["captures"]
            print(f"    TC2 depth drift {rec['drift']:.6e}, min h "
                  f"{rec['h_min']:.6g}", flush=True)
            if rec["h_min"] <= 0.0:
                fail(f"[4w] shallow_sphere {route} {tname}: {rec}")
            out[f"{route}:{tname}"] = rec
            del claw
        print(f"    {route}: drift f32 {drift['float32']:.6e}, f64 "
              f"{drift['float64']:.6e} (tol {SPHERE_DRIFT_TOL})", flush=True)
        if drift["float64"] > SPHERE_DRIFT_TOL:
            fail(f"[4w] shallow_sphere {route}: drift {drift}")
    return out


def fluid_checks(label, q, mx, my):
    """rho > 0 and p > 0 in the forward step's fluid cells (outside the
    step [0.6, 3] x [0, 0.2]); returns (min rho, min p)."""
    fluid = np.ones((mx, my), bool)
    fluid[int(round(0.2 * mx)):, :int(round(0.2 * my))] = False
    q = q.astype(np.float64)
    rho = q[0][fluid]
    p = 0.4 * (q[3][fluid] - 0.5 * (q[1][fluid] ** 2 + q[2][fluid] ** 2)
               / rho)
    if not (rho.min() > 0.0 and p.min() > 0.0):
        fail(f"{label}: min rho {rho.min()}, min p {p.min()} in the fluid")
    return float(rho.min()), float(p.min())


def forward_step_runs(dev, n=(600, 200)):
    """[4w] shock_forward_step at n to FSTEP_T in float32, on the host
    loop (its before_step): classic split (plain PyTorch, no kernel of the
    port) and SharpClaw (dq2_weno5, 10 launches an attempted step); rho >
    0 and p > 0 in the fluid."""
    out = {}
    for solver_type, kernel, per in (("classic", None, 0),
                                     ("sharpclaw", "dq2_weno5", 10)):
        label = f"[4w] shock_forward_step {solver_type} {n[0]}x{n[1]} f32"
        claw, rec = scalar_run(
            label, lambda st=solver_type: run_example(
                dev, "shock_forward_step", np.float32, FSTEP_T, mx=n[0],
                my=n[1], solver_type=st, num_output_times=1), kernel, per,
            (4,) + n, FSTEP_T, graph=False)
        rec["rho_min"], rec["p_min"] = fluid_checks(label, claw.solution.q,
                                                    *n)
        out[solver_type] = rec
        del claw
    return out


def acoustics3d_split_run(dev, n=128):
    """[4w] acoustics_3d_heterogeneous split (three sweeps of plain
    PyTorch, the default CFL) at n^3 float32 to its example's t=0.8."""
    claw, rec = scalar_run(
        f"[4w] acoustics_3d_heterogeneous split {n}^3 f32",
        lambda: run_example(dev, "acoustics_3d_heterogeneous", np.float32,
                            0.8, mx=n, my=n, mz=n, dimensional_split=True),
        None, 0, (4, n, n, n), 0.8)
    del claw
    return rec


def reaction_runs(dev, n=2 ** 20):
    """[4w] advection_reaction at n cells with lambda = REACTION_LAM to
    REACTION_T, float32: classic with the source split Godunov and Strang
    (step1, 1 launch an attempted step; the source in the device loop's
    graphs) and SharpClaw with dq_src (weno5, 10 an attempt); each within
    REACTION_TOL of the exact solution."""
    out = {}
    x = (np.arange(n) + 0.5) / n
    exact = np.exp(-REACTION_LAM * REACTION_T) * np.exp(
        -100.0 * ((x - REACTION_T) % 1.0 - 0.5) ** 2)
    for label, kw, kernel, per in (
            ("classic Godunov", {"source_split": 1}, "step1", 1),
            ("classic Strang", {"source_split": 2}, "step1", 1),
            ("sharpclaw dq_src", {"solver_type": "sharpclaw"}, "weno5", 10)):
        claw, rec = scalar_run(
            f"[4w] advection_reaction {label} 2^20 f32",
            lambda kw=kw: run_example(dev, "advection_reaction", np.float32,
                                      REACTION_T, nx=n, lam=REACTION_LAM,
                                      **kw), kernel, per, (1, n), REACTION_T)
        rec["max_err_exact"] = float(np.abs(claw.solution.q[0] - exact).max())
        print(f"    max |q - exact| {rec['max_err_exact']:.3e} (tol "
              f"{REACTION_TOL})", flush=True)
        if rec["max_err_exact"] > REACTION_TOL:
            fail(f"[4w] advection_reaction {label}: {rec}")
        out[label] = rec
        del claw
    return out


def split_profiles(dev):
    """[4w]: launches and device ms a step of the split and the unsplit
    routes of psystem_2d (1024^2) and shallow_sphere (1024x512), float32,
    on the device loop, each to t=0.02 under torch.profiler
    (profile_main_path)."""
    out = {}
    for name, kw in (("psystem_2d", {"mx": 1024, "my": 1024}),
                     ("shallow_sphere", {"mx": 1024, "my": 512})):
        for route, split in (("split", True), ("unsplit", False)):
            out[f"{name}:{route}"] = profile_main_path(
                f"[4w] {name} {route}",
                lambda name=name, kw=kw, split=split: run_example(
                    dev, name, np.float32, 0.02, dimensional_split=split,
                    **kw))
    return out


def split_card_vs_cpu(dev):
    """[4w]: the split routes and the source routes at small grids on the
    card against the same runs on the CPU in float64 (equal steps, q to
    CARD_VS_CPU_TOL of max|q|): psystem_2d at 60^2, split and unsplit
    (step2_aos on the card), shallow_sphere at 64x32 to t=1.0, split and
    unsplit, shock_forward_step classic at 60x20 to t=0.5,
    acoustics_3d_heterogeneous split at 16^3, advection_reaction at 200
    cells (Godunov, Strang, dq_src)."""
    out = {}
    cases = (
        ("psystem_2d split", lambda d: run_example(
            d, "psystem_2d", np.float64, 1.0, mx=60, my=60)),
        ("psystem_2d unsplit", lambda d: run_example(
            d, "psystem_2d", np.float64, 1.0, mx=60, my=60,
            dimensional_split=False)),
        ("shallow_sphere split", lambda d: run_example(
            d, "shallow_sphere", np.float64, 1.0, mx=64, my=32)),
        ("shallow_sphere unsplit", lambda d: run_example(
            d, "shallow_sphere", np.float64, 1.0, mx=64, my=32,
            dimensional_split=False)),
        ("shock_forward_step classic", lambda d: run_example(
            d, "shock_forward_step", np.float64, 0.5, mx=60, my=20,
            num_output_times=1)),
        ("acoustics_3d_heterogeneous split", lambda d: run_example(
            d, "acoustics_3d_heterogeneous", np.float64, 0.8, mx=16, my=16,
            mz=16, dimensional_split=True)),
        ("advection_reaction Godunov", lambda d: run_example(
            d, "advection_reaction", np.float64, 1.0, source_split=1)),
        ("advection_reaction Strang", lambda d: run_example(
            d, "advection_reaction", np.float64, 1.0, source_split=2)),
        ("advection_reaction dq_src", lambda d: run_example(
            d, "advection_reaction", np.float64, 1.0,
            solver_type="sharpclaw")))
    for label, run in cases:
        runs = {}
        for where in (dev, "cpu"):
            c, st, w = run(where)
            runs[str(where)] = (c.solution.q, (st["numsteps"],
                                               st["numrejected"]), w)
        (q_k, s_k, w_k), (q_c, s_c, w_c) = runs[str(dev)], runs["cpu"]
        rel = float(np.abs(q_k - q_c).max() / np.abs(q_c).max())
        out[label] = {"max_rel": rel, "steps_card": s_k, "steps_cpu": s_c,
                      "wall_card_s": w_k, "wall_cpu_s": w_c}
        print(f"[4w] {label} f64 card vs cpu: max rel {rel:.3e} (tol "
              f"{CARD_VS_CPU_TOL}), steps card {s_k}, cpu {s_c}; wall card "
              f"{w_k:.3f} s, cpu {w_c:.3f} s", flush=True)
        if not (s_k == s_c and rel <= CARD_VS_CPU_TOL):
            fail(f"[4w] {label}: {out[label]}")
    return out


def split_phase(dev):
    """[4w]: this slice's instances against their plain version, its runs
    (each with every launch count set to 0 just before it and read just
    after), the routes' profiles and the card against the CPU."""
    out = {"kernel_check": compare_no_trans(dev)}
    out["psystem_2d"] = psystem_runs(dev)
    out["shallow_sphere"] = sphere_runs(dev)
    out["shock_forward_step"] = forward_step_runs(dev)
    out["acoustics_3d_split"] = acoustics3d_split_run(dev)
    out["advection_reaction"] = reaction_runs(dev)
    out["profiles"] = split_profiles(dev)
    out["card_vs_cpu"] = split_card_vs_cpu(dev)
    return out


def timing_no_trans(dev, name, n=1024):
    """[6]: step2_aos's instance of system ``name`` (CUDA events and the
    profiler's device time), its plain version and its bound on its
    unsplit run's first input (ops/time_kernels.py:
    step2_aos_no_trans_case)."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    out = {}
    for tname, dtype in (("float32", torch.float32),
                         ("float64", torch.float64)):
        qbc, args = step2_aos_no_trans_case(name, n, dtype, dev)
        auxbc, dt, dx, dy, rp, params, lims, order, fwave, capa, _, tw = args

        def kern():
            return tiled2d.step2_rows_generic(qbc, *args)

        def plain():
            return plain_step2(qbc, auxbc, dt, dx, dy, rp, params, lims,
                               order, fwave, capa, tw)

        ms = time_ms(kern, 200)
        plain_ms = time_ms(plain, 20, warm=2)
        ms_again = time_ms(kern, 200)
        dev_ms, dev_n = device_ms_per_call(kern, "step2_aos_kernel", 20)
        item = qbc.element_size()
        cells = (qbc.shape[1] - 4) * (qbc.shape[2] - 4)
        # the aux rows the instance reads, each once (NO_TRANS_CASES)
        aux_read = len(NO_TRANS_CASES[name][5]) * auxbc[0].numel()
        b = bound_of(qbc.numel() * item + aux_read * item
                     + rp.num_eqn * cells * item,
                     FLOPS_PER_CELL_NO_TRANS[name] * cells, tname)
        out[tname] = {"ms": ms, "ms_repeat": ms_again, "device_ms": dev_ms,
                      "device_launches_profiled": dev_n,
                      "plain_ms": plain_ms, "shape": list(qbc.shape), **b}
        print(f"  timing step2_aos {name} {tuple(qbc.shape)} {tname}: "
              f"kernel {ms:.4f} ms (repeat {ms_again:.4f}; on the device "
              f"{dev_ms} ms, {dev_n} launches profiled), plain "
              f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}; bytes {b['bytes_ms']:.4f}, operations "
              f"{b['ops_ms']:.4f}), share of bound {b['bound_ms'] / ms:.4f}, "
              f"library_ms null", flush=True)
    return out


# ---- [4x]: the 1D Riemann library (step1.cu's systems 6-15) and the last
# ten examples ---------------------------------------------------------------

# [4x]'s routes: (label, example module, setup keywords, the kernel and
# its launches per attempted step (None: plain PyTorch, no kernel), the t
# of the run against the plain version on the card (None: the example's
# tfinal), its tolerance (max|q| relative)).  A run whose one-ulp moves
# (the JAX package's run at the example's size from its initial state
# moved by one ulp, three seeds, the CPU) reach past 1e-13 is held to ten
# times its largest reading: LIB_ULP below.  The stegoton runs fork in
# roundoff after t = 1 (their CFL sits at 0.9-1.0 with rejected steps: a
# rounding difference flips an accept), so they are held at t = 1.
LIB_ROUTES = (
    ("stegoton classic", "stegoton_1d", {}, "step1", 1, 1.0),
    ("stegoton sharpclaw", "stegoton_1d", {"solver_type": "sharpclaw"},
     "weno5", 10, 1.0),
    ("sill", "sill", {}, "step1", 1, None),
    ("shallow_1d roe", "shallow_1d", {}, "step1", 1, None),
    ("shallow_1d hlle", "shallow_1d", {"riemann_solver": "hlle"}, "step1",
     1, None),
    ("shallow_1d roe sharpclaw", "shallow_1d",
     {"solver_type": "sharpclaw"}, "weno5", 10, None),
    ("shallow_1d hlle sharpclaw", "shallow_1d",
     {"solver_type": "sharpclaw", "riemann_solver": "hlle"}, "weno5", 10,
     None),
    ("traffic_1d", "traffic_1d", {}, "step1", 1, None),
    ("traffic_1d sharpclaw", "traffic_1d", {"solver_type": "sharpclaw"},
     "weno5", 10, None),
    ("mhd_1d", "mhd_1d", {}, "step1", 1, None),
    ("mhd_1d sharpclaw", "mhd_1d", {"solver_type": "sharpclaw"}, "weno5",
     10, 0.002),
    ("burgers_1d", "burgers_1d", {}, "step1", 1, None),
    ("burgers_1d sharpclaw", "burgers_1d", {"solver_type": "sharpclaw"},
     "weno5", 10, None),
    ("acoustics_1d_heterogeneous", "acoustics_1d_heterogeneous", {},
     "step1", 1, None),
    ("acoustics_1d_heterogeneous sharpclaw", "acoustics_1d_heterogeneous",
     {"solver_type": "sharpclaw"}, "weno5", 10, None),
    ("advection_1d_variable", "advection_1d_variable", {}, "step1", 1,
     None),
    ("advection_1d_variable capacity", "advection_1d_variable",
     {"use_capacity": True}, "step1", 1, None),
    ("advection_1d_variable fwave", "advection_1d_variable",
     {"use_fwave": True}, "step1", 1, None),
    ("advection_1d_variable capacity fwave", "advection_1d_variable",
     {"use_capacity": True, "use_fwave": True}, "step1", 1, None),
    ("advection_1d_variable sharpclaw", "advection_1d_variable",
     {"solver_type": "sharpclaw"}, "weno5", 10, None),
    ("advection_2d_annulus split", "advection_2d_annulus", {}, None, 0,
     None),
    ("advection_2d_annulus unsplit", "advection_2d_annulus",
     {"dimensional_split": False}, "step2_aos", 1, None),
    ("woodward_colella_blast sharpclaw", "woodward_colella_blast", {},
     "weno5", 3, None),
    ("woodward_colella_blast classic", "woodward_colella_blast",
     {"solver_type": "classic"}, "step1", 1, None))
# ten times the largest one-ulp reading of each route whose readings
# pass 1e-13 at the compared t (the JAX package on the CPU, seeds 7-9:
# python tests/test_torch_1d_library_examples.py --routes; the largest
# readings 3.97e-13, 3.99e-8, 2.20e-8, 2.67e-8, 3.22e-13 and 6.59e-12 in
# this order; every other route reads 9.1e-14 or less)
LIB_ULP = {"stegoton sharpclaw": 4e-12, "shallow_1d roe sharpclaw": 4e-7,
           "shallow_1d hlle sharpclaw": 2.2e-7,
           "traffic_1d sharpclaw": 2.7e-7, "burgers_1d sharpclaw": 3.3e-12,
           "woodward_colella_blast sharpclaw": 6.6e-11}
# routes held to their plain version at an earlier t whose float64 run is
# also read against the plain version at the example's tfinal, reported
# and not gated: SharpClaw on the Brio-Wu tube, whose one-ulp readings
# grow from 5.2e-15 at t = 0.002 (where it is held, to 1e-12) through
# 2.5e-11 at t = 0.01 and 4.5e-8 at t = 0.02 to 6.4e-4 at t = 0.1 (seeds
# 7-16 at 0.02 and 0.1, 7-9 before)
LIB_REPORT_TFINAL = {"mhd_1d sharpclaw"}
# routes run in float64 alone: SharpClaw on the stegoton stalls in
# float32 (every attempt rejected from t = 0.33 .. 0.39 at nx = 120, its
# CFL infinite once a stage's reconstructed strain overflows exp), in the
# JAX package's plain path as in the port's (ROADMAP.md, Queue 3)
LIB_F64_ONLY = {"stegoton sharpclaw"}
# float32 against float64 at the example's tfinal (relative L1): the
# stegoton runs fork in roundoff (the CPU's plain path reads 2.6e-2 at
# nx = 1200) and so does SharpClaw on the Brio-Wu tube (the CPU's plain
# path and the card both read 1.03e-3: the float32 run takes 126 + 2
# steps to the float64 run's 125 + 1); the others read 3e-5 or less there
LIB_F32_L1 = {"stegoton classic": 0.1, "stegoton sharpclaw": 0.1,
              "mhd_1d sharpclaw": 3e-3}
LIB_F32_L1_DEFAULT = 1e-3
# the lake at rest (sill, perturb=0) after t = 0.4: max |q - q0|; the
# CPU's plain path reads 1.3e-6 in float32 and 1.5e-15 in float64
LIB_REST_TOL = {"float32": 1e-5, "float64": 1e-12}
# mass and strain conservation (periodic or walls; relative change of the
# sum): the CPU's plain path reads 1.8e-5 (the blast, float32), 3.5e-7
# (stegoton, float32) and 3.4e-14 or less in float64
LIB_CONS_TOL = {"float32": 1e-4, "float64": 1e-12}
# the annulus after one revolution: max |q - q0| / max q0, as the JAX
# package's own test (tests/test_mapped_grids.py) holds its 32x96 run
ANNULUS_RETURN_TOL = 0.35
# [4x]'s full-size run: stegoton at 2^20 cells (cells_per_layer 24, so
# dx and the step count are the example's), to t = 20; held against the
# plain version on the card at t = 1 (STEGOTON_CMP_T, before the fork)
STEGOTON_N = 2 ** 20
STEGOTON_CMP_T = 1.0
# the golden at nx = 600: the JAX package's run from its initial state
# moved by one ulp misses it by 0.00067 to 0.3383 of max|q| (seeds 7-36;
# tests/test_torch_1d_library_examples.py --seeds 30), so 1e-8 is no gate
# a run can be held to, and the max norm is reported only.  The card's run
# is held to what those readings keep tight: the relative L1 distance
# (0.00014 to 0.0877, rounded up) and the peak strain max q[0] (2.2347 to
# 2.2873, widened by 0.01; the golden's 2.2716), as the CPU test is
STEGOTON_GOLDEN_L1 = 0.09
STEGOTON_GOLDEN_PEAK = (2.22, 2.30)


@contextlib.contextmanager
def plain_wrappers():
    """Within the block, the kernel wrappers that the 1D and 2D classic
    and SharpClaw solvers call (ops.sweep.step1, ops.weno.weno5,
    ops.tiled2d.step2_rows_generic, ops.tiled2d.dq_rows) compute their
    plain PyTorch versions on any device: a route's plain version on the
    card."""
    from pyclaw_tpu_torch.classic import kernels
    from pyclaw_tpu_torch.limiters import recon
    from pyclaw_tpu_torch.ops import _build, sweep, tiled2d, weno
    from pyclaw_tpu_torch.sharpclaw import soa as sc_soa

    def step1(qbc, auxbc, dt, dx, rp, params, mthlim, order, fwave,
              index_capa, num_ghost=2, lib=None, out=None):
        return _build.plain_out(kernels.step1(
            qbc, auxbc, dt, dx, rp.rp, params, mthlim, order, fwave,
            index_capa, num_ghost), out)

    def weno5(q, lib=None):
        return recon.weno5(q)

    def step2_rows_generic(qbc, auxbc, dt, dx, dy, rp, params, mthlim,
                           order, fwave, index_capa, num_ghost=2,
                           transverse_waves=2, lib=None, out=None):
        return _build.plain_out(kernels.step2(
            qbc, auxbc, dt, dx, dy, rp.rp, rp.rpt, params, mthlim, order,
            fwave, index_capa, num_ghost, transverse_waves, rp.prefactor),
            out)

    def dq_rows(qbc, dt, dx, dy, params, weno_order=5, num_ghost=3,
                lib=None, rp=None):
        rp = rp if rp is not None else dq_weno_rp("euler_4wave_2D")
        return sc_soa.dq_2d_soa(qbc, dt, dx, dy, rp.rpn_soa, params,
                                weno_order, num_ghost,
                                positivity=rp.positivity,
                                flux_soa=rp.flux_soa)
    saved = (sweep.step1, weno.weno5, tiled2d.step2_rows_generic,
             tiled2d.dq_rows)
    (sweep.step1, weno.weno5, tiled2d.step2_rows_generic,
     tiled2d.dq_rows) = (step1, weno5, step2_rows_generic, dq_rows)
    try:
        yield
    finally:
        (sweep.step1, weno.weno5, tiled2d.step2_rows_generic,
         tiled2d.dq_rows) = saved


# the kernels whose wrappers plain_wrappers() stands in for
PLAIN_SWAPPED = ("step1", "weno5", "step2_aos", "dq2_weno5", "dq2_weno")


def kernel_and_plain(label, run, kernel):
    """``run()`` (a float64 path's Controller.run) on the kernels, then
    under :func:`plain_wrappers` (the route's plain version on the card),
    each through :func:`counted_run`.  Fails unless the first run launched
    ``kernel`` (None: a route of plain PyTorch) and the second launched
    none of PLAIN_SWAPPED, by the wrappers' counts and by the device
    counters, so that a lapse of the swap fails and does not compare the
    kernel with itself.  Returns ((claw, status, wall) of each run, the
    plain run's device counts)."""
    runs = []
    for within in (contextlib.nullcontext, plain_wrappers):
        claw, status, wall, counts, ran = counted_run(run, within)
        runs.append(((claw, status, wall), counts, ran))
    (k_run, _, k_ran), (p_run, p_counts, p_ran) = runs
    if kernel is not None and not k_ran[kernel] > 0:
        fail(f"{label}: the kernel run launched no {kernel}: {k_ran}")
    if any(p_counts[k] or p_ran[k] for k in PLAIN_SWAPPED):
        fail(f"{label}: the plain run launched a kernel: wrappers "
             f"{p_counts}, device {p_ran}")
    return k_run, p_run, p_ran


def lib_run(dev, module, dtype, tfinal=None, **kw):
    """:func:`run_example` to ``tfinal`` (None: the example's) in one
    frame."""
    return run_example(dev, module, dtype, tfinal,
                       tweak=lambda c: setattr(c, "num_output_times", 1),
                       **kw)


def initial_q(module, dtype, **kw):
    """q of examples.<module>'s initial state (a CPU array)."""
    import importlib
    ex = importlib.import_module(f"pyclaw_tpu_torch.examples.{module}")
    return ex.setup(outdir=None, device="cpu", dtype=dtype, **kw).solution.q


def lib_physics(label, module, tname, claw, q0):
    """What each example stands for, gated: MHD's Brio-Wu profile (rho,
    p > 0; By from +1 to -1), the blast's positivity and mass between its
    walls, the stegoton strain and the f-wave advection's kappa-weighted
    mass (periodic), the annulus back near its initial state after a
    revolution.  Returns the readings."""
    q = claw.solution.q.astype(np.float64)
    out = {}
    if module == "mhd_1d":
        rho, by = q[0], q[4]
        ke = 0.5 * (q[1] ** 2 + q[2] ** 2 + q[3] ** 2) / rho
        p = q[6] - ke - 0.5 * (0.75 ** 2 + by ** 2 + q[5] ** 2)
        out = {"rho_min": float(rho.min()), "p_min": float(p.min()),
               "by_ends": [float(by[0]), float(by[-1])]}
        if not (rho.min() > 0 and p.min() > 0 and by[0] > 0.99
                and by[-1] < -0.99):
            fail(f"[4x] {label} {tname}: Brio-Wu profile {out}")
    if module == "woodward_colella_blast":
        rho = q[0]
        p = 0.4 * (q[2] - 0.5 * q[1] ** 2 / rho)
        cons = abs(scalar_mass(q) - scalar_mass(q0)) / abs(scalar_mass(q0))
        out = {"rho_min": float(rho.min()), "p_min": float(p.min()),
               "mass_change": cons}
        if not (rho.min() > 0 and p.min() > 0
                and cons <= LIB_CONS_TOL[tname]):
            fail(f"[4x] {label} {tname}: positivity or mass {out}")
    if module == "stegoton_1d" or label.endswith("capacity fwave"):
        aux = claw.solution.state.aux
        kappa = aux[1].astype(np.float64) if label.endswith("fwave") \
            else None
        cons = abs(scalar_mass(q, kappa) - scalar_mass(q0, kappa)) \
            / float(np.sum(np.abs(q0[0] if kappa is None else q0[0] * kappa)))
        out["mass_change"] = cons
        if not cons <= LIB_CONS_TOL[tname]:
            fail(f"[4x] {label} {tname}: the conserved sum moved by {cons}")
    if module == "advection_2d_annulus":
        err = float(np.abs(q[0] - q0[0]).max() / q0[0].max())
        out["return_err"] = err
        if not err < ANNULUS_RETURN_TOL:
            fail(f"[4x] {label} {tname}: {err} from the initial state")
    return out


def library_routes(dev):
    """[4x]: every new example on each route at its own size to its own
    tfinal, float32 and float64, each with every launch count set to 0
    just before it and read just after (the kernel's launches per
    attempted step times the attempts); the float64 run against the same
    route's plain version on the card (:func:`kernel_and_plain`: the plain
    run launches none of the kernels it stands in for) at the route's
    compared t, equal steps, q to LIB_ULP or 1e-12 of max|q|, and for
    LIB_REPORT_TFINAL at the example's tfinal too, reported; float32
    against float64 (relative L1); each example's physics
    (:func:`lib_physics`); and the sill's lake at rest."""
    out = {}
    for label, module, kw, kernel, per, t_cmp in LIB_ROUTES:
        rec = {}
        qs = {}
        types = (("float64", np.float64),) if label in LIB_F64_ONLY else (
            ("float32", np.float32), ("float64", np.float64))
        for tname, dtype in types:

            def run(dtype=dtype):
                return lib_run(dev, module, dtype, **kw)
            claw, status, wall, counts, ran = counted_run(run)
            ns, nr = status["numsteps"], status["numrejected"]
            loop = check_path_launches(f"[4x] {label} {tname}", claw, status,
                                       counts, kernel, per, ran=ran)
            q = claw.solution.q
            q0 = initial_q(module, dtype, **kw)
            if not (np.all(np.isfinite(q)) and q.shape == q0.shape
                    and abs(claw.solution.t - claw.tfinal) <= 1e-12):
                fail(f"[4x] {label} {tname}: q {q.shape} finite "
                     f"{np.all(np.isfinite(q))} t {claw.solution.t}")
            phys = lib_physics(label, module, tname, claw, q0)
            qs[tname] = q.astype(np.float64)
            rec[tname] = {"accepted": ns, "rejected": nr,
                          "wall_s_counted": wall, "launches": ran,
                          "wrapper_counts": counts, "loop": loop,
                          "t": claw.solution.t, **phys}
            print(f"[4x] {label} {tname} {q.shape} to t={claw.solution.t}: "
                  f"{ns} + {nr} steps, {ran.get(kernel, 0) if kernel else 0}"
                  f" {kernel} launches the card ran ({per} x attempts; "
                  f"{ran}), {wall:.3f} s wall; {phys}", flush=True)
            del claw
        l1 = (0.0 if "float32" not in qs else
              float(np.mean(np.abs(qs["float32"] - qs["float64"]))
                    / np.mean(np.abs(qs["float64"]))))
        l1_tol = LIB_F32_L1.get(label, LIB_F32_L1_DEFAULT)
        rec["f32_vs_f64_l1"] = l1
        # the float64 run against the route's plain version on the card
        (ck, sk, wk), (cp, sp, wp), p_ran = kernel_and_plain(
            f"[4x] {label} vs plain",
            lambda: lib_run(dev, module, np.float64, t_cmp, **kw), kernel)
        qk, nk, rk, tk = (ck.solution.q, sk["numsteps"], sk["numrejected"],
                          ck.solution.t)
        qp, np_, rp_, tp = (cp.solution.q, sp["numsteps"],
                            sp["numrejected"], cp.solution.t)
        rel = float(np.abs(qk - qp).max() / np.abs(qp).max())
        tol = LIB_ULP.get(label, 1e-12)
        rec["vs_plain"] = {"t": tk, "max_rel": rel, "tol": tol,
                           "steps": [nk, rk], "plain_steps": [np_, rp_],
                           "wall_s": wk, "plain_wall_s": wp,
                           "plain_launches": p_ran}
        print(f"    {label}: float32 vs float64 rel L1 {l1:.3e} (tol "
              f"{l1_tol}); float64 against its plain version on the card "
              f"to t={tk}: max rel {rel:.3e} (tol {tol}), steps {nk} + {rk}"
              f" vs {np_} + {rp_}, wall {wk:.3f} s vs {wp:.3f} s; the plain"
              f" run's launches {p_ran}", flush=True)
        if label in LIB_REPORT_TFINAL:
            with plain_wrappers():
                cf, _, _ = lib_run(dev, module, np.float64, **kw)
            rep = float(np.abs(qs["float64"] - cf.solution.q).max()
                        / np.abs(cf.solution.q).max())
            rec["vs_plain_tfinal_report"] = {"t": cf.solution.t,
                                             "max_rel": rep}
            print(f"    {label}: float64 against its plain version at "
                  f"t={cf.solution.t}: max rel {rep:.3e} (reported, not "
                  f"gated)", flush=True)
        if not (l1 <= l1_tol and rel <= tol and (nk, rk) == (np_, rp_)
                and tk == tp):
            fail(f"[4x] {label}: {rec}")
        out[label] = rec
    # the sill's lake at rest: zero fluctuations, so q stays as it was
    rest = {}
    for tname, dtype in (("float32", np.float32), ("float64", np.float64)):
        claw, st, w = lib_run(dev, "sill", dtype, perturb=0.0)
        q0 = initial_q("sill", dtype, perturb=0.0)
        move = float(np.abs(claw.solution.q.astype(np.float64)
                            - q0.astype(np.float64)).max())
        rest[tname] = {"steps": st["numsteps"], "max_move": move}
        print(f"[4x] sill lake at rest {tname}: {st['numsteps']} steps to "
              f"t={claw.solution.t}, max |q - q0| {move:.3e} (tol "
              f"{LIB_REST_TOL[tname]})", flush=True)
        if not move <= LIB_REST_TOL[tname]:
            fail(f"[4x] sill lake at rest {tname}: {move}")
    out["sill_lake_at_rest"] = rest
    return out


def stegoton_full(dev, n=STEGOTON_N):
    """[4x]: stegoton_1d classic (psystem_1D, f-waves, van Leer, periodic
    aux) at n cells on the device loop to t = 20, float32 and float64,
    every launch count set to 0 just before each run and read just after;
    finite; the strain's sum conserved to LIB_CONS_TOL; float32 against
    float64 (relative L1, LIB_F32_L1); the float64 run against its plain
    version on the card to STEGOTON_CMP_T (1e-12); launches a step by the
    device counters, and the busy share of a profiled run to t = 1."""
    out = {}
    qs = {}
    for tname, dtype in (("float32", np.float32), ("float64", np.float64)):
        claw, status, wall, counts, ran = counted_run(
            lambda dtype=dtype: lib_run(dev, "stegoton_1d", dtype, nx=n))
        ns, nr = status["numsteps"], status["numrejected"]
        loop = check_path_launches(f"[4x] stegoton {n} {tname}", claw,
                                   status, counts, "step1", 1, ran=ran)
        q = claw.solution.q
        q0 = initial_q("stegoton_1d", dtype, nx=n)
        cons = (abs(scalar_mass(q) - scalar_mass(q0))
                / float(np.sum(np.abs(q0[0]))))
        attempts = loop["attempts"]
        rec = {"accepted": ns, "rejected": nr, "wall_s_counted": wall,
               "launches": ran, "wrapper_counts": counts, "loop": loop,
               "launches_per_attempt": {k: v / attempts
                                        for k, v in ran.items()},
               "strain_change": cons,
               "cell_updates_per_s": ns * n / wall}
        print(f"[4x] stegoton classic {n} {tname} to t={claw.solution.t}: "
              f"{ns} + {nr} steps, {wall:.3f} s wall with the device "
              f"counters ({ns * n / wall:.4g} cell updates/s), launches a "
              f"step {rec['launches_per_attempt']}; strain change {cons:.3e}"
              f" (tol {LIB_CONS_TOL[tname]})", flush=True)
        if not (np.all(np.isfinite(q)) and q.shape == (2, n)
                and abs(claw.solution.t - 20.0) <= 1e-12
                and cons <= LIB_CONS_TOL[tname]):
            fail(f"[4x] stegoton {n} {tname}: {rec}")
        qs[tname] = q.astype(np.float64)
        out[tname] = rec
        del claw
    l1 = float(np.mean(np.abs(qs["float32"] - qs["float64"]))
               / np.mean(np.abs(qs["float64"])))
    out["f32_vs_f64_l1"] = l1
    k_run, p_run, p_ran = kernel_and_plain(
        f"[4x] stegoton {n} vs plain",
        lambda: lib_run(dev, "stegoton_1d", np.float64, STEGOTON_CMP_T,
                        nx=n), "step1")
    runs = {which: (c.solution.q, (st["numsteps"], st["numrejected"]), w)
            for which, (c, st, w) in (("kernel", k_run), ("plain", p_run))}
    rel = float(np.abs(runs["kernel"][0] - runs["plain"][0]).max()
                / np.abs(runs["plain"][0]).max())
    out["vs_plain"] = {"t": STEGOTON_CMP_T, "max_rel": rel,
                       "steps": runs["kernel"][1],
                       "plain_steps": runs["plain"][1],
                       "wall_s": runs["kernel"][2],
                       "plain_wall_s": runs["plain"][2],
                       "plain_launches": p_ran}
    print(f"    stegoton {n}: float32 vs float64 rel L1 {l1:.3e} (tol "
          f"{LIB_F32_L1['stegoton classic']}); float64 against its plain "
          f"version on the card to t={STEGOTON_CMP_T}: max rel {rel:.3e} "
          f"(tol 1e-12), steps {runs['kernel'][1]} vs {runs['plain'][1]}, "
          f"wall {runs['kernel'][2]:.3f} s vs {runs['plain'][2]:.3f} s; the "
          f"plain run's launches {p_ran}", flush=True)
    if not (l1 <= LIB_F32_L1["stegoton classic"] and rel <= 1e-12
            and runs["kernel"][1] == runs["plain"][1]):
        fail(f"[4x] stegoton {n}: {out}")
    out["profile"] = profile_main_path(
        f"[4x] stegoton classic {n} f32 to t=1.0",
        lambda: lib_run(dev, "stegoton_1d", np.float32, 1.0, nx=n))
    return out


def stegoton_golden_card(dev):
    """[4x]: stegoton_1d at nx = 600 in float64 on the card (its own
    frames, as the golden was made) against tests/golden/stegoton_1d.npz:
    the relative L1 distance to STEGOTON_GOLDEN_L1 and the peak strain
    within STEGOTON_GOLDEN_PEAK, the max norm reported (the run is chaotic
    in roundoff: the JAX package's own one-ulp moves miss it by up to 0.34
    of max|q|); t equal."""
    from pyclaw_tpu_torch.examples import stegoton_1d
    ref = np.load(os.path.join(ROOT, "tests", "golden", "stegoton_1d.npz"))
    claw = stegoton_1d.setup(nx=600, outdir=None, device=dev,
                             dtype=np.float64)
    st = claw.run()
    rel = float(np.abs(claw.solution.q - ref["q"]).max()
                / np.abs(ref["q"]).max())
    l1 = float(np.mean(np.abs(claw.solution.q - ref["q"]))
               / np.mean(np.abs(ref["q"])))
    peak = float(claw.solution.q[0].max())
    lo, hi = STEGOTON_GOLDEN_PEAK
    print(f"[4x] golden stegoton_1d float64: rel L1 {l1:.3e} (tol "
          f"{STEGOTON_GOLDEN_L1}), peak strain {peak:.6f} (within {lo} .. "
          f"{hi}; the golden's {float(ref['q'][0].max()):.6f}), max rel err "
          f"{rel:.3e} (reported: the JAX package's one-ulp readings reach "
          f"0.34; 1e-8 holds no run but the JAX package's unmoved one), "
          f"{st['numsteps']} + {st['numrejected']} steps, t "
          f"{claw.solution.t}", flush=True)
    if not (l1 <= STEGOTON_GOLDEN_L1 and lo <= peak <= hi
            and abs(claw.solution.t - float(ref["t"])) <= 1e-10):
        fail(f"[4x] golden stegoton_1d: rel L1 {l1}, peak {peak}, t "
             f"{claw.solution.t}")
    return {"rel_err": rel, "rel_l1": l1, "peak_strain": peak,
            "l1_tol": STEGOTON_GOLDEN_L1, "peak_range": [lo, hi],
            "steps": [st["numsteps"], st["numrejected"]]}


def library_phase(dev):
    """[4x]: stegoton at 2^20 (f32, f64), its golden, every new example on
    each route; the seconds of each part."""
    out, secs = {}, {}
    for key, fn in (("stegoton_full", stegoton_full),
                    ("stegoton_golden", stegoton_golden_card),
                    ("routes", library_routes)):
        t0 = time.perf_counter()
        out[key] = fn(dev)
        secs[key] = time.perf_counter() - t0
    out["seconds"] = secs
    print(f"[4x] seconds: {secs}", flush=True)
    return out


# ---- [4y]: the other SharpClaw options: WENO orders 7-17 on dq2_weno.cu,
# the RK and multistep integrators, lim_type 0/1 and tfluct ----------------

def dq_weno_entry(order, name, tname):
    """The entry of csrc/dq2_weno.cu: dq2_weno<order>[_acoustics|_euler5]
    _f32|f64."""
    from pyclaw_tpu_torch.ops import tiled2d
    return (tiled2d.dq_weno_entry(name, order)
            + ("_f32" if tname == "float32" else "_f64"))


# Operations per cell of one dq of csrc/dq2_weno.cu, counted as
# FLOPS_PER_CELL_DQ is, at the least the function needs.  The WENO of
# order 2K-1 of one component along one direction (weno_edges): K betas,
# each the quadratic form v^T B v of a symmetric B, as w_a = sum_{c>=a}
# B'_ac v_c (B' = 2B off the diagonal) and then sum_a v_a w_a (K^2 + 2K -
# 1); per stencil the eps add, the square and the reciprocal, which both
# edges share (3K); per edge K candidate values of K terms (K (2K - 1)),
# the weights d_l / (eps + beta_l)^2 (K products), num (K products, K - 1
# adds), den (K - 1 adds) and the division (1): 2K^2 + 3K - 1.  float32
# adds the normalisation (K adds, a reciprocal, K products: 2K + 1).
# Everything else is dq2_weno5.cu's, whose counts hold WENO5 as 109 (f32)
# / 98 (f64) operations a component and direction: per direction Euler
# 4-wave 672 / 624 less 4 x that, acoustics 379 / 346 less 3 x, Euler
# 5-wave 820 / 761 less 5 x; the sum of the two parts NEQ.
WENO5_COMPONENT_OPS = {"float32": 109, "float64": 98}
DQ_REST_PER_DIR = {
    "euler_4wave_2D": {"float32": 672 - 4 * 109, "float64": 624 - 4 * 98},
    "acoustics_2D": {"float32": 379 - 3 * 109, "float64": 346 - 3 * 98},
    "euler_5wave_2D": {"float32": 820 - 5 * 109, "float64": 761 - 5 * 98}}


def weno_component_ops(k, tname):
    ops = (k * (k * k + 2 * k - 1) + 3 * k
           + 2 * (k * (2 * k - 1) + 4 * k - 1))
    return ops + (2 * k + 1 if tname == "float32" else 0)


def flops_per_cell_dq_weno(name, order, tname):
    k = (order + 1) // 2
    neq = dq_weno_rp(name).num_eqn
    return (2 * (neq * weno_component_ops(k, tname)
                 + DQ_REST_PER_DIR[name][tname]) + neq)


# The operations csrc/dq2_weno.cu issues a cell under the plain version's
# arithmetic (limiters/recon.py:weno_stencil, which the kernel repeats
# operation for operation, built without contraction): per component and
# direction K betas over the full K x K form, a product by the
# coefficient, a product by the value and an add for each of its K^3
# nonzero entries (3K^3); per edge and stencil the candidate value (K
# products, K adds), eps + beta, its square, the reciprocal, the product
# by d, num's product and add and den's add (2K + 7), and the edge's
# division; float32's normalisation (K + 1 adds, a reciprocal, K
# products); the rest as flops_per_cell_dq_weno.  Each operation issues
# on its own, so the card's peak (an FMA counted as two) halves for it:
# ceiling_ms is the least time under this arithmetic.
def issued_ops_per_cell_dq_weno(name, order, tname):
    k = (order + 1) // 2
    neq = dq_weno_rp(name).num_eqn
    weno = (3 * k ** 3 + 2 * (k * (2 * k + 7) + 1)
            + (2 * k + 2 if tname == "float32" else 0))
    return 2 * (neq * weno + DQ_REST_PER_DIR[name][tname]) + neq


def ceiling_ms_dq_weno(name, order, tname, cells):
    """The least ms of one dq of an instance of csrc/dq2_weno.cu over
    ``cells`` cells under the plain version's arithmetic: its issued
    operations at half the card's peak (PEAK_FLOPS counts an FMA as
    two)."""
    return (issued_ops_per_cell_dq_weno(name, order, tname) * cells
            / (PEAK_FLOPS[tname] / 2) * 1e3)


def dq_weno_resources(tiled2d, report):
    """{entry: {"threads", "smem_bytes", "blocks_per_sm", "registers",
    "stack", "spill_stores", "spill_loads"}} of each instance of
    csrc/dq2_weno.cu on this card: its threads and shared memory a block
    and resident blocks per SM (the entries of the build), its registers,
    stack frame and spill bytes (``report``, the build's ptxas report);
    fails when one takes no block or the report lacks one."""
    import ctypes
    lib = tiled2d._dq_weno_lib()
    for fn in (lib.dq2_weno_blocks_per_sm, lib.dq2_weno_threads):
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_int
    ptxas = {dq_weno_instance(fn): rec
             for fn, rec in ptxas_resources(report).items()
             if dq_weno_instance(fn) is not None}
    out = {}
    for order in WENO_ORDERS:
        for name in DQ_WENO_SYSTEMS:
            sys_id = tiled2d.DQ_SYSTEMS[name][2]
            for d, tname in enumerate(("float32", "float64")):
                rec = ptxas.get((name, order, tname), {})
                out[dq_weno_entry(order, name, tname)] = {
                    "threads": lib.dq2_weno_threads(sys_id, order, d),
                    "smem_bytes": lib.dq2_weno_smem_bytes(sys_id, order, d),
                    "blocks_per_sm": lib.dq2_weno_blocks_per_sm(sys_id,
                                                                order, d),
                    **{key: rec.get(key) for key in (
                        "registers", "stack", "spill_stores",
                        "spill_loads")}}
    if any(r["blocks_per_sm"] < 1 for r in out.values()):
        fail(f"a dq2_weno instance takes no block on an SM: {out}")
    # (a build that load_all found current has no report)
    if report != "(cached build)" and any(
            r["registers"] is None or r["stack"] is None
            for r in out.values()):
        fail(f"the ptxas report lacks a dq2_weno instance: {out}")
    return out


def step2_aos_euler_resources(lib_aos, report):
    """{(system, type name): {"threads", "smem_bytes", "launch_bound",
    "blocks_per_sm", "registers", "stack", "spill_stores",
    "spill_loads"}} of csrc/step2_aos.cu's Euler instances without
    capacity or f-waves (those of the paths) on this card: threads, shared
    memory a block, the launch bound and the resident blocks per SM (the
    entries of the build), registers, stack frame and spill bytes
    (``report``, the build's ptxas report); and the worst stack and spill
    bytes of all their capacity and f-wave variants under the key
    "variants".  Fails when one takes no block or the report lacks one."""
    from pyclaw_tpu_torch.ops import tiled2d
    ptxas = {step2_aos_instance(fn): rec
             for fn, rec in ptxas_resources(report).items()
             if step2_aos_instance(fn) is not None}
    out = {}
    for name in ("euler_4wave_2D", "euler_5wave_2D"):
        sid = tiled2d.AOS_SYSTEMS[name][0]
        for d, tname in enumerate(("float32", "float64")):
            rec = ptxas.get((name, tname, False, False), {})
            out[(name, tname)] = {
                "threads": lib_aos.step2_aos_threads(),
                "smem_bytes": lib_aos.step2_aos_smem_bytes(sid, 0, d),
                "launch_bound": lib_aos.step2_aos_system_blocks_per_sm(
                    sid, d),
                "blocks_per_sm": lib_aos.step2_aos_system_resident_blocks(
                    sid, d),
                **{key: rec.get(key) for key in (
                    "registers", "stack", "spill_stores", "spill_loads")}}
    if any(r["blocks_per_sm"] < 1 for r in out.values()):
        fail(f"a step2_aos Euler instance takes no block on an SM: {out}")
    # (a build that load_all found current has no report)
    if report != "(cached build)":
        if len(ptxas) != 16 or any(r["registers"] is None
                                   for r in out.values()):
            fail(f"the ptxas report lacks a step2_aos Euler instance: "
                 f"{sorted(ptxas)}")
        out["variants"] = {key: max(r.get(key) or 0 for r in ptxas.values())
                           for key in ("stack", "spill_stores",
                                       "spill_loads")}
    return out


def redesigned_resources(dq_lib, lib_3a, dq_report, s3_report):
    """[2]: the instances with a configuration of their own,
    dq2_weno5.cu's Euler 5-wave instance and step3_aos.cu's burgers_3D
    (each capacity and f-wave variant), on this card:
    {(kernel, system, type name[, capa, fwave]): {"threads",
    "smem_bytes", "blocks_per_sm", "registers", "stack", "spill_stores",
    "spill_loads"}}, the registers, stack frame and spill bytes from the
    builds' ptxas reports.  Fails when one takes no block or a report
    lacks one."""
    from pyclaw_tpu_torch.ops import tiled2d
    dq_ptxas = {dq2_weno5_instance(fn): rec
                for fn, rec in ptxas_resources(dq_report).items()
                if dq2_weno5_instance(fn) is not None}
    s3_ptxas = {step3_aos_instance(fn): rec
                for fn, rec in ptxas_resources(s3_report).items()
                if step3_aos_instance(fn) is not None}
    keys = ("registers", "stack", "spill_stores", "spill_loads")
    out = {}
    for d, tname in enumerate(("float32", "float64")):
        rec = dq_ptxas.get(("euler_5wave_2D", tname), {})
        out[("dq2_weno5", "euler_5wave_2D", tname)] = {
            "threads": dq_lib.dq2_weno5_euler5_threads(d),
            "smem_bytes": dq_lib.dq2_weno5_euler5_smem_bytes(d),
            "blocks_per_sm": dq_lib.dq2_weno5_euler5_blocks_per_sm(d),
            **{k: rec.get(k) for k in keys}}
        sid = tiled2d.STEP3_SYSTEMS["burgers_3D"][0]
        for capa in (False, True):
            for fwave in (False, True):
                rec = s3_ptxas.get(("burgers_3D", tname, capa, fwave), {})
                out[("step3_aos", "burgers_3D", tname, capa, fwave)] = {
                    "threads": lib_3a.step3_aos_system_threads(sid, d),
                    "smem_bytes": lib_3a.step3_aos_smem_bytes(sid,
                                                              int(capa), d),
                    "blocks_per_sm": lib_3a.step3_aos_system_blocks_per_sm(
                        sid, int(capa), int(fwave), d),
                    **{k: rec.get(k) for k in keys}}
    if any(r["blocks_per_sm"] < 1 for r in out.values()):
        fail(f"a redesigned instance takes no block on an SM: {out}")
    # (a build that load_all found current has no report)
    if "(cached build)" not in (dq_report, s3_report) and any(
            r["registers"] is None or r["stack"] is None
            for r in out.values()):
        fail(f"a ptxas report lacks a redesigned instance: {out}")
    return out


def compare_dq_weno(dev):
    """[4y]: one dq of each of dq2_weno.cu's 36 instances against
    sharpclaw/soa.py:dq_2d_soa at its order on the card, at 1024^2 (Euler
    5-wave 2048x512) on a seeded admissible state and at 250x171 (ragged)
    on a state that takes the positivity fallback: TOL_REL (1e-12 in
    float64, 1e-5 in float32), the CFL equal bit for bit.  Returns
    ({entry: its max abs err on the 1024^2 state}, {entry: its max rel
    err on each state}, worst rel err per type, cases, bit-equal
    cases)."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.sharpclaw import soa as sc_soa
    abs_err, rel_err = {}, {}
    worst = {"float32": 0.0, "float64": 0.0}
    ncase = nbits = 0
    for order in WENO_ORDERS:
        k = (order + 1) // 2
        for name in DQ_WENO_SYSTEMS:
            rp, params = dq_weno_rp(name), dq_weno_params(name)
            for tname in ("float32", "float64"):
                for big in (True, False):
                    qbc, dt, dx, dy = dq_weno_case(name, order, tname, dev,
                                                   big)
                    dk, ck = tiled2d.dq_rows(qbc, dt, dx, dy, params, order,
                                             k, rp=rp)
                    dp, cp = sc_soa.dq_2d_soa(
                        qbc, dt, dx, dy, rp.rpn_soa, params, order, k,
                        positivity=rp.positivity, flux_soa=rp.flux_soa)
                    torch.cuda.synchronize()
                    err = float((dk - dp).abs().max())
                    rel = err / float(dp.abs().max())
                    nfall = (0 if big or rp.positivity is None else
                             sc_soa.fallback_count(qbc, params,
                                                   rp.positivity, order))
                    label = (f"[4y] {dq_weno_entry(order, name, tname)} "
                             f"{tuple(qbc.shape)}")
                    if not (np.isfinite(rel) and rel <= TOL_REL[tname]
                            and float(ck) == float(cp)
                            and dk.shape == (rp.num_eqn,) + tuple(
                                s - 2 * k for s in qbc.shape[1:])):
                        fail(f"{label} vs plain: rel err {rel:.3e}, cfl "
                             f"{float(ck)!r} vs {float(cp)!r}")
                    if not big and rp.positivity is not None and nfall == 0:
                        fail(f"{label}: no cell fell back")
                    worst[tname] = max(worst[tname], rel)
                    nbits += bool(torch.equal(dk, dp))
                    ncase += 1
                    entry = dq_weno_entry(order, name, tname)
                    rel_err.setdefault(entry, {})[
                        "1024" if big else "ragged"] = rel
                    if big:
                        abs_err[entry] = err
    print(f"[4y] dq2_weno vs plain: {ncase} cases (36 instances, 1024^2 "
          f"and a ragged 250x171 state with fallbacks), max rel err f32 "
          f"{worst['float32']:.3e}, f64 {worst['float64']:.3e}, the CFL "
          f"equal in every case, {nbits} bit-equal", flush=True)
    return abs_err, rel_err, worst, ncase, nbits


def perturbed(claw):
    """Move a Controller's initial state by one ulp (relative, seeded)."""
    state = claw.solution.state
    r = np.random.default_rng(11).uniform(-1.0, 1.0, state.q.shape)
    state.q = (state.q * (1.0 + np.finfo(state.q.dtype).eps * r)).astype(
        state.q.dtype)


def solver_tweak(perturb=False, **attrs):
    """A run_example tweak: one output frame, the solver's ``attrs`` set
    after setup, and with ``perturb`` the initial state moved by one
    ulp."""
    def tweak(claw):
        claw.num_output_times = 1
        for key, val in attrs.items():
            setattr(claw.solver, key, val)
        if perturb:
            perturbed(claw)
    return tweak


def quadrants_opts(dev, n, dtype, tfinal, perturb=False, **attrs):
    """(claw, status, wall) of the SharpClaw quadrants at n^2 to tfinal
    in one frame with the solver's ``attrs`` set after setup."""
    return run_example(dev, "euler_2d_quadrants", dtype, tfinal,
                       tweak=solver_tweak(perturb, **attrs), mx=n, my=n,
                       solver_type="sharpclaw")


def held_to_plain(label, run, kernel, tol=None):
    """``run()`` (a float64 path's Controller.run: (claw, status, wall))
    on the kernels and under :func:`plain_wrappers` (kernel_and_plain):
    the same steps, and q within ``tol`` of max|q|.  With ``tol`` None
    the run is conditioned (a one-ulp move of its initial state moves its
    plain version by more than 1e-12: ROADMAP.md Queue 3) and the
    distance is a reading only.  Returns the readings."""
    (kc, ks, _), (pc, ps, _), _ = kernel_and_plain(label, run, kernel)
    steps = (ks["numsteps"], ks["numrejected"])
    if steps != (ps["numsteps"], ps["numrejected"]):
        fail(f"{label}: kernel {steps} steps, plain "
             f"{(ps['numsteps'], ps['numrejected'])}")
    q_p = pc.solution.q
    rel = float(np.abs(kc.solution.q - q_p).max() / np.abs(q_p).max())
    if tol is not None and not rel <= tol:
        fail(f"{label}: the kernel run is {rel:.3e} from the plain run "
             f"(tol {tol:.1e})")
    print(f"{label}: {steps[0]} + {steps[1]} steps, kernel vs plain max rel "
          f"{rel:.3e} ("
          + ("a conditioned run: a reading" if tol is None
             else f"tol {tol:.1e}") + ")", flush=True)
    return {"steps": steps, "vs_plain_max_rel": rel, "tol": tol}


def smooth_euler(claw):
    """Make a quadrants Controller periodic, from a smooth Euler state: a
    density wave rho = 1 + 0.2 sin 2 pi (x + 2y) carried at (u, v) =
    (0.5, -0.3), p = 1.  No stencil is constant, so no beta is a
    cancellation and a one-ulp move of the state moves the run by about
    1e-15 at WENO orders 5, 7 and 17 (the CPU's plain path at 48^2)."""
    import pyclaw_tpu_torch as pyclaw
    claw.solver.all_bcs = pyclaw.BC.periodic
    state = claw.solution.state
    x, y = claw.solution.domain.grid.c_centers
    rho = 1.0 + 0.2 * np.sin(2.0 * np.pi * (x + 2.0 * y))
    u, v, p = 0.5, -0.3, 1.0
    state.q = np.stack([rho, rho * u, rho * v,
                        p / 0.4 + 0.5 * rho * (u * u + v * v)]).astype(
        state.q.dtype)


def smooth_opts(dev, n, tfinal, **attrs):
    """(claw, status, wall) of SharpClaw on :func:`smooth_euler`'s wave at
    n^2 in float64 to ``tfinal`` in one frame, the solver's ``attrs`` set
    after setup."""
    def tweak(claw):
        smooth_euler(claw)
        solver_tweak(**attrs)(claw)
    return run_example(dev, "euler_2d_quadrants", np.float64, tfinal,
                       tweak=tweak, mx=n, my=n, solver_type="sharpclaw")


def smooth_paths(dev, n=128, tfinal=0.01):
    """[4y]: :func:`smooth_euler`'s wave at n^2 in float64 to ``tfinal``
    from dt 1e-3, on the kernels and on their plain versions on the card,
    held to 1e-12 of max|q| with the same steps (held_to_plain, gated):
    SSP104 at WENO orders 7 and 17 (dq2_weno7_f64, dq2_weno17_f64), and
    WENO5 (dq2_weno5) with each integrator of INTEGRATOR_RUNS."""
    out = {}
    for order in (7, 17):
        out[f"weno{order}"] = held_to_plain(
            f"[4y] smooth wave weno{order} {n}^2 f64 to t={tfinal}",
            lambda order=order: smooth_opts(
                dev, n, tfinal, weno_order=order, dt_initial=1e-3),
            "dq2_weno", 1e-12)
    for label, (integrator, attrs) in INTEGRATOR_RUNS.items():
        kw = dict({"dt_initial": 1e-3}, **attrs, time_integrator=integrator)
        out[label] = held_to_plain(
            f"[4y] smooth wave {label} {n}^2 f64 to t={tfinal}",
            lambda kw=kw: smooth_opts(dev, n, tfinal, **kw),
            "dq2_weno5", 1e-12)
    return out


def weno7_path(dev, n=1024):
    """[4y]: the quadrants with SharpClaw at WENO order 7 at n^2 in float32
    (SSP104, the SoA route: dq2_weno7, 10 launches an attempted step, no
    dq2_weno5) through Controller.run() to t=0.8 on the device loop, every
    launch count set to 0 just before it and read just after; its profile
    to t=0.1; the float64 run at 256^2 to t=0.02 against its plain
    version on the card (from dt 1e-3: the default first attempt at dt
    0.1 is rejected after blowing up), a conditioned run (piecewise-
    constant data, ROADMAP.md Queue 3): equal steps gated, the distance
    a reading; smooth_paths gates the instance at 1e-12."""
    claw, status, wall, counts, ran = counted_run(
        lambda: quadrants_opts(dev, n, np.float32, 0.8, weno_order=7))
    ns, nr = status["numsteps"], status["numrejected"]
    loop = check_path_launches("[4y] quadrants weno7", claw, status, counts,
                               "dq2_weno", 10, ran=ran)
    q = claw.solution.q
    if (q.shape != (4, n, n) or not np.all(np.isfinite(q))
            or not claw.solution.state.is_valid()
            or abs(claw.solution.t - 0.8) > 1e-12 or ran["dq2_weno5"]):
        fail(f"[4y] quadrants weno7: q {q.shape} finite "
             f"{np.all(np.isfinite(q))}, t {claw.solution.t}, dq2_weno5 "
             f"{ran['dq2_weno5']}")
    per_step = (ran["dq2_weno"] + ran["restore"]) / max(1, loop["attempts"])
    print(f"[4y] quadrants weno7 {n}^2 f32 SSP104 to t={claw.solution.t}: "
          f"{ns} accepted + {nr} rejected steps, {ran['dq2_weno']} dq2_weno7 "
          f"launches the card ran ({ran}; the wrappers' counts {counts}), "
          f"{per_step:.2f} launches of the port's kernels an attempt, "
          f"{wall:.3f} s wall with the device counters; device loop {loop}",
          flush=True)
    prof = profile_main_path(
        f"[4y] quadrants weno7 {n}^2 f32 to t=0.1",
        lambda: quadrants_opts(dev, n, np.float32, 0.1, weno_order=7))
    f64 = held_to_plain(
        "[4y] quadrants weno7 256^2 f64 to t=0.02 from dt 1e-3",
        lambda: quadrants_opts(dev, 256, np.float64, 0.02, weno_order=7,
                               dt_initial=1e-3), "dq2_weno")
    return {"accepted": ns, "rejected": nr, "wall_s_counted": wall,
            "launches": ran, "wrapper_counts": counts, "loop": loop,
            "launches_an_attempt": per_step, "profile": prof, "f64": f64}


def instance_paths(dev):
    """[4y]: each instance of dq2_weno.cu on a short path of its system
    through Controller.run() on the device loop (SSP104, the example's
    first state): the quadrants (Euler 4-wave) and examples.acoustics_2d
    at 128^2, examples.shock_bubble's SharpClaw route (Euler 5-wave) at
    128x32, each order in float32 and float64, every launch count set to
    0 just before each run and read just after (dq2_weno 10 an attempted
    step).  A run that ends non-finite must do so on its plain version
    on the card too, with the same steps: the float32 rule of the
    generic-order WENO (limiters/recon.py:weno_stencil, the JAX
    package's) can lose eps + beta to cancellation on near-constant data
    (ROADMAP.md, Queue 3), and the kernel repeats it.  Returns ({entry:
    the launches the card ran}, {entry: the non-finite values of such a
    run and of its plain run})."""
    runs = {"euler_4wave_2D": ("euler_2d_quadrants", 0.02,
                               dict(mx=128, my=128, solver_type="sharpclaw")),
            "acoustics_2D": ("acoustics_2d", 0.02,
                             dict(mx=128, my=128, solver_type="sharpclaw")),
            "euler_5wave_2D": ("shock_bubble", 0.02,
                               dict(mx=128, my=32, solver_type="sharpclaw"))}
    out, nonfinite = {}, {}
    for order in WENO_ORDERS:
        for name, (module, tfinal, kw) in runs.items():
            for tname, dtype in (("float32", np.float32),
                                 ("float64", np.float64)):
                entry = dq_weno_entry(order, name, tname)

                def run():
                    return run_example(dev, module, dtype, tfinal,
                                       tweak=solver_tweak(weno_order=order),
                                       **kw)
                claw, status, _, counts, ran = counted_run(run)
                check_path_launches(f"[4y] {entry} on {module}", claw,
                                    status, counts, "dq2_weno", 10, ran=ran)
                out[entry] = ran["dq2_weno"]
                q = claw.solution.q
                if np.all(np.isfinite(q)):
                    continue
                with plain_wrappers():
                    pc, ps, _ = run()
                if (np.all(np.isfinite(pc.solution.q))
                        or (ps["numsteps"], ps["numrejected"])
                        != (status["numsteps"], status["numrejected"])):
                    fail(f"[4y] {entry} on {module}: q not finite, its "
                         f"plain run on the card finite "
                         f"{np.all(np.isfinite(pc.solution.q))}")
                nonfinite[entry] = [int((~np.isfinite(q)).sum()),
                                    int((~np.isfinite(pc.solution.q)).sum())]
    print(f"[4y] each instance on a short path of its system (the card's "
          f"launches): {out}; runs that end non-finite with their plain "
          f"version (kernel, plain non-finite values): {nonfinite}",
          flush=True)
    return out, nonfinite


# [4y]'s integrator runs on the quadrants (WENO5, dq2_weno5): the RK4
# tableau on the device loop; SSPLMMk2, SSPLMMk3 (4 steps, variable dt) and
# LMM with Adams-Bashforth 3 at a fixed dt (|s| dt/dx about 0.15 at 1024^2)
# on the host loop
RK4_TABLEAU = dict(a=[[0, 0, 0, 0], [0.5, 0, 0, 0], [0, 0.5, 0, 0],
                      [0, 0, 1.0, 0]], b=[1 / 6, 1 / 3, 1 / 3, 1 / 6])
AB3_COEFFS = dict(lmm_alpha=[0.0, 0.0, 1.0],
                  lmm_beta=[5.0 / 12.0, -16.0 / 12.0, 23.0 / 12.0])
INTEGRATOR_RUNS = {
    "RK4": ("RK", dict(RK4_TABLEAU)),
    "SSPLMMk2": ("SSPLMMk2", {}),
    "SSPLMMk3": ("SSPLMMk3", {}),
    "LMM-AB3": ("LMM", dict(AB3_COEFFS, dt_variable=False,
                            dt_initial=5e-5))}


def integrator_paths(dev, n=1024, tfinal=0.1):
    """[4y]: the quadrants at n^2 in float32 (WENO5 on dq2_weno5) to
    ``tfinal`` with each integrator of INTEGRATOR_RUNS, every launch count
    set to 0 just before each and read just after: RK4 on the device loop
    (4 dq2_weno5 launches an attempted step); the multistep methods on
    the host loop (no device loop, no restore, no attempt after the end;
    11 launches an attempted step while SSP104 starts the history, 1
    after).  Each route against its plain run on the card at 128^2 in
    float64 to t=0.02 from dt 1e-3 (held_to_plain; conditioned, as in
    weno7_path; smooth_paths gates each route at 1e-12)."""
    out = {}
    for label, (integrator, attrs) in INTEGRATOR_RUNS.items():
        kw = dict(attrs, time_integrator=integrator)
        claw, status, wall, counts, ran = counted_run(
            lambda: quadrants_opts(dev, n, np.float32, tfinal, **kw))
        ns, nr = status["numsteps"], status["numrejected"]
        st = dict(claw.solver.loop_stats)
        if integrator == "RK":
            check_path_launches(f"[4y] {label}", claw, status, counts,
                                "dq2_weno5", 4, ran=ran)
        else:
            attempts = ns + nr
            others = {k: v for k, v in ran.items()
                      if k != "dq2_weno5" and v}
            if (st["frames"] or st["attempts"] or st["after_end"] or others
                    or not attempts <= ran["dq2_weno5"] <= 11 * attempts):
                fail(f"[4y] {label}: the host loop's launches {ran} for "
                     f"{attempts} attempted steps, loop {st}")
        q = claw.solution.q
        if (not np.all(np.isfinite(q)) or not claw.solution.state.is_valid()
                or abs(claw.solution.t - tfinal) > 1e-12):
            fail(f"[4y] {label}: q finite {np.all(np.isfinite(q))}, t "
                 f"{claw.solution.t}")
        print(f"[4y] {label} quadrants {n}^2 f32 to t={claw.solution.t}: "
              f"{ns} accepted + {nr} rejected steps, {wall:.3f} s wall with "
              f"the device counters, the card ran {ran}; loop {st}",
              flush=True)
        small = held_to_plain(
            f"[4y] {label} quadrants 128^2 f64 to t=0.02 from dt 1e-3",
            lambda kw=kw: quadrants_opts(
                dev, 128, np.float64, 0.02,
                **dict({"dt_initial": 1e-3}, **kw)), "dq2_weno5")
        out[label] = {"accepted": ns, "rejected": nr, "wall_s_counted": wall,
                      "launches": ran, "loop": st, "f64_128": small}
    return out


def tfluct_run(dev, dtype, use_tfluct, perturb=False, nx=64, tfinal=0.5):
    """The tfluct case of tests/test_well_balanced.py:40 on the port: 1D
    advection (u = 1) of a Gaussian, periodic, SharpClaw SSP104 to
    ``tfinal``, with the exact in-cell fluctuation u (qr - ql) as a torch
    tfluct hook, or without; (claw, status, wall)."""
    import torch
    import pyclaw_tpu_torch as pyclaw
    from pyclaw_tpu_torch import riemann
    solver = pyclaw.SharpClawSolver1D(riemann.advection_1D, device=dev)
    solver.all_bcs = pyclaw.BC.periodic
    if use_tfluct:
        solver.tfluct_solver = True
        solver.tfluct = lambda ixy, ql, qr, al, ar, p: p["u"] * (qr - ql)
    domain = pyclaw.Domain([0.0], [1.0], [nx])
    state = pyclaw.State(domain, 1, dtype=dtype)
    state.problem_data["u"] = 1.0
    x = domain.grid.x.centers
    state.q[0, :] = np.exp(-100.0 * (x - 0.5) ** 2)
    claw = pyclaw.Controller()
    claw.solution = pyclaw.Solution(state, domain)
    claw.solver = solver
    claw.tfinal = tfinal
    claw.num_output_times = 1
    claw.output_format = None
    if perturb:
        perturbed(claw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def card_against_cpu(label, run):
    """``run(where, perturb)`` ((claw, status, wall) of a float64 run) on
    the card and on the CPU: the same steps, q within CARD_VS_CPU_TOL of
    max|q|, or within ULP_FACTOR times the CPU run's own move under a
    one-ulp move of its initial state.  Returns the reading."""
    (kc, ks, _), (cc, cs, _) = run(None, False), run("cpu", False)
    steps = (ks["numsteps"], ks["numrejected"])
    if steps != (cs["numsteps"], cs["numrejected"]):
        fail(f"{label}: card {steps} steps, CPU "
             f"{(cs['numsteps'], cs['numrejected'])}")
    q_c = cc.solution.q
    rel = float(np.abs(kc.solution.q - q_c).max() / np.abs(q_c).max())
    out = {"steps": steps, "card_vs_cpu_max_rel": rel}
    if not rel <= CARD_VS_CPU_TOL:
        uc, _, _ = run("cpu", True)
        out["cpu_one_ulp_move"] = float(
            np.abs(uc.solution.q - q_c).max() / np.abs(q_c).max())
        if not rel <= ULP_FACTOR * out["cpu_one_ulp_move"]:
            fail(f"{label}: card vs CPU {rel:.3e} (tol {CARD_VS_CPU_TOL}; "
                 f"the CPU run's one-ulp move {out['cpu_one_ulp_move']:.3e})")
    print(f"{label}: {steps[0]} + {steps[1]} steps, card vs CPU max rel "
          f"{rel:.3e} (tol {CARD_VS_CPU_TOL}"
          + (f", or {ULP_FACTOR} x the CPU run's one-ulp move "
             f"{out['cpu_one_ulp_move']:.3e}" if "cpu_one_ulp_move" in out
             else "") + ")", flush=True)
    return out


def limiter_paths(dev):
    """[4y]: lim_type 0/1 and tfluct, plain PyTorch on the card as the JAX
    package runs them in XLA, every launch count set to 0 just before each
    run and read just after: the Sod tube (800 cells, f32, to t=0.2) with
    lim_type=1 (MC) and char_decomp 0-4, and with lim_type=0, on the
    device loop (restore once an attempted step, no other kernel); the
    quadrants at 512^2 f32 to t=0.1 with lim_type=1 (the dq_nd route, off
    the SoA route: no dq2_weno5, dq2_weno or weno5); the tfluct advection
    case (weno5.cu, 10 an attempted step) in float32 and float64.  Each
    float64 run on the card against the CPU (card_against_cpu): Sod at
    200 cells, the quadrants at 48^2, tfluct at 64."""
    out = {}

    def sod(where, dtype, nx, cd, lim, perturb=False):
        return run_example(where, "euler_1d_shocktube", dtype, 0.2,
                           tweak=solver_tweak(perturb, lim_type=lim), nx=nx,
                           solver_type="sharpclaw", char_decomp=cd)

    for lim, cds in ((1, (0, 1, 2, 3, 4)), (0, (0,))):
        for cd in cds:
            label = f"[4y] sod lim_type={lim} char_decomp={cd}"
            claw, status, wall, counts, ran = counted_run(
                lambda: sod(dev, np.float32, 800, cd, lim))
            check_path_launches(label, claw, status, counts, None, 0,
                                ran=ran)
            q = claw.solution.q
            if not (np.all(np.isfinite(q)) and np.min(q[0]) > 0.0):
                fail(f"{label}: q not finite or rho <= 0")
            print(f"{label} 800 f32 to t={claw.solution.t}: "
                  f"{status['numsteps']} + {status['numrejected']} steps, "
                  f"the card ran {ran}", flush=True)
            out[f"sod lim{lim} cd{cd}"] = {
                "accepted": status["numsteps"],
                "rejected": status["numrejected"], "launches": ran,
                "f64": card_against_cpu(
                    f"{label} 200 f64 to t=0.2",
                    lambda where, p: sod(where or dev, np.float64, 200, cd,
                                         lim, p))}

    claw, status, wall, counts, ran = counted_run(
        lambda: quadrants_opts(dev, 512, np.float32, 0.1, lim_type=1))
    check_path_launches("[4y] quadrants lim_type=1", claw, status, counts,
                        None, 0, ran=ran)
    if not claw.solution.state.is_valid():
        fail("[4y] quadrants lim_type=1: invalid state")
    print(f"[4y] quadrants lim_type=1 512^2 f32 to t={claw.solution.t}: "
          f"{status['numsteps']} + {status['numrejected']} steps, the card "
          f"ran {ran}", flush=True)
    out["quadrants lim1"] = {
        "accepted": status["numsteps"], "rejected": status["numrejected"],
        "launches": ran,
        "f64": card_against_cpu(
            "[4y] quadrants lim_type=1 48^2 f64 to t=0.1",
            lambda where, p: quadrants_opts(where or dev, 48, np.float64,
                                            0.1, p, lim_type=1))}

    q32 = {}
    for use in (True, False):
        claw, status, _, counts, ran = counted_run(
            lambda: tfluct_run(dev, np.float32, use))
        check_path_launches(f"[4y] tfluct {use}", claw, status, counts,
                            "weno5", 10, ran=ran)
        q32[use] = claw.solution.q
        out[f"tfluct {use}"] = {"accepted": status["numsteps"],
                                "rejected": status["numrejected"],
                                "launches": ran}
    move = float(np.abs(q32[True] - q32[False]).max())
    if not move <= 1e-5:
        fail(f"[4y] tfluct: the hook moves the f32 run by {move:.3e}")

    out["tfluct f64"] = card_against_cpu(
        "[4y] tfluct advection 64 f64 to t=0.5",
        lambda where, p: tfluct_run(where or dev, np.float64, True, p))
    out["tfluct f32 hook vs none"] = move
    print(f"[4y] tfluct advection 64 f32: with and without the hook "
          f"{move:.3e} apart (max abs)", flush=True)
    return out


def options_phase(dev):
    """[4y]: the quadrants at WENO order 7 (1024^2, f32, t=0.8), every
    instance of dq2_weno.cu against its plain version and on a short path,
    the integrators, the smooth wave's runs against their plain versions,
    lim_type 0/1 and tfluct; the seconds of each part."""
    out, secs = {}, {}
    for key, fn in (("weno7_path", weno7_path),
                    ("compare", compare_dq_weno),
                    ("instances", instance_paths),
                    ("integrators", integrator_paths),
                    ("smooth", smooth_paths),
                    ("limiters", limiter_paths)):
        t0 = time.perf_counter()
        out[key] = fn(dev)
        secs[key] = time.perf_counter() - t0
    out["seconds"] = secs
    print(f"[4y] seconds: {secs}", flush=True)
    return out


def timing_dq_weno(dev):
    """[6]: each instance of dq2_weno.cu on its 1024^2 case (dq_weno_case;
    Euler 5-wave 2048x512), float32 and float64: a wrapper call (CUDA
    events), the kernel's device time (torch.profiler), the plain version
    (dq_2d_soa at the order), the bound (bytes: qbc read and dq written
    once; operations: flops_per_cell_dq_weno) and its share of the device
    time."""
    import torch
    from pyclaw_tpu_torch.ops import tiled2d
    from pyclaw_tpu_torch.sharpclaw import soa as sc_soa
    out = {}
    for order in WENO_ORDERS:
        k = (order + 1) // 2
        for name in DQ_WENO_SYSTEMS:
            rp, params = dq_weno_rp(name), dq_weno_params(name)
            for tname in ("float32", "float64"):
                qbc, dt, dx, dy = dq_weno_case(name, order, tname, dev)

                def kern():
                    return tiled2d.dq_rows(qbc, dt, dx, dy, params, order, k,
                                           rp=rp)

                def plain():
                    return sc_soa.dq_2d_soa(
                        qbc, dt, dx, dy, rp.rpn_soa, params, order, k,
                        positivity=rp.positivity, flux_soa=rp.flux_soa)
                ms = time_ms(kern, 20, warm=2)
                dev_ms, dev_n = device_ms_per_call(kern, "dq2_weno_kernel",
                                                   10)
                plain_ms = time_ms(plain, 1, warm=1)
                item = qbc.element_size()
                cells = (qbc.shape[1] - 2 * k) * (qbc.shape[2] - 2 * k)
                b = bound_of(qbc.numel() * item + rp.num_eqn * cells * item,
                             flops_per_cell_dq_weno(name, order, tname)
                             * cells, tname)
                entry = dq_weno_entry(order, name, tname)
                share = (b["bound_ms"] / dev_ms if dev_ms
                         else b["bound_ms"] / ms)
                ceiling = ceiling_ms_dq_weno(name, order, tname, cells)
                out[entry] = {"ms": ms, "device_ms": dev_ms,
                              "device_launches_profiled": dev_n,
                              "plain_ms": plain_ms, "shape": list(qbc.shape),
                              "share_of_device": share,
                              "ceiling_ms": ceiling,
                              "issued_ops_per_cell":
                                  issued_ops_per_cell_dq_weno(name, order,
                                                              tname), **b}
                print(f"  timing {entry} {tuple(qbc.shape)}: kernel "
                      f"{ms:.4f} ms (on the device {dev_ms} ms), plain "
                      f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                      f"({b['bound_by']}), share of the device time "
                      f"{share:.4f}, ceiling under the plain arithmetic "
                      f"{ceiling:.4f} ms, library_ms null", flush=True)
                del qbc
        torch.cuda.empty_cache()
    return out


# Operations per cell of one step1 sweep (order 2, a limiter), each
# interface counted once, of the library systems: the Riemann solve (the
# cell's quantities once a cell, cell(), then the interface's), counted
# from csrc/systems1d.cuh; and what every system does (phase_limit,
# phase_update): a wave's limiter (norm and two dot products 3 (2 NEQ -
# 1), theta 2, nu 2, the limiter about 6, the coefficient 5), the
# correction flux NEQ (2 NW - 1), the update 6 NEQ, the CFL 2 NW.
LIB_RP_OPS = {"shallow_roe_with_efix_1D": 72, "shallow_hlle_1D": 48,
              "shallow_bathymetry_fwave_1D": 50, "psystem_1D": 24,
              "vc_advection_1D": 4, "vc_advection_fwave_1D": 6,
              "acoustics_variable_1D": 20, "burgers_1D": 10,
              "traffic_1D": 12, "mhd_1D": 180}


def flops_per_cell_library(name):
    from pyclaw_tpu_torch import riemann
    rp = riemann.ALL[name]
    neq, nw = rp.num_eqn, rp.num_waves
    return (LIB_RP_OPS[name] + nw * (3 * (2 * neq - 1) + 15)
            + neq * (2 * nw - 1) + 6 * neq + 2 * nw)


def timing_library(dev, n=2 ** 20):
    """[6]: each library system's step1 instance at n cells on its seeded
    state (ops/time_kernels.py:library_case: the example's limiter and
    form, order 2), float32 and float64: a wrapper call (CUDA events), the
    kernel's device time (torch.profiler), the plain version, the bound
    (bytes: NEQ + NAUX read and NEQ written a cell; operations:
    flops_per_cell_library) and its share of the device time."""
    import torch
    from pyclaw_tpu_torch.classic import kernels
    from pyclaw_tpu_torch.ops import sweep
    out = {}
    for name in LIBRARY_1D:
        out[name] = {}
        for tname, dtype in (("float32", torch.float32),
                             ("float64", torch.float64)):
            item = torch.finfo(dtype).bits // 8
            qbc, args = library_case(name, n, dtype, dev)
            rp = args[3]
            naux = sweep.AUX_ROWS_1D.get(name, 0)
            nbytes = (2 * rp.num_eqn + naux) * n * item
            b = bound_of(nbytes, flops_per_cell_library(name) * n, tname)

            def kern():
                return sweep.step1(qbc, *args)

            def plain():
                return kernels.step1(qbc, *args[:3], rp.rp, *args[4:])
            ms = time_ms(kern, 50)
            plain_ms = time_ms(plain, 10, warm=2)
            dev_ms, dev_n = device_ms_per_call(kern, "step1_kernel")
            share = b["bound_ms"] / dev_ms if dev_ms else None
            out[name][tname] = {"ms": ms, "device_ms": dev_ms,
                                "device_launches_profiled": dev_n,
                                "plain_ms": plain_ms,
                                "shape": list(qbc.shape),
                                "share_of_device": share, **b}
            print(f"  timing step1 {name} {tuple(qbc.shape)} {tname}: "
                  f"wrapper call {ms:.4f} ms, kernel on the device {dev_ms} "
                  f"ms ({dev_n} launches profiled), plain {plain_ms:.4f} ms, "
                  f"bound {b['bound_ms']:.6f} ms ({b['bound_by']}; bytes "
                  f"{b['bytes_ms']:.6f}, operations {b['ops_ms']:.6f}), "
                  f"share of the device time {share}, library_ms null",
                  flush=True)
    return out


# ---- the parallel overlay: [4m] NCCL with one rank, [4n] four ranks -------

# ---- [4z] frames and restarts on the main path ---------------------------

# the quadrants at 1024^2 f32 to t=0.8 in four frames; the fixed dt of the
# restart (800 steps a frame); the grid of the native writer's frame
# against the plain one's; %18.8e keeps 9 digits: half a unit of the 9th
FRAMES_N, FRAMES_T, FRAMES_OUT = 1024, 0.8, 4
FRAMES_DT = 0.2 / 800
NATIVE_N = 256
ASCII_REL = 5e-9


def have_module(name):
    """True when ``name`` imports on this machine (h5py and matplotlib may
    be missing on the card's)."""
    import importlib.util
    return importlib.util.find_spec(name) is not None


def frames_claw(dev, outdir=None, fmts=None, fixed_dt=None, n=None):
    """The quadrants at n^2 (FRAMES_N^2) f32 to FRAMES_T in FRAMES_OUT
    frames, written in ``fmts`` (none without ``outdir``), at a fixed dt
    when given."""
    from pyclaw_tpu_torch.examples import euler_2d_quadrants as ex
    n = FRAMES_N if n is None else n
    claw = ex.setup(mx=n, my=n, dtype=np.float32, outdir=outdir, device=dev)
    claw.tfinal, claw.num_output_times = FRAMES_T, FRAMES_OUT
    claw.output_format = fmts if outdir is not None else None
    if fixed_dt is not None:
        claw.solver.dt_variable = False
        claw.solver.dt_initial = fixed_dt
    return claw


def frame_read_back(claw, path, fmts):
    """Each kept frame of ``claw`` read back in each format: netcdf and
    hdf5 equal bit for bit (t too), ascii within %18.8e (ASCII_REL of each
    entry); the largest ascii distance (relative to the entry)."""
    from pyclaw_tpu_torch import Solution
    worst = 0.0
    for k, kept in enumerate(claw.frames):
        want = kept.q.astype(np.float64)
        for fmt in fmts:
            got = Solution(k, path=path, file_format=fmt)
            if got.q.shape != want.shape:
                fail(f"[4z] frame {k} ({fmt}): shape {got.q.shape}")
            if fmt == "ascii":
                dist = np.abs(got.q - want)
                ok = (abs(got.t - kept.t) <= 1e-8
                      and bool(np.all(dist <= ASCII_REL * np.abs(want))))
                worst = max(worst, float(np.max(
                    dist / np.maximum(np.abs(want), 1e-300))))
            else:
                ok = got.t == kept.t and np.array_equal(got.q, want)
            if not ok:
                fail(f"[4z] frame {k} ({fmt}) does not read back: t "
                     f"{got.t!r} against {kept.t!r}, max |dq| "
                     f"{float(np.abs(got.q - want).max())}")
    return worst


def frames_phase(dev):
    """[4z]: frames and restarts on the main path.  The quadrants at
    1024^2 f32 to t=0.8 through Controller.run() with four frames in
    ascii, netcdf and (where h5py imports) hdf5: q equal bit for bit to
    the run with the same frames and no files, the same steps and
    step2_ctu launches; every frame read back (netcdf, hdf5 bit for bit,
    ascii within %18.8e); the native ascii writer's fort.q byte-identical
    to the plain (Python) writer's at 256^2, each writer's ms a frame;
    each format's ms a frame (the pull from the card and the write, host);
    the fixed-dt run restarted from its netcdf frame 2 (t=0.4) equal bit
    for bit to the uninterrupted one, and a variable-dt restart's steps; a
    Fortran-binary frame of a seeded state read back and stepped once on
    the card, equal to the same step from the state in memory.  What needs
    a library this machine lacks (h5py, matplotlib) is reported as not
    run."""
    import shutil

    from pyclaw_tpu_torch import Solution, plot
    from pyclaw_tpu_torch.fileio import ascii as fascii
    out = {"not_run": []}
    fmts = ["ascii", "netcdf"]
    if have_module("h5py"):
        fmts.append("hdf5")
    else:
        out["not_run"].append("hdf5")
        print("[4z] hdf5: not run, no h5py on this machine", flush=True)
    root = os.path.join(ROOT, "build", "frames")
    shutil.rmtree(root, ignore_errors=True)
    fdir = os.path.join(root, "variable")

    # frames do not perturb the run
    def with_frames():
        claw = frames_claw(dev, fdir, fmts)
        claw.keep_copy = True
        return run_claw(claw)
    claw, status, wall, counts, ran = counted_run(with_frames)
    loop = check_path_launches("[4z] quadrants with frames", claw, status,
                               counts, "step2_ctu", 1, ran=ran)
    ref, rstatus, rwall, rcounts, rran = counted_run(
        lambda: run_claw(frames_claw(dev)))
    check_path_launches("[4z] quadrants without files", ref, rstatus,
                        rcounts, "step2_ctu", 1, ran=rran)
    steps = (status["numsteps"], status["numrejected"])
    rsteps = (rstatus["numsteps"], rstatus["numrejected"])
    equal = bool(np.array_equal(claw.solution.q, ref.solution.q))
    out["run"] = {"formats": fmts, "steps": steps, "steps_no_files": rsteps,
                  "launches": ran["step2_ctu"],
                  "launches_no_files": rran["step2_ctu"], "wall_s": wall,
                  "wall_s_no_files": rwall, "bit_equal": equal, "loop": loop}
    print(f"[4z] quadrants {FRAMES_N}^2 f32 to t={FRAMES_T}, {FRAMES_OUT} "
          f"frames in {fmts}: {steps[0]} + {steps[1]} steps, "
          f"{ran['step2_ctu']} step2_ctu launches, {wall:.3f} s wall; "
          f"without files {rsteps[0]} + {rsteps[1]}, {rran['step2_ctu']}, "
          f"{rwall:.3f} s; q equal bit for bit: {equal}", flush=True)
    if not equal or steps != rsteps or ran["step2_ctu"] != rran["step2_ctu"]:
        fail(f"[4z] the frames moved the run: {out['run']}")

    # every frame reads back
    t0 = time.perf_counter()
    worst = frame_read_back(claw, fdir, fmts)
    out["read_back"] = {"frames": len(claw.frames), "ascii_max_rel": worst,
                        "s": time.perf_counter() - t0}
    print(f"[4z] {len(claw.frames)} frames read back in {fmts}: netcdf"
          f"{' and hdf5' if 'hdf5' in fmts else ''} bit for bit, ascii "
          f"within {worst:.3e} of each entry (%18.8e: {ASCII_REL})",
          flush=True)

    # each format's host ms a frame: the pull from the card and the write
    state = claw.solution.state
    out["frame_ms"] = {}
    for fmt in fmts:
        pulls, writes = [], []
        for i in range(3):
            t0 = time.perf_counter()
            claw.solver._pull(state)
            t1 = time.perf_counter()
            claw.solution.write(90 + i, path=fdir, file_format=fmt)
            t2 = time.perf_counter()
            pulls.append(t1 - t0)
            writes.append(t2 - t1)
        rec = {"pull_ms": 1e3 * float(np.median(pulls)),
               "write_ms": 1e3 * float(np.median(writes))}
        rec["frame_ms"] = rec["pull_ms"] + rec["write_ms"]
        out["frame_ms"][fmt] = rec
    print(f"[4z] host ms a {FRAMES_N}^2 f32 frame (median of 3; pull + "
          f"write): " + ", ".join(
              f"{f} {r['pull_ms']:.2f} + {r['write_ms']:.2f} = "
              f"{r['frame_ms']:.2f}" for f, r in out["frame_ms"].items()),
          flush=True)

    # the native writer against the plain one, byte for byte
    patch = frames_claw(dev, n=NATIVE_N).solution.patch
    step = FRAMES_N // NATIVE_N
    q_small = np.ascontiguousarray(claw.solution.q[:, ::step, ::step])
    paths = {w: os.path.join(root, f"{w}.q") for w in ("native", "plain")}
    t0 = time.perf_counter()
    fascii._write_data_file(paths["native"], patch, q_small)
    t1 = time.perf_counter()
    fascii._write_data_file_plain(paths["plain"], patch, q_small)
    t2 = time.perf_counter()
    with open(paths["native"], "rb") as f:
        native = f.read()
    with open(paths["plain"], "rb") as f:
        same = native == f.read()
    out["native"] = {"n": NATIVE_N, "bytes": len(native),
                     "native_ms": 1e3 * (t1 - t0),
                     "plain_ms": 1e3 * (t2 - t1), "byte_identical": same}
    print(f"[4z] fort.q of a {NATIVE_N}^2 frame: native writer "
          f"{out['native']['native_ms']:.2f} ms, plain (Python) writer "
          f"{out['native']['plain_ms']:.2f} ms, {len(native)} bytes, "
          f"byte-identical: {same}", flush=True)
    if not same:
        fail("[4z] the native ascii writer differs from the plain one")

    # the fixed-dt restart from netcdf frame 2, bit for bit
    rdir = os.path.join(root, "fixed")

    def restart(path, fixed_dt):
        c = frames_claw(dev, fixed_dt=fixed_dt)
        sol = Solution(2, path=path, file_format="netcdf")
        sol.state.q = sol.state.q.astype(np.float32)
        c.solution = sol
        c.num_output_times = FRAMES_OUT - 2
        return run_claw(c)
    full, fstatus, fwall, fcounts, fran = counted_run(
        lambda: run_claw(frames_claw(dev, rdir, ["netcdf"], FRAMES_DT)))
    rs, rsstatus, rswall, rscounts, rsran = counted_run(
        lambda: restart(rdir, FRAMES_DT))
    for label, c, st, cn, rn in (("fixed dt", full, fstatus, fcounts, fran),
                                 ("restart", rs, rsstatus, rscounts, rsran)):
        check_path_launches(f"[4z] {label}", c, st, cn, "step2_ctu", 1,
                            ran=rn)
    equal = bool(np.array_equal(rs.solution.q, full.solution.q))
    n_frame = round(FRAMES_T / FRAMES_OUT / FRAMES_DT)
    out["restart_fixed_dt"] = {
        "dt": FRAMES_DT, "steps": fstatus["numsteps"],
        "steps_restarted": rsstatus["numsteps"],
        "cflmax": fstatus["cflmax"], "t": rs.solution.t, "bit_equal": equal}
    print(f"[4z] fixed dt {FRAMES_DT}: {fstatus['numsteps']} steps to "
          f"t={full.solution.t} (CFL max {fstatus['cflmax']:.3f}); "
          f"restarted from netcdf frame 2 (t=0.4): "
          f"{rsstatus['numsteps']} steps to t={rs.solution.t}; q equal "
          f"bit for bit: {equal}", flush=True)
    if (not equal or rs.solution.t != full.solution.t
            or fstatus["numsteps"] != FRAMES_OUT * n_frame
            or rsstatus["numsteps"] != (FRAMES_OUT - 2) * n_frame):
        fail(f"[4z] the fixed-dt restart differs: "
             f"{out['restart_fixed_dt']}")
    # a variable-dt restart from the first run's frame 2: it starts at
    # the frame's t with dt_initial, so its steps are reported
    vr, vstatus, _ = restart(fdir, None)
    out["restart_variable_dt"] = {
        "t0": 0.4, "t": vr.solution.t, "steps": vstatus["numsteps"],
        "rejected": vstatus["numrejected"],
        "max_rel_to_uninterrupted": float(
            np.abs(vr.solution.q - claw.solution.q).max()
            / np.abs(claw.solution.q).max())}
    print(f"[4z] variable-dt restart from frame 2 (t=0.4) to "
          f"t={vr.solution.t}: {vstatus['numsteps']} + "
          f"{vstatus['numrejected']} steps (the uninterrupted run's frames "
          f"3-4 differ in dt: restarted from dt_initial); max distance "
          f"{out['restart_variable_dt']['max_rel_to_uninterrupted']:.3e} of "
          f"max|q|", flush=True)
    if abs(vr.solution.t - FRAMES_T) > 1e-12 or not np.all(
            np.isfinite(vr.solution.q)):
        fail(f"[4z] the variable-dt restart: {out['restart_variable_dt']}")

    # a Fortran-binary frame (f64, Fortran order; fort.q holds the patch
    # header only, as AMRClaw writes it) of a seeded state, one step
    bdir = os.path.join(root, "binary")
    q0 = random_state(np.random.default_rng(31), FRAMES_N,
                      FRAMES_N).astype(np.float32)
    mem = frames_claw(dev)
    mem.solution.state.q = q0.copy()
    mem.solution.write(4, path=bdir, file_format="ascii")
    with open(os.path.join(bdir, "fort.q0004"), "w") as f:
        fascii._write_patch_header(f, mem.solution.patch)
    q0.astype(np.float64).ravel(order="F").tofile(
        os.path.join(bdir, "fort.b0004"))
    read = Solution(4, path=bdir, file_format="binary")
    exact = bool(np.array_equal(read.q, q0.astype(np.float64)))
    read.state.q = read.state.q.astype(np.float32)
    read.state.problem_data.update(mem.solution.state.problem_data)
    stepped = frames_claw(dev)
    stepped.solution = read
    stepped.solver.evolve_to_time(read)
    mem.solver.evolve_to_time(mem.solution)
    equal = bool(np.array_equal(read.q, mem.solution.q)
                 and read.t == mem.solution.t)
    out["binary"] = {"read_exact": exact, "step_bit_equal": equal,
                     "steps": stepped.solver.status["numsteps"],
                     "rejected": stepped.solver.status["numrejected"],
                     "t": read.t}
    print(f"[4z] binary frame of a seeded {FRAMES_N}^2 state: read back "
          f"exactly: {exact}; one step on the card ({out['binary']['steps']}"
          f" + {out['binary']['rejected']}, t={read.t:.6e}) equal to the "
          f"step from memory bit for bit: {equal}", flush=True)
    if not (exact and equal and out["binary"]["steps"] == 1):
        fail(f"[4z] the binary frame: {out['binary']}")

    if have_module("matplotlib"):
        import matplotlib
        matplotlib.use("Agg")
        ax = plot.plot_frame(claw.solution)
        ax.figure.savefig(os.path.join(root, "frame.png"), dpi=50)
        out["plot"] = "plot_frame of the last frame"
        print("[4z] plotting: plot_frame drew the last frame", flush=True)
    else:
        out["not_run"].append("plotting")
        print("[4z] plotting: not run, no matplotlib on this machine",
              flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return out


# [4n]'s runs: name -> (the example module, its setup keywords, the
# overlay's solver class, the mesh shape, the final time, the kernel, its
# launches per attempted step)
OVERLAY_CASES = {
    "euler3d": ("euler_3d", dict(mx=192, my=192, mz=192), "ClawSolver3D",
                (2, 2, 1), 0.2, "step3_ctu", 1),
    "quadrants": ("euler_2d_quadrants", dict(mx=1024, my=1024),
                  "ClawSolver2D", (2, 2), 0.1, "step2_ctu", 1),
    "sharpclaw": ("euler_2d_quadrants",
                  dict(mx=256, my=256, solver_type="sharpclaw"),
                  "SharpClawSolver2D", (2, 2), 0.05, "dq2_weno5", 10),
    "sod": ("euler_1d_shocktube", dict(nx=800, solver_type="classic"),
            "ClawSolver1D", (4,), 0.2, "step1", 1),
    "sharpclaw3d": ("euler_3d", dict(mx=64, my=64, mz=64,
                                     solver_type="sharpclaw"),
                    "SharpClawSolver3D", (2, 2, 1), 0.1, "weno5", 30),
    # gauges (the owners' reads, one all_gather an accepted step; frames
    # and gauge files from rank 0, shards from every rank where h5py
    # imports) and a before_step hook on the global q (OVERLAY_HOOKS)
    "gauges": ("euler_2d_quadrants", dict(mx=256, my=256), "ClawSolver2D",
               (2, 2), 0.1, "step2_ctu", 1),
    "before_step": ("euler_2d_quadrants", dict(mx=256, my=256),
                    "ClawSolver2D", (2, 2), 0.1, "step2_ctu", 1),
}
OVERLAY_RANKS = 4
# [4n]'s gauges: one inside rank 1's block, one on the corner cell
# (128, 128) of rank 3's, one on the grid's corner cell (255, 0); the cell
# the before_step hook damps (seeded)
OVERLAY_GAUGES = [(0.1, 0.7), (128.5 / 256, 128.5 / 256),
                  (255.5 / 256, 0.5 / 256)]
OVERLAY_DAMPED = tuple(int(i) for i in
                       np.random.default_rng(21).integers(0, 256, 2))


def damp_one_cell(solver, state):
    """[4n]'s before_step: damp one cell of the global q in place (the
    same edit on every rank)."""
    state.q[(slice(None),) + OVERLAY_DAMPED] *= 0.97


def gauge_rows(claw):
    """A run's gauge series as rows (gauge number, t, q at the cell)."""
    return np.array([[num, t, *vals]
                     for num, t, vals in claw.solution.state.gauge_data])


# name -> what [4n] adds to the case's claw (the serial one and each
# rank's)
OVERLAY_HOOKS = {
    "gauges": lambda claw: claw.solution.state.grid.add_gauges(
        OVERLAY_GAUGES),
    "before_step": lambda claw: setattr(claw.solver, "before_step",
                                        damp_one_cell),
}


def overlay_claw(name, dev, mesh=None, outdir=None, fmts=None):
    """The float32 claw of OVERLAY_CASES[name] on ``dev``: the example's
    serial run, or with ``mesh`` the overlay on that mesh, with the
    case's OVERLAY_HOOKS, writing frames in ``fmts`` into ``outdir`` when
    given.  An example with a ``use_parallel`` keyword (Euler 3D) builds
    the overlay itself, its solver and its Controller, as a user's run
    does; the others' serial solver is swapped for the overlay's of the
    same settings (and their Controller for the overlay's)."""
    import importlib
    import inspect

    from pyclaw_tpu_torch import convert, parallel
    module, kw, cls, _, tfinal, _, _ = OVERLAY_CASES[name]
    ex = importlib.import_module(f"pyclaw_tpu_torch.examples.{module}")
    if mesh is not None and "use_parallel" in inspect.signature(
            ex.setup).parameters:
        claw = ex.setup(dtype=np.float32, outdir=None, device=dev,
                        use_parallel=True, **kw)
        if not (isinstance(claw, parallel.Controller)
                and type(claw.solver) is getattr(parallel, cls)):
            fail(f"{module}.setup(use_parallel=True) built "
                 f"{type(claw).__name__} / {type(claw.solver).__name__}")
        claw.solver.mesh = mesh
    else:
        claw = ex.setup(dtype=np.float32, outdir=None, device=dev, **kw)
        if mesh is not None:
            solver = getattr(parallel, cls)(claw.solver.rp, mesh=mesh,
                                            device=dev)
            convert.apply_solver_settings(
                solver, convert.solver_settings(claw.solver))
            claw.solver = solver
            ctrl = parallel.Controller()
            ctrl.__dict__.update(claw.__dict__)
            claw = ctrl
    claw.tfinal = tfinal
    if name in OVERLAY_HOOKS:
        OVERLAY_HOOKS[name](claw)
    if outdir is not None:
        claw.outdir, claw.output_format = outdir, fmts
    return claw


def free_port():
    """A free TCP port on the loopback interface, for a process group's
    store (MASTER_PORT)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def launcher_env(rank, world_size, port, local_rank=None):
    """The environment torchrun gives a rank (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT and, for a rank of its own card, LOCAL_RANK)
    inside the block, so that ``parallel.init_distributed()`` joins as
    under torchrun; the earlier values come back after it."""
    env = {"RANK": rank, "WORLD_SIZE": world_size,
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
           "LOCAL_RANK": local_rank}
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_claw(claw):
    """claw.run() between two synchronisations: (claw, status, wall)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    status = claw.run()
    torch.cuda.synchronize()
    return claw, status, time.perf_counter() - t0


def overlay_record(label, claw, status, wall, counts, ran, kernel,
                   per_attempt):
    """A run's record: its steps, its wall, the launch counts (the
    wrappers' and the card's, held by check_path_launches to the kernel's
    launches per attempted step times the attempts, on the host loop)."""
    loop = check_path_launches(label, claw, status, counts, kernel,
                               per_attempt, graph=False, ran=ran)
    return {"accepted": status["numsteps"], "rejected":
            status["numrejected"], "wall_s": wall, "launches": ran,
            "wrapper_counts": counts, "loop": loop}


def overlay_rank(rank, backend, devices, port, outdir, names):
    """[4n]: one rank of the four, on ``devices[rank]``.  Joins the process
    group as under torchrun (the launcher's environment, a store on
    ``port``; NCCL from the card, gloo when asked), runs each case of
    ``names`` on the overlay with its device counters set to 0 just before
    and read just after, and writes its records (rank 0 also each gathered
    q) into ``outdir``."""
    import torch
    import torch.distributed as dist
    from pyclaw_tpu_torch import parallel
    from pyclaw_tpu_torch.ops import _build
    dev = torch.device(devices[rank])
    with launcher_env(rank, OVERLAY_RANKS, port,
                      dev.index if backend == "nccl" else None):
        parallel.init_distributed(None if backend == "nccl" else backend,
                                  device=dev)
    if dev.type == "cuda":
        # the parent's builds, loaded here outside the timed runs
        _build.load_all([OVERLAY_CASES[n][5] for n in names])
    count_on_device(dev)
    if dist.get_backend() != backend:
        fail(f"[4n] rank {rank}: backend {dist.get_backend()}, not {backend}")
    out = {}
    for name in names:
        _, _, _, shape, _, kernel, per_attempt = OVERLAY_CASES[name]
        frames = {}
        if name == "gauges":
            frames = dict(outdir=os.path.join(outdir, "gauges"),
                          fmts=overlay_gauge_formats())
        claw = overlay_claw(name, dev, parallel.make_mesh(len(shape), shape),
                            **frames)
        dist.barrier()
        claw, status, wall, counts, ran = counted_run(lambda: run_claw(claw))
        out[name] = overlay_record(f"[4n] {name} rank {rank}", claw, status,
                                   wall, counts, ran, kernel, per_attempt)
        out[name]["mesh"] = list(claw.solver.mesh.shape)
        if rank == 0:
            np.save(os.path.join(outdir, f"{name}.npy"), claw.solution.q)
            np.save(os.path.join(outdir, f"{name}_gauges.npy"),
                    gauge_rows(claw))
        del claw
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def nccl_one_rank(dev, q_serial, ns, nr):
    """[4m]: Euler 3D 192^3 f32 to t=0.2 on the overlay in a world of one
    NCCL rank, joined as under torchrun (``parallel.init_distributed()``
    reads RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and takes NCCL from
    the card) and built by ``euler_3d.setup(use_parallel=True)``: q equal
    bit for bit to [4c]'s serial run, the same accepted and rejected
    steps, one step3_ctu launch an attempted step on the card and no
    other kernel."""
    import torch.distributed as dist
    from pyclaw_tpu_torch import parallel
    with launcher_env(0, 1, free_port()):
        parallel.init_distributed()
    try:
        if dist.get_backend() != "nccl":
            fail(f"[4m]: the process group's backend is "
                 f"{dist.get_backend()}")
        claw = overlay_claw("euler3d", dev, parallel.make_mesh(3))
        claw, status, wall, counts, ran = counted_run(lambda: run_claw(claw))
        rec = overlay_record("[4m] euler_3d nccl", claw, status, wall,
                             counts, ran, "step3_ctu", 1)
        q = claw.solution.q
    finally:
        dist.destroy_process_group()
    rec["bit_equal"] = bool(np.array_equal(q, q_serial))
    rec["serial_steps"] = [ns, nr]
    print(f"[4m] euler_3d 192^3 f32 to t=0.2 on the overlay, NCCL, one rank "
          f"(mesh {list(claw.solver.mesh.shape)}): {rec['accepted']} + "
          f"{rec['rejected']} steps (serial [4c] {ns} + {nr}), "
          f"{ran['step3_ctu']} step3_ctu launches the card ran, "
          f"{wall:.3f} s wall; q equal to [4c]'s bit for bit: "
          f"{rec['bit_equal']}", flush=True)
    if not rec["bit_equal"] or (rec["accepted"], rec["rejected"]) != (ns, nr):
        fail(f"[4m]: the overlay differs from the serial run: "
             f"max |dq| {float(np.abs(q - q_serial).max())}, steps "
             f"{rec['accepted']} + {rec['rejected']} against {ns} + {nr}")
    return rec


def overlay_gauge_formats():
    """The formats of [4n]'s gauge case: ascii frames (rank 0) and, where
    h5py imports, sharded frames (every rank)."""
    return ["ascii", "sharded"] if have_module("h5py") else ["ascii"]


def overlay_frame_checks(outdir, q_ser):
    """[4n]'s gauge case's files: rank 0's gauge files and ascii frames
    byte-identical to the serial run's, no other file but the shards, and
    where h5py imports the last sharded frame reassembled equal to the
    serial q."""
    from pyclaw_tpu_torch import Solution
    ser, ranks = (os.path.join(outdir, d) for d in ("serial_gauges",
                                                    "gauges"))
    names = sorted(os.listdir(ser))
    got = sorted(n for n in os.listdir(ranks) if not n.startswith("shard"))
    files = [n for n in names if n != "_gauges"]
    files += [os.path.join("_gauges", n)
              for n in sorted(os.listdir(os.path.join(ser, "_gauges")))]
    same = got == names
    for name in files:
        with open(os.path.join(ser, name), "rb") as a, \
                open(os.path.join(ranks, name), "rb") as b:
            same = same and a.read() == b.read()
    rec = {"files": len(files), "byte_identical": same}
    if "sharded" in overlay_gauge_formats():
        last = max(int(n[5:9]) for n in os.listdir(ranks)
                   if n.startswith("shard") and n.endswith(".json"))
        sol = Solution(last, path=ranks, file_format="sharded")
        rec["sharded_frame"] = last
        rec["sharded_equal"] = bool(np.array_equal(
            sol.q, q_ser.astype(np.float64)))
        rec["shards"] = len([n for n in os.listdir(ranks)
                             if n.startswith(f"shard{last:04d}_p")])
    else:
        rec["sharded_frame"] = "not run, no h5py on this machine"
    return rec


def four_ranks(dev, limit_s=400):
    """[4n]: each case of OVERLAY_CASES on four ranks against the serial
    card run of the same setup: q equal bit for bit, the same steps, and
    each rank's device counters holding its kernel's launches per
    attempted step times the attempts.  NCCL with one card a rank when
    the machine has four cards, else gloo with the four ranks on the one
    card (decided here, before any rank starts); the parent has built the
    kernels, so the ranks load them.  The walls beside the serial ones
    are the cost of the exchange, not a scaling figure."""
    import tempfile

    import torch
    backend = "nccl" if torch.cuda.device_count() >= OVERLAY_RANKS else "gloo"
    devices = ([f"cuda:{r}" for r in range(OVERLAY_RANKS)]
               if backend == "nccl" else [str(dev)] * OVERLAY_RANKS)
    print(f"[4n] backend {backend}: {torch.cuda.device_count()} card(s), "
          f"{OVERLAY_RANKS} ranks" + ("" if backend == "nccl" else
                                     " on one card, faces through pinned "
                                     "host memory"), flush=True)
    with tempfile.TemporaryDirectory() as outdir:
        return four_ranks_in(dev, backend, devices, outdir, limit_s)


def four_ranks_in(dev, backend, devices, outdir, limit_s):
    """[4n]'s serial runs, ranks and checks (four_ranks), with the files
    in ``outdir``."""
    import torch.multiprocessing as mp
    serial = {}
    for name in OVERLAY_CASES:
        frames = {}
        if name == "gauges":
            frames = dict(outdir=os.path.join(outdir, "serial_gauges"),
                          fmts=["ascii"])
        claw, status, wall, _, _ = counted_run(
            lambda: run_claw(overlay_claw(name, dev, **frames)))
        # the same run on the host loop, which the overlay takes: its wall
        with host_loop():
            _, _, wall_host = run_claw(overlay_claw(name, dev))
        serial[name] = (claw.solution.q, status["numsteps"],
                        status["numrejected"], wall, wall_host,
                        gauge_rows(claw))
        del claw
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        overlay_rank, args=(backend, devices, free_port(), outdir,
                            list(OVERLAY_CASES)),
        nprocs=OVERLAY_RANKS, join=False, start_method="spawn")
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > limit_s:
            for p in ctx.processes:
                p.kill()
            fail(f"[4n]: the ranks did not end within {limit_s} s")
    ranks_wall = time.perf_counter() - t0
    recs = []
    for r in range(OVERLAY_RANKS):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    q_ranks = {name: np.load(os.path.join(outdir, f"{name}.npy"))
               for name in serial}
    out = {"backend": backend, "ranks_s": ranks_wall, "devices": devices}
    for name, (q_ser, ns, nr, wall_ser, wall_host, _) in serial.items():
        q = q_ranks[name]
        per = [rec[name] for rec in recs]
        steps = {(p["accepted"], p["rejected"]) for p in per}
        kernel = OVERLAY_CASES[name][5]
        res = {"mesh": per[0]["mesh"], "accepted": per[0]["accepted"],
               "rejected": per[0]["rejected"], "serial_accepted": ns,
               "serial_rejected": nr, "serial_wall_s": wall_ser,
               "serial_host_loop_wall_s": wall_host,
               "rank_wall_s": [p["wall_s"] for p in per],
               "launches": [p["launches"][kernel] for p in per],
               "bit_equal": bool(np.array_equal(q, q_ser))}
        out[name] = res
        print(f"[4n] {name} on {res['mesh']} ({backend}): "
              f"{res['accepted']} + {res['rejected']} steps (serial {ns} + "
              f"{nr}), {kernel} launches per rank {res['launches']}; wall "
              f"per rank {[round(w, 3) for w in res['rank_wall_s']]} s, "
              f"serial {wall_ser:.3f} s ("
              f"{'host' if name == 'before_step' else 'device'} loop), "
              f"{wall_host:.3f} s (host loop) (the exchange's cost on "
              f"{'four cards' if backend == 'nccl' else 'one card'}, not a "
              f"scaling figure); q equal to the serial run bit for bit: "
              f"{res['bit_equal']}", flush=True)
        if not res["bit_equal"] or steps != {(ns, nr)}:
            fail(f"[4n] {name}: the overlay differs from the serial run: "
                 f"max |dq| {float(np.abs(q - q_ser).max())}, steps {steps} "
                 f"against {(ns, nr)}")
    # the gauge case's series and files, the hook's damped cell
    g = np.load(os.path.join(outdir, "gauges_gauges.npy"))
    g_ser = serial["gauges"][5]
    files = overlay_frame_checks(outdir, serial["gauges"][0])
    out["gauges"].update(
        {"samples": len(g), "serial_samples": len(g_ser),
         "gauges_bit_equal": bool(g.shape == g_ser.shape
                                  and np.array_equal(g, g_ser)),
         "files": files})
    print(f"[4n] gauges: {len(g)} samples of {len(OVERLAY_GAUGES)} gauges "
          f"(one on the corner cell of rank 3's block) from the owners' "
          f"reads, equal to the serial run's {len(g_ser)} bit for bit: "
          f"{out['gauges']['gauges_bit_equal']}; rank 0's {files['files']} "
          f"gauge and ascii frame files byte-identical to the serial "
          f"run's: {files['byte_identical']}; sharded frame "
          + (f"{files['sharded_frame']} ({files['shards']} shards) equal "
             f"to the serial q: {files['sharded_equal']}"
             if "sharded_equal" in files else files["sharded_frame"]),
          flush=True)
    before = serial["before_step"]
    out["before_step"]["damped_cell"] = list(OVERLAY_DAMPED)
    out["before_step"]["hook_changed_q"] = bool(not np.array_equal(
        before[0], serial["gauges"][0]))
    if not (out["gauges"]["gauges_bit_equal"]
            and len(g) == len(OVERLAY_GAUGES) * serial["gauges"][1]
            and files["byte_identical"]
            and files.get("sharded_equal", True)
            and files.get("shards", OVERLAY_RANKS) == OVERLAY_RANKS
            and out["before_step"]["hook_changed_q"]):
        fail(f"[4n] gauges / before_step: {out['gauges']}, "
             f"{out['before_step']}")
    return out


# ---- the device loop: CUDA-graph replays against the host loop ----------

@contextlib.contextmanager
def host_loop():
    """Every solver takes the host loop (``traced_evolve = False``, one CFL
    readback per attempted step) inside the block."""
    from pyclaw_tpu_torch.solver import Solver
    Solver.traced_evolve = False
    try:
        yield
    finally:
        del Solver.traced_evolve


def loop_paths():
    """The main paths the loop phase drives: name -> (runner(dev, n, dtype,
    tfinal) -> (claw, status, wall), full size, reduced size, final time,
    the path's kernel, its launches per attempted step)."""
    return {
        "quadrants": (run_quadrants, 1024, 256, 0.8, "step2_ctu", 1),
        "sharpclaw": (lambda d, n, dt, t: run_quadrants(d, n, dt, t,
                                                        "sharpclaw"),
                      1024, 128, 0.8, "dq2_weno5", 10),
        "euler3d": (run_euler3d, 192, 48, 0.2, "step3_ctu", 1),
        "shallow": (run_shallow, 1024, 256, 1.0, "step2_aos", 1),
        "het": (run_het, 192, 48, 0.8, "step3_aos", 1),
        "euler3d_capa": (run_euler3d_capa, 192, 48, 0.2, "step3_ctu", 1),
        "sod": (lambda d, n, dt, t: run_sod(d, n, dt, "classic", t), 800,
                800, 0.2, "step1", 1),
        "sod_sharpclaw": (lambda d, n, dt, t: run_sod(d, n, dt, "sharpclaw",
                                                      t),
                          800, 800, 0.2, "weno5", 10)}


def check_path_launches(label, claw, status, counts, kernel, per_attempt,
                        graph=True, ran=None):
    """The launch counts of a path's run.  The wrappers' counts
    (``counts``): on the graph loop the path's kernel per_attempt times
    and ``restore`` once for each of the three attempts a capture makes
    (the eager warm-up and the two captured attempts), on the host loop
    the kernel per_attempt times an attempted step and no restore.  The
    device counters (``ran``, when given: the launches the card ran): the
    kernel per_attempt times and ``restore`` once (none on the host loop)
    an attempted step; on the graph loop the attempts are the accepted,
    the rejected and those after the loop's end, and there is at least
    one capture.  No other kernel in either (``kernel`` None: a path that
    runs no kernel of the port but restore).  Returns the solver's loop
    counters."""
    ns, nr = status["numsteps"], status["numrejected"]
    st = dict(claw.solver.loop_stats)
    attempts = st["attempts"] if graph else ns + nr
    if graph and (attempts != ns + nr + st["after_end"]
                  or st["captures"] < 1):
        fail(f"{label}: {attempts} attempts != {ns} + {nr} + "
             f"{st['after_end']} after the end, or no capture ({st})")
    if not graph and st["frames"]:
        fail(f"{label}: the host loop ran the device loop ({st})")
    made = 3 * st["captures"] if graph else attempts
    want = {"restore": made if graph else 0}
    if kernel is not None:
        want[kernel] = per_attempt * made
    if (any(counts[k] != v for k, v in want.items())
            or (kernel is not None and counts[kernel] == 0)):
        fail(f"{label}: the wrappers counted {counts} launches, not {want} "
             f"({st['captures']} captures, {attempts} attempted steps)")
    sources = [("the wrappers", counts)]
    if ran is not None:
        want = {"restore": attempts if graph else 0}
        if kernel is not None:
            want[kernel] = per_attempt * attempts
        if any(ran[k] != v for k, v in want.items()):
            fail(f"{label}: the card ran {ran} launches, not {want} "
                 f"({attempts} attempted steps)")
        sources.append(("the device counters", ran))
    for where, got in sources:
        others = {k: v for k, v in got.items()
                  if k not in (kernel, "restore") and v}
        if others:
            fail(f"{label}: other kernels launched ({where}): {others}")
    return st


def loop_phase(dev):
    """[4h]: each main path at a reduced size in float32 on the graph loop
    and on the host loop (``traced_evolve = False``): q equal bit for bit,
    the same accepted and rejected steps, the launch counts of each
    (check_path_launches: the wrappers' and the device counters'), the
    readbacks per output frame and the attempts after the end; then the
    path at full size on the graph loop and on the host loop, in turns and
    without the device counters: their walls, and the graph loop's
    counters with its warm-up and capture seconds."""
    out = {}
    for name, (run, n_full, n_small, tfinal, kernel, per) in \
            loop_paths().items():
        rec, qs = {}, {}
        for mode in ("graph", "host"):
            with (host_loop() if mode == "host" else contextlib.nullcontext()):
                claw, status, wall, counts, ran = counted_run(
                    lambda: run(dev, n_small, np.float32, tfinal))
            st = check_path_launches(f"[4h] {name} {n_small} {mode} loop",
                                     claw, status, counts, kernel, per,
                                     graph=mode == "graph", ran=ran)
            qs[mode] = claw.solution.q
            rec[mode] = {"accepted": status["numsteps"],
                         "rejected": status["numrejected"],
                         "wall_s_counted": wall, "launches": ran,
                         "wrapper_counts": counts, "loop": st,
                         "t": claw.solution.t, "dt": claw.solver.dt}
            del claw
        g, h = rec["graph"], rec["host"]
        equal = bool(np.array_equal(qs["graph"], qs["host"]))
        st = g["loop"]
        per_frame = st["readbacks"] / st["frames"]
        rec.update({"size": n_small, "equal_bits": equal,
                    "readbacks_per_frame": per_frame,
                    "attempts_after_end": st["after_end"]})
        print(f"[4h] {name} at {n_small} f32: graph loop {g['accepted']} + "
              f"{g['rejected']} steps ({st['frames']} frames, "
              f"{per_frame:.2f} readbacks a frame, {st['attempts']} "
              f"attempts, {st['after_end']} after the end, "
              f"{st['captures']} captures; {g['launches'][kernel]} {kernel} "
              f"launches the card ran); host loop {h['accepted']} + "
              f"{h['rejected']}; q equal bit for bit: {equal}", flush=True)
        if not (equal and (g["accepted"], g["rejected"], g["t"], g["dt"])
                == (h["accepted"], h["rejected"], h["t"], h["dt"])):
            fail(f"[4h] {name}: the graph loop differs from the host loop: "
                 f"{g['accepted']} + {g['rejected']} against "
                 f"{h['accepted']} + {h['rejected']}, dt {g['dt']!r} against "
                 f"{h['dt']!r}, q equal {equal}")
        count_on_device(None)
        for mode in ("graph", "host"):
            reset_kernel_counts()
            with (host_loop() if mode == "host" else contextlib.nullcontext()):
                claw, status, wall = run(dev, n_full, np.float32, tfinal)
            st = check_path_launches(f"[4h] {name} {n_full} {mode} loop",
                                     claw, status, kernel_counts(), kernel,
                                     per, graph=mode == "graph")
            rec[f"{mode}_full"] = {"accepted": status["numsteps"],
                                   "rejected": status["numrejected"],
                                   "wall_s": wall, "loop": st}
            print(f"    {name} at {n_full} f32 on the {mode} loop: "
                  f"{status['numsteps']} + {status['numrejected']} steps in "
                  f"{wall:.3f} s" + ("" if mode == "host" else
                                     f" ({st})"), flush=True)
            del claw
        count_on_device(dev)
        out[name] = rec
    return out


def loop_hooks(dev, n=200, tfinal=0.1):
    """[4i]: gauges (on the graph loop) and before_step (on the host loop)
    on the card against the same runs on the CPU: the Sod tube, classic, n
    cells, float64, two frames.  The gauge series: the same steps and
    times (1e-12), values to LOOP_HOOK_TOL; before_step (a hook that
    scales the momentum in place each step): the same steps, q to
    LOOP_HOOK_TOL."""
    from pyclaw_tpu_torch.examples import euler_1d_shocktube as ex

    def hook(solver, state):
        state.q[1] *= 0.999

    out = {}
    for case in ("gauges", "before_step"):
        runs = {}
        for where in (dev, "cpu"):
            claw = ex.setup(nx=n, solver_type="classic", outdir=None,
                            dtype=np.float64, device=where)
            claw.tfinal = tfinal
            claw.num_output_times = 2
            if case == "gauges":
                claw.solution.state.grid.add_gauges([(-0.2,), (0.05,),
                                                     (0.3,)])
            else:
                claw.solver.before_step = hook
            st = claw.run()
            runs[str(where)] = (claw, (st["numsteps"], st["numrejected"]))
        (ck, sk), (cc, sc) = runs[str(dev)], runs["cpu"]
        rec = {"steps_card": sk, "steps_cpu": sc,
               "q_max_rel": float(np.max(np.abs(ck.solution.q
                                                - cc.solution.q))
                                  / np.max(np.abs(cc.solution.q)))}
        if case == "gauges":
            gk, gc = ck.solution.state.gauge_data, cc.solution.state.gauge_data
            rec["samples"] = (len(gk), len(gc))
            rec["t_max_diff"] = max(abs(a[1] - b[1]) for a, b in zip(gk, gc))
            rec["values_max_rel"] = max(
                float(np.max(np.abs(np.asarray(a[2]) - np.asarray(b[2]))))
                for a, b in zip(gk, gc)) / float(np.max(np.abs(
                    cc.solution.q)))
            ok = (len(gk) == len(gc) == 3 * sk[0]
                  and rec["t_max_diff"] <= 1e-12
                  and rec["values_max_rel"] <= LOOP_HOOK_TOL
                  and ck.solver.loop_stats["captures"] >= 1)
        else:
            ok = not ck.solver.loop_stats["frames"]
        ok = ok and sk == sc and rec["q_max_rel"] <= LOOP_HOOK_TOL
        out[case] = rec
        print(f"[4i] {case} sod {n} f64 card vs cpu: {rec}", flush=True)
        if not ok:
            fail(f"[4i] {case}: the card's run differs from the CPU's: "
                 f"{rec}")
    return out


# restore's cases of [3i]: shapes of the paths' q (f32) and odd sizes
RESTORE_SHAPES = (((4, 1024, 1024), "float32"), ((3, 800), "float32"),
                  ((5, 192, 192, 192), "float32"), ((3, 7), "float32"),
                  ((4, 37, 131), "float64"), ((1,), "float64"))


def compare_restore(dev, seed=9):
    """[3i]: restore against its plain version (torch.where) on seeded data,
    an accepted and a rejected step each: equal bit for bit."""
    import torch
    from pyclaw_tpu_torch.ops import restore
    rng = np.random.default_rng(seed)
    worst, ncase = 0.0, 0
    for shape, tname in RESTORE_SHAPES:
        dtype = getattr(torch, tname)
        src = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                              device=dev)
        for ok in (True, False):
            dst = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                                  device=dev)
            flag = torch.tensor(ok, device=dev)
            want = restore.plain(dst.clone(), src, flag)
            got = restore.restore(dst, src, flag)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            ncase += 1
            if not torch.equal(got, want):
                fail(f"restore {shape} {tname} ok={ok}: differs from "
                     f"torch.where by {err}")
    return worst, ncase


def timing_restore(dev, shape=(4, 1024, 1024)):
    """restore at the classic quadrants path's q (f32): an accepted step
    (the path's case: one load of the flag a block) and a rejected one (a
    copy of q), CUDA events and the profiler's device time, against
    torch.where (its plain version and the one PyTorch call that computes
    the same), and the bound of each case: one byte read (accepted) or q
    read and written (rejected)."""
    import torch
    from pyclaw_tpu_torch.ops import restore
    src = torch.randn(shape, device=dev)
    dst = torch.randn(shape, device=dev)
    nbytes = dst.numel() * dst.element_size()
    out = {"shape": list(shape), "dtype": "float32"}
    for ok in (True, False):
        flag = torch.tensor(ok, device=dev)
        key = "accepted" if ok else "rejected"

        def kern():
            return restore.restore(dst, src, flag)

        def plain():
            return restore.plain(dst, src, flag)
        ms = time_ms(kern, 200)
        dev_ms, dev_n = device_ms_per_call(kern, "restore_kernel", 20)
        plain_ms = time_ms(plain, 200)
        b = bound_of(1 if ok else 2 * nbytes, 0, "float32")
        out[key] = {"ms": ms, "device_ms": dev_ms,
                    "device_launches_profiled": dev_n, "plain_ms": plain_ms,
                    "library_ms": plain_ms, **b}
        print(f"  timing restore {shape} f32 {key}: kernel {ms:.4f} ms (on "
              f"the device {dev_ms} ms, {dev_n} launches profiled), "
              f"torch.where {plain_ms:.4f} ms, bound {b['bound_ms']:.6f} ms "
              f"({b['bound_by']})", flush=True)
    return out


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a card")
    from pyclaw_tpu_torch.ops import _build, tiled2d

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {kind}; nvidia-smi: {card}; torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)

    # [2] build every kernel of the paths from the checkout's sources, one
    # nvcc per source, all started together
    t0 = time.perf_counter()
    names = ["step2_ctu", "dq2_weno5", "step3_ctu", "step2_aos", "step1",
             "weno5", "step3_aos", "restore", "dq2_weno"]
    (lib, dq_lib, lib3, lib_aos, lib_s1, lib_w5, lib_3a, _,
     _) = _build.load_all(names)
    print(f"[2] built csrc/step2_ctu.cu, csrc/dq2_weno5.cu, "
          f"csrc/step3_ctu.cu, csrc/step2_aos.cu, csrc/step1.cu, "
          f"csrc/weno5.cu, csrc/step3_aos.cu, csrc/restore.cu and "
          f"csrc/dq2_weno.cu for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s; shared memory per block: "
          f"step2_ctu f32 {lib.step2_ctu_smem_bytes(0)} B, f64 "
          f"{lib.step2_ctu_smem_bytes(1)} B; dq2_weno5 f32 "
          f"{dq_lib.dq2_weno5_smem_bytes(0)} B, f64 "
          f"{dq_lib.dq2_weno5_smem_bytes(1)} B, (acoustics) f32 "
          f"{dq_lib.dq2_weno5_acoustics_smem_bytes(0)} B, f64 "
          f"{dq_lib.dq2_weno5_acoustics_smem_bytes(1)} B; step3_ctu f32 "
          f"{lib3.step3_ctu_smem_bytes(0, 0)} B, f64 "
          f"{lib3.step3_ctu_smem_bytes(0, 1)} B, (with capacity) f32 "
          f"{lib3.step3_ctu_smem_bytes(1, 0)} B, f64 "
          f"{lib3.step3_ctu_smem_bytes(1, 1)} B; step2_aos (shallow Roe) f32 "
          f"{lib_aos.step2_aos_smem_bytes(0, 0, 0)} B, f64 "
          f"{lib_aos.step2_aos_smem_bytes(0, 0, 1)} B, (bathymetry with "
          f"capacity) f32 {lib_aos.step2_aos_smem_bytes(1, 1, 0)} B, f64 "
          f"{lib_aos.step2_aos_smem_bytes(1, 1, 1)} B, (acoustics) f32 "
          f"{lib_aos.step2_aos_smem_bytes(2, 0, 0)} B, f64 "
          f"{lib_aos.step2_aos_smem_bytes(2, 0, 1)} B; step1 (Euler) f32 "
          f"{lib_s1.step1_smem_bytes(2, 0, 0)} B, f64 "
          f"{lib_s1.step1_smem_bytes(2, 0, 1)} B, (advection with "
          f"capacity) f32 {lib_s1.step1_smem_bytes(0, 1, 0)} B, f64 "
          f"{lib_s1.step1_smem_bytes(0, 1, 1)} B, (sw_aug) f32 "
          f"{lib_s1.step1_smem_bytes(5, 0, 0)} B, f64 "
          f"{lib_s1.step1_smem_bytes(5, 0, 1)} B; step3_aos (heterogeneous "
          f"acoustics) f32 {lib_3a.step3_aos_smem_bytes(0, 0, 0)} B, f64 "
          f"{lib_3a.step3_aos_smem_bytes(0, 0, 1)} B, (with capacity) f32 "
          f"{lib_3a.step3_aos_smem_bytes(0, 1, 0)} B, f64 "
          f"{lib_3a.step3_aos_smem_bytes(0, 1, 1)} B", flush=True)
    phase_s = {"build": time.perf_counter() - t0}
    scalar_runs = {}
    from pyclaw_tpu_torch.ops import sweep
    efix_id = sweep.SYSTEMS_1D["euler_with_efix_1D"]
    print(f"    resident per SM: step2_ctu "
          f"{lib.step2_ctu_blocks_per_sm(0)} blocks of "
          f"{lib.step2_ctu_threads(0)} threads (f32), "
          f"{lib.step2_ctu_blocks_per_sm(1)} of {lib.step2_ctu_threads(1)} "
          f"(f64); dq2_weno5 "
          f"{dq_lib.dq2_weno5_blocks_per_sm(0)} blocks of 288 threads (f32), "
          f"{dq_lib.dq2_weno5_blocks_per_sm(1)} (f64), acoustics "
          f"{dq_lib.dq2_weno5_acoustics_blocks_per_sm(0)} (f32), "
          f"{dq_lib.dq2_weno5_acoustics_blocks_per_sm(1)} (f64); step2_aos "
          f"{lib_aos.step2_aos_system_blocks_per_sm(0, 0)} blocks of 256 "
          f"threads (f32), {lib_aos.step2_aos_system_blocks_per_sm(0, 1)} "
          f"(f64); step3_ctu "
          f"one block (its shared memory) of "
          f"{lib3.step3_ctu_threads(0, 0, 0)} threads (f32), "
          f"{lib3.step3_ctu_threads(0, 0, 1)} (f64), with capacity "
          f"{lib3.step3_ctu_threads(1, 0, 0)} (f32), "
          f"{lib3.step3_ctu_threads(1, 0, 1)} (f64); step3_aos one block "
          f"of {lib_3a.step3_aos_threads(0)} threads (f32), "
          f"{lib_3a.step3_aos_threads(1)} (f64); step1 (Euler) "
          f"{lib_s1.step1_system_blocks_per_sm(efix_id, 0)} blocks of 256 "
          f"threads (f32), {lib_s1.step1_system_blocks_per_sm(efix_id, 1)} "
          f"(f64); weno5 (large tile) "
          f"{lib_w5.weno5_blocks_per_sm(0)} blocks of 128 threads (f32), "
          f"{lib_w5.weno5_blocks_per_sm(1)} (f64)", flush=True)
    smem_new = {name: [lib_aos.step2_aos_smem_bytes(sid, c, d)
                       for d in (0, 1) for c in (0, 1)]
                for name, sid in (("Euler 4-wave", 3), ("Euler 5-wave", 4),
                                  ("sw_aug_2D", 5))}
    aos_euler = step2_aos_euler_resources(lib_aos,
                                          _build.build_report("step2_aos"))
    print("    step2_aos.cu's Euler instances (registers, stack frame B, "
          "spill stores / loads B, threads and shared memory B a block, "
          "launch bound, resident blocks per SM):", flush=True)
    for key, r in aos_euler.items():
        if key == "variants":
            print(f"      every capacity and f-wave variant: stack at most "
                  f"{r['stack']} B, spills at most {r['spill_stores']} / "
                  f"{r['spill_loads']} B", flush=True)
            continue
        print(f"      {key[0]} {key[1]}: {r['registers']} registers, stack "
              f"{r['stack']} B, spills {r['spill_stores']} / "
              f"{r['spill_loads']} B, {r['threads']} threads, "
              f"{r['smem_bytes']} B, launch bound {r['launch_bound']}, "
              f"{r['blocks_per_sm']} blocks", flush=True)
    print(f"    the instances of this slice: step2_aos shared memory "
          f"(f32 without and with capacity, then f64) {smem_new} B; blocks "
          f"per SM (the launch bound) sw_aug_2D "
          f"{lib_aos.step2_aos_system_blocks_per_sm(5, 0)} (f32), "
          f"{lib_aos.step2_aos_system_blocks_per_sm(5, 1)} (f64); dq2_weno5 "
          f"Euler 5-wave {dq_lib.dq2_weno5_euler5_smem_bytes(0)} B (f32), "
          f"{dq_lib.dq2_weno5_euler5_smem_bytes(1)} B (f64), resident "
          f"{dq_lib.dq2_weno5_euler5_blocks_per_sm(0)} (f32), "
          f"{dq_lib.dq2_weno5_euler5_blocks_per_sm(1)} (f64) blocks per SM",
          flush=True)
    smem_no_trans = {name: [lib_aos.step2_aos_smem_bytes(
        tiled2d.AOS_SYSTEMS[name][0], c, d) for d in (0, 1) for c in (0, 1)]
        for name in NO_TRANS_2D}
    print(f"    the instances without a transverse solver: step2_aos shared "
          f"memory (f32 without and with capacity, then f64) "
          f"{smem_no_trans} B", flush=True)
    smem_scalar = {name: [lib_aos.step2_aos_smem_bytes(
        tiled2d.AOS_SYSTEMS[name][0], c, d) for d in (0, 1) for c in (0, 1)]
        for name in SCALAR_2D}
    print(f"    the scalar instances: step2_aos shared memory (f32 without "
          f"and with capacity, then f64) {smem_scalar} B, blocks per SM "
          f"{lib_aos.step2_aos_system_blocks_per_sm(6, 0)} (f32), "
          f"{lib_aos.step2_aos_system_blocks_per_sm(6, 1)} (f64); step3_aos "
          f"burgers_3D {lib_3a.step3_aos_smem_bytes(3, 0, 0)} B (f32), "
          f"{lib_3a.step3_aos_smem_bytes(3, 0, 1)} B (f64), with capacity "
          f"{lib_3a.step3_aos_smem_bytes(3, 1, 0)} B (f32), "
          f"{lib_3a.step3_aos_smem_bytes(3, 1, 1)} B (f64)", flush=True)
    smem_lib = {name: [lib_s1.step1_smem_bytes(sweep.SYSTEMS_1D[name], c, d)
                       for d in (0, 1) for c in (0, 1)]
                for name in LIBRARY_1D}
    bps_lib = {name: [lib_s1.step1_system_blocks_per_sm(
        sweep.SYSTEMS_1D[name], d) for d in (0, 1)] for name in LIBRARY_1D}
    print(f"    step1's library systems (ids 6-15): shared memory (f32 "
          f"without and with capacity, then f64) {smem_lib} B; resident "
          f"blocks of 256 threads per SM (f32, f64) {bps_lib}; the build "
          f"seconds of each source {_build.build_seconds}", flush=True)
    if any(b < 1 for v in bps_lib.values() for b in v):
        fail(f"a step1 instance takes no block on an SM: {bps_lib}")
    dq_weno = dq_weno_resources(tiled2d, _build.build_report("dq2_weno"))
    print("    dq2_weno.cu's instances (registers, stack frame B, spill "
          "stores / loads B, threads and shared memory B a block, resident "
          "blocks per SM):", flush=True)
    for entry, r in dq_weno.items():
        print(f"      {entry}: {r['registers']} registers, stack "
              f"{r['stack']} B, spills {r['spill_stores']} / "
              f"{r['spill_loads']} B, {r['threads']} threads, "
              f"{r['smem_bytes']} B, {r['blocks_per_sm']} blocks",
              flush=True)
    redesigned = redesigned_resources(
        dq_lib, lib_3a, _build.build_report("dq2_weno5"),
        _build.build_report("step3_aos"))
    print("    the Euler 5-wave dq and burgers_3D instances (registers, "
          "stack frame B, spill stores / loads B, threads and shared "
          "memory B a block, resident blocks per SM):", flush=True)
    for key, r in redesigned.items():
        print(f"      {' '.join(str(k) for k in key)}: {r['registers']} "
              f"registers, stack {r['stack']} B, spills "
              f"{r['spill_stores']} / {r['spill_loads']} B, "
              f"{r['threads']} threads, {r['smem_bytes']} B, "
              f"{r['blocks_per_sm']} blocks", flush=True)
    print(f"    build wall {phase_s['build']:.1f} s; each source's nvcc "
          f"seconds from the start of the builds "
          f"{ {k: round(v, 1) for k, v in _build.build_seconds.items()} }",
          flush=True)
    for name in names:
        for line in _build.build_report(name).splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill", "smem")):
                print("    " + line.strip())

    grids = [(1024, 1024), (80, 80), (128, 128), (100, 37)]
    # [3] step2_ctu against its plain version
    t0 = time.perf_counter()
    worst, worst_cfl, main_abs_err, ncase = compare_kernel(
        dev, grids + [(64, 100)])
    print(f"[3] kernel vs plain: {ncase} cases, max rel err f32 "
          f"{worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{worst['float64']:.3e} (tol {TOL_REL['float64']}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3"] = time.perf_counter() - t0

    # [3b] dq2_weno5 against its plain version
    t0 = time.perf_counter()
    # beside the paths' grids: a grid smaller than one tile, and one
    # ragged on both axes with more tiles than resident blocks
    dq_worst, dq_main_abs_err, dq_ncase = compare_dq(
        dev, grids + [(7, 5), (600, 700)])
    print(f"[3b] dq2_weno5 vs plain: {dq_ncase} cases, max rel err f32 "
          f"{dq_worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{dq_worst['float64']:.3e} (tol {TOL_REL['float64']}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3b"] = time.perf_counter() - t0

    # [3c] step3_ctu against its plain version
    t0 = time.perf_counter()
    s3_worst, s3_worst_cfl, s3_main_abs_err, s3_ncase = compare_step3(dev)
    print(f"[3c] step3_ctu vs plain: {s3_ncase} cases, max rel err f32 "
          f"{s3_worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{s3_worst['float64']:.3e} (tol {TOL_REL['float64']}); max cfl "
          f"rel f32 {s3_worst_cfl['float32']:.3e}, f64 "
          f"{s3_worst_cfl['float64']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3c"] = time.perf_counter() - t0

    # [3d] step2_aos against its plain version
    t0 = time.perf_counter()
    aos_worst, aos_worst_cfl, aos_abs, aos_ncase = compare_aos(
        dev, [(1024, 1024), (60, 60), (125, 125), (64, 100), (100, 37)])
    print(f"[3d] step2_aos vs plain (shallow water and acoustics): "
          f"{aos_ncase} cases, max rel err f32 "
          f"{aos_worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{aos_worst['float64']:.3e} (tol {TOL_REL['float64']}); max cfl "
          f"rel f32 {aos_worst_cfl['float32']:.3e}, f64 "
          f"{aos_worst_cfl['float64']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3d"] = time.perf_counter() - t0

    # [3e] step1 against its plain version
    t0 = time.perf_counter()
    s1_worst, s1_abs, s1_ncase = compare_step1(dev)
    print(f"[3e] step1 vs plain (sixteen systems, sw_aug_1D on wet/dry "
          f"states, the library systems on seeded admissible states): "
          f"{s1_ncase} cases, max rel err f32 "
          f"{s1_worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{s1_worst['float64']:.3e} (tol {TOL_REL['float64']}); the CFL "
          f"equal in every case; {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_s["3e"] = time.perf_counter() - t0

    # [3f] weno5 against its plain version
    t0 = time.perf_counter()
    w5_worst, w5_main_abs_err, w5_ncase = compare_weno5(dev)
    print(f"[3f] weno5 vs plain: {w5_ncase} cases, max rel err f32 "
          f"{w5_worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{w5_worst['float64']:.3e} (tol {TOL_REL['float64']}); constant "
          f"data finite; {time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3f"] = time.perf_counter() - t0

    # [3g] step3_aos against its plain version
    t0 = time.perf_counter()
    s3a_worst, s3a_worst_cfl, s3a_main_abs_err, s3a_ncase = \
        compare_step3_aos(dev)
    print(f"[3g] step3_aos vs plain: {s3a_ncase} cases, max rel err f32 "
          f"{s3a_worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{s3a_worst['float64']:.3e} (tol {TOL_REL['float64']}); max cfl "
          f"rel f32 {s3a_worst_cfl['float32']:.3e}, f64 "
          f"{s3a_worst_cfl['float64']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3g"] = time.perf_counter() - t0

    # [3h] step3_ctu's capacity and f-wave variants against the plain
    # version
    t0 = time.perf_counter()
    s3e_worst, s3e_worst_cfl, s3e_main_abs_err, s3e_ncase = \
        compare_step3_capa(dev)
    print(f"[3h] step3_ctu capacity/f-wave vs plain: {s3e_ncase} cases, "
          f"max rel err "
          f"f32 {s3e_worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{s3e_worst['float64']:.3e} (tol {TOL_REL['float64']}); max cfl "
          f"rel f32 {s3e_worst_cfl['float32']:.3e}, f64 "
          f"{s3e_worst_cfl['float64']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3h"] = time.perf_counter() - t0

    # [3i] restore (the device loop's guarded restore) against torch.where
    t0 = time.perf_counter()
    rs_worst, rs_ncase = compare_restore(dev)
    print(f"[3i] restore vs torch.where: {rs_ncase} cases, accepted and "
          f"rejected, equal bit for bit (max abs err {rs_worst}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3i"] = time.perf_counter() - t0

    # [3j] dq2_weno5's acoustics instance against its plain version
    t0 = time.perf_counter()
    dqa_worst, dqa_worst_cfl, dqa_main_abs_err, dqa_ncase = \
        compare_dq_acoustics(dev)
    print(f"[3j] dq2_weno5 acoustics vs plain: {dqa_ncase} cases, max rel "
          f"err f32 {dqa_worst['float32']:.3e} (tol {TOL_REL['float32']} or "
          f"{ULP_FACTOR} x the plain version's one-ulp change, by case), "
          f"f64 {dqa_worst['float64']:.3e} (tol {TOL_REL['float64']}); max "
          f"cfl rel f32 {dqa_worst_cfl['float32']:.3e}, f64 "
          f"{dqa_worst_cfl['float64']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3j"] = time.perf_counter() - t0

    # [3k] weno5 on the SharpClaw 3D path's moved layouts
    t0 = time.perf_counter()
    w3_worst, w3_main_abs_err, w3_ncase = compare_weno5_3d(dev)
    print(f"[3k] weno5 vs plain on (5, {WENO5_3D_N}^3), each axis moved "
          f"last: {w3_ncase} cases, max rel err f32 "
          f"{w3_worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{w3_worst['float64']:.3e} (tol {TOL_REL['float64']}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3k"] = time.perf_counter() - t0

    # [3l] step2_aos's Euler 4-wave, Euler 5-wave and sw_aug_2D instances
    # against their plain version
    t0 = time.perf_counter()
    aosn_worst, aosn_worst_cfl, aosn_abs, aosn_ncase = compare_aos_new(dev)
    print(f"[3l] step2_aos vs plain (Euler 4-wave, Euler 5-wave, sw_aug_2D):"
          f" {aosn_ncase} cases, max rel err f32 "
          f"{aosn_worst['float32']:.3e} (tol {TOL_REL['float32']}), f64 "
          f"{aosn_worst['float64']:.3e} (tol {TOL_REL['float64']}); max cfl "
          f"rel f32 {aosn_worst_cfl['float32']:.3e}, f64 "
          f"{aosn_worst_cfl['float64']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3l"] = time.perf_counter() - t0

    # [3m] dq2_weno5's Euler 5-wave instance against its plain version, on
    # [3b]'s grids
    t0 = time.perf_counter()
    dq5_worst, dq5_main_abs_err, dq5_ncase = compare_dq_euler5(
        dev, grids + [(7, 5), (600, 700)])
    print(f"[3m] dq2_weno5 euler5 vs plain: {dq5_ncase} cases, max rel err "
          f"f32 {dq5_worst['float32']:.3e} (tol {TOL_REL['float32']}, or "
          f"{ULP_FACTOR} x the one-ulp sensitivity on the fallback states), "
          f"f64 {dq5_worst['float64']:.3e} (tol {TOL_REL['float64']}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3m"] = time.perf_counter() - t0

    # [3n] step2_aos's scalar and variable-coefficient instances and [3o]
    # step3_aos's burgers_3D instance against their plain version
    t0 = time.perf_counter()
    sc_worst, sc_worst_cfl, sc_abs, sc_ncase = compare_scalar(dev)
    print(f"[3n] step2_aos vs plain (advection_2D, vc_advection_2D, "
          f"vc_advection_fwave_2D, vc_acoustics_2D, kpp_2D, burgers_2D): "
          f"{sc_ncase} cases, max rel err f32 {sc_worst['float32']:.3e} (tol "
          f"{TOL_REL['float32']}), f64 {sc_worst['float64']:.3e} (tol "
          f"{TOL_REL['float64']}); max cfl rel f32 "
          f"{sc_worst_cfl['float32']:.3e}, f64 {sc_worst_cfl['float64']:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_s["3n"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b3_worst, b3_worst_cfl, b3_abs, b3_ncase = compare_burgers3d(dev)
    print(f"[3o] step3_aos burgers_3D vs plain: {b3_ncase} cases, max rel "
          f"err f32 {b3_worst['float32']:.3e} (tol {TOL_REL['float32']}), "
          f"f64 {b3_worst['float64']:.3e} (tol {TOL_REL['float64']}); max "
          f"cfl rel f32 {b3_worst_cfl['float32']:.3e}, f64 "
          f"{b3_worst_cfl['float64']:.3e}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_s["3o"] = time.perf_counter() - t0

    def check_run(label, claw, ns, nr):
        q = claw.solution.q
        if nr < 1:
            fail(f"{label}: the first step at dt_initial=0.1 should be "
                 f"rejected")
        if q.shape != (4, 1024, 1024) or not np.all(np.isfinite(q)):
            fail(f"{label}: result is not finite (4, 1024, 1024)")
        if not claw.solution.state.is_valid():
            fail(f"{label}: state.is_valid() is False")
        if abs(claw.solution.t - 0.8) > 1e-12:
            fail(f"{label}: ended at t={claw.solution.t}")

    # [4] the classic main path, every launch count set to 0 just before it
    # and read just after; the device loop's counters.  From here to [6]
    # every wrapper also counts on the card (a replay's launches too)
    count_on_device(dev)
    t0 = time.perf_counter()
    claw, status, wall, counts, ran = counted_run(
        lambda: run_quadrants(dev, 1024, np.float32))
    launches = ran["step2_ctu"]
    rs_launches = ran["restore"]
    ns, nr = status["numsteps"], status["numrejected"]
    loop4 = check_path_launches("classic main path", claw, status, counts,
                                "step2_ctu", 1, ran=ran)
    print(f"[4] main path 1024^2 f32 to t={claw.solution.t}: {ns} accepted "
          f"+ {nr} rejected steps, {launches} kernel launches the card ran "
          f"({ran}; the wrappers' counts {counts}), {wall:.3f} s wall "
          f"with the device counters; device loop {loop4}", flush=True)
    check_run("classic main path", claw, ns, nr)
    q_soa = claw.solution.q.copy()

    # [4b] the SharpClaw path (WENO5 + SSP104), every launch count set to 0
    # just before it and read just after
    sclaw, sstatus, swall, counts, ran = counted_run(
        lambda: run_quadrants(dev, 1024, np.float32,
                              solver_type="sharpclaw"))
    dq_launches = ran["dq2_weno5"]
    sns, snr = sstatus["numsteps"], sstatus["numrejected"]
    loop4b = check_path_launches("sharpclaw path", sclaw, sstatus, counts,
                                 "dq2_weno5", 10, ran=ran)
    print(f"[4b] sharpclaw path 1024^2 f32 SSP104 to t={sclaw.solution.t}: "
          f"{sns} accepted + {snr} rejected steps, {dq_launches} dq2_weno5 "
          f"launches the card ran ({ran}; the wrappers' counts "
          f"{counts}), {swall:.3f} s wall with the device counters; "
          f"device loop {loop4b}", flush=True)
    check_run("sharpclaw path", sclaw, sns, snr)
    phase_s["4+4b"] = time.perf_counter() - t0

    # [4c] the 3D path (ClawSolver3D, Euler, 192^3 f32), launches read
    # around it
    t0 = time.perf_counter()
    n3 = 192
    claw3, status3, wall3, counts, ran = counted_run(
        lambda: run_euler3d(dev, n3, np.float32))
    s3_launches = ran["step3_ctu"]
    ns3, nr3 = status3["numsteps"], status3["numrejected"]
    loop4c = check_path_launches("euler_3d path", claw3, status3, counts,
                                 "step3_ctu", 1, ran=ran)
    print(f"[4c] euler_3d path {n3}^3 f32 to t={claw3.solution.t}: {ns3} "
          f"accepted + {nr3} rejected steps, {s3_launches} step3_ctu "
          f"launches the card ran ({ran}; the wrappers' counts "
          f"{counts}), {wall3:.3f} s wall with the device counters; "
          f"device loop {loop4c}", flush=True)
    q3 = claw3.solution.q
    if nr3 < 1:
        fail("euler_3d path: the first step at dt_initial=0.1 should be "
             "rejected")
    if q3.shape != (5, n3, n3, n3) or not np.all(np.isfinite(q3)):
        fail(f"euler_3d path: result is not finite (5, {n3}, {n3}, {n3})")
    if not claw3.solution.state.is_valid():
        fail("euler_3d path: state.is_valid() is False")
    if abs(claw3.solution.t - 0.2) > 1e-12:
        fail(f"euler_3d path: ended at t={claw3.solution.t}")
    del claw3
    phase_s["4c"] = time.perf_counter() - t0

    # [4d] the shallow-water path (radial dam break, 1024^2 f32), launches
    # read around it
    t0 = time.perf_counter()
    claw_sw, status_sw, wall_sw, counts, ran = counted_run(
        lambda: run_shallow(dev, 1024, np.float32))
    aos_launches = ran["step2_aos"]
    ns_sw, nr_sw = status_sw["numsteps"], status_sw["numrejected"]
    loop4d = check_path_launches("shallow path", claw_sw, status_sw, counts,
                                 "step2_aos", 1, ran=ran)
    q_sw = claw_sw.solution.q
    mass0 = float(np.sum(shallow_state(1024, 1024)[0], dtype=np.float64))
    mass_rel = abs(float(np.sum(q_sw[0], dtype=np.float64)) - mass0) / mass0
    mirror = float(np.abs(q_sw[0] - q_sw[0].T).max() / np.abs(q_sw[0]).max())
    print(f"[4d] shallow path 1024^2 f32 to t={claw_sw.solution.t}: {ns_sw} "
          f"accepted + {nr_sw} rejected steps, {aos_launches} step2_aos "
          f"launches the card ran ({ran}; the wrappers' counts "
          f"{counts}), device loop {loop4d}, {wall_sw:.3f} s wall with the "
          f"device counters; mass "
          f"change {mass_rel:.3e} (relative), max |h - h^T| / max h "
          f"{mirror:.3e}", flush=True)
    if nr_sw < 1:
        fail("shallow path: the first step at dt_initial=0.1 should be "
             "rejected")
    if q_sw.shape != (3, 1024, 1024) or not np.all(np.isfinite(q_sw)):
        fail("shallow path: result is not finite (3, 1024, 1024)")
    if not claw_sw.solution.state.is_valid() or np.min(q_sw[0]) <= 0.0:
        fail("shallow path: invalid state or a dry cell")
    if abs(claw_sw.solution.t - 1.0) > 1e-12:
        fail(f"shallow path: ended at t={claw_sw.solution.t}")
    # the front has not reached the boundary by t=1: no mass crosses it
    if not (mass_rel <= 1e-5 and mirror <= 1e-4):
        fail(f"shallow path: mass change {mass_rel} or mirror asymmetry "
             f"{mirror} too large")
    del claw_sw, q_sw
    phase_s["4d"] = time.perf_counter() - t0

    # [4e] the 1D Sod path (classic and SharpClaw, 800 cells, f32), every
    # launch count set to 0 just before each run and read just after
    t0 = time.perf_counter()
    sod = sod_path(dev)
    s1_launches = sod["classic"]["launches"]["step1"]
    w5_launches = sod["sharpclaw"]["launches"]["weno5"]
    phase_s["4e"] = time.perf_counter() - t0

    # [4f] the 3D heterogeneous-acoustics path (192^3 f32), every launch
    # count set to 0 just before it and read just after
    t0 = time.perf_counter()
    claw_h, status_h, wall_h, counts_h, ran = counted_run(
        lambda: run_het(dev, n3, np.float32))
    het_launches = ran["step3_aos"]
    ns_h, nr_h = status_h["numsteps"], status_h["numrejected"]
    loop4f = check_path_launches("het path", claw_h, status_h, counts_h,
                                 "step3_aos", 1, ran=ran)
    q_h = claw_h.solution.q
    print(f"[4f] acoustics_3d_heterogeneous path {n3}^3 f32 to "
          f"t={claw_h.solution.t}: {ns_h} accepted + {nr_h} rejected steps, "
          f"{het_launches} step3_aos launches the card ran ({ran}; the "
          f"wrappers' counts {counts_h}), {wall_h:.3f} s wall with the "
          f"device counters; device loop {loop4f}", flush=True)
    if nr_h < 1:
        fail("het path: the first step at dt_initial=0.1 should be rejected")
    if q_h.shape != (4, n3, n3, n3) or not np.all(np.isfinite(q_h)):
        fail(f"het path: result is not finite (4, {n3}, {n3}, {n3})")
    if abs(claw_h.solution.t - 0.8) > 1e-12:
        fail(f"het path: ended at t={claw_h.solution.t}")
    del claw_h
    phase_s["4f"] = time.perf_counter() - t0

    # [4g] the 3D Euler capacity path (192^3 f32), every launch count set
    # to 0 just before it and read just after
    t0 = time.perf_counter()
    claw_e, status_e, wall_e, counts_e, ran = counted_run(
        lambda: run_euler3d_capa(dev, n3, np.float32))
    eu_launches = ran["step3_ctu"]
    ns_e, nr_e = status_e["numsteps"], status_e["numrejected"]
    loop4g = check_path_launches("euler capacity path", claw_e, status_e,
                                 counts_e, "step3_ctu", 1, ran=ran)
    q_e = claw_e.solution.q
    print(f"[4g] euler_3d capacity path {n3}^3 f32 to t={claw_e.solution.t}: "
          f"{ns_e} accepted + {nr_e} rejected steps, {eu_launches} step3_ctu "
          f"launches the card ran ({ran}; the wrappers' counts "
          f"{counts_e}), {wall_e:.3f} s wall with the device counters; device "
          f"loop {loop4g}", flush=True)
    if nr_e < 1:
        fail("euler capacity path: the first step at dt_initial=0.1 should "
             "be rejected")
    if q_e.shape != (5, n3, n3, n3) or not np.all(np.isfinite(q_e)):
        fail(f"euler capacity path: result is not finite (5, {n3}, {n3}, "
             f"{n3})")
    if not claw_e.solution.state.is_valid():
        fail("euler capacity path: state.is_valid() is False")
    if abs(claw_e.solution.t - 0.2) > 1e-12:
        fail(f"euler capacity path: ended at t={claw_e.solution.t}")
    del claw_e
    phase_s["4g"] = time.perf_counter() - t0

    # [4j] the acoustics path (1024^2 f32), [4k] the dry dam break (500
    # cells, f32 and f64), [4l] the Sod tube with char_decomp=2 (800 cells
    # f32), every launch count set to 0 just before each and read just
    # after
    t0 = time.perf_counter()
    acou = acoustics_path(dev)
    phase_s["4j"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dam = dam_path(dev)
    phase_s["4k"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    chardecomp = chardecomp_path(dev)
    phase_s["4l"] = time.perf_counter() - t0

    # [4o] the SharpClaw 3D path: Euler 3D (192^3 f32, the generic dq
    # on weno5.cu); [4p] the SharpClaw routes of acoustics_2d (the
    # acoustics instance of dq2_weno5.cu), shallow_2d_radial and
    # acoustics_3d_heterogeneous; every launch count set to 0 just before
    # each run and read just after
    t0 = time.perf_counter()
    sharp3d = sharpclaw3d_path(dev)
    phase_s["4o"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    routes = sharpclaw_routes(dev)
    phase_s["4p"] = time.perf_counter() - t0

    # [4q] the slice's path: shock_bubble classic (2048x512) and SharpClaw
    # (1024x256); the quadrants off the SoA route beside [4]'s run; [4r]
    # the sw_aug_2D runs; every launch count set to 0 just before each run
    # and read just after
    t0 = time.perf_counter()
    bubble = shock_bubble_path(dev)
    routes_q = quadrants_routes(dev, q_soa, (ns, nr))
    del q_soa
    phase_s["4q"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    swaug = sw_aug_paths(dev)
    phase_s["4r"] = time.perf_counter() - t0

    # [4s]-[4v] the runs of this slice's systems: kpp, the material
    # interface, the three advection systems, Burgers in 2D and 3D; every
    # launch count set to 0 just before each run and read just after
    for key, phase in (("4s", kpp_path), ("4t", interface_path),
                       ("4u", advection_paths), ("4v", burgers_paths)):
        t0 = time.perf_counter()
        scalar_runs[key] = phase(dev)
        phase_s[key] = time.perf_counter() - t0

    # [4w] this slice's paths: the instances without a transverse solver
    # against their plain version; psystem_2d and shallow_sphere split and
    # unsplit, the forward step, the 3D acoustics split and
    # advection-reaction's sources, every launch count set to 0 just before
    # each run and read just after; the routes' profiles; the card against
    # the CPU
    t0 = time.perf_counter()
    split = split_phase(dev)
    phase_s["4w"] = time.perf_counter() - t0

    # [4x] this slice's paths: stegoton at 2^20 cells (f32 and f64, to
    # t=20) and its golden, every new example on each route (f32 and f64,
    # each against its plain version on the card in f64), every launch
    # count set to 0 just before each run and read just after
    t0 = time.perf_counter()
    library = library_phase(dev)
    phase_s["4x"] = time.perf_counter() - t0

    # [4y] this slice's paths: the quadrants at WENO order 7 (1024^2 f32
    # to t=0.8), every instance of dq2_weno.cu against its plain version
    # and on a short path, the RK and multistep integrators, lim_type 0/1
    # and tfluct, every launch count set to 0 just before each run and
    # read just after
    t0 = time.perf_counter()
    options = options_phase(dev)
    phase_s["4y"] = time.perf_counter() - t0

    # [4z] frames in every format on the classic main path, read back, the
    # native writer against the plain one, restarts, a binary frame
    t0 = time.perf_counter()
    frames = frames_phase(dev)
    phase_s["4z"] = time.perf_counter() - t0

    # [4m] the parallel overlay in a world of one NCCL rank against [4c];
    # [4n] four ranks against the serial runs, every launch count of each
    # rank set to 0 just before each run and read just after
    t0 = time.perf_counter()
    overlay_one = nccl_one_rank(dev, q3, ns3, nr3)
    phase_s["4m"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    overlay_four = four_ranks(dev)
    phase_s["4n"] = time.perf_counter() - t0

    # [5v] the validator on the card: the ten golden cases of
    # tools/tpu_validate.py in float32 and float64 (it takes over the
    # goldens of the earlier phases [5], [5c], [5d] and three of [5e])
    t0 = time.perf_counter()
    validator = validator_phase(dev)
    golden = {k: v["rel_err"] for k, v in validator.items()}
    phase_s["5v"] = time.perf_counter() - t0

    # [5d] a lake at rest on the card
    tiled2d.step2_rows_generic.launches = 0
    eta_drift, mom, lake_loop = lake_at_rest(dev, 1024, np.float32, 0.05)
    lake_launches = tiled2d.step2_rows_generic.launches
    lake_steps = lake_loop["attempts"]
    print(f"[5d] lake at rest 1024^2 f32 to t=0.05: {lake_steps} attempted "
          f"steps, the wrapper counted "
          f"{lake_launches} step2_aos launches (eager or captured, "
          f"{lake_loop['captures']} captures), max |eta - eta0| "
          f"{eta_drift:.3e}, max |hu|, |hv| {mom:.3e} (tol {LAKE_TOL})",
          flush=True)
    if not (lake_launches == 3 * lake_loop["captures"] > 0
            and lake_steps > 0 and eta_drift <= LAKE_TOL
            and mom <= LAKE_TOL):
        fail(f"lake at rest: drift {eta_drift}, momentum {mom}, launches "
             f"{lake_launches} for {lake_loop}")

    # [5e] the two 1D goldens that the validator has no case for
    t0 = time.perf_counter()
    golden.update(goldens_1d(dev))
    phase_s["5e"] = time.perf_counter() - t0

    # [5f] the heterogeneous path's correctness
    t0 = time.perf_counter()
    het = het_checks(dev, q_h, n3)
    phase_s["5f"] = time.perf_counter() - t0

    # [5g] the Euler capacity path's correctness
    t0 = time.perf_counter()
    eu_checks = euler_capa_checks(dev, q_e, n3)
    phase_s["5g"] = time.perf_counter() - t0

    # [5s] SharpClaw 3D on the card against the same runs on the CPU
    t0 = time.perf_counter()
    sharp3d_vs_cpu = sharpclaw3d_card_vs_cpu(dev)
    phase_s["5s"] = time.perf_counter() - t0

    # [5b] SharpClaw on the card against the same run on the CPU
    t0 = time.perf_counter()
    sharp_vs_cpu = sharp_card_vs_cpu(dev)
    phase_s["5b"] = time.perf_counter() - t0

    # [5x] shock_bubble and the 2D dry dam break on the card against the
    # same runs on the CPU
    t0 = time.perf_counter()
    new_vs_cpu = card_vs_cpu_new(dev)
    phase_s["5x"] = time.perf_counter() - t0

    # [5y] [4s]-[4v]'s runs at small grids on the card against the CPU
    t0 = time.perf_counter()
    scalar_vs_cpu = scalar_card_vs_cpu(dev)
    phase_s["5y"] = time.perf_counter() - t0

    # [4h] the device loop against the host loop on every main path; [4i]
    # gauges and before_step on the card against the CPU
    t0 = time.perf_counter()
    loops = loop_phase(dev)
    phase_s["4h"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    hooks = loop_hooks(dev)
    phase_s["4i"] = time.perf_counter() - t0

    # [6] timing and a profile window of each path, without the device
    # counters
    count_on_device(None)
    t0 = time.perf_counter()
    # each item's seconds (phase_seconds "6:<item>")
    last = [t0]

    def lap(key):
        now = time.perf_counter()
        phase_s[f"6:{key}"] = now - last[0]
        last[0] = now

    tm = timing(dev)
    lap("tm")
    tm_dq = timing_dq(dev)
    lap("tm_dq")
    tm3 = timing_step3(dev, q_last=q3)
    lap("tm3")
    del q3
    tm_aos = timing_aos(dev)
    lap("tm_aos")
    tm_aos_ac = timing_aos(dev, system=ACOUSTICS_2D)
    lap("tm_aos_ac")
    tm_het = timing_step3_aos(dev, q_last=q_h)
    lap("tm_het")
    del q_h
    tm_eu = timing_step3_capa(dev, q_last=q_e)
    lap("tm_eu")
    del q_e
    tm_rs = timing_restore(dev)
    lap("tm_rs")
    tm_dq_ac = timing_dq_acoustics(dev)
    lap("tm_dq_ac")
    tm_w5_3d = timing_weno5_3d(dev)
    lap("tm_w5_3d")
    tm_aos_new = {name: timing_aos(dev, system=name)
                  for name in (EULER4, EULER5, SW_AUG)}
    lap("tm_aos_new")
    tm_dq_e5 = timing_dq_euler5(dev)
    lap("tm_dq_e5")
    tm_scalar = {name: timing_scalar(dev, name) for name in SCALAR_2D}
    lap("tm_scalar")
    tm_b3 = timing_burgers3d(dev)
    lap("tm_b3")
    tm_no_trans = {name: timing_no_trans(dev, name) for name in NO_TRANS_2D}
    lap("tm_no_trans")
    tm_lib = timing_library(dev)
    lap("tm_lib")
    tm_dq_weno = timing_dq_weno(dev)
    lap("tm_dq_weno")
    prof = profile_loops(
        "classic main path 1024^2 f32 to t=0.1",
        lambda: run_quadrants(dev, 1024, np.float32, 0.1))
    lap("prof")
    sprof = profile_loops(
        "sharpclaw main path 1024^2 f32 to t=0.1",
        lambda: run_quadrants(dev, 1024, np.float32, 0.1, "sharpclaw"))
    lap("sprof")
    prof3 = profile_loops(
        "euler_3d main path 192^3 f32 to t=0.02",
        lambda: run_euler3d(dev, 192, np.float32, 0.02))
    lap("prof3")
    prof_sw = profile_loops(
        "shallow path 1024^2 f32 to t=0.1",
        lambda: run_shallow(dev, 1024, np.float32, 0.1))
    lap("prof_sw")
    prof_het = profile_loops(
        "acoustics_3d_heterogeneous path 192^3 f32 to t=0.8",
        lambda: run_het(dev, 192, np.float32))
    lap("prof_het")
    prof_eu = profile_loops(
        "euler_3d capacity path 192^3 f32 to t=0.02",
        lambda: run_euler3d_capa(dev, 192, np.float32, 0.02))
    lap("prof_eu")
    tm_1d = timing_1d(dev)
    lap("tm_1d")
    prof_sod = profile_loops(
        "sod classic path 800 f32 to t=0.2",
        lambda: run_sod(dev, 800, np.float32, "classic"))
    # a short window: the SharpClaw stage is ~230 small launches, and the
    # profiler's bookkeeping of a whole run takes minutes
    lap("prof_sod")
    prof_sod_sharp = profile_loops(
        "sod sharpclaw path 800 f32 to t=0.005",
        lambda: run_sod(dev, 800, np.float32, "sharpclaw", 0.005))
    lap("prof_sod_sharp")
    prof_ac = profile_loops(
        "acoustics path 1024^2 f32 to t=0.12",
        lambda: run_acoustics(dev, 1024, np.float32))
    lap("prof_ac")
    prof_dam = profile_loops(
        "dam_break_dry path 500 f32 to t=0.5",
        lambda: run_dam(dev, 500, np.float32, 0.5))
    lap("prof_dam")
    prof_cd = profile_loops(
        "sod sharpclaw char_decomp=2 path 800 f32 to t=0.005",
        lambda: run_sod(dev, 800, np.float32, "sharpclaw", 0.005, 2))
    # [4o]'s path, the device loop only (its host loop takes minutes under
    # the profiler): the busy share and weno5's share of the device time
    lap("prof_cd")
    prof_s3 = profile_main_path(
        "[4o] sharpclaw euler_3d path 192^3 f32 to t=0.02, device loop",
        lambda: run_euler3d(dev, 192, np.float32, 0.02,
                            solver_type="sharpclaw"))

    lap("prof_s3")
    phase_s["6"] = time.perf_counter() - t0

    f32, f64 = tm["float32"], tm["float64"]
    record = {
        "name": "step2_ctu", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/step2_ctu.cu",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:113",
        "replaces_function": "step2_pallas_rows (SoA body); "
                             "step2_pallas_tiled (ops/tiled2d.py:52)",
        "rows": ["1", "4"],
        "launches": launches,
        "overlay_launches": {"4n": overlay_four["quadrants"]["launches"]},
        "max_abs_err": main_abs_err,
        "ms": f32["ms"], "device_ms": f32["device_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": None,
        "shape": [4, 1028, 1028], "dtype": "float32",
        "ms_f64": f64["ms"], "device_ms_f64": f64["device_ms"],
        "plain_ms_f64": f64["plain_ms"],
        "bound_ms_f64": f64["bound_ms"], "bound_by_f64": f64["bound_by"],
        "max_rel_err_f64": worst["float64"],
        "max_rel_err_f32": worst["float32"],
    }
    d32, d64 = tm_dq["float32"], tm_dq["float64"]
    dq_record = {
        "name": "dq2_weno5", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/dq2_weno5.cu",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:314",
        "replaces_function": "dq_pallas_rows", "rows": ["2"],
        "redesigned_in": 7,
        "launches": dq_launches,
        "overlay_launches": {"4n": overlay_four["sharpclaw"]["launches"]},
        "max_abs_err": dq_main_abs_err,
        "ms": d32["ms"], "device_ms": d32["device_ms"],
        "plain_ms": d32["plain_ms"],
        "bound_ms": d32["bound_ms"], "bound_by": d32["bound_by"],
        "library_ms": None,
        "shape": [4, 1030, 1030], "dtype": "float32",
        "ms_f64": d64["ms"], "device_ms_f64": d64["device_ms"],
        "plain_ms_f64": d64["plain_ms"],
        "bound_ms_f64": d64["bound_ms"], "bound_by_f64": d64["bound_by"],
        "max_rel_err_f64": dq_worst["float64"],
        "max_rel_err_f32": dq_worst["float32"],
    }
    t32, t64 = tm3["float32"], tm3["float64"]
    s3_record = {
        "name": "step3_ctu", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/step3_ctu.cu",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:431",
        "replaces_function": "step3_pallas_xy", "rows": ["3"],
        "launches": s3_launches,
        "overlay_launches": {
            "4m": overlay_one["launches"]["step3_ctu"],
            "4n": overlay_four["euler3d"]["launches"]},
        "max_abs_err": s3_main_abs_err,
        "ms": t32["ms"], "device_ms": t32["device_ms"],
        "ms_last_state": t32["ms_last_state"],
        "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
        "library_ms": None,
        "shape": [5, 196, 196, 196], "dtype": "float32",
        "ms_f64": t64["ms"], "device_ms_f64": t64["device_ms"],
        "ms_last_state_f64": t64["ms_last_state"],
        "plain_ms_f64": t64["plain_ms"],
        "bound_ms_f64": t64["bound_ms"], "bound_by_f64": t64["bound_by"],
        "max_rel_err_f64": s3_worst["float64"],
        "max_rel_err_f32": s3_worst["float32"],
    }
    a32, a64 = tm_aos["float32"], tm_aos["float64"]
    aos_record = {
        "name": "step2_aos", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/step2_aos.cu",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:113",
        "replaces_function": "step2_pallas_rows (generic body "
                             "classic/kernels.py:345 step2_roll); "
                             "step2_pallas_tiled_generic "
                             "(ops/tiled2d.py:609); step2_pallas "
                             "(ops/sweep2d.py:41)",
        "rows": ["1b", "5", "6"],
        "launches": aos_launches, "max_abs_err": aos_abs["shallow"],
        "ms": a32["ms"], "device_ms": a32["device_ms"],
        "plain_ms": a32["plain_ms"],
        "bound_ms": a32["bound_ms"], "bound_by": a32["bound_by"],
        "library_ms": None,
        "shape": [3, 1028, 1028], "dtype": "float32",
        "ms_f64": a64["ms"], "device_ms_f64": a64["device_ms"],
        "plain_ms_f64": a64["plain_ms"],
        "bound_ms_f64": a64["bound_ms"], "bound_by_f64": a64["bound_by"],
        "max_rel_err_f64": aos_worst["float64"],
        "max_rel_err_f32": aos_worst["float32"],
    }
    k32, k64 = tm_1d["step1"]["800:float32"], tm_1d["step1"]["800:float64"]
    big32 = tm_1d["step1"][f"{2 ** 20}:float32"]
    big64 = tm_1d["step1"][f"{2 ** 20}:float64"]
    s1_record = {
        "name": "step1", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/step1.cu",
        "replaces": "pyclaw_tpu/ops/sweep.py:35",
        "replaces_function": "step1_pallas", "rows": ["7"],
        "launches": s1_launches,
        "overlay_launches": {"4n": overlay_four["sod"]["launches"]},
        "max_abs_err": s1_abs["sod"],
        "ms": k32["ms"], "device_ms": k32["device_ms"],
        "plain_ms": k32["plain_ms"],
        "bound_ms": k32["bound_ms"], "bound_by": k32["bound_by"],
        "library_ms": None,
        "shape": k32["shape"], "dtype": "float32",
        "ms_f64": k64["ms"], "device_ms_f64": k64["device_ms"],
        "plain_ms_f64": k64["plain_ms"],
        "bound_ms_f64": k64["bound_ms"], "bound_by_f64": k64["bound_by"],
        "shape_large": big32["shape"], "ms_large": big32["ms"],
        "device_ms_large": big32["device_ms"],
        "device_ms_large_f64": big64["device_ms"],
        "plain_ms_large": big32["plain_ms"],
        "bound_ms_large": big32["bound_ms"],
        "bound_by_large": big32["bound_by"], "ms_large_f64": big64["ms"],
        "plain_ms_large_f64": big64["plain_ms"],
        "bound_ms_large_f64": big64["bound_ms"],
        "max_rel_err_f64": s1_worst["float64"],
        "max_rel_err_f32": s1_worst["float32"],
        **smooth_keys(tm_1d["step1"]),
    }
    w32, w64 = tm_1d["weno5"]["800:float32"], tm_1d["weno5"]["800:float64"]
    wbig32 = tm_1d["weno5"][f"{2 ** 20}:float32"]
    wbig64 = tm_1d["weno5"][f"{2 ** 20}:float64"]
    w5_record = {
        "name": "weno5", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/weno5.cu",
        "replaces": "pyclaw_tpu/ops/weno.py:76",
        "replaces_function": "weno5_pallas", "rows": ["8"],
        "launches": w5_launches, "max_abs_err": w5_main_abs_err,
        "ms": w32["ms"], "device_ms": w32["device_ms"],
        "plain_ms": w32["plain_ms"],
        "bound_ms": w32["bound_ms"], "bound_by": w32["bound_by"],
        "library_ms": None,
        "shape": w32["shape"], "dtype": "float32",
        "ms_f64": w64["ms"], "device_ms_f64": w64["device_ms"],
        "plain_ms_f64": w64["plain_ms"],
        "bound_ms_f64": w64["bound_ms"], "bound_by_f64": w64["bound_by"],
        "shape_large": wbig32["shape"], "ms_large": wbig32["ms"],
        "device_ms_large": wbig32["device_ms"],
        "device_ms_large_f64": wbig64["device_ms"],
        "plain_ms_large": wbig32["plain_ms"],
        "bound_ms_large": wbig32["bound_ms"],
        "bound_by_large": wbig32["bound_by"], "ms_large_f64": wbig64["ms"],
        "plain_ms_large_f64": wbig64["plain_ms"],
        "bound_ms_large_f64": wbig64["bound_ms"],
        "max_rel_err_f64": w5_worst["float64"],
        "max_rel_err_f32": w5_worst["float32"],
        **smooth_keys(tm_1d["weno5"]),
    }
    h32, h64 = tm_het["float32"], tm_het["float64"]
    het_record = {
        "name": "step3_aos", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/step3_aos.cu",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:431",
        "replaces_function": "step3_pallas_xy",
        "replaces_body": "kernel_aux (ops/tiled2d.py:490-518; "
                         "classic/kernels.py:806 step3_roll with aux, "
                         "index_capa, fwave)",
        "rows": ["3b"],
        "redesigned_in": 7,
        "launches": het_launches, "max_abs_err": s3a_main_abs_err,
        "ms": h32["ms"], "device_ms": h32["device_ms"],
        "plain_ms": h32["plain_ms"],
        "bound_ms": h32["bound_ms"], "bound_by": h32["bound_by"],
        "library_ms": None,
        "shape": [4, 196, 196, 196], "aux_shape": [2, 196, 196, 196],
        "dtype": "float32",
        "ms_f64": h64["ms"], "device_ms_f64": h64["device_ms"],
        "plain_ms_f64": h64["plain_ms"],
        "bound_ms_f64": h64["bound_ms"], "bound_by_f64": h64["bound_by"],
        "max_rel_err_f64": s3a_worst["float64"],
        "max_rel_err_f32": s3a_worst["float32"],
    }
    e32, e64 = tm_eu["float32"], tm_eu["float64"]
    eu_record = {
        "name": "step3_ctu:capacity", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/step3_ctu.cu",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:431",
        "replaces_function": "step3_pallas_xy",
        "replaces_body": "kernel_aux (ops/tiled2d.py:490-518) with Euler "
                         "and a capacity function; kernel (:520-563) with "
                         "fwave=True",
        "rows": ["4c"],
        "launches": eu_launches, "max_abs_err": s3e_main_abs_err,
        "ms": e32["ms"], "device_ms": e32["device_ms"],
        "ms_last_state": e32["ms_last_state"],
        "plain_ms": e32["plain_ms"],
        "bound_ms": e32["bound_ms"], "bound_by": e32["bound_by"],
        "library_ms": None,
        "shape": [5, 196, 196, 196], "aux_shape": [1, 196, 196, 196],
        "dtype": "float32",
        "ms_f64": e64["ms"], "device_ms_f64": e64["device_ms"],
        "ms_last_state_f64": e64["ms_last_state"],
        "plain_ms_f64": e64["plain_ms"],
        "bound_ms_f64": e64["bound_ms"], "bound_by_f64": e64["bound_by"],
        "max_rel_err_f64": s3e_worst["float64"],
        "max_rel_err_f32": s3e_worst["float32"],
    }
    ra, rr = tm_rs["accepted"], tm_rs["rejected"]
    rs_record = {
        "name": "restore", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/restore.cu",
        "replaces": "pyclaw_tpu/solver.py:320",
        "replaces_function": "jnp.where(ok, q_new, q_) in the body of "
                             "_make_evolve_fn's while_loop (XLA fuses it; "
                             "no pallas_call)",
        "rows": ["loop"],
        "launches": rs_launches, "max_abs_err": rs_worst,
        "ms": ra["ms"], "device_ms": ra["device_ms"],
        "plain_ms": ra["plain_ms"],
        "bound_ms": ra["bound_ms"], "bound_by": ra["bound_by"],
        "library_ms": ra["library_ms"],
        "shape": tm_rs["shape"], "dtype": "float32", "case": "accepted",
        "ms_rejected": rr["ms"], "device_ms_rejected": rr["device_ms"],
        "plain_ms_rejected": rr["plain_ms"],
        "bound_ms_rejected": rr["bound_ms"],
        "bound_by_rejected": rr["bound_by"],
    }
    c32, c64 = tm_aos_ac["float32"], tm_aos_ac["float64"]
    aos_ac_record = {
        "name": "step2_aos:acoustics_2D", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/step2_aos.cu",
        "system_source": "pyclaw_tpu_torch/csrc/acoustics2d.cuh",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:113",
        "replaces_function": "step2_pallas_rows (SoA body classic/soa.py:"
                             "202 for acoustics_2D without aux; generic "
                             "body classic/kernels.py:345 with aux)",
        "rows": ["1b"],
        "launches": acou["launches"]["step2_aos"],
        "max_abs_err": aos_abs["acoustics"],
        "ms": c32["ms"], "device_ms": c32["device_ms"],
        "plain_ms": c32["plain_ms"],
        "bound_ms": c32["bound_ms"], "bound_by": c32["bound_by"],
        "library_ms": None,
        "shape": [3, 1028, 1028], "dtype": "float32",
        "ms_f64": c64["ms"], "device_ms_f64": c64["device_ms"],
        "plain_ms_f64": c64["plain_ms"],
        "bound_ms_f64": c64["bound_ms"], "bound_by_f64": c64["bound_by"],
        "max_rel_err_f64": aos_worst["float64"],
        "max_rel_err_f32": aos_worst["float32"],
    }
    d32 = tm_1d["step1"][f"dam {2 ** 20}:float32"]
    d64 = tm_1d["step1"][f"dam {2 ** 20}:float64"]
    s1_sw_record = {
        "name": "step1:sw_aug_1D", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/step1.cu",
        "system_source": "pyclaw_tpu_torch/csrc/systems1d.cuh",
        "replaces": "pyclaw_tpu/ops/sweep.py:35",
        "replaces_function": "step1_pallas", "rows": ["7"],
        "launches": dam["float32"]["launches"]["step1"],
        "max_abs_err": s1_abs["sw_aug"],
        "ms": d32["ms"], "device_ms": d32["device_ms"],
        "plain_ms": d32["plain_ms"],
        "bound_ms": d32["bound_ms"], "bound_by": d32["bound_by"],
        "library_ms": None,
        "shape": d32["shape"], "aux_shape": [1, d32["shape"][1]],
        "dtype": "float32", "share_of_device": d32["share_of_device"],
        "ms_f64": d64["ms"], "device_ms_f64": d64["device_ms"],
        "plain_ms_f64": d64["plain_ms"],
        "bound_ms_f64": d64["bound_ms"], "bound_by_f64": d64["bound_by"],
        "max_rel_err_f64": s1_worst["float64"],
        "max_rel_err_f32": s1_worst["float32"],
    }
    q32, q64 = tm_dq_ac["float32"], tm_dq_ac["float64"]
    dq_ac_record = {
        "name": "dq2_weno5:acoustics_2D", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/dq2_weno5.cu",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:314",
        "replaces_function": "dq_pallas_rows (body sharpclaw/soa.py:237 "
                             "with acoustics_2D's SoA hooks)",
        "rows": ["2"],
        "launches": routes["acoustics_2d"]["launches"]["dq2_weno5"],
        "max_abs_err": dqa_main_abs_err,
        "ms": q32["ms"], "device_ms": q32["device_ms"],
        "plain_ms": q32["plain_ms"],
        "bound_ms": q32["bound_ms"], "bound_by": q32["bound_by"],
        "library_ms": None,
        "shape": [3, 1030, 1030], "dtype": "float32",
        "ms_f64": q64["ms"], "device_ms_f64": q64["device_ms"],
        "plain_ms_f64": q64["plain_ms"],
        "bound_ms_f64": q64["bound_ms"], "bound_by_f64": q64["bound_by"],
        "max_rel_err_f64": dqa_worst["float64"],
        "max_rel_err_f32": dqa_worst["float32"],
    }
    v32, v64 = tm_w5_3d["float32"], tm_w5_3d["float64"]
    w5_3d_record = {
        "name": "weno5:sharpclaw_3d", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/weno5.cu",
        "replaces": "pyclaw_tpu/ops/weno.py:76",
        "replaces_function": "weno5_pallas, as sharpclaw/kernels.py:dq_nd "
                             "calls it on each axis",
        "rows": ["8"],
        "launches": sharp3d["launches"]["weno5"],
        "overlay_launches": {"4n": overlay_four["sharpclaw3d"]["launches"]},
        "max_abs_err": w3_main_abs_err,
        "ms": v32["ms"], "device_ms": v32["device_ms"],
        "plain_ms": v32["plain_ms"],
        "bound_ms": v32["bound_ms"], "bound_by": v32["bound_by"],
        "library_ms": None,
        "shape": v32["shape"], "dtype": "float32",
        "ms_f64": v64["ms"], "device_ms_f64": v64["device_ms"],
        "plain_ms_f64": v64["plain_ms"],
        "bound_ms_f64": v64["bound_ms"], "bound_by_f64": v64["bound_by"],
        "max_rel_err_f64": w3_worst["float64"],
        "max_rel_err_f32": w3_worst["float32"],
    }
    new_records = []
    for name, launches, source in (
            (EULER4, routes_q["launches"]["step2_aos"],
             "pyclaw_tpu_torch/csrc/euler2d_aos.cuh"),
            (EULER5, bubble["classic"]["launches"]["step2_aos"],
             "pyclaw_tpu_torch/csrc/euler2d_aos.cuh"),
            (SW_AUG, swaug["radial_bump"]["launches"]["step2_aos"],
             "pyclaw_tpu_torch/csrc/sw_aug2d.cuh")):
        t32, t64 = tm_aos_new[name]["float32"], tm_aos_new[name]["float64"]
        new_records.append({
            "name": f"step2_aos:{name}", "route": "cuda",
            "source": "pyclaw_tpu_torch/csrc/step2_aos.cu",
            "system_source": source,
            "replaces": "pyclaw_tpu/ops/tiled2d.py:113",
            "replaces_function": "step2_pallas_rows (generic body "
                                 "classic/kernels.py:345 step2_roll; the "
                                 "SoA body classic/soa.py for Euler without "
                                 "aux); step2_pallas_tiled_generic "
                                 "(ops/tiled2d.py:609); step2_pallas "
                                 "(ops/sweep2d.py:41)",
            "rows": ["1b"], "launches": launches,
            "max_abs_err": aosn_abs[name],
            "ms": t32["ms"], "device_ms": t32["device_ms"],
            "plain_ms": t32["plain_ms"],
            "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
            "library_ms": None, "shape": t32["shape"], "dtype": "float32",
            "ms_f64": t64["ms"], "device_ms_f64": t64["device_ms"],
            "plain_ms_f64": t64["plain_ms"],
            "bound_ms_f64": t64["bound_ms"],
            "bound_by_f64": t64["bound_by"],
            "max_rel_err_f64": aosn_worst["float64"],
            "max_rel_err_f32": aosn_worst["float32"]})
    e32, e64 = tm_dq_e5["float32"], tm_dq_e5["float64"]
    new_records.append({
        "name": "dq2_weno5:euler_5wave_2D", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/dq2_weno5.cu",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:314",
        "replaces_function": "dq_pallas_rows (body sharpclaw/soa.py:237 "
                             "with euler_5wave_2D's SoA hooks)",
        "rows": ["2"],
        "launches": bubble["sharpclaw"]["launches"]["dq2_weno5"],
        "max_abs_err": dq5_main_abs_err,
        "ms": e32["ms"], "device_ms": e32["device_ms"],
        "plain_ms": e32["plain_ms"],
        "bound_ms": e32["bound_ms"], "bound_by": e32["bound_by"],
        "library_ms": None, "shape": e32["shape"], "dtype": "float32",
        "ms_f64": e64["ms"], "device_ms_f64": e64["device_ms"],
        "plain_ms_f64": e64["plain_ms"],
        "bound_ms_f64": e64["bound_ms"], "bound_by_f64": e64["bound_by"],
        "max_rel_err_f64": dq5_worst["float64"],
        "max_rel_err_f32": dq5_worst["float32"]})
    # this slice's instances: each one's launches from its run
    sr = scalar_runs
    scalar_launches = {
        "kpp_2D": sr["4s"]["classic"]["launches"]["step2_aos"],
        "vc_acoustics_2D": sr["4t"]["classic"]["launches"]["step2_aos"],
        "vc_advection_2D": sr["4u"]["advection_2d"]["launches"]["step2_aos"],
        "advection_2D": sr["4u"]["advection_2D"]["launches"]["step2_aos"],
        "vc_advection_fwave_2D":
            sr["4u"]["vc_advection_fwave_2D"]["launches"]["step2_aos"],
        "burgers_2D":
            sr["4v"]["burgers_2D:float32"]["launches"]["step2_aos"]}
    for name in SCALAR_2D:
        t32, t64 = tm_scalar[name]["float32"], tm_scalar[name]["float64"]
        new_records.append({
            "name": f"step2_aos:{name}", "route": "cuda",
            "source": "pyclaw_tpu_torch/csrc/step2_aos.cu",
            "system_source": ("pyclaw_tpu_torch/csrc/acoustics2d.cuh"
                              if name == "vc_acoustics_2D" else
                              "pyclaw_tpu_torch/csrc/scalar2d.cuh"),
            "replaces": "pyclaw_tpu/ops/tiled2d.py:113",
            "replaces_function": "step2_pallas_rows (generic body "
                                 "classic/kernels.py:345 step2_roll); "
                                 "step2_pallas_tiled_generic "
                                 "(ops/tiled2d.py:609); step2_pallas "
                                 "(ops/sweep2d.py:41)",
            "rows": ["1b"], "launches": scalar_launches[name],
            "max_abs_err": sc_abs[name],
            "ms": t32["ms"], "device_ms": t32["device_ms"],
            "plain_ms": t32["plain_ms"],
            "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
            "library_ms": None, "shape": t32["shape"], "dtype": "float32",
            "ms_f64": t64["ms"], "device_ms_f64": t64["device_ms"],
            "plain_ms_f64": t64["plain_ms"],
            "bound_ms_f64": t64["bound_ms"],
            "bound_by_f64": t64["bound_by"],
            "max_rel_err_f64": sc_worst["float64"],
            "max_rel_err_f32": sc_worst["float32"]})
    b32, b64 = tm_b3["float32"], tm_b3["float64"]
    new_records.append({
        "name": "step3_aos:burgers_3D", "route": "cuda",
        "source": "pyclaw_tpu_torch/csrc/step3_aos.cu",
        "system_source": "pyclaw_tpu_torch/csrc/acoustics3d.cuh",
        "replaces": "pyclaw_tpu/ops/tiled2d.py:431",
        "replaces_function": "step3_pallas_xy",
        "replaces_body": "kernel_aux (ops/tiled2d.py:490-518; "
                         "classic/kernels.py:806 step3_roll)",
        "rows": ["3b"],
        "launches": sr["4v"]["burgers_3D:float32"]["launches"]["step3_aos"],
        "max_abs_err": b3_abs,
        "ms": b32["ms"], "device_ms": b32["device_ms"],
        "plain_ms": b32["plain_ms"],
        "bound_ms": b32["bound_ms"], "bound_by": b32["bound_by"],
        "library_ms": None, "shape": b32["shape"], "dtype": "float32",
        "ms_f64": b64["ms"], "device_ms_f64": b64["device_ms"],
        "plain_ms_f64": b64["plain_ms"],
        "bound_ms_f64": b64["bound_ms"], "bound_by_f64": b64["bound_by"],
        "max_rel_err_f64": b3_worst["float64"],
        "max_rel_err_f32": b3_worst["float32"]})
    # this slice's instances: each one's launches from its unsplit run
    nt_worst, _, nt_abs, _ = split["kernel_check"]
    no_trans_runs = {"psystem_2D": ("psystem_2d", "psystem2d.cuh"),
                     "shallow_sphere_fwave_2D": ("shallow_sphere",
                                                 "shallow_sphere2d.cuh")}
    for name in NO_TRANS_2D:
        run_key, header = no_trans_runs[name]
        t32 = tm_no_trans[name]["float32"]
        t64 = tm_no_trans[name]["float64"]
        new_records.append({
            "name": f"step2_aos:{name}", "route": "cuda",
            "source": "pyclaw_tpu_torch/csrc/step2_aos.cu",
            "system_source": f"pyclaw_tpu_torch/csrc/{header}",
            "replaces": "pyclaw_tpu/ops/tiled2d.py:113",
            "replaces_function": "step2_pallas_rows (generic body "
                                 "classic/kernels.py:345 step2_roll with "
                                 "rpt=None); step2_pallas_tiled_generic "
                                 "(ops/tiled2d.py:609); step2_pallas "
                                 "(ops/sweep2d.py:41)",
            "rows": ["1b"],
            "launches": split[run_key]["unsplit:float32"]["launches"][
                "step2_aos"],
            "max_abs_err": nt_abs[name],
            "ms": t32["ms"], "device_ms": t32["device_ms"],
            "plain_ms": t32["plain_ms"],
            "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
            "library_ms": None, "shape": t32["shape"], "dtype": "float32",
            "ms_f64": t64["ms"], "device_ms_f64": t64["device_ms"],
            "plain_ms_f64": t64["plain_ms"],
            "bound_ms_f64": t64["bound_ms"],
            "bound_by_f64": t64["bound_by"],
            "max_rel_err_f64": nt_worst["float64"],
            "max_rel_err_f32": nt_worst["float32"]})
    # the library systems of step1.cu: each one's launches from its
    # example's run in [4x] (the classic route; psystem_1D from the 2^20
    # stegoton run)
    lib_runs = {"shallow_roe_with_efix_1D": "shallow_1d roe",
                "shallow_hlle_1D": "shallow_1d hlle",
                "shallow_bathymetry_fwave_1D": "sill",
                "vc_advection_1D": "advection_1d_variable",
                "vc_advection_fwave_1D": "advection_1d_variable fwave",
                "acoustics_variable_1D": "acoustics_1d_heterogeneous",
                "burgers_1D": "burgers_1d", "traffic_1D": "traffic_1d",
                "mhd_1D": "mhd_1d"}
    for name in LIBRARY_1D:
        t32, t64 = tm_lib[name]["float32"], tm_lib[name]["float64"]
        if name == "psystem_1D":
            launches = library["stegoton_full"]["float32"]["launches"][
                "step1"]
        else:
            launches = library["routes"][lib_runs[name]]["float32"][
                "launches"]["step1"]
        new_records.append({
            "name": f"step1:{name}", "route": "cuda",
            "source": "pyclaw_tpu_torch/csrc/step1.cu",
            "system_source": "pyclaw_tpu_torch/csrc/systems1d.cuh",
            "replaces": "pyclaw_tpu/ops/sweep.py:35",
            "replaces_function": "step1_pallas", "rows": ["7"],
            "launches": launches, "max_abs_err": s1_abs[name],
            "ms": t32["ms"], "device_ms": t32["device_ms"],
            "plain_ms": t32["plain_ms"],
            "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
            "library_ms": None, "shape": t32["shape"], "dtype": "float32",
            "share_of_device": t32["share_of_device"],
            "ms_f64": t64["ms"], "device_ms_f64": t64["device_ms"],
            "plain_ms_f64": t64["plain_ms"],
            "bound_ms_f64": t64["bound_ms"],
            "bound_by_f64": t64["bound_by"],
            "share_of_device_f64": t64["share_of_device"],
            "max_rel_err_f64": s1_worst["float64"],
            "max_rel_err_f32": s1_worst["float32"]})
    # dq2_weno.cu's instances: each one's launches from its short path in
    # [4y], dq2_weno7's Euler float32 instance from the full-size path
    dq_abs, dq_rel = options["compare"][0], options["compare"][1]
    for order in WENO_ORDERS:
        for name in DQ_WENO_SYSTEMS:
            for tname in ("float32", "float64"):
                entry = dq_weno_entry(order, name, tname)
                t = tm_dq_weno[entry]
                launches = options["instances"][0][entry]
                if entry == "dq2_weno7_f32":
                    launches = options["weno7_path"]["launches"]["dq2_weno"]
                new_records.append({
                    "name": entry, "route": "cuda",
                    "source": "pyclaw_tpu_torch/csrc/dq2_weno.cu",
                    "system_source": "pyclaw_tpu_torch/csrc/dq2_systems.cuh",
                    "replaces": "pyclaw_tpu/ops/tiled2d.py:314",
                    "replaces_function": f"dq_pallas_rows at weno_order "
                                         f"{order} (body sharpclaw/soa.py:"
                                         f"163 _dq_dir_roll) with {name}'s "
                                         f"SoA hooks",
                    "rows": ["2"], "launches": launches,
                    "max_abs_err": dq_abs[entry],
                    "ms": t["ms"], "device_ms": t["device_ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"], "library_ms": None,
                    "shape": t["shape"], "dtype": tname,
                    "share_of_device": t["share_of_device"],
                    "ceiling_ms": t["ceiling_ms"],
                    **dq_weno[entry],
                    "max_rel_err": max(dq_rel[entry].values()),
                    "max_rel_err_by_state": dq_rel[entry]})
    kernels = [record, dq_record, dq_ac_record, s3_record, aos_record,
               aos_ac_record, s1_record, s1_sw_record, w5_record,
               w5_3d_record, het_record, eu_record, rs_record] + new_records
    summary = {"main_path": {"accepted": ns, "rejected": nr,
                             "wall_s_counted": wall, "loop": loop4},
               "sharpclaw_path": {"accepted": sns, "rejected": snr,
                                  "dq_launches": dq_launches,
                                  "wall_s_counted": swall, "loop": loop4b},
               "euler3d_path": {"accepted": ns3, "rejected": nr3,
                                "step3_launches": s3_launches,
                                "wall_s_counted": wall3, "loop": loop4c},
               "shallow_path": {"accepted": ns_sw, "rejected": nr_sw,
                                "aos_launches": aos_launches,
                                "wall_s_counted": wall_sw, "loop": loop4d,
                                "mass_change_rel": mass_rel,
                                "mirror_asymmetry": mirror},
               "sod_path": sod,
               "acoustics3d_het_path": {
                   "accepted": ns_h, "rejected": nr_h,
                   "step3_aos_launches": het_launches,
                   "wall_s_counted": wall_h, "loop": loop4f},
               "acoustics3d_het_checks": het,
               "euler3d_capacity_path": {
                   "accepted": ns_e, "rejected": nr_e,
                   "step3_ctu_launches": eu_launches,
                   "wall_s_counted": wall_e, "loop": loop4g},
               "euler3d_capacity_checks": eu_checks,
               "acoustics_path": acou, "dam_break_dry_path": dam,
               "sod_chardecomp_path": chardecomp, "validator": validator,
               "sharpclaw_euler3d_path": sharp3d,
               "sharpclaw_routes": routes,
               "sharpclaw3d_card_vs_cpu": sharp3d_vs_cpu,
               "timing_dq_acoustics": tm_dq_ac,
               "shock_bubble_path": bubble,
               "quadrants_off_soa": routes_q, "sw_aug_paths": swaug,
               "new_card_vs_cpu": new_vs_cpu,
               "scalar_runs": scalar_runs,
               "scalar_card_vs_cpu": scalar_vs_cpu,
               "timing_scalar": tm_scalar, "timing_burgers_3d": tm_b3,
               "split_source_paths": split,
               "timing_no_trans": tm_no_trans,
               "library_paths": library, "timing_library": tm_lib,
               "options_paths": options, "timing_dq_weno": tm_dq_weno,
               "dq_weno_resources": dq_weno,
               "timing_aos_new": tm_aos_new, "timing_dq_euler5": tm_dq_e5,
               "timing_weno5_3d": tm_w5_3d,
               "profile_sharpclaw_euler3d": prof_s3,
               "frames_and_restarts": frames,
               "overlay_nccl_one_rank": overlay_one,
               "overlay_four_ranks": overlay_four,
               "lake_at_rest": {"steps": lake_steps,
                                "eta_drift": eta_drift, "momentum": mom},
               "golden_rel_err": golden, "sharpclaw_card_vs_cpu":
                   sharp_vs_cpu,
               "timing": tm, "timing_dq": tm_dq, "timing_step3": tm3,
               "timing_aos": tm_aos, "timing_aos_acoustics": tm_aos_ac,
               "timing_1d": tm_1d,
               "timing_step3_aos": tm_het,
               "timing_step3_capa": tm_eu, "timing_restore": tm_rs,
               "device_loop": loops, "device_loop_hooks": hooks,
               "profile": prof, "profile_sharpclaw": sprof,
               "profile_euler3d": prof3, "profile_shallow": prof_sw,
               "profile_acoustics3d_het": prof_het,
               "profile_euler3d_capacity": prof_eu,
               "profile_sod_classic": prof_sod,
               "profile_sod_sharpclaw": prof_sod_sharp,
               "profile_acoustics": prof_ac,
               "profile_dam_break_dry": prof_dam,
               "profile_sod_chardecomp": prof_cd,
               "phase_seconds": phase_s,
               "card": card, "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "chip_smoke.json"), "w") as f:
        json.dump({"kernels": kernels, **summary}, f, indent=1)
    print(json.dumps(summary))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
