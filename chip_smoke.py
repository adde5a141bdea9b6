#!/usr/bin/env python3
"""Smoke run of the PyTorch port (glimslib_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on lines of their own:

1. The card (nvidia-smi name and power limit), the CUDA versions, and the
   build of the CUDA kernels from csrc/ (one nvcc per source, started
   together; seconds, ptxas report).
2. Every lattice kernel against its plain torch version on the card, at
   the N=32 shapes the lattice path gives it: stencil_apply for
   (d_out, d_in) = (1,1), (3,3), (3,1) and the rd residual's three-term
   form <1,1,3> (max rel error <= 1e-5) and stencil_pcg for d=1 and d=3
   ([8] does the same for the 2D forms)
   (|Δiters| <= 3 and max rel error of x <= 1e-4: reductions re-associate
   near the tolerance).  Every stencil_apply form prints its device time
   L2-cold (before each single launch a 256 MB tensor is written and
   128 MB of another read, so the L2 holds neither input and no dirty
   line: the kernel's duration from torch.profiler is the JSON's ``ms``
   and the share of the bound is taken on it; CUDA events right around
   the launch, which add the launch's own latency, are printed beside
   it) and warm (torch.profiler over back-to-back calls on the same
   planes), the wrapper call (CUDA events over back-to-back calls, host
   overhead included) and its host cost by part, the plain version, and
   the same operator as one torch.sparse CSR matrix (int32 indices,
   built once outside the timing; cuSPARSE's matvec, cold and warm,
   ``library_ms`` the cold one: a yardstick the port never calls).  The
   rd residual in one launch is also timed against the three single
   launches and elementwise passes it replaces, in turns (3, 1, 1, 3).
   Every stencil_pcg launch also prints its mode (resident, streamed or
   streamed_global), iterations, device time from CUDA events right
   around single launches (the stream held busy first, so the host's work
   before the launch does not count), us an iteration, the bound (inputs
   once) and the
   per-iteration streaming figure (planes, preconditioner and four vector
   passes from HBM every iteration), each with its share of the time; the
   elasticity solve is also timed in every other mode that fits.
3. The lattice path: TumorGrowthBrain on the N=32 brain box (35,937
   nodes, 196,608 tets), f32, the benchmark's StepConfig, 5 implicit-Euler
   steps through build_simulate_fn.  Every step must converge, every
   stencil kernel's launch count over that run must be above 0, and the
   final c and u must agree to rel-L2 <= 5e-5 with the port's plain path
   at f64 on the card with tight tolerances.  Prints steps/s (one run
   that counts launches, then TIMED_RUNS timed runs), Newton and CG iteration
   counts, peak memory, and the device time by kernel of one profiled run
   (each stencil_apply kernel with its time a launch on the path).  K1's
   kernel runs on the path as the rd residual (apply_scalar_sum); its row
   counts the launches of both of its wrappers.
4. The lattice path at N=64 (274,625 nodes, 1,572,864 tets), f32, bench
   StepConfig, 2 steps: every step converges through the lattice kernels
   (launches > 0); every stencil_apply form is held against its plain
   version and timed as in [2]; one elasticity solve (stencil_pcg<3>, streamed;
   and again forced to streamed_global, the layout larger lattices or
   cards with fewer SMs take) and one rd solve (stencil_pcg<1>, resident)
   are held against the plain pcg (|Δiters| <= 3, max rel <= 1e-4) and
   timed as in [2].
5. bell_bmv against its plain version at the five shapes the unstructured
   flagship gives it (max rel <= 1e-5), each with its device time
   L2-cold (the JSON's ``ms``; flushed as in [2]) and warm, torch.bmm's
   device time the same two ways (a yardstick only, never called by the
   port; ``library_ms`` the cold one), the wrapper call time, the plain
   time, the bound, the share of the bound on the cold time and the
   launch plan (rows a span, staging mode, stages, lanes a row, blocks).
6. The unstructured path: TumorGrowthBrain on the same n=32 box with its
   lattice structure stripped and its nodes in Morton order, f32, the
   benchmark's unstructured StepConfig, 5 steps: set-up seconds (plans,
   frozen preconditioners), the first run, then the mean of TIMED_RUNS runs.  Every
   step must converge and bell_bmv must launch; prints its launches by
   shape and the share of the bound weighted by them (with [5]'s times),
   Newton and CG counts, peak memory, the profiler breakdown and the device's idle
   share, and rel-L2 of the final c and u against the port's plain f64
   path on the card with tight tolerances (<= 1e-4).
7. The adjoint: ``examples.adjoint_problem`` (the benchmark's adjoint
   cell: D_WM and rho_WM, targets from a forward run, 5 steps) on the
   sims of [3] and [6], one ``InverseProblem.value_and_grad`` after
   another.  Per lane: the first call, value_and_grad/s (ADJ_TIMED_CALLS
   calls after the instrumented one, cut from 3), the forward and backward time of one call split by a CUDA
   event at the backward's start, the adjoint CG iterations, each
   kernel's launches in that call by forward and backward (every kernel
   of the lane must launch in the backward), peak memory, the profiler's
   breakdown and idle share, and the device time of the plain-torch VJP
   passes (dW outer products, dx = sum_m A y_bar, the assembly
   backward).  J and the f32 gradient are held against the port's plain
   f64 path on the card (the f64 models of [3] and [6]) with the f64
   default tolerances and the same targets: rel error of J <= 1e-4
   (lattice) and 5e-4 (unstructured), rel-L2 of the gradient <= 1e-3
   (lattice) and 1e-2 (unstructured); on the lattice one directional
   central difference of the f64 objective against its gradient, rel <=
   1e-5.  Each lane ends with its seconds by stage.

8. The 2D models (``examples.rect_sim`` and the two 2D inverse problems).
   Every kernel of the 2D lattice lane against its plain version and
   timed as in [2], at the 50 x 50 rectangle's shapes (2,601 nodes, 7
   offsets; stencil_apply <1,1>, <2,2>, <2,1>, <1,1,3>, stencil_pcg<1>
   and stencil_pcg<2>, the latter in every mode that fits and on 16 and 4
   blocks).  The 50 x 50 uniform (5 steps) and subdomains (10 steps)
   paths as in [3]: every step converges, every kernel launches, final c
   and u within rel-L2 5e-5 of the plain f64 path on the card, steps/s,
   Newton and CG counts and the idle share.  The 512 x 512 rectangle
   (263,169 nodes), 2 steps, as in [4]: stencil_pcg<2> runs streamed in
   the path, and every kernel is held and timed at its shapes (a solve of
   1,000 iterations or more to |Δiters| <= 20% of the plain count:
   PCG_DITERS_SHARE says why).  Then one
   value_and_grad of ``rect_adjoint_problem(50)`` (the lattice lane,
   limits and central difference as in [7]) and of ``atlas2d_problem()``
   (the reduced atlas slice on the unstructured lane, the unstructured
   limits), as in [7]; bell_bmv is held against its plain version and
   timed at the atlas's five shapes first, as in [5], and its launches in
   the value_and_grad weight them as in [6].  The 50 x 50 paths and both
   2D inverse problems take the models' f32 default step, which refines
   in f64: their forwards measure f64 gather residuals, so stencil_apply
   launches in the value_and_grad's backward (the 50 x 50 rows' launches
   come from there) and the forwards launch the two solves.
9. The reference's defaults on the flagship path, on [3]'s and [6]'s
   models.  [9a] REFINED_STEP_CONFIG (f32 solves, f64 residuals, one
   correction solve of the elasticity block a step) on the N=32 lattice
   and the n=32 unstructured box, 5 steps: every step converges with one
   correction solve, the solves' kernels launch, steps/s, device busy and
   idle share; final c and u below the lane's unrefined error in [3] /
   [6] and within rel-L2 1e-5 of the f64 plain path (the unstructured
   lane: in a second run at newton_atol 1e-7, REFINED_NEWTON_ATOL says
   why); then one
   value_and_grad a lane of [7]'s problem with refine_f64 on, J within
   1e-4 of the f64 J on both lanes and the gradient within [7]'s limits.
   [9b] the factored planes (the default: per-class channel stacks
   reduced per simulate) against the dense assembly (the same aux without
   the stacks), max rel 1e-5, with the assembly's device time and steps/s
   both ways.  [9c] the default bf16 coarse factors against f32 ones
   built from the same coarse matrices, BF16_STEPS steps a way: CG
   iterations, the coarse products' device time in a profiled run (its
   aten::mm / aten::mv calls on the factors' shapes) and its
   matrix-product kernels, steps/s and idle share, final state within
   [6]'s limit of [6]'s f64 plain path after as many steps.

10. The quad (P2-concentration) brain model on the n=32 Morton box, the
   benchmark's quad flagship (274,625 P2 dofs on a P2 supernode plan of
   nb=4,352, s=64, flat halo).  Set-up seconds by part (the P2 dof
   layout, the P2 plan, the factored P2 cache, ``_McSNP2``, the P1 plan,
   the coarse level) and the peak memory of the frozen state.  [10a]
   bell_bmv against its plain version at the P2 shapes, the rd constant
   plane (4352, 64, Kh) and the supernode Jacobi (4352, 64, 64), max rel
   1e-5, timed as in [5].  [10b] the forward, f32, the benchmark's
   unstructured StepConfig, QUAD_STEPS steps (cut from 5), as in [6]:
   every step converges, bell_bmv launches at the P2 shapes (its launches
   by shape and the share of the bound weighted by them), steps/s, the
   profiler breakdown and idle share; the final c and u within rel-L2
   1e-4 of the plain f64 path on the card (where the operating point
   leaves more, the same run at newton_atol 1e-7 is held to it, as [9a]
   does).  [10c] the f32 default step (refine_f64) on the same model,
   QUAD_STEPS steps: one correction solve a step, steps/s (no profiled
   breakdown: [10b]'s stands, cut to fit [15]); its final state below
   [10b]'s error, or, where newton_atol
   1e-5 stops Newton first, the same run at newton_atol 1e-7 below it
   and within 1e-5.  [10d] one value_and_grad of ``adjoint_problem`` on
   the quad model as in [7] (J within 5e-4 and the gradient within 1e-2
   of the plain f64 path), bell_bmv launching at the P2 shapes in the
   backward.

11. The workflow (``glimslib_tpu_torch.workflow``) in a temporary
   directory, removed at the end.  [11a] the atlas pipeline on the 256 x
   256 slice 16 of ``brain_labelmap_3d(256, 256, 32)`` (65,536 pixels,
   ``stencil_pcg<2>`` resident): the domain, the forward (10 steps, VTU
   output), the targets, L-BFGS-B from D_WM = rho_WM = 0.05 (type 2,
   maxiter 10, under the profiler: device busy ms and idle share), the
   optimized re-run, the comparison, post_process, the summary and a
   fresh workflow's reload; then every 2D lattice kernel held and timed
   at the slice's shapes as in [8] (without the host-cost split and the
   rd residual's A/B, which [2] runs).  [11b] the same on a 64^3
   labelmap's full lattice (274,625 nodes, ``stencil_pcg<3>`` streamed),
   1 step, maxiter 1 (both cut from 2).  [11c] the patient pipeline on 128 x 128 slices (a
   segmentation's T2 and T1 targets), up to the inverse, maxiter 3.
   Each prints seconds, kernel launches and host seconds of file output
   by stage, value_and_grad calls and calls/s, L-BFGS-B's nit, message
   and J at its start and end, and the recovered parameters; every step
   of a recorded run converges (the solves capped at WF_CG_MAXITER
   iterations: WF_CG_MAXITER says why), stencil kernels launch in the
   forward, inverse and optimized stages, the c and u of [11a]'s and
   [11b]'s forwards after at most WF_F64_STEPS steps (the recorded step;
   cut from [11a]'s 10) are within rel-L2 5e-5 of the plain f64 path,
   [11c]'s J and gradient at v0 within 1e-4 and 1e-3 of it, J falls,
   the recovered (D_WM, rho_WM) lies nearer the truth (0.1, 0.1) than
   v0 (in [11a] each within WF_PARAM_RTOL of it), the T2 volumes of the
   forward and optimized runs are finite and positive, and the reloaded
   series equals the recorded one exactly.  [11d] the atlas pipeline of
   [11a] with ``model="quad"``, 1 step, maxiter 1 (cut from 5 and 3): the quad
   model on the slice's mesh with
   its lattice stripped (the unstructured lane; 261,121 P2 dofs),
   through bell_bmv and no stencil kernel; it prints the seconds by
   stage, each sim's set-up by part (the P1 plan, the P2 plan, the
   coarse level's eigh), the forward's Newton and CG iterations, bell_bmv's
   launches by stage and shape, and at each of the slice's four table
   shapes bell_bmv against its plain version and timed as in [5], with the
   share of the bound weighted by the launches; it holds the forward's c
   and u to QUAD_RTOL of the plain f64 path, J at v0 and the gradient to
   the unstructured limits, J falling and the recovered parameters nearer
   the truth than v0 (reporting whether within WF_PARAM_RTOL), bell_bmv
   launching at every shape.  [11e] the quad model on a 32^3 labelmap's
   full lattice (cell-free P2 vertex dofs on the card): a 1-step forward
   (cut from 2 with [11b]'s),
   finite, with c and u exactly 0 at the cell-free nodes and within
   QUAD_RTOL of the plain f64 path, and one value_and_grad held to the
   unstructured limits.

12. The example scripts (``glimslib_tpu_torch.example_scripts``, the
   port's counterparts of ``examples/*.py``), each ``main()`` in the order
   and with the argument sets of its runner (``RUNS``), on the card at f32
   with plot=False (the line says whether matplotlib imports here), in a
   temporary directory, removed at the end.  Every launch count is set to
   0 just before each script and read just after; each prints its seconds,
   its seconds by stage from the port's ``Tracer``, its launches by kernel
   wrapper (bell_bmv's also by shape), device busy ms and the idle share
   (the profiler's device events; not for the scripts in EX_UNPROFILED,
   which run without the profiler).  The lattice scripts must launch both
   stencil_pcg forms (and stencil_apply where they take a gradient), the
   two on meshes without a lattice (the reduced 2D atlas, the 3D atlas's
   tet mesh) bell_bmv.  ``tumor_growth_2D_uniform`` runs inside
   ``utils/profiling.device_trace``, whose Chrome trace must hold
   stencil_pcg kernel events.  The forward and comparison scripts' final
   fields are held to rel-L2 EX_RTOL of the same script on the plain path
   at f64 on the card; the adjoint scripts print J at x0 and at the end
   and the recovered parameters beside their truth, J must fall and,
   with noise-free targets, each parameter must lie within the script's
   limit (EX_RECOVERY_RTOL where the reference script has none).  At
   each lattice the scripts run (26^2, 16^2, 13^2, 51^2 and the 64^2,
   40^2 and 24^2 image slices), the first script there hands its model
   to phase_kernels: every stencil_apply form and both stencil_pcg
   solves against their plain versions at that lattice's shapes
   (untimed: cut from timing each, as [8] and [11a] time these forms),
   each row with the launches of the scripts there.  bell_bmv must have been
   held at every (B, M, K) the two unstructured scripts launch it at
   (the 3D atlas's tables here, the reduced 2D atlas's in [8]).

13. Block sharding (``Simulation.use_sharding(mode="bell")`` on
   torch.distributed), at f32 refined.  The card's host has one card, so
   a group is one rank over NCCL or ranks sharing the card over gloo, and
   no speed-up over cards is measured.  [13a] world 1 over NCCL in this
   process: [6]'s box under use_sharding() (mode 'bell', one slab of
   every block), 5 steps at [9a]'s config with the unsharded model's
   frozen state, against the unsharded model run the same way (bit for
   bit, or the max difference), [9a]'s own run and the f64 plain path
   (rel-L2 <= 1e-4).  use_sharding turns on deterministic algorithms for
   the process (the ranks must compute their replicated work bit for bit
   alike); [13a] turns them off again after it.  [13b] two ranks sharing
   the card over gloo (``parallel.run_ranks``; [14b] and [14d] run in the
   same spawn after it): per rank the n=32 box, SHARD_P1_STEPS step (cut
   from 5, then 2), and one value_and_grad of [9a]'s refined problem on its
   targets at as many steps, then the quad flagship, SHARD_QUAD_STEPS
   steps (cut from 5, then 2);
   per rank the slab's blocks, set-up seconds, the table bytes held
   against the unsharded model's, bell_bmv's launches by slab shape
   (every shape launched must be held against the plain contraction on
   that rank, in the bulk mode where B M K is a multiple of 4; rank 0
   times them as [5] does, the other rank waiting), device busy ms and
   idle share of rank 0's profiled run (the other rank running beside
   it; cut from one a rank in turns); c and u within
   rel-L2 1e-4 of the f64 plain path ([6]'s and [10]'s after as many
   steps), J within 5e-4 and the gradient within 1e-2 of the f64 plain
   model's at as many steps (computed in [9a]), each also against the
   unsharded f32 run; whether the two ranks' fields, J and gradient
   are bit-equal.  [13c] ``tumor_growth_3D_atlas_sharded`` at two gloo
   ranks on the card: mode 'bell' and bell_bmv on every rank, its final
   max concentration, its fields within EX_RTOL of the same model
   unsharded on the plain path at f64.  [12] leaves that script to [13c].

14. Node sharding of the lattice (``Simulation.use_sharding(mode="nodes")``,
   ``parallel/gspmd.py``): each rank owns a slab of node rows, every
   stencil apply exchanges a halo and launches the halo form of
   stencil_apply, and the solves take the pcg branch with every dot
   product reduced over the ranks.  [14a] world 1 over NCCL in this
   process on the N=32 box (35,937 nodes, halo 1,123) under
   use_sharding() (auto: 'nodes'), 5 steps at [3]'s bench StepConfig and
   at [9a]'s refined one: every step converges, every halo form the run
   launches is counted (the wrappers' counts at 0 just before) while
   neither stencil_pcg launches nor the plain stencil version runs, c and
   u within rel-L2 5e-5 of [3]'s f64 plain path, Newton and CG counts
   beside the unsharded model's, the collectives (count, host ms); steps/s,
   the profiler breakdown and idle share of the bench run; every halo form (<1,1>, <3,3>, <3,1>,
   <1,1,3>) held against its plain version at the slab's shapes and
   timed as in [2] (the kernels line's "halo@N=32 slab" rows).  [14b]
   NODES_WORLD ranks sharing the card over gloo (``parallel.run_ranks``,
   in [13b]'s spawn after [13b]'s work, with deterministic algorithms off
   again) on the box padded to 37,026 nodes (18,513 rows and a halo of 1,123 a
   side a rank), 5 steps at [9a]'s refined config: per rank the rows,
   the plane bytes against the unsharded padded model's (exactly
   1 / NODES_WORLD), the halo forms' launches, the collectives (count and
   host ms each, a timer around torch.distributed.all_reduce), device busy
   ms and idle share of rank 0's profiled run of NODES_PROFILE_STEPS steps
   (cut from 5 steps and from one a rank in turns, to keep [14] short),
   each halo form against its plain version at the slab's shapes; Newton
   and CG counts equal on every rank, fields on the real nodes within
   5e-5 of the f64 plain path, padding dofs exactly 0.
   [14c] the adjoint at world 1 on [14a]'s model: value_and_grad of
   [9a]'s lattice problem (the benchmark's adjoint cell, type 2, 5 steps,
   f32 refined): one call at REFINED_STEP_CONFIG held to the warm-started
   lanes' J limit (NODES_VG_STEPS says why), then at newton_atol
   REFINED_NEWTON_ATOL one call with every count at 0, split at the
   backward's start: launches by wrapper and direction, the backward's
   transposed halo launches by form (dv of the rd residual's mass term
   and of the coupling: both must launch), no stencil_pcg and no plain
   stencil call, the collectives; device busy ms and idle share of one
   call; J within 1e-4 and the gradient within rel-L2 1e-3 of [9a]'s f64
   plain ones.  Each transposed launch (the halo form on the mirrored
   planes extended by H rows, over the cotangent padded by 2H) is held
   bit-equal to its plain version at the slab's shapes and timed as [2]
   times a form (its padding's kernels counted in), beside its bound and
   the torch.sparse CSR matrix of A^T; the <3,3> form's, which the path
   never asks, is held only.  [14d] in [14b]'s processes: one
   value_and_grad of NODES_VG_STEPS steps (cut from 5) of the same
   problem on the padded box (targets zero on the padding) at newton_atol
   REFINED_NEWTON_ATOL, the counts at 0 just before: J and the gradient
   bit-equal on every rank, the forward and adjoint CG counts equal, the
   transposed forms launched, no stencil_pcg, the collectives a call and
   host ms each; J and the gradient within the lattice limits of the f64
   plain path unpadded (NODES_VG_STEPS steps, computed here first).

15. The matrix-free jvp lane and the gather residuals of a von Neumann
   influx and a time-dependent source.  [15a] the N=32 box with
   ``operator_mode = "matrix-free"``, f32, MF_STEPS step(s) (cut from 2
   to fit [16]) at the benchmark's StepConfig and at
   REFINED_STEP_CONFIG, unprofiled (cut to fit [16], whose profiles hold
   the jvp lane's kernels): every kernel wrapper's count 0 over the run;
   Newton and CG counts by block, steps/s; c
   and u within SLICE_RTOL of the auto lane after as many steps ([3]'s
   and [9a]'s runs); one value_and_grad of [7]'s problem at MF_STEPS
   steps on both lanes, J within 1e-4 and the gradient within 1e-3 of
   the assembled lane's.  [15b] the quad model on the N=32 lattice box
   (the jvp lane, 274,625 P2 dofs), QUAD_MF_STEPS refined step(s): no
   kernel, set-up s, step s (unprofiled, cut to fit [16]), c within QUAD_RTOL
   of [10c]'s stripped-mesh run after as many steps (the two meshes'
   P2 dofs share one order).  [15c] ``examples.influx_sim`` (an influx of
   c through the boundary, a time-dependent source) f32 refined, MF_STEPS
   steps, on the N=32 lattice (stencil_pcg<1> and <3> launch; the rd
   residual takes the gather form, so no stencil_apply) and the n=32
   unstructured box (bell_bmv): c and u within the lane's limit of the
   f64 plain path; every kernel row gains its launches there.

16. ``use_sharding(mode="cells")`` (``parallel/shard.py
   ShardedP1Kernels``: a rank's block of cells from the native graph
   partitioner, replicated vectors, one all_reduce a residual) and
   ``mode="nodes"`` on an unstructured mesh (``parallel/nodeshard.py``:
   owned rows, a ghost exchange), both on the matrix-free jvp lane.
   [16a] world 1 over NCCL in this process on the n=32 Morton box (the
   unstructured flagship's mesh), f32, SHARD16_STEPS steps at
   REFINED_STEP_CONFIG a mode: the unsharded model on the jvp lane, then
   'nodes' and 'cells' on the same mesh, each held to UNSTRUCT_RTOL
   against it (bit-equality printed, or the max rel diff and why), with
   the CG counts of both; per rank the owned rows, local cells, ghosts G
   and published rows P (the cells of the block and the partitioner
   under 'cells', which must be the native graph one); steps/s, device
   busy ms and idle share (one profiled run), the collectives a step and
   host ms each; every kernel wrapper's count 0 and no kernel of the
   port in the profile (each mode's run is the profiled one).  [16b] NODES_WORLD gloo ranks sharing the card
   (in [13b]'s spawn, after [14d]) on the 8^3 Morton box padded to 730
   nodes, f64, SMALL16_STEPS step a mode and one value_and_grad: J, the
   gradient, c and u bit-equal on every rank, J and the gradient within
   SMALL16_J_RTOL / SMALL16_G_RTOL of the same problem unsharded on the
   jvp lane (world 1, in this process), the collectives and their host ms, the rank's
   layout, no kernel launch.

17. Chebyshev preconditioning (``StepConfig.precond_degree`` CHEB_DEGREE)
   and von Neumann conditions under ``cells`` and ``nodes``.  [17a] [3]'s
   N=32 lattice (bench StepConfig) and [6]'s n=32 unstructured box,
   CHEB_STEPS steps each at degree 0 and at CHEB_DEGREE, the counts at 0
   before each: the Chebyshev lattice launches every stencil_apply form
   and no stencil_pcg (the pcg branch on the stencil planes), the
   Jacobi one both stencil_pcg; c and u of the two ways within SLICE_RTOL
   (lattice) and UNSTRUCT_RTOL (unstructured); CG iterations, steps/s,
   device busy ms and idle share both ways; the Chebyshev solves' forms
   held against their plain versions on the run's planes, bell_bmv's
   launches by shape (each one [5] holds; a new one raises) and its rd
   Jacobian at the final state against plain; one value_and_grad of
   [7]'s lattice cell each way, J within CHEB_J_RTOL (the warm-started
   lanes' limit: the Chebyshev lattice warm-starts) and the gradient
   within 1e-3 of each other, no stencil_pcg in the Chebyshev call.  [17b]
   ``examples.influx_sim`` with the traction VN17_TRACTION, f32
   REFINED_STEP_CONFIG, VN17_STEPS step: at world 1 over NCCL the N=32
   lattice under 'nodes' (stencil_apply's halo form in the solves, no
   stencil_pcg) and the n=32 Morton box under 'cells' and 'nodes' (no
   launch), each within its lane's limit of the unsharded run, with the
   rank's facets and the collectives; NODES_WORLD gloo ranks (in [13b]'s
   spawn, after [16b]) on [16b]'s 730-node box at f64, VN17_STEPS step
   and one value_and_grad a mode: J, the gradient, c and u bit-equal on
   every rank and within VN17_RTOL of the same mode at world 1; and the
   collectives a CG iteration of one forward step under 'nodes' at
   degree 0 and CHEB_DEGREE.

18. Geometric multigrid (``solvers/multigrid.py``), folded symmetric
   stencils, the streamed P2 residual and the warm-start switches.  [18a]
   [3]'s N=32 box at f32 (5 levels, 33^3 to 3^3, a dense 27-node bottom):
   the scalar block at MG_SCALAR unmasked and the elasticity block at
   MG_E, MG_NU clamped, each solved by pcg to MG_CG_RTOL with the V-cycle
   (its build and solve launch stencil_apply, counted by level; and again
   with plain=True, held to one V-cycle and x within MG_X_RTOL rel-L2 and
   equal iterations), and with Jacobi / block-Jacobi; true residuals
   within MG_RES_RTOL.  The elasticity V-cycle does not converge on this
   box: its solve stops at MG_EL_MAXITER iterations and prints the
   residual reached beside block-Jacobi's at as many (x is then held by
   the one V-cycle alone).  Device busy ms and idle share of the V-cycle
   and the Jacobi solves; every coarse level's stencil_apply <1,1> and
   <3,3> held against plain and timed as in [2] (level 0 has [2]'s
   shapes: held only), each row's launches those of the V-cycle's build
   and solve at that level.  [18b] fold_sym and the folded applies on
   [3]'s bench planes against the kernel's full-plane stencil_apply
   (APPLY_RTOL) and block_jacobi_inverse_sym against the full-plane
   inverse, with call times.  [18c] [10b]'s quad model and f64
   reference, QUAD_STEPS steps a way at the default and at
   GLIMS_P2STREAM=1 (its frozen state [10b]'s plus the P2 mass channel):
   each held to QUAD_RTOL of the f64 plain path and of each other;
   steps/s, busy ms and idle share, the rd residual evaluations a run and
   the device ms of one (two bell_bmv launches an evaluation streamed),
   and bell_bmv's launches both ways.  [18d] [6]'s model, WARM18_STEPS
   steps at the defaults, at GLIMS_WARM_ORDER=3 and at
   GLIMS_ALG_ANCHOR=0: Newton and CG counts, rd residual evaluations, c
   and u within UNSTRUCT_RTOL of the default run.

20. The public members the port gained last (PR 21), on [3]'s and [6]'s
   models, no model built: [20a] build_bell_mass and
   build_bell_coupling_uc on [6]'s box against the model's _BellMrd and
   _BellCuc (bit-equal printed, held to API_TABLE_RTOL), applied through
   bell_bmv (2 launches, counted) against the plain apply
   (API_BMV_RTOL), both shapes held and timed as [5] does; [20b]
   cg_fixed_iters(API_CG_ITERS) with Jacobi on [3]'s rd planes through
   stencil_apply, and torch.autograd.grad of |x|^2 wrt b through the
   kernel's autograd rule (the transposed launches on mirrored planes):
   launches forward and backward, x and the gradient against the same
   solve on the plain apply (API_RTOL), the <1,1> form timed as [2]
   does; [20c] stiffness_residual and integrate_p1 on [6]'s box on the
   card against the f64 CPU kernels (API_RTOL).

Then one JSON line with [20]'s numbers, one with [19]'s, one with [18]'s numbers, one with [17]'s numbers, one with [16]'s numbers, one with [15]'s numbers, one with [14]'s numbers, one with [13]'s numbers, one with [12]'s numbers and its kernel rows by lattice, one with [11]'s, one with [10]'s, one with [9]'s, one with [7]'s
and [8]'s value_and_grad numbers, one with
every kernel's numbers (each with its launches in the path and in one
value_and_grad by forward and backward: [7]'s for the 3D rows, [8]'s for
the 50 x 50 rows; bell_bmv's also at the P2 shapes with its launches in
[10b] and [10d], and at [13b]'s slab shapes with their launches there;
stencil_apply's halo form at [14a]'s slab with its launches in [14a]'s
bench run, its refined run and [14b], and its transposed launches with
their launches in [14c]'s backward and [14d]'s),
the card's line, and as the last line {"ok": true,
"device": {...}}.  Any failure raises (exit code != 0).  Needs CUDA:
without it the script exits non-zero and prints no result.
"""

import json
import os
import re
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

N = 32
N64 = 64
N_STEPS = 5
N64_STEPS = 2
APPLY_RTOL = 1e-5
# the CSR yardstick sums in cuSPARSE's order, with the planes of the rd
# residual's terms added into one matrix first: it must compute the same
# function, to f32 rounding
CSR_RTOL = 1e-4
# written between launches for L2-cold times: five times the H100's 50 MB L2
FLUSH_BYTES = 256 << 20
PCG_RTOL = 1e-4
PCG_DITERS = 3
# past some thousand iterations two f32 CG recurrences that sum in other
# orders drift apart, so the stop at rtol 1e-7 lands at other iterations:
# the 512 x 512 elasticity solve took 2,325 iterations in the kernel and
# 2,653 in the plain version, with x within 2.7e-5 (an NVIDIA H100).  The
# limit on |Δiters| of such a long solve is this share of the plain
# count; where they differ by more than PCG_DITERS the same solve
# in f64 is run and its count printed beside them.  Solves of fewer plain
# iterations than PCG_LONG keep PCG_DITERS.
PCG_DITERS_SHARE = 0.2
PCG_LONG = 1000
SLICE_RTOL = 5e-5
UNSTRUCT_RTOL = 1e-4
BMV_RTOL = 1e-5
# J's limit on the unstructured lane sits above the lattice's: its
# operating point (newton_rtol 1e-4, the chord method, rd forcing 1e-3)
# leaves c at ~6e-5 of the f64 state, and the threshold's slope (50 at
# the front) carries that into J at 1.5-1.9e-4 (n=6 to 32)
ADJ_J_RTOL = {"lattice": 1e-4, "unstructured": 5e-4}
ADJ_G_RTOL = {"lattice": 1e-3, "unstructured": 1e-2}
ADJ_FD_RTOL = 1e-5
ADJ_FD_EPS = 1e-5
ADJ_FD_DIR = (0.6, 0.8)
# value_and_grad/s from this many uninstrumented calls after the first and
# the instrumented one (cut from 3 to fit [14c] and [14d])
ADJ_TIMED_CALLS = 1
# [8]: the 2D models.  The 512 x 512 rectangle is the lattice of a 512^2
# image slice and the first past stencil_pcg<2>'s resident layout on 132
# SMs; its elasticity CG takes 2,664 and 2,886 iterations in the first two
# steps (f32 plain path on the CPU), so the benchmark's limit of 800 is
# raised for it.  The 2D adjoint has 3 parameters: a unit direction in R^3.
N2D = 50
N2D_BIG = 512
N2D_BIG_STEPS = 2
N2D_BIG_CG_MAXITER = 6000
ADJ_FD_DIR_2D = (0.48, 0.6, 0.64)
# [11]: the workflow.  The 2D atlas is a 256 x 256 slice of a 256 x 256
# x 32 labelmap (65,536 pixels, about one 1 mm MR slice: stencil_pcg<2>
# stays resident); the 3D atlas a 64^3 labelmap's full lattice (274,625
# nodes, stencil_pcg<3> streamed), cut in depth from the ~200^3 of a real
# atlas and to 2 steps and 2 L-BFGS-B iterations to keep the phase near
# two minutes; the patient pipeline 128 x 128 slices, run up to the
# inverse.  Parameters: examples/example_config.py:33-39; the inverse from
# D_WM = rho_WM = WF_V0 (type 2).
WF_2D = (256, 256, 32, 16)
WF_3D = (64, 64, 64)
WF_PATIENT = (128, 128, 32, 16)
WF_SIM = {"2d": dict(sim_time=10, sim_time_step=1, seed_width=5.0),
          # [11b] and [11e]: 1 step (cut from 2 to fit [14c] and [14d])
          "3d": dict(sim_time=1, sim_time_step=1, seed_width=5.0),
          "patient": dict(sim_time=2, sim_time_step=1, seed_width=5.0),
          # [11d]: [11a]'s slice with the quad model, cut from [11a]'s 10
          # steps and maxiter 10 (to 5 steps and the reference quad test's
          # maxiter 3), where one f32 value_and_grad took 9.5 s and the
          # profiled inverse 225 s (14 calls; an H100 at 700 W); then to 3
          # steps (and maxiter 1) to fit [14c] and [14d], then to 2 to fit
          # [15], then to 1 to keep the script well inside its limit
          "quad": dict(sim_time=1, sim_time_step=1, seed_width=5.0)}
# [11b] and [11d] take one L-BFGS-B iteration (cut from 2 and 3 to keep
# the script inside its limit with [14c] and [14d]; [11d]'s profiled
# inverse took 53.0 s at maxiter 3, an H100 at 700 W)
WF_MAXITER = {"2d": 10, "3d": 1, "patient": 3, "quad": 1}
# [11e]: the quad model on this labelmap's full lattice (33^3 corners)
WF_QUAD_3D = (32, 32, 32)
WF_OPT = {"tol": 1e-8, "gtol": 1e-8}
# the models' f32 default caps a CG solve at 1,000 iterations (the
# reference's, glimslib_tpu/models/base.py:101); the 256 x 256 slice's
# elasticity solve takes 1,712-1,759 (f32 plain path on the CPU), so the
# first step fails and the forward freezes.  The workflow's simulations
# and their f64 references get this cap, as [8]'s 512 x 512 does
WF_CG_MAXITER = 6000
# a forward is held to the plain f64 path at its recorded step
# min(steps, WF_F64_STEPS): [11a]'s at step 2 of 10 (cut from 10: the f64
# plain path's solves read the host every iteration, 31 s for 10 steps;
# then from 5, 16.6 s, to fit [17])
WF_F64_STEPS = 2
WF_V0 = 0.05
WF_TRUTH = 0.1
# L-BFGS-B's reach: the relative error of each recovered parameter of
# [11a] at most this.  The same pipeline on a 64 x 64 slice of
# brain_labelmap_3d(64, 64, 8), f32 refined, on the CPU: 8 iterations, 13
# value_and_grad calls, 'CONVERGENCE: RELATIVE REDUCTION OF F', J 81.94 ->
# 5.1e-3, rel errors 2.8e-3 (D_WM) and 6.8e-4 (rho_WM); the limit leaves
# 3.5x for the card's f32 summation order and the larger slice
WF_PARAM_RTOL = 1e-2
WF_PARAM_RTOL_WHY = ("a CPU run of the same pipeline at 64 x 64 reached 2.8e-3 "
                     "and 6.8e-4 in 8 iterations")
# torch.cuda._sleep's kernel, which opens a profiled window: not a kernel
# of the call timed in it
SLEEP_KERNEL = r"sleep|spin_kernel"
STENCIL_SRC = "glimslib_tpu_torch/csrc/stencil.cu"
BELL_SRC = "glimslib_tpu_torch/csrc/bell.cu"
# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12


def _rel_max(got, want):
    """(max |got - want|, that over max |want|)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(float(want.double().abs().max()), 1e-300)


def _rel_l2(got, want):
    d = (got.double() - want.double()).norm()
    return float(d / max(float(want.double().norm()), 1e-300))


def _bound(nbytes, flops):
    """(least time in ms, 'bytes' | 'operations') on the published peaks."""
    tb, to = nbytes / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _profile(torch, fn, cpu=True):
    """Run fn() once under torch.profiler (CPU + CUDA activity, or CUDA
    alone: the CPU events of a run of many torch ops take the profiler
    seconds to process)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def _self_device_us(evt):
    return float(getattr(evt, "self_device_time_total", 0.0) or 0.0)


def _device_kernels(prof):
    """{name: [records, device us]} of a profile's device records (kernels,
    copies, fills), summed from the raw events: the sums of
    ``key_averages``, which first parses every event, CPU and device, into
    a tree and takes some forty times as long as this."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            rec = out.setdefault(e.name(), [0, 0.0])
            rec[0] += 1
            rec[1] += e.duration_ns() / 1e3
    return out


def _device_busy_ms(prof):
    """The device busy ms of a profile: its device records' durations."""
    return sum(us for _, us in _device_kernels(prof).values()) / 1e3


def _kernel_device_ms(torch, fn, reps, pattern):
    """Mean device time in ms of the kernels whose name matches
    ``pattern`` over ``reps`` calls of fn(), from the profiler; None when
    the profiler records no device time for them."""
    prof = _profile(torch, lambda: [fn() for _ in range(reps)])
    hits = [e for e in prof.key_averages() if re.search(pattern, e.key)]
    us = sum(_self_device_us(e) for e in hits)
    count = sum(e.count for e in hits)
    return us / count / 1e3 if count and us > 0 else None


def _device_ms(torch, fn, reps, pattern):
    """(device ms of one call of fn(), its source): the profiler's kernel
    time where it records one, else CUDA events around single calls."""
    ms = _kernel_device_ms(torch, fn, reps, pattern)
    if ms is not None:
        return ms, "profiler"
    return _launch_ms(torch, fn, reps), "CUDA events"


def _time_ms(torch, fn, reps):
    """Mean time of fn() in ms over ``reps`` back-to-back calls, between
    two CUDA events (so host launch overhead counts where the host is
    slower than the device), after two warm-up runs."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(torch, fn):
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _launch_ms(torch, fn, reps, prep=None):
    """Mean device time in ms of single calls of fn(), each bracketed by
    CUDA events right around it.  A sleep kernel holds the stream first
    (``prep()``, where given, ends with one), so the host's work inside
    fn() before its launch overlaps the sleep and is not counted."""
    fn()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if prep is None:
            torch.cuda._sleep(4_000_000)
        else:
            prep()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _cold_l2(torch, dev):
    """prep() for L2-cold timing: write FLUSH_BYTES (five times the L2; an
    in-place add, a kernel no timed call launches), read half as many of
    another tensor, so the L2 holds clean lines of neither input and a
    timed kernel pays no write-back of the flush's dirty lines, then hold
    the stream with a sleep kernel."""
    dirty = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    clean = torch.ones(FLUSH_BYTES // 8, dtype=torch.float32, device=dev)

    def prep():
        dirty.add_(1.0)
        clean.sum()
        torch.cuda._sleep(1_000_000)
    return prep


def _device_records(torch, run):
    """The profiler's device records of run(), in the order the device ran
    them.  A 1 ms sleep kernel opens the window: on this card the profiler
    drops the first records of a window now and then."""
    from torch.autograd import DeviceType

    def settled():
        torch.cuda._sleep(2_000_000)
        run()
    prof = _profile(torch, settled)
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def _cold_device_ms(torch, fn, reps, prep, tries=3):
    """(mean device time in ms of one call of fn() after prep(), or None;
    why not), from the profiler: the kernels fn() launches and how often
    (a profile of ``reps`` calls alone), each kernel's mean duration over
    ``reps`` calls after prep(), summed.  Means of each kernel's records
    do not care for a dropped record; a window that lost every record of a
    kernel it needs (the flush's, the call's) is profiled again, up to
    ``tries`` times."""
    from collections import Counter

    def window(run, ok):
        for _ in range(tries):
            recs = _device_records(torch, run)
            if ok(recs):
                break
        return recs

    prep_names = {r.name for r in window(lambda: [prep() for _ in range(3)], bool)}
    if not prep_names:
        return None, "no records of the flush"

    def kernels(recs):  # of fn(), not the flush's or the window's opening sleep
        calls = Counter(r.name for r in recs)
        return {name: round(c / reps) for name, c in calls.items()
                if name not in prep_names and round(c / reps) > 0}
    mix = kernels(window(lambda: [fn() for _ in range(reps)], kernels))
    if not mix:
        return None, "no kernels of the call"
    recs = window(lambda: [(prep(), fn()) for _ in range(reps)],
                  lambda recs: set(mix) <= {r.name for r in recs})
    durations = {}
    for r in recs:
        if r.name in mix:
            durations.setdefault(r.name, []).append(r.time_range.elapsed_us())
    if set(durations) != set(mix):
        return None, f"no cold records of {sorted(set(mix) - set(durations))}"
    return sum(mix[k] * sum(d) / len(d) for k, d in durations.items()) / 1e3, ""


def _csr(torch, offsets, terms, n, d_out, d_in, n_cols, halo=0):
    """The operator sum_k s_k A_k of stencil planes as one torch sparse CSR
    matrix (int32 indices, exact zeros dropped): term (W, s, col0) with W
    (n_off, d_out, d_in, n) puts s W[o, a, b, i] at row i d_out + a, column
    col0 + ((i + off_o) mod n) d_in + b, or in the halo form (``halo`` > 0,
    input rows n + 2 halo) col0 + (i + halo + off_o) d_in + b.  A
    yardstick only: the port never calls it."""
    rows, cols, vals = [], [], []
    i = torch.arange(n, device=terms[0][0].device)
    for W, s, col0 in terms:
        for o, off in enumerate(offsets):
            j = i + halo + off if halo else (i + off) % n
            for a in range(d_out):
                for b in range(d_in):
                    w = W[o, a, b]
                    keep = w != 0
                    rows.append((i * d_out + a)[keep])
                    cols.append((col0 + j * d_in + b)[keep])
                    vals.append((s * w)[keep])
    with warnings.catch_warnings():  # torch's note that sparse CSR is beta
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
            (n * d_out, n_cols), check_invariants=False).coalesce()
        csr = coo.to_sparse_csr()
        return torch.sparse_csr_tensor(
            csr.crow_indices().int(), csr.col_indices().int(), csr.values(),
            csr.shape, check_invariants=False)


def _cold_ms(torch, fn, prep):
    """(L2-cold device ms of fn(), its source, the same by CUDA events
    right around single calls): the profiler's records
    (``_cold_device_ms``), else the events, which count the launch too."""
    events = _launch_ms(torch, fn, 30, prep)
    ms, why = _cold_device_ms(torch, fn, 20, prep)
    if ms is not None:
        return ms, "profiler", events
    return events, f"CUDA events; the profiler's records: {why}", events


def _apply_row(torch, name, kern, plain, args, lib_fn, lib_shape, wrappers,
               pattern, nbytes, flops, replaces, tag, cold):
    """One stencil_apply form against its plain version (max rel <=
    APPLY_RTOL) and its times: L2-cold and warm device time, the wrapper
    call, the plain version and the CSR matvec (cold and warm); without
    ``lib_fn`` the check alone."""
    got = kern(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err, rel = _rel_max(got, want)
    if not bool(torch.isfinite(got).all()) or rel > APPLY_RTOL:
        raise AssertionError(f"{name}: rel err {rel:.3e} > {APPLY_RTOL}")
    row = dict(name=name, route="cuda", source=STENCIL_SRC, replaces=replaces,
               wrappers=wrappers, pattern=pattern, max_abs_err=err)
    if lib_fn is None:
        print(f"{tag} {name}: max abs err {err:.3e}, max rel err {rel:.3e} (<= "
              f"{APPLY_RTOL}); untimed")
        return row
    lib = lib_fn().reshape(lib_shape)
    _, lib_rel = _rel_max(lib, want)
    if lib_rel > CSR_RTOL:
        raise AssertionError(f"{name}: the CSR yardstick is off by {lib_rel:.3e}")
    call_ms = _time_ms(torch, lambda: kern(*args), 50)
    cold_ms, cold_src, cold_ev = _cold_ms(torch, lambda: kern(*args), cold)
    warm_ms, warm_src = _device_ms(torch, lambda: kern(*args), 20, pattern)
    plain_ms = _time_ms(torch, lambda: plain(*args), 10)
    lib_cold, lib_src, lib_cold_ev = _cold_ms(torch, lib_fn, cold)
    lib_warm = _launch_ms(torch, lib_fn, 30)
    bound_ms, bound_by = _bound(nbytes, flops)
    print(f"{tag} {name}: max abs err {err:.3e}, max rel err {rel:.3e} (<= "
          f"{APPLY_RTOL}); device L2-cold {cold_ms:.5f} ms ({cold_src}; CUDA events "
          f"around single launches {cold_ev:.5f}), warm {warm_ms:.5f} ms "
          f"({warm_src}); wrapper call {call_ms:.5f} ms; plain {plain_ms:.4f} ms; "
          f"bound {bound_ms:.5f} ms ({bound_by}) = {100 * bound_ms / cold_ms:.1f}% "
          f"of the cold time; torch.sparse CSR (int32) {lib_cold:.5f} ms cold "
          f"({lib_src}; events {lib_cold_ev:.5f}), {lib_warm:.5f} ms warm (events) = "
          f"{lib_cold / cold_ms:.2f}x the kernel's cold time")
    return dict(row, ms=cold_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_cold, cold_events_ms=cold_ev, call_ms=call_ms,
                warm_ms=warm_ms, library_cold_events_ms=lib_cold_ev,
                library_warm_ms=lib_warm)


def _wrapper_host_us(torch, offs, W, v, reps=400, rounds=5):
    """Host microseconds a call of each step of apply_scalar's launch path
    and of the whole wrapper: the least over ``rounds`` rounds of ``reps``
    calls by perf_counter (the host's neighbours make single rounds
    spread; the launches queue on the device, which keeps up)."""
    from glimslib_tpu_torch import _build
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    n, dev = W.shape[-1], W.device
    y = torch.empty(n, dtype=torch.float32, device=dev)
    entry = sk._entry("glims_stencil_apply")
    pack = _build.pack_offsets(offs, n)[1]
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    ptrs = (W.data_ptr(), v.data_ptr(), y.data_ptr())
    parts = {
        "grad check": lambda: sk._needs_grad(W, v),
        "two tensor checks": lambda: (sk._check("W", W, (len(offs), n), dev),
                                      sk._check("v", v, (n,), dev)),
        "torch.empty_like": lambda: torch.empty_like(v),
        "pack_offsets": lambda: _build.pack_offsets(offs, n),
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "C entry (launch)": lambda: entry(1, 1, *ptrs, n, 0, pack, stream),
        "launch path without the grad check": lambda: sk._scalar_raw(offs, W, v),
        "whole wrapper": lambda: sk.apply_scalar(offs, W, v),
    }
    us = {}
    for name, fn in parts.items():
        fn()
        best = float("inf")
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            best = min(best, time.perf_counter() - t0)
        us[name] = best / reps * 1e6
        torch.cuda.synchronize()
    return us


def phase_applies(torch, offs, theta, wc, dev, tag, suffix="", halo=0, detail=True,
                  timed=True):
    """Every stencil_apply form at one lattice's shapes (the path's planes,
    random vectors from a seed): K1 and K2 against their plain versions
    and the CSR matvec, then the rd residual in one launch against the
    three launches it replaces, both timed as the path calls them.  With
    ``halo`` > 0 the halo form on a node slab's planes (vectors of n + 2
    halo rows), and without ``detail``, the rd residual held and timed
    alone: neither has the host-cost split and the A/B.  Without ``timed``
    every form is held against its plain version and not timed."""
    import functools

    import numpy as np

    from glimslib_tpu_torch.ops import stencil_kernels as sk

    n, d = theta["_Wel"].shape[-1], theta["_Wel"].shape[1]
    nv = n + 2 * halo
    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    v = f32(rng.standard_normal(nv))
    v2 = f32(rng.standard_normal(nv))
    u = f32(rng.standard_normal((nv, d)))
    h = functools.partial  # the halo form: the wrappers with halo bound
    kerns = {f: h(f, halo=halo) if halo else f for f in (
        sk.apply_scalar, sk.apply_vector, sk.apply_coupling, sk.apply_scalar_sum,
        sk.apply_scalar_plain, sk.apply_vector_plain, sk.apply_coupling_plain,
        sk.apply_scalar_sum_plain)}
    cold = _cold_l2(torch, dev)
    k1 = "glimslib_tpu/ops/stencil_pallas.py:108"
    k2 = "glimslib_tpu/ops/stencil_pallas.py:151"
    rows = []
    for name, kern, plain, W, x, d_out, d_in, replaces, wrappers in (
        ("stencil_apply<1,1>", sk.apply_scalar, sk.apply_scalar_plain,
         theta["_Wrd_const"], v, 1, 1, k1, (sk.apply_scalar, sk.apply_scalar_sum)),
        (f"stencil_apply<{d},{d}>", sk.apply_vector, sk.apply_vector_plain,
         theta["_Wel"], u, d, d, k2, (sk.apply_vector,)),
        (f"stencil_apply<{d},1>", sk.apply_coupling, sk.apply_coupling_plain,
         theta["_Cuc"], v, d, 1, k2, (sk.apply_coupling,)),
    ):
        W4 = W.reshape(len(offs), d_out, d_in, n)
        A = _csr(torch, offs, [(W4, 1.0, 0)], n, d_out, d_in, nv * d_in, halo) if timed else None
        xf = x.reshape(-1)
        rows.append(_apply_row(
            torch, name + suffix, kerns[kern], kerns[plain], (offs, W, x),
            (lambda A=A, xf=xf: torch.mv(A, xf)) if timed else None,
            (n, d_out) if d_out > 1 else (n,),
            wrappers, rf"stencil_apply_kernel<{d_out}, ?{d_in}, ?1>",
            4 * (W.numel() + x.numel() + n * d_out), 2 * W.numel(), replaces,
            tag, cold))
        del A
    if halo or not (detail and timed):
        Wc, M, load = theta["_Wrd_const"], theta["_Mst"], theta["_rd_load"]
        A = _csr(torch, offs, [(Wc[:, None, None], 1.0, 0), (wc[:, None, None], 0.5, 0),
                               (M[:, None, None], -1.0, nv)], n, 1, 1, 2 * nv,
                 halo) if timed else None
        x2 = torch.cat([v, v2])
        rows.append(_apply_row(
            torch, "stencil_apply<1,1,3>" + suffix, kerns[sk.apply_scalar_sum],
            kerns[sk.apply_scalar_sum_plain],
            (offs, ((Wc, v, 1.0), (wc, v, 0.5), (M, v2, -1.0)), load),
            (lambda: torch.addmv(load, A, x2, beta=-1.0)) if timed else None, (n,),
            (sk.apply_scalar_sum,),
            r"stencil_apply_kernel<1, ?1, ?3>", 4 * (3 * Wc.numel() + 2 * nv + 2 * n),
            6 * Wc.numel() + 4 * n, k1, tag, cold))
        return rows
    host = _wrapper_host_us(torch, offs, theta["_Wrd_const"], v)
    print(f"{tag} apply_scalar host cost a call, us (perf_counter, the least "
          "of 5 rounds of 400 calls): "
          + ", ".join(f"{k} {us:.2f}" for k, us in host.items()))
    rows[0]["host_us"] = host

    # the lattice rd residual: W_const c + wc c / 2 - M c_prev - load
    Wc, M, load = theta["_Wrd_const"], theta["_Mst"], theta["_rd_load"]
    terms = ((Wc, v, 1.0), (wc, v, 0.5), (M, v2, -1.0))
    A = _csr(torch, offs, [(Wc[:, None, None], 1.0, 0), (wc[:, None, None], 0.5, 0),
                           (M[:, None, None], -1.0, n)], n, 1, 1, 2 * n)
    x2 = torch.cat([v, v2])
    row = _apply_row(
        torch, "stencil_apply<1,1,3>" + suffix, sk.apply_scalar_sum,
        sk.apply_scalar_sum_plain, (offs, terms, load),
        lambda: torch.addmv(load, A, x2, beta=-1.0), (n,), (sk.apply_scalar_sum,),
        r"stencil_apply_kernel<1, ?1, ?3>", 4 * (3 * Wc.numel() + 4 * n),
        6 * Wc.numel() + 4 * n, k1, tag, cold)
    del A

    def three():
        return (sk.apply_scalar(offs, Wc, v) + 0.5 * sk.apply_scalar(offs, wc, v)
                - sk.apply_scalar(offs, M, v2) - load)

    def one():
        return sk.apply_scalar_sum(offs, terms, load)

    err, rel = _rel_max(one(), three())
    ab = {"3 launches": [], "1 launch": []}
    for label in ("3 launches", "1 launch", "1 launch", "3 launches"):
        fn = three if label == "3 launches" else one
        cold_ms, cold_src, cold_ev = _cold_ms(torch, fn, cold)
        ab[label].append((_time_ms(torch, fn, 50), cold_ms, cold_ev))
        if cold_src != "profiler":
            print(f"{tag} rd residual, {label}: L2-cold time from {cold_src}")
    print(f"{tag} rd residual, in-path A/B (turns 3, 1, 1, 3; ms: wrapper "
          "calls back to back / L2-cold device time of its kernels (profiler) / "
          "the same by CUDA events around the call): " + "; ".join(
              f"{k} " + ", ".join(f"{c:.5f} / {d:.5f} / {e:.5f}" for c, d, e in v_)
              for k, v_ in ab.items())
          + f"; one launch vs three max rel {rel:.3e}")
    row["ab_ms"] = {k: [list(p) for p in v_] for k, v_ in ab.items()}
    rows.append(row)
    return rows


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(f"[1] nvidia-smi: {smi[0]}")
    from glimslib_tpu_torch import _build

    nvcc_v = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                            text=True, check=True).stdout.strip().splitlines()
    print(f"[1] torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"nvcc: {nvcc_v[-1]}")
    a = torch.ones((4, 3), dtype=torch.bfloat16, device="cuda")
    try:
        y = torch.mm(a, a.T, out_dtype=torch.float32)
        has = f"yes ({y.dtype}, {float(y[0, 0])})"
    except (TypeError, RuntimeError, NotImplementedError) as e:
        has = f"no ({type(e).__name__}: {e})"
    print(f"[1] torch.mm with out_dtype=float32 on bf16 CUDA operands (the bf16 "
          f"coarse factors' products): {has}")
    t0 = time.perf_counter()
    for name in _build.SOURCES:
        _build.load(name)
    print(f"[1] kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"({', '.join(_build.library_path(n).name for n in _build.SOURCES)})")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                print(f"[1]   {name}: {line.strip()}")
    return smi[0]


def _pcg_work(n_off, d, n, iters):
    """(bytes once, operations) of a whole-solve stencil PCG: planes,
    preconditioner, b and x once; per iteration one plane apply, one
    preconditioner apply and ~12 n d vector operations."""
    m_len = d * d * n if d > 1 else n
    nbytes = 4 * (n_off * d * d * n + m_len + 2 * n * d)
    flops = (iters + 1) * (2 * n_off * d * d * n + 2 * m_len + 12 * n * d)
    return nbytes, flops


def _pcg_stream_bytes(n_off, d, n):
    """Bytes an iteration if planes, preconditioner and four vector passes
    came from HBM every iteration (the streaming figure)."""
    return 4 * (n_off * d * d * n + d * d * n + 4 * n * d)


def phase_kernels(torch, sim, theta, dev, tag="[2]", suffix="", grids=(), forced=True,
                  detail=True, timed=True):
    """Each lattice kernel vs its plain version at the model's shapes (the
    path's planes, random vectors from a seed); the elasticity solve also
    in every other mode that fits (``forced``), and on the plan's mode
    with ``grids`` blocks (printed only); ``detail``: the apply's host-cost
    split and the rd residual's A/B (:func:`phase_applies`); ``timed``:
    the times (without it each kernel is held against its plain version
    only)."""
    import numpy as np

    from glimslib_tpu_torch.ops import fused_cg as fc

    ops = sim._stencil_ops
    offs = ops.offsets
    n, d = sim.mesh.n_nodes, sim.mesh.dim
    mask_u, mask_c, _, _ = sim._bc_masks_and_values()
    c0 = sim.initial_state()[1]
    wc = ops.build_rd_wc(c0, theta["rho"], theta["dt"])
    results = phase_applies(torch, offs, theta, wc, dev, tag, suffix, detail=detail,
                            timed=timed)

    rng = np.random.default_rng(0)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    v = f32(rng.standard_normal(n))
    u = f32(rng.standard_normal((n, d)))
    cfg = sim.step_config
    Wrd = theta["_Wrd_const"] + wc
    solves = [
        ("stencil_pcg<1>", fc.cg_scalar, fc.cg_scalar_plain,
         fc.fold_mask_scalar(offs, Wrd, mask_c), theta["_invdM"],
         torch.where(mask_c, 0.0, v), "glimslib_tpu/ops/pallas_cg.py:204"),
        (f"stencil_pcg<{d}>", fc.cg_vector, fc.cg_vector_plain,
         theta["_WelM"], theta["_BinvM"], torch.where(mask_u, 0.0, u),
         "glimslib_tpu/ops/pallas_cg.py:315"),
    ]
    for name, kern, plain, Wm, Minv, b, replaces in solves:
        row = _check_pcg(torch, name, kern, plain, offs, Wm, Minv, b, cfg,
                         replaces, tag, timed=timed)
        row["name"] += suffix
        results.append(row)
    name, kern, plain, Wm, Minv, b, replaces = solves[1]
    chosen = results[-1]["mode"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for mode in fc.MODES if forced else ():
        try:
            fc.launch_plan(n, d, len(offs), sms, mode)
        except ValueError:
            continue
        if mode != chosen:
            _check_pcg(torch, name, kern, plain, offs, Wm, Minv, b, cfg, replaces,
                       f"{tag} (forced {mode})", mode=mode)
    for blocks in grids:
        _check_pcg(torch, name, kern, plain, offs, Wm, Minv, b, cfg, replaces,
                   f"{tag} ({blocks} blocks)", blocks=blocks)
    return results


# the last system's plain solve, its result and host ms: a solve checked
# again in another launch mode or grid reuses them (cut from a plain solve
# and a timed one a check)
_LAST_PLAIN = {}


def _plain_pcg(torch, plain, args, timed):
    """(x, info, host ms or None) of the plain pcg on ``args``, kept for the
    next call on the same tensors and settings."""
    last = _LAST_PLAIN.get("args")
    if last is None or len(last) != len(args) or any(a is not b for a, b in zip(last, args)):
        _LAST_PLAIN.clear()
        _LAST_PLAIN.update(args=args, out=plain(*args), ms=None)
    if timed and _LAST_PLAIN["ms"] is None:
        _LAST_PLAIN["ms"] = _host_ms(torch, lambda: plain(*args))
    return (*_LAST_PLAIN["out"], _LAST_PLAIN["ms"])


def _check_pcg(torch, name, kern, plain, offs, Wm, Minv, b, cfg, replaces, tag,
               mode=None, blocks=None, timed=True):
    """One whole solve of the kernel against the plain pcg, and its times
    (``timed``): through the wrapper ``kern`` as the path calls it, or with
    ``mode`` forcing the launch plan's mode or ``blocks`` its grid."""
    from glimslib_tpu_torch.ops import fused_cg as fc

    args = (offs, Wm, Minv, b, cfg.cg_rtol, cfg.cg_atol, cfg.cg_maxiter)
    d = b.shape[1] if b.dim() > 1 else 1
    if mode is None and blocks is None:
        def call():
            x, info = kern(*args)
            return x, info, kern.last_plan
    else:
        W4 = Wm if d > 1 else Wm[:, None, None, :]

        def call():
            return fc._pcg_cuda(d, offs, W4, Minv, b, *args[4:], mode, blocks)
    x_k, info_k, plan = call()
    x_p, info_p, plain_ms = _plain_pcg(torch, plain, args, timed)
    torch.cuda.synchronize()
    it_k, it_p = int(info_k["iters"]), int(info_p["iters"])
    err, rel = _rel_max(x_k, x_p)
    dit_max = PCG_DITERS if it_p < PCG_LONG else int(PCG_DITERS_SHARE * it_p)
    if (not bool(torch.isfinite(x_k).all()) or abs(it_k - it_p) > dit_max
            or rel > PCG_RTOL):
        raise AssertionError(f"{name}: iters {it_k} vs {it_p}, rel err {rel:.3e}")
    f64_iters = ""
    if abs(it_k - it_p) > PCG_DITERS:
        _, info64 = plain(*(a.double() if torch.is_tensor(a) else a for a in args))
        f64_iters = f"; the same solve in f64 (plain) takes {int(info64['iters'])}"
    if not timed:
        print(f"{tag} {name}: n={b.shape[0]}, mode {plan.mode}, iters kernel {it_k} / "
              f"plain {it_p} (|Δ| <= {dit_max}{f64_iters}), max abs err {err:.3e}, "
              f"max rel err {rel:.3e} (<= {PCG_RTOL}); untimed")
        return dict(name=name, route="cuda", source=STENCIL_SRC, replaces=replaces,
                    wrappers=(kern,), max_abs_err=err, mode=plan.mode, iters=it_k)
    ms = _time_ms(torch, call, 3)
    dev_ms = _launch_ms(torch, call, 3)
    prof_ms = _kernel_device_ms(torch, call, 2,
                                rf"stencil_pcg_kernel<{d}, ?{fc.MODES[plan.mode]}>")
    n_off, n = Wm.shape[0], b.shape[0]
    bound_ms, bound_by = _bound(*_pcg_work(n_off, d, n, it_k))
    stream_it = _pcg_stream_bytes(n_off, d, n)
    stream_ms = stream_it * it_k / HBM_BPS * 1e3
    us_it = 1e3 * dev_ms / max(it_k, 1)
    print(f"{tag} {name}: n={n}, mode {plan.mode} ({plan.blocks} blocks of "
          f"{plan.nloc} nodes, {plan.stages} stage(s), {plan.smem_bytes} B of "
          f"shared memory a block), iters kernel {it_k} / plain {it_p} "
          f"(|Δ| <= {dit_max}{f64_iters}), resnorm {float(info_k['resnorm']):.3e} / "
          f"{float(info_p['resnorm']):.3e}, max abs err {err:.3e}, max rel "
          f"err {rel:.3e} (<= {PCG_RTOL})")
    print(f"{tag} {name}: kernel on device {dev_ms:.4f} ms (CUDA events, "
          "single launches"
          + ("" if prof_ms is None else f"; profiler {prof_ms:.4f} ms")
          + f") = {us_it:.2f} us an "
          f"iteration; wrapper call {ms:.4f} ms; plain {plain_ms:.4f} ms (host "
          f"clock, syncs every iteration); bound {bound_ms:.4f} ms ({bound_by}) "
          f"= {100 * bound_ms / dev_ms:.1f}% of the device time; streaming "
          f"figure {stream_it / 1e6:.1f} MB = {1e3 * stream_ms / max(it_k, 1):.2f} "
          f"us an iteration at 3.35 TB/s = {100 * stream_ms / dev_ms:.1f}% of it")
    return dict(name=name, route="cuda", source=STENCIL_SRC, replaces=replaces,
                wrappers=(kern,), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                device_ms=dev_ms, profiler_ms=prof_ms, mode=plan.mode,
                us_per_iter=us_it, iters=it_k)


def _print_breakdown(torch, run, run_ms, tag, detail=None, profiled=None,
                     run_name="the unprofiled run's"):
    """Device time by kernel over one profiled simulate, and the device's
    busy share: of the profiled run's wall time (the profiler adds host
    overhead) and of ``run_ms``, the unprofiled run's mean wall time
    (``run_name`` names it).
    Kernels whose name matches ``detail`` are printed too, with their time
    a launch; returns ({name: ms a launch} for them, the device busy ms,
    the idle share of the unprofiled run).  ``profiled``: (profile, its
    wall ms) of a run made already, in place of profiling run()."""
    if profiled is None:
        t0 = time.perf_counter()
        prof = _profile(torch, run, cpu=False)
        wall_ms = (time.perf_counter() - t0) * 1e3
    else:
        prof, wall_ms = profiled
    evts = sorted(_device_kernels(prof).items(), key=lambda kv: kv[1][1], reverse=True)
    busy_ms = sum(us for _, (_, us) in evts) / 1e3
    if busy_ms <= 0:
        print(f"{tag} device time breakdown: none (the profiler recorded "
              "no device time)")
        return {}, None, None
    print(f"{tag} profiled run: device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / wall_ms:.1f}% of its wall {wall_ms:.2f} ms; "
          f"{100 * busy_ms / run_ms:.1f}% of {run_name} "
          f"{run_ms:.2f} ms, so the device idles "
          f"{100 * max(0.0, 1 - busy_ms / run_ms):.1f}% of it")
    per_launch = {}
    for k, (key, (count, us)) in enumerate(evts):
        hit = detail is not None and re.search(detail, key)
        if k < 10 or hit:
            print(f"{tag}   {100 * us / 1e3 / busy_ms:5.1f}%  {us / 1e3:8.3f} ms  "
                  f"x{count:<6d} {key[:90]}"
                  + (f"  ({us / max(count, 1):.2f} us a launch)" if hit else ""))
        if hit:
            per_launch[key] = us / max(count, 1) / 1e3
    return per_launch, busy_ms, max(0.0, 1 - busy_ms / run_ms)


def _drive(torch, sim, simulate, args, groups, tag, n_steps, shown=()):
    """One run of the path with every count set to 0 just before it:
    returns the trajectory, the launches by wrapper and the seconds.
    ``groups`` holds one tuple of wrappers a kernel (the wrappers that
    launch it); each kernel must launch at least once.  ``shown``:
    wrappers whose launches are counted and printed too, without that
    demand."""
    wrappers = list(dict.fromkeys([w for g in groups for w in g] + list(shown)))
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_tr, c_tr, ok, newton = simulate(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {w: w.launches for w in wrappers}
    rd_iters = [int(i) for i in sim.solver_info["rd_cg_iters"]]
    el_iters = [int(i) for i in sim.solver_info["el_cg_iters"]]
    fix_iters = [int(i) for i in sim.solver_info["el_refine_cg_iters"]]
    print(f"{tag} {sim.mesh.n_nodes} nodes, {sim.mesh.n_cells} cells; first run "
          f"{first_s:.3f} s")
    print(f"{tag} converged per step {ok.tolist()}; Newton iterations per step "
          f"{newton.tolist()}; rd CG iterations per Newton solve {rd_iters}; "
          f"elasticity CG iterations per step {el_iters}"
          + (f"; refinement correction solves (CG iterations) {fix_iters}"
             if fix_iters else ""))
    print(f"{tag} launches in that run: " + ", ".join(
        f"{w.__name__}={n}" for w, n in launches.items()))
    if not bool(ok.all()):
        raise AssertionError(f"{tag} a step did not converge")
    missing = [[w.__name__ for w in g] for g in groups
               if sum(launches[w] for w in g) < 1]
    if missing:
        raise AssertionError(f"{tag} kernels not launched on the path: {missing}")
    if not (bool(torch.isfinite(u_tr).all()) and bool(torch.isfinite(c_tr).all())):
        raise AssertionError(f"{tag} non-finite state")
    assert tuple(u_tr.shape) == (n_steps, sim.mesh.n_nodes, sim.mesh.dim)
    assert tuple(c_tr.shape) == (n_steps,) + tuple(args[2].shape)
    return (u_tr, c_tr), launches, first_s


# timed runs a path (cut from 3 to fit [15], then from 2 to keep the
# script well inside its limit)
TIMED_RUNS = 1


def _time_runs(torch, simulate, args, dev, tag, n_steps, detail=None, profiled=None,
               breakdown=True):
    """Steps/s over TIMED_RUNS runs, peak memory, and (``breakdown``) the
    breakdown of one profiled run (``profiled``: of a run profiled
    already, :func:`_print_breakdown`); returns its ms a launch of the
    kernels matching ``detail``, and {steps_per_s, device_busy_ms,
    idle_share}."""
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        out = simulate(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    sps = n_steps / (sum(times) / len(times))
    if not bool(out[2].all()):
        raise AssertionError(f"{tag} a timed run did not converge")
    print(f"{tag} steps/s {sps:.4f} ({TIMED_RUNS} runs of {n_steps} steps: "
          f"{', '.join(f'{t:.4f}' for t in times)} s); peak memory "
          f"{peak / 2**20:.1f} MiB")
    if not breakdown:
        return {}, dict(steps_per_s=sps, device_busy_ms=None, idle_share=None)
    per_launch, busy, idle = _print_breakdown(
        torch, lambda: simulate(*args), 1e3 * sum(times) / len(times), tag, detail,
        profiled)
    return per_launch, dict(steps_per_s=sps, device_busy_ms=busy, idle_share=idle)


def _set_launches(rows, launches, run=""):
    """Each row's launches on the path (``launches`` + ``run``): the sum
    over the wrappers that launch its kernel (K1's kernel is launched by
    apply_scalar and, as the rd residual, by apply_scalar_sum), with the
    split where there are two."""
    for k in rows:
        k["launches" + run] = sum(launches[w] for w in k["wrappers"])
        if len(k["wrappers"]) > 1:
            k["launches_by_wrapper" + run] = {
                w.__name__: launches[w] for w in k["wrappers"]}


def _forward_groups(sim, groups):
    """The kernels a lattice forward launches: all of ``groups``, or under
    refine_f64 those of the solves alone (Newton and the elasticity
    solve measure the f64 gather residuals, so the working residuals'
    stencil_apply runs only in a backward)."""
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    if not sim.step_config.refine_f64:
        return groups
    applies = {sk.apply_scalar, sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling}
    return [g for g in groups if not set(g) <= applies]


def phase_slice(torch, sim, ref, dev, kernels, tag, n_steps, run="", keep=None):
    """A lattice path (``sim``, f32) through the kernels of ``kernels``
    (those a refined forward runs, where the model refines): one run with
    the counts at 0, TIMED_RUNS timed runs and a profiled one, then the final c and
    u against ``ref``, the same model on the plain path at f64 with tight
    tolerances; returns ``ref`` at its default tolerances, its final
    (u, c) and the f32 path's rel-L2 errors (c, u).  ``keep`` (a dict)
    gains the state after MF_STEPS steps ([15a] holds the matrix-free lane
    to it)."""
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    simulate = sim.build_simulate_fn(n_steps, 1.0)
    groups = [k["wrappers"] for k in kernels]
    (u_tr, c_tr), launches, _ = _drive(
        torch, sim, simulate, (theta, u0, c0), _forward_groups(sim, groups),
        tag, n_steps, shown=[w for g in groups for w in g])
    _set_launches(kernels, launches, run)
    if keep is not None:
        keep[f"lattice_bench_{MF_STEPS}"] = (u_tr[MF_STEPS - 1], c_tr[MF_STEPS - 1])
    in_path, _ = _time_runs(torch, simulate, (theta, u0, c0), dev, tag, n_steps,
                            r"stencil_apply_kernel")
    for k in kernels:
        if "pattern" in k:
            k["in_path_ms" + run] = next((ms for key, ms in in_path.items()
                                          if re.search(k["pattern"], key)), None)

    f64_defaults = ref.step_config
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14,
                                 cg_rtol=1e-12, cg_maxiter=4000)
    t0 = time.perf_counter()
    u_r, c_r, ok_r, newton_r = ref.build_simulate_fn(n_steps, 1.0)(
        ref.make_theta(ref.params.as_dict()), *ref.initial_state())
    torch.cuda.synchronize()
    if not bool(ok_r.all()):
        raise AssertionError("f64 plain reference did not converge")
    rel_c = _rel_l2(c_tr[-1], c_r[-1])
    rel_u = _rel_l2(u_tr[-1], u_r[-1])
    print(f"{tag} f64 plain reference on the card ({time.perf_counter() - t0:.1f} s, "
          f"Newton {newton_r.tolist()}): rel-L2 c {rel_c:.3e}, u {rel_u:.3e} "
          f"(<= {SLICE_RTOL})")
    if rel_c > SLICE_RTOL or rel_u > SLICE_RTOL:
        raise AssertionError(f"{tag} slice vs f64 reference: c {rel_c:.3e}, u {rel_u:.3e}")
    # [7] takes the gradient of the same model at the f64 defaults
    ref.step_config = f64_defaults
    return ref, (u_r[-1], c_r[-1]), (rel_c, rel_u)


def phase_lattice_big(torch, dev, sim, tag, suffix, n_steps):
    """K3c: a lattice path past the resident layout (``sim``, f32; its
    model set-up timed by the caller), its elasticity solve streamed."""
    import numpy as np

    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    d = sim.mesh.dim
    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    simulate = sim.build_simulate_fn(n_steps, 1.0)
    groups = [(sk.apply_scalar, sk.apply_scalar_sum), (sk.apply_vector,),
              (sk.apply_coupling,), (sk.apply_scalar_sum,), (fc.cg_scalar,),
              (fc.cg_vector,)]
    _, launches, _ = _drive(torch, sim, simulate, (theta, u0, c0), groups,
                            f"{tag} {suffix[1:]}:", n_steps)
    path_mode = fc.cg_vector.last_plan.mode
    print(f"{tag} {suffix[1:]}: the path's elasticity solves ran stencil_pcg<{d}> "
          f"{path_mode}")
    if path_mode == "resident":
        raise AssertionError(f"{tag} the elasticity solve ran resident, not streamed")

    aug = sim._augment_theta_with_operators(theta)
    mask_u, mask_c, _, _ = sim._bc_masks_and_values()
    ops = sim._stencil_ops
    wc = ops.build_rd_wc(c0, aug["rho"], aug["dt"])
    applies = phase_applies(torch, ops.offsets, aug, wc, dev, tag, suffix)
    _set_launches(applies, launches)
    # the first step's elasticity system: the rhs of u from rest
    ru = sim.el_residual(torch.where(mask_u, 0.0, u0), c0, aug, 1.0)
    b = torch.where(mask_u, 0.0, -ru).contiguous()
    cfg = sim.step_config
    el = _check_pcg(torch, f"stencil_pcg<{d}>", fc.cg_vector, fc.cg_vector_plain,
                    ops.offsets, aug["_WelM"], aug["_BinvM"], b, cfg,
                    "glimslib_tpu/ops/pallas_cg.py:497", tag)
    el["name"] += suffix
    el["launches"] = launches[fc.cg_vector]
    # the same solve with x, r and Ap in global memory, the layout the plan
    # takes where they do not fit beside two ring stages (printed only)
    _check_pcg(torch, f"stencil_pcg<{d}>", fc.cg_vector, fc.cg_vector_plain,
               ops.offsets, aug["_WelM"], aug["_BinvM"], b, cfg,
               "glimslib_tpu/ops/pallas_cg.py:497", f"{tag} (forced streamed_global)",
               mode="streamed_global")
    # an rd Newton system of the first step, from the initial state
    Wrd = aug["_Wrd_const"] + wc
    v = torch.as_tensor(np.random.default_rng(2).standard_normal(sim.mesh.n_nodes),
                        dtype=torch.float32, device=dev)
    rd = _check_pcg(torch, "stencil_pcg<1>", fc.cg_scalar, fc.cg_scalar_plain,
                    ops.offsets, fc.fold_mask_scalar(ops.offsets, Wrd, mask_c),
                    aug["_invdM"], torch.where(mask_c, 0.0, v), cfg,
                    "glimslib_tpu/ops/pallas_cg.py:204", tag)
    rd["name"] += suffix
    rd["launches"] = launches[fc.cg_scalar]
    return applies + [el, rd]


def _bmv_shapes(torch, usim, theta, dev, tag):
    """bell_bmv vs its plain version at the five shapes an unstructured
    model's tables give it, each timed; returns one record a shape."""
    plan = usim._get_bell_plan()
    nb, s, Kh, d = plan.nb, plan.s, plan.Kh, usim.mesh.dim
    return _bmv_check(torch, [
        ("elasticity operator _BellWel", theta["_BellWel"].reshape(nb, s * d, Kh * d)),
        ("coupling _BellCuc", theta["_BellCuc"].reshape(nb, s * d, Kh)),
        ("elasticity supernode Jacobi _BinvSN", theta["_BinvSN"]),
        ("rd constant planes _BellWrdC", theta["_BellWrdC"]),
        ("rd supernode Jacobi _McSN", theta["_McSN"]),
    ], dev, tag)


def _bmv_check(torch, roles, dev, tag):
    """bell_bmv vs its plain version at each (role, A) of ``roles``, each
    timed as torch.bmm is timed beside it: device time L2-cold
    (``_cold_device_ms``, as [2] times stencil_apply; on the paths a table
    is read after others have evicted it) and warm (``_call_device_ms``),
    each time's source in the record's ``timing``; also prints the wrapper
    call, the plain version, the bound, the share and the launch plan
    (``plan_for``).  The cold time weights the bound in :func:`_bmv_split`.
    Returns one record a shape."""
    import numpy as np

    from glimslib_tpu_torch.ops import bell_kernels as bk

    prep = _cold_l2(torch, dev)
    rng = np.random.default_rng(1)
    shapes = []
    for role, A in roles:
        B, M, K = A.shape
        x = torch.as_tensor(rng.standard_normal((B, K)), dtype=torch.float32,
                            device=dev)
        got = bk.batched_matvec(A, x)
        want = bk.batched_matvec_plain(A, x)
        torch.cuda.synchronize()
        err, rel = _rel_max(got, want)
        if not bool(torch.isfinite(got).all()) or rel > BMV_RTOL:
            raise AssertionError(f"bell_bmv {role}: rel err {rel:.3e} > {BMV_RTOL}")
        kern = lambda: bk.batched_matvec(A, x)  # noqa: E731
        bmm = lambda: torch.bmm(A, x[:, :, None])  # noqa: E731
        ms = _time_ms(torch, kern, 50)
        t, src = {}, {}
        for who, fn in (("kernel", kern), ("torch.bmm", bmm)):
            cold, why = _cold_device_ms(torch, fn, 10, prep)
            if cold is None:
                cold = _launch_ms(torch, fn, 10, prep)
                why = f"CUDA events around single calls, launch included ({why})"
            warm, warm_src = _call_device_ms(torch, fn, 20)
            t[who] = cold, warm
            src[who] = dict(cold=why or "profiler", warm=warm_src)
        (dev_ms, warm_ms), (lib_ms, lib_warm) = t["kernel"], t["torch.bmm"]
        odd = {w: s for w, s in src.items() if s != dict(cold="profiler", warm="profiler")}
        if odd:
            print(f"{tag} bell_bmv {role}: not every time is the profiler's: {odd}")
        plain_ms = _time_ms(torch, lambda: bk.batched_matvec_plain(A, x), 20)
        bound_ms, bound_by = _bound(4 * (B * M * K + B * K + B * M), 2 * B * M * K)
        share = bound_ms / dev_ms
        plan = bk.plan_for(A)
        print(f"{tag} bell_bmv {role} (B, M, K) = {(B, M, K)}: max abs err "
              f"{err:.3e}, max rel err {rel:.3e} (<= {BMV_RTOL}); device L2-cold "
              f"{dev_ms:.5f} ms, warm {warm_ms:.5f} ms; torch.bmm L2-cold "
              f"{lib_ms:.5f} ms, warm {lib_warm:.5f} ms ({lib_ms / dev_ms:.2f}x the "
              f"kernel's cold time); wrapper call {ms:.4f} ms, plain {plain_ms:.4f} ms; "
              f"bound {bound_ms:.5f} ms ({bound_by}, {4 * B * M * K / 1e6:.1f} MB of "
              f"table) = {100 * share:.1f}% of the cold time; plan R "
              f"{plan.rows_per_span}, {plan.mode}, S {plan.stages}, G {plan.group}, "
              f"blocks {plan.blocks}")
        shapes.append(dict(role=role, shape=[B, M, K], max_abs_err=err, ms=ms,
                           device_ms=dev_ms, warm_device_ms=warm_ms, plain_ms=plain_ms,
                           library_ms=lib_ms, library_warm_ms=lib_warm,
                           bound_ms=bound_ms, bound_by=bound_by,
                           timing=src,
                           plan=dict(R=plan.rows_per_span, mode=plan.mode,
                                     S=plan.stages, G=plan.group, blocks=plan.blocks)))
    return shapes


def phase_bmv(torch, usim, theta, dev):
    """bell_bmv vs its plain version at the flagship's five shapes."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    shapes = _bmv_shapes(torch, usim, theta, dev, "[5]")
    top = shapes[0]
    return dict(name="bell_bmv", route="cuda", source=BELL_SRC,
                replaces="glimslib_tpu/ops/bell_pallas.py:56", wrappers=(bk.batched_matvec,),
                max_abs_err=max(r["max_abs_err"] for r in shapes),
                ms=top["device_ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
                bound_by=top["bound_by"], library_ms=top["library_ms"],
                call_ms=top["ms"],
                also_replaces=["glimslib_tpu/ops/bell_pallas.py:199",
                               "glimslib_tpu/ops/bell_pallas.py:229"],
                shapes=shapes)


def _bmv_split(kern, by_shape, tag="[6]", shapes="shapes", what="run"):
    """bell_bmv's launches on a path by (B, M, K), and the share of the
    bound weighted by them: sum of launches x bound over sum of launches x
    device time, with the times of each shape in ``kern[shapes]``."""
    times = {tuple(r["shape"]): r for r in kern[shapes]}
    timed = {s: c for s, c in by_shape.items() if s in times}
    bound = sum(c * times[s]["bound_ms"] for s, c in timed.items())
    device = sum(c * times[s]["device_ms"] for s, c in timed.items())
    share = bound / device if device > 0 else None
    print(f"{tag} bell_bmv launches in that {what} by (B, M, K): " + ", ".join(
        f"{s}: {c}" for s, c in sorted(by_shape.items(), key=lambda x: -x[1]))
        + (f"; weighted by them, the device time is {device:.3f} ms against a "
           f"bound of {bound:.3f} ms = {100 * share:.1f}% of the bound"
           if share is not None else "")
        + (f" (shapes not timed: {sorted(set(by_shape) - set(timed))})"
           if len(timed) < len(by_shape) else ""))
    return share


def phase_unstructured(torch, dev):
    """The unstructured path at n=32 (set-up, kernel checks, runs)."""
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG, brain_sim
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    t0 = time.perf_counter()
    sim = brain_sim(n=N, dtype=torch.float32, device=dev, unstructured=True)
    assert sim.mesh.lattice_strides is None
    sim.step_config = UNSTRUCT_STEP_CONFIG
    model_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = sim._get_bell_plan()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    aux = sim.runtime_aux()
    torch.cuda.synchronize()
    aux_s = time.perf_counter() - t0
    print(f"[6] n={N} unstructured set-up: model {model_s:.2f} s, BellPlan "
          f"{plan_s:.2f} s (nb={plan.nb}, s={plan.s}, Kh={plan.Kh}), frozen "
          f"preconditioners {aux_s:.2f} s ("
          + ", ".join(f"{k} {v:.2f} s" for k, v in sim.setup_seconds.items())
          + f"); coarse factors {tuple(aux['_TLCfac'].shape)} and "
          f"{tuple(aux['_TLCfacS'].shape)}")
    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    sim._build_step()
    aug = sim._augment_theta_with_operators({**theta, **aux})
    kern = phase_bmv(torch, sim, aug, dev)
    del aug

    simulate = sim.build_simulate_fn(N_STEPS, 1.0)
    bk.batched_matvec.launches_by_shape = {}
    (u_tr, c_tr), launches, _ = _drive(torch, sim, simulate, (theta, u0, c0),
                                       [(bk.batched_matvec,)], f"[6] n={N}:", N_STEPS)
    kern["launches"] = launches[bk.batched_matvec]
    by_shape = dict(bk.batched_matvec.launches_by_shape)
    kern["launches_by_shape"] = {"x".join(map(str, s)): c for s, c in by_shape.items()}
    kern["weighted_bound_share"] = _bmv_split(kern, by_shape)
    iters = {k: [int(i) for i in sim.solver_info[k]] for k in ("rd_cg_iters", "el_cg_iters")}
    _, run = _time_runs(torch, simulate, (theta, u0, c0), dev, "[6]", N_STEPS)

    ref = brain_sim(n=N, dtype=torch.float64, device=dev, plain=True,
                    unstructured=True)
    f64_defaults = ref.step_config
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14,
                                 cg_rtol=1e-12, cg_maxiter=4000)
    # the frozen coarse factors carry over (a preconditioner changes
    # iteration counts only); the supernode inverses are rebuilt in f64
    ref._aux_cache = {k: v.double() for k, v in aux.items() if k.startswith("_TL")}
    t0 = time.perf_counter()
    u_r, c_r, ok_r, newton_r = ref.build_simulate_fn(N_STEPS, 1.0)(
        ref.make_theta(ref.params.as_dict()), *ref.initial_state())
    torch.cuda.synchronize()
    if not bool(ok_r.all()):
        raise AssertionError("unstructured f64 plain reference did not converge")
    rel_c = _rel_l2(c_tr[-1], c_r[-1])
    rel_u = _rel_l2(u_tr[-1], u_r[-1])
    el_r = [int(i) for i in ref.solver_info["el_cg_iters"]]
    print(f"[6] f64 plain reference on the card ({time.perf_counter() - t0:.1f} s, "
          f"Newton {newton_r.tolist()}, elasticity CG {el_r}): rel-L2 c "
          f"{rel_c:.3e}, u {rel_u:.3e} (<= {UNSTRUCT_RTOL})")
    if rel_c > UNSTRUCT_RTOL or rel_u > UNSTRUCT_RTOL:
        raise AssertionError(
            f"unstructured slice vs f64 reference: c {rel_c:.3e}, u {rel_u:.3e}")
    ref.step_config = f64_defaults
    # what [9] holds its unstructured runs against
    base = dict(ref_traj=(u_r, c_r), rel=(rel_c, rel_u), iters=iters, run=run)
    return kern, sim, ref, base


def _call_device_ms(torch, fn, reps=3, tries=3):
    """(device ms of one call of fn(), its source): from the profiler over
    ``reps`` calls (after one warm-up; the window opened by a sleep kernel,
    which is not counted), each kernel's mean duration times how often a
    call launches it, summed, so a record the profiler drops (it does, in
    a long process) costs a sample, not the number; a window with fewer
    records than calls is profiled again, up to ``tries`` times.  Else
    CUDA events around single calls."""
    fn()
    for _ in range(tries):
        recs = [r for r in _device_records(torch, lambda: [fn() for _ in range(reps)])
                if not re.search(SLEEP_KERNEL, r.name)]
        if len(recs) >= reps:
            break
    if recs:
        us = {}
        for r in recs:
            us.setdefault(r.name, []).append(r.time_range.elapsed_us())
        return sum(max(1, round(len(d) / reps)) * sum(d) / len(d)
                   for d in us.values()) / 1e3, "profiler"
    return _launch_ms(torch, fn, reps), "CUDA events"


def _vjp_passes(torch, sim, c, lattice, tag):
    """Device ms a call of the plain-torch VJP passes the lane's backward
    runs, at the model's shapes (random cotangents from a seed; ``c`` the
    initial concentration): the reference's XLA VJPs, not kernel ports."""
    import numpy as np

    from glimslib_tpu_torch.ops import bell
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    rng = np.random.default_rng(4)
    dev = sim.device
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,  # noqa: E731
                                     device=dev)
    theta = sim.make_theta(sim.params.as_dict())
    n = sim.mesh.n_nodes
    D = theta["D"].detach().clone().requires_grad_()
    rho = theta["rho"].detach().clone().requires_grad_()
    passes = {}
    if lattice:
        ops = sim._stencil_ops
        offs = ops.offsets
        y, v = f32(n), f32(n)
        gW = f32(len(offs), n)
        passes[f"dW = y_bar (x) shifted v, ({len(offs)}, n)"] = lambda: sk.plane_grad(offs, y, v)
        passes["assembly backward: rd constant planes -> D, rho"] = lambda: torch.autograd.grad(
            ops.build_rd_jacobian_const(D, rho, theta["dt"]), (D, rho), gW)
        passes["assembly backward: rd logistic planes wc(c) -> rho"] = lambda: torch.autograd.grad(
            ops.build_rd_wc(c, rho, theta["dt"]), (rho,), gW)
    else:
        plan = sim._get_bell_plan()
        arrays = sim._mesh_arrays()
        nb, s, Kh, d = plan.nb, plan.s, plan.Kh, sim.mesh.dim
        A_c, A_r = f32(nb, d * s, Kh), f32(nb, s, Kh)
        y_c, y_r, x_r = f32(nb, d * s), f32(nb, s), f32(nb, Kh)
        gW = f32(nb, s, Kh)
        passes[f"dA = y_bar x^T, ({nb}, {s}, {Kh})"] = lambda: y_r[:, :, None] * x_r[:, None, :]
        passes[f"dx = sum_m A y_bar, coupling ({nb}, {d * s}, {Kh})"] = lambda: (
            A_c * y_c[:, :, None]).sum(1)
        passes[f"dx = sum_m A y_bar, mass ({nb}, {s}, {Kh})"] = lambda: (
            A_r * y_r[:, :, None]).sum(1)
        passes["assembly backward: rd constant planes -> D, rho"] = lambda: torch.autograd.grad(
            bell.build_bell_rd_const(plan, arrays, D, rho, theta["dt"], sim.kernels._m0),
            (D, rho), gW)
        passes["assembly backward: rd logistic planes wc(c) -> rho"] = lambda: torch.autograd.grad(
            bell.build_bell_rd_wc(plan, arrays, sim.kernels.cells_flat, c, rho,
                                  theta["dt"], sim.kernels._t0, 1.0), (rho,), gW)
    out = {name: _call_device_ms(torch, fn) for name, fn in passes.items()}
    print(f"{tag} plain-torch VJP passes, device ms a call (3 calls): "
          + "; ".join(f"{k} {ms:.4f} ({src})" for k, (ms, src) in out.items()))
    return {k: ms for k, (ms, _) in out.items()}


def _adjoint_lane(torch, sim, ref, lane, groups, tag, problem, fd_dir=None,
                  j_rtol=None, vjp_passes=True, keep=None, f64_calls=None):
    """value_and_grad on one lane (module docstring, [7]) of the inverse
    problem ``problem(sim)`` gives; ``ref`` is the lane's plain f64 model
    at its default tolerances; ``fd_dir`` a direction for a central
    difference of the f64 objective; ``j_rtol`` J's limit where it is not
    the lane's; ``vjp_passes`` whether to time the plain VJP passes;
    ``keep`` (a dict) gains the problem's targets, v0, step config, J and
    gradient and the f64 ones ([13b] holds its sharded call to them);
    ``f64_calls`` (a dict) the f64 value_and_grad calls by (model, steps,
    dt, v0, targets' storage), made once ([9a] holds its refined call to
    [7]'s).
    Every kernel must launch in the backward, and in the forward those a
    forward of the problem's step runs (:func:`_forward_groups`).
    Returns the launches of the instrumented call by wrapper and
    direction, and the lane's numbers."""
    import numpy as np

    from glimslib_tpu_torch.ops import bell_kernels as bk

    dev = sim.device
    lattice = sim.mesh.lattice_strides is not None
    limit = "lattice" if lattice else "unstructured"
    t_lane = time.perf_counter()
    ip, v0 = problem(sim)
    t0 = time.perf_counter()
    J, g = ip.value_and_grad(v0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if not (np.isfinite(J) and np.isfinite(g).all()):
        raise AssertionError(f"{tag} J {J} or gradient {g} not finite")

    # one call with every count at 0, split at the backward's start
    wrappers = [w for grp in groups for w in grp]
    for w in wrappers:
        w.launches = 0
    bk.batched_matvec.launches_by_shape = {}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    vt = ip._param(v0, True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    ev[0].record()
    with torch.enable_grad():
        J_t = ip._objective(vt)
    ev[1].record()
    h1 = time.perf_counter()
    fwd = {w: w.launches for w in wrappers}
    fwd_by_shape = dict(bk.batched_matvec.launches_by_shape)
    (g_t,) = torch.autograd.grad(J_t, vt)
    ev[2].record()
    torch.cuda.synchronize()
    h2 = time.perf_counter()
    bwd = {w: w.launches - fwd[w] for w in wrappers}
    by_shape = dict(bk.batched_matvec.launches_by_shape)
    bwd_by_shape = {s_: c_ - fwd_by_shape.get(s_, 0) for s_, c_ in by_shape.items()
                    if c_ > fwd_by_shape.get(s_, 0)}
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    info = {k: [int(i) for i in v] for k, v in sim.solver_info.items()}
    print(f"{tag} {lane}: first value_and_grad {first_s:.3f} s; J {J:.6e}, "
          f"gradient {g.tolist()}")
    print(f"{tag} {lane}: one call, forward {fwd_ms:.3f} ms / backward {bwd_ms:.3f} "
          f"ms (CUDA events, split at the backward's start; host "
          f"{1e3 * (h1 - h0):.3f} / {1e3 * (h2 - h1):.3f} ms) = backward/forward "
          f"{bwd_ms / fwd_ms:.2f}; adjoint CG iterations rd {info['rd_adj_cg_iters']}, "
          f"elasticity {info['el_adj_cg_iters']} (forward rd {info['rd_cg_iters']}, "
          f"elasticity {info['el_cg_iters']})")
    print(f"{tag} {lane}: launches in that call, forward / backward: " + ", ".join(
        f"{w.__name__}={fwd[w]}/{bwd[w]}" for w in wrappers))
    if not lattice:
        print(f"{tag} {lane}: bell_bmv launches in that call by (B, M, K), forward / "
              "backward: " + ", ".join(
                  f"{s_}: {fwd_by_shape.get(s_, 0)}/{bwd_by_shape.get(s_, 0)}"
                  for s_, _ in sorted(by_shape.items(), key=lambda x: -x[1])))
    fwd_groups = _forward_groups(ip.sim, groups) if lattice else groups
    missing = [[w.__name__ for w in grp] for grp in groups
               if sum(bwd[w] for w in grp) < 1
               or (grp in fwd_groups and sum(fwd[w] for w in grp) < 1)]
    if missing:
        raise AssertionError(f"{tag} {lane}: kernels not launched in both the "
                             f"forward and the backward: {missing}")
    if abs(float(J_t.detach()) - J) > 1e-6 * abs(J) or not torch.isfinite(g_t).all():
        raise AssertionError(f"{tag} {lane}: the instrumented call differs")

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(ADJ_TIMED_CALLS):
        t0 = time.perf_counter()
        ip.value_and_grad(v0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    vgs = 1.0 / (sum(times) / len(times))
    print(f"{tag} {lane}: value_and_grad/s {vgs:.4f} ({ADJ_TIMED_CALLS} call(s): "
          f"{', '.join(f'{t:.4f}' for t in times)} s); peak memory "
          f"{peak / 2**20:.1f} MiB")
    t_prof = time.perf_counter()
    _, busy, idle = _print_breakdown(torch, lambda: ip.value_and_grad(v0),
                                     1e3 * sum(times) / len(times), f"{tag} {lane}:")
    t_vjp = time.perf_counter()
    passes = (_vjp_passes(torch, sim, ip._c0, lattice, f"{tag} {lane}:")
              if vjp_passes else None)

    # the plain f64 path on the card ([3]'s or [6]'s model), the same targets
    t0 = time.perf_counter()
    ip64 = type(ip)(ref, ip.param_names, ip.targets, update_fn=ip.update_fn,
                    n_steps=ip.n_steps, dt=ip.dt)
    key = (id(ref), ip.n_steps, ip.dt, tuple(np.asarray(v0, np.float64).tolist()),
           tuple((k, v.data_ptr()) for k, v in sorted(ip.targets.items())))
    f64_calls = {} if f64_calls is None else f64_calls
    if key not in f64_calls:
        f64_calls[key] = ip64.value_and_grad(v0)
    J64, g64 = f64_calls[key]
    rel_J = abs(J - J64) / abs(J64)
    rel_g = float(np.linalg.norm(g - g64) / np.linalg.norm(g64))
    j_lim = ADJ_J_RTOL[limit] if j_rtol is None else j_rtol
    line = (f"{tag} {lane}: f64 plain reference on the card: J {J64:.6e}, gradient "
            f"{g64.tolist()}; rel err J {rel_J:.3e} (<= {j_lim}), rel-L2 "
            f"gradient {rel_g:.3e} (<= {ADJ_G_RTOL[limit]})")
    rel_fd = None
    if fd_dir is not None:
        d = np.asarray(fd_dir)
        fd = (ip64.objective(v0 + ADJ_FD_EPS * d)
              - ip64.objective(v0 - ADJ_FD_EPS * d)) / (2 * ADJ_FD_EPS)
        rel_fd = abs(fd - float(g64 @ d)) / abs(float(g64 @ d))
        line += (f"; central difference along {fd_dir} (eps {ADJ_FD_EPS}) "
                 f"{fd:.9e} vs gradient {float(g64 @ d):.9e}, rel {rel_fd:.3e} "
                 f"(<= {ADJ_FD_RTOL})")
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    print(line + f" ({t_end - t0:.1f} s)")
    if keep is not None:
        keep.update(targets={k: v.cpu().numpy() for k, v in ip.targets.items()}, v0=v0,
                    vg_config=ip.sim.step_config, J=J, g=g, J64=J64, g64=g64)
    print(f"{tag} {lane}: seconds by stage: problem and calls {t_prof - t_lane:.1f}, "
          f"profiled call {t_vjp - t_prof:.1f}, VJP passes {t0 - t_vjp:.1f}, "
          f"f64 reference {t_end - t0:.1f}")
    if rel_J > j_lim or rel_g > ADJ_G_RTOL[limit] or (
            rel_fd is not None and rel_fd > ADJ_FD_RTOL):
        raise AssertionError(f"{tag} {lane}: against the f64 reference J {rel_J:.3e}, "
                             f"gradient {rel_g:.3e}, central difference {rel_fd}")
    return {"forward": fwd, "backward": bwd}, dict(
        value_and_grad_per_s=vgs, first_s=first_s, forward_ms=fwd_ms,
        backward_ms=bwd_ms, peak_mib=peak / 2**20, device_busy_ms=busy, idle_share=idle,
        refine_f64=ip.sim.step_config.refine_f64,
        adjoint_cg_iters={
            "rd": info["rd_adj_cg_iters"], "el": info["el_adj_cg_iters"]},
        rel_J=rel_J, rel_grad=rel_g, rel_fd=rel_fd, vjp_passes_ms=passes,
        bell_bmv_launches_by_shape={"x".join(map(str, s_)): c_
                                    for s_, c_ in by_shape.items()},
        bell_bmv_launches_by_shape_backward={"x".join(map(str, s_)): c_
                                             for s_, c_ in bwd_by_shape.items()})


def _lattice_groups():
    """The lattice lane's kernels for a value_and_grad, one group a form:
    stencil_apply <1,1> (either wrapper), <d,d> and <d,1>, stencil_pcg<1>
    and stencil_pcg<d>."""
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    return [(sk.apply_scalar, sk.apply_scalar_sum), (sk.apply_vector,),
            (sk.apply_coupling,), (fc.cg_scalar,), (fc.cg_vector,)]


def phase_adjoint(torch, sim, usim, refs, kernels, keep):
    """[7]: value_and_grad on both lanes; every kernel row gains its
    launches in one call, forward and backward."""
    from glimslib_tpu_torch.examples import adjoint_problem
    from glimslib_tpu_torch.ops import bell_kernels as bk

    t0 = time.perf_counter()
    # the problems and the f64 calls, by model: [9a] takes them again
    problems = keep.setdefault("adjoint_problems", {})
    f64_calls = keep.setdefault("f64_calls", {})
    problem = lambda s: problems.setdefault(id(s), adjoint_problem(sim=s))  # noqa: E731
    lat, lat_nums = _adjoint_lane(torch, sim, refs[0], "lattice", _lattice_groups(),
                                  "[7]", problem, ADJ_FD_DIR, f64_calls=f64_calls)
    uns, uns_nums = _adjoint_lane(torch, usim, refs[1], "unstructured",
                                  [(bk.batched_matvec,)], "[7]", problem,
                                  f64_calls=f64_calls)
    for k in kernels:
        if "@" in k["name"]:  # a row of another size
            continue
        counts = uns if k["name"] == "bell_bmv" else lat
        k["adjoint_launches"] = {
            way: sum(counts[way][w] for w in k["wrappers"]) for way in counts}
    print(f"[7] adjoint phase {time.perf_counter() - t0:.1f} s")
    return {"lattice": lat_nums, "unstructured": uns_nums}


def phase_2d(torch, dev):
    """[8]: the 2D models (module docstring).  Returns the kernel rows,
    the two lanes' value_and_grad numbers, and bell_bmv's launches in the
    atlas value_and_grad."""
    from glimslib_tpu_torch.examples import (
        BENCH_STEP_CONFIG, atlas2d_problem, atlas2d_sim, rect_adjoint_problem,
        rect_adjoint_sim, rect_sim,
    )
    from glimslib_tpu_torch.ops import bell_kernels as bk

    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    size = f"@{N2D}x{N2D}"
    t0 = time.perf_counter()
    sim = rect_sim(n=N2D, dtype=f32, device=dev)
    sim._build_step()
    theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    torch.cuda.synchronize()
    print(f"[8] {N2D}x{N2D} rectangle set-up {time.perf_counter() - t0:.1f} s "
          f"({sim.mesh.n_nodes} nodes, {len(sim._stencil_ops.offsets)} offsets)")
    rows = phase_kernels(torch, sim, theta, dev, "[8]", size, grids=(16, 4))
    del theta

    # the two 2D lattice paths, each with its own schedule
    for run, subdomains in (("", False), ("_subdomains", True)):
        s = rect_sim(n=N2D, subdomains=subdomains, dtype=f32, device=dev)
        ref = rect_sim(n=N2D, subdomains=subdomains, dtype=f64, device=dev, plain=True)
        n_steps = int(round(float(s.params.sim_time) / float(s.params.sim_time_step)))
        label = "subdomains" if subdomains else "uniform"
        phase_slice(torch, s, ref, dev, rows, f"[8] {N2D}x{N2D} {label}:", n_steps, run)
        del s, ref

    # the 512 x 512 rectangle: stencil_pcg<2> streamed inside the model
    t0 = time.perf_counter()
    big = rect_sim(n=N2D_BIG, dtype=f32, device=dev)
    big.step_config = BENCH_STEP_CONFIG._replace(cg_maxiter=N2D_BIG_CG_MAXITER)
    torch.cuda.synchronize()
    print(f"[8] {N2D_BIG}x{N2D_BIG} model set-up {time.perf_counter() - t0:.1f} s")
    rows += phase_lattice_big(torch, dev, big, "[8]", f"@{N2D_BIG}x{N2D_BIG}",
                              N2D_BIG_STEPS)
    del big
    torch.cuda.empty_cache()

    # the 2D inverse problems: the rectangle's (lattice) and the reduced
    # atlas's (unstructured lane, bell_bmv)
    lat, lat_nums = _adjoint_lane(
        torch, rect_adjoint_sim(n=N2D, dtype=f32, device=dev),
        rect_adjoint_sim(n=N2D, dtype=f64, device=dev, plain=True), "2D lattice",
        _lattice_groups(), "[8]", lambda s: rect_adjoint_problem(sim=s), ADJ_FD_DIR_2D)
    for k in rows:
        if k["name"].endswith(size):
            k["adjoint_launches"] = {
                way: sum(lat[way][w] for w in k["wrappers"]) for way in lat}
            if not k["launches"]:
                # the 50 x 50 paths refine (the f32 default): their forward
                # measures f64 gather residuals, and stencil_apply runs in
                # the value_and_grad's backward
                k["launches"] = sum(k["adjoint_launches"].values())
                k["launches_in"] = "value_and_grad of rect_adjoint_problem(50)"
    t0 = time.perf_counter()
    asim = atlas2d_sim(dtype=f32, device=dev)
    aref = atlas2d_sim(dtype=f64, device=dev, plain=True)
    asim._build_step()
    aug = asim._augment_theta_with_operators(
        {**asim.make_theta(asim.params.as_dict()), **asim.runtime_aux()})
    torch.cuda.synchronize()
    print(f"[8] 2D atlas: {asim.mesh.n_nodes} nodes, {asim.mesh.n_cells} triangles "
          f"(no lattice: {asim.mesh.lattice_strides is None}); two models and the "
          f"operators {time.perf_counter() - t0:.1f} s")
    bmv = {"shapes": _bmv_shapes(torch, asim, aug, dev, "[8] 2D atlas:")}
    del aug
    uns, uns_nums = _adjoint_lane(torch, asim, aref, "2D atlas", [(bk.batched_matvec,)],
                                  "[8]", lambda s: atlas2d_problem(sim=s))
    bmv.update({way: c[bk.batched_matvec] for way, c in uns.items()})
    by_shape = {tuple(int(x) for x in k.split("x")): c
                for k, c in uns_nums["bell_bmv_launches_by_shape"].items()}
    bmv["by_shape"] = uns_nums["bell_bmv_launches_by_shape"]
    bmv["weighted_bound_share"] = _bmv_split(bmv, by_shape, "[8] 2D atlas:",
                                             what="value_and_grad")
    print(f"[8] 2D phase {time.perf_counter() - t_phase:.1f} s")
    return rows, {"lattice_2d": lat_nums, "atlas_2d": uns_nums}, bmv


# [9]: the reference's defaults on the flagship path.  Refined runs hold
# their final state to REFINED_RTOL of the f64 path (and below the same
# lane's unrefined error) and J to REFINED_J_RTOL on both lanes; the
# factored planes equal the dense ones to FACTORED_RTOL at f32.
REFINED_RTOL = 1e-5
REFINED_J_RTOL = 1e-4
# On the unstructured lane REFINED_STEP_CONFIG's newton_atol (1e-5, an
# absolute residual norm) stops the warm-started Newton one iteration
# after its guess: at n=32 the refined state lands 3.0e-5 from the f64
# one, and 4.5e-7 at this newton_atol (an NVIDIA H100): the tolerance,
# not the residual's precision, sets that floor.  That run is held below
# the unrefined error; a second at this newton_atol is held to
# REFINED_RTOL.
REFINED_NEWTON_ATOL = 1e-7
FACTORED_RTOL = 1e-5


def _refined_problem(sim, problems):
    """[7]'s inverse problem (adjoint_problem, the lane's benchmark step)
    with refine_f64 on, on the same targets ([7]'s own from ``problems``,
    where it ran on ``sim``: its f64 reference then stands for this one's
    too)."""
    from glimslib_tpu_torch.examples import BENCH_STEP_CONFIG, UNSTRUCT_STEP_CONFIG
    from glimslib_tpu_torch.examples import adjoint_problem

    if id(sim) in problems:
        ip0, v0 = problems[id(sim)]
        sim.step_config = (BENCH_STEP_CONFIG if sim.mesh.lattice_strides is not None
                           else UNSTRUCT_STEP_CONFIG)
    else:
        ip0, v0 = adjoint_problem(sim=sim)
    sim.step_config = sim.step_config._replace(refine_f64=True)
    return type(ip0)(sim, ip0.param_names, ip0.targets, update_fn=ip0.update_fn,
                     n_steps=ip0.n_steps, dt=ip0.dt), v0


def phase_refined(torch, dev, lanes, keep=None):
    """[9a]: REFINED_STEP_CONFIG on both lanes, then value_and_grad with
    refine_f64 on.  ``lanes``: (name, model, its f64 plain model, the f64
    final (u, c), the unrefined rel-L2 (c, u), kernel groups).  The
    unstructured lane runs REFINED_STEP_CONFIG a second time with
    newton_atol REFINED_NEWTON_ATOL (REFINED_RTOL's check, module
    constants say why).  ``keep`` (a dict) gains, under "p1", the
    unstructured lane's REFINED_STEP_CONFIG run (its config, final state
    and the f64 one) and its value_and_grad (:func:`_adjoint_lane`), which
    [13] holds the sharded model to, and under "lattice" the lattice lane's
    value_and_grad, which [14c] holds the node-sharded model to, and the
    lattice lane's state after MF_STEPS steps ([15a])."""
    from glimslib_tpu_torch.examples import REFINED_STEP_CONFIG
    from glimslib_tpu_torch.ops import fused_cg as fc

    out = {}
    for lane, sim, ref, (u_r, c_r), (rc0, ru0), groups in lanes:
        runs = [("", REFINED_STEP_CONFIG)]
        if lane == "unstructured":
            runs.append((f", newton_atol {REFINED_NEWTON_ATOL}",
                         REFINED_STEP_CONFIG._replace(newton_atol=REFINED_NEWTON_ATOL)))
        for i, (label, cfg) in enumerate(runs):
            tag = f"[9a] {lane} refined{label}:"
            sim.step_config = cfg
            theta = sim.make_theta(sim.params.as_dict())
            u0, c0 = sim.initial_state()
            simulate = sim.build_simulate_fn(N_STEPS, 1.0)
            shown = [w for g in groups for w in g]
            (u_tr, c_tr), launches, _ = _drive(torch, sim, simulate, (theta, u0, c0),
                                               _forward_groups(sim, groups), tag,
                                               N_STEPS, shown=shown)
            fix = len(sim.solver_info["el_refine_cg_iters"])
            if fix != N_STEPS:
                raise AssertionError(f"{tag} {fix} correction solves in {N_STEPS} steps")
            if fc.cg_vector in launches:
                print(f"{tag} stencil_pcg<3> launches {launches[fc.cg_vector]}: "
                      f"{launches[fc.cg_vector] - fix} elasticity solves and {fix} "
                      "correction solves at refine_cg_rtol "
                      f"{sim.step_config.refine_cg_rtol}")
            run = {}
            if i == 0:
                _, run = _time_runs(torch, simulate, (theta, u0, c0), dev, tag, N_STEPS)
            rel_c, rel_u = _rel_l2(c_tr[-1], c_r), _rel_l2(u_tr[-1], u_r)
            if keep is not None and lane == "unstructured" and i == 0:
                k = SHARD_P1_STEPS - 1
                keep["p1"] = dict(config=cfg, final=(u_tr[-1], c_tr[-1]), ref=(u_r, c_r),
                                  short=(u_tr[k], c_tr[k]))
            if keep is not None and lane == "lattice":
                keep[f"lattice_refined_{MF_STEPS}"] = (u_tr[MF_STEPS - 1],
                                                       c_tr[MF_STEPS - 1])
            if lane == "unstructured" and i == 0:
                lim_c, lim_u, why = rc0, ru0, "the unrefined errors"
            else:
                lim_c, lim_u = min(REFINED_RTOL, rc0), min(REFINED_RTOL, ru0)
                why = f"{REFINED_RTOL} and the unrefined errors"
            print(f"{tag} against the f64 plain path: rel-L2 c {rel_c:.3e} (<= "
                  f"{lim_c:.3e}), u {rel_u:.3e} (<= {lim_u:.3e}): {why} "
                  f"{rc0:.3e}, {ru0:.3e}")
            if rel_c > lim_c or rel_u > lim_u:
                raise AssertionError(f"{tag} c {rel_c:.3e}, u {rel_u:.3e}")
            out[lane + label.replace(", ", "_").replace(" ", "_")] = dict(
                run, launches={w.__name__: n for w, n in launches.items()},
                correction_solves=fix, rel_c=rel_c, rel_u=rel_u, unrefined_rel=(rc0, ru0))
    for lane, sim, ref, _, _, groups in lanes:
        _, nums = _adjoint_lane(torch, sim, ref, f"{lane} refined", groups, "[9a]",
                                lambda s: _refined_problem(s, (keep or {}).get(
                                    "adjoint_problems", {})),
                                j_rtol=REFINED_J_RTOL, f64_calls=(keep or {}).get("f64_calls"),
                                vjp_passes=False,
                                keep=(None if keep is None else keep["p1"] if lane == "unstructured"
                                      else keep.setdefault("lattice", {})))
        out[lane]["value_and_grad"] = nums
        if keep is not None and lane == "unstructured":
            keep["p1"].update(_short_value_and_grad(sim, ref, keep["p1"]))
    return out


def _short_value_and_grad(sim, ref, p1):
    """[13b]'s references at SHARD_P1_STEPS steps: J and the gradient of
    [9a]'s unstructured problem (``p1``: its targets, v0 and config) on
    the unsharded f32 model ``sim`` and on its plain f64 model ``ref``."""
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    names, update = param_map_for_type(2)
    cfg = sim.step_config
    sim.step_config = p1["vg_config"]
    out = {}
    for suffix, s_ in (("", sim), ("64", ref)):
        J, g = InverseProblem(s_, names, p1["targets"], update_fn=update,
                              n_steps=SHARD_P1_STEPS, dt=1.0).value_and_grad(p1["v0"])
        out[f"J{suffix}_short"], out[f"g{suffix}_short"] = J, g
    sim.step_config = cfg
    return out


def phase_factored(torch, dev, usim):
    """[9b]: the factored planes of the n=32 box against the dense ones (the
    same aux without the channel stacks, which assembles the planes from
    the cells), the per-simulate assembly's device time and steps/s both
    ways."""
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG

    usim.step_config = UNSTRUCT_STEP_CONFIG
    aux = usim.runtime_aux()
    dense_aux = {k: v for k, v in aux.items() if not k.startswith("_F")}
    theta = usim.make_theta(usim.params.as_dict())
    u0, c0 = usim.initial_state()
    stack_mb = sum(v.numel() * v.element_size() for k, v in aux.items()
                   if k.startswith("_F") and v.is_floating_point()) / 2**20
    print(f"[9b] factored channel stacks: {', '.join(f'{k} {tuple(v.shape)}' for k, v in aux.items() if k.startswith('_FW') or k == '_FCuc')}; "
          f"{stack_mb:.1f} MiB, built in {usim.setup_seconds.get('factored', 0.0):.2f} s")
    out = {}
    planes = {}
    for way, a in (("factored", aux), ("dense", dense_aux)):
        aug = usim._augment_theta_with_operators({**theta, **a})
        planes[way] = {k: aug[k] for k in ("_BellWel", "_BellCuc", "_BellWrdC", "_BellMrd")}
        del aug
        ms, src = _call_device_ms(
            torch, lambda a=a: usim._augment_theta_with_operators({**theta, **a}))
        call = _host_ms(torch, lambda a=a: usim._augment_theta_with_operators({**theta, **a}))
        simulate = usim.build_simulate_fn(N_STEPS, 1.0)
        out[way] = dict(assembly_device_ms=ms, assembly_call_ms=call)
        print(f"[9b] {way}: per-simulate assembly device {ms:.3f} ms ({src}), call "
              f"{call:.3f} ms (host clock)")
        _, run = _time_runs(torch, simulate, (theta, u0, c0, a), dev, f"[9b] {way}:", N_STEPS)
        out[way].update(run)
    for k in planes["dense"]:
        err, rel = _rel_max(planes["factored"][k], planes["dense"][k])
        print(f"[9b] {k}: factored vs dense max abs {err:.3e}, max rel {rel:.3e} "
              f"(<= {FACTORED_RTOL})")
        out[k] = rel
        if rel > FACTORED_RTOL:
            raise AssertionError(f"[9b] {k} factored vs dense {rel:.3e}")
    return out


def _coarse_in_path(torch, run, aux, pattern):
    """({product: (calls, device ms)} of the coarse term's two matrix
    products in one profiled run(): the aten::mm (bf16) or aten::mv (f32)
    calls whose matrix has a coarse factor's shape or its transpose's,
    with the device time of their kernels; {kernel name: (launches,
    device ms)} of the kernels matching ``pattern`` in the same run; (the
    profile, its wall ms))."""
    from torch.profiler import ProfilerActivity, profile

    shapes = {}
    for key in ("_TLCfac", "_TLCfacS"):
        m, k = aux[key].shape
        shapes[(m, k)] = f"{key} w = B z"
        shapes[(k, m)] = f"{key} z = Bt rc"
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    out = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key in ("aten::mm", "aten::mv") and e.input_shapes:
            name = shapes.get(tuple(e.input_shapes[0]))
            if name is not None:
                c, ms = out.get(name, (0, 0.0))
                out[name] = (c + e.count, ms + e.device_time_total / 1e3)
    kernels = {key: (count, us / 1e3) for key, (count, us) in _device_kernels(prof).items()
               if re.search(pattern, key)}
    return out, kernels, (prof, wall_ms)


# [9c] runs BF16_STEPS steps a way (cut from N_STEPS to fit [15], then
# from 2 to keep the script well inside its limit: its profiled runs
# record CPU events, whose processing takes most of the phase)
BF16_STEPS = 1


def phase_bf16(torch, dev, usim, base6):
    """[9c]: the n=32 box's default bf16 coarse factors against f32 ones
    (the two-level arrays built again in the working dtype, without the
    model's bf16 cast), BF16_STEPS steps a way, the final state against
    [6]'s f64 plain path after as many steps."""
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG
    from glimslib_tpu_torch.ops import bell_kernels as bk

    usim.step_config = UNSTRUCT_STEP_CONFIG
    aux_b = usim.runtime_aux()
    theta = usim.make_theta(usim.params.as_dict())
    t0 = time.perf_counter()
    aux_f = {**aux_b, **usim._twolevel_aux(theta, {})}
    set_s = time.perf_counter() - t0
    print(f"[9c] factors {aux_b['_TLCfac'].dtype} {tuple(aux_b['_TLCfac'].shape)} / "
          f"{tuple(aux_b['_TLCfacS'].shape)} against {aux_f['_TLCfac'].dtype} (built "
          f"again in the working dtype in {set_s:.1f} s)")
    if aux_b["_TLCfac"].dtype != torch.bfloat16 or aux_f["_TLCfac"].dtype != torch.float32:
        raise AssertionError("[9c] the model's factors are not bf16")
    u0, c0 = usim.initial_state()
    u_r, c_r = (x[BF16_STEPS - 1] for x in base6["ref_traj"])
    simulate = usim.build_simulate_fn(BF16_STEPS, 1.0)
    out = {}
    for way, a in (("bf16", aux_b), ("f32", aux_f)):
        tag = f"[9c] {way}:"
        (u_tr, c_tr), _, _ = _drive(torch, usim, simulate, (theta, u0, c0, a),
                                    [(bk.batched_matvec,)], tag, BF16_STEPS)
        it = {k: [int(i) for i in usim.solver_info[k]] for k in ("rd_cg_iters", "el_cg_iters")}
        applies = {"_TLCfac": sum(x + 1 for x in it["el_cg_iters"]),
                   "_TLCfacS": sum(x + 1 for x in it["rd_cg_iters"])}
        # one profiled run for the products, their kernels and the
        # breakdown (cut from three)
        prods, gemv, profiled = _coarse_in_path(
            torch, lambda a=a: simulate(theta, u0, c0, a), a, r"gemv|gemm|nvjet|xmma|cutlass")
        coarse = sum(ms for _, ms in prods.values())
        _, run = _time_runs(torch, simulate, (theta, u0, c0, a), dev, tag, BF16_STEPS,
                            profiled=profiled)
        rel_c, rel_u = _rel_l2(c_tr[-1], c_r), _rel_l2(u_tr[-1], u_r)
        print(f"{tag} CG iterations rd {sum(it['rd_cg_iters'])} (a Newton solve "
              f"{it['rd_cg_iters']}), elasticity {sum(it['el_cg_iters'])} (a step "
              f"{it['el_cg_iters']}); preconditioner applies {applies['_TLCfac']} "
              f"(vector) / {applies['_TLCfacS']} (scalar)")
        print(f"{tag} the coarse products in a profiled run, device ms: {coarse:.3f} ("
              + "; ".join(f"{k} x{c} {ms:.3f} ({1e3 * ms / max(c, 1):.1f} us a call)"
                          for k, (c, ms) in sorted(prods.items()))
              + "); its matrix-product kernels: " + "; ".join(
                  f"{k[:70]} x{c} {ms:.3f}" for k, (c, ms) in gemv.items()))
        print(f"{tag} against the f64 plain path: rel-L2 c {rel_c:.3e}, u {rel_u:.3e} "
              f"(<= {UNSTRUCT_RTOL})")
        if rel_c > UNSTRUCT_RTOL or rel_u > UNSTRUCT_RTOL:
            raise AssertionError(f"{tag} c {rel_c:.3e}, u {rel_u:.3e}")
        out[way] = dict(run, cg_iters=it, coarse_products={k: list(v) for k, v in prods.items()},
                        coarse_ms_a_run=coarse,
                        matrix_product_kernels={k: list(v) for k, v in gemv.items()},
                        rel_c=rel_c, rel_u=rel_u)
    del aux_f
    return out


def phase_defaults(torch, dev, lat, uns, keep=None):
    """[9]: the reference's defaults on the flagship path (module
    docstring).  ``lat`` = ([3]'s model, its f64 plain model, its f64
    final (u, c), its rel-L2 (c, u)); ``uns`` = ([6]'s model, its f64
    plain model, [6]'s baseline); ``keep`` as :func:`phase_refined`."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    t_phase = time.perf_counter()
    sim, ref, lat_state, lat_rel = lat
    usim, uref, base6 = uns
    u_r, c_r = base6["ref_traj"]
    out = {}
    t0 = time.perf_counter()
    out["refined"] = phase_refined(torch, dev, [
        ("lattice", sim, ref, lat_state, lat_rel, _lattice_groups()),
        ("unstructured", usim, uref, (u_r[-1], c_r[-1]), base6["rel"],
         [(bk.batched_matvec,)]),
    ], keep)
    if keep is not None:
        keep["p1"]["ref_short"] = (u_r[SHARD_P1_STEPS - 1], c_r[SHARD_P1_STEPS - 1])
    print(f"[9a] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["factored"] = phase_factored(torch, dev, usim)
    print(f"[9b] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["bf16"] = phase_bf16(torch, dev, usim, base6)
    print(f"[9c] {time.perf_counter() - t0:.1f} s")
    print(f"[9] defaults phase {time.perf_counter() - t_phase:.1f} s")
    return out


# [10]: the quad (P2-concentration) brain model on the n=32 Morton box,
# the benchmark's quad flagship (bench.py run_unstructured(quad=True)).
# Its final state is held to the unstructured limit against the plain f64
# path; where the operating point (rd forcing 1e-3, newton_atol 1e-5)
# leaves more, the run is repeated at QUAD_NEWTON_ATOL and that run is
# held to the limit (as [9a] does).
QUAD_RTOL = UNSTRUCT_RTOL
QUAD_NEWTON_ATOL = 1e-7
# [10b] and [10c] take QUAD_STEPS steps (cut from N_STEPS to keep the
# script well inside its limit); [10d]'s adjoint cell keeps its 5
QUAD_STEPS = 2


def _quad_vs_ref(torch, sim, final, args, ref_traj, tag):
    """rel-L2 (c, u) of a quad run's final state ``final`` (u, c) against
    the f64 plain path's; when above QUAD_RTOL, the same run at
    QUAD_NEWTON_ATOL too."""
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    rel = (_rel_l2(final[1], ref_traj[1]), _rel_l2(final[0], ref_traj[0]))
    print(f"{tag} vs the f64 plain path: rel-L2 c {rel[0]:.3e}, u {rel[1]:.3e} "
          f"(<= {QUAD_RTOL})")
    if max(rel) <= QUAD_RTOL:
        return rel, None
    cfg = sim.step_config
    sim.step_config = StepConfig(**{**cfg._asdict(), "newton_atol": QUAD_NEWTON_ATOL})
    u_t, c_t, ok_t, newton = sim.build_simulate_fn(N_STEPS, 1.0)(*args)
    sim.step_config = cfg
    tight = (_rel_l2(c_t[-1], ref_traj[1]), _rel_l2(u_t[-1], ref_traj[0]))
    print(f"{tag} above the limit: at newton_atol {QUAD_NEWTON_ATOL} (Newton "
          f"{newton.tolist()}) rel-L2 c {tight[0]:.3e}, u {tight[1]:.3e} (<= {QUAD_RTOL})")
    if not bool(ok_t.all()) or max(tight) > QUAD_RTOL:
        raise AssertionError(f"{tag} vs the f64 plain path: {rel}, at newton_atol "
                             f"{QUAD_NEWTON_ATOL} {tight}")
    return rel, tight


def phase_quad(torch, dev, kern, keep=None):
    """[10]: set-up by part, bell_bmv at the P2 shapes ([10a]), the
    forward at the benchmark's unstructured StepConfig ([10b]), the f32
    default refined step ([10c]) and one value_and_grad ([10d]); ``kern``
    (the bell_bmv row) gains the P2 shapes and their launches; ``keep`` (a
    dict) gains, under "quad", [10c]'s config, its state and the f64
    one after SHARD_QUAD_STEPS steps and the tables' bytes ([13b])."""
    from glimslib_tpu_torch.core.mesh import Mesh
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG, adjoint_problem, brain_sim
    from glimslib_tpu_torch.models.base import default_step_config
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.ops.p2 import p2_dof_layout
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    t_phase = time.perf_counter()
    tag = f"[10] quad n={N}:"
    t0 = time.perf_counter()
    sim = brain_sim(n=N, dtype=torch.float32, device=dev, unstructured=True, quad=True)
    model_s = time.perf_counter() - t0
    assert sim.step_config == UNSTRUCT_STEP_CONFIG
    t0 = time.perf_counter()
    p2_dof_layout(Mesh.from_arrays(sim.mesh.points, sim.mesh.cells))
    layout_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    aux = sim.runtime_aux()
    torch.cuda.synchronize()
    aux_s = time.perf_counter() - t0
    aux_peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    u0, c0 = sim.initial_state()
    torch.cuda.synchronize()
    iv_s = time.perf_counter() - t0
    p2, pp, bp = sim.p2, sim._get_p2_plan(), sim._get_bell_plan()
    st = sim.setup_seconds
    slots = pp.nb * pp.s * pp.Kh
    print(f"{tag} {p2.n_dofs} P2 dofs ({sim.mesh.n_nodes} nodes + {p2.n_edges} "
          f"edges), {sim.mesh.n_cells} tets; P2 plan nb={pp.nb}, s={pp.s}, Kh={pp.Kh} "
          f"(Khe={pp.Khe}, flat halo): {slots} slots, {4 * slots / 1e6:.1f} MB a f32 "
          f"plane, placement index {8 * slots / 1e6:.1f} MB; P1 plan nb={bp.nb}, "
          f"s={bp.s}, Kh={bp.Kh}")
    print(f"{tag} set-up seconds: model {model_s:.2f} (of it the P2 dof layout "
          f"{layout_s:.2f}), P2 plan {st['p2_plan']:.2f}, factored P2 cache "
          f"{st['factored_p2']:.2f}, _McSNP2 {st['p2_supernode_jacobi']:.2f}, P1 plan "
          f"{st['bell_plan']:.2f}, P1 supernode Jacobi {st['supernode_jacobi']:.2f}, "
          f"factored P1 {st['factored']:.2f}, coarse level "
          f"{st.get('coarse_build', 0.0) + st.get('coarse_inverse', 0.0):.2f}; frozen "
          f"state {aux_s:.2f} s in all, peak memory {aux_peak / 2**20:.1f} MiB; IV "
          f"projection {iv_s:.2f} s; _FP2Wrd {tuple(aux['_FP2Wrd'].shape)}")
    if (p2.n_dofs, pp.nb, pp.s) != (274625, 4352, 64):
        raise AssertionError(f"{tag} flagship sizes {(p2.n_dofs, pp.nb, pp.s)}")

    # [10a] bell_bmv at the P2 shapes
    theta = sim.make_theta(sim.params.as_dict())
    sim._build_step()
    aug = sim._augment_theta_with_operators({**theta, **aux})
    shapes = _bmv_check(torch, [
        ("P2 rd constant plane _P2BWrdC", aug["_P2BWrdC"]),
        ("P2 supernode Jacobi _McSNP2", aug["_McSNP2"]),
    ], dev, "[10a]")
    if keep is not None:
        keep["quad"] = dict(table_bytes=_table_bytes(aug))
    del aug
    kern["p2_shapes"] = shapes
    p2_keys = [(pp.nb, pp.s, pp.Kh), (pp.nb, pp.s, pp.s)]

    # [10b] the forward at the benchmark's operating point
    simulate = sim.build_simulate_fn(QUAD_STEPS, 1.0)
    args = (theta, u0, c0)
    bk.batched_matvec.launches_by_shape = {}
    (u_tr, c_tr), launches, first_s = _drive(torch, sim, simulate, args,
                                             [(bk.batched_matvec,)], "[10b]", QUAD_STEPS)
    by_shape = dict(bk.batched_matvec.launches_by_shape)
    if any(by_shape.get(k, 0) < 1 for k in p2_keys):
        raise AssertionError(f"[10b] bell_bmv did not launch at the P2 shapes: {by_shape}")
    kern["quad_launches"] = launches[bk.batched_matvec]
    kern["quad_launches_by_shape"] = {"x".join(map(str, k)): c for k, c in by_shape.items()}
    share = _bmv_split({"shapes": kern["shapes"] + shapes}, by_shape, "[10b]")
    iters = {k: [int(i) for i in sim.solver_info[k]] for k in ("rd_cg_iters", "el_cg_iters")}
    _, run = _time_runs(torch, simulate, args, dev, "[10b]", QUAD_STEPS)

    t0 = time.perf_counter()
    ref = brain_sim(n=N, dtype=torch.float64, device=dev, plain=True, unstructured=True,
                    quad=True)
    # the plans are the mesh's; the frozen coarse factors carry over (a
    # preconditioner changes iteration counts only), the supernode
    # inverses and the P2 planes are built in f64
    ref._bell_plan, ref._p2_plan = bp, pp
    ref._aux_cache = {k: v.double() for k, v in aux.items() if k.startswith("_TL")}
    f64_defaults = ref.step_config
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12,
                                 cg_maxiter=4000)
    u_r, c_r, ok_r, newton_r = ref.build_simulate_fn(QUAD_STEPS, 1.0)(
        ref.make_theta(ref.params.as_dict()), *ref.initial_state())
    torch.cuda.synchronize()
    if not bool(ok_r.all()):
        raise AssertionError("[10b] quad f64 plain reference did not converge")
    print(f"[10b] f64 plain reference on the card ({time.perf_counter() - t0:.1f} s, "
          f"Newton {newton_r.tolist()}, rd CG {[int(i) for i in ref.solver_info['rd_cg_iters']]}, "
          f"elasticity CG {[int(i) for i in ref.solver_info['el_cg_iters']]})")
    ref_traj = (u_r[-1], c_r[-1])
    rel, rel_tight = _quad_vs_ref(torch, sim, (u_tr[-1], c_tr[-1]), args, ref_traj,
                                  "[10b]")
    if keep is not None:
        keep["quad18"] = dict(sim=sim, aux=aux, args=args, ref=ref_traj)
    ref.step_config = f64_defaults

    # [10c] the f32 default: refined in f64
    sim.step_config = default_step_config(torch.float32)
    assert sim.step_config.refine_f64
    simulate_r = sim.build_simulate_fn(QUAD_STEPS, 1.0)
    (u_f, c_f), launches_r, _ = _drive(torch, sim, simulate_r, args,
                                       [(bk.batched_matvec,)], "[10c]", QUAD_STEPS)
    n_fix = len(sim.solver_info["el_refine_cg_iters"])
    # [10b]'s run stands for the breakdown (cut from one a run, to fit [15])
    _, run_r = _time_runs(torch, simulate_r, args, dev, "[10c]", QUAD_STEPS, breakdown=False)
    rel_r = (_rel_l2(c_f[-1], c_r[-1]), _rel_l2(u_f[-1], u_r[-1]))
    below = rel_r[0] < rel[0] and rel_r[1] < rel[1]
    print(f"[10c] refined vs the f64 plain path: rel-L2 c {rel_r[0]:.3e}, u "
          f"{rel_r[1]:.3e} ([10b]: {rel[0]:.3e}, {rel[1]:.3e}; below it: {below}); "
          f"correction solves {n_fix} (one a step)")
    if n_fix != QUAD_STEPS:
        raise AssertionError(f"[10c] refined: {n_fix} correction solves")
    rel_rt = None
    if not below:
        # the default's newton_atol (1e-5, absolute) stops Newton before the
        # f64 residual's precision shows; the same run at QUAD_NEWTON_ATOL
        # is held below [10b]'s error and to REFINED_RTOL
        sim.step_config = StepConfig(**{**sim.step_config._asdict(),
                                        "newton_atol": QUAD_NEWTON_ATOL})
        u_t, c_t, ok_t, newton_t = sim.build_simulate_fn(QUAD_STEPS, 1.0)(*args)
        rel_rt = (_rel_l2(c_t[-1], c_r[-1]), _rel_l2(u_t[-1], u_r[-1]))
        print(f"[10c] refined at newton_atol {QUAD_NEWTON_ATOL} (Newton "
              f"{newton_t.tolist()}): rel-L2 c {rel_rt[0]:.3e}, u {rel_rt[1]:.3e} "
              f"(below [10b]'s and <= {REFINED_RTOL})")
        if not (bool(ok_t.all()) and rel_rt[0] < rel[0] and rel_rt[1] < rel[1]
                and max(rel_rt) <= REFINED_RTOL):
            raise AssertionError(f"[10c] refined at newton_atol {QUAD_NEWTON_ATOL}: "
                                 f"{rel_rt} against [10b]'s {rel}")
        del u_t, c_t
    if keep is not None:
        k = SHARD_QUAD_STEPS - 1
        keep["quad"].update(config=default_step_config(torch.float32),
                            final=(u_f[k], c_f[k]), ref=(u_r[k], c_r[k]))
    sim.step_config = UNSTRUCT_STEP_CONFIG
    del u_tr, c_tr, u_f, c_f

    # [10d] one value_and_grad of the benchmark's adjoint cell on the quad model
    counts, nums = _adjoint_lane(torch, sim, ref, "quad unstructured",
                                 [(bk.batched_matvec,)], "[10d]",
                                 lambda s_: adjoint_problem(sim=s_), vjp_passes=False)
    bwd_p2 = {k: nums["bell_bmv_launches_by_shape_backward"].get("x".join(map(str, k)), 0)
              for k in p2_keys}
    if min(bwd_p2.values()) < 1:
        raise AssertionError(f"[10d] bell_bmv did not launch at the P2 shapes in the "
                             f"backward: {bwd_p2}")
    kern["quad_adjoint_launches"] = {way: c[bk.batched_matvec] for way, c in counts.items()}
    kern["quad_adjoint_launches_by_shape"] = {
        "total": nums["bell_bmv_launches_by_shape"],
        "backward": nums["bell_bmv_launches_by_shape_backward"]}
    print(f"[10] quad phase {time.perf_counter() - t_phase:.1f} s")
    return dict(
        p2_dofs=p2.n_dofs, plan=dict(nb=pp.nb, s=pp.s, Kh=pp.Kh, slots=slots),
        setup_s=dict(model=model_s, p2_layout=layout_s, iv_projection=iv_s, **st),
        frozen_state_peak_mib=(aux_peak - held) / 2**20,
        forward=dict(first_s=first_s, rel_c=rel[0], rel_u=rel[1],
                     rel_tight=rel_tight, weighted_bound_share=share, **iters, **run),
        refined=dict(rel_c=rel_r[0], rel_u=rel_r[1], rel_tight=rel_rt, **run_r),
        adjoint=nums)


def _wf_wrappers():
    """Every kernel wrapper a workflow stage may launch."""
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    return [sk.apply_scalar, sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling,
            fc.cg_scalar, fc.cg_vector, bk.batched_matvec]


def _wf_stage(torch, run, name, fn):
    """One workflow stage with every launch count at 0 just before it:
    its seconds, launches by wrapper (bell_bmv's also by shape) and host
    seconds of file output go into ``run``."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    wrappers = _wf_wrappers()
    for w in wrappers:
        w.launches = 0
    bk.batched_matvec.launches_by_shape = {}
    files0 = WF_FILE_S[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    run["seconds"][name] = time.perf_counter() - t0
    run["launches"][name] = {w.__name__: w.launches for w in wrappers}
    run.setdefault("bmv_by_shape", {})[name] = dict(bk.batched_matvec.launches_by_shape)
    run.setdefault("file_output_s", {})[name] = WF_FILE_S[0] - files0
    return out


# host seconds in Results' file output (per-step VTU or XDMF, the PVD
# series, the series store), summed while phase_workflow runs
WF_FILE_S = [0.0]


def _wf_timed_file_output():
    """Wrap Results' writers to sum their seconds into WF_FILE_S; returns
    the originals, to put back."""
    from glimslib_tpu_torch.core.results import Results

    originals = {}
    for name in ("save_solution", "save_solution_end", "save_solution_hdf5"):
        fn = originals[name] = getattr(Results, name)

        def timed(self, *args, _fn=fn, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(self, *args, **kwargs)
            finally:
                WF_FILE_S[0] += time.perf_counter() - t0

        setattr(Results, name, timed)
    return originals


def _wf_cap(sim):
    """WF_CG_MAXITER on a workflow simulation's step; returns it."""
    sim.step_config = sim.step_config._replace(cg_maxiter=WF_CG_MAXITER)
    return sim


def _wf_converged(tag, sim):
    """Every step of a recorded run converged (run() stops recording at
    the first that did not)."""
    n = int(round(float(sim.params.sim_time) / float(sim.params.sim_time_step)))
    if len(sim.results.get_recording_steps()) != n + 1:
        raise AssertionError(f"{tag} a step did not converge: recorded "
                             f"{sim.results.get_recording_steps()} of {n} steps")


def _wf_seed(mesh, labels):
    """The WM node (label 3) nearest the domain's centre."""
    import numpy as np

    wm = np.flatnonzero(np.asarray(labels) == 3)
    centre = 0.5 * (mesh.points.min(axis=0) + mesh.points.max(axis=0))
    return [float(x) for x in mesh.points[wm[np.argmin(
        np.linalg.norm(mesh.points[wm] - centre, axis=1))]]]


def _wf_ref(torch, wf, sim, dev):
    """The plain f64 model of ``sim`` (a workflow simulation) on the card,
    at the f64 default tolerances: what the f32 path is held against.  A
    quad model's shares its plans (cached on the mesh), takes its frozen
    coarse factors (a preconditioner changes iteration counts only) and
    builds its supernode inverses in f64, as [10b]'s does."""
    import numpy as np

    from glimslib_tpu_torch.models.tumor_growth_brain import TumorGrowthBrain
    from glimslib_tpu_torch.models.tumor_growth_brain_quad import (
        TumorGrowthBrain as BrainQuad,
    )
    from glimslib_tpu_torch.workflow.image_based_optimization import (
        TISSUE_MAP, BoundaryAll,
    )

    model = BrainQuad if sim.quad else TumorGrowthBrain
    ref = model(sim.mesh, dtype=torch.float64, device=dev, plain=True)
    ref.setup_global_parameters(
        label_function=wf.labelfunction, domain_names=TISSUE_MAP,
        boundaries={"boundary_all": BoundaryAll()},
        dirichlet_bcs={"clamped_boundary": {"bc_value": np.zeros(wf.mesh.dim),
                                            "named_boundary": "boundary_all",
                                            "subspace_id": 0}})
    ref.setup_model_parameters(iv_expression=sim.params._iv_expressions,
                               **sim.params.as_dict())
    if sim.quad:
        ref._aux_cache = {k: v.double() for k, v in sim.runtime_aux().items()
                          if k.startswith("_TL")}
    return _wf_cap(ref)


def _wf_check_forward(torch, wf, dev, tag, out):
    """The forward's c and u after min(its steps, WF_F64_STEPS) steps (the
    recorded step) against the plain f64 path, rel-L2 <= SLICE_RTOL (a
    quad model: QUAD_RTOL)."""
    t0 = time.perf_counter()
    sim = wf.sims["forward"]
    rtol = QUAD_RTOL if sim.quad else SLICE_RTOL
    ref = _wf_ref(torch, wf, sim, dev)
    u0, c0 = ref.initial_state()
    n = int(round(float(ref.params.sim_time) / float(ref.params.sim_time_step)))
    k = min(n, WF_F64_STEPS)
    if k == n:
        got = sim.solution
    else:
        steps = sim.results.get_recording_steps()
        if len(steps) != n + 1:
            raise AssertionError(f"{tag} {len(steps)} recorded steps of {n + 1}")
        got = sim.results.get_result(steps[k])
    u_r, c_r, ok, _ = ref.build_simulate_fn(k, float(ref.params.sim_time_step))(
        ref.make_theta(ref.params.as_dict()), u0, c0)
    if not bool(ok.all()):
        raise AssertionError(f"{tag} the f64 plain forward did not converge")
    rel_c = _rel_l2(torch.as_tensor(got[1]), c_r[-1].cpu())
    rel_u = _rel_l2(torch.as_tensor(got[0]), u_r[-1].cpu())
    print(f"{tag} forward after {k} of {n} steps vs the f64 plain path on the card "
          f"({time.perf_counter() - t0:.1f} s): rel-L2 c {rel_c:.3e}, u {rel_u:.3e} "
          f"(<= {rtol})")
    if rel_c > rtol or rel_u > rtol:
        raise AssertionError(f"{tag} forward vs f64: c {rel_c:.3e}, u {rel_u:.3e}")
    out.update(forward_rel_c=rel_c, forward_rel_u=rel_u, forward_checked_step=k)


def _wf_check_gradient(torch, wf, dev, tag, out):
    """J and the gradient at v0 of the workflow's inverse problem against
    the same problem on the plain f64 path: rel <= ADJ_J_RTOL and rel-L2 <=
    ADJ_G_RTOL (the lattice's; a quad model's: the unstructured ones)."""
    import numpy as np

    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    v0 = np.full(2, WF_V0)
    lane = "unstructured" if wf.sims["inverse"].quad else "lattice"
    ip = wf.inverse_problem()
    t0 = time.perf_counter()
    J, g = ip.value_and_grad(v0)
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    names, update = param_map_for_type(2)
    ref = _wf_ref(torch, wf, wf.sims["inverse"], dev)
    t0 = time.perf_counter()
    J_r, g_r = InverseProblem(ref, names, wf._load_target_fields(),
                              update_fn=update).value_and_grad(v0)
    rel_J = abs(J - J_r) / abs(J_r)
    rel_g = float(np.linalg.norm(g - g_r) / np.linalg.norm(g_r))
    print(f"{tag} value_and_grad at v0 = {v0.tolist()}: J {J:.8e} (f64 plain "
          f"{J_r:.8e}, rel {rel_J:.3e} <= {ADJ_J_RTOL[lane]}), gradient "
          f"{g.tolist()} (f64 {g_r.tolist()}, rel-L2 {rel_g:.3e} <= "
          f"{ADJ_G_RTOL[lane]}); f32 call {vg_s:.3f} s, the f64 plain one "
          f"{time.perf_counter() - t0:.1f} s")
    if rel_J > ADJ_J_RTOL[lane] or rel_g > ADJ_G_RTOL[lane]:
        raise AssertionError(f"{tag} J {rel_J:.3e}, gradient {rel_g:.3e} vs f64")
    out.update(J_v0=J, J_v0_rel=rel_J, grad_v0_rel=rel_g)


def _wf_inverse(torch, wf, run, tag, maxiter, truth=True):
    """The inverse stage under the profiler (device activity only): its
    seconds and launches, device busy ms and idle share of it, the
    value_and_grad calls and calls/s, and L-BFGS-B's outcome (with the
    relative errors against WF_TRUTH where the targets come from it).
    Busy is the sum of the raw device events' durations: parsing the
    events of a window of millions of launches into ``key_averages`` took
    minutes (the quad inverse, 3.7 million)."""
    prof = {}

    def inverse():
        prof["p"] = _profile(torch, lambda: wf.run_inverse_problem(
            opt_params=dict(WF_OPT, maxiter=maxiter)), cpu=False)

    _wf_stage(torch, run, "inverse", inverse)
    busy = _device_busy_ms(prof["p"])
    sec = run["seconds"]["inverse"]
    res, cols = wf.optimization_result, wf.optimization_progress
    calls = len(cols["J"])
    out = dict(device_busy_ms=busy, idle_share=max(0.0, 1 - busy / (1e3 * sec)),
               value_and_grad_calls=calls, calls_per_s=calls / sec, nit=int(res.nit),
               message=str(res.message), J_start=float(cols["J"][0]),
               J_end=float(res.fun), params=dict(wf.model_params_optimized))
    errors = ""
    if truth:
        out["rel_errors"] = {k: abs(v - WF_TRUTH) / WF_TRUTH
                             for k, v in out["params"].items()}
        errors = f" (truth {WF_TRUTH}), rel errors " + ", ".join(
            f"{k} {v:.3e}" for k, v in out["rel_errors"].items())
    print(f"{tag} inverse (profiled, device activity): {sec:.2f} s, device busy "
          f"{busy:.1f} ms, idle {100 * out['idle_share']:.1f}%; {calls} value_and_grad "
          f"calls, {out['calls_per_s']:.3f} /s; L-BFGS-B nit {out['nit']}, "
          f"'{out['message']}', J {out['J_start']:.6e} -> {out['J_end']:.6e}; "
          f"recovered {out['params']}{errors}")
    return out


def _wf_print_stages(tag, run):
    print(f"{tag} seconds by stage: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run["seconds"].items()))
    for stage, counts in run["launches"].items():
        print(f"{tag} launches in {stage}: " + ", ".join(
            f"{k}={n}" for k, n in counts.items()))
    for stage, by_shape in run.get("bmv_by_shape", {}).items():
        if by_shape:
            print(f"{tag} bell_bmv launches in {stage} by (B, M, K): " + ", ".join(
                f"{k}: {n}" for k, n in sorted(by_shape.items(), key=lambda x: -x[1])))


def _wf_demand_launches(tag, run, stages, quad=False):
    """Stencil kernels launch in each of ``stages`` and bell_bmv does not;
    under refine_f64 a forward runs only the solves (its residuals are the
    f64 gather ones).  ``quad``: bell_bmv launches in each and no stencil
    kernel does (the quad model runs the unstructured lane)."""
    for stage in stages:
        n = sum(v for k, v in run["launches"][stage].items() if k != "batched_matvec")
        bmv = run["launches"][stage]["batched_matvec"]
        if quad and (bmv < 1 or n):
            raise AssertionError(f"{tag} {stage}: bell_bmv {bmv} launches, stencil "
                                 f"kernels {n} on a quad workflow")
        if not quad and n < 1:
            raise AssertionError(f"{tag} no stencil kernel launched in {stage}")
        if not quad and bmv:
            raise AssertionError(f"{tag} bell_bmv launched on a lattice workflow")


def _wf_atlas(torch, dev, tmp, tag, key, shape, z=None, model="linear"):
    """One atlas pipeline (module docstring, [11a] / [11b]; ``model="quad"``
    [11d]); returns its numbers and the workflow."""
    import numpy as np

    from glimslib_tpu_torch.examples import BRAIN_PARAMS_FIXED, BRAIN_PARAMS_VARYING
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.utils.image_io import Image, write_mha
    from glimslib_tpu_torch.utils.synthetic import brain_labelmap_3d
    from glimslib_tpu_torch.workflow.image_based_optimization_atlas import (
        ImageBasedOptimizationAtlas,
    )

    t_all = time.perf_counter()
    path = os.path.join(tmp, f"{key}_atlas.mha")
    write_mha(path, Image(brain_labelmap_3d(*shape), origin=(0, 0, 0), spacing=(1, 1, 1)))
    base = os.path.join(tmp, f"{key}_wf")
    wf = ImageBasedOptimizationAtlas(base, path_to_labels_atlas=path, image_z_slice=z,
                                     model=model, device=dev)
    run = {"seconds": {}, "launches": {}}
    _wf_stage(torch, run, "domain", wf.prepare_domain)
    mesh = wf.mesh
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    seed = _wf_seed(mesh, wf.labelfunction)
    sim_params = WF_SIM[key]
    _wf_stage(torch, run, "forward", lambda: (
        _wf_cap(wf.init_forward_problem(seed, BRAIN_PARAMS_VARYING, BRAIN_PARAMS_FIXED,
                                        sim_params)),
        wf.run_forward_sim(save_method="vtk")))
    sim = wf.sims["forward"]
    _wf_converged(tag, sim)
    out = {"nodes": mesh.n_nodes, "cells": mesh.n_cells,
           "forward_final_max_conc": wf.measures["forward_final_max_conc"]}
    masked = int(sim._unused_node_mask().sum())
    if model == "quad":
        out.update(_wf_quad_forward(tag, sim, seed))
        out["bmv_shapes"] = _wf_quad_shapes(torch, sim, dev, "[11d]")
    else:
        n_off = len(sim._stencil_ops.offsets)
        plan = fc.launch_plan(mesh.n_nodes, mesh.dim, n_off, sms)
        print(f"{tag} {mesh.n_nodes} nodes ({masked} untouched by any cell, masked), "
              f"{mesh.n_cells} cells, {n_off} offsets, seed {seed}; "
              f"stencil_pcg<{mesh.dim}> launch plan: {plan.mode} ({plan.blocks} blocks)")
        out["pcg_mode"] = plan.mode
    _wf_stage(torch, run, "targets", wf.create_target_fields)
    start = dict(BRAIN_PARAMS_VARYING, D_WM=WF_V0, rho_WM=WF_V0)
    _wf_cap(wf.init_inverse_problem(seed, start, sim_params, optimization_type=2))
    out.update(_wf_inverse(torch, wf, run, tag, WF_MAXITER[key]))
    _wf_stage(torch, run, "optimized", lambda: (
        _wf_cap(wf.init_optimized_problem()), wf.run_optimized_sim(save_method="vtk")))
    _wf_converged(tag, wf.sims["optimized"])
    comp = _wf_stage(torch, run, "compare", wf.compare_original_optimized)
    frames = _wf_stage(torch, run, "post_process", wf.post_process)
    _wf_stage(torch, run, "summary", wf.write_analysis_summary)

    def reload():
        wf2 = ImageBasedOptimizationAtlas(base, device=dev)
        wf2.reload_state()
        return wf2.reload_forward_sim()

    sim2 = _wf_stage(torch, run, "reload", reload)
    if sim2.quad != sim.quad:
        raise AssertionError(f"{tag} the reloaded state rebuilt another model")
    res, res2 = sim.results, sim2.results
    if res2.get_recording_steps() != res.get_recording_steps() or not all(
            np.array_equal(res2.get_result(s)[i], res.get_result(s)[i])
            for s in res.get_recording_steps() for i in (0, 1)):
        raise AssertionError(f"{tag} the reloaded series differs from the recorded one")

    out["file_output_s"] = run["file_output_s"]
    out["post_process_s"] = run["seconds"]["post_process"]

    t2 = frames["volume"]
    T2 = wf.conc_threshold_levels["T2"]
    vols = {k: t2[f"{k}_volume_{T2}_all"][-1] for k in ("forward", "optimized")}
    fe = comp["field_errors"]
    out.update(
        T2_volumes=vols, comparison={k: [float(x) for x in v] for k, v in fe.items()},
        param_relative_errors=wf.measures["param_relative_errors"])
    print(f"{tag} T2 volume at the last step: forward {vols['forward']:.4f}, optimized "
          f"{vols['optimized']:.4f}; final errornorms c "
          f"{wf.measures['final_errornorm_concentration']:.4e}, u "
          f"{wf.measures['final_errornorm_displacement']:.4e}; host s: file output "
          f"(VTUs, PVD, series store) in forward {out['file_output_s']['forward']:.3f}, "
          f"in optimized {out['file_output_s']['optimized']:.3f}; post_process "
          f"{out['post_process_s']:.3f}; reloaded series equal")
    if not all(np.isfinite(v) and v > 0 for v in vols.values()):
        raise AssertionError(f"{tag} T2 volumes {vols}")
    if not out["J_end"] < out["J_start"]:
        raise AssertionError(f"{tag} J did not fall: {out['J_start']} -> {out['J_end']}")
    # (D_WM, rho_WM) as a point: nearer the truth than v0
    dist = float(np.hypot(*(v - WF_TRUTH for v in out["params"].values())))
    out["distance_to_truth"] = dist
    if not dist < np.hypot(WF_V0 - WF_TRUTH, WF_V0 - WF_TRUTH):
        raise AssertionError(f"{tag} no closer to the truth than v0: {out['params']}")
    _wf_print_stages(tag, run)
    _wf_demand_launches(tag, run, ("forward", "inverse", "optimized"), model == "quad")
    out.update(seconds=run["seconds"], launches=run["launches"],
               bmv_by_shape=run["bmv_by_shape"], total_s=time.perf_counter() - t_all)
    return out, wf


def _wf_quad_forward(tag, sim, seed):
    """[11d], [11e]: a quad forward's plans, its set-up by part and its CG
    iterations (the model has run)."""
    bp, pp = sim._get_bell_plan(), sim._get_p2_plan()
    info = sim.solver_info
    iters = {k: [int(i) for i in info[k]]
             for k in ("el_cg_iters", "rd_cg_iters", "el_refine_cg_iters")}
    print(f"{tag} {sim.mesh.n_nodes} nodes ({int(sim._unused_node_mask().sum())} "
          f"untouched by any cell, masked with their P2 vertex dofs), "
          f"{sim.mesh.n_cells} cells, {sim.p2.n_dofs} P2 dofs, seed {seed}; P1 plan "
          f"nb={bp.nb}, s={bp.s}, Kh={bp.Kh}; P2 plan nb={pp.nb}, s={pp.s}, Kh={pp.Kh}")
    print(f"{tag} forward: Newton {sim.solver_info['newton_iters'].tolist()}, "
          f"elasticity CG a step {iters['el_cg_iters']}, rd CG a Newton solve "
          f"{iters['rd_cg_iters']}, correction solves {iters['el_refine_cg_iters']}")
    return dict(p2_dofs=sim.p2.n_dofs, p1_plan=[bp.nb, bp.s, bp.Kh],
                p2_plan=[pp.nb, pp.s, pp.Kh], forward_cg_iters=iters)


def _wf_quad_shapes(torch, sim, dev, tag):
    """[11d], [11e]: bell_bmv against its plain version and timed as in
    [5] at the four tables of the quad model's path (checked before an
    inverse, whose profile of millions of launches leaves the profiler
    dropping the records of later windows)."""
    bp = sim._get_bell_plan()
    theta = sim.make_theta(sim.params.as_dict())
    aug = sim._augment_theta_with_operators({**theta, **sim.runtime_aux()})
    d = sim.mesh.dim
    return _bmv_check(torch, [
        ("elasticity operator _BellWel", aug["_BellWel"].reshape(bp.nb, bp.s * d,
                                                                 bp.Kh * d)),
        ("elasticity supernode Jacobi _BinvSN", aug["_BinvSN"]),
        ("P2 rd constant plane _P2BWrdC", aug["_P2BWrdC"]),
        ("P2 supernode Jacobi _McSNP2", aug["_McSNP2"]),
    ], dev, tag)


def _wf_bmv_launches(tag, run, shapes, stages):
    """bell_bmv's launches in ``stages`` of a quad pipeline by (B, M, K);
    each shape of ``shapes`` (the checked tables) launched at least once."""
    by_shape = {}
    for stage in stages:
        for k, n in run["bmv_by_shape"][stage].items():
            by_shape[k] = by_shape.get(k, 0) + n
    if any(by_shape.get(tuple(r["shape"]), 0) < 1 for r in shapes):
        raise AssertionError(f"{tag} bell_bmv did not launch at every checked shape: "
                             f"{by_shape}")
    return by_shape


def _wf_setup_parts(tag, wf):
    """Set-up seconds by part of each quad sim's frozen state."""
    parts = {}
    for name, sim in wf.sims.items():
        st = getattr(sim, "setup_seconds", None)
        if not st:
            continue
        parts[name] = dict(st)
        print(f"{tag} set-up of the {name} sim: P1 plan {st['bell_plan']:.2f} s, P2 "
              f"plan {st['p2_plan']:.2f} s, coarse build {st.get('coarse_build', 0):.2f} "
              f"s, coarse eigh {st.get('coarse_inverse', 0):.2f} s; "
              + ", ".join(f"{k} {v:.2f} s" for k, v in st.items() if k not in (
                  "bell_plan", "p2_plan", "coarse_build", "coarse_inverse")))
    return parts


def _wf_atlas_quad(torch, dev, tmp, kern):
    """[11d]: the atlas pipeline with model="quad" on [11a]'s slice; the
    bell_bmv row ``kern`` gains the slice's shapes and their launches."""
    nx, ny, nz, z = WF_2D
    tag = f"[11d] quad atlas {nx}x{ny}:"
    out, wf = _wf_atlas(torch, dev, tmp, tag, "quad", (nx, ny, nz), z, model="quad")
    _wf_check_forward(torch, wf, dev, tag, out)
    # after the pipeline, as the forward's check: the inverse stage's time
    # then holds the inverse sim's set-up, as [11a]'s does
    _wf_check_gradient(torch, wf, dev, tag, out)
    errs = out["rel_errors"]
    out["within_param_rtol"] = max(errs.values()) <= WF_PARAM_RTOL
    print(f"{tag} recovered parameters within {WF_PARAM_RTOL} of the truth: "
          f"{out['within_param_rtol']} ({errs})")
    out["setup_s"] = _wf_setup_parts(tag, wf)
    shapes = out.pop("bmv_shapes")
    by_shape = _wf_bmv_launches(tag, out, shapes, ("forward", "inverse", "optimized"))
    out["weighted_bound_share"] = _bmv_split(
        {"shapes": shapes}, by_shape, "[11d]", what="forward + inverse + optimized")
    kern["workflow_quad_shapes"] = shapes
    kern["workflow_quad_launches"] = sum(by_shape.values())
    kern["workflow_quad_launches_by_shape"] = {"x".join(map(str, k)): n
                                               for k, n in by_shape.items()}
    out["bmv_by_shape"] = {st: {"x".join(map(str, k)): n for k, n in c.items()}
                           for st, c in out["bmv_by_shape"].items()}
    return out


def _wf_quad_lattice(torch, dev, tmp, kern):
    """[11e]: the quad model on a labelmap's full lattice (cell-free P2
    vertex dofs on the card): a forward and one value_and_grad; the
    bell_bmv row ``kern`` gains the lattice's shapes and their launches."""
    import numpy as np

    from glimslib_tpu_torch.examples import BRAIN_PARAMS_FIXED, BRAIN_PARAMS_VARYING
    from glimslib_tpu_torch.utils.image_io import Image, write_mha
    from glimslib_tpu_torch.utils.synthetic import brain_labelmap_3d
    from glimslib_tpu_torch.workflow.image_based_optimization_atlas import (
        ImageBasedOptimizationAtlas,
    )

    t_all = time.perf_counter()
    tag = f"[11e] quad {WF_QUAD_3D[0]}^3 full lattice:"
    path = os.path.join(tmp, "quad3d_atlas.mha")
    write_mha(path, Image(brain_labelmap_3d(*WF_QUAD_3D), origin=(0, 0, 0),
                          spacing=(1, 1, 1)))
    wf = ImageBasedOptimizationAtlas(os.path.join(tmp, "quad3d_wf"),
                                     path_to_labels_atlas=path, model="quad", device=dev)
    run = {"seconds": {}, "launches": {}}
    _wf_stage(torch, run, "domain", wf.prepare_domain)
    seed = _wf_seed(wf.mesh, wf.labelfunction)
    _wf_stage(torch, run, "forward", lambda: (
        _wf_cap(wf.init_forward_problem(seed, BRAIN_PARAMS_VARYING, BRAIN_PARAMS_FIXED,
                                        WF_SIM["3d"])),
        wf.run_forward_sim(save_method=None)))
    sim = wf.sims["forward"]
    _wf_converged(tag, sim)
    out = _wf_quad_forward(tag, sim, seed)
    unused = sim._unused_node_mask()
    c, u = np.asarray(sim.solution[1]), np.asarray(sim.solution[0])
    free = c[sim.p2.vertex_dof_ids(np.flatnonzero(unused))]
    out.update(nodes=sim.mesh.n_nodes, masked_nodes=int(unused.sum()),
               max_abs_c_cell_free=float(np.abs(free).max()),
               max_abs_u_cell_free=float(np.abs(u[unused]).max()))
    print(f"{tag} final c finite {bool(np.isfinite(c).all())}, u finite "
          f"{bool(np.isfinite(u).all())}, max c {c.max():.6f}; at the {int(unused.sum())} "
          f"cell-free nodes max |c| {out['max_abs_c_cell_free']}, max |u| "
          f"{out['max_abs_u_cell_free']} (exactly 0 demanded)")
    if not (np.isfinite(c).all() and np.isfinite(u).all()) or free.any() or u[unused].any():
        raise AssertionError(f"{tag} non-finite state or cell-free dofs off 0")
    _wf_check_forward(torch, wf, dev, tag, out)
    shapes = _wf_quad_shapes(torch, sim, dev, "[11e]")
    _wf_stage(torch, run, "targets", wf.create_target_fields)
    start = dict(BRAIN_PARAMS_VARYING, D_WM=WF_V0, rho_WM=WF_V0)
    _wf_cap(wf.init_inverse_problem(seed, start, WF_SIM["3d"], optimization_type=2))
    _wf_stage(torch, run, "value_and_grad",
              lambda: _wf_check_gradient(torch, wf, dev, tag, out))
    out["setup_s"] = _wf_setup_parts(tag, wf)
    _wf_print_stages(tag, run)
    _wf_demand_launches(tag, run, ("forward", "value_and_grad"), quad=True)
    by_shape = _wf_bmv_launches(tag, run, shapes, ("forward", "value_and_grad"))
    out["weighted_bound_share"] = _bmv_split(
        {"shapes": shapes}, by_shape, "[11e]", what="forward + value_and_grad")
    kern["workflow_quad_lattice_shapes"] = shapes
    kern["workflow_quad_lattice_launches"] = sum(by_shape.values())
    kern["workflow_quad_lattice_launches_by_shape"] = {"x".join(map(str, k)): n
                                                       for k, n in by_shape.items()}
    out.update(seconds=run["seconds"], launches=run["launches"],
               total_s=time.perf_counter() - t_all)
    return out


def _wf_patient(torch, dev, tmp, tag):
    """[11c]: the patient pipeline up to the inverse."""
    import numpy as np

    from glimslib_tpu_torch.examples import BRAIN_PARAMS_FIXED, BRAIN_PARAMS_VARYING
    from glimslib_tpu_torch.utils.image_io import Image, write_mha
    from glimslib_tpu_torch.utils.synthetic import brain_labelmap_3d, t1_from_labels
    from glimslib_tpu_torch.workflow.image_based_optimization_patient import (
        ImageBasedOptimizationPatient,
    )

    t_all = time.perf_counter()
    nx, ny, nz, z = WF_PATIENT
    lab = brain_labelmap_3d(nx, ny, nz)
    t1 = t1_from_labels(lab)
    # a tumour segmentation: a T2 box around the slice's centre, a T1 core
    # (tests/test_workflow_patient.py:17-34, scaled to the image)
    seg = np.zeros_like(lab)
    cy, cx, h = ny // 2, nx // 2, nx // 10
    seg[z - 2:z + 2, cy - h:cy + h, cx - h:cx + h] = 6
    seg[z - 1:z + 1, cy - h // 3:cy + h // 3, cx - h // 3:cx + h // 3] = 5
    paths = {}
    for name, arr in [("atlas_labels", lab), ("atlas_t1", t1), ("patient_t1", t1),
                      ("patient_seg", seg)]:
        paths[name] = os.path.join(tmp, f"patient_{name}.mha")
        write_mha(paths[name], Image(np.ascontiguousarray(arr), origin=(0, 0, 0),
                                     spacing=(1, 1, 1)))
    wf = ImageBasedOptimizationPatient(
        os.path.join(tmp, "patient_wf"), path_to_labels_atlas=paths["atlas_labels"],
        path_to_image_atlas=paths["atlas_t1"], path_to_image_patient=paths["patient_t1"],
        path_to_labels_patient=paths["patient_seg"], image_z_slice=z, device=dev)
    run = {"seconds": {}, "launches": {}}
    _wf_stage(torch, run, "domain", lambda: wf.prepare_domain(use_registration=True))
    cT2, cT1 = _wf_stage(torch, run, "targets", wf.create_target_fields)
    seed = [float(x) for x in wf.mesh.points[int(np.argmax(cT1))]]
    start = dict(BRAIN_PARAMS_VARYING, D_WM=WF_V0, rho_WM=WF_V0)
    _wf_cap(wf.init_inverse_problem(seed, start, WF_SIM["patient"],
                                    model_params_fixed=BRAIN_PARAMS_FIXED,
                                    optimization_type=2))
    out = {"nodes": wf.mesh.n_nodes, "T2_target_sum": float(cT2.sum()),
           "T1_target_sum": float(cT1.sum())}
    print(f"{tag} {wf.mesh.n_nodes} nodes; targets from the segmentation: sum T2 "
          f"{cT2.sum():.2f}, T1 {cT1.sum():.2f}; seed {seed}")
    _wf_check_gradient(torch, wf, dev, tag, out)
    out.update(_wf_inverse(torch, wf, run, tag, WF_MAXITER["patient"], truth=False))
    if not out["J_end"] <= out["J_start"]:
        raise AssertionError(f"{tag} J rose: {out['J_start']} -> {out['J_end']}")
    _wf_print_stages(tag, run)
    _wf_demand_launches(tag, run, ("inverse",))
    out.update(seconds=run["seconds"], launches=run["launches"],
               total_s=time.perf_counter() - t_all)
    return out


def phase_workflow(torch, dev, kernels):
    """[11]: the workflow (module docstring).  Adds the 256 x 256 kernel
    rows to ``kernels`` and every pipeline's launches to the stencil rows;
    returns the pipelines' numbers."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="glims_workflow_")
    writers = _wf_timed_file_output()
    try:
        out = {}
        nx, ny, nz, z = WF_2D
        tag = f"[11a] atlas {nx}x{ny}:"
        out["atlas_2d"], wf = _wf_atlas(torch, dev, tmp, tag, "2d", (nx, ny, nz), z)
        _wf_check_forward(torch, wf, dev, tag, out["atlas_2d"])
        print(f"{tag} L-BFGS-B's reach: each parameter within {WF_PARAM_RTOL} of the "
              f"truth ({WF_PARAM_RTOL_WHY})")
        errs = out["atlas_2d"]["rel_errors"]
        if max(errs.values()) > WF_PARAM_RTOL:
            raise AssertionError(f"{tag} recovered parameters off by {errs}")
        # every lattice kernel at the slice's shapes, as [8] does at 50 x 50
        sim = wf.sims["forward"]
        theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
        rows = phase_kernels(torch, sim, theta, dev, "[11a]", f"@{nx}x{ny}", forced=False,
                             detail=False)
        del theta, wf, sim
        for k in rows:
            by_stage = {st: sum(c[w.__name__] for w in k["wrappers"])
                        for st, c in out["atlas_2d"]["launches"].items()}
            k["launches"] = sum(by_stage[st] for st in ("forward", "inverse", "optimized"))
            k["launches_in"] = f"[11a] forward + inverse + optimized at {nx}x{ny}"
            k["launches_by_stage"] = by_stage
        kernels += rows
        torch.cuda.empty_cache()

        tag = "[11b] atlas {}^3:".format(WF_3D[0])
        out["atlas_3d"], wf = _wf_atlas(torch, dev, tmp, tag, "3d", WF_3D)
        _wf_check_forward(torch, wf, dev, tag, out["atlas_3d"])
        del wf
        torch.cuda.empty_cache()

        out["patient_2d"] = _wf_patient(torch, dev, tmp, f"[11c] patient "
                                        f"{WF_PATIENT[0]}x{WF_PATIENT[1]}:")
        torch.cuda.empty_cache()

        bmv = next(k for k in kernels if k["name"] == "bell_bmv")
        out["atlas_quad_2d"] = _wf_atlas_quad(torch, dev, tmp, bmv)
        torch.cuda.empty_cache()
        out["quad_lattice_3d"] = _wf_quad_lattice(torch, dev, tmp, bmv)
        torch.cuda.empty_cache()
        for k in kernels:
            if "wrappers" not in k or k.get("route") != "cuda" or "stencil" not in k["name"]:
                continue
            k["workflow_launches"] = {
                pipe: sum(sum(c[w.__name__] for w in k["wrappers"])
                          for c in o["launches"].values())
                for pipe, o in out.items()}
        print(f"[11] workflow phase {time.perf_counter() - t_phase:.1f} s")
        return out
    finally:
        from glimslib_tpu_torch.core.results import Results

        for name, fn in writers.items():
            setattr(Results, name, fn)
        shutil.rmtree(tmp, ignore_errors=True)


# [12]: the example scripts (glimslib_tpu_torch/example_scripts), every
# one at its reference defaults and argument sets, on the card at f32 with
# plot=False: the card's host has no matplotlib (plotting is held on the
# CPU by tests/test_torch_visualisation.py).  The forward and comparison
# scripts' final fields are held to EX_RTOL of the same script on the plain
# path at f64 on the card (the f32 field limit of [9] and [10]); the
# noise-free adjoint scripts' recovered parameters to EX_RECOVERY_RTOL of
# their truth (the reference scripts' limit), J falling; the noisy ones by
# the script's own limit where the reference script has one.  Every
# lattice kernel is held against its plain version at each lattice the
# scripts run (phase_kernels on the script's model, as [11a] does), and
# bell_bmv at every table shape of the unstructured scripts.  The workflow
# scripts keep their reference maxiter (50, 15).
EX_RTOL = 1e-4
EX_RECOVERY_RTOL = 1e-2
EX_FORWARD = ("tumor_growth_2D_uniform", "tumor_growth_2D_subdomains",
              "tumor_growth_2D_uniform_reload", "comparison_2D_atlas",
              "comparison_3D_atlas")
EX_TRACED = "tumor_growth_2D_uniform"
# run without the profiler (busy and idle not measured): the reduced 2D
# atlas adjoint's 18 L-BFGS-B iterations launch millions of kernels, and
# its profiled run took 51.1 s against the 25.6 s of its stages (an H100 at
# 700 W); its value_and_grad is profiled in [8]
EX_UNPROFILED = ("brain_2D_atlas_reduced_domain_adjoint",)
# [13c] runs it: its ranks are processes of their own, whose launches the
# counts of this process do not see
EX_SHARDED = "tumor_growth_3D_atlas_sharded"


def _ex_fields(out):
    """The final fields a forward or comparison script returns."""
    keys = [k for k in ("u", "c", "u_uniform", "c_uniform") if k in out]
    return {k: out[k] for k in keys}


def _ex_trace_kernels(path):
    """The port's kernels in a Chrome trace by name (count, ms), and the
    device's busy ms (kernels, copies and fills, as the profiler's device
    events of the other scripts)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for name in ("stencil_pcg_kernel", "stencil_apply_kernel", "bell_bmv_kernel"):
            if name in e.get("name", ""):
                n, ms = out.get(name, (0, 0.0))
                out[name] = (n + 1, ms + float(e.get("dur", 0.0)) / 1e3)
    busy = sum(float(e.get("dur", 0.0)) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3
    return out, busy


def _ex_run(torch, module, argv, dev, out_dir, traced, log_dir, profiled=True):
    """One script's main() on the card at f32 with every launch count at 0
    just before it: (its result, seconds, launches by wrapper, bell_bmv's
    by shape, device busy ms or None where not ``profiled``, the traced
    kernels or None)."""
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.utils.profiling import device_trace

    wrappers = _wf_wrappers()
    for w in wrappers:
        w.launches = 0
    bk.batched_matvec.launches_by_shape = {}
    box = {}

    def run():
        box["out"] = module.main(argv, device=dev, dtype=torch.float32, plot=False,
                                 out_dir=out_dir)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traced_kernels = None
    if traced:
        with device_trace(log_dir, device=dev) as prof:
            run()
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        traced_kernels, busy = _ex_trace_kernels(prof.trace_path)
    elif profiled:
        prof = _profile(torch, run, cpu=False)
        seconds = time.perf_counter() - t0
        busy = _device_busy_ms(prof)
    else:
        run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        busy = None
    launches = {w.__name__: w.launches for w in wrappers}
    return (box["out"], seconds, launches, dict(bk.batched_matvec.launches_by_shape),
            busy, traced_kernels)


# the scripts whose meshes have no lattice (the reduced 2D atlas; the 3D
# atlas's tet mesh from utils/meshing.mesh_image_labels): the unstructured
# lane, bell_bmv
EX_UNSTRUCTURED = ("brain_2D_atlas_reduced_domain_adjoint", "comparison_3D_atlas")


def _ex_demand(tag, name, launches, out):
    """The kernels a script's path must launch: both lattice solves in a
    lattice script (and stencil_apply where it takes a gradient: the
    backward's residual re-evaluations), bell_bmv on an unstructured
    mesh; convert and example_config run no model."""
    if name in ("example_config", "convert_vtu_mesh_to_hdf5"):
        need = ()
    elif name in EX_UNSTRUCTURED:
        need = ("batched_matvec",)
    else:
        need = ("cg_scalar", "cg_vector")
        if "J0" in out:
            need += ("apply_scalar_sum", "apply_vector")
    missing = [w for w in need if launches[w] < 1]
    if missing:
        raise AssertionError(f"{tag} {missing} did not launch: {launches}")


def _ex_bmv(torch, dev, bmv, results, tables):
    """bell_bmv on [12]'s unstructured meshes: held against its plain
    version and timed as [5] at the 3D atlas's five tables (the brain model
    that comparison_3D_atlas ran), and for both scripts the share of the
    bound weighted by the script's launches (the reduced 2D atlas is [8]'s
    mesh, so [8]'s times)."""
    brain, by_shape = tables["comparison_3D_atlas"]
    brain._build_step()
    aug = brain._augment_theta_with_operators(
        {**brain.make_theta(brain.params.as_dict()), **brain.runtime_aux()})
    bmv["examples_3d_shapes"] = _bmv_shapes(torch, brain, aug, dev,
                                            "[12] comparison_3D_atlas:")
    del aug
    for name, recs in (("comparison_3D_atlas", bmv["examples_3d_shapes"]),
                       ("brain_2D_atlas_reduced_domain_adjoint",
                        bmv["atlas_2d_adjoint_launches"]["shapes"])):
        unchecked = set(tables[name][1]) - {tuple(r["shape"]) for r in recs}
        if unchecked:
            raise AssertionError(f"[12] {name}: bell_bmv ran at {sorted(unchecked)}, "
                                 "which no phase held against its plain version")
        share = _bmv_split({"shapes": recs}, tables[name][1], f"[12] {name}:",
                           what="script")
        results[next(k for k in results if k.split()[0] == name)][
            "bmv_weighted_bound_share"] = share


def _ex_lattice_check(torch, dev, sim, shape, checks):
    """Every lattice kernel against its plain version at ``sim``'s
    lattice, the first time [12] meets that lattice (``checks`` holds the
    rows by lattice)."""
    if shape in checks:
        return
    theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    checks[shape] = phase_kernels(torch, sim, theta, dev, "[12]", f"@{shape}", forced=False,
                                  timed=False)
    del theta
    torch.cuda.empty_cache()


def phase_examples(torch, dev, kernels):
    """[12]: every example script on the card (module docstring).  Adds
    each script's launches to the kernel rows; returns the scripts'
    numbers and the lattice kernels' rows at the scripts' lattices."""
    import importlib
    import importlib.util
    import shutil
    import tempfile

    import numpy as np

    from glimslib_tpu_torch.example_scripts import RUNS
    from glimslib_tpu_torch.example_scripts.__main__ import convert_argv

    t_phase = time.perf_counter()
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    print(f"[12] matplotlib {'imports' if has_mpl else 'is absent'} on this host: the "
          "scripts run with plot=False (plotting is held on the CPU by "
          "tests/test_torch_visualisation.py)")
    tmp = tempfile.mkdtemp(prefix="glims_examples_")
    results, tables, checks, at_lattice = {}, {}, {}, {}
    try:
        for name, argv in RUNS:
            if name == EX_SHARDED:
                print(f"[12] {name}: runs in [13c], on ranks of its own")
                continue
            argv = convert_argv(tmp) if argv is None else argv
            tag = f"[12] {name} {' '.join(argv) if name != 'convert_vtu_mesh_to_hdf5' else ''}".rstrip() + ":"
            key = " ".join([name] + (argv if name != "convert_vtu_mesh_to_hdf5" else []))
            module = importlib.import_module(f"glimslib_tpu_torch.example_scripts.{name}")
            traced = name == EX_TRACED
            out, sec, launches, by_shape, busy, tk = _ex_run(
                torch, module, argv, dev, tmp, traced, os.path.join(tmp, "trace"),
                profiled=name not in EX_UNPROFILED)
            idle = None if busy is None else max(0.0, 1 - busy / (1e3 * sec))
            row = dict(seconds=sec, launches=launches, device_busy_ms=busy, idle_share=idle,
                       stages={k: v["total_s"] for k, v in out.get("stages", {}).items()})
            print(f"{tag} {sec:.2f} s, " + (
                "unprofiled (EX_UNPROFILED): device busy not measured" if busy is None
                else f"device busy {busy:.1f} ms, idle {100 * idle:.1f}%")
                + "; seconds by stage (Tracer): " + ", ".join(
                      f"{k} {v:.3f}" for k, v in row["stages"].items()))
            if by_shape:
                row["bmv_by_shape"] = {"x".join(map(str, k)): n for k, n in by_shape.items()}
            if name == "comparison_3D_atlas":
                tables["comparison_3D_atlas"] = (out["brain"], by_shape)
            if name == "brain_2D_atlas_reduced_domain_adjoint":
                tables[name] = (None, by_shape)
            print(f"{tag} launches: " + ", ".join(f"{k}={n}" for k, n in launches.items())
                  + ("; bell_bmv by (B, M, K): " + ", ".join(
                      f"{k}: {n}" for k, n in sorted(by_shape.items(), key=lambda x: -x[1]))
                     if by_shape else ""))
            _ex_demand(tag, name, launches, out)
            if tk is not None:
                print(f"{tag} device_trace kernels (Chrome trace): " + ", ".join(
                    f"{k} {n} launches {ms:.3f} ms" for k, (n, ms) in tk.items()))
                if tk.get("stencil_pcg_kernel", (0, 0))[0] < 1:
                    raise AssertionError(f"{tag} the trace holds no stencil_pcg kernel: {tk}")
                row["trace_kernels"] = {k: dict(launches=n, ms=ms) for k, (n, ms) in tk.items()}
            if name in EX_FORWARD:
                t0 = time.perf_counter()
                ref = module.main(argv, device=dev, dtype=torch.float64, plot=False,
                                  out_dir=os.path.join(tmp, "plain"), plain=True)
                rel = {k: _rel_l2(torch.as_tensor(np.asarray(v)),
                                  torch.as_tensor(np.asarray(ref[k])))
                       for k, v in _ex_fields(out).items()}
                print(f"{tag} final fields vs the same script on the plain path at f64 "
                      f"on the card ({time.perf_counter() - t0:.1f} s): " + ", ".join(
                          f"{k} {v:.3e}" for k, v in rel.items()) + f" (<= {EX_RTOL})")
                if max(rel.values()) > EX_RTOL:
                    raise AssertionError(f"{tag} f32 vs f64 plain: {rel}")
                row["rel_l2_vs_f64_plain"] = rel
                if "columns" in out:
                    cols = out["columns"]
                    row["relative_errornorm"] = {
                        k: cols[k].tolist() for k in cols if k.startswith("relative_")}
                    print(f"{tag} brain vs uniform model, errornorm relative to the field "
                          f"(limit {out['rtol']}): " + ", ".join(
                              f"{k} {max(v):.3e}" for k, v in row["relative_errornorm"].items()))
            if "J0" in out:
                rel = np.asarray(out["rel_errors"])
                row.update(J0=out["J0"], J=out["J"], calls=out["calls"],
                           truth=np.asarray(out["v_true"]).tolist(),
                           recovered=np.asarray(out["x_opt"]).tolist(),
                           rel_errors=rel.tolist())
                noisy = out.get("noise", 0.0) > 0 or "noise" in name
                limit = out.get("rtol", EX_RECOVERY_RTOL)
                print(f"{tag} J {out['J0']:.6e} -> {out['J']:.6e} in {out['calls']} calls; "
                      f"recovered {dict(zip(out['names'], row['recovered']))}, truth "
                      f"{row['truth']}, rel errors {rel.tolist()} "
                      + (f"(noisy targets: the script's limit {out.get('rtol')})" if noisy
                         else f"(<= {limit})"))
                if not out["J"] < out["J0"]:
                    raise AssertionError(f"{tag} J did not fall")
                if not noisy and max(rel) > limit:
                    raise AssertionError(f"{tag} recovered parameters off by {rel}")
            if "params" in out:
                row["params"] = out["params"]
                print(f"{tag} L-BFGS-B nit {out['nit']}, recovered {out['params']}"
                      + (f", rel errors {out['rel_errors']}" if "rel_errors" in out else ""))
            results[key] = row
            sim = out.get("sim", out.get("brain"))
            if sim is not None and sim.lattice:
                shape = "x".join(map(str, sim.mesh.lattice_shape))
                row["lattice"] = shape
                at_lattice.setdefault(shape, []).append(key)
                _ex_lattice_check(torch, dev, sim, shape, checks)
            del out, sim
        # each row's launches: those of the scripts at its lattice
        for shape, rows in checks.items():
            for k in rows:
                k["launches"] = sum(results[key]["launches"][w.__name__]
                                    for key in at_lattice[shape] for w in k["wrappers"])
                k["launches_in"] = at_lattice[shape]
            print(f"[12] @{shape} (" + ", ".join(at_lattice[shape]) + "): launches "
                  + ", ".join(f"{k['name']} {k['launches']}" for k in rows))
        bmv = next((k for k in kernels if k.get("name") == "bell_bmv"), None)
        if bmv is not None:
            _ex_bmv(torch, dev, bmv, results, tables)
        for k in kernels:
            if "wrappers" in k:
                k["examples_launches"] = {
                    key: sum(r["launches"][w.__name__] for w in k["wrappers"])
                    for key, r in results.items()}
        total = sum(r["seconds"] for r in results.values())
        timed = [r for r in results.values() if r["device_busy_ms"] is not None]
        busy = sum(r["device_busy_ms"] for r in timed)
        prof_s = sum(r["seconds"] for r in timed)
        print(f"[12] scripts {total:.1f} s; the profiled ones {prof_s:.1f} s, device busy "
              f"{busy:.1f} ms, idle {100 * max(0.0, 1 - busy / (1e3 * prof_s)):.1f}%; "
              f"examples phase {time.perf_counter() - t_phase:.1f} s")
        return results, checks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# [13]: block sharding (Simulation.use_sharding(mode="bell")) on
# torch.distributed.  [13b]'s quad run takes SHARD_QUAD_STEPS steps, cut
# from [10]'s 5 to keep [13] short; a collective that waits longer than
# SHARD_TIMEOUT_S raises in its rank.
SHARD_QUAD_STEPS = 1
# [13b]'s P1 box: its forward and value_and_grad take SHARD_P1_STEPS
# step(s) (cut from N_STEPS to keep the script well inside its limit, then
# from 2 to fit [17]: ~2,300 gloo collectives a step at 2-3 ms each)
SHARD_P1_STEPS = 1
SHARD_TIMEOUT_S = 600
# the tables use_sharding holds as a rank's slab (supernode blocks) or
# rows (the two-level level's aggregates), by key
SHARD_TABLES = ("_BellWel", "_BellCuc", "_BellWrdC", "_BellMrd", "_BinvSN", "_McSN",
                "_FWel", "_FCuc", "_FWrd", "_FMrd", "_P2BWrdC", "_McSNP2", "_FP2Wrd",
                "_TLCfac", "_TLCfacS", "_TLCfacT", "_TLCfacST", "_TLMt", "_TLMtS")


def _table_bytes(aug):
    """(bytes of every table of ``aug`` that sharding slabs, each storage
    once; {key: (shape, bytes)} of each)."""
    seen, total, per = set(), 0, {}
    for k in SHARD_TABLES:
        if k not in aug:
            continue
        t = aug[k]
        st = t.untyped_storage()
        per[k] = (tuple(t.shape), t.numel() * t.element_size())
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            total += st.nbytes()
    return total, per


def _bmv_roles(sim, aug):
    """(role, A) of every table a model's path contracts, shaped as
    bell_bmv takes it (the slab's blocks under sharding)."""
    plan = sim._get_bell_plan()
    nb, s, Kh, d = plan.nb, plan.s, plan.Kh, sim.mesh.dim
    roles = [("elasticity operator _BellWel", aug["_BellWel"].reshape(nb, s * d, Kh * d)),
             ("elasticity supernode Jacobi _BinvSN", aug["_BinvSN"])]
    if sim.quad:
        # no P2 tables where the rd block is on the jvp lane (GLIMS_P2BELL=0)
        return roles + ([("P2 rd constant plane _P2BWrdC", aug["_P2BWrdC"]),
                         ("P2 supernode Jacobi _McSNP2", aug["_McSNP2"])]
                        if "_P2BWrdC" in aug else [])
    return roles + [("coupling _BellCuc", aug["_BellCuc"].reshape(nb, s * d, Kh)),
                    ("rd constant planes _BellWrdC", aug["_BellWrdC"]),
                    ("rd supernode Jacobi _McSN", aug["_McSN"])]


def _bmv_slab_errors(torch, roles, dev):
    """bell_bmv against its plain version at each (role, A), untimed: max
    abs and rel error and the launch plan's mode by shape."""
    import numpy as np

    from glimslib_tpu_torch.ops import bell_kernels as bk

    rng = np.random.default_rng(1)
    out = {}
    for role, A in roles:
        B, M, K = A.shape
        x = torch.as_tensor(rng.standard_normal((B, K)), dtype=torch.float32, device=dev)
        err, rel = _rel_max(bk.batched_matvec(A, x), bk.batched_matvec_plain(A, x))
        if rel > BMV_RTOL:
            raise AssertionError(f"bell_bmv {role} {(B, M, K)}: rel err {rel:.3e}")
        out[(B, M, K)] = dict(role=role, max_abs_err=err, rel=rel,
                              mode=bk.plan_for(A).mode)
    return out


def _rank_busy(torch, mesh, run, profiled=None):
    """(wall ms, device busy ms) of one profiled run() on this rank, or
    (None, None) where this rank is not among ``profiled`` (default:
    every rank).  Every rank runs run() once a turn (its collectives need
    them all), and one rank a turn runs it under the profiler, so no two
    profile at once."""
    wall = busy = None
    for r in range(mesh.world) if profiled is None else profiled:
        if r != mesh.rank:
            run()
            continue
        t0 = time.perf_counter()
        prof = _profile(torch, run, cpu=False)
        wall = (time.perf_counter() - t0) * 1e3
        busy = _device_busy_ms(prof)
    return wall, busy


def _rank_model(torch, mesh, tag, quad, config, n_steps, box=None, vg=None, timed=None):
    """One rank of [13b]: the sharded model (P1 box or quad flagship, on
    the mesh ``box`` where given: the models share its plans) at
    ``config``, ``n_steps`` steps with the counts at 0 just before, a
    profiled run a rank, the table bytes, and bell_bmv at every slab shape
    against its plain version (rank 0 times those whose role ``timed``
    names, the others waiting; then each rank checks its own slab); with
    ``vg`` (targets, v0, config) one value_and_grad with the counts at 0,
    and one more that rank 0 profiles.  Returns the numbers and the mesh."""
    import numpy as np
    import torch.distributed as dist

    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    dev = mesh.device
    t0 = time.perf_counter()
    sim = brain_sim(n=N, dtype=torch.float32, device=dev, unstructured=True, quad=quad,
                    mesh=box)
    sim.step_config = config
    sim.use_sharding(mesh)
    aux = sim.runtime_aux()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    theta = sim.make_theta(sim.params.as_dict())
    args = (theta,) + tuple(sim.initial_state())
    simulate = sim.build_simulate_fn(n_steps, 1.0)
    bk.batched_matvec.launches = 0
    bk.batched_matvec.launches_by_shape = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u_tr, c_tr, ok, newton = simulate(*args)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    by_shape = dict(bk.batched_matvec.launches_by_shape)
    if not bool(ok.all()):
        raise AssertionError(f"{tag} rank {mesh.rank}: a step did not converge")
    # rank 0 profiles, the other runs beside it (cut from one profiled run
    # a rank, in turns: the profiler's ~10 s a turn over gloo)
    wall, busy = _rank_busy(torch, mesh, lambda: simulate(*args), profiled=(0,))
    out = dict(setup_s=setup_s, first_s=first_s, newton=newton.tolist(),
               el_cg=[int(i) for i in sim.solver_info["el_cg_iters"]],
               u=u_tr[-1].cpu().numpy(), c=c_tr[-1].cpu().numpy(),
               launches=sum(by_shape.values()), by_shape=by_shape,
               wall_ms=wall, busy_ms=busy, blocks=[
                   (p.nb, p.nb_total) for p in ([sim._get_bell_plan()] + (
                       [sim._get_p2_plan()] if quad else []))])
    aug = sim._augment_theta_with_operators({**theta, **aux})
    out["table_bytes"], out["tables"] = _table_bytes(aug)
    roles = _bmv_roles(sim, aug)
    for r in range(mesh.world):
        if r == mesh.rank == 0:
            out["timed"] = _bmv_check(torch, [(role, A) for role, A in roles
                                              if timed is None or role in timed],
                                      dev, f"{tag} rank 0 slab:")
        dist.barrier()
    out["checked"] = _bmv_slab_errors(torch, roles, dev)
    del aug
    if vg is not None:
        targets, v0, vg_config = vg
        sim.step_config = vg_config
        names, update = param_map_for_type(2)
        ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=n_steps,
                            dt=1.0)
        bk.batched_matvec.launches_by_shape = {}
        t0 = time.perf_counter()
        J, g = ip.value_and_grad(v0)
        torch.cuda.synchronize()
        out["vg_s"] = time.perf_counter() - t0
        out["vg_by_shape"] = dict(bk.batched_matvec.launches_by_shape)
        out["vg_wall_ms"], out["vg_busy_ms"] = _rank_busy(
            torch, mesh, lambda: ip.value_and_grad(v0), profiled=(0,))
        Jg = torch.tensor([J, *g.tolist()], dtype=torch.float64)
        got = mesh.broadcast(Jg.clone(), 0)
        out.update(J=J, g=np.asarray(g), Jg_same_as_rank0=bool(torch.equal(got, Jg)))
    box = sim.mesh
    del sim, aux, theta, args, u_tr, c_tr
    torch.cuda.empty_cache()
    return out, box


def _rank13b(mesh, p1, quad):
    """[13b]'s work on one rank: the P1 box (``p1`` = forward config,
    (targets, v0, value_and_grad config)), then the quad flagship
    (``quad`` = its config) on the same mesh; bell_bmv is timed at the P1
    model's slab shapes and the P2 ones."""
    import torch

    p1_out, box = _rank_model(torch, mesh, "[13b] P1", False, p1[0], SHARD_P1_STEPS,
                              vg=p1[1])
    quad_out, _ = _rank_model(torch, mesh, "[13b] quad", True, quad, SHARD_QUAD_STEPS,
                              box=box, timed=("P2 rd constant plane _P2BWrdC",
                                              "P2 supernode Jacobi _McSNP2"))
    return dict(p1=p1_out, quad=quad_out)


def _shard_world1(torch, dev, usim, keep):
    """[13a]: world 1 over NCCL in this process: [6]'s box under
    use_sharding() (its slab of every table is the whole), 5 steps at
    [9a]'s refined config, against the unsharded model run the same way
    (its frozen state, the deterministic algorithms use_sharding turns
    on), bit for bit or the max difference; against [9a]'s own run of the
    unsharded model (before deterministic algorithms) and the f64 plain
    path."""
    import tempfile
    import warnings

    import torch.distributed as dist

    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.parallel import make_device_mesh

    # cuBLAS warns under deterministic algorithms where its workspace was
    # not set before its first call (this process's was)
    warnings.filterwarnings("ignore", message=".*CUBLAS_WORKSPACE_CONFIG.*")
    p1 = keep["p1"]
    u9, c9 = p1["final"]
    u_r, c_r = p1["ref"]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_device_mesh(device=dev)
            t0 = time.perf_counter()
            sim = brain_sim(n=N, dtype=torch.float32, device=dev, mesh=usim.mesh)
            sim.step_config = usim.step_config = p1["config"]
            sim.use_sharding(mesh)
            if sim.sharding_mode != "bell":
                raise AssertionError(f"[13a] sharding mode {sim.sharding_mode}")
            plan = sim._get_bell_plan()
            aux = usim.runtime_aux()
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            runs = {}
            for who, s_ in (("sharded", sim), ("unsharded", usim)):
                args = (s_.make_theta(s_.params.as_dict()),) + tuple(s_.initial_state())
                bk.batched_matvec.launches_by_shape = {}
                runs[who] = _drive(torch, s_, s_.build_simulate_fn(N_STEPS, 1.0),
                                   args + (aux,), [(bk.batched_matvec,)],
                                   f"[13a] {who}, world 1:", N_STEPS)
                runs[who] += (dict(bk.batched_matvec.launches_by_shape),)
            (u_s, c_s), launches, first_s, by_shape = runs["sharded"]
            (u_u, c_u) = runs["unsharded"][0]
            same = bool(torch.equal(c_s, c_u) and torch.equal(u_s, u_u))
            diff = (float((c_s - c_u).abs().max()), float((u_s - u_u).abs().max()))
            diff9 = (float((c_s[-1] - c9).abs().max()), float((u_s[-1] - u9).abs().max()))
            rel = (_rel_l2(c_s[-1], c_r), _rel_l2(u_s[-1], u_r))
            print(f"[13a] world 1 (nccl): mode {sim.sharding_mode}, slab blocks "
                  f"[{plan.b0}, {plan.b1}) of {plan.nb_total}; set-up {setup_s:.1f} s; "
                  f"bell_bmv by (B, M, K): {by_shape}")
            print(f"[13a] c and u bit-equal to the unsharded model's run {same} (max abs "
                  f"diff c {diff[0]:.3e}, u {diff[1]:.3e}); vs [9a]'s run of it, before "
                  f"deterministic algorithms, max abs diff c {diff9[0]:.3e}, u "
                  f"{diff9[1]:.3e} (the card's atomics in index_add_ add in no fixed "
                  f"order); vs the f64 plain path rel-L2 c {rel[0]:.3e}, u {rel[1]:.3e} "
                  f"(<= {UNSTRUCT_RTOL})")
            if max(rel) > UNSTRUCT_RTOL:
                raise AssertionError(f"[13a] vs f64 plain: {rel}")
            out = dict(setup_s=setup_s, first_s=first_s, launches=launches[bk.batched_matvec],
                       by_shape={"x".join(map(str, k)): v for k, v in by_shape.items()},
                       bit_equal=same, max_abs_diff=diff, max_abs_diff_vs_9a=diff9,
                       rel_vs_f64=rel)
            del sim, aux, runs, u_s, c_s, u_u, c_u
        finally:
            dist.destroy_process_group()
            # use_sharding turned deterministic algorithms on for this
            # process: the phases after [13] run as before it
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = True
    torch.cuda.empty_cache()
    return out


def _rank_pair(mesh, a13, a14):
    """One spawn's work on a rank: [13b] (:func:`_rank13b` on ``a13``),
    then [14b] and [14d] (:func:`_rank14b` on ``a14``) with the
    deterministic algorithms [13b]'s use_sharding turned on off again, as
    in a process of their own, then [16b] (:func:`_rank16b`) and [17b]
    (:func:`_rank17b`); and each part's seconds."""
    import torch

    t0 = time.perf_counter()
    b13 = _rank13b(mesh, *a13)
    t1 = time.perf_counter()
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = True
    torch.cuda.empty_cache()
    b14 = _rank14b(mesh, *a14)
    t2 = time.perf_counter()
    torch.cuda.empty_cache()
    b16 = _rank16b(mesh)
    t3 = time.perf_counter()
    torch.cuda.empty_cache()
    b17 = _rank17b(mesh)
    return {"13b": b13, "14b": b14, "16b": b16, "17b": b17,
            "seconds": (t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3)}


def _shard_two_ranks(torch, keep, ranks, wall_s, rank_s):
    """[13b]: two ranks sharing the card over gloo (module docstring), from
    their results ``ranks`` (the spawn took ``wall_s`` seconds, [13b]'s
    work in it ``rank_s``); returns its numbers and bell_bmv's slab rows
    for the kernels line."""
    import numpy as np

    p1, quad = keep["p1"], keep["quad"]
    out, slab_rows = {}, {}
    for name, ref, f32, steps in (("p1", p1["ref_short"], p1["short"], SHARD_P1_STEPS),
                                  ("quad", quad["ref"], quad["final"], SHARD_QUAD_STEPS)):
        tag = f"[13b] {'P1 box' if name == 'p1' else 'quad flagship'}:"
        whole_bytes, whole = keep[name]["table_bytes"]
        rows = []
        for r, per in enumerate(ranks):
            o = per[name]
            rel = (_rel_l2(torch.as_tensor(o["c"]), ref[1].cpu()),
                   _rel_l2(torch.as_tensor(o["u"]), ref[0].cpu()))
            rel32 = (_rel_l2(torch.as_tensor(o["c"]), f32[1].cpu()),
                     _rel_l2(torch.as_tensor(o["u"]), f32[0].cpu()))
            shown = ("_BellWel", "_P2BWrdC", max(whole, key=lambda k: whole[k][1]))
            idle = max(0.0, 1 - o["busy_ms"] / o["wall_ms"]) if o["busy_ms"] else None
            print(f"{tag} rank {r}: slab blocks " + ", ".join(
                f"{a} of {b}" for a, b in o["blocks"]) + "; "
                  f"set-up {o['setup_s']:.1f} s, {steps} steps in {o['first_s']:.2f} s "
                  f"(Newton {o['newton']}, elasticity CG {o['el_cg']}); table bytes held "
                  f"{o['table_bytes'] / 1e6:.1f} MB against {whole_bytes / 1e6:.1f} MB "
                  f"unsharded ({o['table_bytes'] / whole_bytes:.3f}); " + ", ".join(
                      f"{k} {o['tables'][k][0]} {o['tables'][k][1] / 1e6:.1f} MB against "
                      f"{whole[k][0]} {whole[k][1] / 1e6:.1f} MB"
                      for k in dict.fromkeys(shown) if k in whole)
                  + ("; profiled run: device "
                     f"busy {o['busy_ms']:.1f} ms of {o['wall_ms']:.1f} ms, idle "
                     + (f"{100 * idle:.1f}%" if idle is not None else "not measured")
                     if o["wall_ms"] is not None else "; profiled on rank 0 only"))
            print(f"{tag} rank {r}: bell_bmv launches by slab (B, M, K): " + ", ".join(
                f"{k}: {v}" for k, v in sorted(o["by_shape"].items(), key=lambda x: -x[1]))
                + "; each slab shape against the plain contraction: " + ", ".join(
                    f"{k} max rel {v['rel']:.2e} ({v['mode']})"
                    for k, v in o["checked"].items()))
            print(f"{tag} rank {r}: final c, u vs the f64 plain path rel-L2 {rel[0]:.3e}, "
                  f"{rel[1]:.3e} (<= {UNSTRUCT_RTOL}); vs the unsharded f32 run "
                  f"{rel32[0]:.3e}, {rel32[1]:.3e}")
            if max(rel) > UNSTRUCT_RTOL:
                raise AssertionError(f"{tag} rank {r} vs f64 plain: {rel}")
            unchecked = set(o["by_shape"]) - set(o["checked"])
            if unchecked or not o["by_shape"]:
                raise AssertionError(f"{tag} rank {r}: bell_bmv launched at {unchecked} "
                                     "unchecked, or not at all")
            if any(a * 2 != b for a, b in o["blocks"]):
                raise AssertionError(f"{tag} rank {r}: slabs of {o['blocks']}")
            bulk = {k: v["mode"] for k, v in o["checked"].items()
                    if np.prod(k) % 4 == 0 and v["mode"] != "bulk"}
            if bulk:
                raise AssertionError(f"{tag} rank {r}: not bulk at {bulk}")
            row = dict(rank=r, rel_vs_f64=rel, rel_vs_unsharded_f32=rel32,
                       table_bytes=o["table_bytes"], unsharded_table_bytes=whole_bytes,
                       setup_s=o["setup_s"], run_s=o["first_s"], device_busy_ms=o["busy_ms"],
                       idle_share=idle, launches_by_shape={
                           "x".join(map(str, k)): v for k, v in o["by_shape"].items()})
            if "J" in o:
                J64, g64, J32, g32 = (p1[k] for k in ("J64_short", "g64_short", "J_short",
                                                       "g_short"))
                rJ = abs(o["J"] - J64) / abs(J64)
                rg = float(np.linalg.norm(o["g"] - g64) / np.linalg.norm(g64))
                dJ = abs(o["J"] - J32) / abs(J32)
                dg = float(np.linalg.norm(o["g"] - g32) / np.linalg.norm(g32))
                vidle = (max(0.0, 1 - o["vg_busy_ms"] / o["vg_wall_ms"])
                         if o["vg_busy_ms"] else None)
                print(f"{tag} rank {r}: value_and_grad J {o['J']:.6e}, gradient "
                      f"{o['g'].tolist()} ({o['vg_s']:.2f} s"
                      + (f"; profiled on rank 0: busy {o['vg_busy_ms']:.1f} ms of "
                         f"{o['vg_wall_ms']:.1f}, idle {100 * vidle:.1f}%" if r == 0 else "")
                      + f"); vs the f64 plain "
                      f"path rel J {rJ:.3e} (<= {ADJ_J_RTOL['unstructured']}), gradient "
                      f"{rg:.3e} (<= {ADJ_G_RTOL['unstructured']}); vs the unsharded f32 "
                      f"call rel J {dJ:.3e}, gradient {dg:.3e}; J and gradient bit-equal "
                      f"to rank 0's {o['Jg_same_as_rank0']}; bell_bmv launches in the call "
                      f"by slab shape {o['vg_by_shape']}")
                if rJ > ADJ_J_RTOL["unstructured"] or rg > ADJ_G_RTOL["unstructured"]:
                    raise AssertionError(f"{tag} rank {r}: J {rJ:.3e}, gradient {rg:.3e}")
                row.update(J=o["J"], grad=o["g"].tolist(), rel_J=rJ, rel_grad=rg,
                           rel_J_vs_unsharded=dJ, rel_grad_vs_unsharded=dg,
                           value_and_grad_s=o["vg_s"], value_and_grad_idle_share=vidle,
                           J_grad_bit_equal_across_ranks=o["Jg_same_as_rank0"])
            rows.append(row)
        same = all(np.array_equal(ranks[0][name][k], ranks[1][name][k]) for k in ("u", "c"))
        print(f"{tag} the two ranks' final c and u bit-equal: {same}")
        out[name] = dict(ranks=rows, ranks_bit_equal=same)
        for rec in ranks[0][name]["timed"]:
            slab_rows[tuple(rec["shape"])] = rec
    # a slab shape's launches: both models' forward runs on both ranks
    for key, rec in slab_rows.items():
        rec["launches"] = sum(per[m]["by_shape"].get(key, 0)
                              for per in ranks for m in ("p1", "quad"))
    print(f"[13b] two ranks (gloo, sharing the card): {rank_s:.1f} s on the ranks; the "
          f"spawn, with [14b] and [14d] after it, {wall_s:.1f} s")
    out["seconds"] = rank_s
    out["spawn_seconds"] = wall_s
    return out, list(slab_rows.values())


def _shard_example(torch, dev, tmp):
    """[13c]: tumor_growth_3D_atlas_sharded at two gloo ranks on the card
    (f32), its fields against the same model unsharded on the plain path
    at f64."""
    from glimslib_tpu_torch.example_scripts import tumor_growth_3D_atlas_sharded as ex
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    t0 = time.perf_counter()
    out = ex.main(["--ranks", "2", "--backend", "gloo", "--save-method", "vtk"],
                  device=dev, dtype=torch.float32, out_dir=tmp)
    sec = time.perf_counter() - t0
    ref = ex.build_model(out["store"], torch.float64, dev, plain=True)
    ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12,
                                 cg_maxiter=4000)
    sol = ref.run(save_method=None, plot=False, output_dir=os.path.join(tmp, "plain"))
    rel = (_rel_l2(torch.as_tensor(out["c"]), torch.as_tensor(sol[1])),
           _rel_l2(torch.as_tensor(out["u"]), torch.as_tensor(sol[0])))
    for r in out["ranks"]:
        print(f"[13c] rank {r['rank']}: mode {r['sharding_mode']}, slab blocks "
              f"{r['blocks'][0]} of {r['blocks'][1]}, seconds {r['seconds']}, Newton "
              f"{r['newton_iters'].tolist()}, bell_bmv by slab (B, M, K) "
              f"{r['bell_bmv_launches']}")
        if r["sharding_mode"] != "bell" or not r["bell_bmv_launches"]:
            raise AssertionError(f"[13c] rank {r['rank']}: {r['sharding_mode']}, "
                                 f"{r['bell_bmv_launches']}")
    print(f"[13c] tumor_growth_3D_atlas_sharded at 2 ranks: {out['n_nodes']} nodes, "
          f"{out['n_cells']} tets, {sec:.1f} s; final max concentration "
          f"{out['final_max_c']:.6f} (the reference's ~0.83); vs the plain f64 path "
          f"rel-L2 c {rel[0]:.3e}, u {rel[1]:.3e} (<= {EX_RTOL})")
    if max(rel) > EX_RTOL:
        raise AssertionError(f"[13c] vs f64 plain: {rel}")
    return dict(seconds=sec, final_max_c=out["final_max_c"], rel_vs_f64=rel,
                n_nodes=out["n_nodes"], launches_by_rank=[
                    {"x".join(map(str, k)): v for k, v in r["bell_bmv_launches"].items()}
                    for r in out["ranks"]])


def phase_shard(torch, dev, kern, usim, keep):
    """[13]: block sharding (module docstring).  ``kern`` (the bell_bmv
    row) gains the slab shapes; ``keep`` holds [9a]'s and [10]'s runs, and
    gains [14b]'s rank results under "nodes_ranks", [16b]'s under
    "shard16_ranks" and [17b]'s under "vn17_ranks" (their ranks run in
    [13b]'s spawn)."""
    import shutil
    import tempfile

    from glimslib_tpu_torch.parallel import run_ranks

    t_phase = time.perf_counter()
    out = {"world1": _shard_world1(torch, dev, usim, keep)}
    # one spawn for [13b] and for [14b] and [14d] after it
    p1 = keep["p1"]
    t0 = time.perf_counter()
    ranks = run_ranks(_rank_pair, NODES_WORLD, "gloo", dev, args=(
        ((p1["config"], (p1["targets"], p1["v0"], p1["vg_config"])), keep["quad"]["config"]),
        _nodes_rank_args(keep["lattice"])), timeout=SHARD_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    two, slab_rows = _shard_two_ranks(torch, keep, [r["13b"] for r in ranks], wall_s,
                                      max(r["seconds"][0] for r in ranks))
    keep["nodes_ranks"] = ([r["14b"] for r in ranks], max(r["seconds"][1] for r in ranks))
    keep["shard16_ranks"] = ([r["16b"] for r in ranks], max(r["seconds"][2] for r in ranks))
    keep["vn17_ranks"] = ([r["17b"] for r in ranks], max(r["seconds"][3] for r in ranks))
    out["two_ranks"] = two
    kern["slab_shapes"] = slab_rows
    tmp = tempfile.mkdtemp(prefix="glims_shard_")
    try:
        out["example"] = _shard_example(torch, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[13] sharding phase {out['seconds']:.1f} s")
    return out


# [14]: node sharding of the lattice (Simulation.use_sharding(mode="nodes"),
# parallel/gspmd.py) on torch.distributed.  [14b] pads the N=32 box for
# NODES_WORLD ranks; a collective that waits longer than SHARD_TIMEOUT_S
# raises in its rank.
NODES_WORLD = 2
# the planes and loads a 'nodes' model holds as its rows, and an unsharded
# lattice model holds whole ([14b] compares their bytes)
NODES_PLANES = ("_Wel", "_Binv", "_Wrd_const", "_Mst", "_Cuc", "_rd_load", "_el_load")
# [14b]'s profiled run (rank 0's, the other rank running beside it; cut
# from one a rank in turns) takes NODES_PROFILE_STEPS steps of the same
# model, cut from N_STEPS to keep [14] short
NODES_PROFILE_STEPS = 1
# [14d]'s value_and_grad at two ranks takes NODES_VG_STEPS steps (cut from
# N_STEPS for time: a collective costs 1.0-2.3 ms through the host there)
NODES_VG_STEPS = 2
# [14c] and [14d] hold J and the gradient to the lattice limits at
# newton_atol REFINED_NEWTON_ATOL: at REFINED_STEP_CONFIG's 1e-5 the
# warm-started Newton of the pcg branch stops one iteration after its
# guess (c 3.0e-5 of f64 in [14a]), and J lands 3.4e-4 off the f64 J (an
# H100 at 700 W), as on the unstructured lane ([9a]); [14c]'s call at
# REFINED_STEP_CONFIG is held to that lane's J limit.


def _halo_wrappers():
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    return (sk.apply_scalar, sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling)


def _nodes_groups(refined):
    """The halo forms a 'nodes' forward launches (one tuple a kernel):
    under refine_f64 the residuals are the f64 gather path's, so the
    solves' operators alone (the rd Jacobian <1,1> and the elasticity
    operator <3,3>)."""
    from glimslib_tpu_torch.ops import stencil_kernels as sk

    groups = [(sk.apply_scalar,), (sk.apply_vector,)]
    return groups if refined else groups + [(sk.apply_scalar_sum,), (sk.apply_coupling,)]


class _PlainCalls:
    """Counts the calls of the stencil kernels' plain version while
    active (the 'nodes' path on the card must make none)."""

    def __enter__(self):
        from glimslib_tpu_torch.ops import stencil_kernels as sk

        self.sk, self.orig, self.calls = sk, sk.stencil_apply_plain, 0

        def counted(*a, **k):
            self.calls += 1
            return self.orig(*a, **k)
        sk.stencil_apply_plain = counted
        return self

    def __exit__(self, *exc):
        self.sk.stencil_apply_plain = self.orig


class _Collectives:
    """Counts the calls of torch.distributed.all_reduce while active and
    sums their host time (the call returns once the reduction is done)."""

    def __enter__(self):
        import torch.distributed as dist

        self.dist, self.orig, self.count, self.ms = dist, dist.all_reduce, 0, 0.0

        def timed(*a, **k):
            t = time.perf_counter()
            r = self.orig(*a, **k)
            self.count += 1
            self.ms += (time.perf_counter() - t) * 1e3
            return r
        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig


class _Transposed:
    """Counts the backward's transposed halo launches by form (calls of
    ``stencil_kernels._transposed_apply`` with a halo) while active."""

    def __enter__(self):
        from glimslib_tpu_torch.ops import stencil_kernels as sk

        self.sk, self.orig, self.calls = sk, sk._transposed_apply, {}

        def counted(form, offsets, WT, y, halo=0, plain=False):
            if halo and not plain:
                self.calls[form] = self.calls.get(form, 0) + 1
            return self.orig(form, offsets, WT, y, halo, plain)
        sk._transposed_apply = counted
        return self

    def __exit__(self, *exc):
        self.sk._transposed_apply = self.orig


# the backward's transposed launches on the 'nodes' path: dv of the rd
# residual's mass term (c_prev) and of the coupling (c); the vector form's
# dv is never asked (u is no input of a residual VJP)
NODES_T_FORMS = ("scalar", "coupling")


def _csr_T(torch, A):
    """The CSR matrix A^T (int32 indices) of a CSR matrix A."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        csr = A.to_sparse_coo().t().coalesce().to_sparse_csr()
        return torch.sparse_csr_tensor(csr.crow_indices().int(), csr.col_indices().int(),
                                       csr.values(), csr.shape, check_invariants=False)


def _transposed_rows(torch, sim, aug, dev, tag, suffix):
    """The backward's transposed halo launches at this slab's shapes (the
    path's planes mirrored and extended by H rows, a cotangent from a
    seed): each held against its plain version (bit for bit) and timed as
    [2] times a form (L2-cold and warm), beside its bound and the CSR
    matrix of A^T; the vector form's held only (not on the path)."""
    import functools

    import numpy as np

    from glimslib_tpu_torch.ops import stencil_kernels as sk

    offs, h = sim._stencil_ops.offsets, sim._halo_rows
    n, d = aug["_Wel"].shape[-1], aug["_Wel"].shape[1]
    m = n + 2 * h
    rng = np.random.default_rng(5)
    f32 = lambda *s_: torch.as_tensor(rng.standard_normal(s_), dtype=torch.float32,  # noqa: E731
                                      device=dev)
    cold = _cold_l2(torch, dev)
    kern = functools.partial(sk._transposed_apply, halo=h)
    plain = functools.partial(sk.transposed_apply_plain, halo=h)
    rows = []
    for form, W, d_out, d_in, name, pattern, replaces in (
        ("scalar", aug["_Mst"], 1, 1, "stencil_apply<1,1>^T", r"stencil_apply_kernel<1, ?1, ?1>",
         "glimslib_tpu/ops/stencil_pallas.py:108"),
        ("coupling", aug["_Cuc"], d, 1, f"stencil_apply<{d},1>^T",
         r"stencil_apply_kernel<1, ?1, ?" + str(d) + ">",
         "glimslib_tpu/ops/stencil_pallas.py:151"),
    ):
        WT = sk._transposed(offs, W, form, h)
        y = f32(n, d_out) if d_out > 1 else f32(n)
        W4 = W.reshape(len(offs), d_out, d_in, n)
        A_T = _csr_T(torch, _csr(torch, offs, [(W4, 1.0, 0)], n, d_out, d_in, m * d_in, h))
        yf = y.reshape(-1)
        row = _apply_row(torch, name + suffix, kern, plain, (form, offs, WT, y),
                         lambda A_T=A_T, yf=yf: torch.mv(A_T, yf), (m, d_in) if d_in > 1
                         else (m,), (), pattern,
                         4 * (WT.numel() + y.numel() + m * d_in), 2 * WT.numel(),
                         replaces, tag, cold)
        if row["max_abs_err"] != 0.0:
            raise AssertionError(f"{tag} {name}: not bit-equal to its plain version "
                                 f"(max abs err {row['max_abs_err']:.3e})")
        row["form"] = form
        rows.append(row)
        del A_T
    WT = sk._transposed(offs, aug["_Wel"], "vector", h)
    y = f32(n, d)
    err, rel = _rel_max(kern("vector", offs, WT, y), plain("vector", offs, WT, y))
    print(f"{tag} stencil_apply<{d},{d}>^T{suffix} (not on the path): max abs err "
          f"{err:.3e} against its plain version")
    if err != 0.0:
        raise AssertionError(f"{tag} stencil_apply<{d},{d}>^T: max abs err {err:.3e}")
    return rows


def _nodes_adjoint_world1(torch, sim, dev, vg):
    """[14c]: value_and_grad of [9a]'s lattice problem (``vg``: its
    targets, v0 and f64 J and gradient) on the 'nodes' model of [14a] at
    world 1, f32 refined, N_STEPS steps: a first call, one call with the
    counts at 0 split at the backward's start (launches by wrapper and the
    transposed launches by form; no stencil_pcg, no plain stencil call),
    device busy and idle share of one call, J and the gradient against the
    f64 ones; then the transposed launches held and timed at the slab's
    shapes.  Returns its numbers and the kernel rows."""
    import numpy as np

    from glimslib_tpu_torch.examples import REFINED_STEP_CONFIG
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    tag = "[14c] world 1:"
    t_phase = time.perf_counter()
    names, update = param_map_for_type(2)
    v0 = vg["v0"]

    def problem(cfg):
        sim.step_config = cfg
        return InverseProblem(sim, names, vg["targets"], update_fn=update,
                              n_steps=N_STEPS, dt=1.0)

    def rel(J, g):
        return (abs(J - vg["J64"]) / abs(vg["J64"]),
                float(np.linalg.norm(g - vg["g64"]) / np.linalg.norm(vg["g64"])))

    t0 = time.perf_counter()
    J0, g0 = problem(REFINED_STEP_CONFIG).value_and_grad(v0)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    rel0 = rel(J0, g0)
    print(f"{tag} value_and_grad of [9a]'s lattice problem at REFINED_STEP_CONFIG "
          f"(newton_atol {REFINED_STEP_CONFIG.newton_atol}): first call {first_s:.3f} s; "
          f"J {J0:.6e}, gradient {g0.tolist()}; rel err J {rel0[0]:.3e} (<= "
          f"{ADJ_J_RTOL['unstructured']}, the warm-started lanes' limit: NODES_VG_STEPS' "
          f"note), rel-L2 gradient {rel0[1]:.3e} (<= {ADJ_G_RTOL['lattice']})")
    if rel0[0] > ADJ_J_RTOL["unstructured"] or rel0[1] > ADJ_G_RTOL["lattice"]:
        raise AssertionError(f"{tag} at REFINED_STEP_CONFIG against f64: {rel0}")
    ip = problem(REFINED_STEP_CONFIG._replace(newton_atol=REFINED_NEWTON_ATOL))
    wrappers = _halo_wrappers() + (fc.cg_scalar, fc.cg_vector)
    for w in wrappers:
        w.launches = 0
    vt = ip._param(v0, True)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    with _PlainCalls() as plain, _Collectives() as coll, _Transposed() as tr:
        h0 = time.perf_counter()
        ev[0].record()
        with torch.enable_grad():
            J_t = ip._objective(vt)
        ev[1].record()
        fwd = {w: w.launches for w in wrappers}
        coll_fwd, tr_fwd = coll.count, dict(tr.calls)
        (g_t,) = torch.autograd.grad(J_t, vt)
        ev[2].record()
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - h0) * 1e3
    J, g = float(J_t.detach()), g_t.cpu().numpy().astype(np.float64)
    bwd = {w: w.launches - fwd[w] for w in wrappers}
    info = {k: [int(i) for i in v] for k, v in sim.solver_info.items()}
    fwd_ms, bwd_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    _, busy, idle = _print_breakdown(torch, lambda: ip.value_and_grad(v0), call_ms, tag)
    rel_J, rel_g = rel(J, g)
    print(f"{tag} value_and_grad of [9a]'s lattice problem (f32 refined, {N_STEPS} steps, "
          f"newton_atol {REFINED_NEWTON_ATOL}) on the 'nodes' model: J {J:.6e}, gradient "
          f"{g.tolist()}; against the f64 plain path J {vg['J64']:.6e}, gradient "
          f"{np.asarray(vg['g64']).tolist()}: rel err J {rel_J:.3e} (<= "
          f"{ADJ_J_RTOL['lattice']}), rel-L2 gradient {rel_g:.3e} (<= "
          f"{ADJ_G_RTOL['lattice']})")
    print(f"{tag} one call {call_ms:.1f} ms (host), forward {fwd_ms:.3f} / backward "
          f"{bwd_ms:.3f} ms (CUDA events); launches forward / backward: " + ", ".join(
              f"{w.__name__}={fwd[w]}/{bwd[w]}" for w in wrappers)
          + f"; of them the backward's transposed halo launches by form "
          f"{ {k: v - tr_fwd.get(k, 0) for k, v in tr.calls.items()} }; plain stencil "
          f"calls {plain.calls}; collectives {coll_fwd} / {coll.count - coll_fwd} (NCCL "
          f"world 1: every reduction, no halo band); adjoint CG iterations rd "
          f"{info['rd_adj_cg_iters']}, elasticity {info['el_adj_cg_iters']}")
    t_back = {k: v - tr_fwd.get(k, 0) for k, v in tr.calls.items()}
    missing = [f for f in NODES_T_FORMS if t_back.get(f, 0) < 1]
    if (missing or plain.calls or fwd[fc.cg_scalar] + bwd[fc.cg_scalar]
            + fwd[fc.cg_vector] + bwd[fc.cg_vector]):
        raise AssertionError(f"{tag} transposed forms not launched {missing}, plain "
                             f"calls {plain.calls}, or stencil_pcg launched")
    if rel_J > ADJ_J_RTOL["lattice"] or rel_g > ADJ_G_RTOL["lattice"]:
        raise AssertionError(f"{tag} against f64: J {rel_J:.3e}, gradient {rel_g:.3e}")
    aug = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    rows = _transposed_rows(torch, sim, aug, dev, "[14c]", f" halo@N={N} slab")
    for row in rows:
        row["launches"] = t_back[row["form"]]
    del aug
    out = dict(first_s=first_s, call_ms=call_ms, forward_ms=fwd_ms, backward_ms=bwd_ms,
               device_busy_ms=busy, idle_share=idle, J=J, g=g, rel_J=rel_J, rel_grad=rel_g,
               refined_config_rel=rel0,
               launches_forward={w.__name__: fwd[w] for w in wrappers},
               launches_backward={w.__name__: bwd[w] for w in wrappers},
               transposed_backward=t_back, collectives=(coll_fwd, coll.count - coll_fwd),
               adjoint_cg={"rd": info["rd_adj_cg_iters"], "el": info["el_adj_cg_iters"]})
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[14c] {out['seconds']:.1f} s")
    return out, rows


def _nodes_halo_check(torch, sim, dev, tag):
    """Every halo form against its plain version at this rank's slab
    shapes (the path's planes, random vectors from a seed), untimed: max
    rel by form."""
    import numpy as np

    from glimslib_tpu_torch.ops import stencil_kernels as sk

    aug = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    offs, h = sim._stencil_ops.offsets, sim._halo_rows
    n, d = aug["_Wel"].shape[-1], aug["_Wel"].shape[1]
    rng = np.random.default_rng(2)
    f32 = lambda *s: torch.as_tensor(rng.standard_normal(s), dtype=torch.float32,  # noqa: E731
                                     device=dev)
    v, v2, u = f32(n + 2 * h), f32(n + 2 * h), f32(n + 2 * h, d)
    terms = ((aug["_Wrd_const"], v, 1.0), (aug["_Mst"], v, 0.5), (aug["_Mst"], v2, -1.0))
    out = {}
    for name, kern, plain, args in (
        ("<1,1>", sk.apply_scalar, sk.apply_scalar_plain, (offs, aug["_Wrd_const"], v)),
        (f"<{d},{d}>", sk.apply_vector, sk.apply_vector_plain, (offs, aug["_Wel"], u)),
        (f"<{d},1>", sk.apply_coupling, sk.apply_coupling_plain, (offs, aug["_Cuc"], v)),
        ("<1,1,3>", sk.apply_scalar_sum, sk.apply_scalar_sum_plain,
         (offs, terms, aug["_rd_load"])),
    ):
        _, rel = _rel_max(kern(*args, halo=h), plain(*args, halo=h))
        if rel > APPLY_RTOL:
            raise AssertionError(f"{tag} halo form {name}: rel err {rel:.3e}")
        out[name] = rel
    return out, {k: (tuple(aug[k].shape), aug[k].numel() * aug[k].element_size())
                 for k in NODES_PLANES + ("_rd_diag",)}


def _nodes_world1(torch, dev, lat_ref, kernels, vg):
    """[14a]: world 1 over NCCL in this process on the N=32 box under
    use_sharding() (auto: 'nodes'; one model, set up once), 5 steps at the
    bench config and at [9a]'s refined config, each against the f64 plain path and beside the
    unsharded model's Newton and CG counts; every halo form launched on
    the bench run is held and timed at the slab's shapes (as [2]).
    Returns its numbers; ``kernels`` gains the halo-form rows."""
    import tempfile

    import torch.distributed as dist

    from glimslib_tpu_torch.examples import BENCH_STEP_CONFIG, REFINED_STEP_CONFIG
    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.parallel import make_device_mesh

    u_r, c_r = lat_ref
    out, rows = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_device_mesh(device=dev)
            whole = brain_sim(n=N, dtype=torch.float32, device=dev)
            t0 = time.perf_counter()
            sim = brain_sim(n=N, dtype=torch.float32, device=dev)
            sim.use_sharding(mesh)
            if sim.sharding_mode != "nodes":
                raise AssertionError(f"[14a] sharding mode {sim.sharding_mode}")
            setup_s = time.perf_counter() - t0
            for label, cfg in (("bench", BENCH_STEP_CONFIG),
                               ("refined", REFINED_STEP_CONFIG)):
                tag = f"[14a] {label}, world 1:"
                whole.step_config = cfg
                _, _, ok_w, newton_w = whole.build_simulate_fn(N_STEPS, 1.0)(
                    whole.make_theta(whole.params.as_dict()), *whole.initial_state())
                counts_w = dict(newton=newton_w.tolist(), newton_total=int(newton_w.sum()),
                                rd_cg=[int(i) for i in whole.solver_info["rd_cg_iters"]],
                                el_cg=[int(i) for i in whole.solver_info["el_cg_iters"]])
                sim.step_config = cfg
                simulate = sim.build_simulate_fn(N_STEPS, 1.0)
                theta = sim.make_theta(sim.params.as_dict())
                args = (theta,) + tuple(sim.initial_state())
                with _PlainCalls() as plain, _Collectives() as coll:
                    (u_tr, c_tr), launches, first_s = _drive(
                        torch, sim, simulate, args, _nodes_groups(cfg.refine_f64), tag,
                        N_STEPS, shown=_halo_wrappers() + (fc.cg_scalar, fc.cg_vector))
                if launches[fc.cg_scalar] or launches[fc.cg_vector] or plain.calls:
                    raise AssertionError(f"{tag} stencil_pcg launches or plain calls: "
                                         f"{launches}, {plain.calls}")
                # one rd solve a Newton iteration: their count is Newton's
                rd_cg = [int(i) for i in sim.solver_info["rd_cg_iters"]]
                counts = dict(newton_total=len(rd_cg), rd_cg=rd_cg,
                              el_cg=[int(i) for i in sim.solver_info["el_cg_iters"]])
                if label == "bench":
                    _, run = _time_runs(torch, simulate, args, dev, tag, N_STEPS)
                else:  # the first run's rate (timed runs for the bench config only)
                    run = dict(first_run_steps_per_s=N_STEPS / first_s)
                run.update(collectives=coll.count, collective_ms=coll.ms)
                rel = (_rel_l2(c_tr[-1], c_r), _rel_l2(u_tr[-1], u_r))
                slab = sim._node_slab
                print(f"{tag} mode nodes, {slab.n_own} rows owned of {slab.n_total}, halo "
                      f"{slab.halo}; set-up {setup_s:.1f} s; first run {N_STEPS / first_s:.3f} "
                      f"steps/s with {coll.count} collectives (NCCL, {coll.ms:.1f} ms of "
                      f"host time in all, {coll.ms / max(coll.count, 1):.3f} ms each); "
                      f"stencil_pcg launches 0, plain "
                      f"stencil calls {plain.calls}; vs the f64 plain path rel-L2 c "
                      f"{rel[0]:.3e}, u {rel[1]:.3e} (<= {SLICE_RTOL}); the unsharded "
                      f"model (whole-solve stencil_pcg, no warm starts): Newton "
                      f"{counts_w['newton']}, rd CG {counts_w['rd_cg']}, elasticity CG "
                      f"{counts_w['el_cg']}")
                if max(rel) > SLICE_RTOL or not bool(ok_w.all()):
                    raise AssertionError(f"{tag} vs f64 plain: {rel}")
                out[label] = dict(run, setup_s=setup_s, first_s=first_s, rel_vs_f64=rel,
                                  launches={w.__name__: n for w, n in launches.items()},
                                  cg=counts, unsharded_cg=counts_w, n_own=slab.n_own,
                                  halo=slab.halo)
                if label == "bench":
                    aug = sim._augment_theta_with_operators(theta)
                    wc = sim._stencil_ops.build_rd_wc(sim._halo(args[2])[0], aug["rho"],
                                                      aug["dt"])
                    rows = phase_applies(torch, sim._stencil_ops.offsets, aug, wc, dev,
                                         "[14a]", f" halo@N={N} slab", halo=slab.halo)
                    for row in rows:
                        row["launches"] = sum(launches[w] for w in row["wrappers"])
                        row["launches_by_wrapper"] = {w.__name__: launches[w]
                                                      for w in row["wrappers"]}
                    del aug, wc
                else:
                    for row in rows:
                        row["launches_refined"] = sum(launches[w] for w in row["wrappers"])
                del simulate, theta, args, u_tr, c_tr
            del whole
            out["adjoint"], rows_T = _nodes_adjoint_world1(torch, sim, dev, vg)
            del sim
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    kernels += rows + rows_T
    return out, rows, rows_T


def _rank14b(mesh, cfg, vg):
    """[14b]'s work on one rank: the N=32 box padded for the world, under
    use_sharding() at ``cfg``, N_STEPS steps with the counts at 0 just
    before (the halo forms' launches; the collectives, by a timer around
    torch.distributed.all_reduce), a profiled run of NODES_PROFILE_STEPS
    steps a rank, the halo forms against their plain versions at the
    slab's shapes, the plane bytes (rank 0: also the unsharded padded
    model's, for the same keys).  Then [14d] in the same processes: one
    value_and_grad of NODES_VG_STEPS steps on ``vg`` = (the whole padded
    targets, v0, its step config) with the counts at 0 just before (launches
    by wrapper, the transposed launches by form, the collectives), its J,
    gradient and CG counts."""
    import torch

    from glimslib_tpu_torch.core.mesh import box_mesh, pad_mesh_nodes
    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.parallel import gather_nodes

    dev = mesh.device
    box = pad_mesh_nodes(box_mesh((0, 0, 0), (10, 10, 10), N, N, N), mesh.world)
    whole_bytes = None
    if mesh.rank == 0:
        whole = brain_sim(dtype=torch.float32, device=dev, mesh=box)
        whole._build_step()
        aug_w = whole._augment_theta_with_operators(whole.make_theta(whole.params.as_dict()))
        whole_bytes = sum(aug_w[k].numel() * aug_w[k].element_size() for k in NODES_PLANES)
        del whole, aug_w
    t0 = time.perf_counter()
    sim = brain_sim(dtype=torch.float32, device=dev, mesh=box)
    sim.step_config = cfg
    sim.use_sharding(mesh)
    simulate = sim.build_simulate_fn(N_STEPS, 1.0)
    theta = sim.make_theta(sim.params.as_dict())
    args = (theta,) + tuple(sim.initial_state())
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    wrappers = _halo_wrappers() + (fc.cg_scalar, fc.cg_vector)
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _PlainCalls() as plain, _Collectives() as coll:
        u_tr, c_tr, ok, newton = simulate(*args)
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in wrappers}
    info = dict(sim.solver_info)
    short = sim.build_simulate_fn(NODES_PROFILE_STEPS, 1.0)
    wall, busy = _rank_busy(torch, mesh, lambda: short(*args), profiled=(0,))
    checked, planes = _nodes_halo_check(torch, sim, dev, f"[14b] rank {mesh.rank}")
    slab = sim._node_slab
    vg_out = _rank14d(torch, mesh, sim, vg)
    return dict(vg=vg_out,
        n_own=slab.n_own, n_total=slab.n_total, halo=slab.halo, setup_s=setup_s,
        run_s=run_s, ok=bool(ok.all()), newton=newton.tolist(),
        rd_cg=[int(i) for i in info["rd_cg_iters"]],
        el_cg=[int(i) for i in info["el_cg_iters"]],
        fix_cg=[int(i) for i in info["el_refine_cg_iters"]],
        launches=launches, plain_calls=plain.calls, collectives=coll.count,
        collective_ms=coll.ms, wall_ms=wall, busy_ms=busy, checked=checked,
        planes=planes, plane_bytes=sum(planes[k][1] for k in NODES_PLANES),
        whole_bytes=whole_bytes,
        u=gather_nodes(mesh, slab, u_tr[-1]).cpu().numpy(),
        c=gather_nodes(mesh, slab, c_tr[-1]).cpu().numpy())


def _rank14d(torch, mesh, sim, vg):
    """[14d] on one rank (:func:`_rank14b`)."""
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    targets, v0, sim.step_config = vg
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=NODES_VG_STEPS,
                        dt=1.0)
    wrappers = _halo_wrappers() + (fc.cg_scalar, fc.cg_vector)
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _PlainCalls() as plain, _Collectives() as coll, _Transposed() as tr:
        J, g = ip.value_and_grad(v0)
        torch.cuda.synchronize()
    info = {k: [int(i) for i in v] for k, v in sim.solver_info.items()}
    return dict(J=J, g=g, s=time.perf_counter() - t0, plain_calls=plain.calls,
                launches={w.__name__: w.launches for w in wrappers},
                transposed=dict(tr.calls), collectives=coll.count, collective_ms=coll.ms,
                counts=info)


def _nodes_vg_report(ranks, ref, tag="[14d]"):
    """[14d]'s checks on the ranks' value_and_grad (``ref`` = the f64
    plain path's J and gradient at NODES_VG_STEPS steps): J and the
    gradient bit-equal on every rank, the same forward and adjoint CG
    counts, the transposed forms launched, no stencil_pcg and no plain
    stencil call, J and the gradient within the lattice limits of f64."""
    import numpy as np

    J64, g64 = ref
    rows = []
    for r, o in enumerate(ranks):
        v = o["vg"]
        rel_J = abs(v["J"] - J64) / abs(J64)
        rel_g = float(np.linalg.norm(v["g"] - g64) / np.linalg.norm(g64))
        per = v["collective_ms"] / max(v["collectives"], 1)
        print(f"{tag} rank {r}: value_and_grad ({NODES_VG_STEPS} refined steps, newton_atol "
              f"{REFINED_NEWTON_ATOL}) "
              f"{v['s']:.2f} s: J {v['J']:.9e}, gradient {v['g'].tolist()}; vs the f64 "
              f"plain path J {J64:.9e}, gradient {np.asarray(g64).tolist()}: rel err J "
              f"{rel_J:.3e} (<= {ADJ_J_RTOL['lattice']}), gradient {rel_g:.3e} (<= "
              f"{ADJ_G_RTOL['lattice']}); CG rd {v['counts']['rd_cg_iters']}, elasticity "
              f"{v['counts']['el_cg_iters']}, adjoint rd {v['counts']['rd_adj_cg_iters']}, "
              f"elasticity {v['counts']['el_adj_cg_iters']}; launches {v['launches']}, "
              f"transposed by form {v['transposed']}, plain stencil calls "
              f"{v['plain_calls']}; collectives {v['collectives']}, "
              f"{v['collective_ms']:.1f} ms in all, {per:.3f} ms each (host clock, gloo)")
        missing = [f for f in NODES_T_FORMS if v["transposed"].get(f, 0) < 1]
        if (missing or v["plain_calls"] or v["launches"]["cg_scalar"]
                or v["launches"]["cg_vector"]):
            raise AssertionError(f"{tag} rank {r}: transposed forms not launched "
                                 f"{missing}, or plain calls or stencil_pcg: {v}")
        if rel_J > ADJ_J_RTOL["lattice"] or rel_g > ADJ_G_RTOL["lattice"]:
            raise AssertionError(f"{tag} rank {r}: J {rel_J:.3e}, gradient {rel_g:.3e}")
        rows.append(dict({k: v[k] for k in ("J", "s", "launches", "transposed",
                                              "collectives", "collective_ms")},
                         g=v["g"].tolist(), rel_J=rel_J, rel_grad=rel_g,
                         ms_per_collective=per))
    v0 = ranks[0]["vg"]
    same = all(o["vg"]["J"] == v0["J"] and np.array_equal(o["vg"]["g"], v0["g"])
               for o in ranks)
    counts = all(o["vg"]["counts"] == v0["counts"] for o in ranks)
    print(f"{tag} J and gradient bit-equal on every rank: {same}; forward and adjoint "
          f"CG counts equal on every rank: {counts}")
    if not (same and counts):
        raise AssertionError(f"{tag} the ranks differ: J/gradient {same}, counts {counts}")
    return dict(ranks=rows, bit_equal=same, counts_equal=counts)


def _nodes_rank_args(vg):
    """:func:`_rank14b`'s arguments: [9a]'s refined config, and ``vg``'s
    (the lattice value_and_grad's) targets zero-padded to the padded box,
    v0 and the config at newton_atol REFINED_NEWTON_ATOL."""
    import numpy as np

    from glimslib_tpu_torch.examples import REFINED_STEP_CONFIG

    n_real = (N + 1) ** 3
    # pad_mesh_nodes pads whole planes of the slowest axis
    n_pad = -(-(N + 1) // NODES_WORLD) * NODES_WORLD * (N + 1) ** 2
    targets = {k: np.concatenate([v, np.zeros((n_pad - n_real,) + v.shape[1:], v.dtype)])
               for k, v in vg["targets"].items()}
    return (REFINED_STEP_CONFIG, (targets, vg["v0"], REFINED_STEP_CONFIG._replace(
        newton_atol=REFINED_NEWTON_ATOL)))


def _nodes_two_ranks(torch, dev, lat_ref, vg, ranks, wall_s):
    """[14b]: NODES_WORLD ranks sharing the card over gloo, [9a]'s refined
    config, N_STEPS steps (module docstring), from their results ``ranks``
    ([13b]'s spawn; the work took ``wall_s`` seconds there); returns its
    numbers and the halo forms' launches summed over the ranks."""
    import numpy as np

    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type

    u_r, c_r = (x.cpu().numpy() for x in lat_ref)
    n_real = N_NODES = (N + 1) ** 3
    # [14d]'s reference: the f64 plain path unpadded on the same targets
    t0 = time.perf_counter()
    ref = brain_sim(n=N, dtype=torch.float64, device=dev, plain=True)
    names, update = param_map_for_type(2)
    J64, g64 = InverseProblem(ref, names, vg["targets"], update_fn=update,
                              n_steps=NODES_VG_STEPS, dt=1.0).value_and_grad(vg["v0"])
    del ref
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t0
    whole_bytes = ranks[0]["whole_bytes"]
    rows = []
    for r, o in enumerate(ranks):
        tag = f"[14b] rank {r}:"
        rel = (float(np.linalg.norm(o["c"][:n_real] - c_r) / np.linalg.norm(c_r)),
               float(np.linalg.norm(o["u"][:n_real] - u_r) / np.linalg.norm(u_r)))
        pad = max(float(np.abs(o["c"][n_real:]).max()), float(np.abs(o["u"][n_real:]).max()))
        idle = max(0.0, 1 - o["busy_ms"] / o["wall_ms"]) if o["busy_ms"] else None
        per = o["collective_ms"] / max(o["collectives"], 1)
        print(f"{tag} rows [{r * o['n_own']}, {(r + 1) * o['n_own']}) of {o['n_total']} "
              f"({N_NODES} real), halo {o['halo']} rows a side; plane bytes "
              f"{o['plane_bytes'] / 1e6:.3f} MB against the unsharded padded model's "
              f"{whole_bytes / 1e6:.3f} MB ({o['plane_bytes'] / whole_bytes:.4f}; "
              + ", ".join(f"{k} {o['planes'][k][0]}" for k in ("_Wel", "_Wrd_const"))
              + f"); set-up {o['setup_s']:.1f} s")
        print(f"{tag} {N_STEPS} steps in {o['run_s']:.2f} s: Newton {o['newton']}, rd CG "
              f"{o['rd_cg']}, elasticity CG {o['el_cg']}, correction CG {o['fix_cg']}; "
              f"halo-form launches {o['launches']} (plain stencil calls "
              f"{o['plain_calls']}); collectives {o['collectives']}, "
              f"{o['collective_ms']:.1f} ms in all, {per:.3f} ms each (host clock around "
              f"torch.distributed.all_reduce, gloo)"
              + (f"; a profiled {NODES_PROFILE_STEPS}-step run: device busy "
                 f"{o['busy_ms']:.1f} ms of {o['wall_ms']:.1f} ms, idle "
                 + (f"{100 * idle:.1f}%" if idle is not None else "not measured")
                 if o["wall_ms"] is not None else "; profiled on rank 0 only"))
        print(f"{tag} halo forms vs plain at the slab's shapes, max rel "
              + ", ".join(f"{k} {v:.2e}" for k, v in o["checked"].items())
              + f"; final c, u on the real nodes vs the f64 plain path rel-L2 "
              f"{rel[0]:.3e}, {rel[1]:.3e} (<= {SLICE_RTOL}); padding dofs max |x| {pad}")
        if not o["ok"] or max(rel) > SLICE_RTOL or pad != 0.0:
            raise AssertionError(f"{tag} ok {o['ok']}, rel {rel}, padding {pad}")
        if o["plain_calls"] or o["launches"]["cg_scalar"] or o["launches"]["cg_vector"]:
            raise AssertionError(f"{tag} plain calls or stencil_pcg launches: {o}")
        missing = [g[0].__name__ for g in _nodes_groups(True)
                   if o["launches"][g[0].__name__] < 1]
        if missing or o["plane_bytes"] * NODES_WORLD != whole_bytes:
            raise AssertionError(f"{tag} not launched {missing}, bytes "
                                 f"{o['plane_bytes']} vs {whole_bytes}")
        rows.append(dict({k: v for k, v in o.items() if k not in ("u", "c", "planes", "vg")},
                         rel_vs_f64=rel, idle_share=idle, ms_per_collective=per))
    same = all(ranks[0][k] == o[k] for o in ranks for k in ("newton", "rd_cg", "el_cg",
                                                             "fix_cg"))
    print(f"[14b] Newton and CG counts equal on every rank: {same}; {NODES_WORLD} ranks "
          f"(gloo, sharing the card) {wall_s:.1f} s on the ranks, in [13b]'s spawn")
    if not same:
        raise AssertionError("[14b] the ranks took different solver paths")
    launches, transposed = {}, {}
    for o in ranks:
        for k, v in o["launches"].items():
            launches[k] = launches.get(k, 0) + v
        for k, v in o["vg"]["transposed"].items():
            transposed[k] = transposed.get(k, 0) + v
    t0 = time.perf_counter()
    vg_out = _nodes_vg_report(ranks, (J64, g64))
    vg_out.update(f64_reference_s=ref_s)
    print(f"[14d] f64 plain reference ({NODES_VG_STEPS} steps) {ref_s:.1f} s")
    return (dict(ranks=rows, seconds=wall_s, counts_equal=same), vg_out, launches,
            transposed)


def phase_nodes(torch, dev, kernels, lat_ref, vg, ranks):
    """[14]: node sharding of the lattice (module docstring).  ``lat_ref``
    = [3]'s f64 plain final (u, c); ``vg`` = [9a]'s lattice value_and_grad
    (targets, v0, the f64 J and gradient); ``kernels`` gains the halo-form
    rows with their launches in [14a] and [14b], and the transposed rows
    with their launches in [14c]'s backward and [14d]'s; ``ranks`` = [14b]'s
    rank results and their seconds (:func:`phase_shard`)."""
    t_phase = time.perf_counter()
    out = {}
    out["world1"], rows, rows_T = _nodes_world1(torch, dev, lat_ref, kernels, vg)
    out["world1_s"] = time.perf_counter() - t_phase
    print(f"[14a] and [14c] {out['world1_s']:.1f} s")
    out["two_ranks"], out["value_and_grad_two_ranks"], launches, transposed = (
        _nodes_two_ranks(torch, dev, lat_ref, vg, *ranks))
    for row in rows:
        row["launches_14b"] = sum(launches[w.__name__] for w in row["wrappers"])
    for row in rows_T:
        row["launches_14d"] = transposed.get(row["form"], 0)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[14] node sharding phase {out['seconds']:.1f} s")
    return out


# [15]: the matrix-free jvp lane (operator_mode "matrix-free", the quad
# model on a lattice mesh) and the gather residuals of a von Neumann
# influx and a time-dependent source around the lanes' solves.  [15a] and
# [15c] run MF_STEPS steps and [15b] QUAD_MF_STEPS (the jvp lane has no
# kernel to hold, and a P2 jvp is tens of ms on the card).  The jvp lane
# solves the same systems as the assembled lanes, so its state is held to
# the lattice limit SLICE_RTOL against theirs, its J and gradient to the
# lattice limits; [15b]'s quad state to QUAD_RTOL against [10c]'s.
# MF_STEPS was cut from 2 to fit [16], which profiles the jvp lane on the
# unstructured box of the same cells; [15a] and [15b] run unprofiled for
# it too (their breakdowns stand in PERF.md §5).
MF_STEPS = 1
# [10c] keeps its state after SHARD_QUAD_STEPS steps for [13b]
QUAD_MF_STEPS = SHARD_QUAD_STEPS
MF_KERNEL = r"stencil_apply|stencil_pcg|bell_bmv"


def _mf_run(torch, sim, tag, n_steps, profiled=True):
    """One run of ``sim``'s simulate with every kernel wrapper's count at
    0, then (``profiled``) one profiled run: the trajectory, the launches
    (all must be 0), the kernels in the profile matching MF_KERNEL (must
    be none), the Newton and CG counts by block, steps/s, busy ms and
    idle share."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    wrappers = [w for g in _lattice_groups() for w in g] + [bk.batched_matvec]
    args = (sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    simulate = sim.build_simulate_fn(n_steps, 1.0)
    (u_tr, c_tr), launches, first_s = _drive(torch, sim, simulate, args, [], tag,
                                             n_steps, shown=wrappers)
    info = {k: [int(i) for i in v] for k, v in sim.solver_info.items() if v}
    hits, busy, idle = None, None, None
    t0 = time.perf_counter()
    if profiled:
        hits, busy, idle = _print_breakdown(torch, lambda: simulate(*args),
                                            1e3 * first_s, tag, MF_KERNEL)
    prof_s = time.perf_counter() - t0
    sps = n_steps / first_s
    print(f"{tag} steps/s {sps:.4f} (the first run's {first_s:.3f} s); lattice and "
          f"halo-ELL kernels: wrapper launches {sum(launches.values())}"
          + ("" if hits is None else f", kernels matching {MF_KERNEL!r} in the profiled "
             f"run {sorted(hits)} (its run and processing {prof_s:.1f} s)"))
    if sum(launches.values()) or hits:
        raise AssertionError(f"{tag} the matrix-free lane launched kernels: {launches}, "
                             f"{hits} in the profile")
    return (u_tr, c_tr), dict(steps_per_s=sps, first_s=first_s, device_busy_ms=busy,
                              idle_share=idle, launches=0,
                              profiler_kernels=None if hits is None else len(hits),
                              cg_iters=info)


def _mf_lattice(torch, dev, lat, keep):
    """[15a]: the P1 brain box on the matrix-free lane, MF_STEPS steps at
    the benchmark's StepConfig and at REFINED_STEP_CONFIG, against the
    auto lane's state after as many steps ([3]'s and [9a]'s runs, from
    ``keep``); one value_and_grad of [7]'s problem at MF_STEPS steps on
    both lanes (the auto lane's on [3]'s model ``lat``)."""
    import numpy as np

    from glimslib_tpu_torch.examples import (
        BENCH_STEP_CONFIG, REFINED_STEP_CONFIG, adjoint_problem, brain_sim)
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem

    t0 = time.perf_counter()
    mf = brain_sim(n=N, dtype=torch.float32, device=dev)
    mf.operator_mode = "matrix-free"
    torch.cuda.synchronize()
    print(f"[15a] N={N} matrix-free model set-up {time.perf_counter() - t0:.1f} s")
    out = {}
    for name, cfg in (("bench", BENCH_STEP_CONFIG), ("refined", REFINED_STEP_CONFIG)):
        tag = f"[15a] matrix-free {name}:"
        mf.step_config = cfg
        # unprofiled (cut from the bench run's breakdown to fit [16])
        (u_tr, c_tr), nums = _mf_run(torch, mf, tag, MF_STEPS, profiled=False)
        want = keep[f"lattice_{name}_{MF_STEPS}"]
        source = "[3]" if name == "bench" else "[9a]"
        rel_c, rel_u = _rel_l2(c_tr[-1], want[1]), _rel_l2(u_tr[-1], want[0])
        print(f"{tag} against the auto lane after {MF_STEPS} steps ({source}): "
              f"rel-L2 c {rel_c:.3e}, u {rel_u:.3e} (<= {SLICE_RTOL})")
        if max(rel_c, rel_u) > SLICE_RTOL:
            raise AssertionError(f"{tag} c {rel_c:.3e}, u {rel_u:.3e}")
        out[name] = dict(nums, rel_c=rel_c, rel_u=rel_u)
        del u_tr, c_tr

    # value_and_grad of [7]'s problem (its targets) at MF_STEPS steps
    lat.step_config = BENCH_STEP_CONFIG
    ip7, v0 = adjoint_problem(sim=lat)
    mf.step_config = BENCH_STEP_CONFIG
    got = {}
    for lane, sim_ in (("assembled", lat), ("matrix-free", mf)):
        ip = InverseProblem(sim_, ip7.param_names, ip7.targets, update_fn=ip7.update_fn,
                            n_steps=MF_STEPS, dt=ip7.dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        J, g = ip.value_and_grad(v0)
        torch.cuda.synchronize()
        got[lane] = (J, g, time.perf_counter() - t0, {
            k: [int(i) for i in sim_.solver_info[k]]
            for k in ("rd_adj_cg_iters", "el_adj_cg_iters")})
    (J_a, g_a, s_a, _), (J, g, s_mf, adj) = got["assembled"], got["matrix-free"]
    rel_J = abs(J - J_a) / abs(J_a)
    rel_g = float(np.linalg.norm(g - g_a) / np.linalg.norm(g_a))
    print(f"[15a] value_and_grad at {MF_STEPS} steps: matrix-free J {J:.8e}, gradient "
          f"{g.tolist()} ({s_mf:.2f} s; adjoint CG {adj}); assembled J {J_a:.8e}, "
          f"gradient {g_a.tolist()} ({s_a:.2f} s); rel J {rel_J:.3e} (<= "
          f"{ADJ_J_RTOL['lattice']}), rel-L2 gradient {rel_g:.3e} (<= "
          f"{ADJ_G_RTOL['lattice']})")
    if rel_J > ADJ_J_RTOL["lattice"] or rel_g > ADJ_G_RTOL["lattice"]:
        raise AssertionError(f"[15a] value_and_grad: J {rel_J:.3e}, gradient {rel_g:.3e}")
    out["value_and_grad"] = dict(J=J, J_assembled=J_a, rel_J=rel_J, rel_grad=rel_g,
                                 seconds=s_mf, seconds_assembled=s_a, adjoint_cg_iters=adj)
    return out


def _mf_quad(torch, dev, keep):
    """[15b]: the quad brain model on the N=32 lattice box (the jvp lane),
    QUAD_MF_STEPS refined steps, c against [10c]'s stripped-mesh run at
    the same config (``keep``; the P2 dofs of both meshes share one
    order: the Morton order of their coordinates)."""
    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.models.base import default_step_config

    t0 = time.perf_counter()
    sim = brain_sim(n=N, dtype=torch.float32, device=dev, quad=True)
    sim.step_config = default_step_config(torch.float32)
    u0, c0 = sim.initial_state()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"[15b] quad N={N} lattice: {sim.p2.n_dofs} P2 dofs, {sim.mesh.n_cells} tets; "
          f"matrix-free {sim.matrix_free}; set-up {setup_s:.2f} s (model, P2 layout and "
          f"the IV projection; no plan)")
    if not sim.matrix_free or sim.p2.n_dofs != (2 * N + 1) ** 3:
        raise AssertionError(f"[15b] quad lattice model: {sim.p2.n_dofs} dofs")
    # unprofiled (cut from a breakdown to fit [16])
    (u_tr, c_tr), nums = _mf_run(torch, sim, "[15b] quad matrix-free refined:",
                                 QUAD_MF_STEPS, profiled=False)
    rel_c = _rel_l2(c_tr[-1], keep["quad"]["final"][1])
    rel_f64 = _rel_l2(c_tr[-1], keep["quad"]["ref"][1])
    print(f"[15b] quad matrix-free refined: c after {QUAD_MF_STEPS} step(s) against "
          f"[10c]'s on the stripped Morton mesh: rel-L2 {rel_c:.3e} (<= {QUAD_RTOL}); "
          f"against [10b]'s f64 plain path {rel_f64:.3e}; step s "
          f"{nums['first_s'] / QUAD_MF_STEPS:.2f}")
    if rel_c > QUAD_RTOL:
        raise AssertionError(f"[15b] c {rel_c:.3e}")
    return dict(nums, setup_s=setup_s, rel_c=rel_c, rel_c_f64=rel_f64,
                p2_dofs=sim.p2.n_dofs)


def _influx(torch, dev, kernels, kern):
    """[15c]: examples.influx_sim on the N=32 lattice (stencil_pcg<1>/<3>)
    and on the n=32 unstructured box (bell_bmv), f32 refined, MF_STEPS
    steps each, held to the lane's limit against the plain f64 path;
    every kernel row of the lane gains its launches there."""
    from glimslib_tpu_torch.examples import influx_sim
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    out = {}
    lat_rows = [k for k in kernels if "@" not in k["name"] and k["name"] != "bell_bmv"]
    for lane, kw, limit in (("lattice", {}, SLICE_RTOL),
                            ("unstructured", dict(unstructured=True), UNSTRUCT_RTOL)):
        tag = f"[15c] influx {lane}:"
        t0 = time.perf_counter()
        sim = influx_sim(n=N, dtype=torch.float32, device=dev, **kw)
        assert sim.step_config.refine_f64
        theta = sim.make_theta(sim.params.as_dict())
        sim._build_step()  # the stencil operators
        aug = sim._augment_theta_with_operators({**theta, **sim.runtime_aux()})
        streamed = sorted(k for k in ("_Mst", "_Cuc", "_Bell_rd_load", "_Bell_el_load")
                          if k in aug)
        del aug
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        groups = (_forward_groups(sim, _lattice_groups()) if lane == "lattice"
                  else [(bk.batched_matvec,)])
        simulate = sim.build_simulate_fn(MF_STEPS, 1.0)
        args = (theta, *sim.initial_state())
        (u_tr, c_tr), launches, first_s = _drive(
            torch, sim, simulate, args, groups, tag, MF_STEPS,
            shown=[w for g in _lattice_groups() for w in g] + [bk.batched_matvec])
        # the same mesh: its plans are built once
        ref = influx_sim(dtype=torch.float64, device=dev, plain=True, mesh=sim.mesh)
        ref.step_config = StepConfig(newton_rtol=1e-10, newton_atol=1e-14, cg_rtol=1e-12,
                                     cg_maxiter=4000)
        t1 = time.perf_counter()
        u_r, c_r, ok_r, newton_r = ref.build_simulate_fn(MF_STEPS, 1.0)(
            ref.make_theta(ref.params.as_dict()), *ref.initial_state())
        torch.cuda.synchronize()
        rel_c, rel_u = _rel_l2(c_tr[-1], c_r[-1]), _rel_l2(u_tr[-1], u_r[-1])
        print(f"{tag} set-up {setup_s:.1f} s; streamed residual planes {streamed} "
              f"(the rd residual takes the gather form); against the f64 plain path "
              f"({time.perf_counter() - t1:.1f} s, Newton {newton_r.tolist()}): rel-L2 c "
              f"{rel_c:.3e}, u {rel_u:.3e} (<= {limit}); c grew from "
              f"{float(args[2].sum()):.4f} to {float(c_tr[-1].sum()):.4f} (sum)")
        if not bool(ok_r.all()) or max(rel_c, rel_u) > limit:
            raise AssertionError(f"{tag} c {rel_c:.3e}, u {rel_u:.3e}")
        if any(k in streamed for k in ("_Mst", "_Bell_rd_load")):
            raise AssertionError(f"{tag} the rd residual streamed: {streamed}")
        rows = lat_rows if lane == "lattice" else [kern]
        for k in rows:
            k["influx_launches"] = sum(launches[w] for w in k["wrappers"])
        out[lane] = dict(first_s=first_s, steps_per_s=MF_STEPS / first_s, rel_c=rel_c,
                         rel_u=rel_u, streamed=streamed, setup_s=setup_s,
                         launches={w.__name__: n for w, n in launches.items() if n})
        del sim, ref, u_tr, c_tr, u_r, c_r
        torch.cuda.empty_cache()
    return out


def phase_matrix_free(torch, dev, lat, kernels, kern, keep):
    """[15]: the matrix-free lane and the influx (module docstring)."""
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    out["lattice"] = _mf_lattice(torch, dev, lat, keep)
    print(f"[15a] {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["quad"] = _mf_quad(torch, dev, keep)
    print(f"[15b] {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["influx"] = _influx(torch, dev, kernels, kern)
    print(f"[15c] {time.perf_counter() - t0:.1f} s")
    print(f"[15] matrix-free phase {time.perf_counter() - t_phase:.1f} s")
    return out


# [16]: use_sharding(mode="cells") (parallel/shard.py ShardedP1Kernels,
# the native graph partitioner) and mode="nodes" on an unstructured mesh
# (parallel/nodeshard.py), both on the matrix-free jvp lane.  [16a] runs
# SHARD16_STEPS step(s) a mode (cut from 2 to fit [17]: ~3 s a step of
# the jvp lane a mode) at f32 with REFINED_STEP_CONFIG (the
# reference's f32 default: refine_f64); every mode's state is held to
# UNSTRUCT_RTOL against the unsharded model's on the jvp lane.  [16b]
# runs the small padded Morton box (SMALL16_N, 729 nodes padded to 730)
# at f64 with _small16_config() on NODES_WORLD gloo ranks, SMALL16_STEPS
# step(s) (cut from 2: every CG iteration there makes 2-5 collectives
# through the host), in [13b]'s spawn; its J and gradient are held to
# SMALL16_J_RTOL / SMALL16_G_RTOL against the same problem unsharded on
# the jvp lane (one process, world 1: one reference for both modes, cut
# from a world-1 run of each mode over NCCL).
SHARD16_STEPS = 1
SMALL16_STEPS = 1
SMALL16_N = 8
SMALL16_J_RTOL = 1e-8
SMALL16_G_RTOL = 1e-7
SHARD16_MODES = ("nodes", "cells")


def _small16_config():
    """Tight enough that J and the gradients of the two worlds agree
    within 1e-12 (7.7e-16 under 'nodes', 5.5e-13 under 'cells' on an H100
    80GB HBM3 at 700 W), loose enough to keep [16b]'s collectives, 2-3 ms
    each through gloo there, few."""
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    return StepConfig(newton_rtol=1e-8, newton_atol=1e-12, cg_rtol=1e-10)


def _small16_problem(torch, dev):
    """[16b]'s model: brain_sim on the SMALL16_N box made unstructured,
    Morton-ordered and padded for NODES_WORLD ranks, f64, on ``dev``;
    with the whole targets of value_and_grad (type 2), made from its
    initial values (so the same on every rank and at world 1)."""
    import numpy as np

    from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, pad_mesh_nodes
    from glimslib_tpu_torch.examples import brain_sim

    m = box_mesh((0, 0, 0), (10, 10, 10), SMALL16_N, SMALL16_N, SMALL16_N)
    mesh = pad_mesh_nodes(Mesh.from_arrays(m.points, m.cells).reordered_morton(),
                          NODES_WORLD)
    sim = brain_sim(dtype=torch.float64, device=dev, mesh=mesh)
    sim.step_config = _small16_config()
    iv = sim.params.create_initial_value_function()
    c0 = np.asarray(iv[sim.SUBSPACE_CONCENTRATION])
    targets = {"conc_T2": 0.5 * (np.tanh((1.5 * c0 - 0.12) / 0.01) + 1.0),
               "disp": np.zeros_like(np.asarray(iv[sim.SUBSPACE_DISPLACEMENT]))}
    return sim, targets


def _layout16(sim):
    """This rank's share under the model's mode: owned rows, local cells,
    ghosts (real and the padded G) and published rows (real and P) under
    'nodes'; the block's cells and the partitioner under 'cells'."""
    if sim.sharding_mode is None:
        return {}
    k, rank = sim.kernels, sim.device_mesh.rank
    if sim.sharding_mode == "nodes":
        spec = k.spec
        return dict(owned_rows=k.n_own, of_rows=k.n_total, local_cells=k._k.n_cells,
                    ghosts=k._plan.n_ghost, G=spec.G, published=spec.n_pub[rank], P=spec.P)
    return dict(owned_rows=k.n_nodes, of_rows=k.n_nodes, local_cells=len(k.block_cells),
                of_cells=k.n_cells, partitioner=k.part.method)


def _small16_run(torch, sim, targets):
    """The small problem under its mode: SMALL16_STEPS steps (the whole
    final state gathered under 'nodes') and one value_and_grad at
    (0.05, 0.05), each with the collectives counted and timed, and every
    kernel wrapper's launches; returns numpy values."""
    import numpy as np

    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem, param_map_for_type
    from glimslib_tpu_torch.parallel import gather_rows

    wrappers = [w for g in _lattice_groups() for w in g] + [bk.batched_matvec]
    for w in wrappers:
        w.launches = 0
    names, update = param_map_for_type(2)
    ip = InverseProblem(sim, names, targets, update_fn=update, n_steps=SMALL16_STEPS,
                        dt=1.0)
    simulate = sim.build_simulate_fn(SMALL16_STEPS, 1.0)
    theta = sim.make_theta(sim.params.as_dict())
    u0, c0 = sim.initial_state()
    torch.cuda.synchronize()
    with _Collectives() as coll:
        t0 = time.perf_counter()
        u, c, ok, newton = simulate(theta, u0, c0)
        torch.cuda.synchronize()
        fwd_s = time.perf_counter() - t0
        n_fwd, ms_fwd = coll.count, coll.ms
        counts = {k: [int(i) for i in v] for k, v in sim.solver_info.items() if v}
        t0 = time.perf_counter()
        J, g = ip.value_and_grad(np.array([0.05, 0.05]))
        torch.cuda.synchronize()
        vg_s = time.perf_counter() - t0
    u, c = u[-1], c[-1]
    rows = sim._node_rows
    if rows is not None:
        u = gather_rows(sim.device_mesh, u, rows.start, rows.n_total)
        c = gather_rows(sim.device_mesh, c, rows.start, rows.n_total)
    return dict(mode=sim.sharding_mode, ok=bool(ok.all()), newton=newton.tolist(),
                cg=counts, u=u.cpu().numpy(), c=c.cpu().numpy(), J=J, g=g,
                forward_s=fwd_s, value_and_grad_s=vg_s,
                collectives=(n_fwd, coll.count - n_fwd),
                collective_ms=(ms_fwd, coll.ms - ms_fwd),
                launches=sum(w.launches for w in wrappers), layout=_layout16(sim))


def _rank16b(mesh):
    """[16b] on one rank: the small problem under 'nodes', then 'cells'
    (:func:`_small16_run`), with this rank's layout."""
    import torch

    out = {}
    for mode in SHARD16_MODES:
        sim, targets = _small16_problem(torch, mesh.device)
        sim.use_sharding(mesh, mode=mode)
        out[mode] = _small16_run(torch, sim, targets)
        del sim
    return out


def _run16(torch, sim, tag, profiled):
    """One run of SHARD16_STEPS steps of ``sim`` with every kernel
    wrapper's count and the collectives at 0 just before, under the
    profiler (device activity only) where ``profiled`` (one run a mode,
    cut from an unprofiled and a profiled one: its steps/s carry the
    profiler's overhead): the trajectory and its numbers (launches and
    kernels in the profile must be none; busy ms of the run and the idle
    share of its wall)."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    wrappers = [w for g in _lattice_groups() for w in g] + [bk.batched_matvec]
    args = (sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    simulate = sim.build_simulate_fn(SHARD16_STEPS, 1.0)
    got = {}

    def drive():
        got["run"] = _drive(torch, sim, simulate, args, [], tag, SHARD16_STEPS,
                            shown=wrappers)

    with _Collectives() as coll:
        if profiled:
            t0 = time.perf_counter()
            prof = _profile(torch, drive, cpu=False)
            wall_ms = (time.perf_counter() - t0) * 1e3
        else:
            drive()
    (u_tr, c_tr), launches, first_s = got["run"]
    info = {k: [int(i) for i in v] for k, v in sim.solver_info.items() if v}
    hits, busy, idle = None, None, None
    if profiled:
        hits, busy, idle = _print_breakdown(torch, None, 1e3 * first_s, tag, MF_KERNEL,
                                            profiled=(prof, wall_ms),
                                            run_name="the simulate's own")
    per_step = coll.count / SHARD16_STEPS
    each = coll.ms / max(coll.count, 1)
    print(f"{tag} steps/s {SHARD16_STEPS / first_s:.4f} (the first run's {first_s:.3f} "
          f"s{', profiled' if profiled else ''}); collectives {coll.count} ({per_step:.1f} a step, {each:.4f} ms of host "
          f"time each); hand-written kernel launches {sum(launches.values())}"
          + ("" if hits is None else f", kernels matching {MF_KERNEL!r} in the "
             f"profiled run {sorted(hits)}"))
    if sum(launches.values()) or hits:
        raise AssertionError(f"{tag} the sharded jvp lane launched kernels: {launches}, "
                             f"{hits}")
    return (u_tr, c_tr), dict(steps_per_s=SHARD16_STEPS / first_s, first_s=first_s,
                              device_busy_ms=busy, idle_share=idle, launches=0,
                              collectives=coll.count, collectives_per_step=per_step,
                              collective_ms_each=each, cg_iters=info)


def _cells_nodes_world1(torch, dev):
    """[16a] (module docstring), and [16b]'s reference: its problem
    unsharded on the matrix-free lane."""
    import tempfile

    import torch.distributed as dist

    from glimslib_tpu_torch.examples import REFINED_STEP_CONFIG, brain_sim
    from glimslib_tpu_torch.native import meshops
    from glimslib_tpu_torch.parallel import make_device_mesh

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh1 = make_device_mesh(device=dev)
            t0 = time.perf_counter()
            whole = brain_sim(n=N, dtype=torch.float32, device=dev, unstructured=True)
            whole.operator_mode = "matrix-free"
            whole.step_config = REFINED_STEP_CONFIG
            torch.cuda.synchronize()
            print(f"[16a] n={N} Morton box: {whole.mesh.n_nodes} nodes, "
                  f"{whole.mesh.n_cells} tets; set-up {time.perf_counter() - t0:.1f} s; "
                  f"REFINED_STEP_CONFIG, {SHARD16_STEPS} steps a mode; native mesh ops "
                  f"library built: {meshops.available()}")
            (u_w, c_w), base = _run16(torch, whole, "[16a] unsharded matrix-free:", False)
            out["unsharded"] = base
            for mode in SHARD16_MODES:
                tag = f"[16a] {mode}, world 1:"
                t0 = time.perf_counter()
                sim = brain_sim(dtype=torch.float32, device=dev, mesh=whole.mesh)
                sim.step_config = REFINED_STEP_CONFIG
                sim.use_sharding(mesh1, mode=mode)
                torch.cuda.synchronize()
                setup_s = time.perf_counter() - t0
                layout = _layout16(sim)
                print(f"{tag} {type(sim.kernels).__name__}, set-up (model and "
                      f"use_sharding) {setup_s:.1f} s; rank 0: {layout}")
                if mode == "cells" and layout["partitioner"] != "graph":
                    raise AssertionError(f"{tag} the partitioner was "
                                         f"{layout['partitioner']}, not the native graph one")
                (u, c), nums = _run16(torch, sim, tag, True)
                bit = bool(torch.equal(u, u_w) and torch.equal(c, c_w))
                rel = (_rel_l2(c[-1], c_w[-1]), _rel_l2(u[-1], u_w[-1]))
                rmax = max(_rel_max(c, c_w)[1], _rel_max(u, u_w)[1])
                why = ("" if bit else " (not bit-equal: " + (
                    "point-Jacobi on the elasticity block, the reference's 'cells' "
                    "preconditioner, takes other CG iterates" if mode == "cells" else
                    "index_add_ on the card adds by atomics in no fixed order, so two "
                    "runs of the same kernels differ in the last bits") + ")")
                print(f"{tag} against the unsharded jvp-lane run: bit-equal {bit}; max rel "
                      f"diff {rmax:.3e}{why}; rel-L2 c {rel[0]:.3e}, u {rel[1]:.3e} (<= "
                      f"{UNSTRUCT_RTOL}); CG iterations by solve (one rd solve a Newton "
                      f"iteration) {nums['cg_iters']} against the unsharded "
                      f"{base['cg_iters']}")
                if max(rel) > UNSTRUCT_RTOL:
                    raise AssertionError(f"{tag} c {rel[0]:.3e}, u {rel[1]:.3e}")
                out[mode] = dict(nums, setup_s=setup_s, layout=layout, bit_equal=bit,
                                 max_rel_diff=rmax, rel_c=rel[0], rel_u=rel[1])
                del sim, u, c
                torch.cuda.empty_cache()
            del whole, u_w, c_w
            torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = True
            dist.destroy_process_group()
    sim, targets = _small16_problem(torch, dev)
    sim.operator_mode = "matrix-free"  # the lane the sharded modes take
    ref = _small16_run(torch, sim, targets)
    return out, ref


def _cells_nodes_two_ranks(ranks, wall_s, ref):
    """[16b]: the NODES_WORLD ranks' results ``ranks`` (from [13b]'s spawn,
    ``wall_s`` seconds there) against each other and ``ref``, the problem
    unsharded (world 1)."""
    import numpy as np

    out = {}
    for mode in SHARD16_MODES:
        tag = f"[16b] {mode}, {NODES_WORLD} gloo ranks:"
        rs = [r[mode] for r in ranks]
        same = all(r["J"] == rs[0]["J"] and np.array_equal(r["g"], rs[0]["g"])
                   and np.array_equal(r["c"], rs[0]["c"]) and np.array_equal(r["u"], rs[0]["u"])
                   and r["cg"] == rs[0]["cg"] for r in rs)
        rel_J = abs(rs[0]["J"] - ref["J"]) / abs(ref["J"])
        rel_g = float(np.linalg.norm(rs[0]["g"] - ref["g"]) / np.linalg.norm(ref["g"]))
        rel_c = float(np.linalg.norm(rs[0]["c"] - ref["c"]) / np.linalg.norm(ref["c"]))
        n_f0 = rs[0]["collectives"][0]
        it0 = sum(map(sum, (v for k, v in rs[0]["cg"].items()
                            if k in ("rd_cg_iters", "el_cg_iters"))))
        print(f"{tag} the forward: {n_f0} collectives over {it0} CG iterations = "
              f"{n_f0 / max(it0, 1):.2f} a CG iteration (the residuals and Newton's "
              "norms counted in)")
        for r, o in enumerate(rs):
            n_f, n_b = o["collectives"]
            ms_f, ms_b = o["collective_ms"]
            print(f"{tag} rank {r}: {o['layout']}; forward {o['forward_s']:.2f} s, "
                  f"value_and_grad {o['value_and_grad_s']:.2f} s; collectives "
                  f"{n_f} / {n_b} (forward / value_and_grad; {ms_f / max(n_f, 1):.3f} / "
                  f"{ms_b / max(n_b, 1):.3f} ms each, host clock, gloo); Newton "
                  f"{o['newton']}, CG iterations of the forward {o['cg']}; hand-written "
                  f"kernel launches {o['launches']}")
        print(f"{tag} J {rs[0]['J']:.15e}, gradient {rs[0]['g'].tolist()}; bit-equal on "
              f"every rank (J, gradient, c, u, CG counts) {same}; against the unsharded "
              f"model (world 1): rel J {rel_J:.3e} (<= {SMALL16_J_RTOL}), rel-L2 gradient "
              f"{rel_g:.3e} (<= {SMALL16_G_RTOL}), c {rel_c:.3e}")
        if (not same or not all(o["ok"] for o in rs) or rel_J > SMALL16_J_RTOL
                or rel_g > SMALL16_G_RTOL or any(o["launches"] for o in rs)):
            raise AssertionError(f"{tag} same {same}, J {rel_J:.3e}, gradient {rel_g:.3e}")
        if mode == "cells" and any(o["layout"]["partitioner"] != "graph" for o in rs):
            raise AssertionError(f"{tag} not the native graph partitioner")
        out[mode] = dict(J=rs[0]["J"], rel_J=rel_J, rel_grad=rel_g, rel_c=rel_c,
                         bit_equal=same, layouts=[o["layout"] for o in rs],
                         collectives=[o["collectives"] for o in rs],
                         collective_ms=[o["collective_ms"] for o in rs],
                         forward_s=[o["forward_s"] for o in rs],
                         value_and_grad_s=[o["value_and_grad_s"] for o in rs])
    print(f"[16b] {NODES_WORLD} ranks: {wall_s:.1f} s on the ranks (in [13b]'s spawn)")
    out["seconds_on_ranks"] = wall_s
    return out


def phase_cells_nodes(torch, dev, ranks):
    """[16]: the 'cells' and unstructured 'nodes' modes (module
    docstring); ``ranks`` = [16b]'s rank results and their seconds."""
    t_phase = time.perf_counter()
    out = {}
    out["world1"], ref = _cells_nodes_world1(torch, dev)
    out["two_ranks"] = _cells_nodes_two_ranks(*ranks, ref)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[16] cells and nodes phase {out['seconds']:.1f} s")
    return out


# [17]: Chebyshev preconditioning (StepConfig.precond_degree > 1) and von
# Neumann conditions under the 'cells' and 'nodes' modes.  [17a] runs
# CHEB_STEPS steps a way at degree CHEB_DEGREE and at 0 (Jacobi) on [3]'s
# lattice (bench StepConfig) and [6]'s unstructured box, and one
# value_and_grad of [7]'s lattice cell each way.  [17b] runs
# examples.influx_sim with the traction VN17_TRACTION at f32
# REFINED_STEP_CONFIG, VN17_STEPS step, at world 1 over NCCL, and on
# NODES_WORLD gloo ranks (in [13b]'s spawn) the 730-node box of [16b] at
# f64, VN17_STEPS step and one value_and_grad a mode, held to VN17_RTOL of
# the same mode at world 1.
CHEB_DEGREE = 3
CHEB_STEPS = 2
VN17_STEPS = 1
VN17_TRACTION = (20.0, 0.0, 5.0)
VN17_RTOL = 1e-12
VN17_MODES = ("nodes", "cells")
VN17_CG_RTOL = 1e-12
# the Chebyshev lattice takes the pcg branch with warm starts, whose Newton
# stops at newton_rtol one iteration after the guess: its J takes the
# warm-started lanes' limit (PERF.md section 2), against the Jacobi run's
CHEB_J_RTOL = ADJ_J_RTOL["unstructured"]


def _cheb_way(torch, sim, dev, tag, groups, shown, none):
    """One way of [17a] on ``sim`` (its step config set): a run with the
    counts at 0 (``groups`` must launch, ``none`` must not), a timed run
    and its profile; the trajectory and the numbers."""
    simulate = sim.build_simulate_fn(CHEB_STEPS, 1.0)
    args = (sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    (u, c), launches, first_s = _drive(torch, sim, simulate, args, groups, tag,
                                      CHEB_STEPS, shown=shown + none)
    if any(launches[w] for w in none):
        raise AssertionError(f"{tag} launched {[w.__name__ for w in none]}: {launches}")
    iters = {k: [int(i) for i in sim.solver_info[k]] for k in ("rd_cg_iters",
                                                              "el_cg_iters")}
    _, run = _time_runs(torch, simulate, args, dev, tag, CHEB_STEPS)
    return (u, c), dict(run, launches={w.__name__: n for w, n in launches.items()},
                        cg_iters=iters, first_s=first_s)


def _cheb_lattice(torch, dev, sim, kernels):
    """[17a] on [3]'s lattice model: Jacobi (the whole-solve stencil_pcg)
    and Chebyshev (the pcg branch on the stencil planes: stencil_apply
    only), c and u held to SLICE_RTOL of each other; each stencil_apply
    form the Chebyshev solves launch held against its plain version on
    the run's planes; the kernel rows gain their launches; then one
    value_and_grad of [7]'s cell each way (J within CHEB_J_RTOL and the
    gradient within the lattice limit of the Jacobi call's, no
    stencil_pcg in the Chebyshev call)."""
    import numpy as np

    from glimslib_tpu_torch.examples import BENCH_STEP_CONFIG, adjoint_problem
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.ops import stencil_kernels as sk
    from glimslib_tpu_torch.optimize.adjoint import InverseProblem

    base = sim.step_config
    applies = [sk.apply_scalar, sk.apply_scalar_sum, sk.apply_vector, sk.apply_coupling]
    pcgs = [fc.cg_scalar, fc.cg_vector]
    out, states = {}, {}
    for degree in (0, CHEB_DEGREE):
        sim.step_config = BENCH_STEP_CONFIG._replace(precond_degree=degree)
        tag = f"[17a] N={N} lattice, degree {degree}:"
        if degree:
            groups, none = [(w,) for w in applies], pcgs
        else:
            groups, none = [(w,) for w in pcgs], []
        states[degree], out[degree] = _cheb_way(
            torch, sim, dev, tag, groups, [w for w in applies + pcgs if w not in none],
            none)
    (u0, c0), (u3, c3) = states[0], states[CHEB_DEGREE]
    rel = (_rel_l2(c3[-1], c0[-1]), _rel_l2(u3[-1], u0[-1]))
    print(f"[17a] lattice: Chebyshev against Jacobi after {CHEB_STEPS} steps: rel-L2 c "
          f"{rel[0]:.3e}, u {rel[1]:.3e} (<= {SLICE_RTOL}); CG iterations Jacobi "
          f"{out[0]['cg_iters']}, Chebyshev {out[CHEB_DEGREE]['cg_iters']}; busy "
          f"{out[0]['device_busy_ms']} / {out[CHEB_DEGREE]['device_busy_ms']} ms, idle "
          f"{out[0]['idle_share']} / {out[CHEB_DEGREE]['idle_share']}")
    if max(rel) > SLICE_RTOL:
        raise AssertionError(f"[17a] lattice Chebyshev vs Jacobi: {rel}")
    # the forms the Chebyshev solves launch, on the run's planes
    sim.step_config = BENCH_STEP_CONFIG._replace(precond_degree=CHEB_DEGREE)
    sim._build_step()
    theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    ops = sim._stencil_ops
    offs = ops.offsets
    rng = np.random.default_rng(17)
    n, d = sim.mesh.n_nodes, sim.mesh.dim
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    W = theta["_Wrd_const"] + ops.build_rd_wc(c3[-1], theta["rho"], theta["dt"])
    checks = [
        _apply_row(torch, "stencil_apply<1,1> (the Chebyshev rd Jacobian)", sk.apply_scalar,
                   sk.apply_scalar_plain, (offs, W, f32(rng.standard_normal(n))), None,
                   None, (sk.apply_scalar,), None, 0, 0, None, "[17a]", None),
        _apply_row(torch, "stencil_apply<3,3> (the Chebyshev elasticity operator)",
                   sk.apply_vector, sk.apply_vector_plain,
                   (offs, theta["_Wel"], f32(rng.standard_normal((n, d)))), None, None,
                   (sk.apply_vector,), None, 0, 0, None, "[17a]", None)]
    print(f"[17a] spectral bounds once a simulate: _lmax_u {float(theta['_lmax_u']):.6f}, "
          f"_lmax_c {float(theta['_lmax_c']):.6f}")
    launches = out[CHEB_DEGREE]["launches"]
    for k in kernels:
        if "@" in k["name"] or not set(k["wrappers"]) <= set(applies + pcgs):
            continue
        k["launches_17a"] = sum(launches[w.__name__] for w in k["wrappers"])
    # one value_and_grad of [7]'s cell each way
    ip, v0 = adjoint_problem(sim=sim)
    vg = {}
    for degree in (0, CHEB_DEGREE):
        sim.step_config = BENCH_STEP_CONFIG._replace(precond_degree=degree)
        p = InverseProblem(sim, ip.param_names, ip.targets, update_fn=ip.update_fn,
                           n_steps=ip.n_steps, dt=ip.dt)
        for w in applies + pcgs:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        J, g = p.value_and_grad(v0)
        torch.cuda.synchronize()
        vg[degree] = dict(J=J, g=g, s=time.perf_counter() - t0,
                          launches={w.__name__: w.launches for w in applies + pcgs},
                          cg={k: [int(i) for i in v] for k, v in sim.solver_info.items()
                              if v})
    rel_J = abs(vg[CHEB_DEGREE]["J"] - vg[0]["J"]) / abs(vg[0]["J"])
    rel_g = float(np.linalg.norm(vg[CHEB_DEGREE]["g"] - vg[0]["g"])
                  / np.linalg.norm(vg[0]["g"]))
    lc = vg[CHEB_DEGREE]["launches"]
    print(f"[17a] value_and_grad of [7]'s cell ({ip.n_steps} steps): Jacobi J "
          f"{vg[0]['J']:.9e} in {vg[0]['s']:.3f} s, Chebyshev J "
          f"{vg[CHEB_DEGREE]['J']:.9e} in {vg[CHEB_DEGREE]['s']:.3f} s: rel J {rel_J:.3e} "
          f"(<= {CHEB_J_RTOL}), rel-L2 gradient {rel_g:.3e} (<= "
          f"{ADJ_G_RTOL['lattice']}); launches Chebyshev {lc}, Jacobi "
          f"{vg[0]['launches']}; CG Chebyshev {vg[CHEB_DEGREE]['cg']}")
    if (rel_J > CHEB_J_RTOL or rel_g > ADJ_G_RTOL["lattice"]
            or lc["cg_scalar"] or lc["cg_vector"] or not lc["apply_scalar"]):
        raise AssertionError(f"[17a] Chebyshev value_and_grad: J {rel_J:.3e}, "
                             f"gradient {rel_g:.3e}, launches {lc}")
    sim.step_config = base
    return dict(runs=out, rel_c=rel[0], rel_u=rel[1], lmax_u=float(theta["_lmax_u"]),
                lmax_c=float(theta["_lmax_c"]),
                checks=[dict(name=r["name"], max_abs_err=r["max_abs_err"]) for r in checks],
                value_and_grad={k: dict(v, g=list(map(float, v["g"]))) for k, v in vg.items()},
                rel_J=rel_J, rel_grad=rel_g)


def _cheb_unstructured(torch, dev, usim, kern):
    """[17a] on [6]'s unstructured model: Jacobi-side (its supernode
    block-Jacobi and coarse level) and Chebyshev around them, c and u held
    to UNSTRUCT_RTOL of each other; bell_bmv's launches by shape, each
    shape one [5] holds against plain (a new one raises), and the rd
    Jacobian at the final state held again; the row gains its launches."""
    import numpy as np

    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG
    from glimslib_tpu_torch.ops import bell
    from glimslib_tpu_torch.ops import bell_kernels as bk

    base = usim.step_config
    out, states, shapes = {}, {}, {}
    for degree in (0, CHEB_DEGREE):
        usim.step_config = UNSTRUCT_STEP_CONFIG._replace(precond_degree=degree)
        bk.batched_matvec.launches_by_shape = {}
        states[degree], out[degree] = _cheb_way(
            torch, usim, dev, f"[17a] n={N} unstructured, degree {degree}:",
            [(bk.batched_matvec,)], [], [])
        shapes[degree] = dict(bk.batched_matvec.launches_by_shape)
    (u0, c0), (u3, c3) = states[0], states[CHEB_DEGREE]
    rel = (_rel_l2(c3[-1], c0[-1]), _rel_l2(u3[-1], u0[-1]))
    held = {tuple(r["shape"]) for r in kern["shapes"]}
    new = sorted(set(shapes[CHEB_DEGREE]) - held)
    print(f"[17a] unstructured: Chebyshev against Jacobi after {CHEB_STEPS} steps: rel-L2 "
          f"c {rel[0]:.3e}, u {rel[1]:.3e} (<= {UNSTRUCT_RTOL}); CG iterations Jacobi "
          f"{out[0]['cg_iters']}, Chebyshev {out[CHEB_DEGREE]['cg_iters']}; busy "
          f"{out[0]['device_busy_ms']} / {out[CHEB_DEGREE]['device_busy_ms']} ms, idle "
          f"{out[0]['idle_share']} / {out[CHEB_DEGREE]['idle_share']}; bell_bmv by (B, M, "
          f"K) Jacobi {shapes[0]}, Chebyshev {shapes[CHEB_DEGREE]}: shapes [5] does not "
          f"hold: {new}")
    if max(rel) > UNSTRUCT_RTOL or new:
        raise AssertionError(f"[17a] unstructured Chebyshev: {rel}, new shapes {new}")
    usim.step_config = UNSTRUCT_STEP_CONFIG._replace(precond_degree=CHEB_DEGREE)
    usim._build_step()
    theta = usim._augment_theta_with_operators(
        {**usim.make_theta(usim.params.as_dict()), **usim.runtime_aux()})
    plan = usim._get_bell_plan()
    k0 = usim.kernels
    W = theta["_BellWrdC"] + bell.build_bell_rd_wc(
        plan, usim._mesh_arrays(), k0.cells_flat, c3[-1], theta["rho"], theta["dt"],
        k0._t0, 1.0)
    x = torch.as_tensor(np.random.default_rng(17).standard_normal(W.shape[::2]),
                        dtype=torch.float32, device=dev)
    err, rel_k = _rel_max(bk.batched_matvec(W, x), bk.batched_matvec_plain(W, x))
    print(f"[17a] bell_bmv on the rd Jacobian at the Chebyshev state {tuple(W.shape)}: "
          f"max abs err {err:.3e}, max rel err {rel_k:.3e} (<= {BMV_RTOL})")
    if rel_k > BMV_RTOL:
        raise AssertionError(f"[17a] bell_bmv rd Jacobian: {rel_k:.3e}")
    kern["launches_17a"] = out[CHEB_DEGREE]["launches"]["batched_matvec"]
    usim.step_config = base
    return dict(runs=out, rel_c=rel[0], rel_u=rel[1],
                launches_by_shape={"x".join(map(str, s)): c
                                   for s, c in shapes[CHEB_DEGREE].items()},
                rd_jacobian_max_abs_err=err)


def phase_chebyshev(torch, dev, sim, usim, kernels, kern):
    """[17a] (module docstring)."""
    t0 = time.perf_counter()
    out = {"lattice": _cheb_lattice(torch, dev, sim, kernels)}
    t1 = time.perf_counter()
    out["unstructured"] = _cheb_unstructured(torch, dev, usim, kern)
    out["seconds"] = time.perf_counter() - t0
    print(f"[17a] Chebyshev phase {out['seconds']:.1f} s (lattice {t1 - t0:.1f} s)")
    return out


def _influx_update(sim, torch):
    """[17b]'s parameter map (D_WM, rho_WM): per-cell diffusion and
    proliferation, influx_sim's elsewhere."""
    import numpy as np

    names = {v: k for k, v in sim.subdomains.tissue_id_name_map.items()}
    labels = np.asarray(sim.subdomains.cell_labels)
    wm, gm = (torch.as_tensor(labels == names[t], dtype=sim.dtype, device=sim.device)
              for t in ("WM", "GM"))
    return lambda v: {"diffusion": v[0] * wm + 0.02 * (1.0 - wm),
                      "proliferation": v[1] * wm + 0.02 * gm}


def _vn17_config():
    """[16b]'s step with the solves to VN17_CG_RTOL (two solves of one
    system that part in their rounding alone, the ranks' sums, then stop
    within VN17_RTOL of each other) and Chebyshev preconditioning of
    CHEB_DEGREE: the sharded modes at two ranks take it too."""
    return _small16_config()._replace(newton_rtol=1e-10, cg_rtol=VN17_CG_RTOL,
                                      precond_degree=CHEB_DEGREE)


def _small17_problem(torch, dev):
    """[17b]'s rank model: influx_sim with the traction on [16b]'s padded
    Morton box, f64, with whole targets made from its initial values."""
    import numpy as np

    from glimslib_tpu_torch.core.mesh import Mesh, box_mesh, pad_mesh_nodes
    from glimslib_tpu_torch.examples import influx_sim

    m = box_mesh((0, 0, 0), (10, 10, 10), SMALL16_N, SMALL16_N, SMALL16_N)
    mesh = pad_mesh_nodes(Mesh.from_arrays(m.points, m.cells).reordered_morton(),
                          NODES_WORLD)
    sim = influx_sim(dtype=torch.float64, device=dev, mesh=mesh, traction=VN17_TRACTION)
    sim.step_config = _vn17_config()
    iv = sim.params.create_initial_value_function()
    c0 = np.asarray(iv[sim.SUBSPACE_CONCENTRATION])
    targets = {"conc_T2": 0.5 * (np.tanh((1.5 * c0 - 0.12) / 0.01) + 1.0),
               "disp": np.zeros_like(np.asarray(iv[sim.SUBSPACE_DISPLACEMENT]))}
    return sim, targets


def _small17_run(torch, sim, targets):
    """VN17_STEPS step(s) of [17b]'s model under its mode (the final state
    gathered under 'nodes') and one value_and_grad at (0.05, 0.05), with
    the collectives counted; numpy values."""
    import numpy as np

    from glimslib_tpu_torch.optimize.adjoint import InverseProblem
    from glimslib_tpu_torch.parallel import gather_rows

    ip = InverseProblem(sim, ["D_WM", "rho_WM"], targets,
                        update_fn=_influx_update(sim, torch), n_steps=VN17_STEPS, dt=1.0)
    simulate = sim.build_simulate_fn(VN17_STEPS, 1.0)
    args = (sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    torch.cuda.synchronize()
    with _Collectives() as coll:
        t0 = time.perf_counter()
        u, c, ok, newton = simulate(*args)
        counts = {k: [int(i) for i in v] for k, v in sim.solver_info.items() if v}
        n_fwd = coll.count
        J, g = ip.value_and_grad(np.array([0.05, 0.05]))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    u, c = u[-1], c[-1]
    rows = sim._node_rows
    if rows is not None:
        u = gather_rows(sim.device_mesh, u, rows.start, rows.n_total)
        c = gather_rows(sim.device_mesh, c, rows.start, rows.n_total)
    return dict(mode=sim.sharding_mode, ok=bool(ok.all()), newton=newton.tolist(),
                cg=counts, u=u.cpu().numpy(), c=c.cpu().numpy(), J=J, g=g,
                seconds=seconds, collectives=coll.count,
                forward_collectives=(n_fwd, sum(map(sum, counts.values()))),
                facets={name: len(sim._von_neumann_kernels(name, bc)[1])
                        for name, bc in sim.bcs.von_neumann_bcs.items()})


def _rank17b(mesh):
    """[17b] on one rank: the model under 'nodes', then 'cells'
    (:func:`_small17_run`)."""
    import torch

    out = {}
    for mode in VN17_MODES:
        sim, targets = _small17_problem(torch, mesh.device)
        sim.use_sharding(mesh, mode=mode)
        out[mode] = _small17_run(torch, sim, targets)
        del sim
    torch.use_deterministic_algorithms(False)
    torch.utils.deterministic.fill_uninitialized_memory = True
    return out


def _vn17_one(torch, tag, whole, sim, rtol, groups, none):
    """One world-1 check of [17b]: ``whole`` (unsharded) and ``sim``
    (sharded) VN17_STEPS step(s) each, the counts at 0 before the sharded
    run (``groups`` must launch, ``none`` must not); c and u within
    ``rtol``."""
    u_w, c_w, ok_w, _ = whole.build_simulate_fn(VN17_STEPS, 1.0)(
        whole.make_theta(whole.params.as_dict()), *whole.initial_state())
    simulate = sim.build_simulate_fn(VN17_STEPS, 1.0)
    args = (sim.make_theta(sim.params.as_dict()), *sim.initial_state())
    with _Collectives() as coll:
        (u, c), launches, first_s = _drive(torch, sim, simulate, args, groups, tag,
                                          VN17_STEPS, shown=none)
    if any(launches[w] for w in none) or not bool(ok_w.all()):
        raise AssertionError(f"{tag} launches {launches}, unsharded ok {ok_w.tolist()}")
    rel = (_rel_l2(c[-1], c_w[-1]), _rel_l2(u[-1], u_w[-1]))
    facets = {name: len(sim._von_neumann_kernels(name, bc)[1])
              for name, bc in sim.bcs.von_neumann_bcs.items()}
    print(f"{tag} against the unsharded run: rel-L2 c {rel[0]:.3e}, u {rel[1]:.3e} (<= "
          f"{rtol}); the rank's facets {facets}; collectives {coll.count}; "
          f"{first_s:.2f} s")
    if max(rel) > rtol:
        raise AssertionError(f"{tag} c {rel[0]:.3e}, u {rel[1]:.3e}")
    return dict(rel_c=rel[0], rel_u=rel[1], seconds=first_s, collectives=coll.count,
                launches={w.__name__: n for w, n in launches.items()}, facets=facets)


def _vn_world1(torch, dev, meshes):
    """[17b] at world 1 over NCCL in this process: the N=32 lattice under
    'nodes' and the n=32 Morton box under 'cells' and 'nodes' (``meshes``:
    [3]'s and [6]'s), each against its unsharded run (the lattice's own
    lane; the Morton box's jvp lane, which both modes take); then [17b]'s
    rank model under each mode, the reference of the two ranks."""
    import tempfile

    import torch.distributed as dist

    from glimslib_tpu_torch.examples import REFINED_STEP_CONFIG, influx_sim
    from glimslib_tpu_torch.ops import bell_kernels as bk
    from glimslib_tpu_torch.ops import fused_cg as fc
    from glimslib_tpu_torch.ops import stencil_kernels as sk
    from glimslib_tpu_torch.parallel import make_device_mesh

    every = [w for g in _lattice_groups() for w in g] + [bk.batched_matvec]
    out, refs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh1 = make_device_mesh(device=dev)

            def model(**kw):
                sim = influx_sim(dtype=torch.float32, device=dev, traction=VN17_TRACTION,
                                 **kw)
                sim.step_config = REFINED_STEP_CONFIG
                return sim

            whole = model(mesh=meshes[0])
            sim = model(mesh=whole.mesh)
            sim.use_sharding(mesh1, mode="nodes")
            out["lattice_nodes"] = _vn17_one(
                torch, f"[17b] N={N} lattice 'nodes', world 1:", whole, sim, SLICE_RTOL,
                [(sk.apply_scalar,), (sk.apply_vector,)], [fc.cg_scalar, fc.cg_vector])
            del whole, sim
            whole = model(mesh=meshes[1])
            whole.operator_mode = "matrix-free"
            for mode in VN17_MODES:
                sim = model(mesh=whole.mesh)
                sim.use_sharding(mesh1, mode=mode)
                out[f"unstructured_{mode}"] = _vn17_one(
                    torch, f"[17b] n={N} Morton box '{mode}', world 1:", whole, sim,
                    UNSTRUCT_RTOL, [], every)
                del sim
            del whole
            torch.cuda.empty_cache()
            for mode in VN17_MODES:
                sim, targets = _small17_problem(torch, dev)
                sim.use_sharding(mesh1, mode=mode)
                refs[mode] = _small17_run(torch, sim, targets)
                del sim
        finally:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = True
            dist.destroy_process_group()
    return out, refs


def _vn_two_ranks(ranks, wall_s, refs):
    """[17b]: the NODES_WORLD ranks' results (from [13b]'s spawn, ``wall_s``
    seconds there) against each other and ``refs``, the same mode at
    world 1; and the collectives a CG iteration under 'nodes'."""
    import numpy as np

    out = {}
    for mode in VN17_MODES:
        tag = f"[17b] {mode}, {NODES_WORLD} gloo ranks:"
        rs, ref = [r[mode] for r in ranks], refs[mode]
        same = all(r["J"] == rs[0]["J"] and np.array_equal(r["g"], rs[0]["g"])
                   and np.array_equal(r["c"], rs[0]["c"]) and np.array_equal(r["u"], rs[0]["u"])
                   for r in rs)
        rel = dict(J=abs(rs[0]["J"] - ref["J"]) / abs(ref["J"]),
                   g=float(np.linalg.norm(rs[0]["g"] - ref["g"]) / np.linalg.norm(ref["g"])),
                   c=float(np.linalg.norm(rs[0]["c"] - ref["c"]) / np.linalg.norm(ref["c"])),
                   u=float(np.linalg.norm(rs[0]["u"] - ref["u"]) / np.linalg.norm(ref["u"])))
        print(f"{tag} J {rs[0]['J']:.15e}, gradient {rs[0]['g'].tolist()}; bit-equal on "
              f"every rank {same}; against world 1 (NCCL, this process): rel J "
              f"{rel['J']:.3e}, gradient {rel['g']:.3e}, c {rel['c']:.3e}, u {rel['u']:.3e} "
              f"(<= {VN17_RTOL}); facets a rank {[r['facets'] for r in rs]} (world 1 "
              f"{ref['facets']}); Newton {rs[0]['newton']}, CG {rs[0]['cg']}; collectives "
              f"{[r['collectives'] for r in rs]} in {[round(r['seconds'], 2) for r in rs]} s")
        if not same or not all(r["ok"] for r in rs) or max(rel.values()) > VN17_RTOL:
            raise AssertionError(f"{tag} same {same}, {rel}")
        out[mode] = dict(J=rs[0]["J"], rel=rel, bit_equal=same,
                         facets=[r["facets"] for r in rs],
                         collectives=[r["collectives"] for r in rs],
                         seconds=[r["seconds"] for r in rs])
    n, iters = ranks[0]["nodes"]["forward_collectives"]
    per = n / max(iters, 1)
    print(f"[17b] 'nodes', {NODES_WORLD} gloo ranks, the forward step at degree "
          f"{CHEB_DEGREE}: {n} collectives over {iters} CG iterations = {per:.2f} a CG "
          "iteration (the power iterations' norms, the polynomial's matvecs, the "
          "residuals and Newton's norms counted in; [16b] the same at degree 0)")
    out["collectives_per_cg_iteration"] = per
    out["seconds_on_ranks"] = wall_s
    return out


def phase_vn_shard(torch, dev, ranks, meshes):
    """[17b] (module docstring); ``ranks`` = the rank results and their
    seconds, ``meshes`` [3]'s and [6]'s."""
    t0 = time.perf_counter()
    out = {}
    out["world1"], refs = _vn_world1(torch, dev, meshes)
    print(f"[17b] world 1: {time.perf_counter() - t0:.1f} s")
    out["two_ranks"] = _vn_two_ranks(*ranks, refs)
    out["seconds"] = time.perf_counter() - t0
    print(f"[17b] von Neumann sharding phase {out['seconds']:.1f} s (and "
          f"{ranks[1]:.1f} s on [13b]'s ranks)")
    return out


# [18]: geometric multigrid, folded symmetric stencils, the streamed P2
# residual and the warm-start switches.  [18a] runs on [3]'s N=32 box at
# f32: the scalar block at MG_SCALAR (D, rho, dt; the JAX package's
# stiffness-dominated test setting) unmasked, the elasticity block at
# MG_E, MG_NU clamped on the boundary, each solved by pcg to MG_CG_RTOL
# with the V-cycle (the level applies through the stencil kernel, and
# again with plain=True, held to equal iterations and MG_X_RTOL) and with
# (block-)Jacobi; MG's true residual within MG_RES_RTOL.  The elasticity
# V-cycle does not reach MG_CG_RTOL on this box (an NVIDIA H100 80GB HBM3
# at 700 W: 8.8e-3 after 4,000 iterations at f32; the near-incompressible
# case the JAX package's notes name), so its solve stops at MG_EL_MAXITER
# iterations and prints the residual it reached beside block-Jacobi's at
# as many; the kernel is held against plain=True by one V-cycle
# application (MG_X_RTOL) and equal iterations.  [18c] takes QUAD_STEPS
# steps a way on [10b]'s model; [18d] WARM18_STEPS steps a way on [6]'s.
MG_SCALAR = (5.0, 0.1, 1.0)
MG_E, MG_NU = 1000.0, 0.45
MG_CG_RTOL = 1e-6
MG_MAXITER = 4000
MG_EL_MAXITER = 50
MG_X_RTOL = 1e-6
MG_RES_RTOL = 1e-4
WARM18_STEPS = 2


def _mg_solve(torch, A, b, M, tag, way, maxiter=MG_MAXITER):
    """One pcg solve to MG_CG_RTOL, timed: (x, {iters, wall_ms,
    true_residual}, a function that repeats it).  It must converge unless
    ``maxiter`` is below MG_MAXITER (a capped solve)."""
    from glimslib_tpu_torch.solvers.cg import pcg

    def solve():
        return pcg(A, b, M=M, rtol=MG_CG_RTOL, maxiter=maxiter)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = solve()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    iters = int(info["iters"])
    res = float((b - A(x)).norm() / b.norm())
    print(f"{tag} {way}: {iters} CG iterations, {wall_ms:.2f} ms, true residual {res:.3e}")
    if (iters >= MG_MAXITER and maxiter == MG_MAXITER) or not res == res:
        raise AssertionError(f"{tag} {way}: {iters} iterations, residual {res}")
    return x, dict(iters=iters, wall_ms=wall_ms, true_residual=res), solve


def _busy(torch, out, solve, tag, way):
    """Adds the device busy ms of a profiled repeat of ``solve`` and the
    idle share of the timed solve to ``out``."""
    busy = _device_busy_ms(_profile(torch, solve, cpu=False))
    out.update(device_busy_ms=busy, idle_share=max(0.0, 1 - busy / out["wall_ms"]))
    print(f"{tag} {way}: device busy {busy:.3f} ms, idle {100 * out['idle_share']:.1f}% "
          f"of the timed solve")


def _mg_block(torch, dev, h, kind, tag):
    """One block of [18a]: the V-cycle through the kernel (stencil_apply
    launches counted by level during the solve), the same with
    plain=True, and (block-)Jacobi; returns the numbers, the launches by
    level and the built data."""
    import numpy as np

    from glimslib_tpu_torch.ops import stencil_kernels as sk
    from glimslib_tpu_torch.solvers import multigrid as mg

    ops = h.ops[0]
    offs, n = ops.offsets, h.meshes[0].n_nodes
    rng = np.random.default_rng(18)
    if kind == "scalar":
        D, rho, dt = MG_SCALAR
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        W = ops.build_rd_jacobian_const(D, rho, dt)
        apply, plain, cls, args = sk.apply_scalar, sk.apply_scalar_plain, mg.MGScalar, MG_SCALAR
        diag = W[offs.index(0)]
        inner = lambda r: r / diag  # noqa: E731
        b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
        wrapper = sk.apply_scalar
    else:
        mask = torch.zeros((n, 3), dtype=torch.bool, device=dev)
        mask[torch.as_tensor(h.meshes[0].boundary_nodes, device=dev)] = True
        mu = MG_E / (2 * (1 + MG_NU))
        lam = MG_E * MG_NU / ((1 + MG_NU) * (1 - 2 * MG_NU))
        W = ops.build_elasticity(mu, lam)
        apply, plain, cls, args = sk.apply_vector, sk.apply_vector_plain, mg.MGElasticity, (
            mu, lam)
        Binv = ops.block_jacobi_inverse(W, mask=mask)
        inner = lambda r: torch.where(mask, r, ops.apply_block_jacobi(  # noqa: E731
            Binv, torch.where(mask, 0.0, r)))
        b = torch.where(mask, 0.0, torch.as_tensor(rng.standard_normal((n, 3)),
                                                    dtype=torch.float32, device=dev))
        wrapper = sk.apply_vector

    def masked(fn):
        return lambda v: torch.where(mask, v, fn(offs, W, torch.where(mask, 0.0, v)))

    A, A_plain = masked(apply), masked(plain)
    with torch.no_grad():
        # the path: the V-cycle's build and its solve, launches counted by
        # level (the dense bottom's columns launch in the build)
        mg_k = cls(h, mask)
        by_level = [0] * h.n_levels
        orig = mg_k._apply_op

        def counting(lv, d, v):
            before = wrapper.launches
            y = orig(lv, d, v)
            by_level[lv] += wrapper.launches - before
            return y

        mg_k._apply_op = counting
        wrapper.launches = 0
        t0 = time.perf_counter()
        data = mg_k.build(*args)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        built = list(by_level)
        by_level = [0] * h.n_levels
        cap = MG_MAXITER if kind == "scalar" else MG_EL_MAXITER
        x_k, k_out, solve_k = _mg_solve(torch, A, b, lambda r: mg_k.apply(data, r), tag,
                                        "V-cycle (kernel)", cap)
        total = wrapper.launches
        mg_k._apply_op = orig
        mg_p = cls(h, mask, plain=True)
        data_p = mg_p.build(*args)
        rel_cycle = _rel_l2(mg_k.apply(data, b), mg_p.apply(data_p, b))
        _busy(torch, k_out, solve_k, tag, "V-cycle (kernel)")
        x_p, p_out, _ = _mg_solve(torch, A_plain, b, lambda r: mg_p.apply(data_p, r), tag,
                                  "V-cycle (plain=True)", cap)
        way = "Jacobi" if kind == "scalar" else "block-Jacobi"
        x_j, j_out, solve_j = _mg_solve(torch, A, b, inner, tag, way)
        _busy(torch, j_out, solve_j, tag, way)
        if cap < MG_MAXITER:
            _, j_out["at_cap"], _ = _mg_solve(torch, A, b, inner, tag,
                                              f"{way} stopped at {cap}", cap)
    rel_kp, rel_kj = _rel_l2(x_k, x_p), _rel_l2(x_k, x_j)
    per_it = [c / max(k_out["iters"], 1) for c in by_level]
    converged = cap == MG_MAXITER
    print(f"{tag} {total} stencil_apply launches in the V-cycle's build and solve: the "
          f"build by level {built}, the solve by level {by_level} (the fine operator's "
          f"{total - sum(built) - sum(by_level)} outside the cycle); "
          f"a CG iteration {', '.join(f'L{lv} {c:.1f}' for lv, c in enumerate(per_it))}; "
          f"build {build_s:.2f} s; kernel vs plain=True: one V-cycle rel-L2 "
          f"{rel_cycle:.3e} (<= {MG_X_RTOL}), iterations {k_out['iters']} / "
          f"{p_out['iters']}, rel-L2 x {rel_kp:.3e}"
          + (f" (<= {MG_X_RTOL})" if converged else "") + "; vs "
          f"{way} rel-L2 x {rel_kj:.3e}, "
          + (f"iterations {k_out['iters']} against {j_out['iters']} "
             f"({j_out['iters'] / max(k_out['iters'], 1):.2f}x fewer)" if converged else
             f"residual after {cap} iterations {k_out['true_residual']:.3e} against "
             f"{way}'s {j_out['at_cap']['true_residual']:.3e}; {way} reaches "
             f"{MG_CG_RTOL} in {j_out['iters']}"))
    if (k_out["iters"] != p_out["iters"] or rel_cycle > MG_X_RTOL
            or (converged and (rel_kp > MG_X_RTOL or max(
                k_out["true_residual"], p_out["true_residual"]) > MG_RES_RTOL))
            or min(by_level[:-1] if "Cinv" in data[-1] else by_level) < 1
            or min(b_ + s_ for b_, s_ in zip(built, by_level)) < 1):
        raise AssertionError(f"{tag} V-cycle: kernel {k_out}, plain {p_out}, rel "
                             f"{rel_kp:.3e}, one cycle {rel_cycle:.3e}, launches by "
                             f"level {by_level}")
    return dict(mg=k_out, plain=p_out, jacobi=j_out, rel_cycle_plain=rel_cycle,
                rel_x_plain=rel_kp,
                rel_x_jacobi=rel_kj, launches=total, launches_by_level=by_level,
                build_launches_by_level=built,
                launches_per_iteration_by_level=per_it, build_s=build_s), data


def _mg_level_rows(torch, dev, h, datas, blocks, tag):
    """Each coarse level's stencil_apply forms against their plain version
    and timed as in [2] (level 0 has [2]'s shapes: held, untimed); each
    row's launches are the V-cycle's build and solve's at that level."""
    import numpy as np

    from glimslib_tpu_torch.ops import stencil_kernels as sk

    cold = _cold_l2(torch, dev)
    k1 = "glimslib_tpu/ops/stencil_pallas.py:108"
    k2 = "glimslib_tpu/ops/stencil_pallas.py:151"
    rng = np.random.default_rng(18)
    rows = []
    for lv in range(h.n_levels):
        offs, n = h.ops[lv].offsets, h.meshes[lv].n_nodes
        shape = "x".join(map(str, h.shapes[lv]))
        for kind, kern, plain, d, replaces in (
                ("scalar", sk.apply_scalar, sk.apply_scalar_plain, 1, k1),
                ("elasticity", sk.apply_vector, sk.apply_vector_plain, 3, k2)):
            W = datas[kind][lv]["W"]
            x = torch.as_tensor(rng.standard_normal((n, d) if d > 1 else n),
                                dtype=torch.float32, device=dev)
            name = f"stencil_apply<{d},{d}>@MG L{lv} {shape}"
            timed = lv > 0
            A = _csr(torch, offs, [(W.reshape(len(offs), d, d, n), 1.0, 0)], n, d, d,
                     n * d) if timed else None
            row = _apply_row(
                torch, name, kern, plain, (offs, W, x),
                (lambda A=A, xf=x.reshape(-1): torch.mv(A, xf)) if timed else None,
                (n, d) if d > 1 else (n,), (kern,),
                rf"stencil_apply_kernel<{d}, ?{d}, ?1>",
                4 * (W.numel() + 2 * x.numel()), 2 * W.numel(), replaces, tag, cold)
            row["launches"] = (blocks[kind]["build_launches_by_level"][lv]
                               + blocks[kind]["launches_by_level"][lv])
            row["launches_in"] = f"{tag} the {kind} V-cycle's build and solve"
            if timed:
                rows.append(row)
            del A
    return rows


def _fold_check(torch, dev, sim, tag):
    """[18b]: the folded applies and block_jacobi_inverse_sym on [3]'s
    bench planes against the kernel's full-plane stencil_apply and the
    full-plane inverse; device time of each by CUDA events."""
    import numpy as np

    from glimslib_tpu_torch.ops import stencil_kernels as sk

    theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    ops = sim._stencil_ops
    offs, n, d = ops.offsets, sim.mesh.n_nodes, sim.mesh.dim
    rng = np.random.default_rng(18)
    u = torch.as_tensor(rng.standard_normal((n, d)), dtype=torch.float32, device=dev)
    v = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32, device=dev)
    out = {}
    for form, W, x, full, sym in (
            ("<3,3>", theta["_Wel"], u, sk.apply_vector, ops.apply_vector_sym),
            ("<1,1>", theta["_Wrd_const"], v, sk.apply_scalar, ops.apply_scalar_sym)):
        Ws = ops.fold_sym(W)
        err, rel = _rel_max(sym(Ws, x), full(offs, W, x))
        ms_sym = _time_ms(torch, lambda: sym(Ws, x), 20)
        ms_full = _time_ms(torch, lambda: full(offs, W, x), 20)
        print(f"{tag} {form}: {Ws.shape[0]} of {W.shape[0]} planes; folded apply vs "
              f"the kernel's full-plane stencil_apply max abs err {err:.3e}, max rel "
              f"{rel:.3e} (<= {APPLY_RTOL}); call {ms_sym:.4f} ms folded (plain torch) "
              f"against {ms_full:.4f} ms (the kernel)")
        if rel > APPLY_RTOL:
            raise AssertionError(f"{tag} folded {form}: {rel:.3e}")
        out[form] = dict(max_abs_err=err, folded_ms=ms_sym, kernel_ms=ms_full,
                         planes=(Ws.shape[0], W.shape[0]))
    Ws = ops.fold_sym(theta["_Wel"])
    err, rel = _rel_max(ops.block_jacobi_inverse_sym(Ws), ops.block_jacobi_inverse(
        theta["_Wel"]))
    print(f"{tag} block_jacobi_inverse_sym vs the full-plane inverse: max rel {rel:.3e}")
    if rel > APPLY_RTOL:
        raise AssertionError(f"{tag} block_jacobi_inverse_sym: {rel:.3e}")
    out["block_jacobi_inverse_sym_max_abs_err"] = err
    return out


def phase_mg(torch, dev, sim, kernels):
    """[18a] and [18b] (module docstring); adds the MG level rows to
    ``kernels``."""
    from glimslib_tpu_torch.solvers.multigrid import LatticeHierarchy

    t0 = time.perf_counter()
    tag = f"[18a] N={N} MG:"
    h = LatticeHierarchy(sim.mesh, torch.float32, device=dev)
    print(f"{tag} {h.n_levels} levels " + ", ".join(
        f"L{lv} {'x'.join(map(str, s))} ({m.n_nodes} nodes, {len(o.offsets)} offsets)"
        for lv, (s, m, o) in enumerate(zip(h.shapes, h.meshes, h.ops)))
        + f"; hierarchy {time.perf_counter() - t0:.2f} s")
    blocks, datas = {}, {}
    for kind in ("scalar", "elasticity"):
        blocks[kind], datas[kind] = _mg_block(torch, dev, h, kind, f"{tag} {kind}:")
    rows = _mg_level_rows(torch, dev, h, datas, blocks, "[18a]")
    kernels += rows
    fold = _fold_check(torch, dev, sim, "[18b] folded:")
    print(f"[18a]-[18b] {time.perf_counter() - t0:.1f} s")
    return dict(levels=[list(s) for s in h.shapes], blocks=blocks, folded=fold,
                rows=[r["name"] for r in rows])


def _p2_way(torch, dev, sim, args, stream, tag):
    """One way of [18c]: the switch set (or not) before the simulate is
    built, a counted run (the residual evaluations too), a timed and
    profiled run, and the device ms of one residual evaluation at the
    run's final state."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    if stream:
        os.environ["GLIMS_P2STREAM"] = "1"
    else:
        os.environ.pop("GLIMS_P2STREAM", None)
    # counted where the step takes it: set before the step is built
    evals = []
    rd = sim.rd_residual
    sim.rd_residual = lambda *a: evals.append(1) or rd(*a)
    try:
        simulate = sim.build_simulate_fn(QUAD_STEPS, 1.0)
        bk.batched_matvec.launches_by_shape = {}
        (u, c), launches, _ = _drive(torch, sim, simulate, args, [(bk.batched_matvec,)],
                                     tag, QUAD_STEPS)
        n_evals = len(evals)
        by_shape = dict(bk.batched_matvec.launches_by_shape)
        _, run = _time_runs(torch, simulate, args, dev, tag, QUAD_STEPS)
    finally:
        del sim.rd_residual
    theta = sim._augment_theta_with_operators({**args[0], **sim.runtime_aux()})
    if ("_P2B_rd_load" in theta) != stream:
        raise AssertionError(f"{tag} the streamed residual is {'off' if stream else 'on'}")
    with torch.no_grad():
        bk.batched_matvec.launches = 0
        sim.rd_residual(c[-1], c[-2], theta, 1.0)
        per_eval = bk.batched_matvec.launches
        res_ms, src = _call_device_ms(torch, lambda: sim.rd_residual(
            c[-1], c[-2], theta, 1.0))
    os.environ.pop("GLIMS_P2STREAM", None)
    print(f"{tag} {n_evals} rd residual evaluations in the run, {res_ms:.3f} ms of "
          f"device time each ({src}) = {n_evals * res_ms:.1f} ms a run; bell_bmv "
          f"{launches[bk.batched_matvec]} launches in the run (by shape {by_shape}), "
          f"{per_eval} an evaluation")
    return (u, c), dict(run, residual_evals=n_evals, residual_ms=res_ms,
                        residual_ms_run=n_evals * res_ms,
                        bell_bmv_launches=launches[bk.batched_matvec],
                        bell_bmv_by_shape={"x".join(map(str, s)): k
                                           for s, k in by_shape.items()},
                        cg_iters={k: [int(i) for i in sim.solver_info[k]]
                                  for k in ("rd_cg_iters", "el_cg_iters")},
                        residual_launch_calls=per_eval)


def phase_p2stream(torch, dev, quad, kern):
    """[18c] on [10b]'s model and f64 reference (``quad``, from
    phase_quad): the default and GLIMS_P2STREAM=1, the frozen state the
    switch changes (the P2 mass channel, ``_FP2Mrd``, [10b]'s channel 0)
    added to [10b]'s; both held to QUAD_RTOL of the f64 plain path and of
    each other; the bell_bmv row gains the streamed run's launches."""
    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG

    t0 = time.perf_counter()
    sim, aux, args, ref = quad["sim"], quad["aux"], quad["args"], quad["ref"]
    sim.step_config = UNSTRUCT_STEP_CONFIG
    out, finals = {}, {}
    for way, stream in (("default", False), ("streamed", True)):
        sim._aux_cache = {**aux, "_FP2Mrd": aux["_FP2Wrd"][0]} if stream else aux
        tag = f"[18c] quad n={N} {way}:"
        finals[way], out[way] = _p2_way(torch, dev, sim, args, stream, tag)
        u, c = finals[way]
        out[way]["rel_vs_f64"], _ = _quad_vs_ref(torch, sim, (u[-1], c[-1]), args, ref,
                                                 tag)
    sim._aux_cache = aux
    rel = (_rel_l2(finals["streamed"][1][-1], finals["default"][1][-1]),
           _rel_l2(finals["streamed"][0][-1], finals["default"][0][-1]))
    d, s = out["default"], out["streamed"]
    print(f"[18c] streamed against the default: rel-L2 c {rel[0]:.3e}, u {rel[1]:.3e} (<= "
          f"{QUAD_RTOL}); the P2 rd residual {d['residual_ms_run']:.1f} -> "
          f"{s['residual_ms_run']:.1f} ms a run ({d['residual_ms']:.3f} -> "
          f"{s['residual_ms']:.3f} ms an evaluation); busy {d['device_busy_ms']} -> "
          f"{s['device_busy_ms']} ms, idle {d['idle_share']} -> {s['idle_share']}; "
          f"steps/s {d['steps_per_s']:.3f} -> {s['steps_per_s']:.3f}; bell_bmv "
          f"{d['bell_bmv_launches']} -> {s['bell_bmv_launches']} launches; "
          f"{time.perf_counter() - t0:.1f} s")
    if max(rel) > QUAD_RTOL or s["residual_launch_calls"] != 2:
        raise AssertionError(f"[18c] streamed vs default {rel}, bell_bmv launches an "
                             f"evaluation {s['residual_launch_calls']}")
    kern["quad_p2stream_launches"] = s["bell_bmv_launches"]
    return dict(out, rel_c=rel[0], rel_u=rel[1])


def phase_warm(torch, dev, usim):
    """[18d] on [6]'s model: WARM18_STEPS steps at the defaults, at
    GLIMS_WARM_ORDER=3 and at GLIMS_ALG_ANCHOR=0 (each read when the
    simulate is built), Newton and CG counts, c and u of each switch
    within UNSTRUCT_RTOL of the default run."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    t0 = time.perf_counter()
    args = (usim.make_theta(usim.params.as_dict()), *usim.initial_state())
    out, finals = {}, {}
    for way, env in (("default", {}), ("GLIMS_WARM_ORDER=3", {"GLIMS_WARM_ORDER": "3"}),
                     ("GLIMS_ALG_ANCHOR=0", {"GLIMS_ALG_ANCHOR": "0"})):
        # counted where the step takes it: set before the step is built
        evals = []
        rd = usim.rd_residual
        usim.rd_residual = lambda *a: evals.append(1) or rd(*a)
        os.environ.update(env)
        try:
            simulate = usim.build_simulate_fn(WARM18_STEPS, 1.0)
            for k in env:
                os.environ.pop(k)
            (u, c), launches, first_s = _drive(torch, usim, simulate, args,
                                               [(bk.batched_matvec,)],
                                               f"[18d] n={N} unstructured {way}:", WARM18_STEPS)
        finally:
            for k in env:
                os.environ.pop(k, None)
            del usim.rd_residual
        finals[way] = (u[-1], c[-1])
        out[way] = dict(cg_iters={k: [int(i) for i in usim.solver_info[k]]
                                  for k in ("rd_cg_iters", "el_cg_iters")},
                        rd_residual_evals=len(evals), first_s=first_s,
                        bell_bmv_launches=launches[bk.batched_matvec])
        if way != "default":
            rel = (_rel_l2(c[-1], finals["default"][1]), _rel_l2(u[-1], finals["default"][0]))
            out[way].update(rel_c=rel[0], rel_u=rel[1])
            print(f"[18d] {way} against the default: rel-L2 c {rel[0]:.3e}, u {rel[1]:.3e} "
                  f"(<= {UNSTRUCT_RTOL}); rd residual evaluations {len(evals)} against "
                  f"{out['default']['rd_residual_evals']}")
            if max(rel) > UNSTRUCT_RTOL:
                raise AssertionError(f"[18d] {way}: {rel}")
    print(f"[18d] {time.perf_counter() - t0:.1f} s")
    return out


# [19]: the reference's size and gate switches on the card.  Each
# way runs SW_STEPS step(s) on a model whose plans and frozen state are built
# under the switch (the cached ones set aside and put back after), with its
# set-up by part, CG counts, launches, busy and idle, and its state against
# the same model's default run; every bell_bmv shape a switch gives the
# kernel is held against plain and timed as [5] does (_bmv_check).
SW_STEPS = 1
# [19a]'s forward on the node block-ELL lane
ELL_STEPS = 2
# [19d]'s quad box (cut from [10]'s n=32: the uninterleaved flagship P2
# plan is Kh = 890, 248M slots at s = 32)
SW_QUAD_N = 16
SW_CACHED = ("_bell_plan", "_p2_plan", "_agg_plan", "_aux_cache", "_plan_seconds")


class _Switched:
    """``with _Switched(sim, env):`` the switches ``env`` set and the
    model's cached plans and frozen state set aside (plans it builds meanwhile
    are dropped from its mesh's cache at the end); with no switch the
    model as it is."""

    def __init__(self, sim, env):
        self.sim, self.env = sim, env

    def __enter__(self):
        sim = self.sim
        self.saved = {k: getattr(sim, k) for k in SW_CACHED}
        self.setup = getattr(sim, "setup_seconds", None)
        self.old = {k: os.environ.get(k) for k in self.env}
        self.plans = set(getattr(sim.mesh, "_plan_cache", {}))
        os.environ.update(self.env)
        if self.env:
            for k in SW_CACHED:
                # the aggregation plan depends on one switch only
                if k != "_agg_plan" or "GLIMS_TWOLEVEL_AGG" in self.env:
                    setattr(sim, k, {} if k == "_plan_seconds" else None)
        return sim

    def __exit__(self, *exc):
        sim = self.sim
        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for k, v in self.saved.items():
            setattr(sim, k, v)
        sim.setup_seconds = self.setup
        cache = getattr(sim.mesh, "_plan_cache", {})
        for k in set(cache) - self.plans:
            del cache[k]
        return False


def _known_shapes(kern):
    """The bell_bmv shapes that [5], [10a] and [19] have held and timed."""
    return {tuple(r["shape"]) for r in kern["shapes"] + kern.get("p2_shapes", [])
            + kern.get("switch_shapes", [])}


def _sw_shapes(torch, sim, aug, dev, tag, kern, known):
    """Hold and time (``_bmv_check``) each bell_bmv shape of the model's
    tables that no phase has held yet; ``known`` gains them and
    kern["switch_shapes"] their records."""
    roles, seen = [], set()
    for role, A in _bmv_roles(sim, aug):
        shape = tuple(A.shape)
        if shape not in known and shape not in seen:
            seen.add(shape)
            roles.append((role, A))
    if roles:
        recs = _bmv_check(torch, roles, dev, tag)
        kern.setdefault("switch_shapes", []).extend(recs)
        known.update(tuple(r["shape"]) for r in recs)


def _sw_way(torch, dev, sim, env, tag, n_steps, kern, known, base=None, extra=None):
    """One way of [19]: ``sim`` under the switches ``env`` (_Switched), its
    frozen state built and timed by part with the peak memory of the
    build, its new bell_bmv shapes held, one counted run, whose time
    stands for a timed run's (no second unprofiled run), and one profiled
    run, then ``extra(theta, aux, (u, c))`` (a dict of more numbers) under
    the switches too; the final state against ``base`` ((u, c) of the
    default run) within UNSTRUCT_RTOL.  Returns its numbers and final
    (u, c)."""
    from glimslib_tpu_torch.ops import bell_kernels as bk

    with _Switched(sim, env):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        aux = sim.runtime_aux()
        torch.cuda.synchronize()
        aux_s = time.perf_counter() - t0
        # the build's own peak: over what the card held before it
        aux_peak = (torch.cuda.max_memory_allocated(dev) - held) / 2**20
        theta = sim.make_theta(sim.params.as_dict())
        args = (theta, *sim.initial_state())
        sim._build_step()
        bell_lane = sim._use_bell()
        if bell_lane:
            aug = sim._augment_theta_with_operators({**theta, **aux})
            _sw_shapes(torch, sim, aug, dev, tag, kern, known)
            del aug
        simulate = sim.build_simulate_fn(n_steps, 1.0)
        bk.batched_matvec.launches_by_shape = {}
        groups = [(bk.batched_matvec,)] if bell_lane else []
        (u, c), launches, first_s = _drive(torch, sim, simulate, args, groups, tag,
                                           n_steps, shown=[bk.batched_matvec])
        by_shape = dict(bk.batched_matvec.launches_by_shape)
        if not bell_lane and launches[bk.batched_matvec]:
            raise AssertionError(f"{tag} bell_bmv launched off the supernode lane")
        missed = sorted(set(by_shape) - known)
        if missed:
            raise AssertionError(f"{tag} bell_bmv shapes no phase held: {missed}")
        iters = {k: [int(i) for i in sim.solver_info[k]] for k in ("rd_cg_iters",
                                                                    "el_cg_iters")}
        print(f"{tag} steps/s {n_steps / first_s:.4f} (the counted run)")
        _, busy, idle = _print_breakdown(torch, lambda: simulate(*args), 1e3 * first_s,
                                         tag, run_name="the counted run's")
        run = dict(steps_per_s=n_steps / first_s, device_busy_ms=busy, idle_share=idle)
        run_peak = torch.cuda.max_memory_allocated(dev) / 2**20
        setup = dict(sim.setup_seconds, frozen_state=aux_s)
        print(f"{tag} frozen state {aux_s:.2f} s (" + ", ".join(
            f"{k} {v:.2f}" for k, v in sim.setup_seconds.items()) + f"), keys "
            f"{sorted(aux)}; peak memory of the build {aux_peak:.1f} MiB over the "
            f"{held / 2**20:.1f} held before it; of the counted and profiled runs "
            f"{run_peak:.1f} MiB")
        out = dict(run, setup_s=setup, aux_keys=sorted(aux), aux_peak_mib=aux_peak,
                   run_peak_mib=run_peak, cg_iters=iters, first_s=first_s,
                   bell_bmv_launches=launches[bk.batched_matvec],
                   bell_bmv_by_shape={"x".join(map(str, k)): v for k, v in by_shape.items()})
        if bell_lane:
            out["weighted_bound_share"] = _bmv_split(
                {"shapes": kern["shapes"] + kern.get("p2_shapes", [])
                 + kern.get("switch_shapes", [])}, by_shape, tag)
        if extra is not None:
            out.update(extra(theta, aux, (u, c)))
    if base is not None:
        rel = (_rel_l2(c[-1], base[1]), _rel_l2(u[-1], base[0]))
        out.update(rel_c=rel[0], rel_u=rel[1])
        print(f"{tag} against the default run: rel-L2 c {rel[0]:.3e}, u {rel[1]:.3e} "
              f"(<= {UNSTRUCT_RTOL})")
        if max(rel) > UNSTRUCT_RTOL:
            raise AssertionError(f"{tag} against the default run {rel}")
    return out, (u[-1], c[-1])


def _ell_matvec_ms(torch, sim, theta, aux, tag):
    """The node block-ELL matvecs' device ms a call on the model's planes
    (``ops/ell.py``: plain torch, no TPU kernel behind them) beside their
    bound (the values and x read once, y written once)."""
    from glimslib_tpu_torch.ops import ell

    theta = sim._augment_theta_with_operators({**theta, **aux})
    adj = sim._get_ell_plan().adj_idx
    u, c = sim.initial_state()
    out = {}
    for name, fn, W, x in (("apply_ell_vector", ell.apply_ell_vector, theta["_EllWel"], u),
                           ("apply_ell_scalar", ell.apply_ell_scalar, theta["_EllWrd"], c)):
        ms, src = _call_device_ms(torch, lambda: fn(adj, W, x), reps=10)
        nbytes = W.numel() * 4 + adj.numel() * 8 + 2 * x.numel() * 4
        bound_ms, bound_by = _bound(nbytes, 2 * W.numel())
        print(f"{tag} {name} W {tuple(W.shape)}: {ms:.4f} ms of device time a call "
              f"({src}), bound {bound_ms:.4f} ms ({bound_by}) = "
              f"{100 * bound_ms / ms:.1f}%")
        out[name] = dict(shape=list(W.shape), device_ms=ms, bound_ms=bound_ms)
    return out


def phase_switches_p1(torch, dev, usim, uref, base6, kern, keep):
    """[19a] GLIMS_BELL=0 on [6]'s box: ELL_STEPS steps against [6]'s f64
    plain path and one value_and_grad of [7]'s unstructured cell, J held to
    [7]'s f64 J (its call reused); [19b] the size and gate switches on
    [6]'s box, SW_STEPS step(s) each beside the default."""
    import numpy as np

    from glimslib_tpu_torch.examples import UNSTRUCT_STEP_CONFIG
    from glimslib_tpu_torch.ops import bell_kernels as bk

    t_phase = time.perf_counter()
    usim.step_config = UNSTRUCT_STEP_CONFIG
    known = _known_shapes(kern)
    out = {}
    u_r, c_r = base6["ref_traj"]

    # [19a] the node block-ELL lane
    tag = f"[19a] n={N} GLIMS_BELL=0:"
    t0 = time.perf_counter()
    ip7, v0 = keep["adjoint_problems"][id(usim)]

    def ell_extra(theta, aux, final):
        u, c = final
        rel = (_rel_l2(c[-1], c_r[ELL_STEPS - 1]), _rel_l2(u[-1], u_r[ELL_STEPS - 1]))
        print(f"{tag} against [6]'s f64 plain path after {ELL_STEPS} steps: rel-L2 c "
              f"{rel[0]:.3e}, u {rel[1]:.3e} (<= {UNSTRUCT_RTOL})")
        if max(rel) > UNSTRUCT_RTOL:
            raise AssertionError(f"{tag} against the f64 plain path {rel}")
        ip = type(ip7)(usim, ip7.param_names, ip7.targets, update_fn=ip7.update_fn,
                       n_steps=ip7.n_steps, dt=ip7.dt)
        bk.batched_matvec.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        J, g = ip.value_and_grad(v0)
        torch.cuda.synchronize()
        vg_s = time.perf_counter() - t1
        if bk.batched_matvec.launches:
            raise AssertionError(f"{tag} bell_bmv launched in value_and_grad")
        info = {k: [int(i) for i in v] for k, v in usim.solver_info.items()}
        _, busy, idle = _print_breakdown(torch, lambda: ip.value_and_grad(v0), 1e3 * vg_s,
                                         f"{tag} value_and_grad:")
        # [7]'s f64 call on the same targets (_adjoint_lane's key)
        key = (id(uref), ip.n_steps, ip.dt, tuple(np.asarray(v0, np.float64).tolist()),
               tuple((k, v.data_ptr()) for k, v in sorted(ip.targets.items())))
        J64, g64 = keep["f64_calls"][key]
        rel_J = abs(J - J64) / abs(J64)
        rel_g = float(np.linalg.norm(g - g64) / np.linalg.norm(g64))
        print(f"{tag} value_and_grad {vg_s:.3f} s: J {J:.6e} against [7]'s f64 J "
              f"{J64:.6e}: rel {rel_J:.3e} (<= {ADJ_J_RTOL['unstructured']}), gradient "
              f"rel-L2 {rel_g:.3e} (<= {ADJ_G_RTOL['unstructured']}); adjoint CG rd "
              f"{info['rd_adj_cg_iters']}, elasticity {info['el_adj_cg_iters']}; "
              f"bell_bmv launches 0")
        if rel_J > ADJ_J_RTOL["unstructured"] or rel_g > ADJ_G_RTOL["unstructured"]:
            raise AssertionError(f"{tag} value_and_grad J {rel_J:.3e}, gradient {rel_g:.3e}")
        return dict(rel_c=rel[0], rel_u=rel[1],
                    matvecs=_ell_matvec_ms(torch, usim, theta, aux, tag),
                    value_and_grad=dict(seconds=vg_s, J=J, rel_J=rel_J, rel_grad=rel_g,
                                        device_busy_ms=busy, idle_share=idle,
                                        adjoint_cg_iters={"rd": info["rd_adj_cg_iters"],
                                                          "el": info["el_adj_cg_iters"]}))

    way, _ = _sw_way(torch, dev, usim, {"GLIMS_BELL": "0"}, tag, ELL_STEPS, kern, known,
                     extra=ell_extra)
    out["ell"] = way
    print(f"[19a] {time.perf_counter() - t0:.1f} s")

    # [19b] the size and gate switches, each against the default
    t0 = time.perf_counter()
    out["default"], base = _sw_way(torch, dev, usim, {}, f"[19b] n={N} default:", SW_STEPS,
                                   kern, known)
    for env in ({"GLIMS_BELL_S": "16"}, {"GLIMS_BELL_S": "64"}, {"GLIMS_TWOLEVEL": "0"},
                {"GLIMS_TWOLEVEL_AGG": "32"}, {"GLIMS_COARSE_K": "0"},
                {"GLIMS_TWOLEVEL_BF16": "0"}, {"GLIMS_FACTORED": "0"}):
        name = ",".join(f"{k}={v}" for k, v in env.items())
        tag = f"[19b] n={N} {name}:"
        extra = None
        if "GLIMS_FACTORED" in env:
            def extra(theta, aux, final, tag=tag):
                ms, src = _call_device_ms(
                    torch, lambda: usim._augment_theta_with_operators({**theta, **aux}))
                print(f"{tag} per-simulate assembly {ms:.3f} ms of device time ({src})")
                return dict(assembly_device_ms=ms)
        way, _ = _sw_way(torch, dev, usim, env, tag, SW_STEPS, kern, known, base, extra)
        out[name] = way
    print(f"[19b] {time.perf_counter() - t0:.1f} s")
    print(f"[19a-b] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _p2_plan_numbers(sim, tag):
    """The quad model's P2 plan: nb, s, Kh, gathered rows a block, dense
    slots and the index bytes of its placement."""
    pp = sim._get_p2_plan()
    slots = pp.nb * pp.s * pp.Kh
    print(f"{tag} P2 plan nb={pp.nb}, s={pp.s}, Kh={pp.Kh} (halo chunk "
          f"{pp.halo_chunk}: {pp.khe_rows} gathered rows a block for {pp.Khe} slots), "
          f"{slots} dense slots, {4 * slots / 1e6:.1f} MB a f32 plane")
    return dict(p2_plan=dict(nb=pp.nb, s=pp.s, Kh=pp.Kh, khe_rows=pp.khe_rows,
                             halo_chunk=pp.halo_chunk, slots=slots))


def phase_switches_quad(torch, dev, quad, quad10, kern):
    """[19c] on [10b]'s quad flagship (``quad``: its model and frozen state;
    ``quad10``: [10]'s numbers, the default's set-up and peak): GLIMS_P2_S=32,
    GLIMS_P2_HALO_CHUNK=4 and GLIMS_ASSEMBLE_CHUNK_SLOTS at the reference's
    32,000,000, SW_STEPS step(s) each beside the default, at the f32
    default (refined in f64: the exact P2 Jacobian, ``build_p2_rd_wc``,
    every Newton iteration); [19d] GLIMS_P2BELL=0 and GLIMS_P2_INTERLEAVE=0
    on the SW_QUAD_N box (its own mesh for the canonical P2 order), at the
    f32 default and newton_atol QUAD_NEWTON_ATOL, so that the lanes' states
    compare."""
    import numpy as np

    from glimslib_tpu_torch.examples import brain_sim
    from glimslib_tpu_torch.models.base import default_step_config
    from glimslib_tpu_torch.solvers.coupled import StepConfig

    t_phase = time.perf_counter()
    sim = quad["sim"]
    # the f32 default, refined: the exact P2 Jacobian every Newton iteration
    sim.step_config = default_step_config(torch.float32)
    sim._aux_cache = quad["aux"]
    known = _known_shapes(kern)
    out = {}
    tag = f"[19c] quad n={N} default:"
    out["quad_default"], base = _sw_way(torch, dev, sim, {}, tag, SW_STEPS, kern, known,
                                        extra=lambda *a: _p2_plan_numbers(sim, tag))
    # the default's frozen state was built in [10]
    out["quad_default"]["setup_s"] = quad10["setup_s"]
    out["quad_default"]["aux_peak_mib"] = quad10["frozen_state_peak_mib"]
    print(f"{tag} [10]'s frozen state: peak memory of the build "
          f"{quad10['frozen_state_peak_mib']:.1f} MiB over what the card held")
    for env in ({"GLIMS_P2_S": "32"}, {"GLIMS_P2_HALO_CHUNK": "4"},
                {"GLIMS_ASSEMBLE_CHUNK_SLOTS": "32000000"}):
        name = ",".join(f"{k}={v}" for k, v in env.items())
        tag = f"[19c] quad n={N} {name}:"
        out[name], _ = _sw_way(torch, dev, sim, env, tag, SW_STEPS, kern, known, base,
                               extra=lambda *a, tag=tag: _p2_plan_numbers(sim, tag))
        torch.cuda.empty_cache()
    del sim
    print(f"[19c] {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    cfg = StepConfig(**{**default_step_config(torch.float32)._asdict(),
                        "newton_atol": QUAD_NEWTON_ATOL})
    small = brain_sim(n=SW_QUAD_N, dtype=torch.float32, device=dev, unstructured=True,
                      quad=True)
    small.step_config = cfg
    tag = f"[19d] quad n={SW_QUAD_N} default:"
    out["quad_small_default"], base = _sw_way(torch, dev, small, {}, tag, SW_STEPS, kern, known,
                                         extra=lambda *a: _p2_plan_numbers(small, tag))
    tag = f"[19d] quad n={SW_QUAD_N} GLIMS_P2BELL=0:"
    out["GLIMS_P2BELL=0"], _ = _sw_way(torch, dev, small, {"GLIMS_P2BELL": "0"}, tag,
                                       SW_STEPS, kern, known, base)
    # the canonical P2 order is the mesh's: a model on a mesh of its own
    os.environ["GLIMS_P2_INTERLEAVE"] = "0"
    try:
        canon = brain_sim(n=SW_QUAD_N, dtype=torch.float32, device=dev, unstructured=True,
                          quad=True)
    finally:
        os.environ.pop("GLIMS_P2_INTERLEAVE")
    if not np.array_equal(canon.p2.dof_perm, np.arange(canon.p2.n_dofs)):
        raise AssertionError("[19d] GLIMS_P2_INTERLEAVE=0 did not give the canonical order")
    canon.step_config = cfg
    tag = f"[19d] quad n={SW_QUAD_N} GLIMS_P2_INTERLEAVE=0:"
    # its c in the canonical order against the default's, mapped there
    rank = torch.as_tensor(small.p2.dof_rank, device=dev)
    way, _ = _sw_way(torch, dev, canon, {"GLIMS_P2_INTERLEAVE": "0"}, tag, SW_STEPS, kern,
                     known, (base[0], base[1][rank]),
                     extra=lambda *a: _p2_plan_numbers(canon, tag))
    out["GLIMS_P2_INTERLEAVE=0"] = way
    del small, canon
    torch.cuda.empty_cache()
    print(f"[19d] {time.perf_counter() - t0:.1f} s")
    kern["max_abs_err"] = max([kern["max_abs_err"]] + [r["max_abs_err"] for r in
                                                       kern.get("switch_shapes", [])])
    print(f"[19c-d] phase {time.perf_counter() - t_phase:.1f} s")
    return out


# [20]: the public members the port gained last, on the kernels they
# reach: the mass and coupling tables built by build_bell_mass /
# build_bell_coupling_uc on [6]'s box, applied through bell_bmv, and
# cg_fixed_iters on [3]'s rd operator through stencil_apply, forward and
# backward (its gradient wrt b through the kernel's autograd rule).
API_CG_ITERS = 50
API_RTOL = 1e-5
API_BMV_RTOL = 1e-6
API_TABLE_RTOL = 1e-6


def _api_tables(torch, dev, usim):
    """[20a]: the two tables against the model's own planes, and their
    applies through bell_bmv (counted) against the plain apply."""
    import numpy as np

    from glimslib_tpu_torch.ops import bell
    from glimslib_tpu_torch.ops import bell_kernels as bk

    tag = f"[20a] n={N} unstructured:"
    theta = usim.make_theta(usim.params.as_dict())
    aug = usim._augment_theta_with_operators({**theta, **usim.runtime_aux()})
    plan, arrays = usim._get_bell_plan(), usim._mesh_arrays()
    M = bell.build_bell_mass(plan, arrays, usim.kernels._m0)
    C = bell.build_bell_coupling_uc(plan, arrays, theta["mu"], theta["lam"],
                                    theta["coupling"])
    same = {}
    for name, got, key in (("build_bell_mass", M, "_BellMrd"),
                           ("build_bell_coupling_uc", C, "_BellCuc")):
        _, rel = _rel_max(got, aug[key])
        same[name] = dict(bit_equal=bool(torch.equal(got, aug[key])), max_rel=rel)
        print(f"{tag} {name} {tuple(got.shape)} vs the model's {key}: bit-equal "
              f"{same[name]['bit_equal']}, max rel {rel:.3e} (<= {API_TABLE_RTOL})")
        if rel > API_TABLE_RTOL:
            raise AssertionError(f"{tag} {name} vs {key}: {rel:.3e}")
    n = usim.mesh.n_nodes
    c = torch.as_tensor(np.random.default_rng(20).random(n), dtype=torch.float32,
                        device=dev)
    bk.batched_matvec.launches = 0
    bk.batched_matvec.launches_by_shape = {}
    y_m = bell.apply_bell_scalar(plan, M, c, bk.batched_matvec)
    y_c = bell.apply_bell_coupling(plan, C, c, bk.batched_matvec)
    torch.cuda.synchronize()
    launches = bk.batched_matvec.launches
    by_shape = dict(bk.batched_matvec.launches_by_shape)
    if launches != 2:
        raise AssertionError(f"{tag} bell_bmv launched {launches} times, not 2")
    errs = {}
    for name, got, want in (
            ("mass apply", y_m, bell.apply_bell_scalar(plan, M, c, bk.batched_matvec_plain)),
            ("coupling apply", y_c,
             bell.apply_bell_coupling(plan, C, c, bk.batched_matvec_plain))):
        err, rel = _rel_max(got, want)
        errs[name] = rel
        print(f"{tag} {name} through bell_bmv vs the plain apply: max abs err {err:.3e}, "
              f"max rel {rel:.3e} (<= {API_BMV_RTOL})")
        if not bool(torch.isfinite(got).all()) or rel > API_BMV_RTOL:
            raise AssertionError(f"{tag} {name}: {rel:.3e}")
    nb, s, Kh, d = plan.nb, plan.s, plan.Kh, usim.mesh.dim
    shapes = _bmv_check(torch, [("mass build_bell_mass", M),
                                ("coupling build_bell_coupling_uc",
                                 C.reshape(nb, s * d, Kh))], dev, "[20a]")
    rows = []
    for rec in shapes:
        B, Mr, K = rec["shape"]
        rows.append(dict(
            name=f"bell_bmv@[20a] {rec['role']} ({B}, {Mr}, {K})", route="cuda",
            source=BELL_SRC, replaces="glimslib_tpu/ops/bell_pallas.py:56",
            wrappers=(bk.batched_matvec,), launches=by_shape.get((B, Mr, K), 0),
            launches_in=f"{tag} the two applies", max_abs_err=rec["max_abs_err"],
            ms=rec["device_ms"], plain_ms=rec["plain_ms"], bound_ms=rec["bound_ms"],
            bound_by=rec["bound_by"], library_ms=rec["library_ms"], call_ms=rec["ms"]))
    return rows, dict(tables=same, applies_max_rel=errs, bell_bmv_launches=launches,
                      by_shape={"x".join(map(str, k)): v for k, v in by_shape.items()})


def _api_cg(torch, dev, sim):
    """[20b]: cg_fixed_iters on [3]'s rd operator (its theta-only planes
    _Wrd_const) with Jacobi, through stencil_apply (counted forward and
    backward) and the plain apply: x and the gradient of |x|^2 wrt b."""
    import numpy as np

    from glimslib_tpu_torch.ops import stencil_kernels as sk
    from glimslib_tpu_torch.solvers.cg import cg_fixed_iters

    tag = f"[20b] N={N} lattice:"
    theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    offs, W = sim._stencil_ops.offsets, theta["_Wrd_const"].detach()
    diag = W[list(offs).index(0)]
    cache = sk.MirrorCache([W])
    b0 = torch.as_tensor(np.random.default_rng(20).standard_normal(sim.mesh.n_nodes),
                         dtype=torch.float32, device=dev)

    def solve(apply):
        """x and d|x|^2/db, and the launches of each."""
        sk.apply_scalar.launches = 0
        b = b0.clone().requires_grad_(True)
        x = cg_fixed_iters(apply, b, M=lambda r: r / diag, iters=API_CG_ITERS)
        torch.cuda.synchronize()
        fwd = sk.apply_scalar.launches
        sk.apply_scalar.launches = 0
        (g,) = torch.autograd.grad(torch.sum(x * x), b)
        torch.cuda.synchronize()
        return x.detach(), g, fwd, sk.apply_scalar.launches

    t0 = time.perf_counter()
    x, g, fwd, bwd = solve(lambda v: sk.apply_scalar(offs, W, v, cache=cache))
    run_s = time.perf_counter() - t0
    # A(x0) at x0 = 0 needs no gradient: one more launch forward
    if fwd != API_CG_ITERS + 1 or bwd != API_CG_ITERS:
        raise AssertionError(f"{tag} stencil_apply launches forward {fwd}, backward {bwd}")
    x_p, g_p, _, _ = solve(lambda v: sk.apply_scalar_plain(offs, W, v))
    res = float((sk.apply_scalar_plain(offs, W, x) - b0).norm() / b0.norm())
    rel = (_rel_max(x, x_p)[1], _rel_max(g, g_p)[1])
    print(f"{tag} cg_fixed_iters({API_CG_ITERS}) through stencil_apply: {fwd} launches "
          f"forward, {bwd} backward (transposed, mirrored planes), {run_s:.3f} s; "
          f"residual {res:.3e}; x vs the plain apply max rel {rel[0]:.3e}, gradient "
          f"wrt b {rel[1]:.3e} (<= {API_RTOL})")
    if max(rel) > API_RTOL or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{tag} kernel vs plain {rel}")
    n = sim.mesh.n_nodes
    v = torch.as_tensor(np.random.default_rng(21).standard_normal(n), dtype=torch.float32,
                        device=dev)
    A = _csr(torch, offs, [(W.reshape(len(offs), 1, 1, n), 1.0, 0)], n, 1, 1, n)
    row = _apply_row(torch, f"stencil_apply<1,1>@[20b] N={N} rd operator", sk.apply_scalar,
                     sk.apply_scalar_plain, (offs, W, v), lambda: torch.mv(A, v), (n,),
                     (sk.apply_scalar,), r"stencil_apply_kernel<1, ?1, ?1>",
                     4 * (W.numel() + 2 * n), 2 * W.numel(),
                     "glimslib_tpu/ops/stencil_pallas.py:108", "[20b]", _cold_l2(torch, dev))
    row.update(launches=fwd + bwd, launches_forward=fwd, launches_backward=bwd,
               launches_in=f"{tag} cg_fixed_iters and its gradient")
    return [row], dict(launches_forward=fwd, launches_backward=bwd, seconds=run_s,
                       residual=res, x_max_rel=rel[0], grad_max_rel=rel[1])


def _api_p1(torch, dev, usim):
    """[20c]: stiffness_residual and integrate_p1 on [6]'s box on the card
    (f32) against the f64 CPU kernels."""
    import numpy as np

    from glimslib_tpu_torch.ops.assembly import P1Kernels

    tag = f"[20c] n={N} unstructured:"
    k64 = P1Kernels(usim.mesh, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(22)
    c = rng.random(usim.mesh.n_nodes)
    D = 0.5 + rng.random(usim.mesh.n_cells)
    kc = usim.kernels
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)  # noqa: E731
    out = {}
    for name, got, want in (
            ("stiffness_residual", kc.stiffness_residual(f32(c), f32(D)),
             k64.stiffness_residual(torch.as_tensor(c), torch.as_tensor(D))),
            ("integrate_p1", kc.integrate_p1(f32(c)), k64.integrate_p1(torch.as_tensor(c)))):
        _, rel = _rel_max(got.cpu(), want)
        out[name] = rel
        print(f"{tag} {name} on the card (f32) vs f64 on the CPU: max rel {rel:.3e} "
              f"(<= {API_RTOL})")
        if rel > API_RTOL:
            raise AssertionError(f"{tag} {name}: {rel:.3e}")
    return out


def phase_api(torch, dev, sim, usim, kernels):
    """[20] (module docstring); adds its rows to ``kernels``."""
    t0 = time.perf_counter()
    rows, tables = _api_tables(torch, dev, usim)
    cg_rows, cg = _api_cg(torch, dev, sim)
    p1 = _api_p1(torch, dev, usim)
    kernels += rows + cg_rows
    out = dict(bell=tables, cg_fixed_iters=cg, p1=p1, seconds=time.perf_counter() - t0)
    print(f"[20] API phase {out['seconds']:.1f} s")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from glimslib_tpu_torch.examples import BENCH_STEP_CONFIG, brain_sim

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = phase_device(torch)

    t0 = time.perf_counter()
    sim = brain_sim(n=N, dtype=torch.float32, device=dev)
    sim.step_config = BENCH_STEP_CONFIG
    sim._build_step()
    theta = sim._augment_theta_with_operators(sim.make_theta(sim.params.as_dict()))
    torch.cuda.synchronize()
    print(f"[2] N={N} model set-up {time.perf_counter() - t0:.1f} s")
    kernels = phase_kernels(torch, sim, theta, dev)
    del theta
    keep = {}
    ref, lat_state, lat_rel = phase_slice(
        torch, sim, brain_sim(n=N, dtype=torch.float64, device=dev, plain=True), dev,
        kernels, f"[3] N={N}:", N_STEPS, keep=keep)

    t0 = time.perf_counter()
    big = brain_sim(n=N64, dtype=torch.float32, device=dev)
    big.step_config = BENCH_STEP_CONFIG
    torch.cuda.synchronize()
    print(f"[4] N={N64} model set-up {time.perf_counter() - t0:.1f} s")
    kernels += phase_lattice_big(torch, dev, big, "[4]", f"@N={N64}", N64_STEPS)
    del big
    torch.cuda.empty_cache()

    kern, usim, uref, base6 = phase_unstructured(torch, dev)
    kernels.append(kern)

    adjoint = phase_adjoint(torch, sim, usim, (ref, uref), kernels, keep)

    rows2d, adjoint2d, bmv2d = phase_2d(torch, dev)
    kernels += rows2d
    adjoint.update(adjoint2d)
    kern["atlas_2d_adjoint_launches"] = bmv2d

    defaults = phase_defaults(torch, dev, (sim, ref, lat_state, lat_rel),
                              (usim, uref, base6), keep)
    switches = phase_switches_p1(torch, dev, usim, uref, base6, kern, keep)
    del keep["adjoint_problems"], keep["f64_calls"]
    aux6 = usim.runtime_aux()
    keep["p1"]["table_bytes"] = _table_bytes(usim._augment_theta_with_operators(
        {**usim.make_theta(usim.params.as_dict()), **aux6}))
    del ref, uref, base6, aux6
    torch.cuda.empty_cache()

    quad = phase_quad(torch, dev, kern, keep)
    torch.cuda.empty_cache()

    matrix_free = phase_matrix_free(torch, dev, sim, kernels, kern, keep)
    torch.cuda.empty_cache()

    chebyshev = phase_chebyshev(torch, dev, sim, usim, kernels, kern)
    torch.cuda.empty_cache()

    phase18 = {"mg": phase_mg(torch, dev, sim, kernels)}
    phase18["p2stream"] = phase_p2stream(torch, dev, keep["quad18"], kern)
    phase18["warm"] = phase_warm(torch, dev, usim)
    switches.update(phase_switches_quad(torch, dev, keep.pop("quad18"), quad, kern))
    api = phase_api(torch, dev, sim, usim, kernels)
    meshes17 = [sim.mesh]
    del sim
    torch.cuda.empty_cache()

    shard = phase_shard(torch, dev, kern, usim, keep)
    lat_vg, nodes_ranks = keep["lattice"], keep["nodes_ranks"]
    shard16_ranks, vn17_ranks = keep["shard16_ranks"], keep["vn17_ranks"]
    meshes17.append(usim.mesh)
    del usim, keep
    torch.cuda.empty_cache()

    workflow = phase_workflow(torch, dev, kernels)
    torch.cuda.empty_cache()

    examples, example_checks = phase_examples(torch, dev, kernels)
    torch.cuda.empty_cache()

    nodes = phase_nodes(torch, dev, kernels, lat_state, lat_vg, nodes_ranks)
    torch.cuda.empty_cache()

    cells_nodes = phase_cells_nodes(torch, dev, shard16_ranks)
    torch.cuda.empty_cache()

    vn_shard = phase_vn_shard(torch, dev, vn17_ranks, meshes17)
    del meshes17
    torch.cuda.empty_cache()

    drop = ("wrappers", "pattern", "iters")
    example_checks = {shape: [{k: v for k, v in row.items() if k not in drop}
                              for row in rows] for shape, rows in example_checks.items()}
    print(json.dumps({"api": api}, default=str))
    print(json.dumps({"switches": switches}, default=str))
    print(json.dumps({"phase18": phase18}, default=str))
    print(json.dumps({"chebyshev": chebyshev, "vn_shard": vn_shard}, default=str))
    print(json.dumps({"cells_nodes": cells_nodes}, default=str))
    print(json.dumps({"matrix_free": matrix_free}, default=str))
    print(json.dumps({"nodes": nodes}, default=str))
    print(json.dumps({"sharding": shard}, default=str))
    print(json.dumps({"examples": examples, "examples_kernel_checks": example_checks},
                     default=str))
    print(json.dumps({"workflow": workflow}, default=str))
    print(json.dumps({"quad": quad}, default=str))
    print(json.dumps({"defaults": defaults}, default=str))
    print(json.dumps({"adjoint": adjoint}))
    print(json.dumps({"kernels": [
        {k: v for k, v in kern.items() if k not in drop} for kern in kernels
    ]}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
