"""Drive the PyTorch port's main path once on an NVIDIA GPU, and check it.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases, one line of output each (JSON where it carries numbers):

0. device: the card's name and power limit (nvidia-smi), or exit non-zero
   when there is no CUDA device; nothing runs on the CPU instead;
1. build: the CUDA kernels, built with nvcc from diffmpc_tpu_torch/csrc
   (one nvcc per source, in parallel), its seconds, each source's, and each
   kernel's registers, spills and stack frame; the Riccati sweep's sources
   and lane kernels apart; no GNU unique symbol (nm -D, type u: a
   function-local static of an inline function or template, shared by
   every library of the process) exported by the library or by a second
   build of the sources that hold the Riccati and KKT launch caches
   (csrc/build.py build_with, as the A/B diagnostics' --parent and
   --profile builds are made), nor, in phase 30, by any variant's library;
2. kernel vs plain: the fused iLQR kernel against its plain PyTorch version
   on the card, at the main-path problem (pendulum, T=20, B=1024, and the
   ragged B=1000; lqr_iter=10, eps=1e-5), one iteration at eps=0, a warm
   start, and unroll=True (the exact-power ladder: every chosen alpha one of
   the float32 powers decay**k);
3. main path: the port's mpc_solve at the flagship configuration
   (pendulum, goal cost, box +-2, T=20, B=1024, lqr_iter=10), with the
   kernel's launch count, against the same solve on the CPU;
4. time: the solve at B=1024 and B=65,536, kernel and plain version, by
   CUDA events (best of several loops), with the kernel's bound at both;
4b. iLQR lanes (diffmpc_tpu_torch.diagnostics.ab_ilqr_lanes): the fused
   kernel at each built lane count L (threads per scenario) on the same
   staged inputs, the pendulum at B=1024, 1000 and 65,536 and the bench's
   MLP (phase 22's) at B=1024 and 65,536 without and with hoist_lin: per L
   the share of scenarios bit-equal to L = 1 on xs, us, objs, n_iters and
   alpha (raises below 100%) and the kernel's time alone by CUDA events,
   the wrapper's pick (ops/cuda/ilqr.py, ilqr_lanes) marked;
5. KKT kernel vs plain: the fused KKT backward against its plain PyTorch
   version on the card at T=20, B=1024 and the ragged B=1000, on the main
   path's own residuals (the solved trajectory, its linearization and the
   gradient of mean(us**2)) and on random residuals with ~20% tight
   controls; every output within 1e-4 * max(1, max|plain|);
6. gradient on the main path: torch.autograd.grad of mean(us**2) through
   mpc_solve with respect to the env's params, x_init and the cost's
   weights q, with one launch of each kernel, against the same on the CPU;
7. training: 40 imitation-learning steps of make_dp_train_step at B=1024;
   the loss must stay finite and end below where it started;
8. time: solve + gradient against the forward of the same loop, in strict
   alternation, at B=1024 and B=65,536, and the KKT kernel alone (at the
   wrapper's lane count) against its wrapper's call and its plain version,
   with its bound (bytes, the shared C read in place counted once a step;
   operations; the chain of 3 T steps, kkt_step_depth);
9. Riccati kernel vs plain: the non-fused path's Riccati sweep against its
   plain version on the card, box mode at n=4, m=2 (B=128, the ragged 1000
   and 65,536) and n=4, m=1, free and mask modes at n=3, m=2; ties (box
   QPs the two sides resolve to different candidates: another free flag,
   k or QP count) on at most 0.1% of those entries, each scenario's first
   one a tie (both answers within 1e-5 of the QP's scale on the plain
   version's QP), and
   K, k within 1e-4 * max(1, max|plain|) on every scenario without one; at
   the wrapper's lane count (ops/cuda/riccati.py, riccati_lanes);
10. rollout kernel vs plain: the line search on linear dynamics with and
   without a box and on the pendulum's step, B=1024, T=20, at the wrapper's
   lane count; objs within 1e-5 of the batch's largest |objs|, alpha equal
   on >= 99%, xs, us within 1e-4 where alpha agrees;
10b. rollout lanes (diffmpc_tpu_torch.diagnostics.ab_rollout_lanes): the
   line searches of one mpc_solve each of config 2 at T=20 and T=128
   (B=128, 4096, 16,384, 65,536), the pendulum with FINITE_DIFF at T=20
   (B=1024, 65,536) and T=256 (B=1024) and the bench MLP with verbose=1 at
   T=15 and T=128 (B=1024, and 65,536 tiled from 1024's),
   recorded, then run on the same staged inputs through the resident
   kernel and the twin at every built lane count L: per kernel and L the
   share of scenarios bit-equal to the resident kernel at L = 1 (raises
   below 100%) and the time alone summed over the solve's calls, by CUDA
   events, interleaved, the wrapper's pick (ops/cuda/rollout.py,
   rollout_lanes) marked;
11. the non-fused path: mpc_solve on LinDx at BASELINE.json config 2
   (box-DDP n=4, m=2, T=20, B=128, box +-0.6) and config 1 (unconstrained
   n=3, m=2, T=10, B=32), with the launch counts (Riccati and rollout once
   per iteration, iLQR and KKT never), against the same solve on the CPU
   (objectives within 1e-5 per scenario, controls within 1e-4 on >= 95%
   of the scenarios and 5e-3 on all: a box-QP tie can leave a scenario
   elsewhere on the same float32 objective) and against the problem's
   optimum in float64 (every scenario's objective within 1e-5 of it);
   the two goldens of tests/golden on the card; the gradient (one KKT
   launch) against the CPU and the KKT kernel against the composite
   backward; the pendulum with FINITE_DIFF at B=1024 against the CPU;
12. time: config 2 at B=128, 4096 and 65,536: mpc_solve, each kernel alone
   (each at its wrapper's lane count), each wrapper's
   staging, each plain version once, and the cost of the loop's one read of
   the done mask per iteration; the rollout's bound counts the rollouts
   its inputs need and one scenario's chain, the Riccati kernel's its chain
   of T steps (riccati_step_depth);
13. dispatch: which kernel, resident or streaming twin, each (n, m) of the
   kernels' table takes at T = 20, 64, 128 and 512 (ops/cuda/horizon.py, the
   JAX package's choice);
14. the Riccati twin against its plain version and its resident sibling: box
   n=4, m=2 at T=128, B=128, 4096 and 65,536; free n=3, m=2 and mask n=4,
   m=2 at T=128; box n=3, m=1 at T=512; phase 9's rule for ties;
14b. Riccati lanes (diffmpc_tpu_torch.diagnostics.ab_riccati_lanes): the
   Riccati sweeps of one mpc_solve each of config 2 at T=20 (the resident
   kernel) and T=128 (the twin), B=128, 4096 and 65,536, and of the
   pendulum with FINITE_DIFF at T=20 and T=256 (B=1024), recorded, then run
   on the same staged inputs through the resident kernel and the twin at
   every built lane count L: per kernel and L the share of scenarios
   bit-equal to the resident kernel at L = 1 (raises below 100%) and the
   time alone summed over the solve's calls, by CUDA events, interleaved,
   the wrapper's pick (riccati_lanes) marked; the simplified value update
   at L = 1 and at the pick (bit-equal to each other, and its time);
15. the rollout twin against its plain version and its resident sibling:
   linear with and without a box at T=128, the pendulum's step at T=256;
   objs within 1e-5 of the batch's largest, alpha equal on >= 99%, xs, us
   within 1e-4 where alpha agrees (for the chaotic pendulum against the
   resident kernel only);
16. the KKT twin against its plain version and the resident KKT kernel: n=4,
   m=2 at T=128 and n=3, m=1 at T=512, within 1e-4 * max(1, max|plain|);
17. the slice: mpc_solve on config 2 at T=128 (lqr_iter 20) with the
   gradient of a fixed loss, at B=128, 4096 and 65,536, launching the
   Riccati and rollout twins once per iteration, the KKT twin once and no
   resident kernel; at B=128 against the CPU (phase 11's rule), the float64
   optimum (every scenario within 1e-5) and the CPU's gradients (1e-3 of
   their max-abs on the agreeing scenarios); the pendulum at T=512 (fused
   forward, gradient through the KKT twin) against the same gradient with
   the CPU's plain KKT; the pendulum at T=256 with FINITE_DIFF through the
   twins against the same solve through the resident kernels;
18. time: each twin against its resident sibling, kernels alone on the same
   inputs (the Riccati, rollout and KKT kernels at the wrappers' lane counts), at T = 20,
   128, 512 and B = 128, 4096, 65,536, with their bounds;
   the plain versions once at T=128, B=128; and config 2's mpc_solve at
   T=128, forward and forward + gradient.
19. the depth-blocked Riccati kernel (one thread per (block, scenario))
   against its plain version (K, k within 1e-4 * max(1, max|plain|)) and
   the serial kernel's free mode (5e-4 of its scale, beside the two plain
   versions' own distance) at n=3, m=1, T=20, B=1024 and 1000, and n=4,
   m=2, T=128, B=128, D = 2 and 4; at (4, 2), D = 2, the longest horizon
   one CTA holds (rb.max_horizon) against the plain version on the host and
   the serial kernel; its three ValueErrors on the card (a block other than
   2 or 4, one that does not divide T, a horizon past the longest);
20. the A/B (diffmpc_tpu_torch.diagnostics.ab_blocked_ilp, its counts set
   to 0 before and read after): the serial kernel against the blocked one
   at D = 2 and 4, kernels alone, interleaved, at the JAX
   script's three shapes, BASELINE.json config 1's and n=4, m=2 at T=128,
   B=128, with the bytes bound and the chain floor of each; at every shape
   the blocked outputs within 5e-4 of the serial kernel's scale and 1e-4
   of the plain version's;
21. the piece kernels against their plain versions at reps 1 and 9 (T=20,
   B=1024 and 65,536; the sweep at one lane reading device memory: K, k
   within 1e-4 * max(1, max|plain|), or outside it on <= 0.1% of
   scenarios, each one where float32 alone moves the plain version > 1e-6
   of the scale from the float64 plain version; at every built lane count,
   staged and not, bit-equal to it; each rollout objective within 1e-5 of
   its sum of |stage costs|, and at reps 1 the card's and the plain
   version's objectives within the same of the float64 plain version's),
   the rollout at one lane reading device memory, held so, and at every
   built lane count in both read modes bit-equal to it), then the piece
   decomposition (diffmpc_tpu_torch.diagnostics.profile_riccati_pieces,
   counted the same way): at the fused kernel's lane count, reading device
   memory and staged, the per-sweep slopes and each piece at B=1024 and
   65,536, the rollout's slopes in both modes at that lane count and at
   one lane, the full and rollout slopes beside phase 4's iLQR kernel time
   per iteration;
22. learned dynamics, the kernels against their plain versions: the fused
   iLQR kernel with the MLP step of the JAX bench's NNDynamics (3-16-16-3,
   residual, tanh; bench.py:592-624) at T=15, B=1024 and the ragged 1000,
   lqr_iter=2, hoist_lin off and on, with the float64 plain solve as the
   witness (witnessed_agreement), and the count of scenarios where on and off
   differ bit for bit; the rollout kernel's MLP step (T=15, phase 10's rule)
   and its twin's (T=128, phase 15's rule for the chaotic pendulum);
23. the learned-dynamics path through mpc_solve (T=15, lqr_iter=8, B=1024):
   one iLQR launch and no Riccati or rollout launch, against the same solve
   on the CPU; with hoist_lin; the gradient of mean(us**2) with respect to
   every weight and bias through one KKT launch, against the same gradient
   at the card's fixed point on the CPU (1e-3 of each max-abs); an MLP too
   large for the kernels (64, 64) through the non-fused loop (one Riccati
   launch per iteration, no rollout launch: the ladder is plain PyTorch);
   the 3-16-16-3 MLP with verbose=1 through the rollout kernel, and at
   T=128 through the rollout twin;
24. 40 imitation-learning steps of the MLP at B=1024 (detach_unconverged
   off, the near-upright regime of tests/test_imitation.py:79-83): a finite
   loss that ends below where it started, grad_norm > 0;
25. time: the MLP's fused kernel alone at B=1024 and 65,536, hoist_lin off
   and on, at the wrapper's lane count, interleaved by CUDA events, with the
   bytes bound and the chain floor; mpc_solve and solve + gradient in strict
   alternation; the rollout kernel and twin alone at the wrapper's lane
   count, with the chain in their bounds; each plain version timed once
   after a call to warm up (the fused solve's at two iterations).
26. the kernel-under-the-mesh probe (csrc/shard_probe.cu, the TPU kernel of
   tests/test_pallas_sharding.py:221) against its plain version, bit-equal,
   at shards of 1, 2, 3, 8, 16, 32,768 and 65,536, and at 8, 1027 and
   65,536 with the shard and the output 1-3 floats off a 16-byte boundary;
   at each size its wrapper's call (200 calls by CUDA events), the
   kernel alone and an empty kernel (the launch floor), each 100 launches
   in one CUDA graph replayed in the same rounds, its plain version's and
   the library call's (x[idx].sum() broadcast);
27. one rank over NCCL in this process (diffmpc_tpu_torch.parallel): the
   dry run of parallel/dryrun.py on config 5 of BASELINE.json at
   B=65,536 (per-scenario params, params_batch_axes=0, SGD 1e-2, u_expert =
   0) through make_mesh and shard_batch, the fused solve, three imitation
   steps with replicated params (B=1024) and the probe, equal to the same
   without a mesh exactly (one rank's all_reduce is the identity), with the
   launch counts (counts set to 0 before, read after); the iLQR and KKT
   kernels on the inputs one such step gives them (per-scenario params, B =
   65,536), recorded and run again beside their plain versions: the iLQR
   kernel by phase 2's rule on the first 1024 scenarios and, on all of
   them, by phase 22's with the float64 plain solve as the witness and
   phase 2's ties, as the shared-params kernel is held at that batch; the
   KKT kernel by phase 5's; the time-sharded Riccati at D=1, given its
   shard of the horizon, against the serial kernel's free mode (5e-4 of its
   scale);
28. two ranks over gloo sharing the card (NCCL refuses two ranks on one
   device), 32,768 scenarios each, spawned by parallel/dryrun.py: each rank
   launches the probe once, one iLQR and one KKT kernel in its step; the
   sharded solve's controls within 1e-5 of one process's (bit-equal
   scenarios counted); the step's loss and gradient norm within 1e-5
   relative, param rows within rtol 1e-3 / atol 1e-4 and their change by the
   step within 1e-3 of its max-abs; the imitation params within 1e-3 of
   their max-abs and its gradient norms within 1e-5 relative;
   gather_results in rank order;
29. time: the step on a one-rank mesh against the step without a mesh, in
   strict alternation (the mesh's own cost); the step's all_reduce alone;
   each of the two ranks' steps and all_reduce, two processes taking turns
   on one card (not a scaling figure).

30. the kernels built at first use (csrc/build.py's variants), all of the
   slice's in one parallel build: its seconds, each key's units' seconds
   and each key's registers, spills and stack frame; no GNU unique symbol
   in any key's library;
31. each variant kernel against its plain version: the Riccati sweep at
   (6, 3) in box mode under pnqp_enum "", "0" and "1" (B=4096), free and
   mask modes, and at (4, 2) under "0" (phase 9's rule for ties), every
   built lane count bit-equal to one lane; the fused solve of the (6, 3)
   MLP of scripts/ab_pnqp_enum3.py (16-16, residual) under "" and "1" and a
   3-32-3 MLP, two iterations by phase 22's rule (the float64 plain solve
   as the witness, phase 2's ties), every built lane count of the (6, 3)
   MLP with and without hoist_lin bit-equal to one lane over three
   iterations; the pendulum with the simplified value
   update (one iteration within 1e-4, ten by the chaos rule); the KKT
   kernel and twin at (6, 3) and, with the simplified update, at (3, 1) on
   the main path's residuals (phase 5's rule); the line search at (6, 3)
   (phase 10's rule, the trajectory by the float64 plain version as the
   witness: its states reach hundreds), every built lane count bit-equal
   to one lane; with
   each kernel's time, its plain version's and its bound;
32. the slice's MLP through mpc_solve at B=1024, T=20, lqr_iter=10,
   pnqp_iter=8, box +-0.5 under "" and "1": one iLQR launch each, the
   converged share, the times; under "1" the kernel's first 64 scenarios
   held against the plain solve on the host by phase 22's counts (the float64
   plain solve as the witness: the kernel off it on no more scenarios than
   twice the float32 plain solve, plus 0.5%); the gradient of
   an imitation loss over every weight and bias through one KKT launch at
   (6, 3), against the host's float64 gradient at the card's fixed point
   (1e-3 of each leaf's max-abs, or twice the host's float32 distance);
33. a (6, 3) LinDx box-DDP at B=4096 (config 2's recipe, its dynamics
   scaled to config 2's open-loop growth) under "" and "1"
   through mpc_solve + gradient (the Riccati, rollout and KKT variants; one
   Riccati and one rollout launch an iteration, one KKT launch), its first
   64 scenarios against the host (phase 11's rule, the objectives on the
   scenarios converged on both sides) and, those, under "1" against the
   float64 optimum; the solve's last line search with its cost zeroed, so
   that no candidate improves (nothing_improves_case: the rolled and the
   unrolled ladder against the plain version by phase 10's rule, the
   float64 witness, every built lane count of the kernel and its twin
   bit-equal to one lane); and the launches of the simplified update's
   kernels (the flagship's solve + gradient, the pendulum at T=512 through
   the KKT twin) and of the (4, 2) sweep under "0" (config 2 at B=128).

34. KKT lanes (diffmpc_tpu_torch.diagnostics.ab_kkt_lanes): the KKT call of
   each recorded solve + gradient (the headline at B=1024 and 65,536, the
   (6, 3) MLP's imitation gradient at 1024, a (6, 3) LinDx at 4096, config 2
   at T=20 and 128, B=128, 4096 and 65,536, the pendulum at T=512) through
   the kernel the dispatch takes at every built lane count, one lane with and
   without its prefetch, the resident kernel above one lane with K, k, p on
   chip and in device memory, all on the same staged inputs: bit-equal to
   one lane (raises otherwise), one lane within 1e-4 * max(1, max|plain|) of
   the plain version, every launch that fails raising, the kernels' times
   by CUDA events in each round, the rule's pick, the wrapper's call and its
   staging. The parent commit's kernels are timed beside by the diagnostic
   alone (``--parent DIR``), where the person who runs it names that tree.

35. the dynamics zoo's headline, BASELINE.json config 4 (examples/
   il_cartpole.py:52-99): the cartpole at T=20, lqr_iter=10, eps=1e-5,
   u in [-10, 10], B=4096, its starts drawn with numpy as
   examples/common.py:35-43 draws them; the expert's controls from the true
   params, then the main path, the expert data and five Adam steps (lr 2e-2)
   of make_dp_train_step learning {"dyn", "logq"} from il_cartpole.py's
   perturbed start, each step one iLQR launch of the cartpole's variant and
   one KKT launch at (5, 1) (the counts set to 0 before the main path and
   read after it), a finite loss at each, their ms, converged share and
   loss; the first step's gradient on the first 64 scenarios against the
   host's float64 gradient at the card's fixed point (phase 32's rule) and
   its norms; each step's forward solve, attach and KKT wrapper timed in
   place on the card and the host; the card's idle share of the step after
   four, profiled in a fresh process first (one_robot_profile example, the
   one process that profiles phase 39's examples: il_cartpole at its
   defaults is config 4; its trace must hold the iLQR and KKT kernels); the
   KKT kernel at (5, 1) alone on the first step's inputs;
35b. each env's fused kernel (CartpoleDx, VehicleDx, QuadrotorDx,
   AcrobotDx: its own C++ step, csrc/<env>.cuh) against its plain version,
   B=256, two iterations, by phase 22's rule (the float64 plain solve as the
   witness), the cartpole with per-scenario params too; every built lane
   count with and without hoist_lin bit-equal to one lane over three
   iterations; the kernel alone at the rule's lane count, the wrapper and
   the plain version timed, with the bound (the step's operations counted
   from its header);
36. each env through mpc_solve at its example's width (the cartpole
   B=4096, T=20; the vehicle B=1024, T=20, lqr_iter=10, its per-dimension
   box; the quadrotor B=1024, T=20, lqr_iter=14, box [0, 5]; the acrobot
   B=1024, T=25, lqr_iter=10, box +-4): one iLQR launch, the converged
   share, the times, the first 64 scenarios against the host's plain solve
   (phase 22's rule; the cartpole's at config 4's B=4096 and lqr_iter=10);
   for the last three the imitation loss's gradient through one iLQR and
   one KKT launch against the host's float64 gradient (phase 32's rule);
36b. the line search with each env's step: mpc_solve with verbose=1 at
   T=20 (one Riccati and one line-search launch an iteration) and, for the
   cartpole, at T=128 with a gradient (the three twins); each kernel on the
   env's line-search inputs (B=1024) against its plain version by phase
   10's rule, the float64 plain version as the witness of the trajectory;
   every built lane count of the kernel and its twin bit-equal to one lane;
   the kernel alone, the wrapper and the plain version timed; the solve's
   last line search with its cost zeroed (phase 33's nothing_improves_case);
   at T=128 the cartpole's Riccati twin at (5, 1) on its first recorded
   sweep against its plain version by phase 9's rule (tie entries capped at
   1%, each first tie held by its QP objective against the plain version's
   and, where the float64 sweep took the plain answers at every later
   step, the float64 sweep's), every built lane
   count bit-equal to one lane, the kernel alone, the wrapper and the plain
   version timed (riccati_twin_case);

37. the receding-horizon loop at diffmpc_tpu_torch/examples/receding_mpc.py's
   full width (B=1024, T=20, lqr_iter=10, eps=1e-5, 100 env steps, the
   plant's params +-15% off the model's, seed 0) through the example's own
   episode (run_receding_horizon), three episodes: the pendulum without and
   with the slew penalty (1.0), the vehicle with it; the counts set to 0
   before each episode and read after: one fused launch an env step, of the
   control-passthrough variant (csrc/passthrough.cuh, its key printed) under
   the slew penalty; each episode's success share, stage cost and ms per env
   step (CUDA events, its second run, bit-equal to the first) and the card's
   idle share of env step 50 profiled in a fresh process first
   (one_robot_profile receding; its trace must hold the fused kernel);
   under the slew penalty the
   passthrough kernel on the first solve and on the warm-started solve at
   env step 50 against the host's plain fused solve on the first 64
   scenarios (phase 36's witness rule), every built lane count with and
   without hoist_lin bit-equal to one lane, and the kernel alone, its
   wrapper and its plain version timed with its bound;
37b. the passthrough line search and its twin: a slewed solve with
   verbose=1 at T=20 and T=128 (the twins), B=1024, one Riccati and one
   line-search launch an iteration; its first line search against its plain
   version (phase 36b's rule), every built lane count of the kernel and the
   twin bit-equal to one lane, the times; the solve's last line search with
   its cost zeroed (nothing_improves_case); at T=128 the Riccati twin at the
   wrapped shapes (4, 1) and (6, 2) (riccati_twin_case);
38. the rest of mpc.py: a callable cost equal to config 2's quadratic
   (shared) at B=4096 against the QuadCost's solve by the chaos rule, one
   Riccati launch an iteration and no line-search kernel (the plain ladder
   judges by the callable, the JAX package's dispatch); tests/test_mpc.py:
   160's cosh cost on the pendulum at B=1024, T=10, 15 iterations, with the
   gradient with respect to the cost's weights and x_init through one KKT
   launch against the host's float64 gradient at the card's fixed point
   (phase 32's rule), and the solve against the host's on the first 64
   scenarios; u_zero_I pinning the vehicle's steering at B=1024 on the fused
   kernel, the pinned control exactly 0, unbounded elsewhere (the +-1e18
   box) against the host by phase 36's witness rule, and inside the example's
   box bit-equal to the solve whose steering box is [0, 0]; one MPC.solve
   with ANALYTIC_CHECK on the headline problem (the check on the card, one
   fused launch, bit-equal to ANALYTIC).

39. the port's training examples (diffmpc_tpu_torch/examples/) at their
   default widths (il_pendulum B=1024, T=20; il_cartpole B=4096; il_vehicle
   and il_quadrotor (lqr_iter=14) B=1024; il_acrobot B=1024, T=25;
   il_nn_dynamics B=512, T=15, (64, 64); sysid_domain_rand 128 x 8
   replicas without and with --goal-rand 0.3), each through its own main
   in process under a temporary --out: --steps 4 --ckpt-every 2, then
   --steps 2 and --resume --steps 4, the resumed run's train.csv rows (dt
   aside), final params and Adam state bit-equal to the uninterrupted
   run's; at every step (the counts set to 0 before it and read after) one
   iLQR and one KKT launch on the fused path, one Riccati launch an
   iteration and one KKT launch for the (64, 64) MLP, no plain version
   called, a finite loss and grad_norm > 0; the first step's kernels
   against their plain versions (the fused solve against the host's on its
   first 64 scenarios by phase 36's witness rule with phase 2's ties, the
   Riccati sweep by phase 9's, the KKT backward by phase 5's); the ms a
   step (CUDA events), the host's ms and the card's idle share of the step
   after the four, profiled in a fresh process first (one_robot_profile
   example; its trace must hold the step's iLQR or Riccati kernel and its
   KKT kernel);
   il_pendulum --mesh on one NCCL rank bit-equal to the run without it;
   gen_expert_data's .npz for each of its four envs at B=1024 bit-equal to
   build + generate_expert_data in process, one iLQR launch each.

40. the serving artifacts (diffmpc_tpu_torch/aot.py): the headline
   (pendulum, B=1024, T=20, lqr_iter=10, box +-2) exported on the card,
   written to a file and run by a fresh process that imports
   diffmpc_tpu_torch.aot alone and runs no nvcc (xs, us and info bit-equal
   to the live solve, objs within 1e-6 relative, one iLQR launch a call and
   no plain version); the same at B=65,536; the headline built from CPU
   tensors for the card, bit-equal to the card-built one; a warm-start
   artifact driving 20 receding steps equal to the live loop; the loss and
   gradient through params-input vjp_order=1 artifacts against live (the
   pendulum's per-scenario (B, 3) params at B=1024, BASELINE.json config
   4's cartpole at B=4096 through the linearize op, the vehicle with its
   per-dimension box recorded by value): the loss equal, the gradient
   within 1e-6 of its max-abs; config 2 as non-fused artifacts at T=20
   (B=128, 4096) and T=128 (B=128, the twins), bit-equal with equal
   n_iters and launches (the loop one traced iteration in a while_loop
   with the live loop's exit); config 2's card solve
   at B=128 (lqr_iter=100) against the float64 C++ oracle
   (diffmpc_tpu_torch.native) on 64 scenarios by
   tests/test_native_oracle.py's rule; the callable-cost artifacts (a
   cost(tau) traced at export, its closed-over tensors baked): phase 38's
   cosh cost on the pendulum (B=1024, T=10, 15 iterations) exported on the
   card and run by the fresh process beside the headline, and built from
   CPU tensors for the card, bit-equal to the card-built one; the same with
   params_input and vjp_order=1 (the loss equal, the params gradient within
   1e-6 of its max-abs, one KKT launch); phase 38's callable equal to config
   2's quadratic at B=4096, T=20; each held to the live solve (xs, us, objs
   and n_iters bit-equal), one Riccati launch an iteration as live's, no
   fused or rollout kernel, no plain version; export and load seconds, bytes and ms
   a call (CUDA events) of each artifact beside the live solve's.

41. one robot: the render example's episode (examples/render_trajectory.py:
   41-88, B=1, T=15, lqr_iter=8, eps=1e-5, 80 env steps) for each of the
   five envs through the port's example (its build and episode; the frames
   are drawn on the host by tests/test_torch_render.py, the card's machine
   has no matplotlib): the counts set to 0 before it and read after, one
   fused launch an env step, of the pendulum's prebuilt kernel or the env's
   variant (its key printed), no other kernel and no plain version called;
   the states finite and the controls in the box; the ms an env step (CUDA
   events, the episode's second run, bit-equal to the first), the wrapper's
   card and host ms an env step in place (timed_spans), the card's idle
   share of env step 40 profiled in a fresh process
   (diffmpc_tpu_torch.diagnostics.one_robot_profile; its trace must hold the
   fused kernel); the solves at env steps 0, 40 and 79
   (their warm starts) against the host's plain fused solve by phase 36's
   witness rule, every built lane count with and without hoist_lin
   bit-equal to one lane, the kernel alone at the wrapper's lanes and the
   wrapper timed with the kernel's bound (the chain of the solve's
   iterations at T=15); the host's ms an env step (the env step less the
   wrapper at env step 40); the plain version on the card timed once.

With ``--slice-only`` the script runs phases 0, 1 and 30-33 alone; with
``--zoo-only``, phases 0 and 1, the zoo's variants of phase 30, and 35-36;
with ``--mpc-only``, phases 0 and 1, the receding loop's variants, and
37-38; with ``--examples-only``, phases 0 and 1, the zoo's variants (the
examples' kernels) and 39; with ``--aot-only``, phases 0 and 1, the
variants of phase 40 and 40; with ``--render-only``, phases 0 and 1, the
zoo's variants (the envs' fused kernels) and 41.

The line before the last holds the kernels' record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

try:
    # NVIDIA's H100 SXM data sheet (HBM bandwidth, dense float32 rate), the
    # latency of one dependent float32 operation in cycles, the CUDA-event timer
    from diffmpc_tpu_torch.diagnostics.card import (
        DEP_OP_CYCLES, F32_FLOPS_PER_S, HBM_BYTES_PER_S, cuda_ms, graph_ms, ptxas_report,
    )
except ModuleNotFoundError as e:
    if e.name != "diffmpc_tpu_torch":
        raise
    # the script alone, without the port beside it, has nothing to drive
    sys.exit("chip_smoke: the package diffmpc_tpu_torch is not importable: run this script from the "
             "root of a checkout of the repository")
# the dependent operations of one step of the fused iLQR kernel (ilqr.cuh,
# pendulum.cuh), counted from the source as floors: forward, x_t -> x_t+1
# (the piece kernels' rollout step), and backward, V_t+1 -> V_t (their sweep
# step); the count is written out beside them
from diffmpc_tpu_torch.diagnostics.profile_riccati_pieces import ROLLOUT_STEP_DEPTH as ILQR_FWD_DEPTH
from diffmpc_tpu_torch.diagnostics.profile_riccati_pieces import SWEEP_STEP_DEPTH as ILQR_BACK_DEPTH

T = 20
B_MAIN, B_RAGGED, B_ENSEMBLE = 1024, 1000, 65536
LQR_ITER, EPS = 10, 1e-5
N_ALPHA = 10  # the fused solves' max_linesearch_iter (the default); their bounds count it
TRUE_PARAMS, PARAMS0 = (10.0, 1.0, 1.0), (8.0, 1.25, 0.8)
# BASELINE.json config 2 (box-DDP) and config 1 (unconstrained LQR)
BOX_N, BOX_M, BOX_B, BOX = 4, 2, 128, 0.6
LQR_N, LQR_M, LQR_T, LQR_B = 3, 2, 10, 32
# the long-horizon path: config 2's slice at T=128 (box-DDP stops after ~17
# iterations there), the pendulum with finite differences at T=256 and its
# fused solve at T=512
T_LONG, T_FD, T_PEND, LONG_ITER = 128, 256, 512, 20
B_MID = 4096  # the timing batch between config 2's published 128 and a full card
PROBE_L = 8  # the probe's shard on each of the two ranks (the JAX test's (16,) array)
PROBE_L_RANK = 32768  # the probe's shard on each of the dry run's two ranks at config 5's B=65,536


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def x_init(B: int, seed: int = 0) -> np.ndarray:
    """The flagship initial states: random angle, speed in [-1, 1]."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-np.pi, np.pi, B)
    thdot = rng.uniform(-1.0, 1.0, B)
    return np.stack([np.cos(th), np.sin(th), thdot], -1).astype(np.float32)


def problem(B: int, device, seed: int = 0, steps: int = T):
    """The flagship problem's kernel inputs on ``device``, over ``steps``."""
    from diffmpc_tpu_torch.models import PendulumDx

    dx = PendulumDx.default(device=device)
    q, p = dx.get_true_obj()
    return dict(
        x_init=torch.tensor(x_init(B, seed), device=device),
        C=torch.diag(q).expand(steps, B, 4, 4),
        c=p.expand(steps, B, 4),
        dyn=dx,
        u_lower=torch.full((steps, B, 1), -2.0, device=device),
        u_upper=torch.full((steps, B, 1), 2.0, device=device),
    )


def compare(kernel, plain) -> dict:
    """Kernel vs plain by the chaos rule of the tests (tests/torch_parity.py):
    n_iters equal on most scenarios; on those, objectives within 1e-3
    relative and controls within 5e-3 where the last line-search step also
    agrees. A scenario converged to f32 noise on both sides may take another
    last step at the same objective (a tie); its controls stay within 5e-2."""
    k = {f: getattr(kernel, f).cpu().numpy() for f in kernel._fields}
    p = {f: getattr(plain, f).cpu().numpy() for f in plain._fields}
    same = k["n_iters"] == p["n_iters"]
    tie = same & (k["alpha"] != p["alpha"])
    keep = same & ~tie
    us_diff = np.abs(k["us"] - p["us"]).max(axis=(0, 2))
    rel = np.abs(k["objs"] - p["objs"]) / np.maximum(np.abs(p["objs"]), 1e-6)
    return dict(
        n_iters_equal_frac=float(same.mean()),
        objs_max_rel=float(rel[same].max()),
        us_max_abs=float(us_diff[keep].max()),
        us_max_abs_incl_ties=float(us_diff[same].max()),
        ties=int(tie.sum()),
        ties_converged=bool((k["converged"][tie] & p["converged"][tie]).all()),
        ties_us_max_abs=float(us_diff[tie].max()) if tie.any() else 0.0,
        converged_frac_kernel=float(k["converged"].mean()),
        converged_frac_plain=float(p["converged"].mean()),
    )


def check_chaos(name: str, m: dict, min_equal: float = 0.95) -> None:
    ok = (
        m["n_iters_equal_frac"] >= min_equal
        and m["objs_max_rel"] <= 1e-3
        and m["us_max_abs"] <= 5e-3
        and m["ties_converged"]
        and m["ties_us_max_abs"] <= 5e-2
    )
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree: {m}")


def witnessed_agreement(name: str, kernel, plain, exact, ties: bool = False, calm_limits: bool = True,
                        converged_free: bool = False) -> dict:
    """A float32 solve of an ill-conditioned closed loop against its plain
    version, with the float64 plain version (``exact``) as the witness. A
    scenario is off from another solve when n_iters differ, the objective is
    more than 1e-3 from it relative, or the controls more than 5e-3 (5e-2
    where the last line-search step differs). Held: n_iters equal to the
    float32 plain version's on >= 95% of scenarios; the kernel off from the
    float64 solve on no more scenarios than twice those where the float32
    plain version is, plus 0.5% of the batch (float32 rounding alone moves
    an ill-conditioned scenario; a wrong kernel moves most); on the scenarios
    where neither is off from float64, kernel and plain within twice the
    limits of each other. With ``ties``, a scenario where kernel and plain
    take the same number of iterations but another last line-search step
    (phase 2's tie) is held as phase 2 holds it instead: converged on both
    sides, controls within 5e-2. Without ``calm_limits`` the distances on the
    calm scenarios and the ties are reported and only the counts held: for a
    closed loop still unconverged on most scenarios, where a scenario whose
    last step differs from the float64 solve's may sit 5e-2 from it on
    either side. With ``converged_free`` a scenario converged on both sides
    of a comparison counts as taking the same iterations: both stopped at
    the fixed point, on an iteration that the eps test decides by float32
    noise (a well-conditioned env that converges everywhere); its
    objectives and controls are held all the same."""
    k, p, e = ({f: getattr(r, f).double().cpu().numpy() for f in r._fields} for r in (kernel, plain, exact))

    def same_iters(a, b):
        same = a["n_iters"] == b["n_iters"]
        return same | ((a["converged"] > 0) & (b["converged"] > 0)) if converged_free else same

    def off(a, b):
        us = np.abs(a["us"] - b["us"]).max(axis=(0, 2))
        rel = np.abs(a["objs"] - b["objs"]) / np.maximum(np.abs(b["objs"]), 1e-6)
        return ~same_iters(a, b) | (rel > 1e-3) | (us > np.where(a["alpha"] == b["alpha"], 5e-3, 5e-2))

    kp, pe, ke = off(k, p), off(p, e), off(k, e)
    calm = ~pe & ~ke
    tie = calm & same_iters(k, p) & (k["alpha"] != p["alpha"]) if ties else np.zeros_like(calm)
    us = np.abs(k["us"] - p["us"]).max(axis=(0, 2))
    rel = np.abs(k["objs"] - p["objs"]) / np.maximum(np.abs(p["objs"]), 1e-6)
    held = calm & ~tie  # at one scenario (phase 41) either may be empty
    out = dict(n_iters_equal_frac=float(same_iters(k, p).mean()), off_plain=int(kp.sum()),
               plain_off_float64=int(pe.sum()), kernel_off_float64=int(ke.sum()),
               us_max_abs=float(us[held].max()) if held.any() else 0.0,
               objs_max_rel=float(rel[calm].max()) if calm.any() else 0.0,
               converged_frac_kernel=float(k["converged"].mean()), converged_frac_plain=float(p["converged"].mean()),
               float64_mean_obj=float(e["objs"].mean()), mean_obj=float(k["objs"].mean()))
    if converged_free:
        out.update(n_iters_strictly_equal_frac=float((k["n_iters"] == p["n_iters"]).mean()))
    if ties:
        out.update(ties=int(tie.sum()), ties_us_max_abs=float(us[tie].max()) if tie.any() else 0.0,
                   ties_converged=bool(((k["converged"] > 0) & (p["converged"] > 0))[tie].all()))
    calm_off = out["us_max_abs"] > 1e-2 or out["objs_max_rel"] > 2e-3 \
        or (ties and (out["ties_us_max_abs"] > 5e-2 or not out["ties_converged"]))
    if out["n_iters_equal_frac"] < 0.95 or ke.sum() > 2 * pe.sum() + 0.005 * len(us) or (calm_limits and calm_off):
        raise AssertionError(f"{name}: {out}")
    return out


def check_tight(name: str, kernel, plain, tol: float = 1e-4) -> float:
    worst = 0.0
    for f in kernel._fields:
        a = getattr(kernel, f).double().cpu().nan_to_num(posinf=0.0)
        b = getattr(plain, f).double().cpu().nan_to_num(posinf=0.0)
        worst = max(worst, float((a - b).abs().max()))
    if worst > tol or not torch.equal(kernel.n_iters.cpu(), plain.n_iters.cpu()):
        raise AssertionError(f"{name}: max abs difference {worst} > {tol} or n_iters differ")
    return worst


def random_kkt_inputs(B: int, device, seed: int = 0, tight_share: float = 0.2):
    """Random KKT-backward residuals at T=20, n=3, m=1 (the recipe of
    tests/test_pallas_kkt.py): an SPD cost, random dynamics, controls in
    [-1, 1] with ``tight_share`` of them parked on the bound."""
    n, m = 3, 1
    nm = n + m
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(T, B, nm, nm)) * 0.3
    C = A @ np.swapaxes(A, -1, -2) + np.eye(nm)
    u = rng.uniform(-0.9, 0.9, size=(T, B, m))
    u.reshape(-1)[rng.choice(T * B * m, int(tight_share * T * B * m), replace=False)] = 1.0
    tau = np.concatenate([rng.normal(size=(T, B, n)), u], -1)
    tight = u >= 1.0 - 1e-6
    r = rng.normal(size=(T, B, nm))
    r[..., n:][tight] = 0.0
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return (f32(C), f32(rng.normal(size=(T, B, nm))), f32(rng.normal(size=(T, B, n, nm)) * 0.4),
            f32(r), f32(tau), torch.tensor(tight, device=device))


def main_path_kkt_inputs(B: int, device):
    """The KKT backward's inputs on the main path: the flagship solve's
    trajectory, the env linearized at it, and the gradient of mean(us**2)
    with tight controls zeroed, as lqr_fixed_point builds them."""
    from diffmpc_tpu_torch.ops.cuda.ilqr import ilqr_solve_fused
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics

    prob = problem(B, device)
    sol = ilqr_solve_fused(**prob, lqr_iter=LQR_ITER, eps=EPS)
    F, _ = linearize_dynamics(prob["dyn"], sol.xs, sol.us)
    us = sol.us.clone().requires_grad_(True)
    gx = torch.zeros_like(sol.xs)  # the loss does not read the states
    (gu,) = torch.autograd.grad((us**2).mean(), us)
    tight = (sol.us <= prob["u_lower"] + 1e-6) | (sol.us >= prob["u_upper"] - 1e-6)
    gu = torch.where(tight, 0.0, gu)
    return (prob["C"], prob["c"], F, torch.cat([gx, gu], -1),
            torch.cat([sol.xs, sol.us], -1), tight)


@contextlib.contextmanager
def recording(module_name: str, name: str, calls: list):
    """The function ``name`` of the module ``module_name`` replaced, while
    inside, by a pass-through that keeps each call's arguments."""
    module = importlib.import_module(module_name)
    fn = getattr(module, name)

    def record(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    setattr(module, name, record)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def timed_spans(targets: dict, spans: dict):
    """Each function of ``targets`` (``{label: (module name, function
    name)}``) replaced, while inside, by a pass-through that appends to
    ``spans[label]`` its call's CUDA events (start, end: on the card, the
    card's waits for the host included) and its seconds on the host's
    clock."""
    saved = []
    for label, (module_name, name) in targets.items():
        module = importlib.import_module(module_name)
        fn = getattr(module, name)

        def timed(*args, _fn=fn, _label=label, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = _fn(*args, **kw)
            end.record()
            spans.setdefault(_label, []).append((start, end, time.perf_counter() - t0))
            return out

        setattr(module, name, timed)
        saved.append((module, name, fn))
    try:
        yield
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


def span_ms(spans: dict) -> dict:
    """``{label: {"card_ms", "host_ms"}}`` summed over each label's calls
    (after the card has run them)."""
    return {label: dict(card_ms=sum(s.elapsed_time(e) for s, e, _ in calls), host_ms=sum(h for _, _, h in calls) * 1e3)
            for label, calls in spans.items()}


def check_kkt(name: str, kernel, plain) -> float:
    """Every output within 1e-4 * max(1, max|plain|): one linear pass, no
    chaos. Returns the largest absolute difference."""
    worst = 0.0
    for out, k, p in zip(("dx_init", "dC", "dc", "dF", "df"), kernel, plain):
        err = float((k - p).abs().max())
        bound = 1e-4 * max(1.0, float(p.abs().max()))
        if not err <= bound:
            raise AssertionError(f"{name}: KKT kernel vs plain, {out}: {err} > {bound}")
        worst = max(worst, err)
    return worst


def flagship_grads(config, B: int, device, params=None):
    """Gradients of mean(us**2) through mpc_solve on the flagship problem
    with respect to the env's params, x_init and the cost's weights q."""
    from diffmpc_tpu_torch import QuadCost, mpc_solve
    from diffmpc_tpu_torch.models import PendulumDx

    dx = PendulumDx.default(device=device)
    q, p = dx.get_true_obj()
    prm = (dx.params if params is None else params).clone().requires_grad_(True)
    x = torch.tensor(x_init(B), device=device).requires_grad_(True)
    q = q.clone().requires_grad_(True)
    sol = mpc_solve(config, x, QuadCost(torch.diag(q), p), dx.replace(params=prm),
                    u_lower=-2.0, u_upper=2.0)
    g_prm, g_x, g_q = torch.autograd.grad((sol.us**2).mean(), (prm, x, q))
    return sol, dict(params=g_prm, x_init=g_x, q=g_q)


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def tri(nm: int) -> int:
    """Entries of a symmetric nm x nm matrix's upper triangle: what the
    kernels need of C."""
    return nm * (nm + 1) // 2


def riccati_bytes(B: int, n: int, m: int, steps: int = T) -> int:
    """Bytes the box-mode Riccati sweep must move (f None): C's upper
    triangle, c, F and u_hat in, with the two scalar bounds; K, k (float32),
    free (bool) and n_qp (int32) out."""
    nm = n + m
    return B * steps * (4 * (tri(nm) + nm + n * nm + m) + 4 * (m * n + m) + m + 4) + 8


def rollout_bytes(B: int, n: int, m: int, steps: int = T) -> int:
    """Bytes the linear, boxed line search must move: C's upper triangle, c,
    F, f, K, k, x_hat, u_hat per step and x_init in, with the two scalar
    bounds; xs, us per step and objs, alpha (float32), improved (bool) out."""
    nm = n + m
    per_step = 4 * (tri(nm) + nm + n * nm + n + m * n + m + n + m) + 4 * (n + m)
    return B * (steps * per_step + 4 * n + 9) + 8


def kkt_bytes(B: int, n: int, m: int, steps: int = T, shared_C: bool = False, shared_F: bool = False) -> int:
    """Bytes the KKT backward must move: C's upper triangle, c, F, r, tau
    (float32) and tight (bool) in; dC, dc, dF, df per step and dx_init out.
    A C or F that the kernels read in place (one for every scenario,
    ops/cuda/kkt.py, reads_in_place) counts once a step."""
    nm = n + m
    per_scenario = 4 * 3 * nm + m + 4 * (nm * nm + nm + n * nm + n)
    C_bytes, F_bytes = 4 * tri(nm), 4 * n * nm
    return steps * (B * per_scenario + (1 if shared_C else B) * C_bytes + (1 if shared_F else B) * F_bytes) + B * 4 * n


def ilqr_chain_ms(n_iters: int, clock_mhz: float) -> float:
    """The fused iLQR solve's serial chain for its slowest scenario: the
    initial rollout, then per iteration the backward sweep, the ladder's
    rollouts (independent of each other: one rollout's depth; the chosen
    one's trajectory is kept, so no replay is needed) and the pick, each
    dependent operation at DEP_OP_CYCLES."""
    depth = T * ILQR_FWD_DEPTH + n_iters * (T * (ILQR_BACK_DEPTH + ILQR_FWD_DEPTH) + 1)
    return depth * DEP_OP_CYCLES / (clock_mhz * 1e6) * 1e3


def ilqr_solve_bound(res, B: int, n_alpha: int, clock_mhz: float) -> dict:
    """The fused pendulum solve's bound at batch ``B`` from its result
    ``res`` with a ladder of ``n_alpha`` steps (``max_linesearch_iter``): the
    bytes it must move (C's upper triangle, c, the bounds, x_init and the
    params in; xs, us and the stats out), its operations (the initial
    rollout, then for the iterations the run took, per step: the sweep's
    Riccati step, ~200 for the linearization and the delta cost, the
    ladder's ``n_alpha`` rollouts), or its slowest scenario's serial chain,
    whichever is largest."""
    per_iter = riccati_step_ops(3, 1, "box") + 200 + n_alpha * rollout_step_ops(3, 1)
    n_ops = B * T * rollout_step_ops(3, 1) + float(res.n_iters.sum()) * T * per_iter
    out = bound(4 * B * (T * (tri(4) + 4 + 2 + 3 + 1) + 9), n_ops)
    chain = ilqr_chain_ms(int(res.n_iters.max()), clock_mhz)
    out.update(chain_ms=chain)
    if chain > out["bound_ms"]:
        out.update(bound_ms=chain, bound_by="operations")  # dependent ones, at their latency
    return out


def qp_objective(Quu, qu, k):
    """The box QP's objective 0.5 k'Quu k + qu'k at ``k``, in float64, and the
    sum of its terms' magnitudes: the scale float32 rounding works on."""
    Quu, qu, k = Quu.double(), qu.double(), k.double()
    terms = torch.cat([(0.5 * k[..., :, None] * Quu * k[..., None, :]).flatten(-2), qu * k], -1)
    return terms.sum(-1), terms.abs().sum(-1)


def riccati_agreement(name: str, got, want, Quu, qu, max_tie_share: float = 1e-3, exact=None) -> dict:
    """The Riccati kernel against its plain version. A tie: the box QP's
    candidates tie in objective within float32 rounding (or sit at its 1e-6
    validity tolerance), and the two sides take different ones. A tie step
    has another free flag, a k off by more than the tolerance, or another
    QP count. A scenario's first tie step in the sweep (its largest t, the
    root) must be one: the two sides saw the same value function there, and
    the plain version's QP scores both answers within 1e-5 of its scale.
    The steps before it in time then see another value function (another
    free mask gives other gains), so their answers differ too and are not
    weighed. Tie entries are held to ``max_tie_share`` of the entries (0.1%
    by default), and the scenarios with a tie left out of the comparison of
    K, k within 1e-4 * max(1, max|plain|). With ``exact``, the float64 plain
    sweep's ``(result, Quu, qu)`` on the same inputs, it is the ties'
    witness: at every root tie step where the float64 sweep took the plain
    version's answers at every later t (so its QP is the float32 one to
    rounding), the kernel's k scores within 1e-5 of the float64 k's
    objective on the float64 QP (a true tie: the answer is optimal to
    float32 rounding); the plain version's gap and its own ties against
    float64 are reported beside."""
    tol = {f: 1e-4 * max(1.0, float(getattr(want, f).abs().max())) for f in ("K", "k")}
    free_bad = got.free_mask != want.free_mask
    nqp_bad = got.n_qp_iter != want.n_qp_iter
    k_off = ((got.k - want.k).abs() > tol["k"]) & ~free_bad
    share = float(free_bad.sum() + k_off.sum() + nqp_bad.sum()) / (free_bad.numel() + nqp_bad.numel())
    tie = (free_bad | k_off).any(-1) | nqp_bad  # (T, B) steps
    root = tie & (tie.flip(0).int().cumsum(0).flip(0) == 1)  # no tie at a later t
    (j_got, s_got), (j_want, s_want) = qp_objective(Quu, qu, got.k), qp_objective(Quu, qu, want.k)
    gap = (j_got - j_want).abs() / torch.maximum(s_got, s_want).clamp_min(1e-30)
    root_gap = float(gap[root].max()) if bool(root.any()) else 0.0
    examples = [dict(t=t, b=b, k=got.k[t, b].tolist(), plain_k=want.k[t, b].tolist(),
                     free=got.free_mask[t, b].tolist(), plain_free=want.free_mask[t, b].tolist(),
                     n_qp=int(got.n_qp_iter[t, b]), plain_n_qp=int(want.n_qp_iter[t, b]),
                     qp_obj_rel_gap=float(gap[t, b]))
                for t, b in root.nonzero()[gap[root].argsort(descending=True)[:3]].tolist()]
    agree = ~tie.any(0)  # scenarios
    errs = {f: float((getattr(got, f)[:, agree] - getattr(want, f)[:, agree]).abs().max()) for f in ("K", "k")}
    out = dict(max_abs_err=errs, free_mismatches=int(free_bad.sum()), n_qp_mismatches=int(nqp_bad.sum()),
               k_ties=int(k_off.sum()), tie_entry_share=share, tie_steps=int(tie.sum()),
               tie_scenarios=int(root.sum()),
               tie_k_max_abs=float((got.k - want.k)[tie].abs().max()) if bool(tie.any()) else 0.0,
               root_qp_obj_max_rel_gap=root_gap,
               later_steps_qp_obj_max_rel_gap=float(gap[tie & ~root].max()) if bool((tie & ~root).any()) else 0.0,
               root_examples=examples, clamped_share=float((~want.free_mask).float().mean()),
               tol="1e-4 * max(1, max|plain|)", max_tie_share=max_tie_share)
    witness_gap = 0.0
    if exact is not None:
        e, Quu64, qu64 = exact
        j64, s64 = qp_objective(Quu64, qu64, e.k)
        plain_ties = ((want.free_mask != e.free_mask) | ((want.k - e.k).abs() > tol["k"])).any(-1) \
            | (want.n_qp_iter != e.n_qp_iter)
        # a root step whose float64 QP is the float32 one to rounding: the
        # float64 sweep took the plain version's answers at every later t
        later = plain_ties.flip(0).int().cumsum(0).flip(0) - plain_ties.int()
        witnessed = root & (later == 0)

        def off_float64(k):
            j, s_k = qp_objective(Quu64, qu64, k)
            rel = (j - j64).abs() / torch.maximum(s_k, s64).clamp_min(1e-30)
            return float(rel[witnessed].max()) if bool(witnessed.any()) else 0.0

        witness_gap = off_float64(got.k)
        out.update(witness="float64 plain", witnessed_root_steps=int(witnessed.sum()),
                   root_kernel_qp_obj_rel_gap_vs_float64=witness_gap,
                   root_plain_qp_obj_rel_gap_vs_float64=off_float64(want.k),
                   plain_vs_float64_tie_steps=int(plain_ties.sum()),
                   plain_vs_float64_tie_scenarios=int(plain_ties.any(0).sum()))
    if not all(errs[f] <= tol[f] for f in errs) or share > max_tie_share or root_gap > 1e-5 or witness_gap > 1e-5:
        raise AssertionError(f"Riccati kernel vs plain, {name}: {out}")
    return out


def line_search_agreement(name: str, got, want, hold: bool = True) -> dict:
    """Two line searches on the same inputs: objs within 1e-5 of the batch's
    largest |objs| (relative to each objective, with the batch's largest as
    the floor: a cost summed over T steps can cancel to near zero), alpha
    equal on >= 99%, xs, us within 1e-4 where alpha agrees. With ``hold``
    off the numbers are reported, not held."""
    torch.cuda.synchronize()
    same = got.alpha == want.alpha
    scale = want.objs.abs().clamp_min(max(float(want.objs.abs().max()), 1e-30))
    obj_rel = float(((got.objs - want.objs).abs() / scale).max())
    traj = max(float((got.xs - want.xs)[:, same].abs().max()), float((got.us - want.us)[:, same].abs().max()))
    out = dict(objs_max_rel=obj_rel, alpha_equal_frac=float(same.float().mean()), traj_max_abs_where_alpha_agrees=traj,
               distinct_alphas=len(torch.unique(want.alpha)), improved_frac=float(want.improved.float().mean()))
    if hold and (obj_rel > 1e-5 or out["alpha_equal_frac"] < 0.99 or traj > 1e-4):
        raise AssertionError(f"{name}: {out}")
    return out


def box_lqr_optimum(C, c, F, f, x0, lo: float, hi: float, iters: int = 60, polish: int = 5, device="cpu"):
    """The box-constrained LQR's optimum in float64 on ``device``, independent
    of the solver under test: the problem condensed to one QP in the
    controls (x_t+1 = F_t [x_t; u_t] + f_t, cost 0.5 tau'C tau + c'tau per
    step), solved by a primal-dual interior-point method (robust however
    ill-conditioned the condensed QP: at T=128 its Hessian's condition number
    is ~2e6), then polished by projected Newton steps with a backtracking
    search on the active set it found. Returns the objective as a function
    of controls (T, B, m), the optimal controls and the largest
    projected-gradient entry left at them."""
    f64 = torch.float64
    C, c, F, f, x0 = (a.detach().to(device, f64) for a in (C, c, F, f, x0))
    T_, B, n, nm = F.shape
    m, Tm = nm - n, T_ * (nm - n)
    d64 = dict(dtype=f64, device=device)
    Cs = 0.5 * (C + C.transpose(-1, -2))
    H, g, const = torch.zeros(B, Tm, Tm, **d64), torch.zeros(B, Tm, **d64), torch.zeros(B, **d64)
    ax, Mx = x0, torch.zeros(B, n, Tm, **d64)
    for t in range(T_):  # tau_t = a + M u, affine in the controls u (B, T m)
        Mu = torch.zeros(B, m, Tm, **d64)
        Mu[:, :, t * m:(t + 1) * m] = torch.eye(m, **d64)
        a, M = torch.cat([ax, torch.zeros(B, m, **d64)], -1), torch.cat([Mx, Mu], 1)
        Ca = (Cs[t] @ a[..., None])[..., 0]
        H += M.transpose(1, 2) @ Cs[t] @ M
        g += (M.transpose(1, 2) @ (Ca + c[t])[..., None])[..., 0]
        const += ((0.5 * Ca + c[t]) * a).sum(-1)
        ax, Mx = (F[t] @ a[..., None])[..., 0] + f[t], F[t] @ M

    def qp(u):  # (B, S, Tm) -> (B, S): the objective without its constant (H is symmetric)
        return 0.5 * (u * (u @ H)).sum(-1) + (u * g[:, None]).sum(-1)

    def max_step(x, dx):  # the largest step keeping x + step * dx >= 0, per scenario
        return torch.where(dx < 0, -x / dx, torch.full_like(x, float("inf"))).amin(-1, keepdim=True)

    # interior point: slacks u - lo, hi - u and their duals z1, z2, centred by
    # 0.1 of the duality gap, each scenario stopped once its gap is 1e-13
    u = torch.full((B, Tm), 0.5 * (lo + hi), **d64)
    z1, z2 = torch.ones(B, Tm, **d64), torch.ones(B, Tm, **d64)
    for _ in range(iters):
        s1, s2 = u - lo, hi - u
        gap = (s1 * z1 + s2 * z2).sum(-1, keepdim=True) / (2 * Tm)
        live = gap > 1e-13
        if not bool(live.any()):
            break
        mu = 0.1 * gap
        grad = (H @ u[..., None])[..., 0] + g
        du = torch.linalg.solve(H + torch.diag_embed(z1 / s1 + z2 / s2), mu / s1 - mu / s2 - grad)
        dz1, dz2 = (mu - s1 * z1 - z1 * du) / s1, (mu - s2 * z2 + z2 * du) / s2
        step = torch.minimum(torch.minimum(max_step(s1, du), max_step(s2, -du)),
                             torch.minimum(max_step(z1, dz1), max_step(z2, dz2)))
        step = torch.where(live, (0.99 * step).clamp(max=1.0), torch.zeros_like(step))
        u, z1, z2 = u + step * du, z1 + step * dz1, z2 + step * dz2
    # onto the bounds the interior point approaches, then Newton on the rest
    u = torch.where(u - lo < 1e-9, lo, torch.where(hi - u < 1e-9, hi, u))
    steps = 0.5 ** torch.arange(40, **d64)
    for _ in range(polish):
        grad = (H @ u[..., None])[..., 0] + g
        act = ((u <= lo) & (grad > 0)) | ((u >= hi) & (grad < 0))
        Hm = torch.where(act[:, :, None] | act[:, None, :], torch.eye(Tm, **d64), H)
        d = torch.linalg.solve(Hm, torch.where(act, 0.0, -grad))
        cand = (u[:, None] + steps[:, None] * d[:, None]).clamp(lo, hi)  # (B, S, Tm)
        ok = qp(cand) <= qp(u[:, None])
        pick = cand[torch.arange(B, device=device), torch.argmax(ok.to(torch.int8), 1)]
        u = torch.where(ok.any(1)[:, None], pick, u)
    grad = (H @ u[..., None])[..., 0] + g
    pg = float((u - (u - grad).clamp(lo, hi)).abs().max())

    def objective(us):
        return (qp(us.detach().to(device, f64).transpose(0, 1).reshape(B, 1, Tm))[:, 0] + const).cpu()

    return objective, u.reshape(B, T_, m).transpose(0, 1).cpu(), pg


def riccati_step_ops(n: int, m: int, mode: str) -> int:
    """Floating-point operations of one Riccati step (riccati.cuh), counted
    from the source: W, Q, q, the box QP, the masked solves and the value
    update. The m = 2 enumeration solves nine small systems."""
    nm = n + m
    ops = 2 * n * n * nm + nm * (nm + 1) * n + 2 * n * nm  # W, Q upper, q
    chol = m * m * m // 3 * 2 + 4 * m
    ops += chol + (n + 1) * 2 * m * m  # the factor and the gain columns
    if mode == "box":
        ops += {1: 10, 2: 9 * (chol + 2 * m * m + 6 * m * m + 12)}.get(m, 0)
    ops += 2 * m * n * m + n * (n + 1) // 2 * 6 * m + 6 * n * m  # value update
    return ops


def riccati_step_depth(n: int, m: int, mode: str) -> int:
    """Dependent float32 operations from (V, v) at step t+1 to (V, v) at t of
    one Riccati step (riccati.cuh: its sums of products fused by hand,
    riccati_mad, a fused multiply-add one operation; a lone multiply and an
    add two), counted from the source as floors, a division or a square root
    as one: the Q form (W's n fused terms, then Q's n and C: 2n + 1); the
    box QP (m = 1: the clamp and its frozen test, 6; m = 2: the clipped
    Newton point, its Cholesky 6, its solve 6, the clip 2 and its objective
    6, then the fold over the other 8 candidates, which run beside it, and
    the frozen mask 4: 32); the gains (the factor and one column's solve:
    free 2 + 2 + 1 at m = 1, 6 + 6 + 1 at m = 2; masked, the frozen dims'
    factor and a column's scaling first: 6 at m = 1, 18 at m = 2, and by
    their fit 3 m (m + 1), 36 at m = 3, the KKT backward's (6, 3)); the full
    value update (K'Quu K's two fused sums, then the last add: 2m + 1)."""
    qform = 2 * n + 1
    qp = {1: 6, 2: 32}[m] if mode == "box" else 0
    gains = ({1: 5, 2: 13} if mode == "free" else {1: 6, 2: 18, 3: 36})[m]
    return qform + qp + gains + 2 * m + 1


def riccati_bound(B: int, n: int, m: int, mode: str, steps: int, clock_mhz: float) -> dict:
    """The Riccati sweep's bound: the bytes it must move (riccati_bytes,
    box mode; the other modes' inputs are within a few bytes of it), its
    operations (riccati_step_ops), or one scenario's chain of ``steps``
    dependent steps (riccati_step_depth), whichever is largest."""
    from diffmpc_tpu_torch.diagnostics.card import bound as card_bound
    from diffmpc_tpu_torch.diagnostics.card import chain_ms

    return card_bound(riccati_bytes(B, n, m, steps), steps * B * riccati_step_ops(n, m, mode),
                      chain_ms(steps * riccati_step_depth(n, m, mode), clock_mhz))


def kkt_step_depth(n: int, m: int) -> int:
    """Dependent float32 operations of one step of each of the KKT
    backward's three sweeps (kkt.cuh), counted from the source as floors, a
    fused multiply-add one: sweep 1, from (V, v) at t+1 to t, the Riccati
    step in mask mode (riccati_step_depth); sweep 2, from p_x to the next
    p_x, p_u's n fused terms and k's add, then F p's m control terms; sweep
    3, from lam_{t+1} to lam_t (mu alike), F'lam's n fused terms and the add.
    A scenario's chain is T of these: 3 T dependent steps."""
    return riccati_step_depth(n, m, "mask") + (n + 1 + m) + (n + 1)


def kkt_bound(B: int, n: int, m: int, steps: int, clock_mhz: float, shared_C: bool = False,
              shared_F: bool = False) -> dict:
    """The KKT backward's bound: the bytes it must move (kkt_bytes, a C or F
    read in place counted once a step), its operations (kkt_step_ops), or
    one scenario's chain of 3 ``steps`` dependent steps (kkt_step_depth),
    whichever is largest."""
    from diffmpc_tpu_torch.diagnostics.card import bound as card_bound
    from diffmpc_tpu_torch.diagnostics.card import chain_ms

    return card_bound(kkt_bytes(B, n, m, steps, shared_C, shared_F), steps * B * kkt_step_ops(n, m),
                      chain_ms(steps * kkt_step_depth(n, m), clock_mhz))


def kkt_step_ops(n: int, m: int) -> int:
    """Operations of one step of the KKT backward (kkt.cuh): a mask-mode
    Riccati step, then the adjoint and gradient sweeps."""
    nm = n + m
    return riccati_step_ops(n, m, "mask") + 2 * n * nm + nm * nm * n + nm * (2 * nm * n + 2 * n * n)


def rollout_step_ops(n: int, m: int) -> int:
    """Operations of one step of one closed-loop rollout (rollout.cuh):
    the control with its clamps, the stage cost and a linear step."""
    nm = n + m
    return m * (2 * n + 6) + nm * (2 * nm + 3) + 2 * n * nm


def rollout_step_depth(n: int, m: int, box: bool = True, delta_u: bool = False) -> int:
    """Dependent operations from x_t to x_t+1 of one closed-loop linear step
    (rollout.cuh), counted from the source: x - x_hat and the control's n
    multiply-adds, two for each clip (the box, delta_u), then the step's
    sums from u's first entry on (m multiply-adds) and f."""
    return 1 + n + 2 * (box + delta_u) + m + 1


def rollout_chain_ms(steps: int, step_depth: int, clock_mhz: float) -> float:
    """The line search's serial chain for one scenario: one rollout's
    ``steps`` dependent steps (the ladder's candidates, the baseline and
    alpha_floor's rollout are independent of each other) and the pick, each
    dependent operation at DEP_OP_CYCLES."""
    return (steps * step_depth + 1) * DEP_OP_CYCLES / (clock_mhz * 1e6) * 1e3


def rollouts_needed(res, n_alpha: int, decay: float) -> float:
    """The rollouts this line search's data needs, summed over its
    scenarios: each scenario's ladder up to its first improving candidate,
    or the whole ladder and alpha_floor's rollout where none improves; and
    the baseline, counted as one rollout."""
    ladder = torch.ones(n_alpha, dtype=torch.float32)
    for k in range(1, n_alpha):
        ladder[k] = ladder[k - 1] * decay
    alpha = res.alpha.detach().float().cpu()
    index = (alpha[:, None] == ladder[None, :]).float().argmax(1)
    improved = res.improved.cpu()
    return float(torch.where(improved, index + 1, torch.full_like(index, n_alpha + 1)).sum()) + alpha.numel()


def rollout_bound(res, B: int, n: int, m: int, steps: int, clock_mhz: float, n_alpha: int = 10,
                  decay: float = 0.2) -> dict:
    """The linear, boxed line search's bound from its result ``res``: the
    bytes it must move (rollout_bytes), the operations of the rollouts its
    data needs (rollouts_needed), or one scenario's chain
    (rollout_chain_ms), whichever is largest."""
    from diffmpc_tpu_torch.diagnostics.card import bound as card_bound

    n_ops = rollouts_needed(res, n_alpha, decay) * steps * rollout_step_ops(n, m)
    return card_bound(rollout_bytes(B, n, m, steps), n_ops, rollout_chain_ms(steps, rollout_step_depth(n, m), clock_mhz))


def random_lqr_torch(T: int, B: int, n: int, m: int, device, seed: int):
    """tests/oracles.py's random LQR problem (PSD cost L L'/nm + 0.5 I),
    drawn on the card: C, c, F, f, x_init in float32."""
    g = torch.Generator(device=device).manual_seed(seed)
    nm = n + m
    L = torch.randn((T, B, nm, nm), generator=g, device=device)
    C = L @ L.transpose(-1, -2) / nm + 0.5 * torch.eye(nm, device=device)
    c = torch.randn((T, B, nm), generator=g, device=device)
    F = torch.randn((T, B, n, nm), generator=g, device=device) * 0.5
    f = torch.randn((T, B, n), generator=g, device=device) * 0.5
    return C, c, F, f, torch.randn((B, n), generator=g, device=device)


def random_lqr_numpy(rng, T: int, B: int, n: int, m: int):
    """tests/oracles.py::random_lqr_problem (the goldens' recipe), float32."""
    nm = n + m
    L = rng.standard_normal((T, B, nm, nm))
    C = np.einsum("tbij,tbkj->tbik", L, L) / nm + 0.5 * np.eye(nm)
    c = rng.standard_normal((T, B, nm))
    F = rng.standard_normal((T, B, n, nm)) * 0.5
    f = rng.standard_normal((T, B, n)) * 0.5
    x_init = rng.standard_normal((B, n))
    return [a.astype(np.float32) for a in (C, c, F, f, x_init)]


def once_ms(fn) -> float:
    """One call of ``fn`` (a plain version: thousands of small launches), in
    ms by the host's clock between two synchronizations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def fresh_profile(*argv) -> list:
    """diagnostics/one_robot_profile.py's records (one a profiled step: busy
    ms, each kernel's ms, the step's ms and the card's idle share), run in a
    fresh process with ``argv``: late in this process torch.profiler has lost
    a step's kernels. Raises where the process fails, which it does where a
    trace lacks a kernel of its step."""
    child = subprocess.run([sys.executable, "-m", "diffmpc_tpu_torch.diagnostics.one_robot_profile", *argv],
                           capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        raise AssertionError(f"the profiling process ({' '.join(argv[:1])}) failed:\n{child.stderr[-4000:]}")
    return [json.loads(line) for line in re.findall(r"^\{.*\}$", child.stdout, re.M)]


@functools.lru_cache(maxsize=None)
def example_profiles() -> dict:
    """Each example run of EX_RUNS, its training step after EX_STEPS
    profiled by :func:`fresh_profile` in one process, by its run's name;
    phase 35 reads config 4's (il_cartpole at its defaults) and phase 39
    every run's, from the one process."""
    t0 = time.perf_counter()
    out = {r["example"]: r for r in fresh_profile(
        "example", "--runs", *(" ".join((module,) + flags) for module, flags in EX_RUNS), "--warm", str(EX_STEPS))}
    emit(phase="examples_profile_seconds", seconds=time.perf_counter() - t0)
    return out


def timed_launch(launch, loops: int, out: dict):
    """A launcher that, while the wrapper's staged buffers are alive, runs
    the kernel once to warm up and then ``loops`` times between CUDA events,
    and stores the mean in ``out["ms"]``: the kernel alone, no staging."""

    def run(*args):
        launch(*args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(loops):
            launch(*args)
        end.record()
        torch.cuda.synchronize()
        out["ms"] = start.elapsed_time(end) / loops

    return run


def rollout_inputs(case: str, B: int, seed: int, device, steps: int = T):
    """The line search's inputs as the non-fused loop builds them: a
    trajectory from random controls, gains from the Riccati kernel about
    it, the feedforward scaled by up to 8 so that the ladder backs off."""
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics
    from diffmpc_tpu_torch.ops.lqr import lqr_rollout
    from diffmpc_tpu_torch.utils.batch import bmv

    gen = torch.Generator(device=device).manual_seed(seed)
    if case == "pendulum":
        prob = problem(B, device, seed=seed, steps=steps)
        n, m, dyn = 3, 1, prob["dyn"]
        x0, C, c, lo, hi = prob["x_init"], prob["C"], prob["c"], prob["u_lower"], prob["u_upper"]
        u_hat = (torch.rand((steps, B, m), generator=gen, device=device) - 0.5) * 4.0
        xs, x = [], x0
        for t in range(steps):
            xs.append(x)
            x = dyn.forward(x, u_hat[t])
        x_hat = torch.stack(xs)
        F, f = linearize_dynamics(dyn, x_hat, u_hat)
    else:
        n, m, dyn = BOX_N, BOX_M, None
        C, c, F, f, x0 = random_lqr_torch(steps, B, n, m, device, seed)
        lo, hi = (torch.tensor(-BOX, device=device), torch.tensor(BOX, device=device)) if case == "linear_box" else (None, None)
        u_hat = (torch.rand((steps, B, m), generator=gen, device=device) - 0.5) * 0.6
        zeros = torch.zeros((steps, B, m, n), device=device)
        x_hat, _ = lqr_rollout(x0, F, f, zeros, torch.zeros((steps, B, m), device=device), u_hat=u_hat)
    c_delta = c + bmv(C, torch.cat([x_hat, u_hat], -1))
    box = dict(u_lower=lo, u_upper=hi, u_hat=u_hat) if lo is not None else {}
    res = ric.riccati_backward_cuda(C, c_delta, F, None, n, **box)
    scale = 0.5 + 7.5 * torch.rand((1, B, 1), generator=gen, device=device)
    args = (x0, C, c, None if dyn else F, None if dyn else f, res.K, res.k * scale, x_hat, u_hat)
    return args, dict(u_lower=lo, u_upper=hi, dyn=dyn)


def random_kkt_inputs_torch(steps: int, B: int, n: int, m: int, device, seed: int, tight_share: float = 0.2):
    """KKT-backward residuals drawn on the card, at any horizon and (n, m):
    an SPD cost, random dynamics, a trajectory with ``tight_share`` of the
    controls' entries marked tight and their gradients zeroed."""
    C, c, F, _, _ = random_lqr_torch(steps, B, n, m, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    tau = torch.randn((steps, B, n + m), generator=g, device=device)
    tight = torch.rand((steps, B, m), generator=g, device=device) < tight_share
    r = torch.randn((steps, B, n + m), generator=g, device=device)
    r[..., n:] = torch.where(tight, 0.0, r[..., n:])
    return C, c, F, r, tau, tight


def long_horizon(device, smi: str, clock_mhz: float) -> list:
    """Phases 13-18, the long-horizon path: the dispatch, each streaming twin
    against its plain version and its resident sibling, the slice through
    mpc_solve with its gradient, and the timings. Returns the twins' records
    for the kernels line."""
    from diffmpc_tpu_torch import GradMethods, LinDx, MPCConfig, QuadCost, mpc_solve
    from diffmpc_tpu_torch.diagnostics import ab_riccati_lanes
    from diffmpc_tpu_torch.ops.cuda import horizon, kkt, kkt_stream
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.cuda import riccati_stream as rs
    from diffmpc_tpu_torch.ops.cuda import rollout as rol
    from diffmpc_tpu_torch.ops.cuda import rollout_stream as ros
    from diffmpc_tpu_torch.ops.cuda.ilqr import KERNEL_SHAPES, ilqr_solve_fused
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics
    from diffmpc_tpu_torch.ops.lqr import lqr_rollout
    from diffmpc_tpu_torch.ops.lqr_step import LqrSpec, lqr_fixed_point
    from diffmpc_tpu_torch.utils.batch import bmv

    named = dict(
        ilqr=ilqr_solve_fused, kkt=kkt.kkt_backward_fused, riccati=ric.riccati_backward_cuda,
        rollout=rol.linesearch_rollout_cuda, riccati_stream=rs.riccati_backward_stream_cuda,
        rollout_stream=ros.linesearch_rollout_stream_cuda, kkt_stream=kkt_stream.kkt_backward_stream_cuda,
    )

    def reset_counts():
        for kern in named.values():
            kern.launches = 0

    def counts() -> dict:
        torch.cuda.synchronize()
        return {name: kern.launches for name, kern in named.items()}

    def only(**want) -> dict:
        return {name: want.get(name, 0) for name in named}

    box = dict(u_lower=torch.tensor(-BOX, device=device), u_upper=torch.tensor(BOX, device=device))
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count

    # ---- 13. dispatch: the kernel each shape takes ----
    picks = {}
    for steps in (20, 64, T_LONG, T_PEND):
        for n, m in KERNEL_SHAPES:
            picks[f"T={steps} n={n} m={m}"] = {
                kind: kind + ("_stream" if pred(steps, n, m) else "")
                for kind, pred in (("riccati", horizon.streams_riccati), ("rollout", horizon.streams_rollout),
                                   ("kkt", horizon.streams_kkt))
            }
    emit(phase="dispatch", vmem_budget_bytes=horizon.VMEM_BUDGET_BYTES, picks=picks)
    if set(picks[f"T={T_LONG} n=4 m=2"].values()) != {"riccati_stream", "rollout_stream", "kkt_stream"} \
            or set(picks["T=20 n=4 m=2"].values()) != {"riccati", "rollout", "kkt"}:
        raise AssertionError(f"dispatch: {picks}")

    # ---- 14. the Riccati twin vs plain and vs its resident sibling ----
    ric_err = {}
    for mode, n, m, steps, B in [("box", BOX_N, BOX_M, T_LONG, b) for b in (BOX_B, B_MID, B_ENSEMBLE)] + [
        ("free", 3, 2, T_LONG, B_RAGGED), ("mask", BOX_N, BOX_M, T_LONG, B_RAGGED), ("box", 3, 1, T_PEND, B_RAGGED),
    ]:
        C, c, F, _, _ = random_lqr_torch(steps, B, n, m, device, seed=1400 + B + 10 * n + m)
        gen = torch.Generator(device=device).manual_seed(B + 1)
        kw = {}
        if mode == "box":
            kw = dict(box, u_hat=(torch.rand((steps, B, m), generator=gen, device=device) - 0.5) * 0.6)
        elif mode == "mask":
            kw = dict(ctrl_mask=torch.rand((steps, B, m), generator=gen, device=device) < 0.3)
        twin = rs.riccati_backward_stream_cuda(C, c, F, None, n, **kw)
        resident = ric.riccati_backward_cuda(C, c, F, None, n, **kw)
        want, Quu, qu = ric.riccati_backward_plain(C, c, F, None, n, return_qp=True, **kw)
        torch.cuda.synchronize()
        name = f"{mode} n={n} m={m} T={steps} B={B}"
        vs_plain = riccati_agreement(f"twin, {name}", twin, want, Quu, qu)
        vs_resident = riccati_agreement(f"twin vs resident, {name}", twin, resident, Quu, qu)
        emit(phase="riccati_twin", mode=mode, n=n, m=m, T=steps, B=B, lanes=rs.riccati_backward_stream_cuda.last_lanes,
             staged=rs.riccati_backward_stream_cuda.last_staged, vs_plain=vs_plain,
             vs_resident={k: vs_resident[k] for k in ("max_abs_err", "tie_steps", "free_mismatches")},
             bitwise_equal_to_resident=all(torch.equal(a, b) for a, b in zip(twin, resident)))
        ric_err[(mode, n, m, steps, B)] = max(vs_plain["max_abs_err"].values())
        del C, c, F, twin, resident, want, Quu, qu

    # ---- 14b. Riccati lanes: each built lane count against L = 1 ----
    t0 = time.perf_counter()
    for rec in ab_riccati_lanes.run(device, ab_riccati_lanes.shapes()):
        emit(phase="riccati_lanes", card=smi, **rec)
    emit(phase="riccati_lanes_seconds", seconds=time.perf_counter() - t0)

    # ---- 15. the rollout twin vs plain and vs its resident sibling ----
    rol_err = {}
    for case, steps in (("linear_box", T_LONG), ("linear_free", T_LONG), ("pendulum", T_FD)):
        args, kw = rollout_inputs(case, B_MAIN, 1500, device, steps=steps)
        twin = ros.linesearch_rollout_stream_cuda(*args, **kw)
        plain = rol.linesearch_rollout_plain(*args, **kw)
        resident = rol.linesearch_rollout_cuda(*args, **kw)
        # The pendulum's closed loop is chaotic over 256 steps: the kernels'
        # contracted multiply-adds and the plain version's separate roundings
        # part by an ulp a step, which grows until some rollouts are apart.
        # There the twin is held to the resident kernel (the same device
        # arithmetic), alpha to the plain version's on >= 99%, and each
        # scenario's cost no further from the plain version's than the
        # resident kernel's is (plus 1e-5 of the batch's largest).
        chaotic = case == "pendulum"
        vs_plain = line_search_agreement(f"rollout twin vs plain, {case}", twin, plain, hold=not chaotic)
        vs_resident = line_search_agreement(f"rollout twin vs resident, {case}", twin, resident)
        if chaotic:
            scale = float(plain.objs.abs().max())
            rel = (twin.objs - plain.objs).abs() / scale
            vs_plain["objs_within_1e-5_frac"] = float((rel <= 1e-5).float().mean())
            no_further = bool(((twin.objs - plain.objs).abs() <= (resident.objs - plain.objs).abs() + 1e-5 * scale).all())
            if vs_plain["alpha_equal_frac"] < 0.99 or not no_further:
                raise AssertionError(f"rollout twin vs plain, {case}: {vs_plain}, no further than the resident: {no_further}")
        emit(phase="rollout_twin", case=case, B=B_MAIN, T=steps, vs_plain=vs_plain, vs_resident=vs_resident,
             bitwise_equal_to_resident=all(torch.equal(a, b) for a, b in zip(twin, resident)))
        rol_err[case] = vs_plain["traj_max_abs_where_alpha_agrees"]

    # ---- 16. the KKT twin vs plain and vs the resident KKT kernel ----
    kkt_err = {}
    for n, m, steps in ((BOX_N, BOX_M, T_LONG), (3, 1, T_PEND)):
        ins = random_kkt_inputs_torch(steps, B_MAIN, n, m, device, seed=1600 + steps)
        twin = kkt_stream.kkt_backward_stream_cuda(*ins)
        resident = kkt.run_on_card(kkt._cuda_launcher, *ins)
        err = check_kkt(f"KKT twin vs plain, n={n} m={m} T={steps}", twin, kkt.kkt_backward_plain(*ins))
        err_res = check_kkt(f"KKT twin vs resident, n={n} m={m} T={steps}", twin, resident)
        emit(phase="kkt_twin", n=n, m=m, T=steps, B=B_MAIN, tight_share=float(ins[-1].float().mean()),
             max_abs_err=err, vs_resident_max_abs_err=err_res,
             bitwise_equal_to_resident=all(torch.equal(a, b) for a, b in zip(twin, resident)),
             tol="1e-4 * max(1, max|plain|)")
        kkt_err[(n, m, steps)] = err

    # ---- 17. the slice: config 2 at T=128 through mpc_solve, with its gradient ----
    # lqr_iter 20: box-DDP at this horizon runs more iterations than config
    # 2's 10 at T=20 before every scenario stops (the phase prints n_iters)
    long_config = MPCConfig(n_state=BOX_N, n_ctrl=BOX_M, T=T_LONG, lqr_iter=LONG_ITER, exit_unconverged=False,
                            detach_unconverged=False)

    def slice_solve(arrays, weights, dev, grad=True):
        leaves = [a.to(dev).clone().requires_grad_(grad) for a in arrays]
        C, c, F, f, x0 = leaves
        sol = mpc_solve(long_config, x0, QuadCost(C, c), LinDx(F, f), u_lower=-BOX, u_upper=BOX)
        if not grad:
            return sol, None
        wx, wu = (w.to(dev) for w in weights)
        return sol, torch.autograd.grad((sol.xs * wx).sum() + (sol.us * wu).sum(), leaves)

    slice_launches = None
    for B in (BOX_B, B_MID, B_ENSEMBLE):
        if B == BOX_B:  # the recipe of phase 11, drawn on the host to share with the CPU
            arrays = [torch.tensor(a) for a in random_lqr_numpy(np.random.default_rng(17), T_LONG, B, BOX_N, BOX_M)]
            rng = np.random.default_rng(18)
            weights = [torch.tensor(rng.normal(size=s), dtype=torch.float32)
                       for s in ((T_LONG, B, BOX_N), (T_LONG, B, BOX_M))]
        else:
            arrays = list(random_lqr_torch(T_LONG, B, BOX_N, BOX_M, device, seed=1700 + B))
            gen = torch.Generator(device=device).manual_seed(B)
            weights = [torch.randn(s, generator=gen, device=device) for s in ((T_LONG, B, BOX_N), (T_LONG, B, BOX_M))]
        reset_counts()
        sol, grads = slice_solve(arrays, weights, device)
        got = counts()
        it = int(sol.info.n_iters)
        record = dict(B=B, T=T_LONG, lqr_iter=LONG_ITER, n_iters=it, launches=got,
                      converged_frac=float(sol.info.converged.float().mean()),
                      clamp_frac=float(sol.info.clamp_frac.mean()), mean_obj=float(sol.objs.mean()))
        if got != only(riccati_stream=it, rollout_stream=it, kkt_stream=1):
            raise AssertionError(f"the slice at B={B}: launches {got} for {it} iterations")
        if not bool(torch.isfinite(sol.objs).all()) or not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"the slice at B={B}: non-finite solution or gradient")
        if B == BOX_B:
            slice_launches = got
            # card vs CPU under phase 11's rule, and the float64 optimum
            cpu, g_cpu = slice_solve(arrays, weights, "cpu")
            us_diff = (sol.us.detach().cpu() - cpu.us.detach()).abs().amax(dim=(0, 2))
            agree = us_diff <= 1e-4
            obj_rel = float(((sol.objs.detach().cpu() - cpu.objs.detach()).abs()
                             / cpu.objs.detach().abs().clamp_min(1.0)).max())
            box32 = (float(np.float32(-BOX)), float(np.float32(BOX)))
            objective, u_opt, opt_pg = box_lqr_optimum(*arrays, *box32, device=device)
            j_opt = objective(u_opt)
            gap = {side: (objective(s.us) - j_opt) / j_opt.abs().clamp_min(1.0) for side, s in (("card", sol), ("cpu", cpu))}
            g_rel = {}
            for k, a, b in zip(("C", "c", "F", "f", "x_init"), grads, g_cpu):
                a, b = (a.cpu()[agree], b[agree]) if k == "x_init" else (a.cpu()[:, agree], b[:, agree])
                g_rel[k] = float((a - b).abs().max() / b.abs().max())
            record.update(card_vs_cpu_objs_max_rel=obj_rel, card_vs_cpu_us_max_abs=float(us_diff.max()),
                          us_agree_frac=float(agree.float().mean()), optimum_projected_grad=opt_pg,
                          optimum_rel_gap_max={k: float(v.max()) for k, v in gap.items()},
                          grad_rel_err_on_agreeing=g_rel)
            if obj_rel > 1e-5 or float(agree.float().mean()) < 0.95 or float(us_diff.max()) > 5e-3 \
                    or opt_pg > 1e-8 or float(gap["card"].max()) > 1e-5 or max(g_rel.values()) > 1e-3:
                raise AssertionError(f"the slice at B={B}, card vs CPU and the optimum: {record}")
        emit(phase="long_horizon_slice", **record)
        del arrays, weights, sol, grads

    # the pendulum at T=512: the fused forward, the gradient through the KKT
    # twin, against the same gradient with the CPU's plain KKT. Held with the
    # goal hanging down; reported with the swing-up goal, where the KKT
    # backward's multiplier recursion runs through the open-loop
    # linearization, unstable near upright, for 512 steps: float32 then loses
    # the cancellation that keeps the multipliers bounded, on the card and on
    # the CPU alike. Hanging down, the step is marginally stable.
    pend_config = MPCConfig(n_state=3, n_ctrl=1, T=T_PEND, lqr_iter=LQR_ITER, eps=EPS, exit_unconverged=False,
                            detach_unconverged=False)
    prob = problem(B_MAIN, device, seed=5, steps=T_PEND)
    dx = prob["dyn"]
    q, p_up = dx.get_true_obj()
    for goal, p, hold in (("hanging_down", -p_up, True), ("upright", p_up, False)):  # -p_up: (cos, sin, speed) = (-1, 0, 0)
        prm, x = dx.params.clone().requires_grad_(True), prob["x_init"].clone().requires_grad_(True)
        reset_counts()
        psol = mpc_solve(pend_config, x, QuadCost(torch.diag(q), p), dx.replace(params=prm), u_lower=-2.0, u_upper=2.0)
        g_card = torch.autograd.grad((psol.us**2).mean(), (prm, x))
        pend_launches = counts()
        if pend_launches != only(ilqr=1, kkt_stream=1):
            raise AssertionError(f"pendulum T={T_PEND} solve + gradient launched {pend_launches}")

        def fixed_point_grads(dev):
            """The same gradient at the card's fixed point, as mpc_solve's
            attach builds it, on ``dev``: the CPU's runs the plain KKT."""
            prm_d = dx.params.to(dev).clone().requires_grad_(True)
            x_d = prob["x_init"].to(dev).clone().requires_grad_(True)
            xs, us = psol.xs.detach().to(dev), psol.us.detach().to(dev)
            F, f = linearize_dynamics(dx.replace(params=prm_d), xs, us)
            spec = LqrSpec(n_state=3, constrained=True, tight_eps=pend_config.tight_eps,
                           back_eps=pend_config.back_eps, use_cuda=False if dev == "cpu" else None)
            C, c = torch.diag(q).to(dev).expand(T_PEND, B_MAIN, 4, 4), p.to(dev).expand(T_PEND, B_MAIN, 4)
            _, us2 = lqr_fixed_point(spec, x_d, C, c, F, f, xs, us, torch.full_like(us, -2.0), torch.full_like(us, 2.0))
            return torch.autograd.grad((us2**2).mean(), (prm_d, x_d))

        g_ref = fixed_point_grads("cpu")
        pend_rel = {k: float((a.cpu() - b).abs().max() / b.abs().max())
                    for k, a, b in zip(("params", "x_init"), g_card, g_ref)}
        emit(phase="long_horizon_pendulum", goal=goal, held=hold, B=B_MAIN, T=T_PEND, lqr_iter=LQR_ITER,
             launches=pend_launches, converged_frac=float(psol.info.converged.float().mean()),
             mean_obj=float(psol.objs.mean()), grad_vs_cpu_plain_kkt_rel_err=pend_rel,
             grad_max_abs={k: float(g.abs().max()) for k, g in zip(("params", "x_init"), g_card)})
        finite = all(bool(torch.isfinite(g).all()) for g in g_card)
        if hold and (not finite or max(pend_rel.values()) > 1e-3):
            raise AssertionError(f"pendulum T={T_PEND} gradient vs the CPU's plain KKT: {pend_rel}")

    # the pendulum at T=256 with finite differences: the non-fused loop through
    # the Riccati twin and the rollout twin's pendulum step, against the same
    # solve with the budget set so that the resident kernels take it
    fd_config = dataclasses.replace(pend_config, T=T_FD, grad_method=GradMethods.FINITE_DIFF)
    prob = problem(B_MAIN, device, seed=6, steps=T_FD)
    fd_args = (prob["x_init"], QuadCost(torch.diag(q), p_up), prob["dyn"])
    fd_runs = {}
    for path, budget in (("twins", horizon.VMEM_BUDGET_BYTES), ("resident", 1 << 40)):
        saved, horizon.VMEM_BUDGET_BYTES = horizon.VMEM_BUDGET_BYTES, budget
        try:
            reset_counts()
            fd = mpc_solve(fd_config, *fd_args, u_lower=-2.0, u_upper=2.0)
            fd_runs[path] = (fd, counts())
        finally:
            horizon.VMEM_BUDGET_BYTES = saved
    (fd, fd_launches), (fd_res, res_launches) = fd_runs["twins"], fd_runs["resident"]
    it, it_res = int(fd.info.n_iters), int(fd_res.info.n_iters)
    conv = (float(fd.info.converged.float().mean()), float(fd_res.info.converged.float().mean()))
    objm = (float(fd.objs.mean()), float(fd_res.objs.mean()))
    emit(phase="long_horizon_finite_diff", B=B_MAIN, T=T_FD, lqr_iter=LQR_ITER, launches=fd_launches, n_iters=it,
         converged_frac=conv[0], mean_obj=objm[0], resident_launches=res_launches,
         resident_converged_frac=conv[1], resident_mean_obj=objm[1])
    if fd_launches != only(riccati_stream=it, rollout_stream=it) or res_launches != only(riccati=it_res, rollout=it_res):
        raise AssertionError(f"pendulum FINITE_DIFF T={T_FD}: launches {fd_launches}, resident {res_launches}")
    if not bool(torch.isfinite(fd.objs).all()) or abs(conv[0] - conv[1]) > 0.05 or abs(objm[0] - objm[1]) > 1e-2 * abs(objm[1]):
        raise AssertionError(f"pendulum FINITE_DIFF T={T_FD}, twins vs resident: converged {conv}, mean obj {objm}")

    # ---- 18. time: each twin against its resident sibling, and the slice ----
    # the kernels alone on the same inputs (box-DDP n=4, m=2), CUDA events
    twin_times = {}
    for steps in (T, T_LONG, T_PEND):
        for B in (BOX_B, B_MID, B_ENSEMBLE):
            loops = int(min(20, max(2, 2e7 // (steps * B))))
            at_slice = (steps, B) == (T_LONG, BOX_B)  # the plain versions are timed there, once
            ms, plain_ms = {}, {}
            C, c, F, f, x0 = random_lqr_torch(steps, B, BOX_N, BOX_M, device, seed=1800 + steps)
            u_hat = torch.zeros((steps, B, BOX_M), device=device)
            x_hat, _ = lqr_rollout(x0, F, f, torch.zeros((steps, B, BOX_M, BOX_N), device=device), u_hat)
            c_delta = c + bmv(C, torch.cat([x_hat, u_hat], -1))
            ric_kw = dict(box, u_hat=u_hat)
            ric_lanes = ric.riccati_lanes(B, BOX_N, BOX_M, ric.BOX, sm_count, steps)  # the wrappers' pick
            for name, launcher in (("riccati", ric._cuda_launcher), ("riccati_stream", rs._stream_launcher)):
                out = {}
                ric.run_staged_riccati(timed_launch(launcher(device, BOX_N, BOX_M), loops, out),
                                       C, c_delta, F, None, BOX_N, lanes=ric_lanes, **ric_kw)
                ms[name] = out["ms"]
            res = rs.riccati_backward_stream_cuda(C, c_delta, F, None, BOX_N, **ric_kw)
            if at_slice:
                plain_ms["riccati"] = cuda_ms(lambda: ric.riccati_backward_plain(C, c_delta, F, None, BOX_N, **ric_kw), 1, 1)
            ls_args = (x0, C, c, F, f, res.K, res.k, x_hat, u_hat)
            lanes = rol.rollout_lanes(B, None, sm_count, steps)  # the wrappers' pick, for both kernels
            for name, launcher in (("rollout", rol._cuda_launcher), ("rollout_stream", ros._stream_launcher)):
                out = {}
                ls_res = rol.run_staged_rollout(timed_launch(launcher(device, BOX_N, BOX_M, None), loops, out),
                                                *ls_args, lanes=lanes, **box)
                ms[name] = out["ms"]
            if at_slice:
                plain_ms["rollout"] = cuda_ms(lambda: rol.linesearch_rollout_plain(*ls_args, **box), 1, 1)
            rol_bound = rollout_bound(ls_res, B, BOX_N, BOX_M, steps, clock_mhz)
            del res, ls_args, ls_res, x_hat, u_hat, c_delta, ric_kw, f, x0
            kkt_ins = random_kkt_inputs_torch(steps, B, BOX_N, BOX_M, device, seed=1900 + steps)
            kkt_lanes = kkt.kkt_lanes(B, BOX_N, BOX_M, sm_count, steps)  # the wrapper's pick, for both kernels
            for name, launcher in (("kkt", kkt._cuda_launcher), ("kkt_stream", kkt_stream._stream_launcher)):
                out = {}
                kkt.run_staged_kkt(timed_launch(launcher(device, BOX_N, BOX_M), loops, out), *kkt_ins, lanes=kkt_lanes)
                ms[name] = out["ms"]
            if at_slice:
                plain_ms["kkt"] = cuda_ms(lambda: kkt.kkt_backward_plain(*kkt_ins), 1, 1)
            del C, c, F, kkt_ins
            torch.cuda.empty_cache()
            bounds = dict(
                riccati=riccati_bound(B, BOX_N, BOX_M, "box", steps, clock_mhz),
                rollout=rol_bound,
                kkt=kkt_bound(B, BOX_N, BOX_M, steps, clock_mhz),
            )
            twin_times[(steps, B)] = (ms, plain_ms, bounds, lanes, ric_lanes, kkt_lanes)
            emit(phase="time_twins", T=steps, B=B, n=BOX_N, m=BOX_M, loops=loops, card=smi, rollout_lanes=lanes,
                 riccati_lanes=ric_lanes, kkt_lanes=kkt_lanes,
                 **{f"{k}_ms": v for k, v in ms.items()},
                 **{f"{k}_twin_over_resident": ms[f"{k}_stream"] / ms[k] for k in ("riccati", "rollout", "kkt")},
                 **{f"{k}_plain_ms": v for k, v in plain_ms.items()}, bounds=bounds)

    # the slice through mpc_solve: forward alone, and forward + gradient
    for B, loops in ((BOX_B, 3), (B_MID, 3), (B_ENSEMBLE, 2)):
        arrays = list(random_lqr_torch(T_LONG, B, BOX_N, BOX_M, device, seed=2100 + B))
        weights = [torch.ones((T_LONG, B, BOX_N), device=device), torch.ones((T_LONG, B, BOX_M), device=device)]
        with torch.no_grad():
            it = int(slice_solve(arrays, weights, device, grad=False)[0].info.n_iters)
            fwd_ms = cuda_ms(lambda: slice_solve(arrays, weights, device, grad=False), loops, 2)
        grad_ms = cuda_ms(lambda: slice_solve(arrays, weights, device), loops, 2)
        emit(phase="time_long_horizon_slice", B=B, T=T_LONG, lqr_iter=LONG_ITER, n_iters=it, card=smi,
             mpc_solve_ms=fwd_ms, solves_per_s=B / fwd_ms * 1e3, solve_plus_grad_ms=grad_ms,
             solve_plus_grad_per_s=B / grad_ms * 1e3)
        del arrays, weights

    ms, plain_ms, bounds, lanes, ric_lanes, kkt_lanes = twin_times[(T_LONG, BOX_B)]
    source = "diffmpc_tpu_torch/csrc/"
    return [
        dict(name="riccati_backward_pallas_stream", route="cuda", source=source + "riccati_stream.cu",
             replaces="diffmpc_tpu/ops/pallas/riccati_stream.py:171", launches=slice_launches["riccati_stream"],
             max_abs_err=ric_err[("box", BOX_N, BOX_M, T_LONG, BOX_B)], ms=ms["riccati_stream"],
             plain_ms=plain_ms["riccati"], **{k: bounds["riccati"][k] for k in ("bound_ms", "bound_by")},
             library_ms=None, lanes=ric_lanes),
        dict(name="linesearch_rollout_pallas_stream", route="cuda", source=source + "rollout_stream.cu",
             replaces="diffmpc_tpu/ops/pallas/rollout_stream.py:196", launches=slice_launches["rollout_stream"],
             max_abs_err=rol_err["linear_box"], ms=ms["rollout_stream"], plain_ms=plain_ms["rollout"],
             **{k: bounds["rollout"][k] for k in ("bound_ms", "bound_by")}, library_ms=None, lanes=lanes),
        dict(name="kkt_backward_fused_stream", route="cuda", source=source + "kkt_stream.cu",
             replaces="diffmpc_tpu/ops/pallas/kkt_stream.py:203", launches=slice_launches["kkt_stream"],
             max_abs_err=kkt_err[(BOX_N, BOX_M, T_LONG)], ms=ms["kkt_stream"], plain_ms=plain_ms["kkt"],
             **{k: bounds["kkt"][k] for k in ("bound_ms", "bound_by")}, library_ms=None, lanes=kkt_lanes),
    ]


def scenario_rel_err(got, want, scales) -> torch.Tensor:
    """Each scenario's largest |got - want| over K and k, relative to
    ``scales`` (the batch's max(1, max|want|) of each): ``(B,)``."""
    return torch.stack([(getattr(got, k).double() - getattr(want, k).double()).abs().flatten(2).amax((0, 2))
                        / scales[k] for k in ("K", "k")]).amax(0)


def max_err(got, want, names=("K", "k")) -> tuple:
    """The largest |got - want| over ``names`` and the scale
    max(1, max|want|) of each."""
    errs = {k: float((getattr(got, k) - getattr(want, k)).abs().max()) for k in names}
    scales = {k: max(1.0, float(getattr(want, k).abs().max())) for k in names}
    return errs, scales


def pieces_unequal(kernel, one, *args, **knobs) -> list:
    """The (lanes, staged) pairs, over every built lane count and both read
    modes, at which ``kernel(*args, lanes=, staged=, **knobs)`` is not bit
    for bit ``one`` (one lane reading device memory)."""
    from diffmpc_tpu_torch.ops.cuda import riccati_pieces as rp

    def outputs(r):
        return (r,) if torch.is_tensor(r) else tuple(r)

    return [(lanes, staged) for lanes in rp.PIECE_LANES for staged in (False, True)
            if not all(torch.equal(g, o) for g, o in zip(
                outputs(kernel(*args, lanes=lanes, staged=staged, **knobs)), outputs(one)))]


def pieces_vs_plain(device) -> tuple:
    """Phase 21's agreement: each piece kernel against its plain version at
    reps 1 and 9, at each of profile_riccati_pieces.BATCHES, each at one
    lane reading device memory and at every built lane count in both read
    modes bit-equal to it. Returns the largest error of each kind at B_MAIN
    and the plain versions' times there."""
    from diffmpc_tpu_torch.diagnostics import profile_riccati_pieces
    from diffmpc_tpu_torch.ops.cuda import riccati_pieces as rp

    piece_err = {}
    for B in profile_riccati_pieces.BATCHES:
        ins = profile_riccati_pieces.make_inputs(B, device)
        exact = {}  # the float64 sweeps, made where an outlier needs a witness
        for kind in profile_riccati_pieces.KINDS:
            for reps in (1, profile_riccati_pieces.REPS_HI):
                if kind == "rollout":
                    got = rp.rollout_piece_cuda(*ins, reps=reps, lanes=1, staged=False)
                    unequal = pieces_unequal(rp.rollout_piece_cuda, got, *ins, reps=reps)
                    emit(phase="pieces_lane_groups", kind=kind, reps=reps, B=B, lanes=list(rp.PIECE_LANES),
                         modes=["device", "staged"], unequal_to_one_lane=unequal)
                    if unequal:
                        raise AssertionError(f"piece rollout at B={B} reps={reps}: {unequal} differ from one lane")
                    want = rp.rollout_piece_plain(*ins, reps=reps)
                    # each scenario within 1e-5 of its sum of |stage costs|: the
                    # summed objective can cancel to near zero, its rounding
                    # grows with that sum
                    diff = (got - want.obj).abs()
                    err, rel = float(diff.max()), float((diff / want.abs_cost).max())
                    ok, tol = rel <= 1e-5, "each objective within 1e-5 of its sum of |stage costs|"
                    if reps == 1:
                        # the float64 plain version, the witness of both float32 roundings
                        obj64 = rp.rollout_piece_plain(*ins, dtype=torch.float64)
                        worst = int((diff / want.obj.abs()).argmax())
                        vs64 = {name: float(((o.double() - obj64.obj).abs() / obj64.abs_cost).max())
                                for name, o in (("card", got), ("plain", want.obj))}
                        emit(phase="rollout_piece_vs_float64", B=B, worst_relative_scenario=worst,
                             obj=dict(card=float(got[worst]), plain=float(want.obj[worst]),
                                      float64=float(obj64.obj[worst])), abs_cost=float(obj64.abs_cost[worst]),
                             max_err_over_abs_cost_vs_float64=vs64, tol="1e-5")
                        ok = ok and max(vs64.values()) <= 1e-5
                        del obj64
                else:
                    got = rp.sweep_piece_cuda(kind, *ins, reps=reps, lanes=1, staged=False)
                    # every built lane count in both read modes, bit for bit one
                    # lane reading device memory (the design gives it)
                    unequal = pieces_unequal(functools.partial(rp.sweep_piece_cuda, kind), got, *ins, reps=reps)
                    emit(phase="pieces_lane_groups", kind=kind, reps=reps, B=B, lanes=list(rp.PIECE_LANES),
                         modes=["device", "staged"], unequal_to_one_lane=unequal)
                    if unequal:
                        raise AssertionError(f"piece sweep {kind} at B={B} reps={reps}: {unequal} differ from one lane")
                    want = rp.sweep_piece_plain(kind, *ins, reps=reps)
                    errs, scales = max_err(got, want)
                    err = max(errs.values())
                    per = scenario_rel_err(got, want, scales)
                    rel, outliers = float(per.max()), (per > 1e-4).nonzero().flatten()
                    ok, extra = True, {}
                    tol = ("K, k within 1e-4 * max(1, max|plain|), or outside it on <= 0.1% of scenarios, each "
                           "one where float32 rounding moves the plain version > 1e-6 of the scale from float64")
                    if len(outliers):
                        # An ill-conditioned scenario amplifies float32 rounding
                        # past the limit in any float32 build (the plain version
                        # too, against float64). The float64 plain version
                        # witnesses each outlier as one; reps only add a 1e-30 seed.
                        if kind not in exact:
                            exact[kind] = rp.sweep_piece_plain(kind, *ins, dtype=torch.float64)
                        rounding = scenario_rel_err(want, exact[kind], scales)[outliers]
                        card64 = scenario_rel_err(got, exact[kind], scales)[outliers]
                        ok = len(outliers) <= 1e-3 * B and bool((rounding > 1e-6).all())
                        extra = dict(outliers=len(outliers), outlier_scenarios=outliers[:20].tolist(),
                                     outlier_plain_vs_float64_min=float(rounding.min()),
                                     outlier_plain_vs_float64_max=float(rounding.max()),
                                     outlier_card_vs_float64_max=float(card64.max()),
                                     plain_vs_float64_over_all=float(scenario_rel_err(want, exact[kind], scales).max()))
                emit(phase="pieces_vs_plain", kind=kind, reps=reps, T=T, B=B, max_abs_err=err, max_rel_err=rel, tol=tol,
                     **extra)
                if not ok:
                    raise AssertionError(f"piece kernel {kind} at B={B} reps={reps} vs plain: {err}")
                if B == B_MAIN:
                    piece_err[kind] = max(piece_err.get(kind, 0.0), err)
                del got, want
        del exact
        if B == B_MAIN:
            torch.cuda.synchronize()
            piece_plain_ms = {"full": cuda_ms(lambda: rp.sweep_piece_plain("full", *ins), 1, 1),
                              "rollout": cuda_ms(lambda: rp.rollout_piece_plain(*ins), 1, 1)}
        del ins
        torch.cuda.empty_cache()
    return piece_err, piece_plain_ms


def riccati_chain(device, smi: str, ilqr_ms_per_iter: float) -> list:
    """Phases 19-21, the Riccati chain's diagnostics path: the depth-blocked
    kernel against its plain version and the serial kernel, the blocked A/B
    and the piece decomposition through the diagnostics modules. Returns the three
    kernels' records for the kernels line."""
    from diffmpc_tpu_torch.diagnostics import ab_blocked_ilp, profile_riccati_pieces
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.cuda import riccati_blocked as rb
    from diffmpc_tpu_torch.ops.cuda import riccati_pieces as rp

    named = dict(riccati_blocked=rb.riccati_backward_blocked_cuda, riccati=ric.riccati_backward_cuda,
                 sweep_piece=rp.sweep_piece_cuda, rollout_piece=rp.rollout_piece_cuda)

    def reset_counts():
        for kern in named.values():
            kern.launches = 0

    def counts() -> dict:
        torch.cuda.synchronize()
        return {name: kern.launches for name, kern in named.items()}

    # ---- 19. the blocked kernel vs its plain version and the serial kernel ----
    t0 = time.perf_counter()
    blocked_err = {}
    for n, m, steps, B in ((3, 1, T, B_MAIN), (3, 1, T, B_RAGGED), (BOX_N, BOX_M, T_LONG, BOX_B)):
        C, c, F, f = (torch.tensor(a, device=device) for a in ab_blocked_ilp.make_problem(steps, B, n, m, seed=1900 + B))
        serial = ric.riccati_backward_cuda(C, c, F, f, n)
        serial_plain = ric.riccati_backward_plain(C, c, F, f, n)
        for D in (2, 4):
            want = rb.riccati_backward_blocked_plain(C, c, F, f, n, block=D)
            # the two algorithms' own distance, on the plain versions: where
            # the kernel's gap to the serial kernel comes from
            plain_gap, _ = max_err(want, serial_plain)
            got = rb.riccati_backward_blocked_cuda(C, c, F, f, n, block=D)
            torch.cuda.synchronize()
            err, scale = max_err(got, want)
            gap, gap_scale = max_err(got, serial)
            held = all(gap[k] <= 5e-4 * gap_scale[k] for k in gap)
            emit(phase="blocked_vs_plain", n=n, m=m, T=steps, B=B, block=D, max_abs_err=err,
                 tol="1e-4 * max(1, max|plain|)", vs_serial_max_abs=gap,
                 vs_serial_tol="5e-4 * max(1, max|serial|)", vs_serial_held=held,
                 plain_blocked_vs_plain_serial_max_abs=plain_gap, free_all_true=bool(got.free_mask.all()))
            if not all(err[k] <= 1e-4 * scale[k] for k in err) or not bool(got.free_mask.all()):
                raise AssertionError(f"blocked kernel vs plain, n={n} m={m} T={steps} B={B} D={D}: {err}")
            if not held:
                raise AssertionError(f"blocked kernel vs serial, n={n} m={m} T={steps} B={B} D={D}: {gap}")
            blocked_err[(n, m, steps, B, D)] = max(err.values())
            del got, want
        del C, c, F, f, serial, serial_plain
    # the longest horizon one CTA holds at (4, 2), D = 2: held against the
    # plain version (run on the host) and the serial kernel; one block more
    # raises ValueError naming it
    longest = rb.max_horizon(device, BOX_N, BOX_M, 2)
    ins = ab_blocked_ilp.make_problem(longest, 8, BOX_N, BOX_M, seed=1901)
    C, c, F, f = (torch.tensor(a, device=device) for a in ins)
    got = rb.riccati_backward_blocked_cuda(C, c, F, f, BOX_N, block=2)
    serial = ric.riccati_backward_cuda(C, c, F, f, BOX_N)
    want = rb.riccati_backward_blocked_plain(*(torch.tensor(a) for a in ins), BOX_N, block=2)
    err, scale = max_err(got._replace(K=got.K.cpu(), k=got.k.cpu()), want)
    gap, gap_scale = max_err(got, serial)
    emit(phase="blocked_longest_horizon", n=BOX_N, m=BOX_M, block=2, T=longest, B=8, max_abs_err=err,
         vs_serial_max_abs=gap, longest_at_block_4=rb.max_horizon(device, BOX_N, BOX_M, 4),
         longest_n3m1={D: rb.max_horizon(device, 3, 1, D) for D in (2, 4)})
    if not all(err[k] <= 1e-4 * scale[k] for k in err) or not all(gap[k] <= 5e-4 * gap_scale[k] for k in gap):
        raise AssertionError(f"blocked kernel at its longest horizon T={longest}: {err}, vs serial {gap}")
    del C, c, F, f, got, serial, want
    C, c, F, f = (torch.tensor(a, device=device) for a in ab_blocked_ilp.make_problem(longest + 2, 2, BOX_N, BOX_M,
                                                                                       seed=1902))
    try:
        rb.riccati_backward_blocked_cuda(C, c, F, f, BOX_N, block=2)
    except ValueError as e:
        if f"T <= {longest}" not in str(e):
            raise
    else:
        raise AssertionError(f"T={longest + 2} at block 2 did not raise")
    C, c, F, f = (torch.tensor(a, device=device) for a in ab_blocked_ilp.make_problem(6, 8, 3, 1, seed=0))
    for block, match in ((3, "block must be 2 or 4"), (4, "must evenly divide")):
        try:
            rb.riccati_backward_blocked(C, c, F, f, 3, block=block)
        except ValueError as e:
            if match not in str(e):
                raise
        else:
            raise AssertionError(f"block={block} at T=6 did not raise")
    emit(phase="blocked_validation", raised=["block must be 2 or 4", "must evenly divide", "longest horizon"],
         phase_19_seconds=time.perf_counter() - t0)

    # ---- 20. the A/B: the serial kernel against the blocked one at D = 2, 4 ----
    t0 = time.perf_counter()
    reset_counts()
    ab = ab_blocked_ilp.run()
    ab_launches = counts()
    for rec in ab:
        emit(phase="blocked_ab", card=smi, **rec)
    if ab_launches["riccati_blocked"] < 1 or ab_launches["riccati"] < 1:
        raise AssertionError(f"the A/B launched {ab_launches}")
    for rec in ab:  # every shape's blocked outputs held against the serial kernel's and the plain version's
        if not rec["vs_serial_held"]:
            raise AssertionError(f"blocked vs serial in the A/B at T={rec['T']} B={rec['B']}: {rec['vs_serial']}")
        if not rec["vs_plain_held"]:
            raise AssertionError(f"blocked vs plain in the A/B at T={rec['T']} B={rec['B']}: {rec['vs_plain']}")
    emit(phase="blocked_ab_launches", launches=ab_launches, phase_20_seconds=time.perf_counter() - t0)

    # ---- 21. the pieces: each kernel vs its plain version, then the slopes ----
    t0 = time.perf_counter()
    piece_err, piece_plain_ms = pieces_vs_plain(device)
    reset_counts()
    pieces = profile_riccati_pieces.run(ilqr_ms_per_iter)
    piece_launches = counts()
    for rec in pieces:  # the sweep's slope beside the fused kernel's time an iteration (phase 4)
        main = rec["B"] == B_MAIN
        emit(phase="pieces", card=smi, **rec, ilqr_kernel_ms_per_iteration=ilqr_ms_per_iter if main else None,
             full_slope_over_ilqr_iteration={mode: r["slope_us"]["full"] * 1e-3 / ilqr_ms_per_iter
                                             for mode, r in rec["modes"].items()} if main else None)
    if piece_launches["sweep_piece"] < 1 or piece_launches["rollout_piece"] < 1:
        raise AssertionError(f"the piece decomposition launched {piece_launches}")
    emit(phase="pieces_launches", launches=piece_launches, phase_21_seconds=time.perf_counter() - t0)

    first, main_pieces = ab[0], pieces[0]  # T=20, B=1024: the script's first shape and batch
    roll = main_pieces["rollout_modes"]
    source = "diffmpc_tpu_torch/csrc/"
    return [
        dict(name="riccati_backward_blocked_pallas", route="cuda", source=source + "riccati_blocked.cu",
             replaces="diffmpc_tpu/ops/pallas/riccati_blocked.py:445", launches=ab_launches["riccati_blocked"],
             max_abs_err=blocked_err[(3, 1, T, B_MAIN, 2)], ms=first["ms"]["blocked_D2"],
             plain_ms=first["plain_ms"]["blocked_D2"],
             **{k: first["bounds"]["blocked_D2"][k] for k in ("bound_ms", "bound_by")}, library_ms=None),
        dict(name="profile_riccati_pieces.make_sweep_kernel", route="cuda", source=source + "riccati_pieces.cu",
             replaces="scripts/profile_riccati_pieces.py:52", launches=piece_launches["sweep_piece"],
             max_abs_err=piece_err["full"], ms=main_pieces["ms"]["device:full@1"], plain_ms=piece_plain_ms["full"],
             **{k: main_pieces["bounds"]["full@1"][k] for k in ("bound_ms", "bound_by")}, library_ms=None,
             lanes=main_pieces["lanes"], staged_ms=main_pieces["ms"]["staged:full@1"]),
        dict(name="profile_riccati_pieces.make_rollout_kernel", route="cuda", source=source + "riccati_pieces.cu",
             replaces="scripts/profile_riccati_pieces.py:181", launches=piece_launches["rollout_piece"],
             max_abs_err=piece_err["rollout"], ms=roll[f"device@{main_pieces['lanes']}"]["one_ms"],
             plain_ms=piece_plain_ms["rollout"],
             **{k: main_pieces["bounds"]["rollout@1"][k] for k in ("bound_ms", "bound_by")}, library_ms=None,
             lanes=main_pieces["lanes"], staged_ms=roll[f"staged@{main_pieces['lanes']}"]["one_ms"],
             one_lane_ms=roll["device@1"]["one_ms"]),
    ]


# the learned-dynamics cell of the JAX bench (bench.py:592-624): its MLP
# (3-16-16-3, residual, tanh), T=15, lqr_iter=8; the rollout twin's horizon
# for n=3, m=1 (the JAX package takes it from T=121)
NN_HIDDEN, NN_T, NN_ITER, NN_T_LONG = (16, 16), 15, 8, 128


def nn_model(device, seed: int = 0, hidden=NN_HIDDEN, out_scale: float = 1.0):
    """The bench's MLP with He-normal weights from ``seed`` (its last layer
    scaled by ``out_scale``)."""
    from diffmpc_tpu_torch.models import NNDynamics

    nn = NNDynamics.init(3, 1, hidden=hidden, residual=True, device=device,
                         generator=torch.Generator(device=device).manual_seed(seed))
    return nn.replace(weights=nn.weights[:-1] + (nn.weights[-1] * out_scale,))


def stabilization_x_init(B: int, seed: int = 42) -> np.ndarray:
    """Near-upright starts (tests/test_imitation.py:79-83)."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(-0.6, 0.6, B)
    return np.stack([np.cos(th), np.sin(th), rng.uniform(-0.5, 0.5, B)], -1).astype(np.float32)


def nn_widths(nn) -> list:
    return [nn.n_state + nn.n_ctrl, *nn.hidden, nn.n_state]


def nn_step_ops(nn, tangents: int = 0) -> int:
    """Floating-point operations of one MLP step (nn_mlp.cuh) on a scalar
    carrying ``tangents`` dual parts: per weight a multiply and an add on
    the value and on each tangent, a bias add, per hidden unit an
    activation (one, and one multiply per tangent), the residual add."""
    w = nn_widths(nn)
    macs = sum(a * b for a, b in zip(w[:-1], w[1:]))
    units = sum(w[1:-1])
    return 2 * (1 + tangents) * macs + sum(w[1:]) + (1 + tangents) * units + nn.n_state


def nn_step_depth(nn) -> int:
    """Dependent operations of one MLP step: each unit sums its inputs in
    order and adds its bias, each hidden layer's activation counts one, the
    residual add one."""
    w = nn_widths(nn)
    return sum(a + 1 for a in w[:-1]) + len(w) - 2 + 1


def env_ilqr_bound(n: int, m: int, step_ops: int, jac_ops: int, step_depth: int, n_params: int, res, B: int,
                   steps: int, n_alpha: int, clock_mhz: float, qp_ops=None, back_depth=None) -> dict:
    """The fused solve's bound with an env's own step of ``step_ops``
    operations (``jac_ops`` carrying the n + m tangents of its Jacobian by
    dual numbers) and ``step_depth`` dependent ones, from its result ``res``
    with a ladder of ``n_alpha`` steps: its bytes (C's upper triangle, c,
    the bounds per step, x_init and the ``n_params`` params in; xs, us and
    the six stats out), its operations (the initial rollout, then for the
    iterations each scenario took, per step: the sweep's Riccati step, the
    Jacobian, the delta cost, the ladder's rollouts), or its slowest
    scenario's serial chain (the initial rollout, then per iteration the
    sweep, one rollout's depth for the whole ladder and the pick: the chosen
    trajectory is kept, not replayed), whichever is largest. The sweep's
    step is riccati_step_ops' box mode, or given ``qp_ops`` (each
    scenario's box QP, over the batch) the mask mode's plus that QP; its
    depth is riccati_step_depth's box mode, or ``back_depth``."""
    from diffmpc_tpu_torch.diagnostics.card import bound as card_bound, chain_ms

    nm = n + m
    n_bytes = 4 * B * (steps * (tri(nm) + nm + 2 * m + n + m) + n + 6) + 4 * n_params
    roll = rollout_step_ops(n, m) - 2 * n * nm + step_ops
    sweep = riccati_step_ops(n, m, "box") if qp_ops is None else riccati_step_ops(n, m, "mask") + qp_ops
    per_step = sweep + jac_ops + 2 * nm * nm + n_alpha * roll
    iters = res.n_iters.double().cpu()
    n_ops = B * steps * roll + float((iters * per_step).sum()) * steps
    fwd_depth = 5 + step_depth  # the control and its clip, then the step
    back = riccati_step_depth(n, m, "box") if back_depth is None else back_depth
    depth = steps * fwd_depth + int(iters.max()) * (steps * (back + fwd_depth) + 1)
    return card_bound(n_bytes, n_ops, chain_ms(depth, clock_mhz))


def nn_ilqr_bound(nn, res, B: int, steps: int, n_alpha: int, clock_mhz: float) -> dict:
    """env_ilqr_bound with the MLP's step at (3, 1), the sweep's chain the
    pieces profiler's step depth."""
    return env_ilqr_bound(3, 1, nn_step_ops(nn), nn_step_ops(nn, tangents=4), nn_step_depth(nn), nn.n_params, res, B,
                          steps, n_alpha, clock_mhz, back_depth=ILQR_BACK_DEPTH)


def nn_rollout_bound(nn, res, B: int, steps: int, clock_mhz: float, n_alpha: int = 10) -> dict:
    """The line search's bound with the MLP step, from its result ``res``:
    C's upper triangle, c, K, k, x_hat, u_hat, the bounds per step, x_init
    and the weights in; xs, us, objs, alpha, improved out; the operations of
    the rollouts its data needs (rollouts_needed); or one scenario's chain,
    one rollout's steps (the control and its clip, then the MLP step) and
    the pick; whichever is largest."""
    return env_rollout_bound(3, 1, nn_step_ops(nn), nn_step_depth(nn), nn.n_params, res, B, steps, clock_mhz, n_alpha)


def env_rollout_bound(n: int, m: int, step_ops: int, step_depth: int, n_params: int, res, B: int, steps: int,
                      clock_mhz: float, n_alpha: int = 10) -> dict:
    """The line search's bound with an env's own step of ``step_ops``
    operations and ``step_depth`` dependent ones, from its result ``res``:
    C's upper triangle, c, K, k, x_hat, u_hat, the bounds per step, x_init
    and the ``n_params`` params in; xs, us, objs, alpha, improved out; the
    operations of the rollouts its data needs (rollouts_needed); or one
    scenario's chain, one rollout's steps (the control and its clip, then
    the step) and the pick; whichever is largest."""
    from diffmpc_tpu_torch.diagnostics.card import bound as card_bound

    nm = n + m
    per_step = 4 * (tri(nm) + nm + m * n + m + n + m + 2 * m) + 4 * (n + m)
    n_bytes = B * (steps * per_step + 4 * n + 9) + 4 * n_params
    ops = rollouts_needed(res, n_alpha, 0.2) * steps * (rollout_step_ops(n, m) - 2 * n * nm + step_ops)
    return card_bound(n_bytes, ops, rollout_chain_ms(steps, 5 + step_depth, clock_mhz))


def nn_rollout_inputs(nn, B: int, seed: int, device, steps: int):
    """rollout_inputs' recipe with the MLP: a trajectory from random controls
    through its forward, the box sweep's gains about its linearization, the
    feedforward scaled by up to 8."""
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics
    from diffmpc_tpu_torch.utils.batch import bmv

    prob = problem(B, device, seed=seed, steps=steps)
    gen = torch.Generator(device=device).manual_seed(seed)
    u_hat = (torch.rand((steps, B, 1), generator=gen, device=device) - 0.5) * 4.0
    xs, x = [], prob["x_init"]
    for t in range(steps):
        xs.append(x)
        x = nn.forward(x, u_hat[t])
    x_hat = torch.stack(xs)
    F, _ = linearize_dynamics(nn, x_hat, u_hat)
    C, c, lo, hi = prob["C"], prob["c"], prob["u_lower"], prob["u_upper"]
    res = ric.riccati_backward_cuda(C, c + bmv(C, torch.cat([x_hat, u_hat], -1)), F, None, 3,
                                    u_lower=lo, u_upper=hi, u_hat=u_hat)
    scale = 0.5 + 7.5 * torch.rand((1, B, 1), generator=gen, device=device)
    return (prob["x_init"], C, c, None, None, res.K, res.k * scale, x_hat, u_hat), dict(u_lower=lo, u_upper=hi, dyn=nn)


def learned_dynamics(device, smi: str, clock_mhz: float) -> list:
    """Phases 22-25, the learned-dynamics path: the MLP's kernels against
    their plain versions, the path through mpc_solve with its gradient and
    the non-fused loop, the imitation step, and the times. Returns the
    kernels' records for the kernels line."""
    from diffmpc_tpu_torch import MPCConfig, QuadCost, mpc_solve
    from diffmpc_tpu_torch.diagnostics.card import interleaved_ms
    from diffmpc_tpu_torch.models import PendulumDx
    from diffmpc_tpu_torch.ops.cuda import horizon
    from diffmpc_tpu_torch.ops.cuda import ilqr as il
    from diffmpc_tpu_torch.ops.cuda import kkt
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.cuda import riccati_stream as rs
    from diffmpc_tpu_torch.ops.cuda import rollout as rol
    from diffmpc_tpu_torch.ops.cuda import rollout_stream as ros
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics
    from diffmpc_tpu_torch.ops.lqr_step import LqrSpec, lqr_fixed_point
    from diffmpc_tpu_torch.parallel import generate_expert_data, init_train_state, make_dp_train_step

    named = dict(ilqr=il.ilqr_solve_fused, kkt=kkt.kkt_backward_fused, riccati=ric.riccati_backward_cuda,
                 rollout=rol.linesearch_rollout_cuda, riccati_stream=rs.riccati_backward_stream_cuda,
                 rollout_stream=ros.linesearch_rollout_stream_cuda)

    def reset_counts():
        for kern in named.values():
            kern.launches = 0

    def counts() -> dict:
        torch.cuda.synchronize()
        return {name: kern.launches for name, kern in named.items()}

    def only(**want) -> dict:
        return {name: want.get(name, 0) for name in named}

    nn = nn_model(device)
    sm_count = torch.cuda.get_device_properties(device).multi_processor_count
    pend = PendulumDx.default(device=device)
    q, p = pend.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    cost_cpu = QuadCost(cost.C.cpu(), cost.c.cpu())

    # ---- 22. the MLP's kernels against their plain versions ----
    t0 = time.perf_counter()
    two = dict(lqr_iter=2, eps=EPS)
    nn_err, nn_plain_s = {}, {}
    for B in (B_MAIN, B_RAGGED):
        prob = dict(problem(B, device, steps=NN_T), dyn=nn)
        t1 = time.perf_counter()
        plain = il.ilqr_solve_plain(**prob, **two)
        torch.cuda.synchronize()
        nn_plain_s[B] = time.perf_counter() - t1
        exact = il.ilqr_solve_plain(**{k: v.double() if torch.is_tensor(v) else v.to(torch.float64)
                                       for k, v in prob.items()}, **two)
        kern = {h: il.ilqr_solve_fused(**prob, hoist_lin=h, **two) for h in (False, True)}
        for h, out in kern.items():
            m = witnessed_agreement(f"NN kernel vs plain, B={B} hoist_lin={h}", out, plain, exact)
            emit(phase="nn_kernel_vs_plain", B=B, T=NN_T, hidden=list(NN_HIDDEN), hoist_lin=h, **two, **m,
                 plain_seconds=nn_plain_s[B])
            nn_err[(B, h)] = m["us_max_abs"]
        differ = torch.zeros(B, dtype=torch.bool, device=device)
        for f in ("xs", "us"):
            differ |= (getattr(kern[True], f) != getattr(kern[False], f)).flatten(2).any(-1).any(0)
        for f in ("objs", "alpha", "n_iters"):
            differ |= getattr(kern[True], f) != getattr(kern[False], f)
        emit(phase="nn_hoist_lin_vs_in_sweep", B=B, scenarios_not_bit_equal=int(differ.sum()),
             us_max_abs=float((kern[True].us - kern[False].us).abs().max()))
    nn_rol_err = {}
    args, kw = nn_rollout_inputs(nn, B_MAIN, 2200 + NN_T, device, NN_T)
    agreement = line_search_agreement("NN rollout kernel vs plain", rol.linesearch_rollout_cuda(*args, **kw),
                                      rol.linesearch_rollout_plain(*args, **kw))
    emit(phase="nn_rollout_vs_plain", kernel="rollout", B=B_MAIN, T=NN_T, **agreement)
    nn_rol_err["rollout"] = agreement["traj_max_abs_where_alpha_agrees"]
    # the twin at T=128, the MLP's last layer scaled by 0.1 so that its
    # increments stay small over the long horizon. Over 128 steps the
    # kernels' contracted multiply-adds and the plain version's separate
    # roundings part the trajectories by ~1e-4 (phase 15's pendulum reads
    # the same): the twin is held to the resident kernel (the same device
    # arithmetic), its alpha and objectives to the plain version's, its
    # trajectory reported.
    args, kw = nn_rollout_inputs(nn_model(device, out_scale=0.1), B_MAIN, 2200 + NN_T_LONG, device, NN_T_LONG)
    twin, plain = ros.linesearch_rollout_stream_cuda(*args, **kw), rol.linesearch_rollout_plain(*args, **kw)
    vs_plain = line_search_agreement("NN rollout twin vs plain", twin, plain, hold=False)
    vs_resident = line_search_agreement("NN rollout twin vs resident", twin, rol.linesearch_rollout_cuda(*args, **kw))
    emit(phase="nn_rollout_vs_plain", kernel="rollout_stream", B=B_MAIN, T=NN_T_LONG, **vs_plain,
         vs_resident=vs_resident)
    if vs_plain["objs_max_rel"] > 1e-5 or vs_plain["alpha_equal_frac"] < 0.99:
        raise AssertionError(f"NN rollout twin vs plain: {vs_plain}")
    nn_rol_err["rollout_stream"] = vs_plain["traj_max_abs_where_alpha_agrees"]
    emit(phase="nn_phase_22_seconds", seconds=time.perf_counter() - t0)

    # ---- 23. the learned-dynamics path through mpc_solve ----
    t0 = time.perf_counter()
    config = MPCConfig(n_state=3, n_ctrl=1, T=NN_T, lqr_iter=NN_ITER, eps=EPS, exit_unconverged=False,
                       detach_unconverged=False)
    x = torch.tensor(x_init(B_MAIN, seed=7), device=device)
    path_launches = {}

    def solve(cfg, model, dev=device, xi=x):
        return mpc_solve(cfg, xi.to(dev), cost if dev == device else cost_cpu, model, u_lower=-2.0, u_upper=2.0)

    with torch.no_grad():
        for label, cfg in (("fused", config), ("fused_hoist_lin", dataclasses.replace(config, hoist_lin=True))):
            reset_counts()
            sol = solve(cfg, nn)
            path_launches[label] = counts()
            if path_launches[label] != only(ilqr=1):
                raise AssertionError(f"NN mpc_solve ({label}) launched {path_launches[label]}")
            if label == "fused":
                sol_fused = sol
        cpu = solve(config, nn.to(device="cpu"), dev="cpu")
    conv = (float(sol_fused.info.converged.float().mean()), float(cpu.info.converged.float().mean()))
    objm = (float(sol_fused.objs.mean()), float(cpu.objs.mean()))
    hoist_equal = bool(torch.equal(sol.us, sol_fused.us) and torch.equal(sol.objs, sol_fused.objs))
    emit(phase="nn_main_path", B=B_MAIN, T=NN_T, lqr_iter=NN_ITER, launches=path_launches["fused"],
         hoist_lin_launches=path_launches["fused_hoist_lin"], converged_frac=conv[0], cpu_converged_frac=conv[1],
         mean_obj=objm[0], cpu_mean_obj=objm[1], max_n_iters=int(sol_fused.info.n_iters),
         hoist_lin_bit_equal=hoist_equal)
    if not bool(torch.isfinite(sol_fused.objs).all()) or abs(conv[0] - conv[1]) > 0.05 \
            or abs(objm[0] - objm[1]) > 1e-2 * abs(objm[1]):
        raise AssertionError(f"NN mpc_solve, card vs CPU: converged {conv}, mean obj {objm}")

    # the gradient of mean(us**2) with respect to every weight and bias,
    # against the same gradient at the card's fixed point on the CPU
    leaves = [a.clone().requires_grad_(True) for a in nn.weights + nn.biases]
    k = len(nn.weights)

    def with_leaves(ls):
        return nn.replace(weights=tuple(ls[:k]), biases=tuple(ls[k:]))

    reset_counts()
    gsol = solve(config, with_leaves(leaves))
    g_card = torch.autograd.grad((gsol.us**2).mean(), leaves)
    grad_launches = counts()
    if grad_launches != only(ilqr=1, kkt=1):
        raise AssertionError(f"NN solve + gradient launched {grad_launches}")
    cpu_leaves = [a.detach().cpu().requires_grad_(True) for a in leaves]
    xs, us = gsol.xs.detach().cpu(), gsol.us.detach().cpu()
    F, f = linearize_dynamics(with_leaves(cpu_leaves), xs, us)
    spec = LqrSpec(n_state=3, constrained=True, tight_eps=config.tight_eps, back_eps=config.back_eps, use_cuda=False)
    C, c = cost_cpu.C.expand(NN_T, B_MAIN, 4, 4), cost_cpu.c.expand(NN_T, B_MAIN, 4)
    _, us2 = lqr_fixed_point(spec, x.cpu(), C, c, F, f, xs, us, torch.full_like(us, -2.0), torch.full_like(us, 2.0))
    g_cpu = torch.autograd.grad((us2**2).mean(), cpu_leaves)
    g_rel = [float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in zip(g_card, g_cpu)]
    emit(phase="nn_gradient", B=B_MAIN, T=NN_T, lqr_iter=NN_ITER, launches=grad_launches,
         rel_err_vs_cpu_at_the_fixed_point=g_rel, grad_max_abs=[float(g.abs().max()) for g in g_card])
    if not all(bool(torch.isfinite(g).all()) for g in g_card) or max(g_rel) > 1e-3:
        raise AssertionError(f"NN weight gradients, card vs CPU: {g_rel}")

    # an MLP too large for the kernels: the non-fused loop, the ladder in
    # PyTorch; B=256 keeps the CPU's side short
    big = nn_model(device, seed=3, hidden=(64, 64))
    xb = x[:256]
    with torch.no_grad():
        reset_counts()
        bsol = solve(config, big, xi=xb)
        big_launches = counts()
        bcpu = solve(config, big.to(device="cpu"), dev="cpu", xi=xb)
    it = int(bsol.info.n_iters)
    bconv = (float(bsol.info.converged.float().mean()), float(bcpu.info.converged.float().mean()))
    bobj = (float(bsol.objs.mean()), float(bcpu.objs.mean()))
    emit(phase="nn_non_fused", hidden=[64, 64], B=256, T=NN_T, kernel_fusable=big.kernel_fusable, n_iters=it,
         launches=big_launches, converged_frac=bconv[0], cpu_converged_frac=bconv[1], mean_obj=bobj[0],
         cpu_mean_obj=bobj[1])
    if big.kernel_fusable or big_launches != only(riccati=it) or abs(bconv[0] - bconv[1]) > 0.05 \
            or abs(bobj[0] - bobj[1]) > 1e-2 * abs(bobj[1]):
        raise AssertionError(f"the (64, 64) MLP through the non-fused loop: {big_launches}, {bconv}, {bobj}")

    # the fusable MLP with verbose=1: the non-fused loop through the rollout
    # kernel's MLP step (T=15), and at T=128 through the rollout twin's (the
    # JAX dispatch keeps the resident Riccati sweep there up to T=146)
    verbose_launches = {}
    for label, steps, model, iters in (("resident", NN_T, nn, NN_ITER),
                                       ("twins", NN_T_LONG, nn_model(device, out_scale=0.1), 4)):
        vcfg = dataclasses.replace(config, T=steps, lqr_iter=iters, verbose=1)
        printed = io.StringIO()
        with torch.no_grad(), contextlib.redirect_stdout(printed):
            reset_counts()
            vsol = solve(vcfg, model)
            got = counts()
        it = int(vsol.info.n_iters)
        want = only(**{"riccati_stream" if horizon.streams_riccati(steps, 3, 1) else "riccati": it,
                       "rollout_stream" if horizon.streams_rollout(steps, 3, 1) else "rollout": it})
        verbose_launches[label] = got
        record = dict(T=steps, lqr_iter=iters, n_iters=it, launches=got, printed_lines=len(printed.getvalue().splitlines()),
                      converged_frac=float(vsol.info.converged.float().mean()), mean_obj=float(vsol.objs.mean()))
        if label == "resident":
            record.update(fused_converged_frac=conv[0], fused_mean_obj=objm[0])
        emit(phase="nn_verbose", path=label, B=B_MAIN, **record)
        if got != want or record["printed_lines"] != it or not bool(torch.isfinite(vsol.objs).all()):
            raise AssertionError(f"NN verbose=1 ({label}): {record}")
        if label == "resident" and (abs(record["converged_frac"] - conv[0]) > 0.05
                                    or abs(record["mean_obj"] - objm[0]) > 1e-2 * abs(objm[0])):
            raise AssertionError(f"NN verbose=1 against the fused solve: {record}")
    emit(phase="nn_phase_23_seconds", seconds=time.perf_counter() - t0)

    # ---- 24. 40 imitation-learning steps of the MLP ----
    t0 = time.perf_counter()
    xs_stab = torch.tensor(stabilization_x_init(B_MAIN), device=device)
    _, u_expert, _ = generate_expert_data(config, cost, pend, xs_stab, -2.0, 2.0)
    nn0 = nn_model(device, seed=1)
    adam = functools.partial(torch.optim.Adam, lr=3e-3)
    step = make_dp_train_step(
        config, lambda prm: (cost, nn0.replace(weights=tuple(prm["w"]), biases=tuple(prm["b"]))), adam, None,
        -2.0, 2.0,
    )
    state = init_train_state({"w": nn0.weights, "b": nn0.biases}, adam)
    losses, gnorms = [], []
    reset_counts()
    t1 = time.perf_counter()
    for _ in range(40):
        state, stats = step(state, xs_stab, u_expert)
        losses.append(float(stats.loss))
        gnorms.append(float(stats.grad_norm))
    torch.cuda.synchronize()
    il_ms = (time.perf_counter() - t1) / 40 * 1e3
    il_launches = counts()
    emit(phase="nn_train", B=B_MAIN, T=NN_T, lqr_iter=NN_ITER, steps=40, losses={i: losses[i] for i in (0, 10, 20, 39)},
         grad_norm={i: gnorms[i] for i in (0, 39)}, converged_frac=float(stats.converged_frac), ms_per_step=il_ms,
         launches=il_launches, card=smi, seconds=time.perf_counter() - t0)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or not max(gnorms) > 0:
        raise AssertionError(f"NN training: losses {losses[::10]}, grad norms {gnorms[::10]}")
    if il_launches != only(ilqr=40, kkt=40):
        raise AssertionError(f"40 NN steps launched {il_launches}")

    # ---- 25. time ----
    t0 = time.perf_counter()
    env = il.kernel_env(nn)
    knobs = dict(lqr_iter=NN_ITER, eps=EPS, max_linesearch_iter=N_ALPHA)
    nn_times = {}
    for B, rounds, loops in ((B_MAIN, 5, 5), (B_ENSEMBLE, 4, 2)):
        prob = problem(B, device, steps=NN_T)
        args = (prob["x_init"], prob["C"], prob["c"], nn, prob["u_lower"], prob["u_upper"])
        # the lanes the wrapper launches at this batch, which the timed launches take
        res = il.ilqr_solve_fused(*args, **knobs)
        lanes = {"in_sweep": il.ilqr_solve_fused.last_lanes}
        il.ilqr_solve_fused(*args, hoist_lin=True, **knobs)
        lanes["hoist_lin"] = il.ilqr_solve_fused.last_lanes
        stagers = {
            label: (il._cuda_launcher(device, env, h),
                    lambda launch, label=label, h=h: il.run_staged(launch, *args, hoist_lin=h, lanes=lanes[label],
                                                                   **knobs))
            for label, h in (("in_sweep", False), ("hoist_lin", True))
        }
        ms = interleaved_ms(stagers, rounds, loops)
        nb = nn_ilqr_bound(nn, res, B, NN_T, knobs["max_linesearch_iter"], clock_mhz)
        xb_ = args[0]
        prm = [a.clone().requires_grad_(True) for a in nn.weights + nn.biases]
        model = with_leaves(prm)

        def fwd():
            with torch.no_grad():
                solve(config, model, xi=xb_)

        def fwd_grad():
            torch.autograd.grad((solve(config, model, xi=xb_).us ** 2).mean(), prm)

        t_f = t_g = float("inf")
        for _ in range(3):  # strict alternation, best of each
            t_f = min(t_f, cuda_ms(fwd, loops, 1))
            t_g = min(t_g, cuda_ms(fwd_grad, loops, 1))
        nn_times[B] = (ms, nb, lanes)
        emit(phase="time_nn", B=B, T=NN_T, lqr_iter=NN_ITER, hidden=list(NN_HIDDEN), card=smi, lanes=lanes,
             kernel_ms=ms, hoist_lin_over_in_sweep=ms["hoist_lin"] / ms["in_sweep"],
             kernel_solves_per_s=B / ms["in_sweep"] * 1e3, bound=nb, max_n_iters=int(res.n_iters.max()),
             mpc_solve_ms=t_f, mpc_solve_per_s=B / t_f * 1e3, solve_plus_grad_ms=t_g,
             solve_plus_grad_per_s=B / t_g * 1e3)
        del args, res
        torch.cuda.empty_cache()
    prob = dict(problem(B_MAIN, device, steps=NN_T), dyn=nn)
    # the plain solve at two iterations (phase 22's), warmed up once, then timed once
    nn_plain_ms = cuda_ms(lambda: il.ilqr_solve_plain(**prob, **dict(knobs, lqr_iter=2)), 1, 1)
    rol_times = {}
    for name, steps, launcher, model in (("rollout", NN_T, rol._cuda_launcher, nn),
                                         ("rollout_stream", NN_T_LONG, ros._stream_launcher,
                                          nn_model(device, out_scale=0.1))):
        args, kw = nn_rollout_inputs(model, B_MAIN, 2500 + steps, device, steps)
        out = {}
        lanes = rol.rollout_lanes(B_MAIN, il.kernel_env(model), sm_count, steps)  # the wrapper's pick
        res = rol.run_staged_rollout(timed_launch(launcher(device, 3, 1, model), 20, out), *args, lanes=lanes, **kw)
        plain_ms = cuda_ms(lambda: rol.linesearch_rollout_plain(*args, **kw), 1, 1)
        rol_times[name] = (out["ms"], plain_ms, nn_rollout_bound(model, res, B_MAIN, steps, clock_mhz), lanes)
        emit(phase="time_nn_rollout", kernel=name, B=B_MAIN, T=steps, card=smi, lanes=lanes, kernel_ms=out["ms"],
             plain_ms=plain_ms, bound=rol_times[name][2])
    emit(phase="nn_phase_25_seconds", seconds=time.perf_counter() - t0, nn_plain_ms=nn_plain_ms)

    source = "diffmpc_tpu_torch/csrc/"
    ms, nb, nn_lanes = nn_times[B_MAIN]
    keep = ("bound_ms", "bound_by")
    return [
        dict(name="ilqr_solve_fused[NNDynamics 3-16-16-3]", route="cuda", source=source + "ilqr_nn.cu",
             replaces="diffmpc_tpu/ops/pallas/ilqr.py:458", launches=path_launches["fused"]["ilqr"],
             max_abs_err=nn_err[(B_MAIN, False)], ms=ms["in_sweep"], plain_ms=nn_plain_ms, plain_lqr_iter=2,
             **{k: nb[k] for k in keep}, library_ms=None, lanes=nn_lanes["in_sweep"]),
        dict(name="ilqr_solve_fused[NNDynamics 3-16-16-3, hoist_lin]", route="cuda", source=source + "ilqr_nn.cu",
             replaces="diffmpc_tpu/ops/pallas/ilqr.py:234", launches=path_launches["fused_hoist_lin"]["ilqr"],
             max_abs_err=nn_err[(B_MAIN, True)], ms=ms["hoist_lin"], plain_ms=nn_plain_ms, plain_lqr_iter=2,
             **{k: nb[k] for k in keep}, library_ms=None, lanes=nn_lanes["hoist_lin"]),
        dict(name="linesearch_rollout_pallas[NNDynamics 3-16-16-3]", route="cuda", source=source + "rollout.cu",
             replaces="diffmpc_tpu/ops/pallas/rollout.py:180", launches=verbose_launches["resident"]["rollout"],
             max_abs_err=nn_rol_err["rollout"], ms=rol_times["rollout"][0], plain_ms=rol_times["rollout"][1],
             **{k: rol_times["rollout"][2][k] for k in keep}, library_ms=None, lanes=rol_times["rollout"][3]),
        dict(name="linesearch_rollout_pallas_stream[NNDynamics 3-16-16-3]", route="cuda",
             source=source + "rollout_stream.cu", replaces="diffmpc_tpu/ops/pallas/rollout_stream.py:196",
             launches=verbose_launches["twins"]["rollout_stream"], max_abs_err=nn_rol_err["rollout_stream"],
             ms=rol_times["rollout_stream"][0], plain_ms=rol_times["rollout_stream"][1],
             **{k: rol_times["rollout_stream"][2][k] for k in keep}, library_ms=None,
             lanes=rol_times["rollout_stream"][3]),
    ]


def data_parallel(device, smi: str) -> dict:
    """Phases 26-29, the data-parallel path: the probe kernel against its
    plain version; one rank over NCCL in this process; two ranks over gloo
    sharing the card (diffmpc_tpu_torch.parallel.dryrun); the times. Returns
    the probe kernel's record for the kernels line."""
    from diffmpc_tpu_torch.ops.assoc_riccati import riccati_backward_time_sharded
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.cuda.ilqr import ilqr_solve_fused, ilqr_solve_plain
    from diffmpc_tpu_torch.ops.cuda.kkt import kkt_backward_fused, kkt_backward_plain
    from diffmpc_tpu_torch.ops.cuda.shard_probe import launch_floor_cuda, shard_probe_cuda, shard_probe_plain
    from diffmpc_tpu_torch.parallel import distributed, dryrun, make_mesh, shard_batch

    # ---- 26. the probe kernel against its plain version ----
    t0 = time.perf_counter()
    probe = {}
    for L in (1, 2, 3, 8, 16, PROBE_L_RANK, B_ENSEMBLE):
        x = torch.arange(L, dtype=torch.float32, device=device) ** 1.5
        got, want = shard_probe_cuda(x), shard_probe_plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe kernel vs plain at L={L}: {got[:4].tolist()} vs {want[:4].tolist()}")
        # the library call: the four reads summed by one reduction, broadcast
        idx = torch.tensor([0, 0, min(1, L - 1), min(2, L - 1)], device=device)
        out = torch.empty_like(x)
        # the kernel alone and an empty kernel, each 100 launches in one CUDA
        # graph, in the same rounds: the wrapper's host work runs at the
        # capture, not in the replays
        alone = graph_ms({"kernel": lambda: shard_probe_cuda(x, out=out), "floor": lambda: launch_floor_cuda(device)})
        if not torch.equal(out, want):
            raise AssertionError(f"probe kernel replayed from its graph vs plain at L={L}")
        probe[L] = dict(max_abs_err=0.0, kernel_ms=cuda_ms(lambda: shard_probe_cuda(x), 200, 3),
                        kernel_alone_ms=alone["kernel"], launch_floor_ms=alone["floor"],
                        plain_ms=cuda_ms(lambda: shard_probe_plain(x), 200, 3),
                        library_ms=cuda_ms(lambda: x[idx].sum().expand(L).clone(), 200, 3), **bound(4 * L + 12, 3))
        probe[L].update(alone_over_floor=alone["kernel"] / alone["floor"])
        emit(phase="probe_vs_plain", L=L, card=smi, bit_equal=True, **probe[L])
    # a shard and an output at each offset of 1-3 floats from a 16-byte
    # boundary: the kernel's scalar head and tail around its float4 stores
    misaligned = []
    for L in (8, 1027, B_ENSEMBLE):
        for offset in (1, 2, 3):
            x = (torch.arange(L + offset, dtype=torch.float32, device=device) ** 1.5)[offset:]
            base = torch.full((L + 8,), float("nan"), device=device)
            got = shard_probe_cuda(x, out=base[offset:offset + L])
            torch.cuda.synchronize()
            if not torch.equal(got, shard_probe_plain(x)) or not bool(torch.isnan(base[:offset]).all()) \
                    or not bool(torch.isnan(base[offset + L:]).all()):
                raise AssertionError(f"probe kernel vs plain at L={L}, offset {offset}")
            misaligned.append((L, offset))
    emit(phase="probe_misaligned", bit_equal=True, shards=misaligned)
    emit(phase="probe_seconds", seconds=time.perf_counter() - t0)

    # ---- 27. one rank over NCCL, in this process. The dry run sets the
    # launch counts to 0 before each of its parts (probe, ensemble step,
    # solve, imitation steps) and reads them after; check() holds them ----
    t0 = time.perf_counter()
    spec = dryrun.make_spec(device, B=B_ENSEMBLE, T=T, lqr_iter=LQR_ITER, il_batch=B_MAIN, il_steps=3)
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(f"file://{tmp}/store", 1, 0, device=device)
        try:
            mesh = make_mesh()
            report = dryrun.check([dryrun.rank_dryrun(mesh, spec)], dryrun.single_process(spec, device), spec)
            emit(phase="dp_world_1", B=B_ENSEMBLE, il_batch=B_MAIN, **report)
            # the iLQR and KKT kernels on the step's own inputs: config 5's
            # per-scenario params (the kernel's params_stride 3 path) at
            # B=65,536, recorded from one step on the mesh, each run again
            # beside its plain version
            ilqr_calls, kkt_calls = [], []
            step, state, x, u = dryrun.ensemble_step(spec, device, mesh)
            with recording("diffmpc_tpu_torch.mpc", "ilqr_solve_fused", ilqr_calls), \
                    recording("diffmpc_tpu_torch.ops.library", "kkt_backward_fused", kkt_calls):
                step(state, x, u)
            (args, kw), = ilqr_calls
            plain_kw = {k: v for k, v in kw.items() if k != "use_cuda"}
            x0, C, c, dyn, lo, hi = args
            with torch.no_grad():
                # phase 2's chaos rule on the first B_MAIN scenarios. At the
                # full batch float32 alone moves ~0.2% of the swing-ups to
                # another basin (the shared-params kernel too), so the
                # float64 plain solve is the witness, ties held as phase 2's
                rows = (x0[:B_MAIN], C[:, :B_MAIN], c[:, :B_MAIN], dyn.replace(params=dyn.params[:B_MAIN]),
                        lo[:, :B_MAIN], hi[:, :B_MAIN])
                m = compare(ilqr_solve_fused(*rows, **kw), ilqr_solve_plain(*rows, **plain_kw))
                emit(phase="ensemble_kernel_vs_plain", B=B_MAIN, params=list(rows[3].params.shape), T=T,
                     lqr_iter=kw["lqr_iter"], **m)
                check_chaos(f"config 5's step, per-scenario params, its first {B_MAIN} scenarios", m)
                full = (ilqr_solve_fused(*args, **kw), ilqr_solve_plain(*args, **plain_kw))
                exact = ilqr_solve_plain(*(a.to(torch.float64) for a in args), **plain_kw)
                m = witnessed_agreement("config 5's step, per-scenario params", *full, exact, ties=True)
                emit(phase="ensemble_kernel_vs_plain", B=B_ENSEMBLE, params=list(dyn.params.shape), T=T,
                     lqr_iter=kw["lqr_iter"], witness="float64 plain", **m, chaos_rule=compare(*full))
                # the same rule on the shared-params kernel (phase 2's
                # problem) at the same batch, for comparison
                prob = problem(B_ENSEMBLE, device)
                knobs = dict(lqr_iter=LQR_ITER, eps=EPS)
                full = (ilqr_solve_fused(**prob, **knobs), ilqr_solve_plain(**prob, **knobs))
                exact = ilqr_solve_plain(**{k: v.to(torch.float64) for k, v in prob.items()}, **knobs)
                m = witnessed_agreement("shared params", *full, exact, ties=True)
                emit(phase="shared_kernel_vs_plain", B=B_ENSEMBLE, T=T, **knobs, witness="float64 plain", **m,
                     chaos_rule=compare(*full))
            (args, kw), = kkt_calls
            plain_kw = {k: v for k, v in kw.items() if k != "use_cuda"}
            err = check_kkt("config 5's step", kkt_backward_fused(*args, **kw), kkt_backward_plain(*args, **plain_kw))
            emit(phase="ensemble_kkt_vs_plain", B=B_ENSEMBLE, tight_share=float(args[5].float().mean()),
                 max_abs_err=err, tol="1e-4 * max(1, max|plain|)")
            # the time-sharded Riccati at D=1 against the serial kernel's free
            # mode, within the blocked kernel's limit (5e-4 of the scale)
            time_mesh = make_mesh(axis="time")
            for steps, B, n, m in ((T, B_MAIN, 3, 1), (T_LONG, BOX_B, BOX_N, BOX_M)):
                C, c, F, f, _ = random_lqr_torch(steps, B, n, m, device, seed=2600 + steps)
                shard = shard_batch(time_mesh, (C, c, F, f))
                err, scale = max_err(riccati_backward_time_sharded(time_mesh, *shard, n),
                                     ric.riccati_backward_cuda(C, c, F, f, n))
                emit(phase="time_sharded_riccati", D=1, backend=report["backend"], T=steps, B=B, n=n, m=m,
                     vs_serial_max_abs=err, tol="5e-4 * max(1, max|serial|)", scale=scale)
                if any(err[k] > 5e-4 * scale[k] for k in err):
                    raise AssertionError(f"time-sharded Riccati vs the serial kernel: {err}, scale {scale}")
            # ---- 29. the mesh's own cost: its step against the step without
            # one, in strict alternation; the step's all_reduce alone ----
            on_mesh, alone = (dryrun.ensemble_step(spec, device, mh) for mh in (mesh, None))
            t_mesh = t_alone = float("inf")
            for _ in range(5):
                t_mesh = min(t_mesh, cuda_ms(lambda: on_mesh[0](*on_mesh[1:]), 5, 1))
                t_alone = min(t_alone, cuda_ms(lambda: alone[0](*alone[1:]), 5, 1))
            emit(phase="time_dp_world_1", backend=report["backend"], B=B_ENSEMBLE, card=smi, step_ms_on_mesh=t_mesh,
                 step_ms_without_mesh=t_alone, mesh_cost_ms=t_mesh - t_alone,
                 all_reduce_ms=dryrun.all_reduce_ms(mesh, 200))
        finally:
            distributed.shutdown()
    emit(phase="dp_world_1_seconds", seconds=time.perf_counter() - t0)

    # ---- 28. two ranks over gloo sharing the card (NCCL refuses two ranks
    # on one device), 32,768 scenarios each; each rank times its steps ----
    t0 = time.perf_counter()
    two = dryrun.run(2, device, B=B_ENSEMBLE, T=T, lqr_iter=LQR_ITER, il_batch=B_MAIN, il_steps=3)
    times = two.pop("times")
    emit(phase="dp_two_ranks", B=B_ENSEMBLE, il_batch=B_MAIN, **two)
    # ---- 29. the two ranks' step times: two processes taking turns on one
    # card, not a scaling figure ----
    emit(phase="time_dp_two_ranks", card=smi, sharing_one_card=True, ranks=times,
         seconds=time.perf_counter() - t0)
    path_launches = sum(r["probe"] for run in (report, two) for r in run["launches"]["probe"])
    row = probe[PROBE_L]
    return dict(name="shard_probe", route="cuda", source="diffmpc_tpu_torch/csrc/shard_probe.cu",
                replaces="tests/test_pallas_sharding.py:221", launches=path_launches,
                max_abs_err=max(v["max_abs_err"] for v in probe.values()), ms=row["kernel_alone_ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                library_ms=row["library_ms"], wrapper_ms=row["kernel_ms"], launch_floor_ms=row["launch_floor_ms"],
                at_rank_shards={L: {k: probe[L][k] for k in ("kernel_alone_ms", "launch_floor_ms", "kernel_ms",
                                                            "library_ms")} for L in (PROBE_L_RANK, B_ENSEMBLE)})


# ---------------------------------------------------------------------------
# Phases 30-33: the kernels built at first use (csrc/build.py's variants),
# and the slice they serve: the n = 6, m = 3 MLP of scripts/ab_pnqp_enum3.py
# under each box-QP mode, and a (6, 3) LinDx box-DDP.
# ---------------------------------------------------------------------------

# scripts/ab_pnqp_enum3.py:36-55: the n = 6, m = 3 residual 16-16 MLP, T=20,
# lqr_iter=10, pnqp_iter=8, box +-0.5, B=1024; the LinDx call at B=4096
SL_N, SL_M, SL_HIDDEN, SL_T, SL_ITER, SL_BOX, SL_B, SL_LIN_B = 6, 3, (16, 16), 20, 10, 0.5, 1024, 4096
SL_CPU_B = 64  # the scenarios held against a plain solve on the host (each scenario solves alone)


def slice_variant_keys() -> list:
    """Every variant the slice launches: the (6, 3) MLP's fused solve under
    the default QP and the 27-candidate enumeration, the 3-32-3 MLP's, the
    pendulum's with the simplified value update; the Riccati sweep at (6, 3)
    under both of its QPs and at (4, 2) under the loop ("0"); the line
    search at (6, 3); the KKT pair at (6, 3) and, with the simplified update,
    at (3, 1). The zoo's shapes are the zoo's phases' (zoo_variant_keys):
    phases 35-36 launch them at the envs' published widths."""
    from diffmpc_tpu_torch.csrc.build import ENUM_LOOP, ENUM_THREE, VariantKey as K

    keys = [K("ilqr", SL_N, SL_M, "nn", SL_HIDDEN), K("ilqr", SL_N, SL_M, "nn", SL_HIDDEN, ENUM_THREE),
            K("ilqr", 3, 1, "nn", (32,)), K("ilqr", 3, 1, "pendulum", exact=True),
            K("riccati", SL_N, SL_M), K("riccati", SL_N, SL_M, enum=ENUM_THREE), K("riccati", BOX_N, BOX_M, enum=ENUM_LOOP),
            K("rollout", SL_N, SL_M), K("kkt", SL_N, SL_M), K("kkt", 3, 1, exact=True)]
    return keys


def config2_recipe(seed: int, B: int, n: int, m: int) -> list:
    """BASELINE.json config 2's random LQR recipe (random_lqr_numpy) at
    (n, m), its dynamics scaled by sqrt(4 / n) so that their open-loop
    growth is config 2's at n = 4 (the recipe's F has entries of 0.5 N(0, 1):
    a spectral radius near 0.5 sqrt(n), which at n = 6 grows the states ~50x
    over 20 steps and leaves the condensed QP too ill-conditioned for its
    float64 optimum)."""
    C, c, F, f, x0 = random_lqr_numpy(np.random.default_rng(seed), T, B, n, m)
    return [C, c, (F * np.float32(np.sqrt(BOX_N / n))).astype(np.float32), f, x0]


def qp_chol_ops(m: int) -> int:
    return m * m * m // 3 * 2 + 4 * m


def qp_obj_ops(m: int) -> int:
    return 2 * m * m + 3 * m


def box_qp_ops(m: int, enumerates: bool, n_qp: float) -> float:
    """Operations of one box QP of ``m`` dims (riccati_entries.cuh), counted
    from the source: the enumeration's 3^m candidates, each a Cholesky solve
    of its free block, its KKT checks and its objective; or the
    projected-Newton loop's start and its ``n_qp`` steps, each the gradient,
    the masked factor and solve and six Armijo candidates."""
    chol, solve, obj = qp_chol_ops(m), 2 * m * m, qp_obj_ops(m)
    if enumerates:
        return 3**m * (chol + solve + 4 * m * m + obj + 4 * m)
    return chol + solve + obj + n_qp * (3 * m * m + chol + solve + 6 * (obj + 3 * m) + obj) + 2 * m * m + 2 * m


def box_qp_depth(m: int, enumerates: bool, n_qp: float) -> float:
    """Dependent operations of one box QP of ``m`` dims, floors from the
    source: the clipped Newton point (the factor and solve, as the masked
    gains count them, the clip, the objective), then the enumeration's fold
    over 3^m - 1 candidates that run beside it, or the loop's ``n_qp`` steps
    (the masked factor and solve, the gradient, the step test and the
    Armijo picks), then the frozen mask."""
    factor = 6 * m * (m + 1) // 2
    start = factor + 2 + 2 * m
    middle = 3**m - 1 if enumerates else n_qp * (factor + 5 * m + 8)
    return start + middle + m + 2


def variant_riccati_bound(res, B: int, n: int, m: int, steps: int, clock_mhz: float, enumerates: bool) -> dict:
    """The box-mode Riccati sweep's bound at any (n, m) from its result
    ``res``: its bytes (riccati_bytes), its operations (the step without its
    QP, riccati_step_ops in mask mode, and each step's QP with the loop's
    steps this run took, ``res.n_qp_iter``), or its slowest scenario's chain
    (the Q form 2n + 1, the QP, the masked gains 6 m (m + 1) / 2, the value
    update 2m + 1), whichever is largest."""
    from diffmpc_tpu_torch.diagnostics.card import bound as card_bound
    from diffmpc_tpu_torch.diagnostics.card import chain_ms

    n_qp = res.n_qp_iter.double().cpu()
    qp = box_qp_ops(m, enumerates, n_qp)
    ops = steps * B * riccati_step_ops(n, m, "mask") + (float(qp.sum()) if torch.is_tensor(qp) else qp * steps * B)
    base = 2 * n + 1 + 6 * m * (m + 1) // 2 + 2 * m + 1
    depth = (base + box_qp_depth(m, enumerates, n_qp)).sum(0).max() if not enumerates else \
        steps * (base + box_qp_depth(m, True, 1))
    return card_bound(riccati_bytes(B, n, m, steps), ops, chain_ms(float(depth), clock_mhz))


def variant_nn_ilqr_bound(nn, res, B: int, steps: int, n_alpha: int, clock_mhz: float, enumerates: bool) -> dict:
    """env_ilqr_bound with the MLP's step at its own (n, m), its box QP's
    operations and chain by box_qp_ops and box_qp_depth (the loop at the
    mean QP steps each scenario's last iteration took, ``res.qp_iters``)."""
    n, m = nn.n_state, nn.n_ctrl
    qp_iters = res.qp_iters.double().cpu()
    qp = torch.tensor([box_qp_ops(m, enumerates, float(q)) for q in qp_iters], dtype=torch.float64)
    back = 2 * n + 1 + 6 * m * (m + 1) // 2 + 2 * m + 1 + box_qp_depth(m, enumerates, float(qp_iters.max()))
    return env_ilqr_bound(n, m, nn_step_ops(nn), nn_step_ops(nn, tangents=n + m), nn_step_depth(nn), nn.n_params,
                          res, B, steps, n_alpha, clock_mhz, qp_ops=qp, back_depth=back)


def slice_mlp(device):
    """The slice's MLP, weights from a seeded generator: n = 6, m = 3, hidden
    16-16, tanh, residual (scripts/ab_pnqp_enum3.py's architecture)."""
    from diffmpc_tpu_torch.models import NNDynamics

    return NNDynamics.init(SL_N, SL_M, hidden=SL_HIDDEN, residual=True, device=device,
                           generator=torch.Generator(device=device).manual_seed(0))


def slice_problem(B: int, device):
    """scripts/ab_pnqp_enum3.py's cost and box: C = diag(1 x 6, 0.02 x 3),
    c = (0 x 6, 0.08 x 3), x0 ~ U(-0.8, 0.8) from seed 1, box +-0.5."""
    nm = SL_N + SL_M
    x0 = torch.tensor(np.random.default_rng(1).uniform(-0.8, 0.8, (B, SL_N)), dtype=torch.float32, device=device)
    C = torch.diag(torch.tensor([1.0] * SL_N + [0.02] * SL_M, device=device)).expand(SL_T, B, nm, nm)
    c = torch.tensor([0.0] * SL_N + [0.08] * SL_M, device=device).expand(SL_T, B, nm)
    box = torch.full((SL_T, B, SL_M), SL_BOX, device=device)
    return dict(x_init=x0, C=C, c=c, u_lower=-box, u_upper=box)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` equal entry by entry, a NaN equal to a NaN (a
    scenario's last improvement is NaN where its last candidates diverged)."""
    if a.is_floating_point():
        nan = a.isnan()
        return torch.equal(nan, b.isnan()) and torch.equal(a.masked_fill(nan, 0.0), b.masked_fill(nan, 0.0))
    return torch.equal(a, b)


def lanes_bit_equal(name: str, results: dict) -> dict:
    """Each lane count's result bit-equal to one lane's (the first), every
    field (:func:`same_bits`); raises otherwise."""
    first = next(iter(results.values()))
    out = {}
    for label, res in results.items():
        same = all(same_bits(a, b) for a, b in zip(res, first))
        out[str(label)] = same
        if not same:
            raise AssertionError(f"{name}: lanes {label} is not bit-equal to {next(iter(results))}")
    return out


# the sources whose units hold the Riccati and KKT launch caches (the
# one-lane kernels' wave), built a second time beside the library in phase 1
CACHE_SOURCES = ("riccati_l1.cu", "kkt_l1.cu")


def check_unique_symbols(libraries: dict) -> None:
    """Raise where a library (name -> path) exports a GNU unique symbol: a
    cache that a second build loaded beside would share."""
    from diffmpc_tpu_torch.csrc import build

    found = {name: build.unique_symbols(path) for name, path in libraries.items()}
    emit(phase="unique_symbols", libraries=len(found), found={k: v for k, v in found.items() if v})
    if any(found.values()):
        raise AssertionError(f"GNU unique symbols exported: {found}")


def build_variants_phase(keys: list) -> None:
    """Phase 30: build every variant of ``keys`` in one parallel build; its
    seconds, each key's units' seconds, and each key's registers, spills and
    stack frame (per kernel for the fused solve and the line search); no
    variant's library exports a GNU unique symbol."""
    from diffmpc_tpu_torch.csrc import build

    t0 = time.perf_counter()
    seconds = {}
    built = build.build_variants(keys, seconds)
    build_s = time.perf_counter() - t0
    ptxas = {}
    for key, (path, log) in built.items():
        report = ptxas_report(log)
        ptxas[key.name] = dict(kernels=len(report), max_registers=max((r.get("registers", 0) for r in report.values()),
                                                                       default=0),
                               spill_stores=sum(r.get("spill_stores", 0) for r in report.values()),
                               spill_loads=sum(r.get("spill_loads", 0) for r in report.values()),
                               stack_frame_max=max((r.get("stack_frame", 0) for r in report.values()), default=0),
                               per_kernel={k[:120]: v for k, v in report.items()}
                               if key.family == "ilqr" or key.env not in ("linear", "nn") else None)
    emit(phase="variants_build", seconds=build_s, keys=len(built), per_key_seconds=seconds, ptxas=ptxas,
         workers=build.variant_workers())
    check_unique_symbols({key.name: path for key, (path, _) in built.items()})
    # each fused-solve key's registers, local memory, shared memory a block
    # and blocks an SM at every lane count, as the card gives them; raises
    # past the card's opt-in shared memory or below one block an SM
    from diffmpc_tpu_torch.diagnostics.ab_ilqr_lanes import occupancy
    from diffmpc_tpu_torch.ops.cuda.ilqr import ILQR_LANES

    props = torch.cuda.get_device_properties(0)
    limit = getattr(props, "shared_memory_per_block_optin", 227 * 1024)
    occ = {}
    for key in built:
        if key.family == "ilqr":
            occ[key.name] = {f"{'hoist' if hoist else 'sweep'}": occupancy(build.load_variant(key), ILQR_LANES, hoist)
                             for hoist in (False, True)}
    emit(phase="variants_occupancy", smem_optin_bytes=limit, occupancy=occ)
    for name, by_hoist in occ.items():
        for by_l in by_hoist.values():
            for L, o in by_l.items():
                if o["smem_block_bytes"] > limit or o["blocks_per_sm"] < 1:
                    raise AssertionError(f"{name} at {L} lanes: {o} (opt-in limit {limit} bytes)")


def variants_slice(device, smi: str, clock_mhz: float) -> list:
    """Phases 30-33: the variants' build, each variant kernel against its
    plain version, the slice's two calls through mpc_solve at full width with
    the MLP's gradient. Returns the kernels' records
    for the kernels line."""
    from diffmpc_tpu_torch import LinDx, MPCConfig, QuadCost, mpc_solve
    from diffmpc_tpu_torch.csrc import build
    from diffmpc_tpu_torch.diagnostics.card import interleaved_ms
    from diffmpc_tpu_torch.models import NNDynamics
    from diffmpc_tpu_torch.ops.cuda import ilqr as il
    from diffmpc_tpu_torch.ops.cuda import kkt
    from diffmpc_tpu_torch.ops.cuda import kkt_stream
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.cuda import rollout as rol
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics
    from diffmpc_tpu_torch.ops.lqr import lqr_rollout
    from diffmpc_tpu_torch.ops.lqr_step import LqrSpec, lqr_fixed_point
    from diffmpc_tpu_torch.utils.batch import bmv

    named = dict(ilqr=il.ilqr_solve_fused, kkt=kkt.kkt_backward_fused, kkt_stream=kkt_stream.kkt_backward_stream_cuda,
                 riccati=ric.riccati_backward_cuda, rollout=rol.linesearch_rollout_cuda)

    def reset_counts():
        for kern in named.values():
            kern.launches = 0

    def counts() -> dict:
        torch.cuda.synchronize()
        return {name: kern.launches for name, kern in named.items()}

    def only(**want) -> dict:
        return {name: want.get(name, 0) for name in named}

    sm_count = torch.cuda.get_device_properties(device).multi_processor_count

    # ---- 30. the variants, the slice's, the zoo's and the receding loop's, built together ----
    build_variants_phase(slice_variant_keys() + zoo_variant_keys() + receding_variant_keys())

    # ---- 31. each variant kernel against its plain version ----
    t0 = time.perf_counter()
    # the Riccati sweep at (6, 3) under both of its QPs (and "0", which at
    # m = 3 is ""'s QP: the same kernel), every mode, and at (4, 2) under "0"
    ric_err, ric_ms = {}, {}
    for n, m, mode, qp, B in [(SL_N, SL_M, "box", e, SL_LIN_B) for e in ("", "0", "1")] + [
            (SL_N, SL_M, "free", "", B_RAGGED), (SL_N, SL_M, "mask", "", B_RAGGED), (BOX_N, BOX_M, "box", "0", B_RAGGED)]:
        C, c, F, _, _ = random_lqr_torch(T, B, n, m, device, seed=3000 + B + 10 * n + m)
        gen = torch.Generator(device=device).manual_seed(B + len(qp))
        kw = dict(pnqp_enum=qp)
        if mode == "box":
            u_hat = (torch.rand((T, B, m), generator=gen, device=device) - 0.5) * 0.6
            kw.update(u_lower=torch.tensor(-BOX, device=device), u_upper=torch.tensor(BOX, device=device), u_hat=u_hat)
        elif mode == "mask":
            kw.update(ctrl_mask=torch.rand((T, B, m), generator=gen, device=device) < 0.3)
        got = ric.riccati_backward_cuda(C, c, F, None, n, **kw)
        lanes = ric.riccati_backward_cuda.last_lanes
        want, Quu, qu = ric.riccati_backward_plain(C, c, F, None, n, return_qp=True, **kw)
        agreement = riccati_agreement(f"{mode} n={n} m={m} pnqp_enum={qp!r} B={B}", got, want, Quu, qu)
        # every built lane count (one lane read from device memory and staged)
        # bit-equal to one lane
        launch = ric._cuda_launcher(device, n, m, pnqp_enum=qp)
        by_lanes = {(L, s): ric.run_staged_riccati(launch, C, c, F, None, n, lanes=L, staged=s, **kw)
                    for L, s in ((1, False), (1, True), (16, True))}
        bit_equal = lanes_bit_equal(f"Riccati (n={n}, m={m}) {mode} {qp!r}", by_lanes)
        record = dict(phase="variant_riccati_vs_plain", mode=mode, n=n, m=m, pnqp_enum=qp, B=B, T=T, lanes=lanes,
                      lanes_bit_equal=bit_equal, mean_n_qp=float(got.n_qp_iter.float().mean()), **agreement)
        if mode == "box":
            out = {}
            ric.run_staged_riccati(timed_launch(launch, 20, out), C, c, F, None, n, lanes=lanes, **kw)
            plain_ms = cuda_ms(lambda: ric.riccati_backward_plain(C, c, F, None, n, **kw), 1, 1)
            rb = variant_riccati_bound(got, B, n, m, T, clock_mhz, qp == "1" or (m == 2 and qp != "0"))
            ric_ms[(n, m, qp)] = (out["ms"], plain_ms, rb, lanes)
            record.update(kernel_ms=out["ms"], plain_ms=plain_ms, bound=rb, card=smi)
        emit(**record)
        ric_err[(n, m, mode, qp)] = max(agreement["max_abs_err"].values())

    # the fused solve: the (6, 3) MLP under both QPs (one iteration, tight;
    # every built lane count with and without the pre-pass bit-equal to one
    # lane), the 3-32-3 MLP, the pendulum with the simplified update
    mlp = slice_mlp(device)
    sp = slice_problem(SL_B, device)
    nn_err, nn_one = {}, {}
    mlp64 = mlp.to(torch.float64)
    sp64 = {k: v.double() for k, v in sp.items()}

    def head(res):  # the first SL_CPU_B scenarios of a solve
        return res._replace(**{f: getattr(res, f)[:, :SL_CPU_B] if getattr(res, f).ndim == 3 else
                               getattr(res, f)[:SL_CPU_B] for f in res._fields})

    for qp in ("", "1"):
        two = dict(lqr_iter=2, eps=EPS, pnqp_iter=8, pnqp_enum=qp)
        kern = il.ilqr_solve_fused(**sp, dyn=mlp, **two)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        plain = il.ilqr_solve_plain(**sp, dyn=mlp, **two)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        agree = witnessed_agreement(f"MLP (6, 3) pnqp_enum={qp!r}, two iterations", kern, plain,
                                    il.ilqr_solve_plain(**sp64, dyn=mlp64, **two), ties=True)
        nn_err[qp] = agree["us_max_abs"]
        k2_ms = cuda_ms(lambda: il.ilqr_solve_fused(**sp, dyn=mlp, **two), 10, 2)
        nn_one[qp] = (k2_ms, plain_s * 1e3, variant_nn_ilqr_bound(mlp, kern, SL_B, SL_T, N_ALPHA, clock_mhz, qp == "1"),
                      il.ilqr_solve_fused.last_lanes)
        env = il.kernel_env(mlp)
        staged = {}
        for hoist in (False, True):
            launch = il._cuda_launcher(device, env, hoist, qp)
            for L in il.ILQR_LANES:
                staged[(L, hoist)] = il.run_staged(launch, sp["x_init"], sp["C"], sp["c"], mlp, sp["u_lower"],
                                                   sp["u_upper"], lqr_iter=3, eps=EPS, pnqp_iter=8, lanes=L,
                                                   hoist_lin=hoist)
        bit_equal = lanes_bit_equal(f"MLP (6, 3) {qp!r} lanes", staged)
        emit(phase="variant_nn_kernel_vs_plain", hidden=list(SL_HIDDEN), n=SL_N, m=SL_M, pnqp_enum=qp, B=SL_B, T=SL_T,
             lqr_iter=2, lanes=nn_one[qp][3], **agree, kernel_ms=nn_one[qp][0], plain_ms=nn_one[qp][1],
             bound=nn_one[qp][2], card=smi, mean_qp_iters=float(kern.qp_iters.mean()),
             lanes_bit_equal_three_iterations=bit_equal)
    wide = NNDynamics.init(3, 1, hidden=(32,), residual=True, device=device,
                           generator=torch.Generator(device=device).manual_seed(5))
    wide = wide.replace(weights=wide.weights[:-1] + (wide.weights[-1] * 0.3,))
    prob = dict(problem(B_MAIN, device, steps=NN_T), dyn=wide)
    two = dict(lqr_iter=2, eps=EPS)
    prob64 = {k: v.double() if torch.is_tensor(v) else v.to(torch.float64) for k, v in prob.items()}
    agree = witnessed_agreement("MLP 3-32-3, two iterations", il.ilqr_solve_fused(**prob, **two),
                                il.ilqr_solve_plain(**prob, **two), il.ilqr_solve_plain(**prob64, **two))
    emit(phase="variant_nn_kernel_vs_plain", hidden=[32], n=3, m=1, B=B_MAIN, T=NN_T, lqr_iter=2, **agree,
         lanes=il.ilqr_solve_fused.last_lanes)
    one = dict(lqr_iter=1, eps=0.0)
    prob = problem(B_MAIN, device)
    exact = dict(value_update_exact_reg=1e-6, reg=1e-9)
    pend_err = check_tight("pendulum, simplified update, one iteration", il.ilqr_solve_fused(**prob, **one, **exact),
                           il.ilqr_solve_plain(**prob, **one, **exact))
    knobs = dict(lqr_iter=LQR_ITER, eps=EPS, **exact)
    pm = compare(il.ilqr_solve_fused(**prob, **knobs), il.ilqr_solve_plain(**prob, **knobs))
    check_chaos("pendulum, simplified update", pm)
    env = il.kernel_env(prob["dyn"])
    pend_lanes = il.ilqr_lanes(B_MAIN, env, sm_count)
    args = (prob["x_init"], prob["C"], prob["c"], prob["dyn"], prob["u_lower"], prob["u_upper"])
    stagers = {label: (il._cuda_launcher(device, env, False, exact=x),
                       lambda launch: il.run_staged(launch, *args, lqr_iter=LQR_ITER, eps=EPS, lanes=pend_lanes))
               for label, x in (("full", False), ("simplified", True))}
    pend_ms = interleaved_ms(stagers, 5, 10)
    pend_plain_ms = once_ms(lambda: il.ilqr_solve_plain(**prob, **knobs))
    pend_bound = ilqr_solve_bound(il.ilqr_solve_fused(**prob, **knobs), B_MAIN, N_ALPHA, clock_mhz)
    emit(phase="variant_pendulum_simplified_update", B=B_MAIN, T=T, one_iteration_max_abs_err=pend_err, **pm,
         kernel_ms=pend_ms, simplified_over_full=pend_ms["simplified"] / pend_ms["full"], lanes=pend_lanes,
         plain_ms=pend_plain_ms, bound=pend_bound, card=smi)

    # the KKT pair at (6, 3), and with the simplified update at (3, 1)
    kkt_err, kkt_ms = {}, {}
    for (n, m), x in (((SL_N, SL_M), False), ((3, 1), True)):
        ins = main_path_kkt_inputs(B_MAIN, device) if x else random_kkt_inputs_torch(T, SL_LIN_B, n, m, device, 3100)
        B = ins[0].shape[1]
        kw = dict(reg=1e-7, value_update_exact_reg=1e-6 if x else -1.0)
        plain = kkt.kkt_backward_plain(*ins, **kw)
        errs = {}
        for label, launcher in (("kkt", kkt._cuda_launcher), ("kkt_stream", kkt_stream._stream_launcher)):
            got = kkt.run_on_card(launcher, *ins, **kw)
            errs[label] = check_kkt(f"{label} (n={n}, m={m}) simplified={x}", got, plain)
        lanes = kkt.kkt_lanes(B, n, m, sm_count, T)  # the wrapper's pick

        def stage(launch):
            kkt.run_staged_kkt(launch, *ins, reg=1e-7, lanes=lanes)

        stagers = {label: (launcher(device, n, m, exact=x), stage)
                   for label, launcher in (("kkt", kkt._cuda_launcher), ("kkt_stream", kkt_stream._stream_launcher))}
        if x:
            stagers["kkt_full"] = (kkt._cuda_launcher(device, n, m), stage)
            stagers["kkt_stream_full"] = (kkt_stream._stream_launcher(device, n, m), stage)
        ms = interleaved_ms(stagers, 5, 10)
        plain_ms = cuda_ms(lambda: kkt.kkt_backward_plain(*ins, **kw), 1, 1)
        shared = dict(shared_C=kkt.reads_in_place(ins[0]), shared_F=kkt.reads_in_place(ins[2]))
        kb = kkt_bound(B, n, m, T, clock_mhz, **shared)
        kkt_err[(n, m)], kkt_ms[(n, m)] = errs, (ms, plain_ms, {k: kb[k] for k in ("bound_ms", "bound_by")}, lanes)
        emit(phase="variant_kkt_vs_plain", n=n, m=m, B=B, T=T, simplified_update=x, max_abs_err=errs,
             tol="1e-4 * max(1, max|plain|)", lanes=lanes, kernel_ms=ms, plain_ms=plain_ms, bound=kb,
             reads_in_place=shared, card=smi)

    # the line search at (6, 3), every built lane count bit-equal to one
    C, c, F, f, x0 = random_lqr_torch(T, SL_LIN_B, SL_N, SL_M, device, seed=3200)
    gen = torch.Generator(device=device).manual_seed(3201)
    u_hat = (torch.rand((T, SL_LIN_B, SL_M), generator=gen, device=device) - 0.5) * 0.6
    x_hat, _ = lqr_rollout(x0, F, f, torch.zeros((T, SL_LIN_B, SL_M, SL_N), device=device),
                           torch.zeros((T, SL_LIN_B, SL_M), device=device), u_hat=u_hat)
    lo, hi = torch.tensor(-BOX, device=device), torch.tensor(BOX, device=device)
    res = ric.riccati_backward_cuda(C, c + bmv(C, torch.cat([x_hat, u_hat], -1)), F, None, SL_N, u_lower=lo,
                                    u_upper=hi, u_hat=u_hat)
    scale = 0.5 + 7.5 * torch.rand((1, SL_LIN_B, 1), generator=gen, device=device)
    ls_args = (x0, C, c, F, f, res.K, res.k * scale, x_hat, u_hat)
    got = rol.linesearch_rollout_cuda(*ls_args, u_lower=lo, u_upper=hi)
    rol_lanes = rol.linesearch_rollout_cuda.last_lanes
    plain = rol.linesearch_rollout_plain(*ls_args, u_lower=lo, u_upper=hi)
    rol_agree = line_search_agreement("rollout (6, 3) vs plain", got, plain, hold=False)
    # n = 6 states grow to hundreds over 20 steps, where 1e-4 is an ulp or
    # two of float32: the trajectory is held to the float64 plain version's,
    # the kernel no further from it than twice the float32 plain version
    # (phase 22's witness), and 1e-4
    exact = rol.linesearch_rollout_plain(*(None if a is None else a.double() for a in ls_args), u_lower=lo.double(),
                                         u_upper=hi.double())
    same = (got.alpha == plain.alpha) & (plain.alpha.double() == exact.alpha)

    def traj_err(r):
        return max(float((r.xs.double() - exact.xs)[:, same].abs().max()), float((r.us.double() - exact.us)[:, same].abs().max()))

    rol_agree.update(kernel_traj_off_float64=traj_err(got), plain_traj_off_float64=traj_err(plain),
                     traj_scale=float(exact.xs.abs().max()), alpha_equal_float64_frac=float(same.float().mean()))
    if rol_agree["objs_max_rel"] > 1e-5 or rol_agree["alpha_equal_frac"] < 0.99 \
            or rol_agree["kernel_traj_off_float64"] > 2 * rol_agree["plain_traj_off_float64"] + 1e-4:
        raise AssertionError(f"rollout (6, 3) vs plain: {rol_agree}")
    launch = rol._cuda_launcher(device, SL_N, SL_M, None)
    bit_equal = lanes_bit_equal("rollout (6, 3) lanes", {L: rol.run_staged_rollout(launch, *ls_args, u_lower=lo, u_upper=hi,
                                                                                   lanes=L) for L in rol.ROLLOUT_LANES})
    rol_out = {}
    rres = rol.run_staged_rollout(timed_launch(launch, 20, rol_out), *ls_args, u_lower=lo, u_upper=hi, lanes=rol_lanes)
    rol_plain_ms = cuda_ms(lambda: rol.linesearch_rollout_plain(*ls_args, u_lower=lo, u_upper=hi), 1, 1)
    rol_b = rollout_bound(rres, SL_LIN_B, SL_N, SL_M, T, clock_mhz)
    emit(phase="variant_rollout_vs_plain", n=SL_N, m=SL_M, B=SL_LIN_B, T=T, lanes=rol_lanes, lanes_bit_equal=bit_equal,
         kernel_ms=rol_out["ms"], plain_ms=rol_plain_ms, bound=rol_b, card=smi, **rol_agree)
    emit(phase="variants_vs_plain_seconds", seconds=time.perf_counter() - t0)

    # ---- 32. the slice's MLP through mpc_solve at full width ----
    t0 = time.perf_counter()
    config = MPCConfig(n_state=SL_N, n_ctrl=SL_M, T=SL_T, lqr_iter=SL_ITER, pnqp_iter=8, exit_unconverged=False,
                       detach_unconverged=False)
    cost = QuadCost(sp["C"], sp["c"])
    nn_path, nn_times = {}, {}
    for qp in ("", "1"):
        cfg = dataclasses.replace(config, pnqp_enum=qp)
        with torch.no_grad():
            reset_counts()
            sol = mpc_solve(cfg, sp["x_init"], cost, mlp, u_lower=-SL_BOX, u_upper=SL_BOX)
            launches = counts()
            if launches != only(ilqr=1):
                raise AssertionError(f"the (6, 3) MLP's mpc_solve ({qp!r}) launched {launches}")
            solve_ms = cuda_ms(lambda: mpc_solve(cfg, sp["x_init"], cost, mlp, u_lower=-SL_BOX, u_upper=SL_BOX), 5, 2)
        knobs = dict(lqr_iter=SL_ITER, pnqp_iter=8, pnqp_enum=qp)
        kern = il.ilqr_solve_fused(**sp, dyn=mlp, **knobs)
        lanes = il.ilqr_solve_fused.last_lanes
        k_ms = cuda_ms(lambda: il.ilqr_solve_fused(**sp, dyn=mlp, **knobs), 5, 2)
        held = {}
        if qp == "1":
            # the new QP's solve held against the plain solve of its first
            # scenarios on the host (each scenario's solve is its own; the
            # plain solve's cost is its ops' count, whatever the batch, so
            # the loop, held at two iterations in phase 31 and by the host
            # build, is not held again here). After ten iterations ~90% of
            # the scenarios are still unconverged (objectives in the
            # thousands), and float32 rounding alone moves ~1 in 4 of them
            # off the float64 solve: phase 22's rule by its counts, the
            # float64 plain solve as the witness
            cut = {k: v[:, :SL_CPU_B].cpu() if v.ndim > 2 else v[:SL_CPU_B].cpu() for k, v in sp.items()}
            t1 = time.perf_counter()
            plain = il.ilqr_solve_plain(**cut, dyn=mlp.to(device="cpu"), **knobs)
            held["plain_host_seconds"] = time.perf_counter() - t1
            exact = il.ilqr_solve_plain(**{k: v.double() for k, v in cut.items()}, dyn=mlp.to(torch.float64, "cpu"),
                                        **knobs)
            held["vs_plain"] = dict(first_scenarios=SL_CPU_B, **witnessed_agreement(
                f"the (6, 3) MLP, pnqp_enum={qp!r}, card vs plain", head(kern), plain, exact, ties=True,
                calm_limits=False))
        nb = variant_nn_ilqr_bound(mlp, kern, SL_B, SL_T, N_ALPHA, clock_mhz, qp == "1")
        nn_path[qp], nn_times[qp] = launches, k_ms
        emit(phase="slice_mlp_main_path", pnqp_enum=qp, B=SL_B, T=SL_T, lqr_iter=SL_ITER, launches=launches,
             converged_frac=float(sol.info.converged.float().mean()), mean_obj=float(sol.objs.mean()),
             max_n_iters=int(sol.info.n_iters), mean_qp_iters=float(sol.info.qp_iters.mean()),
             clamp_frac=float(sol.info.clamp_frac.mean()), mpc_solve_ms=solve_ms, kernel_ms=k_ms, lanes=lanes,
             bound=nb, card=smi, **held)
    emit(phase="slice_mlp_enum_over_loop", kernel=nn_times["1"] / nn_times[""])

    # its gradient: an imitation loss over every weight and bias (the expert:
    # the same MLP with its last layer scaled by 1.1) through one KKT launch
    # at (6, 3), against the same gradient at the card's fixed point on the host
    cfg = dataclasses.replace(config, pnqp_enum="1")
    expert = mlp.replace(weights=mlp.weights[:-1] + (mlp.weights[-1] * 1.1,))
    with torch.no_grad():
        u_expert = mpc_solve(cfg, sp["x_init"], cost, expert, u_lower=-SL_BOX, u_upper=SL_BOX).us
    leaves = [a.clone().requires_grad_(True) for a in mlp.weights + mlp.biases]
    k = len(mlp.weights)

    def with_leaves(ls):
        return mlp.replace(weights=tuple(ls[:k]), biases=tuple(ls[k:]))

    reset_counts()
    gsol = mpc_solve(cfg, sp["x_init"], cost, with_leaves(leaves), u_lower=-SL_BOX, u_upper=SL_BOX)
    g_card = torch.autograd.grad(((gsol.us - u_expert) ** 2).mean(), leaves)
    grad_launches = counts()
    if grad_launches != only(ilqr=1, kkt=1):
        raise AssertionError(f"the (6, 3) MLP's solve + gradient launched {grad_launches}")
    grad_ms = cuda_ms(lambda: torch.autograd.grad(((mpc_solve(cfg, sp["x_init"], cost, with_leaves(leaves),
                                                              u_lower=-SL_BOX, u_upper=SL_BOX).us - u_expert) ** 2).mean(),
                                                  leaves), 3, 2)
    spec = LqrSpec(n_state=SL_N, constrained=True, tight_eps=cfg.tight_eps, back_eps=cfg.back_eps, use_cuda=False)

    def host_grads(dtype):
        """The same gradient on the host at the card's fixed point, in ``dtype``."""
        ls = [a.detach().to("cpu", dtype).requires_grad_(True) for a in leaves]
        xs, us = gsol.xs.detach().to("cpu", dtype), gsol.us.detach().to("cpu", dtype)
        F, f = linearize_dynamics(with_leaves(ls), xs, us)
        _, us2 = lqr_fixed_point(spec, *(sp[k].to("cpu", dtype) for k in ("x_init", "C", "c")), F, f, xs, us,
                                 torch.full_like(us, -SL_BOX), torch.full_like(us, SL_BOX))
        return torch.autograd.grad(((us2 - u_expert.to("cpu", dtype)) ** 2).mean(), ls)

    # each leaf's gradient within 1e-3 of its max-abs of the float64 one, or
    # no further from it than twice the host's float32 gradient: the output
    # bias's sums cancel over 20,480 samples, and float32 alone moves them
    g64 = host_grads(torch.float64)
    g_rel = [float((a.cpu().double() - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(g_card, g64)]
    g_rel32 = [float((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(host_grads(torch.float32), g64)]
    emit(phase="slice_mlp_gradient", pnqp_enum="1", B=SL_B, T=SL_T, launches=grad_launches,
         rel_err_vs_float64_at_the_fixed_point=g_rel, host_float32_rel_err_vs_float64=g_rel32,
         grad_max_abs=[float(g.abs().max()) for g in g_card], solve_plus_grad_ms=grad_ms, card=smi)
    if not all(bool(torch.isfinite(g).all()) for g in g_card) \
            or any(r > max(1e-3, 2 * r32) for r, r32 in zip(g_rel, g_rel32)):
        raise AssertionError(f"the (6, 3) MLP's weight gradients against float64: {g_rel}, host float32 {g_rel32}")
    emit(phase="slice_mlp_seconds", seconds=time.perf_counter() - t0)

    # ---- 33. the (6, 3) LinDx box-DDP at B=4096 ----
    t0 = time.perf_counter()
    lin_path, lin_searches = {}, {}
    for qp in ("", "1"):
        cfg = MPCConfig(n_state=SL_N, n_ctrl=SL_M, T=T, lqr_iter=10, exit_unconverged=False, detach_unconverged=False,
                        pnqp_enum=qp)
        arrays = config2_recipe(33, SL_LIN_B, SL_N, SL_M)

        def solve(dev, grad=False, B=SL_LIN_B):
            leaves = [torch.tensor(a[:, :B] if a.ndim > 2 else a[:B], device=dev, requires_grad=grad) for a in arrays]
            C, c, F, f, x0 = leaves
            return leaves, mpc_solve(cfg, x0, QuadCost(C, c), LinDx(F, f), u_lower=-BOX, u_upper=BOX)

        reset_counts()
        with recording("diffmpc_tpu_torch.ops.lqr", "linesearch_rollout_cuda", lin_searches.setdefault(qp, [])):
            leaves, sol = solve(device, grad=True)
        weights = [torch.ones_like(sol.xs), torch.ones_like(sol.us)]
        grads = torch.autograd.grad((sol.xs * weights[0]).sum() + (sol.us * weights[1]).sum(), leaves)
        got = counts()
        it = int(sol.info.n_iters)
        lin_path[qp] = got
        if got != only(riccati=it, rollout=it, kkt=1) or not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"(6, 3) LinDx {qp!r}: launches {got} for {it} iterations")
        with torch.no_grad():
            ms = cuda_ms(lambda: solve(device), 3, 2)
        # the first scenarios against the host's solve and the float64 optimum
        _, cpu = solve("cpu", B=SL_CPU_B)
        head_us, head_objs = sol.us[:, :SL_CPU_B].detach().cpu(), sol.objs[:SL_CPU_B].detach().cpu()
        us_diff = (head_us - cpu.us.detach()).abs().amax(dim=(0, 2))
        agree = us_diff <= 1e-4
        obj_rel = float(((head_objs - cpu.objs.detach()).abs() / cpu.objs.detach().abs().clamp_min(1.0)).max())
        objective, u_opt, opt_pg = box_lqr_optimum(*(torch.tensor(a[:, :SL_CPU_B] if a.ndim > 2 else a[:SL_CPU_B])
                                                     for a in arrays), float(np.float32(-BOX)), float(np.float32(BOX)))
        j_opt = objective(u_opt)
        gap = (objective(head_us) - j_opt) / j_opt.abs().clamp_min(1.0)
        # ten iterations leave some scenarios unconverged, where one rounding
        # can set two solves on other paths: the objectives and the optimum
        # are held on the scenarios converged on both sides
        done = sol.info.converged[:SL_CPU_B].cpu() & cpu.info.converged
        obj_rel_done = float(((head_objs - cpu.objs.detach()).abs() / cpu.objs.detach().abs().clamp_min(1.0))[done].max())
        gap_done = float(gap[done].max())
        record = dict(pnqp_enum=qp, B=SL_LIN_B, T=T, n=SL_N, m=SL_M, n_iters=it, launches=got, mpc_solve_ms=ms,
                      converged_frac=float(sol.info.converged.float().mean()), mean_obj=float(sol.objs.mean()),
                      mean_qp_iters=float(sol.info.qp_iters.mean()), clamp_frac=float(sol.info.clamp_frac.mean()),
                      card_vs_host_objs_max_rel=obj_rel, card_vs_host_objs_max_rel_converged=obj_rel_done,
                      us_agree_frac=float(agree.float().mean()), card_vs_host_us_max_abs=float(us_diff.max()),
                      optimum_projected_grad=opt_pg, optimum_rel_gap_max=float(gap.max()),
                      converged_of_held=int(done.sum()), optimum_rel_gap_max_converged=gap_done, card=smi)
        emit(phase="slice_lindx_main_path", **record)
        if qp == "":  # the line search is the same kernel under either QP
            with torch.no_grad():
                emit(phase="slice_lindx_nothing_improves", B=SL_LIN_B, T=T, calls=len(lin_searches[qp]), card=smi,
                     **nothing_improves_case("(6, 3) LinDx", device, lin_searches[qp][-1], rol.linesearch_rollout_cuda))
        # written so that a NaN fails
        if not (obj_rel_done <= 1e-5 and float(agree.float().mean()) >= 0.95 and int(done.sum()) >= SL_CPU_B // 2
                and opt_pg <= 1e-6 and (qp != "1" or gap_done <= 1e-5)):
            raise AssertionError(f"(6, 3) LinDx {qp!r}, card vs host and the optimum: {record}")
        del leaves, sol, grads

    # the launches of the simplified update's kernels and the (4, 2) "0" sweep
    # on their paths: the flagship solve + gradient, the pendulum at T=512
    # (the KKT twin), config 2 at B=128 under "0"
    pend_cfg = MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=LQR_ITER, eps=EPS, exit_unconverged=False,
                         detach_unconverged=False, value_update_exact_reg=1e-6)
    reset_counts()
    flagship_grads(pend_cfg, B_MAIN, device)
    exact_launches = counts()
    long_cfg = dataclasses.replace(pend_cfg, T=T_PEND)
    reset_counts()
    pend = problem(SL_CPU_B, device, steps=T_PEND)
    x = pend["x_init"].clone().requires_grad_(True)
    s = mpc_solve(long_cfg, x, QuadCost(pend["C"][0, 0], pend["c"][0, 0]), pend["dyn"], u_lower=-2.0, u_upper=2.0)
    torch.autograd.grad((s.us**2).mean(), x)
    exact_long_launches = counts()
    loop_cfg = MPCConfig(n_state=BOX_N, n_ctrl=BOX_M, T=T, lqr_iter=10, exit_unconverged=False,
                         detach_unconverged=False, pnqp_enum="0")
    C, c, F, f, x0 = random_lqr_torch(T, BOX_B, BOX_N, BOX_M, device, seed=34)
    reset_counts()
    with torch.no_grad():
        lsol = mpc_solve(loop_cfg, x0, QuadCost(C, c), LinDx(F, f), u_lower=-BOX, u_upper=BOX)
    loop_launches = counts()
    emit(phase="slice_flag_paths", simplified_update_flagship=exact_launches,
         simplified_update_pendulum_T512=exact_long_launches, config2_pnqp_enum_0=loop_launches,
         config2_pnqp_enum_0_mean_qp_iters=float(lsol.info.qp_iters.mean()))
    if exact_launches != only(ilqr=1, kkt=1) or exact_long_launches != only(ilqr=1, kkt_stream=1) \
            or loop_launches["riccati"] != int(lsol.info.n_iters) or float(lsol.info.qp_iters.max()) <= 1.0:
        raise AssertionError(f"the flags' paths: {exact_launches}, {exact_long_launches}, {loop_launches}")
    emit(phase="slice_lindx_seconds", seconds=time.perf_counter() - t0)

    src = "diffmpc_tpu_torch/csrc/variants/"
    keep = ("bound_ms", "bound_by")
    rows = []
    for qp in ("", "1"):  # two iterations, kernel and plain version on the same inputs
        k_ms, plain_ms, nb, lanes = nn_one[qp]
        rows.append(dict(name=f"ilqr_solve_fused[NNDynamics 6-16-16-6, pnqp_enum={qp!r}]", route="cuda",
                         source=src + "ilqr.cu", replaces="diffmpc_tpu/ops/pallas/ilqr.py:458",
                         launches=nn_path[qp]["ilqr"], max_abs_err=nn_err[qp], ms=k_ms, plain_ms=plain_ms,
                         **{k: nb[k] for k in keep}, library_ms=None, lanes=lanes, lqr_iter=2))
    rows.append(dict(name="ilqr_solve_fused[pendulum, value_update_exact_reg=1e-6]", route="cuda", source=src + "ilqr.cu",
                     replaces="diffmpc_tpu/ops/pallas/ilqr.py:114", launches=exact_launches["ilqr"], max_abs_err=pend_err,
                     ms=pend_ms["simplified"], plain_ms=pend_plain_ms, **{k: pend_bound[k] for k in keep},
                     library_ms=None, lanes=pend_lanes))
    for (n, m, qp), enum_row in (((SL_N, SL_M, ""), "riccati_backward_pallas[(6, 3) box, pnqp_enum='']"),
                                 ((SL_N, SL_M, "1"), "riccati_backward_pallas[(6, 3) box, pnqp_enum='1']"),
                                 ((BOX_N, BOX_M, "0"), "riccati_backward_pallas[(4, 2) box, pnqp_enum='0']")):
        ms_, plain_ms, rb, lanes_ = ric_ms[(n, m, qp)]
        launched = lin_path[qp]["riccati"] if n == SL_N else loop_launches["riccati"]
        rows.append(dict(name=enum_row, route="cuda", source=src + "riccati.cu",
                         replaces="diffmpc_tpu/ops/pallas/riccati.py:696", launches=launched,
                         max_abs_err=ric_err[(n, m, "box", qp)], ms=ms_, plain_ms=plain_ms,
                         **{k: rb[k] for k in keep}, library_ms=None, lanes=lanes_))
    rows.append(dict(name="linesearch_rollout_pallas[(6, 3)]", route="cuda", source=src + "rollout.cu",
                     replaces="diffmpc_tpu/ops/pallas/rollout.py:180", launches=lin_path["1"]["rollout"],
                     max_abs_err=rol_agree["traj_max_abs_where_alpha_agrees"], ms=rol_out["ms"], plain_ms=rol_plain_ms,
                     **{k: rol_b[k] for k in keep}, library_ms=None, lanes=rol_lanes))
    ms6, plain6, kb6, lanes6 = kkt_ms[(SL_N, SL_M)]
    rows.append(dict(name="kkt_backward_fused[(6, 3)]", route="cuda", source=src + "kkt.cu",
                     replaces="diffmpc_tpu/ops/pallas/kkt.py:245", launches=lin_path["1"]["kkt"],
                     max_abs_err=kkt_err[(SL_N, SL_M)]["kkt"], ms=ms6["kkt"], plain_ms=plain6,
                     **kb6, library_ms=None, lanes=lanes6))
    ms3, plain3, kb3, lanes3 = kkt_ms[(3, 1)]
    rows.append(dict(name="kkt_backward_fused[value_update_exact_reg=1e-6]", route="cuda", source=src + "kkt.cu",
                     replaces="diffmpc_tpu/ops/pallas/kkt.py:103", launches=exact_launches["kkt"],
                     max_abs_err=kkt_err[(3, 1)]["kkt"], ms=ms3["kkt"], plain_ms=plain3,
                     **kb3, library_ms=None, lanes=lanes3))
    rows.append(dict(name="kkt_backward_fused_stream[value_update_exact_reg=1e-6]", route="cuda", source=src + "kkt.cu",
                     replaces="diffmpc_tpu/ops/pallas/kkt_stream.py:203", launches=exact_long_launches["kkt_stream"],
                     max_abs_err=kkt_err[(3, 1)]["kkt_stream"], ms=ms3["kkt_stream"], plain_ms=plain3,
                     **kb3, library_ms=None, lanes=lanes3))
    return rows


# ---------------------------------------------------------------------------
# Phases 35-36: the dynamics zoo (CartpoleDx, VehicleDx, QuadrotorDx,
# AcrobotDx), each env's own C++ step (csrc/<env>.cuh) in the fused iLQR
# kernel, the line search and its twin, built as variants at first use;
# BASELINE.json config 4's cartpole imitation step at B=4096.
# ---------------------------------------------------------------------------

ZOO_ENVS = ("cartpole", "vehicle", "quadrotor", "acrobot")
# BASELINE.json config 4 (examples/il_cartpole.py:52-99): T=20, lqr_iter=10,
# eps=1e-5, u in [-10, 10], B=4096, Adam 2e-2 on {"dyn", "logq"}
IL4_B, IL4_STEPS, IL4_LR = 4096, 5, 2e-2
# each step's spans, timed in place (timed_spans): the forward solve, the
# attach's linearization and the KKT wrapper
IL4_SPANS = {"ilqr": ("diffmpc_tpu_torch.mpc", "ilqr_solve_fused"),
             "linearize": ("diffmpc_tpu_torch.mpc", "linearize"),
             "kkt": ("diffmpc_tpu_torch.ops.library", "kkt_backward_fused")}
ZOO_KERNEL_B = 256  # each fused kernel against its plain version
ZOO_CPU_B = 64  # the scenarios held against the host
ZOO_LS_B = 1024  # the line search's batch, at T=20 and (cartpole) T_LONG
# each step's operations and dependent chain, counted from csrc/<env>.cuh
# (its header writes the count out; a sine or a cosine counted as one): the
# operations on values, the sines and cosines, and the longest chain of
# dependent ones from x_t to x_t+1; the pendulum's (csrc/pendulum.cuh, its
# sines, cosines and square root) beside them for phases 37 and 41
ZOO_STEP = {"cartpole": (40, 2, 14), "vehicle": (15, 4, 12), "quadrotor": (22, 2, 8), "acrobot": (106, 4, 17),
            "pendulum": (25, 3, 14)}


def zoo_variant_keys() -> list:
    """Every variant the zoo's phases launch: each env's fused solve and line
    search (its C++ step, csrc/<env>.cuh), and the Riccati sweep and KKT
    backward at the cartpole's (5, 1), the quadrotor's (6, 2) and the
    acrobot's (6, 1) (the vehicle's (4, 2) is prebuilt)."""
    from diffmpc_tpu_torch.csrc.build import VariantKey as K
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    keys = []
    for name in ZOO_ENVS:
        env = il.kernel_env(zoo_model(name, "cpu"))
        keys += [il.env_variant_key(env, "ilqr"), il.env_variant_key(env, "rollout")]
    return keys + [K(family, n, m) for n, m in ((5, 1), (6, 2), (6, 1)) for family in ("riccati", "kkt")]


def zoo_model(name: str, device, dtype=torch.float32):
    """The env ``name`` with its default (true) params."""
    from diffmpc_tpu_torch import models

    return getattr(models, f"{name.capitalize()}Dx").default(dtype, device=device)


def zoo_case(name: str, device, B: int = 0, seed: int = 0) -> dict:
    """The env's example (diffmpc_tpu_torch/examples/il_<name>.py, its
    ``build``) at ``B`` scenarios (its published width, the example's
    default, by default) drawn from ``seed``: the true model ``dx`` and its
    cost, the starts, the box (the vehicle's per dimension, the quadrotor's
    [0, max_thrust]), the config (T, lqr_iter, eps=1e-5,
    detach_unconverged), the learner's first params and
    ``make_problem(params) -> (cost, dx)``."""
    ex = importlib.import_module(f"diffmpc_tpu_torch.examples.il_{name}")
    return ex.build(ex.parse_args(["--seed", str(seed)] + (["--batch", str(B)] if B else [])), device)


def zoo_kernel_inputs(case: dict, steps: int) -> dict:
    """The fused solve's inputs of a zoo case: C, c expanded over the horizon
    and the batch, the bounds as (T, B, m)."""
    x0 = case["x_init"]
    B, device = x0.shape[0], x0.device
    C, c = case["cost"].C, case["cost"].c
    nm = C.shape[-1]
    m = case["dx"].n_ctrl
    box = [torch.as_tensor(b, dtype=torch.float32, device=device).expand(steps, B, m).contiguous()
           for b in (case["lo"], case["hi"])]
    return dict(x_init=x0, C=C.expand(steps, B, nm, nm), c=c.expand(steps, B, nm), dyn=case["dx"],
                u_lower=box[0], u_upper=box[1])


def zoo_step_ops(name: str, tangents: int = 0) -> int:
    """Operations of one env step on a scalar carrying ``tangents`` dual parts
    (each operation repeated on every tangent: a floor)."""
    ops, trans, _ = ZOO_STEP[name]
    return (1 + tangents) * (ops + trans)


def zoo_ilqr_bound(name: str, res, B: int, steps: int, n_alpha: int, clock_mhz: float) -> dict:
    """env_ilqr_bound with the env's own step and shared params."""
    dx = zoo_model(name, "cpu")
    n, m = dx.n_state, dx.n_ctrl
    return env_ilqr_bound(n, m, zoo_step_ops(name), zoo_step_ops(name, tangents=n + m), ZOO_STEP[name][2],
                          dx.params.shape[-1], res, B, steps, n_alpha, clock_mhz)


def zoo_rollout_bound(name: str, res, B: int, steps: int, clock_mhz: float) -> dict:
    """env_rollout_bound with the env's own step."""
    dx = zoo_model(name, "cpu")
    return env_rollout_bound(dx.n_state, dx.n_ctrl, zoo_step_ops(name), ZOO_STEP[name][2], dx.params.shape[-1], res,
                             B, steps, clock_mhz)


def zoo_host_grads(case: dict, leaves: list, rebuild, sol, u_expert, cut: int, dtype) -> list:
    """The imitation loss's gradient over the first ``cut`` scenarios on the
    host, in ``dtype``, at the card's fixed point ``sol``: the model
    linearized at the card's trajectory with gradients from ``leaves``
    (``rebuild(leaves)`` gives the learnable params), the float64 KKT
    backward of lqr_fixed_point, the unconverged scenarios held at the
    card's solve (detach_unconverged)."""
    from diffmpc_tpu_torch.mpc import _expand_bound, _expand_cost
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics
    from diffmpc_tpu_torch.ops.lqr_step import LqrSpec, lqr_fixed_point

    config = case["config"]
    steps, n, m = config.T, config.n_state, config.n_ctrl
    ls = [a.detach().to("cpu", dtype).requires_grad_(True) for a in leaves]
    cost, dx = case["make_problem"](rebuild(ls))
    cost = _expand_cost(cost, steps, cut, dtype, "cpu")
    xs = sol.xs.detach()[:, :cut].to("cpu", dtype)
    us = sol.us.detach()[:, :cut].to("cpu", dtype)
    F, f = linearize_dynamics(dx, xs, us)
    lo = _expand_bound(torch.as_tensor(case["lo"]).cpu(), steps, cut, m, dtype, "cpu")
    hi = _expand_bound(torch.as_tensor(case["hi"]).cpu(), steps, cut, m, dtype, "cpu")
    spec = LqrSpec(n_state=n, constrained=True, tight_eps=config.tight_eps, back_eps=config.back_eps, use_cuda=False)
    _, us2 = lqr_fixed_point(spec, case["x_init"][:cut].to("cpu", dtype), cost.C, cost.c, F, f, xs, us, lo, hi)
    keep = sol.info.converged[:cut].cpu()[None, :, None]
    us2 = torch.where(keep, us2, us)
    return list(torch.autograd.grad(((us2 - u_expert[:, :cut].to("cpu", dtype)) ** 2).mean(), ls))


def zoo_gradient_check(name: str, case: dict, leaves: list, rebuild, u_expert, counter) -> dict:
    """The imitation loss over the first ZOO_CPU_B scenarios through
    mpc_solve on the card at the learner's params, its gradient by one iLQR
    and one KKT launch (``counter``: the launch counts' reset and read),
    against
    the host's float64 gradient at the card's fixed point: each leaf within
    1e-3 of its max-abs, or no further than twice the host's float32
    gradient (phase 32's rule). Returns the record."""
    from diffmpc_tpu_torch import mpc_solve

    config = case["config"]
    reset, count = counter
    ls = [a.detach().clone().requires_grad_(True) for a in leaves]
    reset()
    cost, dx = case["make_problem"](rebuild(ls))
    sol = mpc_solve(config, case["x_init"], cost, dx, u_lower=case["lo"], u_upper=case["hi"])
    g_card = torch.autograd.grad(((sol.us[:, :ZOO_CPU_B] - u_expert[:, :ZOO_CPU_B]) ** 2).mean(), ls)
    launches = count()
    g64 = zoo_host_grads(case, ls, rebuild, sol, u_expert, ZOO_CPU_B, torch.float64)
    g32 = zoo_host_grads(case, ls, rebuild, sol, u_expert, ZOO_CPU_B, torch.float32)
    rel = [float((a.cpu().double() - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(g_card, g64)]
    rel32 = [float((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(g32, g64)]
    out = dict(launches=launches, first_scenarios=ZOO_CPU_B, rel_err_vs_float64_at_the_fixed_point=rel,
               host_float32_rel_err_vs_float64=rel32, grad_max_abs=[float(g.abs().max()) for g in g_card],
               converged_of_held=int(sol.info.converged[:ZOO_CPU_B].sum()))
    if not all(bool(torch.isfinite(g).all()) for g in g_card) or any(r > max(1e-3, 2 * r32) for r, r32 in zip(rel, rel32)):
        raise AssertionError(f"{name}: the gradient against the host's float64 one: {out}")
    return out


def zoo_line_search_inputs(name: str, B: int, steps: int, seed: int, device):
    """rollout_inputs' recipe with the env's own step: a trajectory of random
    controls inside the box through its forward, the box sweep's gains about
    its linearization, the feedforward scaled by up to 8 so that the ladder
    backs off."""
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics
    from diffmpc_tpu_torch.utils.batch import bmv

    case = zoo_case(name, device, B, seed)
    ins = zoo_kernel_inputs(case, steps)
    dyn, lo, hi = ins["dyn"], ins["u_lower"], ins["u_upper"]
    gen = torch.Generator(device=device).manual_seed(seed)
    u_hat = lo + (hi - lo) * torch.rand(lo.shape, generator=gen, device=device)
    xs, x = [], ins["x_init"]
    for t in range(steps):
        xs.append(x)
        x = dyn.forward(x, u_hat[t])
    x_hat = torch.stack(xs)
    F, _ = linearize_dynamics(dyn, x_hat, u_hat)
    C, c = ins["C"], ins["c"]
    res = ric.riccati_backward_cuda(C, c + bmv(C, torch.cat([x_hat, u_hat], -1)), F, None, dyn.n_state,
                                    u_lower=lo, u_upper=hi, u_hat=u_hat)
    scale = 0.5 + 7.5 * torch.rand((1, B, 1), generator=gen, device=device)
    return (ins["x_init"], C, c, None, None, res.K, res.k * scale, x_hat, u_hat), dict(u_lower=lo, u_upper=hi, dyn=dyn)


def zoo_line_search_check(name: str, got, plain, exact) -> dict:
    """Phase 10's rule with the float64 plain version as the witness of the
    trajectory (the states of an unstable env grow over the horizon): objs
    within 1e-5 of the batch's largest, alpha equal on >= 99%, and where the
    float32 sides' alpha and the float64 one agree, the kernel's trajectory
    no further from the float64 one than twice the float32 plain version's,
    plus 1e-4."""
    out = line_search_agreement(f"{name} line search vs plain", got, plain, hold=False)
    same = (got.alpha == plain.alpha) & (plain.alpha.double() == exact.alpha)

    def traj_err(r):
        return max(float((r.xs.double() - exact.xs)[:, same].abs().max()),
                   float((r.us.double() - exact.us)[:, same].abs().max()))

    out.update(kernel_traj_off_float64=traj_err(got), plain_traj_off_float64=traj_err(plain),
               traj_scale=float(exact.xs.abs().max()), alpha_equal_float64_frac=float(same.float().mean()))
    if out["objs_max_rel"] > 1e-5 or out["alpha_equal_frac"] < 0.99 \
            or out["kernel_traj_off_float64"] > 2 * out["plain_traj_off_float64"] + 1e-4:
        raise AssertionError(f"{name} line search vs plain: {out}")
    return out


def nothing_improves_case(name: str, device, call, runner) -> dict:
    """The line search of a converged solve's last call (``call``: its
    recorded args and kwargs) with its cost set to zero, so that every
    candidate ties the baseline and none improves on any scenario: under the
    rolled ladder and the unrolled one, the kernel of the wrapper ``runner``
    at its lane rule against the plain version by phase 10's rule,
    alpha_floor everywhere, every cost 0,
    the trajectory no further from the float64 plain version's than twice
    the float32 plain version, plus 1e-4 (zoo_line_search_check's witness),
    and every built lane count of the kernel and its twin bit-equal to one
    lane. Returns the record; raises otherwise."""
    from diffmpc_tpu_torch.ops.cuda import rollout as rol
    from diffmpc_tpu_torch.ops.cuda import rollout_stream

    args, kw = call
    args = (args[0], torch.zeros_like(args[1]), torch.zeros_like(args[2])) + tuple(args[3:])
    kw = {k: v for k, v in kw.items() if k != "use_cuda"}
    dyn = kw.get("dyn")
    n, m = args[0].shape[-1], args[6].shape[-1]
    out = {}
    # the wrapper's launch at its lane rule; the twin's wrapper takes no
    # unroll, so its launcher runs through the wrapper's own run_on_card
    launcher = rollout_stream._stream_launcher if runner is rollout_stream.linesearch_rollout_stream_cuda \
        else rol._cuda_launcher
    for unroll in (False, True):
        knobs = dict(kw, unroll=unroll)
        got = rol.run_on_card(launcher, *args, **knobs)
        lanes = runner.last_lanes
        plain = rol.linesearch_rollout_plain(*args, **knobs)
        wide = {k: v.double() if torch.is_tensor(v) else v for k, v in knobs.items() if k != "dyn"}
        exact = rol.linesearch_rollout_plain(*(None if a is None else a.double() for a in args), **wide,
                                             dyn=None if dyn is None else dyn.to(torch.float64))
        label = f"{name} nothing improving, unroll={unroll}"
        # phase 10's rule; every side picks alpha_floor (the float64 one
        # rounded once less), so the float64 witness holds every scenario
        agree = line_search_agreement(label, got, plain, hold=False)

        def traj_err(r):
            return max(float((r.xs.double() - exact.xs).abs().max()), float((r.us.double() - exact.us).abs().max()))

        agree.update(kernel_traj_off_float64=traj_err(got), plain_traj_off_float64=traj_err(plain),
                     traj_scale=float(exact.xs.abs().max()))
        if bool(got.improved.any()) or bool(plain.improved.any()) or bool(exact.improved.any()) \
                or not bool((got.alpha == plain.alpha).all()) or bool(got.objs.any()) \
                or agree["kernel_traj_off_float64"] > 2 * agree["plain_traj_off_float64"] + 1e-4:
            raise AssertionError(f"{label}: {agree}")
        by_lanes = {}
        for kind, launcher in (("rollout", rol._cuda_launcher), ("rollout_stream", rollout_stream._stream_launcher)):
            launch = launcher(device, n, m, dyn)
            for L in rol.ROLLOUT_LANES:
                by_lanes[(kind, L)] = rol.run_staged_rollout(launch, *args, lanes=L, **knobs)
        out["unrolled" if unroll else "rolled"] = dict(lanes=lanes, lanes_bit_equal=lanes_bit_equal(label, by_lanes),
                                                       **agree)
    return out


def riccati_twin_case(name: str, device, call, clock_mhz: float) -> dict:
    """The Riccati twin on the first sweep a long-horizon solve recorded
    (``call``: the args and kwargs the dispatch gave
    riccati_backward_stream_cuda): the wrapper against the plain version by
    phase 9's rule (tie entries capped at 1%, each first tie held by its QP
    objective, the float64 plain sweep as the witness), every built lane
    count (one lane staged and not) bit-equal to one lane; the kernel alone,
    the wrapper and the plain version timed, the bound (riccati_bound, box
    mode). Returns the record."""
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.ops.cuda import riccati_stream as rs

    args, kw = call
    kw = {k: v for k, v in kw.items() if k != "use_cuda"}
    C, n = args[0], args[4]
    steps, B, m = C.shape[0], C.shape[1], C.shape[-1] - n
    got = rs.riccati_backward_stream_cuda(*args, **kw)
    lanes = rs.riccati_backward_stream_cuda.last_lanes
    want, Quu, qu = ric.riccati_backward_plain(*args, return_qp=True, **kw)
    exact = ric.riccati_backward_plain(*(a.double() if torch.is_tensor(a) else a for a in args), return_qp=True,
                                       **{k: v.double() if torch.is_tensor(v) else v for k, v in kw.items()})
    # a solve's recorded sweep of the slewed vehicle at T=128 holds flat box
    # QPs whose m = 2 candidates tie on 0.18% of the entries (707 tie steps
    # on an NVIDIA H100 80GB HBM3, every first one within 9.2e-8 of the
    # plain version's QP objective): the share is capped at 1%, a few times
    # that reading, and each first tie is held by its objective against the
    # float64 sweep's as well as the plain version's
    agree = riccati_agreement(f"{name} Riccati twin T={steps}", got, want, Quu, qu, max_tie_share=1e-2, exact=exact)
    enum = kw.get("pnqp_enum", "")
    by_lanes = {(L, st): ric.run_staged_riccati(rs._stream_launcher(device, n, m, pnqp_enum=enum), *args, lanes=L,
                                                staged=st, **kw) for L, st in ((1, False), (1, True), (16, True))}
    bit_equal = lanes_bit_equal(f"{name} Riccati twin lanes", by_lanes)
    out = {}
    ric.run_staged_riccati(timed_launch(rs._stream_launcher(device, n, m, pnqp_enum=enum), 20, out), *args,
                           lanes=lanes, **kw)
    wrap_ms = cuda_ms(lambda: rs.riccati_backward_stream_cuda(*args, **kw), 10, 2)
    plain_ms = cuda_ms(lambda: ric.riccati_backward_plain(*args, **kw), 1, 1)
    return dict(n=n, m=m, B=B, T=steps, lanes=lanes, lanes_bit_equal=bit_equal, kernel_ms=out["ms"],
                wrapper_ms=wrap_ms, plain_ms=plain_ms, bound=riccati_bound(B, n, m, "box", steps, clock_mhz),
                max_abs_err=max(agree["max_abs_err"].values()), agreement=agree)


def riccati_twin_row(label: str, rec: dict, launches: int) -> dict:
    """A kernels-line record of riccati_twin_case's ``rec``: the prebuilt
    twin for the table's shapes, else the variant's."""
    from diffmpc_tpu_torch.ops.cuda.ilqr import KERNEL_SHAPES

    prebuilt = (rec["n"], rec["m"]) in KERNEL_SHAPES
    return dict(name=f"riccati_backward_pallas_stream[{label}, ({rec['n']}, {rec['m']}), T={rec['T']}]", route="cuda",
                source="diffmpc_tpu_torch/csrc/" + ("riccati_stream.cu" if prebuilt else "variants/riccati.cu"),
                replaces="diffmpc_tpu/ops/pallas/riccati_stream.py:171", launches=launches,
                max_abs_err=rec["max_abs_err"], ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
                bound_ms=rec["bound"]["bound_ms"], bound_by=rec["bound"]["bound_by"], library_ms=None,
                lanes=rec["lanes"], B=rec["B"])


class ZooRun:
    """What the zoo's phases share: the card, the launch counters of every
    kernel family they reach, and the results each phase leaves for the
    kernels line."""

    def __init__(self, device, smi: str, clock_mhz: float):
        from diffmpc_tpu_torch.ops.cuda import ilqr as il
        from diffmpc_tpu_torch.ops.cuda import kkt, kkt_stream, riccati_stream, rollout_stream
        from diffmpc_tpu_torch.ops.cuda import riccati as ric
        from diffmpc_tpu_torch.ops.cuda import rollout as rol

        self.device, self.smi, self.clock_mhz = device, smi, clock_mhz
        self.sm_count = torch.cuda.get_device_properties(device).multi_processor_count
        self.named = dict(ilqr=il.ilqr_solve_fused, kkt=kkt.kkt_backward_fused,
                          kkt_stream=kkt_stream.kkt_backward_stream_cuda, riccati=ric.riccati_backward_cuda,
                          riccati_stream=riccati_stream.riccati_backward_stream_cuda,
                          rollout=rol.linesearch_rollout_cuda, rollout_stream=rollout_stream.linesearch_rollout_stream_cuda)
        self.rows, self.fused, self.solves, self.searches = [], {}, {}, {}
        self.ric_twins = {}  # (label, n, m): (riccati_twin_case's record, launches on its path)
        self.main_launches = None

    def reset(self):
        for kern in self.named.values():
            kern.launches = 0

    def counts(self) -> dict:
        torch.cuda.synchronize()
        return {k: kern.launches for k, kern in self.named.items()}

    def only(self, **want) -> dict:
        return {k: want.get(k, 0) for k in self.named}


ZOO_SRC = "diffmpc_tpu_torch/csrc/variants/"


def zoo_config4(run: ZooRun) -> None:
    """Phase 35: BASELINE.json config 4, the cartpole imitation step at
    B=4096: the expert's controls from the true params, the first step's
    gradient against the host's float64 one, then the main path (the expert
    data and five Adam steps learning {"dyn", "logq"}, the counts set to 0
    before and read after), one iLQR and one KKT launch a step, a finite
    loss at every step, each step's forward solve, attach and KKT wrapper
    timed in place (IL4_SPANS) on the card and the host; the card's idle
    share of il_cartpole's step after EX_STEPS at its defaults (config 4)
    in a fresh process first (example_profiles, shared with phase 39: its
    trace must hold the iLQR and KKT kernels); the KKT kernel at (5, 1)
    alone on the first step's own inputs."""
    from diffmpc_tpu_torch import mpc_solve
    from diffmpc_tpu_torch.ops.cuda import kkt
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics
    from diffmpc_tpu_torch.parallel import generate_expert_data, init_train_state, make_dp_train_step

    device, smi = run.device, run.smi
    t0 = time.perf_counter()
    prof = example_profiles()["il_cartpole"]
    idle = dict(warm_steps=prof["warm"], step_ms=prof["profiled_step_ms"], busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
                kernel_ms=prof["kernel_ms"], kernels=prof["kernels"], process="fresh")
    case = zoo_case("cartpole", device)
    config, lo, hi = case["config"], case["lo"], case["hi"]
    _, u_expert, _ = generate_expert_data(config, case["cost"], case["dx"], case["x_init"], lo, hi)
    keys = ("dyn", "logq")
    grad_rec = zoo_gradient_check("config 4", case, [case["params0"][k] for k in keys],
                                  lambda ls: dict(zip(keys, ls)), u_expert, (run.reset, run.counts))
    if grad_rec["launches"] != run.only(ilqr=1, kkt=1):
        raise AssertionError(f"config 4's gradient launched {grad_rec['launches']}")
    # the first step's gradient norms, each leaf, over the whole batch
    ls = [case["params0"][k].clone().requires_grad_(True) for k in keys]
    cost, dx = case["make_problem"](dict(zip(keys, ls)))
    sol = mpc_solve(config, case["x_init"], cost, dx, u_lower=lo, u_upper=hi)
    g_first = torch.autograd.grad(((sol.us - u_expert) ** 2).mean(), ls)

    opt = functools.partial(torch.optim.Adam, lr=IL4_LR)
    step = make_dp_train_step(config, case["make_problem"], opt, u_lower=lo, u_upper=hi)
    state = init_train_state(case["params0"], opt)
    steps_rec, kkt_calls = [], []
    run.reset()
    _, u_expert, expert_objs = generate_expert_data(config, case["cost"], case["dx"], case["x_init"], lo, hi)
    for i in range(IL4_STEPS):
        before = run.counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        spans = {}
        t1 = time.perf_counter()
        start.record()
        with recording("diffmpc_tpu_torch.ops.library", "kkt_backward_fused", kkt_calls if i == 0 else []), \
                timed_spans(IL4_SPANS, spans):
            state, stats = step(state, case["x_init"], u_expert)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t1) * 1e3
        got = {k: v - before[k] for k, v in run.counts().items()}
        rec = dict(step=i, ms=start.elapsed_time(end), host_ms=host_ms, spans=span_ms(spans), loss=float(stats.loss),
                   grad_norm=float(stats.grad_norm), converged_frac=float(stats.converged_frac),
                   clamp_frac=float(stats.clamp_frac), launches=got)
        rec["rest_ms"] = rec["ms"] - sum(v["card_ms"] for v in rec["spans"].values())
        steps_rec.append(rec)
        if got != run.only(ilqr=1, kkt=1) or not np.isfinite(rec["loss"]):
            raise AssertionError(f"config 4's step {i}: {rec}")
    run.main_launches = run.counts()
    emit(phase="config4_il", B=IL4_B, T=config.T, lqr_iter=config.lqr_iter, steps=steps_rec,
         expert_mean_obj=float(expert_objs.mean()), main_path_launches=run.main_launches,
         first_grad_norms=dict(zip(keys, (float(g.norm()) for g in g_first))), first_grad_vs_host=grad_rec,
         dyn=[float(v) for v in state.params["dyn"].detach().cpu()],
         true_dyn=[float(v) for v in case["dx"].params.cpu()], card=smi)
    # the KKT kernel at (5, 1) on the first step's own inputs, alone
    (args, kw), = kkt_calls
    lanes = kkt.kkt_lanes(IL4_B, 5, 1, run.sm_count, config.T)
    out = {}
    kkt.run_staged_kkt(timed_launch(kkt._cuda_launcher(device, 5, 1), 20, out), *args, reg=kw["reg"], lanes=lanes)
    plain_kw = {k: v for k, v in kw.items() if k != "use_cuda"}
    err = check_kkt("config 4's step, KKT (5, 1)", kkt.kkt_backward_fused(*args, **kw),
                    kkt.kkt_backward_plain(*args, **plain_kw))
    plain_ms = cuda_ms(lambda: kkt.kkt_backward_plain(*args, **plain_kw), 1, 1)
    shared = dict(shared_C=kkt.reads_in_place(args[0]), shared_F=kkt.reads_in_place(args[2]))
    kb = kkt_bound(IL4_B, 5, 1, config.T, run.clock_mhz, **shared)
    # where a step's time goes: the forward solve, the attach's linearization
    # (torch.func over every sample), the KKT wrapper; the rest is the
    # step's own ops, the optimizer and the host
    state_ls = [state.params[k].detach().clone().requires_grad_(True) for k in keys]
    cost, dx = case["make_problem"](dict(zip(keys, state_ls)))
    with torch.no_grad():
        solve_ms = cuda_ms(lambda: mpc_solve(config, case["x_init"], cost, dx, u_lower=lo, u_upper=hi), 5, 2)
        sol = mpc_solve(config, case["x_init"], cost, dx, u_lower=lo, u_upper=hi)
    lin_ms = cuda_ms(lambda: linearize_dynamics(dx, sol.xs, sol.us), 5, 2)
    kkt_wrap_ms = cuda_ms(lambda: kkt.kkt_backward_fused(*args, **kw), 10, 2)
    step_ms = min(r["ms"] for r in steps_rec[1:])
    emit(phase="config4_kkt", B=IL4_B, T=config.T, lanes=lanes, kernel_ms=out["ms"], plain_ms=plain_ms,
         max_abs_err=err, bound=kb, reads_in_place=shared, card=smi)
    emit(phase="config4_breakdown", B=IL4_B, step_ms=step_ms, mpc_solve_ms=solve_ms, attach_linearize_ms=lin_ms,
         kkt_wrapper_ms=kkt_wrap_ms, kkt_kernel_ms=out["ms"],
         rest_ms=step_ms - solve_ms - lin_ms - kkt_wrap_ms, profiled_step=idle, card=smi)
    run.rows.append(dict(name="kkt_backward_fused[(5, 1), config 4]", route="cuda", source=ZOO_SRC + "kkt.cu",
                         replaces="diffmpc_tpu/ops/pallas/kkt.py:245", launches=run.main_launches["kkt"],
                         max_abs_err=err, ms=out["ms"], plain_ms=plain_ms, bound_ms=kb["bound_ms"],
                         bound_by=kb["bound_by"], library_ms=None, lanes=lanes))
    emit(phase="config4_seconds", seconds=time.perf_counter() - t0)


def zoo_kernels(run: ZooRun) -> None:
    """Phase 35b: each env's fused kernel against its plain version on the
    card, B=256, two iterations, phase 22's rule (the float64 plain solve as
    the witness; phase 2's ties at m = 2), the cartpole with per-scenario
    params too; every built lane count, with and without hoist_lin,
    bit-equal to one lane over three iterations; the kernel alone at the
    rule's lane count, the wrapper and the plain version timed."""
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    device, smi = run.device, run.smi
    t0 = time.perf_counter()
    two = dict(lqr_iter=2, eps=EPS)
    for name in ZOO_ENVS:
        zc = zoo_case(name, device, ZOO_KERNEL_B)
        steps = zc["config"].T
        for per_scenario in (False, True) if name == "cartpole" else (False,):
            ins = zoo_kernel_inputs(zc, steps)
            if per_scenario:  # each scenario its own physics, 0.8-1.2 of the true
                gen = torch.Generator(device=device).manual_seed(35)
                spread = 0.8 + 0.4 * torch.rand((ZOO_KERNEL_B, ins["dyn"].params.shape[-1]), generator=gen,
                                                device=device)
                ins["dyn"] = ins["dyn"].replace(params=ins["dyn"].params * spread)
            kern = il.ilqr_solve_fused(**ins, **two)
            lanes = il.ilqr_solve_fused.last_lanes
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            plain = il.ilqr_solve_plain(**ins, **two)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t1) * 1e3  # the plain version, timed once
            exact = il.ilqr_solve_plain(**{k: v.double() if torch.is_tensor(v) else v.to(torch.float64)
                                           for k, v in ins.items()}, **two)
            agree = witnessed_agreement(f"{name} fused kernel, per_scenario={per_scenario}", kern, plain, exact,
                                        ties=zc["dx"].n_ctrl > 1)
            env = il.kernel_env(ins["dyn"])
            args = (ins["x_init"], ins["C"], ins["c"], ins["dyn"], ins["u_lower"], ins["u_upper"])
            staged = {}
            for hoist in (False, True):
                launch = il._cuda_launcher(device, env, hoist)
                for L in il.ILQR_LANES:
                    staged[(L, hoist)] = il.run_staged(launch, *args, lqr_iter=3, eps=EPS, lanes=L, hoist_lin=hoist)
            bit_equal = lanes_bit_equal(f"{name} fused lanes, per_scenario={per_scenario}", staged)
            record = dict(phase="zoo_kernel_vs_plain", env=name, per_scenario=per_scenario, B=ZOO_KERNEL_B, T=steps,
                          lqr_iter=2, lanes=lanes, lanes_bit_equal_three_iterations=bit_equal, **agree)
            if not per_scenario:
                out = {}
                res = il.run_staged(timed_launch(il._cuda_launcher(device, env, False), 10, out), *args, lanes=lanes,
                                    **two)
                wrap_ms = cuda_ms(lambda: il.ilqr_solve_fused(**ins, **two), 10, 2)
                fb = zoo_ilqr_bound(name, res, ZOO_KERNEL_B, steps, N_ALPHA, run.clock_mhz)
                run.fused[name] = dict(ms=out["ms"], wrapper_ms=wrap_ms, plain_ms=plain_ms, bound=fb, lanes=lanes,
                                       max_abs_err=agree["us_max_abs"])
                record.update(kernel_ms=out["ms"], wrapper_ms=wrap_ms, plain_ms=plain_ms, bound=fb, card=smi)
            emit(**record)
    emit(phase="zoo_kernels_seconds", seconds=time.perf_counter() - t0)


def zoo_solves(run: ZooRun) -> None:
    """Phase 36: each env through mpc_solve at its example's width (one iLQR
    launch), the converged share and the times, the fused kernel alone at
    that width; the first ZOO_CPU_B scenarios against the host's plain
    solve (the float64 one as the witness), the cartpole's at config 4's
    B=4096 and lqr_iter=10; for the vehicle, the quadrotor and the acrobot
    the imitation loss's gradient through one iLQR and one KKT launch
    against the host's float64 gradient (config 4's phase holds the
    cartpole's)."""
    from diffmpc_tpu_torch import mpc_solve
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    device, smi = run.device, run.smi
    t0 = time.perf_counter()
    for name in ZOO_ENVS:
        zc = zoo_case(name, device)
        cfg = zc["config"]
        B = zc["x_init"].shape[0]
        solve_args = (cfg, zc["x_init"], zc["cost"], zc["dx"])
        bounds = dict(u_lower=zc["lo"], u_upper=zc["hi"])
        with torch.no_grad():
            run.reset()
            sol = mpc_solve(*solve_args, **bounds)
            launches = run.counts()
            if launches != run.only(ilqr=1):
                raise AssertionError(f"{name}'s mpc_solve launched {launches}")
            solve_ms = cuda_ms(lambda: mpc_solve(*solve_args, **bounds), 5, 2)
        ins = zoo_kernel_inputs(zc, cfg.T)
        knobs = dict(lqr_iter=cfg.lqr_iter, eps=cfg.eps)
        env = il.kernel_env(zc["dx"])
        lanes = il.ilqr_lanes(B, env, run.sm_count)
        out = {}
        res = il.run_staged(timed_launch(il._cuda_launcher(device, env, False), 10, out), ins["x_init"], ins["C"],
                            ins["c"], ins["dyn"], ins["u_lower"], ins["u_upper"], lanes=lanes, **knobs)
        record = dict(phase="zoo_main_path", env=name, B=B, T=cfg.T, lqr_iter=cfg.lqr_iter, launches=launches,
                      converged_frac=float(sol.info.converged.float().mean()), mean_obj=float(sol.objs.mean()),
                      max_n_iters=int(sol.info.n_iters), mean_qp_iters=float(sol.info.qp_iters.mean()),
                      clamp_frac=float(sol.info.clamp_frac.mean()), mpc_solve_ms=solve_ms, kernel_ms=out["ms"],
                      lanes=lanes, bound=zoo_ilqr_bound(name, res, B, cfg.T, N_ALPHA, run.clock_mhz), card=smi)
        cut = {k: (v[:ZOO_CPU_B] if k == "x_init" else v[:, :ZOO_CPU_B]).cpu() if torch.is_tensor(v) else
               v.to(device="cpu") for k, v in ins.items()}
        kern = il.ilqr_solve_fused(**ins, **knobs)
        head = kern._replace(**{f: getattr(kern, f)[:, :ZOO_CPU_B] if getattr(kern, f).ndim == 3 else
                                getattr(kern, f)[:ZOO_CPU_B] for f in kern._fields})
        host = il.ilqr_solve_plain(**cut, **knobs)
        exact = il.ilqr_solve_plain(**{k: v.double() if torch.is_tensor(v) else v.to(torch.float64)
                                       for k, v in cut.items()}, **knobs)
        record["vs_host"] = dict(first_scenarios=ZOO_CPU_B, **witnessed_agreement(
            f"{name} mpc_solve, card vs host", head, host, exact, ties=cfg.n_ctrl > 1, converged_free=True))
        if name != "cartpole":  # config 4's own phase holds the cartpole's gradient
            with torch.no_grad():
                expert = mpc_solve(*solve_args, **bounds).us
            grad = zoo_gradient_check(name, zc, [zc["params0"]], lambda ls: ls[0], expert, (run.reset, run.counts))
            if grad["launches"] != run.only(ilqr=1, kkt=1):
                raise AssertionError(f"{name}'s solve + gradient launched {grad['launches']}")
            prm = zc["params0"].clone().requires_grad_(True)

            def solve_grad():
                cost, dx = zc["make_problem"](prm)
                s = mpc_solve(cfg, zc["x_init"], cost, dx, **bounds)
                return torch.autograd.grad(((s.us - expert) ** 2).mean(), prm)

            record.update(gradient=grad, solve_plus_grad_ms=cuda_ms(solve_grad, 3, 2))
        run.solves[name] = launches
        emit(**record)
    emit(phase="zoo_main_path_seconds", seconds=time.perf_counter() - t0)


def zoo_line_searches(run: ZooRun) -> None:
    """Phase 36b: the line search with each env's step. The non-fused loop
    (verbose=1) through mpc_solve at T=20 (the resident kernels: one Riccati
    and one line-search launch an iteration), and for the cartpole at
    T_LONG with a gradient (the twins, and one launch of the KKT twin); each
    kernel on line-search inputs of the env (B=1024) against its plain
    version by phase 10's rule, the float64 plain version as the witness of
    the trajectory; every built lane count of the resident kernel and the
    twin bit-equal to one lane; the kernel alone, the wrapper and the plain
    version timed."""
    from diffmpc_tpu_torch import mpc_solve
    from diffmpc_tpu_torch.ops.cuda import rollout as rol
    from diffmpc_tpu_torch.ops.cuda import rollout_stream

    device, smi = run.device, run.smi
    t0 = time.perf_counter()
    for name, steps in [(n_, T) for n_ in ZOO_ENVS] + [("cartpole", T_LONG)]:
        twin = steps != T
        kind, ric_kind = ("rollout_stream", "riccati_stream") if twin else ("rollout", "riccati")
        zc = zoo_case(name, device, ZOO_LS_B)
        cfg = dataclasses.replace(zc["config"], T=steps, verbose=1, detach_unconverged=False)
        prm = (zc["params0"]["dyn"] if name == "cartpole" else torch.exp(zc["params0"])).clone().requires_grad_(twin)
        run.reset()
        calls, sweeps = [], []
        with contextlib.redirect_stdout(io.StringIO()) as printed, \
                recording("diffmpc_tpu_torch.ops.lqr", f"linesearch_rollout{'_stream' if twin else ''}_cuda", calls), \
                recording("diffmpc_tpu_torch.ops.lqr", "riccati_backward_stream_cuda", sweeps):
            sol = mpc_solve(cfg, zc["x_init"], zc["cost"], zc["dx"].replace(params=prm), u_lower=zc["lo"],
                            u_upper=zc["hi"])
            if twin:
                torch.autograd.grad((sol.us**2).mean(), prm)
        it = int(sol.info.n_iters)
        got = run.counts()
        want = run.only(**{ric_kind: it, kind: it}, **(dict(kkt_stream=1) if twin else {}))
        if got != want or not printed.getvalue().strip():
            raise AssertionError(f"{name} verbose=1 at T={steps}: launches {got} for {it} iterations")
        ls_args, kw = zoo_line_search_inputs(name, ZOO_LS_B, steps, 3600 + steps, device)
        dyn = kw["dyn"]
        runner = rollout_stream.linesearch_rollout_stream_cuda if twin else rol.linesearch_rollout_cuda
        got_ls = runner(*ls_args, **kw)
        lanes = runner.last_lanes
        plain = rol.linesearch_rollout_plain(*ls_args, **kw)
        exact = rol.linesearch_rollout_plain(*(None if a is None else a.double() for a in ls_args),
                                             u_lower=kw["u_lower"].double(), u_upper=kw["u_upper"].double(),
                                             dyn=dyn.to(torch.float64))
        agree = zoo_line_search_check(f"{name} T={steps}", got_ls, plain, exact)
        # every built lane count bit-equal to one lane, the resident kernel
        # and the twin alike
        by_lanes = {}
        for label, launcher in (("rollout", rol._cuda_launcher), ("rollout_stream", rollout_stream._stream_launcher)):
            launch = launcher(device, dyn.n_state, dyn.n_ctrl, dyn)
            for L in rol.ROLLOUT_LANES:
                by_lanes[(label, L)] = rol.run_staged_rollout(launch, *ls_args, lanes=L, **kw)
        bit_equal = lanes_bit_equal(f"{name} line search lanes, T={steps}", by_lanes)
        launcher = rollout_stream._stream_launcher if twin else rol._cuda_launcher
        out = {}
        res = rol.run_staged_rollout(timed_launch(launcher(device, dyn.n_state, dyn.n_ctrl, dyn), 20, out), *ls_args,
                                     lanes=lanes, **kw)
        wrap_ms = cuda_ms(lambda: runner(*ls_args, **kw), 10, 2)
        plain_ms = cuda_ms(lambda: rol.linesearch_rollout_plain(*ls_args, **kw), 1, 1)
        rb = zoo_rollout_bound(name, res, ZOO_LS_B, steps, run.clock_mhz)
        run.searches[(name, steps)] = dict(ms=out["ms"], plain_ms=plain_ms, bound=rb, lanes=lanes, launches=got[kind],
                                           max_abs_err=agree["traj_max_abs_where_alpha_agrees"])
        emit(phase="zoo_line_search", env=name, B=ZOO_LS_B, T=steps, kernel=kind, lanes=lanes, n_iters=it,
             path_launches=got, lanes_bit_equal=bit_equal, kernel_ms=out["ms"], wrapper_ms=wrap_ms,
             plain_ms=plain_ms, bound=rb, card=smi, **agree)
        with torch.no_grad():
            emit(phase="zoo_line_search_nothing_improves", env=name, B=ZOO_LS_B, T=steps, kernel=kind,
                 calls=len(calls), card=smi, **nothing_improves_case(f"{name} T={steps}", device, calls[-1], runner))
            if twin:
                rec = riccati_twin_case(name, device, sweeps[0], run.clock_mhz)
                run.ric_twins[(f"{name.capitalize()}Dx", rec["n"], rec["m"])] = (rec, got[ric_kind])
                emit(phase="zoo_riccati_twin", env=name, card=smi, **rec)
    emit(phase="zoo_line_search_seconds", seconds=time.perf_counter() - t0)


def zoo_rows(run: ZooRun) -> list:
    """The zoo's records for the kernels line: each env's fused kernel (its
    launches on config 4's main path for the cartpole, on its mpc_solve for
    the others) and line search (on its verbose=1 solve), and the KKT at
    (5, 1)."""
    keep = ("bound_ms", "bound_by")
    rows = list(run.rows)
    for name in ZOO_ENVS:
        f = run.fused[name]
        launches = run.main_launches["ilqr"] if name == "cartpole" else run.solves[name]["ilqr"]
        rows.append(dict(name=f"ilqr_solve_fused[{name.capitalize()}Dx]", route="cuda", source=ZOO_SRC + "ilqr.cu",
                         env_step=f"diffmpc_tpu_torch/csrc/{name}.cuh", replaces="diffmpc_tpu/ops/pallas/ilqr.py:458",
                         launches=launches, max_abs_err=f["max_abs_err"], ms=f["ms"], plain_ms=f["plain_ms"],
                         **{k: f["bound"][k] for k in keep}, library_ms=None, lanes=f["lanes"], B=ZOO_KERNEL_B,
                         lqr_iter=2))
    for (name, steps), s in run.searches.items():
        twin = steps != T
        rows.append(dict(name=f"linesearch_rollout_pallas{'_stream' if twin else ''}[{name.capitalize()}Dx, T={steps}]",
                         route="cuda", source=ZOO_SRC + "rollout.cu", env_step=f"diffmpc_tpu_torch/csrc/{name}.cuh",
                         replaces="diffmpc_tpu/ops/pallas/rollout_stream.py:196" if twin else
                         "diffmpc_tpu/ops/pallas/rollout.py:180", launches=s["launches"], max_abs_err=s["max_abs_err"],
                         ms=s["ms"], plain_ms=s["plain_ms"], **{k: s["bound"][k] for k in keep}, library_ms=None,
                         lanes=s["lanes"], B=ZOO_LS_B))
    rows += [riccati_twin_row(label, rec, launches) for (label, _, _), (rec, launches) in run.ric_twins.items()
             if not label.startswith("CtrlPassthrough")]
    return rows


ZOO_PHASES = (zoo_config4, zoo_kernels, zoo_solves, zoo_line_searches)


def zoo(device, smi: str, clock_mhz: float) -> list:
    """Phases 35-36 in order; returns the kernels' records."""
    run = ZooRun(device, smi, clock_mhz)
    for phase in ZOO_PHASES:
        phase(run)
    return zoo_rows(run)


# ---------------------------------------------------------------------------
# Phases 37-38: the receding-horizon loop (diffmpc_tpu_torch.receding, the
# example diffmpc_tpu_torch/examples/receding_mpc.py) with the slew penalty
# on the control-passthrough variants of the fused solve and the line search
# (csrc/passthrough.cuh), and the rest of mpc.py: callable costs, u_zero_I,
# ANALYTIC_CHECK.
# ---------------------------------------------------------------------------

# examples/receding_mpc.py's full width: B=1024, T=20, lqr_iter=10, eps=1e-5,
# 100 env steps, the plant's params +-15% off the model's, seed 0
RH_B, RH_T, RH_ITER, RH_STEPS, RH_ERR = 1024, 20, 10, 100, 0.15
RH_EPISODES = (("pendulum", 0.0), ("pendulum", 1.0), ("vehicle", 1.0))
RH_CPU_B = 64  # the scenarios held against the host's plain solve
RH_MID = 50  # the env step of the warm-started solve held against the host
# each wrapped env's inner step (ZOO_STEP's columns: operations, sines,
# cosines and square roots, the longest chain x_t -> x_t+1), counted from
# csrc/pendulum.cuh and csrc/vehicle.cuh; the wrapper adds m copies, off
# that chain
PT_STEP = {name: ZOO_STEP[name] for name in ("pendulum", "vehicle")}
PT_SRC = "diffmpc_tpu_torch/csrc/passthrough.cuh"


def passthrough_model(name: str, device):
    """The slew penalty's augmented model of env ``name`` (the pendulum or
    the vehicle) with its default params."""
    from diffmpc_tpu_torch.models import CtrlPassthroughDynamics, PendulumDx

    inner = PendulumDx.default(device=device) if name == "pendulum" else zoo_model(name, device)
    return CtrlPassthroughDynamics(inner=inner, n_ctrl=inner.n_ctrl)


def receding_variant_keys() -> list:
    """Every variant phases 37-38 launch: the control-passthrough fused solve
    and line search (with its twin) of the pendulum at (4, 1) and the
    vehicle at (6, 2), the vehicle's own fused solve (u_zero_I), and the
    Riccati sweep at (6, 2) (the (4, 1) one is prebuilt). The zoo's phases
    build the last two as well: one parallel build takes each key once."""
    from diffmpc_tpu_torch.csrc.build import VariantKey as K
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    keys = [il.env_variant_key(il.kernel_env(passthrough_model(name, "cpu")), family)
            for name in ("pendulum", "vehicle") for family in ("ilqr", "rollout")]
    return keys + [il.env_variant_key(il.kernel_env(zoo_model("vehicle", "cpu")), "ilqr"), K("riccati", 6, 2)]


def pt_step_ops(name: str, tangents: int = 0) -> int:
    """Operations of one wrapped step on a scalar carrying ``tangents`` dual
    parts: the inner step's and the m copies."""
    ops, trans, _ = PT_STEP[name]
    m = 1 if name == "pendulum" else 2
    return (1 + tangents) * (ops + trans + m)


def pt_ilqr_bound(name: str, res, B: int, steps: int, n_alpha: int, clock_mhz: float) -> dict:
    """env_ilqr_bound at the wrapped shape with the wrapped step (the inner
    step's chain; the copies run beside it), shared params."""
    n_i, m = (3, 1) if name == "pendulum" else (4, 2)
    n = n_i + m
    return env_ilqr_bound(n, m, pt_step_ops(name), pt_step_ops(name, tangents=n + m), PT_STEP[name][2],
                          3 if name == "pendulum" else 2, res, B, steps, n_alpha, clock_mhz)


def pt_rollout_bound(name: str, res, B: int, steps: int, clock_mhz: float) -> dict:
    """env_rollout_bound at the wrapped shape with the wrapped step."""
    n_i, m = (3, 1) if name == "pendulum" else (4, 2)
    return env_rollout_bound(n_i + m, m, pt_step_ops(name), PT_STEP[name][2], 3 if name == "pendulum" else 2, res, B,
                             steps, clock_mhz)


def solution_agreement(name: str, got, want, calm: float = 5e-3) -> dict:
    """Two ``mpc_solve`` solutions (MPCSolution) of a convex problem: every
    scenario's objective within 1e-3 relative, its controls within ``calm``
    where the last line-search step agrees and within 5e-2 where it does not
    (a box-QP tie, or a last step taken at the same objective: phase 2's
    ties). A step agrees where the two alphas are within 1e-6 relative: the
    rollout kernel rolls the ladder (alpha *= decay), the plain ladder takes
    powers. Whether each converged is reported: at eps the float32 noise of
    two ways to compute one objective decides it."""
    g = {k: getattr(got, k).detach().double().cpu() for k in ("us", "objs")}
    w = {k: getattr(want, k).detach().double().cpu() for k in ("us", "objs")}
    ga, wa = got.info.mean_alpha.double().cpu(), want.info.mean_alpha.double().cpu()
    tie = (ga - wa).abs() > 1e-6 * wa.abs()
    us = (g["us"] - w["us"]).abs().amax(dim=(0, 2))
    rel = (g["objs"] - w["objs"]).abs() / w["objs"].abs().clamp_min(1e-6)
    out = dict(objs_max_rel=float(rel.max()), us_max_abs=float(us[~tie].max()) if (~tie).any() else 0.0,
               ties=int(tie.sum()), ties_us_max_abs=float(us[tie].max()) if tie.any() else 0.0,
               converged_equal_frac=float((got.info.converged.cpu() == want.info.converged.cpu()).double().mean()),
               converged_frac=float(got.info.converged.double().mean()))
    if out["objs_max_rel"] > 1e-3 or out["us_max_abs"] > calm or out["ties_us_max_abs"] > 5e-2:
        raise AssertionError(f"{name}: {out}")
    return out


class SolView(NamedTuple):
    """An MPCSolution seen as the fused solve's result for the witness rule:
    a scenario's iterations stood in for by whether it converged."""

    us: torch.Tensor
    objs: torch.Tensor
    converged: torch.Tensor
    alpha: torch.Tensor
    n_iters: torch.Tensor


def sol_view(sol, cut: int = 0) -> SolView:
    """``sol``'s first ``cut`` scenarios (all for 0) as a SolView."""
    cut = cut or sol.objs.shape[0]
    conv = sol.info.converged[:cut]
    return SolView(sol.us[:, :cut].detach(), sol.objs[:cut].detach(), conv, sol.info.mean_alpha[:cut],
                   conv.to(torch.int32))


class MpcRun(ZooRun):
    """What phases 37-38 share: ZooRun's card, counters and records, and the
    passthrough kernels' records for the kernels line."""

    def __init__(self, device, smi: str, clock_mhz: float):
        super().__init__(device, smi, clock_mhz)
        self.pt_fused, self.pt_searches = {}, {}


def receding_setup(name: str, slew: float, device):
    """The example's problem (diffmpc_tpu_torch/examples/receding_mpc.py,
    its ``build``) at its full width for env ``name`` and slew weight
    ``slew``."""
    from diffmpc_tpu_torch.examples import receding_mpc as ex

    args = ex.parse_args(receding_flags(name, slew))
    return args, ex.build(args, device)


def receding_flags(name: str, slew: float) -> list:
    """The receding example's flags at its full width (RH_*) for env
    ``name`` and slew weight ``slew``: phase 37's episodes and their
    profiles in a fresh process."""
    return ["--env", name, "--batch", str(RH_B), "--horizon", str(RH_T), "--env-steps", str(RH_STEPS),
            "--lqr-iter", str(RH_ITER), "--seed", "0", "--plant-param-error", str(RH_ERR), "--slew", str(slew)]


def fused_vs_host(name: str, call, cut: int, ties: bool = None) -> tuple:
    """The fused kernel on one recorded solve's inputs ``call`` (the args and
    keywords mpc_solve gave ilqr_solve_fused) against the host's plain fused
    solve on the first ``cut`` scenarios by phase 36's witness rule (the
    float64 plain solve as the witness; a scenario converged on both sides
    counts as iteration-equal; phase 2's ties at m >= 2, or as ``ties``
    says). Per-scenario params are cut with the scenarios. Returns the
    agreement and the kernel's inputs."""
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    args, kw = call
    kw = {k: v for k, v in kw.items() if k != "use_cuda"}
    names = ("x_init", "C", "c", "dyn", "u_lower", "u_upper")
    ins = dict(zip(names, args))
    kern = il.ilqr_solve_fused(**ins, **kw)
    cut_t = lambda v: v[:cut] if v.ndim <= 2 else v[:, :cut]  # noqa: E731

    def cut_model(dyn):
        params = getattr(dyn, "params", None)
        if params is not None and params.ndim == 2:  # per-scenario params
            dyn = dyn.replace(params=params[:cut])
        return dyn.to(device="cpu")

    head = kern._replace(**{f: cut_t(getattr(kern, f)) for f in kern._fields})
    host_in = {k: cut_t(v).cpu() if torch.is_tensor(v) else cut_model(v) for k, v in ins.items()}
    host_kw = {k: cut_t(v).cpu() if torch.is_tensor(v) else v for k, v in kw.items()}
    host = il.ilqr_solve_plain(**host_in, **host_kw)
    exact = il.ilqr_solve_plain(**{k: v.double() if torch.is_tensor(v) else v.to(torch.float64)
                                   for k, v in host_in.items()},
                                **{k: v.double() if torch.is_tensor(v) else v for k, v in host_kw.items()})
    m = ins["dyn"].n_ctrl
    agree = witnessed_agreement(f"{name}, card vs host", head, host, exact, ties=m > 1 if ties is None else ties,
                                converged_free=True)
    return dict(first_scenarios=cut, **agree), (args, kw)


def pt_witness(run: MpcRun, name: str, label: str, call) -> dict:
    """The passthrough fused kernel on one recorded solve's inputs ``call``
    against the host's plain fused solve on the first RH_CPU_B scenarios
    (:func:`fused_vs_host`), and every built lane count, with and without
    hoist_lin, bit-equal to one lane."""
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    agree, (args, kw) = fused_vs_host(f"{name} passthrough fused kernel, {label}", call, RH_CPU_B)
    env = il.kernel_env(args[3])
    staged = {}
    knobs = {k: v for k, v in kw.items() if k not in ("pnqp_enum", "value_update_exact_reg", "hoist_lin")}
    for hoist in (False, True):
        launch = il._cuda_launcher(run.device, env, hoist)
        for L in il.ILQR_LANES:
            staged[(L, hoist)] = il.run_staged(launch, *args, lanes=L, **dict(knobs, hoist_lin=hoist))
    return dict(lanes_bit_equal=lanes_bit_equal(f"{name} passthrough lanes, {label}", staged), **agree)


def receding_episodes(run: MpcRun) -> None:
    """Phase 37: the three closed-loop episodes at the example's full width
    through its own setup and episode (run_receding_horizon; the counts set
    to 0 before each and read after: one fused launch per env step, of the
    passthrough variant with the slew penalty, no other kernel), each
    episode's success share, stage cost and ms per env step (CUDA events,
    its second run), the card's idle share of env step RH_MID profiled in a
    fresh process first (fresh_profile: its trace must hold the fused
    kernel); with
    the slew penalty, the passthrough kernel held against the host on the
    episode's first solve and on its warm-started solve at env step RH_MID,
    the kernel alone, its wrapper and its plain version timed with its
    bound."""
    from diffmpc_tpu_torch.examples import receding_mpc as ex
    from diffmpc_tpu_torch.ops.cuda import ilqr as il
    from diffmpc_tpu_torch.receding import receding_init, receding_step

    device, smi = run.device, run.smi
    profiled = {(r["env"], r["slew"]): r for r in fresh_profile(
        "receding", "--runs", *(" ".join(receding_flags(name, slew)) for name, slew in RH_EPISODES),
        "--at", str(RH_MID))}
    for name, slew in RH_EPISODES:
        t0 = time.perf_counter()
        args, s = receding_setup(name, slew, device)
        keys = []
        run.reset()
        with recording("diffmpc_tpu_torch.ops.cuda.ilqr", "kernel_library", keys):
            xs, us, objs = ex.episode(s, RH_STEPS)
        launches = run.counts()
        if launches != run.only(ilqr=RH_STEPS):
            raise AssertionError(f"receding {name} slew={slew}: launches {launches}")
        launched = sorted({"prebuilt" if key is None else key.name for (key,), _ in keys})
        want_key = il.env_variant_key(il.kernel_env(passthrough_model(name, "cpu") if slew else s["model"]), "ilqr")
        if launched != ["prebuilt" if want_key is None else want_key.name]:
            raise AssertionError(f"receding {name} slew={slew}: launched {launched}, not {want_key}")
        m = ex.metrics(args, s, xs, us)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        xs2, us2, _ = ex.episode(s, RH_STEPS)
        end.record()
        end.synchronize()
        episode_ms = start.elapsed_time(end)
        if not (bool(torch.isfinite(xs2).all()) and torch.equal(us2, us)):
            raise AssertionError(f"receding {name} slew={slew}: the second run differs from the first")
        # the solves at env steps 0 and RH_MID, recorded
        config, cost, model = s["config"], s["cost"], s["model"]
        bounds = dict(u_lower=s["lo"], u_upper=s["hi"])
        state = receding_init(config, s["x0"])
        mid_call, first_call = [], []
        with torch.no_grad():
            for i in range(RH_MID + 1):
                sink = first_call if i == 0 else mid_call if i == RH_MID else []
                with recording("diffmpc_tpu_torch.mpc", "ilqr_solve_fused", sink):
                    nxt, _ = receding_step(config, state, cost, model, s["plant"].forward, **bounds)
                if i < RH_MID:
                    state = nxt
        prof = profiled[(name, slew)]
        record = dict(phase="receding_episode", env=name, slew=slew, B=RH_B, T=RH_T, lqr_iter=RH_ITER, env_steps=RH_STEPS,
                      plant_param_error=RH_ERR, launches=launches, variant=launched[0],
                      success_frac=m["success_frac"], mean_stage_cost=m["mean_stage_cost"],
                      final_stage_cost=m["final_stage_cost"], mean_abs_du=m["mean_abs_du"],
                      mean_obj_last_step=float(objs[-1].mean()), episode_ms=episode_ms,
                      ms_per_env_step=episode_ms / RH_STEPS, profiled_env_step_ms=prof["profiled_step_ms"],
                      busy_ms=prof["busy_ms"], fused_kernel_ms=prof["kernel_ms"]["ilqr"],
                      idle_share=prof["idle_share"], card=smi)
        if slew:
            (call,), (mid,) = first_call, mid_call
            record["first_solve_vs_host"] = pt_witness(run, name, "first solve", call)
            record["mid_solve_vs_host"] = pt_witness(run, name, f"env step {RH_MID}", mid)
            fargs, fkw = call
            fkw = {k: v for k, v in fkw.items() if k not in ("use_cuda", "pnqp_enum", "value_update_exact_reg",
                                                             "hoist_lin")}
            env = il.kernel_env(fargs[3])
            lanes = il.ilqr_lanes(RH_B, env, run.sm_count)
            out = {}
            res = il.run_staged(timed_launch(il._cuda_launcher(device, env, False), 20, out), *fargs, lanes=lanes,
                                **fkw)
            wrap_ms = cuda_ms(lambda: il.ilqr_solve_fused(*fargs, **fkw), 10, 2)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            il.ilqr_solve_plain(*fargs, **fkw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t1) * 1e3  # the plain version, timed once
            fb = pt_ilqr_bound(name, res, RH_B, RH_T, N_ALPHA, run.clock_mhz)
            run.pt_fused[name] = dict(ms=out["ms"], wrapper_ms=wrap_ms, plain_ms=plain_ms, bound=fb, lanes=lanes,
                                      launches=launches["ilqr"], key=launched[0],
                                      max_abs_err=record["first_solve_vs_host"]["us_max_abs"])
            record.update(kernel_ms=out["ms"], wrapper_ms=wrap_ms, plain_ms=plain_ms, lanes=lanes, bound=fb)
        record["seconds"] = time.perf_counter() - t0
        emit(**record)


def receding_line_searches(run: MpcRun) -> None:
    """Phase 37b: the passthrough line search and its twin. A slewed solve
    with verbose=1 (the non-fused loop) at T=20 (the resident kernels) and
    T=128 (the Riccati and rollout twins at the wrapped shape), B=1024, one
    Riccati and one line-search launch an iteration; the first line search
    of each on its recorded inputs against its plain version by phase 10's
    rule (the float64 plain version as the witness of the trajectory), every
    built lane count of the kernel and the twin bit-equal to one lane; the
    kernel alone, its wrapper and its plain version timed."""
    from diffmpc_tpu_torch import mpc_solve
    from diffmpc_tpu_torch.ops.cuda import rollout as rol
    from diffmpc_tpu_torch.ops.cuda import rollout_stream

    device, smi = run.device, run.smi
    for name in ("pendulum", "vehicle"):
        for steps in (RH_T, T_LONG):
            t0 = time.perf_counter()
            twin = steps != RH_T
            kind, ric_kind = ("rollout_stream", "riccati_stream") if twin else ("rollout", "riccati")
            args, s = receding_setup(name, 1.0, device)
            cfg = dataclasses.replace(s["config"], T=steps, verbose=1)
            calls, sweeps = [], []
            runner = rollout_stream.linesearch_rollout_stream_cuda if twin else rol.linesearch_rollout_cuda
            run.reset()
            with contextlib.redirect_stdout(io.StringIO()) as printed, torch.no_grad(), \
                    recording("diffmpc_tpu_torch.ops.lqr", runner.__name__, calls), \
                    recording("diffmpc_tpu_torch.ops.lqr", "riccati_backward_stream_cuda", sweeps):
                sol = mpc_solve(cfg, s["x0"], s["cost"], s["model"], u_lower=s["lo"], u_upper=s["hi"],
                                prev_ctrl=torch.full((RH_B, s["config"].n_ctrl), 0.1, device=device))
            it = int(sol.info.n_iters)
            got = run.counts()
            if got != run.only(**{ric_kind: it, kind: it}) or not printed.getvalue().strip():
                raise AssertionError(f"{name} slewed verbose=1 at T={steps}: launches {got} for {it} iterations")
            last = calls[-1]
            ls_args, kw = calls[0]
            kw = {k: v for k, v in kw.items() if k != "use_cuda"}
            dyn = kw["dyn"]
            got_ls = runner(*ls_args, **kw)
            lanes = runner.last_lanes
            plain = rol.linesearch_rollout_plain(*ls_args, **kw)
            exact = rol.linesearch_rollout_plain(*(None if a is None else a.double() for a in ls_args),
                                                 **dict(kw, u_lower=kw["u_lower"].double(),
                                                        u_upper=kw["u_upper"].double(), dyn=dyn.to(torch.float64)))
            agree = zoo_line_search_check(f"{name} passthrough T={steps}", got_ls, plain, exact)
            n, m = ls_args[0].shape[-1], dyn.n_ctrl
            by_lanes = {}
            for label, launcher in (("rollout", rol._cuda_launcher), ("rollout_stream", rollout_stream._stream_launcher)):
                launch = launcher(device, n, m, dyn)
                for L in rol.ROLLOUT_LANES:
                    by_lanes[(label, L)] = rol.run_staged_rollout(launch, *ls_args, lanes=L, **kw)
            bit_equal = lanes_bit_equal(f"{name} passthrough line search lanes, T={steps}", by_lanes)
            launcher = rollout_stream._stream_launcher if twin else rol._cuda_launcher
            out = {}
            res = rol.run_staged_rollout(timed_launch(launcher(device, n, m, dyn), 20, out), *ls_args, lanes=lanes, **kw)
            wrap_ms = cuda_ms(lambda: runner(*ls_args, **kw), 10, 2)
            plain_ms = cuda_ms(lambda: rol.linesearch_rollout_plain(*ls_args, **kw), 1, 1)
            rb = pt_rollout_bound(name, res, RH_B, steps, run.clock_mhz)
            run.pt_searches[(name, steps)] = dict(ms=out["ms"], plain_ms=plain_ms, bound=rb, lanes=lanes,
                                                  launches=got[kind], max_abs_err=agree["traj_max_abs_where_alpha_agrees"])
            emit(phase="receding_line_search", env=name, B=RH_B, T=steps, kernel=kind, lanes=lanes, n_iters=it,
                 path_launches=got, lanes_bit_equal=bit_equal, kernel_ms=out["ms"], wrapper_ms=wrap_ms,
                 plain_ms=plain_ms, bound=rb, seconds=time.perf_counter() - t0, card=smi, **agree)
            with torch.no_grad():
                emit(phase="receding_line_search_nothing_improves", env=name, B=RH_B, T=steps, kernel=kind,
                     calls=len(calls), card=smi,
                     **nothing_improves_case(f"{name} passthrough T={steps}", device, last, runner))
                if twin:
                    rec = riccati_twin_case(f"{name} passthrough", device, sweeps[0], run.clock_mhz)
                    label = f"CtrlPassthroughDynamics({name.capitalize()}Dx)"
                    run.ric_twins[(label, rec["n"], rec["m"])] = (rec, got[ric_kind])
                    emit(phase="receding_riccati_twin", env=name, card=smi, **rec)


# BASELINE.json config 2's recipe (box-DDP n=4, m=2, T=20, box +-0.6) at
# B=4096, its cost shared over the batch and the horizon (a callable cost
# sees tau alone): the first scenario's first step of the recipe's C, c
RM_CALL_B, RM_COSH_B, RM_COSH_T, RM_COSH_ITER = 4096, 1024, 10, 15
COSH_Q, COSH_GOAL = (1.0, 1.0, 0.1, 0.001), (1.0, 0.0, 0.0, 0.0)


def cosh_cost(q):
    """tests/test_mpc.py:160's cost: the goal quadratic with weights ``q``
    and a cosh barrier on the control, per sample ``tau``."""
    goal = torch.tensor(COSH_GOAL, dtype=q.dtype, device=q.device)

    def cost(tau):
        d = tau - goal
        return 0.5 * (q * d * d).sum() + 0.01 * (torch.cosh(tau[3:]) - 1.0).sum()

    return cost


def cosh_problem(device) -> tuple:
    """Phase 38's (b) problem without its gradient: ``(config, x_init, the
    pendulum)``, B=RM_COSH_B, T=RM_COSH_T, RM_COSH_ITER iterations, box +-2."""
    from diffmpc_tpu_torch import MPCConfig
    from diffmpc_tpu_torch.models import PendulumDx

    cfg = MPCConfig(n_state=3, n_ctrl=1, T=RM_COSH_T, lqr_iter=RM_COSH_ITER, eps=1e-6, exit_unconverged=False,
                    detach_unconverged=True)
    return cfg, torch.tensor(x_init(RM_COSH_B, 38), device=device), PendulumDx.default(device=device)


def config2_callable(device) -> tuple:
    """Phase 38's (a) problem: config 2's recipe at B=RM_CALL_B, T=20, its
    first scenario's first quadratic shared as a callable (and as the
    QuadCost it equals). Returns ``(config, x_init, callable, QuadCost,
    LinDx, box)``."""
    from diffmpc_tpu_torch import LinDx, MPCConfig, QuadCost

    C, c, F, f, x0 = (torch.tensor(a, device=device) for a in random_lqr_numpy(np.random.default_rng(38), T,
                                                                               RM_CALL_B, BOX_N, BOX_M))
    Cs, cs = C[0, 0], c[0, 0]
    config = MPCConfig(n_state=BOX_N, n_ctrl=BOX_M, T=T, lqr_iter=LONG_ITER, exit_unconverged=False,
                       detach_unconverged=False)

    def quad_tau(tau):
        return 0.5 * (tau * (Cs * tau).sum(-1)).sum() + (cs * tau).sum()

    return config, x0, quad_tau, QuadCost(Cs, cs), LinDx(F, f), dict(u_lower=-BOX, u_upper=BOX)


def rest_of_mpc(run: MpcRun) -> None:
    """Phase 38: the rest of mpc.py on the card, each call with the counts
    set to 0 before it and read after. (a) A callable cost equal to config
    2's quadratic (shared) at B=4096 through the non-fused loop: the same
    solve as the QuadCost's by the tests' chaos rule, one Riccati launch an
    iteration and no line-search kernel (the ladder judges by the callable,
    as the JAX package's dispatch does); both timed. (b) tests/test_mpc.py:
    160's cosh cost on the pendulum at B=1024 with the gradient of a loss
    over the first RH_CPU_B scenarios with respect to the cost's weights
    and x_init (one Riccati launch an iteration, one KKT launch), against
    the host's float64 gradient at the card's fixed point (phase 32's rule)
    and the card's solve against the host's on those scenarios. (c)
    u_zero_I pinning the vehicle's steering at B=1024 on the fused kernel
    (one launch), unbounded elsewhere (the +-1e18 box) and inside the
    example's box: the steering exactly 0, the bounded solve bit-equal to
    the one with the steering box [0, 0], the unbounded one against the
    host by phase 36's witness rule. (d) One MPC.solve with ANALYTIC_CHECK
    on the headline problem: the check on the card, then one fused launch,
    bit-equal to ANALYTIC."""
    from diffmpc_tpu_torch import MPC, GradMethods, QuadCost, mpc_solve
    from diffmpc_tpu_torch.models import PendulumDx
    from diffmpc_tpu_torch.ops.cuda import ilqr as il
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics, quadraticize_cost
    from diffmpc_tpu_torch.ops.lqr_step import LqrSpec, lqr_fixed_point

    device, smi = run.device, run.smi
    # (a) the callable cost equal to config 2's quadratic
    t0 = time.perf_counter()
    config, x0, quad_tau, quad_cost, dx, box = config2_callable(device)
    with torch.no_grad():
        run.reset()
        quad = mpc_solve(config, x0, quad_cost, dx, **box)
        quad_launches = run.counts()
        run.reset()
        call = mpc_solve(config, x0, quad_tau, dx, **box)
        call_launches = run.counts()
        it_q, it_c = int(quad.info.n_iters), int(call.info.n_iters)
        if quad_launches != run.only(riccati=it_q, rollout=it_q) or call_launches != run.only(riccati=it_c):
            raise AssertionError(f"callable cost: launches {call_launches} ({it_c} iterations), the QuadCost's "
                                 f"{quad_launches} ({it_q})")
        agree = solution_agreement("callable cost vs QuadCost, config 2", call, quad)
        quad_ms = cuda_ms(lambda: mpc_solve(config, x0, quad_cost, dx, **box), 3, 2)
        call_ms = cuda_ms(lambda: mpc_solve(config, x0, quad_tau, dx, **box), 3, 2)
    emit(phase="callable_cost", B=RM_CALL_B, T=T, launches=call_launches, quadcost_launches=quad_launches,
         n_iters=it_c, quadcost_n_iters=it_q, mpc_solve_ms=call_ms, quadcost_mpc_solve_ms=quad_ms,
         seconds=time.perf_counter() - t0, card=smi, **agree)

    # (b) the cosh cost on the pendulum with its gradient
    t0 = time.perf_counter()
    cfg, xc, pend = cosh_problem(device)
    q = torch.tensor(COSH_Q, device=device, requires_grad=True)
    x_leaf = xc.clone().requires_grad_(True)
    run.reset()
    sol = mpc_solve(cfg, x_leaf, cosh_cost(q), pend, u_lower=-2.0, u_upper=2.0)
    loss = (sol.us[:, :RH_CPU_B] ** 2).mean() + (sol.xs[:, :RH_CPU_B, 2] ** 2).mean()
    g_card = torch.autograd.grad(loss, (q, x_leaf))
    it = int(sol.info.n_iters)
    launches = run.counts()
    if launches != run.only(riccati=it, kkt=1):
        raise AssertionError(f"cosh cost: launches {launches} for {it} iterations")

    def host_grads(dtype):
        qh = torch.tensor(COSH_Q, dtype=dtype, requires_grad=True)
        xh = xc[:RH_CPU_B].to("cpu", dtype).requires_grad_(True)
        xs = sol.xs.detach()[:, :RH_CPU_B].to("cpu", dtype)
        us = sol.us.detach()[:, :RH_CPU_B].to("cpu", dtype)
        dxh = PendulumDx.default(dtype, device="cpu")
        Ch, ch = quadraticize_cost(cosh_cost(qh), xs, us)
        Fh, fh = linearize_dynamics(dxh, xs, us)
        lo = torch.full((RM_COSH_T, RH_CPU_B, 1), -2.0, dtype=dtype)
        spec = LqrSpec(n_state=3, constrained=True, tight_eps=cfg.tight_eps, back_eps=cfg.back_eps, use_cuda=False)
        xs2, us2 = lqr_fixed_point(spec, xh, Ch, ch, Fh, fh, xs, us, lo, -lo)
        keep = sol.info.converged[:RH_CPU_B].cpu()[None, :, None]
        us2, xs2 = torch.where(keep, us2, us), torch.where(keep, xs2, xs)
        return torch.autograd.grad((us2 ** 2).mean() + (xs2[..., 2] ** 2).mean(), (qh, xh))

    g64, g32 = host_grads(torch.float64), host_grads(torch.float32)
    rel = [float((a.cpu().double() - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(
        (g_card[0], g_card[1][:RH_CPU_B]), g64)]
    rel32 = [float((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(g32, g64)]
    with torch.no_grad():
        head = sol_view(sol, RH_CPU_B)
        views = [sol_view(mpc_solve(cfg, xc[:RH_CPU_B].to("cpu", dtype), cosh_cost(torch.tensor(COSH_Q, dtype=dtype)),
                                    PendulumDx.default(dtype, device="cpu"), u_lower=-2.0, u_upper=2.0))
                 for dtype in (torch.float32, torch.float64)]
        vs_host = witnessed_agreement("cosh cost, card vs host", head, *views, converged_free=True)
        solve_ms = cuda_ms(lambda: mpc_solve(cfg, xc, cosh_cost(q.detach()), pend, u_lower=-2.0, u_upper=2.0), 3, 2)

    def solve_grad():
        s2 = mpc_solve(cfg, x_leaf, cosh_cost(q), pend, u_lower=-2.0, u_upper=2.0)
        return torch.autograd.grad((s2.us[:, :RH_CPU_B] ** 2).mean() + (s2.xs[:, :RH_CPU_B, 2] ** 2).mean(), (q, x_leaf))

    grad_rec = dict(rel_err_vs_float64_at_the_fixed_point=rel, host_float32_rel_err_vs_float64=rel32,
                    grad_max_abs=[float(g.abs().max()) for g in g_card])
    if not all(bool(torch.isfinite(g).all()) for g in g_card) or any(r > max(1e-3, 2 * r32) for r, r32 in zip(rel, rel32)):
        raise AssertionError(f"cosh cost: the gradient against the host's float64 one: {grad_rec}")
    emit(phase="cosh_cost", B=RM_COSH_B, T=RM_COSH_T, lqr_iter=RM_COSH_ITER, launches=launches, n_iters=it,
         converged_frac=float(sol.info.converged.float().mean()), mean_obj=float(sol.objs.detach().mean()),
         gradient=grad_rec, vs_host=vs_host, mpc_solve_ms=solve_ms, solve_plus_grad_ms=cuda_ms(solve_grad, 3, 2),
         seconds=time.perf_counter() - t0, card=smi)

    # (c) u_zero_I on the vehicle's steering, on the fused kernel
    t0 = time.perf_counter()
    _, s = receding_setup("vehicle", 0.0, device)
    veh, cost, xv = s["model"], s["cost"], s["x0"]
    vcfg = s["config"]
    pin = torch.tensor([False, True], device=device)
    recs = {}
    with torch.no_grad():
        for label, bounds in (("unbounded", {}), ("box", dict(u_lower=s["lo"], u_upper=s["hi"]))):
            calls = []
            run.reset()
            with recording("diffmpc_tpu_torch.mpc", "ilqr_solve_fused", calls):
                got = mpc_solve(vcfg, xv, cost, veh, u_zero_I=pin, **bounds)
            launches = run.counts()
            pinned_zero = bool((got.us[..., 1] == 0).all())
            if launches != run.only(ilqr=1) or not pinned_zero or not bool(torch.isfinite(got.objs).all()):
                raise AssertionError(f"u_zero_I {label}: launches {launches}, pinned exactly 0: {pinned_zero}")
            rec = dict(launches=launches, converged_frac=float(got.info.converged.float().mean()),
                       mean_obj=float(got.objs.mean()), accel_max_abs=float(got.us[..., 0].abs().max()),
                       mpc_solve_ms=cuda_ms(lambda: mpc_solve(vcfg, xv, cost, veh, u_zero_I=pin, **bounds), 5, 2))
            if label == "box":
                keepdim = torch.tensor([1.0, 0.0], device=device)
                boxed = mpc_solve(vcfg, xv, cost, veh, u_lower=s["lo"] * keepdim, u_upper=s["hi"] * keepdim)
                rec["bit_equal_to_the_zero_box"] = torch.equal(got.us, boxed.us) and torch.equal(got.objs, boxed.objs)
                if not rec["bit_equal_to_the_zero_box"]:
                    raise AssertionError("u_zero_I in the box is not the solve with the steering box [0, 0]")
            else:
                (args, kw), = calls
                kw = {k: v for k, v in kw.items() if k != "use_cuda"}
                ins = dict(zip(("x_init", "C", "c", "dyn", "u_lower", "u_upper"), args))
                cut = lambda v: v[:RH_CPU_B] if v.ndim <= 2 else v[:, :RH_CPU_B]  # noqa: E731
                host_in = {k: cut(v).cpu() if torch.is_tensor(v) else v.to(device="cpu") for k, v in ins.items()}
                host = il.ilqr_solve_plain(**host_in, **kw)
                exact = il.ilqr_solve_plain(**{k: v.double() if torch.is_tensor(v) else v.to(torch.float64)
                                               for k, v in host_in.items()}, **kw)
                kern = il.ilqr_solve_fused(**ins, **kw)
                head = kern._replace(**{f: cut(getattr(kern, f)) for f in kern._fields})
                rec["vs_host"] = witnessed_agreement("u_zero_I unbounded, card vs host", head, host, exact, ties=True,
                                                     converged_free=True)
                rec["bounds_abs"] = float(ins["u_upper"][..., 0].max())
            recs[label] = rec
    emit(phase="u_zero_I", env="vehicle", B=RH_B, T=RH_T, seconds=time.perf_counter() - t0, card=smi, **recs)

    # (d) ANALYTIC_CHECK
    t0 = time.perf_counter()
    prob = problem(B_MAIN, device)
    q_p, p_p = prob["dyn"].get_true_obj()
    kw = dict(u_lower=-2.0, u_upper=2.0, lqr_iter=LQR_ITER, eps=EPS, exit_unconverged=False, backprop=False)
    with torch.no_grad():
        run.reset()
        checked = MPC(3, 1, T, grad_method=GradMethods.ANALYTIC_CHECK, **kw).solve(prob["x_init"], QuadCost(
            torch.diag(q_p), p_p), prob["dyn"])
        launches = run.counts()
        plain = MPC(3, 1, T, **kw).solve(prob["x_init"], QuadCost(torch.diag(q_p), p_p), prob["dyn"])
    same = torch.equal(checked.us, plain.us) and torch.equal(checked.objs, plain.objs)
    if launches != run.only(ilqr=1) or not same:
        raise AssertionError(f"ANALYTIC_CHECK: launches {launches}, equal to ANALYTIC: {same}")
    emit(phase="analytic_check", B=B_MAIN, launches=launches, equal_to_analytic=same,
         seconds=time.perf_counter() - t0, card=smi)


def passthrough_rows(run: MpcRun) -> list:
    """The passthrough kernels' records for the kernels line: each env's
    fused solve (its launches in its slewed episode) and line search and
    twin (their launches in the slewed verbose=1 solve)."""
    keep = ("bound_ms", "bound_by")
    rows = []
    for name, f in run.pt_fused.items():
        rows.append(dict(name=f"ilqr_solve_fused[CtrlPassthroughDynamics({name.capitalize()}Dx)]", route="cuda",
                         source=ZOO_SRC + "ilqr.cu", env_step=PT_SRC, variant=f["key"],
                         replaces="diffmpc_tpu/ops/pallas/ilqr.py:458", launches=f["launches"],
                         max_abs_err=f["max_abs_err"], ms=f["ms"], plain_ms=f["plain_ms"],
                         **{k: f["bound"][k] for k in keep}, library_ms=None, lanes=f["lanes"], B=RH_B))
    for (name, steps), s in run.pt_searches.items():
        twin = steps != RH_T
        rows.append(dict(name=f"linesearch_rollout_pallas{'_stream' if twin else ''}[CtrlPassthroughDynamics("
                              f"{name.capitalize()}Dx), T={steps}]", route="cuda", source=ZOO_SRC + "rollout.cu",
                         env_step=PT_SRC, replaces="diffmpc_tpu/ops/pallas/rollout_stream.py:196" if twin else
                         "diffmpc_tpu/ops/pallas/rollout.py:180", launches=s["launches"], max_abs_err=s["max_abs_err"],
                         ms=s["ms"], plain_ms=s["plain_ms"], **{k: s["bound"][k] for k in keep}, library_ms=None,
                         lanes=s["lanes"], B=RH_B))
    rows += [riccati_twin_row(label, rec, launches) for (label, _, _), (rec, launches) in run.ric_twins.items()
             if label.startswith("CtrlPassthrough")]
    return rows


def receding(device, smi: str, clock_mhz: float) -> list:
    """Phases 37-38 in order; returns the passthrough kernels' records."""
    run = MpcRun(device, smi, clock_mhz)
    t0 = time.perf_counter()
    receding_episodes(run)
    receding_line_searches(run)
    rest_of_mpc(run)
    emit(phase="receding_and_mpc_seconds", seconds=time.perf_counter() - t0)
    return passthrough_rows(run)


# ---------------------------------------------------------------------------
# Phase 39: the port's training examples (diffmpc_tpu_torch/examples/) at
# their default widths, each through its own main([...]) in process: an
# uninterrupted run, a run saved and resumed, the launches and the plain
# versions counted step by step, the times; il_pendulum --mesh on one NCCL
# rank; gen_expert_data's .npz against build + generate_expert_data.
# ---------------------------------------------------------------------------

EX_STEPS, EX_CKPT, EX_CPU_B = 4, 2, 64
# (example, its flags beyond the defaults); every run takes --steps and --out
EX_RUNS = (("il_pendulum", ()), ("il_cartpole", ()), ("il_vehicle", ()), ("il_quadrotor", ()), ("il_acrobot", ()),
           ("il_nn_dynamics", ()), ("sysid_domain_rand", ()), ("sysid_domain_rand", ("--goal-rand", "0.3")))
EX_GEN_ENVS = ("pendulum", "cartpole", "acrobot", "vehicle")
# the plain versions a solve could fall back on, where the port's dispatch
# names them
EX_PLAIN = {"ilqr": ("diffmpc_tpu_torch.ops.cuda.ilqr", "ilqr_solve_plain"),
            "kkt": ("diffmpc_tpu_torch.ops.cuda.kkt", "kkt_backward_plain"),
            "riccati": ("diffmpc_tpu_torch.ops.lqr", "riccati_backward_plain"),
            "rollout": ("diffmpc_tpu_torch.ops.lqr", "linesearch_rollout_plain")}
# the kernels a step's solve and gradient launch, where the port's modules
# call them: recorded on each example's first step
EX_CALLS = {"ilqr": ("diffmpc_tpu_torch.mpc", "ilqr_solve_fused"),
            "riccati": ("diffmpc_tpu_torch.ops.lqr", "riccati_backward_cuda"),
            "kkt": ("diffmpc_tpu_torch.ops.library", "kkt_backward_fused")}


@contextlib.contextmanager
def counted_plain(counts: dict):
    """Each plain version of EX_PLAIN replaced, while inside, by a
    pass-through that adds one to ``counts[name]`` a call."""
    saved = []
    for label, (module_name, name) in EX_PLAIN.items():
        module = importlib.import_module(module_name)
        fn = getattr(module, name)

        def counted(*args, _fn=fn, _label=label, **kw):
            counts[_label] = counts.get(_label, 0) + 1
            return _fn(*args, **kw)

        setattr(module, name, counted)
        saved.append((module, name, fn))
    try:
        yield
    finally:
        for module, name, fn in reversed(saved):
            setattr(module, name, fn)


@contextlib.contextmanager
def example_steps(run: ZooRun, records: list, calls):
    """The examples' make_dp_train_step wrapped, while inside: before each
    step the kernels' counts and the plain versions' are set to 0, after it
    they are read, with the step's CUDA-event and host ms, its stats and the
    iterations of its solve (``records``, one dict a step); the first step's
    kernel calls are kept where ``calls`` is a dict (EX_CALLS's labels)."""
    from diffmpc_tpu_torch.examples import common
    from diffmpc_tpu_torch.parallel import training

    made, solve = common.make_dp_train_step, training.mpc_solve
    iters = []

    def counted_solve(*args, **kw):
        sol = solve(*args, **kw)
        iters.append(int(sol.info.n_iters))
        return sol

    def make_dp_train_step(*args, **kwargs):
        step = made(*args, **kwargs)

        def watched(state, *rest):
            plain = {}
            first = calls is not None and not calls
            keep = {k: [] for k in EX_CALLS} if first else {}
            run.reset()
            iters.clear()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with contextlib.ExitStack() as stack:
                stack.enter_context(counted_plain(plain))
                for label, (module_name, name) in EX_CALLS.items() if first else ():
                    stack.enter_context(recording(module_name, name, keep[label]))
                t0 = time.perf_counter()
                a.record()
                state, stats = step(state, *rest)
                b.record()
                host_ms = (time.perf_counter() - t0) * 1e3
                b.synchronize()
            if first:
                calls.update(keep)
            records.append(dict(ms=a.elapsed_time(b), host_ms=host_ms, loss=float(stats.loss),
                                grad_norm=float(stats.grad_norm), converged_frac=float(stats.converged_frac),
                                n_iters=list(iters), launches={k: v for k, v in run.counts().items() if v},
                                plain=plain))
            return state, stats

        return watched

    common.make_dp_train_step, training.mpc_solve = make_dp_train_step, counted_solve
    try:
        yield
    finally:
        common.make_dp_train_step, training.mpc_solve = made, solve


def run_example(run: ZooRun, module: str, argv: list, calls: dict = None):
    """``diffmpc_tpu_torch.examples.<module>.main(argv)`` under
    :func:`example_steps`; returns (main's result, the step records)."""
    ex = importlib.import_module(f"diffmpc_tpu_torch.examples.{module}")
    records = []
    with example_steps(run, records, calls), contextlib.redirect_stdout(io.StringIO()):
        out = ex.main(argv)
    return out, records


def csv_rows(path: str) -> list:
    """train.csv's rows as strings, ``dt`` left out."""
    import csv

    with open(path) as fh:
        return [{k: v for k, v in r.items() if k != "dt"} for r in csv.DictReader(fh)]


def same_state(a, b) -> bool:
    """Params and optimizer state (Adam's moments and step) bit-equal."""
    from diffmpc_tpu_torch.utils.tree import tree_leaves

    sa, sb = a.opt_state.state_dict()["state"], b.opt_state.state_dict()["state"]
    return all(same_bits(x.detach(), y.detach()) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params))) \
        and sorted(sa) == sorted(sb) and all(same_bits(sa[k][f], sb[k][f]) for k in sa for f in sa[k])


def want_launches(module: str, rec: dict) -> dict:
    """The launches a step must show: the fused path one iLQR and one KKT
    launch; the MLP past the fused kernels' gate one Riccati launch an
    iteration of its solve and one KKT launch."""
    if module == "il_nn_dynamics":
        return dict(riccati=sum(rec["n_iters"]), kkt=1)
    return dict(ilqr=1, kkt=1)


def example_kernels(name: str, calls: dict) -> dict:
    """The first step's kernel calls held against their plain versions: the
    fused solve against the host's on its first EX_CPU_B scenarios
    (:func:`fused_vs_host`, phase 2's ties at every m: the learner's first
    problem leaves some converged scenarios a flat direction, where the two
    sides take another last step at the same objective), a Riccati sweep
    against its plain version on the card (phase 9's rule), the KKT backward
    against its plain version on the card (phase 5's)."""
    from diffmpc_tpu_torch.ops.cuda import kkt
    from diffmpc_tpu_torch.ops.cuda import riccati as ric

    out = {}
    if calls["ilqr"]:
        out["ilqr_vs_host"] = fused_vs_host(f"{name}'s fused solve", calls["ilqr"][0], EX_CPU_B, ties=True)[0]
    for i, (args, kw) in enumerate(calls["riccati"][:2]):
        got = ric.riccati_backward_cuda(*args, **kw)
        want, Quu, qu = ric.riccati_backward_plain(*args, return_qp=True, **kw)
        out[f"riccati_{i}_vs_plain"] = riccati_agreement(f"{name}'s Riccati sweep {i}", got, want, Quu, qu)
    (args, kw), = calls["kkt"]
    plain_kw = {k: v for k, v in kw.items() if k != "use_cuda"}
    out["kkt_max_abs_err"] = check_kkt(f"{name}'s KKT backward", kkt.kkt_backward_fused(*args, **kw),
                                       kkt.kkt_backward_plain(*args, **plain_kw))
    return out


def examples(device, smi: str, clock_mhz: float) -> None:
    """Phase 39: each training example at its default widths, through its
    main([...]) in process under a temporary --out: --steps 4 --ckpt-every 2
    uninterrupted; --steps 2, then --resume --steps 4, its train.csv rows (dt
    aside) and its final params and Adam state bit-equal to the
    uninterrupted run's; at every step the launches (counts set to 0 before
    the step and read after: one iLQR and one KKT launch on the fused path,
    one Riccati launch an iteration and one KKT launch for the MLP past the
    gate) and no plain version called, a finite loss and grad_norm > 0; the
    first step's kernels against their plain versions; the ms a step (CUDA
    events), the host's ms and the card's idle share of the step after
    EX_STEPS, profiled in a fresh process (example_profiles, run by phase
    35 where it ran first: its trace must hold the step's kernels).
    il_pendulum --mesh on one NCCL rank bit-equal to the run without it.
    gen_expert_data's .npz for each env at B=1024 bit-equal to build +
    generate_expert_data in process, one iLQR launch each."""
    from diffmpc_tpu_torch.examples import gen_expert_data
    from diffmpc_tpu_torch.parallel import generate_expert_data

    run = ZooRun(device, smi, clock_mhz)
    t_phase = time.perf_counter()
    profiled = example_profiles()
    with tempfile.TemporaryDirectory() as tmp:
        for n, (module, flags) in enumerate(EX_RUNS):
            name = " ".join((module,) + flags)
            t0 = time.perf_counter()
            out = lambda tag: ["--out", os.path.join(tmp, f"{n}_{tag}")]  # noqa: E731
            calls = {}
            whole, steps = run_example(run, module, [*flags, "--steps", str(EX_STEPS), "--ckpt-every", str(EX_CKPT),
                                                     *out("whole")], calls)
            run_example(run, module, [*flags, "--steps", str(EX_CKPT), "--ckpt-every", str(EX_CKPT),
                                                 *out("parts")])
            resumed, resumed_steps = run_example(run, module, [*flags, "--steps", str(EX_STEPS), "--ckpt-every",
                                                               str(EX_CKPT), "--resume", *out("parts")])
            rows_whole = csv_rows(out("whole")[1] + "/train.csv")
            rows_parts = csv_rows(out("parts")[1] + "/train.csv")
            record = dict(phase="examples", example=name, steps=steps, resumed_steps=resumed_steps,
                          resume_rows_bit_equal=rows_whole == rows_parts, resume_state_bit_equal=same_state(whole,
                                                                                                             resumed))
            for i, rec in enumerate(steps + resumed_steps):
                if rec["launches"] != want_launches(module, rec) or any(rec["plain"].values()) \
                        or not np.isfinite(rec["loss"]) or not rec["grad_norm"] > 0:
                    raise AssertionError(f"{name} step {i}: {rec}")
            if not (record["resume_rows_bit_equal"] and record["resume_state_bit_equal"]):
                raise AssertionError(f"{name}: the resumed run parts from the uninterrupted one: "
                                     f"{rows_whole} / {rows_parts}")
            record["first_step_kernels"] = example_kernels(name, calls)
            if module == "il_pendulum":
                meshed, mesh_steps = run_example(run, module, [*flags, "--mesh", "--steps", str(EX_STEPS), "--ckpt-every",
                                                               "0", *out("mesh")])
                record.update(mesh_rows_bit_equal=csv_rows(out("mesh")[1] + "/train.csv") == rows_whole,
                              mesh_state_bit_equal=same_state(meshed, whole),
                              mesh_launches=[r["launches"] for r in mesh_steps],
                              mesh_ms_per_step=[r["ms"] for r in mesh_steps])
                if not (record["mesh_rows_bit_equal"] and record["mesh_state_bit_equal"]):
                    raise AssertionError(f"il_pendulum --mesh parts from the run without it: {record}")
            prof = profiled[name]
            record.update(profiled_step_ms=prof["profiled_step_ms"], busy_ms=prof["busy_ms"],
                          kernel_ms=prof["kernel_ms"], idle_share=prof["idle_share"],
                          ms_per_step=[r["ms"] for r in steps], host_ms_per_step=[r["host_ms"] for r in steps])
            emit(**record, seconds=time.perf_counter() - t0, card=smi)
        for env in EX_GEN_ENVS:
            t0 = time.perf_counter()
            path = os.path.join(tmp, f"expert_{env}.npz")
            run.reset()
            plain = {}
            with counted_plain(plain), contextlib.redirect_stdout(io.StringIO()):
                gen_expert_data.main(["--env", env, "--out", path])
            launches = {k: v for k, v in run.counts().items() if v}
            b = gen_expert_data.build(gen_expert_data.parse_args(["--env", env]), device)
            xs, us, objs = generate_expert_data(b["config"], b["cost"], b["dx"], b["x_init"], b["lo"], b["hi"])
            saved = np.load(path)
            equal = {k: bool(np.array_equal(saved[k], v.cpu().numpy()))
                     for k, v in dict(x_init=b["x_init"], xs=xs, us=us, objs=objs).items()}
            rec = dict(phase="examples_gen_expert_data", env=env, B=int(b["x_init"].shape[0]), launches=launches,
                       plain=plain, bit_equal=equal, env_key=str(saved["env"]), mean_obj=float(objs.mean()),
                       seconds=time.perf_counter() - t0, card=smi)
            emit(**rec)
            if launches != dict(ilqr=1) or any(plain.values()) or not all(equal.values()) or rec["env_key"] != env:
                raise AssertionError(f"gen_expert_data --env {env}: {rec}")
    emit(phase="examples_seconds", seconds=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# Phase 40: the serving artifacts (diffmpc_tpu_torch/aot.py), each loaded and
# held to the live solve on the card.
# ---------------------------------------------------------------------------

AOT_B_BIG, AOT_WARM_STEPS, AOT_ORACLE_B, AOT_ORACLE_ITER = 65536, 20, 64, 100
# the loading process: it imports the serving module alone (with torch), its
# build step refused (the kernels come from the build on disk), the kernels'
# launches and the plain versions' calls counted; argv: where to write, a
# file whose creation lets it time its calls (the parent, meanwhile, runs the
# rest of the phase on the card and creates it once it only waits), then each
# artifact and its starts
AOT_CHILD = r"""
import os, sys, time
import torch
import diffmpc_tpu_torch.aot as aot

mods = sys.modules


def no_nvcc():
    raise RuntimeError("the loading process would run nvcc")


mods["diffmpc_tpu_torch.csrc.build"].find_nvcc = no_nvcc
cuda = "diffmpc_tpu_torch.ops.cuda."
kernels = dict(ilqr=mods[cuda + "ilqr"].ilqr_solve_fused, riccati=mods[cuda + "riccati"].riccati_backward_cuda,
               rollout=mods[cuda + "rollout"].linesearch_rollout_cuda, kkt=mods[cuda + "kkt"].kkt_backward_fused)
plain = []
for module, name in ((cuda + "ilqr", "ilqr_solve_plain"), (cuda + "kkt", "kkt_backward_plain"),
                     ("diffmpc_tpu_torch.ops.lqr", "riccati_backward_plain"),
                     ("diffmpc_tpu_torch.ops.lqr", "linesearch_rollout_plain")):
    orig = getattr(mods[module], name)
    setattr(mods[module], name, lambda *a, _orig=orig, **k: plain.append(1) or _orig(*a, **k))
out, go, *pairs = sys.argv[1:]
runs = []
for artifact, starts in zip(pairs[::2], pairs[1::2]):
    t0 = time.perf_counter()
    solve = aot.load_solve(open(artifact, "rb").read())
    load_s = time.perf_counter() - t0
    x = torch.load(starts).cuda()
    for kern in kernels.values():
        kern.launches = 0
    plain.clear()
    t0 = time.perf_counter()
    sol = solve(x)
    torch.cuda.synchronize()
    runs.append(dict(solve=solve, x=x, sol=[t.cpu() for t in (sol.xs, sol.us, sol.objs, *sol.info)],
                     launches={k: kern.launches for k, kern in kernels.items()}, plain=len(plain), load_s=load_s,
                     first_call_s=time.perf_counter() - t0))
deadline = time.monotonic() + 900
while not os.path.exists(go):
    if time.monotonic() > deadline:
        raise SystemExit("the parent never let the loading process time its calls")
    time.sleep(0.05)
for run in runs:
    solve, x = run.pop("solve"), run.pop("x")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        solve(x)
    end.record()
    end.synchronize()
    run["ms"] = start.elapsed_time(end) / 20
torch.save(dict(runs=runs, jax=[m for m in mods if m.split(".")[0] in ("jax", "diffmpc_tpu")]), out)
"""
AOT_FIELDS = ("xs", "us", "objs", "converged", "n_iters", "last_improvement", "mean_alpha", "clamp_frac", "qp_iters")


def aot_variant_keys() -> list:
    """The variants phase 40 launches: the cartpole's and the vehicle's fused
    solves and the KKT backward at the cartpole's (5, 1)."""
    from diffmpc_tpu_torch.csrc.build import VariantKey as K
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    return [il.env_variant_key(il.kernel_env(zoo_model(name, "cpu")), "ilqr") for name in ("cartpole", "vehicle")] + [
        K("kkt", 5, 1)]


def aot_flat(sol) -> list:
    return [sol.xs, sol.us, sol.objs, *sol.info]


def aot_agreement(name: str, got, want, objs_rtol: float = 1e-6) -> dict:
    """``xs``, ``us`` and every field of ``info`` bit-equal, ``objs`` within
    ``objs_rtol`` relative; raises otherwise."""
    g, w = aot_flat(got), aot_flat(want)
    bits = {f: same_bits(a.detach(), b.detach()) for f, a, b in zip(AOT_FIELDS, g, w)}
    rel = float(((g[2] - w[2]).abs() / w[2].abs().clamp_min(1e-30)).max())
    bad = [f for f, ok in bits.items() if not ok and f != "objs"]
    if bad or rel > objs_rtol:
        raise AssertionError(f"{name}: the artifact differs from the live solve in {bad}, objs rel {rel}")
    return dict(bit_equal=all(bits.values()), objs_max_rel=rel)


def aot_grad_agreement(name: str, loss_aot, loss_live, g_aot, g_live, rtol: float = 1e-6) -> dict:
    """The loss equal and the gradient within ``rtol`` of its max-abs; raises
    otherwise."""
    rel = float((g_aot - g_live).abs().max() / g_live.abs().max().clamp_min(1e-30))
    if float(loss_aot) != float(loss_live) or rel > rtol or not bool(g_live.abs().max() > 0):
        raise AssertionError(f"{name}: loss {float(loss_aot)} vs {float(loss_live)}, gradient rel {rel}")
    return dict(loss=float(loss_aot), loss_equal=True, grad_rel=rel, grad_bit_equal=bool(torch.equal(g_aot, g_live)))


def callable_agreement(name: str, got, want) -> dict:
    """A callable cost's artifact against its reference: every field
    bit-equal; where one is not, the difference is shown and the artifact is
    held by aot_agreement's objs rule (1e-6 relative) with n_iters equal.
    Raises otherwise."""
    g, w = aot_flat(got), aot_flat(want)
    differ = {f: float((a.detach().double() - b.detach().double()).abs().max())
              for f, a, b in zip(AOT_FIELDS, g, w) if not same_bits(a.detach(), b.detach())}
    rel = float(((g[2] - w[2]).abs() / w[2].abs().clamp_min(1e-30)).max())
    if differ and (rel > 1e-6 or int(g[4]) != int(w[4])):
        raise AssertionError(f"{name}: the artifact differs from its reference: {differ}, objs rel {rel}")
    return dict(bit_equal=not differ, max_abs_diff=differ, objs_max_rel=rel)


def aot_phase(device, smi: str) -> None:
    """Phase 40: the serving artifacts. The headline (the pendulum, B=1024,
    T=20, lqr_iter=10, box +-2) exported on the card, written to a file and
    run by a fresh process that imports diffmpc_tpu_torch.aot alone and may
    not run nvcc (one iLQR launch a call, no plain version); the same at
    B=65,536; the headline built from CPU tensors for the card; a warm-start
    artifact through 20 receding steps; the gradients through params-input
    vjp_order=1 artifacts (the pendulum's per-scenario (B, 3) params, config
    4's cartpole through the linearize op, the vehicle's per-dimension box);
    config 2 as non-fused artifacts at T=20 (B=128, 4096) and T=128 (B=128,
    the twins), their launches beside the live solve's; config 2's card
    solve against the float64 C++ oracle on 64 scenarios
    (tests/test_native_oracle.py's rule). Each artifact equals the live
    solve (aot_agreement); the export and load seconds, bytes and ms a call
    (CUDA events) are printed."""
    from diffmpc_tpu_torch import LinDx, MPCConfig, QuadCost, aot, mpc_solve, native
    from diffmpc_tpu_torch.models import PendulumDx
    from diffmpc_tpu_torch.mpc import MPCInfo, MPCSolution
    from diffmpc_tpu_torch.parallel import generate_expert_data

    t_phase = time.perf_counter()
    run = ZooRun(device, smi, 0.0)
    config = MPCConfig(n_state=3, n_ctrl=1, T=T, lqr_iter=LQR_ITER, eps=EPS, exit_unconverged=False,
                       detach_unconverged=False)
    dx = PendulumDx.default(device=device)
    q, p = dx.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    box = dict(u_lower=-2.0, u_upper=2.0)

    def export(*args, **kw):
        t0 = time.perf_counter()
        blob = aot.export_solve(*args, **kw)
        return blob, time.perf_counter() - t0

    def load(blob):
        t0 = time.perf_counter()
        solve = aot.load_solve(blob)
        return solve, time.perf_counter() - t0

    def live(x, **kw):
        with torch.no_grad():
            return mpc_solve(config, x, cost, dx, **box, **kw)

    def counted(fn):
        """``fn()``'s result, its launches and the plain versions it called."""
        plain = {}
        run.reset()
        with counted_plain(plain):
            out = fn()
        return out, run.counts(), plain

    # ---- the headline and the callable costs' artifacts, loaded by a fresh
    # process (which starts now and is read at the end of the phase) ----
    x = torch.tensor(x_init(B_MAIN), device=device)
    blob, export_s = export(config, cost, dx, B_MAIN, **box)
    want = live(x)
    cosh_cfg, xc, _ = cosh_problem(device)
    cosh = cosh_cost(torch.tensor(COSH_Q, device=device))
    q2_cfg, x2, quad_tau, _, q2_dx, q2_box = config2_callable(device)
    # (name, config, cost, model, starts, box, its export and seconds)
    callables = [("cosh cost", cosh_cfg, cosh, dx, xc, box, *export(cosh_cfg, cosh, dx, RM_COSH_B, **box)),
                 ("config 2's quadratic as a callable", q2_cfg, quad_tau, q2_dx, x2, q2_box,
                  *export(q2_cfg, quad_tau, q2_dx, RM_CALL_B, **q2_box))]
    callable_live = {}

    def artifacts():
        """The phase but the fresh process: the headline in this process, the
        other artifacts and the oracle."""
        solve, load_s = load(blob)
        got, launches, plain = counted(lambda: solve(x))
        if launches != run.only(ilqr=1) or plain:
            raise AssertionError(f"headline artifact: launches {launches}, plain calls {plain}")
        headline = aot_agreement("headline", got, want)
        art_ms, live_ms = cuda_ms(lambda: solve(x), 20), cuda_ms(lambda: live(x), 20)
        emit(phase="aot_headline", B=B_MAIN, T=T, lqr_iter=LQR_ITER, bytes=len(blob), export_s=export_s, load_s=load_s,
             artifact_ms=art_ms, live_ms=live_ms, launches_per_call=launches, **headline, card=smi)

        # ---- the same at B=65,536 ----
        xb = torch.tensor(x_init(AOT_B_BIG, seed=3), device=device)
        big, big_export_s = export(config, cost, dx, AOT_B_BIG, **box)
        big_solve, big_load_s = load(big)
        got, launches, plain = counted(lambda: big_solve(xb))
        if launches != run.only(ilqr=1) or plain:
            raise AssertionError(f"B=65,536 artifact: launches {launches}, plain calls {plain}")
        emit(phase="aot_big", B=AOT_B_BIG, bytes=len(big), export_s=big_export_s, load_s=big_load_s,
             artifact_ms=cuda_ms(lambda: big_solve(xb), 5), live_ms=cuda_ms(lambda: live(xb), 5),
             **aot_agreement("B=65,536", got, live(xb)), card=smi)

        # ---- built from CPU tensors for the card ----
        cpu_dx = dx.to(device=torch.device("cpu"))
        cpu_cost = QuadCost(cost.C.cpu(), cost.c.cpu())
        cpu_blob, cpu_export_s = export(config, cpu_cost, cpu_dx, B_MAIN, platforms=["cuda"], **box)
        cpu_solve, _ = load(cpu_blob)
        if aot.read_manifest(cpu_blob)["platforms"] != ["cuda"]:
            raise AssertionError("the CPU-built artifact is not the card's")
        got, launches, plain = counted(lambda: cpu_solve(x))
        if launches != run.only(ilqr=1) or plain:
            raise AssertionError(f"CPU-built artifact: launches {launches}, plain calls {plain}")
        cpu_rec = aot_agreement("CPU-built", got, solve(x), objs_rtol=0.0)
        emit(phase="aot_cpu_built", B=B_MAIN, bytes=len(cpu_blob), export_s=cpu_export_s, **cpu_rec, card=smi)

        # ---- warm start: 20 receding steps, the plan shifted ----
        warm, _ = export(config, cost, dx, B_MAIN, warm_start=True, **box)
        warm_solve, _ = load(warm)

        def episode(fn):
            u, objs = torch.zeros((T, B_MAIN, 1), device=device), []
            for _ in range(AOT_WARM_STEPS):
                sol = fn(u)
                u = torch.roll(sol.us, -1, dims=0)
                objs.append(sol.objs)
            return torch.stack(objs), u

        (o_art, u_art), launches, plain = counted(lambda: episode(lambda u: warm_solve(x, u)))
        o_live, u_live = episode(lambda u: live(x, u_init=u))
        if not (same_bits(o_art, o_live) and same_bits(u_art, u_live)) or launches != run.only(ilqr=AOT_WARM_STEPS) or plain:
            raise AssertionError(f"warm start: the artifact's loop differs from the live loop (launches {launches})")
        emit(phase="aot_warm_start", B=B_MAIN, steps=AOT_WARM_STEPS, bit_equal=True, launches=launches, card=smi)

        # ---- gradients through params-input, vjp_order=1 artifacts ----
        def grad_case(name, cfg, cst, model, x0, bnd, target, B):
            """The loss and params gradient through a params-input vjp_order=1
            artifact against live's, its launches live's, one KKT launch."""
            blob, ex_s = export(cfg, cst, model, B, params_input=True, vjp_order=1, **bnd)
            fn, ld_s = load(blob)
            leaf = model.params.detach().clone().requires_grad_(True)

            def loss_of(sol):
                return ((sol.us - target) ** 2).mean()

            def art():
                loss = loss_of(fn(x0, leaf))
                return loss, torch.autograd.grad(loss, leaf)[0]

            def lv():
                loss = loss_of(mpc_solve(cfg, x0, cst, model.replace(params=leaf), **bnd))
                return loss, torch.autograd.grad(loss, leaf)[0]

            (la, ga), launches, plain = counted(art)
            (ll, gl), live_launches, _ = counted(lv)
            if launches != live_launches or plain or launches["kkt"] + launches["kkt_stream"] != 1:
                raise AssertionError(f"{name}: launches {launches} (live {live_launches}), plain calls {plain}")
            rec = aot_grad_agreement(name, la, ll, ga, gl)
            return blob, dict(case=name, B=B, bytes=len(blob), export_s=ex_s, load_s=ld_s, launches=launches, **rec,
                              artifact_ms=cuda_ms(art, 5), live_ms=cuda_ms(lv, 5))

        params_b = (dx.params * torch.tensor(np.random.default_rng(7).uniform(0.9, 1.1, (B_MAIN, 3)), dtype=torch.float32,
                                             device=device)).contiguous()
        _, rec = grad_case("pendulum per-scenario params", config, cost, dx.replace(params=params_b), x, box,
                           torch.zeros((T, B_MAIN, 1), device=device), B_MAIN)
        emit(phase="aot_grad", **rec, card=smi)
        case = zoo_case("cartpole", device)
        c4_cost, c4_dx = case["make_problem"](case["params0"])
        c4_bnd = dict(u_lower=case["lo"], u_upper=case["hi"])
        _, u_expert, _ = generate_expert_data(case["config"], case["cost"], case["dx"], case["x_init"], case["lo"],
                                              case["hi"])
        blob4, rec = grad_case("config 4 cartpole (linearize op)", case["config"], c4_cost, c4_dx, case["x_init"], c4_bnd,
                               u_expert, case["x_init"].shape[0])
        if "diffmpc.linearize" not in str(aot.load_solve(blob4).exported.graph):
            raise AssertionError("config 4's artifact does not linearize through the linearize op")
        emit(phase="aot_grad", **rec, card=smi)
        veh = zoo_case("vehicle", device)
        veh_bnd = dict(u_lower=veh["lo"], u_upper=veh["hi"])
        B_veh = veh["x_init"].shape[0]
        blobv, rec = grad_case("vehicle per-dimension box", veh["config"], veh["cost"], veh["dx"], veh["x_init"], veh_bnd,
                               torch.zeros((veh["config"].T, B_veh, 2), device=device), B_veh)
        bounds = aot.read_manifest(blobv)["bounds"]
        if "values" not in (bounds["u_lower"] or {}):
            raise AssertionError(f"the vehicle's box is not recorded by value: {bounds}")
        emit(phase="aot_grad", **rec, bounds=bounds, card=smi)

        # ---- callable costs: each held to the live solve, one Riccati launch
        # an iteration as live's, no other kernel ----
        loaded = {}
        for name, cfg, cst, model, x0, bnd, blob_c, ex_s in callables:
            fn, ld_s = load(blob_c)
            got, launches, plain = counted(lambda: fn(x0))
            with torch.no_grad():
                want_c, live_launches, live_plain = counted(lambda: mpc_solve(cfg, x0, cst, model, **bnd))
            it = int(want_c.info.n_iters)
            if plain or live_plain or launches != live_launches or live_launches != run.only(riccati=it):
                raise AssertionError(f"{name} artifact: launches {launches}, live {live_launches}, plain calls "
                                     f"{plain} / {live_plain}")
            callable_live[name], loaded[name] = want_c, fn
            with torch.no_grad():
                live_ms = cuda_ms(lambda: mpc_solve(cfg, x0, cst, model, **bnd), 3)
            emit(phase="aot_callable", case=name, B=x0.shape[0], T=cfg.T, lqr_iter=cfg.lqr_iter, n_iters=it,
                 bytes=len(blob_c), export_s=ex_s, load_s=ld_s, launches=launches, live_launches=live_launches,
                 artifact_ms=cuda_ms(lambda: fn(x0), 3), live_ms=live_ms, **callable_agreement(name, got, want_c),
                 card=smi)
        # the cosh cost's artifact built from CPU tensors for the card
        name, cfg = callables[0][:2]
        cpu_blob_c, cpu_ex_s = export(cfg, cosh_cost(torch.tensor(COSH_Q)), dx.to(device=torch.device("cpu")),
                                      RM_COSH_B, platforms=["cuda"], **box)
        got, launches, plain = counted(lambda: load(cpu_blob_c)[0](xc))
        if launches != run.only(riccati=int(callable_live[name].info.n_iters)) or plain:
            raise AssertionError(f"CPU-built cosh-cost artifact: launches {launches}, plain calls {plain}")
        emit(phase="aot_callable_cpu_built", case=name, B=RM_COSH_B, bytes=len(cpu_blob_c), export_s=cpu_ex_s,
             **callable_agreement("CPU-built cosh cost vs card-built", got, loaded[name](xc)), card=smi)
        # its params gradient through a params-input, vjp_order=1 artifact
        _, rec = grad_case("cosh cost params gradient", cfg, cosh, dx, xc, box,
                           torch.zeros((cfg.T, RM_COSH_B, 1), device=device), RM_COSH_B)
        emit(phase="aot_grad", **rec, card=smi)

        # ---- config 2 as non-fused artifacts, and the float64 oracle ----
        for steps, B, iters in ((T, BOX_B, 10), (T, B_MID, 10), (T_LONG, BOX_B, LONG_ITER)):
            cfg = MPCConfig(n_state=BOX_N, n_ctrl=BOX_M, T=steps, lqr_iter=iters, exit_unconverged=False,
                            detach_unconverged=False)
            C, c, F, f, x0 = (torch.tensor(a, device=device) for a in random_lqr_numpy(np.random.default_rng(11), steps, B,
                                                                                         BOX_N, BOX_M))
            bnd = dict(u_lower=-BOX, u_upper=BOX)
            blob2, ex_s = export(cfg, QuadCost(C, c), LinDx(F, f), B, **bnd)
            fn, ld_s = load(blob2)
            got, launches, plain = counted(lambda: fn(x0))
            with torch.no_grad():
                want2, live_launches, _ = counted(lambda: mpc_solve(cfg, x0, QuadCost(C, c), LinDx(F, f), **bnd))
            rec = aot_agreement(f"config 2 T={steps} B={B}", got, want2)
            it = int(want2.info.n_iters)
            kinds = ("riccati_stream", "rollout_stream") if steps == T_LONG else ("riccati", "rollout")
            if plain or launches != live_launches or live_launches != run.only(**{k: it for k in kinds}):
                raise AssertionError(f"config 2 T={steps} B={B}: launches {launches}, live {live_launches}, plain {plain}")
            emit(phase="aot_config2", T=steps, B=B, lqr_iter=iters, n_iters=it, bytes=len(blob2), export_s=ex_s, load_s=ld_s,
                 launches={k: launches[k] for k in kinds}, live_launches={k: live_launches[k] for k in kinds},
                 artifact_ms=cuda_ms(lambda: fn(x0), 3), live_ms=cuda_ms(lambda: mpc_solve(cfg, x0, QuadCost(C, c),
                                                                                          LinDx(F, f), **bnd), 3),
                 **rec, card=smi)
        arrays = random_lqr_numpy(np.random.default_rng(12), T, BOX_B, BOX_N, BOX_M)
        oracle_cfg = MPCConfig(n_state=BOX_N, n_ctrl=BOX_M, T=T, lqr_iter=AOT_ORACLE_ITER, eps=1e-13,
                               not_improved_lim=10 ** 6, exit_unconverged=False, detach_unconverged=False)
        C, c, F, f, x0 = (torch.tensor(a, device=device) for a in arrays)
        with torch.no_grad():
            card = mpc_solve(oracle_cfg, x0, QuadCost(C, c), LinDx(F, f), u_lower=-BOX, u_upper=BOX)
        cut = [np.asarray(a[:, :AOT_ORACLE_B] if a.ndim > 2 else a[:AOT_ORACLE_B], np.float64) for a in arrays]
        t0 = time.perf_counter()
        _, us_n, objs_n = native.solve_batch(*cut, u_lower=np.full((T, AOT_ORACLE_B, BOX_M), -BOX),
                                             u_upper=np.full((T, AOT_ORACLE_B, BOX_M), BOX), ilqr_iter=AOT_ORACLE_ITER)
        oracle_s = time.perf_counter() - t0
        us_err = float((card.us[:, :AOT_ORACLE_B].double().cpu() - us_n).abs().max())
        objs_err = float(((card.objs[:AOT_ORACLE_B].double().cpu() - objs_n).abs() / (1e-5 + 1e-5 * objs_n.abs())).max())
        emit(phase="aot_native_oracle", T=T, B=BOX_B, scenarios=AOT_ORACLE_B, lqr_iter=AOT_ORACLE_ITER,
             us_max_abs_err=us_err, us_tol=2.5e-4, objs_err_over_tol=objs_err, oracle_s=oracle_s, card=smi)
        if us_err > 2.5e-4 or objs_err > 1.0:
            raise AssertionError(f"config 2 on the card against the float64 oracle: us {us_err}, objs {objs_err} x tol")

    with tempfile.TemporaryDirectory() as tmp:
        out, go = os.path.join(tmp, "out.pt"), os.path.join(tmp, "go")
        pairs = []
        for i, (art, starts) in enumerate([(blob, x)] + [(c[6], c[4]) for c in callables]):
            pairs += [os.path.join(tmp, f"{i}.bin"), os.path.join(tmp, f"{i}.pt")]
            with open(pairs[-2], "wb") as f:
                f.write(art)
            torch.save(starts.cpu(), pairs[-1])
        repo = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.Popen([sys.executable, "-c", AOT_CHILD, out, go, *pairs], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=dict(os.environ, PYTHONPATH=repo), cwd=repo)
        try:
            artifacts()
            with open(go, "w"):
                pass
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(f"the loading process failed:\n{stdout}\n{stderr}")
        child = torch.load(out)
    if child["jax"]:
        raise AssertionError(f"the loading process imported JAX modules: {child['jax']}")
    references = [("headline", want, dict(ilqr=1))] + [
        (c[0], callable_live[c[0]], dict(riccati=int(callable_live[c[0]].info.n_iters))) for c in callables]
    for (name, reference, launches), fresh_run in zip(references, child["runs"]):
        flat = [t.to(device) for t in fresh_run["sol"]]
        got = MPCSolution(*flat[:3], MPCInfo(*flat[3:]))
        agree = (aot_agreement if name == "headline" else callable_agreement)(f"{name}, fresh process", got, reference)
        want_launches = {k: launches.get(k, 0) for k in fresh_run["launches"]}
        if fresh_run["launches"] != want_launches or fresh_run["plain"]:
            raise AssertionError(f"the loading process, {name}: launches {fresh_run['launches']}, "
                                 f"{fresh_run['plain']} plain calls")
        emit(phase="aot_fresh_process", case=name, B=got.objs.shape[0], load_s=fresh_run["load_s"],
             first_call_s=fresh_run["first_call_s"], ms=fresh_run["ms"], launches=fresh_run["launches"],
             plain_calls=fresh_run["plain"], **agree, card=smi)
    emit(phase="aot_done", seconds=time.perf_counter() - t_phase, card=smi)


# ---------------------------------------------------------------------------
# Phase 41: one robot. The render example's episode (examples/
# render_trajectory.py:41-88: B=1, T=15, lqr_iter=8, eps=1e-5, 80 env steps)
# for each of the five envs through the port's example (diffmpc_tpu_torch/
# examples/render_trajectory.py, its build and episode): one fused launch an
# env step, of the prebuilt pendulum kernel or the env's variant. Its frames
# are drawn on the host (tests/test_torch_render.py): the card's machine has
# no matplotlib.
# ---------------------------------------------------------------------------

RENDER_ENVS = ("pendulum", "cartpole", "vehicle", "quadrotor", "acrobot")
RENDER_AT = (0, 40, 79)  # the env steps whose solves are held against the plain version
RENDER_LOOPS = 50  # the kernel alone and the wrapper, each a mean over this many calls


def render_solve(name: str, run: ZooRun, step: int, call) -> tuple:
    """The episode's solve at env step ``step`` (its recorded call of the
    fused wrapper, warm start included) against the host's plain fused solve
    by phase 36's witness rule; every built lane count, with and without
    hoist_lin, bit-equal to one lane; the kernel alone (at the wrapper's
    lanes) and the wrapper timed, the kernel's bound from its result.
    Returns the record and the solve's inputs ``(args, knobs)``."""
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    agree, (args, kw) = fused_vs_host(f"{name} one robot, env step {step}", call, 1)
    knobs = {k: v for k, v in kw.items() if k not in ("use_cuda", "pnqp_enum", "value_update_exact_reg", "hoist_lin")}
    env = il.kernel_env(args[3])
    staged = {}
    for hoist in (False, True):
        launch = il._cuda_launcher(run.device, env, hoist)
        for L in il.ILQR_LANES:
            staged[(L, hoist)] = il.run_staged(launch, *args, lanes=L, **dict(knobs, hoist_lin=hoist))
    bit_equal = lanes_bit_equal(f"{name} one robot lanes, env step {step}", staged)
    lanes = il.ilqr_lanes(1, env, run.sm_count)
    out = {}
    res = il.run_staged(timed_launch(il._cuda_launcher(run.device, env, False), RENDER_LOOPS, out), *args, lanes=lanes,
                        **knobs)
    wrap_ms = cuda_ms(lambda: il.ilqr_solve_fused(*args, **knobs), RENDER_LOOPS, 3)
    bound = zoo_ilqr_bound(name, res, 1, args[1].shape[0], knobs["max_linesearch_iter"], run.clock_mhz)
    return dict(step=step, n_iters=int(res.n_iters[0]), converged=bool(res.converged[0]), lanes=lanes,
                lanes_bit_equal=bit_equal, kernel_ms=out["ms"], wrapper_ms=wrap_ms, bound=bound,
                vs_host=agree), (args, knobs)


def render_episodes(run: ZooRun) -> None:
    """Phase 41: each env's one-robot episode at the example's full width
    through its own build and episode (the counts set to 0 before it and
    read after: one fused launch an env step, of the env's prebuilt kernel
    or variant, no other kernel and no plain version); the states finite
    and the controls in the box; its second run (CUDA events) bit-equal to
    the first, ms an env step; a third under timed_spans, the wrapper's card
    and host ms an env step in place; the card's idle share of env step 40,
    profiled in a fresh process first (fresh_profile: late in this process
    the profiler has lost the fused kernel's events); the
    solves at env steps 0, 40 and 79 (render_solve); the host's ms an env
    step beside the wrapper's (the env step less the wrapper alone at env
    step 40)."""
    from diffmpc_tpu_torch.examples import render_trajectory as ex
    from diffmpc_tpu_torch.ops.cuda import ilqr as il

    device, smi = run.device, run.smi
    profiled = {r["env"]: r for r in fresh_profile("one_robot", "--at", str(RENDER_AT[1]), "--envs", *RENDER_ENVS)}
    for name in RENDER_ENVS:
        t0 = time.perf_counter()
        args = ex.parse_args(["--env", name])
        s = ex.build(args, device)
        steps, cfg = args.steps, s["config"]
        keys, calls, plain = [], [], {}
        run.reset()
        with recording("diffmpc_tpu_torch.ops.cuda.ilqr", "kernel_library", keys), \
                recording("diffmpc_tpu_torch.mpc", "ilqr_solve_fused", calls), counted_plain(plain):
            xs, us, objs = ex.episode(s, steps)
        launches = run.counts()
        lanes = il.ilqr_solve_fused.last_lanes
        if launches != run.only(ilqr=steps) or plain or len(calls) != steps:
            raise AssertionError(f"one robot {name}: launches {launches}, plain calls {plain}, {len(calls)} solves")
        launched = sorted({"prebuilt" if key is None else key.name for (key,), _ in keys})
        want_key = il.env_variant_key(il.kernel_env(s["dx"]), "ilqr")
        if launched != ["prebuilt" if want_key is None else want_key.name]:
            raise AssertionError(f"one robot {name}: launched {launched}, not {want_key}")
        n, m = cfg.n_state, cfg.n_ctrl
        lo, hi = (torch.as_tensor(b, dtype=torch.float32, device=device).expand(m) for b in (s["lo"], s["hi"]))
        if xs.shape != (steps + 1, 1, n) or us.shape != (steps, 1, m) or not bool(torch.isfinite(xs).all()) \
                or not bool(torch.isfinite(objs).all()) or not bool(((us >= lo) & (us <= hi)).all()):
            raise AssertionError(f"one robot {name}: shapes {tuple(xs.shape)}, {tuple(us.shape)}, or non-finite "
                                 f"states, or controls outside the box")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        xs2, us2, _ = ex.episode(s, steps)
        end.record()
        end.synchronize()
        episode_ms = start.elapsed_time(end)
        if not (torch.equal(xs2, xs) and torch.equal(us2, us)):
            raise AssertionError(f"one robot {name}: the second run differs from the first")
        spans = {}
        with timed_spans({"wrapper": ("diffmpc_tpu_torch.mpc", "ilqr_solve_fused")}, spans):
            ex.episode(s, steps)
        torch.cuda.synchronize()
        in_place = {k: v / steps for k, v in span_ms(spans)["wrapper"].items()}
        solves, inputs = zip(*(render_solve(name, run, i, calls[i]) for i in RENDER_AT))
        mid = solves[1]
        ms_step = episode_ms / steps
        record = dict(phase="one_robot_episode", env=name, B=1, T=cfg.T, lqr_iter=cfg.lqr_iter, eps=cfg.eps,
                      env_steps=steps, launches=launches, variant=launched[0], lanes=lanes,
                      final_state=xs[-1, 0].tolist(), mean_obj=float(objs.mean()), episode_ms=episode_ms,
                      ms_per_env_step=ms_step, wrapper_in_place=in_place, profiled=profiled[name],
                      idle_share=profiled[name]["idle_share"],
                      kernel_ms=mid["kernel_ms"], wrapper_ms=mid["wrapper_ms"], host_ms=ms_step - mid["wrapper_ms"],
                      solves=solves, card=smi)
        # the plain version on the card, timed once on the first solve
        pargs, pknobs = inputs[0]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        il.ilqr_solve_plain(*pargs, **pknobs)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        first = solves[0]
        run.fused[name] = dict(ms=first["kernel_ms"], wrapper_ms=first["wrapper_ms"], plain_ms=plain_ms,
                               bound=first["bound"], lanes=first["lanes"], launches=launches["ilqr"],
                               key=launched[0], T=cfg.T,
                               max_abs_err=max(sv["vs_host"]["us_max_abs"] for sv in solves))
        record.update(plain_ms=plain_ms, seconds=time.perf_counter() - t0)
        emit(**record)


def render_rows(run: ZooRun) -> list:
    """The one-robot records for the kernels line: each env's fused kernel at
    B=1 on its episode's first solve, with its launches in the episode."""
    rows = []
    for name, f in run.fused.items():
        rows.append(dict(name=f"ilqr_solve_fused[{name.capitalize()}Dx, B=1]", route="cuda",
                         source="diffmpc_tpu_torch/csrc/ilqr.cu" if f["key"] == "prebuilt" else ZOO_SRC + "ilqr.cu",
                         env_step=f"diffmpc_tpu_torch/csrc/{name}.cuh", variant=f["key"],
                         replaces="diffmpc_tpu/ops/pallas/ilqr.py:458", launches=f["launches"],
                         max_abs_err=f["max_abs_err"], ms=f["ms"], plain_ms=f["plain_ms"],
                         **{k: f["bound"][k] for k in ("bound_ms", "bound_by")}, library_ms=None, lanes=f["lanes"],
                         B=1, T=f["T"]))
    return rows


def one_robot(device, smi: str, clock_mhz: float) -> list:
    """Phase 41; returns the kernels' records."""
    run = ZooRun(device, smi, clock_mhz)
    t0 = time.perf_counter()
    render_episodes(run)
    emit(phase="one_robot_seconds", seconds=time.perf_counter() - t0)
    return render_rows(run)


def kkt_lanes_ab(device, smi: str) -> None:
    """Phase 34 (diffmpc_tpu_torch.diagnostics.ab_kkt_lanes): every KKT call
    of the recorded solves + gradients (the headline at B=1024 and 65,536,
    the (6, 3) MLP's imitation gradient at 1024, a (6, 3) LinDx at 4096,
    config 2 at T=20 and 128 at B=128, 4096 and 65,536, the pendulum at
    T=512) through the kernel the dispatch takes at every built L, one lane
    with and without the prefetch and the resident kernel above one lane with
    K, k, p on chip and in device memory, on the same staged inputs: each
    bit-equal to one lane (raises otherwise), one lane within
    1e-4 * max(1, max|plain|) of the plain version (raises beyond), a failed
    launch raising, the times by CUDA events in each round and the rule's
    pick."""
    from diffmpc_tpu_torch.diagnostics import ab_kkt_lanes

    t0 = time.perf_counter()
    for rec in ab_kkt_lanes.run(device, ab_kkt_lanes.CASES, rounds=3):
        ms = rec["ms"]
        pick = rec["pick"]["name"]
        emit(phase="kkt_lanes", case=rec["case"], T=rec["T"], B=rec["B"], n=rec["n"], m=rec["m"],
             dispatched=rec["dispatched"], pick=rec["pick"], C_in_place=rec["C_in_place"], F_in_place=rec["F_in_place"],
             bit_equal_to_one_lane=all(rec["bit_equal"].values()), max_abs_err=rec["max_abs_err"],
             err_bound=rec["err_bound"], pick_ms=ms[pick],
             one_lane_ms=ms[f"{rec['dispatched']}/L1/auto"], sixteen_lanes_ms=ms[f"{rec['dispatched']}/L16/auto"],
             ms=ms, ms_rounds=rec["ms_rounds"], wrapper_ms=rec["wrapper_ms"], stage_ms=rec["stage_ms"],
             stage_copies_ms=rec["stage_copies_ms"], plain_ms=rec["plain_ms"], card=smi)
    emit(phase="kkt_lanes_done", seconds=time.perf_counter() - t0)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA device", file=sys.stderr)
        return 1
    from diffmpc_tpu_torch.csrc import build

    # ---- 0. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(phase="device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(), max_sm_clock_mhz=clock_mhz,
         torch=torch.__version__, cuda=torch.version.cuda)

    # ---- 1. build ----
    t0 = time.perf_counter()
    per_source = {}
    so, log = build.build(per_source)
    build.load()
    build_s = time.perf_counter() - t0
    # the Riccati sweep's kernels, riccati_kernel<n, m, mode, staged, L>
    riccati = {"n{}m{} mode {} {} L={}".format(*k.group(1, 2, 3), "staged" if k.group(4) == "1" else "direct", k.group(5)): v
               for name, v in ptxas_report(log, "riccati_kernel").items()
               if (k := re.search(r"riccati_kernelILi(\d)ELi(\d)ELi(\d)ELb(\d)ELi(\d+)E", name))}
    emit(
        phase="build", seconds=build_s, per_source_seconds=per_source, library=os.path.relpath(so), fresh=bool(log),
        ptxas=ptxas_report(log),
        riccati_sources_seconds={k: v for k, v in per_source.items() if re.fullmatch(r"riccati(_stream|_l\d+)?\.cu", k)},
        riccati_kernels=riccati,
    )
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        second = build.build_with([os.path.join(build.CSRC, f) for f in CACHE_SOURCES], tmp, (), "second")
        check_unique_symbols({"library": so, "second_build": second._name})
    emit(phase="build_second", sources=list(CACHE_SOURCES), seconds=time.perf_counter() - t0)
    if {"--slice-only", "--zoo-only", "--mpc-only", "--examples-only", "--aot-only", "--render-only"} & set(sys.argv[1:]):
        # phases 30-33 alone: the variants and the slice they serve; or the
        # zoo's variants and phases 35-36 alone; or the receding loop's
        # variants and phases 37-38 alone; or the zoo's variants (the
        # examples' kernels) and phase 39 alone; or phase 40's variants and
        # phase 40 alone; or the zoo's variants (the envs' fused kernels) and
        # phase 41 alone
        if "--render-only" in sys.argv[1:]:
            build_variants_phase(zoo_variant_keys())
            rows = one_robot(device, smi, clock_mhz)
        elif "--aot-only" in sys.argv[1:]:
            build_variants_phase(aot_variant_keys())
            aot_phase(device, smi)
            rows = []
        elif "--examples-only" in sys.argv[1:]:
            build_variants_phase(zoo_variant_keys())
            examples(device, smi, clock_mhz)
            rows = []
        elif "--zoo-only" in sys.argv[1:]:
            build_variants_phase(zoo_variant_keys())
            rows = zoo(device, smi, clock_mhz)
        elif "--mpc-only" in sys.argv[1:]:
            build_variants_phase(receding_variant_keys())
            rows = receding(device, smi, clock_mhz)
        else:
            rows = variants_slice(device, smi, clock_mhz)
        print(smi, flush=True)
        emit(kernels=rows)
        emit(ok=True, device=dict(platform="gpu", kind=kind, count=torch.cuda.device_count()))
        return 0
    return run_phases(device, kind, smi, clock_mhz)


def run_phases(device, kind: str, smi: str, clock_mhz: float) -> int:
    """Phases 2-41, then the kernels line and the ok line."""
    from diffmpc_tpu_torch import GradMethods, LinDx, MPCConfig, QuadCost, mpc_solve
    from diffmpc_tpu_torch.models import PendulumDx
    from diffmpc_tpu_torch.ops.cuda import kkt as kkt_mod
    from diffmpc_tpu_torch.ops.cuda import riccati as ric
    from diffmpc_tpu_torch.diagnostics import ab_ilqr_lanes, ab_rollout_lanes
    from diffmpc_tpu_torch.ops.cuda import rollout as rol
    from diffmpc_tpu_torch.ops.cuda.ilqr import ilqr_solve_fused, ilqr_solve_plain
    from diffmpc_tpu_torch.ops.cuda.kkt import kkt_backward_fused, kkt_backward_plain
    from diffmpc_tpu_torch.ops.linearize import linearize_dynamics
    from diffmpc_tpu_torch.ops.lqr import lqr_rollout
    from diffmpc_tpu_torch.ops.lqr_step import kkt_backward_composite
    from diffmpc_tpu_torch.utils.batch import bmv
    from diffmpc_tpu_torch.parallel import generate_expert_data, init_train_state, make_dp_train_step

    sm_count = torch.cuda.get_device_properties(device).multi_processor_count

    # ---- 2. kernel vs plain on the card ----
    knobs = dict(lqr_iter=LQR_ITER, eps=EPS, max_linesearch_iter=N_ALPHA)
    results = {}
    for B in (B_MAIN, B_RAGGED):
        prob = problem(B, device)
        kernel = ilqr_solve_fused(**prob, **knobs)
        plain = ilqr_solve_plain(**prob, **knobs)
        m = compare(kernel, plain)
        emit(phase="kernel_vs_plain", B=B, T=T, **knobs, **m)
        check_chaos(f"B={B}", m)
        results[B] = (kernel, m)
    prob = problem(B_MAIN, device)
    one = dict(lqr_iter=1, eps=0.0)
    err1 = check_tight("lqr_iter=1", ilqr_solve_fused(**prob, **one), ilqr_solve_plain(**prob, **one))
    emit(phase="kernel_vs_plain", B=B_MAIN, T=T, **one, max_abs_err=err1, tol=1e-4)
    u_warm = torch.roll(results[B_MAIN][0].us, -1, dims=0).contiguous()
    mw = compare(
        ilqr_solve_fused(**prob, u_init=u_warm, **knobs),
        ilqr_solve_plain(**prob, u_init=u_warm, **knobs),
    )
    emit(phase="kernel_vs_plain", B=B_MAIN, T=T, warm_start=True, **knobs, **mw)
    check_chaos("warm start", mw)
    unrolled = ilqr_solve_fused(**prob, **knobs, unroll=True)
    mu = compare(unrolled, ilqr_solve_plain(**prob, **knobs, unroll=True))
    powers = torch.tensor([0.2**k for k in range(10)], dtype=torch.float32)  # decay 0.2, 10 steps
    in_powers = bool(torch.isin(unrolled.alpha.cpu(), powers).all())
    emit(phase="kernel_vs_plain", B=B_MAIN, T=T, unroll=True, **knobs, **mu, alphas_are_powers=in_powers)
    check_chaos("unroll", mu)
    if not in_powers:
        raise AssertionError("unroll=True chose an alpha that is not a float32 power decay**k")

    # ---- 3. the main path: mpc_solve at the flagship configuration ----
    config = MPCConfig(
        n_state=3, n_ctrl=1, T=T, lqr_iter=LQR_ITER, eps=EPS,
        exit_unconverged=False, detach_unconverged=False,
    )
    dx = prob["dyn"]
    q, p = dx.get_true_obj()
    cost = QuadCost(torch.diag(q), p)
    x = prob["x_init"]
    ilqr_solve_fused.launches = kkt_backward_fused.launches = 0
    sol = mpc_solve(config, x, cost, dx, u_lower=-2.0, u_upper=2.0)
    torch.cuda.synchronize()
    launches = ilqr_solve_fused.launches
    if launches < 1:
        raise AssertionError("mpc_solve did not launch the iLQR kernel")
    if kkt_backward_fused.launches != 0 or sol.us.requires_grad:
        raise AssertionError("a forward-only solve attached a gradient")
    if sol.us.shape != (T, B_MAIN, 1) or sol.xs.shape != (T, B_MAIN, 3):
        raise AssertionError(f"shapes {tuple(sol.xs.shape)}, {tuple(sol.us.shape)}")
    if not bool(torch.isfinite(sol.objs).all()) or not bool(torch.isfinite(sol.xs).all()):
        raise AssertionError("non-finite solution")
    if float(sol.us.abs().max()) > 2.0:
        raise AssertionError("controls outside the box [-2, 2]")
    cpu = mpc_solve(
        config, x.cpu(), QuadCost(cost.C.cpu(), cost.c.cpu()),
        dx.replace(params=dx.params.cpu()), u_lower=-2.0, u_upper=2.0,
    )
    conv_gpu = float(sol.info.converged.float().mean())
    conv_cpu = float(cpu.info.converged.float().mean())
    mean_gpu, mean_cpu = float(sol.objs.mean()), float(cpu.objs.mean())
    emit(
        phase="main_path", B=B_MAIN, T=T, lqr_iter=LQR_ITER, launches=launches,
        converged_frac=conv_gpu, mean_obj=mean_gpu, max_n_iters=int(sol.info.n_iters),
        cpu_converged_frac=conv_cpu, cpu_mean_obj=mean_cpu,
    )
    if abs(conv_gpu - conv_cpu) > 0.05 or abs(mean_gpu - mean_cpu) > 1e-2 * abs(mean_cpu):
        raise AssertionError("mpc_solve on the card disagrees with the same solve on the CPU")

    # ---- 4. time ----
    times, ilqr_bounds = {}, {}
    for B, k_loops, p_reps in ((B_MAIN, 20, 3), (B_ENSEMBLE, 5, 2)):
        prob = problem(B, device)
        ilqr_bounds[B] = ilqr_solve_bound(ilqr_solve_fused(**prob, **knobs), B, knobs["max_linesearch_iter"],
                                          clock_mhz)
        kernel_ms = cuda_ms(lambda: ilqr_solve_fused(**prob, **knobs), k_loops, 3)
        lanes = ilqr_solve_fused.last_lanes  # the lanes the timed launches took
        plain_ms = cuda_ms(lambda: ilqr_solve_plain(**prob, **knobs), 1, p_reps)
        solve_ms = cuda_ms(
            lambda: mpc_solve(config, prob["x_init"], cost, dx, u_lower=-2.0, u_upper=2.0),
            k_loops, 3,
        )
        times[B] = (kernel_ms, plain_ms, lanes)
        emit(
            phase="time", B=B, T=T, lqr_iter=LQR_ITER, card=smi,
            lanes=lanes, bound=ilqr_bounds[B],
            kernel_ms=kernel_ms, kernel_solves_per_s=B / kernel_ms * 1e3,
            plain_ms=plain_ms, plain_solves_per_s=B / plain_ms * 1e3,
            mpc_solve_ms=solve_ms, mpc_solve_solves_per_s=B / solve_ms * 1e3,
        )

    # ---- 4b. iLQR lanes: each built lane count against L = 1 ----
    t0 = time.perf_counter()
    lane_records = ab_ilqr_lanes.run(device, ab_ilqr_lanes.shapes(device))
    for rec in lane_records:
        emit(phase="ilqr_lanes", card=smi, **rec)
    emit(phase="ilqr_lanes_seconds", seconds=time.perf_counter() - t0)

    # ---- 5. KKT kernel vs plain on the card ----
    kkt_err = 0.0
    for B in (B_MAIN, B_RAGGED):
        for residuals, ins in (("main_path", main_path_kkt_inputs(B, device)),
                               ("random", random_kkt_inputs(B, device, seed=B))):
            err = check_kkt(f"{residuals} B={B}", kkt_backward_fused(*ins), kkt_backward_plain(*ins))
            torch.cuda.synchronize()
            emit(phase="kkt_vs_plain", B=B, T=T, residuals=residuals,
                 tight_share=float(ins[-1].float().mean()), max_abs_err=err,
                 tol="1e-4 * max(1, max|plain|)")
            kkt_err = max(kkt_err, err)

    # ---- 6. gradient on the main path, against the same on the CPU ----
    grad_config = dataclasses.replace(config, detach_unconverged=False)
    ilqr_solve_fused.launches = kkt_backward_fused.launches = 0
    gsol, g = flagship_grads(grad_config, B_MAIN, device)
    torch.cuda.synchronize()
    counts = (ilqr_solve_fused.launches, kkt_backward_fused.launches)
    if counts != (1, 1):
        raise AssertionError(f"solve + gradient launched (iLQR, KKT) = {counts}, not (1, 1)")
    if not all(bool(torch.isfinite(v).all()) for v in g.values()):
        raise AssertionError("non-finite gradient on the main path")
    one = dataclasses.replace(grad_config, lqr_iter=1, eps=0.0)
    _, g1 = flagship_grads(one, B_MAIN, device)
    _, c1 = flagship_grads(one, B_MAIN, "cpu")
    rel = {k: float((g1[k].cpu() - c1[k]).abs().max() / c1[k].abs().max()) for k in g1}
    if max(rel["params"], rel["q"], rel["x_init"]) > 1e-3:
        raise AssertionError(f"one-iteration gradients, card vs CPU: {rel}")
    csol, c = flagship_grads(grad_config, B_MAIN, "cpu")
    agree = (gsol.us.detach().cpu() - csol.us.detach()).abs().amax(dim=(0, 2)) <= 1e-4
    gx, cx = g["x_init"].cpu()[agree], c["x_init"][agree]
    rel10 = float((gx - cx).abs().max() / c["x_init"].abs().max())
    emit(phase="gradient", B=B_MAIN, T=T, lqr_iter=LQR_ITER, launches=dict(ilqr=counts[0], kkt=counts[1]),
         one_iteration_rel_err=rel, agree_frac=float(agree.float().mean()),
         x_init_rows_rel_err=rel10, params_grad=g["params"].tolist(),
         cpu_params_grad=c["params"].tolist())
    if rel10 > 1e-3 or float(agree.float().mean()) < 0.9:
        raise AssertionError(f"ten-iteration x_init gradient rows, card vs CPU: {rel10}")

    # ---- 7. training: 40 imitation-learning steps ----
    train_config = dataclasses.replace(config, detach_unconverged=True)
    true_dx = dx.replace(params=torch.tensor(TRUE_PARAMS, device=device))
    _, u_expert, _ = generate_expert_data(train_config, cost, true_dx, x, -2.0, 2.0)
    adam = functools.partial(torch.optim.Adam, lr=5e-2)
    step = make_dp_train_step(
        train_config, lambda prm: (cost, true_dx.replace(params=prm)), adam, None, -2.0, 2.0
    )
    state = init_train_state(torch.tensor(PARAMS0, device=device), adam)
    losses = []
    ilqr_solve_fused.launches = kkt_backward_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(40):
        state, stats = step(state, x, u_expert)
        losses.append(float(stats.loss))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 40 * 1e3
    train_launches = (ilqr_solve_fused.launches, kkt_backward_fused.launches)
    emit(phase="train", B=B_MAIN, T=T, lqr_iter=LQR_ITER, steps=40,
         losses={i: losses[i] for i in (0, 10, 20, 39)},
         params=state.params.tolist(), converged_frac=float(stats.converged_frac),
         grad_norm=float(stats.grad_norm), ms_per_step=step_ms,
         launches=dict(ilqr=train_launches[0], kkt=train_launches[1]))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not lower a finite loss: {losses[::10]}")
    if train_launches != (40, 40):
        raise AssertionError(f"40 steps launched (iLQR, KKT) = {train_launches}")

    # ---- 8. time: solve + gradient vs forward, and the KKT kernel ----
    kkt_times = {}
    for B, loops in ((B_MAIN, 20), (B_ENSEMBLE, 5)):
        xb = torch.tensor(x_init(B, seed=21), device=device)
        prm = dx.params.clone().requires_grad_(True)
        dxg = dx.replace(params=prm)

        def fwd():
            with torch.no_grad():
                mpc_solve(config, xb, cost, dxg, u_lower=-2.0, u_upper=2.0).us.pow(2).mean()

        def fwd_grad():
            us = mpc_solve(grad_config, xb, cost, dxg, u_lower=-2.0, u_upper=2.0).us
            torch.autograd.grad(us.pow(2).mean(), prm)

        # strict alternation, best of each: two loops timed minutes apart
        # see different clocks and neighbours
        t_f = t_g = float("inf")
        for _ in range(5):
            t_f = min(t_f, cuda_ms(fwd, loops, 1))
            t_g = min(t_g, cuda_ms(fwd_grad, loops, 1))
        ins = main_path_kkt_inputs(B, device)
        w_ms = cuda_ms(lambda: kkt_backward_fused(*ins), loops * 5, 3)
        lanes = kkt_mod.kkt_lanes(B, 3, 1, sm_count, T)  # the wrapper's pick
        out = {}
        kkt_mod.run_staged_kkt(timed_launch(kkt_mod._cuda_launcher(device, 3, 1), loops * 5, out), *ins, lanes=lanes)
        p_ms = cuda_ms(lambda: kkt_backward_plain(*ins), 1, 1)
        shared = dict(shared_C=kkt_mod.reads_in_place(ins[0]), shared_F=kkt_mod.reads_in_place(ins[2]))
        kkt_b = kkt_bound(B, 3, 1, T, clock_mhz, **shared)
        kkt_times[B] = (out["ms"], p_ms, {k: kkt_b[k] for k in ("bound_ms", "bound_by")}, lanes)
        emit(phase="time_grad", B=B, T=T, lqr_iter=LQR_ITER, card=smi,
             solve_plus_grad_ms=t_g, solve_plus_grad_per_s=B / t_g * 1e3,
             fwd_ms=t_f, fwd_per_s=B / t_f * 1e3, grad_vs_fwd_frac=t_f / t_g,
             kkt_lanes=lanes, kkt_kernel_ms=out["ms"], kkt_wrapper_ms=w_ms, kkt_plain_ms=p_ms, kkt_bound=kkt_b,
             kkt_reads_in_place=shared)

    kernels = (ilqr_solve_fused, kkt_backward_fused, ric.riccati_backward_cuda, rol.linesearch_rollout_cuda)

    def reset_counts():
        for kern in kernels:
            kern.launches = 0

    def counts() -> dict:
        torch.cuda.synchronize()
        return dict(zip(("ilqr", "kkt", "riccati", "rollout"), (kern.launches for kern in kernels)))

    # ---- 9. Riccati kernel vs plain on the card ----
    ric_err = {}
    for mode, n, m, B in [("box", BOX_N, BOX_M, b) for b in (BOX_B, B_RAGGED, B_ENSEMBLE)] + [
        ("box", 4, 1, B_RAGGED), ("free", 3, 2, B_RAGGED), ("mask", 3, 2, B_RAGGED),
    ]:
        C, c, F, _, _ = random_lqr_torch(T, B, n, m, device, seed=900 + B + 10 * n + m)
        gen = torch.Generator(device=device).manual_seed(B)
        kw = {}
        if mode == "box":
            u_hat = (torch.rand((T, B, m), generator=gen, device=device) - 0.5) * 0.6
            kw = dict(u_lower=torch.tensor(-BOX, device=device), u_upper=torch.tensor(BOX, device=device), u_hat=u_hat)
        elif mode == "mask":
            kw = dict(ctrl_mask=torch.rand((T, B, m), generator=gen, device=device) < 0.3)
        got = ric.riccati_backward_cuda(C, c, F, None, n, **kw)
        want, Quu, qu = ric.riccati_backward_plain(C, c, F, None, n, return_qp=True, **kw)
        torch.cuda.synchronize()
        agreement = riccati_agreement(f"{mode} n={n} m={m} B={B}", got, want, Quu, qu)
        emit(phase="riccati_vs_plain", mode=mode, n=n, m=m, B=B, T=T, lanes=ric.riccati_backward_cuda.last_lanes,
             staged=ric.riccati_backward_cuda.last_staged, **agreement)
        ric_err[(mode, n, m, B)] = max(agreement["max_abs_err"].values())

    # ---- 10. rollout kernel vs plain on the card ----
    rol_err = {}
    for case in ("linear_box", "linear_free", "pendulum"):
        args, kw = rollout_inputs(case, B_MAIN, 1000, device)
        got = rol.linesearch_rollout_cuda(*args, **kw)
        want = rol.linesearch_rollout_plain(*args, **kw)
        agreement = line_search_agreement(f"rollout kernel vs plain, {case}", got, want)
        emit(phase="rollout_vs_plain", case=case, B=B_MAIN, T=T, lanes=rol.linesearch_rollout_cuda.last_lanes,
             **agreement)
        rol_err[case] = agreement["traj_max_abs_where_alpha_agrees"]

    # ---- 10b. rollout lanes: each built lane count against L = 1 ----
    t0 = time.perf_counter()
    for rec in ab_rollout_lanes.run(device, ab_rollout_lanes.shapes()):
        emit(phase="rollout_lanes", card=smi, **rec)
    emit(phase="rollout_lanes_seconds", seconds=time.perf_counter() - t0)

    # ---- 11. the non-fused path: mpc_solve on LinDx ----
    # detach_unconverged off: a solved LQR "converges" by a +-1 ulp objective
    # change, which the card and the CPU may decide differently
    box_config = MPCConfig(n_state=BOX_N, n_ctrl=BOX_M, T=T, lqr_iter=10, exit_unconverged=False,
                           detach_unconverged=False)
    lqr_config = MPCConfig(n_state=LQR_N, n_ctrl=LQR_M, T=LQR_T, lqr_iter=4, exit_unconverged=False,
                           detach_unconverged=False)
    path_launches = {}
    for name, cfg, B, box in (("config2_boxddp", box_config, BOX_B, BOX), ("config1_lqr", lqr_config, LQR_B, None)):
        arrays = random_lqr_numpy(np.random.default_rng(11), cfg.T, B, cfg.n_state, cfg.n_ctrl)
        bounds = dict(u_lower=-box, u_upper=box) if box else {}

        def solve(dev, grad=False):
            leaves = [torch.tensor(a, device=dev, requires_grad=grad) for a in arrays]
            C, c, F, f, x0 = leaves
            return leaves, mpc_solve(cfg, x0, QuadCost(C, c), LinDx(F, f), **bounds)

        reset_counts()
        _, sol = solve(device)
        got = counts()
        it = int(sol.info.n_iters)
        path_launches[name] = got
        if got != dict(ilqr=0, kkt=0, riccati=it, rollout=it):
            raise AssertionError(f"{name}: launches {got} for {it} iterations")
        # the same solve on the CPU: the same objectives, scenario by scenario;
        # controls within 1e-4 on >= 95% of the scenarios. A box-QP tie
        # (phase 9) can leave a scenario at another point of the same float32
        # objective: its controls stay within 5e-3. The second witness is the
        # problem's optimum in float64 (box_lqr_optimum): every scenario's
        # controls, the card's and the CPU's, score within 1e-5 of it; the
        # scenarios where the two sides part are named with their distances
        # from it.
        _, cpu = solve("cpu")
        us_diff = (sol.us.cpu() - cpu.us).abs().amax(dim=(0, 2))
        agree = us_diff <= 1e-4
        obj_rel = float(((sol.objs.cpu() - cpu.objs).abs() / cpu.objs.abs().clamp_min(1.0)).max())
        box32 = (float(np.float32(-box)), float(np.float32(box))) if box else (-float("inf"), float("inf"))
        objective, u_opt, opt_pg = box_lqr_optimum(*(torch.tensor(a) for a in arrays), *box32)
        j_opt = objective(u_opt)
        gap = {side: (objective(s.us) - j_opt) / j_opt.abs().clamp_min(1.0) for side, s in (("card", sol), ("cpu", cpu))}
        parted = [dict(b=b, us_diff=float(us_diff[b]), card_gap=float(gap["card"][b]), cpu_gap=float(gap["cpu"][b]),
                       card_to_opt=float((sol.us[:, b].cpu().double() - u_opt[:, b]).abs().max()),
                       cpu_to_opt=float((cpu.us[:, b].double() - u_opt[:, b]).abs().max()))
                   for b in (~agree).nonzero()[:, 0].tolist()]
        witness = dict(optimum_projected_grad=opt_pg, optimum_rel_gap_max={k: float(v.max()) for k, v in gap.items()},
                       parted_scenarios=parted[:8])
        if not bool(torch.isfinite(sol.objs).all()) or obj_rel > 1e-5 or float(agree.float().mean()) < 0.95 \
                or float(us_diff.max()) > 5e-3 or opt_pg > 1e-8 or float(gap["card"].max()) > 1e-5:
            raise AssertionError(f"{name}: card vs CPU objs {obj_rel}, controls {us_diff.max()} "
                                 f"(agree on {float(agree.float().mean()):.3f}); {witness}")
        # the gradient: one KKT launch, card against CPU on the agreeing scenarios
        weights = [torch.tensor(np.random.default_rng(12).normal(size=s), dtype=torch.float32)
                   for s in ((cfg.T, B, cfg.n_state), (cfg.T, B, cfg.n_ctrl))]

        def grads(dev):
            leaves, s = solve(dev, grad=True)
            loss = (s.xs * weights[0].to(dev)).sum() + (s.us * weights[1].to(dev)).sum()
            return torch.autograd.grad(loss, leaves)

        reset_counts()
        g_card = grads(device)
        g_launches = counts()
        g_cpu = grads("cpu")
        g_rel = {}
        for k, a, b in zip(("C", "c", "F", "f", "x_init"), g_card, g_cpu):
            a, b = (a.cpu()[agree], b[agree]) if k == "x_init" else (a.cpu()[:, agree], b[:, agree])
            g_rel[k] = float((a - b).abs().max() / b.abs().max())
        emit(phase="non_fused_path", case=name, B=B, T=cfg.T, n=cfg.n_state, m=cfg.n_ctrl, box=box,
             lqr_iter=cfg.lqr_iter, n_iters=it, launches=got, converged_frac=float(sol.info.converged.float().mean()),
             clamp_frac=float(sol.info.clamp_frac.mean()), mean_obj=float(sol.objs.mean()),
             card_vs_cpu_objs_max_rel=obj_rel, card_vs_cpu_us_max_abs=float(us_diff.max()),
             us_agree_frac=float(agree.float().mean()), **witness, grad_launches=g_launches,
             grad_rel_err_on_agreeing=g_rel)
        if g_launches["kkt"] != 1 or max(g_rel.values()) > 1e-3:
            raise AssertionError(f"{name}: gradient launches {g_launches}, card vs CPU {g_rel}")

    # the goldens (tests/test_parity_golden.py's recipes) on the card
    golden_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")
    for name, seed, (gT, gB, gn, gm), kw in (
        ("lqr_unconstrained_n3m2T10B32", 1234, (10, 32, 3, 2), dict(lqr_iter=4)),
        ("boxddp_n4m1T20B16", 4321, (20, 16, 4, 1),
         dict(lqr_iter=60, eps=1e-12, not_improved_lim=10**6)),
    ):
        C, c, F, f, x0 = (torch.tensor(a, device=device) for a in random_lqr_numpy(np.random.default_rng(seed), gT, gB, gn, gm))
        bounds = dict(u_lower=-BOX, u_upper=BOX) if gm == 1 else {}
        sol = mpc_solve(MPCConfig(n_state=gn, n_ctrl=gm, T=gT, exit_unconverged=False, **kw), x0, QuadCost(C, c), LinDx(F, f), **bounds)
        err = float(np.abs(sol.us.cpu().numpy() - np.load(os.path.join(golden_dir, name + ".npz"))["us"]).max())
        emit(phase="golden", name=name, max_abs_err=err, tol=1e-4)
        if err > 1e-4:
            raise AssertionError(f"golden {name} on the card: {err}")

    # the KKT kernel against the composite backward (Riccati kernel in mask mode)
    res_C, res_c, res_F, _, _ = random_lqr_torch(T, B_MAIN, BOX_N, BOX_M, device, seed=77)
    gen = torch.Generator(device=device).manual_seed(78)
    tau = torch.randn((T, B_MAIN, BOX_N + BOX_M), generator=gen, device=device)
    tight = torch.rand((T, B_MAIN, BOX_M), generator=gen, device=device) < 0.3
    r = torch.randn((T, B_MAIN, BOX_N + BOX_M), generator=gen, device=device)
    r[..., BOX_N:] = torch.where(tight, 0.0, r[..., BOX_N:])
    kkt_ins = (res_C, res_c, res_F, r, tau, tight)
    comp_err = check_kkt("KKT kernel vs composite (4, 2)", kkt_backward_fused(*kkt_ins), kkt_backward_composite(*kkt_ins))
    emit(phase="kkt_vs_composite", n=BOX_N, m=BOX_M, B=B_MAIN, T=T, max_abs_err=comp_err, tol="1e-4 * max(1, max|composite|)")

    # the pendulum off the fused path: finite differences
    fd_config = dataclasses.replace(config, grad_method=GradMethods.FINITE_DIFF)
    prob = problem(B_MAIN, device)
    reset_counts()
    fd = mpc_solve(fd_config, prob["x_init"], cost, prob["dyn"], u_lower=-2.0, u_upper=2.0)
    fd_launches = counts()
    fd_cpu = mpc_solve(fd_config, prob["x_init"].cpu(), QuadCost(cost.C.cpu(), cost.c.cpu()),
                       PendulumDx.default(device="cpu"), u_lower=-2.0, u_upper=2.0)
    conv = (float(fd.info.converged.float().mean()), float(fd_cpu.info.converged.float().mean()))
    objm = (float(fd.objs.mean()), float(fd_cpu.objs.mean()))
    emit(phase="pendulum_finite_diff", B=B_MAIN, T=T, lqr_iter=LQR_ITER, launches=fd_launches,
         n_iters=int(fd.info.n_iters), converged_frac=conv[0], cpu_converged_frac=conv[1],
         mean_obj=objm[0], cpu_mean_obj=objm[1])
    it = int(fd.info.n_iters)
    if fd_launches != dict(ilqr=0, kkt=0, riccati=it, rollout=it):
        raise AssertionError(f"pendulum FINITE_DIFF launches {fd_launches} for {it} iterations")
    if abs(conv[0] - conv[1]) > 0.05 or abs(objm[0] - objm[1]) > 1e-2 * abs(objm[1]):
        raise AssertionError(f"pendulum FINITE_DIFF, card vs CPU: converged {conv}, mean obj {objm}")

    # ---- 12. time: config 2 at three batch sizes ----
    flag = torch.zeros(B_MAIN, dtype=torch.bool, device=device)
    read_ms = cuda_ms(lambda: bool(flag.all()), 50, 3)  # one read of a done mask, alone
    nf_times = {}
    for B, loops in ((BOX_B, 20), (4096, 20), (B_ENSEMBLE, 5)):
        C, c, F, f, x0 = random_lqr_torch(T, B, BOX_N, BOX_M, device, seed=2000 + B)
        solve = lambda: mpc_solve(box_config, x0, QuadCost(C, c), LinDx(F, f), u_lower=-BOX, u_upper=BOX)  # noqa: E731
        with torch.no_grad():
            it = int(solve().info.n_iters)
            solve_ms = cuda_ms(solve, loops, 3)
        # the first iteration's inputs, as lqr_step builds them
        lo, hi = torch.tensor(-BOX, device=device), torch.tensor(BOX, device=device)
        u_hat = torch.zeros((T, B, BOX_M), device=device)
        x_hat, _ = lqr_rollout(x0, F, f, torch.zeros((T, B, BOX_M, BOX_N), device=device), u_hat)
        c_delta = c + bmv(C, torch.cat([x_hat, u_hat], -1))
        box = dict(u_lower=lo, u_upper=hi, u_hat=u_hat)
        ric_t, rol_t = {}, {}
        ric_launch = ric._cuda_launcher(device, BOX_N, BOX_M)
        ric_lanes = ric.riccati_lanes(B, BOX_N, BOX_M, ric.BOX, sm_count, T)  # the wrapper's pick
        ric.run_staged_riccati(timed_launch(ric_launch, loops, ric_t), C, c_delta, F, None, BOX_N, lanes=ric_lanes,
                               **box)
        res = ric.riccati_backward_cuda(C, c_delta, F, None, BOX_N, **box)
        ls_args = (x0, C, c, F, f, res.K, res.k, x_hat, u_hat)
        rol_launch = rol._cuda_launcher(device, BOX_N, BOX_M, None)
        rol_lanes = rol.rollout_lanes(B, None, sm_count, T)  # the wrapper's pick
        rol_res = rol.run_staged_rollout(timed_launch(rol_launch, loops, rol_t), *ls_args, u_lower=lo, u_upper=hi,
                                         lanes=rol_lanes)
        ric_wrap = cuda_ms(lambda: ric.riccati_backward_cuda(C, c_delta, F, None, BOX_N, **box), loops, 3)
        rol_wrap = cuda_ms(lambda: rol.linesearch_rollout_cuda(*ls_args, u_lower=lo, u_upper=hi), loops, 3)
        ric_stage = cuda_ms(lambda: ric.run_staged_riccati(lambda *a: None, C, c_delta, F, None, BOX_N, **box), loops, 3)
        rol_stage = cuda_ms(lambda: rol.run_staged_rollout(lambda *a: None, *ls_args, u_lower=lo, u_upper=hi), loops, 3)
        ric_plain = cuda_ms(lambda: ric.riccati_backward_plain(C, c_delta, F, None, BOX_N, **box), 1, 1)
        rol_plain = cuda_ms(lambda: rol.linesearch_rollout_plain(*ls_args, u_lower=lo, u_upper=hi), 1, 1)
        steps = T * B
        ric_bound = riccati_bound(B, BOX_N, BOX_M, "box", T, clock_mhz)
        rol_bound = rollout_bound(rol_res, B, BOX_N, BOX_M, T, clock_mhz, box_config.max_linesearch_iter,
                                  box_config.linesearch_decay)
        nf_times[B] = dict(ric=(ric_t["ms"], ric_plain, ric_bound), rol=(rol_t["ms"], rol_plain, rol_bound),
                           rol_lanes=rol_lanes, ric_lanes=ric_lanes)
        emit(phase="time_non_fused", B=B, T=T, n=BOX_N, m=BOX_M, lqr_iter=box_config.lqr_iter, n_iters=it,
             card=smi, mpc_solve_ms=solve_ms, solves_per_s=B / solve_ms * 1e3,
             riccati_lanes=ric_lanes, riccati_kernel_ms=ric_t["ms"], riccati_wrapper_ms=ric_wrap,
             riccati_staging_ms=ric_stage,
             riccati_plain_ms=ric_plain, riccati_bound=ric_bound,
             rollout_lanes=rol_lanes, rollout_kernel_ms=rol_t["ms"], rollout_wrapper_ms=rol_wrap,
             rollout_staging_ms=rol_stage,
             rollout_plain_ms=rol_plain, rollout_bound=rol_bound,
             done_read_ms=read_ms, host_and_glue_ms=solve_ms - it * (ric_wrap + rol_wrap))

    for B, b in ilqr_bounds.items():
        emit(phase="ilqr_bound", B=B, max_sm_clock_mhz=clock_mhz, **b)

    twins = long_horizon(device, smi, clock_mhz)
    chain = riccati_chain(device, smi, times[B_MAIN][0] / int(results[B_MAIN][0].n_iters.max()))
    learned = learned_dynamics(device, smi, clock_mhz)
    probe_row = data_parallel(device, smi)
    slice_rows = variants_slice(device, smi, clock_mhz)
    kkt_lanes_ab(device, smi)
    zoo_records = zoo(device, smi, clock_mhz)
    receding_records = receding(device, smi, clock_mhz)
    examples(device, smi, clock_mhz)
    aot_phase(device, smi)
    one_robot_records = one_robot(device, smi, clock_mhz)

    print(smi, flush=True)
    emit(kernels=[
        dict(
            name="ilqr_solve_fused",
            route="cuda",
            source="diffmpc_tpu_torch/csrc/ilqr.cu",
            replaces="diffmpc_tpu/ops/pallas/ilqr.py:458",
            launches=launches,
            max_abs_err=results[B_MAIN][1]["us_max_abs"],
            ms=times[B_MAIN][0],
            plain_ms=times[B_MAIN][1],
            bound_ms=ilqr_bounds[B_MAIN]["bound_ms"],
            bound_by=ilqr_bounds[B_MAIN]["bound_by"],
            library_ms=None,
            lanes=times[B_MAIN][2],
        ),
        dict(
            name="kkt_backward_fused",
            route="cuda",
            source="diffmpc_tpu_torch/csrc/kkt.cu",
            replaces="diffmpc_tpu/ops/pallas/kkt.py:245",
            launches=train_launches[1],
            max_abs_err=kkt_err,
            ms=kkt_times[B_MAIN][0],
            plain_ms=kkt_times[B_MAIN][1],
            **kkt_times[B_MAIN][2],
            library_ms=None,
            lanes=kkt_times[B_MAIN][3],
        ),
        dict(
            name="riccati_backward_pallas",
            route="cuda",
            source="diffmpc_tpu_torch/csrc/riccati.cu",
            replaces="diffmpc_tpu/ops/pallas/riccati.py:696",
            launches=path_launches["config2_boxddp"]["riccati"],
            max_abs_err=ric_err[("box", BOX_N, BOX_M, BOX_B)],
            ms=nf_times[BOX_B]["ric"][0],
            plain_ms=nf_times[BOX_B]["ric"][1],
            **{k: nf_times[BOX_B]["ric"][2][k] for k in ("bound_ms", "bound_by")},
            library_ms=None,
            lanes=nf_times[BOX_B]["ric_lanes"],
        ),
        dict(
            name="linesearch_rollout_pallas",
            route="cuda",
            source="diffmpc_tpu_torch/csrc/rollout.cu",
            replaces="diffmpc_tpu/ops/pallas/rollout.py:180",
            launches=path_launches["config2_boxddp"]["rollout"],
            max_abs_err=rol_err["linear_box"],
            ms=nf_times[BOX_B]["rol"][0],
            plain_ms=nf_times[BOX_B]["rol"][1],
            **{k: nf_times[BOX_B]["rol"][2][k] for k in ("bound_ms", "bound_by")},
            library_ms=None,
            lanes=nf_times[BOX_B]["rol_lanes"],
        ),
        *twins,
        *chain,
        *learned,
        probe_row,
        *slice_rows,
        *zoo_records,
        *receding_records,
        *one_robot_records,
    ])
    emit(ok=True, device=dict(platform="gpu", kind=kind, count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
