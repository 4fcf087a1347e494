#!/usr/bin/env python3
"""Smoke test and measurement of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA device and the CUDA
toolkit (``nvcc``).  Phases, each of which fails the run when it fails:

1. Environment: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions, both TF32 flags (the port must leave TF32 off).
2. Build every kernel source under ``rxinfer_tpu_torch/csrc`` with ``nvcc``
   for sm_90a, all builds started together; print the ``-Xptxas -v`` lines.
3. Kernels vs plain versions on the card, on the same CUDA tensors at
   several shapes: the smoother kernels K1/K2 against
   ``fused_forward_reference`` / ``fused_backward_reference`` (RTOL/ATOL),
   at shapes that take one time block and shapes that take many (the most
   the wrapper's rule gives, and a ragged last block), and the HMM
   forward-backward kernels K4/K5 (both ``per_step_xi`` variants) against
   ``fb_forward_reference`` / ``fb_backward_reference`` at the wrapper's
   marginal tile (FB_RTOL/FB_ATOL; shapes with one tile, many tiles, ragged
   staged and marginal tiles, and a large batch), xi_sum bit-identical over
   repeated calls, plus sampled chains against a float64 numpy
   forward-backward (FB_ORACLE_TOL).  The plain versions of K1/K2 are timed
   by their one call on the card at the first check shape and run on the
   host (CPU copies of the same inputs) at the others.  The K4/K5 checks
   and phase 6's run in a second process, phase 10 (a)'s in a third, while
   this one checks K1/K2: the plain versions are host-bound loops, seconds
   a call.  Each check process prints when it ended (``[time]``).
4. LGSSM path at full width: ``rxinfer_tpu_torch.batched_program`` on
   ``zoo.lgssm`` with B=1024 chains, T=10,000 steps, d=4 (the constants of
   the JAX package's bench), y from a numpy seed.  Checks that the plan runs
   on the CUDA kernels with exactly one K1 and one K2 launch per call, holds
   sampled chains against a float64 numpy RTS smoother, runs
   ``infer_batched`` at a smaller batch, times the program and each stage
   with CUDA events, and profiles one program call (device busy time, idle
   share, each kernel's device time; the fold, carry and replay passes of
   K1 and K2 apart), at the wrapper's own number of time blocks.
5. HMM path at the JAX package's bench size: ``batched_program`` on
   ``zoo.hmm(3, 3)`` with B=256 chains, T=200 steps, 20 VMP iterations, y
   simulated from a numpy seed as ``bench.py`` does.  Checks that the chain
   runs on the CUDA forward-backward kernels with exactly 20 K4 and 20 K5
   launches per call, holds sampled chains against a float64 numpy VMP
   (HMM_ORACLE_TOL), holds K4/K5 against their plain versions on the
   inputs of the path's last sweep (FB_RTOL/FB_ATOL), checks
   ``infer_batched`` against ``batched_program`` on the same rows and those
   rows against the full batch (INFER_TOL), times the program and its
   stages with CUDA events, and profiles one program call as in phase 4
   (K5's beta, marginal and xi_sum passes apart).  Then K4 and K5 alone at
   the path's shape, beside the SM clock sampled meanwhile.  The plain
   versions are timed by their one call on the path's inputs.
6. (Run beside phase 3.) Filter and quantization kernels vs plain
   versions on the card: the streaming filter kernel K3 against
   ``fused_filter_reference`` at several (B, T, d, dy) (RTOL/ATOL), a
   ragged last warp at path A's width included, and sampled chains
   against a float64 filter; the quantize kernels K6/K7 against their
   plain versions (payload bytes and scales must be EQUAL, a zero row
   included) at
   QUANT_CHECK_SHAPES, which take each of their layouts
   (``pick_quant_layout``: narrow, wide, general) and a view that starts 4
   bytes into its storage; the dequantize + product kernel K8 on both
   payload types at DEQUANT_CHECK_SHAPES, which take each of its layouts
   (``pick_dequant_layout``: vector, general), a payload view that
   starts 4 bytes into its storage, and W of 64 KB, 200 KB (whole in
   shared memory) and 240 KB (row tiles, ``dequant_tiles``); outputs must
   be EQUAL.
7. Path A, continuous-batching filter at full width:
   ``parallel.filtering.make_sharded_filtering(None, ..., fused=True)`` over
   a (T, B, dy) stream of B=10,000 chains, T=200 steps, d=dy=4 with the
   LGSSM constants.  One K3 launch per call; final state and sampled means
   against the float64 filter (ORACLE_TOL); the call and K3 alone (beside
   the SM clock) timed, K3's plain version by its one call on the path's
   inputs; one call profiled (K3's cycles a step).
8. Path B, quantized ingest.  (i) The LGSSM program of phase 4 with
   ``options={"observation_dtype": "int8" | "float8_e4m3fn"}`` at 1 and 10
   iterations beside the float32 program: one K6 or K7 launch per call
   whatever the iterations, posterior means within INT8_LEVEL / FP8_LEVEL of
   the float32 run's and equal (DEQ_TOL) to the float32 program run on the
   dequantized observations.  (ii) ``quantized_evidence`` and
   ``quantized_evidence_fp8`` at 2^21 rows, dy=16 -> dx=4: one K6 or K7 and
   one K8 launch per call, the result against the float32 product.  Both
   time K6/K7 alone with the layout their rows took, beside a device copy
   of the same rows (``torch.empty_like(x).copy_(x)``) as a yardstick of
   the bandwidth the card reaches; (ii) times K8 alone with its layout,
   beside a device copy of its payload and of its output.
9. The single-dataset ``infer`` and the unfused chain path, which launch
   no kernel (every kernel module's launch count must stay at zero):
   (a) ``infer`` on ``zoo.lgssm`` with one dataset of T=10,000, d=4 (the
   JAX package's single-chain row): the float64 RTS (ORACLE_TOL), the
   median of 2 calls (CUDA events), updates/s = 3 T / t, the device busy
   and idle share of one profiled call; (b) ``infer`` on ``zoo.hmm(3, 3)``,
   one dataset of T=200, 20 iterations, phase 5's initialization: the
   float64 VMP (HMM_ORACLE_TOL) and its time; (c) phase 4's cell with
   ``options={"fused_kernels": False}``: the plan report, the posteriors
   against the fused program's (ORACLE_TOL), its checked call's time beside
   the fused program's phase 4 time, and its peak device memory; (d) ``infer_batched`` on 64
   LGSSM chains of T=10,000 with 10% of the steps NaN: the plan report and
   sampled chains against the float64 RTS with no evidence at the missing
   steps (ORACLE_TOL).
10. The dynamic-precision tier: K1/K2 with per-chain W and/or Q (V1).
   (a) (In a process of its own beside phase 3.) The per-chain kernels
   against their plain versions (RTOL/ATOL) at DYN_CHECK_SHAPES, many time blocks
   and one, d = 1 to 8: K1 with W per chain, Q per chain and both, K2 with
   Q per chain (with W alone per chain K2 is the static one, as in the JAX
   package); the plain versions on the host, the modes' chains side by
   side in one call.
   (b) ``lgssm_wtau`` (bench.py:291-312: the LGSSM with an unknown
   observation precision Wr ~ Wishart(d + 1, I)) through
   ``batched_program`` at B=1024, T=10,000, d=4, 2 iterations, y from a
   numpy seed: the plan report (``dynamic == ["W"]``, ``w_linear``), exactly
   2 per-chain K1 and 2 static K2 launches a call and no other,
   sampled chains against a float64 mean-field VMP (means ORACLE_TOL, the
   Wishart relative WISHART_REL_TOL), the median of 2 calls, updates/s =
   2 * 3 T B / t (bench.py:312), the sweep's stages alone, the device
   busy and idle share of one profiled call, and K1 with per-chain W
   against its plain version (on the host) on the path's own inputs over
   its first 2112 steps, which take the path's 66 time blocks (the plain
   version's one call on the card over 64 steps is its time).  (c) The
   same model at B=256, T=2048 against ``fused_kernels=False`` (max |mean|
   difference within ORACLE_TOL), both timed.  (d) The W-and-Q model of
   tests/engine/test_fused_dynamic.py at (64, 1056, 2), 33 time blocks:
   per-chain W and Q launches, against its unfused program, one profiled
   call, and K1 / K2 with per-chain W and Q against their plain versions
   on the path's own inputs (their one call on the card is their time).
11. One JSON line listing every ported kernel with its launches on its path,
   error against its plain version, time (alone, CUDA events over launches
   back to back; ``ms_in_path``: device time per launch inside the
   path's call, ``torch.profiler``), bound and plain time, and its
   launches on phase 12's paths (``launches_fe_paths``).
12. (Before the JSON line.) The Bethe free energy, ``free_energy=True``, on
   the paths above, each program timed beside the same program without
   it: (a) phase 4's LGSSM cell: one K1 and one K2 launch a call, FE ==
   -log Z (float64 prediction-error filter) on sampled chains
   (FE_LOGZ_TOL), the FE stage alone and the peak device memory with and
   without FE; (b) phase 5's HMM cell: 20 K4 and 20 K5 launches, the FE of
   every sweep against a float64 structured VMP's Bethe FE on sampled
   chains (FE_HMM_TOL) and non-increasing (FE_MONOTONE_TOL); (c)
   ``lgssm_wtau`` at phase 10 (c)'s shape: the fused FE against
   ``fused_kernels=False``'s (FE_PATH_TOL); (d) phase 8 (i)'s cell on int8
   / fp8 observations: one K6 / K7 launch, FE against the float32
   program's on the dequantized observations (FE_PATH_TOL); (e) BASELINE
   config 2: ``zoo.beta_bernoulli(2, 7)`` over 4096 datasets of 5000 flips
   against the closed form (FE_BB_TOL), row 0 (3743 successes) against the
   reference's 2828.0533343622483 (FE_REF_TOL), and
   ``zoo.gaussian_unknown_mean_precision()`` over 4096 datasets of 1000
   points, 10 iterations, against a float64 mean-field VMP's FE
   (FE_GAUSS_TOL).  Results on ``[fe]`` lines.
13. (Before the JSON line.) BASELINE config 4, the Gaussian mixture of
   bench.py:487-508: ``zoo.gmm(2, [-2, 2])`` through ``batched_program`` on
   1000 datasets of 200 points, 20 iterations, that row's initialization,
   with and without ``free_energy=True``: no kernel launch; sampled rows
   against a float64 mean-field VMP in the port's group order (GMM_TOL:
   the posterior parameters of m0, m1, w0, w1 and pi, z's probabilities and
   the FE of every sweep) and the FE non-increasing (FE_MONOTONE_TOL);
   each program's median of 3 calls, updates/s = B * iterations * (N + 5)
   / t (bench.py:508), the device busy and idle share of one profiled call
   without FE, peak memory.  ``[gmm]`` lines.
14. BASELINE config 5's engine (bench.py:401-485): the tick model and
   autoupdates of bench.py:446-460 with ``batched=True`` on 10,000 chains
   x 200 ticks, d = dy = 4, y from a numpy seed staged on the card: (a)
   ``run_offline`` through the fused stream plan (which must engage), (b)
   the generic tick (``returnvars="x"``), (c) ``start(datastream)`` over
   20 ticks of chain 0, one stream.  No kernel launch; (a) and (b) against
   a float64 filter with the plan's tick order (posterior, then
   prediction) on sampled chains and against each other, (c) against (a)'s
   first ticks and its events in the reference order (STREAM_TOL); (a) and
   (b) per ``run_offline`` call ((a) the median of 3, (b) its checked
   call), updates/s
   = B * T / t (bench.py:473, 485), device busy and idle share (from a
   call over the first STREAM_PROFILE_T ticks), peak memory; path A's K3
   call (phase 7) beside them for scale.  ``[stream]`` lines.

15. K1/K2 at state dims 9..16 (the wide kernels of
   ``csrc/fused_smoother_wide.cu``, V3) and with bf16 moments (V2).  (a)
   (The wide checks and the bf16 checks each in a process of their own
   beside phase 3.) The wide kernels against their
   plain version at WIDE_CHECK_SHAPES (d = 9, 12, 16; static and per-chain
   W and Q; float32 and bf16 moments; an ill-conditioned case at d = 16,
   P0 = 1e6 I; RTOL/ATOL, bf16 moments BF16_RTOL / BF16_ATOL), and the bf16
   register kernels' fold, carry and replay
   passes against the plain version of the same passes at every
   CHECK_SHAPES shape and, with W and Q per chain, at BF16_DYN_SHAPES;
   each launch counted under its key.  (b) bench.py:612-622's d16 fused
   row: ``gen16`` through ``batched_program`` at B=1024, T=2048, d=16, one
   iteration: exactly one wide K1 and one wide K2 launch a call, sampled
   chains against bench.py:650-670's float64 RTS (ORACLE_TOL), the fused
   program against ``fused_kernels=False`` at D16_SMALL (ORACLE_TOL), the
   median of 3 calls, updates/s = 3 T B / t (bench.py:622), K1 and K2
   alone and in one profiled call, each with its cycles a step at the
   sampled SM clock, its bound with the tensor cores' products at 3xTF32
   and at float32 only, its warps an SM and chains a warp, peak memory.
   (c) bench.py:240-251's
   bf16 row: phase 4's cell with ``options={"fused_moment_dtype":
   "bfloat16"}``: exactly one bf16 K1 and one bf16 K2 launch a call, the
   posteriors and the smoother's outputs against the float32 program's at
   the JAX package's tolerances (BF16_ROW_TOL), both programs timed in
   turns, each kernel alone and in one profiled call.  ``[wide check]``,
   ``[bf16 check]``, ``[d16]`` and ``[bf16]`` lines; four more rows in the
   ``kernels`` line (the wide K1 / K2, the bf16 K1 / K2), each with the
   errors of its checked variants.
16. K4/K5 above eight states (``csrc/fused_fb_wide.cu``, V4, redesigned
   for K <= 16: ``fused_fb_batched`` there is the serial launch of both
   recursions, ``fb_serial_wide``, then the marginal launch,
   ``fb_marginals_wide``) and K3 at d 9..16 or dy > 8
   (``csrc/fused_filter_wide.cu``, V5).  (a) and (c) (in a fourth process
   beside phase 3): the wide K4/K5 wrappers and the two calls against their
   plain versions at FB_WIDE_CHECK_SHAPES (K = 9 to 240: the half-warp
   design, registers, a table in shared memory and one read from device
   memory; both ``per_step_xi`` variants; FB_RTOL/FB_ATOL; xi_sum
   bit-identical over calls; the serial launch equal bit for bit to each
   recursion launched alone; sampled chains against the float64
   forward-backward), the wide K3 at FILTER_WIDE_CHECK_SHAPES (RTOL/ATOL,
   a vague prior among them; sampled chains against the float64 filter).
   (b) ``zoo.hmm(16, 8)``
   through ``batched_program`` at B=1024, T=1000, 20 iterations: the plan
   fused on the CUDA route, exactly 20 serial and 20 marginal launches a
   call and no other, sampled chains against the float64 VMP
   (HMM_ORACLE_TOL), the two calls against their plain versions on the
   last sweep's inputs, one call with ``free_energy=True`` against the
   float64 structured VMP's FE (FE_HMM_TOL), the median of 2 calls,
   updates/s = B * iterations * (T + 2), one profiled call (each pass's
   device ms in the program), each call, each recursion and each wrapper
   alone (cycles a step), the marginal tile and occupancy.  (d) path A at
   d = dy = 16 (phase 7's B and T, ``gen16``'s constants): one wide K3
   launch, the float64 filter (ORACLE_TOL), K3 against its plain version
   over the first 4 steps (that call is the plain version's time), the
   call and K3 alone.  ``[hmm16]`` and ``[filter16]`` lines; three more
   rows in the ``kernels`` line (the serial and marginal launches, with
   their ``ptxas`` lines, and the wide K3 with both bounds, its registers,
   spills and warps an SM).

17. K3 above d = 16 (``csrc/fused_filter_warp.cu``, V6: a chain a warp;
   to d = 32 the tensor-core tier, past it the sweep tiers).
   (a) (In a seventh process beside phase 3.) Each check shape's d on the
   tier ``warp_plan`` should give it, and the warp K3 against its plain
   version at FILTER_WARP_CHECK_SHAPES (d = 17 with a ragged block, d = 24,
   d = 32 with two observation chunks, d = 33, d = 64; RTOL/ATOL; sampled
   chains of the first against the float64 filter) and at FILTER_WARP_TIER_SHAPES
   (d = 100: F, Q, W in device memory; d = 176: each chain's matrices in a
   device scratch) against the float64 filter on every chain (RTOL/ATOL),
   each shape one ``fused_filter_warp`` launch.  (b) Path A at d = dy = 32
   (phase 7's B and T, ``lgssm_constants(32)``): one warp K3 launch, the
   float64 filter (ORACLE_TOL), K3 against its plain version over the first
   2 steps (that call is the plain version's time), the call and K3 alone,
   cycles a step, one profiled call; the tensor-core tier's warps an SM and
   its ``ptxas`` lines (it must not spill).  ``[filter32]`` lines; one more
   row in the ``kernels`` line, with the kernel's ``ptxas`` lines, its plans
   and the tier each checked d took.  Phases 15 (a) and 17 (a) also hold
   the wide K1 and K2 (d = 16, a rank-one W) and the warp K3's tensor-core
   tier (d = 17, 24, 32) on chains with one observation over ONE_OBS_T
   steps against the float64 RTS / filter at ORACLE_TOL (ROADMAP C7: a
   kernel that does not keep P symmetric drifts to NaN there).
18. ``shared=`` pooling and the generic mixture.  (a) Phase 10 (b)'s
   ``lgssm_wtau`` cell with ``shared=("Wr",)``: the plan report
   (``dynamic == ["W"]``), exactly 2 per-chain K1 and 2 K2 launches a call,
   the pooled Wishart (nu = nu0 + B T in every row) and sampled chains
   against a float64 pooled mean-field VMP over all chains (run in a check
   process while phases 4-17 run; means ORACLE_TOL, the Wishart relative
   WISHART_REL_TOL), the median of 2 calls, updates/s = 2 * 3 T B / t,
   phase 10 (b)'s unpooled call beside it, one profiled call.  (b) The same
   through ``infer_batched`` beyond a device budget of 4 chunks of 256:
   each chunk's launches, against (a) at SHARED_CHUNK_TOL relative, timed.
   (c) The pooled process-noise model (``hier``, d = 2) at (1024, 2048)
   with ``free_energy=True``: per-chain Q launches, the pooled FE
   (iterations,) non-increasing; at (64, 256) against the port's own
   program on the CPU (in that check process) at HIER_TOL relative.  (d) A
   generic two-component ``Mixture`` over 1000 datasets with
   ``annotations=LogScaleAnnotations()`` and ``free_energy=True``: each
   dataset's log-scale and -FE against its float64 closed-form evidence
   (MIX_TOL), timed once.  ``[shared]``, ``[hier]`` and ``[mixture]`` lines;
   every row of the ``kernels`` line gets its launches on these paths
   (``launches_shared_paths``).

19. The autoregressive and HGF chains and the dot-product mean (ROADMAP
   A6a), each on the batch-major scan path: the JAX package's planner
   leaves these chains on its XLA scans, and the plan report must give its
   reasons; no kernel may launch.  Each cell, its program built first: its
   first call timed (CUDA events) with its peak memory, one profiled call
   (device busy, idle share), updates/s.  (a) ``zoo.latent_ar(8)``
   through ``infer_batched``: 256 series of 250 steps of one stable AR(8),
   10 sweeps with the free energy, theta ~ N(0, I), gamma ~ Gamma(1, 1);
   four sampled series against ``lar_vmp_float64`` (run in a check process
   while phases 4-18 run) at LAR_TOL relative (means of s, theta, gamma and the
   free energy after every sweep); updates/s = 3 T B a sweep.  (b)
   ``zoo.hgf()`` over 256 datasets of 500 steps (``simulate_hgf``, seeded
   by dataset), 20 sweeps with the free energy, z ~ N(0, 5): four sampled
   datasets against the port's own run of them on the CPU (that check
   process) at HGF_TOL relative, and on each the accuracy checks of
   ``tests/models/test_hgf.py`` that the reference meets on these data
   (``hgf_accuracy``; the z envelopes equal to the CPU run's instead);
   every free energy finite.  (c)
   ``zoo.linear_regression(32)`` over 1024 datasets of 500 rows, one sweep
   with the free energy: theta's posterior against the float64 closed form
   (ORACLE_TOL) and the free energy against -log p(y) (FE_LOGZ_TOL);
   updates/s = B N.  ``[lar]``, ``[hgf]`` and ``[linreg]`` lines, each with
   the card's name and power limit.
20. The nonlinear nodes (``rules/delta.py``, Probit, SoftDot) and the
   strict-fp32 row, every kernel count at zero in (a)-(d):
   (a) a range-bearing tracker fleet, 1024 tracks of 1000 steps (d = 4
   constant velocity, ``rb_tracks``), 10 sweeps with the free energy under
   ``Linearization()``: the chain on the scans with the JAX planner's
   reason; (a0) the same fleet with a linear delta (the position) against
   the float64 RTS smoother (RB_ORACLE_TOL); (a1) eight tracks against the
   port's run of them on the CPU (RB_TOL; the host work of (a)-(d) runs in
   a check process once one of phase 3's is free);
   (a2) the smoothed positions' RMSE, in units of the measurement noise's
   scale at each range, under 1 (the tracks recede at 5-10 m/s, clear of
   the sensor and of the bearing's +-pi cut: ``rb_tracks``);
   call ms, updates/s = 3 T B a sweep, device busy and idle, device kernels
   a call, peak memory.  (b) The same under ``Unscented(alpha=1)``.  (c)
   The probit model over 1024 datasets of 500 rows and the SoftDot
   regression over 1024 datasets of 300 rows, 20 sweeps with the free
   energy: the tests' accuracy checks on every dataset, eight against the
   CPU.  (d) ``tests/models/test_cvi_dynamics.py``'s model
   over 256 datasets of 50 steps, 600 draws, 150 sweeps, one timed call:
   its checks on its own dataset; four datasets against the CPU run with
   the card's draws, each of the first 30 sweeps (CVI_TOL) and the average
   of the last two (CVI_TOL or CVI_ULP_FACTOR times the CPU's largest move
   under a one-ulp change of the observations).  (e) Phase 4's LGSSM cell, one iteration,
   with ``options={"matmul_precision": "highest"}`` beside the default
   program: one K1 and one K2 launch each, equal within STRICT_TOL, the
   float64 RTS on sampled chains.  ``[nl]`` lines.
21. Constraints (ROADMAP A6c, A6g): (a) the online HGF of
   tests/models/test_hgf_streaming.py over HGFS_B streams under the
   reference constraint, against the port on the CPU (HGFS_TOL), the
   reference's checks and the fleet's 3 / 6 sd shares, bit-equal without
   the constraint; (b) ``ProjectedTo("beta")`` over PROJ_B datasets
   against quadrature (PROJ_TOL); (c) ``MeanField()`` on phase 12 (e)'s
   Gaussian cell against its float64 mean-field VMP (MF_TOL) and on the
   LGSSM cell (one K1 and one K2 launch, bit-equal).  ``[constraints]``
   lines.
22. The rest of the node library (ROADMAP A6d) on plain groups, every
   cell through ``infer_batched`` with the free energy and every kernel's
   launch count at zero: (a) counts: rate ~ Gamma(shape=2, scale=5), y ~
   Poisson(rate) over CNT_B x CNT_N; p ~ Beta(1, 1), y ~ Binomial(n, p)
   over BIN_B x BIN_N; p ~ Dirichlet(ones(MULT_K)), y ~ Multinomial(n, p)
   over MULT_B x MULT_N; each against its closed-form posterior and -log
   p(y); (b) a noise level, mu ~ N(0, 100), v ~ InverseGamma(2, 1) over
   NOISE_B x NOISE_N, NOISE_IT sweeps, against a float64 VMP of the port's
   schedule (the free energy of every sweep); (c) covariances at d = COV_D
   over COV_B x COV_N: InverseWishart with m known (closed form IW(nu + N,
   Psi + S), -log p(y)), m ~ MvNormal(0, 100 I) (a float64 VMP, COV_IT
   sweeps), and MvNormal(mean=m, gamma=g), g ~ Gamma(1, 1) (a float64
   VMP); (d) sums: y ~ N(a + b, 0.25) over SUM_B datasets of one reading
   (a tree: the closed-form marginals) and of SUM_LOOPY_N (loopy, SUM_IT
   sweeps: a float64 BP with the port's cavity store, and E[a + b] against
   its conjugate posterior at A6D_SUM_GAP), s = lincomb(A x + B u), y ~
   MvNormal(s, R) at d = LC_D over LC_B (the closed-form posterior and -log
   p(y)).  All at A6D_TOL relative; the float64 references in a check
   process (``slice23_checks``).  Each cell: call ms, updates/s, device
   busy and idle, device kernels a call, peak memory.  ``[a6d]`` lines,
   and ``launches_phase22`` on every row of the ``kernels`` line.
23. Grid data and grid latents over nested plates, the logic, Polya and
   continuous-transition nodes with ``tie`` (ROADMAP A6e) and the affine
   custom-transition pair of the free energy (A6f), on plain groups, every
   cell with the free energy and every kernel's launch count at zero: (a1)
   z[i, j] ~ N(0, 4), y[i, j] ~ N(z[i, j], 1) over GRID_N x GRID_M on
   ``infer`` against the closed-form posteriors and -log Z; (a2) the grid
   hierarchy of tests/models/test_grid_latents.py over GH_B regions of GH_N
   x GH_M with GH_NAN of y missing, GH_IT sweeps, against a float64 run of
   the port's updates (the free energy of every sweep); (a3) the three-axis
   Beta-Bernoulli over CUBE_SHAPE on ``infer`` (closed form); (b)
   BinomialPolya over PG_B x PG_N rows at d = PG_D, n = PG_TRIALS, and the
   two-class MultinomialPolya over MPG_B x PG_N, PG_IT sweeps, against a
   float64 run of the same Polya-Gamma updates (every sweep's free energy);
   (c) ContinuousTransition over CT_B x CT_N at (dy, dx) = (CT_DY, CT_DX):
   W known (the closed-form posterior of vec(A) and -log p(y)) and W ~
   Wishart(dy + 2, I) (a float64 VMP); (d) the reference's fault tree with
   ``tie`` over LOGIC_B trees and the noisy-OR over LOGIC_B copies, against
   float64 enumeration (marginals and -log Z); (e) a user node's drifting
   walk over WALK_B x WALK_T and its vector form at d = MVWALK_D over
   MVWALK_B, against the float64 RTS smoother and Kalman -log Z.  All at
   A6E_TOL relative; the float64 references in a check process
   (``slice24_checks``).  Each cell: call ms, updates/s, device busy and
   idle, device kernels a call, peak memory.  ``[a6e]`` lines, and
   ``launches_phase23`` on every row of the ``kernels`` line.
24. Submodels, folded data, node contraction (ROADMAP A6i), sessions,
   checkpoints, ``trace_messages``, ``profile_trace`` and early stopping
   (A6h), the streaming engine's ``meta=`` / ``annotations=`` /
   ``postprocess=`` (A4c): (a) phase 4's LGSSM cell written as submodels
   inside ``scope("track")`` through ``infer_batched`` with the free
   energy: one K1 and one K2 launch, posteriors and free energy bit-equal
   to ``zoo.lgssm``'s, the same ``trace_messages`` records, a
   ``profile_trace`` Chrome trace naming the smoother kernels; (b) x ~
   N(a + b, 1) with data a, b (folded), y over FOLD_N days, FOLD_B stores,
   against the float64 closed form (FOLD_TOL), new b reusing the program;
   (c) the gcv_sub chain of tests/models/test_node_contraction.py over
   GCVC_B datasets, contracted against its body (the JAX test's bounds),
   against the port on the CPU (GCVC_TOL), and on ``infer`` with
   ``allow_node_contraction=True`` over the JAX test's series, the free
   energy non-increasing;
   (d1) config 2's Beta-Bernoulli as CTR_B click-through streams over CTR_T
   ticks with annotations, the free energy and a postprocess: each tick's
   per-stream log-scale against the float64 log predictive (LOGSCALE_TOL);
   (d2) phase 21 (a)'s online HGF over HGFM_T ticks with meta= against the
   port on the CPU; (e) phase 14's engine checkpointed half-way
   (``save_checkpoint`` / ``load_checkpoint`` onto the card) and resumed
   bit-equal, and an ``infer`` stopped by ``StopEarlyIterationStrategy``
   at the CPU's sweep; the default session's counts.  The references in a
   check process (``slice25_checks``).  ``[s24]`` lines, and
   ``launches_phase24`` on every row of the ``kernels`` line.
25. The mesh entry points (ROADMAP A7b) on a one-rank NCCL world
   (``one_rank_world``: a ``file://`` rendezvous under a temporary
   directory, destroyed at the end of the phase whatever happens), each
   against the same call without a mesh: (a1) ``infer_batched(mesh=dp)``
   on phase 4's cell with the free energy: one K1 and one K2 launch,
   posteriors and free energy bit-equal; (a2) ``shared=("Wr",)`` on phase
   18's pooled ``lgssm_wtau`` through the NCCL ``all_reduce``: WTAU_IT
   per-chain K1 and static K2 launches, bit-equal; (b) ``infer`` over a
   ``"time"`` mesh at bench.py:680-706's row (one chain, MESH_T steps,
   d = 4): the float64 RTS (ORACLE_TOL; in a check process,
   ``slice26_checks``) and the local call (MESH_ONE_TOL), both timed (one
   warm-up, two timed calls), updates/s = 3 T / t and local / sharded;
   (c) ``make_sharded_filtering(mesh, fused=True)`` at path A's cell: one
   K3 launch, bit-equal to phase 7's call; (d) the streaming engine's
   ``mesh=`` at phase 14's cell: one ``run_offline`` through the fused
   stream plan, bit-equal to the unsharded engine; (e)
   ``make_sharded_step`` on the (1, 1) hybrid mesh at HIERM_B x HIERM_T,
   d = 4, against the flat mesh (HIERM_TOL).  One rank on one card: no
   multi-GPU time (NCCL takes one rank a GPU).  ``[s25]`` lines, and
   ``launches_phase25`` on every row of the ``kernels`` line.
26. The warp K3's tier past d = 32 and the wide K5's marginal kernel
   past 16 states at full width: (a) path A at
   (B, T, d, dy) = FILTER64 (2000, 200, 64, 64) through
   ``make_sharded_filtering(fused=True)`` (``tier_filter_path``): one
   ``fused_filter_warp`` launch of ``warp_filter_tc64_kernel`` a call and
   none of the sweep tier's, sampled chains against the float64 filter
   (ORACLE_TOL), the kernel against its plain version on the host over
   one step of four chains (RTOL / ATOL; computed in a check process,
   ``slice27_checks``, beside phase 17 (a)'s shapes past d = 32), the call
   over three calls after a warm-up, the kernel alone, then the sweep tier
   at the same shape and inputs between two timings of the new tier (their
   outputs held to each other), registers, spills, warps an SM, the bound
   (``filter_bound``, 3xTF32 at the top three Schur levels) and its
   share; (b) a 32-state HMM (``hmm16_path`` at HMM32: 1024 x 1000, 32
   categories, 20 sweeps): 20 serial and 20 marginal launches a call, the
   marginal kernel ``fb_wide_marg_rows_kernel``, sampled chains against
   the float64 VMP (HMM_ORACLE_TOL), the two calls against their plain
   versions on the path's inputs (the serial one on the host on the
   sampled chains), the free energy's gap to the float64 one recorded,
   each launch alone and in the program against ``fb_wide_bounds``.
   ``[filter64]`` / ``[hmm32]`` / ``[s26]`` lines, four more rows on the
   ``kernels`` line and ``launches_phase26`` on every row.
27. The warp K3's tier past d = 64 and the wide K5's marginal kernel past
   32 states at full width: (a) path A at (B, T, d, dy) = FILTER128
   (1000, 200, 128, 128) through ``make_sharded_filtering(fused=True)``
   (``tier_filter_path``): one ``fused_filter_warp`` launch of
   ``warp_filter_tc128_kernel`` a call and none of the sweep tier's,
   sampled chains against the float64 filter (ORACLE_TOL), the kernel
   against its plain version on the host over one step of two chains
   (RTOL / ATOL; computed in a check process, ``slice28_checks``), the
   call over three calls after a warm-up, the kernel alone, then the sweep
   tier at the same shape and inputs once between two timings of the new
   tier (their outputs held to each other), registers, spills, warps an
   SM, the bound (``filter_bound``, 3xTF32 at the top four Schur levels)
   and its share; (b) a 64-state HMM (``hmm16_path`` at HMM64: 512 x 1000,
   64 categories, 20 sweeps): 20 serial and 20 marginal launches a call,
   the marginal kernel ``fb_wide_marg_rows2_kernel``, sampled chains
   against the float64 VMP (HMM_ORACLE_TOL), the two calls against their
   plain versions on the path's inputs (the marginals bit for bit; the
   serial one on the host on the sampled chains), the free energy's gap to
   the float64 one recorded, each launch alone and in the program against
   ``fb_wide_bounds``, and ``fb_wide_marg_kernel`` on the same inputs
   between two timings of the new kernel (their outputs equal).
   ``[filter128]`` / ``[hmm64]`` / ``[s27]`` lines, three more rows on the
   ``kernels`` line and ``launches_phase27`` on every row.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout of the repository, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import functools
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

# Tolerance of kernel vs plain version on the card: the JAX package's own
# smoother test tolerance.  The two sides differ only in rounding (the kernel
# contracts a*b+c into fused multiply-adds; the plain version rounds each
# product), and the filter recursion is contractive, so differences stay at
# float32 roundoff scale.
RTOL = ATOL = 3e-4
# Tolerance of the float32 main path against the float64 RTS oracle over
# T = 10,000 steps.  The plain float32 version on the CPU lands at 3.5e-7 on
# these chains; the filter is contractive, so roundoff does not grow with T.
ORACLE_TOL = 1e-4

# Tolerance of the forward-backward kernels vs their plain versions on the
# card: the JAX package's fused-vs-scan forward-backward tolerance (atol 2e-5
# on gammas/xis, tests/engine/test_batched_engine.py:232-235), with a
# relative term for the log-space alphas and logZ and the summed xi.  Both
# sides run the same operations in the same order; they differ only where
# the compiler's expf/logf and torch's exp/log round differently.
FB_RTOL = FB_ATOL = 2e-5
# Float32 forward-backward (kernel) against a float64 oracle on the same
# inputs: max-normalised log space keeps roundoff at a few ulps per step.
FB_ORACLE_TOL = 1e-5
# The HMM main path (20 VMP sweeps in float32) against a float64 numpy VMP:
# on gammas (absolute) and on the Dirichlet concentrations (relative to
# their size, which reaches ~200 at T=200).
HMM_ORACLE_TOL = {"gammas": 1e-4, "conc_rel": 1e-4}
# The sampled rows run as a batch of 4 against the same rows in the batch of
# 256 (see hmm_path): probabilities absolute, concentrations relative.  On
# an H100 the two read 4.8e-7 on probabilities and 5.4e-7 / 7.4e-7 relative
# on A / B; absolute, A reads 1.14e-5, 1.5 float32 ulps at concentrations
# of 64-128, which is why concentrations are held relative.
INFER_TOL = 1e-5

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, 80 GB HBM3 (data sheet)
FP32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM TF32 on the tensor cores (dense)
# a float32-accurate product in 3xTF32 is three TF32 products
TF32X3_FLOPS = TF32_FLOPS / 3

MAIN_B, MAIN_T, MAIN_D = 1024, 10_000, 4
# (8, 1056, 4): the most time blocks the wrapper's rule gives at that T (33
# of 32 steps); (40, 1001, 3): a ragged last block (30 of 33 steps and one of
# 11); (12, 300, 5): several blocks at the largest d with a fold kernel.
CHECK_SHAPES = [(1000, 257, 4), (37, 64, 1), (64, 100, 2), (96, 48, 3),
                (64, 32, 8), (50, 1, 4), (50, 2, 4), (8, 1056, 4),
                (40, 1001, 3), (12, 300, 5)]
BLOCKED_SHAPES = {(1000, 257, 4): 8, (8, 1056, 4): 33, (40, 1001, 3): 31,
                  (12, 300, 5): 9}       # shape -> time blocks on 132 SMs
PLAIN_SHAPE = CHECK_SHAPES[0]

HMM_B, HMM_T, HMM_IT, HMM_K = 256, 200, 20, 3
# (40, 1001, 3): ragged last staged tile (1001 = 31 * 32 + 9) and many
# marginal tiles; (8, 4099, 8): the most marginal tiles of the list, ragged;
# (8448, 64, 3): a batch that takes one marginal tile per 16 steps
FB_CHECK_SHAPES = [(1000, 257, 3), (37, 64, 2), (64, 100, 5), (64, 33, 8),
                   (16, 40, 1), (50, 1, 3), (50, 2, 3), (40, 1001, 3),
                   (8, 4099, 8), (8448, 64, 3)]
HMM_ROWS = (0, 1, 128, 255)
NAN_B = 64          # phase 9 (d): chains of the NaN batch

# Phase 10, the dynamic-precision tier.  lgssm_wtau at bench.py:306-312's
# (B, T, d) and 2 iterations; at bench.py:314-330's (B, T) against the scan
# path; the W-and-Q model at a small shape.
WTAU_B, WTAU_T, WTAU_D, WTAU_IT = 1024, 10_000, 4, 2
WTAU_SMALL = (256, 2048)
WTAU_ROWS = (0, WTAU_B - 1)
# the W-and-Q model at 33 time blocks (the per-chain K2's blocked kernels)
WQ_SHAPE, WQ_IT = (64, 1056, 2), 3
# (8, 1056, 4) and (40, 1001, 3): many time blocks, the second with a ragged
# last one; (37, 64, 1) and (64, 32, 8): one block at the smallest and the
# largest d
DYN_CHECK_SHAPES = [(8, 1056, 4), (40, 1001, 3), (37, 64, 1), (64, 32, 8)]
DYN_BLOCKED = {(8, 1056, 4): 33, (40, 1001, 3): 31}
# K1 with per-chain W against its plain version on lgssm_wtau's own inputs:
# all chains over the first 2112 steps, which the wrapper cuts into the
# path's 66 time blocks (the plain version on the host takes 6-10 s);
# the plain version's time is one call on the card over 64 steps
DYN_PATH_STEPS = 2112
DYN_PLAIN_STEPS = 64
# The Wishart posterior against the float64 VMP, relative: nu and the scale
# (whose entries are sums of 10,000 float32 terms)
WISHART_REL_TOL = 1e-4

# The quantized LGSSM program against the float32 program on the
# dequantized observations (the two evidence einsums read different layouts
# and may sum in different orders).  K8 is held EQUAL to its plain version:
# both round every product and sum on its own, in the same order.
DEQ_TOL = 1e-5
# Posterior means on quantized observations against the float32 run, as a
# share of max |mean|: the JAX package's engine-test levels.
INT8_LEVEL, FP8_LEVEL = 0.05, 0.07

FILTER_B, FILTER_T, FILTER_D = 10_000, 200, 4
# (10_001, 200, 4, 4) is path A's shape with a ragged last warp.
FILTER_CHECK_SHAPES = [(1000, 257, 4, 4), (10_001, 200, 4, 4), (37, 64, 2, 3),
                       (64, 33, 8, 8), (16, 40, 1, 1), (50, 1, 3, 3)]
# (R, C, start): rows of x from ``start`` floats into its storage.  Each of
# the quantize kernels' layouts is taken (narrow with 4 row groups a thread
# and with 1, narrow with a warp a row, wide, general), and the general one
# for rows that are not 16-byte aligned: C % 4 != 0, past the wide layout's
# register cap, or a contiguous view that starts 4 bytes into its storage.
QUANT_CHECK_SHAPES = [(1 << 21, 16, 0), (100_001, 16, 0), (4096, 10_000, 0),
                      (5, 16_388, 0), (1024, 1001, 0), (4096, 16, 1),
                      (4096, 200, 0), (100_000, 16, 0), (777, 6, 0),
                      (3, 1, 0)]
# (R, dy, dx, start): a payload view ``start`` bytes into its storage.  Each
# of K8's layouts is taken (``pick_dequant_layout``: vector with 4 rows a
# thread and with 1; general for odd dy, rows of 8 bytes and the view that
# starts off 16 bytes), and W whole past 48 KB (64 KB and 200 KB) and in
# row tiles past the opt-in limit (240 KB; ``dequant_tiles``).
DEQUANT_CHECK_SHAPES = [(1 << 21, 16, 4, 0), (100_001, 16, 4, 0),
                        (4096, 32, 8, 0), (1000, 3, 5, 0), (65_536, 8, 3, 0),
                        (5000, 16, 4, 4), (4096, 128, 128, 0),
                        (2048, 400, 128, 0), (1000, 20_000, 3, 0)]
QUANT_SHAPE = (MAIN_B * MAIN_D, MAIN_T)        # the engine's rows (B*F, T)
INGEST_SHAPE = (1 << 21, 16, 4)                # rows, dy, dx
QUANT_ITERATIONS = (1, 10)

# kernel label -> the CUDA kernel's name, as the profiler reports it
FILTER_KERNEL_NAMES = {"fused_filter": "filter_kernel",
                       "fused_filter_wide": "wide_filter_tc_kernel",
                       "fused_filter_warp":
                           "warp_filter(?:_tc|_tc64|_tc128)?_kernel"}
QUANT_KERNEL_NAMES = {
    "quantize_rows": r"quantize_(?:narrow|wide|general)_kernel<.*Int8Payload",
    "quantize_rows_fp8": r"quantize_(?:narrow|wide|general)_kernel<.*Fp8Payload",
                      "dequant_matmul": "dequant_matmul_kernel"}
# one wrapper call is up to three device kernels, the last always launched
SMOOTHER_KERNEL_NAMES = {
    "fused_smoother_fwd": ("fwd_fold_kernel", "fwd_carry_kernel",
                           "fwd_replay_kernel"),
    "fused_smoother_bwd": ("bwd_fold_kernel", "bwd_carry_kernel",
                           "bwd_replay_kernel")}
FB_KERNEL_NAMES = {"fused_fb_fwd": ("fb_fwd_kernel",),
                   "fused_fb_bwd": ("fb_beta_kernel", "fb_xisum_kernel",
                                    "fb_marg_kernel")}
# the two calls of fused_fb_batched above eight states: the serial launch
# (both recursions), the marginal kernel (K <= 16) and xi_sum's
FB_WIDE_KERNEL_NAMES = {"fused_fb_serial_wide": ("fb_wide_serial_kernel",),
                        "fused_fb_marg_wide": ("fb_xisum_kernel",
                                               "fb_wide_marg_half_kernel")}
# ... and at 16 < K <= 32, where the marginal kernel runs a warp a unit
FB_ROWS_KERNEL_NAMES = {"fused_fb_serial_wide": ("fb_wide_serial_kernel",),
                        "fused_fb_marg_wide": ("fb_xisum_kernel",
                                               "fb_wide_marg_rows_kernel")}
# ... and at 32 < K <= 64, two warps a unit
FB_ROWS2_KERNEL_NAMES = {"fused_fb_serial_wide": ("fb_wide_serial_kernel",),
                         "fused_fb_marg_wide": ("fb_xisum_kernel",
                                                "fb_wide_marg_rows2_kernel")}


def _cuda_ms(fn, reps: int, warmup: int = 1, inner: int = 1) -> float:
    """Milliseconds per ``fn()`` call, CUDA events: the median over ``reps``
    rounds, each timing ``inner`` calls back to back.  With ``inner`` > 1
    the host enqueues ahead of the device, so a short kernel's time is not
    inflated by its own launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _once_ms(fn):
    """``fn()``'s result and its milliseconds, one call between CUDA events
    after a synchronize: the time of a plain version that a check runs
    anyway (thousands of small launches, seconds a call)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


# -- exact operation counts of one chain-step ---------------------------------------

class _OpCount:
    """Stand-in entry that counts arithmetic operations when the plain step
    functions run on it (adds, subtracts, multiplies, divides, abs,
    compare/select, maximum, exp, log, each one operation; a leading ``0 +``
    of Python's ``sum`` is not an op)."""

    n = 0

    def _op(self, other):
        if isinstance(other, int) and other == 0:
            return self
        _OpCount.n += 1
        return _OpCount()

    __add__ = __radd__ = __sub__ = __rsub__ = _op
    __mul__ = __rmul__ = __truediv__ = __rtruediv__ = __gt__ = _op

    def __neg__(self):
        return _OpCount()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        import torch

        if func in (torch.abs, torch.where, torch.maximum, torch.exp,
                    torch.log):
            _OpCount.n += 1
            return _OpCount()
        if func is torch.ones_like:
            return _OpCount()
        raise NotImplementedError(func)


def ops_per_step(d: int) -> tuple[int, int]:
    """Operations of one forward and one backward chain-step at dim d."""
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    fe = [[0.5] * d for _ in range(d)]
    be = [0.0] * d
    ent = lambda: [_OpCount() for _ in range(d)]
    mat = lambda: [[_OpCount() for _ in range(d)] for _ in range(d)]
    _OpCount.n = 0
    fs.forward_step(ent(), mat(), ent(), fe, be, fe, fe, first=False)
    n_fwd = _OpCount.n
    _OpCount.n = 0
    fs.backward_step(ent(), mat(), ent(), mat(), fe, be, fe)
    return n_fwd, _OpCount.n


def wide_tc_ops(d: int) -> tuple[int, int]:
    """Operations of one forward and one backward chain-step that the wide
    K1 / K2 (8 < d <= 16, ``csrc/fused_smoother_wide.cu``) run on the
    tensor cores, counted on the plain step's pieces: K1 F P F^T + Q and its
    two inverses' top-level Schur block products; K2 F P_f F^T + Q, P_f F^T,
    its inverse's top-level block products, the gain, G (P_s' - P_pred),
    the new covariance's upper triangle and the cross."""
    from rxinfer_tpu_torch.ops import entrywise as ew

    par = [[0.5] * d for _ in range(d)]
    mat = lambda: [[_OpCount() for _ in range(d)] for _ in range(d)]
    sandwich = _count_ops(lambda: ew.sandwich_sym(par, mat(), par))
    product = _count_ops(lambda: ew.mat_mul(mat(), mat()))
    top = _schur_product_ops(d, 1)
    nsym = d * (d + 1) // 2
    upper = _count_ops(lambda: [
        _OpCount() + sum(_OpCount() * _OpCount() for _ in range(d))
        for _ in range(nsym)])
    return (sandwich + 2 * top,
            sandwich + product + top + 2 * product + upper + product)


def kernel_bounds(b: int, t: int, d: int, moment_bytes: int = 4) -> dict:
    """Least time (ms) the card could take for K1 and K2 at (B, T, d): each
    input read once and each output written once over the HBM rate, against
    the operations over the float32 rate.  At the wide tier (8 < d <= 16)
    the operations the wide kernels run on the tensor cores (``wide_tc_ops``)
    are priced at the 3xTF32 rate instead, the rest at the float32 rate,
    the two times added (``bound_ms``); ``bound_ms_fp32`` prices every
    operation at the float32 rate.  ``moment_bytes``: the packed
    covariances' and the cross's entry size (2 for bf16 moments)."""
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    nsym = d * (d + 1) // 2
    f4, mb = 4, moment_bytes
    fwd_bytes = (t * b * d + b * d + b * d * d) * f4 \
        + t * (d * f4 + nsym * mb) * b
    bwd_bytes = t * (d * f4 + nsym * mb) * b \
        + (t * (d * f4 + nsym * mb) + (t - 1) * d * d * mb) * b
    n_fwd, n_bwd = ops_per_step(d)
    tc_fwd, tc_bwd = wide_tc_ops(d) if fs.REG_MAX_DIM < d <= fs.MAX_DIM \
        else (0, 0)
    out = {}
    for name, nbytes, ops, tc in (
            ("fused_smoother_fwd", fwd_bytes, n_fwd * t * b, tc_fwd * t * b),
            ("fused_smoother_bwd", bwd_bytes, n_bwd * (t - 1) * b,
             tc_bwd * (t - 1) * b)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ((ops - tc) / FP32_FLOPS + tc / TF32X3_FLOPS) * 1e3
        t_fp32 = ops / FP32_FLOPS * 1e3
        out[name] = {
            "bytes": nbytes, "ops": ops, "ops_tensor_cores": tc,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_fp32": max(t_bytes, t_fp32),
        }
    return out


def fb_ops(b: int, t: int, k: int) -> tuple[int, int]:
    """Operations of K4 and of K5 (per-step xi on) over a (B, T, K) call:
    each chain-step of the plain versions run on counting stand-ins."""
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    ent = lambda: [_OpCount() for _ in range(k)]
    mat = lambda: [[_OpCount() for _ in range(k)] for _ in range(k)]

    def count(fn, *args, **kw):
        _OpCount.n = 0
        fn(*args, **kw)
        return _OpCount.n

    first = count(ffb.forward_step, ent(), ent(), mat(), first=True)
    step = count(ffb.forward_step, ent(), ent(), mat(), first=False)
    # logZ from the last alphas: K-1 maxima, K shifts, K exps, K-1 adds, one
    # log and the two adds of cum + m + log(s)
    logz = 4 * k + 1
    n_fwd = (first + (t - 1) * step + logz) * b
    last = count(ffb._softmax, ent())
    bstep = count(ffb.backward_step, ent(), ent(), ent(), mat()) + k * k
    n_bwd = (last + (t - 1) * bstep) * b
    return n_fwd, n_bwd


def fb_wide_bounds(b: int, t: int, k: int) -> dict:
    """Least time (ms) the card could take for the two calls of
    ``fused_fb_batched`` above eight states at (B, T, K), per-step xi on:
    ``fused_fb_serial_wide`` (log_prior, the table and the evidence read,
    alphas, logZ and betas written; the forward recursion's and the beta
    recursion's operations) and ``fused_fb_marg_wide`` (the table, evidence,
    alphas and betas read, gammas, the per-step xi and xi_sum written; the
    scores, gamma's softmax, xi's and xi_sum's operations)."""
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    ent = lambda: [_OpCount() for _ in range(k)]
    mat = lambda: [[_OpCount() for _ in range(k)] for _ in range(k)]

    def count(fn, *args):
        _OpCount.n = 0
        fn(*args)
        return _OpCount.n

    n_fwd, _ = fb_ops(b, t, k)
    scores = count(ffb._scores, ent(), ent(), mat())
    beta = count(ffb._beta_from_scores, mat())
    gamma = count(ffb._softmax, ent()) + k          # alpha + beta first
    xi = count(ffb.xi_from_scores, ent(), mat()) + k * k   # + xi_sum
    f4 = 4
    work = {
        "fused_fb_serial_wide": (
            (b * k + b * k * k + 3 * t * b * k + b) * f4,
            n_fwd + b * (t - 1) * (scores + beta)),
        "fused_fb_marg_wide": (
            (2 * b * k * k + 4 * t * b * k + (t - 1) * b * k * k) * f4,
            b * (t * gamma + (t - 1) * (scores + xi))),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        out[name] = {"bytes": nbytes, "ops": ops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return out


def fb_bounds(b: int, t: int, k: int) -> dict:
    """Least time (ms) the card could take for K4 and K5 (per-step xi on)
    at (B, T, K): inputs read once and outputs written once over the HBM
    rate, against the operations over the float32 rate."""
    f4 = 4
    fwd_bytes = (b * k + b * k * k + t * b * k + t * b * k + b) * f4
    bwd_bytes = (b * k * k + 2 * t * b * k + t * b * k + b * k * k
                 + (t - 1) * b * k * k) * f4
    n_fwd, n_bwd = fb_ops(b, t, k)
    out = {}
    for name, nbytes, ops in (("fused_fb_fwd", fwd_bytes, n_fwd),
                              ("fused_fb_bwd", bwd_bytes, n_bwd)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        out[name] = {
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
    return out


# -- the float64 oracles --------------------------------------------------------------

def rts_float64(m0, p0, xi, f, b, q, w, filtered: bool = False):
    """Information-form Kalman filter + RTS smoother in float64 numpy, for a
    few chains at once (no transition at t = 0).  xi (T, n, d); w (d, d)
    shared or (T, n, d, d) a step; returns smoothed means (T, n, d) and
    covariances (T, n, d, d), and with ``filtered`` the filtered ones
    before them."""
    t_len, n, d = xi.shape
    f, b, q, w = (np.asarray(a, np.float64) for a in (f, b, q, w))
    w_at = (lambda t: w[t]) if w.ndim == 4 else (lambda t: w)
    mf = np.empty((t_len, n, d))
    pf = np.empty((t_len, n, d, d))
    m = np.asarray(m0, np.float64)
    p = np.asarray(p0, np.float64)
    for t in range(t_len):
        if t > 0:
            m = m @ f.T + b
            p = f @ p @ f.T + q
        lam = np.linalg.inv(p)
        p = np.linalg.inv(lam + w_at(t))
        m = np.einsum("nij,nj->ni", p,
                      np.einsum("nij,nj->ni", lam, m) + xi[t])
        mf[t], pf[t] = m, p
    ms = mf.copy()
    ps = pf.copy()
    for t in range(t_len - 2, -1, -1):
        p_pred = f @ pf[t] @ f.T + q
        g = pf[t] @ f.T @ np.linalg.inv(p_pred)
        ms[t] = mf[t] + np.einsum("nij,nj->ni", g, ms[t + 1] - (mf[t] @ f.T + b))
        ps[t] = pf[t] + g @ (ps[t + 1] - p_pred) @ np.swapaxes(g, -1, -2)
    return (mf, pf, ms, ps) if filtered else (ms, ps)


def _max_err(got, want, rtol=RTOL, atol=ATOL):
    """(max abs error, max error relative to |want|, within rtol/atol)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0, 0.0, True
    diff = np.abs(got - want)
    ok = bool(np.all(diff <= atol + rtol * np.abs(want)))
    return float(diff.max()), float((diff / np.maximum(np.abs(want), 1e-6)).max()), ok


def _max_err_device(got, want, rtol, atol):
    """``_max_err`` on the tensors' own device (float32: the difference of
    two values within a factor of two of each other is exact), for outputs
    of a gigabyte that the host would copy and widen to float64 first."""
    if got.numel() == 0:
        return 0.0, 0.0, True
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    rel = float((diff / want.abs().clamp_min(1e-6)).max())
    return float(diff.max()), rel, ok


def _on_host(fn, *args):
    """``fn`` on CPU copies of its tensor arguments: a plain version run by
    the host's torch on the same inputs as a kernel on the card.  The plain
    versions are loops of small operations, each a launch on the card
    (about 12 us) and a few us on the CPU, so the checks take them there
    and time them on the card once, at their first shape."""
    import torch

    return fn(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args])


def _smoother_params(d: int, seed: int):
    """A stable random system: F a scaled orthogonal matrix."""
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    b = (0.1 * np.arange(d)).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    a = rng.standard_normal((d, d)) * 0.2
    w = (0.8 * np.eye(d) + a @ a.T).astype(np.float32)
    return f, b, q, w


def check_kernels(device, shapes, log=print) -> tuple[dict, dict]:
    """Phase 3: each kernel wrapper against its plain version on the same
    CUDA tensors.  Returns per-kernel max abs error, and at the first shape
    each plain version's time (its one call of the check) beside the
    kernel's."""
    import torch

    from rxinfer_tpu_torch.ops import fused_smoother as fs

    worst = {"fused_smoother_fwd": 0.0, "fused_smoother_bwd": 0.0}
    before = dict(fs.LAUNCHES)
    failures = []
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for i, (bsz, t_len, d) in enumerate(shapes):
        blocks = fs.pick_blocks(bsz, t_len, d, sms)
        want = BLOCKED_SHAPES.get((bsz, t_len, d), 1)
        if sms == 132 and blocks != want:
            raise AssertionError(f"(B,T,d)=({bsz},{t_len},{d}): the wrapper "
                                 f"takes {blocks} time blocks, expected {want}")
        f, b, q, w = _smoother_params(d, seed=100 + i)
        rng = np.random.default_rng(i)
        xi = torch.as_tensor(rng.standard_normal((t_len, bsz, d)).astype(
            np.float32), device=device)
        m0 = torch.as_tensor(rng.standard_normal((bsz, d)).astype(np.float32),
                             device=device)
        p0 = torch.as_tensor(np.broadcast_to(9.0 * np.eye(d, dtype=np.float32),
                                             (bsz, d, d)).copy(), device=device)
        mf, pf = fs.fused_forward(m0, p0, xi, f, b, q, w)
        ms, ps, cr = fs.fused_backward(mf, pf, f, b, q)
        if i == 0:
            # the plain versions on the card: their one call is their time
            (mf_r, pf_r), fwd_plain_ms = _once_ms(
                lambda: fs.fused_forward_reference(m0, p0, xi, f, b, q, w))
            (ms_r, ps_r, cr_r), bwd_plain_ms = _once_ms(
                lambda: fs.fused_backward_reference(mf, pf, f, b, q))
        else:
            mf_r, pf_r = _on_host(fs.fused_forward_reference, m0, p0, xi, f,
                                  b, q, w)
            ms_r, ps_r, cr_r = _on_host(fs.fused_backward_reference, mf, pf,
                                        f, b, q)
        torch.cuda.synchronize()
        if i == 0:
            # the plain versions' time at this shape; the kernels' at the
            # same shape is taken after the launch count below
            plain = {"fused_smoother_fwd": {"plain_ms": fwd_plain_ms},
                     "fused_smoother_bwd": {"plain_ms": bwd_plain_ms}}
            first = (lambda a=(m0, p0, xi, f, b, q, w): fs.fused_forward(*a),
                     lambda a=(mf, pf, f, b, q): fs.fused_backward(*a))
        rows = {
            "fused_smoother_fwd": [("mf", mf, mf_r), ("pf", pf, pf_r)],
            "fused_smoother_bwd": [("ms", ms, ms_r), ("ps", ps, ps_r),
                                   ("cross", cr, cr_r)],
        }
        parts = []
        for kname, items in rows.items():
            for label, got, want in items:
                ea, er, ok = _max_err(got.cpu().numpy(), want.cpu().numpy())
                worst[kname] = max(worst[kname], ea)
                parts.append(f"{label} abs {ea:.3g} rel {er:.3g}")
                if not ok:
                    failures.append(f"(B,T,d)=({bsz},{t_len},{d}) {label}: "
                                    f"abs {ea:.3g} rel {er:.3g}")
        log(f"[check] (B,T,d)=({bsz},{t_len},{d}) blocks {blocks} "
            + "; ".join(parts))
    if failures:
        raise AssertionError("kernel disagrees with its plain version beyond "
                             f"rtol=atol={RTOL}: " + "; ".join(failures))
    for k in worst:
        if fs.LAUNCHES[k] - before[k] != len(shapes):
            raise AssertionError(f"{k}: launch counter did not rise once "
                                 "per checked shape")
    for k, fn in zip(("fused_smoother_fwd", "fused_smoother_bwd"), first):
        plain[k]["ms"] = _cuda_ms(fn, 5, inner=20)
    return worst, plain


def _lse64(x, axis):
    m = x.max(axis=axis, keepdims=True)
    return np.squeeze(m + np.log(np.exp(x - m).sum(axis=axis, keepdims=True)),
                      axis)


def fb_float64(lp, lt, le):
    """Log-space forward-backward in float64 numpy for a few chains:
    lp (n, K), lt (n, K, K) [out, in], le (T, n, K).  Returns gammas
    (T, n, K), xis (T-1, n, K, K) and logZ (n,)."""
    lp, lt, le = (np.asarray(a, np.float64) for a in (lp, lt, le))
    t_len = le.shape[0]
    la = np.empty(le.shape)
    la[0] = lp + le[0]
    for t in range(1, t_len):
        la[t] = _lse64(lt + la[t - 1][:, None, :], -1) + le[t]
    lb = np.zeros(le.shape)
    for t in range(t_len - 2, -1, -1):
        lb[t] = _lse64(lt + (le[t + 1] + lb[t + 1])[:, :, None], 1)
    logz = _lse64(la[-1], -1)
    gammas = np.exp(la + lb - logz[None, :, None])
    xis = np.exp(la[:-1, :, None, :] + lt[None]
                 + (le[1:] + lb[1:])[:, :, :, None] - logz[None, :, None, None])
    return gammas, xis, logz


def digamma64(x):
    """float64 digamma: recurrence up to x >= 6, then the asymptotic
    series (error < 1e-12 there)."""
    x = np.array(x, np.float64)
    out = np.zeros_like(x)
    while np.any(x < 6.0):
        small = x < 6.0
        out[small] -= 1.0 / x[small]
        x[small] += 1.0
    f = 1.0 / (x * x)
    return out + np.log(x) - 0.5 / x - f * (
        1 / 12 - f * (1 / 120 - f * (1 / 252 - f * (1 / 240 - f / 132))))


def hmm_vmp_float64(y, a0, b0, iterations):
    """Structured VMP on ``zoo.hmm`` for a few chains in float64: y (n, T, m)
    one-hot, initial concentrations a0 (K, K) and b0 (m, K), flat
    DirichletCollection priors and a uniform initial state.  Returns gammas
    (n, T, K) and the A (n, K, K) and B (n, m, K) concentrations."""
    y = np.asarray(y, np.float64)
    n, _, _ = y.shape
    k = a0.shape[-1]
    ca = np.broadcast_to(np.asarray(a0, np.float64), (n, k, k))
    cb = np.broadcast_to(np.asarray(b0, np.float64), (n,) + b0.shape)
    lp = np.full((n, k), np.log(np.float32(1.0 / k)), np.float64)
    for _ in range(iterations):
        elog_a = digamma64(ca) - digamma64(ca.sum(-2, keepdims=True))
        elog_b = digamma64(cb) - digamma64(cb.sum(-2, keepdims=True))
        le = np.einsum("nij,nti->tnj", elog_b, y)
        gammas, xis, _ = fb_float64(lp, elog_a, le)
        ca = 1.0 + xis.sum(0)
        cb = 1.0 + np.einsum("nti,tnj->nij", y, gammas)
    return np.moveaxis(gammas, 0, 1), ca, cb


def _fb_inputs(b, t, k, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(a.astype(np.float32), device=device) for a in (
        rng.standard_normal((b, k)), 2.0 * rng.standard_normal((b, k, k)),
        2.0 * rng.standard_normal((t, b, k))))


def check_fb_kernels(device, shapes, log=print, seed: int = 200) -> dict:
    """Phase 3 for K4/K5 (and phase 16 (a) for the wide kernels, K > 8):
    each kernel wrapper against its plain version on the same CUDA tensors
    (K5 with and without the per-step xi stream), and a few chains of the
    first shape against the float64 oracle.  Above eight states also the
    two calls of ``fused_fb_batched``: ``fb_serial_wide`` (both recursions
    in one launch; its alphas and betas must equal those of the forward and
    the beta recursion launched alone, bit for bit) and
    ``fb_marginals_wide`` (xi_sum bit-identical over three calls).  Each
    wrapper call must count under its launch key.  Returns per-launch-key
    max abs error against the plain versions, and under ``"bit_equal"``
    whether every output equalled the plain version's bits."""
    import torch

    from rxinfer_tpu_torch.ops import fused_fb as ffb

    worst = {}
    bit_equal = True
    before = dict(ffb.LAUNCHES)
    want_launches = {key: 0 for key in ffb.LAUNCHES}
    failures = []
    for i, (bsz, t_len, k) in enumerate(shapes):
        wide = k > ffb.REG_MAX_STATES
        keys = {d: ffb.launch_key(d, k) for d in
                ("fwd", "bwd") + (("serial", "marg") if wide else ())}
        want_launches[keys["fwd"]] += 1
        want_launches[keys["bwd"]] += 3
        lp, lt, le = _fb_inputs(bsz, t_len, k, seed=seed + i, device=device)
        tile = ffb.device_tile(bsz, t_len, device, k)
        alphas, logz = ffb.fb_forward(lp, lt, le)
        alphas_r, logz_r = ffb.fb_forward_reference(lp, lt, le)
        g, xs, steps = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
        g2, xs2, none = ffb.fb_backward(lt, le, alphas, per_step_xi=False)
        _, xs3, _ = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
        betas_r = ffb.beta_pass_reference(lt, le)
        g_r, xs_r, steps_r = ffb.marginals_reference(lt, le, alphas, betas_r,
                                                     True, tile=tile)
        if wide:
            want_launches[keys["serial"]] += 1
            want_launches[keys["marg"]] += 3
            a_w, z_w, betas = ffb.fb_serial_wide(lp, lt, le)
            gw, xw, sw = ffb.fb_marginals_wide(lt, le, a_w, betas, True)
            gw2, xw2, _ = ffb.fb_marginals_wide(lt, le, a_w, betas, False)
            xw3 = ffb.fb_marginals_wide(lt, le, a_w, betas, True)[1]
        torch.cuda.synchronize()
        if none is not None or tuple(steps.shape) != (t_len - 1, bsz, k, k):
            failures.append(f"(B,T,K)=({bsz},{t_len},{k}): xi_steps shape")
        if not (torch.equal(xs, xs2) and torch.equal(xs, xs3)):
            failures.append(f"(B,T,K)=({bsz},{t_len},{k}): xi_sum differs "
                            "between calls on the same inputs")
        rows = {
            keys["fwd"]: [("alphas", alphas, alphas_r),
                          ("logz", logz, logz_r)],
            keys["bwd"]: [("gammas", g, g_r), ("xi_sum", xs, xs_r),
                          ("xi_steps", steps, steps_r),
                          ("gammas(no steps)", g2, g_r),
                          ("xi_sum(no steps)", xs2, xs_r)],
        }
        plan = ""
        if wide:
            rows[keys["serial"]] = [("alphas(serial)", a_w, alphas_r),
                                    ("logz(serial)", z_w, logz_r),
                                    ("betas(serial)", betas, betas_r)]
            rows[keys["marg"]] = [("gammas(marg)", gw, g_r),
                                  ("xi_sum(marg)", xw, xs_r),
                                  ("xi_steps(marg)", sw, steps_r),
                                  ("gammas(marg, no steps)", gw2, g_r),
                                  ("xi_sum(marg, no steps)", xw2, xs_r)]
            if not (torch.equal(xw, xw2) and torch.equal(xw, xw3)):
                failures.append(f"(B,T,K)=({bsz},{t_len},{k}): the marginal "
                                "call's xi_sum differs between calls")
            # one launch of both recursions gives each one's bits alone
            alone = all(torch.equal(x, y) for x, y in (
                (a_w, alphas), (z_w, logz), (gw, g), (xw, xs), (sw, steps)))
            if not alone:
                failures.append(f"(B,T,K)=({bsz},{t_len},{k}): the serial "
                                "launch of both recursions differs from "
                                "each recursion launched alone")
            serial = ffb.wide_serial_plan(k, device)
            plan = (f"; the serial launch equals each recursion alone bit "
                    f"for bit; serial plan {serial}")
            if k == FB_DEVICE_TABLE_K and serial["table"] != "device":
                failures.append(f"K={k}: the table should be read from "
                                f"device memory, plan {serial}")
        parts = []
        for kname, items in rows.items():
            for label, got, want in items:
                ea, _, ok = _max_err(got.cpu().numpy(), want.cpu().numpy(),
                                     rtol=FB_RTOL, atol=FB_ATOL)
                worst[kname] = max(worst.get(kname, 0.0), ea)
                bit_equal = bit_equal and torch.equal(got, want)
                parts.append(f"{label} {ea:.3g}")
                if not ok:
                    failures.append(f"(B,T,K)=({bsz},{t_len},{k}) {label}: "
                                    f"abs {ea:.3g}")
        log(f"[check] (B,T,K)=({bsz},{t_len},{k}) marginal tile {tile} "
            f"({-(-t_len // tile)} tiles) max abs: " + "; ".join(parts)
            + f"; xi_sum bit-identical over 3 calls{plan}")
        if i == 0:
            idx = [0, 1, bsz // 2, bsz - 1]
            o_g, o_x, o_z = fb_float64(lp[idx].cpu().numpy(),
                                       lt[idx].cpu().numpy(),
                                       le[:, idx].cpu().numpy())
            errs = {
                "gammas": float(np.abs(g[:, idx].cpu().numpy() - o_g).max()),
                "xi_steps": float(np.abs(steps[:, idx].cpu().numpy()
                                         - o_x).max()),
                "logz_rel": float((np.abs(logz[idx].cpu().numpy() - o_z)
                                   / np.abs(o_z)).max()),
            }
            log(f"[check] K4/K5 vs float64 forward-backward, chains {idx}: "
                f"{errs} (tol {FB_ORACLE_TOL})")
            if max(errs.values()) > FB_ORACLE_TOL:
                failures.append(f"float64 oracle: {errs}")
    if failures:
        raise AssertionError("forward-backward kernels disagree: "
                             + "; ".join(failures))
    rose = {key: ffb.LAUNCHES[key] - before[key] for key in before}
    if rose != want_launches:
        raise AssertionError(f"fused_fb launch counters rose {rose}, "
                             f"expected {want_launches}")
    worst["bit_equal"] = bit_equal
    return worst


def check_fb_path_inputs(lp, lt, le, log=print, tag: str = "hmm",
                         serial_rows: list | None = None,
                         marginal_bits: bool = False) -> tuple[dict, dict]:
    """K4/K5 against their plain versions on the inputs the HMM path hands
    them in its last sweep, at the path's own (B, T, K): above eight states
    the two calls the path makes (``fb_serial_wide``, ``fb_marginals_wide``,
    under their launch keys), else ``fb_forward`` / ``fb_backward``; with
    ``serial_rows`` the serial call's plain version runs on the host on
    those chains (its step is a few hundred launches on the card: 7.3 s
    a call at 32 states); with ``marginal_bits`` the marginal call's
    outputs must be the plain version's bits.  Returns per-launch-key max
    abs error and the plain versions' ms (their one call here)."""
    import torch

    from rxinfer_tpu_torch.ops import fused_fb as ffb

    t_len, bsz, k = le.shape
    tile = ffb.device_tile(bsz, t_len, le.device, k)
    if k > ffb.REG_MAX_STATES:
        first, second = ffb.launch_key("serial", k), ffb.launch_key("marg", k)
        alphas, logz, betas = ffb.fb_serial_wide(lp, lt, le)
        serial_plain = lambda a, b, c: ffb.fb_forward_reference(a, b, c) + (
            ffb.beta_pass_reference(b, c),)
        if serial_rows is None:
            (alphas_r, logz_r, betas_r), first_ms = _once_ms(
                lambda: serial_plain(lp, lt, le))
        else:
            pick = list(serial_rows)
            t0 = time.perf_counter()
            alphas_r, logz_r, betas_r = (
                x.to(le.device) for x in serial_plain(
                    lp[pick].cpu(), lt[pick].cpu(), le[:, pick].cpu()))
            first_ms = (time.perf_counter() - t0) * 1e3
        g, xs, steps = ffb.fb_marginals_wide(lt, le, alphas, betas, True)
        (g_r, xs_r, steps_r), second_ms = _once_ms(
            lambda: ffb.marginals_reference(lt, le, alphas, betas, True,
                                            tile=tile))
        sel = (slice(None) if serial_rows is None else list(serial_rows))
        first_rows = [("alphas", alphas[:, sel], alphas_r),
                      ("logz", logz[sel], logz_r),
                      ("betas", betas[:, sel], betas_r)]
    else:
        first, second = ffb.launch_key("fwd", k), ffb.launch_key("bwd", k)
        alphas, logz = ffb.fb_forward(lp, lt, le)
        (alphas_r, logz_r), first_ms = _once_ms(
            lambda: ffb.fb_forward_reference(lp, lt, le))
        g, xs, steps = ffb.fb_backward(lt, le, alphas, per_step_xi=True)
        (g_r, xs_r, steps_r), second_ms = _once_ms(
            lambda: ffb.fb_backward_reference(lt, le, alphas, True,
                                              tile=tile))
        first_rows = [("alphas", alphas, alphas_r), ("logz", logz, logz_r)]
    torch.cuda.synchronize()
    rows = {
        first: first_rows,
        second: [("gammas", g, g_r), ("xi_sum", xs, xs_r),
                 ("xi_steps", steps, steps_r)],
    }
    worst = {}
    parts, failures = [], []
    for kname, items in rows.items():
        worst[kname] = 0.0
        for label, got, want in items:
            ea, _, ok = _max_err_device(got, want, rtol=FB_RTOL, atol=FB_ATOL)
            worst[kname] = max(worst[kname], ea)
            parts.append(f"{label} {ea:.3g}")
            if not ok:
                failures.append(f"{label}: abs {ea:.3g}")
            if marginal_bits and kname == second and not torch.equal(got,
                                                                     want):
                failures.append(f"{label}: not the plain version's bits")
    plain = {first: first_ms, second: second_ms}
    log(f"[{tag}] {first} / {second} vs plain versions on the path's "
        f"inputs, (B,T,K)=({bsz},{t_len},{k}) max abs: " + "; ".join(parts)
        + f" (rtol=atol={FB_RTOL}); the plain versions' one call "
        f"{first_ms:.1f} / {second_ms:.1f} ms"
        + ("" if serial_rows is None else
           f" ({first} on the host, chains {list(serial_rows)})")
        + (f"; {second} bit for bit" if marginal_bits else ""))
    if failures:
        raise AssertionError("forward-backward kernels disagree on the HMM "
                             "path's inputs: " + "; ".join(failures))
    return worst, plain


# host results (data and float64 oracles) computed once: here, or ahead by
# ``host_prefetch`` in a check process while phase 3 runs
_MEMO: dict = {}


def _memo(key, fn):
    if key not in _MEMO:
        _MEMO[key] = fn()
    return _MEMO[key]


def simulate_hmm(b: int, t_len: int, seed: int):
    """One-hot observations of the JAX package's HMM bench (bench.py:514-522):
    a sticky 3-state chain and a noisy identity emission, from a numpy
    seed (simulated once a shape and seed, a copy each call)."""
    return _memo(("hmm_y", b, t_len, seed),
                 lambda: _simulate_hmm(b, t_len, seed)).copy()


def _simulate_hmm(b: int, t_len: int, seed: int):
    rng = np.random.default_rng(seed)
    a_true = np.array([[0.9, 0.05, 0.05], [0.05, 0.9, 0.05],
                       [0.05, 0.05, 0.9]], np.float64)
    yh = np.zeros((b, t_len), np.int64)
    for bidx in range(b):
        s = rng.integers(3)
        for t in range(t_len):
            s = rng.choice(3, p=a_true[:, s])
            yh[bidx, t] = rng.choice(3, p=a_true[:, s])
    return np.eye(3, dtype=np.float32)[yh]


def _hmm_diffs(got, want, rows) -> dict:
    """Max differences of the HMM posteriors ``got`` from ``want`` at
    ``rows``: s probabilities absolute, A and B concentrations absolute and
    relative to their size."""
    out = {"probs_abs": float((got["s"].probs() - want["s"].probs()[rows])
                              .abs().max())}
    for n in ("A", "B"):
        diff = (got[n].alpha - want[n].alpha[rows]).abs()
        out[f"{n}_abs"] = float(diff.max())
        out[f"{n}_rel"] = float((diff / want[n].alpha[rows]).max())
    return out


def _counted_modules():
    from rxinfer_tpu_torch.ops import (
        fused_fb,
        fused_filter,
        fused_smoother,
        quantized,
    )

    return fused_smoother, fused_fb, fused_filter, quantized


def reset_launches() -> None:
    for mod in _counted_modules():
        mod.reset_launches()


def read_launches() -> dict:
    out: dict = {}
    for mod in _counted_modules():
        out.update(mod.LAUNCHES)
    return out


def expect_launches(launches: dict, **nonzero) -> None:
    """Raise unless exactly the named kernels were launched, each the given
    number of times, and no other kernel at all."""
    want = {k: nonzero.get(k, 0) for k in launches}
    if launches != want or set(nonzero) - set(launches):
        raise AssertionError(f"expected launches {want}, got {launches}")


def hmm_path(device, b: int, t_len: int, iterations: int, reps: int,
             log=print) -> dict:
    """Phase 5: the port's batched program on zoo.hmm(3, 3)."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine import batched as eb
    from rxinfer_tpu_torch.engine.blocks import BatchContext
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    y_host = simulate_hmm(b, t_len, seed=0)
    y = torch.as_tensor(y_host, device=device)
    a0 = np.full((3, 3), 1.0, np.float32)
    b0 = np.float32(np.eye(3) * 5.0 + 1.0)
    init = {"A": rt.DirichletCollection(a0), "B": rt.DirichletCollection(b0)}
    model = zoo.hmm(3, 3)
    compiled, prog = rt.batched_program(
        model, {"y": y}, iterations=iterations, free_energy=False,
        initialization=init, device=device)
    report = compiled.plan_report()
    log(f"[hmm] plan_report {report}")
    if report.get("s") != {"fused": True, "kernel": "fused_fb",
                           "route": "cuda"}:
        raise AssertionError("chain s is not on the CUDA forward-backward "
                             "kernels")

    reset_launches()
    state, _, _ = prog({"y": y})
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[hmm] launches in one program call: {launches}")
    expect_launches(launches, fused_fb_fwd=iterations, fused_fb_bwd=iterations)

    probs = state["s"].probs().cpu().numpy()
    conc = {n: state[n].alpha.cpu().numpy() for n in ("A", "B")}
    if probs.shape != (b, t_len, 3) or not np.isfinite(probs).all() or \
            any(not np.isfinite(c).all() for c in conc.values()):
        raise AssertionError("HMM posteriors have the wrong shape or are "
                             "not finite")

    rows = list(HMM_ROWS)
    o_g, o_a, o_b = hmm_vmp_float64(y_host[rows], a0, b0, iterations)
    errs = {
        "gammas": float(np.abs(probs[rows] - o_g).max()),
        "A_rel": float((np.abs(conc["A"][rows] - o_a) / o_a).max()),
        "B_rel": float((np.abs(conc["B"][rows] - o_b) / o_b).max()),
    }
    log(f"[hmm] float64 VMP, chains {rows}: {errs} (tol {HMM_ORACLE_TOL})")
    if errs["gammas"] > HMM_ORACLE_TOL["gammas"] or max(
            errs["A_rel"], errs["B_rel"]) > HMM_ORACLE_TOL["conc_rel"]:
        raise AssertionError(f"HMM path disagrees with the float64 VMP: {errs}")

    # infer_batched on the sampled rows against batched_program on the same
    # rows: one plan on the same shapes, so the same operations; and those
    # rows run as a batch of 4 against the same rows of the batch of 256
    sub = {"y": y[rows]}
    res = rt.infer_batched(model, sub, iterations=iterations,
                           initialization=init, device=device)
    _, prog_sub = rt.batched_program(model, sub, iterations=iterations,
                                     free_energy=False, initialization=init,
                                     device=device)
    state_sub, _, _ = prog_sub(sub)
    same = _hmm_diffs(res.posteriors, state_sub, slice(None))
    across = _hmm_diffs(state_sub, state, rows)
    log(f"[hmm] infer_batched vs batched_program on rows {rows}: {same} "
        f"(must be 0)")
    log(f"[hmm] those rows as a batch of {len(rows)} vs in the batch of {b}:"
        f" {across} (tol {INFER_TOL} on probs_abs and the *_rel)")
    if max(same.values()) != 0.0:
        raise AssertionError("infer_batched disagrees with batched_program")
    if max(across["probs_abs"], across["A_rel"], across["B_rel"]) > INFER_TOL:
        raise AssertionError("the HMM path depends on the batch size beyond "
                             f"{INFER_TOL}: {across}")

    out = {"errs": errs, "launches": launches, "batch_diffs": across}
    block = next(blk for kind, blk in compiled.blocks if blk.var.name == "s")
    groups = [blk for kind, blk in compiled.blocks if kind == "plain"]
    ctx = BatchContext(device, b, {})
    lp, elog_a, le_t = block._inputs(state, {"y": y}, {}, ctx)
    out["kernel_errs"], out["plain_ms"] = check_fb_path_inputs(
        lp, elog_a, le_t, log=log)

    # -- timing: the program and each stage alone, on the last sweep's inputs
    out["program_ms"] = _cuda_ms(lambda: prog({"y": y}), reps)
    out["updates_per_s"] = b * iterations * (t_len + 2) / (
        out["program_ms"] / 1e3)
    alphas, _ = ffb.fb_forward(lp, elog_a, le_t)
    gammas, _, _ = ffb.fb_backward(elog_a, le_t, alphas, per_step_xi=True)
    _, cross = eb._fused_discrete_update(block, state, {"y": y}, {}, ctx)
    cc = {"s": cross}
    stages = {
        "inputs": lambda: block._inputs(state, {"y": y}, {}, ctx),
        "fwd": lambda: ffb.fb_forward(lp, elog_a, le_t),
        "bwd": lambda: ffb.fb_backward(elog_a, le_t, alphas, per_step_xi=True),
        "marginal": lambda: torch.log(torch.clamp(gammas.transpose(0, 1),
                                                  min=1e-37)),
        "plain_groups": lambda: [g.update(state, {"y": y}, cc, ctx)
                                 for g in groups],
    }
    # each stage back to back (``iterations`` times, as in one call): a
    # kernel's time is then its device time, a host-bound stage's the host's
    # cost per sweep
    for name, fn in stages.items():
        out[f"{name}_ms"] = _cuda_ms(fn, reps, inner=iterations)
    out["profile"] = _device_profile(lambda: prog({"y": y}), FB_KERNEL_NAMES)
    busy = out["profile"]["busy_ms"]
    log(f"[hmm] program {out['program_ms']:.3f} ms/call "
        f"({out['updates_per_s']:.4g} updates/s); stages alone (one sweep): "
        + ", ".join(f"{n} {out[n + '_ms']:.4f} ms" for n in stages)
        + f"; device busy {busy} ms per program call, idle "
        f"{_idle_share(out['program_ms'], busy)}; in the program "
        f"{out['profile']['kernels']}")
    return out


def _device_profile(fn, kernels: dict, top: int = 0) -> dict:
    """One ``fn()`` call under ``torch.profiler``, after a warm-up call inside
    the profiler that is not recorded.  ``busy_ms`` sums the
    device events (kernels, copies, sets) only: a CPU operator's device time
    repeats that of its kernels, so summing every event would count the
    torch operators twice.  For each entry of ``kernels`` (label -> CUDA
    kernel name, or the names of the device kernels that one wrapper call
    launches, the last of them at every call) it gives the launches and the
    device ms per launch, summed over the names, and for several names each
    one's ms per launch under ``parts``.  With ``top``, ``top`` lists that
    many device kernels with the most device ms in the call, each [name,
    launches, ms].  Every entry of ``kernels`` must be launched by each
    call.  Device numbers read "not measured" when the profiler records
    no device event."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # one warm-up step inside the profiler, discarded, then the recorded one:
    # device events of the first launches after the profiler starts are lost.
    # A session that records no device event at all, or none of a kernel
    # that every call launches, is run once more (both seen on an H100,
    # after several sessions in one process).
    last = [re.compile(rf"(?<!\w){v if isinstance(v, str) else v[-1]}\b")
            for v in kernels.values()]
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        if dev and all(any(pat.search(e.name) for e in dev) for pat in last):
            break
        print("[profile] a kernel's device events were not recorded; "
              "profiling once more", flush=True)
    if not dev:
        return {"busy_ms": "not measured",
                "kernels": {k: {"launches": "not measured",
                                "ms_per_launch": "not measured"}
                            for k in kernels}}
    out = {"busy_ms": sum(e.device_time_total for e in dev) / 1e3,
           "kernels": {}}
    for label, names in kernels.items():
        names = (names,) if isinstance(names, str) else names
        hits = {}
        for name in names:
            pat = re.compile(rf"(?<!\w){name}\b")
            hits[name] = [e.device_time_total for e in dev
                          if pat.search(e.name)]
        calls = len(hits[names[-1]])
        row = {"launches": calls,
               "ms_per_launch": sum(map(sum, hits.values())) / 1e3 / calls
               if calls else "not measured"}
        if len(names) > 1 and calls:
            row["parts"] = {n: sum(h) / 1e3 / calls for n, h in hits.items()}
        out["kernels"][label] = row
    if top:
        by_name: dict = {}
        for e in dev:
            n, ms = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, ms + e.device_time_total / 1e3)
        out["top"] = [[name[:80], n, ms] for name, (n, ms) in sorted(
            by_name.items(), key=lambda kv: -kv[1][1])[:top]]
    return out


def _cycles_per_step(ms, mhz: float, t_len: int):
    """SM cycles a time step: ``ms`` at ``mhz`` over ``t_len`` steps."""
    if not isinstance(ms, float) or mhz != mhz:
        return "not measured"
    return ms * mhz * 1e3 / t_len


def _share(bound_ms: float, ms):
    """``bound_ms`` over a measured ``ms``, or "not measured"."""
    return bound_ms / ms if isinstance(ms, float) else "not measured"


def _elapsed(what: str, t_start: float) -> None:
    print(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s",
          flush=True)


def _idle_share(program_ms: float, busy_ms) -> str:
    if not isinstance(busy_ms, float):
        return "not measured"
    return f"{100 * (1 - busy_ms / program_ms):.1f}%"


class SmClock:
    """``nvidia-smi`` sampling the SM clock every 50 ms while the block runs;
    ``mhz`` is the median sample (nan without one).  The process is stopped
    on exit."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate()
        mhz = [float(x) for x in out.split() if x.replace(".", "").isdigit()]
        self.mhz = statistics.median(mhz) if mhz else float("nan")
        return False


def time_fb_alone(device, shapes, smi: str, log=print) -> dict:
    """K4 and K5 (per-step xi on) alone at each (B, T, K), after half a
    second of launches that brings the clock up: device ms per wrapper call
    (``_device_profile`` over five calls of each; K5's passes summed) and
    the cycles a step it gives at the SM clock sampled meanwhile, and under
    ``wall_ms`` the ms between CUDA events over calls back to back, which
    the wrapper's Python bounds when the kernels are shorter."""
    import torch

    from rxinfer_tpu_torch.ops import fused_fb as ffb

    out = {}
    for shape in shapes:
        bsz, t_len, k = shape
        lp, lt, le = _fb_inputs(*shape, seed=7, device=device)
        alphas, _ = ffb.fb_forward(lp, lt, le)
        fwd = lambda: ffb.fb_forward(lp, lt, le)
        bwd = lambda: ffb.fb_backward(lt, le, alphas, per_step_xi=True)
        with SmClock() as clk:
            end = time.perf_counter() + 0.5
            while time.perf_counter() < end:
                fwd()
                bwd()
            torch.cuda.synchronize()
            wall = {"fused_fb_fwd": _cuda_ms(fwd, 9, inner=10),
                    "fused_fb_bwd": _cuda_ms(bwd, 9, inner=10)}
            prof = _device_profile(
                lambda: [f() for f in (fwd,) * 5 + (bwd,) * 5],
                FB_KERNEL_NAMES)["kernels"]
        row = {n: prof[n]["ms_per_launch"] for n in wall}
        row["wall_ms"] = wall
        row["bwd_parts"] = prof["fused_fb_bwd"].get("parts")
        row["sm_clock_mhz"] = clk.mhz
        row["cycles_per_step"] = {
            n: _cycles_per_step(row[n], clk.mhz, t_len) for n in wall}
        row["tile"] = ffb.device_tile(bsz, t_len, device, k)
        out[shape] = row
        fmt = lambda x, f: format(x, f) if isinstance(x, float) else str(x)
        cyc = lambda n: fmt(row["cycles_per_step"][n], ".0f")
        log(f"[hmm] alone at (B,T,K)={shape}, device ms: K4 "
            f"{fmt(row['fused_fb_fwd'], '.4f')} ({cyc('fused_fb_fwd')} cycles"
            f" a step), K5 {fmt(row['fused_fb_bwd'], '.4f')} "
            f"({cyc('fused_fb_bwd')} cycles a step, marginal tile "
            f"{row['tile']}, passes "
            f"{row['bwd_parts']}); between events K4 {wall['fused_fb_fwd']:.4f},"
            f" K5 {wall['fused_fb_bwd']:.4f}; at {clk.mhz:.0f} MHz; {smi}")
    return out


def lgssm_constants(d: int):
    """The JAX package's bench constants: F = kron(I, rot(pi/35)),
    H = 1.3 I, R = Q = I, m0 = 0, P0 = 25 I."""
    theta = np.pi / 35
    rot = np.array([[np.cos(theta), -np.sin(theta)],
                    [np.sin(theta), np.cos(theta)]], dtype=np.float32)
    f = np.kron(np.eye(d // 2, dtype=np.float32), rot)
    h = 1.3 * np.eye(d, dtype=np.float32)
    r = np.eye(d, dtype=np.float32)
    q = np.eye(d, dtype=np.float32)
    m0 = np.zeros(d, np.float32)
    p0 = 25.0 * np.eye(d, dtype=np.float32)
    return f, q, h, r, m0, p0


@functools.lru_cache(maxsize=None)
def _lgssm_y(b: int, t_len: int, d: int) -> np.ndarray:
    return np.random.default_rng(0).standard_normal((b, t_len, d),
                                                    dtype=np.float32)


def lgssm_y(b: int, t_len: int, d: int) -> np.ndarray:
    """The LGSSM cells' observations, standard normal from seed 0 (drawn
    once a shape, a copy each call)."""
    return _lgssm_y(b, t_len, d).copy()


def lgssm_rows_oracle(b: int, t_len: int, d: int, rows: tuple):
    """The float64 RTS smoother of ``lgssm_y``'s sampled chains under
    ``lgssm_constants(d)``: means and covariances (T, rows, d[, d])."""
    def oracle():
        f, q, h, r, m0, p0 = lgssm_constants(d)
        hinv = h.T @ np.linalg.inv(r)
        xi = np.einsum("ij,ntj->tni", hinv.astype(np.float64),
                       _lgssm_y(b, t_len, d)[list(rows)].astype(np.float64))
        return rts_float64(np.broadcast_to(m0, (len(rows), d)),
                           np.broadcast_to(p0, (len(rows), d, d)), xi, f,
                           np.zeros(d), q, hinv @ h)

    return _memo(("lgssm_rows", b, t_len, d, tuple(rows)), oracle)


def lgssm_logz_rows(b: int, t_len: int, d: int, rows: tuple):
    """-log p(y) of ``lgssm_y``'s sampled chains (``lgssm_minus_log_z``)."""
    return _memo(("logz", b, t_len, d, tuple(rows)),
                 lambda: lgssm_minus_log_z(
                     _lgssm_y(b, t_len, d)[list(rows)],
                     *lgssm_constants(d)))


def edge_rows(b: int) -> list:
    """The sampled chains of a batch: the first two, the middle, the last."""
    return sorted({0, 1, b // 2, b - 1})


def infer_lgssm_y(t_len: int, d: int, seed: int = 1) -> np.ndarray:
    """Phase 9 (a)'s chain: standard normal from ``seed``."""
    return np.random.default_rng(seed).standard_normal(
        (t_len, d)).astype(np.float32)


def infer_lgssm_oracle(t_len: int, d: int, seed: int = 1):
    """The float64 RTS of ``infer_lgssm_y``'s chain."""
    return _memo(("infer_lgssm", seed, t_len, d), lambda: _lgssm_oracle(
        infer_lgssm_y(t_len, d, seed)[None], d))


def nan_batch_y(b: int, t_len: int, d: int, seed: int = 5) -> np.ndarray:
    """Phase 9 (c)'s chains: standard normal from ``seed``, about a tenth
    of the steps missing (NaN)."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, t_len, d)).astype(np.float32)
    y[rng.random((b, t_len)) < 0.1] = np.nan
    return y


def nan_batch_oracle(b: int, t_len: int, d: int, seed: int = 5):
    """The float64 RTS of ``nan_batch_y``'s ``edge_rows``, missing steps
    skipped."""
    def oracle():
        y = nan_batch_y(b, t_len, d, seed)[edge_rows(b)]
        return _lgssm_oracle(y, d, w_steps=np.isfinite(y).all(-1).T.astype(
            np.float64))

    return _memo(("nan_batch", seed, b, t_len, d), oracle)


def wtau_y(b: int, t_len: int, d: int, seed: int = 11) -> np.ndarray:
    """Phase 10 (b)'s observations: standard normal from ``seed``."""
    return np.random.default_rng(seed).standard_normal(
        (b, t_len, d)).astype(np.float32)


def wtau_oracle(b: int, t_len: int, d: int, iterations: int, rows: tuple,
                seed: int = 11):
    """The float64 mean-field VMP of ``wtau_y``'s ``rows``."""
    return _memo(("wtau", seed, b, t_len, d, iterations, tuple(rows)),
                 lambda: wtau_vmp_float64(wtau_y(b, t_len, d, seed)[
                     list(rows)], d, iterations))


def hmm16_y(b: int, t_len: int, k: int, m: int, seed: int = 16):
    """Phase 16 (b)'s observations (``simulate_hmm_k`` from ``seed``)."""
    return simulate_hmm_k(b, t_len, k, m, seed=seed)


def hmm16_oracle(b: int, t_len: int, k: int, m: int, iterations: int,
                 seed: int = 16):
    """The float64 VMP of ``hmm16_y``'s ``edge_rows`` from ``hmm_k_init``:
    (its FE, (gammas, A's and B's concentrations))."""
    def oracle():
        a0, b0 = hmm_k_init(k, m)
        return hmm_vmp_fe_float64(hmm16_y(b, t_len, k, m, seed)[
            edge_rows(b)], a0, b0, iterations, with_state=True)

    return _memo(("hmm16", seed, b, t_len, k, m, iterations), oracle)


def d16_y(b: int, t_len: int, d: int, seed: int = 16) -> np.ndarray:
    """Phase 15 (b)'s observations: standard normal from ``seed``."""
    return np.random.default_rng(seed).standard_normal((b, t_len, d),
                                                       dtype=np.float32)


def d16_oracle(b: int, t_len: int, d: int, seed: int = 16) -> dict:
    """The float64 RTS (means, covariances) of ``d16_y``'s ``edge_rows``
    under ``lgssm_constants(d)``, by row."""
    def oracle():
        y = d16_y(b, t_len, d, seed)
        return {row: rts_cov_float64(*lgssm_constants(d), y[row])
                for row in edge_rows(b)}

    return _memo(("d16", seed, b, t_len, d), oracle)


def host_prefetch(wall0: float, part: int) -> tuple[list, dict]:
    """The slowest host results (data and float64 oracles) of phases 4, 5,
    9, 10, 12, 15, 16 and 26, computed in a check process while phase 3 runs,
    by the functions the phases call: the main process takes them from
    ``_MEMO``."""
    lines: list = []
    if part == 0:
        simulate_hmm(HMM_B, HMM_T, 0)
        lgssm_rows_oracle(MAIN_B, MAIN_T, MAIN_D, tuple(edge_rows(MAIN_B)))
        lgssm_logz_rows(MAIN_B, MAIN_T, MAIN_D, tuple(FE_ROWS))
        infer_lgssm_oracle(MAIN_T, MAIN_D)
        nan_batch_oracle(NAN_B, MAIN_T, MAIN_D)
        hmm16_oracle(HMM32_B, HMM32_T, HMM32_K, HMM32_M, HMM32_IT)
    else:
        wtau_oracle(WTAU_B, WTAU_T, WTAU_D, WTAU_IT, WTAU_ROWS)
        hmm16_oracle(HMM16_B, HMM16_T, HMM16_K, HMM16_M, HMM16_IT)
        d16_oracle(D16_B, D16_T, D16_D)
        _memo(("filter_bound",) + (FILTER64_B, FILTER64_T) + (FILTER64_D,) * 2,
              lambda: filter_bound(FILTER64_B, FILTER64_T, FILTER64_D,
                                   FILTER64_D))
    _ended(lines, f"host oracles, part {part}", wall0)
    return lines, dict(_MEMO)


def main_path(device, b: int, t_len: int, d: int, reps: int,
              log=print) -> dict:
    """Phase 4: the port's batched program at (B, T, d)."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    f, q, h, r, m0, p0 = lgssm_constants(d)
    model = zoo.lgssm(f, q, h, r, m0, p0)
    y_host = lgssm_y(b, t_len, d)
    y = torch.as_tensor(y_host, device=device)
    compiled, prog = rt.batched_program(model, {"y": y}, iterations=1,
                                        free_energy=False, device=device)
    report = compiled.plan_report()
    log(f"[main] plan_report {report}")
    want_route = "cuda" if device.type == "cuda" else "plain"
    if report.get("x", {}).get("fused") is not True \
            or report["x"].get("route") != want_route:
        raise AssertionError(f"chain x is not on the fused {want_route} path")

    reset_launches()
    state, _, _ = prog({"y": y})
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    log(f"[main] launches in one program call: {launches}")
    if device.type == "cuda":
        expect_launches(launches, fused_smoother_fwd=1, fused_smoother_bwd=1)

    post = state["x"]
    means = post.mu.cpu().numpy()
    covs = post.sigma.cpu().numpy()
    if means.shape != (b, t_len, d) or covs.shape != (b, t_len, d, d):
        raise AssertionError(f"posterior shapes {means.shape}, {covs.shape}")
    if not (np.isfinite(means).all() and np.isfinite(covs).all()):
        raise AssertionError("non-finite posterior moments")

    # sampled chains against the float64 oracle
    rows = sorted({0, 1, b // 2, b - 1})
    hinv = h.T @ np.linalg.inv(r)
    w_obs = hinv @ h
    o_m, o_p = lgssm_rows_oracle(b, t_len, d, tuple(rows))
    errs = {
        "means": np.abs(means[rows] - np.moveaxis(o_m, 0, 1)).max(),
        "covs": np.abs(covs[rows] - np.moveaxis(o_p, 0, 1)).max(),
    }
    log(f"[main] float64 oracle, chains {rows}: max abs err means "
        f"{errs['means']:.3g}, covs {errs['covs']:.3g} (tol {ORACLE_TOL})")
    if max(errs.values()) > ORACLE_TOL:
        raise AssertionError(f"main path disagrees with the float64 oracle: {errs}")

    # infer_batched at a smaller batch: same rows, same answers
    b_small = min(64, b)
    res = rt.infer_batched(model, {"y": y[:b_small]}, device=device)
    px = res.posteriors["x"]
    diff = float((px.mu - post.mu[:b_small]).abs().max())
    log(f"[main] infer_batched B={b_small}: max |mean - batched_program mean| "
        f"= {diff:.3g}")
    if px.mu.shape != (b_small, t_len, d) or diff > 1e-4:
        raise AssertionError("infer_batched disagrees with batched_program")

    # the unfused chain path (phase 9) runs the same model on the same data
    out = {"errs": errs, "launches": launches, "model": model, "y": y}
    if device.type != "cuda":
        return out

    # -- timing: the program and each stage alone --------------------------------
    out["program_ms"] = _cuda_ms(lambda: prog({"y": y}), reps)
    out["updates_per_s"] = 3 * t_len * b / (out["program_ms"] / 1e3)
    ek = torch.as_tensor(hinv.astype(np.float32), device=device)
    xi_t = torch.einsum("if,btf->tbi", ek, y).contiguous()
    out["einsum_ms"] = _cuda_ms(
        lambda: torch.einsum("if,btf->tbi", ek, y).contiguous(), reps)
    m0_t = torch.as_tensor(m0, device=device).expand((b, d)).contiguous()
    p0_t = torch.as_tensor(p0, device=device).expand((b, d, d)).contiguous()
    zeros = np.zeros(d, np.float32)
    mf, pf = fs.fused_forward(m0_t, p0_t, xi_t, f, zeros, q, w_obs)
    ms, ps, cr = fs.fused_backward(mf, pf, f, zeros, q)
    out["fwd_ms"] = _cuda_ms(
        lambda: fs.fused_forward(m0_t, p0_t, xi_t, f, zeros, q, w_obs), reps)
    out["bwd_ms"] = _cuda_ms(lambda: fs.fused_backward(mf, pf, f, zeros, q),
                             reps)
    out["unpack_ms"] = _cuda_ms(lambda: fs.sym_unfold_t(ps, d), reps)
    out["profile"] = _device_profile(lambda: prog({"y": y}),
                                     SMOOTHER_KERNEL_NAMES)
    busy = out["profile"]["busy_ms"]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out["blocks"] = fs.pick_blocks(b, t_len, d, sms)
    slots = out["blocks"] if out["blocks"] > 1 else 0
    out["scratch_bytes"] = {
        "fused_smoother_fwd": 4 * slots * fs.forward_scratch_rows(d) * b,
        "fused_smoother_bwd": 4 * slots * fs.backward_scratch_rows(d) * b}
    log(f"[main] program {out['program_ms']:.3f} ms/call "
        f"({out['updates_per_s']:.4g} updates/s); stages alone: einsum "
        f"{out['einsum_ms']:.3f} ms, K1 {out['fwd_ms']:.3f} ms, K2 "
        f"{out['bwd_ms']:.3f} ms, covariance unpack {out['unpack_ms']:.3f} ms"
        f"; device busy {busy} ms per program call, idle "
        f"{_idle_share(out['program_ms'], busy)}; in the program "
        f"{out['profile']['kernels']}")
    for label, k in (("K1", "fused_smoother_fwd"), ("K2", "fused_smoother_bwd")):
        parts = out["profile"]["kernels"][k].get("parts", {})
        log(f"[main] {label} in the program, {out['blocks']} time blocks of "
            f"{-(-t_len // out['blocks'])} steps, scratch "
            f"{out['scratch_bytes'][k]} bytes: " + (", ".join(
                f"{n.split('_')[1]} {ms:.4f} ms" for n, ms in parts.items())
                or "passes not measured"))

    return out


# -- slice 3: the streaming filter (K3) and the quantized payloads (K6-K8) --------

def _bound(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return {"bytes": nbytes, "ops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _count_ops(fn) -> int:
    _OpCount.n = 0
    fn()
    return _OpCount.n


def _schur_product_ops(n: int, levels: int) -> int:
    """Operations of the plain ``sym_inv``'s block products (X = A^-1 B, the
    Schur complement, X S^-1 and the top-left block) at size n and the
    ``levels - 1`` levels below it: the inverse's count less those of its
    two half-size inverses."""
    from rxinfer_tpu_torch.ops import entrywise as ew

    if levels == 0 or n <= 2:
        return 0
    sym = lambda k: _count_ops(lambda: ew.sym_inv(
        [[_OpCount() for _ in range(k)] for _ in range(k)]))
    k = n // 2
    return (sym(n) - sym(k) - sym(n - k) + _schur_product_ops(k, levels - 1)
            + _schur_product_ops(n - k, levels - 1))


def filter_bound(b: int, t: int, d: int, dy: int) -> dict:
    """Least time the card could take for K3 at (B, T, d, dy): observations
    and initial state read once, means and final state written once, against
    the operations of T chain-steps (the plain step run on counting
    stand-ins) at the float32 rate.  Where a tier runs products on the
    tensor cores, those operations are priced at the 3xTF32 rate instead,
    the rest (leaves, scaling, vectors, the evidence) at the float32 rate,
    the two times added (``bound_ms``): at the wide K3 (``launch_key``
    "fused_filter_wide": 8 < d <= 16, or d <= 8 with dy > 8) F P F^T + Q,
    both inverses' block products at the top level of the Schur recursion
    and the evidence xi = HR y; at the warp K3's tensor-core tier (16 < d <=
    32) F P F^T + Q and the inverses' block products at the top two levels;
    at its tier past 32 (32 < d <= 64) the same at the top three levels
    (the Schur blocks at 64 or 48, 32 and 16); at its tier past 64 (64 < d
    <= 128) at the top four (128, 64, 32, 16).  ``bound_ms_fp32`` prices
    every operation at the float32 rate."""
    from rxinfer_tpu_torch.ops import entrywise as ew
    from rxinfer_tpu_torch.ops import fused_filter as ff

    nsym = d * (d + 1) // 2
    nbytes = (t * dy * b + t * d * b + 2 * (d + nsym) * b) * 4
    par = [[0.5] * d for _ in range(d)]
    ops = _count_ops(lambda: ff.filter_step(
        [_OpCount() for _ in range(d)],
        [[_OpCount() for _ in range(d)] for _ in range(d)],
        [_OpCount() for _ in range(dy)], par, par, par,
        [[0.5] * dy for _ in range(d)]))
    levels = 0
    if ff.launch_key(d, dy) == "fused_filter_wide":
        levels = 1
    elif ff.WIDE_MAX_DIM < d <= ff.TC_DIM:
        levels = 2
    elif ff.TC_DIM < d <= ff.TC64_DIM:
        levels = 3
    elif ff.TC64_DIM < d <= ff.TC128_DIM:
        levels = 4
    tc_ops = 0
    if levels:
        tc_ops = _count_ops(lambda: ew.sandwich_sym(
            par, [[_OpCount() for _ in range(d)] for _ in range(d)], par)) \
            + 2 * _schur_product_ops(d, levels)
    if levels == 1:
        tc_ops += _count_ops(lambda: ew.mat_vec(
            [[0.5] * dy for _ in range(d)], [_OpCount() for _ in range(dy)]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ((ops - tc_ops) / FP32_FLOPS + tc_ops / TF32X3_FLOPS) * t * b * 1e3
    t_fp32 = ops / FP32_FLOPS * t * b * 1e3
    return {"bytes": nbytes, "ops": ops * t * b,
            "ops_tensor_cores": tc_ops * t * b,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_fp32": max(t_bytes, t_fp32)}


def quantize_bound(r: int, c: int) -> dict:
    """K6 / K7 at (R, C): float32 in, one byte a value and one scale a row
    out; per element an abs, a max, a division and the rounding (int8: with
    its two clips)."""
    return _bound(r * c * 4 + r * c + r * 4, 6 * r * c)


def dequant_bound(r: int, dy: int, dx: int) -> dict:
    """K8 at (R, dy, dx): payload, scales and W in, float32 (R, dx) out; dy
    dequantizing multiplies and dy * dx multiply-adds a row."""
    return _bound(r * (dy + 4 + dx * 4) + dy * dx * 4, r * (dy + 2 * dy * dx))


def filter_float64(m0, p0, ys, f, q, h, r):
    """Information-form Kalman filter in float64 numpy for a few chains, the
    transition applied at every step: m0 (n, d), p0 (n, d, d), ys (T, n, dy).
    Returns means (T, n, d) and the final (m, P)."""
    f, q, h, r = (np.asarray(a, np.float64) for a in (f, q, h, r))
    hr = h.T @ np.linalg.inv(r)
    w = hr @ h
    m = np.asarray(m0, np.float64)
    p = np.asarray(p0, np.float64)
    means = np.empty((ys.shape[0],) + m.shape)
    for t in range(ys.shape[0]):
        m = m @ f.T
        p = f @ p @ f.T + q
        lam = np.linalg.inv(p)
        p = np.linalg.inv(lam + w)
        m = np.einsum("nij,nj->ni", p, np.einsum("nij,nj->ni", lam, m)
                      + np.asarray(ys[t], np.float64) @ hr.T)
        means[t] = m
    return means, m, p


def _filter_system(d: int, dy: int, seed: int):
    """A stable random system with a (dy, d) observation matrix."""
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    h = (1.2 * np.eye(dy, d) + 0.2 * rng.standard_normal((dy, d))).astype(
        np.float32)
    r = (0.8 * np.eye(dy) + 0.1 * np.ones((dy, dy))).astype(np.float32)
    return f, q, h, r


def _soa_state(m, p):
    """(B, d), (B, d, d) -> the kernel's batch-minor (d, B), (nsym, B)."""
    from rxinfer_tpu_torch.ops.fused_smoother import sym_fold

    return m.t().contiguous(), sym_fold(p).contiguous()


def check_filter_kernel(device, shapes, log=print, seed: int = 300) -> dict:
    """Phase 6 for K3 (and phase 16 (c) for the wide K3): the wrapper
    against its plain version on the same inputs (the plain version on CPU
    copies of them), and chains of the first shape against the float64
    filter.  Each call must count under its launch key (``fused_filter``
    for d, dy <= 8, else ``fused_filter_wide``).  A shape is (B, T, d, dy)
    and, optionally, the prior's scale (P0 = scale I; 9 without it).
    Returns each launch key's max abs error against the plain version."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff

    worst = {}
    before = dict(ff.LAUNCHES)
    want_launches = {key: 0 for key in ff.LAUNCHES}
    failures = []
    for i, (bsz, t_len, d, dy, *scale) in enumerate(shapes):
        p0_scale = scale[0] if scale else 9.0
        key = ff.launch_key(d, dy)
        want_launches[key] += 1
        f, q, h, r = _filter_system(d, dy, seed=seed + i)
        w_obs, hr = ff.evidence_operators(h, r)
        rng = np.random.default_rng(seed + i)
        ys = torch.as_tensor(rng.standard_normal((t_len, dy, bsz)).astype(
            np.float32), device=device)
        m = torch.as_tensor(rng.standard_normal((bsz, d)).astype(np.float32),
                            device=device)
        p = torch.as_tensor(np.broadcast_to(
            p0_scale * np.eye(d, dtype=np.float32), (bsz, d, d)).copy(),
            device=device)
        m0, p0 = _soa_state(m, p)
        got = ff.fused_filter(m0, p0, ys, f, q, hr, w_obs)
        want = _on_host(ff.fused_filter_reference, m0, p0, ys, f, q, hr,
                        w_obs)
        torch.cuda.synchronize()
        parts = []
        for label, g, w in zip(("means", "final m", "final P"), got, want):
            ea, er, ok = _max_err(g.cpu().numpy(), w.cpu().numpy())
            worst[key] = max(worst.get(key, 0.0), ea)
            parts.append(f"{label} abs {ea:.3g} rel {er:.3g}")
            if not ok:
                failures.append(f"(B,T,d,dy)=({bsz},{t_len},{d},{dy}) "
                                f"P0={p0_scale:g} I {label}:"
                                f" abs {ea:.3g} rel {er:.3g}")
        log(f"[check] K3 {key} (B,T,d,dy)=({bsz},{t_len},{d},{dy}) "
            f"P0={p0_scale:g} I: " + "; ".join(parts))
        if i == 0:
            idx = [0, 1, bsz // 2, bsz - 1]
            o_means, o_m, _ = filter_float64(
                m[idx].cpu().numpy(), p[idx].cpu().numpy(),
                ys[:, :, idx].transpose(1, 2).cpu().numpy(), f, q, h, r)
            err = max(
                float(np.abs(got[0][:, :, idx].transpose(1, 2).cpu().numpy()
                             - o_means).max()),
                float(np.abs(got[1][:, idx].t().cpu().numpy() - o_m).max()))
            log(f"[check] K3 vs float64 filter, chains {idx}: {err:.3g} "
                f"(tol {ORACLE_TOL})")
            if err > ORACLE_TOL:
                failures.append(f"float64 filter: {err:.3g}")
    if failures:
        raise AssertionError("filter kernel disagrees beyond rtol=atol="
                             f"{RTOL}: " + "; ".join(failures))
    rose = {key: ff.LAUNCHES[key] - before[key] for key in before}
    if rose != want_launches:
        raise AssertionError(f"fused_filter launch counters rose {rose}, "
                             f"expected {want_launches}")
    return worst


def _quant_rows(r: int, c: int, seed: int, device, start: int = 0):
    """Rows with scales spread over e^-3 .. e^3 and, where there is more
    than one row, a zero row; a contiguous view ``start`` floats into its
    storage."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((r * c + start,), generator=gen, device=device)
    x = x[start:].view(r, c)
    x.mul_(torch.exp(6.0 * torch.rand((r, 1), generator=gen, device=device)
                     - 3.0))
    if r > 1:
        x[1] = 0.0
    return x


def _layout_name(layout) -> str:
    return f"{layout.variant}(group={layout.group}, rows_per_thread=" \
        f"{layout.rows_per_thread}, vecs={layout.vecs})"


def check_quant_kernels(device, log=print) -> tuple[dict, dict]:
    """Phase 6 for K6, K7, K8.  Quantize: payload bytes and scales equal to
    the plain version's, the zero row all zeros, at every entry of
    QUANT_CHECK_SHAPES, each of the kernels' layouts taken at least once.
    Dequantize + product: EQUAL to the plain version on both payload types
    at every entry of DEQUANT_CHECK_SHAPES, each of its layouts taken.
    Returns per-kernel max abs error (payloads decoded to float32) and the
    layout each shape took (``quantize``: (R, C, start), ``dequant``:
    (R, dy, dx, start))."""
    import torch

    from rxinfer_tpu_torch.ops import quantized as tq

    worst = {k: 0.0 for k in tq.LAUNCHES}
    before = dict(tq.LAUNCHES)
    failures = []
    pairs = (("quantize_rows", tq.quantize_rows, tq.quantize_rows_reference),
             ("quantize_rows_fp8", tq.quantize_rows_fp8,
              tq.quantize_rows_fp8_reference))
    layouts = {}
    for i, (r, c, start) in enumerate(QUANT_CHECK_SHAPES):
        x = _quant_rows(r, c, seed=400 + i, device=device, start=start)
        parts = []
        for name, fn, ref in pairs:
            v, s = fn(x)
            layouts[(r, c, start)] = tq.device_quant_layout(x, v)
            v_r, s_r = ref(x)
            torch.cuda.synchronize()
            n_bytes = int((v.view(torch.uint8) != v_r.view(torch.uint8)).sum())
            n_scales = int((s != s_r).sum())
            err = float((v.float() - v_r.float()).abs().max())
            worst[name] = max(worst[name], err)
            parts.append(f"{name}: {n_bytes} payload bytes and {n_scales} "
                         f"scales differ, max |payload diff| {err:.3g}")
            if n_bytes or n_scales:
                failures.append(f"(R,C)=({r},{c}) {parts[-1]}")
            if r > 1 and bool(v[1].view(torch.uint8).any()):
                failures.append(f"(R,C)=({r},{c}) {name}: zero row not zero")
        log(f"[check] K6/K7 (R,C)=({r},{c}) start {start}, "
            f"{_layout_name(layouts[(r, c, start)])}: " + "; ".join(parts))
        del x
    taken = {(lay.variant, lay.rows_per_thread, min(lay.vecs, 2))
             for lay in layouts.values() if lay.variant == "narrow"}
    taken |= {(lay.variant,) for lay in layouts.values()
              if lay.variant != "narrow"}
    if not {("narrow", 1, 1), ("narrow", tq.NARROW_ROW_GROUPS, 1),
            ("narrow", 1, 2), ("wide",), ("general",)} <= taken:
        failures.append(f"the check shapes took only the layouts {taken}")
    for (r, c, start), lay in layouts.items():
        if start and lay.variant != "general":
            failures.append(f"(R,C)=({r},{c}) {start} floats into its "
                            f"storage took {lay}, not the general layout")
    dq_layouts, dq_tiles = {}, {}
    for i, (r, dy, dx, start) in enumerate(DEQUANT_CHECK_SHAPES):
        x = _quant_rows(r, dy, seed=500 + i, device=device)
        gen = torch.Generator(device=device).manual_seed(600 + i)
        w = torch.randn((dy, dx), generator=gen, device=device)
        parts = []
        for name, fn, _ in pairs:
            v, s = fn(x)
            if start:
                store = torch.empty(r * dy + start, dtype=v.dtype,
                                    device=device)
                v = store[start:].view(r, dy).copy_(v)
            got = tq.dequant_matmul(v, s, w)
            want = tq.dequant_matmul_reference(v, s, w)
            dq_layouts[(r, dy, dx, start)] = tq.device_dequant_layout(v, got)
            dq_tiles[(r, dy, dx, start)] = tq.device_dequant_tiles(dy, dx,
                                                                   device)
            torch.cuda.synchronize()
            n_diff = int((got.view(torch.int32)
                          != want.view(torch.int32)).sum())
            ea = float((got - want).abs().max())
            worst["dequant_matmul"] = max(worst["dequant_matmul"], ea)
            parts.append(f"{v.dtype}: {n_diff} outputs differ, max abs "
                         f"{ea:.3g}")
            if n_diff:
                failures.append(f"(R,dy,dx)=({r},{dy},{dx}) {parts[-1]}")
        log(f"[check] K8 (R,dy,dx)=({r},{dy},{dx}) start {start}, "
            f"{dq_layouts[(r, dy, dx, start)]}, W tiles "
            f"{dq_tiles[(r, dy, dx, start)]}: " + "; ".join(parts)
            + " (must be EQUAL)")
        del x
    taken = {(lay.variant, lay.rows_per_thread)
             for lay in dq_layouts.values()}
    if not {("vector", 4), ("vector", 1), ("general", 1)} <= taken:
        failures.append(f"the K8 check shapes took only the layouts {taken}")
    whole = [k for k, t in dq_tiles.items() if t == k[1:3]]
    if not (any(dy * dx * 4 > 48 * 1024 for _, dy, dx, _ in whole)
            and len(whole) < len(dq_tiles)):
        failures.append(f"the K8 check shapes took only the W tiles "
                        f"{dq_tiles}")
    for (r, dy, dx, start), lay in dq_layouts.items():
        if start % 16 and lay.variant != "general":
            failures.append(f"K8 (R,dy,dx)=({r},{dy},{dx}) {start} bytes into "
                            f"its storage took {lay}, not the general layout")
    if failures:
        raise AssertionError("quantization kernels disagree with their plain "
                             "versions: " + "; ".join(failures))
    n_q, n_d = len(QUANT_CHECK_SHAPES), len(DEQUANT_CHECK_SHAPES)
    rose = {k: tq.LAUNCHES[k] - before[k] for k in before}
    if rose != {"quantize_rows": n_q + n_d, "quantize_rows_fp8": n_q + n_d,
                "dequant_matmul": 2 * n_d}:
        raise AssertionError(f"quantized launch counters rose by {rose}")
    return worst, {"quantize": layouts, "dequant": dq_layouts,
                   "dequant_tiles": dq_tiles}


def filter_path(device, b: int, t_len: int, d: int, reps: int,
                log=print, plain_steps: int | None = None,
                tag: str = "filter", inner: int = 20,
                warm_sync: bool = False,
                plain_chains: int | None = None) -> dict:
    """Phase 7, path A: the continuous-batching filter at (B, T, d), d = dy
    (phase 16 (d) at d = 16, on the wide K3; phase 17 (b) at d = 32, on the
    warp K3; phase 26 (a) at d = 64, on its tier past 32).  The kernel is
    held against its plain version on the path's own inputs, over the first
    ``plain_steps`` steps when given (the plain step at d = 16 is ~10^4
    small launches), and that one call of the plain version is its time;
    with ``plain_chains`` the plain version runs on the host on that many
    of the sampled chains (``plain_device`` "host"), else on the card.  K3
    alone is timed over ``inner`` launches back to back a round;
    ``warm_sync`` waits for each launch that brings the clock up (a kernel
    of tens of ms: half a second of launches enqueued without waiting runs
    for tens of seconds).  The profile also lists the call's top device
    kernels."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.parallel.filtering import (
        FilterState,
        make_sharded_filtering,
    )

    f, q, h, r, m0, p0 = lgssm_constants(d)
    rng = np.random.default_rng(0)
    ys_host = rng.standard_normal((t_len, b, d)).astype(np.float32)
    ys = torch.as_tensor(ys_host, device=device)
    state = FilterState(
        torch.zeros((b, d), device=device),
        torch.as_tensor(p0, device=device).expand((b, d, d)).contiguous())
    fn = make_sharded_filtering(None, f, q, h, r, fused=True)
    key = ff.launch_key(d, d)

    reset_launches()
    final, means = fn(state, ys)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[{tag}] launches in one call: {launches}")
    expect_launches(launches, **{key: 1})
    if tuple(means.shape) != (t_len, b, d) or tuple(final.m.shape) != (b, d) \
            or tuple(final.p.shape) != (b, d, d):
        raise AssertionError("filter outputs have the wrong shape")
    if not all(bool(torch.isfinite(a).all())
               for a in (means, final.m, final.p)):
        raise AssertionError("non-finite filter outputs")

    rows = sorted({0, 1, b // 2, b - 1})
    o_means, o_m, o_p = filter_float64(
        np.zeros((len(rows), d)), np.broadcast_to(p0, (len(rows), d, d)),
        ys_host[:, rows], f, q, h, r)
    errs = {
        "means": float(np.abs(means[:, rows].cpu().numpy() - o_means).max()),
        "final_m": float(np.abs(final.m[rows].cpu().numpy() - o_m).max()),
        "final_p": float(np.abs(final.p[rows].cpu().numpy() - o_p).max()),
    }
    log(f"[{tag}] float64 filter, chains {rows}: {errs} (tol {ORACLE_TOL})")
    if max(errs.values()) > ORACLE_TOL:
        raise AssertionError(f"path A disagrees with the float64 filter: {errs}")

    # the kernel against its plain version on the path's own inputs
    w_obs, hr = ff.evidence_operators(h, r)
    m_soa, p_soa = _soa_state(state.m, state.p)
    ys_soa = ys.transpose(1, 2).contiguous()
    ys_plain = ys_soa[:plain_steps].contiguous() if plain_steps else ys_soa
    got = ff.fused_filter(m_soa, p_soa, ys_plain, f, q, hr, w_obs)
    if plain_chains:
        # the plain version on the host, on the sampled chains (computed
        # ahead in a check process: ``slice27_checks``)
        pick = rows[:plain_chains]
        got = tuple(g[..., pick] for g in got)
        want, plain_kernel_ms = filter_plain_rows(
            b, t_len, d, int(ys_plain.shape[0]), tuple(pick))
        want = [torch.as_tensor(w) for w in want]
    else:
        # the plain version's one call (2-4 s: thousands of small launches)
        # is its time as well
        want, plain_kernel_ms = _once_ms(lambda: ff.fused_filter_reference(
            m_soa, p_soa, ys_plain, f, q, hr, w_obs))
    kernel_err = 0.0
    for label, g, w in zip(("means", "final m", "final P"), got, want):
        ea, er, ok = _max_err(g.cpu().numpy(), w.cpu().numpy())
        kernel_err = max(kernel_err, ea)
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version on "
                                 f"path A's inputs, {label}: abs {ea:.3g}")
    log(f"[{tag}] K3 vs plain version on the path's inputs over "
        f"{ys_plain.shape[0]} steps"
        + (f" of chains {rows[:plain_chains]} (the plain version on the "
           "host)" if plain_chains else "")
        + f": max abs {kernel_err:.3g} (rtol=atol={RTOL})")

    out = {"errs": errs, "launches": launches, "kernel_err": kernel_err,
           "plain_kernel_ms": plain_kernel_ms,
           "plain_steps": int(ys_plain.shape[0]),
           "plain_chains": len(rows[:plain_chains]) if plain_chains else b,
           "plain_device": "host" if plain_chains else "card"}
    out["call_ms"] = _cuda_ms(lambda: fn(state, ys), reps)
    out["updates_per_s"] = b * t_len / (out["call_ms"] / 1e3)
    k3 = lambda: ff.fused_filter(m_soa, p_soa, ys_soa, f, q, hr, w_obs)
    with SmClock() as clk:
        end = time.perf_counter() + 0.5     # launches that bring the clock up
        while time.perf_counter() < end:
            k3()
            if warm_sync:
                torch.cuda.synchronize()
        out["kernel_ms"] = _cuda_ms(k3, reps, inner=inner)
    out["sm_clock_mhz"] = clk.mhz
    out["layout_ms"] = _cuda_ms(lambda: ys.transpose(1, 2).contiguous(), reps,
                                inner=20)
    out["profile"] = _device_profile(
        lambda: fn(state, ys), {key: FILTER_KERNEL_NAMES[key]}, top=4)
    busy = out["profile"]["busy_ms"]
    out["cycles_per_step"] = _cycles_per_step(
        out["profile"]["kernels"][key]["ms_per_launch"],
        out["sm_clock_mhz"], t_len)
    log(f"[{tag}] call {out['call_ms']:.4f} ms ({out['updates_per_s']:.4g} "
        f"chain-updates/s); K3 {out['cycles_per_step']} cycles a step in "
        f"the call at {out['sm_clock_mhz']:.0f} MHz; alone: K3 "
        f"{out['kernel_ms']:.4f} ms, observation "
        f"layout copy {out['layout_ms']:.4f} ms; K3's plain version "
        f"{out['plain_kernel_ms']:.1f} ms ({out['plain_device']}); device "
        f"busy {busy} ms per call, idle {_idle_share(out['call_ms'], busy)};"
        f" in the call {out['profile']['kernels']}, top device kernels "
        f"[name, launches, ms] {out['profile'].get('top')}")
    return out


def quantized_program_path(device, b: int, t_len: int, d: int, reps: int,
                           log=print) -> dict:
    """Phase 8 (i), path B: the LGSSM program on quantized observations."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine.batched import quantize_observations
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import quantized as tq

    f, q, h, r, m0, p0 = lgssm_constants(d)
    model = zoo.lgssm(f, q, h, r, m0, p0)
    y = torch.as_tensor(lgssm_y(b, t_len, d), device=device)
    dtypes = {"int8": ("quantize_rows", INT8_LEVEL),
              "float8_e4m3fn": ("quantize_rows_fp8", FP8_LEVEL)}
    out: dict = {"launches": {}, "program_ms": {}, "errs": {}}

    built: dict = {}

    def program(iterations, obs_dtype=None):
        key = (iterations, obs_dtype)
        if key not in built:
            opts = {"observation_dtype": obs_dtype} if obs_dtype else None
            built[key] = rt.batched_program(
                model, {"y": y}, iterations=iterations, free_energy=False,
                options=opts, device=device)[1]
        return built[key]

    for iterations in QUANT_ITERATIONS:
        n_reps = reps if iterations == 1 else max(3, reps // 2)
        prog_f = program(iterations)
        mu_f = prog_f({"y": y})[0]["x"].mu
        scale = float(mu_f.abs().max())
        out["program_ms"][("float32", iterations)] = _cuda_ms(
            lambda: prog_f({"y": y}), n_reps)
        for obs_dtype, (kname, level) in dtypes.items():
            prog_q = program(iterations, obs_dtype)
            reset_launches()
            mu_q = prog_q({"y": y})[0]["x"].mu
            torch.cuda.synchronize()
            launches = read_launches()
            expect_launches(launches, fused_smoother_fwd=iterations,
                            fused_smoother_bwd=iterations, **{kname: 1})
            out["launches"][(obs_dtype, iterations)] = launches
            vals, scales = quantize_observations(y, obs_dtype)
            y_hat = (vals.to(torch.float32) * scales).transpose(1, 2)
            mu_hat = prog_f({"y": y_hat.contiguous()})[0]["x"].mu
            torch.cuda.synchronize()
            errs = {
                "vs_float32_share": float((mu_q - mu_f).abs().max()) / scale,
                "vs_float32_on_dequantized": float(
                    (mu_q - mu_hat).abs().max()),
            }
            out["errs"][(obs_dtype, iterations)] = errs
            if not bool(torch.isfinite(mu_q).all()) \
                    or errs["vs_float32_share"] > level \
                    or errs["vs_float32_on_dequantized"] > DEQ_TOL:
                raise AssertionError(
                    f"path B, {obs_dtype} at {iterations} iterations: {errs} "
                    f"(levels {level} and {DEQ_TOL})")
            out["program_ms"][(obs_dtype, iterations)] = _cuda_ms(
                lambda: prog_q({"y": y}), n_reps)
            del mu_q, mu_hat, y_hat, vals, scales
        log(f"[quant] iterations={iterations}: program ms "
            + ", ".join(f"{k} {out['program_ms'][(k, iterations)]:.3f}"
                        for k in ("float32", *dtypes))
            + "; launches "
            + ", ".join(f"{k} {out['launches'][(k, iterations)][v[0]]} x {v[0]}"
                        for k, v in dtypes.items())
            + "; errors "
            + ", ".join(f"{k} {out['errs'][(k, iterations)]}" for k in dtypes))

    # stages alone at the engine's shapes: the quantize kernels on the rows
    # (B*F, T), and the evidence einsum on the payload and on float32
    rows = y.transpose(1, 2).reshape(b * d, t_len).contiguous()
    ek = torch.as_tensor((h.T @ np.linalg.inv(r)).astype(np.float32),
                         device=device)
    out["einsum_ms"] = {"float32": _cuda_ms(
        lambda: torch.einsum("if,btf->tbi", ek, y), reps)}
    out["kernel_ms"], out["plain_ms"] = {}, {}
    for obs_dtype, fn, ref in (
            ("int8", tq.quantize_rows, tq.quantize_rows_reference),
            ("float8_e4m3fn", tq.quantize_rows_fp8,
             tq.quantize_rows_fp8_reference)):
        kname = dtypes[obs_dtype][0]
        out["kernel_ms"][kname] = _cuda_ms(lambda: fn(rows), reps, inner=20)
        out["plain_ms"][kname] = _cuda_ms(lambda: ref(rows), reps)
        out["layout"] = _layout_name(tq.device_quant_layout(rows,
                                                            fn(rows)[0]))
        vals, scales = quantize_observations(y, obs_dtype)
        out["einsum_ms"][obs_dtype] = _cuda_ms(
            lambda: torch.einsum("if,bft->tbi", ek,
                                 vals.to(torch.float32) * scales), reps)
    # yardstick only: a device copy of the same rows, read and write counted
    out["copy_ms"] = _cuda_ms(lambda: torch.empty_like(rows).copy_(rows),
                              reps, inner=20)
    out["copy_bytes_per_s"] = 2 * rows.numel() * 4 / (out["copy_ms"] / 1e3)
    out["profile"] = {}
    for obs_dtype in dtypes:
        prog_q = program(QUANT_ITERATIONS[-1], obs_dtype)
        out["profile"][obs_dtype] = _device_profile(
            lambda: prog_q({"y": y}),
            {**SMOOTHER_KERNEL_NAMES,
             dtypes[obs_dtype][0]: QUANT_KERNEL_NAMES[dtypes[obs_dtype][0]]})
    log(f"[quant] alone at rows {tuple(rows.shape)}, {out['layout']}: "
        + ", ".join(f"{k} {v:.4f} ms (plain {out['plain_ms'][k]:.3f} ms)"
                    for k, v in out["kernel_ms"].items())
        + f"; copy of the rows {out['copy_ms']:.4f} ms = "
        f"{out['copy_bytes_per_s'] / 1e9:.0f} GB/s"
        + "; evidence einsum ms " + ", ".join(
            f"{k} {v:.3f}" for k, v in out["einsum_ms"].items())
        + f"; in the {QUANT_ITERATIONS[-1]}-iteration program "
        + ", ".join(f"{k}: busy {v['busy_ms']} ms, {v['kernels']}"
                    for k, v in out["profile"].items()))
    return out


def quantized_ingest_path(device, shape, reps: int, log=print) -> dict:
    """Phase 8 (ii), path B: ``quantized_evidence`` and its fp8 form at
    (R, dy, dx)."""
    import torch

    from rxinfer_tpu_torch.ops import quantized as tq

    r, dy, dx = shape
    rng = np.random.default_rng(2)
    y = torch.as_tensor(
        3.0 * rng.standard_normal((r, dy), dtype=np.float32), device=device)
    w = torch.as_tensor(rng.standard_normal((dy, dx)).astype(np.float32),
                        device=device)
    exact = y @ w
    scale = float(exact.abs().max())
    nbytes = r * (dy + 4 + dx * 4)          # the JAX package's bench count
    out: dict = {"launches": {}, "errs": {}, "call_ms": {}, "quantize_ms": {},
                 "dequant_ms": {}, "dequant_plain_ms": {},
                 "dequant_bytes_per_s": {}, "quantize_plain_ms": {},
                 "dequant_device_ms": {}}
    for label, fn, quant, ref, kname, level in (
            ("int8", tq.quantized_evidence, tq.quantize_rows,
             tq.quantize_rows_reference, "quantize_rows", INT8_LEVEL),
            ("float8_e4m3fn", tq.quantized_evidence_fp8, tq.quantize_rows_fp8,
             tq.quantize_rows_fp8_reference, "quantize_rows_fp8", FP8_LEVEL)):
        reset_launches()
        xi = fn(y, w)
        torch.cuda.synchronize()
        launches = read_launches()
        expect_launches(launches, dequant_matmul=1, **{kname: 1})
        out["launches"][label] = launches
        err = float((xi - exact).abs().max()) / scale
        out["errs"][label] = err
        if tuple(xi.shape) != (r, dx) or not bool(torch.isfinite(xi).all()) \
                or err > level:
            raise AssertionError(f"quantized ingest, {label}: error share "
                                 f"{err:.3g} (level {level})")
        vals, scales = quant(y)
        out["call_ms"][label] = _cuda_ms(lambda: fn(y, w), reps, inner=10)
        out["quantize_ms"][label] = _cuda_ms(lambda: quant(y), reps, inner=20)
        out["quantize_plain_ms"][label] = _cuda_ms(lambda: ref(y), reps)
        out["layout"] = _layout_name(tq.device_quant_layout(y, vals))
        out["dequant_ms"][label] = _cuda_ms(
            lambda: tq.dequant_matmul(vals, scales, w), reps, inner=20)
        out["dequant_layout"] = str(tq.device_dequant_layout(vals, xi))
        # the wrapper's Python takes about as long as the kernel, so the
        # events above time the host: the device time of 20 launches
        out["dequant_device_ms"][label] = _device_profile(
            lambda: [tq.dequant_matmul(vals, scales, w) for _ in range(20)],
            {"dequant_matmul": QUANT_KERNEL_NAMES["dequant_matmul"]})[
            "kernels"]["dequant_matmul"]["ms_per_launch"]
        out["dequant_plain_ms"][label] = _cuda_ms(
            lambda: tq.dequant_matmul_reference(vals, scales, w), reps)
        dq_ms = out["dequant_device_ms"][label]
        out["dequant_bytes_per_s"][label] = nbytes / (
            (dq_ms if isinstance(dq_ms, float) else out["dequant_ms"][label])
            / 1e3)
        if label == "int8":
            # yardstick only: the product alone, on the matrix already
            # dequantized to float32
            deq = vals.to(torch.float32) * scales
            out["library_ms"] = _cuda_ms(lambda: torch.matmul(deq, w), reps,
                                         inner=20)
            del deq
    # yardstick only: a device copy of the same rows, read and write counted
    out["copy_ms"] = _cuda_ms(lambda: torch.empty_like(y).copy_(y), reps,
                              inner=20)
    out["copy_bytes_per_s"] = 2 * y.numel() * 4 / (out["copy_ms"] / 1e3)
    # and of K8's payload and output
    out["copy_payload_ms"] = _cuda_ms(
        lambda: torch.empty_like(vals).copy_(vals), reps, inner=20)
    out["copy_out_ms"] = _cuda_ms(lambda: torch.empty_like(xi).copy_(xi),
                                  reps, inner=20)
    out["copy_dequant_bytes_per_s"] = 2 * (vals.numel() + xi.numel() * 4) / (
        (out["copy_payload_ms"] + out["copy_out_ms"]) / 1e3)
    # three calls a recorded step: the profiler can lose the device event
    # of a step's first launch, and the per-launch time is over those found
    out["profile"] = _device_profile(
        lambda: [tq.quantized_evidence(y, w) for _ in range(3)],
        {k: QUANT_KERNEL_NAMES[k] for k in ("quantize_rows",
                                           "dequant_matmul")})
    out["profile_fp8"] = _device_profile(
        lambda: [tq.quantized_evidence_fp8(y, w) for _ in range(3)],
        {k: QUANT_KERNEL_NAMES[k] for k in ("quantize_rows_fp8",
                                           "dequant_matmul")})
    log(f"[ingest] (R,dy,dx)={shape}: "
        + "; ".join(
            f"{k}: call {out['call_ms'][k]:.4f} ms, quantize "
            f"{out['quantize_ms'][k]:.4f} ms (plain "
            f"{out['quantize_plain_ms'][k]:.3f}), dequant+product "
            f"{out['dequant_device_ms'][k]} ms device, "
            f"{out['dequant_ms'][k]:.4f} between events (plain "
            f"{out['dequant_plain_ms'][k]:.3f}) = "
            f"{out['dequant_bytes_per_s'][k]:.4g} B/s, error share "
            f"{out['errs'][k]:.3g}" for k in out["call_ms"])
        + f"; float32 matmul on the dequantized matrix {out['library_ms']:.4f}"
        f" ms; dequantize layout {out['dequant_layout']}; copy of the payload"
        f" and of the output {out['copy_dequant_bytes_per_s'] / 1e9:.0f} "
        f"GB/s; quantize layout {out['layout']}; copy of y "
        f"{out['copy_ms']:.4f} ms = {out['copy_bytes_per_s'] / 1e9:.0f} GB/s"
        f"; in three int8 calls {out['profile']['kernels']}, in three fp8 "
        f"calls {out['profile_fp8']['kernels']}")
    return out


# -- the single-dataset infer and the unfused chain path -------------------------

def _lgssm_oracle(y_host, d, w_steps=None):
    """Smoothed means (n, T, d) and covariances (n, T, d, d) of the LGSSM
    with ``lgssm_constants`` for the chains y_host (n, T, d), float64;
    ``w_steps`` (T, n) zeroes the evidence of the steps where it is 0."""
    f, q, h, r, m0, p0 = lgssm_constants(d)
    n, t_len, _ = y_host.shape
    hinv = (h.T @ np.linalg.inv(r)).astype(np.float64)
    xi = np.einsum("ij,ntj->tni", hinv, np.nan_to_num(y_host).astype(
        np.float64))
    w = hinv @ h
    if w_steps is not None:
        xi = xi * w_steps[..., None]
        w = w_steps[..., None, None] * w
    o_m, o_p = rts_float64(np.broadcast_to(m0, (n, d)),
                           np.broadcast_to(p0, (n, d, d)), xi, f,
                           np.zeros(d), q, w)
    return np.moveaxis(o_m, 0, 1), np.moveaxis(o_p, 0, 1)


def infer_lgssm_path(device, t_len: int, d: int, reps: int,
                     log=print) -> dict:
    """Phase 9 (a): ``rxinfer_tpu_torch.infer`` on one LGSSM dataset of T
    steps (the JAX package's single-chain row): the associative-scan
    smoother in torch, no kernel."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    model = zoo.lgssm(*lgssm_constants(d))
    y = torch.as_tensor(infer_lgssm_y(t_len, d), device=device)
    call = lambda: rt.infer(model, data={"y": y}, device=device)
    reset_launches()
    res = call()
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(launches)
    post = res.posteriors["x"]
    means, covs = post.mean().cpu().numpy(), post.cov().cpu().numpy()
    if means.shape != (t_len, d) or covs.shape != (t_len, d, d) or not (
            np.isfinite(means).all() and np.isfinite(covs).all()):
        raise AssertionError("infer's LGSSM posterior has the wrong shape or "
                             "is not finite")
    o_m, o_p = infer_lgssm_oracle(t_len, d)
    errs = {"means": float(np.abs(means - o_m[0]).max()),
            "covs": float(np.abs(covs - o_p[0]).max())}
    if max(errs.values()) > ORACLE_TOL:
        raise AssertionError(f"infer disagrees with the float64 RTS: {errs}")
    out = {"errs": errs, "launches": launches}
    out["ms"] = _cuda_ms(call, reps)
    out["updates_per_s"] = 3 * t_len / (out["ms"] / 1e3)
    out["profile"] = _device_profile(call, {})
    busy = out["profile"]["busy_ms"]
    log(f"[infer] zoo.lgssm T={t_len} d={d}: {out['ms']:.3f} ms a call, "
        f"{out['updates_per_s']:.6g} updates/s; float64 RTS max abs err "
        f"means {errs['means']:.3g}, covs {errs['covs']:.3g} (tol "
        f"{ORACLE_TOL}); kernel launches {launches}; device busy {busy} ms "
        f"a call, idle {_idle_share(out['ms'], busy)}")
    return out


def infer_hmm_path(device, t_len: int, iterations: int, reps: int,
                   log=print) -> dict:
    """Phase 9 (b): ``infer`` on one dataset of the HMM path (phase 5's
    initialization): the associative-scan forward-backward in torch."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    y_host = simulate_hmm(1, t_len, seed=3)
    y = torch.as_tensor(y_host[0], device=device)
    a0 = np.full((3, 3), 1.0, np.float32)
    b0 = np.float32(np.eye(3) * 5.0 + 1.0)
    init = {"A": rt.DirichletCollection(a0), "B": rt.DirichletCollection(b0)}
    model = zoo.hmm(3, 3)
    call = lambda: rt.infer(model, data={"y": y}, iterations=iterations,
                            initialization=init, returnvars=rt.KeepLast(),
                            device=device)
    reset_launches()
    post = call().posteriors
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(launches)
    o_g, o_a, o_b = hmm_vmp_float64(y_host, a0, b0, iterations)
    errs = {
        "gammas": float(np.abs(post["s"].probs().cpu().numpy()
                               - o_g[0]).max()),
        "A_rel": float((np.abs(post["A"].alpha.cpu().numpy() - o_a[0])
                        / o_a[0]).max()),
        "B_rel": float((np.abs(post["B"].alpha.cpu().numpy() - o_b[0])
                        / o_b[0]).max()),
    }
    if errs["gammas"] > HMM_ORACLE_TOL["gammas"] or max(
            errs["A_rel"], errs["B_rel"]) > HMM_ORACLE_TOL["conc_rel"]:
        raise AssertionError(f"infer disagrees with the float64 VMP: {errs}")
    out = {"errs": errs, "launches": launches, "ms": _cuda_ms(call, reps)}
    log(f"[infer] zoo.hmm(3, 3) T={t_len}, {iterations} iterations: "
        f"{out['ms']:.3f} ms a call; float64 VMP {errs} (tol "
        f"{HMM_ORACLE_TOL}); kernel launches {launches}")
    return out


def unfused_path(device, main: dict, reps: int, log=print) -> dict:
    """Phase 9 (c): phase 4's LGSSM cell with ``fused_kernels=False``: the
    batched scans in torch against the fused program on the same data; the
    median of ``reps`` calls, the checked one among them."""
    import torch

    import rxinfer_tpu_torch as rt

    model, y = main["model"], main["y"]
    b, t_len, d = y.shape
    _, fused = rt.batched_program(model, {"y": y}, iterations=1,
                                  free_energy=False, device=device)
    compiled, prog = rt.batched_program(
        model, {"y": y}, iterations=1, free_energy=False, device=device,
        options={"fused_kernels": False})
    report = compiled.plan_report()["x"]
    if report.get("fused") is not False or "fused_kernels" not in report.get(
            "reason", ""):
        raise AssertionError(f"chain x is not on the unfused path: {report}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    reset_launches()
    (state, _, _), first_ms = _once_ms(lambda: prog({"y": y}))
    launches = read_launches()
    expect_launches(launches)
    peak = torch.cuda.max_memory_allocated(device) - base
    want, _, _ = fused({"y": y})
    errs = {"means": float((state["x"].mu - want["x"].mu).abs().max()),
            "covs": float((state["x"].sigma - want["x"].sigma).abs().max())}
    if not max(errs.values()) <= ORACLE_TOL:
        raise AssertionError(f"the unfused program disagrees with the fused "
                             f"one: {errs}")
    del state, want
    out = {"errs": errs, "launches": launches, "peak_bytes": peak,
           "bytes_per_step": peak / (b * t_len)}
    # the checked call is one of the ``reps`` timed (1.7 s a call on an
    # H100); the fused program's time is phase 4's, in this run
    out["ms"] = statistics.median([first_ms] + [
        _once_ms(lambda: prog({"y": y}))[1] for _ in range(reps - 1)])
    out["fused_ms"] = main["program_ms"]
    log(f"[unfused] LGSSM B={b} T={t_len} d={d}, fused_kernels=False: "
        f"{out['ms']:.3f} ms a call against the fused program's "
        f"{out['fused_ms']:.3f} ms ({out['ms'] / out['fused_ms']:.1f}x); "
        f"max |diff| to the fused posteriors {errs} (tol {ORACLE_TOL}); "
        f"peak {peak / 1e9:.2f} GB above the inputs "
        f"({out['bytes_per_step']:.0f} bytes a chain-step); kernel launches "
        f"{launches}")
    torch.cuda.empty_cache()
    return out


def nan_batch_path(device, b: int, t_len: int, d: int, log=print) -> dict:
    """Phase 9 (d): ``infer_batched`` on B LGSSM chains with 10% of the
    steps missing (NaN): the plan sends the chain to its scans, and sampled
    chains match the float64 RTS with no evidence at the missing steps."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    model = zoo.lgssm(*lgssm_constants(d))
    y_host = nan_batch_y(b, t_len, d)
    y = torch.as_tensor(y_host, device=device)
    compiled, _ = rt.batched_program(model, {"y": y}, device=device)
    report = compiled.plan_report()["x"]
    if report.get("fused") is not False or "missing" not in report.get(
            "reason", ""):
        raise AssertionError(f"the NaN batch is not on the unfused path: "
                             f"{report}")
    reset_launches()
    res, call_ms = _once_ms(lambda: rt.infer_batched(model, {"y": y},
                                                     device=device))
    launches = read_launches()
    expect_launches(launches)
    rows = edge_rows(b)
    seen = np.isfinite(y_host[rows]).all(-1).T.astype(np.float64)  # (T, n)
    o_m, o_p = nan_batch_oracle(b, t_len, d)
    post = res.posteriors["x"]
    errs = {"means": float(np.abs(post.mu[rows].cpu().numpy() - o_m).max()),
            "covs": float(np.abs(post.sigma[rows].cpu().numpy()
                                 - o_p).max())}
    if max(errs.values()) > ORACLE_TOL:
        raise AssertionError(f"the NaN batch disagrees with the float64 RTS:"
                             f" {errs}")
    log(f"[nan] infer_batched B={b} T={t_len} d={d}, "
        f"{100 * (1 - seen.mean()):.1f}% of the sampled steps missing: "
        f"{call_ms:.1f} ms (one call); float64 RTS with W = 0 at the missing "
        f"steps, chains {rows}: {errs} (tol {ORACLE_TOL}); kernel launches "
        f"{launches}")
    return {"errs": errs, "launches": launches, "ms": call_ms}


# -- slice 9: the dynamic-precision tier (K1/K2 with per-chain W and Q) ----------

def _spd_batch(rng, n: int, d: int, scale: float) -> np.ndarray:
    """n symmetric positive-definite (d, d) matrices around scale * I."""
    a = 0.3 * rng.standard_normal((n, d, d))
    return (scale * np.eye(d) + a @ np.swapaxes(a, -1, -2)).astype(np.float32)


def dynamic_bounds(b: int, t: int, d: int) -> dict:
    """K1/K2's bounds with a per-chain tile each (W for K1 on the path,
    Q for K2): the static kernels' bytes and operations plus nsym B floats
    read once."""
    nsym = d * (d + 1) // 2
    out = {}
    for name, row in kernel_bounds(b, t, d).items():
        nbytes = row["bytes"] + nsym * b * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = row["ops"] / FP32_FLOPS * 1e3
        out[name + "_dyn"] = {
            "bytes": nbytes, "ops": row["ops"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return out


def check_dynamic_kernels(device, shapes, log=print) -> dict:
    """Phase 10 (a): K1/K2 with per-chain W and/or Q against their plain
    versions on the same inputs, at each (B, T, d) and in each mode: W per
    chain, Q per chain, both.  K2 reads Q only, so its per-chain
    instantiation runs in the two modes with Q per chain (with W alone
    per chain the engine runs the static K2, checked in phase 3).  The
    plain versions run once a shape on the host, the modes' chains side by
    side (``_on_host``).  Returns each kernel's max abs error."""
    import torch

    from rxinfer_tpu_torch.ops import fused_smoother as fs

    worst = {"fused_smoother_fwd_dyn": 0.0, "fused_smoother_bwd_dyn": 0.0}
    before = dict(fs.LAUNCHES)
    failures = []
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for i, (bsz, t_len, d) in enumerate(shapes):
        blocks = fs.pick_blocks(bsz, t_len, d, sms)
        want_blocks = DYN_BLOCKED.get((bsz, t_len, d), 1)
        if sms == 132 and blocks != want_blocks:
            raise AssertionError(f"(B,T,d)=({bsz},{t_len},{d}): the wrapper "
                                 f"takes {blocks} time blocks, expected "
                                 f"{want_blocks}")
        f, b, q, w = _smoother_params(d, seed=500 + i)
        rng = np.random.default_rng(500 + i)
        dev = lambda a: torch.as_tensor(a, device=device)
        xi = dev(rng.standard_normal((t_len, bsz, d)).astype(np.float32))
        m0 = dev(rng.standard_normal((bsz, d)).astype(np.float32))
        p0 = dev(np.broadcast_to(9.0 * np.eye(d, dtype=np.float32),
                                 (bsz, d, d)).copy())
        wb = dev(_spd_batch(rng, bsz, d, 0.8))
        qb = dev(_spd_batch(rng, bsz, d, 0.4))
        wsh = dev(w).expand(bsz, d, d).contiguous()
        qsh = dev(q).expand(bsz, d, d).contiguous()
        # mode -> (shared W, shared Q, W per chain, Q per chain)
        modes = {"W": (None, q, wb, None), "Q": (w, None, None, qb),
                 "WQ": (None, None, wb, qb)}
        fwd, bwd = {}, {}
        for mode, (w_sh, q_sh, w_b, q_b) in modes.items():
            fwd[mode] = fs.fused_forward(m0, p0, xi, f, b, q_sh, w_sh, w_b,
                                         q_b)
            if q_b is not None:
                bwd[mode] = fs.fused_backward(*fwd[mode], f, b, None, q_b)
        torch.cuda.synchronize()
        cat = lambda got, k: torch.cat([v[k] for v in got.values()], dim=-1)
        mf_r, pf_r = _on_host(
            fs.fused_forward_reference, torch.cat([m0] * 3),
            torch.cat([p0] * 3), torch.cat([xi] * 3, dim=1), f, b, None,
            None, torch.cat([wb, wsh, wb]), torch.cat([qsh, qb, qb]))
        ms_r, ps_r, cr_r = _on_host(
            fs.fused_backward_reference, cat(fwd, 0)[..., bsz:],
            cat(fwd, 1)[..., bsz:], f, b, None, torch.cat([qb, qb]))
        rows = {
            "fused_smoother_fwd_dyn": [("mf", cat(fwd, 0), mf_r),
                                       ("pf", cat(fwd, 1), pf_r)],
            "fused_smoother_bwd_dyn": [("ms", cat(bwd, 0), ms_r),
                                       ("ps", cat(bwd, 1), ps_r),
                                       ("cross", cat(bwd, 2), cr_r)],
        }
        parts = []
        for kname, items in rows.items():
            for label, g, want in items:
                ea, er, ok = _max_err(g.cpu().numpy(), want.numpy())
                worst[kname] = max(worst[kname], ea)
                parts.append(f"{label} abs {ea:.3g} rel {er:.3g}")
                if not ok:
                    failures.append(f"(B,T,d)=({bsz},{t_len},{d}) {label}: "
                                    f"abs {ea:.3g} rel {er:.3g}")
        log(f"[dyn check] (B,T,d)=({bsz},{t_len},{d}) blocks {blocks}, K1 "
            f"modes {list(fwd)}, K2 modes {list(bwd)}: " + "; ".join(parts))
    if failures:
        raise AssertionError("a per-chain W/Q kernel disagrees with its plain"
                             f" version beyond rtol=atol={RTOL}: "
                             + "; ".join(failures))
    for k, modes_run in (("fused_smoother_fwd_dyn", 3),
                         ("fused_smoother_bwd_dyn", 2)):
        if fs.LAUNCHES[k] - before[k] != modes_run * len(shapes):
            raise AssertionError(f"{k}: launch counter did not rise once per "
                                 "checked shape and mode")
    return worst


def wtau_model(d: int):
    """bench.py:291-304's ``lgssm_wtau``: the LGSSM of ``lgssm_constants``
    with an unknown observation precision Wr ~ Wishart(d + 1, I), and its
    initialization."""
    import rxinfer_tpu_torch as rt

    f, q, _, _, m0, p0 = lgssm_constants(d)
    nu0 = float(d) + 1.0
    eye = np.eye(d, dtype=np.float32)

    @rt.model
    def lgssm_wtau(y):
        Tn = len(y)
        Wr = rt.Wishart(nu0, eye)
        x = rt.latent(Tn, name="x")
        x[0] = rt.MvNormal(mean=m0, cov=p0)
        for t in rt.plate(1, Tn):
            x[t] = rt.MvNormal(mean=f @ x[t - 1], cov=q)
        for t in rt.plate(Tn):
            y[t] = rt.MvNormal(mean=x[t], precision=Wr)

    return lgssm_wtau, {"Wr": rt.Wishart(nu0, eye)}


def wtau_vmp_float64(y, d: int, iterations: int):
    """Mean-field VMP of ``lgssm_wtau`` in float64 numpy for a few chains
    y (n, T, d), in the port's sweep order (x, then Wr): the RTS smoother
    with E[Wr] = nu S, then the Wishart update nu = nu0 + T,
    S = (I + sum_t (y_t - m_t)(y_t - m_t)^T + P_t)^-1.  Returns the smoothed
    means (n, T, d) and the Wishart (nu (n,), S (n, d, d))."""
    f, q, _, _, m0, p0 = lgssm_constants(d)
    y = np.asarray(y, np.float64)
    n, t_len, _ = y.shape
    nu0 = d + 1.0
    nu = np.full(n, nu0)
    s = np.broadcast_to(np.eye(d), (n, d, d)).copy()
    for _ in range(iterations):
        ew = nu[:, None, None] * s
        xi = np.einsum("nij,ntj->tni", ew, y)
        o_m, o_p = rts_float64(np.broadcast_to(m0, (n, d)),
                               np.broadcast_to(p0, (n, d, d)), xi, f,
                               np.zeros(d), q,
                               np.broadcast_to(ew, (t_len, n, d, d)))
        ms, ps = np.moveaxis(o_m, 0, 1), np.moveaxis(o_p, 0, 1)
        diff = y - ms
        scatter = (diff[..., :, None] * diff[..., None, :] + ps).sum(1)
        nu = np.full(n, nu0 + t_len)
        s = np.linalg.inv(np.eye(d) + scatter)
    return ms, nu, s


# the device kernels of each wrapper call in a profile of a dynamic program:
# K1 with per-chain W and / or Q; K2 with per-chain Q (the W-and-Q model) or
# the static K2 (lgssm_wtau, W alone per chain)
DYN_NAMES = {"fused_smoother_fwd_dyn": SMOOTHER_KERNEL_NAMES[
                 "fused_smoother_fwd"],
             "fused_smoother_bwd_dyn": SMOOTHER_KERNEL_NAMES[
                 "fused_smoother_bwd"]}
WTAU_NAMES = {"fused_smoother_fwd_dyn": SMOOTHER_KERNEL_NAMES[
                  "fused_smoother_fwd"],
              "fused_smoother_bwd": SMOOTHER_KERNEL_NAMES[
                  "fused_smoother_bwd"]}


def wtau_path(device, b: int, t_len: int, d: int, iterations: int,
              reps: int, log=print) -> dict:
    """Phase 10 (b): ``lgssm_wtau`` through ``batched_program`` at (B, T, d)
    as bench.py:306-312 builds it: the dynamic plan, its launches, sampled
    chains against the float64 VMP, the time, the stages alone, one
    profiled call, and K1 with per-chain W against its plain version on
    the path's own inputs over its first DYN_PATH_STEPS steps, which the
    wrapper cuts into as many time blocks as the whole path's (the
    instantiations the path launches).  W alone is per chain here, so K2
    is the static one."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine import batched as eb
    from rxinfer_tpu_torch.engine.blocks import BatchContext
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    secs = {}
    t0 = time.perf_counter()
    model, init = wtau_model(d)
    y_host = wtau_y(b, t_len, d)
    y = torch.as_tensor(y_host, device=device)
    compiled, prog = rt.batched_program(
        model, {"y": y}, iterations=iterations, free_energy=False,
        initialization=init, device=device)
    secs["plan"] = time.perf_counter() - t0
    report = compiled.plan_report()["x"]
    log(f"[wtau] plan_report {report}")
    route = "cuda" if device.type == "cuda" else "plain"
    if report.get("dynamic") != ["W"] or report.get("w_linear") is not True \
            or report.get("route") != route:
        raise AssertionError(f"lgssm_wtau is not on the dynamic W-linear "
                             f"{route} plan: {report}")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    state, _, _ = prog({"y": y})
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device) - base
    launches = read_launches()
    log(f"[wtau] launches in one program call: {launches}")
    expect_launches(launches, fused_smoother_fwd_dyn=iterations,
                    fused_smoother_bwd=iterations)
    post, wr = state["x"], state["Wr"]
    means = post.mu.cpu().numpy()
    if means.shape != (b, t_len, d) or tuple(wr.s.shape) != (b, d, d) \
            or not (np.isfinite(means).all()
                    and bool(torch.isfinite(post.sigma).all())
                    and bool(torch.isfinite(wr.s).all())):
        raise AssertionError("lgssm_wtau posteriors have the wrong shape or "
                             "are not finite")
    secs["first_call"] = time.perf_counter() - t0 - sum(secs.values())
    rows = list(WTAU_ROWS)
    o_m, o_nu, o_s = wtau_oracle(b, t_len, d, iterations, tuple(rows))
    secs["oracle"] = time.perf_counter() - t0 - sum(secs.values())
    s_got = wr.s[rows].cpu().numpy().astype(np.float64)
    errs = {"means": float(np.abs(means[rows] - o_m).max()),
            "nu_rel": float(np.abs(wr.nu[rows].cpu().numpy() / o_nu
                                   - 1).max()),
            "scale_rel": float(np.abs(s_got - o_s).max()
                               / np.abs(o_s).max())}
    log(f"[wtau] float64 VMP, chains {rows}: {errs} (tol means "
        f"{ORACLE_TOL}, Wishart relative {WISHART_REL_TOL})")
    if errs["means"] > ORACLE_TOL or max(errs["nu_rel"],
                                         errs["scale_rel"]) > WISHART_REL_TOL:
        raise AssertionError(f"lgssm_wtau disagrees with the float64 VMP: "
                             f"{errs}")
    out = {"errs": errs, "launches": launches, "peak_bytes": peak}

    # the sweep's stages alone, on the final state
    plan = eb.build_plans(compiled, {"y": y_host[0]}, device=device)["x"]
    block = next(blk for kind, blk in compiled.blocks if blk.var.name == "x")
    group = next(blk for kind, blk in compiled.blocks
                 if blk.var.name == "Wr")
    ctx = BatchContext(device, b, {})
    data = {"y": y}
    xi_t, w_b, _ = eb.dynamic_inputs(block, plan, state, data, ctx)
    xi_t = xi_t.contiguous()
    m0 = torch.as_tensor(plan.m0, device=device).expand(b, d).contiguous()
    p0 = torch.as_tensor(plan.p0, device=device).expand(b, d, d).contiguous()
    k1 = lambda: fs.fused_forward(m0, p0, xi_t, plan.A, plan.b, plan.Q, None,
                                  w_batch=w_b)
    mf, pf = k1()
    k2 = lambda: fs.fused_backward(mf, pf, plan.A, plan.b, plan.Q)
    ms, ps, cr = k2()
    cc = {"x": cr.reshape(t_len - 1, d, d, b).permute(3, 0, 2, 1)}
    stages = {
        "reclose": lambda: eb.dynamic_inputs(block, plan, state, data, ctx),
        "fwd": k1, "bwd": k2,
        "unpack": lambda: fs.sym_unfold_t(ps, d),
        "wishart_group": lambda: group.update(state, data, cc, ctx),
    }
    out["program_ms"] = _cuda_ms(lambda: prog({"y": y}), reps)
    out["updates_per_s"] = iterations * 3 * t_len * b / (
        out["program_ms"] / 1e3)
    for name, fn in stages.items():
        out[f"{name}_ms"] = _cuda_ms(fn, reps)
    out["profile"] = _device_profile(lambda: prog({"y": y}), WTAU_NAMES)
    secs["timing"] = time.perf_counter() - t0 - sum(secs.values())
    busy = out["profile"]["busy_ms"]
    log(f"[wtau] B={b} T={t_len} d={d}, {iterations} iterations: program "
        f"{out['program_ms']:.3f} ms/call ({out['updates_per_s']:.4g} "
        f"updates/s), peak {peak / 1e9:.2f} GB above the inputs; stages "
        "alone (one sweep): " + ", ".join(
            f"{n} {out[n + '_ms']:.3f} ms" for n in stages)
        + f"; device busy {busy} ms per program call, idle "
        f"{_idle_share(out['program_ms'], busy)}; in the program "
        f"{out['profile']['kernels']}")

    # K1 with per-chain W against its plain version on the path's inputs,
    # all chains over the first DYN_PATH_STEPS steps, in as many time
    # blocks as the path's; the plain version on the host, and once on the
    # card at DYN_PLAIN_STEPS steps for its time
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out["blocks"] = fs.pick_blocks(b, t_len, d, sms)
    n_t = DYN_PATH_STEPS
    check_blocks = fs.pick_blocks(b, n_t, d, sms)
    if check_blocks < 2 or check_blocks != out["blocks"]:
        raise AssertionError(f"the check on the path's inputs takes "
                             f"{check_blocks} time blocks, the path "
                             f"{out['blocks']}")
    xs = xi_t[:n_t].contiguous()
    mf_k, pf_k = fs.fused_forward(m0, p0, xs, plan.A, plan.b, plan.Q, None,
                                  w_batch=w_b)
    torch.cuda.synchronize()
    mf_r, pf_r = _on_host(fs.fused_forward_reference, m0, p0, xs, plan.A,
                          plan.b, plan.Q, None, w_b)
    worst = 0.0
    for label, g, want in (("mf", mf_k, mf_r), ("pf", pf_k, pf_r)):
        ea, _, ok = _max_err(g.cpu().numpy(), want.numpy())
        worst = max(worst, ea)
        if not ok:
            raise AssertionError(f"K1 with per-chain W disagrees with its "
                                 f"plain version on the path's inputs "
                                 f"({label}): {ea}")
    out["kernel_err"] = worst
    out["check_shape"] = [b, n_t, d]
    xs = xi_t[:DYN_PLAIN_STEPS].contiguous()
    _, out["plain_ms"] = _once_ms(lambda: fs.fused_forward_reference(
        m0, p0, xs, plan.A, plan.b, plan.Q, None, w_batch=w_b))
    out["plain_shape"] = [b, DYN_PLAIN_STEPS, d]
    log(f"[wtau] K1 with per-chain W vs its plain version on the path's "
        f"inputs, (B,T,d)=({b},{n_t},{d}), {check_blocks} time blocks as "
        f"the path: max abs {worst:.3g} "
        f"(rtol=atol={RTOL}); the plain "
        f"version's one call on the card at (B,T,d)=({b},{DYN_PLAIN_STEPS},"
        f"{d}) {out['plain_ms']:.1f} ms")
    # each kernel alone at the path's shape, on the path's tiles; K2 with
    # per-chain Q (which this path does not run) on the shared Q as a tile
    q_b = torch.as_tensor(plan.Q, device=device).expand(b, d, d).contiguous()
    out["fwd_alone_ms"] = _cuda_ms(k1, reps)
    out["bwd_alone_ms"] = _cuda_ms(k2, reps)
    out["bwd_dyn_alone_ms"] = _cuda_ms(
        lambda: fs.fused_backward(mf, pf, plan.A, plan.b, None, q_batch=q_b),
        reps)
    secs["path_check"] = time.perf_counter() - t0 - sum(secs.values())
    log(f"[wtau] alone at (B,T,d)=({b},{t_len},{d}), {out['blocks']} time "
        f"blocks: K1 with per-chain W {out['fwd_alone_ms']:.4f} ms, the "
        f"static K2 {out['bwd_alone_ms']:.4f} ms, K2 with per-chain Q "
        f"{out['bwd_dyn_alone_ms']:.4f} ms; seconds of the phase: "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return out


def wtau_vs_scan(device, b: int, t_len: int, d: int, iterations: int,
                 reps: int, log=print) -> dict:
    """Phase 10 (c): ``lgssm_wtau`` at bench.py:314-330's (B, T): the
    dynamic program against ``fused_kernels=False`` (max |mean| difference
    within ORACLE_TOL), both timed."""
    import torch

    import rxinfer_tpu_torch as rt

    model, init = wtau_model(d)
    y = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (b, t_len, d)).astype(np.float32), device=device)
    kw = dict(iterations=iterations, free_energy=False, initialization=init,
              device=device)
    _, dyn = rt.batched_program(model, {"y": y}, **kw)
    compiled, scan = rt.batched_program(
        model, {"y": y}, options={"fused_kernels": False, "warn": False},
        **kw)
    if compiled.plan_report()["x"].get("fused") is not False:
        raise AssertionError("the scan program's chain is on the kernels")
    reset_launches()
    st_dyn, _, _ = dyn({"y": y})
    torch.cuda.synchronize()
    expect_launches(read_launches(), fused_smoother_fwd_dyn=iterations,
                    fused_smoother_bwd=iterations)
    reset_launches()
    st_scan, _, _ = scan({"y": y})
    torch.cuda.synchronize()
    expect_launches(read_launches())
    diff = float((st_dyn["x"].mu - st_scan["x"].mu).abs().max())
    if not diff <= ORACLE_TOL:
        raise AssertionError(f"the dynamic program and the scan path differ "
                             f"by {diff} on the means")
    out = {"max_mean_diff": diff,
           "dyn_ms": _cuda_ms(lambda: dyn({"y": y}), reps),
           "scan_ms": statistics.median(
               [_once_ms(lambda: scan({"y": y}))[1] for _ in range(reps)])}
    log(f"[wtau] B={b} T={t_len}, {iterations} iterations: dynamic program "
        f"{out['dyn_ms']:.3f} ms, fused_kernels=False {out['scan_ms']:.3f} ms"
        f" ({out['scan_ms'] / out['dyn_ms']:.1f}x); max |mean diff| {diff:.3g}"
        f" (tol {ORACLE_TOL})")
    return out


def wq_both_path(device, shape, iterations: int, log=print) -> dict:
    """Phase 10 (d): tests/engine/test_fused_dynamic.py's
    ``test_dyn_wq_mv_wishart_both`` model (W and Q random, d = 2) at
    WQ_SHAPE: the dynamic plan (per-chain W and Q), its launches, x and
    both Wishart means against the unfused program within rtol = atol =
    1e-4, one profiled call, and K1 / K2 with per-chain W and Q against
    their plain versions on the path's own inputs at its whole shape (the
    plain versions' one call on the card is their time)."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine import batched as eb
    from rxinfer_tpu_torch.engine.blocks import BatchContext
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    b, t_len, d = shape
    a_mat = (0.9 * np.eye(d)).astype(np.float32)
    nu0 = float(d) + 1.0
    eye = np.eye(d, dtype=np.float32)
    p0 = (10.0 * np.eye(d)).astype(np.float32)

    @rt.model
    def hier(y):
        T = len(y)
        Wq = rt.Wishart(nu0, eye)
        Wr = rt.Wishart(nu0, eye)
        x = rt.latent(T, name="x")
        x[0] = rt.MvNormal(mean=np.zeros(d, np.float32), cov=p0)
        for t in rt.plate(1, T):
            x[t] = rt.MvNormal(mean=a_mat @ x[t - 1], precision=Wq)
        for t in rt.plate(T):
            y[t] = rt.MvNormal(mean=x[t], precision=Wr)

    init = {"Wq": rt.Wishart(nu0, eye), "Wr": rt.Wishart(nu0, eye)}
    rng = np.random.default_rng(3)
    y_host = np.cumsum(rng.standard_normal((b, t_len, d)),
                       axis=1).astype(np.float32)
    y = torch.as_tensor(y_host, device=device)
    kw = dict(iterations=iterations, free_energy=False, initialization=init,
              device=device)
    compiled, dyn = rt.batched_program(hier, {"y": y}, **kw)
    report = compiled.plan_report()["x"]
    route = "cuda" if device.type == "cuda" else "plain"
    if report.get("dynamic") != ["W", "Q"] or report.get("route") != route:
        raise AssertionError(f"the W-and-Q model is not on the dynamic "
                             f"{route} plan: {report}")
    _, scan = rt.batched_program(
        hier, {"y": y}, options={"fused_kernels": False, "warn": False}, **kw)
    reset_launches()
    st, _, _ = dyn({"y": y})
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(launches, fused_smoother_fwd_dyn=iterations,
                    fused_smoother_bwd_dyn=iterations)
    ref, _, _ = scan({"y": y})
    errs = {}
    for name in ("x", "Wq", "Wr"):
        ea, _, ok = _max_err(st[name].mean().cpu().numpy(),
                             ref[name].mean().cpu().numpy(), rtol=1e-4,
                             atol=1e-4)
        errs[name] = ea
        if not ok:
            raise AssertionError(f"the W-and-Q model's {name} differs from "
                                 f"the unfused program: {ea}")
    out = {"errs": errs, "launches": launches,
           "profile": _device_profile(lambda: dyn({"y": y}), DYN_NAMES)}

    # the kernels on the path's inputs at the final state
    plan = eb.build_plans(compiled, {"y": y_host[0]}, device=device)["x"]
    block = next(blk for kind, blk in compiled.blocks if blk.var.name == "x")
    ctx = BatchContext(device, b, {})
    xi_t, w_b, q_b = eb.dynamic_inputs(block, plan, st, {"y": y}, ctx)
    xi_t = xi_t.contiguous()
    m0 = torch.as_tensor(plan.m0, device=device).expand(b, d).contiguous()
    p0 = torch.as_tensor(plan.p0, device=device).expand(b, d, d).contiguous()
    out["blocks"] = fs.pick_blocks(
        b, t_len, d, torch.cuda.get_device_properties(device)
        .multi_processor_count)
    if out["blocks"] < 2:
        raise AssertionError(f"the W-and-Q path takes {out['blocks']} time "
                             "block: its blocked kernels go unchecked")
    mf, pf = fs.fused_forward(m0, p0, xi_t, plan.A, plan.b, None, None,
                              w_batch=w_b, q_batch=q_b)
    ms, ps, cr = fs.fused_backward(mf, pf, plan.A, plan.b, None, q_batch=q_b)
    (mf_r, pf_r), fwd_plain = _once_ms(lambda: fs.fused_forward_reference(
        m0, p0, xi_t, plan.A, plan.b, None, None, w_batch=w_b, q_batch=q_b))
    (ms_r, ps_r, cr_r), bwd_plain = _once_ms(
        lambda: fs.fused_backward_reference(mf, pf, plan.A, plan.b, None,
                                            q_batch=q_b))
    out["kernel_errs"] = {}
    for kname, items in (
            ("fused_smoother_fwd_dyn", ((mf, mf_r), (pf, pf_r))),
            ("fused_smoother_bwd_dyn", ((ms, ms_r), (ps, ps_r), (cr, cr_r)))):
        worst = 0.0
        for g, want in items:
            ea, _, ok = _max_err(g.cpu().numpy(), want.cpu().numpy())
            worst = max(worst, ea)
            if not ok:
                raise AssertionError(f"{kname} disagrees with its plain "
                                     f"version on the W-and-Q path's inputs: "
                                     f"{ea}")
        out["kernel_errs"][kname] = worst
    out["plain_ms"] = {"fused_smoother_fwd_dyn": fwd_plain,
                       "fused_smoother_bwd_dyn": bwd_plain}
    log(f"[wq] W and Q random, (B,T,d)=({b},{t_len},{d}), {iterations} "
        f"iterations: plan {report}; launches {launches}; max |diff| to the "
        f"unfused program {errs} (rtol=atol=1e-4); in the program "
        f"{out['profile']['kernels']}; K1 / K2 with per-chain W and Q vs "
        f"their plain versions on the path's inputs, {out['blocks']} time "
        f"blocks: {out['kernel_errs']} (rtol=atol={RTOL}), the plain "
        f"versions' one call on the card {fwd_plain:.1f} / {bwd_plain:.1f} ms")
    return out


# -- slice 10: the Bethe free energy ----------------------------------------------------

# Phase 12.  FE against its float64 references, relative.  (a) the LGSSM
# cell: FE == -log Z (the float64 prediction-error filter); (b) the HMM cell
# against the float64 structured VMP's Bethe FE, and its non-increase from
# sweep to sweep; (c) lgssm_wtau's fused FE against fused_kernels=False's;
# (d) the quantized programs' FE against the float32 program's on the
# dequantized observations; (e) the Gaussian with unknown mean and precision
# against the float64 mean-field VMP.  Every row of (e)'s Beta-Bernoulli
# against the closed form at FE_BB_TOL and row 0 against the reference's
# scalar at its own rtol.
FE_LOGZ_TOL = 1e-5
FE_HMM_TOL = 1e-4
FE_MONOTONE_TOL = 1e-5
FE_PATH_TOL = 1e-5
FE_BB_TOL = 1e-5
FE_REF_TOL = 1e-6
FE_GAUSS_TOL = 1e-5
FE_REF = 2828.0533343622483          # beta_bernoulli_tests.jl:55
FE_ROWS = (0, 1, MAIN_B // 2, MAIN_B - 1)
BB_B, BB_N = 4096, 5000              # (e): Beta-Bernoulli datasets, flips
GAUSS_B, GAUSS_N, GAUSS_IT = 4096, 1000, 10


def lgssm_minus_log_z(y, f, q, h, r, m0, p0):
    """-log p(y) of the LGSSM for a few chains y (n, T, dy) in float64: the
    Kalman filter's prediction-error decomposition (bench.py:719-746)."""
    f, q, h, r = (np.asarray(a, np.float64) for a in (f, q, h, r))
    y = np.asarray(y, np.float64)
    n, t_len, dy = y.shape
    m = np.broadcast_to(np.asarray(m0, np.float64), (n, len(m0))).copy()
    p = np.broadcast_to(np.asarray(p0, np.float64), (n,) + p0.shape).copy()
    nll = np.zeros(n)
    for t in range(t_len):
        if t:
            m = m @ f.T
            p = f @ p @ f.T + q
        s = h @ p @ h.T + r
        s_inv = np.linalg.inv(s)
        e = y[:, t] - m @ h.T
        nll += 0.5 * (dy * np.log(2 * np.pi) + np.linalg.slogdet(s)[1]
                      + np.einsum("ni,nij,nj->n", e, s_inv, e))
        k = p @ h.T @ s_inv
        m = m + np.einsum("nij,nj->ni", k, e)
        p = p - k @ h @ p
    return nll


def _lgamma64(x):
    return np.vectorize(math.lgamma)(np.asarray(x, np.float64))


def _dirichlet_collection_entropy64(a):
    """Sum over the columns (simplex axis -2) of their Dirichlet entropies,
    (n,) for a (n, K, K')."""
    a0 = a.sum(-2)
    k = a.shape[-2]
    per_col = (_lgamma64(a).sum(-2) - _lgamma64(a0)
               + (a0 - k) * digamma64(a0)
               - ((a - 1.0) * digamma64(a)).sum(-2))
    return per_col.sum(-1)


def hmm_vmp_fe_float64(y, a0, b0, iterations, with_state: bool = False):
    """The float64 structured VMP of ``hmm_vmp_float64`` with its Bethe
    free energy after each sweep (sweep s, A, B, as the port's): the
    transition and emission average energies under E[log A], E[log B], the
    uniform initial state's and the flat Dirichlet priors', minus the
    chain's entropy sum_t H(xi_t) - sum_interior H(gamma_t) and the two
    Dirichlet entropies.  Returns the FE (iterations, n) and, with
    ``with_state``, ``hmm_vmp_float64``'s gammas and concentrations after
    the last sweep."""
    y = np.asarray(y, np.float64)
    n, t_len, m = y.shape
    k = a0.shape[-1]
    ca = np.broadcast_to(np.asarray(a0, np.float64), (n, k, k)).copy()
    cb = np.broadcast_to(np.asarray(b0, np.float64), (n, m, k)).copy()
    lp = np.full((n, k), np.log(np.float32(1.0 / k)), np.float64)
    # the flat priors' energies: -log of Dir(1, ..., 1) per column
    prior_ae = -k * (math.lgamma(k) + math.lgamma(m))
    fes = []
    for _ in range(iterations):
        elog_a = digamma64(ca) - digamma64(ca.sum(-2, keepdims=True))
        elog_b = digamma64(cb) - digamma64(cb.sum(-2, keepdims=True))
        le = np.einsum("nij,nti->tnj", elog_b, y)
        g, xi, _ = fb_float64(lp, elog_a, le)            # (T, n, K), xis
        ca = 1.0 + xi.sum(0)
        cb = 1.0 + np.einsum("nti,tnj->nij", y, g)
        elog_a = digamma64(ca) - digamma64(ca.sum(-2, keepdims=True))
        elog_b = digamma64(cb) - digamma64(cb.sum(-2, keepdims=True))
        ae = (-np.einsum("tnij,nij->n", xi, elog_a)
              - np.einsum("nti,tnj,nij->n", y, g, elog_b)
              - np.einsum("nk,nk->n", g[0], lp) + prior_ae)
        h_xi = -np.sum(xi * np.log(np.maximum(xi, 1e-300)), (0, 2, 3))
        h_g = -np.sum(g * np.log(np.maximum(g, 1e-300)), -1)   # (T, n)
        fes.append(ae - (h_xi - h_g[1:-1].sum(0))
                   - _dirichlet_collection_entropy64(ca)
                   - _dirichlet_collection_entropy64(cb))
    if with_state:
        return np.stack(fes), (np.moveaxis(g, 0, 1), ca, cb)
    return np.stack(fes)


def gauss_vmp_fe_float64(y, iterations, m0=0.0, v0=100.0, a0=0.01,
                         b0=0.01, with_state: bool = False):
    """Mean-field VMP of ``zoo.gaussian_unknown_mean_precision`` in float64
    for every row of y (B, n), sweep mu then tau, tau starting at
    Gamma(1, 1), with its free energy after each sweep: (iterations, B);
    ``with_state`` adds the last sweep's posteriors, {"mu": (mean, var),
    "tau": (shape, rate)}."""
    y = np.asarray(y, np.float64)
    n = y.shape[1]
    a, b = np.ones(len(y)), np.ones(len(y))
    s1, s2 = y.sum(1), (y * y).sum(1)
    fes = []
    for _ in range(iterations):
        et = a / b
        w = 1.0 / v0 + n * et
        mu = (m0 / v0 + et * s1) / w
        v = 1.0 / w
        sq = s2 - 2.0 * mu * s1 + n * (mu * mu + v)
        a, b = a0 + 0.5 * n, b0 + 0.5 * sq
        et, elt = a / b, digamma64(a) - np.log(b)
        ae_mu = 0.5 * (np.log(2 * np.pi * v0) + ((mu - m0) ** 2 + v) / v0)
        ae_tau = -((a0 - 1.0) * elt - b0 * et + a0 * np.log(b0)
                   - math.lgamma(a0))
        ae_y = 0.5 * (n * np.log(2 * np.pi) - n * elt + et * sq)
        h_mu = 0.5 * np.log(2 * np.pi * np.e * v)
        h_tau = a - np.log(b) + _lgamma64(a) + (1.0 - a) * digamma64(a)
        fes.append(ae_mu + ae_tau + ae_y - h_mu - h_tau)
    if with_state:
        return np.stack(fes), {"mu": (mu, v), "tau": (a, b)}
    return np.stack(fes)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def _peak_call(device, fn):
    """``fn()``'s result and the device memory it peaked at above what was
    allocated before it (the inputs and everything held), bytes."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated(device) - base


def _with_and_without_fe(device, model, data, reps, **kw):
    """Phase 12's pair of one cell: the program with free energy, the same
    program without it, and each one's time (median of ``reps`` calls):
    (compiled, program, program without FE, times)."""
    import rxinfer_tpu_torch as rt

    compiled, prog = rt.batched_program(model, data, free_energy=True,
                                        device=device, **kw)
    _, plain = rt.batched_program(model, data, free_energy=False,
                                  device=device, **kw)
    return compiled, prog, plain, {
        "fe_program_ms": _cuda_ms(lambda: prog(data), reps),
        "program_ms": _cuda_ms(lambda: plain(data), reps)}


def fe_lgssm_path(device, b: int, t_len: int, d: int, reps: int,
                  log=print) -> dict:
    """Phase 12 (a): phase 4's LGSSM cell with ``free_energy=True``: one K1
    and one K2 launch a call, FE == -log Z on FE_ROWS, the program beside
    the same program without FE, the FE stage alone (on the call's
    marginals and K2's cross) and the peak device memory of each."""
    import torch

    from rxinfer_tpu_torch.engine import batched as eb
    from rxinfer_tpu_torch.engine.blocks import BatchContext
    from rxinfer_tpu_torch.models import zoo

    f, q, h, r, m0, p0 = lgssm_constants(d)
    model = zoo.lgssm(f, q, h, r, m0, p0)
    y_host = lgssm_y(b, t_len, d)
    y = torch.as_tensor(y_host, device=device)
    data = {"y": y}
    compiled, prog, plain, out = _with_and_without_fe(device, model, data,
                                                      reps)
    reset_launches()
    (state, fe, _), peak = _peak_call(device, lambda: prog(data))
    launches = read_launches()
    expect_launches(launches, fused_smoother_fwd=1, fused_smoother_bwd=1)
    fe = fe.cpu().numpy()
    if fe.shape != (1, b) or not np.isfinite(fe).all():
        raise AssertionError(f"LGSSM FE of shape {fe.shape}, finite "
                             f"{np.isfinite(fe).all()}")
    rows = list(FE_ROWS)
    want = lgssm_logz_rows(b, t_len, d, tuple(rows))
    err = _rel(fe[0, rows], want)
    log(f"[fe] (a) LGSSM B={b} T={t_len} d={d}: launches {launches}; FE "
        f"rows {rows} {fe[0, rows].tolist()} against -log Z "
        f"{want.tolist()}: max rel err {err:.3g} (tol {FE_LOGZ_TOL})")
    if not err <= FE_LOGZ_TOL:
        raise AssertionError(f"LGSSM FE != -log Z: {err}")
    _, peak_plain = _peak_call(device, lambda: plain(data))
    # the FE stage alone, on this call's marginals and K2's cross
    plan = eb.build_plans(compiled, {"y": y_host[0]}, device=device)["x"]
    block = next(blk for _, blk in compiled.blocks)
    marg, cross = eb._fused_gaussian_update(block, plan, data, b)
    ctx = BatchContext(device, b, {})
    stage = lambda: compiled._free_energy({"x": marg}, {"x": cross}, data,
                                          ctx)
    fe_alone = stage().cpu().numpy()
    out.update({
        "launches": launches, "rel_err": err, "peak_bytes": peak,
        "peak_bytes_without_fe": peak_plain,
        "fe_stage_ms": _cuda_ms(stage, reps),
        "stage_vs_program": float(np.abs(fe_alone - fe[0]).max())})
    log(f"[fe] (a) program with FE {out['fe_program_ms']:.3f} ms, without "
        f"{out['program_ms']:.3f} ms; the FE stage alone "
        f"{out['fe_stage_ms']:.3f} ms; peak {peak / 1e9:.2f} GB above the "
        f"inputs ({peak_plain / 1e9:.2f} GB without FE)")
    del state, marg, cross
    torch.cuda.empty_cache()
    return out


def fe_hmm_path(device, b: int, t_len: int, iterations: int, reps: int,
                log=print) -> dict:
    """Phase 12 (b): phase 5's HMM cell with ``free_energy=True``: 20 K4 and
    20 K5 launches a call, FE after every sweep against the float64
    structured VMP's on HMM_ROWS, its non-increase, the program beside the
    same program without FE."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    y_host = simulate_hmm(b, t_len, seed=0)
    y = torch.as_tensor(y_host, device=device)
    a0 = np.full((3, 3), 1.0, np.float32)
    b0 = np.float32(np.eye(3) * 5.0 + 1.0)
    init = {"A": rt.DirichletCollection(a0), "B": rt.DirichletCollection(b0)}
    data = {"y": y}
    _, prog, _, out = _with_and_without_fe(
        device, zoo.hmm(3, 3), data, reps, iterations=iterations,
        initialization=init)
    reset_launches()
    _, fe, _ = prog(data)
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(launches, fused_fb_fwd=iterations,
                    fused_fb_bwd=iterations)
    fe = fe.cpu().numpy()
    rows = list(HMM_ROWS)
    want = hmm_vmp_fe_float64(y_host[rows], a0, b0, iterations)
    err = _rel(fe[:, rows], want)
    rise = float(np.max(np.diff(fe, axis=0) / np.abs(fe[1:])))
    log(f"[fe] (b) HMM B={b} T={t_len}, {iterations} iterations: launches "
        f"{launches}; FE rows {rows} first/last sweep "
        f"{fe[0, rows].tolist()} / {fe[-1, rows].tolist()}; against the "
        f"float64 structured VMP max rel err {err:.3g} (tol {FE_HMM_TOL}); "
        f"largest rise from a sweep to the next {rise:.3g} relative (tol "
        f"{FE_MONOTONE_TOL}); program with FE {out['fe_program_ms']:.3f} ms,"
        f" without {out['program_ms']:.3f} ms")
    if not np.isfinite(fe).all() or not err <= FE_HMM_TOL \
            or not rise <= FE_MONOTONE_TOL:
        raise AssertionError(f"HMM FE: finite {np.isfinite(fe).all()}, "
                             f"err {err}, rise {rise}")
    out.update({"launches": launches, "rel_err": err, "max_rise": rise})
    return out


def fe_wtau_path(device, b: int, t_len: int, d: int, iterations: int,
                 reps: int, log=print) -> dict:
    """Phase 12 (c): ``lgssm_wtau`` at phase 10 (c)'s (B, T) with
    ``free_energy=True``: the fused program's FE (per-chain-W K1, static K2)
    against ``fused_kernels=False``'s on the same data."""
    import torch

    import rxinfer_tpu_torch as rt

    model, init = wtau_model(d)
    y = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (b, t_len, d)).astype(np.float32), device=device)
    data = {"y": y}
    _, prog, _, out = _with_and_without_fe(
        device, model, data, reps, iterations=iterations,
        initialization=init)
    _, scan = rt.batched_program(
        model, data, iterations=iterations, free_energy=True,
        initialization=init, options={"fused_kernels": False, "warn": False},
        device=device)
    reset_launches()
    fe = prog(data)[1]
    torch.cuda.synchronize()
    launches = read_launches()
    expect_launches(launches, fused_smoother_fwd_dyn=iterations,
                    fused_smoother_bwd=iterations)
    fe_scan = scan(data)[1]
    err = _rel(fe.cpu().numpy(), fe_scan.cpu().numpy())
    log(f"[fe] (c) lgssm_wtau B={b} T={t_len} d={d}, {iterations} "
        f"iterations: launches {launches}; FE against fused_kernels=False "
        f"max rel err {err:.3g} (tol {FE_PATH_TOL}); program with FE "
        f"{out['fe_program_ms']:.3f} ms, without {out['program_ms']:.3f} ms")
    if not bool(torch.isfinite(fe).all()) or not err <= FE_PATH_TOL:
        raise AssertionError(f"lgssm_wtau FE differs from the scan path's: "
                             f"{err}")
    out.update({"launches": launches, "rel_err": err})
    return out


def fe_quant_path(device, b: int, t_len: int, d: int, reps: int,
                  log=print) -> dict:
    """Phase 12 (d): phase 8 (i)'s LGSSM cell on int8 / float8_e4m3fn
    observations with ``free_energy=True``, 1 iteration: one K6 or K7
    launch a call; FE against the float32 program's on the dequantized
    observations."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine.batched import quantize_observations
    from rxinfer_tpu_torch.models import zoo

    model = zoo.lgssm(*lgssm_constants(d))
    y = torch.as_tensor(lgssm_y(b, t_len, d), device=device)
    _, prog_f = rt.batched_program(model, {"y": y}, free_energy=True,
                                   device=device)
    out: dict = {"launches": {}, "rel_err": {}, "fe_program_ms": {},
                 "program_ms": {}}
    for obs_dtype, kname in (("int8", "quantize_rows"),
                             ("float8_e4m3fn", "quantize_rows_fp8")):
        _, prog, _, times = _with_and_without_fe(
            device, model, {"y": y}, reps,
            options={"observation_dtype": obs_dtype})
        reset_launches()
        fe = prog({"y": y})[1]
        torch.cuda.synchronize()
        launches = read_launches()
        expect_launches(launches, fused_smoother_fwd=1, fused_smoother_bwd=1,
                        **{kname: 1})
        vals, scales = quantize_observations(y, obs_dtype)
        y_hat = (vals.to(torch.float32) * scales).transpose(1, 2).contiguous()
        fe_hat = prog_f({"y": y_hat})[1]
        err = _rel(fe.cpu().numpy(), fe_hat.cpu().numpy())
        out["launches"][obs_dtype] = launches
        out["rel_err"][obs_dtype] = err
        out["fe_program_ms"][obs_dtype] = times["fe_program_ms"]
        out["program_ms"][obs_dtype] = times["program_ms"]
        log(f"[fe] (d) {obs_dtype} B={b} T={t_len} d={d}: launches "
            f"{launches}; FE against the float32 program's on the "
            f"dequantized observations max rel err {err:.3g} (tol "
            f"{FE_PATH_TOL}); program with FE {times['fe_program_ms']:.3f} "
            f"ms, without {times['program_ms']:.3f} ms")
        if not bool(torch.isfinite(fe).all()) or not err <= FE_PATH_TOL:
            raise AssertionError(f"{obs_dtype} FE differs from the float32 "
                                 f"FE on the dequantized data: {err}")
        del vals, scales, y_hat, fe, fe_hat
    torch.cuda.empty_cache()
    return out


@functools.lru_cache(maxsize=None)
def config2_data():
    """Phase 12 (e)'s data (phase 21 (c) and 24 (e) reuse the Gaussian
    cell; made once a process, its callers only read it): the
    Beta-Bernoulli flips (BB_B, BB_N), row 0 the reference's 3743
    successes, then the Gaussian cell's observations (GAUSS_B, GAUSS_N)
    from the same generator."""
    rng = np.random.default_rng(42)
    flips = (rng.random((BB_B, BB_N)) < rng.uniform(0.2, 0.9, (BB_B, 1)))
    flips[0] = rng.permutation(np.arange(BB_N) < 3743)
    loc = rng.normal(0.0, 2.0, (GAUSS_B, 1))
    scale = rng.uniform(0.5, 2.0, (GAUSS_B, 1))
    yg = (loc + scale * rng.standard_normal((GAUSS_B, GAUSS_N))).astype(
        np.float32)
    return flips, yg


def fe_config2_path(device, reps: int, log=print) -> dict:
    """Phase 12 (e): BASELINE config 2 through ``infer_batched``.
    ``zoo.beta_bernoulli(2.0, 7.0)`` over BB_B datasets of BB_N flips (row 0
    holds the reference's 3743 successes): every row's FE against the
    closed form -(betaln(2 + h, 7 + n - h) - betaln(2, 7)) in float64, row 0
    against the reference's scalar.  ``zoo.gaussian_unknown_mean_precision``
    over GAUSS_B datasets of GAUSS_N points, GAUSS_IT iterations, tau
    initialized at Gamma(1, 1): the FE after every sweep against the
    float64 mean-field VMP's.  Both timed beside the programs without FE."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    flips, yg_host = config2_data()
    y = torch.as_tensor(flips.astype(np.float32), device=device)
    res = rt.infer_batched(zoo.beta_bernoulli(2.0, 7.0), {"y": y},
                           free_energy=True, device=device)
    fe = res.free_energy[-1].cpu().numpy()
    h = flips.sum(1).astype(np.float64)
    closed = -np.array([math.lgamma(2.0 + hi) + math.lgamma(7.0 + BB_N - hi)
                        - math.lgamma(9.0 + BB_N) for hi in h]) + (
        math.lgamma(2.0) + math.lgamma(7.0) - math.lgamma(9.0))
    out = {"bb_rel_err": _rel(fe, closed),
           "bb_ref_rel_err": abs(float(fe[0]) / FE_REF - 1.0),
           "bb_row0": float(fe[0])}
    *_, times = _with_and_without_fe(device, zoo.beta_bernoulli(2.0, 7.0),
                                     {"y": y}, reps)
    out["bb_fe_program_ms"] = times["fe_program_ms"]
    out["bb_program_ms"] = times["program_ms"]
    log(f"[fe] (e) beta_bernoulli(2, 7) B={BB_B} n={BB_N}: FE against the "
        f"closed form max rel err {out['bb_rel_err']:.3g} (tol {FE_BB_TOL});"
        f" row 0 (3743 / 5000) {out['bb_row0']!r} against {FE_REF!r}, rel "
        f"err {out['bb_ref_rel_err']:.3g} (tol {FE_REF_TOL}); program with "
        f"FE {times['fe_program_ms']:.3f} ms, without "
        f"{times['program_ms']:.3f} ms")
    if not out["bb_rel_err"] <= FE_BB_TOL \
            or not out["bb_ref_rel_err"] <= FE_REF_TOL:
        raise AssertionError(f"Beta-Bernoulli FE: {out}")

    yg = torch.as_tensor(yg_host, device=device)
    init = {"tau": rt.Gamma(1.0, 1.0)}
    model = zoo.gaussian_unknown_mean_precision()
    res = rt.infer_batched(model, {"y": yg}, iterations=GAUSS_IT,
                           free_energy=True, initialization=init,
                           device=device)
    fe = res.free_energy.cpu().numpy()
    want = gauss_vmp_fe_float64(yg_host, GAUSS_IT)
    out["gauss_rel_err"] = _rel(fe, want)
    *_, times = _with_and_without_fe(device, model, {"y": yg}, reps,
                                     iterations=GAUSS_IT,
                                     initialization=init)
    out["gauss_fe_program_ms"] = times["fe_program_ms"]
    out["gauss_program_ms"] = times["program_ms"]
    log(f"[fe] (e) gaussian_unknown_mean_precision B={GAUSS_B} "
        f"n={GAUSS_N}, {GAUSS_IT} iterations: FE against the float64 VMP max"
        f" rel err {out['gauss_rel_err']:.3g} (tol {FE_GAUSS_TOL}); program "
        f"with FE {times['fe_program_ms']:.3f} ms, without "
        f"{times['program_ms']:.3f} ms")
    if not out["gauss_rel_err"] <= FE_GAUSS_TOL:
        raise AssertionError(f"Gaussian FE against the float64 VMP: "
                             f"{out['gauss_rel_err']}")
    return out


# -- slice 11: the Gaussian mixture (config 4) and the streaming engine -------------

# Phase 13: bench.py:487-508's GMM cell.  Its float32 program against a
# float64 mean-field VMP in the port's group order: the posterior
# parameters of m_i, w_i and pi relative, z's probabilities absolute, the
# free energy of every sweep relative.  Float32 against float64 over 20
# sweeps lands at ~1e-6 relative on the parameters and ~1e-6 on the FE
# (PERF.md, Findings), an order or two under the limits.
GMM_B, GMM_N, GMM_IT, GMM_LOCS = 1000, 200, 20, (-2.0, 2.0)
GMM_ROWS = (0, 1, GMM_B // 2, GMM_B - 1)
GMM_TOL = {"param_rel": 1e-4, "z": 1e-4, "fe_rel": 1e-5}
# Phase 14: bench.py:401-485's streaming cell, 10,000 chains x 200 ticks,
# d = dy = 4; (c) drives STREAM_ONLINE_T ticks of chain 0 through on_next.
# The fused stream plan and the generic tick against a float64 filter with
# the plan's tick order (absolute, as ORACLE_TOL), against each other and
# (c) against (a).
STREAM_B, STREAM_T, STREAM_D = 10_000, 200, 4
STREAM_ROWS = (0, 1, STREAM_B // 2, STREAM_B - 1)
STREAM_ONLINE_T = 20
STREAM_TOL = 1e-4
# (b)'s time is the median of its checked call and two more (1.1-1.4 s a
# call on an H100); the device busy share of (a) and (b) is read from a
# profiled call over the first STREAM_PROFILE_T ticks (every tick does the
# same work): a profile of a whole call holds 10^4-10^5 events, seconds of
# the profiler's own processing
STREAM_PROFILE_T = 20
# the reference engine's events of a datastream of n ticks with keephistory
# (the JAX engine's order; tests/test_torch_streaming.py holds the port's
# against it on the CPU)
_TICK_EVENTS = ["on_new_data", "before_iteration", "before_auto_update",
                "after_auto_update", "before_data_update",
                "on_marginal_update", "after_data_update", "after_iteration",
                "before_history_save", "after_history_save", "on_tick"]


def stream_events(n: int) -> list:
    return (["before_autostart", "before_start", "after_start",
             "before_model_creation", "after_model_creation"]
            + _TICK_EVENTS * n + ["on_complete", "after_autostart"])


def gmm_data(b: int, n: int, seed: int) -> np.ndarray:
    """bench.py:489-492's generator: 40% of the points from N(4, 0.5^2),
    the rest from N(-1, 0.7^2)."""
    rng = np.random.default_rng(seed)
    comp = rng.uniform(size=(b, n)) < 0.4
    return np.where(comp, 4.0 + 0.5 * rng.standard_normal((b, n)),
                    -1.0 + 0.7 * rng.standard_normal((b, n))).astype(
        np.float32)


def gmm_vmp_fe_float64(y, iterations, locs=GMM_LOCS, mean_var=100.0,
                       a0=0.01, b0=0.01):
    """Mean-field VMP of ``zoo.gmm(k, locs)`` in float64 for the rows of y
    (n, N), in the port's group order (z, pi, then m_i and w_i in turn),
    from bench.py:493-499's initialization (m_i ~ N(locs_i, 10), w_i ~
    Gamma(1, 1), pi ~ Dir(1)).  Returns the final parameters and the Bethe
    free energy after each sweep, (iterations, n): sum of the factors'
    average energies minus every variable's entropy."""
    y = np.asarray(y, np.float64)
    n, npts = y.shape
    k = len(locs)
    locs = np.asarray(locs, np.float64)
    mu = np.broadcast_to(locs, (n, k)).copy()
    v = np.full((n, k), 10.0)
    a = np.ones((n, k))
    b = np.ones((n, k))
    alpha = np.ones((n, k))
    lg = _lgamma64
    fes = []
    for _ in range(iterations):
        # z: E[log pi] and each component's expected log-likelihood
        elog_pi = digamma64(alpha) - digamma64(alpha.sum(-1, keepdims=True))
        c = (y[:, :, None] ** 2 - 2.0 * y[:, :, None] * mu[:, None]
             + (mu ** 2 + v)[:, None])
        ew, elw = a / b, digamma64(a) - np.log(b)
        logits = elog_pi[:, None] - 0.5 * (math.log(2 * math.pi)
                                           - elw[:, None] + ew[:, None] * c)
        logits -= logits.max(-1, keepdims=True)
        r = np.exp(logits)
        r /= r.sum(-1, keepdims=True)
        alpha = 1.0 + r.sum(1)
        for i in range(k):
            ri = r[:, :, i]
            w = 1.0 / mean_var + (a[:, i] / b[:, i]) * ri.sum(1)
            xi = locs[i] / mean_var + (a[:, i] / b[:, i]) * (ri * y).sum(1)
            mu[:, i], v[:, i] = xi / w, 1.0 / w
            ci = y ** 2 - 2.0 * y * mu[:, i:i + 1] + (mu[:, i] ** 2
                                                      + v[:, i])[:, None]
            a[:, i] = a0 + 0.5 * ri.sum(1)
            b[:, i] = b0 + 0.5 * (ri * ci).sum(1)
        elog_pi = digamma64(alpha) - digamma64(alpha.sum(-1, keepdims=True))
        ew, elw = a / b, digamma64(a) - np.log(b)
        c = (y[:, :, None] ** 2 - 2.0 * y[:, :, None] * mu[:, None]
             + (mu ** 2 + v)[:, None])
        ae = (0.5 * (math.log(2 * math.pi * mean_var)
                     + ((mu - locs) ** 2 + v) / mean_var).sum(-1)
              - ((a0 - 1.0) * elw - b0 * ew + a0 * math.log(b0)
                 - math.lgamma(a0)).sum(-1)
              - (r * elog_pi[:, None]).sum((1, 2))
              + (r * 0.5 * (math.log(2 * math.pi) - elw[:, None]
                            + ew[:, None] * c)).sum((1, 2)))
        a_sum = alpha.sum(-1)
        h_pi = (lg(alpha).sum(-1) - lg(a_sum) + (a_sum - k) * digamma64(a_sum)
                - ((alpha - 1.0) * digamma64(alpha)).sum(-1))
        h_m = 0.5 * np.log(2 * np.pi * np.e * v).sum(-1)
        h_w = (a - np.log(b) + lg(a) + (1.0 - a) * digamma64(a)).sum(-1)
        h_z = -(r * np.log(np.maximum(r, 1e-300))).sum((1, 2))
        fes.append(ae - h_pi - h_m - h_w - h_z)
    return {"mu": mu, "v": v, "a": a, "b": b, "alpha": alpha, "r": r,
            "fe": np.stack(fes)}


def gmm_path(device, reps: int, log=print) -> dict:
    """Phase 13: ``zoo.gmm(2, [-2, 2])`` through ``batched_program`` at
    bench.py:487-508's cell, with and without the free energy: no kernel
    launch, sampled rows against the float64 VMP (GMM_TOL), the free energy
    not increasing, the median of ``reps`` calls of each program,
    updates/s = B * iterations * (N + 5) / t (bench.py:508), the device busy
    and idle share of one profiled call without FE and the peak device
    memory."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    y_host = gmm_data(GMM_B, GMM_N, seed=0)
    y = torch.as_tensor(y_host, device=device)
    t = lambda v: torch.tensor(v, dtype=torch.float32)
    init = {"pi": rt.Dirichlet(np.ones(2, np.float32))}
    for i, loc in enumerate(GMM_LOCS):
        init[f"m{i}"] = rt.NormalMeanVariance(t(loc), t(10.0))
        init[f"w{i}"] = rt.GammaShapeRate(t(1.0), t(1.0))
    model = zoo.gmm(2, list(GMM_LOCS))
    progs = {}
    for fe_on in (False, True):
        compiled, progs[fe_on] = rt.batched_program(
            model, {"y": y}, iterations=GMM_IT, free_energy=fe_on,
            initialization=init, device=device)
    if compiled.sweep != ["z", "pi", "m0", "w0", "m1", "w1"]:
        raise AssertionError(f"GMM sweep order {compiled.sweep} is not the "
                             "float64 VMP's")
    out = {}
    for fe_on, prog in progs.items():
        reset_launches()
        (state, fe, _), peak = _peak_call(device, lambda: prog({"y": y}))
        out["launches"] = read_launches()
        expect_launches(out["launches"])
        out["peak_bytes" + ("_fe" if fe_on else "")] = peak
    rows = list(GMM_ROWS)
    want = gmm_vmp_fe_float64(y_host[rows], GMM_IT)
    got = {
        "mu": np.stack([state[f"m{i}"].mean()[rows].cpu().numpy()
                        for i in range(2)], -1),
        "v": np.stack([state[f"m{i}"].var()[rows].cpu().numpy()
                       for i in range(2)], -1),
        "a": np.stack([state[f"w{i}"].a[rows].cpu().numpy()
                       for i in range(2)], -1),
        "b": np.stack([state[f"w{i}"].b[rows].cpu().numpy()
                       for i in range(2)], -1),
        "alpha": state["pi"].alpha[rows].cpu().numpy(),
    }
    errs = {k: _rel(got[k], want[k]) for k in got}
    errs["z"] = float(np.abs(state["z"].mean()[rows].cpu().numpy()
                             - want["r"]).max())
    fe_all = fe.cpu().numpy()
    errs["fe"] = _rel(fe_all[:, rows], want["fe"])
    rise = float(np.max(np.diff(fe_all, axis=0) / np.abs(fe_all[:-1])))
    log(f"[gmm] B={GMM_B} N={GMM_N} {GMM_IT} iterations, rows {rows} "
        f"against the float64 VMP: max rel err " + ", ".join(
            f"{k} {errs[k]:.3g}" for k in ("mu", "v", "a", "b", "alpha"))
        + f" (tol {GMM_TOL['param_rel']}); z abs {errs['z']:.3g} (tol "
        f"{GMM_TOL['z']}); FE rel {errs['fe']:.3g} (tol {GMM_TOL['fe_rel']})"
        f"; largest rise of the FE from a sweep to the next {rise:.3g} "
        f"relative (tol {FE_MONOTONE_TOL}); launches {out['launches']}")
    bad = [k for k in ("mu", "v", "a", "b", "alpha")
           if not errs[k] <= GMM_TOL["param_rel"]]
    if (bad or not errs["z"] <= GMM_TOL["z"]
            or not errs["fe"] <= GMM_TOL["fe_rel"]
            or not np.isfinite(fe_all).all() or not rise <= FE_MONOTONE_TOL):
        raise AssertionError(f"GMM against the float64 VMP: {errs}, rise "
                             f"{rise}")
    out["errs"] = errs
    if device.type != "cuda":
        return out
    for fe_on, key in ((False, "program_ms"), (True, "fe_program_ms")):
        out[key] = _cuda_ms(lambda: progs[fe_on]({"y": y}), reps)
        out[key.replace("program_ms", "updates_per_s")] = (
            GMM_B * GMM_IT * (GMM_N + 5) / (out[key] / 1e3))
    out["busy_ms"] = _device_profile(lambda: progs[False]({"y": y}),
                                     {})["busy_ms"]
    log(f"[gmm] program {out['program_ms']:.3f} ms/call "
        f"({out['updates_per_s']:.4g} updates/s), device busy "
        f"{out['busy_ms']} ms, idle {_idle_share(out['program_ms'], out['busy_ms'])}"
        f", peak {out['peak_bytes'] / 1e6:.1f} MB; with FE "
        f"{out['fe_program_ms']:.3f} ms/call ({out['fe_updates_per_s']:.4g} "
        f"updates/s), peak {out['peak_bytes_fe'] / 1e6:.1f} MB")
    return out


def stream_filter_float64(pm, pc, ys, f, q, r):
    """The fused stream plan's recursion in float64 for a few streams:
    each tick the posterior of x given y_t under the prior (pm, pc) with
    y ~ N(x, R), then the prediction pm = F m, pc = F P F^T + Q.  pm (n, d),
    pc (n, d, d), ys (T, n, d); returns the posterior means and
    covariances, (T, n, d) and (T, n, d, d)."""
    f, q, r = (np.asarray(a, np.float64) for a in (f, q, r))
    w_obs = np.linalg.inv(r)
    m = np.asarray(pm, np.float64)
    p = np.asarray(pc, np.float64)
    means = np.empty(ys.shape, np.float64)
    covs = np.empty(ys.shape + ys.shape[-1:], np.float64)
    for t in range(ys.shape[0]):
        lam = np.linalg.inv(p)
        p = np.linalg.inv(lam + w_obs)
        m = np.einsum("nij,nj->ni", p, np.einsum("nij,nj->ni", lam, m)
                      + np.asarray(ys[t], np.float64) @ w_obs.T)
        means[t], covs[t] = m, p
        m = m @ f.T
        p = f @ p @ f.T + q
    return means, covs


def _stream_tick_model(r):
    """bench.py:446-449's tick: x ~ N(pm, pc), y ~ N(x, R)."""
    import rxinfer_tpu_torch as rt

    @rt.model
    def stream_tick(y, pm, pc):
        x = rt.MvNormal(mean=pm, cov=pc)
        y.observe(rt.MvNormal(mean=x, cov=r))
        return {"x": x}

    return stream_tick


def _stream_autoupdates(f, q, p0, b, device):
    """bench.py:451-460's autoupdates (the prediction), in torch on the
    engine's device; ``b`` streams, or one stream when None."""
    import torch

    import rxinfer_tpu_torch as rt

    ft = torch.as_tensor(f, device=device)
    qt = torch.as_tensor(q, device=device)
    d = f.shape[0]
    lead = () if b is None else (b,)
    return rt.autoupdates(
        initial={"pm": np.zeros(lead + (d,), np.float32),
                 "pc": np.broadcast_to(p0, lead + (d, d)).copy()},
        pm=lambda qq: qq["x"].mean() @ ft.T,
        pc=lambda qq: ft @ qq["x"].cov() @ ft.T + qt)


def stream_path(device, reps: int, path_a_ms=None, log=print) -> dict:
    """Phase 14: the streaming engine on config 5's cell (STREAM_B chains x
    STREAM_T ticks, d = dy = 4, bench.py:401-485's system).  (a)
    ``run_offline`` through the fused stream plan (it must engage); (b) the
    generic tick (``returnvars="x"``); (c) ``start(datastream)`` over
    STREAM_ONLINE_T ticks of chain 0.  No kernel may launch.  (a) and (b)
    against the float64 filter on sampled chains and against each other,
    (c) against (a) and its events in the reference order (STREAM_TOL).
    (a) and (b) timed per ``run_offline`` call (median of ``reps``),
    updates/s = B T / t (bench.py:473, 485), with the device busy and idle
    share of one profiled call and the peak device memory."""
    import torch

    import rxinfer_tpu_torch as rt

    f, q, _, r, _, p0 = lgssm_constants(STREAM_D)
    rng = np.random.default_rng(0)
    ys_host = rng.standard_normal((STREAM_T, STREAM_B, STREAM_D)).astype(
        np.float32)
    ys = torch.as_tensor(ys_host, device=device)
    obs = {"y": ys}
    rows = list(STREAM_ROWS)
    o_m, o_p = stream_filter_float64(
        np.zeros((len(rows), STREAM_D)),
        np.broadcast_to(p0, (len(rows), STREAM_D, STREAM_D)),
        ys_host[:, rows], f, q, r)
    out = {}
    engines = {}
    posts = {}
    for label, kw in (("a", {}), ("b", {"returnvars": "x"})):
        eng = engines[label] = rt.infer(
            model=_stream_tick_model(r), datastream=None,
            autoupdates=_stream_autoupdates(f, q, p0, STREAM_B, device),
            batched=True, device=device, **kw)
        reset_launches()
        t0 = time.perf_counter()
        (post, fes), peak = _peak_call(device, lambda: eng.run_offline(obs))
        out[f"first_ms_{label}"] = (time.perf_counter() - t0) * 1e3
        out[f"launches_{label}"] = read_launches()
        expect_launches(out[f"launches_{label}"])
        out[f"peak_bytes_{label}"] = peak
        post = posts[label] = post["x"]
        if tuple(post.mean().shape) != (STREAM_T, STREAM_B, STREAM_D) \
                or tuple(fes.shape) != (STREAM_T, STREAM_B, 0):
            raise AssertionError(f"({label}) shapes {tuple(post.mean().shape)}"
                                 f", {tuple(fes.shape)}")
        err = max(
            float(np.abs(post.mean()[:, rows].cpu().numpy() - o_m).max()),
            float(np.abs(post.cov()[:, rows].cpu().numpy() - o_p).max()))
        out[f"oracle_err_{label}"] = err
        log(f"[stream] ({label}) plan {'engaged' if eng._stream_plan else 'off'}"
            f"; chains {rows} against the float64 filter: max abs err "
            f"{err:.3g} (tol {STREAM_TOL}); launches "
            f"{out[f'launches_{label}']}")
        if not err <= STREAM_TOL:
            raise AssertionError(f"({label}) against the float64 filter: "
                                 f"{err}")
    if not engines["a"]._stream_plan or engines["b"]._stream_plan:
        raise AssertionError("the fused stream plan did not engage on (a), "
                             "or engaged on (b)")
    out["a_vs_b"] = max(
        float((posts["a"].mean() - posts["b"].mean()).abs().max()),
        float((posts["a"].cov() - posts["b"].cov()).abs().max()))
    # (c): one stream through on_next, its events and posteriors
    eng_c = rt.infer(
        model=_stream_tick_model(r), autoupdates=_stream_autoupdates(
            f, q, p0, None, device), keephistory=STREAM_ONLINE_T,
        datastream=[{"y": ys[k, 0]} for k in range(STREAM_ONLINE_T)],
        device=device)
    names = [e.name for e in eng_c.events]
    out["events_ok"] = names == stream_events(STREAM_ONLINE_T)
    got_m = torch.stack([h["x"].mean() for h in eng_c.history])
    got_p = torch.stack([h["x"].cov() for h in eng_c.history])
    out["c_vs_a"] = max(
        float((got_m - posts["a"].mean()[:STREAM_ONLINE_T, 0]).abs().max()),
        float((got_p - posts["a"].cov()[:STREAM_ONLINE_T, 0]).abs().max()))
    log(f"[stream] (a) against (b): max abs {out['a_vs_b']:.3g}; (c) "
        f"{STREAM_ONLINE_T} ticks of chain 0 through on_next against (a): "
        f"{out['c_vs_a']:.3g} (tol {STREAM_TOL}); (c)'s {len(names)} events "
        f"in the reference order: {out['events_ok']}")
    if not (out["a_vs_b"] <= STREAM_TOL and out["c_vs_a"] <= STREAM_TOL
            and out["events_ok"]):
        raise AssertionError(f"streaming paths disagree: {out}; events "
                             f"{names}")
    if device.type != "cuda":
        return out
    eng_a, eng_b = engines["a"], engines["b"]
    out["ms_a"] = _cuda_ms(lambda: eng_a.run_offline(obs), reps)
    out["ms_b"] = out["first_ms_b"]    # its checked call (1.4 s a call)
    head = {"y": ys[:STREAM_PROFILE_T]}
    for label, eng in (("a", eng_a), ("b", eng_b)):
        head_ms = _cuda_ms(lambda: eng.run_offline(head), 3, warmup=1)
        busy = _device_profile(lambda: eng.run_offline(head), {})["busy_ms"]
        out[f"busy_ms_{label}"] = (busy * out[f"ms_{label}"] / head_ms
                                   if isinstance(busy, float) else busy)
        out[f"updates_per_s_{label}"] = STREAM_B * STREAM_T / (
            out[f"ms_{label}"] / 1e3)
    t0 = time.perf_counter()
    eng_c.start([{"y": ys[k, 0]} for k in range(STREAM_ONLINE_T)])
    out["on_next_ms"] = (time.perf_counter() - t0) * 1e3 / STREAM_ONLINE_T
    log(f"[stream] (a) fused plan {out['ms_a']:.3f} ms per run_offline "
        f"({out['updates_per_s_a']:.4g} updates/s), busy {out['busy_ms_a']} "
        f"ms, idle {_idle_share(out['ms_a'], out['busy_ms_a'])}, peak "
        f"{out['peak_bytes_a'] / 1e6:.1f} MB; (b) generic tick "
        f"{out['ms_b']:.3f} ms ({out['updates_per_s_b']:.4g} updates/s), "
        f"busy {out['busy_ms_b']} ms, idle "
        f"{_idle_share(out['ms_b'], out['busy_ms_b'])}, peak "
        f"{out['peak_bytes_b'] / 1e6:.1f} MB (busy: each one's share over "
        f"a {STREAM_PROFILE_T}-tick call); (c) on_next "
        f"{out['on_next_ms']:.3f} ms a tick (host clock); for scale, path "
        f"A's K3 call (phase 7) {path_a_ms} ms")
    return out


# -- slice 12: K1/K2 at d 9..16 (the wide kernels, V3) and bf16 moments (V2) --------

# Phase 15 (b): bench.py:612-622's d16 fused row; sampled chains against
# bench.py:650-670's float64 RTS, and the fused program against
# ``fused_kernels=False`` at a small shape.
D16_B, D16_T, D16_D = 1024, 2048, 16
D16_SMALL = (8, 256)
# (B, T, d, mode) of the wide kernels' checks: d = 16 at the row's batch and
# at B = 1024 with W and Q per chain, the smallest wide d with a ragged last
# block of chains (37 = 4 * 8 + 5), d = 12 with W and Q per chain, bf16
# moments with shared and with per-chain precisions, and an ill-conditioned
# case: d = 16, W and Q per chain, P0 = 1e6 I ("vague"), where one plain
# TF32 product loses three digits (tests/test_torch_smoother_wide_tc.py).
# Short chains: the plain version issues about 10^4 torch operations a step
# at d = 16.
WIDE_CHECK_SHAPES = [(1024, 4, 16, ""), (37, 16, 9, ""), (64, 8, 12, "WQ"),
                     (1024, 4, 16, "WQ"), (64, 8, 16, "bf16"),
                     (40, 6, 10, "WQ bf16"), (45, 5, 16, "WQ vague")]
# P0's scale in the checks, and in the "vague" case
CHECK_P0_SCALE, VAGUE_P0_SCALE = 9.0, 1e6
WIDE_PLAIN_SHAPE = WIDE_CHECK_SHAPES[0][:3]
# The bf16 register kernels at every CHECK_SHAPES shape (one time block and
# many) and, with W and Q per chain, at one shape of 8 blocks, against the
# plain version of the same passes (``fused_*_blocked_reference`` at the
# wrapper's number of blocks).
BF16_DYN_SHAPES = [(40, 257, 3)]
# bf16 moments against their bf16 plain version: two bf16 ulps relative.
# Both sides round float32 values that differ in their last bits (fused
# multiply-adds, and for the wide kernels Gauss-Jordan against the Schur
# recursion), so an entry near a rounding boundary lands one bf16 ulp
# (2^-8 to 2^-7 relative) away, and K2 carries such a flip of pf into its
# outputs; measured on an H100: 7.63e-3 relative at most.  The float32
# means are held at RTOL / ATOL.
BF16_RTOL, BF16_ATOL = 1.6e-2, 3e-4
# Phase 15 (c): the bf16 program against the float32 one at the JAX
# package's own tolerances (tests/parallel/test_pallas_smoother.py:82-85):
# means 3e-2 absolute, covariances 3e-2 (relative and absolute), cross 5e-2.
BF16_ROW_TOL = {"means": 3e-2, "covs": 3e-2, "cross": 5e-2}
WIDE_KERNEL_NAMES = {"fused_smoother_fwd_wide": "wide_fwd_tc_kernel",
                     "fused_smoother_bwd_wide": "wide_bwd_ring_kernel"}

# Phase 16 (a): the wide K4/K5 at (B, T, K): (37, 1001, 9) the smallest wide
# K, ragged staged and marginal tiles, B mod 4 chains a CTA; (8, 4099, 16)
# the most marginal tiles; (33, 97, 32) a full warp of states; (5, 33, 33)
# one state past it (lane 0 takes two); (3, 17, 64) the table in shared
# memory; (2, 9, 240) past it: 240 rows of 241 floats do not fit an H100
# block's 227 KB beside the ring, so both passes read the table from device
# memory (FB_DEVICE_TABLE_K, held by the check); (37, 1001, 17) the first K
# of the marginal kernel past 16 states, a row of 17 floats (scalar stores,
# an odd stride), ragged tiles.
FB_WIDE_CHECK_SHAPES = [(37, 1001, 9), (8, 4099, 16), (33, 97, 32),
                        (5, 33, 33), (3, 17, 64), (2, 9, 240),
                        (37, 1001, 17)]
FB_DEVICE_TABLE_K = 240
# Phase 16 (b): a 16-state HMM through batched_program at the path's full
# width; per-step xi is 999 * 1024 * 256 floats (1.05 GB) a sweep.
HMM16_B, HMM16_T, HMM16_IT, HMM16_K, HMM16_M = 1024, 1000, 20, 16, 8
# Phase 16 (c): the wide K3 at (B, T, d, dy): d = 9 with one observation and
# a ragged last block of chains (37 = 4 * 8 + 5); d = 12, dy = 9; d = 4 with
# twelve observations (the register kernel's d, padded work); dy = 40 (five
# k tiles of the evidence's product); d = dy = 16 over 8448 chains; d = 16
# with one observation over 65 steps, where the two inverses a step amplify
# any asymmetry of P (a kernel that does not keep P symmetric drifts); and
# a vague prior (P0 = 1e6 I, the fifth entry; 9 I elsewhere) at dy = 40,
# where W is well conditioned and one TF32 product in place of 3xTF32 loses
# digits.
FILTER_WIDE_CHECK_SHAPES = [(37, 65, 9, 1), (100, 33, 12, 9), (40, 20, 4, 12),
                            (33, 9, 16, 40), (8448, 17, 16, 16),
                            (37, 65, 16, 1), (33, 9, 16, 40, 1e6)]
# Phase 16 (d): path A at d = dy = 16 (B, T as phase 7); the plain version
# over its first steps only (about 10^4 small launches a step).
FILTER16_D = 16
FILTER16_PLAIN_STEPS = 4
# Phase 17 (a): the warp K3 (d > 16) at (B, T, d, dy) against its plain
# version: on the tensor-core tier d = 17 with one observation and a ragged
# last block of chains (37 = 4 * 8 + 5), d = 24 with fewer observations than
# states, d = 32 with dy = 40 (two staged chunks); on the tier past 32
# (FILTER_TC64_CHECK_SHAPES, in a check process of their own: the plain
# step at d = 64 is about 10^6 small torch operations, seconds on the host)
# d = 33 and 48 at DP = 48 (eight chains a block) with ragged last blocks
# (10 = 8 + 2, 17 = 2 * 8 + 1), d = 64 at DP = 64 (four chains a block)
# with 8, with one observation (a ragged block of 9 = 2 * 4 + 1) and with
# 100 (four staged chunks); d = 65, the first d past it, on the tier past
# 64 (a ragged 16-block: the state padded by 63).
FILTER_WARP_CHECK_SHAPES = [(37, 5, 17, 1), (33, 4, 24, 12), (33, 4, 32, 40)]
FILTER_TC64_CHECK_SHAPES = [(10, 3, 33, 5), (5, 2, 64, 8), (17, 2, 48, 7),
                            (9, 1, 64, 1), (5, 1, 64, 100), (3, 1, 65, 4)]
# ... and the tiers past them, against the float64 filter (the plain step is
# minutes there): d = 100 on the tier past 64 (F in shared memory, Q and W
# read from device memory, a padding of 28), d = 176 on the sweep tier, each
# chain's matrices in a device-memory scratch (``warp_plan`` on an H100; the
# check holds the placements it expects), so that both tiers past 64 stay
# checked.
FILTER_WARP_TIER_SHAPES = [(3, 3, 100, 7, ("F shared, Q and W device",
                                           "shared")),
                           (2, 2, 176, 3, ("device", "device"))]
# Phase 17 (b): path A at d = dy = 32 (B, T as phase 7); the plain version
# over its first steps only, the kernel alone timed a launch at a time
# (about 0.1 s a call).
FILTER32_D = 32
FILTER32_PLAIN_STEPS = 2
# Phases 15 (a) and 17 (a), ROADMAP C7: chains with one observation a step
# over ONE_OBS_T steps, where the two inverses of a filter step amplify any
# gap between P's two triangles (a kernel that does not keep P symmetric
# drifts to NaN), against the float64 filter / RTS on every chain at
# ORACLE_TOL: the wide K1 and K2 at d = 16 with a rank-one W, the warp K3's
# tensor-core tiers at each ONE_OBS_WARP_D (48 and 64: the tier past 32;
# 128: the tier past 64).
ONE_OBS_T, ONE_OBS_B = 200, 37
ONE_OBS_WIDE_D = 16
ONE_OBS_WARP_D = (17, 24, 32, 48, 64, 128)
# Phase 26 (a): path A at d = dy = 64 on the warp K3's tier past 32, the
# sweep tier timed at the same shape in the same run; the kernel against
# its plain version on the path's inputs over FILTER64_PLAIN_STEPS steps of
# FILTER64_PLAIN_CHAINS sampled chains on the host (the plain step is about
# 1.4e6 small torch operations at d = 64: seconds on the host, more on the
# card).  (b) a 32-state HMM through batched_program at phase 16 (b)'s
# width, on the wide K4/K5 (the marginal kernel past 16 states), over 32
# categories, each state's most likely its own (``hmm_k_emission``): with
# 8, four states a category, the float32 VMP drifts 2.2e-4 relative from
# the float64 one over 20 sweeps on the CPU as well, past HMM_ORACLE_TOL
# (``scripts/hmm16_conditioning.py --states 32 --categories 8``; 32
# categories: 7.2e-6 for A, 3.6e-5 for B).
FILTER64_B, FILTER64_T, FILTER64_D = 2000, 200, 64
FILTER64_PLAIN_STEPS, FILTER64_PLAIN_CHAINS = 1, 4
HMM32_B, HMM32_T, HMM32_IT, HMM32_K, HMM32_M = 1024, 1000, 20, 32, 32
# Phase 27 (a): path A at d = dy = 128 on the warp K3's tier past 64 (a
# fleet of trackers whose state joins many keypoints: 21 hand landmarks in
# 3-D with their velocities is d = 126), the sweep tier timed at the same
# shape in the same run; the kernel against its plain version on the
# path's inputs over FILTER128_PLAIN_STEPS steps of FILTER128_PLAIN_CHAINS
# sampled chains on the host (about 1e7 small torch operations a step: a
# minute, in a check process).  (b) a 64-state HMM through batched_program
# (a regime model of 64 states fitted per series), on the wide K4/K5 (the
# marginal kernel past 32 states), over 64 categories, each state's most
# likely its own (``hmm_k_emission``; ``scripts/hmm16_conditioning.py
# --states 64 --categories 64 --chains 512``), ``fb_wide_marg_kernel``
# timed beside the new marginal kernel.
FILTER128_B, FILTER128_T, FILTER128_D = 1000, 200, 128
FILTER128_PLAIN_STEPS, FILTER128_PLAIN_CHAINS = 1, 2
HMM64_B, HMM64_T, HMM64_IT, HMM64_K, HMM64_M = 512, 1000, 20, 64, 64
# The warp K3's tensor-core tiers past 32 on their paths (phases 26 (a), 27
# (a)): d -> (B, T, plain steps, plain chains, the plan's tier, the device
# kernel, its library, the sweep tier's timing (rounds, warm-ups; no rounds:
# its one call, the one whose outputs are compared, timed))
TIER_PATHS = {
    FILTER64_D: (FILTER64_B, FILTER64_T, FILTER64_PLAIN_STEPS,
                 FILTER64_PLAIN_CHAINS, "tensor_cores_64",
                 "warp_filter_tc64_kernel", "fused_filter_warp", (2, 1)),
    FILTER128_D: (FILTER128_B, FILTER128_T, FILTER128_PLAIN_STEPS,
                  FILTER128_PLAIN_CHAINS, "tensor_cores_128",
                  "warp_filter_tc128_kernel", "fused_filter_tc128", (0, 0)),
}
BF16_KERNEL_NAMES = {"fused_smoother_fwd_bf16": SMOOTHER_KERNEL_NAMES[
                         "fused_smoother_fwd"],
                     "fused_smoother_bwd_bf16": SMOOTHER_KERNEL_NAMES[
                         "fused_smoother_bwd"]}


def _check_rows(rows: dict, worst: dict, failures: list, where: str,
                bf16: bool) -> list:
    """Hold each (label, got, want) of ``rows`` (launch key -> items)
    against its plain version: RTOL / ATOL, the bf16 moments at BF16_RTOL /
    BF16_ATOL.  Updates ``worst`` and ``failures``; returns the log parts."""
    parts = []
    for kname, items in rows.items():
        for label, got, want in items:
            moment = bf16 and label in ("pf", "ps", "cross")
            tol = (BF16_RTOL, BF16_ATOL) if moment else (RTOL, ATOL)
            ea, er, ok = _max_err(got.float().cpu().numpy(),
                                  want.float().cpu().numpy(), *tol)
            worst[kname] = max(worst.get(kname, 0.0), ea)
            parts.append(f"{label} abs {ea:.3g} rel {er:.3g}")
            if not ok:
                failures.append(f"{where} {label}: abs {ea:.3g} rel {er:.3g}"
                                f" (rtol {tol[0]}, atol {tol[1]})")
    return parts


def check_slice12_kernels(device, cases, log=print) -> tuple[dict, dict]:
    """Phase 15 (a): each (B, T, d, dyn, moment dtype) of ``cases``
    through the wrappers (W and Q per chain with ``dyn``) against the plain
    version of the same passes on the same inputs: the blocked plain
    version at the wrapper's number of time blocks, the step-by-step one at
    one block (always so for the wide kernels).  K2 takes K1's own mf, pf.
    Each wrapper call must count once under its launch key.  The plain
    versions run on the host but at the first case, where their one call on
    the card is their time, beside the kernels'.  Returns each launch key's
    max abs error and those times."""
    import torch

    from rxinfer_tpu_torch.ops import fused_smoother as fs

    worst: dict = {}
    failures: list = []
    plain: dict = {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for i, (bsz, t_len, d, dyn, md, *scale) in enumerate(cases):
        bf16 = md == torch.bfloat16
        p0_scale = scale[0] if scale else CHECK_P0_SCALE
        blocks = fs.pick_blocks(bsz, t_len, d, sms)
        f, b, q, w = _smoother_params(d, seed=1200 + i)
        rng = np.random.default_rng(1200 + i)
        dev = lambda a: torch.as_tensor(a, device=device)
        xi = dev(rng.standard_normal((t_len, bsz, d)).astype(np.float32))
        m0 = dev(rng.standard_normal((bsz, d)).astype(np.float32))
        p0 = dev(np.broadcast_to(p0_scale * np.eye(d, dtype=np.float32),
                                 (bsz, d, d)).copy())
        wb = dev(_spd_batch(rng, bsz, d, 0.8)) if dyn else None
        qb = dev(_spd_batch(rng, bsz, d, 0.4)) if dyn else None
        w_sh, q_sh = (None, None) if dyn else (w, q)
        keys = [fs.launch_key(dr, d, dyn, bf16) for dr in ("fwd", "bwd")]
        before = dict(fs.LAUNCHES)
        mf, pf = fs.fused_forward(m0, p0, xi, f, b, q_sh, w_sh, wb, qb,
                                  moment_dtype=md)
        ms, ps, cr = fs.fused_backward(mf, pf, f, b, q_sh, qb)
        torch.cuda.synchronize()
        for k in keys:
            if fs.LAUNCHES[k] - before[k] != 1:
                raise AssertionError(f"{k} did not count one launch at "
                                     f"(B,T,d)=({bsz},{t_len},{d})")
        if blocks > 1:
            ref_f = lambda *a: fs.fused_forward_blocked_reference(
                *a[:7], blocks, *a[7:])
            ref_b = lambda *a: fs.fused_backward_blocked_reference(
                *a[:5], blocks, *a[5:])
        else:
            ref_f, ref_b = fs.fused_forward_reference, \
                fs.fused_backward_reference
        args_f = (m0, p0, xi, f, b, q_sh, w_sh, wb, qb, md)
        args_b = (mf, pf, f, b, q_sh, qb)
        if i == 0:
            (mf_r, pf_r), fwd_plain_ms = _once_ms(lambda: ref_f(*args_f))
            (ms_r, ps_r, cr_r), bwd_plain_ms = _once_ms(
                lambda: ref_b(*args_b))
            plain = {keys[0]: {"plain_ms": fwd_plain_ms, "ms": _cuda_ms(
                         lambda: fs.fused_forward(*args_f[:9],
                                                  moment_dtype=md), 5, inner=20)},
                     keys[1]: {"plain_ms": bwd_plain_ms, "ms": _cuda_ms(
                         lambda: fs.fused_backward(*args_b), 5, inner=20)}}
        else:
            mf_r, pf_r = _on_host(ref_f, *args_f)
            ms_r, ps_r, cr_r = _on_host(ref_b, *args_b)
        rows = {keys[0]: [("mf", mf, mf_r), ("pf", pf, pf_r)],
                keys[1]: [("ms", ms, ms_r), ("ps", ps, ps_r),
                          ("cross", cr, cr_r)]}
        where = (f"(B,T,d)=({bsz},{t_len},{d}) {'WQ' if dyn else 'static'}"
                 f" {'bf16' if bf16 else 'float32'} P0 = {p0_scale:g} I "
                 f"blocks {blocks}")
        parts = _check_rows(rows, worst, failures, where, bf16)
        log(f"[{'wide' if d > fs.REG_MAX_DIM else 'bf16'} check] {where}: "
            + "; ".join(parts))
    if failures:
        raise AssertionError("a kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return worst, plain


def one_observation_system(d: int, b: int, t_len: int, seed: int = 5):
    """A smoother's chains with one observation of d states a step: F a
    scaled orthogonal matrix, Q = 0.4 I, W = h^T h / 0.9 of rank one (h
    mostly the first state), P0 = 9 I.  Returns m0 (B, d), p0 (B, d, d),
    xi (T, B, d), F, b (zero), Q, W, float32."""
    rng = np.random.default_rng(seed)
    qm, _ = np.linalg.qr(rng.standard_normal((d, d)))
    f = (0.98 * qm).astype(np.float32)
    q = (0.4 * np.eye(d)).astype(np.float32)
    h = (1.2 * np.eye(1, d) + 0.2 * rng.standard_normal((1, d))).astype(
        np.float32)
    w = (h.T @ h / 0.9).astype(np.float32)
    xi = (rng.standard_normal((t_len, b, 1)) @ h / 0.9).astype(np.float32)
    m0 = rng.standard_normal((b, d)).astype(np.float32)
    p0 = np.broadcast_to(9 * np.eye(d, dtype=np.float32), (b, d, d)).copy()
    return m0, p0, xi, f, np.zeros(d, np.float32), q, w


def check_one_observation_smoother(device, log=print) -> float:
    """Phase 15 (a), ROADMAP C7: the wide K1 and K2 at d = ONE_OBS_WIDE_D
    over ONE_OBS_T steps of one observation (``one_observation_system``),
    every chain's filtered and smoothed means and covariances against the
    float64 filter and RTS at ORACLE_TOL, each wrapper counting one launch.
    Returns the max abs error."""
    import torch

    from rxinfer_tpu_torch.ops import fused_smoother as fs

    d, bsz, t_len = ONE_OBS_WIDE_D, ONE_OBS_B, ONE_OBS_T
    m0, p0, xi, f, b, q, w = one_observation_system(d, bsz, t_len)
    dev = lambda a: torch.as_tensor(a, device=device)
    keys = [fs.launch_key(dr, d, False, False) for dr in ("fwd", "bwd")]
    before = {k: fs.LAUNCHES[k] for k in keys}
    mf, pf = fs.fused_forward(dev(m0), dev(p0), dev(xi), f, b, q, w)
    ms, ps, _ = fs.fused_backward(mf, pf, f, b, q)
    torch.cuda.synchronize()
    if any(fs.LAUNCHES[k] != before[k] + 1 for k in keys):
        raise AssertionError(f"{keys} did not count one launch each")
    o_mf, o_pf, o_ms, o_ps = rts_float64(m0, p0, xi, f, b, q, w,
                                         filtered=True)
    unfold = lambda x: fs.sym_unfold_t(x, d).cpu().numpy()
    errs, bad = {}, []
    for label, got, want in (
            ("K1 means", mf.transpose(1, 2).cpu().numpy(), o_mf),
            ("K1 covariances", unfold(pf), o_pf),
            ("K2 means", ms.transpose(1, 2).cpu().numpy(), o_ms),
            ("K2 covariances", unfold(ps), o_ps)):
        err = float(np.abs(got - want).max()) if np.isfinite(got).all() \
            else float("inf")
        errs[label] = err
        if not err <= ORACLE_TOL:
            bad.append(f"{label} {err:.3g}")
    log(f"[wide check] one observation of d = {d}, (B,T) = ({bsz},{t_len}), "
        f"rank-one W, against the float64 filter and RTS: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol {ORACLE_TOL})")
    if bad:
        raise AssertionError("the wide K1/K2 leave the float64 RTS on one "
                             "observation: " + "; ".join(bad))
    return max(errs.values())


def check_one_observation_filter(device, log=print) -> float:
    """Phase 17 (a), ROADMAP C7: the warp K3's tensor-core tiers at each
    ONE_OBS_WARP_D with one observation over ONE_OBS_T steps
    (``_filter_system``, P0 = 9 I), every chain's means and final moments
    against the float64 filter at ORACLE_TOL, one ``fused_filter_warp``
    launch a d.  Returns the max abs error."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff

    worst, bad = 0.0, []
    for d in ONE_OBS_WARP_D:
        f, q, h, r = _filter_system(d, 1, seed=d + 1)
        w_obs, hr = ff.evidence_operators(h, r)
        rng = np.random.default_rng(d)
        ys = rng.standard_normal((ONE_OBS_T, 1, ONE_OBS_B)).astype(
            np.float32)
        m = rng.standard_normal((ONE_OBS_B, d)).astype(np.float32)
        p = np.broadcast_to(9.0 * np.eye(d, dtype=np.float32),
                            (ONE_OBS_B, d, d)).copy()
        m0, p0 = _soa_state(torch.as_tensor(m, device=device),
                            torch.as_tensor(p, device=device))
        before = ff.LAUNCHES["fused_filter_warp"]
        means, mf, pf = ff.fused_filter(
            m0, p0, torch.as_tensor(ys, device=device), f, q, hr, w_obs)
        torch.cuda.synchronize()
        if ff.LAUNCHES["fused_filter_warp"] != before + 1:
            bad.append(f"d = {d}: no fused_filter_warp launch counted")
        o_means, o_m, o_p = filter_float64(m, p, ys.transpose(0, 2, 1), f, q,
                                           h, r)
        errs = {}
        for label, got, want in (
                ("means", means.transpose(1, 2).cpu().numpy(), o_means),
                ("final m", mf.t().cpu().numpy(), o_m),
                ("final P", _unfold_host(pf, d), o_p)):
            err = float(np.abs(got - want).max()) \
                if np.isfinite(got).all() else float("inf")
            errs[label] = err
            worst = max(worst, err)
            if not err <= ORACLE_TOL:
                bad.append(f"d = {d} {label} {err:.3g}")
        log(f"[check] K3 fused_filter_warp one observation of d = {d}, "
            f"(B,T) = ({ONE_OBS_B},{ONE_OBS_T}), against the float64 filter:"
            f" " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (tol {ORACLE_TOL})")
    if bad:
        raise AssertionError("the warp K3's tensor-core tiers leave the "
                             "float64 filter on one observation: "
                             + "; ".join(bad))
    return worst


def wide_check_cases() -> list:
    """Phase 15 (a)'s cases of the wide kernels: WIDE_CHECK_SHAPES as
    ``check_slice12_kernels`` takes them."""
    import torch

    return [(bsz, t, d, "WQ" in mode,
             torch.bfloat16 if "bf16" in mode else torch.float32,
             VAGUE_P0_SCALE if "vague" in mode else CHECK_P0_SCALE)
            for bsz, t, d, mode in WIDE_CHECK_SHAPES]


def slice12_checks(which: str, wall0: float) -> tuple[list, dict, dict]:
    """Phase 15 (a)'s ``"wide"`` or ``"bf16"`` kernel checks in a process
    of their own, beside phase 3's (their plain versions are host loops).
    Returns the log lines, each launch key's max error and the plain
    versions' times."""
    import torch

    bf16 = torch.bfloat16
    # the bf16 checks of the longest CHECK_SHAPES go with the wide ones, so
    # that the two processes end together
    late = CHECK_SHAPES[-3:-1]
    if which == "wide":
        cases = wide_check_cases() + \
            [(bsz, t, d, False, bf16) for bsz, t, d in late]
    else:
        cases = [(bsz, t, d, False, bf16) for bsz, t, d in CHECK_SHAPES
                 if (bsz, t, d) not in late] + \
            [(bsz, t, d, True, bf16) for bsz, t, d in BF16_DYN_SHAPES]
    lines: list = []
    worst, plain = check_slice12_kernels(torch.device("cuda"), cases,
                                         log=lines.append)
    if which == "wide":
        worst["one_observation"] = check_one_observation_smoother(
            torch.device("cuda"), log=lines.append)
    _ended(lines, f"{which} K1/K2 checks", wall0)
    return lines, worst, plain


def rts_cov_float64(f, q, h, r, m0, p0, y):
    """bench.py:650-670's float64 RTS smoother in covariance form, one
    chain: y (T, dy); returns smoothed means (T, d) and covariances
    (T, d, d)."""
    f, q, h, r = (np.asarray(a, np.float64) for a in (f, q, h, r))
    mf, pf = [], []
    m, p = np.asarray(m0, np.float64), np.asarray(p0, np.float64)
    for t in range(y.shape[0]):
        if t > 0:
            m = f @ m
            p = f @ p @ f.T + q
        s_t = h @ p @ h.T + r
        k = p @ h.T @ np.linalg.inv(s_t)
        m = m + k @ (y[t].astype(np.float64) - h @ m)
        p = p - k @ h @ p
        mf.append(m)
        pf.append(p)
    ms, ps = list(mf), list(pf)
    for t in range(y.shape[0] - 2, -1, -1):
        ppred = f @ pf[t] @ f.T + q
        g = pf[t] @ f.T @ np.linalg.inv(ppred)
        ms[t] = mf[t] + g @ (ms[t + 1] - f @ mf[t])
        ps[t] = pf[t] + g @ (ps[t + 1] - ppred) @ g.T
    return np.stack(ms), np.stack(ps)


def d16_path(device, b: int, t_len: int, d: int, reps: int,
             log=print) -> dict:
    """Phase 15 (b): bench.py:612-622's d16 fused row through
    ``batched_program``: ``gen16`` (bench.py:590-597: F = kron(I8, rot),
    Q = R = I, H = 1.3 I, m0 = 0, P0 = 25 I) at (B, T) = (1024, 2048), one
    iteration, y from a numpy seed.  Exactly one wide K1 and one wide K2
    launch a call and no other; sampled chains against the float64 RTS
    (ORACLE_TOL); the fused program against ``fused_kernels=False`` at
    D16_SMALL (ORACLE_TOL, no kernel launched there); the program's median
    of ``reps`` calls, updates/s = 3 T B / t (bench.py:622), K1 and K2
    alone and in the program (one profiled call), peak memory."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    f, q, h, r, m0, p0 = lgssm_constants(d)
    model = zoo.lgssm(f, q, h, r, m0, p0)
    y = torch.as_tensor(d16_y(b, t_len, d), device=device)
    compiled, prog = rt.batched_program(model, {"y": y}, iterations=1,
                                        device=device)
    report = compiled.plan_report()
    log(f"[d16] plan_report {report}")
    if report.get("x", {}).get("fused") is not True:
        raise AssertionError("the d16 chain is not on the fused path")
    reset_launches()
    (state, _, _), peak = _peak_call(device, lambda: prog({"y": y}))
    launches = read_launches()
    log(f"[d16] launches in one program call: {launches}; peak "
        f"{peak / 1e9:.3f} GB above the inputs")
    expect_launches(launches, fused_smoother_fwd_wide=1,
                    fused_smoother_bwd_wide=1)
    means = state["x"].mu.cpu().numpy()
    covs = state["x"].sigma.cpu().numpy()
    if means.shape != (b, t_len, d) or covs.shape != (b, t_len, d, d) \
            or not (np.isfinite(means).all() and np.isfinite(covs).all()):
        raise AssertionError(f"d16 posterior shapes {means.shape}, "
                             f"{covs.shape} or non-finite values")
    errs = {"means": 0.0, "covs": 0.0}
    rows = edge_rows(b)
    oracle = d16_oracle(b, t_len, d)
    for row in rows:
        om, op = oracle[row]
        errs["means"] = max(errs["means"], float(np.abs(means[row] - om).max()))
        errs["covs"] = max(errs["covs"], float(np.abs(covs[row] - op).max()))
    log(f"[d16] float64 RTS (bench.py:650-670), chains {rows}: max abs "
        f"err means {errs['means']:.3g}, covs {errs['covs']:.3g} (tol "
        f"{ORACLE_TOL})")
    if max(errs.values()) > ORACLE_TOL:
        raise AssertionError(f"the d16 row disagrees with the float64 RTS: "
                             f"{errs}")

    # the fused program against the scan path on the same rows
    bs, ts = D16_SMALL
    ys = y[:bs, :ts].contiguous()
    _, fprog = rt.batched_program(model, {"y": ys}, iterations=1,
                                  device=device)
    ucomp, uprog = rt.batched_program(
        model, {"y": ys}, iterations=1, device=device,
        options={"fused_kernels": False, "warn": False})
    fs_state, _, _ = fprog({"y": ys})
    reset_launches()
    us_state, _, _ = uprog({"y": ys})
    torch.cuda.synchronize()
    expect_launches(read_launches())
    unf = {"means": float((fs_state["x"].mu - us_state["x"].mu).abs().max()),
           "covs": float((fs_state["x"].sigma
                          - us_state["x"].sigma).abs().max())}
    log(f"[d16] fused against fused_kernels=False at (B,T)={D16_SMALL}: max "
        f"abs diff means {unf['means']:.3g}, covs {unf['covs']:.3g} (tol "
        f"{ORACLE_TOL}; no kernel launched by the scan path)")
    if max(unf.values()) > ORACLE_TOL:
        raise AssertionError(f"d16 fused and unfused programs disagree: {unf}")

    out = {"launches": launches, "errs": errs, "unfused_diff": unf,
           "peak_bytes": peak}
    out["program_ms"] = _cuda_ms(lambda: prog({"y": y}), reps)
    out["updates_per_s"] = 3 * t_len * b / (out["program_ms"] / 1e3)
    w_obs = (h.T @ np.linalg.inv(r) @ h).astype(np.float32)
    ek = torch.as_tensor((h.T @ np.linalg.inv(r)).astype(np.float32),
                         device=device)
    xi_t = torch.einsum("if,btf->tbi", ek, y).contiguous()
    m0_t = torch.as_tensor(m0, device=device).expand((b, d)).contiguous()
    p0_t = torch.as_tensor(p0, device=device).expand((b, d, d)).contiguous()
    zeros = np.zeros(d, np.float32)
    mf, pf = fs.fused_forward(m0_t, p0_t, xi_t, f, zeros, q, w_obs)
    with SmClock() as clk:
        out["fwd_ms"] = _cuda_ms(
            lambda: fs.fused_forward(m0_t, p0_t, xi_t, f, zeros, q, w_obs),
            reps)
        out["bwd_ms"] = _cuda_ms(
            lambda: fs.fused_backward(mf, pf, f, zeros, q), reps)
    out["sm_clock_mhz"] = clk.mhz
    out["profile"] = _device_profile(lambda: prog({"y": y}),
                                     WIDE_KERNEL_NAMES)
    out["shape"] = fs.wide_kernel_shape(device)
    steps = {"fused_smoother_fwd_wide": t_len,
             "fused_smoother_bwd_wide": t_len - 1}
    out["cycles_per_step"] = {
        k: {"alone": _cycles_per_step(out["fwd_ms" if "fwd" in k else
                                          "bwd_ms"], clk.mhz, n),
            "in_program": _cycles_per_step(
                out["profile"]["kernels"][k]["ms_per_launch"], clk.mhz, n)}
        for k, n in steps.items()}
    busy = out["profile"]["busy_ms"]
    log(f"[d16] program {out['program_ms']:.3f} ms/call "
        f"({out['updates_per_s']:.4g} updates/s); K1 alone "
        f"{out['fwd_ms']:.3f} ms, K2 alone {out['bwd_ms']:.3f} ms; device "
        f"busy {busy} ms per call, idle "
        f"{_idle_share(out['program_ms'], busy)}; in the program "
        f"{out['profile']['kernels']}; cycles a step at "
        f"{clk.mhz:.0f} MHz {out['cycles_per_step']}; the kernels' shape "
        f"{out['shape']}")
    return out


def bf16_path(device, b: int, t_len: int, d: int, reps: int,
              log=print) -> dict:
    """Phase 15 (c): bench.py:240-251's row, phase 4's LGSSM cell with
    ``options={"fused_moment_dtype": "bfloat16"}``, beside the same run's
    float32 program: exactly one bf16 K1 and one bf16 K2 launch a call and
    no other; the posteriors, and the smoother's means, covariances and
    cross on the path's inputs, against the float32 ones (BF16_ROW_TOL);
    both programs' median of ``reps`` calls in turns, updates/s, each
    kernel alone and in the program (one profiled call)."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import fused_smoother as fs

    f, q, h, r, m0, p0 = lgssm_constants(d)
    model = zoo.lgssm(f, q, h, r, m0, p0)
    y = torch.as_tensor(lgssm_y(b, t_len, d), device=device)
    _, prog32 = rt.batched_program(model, {"y": y}, iterations=1,
                                   device=device)
    comp16, prog16 = rt.batched_program(
        model, {"y": y}, iterations=1, device=device,
        options={"fused_moment_dtype": "bfloat16"})
    if comp16.plan_report()["x"].get("fused") is not True:
        raise AssertionError("the bf16 chain is not on the fused path")
    state32, _, _ = prog32({"y": y})
    reset_launches()
    state16, _, _ = prog16({"y": y})
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[bf16] launches in one program call: {launches}")
    expect_launches(launches, fused_smoother_fwd_bf16=1,
                    fused_smoother_bwd_bf16=1)

    # the smoother on the path's inputs, bf16 against float32
    hinv = (h.T @ np.linalg.inv(r)).astype(np.float32)
    w_obs = (hinv @ h).astype(np.float32)
    xi_t = torch.einsum("if,btf->tbi", torch.as_tensor(hinv, device=device),
                        y).contiguous()
    m0_t = torch.as_tensor(m0, device=device).expand((b, d)).contiguous()
    p0_t = torch.as_tensor(p0, device=device).expand((b, d, d)).contiguous()
    zeros = np.zeros(d, np.float32)
    got = fs.fused_batched_smoother(m0_t, p0_t, xi_t, f, zeros, q, w_obs,
                                    moment_dtype=torch.bfloat16)
    want = fs.fused_batched_smoother(m0_t, p0_t, xi_t, f, zeros, q, w_obs)
    errs = {}
    for name, g, wnt in zip(("means", "covs", "cross"), got, want):
        if g.dtype != torch.float32:
            raise AssertionError(f"bf16 {name} returned as {g.dtype}")
        errs[name] = float((g - wnt).abs().max())
    errs["posterior_means"] = float((state16["x"].mu
                                     - state32["x"].mu).abs().max())
    errs["posterior_covs"] = float((state16["x"].sigma
                                    - state32["x"].sigma).abs().max())
    covs_rel = float(((got[1] - want[1]).abs()
                      / (BF16_ROW_TOL["covs"]
                         * (1 + want[1].abs()))).max())
    log(f"[bf16] against the float32 program: max abs diff " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items())
        + f"; covariances at {covs_rel:.3g} of the rtol=atol="
        f"{BF16_ROW_TOL['covs']} allowance (tolerances {BF16_ROW_TOL}, "
        "tests/parallel/test_pallas_smoother.py:82-85)")
    for name, tol in (("means", "means"), ("posterior_means", "means"),
                      ("cross", "cross")):
        if errs[name] > BF16_ROW_TOL[tol]:
            raise AssertionError(f"bf16 {name} off by {errs[name]}")
    if covs_rel > 1.0 or errs["posterior_covs"] > BF16_ROW_TOL["covs"] * (
            1 + float(state32["x"].sigma.abs().max())):
        raise AssertionError("bf16 covariances beyond rtol=atol=3e-2")

    out = {"launches": launches, "errs": errs}
    # the two programs in turns: float32, bf16, bf16, float32
    t32a = _cuda_ms(lambda: prog32({"y": y}), reps)
    t16a = _cuda_ms(lambda: prog16({"y": y}), reps)
    t16b = _cuda_ms(lambda: prog16({"y": y}), reps)
    t32b = _cuda_ms(lambda: prog32({"y": y}), reps)
    out["program_ms"] = statistics.median([t16a, t16b])
    out["program_ms_fp32"] = statistics.median([t32a, t32b])
    out["program_ms_runs"] = [t32a, t16a, t16b, t32b]
    out["updates_per_s"] = 3 * t_len * b / (out["program_ms"] / 1e3)
    out["updates_per_s_fp32"] = 3 * t_len * b / (out["program_ms_fp32"] / 1e3)
    mf, pf = fs.fused_forward(m0_t, p0_t, xi_t, f, zeros, q, w_obs,
                              moment_dtype=torch.bfloat16)
    out["fwd_ms"] = _cuda_ms(lambda: fs.fused_forward(
        m0_t, p0_t, xi_t, f, zeros, q, w_obs, moment_dtype=torch.bfloat16),
        reps)
    out["bwd_ms"] = _cuda_ms(lambda: fs.fused_backward(mf, pf, f, zeros, q),
                             reps)
    out["profile"] = _device_profile(lambda: prog16({"y": y}),
                                     BF16_KERNEL_NAMES)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    out["blocks"] = fs.pick_blocks(b, t_len, d, sms)
    busy = out["profile"]["busy_ms"]
    log(f"[bf16] program {out['program_ms']:.3f} ms/call "
        f"({out['updates_per_s']:.4g} updates/s) against float32 "
        f"{out['program_ms_fp32']:.3f} ms ({out['updates_per_s_fp32']:.4g});"
        f" in turns {[round(x, 4) for x in out['program_ms_runs']]}; K1 "
        f"alone {out['fwd_ms']:.4f} ms, K2 alone {out['bwd_ms']:.4f} ms; "
        f"device busy {busy} ms, idle {_idle_share(out['program_ms'], busy)};"
        f" in the program {out['profile']['kernels']}")
    return out


# -- slice 13: K4/K5 above eight states (V4), K3 at d 9..16 or dy > 8 (V5) ----------

def hmm_k_emission(k: int, m: int) -> np.ndarray:
    """Emission probabilities (m, K) of the K-state cell: state s emits
    category s % m with 0.5, a second one, (s % m + 1 + 2 (s // m)) % m,
    that tells s from s + m, with 0.3, and any category with 0.2 / m.  With
    two states a category (s and s + m alike) the VMP is ill-conditioned:
    the float32 plain version drifts 1.2e-4 relative from the float64 VMP
    over 20 sweeps on the CPU as well, and the float64 VMP moves 1e-5 for a
    1e-7 change of its input; with this one the drift is 4.4e-5
    (``scripts/hmm16_conditioning.py``)."""
    e = np.full((m, k), 0.2 / m)
    for s in range(k):
        e[s % m, s] += 0.5
        e[(s % m + 1 + 2 * (s // m)) % m, s] += 0.3
    return e


def simulate_hmm_k(b: int, t_len: int, k: int, m: int, seed: int):
    """One-hot observations of ``simulate_hmm``'s kind for K states and m
    categories, every chain at once: a sticky chain (it stays with
    probability 0.9, else jumps to a uniform state) emitting by
    ``hmm_k_emission``."""
    rng = np.random.default_rng(seed)
    cum = np.cumsum(hmm_k_emission(k, m), axis=0)          # (m, K)
    s = rng.integers(k, size=b)
    ys = np.empty((b, t_len), np.int64)
    for t in range(t_len):
        s = np.where(rng.random(b) < 0.1, rng.integers(k, size=b), s)
        u = rng.random(b)
        ys[:, t] = np.minimum((u[None, :] > cum[:, s]).sum(0), m - 1)
    return np.eye(m, dtype=np.float32)[ys]


def hmm_k_init(k: int, m: int):
    """Initial concentrations of A (flat, K x K) and B (m x K: 1 + 10 times
    the emission probabilities)."""
    a0 = np.ones((k, k), np.float32)
    b0 = (1.0 + 10.0 * hmm_k_emission(k, m)).astype(np.float32)
    return a0, b0


def hmm16_path(device, b: int, t_len: int, k: int, m: int, iterations: int,
               reps: int, smi: str, log=print,
               beside_first_written: bool = False) -> dict:
    """Phase 16 (b) (and 26 (b) at 32 states; the log lines' tag "hmm{k}"):
    ``zoo.hmm(k, m)`` through ``batched_program`` at (B, T)
    with ``iterations`` sweeps, y from ``simulate_hmm_k``: the plan fused on
    the CUDA route, exactly ``iterations`` serial launches (both
    recursions) and ``iterations`` marginal launches a call and no other
    kernel, sampled chains against the float64 VMP (HMM_ORACLE_TOL), the
    two calls against their plain versions on the last sweep's inputs
    (FB_RTOL / FB_ATOL), one call with ``free_energy=True`` against the
    float64 structured VMP's Bethe FE (FE_HMM_TOL; the port counts the
    matrix entropy per transition, C6); the program's median of ``reps``
    calls, updates/s = B * iterations * (T + 2) (bench.py:536), one
    profiled call (device busy, idle share, each pass's ms), and on the
    last sweep's inputs each call alone, each recursion alone and the
    wrappers ``fb_forward`` / ``fb_backward`` (CUDA events, beside the SM
    clock sampled meanwhile); with ``beside_first_written`` (phase 27 (b))
    the marginal call held to the plain version's bits, and
    ``fb_wide_marg_kernel`` on the same inputs, its outputs equal to the
    marginal call's, timed between two timings of that call."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine.blocks import BatchContext
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    tag = f"hmm{k}"
    names = FB_ROWS_KERNEL_NAMES if ffb.HALF_WARP_STATES < k <= \
        ffb.ROW_STATES else FB_ROWS2_KERNEL_NAMES if ffb.ROW_STATES < k <= \
        ffb.ROWS2_STATES else FB_WIDE_KERNEL_NAMES
    marks = [("start", time.perf_counter())]
    mark = lambda what: marks.append((what, time.perf_counter()))
    y_host = hmm16_y(b, t_len, k, m)
    y = torch.as_tensor(y_host, device=device)
    a0, b0 = hmm_k_init(k, m)
    init = {"A": rt.DirichletCollection(a0), "B": rt.DirichletCollection(b0)}
    model = zoo.hmm(k, m)
    compiled, prog = rt.batched_program(
        model, {"y": y}, iterations=iterations, free_energy=False,
        initialization=init, device=device)
    report = compiled.plan_report()
    mark("data and plan")
    log(f"[{tag}] plan_report {report}")
    if report.get("s") != {"fused": True, "kernel": "fused_fb",
                           "route": "cuda"}:
        raise AssertionError(f"the {k}-state chain is not on the CUDA "
                             "forward-backward kernels")
    reset_launches()
    (state, _, _), peak = _peak_call(device, lambda: prog({"y": y}))
    launches = read_launches()
    log(f"[{tag}] launches in one program call: {launches}; peak "
        f"{peak / 1e9:.3f} GB above the inputs")
    expect_launches(launches, fused_fb_serial_wide=iterations,
                    fused_fb_marg_wide=iterations)
    probs = state["s"].probs().cpu().numpy()
    conc = {n: state[n].alpha.cpu().numpy() for n in ("A", "B")}
    if probs.shape != (b, t_len, k) or not np.isfinite(probs).all() or \
            any(not np.isfinite(c).all() for c in conc.values()):
        raise AssertionError(f"{k}-state HMM posteriors have the wrong "
                             "shape or are not finite")
    mark("checked call")
    rows = edge_rows(b)
    # one float64 VMP pass: the posteriors here, its FE below
    fe_want, (o_g, o_a, o_b) = hmm16_oracle(b, t_len, k, m, iterations)
    mark("float64 VMP")
    errs = {
        "gammas": float(np.abs(probs[rows] - o_g).max()),
        "A_rel": float((np.abs(conc["A"][rows] - o_a) / o_a).max()),
        "B_rel": float((np.abs(conc["B"][rows] - o_b) / o_b).max()),
    }
    log(f"[{tag}] float64 VMP, chains {rows}: {errs} (tol {HMM_ORACLE_TOL})")
    if errs["gammas"] > HMM_ORACLE_TOL["gammas"] or max(
            errs["A_rel"], errs["B_rel"]) > HMM_ORACLE_TOL["conc_rel"]:
        raise AssertionError(f"the {k}-state HMM disagrees with the float64 "
                             f"VMP: {errs}")
    out = {"errs": errs, "launches": launches, "peak_bytes": peak}
    block = next(blk for kind, blk in compiled.blocks if blk.var.name == "s")
    lp, elog_a, le_t = block._inputs(state, {"y": y}, {},
                                     BatchContext(device, b, {}))
    out["kernel_errs"], out["plain_ms"] = check_fb_path_inputs(
        lp, elog_a, le_t, log=log, tag=tag,
        serial_rows=rows if k > ffb.HALF_WARP_STATES else None,
        marginal_bits=beside_first_written)
    mark("the two calls against the plain versions")

    # the free energy: one call, against the float64 structured VMP's
    _, fe_prog = rt.batched_program(
        model, {"y": y}, iterations=iterations, free_energy=True,
        initialization=init, device=device)
    reset_launches()
    _, fe, _ = fe_prog({"y": y})
    torch.cuda.synchronize()
    out["fe_launches"] = read_launches()
    expect_launches(out["fe_launches"], fused_fb_serial_wide=iterations,
                    fused_fb_marg_wide=iterations)
    fe = fe.cpu().numpy()
    out["fe_rel_err"] = _rel(fe[:, rows], fe_want)
    # Past 16 states the float32 FE is coarser than FE_HMM_TOL: at 32 the
    # port's plain version on the CPU misses the float64 FE by 2.6e-4 as
    # well (``scripts/hmm16_conditioning.py --states 32 --categories 32``),
    # so the gap is recorded there, not held.
    fe_held = k <= ffb.HALF_WARP_STATES
    log(f"[{tag}] FE with free_energy=True, rows {rows} last sweep "
        f"{fe[-1, rows].tolist()}: against the float64 structured VMP max "
        f"rel err {out['fe_rel_err']:.3g} ("
        + (f"tol {FE_HMM_TOL})" if fe_held else "recorded, not held: the "
           "float32 FE's own resolution)"))
    if not np.isfinite(fe).all() or (
            fe_held and not out["fe_rel_err"] <= FE_HMM_TOL):
        raise AssertionError(f"{k}-state HMM FE: {out['fe_rel_err']}")
    mark("free energy")

    # the program, then each call alone on the last sweep's inputs, while
    # the SM clock is sampled (the program's calls bring the clock up)
    alphas, _, betas = ffb.fb_serial_wide(lp, elog_a, le_t)
    alone = {
        "fused_fb_serial_wide": lambda: ffb.fb_serial_wide(lp, elog_a, le_t),
        "fused_fb_marg_wide": lambda: ffb.fb_marginals_wide(
            elog_a, le_t, alphas, betas, per_step_xi=True),
        # the beta recursion on its own launch of the serial kernel (the
        # forward one alone is fb_forward's launch)
        "beta_alone": lambda: ffb._serial_cuda(None, elog_a, le_t,
                                               forward=False, beta=True),
        "fused_fb_fwd_wide": lambda: ffb.fb_forward(lp, elog_a, le_t),
        "fused_fb_bwd_wide": lambda: ffb.fb_backward(
            elog_a, le_t, alphas, per_step_xi=True),
    }
    with SmClock() as clk:
        out["program_ms"] = _cuda_ms(lambda: prog({"y": y}), reps)
        out["alone_ms"] = {n: _cuda_ms(fn, 5, inner=3)
                           for n, fn in alone.items()}
    out["sm_clock_mhz"] = clk.mhz
    if beside_first_written:
        new_marg = alone["fused_fb_marg_wide"]
        old_marg = lambda: ffb._marginals_cuda(elog_a, le_t, alphas, betas,
                                               True, first_written=True)
        if not all(torch.equal(x, y) for x, y in zip(new_marg(),
                                                      old_marg())):
            raise AssertionError(f"the {k}-state marginal kernel and "
                                 "fb_wide_marg_kernel differ")
        with SmClock() as clk_old:
            beside = [_cuda_ms(new_marg, 3, inner=3)]
            out["first_written_marg_ms"] = _cuda_ms(old_marg, 3, inner=3)
            beside.append(_cuda_ms(new_marg, 3, inner=3))
        out["marg_ms_beside_first_written"] = beside
        out["first_written_clock_mhz"] = clk_old.mhz
        log(f"[{tag}] fb_wide_marg_kernel on the same inputs "
            f"{out['first_written_marg_ms']:.4f} ms between the marginal "
            f"call's {beside} ms at {clk_old.mhz:.0f} MHz (outputs equal)")
    out["alone_cycles_per_step"] = {
        n: _cycles_per_step(ms, clk.mhz, t_len)
        for n, ms in out["alone_ms"].items()}
    out["marginal_warps_per_sm"] = ffb.wide_marginal_warps_per_sm(device, k)
    out["updates_per_s"] = b * iterations * (t_len + 2) / (
        out["program_ms"] / 1e3)
    out["profile"] = _device_profile(lambda: prog({"y": y}), names, top=8)
    out["cycles_per_step"] = {
        n: _cycles_per_step(row["ms_per_launch"], clk.mhz, t_len)
        for n, row in out["profile"]["kernels"].items()}
    # the program's device time outside the two calls' kernels (the
    # engine's messages: the Dirichlet message over the per-step xi, the
    # evidence, the marginals' moments)
    rows_k = out["profile"]["kernels"].values()
    out["rest_ms"] = "not measured" if isinstance(
        out["profile"]["busy_ms"], str) or any(
        isinstance(r["ms_per_launch"], str) for r in rows_k) else \
        out["profile"]["busy_ms"] - sum(r["ms_per_launch"] * r["launches"]
                                        for r in rows_k)
    out["tile"] = ffb.device_tile(b, t_len, device, k)
    mark("timing and profile")
    busy = out["profile"]["busy_ms"]
    log(f"[{tag}] program {out['program_ms']:.3f} ms/call "
        f"({out['updates_per_s']:.4g} updates/s); device busy {busy} ms per "
        f"call, idle {_idle_share(out['program_ms'], busy)}; in the program "
        f"{out['profile']['kernels']} ({out['cycles_per_step']} cycles a "
        f"step at {clk.mhz:.0f} MHz); top device kernels [name, launches, "
        f"ms] {out['profile'].get('top')}; alone (events) {out['alone_ms']} "
        f"({out['alone_cycles_per_step']} cycles a step); marginal tile "
        f"{out['tile']} ({-(-t_len // out['tile'])} tiles), "
        f"{out['marginal_warps_per_sm']} marginal warps an SM by occupancy "
        f"(the tile rule takes {ffb.marginal_plan(k)['warps_per_sm']}); "
        f"seconds: " + ", ".join(f"{what} {t - t0:.1f}" for (_, t0), (what, t)
                                 in zip(marks, marks[1:])) + f"; {smi}")
    return out


def _ptxas_of(name: str, entry: str) -> dict:
    """The ``ptxas`` lines of the library ``name``'s kernels whose mangled
    name contains ``entry``: the lines, the most registers and the most
    spill bytes among them."""
    import re

    from rxinfer_tpu_torch import kernels

    lines, inside = [], False
    for line in kernels.ptxas_report(name).splitlines():
        if "Compiling entry" in line:
            inside = entry in line
            if inside:
                lines.append(line.strip())
        elif inside and any(k in line for k in ("registers", "spill")):
            lines.append(line.strip())
    text = " ".join(lines)
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
    spills = [int(n) for n in re.findall(
        r"(\d+) bytes spill (?:stores|loads)", text)]
    if not lines:
        raise AssertionError(f"no ptxas lines of {entry} in {name}")
    return {"lines": lines, "registers": max(regs) if regs else None,
            "spill_bytes": max(spills) if spills else None}


def tier_filter_path(device, d: int, smi: str, log=print) -> dict:
    """Phases 26 (a) and 27 (a): path A at d = dy = ``d`` (64 or 128, at
    ``TIER_PATHS[d]``'s B, T) through ``make_sharded_filtering(fused=True)``
    on the warp K3's tensor-core tier past 32 or past 64 (``filter_path``:
    one ``fused_filter_warp`` launch a call, the float64 filter on sampled
    chains, the plain version on the host over the first steps of a few
    chains, the call over three calls after a warm-up, the kernel alone,
    the profile), its device kernel and never the sweep tier's
    ``warp_filter_kernel`` in the call; then the sweep tier
    (``warp_filter_kernel`` on ``sweep_warp_plan``, through its library's
    launcher) at the same shape and inputs, timed between two timings of
    the tier, and the two tiers' outputs against each other; the tier's
    ``ptxas`` registers and spills and its warps an SM."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff

    (b, t_len, plain_steps, plain_chains, tier, entry, lib_name,
     (sweep_reps, sweep_warm)) = TIER_PATHS[d]
    tag = f"filter{d}"
    plan = ff.device_warp_plan(d, device)
    if plan["tier"] != tier:
        raise AssertionError(f"d = {d} plans {plan}, not the tier {tier}")
    out = filter_path(device, b, t_len, d, reps=3, plain_steps=plain_steps,
                      plain_chains=plain_chains, tag=tag, inner=1,
                      warm_sync=True, log=log)
    top = out["profile"].get("top") or []
    if not any(entry in row[0] for row in top) or any(
            "warp_filter_kernel" in row[0] for row in top):
        raise AssertionError(f"path A at d = {d} did not run {entry} alone:"
                             f" {top}")
    # the sweep tier at the same shape, on the same inputs
    f, q, h, r, _, p0_host = lgssm_constants(d)
    w_obs, hr = ff.evidence_operators(h, r)
    fh, qh, hrh, wh = ff._host_params(f, q, hr, w_obs, d, d)
    rng = np.random.default_rng(0)
    ys = torch.as_tensor(rng.standard_normal((t_len, b, d)).astype(
        np.float32), device=device).transpose(1, 2).contiguous()
    m0 = torch.zeros((d, b), device=device)
    p0 = _soa_state(m0.t(), torch.as_tensor(p0_host, device=device).expand(
        (b, d, d)))[1]
    lib = ff._library("fused_filter_warp")
    sweep = ff.sweep_warp_plan(d, ff._smem_optin(device.index or 0))
    dp, stride, chains = (sweep["padded_dim"], sweep["stride"],
                          sweep["chains_per_block"])
    ps = int(sweep["params"] == "shared")
    cs = int(sweep["chain_matrices"] == "shared")
    if not cs:
        raise AssertionError(f"the sweep tier's plan at d = {d}: {sweep}")
    prm = np.zeros((4, dp, stride), np.float32)
    for i, a in enumerate((fh, fh.T, qh, wh)):
        prm[i, :d, :d] = a
    params = torch.as_tensor(prm, device=device)
    hr_t = torch.as_tensor(np.ascontiguousarray(hrh.T), device=device)
    old_out = (torch.empty((t_len, d, b), device=device),
               torch.empty((d, b), device=device), torch.empty_like(p0))
    stream = torch.cuda.current_stream(device).cuda_stream

    def old():
        rc = lib.rxt_warp_filter(
            d, d, ys.data_ptr(), m0.data_ptr(), p0.data_ptr(),
            hr_t.data_ptr(), params.data_ptr(),
            *(o.data_ptr() for o in old_out), None, t_len, b, dp, stride,
            chains, ps, cs, stream)
        if rc:
            raise AssertionError(f"the sweep tier at d = {d}: CUDA error {rc}")

    new = lambda: ff.fused_filter(m0, p0, ys, f, q, hr, w_obs)
    got = new()
    with SmClock() as clk:
        new_ms = [_cuda_ms(new, 3)]
        if sweep_reps:
            old()
            out["sweep_ms"] = _cuda_ms(old, sweep_reps, warmup=sweep_warm)
        else:
            out["sweep_ms"] = _once_ms(old)[1]
        new_ms.append(_cuda_ms(new, 3))
    out["tiers_diff"] = 0.0
    for label, a, c in zip(("means", "final m", "final P"), got, old_out):
        ea, er, ok = _max_err(a.cpu().numpy(), c.cpu().numpy())
        out["tiers_diff"] = max(out["tiers_diff"], ea)
        if not ok:
            raise AssertionError(f"the tier {tier} and the sweep tier "
                                 f"differ at d = {d}, {label}: abs {ea:.3g}")
    out["kernel_ms_beside_sweep"] = new_ms
    out["sweep_clock_mhz"] = clk.mhz
    out["speedup_over_sweep"] = out["sweep_ms"] / min(new_ms)
    out["sweep_plan"] = sweep
    out["ptxas"] = _ptxas_of(lib_name, entry)
    tier_lib = ff._library(lib_name)
    out["warps_per_sm"] = (
        tier_lib.rxt_warp_filter_tc128_blocks_per_sm()
        if lib_name == "fused_filter_tc128"
        else tier_lib.rxt_warp_filter_tc64_blocks_per_sm(d)) \
        * plan["chains_per_block"] * plan["warps_per_chain"]
    out["plan"] = plan
    out["bound"] = _memo(("filter_bound", b, t_len, d, d),
                         lambda: filter_bound(b, t_len, d, d))
    bnd = out["bound"]
    in_call = out["profile"]["kernels"]["fused_filter_warp"]["ms_per_launch"]
    log(f"[{tag}] {entry} alone {out['kernel_ms']:.3f} "
        f"ms, in the call {in_call} ms ({out['cycles_per_step']} cycles a "
        f"step at {out['sm_clock_mhz']:.0f} MHz); beside the sweep tier "
        f"{new_ms} ms against warp_filter_kernel {out['sweep_ms']:.3f} ms at "
        f"{clk.mhz:.0f} MHz: {out['speedup_over_sweep']:.2f}x; the two "
        f"tiers' outputs differ by up to {out['tiers_diff']:.3g}; bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; float32 only "
        f"{bnd['bound_ms_fp32']:.4f}), share "
        f"{100 * bnd['bound_ms'] / out['kernel_ms']:.2f}%; registers "
        f"{out['ptxas']['registers']}, spill bytes "
        f"{out['ptxas']['spill_bytes']}; {out['warps_per_sm']} warps an SM;"
        f" plan {plan}; the sweep's {sweep}; {smi}")
    return out


def slice13_checks(wall0: float) -> tuple[list, dict, bool]:
    """Phase 16 (a) and (c) in a process of their own beside phase 3's: the
    wide K4/K5 at FB_WIDE_CHECK_SHAPES (both ``per_step_xi`` variants,
    xi_sum bit-identical over calls, sampled chains of the first shape
    against the float64 oracle) and the wide K3 at FILTER_WIDE_CHECK_SHAPES
    (sampled chains of the first against the float64 filter).  Returns the
    log lines, each launch key's max error and whether every K4/K5 output
    equalled its plain version's bits."""
    import torch

    device = torch.device("cuda")
    lines: list = []
    worst = check_fb_kernels(device, FB_WIDE_CHECK_SHAPES, log=lines.append,
                             seed=1600)
    bit_equal = worst.pop("bit_equal")
    worst.update(check_filter_kernel(device, FILTER_WIDE_CHECK_SHAPES,
                                     log=lines.append, seed=1650))
    _ended(lines, "wide K3-K5 checks", wall0)
    return lines, worst, bit_equal


def check_warp_tiers(device, shapes, log=print, seed: int = 1750) -> dict:
    """Phase 17 (a) past the shared parameters: the warp K3 at each (B, T,
    d, dy, tier) against the float64 filter on every chain (RTOL / ATOL),
    the plan's (params, chain matrices) placement held to ``tier``, one
    ``fused_filter_warp`` launch a shape.  Returns the max abs error and
    the plans."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff

    worst, plans, failures = 0.0, {}, []
    for i, (bsz, t_len, d, dy, tier) in enumerate(shapes):
        plan = ff.device_warp_plan(d, device)
        plans[f"{bsz}x{t_len}x{d}x{dy}"] = plan
        if (plan["params"], plan["chain_matrices"]) != tier:
            failures.append(f"d = {d} planned {plan}, expected {tier}")
        f, q, h, r = _filter_system(d, dy, seed=seed + i)
        w_obs, hr = ff.evidence_operators(h, r)
        rng = np.random.default_rng(seed + i)
        ys = rng.standard_normal((t_len, dy, bsz)).astype(np.float32)
        m = rng.standard_normal((bsz, d)).astype(np.float32)
        p = np.broadcast_to(9.0 * np.eye(d, dtype=np.float32),
                            (bsz, d, d)).copy()
        m0, p0 = _soa_state(torch.as_tensor(m, device=device),
                            torch.as_tensor(p, device=device))
        before = ff.LAUNCHES["fused_filter_warp"]
        means, mf, pf = ff.fused_filter(
            m0, p0, torch.as_tensor(ys, device=device), f, q, hr, w_obs)
        torch.cuda.synchronize()
        if ff.LAUNCHES["fused_filter_warp"] != before + 1:
            failures.append(f"d = {d}: no fused_filter_warp launch counted")
        o_means, o_m, o_p = filter_float64(m, p, ys.transpose(0, 2, 1), f, q,
                                           h, r)
        errs = {}
        for label, got, want in (
                ("means", means.transpose(1, 2).cpu().numpy(), o_means),
                ("final m", mf.t().cpu().numpy(), o_m),
                ("final P", _unfold_host(pf, d), o_p)):
            ea, er, ok = _max_err(got, want)
            errs[label] = ea
            worst = max(worst, ea)
            if not ok:
                failures.append(f"d = {d} {label}: abs {ea:.3g} rel {er:.3g}")
        log(f"[check] K3 fused_filter_warp (B,T,d,dy)=({bsz},{t_len},{d},"
            f"{dy}) params {plan['params']}, chain matrices "
            f"{plan['chain_matrices']}, {plan['chains_per_block']} chains a "
            f"block, against the float64 filter: "
            + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    if failures:
        raise AssertionError("warp filter tiers: " + "; ".join(failures))
    return {"max_abs_err": worst, "plans": plans}


def tensor_tier_ptxas(lines: list) -> list:
    """The ``ptxas`` lines of the warp K3's tensor-core tier among its
    library's (``Compiling entry``, registers, spills); raises if it spills
    or is missing."""
    import re

    out, inside = [], False
    for line in lines:
        if "Compiling entry" in line:
            inside = "warp_filter_tc_kernel" in line
        elif inside:
            out.append(line)
    spills = [line for line in out if any(
        int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                   line))]
    if not out or spills:
        raise AssertionError("the warp K3's tensor-core tier "
                             + ("spills: " + "; ".join(spills) if out else
                                "has no ptxas lines"))
    return out


def _unfold_host(pf, d: int) -> np.ndarray:
    """A packed (nsym, B) covariance on the card as (B, d, d) on the host."""
    from rxinfer_tpu_torch.ops.fused_smoother import sym_unfold_t

    return sym_unfold_t(pf[None], d)[0].cpu().numpy()


def slice14_checks(wall0: float) -> tuple[list, dict, dict]:
    """Phase 17 (a) in a process of its own beside phase 3's: the warp K3 at
    FILTER_WARP_CHECK_SHAPES against its plain version (sampled chains of
    the first against the float64 filter), each d of these and of
    FILTER_TC64_CHECK_SHAPES on its tier (``slice27_checks`` holds the
    latter), and at FILTER_WARP_TIER_SHAPES against the float64 filter.
    Returns the log lines, the launch key's max error and the tier checks'
    errors and plans (``by_d``: the tier each check shape's d took)."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff

    device = torch.device("cuda")
    lines: list = []
    taken = {d: ff.device_warp_plan(d, device)["tier"]
             for _, _, d, _ in FILTER_WARP_CHECK_SHAPES
             + FILTER_TC64_CHECK_SHAPES}
    if taken != {d: "tensor_cores" if d <= ff.TC_DIM else "tensor_cores_64"
                 if d <= ff.TC64_DIM else "tensor_cores_128"
                 if d <= ff.TC128_DIM else "sweep" for d in taken}:
        raise AssertionError(f"the warp K3's check shapes took the tiers "
                             f"{taken}")
    lines.append(f"[check] K3 fused_filter_warp tiers by d: {taken}")
    worst = check_filter_kernel(device, FILTER_WARP_CHECK_SHAPES,
                                log=lines.append, seed=1700)
    tiers = check_warp_tiers(device, FILTER_WARP_TIER_SHAPES,
                             log=lines.append)
    tiers["by_d"] = taken
    tiers["one_observation"] = check_one_observation_filter(
        device, log=lines.append)
    _ended(lines, "warp K3 checks", wall0)
    return lines, worst, tiers


def filter_plain_rows(b: int, t_len: int, d: int, steps: int,
                      rows: tuple):
    """Path A's plain version at (B, T, d) (``filter_path``'s inputs:
    ``lgssm_constants``, the observations from seed 0) on the host over the
    first ``steps`` steps of the chains ``rows``: its (means, final m, final
    packed P) as arrays, and its host milliseconds."""
    import torch

    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.ops.fused_smoother import sym_fold

    def plain():
        f, q, h, r, _, p0 = lgssm_constants(d)
        w_obs, hr = ff.evidence_operators(h, r)
        ys = np.random.default_rng(0).standard_normal(
            (t_len, b, d)).astype(np.float32)[:steps, list(rows)]
        n = len(rows)
        m0 = torch.zeros((d, n))
        p0 = sym_fold(torch.as_tensor(np.broadcast_to(p0, (n, d, d)).copy())
                      ).contiguous()
        ys_soa = torch.as_tensor(np.ascontiguousarray(ys.transpose(0, 2, 1)))
        t0 = time.perf_counter()
        want = ff.fused_filter_reference(m0, p0, ys_soa, f, q, hr, w_obs)
        ms = (time.perf_counter() - t0) * 1e3
        return [w.numpy() for w in want], ms

    return _memo(("filter_plain", b, t_len, d, steps, tuple(rows)), plain)


def slice27_checks(wall0: float) -> tuple[list, dict, dict]:
    """Phase 17 (a)'s shapes past d = 32 (FILTER_TC64_CHECK_SHAPES: the
    tier past 32 and the first d past it) against the plain version, and
    phase 26 (a)'s plain version on its sampled chains (``filter_plain_
    rows``), in a check process.  Returns the log lines, the launch key's
    max error and the host results for ``_MEMO``."""
    import torch

    device = torch.device("cuda")
    lines: list = []
    worst = check_filter_kernel(device, FILTER_TC64_CHECK_SHAPES,
                                log=lines.append, seed=2700)
    filter_plain_rows(FILTER64_B, FILTER64_T, FILTER64_D,
                      FILTER64_PLAIN_STEPS,
                      tuple(edge_rows(FILTER64_B)[:FILTER64_PLAIN_CHAINS]))
    _ended(lines, "warp K3 checks past d = 32", wall0)
    return lines, worst, dict(_MEMO)


def slice28_checks(wall0: float) -> tuple[list, dict]:
    """Phase 27's host results, in a check process fetched when the phase
    runs: (a)'s plain version on its sampled chains (``filter_plain_rows``:
    about 40 s a step at d = 128 on the host) and its bound (the counts of
    ``filter_bound``, about 10 s), (b)'s float64 VMP (``hmm16_oracle``,
    about 20 s).  Returns the log lines and the host results for
    ``_MEMO``."""
    lines: list = []
    filter_plain_rows(FILTER128_B, FILTER128_T, FILTER128_D,
                      FILTER128_PLAIN_STEPS,
                      tuple(edge_rows(FILTER128_B)[:FILTER128_PLAIN_CHAINS]))
    _memo(("filter_bound",) + (FILTER128_B, FILTER128_T) + (FILTER128_D,) * 2,
          lambda: filter_bound(FILTER128_B, FILTER128_T, FILTER128_D,
                               FILTER128_D))
    hmm16_oracle(HMM64_B, HMM64_T, HMM64_K, HMM64_M, HMM64_IT)
    _ended(lines, "phase 27's host results", wall0)
    return lines, dict(_MEMO)


def _ended(lines: list, what: str, wall0: float) -> None:
    """A check process's ``[time]`` line: when it ended, in seconds since
    the main process's start (``wall0``, its ``time.time()`` then)."""
    lines.append(f"[time] {what} done at {time.time() - wall0:.1f} s (its "
                 "own process)")


def dynamic_checks(wall0: float) -> tuple[list, dict]:
    """Phase 10 (a) in a process of its own beside phase 3's."""
    import torch

    lines: list = []
    worst = check_dynamic_kernels(torch.device("cuda"), DYN_CHECK_SHAPES,
                                  log=lines.append)
    _ended(lines, "dynamic K1/K2 checks", wall0)
    return lines, worst


# Phase 18, ``shared=`` pooling (ROADMAP A7a) and generic mixtures (A4b):
# (a) phase 10 (b)'s ``lgssm_wtau`` cell with its observation precision
# pooled over every chain (one sensor-noise level learned jointly over a
# fleet of trackers), against a float64 pooled VMP over all chains (in the
# check process ``shared_checks``, beside phase 3), sampled chains at
# SHARED_ROWS; (b) the same beyond a device budget set so that it runs
# SHARED_CHUNKS sequential chunks, against (a) at SHARED_CHUNK_TOL relative;
# (c) the pooled process-noise model (``tests/parallel/
# test_infer_batched_shared.py``'s ``hier``, d = 2) at HIER_SHAPE with its
# free energy, and at HIER_SMALL against the port's own program on the CPU
# at HIER_TOL relative; (d) the generic two-component ``Mixture`` over
# MIX_B datasets with log-scale annotations and its free energy, against
# each dataset's float64 closed-form evidence at MIX_TOL.
SHARED_ROWS = (0, 1, WTAU_B // 2, WTAU_B - 1)
SHARED_CHUNKS = 4
SHARED_CHUNK_TOL = 1e-5
HIER_SHAPE, HIER_SMALL, HIER_IT, HIER_D = (1024, 2048), (64, 256), 3, 2
HIER_ROWS = (0, 1, 63)
HIER_TOL = 1e-4
MIX_B, MIX_N, MIX_IT, MIX_TOL = 1000, 20, 3, 1e-4


def pooled_wtau_vmp_float64(b: int, t_len: int, d: int, iterations: int,
                            rows) -> tuple:
    """Mean-field VMP of ``lgssm_wtau`` with Wr POOLED over all b chains,
    float64 numpy (the pooled update needs every chain): the RTS smoother of
    every chain with E[Wr] = nu S, then nu = nu0 + b T, S = (I + sum over
    chains and steps of (y - m)(y - m)^T + P)^-1.  The chains share F, Q,
    P0 and E[Wr], so their covariances are one recursion, ``rts_float64``'s
    on one chain; the means of all chains follow it vectorized over the
    batch.  y is phase 10 (b)'s (seed 11).  Returns the smoothed means of
    ``rows`` (len(rows), T, d), nu and S."""
    f, q, _, _, m0, p0 = lgssm_constants(d)
    f, q, m0, p0 = (np.asarray(a, np.float64) for a in (f, q, m0, p0))
    y = np.random.default_rng(11).standard_normal((b, t_len, d))
    y = y.astype(np.float32).astype(np.float64)
    nu0 = d + 1.0
    nu, s = nu0, np.eye(d)
    mf = np.empty((t_len, b, d))
    for _ in range(iterations):
        ew = nu * s
        _, pf, _, ps = rts_float64(m0[None], p0[None], np.zeros((t_len, 1, d)),
                                   f, np.zeros(d), q, ew, filtered=True)
        pf, ps = pf[:, 0], ps[:, 0]
        xi = y @ ew.T
        m = np.broadcast_to(m0, (b, d))
        for t in range(t_len):
            p_pred = f @ pf[t - 1] @ f.T + q if t else p0
            pred = m @ f.T if t else m
            m = (pred @ np.linalg.inv(p_pred).T + xi[:, t]) @ pf[t].T
            mf[t] = m
        ms = mf.copy()
        for t in range(t_len - 2, -1, -1):
            g = pf[t] @ f.T @ np.linalg.inv(f @ pf[t] @ f.T + q)
            ms[t] = mf[t] + (ms[t + 1] - mf[t] @ f.T) @ g.T
        diff = y - np.moveaxis(ms, 0, 1)
        scatter = np.einsum("bti,btj->ij", diff, diff) + b * ps.sum(0)
        nu = nu0 + b * t_len
        s = np.linalg.inv(np.eye(d) + scatter)
    return np.moveaxis(ms, 0, 1)[list(rows)], nu, s


def hier_model(d: int = HIER_D):
    """``tests/parallel/test_infer_batched_shared.py``'s ``hier``: an LGSSM
    whose process-noise precision W ~ Wishart(d + 1, I), and its
    initialization."""
    import rxinfer_tpu_torch as rt

    a = (0.9 * np.eye(d)).astype(np.float32)
    r = (0.09 * np.eye(d)).astype(np.float32)
    nu0 = float(d) + 1.0
    eye = np.eye(d, dtype=np.float32)

    @rt.model
    def hier(y):
        Tn = len(y)
        W = rt.Wishart(nu0, eye)
        x = rt.latent(Tn, name="x")
        x[0] = rt.MvNormal(mean=np.zeros(d, np.float32), cov=10.0 * eye)
        for t in rt.plate(1, Tn):
            x[t] = rt.MvNormal(mean=a @ x[t - 1], precision=W)
        for t in rt.plate(Tn):
            y[t] = rt.MvNormal(mean=x[t], cov=r)

    return hier, {"W": rt.Wishart(nu0, eye)}


def hier_data(b: int, t_len: int, d: int = HIER_D, seed: int = 2):
    """b chains of ``hier``'s system (W = [[2, .3], [.3, 1.5]]), simulated
    over the batch at once, float32."""
    rng = np.random.default_rng(seed)
    w_true = np.array([[2.0, 0.3], [0.3, 1.5]])
    chol = np.linalg.cholesky(np.linalg.inv(w_true))
    x = np.zeros((b, d))
    ys = np.empty((b, t_len, d), np.float32)
    for t in range(t_len):
        x = 0.9 * x + rng.standard_normal((b, d)) @ chol.T
        ys[:, t] = x + 0.3 * rng.standard_normal((b, d))
    return ys


def _pooled_run(model, init, data, iterations, device, **kw):
    """``infer_batched(shared=)`` of a model's one shared group with the
    free energy: (posteriors, free energy)."""
    import rxinfer_tpu_torch as rt

    res = rt.infer_batched(model, data, iterations=iterations,
                           initialization=init, shared=(next(iter(init)),),
                           free_energy=True, device=device, **kw)
    return res.posteriors, res.free_energy


def shared_checks(wall0: float) -> tuple[list, dict]:
    """Phase 18's host work in a process of its own beside phase 3's: (a)'s
    float64 pooled VMP over every chain, and (c)'s program at HIER_SMALL on
    the CPU (the port's plain versions)."""
    import torch

    lines: list = []
    t0 = time.perf_counter()
    o_m, o_nu, o_s = pooled_wtau_vmp_float64(WTAU_B, WTAU_T, WTAU_D, WTAU_IT,
                                             SHARED_ROWS)
    lines.append(f"[shared check] float64 pooled VMP over {WTAU_B} chains "
                 f"in {time.perf_counter() - t0:.1f} s")
    torch.set_num_threads(1)
    model, init = hier_model()
    posts, fe = _pooled_run(model, init,
                            {"y": hier_data(*HIER_SMALL)}, HIER_IT,
                            torch.device("cpu"))
    out = {"wtau": (o_m, o_nu, o_s),
           "hier_cpu": {"fe": fe.numpy(), "w_s": posts["W"].s[0].numpy(),
                        "w_nu": float(posts["W"].nu[0]),
                        "means": posts["x"].mean()[list(HIER_ROWS)].numpy()}}
    _ended(lines, "phase 18 host checks", wall0)
    return lines, out


def shared_wtau_path(device, host: dict, reps: int, wtau_ms: float,
                     log=print) -> dict:
    """Phase 18 (a) and (b): ``lgssm_wtau`` at phase 10 (b)'s cell with Wr
    pooled: the plan, exactly WTAU_IT per-chain K1 and static K2 launches a
    call, the pooled Wishart (nu = nu0 + B T in every row) and sampled
    chains against the float64 pooled VMP (``host``), the time, one
    profiled call; then the chunked program (SHARED_CHUNKS chunks) against
    it, timed."""
    import warnings

    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.engine.batched import chain_hbm_bytes_per_element

    b, t_len, d, it = WTAU_B, WTAU_T, WTAU_D, WTAU_IT
    model, init = wtau_model(d)
    y = torch.as_tensor(np.random.default_rng(11).standard_normal(
        (b, t_len, d)).astype(np.float32), device=device)
    compiled, prog = rt.batched_program(model, {"y": y}, iterations=it,
                                        initialization=init,
                                        shared=("Wr",), device=device)
    report = compiled.plan_report()["x"]
    log(f"[shared] plan_report {report}")
    if report.get("dynamic") != ["W"]:
        raise AssertionError(f"pooled lgssm_wtau is not on the dynamic W "
                             f"plan: {report}")
    reset_launches()
    state, _, _ = prog({"y": y})
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[shared] launches in one program call: {launches}")
    expect_launches(launches, fused_smoother_fwd_dyn=it,
                    fused_smoother_bwd=it)
    wr, means = state["Wr"], state["x"].mu
    nu = wr.nu.cpu().numpy()
    if not (np.all(nu == nu[0]) and nu[0] == d + 1.0 + b * t_len) \
            or not bool(torch.isfinite(means).all()):
        raise AssertionError(f"the pooled Wishart's nu {nu[:4]} is not "
                             f"nu0 + B T = {d + 1.0 + b * t_len} in every "
                             "row, or the means are not finite")
    o_m, o_nu, o_s = host["wtau"]
    rows = list(SHARED_ROWS)
    s_got = wr.s.cpu().numpy().astype(np.float64)
    errs = {"means": float(np.abs(means[rows].cpu().numpy() - o_m).max()),
            "nu_rel": abs(float(nu[0]) / o_nu - 1.0),
            "scale_rel": float(np.abs(s_got - o_s).max() / np.abs(o_s).max())}
    log(f"[shared] float64 pooled VMP, chains {rows}: {errs} (tol means "
        f"{ORACLE_TOL}, Wishart relative {WISHART_REL_TOL})")
    if errs["means"] > ORACLE_TOL or max(errs["nu_rel"],
                                         errs["scale_rel"]) > WISHART_REL_TOL:
        raise AssertionError(f"pooled lgssm_wtau disagrees with the float64 "
                             f"pooled VMP: {errs}")
    out = {"errs": errs, "launches": launches}
    out["program_ms"] = _cuda_ms(lambda: prog({"y": y}), reps)
    out["updates_per_s"] = it * 3 * t_len * b / (out["program_ms"] / 1e3)
    out["profile"] = _device_profile(lambda: prog({"y": y}), WTAU_NAMES)
    busy = out["profile"]["busy_ms"]
    log(f"[shared] B={b} T={t_len} d={d}, {it} iterations, Wr pooled: "
        f"program {out['program_ms']:.3f} ms/call "
        f"({out['updates_per_s']:.4g} updates/s; unpooled, phase 10 (b): "
        f"{wtau_ms:.3f} ms); device busy {busy} ms per call, idle "
        f"{_idle_share(out['program_ms'], busy)}; in the program "
        f"{out['profile']['kernels']}")

    # (b) the chunked pooled program: a budget of SHARED_CHUNKS chunks
    per_elem = chain_hbm_bytes_per_element(compiled)
    budget = per_elem * (b // SHARED_CHUNKS)
    run = lambda: rt.infer_batched(
        model, {"y": y}, iterations=it, initialization=init, shared=("Wr",),
        options={"hbm_budget_bytes": budget}, device=device)
    reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = run()
    torch.cuda.synchronize()
    out["chunked_launches"] = read_launches()
    if not any(f"chunks of {b // SHARED_CHUNKS}" in str(w.message)
               for w in caught):
        raise AssertionError("the chunked pooled program did not run in "
                             f"chunks of {b // SHARED_CHUNKS}")
    # each chunk's chains every sweep, and once more for the final state
    expect_launches(out["chunked_launches"],
                    fused_smoother_fwd_dyn=SHARED_CHUNKS * (it + 1),
                    fused_smoother_bwd=SHARED_CHUNKS * (it + 1))
    rel = lambda g, w: float((g - w).abs().max() / w.abs().max())
    out["chunked_rel"] = {
        "means": rel(res.posteriors["x"].mu, means),
        "wishart_s": rel(res.posteriors["Wr"].s, wr.s),
        "wishart_nu": rel(res.posteriors["Wr"].nu, wr.nu)}
    if max(out["chunked_rel"].values()) > SHARED_CHUNK_TOL:
        raise AssertionError(f"the chunked pooled program disagrees with the "
                             f"unchunked one: {out['chunked_rel']}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        # the chunked program is built at the first call and kept
        out["chunked_ms"] = statistics.median(
            [_once_ms(run)[1] for _ in range(3)])
    log(f"[shared] chunked, {SHARED_CHUNKS} chunks of {b // SHARED_CHUNKS} "
        f"(budget {budget} bytes): {out['chunked_ms']:.3f} ms/call, launches "
        f"{out['chunked_launches']}; against the unchunked program, relative:"
        f" {out['chunked_rel']} (tol {SHARED_CHUNK_TOL})")
    return out


def shared_hier_path(device, host: dict, reps: int, log=print) -> dict:
    """Phase 18 (c): the pooled process-noise model at HIER_SHAPE with its
    free energy (per-chain Q on K1 and K2; the pooled FE (iterations,),
    non-increasing), and at HIER_SMALL against the port's own program on
    the CPU (``host``): FE, the pooled W and sampled chains at HIER_TOL
    relative."""
    import torch

    model, init = hier_model()
    data = {"y": torch.as_tensor(hier_data(*HIER_SHAPE), device=device)}
    reset_launches()
    posts, fe = _pooled_run(model, init, data, HIER_IT, device)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[hier] launches in one call: {launches}")
    expect_launches(launches, fused_smoother_fwd_dyn=HIER_IT,
                    fused_smoother_bwd_dyn=HIER_IT)
    fe_h = fe.cpu().numpy()
    if fe_h.shape != (HIER_IT,) or not np.isfinite(fe_h).all() or not (
            np.diff(fe_h) <= FE_MONOTONE_TOL * np.abs(fe_h[:-1])).all():
        raise AssertionError(f"the pooled free energy {fe_h} is not a "
                             "finite non-increasing (iterations,) trace")
    nu = posts["W"].nu.cpu().numpy()
    b, t_len = HIER_SHAPE
    if not (np.all(nu == nu[0]) and nu[0] == HIER_D + 1.0 + b * (t_len - 1)):
        raise AssertionError(f"the pooled W's nu {nu[:4]} is not nu0 + "
                             "B (T - 1) in every row")
    out = {"launches": launches, "fe": fe_h.tolist(),
           "ms": _cuda_ms(lambda: _pooled_run(model, init, data, HIER_IT,
                                              device), reps)}
    small = {"y": torch.as_tensor(hier_data(*HIER_SMALL), device=device)}
    posts, fe = _pooled_run(model, init, small, HIER_IT, device)
    cpu = host["hier_cpu"]
    rel = lambda g, w: float(np.abs(g - w).max() / np.abs(w).max())
    out["vs_cpu_rel"] = {
        "fe": rel(fe.cpu().numpy(), cpu["fe"]),
        "w_s": rel(posts["W"].s[0].cpu().numpy(), cpu["w_s"]),
        "w_nu": rel(np.float64(posts["W"].nu[0].item()), cpu["w_nu"]),
        "means": rel(posts["x"].mean()[list(HIER_ROWS)].cpu().numpy(),
                     cpu["means"])}
    log(f"[hier] (B,T)={HIER_SHAPE}, d={HIER_D}, {HIER_IT} iterations, W "
        f"pooled, free energy {fe_h.tolist()}: {out['ms']:.3f} ms/call; at "
        f"(B,T)={HIER_SMALL} against the port's program on the CPU, "
        f"relative: {out['vs_cpu_rel']} (tol {HIER_TOL})")
    if max(out["vs_cpu_rel"].values()) > HIER_TOL:
        raise AssertionError(f"the pooled process-noise model on the card "
                             f"disagrees with the CPU: {out['vs_cpu_rel']}")
    return out


def mixture_path(device, log=print) -> dict:
    """Phase 18 (d): the generic two-component ``Mixture`` of
    ``tests/models/test_generic_mixture.py`` (theta ~ Mixture(selector,
    (Beta(4, 8), Beta(8, 4))), MIX_N Bernoulli observations) over MIX_B
    datasets through ``infer_batched(annotations=LogScaleAnnotations(),
    free_energy=True)``: each dataset's log-scale of theta and -FE against
    its float64 closed-form log-evidence at MIX_TOL; no kernel (plain
    groups); timed once."""
    import torch
    from scipy.special import betaln

    import rxinfer_tpu_torch as rt

    n = MIX_N

    @rt.model
    def mix(y):
        selector = rt.Categorical(np.array([0.5, 0.5], np.float32))
        in1 = rt.Beta(4.0, 8.0)
        in2 = rt.Beta(8.0, 4.0)
        theta = rt.Mixture(selector, (in1, in2))
        for i in rt.plate(n):
            y[i] = rt.Bernoulli(theta)

    beta = lambda a, b: rt.dists.Beta(torch.tensor(a), torch.tensor(b))
    init = {"in1": beta(4.0, 8.0), "in2": beta(8.0, 4.0),
            "theta": beta(1.0, 1.0)}
    rng = np.random.default_rng(23)
    p = rng.uniform(0.1, 0.9, size=(MIX_B, 1))
    ys = (rng.uniform(size=(MIX_B, n)) < p).astype(np.float32)
    run = lambda: rt.infer_batched(
        mix, {"y": ys}, iterations=MIX_IT, initialization=init,
        annotations=rt.LogScaleAnnotations(), free_energy=True,
        device=device)
    reset_launches()
    res = run()
    expect_launches(read_launches())
    ms = _once_ms(run)[1]
    s = ys.sum(1).astype(np.float64)
    lz = lambda a, b: betaln(a + s, b + n - s) - betaln(a, b)
    exact = np.logaddexp(np.log(0.5) + lz(4.0, 8.0),
                         np.log(0.5) + lz(8.0, 4.0))
    errs = {"log_scale": float(np.abs(rt.getlogscale(
                res.posteriors["theta"]).cpu().numpy() - exact).max()),
            "minus_fe": float(np.abs(-res.free_energy[-1].cpu().numpy()
                                     - exact).max())}
    log(f"[mixture] B={MIX_B} datasets of {n} observations, {MIX_IT} "
        f"iterations with annotations and the free energy: {ms:.1f} ms (one "
        f"call); against the float64 closed-form log-evidence: {errs} (tol "
        f"{MIX_TOL})")
    if max(errs.values()) > MIX_TOL:
        raise AssertionError(f"the mixture's evidence disagrees with the "
                             f"closed form: {errs}")
    return {"ms": ms, "errs": errs}


# Phase 19, the autoregressive and HGF chains and the dot-product mean
# (ROADMAP A6a), each on the batch-major scan path (no kernel: the JAX
# package's planner puts these chains on its XLA scans, and so does the
# port's).  (a) ``zoo.latent_ar(LAR_K)`` through ``infer_batched``: LAR_B
# series of LAR_T steps of one stable AR(LAR_K) observed with variance
# LAR_OBS_VAR, LAR_IT sweeps with the free energy, the sampled series
# LAR_ROWS against ``lar_vmp_float64`` (in the check process
# ``slice20_checks`` beside phase 3) at LAR_TOL relative; (b) ``zoo.hgf()``
# over HGF_B datasets of HGF_T steps (``simulate_hgf``, seeded by dataset),
# HGF_IT sweeps, HGF_ROWS against the port's own run of those datasets on
# the CPU (the same check process) at HGF_TOL relative, and on each of them
# the accuracy checks of ``tests/models/test_hgf.py`` that the reference
# meets on these data (``hgf_accuracy``); (c)
# ``zoo.linear_regression(LINREG_D)`` over LINREG_B datasets of LINREG_N
# rows, one sweep, against the float64 closed form (ORACLE_TOL) and its
# -log evidence (FE_LOGZ_TOL).
LAR_B, LAR_T, LAR_K, LAR_IT = 256, 250, 8, 10
LAR_ROWS = (0, 1, LAR_B // 2, LAR_B - 1)
LAR_OBS_VAR = 0.09
LAR_JITTER = 1e-6            # engine/blocks.py ARChainBlock.JITTER
# the AR(8)'s roots: conjugate pairs of modulus LAR_ROOT_MOD, so the
# coefficients stay small and the float32 posterior of theta is well
# conditioned (roots near the unit circle give coefficients near 8, where
# it is not, in both packages)
LAR_ROOT_MOD = (0.3, 0.7)
# twice the JAX package's gap to lar_vmp_float64 on the CPU on the same
# four series, 10 sweeps (``python3 scripts/lar_oracle_gap.py``: its largest
# relative error over the means of s, theta, gamma and the free energy,
# 8.323e-5, the free energy's; never above 1e-3)
LAR_TOL = 1.66e-4
HGF_B, HGF_T, HGF_IT = 256, 500, 20
HGF_ROWS = (0, 1, HGF_B // 2, HGF_B - 1)
HGF_TOL = 1e-3
LINREG_B, LINREG_N, LINREG_D = 1024, 500, 32


def lar_data(b: int, t_len: int, k: int, seed: int):
    """y (b, t_len) float32 from one stable AR(k) (roots of modulus in
    LAR_ROOT_MOD; one real root at odd k), unit innovations, observed with
    variance LAR_OBS_VAR, and its coefficients."""
    rng = np.random.default_rng(seed)
    mod = rng.uniform(*LAR_ROOT_MOD, k // 2)
    ang = rng.uniform(0.2, 2.9, k // 2)
    roots = np.concatenate([mod * np.exp(1j * ang), mod * np.exp(-1j * ang)]
                           + ([rng.uniform(-0.7, 0.7, 1)] if k % 2 else []))
    coef = -np.poly(roots)[1:].real
    x = np.zeros((b, t_len + k))
    for t in range(k, t_len + k):
        x[:, t] = x[:, t - k:t][:, ::-1] @ coef + rng.standard_normal(b)
    y = x[:, k:] + np.sqrt(LAR_OBS_VAR) * rng.standard_normal((b, t_len))
    return y.astype(np.float32), coef


def lar_vmp_float64(y, order: int, iterations: int, obs_var: float = LAR_OBS_VAR):
    """Structured VMP on ``zoo.latent_ar(order)`` in float64 (the port's sweep
    order: s, theta, gamma): a companion-form RTS smoother of the chain given
    E[theta] and E[gamma] (process noise JITTER I + e_1 e_1^T / E[gamma], as
    the chain block's), then theta's and gamma's conjugate updates from the
    pair statistics.  Returns the means of s (n, T, k), theta (n, k) and
    gamma (n,) after the last sweep and the Bethe free energy after every
    sweep (iterations, n): the average energies minus the chain's entropy
    H[s_1] + sum_t (H[out_0, in] - H[in]) (the embedded state's shift rows
    are deterministic) and theta's and gamma's."""
    from scipy.special import digamma, gammaln

    y = np.asarray(y, np.float64)
    n, t_len = y.shape
    k = order
    eye = np.eye(k)
    e1 = eye[0]
    m_th = np.zeros((n, k))
    s_th = np.broadcast_to(eye, (n, k, k)).copy()
    a_g = np.ones(n)
    b_g = np.ones(n)
    l2pi = np.log(2 * np.pi)
    l2pie = np.log(2 * np.pi * np.e)
    fes = []
    for _ in range(iterations):
        eg = a_g / b_g
        f = np.zeros((n, k, k))
        f[:, 0, :] = m_th
        f[:, np.arange(1, k), np.arange(k - 1)] = 1.0
        q = LAR_JITTER * np.broadcast_to(eye, (n, k, k)).copy()
        q[:, 0, 0] += 1.0 / eg
        w = np.outer(e1, e1) / obs_var
        mf = np.empty((t_len, n, k))
        pf = np.empty((t_len, n, k, k))
        m = np.zeros((n, k))
        p = np.broadcast_to(10.0 * eye, (n, k, k)).copy()
        for t in range(t_len):
            if t > 0:
                m = np.einsum("nij,nj->ni", f, m)
                p = f @ p @ np.swapaxes(f, -1, -2) + q
            lam = np.linalg.inv(p)
            p = np.linalg.inv(lam + w)
            m = np.einsum("nij,nj->ni", p, np.einsum("nij,nj->ni", lam, m)
                          + e1 * (y[:, t, None] / obs_var))
            mf[t], pf[t] = m, p
        ms, ps = mf.copy(), pf.copy()
        cross = np.empty((t_len - 1, n, k, k))    # Cov(s_{t+1}, s_t)
        for t in range(t_len - 2, -1, -1):
            p_pred = f @ pf[t] @ np.swapaxes(f, -1, -2) + q
            g = pf[t] @ np.swapaxes(f, -1, -2) @ np.linalg.inv(p_pred)
            ms[t] = mf[t] + np.einsum(
                "nij,nj->ni", g, ms[t + 1] - np.einsum("nij,nj->ni", f, mf[t]))
            ps[t] = pf[t] + g @ (ps[t + 1] - p_pred) @ np.swapaxes(g, -1, -2)
            cross[t] = ps[t + 1] @ np.swapaxes(g, -1, -2)
        m_in, p_in = ms[:-1], ps[:-1]
        m_out, p_out = ms[1:], ps[1:]
        s_in = p_in + m_in[..., :, None] * m_in[..., None, :]
        e_x0s = cross[..., 0, :] + m_out[..., 0:1] * m_in
        e_x0sq = p_out[..., 0, 0] + m_out[..., 0] ** 2
        # theta, at the gamma the sweep started from
        w_th = eye + eg[:, None, None] * s_in.sum(0)
        s_th = np.linalg.inv(w_th)
        m_th = np.einsum("nij,nj->ni", s_th, eg[:, None] * e_x0s.sum(0))
        tt = s_th + m_th[..., :, None] * m_th[..., None, :]
        c2 = (e_x0sq - 2.0 * np.einsum("ni,tni->tn", m_th, e_x0s)
              + np.einsum("nij,tnji->tn", tt, s_in))
        a_g = 1.0 + 0.5 * (t_len - 1)
        a_g = np.full(n, a_g)
        b_g = 1.0 + 0.5 * c2.sum(0)
        eg, elg = a_g / b_g, digamma(a_g) - np.log(b_g)
        ae = (0.5 * (k * l2pi + np.trace(s_th, axis1=-2, axis2=-1)
                     + (m_th ** 2).sum(-1))
              + eg
              + 0.5 * (k * np.log(2 * np.pi * 10.0)
                       + (np.trace(ps[0], axis1=-2, axis2=-1)
                          + (ms[0] ** 2).sum(-1)) / 10.0)
              + (0.5 * (np.log(2 * np.pi * obs_var)
                        + ((y.T - ms[..., 0]) ** 2 + ps[..., 0, 0])
                        / obs_var)).sum(0)
              + (0.5 * (l2pi - elg + eg * c2)).sum(0))
        joint = np.empty((t_len - 1, n, k + 1, k + 1))
        joint[..., :1, :1] = p_out[..., :1, :1]
        joint[..., :1, 1:] = cross[..., :1, :]
        joint[..., 1:, :1] = np.swapaxes(cross[..., :1, :], -1, -2)
        joint[..., 1:, 1:] = p_in
        h_pair = 0.5 * (k + 1) * l2pie + 0.5 * np.linalg.slogdet(joint)[1]
        h_in = 0.5 * k * l2pie + 0.5 * np.linalg.slogdet(p_in)[1]
        h_s = (0.5 * k * l2pie + 0.5 * np.linalg.slogdet(ps[0])[1]
               + (h_pair - h_in).sum(0))
        h_th = 0.5 * k * l2pie + 0.5 * np.linalg.slogdet(s_th)[1]
        h_g = a_g - np.log(b_g) + gammaln(a_g) + (1.0 - a_g) * digamma(a_g)
        fes.append(ae - h_s - h_th - h_g)
    return (np.moveaxis(ms, 0, 1), m_th, a_g / b_g, np.stack(fes))


def simulate_hgf(t_len: int, kappa: float = 1.0, omega: float = -2.0,
                 z_std: float = 0.155, seed: int = 0):
    """``tests/models/test_hgf.py``'s simulator: the volatility walk z, the
    state x and y = x + 0.1 noise."""
    rng = np.random.default_rng(seed)
    z = np.zeros(t_len)
    x = np.zeros(t_len)
    for t in range(1, t_len):
        z[t] = z[t - 1] + z_std * rng.standard_normal()
        x[t] = x[t - 1] + np.exp(0.5 * (kappa * z[t] + omega)) \
            * rng.standard_normal()
    y = x + 0.1 * rng.standard_normal(t_len)
    return z, x, y.astype(np.float32)


def hgf_data(b: int, t_len: int):
    """(z, x, y), each (b, t_len): dataset i simulated with seed i."""
    z, x, y = zip(*(simulate_hgf(t_len, seed=i) for i in range(b)))
    return np.stack(z), np.stack(x), np.stack(y)


def hgf_init():
    import torch

    import rxinfer_tpu_torch as rt

    return {"z": rt.NormalMeanVariance(torch.tensor(0.0),
                                       torch.tensor(5.0))}


def lar_init(k: int):
    import torch

    import rxinfer_tpu_torch as rt

    return {"theta": rt.MvNormalMeanCovariance(torch.zeros(k), torch.eye(k)),
            "gamma": rt.GammaShapeRate(torch.tensor(1.0), torch.tensor(1.0))}


def slice20_checks(wall0: float) -> tuple[list, dict]:
    """Phase 19's host work in a process of its own beside phase 3's: (a)'s
    float64 structured VMP of the sampled series, and (b)'s program on the
    CPU (the port's plain path) over the sampled datasets."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    lines: list = []
    t0 = time.perf_counter()
    y, _ = lar_data(LAR_B, LAR_T, LAR_K, seed=19)
    rows = list(LAR_ROWS)
    o_s, o_th, o_g, o_fe = lar_vmp_float64(y[rows], LAR_K, LAR_IT)
    lines.append(f"[lar check] float64 structured VMP of {len(rows)} series "
                 f"in {time.perf_counter() - t0:.1f} s")
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    _, _, hy = hgf_data(HGF_B, HGF_T)
    res = rt.infer_batched(zoo.hgf(), {"y": hy[list(HGF_ROWS)]},
                           iterations=HGF_IT, initialization=hgf_init(),
                           free_energy=True, device=torch.device("cpu"),
                           options={"warn": False})
    post = res.posteriors
    lines.append(f"[hgf check] the port on the CPU over {len(HGF_ROWS)} "
                 f"datasets in {time.perf_counter() - t0:.1f} s")
    out = {"lar": {"s": o_s, "theta": o_th, "gamma": o_g, "fe": o_fe},
           "hgf": {name: (post[name].mean().numpy(), post[name].var().numpy())
                   for name in ("x", "z")}}
    _ended(lines, "phase 19 host checks", wall0)
    return lines, out


def _rel_max(got, want) -> float:
    """max |got - want| over max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _busy_ms(fn):
    """Device busy ms of one warm ``fn()`` call by ``torch.profiler``: the
    summed duration of its device events (kernels, copies, sets), read
    from the profiler's raw results, since building its event tree for the
    tens of thousands of launches of a scan-path call takes longer than
    the call.  The profiler's first step, whose first device events it
    may lose, is one small launch and is discarded; the recorded step is
    the call.  "not measured" when no device event was recorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not e.name().startswith("ProfilerStep")]
    if not events:
        return "not measured"
    return sum(e.duration_ns() if hasattr(e, "duration_ns")
               else 1e3 * e.duration_us() for e in events) / 1e6


def _scan_cell(device, run, reps: int) -> dict:
    """A phase 19 cell's measurements, its program built beforehand: the
    first call's launches (no kernel may launch), its peak memory above
    what was held before it and its time (CUDA events), the median with
    ``reps`` - 1 more calls, and one profiled call's device busy time
    (``_busy_ms``)."""
    reset_launches()
    (out, ms), peak = _peak_call(device, lambda: _once_ms(run))
    launches = read_launches()
    expect_launches(launches)
    if reps > 1:
        ms = statistics.median([ms] + [_once_ms(run)[1]
                                       for _ in range(reps - 1)])
    busy = _busy_ms(run)
    return {"out": out, "launches": launches, "ms": ms, "busy_ms": busy,
            "idle": _idle_share(ms, busy), "peak_bytes": peak}


def lar_path(device, host: dict, reps: int, smi: str, log=print) -> dict:
    """Phase 19 (a): ``zoo.latent_ar(LAR_K)`` through ``infer_batched`` at
    (LAR_B, LAR_T), LAR_IT sweeps with the free energy; the plan leaves the
    chain on the scans with the JAX planner's reason and launches no
    kernel; the sampled series against the float64 structured VMP
    (``host``) at LAR_TOL; updates/s = 3 T B a sweep."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    y, coef = lar_data(LAR_B, LAR_T, LAR_K, seed=19)
    data = {"y": torch.as_tensor(y, device=device)}
    model, init = zoo.latent_ar(LAR_K), lar_init(LAR_K)
    run = lambda: rt.infer_batched(model, data, iterations=LAR_IT,
                                   initialization=init, free_energy=True,
                                   device=device, options={"warn": False})
    compiled, _ = rt.batched_program(model, data, iterations=LAR_IT,
                                     initialization=init, free_energy=True,
                                     device=device, options={"warn": False})
    want = {"fused": False, "reason": (
        "ARChainBlock has state-dependent transition parameters "
        "(re-assembled every sweep); XLA scan path")}
    if compiled.plan_report()["s"] != want:
        raise AssertionError(f"plan_report()['s'] {compiled.plan_report()}")
    cell = _scan_cell(device, run, reps)
    post, fe = cell["out"]
    rows = list(LAR_ROWS)
    oracle = host["lar"]
    errs = {"s": _rel_max(post["s"].mean()[rows].cpu(), oracle["s"]),
            "theta": _rel_max(post["theta"].mean()[rows].cpu(),
                              oracle["theta"]),
            "gamma": _rel_max(post["gamma"].mean()[rows].cpu(),
                              oracle["gamma"]),
            "fe": _rel_max(fe[:, rows].cpu(), oracle["fe"])}
    fe_h = fe.cpu().numpy()
    ups = 3.0 * LAR_T * LAR_B * LAR_IT / (cell["ms"] / 1e3)
    log(f"[lar] zoo.latent_ar({LAR_K}) (B,T)=({LAR_B},{LAR_T}), {LAR_IT} "
        f"sweeps with FE: call_ms {cell['ms']:.3f} updates_per_s {ups:.6g} "
        f"busy_ms {cell['busy_ms']} idle {cell['idle']} peak_gb "
        f"{cell['peak_bytes'] / 1e9:.3f}; against the float64 VMP on rows "
        f"{rows}, relative: {errs} (tol {LAR_TOL}); launches none; {smi}")
    bad = {k: v for k, v in errs.items() if not v <= LAR_TOL}
    if bad or not np.isfinite(fe_h).all():
        raise AssertionError(f"latent AR on the card: {bad or 'FE not finite'}")
    return {"ms": cell["ms"], "updates_per_s": ups,
            "busy_ms": cell["busy_ms"], "idle": cell["idle"],
            "peak_gb": cell["peak_bytes"] / 1e9, "errs": errs,
            "coef": coef.tolist()}


def hgf_accuracy(z_true, x_true, qx, qz) -> dict:
    """``tests/models/test_hgf.py``'s accuracy measures of one dataset and
    whether the ones the reference meets on these data hold (``ok``):
    median |x error| < 0.15, x within 6 sd everywhere and within 3 sd at
    more than 95% of the steps, corr(z) > 0.55, positive variances.  The z
    envelopes (within 6 sd everywhere, within 3 sd at more than 95%) are
    measured, not gated: over 500 steps with the model's z step variance
    0.01 below the simulator's 0.155^2, the JAX package's posterior of z
    misses them on three of the four sampled datasets as the port's does
    (z within 3 sd at 0.608 of the steps of dataset 1, the same in both on
    a CPU); ``hgf_path`` holds them equal to the port's CPU run instead."""
    mx, vx = qx
    mz, vz = qz
    sx, sz = np.sqrt(vx), np.sqrt(vz)
    vals = {"median_x_err": float(np.median(np.abs(mx - x_true))),
            "x_in_6sd": bool(np.all(np.abs(x_true - mx) < 6.0 * sx)),
            "x_in_3sd": float(np.mean(np.abs(x_true - mx) < 3.0 * sx)),
            "corr_z": float(np.corrcoef(mz[10:], z_true[10:])[0, 1]),
            "z_in_6sd": bool(np.all(np.abs(z_true - mz) < 6.0 * sz)),
            "z_in_3sd": float(np.mean(np.abs(z_true - mz) < 3.0 * sz))}
    ok = (vals["median_x_err"] < 0.15 and vals["x_in_6sd"]
          and vals["x_in_3sd"] > 0.95 and vals["corr_z"] > 0.55
          and bool(np.all(sx > 0) and np.all(sz > 0)))
    return {"ok": ok, **vals}


def hgf_path(device, host: dict, reps: int, smi: str, log=print) -> dict:
    """Phase 19 (b): ``zoo.hgf()`` through ``infer_batched`` at (HGF_B,
    HGF_T), HGF_IT sweeps with the free energy from z ~ N(0, 5): both chains
    on the scans with the JAX planner's reasons, no kernel; the sampled
    datasets against the port's run of them on the CPU (``host``) at
    HGF_TOL relative and the accuracy checks on each; every free energy
    finite; updates/s = 3 T B a sweep."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    z_true, x_true, y = hgf_data(HGF_B, HGF_T)
    data = {"y": torch.as_tensor(y, device=device)}
    model, init = zoo.hgf(), hgf_init()
    run = lambda: rt.infer_batched(model, data, iterations=HGF_IT,
                                   initialization=init, free_energy=True,
                                   device=device, options={"warn": False})
    compiled, _ = rt.batched_program(model, data, iterations=HGF_IT,
                                     initialization=init, free_energy=True,
                                     device=device, options={"warn": False})
    want = {"x": {"fused": False, "reason": (
                "GCVChainBlock has state-dependent transition parameters "
                "(re-assembled every sweep); XLA scan path")},
            "z": {"fused": False, "reason": (
                "evidence factor GCV reads the chain's own marginal "
                "(state-dependent message)")}}
    if compiled.plan_report() != want:
        raise AssertionError(f"plan_report() {compiled.plan_report()}")
    cell = _scan_cell(device, run, reps)
    post, fe = cell["out"]
    rows = list(HGF_ROWS)
    got = {name: (post[name].mean()[rows].cpu().numpy(),
                  post[name].var()[rows].cpu().numpy())
           for name in ("x", "z")}
    errs = {f"{name}_{what}": _rel_max(got[name][i], host["hgf"][name][i])
            for name in ("x", "z") for i, what in enumerate(("mean", "var"))}
    acc = [hgf_accuracy(z_true[r], x_true[r],
                        (got["x"][0][i], got["x"][1][i]),
                        (got["z"][0][i], got["z"][1][i]))
           for i, r in enumerate(rows)]
    # the z envelopes, as many steps inside on the card as on the CPU
    cpu_acc = [hgf_accuracy(z_true[r], x_true[r],
                            tuple(a[i] for a in host["hgf"]["x"]),
                            tuple(a[i] for a in host["hgf"]["z"]))
               for i, r in enumerate(rows)]
    z_same = all(a[k] == c[k] for a, c in zip(acc, cpu_acc)
                 for k in ("z_in_6sd", "z_in_3sd"))
    fe_h = fe.cpu().numpy()
    ups = 3.0 * HGF_T * HGF_B * HGF_IT / (cell["ms"] / 1e3)
    log(f"[hgf] zoo.hgf() (B,T)=({HGF_B},{HGF_T}), {HGF_IT} sweeps with FE: "
        f"call_ms {cell['ms']:.3f} updates_per_s {ups:.6g} busy_ms "
        f"{cell['busy_ms']} idle {cell['idle']} peak_gb "
        f"{cell['peak_bytes'] / 1e9:.3f}; against the port on the CPU on "
        f"rows {rows}, relative: {errs} (tol {HGF_TOL}); accuracy "
        f"(median |x err| < 0.15, 6 sd, 3 sd > 0.95, corr(z) > 0.55): "
        f"{acc}, z envelopes equal to the CPU run's: {z_same}; launches "
        f"none; {smi}")
    if max(errs.values()) > HGF_TOL or not all(a["ok"] for a in acc) \
            or not z_same or not np.isfinite(fe_h).all():
        raise AssertionError(f"the HGF on the card: {errs}, {acc}, z "
                             f"envelopes as on the CPU {z_same}, FE finite "
                             f"{np.isfinite(fe_h).all()}")
    return {"ms": cell["ms"], "updates_per_s": ups,
            "busy_ms": cell["busy_ms"], "idle": cell["idle"],
            "peak_gb": cell["peak_bytes"] / 1e9, "errs": errs,
            "accuracy": acc}


def linreg_closed_form(phi, y, prior_var: float = 100.0,
                       noise_var: float = 1.0):
    """The float64 posterior of theta (means (B, d), covariances (B, d, d))
    and -log p(y) (B,) of ``zoo.linear_regression``."""
    phi = np.asarray(phi, np.float64)
    y = np.asarray(y, np.float64)
    n, d = phi.shape[-2:]
    gram = np.swapaxes(phi, -1, -2) @ phi / noise_var
    prec = gram + np.eye(d) / prior_var
    cov = np.linalg.inv(prec)
    rhs = np.einsum("bnd,bn->bd", phi, y) / noise_var
    mean = np.einsum("bij,bj->bi", cov, rhs)
    # log det(noise I + prior Phi Phi^T) by the determinant lemma
    logdet = (n * np.log(noise_var)
              + np.linalg.slogdet(np.eye(d) + prior_var * gram)[1])
    quad = (np.einsum("bn,bn->b", y, y) / noise_var
            - np.einsum("bd,bd->b", rhs, mean))
    return mean, cov, 0.5 * (n * np.log(2 * np.pi) + logdet + quad)


def linreg_path(device, reps: int, smi: str, log=print) -> dict:
    """Phase 19 (c): ``zoo.linear_regression(LINREG_D)`` through
    ``infer_batched`` over LINREG_B datasets of LINREG_N rows, one sweep
    with the free energy: theta's posterior against the float64 closed form
    (ORACLE_TOL, relative to the largest value) and the free energy against
    the closed-form -log evidence (FE_LOGZ_TOL relative); no kernel;
    updates/s = B N a call."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    rng = np.random.default_rng(20)
    phi = rng.standard_normal((LINREG_B, LINREG_N, LINREG_D)).astype(
        np.float32)
    w = rng.standard_normal((LINREG_B, LINREG_D))
    y = (np.einsum("bnd,bd->bn", phi, w)
         + rng.standard_normal((LINREG_B, LINREG_N))).astype(np.float32)
    data = {"phi": torch.as_tensor(phi, device=device),
            "y": torch.as_tensor(y, device=device)}
    model = zoo.linear_regression(LINREG_D)
    run = lambda: rt.infer_batched(model, data, free_energy=True,
                                   device=device)
    rt.batched_program(model, data, free_energy=True, device=device)
    cell = _scan_cell(device, run, reps)
    post, fe = cell["out"]
    mean, cov, nlz = linreg_closed_form(phi, y)
    errs = {"theta_mean": _rel_max(post["theta"].mean().cpu(), mean),
            "theta_cov": _rel_max(post["theta"].cov().cpu(), cov),
            "fe": float(np.max(np.abs(fe[-1].cpu().numpy() - nlz)
                               / np.abs(nlz)))}
    tol = {"theta_mean": ORACLE_TOL, "theta_cov": ORACLE_TOL,
           "fe": FE_LOGZ_TOL}
    ups = LINREG_B * LINREG_N / (cell["ms"] / 1e3)
    log(f"[linreg] zoo.linear_regression({LINREG_D}) B={LINREG_B} datasets "
        f"of N={LINREG_N}, 1 sweep with FE: call_ms {cell['ms']:.3f} "
        f"updates_per_s {ups:.6g} busy_ms {cell['busy_ms']} idle "
        f"{cell['idle']} peak_gb {cell['peak_bytes'] / 1e9:.3f}; against the "
        f"float64 closed form: {errs} (tol {tol}); launches none; {smi}")
    bad = {k: v for k, v in errs.items() if not v <= tol[k]}
    if bad:
        raise AssertionError(f"linear regression on the card: {bad}")
    return {"ms": cell["ms"], "updates_per_s": ups,
            "busy_ms": cell["busy_ms"], "idle": cell["idle"],
            "peak_gb": cell["peak_bytes"] / 1e9, "errs": errs}


# -- slice 21: the nonlinear nodes (A6b) and matmul_precision (A6g(i)) ----------

RB_B, RB_T, RB_IT = 1024, 1000, 10
RB_DT, RB_Q = 0.1, 0.1
RB_R = (0.01, 1e-4)              # range (m^2), bearing (rad^2) variances
RB_LIN_R = 0.01                  # (a0): positions observed, m^2
RB_ROWS = (0, 1, 2, 3, 511, 512, 1022, 1023)
RB_ORACLE_ROWS = (0, 1, 512, 1023)
# (a1): the card against the port on the CPU over the sampled tracks,
# relative to the largest value (means, variances, free energy)
RB_TOL = 1e-3
# (a0): means against the float64 RTS; covariances at the scan smoother's
# own float32 gap on this fleet, at slot 0's velocity variance (4.5e-4 of
# the largest covariance on a CPU, the same for the chain written as
# H @ x[t]; tests/test_torch_delta.py SCAN_COV_TOL)
RB_ORACLE_TOL = {"means": 1e-4, "covs": 1e-3}
# the unscented fleet runs alpha = 1: at the default 1e-3 the sigma-point
# weights (about 1e5) amplify float32 rounding at these ranges past every
# digit, in the JAX package too (ROADMAP C11)
RB_UNSCENTED_ALPHA = 1.0
PROBIT_B, PROBIT_N, PROBIT_IT = 1024, 500, 20
SOFTDOT_B, SOFTDOT_N, SOFTDOT_D, SOFTDOT_IT = 1024, 300, 2, 20
GLM_ROWS = (0, 1, 2, 3, 511, 512, 1022, 1023)
CVI_B, CVI_T, CVI_SAMPLES, CVI_IT = 256, 50, 600, 150
CVI_ROWS = (0, 1, 128, 255)
CVI_SENSOR, CVI_P_VAR, CVI_S_VAR = 53.0, 5.0, 5.0
# the card against the port on the CPU with the same draws, each of the
# first CVI_CHECK_IT sweeps (measured at up to 7.9e-6 on an H100 80GB HBM3
# at 700 W).  Later some datasets settle into a two-sweep cycle (dataset
# 128's free energy alternates between 334.9 and 336.1; the JAX package
# cycles there too, ``tests/test_torch_nonlinear_nodes.py``), whose phase
# float32 rounding decides, and some converge so slowly that one rounding
# moves their last sweep (a one-ulp change of dataset 0's observations
# moved its z variances by 2.7e-2 after 150 sweeps, on the CPU with an
# H100's draws).  So the last
# sweeps are held by the average of the last two, the cycle's invariant,
# within CVI_TOL or CVI_ULP_FACTOR times the most that a one-ulp change
# of the observations, up or down, moves that average on the CPU,
# whichever is larger, dataset by dataset.
CVI_CHECK_IT = 30
CVI_TOL = 1e-4
CVI_ULP_FACTOR = 10.0
STRICT_TOL = 1e-5


def rb_constants():
    """F, Q (white acceleration), the prior and the range-bearing noise of
    phase 20's constant-velocity fleet."""
    dt, q = RB_DT, RB_Q
    i2, z2 = np.eye(2), np.zeros((2, 2))
    f = np.block([[i2, dt * i2], [z2, i2]]).astype(np.float32)
    qm = (q * np.block([[dt ** 3 / 3 * i2, dt ** 2 / 2 * i2],
                        [dt ** 2 / 2 * i2, dt * i2]])).astype(np.float32)
    m0 = np.array([35.0, 0.0, 0.0, 0.0], np.float32)
    p0 = np.diag([225.0, 225.0, 1.0, 1.0]).astype(np.float32)
    return f, qm, m0, p0


def rb_tracks(b: int, t_len: int, seed: int, linear: bool = False):
    """Constant-velocity tracks starting 20-50 m from the sensor at the
    origin within +-0.6 rad of the x axis and receding from it at 5-10 m/s
    (a cross-track speed of N(0, 0.5^2)), and their observations: range and
    bearing, or (``linear``) the position.  A track that drifts behind the
    sensor crosses the bearing's +-pi cut, and one that passes by it the
    origin's singularity, where a Gaussian range-bearing likelihood cannot
    follow it in either package; under the white-acceleration noise over
    100 s the receding tracks keep 20 m and 1.9 rad clear of both."""
    f, q, _, _ = rb_constants()
    rng = np.random.default_rng(seed)
    r0 = rng.uniform(20.0, 50.0, b)
    a0 = rng.uniform(-0.6, 0.6, b)
    speed = rng.uniform(5.0, 10.0, b)
    cross = 0.5 * rng.standard_normal(b)
    x = np.stack([r0 * np.cos(a0), r0 * np.sin(a0),
                  speed * np.cos(a0) - cross * np.sin(a0),
                  speed * np.sin(a0) + cross * np.cos(a0)], -1)
    lq = np.linalg.cholesky(q.astype(np.float64))
    xs = np.empty((b, t_len, 4))
    for t in range(t_len):
        if t:
            x = x @ f.T.astype(np.float64) + rng.standard_normal((b, 4)) @ lq.T
        xs[:, t] = x
    e = rng.standard_normal((b, t_len, 2))
    if linear:
        y = xs[..., :2] + np.sqrt(RB_LIN_R) * e
    else:
        y = np.stack([np.hypot(xs[..., 0], xs[..., 1]),
                      np.arctan2(xs[..., 1], xs[..., 0])], -1) \
            + np.sqrt(np.array(RB_R)) * e
    return xs, y.astype(np.float32)


def rb_fn(x):
    """Range and bearing of the position from the sensor at the origin."""
    import torch

    return torch.stack([torch.sqrt(x[0] * x[0] + x[1] * x[1]),
                        torch.atan2(x[1], x[0])])


def rb_lin_fn(x):
    """The position: a linear delta (H = [I 0])."""
    import torch

    return torch.stack([x[0], x[1]])


def rb_model(fn, method, t_len: int, r):
    import rxinfer_tpu_torch as rt

    f, q, m0, p0 = rb_constants()

    @rt.model
    def tracker(y):
        x = rt.latent(t_len, name="x")
        x[0] = rt.MvNormal(mean=m0, cov=p0)
        for t in rt.plate(1, t_len):
            x[t] = rt.MvNormal(mean=f @ x[t - 1], cov=q)
        for t in rt.plate(t_len):
            y[t] = rt.MvNormal(mean=rt.Delta(fn, x[t], method=method), cov=r)
        return {"x": x}

    return tracker


def rb_init():
    import torch

    import rxinfer_tpu_torch as rt

    _, _, m0, p0 = rb_constants()
    return {"x": rt.MvNormalMeanCovariance(torch.as_tensor(m0),
                                           torch.as_tensor(p0))}


def rb_method(kind: str):
    from rxinfer_tpu_torch.rules import delta

    return (delta.Linearization() if kind == "linearization"
            else delta.Unscented(alpha=RB_UNSCENTED_ALPHA))


def rb_rts_float64(y, r):
    """The float64 RTS smoother of the linear fleet's rows: means and
    covariances (rows, T, 4[, 4])."""
    f, q, m0, p0 = (a.astype(np.float64) for a in rb_constants())
    h = np.hstack([np.eye(2), np.zeros((2, 2))])
    means, covs = [], []
    for yb in np.asarray(y, np.float64):
        m, p = m0, p0
        ms, ps, mp, pp = [], [], [], []
        for t in range(len(yb)):
            if t:
                m, p = f @ m, f @ p @ f.T + q
            mp.append(m)
            pp.append(p)
            s = h @ p @ h.T + r
            k = p @ h.T @ np.linalg.inv(s)
            m, p = m + k @ (yb[t] - h @ m), p - k @ s @ k.T
            ms.append(m)
            ps.append(p)
        sm, sp = [ms[-1]], [ps[-1]]
        for t in range(len(yb) - 2, -1, -1):
            g = ps[t] @ f.T @ np.linalg.inv(pp[t + 1])
            sm.append(ms[t] + g @ (sm[-1] - mp[t + 1]))
            sp.append(ps[t] + g @ (sp[-1] - pp[t + 1]) @ g.T)
        means.append(sm[::-1])
        covs.append(sp[::-1])
    return np.array(means), np.array(covs)


def probit_model(n: int):
    import rxinfer_tpu_torch as rt

    @rt.model
    def probit(y):
        x = rt.Normal(mean=0.0, var=10.0)
        for i in rt.plate(n):
            y[i] = rt.Probit(x)
        return {"x": x}

    return probit


def probit_data(b: int, n: int, seed: int = 21):
    """``tests/models/test_probit_mixtures.py``'s data, one conversion rate
    Phi(x) per dataset around Phi(0.8)."""
    from math import erf

    rng = np.random.default_rng(seed)
    x = 0.8 + 0.3 * rng.standard_normal(b)
    p = 0.5 * (1.0 + np.vectorize(erf)(x / np.sqrt(2.0)))
    return (rng.uniform(size=(b, n)) < p[:, None]).astype(np.float32)


def softdot_model(n: int, d: int):
    import rxinfer_tpu_torch as rt

    @rt.model
    def softdot(phi, y):
        theta = rt.MvNormal(mean=np.zeros(d, np.float32),
                            cov=10.0 * np.eye(d, dtype=np.float32))
        g = rt.Gamma(shape=1.0, rate=1.0)
        for i in rt.plate(n):
            y[i] = rt.SoftDot(theta, phi[i], g)
        return {"theta": theta, "g": g}

    return softdot


def softdot_data(b: int, n: int, d: int):
    """``tests/models/test_misc_nodes.py``'s regression, theta = (1, -0.5),
    noise 0.1, dataset i from seed 1 + i (dataset 0 is the test's own)."""
    phi, y = [], []
    for i in range(b):
        rng = np.random.default_rng(1 + i)
        phi.append(rng.standard_normal((n, d)))
        y.append(phi[-1] @ np.array([1.0, -0.5])
                 + 0.1 * rng.standard_normal(n))
    return np.array(phi, np.float32), np.array(y, np.float32)


def glm_init(which: str):
    import torch

    import rxinfer_tpu_torch as rt

    if which == "probit":
        return {"x": rt.NormalMeanVariance(torch.tensor(0.0),
                                           torch.tensor(10.0))}
    return {"theta": rt.MvNormalMeanCovariance(
                torch.zeros(SOFTDOT_D), 10.0 * torch.eye(SOFTDOT_D)),
            "g": rt.GammaShapeRate(torch.tensor(1.0), torch.tensor(1.0))}


def cvi_model(t_len: int, n_samples: int):
    import rxinfer_tpu_torch as rt

    method = rt.CVIProjection(n_samples=n_samples, seed=7)

    def sensor(z):
        return (z - CVI_SENSOR) ** 2

    @rt.model
    def nonlinear_dynamics(y):
        tau = rt.Gamma(shape=0.01, rate=0.01)
        theta = rt.Gamma(shape=0.01, rate=0.01)
        z = rt.latent(t_len, name="z")
        x = rt.latent(t_len, name="x")
        z[0] = rt.Normal(mean=0.0, precision=tau)
        for t in rt.plate(1, t_len):
            z[t] = rt.Normal(mean=z[t - 1] + 1.0, precision=tau)
        for t in rt.plate(t_len):
            x[t] = rt.Delta(sensor, z[t], method=method)
        for t in rt.plate(t_len):
            y[t] = rt.Normal(mean=x[t], precision=theta)
        return {"z": z, "x": x, "tau": tau, "theta": theta}

    return nonlinear_dynamics


def cvi_data(b: int, t_len: int):
    """``tests/models/test_cvi_dynamics.py``'s simulation, dataset i from
    seed 42 + i (dataset 0 is the test's own): (hidden, data,
    observations)."""
    hidden = np.arange(1, t_len + 1, dtype=np.float64)
    data, y = [], []
    for i in range(b):
        rng = np.random.default_rng(42 + i)
        data.append(hidden + np.sqrt(CVI_P_VAR) * rng.standard_normal(t_len))
        y.append((data[-1] - CVI_SENSOR) ** 2
                 + np.sqrt(CVI_S_VAR) * rng.standard_normal(t_len))
    return hidden, np.array(data), np.array(y, np.float32)


def cvi_init():
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.graph.constraints import InitMessage

    t = torch.tensor
    return {"z": InitMessage(rt.NormalMeanVariance(t(0.0), t(CVI_P_VAR))),
            "x": rt.NormalMeanVariance(t(0.0), t(100.0)),
            "tau": rt.GammaShapeRate(t(1e-12), t(1e-3)),
            "theta": rt.GammaShapeRate(t(1e-12), t(1e-3))}


def cvi_card_draws():
    """The card's CVIProjection draws (``standard_normal_draws`` on the
    CUDA device), as the CPU run must use them."""
    import torch

    from rxinfer_tpu_torch.rules import delta

    params = delta.CVIProjection(n_samples=CVI_SAMPLES, seed=7)
    return delta.standard_normal_draws(params, 1, torch.float32,
                                       torch.device("cuda")).cpu()


def cvi_sweeps(post, fe, rows=None) -> dict:
    """z's means and variances at every sweep ((sweeps, datasets, T)) and
    the free energies ((sweeps, datasets)) of a ``KeepEach`` run, on the
    host, of ``rows`` when given."""
    import torch

    take = (lambda a: a) if rows is None else (lambda a: a[..., rows, :])
    return {"mean": take(torch.stack([q.mean() for q in post["z"]])).cpu()
            .numpy(),
            "var": take(torch.stack([q.var() for q in post["z"]])).cpu()
            .numpy(),
            "fe": (fe.cpu().numpy() if rows is None
                   else fe[:, rows].cpu().numpy())}


def cvi_tail_errs(card: dict, cpu: dict, ulps: list) -> dict:
    """The card's average of the last two sweeps against the CPU's,
    dataset by dataset and quantity by quantity (relative), beside the
    tolerance: CVI_TOL or CVI_ULP_FACTOR times the most that a one-ulp
    change of the observations up or down (``ulps``, the CPU's runs of
    them) moves the CPU's average, whichever is larger."""
    last2 = lambda a: 0.5 * (a[-1] + a[-2])
    errs = {}
    for name in ("mean", "var", "fe"):
        got, want = last2(card[name]), last2(cpu[name])
        moved = [last2(ulp[name]) for ulp in ulps]
        errs[name] = [(_rel_max(got[j], want[j]), max(
            CVI_TOL, CVI_ULP_FACTOR * max(_rel_max(m[j], want[j])
                                          for m in moved)))
            for j in range(len(want))]
    return errs


def _pairs(errs: dict) -> str:
    return "; ".join(f"{name} " + ", ".join(f"({e:.3g}, {tol:.3g})"
                                            for e, tol in v)
                     for name, v in errs.items())


def cvi_accuracy(hidden, data, mz, vz, tau, theta, fe) -> dict:
    """``tests/models/test_cvi_dynamics.py``'s checks of one dataset; the
    free-energy ones on the port's values in the JAX package's convention
    (plus (T - 1) H[q(tau)], ROADMAP C6) as the reference test reads them:
    ``fe_c6`` is that sum's trace."""
    sz = np.sqrt(vz)
    vals = {"rmse_data": float(np.sqrt(np.mean((data - mz) ** 2))),
            "in_6sd": bool(np.all(np.abs(data - mz) < 6.0 * sz)),
            "in_3sd": float(np.mean(np.abs(data - mz) < 3.0 * sz)),
            "rmse_hidden": float(np.sqrt(np.mean((hidden - mz) ** 2))),
            "tau": float(tau), "theta": float(theta),
            "fe_tail": float(abs(fe[-1] - fe[-5])),
            "fe_max_rise": float(np.diff(fe)[10:].max())}
    ok = (vals["rmse_data"] < 0.5 and vals["in_6sd"] and vals["in_3sd"] > 0.9
          and vals["rmse_hidden"] < 2.5 and 0.05 < vals["tau"] < 0.6
          and 0.005 < vals["theta"] < 0.2 and bool(np.all(sz > 0))
          and bool(np.isfinite(fe[1:]).all()) and vals["fe_max_rise"] < 3.0
          and fe[1] - fe[-1] > 0 and vals["fe_tail"] < 0.1)
    return {"ok": ok, **vals}


def slice21_checks(wall0: float) -> tuple[list, dict]:
    """Phase 20's host work in a process of its own beside phase 3's: the
    port on the CPU over the sampled tracks (both methods), datasets and
    CVI paths (with the card's draws), and the float64 RTS of the linear
    fleet's sampled rows."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.rules import delta

    lines: list = []
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    out: dict = {}
    t0 = time.perf_counter()
    _, yl = rb_tracks(RB_B, RB_T, seed=30, linear=True)
    out["rts"] = rb_rts_float64(yl[list(RB_ORACLE_ROWS)],
                                RB_LIN_R * np.eye(2))
    _, y = rb_tracks(RB_B, RB_T, seed=31)
    r = np.diag(RB_R).astype(np.float32)
    for kind in ("linearization", "unscented"):
        post, fe = rt.infer_batched(
            rb_model(rb_fn, rb_method(kind), RB_T, r),
            {"y": y[list(RB_ROWS)]}, iterations=RB_IT, free_energy=True,
            initialization=rb_init(), device=cpu, options={"warn": False})
        out[kind] = {"mean": post["x"].mean().numpy(),
                     "var": post["x"].var().numpy(), "fe": fe.numpy()}
    lines.append(f"[nl check] the trackers on the CPU over {len(RB_ROWS)} "
                 f"tracks and the float64 RTS in "
                 f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows = list(GLM_ROWS)
    post, fe = rt.infer_batched(
        probit_model(PROBIT_N), {"y": probit_data(PROBIT_B, PROBIT_N)[rows]},
        iterations=PROBIT_IT, initialization=glm_init("probit"),
        free_energy=True, device=cpu)
    out["probit"] = {"mean": post["x"].mean().numpy(),
                     "var": post["x"].var().numpy(), "fe": fe.numpy()}
    phi, ys = softdot_data(SOFTDOT_B, SOFTDOT_N, SOFTDOT_D)
    post, fe = rt.infer_batched(
        softdot_model(SOFTDOT_N, SOFTDOT_D), {"phi": phi[rows], "y": ys[rows]},
        iterations=SOFTDOT_IT, initialization=glm_init("softdot"),
        free_energy=True, device=cpu)
    out["softdot"] = {"theta": post["theta"].mean().numpy(),
                      "g": post["g"].mean().numpy(), "fe": fe.numpy()}
    draws = cvi_card_draws()
    delta.standard_normal_draws = lambda params, n, dtype, device: \
        draws.to(dtype=dtype, device=device)
    _, _, yc = cvi_data(CVI_B, CVI_T)
    yc = yc[list(CVI_ROWS)]
    out["cvi_ulp"] = []
    for y_cvi in (yc, np.nextafter(yc, np.float32(np.inf)),
                  np.nextafter(yc, np.float32(-np.inf))):
        post, fe = rt.infer_batched(
            cvi_model(CVI_T, CVI_SAMPLES), {"y": y_cvi}, iterations=CVI_IT,
            initialization=cvi_init(), free_energy=True, device=cpu,
            returnvars=rt.KeepEach(), options={"warn": False})
        out["cvi_ulp"].append(cvi_sweeps(post, fe))
    out["cvi"] = out["cvi_ulp"].pop(0)
    lines.append(f"[nl check] probit, SoftDot and CVI on the CPU in "
                 f"{time.perf_counter() - t0:.1f} s")
    _ended(lines, "phase 20 host checks", wall0)
    return lines, out


def _busy_and_kernels(fn):
    """``_busy_ms`` of one call and the device kernels it launched (the
    profiler's kernel events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        fn()
        torch.cuda.synchronize()
        prof.step()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA
              and not e.name().startswith("ProfilerStep")]
    if not events:
        return "not measured", "not measured"
    busy = sum(e.duration_ns() if hasattr(e, "duration_ns")
               else 1e3 * e.duration_us() for e in events) / 1e6
    kernels = sum(1 for e in events if "memcpy" not in e.name().lower()
                  and "memset" not in e.name().lower())
    return busy, kernels


def _nl_cell(device, run, reps: int) -> dict:
    """A phase 20 cell, its program built beforehand: the first call's
    launches (no kernel of the port may launch), its peak memory above what
    was held before it and its time (CUDA events), the median with
    ``reps`` - 1 more calls, then one profiled call's device busy time and
    device kernels."""
    reset_launches()
    (out, ms), peak = _peak_call(device, lambda: _once_ms(run))
    launches = read_launches()
    expect_launches(launches)
    if reps > 1:
        ms = statistics.median([ms] + [_once_ms(run)[1]
                                       for _ in range(reps - 1)])
    busy, kernels = _busy_and_kernels(run)
    return {"out": out, "launches": launches, "ms": ms, "busy_ms": busy,
            "idle": _idle_share(ms, busy), "kernels": kernels,
            "peak_bytes": peak}


def rb_path(device, host: dict, reps: int, smi: str, log=print) -> dict:
    """Phase 20 (a) and (b): the range-bearing fleet, RB_B tracks of RB_T
    steps, RB_IT sweeps with the free energy, under Linearization and
    Unscented: the chain on the scans with the JAX planner's reason, no
    kernel; (a0) the same fleet with a linear delta against the float64
    RTS; (a1) the sampled tracks against the port on the CPU; (a2) the
    smoothed positions' RMSE over the fleet, each error in units of the
    measurement noise's scale at its range (sqrt(R_range + r^2
    R_bearing)), under 1.  updates/s = 3 T B a sweep."""
    import torch

    import rxinfer_tpu_torch as rt

    out: dict = {}
    _, yl = rb_tracks(RB_B, RB_T, seed=30, linear=True)
    lin_r = (RB_LIN_R * np.eye(2)).astype(np.float32)
    om, oc = host["rts"]
    orows = list(RB_ORACLE_ROWS)
    for kind in ("linearization", "unscented"):
        model = rb_model(rb_lin_fn, rb_method(kind), RB_T, lin_r)
        reset_launches()
        post, _ = rt.infer_batched(model, {"y": torch.as_tensor(
            yl, device=device)}, iterations=2, initialization=rb_init(),
            device=device, options={"warn": False})
        expect_launches(read_launches())
        errs = {"means": _rel_max(post["x"].mean()[orows].cpu(), om),
                "covs": _rel_max(post["x"].cov()[orows].cpu(), oc)}
        log(f"[nl] (a0) linear delta fleet ({kind}), (B,T)=({RB_B},{RB_T}), "
            f"2 sweeps, against the float64 RTS on rows {orows}, relative: "
            f"{errs} (tol {RB_ORACLE_TOL}); launches none")
        bad = {k: v for k, v in errs.items() if not v <= RB_ORACLE_TOL[k]}
        if bad:
            raise AssertionError(f"linear delta fleet ({kind}): {bad}")
        out[f"a0_{kind}"] = errs
    xs, y = rb_tracks(RB_B, RB_T, seed=31)
    data = {"y": torch.as_tensor(y, device=device)}
    r = np.diag(RB_R).astype(np.float32)
    rows = list(RB_ROWS)
    noise_var = RB_R[0] + (xs[..., 0] ** 2 + xs[..., 1] ** 2) * RB_R[1]
    for tag, kind in (("a", "linearization"), ("b", "unscented")):
        model = rb_model(rb_fn, rb_method(kind), RB_T, r)
        run = lambda: rt.infer_batched(model, data, iterations=RB_IT,
                                       initialization=rb_init(),
                                       free_energy=True, device=device,
                                       options={"warn": False})
        compiled, _ = rt.batched_program(model, data, iterations=RB_IT,
                                         initialization=rb_init(),
                                         free_energy=True, device=device,
                                         options={"warn": False})
        want = {"fused": False, "reason": (
            "evidence factor NonlinearGaussianCovariance reads the chain's "
            "own marginal (state-dependent message)")}
        if compiled.plan_report()["x"] != want:
            raise AssertionError(f"plan_report() {compiled.plan_report()}")
        cell = _nl_cell(device, run, reps)
        post, fe = cell["out"]
        mean = post["x"].mean()
        cpu = host[kind]
        errs = {"mean": _rel_max(mean[rows].cpu(), cpu["mean"]),
                "var": _rel_max(post["x"].var()[rows].cpu(), cpu["var"]),
                "fe": _rel_max(fe[:, rows].cpu(), cpu["fe"])}
        pos = mean[..., :2].cpu().numpy()
        sq = np.sum((pos - xs[..., :2]) ** 2, axis=-1)
        rmse = float(np.sqrt(np.mean(sq)))
        scaled = float(np.sqrt(np.mean(sq / noise_var)))
        fe_h = fe.cpu().numpy()
        ups = 3.0 * RB_T * RB_B * RB_IT / (cell["ms"] / 1e3)
        log(f"[nl] ({tag}) range-bearing fleet, {kind}, (B,T)=({RB_B},"
            f"{RB_T}), {RB_IT} sweeps with FE: call_ms {cell['ms']:.3f} "
            f"updates_per_s {ups:.6g} busy_ms {cell['busy_ms']} idle "
            f"{cell['idle']} device_kernels_per_call {cell['kernels']} "
            f"peak_gb {cell['peak_bytes'] / 1e9:.3f}; (a1) against the port "
            f"on the CPU on rows {rows}, relative: {errs} (tol {RB_TOL}); "
            f"(a2) position RMSE {rmse:.4f} m, {scaled:.4f} of the "
            f"measurement noise's scale (under 1); launches none; {smi}")
        if (max(errs.values()) > RB_TOL or not scaled < 1.0
                or not np.isfinite(fe_h).all()):
            raise AssertionError(f"range-bearing fleet ({kind}): {errs}, "
                                 f"RMSE {rmse} ({scaled} of the noise), FE "
                                 f"finite {np.isfinite(fe_h).all()}")
        out[tag] = {"ms": cell["ms"], "updates_per_s": ups,
                    "busy_ms": cell["busy_ms"], "idle": cell["idle"],
                    "kernels": cell["kernels"],
                    "peak_gb": cell["peak_bytes"] / 1e9, "errs": errs,
                    "rmse": rmse, "rmse_scaled": scaled}
    return out


def glm_path(device, host: dict, reps: int, smi: str, log=print) -> dict:
    """Phase 20 (c): the probit model over PROBIT_B datasets of PROBIT_N
    rows and the SoftDot regression over SOFTDOT_B datasets of SOFTDOT_N
    rows, PROBIT_IT / SOFTDOT_IT sweeps with the free energy: the tests'
    accuracy checks on every dataset (SoftDot's 50 < E[g] < 200 is a factor
    of two around the true noise precision of 100; the mean-field value
    sits lower, the test's own dataset's at 55.6 in both packages); the
    sampled datasets against the port on the CPU (RB_TOL relative); no
    kernel."""
    import torch

    import rxinfer_tpu_torch as rt

    out: dict = {}
    rows = list(GLM_ROWS)
    y = probit_data(PROBIT_B, PROBIT_N)
    data = {"y": torch.as_tensor(y, device=device)}
    run = lambda: rt.infer_batched(probit_model(PROBIT_N), data,
                                   iterations=PROBIT_IT,
                                   initialization=glm_init("probit"),
                                   free_energy=True, device=device)
    rt.batched_program(probit_model(PROBIT_N), data, iterations=PROBIT_IT,
                       initialization=glm_init("probit"), free_energy=True,
                       device=device)
    cell = _nl_cell(device, run, reps)
    post, fe = cell["out"]
    m = post["x"].mean()
    phi_est = 0.5 * (1.0 + torch.erf(m / np.sqrt(2.0))).cpu().numpy()
    acc = np.abs(phi_est - y.mean(axis=1))
    errs = {"mean": _rel_max(m[rows].cpu(), host["probit"]["mean"]),
            "var": _rel_max(post["x"].var()[rows].cpu(),
                            host["probit"]["var"]),
            "fe": _rel_max(fe[:, rows].cpu(), host["probit"]["fe"])}
    ups = PROBIT_B * PROBIT_N * PROBIT_IT / (cell["ms"] / 1e3)
    log(f"[nl] (c) probit B={PROBIT_B} datasets of N={PROBIT_N}, {PROBIT_IT} "
        f"sweeps with FE: call_ms {cell['ms']:.3f} updates_per_s {ups:.6g} "
        f"busy_ms {cell['busy_ms']} idle {cell['idle']} "
        f"device_kernels_per_call {cell['kernels']} peak_gb "
        f"{cell['peak_bytes'] / 1e9:.3f}; |Phi(E[x]) - rate| max "
        f"{acc.max():.4f} (< 0.03 on every dataset); against the port on the "
        f"CPU on rows {rows}, relative: {errs} (tol {RB_TOL}); launches none; "
        f"{smi}")
    if (max(errs.values()) > RB_TOL or not acc.max() < 0.03
            or not np.isfinite(fe.cpu().numpy()).all()):
        raise AssertionError(f"probit on the card: {errs}, {acc.max()}")
    out["probit"] = {"ms": cell["ms"], "updates_per_s": ups,
                     "busy_ms": cell["busy_ms"], "idle": cell["idle"],
                     "kernels": cell["kernels"], "errs": errs}
    phi, ys = softdot_data(SOFTDOT_B, SOFTDOT_N, SOFTDOT_D)
    data = {"phi": torch.as_tensor(phi, device=device),
            "y": torch.as_tensor(ys, device=device)}
    run = lambda: rt.infer_batched(softdot_model(SOFTDOT_N, SOFTDOT_D), data,
                                   iterations=SOFTDOT_IT,
                                   initialization=glm_init("softdot"),
                                   free_energy=True, device=device)
    rt.batched_program(softdot_model(SOFTDOT_N, SOFTDOT_D), data,
                       iterations=SOFTDOT_IT,
                       initialization=glm_init("softdot"), free_energy=True,
                       device=device)
    cell = _nl_cell(device, run, reps)
    post, fe = cell["out"]
    theta = post["theta"].mean().cpu().numpy()
    g = post["g"].mean().cpu().numpy()
    fe_h = fe.cpu().numpy()
    rises = np.diff(fe_h, axis=0) - 5e-5 * np.abs(fe_h[:-1]) - 1e-3
    acc = {"theta_err": float(np.abs(theta - [1.0, -0.5]).max()),
           "g_test": float(g[0]), "g_min": float(g.min()),
           "g_max": float(g.max()),
           "g_outside": int(np.sum((g <= 50.0) | (g >= 200.0))),
           "fe_rise": float(rises.max())}
    errs = {"theta": _rel_max(theta[rows], host["softdot"]["theta"]),
            "g": _rel_max(g[rows], host["softdot"]["g"]),
            "fe": _rel_max(fe_h[:, rows], host["softdot"]["fe"])}
    ups = SOFTDOT_B * SOFTDOT_N * SOFTDOT_IT / (cell["ms"] / 1e3)
    log(f"[nl] (c) SoftDot B={SOFTDOT_B} datasets of N={SOFTDOT_N}, d="
        f"{SOFTDOT_D}, {SOFTDOT_IT} sweeps with FE: call_ms {cell['ms']:.3f} "
        f"updates_per_s {ups:.6g} busy_ms {cell['busy_ms']} idle "
        f"{cell['idle']} device_kernels_per_call {cell['kernels']} peak_gb "
        f"{cell['peak_bytes'] / 1e9:.3f}; accuracy (|theta err| < 0.05, "
        f"50 < E[g] < 200 and the FE never rising on every dataset): {acc}; "
        f"against the port on the CPU on rows {rows}, relative: {errs} (tol "
        f"{RB_TOL}); launches none; {smi}")
    if (max(errs.values()) > RB_TOL or not acc["theta_err"] < 0.05
            or acc["g_outside"] != 0
            or not acc["fe_rise"] <= 0.0):
        raise AssertionError(f"SoftDot on the card: {errs}, {acc}")
    out["softdot"] = {"ms": cell["ms"], "updates_per_s": ups,
                      "busy_ms": cell["busy_ms"], "idle": cell["idle"],
                      "kernels": cell["kernels"], "errs": errs, "acc": acc}
    return out


def cvi_path(device, host: dict, smi: str, log=print) -> dict:
    """Phase 20 (d): ``tests/models/test_cvi_dynamics.py``'s nonlinear
    dynamics over CVI_B datasets of CVI_T steps, CVIProjection with
    CVI_SAMPLES draws, CVI_IT sweeps with the free energy, one timed call:
    the test's checks on its own dataset (dataset 0), counted on the others
    (the model has a second mode, tau large and theta near zero, where
    some paths settle: the checks are calibrated on the test's path), and
    the sampled datasets against the port on the CPU with the card's draws:
    each of the first CVI_CHECK_IT sweeps (CVI_TOL relative) and the
    average of the last two (``cvi_tail_errs``); no kernel."""
    import torch

    import rxinfer_tpu_torch as rt

    hidden, data_path, y = cvi_data(CVI_B, CVI_T)
    data = {"y": torch.as_tensor(y, device=device)}
    model = cvi_model(CVI_T, CVI_SAMPLES)
    run = lambda: rt.infer_batched(model, data, iterations=CVI_IT,
                                   initialization=cvi_init(),
                                   free_energy=True, device=device,
                                   returnvars=rt.KeepEach(),
                                   options={"warn": False})
    rt.batched_program(model, data, iterations=CVI_IT,
                       initialization=cvi_init(), free_energy=True,
                       device=device, keep_each=True,
                       options={"warn": False})
    reset_launches()
    (post, fe), ms = _once_ms(run)
    launches = read_launches()
    expect_launches(launches)
    mz = post["z"][-1].mean().cpu().numpy()
    vz = post["z"][-1].var().cpu().numpy()
    tau_h = torch.stack([q.entropy() for q in post["tau"]]).cpu().numpy()
    fe_h = fe.cpu().numpy()
    fe_c6 = fe_h + (CVI_T - 1) * tau_h
    tau = post["tau"][-1].mean().cpu().numpy()
    theta = post["theta"][-1].mean().cpu().numpy()
    acc = [cvi_accuracy(hidden, data_path[i], mz[i], vz[i], tau[i], theta[i],
                        fe_c6[:, i]) for i in range(CVI_B)]
    n_ok = sum(a["ok"] for a in acc)
    if not acc[0]["ok"]:
        raise AssertionError(f"CVI dynamics, the test's own dataset: {acc[0]}")
    rows = list(CVI_ROWS)
    card, cpu = cvi_sweeps(post, fe, rows), host["cvi"]
    # the first sweep's free energy is NaN in both packages under the
    # reference's vague Gamma(1e-12, 1e-3) initialization (the test reads
    # it from the second on)
    k = CVI_CHECK_IT
    errs = {"mean": _rel_max(card["mean"][:k], cpu["mean"][:k]),
            "var": _rel_max(card["var"][:k], cpu["var"][:k]),
            "fe": _rel_max(card["fe"][1:k], cpu["fe"][1:k])}
    tail = cvi_tail_errs(card, cpu, host["cvi_ulp"])
    tail_bad = {name: [j for j, (e, tol) in enumerate(v) if not e <= tol]
                for name, v in tail.items()}
    ups = 3.0 * CVI_T * CVI_B * CVI_IT / (ms / 1e3)
    log(f"[nl] (d) CVI nonlinear dynamics B={CVI_B} datasets of T={CVI_T}, "
        f"{CVI_SAMPLES} draws, {CVI_IT} sweeps with FE: call_ms {ms:.3f} "
        f"updates_per_s {ups:.6g}; the test's checks on its dataset: "
        f"{acc[0]}; they hold on {n_ok} of {CVI_B} datasets (first failing: "
        f"{next((a for a in acc if not a['ok']), None)}); against the port "
        f"on the CPU with the card's draws on rows {rows}, relative: the "
        f"first {CVI_CHECK_IT} sweeps {errs} (tol {CVI_TOL}); the average "
        f"of sweeps {CVI_IT - 1} and {CVI_IT}, (error, tolerance) a row: "
        f"{_pairs(tail)}; "
        f"launches none; {smi}")
    if max(errs.values()) > CVI_TOL or any(tail_bad.values()):
        raise AssertionError(f"CVI dynamics on the card: {errs}, the last "
                             f"sweeps' rows out of tolerance {tail_bad}")
    return {"ms": ms, "updates_per_s": ups, "errs": errs, "tail": tail,
            "ok": n_ok}


def strict_path(device, reps: int, smi: str, log=print) -> dict:
    """Phase 20 (e): bench.py's strict-fp32 row, the LGSSM cell of phase 4
    (one iteration) with ``options={"matmul_precision": "highest"}`` beside
    the default program: exactly one K1 and one K2 launch a call each, the
    posteriors equal within STRICT_TOL, sampled chains against the float64
    RTS (ORACLE_TOL), both timed in turns."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    f, q, h, r, m0, p0 = lgssm_constants(MAIN_D)
    model = zoo.lgssm(f, q, h, r, m0, p0)
    data = {"y": torch.as_tensor(lgssm_y(MAIN_B, MAIN_T, MAIN_D),
                                 device=device)}
    progs, states, launches = {}, {}, {}
    prev = torch.get_float32_matmul_precision()
    for name, opts in (("strict", {"matmul_precision": "highest"}),
                       ("default", None)):
        _, progs[name] = rt.batched_program(model, data, iterations=1,
                                            device=device, options=opts)
        reset_launches()
        states[name] = progs[name](data)[0]["x"]
        torch.cuda.synchronize()
        launches[name] = read_launches()
        expect_launches(launches[name], fused_smoother_fwd=1,
                        fused_smoother_bwd=1)
        if torch.get_float32_matmul_precision() != prev:
            raise AssertionError("matmul_precision was not restored")
    diff = {"means": _rel_max(states["strict"].mu.cpu(),
                              states["default"].mu.cpu()),
            "covs": _rel_max(states["strict"].sigma.cpu(),
                             states["default"].sigma.cpu())}
    rows = [0, 1, MAIN_B // 2, MAIN_B - 1]
    o_m, o_p = lgssm_rows_oracle(MAIN_B, MAIN_T, MAIN_D, tuple(rows))
    oracle = {"means": float(np.abs(states["strict"].mu[rows].cpu().numpy()
                                    - np.moveaxis(o_m, 0, 1)).max()),
              "covs": float(np.abs(states["strict"].sigma[rows].cpu().numpy()
                                   - np.moveaxis(o_p, 0, 1)).max())}
    times = [_cuda_ms(lambda n=n: progs[n](data), reps)
             for n in ("default", "strict", "strict", "default")]
    log(f"[nl] (e) strict-fp32 LGSSM (B,T,d)=({MAIN_B},{MAIN_T},{MAIN_D}), "
        f"1 iteration, matmul_precision='highest': launches "
        f"{launches['strict']}; against the default program, relative: "
        f"{diff} (tol {STRICT_TOL}); float64 RTS on rows {rows}, max abs: "
        f"{oracle} (tol {ORACLE_TOL}); ms in turns default/strict/strict/"
        f"default {[round(t, 4) for t in times]}; {smi}")
    if max(diff.values()) > STRICT_TOL or max(oracle.values()) > ORACLE_TOL:
        raise AssertionError(f"strict-fp32 row: {diff}, {oracle}")
    return {"launches": launches["strict"], "diff": diff, "oracle": oracle,
            "ms": {"strict": (times[1] + times[2]) / 2,
                   "default": (times[0] + times[3]) / 2}}


# -- slice 22: constraints (phase 21) -----------------------------------------------

# Phase 21 (a): the online HGF of tests/models/test_hgf_streaming.py:37-44
# (kappa 1, omega 0, z step variance 0.04, y variance 0.01) on the streaming
# engine, HGFS_B streams in lockstep, HGFS_IT sweeps a tick, with the
# reference's constraint q(xt, zt, xt_min) = q(xt, xt_min)q(zt) passed
# explicitly.  Stream 0 is tests/models/test_joint_pairs.py:101-114's data
# (seed 42), streams 1.. the same recursion vectorized from seed 43.  Cut
# for time: 300 ticks -> HGFS_T (a tick takes 77-98 ms on the card,
# host-bound: 300 would take 23-29 s a call, and the phase may add 15 s);
# (a2) compares the first HGFS_A2_T ticks.
HGFS_B, HGFS_T, HGFS_IT, HGFS_A2_T = 10_000, 60, 10, 20
HGFS_K, HGFS_W, HGFS_ZV, HGFS_YV = 1.0, 0.0, 0.2 ** 2, 0.1 ** 2
HGFS_ROWS = (0, 1, HGFS_B // 2, HGFS_B - 1)
HGFS_TOL = 1e-3          # phase 19 (b)'s HGF tolerance (C9), relative
# the fleet's shares of (stream, tick) states within 3 and 6 sd, x and z;
# the JAX package reaches them on 64 streams on the CPU
# (scripts/constraint_gates.py)
HGFS_SHARES = {"3sd": 0.95, "6sd": 0.999}
HGFS_PROFILE_T = 3       # ticks of the profiled call
# Phase 21 (b): tests/models/test_projection.py:12-48's model, theta ~
# Beta(2, 2), PROJ_N observations y ~ N(theta, PROJ_VAR), over PROJ_B
# datasets (theta uniform in (0.1, 0.9)), PROJ_IT sweeps of
# ProjectedTo("beta", n_samples=PROJ_SAMPLES); every dataset against its
# quadrature posterior.  The JAX package's worst gap over the first 64 of
# these datasets on the CPU is not finite (NaN posteriors where theta is
# below 0.19 or above 0.83, scripts/constraint_gates.py), so twice it
# bounds nothing and the gate is the JAX test's own tolerance (mean 0.02,
# variance 50% + 1e-4); PROJ_JAX_FINITE holds twice the JAX package's worst
# gaps over the 53 datasets it solves, printed beside the port's
PROJ_B, PROJ_N, PROJ_IT, PROJ_SAMPLES, PROJ_VAR = 1024, 60, 8, 4096, 0.05
PROJ_TOL = {"mean": 0.02, "var_rel": 0.5, "var_abs": 1e-4}
PROJ_JAX_FINITE = {"mean": 2.59e-4, "var_rel": 3.24e-2}
# Phase 21 (c): MeanField() on phase 12 (e)'s Gaussian cell against its
# float64 mean-field VMP, relative to the largest value
MF_TOL = 1e-4
# and against the unconstrained program: the mean-field rule forms the
# message to mu in precision form where the default's takes variance
# form, one float32 rounding apart in both packages
# (tests/test_torch_constraints.py), relative
MF_DEFAULT_TOL = 1e-5


def hgfs_data(b: int, t_len: int):
    """(z, x, y), each (t_len, b): stream 0 by
    tests/models/test_joint_pairs.py:101-114's loop (seed 42), the others by
    the same recursion over the streams at once (seed 43)."""
    z = np.zeros((t_len, b))
    x = np.zeros((t_len, b))
    y = np.zeros((t_len, b))
    rng = np.random.default_rng(42)
    z_prev = x_prev = 0.0
    for t in range(t_len):
        z_prev = z_prev + np.sqrt(HGFS_ZV) * rng.standard_normal()
        v = np.exp(HGFS_K * z_prev + HGFS_W)
        x_prev = x_prev + np.sqrt(v) * rng.standard_normal()
        z[t, 0], x[t, 0] = z_prev, x_prev
        y[t, 0] = x_prev + np.sqrt(HGFS_YV) * rng.standard_normal()
    rng = np.random.default_rng(43)
    zp, xp = np.zeros(b - 1), np.zeros(b - 1)
    for t in range(t_len):
        zp = zp + np.sqrt(HGFS_ZV) * rng.standard_normal(b - 1)
        xp = xp + np.sqrt(np.exp(HGFS_K * zp + HGFS_W)) \
            * rng.standard_normal(b - 1)
        z[t, 1:], x[t, 1:] = zp, xp
        y[t, 1:] = xp + np.sqrt(HGFS_YV) * rng.standard_normal(b - 1)
    return z, x, y.astype(np.float32)


def hgfs_model(rx):
    """tests/models/test_hgf_streaming.py:37-44's tick, in ``rx`` (the port
    here; the JAX package in scripts/constraint_gates.py)."""
    @rx.model
    def hgf_step(y, zt_min_mean, zt_min_var, xt_min_mean, xt_min_var):
        zt_min = rx.Normal(mean=zt_min_mean, var=zt_min_var)
        xt_min = rx.Normal(mean=xt_min_mean, var=xt_min_var)
        zt = rx.Normal(mean=zt_min, var=HGFS_ZV)
        xt = rx.GCV(xt_min, zt, kappa=HGFS_K, omega=HGFS_W)
        y.observe(rx.Normal(mean=xt, var=HGFS_YV))
        return {"zt": zt, "xt": xt, "zt_min": zt_min, "xt_min": xt_min}

    return hgf_step


def hgfs_engine_kw(rx, b: int, dist, constrained: bool = True) -> dict:
    """The engine's arguments beside the model and the data: the
    autoupdates of b streams, the initialization (``dist`` makes a
    NormalMeanVariance), the reference constraint."""
    au = rx.autoupdates(
        initial={"zt_min_mean": np.zeros(b, np.float32),
                 "zt_min_var": np.full(b, 5.0, np.float32),
                 "xt_min_mean": np.zeros(b, np.float32),
                 "xt_min_var": np.full(b, 5.0, np.float32)},
        zt_min_mean=lambda q: q["zt"].mean(),
        zt_min_var=lambda q: q["zt"].var(),
        xt_min_mean=lambda q: q["xt"].mean(),
        xt_min_var=lambda q: q["xt"].var())
    kw = dict(autoupdates=au, batched=True, iterations=HGFS_IT,
              free_energy=True,
              initialization={"zt": dist(0.0, 5.0), "xt": dist(0.0, 5.0)})
    if constrained:
        kw["constraints"] = rx.constraints(factorization=rx.factorize(
            ("xt", "zt"), ("xt_min", "zt")))
    return kw


def hgfs_run(device, y, constrained: bool = True, meta=None, keep=None):
    """The port's engine over y (T, B) on ``device`` through ``infer``'s
    datastream with keephistory (and ``meta=``): xt's and zt's (mean, var)
    per tick, (T, B) each, on the host, and the free energies (T, B,
    HGFS_IT).  The engine is appended to ``keep`` when given."""
    import torch

    import rxinfer_tpu_torch as rt

    t_len, b = y.shape
    dist = lambda m, v: rt.NormalMeanVariance(torch.tensor(m),
                                              torch.tensor(v))
    yt = torch.as_tensor(y, device=device)
    eng = rt.infer(model=hgfs_model(rt), datastream=[
        {"y": yt[t]} for t in range(t_len)], keephistory=t_len,
        historyvars={"xt": rt.KeepLast(), "zt": rt.KeepLast()},
        device=device, meta=meta, **hgfs_engine_kw(rt, b, dist, constrained))
    if keep is not None:
        keep.append(eng)
    post = {name: tuple(torch.stack([getattr(h[name], f)() for h in
                                     eng.history]).cpu().numpy()
                        for f in ("mean", "var")) for name in ("xt", "zt")}
    return post, torch.stack([torch.as_tensor(f) for f in
                              eng.fe_history]).cpu().numpy()


def hgfs_reference_checks(z, x, post, fe) -> dict:
    """tests/models/test_joint_pairs.py:139-154 on one stream: positive
    variances, every state within 6 sd, more than 95% within 3 sd (x and
    z), and every large step of the tick-averaged free energy down."""
    (mx, vx), (mz, vz) = post["xt"], post["zt"]
    sx, sz = np.sqrt(vx), np.sqrt(vz)
    diffs = np.diff(np.mean(fe, axis=0))
    vals = {"var_positive": bool(np.all(sx > 0) and np.all(sz > 0)),
            "x_6sd": bool(np.all(np.abs(x - mx) < 6.0 * sx)),
            "z_6sd": bool(np.all(np.abs(z - mz) < 6.0 * sz)),
            "x_3sd": float(np.mean(np.abs(x - mx) < 3.0 * sx)),
            "z_3sd": float(np.mean(np.abs(z - mz) < 3.0 * sz)),
            "fe_big_steps_down": bool(np.all(diffs[np.abs(diffs) > 0.1] < 0))}
    vals["ok"] = (vals["var_positive"] and vals["x_6sd"] and vals["z_6sd"]
                  and vals["x_3sd"] > 0.95 and vals["z_3sd"] > 0.95
                  and vals["fe_big_steps_down"])
    return vals


def hgfs_shares(z, x, post) -> dict:
    """The fleet's shares of (tick, stream) states within 3 and 6 sd."""
    out = {}
    for name, truth in (("x", x), ("z", z)):
        m, v = post[name + "t"]
        err = np.abs(truth - m) / np.sqrt(v)
        out[name] = {"3sd": float(np.mean(err < 3.0)),
                     "6sd": float(np.mean(err < 6.0))}
    return out


def proj_model(rx, n: int = PROJ_N):
    """tests/models/test_projection.py:12-48's model."""
    @rx.model
    def beta_gauss(y):
        theta = rx.Beta(2.0, 2.0)
        for i in rx.plate(n):
            y[i] = rx.Normal(mean=theta, var=PROJ_VAR)
        return {"theta": theta}

    return beta_gauss


def proj_data(b: int, n: int = PROJ_N, seed: int = 22):
    """theta (b,) uniform in (0.1, 0.9) and y (b, n) ~ N(theta, PROJ_VAR)."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.1, 0.9, b)
    y = theta[:, None] + np.sqrt(PROJ_VAR) * rng.standard_normal((b, n))
    return theta, y.astype(np.float32)


def proj_quadrature(y):
    """Each dataset's posterior mean and variance of theta by the
    trapezoid rule on 4001 points of (0, 1), float64 (the JAX test's
    grid)."""
    from scipy import integrate

    y = np.asarray(y, np.float64)
    ts = np.linspace(1e-4, 1 - 1e-4, 4001)
    s1, s2, n = y.sum(1, keepdims=True), (y * y).sum(1, keepdims=True), \
        y.shape[1]
    logw = (np.log(ts * (1.0 - ts))[None]
            - 0.5 * (s2 - 2.0 * ts[None] * s1 + n * ts[None] ** 2) / PROJ_VAR)
    w = np.exp(logw - logw.max(1, keepdims=True))
    w /= integrate.trapezoid(w, ts, axis=1)[:, None]
    mean = integrate.trapezoid(ts[None] * w, ts, axis=1)
    var = integrate.trapezoid((ts[None] - mean[:, None]) ** 2 * w, ts,
                              axis=1)
    return mean, var


def proj_gaps(mean, var, q_mean, q_var) -> dict:
    """The worst gaps to the quadrature: |mean error| and the variance
    error over (var_rel * var + var_abs) as PROJ_TOL scales it."""
    mean, var = np.asarray(mean, np.float64), np.asarray(var, np.float64)
    return {"mean": float(np.abs(mean - q_mean).max()),
            "var_rel": float((np.abs(var - q_var) / q_var).max())}


def slice22_checks(wall0: float) -> tuple[list, dict]:
    """Phase 21's host work in a process of its own beside phase 3's: the
    port on the CPU over (a)'s sampled streams, (b)'s quadrature posteriors
    and (c)'s float64 mean-field VMP."""
    import torch

    lines: list = []
    torch.set_num_threads(2)
    out: dict = {}
    t0 = time.perf_counter()
    _, _, y = hgfs_data(HGFS_B, HGFS_T)
    out["hgfs"] = hgfs_run(torch.device("cpu"), y[:, list(HGFS_ROWS)])
    lines.append(f"[constraints check] the online HGF on the CPU over "
                 f"{len(HGFS_ROWS)} streams, {HGFS_T} ticks in "
                 f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["proj"] = proj_quadrature(proj_data(PROJ_B)[1])
    _, yg = config2_data()
    out["mf"] = gauss_vmp_fe_float64(yg, GAUSS_IT, with_state=True)
    lines.append(f"[constraints check] quadrature of {PROJ_B} datasets and "
                 f"the float64 VMP of {GAUSS_B} in "
                 f"{time.perf_counter() - t0:.1f} s")
    _ended(lines, "phase 21 host checks", wall0)
    return lines, out


def hgf_stream_path(device, host: dict, smi: str, log=print) -> dict:
    """Phase 21 (a): the online HGF fleet, HGFS_B streams of HGFS_T ticks,
    HGFS_IT sweeps a tick with the free energy, through ``infer``'s
    datastream (``batched=True``, keephistory) with the reference
    constraint: (a0) the sampled streams against the port's CPU run
    (``host``) at HGFS_TOL relative; (a1) stream 0 by the reference's
    checks and the fleet's shares within 3 and 6 sd (HGFS_SHARES); (a2)
    the fleet without ``constraints=`` over the first HGFS_A2_T ticks equal
    bit for bit on the sampled streams.  No kernel launches.  A two-tick
    call warms the card first; the timed call is one, by the host's clock
    (its ticks synchronize).  updates/s = 2 HGFS_T HGFS_B HGFS_IT (x and z
    a sweep)."""
    import torch

    z, x, y = hgfs_data(HGFS_B, HGFS_T)
    rows = list(HGFS_ROWS)
    hgfs_run(device, y[:2])
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (post, fe), peak = _peak_call(device, lambda: hgfs_run(device, y))
    ms = 1e3 * (time.perf_counter() - t0)
    expect_launches(read_launches())
    t0 = time.perf_counter()
    post_mf, fe_mf = hgfs_run(device, y[:HGFS_A2_T], constrained=False)
    first = lambda a: a[:HGFS_A2_T]
    ms_default = 1e3 * (time.perf_counter() - t0)
    y_prof = y[:HGFS_PROFILE_T]
    busy, kernels = _busy_and_kernels(lambda: hgfs_run(device, y_prof))
    prof_ms = _once_ms(lambda: hgfs_run(device, y_prof))[1]
    errs = {f"{n}_{w}": _rel_max(post[n][i][:, rows], host["hgfs"][0][n][i])
            for n in ("xt", "zt") for i, w in enumerate(("mean", "var"))}
    # the free energy printed beside them: its Gaussian average energies
    # cancel E[out^2] - 2 E[out] mean + mean^2 at |y| of several units in
    # float32 (tests/test_torch_hgf_streaming.py), so it is not held there
    fe_err = _rel_max(fe[:, rows], host["hgfs"][1])
    ref = hgfs_reference_checks(
        z[:, 0], x[:, 0], {n: (post[n][0][:, 0], post[n][1][:, 0])
                           for n in ("xt", "zt")}, fe[:, 0])
    shares = hgfs_shares(z, x, post)
    same = all(np.array_equal(first(post[n][i])[:, rows],
                              post_mf[n][i][:, rows])
               for n in ("xt", "zt") for i in (0, 1)) and np.array_equal(
        first(fe)[:, rows], fe_mf[:, rows])
    same_fleet = all(np.array_equal(first(post[n][i]), post_mf[n][i])
                     for n in ("xt", "zt") for i in (0, 1))
    ups = 2.0 * HGFS_T * HGFS_B * HGFS_IT / (ms / 1e3)
    log(f"[constraints] (a) online HGF (B,T)=({HGFS_B},{HGFS_T}), {HGFS_IT} "
        f"sweeps a tick with FE, q(xt, xt_min)q(zt): call_ms {ms:.1f} "
        f"updates_per_s {ups:.6g} peak_gb {peak / 1e9:.3f}; a "
        f"{HGFS_PROFILE_T}-tick call {prof_ms:.1f} ms: busy_ms {busy} idle "
        f"{_idle_share(prof_ms, busy)} device kernels {kernels}; "
        f"(a0) against the port on the CPU on streams {rows}, relative: "
        f"{errs} (tol {HGFS_TOL}), free energy {fe_err:.3g}; (a1) stream 0 "
        f"{ref}, fleet shares {shares}"
        f" (gate {HGFS_SHARES}); (a2) without constraints= over {HGFS_A2_T} "
        f"ticks bit-equal on the sampled streams {same}, on the fleet "
        f"{same_fleet}, call_ms "
        f"{ms_default:.1f}; launches none; {smi}")
    if (max(errs.values()) > HGFS_TOL or not ref["ok"] or not same
            or not np.isfinite(fe).all()
            or any(shares[n][k] < HGFS_SHARES[k] for n in shares
                   for k in HGFS_SHARES)):
        raise AssertionError(f"the online HGF fleet: {errs}, {ref}, "
                             f"{shares}, bit-equal {same}")
    return {"ms": ms, "updates_per_s": ups, "busy_ms": busy,
            "kernels": kernels, "peak_gb": peak / 1e9, "errs": errs,
            "fe_err": fe_err}


def projection_path(device, host: dict, smi: str, log=print) -> dict:
    """Phase 21 (b): ``ProjectedTo("beta")`` over PROJ_B datasets through
    ``infer_batched``, PROJ_IT sweeps: every dataset against its quadrature
    posterior (``host``) at PROJ_TOL.  No kernel launches.  updates/s =
    PROJ_B PROJ_IT (one projected marginal a dataset a sweep)."""
    import torch

    import rxinfer_tpu_torch as rt

    _, y = proj_data(PROJ_B)
    data = {"y": torch.as_tensor(y, device=device)}
    model = proj_model(rt)
    cons = rt.constraints(forms={"theta": rt.ProjectedTo(
        "beta", n_samples=PROJ_SAMPLES)})
    init = {"theta": rt.Beta(2.0, 2.0)}
    run = lambda: rt.infer_batched(model, data, iterations=PROJ_IT,
                                   constraints=cons, initialization=init,
                                   device=device)
    run()
    cell = _nl_cell(device, run, reps=2)
    q = cell["out"].posteriors["theta"]
    gaps = proj_gaps(q.mean().cpu().numpy(), q.var().cpu().numpy(),
                     *host["proj"])
    var_ok = bool(np.all(np.abs(q.var().cpu().numpy() - host["proj"][1])
                         <= PROJ_TOL["var_rel"] * host["proj"][1]
                         + PROJ_TOL["var_abs"]))
    ups = PROJ_B * PROJ_IT / (cell["ms"] / 1e3)
    log(f"[constraints] (b) ProjectedTo('beta', n_samples={PROJ_SAMPLES}) "
        f"B={PROJ_B}, n={PROJ_N}, {PROJ_IT} sweeps: call_ms "
        f"{cell['ms']:.3f} updates_per_s {ups:.6g} busy_ms "
        f"{cell['busy_ms']} idle {cell['idle']} device kernels "
        f"{cell['kernels']} peak_gb {cell['peak_bytes'] / 1e9:.3f}; against "
        f"the quadrature on every dataset: {gaps} (tol {PROJ_TOL}; twice "
        f"the JAX package's gaps where it is finite {PROJ_JAX_FINITE}); "
        f"launches none; {smi}")
    if gaps["mean"] > PROJ_TOL["mean"] or not var_ok:
        raise AssertionError(f"ProjectedTo fleet: {gaps}")
    return {"ms": cell["ms"], "updates_per_s": ups, "gaps": gaps}


def mean_field_paths(device, host: dict, smi: str, log=print) -> dict:
    """Phase 21 (c): ``constraints=MeanField()`` on paths that already
    run.  Phase 12 (e)'s Gaussian cell through ``infer_batched``: against
    its float64 mean-field VMP (``host``) at MF_TOL, against the
    unconstrained program at MF_DEFAULT_TOL.  The LGSSM cell of phase 4
    (one iteration): one K1 and one K2 launch, as without it, and the
    posteriors equal to the unconstrained program's bit for bit."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    mf = rt.constraints(factorization=rt.MeanField())
    _, yg = config2_data()
    data = {"y": torch.as_tensor(yg, device=device)}
    model = zoo.gaussian_unknown_mean_precision()
    init = {"tau": rt.Gamma(1.0, 1.0)}
    kw = dict(iterations=GAUSS_IT, free_energy=True, initialization=init,
              device=device)
    run = lambda: rt.infer_batched(model, data, constraints=mf, **kw)
    run()
    cell = _nl_cell(device, run, reps=3)
    post, fe = cell["out"]
    base, fe_base = rt.infer_batched(model, data, **kw)
    o_fe, o = host["mf"]
    got = {"mu_mean": post["mu"].mean(), "mu_var": post["mu"].var(),
           "tau_shape": post["tau"].a, "tau_rate": post["tau"].b}
    want = {"mu_mean": o["mu"][0], "mu_var": o["mu"][1],
            "tau_shape": o["tau"][0], "tau_rate": o["tau"][1]}
    dflt = {"mu_mean": base["mu"].mean(), "mu_var": base["mu"].var(),
            "tau_shape": base["tau"].a, "tau_rate": base["tau"].b}
    errs = {k: _rel_max(got[k].cpu().numpy(), want[k]) for k in got}
    errs["fe"] = _rel_max(fe.cpu().numpy(), o_fe)
    errs_default = {k: _rel_max(got[k].cpu().numpy(), dflt[k].cpu().numpy())
                    for k in got}
    errs_default["fe"] = _rel_max(fe.cpu().numpy(), fe_base.cpu().numpy())
    bit_equal = all(torch.equal(got[k], dflt[k]) for k in got)
    ups = 2.0 * GAUSS_B * GAUSS_IT / (cell["ms"] / 1e3)

    f, q, h, r, m0, p0 = lgssm_constants(MAIN_D)
    lg = zoo.lgssm(f, q, h, r, m0, p0)
    ldata = {"y": torch.as_tensor(lgssm_y(MAIN_B, MAIN_T, MAIN_D),
                                  device=device)}
    states, launches, progs = {}, {}, {}
    for name, cons in (("mean_field", mf), ("default", None)):
        _, progs[name] = rt.batched_program(lg, ldata, iterations=1,
                                            constraints=cons, device=device)
        reset_launches()
        states[name] = progs[name](ldata)[0]["x"]
        torch.cuda.synchronize()
        launches[name] = read_launches()
        expect_launches(launches[name], fused_smoother_fwd=1,
                        fused_smoother_bwd=1)
    lg_equal = (torch.equal(states["mean_field"].mu, states["default"].mu)
                and torch.equal(states["mean_field"].sigma,
                                states["default"].sigma))
    lg_ms = _cuda_ms(lambda: progs["mean_field"](ldata), 2)
    log(f"[constraints] (c) MeanField() on gaussian_unknown_mean_precision "
        f"B={GAUSS_B} n={GAUSS_N}, {GAUSS_IT} sweeps with FE: call_ms "
        f"{cell['ms']:.3f} updates_per_s {ups:.6g} busy_ms "
        f"{cell['busy_ms']} idle {cell['idle']} device kernels "
        f"{cell['kernels']} peak_gb {cell['peak_bytes'] / 1e9:.3f}; against "
        f"the float64 mean-field VMP, relative: {errs} (tol {MF_TOL}); "
        f"against the unconstrained program: {errs_default} (tol "
        f"{MF_DEFAULT_TOL}), bit-equal {bit_equal}; LGSSM (B,T,d)=("
        f"{MAIN_B},{MAIN_T},{MAIN_D}) under MeanField(): launches "
        f"{launches['mean_field']}, posteriors bit-equal to the "
        f"unconstrained program's {lg_equal}, call_ms {lg_ms:.4f}; {smi}")
    if (max(errs.values()) > MF_TOL
            or max(errs_default.values()) > MF_DEFAULT_TOL or not lg_equal):
        raise AssertionError(f"MeanField(): {errs}, {errs_default}, LGSSM "
                             f"bit-equal {lg_equal}")
    return {"ms": cell["ms"], "errs": errs, "errs_default": errs_default,
            "lgssm_launches": launches["mean_field"]}


# -- the rest of the node library (phase 22) ---------------------------------------

# Phase 22's cells, each a plain-group model through ``infer_batched`` with
# the free energy (no kernel launches):
# (a) counts: one demand rate a store, rate ~ Gamma(shape=2, scale=5),
#     y ~ Poisson(rate), CNT_B stores x CNT_N days; a click-through rate an
#     ad, p ~ Beta(1, 1), y ~ Binomial(n, p), BIN_B ads x BIN_N days;
#     session mixes a user, p ~ Dirichlet(ones(MULT_K)), y ~ Multinomial(n,
#     p), MULT_B users x MULT_N sessions;
# (b) a noise level a sensor: mu ~ N(0, 100), v ~ InverseGamma(2, 1),
#     y ~ N(mu, var=v), NOISE_B sensors x NOISE_N readings, NOISE_IT sweeps;
# (c) a covariance a sensor array at d = COV_D: Sigma ~ InverseWishart(d +
#     3, I), y ~ MvNormal(m, cov=Sigma), COV_B arrays x COV_N readings, m
#     known (one sweep) or m ~ MvNormal(0, 100 I) (COV_IT sweeps), and the
#     scale-precision form MvNormal(mean=m, gamma=g), g ~ Gamma(1, 1);
# (d) an offset plus a bias a sensor: y ~ N(a + b, 0.25) (the contracted
#     GaussianSum factor), SUM_B datasets of one reading (a tree) and of
#     SUM_LOOPY_N (loopy, SUM_IT sweeps); s = lincomb(A x + B u), y ~
#     MvNormal(s, R) at d = LC_D, LC_B datasets.
CNT_B, CNT_N = 10_000, 365
BIN_B, BIN_N = 10_000, 30
MULT_B, MULT_N, MULT_K = 4096, 50, 16
NOISE_B, NOISE_N, NOISE_IT = 4096, 1000, 10
COV_B, COV_N, COV_D, COV_IT = 1024, 400, 8, 5
SUM_B, SUM_LOOPY_N, SUM_IT = 10_000, 100, 20
LC_B, LC_D, LC_IT = 10_000, 4, 2
# float32 against each cell's float64 closed form or float64 VMP of the
# same schedule: the posteriors' parameters and the free energy, each
# relative to its largest value
A6D_TOL = 1e-4
# the loopy sum's E[a + b] against the conjugate posterior of a + b: loopy
# BP's own gap, bounded as tests/models/test_misc_nodes.py bounds it
A6D_SUM_GAP = 0.05


def _log_factorial64(x):
    """log x! of non-negative integer counts (a float array), by a table."""
    x = np.asarray(x, np.int64)
    table = np.concatenate([[0.0], np.cumsum(np.log(np.arange(
        1, int(x.max()) + 1, dtype=np.float64)))])
    return table[x]


def _mv_lgamma64(d: int, a):
    a = np.asarray(a, np.float64)
    j = np.arange(1, d + 1)
    return 0.25 * d * (d - 1) * math.log(math.pi) + _lgamma64(
        a[..., None] + 0.5 * (1 - j)).sum(-1)


def _mv_digamma64(d: int, a):
    a = np.asarray(a, np.float64)
    j = np.arange(1, d + 1)
    return digamma64(a[..., None] + 0.5 * (1 - j)).sum(-1)


def _slogdet64(m):
    return np.linalg.slogdet(np.asarray(m, np.float64))[1]


def a6d_counts_data():
    """Phase 22 (a)'s data: Poisson counts (CNT_B, CNT_N), binomial
    successes and trials (BIN_B, BIN_N), multinomial counts (MULT_B,
    MULT_N, MULT_K) and their totals."""
    rng = np.random.default_rng(23)
    rate = rng.gamma(2.0, 5.0, (CNT_B, 1))
    y = rng.poisson(rate, (CNT_B, CNT_N)).astype(np.float32)
    n = rng.integers(20, 500, (BIN_B, BIN_N))
    yb = rng.binomial(n, rng.beta(2.0, 30.0, (BIN_B, 1))).astype(np.float32)
    nm = rng.integers(1, 40, (MULT_B, MULT_N))
    ym = rng.multinomial(nm, rng.dirichlet(np.ones(MULT_K), MULT_B)[
        :, None, :]).astype(np.float32)
    return y, (yb, n.astype(np.float32)), (ym, nm.astype(np.float32))


def a6d_counts_oracle():
    """Phase 22 (a)'s closed forms in float64: each cell's posterior
    parameters and -log p(y)."""
    y, (yb, n), (ym, nm) = a6d_counts_data()
    out = {}
    a, b = 2.0 + y.sum(1, dtype=np.float64), 0.2 + CNT_N
    out["poisson"] = ({"a": a, "b": np.full(CNT_B, b)}, -(
        _lgamma64(a) - a * np.log(b) - (math.lgamma(2.0) - 2.0 * np.log(0.2))
        - _log_factorial64(y).sum(1)))
    pa = 1.0 + yb.sum(1, dtype=np.float64)
    pb = 1.0 + (n - yb).sum(1, dtype=np.float64)
    out["binomial"] = ({"a": pa, "b": pb}, -(
        _lgamma64(pa) + _lgamma64(pb) - _lgamma64(pa + pb)
        + (_log_factorial64(n) - _log_factorial64(yb)
           - _log_factorial64(n - yb)).sum(1)))
    alpha = 1.0 + ym.sum(1, dtype=np.float64)
    out["multinomial"] = ({"alpha": alpha}, -(
        _lgamma64(alpha).sum(-1) - _lgamma64(alpha.sum(-1))
        + math.lgamma(MULT_K)
        + (_log_factorial64(nm) - _log_factorial64(ym).sum(-1)).sum(1)))
    return out


def a6d_noise_data():
    rng = np.random.default_rng(24)
    loc = rng.normal(0.0, 2.0, (NOISE_B, 1))
    scale = rng.uniform(0.2, 2.0, (NOISE_B, 1))
    return (loc + scale * rng.standard_normal((NOISE_B, NOISE_N))).astype(
        np.float32)


def a6d_noise_vmp64(y, iterations):
    """Phase 22 (b)'s VMP in float64, the port's schedule (mu, then v; v
    starting at its prior): mu's messages read E[v] (the Gaussian node's
    BP-form message to its mean), v's are the a = -1/2 InverseGamma
    carriers.  The posteriors after the last sweep and the free energy
    after every sweep, (iterations, B)."""
    y = np.asarray(y, np.float64)
    n = y.shape[1]
    s1, s2 = y.sum(1), (y * y).sum(1)
    a, b = np.full(len(y), 2.0), np.ones(len(y))
    fes = []
    for _ in range(iterations):
        w = 1.0 / 100.0 + n / (b / (a - 1.0))
        m, v = (s1 / (b / (a - 1.0))) / w, 1.0 / w
        c = s2 - 2.0 * m * s1 + n * (m * m + v)
        a, b = 2.0 + 0.5 * n, 1.0 + 0.5 * c
        fes.append(_noise_fe64(n, m, v, c, a, b))
    return {"mu_mean": m, "mu_var": v, "v_a": a, "v_b": b}, np.stack(fes)


def _noise_fe64(n, m, v, c, a, b):
    e_inv, e_log = a / b, np.log(b) - digamma64(a)
    ae = (0.5 * (n * math.log(2 * math.pi) + n * e_log + c * e_inv)
          + 0.5 * (math.log(2 * math.pi * 100.0) + (m * m + v) / 100.0)
          - (2.0 * math.log(1.0) - math.lgamma(2.0) - 3.0 * e_log - e_inv))
    h = (0.5 * np.log(2 * np.pi * np.e * v)
         + a + np.log(b) + _lgamma64(a) - (1.0 + a) * digamma64(a))
    return ae - h


def a6d_cov_data():
    rng = np.random.default_rng(25)
    d = COV_D
    g = rng.standard_normal((COV_B, d, d)) / np.sqrt(d)
    chol = np.linalg.cholesky(g @ np.swapaxes(g, -1, -2) + 0.5 * np.eye(d))
    m = rng.normal(0.0, 1.0, (COV_B, 1, d))
    y = m + np.einsum("bij,bnj->bni", chol,
                      rng.standard_normal((COV_B, COV_N, d)))
    return y.astype(np.float32)


def _iw_entropy64(nu, psi):
    d = psi.shape[-1]
    return (0.5 * (d + 1.0) * _slogdet64(psi) - 0.5 * d * (d + 1.0)
            * math.log(2.0) + _mv_lgamma64(d, 0.5 * nu)
            - 0.5 * (nu + d + 1.0) * _mv_digamma64(d, 0.5 * nu)
            + 0.5 * nu * d)


def _mvn_entropy64(cov):
    d = cov.shape[-1]
    return 0.5 * d * (math.log(2 * math.pi) + 1.0) + 0.5 * _slogdet64(cov)


def a6d_cov_oracle(y, iterations):
    """Phase 22 (c) in float64: (known) the closed-form IW(nu0 + N, I + S)
    and -log p(y) (a matrix-t); (random m) the port's schedule, m then
    Sigma, Sigma starting at its prior, m's messages reading E[Sigma]; (gamma)
    the scale-precision form, m then g, g starting at Gamma(1, 1).  The
    random cells' posteriors and free energy after the last sweep."""
    y = np.asarray(y, np.float64)
    bsz, n, d = y.shape
    nu0, psi0 = d + 3.0, np.eye(d)
    s = np.einsum("bni,bnj->bij", y, y)
    nu, psi = nu0 + n, psi0 + s
    log_z = (-0.5 * n * d * math.log(math.pi) + _mv_lgamma64(d, 0.5 * nu)
             - _mv_lgamma64(d, 0.5 * nu0) + 0.5 * nu0 * _slogdet64(psi0)
             - 0.5 * nu * _slogdet64(psi))
    out = {"known": ({"nu": np.full(bsz, nu), "psi": psi}, -log_z)}

    ysum = y.sum(1)
    eye = np.eye(d)

    def m_update(prec_obs):
        w = eye / 100.0 + n * prec_obs
        v = np.linalg.inv(w)
        return np.einsum("bij,bjk,bk->bi", v, prec_obs, ysum), v

    def scatter(m, v):
        r = y - m[:, None, :]
        return np.einsum("bni,bnj->bij", r, r) + n * v

    nu_q, psi_q = np.full(bsz, nu0), np.broadcast_to(psi0, (bsz, d, d))
    for _ in range(iterations):
        e_sig = psi_q / (nu_q - d - 1.0)[:, None, None]
        m, v = m_update(np.linalg.inv(e_sig))
        c = scatter(m, v)
        nu_q, psi_q = np.full(bsz, nu0 + n), psi0 + c
    e_inv = nu_q[:, None, None] * np.linalg.inv(psi_q)
    e_ld = _slogdet64(psi_q) - d * math.log(2.0) - _mv_digamma64(d, 0.5 * nu_q)
    tr = lambda a_, b_: np.einsum("bij,bji->b", a_, b_)
    ae = (0.5 * (n * d * math.log(2 * math.pi) + n * e_ld + tr(e_inv, c))
          + 0.5 * (d * math.log(2 * math.pi * 100.0)
                   + (np.einsum("bi,bi->b", m, m) + np.trace(v, axis1=1,
                                                            axis2=2)) / 100.0)
          - (-0.5 * (nu0 + d + 1.0) * e_ld - 0.5 * np.trace(e_inv, axis1=1,
                                                             axis2=2)
             - 0.5 * nu0 * d * math.log(2.0) - _mv_lgamma64(d, 0.5 * nu0)))
    fe = ae - _mvn_entropy64(v) - _iw_entropy64(nu_q, psi_q)
    out["random_m"] = ({"m": m, "sigma_mean": psi_q / (nu_q - d - 1.0)[
        :, None, None]}, fe)

    ga, gb = np.ones(bsz), np.ones(bsz)
    for _ in range(iterations):
        m, v = m_update((ga / gb)[:, None, None] * eye)
        tr_c = np.trace(scatter(m, v), axis1=1, axis2=2)
        ga, gb = 1.0 + 0.5 * n * d, 1.0 + 0.5 * tr_c
    eg, elg = ga / gb, digamma64(ga) - np.log(gb)
    ae = (0.5 * (n * d * math.log(2 * math.pi) - n * d * elg + eg * tr_c)
          + 0.5 * (d * math.log(2 * math.pi * 100.0)
                   + (np.einsum("bi,bi->b", m, m) + np.trace(v, axis1=1,
                                                            axis2=2)) / 100.0)
          + eg)
    h_g = ga - np.log(gb) + _lgamma64(ga) + (1.0 - ga) * digamma64(ga)
    out["gamma"] = ({"m": m, "g_a": np.full(bsz, ga), "g_b": gb},
                    ae - _mvn_entropy64(v) - h_g)
    return out


def a6d_sum_data():
    rng = np.random.default_rng(26)
    ab = rng.normal(0.0, 1.0, (SUM_B, 2))
    tree = ab[:, :1] + ab[:, 1:] + 0.5 * rng.standard_normal((SUM_B, 1))
    loopy = (ab[:, :1] + ab[:, 1:]
             + 0.5 * rng.standard_normal((SUM_B, SUM_LOOPY_N)))
    return tree.astype(np.float32), loopy.astype(np.float32)


def a6d_sum_bp64(y, iterations, prior_a=(1.0, 1.0), prior_b=(0.5, 2.0)):
    """Phase 22 (d)'s offset-plus-bias model y ~ N(a + b, 0.25) in float64
    with the port's schedule and cavity store: a, then b, each copy's
    message read from the other term's marginal divided by that copy's
    last message to it.  The marginals and the free energy (the factor's
    mean-field average energy; the pair's structure is not scored, in both
    packages) after the last sweep."""
    y = np.asarray(y, np.float64)
    nat = lambda m, v: (m / v, 1.0 / v)
    qa, qb = nat(*prior_a), nat(*prior_b)
    qa = tuple(np.broadcast_to(x, (len(y), 1)) for x in qa)
    qb = tuple(np.broadcast_to(x, (len(y), 1)) for x in qb)
    msg = {"a": None, "b": None}

    def update(q_other, msg_other, prior):
        cav = q_other if msg_other is None else (
            q_other[0] - msg_other[0], q_other[1] - msg_other[1])
        m_c, v_c = cav[0] / cav[1], 1.0 / cav[1]
        new = tuple(np.broadcast_to(x, y.shape)
                    for x in nat(y - m_c, v_c + 0.25))
        p = nat(*prior)
        return (p[0] + new[0].sum(1, keepdims=True),
                p[1] + new[1].sum(1, keepdims=True)), new

    for _ in range(iterations):
        qa, msg["a"] = update(qb, msg["b"], prior_a)
        qb, msg["b"] = update(qa, msg["a"], prior_b)
    ma, va = qa[0][:, 0] / qa[1][:, 0], 1.0 / qa[1][:, 0]
    mb, vb = qb[0][:, 0] / qb[1][:, 0], 1.0 / qb[1][:, 0]
    c = ((y - ma[:, None] - mb[:, None]) ** 2 + va[:, None]
         + vb[:, None]).sum(1)
    n = y.shape[1]
    ae = (0.5 * (n * math.log(2 * math.pi * 0.25) + c / 0.25)
          + sum(0.5 * (math.log(2 * math.pi * pv) + ((mm - pm) ** 2 + vv)
                       / pv)
                for (pm, pv), mm, vv in ((prior_a, ma, va),
                                         (prior_b, mb, vb))))
    fe = ae - 0.5 * np.log(2 * np.pi * np.e * va) - 0.5 * np.log(
        2 * np.pi * np.e * vb)
    return {"a_mean": ma, "a_var": va, "b_mean": mb, "b_var": vb}, fe


def a6d_lincomb_consts():
    rng = np.random.default_rng(27)
    d = LC_D
    a_mat = (np.eye(d) + 0.2 * rng.standard_normal((d, d))).astype(np.float32)
    b_mat = rng.standard_normal((d, 2)).astype(np.float32)
    r_cov = (0.5 * np.eye(d)).astype(np.float32)
    y = rng.standard_normal((LC_B, d)).astype(np.float32) * 2.0
    return a_mat, b_mat, r_cov, y


def a6d_lincomb_oracle():
    """Phase 22 (d)'s linear combination in closed form (float64): the
    Gaussian posterior of (x, u) and -log p(y)."""
    a_mat, b_mat, r_cov, y = a6d_lincomb_consts()
    d = LC_D
    h = np.concatenate([a_mat, b_mat], 1).astype(np.float64)
    p0 = np.diag([1.0] * d + [2.0, 2.0])
    m0 = np.array([0.0] * d + [1.0, 1.0])
    s = h @ p0 @ h.T + r_cov
    gain = p0 @ h.T @ np.linalg.inv(s)
    r = y.astype(np.float64) - h @ m0
    mean = m0 + r @ gain.T
    cov = p0 - gain @ h @ p0
    log_z = -0.5 * (np.linalg.slogdet(2 * np.pi * s)[1]
                    + np.einsum("bi,ij,bj->b", r, np.linalg.inv(s), r))
    return {"x_mean": mean[:, :d], "u_mean": mean[:, d:],
            "x_cov": cov[:d, :d], "u_cov": cov[d:, d:]}, -log_z


def slice23_checks(wall0: float) -> tuple[list, dict]:
    """Phase 22's float64 closed forms and VMPs in a check process."""
    lines: list = []
    t0 = time.perf_counter()
    out = {"counts": a6d_counts_oracle(),
           "noise": a6d_noise_vmp64(a6d_noise_data(), NOISE_IT),
           "cov": a6d_cov_oracle(a6d_cov_data(), COV_IT),
           "lincomb": a6d_lincomb_oracle()}
    tree, loopy = a6d_sum_data()
    out["sum_tree"] = a6d_sum_bp64(tree, 1)
    out["sum_loopy"] = a6d_sum_bp64(loopy, SUM_IT, (0.0, 1.0), (0.0, 1.0))
    lines.append(f"[a6d check] the float64 closed forms and VMPs of phase "
                 f"22 in {time.perf_counter() - t0:.1f} s")
    _ended(lines, "phase 22 host checks", wall0)
    return lines, out


def a6d_models(rt):
    """Phase 22's models, written once for the port."""
    @rt.model
    def counts(y):
        rate = rt.Gamma(shape=2.0, scale=5.0)
        for i in rt.plate(len(y)):
            y[i] = rt.Poisson(rate)
        return {"rate": rate}

    @rt.model
    def clicks(y, n):
        p = rt.Beta(1.0, 1.0)
        for i in rt.plate(len(y)):
            y[i] = rt.Binomial(n[i], p)
        return {"p": p}

    @rt.model
    def sessions(y, n):
        p = rt.Dirichlet(np.ones(MULT_K, np.float32))
        for i in rt.plate(len(y)):
            y[i] = rt.Multinomial(n[i], p)
        return {"p": p}

    @rt.model
    def noise(y):
        mu = rt.Normal(mean=0.0, var=100.0)
        v = rt.InverseGamma(2.0, 1.0)
        for i in rt.plate(len(y)):
            y[i] = rt.Normal(mean=mu, var=v)
        return {"mu": mu, "v": v}

    eye = np.eye(COV_D, dtype=np.float32)
    zero = np.zeros(COV_D, np.float32)

    @rt.model
    def cov_known(y):
        sig = rt.InverseWishart(COV_D + 3.0, eye)
        for i in rt.plate(len(y)):
            y[i] = rt.MvNormal(mean=zero, cov=sig)
        return {"sig": sig}

    @rt.model
    def cov_random(y):
        sig = rt.InverseWishart(COV_D + 3.0, eye)
        m = rt.MvNormal(mean=zero, cov=100.0 * eye)
        for i in rt.plate(len(y)):
            y[i] = rt.MvNormal(mean=m, cov=sig)
        return {"sig": sig, "m": m}

    @rt.model
    def scale_prec(y):
        m = rt.MvNormal(mean=zero, cov=100.0 * eye)
        g = rt.Gamma(shape=1.0, rate=1.0)
        for i in rt.plate(len(y)):
            y[i] = rt.MvNormal(mean=m, gamma=g)
        return {"m": m, "g": g}

    def offset_bias(prior_a, prior_b):
        @rt.model
        def m(y):
            a = rt.Normal(mean=prior_a[0], var=prior_a[1])
            b = rt.Normal(mean=prior_b[0], var=prior_b[1])
            for i in rt.plate(len(y)):
                y[i] = rt.Normal(mean=a + b, var=0.25)
            return {"a": a, "b": b}
        return m

    a_mat, b_mat, r_cov, _ = a6d_lincomb_consts()

    @rt.model
    def lincomb(y):
        x = rt.MvNormal(mean=np.zeros(LC_D, np.float32),
                        cov=np.eye(LC_D, dtype=np.float32))
        u = rt.MvNormal(mean=np.ones(2, np.float32),
                        cov=2.0 * np.eye(2, dtype=np.float32))
        s = rt.lincomb(a_mat @ x + b_mat @ u)
        y.observe(rt.MvNormal(mean=s, cov=r_cov))
        return {"x": x, "u": u, "s": s}

    return {"counts": counts, "clicks": clicks, "sessions": sessions,
            "noise": noise, "cov_known": cov_known, "cov_random": cov_random,
            "scale_prec": scale_prec,
            "sum_tree": offset_bias((1.0, 1.0), (0.5, 2.0)),
            "sum_loopy": offset_bias((0.0, 1.0), (0.0, 1.0)),
            "lincomb": lincomb}


def _a6d_cell(device, model, data, iterations, init=None):
    """One phase 22 cell through ``infer_batched`` with the free energy,
    its program built by a first call: ``_nl_cell``'s launches (none may
    launch), time, peak memory, device busy and kernels."""
    import torch

    import rxinfer_tpu_torch as rt

    data = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    run = lambda: rt.infer_batched(model, data, iterations=iterations,
                                   initialization=init, free_energy=True,
                                   device=device)
    run()
    return _nl_cell(device, run, reps=1)


def a6d_paths(device, host: dict, smi: str, log=print) -> dict:
    """Phase 22 (a)-(d), every cell with the free energy and every kernel's
    launch count at zero, each against its float64 closed form or float64
    VMP of the port's schedule (``host``) at A6D_TOL relative (posteriors'
    parameters and the free energy after the last sweep); updates/s = B x
    sweeps x the random variables a sweep updates, over the call's time."""
    import torch

    import rxinfer_tpu_torch as rt

    models = a6d_models(rt)
    cpu = lambda t: t.detach().cpu().numpy()
    results: dict = {}

    def gate(tag, label, cell, got, want, fe_want, b, sweeps, nvars,
             extra=""):
        post, fe = cell["out"]
        errs = {k: _rel_max(got[k], want[k]) for k in want}
        # the last sweep's free energy, or every sweep's against a VMP's
        errs["fe"] = _rel_max(cpu(fe if np.ndim(fe_want) == 2 else fe[-1]),
                              fe_want)
        finite = bool(torch.isfinite(fe).all())
        ups = b * sweeps * nvars / (cell["ms"] / 1e3)
        log(f"[a6d] {tag} {label}: call_ms {cell['ms']:.3f} updates_per_s "
            f"{ups:.6g} busy_ms {cell['busy_ms']} idle {cell['idle']} device "
            f"kernels {cell['kernels']} peak_gb "
            f"{cell['peak_bytes'] / 1e9:.3f}; against the float64 reference, "
            f"relative: {errs} (tol {A6D_TOL}){extra}; launches none; {smi}")
        if max(errs.values()) > A6D_TOL or not finite:
            raise AssertionError(f"phase 22 {tag} {label}: {errs}, finite "
                                 f"free energy {finite}")
        results[label] = {"ms": cell["ms"], "updates_per_s": ups,
                          "launches": cell["launches"],
                          "busy_ms": cell["busy_ms"],
                          "kernels": cell["kernels"],
                          "peak_gb": cell["peak_bytes"] / 1e9, "errs": errs}

    # (a) counts
    y, (yb, n), (ym, nm) = a6d_counts_data()
    oc = host["counts"]
    cell = _a6d_cell(device, models["counts"], {"y": y}, 1)
    q = cell["out"][0]["rate"]
    gate("(a)", f"poisson-gamma (B,N)=({CNT_B},{CNT_N})", cell,
         {"a": cpu(q.a), "b": cpu(q.b)}, *oc["poisson"], CNT_B, 1, 1)
    cell = _a6d_cell(device, models["clicks"], {"y": yb, "n": n}, 1)
    q = cell["out"][0]["p"]
    gate("(a)", f"beta-binomial (B,N)=({BIN_B},{BIN_N})", cell,
         {"a": cpu(q.a), "b": cpu(q.b)}, *oc["binomial"], BIN_B, 1, 1)
    cell = _a6d_cell(device, models["sessions"], {"y": ym, "n": nm}, 1)
    q = cell["out"][0]["p"]
    gate("(a)", f"dirichlet-multinomial (B,N,K)=({MULT_B},{MULT_N},"
         f"{MULT_K})", cell, {"alpha": cpu(q.alpha)}, *oc["multinomial"],
         MULT_B, 1, 1)

    # (b) noise levels
    init = {"v": rt.InverseGamma(2.0, 1.0)}
    cell = _a6d_cell(device, models["noise"], {"y": a6d_noise_data()},
                     NOISE_IT, init)
    post = cell["out"][0]
    fe_all = cpu(cell["out"][1])
    # a rise over a sweep, relative to the largest free energy: float32
    # rounding on a dataset whose terms cancel to a free energy near 0
    rise = float(np.max(np.diff(fe_all, axis=0)) / np.abs(fe_all).max())
    gate("(b)", f"noise level (B,N)=({NOISE_B},{NOISE_N}), {NOISE_IT} sweeps",
         cell, {"mu_mean": cpu(post["mu"].mean()),
                "mu_var": cpu(post["mu"].var()), "v_a": cpu(post["v"].a),
                "v_b": cpu(post["v"].b)}, *host["noise"], NOISE_B, NOISE_IT,
         2, extra=f" (the free energy of every sweep); its largest rise over "
                  f"a sweep, relative to the largest: {rise:.3g}")
    if rise > A6D_TOL:
        raise AssertionError(f"phase 22 (b): the free energy rose {rise}")

    # (c) covariances
    yc = a6d_cov_data()
    ov = host["cov"]
    cell = _a6d_cell(device, models["cov_known"], {"y": yc}, 1)
    q = cell["out"][0]["sig"]
    gate("(c)", f"inverse-Wishart, m known (B,N,d)=({COV_B},{COV_N},{COV_D})",
         cell, {"nu": cpu(q.nu), "psi": cpu(q.psi)}, *ov["known"], COV_B, 1,
         1)
    eye = np.eye(COV_D, dtype=np.float32)
    cell = _a6d_cell(device, models["cov_random"], {"y": yc}, COV_IT,
                     {"sig": rt.InverseWishart(COV_D + 3.0, eye)})
    post = cell["out"][0]
    gate("(c)", f"inverse-Wishart, m random, {COV_IT} sweeps", cell,
         {"m": cpu(post["m"].mean()), "sigma_mean": cpu(post["sig"].mean())},
         *ov["random_m"], COV_B, COV_IT, 2)
    cell = _a6d_cell(device, models["scale_prec"], {"y": yc}, COV_IT,
                     {"g": rt.Gamma(shape=1.0, rate=1.0)})
    post = cell["out"][0]
    gate("(c)", f"MvNormal(mean=m, gamma=g), {COV_IT} sweeps", cell,
         {"m": cpu(post["m"].mean()), "g_a": cpu(post["g"].a),
          "g_b": cpu(post["g"].b)}, *ov["gamma"], COV_B, COV_IT, 2)

    # (d) sums
    tree, loopy = a6d_sum_data()
    for label, key, yy, its, init in (
            (f"offset+bias tree (B,N)=({SUM_B},1)", "sum_tree", tree, 1,
             ((1.0, 1.0), (0.5, 2.0))),
            (f"offset+bias loopy (B,N)=({SUM_B},{SUM_LOOPY_N}), {SUM_IT} "
             f"sweeps", "sum_loopy", loopy, SUM_IT,
             ((0.0, 1.0), (0.0, 1.0)))):
        cell = _a6d_cell(device, models[key], {"y": yy}, its, {
            "a": rt.Normal(mean=init[0][0], var=init[0][1]),
            "b": rt.Normal(mean=init[1][0], var=init[1][1])})
        post = cell["out"][0]
        got = {"a_mean": cpu(post["a"].mean()), "a_var": cpu(post["a"].var()),
               "b_mean": cpu(post["b"].mean()), "b_var": cpu(post["b"].var())}
        extra = ""
        if key == "sum_loopy":
            # the conjugate posterior mean of s = a + b (prior N(0, 2))
            s_exact = (yy.astype(np.float64).sum(1) / 0.25) / (
                0.5 + SUM_LOOPY_N / 0.25)
            gap = float(np.abs(got["a_mean"] + got["b_mean"]
                               - s_exact).max())
            extra = f"; E[a + b] against its conjugate posterior: {gap:.3g} " \
                    f"(bound {A6D_SUM_GAP})"
            if gap > A6D_SUM_GAP:
                raise AssertionError(f"phase 22 (d) loopy sum: {gap}")
        gate("(d)", label, cell, got, *host[key], SUM_B, its, 2, extra=extra)
    a_mat, b_mat, r_cov, ylc = a6d_lincomb_consts()
    lc_init = {"x": rt.MvNormal(mean=np.zeros(LC_D, np.float32),
                                cov=np.eye(LC_D, dtype=np.float32)),
               "u": rt.MvNormal(mean=np.ones(2, np.float32),
                                cov=2.0 * np.eye(2, dtype=np.float32))}
    cell = _a6d_cell(device, models["lincomb"], {"y": ylc}, LC_IT, lc_init)
    post = cell["out"][0]
    ol, ofe = host["lincomb"]
    got = {"x_mean": cpu(post["x"].mean()), "u_mean": cpu(post["u"].mean()),
           "x_cov": cpu(post["x"].cov()), "u_cov": cpu(post["u"].cov())}
    want = {k: np.broadcast_to(v, got[k].shape) for k, v in ol.items()}
    gate("(d)", f"lincomb(A x + B u) (B,d)=({LC_B},{LC_D})", cell, got, want,
         ofe, LC_B, LC_IT, 3)
    return results


# -- grid data and latents, logic, Polya, continuous transitions and the affine
# custom-transition pair (phase 23) ------------------------------------------

# Phase 23's cells, plain groups through ``infer`` / ``infer_batched`` with
# the free energy (no kernel launches):
# (a1) z[i, j] ~ N(0, 4), y[i, j] ~ N(z[i, j], 1) over GRID_N stores x
#      GRID_M days on ``infer``, GRID_IT sweeps;
# (a2) a residual a store-day under a mean a store and a shared noise
#      precision (tests/models/test_grid_latents.py:39-73) over GH_B regions
#      of GH_N stores x GH_M days, GH_NAN of y missing, GH_IT sweeps;
# (a3) one conversion rate over CUBE_SHAPE campaigns x regions x days, three
#      nested plates (tests/models/test_nested_plates.py:138-159) on
#      ``infer``;
# (b)  a click-through regression a campaign, y ~ BinomialPolya(x, n, beta)
#      over PG_B campaigns x PG_N rows, d = PG_D features, n = PG_TRIALS,
#      PG_IT sweeps; the two-class MultinomialPolya over MPG_B x PG_N;
# (c)  an emission operator a sensor, y ~ ContinuousTransition(x, vec(A), W)
#      over CT_B sensors x CT_N readings at (dy, dx) = (CT_DY, CT_DX): W
#      known (CT_IT_KNOWN sweeps), W ~ Wishart(dy + 2, I) (CT_IT_RANDOM);
# (d1) the reference's fault tree IMPLY(x1, AND(x2, OR(x3, NOT(x4)))) with
#      tie(x, Bernoulli(y)), y per tree from U(0.05, 0.95), LOGIC_B trees,
#      LOGIC_IT sweeps; (d2) the noisy-OR of tests/models/
#      test_boolean_custom.py over LOGIC_B copies with y in {0, 1};
# (e1) a user node's drifting random walk (DriftWalkT,
#      tests/models/test_custom_transition_chain.py:24-45) over WALK_B
#      datasets of WALK_T steps, WALK_IT sweeps of iterative message passing;
#      (e2) its vector form at d = MVWALK_D over MVWALK_B datasets,
#      MVWALK_IT sweeps.
# The sweeps of (b)-(e) are cut to hold the phase near 10 s on the card
# (each cell runs a timed and a profiled call; the walks converge to their
# RTS within 1e-6 by 30 and 10 sweeps on the CPU): Polya 30 -> 10, (c2)
# 10 -> 5, logic 20 -> 10, (e1) 100 -> 30, (e2) 60 -> 15.
GRID_N, GRID_M, GRID_IT = 1000, 365, 2
GH_B, GH_N, GH_M, GH_IT, GH_NAN = 64, 100, 365, 10, 0.1
CUBE_SHAPE = (1024, 16, 30)
PG_B, PG_N, PG_D, PG_TRIALS, PG_IT = 1024, 1000, 8, 20, 10
MPG_B = 256
CT_B, CT_N, CT_DY, CT_DX = 1024, 200, 4, 8
CT_IT_KNOWN, CT_IT_RANDOM = 5, 5
CT_NOISE = 0.3
LOGIC_B, LOGIC_IT = 10_000, 10
WALK_B, WALK_T, WALK_IT = 1024, 50, 30
WALK_DRIFT, WALK_Q, WALK_R, WALK_V0 = 0.5, 0.3, 0.04, 0.4
MVWALK_B, MVWALK_D, MVWALK_IT = 256, 4, 15
# float32 against each cell's float64 closed form, enumeration, RTS or VMP
# of the port's schedule: the posteriors' parameters and the free energy,
# each relative to its largest value (phase 22's)
A6E_TOL = 1e-4
# the order in which a sweep updates (a2)'s groups and (c)'s (the port's
# schedule, ``CompiledModel.sweep``), which the float64 VMPs follow
GH_ORDER = ("tau", "mu", "z")
CT_ORDER = ("theta", "prec")


def a6e_grid_data():
    """(a1)'s observations: y = z + e, z ~ N(0, 4), e ~ N(0, 1)."""
    rng = np.random.default_rng(230)
    return (np.sqrt(5.0) * rng.standard_normal((GRID_N, GRID_M))).astype(
        np.float32)


def a6e_grid_oracle():
    y = a6e_grid_data().astype(np.float64)
    nlz = float((0.5 * np.log(2 * np.pi * 5.0) + y * y / 10.0).sum())
    return {"mean": y * 0.8, "var": np.full(y.shape, 0.8)}, nlz


def a6e_hier_data():
    """(a2)'s y (GH_B, GH_N, GH_M): store means from N(0, 1.5^2), a
    residual N(0, 1) a store-day, noise 0.3, GH_NAN of the cells NaN."""
    rng = np.random.default_rng(231)
    mu = 1.5 * rng.standard_normal((GH_B, GH_N, 1))
    z = mu + rng.standard_normal((GH_B, GH_N, GH_M))
    y = (z + 0.3 * rng.standard_normal(z.shape)).astype(np.float32)
    y[rng.random(y.shape) < GH_NAN] = np.nan
    return y


def _gauss_entropy64(v):
    return 0.5 * np.log(2 * np.pi * np.e * v)


def _gamma_entropy64(a, b):
    return a - np.log(b) + _lgamma64(a) + (1.0 - a) * digamma64(a)


def a6e_hier_vmp64(y, iterations):
    """(a2)'s updates in float64 in the port's order (GH_ORDER) from
    (a2)'s initialization, tau ~ Gamma(1, 1), mu[i] ~ N(0, 100), z[i, j] ~
    N(0, 1): the Gaussian nodes' rules between z and mu (the other end's
    marginal integrated, as the port's and the JAX package's rules do), the
    conjugate Gamma update of tau; the mean-field free energy after every
    sweep, the last sweep's posteriors."""
    obs = np.isfinite(y)
    yz = np.where(obs, y, 0.0).astype(np.float64)
    n_obs = obs.sum(axis=(1, 2))
    b, n, m = y.shape
    ta, tb = np.ones(b), np.ones(b)
    mm, mv = np.zeros((b, n)), np.full((b, n), 100.0)
    zm, zv = np.zeros((b, n, m)), np.ones((b, n, m))
    fes = []
    for _ in range(iterations):
        for name in GH_ORDER:
            if name == "tau":
                r2 = np.where(obs, (yz - zm) ** 2 + zv, 0.0).sum(axis=(1, 2))
                ta, tb = 1.0 + 0.5 * n_obs, 1.0 + 0.5 * r2
            elif name == "z":
                # the Gaussian node's (out, mean) rule integrates the other
                # end's marginal: N(E[mu], Var[mu] + 1)
                w_mu = 1.0 / (1.0 + mv[:, :, None])
                w = w_mu + obs * (ta / tb)[:, None, None]
                xi = w_mu * mm[:, :, None] + obs * yz * (ta / tb)[:, None,
                                                                 None]
                zm, zv = xi / w, 1.0 / w
            else:
                w_z = 1.0 / (1.0 + zv)
                w = 0.01 + w_z.sum(axis=2)
                mm, mv = (w_z * zm).sum(axis=2) / w, 1.0 / w
        et, elt = ta / tb, digamma64(ta) - np.log(tb)
        r2 = np.where(obs, (yz - zm) ** 2 + zv, 0.0).sum(axis=(1, 2))
        ae = (0.5 * (n_obs * np.log(2 * np.pi) - n_obs * elt + et * r2)
              + 0.5 * (n * m * np.log(2 * np.pi)
                       + (zv + mv[:, :, None]
                          + (zm - mm[:, :, None]) ** 2).sum(axis=(1, 2)))
              + 0.5 * (n * np.log(2 * np.pi * 100.0)
                       + (mv + mm * mm).sum(axis=1) / 100.0)
              + et)
        h = (_gauss_entropy64(zv).sum(axis=(1, 2))
             + _gauss_entropy64(mv).sum(axis=1) + _gamma_entropy64(ta, tb))
        fes.append(ae - h)
    post = {"tau_a": ta, "tau_b": tb, "mu_mean": mm, "mu_var": mv,
            "z_mean": zm, "z_var": zv}
    return post, np.stack(fes)


def a6e_cube_data():
    rng = np.random.default_rng(232)
    return (rng.random(CUBE_SHAPE) < 0.05).astype(np.float32)


def a6e_cube_oracle():
    y = a6e_cube_data()
    h, n = float(y.sum(dtype=np.float64)), float(y.size)
    a, b = 1.0 + h, 1.0 + n - h
    nlz = -float(_lgamma64(a) + _lgamma64(b) - _lgamma64(a + b))
    return {"a": np.float64(a), "b": np.float64(b)}, nlz


def a6e_polya_data(b: int, multi: bool = False):
    """(b)'s features x (b, PG_N, PG_D) and successes of PG_TRIALS trials
    under beta ~ N(0, 0.5^2 I) a campaign (two counts a row for the
    MultinomialPolya)."""
    rng = np.random.default_rng(233 + int(multi))
    x = rng.standard_normal((b, PG_N, PG_D)).astype(np.float32)
    beta = 0.5 * rng.standard_normal((b, PG_D, 1))
    p = 1.0 / (1.0 + np.exp(-(x.astype(np.float64) @ beta)[..., 0]))
    y = rng.binomial(PG_TRIALS, p).astype(np.float32)
    if multi:
        y = np.stack([y, PG_TRIALS - y], axis=-1).astype(np.float32)
    return x, y


def a6e_polya_vmp64(x, y, iterations):
    """The Polya-Gamma VMP of (b) in float64: beta ~ N(0, 10 I), q(beta)
    from N(0, I); every sweep E[omega] from the last q(beta), the Gaussian
    update, and the free energy (the prior's energy, every row's bound, -H
    of q(beta))."""
    x = x.astype(np.float64)
    y = (y[..., 0] if y.ndim == 3 else y).astype(np.float64)
    n = float(PG_TRIALS)
    b, _, d = x.shape
    mean, cov = np.zeros((b, d)), np.broadcast_to(np.eye(d), (b, d, d))
    log_binom = (_log_factorial64(np.full(y.shape, n)) - _log_factorial64(y)
                 - _log_factorial64(n - y))
    xi = np.matmul((y - 0.5 * n)[:, None, :], x)[:, 0]

    def moments(mean, cov):
        m = np.matmul(x, mean[..., None])[..., 0]
        v = (np.matmul(x, cov) * x).sum(-1)
        c = np.sqrt(np.maximum(m * m + v, 1e-12))
        om = np.where(c < 1e-4, n / 4.0, n / (2.0 * c) * np.tanh(c / 2.0))
        return m, c, om

    fes = []
    for _ in range(iterations):
        _, _, om = moments(mean, cov)
        w = np.eye(d) / 10.0 + np.matmul(
            np.swapaxes(om[..., None] * x, 1, 2), x)
        cov = np.linalg.inv(w)
        mean = np.einsum("bij,bj->bi", cov, xi)
        m, c, _ = moments(mean, cov)
        ae = -(log_binom + (y - 0.5 * n) * m - n * np.logaddexp(0.0, c)
               + 0.5 * n * c).sum(axis=1)
        ae = ae + 0.5 * (d * np.log(2 * np.pi * 10.0)
                         + (np.trace(cov, axis1=1, axis2=2)
                            + (mean * mean).sum(1)) / 10.0)
        h = 0.5 * d * (np.log(2 * np.pi) + 1.0) + 0.5 * _slogdet64(cov)
        fes.append(ae - h)
    return {"mean": mean, "cov": cov}, np.stack(fes)


def a6e_ct_data():
    """(c)'s inputs x (CT_B, CT_N, CT_DX) and outputs y = A x + e, A
    (CT_DY, CT_DX) a sensor from N(0, 1 / dx), e ~ N(0, CT_NOISE^2 I)."""
    rng = np.random.default_rng(235)
    a = rng.standard_normal((CT_B, CT_DY, CT_DX)) / np.sqrt(CT_DX)
    x = rng.standard_normal((CT_B, CT_N, CT_DX))
    y = np.einsum("bij,bnj->bni", a, x) + CT_NOISE * rng.standard_normal(
        (CT_B, CT_N, CT_DY))
    return x.astype(np.float32), y.astype(np.float32)


def _ct_stats(x, y):
    x, y = x.astype(np.float64), y.astype(np.float64)
    return (np.einsum("bni,bnj->bij", x, x), np.einsum("bni,bnj->bij", y, x),
            np.einsum("bni,bnj->bij", y, y))


def _ct_theta(w, sxx, syx):
    """q(theta) of one update at E[W] = ``w``: the prior N(0, 10 I) times
    every reading's message (precision W kron x x^T, row-major vec)."""
    b, dy, dx = syx.shape
    lam = np.eye(dy * dx) / 10.0 + np.einsum("bik,bjl->bijkl", w, sxx
                                             ).reshape(b, dy * dx, dy * dx)
    eta = np.einsum("bij,bjk->bik", w, syx).reshape(b, dy * dx)
    cov = np.linalg.inv(lam)
    return np.einsum("bij,bj->bi", cov, eta), cov, lam, eta


def _ct_scatter(mean, cov, sxx, syx, syy):
    """sum over the readings of E[(y - A x)(y - A x)^T] under q(theta)."""
    b, dy, dx = syx.shape
    a = mean.reshape(b, dy, dx)
    s = (syy - np.einsum("bij,bkj->bik", syx, a)
         - np.einsum("bij,bkj->bik", a, syx)
         + np.einsum("bij,bjk,blk->bil", a, sxx, a))
    tc = cov.reshape(b, dy, dx, dy, dx)
    return s + np.einsum("bijkl,bjl->bik", tc, sxx)


def _ct_theta_fe_terms(mean, cov):
    d = mean.shape[-1]
    ae = 0.5 * (d * np.log(2 * np.pi * 10.0)
                + (np.trace(cov, axis1=1, axis2=2) + (mean * mean).sum(1))
                / 10.0)
    h = 0.5 * d * (np.log(2 * np.pi) + 1.0) + 0.5 * _slogdet64(cov)
    return ae, h


def a6e_ct_known_oracle():
    """(c1) in closed form: the posterior of vec(A) at W = I / CT_NOISE^2
    and -log p(y) of the linear-Gaussian model."""
    x, y = a6e_ct_data()
    sxx, syx, syy = _ct_stats(x, y)
    w = np.broadcast_to(np.eye(CT_DY) / CT_NOISE ** 2, (CT_B, CT_DY, CT_DY))
    mean, cov, lam, eta = _ct_theta(w, sxx, syx)
    dth = CT_DY * CT_DX
    nlz = 0.5 * (np.trace(syy, axis1=1, axis2=2) / CT_NOISE ** 2
                 - np.einsum("bi,bi->b", eta, mean)
                 + _slogdet64(lam) - dth * np.log(0.1)
                 + CT_N * CT_DY * np.log(2 * np.pi * CT_NOISE ** 2))
    return {"mean": mean, "cov": cov}, nlz


def _wishart_elogdet64(nu, s):
    d = s.shape[-1]
    return _mv_digamma64(d, nu / 2.0) + d * np.log(2.0) + _slogdet64(s)


def a6e_ct_random_vmp64(iterations):
    """(c2) by mean-field VMP in float64 in the port's order (CT_ORDER)
    from q(theta) = N(0, I), q(W) = Wishart(dy + 2, I): the free energy of
    every sweep and the last posteriors."""
    x, y = a6e_ct_data()
    sxx, syx, syy = _ct_stats(x, y)
    d = CT_DY
    nu0 = d + 2.0
    dth = CT_DY * CT_DX
    mean = np.zeros((CT_B, dth))
    cov = np.broadcast_to(np.eye(dth), (CT_B, dth, dth))
    nu, s = np.full(CT_B, nu0), np.broadcast_to(np.eye(d), (CT_B, d, d))
    fes = []
    for _ in range(iterations):
        for name in CT_ORDER:
            if name == "theta":
                mean, cov, _, _ = _ct_theta(nu[:, None, None] * s, sxx, syx)
            else:
                c = _ct_scatter(mean, cov, sxx, syx, syy)
                nu, s = np.full(CT_B, nu0 + CT_N), np.linalg.inv(np.eye(d) + c)
        ew, elw = nu[:, None, None] * s, _wishart_elogdet64(nu, s)
        c = _ct_scatter(mean, cov, sxx, syx, syy)
        ae_lik = 0.5 * (CT_N * d * np.log(2 * np.pi) - CT_N * elw
                        + np.einsum("bij,bji->b", ew, c))
        ae_w = -(0.5 * (nu0 - d - 1) * elw
                 - 0.5 * np.trace(ew, axis1=1, axis2=2)
                 - 0.5 * nu0 * d * np.log(2.0) - _mv_lgamma64(d, nu0 / 2.0))
        h_w = (0.5 * (d + 1) * _slogdet64(s) + 0.5 * d * (d + 1) * np.log(2.0)
               + _mv_lgamma64(d, nu / 2.0)
               - 0.5 * (nu - d - 1) * _mv_digamma64(d, nu / 2.0)
               + 0.5 * nu * d)
        ae_t, h_t = _ct_theta_fe_terms(mean, cov)
        fes.append(ae_lik + ae_w + ae_t - h_w - h_t)
    return {"mean": mean, "cov": cov, "w_mean": nu[:, None, None] * s}, \
        np.stack(fes)


def a6e_logic_data():
    """(d1)'s soft evidence y a tree and (d2)'s observed effect a copy."""
    rng = np.random.default_rng(236)
    return (rng.uniform(0.05, 0.95, LOGIC_B).astype(np.float32),
            (rng.random(LOGIC_B) < 0.5).astype(np.float32))


def a6e_logic_oracle():
    """float64 enumeration: (d1) the marginals of x1..x4 and x and -log Z
    over the 2^4 input states; (d2) q(a), q(b) and -log P(y) over 2^2."""
    y1, y2 = (v.astype(np.float64) for v in a6e_logic_data())
    z, marg = 0.0, np.zeros((5, LOGIC_B))
    for s in range(16):
        x1, x2, x3, x4 = [(s >> k) & 1 for k in range(4)]
        x = int((not x1) or (x2 and (x3 or not x4)))
        w = 0.5 ** 4 * (y1 if x else 1.0 - y1)
        z = z + w
        marg += w * np.array([x1, x2, x3, x4, x], np.float64)[:, None]
    tree = {k: marg[i] / z for i, k in enumerate(("x1", "x2", "x3", "x4",
                                                    "x"))}
    z2, qa, qb = 0.0, 0.0, 0.0
    for a in (0, 1):
        for b in (0, 1):
            w = (0.3 if a else 0.7) * (0.1 if b else 0.9)
            w = w * (y2 if (a or b) else 1.0 - y2)
            z2, qa, qb = z2 + w, qa + a * w, qb + b * w
    return (tree, -np.log(z)), ({"a": qa / z2, "b": qb / z2}, -np.log(z2))


def a6e_walk_data():
    """(e1)'s observations (WALK_B, WALK_T) of a random walk with drift."""
    rng = np.random.default_rng(237)
    x = WALK_DRIFT + np.sqrt(WALK_V0) * rng.standard_normal((WALK_B, 1))
    x = x + np.concatenate([np.zeros((WALK_B, 1)), np.cumsum(
        WALK_DRIFT + np.sqrt(WALK_Q) * rng.standard_normal(
            (WALK_B, WALK_T - 1)), axis=1)], axis=1)
    return (x + np.sqrt(WALK_R) * rng.standard_normal(x.shape)).astype(
        np.float32)


def a6e_mvwalk_consts():
    """(e2)'s transition out = A in + b + N(0, Q) at d = MVWALK_D, the
    observation noise R and the prior N(0, P0)."""
    d = MVWALK_D
    th = 0.3
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    a = np.zeros((d, d))
    a[:2, :2], a[2:, 2:], a[0, 2] = 0.97 * rot, 0.9 * rot.T, 0.1
    rng = np.random.default_rng(238)
    l_ = 0.2 * rng.standard_normal((d, d))
    q = l_ @ l_.T + 0.1 * np.eye(d)
    b = np.array([0.2, -0.1, 0.05, 0.1])
    return (a.astype(np.float32), b.astype(np.float32), q.astype(np.float32),
            (0.05 * np.eye(d)).astype(np.float32), np.eye(d, dtype=np.float32))


def a6e_mvwalk_data():
    a, b, q, r, p0 = (m.astype(np.float64) for m in a6e_mvwalk_consts())
    rng = np.random.default_rng(239)
    d = MVWALK_D
    x = rng.standard_normal((MVWALK_B, d)) @ np.linalg.cholesky(p0).T
    ys = []
    for t in range(WALK_T):
        if t:
            x = x @ a.T + b + rng.standard_normal((MVWALK_B, d)) @ \
                np.linalg.cholesky(q).T
        ys.append(x + rng.standard_normal((MVWALK_B, d)) @
                  np.linalg.cholesky(r).T)
    return np.stack(ys, axis=1).astype(np.float32)


def _kalman_rts64(y, m0, p0, a, b, q, r):
    """float64 Kalman filter and RTS smoother of x_t = A x_{t-1} + b +
    N(0, Q), y_t = x_t + N(0, R) over a batch y (B, T, d): the smoothed
    means and covariances and -log p(y)."""
    bsz, t_len, d = y.shape
    fm, fp = np.zeros((bsz, t_len, d)), np.zeros((bsz, t_len, d, d))
    m, p = np.broadcast_to(m0, (bsz, d)), np.broadcast_to(p0, (bsz, d, d))
    nlz = np.zeros(bsz)
    for t in range(t_len):
        if t:
            m, p = m @ a.T + b, a @ p @ a.T + q
        s = p + r
        e = y[:, t] - m
        sol = np.linalg.solve(s, e[..., None])[..., 0]
        nlz += 0.5 * (d * np.log(2 * np.pi) + _slogdet64(s)
                      + (e * sol).sum(-1))
        k = np.linalg.solve(s, p)          # S^-1 P = K^T (symmetric S, P)
        m = m + np.einsum("bji,bj->bi", k, e)
        p = p - np.swapaxes(k, 1, 2) @ p
        fm[:, t], fp[:, t] = m, p
    sm, sp = fm.copy(), fp.copy()
    for t in range(t_len - 2, -1, -1):
        pp = a @ fp[:, t] @ a.T + q
        g = fp[:, t] @ a.T @ np.linalg.inv(pp)
        sm[:, t] = fm[:, t] + np.einsum("bij,bj->bi", g, sm[:, t + 1] - (
            fm[:, t] @ a.T + b))
        sp[:, t] = fp[:, t] + g @ (sp[:, t + 1] - pp) @ np.swapaxes(g, 1, 2)
    return sm, sp, nlz


def a6e_walk_oracle():
    y = a6e_walk_data().astype(np.float64)[..., None]
    one = np.ones((1, 1))
    sm, sp, nlz = _kalman_rts64(y, np.array([WALK_DRIFT]), WALK_V0 * one, one,
                                np.array([WALK_DRIFT]), WALK_Q * one,
                                WALK_R * one)
    return {"mean": sm[..., 0], "var": sp[..., 0, 0]}, nlz


def a6e_mvwalk_oracle():
    a, b, q, r, p0 = (m.astype(np.float64) for m in a6e_mvwalk_consts())
    sm, sp, nlz = _kalman_rts64(a6e_mvwalk_data().astype(np.float64),
                                np.zeros(MVWALK_D), p0, a, b, q, r)
    return {"mean": sm, "cov": sp}, nlz


def slice24_checks(wall0: float) -> tuple[list, dict]:
    """Phase 23's float64 closed forms, enumerations, RTS smoothers and
    VMPs in a check process."""
    lines: list = []
    t0 = time.perf_counter()
    out = {"grid": a6e_grid_oracle(),
           "hier": a6e_hier_vmp64(a6e_hier_data(), GH_IT),
           "cube": a6e_cube_oracle(),
           "polya": a6e_polya_vmp64(*a6e_polya_data(PG_B), PG_IT),
           "mpolya": a6e_polya_vmp64(*a6e_polya_data(MPG_B, True), PG_IT),
           "ct_known": a6e_ct_known_oracle(),
           "ct_random": a6e_ct_random_vmp64(CT_IT_RANDOM),
           "logic": a6e_logic_oracle(), "walk": a6e_walk_oracle(),
           "mvwalk": a6e_mvwalk_oracle()}
    lines.append(f"[a6e check] the float64 references of phase 23 in "
                 f"{time.perf_counter() - t0:.1f} s")
    _ended(lines, "phase 23 host checks", wall0)
    return lines, out


def a6e_models(rt):
    """Phase 23's models, written once for the port, and the user nodes of
    (e) registered in its rule registry."""
    import torch

    from rxinfer_tpu_torch.rules.registry import node

    @rt.model
    def grid(y):
        z = rt.latent((GRID_N, GRID_M), name="z")
        for i in rt.plate(GRID_N):
            for j in rt.plate(GRID_M):
                z[i, j] = rt.Normal(mean=0.0, var=4.0)
                y[i, j] = rt.Normal(mean=z[i, j], var=1.0)
        return {"z": z}

    @rt.model
    def hier(y):
        tau = rt.Gamma(shape=1.0, rate=1.0)
        mu = rt.latent(GH_N, name="mu")
        for i in rt.plate(GH_N):
            mu[i] = rt.Normal(mean=0.0, var=100.0)
        z = rt.latent((GH_N, GH_M), name="z")
        for i in rt.plate(GH_N):
            for j in rt.plate(GH_M):
                z[i, j] = rt.Normal(mean=mu[i], precision=1.0)
                y[i, j] = rt.Normal(mean=z[i, j], precision=tau)
        return {"mu": mu, "z": z, "tau": tau}

    @rt.model
    def cube(y):
        theta = rt.Beta(1.0, 1.0)
        for i in rt.plate(CUBE_SHAPE[0]):
            for j in rt.plate(CUBE_SHAPE[1]):
                for k in rt.plate(CUBE_SHAPE[2]):
                    y[i, j, k] = rt.Bernoulli(theta)
        return {"theta": theta}

    def polya(fform):
        @rt.model
        def m(x, y):
            beta = rt.MvNormal(mean=np.zeros(PG_D, np.float32),
                               cov=10.0 * np.eye(PG_D, dtype=np.float32))
            for i in rt.plate(PG_N):
                y[i] = getattr(rt, fform)(x[i], float(PG_TRIALS), beta)
            return {"beta": beta}
        return m

    dth = CT_DY * CT_DX

    def ctrans(known):
        w = np.float32(np.eye(CT_DY) / CT_NOISE ** 2)

        @rt.model
        def m(x, y):
            theta = rt.MvNormal(mean=np.zeros(dth, np.float32),
                                cov=10.0 * np.eye(dth, dtype=np.float32))
            prec = w if known else rt.Wishart(
                CT_DY + 2.0, np.eye(CT_DY, dtype=np.float32))
            for i in rt.plate(CT_N):
                y[i] = rt.ContinuousTransition(x[i], theta, prec)
            return {"theta": theta} if known else {"theta": theta,
                                                   "prec": prec}
        return m

    @rt.model
    def fault_tree(y):
        x1 = rt.Bernoulli(0.5)
        x2 = rt.Bernoulli(0.5)
        x3 = rt.Bernoulli(0.5)
        x4 = rt.Bernoulli(0.5)
        x = rt.IMPLY(x1, rt.AND(x2, rt.OR(x3, rt.NOT(x4))))
        rt.tie(x, rt.Bernoulli(y))
        return {"x1": x1, "x2": x2, "x3": x3, "x4": x4, "x": x}

    @rt.model
    def noisy_or(y):
        a = rt.Bernoulli(0.3)
        b = rt.Bernoulli(0.1)
        y.observe(rt.OR(a, b))
        return {"a": a, "b": b}

    @node("DriftWalkT")
    class DriftWalkT:
        """out ~ N(in + WALK_DRIFT, WALK_Q)."""

        interfaces = ("out", "in")
        cavity_cluster = ("out", "in")

        @staticmethod
        def message_to_out(q):
            m = q["in"]
            return rt.NormalMeanVariance(m.mean() + WALK_DRIFT,
                                         m.var() + WALK_Q)

        @staticmethod
        def message_to_in(q):
            m = q["out"]
            return rt.NormalMeanVariance(m.mean() - WALK_DRIFT,
                                         m.var() + WALK_Q)

        @staticmethod
        def average_energy(q):
            mo, vo = q["out"].mean(), q["out"].var()
            mi, vi = q["in"].mean(), q["in"].var()
            return 0.5 * (math.log(2 * math.pi * WALK_Q)
                          + ((mo - mi - WALK_DRIFT) ** 2 + vo + vi) / WALK_Q)

    a4, b4, q4, r4, p4 = a6e_mvwalk_consts()
    a4_inv = np.linalg.inv(a4).astype(np.float32)

    @node("MvDriftWalkT")
    class MvDriftWalkT:
        """out ~ N(A in + b, Q) at d = MVWALK_D."""

        interfaces = ("out", "in")
        cavity_cluster = ("out", "in")

        @staticmethod
        def message_to_out(q):
            m = q["in"]
            dev = m.mean().device
            a, b, qq = (torch.as_tensor(v, device=dev) for v in (a4, b4, q4))
            return rt.MvNormalMeanCovariance(
                torch.einsum("ij,...j->...i", a, m.mean()) + b,
                torch.einsum("ij,...jk,lk->...il", a, m.cov(), a) + qq)

        @staticmethod
        def message_to_in(q):
            m = q["out"]
            dev = m.mean().device
            ai, b, qq = (torch.as_tensor(v, device=dev)
                         for v in (a4_inv, b4, q4))
            return rt.MvNormalMeanCovariance(
                torch.einsum("ij,...j->...i", ai, m.mean() - b),
                torch.einsum("ij,...jk,lk->...il", ai, m.cov() + qq, ai))

        @staticmethod
        def average_energy(q):
            return 0.0 * q["out"].mean()[..., 0]

    @rt.model
    def walk(y):
        x = rt.latent(WALK_T, name="x")
        x[0] = rt.Normal(mean=WALK_DRIFT, var=WALK_V0)
        for t in rt.plate(1, WALK_T):
            x[t] = rt.factor_node("DriftWalkT", **{"in": x[t - 1]})
        for t in rt.plate(WALK_T):
            y[t] = rt.Normal(mean=x[t], var=WALK_R)
        return {"x": x}

    @rt.model
    def mvwalk(y):
        x = rt.latent(WALK_T, name="x")
        x[0] = rt.MvNormal(mean=np.zeros(MVWALK_D, np.float32), cov=p4)
        for t in rt.plate(1, WALK_T):
            x[t] = rt.factor_node("MvDriftWalkT", **{"in": x[t - 1]})
        for t in rt.plate(WALK_T):
            y[t] = rt.MvNormal(mean=x[t], cov=r4)
        return {"x": x}

    return {"grid": grid, "hier": hier, "cube": cube,
            "polya": polya("BinomialPolya"),
            "mpolya": polya("MultinomialPolya"),
            "ct_known": ctrans(True), "ct_random": ctrans(False),
            "fault_tree": fault_tree, "noisy_or": noisy_or, "walk": walk,
            "mvwalk": mvwalk}


def _a6e_cell(device, model, data, iterations, init=None, batched=True):
    """One phase 23 cell with the free energy through ``infer_batched`` (or
    ``infer`` on one dataset): its program built beforehand (by
    ``batched_program``; ``infer``'s by a first call), then ``_nl_cell``'s
    launches (none may launch), time, peak memory, device busy and
    kernels.  ``out`` is (posteriors, free energy (iterations, B) or
    (iterations,))."""
    import warnings

    import torch

    import rxinfer_tpu_torch as rt

    data = {k: torch.as_tensor(v, device=device) for k, v in data.items()}

    def run():
        with warnings.catch_warnings():
            # the custom chains warn that they have no chain solver
            warnings.simplefilter("ignore")
            if batched:
                return rt.infer_batched(model, data, iterations=iterations,
                                        initialization=init,
                                        free_energy=True, device=device)
            res = rt.infer(model=model, data=data, iterations=iterations,
                           initialization=init, free_energy=True,
                           returnvars=rt.KeepLast(), device=device)
            return res.posteriors, res.free_energy

    if batched:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rt.batched_program(model, data, iterations=iterations,
                               initialization=init, free_energy=True,
                               device=device)
    else:
        run()
    return _nl_cell(device, run, reps=1)


def a6e_paths(device, host: dict, smi: str, log=print) -> dict:
    """Phase 23 (a)-(e), every cell with the free energy and every kernel's
    launch count at zero, each against its float64 closed form,
    enumeration, RTS smoother or VMP of the port's schedule (``host``) at
    A6E_TOL relative (the posteriors and the free energy after the last
    sweep, or after every sweep against a VMP); updates/s = datasets x
    sweeps x the variable slots a sweep updates, over the call's time."""
    import torch

    import rxinfer_tpu_torch as rt

    models = a6e_models(rt)
    cpu = lambda t: t.detach().cpu().numpy()
    results: dict = {}

    def gate(tag, label, cell, got, want, fe_want, b, sweeps, slots,
             extra=""):
        post, fe = cell["out"]
        errs = {k: _rel_max(got[k], want[k]) for k in want}
        errs["fe"] = _rel_max(cpu(fe if np.ndim(fe_want) == 2 else fe[-1]),
                              fe_want)
        finite = bool(torch.isfinite(fe).all())
        ups = b * sweeps * slots / (cell["ms"] / 1e3)
        log(f"[a6e] {tag} {label}: call_ms {cell['ms']:.3f} updates_per_s "
            f"{ups:.6g} busy_ms {cell['busy_ms']} idle {cell['idle']} device "
            f"kernels {cell['kernels']} peak_gb "
            f"{cell['peak_bytes'] / 1e9:.3f}; against the float64 reference, "
            f"relative: {errs} (tol {A6E_TOL}){extra}; launches none; {smi}")
        if max(errs.values()) > A6E_TOL or not finite:
            raise AssertionError(f"phase 23 {tag} {label}: {errs}, finite "
                                 f"free energy {finite}")
        results[label] = {"ms": cell["ms"], "updates_per_s": ups,
                          "launches": cell["launches"],
                          "busy_ms": cell["busy_ms"],
                          "kernels": cell["kernels"],
                          "peak_gb": cell["peak_bytes"] / 1e9, "errs": errs}

    # (a) grids
    want, nlz = host["grid"]
    cell = _a6e_cell(device, models["grid"], {"y": a6e_grid_data()}, GRID_IT,
                     batched=False)
    q = cell["out"][0]["z"]
    gate("(a1)", f"grid latent (N,M)=({GRID_N},{GRID_M}) on infer", cell,
         {"mean": cpu(q.mean()), "var": cpu(q.var())}, want, nlz, 1, GRID_IT,
         GRID_N * GRID_M)
    compiled, _ = rt.batched_program(
        models["hier"], {"y": np.zeros((1, GH_N, GH_M), np.float32)},
        iterations=1, initialization=a6e_hier_init(rt), device="cpu")
    if tuple(compiled.sweep) != GH_ORDER:
        raise AssertionError(f"phase 23 (a2): the port's sweep "
                             f"{compiled.sweep} is not the oracle's "
                             f"{GH_ORDER}")
    ow, ofe = host["hier"]
    cell = _a6e_cell(device, models["hier"], {"y": a6e_hier_data()}, GH_IT,
                     a6e_hier_init(rt))
    post = cell["out"][0]
    gate("(a2)", f"grid hierarchy (B,N,M)=({GH_B},{GH_N},{GH_M}), "
         f"{GH_NAN:.0%} missing, {GH_IT} sweeps", cell,
         {"tau_a": cpu(post["tau"].a), "tau_b": cpu(post["tau"].b),
          "mu_mean": cpu(post["mu"].mean()), "mu_var": cpu(post["mu"].var()),
          "z_mean": cpu(post["z"].mean()), "z_var": cpu(post["z"].var())},
         ow, ofe, GH_B, GH_IT, 2 * GH_N * GH_M + GH_N + 2,
         extra=" (the free energy of every sweep)")
    want, nlz = host["cube"]
    cell = _a6e_cell(device, models["cube"], {"y": a6e_cube_data()}, 1,
                     batched=False)
    q = cell["out"][0]["theta"]
    gate("(a3)", f"three-axis Beta-Bernoulli {CUBE_SHAPE} on infer", cell,
         {"a": cpu(q.a), "b": cpu(q.b)}, want, nlz, 1, 1, 1)

    # (b) Polya regressions
    pinit = {"beta": rt.MvNormalMeanCovariance(
        torch.zeros(PG_D), torch.eye(PG_D))}
    for key, b, label in (
            ("polya", PG_B, f"BinomialPolya (B,N,d)=({PG_B},{PG_N},{PG_D}), "
             f"n={PG_TRIALS}, {PG_IT} sweeps"),
            ("mpolya", MPG_B, f"MultinomialPolya K=2 (B,N,d)=({MPG_B},"
             f"{PG_N},{PG_D}), {PG_IT} sweeps")):
        x, y = a6e_polya_data(b, key == "mpolya")
        cell = _a6e_cell(device, models[key], {"x": x, "y": y}, PG_IT, pinit)
        q = cell["out"][0]["beta"]
        ow, ofe = host[key]
        gate("(b)", label, cell, {"mean": cpu(q.mean()), "cov": cpu(q.cov())},
             ow, ofe, b, PG_IT, 1,
             extra=" (the free energy of every sweep)")

    # (c) continuous transitions
    x, y = a6e_ct_data()
    dth = CT_DY * CT_DX
    tinit = {"theta": rt.MvNormalMeanCovariance(torch.zeros(dth),
                                                torch.eye(dth))}
    cell = _a6e_cell(device, models["ct_known"], {"x": x, "y": y},
                     CT_IT_KNOWN, tinit)
    q = cell["out"][0]["theta"]
    ow, nlz = host["ct_known"]
    gate("(c1)", f"ContinuousTransition W known (B,N,dy,dx)=({CT_B},{CT_N},"
         f"{CT_DY},{CT_DX}), {CT_IT_KNOWN} sweeps", cell,
         {"mean": cpu(q.mean()), "cov": cpu(q.cov())}, ow, nlz, CT_B,
         CT_IT_KNOWN, 1)
    compiled, _ = rt.batched_program(
        models["ct_random"], {"x": x[:1], "y": y[:1]}, iterations=1,
        initialization=a6e_ct_init(rt), device="cpu")
    if tuple(compiled.sweep) != CT_ORDER:
        raise AssertionError(f"phase 23 (c2): the port's sweep "
                             f"{compiled.sweep} is not the oracle's "
                             f"{CT_ORDER}")
    cell = _a6e_cell(device, models["ct_random"], {"x": x, "y": y},
                     CT_IT_RANDOM, a6e_ct_init(rt))
    post = cell["out"][0]
    ow, ofe = host["ct_random"]
    gate("(c2)", f"ContinuousTransition W ~ Wishart(dy + 2, I), "
         f"{CT_IT_RANDOM} sweeps", cell,
         {"mean": cpu(post["theta"].mean()), "cov": cpu(post["theta"].cov()),
          "w_mean": cpu(post["prec"].mean())}, ow, ofe, CT_B, CT_IT_RANDOM, 2,
         extra=" (the free energy of every sweep)")

    # (d) logic
    y1, y2 = a6e_logic_data()
    (tree, nlz1), (nor, nlz2) = host["logic"]
    names = ("x1", "x2", "x3", "x4", "x")
    cell = _a6e_cell(device, models["fault_tree"], {"y": y1}, LOGIC_IT,
                     {k: rt.Bernoulli(0.5) for k in names})
    post = cell["out"][0]
    gate("(d1)", f"fault tree with tie (B={LOGIC_B}), {LOGIC_IT} sweeps",
         cell, {k: cpu(post[k].mean()) for k in names}, tree, nlz1, LOGIC_B,
         LOGIC_IT, len(names))
    cell = _a6e_cell(device, models["noisy_or"], {"y": y2}, LOGIC_IT,
                     {"a": rt.Bernoulli(0.3), "b": rt.Bernoulli(0.1)})
    post = cell["out"][0]
    gate("(d2)", f"noisy-OR (B={LOGIC_B}), {LOGIC_IT} sweeps", cell,
         {k: cpu(post[k].mean()) for k in ("a", "b")}, nor, nlz2, LOGIC_B,
         LOGIC_IT, 2)

    # (e) the affine custom-transition pair
    ow, nlz = host["walk"]
    cell = _a6e_cell(device, models["walk"], {"y": a6e_walk_data()}, WALK_IT,
                     {"x": rt.NormalMeanVariance(torch.tensor(0.0),
                                                 torch.tensor(10.0))})
    q = cell["out"][0]["x"]
    gate("(e1)", f"DriftWalkT (B,T)=({WALK_B},{WALK_T}), {WALK_IT} sweeps",
         cell, {"mean": cpu(q.mean()), "var": cpu(q.var())}, ow, nlz, WALK_B,
         WALK_IT, WALK_T)
    ow, nlz = host["mvwalk"]
    cell = _a6e_cell(device, models["mvwalk"], {"y": a6e_mvwalk_data()},
                     MVWALK_IT, {"x": rt.MvNormalMeanCovariance(
                         torch.zeros(MVWALK_D), 10.0 * torch.eye(MVWALK_D))})
    q = cell["out"][0]["x"]
    gate("(e2)", f"MvDriftWalkT (B,T,d)=({MVWALK_B},{WALK_T},{MVWALK_D}), "
         f"{MVWALK_IT} sweeps", cell,
         {"mean": cpu(q.mean()), "cov": cpu(q.cov())}, ow, nlz, MVWALK_B,
         MVWALK_IT, WALK_T)
    return results


def a6e_hier_init(rt):
    """(a2)'s initialization, which ``a6e_hier_vmp64`` starts from."""
    import torch

    return {"tau": rt.GammaShapeRate(torch.tensor(1.0), torch.tensor(1.0)),
            "mu": rt.NormalMeanVariance(torch.tensor(0.0),
                                        torch.tensor(100.0)),
            "z": rt.NormalMeanVariance(torch.tensor(0.0), torch.tensor(1.0))}


def a6e_ct_init(rt):
    """(c2)'s initialization, which ``a6e_ct_random_vmp64`` starts from."""
    import torch

    dth = CT_DY * CT_DX
    return {"theta": rt.MvNormalMeanCovariance(torch.zeros(dth),
                                               torch.eye(dth)),
            "prec": rt.Wishart(torch.tensor(CT_DY + 2.0), torch.eye(CT_DY))}


# -- submodels, folded data, node contraction, the engine's meta, annotations
# and postprocess, checkpoints (phase 24) -------------------------------------------

# (a): phase 4's LGSSM cell written as submodels inside scope("track")
S24_LABEL = "track/transition/x"
# (b): a demand level per store whose prior mean is last year's level plus
# a planned promotion lift (data a, b), 365 days of sales under N(x, 1)
FOLD_B, FOLD_N = 10_000, 365
FOLD_TOL = 1e-5          # against the float64 closed form, relative
FOLD_SHIFT = 1.0         # (b)'s second call: every lift one unit higher
# (c): tests/models/test_node_contraction.py's gcv_sub chain at T = 16
# over GCVC_B series, and on ``infer`` over the JAX test's own series (T =
# 4), where the reference holds the free energy non-increasing.  Over
# random series at T = 16 the contracted chain's free energy rises by up to
# 1.5e-2 on 64% of them (the body's on 83%), in the JAX package as in the
# port (measured on the CPU): mean-field VMP through GCV's quadrature is
# not monotone there, so that cell reports its rise and is not held to it.
GCVC_B, GCVC_T, GCVC_IT = 1024, 16, 15
GCVC_REF_T = 4
GCVC_PROFILE_IT = 1      # sweeps of the profiled call (busy scaled to 15)
GCVC_KAPPA, GCVC_OMEGA = 1.0, -1.0
GCVC_ROWS = (0, 1, GCVC_B // 2, GCVC_B - 1)
GCVC_TOL = 1e-4           # the card against the port's CPU run, relative
GCVC_BOUNDS = {"fe": 0.5, "means": 0.15}   # the JAX test's, absolute
GCVC_MONOTONE = 1e-4
# (d1): config 2's Beta-Bernoulli as CTR_B click-through streams in
# lockstep over CTR_T ticks; each tick's log-scale against the float64 log
# predictive at LOGSCALE_TOL plus 8 float32 ulps of lgamma(a + b + 1), the
# largest term the tick's free energy cancels (a float32 lgamma of ~860 at
# tick 200 is off by ~5e-5 alone: 8.0e-5 measured on the CPU)
CTR_B, CTR_T, CTR_PROFILE_T = 10_000, 200, 10
LOGSCALE_TOL = 1e-5
# (d2): phase 21 (a)'s online HGF over HGFM_T ticks with GCV damping,
# without meta= over the first HGFM_PLAIN_T, profiled over HGFM_PROFILE_T
# (a tick takes 100-150 ms)
HGFM_T, HGFM_PLAIN_T, HGFM_PROFILE_T = 10, 1, 1
HGFM_META = {"GCV": {"damping": 0.8}}
# (e): phase 14's engine cell checkpointed after CKPT_SPLIT ticks; the
# early-stopped infer on row 0 of phase 12 (e)'s Gaussian cell
CKPT_SPLIT = STREAM_T // 2
# the stopper's atol sits well above the free energy's float32 rounding
# (an ulp at its ~876 is 6.1e-5): at the JAX test's 1e-4 an H100 stopped a
# sweep after the CPU, its converged sweeps one ulp apart
ES_ATOL, ES_IT, ES_TOL = 1e-2, 50, 1e-5


def s24_lgssm_submodels(rt, f, q, h, r, m0, p0):
    """``zoo.lgssm`` written as submodels inside ``scope("track")``: the
    state chain (``default_init`` for its x) and the observations."""
    import torch

    prior = rt.MvNormalMeanCovariance(torch.as_tensor(m0),
                                      torch.as_tensor(p0))

    @rt.submodel(default_init={"x": prior})
    def transition(t_len):
        x = rt.latent(t_len, name="x")
        x[0] = rt.MvNormal(mean=m0, cov=p0)
        for t in rt.plate(1, t_len):
            x[t] = rt.MvNormal(mean=f @ x[t - 1], cov=q)
        return x

    @rt.submodel
    def emission(y, x):
        for t in rt.plate(len(y)):
            y[t] = rt.MvNormal(mean=h @ x[t], cov=r)

    @rt.model
    def lgssm_track(y):
        with rt.scope("track"):
            x = transition(len(y))
            emission(y, x)

    return lgssm_track


def fold_data():
    """(b)'s stores: last year's level a, the planned lift b, and 365 days
    of sales around a + b + a store effect."""
    rng = np.random.default_rng(25)
    a = rng.normal(10.0, 3.0, FOLD_B).astype(np.float32)
    b = rng.uniform(0.0, 2.0, FOLD_B).astype(np.float32)
    level = a + b + rng.standard_normal(FOLD_B)
    y = (level[:, None] + rng.standard_normal((FOLD_B, FOLD_N))).astype(
        np.float32)
    return a, b, y


def fold_closed_form(a, b, y):
    """x ~ N(a + b, 1), y_d ~ N(x, 1): the posterior mean and variance and
    -log p(y), float64."""
    a, b, y = (np.asarray(v, np.float64) for v in (a, b, y))
    n = y.shape[1]
    mu = a + b
    var = 1.0 / (1.0 + n)
    mean = (mu + y.sum(1)) * var
    res = y - mu[:, None]
    quad = (res ** 2).sum(1) - res.sum(1) ** 2 / (1.0 + n)
    return mean, var, 0.5 * (n * np.log(2 * np.pi) + np.log1p(n) + quad)


def fold_model(rt):
    @rt.model
    def demand(y, a, b):
        x = rt.Normal(mean=a + b, precision=1.0)
        for d in rt.plate(len(y)):
            y[d] = rt.Normal(mean=x, var=1.0)
        return {"x": x}

    return demand


def gcvc_register(rt):
    """(c)'s user node ``gcv_sub`` in the port's registry: its rules
    forward to GCV through ``call_rule`` (x is GCV's ``in``), as
    tests/models/test_node_contraction.py's do."""
    import torch

    from rxinfer_tpu_torch.dists import tree_leaves
    from rxinfer_tpu_torch.rules.registry import node

    def consts(q):
        dev = tree_leaves(q["x"])[0].device
        return {k: rt.PointMass(torch.tensor(np.float32(v), device=dev))
                for k, v in (("kappa", GCVC_KAPPA), ("omega", GCVC_OMEGA))}

    def fwd(q):
        fw = {"in": q["x"], "z": q["z"]}
        if "out" in q:
            fw["out"] = q["out"]
        return fw

    @node("gcv_sub")
    class GcvSubNode:
        interfaces = ("out", "x", "z")
        needs_self_marginal = True
        cavity_cluster = ("out", "x")

        @staticmethod
        def message_to_out(q):
            return rt.call_rule("GCV", "out", **fwd(q), **consts(q))

        @staticmethod
        def message_to_x(q):
            return rt.call_rule("GCV", "in", **fwd(q), **consts(q))

        @staticmethod
        def message_to_z(q):
            return rt.call_rule("GCV", "z", **{"in": q["x"], "out": q["out"],
                                               "z": q["z"]}, **consts(q))

        @staticmethod
        def average_energy(q):
            return rt.call_rule("GCV", "average_energy", **fwd(q),
                                **consts(q))


def gcvc_models(rt):
    """(c)'s chain with the contracted submodel and with its body traced
    (two models: the program caches key on the model function).  The
    batched entry points take no ``allow_node_contraction=``, as in the
    JAX package, so the contracted model traces with it itself."""
    from rxinfer_tpu_torch.graph.dsl import ModelGenerator

    gcvc_register(rt)

    @rt.submodel
    def gcv_sub(x=None, z=None):
        return rt.GCV(x, z, kappa=GCVC_KAPPA, omega=GCVC_OMEGA)

    def chain():
        @rt.model
        def gcv_chain(y):
            named = {}
            x_prev = rt.Normal(mean=0.0, var=1.0)
            named["x0"] = x_prev
            for t in range(len(y)):
                z = rt.Normal(mean=0.0, var=0.5)
                x = gcv_sub(x=x_prev, z=z)
                y[t] = rt.Normal(mean=x, var=0.1)
                named[f"z{t}"] = z
                named[f"x{t + 1}"] = x
                x_prev = x
            return named

        return gcv_chain

    class Contracted(ModelGenerator):
        def trace(self, data, allow_node_contraction=False):
            return super().trace(data, allow_node_contraction=True)

    contracted = chain()
    return Contracted(contracted.fn, contracted.bound), chain()


def gcvc_init(rt):
    import torch

    nmv = lambda m, v: rt.NormalMeanVariance(torch.tensor(m), torch.tensor(v))
    init = {f"x{t}": nmv(0.0, 1.0) for t in range(GCVC_T + 1)}
    init.update({f"z{t}": nmv(0.0, 0.5) for t in range(GCVC_T)})
    return init


def gcvc_data(b: int = GCVC_B, t_len: int = GCVC_T):
    """(c)'s series; (1, GCVC_REF_T) is the JAX test's own."""
    return np.random.default_rng(11).normal(0.0, 1.0, (b, t_len)).astype(
        np.float32)


def gcvc_reference_run(device, contract: bool):
    """(c) on ``infer`` over the JAX test's series, contracted or with the
    body traced: the free energy of every sweep and the means."""
    import torch

    import rxinfer_tpu_torch as rt

    _, chain = gcvc_models(rt)
    init = {k: v for k, v in gcvc_init(rt).items()
            if int(k[1:]) <= GCVC_REF_T - (k[0] == "z")}
    res = rt.infer(model=chain, data={"y": torch.as_tensor(
        gcvc_data(1, GCVC_REF_T)[0], device=device)}, iterations=GCVC_IT,
        free_energy=True, returnvars=rt.KeepLast(),
        constraints=rt.MeanField(), initialization=init,
        allow_node_contraction=contract, device=device)
    return (res.free_energy.cpu().numpy(),
            {k: float(v.mean()) for k, v in res.posteriors.items()})


def gcvc_run(device, model, y, iterations: int = GCVC_IT):
    """(c)'s ``infer_batched`` call: the means of every variable (name ->
    (B,)) and the free energy (iterations, B), on the host."""
    import torch

    import rxinfer_tpu_torch as rt

    post, fe = rt.infer_batched(
        model, {"y": torch.as_tensor(y, device=device)}, iterations=iterations,
        free_energy=True, constraints=rt.MeanField(),
        initialization=gcvc_init(rt), device=device)
    return ({k: v.mean().cpu().numpy() for k, v in post.items()},
            fe.cpu().numpy())


def ctr_data():
    """(d1)'s impressions: CTR_T ticks of CTR_B ads, each clicked with its
    own rate in [0.01, 0.2]."""
    rng = np.random.default_rng(26)
    p = rng.uniform(0.01, 0.2, CTR_B)
    return (rng.uniform(size=(CTR_T, CTR_B)) < p).astype(np.float32)


def ctr_log_predictive(ys):
    """Each tick's float64 log predictive log p(y_t | y_<t) of every stream
    under Beta(1, 1), and its tolerance (LOGSCALE_TOL above)."""
    from scipy.special import betaln, gammaln

    a = np.ones(ys.shape[1])
    b = np.ones(ys.shape[1])
    lp = np.empty(ys.shape)
    tol = np.empty(ys.shape)
    for t, y in enumerate(ys.astype(np.float64)):
        lp[t] = betaln(a + y, b + 1.0 - y) - betaln(a, b)
        tol[t] = LOGSCALE_TOL + 8 * np.finfo(np.float32).eps * gammaln(
            a + b + 1.0)
        a, b = a + y, b + 1.0 - y
    return lp, tol


def ctr_model(rt):
    @rt.model
    def ctr_tick(y, pa, pb):
        theta = rt.Beta(pa, pb)
        y.observe(rt.Bernoulli(theta))
        return {"theta": theta}

    return ctr_tick


def ctr_run(device, ys, seen):
    """(d1)'s engine over ys (T, B): annotations, the free energy and a user
    postprocess; ``seen`` receives every tick's postprocessed posteriors."""
    import torch

    import rxinfer_tpu_torch as rt

    b = ys.shape[1]
    au = rt.autoupdates(initial={"pa": np.ones(b, np.float32),
                                 "pb": np.ones(b, np.float32)},
                        pa=lambda q: q["theta"].a, pb=lambda q: q["theta"].b)
    yt = torch.as_tensor(ys, device=device)
    return rt.infer(model=ctr_model(rt), autoupdates=au, batched=True,
                    datastream=[{"y": yt[t]} for t in range(len(ys))],
                    free_energy=True, annotations=rt.LogScaleAnnotations(),
                    postprocess=lambda m: ("ctr", m), device=device,
                    callbacks={"on_marginal_update":
                               lambda ev: seen.append(ev.payload)})


def early_stop_run(device):
    """(e)'s early-stopped ``infer`` on row 0 of phase 12 (e)'s Gaussian
    cell: the sweeps it ran, their free energies and mu's mean."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo

    _, yg = config2_data()
    stopper = rt.StopEarlyIterationStrategy(atol=ES_ATOL)
    res = rt.infer(model=zoo.gaussian_unknown_mean_precision(),
                   data={"y": torch.as_tensor(yg[0], device=device)},
                   iterations=ES_IT, free_energy=True,
                   returnvars=rt.KeepLast(),
                   initialization={"tau": rt.GammaShapeRate(
                       torch.tensor(1.0), torch.tensor(1.0))},
                   callbacks={"after_iteration": stopper}, device=device)
    return (len(res.free_energy), res.free_energy.cpu().numpy(),
            float(res.posteriors["mu"].mean()))


def slice25_checks(wall0: float) -> tuple[list, dict]:
    """Phase 24's host work in a check process: (b)'s float64 closed forms,
    (c)'s chains and (d2)'s online HGF on the CPU on sampled rows, (d1)'s
    float64 log predictives, (e)'s early-stopped infer on the CPU."""
    import torch

    import rxinfer_tpu_torch as rt

    lines: list = []
    torch.set_num_threads(2)
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    a, b, y = fold_data()
    out = {"fold": fold_closed_form(a, b, y),
           "fold_shift": fold_closed_form(a, b + FOLD_SHIFT, y)}
    contracted, flat = gcvc_models(rt)
    yc = gcvc_data()[list(GCVC_ROWS)]
    out["gcvc"] = gcvc_run(cpu, contracted, yc)
    # the body traced, over every series: the contracted card run is held
    # against it at the JAX test's bounds
    out["gcvc_flat"] = gcvc_run(cpu, flat, gcvc_data())
    out["gcvc_ref_body"] = gcvc_reference_run(cpu, False)
    out["ctr"] = ctr_log_predictive(ctr_data())
    _, _, yh = hgfs_data(HGFS_B, HGFM_T)
    out["hgfm"] = hgfs_run(cpu, yh[:, list(HGFS_ROWS)], meta=HGFM_META)
    out["early_stop"] = early_stop_run(cpu)
    lines.append(f"[s24 check] phase 24's references on the CPU in "
                 f"{time.perf_counter() - t0:.1f} s")
    _ended(lines, "phase 24 host checks", wall0)
    return lines, out


def _trace_kernels(files: list, names: tuple) -> dict:
    """Device kernels of ``profile_trace``'s Chrome trace: the launches of
    each name in ``names``, and every kernel's summed ms."""
    events = []
    for path in files:
        with open(path) as fh:
            events += [e for e in json.load(fh).get("traceEvents", [])
                       if e.get("cat") == "kernel"]
    return {"launches": {n: sum(1 for e in events if n in e["name"])
                         for n in names},
            "busy_ms": sum(e.get("dur", 0.0) for e in events) / 1e3,
            "kernels": len(events)}


def slice25_paths(device, host: dict, smi: str, log=print) -> dict:
    """Phase 24 (a)-(e): this slice's paths at full width, each checked on
    the card, its launches read, its ms, device busy and idle share, device
    kernels and peak memory printed.  Only (a) and (d1) are timed (one
    warm-up, one timed call); every other cell reports its checked call."""
    import tempfile

    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from rxinfer_tpu_torch.utils.session import get_default_session

    results: dict = {}
    cpu = lambda t: t.detach().cpu().numpy()
    sess = get_default_session()
    n0 = {k: sess.get_session_stats(k).total
          for k in ("inference", "streaming_inference")}
    n_calls = {"inference": 0, "streaming_inference": 0}

    cell_t0 = [time.perf_counter()]

    def report(tag, label, ms, busy, kernels, peak, launches, extra):
        cell_s = time.perf_counter() - cell_t0[0]
        cell_t0[0] = time.perf_counter()
        log(f"[s24] {tag} {label} (the cell {cell_s:.2f} s): call_ms "
            f"{ms:.3f} busy_ms {busy} idle "
            f"{_idle_share(ms, busy)} device kernels {kernels} peak_gb "
            f"{peak / 1e9:.3f}; {extra}; launches "
            f"{ {k: v for k, v in launches.items() if v} or 'none'}; {smi}")
        results[tag] = {"ms": ms, "busy_ms": busy, "kernels": kernels,
                        "peak_bytes": peak, "launches": launches}

    # (a) the LGSSM cell as submodels: the fused plan, K1 and K2 once each
    f, q, h, r, m0, p0 = lgssm_constants(MAIN_D)
    flat = zoo.lgssm(f, q, h, r, m0, p0)
    sub = s24_lgssm_submodels(rt, f, q, h, r, m0, p0)
    y = torch.as_tensor(lgssm_y(MAIN_B, MAIN_T, MAIN_D), device=device)
    data = {"y": y}
    run_a = lambda m: rt.infer_batched(m, data, free_energy=True,
                                       device=device)
    compiled, _ = rt.batched_program(sub, data, free_energy=True,
                                     device=device)
    report_a = compiled.plan_report()[S24_LABEL]
    want_route = "cuda" if device.type == "cuda" else "plain"
    if not report_a.get("fused") or report_a.get("route") != want_route:
        raise AssertionError(f"phase 24 (a): not the fused plan: {report_a}")
    run_a(sub)                                            # warm-up
    reset_launches()
    with rt.trace_messages() as mt_sub:
        (res_s, ms_a) = _once_ms(lambda: run_a(sub))
    launches = read_launches()
    expect_launches(launches, fused_smoother_fwd=1, fused_smoother_bwd=1)
    with rt.trace_messages() as mt_flat:
        res_f = run_a(flat)
    qs, qf = res_s.posteriors[S24_LABEL], res_f.posteriors["x"]
    bit_equal = (torch.equal(qs.mean(), qf.mean())
                 and torch.equal(qs.cov(), qf.cov())
                 and torch.equal(res_s.free_energy, res_f.free_energy))
    strip = lambda recs: [(e["node"], e["mean_field"]) for e in recs]
    same_trace = (strip(mt_sub.records) == strip(mt_flat.records)
                  and len(mt_sub.records) > 0)
    logdir = tempfile.mkdtemp(prefix="s24_profile_")
    with rt.profile_trace(logdir) as pt:
        _, peak_a = _peak_call(device, lambda: run_a(sub))
    names = tuple(n for k in ("fused_smoother_fwd", "fused_smoother_bwd")
                  for n in SMOOTHER_KERNEL_NAMES[k])
    traced = _trace_kernels(pt.trace_files(), names)
    shutil.rmtree(logdir, ignore_errors=True)
    named = (traced["launches"]["fwd_replay_kernel"] >= 1
             and traced["launches"]["bwd_replay_kernel"] >= 1)
    report("(a)", f"LGSSM as submodels (B,T,d)=({MAIN_B},{MAIN_T},{MAIN_D}) "
           "with FE, infer_batched", ms_a, traced["busy_ms"],
           traced["kernels"], peak_a, launches,
           f"bit-equal to zoo.lgssm {bit_equal}; trace_messages records "
           f"{len(mt_sub.records)} equal to the flat model's {same_trace}; "
           f"profile_trace names the smoother kernels {named} "
           f"({traced['launches']})")
    if not (bit_equal and same_trace and named):
        raise AssertionError(f"phase 24 (a): bit-equal {bit_equal}, traces "
                             f"{same_trace}, profile {traced['launches']}")
    del res_s, res_f, qs, qf, y, data

    # (b) folded data on plain groups; new a, b reuse the program
    a, b, yf = fold_data()
    fdata = {"a": torch.as_tensor(a, device=device),
             "b": torch.as_tensor(b, device=device),
             "y": torch.as_tensor(yf, device=device)}
    model_b = fold_model(rt)
    first, _ = rt.batched_program(model_b, fdata, free_energy=True,
                                  device=device)
    reset_launches()
    (post_b, ms_b), peak_b = _peak_call(device, lambda: _once_ms(
        lambda: rt.infer_batched(model_b, fdata, free_energy=True,
                                 device=device)))
    launches_b = read_launches()
    expect_launches(launches_b)
    shifted = dict(fdata, b=fdata["b"] + FOLD_SHIFT)
    post_b2 = rt.infer_batched(model_b, shifted, free_energy=True,
                               device=device)
    again, _ = rt.batched_program(model_b, shifted, free_energy=True,
                                  device=device)
    errs_b = {}
    for tag, (pb, fb), ref in (("", post_b, host["fold"]),
                               ("shift_", post_b2, host["fold_shift"])):
        mean, var, nlz = ref
        errs_b[tag + "mean"] = _rel_max(cpu(pb["x"].mean()), mean)
        errs_b[tag + "var"] = _rel_max(cpu(pb["x"].var()),
                                       np.full_like(mean, var))
        errs_b[tag + "fe"] = _rel_max(cpu(fb[-1]), nlz)
    moved = float((post_b2[0]["x"].mean() - post_b[0]["x"].mean()).mean())
    want_move = FOLD_SHIFT / (1.0 + FOLD_N)
    busy_b, kernels_b = _busy_and_kernels(
        lambda: rt.infer_batched(model_b, fdata, free_energy=True,
                                 device=device))
    report("(b)", f"folded data a + b, (B,N)=({FOLD_B},{FOLD_N}) with FE",
           ms_b, busy_b, kernels_b, peak_b, launches_b,
           f"against the float64 closed form, relative: {errs_b} (tol "
           f"{FOLD_TOL}); b + {FOLD_SHIFT} reuses the program "
           f"{again is first}, moves the means by {moved:.6g} (closed form "
           f"{want_move:.6g})")
    if (max(errs_b.values()) > FOLD_TOL or again is not first
            or abs(moved - want_move) > 1e-4):
        raise AssertionError(f"phase 24 (b): {errs_b}, reused "
                             f"{again is first}, moved {moved}")
    del fdata, shifted, post_b, post_b2

    # (c) node contraction over GCVC_B datasets
    contracted, _ = gcvc_models(rt)
    yc = gcvc_data()
    rt.batched_program(contracted, {"y": torch.as_tensor(yc, device=device)},
                       iterations=GCVC_IT, free_energy=True,
                       constraints=rt.MeanField(),
                       initialization=gcvc_init(rt), device=device)
    reset_launches()
    ((mc, fec), ms_c), peak_c = _peak_call(device, lambda: _once_ms(
        lambda: gcvc_run(device, contracted, yc)))
    launches_c = read_launches()
    expect_launches(launches_c)
    mf_, fef = host["gcvc_flat"]
    rows = list(GCVC_ROWS)
    hm, hfe = host["gcvc"]
    errs_c = {"means": max(_rel_max(mc[k][rows], hm[k]) for k in hm),
              "fe": _rel_max(fec[:, rows], hfe)}
    gaps = {"fe": float(np.abs(fec[-1] - fef[-1]).max()),
            "means": max(float(np.abs(mc[k] - mf_[k]).max()) for k in mf_)}
    rises = np.diff(fec, axis=0).max(axis=0)
    fe_ref, m_ref = gcvc_reference_run(device, True)
    fe_body, m_body = host["gcvc_ref_body"]
    n_calls["inference"] += 1
    ref_rise = float(np.diff(fe_ref).max())
    ref_gaps = {"fe": abs(float(fe_ref[-1] - fe_body[-1])),
                "means": max(abs(m_ref[k] - m_body[k]) for k in m_body)}
    one_sweep = lambda: gcvc_run(device, contracted, yc, GCVC_PROFILE_IT)
    one_sweep()
    busy_c, kernels_c = _busy_and_kernels(one_sweep)
    busy_c = (busy_c * GCVC_IT / GCVC_PROFILE_IT
              if isinstance(busy_c, float) else busy_c)
    report("(c)", f"node contraction, gcv_sub chain (B,T)=({GCVC_B},"
           f"{GCVC_T}), {GCVC_IT} sweeps under MeanField()", ms_c, busy_c,
           kernels_c, peak_c, launches_c,
           f"against the port on the CPU on rows {rows}, relative: {errs_c} "
           f"(tol {GCVC_TOL}); contracted against the body traced (the "
           f"port on the CPU): {gaps} (bounds {GCVC_BOUNDS}); finite {bool(np.isfinite(fec).all())}; "
           f"FE rises by more than {GCVC_MONOTONE} on "
           f"{float((rises > GCVC_MONOTONE).mean()):.3f} of the series, "
           f"at most {float(rises.max()):.3g} (not held, see GCVC_REF_T); "
           f"infer(allow_node_contraction=True) on the JAX test's series: "
           f"largest FE rise {ref_rise:.3g} (tol {GCVC_MONOTONE}), against "
           f"the body {ref_gaps} (its body on the CPU); busy and kernels "
           f"over {GCVC_PROFILE_IT} sweep, busy scaled to {GCVC_IT}")
    if (max(errs_c.values()) > GCVC_TOL or not np.isfinite(fec).all()
            or any(gaps[k] >= GCVC_BOUNDS[k] for k in gaps)
            or not np.isfinite(fe_ref).all() or ref_rise > GCVC_MONOTONE
            or any(ref_gaps[k] >= GCVC_BOUNDS[k] for k in ref_gaps)):
        raise AssertionError(f"phase 24 (c): {errs_c}, {gaps}, the JAX "
                             f"test's series: rise {ref_rise}, {ref_gaps}")

    # (d1) click-through streams: per-stream log-scales and a postprocess
    ys = ctr_data()
    ctr_run(device, ys[:2], [])                           # warm-up
    seen: list = []
    t0 = time.perf_counter()
    reset_launches()
    eng, peak_d1 = _peak_call(device, lambda: ctr_run(device, ys, seen))
    ms_d1 = (time.perf_counter() - t0) * 1e3
    launches_d1 = read_launches()
    expect_launches(launches_d1)
    n_calls["streaming_inference"] += 2
    wrapped = len(seen) == CTR_T and all(
        p["theta"][0] == "ctr" and isinstance(p["theta"][1], rt.Marginal)
        for p in seen)
    scales = cpu(torch.stack([rt.getlogscale(p["theta"][1]) for p in seen]))
    lp, tol = host["ctr"]
    err = np.abs(scales - lp)
    over = float((err / tol).max())
    busy_d1, kernels_d1 = _busy_and_kernels(
        lambda: ctr_run(device, ys[:CTR_PROFILE_T], []))
    n_calls["streaming_inference"] += 1
    busy_d1 = (busy_d1 * CTR_T / CTR_PROFILE_T
               if isinstance(busy_d1, float) else busy_d1)
    report("(d1)", f"click-through streams (B,T)=({CTR_B},{CTR_T}), "
           "annotations, FE and a postprocess, on_next (host clock)", ms_d1,
           busy_d1, kernels_d1, peak_d1, launches_d1,
           f"log-scale against the float64 log predictive: max abs "
           f"{err.max():.3g}, at most {over:.3g} of its tolerance "
           f"({LOGSCALE_TOL} + 8 float32 ulps of lgamma(a + b + 1)); the "
           f"postprocess wraps every tick {wrapped}; busy and kernels over "
           f"{CTR_PROFILE_T} ticks, busy scaled to {CTR_T}")
    if over > 1.0 or not wrapped or scales.shape != (CTR_T, CTR_B):
        raise AssertionError(f"phase 24 (d1): {err.max()}, {over}, wrapped "
                             f"{wrapped}")
    del eng, seen

    # (d2) the online HGF with meta=: against the CPU, meta on the tick
    _, _, yh = hgfs_data(HGFS_B, HGFM_T)
    t0 = time.perf_counter()
    reset_launches()
    kept: list = []
    (post_m, fe_m), peak_d2 = _peak_call(
        device, lambda: hgfs_run(device, yh, meta=HGFM_META, keep=kept))
    ms_d2 = (time.perf_counter() - t0) * 1e3
    launches_d2 = read_launches()
    expect_launches(launches_d2)
    post_n, fe_n = hgfs_run(device, yh[:HGFM_PLAIN_T])
    busy_d2, kernels_d2 = _busy_and_kernels(
        lambda: hgfs_run(device, yh[:HGFM_PROFILE_T], meta=HGFM_META))
    busy_d2 = (busy_d2 * HGFM_T / HGFM_PROFILE_T
               if isinstance(busy_d2, float) else busy_d2)
    n_calls["streaming_inference"] += 3
    hrows = list(HGFS_ROWS)
    errs_d2 = {f"{n}_{w}": _rel_max(post_m[n][i][:, hrows],
                                    host["hgfm"][0][n][i])
               for n in ("xt", "zt") for i, w in enumerate(("mean", "var"))}
    same = all(np.array_equal(post_m[n][i][:HGFM_PLAIN_T], post_n[n][i])
               for n in ("xt", "zt") for i in (0, 1))
    damped = [fct.meta.get("damping") for fct in
              kept[0]._compiled.graph.factors if fct.fform == "GCV"]
    report("(d2)", f"online HGF (B,T)=({HGFS_B},{HGFM_T}), {HGFS_IT} sweeps "
           f"a tick, meta={HGFM_META}", ms_d2, busy_d2, kernels_d2,
           peak_d2, launches_d2,
           f"against the port on the CPU on streams {hrows}, relative: "
           f"{errs_d2} (tol {HGFS_TOL}); the tick's GCV factors carry "
           f"damping {damped}; without meta= over the first {HGFM_PLAIN_T} "
           f"ticks bit-equal {same} (GCV damping "
           "blends a chain's evidence only, in both packages; xt is a plain "
           f"group); busy and kernels over {HGFM_PROFILE_T} tick, busy "
           f"scaled to {HGFM_T}")
    if max(errs_d2.values()) > HGFS_TOL or damped != [0.8]:
        raise AssertionError(f"phase 24 (d2): {errs_d2}, damping {damped}")

    # (e) checkpoint and resume of phase 14's engine; the early stop
    ff, qq, _, rr, _, pp0 = lgssm_constants(STREAM_D)
    rng = np.random.default_rng(0)
    yss = torch.as_tensor(rng.standard_normal(
        (STREAM_T, STREAM_B, STREAM_D)).astype(np.float32), device=device)

    def engine(au):
        return rt.infer(model=_stream_tick_model(rr), datastream=None,
                        autoupdates=au, batched=True, device=device)

    make_au = lambda: _stream_autoupdates(ff, qq, pp0, STREAM_B, device)
    whole = engine(make_au())
    reset_launches()
    (posts, _), peak_e = _peak_call(device, lambda: whole.run_offline(
        {"y": yss}))
    first_half = engine(make_au())
    first_half.run_offline({"y": yss[:CKPT_SPLIT]})
    ckdir = tempfile.mkdtemp(prefix="s24_ckpt_")
    path = os.path.join(ckdir, "args.pkl")
    t0 = time.perf_counter()
    save_checkpoint(path, first_half.args)
    args = load_checkpoint(path, device=device)
    ms_ck = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(ckdir, ignore_errors=True)
    resumed = engine(rt.autoupdates(initial=args, **make_au().mapping))
    (rest, _), ms_e = _once_ms(lambda: resumed.run_offline(
        {"y": yss[CKPT_SPLIT:]}))
    launches_e = read_launches()
    expect_launches(launches_e)
    n_calls["streaming_inference"] += 3
    bits = (torch.equal(rest["x"].mean(), posts["x"].mean()[CKPT_SPLIT:])
            and torch.equal(rest["x"].cov(), posts["x"].cov()[CKPT_SPLIT:])
            and all(torch.equal(resumed.args[k], whole.args[k])
                    for k in whole.args))
    plans = [bool(e._stream_plan) for e in (whole, first_half, resumed)]
    sweeps, fes, mu = early_stop_run(device)
    n_calls["inference"] += 1
    h_sweeps, h_fes, h_mu = host["early_stop"]
    es_err = (_rel_max(fes, h_fes) if sweeps == h_sweeps else float("inf"))
    busy_e, kernels_e = _busy_and_kernels(lambda: resumed.run_offline(
        {"y": yss[CKPT_SPLIT:]}))
    report("(e)", f"checkpoint after {CKPT_SPLIT} of {STREAM_T} ticks, "
           f"(B,d)=({STREAM_B},{STREAM_D}), the resumed half", ms_e, busy_e,
           kernels_e, peak_e, launches_e,
           f"resumed bit-equal to the whole run {bits} (fused stream plan "
           f"{plans}); save and load {ms_ck:.1f} ms; early stop at sweep "
           f"{sweeps} of {ES_IT} (CPU {h_sweeps}), FE against the CPU "
           f"relative {es_err:.3g} (tol {ES_TOL}), mu {mu:.6g} (CPU "
           f"{h_mu:.6g})")
    if not bits or sweeps != h_sweeps or es_err > ES_TOL:
        raise AssertionError(f"phase 24 (e): bits {bits}, sweeps {sweeps} "
                             f"against {h_sweeps}, FE {es_err}")

    logged = {k: sess.get_session_stats(k).total - n0[k] for k in n0}
    log(f"[s24] the default session logged {logged} (calls made: "
        f"{n_calls})")
    if logged != n_calls:
        raise AssertionError(f"phase 24: session {logged}, calls {n_calls}")
    return results


# -- slice 26: multi-device (phase 25) ------------------------------------------------

MESH_T = 100_000             # (b): bench.py:680-706's time-sharded row
MESH_ONE_TOL = 1e-4          # (b) against the same call without a mesh
HIERM_B, HIERM_T = 1024, 1000
HIERM_TOL = 1e-4             # (e) the hybrid mesh against the flat one


def slice26_checks(wall0: float) -> tuple[list, dict]:
    """Phase 25's host work in a check process: (b)'s float64 RTS of the
    T = MESH_T chain."""
    lines: list = []
    t0 = time.perf_counter()
    out = {"time_oracle": _lgssm_oracle(infer_lgssm_y(MESH_T, MAIN_D)[None],
                                        MAIN_D)}
    lines.append(f"[s25 check] phase 25's float64 RTS over {MESH_T} steps "
                 f"in {time.perf_counter() - t0:.1f} s")
    _ended(lines, "phase 25 host checks", wall0)
    return lines, out


class one_rank_world:
    """A one-rank ``torch.distributed`` world for phase 25: NCCL on the
    card (gloo for a CPU rehearsal), a ``file://`` rendezvous under a
    temporary directory; destroyed on exit, also when the phase fails."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import tempfile

        import torch
        import torch.distributed as dist

        self.root = tempfile.mkdtemp(prefix="s25_world_")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device.index or 0)
        dist.init_process_group(
            "nccl" if self.device.type == "cuda" else "gloo",
            init_method=f"file://{self.root}/rendezvous", rank=0,
            world_size=1)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.root, ignore_errors=True)
        return False


def slice26_paths(device, host: dict, smi: str, log=print) -> dict:
    """Phase 25 (a)-(e): the mesh entry points on a one-rank world, each
    against the same call without a mesh.  Every cell reports its checked
    call's ms, device busy and idle share, device kernels, peak memory and
    launches; only (b) is timed (one warm-up and two timed calls of each
    side).  Run inside ``one_rank_world``."""
    import torch

    import rxinfer_tpu_torch as rt
    from rxinfer_tpu_torch.models import zoo
    from rxinfer_tpu_torch.ops import fused_filter as ff
    from rxinfer_tpu_torch.parallel.filtering import (
        FilterState,
        make_sharded_filtering,
    )
    from rxinfer_tpu_torch.parallel.hierarchical import (
        HierLGSSMState,
        make_sharded_step,
    )
    from rxinfer_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh

    kind = device.type
    dp = make_mesh(1, "dp", device_type=kind)
    time_mesh = make_mesh(1, "time", device_type=kind)
    flat = make_mesh(1, "batch", device_type=kind)
    hybrid = make_hybrid_mesh(None, ("host", "batch"), device_type=kind)
    results: dict = {}
    cell_t0 = [time.perf_counter()]

    def checked(run, **launches):
        """The warmed-up call, its launches (held to ``launches``), ms and
        peak memory; then the device busy time of one more call."""
        run()
        reset_launches()
        (out, ms), peak = _peak_call(device, lambda: _once_ms(run))
        got = read_launches()
        expect_launches(got, **launches)
        busy, kernels = _busy_and_kernels(run)
        return out, {"ms": ms, "busy_ms": busy, "kernels": kernels,
                     "peak_bytes": peak, "launches": got}

    def report(tag, label, cell, extra):
        cell_s = time.perf_counter() - cell_t0[0]
        cell_t0[0] = time.perf_counter()
        log(f"[s25] {tag} {label} (the cell {cell_s:.2f} s): call_ms "
            f"{cell['ms']:.3f} busy_ms {cell['busy_ms']} idle "
            f"{_idle_share(cell['ms'], cell['busy_ms'])} device kernels "
            f"{cell['kernels']} peak_gb {cell['peak_bytes'] / 1e9:.3f}; "
            f"{extra}; launches "
            f"{ {k: v for k, v in cell['launches'].items() if v} or 'none'}"
            f"; {smi}")
        results[tag] = cell

    eq = lambda a, b: bool(torch.equal(a, b))

    # (a1) infer_batched(mesh=) on phase 4's LGSSM cell, with the FE
    f, q, h, r, m0, p0 = lgssm_constants(MAIN_D)
    model = zoo.lgssm(f, q, h, r, m0, p0)
    data = {"y": torch.as_tensor(lgssm_y(MAIN_B, MAIN_T, MAIN_D),
                                 device=device)}
    one = rt.infer_batched(model, data, free_energy=True, device=device)
    res, cell = checked(lambda: rt.infer_batched(model, data,
                                                 free_energy=True, mesh=dp),
                        fused_smoother_fwd=1, fused_smoother_bwd=1)
    qa, qo = res.posteriors["x"], one.posteriors["x"]
    bit_equal = (eq(qa.mean(), qo.mean()) and eq(qa.cov(), qo.cov())
                 and eq(res.free_energy, one.free_energy))
    report("(a1)", f"infer_batched(mesh=dp) LGSSM (B,T,d)=({MAIN_B},"
           f"{MAIN_T},{MAIN_D}) with FE", cell,
           f"posteriors and FE bit-equal to the one-device call {bit_equal}")
    if not bit_equal:
        raise AssertionError("phase 25 (a1): the mesh run is not bit-equal "
                             "to the one-device run")
    del res, one, qa, qo, data

    # (a2) shared= on phase 18's pooled lgssm_wtau cell: the NCCL all_reduce
    b, t_len, d, it = WTAU_B, WTAU_T, WTAU_D, WTAU_IT
    model, init = wtau_model(d)
    data = {"y": torch.as_tensor(np.random.default_rng(11).standard_normal(
        (b, t_len, d)).astype(np.float32), device=device)}
    kw = dict(iterations=it, initialization=init, shared=("Wr",))
    one = rt.infer_batched(model, data, device=device, **kw)
    res, cell = checked(lambda: rt.infer_batched(model, data, mesh=dp, **kw),
                        fused_smoother_fwd_dyn=it, fused_smoother_bwd=it)
    pa, po = res.posteriors, one.posteriors
    bit_equal = (eq(pa["Wr"].nu, po["Wr"].nu) and eq(pa["Wr"].s, po["Wr"].s)
                 and eq(pa["x"].mean(), po["x"].mean())
                 and eq(pa["x"].cov(), po["x"].cov()))
    report("(a2)", f"infer_batched(shared=('Wr',), mesh=dp) lgssm_wtau "
           f"(B,T,d)=({b},{t_len},{d}), {it} iterations", cell,
           f"bit-equal to the one-device pooled call {bit_equal}")
    if not bit_equal:
        raise AssertionError("phase 25 (a2): the pooled sum over the mesh is "
                             "not bit-equal to the one-device pooled sum")
    del res, one, pa, po, data

    # (b) infer(mesh=time) at bench.py's time-sharded row
    model = zoo.lgssm(*lgssm_constants(MAIN_D))
    y = torch.as_tensor(infer_lgssm_y(MESH_T, MAIN_D), device=device)
    call_mesh = lambda: rt.infer(model, data={"y": y}, mesh=time_mesh)
    call_one = lambda: rt.infer(model, data={"y": y}, device=device)
    one = call_one()
    res, cell = checked(call_mesh)
    means, covs = res.posteriors["x"].mean(), res.posteriors["x"].cov()
    o_m, o_p = host["time_oracle"]
    errs = {"means": float(np.abs(means.cpu().numpy() - o_m[0]).max()),
            "covs": float(np.abs(covs.cpu().numpy() - o_p[0]).max()),
            "one_means": float((means - one.posteriors["x"].mean()).abs()
                               .max()),
            "one_covs": float((covs - one.posteriors["x"].cov()).abs()
                              .max())}
    # the checked call warmed the mesh's side up and ``one`` the local one
    cell["ms_mesh"] = _cuda_ms(call_mesh, reps=2, warmup=0)
    cell["ms_one"] = _cuda_ms(call_one, reps=2, warmup=0)
    cell["updates_per_s"] = 3 * MESH_T / (cell["ms_mesh"] / 1e3)
    cell["one_updates_per_s"] = 3 * MESH_T / (cell["ms_one"] / 1e3)
    cell["ratio_to_local"] = cell["ms_one"] / cell["ms_mesh"]
    cell["errs"] = errs
    report("(b)", f"infer(mesh=time) one chain T={MESH_T} d={MAIN_D}", cell,
           f"time-sharded {cell['ms_mesh']:.3f} ms "
           f"({cell['updates_per_s']:.6g} updates/s), local "
           f"{cell['ms_one']:.3f} ms ({cell['one_updates_per_s']:.6g} "
           f"updates/s), local / sharded {cell['ratio_to_local']:.3f}; "
           f"float64 RTS max abs err means {errs['means']:.3g} covs "
           f"{errs['covs']:.3g} (tol {ORACLE_TOL}); against the local call "
           f"means {errs['one_means']:.3g} covs {errs['one_covs']:.3g} "
           f"(tol {MESH_ONE_TOL})")
    if max(errs["means"], errs["covs"]) > ORACLE_TOL or max(
            errs["one_means"], errs["one_covs"]) > MESH_ONE_TOL:
        raise AssertionError(f"phase 25 (b): {errs}")
    del res, one, means, covs, y

    # (c) make_sharded_filtering(mesh, fused=True) at path A's cell
    f, q, h, r, m0, p0 = lgssm_constants(FILTER_D)
    ys = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (FILTER_T, FILTER_B, FILTER_D)).astype(np.float32), device=device)
    state = FilterState(
        torch.zeros((FILTER_B, FILTER_D), device=device),
        torch.as_tensor(p0, device=device).expand(
            (FILTER_B, FILTER_D, FILTER_D)).contiguous())
    fn_one = make_sharded_filtering(None, f, q, h, r, fused=True,
                                    device=device)
    fn_mesh = make_sharded_filtering(flat, f, q, h, r, fused=True)
    want = fn_one(state, ys)
    (final, fmeans), cell = checked(
        lambda: fn_mesh(state, ys), **{ff.launch_key(FILTER_D, FILTER_D): 1})
    bit_equal = (eq(final.m, want[0].m) and eq(final.p, want[0].p)
                 and eq(fmeans, want[1]))
    report("(c)", f"make_sharded_filtering(mesh=batch, fused=True) "
           f"(B,T,d,dy)=({FILTER_B},{FILTER_T},{FILTER_D},{FILTER_D})", cell,
           f"bit-equal to phase 7's one-device call {bit_equal}")
    if not bit_equal:
        raise AssertionError("phase 25 (c): the sharded filter is not "
                             "bit-equal to the one-device filter")
    del final, fmeans, want, ys, state

    # (d) the streaming engine's mesh= at phase 14's cell
    f, q, _, r, _, p0 = lgssm_constants(STREAM_D)
    obs = {"y": torch.as_tensor(np.random.default_rng(0).standard_normal(
        (STREAM_T, STREAM_B, STREAM_D)).astype(np.float32), device=device)}
    engine = lambda **kw: rt.infer(
        model=_stream_tick_model(r), datastream=None,
        autoupdates=_stream_autoupdates(f, q, p0, STREAM_B, device), **kw)
    eng_one = engine(batched=True, device=device)
    post_one, _ = eng_one.run_offline(obs)
    engines = []

    def run_mesh():
        engines.append(engine(mesh=dp))
        return engines[-1].run_offline(obs)

    (post_mesh, fes), cell = checked(run_mesh)
    eng_mesh = engines[1]
    bit_equal = (eq(post_mesh["x"].mean(), post_one["x"].mean())
                 and eq(post_mesh["x"].cov(), post_one["x"].cov())
                 and eq(eng_mesh.args["pm"], eng_one.args["pm"])
                 and eq(eng_mesh.args["pc"], eng_one.args["pc"]))
    plans = bool(eng_mesh._stream_plan) and bool(eng_one._stream_plan)
    report("(d)", f"streaming engine mesh=dp run_offline (B,T,d)="
           f"({STREAM_B},{STREAM_T},{STREAM_D})", cell,
           f"fused stream plan engaged {plans}; posteriors and the next "
           f"tick's arguments bit-equal to the unsharded engine {bit_equal}")
    if not (bit_equal and plans):
        raise AssertionError(f"phase 25 (d): bit-equal {bit_equal}, plans "
                             f"{plans}")
    del post_mesh, post_one, fes, obs, engines, eng_mesh, eng_one

    # (e) make_sharded_step on the hybrid (1, 1) mesh against the flat one
    f, q, h, r, m0, p0 = lgssm_constants(MAIN_D)
    args = (m0, p0, f, h, r, np.float32(MAIN_D + 1.0),
            np.eye(MAIN_D, dtype=np.float32))
    y = torch.as_tensor(lgssm_y(HIERM_B, HIERM_T, MAIN_D), device=device)
    st0 = HierLGSSMState(torch.tensor(MAIN_D + 1.0, device=device),
                         torch.eye(MAIN_D, device=device))
    step_flat = make_sharded_step(flat, *args)
    step_hyb = make_sharded_step(hybrid, *args, axis_name=("host", "batch"))
    want_st, (want_m, _) = step_flat(st0, y)
    (got_st, (got_m, _)), cell = checked(lambda: step_hyb(st0, y))
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    errs = {"nu": rel(got_st.w_nu, want_st.w_nu),
            "sinv": rel(got_st.w_sinv, want_st.w_sinv),
            "means": rel(got_m, want_m)}
    ok = (max(errs.values()) <= HIERM_TOL
          and float(got_st.w_nu) == MAIN_D + 1.0 + HIERM_B * (HIERM_T - 1))
    report("(e)", f"make_sharded_step on the hybrid mesh "
           f"{tuple(hybrid.shape)} (B,T,d)=({HIERM_B},{HIERM_T},{MAIN_D})",
           cell, f"against the flat mesh, relative {errs} (tol "
           f"{HIERM_TOL}); nu {float(got_st.w_nu)}")
    if not ok:
        raise AssertionError(f"phase 25 (e): {errs}, nu {got_st.w_nu}")
    return results


def _start_checker() -> None:
    """A check process's start-up, run while the main process builds the
    kernels: the port's imports and the card's context."""
    import torch

    import rxinfer_tpu_torch  # noqa: F401

    torch.cuda.init()


def side_checks(wall0: float) -> tuple[list, dict, dict]:
    """Phase 3's K4/K5 checks and phase 6's K3, K6-K8 checks, in a second
    process beside the K1/K2 checks.  The plain versions the checks hold the
    kernels against are host-bound Python loops (seconds a call), so the two
    processes overlap about half of the script's checking time.  Returns the
    log lines, each kernel's max error against its plain version and the
    layouts K6-K8 took."""
    import torch

    device = torch.device("cuda")
    lines: list = []
    worst = check_fb_kernels(device, FB_CHECK_SHAPES, log=lines.append)
    del worst["bit_equal"]
    worst.update(check_filter_kernel(device, FILTER_CHECK_SHAPES,
                                     log=lines.append))
    quant_worst, layouts = check_quant_kernels(device, log=lines.append)
    worst.update(quant_worst)
    _ended(lines, "K3-K8 checks", wall0)
    return lines, worst, layouts


def main() -> int:
    if shutil.which("nvidia-smi"):
        # torch's and the port's bytecode, compiled by this process into the
        # checkout's _pycache/, from which the check processes then start
        here = os.path.dirname(os.path.abspath(__file__))
        os.environ.setdefault("PYTHONPYCACHEPREFIX",
                              os.path.join(here, "_pycache"))
        sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import rxinfer_tpu_torch  # noqa: F401
        from rxinfer_tpu_torch import kernels
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    wall0 = time.time()
    device = torch.device("cuda")

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"[env] nvidia-smi: {smi}")
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    print(f"[env] tf32: matmul.allow_tf32={tf32[0]} cudnn.allow_tf32={tf32[1]}"
          f" float32_matmul_precision={torch.get_float32_matmul_precision()}")
    if tf32[0]:
        raise AssertionError("TF32 matmuls are enabled; the port must not "
                             "enable them")

    # 3. and 6. kernels vs plain versions: K1/K2 here, K3-K8 in a second
    # process at the same time (a check that fails there raises here);
    # 10 (a): the per-chain K1/K2, a third; 15 (a): the wide and the bf16
    # kernels' checks, a process each; 16 (a) and (c): the wide K4/K5 and
    # K3, a sixth; 17 (a): the warp K3, a seventh; the host oracles of
    # phases 4-16 (``host_prefetch``), in two parts, an eighth and the first
    # to be free.  The host checks of phases 18-20 (the float64 pooled VMP
    # and CPU programs) follow in the processes as they free up, and run
    # while this process runs phases 4-17.  The eight processes start
    # (imports, the card's context) during the build.
    pool = multiprocessing.get_context("spawn").Pool(
        8, initializer=_start_checker)
    try:
        return _main_with_pool(pool, device, smi, t_start, wall0, kernels)
    finally:
        pool.terminate()
        pool.join()


def _main_with_pool(pool, device, smi: str, t_start: float, wall0: float,
                    kernels) -> int:
    """``main``'s phases 2-24 with the check processes' pool (``main``
    stops it whatever happens here).  The kernel checks and the host
    oracles are fetched before phase 4; the host checks of phases 18-20
    run meanwhile and are fetched where their phases need them."""
    import torch

    # 2. build
    t0 = time.perf_counter()
    libs = kernels.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for name in libs:
        for line in kernels.ptxas_report(name).splitlines():
            if any(k in line for k in ("Compiling entry", "registers",
                                       "spill")):
                print(f"[ptxas] {name}: {line.strip()}")

    side = pool.apply_async(side_checks, (wall0,))
    side_dyn = pool.apply_async(dynamic_checks, (wall0,))
    side12 = {w: pool.apply_async(slice12_checks, (w, wall0))
              for w in ("wide", "bf16")}
    side13 = pool.apply_async(slice13_checks, (wall0,))
    side14 = pool.apply_async(slice14_checks, (wall0,))
    prefetch = [pool.apply_async(host_prefetch, (wall0, part))
                for part in (0, 1)]
    side27 = pool.apply_async(slice27_checks, (wall0,))
    side28 = pool.apply_async(slice28_checks, (wall0,))
    side18 = pool.apply_async(shared_checks, (wall0,))
    side20 = pool.apply_async(slice20_checks, (wall0,))
    side21 = pool.apply_async(slice21_checks, (wall0,))
    side22 = pool.apply_async(slice22_checks, (wall0,))
    side23 = pool.apply_async(slice23_checks, (wall0,))
    side24 = pool.apply_async(slice24_checks, (wall0,))
    side25 = pool.apply_async(slice25_checks, (wall0,))
    side26 = pool.apply_async(slice26_checks, (wall0,))
    worst, plain = check_kernels(device, CHECK_SHAPES)
    _elapsed("K1/K2 checks", t_start)
    dyn_lines, dyn_worst = side_dyn.get()
    side_lines, side_worst, quant_layouts = side.get()
    s12_lines, s12_worst, s12_plain = side12["wide"].get()
    bf16_lines, bf16_worst, bf16_plain = side12["bf16"].get()
    s13_lines, s13_worst, s13_bit_equal = side13.get()
    s14_lines, s14_worst, s14_tiers = side14.get()
    pre_lines = []
    for task in prefetch:
        part_lines, part_memo = task.get()
        pre_lines += part_lines
        _MEMO.update(part_memo)
    for line in (dyn_lines + side_lines + s12_lines + bf16_lines
                 + s13_lines + s14_lines + pre_lines):
        print(line)
    worst.update(dyn_worst)
    worst.update(s13_worst)
    worst.update(s14_worst)
    worst.update(side_worst)
    s12_worst.update(bf16_worst)
    s12_plain.update(bf16_plain)
    worst.update(s12_worst)
    _elapsed("wide and bf16 K1/K2, wide K3-K5, warp K3 checks", t_start)

    # 4. LGSSM path at full width
    main = main_path(device, MAIN_B, MAIN_T, MAIN_D, reps=3)
    bounds = kernel_bounds(MAIN_B, MAIN_T, MAIN_D)
    plain_bounds = kernel_bounds(*PLAIN_SHAPE)
    _elapsed("LGSSM path", t_start)

    # 5. HMM path at the bench size
    hmm = hmm_path(device, HMM_B, HMM_T, HMM_IT, reps=3)
    hmm_shape = (HMM_B, HMM_T, HMM_K)
    fb_alone = time_fb_alone(device, [hmm_shape], smi)
    fbb = fb_bounds(*hmm_shape)
    _elapsed("HMM path", t_start)
    for name, ms_key in (("fused_fb_fwd", "fwd_ms"),
                         ("fused_fb_bwd", "bwd_ms")):
        print(f"[hmm] {name}: {hmm[ms_key]:.4f} ms, bound "
              f"{fbb[name]['bound_ms']:.6f} ms ({fbb[name]['bound_by']}), "
              f"roofline share {100 * fbb[name]['bound_ms'] / hmm[ms_key]:.3f}%;"
              f" plain {hmm['plain_ms'][name]:.2f} ms (its one call on the "
              f"path's inputs) at (B,T,K)={hmm_shape}")

    # 7. path A: the continuous-batching filter at full width
    filt = filter_path(device, FILTER_B, FILTER_T, FILTER_D, reps=3)
    filt_bound = filter_bound(FILTER_B, FILTER_T, FILTER_D, FILTER_D)
    _elapsed("path A", t_start)

    # 8. path B: quantized ingest, through the engine and through the
    # evidence entry points
    quant = quantized_program_path(device, MAIN_B, MAIN_T, MAIN_D, reps=3)
    ingest = quantized_ingest_path(device, INGEST_SHAPE, reps=3)
    q_bound = quantize_bound(*QUANT_SHAPE)
    q_ingest_bound = quantize_bound(*INGEST_SHAPE[:2])
    dq_bound = dequant_bound(*INGEST_SHAPE)
    _elapsed("path B", t_start)

    # 9. the single-dataset infer and the unfused chain path: no kernel
    inf = infer_lgssm_path(device, MAIN_T, MAIN_D, reps=2)
    inf_hmm = infer_hmm_path(device, HMM_T, HMM_IT, reps=2)
    unf = unfused_path(device, main, reps=1)
    del main["y"]
    nan_b = nan_batch_path(device, NAN_B, MAIN_T, MAIN_D)
    _elapsed("infer and the unfused path", t_start)

    # 10. the dynamic-precision tier: (a) ran beside phase 3; (b) lgssm_wtau
    # at full width, (c) at the scan path's shape against it, (d) W and Q
    # both random
    wtau = wtau_path(device, WTAU_B, WTAU_T, WTAU_D, WTAU_IT, reps=2)
    wtau_scan = wtau_vs_scan(device, *WTAU_SMALL, WTAU_D, WTAU_IT, reps=1)
    wq = wq_both_path(device, WQ_SHAPE, WQ_IT)
    dyn_bounds = dynamic_bounds(WTAU_B, WTAU_T, WTAU_D)
    _elapsed("the dynamic-precision tier", t_start)

    # 12. the Bethe free energy on the paths above: (a) the LGSSM cell, (b)
    # the HMM cell, (c) lgssm_wtau at (c)'s shape, (d) quantized ingest, (e)
    # config 2
    fe_a = fe_lgssm_path(device, MAIN_B, MAIN_T, MAIN_D, reps=2)
    fe_b = fe_hmm_path(device, HMM_B, HMM_T, HMM_IT, reps=2)
    fe_c = fe_wtau_path(device, *WTAU_SMALL, WTAU_D, WTAU_IT, reps=1)
    fe_d = fe_quant_path(device, MAIN_B, MAIN_T, MAIN_D, reps=2)
    fe_e = fe_config2_path(device, reps=2)
    _elapsed("the free energy", t_start)

    # 13. the GMM (config 4) and 14. the streaming engine (config 5): plain
    # groups and torch code, no kernel
    gmm = gmm_path(device, reps=3)
    _elapsed("the GMM", t_start)
    stream = stream_path(device, reps=3, path_a_ms=round(filt["call_ms"], 4))
    _elapsed("the streaming engine", t_start)

    # 15. (b) bench.py's d16 fused row on the wide kernels; (c) its bf16
    # row on the bf16 kernels, beside the float32 program
    d16 = d16_path(device, D16_B, D16_T, D16_D, reps=3)
    d16_bounds = kernel_bounds(D16_B, D16_T, D16_D)
    bf16 = bf16_path(device, MAIN_B, MAIN_T, MAIN_D, reps=3)
    bf16_bounds = kernel_bounds(MAIN_B, MAIN_T, MAIN_D, moment_bytes=2)
    _elapsed("the d16 and bf16 rows", t_start)

    # 16. (b) the 16-state HMM on the wide K4/K5; (d) path A at d = 16 on
    # the wide K3
    hmm16 = hmm16_path(device, HMM16_B, HMM16_T, HMM16_K, HMM16_M, HMM16_IT,
                       reps=2, smi=smi)
    hmm16_bounds = fb_wide_bounds(HMM16_B, HMM16_T, HMM16_K)
    _elapsed("the 16-state HMM", t_start)
    filt16 = filter_path(device, FILTER_B, FILTER_T, FILTER16_D, reps=2,
                         plain_steps=FILTER16_PLAIN_STEPS, tag="filter16")
    filt16_bound = filter_bound(FILTER_B, FILTER_T, FILTER16_D, FILTER16_D)
    _elapsed("the 16-state HMM and path A at d = 16", t_start)

    # 17. (b) path A at d = 32 on the warp K3
    filt32 = filter_path(device, FILTER_B, FILTER_T, FILTER32_D, reps=1,
                         plain_steps=FILTER32_PLAIN_STEPS, tag="filter32",
                         inner=1, warm_sync=True)
    filt32_bound = filter_bound(FILTER_B, FILTER_T, FILTER32_D, FILTER32_D)
    _elapsed("path A at d = 32", t_start)

    # 18. shared= pooling: (a) lgssm_wtau pooled, (b) chunked, (c) the
    # pooled process-noise model; (d) the generic mixture's evidence
    s18_lines, shared_host = side18.get()
    print("\n".join(s18_lines))
    shared = shared_wtau_path(device, shared_host, reps=2,
                              wtau_ms=wtau["program_ms"])
    hier = shared_hier_path(device, shared_host, reps=1)
    mixture = mixture_path(device)
    _elapsed("shared= pooling and the generic mixture", t_start)

    # 19. the AR and HGF chains and the dot-product mean, on the scans (no
    # kernel): (a) the latent AR, (b) the HGF, (c) the linear regression
    s20_lines, s20_host = side20.get()
    print("\n".join(s20_lines))
    lar_path(device, s20_host, reps=1, smi=smi)
    hgf_path(device, s20_host, reps=1, smi=smi)
    linreg_path(device, reps=1, smi=smi)
    _elapsed("the AR and HGF chains and the regression", t_start)

    # 20. the nonlinear nodes on the scans and plain groups (no kernel): (a)
    # the range-bearing fleet under Linearization, (b) under Unscented, (c)
    # probit and SoftDot, (d) CVIProjection; (e) the strict-fp32 LGSSM row
    s21_lines, s21_host = side21.get()
    print("\n".join(s21_lines))
    rb_path(device, s21_host, reps=1, smi=smi)
    glm_path(device, s21_host, reps=3, smi=smi)
    cvi_path(device, s21_host, smi=smi)
    strict = strict_path(device, reps=3, smi=smi)
    _elapsed("the nonlinear nodes and the strict-fp32 row", t_start)

    # 21. constraints: (a) the online HGF fleet under the reference
    # constraint, (b) ProjectedTo over a batch, (c) MeanField() on the
    # Gaussian cell and the LGSSM cell
    s22_lines, s22_host = side22.get()
    print("\n".join(s22_lines))
    hgf_stream_path(device, s22_host, smi=smi)
    projection_path(device, s22_host, smi=smi)
    mean_field_paths(device, s22_host, smi=smi)
    _elapsed("the constraints", t_start)

    # 22. the rest of the node library on plain groups (no kernel): (a)
    # counts, (b) a noise level, (c) covariances, (d) sums
    s23_lines, s23_host = side23.get()
    print("\n".join(s23_lines))
    a6d = a6d_paths(device, s23_host, smi=smi)
    _elapsed("the rest of the node library", t_start)

    # 23. grid data and grid latents, the logic, Polya and
    # continuous-transition nodes, and the affine custom-transition pair,
    # on plain groups (no kernel)
    s24_lines, s24_host = side24.get()
    print("\n".join(s24_lines))
    t23 = time.perf_counter()
    a6e = a6e_paths(device, s24_host, smi=smi)
    print(f"[a6e] phase 23 took {time.perf_counter() - t23:.1f} s; {smi}")
    _elapsed("grids, logic, Polya, continuous transitions and the custom "
             "pair", t_start)

    # 24. submodels (K1/K2 through the LGSSM written as submodels), folded
    # data, node contraction, the streaming engine's meta, annotations and
    # postprocess, checkpoints and early stopping
    s25_lines, s25_host = side25.get()
    print("\n".join(s25_lines))
    t24 = time.perf_counter()
    s24 = slice25_paths(device, s25_host, smi=smi)
    print(f"[s24] phase 24 took {time.perf_counter() - t24:.1f} s; {smi}")
    _elapsed("submodels, folding, contraction, the engine's A4c and "
             "checkpoints", t_start)

    # 25. the mesh entry points on a one-rank NCCL world: (a) infer_batched
    # (shared= through the all_reduce), (b) the time-sharded infer row, (c)
    # the sharded filter, (d) the streaming engine, (e) the hybrid-mesh
    # step; each against the same call without a mesh
    s26_lines, s26_host = side26.get()
    print("\n".join(s26_lines))
    t25 = time.perf_counter()
    with one_rank_world(device):
        s25 = slice26_paths(device, s26_host, smi=smi)
    print(f"[s25] phase 25 took {time.perf_counter() - t25:.1f} s; {smi}")
    _elapsed("the mesh entry points", t_start)

    # 26. the two kernel tiers redesigned for the card: (a) path A at d = dy
    # = 64 on the warp K3's tier past 32, the sweep tier beside it; (b) a
    # 32-state HMM on the wide K4/K5, the marginal kernel past 16 states
    s27_lines, s27_worst, s27_memo = side27.get()
    print("\n".join(s27_lines))
    _MEMO.update(s27_memo)
    worst["fused_filter_warp"] = max(worst["fused_filter_warp"],
                                     s27_worst["fused_filter_warp"])
    t26 = time.perf_counter()
    filt64 = tier_filter_path(device, FILTER64_D, smi=smi)
    hmm32 = hmm16_path(device, HMM32_B, HMM32_T, HMM32_K, HMM32_M, HMM32_IT,
                       reps=2, smi=smi)
    hmm32_bounds = fb_wide_bounds(HMM32_B, HMM32_T, HMM32_K)
    print(f"[s26] phase 26 took {time.perf_counter() - t26:.1f} s; {smi}")
    _elapsed("path A at d = 64 and the 32-state HMM", t_start)

    # 27. the last two first-written tiers redesigned for the card: (a) path
    # A at d = dy = 128 on the warp K3's tier past 64, the sweep tier beside
    # it; (b) a 64-state HMM on the wide K4/K5, the marginal kernel past 32
    # states beside fb_wide_marg_kernel
    s28_lines, s28_memo = side28.get()
    print("\n".join(s28_lines))
    _MEMO.update(s28_memo)
    t27 = time.perf_counter()
    filt128 = tier_filter_path(device, FILTER128_D, smi=smi)
    hmm64 = hmm16_path(device, HMM64_B, HMM64_T, HMM64_K, HMM64_M, HMM64_IT,
                       reps=1, smi=smi, beside_first_written=True)
    hmm64_bounds = fb_wide_bounds(HMM64_B, HMM64_T, HMM64_K)
    print(f"[s27] phase 27 took {time.perf_counter() - t27:.1f} s; {smi}")
    _elapsed("path A at d = 128 and the 64-state HMM", t_start)
    shared_launches = {"wtau_pooled": shared["launches"],
                       "wtau_pooled_chunked": shared["chunked_launches"],
                       "hier_pooled": hier["launches"]}
    fe_launches = {
        "fused_smoother_fwd": {"lgssm": 1, "int8": 1, "float8_e4m3fn": 1},
        "fused_smoother_bwd": {"lgssm": 1, "int8": 1, "float8_e4m3fn": 1,
                               "lgssm_wtau": WTAU_IT},
        "fused_smoother_fwd_dyn": {"lgssm_wtau": WTAU_IT},
        "fused_fb_fwd": {"hmm": HMM_IT}, "fused_fb_bwd": {"hmm": HMM_IT},
        "fused_fb_serial_wide": {"hmm16": HMM16_IT},
        "fused_fb_marg_wide": {"hmm16": HMM16_IT},
        "quantize_rows": {"int8": 1}, "quantize_rows_fp8": {"float8_e4m3fn": 1},
    }
    # the counts each phase 12 path read (expect_launches held them)
    fe_read = {"lgssm": fe_a["launches"], "hmm": fe_b["launches"],
               "lgssm_wtau": fe_c["launches"], "hmm16": hmm16["fe_launches"],
               **fe_d["launches"]}
    for name, per_path in fe_launches.items():
        for path, n in per_path.items():
            if fe_read[path][name] != n:
                raise AssertionError(f"{name} on the FE path {path}: "
                                     f"{fe_read[path][name]} launches")
    dyn_plain = {
        "fused_smoother_fwd_dyn": (wtau["plain_ms"], wtau["plain_shape"]),
        "fused_smoother_bwd_dyn": (wq["plain_ms"]["fused_smoother_bwd_dyn"],
                                   list(WQ_SHAPE))}
    for name, ms_key in (("fused_smoother_fwd_dyn", "fwd_alone_ms"),
                         ("fused_smoother_bwd_dyn", "bwd_dyn_alone_ms")):
        print(f"[wtau] {name}: {wtau[ms_key]:.4f} ms at (B,T,d)="
              f"{(WTAU_B, WTAU_T, WTAU_D)}, bound "
              f"{dyn_bounds[name]['bound_ms']:.4f} ms "
              f"({dyn_bounds[name]['bound_by']}), roofline share "
              f"{100 * dyn_bounds[name]['bound_ms'] / wtau[ms_key]:.2f}%; "
              f"plain {dyn_plain[name][0]:.1f} ms at (B,T,d)="
              f"{tuple(dyn_plain[name][1])}")
    print(f"[filter] fused_filter: {filt['kernel_ms']:.4f} ms, bound "
          f"{filt_bound['bound_ms']:.4f} ms ({filt_bound['bound_by']}), "
          f"roofline share "
          f"{100 * filt_bound['bound_ms'] / filt['kernel_ms']:.2f}%")
    for name, label in (("quantize_rows", "int8"),
                        ("quantize_rows_fp8", "float8_e4m3fn")):
        print(f"[quant] {name}: {quant['kernel_ms'][name]:.4f} ms at rows "
              f"{QUANT_SHAPE} ({quant['layout']}), bound "
              f"{q_bound['bound_ms']:.4f} ms ({q_bound['bound_by']}), "
              f"roofline share "
              f"{100 * q_bound['bound_ms'] / quant['kernel_ms'][name]:.2f}%; "
              f"{ingest['quantize_ms'][label]:.4f} ms at rows "
              f"{INGEST_SHAPE[:2]} ({ingest['layout']}), bound "
              f"{q_ingest_bound['bound_ms']:.4f} ms, roofline share "
              f"{100 * q_ingest_bound['bound_ms'] / ingest['quantize_ms'][label]:.2f}%")
    print(f"[ingest] dequant_matmul ({ingest['dequant_layout']}): "
          f"{ingest['dequant_device_ms']['int8']} ms device, bound "
          f"{dq_bound['bound_ms']:.4f} ms ({dq_bound['bound_by']}), share of "
          f"the bound {_share(dq_bound['bound_ms'], ingest['dequant_device_ms']['int8'])}")

    for name, ms_key in (("fused_smoother_fwd", "fwd_ms"),
                         ("fused_smoother_bwd", "bwd_ms")):
        print(f"[main] {name}: {main[ms_key]:.4f} ms, bound "
              f"{bounds[name]['bound_ms']:.4f} ms ({bounds[name]['bound_by']}),"
              f" roofline share {100 * bounds[name]['bound_ms'] / main[ms_key]:.2f}%;"
              f" plain {plain[name]['plain_ms']:.2f} ms vs kernel "
              f"{plain[name]['ms']:.4f} ms at (B,T,d)={PLAIN_SHAPE}")

    # 11. the kernels line
    source = "rxinfer_tpu_torch/csrc/fused_smoother.cu"
    rows = []
    for name, replaces, ms_key in (
            ("fused_smoother_fwd", "rxinfer_tpu/ops/pallas_smoother.py:76",
             "fwd_ms"),
            ("fused_smoother_bwd", "rxinfer_tpu/ops/pallas_smoother.py:139",
             "bwd_ms")):
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main["launches"][name],
            "max_abs_err": worst[name], "ms": main[ms_key],
            "ms_in_path": main["profile"]["kernels"][name]["ms_per_launch"],
            "ms_in_path_by_pass": main["profile"]["kernels"][name].get("parts"),
            "blocks": main["blocks"],
            "scratch_bytes": main["scratch_bytes"][name],
            "plain_ms": plain[name]["plain_ms"],
            "bound_ms": bounds[name]["bound_ms"],
            "bound_by": bounds[name]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes a Kalman/RTS "
                            "smoother",
            "shape_BTd": [MAIN_B, MAIN_T, MAIN_D],
            "bytes": bounds[name]["bytes"], "ops": bounds[name]["ops"],
            "plain_shape_BTd": list(PLAIN_SHAPE),
            "ms_at_plain_shape": plain[name]["ms"],
            "bound_ms_at_plain_shape": plain_bounds[name]["bound_ms"],
        })
    # lgssm_wtau runs the static K2 (W alone is per chain)
    rows[1]["launches_wtau_path"] = wtau["launches"]["fused_smoother_bwd"]
    for row, name in zip(rows, ("fused_smoother_fwd", "fused_smoother_bwd")):
        row["launches_strict_path"] = strict["launches"][name]
        row["ms_strict_program"] = strict["ms"]["strict"]
    rows[1]["ms_in_wtau_path"] = wtau["profile"]["kernels"][
        "fused_smoother_bwd"]["ms_per_launch"]
    rows[1]["ms_alone_wtau_shape"] = wtau["bwd_alone_ms"]
    fb_source = "rxinfer_tpu_torch/csrc/fused_fb.cu"
    from rxinfer_tpu_torch.ops import fused_fb as ffb

    main_alone = fb_alone[hmm_shape]
    marg_tile = main_alone["tile"]
    fb_tiles = {
        "fused_fb_fwd": {"staged_steps": ffb.STAGED_STEPS},
        "fused_fb_bwd": {"staged_steps": ffb.STAGED_STEPS,
                         "marginal_steps": marg_tile,
                         "marginal_tiles": -(-HMM_T // marg_tile)}}
    for name, replaces, ms_key in (
            ("fused_fb_fwd", "rxinfer_tpu/ops/pallas_discrete.py:48",
             "fwd_ms"),
            ("fused_fb_bwd", "rxinfer_tpu/ops/pallas_discrete.py:87",
             "bwd_ms")):
        rows.append({
            "name": name, "route": "cuda", "source": fb_source,
            "replaces": replaces, "launches": hmm["launches"][name],
            "max_abs_err": max(worst[name], hmm["kernel_errs"][name]),
            "max_abs_err_on_path": hmm["kernel_errs"][name],
            "ms": hmm[ms_key],
            "ms_in_path": hmm["profile"]["kernels"][name]["ms_per_launch"],
            "ms_in_path_by_pass": hmm["profile"]["kernels"][name].get(
                "parts"),
            "tile": fb_tiles[name],
            "cycles_per_step": _cycles_per_step(
                hmm["profile"]["kernels"][name]["ms_per_launch"],
                main_alone["sm_clock_mhz"], HMM_T),
            "sm_clock_mhz": main_alone["sm_clock_mhz"],
            "ms_alone": {"x".join(map(str, shp)): row[name]
                         for shp, row in fb_alone.items()},
            "ms_alone_wall": {"x".join(map(str, shp)): row["wall_ms"][name]
                              for shp, row in fb_alone.items()},
            "plain_ms": hmm["plain_ms"][name],
            "bound_ms": fbb[name]["bound_ms"],
            "bound_by": fbb[name]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes an HMM "
                            "forward-backward",
            "shape_BTK": list(hmm_shape),
            "bytes": fbb[name]["bytes"], "ops": fbb[name]["ops"],
            "plain_shape_BTK": list(hmm_shape),
        })
    rows.append({
        "name": "fused_filter", "route": "cuda",
        "source": "rxinfer_tpu_torch/csrc/fused_filter.cu",
        "replaces": "rxinfer_tpu/ops/pallas_filter.py:84",
        "launches": filt["launches"]["fused_filter"],
        "max_abs_err": max(worst["fused_filter"], filt["kernel_err"]),
        "max_abs_err_on_path": filt["kernel_err"],
        "ms": filt["kernel_ms"],
        "ms_in_path": filt["profile"]["kernels"]["fused_filter"][
            "ms_per_launch"],
        "plain_ms": filt["plain_kernel_ms"],
        "bound_ms": filt_bound["bound_ms"],
        "bound_by": filt_bound["bound_by"], "library_ms": None,
        "library_note": "no single PyTorch call computes a Kalman filter",
        "shape_BTddy": [FILTER_B, FILTER_T, FILTER_D, FILTER_D],
        "bytes": filt_bound["bytes"], "ops": filt_bound["ops"],
        "cycles_per_step": filt["cycles_per_step"],
        "sm_clock_mhz": filt["sm_clock_mhz"],
        "share_of_bound": filt_bound["bound_ms"] / filt["kernel_ms"],
    })
    q_source = "rxinfer_tpu_torch/csrc/quantized.cu"
    for name, replaces, label in (
            ("quantize_rows", "rxinfer_tpu/ops/quantized.py:50", "int8"),
            ("quantize_rows_fp8", "rxinfer_tpu/ops/quantized.py:153",
             "float8_e4m3fn")):
        it_last = QUANT_ITERATIONS[-1]
        rows.append({
            "name": name, "route": "cuda", "source": q_source,
            "replaces": replaces,
            "launches": quant["launches"][(label, it_last)][name],
            "launches_in_ingest_call": ingest["launches"][label][name],
            "max_abs_err": worst[name], "ms": quant["kernel_ms"][name],
            "ms_in_path": quant["profile"][label]["kernels"][name][
                "ms_per_launch"],
            "plain_ms": quant["plain_ms"][name],
            "bound_ms": q_bound["bound_ms"], "bound_by": q_bound["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes a per-row "
                            "scaled quantization",
            "shape_RC": list(QUANT_SHAPE),
            "bytes": q_bound["bytes"], "ops": q_bound["ops"],
            "ingest_shape_RC": list(INGEST_SHAPE[:2]),
            "ms_at_ingest_shape": ingest["quantize_ms"][label],
            "ms_in_path_at_ingest_shape": ingest[
                "profile" if label == "int8" else "profile_fp8"]["kernels"][
                name]["ms_per_launch"],
            "plain_ms_at_ingest_shape": ingest["quantize_plain_ms"][label],
            "bound_ms_at_ingest_shape": q_ingest_bound["bound_ms"],
            "variant": quant["layout"],
            "variant_at_ingest_shape": ingest["layout"],
            "share_of_bound": q_bound["bound_ms"] / quant["kernel_ms"][name],
            "share_of_bound_at_ingest_shape":
                q_ingest_bound["bound_ms"] / ingest["quantize_ms"][label],
            "variants_checked": {
                "x".join(map(str, k)): _layout_name(v)
                for k, v in quant_layouts["quantize"].items()},
            "copy_gb_per_s": quant["copy_bytes_per_s"] / 1e9,
            "copy_gb_per_s_at_ingest_shape": ingest["copy_bytes_per_s"] / 1e9,
        })
    rows.append({
        "name": "dequant_matmul", "route": "cuda", "source": q_source,
        "replaces": "rxinfer_tpu/ops/quantized.py:107",
        "launches": ingest["launches"]["int8"]["dequant_matmul"],
        "launches_in_fp8_call": ingest["launches"]["float8_e4m3fn"][
            "dequant_matmul"],
        "max_abs_err": worst["dequant_matmul"],
        "ms": ingest["dequant_device_ms"]["int8"],
        "ms_fp8": ingest["dequant_device_ms"]["float8_e4m3fn"],
        "ms_events": ingest["dequant_ms"]["int8"],
        "ms_events_fp8": ingest["dequant_ms"]["float8_e4m3fn"],
        "ms_in_path": ingest["profile"]["kernels"]["dequant_matmul"][
            "ms_per_launch"],
        "plain_ms": ingest["dequant_plain_ms"]["int8"],
        "bound_ms": dq_bound["bound_ms"], "bound_by": dq_bound["bound_by"],
        "library_ms": ingest["library_ms"],
        "library_note": "torch.matmul on the matrix already dequantized to "
                        "float32: the product alone",
        "shape_Rdydx": list(INGEST_SHAPE),
        "bytes": dq_bound["bytes"], "ops": dq_bound["ops"],
        "bytes_per_s": ingest["dequant_bytes_per_s"]["int8"],
        "variant": ingest["dequant_layout"],
        "share_of_bound": _share(dq_bound["bound_ms"],
                                 ingest["dequant_device_ms"]["int8"]),
        "share_of_bound_fp8": _share(
            dq_bound["bound_ms"], ingest["dequant_device_ms"]["float8_e4m3fn"]),
        "copy_gb_per_s": ingest["copy_dequant_bytes_per_s"] / 1e9,
        "variants_checked": {"x".join(map(str, k)): str(v)
                             for k, v in quant_layouts["dequant"].items()},
        "w_tiles_checked": {"x".join(map(str, k)): list(v) for k, v in
                            quant_layouts["dequant_tiles"].items()},
    })
    # K1 with per-chain W: launched on lgssm_wtau (and, with Q per chain
    # too, on the W-and-Q path); K2 with per-chain Q: launched on the
    # W-and-Q path only.  "ms" is each alone at lgssm_wtau's shape, beside
    # the bound there; "ms_in_path" is in the path that launches it.
    wq_bounds = dynamic_bounds(*WQ_SHAPE)
    dyn_rows = {
        "fused_smoother_fwd_dyn": dict(
            replaces="rxinfer_tpu/ops/pallas_smoother.py:76",
            path="lgssm_wtau", per_chain="W",
            launches=wtau["launches"]["fused_smoother_fwd_dyn"],
            launches_wq_path=wq["launches"]["fused_smoother_fwd_dyn"],
            max_abs_err=max(worst["fused_smoother_fwd_dyn"],
                            wtau["kernel_err"],
                            wq["kernel_errs"]["fused_smoother_fwd_dyn"]),
            max_abs_err_on_path=wtau["kernel_err"],
            check_on_path_BTd=wtau["check_shape"],
            max_abs_err_on_wq_path=wq["kernel_errs"][
                "fused_smoother_fwd_dyn"],
            ms=wtau["fwd_alone_ms"],
            ms_in_path=wtau["profile"]["kernels"]["fused_smoother_fwd_dyn"][
                "ms_per_launch"],
            ms_in_path_by_pass=wtau["profile"]["kernels"][
                "fused_smoother_fwd_dyn"].get("parts"),
            blocks=wtau["blocks"], path_shape_BTd=[WTAU_B, WTAU_T, WTAU_D]),
        "fused_smoother_bwd_dyn": dict(
            replaces="rxinfer_tpu/ops/pallas_smoother.py:139",
            path="W-and-Q model", per_chain="Q",
            launches=wq["launches"]["fused_smoother_bwd_dyn"],
            max_abs_err=max(worst["fused_smoother_bwd_dyn"],
                            wq["kernel_errs"]["fused_smoother_bwd_dyn"]),
            max_abs_err_on_path=wq["kernel_errs"]["fused_smoother_bwd_dyn"],
            check_on_path_BTd=list(WQ_SHAPE),
            ms=wtau["bwd_dyn_alone_ms"],
            ms_in_path=wq["profile"]["kernels"]["fused_smoother_bwd_dyn"][
                "ms_per_launch"],
            ms_in_path_by_pass=wq["profile"]["kernels"][
                "fused_smoother_bwd_dyn"].get("parts"),
            bound_ms_at_path_shape=wq_bounds["fused_smoother_bwd_dyn"][
                "bound_ms"],
            blocks=wq["blocks"], path_shape_BTd=list(WQ_SHAPE)),
    }
    for name, row in dyn_rows.items():
        rows.append({
            "name": name, "route": "cuda", "source": source, **row,
            "plain_ms": dyn_plain[name][0],
            "plain_shape_BTd": dyn_plain[name][1],
            "bound_ms": dyn_bounds[name]["bound_ms"],
            "bound_by": dyn_bounds[name]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes a Kalman/RTS "
                            "smoother",
            "shape_BTd": [WTAU_B, WTAU_T, WTAU_D],
            "bytes": dyn_bounds[name]["bytes"], "ops": dyn_bounds[name]["ops"],
        })
    print(f"[wtau] program_ms {wtau['program_ms']:.4f} updates_per_s "
          f"{wtau['updates_per_s']:.6g} (B={WTAU_B}, T={WTAU_T}, d={WTAU_D}, "
          f"iterations={WTAU_IT}); at B={WTAU_SMALL[0]} T={WTAU_SMALL[1]} "
          f"dynamic {wtau_scan['dyn_ms']:.4f} ms against "
          f"fused_kernels=False {wtau_scan['scan_ms']:.4f} ms")
    print(f"[filter] call_ms {filt['call_ms']:.4f} chain_updates_per_s "
          f"{filt['updates_per_s']:.6g} (B={FILTER_B}, T={FILTER_T}, "
          f"d={FILTER_D})")
    print(f"[hmm] program_ms {hmm['program_ms']:.4f} updates_per_s "
          f"{hmm['updates_per_s']:.6g} (B={HMM_B}, T={HMM_T}, "
          f"iterations={HMM_IT})")
    print(f"[infer] lgssm_ms {inf['ms']:.4f} updates_per_s "
          f"{inf['updates_per_s']:.6g} (T={MAIN_T}, d={MAIN_D}); hmm_ms "
          f"{inf_hmm['ms']:.4f} (T={HMM_T}, iterations={HMM_IT}); unfused "
          f"program_ms {unf['ms']:.4f} against fused {unf['fused_ms']:.4f} "
          f"(B={MAIN_B}); NaN batch ms {nan_b['ms']:.1f} (B={NAN_B})")
    print(f"[main] program_ms {main['program_ms']:.4f} updates_per_s "
          f"{main['updates_per_s']:.6g} (B={MAIN_B}, T={MAIN_T}, d={MAIN_D}); "
          f"total run {time.perf_counter() - t_start:.1f} s")
    # the wide kernels (d16 row) and the bf16 register kernels (bf16 row);
    # their other instantiations (per-chain W / Q, bf16 wide) are checked
    # in 15 (a) and listed with their errors under "variants_checked"
    slice12 = (
        ("fused_smoother_fwd_wide", "rxinfer_tpu/ops/pallas_smoother.py:76",
         "rxinfer_tpu_torch/csrc/fused_smoother_wide.cu", d16, d16_bounds,
         "fused_smoother_fwd", "fwd_ms", [D16_B, D16_T, D16_D]),
        ("fused_smoother_bwd_wide", "rxinfer_tpu/ops/pallas_smoother.py:139",
         "rxinfer_tpu_torch/csrc/fused_smoother_wide.cu", d16, d16_bounds,
         "fused_smoother_bwd", "bwd_ms", [D16_B, D16_T, D16_D]),
        ("fused_smoother_fwd_bf16", "rxinfer_tpu/ops/pallas_smoother.py:76",
         "rxinfer_tpu_torch/csrc/fused_smoother_bf16.cu", bf16, bf16_bounds,
         "fused_smoother_fwd", "fwd_ms", [MAIN_B, MAIN_T, MAIN_D]),
        ("fused_smoother_bwd_bf16", "rxinfer_tpu/ops/pallas_smoother.py:139",
         "rxinfer_tpu_torch/csrc/fused_smoother_bf16.cu", bf16, bf16_bounds,
         "fused_smoother_bwd", "bwd_ms", [MAIN_B, MAIN_T, MAIN_D]),
    )
    smoother_wide_ptxas = [line.strip() for line in kernels.ptxas_report(
        "fused_smoother_wide").splitlines() if any(
        k in line for k in ("Compiling entry", "registers", "spill"))]
    for name, replaces, src, path, bnds, bkey, ms_key, shape in slice12:
        direction = "_fwd" if "_fwd" in name else "_bwd"
        wide = "_wide" in name
        variants = {k: v for k, v in s12_worst.items()
                    if direction in k and ("_wide" in k) == wide
                    and (wide or "_bf16" in k)}
        prof = path["profile"]["kernels"][name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": path["launches"][name],
            "max_abs_err": s12_worst[name], "ms": path[ms_key],
            "ms_in_path": prof["ms_per_launch"],
            "ms_in_path_by_pass": prof.get("parts"),
            "plain_ms": s12_plain[name]["plain_ms"],
            "plain_shape_BTd": list(WIDE_PLAIN_SHAPE) if "_wide" in name
            else list(CHECK_SHAPES[0]),
            "bound_ms": bnds[bkey]["bound_ms"],
            "bound_by": bnds[bkey]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes a Kalman/RTS "
                            "smoother",
            "shape_BTd": shape, "bytes": bnds[bkey]["bytes"],
            "ops": bnds[bkey]["ops"],
            "ms_at_plain_shape": s12_plain[name]["ms"],
            "variants_checked": variants,
        })
        if wide:
            rows[-1].update({
                "device_kernel": WIDE_KERNEL_NAMES[name],
                "max_abs_err_one_observation_vs_float64":
                    s12_worst["one_observation"],
                "one_observation_BTd": [ONE_OBS_B, ONE_OBS_T,
                                        ONE_OBS_WIDE_D],
                "bound_ms_fp32": bnds[bkey]["bound_ms_fp32"],
                "ops_tensor_cores": bnds[bkey]["ops_tensor_cores"],
                "cycles_per_step": path["cycles_per_step"][name],
                "sm_clock_mhz": path["sm_clock_mhz"],
                "kernel_shape": path["shape"],
                "ptxas": smoother_wide_ptxas})
    for name in ("fused_smoother_fwd_bf16", "fused_smoother_bwd_bf16"):
        f32 = "fused_smoother_fwd" if "fwd" in name else "fused_smoother_bwd"
        ms_key = "fwd_ms" if "fwd" in name else "bwd_ms"
        print(f"[bf16] {name}: {bf16[ms_key]:.4f} ms alone, in the program "
              f"{bf16['profile']['kernels'][name]['ms_per_launch']} ms at "
              f"(B,T,d)={(MAIN_B, MAIN_T, MAIN_D)}, bound "
              f"{bf16_bounds[f32]['bound_ms']:.4f} ms "
              f"({bf16_bounds[f32]['bound_by']}); float32 {main[ms_key]:.4f}"
              f" ms against its bound {bounds[f32]['bound_ms']:.4f}; {smi}")
    shape16 = d16["shape"]
    for name in ("fused_smoother_fwd_wide", "fused_smoother_bwd_wide"):
        f32 = "fused_smoother_fwd" if "fwd" in name else "fused_smoother_bwd"
        ms = d16["fwd_ms" if "fwd" in name else "bwd_ms"]
        bnd = d16_bounds[f32]
        warps = shape16["fwd_warps_per_sm" if "fwd" in name
                        else "bwd_warps_per_sm"]
        layout = (f"{shape16['fwd_chains_per_warp']} chain(s) a warp"
                  if "fwd" in name else
                  f"a chain a consumer warp and {shape16['bwd_producers']} "
                  f"producer warp(s) of {shape16['bwd_steps_per_round']} "
                  "step(s) a round")
        print(f"[d16] {WIDE_KERNEL_NAMES[name]} ({name}): {ms:.4f} ms alone,"
              f" in the program "
              f"{d16['profile']['kernels'][name]['ms_per_launch']} ms; "
              f"cycles a step {d16['cycles_per_step'][name]} at "
              f"{d16['sm_clock_mhz']:.0f} MHz; bound {bnd['bound_ms']:.4f} ms"
              f" ({bnd['bound_by']}; the tensor cores' "
              f"{bnd['ops_tensor_cores']} operations at 3xTF32), "
              f"{bnd['bound_ms_fp32']:.4f} ms at float32 only; roofline "
              f"share {100 * bnd['bound_ms'] / ms:.2f}% "
              f"({100 * bnd['bound_ms_fp32'] / ms:.2f}% at float32); "
              f"{warps} warps an SM, {layout}; at (B,T,d)="
              f"{(D16_B, D16_T, D16_D)}; {smi}")
    print(f"[d16] program_ms {d16['program_ms']:.4f} updates_per_s "
          f"{d16['updates_per_s']:.6g} (B={D16_B}, T={D16_T}, d={D16_D}), "
          f"peak {d16['peak_bytes'] / 1e9:.3f} GB; {smi}")
    print(f"[bf16] program_ms {bf16['program_ms']:.4f} updates_per_s "
          f"{bf16['updates_per_s']:.6g} against float32 "
          f"{bf16['program_ms_fp32']:.4f} ({bf16['updates_per_s_fp32']:.6g}) "
          f"(B={MAIN_B}, T={MAIN_T}, d={MAIN_D}); {smi}")

    # the wide K4/K5 (16-state HMM: the serial launch of both recursions and
    # the marginal launch) and the wide K3 (path A at d = 16); their other
    # shapes are checked in 16 (a) / (c)
    hmm16_shape = (HMM16_B, HMM16_T, HMM16_K)
    tile16 = hmm16["tile"]
    fb_wide_ptxas = [line.strip() for line in kernels.ptxas_report(
        "fused_fb_wide").splitlines() if any(
        k in line for k in ("Compiling entry", "registers", "spill"))]
    for name, replaces, variant, earlier in (
            ("fused_fb_serial_wide", "rxinfer_tpu/ops/pallas_discrete.py:48",
             "fb_wide_serial_kernel<16>: K4 and K5's beta recursion in one "
             "launch, a forward and a beta warp a chain side by side, each "
             "log-sum-exp split over the half-warps",
             {"fused_fb_fwd_wide": "fb_wide_fwd_kernel<16>, a launch of "
              "its own",
              "fused_fb_bwd_wide (beta)": "fb_wide_beta_kernel<16>, a "
              "launch of its own"}),
            ("fused_fb_marg_wide", "rxinfer_tpu/ops/pallas_discrete.py:87",
             "fb_wide_marg_half_kernel + fb_xisum_kernel: K5's marginals, a "
             "half-warp a (tile, chain), shuffle sums, 16-byte stores",
             {"fused_fb_bwd_wide (marginals)": "fb_wide_marg_kernel<16>, "
              "a warp a (tile, chain)"})):
        prof = hmm16["profile"]["kernels"][name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "rxinfer_tpu_torch/csrc/fused_fb_wide.cu",
            "replaces": replaces, "variant": variant,
            "earlier_variant": earlier,
            "launches": hmm16["launches"][name],
            "max_abs_err": max(worst[name], hmm16["kernel_errs"][name]),
            "max_abs_err_on_path": hmm16["kernel_errs"][name],
            "bit_equal_to_plain_at_checked_shapes": s13_bit_equal,
            "ms": hmm16["alone_ms"][name],
            "ms_in_path": prof["ms_per_launch"],
            "ms_in_path_by_pass": prof.get("parts"),
            "ms_alone_by_pass": {
                "forward": hmm16["alone_ms"]["fused_fb_fwd_wide"],
                "beta": hmm16["alone_ms"]["beta_alone"]}
            if name == "fused_fb_serial_wide" else None,
            "ms_wrappers_alone": {n: hmm16["alone_ms"][n] for n in (
                "fused_fb_fwd_wide", "fused_fb_bwd_wide")},
            "cycles_per_step": hmm16["cycles_per_step"][name],
            "sm_clock_mhz": hmm16["sm_clock_mhz"],
            "tile": {"marginal_steps": tile16,
                     "marginal_tiles": -(-HMM16_T // tile16),
                     "marginal_warps_per_sm": hmm16["marginal_warps_per_sm"]},
            "serial_plan": ffb.wide_serial_plan(HMM16_K, device),
            "ptxas": fb_wide_ptxas,
            "plain_ms": hmm16["plain_ms"][name],
            "plain_shape_BTK": list(hmm16_shape),
            "bound_ms": hmm16_bounds[name]["bound_ms"],
            "bound_by": hmm16_bounds[name]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes an HMM "
                            "forward-backward",
            "shape_BTK": list(hmm16_shape),
            "bytes": hmm16_bounds[name]["bytes"],
            "ops": hmm16_bounds[name]["ops"],
            "shapes_checked": ["x".join(map(str, s))
                               for s in FB_WIDE_CHECK_SHAPES],
        })
        print(f"[hmm16] {name}: {hmm16['alone_ms'][name]:.4f} ms "
              f"alone, in the program {prof['ms_per_launch']} ms (passes "
              f"{prof.get('parts')}), bound "
              f"{hmm16_bounds[name]['bound_ms']:.6f} ms "
              f"({hmm16_bounds[name]['bound_by']}); plain "
              f"{hmm16['plain_ms'][name]:.1f} ms at (B,T,K)={hmm16_shape}; "
              f"{smi}")
    # the wide K3 (path A at d = 16); its other shapes are checked in 16 (c)
    from rxinfer_tpu_torch.ops import fused_filter as ff

    wide_ptxas = [line.strip() for line in kernels.ptxas_report(
        "fused_filter_wide").splitlines() if any(
        k in line for k in ("Compiling entry", "registers", "spill"))]
    regs = re.search(r"Used (\d+) registers", " ".join(wide_ptxas))
    spills = re.findall(r"(\d+) bytes spill (?:stores|loads)",
                        " ".join(wide_ptxas))
    wide_shape = ff.wide_filter_shape(device)
    print(f"[filter16] wide K3: {wide_shape['warps_per_sm']} warps an SM, "
          f"{wide_shape}; ptxas: " + " | ".join(wide_ptxas))
    rows.append({
        "name": "fused_filter_wide", "route": "cuda",
        "source": "rxinfer_tpu_torch/csrc/fused_filter_wide.cu",
        "replaces": "rxinfer_tpu/ops/pallas_filter.py:84",
        "variant": "wide_filter_tc_kernel: a chain a warp on the wide K1's "
                   "tensor-core step (csrc/wide_step.cuh: 3xTF32 products, "
                   "Schur inverses at 8, leaves by "
                   + ("pivot pairs" if wide_shape["pivot_pairs"] else
                      "single pivots")
                   + "); the evidence XI = HR Y of the block's eight chains "
                   "one m16n8k8 tile a step in 3xTF32, the means staged and "
                   "written a row of eight chains at a time, "
                   f"{wide_shape['staged_steps']} steps between barriers",
        "earlier_variant": "wide_filter_kernel (a chain on 16 lanes, the "
                           "row step of wide_rows.cuh)",
        "launches": filt16["launches"]["fused_filter_wide"],
        "max_abs_err": max(worst["fused_filter_wide"], filt16["kernel_err"]),
        "max_abs_err_on_path": filt16["kernel_err"],
        "ms": filt16["kernel_ms"],
        "ms_in_path": filt16["profile"]["kernels"]["fused_filter_wide"][
            "ms_per_launch"],
        "plain_ms": filt16["plain_kernel_ms"],
        "plain_shape_BTddy": [FILTER_B, filt16["plain_steps"], FILTER16_D,
                              FILTER16_D],
        "bound_ms": filt16_bound["bound_ms"],
        "bound_by": filt16_bound["bound_by"],
        "bound_ms_fp32": filt16_bound["bound_ms_fp32"], "library_ms": None,
        "library_note": "no single PyTorch call computes a Kalman filter",
        "shape_BTddy": [FILTER_B, FILTER_T, FILTER16_D, FILTER16_D],
        "bytes": filt16_bound["bytes"], "ops": filt16_bound["ops"],
        "ops_tensor_cores": filt16_bound["ops_tensor_cores"],
        "bound_rates": "ops_tensor_cores at 3xTF32 (495e12 / 3 op/s), the "
                       "other ops at 67e12 op/s, bytes at 3.35e12 B/s",
        "cycles_per_step": filt16["cycles_per_step"],
        "sm_clock_mhz": filt16["sm_clock_mhz"],
        "share_of_bound": filt16_bound["bound_ms"] / filt16["kernel_ms"],
        "registers": int(regs.group(1)) if regs else None,
        "spill_bytes": max(map(int, spills)) if spills else None,
        "warps_per_sm": wide_shape["warps_per_sm"],
        "kernel_shape": wide_shape,
        "ptxas": wide_ptxas,
        "shapes_checked": ["x".join(map(str, s))
                           for s in FILTER_WIDE_CHECK_SHAPES],
    })
    print(f"[filter16] fused_filter_wide: {filt16['kernel_ms']:.4f} ms alone,"
          f" in the call {rows[-1]['ms_in_path']} ms, bound "
          f"{filt16_bound['bound_ms']:.4f} ms ({filt16_bound['bound_by']}; "
          f"float32 only {filt16_bound['bound_ms_fp32']:.4f}), "
          f"roofline share {100 * rows[-1]['share_of_bound']:.2f}%; plain "
          f"{filt16['plain_kernel_ms']:.1f} ms over {filt16['plain_steps']} "
          f"steps; {smi}")
    # the warp K3 (path A at d = 32); its other shapes and tiers are checked
    # in 17 (a)
    warp_ptxas = [line.strip() for line in kernels.ptxas_report(
        "fused_filter_warp").splitlines() if any(
        k in line for k in ("Compiling entry", "registers", "spill"))]
    tc_ptxas = tensor_tier_ptxas(warp_ptxas)
    tc_warps = 8 * ff._library("fused_filter_warp") \
        .rxt_warp_filter_tc_blocks_per_sm(FILTER32_D, ff.WARP_MAX_CHAINS)
    print(f"[filter32] tensor-core tier: {tc_warps} warps an SM; ptxas: "
          + " | ".join(tc_ptxas))
    rows.append({
        "name": "fused_filter_warp", "route": "cuda",
        "source": "rxinfer_tpu_torch/csrc/fused_filter_warp.cu",
        "replaces": "rxinfer_tpu/ops/pallas_filter.py:84",
        "launches": filt32["launches"]["fused_filter_warp"],
        "max_abs_err": max(worst["fused_filter_warp"], filt32["kernel_err"],
                           s14_tiers["max_abs_err"]),
        "max_abs_err_on_path": filt32["kernel_err"],
        "max_abs_err_vs_float64_in_device_tiers": s14_tiers["max_abs_err"],
        "max_abs_err_one_observation_vs_float64":
            s14_tiers["one_observation"],
        "one_observation_BT_d": [ONE_OBS_B, ONE_OBS_T, list(ONE_OBS_WARP_D)],
        "ms": filt32["kernel_ms"],
        "ms_in_path": filt32["profile"]["kernels"]["fused_filter_warp"][
            "ms_per_launch"],
        "plain_ms": filt32["plain_kernel_ms"],
        "plain_shape_BTddy": [FILTER_B, filt32["plain_steps"], FILTER32_D,
                              FILTER32_D],
        "bound_ms": filt32_bound["bound_ms"],
        "bound_by": filt32_bound["bound_by"],
        "bound_ms_fp32": filt32_bound["bound_ms_fp32"], "library_ms": None,
        "library_note": "no single PyTorch call computes a Kalman filter",
        "shape_BTddy": [FILTER_B, FILTER_T, FILTER32_D, FILTER32_D],
        "bytes": filt32_bound["bytes"], "ops": filt32_bound["ops"],
        "ops_tensor_cores": filt32_bound["ops_tensor_cores"],
        "bound_rates": "ops_tensor_cores at 3xTF32 (495e12 / 3 op/s), the "
                       "other ops at 67e12 op/s, bytes at 3.35e12 B/s",
        "cycles_per_step": filt32["cycles_per_step"],
        "sm_clock_mhz": filt32["sm_clock_mhz"],
        "share_of_bound": filt32_bound["bound_ms"] / filt32["kernel_ms"],
        "plan": ff.device_warp_plan(FILTER32_D, device),
        "tier_by_d": s14_tiers["by_d"],
        "warps_per_sm": tc_warps,
        "ptxas_tensor_core_tier": tc_ptxas,
        "plans_device_tiers": s14_tiers["plans"],
        "shapes_checked": ["x".join(map(str, s))
                           for s in FILTER_WARP_CHECK_SHAPES
                           + FILTER_TC64_CHECK_SHAPES]
        + ["x".join(map(str, s[:4])) for s in FILTER_WARP_TIER_SHAPES],
        "ptxas": warp_ptxas,
    })
    print(f"[filter32] fused_filter_warp: {filt32['kernel_ms']:.4f} ms alone,"
          f" in the call {rows[-1]['ms_in_path']} ms, bound "
          f"{filt32_bound['bound_ms']:.4f} ms ({filt32_bound['bound_by']}), "
          f"roofline share {100 * rows[-1]['share_of_bound']:.2f}%; plain "
          f"{filt32['plain_kernel_ms']:.1f} ms over {filt32['plain_steps']} "
          f"steps; {smi}")
    # phase 26: the warp K3's tier past 32 (path A at d = 64) and the wide
    # K4/K5 at 32 states (the marginal kernel past 16 states)
    bnd64 = filt64["bound"]
    rows.append({
        "name": "fused_filter_warp_d64", "route": "cuda",
        "source": "rxinfer_tpu_torch/csrc/fused_filter_warp.cu",
        "replaces": "rxinfer_tpu/ops/pallas_filter.py:84",
        "launch_key": "fused_filter_warp",
        "device_kernel": "warp_filter_tc64_kernel",
        "launches": filt64["launches"]["fused_filter_warp"],
        "max_abs_err": max(worst["fused_filter_warp"], filt64["kernel_err"]),
        "max_abs_err_on_path": filt64["kernel_err"],
        "max_abs_err_vs_float64_on_path": max(filt64["errs"].values()),
        "ms": filt64["kernel_ms"],
        "ms_beside_sweep_tier": filt64["kernel_ms_beside_sweep"],
        "ms_in_path": filt64["profile"]["kernels"]["fused_filter_warp"][
            "ms_per_launch"],
        "call_ms": filt64["call_ms"],
        "sweep_tier_ms": filt64["sweep_ms"],
        "speedup_over_sweep_tier": filt64["speedup_over_sweep"],
        "max_abs_diff_from_sweep_tier": filt64["tiers_diff"],
        "plain_ms": filt64["plain_kernel_ms"],
        "plain_shape_BTddy": [filt64["plain_chains"], filt64["plain_steps"],
                              FILTER64_D, FILTER64_D],
        "plain_device": filt64["plain_device"],
        "bound_ms": bnd64["bound_ms"], "bound_by": bnd64["bound_by"],
        "bound_ms_fp32": bnd64["bound_ms_fp32"], "library_ms": None,
        "library_note": "no single PyTorch call computes a Kalman filter",
        "shape_BTddy": [FILTER64_B, FILTER64_T, FILTER64_D, FILTER64_D],
        "bytes": bnd64["bytes"], "ops": bnd64["ops"],
        "ops_tensor_cores": bnd64["ops_tensor_cores"],
        "bound_rates": "ops_tensor_cores at 3xTF32 (495e12 / 3 op/s), the "
                       "other ops at 67e12 op/s, bytes at 3.35e12 B/s",
        "cycles_per_step": filt64["cycles_per_step"],
        "sm_clock_mhz": filt64["sm_clock_mhz"],
        "share_of_bound": bnd64["bound_ms"] / filt64["kernel_ms"],
        "registers": filt64["ptxas"]["registers"],
        "spill_bytes": filt64["ptxas"]["spill_bytes"],
        "ptxas": filt64["ptxas"]["lines"],
        "warps_per_sm": filt64["warps_per_sm"], "plan": filt64["plan"],
        "tier_by_d": s14_tiers["by_d"],
        "one_observation_BT_d": [ONE_OBS_B, ONE_OBS_T, list(ONE_OBS_WARP_D)],
        "max_abs_err_one_observation_vs_float64":
            s14_tiers["one_observation"],
        "max_abs_err_at_check_shapes": s27_worst["fused_filter_warp"],
        "shapes_checked": ["x".join(map(str, s))
                           for s in FILTER_TC64_CHECK_SHAPES],
    })
    print(f"[filter64] fused_filter_warp (warp_filter_tc64_kernel): "
          f"{filt64['kernel_ms']:.4f} ms alone, in the call "
          f"{rows[-1]['ms_in_path']} ms, call {filt64['call_ms']:.4f} ms; "
          f"bound {bnd64['bound_ms']:.4f} ms ({bnd64['bound_by']}), roofline"
          f" share {100 * rows[-1]['share_of_bound']:.2f}%; the sweep tier "
          f"{filt64['sweep_ms']:.3f} ms ({filt64['speedup_over_sweep']:.2f}x)"
          f"; plain {filt64['plain_kernel_ms']:.1f} ms over "
          f"{filt64['plain_steps']} step(s) of {filt64['plain_chains']} "
          f"chains on the host; {smi}")
    hmm32_shape = (HMM32_B, HMM32_T, HMM32_K)
    tile32 = hmm32["tile"]
    for name, replaces in (
            ("fused_fb_serial_wide", "rxinfer_tpu/ops/pallas_discrete.py:48"),
            ("fused_fb_marg_wide", "rxinfer_tpu/ops/pallas_discrete.py:87")):
        prof = hmm32["profile"]["kernels"][name]
        entry = ("fb_wide_serial_kernelILi32E" if "serial" in name
                 else "fb_wide_marg_rows_kernelILb1ELb1E")
        px = _ptxas_of("fused_fb_wide", entry)
        rows.append({
            "name": name + "_k32", "route": "cuda",
            "source": "rxinfer_tpu_torch/csrc/fused_fb_wide.cu",
            "replaces": replaces, "launch_key": name,
            "device_kernel": FB_ROWS_KERNEL_NAMES[name],
            "launches": hmm32["launches"][name],
            "max_abs_err": max(worst[name], hmm32["kernel_errs"][name]),
            "max_abs_err_on_path": hmm32["kernel_errs"][name],
            "ms": hmm32["alone_ms"][name],
            "ms_in_path": prof["ms_per_launch"],
            "ms_in_path_by_pass": prof.get("parts"),
            "program_ms": hmm32["program_ms"],
            "program_busy_ms": hmm32["profile"]["busy_ms"],
            "cycles_per_step": hmm32["cycles_per_step"][name],
            "sm_clock_mhz": hmm32["sm_clock_mhz"],
            "tile": {"marginal_steps": tile32,
                     "marginal_tiles": -(-HMM32_T // tile32),
                     "marginal_warps_per_sm": hmm32["marginal_warps_per_sm"]},
            "registers": px["registers"], "spill_bytes": px["spill_bytes"],
            "ptxas": px["lines"],
            "plain_ms": hmm32["plain_ms"][name],
            # the serial call's plain version runs on the host on the
            # sampled chains (check_fb_path_inputs' serial_rows)
            "plain_shape_BTK": [len(edge_rows(HMM32_B)), HMM32_T, HMM32_K]
            if "serial" in name else list(hmm32_shape),
            "plain_device": "host" if "serial" in name else "card",
            "bound_ms": hmm32_bounds[name]["bound_ms"],
            "bound_by": hmm32_bounds[name]["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes an HMM "
                            "forward-backward",
            "share_of_bound": hmm32_bounds[name]["bound_ms"]
            / hmm32["alone_ms"][name],
            "shape_BTK": list(hmm32_shape),
            "bytes": hmm32_bounds[name]["bytes"],
            "ops": hmm32_bounds[name]["ops"],
        })
        print(f"[hmm32] {name}: {hmm32['alone_ms'][name]:.4f} ms alone, in "
              f"the program {prof['ms_per_launch']} ms (passes "
              f"{prof.get('parts')}), bound "
              f"{hmm32_bounds[name]['bound_ms']:.4f} ms "
              f"({hmm32_bounds[name]['bound_by']}), share "
              f"{100 * rows[-1]['share_of_bound']:.2f}%; registers "
              f"{px['registers']}, spill bytes {px['spill_bytes']}; plain "
              f"{hmm32['plain_ms'][name]:.1f} ms at (B,T,K)="
              f"{tuple(rows[-1]['plain_shape_BTK'])} on the "
              f"{rows[-1]['plain_device']}; {smi}")
    print(f"[hmm32] program_ms {hmm32['program_ms']:.4f} updates_per_s "
          f"{hmm32['updates_per_s']:.6g} (B={HMM32_B}, T={HMM32_T}, "
          f"K={HMM32_K}, iterations={HMM32_IT}), device busy "
          f"{hmm32['profile']['busy_ms']} ms a call, of it the engine's "
          f"other device kernels {hmm32['rest_ms']} ms; peak "
          f"{hmm32['peak_bytes'] / 1e9:.3f} GB; {smi}")
    # phase 27: the warp K3's tier past 64 (path A at d = 128) and the wide
    # K4/K5 at 64 states (the marginal kernel past 32 states)
    bnd128 = filt128["bound"]
    rows.append({
        "name": "fused_filter_warp_d128", "route": "cuda",
        "source": "rxinfer_tpu_torch/csrc/fused_filter_tc128.cu",
        "replaces": "rxinfer_tpu/ops/pallas_filter.py:84",
        "launch_key": "fused_filter_warp",
        "device_kernel": "warp_filter_tc128_kernel",
        "launches": filt128["launches"]["fused_filter_warp"],
        "max_abs_err": max(worst["fused_filter_warp"], filt128["kernel_err"]),
        "max_abs_err_on_path": filt128["kernel_err"],
        "max_abs_err_vs_float64_on_path": max(filt128["errs"].values()),
        "ms": filt128["kernel_ms"],
        "ms_beside_sweep_tier": filt128["kernel_ms_beside_sweep"],
        "ms_in_path": filt128["profile"]["kernels"]["fused_filter_warp"][
            "ms_per_launch"],
        "call_ms": filt128["call_ms"],
        "call_busy_ms": filt128["profile"]["busy_ms"],
        "sweep_tier_ms": filt128["sweep_ms"],
        "sweep_tier_plan": filt128["sweep_plan"],
        "speedup_over_sweep_tier": filt128["speedup_over_sweep"],
        "max_abs_diff_from_sweep_tier": filt128["tiers_diff"],
        "plain_ms": filt128["plain_kernel_ms"],
        "plain_shape_BTddy": [filt128["plain_chains"], filt128["plain_steps"],
                              FILTER128_D, FILTER128_D],
        "plain_device": filt128["plain_device"],
        "bound_ms": bnd128["bound_ms"], "bound_by": bnd128["bound_by"],
        "bound_ms_fp32": bnd128["bound_ms_fp32"], "library_ms": None,
        "library_note": "no single PyTorch call computes a Kalman filter",
        "shape_BTddy": [FILTER128_B, FILTER128_T, FILTER128_D, FILTER128_D],
        "bytes": bnd128["bytes"], "ops": bnd128["ops"],
        "ops_tensor_cores": bnd128["ops_tensor_cores"],
        "bound_rates": "ops_tensor_cores at 3xTF32 (495e12 / 3 op/s), the "
                       "other ops at 67e12 op/s, bytes at 3.35e12 B/s",
        "cycles_per_step": filt128["cycles_per_step"],
        "sm_clock_mhz": filt128["sm_clock_mhz"],
        "share_of_bound": bnd128["bound_ms"] / filt128["kernel_ms"],
        "registers": filt128["ptxas"]["registers"],
        "spill_bytes": filt128["ptxas"]["spill_bytes"],
        "ptxas": filt128["ptxas"]["lines"],
        "warps_per_sm": filt128["warps_per_sm"], "plan": filt128["plan"],
        "tier_by_d": s14_tiers["by_d"],
        "one_observation_BT_d": [ONE_OBS_B, ONE_OBS_T, list(ONE_OBS_WARP_D)],
        "max_abs_err_one_observation_vs_float64":
            s14_tiers["one_observation"],
        "shapes_checked": ["x".join(map(str, s[:4]))
                           for s in FILTER_TC64_CHECK_SHAPES
                           + FILTER_WARP_TIER_SHAPES if 64 < s[2] <= 128],
    })
    print(f"[filter128] fused_filter_warp (warp_filter_tc128_kernel): "
          f"{filt128['kernel_ms']:.4f} ms alone, in the call "
          f"{rows[-1]['ms_in_path']} ms, call {filt128['call_ms']:.4f} ms; "
          f"bound {bnd128['bound_ms']:.4f} ms ({bnd128['bound_by']}), "
          f"roofline share {100 * rows[-1]['share_of_bound']:.2f}%; the sweep"
          f" tier {filt128['sweep_ms']:.3f} ms "
          f"({filt128['speedup_over_sweep']:.2f}x); plain "
          f"{filt128['plain_kernel_ms']:.1f} ms over "
          f"{filt128['plain_steps']} step(s) of {filt128['plain_chains']} "
          f"chains on the host; {smi}")
    hmm64_shape = (HMM64_B, HMM64_T, HMM64_K)
    tile64 = hmm64["tile"]
    for name, replaces in (
            ("fused_fb_serial_wide", "rxinfer_tpu/ops/pallas_discrete.py:48"),
            ("fused_fb_marg_wide", "rxinfer_tpu/ops/pallas_discrete.py:87")):
        prof = hmm64["profile"]["kernels"][name]
        entry = ("fb_wide_serial_kernelILi0E" if "serial" in name
                 else "fb_wide_marg_rows2_kernelILb1ELb1E")
        px = _ptxas_of("fused_fb_wide", entry)
        bnd = hmm64_bounds[name]
        rows.append({
            "name": name + "_k64", "route": "cuda",
            "source": "rxinfer_tpu_torch/csrc/fused_fb_wide.cu",
            "replaces": replaces, "launch_key": name,
            "device_kernel": FB_ROWS2_KERNEL_NAMES[name],
            "launches": hmm64["launches"][name],
            "max_abs_err": max(worst[name], hmm64["kernel_errs"][name]),
            "max_abs_err_on_path": hmm64["kernel_errs"][name],
            "ms": hmm64["alone_ms"][name],
            "ms_in_path": prof["ms_per_launch"],
            "ms_in_path_by_pass": prof.get("parts"),
            "program_ms": hmm64["program_ms"],
            "program_busy_ms": hmm64["profile"]["busy_ms"],
            "cycles_per_step": hmm64["cycles_per_step"][name],
            "sm_clock_mhz": hmm64["sm_clock_mhz"],
            "tile": {"marginal_steps": tile64,
                     "marginal_tiles": -(-HMM64_T // tile64),
                     "marginal_warps_per_sm": hmm64["marginal_warps_per_sm"]},
            "registers": px["registers"], "spill_bytes": px["spill_bytes"],
            "ptxas": px["lines"],
            "plain_ms": hmm64["plain_ms"][name],
            "plain_shape_BTK": [len(edge_rows(HMM64_B)), HMM64_T, HMM64_K]
            if "serial" in name else list(hmm64_shape),
            "plain_device": "host" if "serial" in name else "card",
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes an HMM "
                            "forward-backward",
            "share_of_bound": bnd["bound_ms"] / hmm64["alone_ms"][name],
            "shape_BTK": list(hmm64_shape),
            "bytes": bnd["bytes"], "ops": bnd["ops"],
        })
        if "marg" in name:
            rows[-1].update({
                "first_written_kernel": "fb_wide_marg_kernel",
                "first_written_ms": hmm64["first_written_marg_ms"],
                "ms_beside_first_written": hmm64[
                    "marg_ms_beside_first_written"],
                "speedup_over_first_written": hmm64["first_written_marg_ms"]
                / min(hmm64["marg_ms_beside_first_written"]),
                "first_written_share_of_bound": bnd["bound_ms"]
                / hmm64["first_written_marg_ms"]})
        print(f"[hmm64] {name}: {hmm64['alone_ms'][name]:.4f} ms alone, in "
              f"the program {prof['ms_per_launch']} ms (passes "
              f"{prof.get('parts')}), bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}), share "
              f"{100 * rows[-1]['share_of_bound']:.2f}%; registers "
              f"{px['registers']}, spill bytes {px['spill_bytes']}; plain "
              f"{hmm64['plain_ms'][name]:.1f} ms at (B,T,K)="
              f"{tuple(rows[-1]['plain_shape_BTK'])} on the "
              f"{rows[-1]['plain_device']}"
              + (f"; fb_wide_marg_kernel {hmm64['first_written_marg_ms']:.4f}"
                 f" ms ({rows[-1]['speedup_over_first_written']:.2f}x)"
                 if "marg" in name else "") + f"; {smi}")
    print(f"[hmm64] program_ms {hmm64['program_ms']:.4f} updates_per_s "
          f"{hmm64['updates_per_s']:.6g} (B={HMM64_B}, T={HMM64_T}, "
          f"K={HMM64_K}, iterations={HMM64_IT}), device busy "
          f"{hmm64['profile']['busy_ms']} ms a call, of it the engine's "
          f"other device kernels {hmm64['rest_ms']} ms; peak "
          f"{hmm64['peak_bytes'] / 1e9:.3f} GB; {smi}")
    print(f"[filter32] call_ms {filt32['call_ms']:.4f} chain_updates_per_s "
          f"{filt32['updates_per_s']:.6g} (B={FILTER_B}, T={FILTER_T}, "
          f"d=dy={FILTER32_D}); {smi}")
    print(f"[hmm16] program_ms {hmm16['program_ms']:.4f} updates_per_s "
          f"{hmm16['updates_per_s']:.6g} (B={HMM16_B}, T={HMM16_T}, "
          f"K={HMM16_K}, iterations={HMM16_IT}), peak "
          f"{hmm16['peak_bytes'] / 1e9:.3f} GB; {smi}")
    print(f"[filter16] call_ms {filt16['call_ms']:.4f} chain_updates_per_s "
          f"{filt16['updates_per_s']:.6g} (B={FILTER_B}, T={FILTER_T}, "
          f"d=dy={FILTER16_D}); {smi}")

    for row in rows:
        row["launches_fe_paths"] = fe_launches.get(row["name"], {})
        row["launches_shared_paths"] = {
            path: counts.get(row["name"], 0)
            for path, counts in shared_launches.items()}
        row["launches_gmm_stream_paths"] = {
            "gmm": gmm["launches"].get(row["name"], 0),
            "stream_fused": stream["launches_a"].get(row["name"], 0),
            "stream_generic": stream["launches_b"].get(row["name"], 0)}
        row["launches_phase22"] = {
            cell: res["launches"].get(row["name"], 0)
            for cell, res in a6d.items()}
        row["launches_phase23"] = {
            cell: res["launches"].get(row["name"], 0)
            for cell, res in a6e.items()}
        row["launches_phase24"] = {
            cell: res["launches"].get(row["name"], 0)
            for cell, res in s24.items()}
        row["launches_phase25"] = {
            cell: res["launches"].get(row["name"], 0)
            for cell, res in s25.items()}
        key = row.get("launch_key", row["name"])
        row["launches_phase26"] = {
            "filter64": filt64["launches"].get(key, 0),
            "hmm32": hmm32["launches"].get(key, 0)}
        row["launches_phase27"] = {
            "filter128": filt128["launches"].get(key, 0),
            "hmm64": hmm64["launches"].get(key, 0)}
    print(f"[gmm] program_ms {gmm['program_ms']:.4f} updates_per_s "
          f"{gmm['updates_per_s']:.6g} with FE {gmm['fe_program_ms']:.4f} "
          f"({gmm['fe_updates_per_s']:.6g}) (B={GMM_B}, N={GMM_N}, "
          f"iterations={GMM_IT})")
    print(f"[stream] fused_plan_ms {stream['ms_a']:.4f} updates_per_s "
          f"{stream['updates_per_s_a']:.6g} generic_ms {stream['ms_b']:.4f} "
          f"updates_per_s {stream['updates_per_s_b']:.6g} on_next_ms "
          f"{stream['on_next_ms']:.3f} (B={STREAM_B}, T={STREAM_T}, "
          f"d={STREAM_D}); path A's K3 call {filt['call_ms']:.4f}")
    print(f"[fe] (a) lgssm program_ms with FE {fe_a['fe_program_ms']:.4f} "
          f"without {fe_a['program_ms']:.4f} fe_stage_ms "
          f"{fe_a['fe_stage_ms']:.4f} peak_gb {fe_a['peak_bytes'] / 1e9:.3f}"
          f" (without FE {fe_a['peak_bytes_without_fe'] / 1e9:.3f}) rel_err "
          f"{fe_a['rel_err']:.3g}; (b) hmm with {fe_b['fe_program_ms']:.4f} "
          f"without {fe_b['program_ms']:.4f} rel_err {fe_b['rel_err']:.3g}; "
          f"(c) lgssm_wtau with {fe_c['fe_program_ms']:.4f} without "
          f"{fe_c['program_ms']:.4f} rel_err {fe_c['rel_err']:.3g}; (d) "
          + ", ".join(f"{k} with {fe_d['fe_program_ms'][k]:.4f} without "
                      f"{fe_d['program_ms'][k]:.4f} rel_err "
                      f"{fe_d['rel_err'][k]:.3g}" for k in fe_d["rel_err"])
          + f"; (e) beta_bernoulli with {fe_e['bb_fe_program_ms']:.4f} "
          f"without {fe_e['bb_program_ms']:.4f} row0 {fe_e['bb_row0']!r}, "
          f"gaussian with {fe_e['gauss_fe_program_ms']:.4f} without "
          f"{fe_e['gauss_program_ms']:.4f} rel_err "
          f"{fe_e['gauss_rel_err']:.3g}")
    print(f"[shared] (a) program_ms {shared['program_ms']:.4f} "
          f"updates_per_s {shared['updates_per_s']:.6g} (B={WTAU_B}, "
          f"T={WTAU_T}, d={WTAU_D}, iterations={WTAU_IT}; unpooled "
          f"{wtau['program_ms']:.4f}); (b) chunked_ms "
          f"{shared['chunked_ms']:.4f} ({SHARED_CHUNKS} chunks); (c) hier_ms "
          f"{hier['ms']:.4f} (B,T={HIER_SHAPE}, d={HIER_D}, "
          f"iterations={HIER_IT}); {smi}")
    print(f"[mixture] (d) ms {mixture['ms']:.1f} (B={MIX_B}, N={MIX_N}, "
          f"iterations={MIX_IT}) errs {mixture['errs']}; {smi}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
