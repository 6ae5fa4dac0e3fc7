#!/usr/bin/env python3
"""Drive tpunmf_torch's main paths once on one CUDA card, through its kernels.

    python3 chip_smoke.py       # one card; about fifteen minutes of command time on an H100

Phases (any failure exits non-zero; nothing is caught and carried on):
  1. the card's name and power limit; build the CUDA kernels of
     tpunmf_torch/ops/csrc with nvcc (sm_90a), in a thread while the host
     makes the data, and the native panelizer of tpunmf_torch/native with
     g++ (both must build), and print the build times.
  2. each kernel against its plain PyTorch version on the card, at the
     paths' shapes and ragged ones: the error against a stated tolerance,
     both times (CUDA events, in the order plain, kernel, kernel, plain)
     and the kernel's bound (the larger of its flops over the card's peak
     rate and its bytes over the memory rate).  At EU 8192x8192 r128 (f32
     and bf16 X) and KL 8192x4096 r128 the single-pass iteration is also
     timed against the 2-pass pair, in turns.  The ratio and objective
     passes also run at MUR's high rank, 8192x4096 / 8192x8192 r1536,
     and kl_ratio at ragged 1000x777 k37 and k1100 and at KL config[1];
     mur_h_update, mur_w_update and the lagged W pass also at KL
     8192x4096 r128; the lagged W must be the plain KL W bit for bit, and
     masked_w_update must give its pinned bits (masked_w_bits, with its
     sums rounded every step).  mur_iteration_kl also at
     KL 8192x4096 r128 on bf16 X and at 8192x1024 k 256-1024 (across the
     KL rank lines), where up to KL_ITER_PAIR_RANK its W', objective and
     wtr must be the lagged W pass's and the KL H pass's numerator bit for
     bit, above it within UPDATE_RTOL (kl_bits_phase, with ragged k37).
     The two single passes behind the port's switches: hals_iteration_eu
     at 8192x8192 r128 (f32 at 2 and 1 sweeps, bf16) and ragged 1000x777
     k40, and mur_iteration_eu_dma at 8192x8192 r128 (f32, bf16) and
     ragged k37 (TMA and wgmma; the ragged X's rows are off 16 bytes, so
     its tiles take the kernel's own load path, which the line names): at
     lam_w=0 it is held to v1_iter bit for bit, and to mur_iteration_eu
     (mma.sync) within ROUTE_RTOL, timed against it in turns, with its
     device time and TFLOP/s.  The sweep scripts' kernels: v1_iter and
     v2_iter at 8192x8192 r128 (bf16 and f32 X) and ragged k37 (the dma
     variant's stages), v1 held to mur_iteration_eu(lam_w=0) within
     ROUTE_RTOL and timed against it in turns, with device times;
     iter_eu_int8 at 8192x8192 r128 (X + 0.05 quantised) and ragged k37
     (the same stages on int8 X, widened to bf16 in registers), with its
     device time, TFLOP/s and the load path of X's tiles, held at scale 1 to
     v1_iter on xq.to(bfloat16) bit for bit; the read probe at 8192x8192
     f32 and a ragged 896x777, with its rate.  score_blockmax_relayout (TMA
     and wgmma) at the serving shapes and ragged ones (H's rows off 16 bytes,
     f32 and bf16), with its device time, TB/s or TFLOP/s and the load path
     of H's tiles; its maxima must be torch.amax of its s3 bit for bit.
     blockmax_relayout at (64, 2^20) and the read probe at 8192x8192 are
     also timed in turns with the one PyTorch call that computes their
     function (torch.amax of the scores' view, torch.sum over rows), with
     the bytes per second each reaches.  The tensor-core kernels
     (mur_iteration_eu, mur_iteration_kl, hals_iteration_eu, mur_w_update,
     the lagged W pass and mur_h_update at their shapes above, both masked
     passes at MovieLens-1M and -10M; kl_ratio_and_obj and kl_ratio at config[3], config[1] and r1536;
     eu_residual_obj at 8192x8192 r128, r1536 and config[3]; kl_obj at
     config[1], 8192x4096 r128 and r1536)
     also print their profiler device time and the TFLOP/s of f32 products
     (TB/s where bytes bind) alone, on the device and at the bound; both
     masked passes also run on bf16 X at MovieLens-10M and must give the
     same bits on a second call, and kl_ratio's ratio and kl_obj's
     objective must be kl_ratio_and_obj's bit for bit at every KL shape.
  3. the paths through tpunmf_torch.NMF(...).factorize, exactly 50
     iterations each (masked MUR and ADMM SLOW_RUN_ITERS, ANLS and AO-ADMM
     fewer, below), the kernel route
     against the plain route on the card; each profile a factorize() of
     PROFILE_ITERS iterations:
     - MUR: EU at 8192x8192 r128 (lowrank_dense) with bf16 and f32 X, which
       tpunmf's route rule sends to the single pass, and the same runs on
       the 2-pass pair for comparison; EU f32 at 8192x16384 r128, which the
       rule sends to the 2-pass pair; KL at its defaults (random init,
       exact objective) on BASELINE config[1], 20000x11000 r50 (tfidf_like,
       seed 1), 2-pass; KL at 8192x4096 r128 (tfidf_like, seed 4), single
       pass, exact and objective="lagged"; after the paths, the EU and KL
       single-pass shapes, config[1] and the high-rank step profiled on
       both routes;
     - MUR's high-rank step (1024 < k <= 2048: plain products, the
       ratio and objective kernels): KL at 8192x4096 and EU at 8192x8192,
       both r1536; KL must launch kl_ratio 50 times and kl_ratio_and_obj
       51, EU eu_residual_obj 51, and neither an update kernel;
     - NMF given float64 numpy arrays (they run on the card as float32,
       through their routes' kernels): MUR EU and KL at 8192x8192 r128,
       and mask=, HALS, ADMM and AO-ADMM at 1000x777 r37; and a CUDA float64 tensor
       (the plain route: no kernel launched);
     - HALS (method="hals"): EU 8192x8192 r128 f32, inner_sweeps=2, from
       one NNDSVD 'zero' init given to both routes;
     - masked MUR (mask=): EU and KL at MovieLens-10M's dimensions, 69878
       users x 10677 items, 1.34% observed, r64 (movielens_like's recipe,
       made on the card; profiled on both routes after the paths);
     - MUR KL with objective="lagged" at config[1] and at 8192x4096, each
       against its exact run;
     - serving (tpunmf_torch.serve.topk): 20 batches of 64 users against
       n = 2^20 items at r128, k = 100, exact, quantized (bf16 first stage
       from a stored bf16 H) and exact with 1% of the items excluded, and
       20 batches at r512, n = 2^19, exact; kernel route against the plain
       route (the same code with the kernels' plain versions), each
       answer held against a stable sort of its own scores, and after
       the path, each mode's device and wall ms per request from a profile
       of 10 requests on each route;
     - ANLS (method="anls") at BASELINE config[2]'s stand-in, 6040x3706
       (movielens_like, density 0.2, seed 2) at r64 from one NNDSVD 'zero'
       init, 3 iterations each on both routes: EU with use_fcnnls and
       'chol', EU 'cg', EU 'bpp', KL 'chol', each with its it/s over
       factorize(), ms an iteration, NNLS trips per half-step and final
       objective; the kernel route launches its objective kernel
       (eu_residual_obj, or kl_obj and no kl_ratio_and_obj) once an
       iteration and nothing else, the plain route nothing; W and H the
       same bits on both routes, traces within 1e-4, the EU 'chol' trace
       non-increasing within 1e-6; NMF.transform with the trained EU W fits
       X at least as well as the fit (within 1e-5), KL transform of 256
       columns is finite and >= 0, inverse_transform gives X's shape, and
       no transform launches a kernel; then EU 'chol' at 8192x8192 r128,
       10 iterations on the kernel route; after the path, EU 'chol' at
       config[2] profiled on both routes, with the host and device ms
       inside the NNLS calls;
     - ADMM (method="admm") at BASELINE config[3], 50000x20000 r128
       (sparse_csr(density=0.02, seed=3) densified), EU with rho fixed and
       adaptive, and KL (EU and KL profiled on both routes after the path);
     - AO-ADMM (method="ao_admm"), after the ADMM path freed config[3]: KL
       at one card's cut of BASELINE config[4], 50000x20000 r256
       (lowrank_dense's recipe, seed 4, formed on the card; L1 on W, l2n
       on H, admm_iter 10), 2 iterations; at the bench's 8192x8192 r128,
       the defaults and the local-sparsity variant (rho_mode adaptive,
       l1inf on W, an l1 budget of 256), 20 iterations, and 'cg' on the
       kernel route, 2; each from its X's NNDSVD 'zero' init on both
       routes (one warm-up iteration a route first), with its it/s over
       factorize(), ms an outer iteration, inner trips per H and per W
       subproblem, final objective and peak memory; the kernel route
       launches eu_residual_obj or kl_obj (never kl_ratio_and_obj) once an
       iteration and nothing else, the plain route nothing; W and H the
       same bits, the same inner trips and traces within 1e-4 on both
       routes, and each route's final objective within 1e-4 of the final
       iterate's in float64; KL config[4] (3 iterations) and EU 8192x8192
       profiled on both routes after the path;
     - the switched single passes (tpunmf_torch/solvers/cuda_defaults.py,
       off by default as in tpunmf, flipped by switched()): HALS at
       8192x8192 r128 f32 with hals_single_pass on, and MUR EU at the same
       X, f32 and bf16, with mur_single_pass_variant "dma", each from its
       default run's init and held to that run's trace, with profiles.
     - the sweep scripts' paths (tpunmf_torch/sweeps), at their 8192x8192
       r128 from their own recipes, 30 iterations each: the v1 and v2
       loops on bf16 X from one init (exactly 30 v1_iter, 30 v2_iter, no
       other kernel; their results agree within the bf16 route tolerance),
       the tensor-core probe, and the int8 loop against the f32 single-pass
       loop (exactly 30 iter_eu_int8 and 30 mur_iteration_eu) with the
       objective's relative deviation; and the read rate of the 8192x8192
       f32 X by the read probe (exactly 360 launches).
     Each path's launch counters are set to 0 just before it and read just
     after; each run must launch its route's kernels and none of the other
     route's, and give finite factors and trace (non-increasing for MUR and
     HALS EU; ADMM's is not monotone).  The paths with the switches at their
     defaults must launch neither switched kernel, and no NMF.factorize
     path may launch a sweep script's kernel or the read probe.
  4. a save_factorization / load_factorization round trip of a MUR and of
     an AO-ADMM model.
  5. the tooling, each path's launches counted as in phase 3, every time
     printed beside the card's name and power limit:
     - checkpoint/resume at 8192x8192 r128 from NNDSVD 'zero': MUR EU on
       its default route (60 iterations, a save every 20) and ADMM EU with
       adaptive rho (30, every 10), each stopped after two blocks by an
       on_block_end that raises, then resumed: W, H, i and the trace must
       be the uninterrupted run's bit for bit; each save's ms and bytes;
     - experiments.mur_lambda_grid: EU at 8192x8192 r128, lambda_w x
       lambda_h = {0, 0.1, 1}^2, 50 iterations, and KL at 8192x4096 r128,
       {0, 0.1}^2, 20 iterations, each combination's trace within 1e-4 of
       a sequential kernel-route mur run from the same init; combination-
       iterations a second for both;
     - experiments.rank_scan on a planted 8192x4096 X (16 components), ks
       8, 16, 24, 8 seeds, 100 iterations: dispersions in [0, 1], finite
       objectives, seconds a rank;
     - mur_beta at 8192x8192 r128 from NNDSVD 'zero' (nudged as mur_beta
       nudges it), 50 iterations: beta 0 and 0.5 finite and decreasing,
       beta 1 and 2 within 1e-4 of mur KL and EU on the plain route and on
       the kernel route; it/s;
     - the sklearn estimator at config[2]'s stand-in (6040x3706 r64):
       'cd' and 'mu' with KL from 'nndsvd', 50 iterations, transform of
       512 new rows finite and >= 0;
     - python -m tpunmf_torch in subprocesses on the 8192x8192 X (.npy):
       factorize with --checkpoint (iterations 49, its save file), the
       same command again (it resumes at the end: the same line), and a
       grid of 4 rows beside them;
     - utils: MetricsLogger over 100 MUR EU iterations in blocks of 25 (4
       records, its mean it/s beside the wall rate), trace() around 5
       iterations (names the route's kernels), determinism_check of 10
       iterations of MUR EU and of HALS on the kernel routes.
  6. every kernel route that updates the iterate against float64 (faults
     3.5 and 3.7, route_f64_phase; ``python3 tools/route_drift.py`` alone),
     every time beside the card's name and power limit: 50 iterations from
     one init on the plain route in float64 (X and the init upcast), the
     plain route in f32 and the kernel route in f32, each f32 trace's
     largest relative distance from float64 and both routes' it/s; the
     kernel route within 1e-5 of float64 at every iteration (twice the
     plain f32 route's distance where that exceeds 5e-6), launching its
     route's kernels, the plain routes none: MUR KL at 8192x8192 r128 (its
     NNDSVD 'zero'), 8192x4096 r128 and BASELINE config[1] (random_init
     seed 0); MUR EU at 8192x8192 r128 from its NNDSVD 'zero' on the
     single pass, the 2-pass pair and the "dma" single pass; HALS there
     (inner_sweeps=2, the init nudged to 1e-16) on gs_sweep and on its
     single pass; masked MUR EU and KL at MovieLens-10M's dimensions r64
     and on the KL 8192x4096 r128 X with a seeded 25% mask, from
     random_init seed 0.  The "dma" and HALS single passes, off by
     default, are printed and not gated.  Then the solver families, 10
     iterations a run, kernel route against plain route from one init,
     with it/s over factorize(), ms an iteration, final objective and
     launches:
     - semi_nmf on the 8192x8192 X minus its column means (mixed sign)
       from one seeded |N(0, 1)| H; onmf from X's NNDSVD 'zero' (nudged to
       1e-6): eu_residual_obj once an iteration and once for the initial
       objective, nothing else; the plain route nothing; W and H the same
       bits on both routes, traces within OBJECTIVE_RTOL; semi_nmf's trace
       non-increasing within EU_MONOTONE_RTOL;
     - robust_nmf on X with 50 |N(0, 1)| added to 1% of its columns
       (tests/test_robust.py's recipe), from the same nudged init: no
       kernel (one route, run twice: the same bits), its l2,1 trace
       non-increasing within EU_MONOTONE_RTOL;
     - the multilevel warm start (levels 2, factor 4, 10 coarse
       iterations) over HALS (inner_sweeps=2) and MUR EU at 8192x16384
       r128: its route's kernels and none of the other's, the plain route
       nothing, the traces within ROUTE_RTOL over ROUTE_ITERS iterations,
       and below a cold start's of the same fine budget;
     each final objective within OBJECTIVE_RTOL of the final (W, H)'s in
     float64.
  7. N-way CP and the remaining families, every number beside the card's
     name and power limit, each path through drive() with its launches
     counted as in phase 3 (exact where the code fixes them), each
     kernel-route run held to a plain-route run from the same init:
     - ntf at tpunmf's own production shape, 512x512x512 r64 f32
       (benchmarks/rate_probe.py:146-152: X the CP model of three seeded
       U[0, 1) + 0.01 factors, plus 0.05 U[0, 1) noise), from one
       factors_init: MUR EU and CP-HALS 50 iterations, KL MUR and masked
       EU MUR (a seeded 50% mask) 20; each route's it/s over factorize(),
       ms an iteration, peak memory above the resting allocation, final
       objective and the final factors' objective in float64 (from X -
       cp_reconstruct, slices at a time); CP-HALS launches exactly 3
       gs_sweep an iteration on the kernel route, every other run nothing;
       MUR's routes give the same bits; the routes' float64 objectives
       within OBJECTIVE_RTOL; MUR EU's trace rises by no more than
       EU_MONOTONE_RTOL x ||X||^2 / 2 (where its float32 Gram form
       rounds); the Gram form's gap from float64 is printed, not gated;
     - the same at 64^4 r16 (MUR EU and CP-HALS, 20 iterations);
     - ntf_rank_scan on a planted 256^3 rank-16 X, ks 8, 16, 24, hals, 50
       iterations: seconds a rank, relative errors and core consistencies;
     - python -m tpunmf_torch factorize stack.npy -k 16 -m ntf --ntf-update
       hals on a 256x256x64 stack (a subprocess): its save file loads
       through NMF.load_factorization with the same factors, i and final
       objective as the same fit in this process;
     - convex_nmf on the 8192x8192 X minus its column means, r128 (no
       kernel: run twice, the same bits); knn_graph of X's columns (5
       neighbours, heat), timed; gnmf with it, lambda_g 1, and nmtf (k_row =
       k_col = 32, its own k-means init, the peak memory printed), each
       launching eu_residual_obj iters + 1 times a run and the same W, H
       bits on both routes; symnmf of the graph (no kernel, run twice); 10
       iterations each, the final objective against float64 (printed, not
       gated, for the Gram forms of convex_nmf and symnmf);
     - OnlineNMF over the 8192x8192 X in 8 minibatches of 1024 columns, two
       passes, r128, sweeps=2: exactly 16 gs_sweep on the kernel route and
       none on the plain route (after one warm-up minibatch a route), the
       final W within 1e-4 of the plain route's, minibatches a second, and
       the EU fit of a transform of X.
  8. out of core (tpunmf_torch.solvers.mur_streaming, PanelStream and the
     native panelizer, the pinned ring of data/pipeline.py), every number
     beside the card's name and power limit, each run through drive():
     (a) the panelizer must build from tpunmf_torch/native/panelize.cpp;
     the densify rate of 8192x8192 tiles alone into a pinned buffer (f32
     and bf16) and the pinned host-to-device copy rate, in GB/s; (b) 2
     iterations from one init inside HBM: EU at BASELINE config[3] streamed
     with f32 transfer against in-core mur (1e-4) and with bf16 transfer
     against in-core mur on the bf16-rounded X (5e-3), no kernel launched;
     KL at config[1] streamed on its kernel route (exactly two kl_ratio a
     nonempty tile an iteration and one kl_obj a nonempty tile an
     objective) against its plain route (no kernel) and in-core mur
     (1e-4); (c) MUR EU with bf16 transfer at BASELINE config[4]'s data
     scale, sparse_csr(1_000_000, 100_000, density=1e-3, seed=0) (dense
     400 GB f32, 200 GB bf16), r256, 1 iteration (3 passes) from the
     seeded random init in 8192x8192 tiles: seconds a pass and an iteration, GB an
     iteration, the pipeline's GB/s beside the copy and densify rates, the
     peak device memory (below 10 GB), the objective (it must not rise),
     and one more pass under torch.profiler for the device's idle share;
     (d) topk_streaming of 64 users, k 100, from a host H of 2^24 items
     r128 (8.6 GB f32) in panels of 2^20: topk_retrieval's answers on the
     whole H, ms a request and the panels' GB/s.
  9. MUR across GPUs (tpunmf_torch.parallel) as a world of one: the card's
     machine has one H100, and NCCL puts no two ranks of a communicator on
     one device, so the sharded paths run as one rank, through the code
     and kernels an N-rank world runs.  Every number beside the card's name
     and power limit, each run through drive() with its launches counted:
     an NCCL process group through a file store in a temporary directory
     (ms to init it, to build the meshes (1,) 'cols' and (1, 1) 'rows' x
     'cols', and for the first all_reduce); on both meshes the facade's
     mesh= (parallel.mur_mesh) and schedule="ulysses" and "rank"
     (parallel.mur_sharded), 50 iterations from one random init at EU
     8192x8192 r128 f32 and at KL config[1] (20000x11000 r50), each on its
     kernel route and its plain route: exact launches (mesh= and Ulysses:
     mur_w_update and mur_h_update once an iteration, the objective kernel
     once an iteration and once more; rank: none) and exact collective
     calls by kind (parallel.calls), the first ROUTE_ITERS iterations of
     the kernel route within ROUTE_RTOL of the plain route and of one-device
     NMF(...).factorize("mur"), ms an iteration beside the one-device
     run's; solvers.mur_streaming_sharded on the (1,) mesh: EU at BASELINE
     config[3], 5 iterations from one init, f32 and bf16 transfer, against
     mur_streaming (1e-4); KL at config[1] on its kernel route (exactly two
     kl_ratio a row block an iteration, one kl_obj a row block an
     objective) against its plain route (1e-4), and objective="lagged"
     (kl_ratio_and_obj and kl_ratio once a row block an iteration) against
     the exact trace; MUR EU with bf16 transfer at phase 8's config[4]-scale
     matrix, r256, one iteration in 8192-row panels: seconds a pass, GB/s,
     peak memory above the resting allocation (below 20 GB), the objective
     must not rise; topk_retrieval over the (1,) mesh at (64, 2^20) r128, k
     100, exact, quantized (stored bf16 H) and 1% excluded: the one-device
     answers, ms a request beside the one-device path's.
 10. the reference solvers across GPUs (tpunmf_torch.parallel's
     mesh_solvers, ntf_sharded and the lambda grid's mesh=) as a world of
     one, on a new NCCL group through a file store and the meshes (1,)
     'cols' and (1, 1) 'rows' x 'cols': first the host microseconds of a
     one-element all_reduce (alone, and with a host read after each);
     then each path of MM_RUNS through NMF(x, k, mesh=).factorize, at the
     widths of phase 3: HALS EU 8192x8192 r128 (20 iterations), AO-ADMM EU
     8192x8192 r128 (10), ANLS EU 'chol', EU 'bpp' and KL 'chol' at
     config[2]'s stand-in, 6040x3706 r64 (5), ADMM EU with l1 on H (5)
     and KL (3) at config[3], 50000x20000 r128, AO-ADMM KL at config[4]'s
     cut, 50000x20000 r256 (2), masked MUR EU and KL at MovieLens-10M's
     dimensions r64 with a uint8 mask (10), each from its X's NNDSVD 'zero'
     (masked: a seeded |N(0, 1)|); ntf_sharded EU mur, EU hals and KL mur
     at 512x512x512 r64 (20) from one factors_init against the one-device
     ntf(normalize=False); mur_lambda_grid over the mesh's last axis at
     phase 5's grids against the unsharded grid.  Each path: the
     one-device run on its kernel route, then on each mesh its kernel
     route and its plain route (use_pallas=False), each through drive()
     with exact launches (mm_launches) and exact collective calls by kind
     (mesh_method_calls, ntf_sharded_calls, grid_calls: the formulas the
     CPU tests hold on 4 gloo ranks); every mesh run stops where the
     one-device run does and stays within MM_MESH_RTOL of its trace at
     every iteration (whether the bits are equal is printed), the kernel
     route within ROUTE_RTOL of the plain over ROUTE_ITERS iterations; ms
     an iteration of each beside one device's.
 11. every other method and keyword across GPUs as a world of one
     (mesh_rest_phase; ``python3 tools/multi_gpu.py --phase 11`` alone), on
     a new NCCL group and the meshes of phase 10, through mm_path as there:
     semi_nmf (on X less its column means), onmf (orthogonal 'h' and 'w')
     and robust at 8192x8192 r128 (20 iterations); beta= 0.5 and 0 there
     (20); MUR EU objective="gram", KL objective="lagged" and KL
     objective_every=8 there (24) and KL "lagged" at config[1] (20), the
     one-device MUR on the 2-pass pair (two_pass_route), which the mesh's
     local halves take, and 'lagged' held against the plain route's
     'exact' a step later; multilevel= with mur (EU) and hals there,
     levels 2, factor 4, 10 iterations a coarse level (20 at the finest);
     ntf EU mur, EU hals and KL (normalize=True) and masked EU at
     512x512x512 r64 (10); every path with exact launches (mr_launches)
     and exact collective calls (mesh_method_calls, multilevel_calls,
     ntf_mesh_calls).  Then checkpoints: HALS EU 8192x8192 r128 on (1, 1)
     in blocks of 10, stopped after two blocks and resumed, through .npz
     and through DCP, each the uninterrupted run's bits, the .npz resumed
     in one-device hals with its bits, and the seconds a save costs.
 12. the CLI's bench (bench_phase): ``python -m tpunmf_torch bench
     --deltas admm=1000,ao_admm=100,ao_admm_local_l1inf=50`` through
     tpunmf_torch.__main__.main in-process at its own full sizes
     (tpunmf_torch.bench: the probes, MUR EU 8192x8192 r128 on bf16 and
     f32 X, rank 512 at 8192x2048, MUR KL at cadence 1 and 8, serving at
     (64, 2^20) r128 and (64, 2^19) r512, eight solver families' rates,
     ADMM and the two AO-ADMM families on 1000, 100 and 50 extra
     iterations where bench.py takes 3000, 2000 and 1000: BENCH_DELTAS),
     the deltas and its line printed;
     it must return 0 with no "error" in the line, a positive headline and
     vs_baseline, a roofline fraction against
     the measured ceiling and a rank-512 MFU of at most BENCH_FRACTION_MAX
     (the former unless the probes undershot the solver), and launches of
     the read probe, the headline route's MUR kernel, the fused scoring
     kernel and gs_sweep (HALS's rate); the phase's seconds.
 13. BASELINE's five configs to convergence and HALS against MUR-EU in
     time to objective (configs_phase): tpunmf_torch.sweeps.run_configs at
     scale 1.0, no iteration cap, each config from one float64 NNDSVD init
     on its kernel route (f32), the plain route at float64 (the yardstick)
     and at f32 (config[1] and config[3] on phase 3's matrices, config 4
     also on a (1, 1) mesh of an NCCL group of one); each route's stop
     iteration, error and deviation, recall@10, config 3's trajectories,
     the launches by kernel and the seconds printed.  Each config's final
     error (config 3: its fixed-rho run; configs 1 and 4: the final KL)
     must be within BASELINE's 1e-4 of float64 (run_configs.gate: twice
     the plain f32 route's deviation where that exceeds 1e-4), config 4's
     mesh run within rtol 1e-6 of one device with its bits, and each
     config must launch its route's kernels (CONFIG_KERNELS).  Then
     tpunmf_torch.sweeps.bench_hals: MUR-EU, HALS 1 and 2 sweeps at
     8192x8192 r128, 150 iterations from one init, each trace non-increasing
     within EU_MONOTONE_RTOL; it/s and the iterations and seconds each HALS
     run takes to MUR-EU's 150th objective printed.
Then one JSON line of the kernels, the nvidia-smi line, and the result
line.  Without a CUDA card, or without the tpunmf_torch package beside
this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Kernel vs plain version.  Both round the same operands to the same types,
# and every sum in the updates is of positive terms, so the elementwise error
# is f32 rounding of sums taken in another order: about sqrt(n) * 6e-8
# typically, n * 6e-8 = 1.2e-3 at worst for n = 20000.  The objectives are
# sums of up to 2.2e8 cells, again in another order.
UPDATE_RTOL = 1e-4
OBJECTIVE_RTOL = 1e-4
# Fused route vs plain route over the first iterations of a run.  f32 X: the
# same formulas in another summation order.  bf16 X: the fused EU products
# also round the factor to bf16 (tpunmf mur_fused.py:84, :716), which the
# plain route does not, so the two routes differ by bf16 rounding (2^-9).
ROUTE_RTOL = {"float32": 1e-4, "bfloat16": 5e-3}
ROUTE_ITERS = 5
RUN_ITERS = 50
# the masked MUR and ADMM paths of phase 3, over ML-10M and config[3]
SLOW_RUN_ITERS = 20
# EU objective may not rise by more than f32 rounding between iterations
EU_MONOTONE_RTOL = 1e-5
# HALS sweeps clamp at 0, so an element's relative error means nothing
# near a clamp: the sweep is held to max|got - want| / max|want|
SWEEP_TOL = 1e-4
# hals_iteration_eu against its plain version, on the same scale: the kernel
# forms X round(H)^T itself (the tensor cores, each step's sum rounded) where
# the plain version takes cuBLAS's, another f32 summation order, and each
# Gauss-Seidel step subtracts sums up to k times larger than their
# difference, so that rounding comes out amplified (1.6e-4 measured at
# 8192x8192 r128 with random factors on FMA tiles)
HALS_ITER_TOL = 1e-3
# lagged[i+1] against the exact route's exact[i]: the same KL sums, one
# from the W pass's tiles and one from the objective kernel's
LAGGED_RTOL = 1e-4
# MovieLens-10M: 10,000,054 ratings of 69,878 users on 10,677 items
ML10M = (69878, 10677, 0.0134)
# BASELINE config[3] (benchmarks/run_configs.py:176-188): ADMM, L1 on H
CONFIG3 = dict(m=50000, n=20000, k=128, density=0.02, seed=3)
ADMM_KW = dict(rho=1.0, reg_w=(0, "nn"), reg_h=(0.1, "l1n"),
               nndsvd_init=(True, "zero"))
# BASELINE config[4] (benchmarks/run_configs.py:229-244): AO-ADMM KL with L1
# on W and Tikhonov smoothing on H at rank 256, lowrank_dense's recipe at
# seed 4; one card's cut of its 1M x 100k (400 GB a copy) keeps all but m, n
CONFIG4 = dict(m=50000, n=20000, k=256, seed=4)
AO_KL_KW = dict(distance_type="kl", reg_w=(0.05, "l1n"), reg_h=(0.05, "l2n"),
                admm_iter=10)
# AO-ADMM's runs at the bench's 8192^2 r128 (bench.py:717-719): (label,
# iterations, options, plain route too); the defaults, the local-sparsity
# variant, and 'cg' on the kernel route alone.  The local-sparsity run's l1
# budget, 256, is above every row of W on this X (under 90): where the
# budget binds (tpunmf's default 1, or 64) the variant's iterates blow up
# here, in float64 as in float32 (tools/ao_admm_budget.py), as tpunmf's do
# at rank 32 (tests/test_torch_ao_admm.py)
AO_KL_ITERS, AO_EU_ITERS, AO_CG_ITERS = 2, 20, 2
AO_EU_RUNS = (("AO-ADMM EU 8192^2", AO_EU_ITERS, dict(distance_type="eu"), True),
              ("AO-ADMM EU local sparsity 8192^2", AO_EU_ITERS,
               dict(distance_type="eu", rho_mode="adaptive", reg_w=(0.1, "l1inf"),
                    upper_bound=256.0), True),
              ("AO-ADMM EU cg 8192^2", AO_CG_ITERS,
               dict(distance_type="eu", spd_solver="cg"), False))
# BASELINE config[2] (benchmarks/run_configs.py:136-158): ANLS + FCNNLS on
# the MovieLens-1M stand-in at r64, from one NNDSVD 'zero' init; each NNLS
# configuration 3 iterations on each route, EU 'chol' also 10 at 8192^2 r128
ANLS_K, ANLS_ITERS, ANLS_EU_ITERS = 64, 3, 10
ANLS_RUNS = (("ANLS EU chol config[2]", dict(distance_type="eu", use_fcnnls=True)),
             ("ANLS EU cg config[2]", dict(distance_type="eu", masked_solver="cg")),
             ("ANLS EU bpp config[2]", dict(distance_type="eu", nnls_solver="bpp")),
             ("ANLS KL chol config[2]", dict(distance_type="kl")))
# ANLS's routes share every step but the objective pass, so their factors are
# the same bits and their traces differ by the objective's summation order
ANLS_TRACE_RTOL = 1e-4
# exact NNLS half-steps: the EU 'chol' trace may rise by f32 rounding only
ANLS_MONOTONE_RTOL = 1e-6
# EU transform of X with the trained W solves the fit's last H update again
TRANSFORM_RTOL = 1e-5
# the profiler range that nnls_ranges() puts around each NNLS call
NNLS_RANGE = "nnls"
# the fused scoring kernel against its plain version: both accumulate the
# same f32 products in another order; |got - want| <= 2e-5 (1 + |want|),
# tpunmf's tolerance against interpret mode (tests/test_serve.py:456-459)
SCORE_TOL = 2e-5
# serving: top-k values of the kernel and plain routes (scores summed in
# another order), relative
SERVE_VALUE_RTOL = 1e-5
SERVE_BATCH, SERVE_BATCHES, SERVE_K = 64, 20, 100
# calls of a kernel and of its library call that the profiler times
PROFILED_CALLS = 20
# iterations of a profiled factorize() (profile_run): the profiler's own
# host cost grows with the host ops it records, about 1.5 s an ANLS iteration
PROFILE_ITERS = 5

# masked_w_bits as the masked W pass gives them on an H100 with its sums
# rounded every step (fault 3.7); before, with the tensor cores' own sums,
# 7cdbaf0dd25264455ec0e6c7d08771d51db7fed38144b35f800e60027f0d8e97
MASKED_W_BITS = "2e7339ae5cda5404af7403a594f7814d772ac0bb37711d6e1680c50947e7aba3"
# the single-pass shapes: tpunmf's own route test (tests/test_ops.py:265-277)
KL_SINGLE = dict(m=8192, n=4096, k=128, seed=4)
EU_WIDE = dict(m=8192, n=16384, k=128, seed=0)
# mur_iteration_kl across the KL passes' rank lines (tensor cores to k 320
# for W, 640 for H) and its own (the pair's bodies to k 448): 8192 x 1024,
# where tpunmf's rule takes the single pass up to k 1024
KL_NARROW, KL_RANKS = 1024, (256, 384, 448, 512, 768, 1024)
SINGLE_EU = ("mur_iteration_eu", "eu_residual_obj")
PAIR = ("mur_w_update", "mur_h_update")
UPDATES = PAIR + ("mur_iteration_eu", "mur_iteration_kl")
# MUR's high-rank step: above the update kernels' 1024, within the
# objective kernels' 2048 (tpunmf takes its jnp step with the ratio and
# objective kernels there, tpunmf/solvers/mur.py:256-280)
HIGH_RANK = 1536

KERNELS = {
    "mur_w_update": ("tpunmf_torch/ops/csrc/mur_update.cu",
                     "tpunmf/ops/mur_fused.py:169"),
    "mur_h_update": ("tpunmf_torch/ops/csrc/mur_update.cu",
                     "tpunmf/ops/mur_fused.py:750"),
    "eu_residual_obj": ("tpunmf_torch/ops/csrc/objective.cu",
                        "tpunmf/ops/fused.py:233"),
    "kl_obj": ("tpunmf_torch/ops/csrc/objective.cu", "tpunmf/ops/fused.py:220"),
    "mur_w_update_lagged": ("tpunmf_torch/ops/csrc/mur_update.cu",
                            "tpunmf/ops/mur_fused.py:227"),
    "gs_sweep": ("tpunmf_torch/ops/csrc/hals_sweep.cu",
                 "tpunmf/ops/hals_sweep.py:232"),
    "masked_w_update": ("tpunmf_torch/ops/csrc/masked_update.cu",
                        "tpunmf/ops/masked_fused.py:129"),
    "masked_h_update": ("tpunmf_torch/ops/csrc/masked_update.cu",
                        "tpunmf/ops/masked_fused.py:224"),
    "kl_ratio_and_obj": ("tpunmf_torch/ops/csrc/objective.cu",
                         "tpunmf/ops/fused.py:253"),
    "blockmax_relayout": ("tpunmf_torch/ops/csrc/topk_select.cu",
                          "tpunmf/ops/topk_select.py:77"),
    "score_blockmax_relayout": ("tpunmf_torch/ops/csrc/topk_select.cu",
                                "tpunmf/ops/topk_select.py:156"),
    "mur_iteration_eu": ("tpunmf_torch/ops/csrc/mur_iteration.cu",
                         "tpunmf/ops/mur_fused.py:314"),
    "mur_iteration_kl": ("tpunmf_torch/ops/csrc/mur_iteration.cu",
                         "tpunmf/ops/mur_fused.py:652"),
    "kl_ratio": ("tpunmf_torch/ops/csrc/objective.cu", "tpunmf/ops/fused.py:243"),
    "mur_iteration_eu_dma": ("tpunmf_torch/ops/csrc/mur_iteration.cu",
                             "tpunmf/ops/mur_fused.py:465"),
    "hals_iteration_eu": ("tpunmf_torch/ops/csrc/hals_iteration.cu",
                          "tpunmf/ops/hals_sweep.py:186"),
    "v1_iter": ("tpunmf_torch/ops/csrc/mur_variants.cu", "benchmarks/sweep_iter2.py:38"),
    "v2_iter": ("tpunmf_torch/ops/csrc/mur_variants.cu", "benchmarks/sweep_iter2.py:92"),
    "iter_eu_int8": ("tpunmf_torch/ops/csrc/mur_variants.cu", "benchmarks/sweep_int8.py:49"),
    "read_probe": ("tpunmf_torch/ops/csrc/read_probe.cu", "bench.py:240"),
}
# the kernels that only the port's switches reach (tpunmf's defaults: off)
OPT_IN = ("mur_iteration_eu_dma", "hals_iteration_eu")
# the kernels of the sweep scripts and of the read-rate probe, which no
# NMF.factorize path may launch
SWEEP_ONLY = ("v1_iter", "v2_iter", "iter_eu_int8", "read_probe")
SWEEP_ITERS = 30  # the sweep scripts' loops (benchmarks/sweep_iter2.py:123)
# the shape whose times the kernels line reports (its f32 case, or X's
# type in HEADLINE_X: the sweep scripts' own)
HEADLINE = {"kl_obj": "KL", "mur_w_update_lagged": "KL",
            "masked_w_update": "ML-10M", "masked_h_update": "ML-10M",
            "kl_ratio_and_obj": "config[3]", "blockmax_relayout": "serve",
            "score_blockmax_relayout": "serve", "mur_iteration_kl": "KL",
            "kl_ratio": "high-rank KL"}
HEADLINE_X = {"v1_iter": "bf16", "v2_iter": "bf16", "iter_eu_int8": "int8"}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_pair(torch, plain, kernel, reps):
    """(kernel_ms, plain_ms): CUDA-event means, in turns plain, kernel,
    kernel, plain after one warm-up call of each."""
    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    plain()
    kernel()
    p1, k1, k2, p2 = timed(plain), timed(kernel), timed(kernel), timed(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(torch, fn, calls):
    """Device ms per call of ``fn`` over ``calls`` calls: the time of its
    kernels in torch.profiler, with no host time between them inside.
    Where the profiler shows no device time (its tracing is not always
    there), CUDA events around ``calls`` calls back to back instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us > 0:
        return us / 1e3 / calls
    print(f"  (the profiler showed no device time: CUDA events over {calls} calls)",
          flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def chunks(got, want, size=1 << 26):
    """(got, want) as float64 pieces of at most ``size`` elements, so that
    comparing two config[3]-sized outputs (1e9 cells) needs no 8 GB
    temporaries."""
    for a, b in zip(got.reshape(-1).split(size), want.reshape(-1).split(size)):
        yield a.double(), b.double()


def max_rel_err(got, want):
    tiny = float(np.finfo(np.float32).tiny)
    return max(float(((a - b).abs() / b.abs().clamp_min(tiny)).max())
               for a, b in chunks(got, want))


def scaled_err(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def close_err(got, want):
    """max |got - want| / (1 + |want|): against t, rtol = atol = t."""
    return max(float(((a - b).abs() / (1.0 + b.abs())).max())
               for a, b in chunks(got, want))


def bit_err(got, want):
    """0 when the tensors hold the same values with NaN in the same places,
    else the largest difference (inf where only one side is NaN)."""
    import torch

    worst = 0.0
    for a, b in chunks(got, want):
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            return float("inf")
        real = ~torch.isnan(b)
        worst = max(worst, float((a[real] - b[real]).abs().max()))
    return worst


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def written(outputs, inputs):
    """The outputs whose bytes a call writes: one that shares an input's
    storage (a view of it) writes none."""
    shared = {t.untyped_storage().data_ptr() for t in inputs}
    return [o for o in outputs if o.untyped_storage().data_ptr() not in shared]


def mur_flops(name, x, k, dist=None):
    """(f32, bf16) flops of one call of a MUR kernel on X at rank k."""
    import torch
    from tpunmf_torch.ops import roofline

    return roofline.mur_flops(name, *x.shape, k, x.dtype == torch.bfloat16, dist)


def check_kernel(torch, records, name, label, what, kern, plain, rtol, reps,
                 err=max_rel_err, inputs=(), flops=(0.0, 0.0, 0.0), library=None,
                 profiled=False):
    """One kernel call against its plain version on the same inputs: the
    error (over every output) against rtol, both times, the bound of the
    call (tpunmf_torch/ops/roofline.py: ``inputs`` read once, the outputs
    that are not views of an input written once, ``flops`` (f32
    elementwise, bf16 product, f32 product) done), and where one PyTorch
    call computes the same function (``library``), that call's time in
    turns with the kernel's (library, kernel, kernel, library; ``reps``
    calls a run, as ``ms``), both device times (profiler), and the bytes
    per second of each.  ``profiled``: the kernel's device time (profiler)
    too, and the rate it reaches on what binds it (TFLOP/s of its products
    where operations do, TB/s where bytes do), alone and on the device."""
    from tpunmf_torch.ops import roofline

    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rel = max(err(a, b) for a, b in zip(got, want))
    abs_err = max(bit_err(a, b) for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ms, plain_ms = time_pair(torch, plain, kern, reps)
    moved = nbytes(inputs) + nbytes(written(got, inputs))
    library_ms = turns_ms = kern_dev = lib_dev = None
    if library is not None:
        turns_ms, library_ms = time_pair(torch, library, kern, reps)
        kern_dev, lib_dev = (device_ms(torch, f, PROFILED_CALLS) for f in (kern, library))
    elif profiled:
        kern_dev = device_ms(torch, kern, PROFILED_CALLS)
    f32_flops, bf16_flops, product_flops = flops
    bound_ms, bound_by = roofline.bound(f32_flops, bf16_flops, moved, product_flops)
    ok = finite and rel <= rtol
    print(f"  {name:19s} {label:36s} {what:24s} err={rel:.3e} "
          f"(tol {rtol:.0e}) max_abs_err={abs_err:.3e} "
          f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
          f"({bound_by})  {'ok' if ok else 'FAIL'}", flush=True)
    if library is not None:
        print(f"  {name:19s} {label:36s} in turns with the library call, {reps} calls "
              f"a run, on {moved / 1e6:.1f} MB: kernel {turns_ms:.4f} ms "
              f"({moved / turns_ms / 1e9:.3f} TB/s), library {library_ms:.4f} ms "
              f"({moved / library_ms / 1e9:.3f} TB/s); device time (profiler, "
              f"{PROFILED_CALLS} calls) kernel {kern_dev:.4f} ms "
              f"({moved / kern_dev / 1e9:.3f} TB/s), library {lib_dev:.4f} ms "
              f"({moved / lib_dev / 1e9:.3f} TB/s)", flush=True)
    rates = None
    if profiled:
        # TFLOP/s of the products (bf16 and f32; or of all flops where
        # there are none) where operations bind, TB/s where bytes do; both
        # per ms: work / 1e9 / ms
        work, unit = ((bf16_flops + product_flops or f32_flops, "TFLOP/s")
                      if bound_by == "operations" else (moved, "TB/s"))
        rates = {"unit": unit, "alone": work / ms / 1e9, "device": work / kern_dev / 1e9,
                 "bound": work / bound_ms / 1e9}
        print(f"  {name:19s} {label:36s} device time (profiler, {PROFILED_CALLS} calls) "
              f"{kern_dev:.4f} ms; {unit} alone {rates['alone']:.3f}, on the device "
              f"{rates['device']:.3f}, at the bound {rates['bound']:.3f} "
              f"({product_flops / 1e9:.1f} GFLOP of f32 products, {bf16_flops / 1e9:.1f} of "
              f"bf16, {moved / 1e6:.1f} MB)",
              flush=True)
    require(finite, f"{name} {label} {what}: non-finite output")
    require(rel <= rtol, f"{name} {label} {what}: error {rel:.3e} above {rtol:.0e}")
    rec = records.setdefault(name, {"max_abs_err": 0.0, "cases": []})
    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
    rec["cases"].append({"shape": label, "case": what, "max_rel_err": rel,
                         "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved,
                         "library_ms": library_ms, "turns_ms": turns_ms,
                         "device_ms": kern_dev, "library_device_ms": lib_dev,
                         "rates": rates})


def kernel_phase(torch, cases, reps, records=None):
    """Compare every kernel of the MUR path with its plain version (a case
    may name the kernels it takes); returns per-kernel records, with the
    pair's device times and rates (tensor-core kernels).  Launches here do
    not count toward a path's."""
    from tpunmf_torch.ops import fused, mur_fused

    records = {} if records is None else records
    for label, x, k, distances, *only in cases:
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(7)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        checks = []
        for dist in distances:
            for lam in (0.0, 0.2):
                checks.append((
                    "mur_w_update", dist, f"{dist} lam={lam}",
                    lambda d=dist, l=lam: mur_fused.mur_w_update(
                        x, w, h, distance_type=d, lam=l),
                    lambda d=dist, l=lam: mur_fused.mur_w_update_ref(
                        x, w, h, distance_type=d, lam=l), UPDATE_RTOL))
                checks.append((
                    "mur_h_update", dist, f"{dist} lam={lam}",
                    lambda d=dist, l=lam: mur_fused.mur_h_update(
                        x, w, h, distance_type=d, lam=l),
                    lambda d=dist, l=lam: mur_fused.mur_h_update_ref(
                        x, w, h, distance_type=d, lam=l), UPDATE_RTOL))
            obj = "eu_residual_obj" if dist == "eu" else "kl_obj"
            checks.append((obj, dist, dist, lambda o=obj: getattr(fused, o)(x, w, h),
                           lambda o=obj: getattr(fused, o + "_ref")(x, w, h),
                           OBJECTIVE_RTOL))
        for name, dist, what, kern, plain, rtol in checks:
            if only and name not in only[0]:
                continue
            check_kernel(torch, records, name, label, what, kern, plain, rtol, reps,
                         inputs=(x, w, h), flops=mur_flops(name, x, k, dist),
                         profiled=name in PAIR)
        del w, h
    return records


def lagged_phase(torch, records, x, k, label, reps):
    """The lagged W pass against its plain version: the new W, and the
    objective against the plain masked KL of the incoming (W, H) (the
    formula of fused.kl_obj_ref), with its device time; its W must be the
    plain KL W pass's bit for bit."""
    from tpunmf_torch.ops import mur_fused

    m, n = x.shape
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    w = torch.rand((m, k), generator=g, device="cuda") + 0.1
    h = torch.rand((k, n), generator=g, device="cuda") + 0.1
    for lam in (0.0, 0.2):
        kw = dict(distance_type="kl", lam=lam, with_lagged_obj=True)
        check_kernel(torch, records, "mur_w_update_lagged", label, f"kl lam={lam}",
                     lambda: mur_fused.mur_w_update(x, w, h, **kw),
                     lambda: mur_fused.mur_w_update_ref(x, w, h, **kw),
                     UPDATE_RTOL, reps, inputs=(x, w, h),
                     flops=mur_flops("mur_w_update_lagged", x, k, "kl"), profiled=True)
        got = mur_fused.mur_w_update(x, w, h, **kw)[0]
        require(torch.equal(got, mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=lam)),
                f"mur_w_update_lagged {label}: its W is not the plain KL W pass's")


def masked_w_bits(torch, mf):
    """sha256 of masked_w_update's outputs on fixed inputs made from a seed:
    EU and KL, lam 0.2, f32 and bf16 X, a uint8 mask with a cold row and
    column, at 300x277 k37 (32-row blocks, H through its padded copy) and
    17000x260 k64 (64-row blocks, H in place)."""
    import hashlib

    digest = hashlib.sha256()
    for m, n, k in ((300, 277, 37), (17000, 260, 64)):
        rng = np.random.default_rng(m + n + k)
        x = rng.random((m, n), dtype=np.float32)
        mask = (rng.random((m, n)) < 0.3).astype(np.uint8)
        mask[3, :] = 0
        mask[:, 5] = 0
        w = (rng.random((m, k)) + 0.1).astype(np.float32)
        h = (rng.random((k, n)) + 0.1).astype(np.float32)
        xc, mc, wc, hc = (torch.from_numpy(a).cuda() for a in (x, mask, w, h))
        for xx in (xc, xc.bfloat16()):
            for dist in ("eu", "kl"):
                out = mf.masked_w_update(xx, mc, wc, hc, distance_type=dist, lam=0.2)
                digest.update(out.cpu().numpy().tobytes())
    return digest.hexdigest()


def iteration_phase(torch, records, cases, reps):
    """mur_iteration_eu / mur_iteration_kl against their plain versions
    (every output, KL's objective too, within UPDATE_RTOL: f32 sums of
    positive terms in another order), and where ``pair`` is set the single
    pass against the 2-pass pair (mur_w_update + mur_h_update) on the same
    inputs, timed in turns (pair, single, single, pair); returns those
    times."""
    from tpunmf_torch.ops import mur_fused

    routes = {}
    for label, x, k, dist, pair in cases:
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(14)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        name = "mur_iteration_" + dist
        tileable = mur_fused.iter_eu_tileable if dist == "eu" else mur_fused.iter_kl_tileable
        route = tileable(x, k)
        # tpunmf's strip height where its rule gives one, else one strip
        bm = m if route is None else route if dist == "eu" else route[0]
        kern, ref = getattr(mur_fused, name), getattr(mur_fused, name + "_ref")
        for lam in (0.0, 0.2):
            check_kernel(torch, records, name, label, f"{dist} lam={lam} bm={bm}",
                         lambda l=lam: kern(x, w, h, lam_w=l, bm=bm),
                         lambda l=lam: ref(x, w, h, lam_w=l), UPDATE_RTOL, reps,
                         inputs=(x, w, h), flops=mur_flops(name, x, k), profiled=True)
        if pair:
            def two_pass():
                w1 = mur_fused.mur_w_update(x, w, h, distance_type=dist, lam=0.0)
                return mur_fused.mur_h_update(x, w1, h, distance_type=dist, lam=0.0)

            single_ms, pair_ms = time_pair(torch, two_pass,
                                           lambda: kern(x, w, h, lam_w=0.0, bm=bm), reps)
            routes[label] = {"single_ms": single_ms, "pair_ms": pair_ms}
            print(f"  {label}: single pass {single_ms:.4f} ms, 2-pass pair "
                  f"{pair_ms:.4f} ms (mur_w_update + mur_h_update, in turns)", flush=True)
        del w, h
    return routes


def kl_bits_phase(torch, cases):
    """Up to KL_ITER_PAIR_RANK mur_iteration_kl runs the 2-pass pair's KL
    bodies: its W' and objective must be the lagged KL W pass's, its wtr
    the KL H pass's numerator at that W', bit for bit; above it (its FMA
    waves) within UPDATE_RTOL of them (launches here count toward no
    path)."""
    from tpunmf_torch.ops import mur_fused

    def bits(a):
        return a.contiguous().view(torch.int32).cpu().numpy().tobytes()

    for label, x, k in cases:
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(16)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        w_new, wtr, obj = mur_fused.mur_iteration_kl(x, w, h, lam_w=0.2, bm=m)
        w_pair, obj_pair = mur_fused.mur_w_update(x, w, h, distance_type="kl", lam=0.2,
                                                  with_lagged_obj=True)
        numer = mur_fused.mur_h_update(x, w_new, h, distance_type="kl", lam=0.2)[1]
        outs = {"W'": (w_new, w_pair), "obj": (obj, obj_pair), "wtr": (wtr, numer)}
        if mur_fused.iteration_kl_on_pair(k):
            same = {name: bits(a) == bits(b) for name, (a, b) in outs.items()}
            print(f"  mur_iteration_kl {label}: the pair's bits in "
                  f"{', '.join(n for n, ok in same.items() if ok) or 'nothing'}", flush=True)
            require(all(same.values()), f"mur_iteration_kl {label}: not the pair's bits in "
                                        f"{[n for n, ok in same.items() if not ok]}")
        else:
            rel = max(max_rel_err(a, b) for a, b in outs.values())
            print(f"  mur_iteration_kl {label} (FMA waves): max relative |single - pair| "
                  f"{rel:.3e} (tol {UPDATE_RTOL:.0e})", flush=True)
            require(rel <= UPDATE_RTOL, f"mur_iteration_kl {label}: {rel:.3e} off the pair")
        del w, h, w_new, wtr, w_pair, numer


def sweep_phase(torch, records, cases, reps):
    """gs_sweep against its plain version in the W frame (transposed
    views) and the H frame; at the shapes marked ``timed``, each frame's
    device ms at 1 and 2 sweeps beside the bound and its share of it."""
    from tpunmf_torch.ops import hals_sweep, roofline

    for label, x, k, timed in cases:
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(9)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        frames = {"W frame": ((x @ h.T).T, h @ h.T, w.T),
                  "H frame": (w.T @ x, w.T @ w, h)}
        for frame, (a, gram, v) in frames.items():
            for lam in (0.0, 0.3):
                for nsweeps in (1, 2):
                    kw = dict(lam=lam, nsweeps=nsweeps)
                    # each sweep updates every entry of V from a row of the Gram
                    check_kernel(torch, records, "gs_sweep", label,
                                 f"{frame} lam={lam} sweeps={nsweeps}",
                                 lambda: hals_sweep.gs_sweep(a, gram, v, **kw),
                                 lambda: hals_sweep.gs_sweep_ref(a, gram, v, **kw),
                                 SWEEP_TOL, reps, err=scaled_err, inputs=(a, gram, v),
                                 flops=roofline.sweep_flops(k, v.shape[1], nsweeps),
                                 profiled=timed and lam == 0.0)
                    if timed and lam == 0.0:
                        c = records["gs_sweep"]["cases"][-1]
                        print(f"  gs_sweep {frame} {v.shape[1]} columns k{k} sweeps={nsweeps}: "
                              f"device {c['device_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                              f"({c['bound_by']}), {c['bound_ms'] / c['device_ms']:.1%} of the "
                              f"bound", flush=True)
        del w, h, frames


def x_load_path(x):
    """How the kernels on TMA and wgmma (csrc/wave.cuh's TmaStages, the
    scoring kernel of csrc/topk_select.cu) load the tiles of X (of H): by
    TMA where its rows start on 16 bytes, else by the producer warpgroup's
    16-byte cp.async copies of the chunks that cover each row
    (hop::copy_rows)."""
    row, base = x.shape[1] * x.element_size(), x.data_ptr()
    if base % 16 == 0 and row % 16 == 0:
        return "TMA"
    return "16-byte cp.async of the rows' covering chunks (rows off 16 bytes)"


def opt_in_phase(torch, records, eu_x, k, ragged, reps):
    """hals_iteration_eu (HALS_ITER_TOL, scaled: the sweeps clamp) and
    mur_iteration_eu_dma (UPDATE_RTOL, with device times) against their
    plain versions; the dma variant (TMA and wgmma) at lam_w=0 against
    v1_iter (the same stages on the same operands): the same outputs bit
    for bit; and against mur_iteration_eu (mma.sync): within ROUTE_RTOL,
    timed in turns (auto, dma, dma, auto).  Returns those times, with the
    load path of X's tiles."""
    from tpunmf_torch.ops import hals_sweep, mur_fused, mur_variants, roofline

    g = torch.Generator(device="cuda")
    g.manual_seed(15)

    def factors(m, n, kk):
        return (torch.rand((m, kk), generator=g, device="cuda") + 0.1,
                torch.rand((kk, n), generator=g, device="cuda") + 0.1)

    eu, rag = f"EU {tuple(eu_x.shape)} k{k}", f"ragged {tuple(ragged.shape)}"
    # the HALS path's 2 sweeps first: the kernels line reports the first case
    for label, x, kk, nsweeps, lam in (
            (f"{eu} f32", eu_x, k, 2, 0.0), (f"{eu} f32", eu_x, k, 1, 0.0),
            (f"{eu} bf16", eu_x.bfloat16(), k, 2, 0.0),
            (f"{rag} k40 f32", ragged, 40, 2, 0.3),
            (f"{rag} k40 bf16", ragged.bfloat16(), 40, 2, 0.3)):
        m, n = x.shape
        w, h = factors(m, n, kk)
        bm = hals_sweep.hals_iter_tileable(x, kk) or m  # tpunmf's strips, else one
        kw = dict(lam_w=lam, nsweeps=nsweeps)
        check_kernel(torch, records, "hals_iteration_eu", label,
                     f"lam={lam} sweeps={nsweeps} bm={bm}",
                     lambda: hals_sweep.hals_iteration_eu(x, w, h, bm=bm, **kw),
                     lambda: hals_sweep.hals_iteration_eu_ref(x, w, h, **kw),
                     HALS_ITER_TOL, reps, err=scaled_err, inputs=(x, w, h),
                     flops=roofline.hals_flops(m, n, kk, x.dtype == torch.bfloat16, nsweeps),
                     profiled=True)
        del w, h
    line = {}
    for label, x, kk in ((f"{eu} f32", eu_x, k), (f"{eu} bf16", eu_x.bfloat16(), k),
                         (f"{rag} k37 f32", ragged, 37),
                         (f"{rag} k37 bf16", ragged.bfloat16(), 37)):
        m, n = x.shape
        w, h = factors(m, n, kk)
        # tpunmf's strip heights where its rules give one, else two strips / one
        bm = mur_fused.iter_eu_dma_tileable(x, kk) or m // 2
        auto_bm = mur_fused.iter_eu_tileable(x, kk) or m
        for lam in (0.0, 0.2):
            check_kernel(torch, records, "mur_iteration_eu_dma", label, f"eu lam={lam} bm={bm}",
                         lambda l=lam: mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=l, bm=bm),
                         lambda l=lam: mur_fused.mur_iteration_eu_dma_ref(x, w, h, lam_w=l),
                         UPDATE_RTOL, reps, inputs=(x, w, h),
                         flops=mur_flops("mur_iteration_eu_dma", x, kk), profiled=True)
        dma = mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.2, bm=bm)
        auto = mur_fused.mur_iteration_eu(x, w, h, lam_w=0.2, bm=auto_bm)
        rel = max(max_rel_err(a, b) for a, b in zip(dma, auto))
        rtol = ROUTE_RTOL[str(x.dtype).split(".")[-1]]
        v1_bm = 128 if x.shape[0] % 128 == 0 else 8  # the sweep scripts' strips
        v1 = mur_variants.v1_iter(x, w, h, bm=v1_bm)
        dma0 = mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.0, bm=bm)
        diff = max(bit_err(a, b) for a, b in zip(dma0, v1))
        dma_ms, auto_ms = time_pair(
            torch, lambda: mur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=auto_bm),
            lambda: mur_fused.mur_iteration_eu_dma(x, w, h, lam_w=0.0, bm=bm), reps)
        path = x_load_path(x)
        line[label] = {"dma_ms": dma_ms, "auto_ms": auto_ms, "max_rel_diff": rel,
                       "max_abs_diff_v1": diff, "x_loads": path}
        print(f"  {label}: mur_iteration_eu_dma {dma_ms:.4f} ms, mur_iteration_eu "
              f"{auto_ms:.4f} ms (in turns); max relative |dma - auto| {rel:.3e} "
              f"(tol {rtol:.0e}); max |dma - v1_iter| at lam_w=0 {diff:.3e}; X's tiles by "
              f"{path}", flush=True)
        require(rel <= rtol, f"{label}: the dma variant and mur_iteration_eu differ by "
                             f"{rel:.3e}")
        require(diff == 0.0, f"{label}: the dma variant (lam_w=0) and v1_iter differ")
        del w, h, dma, auto, dma0, v1
    return line


def variant_phase(torch, records, eu_x, k, ragged, reps):
    """The sweep scripts' kernels against their plain versions (UPDATE_RTOL:
    sums of positive terms in another order): v1_iter and v2_iter at the
    scripts' 8192x8192 r128 on bf16 X and on f32 X and at ragged k37 (with
    device times), v1 also against mur_iteration_eu(lam_w=0) on the same
    inputs (wgmma against mma.sync) within ROUTE_RTOL, timed in turns
    (auto, v1, v1, auto); iter_eu_int8 on X + 0.05 quantised
    as sweep_int8.py does and on the ragged X (rows off 16 bytes),
    with device times, held at scale 1 to v1_iter on xq.to(bfloat16) bit for
    bit (the same stages on the same values); and the read probe at
    8192x8192 f32 (268 MB, past the 50 MB L2) with torch.sum(x, 0) as its
    library call, and at a ragged 896x777 (n % 4 != 0).  Returns the v1 /
    auto times and int8's checks."""
    from tpunmf_torch.ops import mur_fused, mur_variants, read_probe, roofline
    from tpunmf_torch.sweeps import sweep_int8

    g = torch.Generator(device="cuda")
    g.manual_seed(16)

    def factors(m, n, kk):
        return (torch.rand((m, kk), generator=g, device="cuda") + 0.1,
                torch.rand((kk, n), generator=g, device="cuda") + 0.1)

    eu, rag = f"EU {tuple(eu_x.shape)} k{k}", f"ragged {tuple(ragged.shape)} k37"
    line = {}
    # the scripts' bf16 X first: the kernels line reports the first case
    for label, x, kk, bm in ((f"{eu} bf16", eu_x.bfloat16(), k, 128), (f"{eu} f32", eu_x, k, 128),
                             (f"{rag} f32", ragged, 37, 8), (f"{rag} bf16", ragged.bfloat16(), 37, 8)):
        m, n = x.shape
        w, h = factors(m, n, kk)
        for name in ("v1_iter", "v2_iter"):
            kern, ref = getattr(mur_variants, name), getattr(mur_variants, name + "_ref")
            check_kernel(torch, records, name, label, f"eu lam=0 bm={bm}",
                         lambda: kern(x, w, h, bm), lambda: ref(x, w, h), UPDATE_RTOL, reps,
                         inputs=(x, w, h), flops=mur_flops(name, x, kk), profiled=True)
        auto_bm = mur_fused.iter_eu_tileable(x, kk) or m
        v1 = mur_variants.v1_iter(x, w, h, bm)
        auto = mur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=auto_bm)
        rel = max(max_rel_err(a, b) for a, b in zip(v1, auto))
        rtol = ROUTE_RTOL[str(x.dtype).split(".")[-1]]
        v1_ms, auto_ms = time_pair(
            torch, lambda: mur_fused.mur_iteration_eu(x, w, h, lam_w=0.0, bm=auto_bm),
            lambda: mur_variants.v1_iter(x, w, h, bm), reps)
        path = x_load_path(x)
        line[label] = {"v1_ms": v1_ms, "auto_ms": auto_ms, "max_rel_diff": rel, "x_loads": path}
        print(f"  {label}: v1_iter {v1_ms:.4f} ms, mur_iteration_eu(lam_w=0) {auto_ms:.4f} ms "
              f"(in turns); max relative |v1 - auto| {rel:.3e} (tol {rtol:.0e}); X's tiles by "
              f"{path}", flush=True)
        require(rel <= rtol, f"{label}: v1_iter and mur_iteration_eu(lam_w=0) differ by "
                             f"{rel:.3e}")
        del w, h, v1, auto
    for label, x, kk, bm in ((f"{eu} int8", eu_x + 0.05, k, 128), (f"{rag} int8", ragged, 37, 8)):
        m, n = x.shape
        w, h = factors(m, n, kk)
        xq, scale = sweep_int8.quantize(x)
        check_kernel(torch, records, "iter_eu_int8", label, f"eu lam=0 bm={bm}",
                     lambda: mur_variants.iter_eu_int8(xq, scale, w, h, bm),
                     lambda: mur_variants.iter_eu_int8_ref(xq, scale, w, h), UPDATE_RTOL, reps,
                     inputs=(xq, scale, w, h), flops=mur_flops("iter_eu_int8", xq, kk),
                     profiled=True)
        one = torch.tensor(1.0, device="cuda")
        q1 = mur_variants.iter_eu_int8(xq, one, w, h, bm)
        v1 = mur_variants.v1_iter(xq.to(torch.bfloat16), w, h, bm)
        diff = max(bit_err(a, b) for a, b in zip(q1, v1))
        path = x_load_path(xq)
        line[label] = {"max_abs_diff_v1": diff, "x_loads": path,
                       "device_ms": records["iter_eu_int8"]["cases"][-1]["device_ms"]}
        print(f"  {label}: iter_eu_int8 at scale 1 against v1_iter on xq.to(bfloat16): max "
              f"|diff| {diff:.3e}; X's tiles by {path}", flush=True)
        require(diff == 0.0, f"{label}: iter_eu_int8 at scale 1 and v1_iter on the widened X "
                             f"differ by {diff:.3e}")
        del w, h, xq, q1, v1
    s = torch.tensor(0.5, device="cuda")
    for label, x in ((f"EU {tuple(eu_x.shape)} f32", eu_x),
                     ("ragged (896, 777) f32", ragged[:896].contiguous())):
        library = (lambda: torch.sum(x, dim=0)) if x is eu_x else None
        check_kernel(torch, records, "read_probe", label, "s=0.5",
                     lambda: read_probe.read_probe(x, s), lambda: read_probe.read_probe_ref(x, s),
                     UPDATE_RTOL, reps, inputs=(x, s), flops=roofline.read_probe_flops(*x.shape),
                     library=library)
    probe = records["read_probe"]["cases"][0]
    print(f"  read probe {tuple(eu_x.shape)} f32: {nbytes((eu_x,)) / probe['ms'] / 1e9:.3f} "
          f"TB/s per call, {reps} calls a run (published peak 3.35 TB/s)", flush=True)
    return line


def masked_phase(torch, records, cases, reps):
    """masked_w_update / masked_h_update against their plain versions:
    EU and KL, lam 0 and 0.2, a 1-byte binary mask and an f32 weight
    mask, each with a fully unobserved row and column, with their device
    time and rate; at the last shape both also on bf16 X (uint8 mask),
    where a second call of each must give the same bits (f32 and bf16 X)."""
    from tpunmf_torch.ops import masked_fused as mf
    from tpunmf_torch.ops import roofline

    for case, (label, x, observed, k) in enumerate(cases):
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(10)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        binary = observed.to(torch.uint8)
        binary[0, :] = 0
        binary[:, 0] = 0
        weights = binary * (0.5 + torch.rand((m, n), generator=g, device="cuda"))
        for mask_name, mask in (("uint8", binary), ("f32 weights", weights)):
            for dist in ("eu", "kl"):
                for lam in (0.0, 0.2):
                    kw = dict(distance_type=dist, lam=lam)
                    what = f"{dist} lam={lam} {mask_name}"
                    # S = W H and two products against a factor: 6 m n k
                    work = dict(inputs=(x, mask, w, h), flops=roofline.masked_flops(m, n, k))
                    check_kernel(torch, records, "masked_w_update", label, what,
                                 lambda: mf.masked_w_update(x, mask, w, h, **kw),
                                 lambda: mf.masked_w_update_ref(x, mask, w, h, **kw),
                                 UPDATE_RTOL, reps, profiled=True, **work)
                    check_kernel(torch, records, "masked_h_update", label, what,
                                 lambda: mf.masked_h_update(x, mask, w, h, **kw),
                                 lambda: mf.masked_h_update_ref(x, mask, w, h, **kw),
                                 UPDATE_RTOL, reps, profiled=True, **work)
        if case == len(cases) - 1:
            xb = x.bfloat16()
            for dist in ("eu", "kl"):
                kw = dict(distance_type=dist, lam=0.2)
                for name in ("masked_w_update", "masked_h_update"):
                    kern, ref = getattr(mf, name), getattr(mf, name + "_ref")
                    check_kernel(torch, records, name, label[:-3] + "bf16",
                                 f"{dist} lam=0.2 uint8",
                                 lambda: kern(xb, binary, w, h, **kw),
                                 lambda: ref(xb, binary, w, h, **kw),
                                 UPDATE_RTOL, reps, inputs=(xb, binary, w, h),
                                 flops=roofline.masked_flops(m, n, k))
                    for xx in (x, xb):
                        first = kern(xx, binary, w, h, **kw)
                        require(torch.equal(first, kern(xx, binary, w, h, **kw)),
                                f"{name} {label} {dist} {xx.dtype}: two calls differ")
            print(f"  masked_w_update {label}: {mf.w_block_rows(m, k)}-row blocks, H read at "
                  f"row stride {mf.h_stride(n)}; masked_h_update: {mf.row_splits(m, n, k)} "
                  f"row splits; both the same bits on a second call (eu, kl; f32 and bf16 X)",
                  flush=True)
            del xb, first
        del w, h, binary, weights


PASS_CASE = {"kl_ratio": "ratio", "kl_ratio_and_obj": "ratio, objective",
             "eu_residual_obj": "eu", "kl_obj": "kl"}


def pass_phase(torch, records, cases, reps):
    """The ratio and objective passes of csrc/objective.cu (one tensor-core
    body) against their plain versions: kl_ratio elementwise within
    UPDATE_RTOL (W H is a sum of positive terms, so the only error is f32
    summation order), the objectives (and kl_ratio_and_obj's ratio) within
    OBJECTIVE_RTOL, with their device time and rate at the paths' shapes;
    and wherever a KL pass runs, kl_ratio's ratio and kl_obj's objective
    must be kl_ratio_and_obj's bit for bit."""
    from tpunmf_torch.ops import fused

    for name, label, x, k in cases:
        m, n = x.shape
        g = torch.Generator(device="cuda")
        g.manual_seed(12)
        w = torch.rand((m, k), generator=g, device="cuda") + 0.1
        h = torch.rand((k, n), generator=g, device="cuda") + 0.1
        kern, ref = getattr(fused, name), getattr(fused, name + "_ref")
        check_kernel(torch, records, name, label, PASS_CASE[name],
                     lambda: kern(x, w, h), lambda: ref(x, w, h),
                     UPDATE_RTOL if name == "kl_ratio" else OBJECTIVE_RTOL, reps,
                     inputs=(x, w, h), flops=mur_flops(name, x, k),
                     profiled=not label.startswith("ragged"))
        if name in ("kl_ratio_and_obj", "kl_obj"):  # one body: the same bits
            ratio, obj = fused.kl_ratio_and_obj(x, w, h)
            diff = bit_err(fused.kl_ratio(x, w, h), ratio)
            require(diff == 0.0, f"kl_ratio and kl_ratio_and_obj {label}: ratios differ "
                                 f"by {diff:.3e}")
            diff = bit_err(fused.kl_obj(x, w, h), obj)
            require(diff == 0.0, f"kl_obj and kl_ratio_and_obj {label}: objectives differ "
                                 f"by {diff:.3e}")
            del ratio, obj
        del w, h


def serving_kernel_phase(torch, records, reps):
    """blockmax_relayout (bit for bit) and score_blockmax_relayout
    (SCORE_TOL, with device times) against their plain versions at the
    serving shapes and ragged ones (H's rows off 16 bytes), its
    maxima held to torch.amax of its s3 bit for bit, with the load path of
    H's tiles; and torch.topk on the full (64, 2^20) scores beside the
    block-max route."""
    from tpunmf_torch.ops import topk_select as ts
    from tpunmf_torch.serve import topk

    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    scoring = {}
    for label, b, n, dtype in ((f"serve ({SERVE_BATCH}, {1 << 20}) f32", SERVE_BATCH,
                                1 << 20, torch.float32),
                               (f"serve ({SERVE_BATCH}, {1 << 20}) bf16", SERVE_BATCH,
                                1 << 20, torch.bfloat16),
                               ("ragged (3, 40000) f32", 3, 40000, torch.float32),
                               (f"two row tiles (96, {1 << 20}) f32", 96, 1 << 20,
                                torch.float32)):
        s = torch.randn((b, n), generator=g, device="cuda").to(dtype)
        # where the blocks tile n exactly (n = 2^20), the kernel returns s3
        # as a view of the scores (no bytes written: the bound is the read of
        # S plus the maxima) and one torch.amax of that view computes the
        # same maxima: the library call
        library = ((lambda: torch.amax(s.view(b, n // 128, 128), dim=2))
                   if n % (128 * 128) == 0 else None)
        check_kernel(torch, records, "blockmax_relayout", label, "bit for bit",
                     lambda: ts.blockmax_relayout(s), lambda: ts.blockmax_relayout_ref(s),
                     0.0, reps, err=bit_err, inputs=(s,), flops=(float(b * n), 0.0, 0.0),
                     library=library)
        if dtype == torch.float32 and b == SERVE_BATCH:
            scores = s
        del s
    for label, b, r, n, hdtype in (
            (f"serve ({SERVE_BATCH}, 128)x(128, {1 << 20}) f32", SERVE_BATCH, 128,
             1 << 20, torch.float32),
            (f"serve ({SERVE_BATCH}, 128)x(128, {1 << 20}) bf16 H", SERVE_BATCH, 128,
             1 << 20, torch.bfloat16),
            (f"serve ({SERVE_BATCH}, 512)x(512, {1 << 19}) f32", SERVE_BATCH, 512,
             1 << 19, torch.float32),
            ("ragged (96, 128)x(128, 40000) f32", 96, 128, 40000, torch.float32),
            (f"serve ({SERVE_BATCH}, 128)x(128, {(1 << 20) + 2}) f32", SERVE_BATCH, 128,
             (1 << 20) + 2, torch.float32),
            ("ragged (8, 64)x(64, 40001) f32", 8, 64, 40001, torch.float32),
            ("ragged (8, 64)x(64, 40001) bf16 H", 8, 64, 40001, torch.bfloat16)):
        w = torch.rand((b, r), generator=g, device="cuda").to(hdtype)
        h = torch.rand((r, n), generator=g, device="cuda").to(hdtype)
        product = 2.0 * b * r * n  # and one comparison a score
        flops = ((b * n, product, 0.0) if hdtype == torch.bfloat16 else (b * n, 0.0, product))
        check_kernel(torch, records, "score_blockmax_relayout", label, "f32 accumulate",
                     lambda: ts.score_blockmax_relayout(w, h),
                     lambda: ts.score_blockmax_relayout_ref(w, h), SCORE_TOL, reps,
                     err=close_err, inputs=(w, h), flops=flops, profiled=True)
        bmax, s3 = ts.score_blockmax_relayout(w, h)
        diff = bit_err(bmax, torch.amax(s3, dim=2))
        path = x_load_path(h)
        scoring[label] = {"bmax_vs_amax_s3": diff, "h_loads": path,
                          "device_ms": records["score_blockmax_relayout"]["cases"][-1][
                              "device_ms"]}
        print(f"  {label}: max |bmax - amax(s3)| {diff:.3e}; H's tiles by {path}", flush=True)
        require(diff == 0.0, f"score_blockmax_relayout {label}: bmax is not amax(s3)")
        del w, h, bmax, s3

    # torch.topk of the whole score matrix against the block-max route
    # (blockmax_relayout + the gathered sort) on the same scores
    got = topk._exact_topk(scores, SERVE_K)
    want = torch.topk(scores, SERVE_K)
    require(torch.equal(got[0], want.values), "torch.topk and the block-max route "
                                              "disagree on the top-k values")
    route_ms, topk_ms = time_pair(torch, lambda: torch.topk(scores, SERVE_K),
                                  lambda: topk._exact_topk(scores, SERVE_K), reps)
    line = {"scores": [SERVE_BATCH, 1 << 20], "k": SERVE_K, "torch_topk_ms": topk_ms,
            "blockmax_route_ms": route_ms, "scoring": scoring}
    print(f"  torch.topk of ({SERVE_BATCH}, {1 << 20}) f32 at k={SERVE_K}: "
          f"{topk_ms:.4f} ms; block-max route on the same scores {route_ms:.4f} ms "
          f"(same values)", flush=True)
    return line


def kernel_counters():
    """Each kernel of KERNELS (and the lagged W pass): its wrapper and the
    attribute that counts its launches."""
    from tpunmf_torch.ops import (fused, hals_sweep, masked_fused, mur_fused, mur_variants,
                                  read_probe, topk_select)

    return {"mur_w_update": (mur_fused.mur_w_update, "launches"),
            "mur_h_update": (mur_fused.mur_h_update, "launches"),
            "eu_residual_obj": (fused.eu_residual_obj, "launches"),
            "kl_obj": (fused.kl_obj, "launches"),
            "mur_w_update_lagged": (mur_fused.mur_w_update, "lagged_launches"),
            "gs_sweep": (hals_sweep.gs_sweep, "launches"),
            "masked_w_update": (masked_fused.masked_w_update, "launches"),
            "masked_h_update": (masked_fused.masked_h_update, "launches"),
            "kl_ratio_and_obj": (fused.kl_ratio_and_obj, "launches"),
            "blockmax_relayout": (topk_select.blockmax_relayout, "launches"),
            "score_blockmax_relayout": (topk_select.score_blockmax_relayout,
                                        "launches"),
            "mur_iteration_eu": (mur_fused.mur_iteration_eu, "launches"),
            "mur_iteration_kl": (mur_fused.mur_iteration_kl, "launches"),
            "kl_ratio": (fused.kl_ratio, "launches"),
            "mur_iteration_eu_dma": (mur_fused.mur_iteration_eu_dma, "launches"),
            "hals_iteration_eu": (hals_sweep.hals_iteration_eu, "launches"),
            "v1_iter": (mur_variants.v1_iter, "launches"),
            "v2_iter": (mur_variants.v2_iter, "launches"),
            "iter_eu_int8": (mur_variants.iter_eu_int8, "launches"),
            "read_probe": (read_probe.read_probe, "launches")}


def reset_counters(counters):
    for fn, attr in counters.values():
        setattr(fn, attr, 0)


def counts(counters):
    return {name: getattr(fn, attr) for name, (fn, attr) in counters.items()}


def run_path(torch, counters, label, needed, body):
    """Drive one path: every count set to 0 just before it, read just
    after; each kernel the path runs must have launched."""
    t0 = time.perf_counter()
    reset_counters(counters)
    out = body()
    launched = counts(counters)
    print(f"  {label}: launches {launched} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    for name in needed:
        require(launched[name] > 0, f"{label}: {name} was not launched")
    return out, launched


def run_slice(torch, tt, wrappers, label, x, k, distance, data_dtype, card,
              iters, method="mur", needed=None, banned=(), exact=None, **extra):
    """One NMF run of `iters` iterations on the fused route, and the plain
    route over the same run for comparison; returns the rates, the routes'
    agreement and the fused route's trace.  The fused run must launch every
    kernel of ``needed``, none of ``banned`` (the other route's), and each
    kernel of ``exact`` exactly that many times."""
    kw = dict(method=method, min_iter=iters, max_iter=iters, **extra)
    if method in ("mur", "admm"):
        kw["distance_type"] = distance
    if data_dtype is not None:
        kw["data_dtype"] = data_dtype
    # warm-up: first-call costs (allocator, cuBLAS handles) stay out of timing
    tt.NMF(x, k).factorize(**{**kw, "min_iter": 2, "max_iter": 2})
    tt.NMF(x, k).factorize(use_pallas=False, **{**kw, "min_iter": 2, "max_iter": 2})

    before = counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused = tt.NMF(x, k).factorize(**kw)
    torch.cuda.synchronize()
    fused_s = time.perf_counter() - t0
    launched = {n: c - before[n] for n, c in counts(wrappers).items()}

    t0 = time.perf_counter()
    plain = tt.NMF(x, k).factorize(use_pallas=False, **kw)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    require(counts(wrappers) == {n: before[n] + launched[n] for n in before},
            f"{label}: the plain route launched a kernel")

    hist = np.asarray(fused.obj_history, dtype=np.float64)
    plain_hist = np.asarray(plain.obj_history, dtype=np.float64)
    dname = "bfloat16" if data_dtype == torch.bfloat16 else "float32"
    rtol = ROUTE_RTOL[dname]
    route_err = float(np.max(np.abs(hist[:ROUTE_ITERS + 1]
                                    - plain_hist[:ROUTE_ITERS + 1])
                             / np.abs(plain_hist[:ROUTE_ITERS + 1])))
    print(f"  {label}: i={fused.i} obj[0]={hist[0]:.6e} obj[{iters}]={hist[-1]:.6e} "
          f"plain obj[{iters}]={plain_hist[-1]:.6e}", flush=True)
    print(f"  {label}: fused {iters / fused_s:.2f} it/s, plain {iters / plain_s:.2f} it/s "
          f"(wall clock over factorize(), init included; {card})", flush=True)
    print(f"  {label}: first {ROUTE_ITERS} iterations fused vs plain max rel "
          f"{route_err:.3e} (tol {rtol:.0e}); launches {launched}", flush=True)

    require(fused.i == iters - 1 and len(hist) == iters + 1,
            f"{label}: ran {fused.i + 1} iterations, expected {iters}")
    require(np.all(np.isfinite(hist)), f"{label}: non-finite objective")
    require(np.all(np.isfinite(fused.w)) and np.all(np.isfinite(fused.h)),
            f"{label}: non-finite factors")
    require(fused.w.shape == (x.shape[0], k) and fused.h.shape == (k, x.shape[1]),
            f"{label}: factor shapes {fused.w.shape} {fused.h.shape}")
    require(route_err <= rtol, f"{label}: fused and plain routes disagree "
                               f"({route_err:.3e} > {rtol:.0e})")
    if distance == "eu" and method != "admm":  # ADMM's trace is not monotone
        rises = np.diff(hist) / hist[:-1]
        require(np.all(rises <= EU_MONOTONE_RTOL),
                f"{label}: EU objective rose by {rises.max():.3e}")
    if needed is None:
        needed = ("mur_w_update", "mur_h_update",
                  "kl_obj" if distance == "kl" else "eu_residual_obj")
    for name in needed:
        require(launched[name] > 0, f"{label}: {name} was not launched")
    for name in banned:
        require(launched[name] == 0, f"{label}: {name} was launched off its route")
    for name, count in (exact or {}).items():
        require(launched[name] == count,
                f"{label}: {name} launched {launched[name]} times, not {count}")
    return {"fused_it_s": iters / fused_s, "plain_it_s": iters / plain_s,
            "route_err": route_err, "trace": hist.tolist()}


def lagged_run(torch, tt, wrappers, label, x, k, exact_trace, iters, card, needed):
    """MUR KL with objective='lagged' on the kernel route: its trace is the
    exact route's shifted by one iteration, and it launches ``needed``."""
    kw = dict(method="mur", distance_type="kl", min_iter=iters, max_iter=iters,
              objective="lagged")
    tt.NMF(x, k).factorize(**{**kw, "min_iter": 2, "max_iter": 2})
    before = counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tt.NMF(x, k).factorize(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for name in needed:
        require(counts(wrappers)[name] > before[name], f"{label}: {name} was not launched")
    lagged = np.asarray(res.obj_history, dtype=np.float64)
    exact = np.asarray(exact_trace)
    require(res.i == iters - 1 and len(lagged) == iters + 1,
            f"{label}: ran {res.i + 1} iterations, expected {iters}")
    require(np.all(np.isfinite(lagged)), f"{label}: non-finite objective")
    require(np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h)),
            f"{label}: non-finite factors")
    shift_err = float(np.max(np.abs(lagged[1:] - exact[:-1]) / np.abs(exact[:-1])))
    first_err = abs(lagged[0] - exact[0]) / abs(exact[0])
    print(f"  {label}: i={res.i} lagged[1:] vs exact[:-1] max rel {shift_err:.3e}, "
          f"lagged[0] vs exact[0] {first_err:.3e} (tol {LAGGED_RTOL:.0e}); "
          f"{iters / secs:.2f} it/s (wall clock over factorize(); {card})", flush=True)
    require(shift_err <= LAGGED_RTOL and first_err <= LAGGED_RTOL,
            f"{label}: the lagged trace is not the exact trace shifted by one")
    return {"fused_it_s": iters / secs, "shift_err": shift_err}


def switched_run(torch, tt, wrappers, label, x, k, ref_trace, rtol, exact, card, iters,
                 **kw):
    """One NMF run of `iters` iterations with a route switch flipped: it
    launches each kernel of ``exact`` exactly that many times, its trace is
    finite and non-increasing (EU), and its first iterations agree with
    ``ref_trace``, the default route's run from the same init, within rtol."""
    kw = dict(min_iter=iters, max_iter=iters, **kw)
    tt.NMF(x, k).factorize(**{**kw, "min_iter": 2, "max_iter": 2})
    before = counts(wrappers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tt.NMF(x, k).factorize(**kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {n: c - before[n] for n, c in counts(wrappers).items()}
    hist = np.asarray(res.obj_history, dtype=np.float64)
    ref = np.asarray(ref_trace)
    first = slice(0, ROUTE_ITERS + 1)
    err = float(np.max(np.abs(hist[first] - ref[first]) / np.abs(ref[first])))
    whole = float(np.max(np.abs(hist - ref) / np.abs(ref)))
    print(f"  {label}: i={res.i} obj[{iters}]={hist[-1]:.6e}; {iters / secs:.2f} it/s "
          f"(wall clock over factorize(), init included; {card}); first {ROUTE_ITERS} "
          f"iterations against the default route max rel {err:.3e} (tol {rtol:.0e}), "
          f"all {iters} {whole:.3e}; launches {launched}", flush=True)
    require(res.i == iters - 1 and len(hist) == iters + 1,
            f"{label}: ran {res.i + 1} iterations, expected {iters}")
    require(np.all(np.isfinite(hist)), f"{label}: non-finite objective")
    require(np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h)),
            f"{label}: non-finite factors")
    require(res.w.shape == (x.shape[0], k) and res.h.shape == (k, x.shape[1]),
            f"{label}: factor shapes {res.w.shape} {res.h.shape}")
    require(err <= rtol, f"{label}: the switched and default routes disagree "
                         f"({err:.3e} > {rtol:.0e})")
    rises = np.diff(hist) / hist[:-1]
    require(np.all(rises <= EU_MONOTONE_RTOL), f"{label}: EU objective rose by {rises.max():.3e}")
    for name, count in exact.items():
        require(launched[name] == count,
                f"{label}: {name} launched {launched[name]} times, not {count}")
    return {"fused_it_s": iters / secs, "route_err": err, "trace_err": whole}


def anls_run(torch, tt, counters, label, x, k, iters, card, w0, h0, plain=True, **kw):
    """ANLS, `iters` iterations from (w0, h0), on the kernel route and, with
    ``plain``, the plain route: it/s over factorize() (host clock with a
    synchronize, the init given), ms an iteration (from the ends of
    one-iteration blocks, the first iteration left out), the NNLS's trips
    per half-step and the final objective.  The kernel route launches its
    objective kernel once an iteration and nothing else, the plain route
    nothing; both give the same bits of W and H and the same trips."""
    from tpunmf_torch.nnls import trips

    dist = kw["distance_type"]
    obj = "kl_obj" if dist == "kl" else "eu_residual_obj"
    kw = dict(method="anls", min_iter=iters, max_iter=iters, w_init=w0, h_init=h0, **kw)
    if plain:  # warm-up: first-call costs stay out of timing
        for route in (True, False):
            tt.NMF(x, k).factorize(use_pallas=route, **{**kw, "min_iter": 2, "max_iter": 2})

    def one(route):
        model, stamps = tt.NMF(x, k), []
        trips.reset()
        before = counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = model.factorize(use_pallas=route, block_size=1,
                              on_block_end=lambda c: stamps.append(time.perf_counter()), **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {n: c - before[n] for n, c in counts(counters).items()}
        per = {name: n / max(trips.calls, 1) for name, n in trips.as_dict().items()
               if name != "calls"}
        return {"model": model, "res": res, "it_s": iters / secs,
                "ms_per_it": 1e3 * (stamps[-1] - stamps[0]) / (iters - 1),
                "trips": trips.as_dict(), "trips_per_half_step": per, "launched": launched}

    kern = one(True)
    res, hist = kern["res"], np.asarray(kern["res"].obj_history, dtype=np.float64)
    rises = np.diff(hist) / hist[:-1]
    out = {"it_s": kern["it_s"], "ms_per_it": kern["ms_per_it"],
           "trips_per_half_step": kern["trips_per_half_step"], "obj": float(hist[-1]),
           "max_rise": float(rises.max())}
    print(f"  {label}: i={res.i} obj[0]={hist[0]:.6e} obj[{iters}]={hist[-1]:.6e}; "
          f"{kern['it_s']:.2f} it/s over factorize(), {kern['ms_per_it']:.3f} ms an "
          f"iteration; NNLS trips per half-step "
          + ", ".join(f"{n} {v:.2f}" for n, v in kern["trips_per_half_step"].items())
          + f"; max rise {rises.max():.2e} ({card})", flush=True)
    require(res.i == iters - 1 and len(hist) == iters + 1,
            f"{label}: ran {res.i + 1} iterations, expected {iters}")
    require(np.all(np.isfinite(hist)) and np.all(np.isfinite(res.w))
            and np.all(np.isfinite(res.h)), f"{label}: non-finite factors or trace")
    require(res.w.min() >= 0 and res.h.min() >= 0, f"{label}: a negative factor")
    require(res.w.shape == (x.shape[0], k) and res.h.shape == (k, x.shape[1]),
            f"{label}: factor shapes {res.w.shape} {res.h.shape}")
    require(kern["launched"] == {n: iters if n == obj else 0 for n in counters},
            f"{label}: launches { {n: c for n, c in kern['launched'].items() if c} }, "
            f"not {iters} of {obj} alone")
    if dist == "eu" and kw.get("masked_solver", "chol") == "chol" and "nnls_solver" not in kw:
        require(rises.max() <= ANLS_MONOTONE_RTOL,
                f"{label}: EU objective rose by {rises.max():.3e}")
    if plain:
        pl = one(False)
        plain_hist = np.asarray(pl["res"].obj_history, dtype=np.float64)
        err = float(np.max(np.abs(hist - plain_hist) / np.abs(plain_hist)))
        same = (np.array_equal(res.w, pl["res"].w) and np.array_equal(res.h, pl["res"].h))
        out.update(plain_it_s=pl["it_s"], plain_ms_per_it=pl["ms_per_it"], route_err=err)
        print(f"  {label}: plain route {pl['it_s']:.2f} it/s, {pl['ms_per_it']:.3f} ms an "
              f"iteration; W, H {'the same bits' if same else 'DIFFER'}; traces max rel "
              f"{err:.3e} (tol {ANLS_TRACE_RTOL:.0e})", flush=True)
        require(not any(pl["launched"].values()), f"{label}: the plain route launched a kernel")
        require(same, f"{label}: the routes' factors differ")
        require(pl["trips"] == kern["trips"], f"{label}: the routes' NNLS trips differ")
        require(err <= ANLS_TRACE_RTOL, f"{label}: the routes' traces disagree ({err:.3e})")
    return out, kern["model"]


def anls_transforms(torch, tt, eu_model, kl_model, x, card):
    """NMF.transform with the trained W: EU on all of X fits at least as well
    as the fit (TRANSFORM_RTOL), KL on 256 columns is finite and >= 0, and
    inverse_transform gives X's shape."""
    from tpunmf_torch.core.precision import full_f32

    t0 = time.perf_counter()
    h_t = eu_model.transform(x)
    torch.cuda.synchronize()
    eu_s = time.perf_counter() - t0
    w = torch.as_tensor(eu_model.w, device=x.device)
    with full_f32():
        fit = 0.5 * float(torch.sum((x - w @ torch.as_tensor(eu_model.h, device=x.device))
                                    .double() ** 2))
        enc = 0.5 * float(torch.sum((x - w @ h_t).double() ** 2))
    t0 = time.perf_counter()
    h_kl = kl_model.transform(x[:, :256])
    torch.cuda.synchronize()
    kl_s = time.perf_counter() - t0
    rec = eu_model.inverse_transform(h_t)
    print(f"  ANLS transform: EU {tuple(h_t.shape)} in {1e3 * eu_s:.1f} ms, 0.5||X - W H_t||^2 "
          f"= {enc:.6e} against the fit's {fit:.6e} (rel {enc / fit - 1:+.2e}, tol "
          f"{TRANSFORM_RTOL:.0e}); KL on 256 columns in {1e3 * kl_s:.1f} ms; "
          f"inverse_transform {tuple(rec.shape)} ({card})", flush=True)
    require(h_t.is_cuda and h_t.shape == (eu_model.factors, x.shape[1])
            and bool(torch.isfinite(h_t).all()) and bool((h_t >= 0).all()),
            "ANLS transform: EU coefficients not finite, >= 0 and on the card")
    require(enc <= fit * (1 + TRANSFORM_RTOL), f"ANLS transform: EU {enc} > fit {fit}")
    require(h_kl.shape == (kl_model.factors, 256) and bool(torch.isfinite(h_kl).all())
            and bool((h_kl >= 0).all()), "ANLS transform: KL coefficients not finite, >= 0")
    require(rec.shape == x.shape, f"inverse_transform: shape {tuple(rec.shape)}")
    return {"eu_ms": 1e3 * eu_s, "kl_ms": 1e3 * kl_s, "rel_gap": enc / fit - 1}


def ao_admm_run(torch, tt, counters, label, x, k, iters, card, w0, h0, plain=True, **kw):
    """AO-ADMM, `iters` outer iterations from (w0, h0), on the kernel route
    and, with ``plain``, the plain route: it/s over factorize() (host clock
    with a synchronize, the init given), ms an outer iteration (from the
    ends of one-iteration blocks, the first left out), inner ADMM trips per
    H and per W subproblem (each one host read), the final objective and
    the peak device memory.  The kernel route launches its objective kernel
    once an iteration and nothing else, the plain route nothing; both give
    the same bits of W and H and the same trips, traces within
    OBJECTIVE_RTOL, and each route's final objective within OBJECTIVE_RTOL
    of the final (W, H)'s in float64.  One warm-up iteration a route comes
    first."""
    from tpunmf_torch.solvers.ao_admm import trips

    dist = kw["distance_type"]
    obj = "kl_obj" if dist == "kl" else "eu_residual_obj"
    kw = dict(method="ao_admm", min_iter=iters, max_iter=iters, w_init=w0, h_init=h0, **kw)
    routes = (True, False) if plain else (True,)
    for route in routes:
        tt.NMF(x, k).factorize(use_pallas=route, **{**kw, "min_iter": 1, "max_iter": 1})

    def one(route):
        stamps = []
        trips.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = counts(counters)
        t0 = time.perf_counter()
        res = tt.NMF(x, k).factorize(use_pallas=route, block_size=1,
                                     on_block_end=lambda c: stamps.append(time.perf_counter()),
                                     **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return {"res": res, "it_s": iters / secs,
                "ms_per_it": 1e3 * (stamps[-1] - stamps[0]) / (iters - 1),
                "trips": trips.as_dict(), "trips_per_subproblem": trips.per_subproblem(),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "launched": {n: c - before[n] for n, c in counts(counters).items()}}

    kern = one(True)
    res, hist = kern["res"], np.asarray(kern["res"].obj_history, dtype=np.float64)
    per = kern["trips_per_subproblem"]
    ref = objective_f64(torch, x, *(torch.from_numpy(np.ascontiguousarray(f)).to(x.device)
                                    for f in (res.w, res.h)), dist)
    ref_err = abs(hist[-1] / ref - 1)
    out = {"it_s": kern["it_s"], "ms_per_it": kern["ms_per_it"], "trips_per_subproblem": per,
           "obj": float(hist[-1]), "obj_f64": ref, "f64_err": ref_err,
           "peak_gib": kern["peak_gib"]}
    print(f"  {label}: i={res.i} obj[0]={hist[0]:.6e} obj[{iters}]={hist[-1]:.9e} (float64 "
          f"{ref:.9e}, rel {ref_err:.3e}); {kern['it_s']:.3f} it/s over factorize(), "
          f"{kern['ms_per_it']:.3f} ms an outer iteration; inner trips per H subproblem "
          f"{per['h']:.2f}, per W {per['w']:.2f}; peak {kern['peak_gib']:.2f} GiB allocated "
          f"({card})", flush=True)
    require(res.i == iters - 1 and len(hist) == iters + 1,
            f"{label}: ran {res.i + 1} iterations, expected {iters}")
    require(np.all(np.isfinite(hist)) and np.all(np.isfinite(res.w))
            and np.all(np.isfinite(res.h)), f"{label}: non-finite factors or trace")
    require(res.w.min() >= 0 and res.h.min() >= 0, f"{label}: a negative factor")
    require(res.w.shape == (x.shape[0], k) and res.h.shape == (k, x.shape[1]),
            f"{label}: factor shapes {res.w.shape} {res.h.shape}")
    require(kern["launched"] == {n: iters if n == obj else 0 for n in counters},
            f"{label}: launches { {n: c for n, c in kern['launched'].items() if c} }, "
            f"not {iters} of {obj} alone")
    require(ref_err <= OBJECTIVE_RTOL, f"{label}: the final objective is {ref_err:.3e} "
                                       f"off its float64 value")
    if plain:
        pl = one(False)
        plain_hist = np.asarray(pl["res"].obj_history, dtype=np.float64)
        err = float(np.max(np.abs(hist - plain_hist) / np.abs(plain_hist)))
        plain_ref_err = abs(plain_hist[-1] / ref - 1)
        same = (np.array_equal(res.w, pl["res"].w) and np.array_equal(res.h, pl["res"].h))
        out.update(plain_it_s=pl["it_s"], plain_ms_per_it=pl["ms_per_it"], route_err=err,
                   plain_f64_err=plain_ref_err, plain_peak_gib=pl["peak_gib"])
        print(f"  {label}: plain route {pl['it_s']:.3f} it/s, {pl['ms_per_it']:.3f} ms an "
              f"outer iteration, peak {pl['peak_gib']:.2f} GiB; W, H "
              f"{'the same bits' if same else 'DIFFER'}; traces max rel {err:.3e} "
              f"(tol {OBJECTIVE_RTOL:.0e}); final objective against float64 "
              f"{plain_ref_err:.3e}", flush=True)
        require(not any(pl["launched"].values()), f"{label}: the plain route launched a kernel")
        require(same, f"{label}: the routes' factors differ")
        require(pl["trips"] == kern["trips"], f"{label}: the routes' inner trips differ")
        require(err <= OBJECTIVE_RTOL, f"{label}: the routes' traces disagree ({err:.3e})")
        require(plain_ref_err <= OBJECTIVE_RTOL,
                f"{label}: the plain route's final objective is {plain_ref_err:.3e} off "
                f"its float64 value")
    return out


def objective_f64(torch, x, w, h, dist, rows=4096):
    """The objective of (W, H) on X in float64 on the card (core/losses.py's
    formulas), a block of rows at a time."""
    from tpunmf_torch.core.losses import distance

    hd = h.double()
    return sum(float(distance(x[r:r + rows].double(), w[r:r + rows].double() @ hd, dist))
               for r in range(0, x.shape[0], rows))


# every kernel route that updates the iterate against float64 (faults 3.5
# and 3.7): 50 iterations, the exact objective, every f32 trace held to the
# float64 plain route's from the same init
F64_ITERS = 50
F64_TOL = 1e-5
# where the plain f32 route is itself farther than this from float64, the
# kernel route's gate is twice the plain route's distance
F64_PLAIN_FLOOR = 5e-6
# the masked cases' kernel route is also held within this many times the
# plain f32 route's distance (fault 3.7): on an H100 it sat 0.96-1.96
# times it with the W pass's sums rounded every step, 2.2-4.0 times with
# the tensor cores' own sums in both passes, and 1.29-5.25 times (3.39 and
# 5.25 in two of the four cases) with those in the W pass alone
F64_NEAR_PLAIN = 2.5
# the masked cases' second X: phase 6's KL 8192x4096 (KL_SINGLE) with the
# bench's 25% mask (tpunmf_torch/bench.py's bench_solver_rates)
F64_MASK_DENSITY, F64_MASK_SEED = 0.25, 2


def f64_case(key, label, fit, x, k, init, needed, banned=(), gated=True, ref=None,
             within=contextlib.nullcontext, near_plain=None):
    """One case of route_f64_phase: ``fit(x, k, **kw)`` runs the solver on
    X from ``init`` (W0, H0); its kernel route must launch every kernel of
    ``needed`` and none of ``banned``, inside ``within()`` (a route's
    switch); the cases of one ``ref`` (one solver, X and init) share their
    float64 and plain f32 runs; ``near_plain`` also holds the kernel
    route within that many times the plain f32 route's distance.  A
    ``gated`` case that misses its gate fails the phase; another is
    printed and recorded."""
    return dict(key=key, label=label, fit=fit, x=x, k=k, init=init, needed=needed,
                banned=banned, gated=gated, ref=ref or key, within=within,
                near_plain=near_plain)


def kl_f64_cases(torch, eu_x, eu_init, kl_x, kl2_x):
    """MUR KL at three shapes (fault 3.5): 8192^2 r128 from its NNDSVD
    'zero' (given, as the paths computed it); KL 8192x4096 r128 and
    BASELINE config[1] from random_init(0), each on the route mur_route
    gives it."""
    import functools

    from tpunmf_torch.init import random_init
    from tpunmf_torch.solvers import mur
    from tpunmf_torch.solvers.mur import mur_route

    fit = functools.partial(mur, distance_type="kl")
    cases = []
    for key, label, x, k, init in (
            ("kl-8192sq", f"8192^2 r{eu_init[0].shape[1]} NNDSVD 'zero'", eu_x,
             eu_init[0].shape[1], eu_init),
            ("kl-8192x4096", f"{tuple(kl2_x.shape)} r{KL_SINGLE['k']}", kl2_x,
             KL_SINGLE["k"], None),
            ("kl-config1", f"config[1] {tuple(kl_x.shape)} r50", kl_x, 50, None)):
        init = init or random_init(0, *x.shape, k, device=x.device)
        single = mur_route(x, k, "kl")[0] == "single"
        cases.append(f64_case(key, "MUR KL " + label, fit, x, k, init,
                              (("mur_iteration_kl",) if single else PAIR) + ("kl_obj",),
                              PAIR if single else ("mur_iteration_kl",)))
    return cases


def eu_f64_cases(torch, eu_x, eu_init, hals_init):
    """MUR EU and HALS at 8192^2 r128 (lowrank_dense seed 0) from its NNDSVD
    'zero' (HALS's nudged to 1e-16, as hals() nudges the inits it makes),
    on each route: MUR's single pass ("auto", tpunmf's rule), the 2-pass
    pair and the "dma" single pass; HALS's gs_sweep and its single pass.
    The two switched routes, off by default, are not gated."""
    import functools

    from tpunmf_torch.solvers import hals, mur

    k = eu_init[0].shape[1]
    mur_eu = functools.partial(mur, distance_type="eu")
    hals2 = functools.partial(hals, inner_sweeps=2)
    shape = f"8192^2 r{k} NNDSVD 'zero'"
    return [
        f64_case("mur-eu", f"MUR EU f32 single pass {shape}", mur_eu, eu_x, k, eu_init,
                 SINGLE_EU, PAIR + OPT_IN),
        f64_case("mur-eu-pair", f"MUR EU f32 2-pass pair {shape}", mur_eu, eu_x, k, eu_init,
                 PAIR + ("eu_residual_obj",), ("mur_iteration_eu",) + OPT_IN, ref="mur-eu",
                 within=two_pass_route),
        f64_case("mur-eu-dma", f"MUR EU f32 dma {shape}", mur_eu, eu_x, k, eu_init,
                 ("mur_iteration_eu_dma", "eu_residual_obj"), ("mur_iteration_eu",) + PAIR,
                 gated=False, ref="mur-eu",
                 within=lambda: switched(mur_single_pass_variant="dma")),
        f64_case("hals", f"HALS EU f32 gs_sweep, inner_sweeps=2, {shape}", hals2, eu_x, k,
                 hals_init, ("gs_sweep", "eu_residual_obj"), OPT_IN),
        f64_case("hals-single", f"HALS EU f32 single pass, inner_sweeps=2, {shape}", hals2,
                 eu_x, k, hals_init, ("hals_iteration_eu", "eu_residual_obj"), gated=False,
                 ref="hals", within=lambda: switched(hals_single_pass=True))]


def masked_f64_cases(torch, key, label, x, mask, k):
    """Masked MUR EU and KL (fault 3.7) on X with a boolean mask, from
    random_init(0) (phase 10's masked init), each also held within
    F64_NEAR_PLAIN times the plain f32 route's distance."""
    import functools

    from tpunmf_torch.init import random_init
    from tpunmf_torch.solvers import mur_masked

    def fit(x, k, dist, **kw):
        return mur_masked(x, mask, k, distance_type=dist, **kw)

    init = random_init(0, *x.shape, k, device=x.device)
    return [f64_case(f"masked-{dist}-{key}", f"masked MUR {dist.upper()} {label} r{k}",
                     functools.partial(fit, dist=dist), x, k, init,
                     ("masked_w_update", "masked_h_update"), near_plain=F64_NEAR_PLAIN)
            for dist in ("eu", "kl")]


def f64_mask(torch, x):
    """The F64_MASK_DENSITY share of X's cells, drawn on the card from
    F64_MASK_SEED."""
    g = torch.Generator(device=x.device)
    g.manual_seed(F64_MASK_SEED)
    return torch.rand(x.shape, generator=g, device=x.device) < F64_MASK_DENSITY


def f64_mask_label(x):
    return (f"{tuple(x.shape)} tfidf_like seed {KL_SINGLE['seed']}, "
            f"{F64_MASK_DENSITY:.0%} observed")


def route_f64_phase(torch, counters, cases, card, gate=True):
    """Each case F64_ITERS iterations from its init three ways: the plain
    route in float64 on the card (X and the init upcast), the plain route
    in f32 and the kernel route in f32 (after a 2-iteration warm-up of each
    f32 route).  Prints each f32 trace's largest relative distance from the
    float64 trace, the gate, the it/s of both f32 routes over the solver
    call and the kernels the kernel route launched; the plain routes must
    launch none.  With ``gate``, a gated case's kernel route must stay
    within F64_TOL of float64 at every iteration (twice the plain route's
    distance where that exceeds F64_PLAIN_FLOOR), and within its
    ``near_plain`` times the plain route's distance where it has one."""
    kw = dict(min_iter=F64_ITERS, max_iter=F64_ITERS, tol1=0.0, tol2=0.0)

    def timed(fit, x, k, w0, h0, use_pallas):
        fit(x, k, w_init=w0, h_init=h0, use_pallas=use_pallas,
            **{**kw, "min_iter": 2, "max_iter": 2})  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(x, k, w_init=w0, h_init=h0, use_pallas=use_pallas, **kw)
        return (np.asarray(res.obj_history, dtype=np.float64),
                F64_ITERS / (time.perf_counter() - t0))

    out, refs = {}, {}
    for c in cases:
        label, fit, x, k, (w0, h0) = c["label"], c["fit"], c["x"], c["k"], c["init"]
        if c["ref"] not in refs:
            before = counts(counters)
            ref = fit(x.double(), k, w_init=w0.double(), h_init=h0.double(), use_pallas=False,
                      **kw)
            want = np.asarray(ref.obj_history, dtype=np.float64)
            del ref
            torch.cuda.empty_cache()
            plain, plain_it_s = timed(fit, x, k, w0, h0, False)
            require(counts(counters) == before, f"{label}: a plain route launched a kernel")
            refs[c["ref"]] = want, plain, plain_it_s
        want, plain, plain_it_s = refs[c["ref"]]
        with c["within"]():
            before = counts(counters)
            got, it_s = timed(fit, x, k, w0, h0, True)
            launched = {n: v - before[n] for n, v in counts(counters).items() if v > before[n]}
        dist = {}
        for name, trace in (("plain f32", plain), ("kernels f32", got)):
            require(trace.shape == want.shape and np.all(np.isfinite(trace)),
                    f"{label}: the {name} trace")
            dist[name] = float(np.max(np.abs(trace - want) / np.abs(want)))
        tol = F64_TOL if dist["plain f32"] <= F64_PLAIN_FLOOR else 2.0 * dist["plain f32"]
        rule = ("1e-5" if tol == F64_TOL
                else f"twice the plain route's distance, {tol:.3e}")
        held = dist["kernels f32"] <= tol
        ratio = dist["kernels f32"] / dist["plain f32"] if dist["plain f32"] else np.inf
        if c["near_plain"] is not None:
            rule += (f", and {ratio:.2f} times the plain route's distance within "
                     f"{c['near_plain']:g}")
            held = held and ratio <= c["near_plain"]
        print(f"  {label}, {F64_ITERS} iterations against float64: plain f32 "
              f"{dist['plain f32']:.3e}, kernels f32 {dist['kernels f32']:.3e}; gate {rule}"
              f"{'' if c['gated'] else ' (not gated: off by default)'}: "
              f"{'held' if held else 'MISSED'}; {it_s:.2f} it/s on the kernels, "
              f"{plain_it_s:.2f} plain (over the solver, init given); launches {launched} "
              f"[{card}]", flush=True)
        for name in c["needed"]:
            require(launched.get(name, 0) > 0, f"{label}: {name} was not launched")
        for name in c["banned"]:
            require(name not in launched, f"{label}: {name} was launched off its route")
        if gate and c["gated"]:
            require(held, f"{label}: the kernel route is {dist['kernels f32']:.3e} off "
                          f"float64 ({ratio:.2f} times the plain route's distance), "
                          f"gate {rule}")
        out[label] = {"key": c["key"], "plain_f32": dist["plain f32"],
                      "kernels_f32": dist["kernels f32"], "gate": tol, "gated": c["gated"],
                      "near_plain": c["near_plain"],
                      "ratio": ratio if np.isfinite(ratio) else None, "held": held,
                      "it_s": it_s, "plain_it_s": plain_it_s, "launches": launched}
        torch.cuda.empty_cache()
    return out


def config4_on_card(torch):
    """One card's cut of BASELINE config[4]'s matrix: lowrank_dense's recipe
    at seed 4 (the planted factors drawn from numpy's default_rng(4)), with
    X = W H + 0.01 U formed in float32 on the card and U from a seeded CUDA
    generator, where lowrank_dense forms it in float64 on the host (8 GB at
    this shape): not lowrank_dense's bits."""
    m, n, k = CONFIG4["m"], CONFIG4["n"], CONFIG4["k"]
    rng = np.random.default_rng(CONFIG4["seed"])
    w = torch.from_numpy(rng.random((m, k))).cuda().float()
    h = torch.from_numpy(rng.random((k, n))).cuda().float()
    x = w @ h  # TF32 is off in this script
    del w, h
    gen = torch.Generator(device="cuda").manual_seed(CONFIG4["seed"])
    x.add_(torch.rand((m, n), generator=gen, device="cuda"), alpha=0.01)
    return x


@contextlib.contextmanager
def nnls_ranges():
    """Profiler ranges named 'nnls' around ANLS's NNLS calls (this script's
    instrumentation: the solver has none)."""
    import importlib

    from torch.profiler import record_function

    mod = importlib.import_module("tpunmf_torch.solvers.anls")
    saved = mod.nnls_activeset, mod.nnls_bpp

    def ranged(fn):
        def run(*a, **kw):
            with record_function(NNLS_RANGE):
                return fn(*a, **kw)
        return run

    mod.nnls_activeset, mod.nnls_bpp = ranged(saved[0]), ranged(saved[1])
    try:
        yield
    finally:
        mod.nnls_activeset, mod.nnls_bpp = saved


def device_ms_by_kernel(prof, per):
    """Device ms by kernel in a profile, over ``per`` iterations or
    requests; cuBLAS's products under one name."""
    import re

    from torch.autograd import DeviceType

    kernels = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        # a range of nnls_ranges() shows on the device's track too: not a kernel
        if e.device_type == DeviceType.CUDA and us > 0 and e.key != NNLS_RANGE:
            name = re.sub(r"^(void )?([\w:]+::)?(\(anonymous namespace\)::)?", "", e.key)
            name = re.split(r"[<(]", name)[0]
            if "gemm" in e.key.lower() or "splitK" in e.key:
                name = "cuBLAS GEMM"
            kernels[name] = kernels.get(name, 0.0) + us / 1e3 / per
    return kernels


def profile_run(torch, tt, label, x, k, distance, iters=None, plain=False, method="mur",
                **extra):
    """Device time by kernel over one factorize() of `iters` iterations
    (PROFILE_ITERS by default; torch.profiler; the kernels run on one
    stream, so their sum is their union), it/s in that window, and the device's idle share of its host
    wall time (an upper bound: the profiler's own overhead is inside)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iters = iters or PROFILE_ITERS
    kw = dict(method=method, min_iter=iters, max_iter=iters, **extra)
    if method == "mur":
        kw["distance_type"] = distance
    if plain:
        kw["use_pallas"] = False
    tt.NMF(x, k).factorize(**{**kw, "min_iter": 2, "max_iter": 2})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tt.NMF(x, k).factorize(**kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_ms_by_kernel(prof, iters)
    device = sum(kernels.values())
    out = {"device_ms_per_it": device, "wall_ms_per_it": 1e3 * wall / iters,
           "it_s": iters / wall, "idle_share": 1.0 - device * iters / (1e3 * wall),
           "kernels_ms_per_it": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])}
    ranges = [e for e in prof.key_averages()
              if e.key == NNLS_RANGE and e.device_type != DeviceType.CUDA]
    nnls = ""
    if ranges:  # nnls_ranges(): host and device ms inside the NNLS calls
        e = ranges[0]
        out["nnls_wall_ms_per_it"] = e.cpu_time_total / 1e3 / iters
        out["nnls_device_ms_per_it"] = getattr(e, "device_time_total", 0) / 1e3 / iters
        out["nnls_share"] = out["nnls_wall_ms_per_it"] / out["wall_ms_per_it"]
        nnls = (f"; NNLS {out['nnls_wall_ms_per_it']:.3f} ms/it on the host clock "
                f"({out['nnls_share']:.3f} of the wall), "
                f"{out['nnls_device_ms_per_it']:.3f} on the device")
    print(f"  profile {label}: {out['device_ms_per_it']:.3f} ms/it on the device, "
          f"{out['it_s']:.1f} it/s, idle share {out['idle_share']:.3f}; "
          + ", ".join(f"{n} {v:.3f}" for n, v in out["kernels_ms_per_it"].items()) + nnls,
          flush=True)
    return out


def movielens_on_card(torch, n_users, n_items, density, seed, n_factors=8):
    """movielens_like's recipe (tpunmf_torch/data/synthetic.py) with the
    m x n work on the card: the planted gamma factors from numpy, the
    scores in f32 and the observed support from a seeded CUDA generator
    (numpy at f64 would need about 20 GB of host memory at MovieLens-10M).
    Returns X (f32, ratings 1..5 on the support, 0 elsewhere) and the
    observed mask."""
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.gamma(2.0, 1.0, (n_users, n_factors))).float().cuda()
    v = torch.from_numpy(rng.gamma(2.0, 1.0, (n_factors, n_items))).float().cuda()
    x = u @ v
    lo, hi = x.min(), x.max()
    x.sub_(lo).mul_(4.0 / (hi - lo + 1e-9)).add_(1.0).round_()
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    observed = torch.rand((n_users, n_items), generator=g, device="cuda") < density
    x.mul_(observed)
    return x, observed


@contextlib.contextmanager
def two_pass_route():
    """MUR with tpunmf's single-pass rule turned off: every shape takes the
    2-pass pair (for comparing the two routes at one shape)."""
    mur = sys.modules["tpunmf_torch.solvers.mur"]
    saved = mur.iter_eu_tileable, mur.iter_kl_tileable
    mur.iter_eu_tileable = mur.iter_kl_tileable = lambda x, k: None
    try:
        yield
    finally:
        mur.iter_eu_tileable, mur.iter_kl_tileable = saved


@contextlib.contextmanager
def switched(**values):
    """The port's route switches (tpunmf_torch/solvers/cuda_defaults.py) set
    to ``values``, e.g. hals_single_pass=True, and restored after."""
    from tpunmf_torch.solvers import cuda_defaults

    saved = {name: getattr(cuda_defaults, name) for name in values}
    for name, value in values.items():
        setattr(cuda_defaults, name, lambda device, v=value: v)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(cuda_defaults, name, fn)


@contextlib.contextmanager
def plain_serving():
    """The serving code with the kernels' plain versions in their place:
    the plain route that the kernel route is compared with."""
    from tpunmf_torch.ops import topk_select as ts
    from tpunmf_torch.serve import topk

    saved = topk.blockmax_relayout, topk.score_blockmax_relayout
    topk.blockmax_relayout = ts.blockmax_relayout_ref
    topk.score_blockmax_relayout = ts.score_blockmax_relayout_ref
    try:
        yield
    finally:
        topk.blockmax_relayout, topk.score_blockmax_relayout = saved


def serving_data(torch, r, n, seed, exclusion=False):
    """W for SERVE_BATCHES batches of SERVE_BATCH users and H, U[0,1) from a
    seeded CUDA generator (bench.py's serving cells draw the same
    distribution); with ``exclusion`` 1% of the items of every user."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    users = torch.rand((SERVE_BATCHES * SERVE_BATCH, r), generator=g, device="cuda")
    h = torch.rand((r, n), generator=g, device="cuda")
    excl = None
    if exclusion:
        excl = torch.rand((SERVE_BATCHES * SERVE_BATCH, n), generator=g,
                          device="cuda") < 0.01
    return users, h, excl


def serve_batches(torch, request):
    """request(i) for every batch after two warm-up calls: the answers and
    each batch's latency in ms (CUDA events around the request; the
    request's own host read of its acceptance check is inside)."""
    request(0)
    request(1)
    answers, ms = [], []
    for i in range(SERVE_BATCHES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        answers.append(request(i))
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    return answers, ms


def serving_profile(torch, request, requests=10):
    """Device and wall ms per request over ``requests`` requests
    (torch.profiler's kernel time, and the host clock around them with a
    synchronize at the end: an upper bound, the profiler's overhead is
    inside), the device's idle share of that wall time, and the three
    kernels that take the most device time, ms per request."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(requests):
            request(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = device_ms_by_kernel(prof, requests)
    device_ms, wall_ms = sum(kernels.values()), 1e3 * wall / requests
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:3])
    return device_ms, wall_ms, 1.0 - device_ms / wall_ms, top


def serving_mode(torch, label, request):
    """One serving mode on the kernel route and on the plain route, CUDA
    events around each request."""
    kernel_answers, kernel_ms = serve_batches(torch, request)
    with plain_serving():
        plain_answers, plain_ms = serve_batches(torch, request)
    worst = 0.0
    for (kv, _), (pv, _) in zip(kernel_answers, plain_answers):
        worst = max(worst, float(((kv.double() - pv.double()).abs()
                                  / pv.double().abs()).max()))
    same_idx = float(np.mean([float((ki == pi).float().mean()) for (_, ki), (_, pi)
                              in zip(kernel_answers, plain_answers)]))
    out = {"batch_ms": float(np.mean(kernel_ms)), "plain_batch_ms": float(np.mean(plain_ms)),
           "batch_ms_max": float(np.max(kernel_ms)),
           "qps": SERVE_BATCH * 1e3 / float(np.mean(kernel_ms)),
           "plain_qps": SERVE_BATCH * 1e3 / float(np.mean(plain_ms)),
           "value_err": worst, "same_indices": same_idx}
    print(f"  {label}: kernel route {out['batch_ms']:.4f} ms/batch "
          f"({out['qps']:.0f} QPS), plain route {out['plain_batch_ms']:.4f} ms/batch "
          f"({out['plain_qps']:.0f} QPS); values kernel vs plain max rel {worst:.3e} "
          f"(tol {SERVE_VALUE_RTOL:.0e}), same indices {same_idx:.4f}", flush=True)
    require(worst <= SERVE_VALUE_RTOL, f"{label}: kernel and plain routes disagree")
    for v, i in kernel_answers + plain_answers:
        require(v.shape == (SERVE_BATCH, SERVE_K) and i.dtype == torch.int64,
                f"{label}: answer of shape {tuple(v.shape)}, {i.dtype}")
        require(bool(torch.isfinite(v).all()), f"{label}: non-finite top-k values")
    return out, kernel_answers, plain_answers


def check_own_scores(torch, label, answers, scores_of, batches=2, candidates=None):
    """Each of the first ``batches`` answers equals a stable sort of the
    scores its route ranked: all n of them, or the (b, c) rescored
    candidates ``candidates(i)`` gives with ``scores_of(i)`` (ties then go
    to the earlier candidate, as tpunmf's rerank orders them)."""
    from tpunmf_torch.serve import topk

    for i in range(batches):
        v, idx = topk._topk(scores_of(i), SERVE_K)
        if candidates is not None:
            idx = torch.gather(candidates(i), 1, idx)
        bad = int((v != answers[i][0]).sum() + (idx != answers[i][1]).sum())
        require(bad == 0, f"{label}: batch {i} is not the top-k of its own scores "
                          f"({bad} of {2 * v.numel()} entries differ)")


def serving_path(torch, runs):
    """The serving cells; returns what check_serving needs afterwards (the
    checks launch kernels, which must not count toward the path)."""
    from tpunmf_torch.serve import topk

    kept = {}
    users, h, excl = serving_data(torch, 128, 1 << 20, seed=21, exclusion=True)
    hq = h.to(torch.bfloat16)  # the stored low-precision copy
    batch = lambda i: users[i * SERVE_BATCH:(i + 1) * SERVE_BATCH]
    modes = {
        "serve exact r128": lambda i: topk.topk_scores_dense(batch(i), h, SERVE_K),
        "serve bf16 r128": lambda i: topk.topk_retrieval(
            None, batch(i), h, SERVE_K, first_stage_dtype="bf16", h_quantized=hq,
            oversample=2),
        "serve exclude r128": lambda i: topk.topk_retrieval(
            None, batch(i), h, SERVE_K,
            exclude=excl[i * SERVE_BATCH:(i + 1) * SERVE_BATCH]),
    }
    users512, h512, _ = serving_data(torch, 512, 1 << 19, seed=22)
    batch512 = lambda i: users512[i * SERVE_BATCH:(i + 1) * SERVE_BATCH]
    modes["serve exact r512"] = lambda i: topk.topk_scores_dense(batch512(i), h512, SERVE_K)
    for label, request in modes.items():
        runs[label], kernel, plain = serving_mode(torch, label, request)
        kept[label] = (kernel, plain)
    kept["r128"] = (batch, h, hq, excl)
    kept["r512"] = (batch512, h512)
    kept["requests"] = modes
    return kept


def profile_serving(torch, runs, requests):
    """Each serving mode's device and wall ms per request on both routes
    (serving_profile), after the serving path's counts were read: the
    profiled requests are not the path's."""
    for label, request in requests.items():
        kernel = serving_profile(torch, request)
        with plain_serving():
            plain = serving_profile(torch, request)
        runs[label].update(device_ms=kernel[0], wall_ms=kernel[1], idle_share=kernel[2],
                           kernels_ms=kernel[3], plain_device_ms=plain[0],
                           plain_wall_ms=plain[1], plain_idle_share=plain[2],
                           plain_kernels_ms=plain[3])
        for route, p in (("kernel", kernel), ("plain", plain)):
            print(f"  {label}: profiled {route} route, ms per request device / wall "
                  f"{p[0]:.4f} / {p[1]:.4f} (idle {p[2]:.3f}); "
                  + ", ".join(f"{n} {v:.4f}" for n, v in p[3].items()), flush=True)


def check_serving(torch, runs, kept):
    """Every serving answer against its own scores (the kernel route's
    rebuilt from the kernel's s3), and the quantized route's recall@100
    against the exact route."""
    from tpunmf_torch.ops import topk_select as ts
    from tpunmf_torch.serve import topk

    batch, h, hq, excl = kept["r128"]
    batch512, h512 = kept["r512"]

    def from_s3(w, hh):
        return ts.score_blockmax_relayout(w, hh)[1].reshape(w.shape[0], -1)[:, :hh.shape[1]]

    for label, bt, hh in (("serve exact r128", batch, h), ("serve exact r512", batch512, h512)):
        kernel, plain = kept[label]
        check_own_scores(torch, label + " kernel", kernel, lambda i: from_s3(bt(i), hh))
        check_own_scores(torch, label + " plain", plain, lambda i: topk._score(bt(i), hh))
    kernel, plain = kept["serve exclude r128"]
    masked = lambda i: torch.where(excl[i * SERVE_BATCH:(i + 1) * SERVE_BATCH], -torch.inf,
                                   topk._score(batch(i), h))
    check_own_scores(torch, "serve exclude r128 kernel", kernel, masked)
    check_own_scores(torch, "serve exclude r128 plain", plain, masked)
    for i in range(SERVE_BATCHES):
        taken = torch.gather(excl[i * SERVE_BATCH:(i + 1) * SERVE_BATCH], 1, kernel[i][1])
        require(not bool(taken.any()), "serve exclude r128: an excluded item was served")

    # quantized: the candidates are the top 2k of the first stage's own
    # scores, reranked by the exact rescore of those candidates
    kernel, plain = kept["serve bf16 r128"]
    for route, answers, stage in (("kernel", kernel, lambda w: from_s3(w, hq)),
                                  ("plain", plain, lambda w: topk._score(w, hq))):
        def cands(i, stage=stage):
            return topk._topk(stage(batch(i).to(torch.bfloat16)), 2 * SERVE_K)[1]

        def rescored(i):
            return torch.bmm(h.T[cands(i)], batch(i)[:, :, None])[:, :, 0]
        check_own_scores(torch, f"serve bf16 r128 {route}", answers, rescored,
                         candidates=cands)
    exact_kernel = kept["serve exact r128"][0]
    recall = float(np.mean([topk.recall_at_k(q[1], e[1]) for q, e in zip(kernel, exact_kernel)]))
    runs["serve bf16 r128"]["recall_at_100"] = recall
    print(f"  serve bf16 r128: recall@{SERVE_K} against the exact route {recall:.4f}; "
          f"every answer is the top-k of its own scores", flush=True)


def config3_on_card(torch):
    """BASELINE config[3]'s matrix, made on the host with the seed's draws
    and densified to float32 on the card; and its CSR (phase 8 streams it)."""
    from tpunmf_torch.data import densify, sparse_csr

    csr = sparse_csr(CONFIG3["m"], CONFIG3["n"], density=CONFIG3["density"],
                     k=CONFIG3["k"], seed=CONFIG3["seed"])
    x = torch.from_numpy(densify(csr)).cuda()
    return x, csr


def roundtrip_phase(tt, x, k, **kw):
    model = tt.NMF(x, k)
    model.factorize(min_iter=3, max_iter=3, **kw)
    with tempfile.TemporaryDirectory() as d:
        path = model.save_factorization(save_dir=d)
        loaded = tt.NMF.load_factorization(path)
    require(np.array_equal(loaded.w, model.w) and np.array_equal(loaded.h, model.h),
            "save/load: factors differ")
    require(loaded.results.i == model.results.i, "save/load: i differs")
    require(np.array_equal(np.asarray(loaded.results.obj_history),
                           np.asarray(model.results.obj_history)),
            "save/load: obj_history differs")
    require(loaded.default_save_name() == model.default_save_name(),
            "save/load: save name differs")
    print(f"  save/load round trip ok: {os.path.basename(path)}", flush=True)


# Phase 5: the tooling's paths on the card.  Checkpoint/resume at full width
# must give the uninterrupted run's bits (the kernels sum in a fixed order)
CKPT_RUNS = (("MUR EU", dict(method="mur", distance_type="eu"), 60, 20),
             ("ADMM EU adaptive", dict(method="admm", distance_type="eu",
                                       rho_mode="adaptive", **ADMM_KW), 30, 10))
# the lambda grid against sequential kernel-route runs from the same init:
# the grid's products are cuBLAS's (TF32 off), the runs' the kernels'
GRID_RTOL = 1e-4
GRID_LAMBDAS = (0.0, 0.1, 1.0)
GRID_ITERS, GRID_KL_ITERS = 50, 20
# rank_scan's planted problem: each of X's 4096 columns dominated by one of
# 16 components
SCAN = dict(m=8192, n=4096, k=16, ks=(8, 16, 24), seeds=8, iters=100)
# the sklearn estimator at BASELINE config[2]'s stand-in (movielens_like,
# density 0.2, seed 2), and 512 new rows to transform
SKLEARN = dict(m=6040, n=3706, k=64, new=512, iters=50)
# beta = 1 and 2 against MUR KL and EU from one init on MUR's plain route
# (the same f32 products on cuBLAS, the eps guards in other places,
# tpunmf/solvers/beta.py:15-18) and on its kernel route, whose KL numerators
# round their sums (fault 3.5, phase 6)
BETA_RTOL = 1e-4
BETA_ITERS = 50


class _Stop(Exception):
    pass


@contextlib.contextmanager
def timed_saves(torch, log):
    """Time each checkpoint save of the runs inside (the device is
    synchronised first, so the time is the copy to the host and the
    write), with the bytes written."""
    from tpunmf_torch.io import checkpoint

    save = checkpoint.save_state

    def timed(path, carry, meta=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final = save(path, carry, meta=meta)
        log.append((1e3 * (time.perf_counter() - t0), os.path.getsize(final)))
        return final

    checkpoint.save_state = timed
    try:
        yield log
    finally:
        checkpoint.save_state = save


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def checkpoint_path_run(torch, tt, card, x, k, init, d):
    """Each run of CKPT_RUNS uninterrupted, then stopped after two blocks
    and resumed: the resumed run's W, H, i and trace are the uninterrupted
    run's bits."""
    out = {}
    for label, kw, iters, every in CKPT_RUNS:
        kw = dict(kw, min_iter=iters, max_iter=iters, tol1=0.0, tol2=0.0,
                  w_init=init[0], h_init=init[1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = tt.NMF(x, k).factorize(**kw)
        full_s = time.perf_counter() - t0
        path = os.path.join(d, label.replace(" ", "_"))
        blocks = []

        def stop(carry):
            blocks.append(carry.i)
            if len(blocks) == 2:
                raise _Stop

        saves = []
        with timed_saves(torch, saves):
            try:
                tt.NMF(x, k).factorize(checkpoint_path=path, checkpoint_every=every,
                                       on_block_end=stop, **kw)
            except _Stop:
                pass
            require(blocks == [every, 2 * every], f"{label}: blocks ended at {blocks}")
            res = tt.NMF(x, k).factorize(checkpoint_path=path, checkpoint_every=every,
                                         resume=True, **kw)
        require(res.i == full.i == iters - 1, f"{label}: i {res.i} / {full.i}")
        for name in ("w", "h", "obj_history"):
            require(same_bits(getattr(res, name), getattr(full, name)),
                    f"{label}: the resumed run's {name} is not the uninterrupted run's")
        ms = [s for s, _ in saves]
        out[label] = {"iterations": iters, "checkpoint_every": every, "saves": len(saves),
                      "save_ms": ms, "save_bytes": saves[0][1],
                      "uninterrupted_s": full_s,
                      "final_objective": float(full.obj_history[-1])}
        print(f"  checkpoint {label} {tuple(x.shape)} k{k}: resumed after 2 blocks of "
              f"{every} = the uninterrupted {iters} iterations bit for bit (W, H, i, "
              f"trace); {len(saves)} saves of {saves[0][1]} bytes, "
              f"{min(ms):.2f}-{max(ms):.2f} ms each (mean {np.mean(ms):.2f}) [{card}]",
              flush=True)
    return out


def lambda_grid_run(torch, tt, card, label, x, k, dist, lambdas, iters, init):
    """mur_lambda_grid against one sequential kernel-route run of each
    combination from the same init; combination-iterations a second."""
    from tpunmf_torch.experiments import mur_lambda_grid

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    combos, ws, hs, objs = mur_lambda_grid(x, k, lambda_w=lambdas, lambda_h=lambdas,
                                           distance_type=dist, n_iter=iters,
                                           w_init=init[0], h_init=init[1])
    objs = objs.cpu().numpy().astype(np.float64)
    grid_s = time.perf_counter() - t0
    require(np.all(np.isfinite(objs)), f"{label}: non-finite grid objective")
    seq_s, worst = 0.0, 0.0
    for b, (lw, lh) in enumerate(combos):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = tt.NMF(x, k).factorize(method="mur", distance_type=dist, lambda_w=lw,
                                     lambda_h=lh, w_init=init[0], h_init=init[1],
                                     min_iter=iters, max_iter=iters, tol1=0.0, tol2=0.0,
                                     objective="exact")
        seq_s += time.perf_counter() - t0
        want = np.asarray(ref.obj_history[1:], dtype=np.float64)
        err = float(np.max(np.abs(objs[b] - want) / np.abs(want)))
        worst = max(worst, err)
        require(err <= GRID_RTOL, f"{label} ({lw}, {lh}): trace off the sequential run "
                                  f"by {err:.3e} > {GRID_RTOL}")
    n = len(combos) * iters
    line = {"combinations": len(combos), "iterations": iters, "grid_s": grid_s,
            "sequential_s": seq_s, "grid_comb_it_s": n / grid_s,
            "sequential_comb_it_s": n / seq_s, "max_rel_err": worst}
    print(f"  {label}: {len(combos)} combinations x {iters} iterations, traces within "
          f"{worst:.3e} of the sequential kernel-route runs; grid "
          f"{line['grid_comb_it_s']:.1f} combination-iterations/s, sequential "
          f"{line['sequential_comb_it_s']:.1f} [{card}]", flush=True)
    return line


def planted_x(torch, m, n, k, seed, device):
    """X = W H with column j of H dominated by component j % k."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    w = torch.rand((m, k), generator=g, device=device) + 0.1
    h = 0.02 * torch.rand((k, n), generator=g, device=device)
    cols = torch.arange(n, device=device)
    h[cols % k, cols] += 1.0
    return w @ h


def tooling_phase(torch, tt, drive, card, eu_np, eu_x, eu_init, hals_init, kl2_x):
    """Phase 5: checkpoint/resume, the lambda grid, the rank scan, the
    beta-divergence MUR, the sklearn estimator, the CLI in a subprocess,
    and the profiling aids, each path's kernel launches counted."""
    from tpunmf_torch.data import movielens_like
    from tpunmf_torch.experiments import rank_scan
    from tpunmf_torch.init import random_init
    from tpunmf_torch.sklearn_api import NMF as SkNMF
    from tpunmf_torch.solvers import hals, mur, mur_beta
    from tpunmf_torch.utils import MetricsLogger, determinism_check, trace

    k, dev = eu_init[0].shape[1], eu_x.device
    line = {}
    with tempfile.TemporaryDirectory() as d:
        line["checkpoint"] = drive(
            "checkpoint/resume path", SINGLE_EU,
            lambda: checkpoint_path_run(torch, tt, card, eu_x, k, eu_init, d))

        def grid_path():
            eu = lambda_grid_run(torch, tt, card, f"lambda grid EU {tuple(eu_x.shape)} k{k}",
                                 eu_x, k, "eu", GRID_LAMBDAS, GRID_ITERS, eu_init)
            init = random_init(0, *kl2_x.shape, k, device=kl2_x.device)
            kl = lambda_grid_run(torch, tt, card, f"lambda grid KL {tuple(kl2_x.shape)} k{k}",
                                 kl2_x, k, "kl", GRID_LAMBDAS[:2], GRID_KL_ITERS, init)
            return {"EU": eu, "KL": kl}

        line["lambda_grid"] = drive("lambda grid path", SINGLE_EU + (
            "kl_ratio", "kl_obj", "mur_iteration_kl"), grid_path)

        def scan_path():
            x = planted_x(torch, SCAN["m"], SCAN["n"], SCAN["k"], seed=6, device=dev)
            out = []
            for kk in SCAN["ks"]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = rank_scan(x, (kk,), n_seeds=SCAN["seeds"], n_iter=SCAN["iters"])[0]
                r["seconds"] = time.perf_counter() - t0
                require(0.0 <= r["dispersion"] <= 1.0 + 1e-6
                        and np.isfinite(r["mean_final_obj"]),
                        f"rank_scan k{kk}: dispersion {r['dispersion']}, "
                        f"objective {r['mean_final_obj']}")
                out.append(r)
            print(f"  rank_scan planted {tuple(x.shape)} ({SCAN['k']} components), "
                  f"{SCAN['seeds']} "
                  f"seeds x {SCAN['iters']} iterations: " + ", ".join(
                      f"k{r['k']} dispersion {r['dispersion']:.4f} in {r['seconds']:.2f} s"
                      for r in out) + f" [{card}]", flush=True)
            return out

        line["rank_scan"] = drive("rank_scan path", ("eu_residual_obj",), scan_path)

        def beta_path():
            nudged = [f.clamp(min=1e-6).contiguous() for f in eu_init]  # mur_beta's nudge
            out = {}
            for beta in (0.0, 0.5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = mur_beta(eu_x, k, beta=beta, w_init=nudged[0], h_init=nudged[1],
                               min_iter=BETA_ITERS, max_iter=BETA_ITERS, tol1=0.0, tol2=0.0)
                secs = time.perf_counter() - t0
                hist = np.asarray(res.obj_history, dtype=np.float64)
                require(np.all(np.isfinite(hist)) and hist[-1] < hist[0],
                        f"mur_beta {beta}: trace {hist[0]} -> {hist[-1]}")
                out[f"beta={beta:g}"] = {"it_s": BETA_ITERS / secs, "first": hist[0],
                                         "final": hist[-1]}
            for beta, dist in ((1.0, "kl"), (2.0, "eu")):
                kw = dict(w_init=eu_init[0], h_init=eu_init[1], min_iter=BETA_ITERS,
                          max_iter=BETA_ITERS, tol1=0.0, tol2=0.0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = mur_beta(eu_x, k, beta=beta, **kw)
                secs = time.perf_counter() - t0
                a = np.asarray(res.obj_history, dtype=np.float64)
                errs = []
                for plain in (True, False):
                    ref = mur(eu_x, k, distance_type=dist, use_pallas=not plain, **kw)
                    b = np.asarray(ref.obj_history, dtype=np.float64)
                    errs.append(float(np.max(np.abs(a - b) / np.abs(b))))
                for err, route in zip(errs, ("plain", "kernel")):
                    require(err <= BETA_RTOL,
                            f"mur_beta {beta} off MUR {dist}'s {route} route by {err:.3e}")
                out[f"beta={beta:g}"] = {"it_s": BETA_ITERS / secs, "first": a[0],
                                         "final": a[-1], "max_rel_err_vs_mur_plain": errs[0],
                                         "max_rel_err_vs_mur_kernels": errs[1]}
            print(f"  mur_beta {tuple(eu_x.shape)} k{k}, {BETA_ITERS} iterations: " + "; ".join(
                f"{b} {r['it_s']:.1f} it/s, objective {r['first']:.6e} -> {r['final']:.6e}"
                + (f", {r['max_rel_err_vs_mur_plain']:.2e} off MUR's plain route "
                   f"({r['max_rel_err_vs_mur_kernels']:.2e} off its kernel route)"
                   if "max_rel_err_vs_mur_plain" in r else "")
                for b, r in out.items()) + f" [{card}]", flush=True)
            return out

        line["mur_beta"] = drive("mur_beta path", ("eu_residual_obj", "kl_obj"), beta_path)

        def sklearn_path():
            m, n, kk, iters = SKLEARN["m"], SKLEARN["n"], SKLEARN["k"], SKLEARN["iters"]
            x = torch.from_numpy(movielens_like(m, n, density=0.2, seed=2)).to(dev)
            new = torch.from_numpy(movielens_like(SKLEARN["new"], n, density=0.2,
                                                  seed=7)).to(dev)
            out = {}
            for label, kw in (("cd", dict(solver="cd")),
                              ("mu KL", dict(solver="mu", beta_loss="kullback-leibler"))):
                est = SkNMF(n_components=kk, init="nndsvd", max_iter=iters, tol=0.0,
                            min_iter=iters, **kw)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                est.fit(x)
                secs = time.perf_counter() - t0
                enc = est.transform(new)
                require(est.n_iter_ == iters - 1 and np.isfinite(est.reconstruction_err_),
                        f"sklearn {label}: n_iter_ {est.n_iter_}, "
                        f"err {est.reconstruction_err_}")
                require(enc.shape == (SKLEARN["new"], kk) and np.all(np.isfinite(enc))
                        and enc.min() >= 0, f"sklearn {label}: transform of new rows")
                out[label] = {"n_iter_": est.n_iter_,
                              "reconstruction_err_": est.reconstruction_err_,
                              "fit_s": secs}
                print(f"  sklearn NMF {label} {tuple(x.shape)} k{kk}: n_iter_ {est.n_iter_}, "
                      f"reconstruction_err_ {est.reconstruction_err_:.6e}, fit {secs:.2f} s "
                      f"(NNDSVD included); transform of {SKLEARN['new']} new rows finite, "
                      f">= 0 "
                      f"[{card}]", flush=True)
            return out

        line["sklearn"] = drive("sklearn path", ("gs_sweep", "eu_residual_obj", "kl_obj"),
                                sklearn_path)
        line["cli"] = cli_path(card, eu_np, k, d, dev.type)

        def profiling_path():
            kw = dict(distance_type="eu", w_init=eu_init[0], h_init=eu_init[1], tol1=0.0,
                      tol2=0.0)
            logger = MetricsLogger(flops_per_iter=6.0 * eu_x.numel() * k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mur(eu_x, k, min_iter=100, max_iter=100, block_size=25, on_block_end=logger,
                **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            s = logger.summary()
            require(len(logger.records) == 4 and s["iterations"] == 100,
                    f"MetricsLogger: {len(logger.records)} records, {s['iterations']}")
            tdir = os.path.join(d, "trace")
            with trace(tdir):
                mur(eu_x, k, min_iter=5, max_iter=5, **kw)
                torch.cuda.synchronize()
            with open(os.path.join(tdir, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            names = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
            require(any("pass_kernel" in n for n in names)
                    and any(s_ in n for n in names for s_ in ("eu_rows_tc_kernel",
                                                             "eu_cols_tc_kernel")),
                    f"trace: the route's kernels are not named in {names[:12]}")

            def run(fn, **extra):
                return lambda: (lambda r: (r.w, r.h, r.obj_history))(
                    fn(eu_x, k, min_iter=10, max_iter=10, **{**kw, **extra}))

            require(determinism_check(run(mur), runs=2), "MUR EU not deterministic")
            require(determinism_check(run(hals, w_init=hals_init[0], h_init=hals_init[1]),
                                      runs=2), "HALS not deterministic")
            out = {"records": len(logger.records),
                   "logger_mean_it_s": s["mean_iters_per_sec"], "wall_it_s": 100 / wall,
                   "trace_kernels": len(names)}
            print(f"  MetricsLogger on 100 MUR EU iterations (blocks of 25): 4 records, "
                  f"mean {s['mean_iters_per_sec']:.1f} it/s, wall {100 / wall:.1f} it/s; "
                  f"trace() of 5 iterations names {len(names)} kernels; determinism_check "
                  f"passes for MUR EU and HALS (10 iterations, kernel routes) [{card}]",
                  flush=True)
            return out

        line["profiling"] = drive("profiling path", SINGLE_EU + ("gs_sweep",),
                                  profiling_path)
    return line


def cli_path(card, eu_np, k, d, device):
    """python -m tpunmf_torch in subprocesses on the card: factorize with a
    checkpoint, the same command again (it resumes at the saved end), and a
    grid beside them."""
    data = os.path.join(d, "x.npy")
    np.save(data, eu_np)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m", "tpunmf_torch"]
    grid = subprocess.Popen(cli + ["grid", data, "-k", str(k), "--features", f"{k // 2},{k}",
                                   "--lambda-w", "0,0.1", "--max-iter", "20", "--no-save",
                                   "--device", device],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=d)
    fact = cli + ["factorize", data, "-k", str(k), "--distance-type", "eu", "--nndsvd",
                  "zero", "--min-iter", "50", "--max-iter", "50", "--checkpoint",
                  os.path.join(d, "cli_state"), "--save-dir", os.path.join(d, "out"),
                  "--device", device]
    rows, secs = [], []
    try:
        for _ in range(2):
            t0 = time.perf_counter()
            r = subprocess.run(fact, capture_output=True, text=True, env=env, cwd=d,
                               timeout=300)
            secs.append(time.perf_counter() - t0)
            require(r.returncode == 0, f"CLI factorize exited {r.returncode}: "
                                       f"{r.stderr[-2000:]}")
            rows.append([json.loads(s) for s in r.stdout.splitlines() if s.startswith("{")])
        g_out, g_err = grid.communicate(timeout=300)
    finally:
        if grid.poll() is None:
            grid.kill()
            grid.communicate()
    require(grid.returncode == 0, f"CLI grid exited {grid.returncode}: {g_err[-2000:]}")
    first, again = rows[0][0], rows[1][0]
    saved = os.listdir(os.path.join(d, "out"))
    require(first["iterations"] == 49 and again == first,
            f"CLI factorize: {first} then {again}")
    require(any(s.startswith(f"nmf_mur_{k}_eu") for s in saved), f"CLI saved {saved}")
    grid_rows = [json.loads(s) for s in g_out.splitlines() if s.startswith("{")]
    require(len(grid_rows) == 4 and all(np.isfinite(r["final_objective"]) for r in grid_rows),
            f"CLI grid printed {grid_rows}")
    print(f"  CLI factorize {eu_np.shape} k{k} --checkpoint: iterations 49, objective "
          f"{first['final_objective']:.6e}, saved {saved[0]}, {secs[0]:.1f} s; the same "
          f"command resumed at the end with the same line in {secs[1]:.1f} s; grid printed "
          f"4 rows (subprocesses, NNDSVD included) [{card}]", flush=True)
    return {"factorize_s": secs[0], "resume_s": secs[1],
            "final_objective": first["final_objective"], "grid_rows": len(grid_rows)}


# Phase 6: semi-NMF, ONMF and robust NMF at the bench's 8192^2 r128, the
# multilevel warm start at 8192x16384 r128; 10 iterations a run
FAMILY_ITERS = 10
# robust NMF's X: outliers added to this share of the columns, as
# tests/test_robust.py's recipe adds them (50 |N(0, 1)| a cell)
ROBUST_OUTLIERS = 0.01
MULTILEVEL = dict(levels=2, factor=4, coarse_iters=10)


def l21_f64(torch, x, w, h, rows=4096):
    """sum_j ||x_j - W h_j|| in float64 on the card, a block of rows at a
    time (robust NMF's objective)."""
    hd = h.double()
    sq = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    for r in range(0, x.shape[0], rows):
        d = x[r:r + rows].double() - w[r:r + rows].double() @ hd
        sq += torch.sum(d * d, dim=0)
    return float(torch.sum(torch.sqrt(sq)))


def family_run(torch, tt, counters, label, x, k, card, objective_of, *, routes=(True, False),
               exact=None, needed=(), banned=(), monotone=False, same_bits=True, fit=None,
               f64_gate=True, **kw):
    """NMF(x, k).factorize(**kw) (or ``fit(**kw)``, a solver's own entry)
    for FAMILY_ITERS iterations on each of ``routes`` (use_pallas; a solver
    without a kernel has one route, None, run twice): it/s over the call
    (host clock with a synchronize, the init given), ms an iteration (from
    the ends of the last FAMILY_ITERS one-iteration blocks, the first left
    out), final objective and launches.  The first route launches exactly
    ``exact`` (or each of ``needed`` and none of ``banned``), every other
    route nothing; its final objective is within OBJECTIVE_RTOL of the final
    (W, H)'s in float64 (``objective_of``; without ``f64_gate``, for a Gram
    form that cancels in float32, the distance is printed, not gated); with
    ``monotone`` its trace rises by no more than EU_MONOTONE_RTOL.  Between
    routes: W and H the same bits and the traces within OBJECTIVE_RTOL, or
    without ``same_bits`` the traces within ROUTE_RTOL over the first
    ROUTE_ITERS iterations.  One warm-up iteration a route first."""
    iters = FAMILY_ITERS
    flag = (lambda route: {} if route is None else {"use_pallas": route})
    if fit is None:
        fit = (lambda **a: tt.NMF(x, k).factorize(**a))
    for route in routes:
        fit(**flag(route), **{**kw, "min_iter": 1, "max_iter": 1})

    def one(route):
        stamps = []
        torch.cuda.synchronize()
        before = counts(counters)
        t0 = time.perf_counter()
        res = fit(min_iter=iters, max_iter=iters, tol1=0.0, tol2=0.0, block_size=1,
                  on_block_end=lambda c: stamps.append(time.perf_counter()), **flag(route),
                  **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        hist = np.asarray(res.obj_history, dtype=np.float64)
        require(res.i == iters - 1 and len(hist) == iters + 1,
                f"{label}: ran {res.i + 1} iterations, expected {iters}")
        require(np.all(np.isfinite(hist)) and np.all(np.isfinite(res.w))
                and np.all(np.isfinite(res.h)), f"{label}: non-finite factors or trace")
        return {"res": res, "hist": hist, "it_s": iters / secs,
                "ms_per_it": 1e3 * (stamps[-1] - stamps[-iters]) / (iters - 1),
                "launched": {n: c - before[n] for n, c in counts(counters).items()}}

    first = one(routes[0])
    res, hist = first["res"], first["hist"]
    ref = objective_of(*(torch.from_numpy(np.ascontiguousarray(f)).to(x.device)
                         for f in (res.w, res.h)))
    ref_err = abs(hist[-1] / ref - 1)
    launched = {n: c for n, c in first["launched"].items() if c}
    out = {"it_s": first["it_s"], "ms_per_it": first["ms_per_it"], "obj0": float(hist[0]),
           "obj": float(hist[-1]), "obj_f64": ref, "f64_err": ref_err, "launches": launched}
    print(f"  {label}: obj[0]={hist[0]:.6e} obj[{iters}]={hist[-1]:.9e} (float64 {ref:.9e}, "
          f"rel {ref_err:.3e}); {first['it_s']:.2f} it/s over factorize(), "
          f"{first['ms_per_it']:.3f} ms an iteration; launches {launched} [{card}]",
          flush=True)
    if exact is not None:
        require(first["launched"] == {n: exact.get(n, 0) for n in counters},
                f"{label}: launches {launched}, not {exact}")
    for name in needed:
        require(first["launched"][name] > 0, f"{label}: {name} was not launched")
    for name in banned:
        require(first["launched"][name] == 0, f"{label}: {name} was launched off its route")
    require(ref_err <= OBJECTIVE_RTOL or not f64_gate,
            f"{label}: the final objective is {ref_err:.3e} off its float64 value")
    if monotone:
        rises = np.diff(hist) / np.abs(hist[:-1])
        out["max_rise"] = float(rises.max())
        require(np.all(rises <= EU_MONOTONE_RTOL),
                f"{label}: the objective rose by {rises.max():.3e}")
    for route in routes[1:] if len(routes) > 1 else (routes[0],):
        other = one(route)
        name = "plain route" if route is False else "the same run again"
        b = other["hist"]
        if same_bits:
            same = (np.array_equal(res.w, other["res"].w)
                    and np.array_equal(res.h, other["res"].h))
            err = float(np.max(np.abs(hist - b) / np.abs(b)))
            tol, what = OBJECTIVE_RTOL, "traces"
        else:
            same = None
            n = ROUTE_ITERS + 1
            err = float(np.max(np.abs(hist[:n] - b[:n]) / np.abs(b[:n])))
            tol, what = ROUTE_RTOL["float32"], f"first {ROUTE_ITERS} iterations"
        out.update(other_it_s=other["it_s"], other_ms_per_it=other["ms_per_it"],
                   other_obj=float(b[-1]), route_err=err)
        print(f"  {label}: {name} {other['it_s']:.2f} it/s, {other['ms_per_it']:.3f} ms an "
              f"iteration, obj[{iters}]={b[-1]:.9e}; "
              + ("" if same is None else f"W, H {'the same bits' if same else 'DIFFER'}; ")
              + f"{what} max rel {err:.3e} (tol {tol:.0e})", flush=True)
        if route is False:
            require(not any(other["launched"].values()),
                    f"{label}: the plain route launched a kernel")
        require(same is not False, f"{label}: W, H differ between runs")
        require(err <= tol, f"{label}: the runs' traces disagree ({err:.3e})")
    return out


def families_phase(torch, tt, counters, drive, card, eu_x, eu_init):
    """Phase 6: semi_nmf on the column-centred 8192^2 X from one seeded
    |N(0, 1)| H, onmf from X's NNDSVD 'zero' (nudged to 1e-6), robust_nmf
    on X with outliers in 1% of its columns from the same nudged init, and
    the multilevel warm start over HALS and MUR EU at 8192x16384 r128,
    each beside a cold start with the same fine budget."""
    from tpunmf_torch.data import lowrank_dense

    k, (m, n) = eu_init[0].shape[1], eu_x.shape
    iters = FAMILY_ITERS
    nudged = [f.clamp(min=1e-6).contiguous() for f in eu_init]
    out = {}

    def eu_f64(x):
        return lambda w, h: objective_f64(torch, x, w, h, "eu")

    def semi_path():
        xc = eu_x - eu_x.mean(dim=0)
        g = torch.Generator(device=eu_x.device)
        g.manual_seed(0)
        h0 = torch.randn((k, n), generator=g, device=eu_x.device).abs_()
        require(float(xc.min()) < 0 < float(xc.max()), "semi_nmf: X is not mixed-sign")
        out["semi_nmf"] = family_run(
            torch, tt, counters, f"semi_nmf {tuple(xc.shape)} k{k} centred", xc, k, card,
            eu_f64(xc), exact={"eu_residual_obj": iters + 1}, monotone=True,
            method="semi_nmf", h_init=h0)

    def onmf_path():
        out["onmf"] = family_run(
            torch, tt, counters, f"onmf {tuple(eu_x.shape)} k{k} NNDSVD 'zero'", eu_x, k, card,
            eu_f64(eu_x), exact={"eu_residual_obj": iters + 1}, method="onmf",
            w_init=nudged[0], h_init=nudged[1])

    def robust_path():
        rng = np.random.default_rng(0)
        cols = torch.from_numpy(rng.choice(n, size=int(ROBUST_OUTLIERS * n), replace=False))
        xr = eu_x.clone()
        xr[:, cols.to(xr.device)] += torch.from_numpy(
            50.0 * np.abs(rng.standard_normal((m, len(cols))))).float().to(xr.device)
        out["robust_nmf"] = family_run(
            torch, tt, counters, f"robust_nmf {tuple(xr.shape)} k{k}, {len(cols)} outlier "
            "columns", xr, k, card, lambda w, h: l21_f64(torch, xr, w, h), routes=(None,),
            exact={}, monotone=True, method="robust", w_init=nudged[0], h_init=nudged[1])

    # each path: its kernel-route warm-up (2 objectives) and run (iters + 1)
    drive("semi_nmf path", ("eu_residual_obj",), semi_path,
          exact={"eu_residual_obj": iters + 3})
    drive("onmf path", ("eu_residual_obj",), onmf_path, exact={"eu_residual_obj": iters + 3})
    drive("robust_nmf path", (), robust_path, exact={})

    t0 = time.perf_counter()
    wide = torch.from_numpy(lowrank_dense(EU_WIDE["m"], EU_WIDE["n"], EU_WIDE["k"],
                                          seed=EU_WIDE["seed"])).cuda()
    print(f"  multilevel's X {tuple(wide.shape)} made in {time.perf_counter() - t0:.1f} s",
          flush=True)

    def multilevel_path(method, needed, banned, **kw):
        label = f"multilevel {method} {tuple(wide.shape)} k{k}"
        warm = family_run(torch, tt, counters, label, wide, k, card, eu_f64(wide),
                          needed=needed, banned=banned, same_bits=False, method=method,
                          multilevel=MULTILEVEL, **kw)
        t0 = time.perf_counter()
        cold = tt.NMF(wide, k).factorize(method=method, min_iter=iters, max_iter=iters,
                                         tol1=0.0, tol2=0.0, **kw)
        secs = time.perf_counter() - t0
        warm.update(cold_obj=float(cold.obj_history[-1]), cold_it_s=iters / secs)
        print(f"  {label}: cold start, {iters} iterations from the solver's own init: "
              f"obj[{iters}]={cold.obj_history[-1]:.9e}, {iters / secs:.2f} it/s over "
              f"factorize(); the warm start ends "
              f"{warm['obj'] / cold.obj_history[-1]:.4f} of it [{card}]", flush=True)
        require(warm["obj"] < cold.obj_history[-1],
                f"{label}: the warm start ends at {warm['obj']:.6e}, not below the cold "
                f"start's {cold.obj_history[-1]:.6e}")
        out[f"multilevel {method}"] = warm

    hals_kernels = ("gs_sweep", "eu_residual_obj")
    drive("multilevel HALS path", hals_kernels,
          lambda: multilevel_path("hals", hals_kernels, UPDATES, inner_sweeps=2))
    drive("multilevel MUR path", ("eu_residual_obj",),
          lambda: multilevel_path("mur", ("eu_residual_obj",), ("gs_sweep",),
                                  distance_type="eu"))
    return out


# Phase 7: N-way CP at tpunmf's own production shape (benchmarks/rate_probe.py:
# 146-152: X the exact CP model of three seeded uniform + 0.01 factors, here
# with 0.05 U[0, 1) noise so that a fit does not drive the objective to 0),
# a 4-way tensor, the CP rank scan, the CLI on a 3-D stack, then convex, graph,
# symmetric and tri-factor NMF and online NMF at the bench's 8192^2 r128
NTF = dict(dims=(512, 512, 512), k=64, seed=5, noise=0.05)
# (label, solver keywords, iterations, observed share of a seeded mask or None)
NTF_RUNS = (("MUR EU", dict(update="mur", distance_type="eu"), 50, None),
            ("CP-HALS EU", dict(update="hals"), 50, None),
            ("MUR KL", dict(update="mur", distance_type="kl"), 20, None),
            ("masked MUR EU", dict(update="mur", distance_type="eu"), 20, 0.5))
NTF4 = dict(dims=(64, 64, 64, 64), k=16, seed=6, noise=0.05, iters=20)
NTF_SCAN = dict(dims=(256, 256, 256), k=16, ks=(8, 16, 24), iters=50, seed=7, noise=0.05)
NTF_CLI = dict(dims=(256, 256, 64), k=16, seed=8, noise=0.05)
NMTF_K = 32
KNN_NEIGHBORS = 5
ONLINE = dict(batch=1024, passes=2, sweeps=2, tol=1e-4)


def cp_data(torch, dims, k, seed, noise):
    """(X, init): X the CP model of k seeded U[0, 1) + 0.01 factors plus
    ``noise`` U[0, 1), and an init of the same recipe from the next draws,
    all float32 on the card."""
    from tpunmf_torch.solvers import cp_reconstruct

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    factors = [torch.rand((d, k), generator=g, device="cuda") + 0.01 for d in dims]
    x = cp_reconstruct(factors)
    x += noise * torch.rand(x.shape, generator=g, device="cuda")
    init = [torch.rand((d, k), generator=g, device="cuda") + 0.01 for d in dims]
    return x, init


def cp_objective_f64(torch, x, factors, dist, mask=None, rows=32):
    """The CP model's objective on X in float64 on the card (core/losses.py's
    formulas), directly from X - cp_reconstruct, a block of mode-0 slices at
    a time."""
    from tpunmf_torch.core.losses import distance
    from tpunmf_torch.solvers import cp_reconstruct

    fs = [torch.as_tensor(f, device=x.device).double() for f in factors]
    total = 0.0
    for r in range(0, x.shape[0], rows):
        xr = x[r:r + rows].double()
        xhat = cp_reconstruct([fs[0][r:r + rows]] + fs[1:])
        if mask is not None:
            mr = mask[r:r + rows].double()
            xr, xhat = mr * xr, mr * xhat
        total += float(distance(xr, xhat, dist))
    return total


def ntf_run(torch, tt, counters, label, x, init, iters, card, *, mask=None, **kw):
    """NMF(x, k).factorize(method="ntf", factors_init=init, **kw) for exactly
    ``iters`` iterations on the kernel route and on the plain route (one
    warm-up iteration each first): it/s over factorize(), ms an iteration
    (ends of one-iteration blocks, the first left out), the peak device
    memory above the resting allocation, the final Gram-form (or direct)
    objective and the final factors' objective in float64.  CP-HALS's kernel
    route launches exactly ``x.ndim`` gs_sweep an iteration, every other run
    nothing; MUR's routes are one code (the same bits); the routes' float64
    objectives agree within OBJECTIVE_RTOL; MUR EU's trace rises by no more
    than EU_MONOTONE_RTOL x ||X||^2 / 2, the scale at which its float32 Gram
    form rounds."""
    k = init[0].shape[1]
    dist = kw.get("distance_type", "eu")
    hals = kw.get("update") == "hals"
    fit = dict(method="ntf", factors_init=init, mask=mask, **kw)
    xsq = float(torch.sum(x.double() ** 2))
    for route in (True, False):
        tt.NMF(x, k).factorize(use_pallas=route, min_iter=1, max_iter=1, **fit)

    def one(route):
        stamps = []
        torch.cuda.synchronize()
        rest = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = counts(counters)
        t0 = time.perf_counter()
        res = tt.NMF(x, k).factorize(
            use_pallas=route, min_iter=iters, max_iter=iters, tol1=0.0, tol2=0.0,
            block_size=1, on_block_end=lambda c: stamps.append(time.perf_counter()), **fit)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - rest
        launched = {n: c - before[n] for n, c in counts(counters).items() if c - before[n]}
        hist = np.asarray(res.obj_history, dtype=np.float64)
        require(res.i == iters - 1 and len(hist) == iters + 1,
                f"{label}: ran {res.i + 1} iterations, expected {iters}")
        require(np.all(np.isfinite(hist)) and all(np.all(np.isfinite(f)) for f in res.factors),
                f"{label}: non-finite factors or trace")
        f64 = cp_objective_f64(torch, x, res.factors, dist, mask)
        want = {"gs_sweep": x.ndim * iters} if (route and hals) else {}
        require(launched == want, f"{label}: launches {launched}, not {want}")
        return {"res": res, "hist": hist, "it_s": iters / secs, "launches": launched,
                "ms_per_it": 1e3 * (stamps[-1] - stamps[-iters]) / (iters - 1),
                "peak_gb": peak / 1e9, "obj": float(hist[-1]), "obj_f64": f64,
                "gap": float(hist[-1] / f64 - 1)}

    out = {}
    for route, name in ((True, "kernel route"), (False, "plain route")):
        r = one(route)
        out[name] = r
        print(f"  ntf {label} {tuple(x.shape)} k{k}, {name}: {r['it_s']:.2f} it/s over "
              f"factorize(), {r['ms_per_it']:.3f} ms an iteration, peak {r['peak_gb']:.3f} GB "
              f"above the resting allocation (X {x.numel() * x.element_size() / 1e9:.3f} GB); "
              f"obj[0]={r['hist'][0]:.6e} obj[{iters}]={r['obj']:.9e}, float64 of the final "
              f"factors {r['obj_f64']:.9e} (gap {r['gap']:+.3e}); launches {r['launches']} "
              f"[{card}]", flush=True)
    a, b = out["kernel route"], out["plain route"]
    err = abs(a["obj_f64"] / b["obj_f64"] - 1)
    same = all(np.array_equal(p, q) for p, q in zip(a["res"].factors, b["res"].factors))
    print(f"  ntf {label}: the routes' float64 objectives {err:.3e} apart (tol "
          f"{OBJECTIVE_RTOL:.0e}); factors {'the same bits' if same else 'differ'}", flush=True)
    require(err <= OBJECTIVE_RTOL, f"{label}: the routes' float64 objectives differ by {err:.3e}")
    if not hals:
        require(same, f"{label}: MUR's routes are one code, yet the factors differ")
    if dist == "eu" and mask is None and not hals:
        rise = float(np.max(np.diff(a["hist"])))
        a["max_rise_over_xsq"] = rise / (0.5 * xsq)
        print(f"  ntf {label}: largest rise of the trace {rise:+.3e} = "
              f"{a['max_rise_over_xsq']:+.3e} x ||X||^2/2 (tol {EU_MONOTONE_RTOL:.0e})",
              flush=True)
        require(a["max_rise_over_xsq"] <= EU_MONOTONE_RTOL,
                f"{label}: the trace rose by {rise:.3e}")
    return {name: {k_: v for k_, v in r.items() if k_ not in ("res", "hist")}
            for name, r in out.items()} | {"routes_f64_err": err}


def ntf_cli_path(torch, tt, card, d):
    """python -m tpunmf_torch factorize stack.npy -k 16 -m ntf --ntf-update
    hals on a 3-D stack in a subprocess: its save file loads through
    NMF.load_factorization with the factors, i and final objective of the
    same fit in this process (the init is the default seed's on both)."""
    cfg = NTF_CLI
    x, _ = cp_data(torch, cfg["dims"], cfg["k"], cfg["seed"], cfg["noise"])
    stack = x.cpu().numpy()
    data = os.path.join(d, "stack.npy")
    np.save(data, stack)
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "tpunmf_torch", "factorize", data, "-k",
                        str(cfg["k"]), "-m", "ntf", "--ntf-update", "hals", "--save-dir",
                        os.path.join(d, "out"), "--device", "cuda"],
                       capture_output=True, text=True, env=env, cwd=d, timeout=300)
    secs = time.perf_counter() - t0
    require(r.returncode == 0, f"CLI ntf exited {r.returncode}: {r.stderr[-2000:]}")
    row = [json.loads(s) for s in r.stdout.splitlines() if s.startswith("{")][0]
    saved = os.listdir(os.path.join(d, "out"))
    loaded = tt.NMF.load_factorization(os.path.join(d, "out", saved[0]))
    model = tt.NMF(torch.from_numpy(stack).cuda(), cfg["k"])
    res = model.factorize(method="ntf", update="hals")
    same = all(np.array_equal(p, q) for p, q in zip(loaded.results.factors, res.factors))
    print(f"  CLI factorize -m ntf --ntf-update hals {stack.shape} k{cfg['k']}: {row}, saved "
          f"{saved[0]} in {secs:.1f} s (a subprocess); loaded: "
          f"{[f.shape for f in loaded.results.factors]}, i {loaded.results.i}; the same fit "
          f"here: i {res.i}, factors {'the same bits' if same else 'DIFFER'} [{card}]",
          flush=True)
    require(row["method"] == "ntf" and row["iterations"] == res.i == loaded.results.i
            and row["final_objective"] == float(res.obj_history[-1]),
            f"CLI ntf printed {row}, the same fit here ends at i {res.i}, "
            f"{res.obj_history[-1]}")
    require(saved == [model.default_save_name() + ".npz"] and same,
            f"CLI ntf saved {saved}; factors the same bits: {same}")
    return {"seconds": secs, "iterations": row["iterations"],
            "final_objective": row["final_objective"]}


def ntf_phase(torch, tt, counters, drive, card):
    """Phase 7, first half: ntf at 512^3 r64 (MUR EU, CP-HALS, KL, masked
    EU), the 4-way tensor, ntf_rank_scan and the CLI."""
    from tpunmf_torch.experiments import ntf_rank_scan

    out = {}
    t0 = time.perf_counter()
    x, init = cp_data(torch, NTF["dims"], NTF["k"], NTF["seed"], NTF["noise"])
    g = torch.Generator(device="cuda")
    g.manual_seed(NTF["seed"] + 100)
    torch.cuda.synchronize()
    print(f"  ntf's X {tuple(x.shape)} made in {time.perf_counter() - t0:.1f} s", flush=True)
    for label, kw, iters, observed in NTF_RUNS:
        mask = (None if observed is None else
                (torch.rand(x.shape, generator=g, device="cuda") < observed).float())
        hals = kw.get("update") == "hals"
        exact = {"gs_sweep": x.ndim * (iters + 1)} if hals else {}
        out[label] = drive(f"ntf {label} path", ("gs_sweep",) if hals else (),
                           lambda: ntf_run(torch, tt, counters, label, x, init, iters, card,
                                           mask=mask, **kw), exact=exact)
        del mask

    def profile_path():
        # where an iteration's time goes at 512^3, each update family on the
        # kernel route, CP-HALS on the plain route too
        for label, kw, _, observed in NTF_RUNS:
            extra = dict(kw, factors_init=init)
            if observed is not None:
                extra["mask"] = (torch.rand(x.shape, generator=g, device="cuda")
                                 < observed).float()
            out["profile " + label] = profile_run(torch, tt, f"ntf {label} {tuple(x.shape)}",
                                                  x, NTF["k"], None, method="ntf", **extra)
            if kw.get("update") == "hals":
                out["profile " + label + " plain"] = profile_run(
                    torch, tt, f"ntf {label} {tuple(x.shape)} plain", x, NTF["k"], None,
                    plain=True, method="ntf", **extra)

    drive("ntf profile path", ("gs_sweep",), profile_path)
    del x, init

    x4, init4 = cp_data(torch, NTF4["dims"], NTF4["k"], NTF4["seed"], NTF4["noise"])
    for label, kw in (("4-way MUR EU", dict(update="mur")), ("4-way CP-HALS", dict(update="hals"))):
        hals = kw["update"] == "hals"
        out[label] = drive(f"ntf {label} path", ("gs_sweep",) if hals else (),
                           lambda: ntf_run(torch, tt, counters, label, x4, init4, NTF4["iters"],
                                           card, **kw),
                           exact={"gs_sweep": 4 * (NTF4["iters"] + 1)} if hals else {})
    del x4, init4

    def scan_path():
        xs, _ = cp_data(torch, NTF_SCAN["dims"], NTF_SCAN["k"], NTF_SCAN["seed"],
                        NTF_SCAN["noise"])
        t0 = time.perf_counter()
        rows = ntf_rank_scan(xs, NTF_SCAN["ks"], update="hals", n_iter=NTF_SCAN["iters"],
                             key=0)
        secs = time.perf_counter() - t0
        print(f"  ntf_rank_scan {tuple(xs.shape)} planted rank {NTF_SCAN['k']}, ks "
              f"{NTF_SCAN['ks']}, hals, {NTF_SCAN['iters']} iterations at most: "
              f"{secs / len(rows):.2f} s a rank; "
              + "; ".join(f"k {r['k']}: rel_err {r['rel_err']:.4e} corcondia "
                          f"{r['corcondia']:.2f} final_obj {r['final_obj']:.6e}" for r in rows)
              + f" [{card}]", flush=True)
        require(all(np.isfinite([r["rel_err"], r["corcondia"], r["final_obj"]]).all()
                    for r in rows), f"ntf_rank_scan: non-finite rows {rows}")
        require(rows[1]["rel_err"] < rows[0]["rel_err"],
                "ntf_rank_scan: the planted rank fits no better than half of it")
        return {"s_a_rank": secs / len(rows), "rows": rows}

    out["ntf_rank_scan"] = drive("ntf_rank_scan path", ("gs_sweep",), scan_path)
    with tempfile.TemporaryDirectory() as d:
        out["cli"] = drive("ntf CLI path", ("gs_sweep",), lambda: ntf_cli_path(torch, tt, card, d))
    return out


def matrix_families_phase(torch, tt, counters, drive, card, eu_x, eu_init):
    """Phase 7, second half, at the bench's 8192^2 r128: convex_nmf on the
    column-centred X (no kernel: run twice, the same bits), knn_graph of X's
    columns, gnmf with it (eu_residual_obj iters + 1 a run), symnmf of the
    graph (no kernel), nmtf from its own k-means init (eu_residual_obj
    iters + 1 a run) and OnlineNMF over 8 minibatches of 1024 columns, two
    passes (exactly 16 gs_sweep on the kernel route)."""
    from tpunmf_torch import solvers

    k, (m, n) = eu_init[0].shape[1], eu_x.shape
    iters = FAMILY_ITERS
    nudged = [f.clamp(min=1e-6).contiguous() for f in eu_init]
    out = {}

    def eu_f64(x, scale=1.0):
        return lambda w, h: scale * objective_f64(torch, x, w, h, "eu")

    def convex_path():
        xc = eu_x - eu_x.mean(dim=0)
        out["convex_nmf"] = family_run(
            torch, tt, counters, f"convex_nmf {tuple(xc.shape)} k{k} centred", xc, k, card,
            eu_f64(xc, 2.0), routes=(None,), exact={}, f64_gate=False,
            fit=lambda **a: solvers.convex_nmf(xc, k, **a))

    drive("convex_nmf path", (), convex_path, exact={})

    graph = {}

    def knn_path():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = solvers.knn_graph(eu_x, KNN_NEIGHBORS, mode="heat")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        nnz = int((a > 0).sum())
        sym = bool(torch.equal(a, a.T))
        print(f"  knn_graph of {n} columns, {KNN_NEIGHBORS} neighbours, heat: {1e3 * secs:.1f} "
              f"ms, {nnz} nonzeros ({nnz / n:.2f} a column), symmetric {sym} [{card}]",
              flush=True)
        require(sym and nnz >= KNN_NEIGHBORS * n and bool(torch.isfinite(a).all()),
                "knn_graph: not a symmetric finite graph with every column's neighbours")
        graph["a"] = a
        return {"ms": 1e3 * secs, "nnz": nnz}

    out["knn_graph"] = drive("knn_graph path", (), knn_path, exact={})
    a = graph["a"]
    a64 = a.double()
    deg64 = a64.sum(dim=1)

    def gnmf_f64(w, h):
        hd = h.double()
        smooth = float(torch.sum(deg64 * torch.sum(hd * hd, dim=0)) - torch.sum((hd @ a64) * hd))
        return objective_f64(torch, eu_x, w, h, "eu") + 0.5 * smooth

    def gnmf_path():
        out["gnmf"] = family_run(
            torch, tt, counters, f"gnmf {tuple(eu_x.shape)} k{k} lambda_g 1", eu_x, k, card,
            gnmf_f64, exact={"eu_residual_obj": iters + 1},
            fit=lambda **kw: solvers.gnmf(eu_x, k, a, lambda_g=1.0, **kw),
            w_init=nudged[0], h_init=nudged[1])

    def symnmf_path():
        out["symnmf"] = family_run(
            torch, tt, counters, f"symnmf of the graph {tuple(a.shape)} k{k}", a, k, card,
            eu_f64(a, 2.0), routes=(None,), exact={}, f64_gate=False,
            fit=lambda **kw: solvers.symnmf(a, k, **kw))

    # each kernel path: its kernel-route warm-up (2 objectives) and run (iters + 1)
    drive("gnmf path", ("eu_residual_obj",), gnmf_path, exact={"eu_residual_obj": iters + 3})
    del a64, deg64
    drive("symnmf path", (), symnmf_path, exact={})
    del graph["a"], a

    core = {}

    def nmtf_fit(**kw):
        res, core["s"] = solvers.nmtf(eu_x, NMTF_K, NMTF_K, **kw)
        return res

    def nmtf_path():
        torch.cuda.synchronize()
        rest = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out["nmtf"] = family_run(
            torch, tt, counters, f"nmtf {tuple(eu_x.shape)} k_row = k_col = {NMTF_K}, k-means "
            "init", eu_x, NMTF_K, card,
            lambda f, gt: objective_f64(torch, eu_x, f,
                                        torch.from_numpy(core["s"]).cuda() @ gt, "eu"),
            exact={"eu_residual_obj": iters + 1}, fit=nmtf_fit)
        peak = (torch.cuda.max_memory_allocated() - rest) / 1e9
        out["nmtf"]["peak_gb"] = peak
        chunk = importlib.import_module("tpunmf_torch.solvers.nmtf")._KMEANS_CHUNK_BYTES
        print(f"  nmtf: peak {peak:.3f} GB above the resting allocation over its runs, the "
              f"k-means distances in chunks of {chunk >> 20} MB [{card}]", flush=True)

    drive("nmtf path", ("eu_residual_obj",), nmtf_path, exact={"eu_residual_obj": iters + 3})

    batches = [eu_x[:, j:j + ONLINE["batch"]].contiguous() for j in range(0, n, ONLINE["batch"])]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    w0 = torch.randn((m, k), generator=g, device="cuda").abs_()
    online = {}

    def stream(route):
        model = solvers.OnlineNMF(m, k, sweeps=ONLINE["sweeps"], w_init=w0, use_pallas=route)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ONLINE["passes"]):
            for b in batches:
                model.partial_fit(b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        online[route] = model
        return len(batches) * ONLINE["passes"] / secs

    def warm_up():
        # one minibatch a route first: the NNLS's first solves start the
        # card's solver library, which the stream's rate should not hold
        for route in (True, False):
            solvers.OnlineNMF(m, k, sweeps=ONLINE["sweeps"], w_init=w0,
                              use_pallas=route).partial_fit(batches[0])
        torch.cuda.synchronize()

    def online_kernel_path():
        rate = stream(True)
        model = online[True]
        h = model.transform(eu_x)
        w = model._w
        fit = objective_f64(torch, eu_x, w, h, "eu")
        xsq = float(torch.sum(eu_x.double() ** 2))
        print(f"  OnlineNMF {tuple(eu_x.shape)} k{k}, {len(batches)} minibatches of "
              f"{ONLINE['batch']} columns, {ONLINE['passes']} passes, sweeps "
              f"{ONLINE['sweeps']}, kernel route: {rate:.2f} minibatches/s; last minibatch's "
              f"objective {model.obj_history[-1]:.6e}; transform of X re-encoded: EU "
              f"objective {fit:.9e} = {fit / (0.5 * xsq):.4e} of ||X||^2/2 [{card}]", flush=True)
        require(np.all(np.isfinite(model.obj_history)) and np.isfinite(fit),
                "OnlineNMF: non-finite objective")
        online["fit"], online["rate"] = fit, rate

    drive("OnlineNMF warm-up path", ("gs_sweep",), warm_up, exact={"gs_sweep": 1})
    drive("OnlineNMF kernel path", ("gs_sweep",), online_kernel_path,
          exact={"gs_sweep": len(batches) * ONLINE["passes"]})
    plain_rate = drive("OnlineNMF plain path", (), lambda: stream(False), exact={})
    wk, wp = online[True]._w, online[False]._w
    err = float(torch.max(torch.abs(wk - wp)) / torch.max(torch.abs(wp)))
    print(f"  OnlineNMF plain route {plain_rate:.2f} minibatches/s; final W {err:.3e} of its "
          f"largest entry off the plain route's (tol {ONLINE['tol']:.0e})", flush=True)
    require(err <= ONLINE["tol"], f"OnlineNMF: the routes' W differ by {err:.3e}")
    out["online"] = {"rate": online["rate"], "plain_rate": plain_rate, "w_err": err,
                     "transform_obj": online["fit"]}
    return out

# Phase 8: out of core.  The streamed MUR's host path (the native panelizer,
# the pinned ring, the copy stream), its agreement with in-core mur inside
# HBM, and MUR EU at BASELINE config[4]'s data scale, whose dense X is 400 GB
# in f32 and 200 GB in bf16 (benchmarks/run_configs.py:229-244: 1M x 100k,
# r256; here sparse_csr's recipe at 1e-3 density, 1e8 nonzeros), then
# topk_streaming from a host H larger than one panel
# one iteration (two before phase 9 came)
OOC = dict(m=1_000_000, n=100_000, density=1e-3, seed=0, k=256, iters=1)
# the panelizer's tiles and the ring's panels, 134 MB each in bf16
OOC_TILE = 8192
# the in-HBM agreements: iterations from one init, and the tolerances of the
# streamed runs against in-core mur (f32 transfer; bf16 transfer against
# in-core mur on the bf16-rounded X) and of the KL kernel route against its
# plain route and in-core mur: f32 sums in another order
OOC_AGREE_ITERS = 2
OOC_RTOL = {"f32": 1e-4, "bf16": 5e-3, "kl": 1e-4}
# W, H, the accumulators and the ring; never X
OOC_PEAK_BYTES = 10e9
# topk_streaming: 64 users, k = 100, 2^24 items at r128 (an 8.6 GB f32 host
# H), panels of 2^20 items
OOC_TOPK = dict(users=64, k=100, items=1 << 24, r=128, panel=1 << 20, requests=3)


@contextlib.contextmanager
def timed_passes(torch, log):
    """Record (start, end, tiles) of each streamed pass of mur_streaming:
    host clock from the pass's first panel to its last, with a synchronize
    at its end."""
    from tpunmf_torch.solvers import streaming

    real = streaming._Panels.pipelined

    def pipelined(self, sched):
        t0 = time.perf_counter()
        yield from real(self, sched)
        torch.cuda.synchronize()
        log.append((t0, time.perf_counter(), len(sched)))

    streaming._Panels.pipelined = pipelined
    try:
        yield
    finally:
        streaming._Panels.pipelined = real


def host_path_rates(torch, stream, card):
    """(a): the densify rate of full-width tiles alone into a pinned buffer
    (host clock, one row block of tiles), f32 and bf16: as the ring fills
    its buffers (the held tile's nonzeros cleared, ``holds=``) and with each
    tile zeroed first; and the pinned host-to-device copy rate (CUDA events
    over 10 copies); all in GB/s of tile bytes."""
    t = stream.row_block
    tiles = [(1, j) for j in range(stream.grid[1]) if (j + 1) * stream.col_panel <= stream.n]
    out = {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        buf = torch.empty((t, t), dtype=dtype, pin_memory=True)
        if dtype == torch.float32:
            def fill(ij, holds, view=buf.numpy()):
                stream.panel(*ij, out=view, holds=holds)
        else:
            def fill(ij, holds):
                stream.panel_bf16(*ij, out=buf, holds=holds)
        fill(tiles[-1], None)
        for label, sparse in (("densify", True), ("zeroing_densify", False)):
            held = tiles[-1]
            t0 = time.perf_counter()
            for ij in tiles:
                fill(ij, held if sparse else None)
                held = ij
            secs = time.perf_counter() - t0
            out[f"{label}_gb_s_{name}"] = len(tiles) * buf.nbytes / secs / 1e9
        dev = torch.empty((t, t), dtype=dtype, device="cuda")
        dev.copy_(buf, non_blocking=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            dev.copy_(buf, non_blocking=True)
        end.record()
        end.synchronize()
        out[f"copy_gb_s_{name}"] = 10 * buf.nbytes / (start.elapsed_time(end) / 1e3) / 1e9
        print(f"  host path, {t}x{t} {name} tiles of the config[4]-scale matrix: densify "
              f"{out[f'densify_gb_s_{name}']:.2f} GB/s of tiles as the ring fills (the held "
              f"tile's nonzeros cleared), {out[f'zeroing_densify_gb_s_{name}']:.2f} zeroing "
              f"each tile ({len(tiles)} tiles, {stream.n_threads} threads, host clock); "
              f"pinned copy to the card {out[f'copy_gb_s_{name}']:.2f} GB/s (CUDA events, 10 "
              f"copies of {buf.nbytes / 1e6:.0f} MB; {card})", flush=True)
        del dev
    return out


def agree(label, got, want, tol):
    """The largest relative gap of two Results' traces (the same length) and
    the scaled gaps of their factors, each within ``tol``."""
    g, w = np.asarray(got.obj_history, dtype=np.float64), np.asarray(want.obj_history,
                                                                      dtype=np.float64)
    require(g.shape == w.shape, f"{label}: traces of {g.shape} and {w.shape}")
    trace = float(np.max(np.abs(g - w) / np.abs(w)))
    fw = float(np.max(np.abs(got.w - want.w)) / np.max(np.abs(want.w)))
    fh = float(np.max(np.abs(got.h - want.h)) / np.max(np.abs(want.h)))
    print(f"  {label}: trace within {trace:.3e}, W {fw:.3e}, H {fh:.3e} (tol {tol:.0e})",
          flush=True)
    require(all(np.isfinite(v) and v <= tol for v in (trace, fw, fh)),
            f"{label}: {trace:.3e} / {fw:.3e} / {fh:.3e} above {tol:.0e}")
    return {"trace": trace, "w": fw, "h": fh, "tol": tol}


def streamed(torch, label, card, csr, k, **kw):
    """One mur_streaming run, timed on the host clock with a synchronize."""
    from tpunmf_torch.solvers import mur_streaming

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mur_streaming(csr, k, **kw)
    secs = time.perf_counter() - t0
    print(f"  {label}: {res.i + 1} iterations in {secs:.2f} s, obj {res.obj_history[-1]:.6e} "
          f"({card})", flush=True)
    require(np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.obj_history)),
            f"{label}: non-finite factors or trace")
    return res, secs


def in_hbm_agreement(torch, drive, card, adm_csr, kl_x):
    """(b): OOC_AGREE_ITERS iterations from one init, streamed against in-core mur (its
    kernel route) on the densified X: EU at config[3] with f32 and bf16
    transfer, KL at config[1] on the streamed kernel route (exact kl_ratio
    and kl_obj counts) against its plain route and in-core mur."""
    import scipy.sparse as sp

    from tpunmf_torch.data import PanelStream, densify
    from tpunmf_torch.init import random_init
    from tpunmf_torch.solvers import mur

    its = OOC_AGREE_ITERS
    common = dict(min_iter=its, max_iter=its, tol1=0.0, tol2=0.0)
    out = {}
    k = CONFIG3["k"]
    w0, h0 = random_init(0, *adm_csr.shape, k, device="cuda")
    x = torch.from_numpy(densify(adm_csr)).cuda()
    tiles = dict(row_block=OOC_TILE, col_panel=OOC_TILE)
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        if dtype is not None:
            x = x.bfloat16().float()  # the bf16-rounded X, in float32
        incore = mur(x, k, distance_type="eu", w_init=w0, h_init=h0, **common)
        res, secs = drive(f"out-of-core EU config[3] {name} path", (),
                          lambda: streamed(torch, f"streamed EU config[3] {name} transfer",
                                           card, adm_csr, k, distance_type="eu", w_init=w0,
                                           h_init=h0, transfer_dtype=dtype, **tiles,
                                           **common), exact={})
        out[f"eu_config3_{name}"] = {
            "secs": secs, **agree(f"streamed EU config[3] {name} transfer against in-core mur",
                                  res, incore, OOC_RTOL[name])}
    del x
    torch.cuda.empty_cache()

    kl_csr = sp.csr_matrix(kl_x.cpu().numpy())
    stream = PanelStream(kl_csr)
    nonempty = sum(stream.panel_nnz(i, j) > 0 for i in range(stream.grid[0])
                   for j in range(stream.grid[1]))
    k = 50
    w0, h0 = random_init(1, *kl_csr.shape, k, device="cuda")
    kw = dict(distance_type="kl", w_init=w0, h_init=h0, **common)
    kern, secs = drive("out-of-core KL config[1] path", ("kl_ratio", "kl_obj"),
                       lambda: streamed(torch, "streamed KL config[1], kernels", card, kl_csr,
                                        k, **kw),
                       exact={"kl_ratio": 2 * nonempty * its, "kl_obj": nonempty * (its + 1)})
    plain, plain_secs = drive("out-of-core KL config[1] plain path", (),
                              lambda: streamed(torch, "streamed KL config[1], plain", card,
                                               kl_csr, k, use_pallas=False, **kw), exact={})
    incore = mur(kl_x, k, **kw)
    out["kl_config1"] = {"secs": secs, "plain_secs": plain_secs, "tiles": nonempty,
                         "plain": agree("streamed KL config[1] kernels against plain", kern,
                                        plain, OOC_RTOL["kl"]),
                         "incore": agree("streamed KL config[1] kernels against in-core mur",
                                         kern, incore, OOC_RTOL["kl"])}
    return out


def out_of_core_run(torch, drive, card):
    """(a) on the matrix of (c), then (c): MUR EU with bf16 transfer at
    config[4]'s data scale, OOC['iters'] iterations from the seeded random
    init, its passes timed, its peak memory, and one more pass under the
    profiler.  Returns (the numbers, the matrix)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpunmf_torch.data import PanelStream, sparse_csr
    from tpunmf_torch.native import loader, native_available

    t0 = time.perf_counter()
    built = native_available()  # built at first use (phase 1 in chip_smoke.py)
    print(f"  native panelizer: {'loaded' if built else 'NOT built'} "
          f"(tpunmf_torch/native/panelize.cpp, {time.perf_counter() - t0:.1f} s)", flush=True)
    require(built, f"the native panelizer did not build: {loader.build_error}")
    t0 = time.perf_counter()
    m, n, k = OOC["m"], OOC["n"], OOC["k"]
    csr = sparse_csr(m, n, density=OOC["density"], seed=OOC["seed"])
    print(f"  config[4]-scale matrix {m}x{n}, {csr.nnz} nonzeros, made on the host in "
          f"{time.perf_counter() - t0:.1f} s (dense: {4 * m * n / 1e9:.0f} GB f32, "
          f"{2 * m * n / 1e9:.0f} GB bf16)", flush=True)
    stream = PanelStream(csr, row_block=OOC_TILE, col_panel=OOC_TILE)
    require(stream.native, "PanelStream took the scipy path")
    out = host_path_rates(torch, stream, card)
    tiles = stream.grid[0] * stream.grid[1]
    del stream

    kw = dict(distance_type="eu", transfer_dtype=torch.bfloat16, key=0, tol1=0.0, tol2=0.0,
              row_block=OOC_TILE, col_panel=OOC_TILE)
    torch.cuda.empty_cache()
    resting = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    passes = []
    with timed_passes(torch, passes):
        res, secs = drive("out-of-core EU config[4]-scale path", (),
                          lambda: streamed(torch, f"streamed EU {m}x{n} r{k} bf16 transfer",
                                           card, csr, k, min_iter=OOC["iters"],
                                           max_iter=OOC["iters"], **kw), exact={})
    peak = torch.cuda.max_memory_allocated()
    obj = [float(v) for v in res.obj_history]
    nonempty = passes[0][2]
    tile_bytes = 2 * OOC_TILE * OOC_TILE
    pass_secs = [e - s for s, e, _ in passes]
    iter_secs = [passes[2 * i + 2][1] - passes[2 * i][1] for i in range(OOC["iters"])]
    pass_gb = nonempty * tile_bytes / 1e9
    rate = pass_gb / np.median(pass_secs)
    pace = ("copy" if out["copy_gb_s_bf16"] < out["densify_gb_s_bf16"] else "densify")
    print(f"  {len(passes)} passes of {nonempty} of {tiles} tiles ({OOC_TILE}^2 bf16): "
          f"{', '.join(f'{s:.2f}' for s in pass_secs)} s a pass; iterations "
          f"{', '.join(f'{s:.2f}' for s in iter_secs)} s; {2 * pass_gb:.1f} GB an iteration; "
          f"the pipeline {rate:.2f} GB/s against copy {out['copy_gb_s_bf16']:.2f} and densify "
          f"{out['densify_gb_s_bf16']:.2f} (the bound, bytes / copy rate: "
          f"{pass_gb / out['copy_gb_s_bf16']:.2f} s a pass; the slower of the two, {pace}, "
          f"sets the pace); peak memory {peak / 1e9:.3f} GB ({(peak - resting) / 1e9:.3f} "
          f"above the resting {resting / 1e9:.3f}); objective {obj} ({card})", flush=True)
    require(len(passes) == 1 + 2 * OOC["iters"], f"{len(passes)} passes")
    require(peak < OOC_PEAK_BYTES, f"peak memory {peak / 1e9:.3f} GB")
    require(all(b <= a for a, b in zip(obj, obj[1:])), f"the objective rose: {obj}")

    # one pass (the initial objective's W^T X) under the profiler
    prof_passes = []
    with timed_passes(torch, prof_passes), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        streamed(torch, "profiled pass", card, csr, k, min_iter=0, max_iter=0, **kw)
    wall = prof_passes[0][1] - prof_passes[0][0]
    compute = copies = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if e.device_type == DeviceType.CUDA and us > 0:
            if "memcpy" in e.key.lower():
                copies += us / 1e6
            else:
                compute += us / 1e6
    idle = 1.0 - compute / wall
    print(f"  profile of one pass: {wall:.2f} s, compute kernels {compute:.2f} s (idle share "
          f"{idle:.3f}), host-to-device copies {copies:.2f} s ({copies / wall:.3f} of the "
          f"pass) ({card})", flush=True)
    out.update({"shape": [m, n], "k": k, "nnz": int(csr.nnz), "tile": OOC_TILE,
                "tiles": tiles, "nonempty": nonempty, "pass_secs": pass_secs,
                "iter_secs": iter_secs, "gb_per_iter": 2 * pass_gb, "pipeline_gb_s": rate,
                "pace": pace, "peak_gb": peak / 1e9, "resting_gb": resting / 1e9,
                "objective": obj, "run_secs": secs, "profiled_pass_secs": wall,
                "profiled_compute_secs": compute, "profiled_copy_secs": copies,
                "idle_share": idle})
    return out, csr


def topk_out_of_core(torch, drive, card, copy_rate):
    """(d): topk_streaming of 64 users from a host H of 2^24 items r128
    (8.6 GB f32) in panels of 2^20, against topk_retrieval on the whole H
    on the card; ms a request."""
    from tpunmf_torch.serve import topk

    c = OOC_TOPK
    gen = torch.Generator(device="cuda").manual_seed(5)
    h_dev = torch.rand((c["r"], c["items"]), generator=gen, device="cuda")
    w = torch.rand((c["users"], c["r"]), generator=gen, device="cuda")
    t0 = time.perf_counter()
    h_host = h_dev.cpu().numpy()
    print(f"  H {h_host.shape} f32 ({h_host.nbytes / 1e9:.2f} GB) on the host in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    want = topk.topk_retrieval(None, w, h_dev, c["k"])
    del h_dev
    torch.cuda.empty_cache()

    def request():
        return topk.topk_streaming(w, h_host, c["items"], c["k"], panel_cols=c["panel"])

    got = drive("out-of-core serving path", ("score_blockmax_relayout",), request)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "topk_streaming differs from topk_retrieval on the whole H")
    secs = []
    for _ in range(c["requests"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    ms = 1e3 * float(np.median(secs))
    rate = h_host.nbytes / (ms / 1e3) / 1e9
    print(f"  topk_streaming ({c['users']} users, k {c['k']}, {c['items']} items r{c['r']}, "
          f"panels of {c['panel']}): the answers of topk_retrieval on the whole H; "
          f"{ms:.1f} ms a request (median of {c['requests']}, host clock), panels at "
          f"{rate:.2f} GB/s against the pinned copy's {copy_rate:.2f} ({card})", flush=True)
    return {"ms": ms, "gb_s": rate, "copy_gb_s": copy_rate, "all_ms": [1e3 * s for s in secs]}


def out_of_core_phase(torch, drive, card, adm_csr, kl_x):
    """Phase 8; returns (its numbers, the config[4]-scale matrix)."""
    out = {"in_hbm": in_hbm_agreement(torch, drive, card, adm_csr, kl_x)}
    torch.cuda.empty_cache()
    out["config4_scale"], csr = out_of_core_run(torch, drive, card)
    torch.cuda.empty_cache()
    out["topk_streaming"] = topk_out_of_core(torch, drive, card,
                                             out["config4_scale"]["copy_gb_s_f32"])
    return out, csr


# Phase 9: MUR across GPUs as a world of one.  The card's machine has one
# H100 and NCCL puts no two ranks of a communicator on one device, so the
# sharded paths run as one rank over NCCL, at full width, through the same
# code and the same kernels as an N-rank world: the facade's mesh= and
# schedule= at the MUR shapes of phase 3, mur_streaming_sharded in HBM and at
# BASELINE config[4]'s data scale, and sharded serving
MGPU_MESHES = (((1,), ("cols",)), ((1, 1), ("rows", "cols")))
# (label, X's name, k, distance, iterations)
MGPU_RUNS = (("EU 8192x8192 k128 f32", "eu", 128, "eu", 50),
             ("KL config[1] 20000x11000 k50 f32", "kl", 50, "kl", 50))
# the streamed runs in HBM: iterations from one init
MGPU_STREAM_ITERS = 5
MGPU_STREAM_RTOL = 1e-4
# the config[4]-scale run: W, H, the accumulators, the ring's row panels
# (3 x 8192 x 100000 bf16) and a row panel in f32; never X
MGPU_PEAK_BYTES = 20e9


def collective_counts(tt):
    return dict(tt.parallel.calls)


def mesh_run(torch, tt, x, k, mesh, driver, iters, init, use_pallas, dist):
    """One factorize() over ``mesh``, timed on the host clock with a
    synchronize: (Results, seconds, kernel launches, collective calls)."""
    kw = dict(method="mur", distance_type=dist, w_init=init[0], h_init=init[1],
              min_iter=iters, max_iter=iters, tol1=0.0, tol2=0.0, use_pallas=use_pallas)
    if driver == "mesh":
        model = tt.NMF(x, k, mesh=mesh)
    else:
        model = tt.NMF(x, k)
        kw.update(schedule=driver, mesh=mesh)
    tt.parallel.reset_calls()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.factorize(**kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, collective_counts(tt)


def expected_calls(driver, axes, iters, kernels):
    """The collectives a run of ``iters`` iterations over a mesh of ``axes``
    axes of size 1 sends (inits given, so no broadcast): the data's minimum
    and the initial objective reduced over every axis; then an iteration:
    mesh= the objective over every axis, and on the plain route the two
    sums of each half whose axis the mesh has (the kernel route takes both
    halves locally); Ulysses W and H gathered and the objective reduced;
    rank two reconstructions; at the end the sharded factors gathered."""
    if driver == "mesh":
        per_iter = axes if kernels else 3 * axes
        return {"all_reduce": 2 * axes + per_iter * iters, "all_gather": axes,
                "all_to_all": 0, "p2p": 0, "broadcast": 0}
    if driver == "ulysses":
        return {"all_reduce": axes + 1 + iters, "all_gather": 1 + 2 * iters + 1,
                "all_to_all": 0, "p2p": 0, "broadcast": 0}
    return {"all_reduce": axes + 1 + 2 * iters, "all_gather": 2, "all_to_all": 0, "p2p": 0,
            "broadcast": 0}


def expected_launches(driver, dist, iters, kernels):
    """Kernel launches of a run: mesh= and Ulysses take the W and H update
    kernels once an iteration (both halves local on these meshes) and the
    objective kernel once an iteration and once for the initial iterate;
    the rank schedule is plain products."""
    if driver == "rank" or not kernels:
        return {}
    obj = "kl_obj" if dist == "kl" else "eu_residual_obj"
    return {"mur_w_update": iters, "mur_h_update": iters, obj: iters + 1}


def trace_gap(got, want, iters=ROUTE_ITERS):
    """The largest relative gap of two traces over their first ``iters``
    iterations (None: all of them, which must be as many)."""
    g = np.asarray(got, dtype=np.float64)[:None if iters is None else iters + 1]
    w = np.asarray(want, dtype=np.float64)[:None if iters is None else iters + 1]
    require(g.shape == w.shape, f"traces of {g.shape} and {w.shape}")
    return float(np.max(np.abs(g - w) / np.abs(w)))


def mesh_paths(torch, tt, drive, card, data, meshes):
    """The facade's mesh= and schedule= at the MUR shapes, on both meshes,
    each on its kernel route and its plain route, against one-device
    NMF(...).factorize('mur') from the same init: exact launches and
    collectives, ms an iteration beside the one-device run's."""
    from tpunmf_torch.init import random_init

    out = {}
    for label, name, k, dist, iters in MGPU_RUNS:
        x = data[name]
        init = random_init(0, *x.shape, k, device="cuda")
        kw = dict(method="mur", distance_type=dist, w_init=init[0], h_init=init[1],
                  min_iter=iters, max_iter=iters, tol1=0.0, tol2=0.0)
        tt.NMF(x, k).factorize(**{**kw, "min_iter": 2, "max_iter": 2})  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = tt.NMF(x, k).factorize(**kw)
        torch.cuda.synchronize()
        one_ms = 1e3 * (time.perf_counter() - t0) / iters
        print(f"  {label}: one device NMF.factorize('mur') {one_ms:.3f} ms an iteration, "
              f"obj[{iters}] {one.obj_history[-1]:.6e} ({card})", flush=True)
        out[label] = {"one_device_ms": one_ms}
        for shape, names in MGPU_MESHES:
            mesh = meshes[shape]
            for driver in ("mesh", "ulysses", "rank"):
                tag = f"{label} {driver} {shape}"
                mesh_run(torch, tt, x, k, mesh, driver, 2, init, None, dist)  # warm-up
                runs = {}
                for kernels in (True, False):
                    want = expected_launches(driver, dist, iters, kernels)
                    res, secs, sent = drive(
                        f"{tag} {'kernels' if kernels else 'plain'} path", tuple(want),
                        lambda: mesh_run(torch, tt, x, k, mesh, driver, iters, init,
                                         None if kernels else False, dist), exact=want)
                    calls = expected_calls(driver, len(shape), iters, kernels)
                    require(sent == calls, f"{tag}: collectives {sent}, not {calls}")
                    require(res.i == iters - 1 and np.all(np.isfinite(res.obj_history))
                            and np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h)),
                            f"{tag}: {res.i + 1} iterations or non-finite results")
                    runs[kernels] = (res, secs)
                (kern, ks), (plain, ps) = runs[True], runs[False]
                route = trace_gap(kern.obj_history, plain.obj_history)
                vs_one = trace_gap(kern.obj_history, one.obj_history)
                ms, plain_ms = 1e3 * ks / iters, 1e3 * ps / iters
                print(f"  {tag}: {ms:.3f} ms an iteration on the kernel route, {plain_ms:.3f} "
                      f"plain, {one_ms:.3f} one device; first {ROUTE_ITERS} iterations: "
                      f"kernels vs plain {route:.3e}, vs one device {vs_one:.3e} (tol "
                      f"{ROUTE_RTOL['float32']:.0e}); collectives {sent} ({card})", flush=True)
                require(route <= ROUTE_RTOL["float32"] and vs_one <= ROUTE_RTOL["float32"],
                        f"{tag}: routes disagree ({route:.3e}, {vs_one:.3e})")
                if dist == "eu":
                    hist = np.asarray(kern.obj_history, dtype=np.float64)
                    rises = np.diff(hist) / hist[:-1]
                    require(np.all(rises <= EU_MONOTONE_RTOL),
                            f"{tag}: EU objective rose by {rises.max():.3e}")
                out[label][f"{driver} {shape}"] = {
                    "ms": ms, "plain_ms": plain_ms, "route_err": route,
                    "vs_one_device": vs_one, "collectives": sent,
                    "obj": float(kern.obj_history[-1])}
        del init
    return out


def streamed_sharded(torch, label, card, csr, k, mesh, **kw):
    """One mur_streaming_sharded run, timed on the host clock."""
    from tpunmf_torch.solvers import mur_streaming_sharded

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mur_streaming_sharded(csr, k, mesh, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"  {label}: {res.i + 1} iterations in {secs:.2f} s, obj {res.obj_history[-1]:.6e} "
          f"({card})", flush=True)
    require(np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h))
            and np.all(np.isfinite(res.obj_history)), f"{label}: non-finite results")
    return res, secs


def streaming_paths(torch, tt, drive, card, adm_csr, kl_x, c4_csr, mesh):
    """mur_streaming_sharded: EU at config[3] against mur_streaming (f32 and
    bf16 transfer), KL config[1] kernels against plain (exact kl_ratio and
    kl_obj counts), then one iteration at config[4]'s data scale."""
    import scipy.sparse as sp

    from tpunmf_torch.init import random_init
    from tpunmf_torch.solvers import mur_streaming

    its = MGPU_STREAM_ITERS
    common = dict(min_iter=its, max_iter=its, tol1=0.0, tol2=0.0)
    out = {}
    k = CONFIG3["k"]
    w0, h0 = random_init(0, *adm_csr.shape, k, device="cuda")
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        kw = dict(distance_type="eu", w_init=w0, h_init=h0, transfer_dtype=dtype, **common)
        one, one_secs = streamed(torch, f"mur_streaming EU config[3] {name}", card, adm_csr, k,
                                 row_block=OOC_TILE, col_panel=OOC_TILE, **kw)
        res, secs = drive(f"sharded streaming EU config[3] {name} path", (),
                          lambda: streamed_sharded(torch, f"mur_streaming_sharded EU config[3] "
                                                   f"{name}", card, adm_csr, k, mesh, **kw),
                          exact={})
        out[f"eu_config3_{name}"] = {"secs": secs, "one_device_secs": one_secs,
                                     **agree(f"sharded streaming EU config[3] {name} against "
                                             "mur_streaming", res, one, MGPU_STREAM_RTOL)}
    kl_csr = sp.csr_matrix(kl_x.cpu().numpy())
    rb = -(-kl_csr.shape[0] // 8192)  # row blocks at the default row_block
    k = 50
    w0, h0 = random_init(1, *kl_csr.shape, k, device="cuda")
    kw = dict(distance_type="kl", w_init=w0, h_init=h0, **common)
    kern, secs = drive("sharded streaming KL config[1] path", ("kl_ratio", "kl_obj"),
                       lambda: streamed_sharded(torch, "mur_streaming_sharded KL config[1], "
                                                "kernels", card, kl_csr, k, mesh, **kw),
                       exact={"kl_ratio": 2 * rb * its, "kl_obj": rb * (its + 1)})
    plain, plain_secs = drive("sharded streaming KL config[1] plain path", (),
                              lambda: streamed_sharded(torch, "mur_streaming_sharded KL "
                                                       "config[1], plain", card, kl_csr, k,
                                                       mesh, use_pallas=False, **kw),
                              exact={})
    lagged, lagged_secs = drive(
        "sharded streaming KL config[1] lagged path", ("kl_ratio_and_obj", "kl_ratio"),
        lambda: streamed_sharded(torch, "mur_streaming_sharded KL config[1], lagged", card,
                                 kl_csr, k, mesh, objective="lagged", **kw),
        exact={"kl_ratio_and_obj": rb * its, "kl_ratio": rb * its})
    # lagged[i] is the objective of the iterate entering iteration i: exact[i]
    lag = np.asarray(lagged.obj_history, dtype=np.float64)
    exact = np.asarray(kern.obj_history[:its], dtype=np.float64)
    lag_err = float(np.max(np.abs(lag - exact) / np.abs(exact)))
    print(f"  sharded streaming KL lagged[i] against exact[i]: {lag_err:.3e} ({card})",
          flush=True)
    require(lag_err <= MGPU_STREAM_RTOL, f"lagged KL trace {lag_err:.3e} off the exact one")
    out["kl_config1"] = {"secs": secs, "plain_secs": plain_secs, "lagged_secs": lagged_secs,
                         "lagged_err": lag_err,
                         **agree("sharded streaming KL config[1] kernels against plain", kern,
                                 plain, MGPU_STREAM_RTOL)}
    del kl_csr, w0, h0
    torch.cuda.empty_cache()

    # config[4]'s data scale: one iteration, bf16 transfer, 8192-row panels
    m, n = c4_csr.shape
    k = OOC["k"]
    resting = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    passes = []
    with timed_passes(torch, passes):
        res, secs = drive("sharded streaming EU config[4]-scale path", (),
                          lambda: streamed_sharded(torch, f"mur_streaming_sharded EU {m}x{n} "
                                                   f"r{k} bf16", card, c4_csr, k, mesh,
                                                   distance_type="eu", key=0, min_iter=1,
                                                   max_iter=1, tol1=0.0, tol2=0.0,
                                                   transfer_dtype=torch.bfloat16),
                          exact={})
    peak = torch.cuda.max_memory_allocated()
    obj = [float(v) for v in res.obj_history]
    pass_secs = [e - s for s, e, _ in passes]
    pass_gb = 2 * m * n / 1e9
    rate = pass_gb / float(np.median(pass_secs))
    print(f"  {len(passes)} passes of {passes[0][2]} row panels (8192x{n} bf16): "
          f"{', '.join(f'{s:.2f}' for s in pass_secs)} s a pass, {pass_gb:.1f} GB a pass, "
          f"{rate:.2f} GB/s; peak memory {peak / 1e9:.3f} GB ({(peak - resting) / 1e9:.3f} above "
          f"the resting {resting / 1e9:.3f}); objective {obj} ({card})", flush=True)
    require(len(passes) == 2, f"{len(passes)} passes")
    require(peak - resting < MGPU_PEAK_BYTES, f"peak memory {peak / 1e9:.3f} GB")
    require(obj[1] <= obj[0], f"the objective rose: {obj}")
    out["config4_scale"] = {"shape": [m, n], "k": k, "pass_secs": pass_secs,
                            "gb_per_pass": pass_gb, "gb_s": rate, "peak_gb": peak / 1e9,
                            "resting_gb": resting / 1e9, "objective": obj, "run_secs": secs}
    return out


def sharded_serving(torch, tt, drive, card, mesh):
    """topk_retrieval over the mesh at (64, 2^20) r128, k 100: exact,
    quantized (bf16 first stage from a stored bf16 H) and 1% excluded, the
    indices those of the one-device path; ms a request."""
    from tpunmf_torch.serve import topk

    users, h, excl = serving_data(torch, 128, 1 << 20, seed=7, exclusion=True)
    w, excl = users[:SERVE_BATCH], excl[:SERVE_BATCH]
    hq = h.to(torch.bfloat16)
    out = {}
    for mode, kw, needed in (("exact", {}, ("score_blockmax_relayout",)),
                             ("quantized", {"first_stage_dtype": "bf16", "h_quantized": hq},
                              ("score_blockmax_relayout",)),
                             ("exclude 1%", {"exclude": excl}, ("blockmax_relayout",))):
        want = topk.topk_retrieval(None, w, h, 100, **kw)
        got = drive(f"sharded serving {mode} path", needed,
                    lambda: topk.topk_retrieval(mesh, w, h, 100, **kw))
        require(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
                f"sharded serving {mode}: not the one-device answer")
        ms = {}
        for name, m in (("sharded", mesh), ("one_device", None)):
            topk.topk_retrieval(m, w, h, 100, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                topk.topk_retrieval(m, w, h, 100, **kw)
            torch.cuda.synchronize()
            ms[name] = 1e3 * (time.perf_counter() - t0) / 10
        print(f"  sharded serving {mode} ({SERVE_BATCH} users, 2^20 items r128, k 100): the "
              f"one-device answer; {ms['sharded']:.3f} ms a request, one device "
              f"{ms['one_device']:.3f} ({card})", flush=True)
        out[mode] = ms
    return out


def multi_gpu_phase(torch, tt, drive, card, data, adm_csr, c4_csr):
    """Phase 9: an NCCL group of one rank through a file store, meshes
    (1,) and (1, 1), then the facade's mesh= and schedule=, the sharded
    streamed MUR and sharded serving."""
    import torch.distributed as dist

    out = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        tt.parallel.initialize_multihost(f"file://{d}/store", 1, 0)
        init_s = time.perf_counter() - t0
        meshes = {shape: tt.parallel.build_mesh(shape, names) for shape, names in MGPU_MESHES}
        mesh_s = time.perf_counter() - t0 - init_s
        probe = torch.ones(1, device="cuda")
        tt.parallel.collectives.all_reduce(probe, meshes[(1,)], "cols")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0 - init_s - mesh_s
        require(float(probe[0]) == 1.0, "a one-rank all_reduce changed its input")
        print(f"  NCCL group of one rank ({dist.get_backend()}, file store): "
              f"{1e3 * init_s:.1f} ms to init, {1e3 * mesh_s:.1f} ms for the two meshes, "
              f"{1e3 * first_s:.1f} ms for the first all_reduce ({card})", flush=True)
        out["nccl_startup_ms"] = {"init": 1e3 * init_s, "meshes": 1e3 * mesh_s,
                                  "first_all_reduce": 1e3 * first_s}
        try:
            out["mesh_paths"] = mesh_paths(torch, tt, drive, card, data, meshes)
            out["streaming"] = streaming_paths(torch, tt, drive, card, adm_csr, data["kl"],
                                               c4_csr, meshes[(1,)])
            out["serving"] = sharded_serving(torch, tt, drive, card, meshes[(1,)])
        finally:
            dist.destroy_process_group()
    return out


# Phase 10: the reference solvers across GPUs as a world of one: the facade's
# mesh= for hals, anls, admm, ao_admm and masked MUR, ntf_sharded and the
# lambda grid's mesh=, at the widths of phases 3, 5 and 7, each held to the
# one-device run and to its plain route from one init
MM_MESH_RTOL = 1e-6   # a mesh run against the one-device run, every iteration
# (label, X's name, k, method, options, iterations); ADMM and ANLS from
# their X's NNDSVD 'zero', masked MUR from a seeded |N(0, 1)| init
MM_RUNS = (
    ("HALS EU 8192^2 k128", "eu", 128, "hals", dict(inner_sweeps=2), 20),
    ("AO-ADMM EU 8192^2 k128", "eu", 128, "ao_admm", dict(distance_type="eu"), 10),
    ("ANLS EU chol config[2]", "ml1", ANLS_K, "anls",
     dict(distance_type="eu", use_fcnnls=True), 5),
    ("ANLS EU bpp config[2]", "ml1", ANLS_K, "anls",
     dict(distance_type="eu", nnls_solver="bpp"), 5),
    ("ANLS KL chol config[2]", "ml1", ANLS_K, "anls", dict(distance_type="kl"), 5),
    ("ADMM EU l1 on H config[3]", "adm", CONFIG3["k"], "admm",
     dict(distance_type="eu", rho=1.0, reg_w=(0, "nn"), reg_h=(0.1, "l1n")), 5),
    ("ADMM KL config[3]", "adm", CONFIG3["k"], "admm",
     dict(distance_type="kl", rho=1.0, reg_w=(0, "nn"), reg_h=(0.1, "l1n")), 3),
    ("AO-ADMM KL config[4] cut", "c4", CONFIG4["k"], "ao_admm", AO_KL_KW, 2),
    ("masked MUR EU ML-10M k64", "ml10", 64, "mur", dict(distance_type="eu"), 10),
    ("masked MUR KL ML-10M k64", "ml10", 64, "mur", dict(distance_type="kl"), 10),
)
MM_NTF_ITERS = 20
MM_NTF_RUNS = (("ntf_sharded EU mur", "eu", "mur"), ("ntf_sharded EU hals", "eu", "hals"),
               ("ntf_sharded KL mur", "kl", "mur"))
# the lambda grids of phase 5
MM_GRIDS = (("EU 8192^2 k128", "eu", 128, (0.0, 0.1, 1.0), 50),
            ("KL 8192x4096 k128", "kl", KL_SINGLE["k"], (0.0, 0.1), 20))


def _real_objectives(kw, iters):
    """The iterations of ``iters`` that record a real objective: every
    objective_every-th and the last possible one (tpunmf mur.py:96-131)."""
    every, top = int(kw.get("objective_every", 1)), kw.get("max_iter", 100000)
    return sum(1 for i in range(iters) if (i + 1) % every == 0 or i + 1 >= top)


def mesh_method_calls(method, kw, rows, cols, iters, trips=None, kernels=False, saves=0):
    """The collectives a facade mesh= run sends, by kind, on a mesh with
    the axes 'rows' / 'cols' that ``rows`` / ``cols`` say (of any size; a
    world of one has them of size 1), over ``iters`` iterations; AO-ADMM's
    inner ``trips`` as ``ao_admm.trips`` counted them (h_calls, h, w_calls,
    w); ``saves`` ``.npz`` checkpoint saves of a carry whose split leaves
    are W and H (each save gathers W over 'rows' and H over 'cols').
    Every driver: inits given (none sent) or made on rank 0 and
    broadcast (W and H), the initial objective all-reduced over each axis,
    the factors gathered at the end (W over 'rows', H over 'cols').  An
    iteration: HALS X H^T, H H^T over 'cols', W^T X, W^T W over 'rows', the
    objective over each axis (the Gram form: its two sums over 'cols');
    ANLS the same four products; ADMM the same four and, with adaptive rho,
    its two residuals' two sums; AO-ADMM a subproblem's Gram (and W^T V for
    EU) over its frame's rows once, each trip its stop test's norms (one
    all_reduce, which adaptive rho reuses) over its frame's columns and,
    for KL, the split's product over its rows; the local-sparsity W
    update's Gram once and, each trip, its three products over 'cols' and
    its norms (of W over 'rows' twice, of V over both once); masked MUR
    each half's two sums where it is not local (the kernel route on a
    world of one is), after the
    elevation's minimum and, on the kernel route, the binary-mask test over
    each axis.  MUR and HALS elevate X by a minimum over each axis.
    MUR (``mur_mesh``): on the plain route each half's two sums (EU X H^T,
    H H^T / W^T X, W^T W; KL R H^T and H's row sums / W^T R and W's column
    sums), on the kernel route (both halves local) none; then on an
    iteration that records a real objective (``objective_every``) the
    objective over each axis, or the Gram form's W^T W over 'rows' (the
    kernel route's, which the plain route has already) and two sums over
    'cols', or 'lagged' KL's incoming objective over each axis; the Gram
    form's ||X||^2 over each axis once.  beta= (``mur_beta_mesh``): the
    elevation, then each half's numerator and denominator over its axis and
    the divergence over each axis.  semi_nmf: H (when not given) and W
    (when not given, by least squares) broadcast, H H^T, X H^T over 'cols',
    W^T X, W^T W over 'rows', the objective over each axis.  onmf: the
    elevation, X H^T, H H^T and (W^T X) H^T over 'cols', W^T X over
    'rows', the objective over each axis (``orthogonal='w'``: the roles
    swapped).  robust: the non-negativity test over each axis, ||x_j||^2
    over 'rows', then W^T W and W^T X over 'rows' and the objective over
    'cols' (initially), an iteration W^T W, W^T X over 'rows' twice, X (HD)^T
    and H (HD)^T over 'cols', the objective over 'cols'."""
    r, c = int(rows), int(cols)
    axes = r + c
    ar = ag = 0
    bc = 0 if "w_init" in kw else 2
    kl = kw.get("distance_type", "kl" if method == "mur" else "eu") == "kl"
    reg_w, reg_h = kw.get("reg_w", (0, "nn"))[1], kw.get("reg_h", (0, "l2n"))[1]
    adaptive = kw.get("rho_mode") == "adaptive"
    if method == "hals":
        gram = kw.get("objective") == "gram"
        ar = axes + axes * gram + axes + iters * (2 * r + 2 * c + (2 * c if gram else axes))
    elif method == "anls":
        ar = axes + iters * (2 * r + 2 * c + axes)
    elif method == "admm":
        ar = axes + iters * (2 * r + 2 * c + axes + 2 * axes * adaptive)
        ag = iters * 2 * (c * (reg_h == "l1inf") + r * (reg_w == "l1inf"))
    elif method == "ao_admm":
        h_calls, h_trips, w_calls, w_trips = trips
        ar = axes + iters * axes
        ar += h_calls * r * (1 + (not kl)) + h_trips * (r * kl + c)
        ag = h_trips * c * (reg_h == "l1inf")
        if adaptive and reg_w == "l1inf":
            ar += w_calls * c + w_trips * (4 * c + 3 * r)
        else:
            ar += w_calls * c * (1 + (not kl)) + w_trips * (c * kl + r)
            ag += w_trips * r * (reg_w == "l1inf")
    elif method == "semi_nmf":
        bc = int("h_init" not in kw) + int("w_init" not in kw)
        ar = axes + iters * (2 * c + 2 * r + axes)
    elif method == "onmf":
        if kw.get("orthogonal") == "w":
            r, c = c, r
        ar = axes + axes + iters * (3 * c + r + axes)
    elif method == "robust":
        ar = axes + r + (2 * r + c) + iters * (4 * r + 3 * c)
    elif method == "mur" and kw.get("beta") is not None:
        ar = axes + axes + iters * (2 * c + 2 * r + axes)
    elif method == "mur" and "mask" not in kw:
        objective = kw.get("objective", "exact")
        real = _real_objectives(kw, iters)
        gram = not kl and objective == "gram"
        # 'lagged' sends what 'exact' sends: one objective over each axis
        per_obj = (2 * c + r * kernels) if gram else axes
        ar = axes + axes * gram + axes + iters * (0 if kernels else 2 * r + 2 * c)
        ar += real * per_obj
    else:  # masked MUR
        ar = axes + axes * kernels + axes + iters * (2 * (r + c) * (not kernels) + axes)
    ag += saves * axes
    return {"all_gather": ag + axes, "all_reduce": ar, "all_to_all": 0,
            "broadcast": bc, "p2p": 0}


def multilevel_calls(method, kw, rows, cols, iters, n, k, kernels=False):
    """``multilevel_mesh``'s collectives: its levels' runs, each a mesh run
    (:func:`mesh_method_calls`): the coarsest from the solver's default
    init for ``coarse_iters`` iterations, the finer coarse levels likewise
    from the prolongated factors, the finest ``iters`` from them (every
    level at tol 0 runs all its iterations).  ``n``: X's columns (rows for
    ``axis=0``)."""
    ml = dict(kw["multilevel"])
    levels, factor = ml.get("levels", 2), ml.get("factor", 4)
    coarse = ml.get("coarse_iters", 200)
    sizes = [n]
    for _ in range(levels):
        nxt = -(-sizes[-1] // factor)
        if nxt < max(2 * k, 8):
            break
        sizes.append(nxt)
    base = {key: v for key, v in kw.items() if key != "multilevel"}
    given = {**base, "w_init": True}
    total = mesh_method_calls(method, base, rows, cols, coarse, kernels=kernels)
    for _ in range(len(sizes) - 2):
        part = mesh_method_calls(method, given, rows, cols, coarse, kernels=kernels)
        total = {key: total[key] + part[key] for key in total}
    part = mesh_method_calls(method, given, rows, cols, iters, kernels=kernels)
    return {key: total[key] + part[key] for key in total}


def ntf_mesh_calls(kw, rows, cols, ndim, iters, saves=0):
    """``ntf_mesh``'s collectives (modes 0 and 1 split over 'rows' and
    'cols'): the non-negativity tests (X's, the mask's) over each axis,
    ||X||^2 over each axis, the initial objective (EU: the mode-0 and
    mode-1 Grams and the last MTTKRP, over both axes; else over each axis);
    an iteration: EU the two split Grams, each mode's MTTKRP over the axes
    that split the other modes, the updated split Grams; KL and masked each
    mode's MTTKRP and its denominator's sums likewise, the objective over
    each axis; the normalization's split column norms; the split factors
    gathered at the end; random factors broadcast a mode each."""
    r, c = int(rows), int(cols)
    axes = r + c
    masked = kw.get("mask") is not None
    eu = kw.get("distance_type", "eu") == "eu" and not masked
    ar = axes + axes * masked + axes
    ar += 2 * axes if eu else axes
    per = (ndim + 1) * axes if eu else (2 * (ndim - 1) + 1) * axes
    per += axes * kw.get("normalize", True)
    ar += iters * per
    return {"all_gather": axes + saves * axes, "all_reduce": ar, "all_to_all": 0,
            "broadcast": 0 if kw.get("factors_init") is not None else ndim, "p2p": 0}


def ntf_sharded_calls(dist, ndim, iters, factors_given):
    """ntf_sharded's collectives: the non-negativity test, the initial
    objective (EU: ||X||^2, the last MTTKRP and the mode-0 Gram; KL: the
    KL sum), then an EU iteration's mode-0 Gram twice and N-1 MTTKRPs, a KL
    iteration's N-1 MTTKRPs, N-1 mode-0 column sums and the KL sum; the
    mode-0 factor gathered at the end; random inits broadcast a mode each."""
    eu = dist == "eu"
    ar = 1 + (3 if eu else 1) + iters * ((ndim + 1) if eu else (2 * ndim - 1))
    return {"all_gather": 1, "all_reduce": ar, "all_to_all": 0,
            "broadcast": 0 if factors_given else ndim, "p2p": 0}


def grid_calls(init_given):
    """The lambda grid over a mesh: W, H and the traces gathered; a random
    init broadcast."""
    return {"all_gather": 3, "all_reduce": 0, "all_to_all": 0,
            "broadcast": 0 if init_given else 2, "p2p": 0}


def mm_launches(method, kw, iters, kernels, ndim=3):
    """Kernel launches of a phase-10 run on its route: HALS gs_sweep twice
    an iteration and eu_residual_obj once an iteration and once more; ANLS
    and AO-ADMM their objective kernel once an iteration (eu_residual_obj
    or kl_obj), ADMM eu_residual_obj or kl_ratio_and_obj; masked MUR both
    masked passes once an iteration (local halves); CP-HALS gs_sweep once a
    mode an iteration; the plain route nothing."""
    if not kernels:
        return {}
    kl = kw.get("distance_type", "kl" if method == "mur" else "eu") == "kl"
    if method == "hals":
        return {"gs_sweep": 2 * iters, "eu_residual_obj": iters + 1}
    if method in ("anls", "ao_admm"):
        return {"kl_obj" if kl else "eu_residual_obj": iters}
    if method == "admm":
        return {"kl_ratio_and_obj" if kl else "eu_residual_obj": iters}
    if method == "ntf":
        return {"gs_sweep": ndim * iters} if kw.get("update") == "hals" else {}
    return {"masked_w_update": iters, "masked_h_update": iters}


def mm_same_bits(a, b, fields):
    """Whether two results hold the same bits in ``fields`` (a list of
    arrays, as ntf's factors, compared one by one)."""
    def arrays(r, f):
        v = getattr(r, f)
        return [np.asarray(u) for u in v] if f == "factors" else [np.asarray(v)]

    return all(np.array_equal(p, q, equal_nan=np.issubdtype(p.dtype, np.floating))
               for f in fields for p, q in zip(arrays(a, f), arrays(b, f)))


def mm_timed(torch, tt, fn):
    from tpunmf_torch.solvers.ao_admm import trips

    tt.parallel.reset_calls()
    trips.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0, dict(tt.parallel.calls),
            [trips.h_calls, trips.h, trips.w_calls, trips.w])


def real_pattern(kw, iters):
    """Where a trace of ``iters`` iterations holds a real objective: the
    initial one and each iteration that objective_every records."""
    every, top = int(kw.get("objective_every", 1)), kw.get("max_iter", iters)
    return np.array([True] + [(i + 1) % every == 0 or i + 1 >= top for i in range(iters)])


def gap_where_real(got, want, shift=0, iters=None):
    """trace_gap over the entries both traces record, ``got`` read
    ``shift`` entries later ('lagged' against 'exact': lagged[i + 1] is
    exact[i]); the first ``iters`` iterations only where given."""
    g = np.asarray(got, dtype=np.float64)[shift:]
    w = np.asarray(want, dtype=np.float64)[:len(got) - shift]
    if iters is not None:
        g, w = g[:iters + 1], w[:iters + 1]
    real = ~(np.isnan(g) | np.isnan(w))
    require(real.any(), "no entry to compare")
    return float(np.max(np.abs(g[real] - w[real]) / np.abs(w[real])))


def mm_path(torch, tt, drive, card, label, x, k, method, kw, iters, meshes, one_device, run,
            ndim=None, fields=("w", "h"), launches=None, calls_of=None, plain_shift=0,
            one_device_ctx=contextlib.nullcontext):
    """One path: the one-device run on its kernel route, then each mesh's
    kernel and plain routes (``run(mesh, use_pallas)``), each with exact
    launches and collective calls; the mesh runs within MM_MESH_RTOL of one
    device at every iteration (bits compared), the kernel route within
    ROUTE_RTOL of the plain over the first ROUTE_ITERS iterations; ms an
    iteration.  ``launches(kernels)`` and ``calls_of(rows, cols, kernels,
    trips)`` give a run's counts where ``mm_launches`` and
    ``mesh_method_calls`` do not; ``plain_shift`` compares a 'lagged'
    kernel trace with the plain route's 'exact' one; ``one_device_ctx``
    wraps the one-device run (``two_pass_route`` puts it on the mesh's
    kernels); a trace may hold NaN only where ``objective_every`` puts it."""
    if launches is None:
        def launches(kernels):
            return mm_launches(method, kw, iters, kernels, ndim=ndim or 3)
    if calls_of is None:
        def calls_of(rows, cols, kernels, trips):
            if method == "ntf":
                return ntf_sharded_calls(kw["distance_type"], ndim, iters, True)
            return mesh_method_calls(method, kw, rows, cols, iters, trips, kernels)
    pattern = real_pattern(kw, iters)
    want = launches(True)
    run(meshes[(1,)], None, 1)  # warm-up: first-call costs out of the timing
    with one_device_ctx():
        one, one_s, _, _ = drive(f"{label} one device path", tuple(want),
                                 lambda: mm_timed(torch, tt, one_device), exact=want)
    one_ms = 1e3 * one_s / iters
    out = {"one_device_ms": one_ms}
    for shape, mesh in meshes.items():
        rows, cols = "rows" in mesh.mesh_dim_names, "cols" in mesh.mesh_dim_names
        runs = {}
        for kernels in (True, False):
            route = "kernels" if kernels else "plain"
            got, secs, sent, trips = drive(
                f"{label} {shape} {route} path", tuple(launches(kernels)),
                lambda: mm_timed(torch, tt, lambda: run(mesh, None if kernels else False,
                                                        iters)),
                exact=launches(kernels))
            calls = calls_of(rows, cols, kernels, trips)
            require(sent == calls, f"{label} {shape} {route}: collectives {sent}, not {calls}")
            hist = np.asarray(got.obj_history, dtype=np.float64)
            require(got.i == iters - 1 and np.array_equal(~np.isnan(hist), pattern)
                    and np.all(np.isfinite(hist[pattern])),
                    f"{label} {shape} {route}: {got.i + 1} iterations or a non-finite trace")
            runs[kernels] = (got, secs, sent)
        (kern, ks, sent), (plain, ps, _) = runs[True], runs[False]
        vs_one = gap_where_real(kern.obj_history, one.obj_history)
        vs_plain = gap_where_real(kern.obj_history, plain.obj_history, plain_shift, ROUTE_ITERS)
        bits = mm_same_bits(kern, one, ("obj_history",) + fields)
        ms, plain_ms = 1e3 * ks / iters, 1e3 * ps / iters
        print(f"  {label} {shape}: {ms:.3f} ms an iteration on the kernel route, "
              f"{plain_ms:.3f} plain, {one_ms:.3f} one device; against one device "
              f"{vs_one:.3e} (tol {MM_MESH_RTOL:.0e}, the same bits: "
              f"{'yes' if bits else 'no'}), kernels vs plain {vs_plain:.3e} over "
              f"{ROUTE_ITERS} iterations (tol {ROUTE_RTOL['float32']:.0e}); collectives "
              f"{sent} ({card})", flush=True)
        require(kern.i == one.i, f"{label} {shape}: stopped at {kern.i}, one device {one.i}")
        require(vs_one <= MM_MESH_RTOL, f"{label} {shape}: {vs_one:.3e} off one device")
        require(vs_plain <= ROUTE_RTOL["float32"],
                f"{label} {shape}: routes disagree ({vs_plain:.3e})")
        out[str(shape)] = {"ms": ms, "plain_ms": plain_ms, "vs_one_device": vs_one,
                           "same_bits": bits, "route_err": vs_plain, "collectives": sent}
    return out


def mm_factorize_path(torch, tt, drive, card, label, x, k, method, kw, iters, init, meshes,
                      mask=None):
    common = dict(method=method, w_init=init[0], h_init=init[1], min_iter=iters,
                  max_iter=iters, tol1=0.0, tol2=0.0, **kw)
    if mask is not None:
        common["mask"] = mask

    def one_device():
        return tt.NMF(x, k).factorize(**common)

    def run(mesh, use_pallas, its):
        return tt.NMF(x, k, mesh=mesh).factorize(
            **{**common, "use_pallas": use_pallas, "min_iter": its, "max_iter": its})

    # the formulas read the inits and the mask from the keywords
    counted = {**kw, "w_init": init[0], **({} if mask is None else {"mask": True})}
    return mm_path(torch, tt, drive, card, label, x, k, method, counted, iters, meshes,
                   one_device, run)


def mm_ntf_paths(torch, tt, drive, card, meshes):
    from tpunmf_torch import solvers

    x, init = cp_data(torch, NTF["dims"], NTF["k"], NTF["seed"], NTF["noise"])
    out = {}
    for label, dist, update in MM_NTF_RUNS:
        kw = dict(distance_type=dist, update=update, factors_init=init, tol1=0.0, tol2=0.0)

        def one_device():
            return solvers.ntf(x, NTF["k"], normalize=False, min_iter=MM_NTF_ITERS,
                               max_iter=MM_NTF_ITERS, **kw)

        def run(mesh, use_pallas, its):
            return tt.parallel.ntf_sharded(mesh, x, NTF["k"], use_pallas=use_pallas,
                                           min_iter=its, max_iter=its, **kw)

        out[label] = mm_path(torch, tt, drive, card, f"{label} 512^3 k{NTF['k']}", x,
                             NTF["k"], "ntf", kw, MM_NTF_ITERS, meshes, one_device, run,
                             ndim=3, fields=("factors",))
    del x, init
    return out


def mm_grid_paths(torch, tt, drive, card, data, meshes):
    """The lambda grid over the mesh's first axis against the unsharded
    grid: the same combinations' traces; combination-iterations a second."""
    from tpunmf_torch import experiments
    from tpunmf_torch.init import random_init

    out = {}
    for label, name, k, lambdas, iters in MM_GRIDS:
        x = data[name]
        init = random_init(0, *x.shape, k, device="cuda")
        kw = dict(lambda_w=lambdas, lambda_h=lambdas, distance_type=name, n_iter=iters,
                  w_init=init[0], h_init=init[1])
        n = len(lambdas) ** 2
        kl = name == "kl"
        want = ({"kl_ratio": 2 * n * iters, "kl_obj": n * iters} if kl
                else {"eu_residual_obj": n * iters})
        experiments.mur_lambda_grid(x, k, **{**kw, "n_iter": 1})  # warm-up
        one, one_s, _, _ = drive(f"lambda grid {label} one device path", tuple(want),
                                 lambda: mm_timed(torch, tt, lambda: experiments.mur_lambda_grid(
                                     x, k, **kw)), exact=want)
        out[label] = {"one_device_ci_s": n * iters / one_s}
        for shape, mesh in meshes.items():
            got, secs, sent, _ = drive(
                f"lambda grid {label} {shape} path", tuple(want),
                lambda: mm_timed(torch, tt, lambda: experiments.mur_lambda_grid(
                    x, k, mesh=mesh, grid_axis=mesh.mesh_dim_names[-1], **kw)), exact=want)
            require(sent == grid_calls(True), f"lambda grid {label} {shape}: collectives {sent}")
            gap = trace_gap(got[3].cpu().numpy(), one[3].cpu().numpy(), None)
            bits = all(torch.equal(a, b) for a, b in zip(got[1:], one[1:]))
            print(f"  lambda grid {label} {shape}, {n} combinations x {iters} iterations: "
                  f"{n * iters / secs:.1f} combination-iterations a second, one device "
                  f"{n * iters / one_s:.1f}; against one device {gap:.3e} (tol "
                  f"{MM_MESH_RTOL:.0e}, the same bits: {'yes' if bits else 'no'}); "
                  f"collectives {sent} ({card})", flush=True)
            require(got[0] == one[0] and gap <= MM_MESH_RTOL,
                    f"lambda grid {label} {shape}: {gap:.3e} off one device")
            out[label][str(shape)] = {"ci_s": n * iters / secs, "vs_one_device": gap,
                                      "same_bits": bits}
        del init
    return out


def all_reduce_probe(torch, tt, mesh, card, calls=200):
    """Host microseconds of a one-element all_reduce over the one-rank
    mesh: alone (enqueued back to back, then one synchronize) and followed
    by a host read each, as AO-ADMM's stop test reads its norms."""
    from tpunmf_torch.parallel.collectives import all_reduce

    t = torch.ones(1, device="cuda")
    out = {}
    for read in (False, True, False, True):
        all_reduce(t, mesh, "cols")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            all_reduce(t, mesh, "cols")
            if read:
                float(t[0])
        torch.cuda.synchronize()
        out["with_read" if read else "alone"] = 1e6 * (time.perf_counter() - t0) / calls
    print(f"  a one-element all_reduce over the one-rank NCCL mesh: {out['alone']:.1f} us "
          f"alone, {out['with_read']:.1f} us with a host read after each (second of two "
          f"rounds of {calls}; {card})", flush=True)
    return out


def methods_phase(torch, tt, drive, card, data, adm_csr):
    """Phase 10: an NCCL group of one rank through a file store, meshes (1,)
    'cols' and (1, 1) 'rows' x 'cols', then every path of MM_RUNS through
    the facade's mesh=, ntf_sharded at 512^3 r64 and the lambda grids.
    ``data``: the 8192^2 EU X ("eu") and the 8192x4096 KL X ("kl")."""
    import torch.distributed as dist

    from tpunmf_torch.data import densify, movielens_like
    from tpunmf_torch.init import nndsvd, random_init

    out = {}
    with tempfile.TemporaryDirectory() as d:
        tt.parallel.initialize_multihost(f"file://{d}/store", 1, 0)
        meshes = {shape: tt.parallel.build_mesh(shape, names) for shape, names in MGPU_MESHES}
        try:
            out["all_reduce_us"] = all_reduce_probe(torch, tt, meshes[(1,)], card)
            t0 = time.perf_counter()
            made = {"eu": lambda: data["eu"],
                    "ml1": lambda: torch.from_numpy(movielens_like(6040, 3706, density=0.2,
                                                                   seed=2)).cuda(),
                    "adm": lambda: torch.from_numpy(densify(adm_csr)).cuda(),
                    "c4": lambda: config4_on_card(torch),
                    "ml10": lambda: movielens_on_card(torch, *ML10M, seed=3)}
            for name in dict.fromkeys(run[1] for run in MM_RUNS):
                t1 = time.perf_counter()
                x, mask = made[name](), None
                if name == "ml10":
                    x, mask = x
                torch.cuda.synchronize()
                print(f"  {name} made in {time.perf_counter() - t1:.1f} s", flush=True)
                inits = {}
                for label, n, k, method, kw, iters in MM_RUNS:
                    if n != name:
                        continue
                    if k not in inits:
                        inits[k] = (random_init(0, *x.shape, k, device="cuda")
                                    if mask is not None else nndsvd(x, k, variant="zero"))
                    # row-major, as the mesh places them (cuBLAS rounds by layout)
                    init = tuple(f.contiguous() for f in inits[k])
                    if method == "hals":  # as HALS nudges the inits it makes
                        init = tuple(torch.clamp(f, min=1e-16) for f in init)
                    out[label] = mm_factorize_path(torch, tt, drive, card, label, x, k, method,
                                                   kw, iters, init, meshes, mask=mask)
                del x, mask, inits
                torch.cuda.empty_cache()
            out["ntf_sharded"] = mm_ntf_paths(torch, tt, drive, card, meshes)
            grid_meshes = {(1,): tt.parallel.build_mesh((1,), ("grid",)),
                           (1, 1): meshes[(1, 1)]}
            out["lambda_grid"] = mm_grid_paths(torch, tt, drive, card, data, grid_meshes)
            print(f"  phase 10's paths took {time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            dist.destroy_process_group()
    return out


# Phase 11: every other method and keyword across GPUs as a world of one
MR_ITERS = 20
# (label, X's name, k, method, options, iterations); from one seeded |N(0, 1)|
# init (ntf: cp_data's), the one-device MUR on the 2-pass pair
MR_RUNS = (
    ("semi_nmf EU 8192^2 k128", "semi", 128, "semi_nmf", {}, MR_ITERS),
    ("onmf h 8192^2 k128", "eu", 128, "onmf", {}, MR_ITERS),
    ("onmf w 8192^2 k128", "eu", 128, "onmf", {"orthogonal": "w"}, MR_ITERS),
    ("robust 8192^2 k128", "eu", 128, "robust", {}, MR_ITERS),
    ("beta 0.5 8192^2 k128", "eu", 128, "mur", {"beta": 0.5}, MR_ITERS),
    ("beta 0 8192^2 k128", "eu", 128, "mur", {"beta": 0.0}, MR_ITERS),
    ("MUR EU gram 8192^2 k128", "eu", 128, "mur",
     {"distance_type": "eu", "objective": "gram"}, 24),
    ("MUR KL lagged 8192^2 k128", "eu", 128, "mur",
     {"distance_type": "kl", "objective": "lagged"}, 24),
    ("MUR KL objective_every=8 8192^2 k128", "eu", 128, "mur",
     {"distance_type": "kl", "objective_every": 8}, 24),
    ("MUR KL lagged config[1] k50", "kl", 50, "mur",
     {"distance_type": "kl", "objective": "lagged"}, MR_ITERS),
    ("multilevel mur EU 8192^2 k128", "eu", 128, "mur",
     {"distance_type": "eu", "multilevel": {"levels": 2, "factor": 4, "coarse_iters": 10}},
     MR_ITERS),
    ("multilevel hals 8192^2 k128", "eu", 128, "hals",
     {"multilevel": {"levels": 2, "factor": 4, "coarse_iters": 10}}, MR_ITERS),
)
MR_NTF_ITERS = 10
MR_NTF_RUNS = (("ntf EU mur", dict(distance_type="eu", update="mur")),
               ("ntf EU hals", dict(distance_type="eu", update="hals")),
               ("ntf KL mur", dict(distance_type="kl", update="mur")),
               ("ntf masked EU mur", dict(distance_type="eu", update="mur", mask=0.7)))
# HALS's checkpoints: blocks of MR_CK_EVERY, stopped after two, of 3 blocks
MR_CK_EVERY = 10


def mr_launches(method, kw, iters, kernels, n=None, k=None):
    """Kernel launches of a phase-11 run on a world of one: semi_nmf and
    onmf eu_residual_obj once an iteration and once more; robust and beta=
    none; MUR the two update kernels once an iteration (both halves local),
    its objective pass (eu_residual_obj or kl_obj) initially and on each
    iteration that records an exact objective, the lagged W pass in place
    of the W pass where 'lagged' records one; multilevel every level's
    (the coarse levels of ``n`` columns at rank ``k``, coarse_iters each);
    ntf CP-HALS gs_sweep once a mode an iteration; the plain route nothing."""
    if not kernels:
        return {}
    if "multilevel" in kw:
        ml = kw["multilevel"]
        sizes = [n]
        for _ in range(ml["levels"]):
            if -(-sizes[-1] // ml["factor"]) < max(2 * k, 8):
                break
            sizes.append(-(-sizes[-1] // ml["factor"]))
        total = {}
        base = {key: v for key, v in kw.items() if key != "multilevel"}
        for its in [ml["coarse_iters"]] * (len(sizes) - 1) + [iters]:
            for name, c in mr_launches(method, base, its, True).items():
                total[name] = total.get(name, 0) + c
        return total
    if method in ("semi_nmf", "onmf"):
        return {"eu_residual_obj": iters + 1}
    if method in ("robust",) or kw.get("beta") is not None:
        return {}
    if method == "hals":
        return {"gs_sweep": 2 * iters, "eu_residual_obj": iters + 1}
    if method == "ntf":
        return {"gs_sweep": 3 * iters} if kw.get("update") == "hals" else {}
    kl = kw.get("distance_type", "kl") == "kl"
    real = _real_objectives({**kw, "max_iter": iters}, iters)
    obj = "kl_obj" if kl else "eu_residual_obj"
    out = {"mur_w_update": iters, "mur_h_update": iters, obj: 1}
    if kl and kw.get("objective") == "lagged":
        out["mur_w_update"] -= real
        out["mur_w_update_lagged"] = real
    elif kw.get("objective") != "gram" or kl:
        out[obj] += real
    return {name: c for name, c in out.items() if c}


def mr_factorize_path(torch, tt, drive, card, label, x, k, method, kw, iters, init, meshes):
    common = dict(method=method, min_iter=iters, max_iter=iters, tol1=0.0, tol2=0.0, **kw)
    ml = "multilevel" in kw
    if not ml:
        common.update(w_init=init[0], h_init=init[1])

    def one_device():
        return tt.NMF(x, k).factorize(**common)

    # robust NMF and beta= have no kernel (nor use_pallas): both routes are one
    switch = method != "robust" and kw.get("beta") is None

    def run(mesh, use_pallas, its):
        extra = {"use_pallas": use_pallas} if switch else {}
        return tt.NMF(x, k, mesh=mesh).factorize(
            **{**common, **extra, "min_iter": its, "max_iter": its})

    full = {**kw, "max_iter": iters, **({} if ml else {"w_init": True, "h_init": True})}
    n = x.shape[1] if ml else None

    def calls_of(rows, cols, kernels, trips):
        if ml:
            return multilevel_calls(method, full, rows, cols, iters, n, k, kernels=kernels)
        return mesh_method_calls(method, full, rows, cols, iters, trips, kernels)

    lagged = kw.get("objective") == "lagged"
    return mm_path(torch, tt, drive, card, label, x, k, method, full, iters, meshes,
                   one_device, run,
                   launches=lambda kernels: mr_launches(method, full, iters, kernels, n, k),
                   calls_of=calls_of, plain_shift=1 if lagged else 0,
                   one_device_ctx=two_pass_route if method == "mur" else contextlib.nullcontext)


def mr_ntf_paths(torch, tt, drive, card, meshes):
    from tpunmf_torch import solvers

    x, init = cp_data(torch, NTF["dims"], NTF["k"], NTF["seed"], NTF["noise"])
    out = {}
    for label, options in MR_NTF_RUNS:
        kw = dict(options, factors_init=init, tol1=0.0, tol2=0.0)
        if "mask" in kw:
            g = torch.Generator(device="cuda").manual_seed(NTF["seed"])
            kw["mask"] = (torch.rand(x.shape, generator=g, device="cuda")
                          < kw["mask"]).float()

        def one_device(kw=kw):
            return solvers.ntf(x, NTF["k"], min_iter=MR_NTF_ITERS, max_iter=MR_NTF_ITERS, **kw)

        def run(mesh, use_pallas, its, kw=kw):
            return tt.NMF(x, NTF["k"], mesh=mesh).factorize(
                method="ntf", use_pallas=use_pallas, min_iter=its, max_iter=its, **kw)

        out[label] = mm_path(
            torch, tt, drive, card, f"{label} 512^3 k{NTF['k']}", x, NTF["k"], "ntf", kw,
            MR_NTF_ITERS, meshes, one_device, run, ndim=3, fields=("factors",),
            launches=lambda kernels, kw=kw: mr_launches("ntf", kw, MR_NTF_ITERS, kernels),
            calls_of=lambda rows, cols, kernels, trips, kw=kw: ntf_mesh_calls(
                kw, rows, cols, 3, MR_NTF_ITERS))
    del x, init
    return out


class _Stop(Exception):
    pass


def mr_checkpoints(torch, tt, drive, card, x, mesh, d):
    """HALS EU over (1, 1) in blocks of MR_CK_EVERY, three blocks: the
    uninterrupted run with checkpoints through each backend, a run stopped
    after two blocks and resumed, which must give its bits, with exact
    launches and collectives; then the .npz, resumed in one-device hals,
    must give one device's bits.  The seconds a save costs: the
    checkpointed run's against one without saves (the first save of a
    backend in the process inside), and three saves of the final carry
    through ``MeshStore`` timed alone after them."""
    from tpunmf_torch.init import random_init
    from tpunmf_torch.solvers import hals

    k, iters = 128, 3 * MR_CK_EVERY
    w0, h0 = random_init(0, *x.shape, k, device="cuda")
    kw = dict(method="hals", w_init=w0, h_init=h0, min_iter=iters, max_iter=iters, tol1=0.0,
              tol2=0.0)
    counted = {**kw, "w_init": True}
    model = tt.NMF(x, k, mesh=mesh)

    def timed(**extra):
        return mm_timed(torch, tt, lambda: model.factorize(**kw, **extra))

    def launches(its, runs=1):
        return {"gs_sweep": 2 * its, "eu_residual_obj": its + runs}

    model.factorize(**{**kw, "min_iter": 2, "max_iter": 2})  # warm-up
    bare, bare_s, _, _ = drive("HALS checkpoints: no saves path", ("gs_sweep",),
                               lambda: timed(), exact=launches(iters))
    out = {"bare_ms": 1e3 * bare_s / iters}
    for backend in ("npz", "dcp"):
        saves = 3 if backend == "npz" else 0
        ck = dict(checkpoint_every=MR_CK_EVERY, checkpoint_backend=backend)
        full, full_s, sent, _ = drive(
            f"HALS checkpoints {backend} uninterrupted path", ("gs_sweep",),
            lambda: timed(checkpoint_path=os.path.join(d, f"full_{backend}"), **ck),
            exact=launches(iters))
        want = mesh_method_calls("hals", counted, True, True, iters, saves=saves)
        require(sent == want, f"HALS checkpoints {backend}: collectives {sent}, not {want}")
        path = os.path.join(d, f"stopped_{backend}")
        seen = []

        def stop(carry):
            seen.append(carry.i)
            if len(seen) == 2:
                raise _Stop

        def stopped_and_resumed():
            try:
                model.factorize(checkpoint_path=path, on_block_end=stop, **ck, **kw)
            except _Stop:
                pass
            return model.factorize(checkpoint_path=path, resume=True, **ck, **kw)

        got, _, _, _ = drive(f"HALS checkpoints {backend} stopped and resumed path",
                             ("gs_sweep",), lambda: mm_timed(torch, tt, stopped_and_resumed),
                             exact=launches(iters, runs=2))
        bits = mm_same_bits(got, full, ("obj_history", "w", "h"))
        per_save = (full_s - bare_s) / 3
        print(f"  HALS EU 8192^2 k128 (1, 1) checkpoints through {backend}: stopped at "
              f"{seen}, resumed to {got.i + 1}; the uninterrupted run's bits: "
              f"{'yes' if bits else 'no'}; {1e3 * full_s / iters:.3f} ms an iteration with a "
              f"save every {MR_CK_EVERY}, {1e3 * bare_s / iters:.3f} without: "
              f"{per_save:.3f} s a save ({card})", flush=True)
        require(seen == [MR_CK_EVERY, 2 * MR_CK_EVERY] and bits,
                f"HALS checkpoints {backend}: the resumed run is not the uninterrupted one")
        out[backend] = {"save_s": per_save, "same_bits": bits,
                        "ms": 1e3 * full_s / iters}
    # a mesh run stopped after two blocks, its .npz resumed in one-device hals
    path = os.path.join(d, "mesh_to_one_device")
    seen.clear()
    try:
        model.factorize(checkpoint_path=path, checkpoint_every=MR_CK_EVERY, on_block_end=stop,
                        **kw)
    except _Stop:
        pass
    solver_kw = {key: v for key, v in kw.items() if key != "method"}
    one = hals(x, k, **solver_kw)
    resumed = hals(x, k, checkpoint_path=path, checkpoint_every=MR_CK_EVERY, resume=True,
                   **solver_kw)
    bits = mm_same_bits(resumed, one, ("obj_history", "w", "h"))
    print(f"  the (1, 1) mesh's .npz resumed in one-device hals: one device's bits: "
          f"{'yes' if bits else 'no'} ({card})", flush=True)
    require(bits, "the mesh's .npz does not resume in one-device hals with its bits")
    out["npz_in_one_device"] = bits
    # a save alone: the final carry through each backend's store, three times
    final = []
    model.factorize(block_size=iters, on_block_end=final.append, **kw)
    layouts = [("rows", None), (None, "cols")]
    for backend in ("npz", "dcp"):
        store = tt.parallel.MeshStore(mesh, layouts, backend)
        times = []
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            store.save(os.path.join(d, f"alone_{backend}"), final[0], "HALS")
            times.append(time.perf_counter() - t0)
        print(f"  a save of HALS 8192^2 k128's carry (8.4 MB) through {backend} alone: "
              f"{', '.join(f'{1e3 * t:.1f}' for t in times)} ms ({card})", flush=True)
        out[backend]["alone_ms"] = [1e3 * t for t in times]
    return out


def mesh_rest_phase(torch, tt, drive, card, data):
    """Phase 11: an NCCL group of one rank through a file store, the meshes
    of phase 10, then MR_RUNS through the facade's mesh=, MR_NTF_RUNS and
    HALS's checkpoints.  ``data``: the 8192^2 EU X ("eu") and BASELINE
    config[1] ("kl")."""
    import torch.distributed as dist

    from tpunmf_torch.init import random_init

    out = {}
    with tempfile.TemporaryDirectory() as d:
        tt.parallel.initialize_multihost(f"file://{d}/store", 1, 0)
        meshes = {shape: tt.parallel.build_mesh(shape, names) for shape, names in MGPU_MESHES}
        try:
            t0 = time.perf_counter()
            made = {"eu": data["eu"], "kl": data["kl"],
                    "semi": data["eu"] - data["eu"].mean(dim=0)}
            for label, name, k, method, kw, iters in MR_RUNS:
                x = made[name]
                init = random_init(0, *x.shape, k, device="cuda")
                out[label] = mr_factorize_path(torch, tt, drive, card, label, x, k, method, kw,
                                               iters, init, meshes)
                del init
            del made
            torch.cuda.empty_cache()
            out["ntf"] = mr_ntf_paths(torch, tt, drive, card, meshes)
            out["checkpoints"] = mr_checkpoints(torch, tt, drive, card, data["eu"],
                                                meshes[(1, 1)], d)
            out["seconds"] = time.perf_counter() - t0
            print(f"  phase 11's paths took {out['seconds']:.1f} s", flush=True)
        finally:
            dist.destroy_process_group()
    return out


# Phase 12: the CLI's bench, in-process, at its own full sizes
BENCH_HEADLINE = dict(m=8192, n=8192, k=128)  # tpunmf_torch.bench's headline MUR EU, bf16 X
BENCH_FRACTION_MAX = 1.05  # a fraction of a ceiling (roofline, product peak) past which
                           # the timing, not the program, is wrong
# the bench's solver rates here run ADMM and the two AO-ADMM families on
# fewer extra iterations than bench.py's 3000, 2000 and 1000 (RATE_DELTAS,
# which python -m tpunmf_torch bench keeps): sized for the TPU's on-device
# loops, the AO-ADMM pair took 459 s at the card's 65 and 24 it/s
# (host-bound inner loops); at 200 and 100, and ADMM at 3000, the three
# took 108 s of phase 12's 220, which phase 13's time came out of
BENCH_DELTAS = {"admm": 1000, "ao_admm": 100, "ao_admm_local_l1inf": 50}


def bench_phase(torch, counters, card):
    """Phase 12: ``python -m tpunmf_torch bench --deltas ...`` (BENCH_DELTAS)
    through the CLI's main, in-process, its line captured and printed;
    every count set to 0 just before it and read just after.  The
    headline's MUR kernel (the route mur_route gives bf16 X at 8192^2
    r128), the read probe, the fused
    scoring kernel and gs_sweep (HALS's rate) must have launched, and no
    kernel behind the port's switches or of the sweep scripts."""
    import io

    from tpunmf_torch.__main__ import main as cli_main
    from tpunmf_torch.bench import RATE_DELTAS, errors
    from tpunmf_torch.solvers.mur import mur_route

    h = BENCH_HEADLINE
    route, strips = mur_route(torch.empty((h["m"], h["n"]), dtype=torch.bfloat16,
                                          device="meta"), h["k"], "eu")
    headline = {"single": ("mur_iteration_eu_dma" if isinstance(strips, tuple)
                           else "mur_iteration_eu"),
                "pair": "mur_w_update"}[route]
    needed = ("read_probe", headline, "score_blockmax_relayout", "gs_sweep")
    deltas = {**RATE_DELTAS, **BENCH_DELTAS}
    arg = ",".join(f"{name}={count}" for name, count in BENCH_DELTAS.items())
    print(f"  bench --deltas {arg}: the solver rates' deltas {deltas} (bench.py's "
          f"{RATE_DELTAS})", flush=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    reset_counters(counters)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["bench", "--deltas", arg])
    finally:
        launched = counts(counters)
        seconds = time.perf_counter() - t0
        print(buf.getvalue(), end="", flush=True)  # the bench's line, or what it printed
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"  bench: launches {launched} ({seconds:.1f} s, {card})", flush=True)
    require(rc == 0, f"bench: the CLI returned {rc}")
    require(not errors(line), f"bench: errors at {errors(line)}")
    require(line["value"] > 0 and line["vs_baseline"] > 0,
            f"bench: headline {line['value']}, vs_baseline {line['vs_baseline']}")
    extra = line["extra"]
    require(extra["probes_undershoot_solver"]
            or extra["roofline_fraction_measured_bw"] <= BENCH_FRACTION_MAX,
            f"bench: roofline fraction {extra['roofline_fraction_measured_bw']} against "
            "the measured ceiling, with no undershoot")
    mfu = extra["rank512_compute_bound"]["mfu_vs_measured_mxu"]
    require(mfu <= BENCH_FRACTION_MAX, f"bench: rank-512 MFU {mfu}")
    require(extra.get("solver_rate_deltas") == deltas,
            f"bench: the line names deltas {extra.get('solver_rate_deltas')}, not {deltas}")
    for name in needed:
        require(launched[name] > 0, f"bench: {name} was not launched")
    for name in OPT_IN + tuple(n for n in SWEEP_ONLY if n != "read_probe"):
        require(launched[name] == 0, f"bench: {name} was launched off its path")
    return {"seconds": seconds, "route": route, "launches": launched, "deltas": deltas}, launched


# Phase 13: BASELINE's configs to convergence (tpunmf_torch.sweeps.run_configs)
# and the HALS time-to-objective bench (tpunmf_torch.sweeps.bench_hals)
def config_kernels():
    """The kernels each config's kernel route must launch: MUR's route at
    config 0's and config 1's shapes (mur_route) and the objective pass."""
    import torch

    from tpunmf_torch.solvers.mur import mur_route

    def mur_kernels(m, n, k, dist):
        route, strips = mur_route(torch.empty((m, n), device="meta"), k, dist)
        single = {"eu": ("mur_iteration_eu_dma" if isinstance(strips, tuple)
                         else "mur_iteration_eu"),
                  "kl": "mur_iteration_kl"}[dist]
        return (single,) if route == "single" else PAIR

    return {0: mur_kernels(2000, 1000, 20, "eu") + ("eu_residual_obj",),
            1: mur_kernels(20000, 11000, 50, "kl") + ("kl_obj",),
            2: ("eu_residual_obj",), 3: ("eu_residual_obj",), 4: ("kl_obj",)}


def configs_phase(torch, tt, counters, card, kl_x, adm_csr):
    """Phase 13: run_configs' five configs at scale 1.0 (config[1] on phase
    3's matrix, config[3] densified again from phase 1's CSR, as phase 10
    does), each within the float64 gate, then bench_hals' three runs; every
    count set to 0 just before each and read just after.  Returns (record,
    launches over the phase)."""
    import torch.distributed as dist

    from tpunmf_torch.data import densify
    from tpunmf_torch.sweeps import bench_hals, run_configs

    needed = config_kernels()
    out, total = {"configs": {}}, {name: 0 for name in counters}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tt.parallel.initialize_multihost(f"file://{d}/store", 1, 0)
        try:
            for idx, fn in enumerate(run_configs.runners()):
                given = {1: lambda: dict(x=kl_x),
                         3: lambda: dict(x=torch.from_numpy(densify(adm_csr)).cuda())}
                given = given[idx]() if idx in given else {}
                reset_counters(counters)
                t0 = time.perf_counter()
                r = fn(1.0, device="cuda", **given)
                seconds = time.perf_counter() - t0
                launched = {n: c for n, c in counts(counters).items() if c}
                for n, c in launched.items():
                    total[n] += c
                held, tol = run_configs.gate(r)
                ours = r["fixed"] if idx == 3 else r
                err = "final_kl" if "final_kl" in r else "rel_err"
                plain = r["plain_f32"]
                extra = ""
                if idx == 2:
                    extra = f"; recall@10 against float64's factors {r['recall10_vs_ref']:.4f}"
                if idx == 3:
                    extra = (f"; adaptive rho i={r['rho_damped']['i']} rel_err "
                             f"{r['rho_damped']['rel_err']:.9e}; 25-iteration trajectory "
                             f"{r['trajectory_max_rel_dev']:.3e} (plain f32 "
                             f"{plain['trajectory_max_rel_dev']:.3e}, float64 on X(1 + 1e-15) "
                             f"{r['ref_self_divergence']:.3e})")
                if idx == 4:
                    extra = (f"; mesh {tuple(r['mesh'])} i={r['sharded_i']} final_kl "
                             f"{r['sharded_final_kl']:.9e}, within rtol 1e-6: "
                             f"{r['sharded_matches']}, one device's bits: "
                             f"{r['sharded_same_bits']} ({r['sharded_wall_s']:.1f} s)")
                print(f"  config {idx} {r['config']} {tuple(r['shape'])}: NNDSVD in float64 "
                      f"{r['init_s']:.1f} s; kernels i={ours['i']} {err} {ours[err]:.9e} "
                      f"({ours['wall_s']:.1f} s), float64 i={r['ref_i']} {r['ref_' + err]:.9e} "
                      f"({r['ref_wall_s']:.1f} s), plain f32 i={plain['i']} {plain[err]:.9e} "
                      f"({plain['wall_s']:.1f} s); deviation {r['final_err_deviation']:.3e} "
                      f"(plain f32 {plain['final_err_deviation']:.3e}), gate {tol:.3e}: "
                      f"{'held' if held else 'MISSED'}; iters_match {r['iters_match']}{extra}; "
                      f"launches {launched}; {seconds:.1f} s [{card}]", flush=True)
                require(held, f"config {idx}: {r['final_err_deviation']:.3e} off float64, "
                              f"gate {tol:.3e}")
                for name in needed[idx]:
                    require(launched.get(name, 0) > 0, f"config {idx}: {name} was not launched")
                if idx == 4:
                    require(r["sharded_matches"] and r["sharded_same_bits"],
                            "config 4: the mesh run is not the one-device run")
                out["configs"][idx] = {**r, "launches": launched, "seconds": seconds}
                del given
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    x, w0, h0 = bench_hals.problem()
    recs = {}
    for name in bench_hals.CONFIGS:
        reset_counters(counters)
        recs[name] = bench_hals.measure(name, x, w0, h0)
        launched = {n: c for n, c in counts(counters).items() if c}
        for n, c in launched.items():
            total[n] += c
        obj = np.asarray(recs[name]["obj"])
        rises = float(np.max((obj[1:] - obj[:-1]) / obj[:-1]))
        print(f"  bench_hals {name}: {recs[name]['it_per_s']} it/s over {bench_hals.ITERS} "
              f"iterations ({recs[name]['s_total']:.3f} s), obj {obj[0]:.6e} -> {obj[-1]:.6e}, "
              f"largest rise {rises:.3e}; launches {launched} [{card}]", flush=True)
        require(np.all(np.isfinite(obj)) and rises <= EU_MONOTONE_RTOL,
                f"bench_hals {name}: the trace rises by {rises:.3e}")
        require(launched.get("gs_sweep" if name.startswith("hals") else "eu_residual_obj", 0) > 0,
                f"bench_hals {name}: its kernels were not launched")
        recs[name]["launches"] = launched
    target = recs["mur_eu"]["obj"][-1]
    for name in ("hals_s1", "hals_s2"):
        reach = bench_hals.time_to(recs[name], target)
        recs[name]["to_mur_objective"] = reach
        print(f"  bench_hals {name}: MUR-EU's objective after {bench_hals.ITERS} iterations "
              f"({target:.6e}) "
              + (f"after {reach[0]} iterations, {reach[1]:.3f} s against MUR's "
                 f"{recs['mur_eu']['s_total']:.3f} s" if reach else "not reached"), flush=True)
    del x, w0, h0
    torch.cuda.empty_cache()
    out["bench_hals"] = {name: {k: v for k, v in rec.items() if k != "obj"} | {
        "obj_first_last": [rec["obj"][0], rec["obj"][-1]]} for name, rec in recs.items()}
    out["bench_hals_seconds"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    return out, total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "tpunmf_torch")):
        print("chip_smoke: tpunmf_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import tpunmf_torch as tt
    import tpunmf_torch.parallel  # noqa: F401  (tt.parallel, phase 9)
    from tpunmf_torch.data import lowrank_dense, movielens_like, tfidf_like
    from tpunmf_torch.init import nndsvd
    from tpunmf_torch.ops import _build, masked_fused, read_probe
    from tpunmf_torch.sweeps import sweep_int8, sweep_iter2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counters = kernel_counters()

    t_start = time.perf_counter()
    card = nvidia_smi_line()
    print(f"phase 1: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    # nvcc builds tpunmf_torch/ops/csrc (one process a source) while the
    # host makes the data; every kernel must have built before phase 2
    t_build = time.perf_counter()
    nvcc_pool = concurrent.futures.ThreadPoolExecutor(1)
    built = nvcc_pool.submit(_build.library)

    t0 = time.perf_counter()
    eu_np = lowrank_dense(8192, 8192, 128, seed=0)
    eu_x = torch.from_numpy(eu_np).cuda()
    kl_x = torch.from_numpy(tfidf_like(20000, 11000, n_topics=50, seed=1)).cuda()
    eu_k, kl_k = 128, 50
    wide_x = torch.from_numpy(lowrank_dense(EU_WIDE["m"], EU_WIDE["n"], EU_WIDE["k"],
                                            seed=EU_WIDE["seed"])).cuda()
    kl2_x = torch.from_numpy(tfidf_like(KL_SINGLE["m"], KL_SINGLE["n"],
                                        n_topics=KL_SINGLE["k"], seed=KL_SINGLE["seed"])).cuda()
    kl2_label = f"KL {tuple(kl2_x.shape)} k{KL_SINGLE['k']} f32"
    kl3_x = torch.from_numpy(tfidf_like(KL_SINGLE["m"], KL_NARROW, n_topics=KL_SINGLE["k"],
                                        seed=KL_SINGLE["seed"])).cuda()
    high_kl_label = f"high-rank KL {tuple(kl2_x.shape)} k{HIGH_RANK} f32"
    high_eu_label = f"high-rank EU {tuple(eu_x.shape)} k{HIGH_RANK} f32"
    ragged_np = tfidf_like(1000, 777, n_topics=37, seed=2) + 0.05
    ragged_np[::7, ::5] = 0.0  # exact zeros for the KL masking
    ragged = torch.from_numpy(ragged_np).cuda()
    print(f"  data made in {time.perf_counter() - t0:.1f} s: EU {tuple(eu_x.shape)} and "
          f"{tuple(wide_x.shape)}, KL {tuple(kl_x.shape)} "
          f"({float((kl_x == 0).float().mean()):.4f} zeros) and {tuple(kl2_x.shape)} "
          f"({float((kl2_x == 0).float().mean()):.4f} zeros)", flush=True)
    t0 = time.perf_counter()
    # BASELINE config[2]'s MovieLens-1M stand-in (benchmarks/run_configs.py:151-155)
    ml1_x = torch.from_numpy(movielens_like(6040, 3706, density=0.2, seed=2)).cuda()
    ml10_x, ml10_obs = movielens_on_card(torch, *ML10M, seed=3)
    torch.cuda.synchronize()
    print(f"  MovieLens-shaped data made in {time.perf_counter() - t0:.1f} s: "
          f"{tuple(ml1_x.shape)} {float((ml1_x > 0).float().mean()):.4f} observed; "
          f"{tuple(ml10_x.shape)} {int(ml10_obs.sum())} observed", flush=True)
    t0 = time.perf_counter()
    from tpunmf_torch.native import loader, native_available
    require(native_available(), f"the native panelizer did not build: {loader.build_error}")
    print(f"  native panelizer built from tpunmf_torch/native/panelize.cpp with g++ and "
          f"loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    adm_x, adm_csr = config3_on_card(torch)
    adm_label = f"config[3] {tuple(adm_x.shape)} k{CONFIG3['k']} f32"
    print(f"  BASELINE config[3] made in {time.perf_counter() - t0:.1f} s: "
          f"{tuple(adm_x.shape)}, {adm_csr.nnz} nonzeros", flush=True)
    t0 = time.perf_counter()
    built.result()  # raises if a kernel did not build
    nvcc_pool.shutdown()
    print(f"  kernels built and loaded in {time.perf_counter() - t_build:.1f} s beside the "
          f"data ({time.perf_counter() - t0:.1f} s waited for after them)", flush=True)

    t_phase = time.perf_counter()
    print("phase 2: kernels vs plain versions", flush=True)
    cases = [
        (f"ragged {tuple(ragged.shape)} k37 f32", ragged, 37, ("eu", "kl")),
        (f"ragged {tuple(ragged.shape)} k37 bf16", ragged.bfloat16(), 37, ("eu", "kl")),
        (f"EU {tuple(eu_x.shape)} k{eu_k} f32", eu_x, eu_k, ("eu",)),
        (f"EU {tuple(eu_x.shape)} k{eu_k} bf16", eu_x.bfloat16(), eu_k, ("eu",)),
        (f"KL {tuple(kl_x.shape)} k{kl_k} f32", kl_x, kl_k, ("kl",)),
    ]
    records = kernel_phase(torch, cases, reps=5)
    # mur_h_update's KL body where the pair runs KL 8192x4096 (the 2-pass
    # route and the lagged path)
    kernel_phase(torch, [(kl2_label, kl2_x, KL_SINGLE["k"], ("kl",),
                          ("mur_w_update", "mur_h_update"))], reps=5, records=records)
    lagged_phase(torch, records, ragged, 37, f"ragged {tuple(ragged.shape)} k37 f32", 5)
    lagged_phase(torch, records, kl_x, kl_k, f"KL {tuple(kl_x.shape)} k{kl_k} f32", 5)
    lagged_phase(torch, records, kl2_x, KL_SINGLE["k"], kl2_label, 3)
    route_line = iteration_phase(torch, records, [
        (f"ragged {tuple(ragged.shape)} k37 f32", ragged, 37, "eu", False),
        (f"ragged {tuple(ragged.shape)} k37 bf16", ragged.bfloat16(), 37, "eu", False),
        (f"ragged {tuple(ragged.shape)} k37 f32", ragged, 37, "kl", False),
        (f"ragged {tuple(ragged.shape)} k37 bf16", ragged.bfloat16(), 37, "kl", False),
        (f"EU {tuple(eu_x.shape)} k{eu_k} f32", eu_x, eu_k, "eu", True),
        (f"EU {tuple(eu_x.shape)} k{eu_k} bf16", eu_x.bfloat16(), eu_k, "eu", True),
        (kl2_label, kl2_x, KL_SINGLE["k"], "kl", True),
        (kl2_label[:-3] + "bf16", kl2_x.bfloat16(), KL_SINGLE["k"], "kl", False)]
        # across the KL rank lines (W 320, H 640), where tpunmf's rule admits k 1024
        + [(f"KL {tuple(kl3_x.shape)} k{k} f32", kl3_x, k, "kl", False)
           for k in KL_RANKS], reps=5)
    kl_bits_phase(torch, [
        (f"ragged {tuple(ragged.shape)} k37 f32", ragged, 37),
        (kl2_label, kl2_x, KL_SINGLE["k"]),
        (kl2_label[:-3] + "bf16", kl2_x.bfloat16(), KL_SINGLE["k"])]
        + [(f"KL {tuple(kl3_x.shape)} k{k} f32", kl3_x, k) for k in KL_RANKS])
    del kl3_x
    sweep_phase(torch, records, [
        (f"ragged {tuple(ragged.shape)} k37 f32", ragged, 37, False),
        (f"EU {tuple(eu_x.shape)} k{eu_k} f32", eu_x, eu_k, True)], reps=3)
    masked_phase(torch, records, [
        (f"ML-1M {tuple(ml1_x.shape)} k64 f32", ml1_x, ml1_x > 0, 64),
        (f"ML-10M {tuple(ml10_x.shape)} k64 f32", ml10_x, ml10_obs, 64)], reps=3)
    bits = masked_w_bits(torch, masked_fused)
    print(f"  masked_w_update: sha256 of its outputs on the fixed inputs {bits[:16]}, "
          f"{'as' if bits == MASKED_W_BITS else 'NOT as'} pinned", flush=True)
    require(bits == MASKED_W_BITS, "masked_w_update: its bits moved")
    rag = f"ragged {tuple(ragged.shape)}"
    pass_phase(torch, records, [
        ("kl_ratio_and_obj", f"{rag} k37 f32", ragged, 37),
        ("kl_ratio_and_obj", f"KL {tuple(kl_x.shape)} k{kl_k} f32", kl_x, kl_k),
        ("kl_ratio_and_obj", adm_label, adm_x, CONFIG3["k"]),
        # the ratio pass of MUR's high-rank KL step, past the update
        # kernels' rank bound, and at the BASELINE row's shape
        ("kl_ratio", f"{rag} k37 f32", ragged, 37),
        ("kl_ratio", f"{rag} k37 bf16", ragged.bfloat16(), 37),
        ("kl_ratio", f"{rag} k1100 f32", ragged, 1100),
        ("kl_ratio", f"{rag} k1100 bf16", ragged.bfloat16(), 1100),
        ("kl_ratio", f"KL {tuple(kl_x.shape)} k{kl_k} f32", kl_x, kl_k),
        ("kl_ratio", high_kl_label, kl2_x, HIGH_RANK),
        # the high-rank step's objective passes at its shapes
        ("kl_ratio_and_obj", high_kl_label, kl2_x, HIGH_RANK),
        ("kl_obj", high_kl_label, kl2_x, HIGH_RANK),
        ("eu_residual_obj", high_eu_label, eu_x, HIGH_RANK),
        # the objectives at the paths' shapes: MUR EU's and HALS's, MUR KL's
        # at config[1] and KL 8192x4096, ADMM EU's at config[3]
        ("kl_obj", f"{rag} k37 f32", ragged, 37),
        ("eu_residual_obj", f"EU {tuple(eu_x.shape)} k{eu_k} f32", eu_x, eu_k),
        ("kl_obj", f"KL {tuple(kl_x.shape)} k{kl_k} f32", kl_x, kl_k),
        ("kl_obj", kl2_label, kl2_x, KL_SINGLE["k"]),
        ("eu_residual_obj", adm_label, adm_x, CONFIG3["k"])], reps=3)
    topk_line = serving_kernel_phase(torch, records, reps=5)
    dma_line = opt_in_phase(torch, records, eu_x, eu_k, ragged, reps=3)
    v1_line = variant_phase(torch, records, eu_x, eu_k, ragged, reps=3)
    print(f"  phase 2 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print("phase 3: the paths through NMF.factorize", flush=True)
    runs, launches = {}, {name: 0 for name in KERNELS}

    def mur_path():
        # tpunmf's route rule: the single pass at the EU headline and at
        # KL 8192x4096, the 2-pass pair at EU 8192x16384 and at config[1]
        for label, x, k, dist, dd, needed, banned in (
                ("EU bf16", eu_x, eu_k, "eu", torch.bfloat16, SINGLE_EU, PAIR),
                ("EU f32", eu_x, eu_k, "eu", None, SINGLE_EU, PAIR),
                ("EU f32 8192x16384", wide_x, EU_WIDE["k"], "eu", None,
                 PAIR + ("eu_residual_obj",), ("mur_iteration_eu",)),
                ("KL config[1]", kl_x, kl_k, "kl", None, PAIR + ("kl_obj",),
                 ("mur_iteration_kl",)),
                ("KL 8192x4096", kl2_x, KL_SINGLE["k"], "kl", None,
                 ("mur_iteration_kl", "kl_obj"), PAIR)):
            runs[label] = run_slice(torch, tt, counters, label, x, k, dist, dd,
                                    card, RUN_ITERS, needed=needed, banned=banned)
        # the same EU headline runs on the 2-pass pair, for the routes' it/s
        with two_pass_route():
            for label, dd in (("EU bf16 2-pass", torch.bfloat16), ("EU f32 2-pass", None)):
                runs[label] = run_slice(torch, tt, counters, label, eu_x, eu_k, "eu", dd,
                                        card, RUN_ITERS, needed=PAIR,
                                        banned=("mur_iteration_eu",))

    def high_rank_path():
        # above the update kernels' rank bound: tpunmf's jnp step with the
        # ratio and objective kernels, against the plain route
        for label, x, dist, exact in (
                (f"KL {tuple(kl2_x.shape)} k{HIGH_RANK}", kl2_x, "kl",
                 {"kl_ratio": RUN_ITERS, "kl_ratio_and_obj": RUN_ITERS + 1}),
                (f"EU {tuple(eu_x.shape)} k{HIGH_RANK}", eu_x, "eu",
                 {"eu_residual_obj": RUN_ITERS + 1})):
            runs[label] = run_slice(torch, tt, counters, label, x, HIGH_RANK, dist, None,
                                    card, RUN_ITERS, needed=tuple(exact), banned=UPDATES,
                                    exact=exact)

    def numpy_path():
        # numpy means the card, float64 as float32: each run must launch its
        # route's kernels (tpunmf's jnp.asarray makes float64 float32 too)
        runs_np = (
            ("MUR EU", eu_np.astype(np.float64), eu_k, dict(method="mur", distance_type="eu"),
             {"mur_iteration_eu": 5, "eu_residual_obj": 6}),
            ("MUR KL", eu_np.astype(np.float64), eu_k, dict(method="mur", distance_type="kl"),
             {"mur_w_update": 5, "mur_h_update": 5, "kl_obj": 6}),
            ("mask=", ragged_np.astype(np.float64), 37,
             dict(method="mur", distance_type="kl", mask=ragged_np > 0.1),
             {"masked_w_update": 5, "masked_h_update": 5}),
            ("HALS", ragged_np.astype(np.float64), 37, dict(method="hals"),
             {"gs_sweep": 10, "eu_residual_obj": 6}),
            ("ADMM", ragged_np.astype(np.float64), 37, dict(method="admm", distance_type="eu"),
             {"eu_residual_obj": 5}),
            ("AO-ADMM", ragged_np.astype(np.float64), 37,
             dict(method="ao_admm", distance_type="eu"), {"eu_residual_obj": 5}))
        for label, data, k, kw, exact in runs_np:
            t0 = time.perf_counter()
            before = counts(counters)
            res = tt.NMF(data, k).factorize(min_iter=5, max_iter=5, **kw)
            launched = {n: c - before[n] for n, c in counts(counters).items()}
            print(f"  NMF(numpy {data.shape} {data.dtype}) {label}: 5 iterations in "
                  f"{time.perf_counter() - t0:.1f} s, obj[5]={res.obj_history[-1]:.6e}, "
                  f"factors {res.w.dtype}; launches "
                  f"{ {n: c for n, c in launched.items() if c} }", flush=True)
            require(np.all(np.isfinite(res.w)) and np.all(np.isfinite(res.h))
                    and np.all(np.isfinite(res.obj_history)),
                    f"NMF(numpy float64) {label}: non-finite factors or trace")
            require(res.w.dtype == np.float32, f"NMF(numpy float64) {label}: factors "
                                               f"{res.w.dtype}, not float32")
            for name, count in exact.items():
                require(launched[name] == count, f"NMF(numpy float64) {label}: {name} "
                                                 f"launched {launched[name]} times, not {count}")

    def float64_tensor_path():
        # a CUDA float64 tensor asks for float64: the plain route, no kernel
        x = torch.from_numpy(ragged_np.astype(np.float64)).cuda()
        res = tt.NMF(x, 37).factorize(method="mur", distance_type="eu", min_iter=5,
                                      max_iter=5)
        require(res.w.dtype == np.float64 and np.all(np.isfinite(res.obj_history)),
                f"CUDA float64 tensor: factors {res.w.dtype} or a non-finite trace")
        print(f"  CUDA float64 tensor {tuple(x.shape)}: 5 iterations, factors "
              f"{res.w.dtype}, obj[5]={res.obj_history[-1]:.6e}", flush=True)

    def hals_path():
        t0 = time.perf_counter()
        # NNDSVD 'zero' once for both routes, nudged to 1e-16 as hals()
        # nudges the inits it makes (tpunmf/solvers/hals.py:221-225)
        w0, h0 = nndsvd(eu_x, eu_k, variant="zero")
        eu_nndsvd[:] = [w0, h0]  # ANLS's own init at this X
        w0, h0 = w0.clamp(min=1e-16).contiguous(), h0.clamp(min=1e-16).contiguous()
        hals_init[:] = [w0, h0]
        torch.cuda.synchronize()
        print(f"  HALS: NNDSVD 'zero' init in {time.perf_counter() - t0:.1f} s", flush=True)
        runs["HALS EU f32"] = run_slice(
            torch, tt, counters, "HALS EU f32", eu_x, eu_k, "eu", None, card,
            RUN_ITERS, method="hals", needed=("gs_sweep", "eu_residual_obj"),
            inner_sweeps=2, w_init=w0, h_init=h0)

    def hals_single_path():
        # tpunmf's hals_single_pass, off by default, on: the HALS path's run
        # again, from its init, through hals_iteration_eu
        w0, h0 = hals_init
        with switched(hals_single_pass=True):
            runs["HALS EU f32 single pass"] = switched_run(
                torch, tt, counters, "HALS EU f32 single pass", eu_x, eu_k,
                runs["HALS EU f32"]["trace"], SWEEP_TOL,
                {"hals_iteration_eu": RUN_ITERS, "gs_sweep": RUN_ITERS,
                 "eu_residual_obj": RUN_ITERS + 1}, card, RUN_ITERS,
                method="hals", inner_sweeps=2, w_init=w0, h_init=h0)
            profiles["HALS EU f32 single pass"] = profile_run(
                torch, tt, "HALS EU f32 single pass", eu_x, eu_k, "eu", method="hals",
                inner_sweeps=2, w_init=w0, h_init=h0)
        profiles["HALS EU f32"] = profile_run(torch, tt, "HALS EU f32", eu_x, eu_k, "eu",
                                              method="hals", inner_sweeps=2, w_init=w0,
                                              h_init=h0)

    def mur_dma_path():
        # tpunmf's mur_single_pass_variant "dma": the MUR path's EU headline
        # runs again (the same random init) through mur_iteration_eu_dma
        with switched(mur_single_pass_variant="dma"):
            for label, dd in (("EU bf16", torch.bfloat16), ("EU f32", None)):
                dname = "bfloat16" if dd is not None else "float32"
                runs[label + " dma"] = switched_run(
                    torch, tt, counters, label + " dma", eu_x, eu_k, runs[label]["trace"],
                    ROUTE_RTOL[dname], {"mur_iteration_eu_dma": RUN_ITERS,
                                        "mur_iteration_eu": 0,
                                        "eu_residual_obj": RUN_ITERS + 1},
                    card, RUN_ITERS, method="mur", distance_type="eu", data_dtype=dd)
            profiles["EU f32 dma"] = profile_run(torch, tt, "EU f32 dma", eu_x, eu_k, "eu")

    def masked_path():
        for dist in ("eu", "kl"):
            label = f"masked {dist.upper()} ML-10M"
            runs[label] = run_slice(
                torch, tt, counters, label, ml10_x, 64, dist, None, card, SLOW_RUN_ITERS,
                needed=("masked_w_update", "masked_h_update"), mask=ml10_obs)

    def lagged_path():
        runs["KL config[1] lagged"] = lagged_run(
            torch, tt, counters, "KL config[1] lagged", kl_x, kl_k,
            runs["KL config[1]"]["trace"], RUN_ITERS, card,
            needed=("mur_w_update_lagged", "mur_h_update"))
        runs["KL 8192x4096 lagged"] = lagged_run(
            torch, tt, counters, "KL 8192x4096 lagged", kl2_x, KL_SINGLE["k"],
            runs["KL 8192x4096"]["trace"], RUN_ITERS, card, needed=("mur_iteration_kl",))

    def admm_path():
        for label, dist, mode in (("ADMM EU fixed config[3]", "eu", "fixed"),
                                  ("ADMM EU adaptive config[3]", "eu", "adaptive"),
                                  ("ADMM KL config[3]", "kl", "fixed")):
            runs[label] = run_slice(
                torch, tt, counters, label, adm_x, CONFIG3["k"], dist, None, card,
                SLOW_RUN_ITERS, method="admm",
                needed=("eu_residual_obj" if dist == "eu" else "kl_ratio_and_obj",),
                rho_mode=mode, **ADMM_KW)

    def ao_admm_path():
        # one card's cut of BASELINE config[4], then the bench's 8192^2 r128;
        # each X's NNDSVD 'zero' once, given to both routes
        t0 = time.perf_counter()
        w0, h0 = nndsvd(ao_x, CONFIG4["k"], variant="zero")
        torch.cuda.synchronize()
        ao_init[:] = [w0, h0]
        print(f"  AO-ADMM: NNDSVD 'zero' init of {tuple(ao_x.shape)} k{CONFIG4['k']} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        label = f"AO-ADMM KL config[4] {tuple(ao_x.shape)} k{CONFIG4['k']}"
        runs["AO-ADMM KL config[4]"] = ao_admm_run(torch, tt, counters, label, ao_x,
                                                   CONFIG4["k"], AO_KL_ITERS, card, w0, h0,
                                                   **AO_KL_KW)
        for label, iters, kw, plain in AO_EU_RUNS:
            runs[label] = ao_admm_run(torch, tt, counters, label, eu_x, eu_k, iters, card,
                                      *eu_nndsvd, plain=plain, **kw)

    def sweep_path():
        # the sweep scripts' loops at their shape, 30 iterations each from
        # the scripts' init; warm-up runs happen before the counts are reset
        x, w0, h0 = sweep_data["iter2"]
        out = {}
        for label, make in (("v1 loop", sweep_iter2.make_v1), ("v2 loop", sweep_iter2.make_v2)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[label] = float(make(128)(x, w0, h0, SWEEP_ITERS))  # a host read
            secs = time.perf_counter() - t0
            runs[f"sweep {label} bf16"] = {"it_s": SWEEP_ITERS / secs, "value": out[label]}
            print(f"  sweep {label} {tuple(x.shape)} r128 bf16: {SWEEP_ITERS} iterations, "
                  f"{SWEEP_ITERS / secs:.2f} it/s (wall clock; {card}); sum(W[0]) + "
                  f"sum(H[:, 0]) = {out[label]:.6e}", flush=True)
        err = abs(out["v1 loop"] - out["v2 loop"]) / abs(out["v1 loop"])
        print(f"  sweep v1 loop vs v2 loop: rel {err:.3e} (tol {ROUTE_RTOL['bfloat16']:.0e})",
              flush=True)
        require(np.isfinite(out["v1 loop"]) and err <= ROUTE_RTOL["bfloat16"],
                f"sweep loops: v1 and v2 disagree ({err:.3e})")
        t, tflops = sweep_iter2.mxu_probe(0)
        runs["tensor-core probe"] = {"ms": 1e3 * t, "tflops": tflops}
        print(f"  tensor-core probe (2048x65536x2048 bf16, torch.matmul): {1e3 * t:.3f} ms, "
              f"{tflops:.1f} TFLOP/s (published dense bf16 peak 989; {card})", flush=True)

    def int8_path():
        # sweep_int8's loop against the f32 single-pass loop from one init
        x, xq, scale, w0, h0 = sweep_data["int8"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wq, hq, _ = sweep_int8.make_run(128)(xq, scale, w0, h0, SWEEP_ITERS)
        torch.cuda.synchronize()
        secs_q = time.perf_counter() - t0
        t0 = time.perf_counter()
        wf, hf = sweep_int8.run_f32(x, w0, h0, SWEEP_ITERS)
        torch.cuda.synchronize()
        secs_f = time.perf_counter() - t0
        obj_q, obj_f = sweep_int8.objective(x, wq, hq), sweep_int8.objective(x, wf, hf)
        dev = (obj_q - obj_f) / obj_f
        runs["sweep int8 loop"] = {"it_s": SWEEP_ITERS / secs_q, "f32_it_s": SWEEP_ITERS / secs_f,
                                   "obj_int8": obj_q, "obj_f32": obj_f, "rel_dev": dev}
        print(f"  sweep int8 loop {tuple(xq.shape)} r128: {SWEEP_ITERS / secs_q:.2f} it/s, f32 "
              f"single-pass loop {SWEEP_ITERS / secs_f:.2f} it/s (wall clock; {card}); objective "
              f"after {SWEEP_ITERS}: int8 {obj_q:.6e} vs f32 {obj_f:.6e} (rel dev {dev:+.3%})",
              flush=True)
        require(all(bool(torch.isfinite(a).all()) for a in (wq, hq, wf, hf))
                and np.isfinite(obj_q) and np.isfinite(obj_f), "sweep int8: non-finite result")

    def rate_path():
        rate = read_probe.read_rate(eu_x)
        runs["read rate"] = {"bytes_per_s": rate}
        print(f"  read rate of {tuple(eu_x.shape)} f32 (read_probe, 110 less 10 calls): "
              f"{rate / 1e12:.3f} TB/s against the published 3.35 ({card})", flush=True)
        require(np.isfinite(rate) and rate > 0, f"read rate {rate}")

    def drive(label, needed, body, opt_in=False, exact=None):
        out, launched = run_path(torch, counters, label, needed, body)
        for name, c in launched.items():
            launches[name] += c
        if exact is not None:  # exactly these launches, none of any other kernel
            for name, c in launched.items():
                require(c == exact.get(name, 0),
                        f"{label}: {name} launched {c} times, not {exact.get(name, 0)}")
            return out
        # the switches at tpunmf's defaults; no NMF path reaches the sweeps' kernels
        for name in (() if opt_in else OPT_IN) + SWEEP_ONLY:
            require(launched[name] == 0, f"{label}: {name} was launched off its path")
        return out

    def profile_path():
        # where the time goes on both routes, at the single pass's shapes
        for label, x, k, dist in (("EU f32", eu_x, eu_k, "eu"),
                                  ("KL 8192x4096", kl2_x, KL_SINGLE["k"], "kl")):
            profiles[label] = profile_run(torch, tt, label, x, k, dist)
            with two_pass_route():
                profiles[label + " 2-pass"] = profile_run(torch, tt, label + " 2-pass", x,
                                                          k, dist)
        # MUR KL at config[1] (the pair, exact objective) on both routes
        profiles["KL config[1]"] = profile_run(torch, tt, "KL config[1]", kl_x, kl_k, "kl")
        profiles["KL config[1] plain"] = profile_run(torch, tt, "KL config[1] plain", kl_x,
                                                     kl_k, "kl", plain=True)
        # and on the high-rank step and the plain route at its shapes
        for label, x, dist in ((f"KL 8192x4096 k{HIGH_RANK}", kl2_x, "kl"),
                               (f"EU 8192x8192 k{HIGH_RANK}", eu_x, "eu")):
            profiles[label] = profile_run(torch, tt, label, x, HIGH_RANK, dist)
            profiles[label + " plain"] = profile_run(torch, tt, label + " plain", x,
                                                     HIGH_RANK, dist, plain=True)

    def anls_path():
        # BASELINE config[2]'s stand-in from one NNDSVD 'zero' init, each
        # NNLS configuration on both routes; then the transforms with the
        # trained W, and EU 'chol' at the EU headline X on the kernel route
        t0 = time.perf_counter()
        w0, h0 = nndsvd(ml1_x, ANLS_K, variant="zero")
        torch.cuda.synchronize()
        anls_init[:] = [w0, h0]
        print(f"  ANLS: NNDSVD 'zero' init of {tuple(ml1_x.shape)} k{ANLS_K} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        models = {}
        for label, kw in ANLS_RUNS:
            runs[label], models[label] = anls_run(torch, tt, counters, label, ml1_x, ANLS_K,
                                                  ANLS_ITERS, card, w0, h0, **kw)
        runs["ANLS transform config[2]"] = anls_transforms(
            torch, tt, models[ANLS_RUNS[0][0]], models[ANLS_RUNS[-1][0]], ml1_x, card)
        label = f"ANLS EU chol {tuple(eu_x.shape)} k{eu_k}"
        runs[label], _ = anls_run(torch, tt, counters, label, eu_x, eu_k, ANLS_EU_ITERS,
                                  card, *eu_nndsvd, plain=False, distance_type="eu")

    profiles, hals_init, eu_nndsvd, anls_init, ao_init = {}, [], [], [], []
    for label, needed, body in (
            ("MUR path", ("mur_w_update", "mur_h_update", "eu_residual_obj", "kl_obj",
                          "mur_iteration_eu", "mur_iteration_kl"), mur_path),
            ("high-rank MUR path", ("kl_ratio", "kl_ratio_and_obj", "eu_residual_obj"),
             high_rank_path),
            ("NMF(numpy float64) path", SINGLE_EU + PAIR + ("kl_obj", "gs_sweep",
                                                            "masked_w_update"), numpy_path),
            ("HALS path", ("gs_sweep", "eu_residual_obj"), hals_path),
            ("masked MUR path", ("masked_w_update", "masked_h_update"), masked_path),
            ("lagged KL path", ("mur_w_update_lagged", "mur_h_update", "mur_iteration_kl"),
             lagged_path),
            ("profile of the MUR routes", ("mur_iteration_eu", "mur_iteration_kl",
                                           "kl_ratio"), profile_path)):
        drive(label, needed, body)
    drive("HALS single-pass path", ("hals_iteration_eu", "gs_sweep", "eu_residual_obj"),
          hals_single_path, opt_in=True)
    drive("MUR EU dma path", ("mur_iteration_eu_dma", "eu_residual_obj"), mur_dma_path,
          opt_in=True)
    _, launched = run_path(torch, counters, "CUDA float64 tensor path", (),
                           float64_tensor_path)
    require(sum(launched.values()) == 0, "a CUDA float64 tensor launched a kernel")
    # where the time goes on the masked paths, both routes (after the paths'
    # counts were read: these launches are not a path's)
    for dist in ("eu", "kl"):
        label = f"masked {dist.upper()} ML-10M"
        profiles[label] = profile_run(torch, tt, label, ml10_x, 64, dist, mask=ml10_obs)
        profiles[label + " plain"] = profile_run(torch, tt, label + " plain", ml10_x, 64, dist,
                                                 plain=True, mask=ml10_obs)
    # ANLS at config[2]: each EU run (3, with 2 warm-up iterations) and the KL
    # run launch their objective kernel once an iteration, the transforms none
    drive("ANLS path", ("eu_residual_obj", "kl_obj"), anls_path,
          exact={"eu_residual_obj": 3 * (ANLS_ITERS + 2) + ANLS_EU_ITERS,
                 "kl_obj": ANLS_ITERS + 2})
    t0 = time.perf_counter()
    with nnls_ranges():
        for plain in (False, True):
            label = "ANLS EU chol config[2]" + (" plain" if plain else "")
            profiles[label] = profile_run(torch, tt, label, ml1_x, ANLS_K, "eu", plain=plain,
                                          method="anls", distance_type="eu", use_fcnnls=True,
                                          w_init=anls_init[0], h_init=anls_init[1])
    print(f"  ANLS profiles took {time.perf_counter() - t0:.1f} s", flush=True)
    # the ADMM KL path holds ~10 config[3]-sized arrays (4 GB each)
    del ml10_x, ml10_obs, ml1_x, wide_x, anls_init
    kept = drive("serving path", ("score_blockmax_relayout", "blockmax_relayout"),
                 lambda: serving_path(torch, runs))
    check_serving(torch, runs, kept)
    profile_serving(torch, runs, kept["requests"])
    del kept
    torch.cuda.empty_cache()
    drive("ADMM path", ("eu_residual_obj", "kl_ratio_and_obj"), admm_path)
    for dist in ("eu", "kl"):
        for plain in (False, True):
            label = f"ADMM {dist.upper()} config[3]" + (" plain" if plain else "")
            profiles[label] = profile_run(torch, tt, label, adm_x, CONFIG3["k"], dist,
                                          plain=plain, method="admm", distance_type=dist,
                                          rho_mode="fixed", **ADMM_KW)
    del adm_x
    torch.cuda.empty_cache()
    # AO-ADMM after the ADMM KL path freed config[3]: config[4]'s cut holds
    # V, v_aux, dual_v and the split's temporaries (4 GB each)
    t0 = time.perf_counter()
    ao_x = config4_on_card(torch)
    torch.cuda.synchronize()
    print(f"  BASELINE config[4]'s cut made in {time.perf_counter() - t0:.1f} s: "
          f"{tuple(ao_x.shape)} f32", flush=True)
    # each run's warm-up launches its objective once on the kernel route
    drive("AO-ADMM path", ("eu_residual_obj", "kl_obj"), ao_admm_path,
          exact={"kl_obj": AO_KL_ITERS + 1,
                 "eu_residual_obj": sum(iters + 1 for _, iters, _, _ in AO_EU_RUNS)})
    for plain in (False, True):
        tag = " plain" if plain else ""
        profiles["AO-ADMM KL config[4]" + tag] = profile_run(
            torch, tt, "AO-ADMM KL config[4]" + tag, ao_x, CONFIG4["k"], "kl", iters=3,
            plain=plain, method="ao_admm", w_init=ao_init[0], h_init=ao_init[1], **AO_KL_KW)
        profiles["AO-ADMM EU 8192^2" + tag] = profile_run(
            torch, tt, "AO-ADMM EU 8192^2" + tag, eu_x, eu_k, "eu", plain=plain,
            method="ao_admm", distance_type="eu", w_init=eu_nndsvd[0], h_init=eu_nndsvd[1])
    del ao_x, ao_init
    torch.cuda.empty_cache()
    # the sweep scripts' data and warm-up runs (2 iterations each), before
    # their paths' counts are reset
    x2, w2, h2 = sweep_iter2.problem(0)
    x8, w8, h8 = sweep_int8.problem(0)
    sweep_data = {"iter2": (x2, w2, h2), "int8": (x8, *sweep_int8.quantize(x8), w8, h8)}
    sweep_iter2.make_v1(128)(x2, w2, h2, 2)
    sweep_iter2.make_v2(128)(x2, w2, h2, 2)
    sweep_int8.make_run(128)(*sweep_data["int8"][1:], 2)
    sweep_int8.run_f32(x8, w8, h8, 2)
    drive("sweep_iter2 path", ("v1_iter", "v2_iter"), sweep_path,
          exact={"v1_iter": SWEEP_ITERS, "v2_iter": SWEEP_ITERS})
    drive("sweep_int8 path", ("iter_eu_int8", "mur_iteration_eu"), int8_path,
          exact={"iter_eu_int8": SWEEP_ITERS, "mur_iteration_eu": SWEEP_ITERS})
    drive("read-rate path", ("read_probe",), rate_path, exact={"read_probe": 3 * (10 + 110)})
    del sweep_data, x2, w2, h2, x8, w8, h8
    print(f"  launches over the paths: {launches}", flush=True)
    for name, c in launches.items():
        require(c > 0, f"{name} was not launched on any path")
    print(f"  phase 3 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print("phase 4: save/load", flush=True)
    roundtrip_phase(tt, ragged, 8, method="mur", distance_type="eu")
    roundtrip_phase(tt, ragged, 8, method="ao_admm", **AO_KL_KW)
    print(f"  phase 4 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print(f"phase 5: tooling [{card}]", flush=True)
    torch.cuda.empty_cache()  # room for the CLI's processes beside this one
    tooling = tooling_phase(torch, tt, drive, card, eu_np, eu_x, eu_nndsvd, hals_init, kl2_x)
    print(f"  phase 5 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print(f"phase 6: every kernel route against float64, semi_nmf, onmf, robust_nmf, "
          f"multilevel [{card}]", flush=True)
    t0 = time.perf_counter()
    kl_f64 = route_f64_phase(torch, counters,
                             kl_f64_cases(torch, eu_x, eu_nndsvd, kl_x, kl2_x), card)
    route_f64 = route_f64_phase(torch, counters,
                                eu_f64_cases(torch, eu_x, eu_nndsvd, hals_init)
                                + masked_f64_cases(torch, "8192x4096", f64_mask_label(kl2_x), kl2_x,
                                                   f64_mask(torch, kl2_x), KL_SINGLE["k"]),
                                card)
    ml10_x, ml10_obs = movielens_on_card(torch, *ML10M, seed=3)
    route_f64.update(route_f64_phase(torch, counters, masked_f64_cases(
        torch, "ml10m", f"ML-10M {tuple(ml10_x.shape)}", ml10_x, ml10_obs, 64), card))
    del ml10_x, ml10_obs
    torch.cuda.empty_cache()
    print(f"  the float64 check took {time.perf_counter() - t0:.1f} s", flush=True)
    families = families_phase(torch, tt, counters, drive, card, eu_x, eu_nndsvd)
    print(f"  phase 6 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print(f"phase 7: N-way CP and the remaining families [{card}]", flush=True)
    torch.cuda.empty_cache()  # room for the CLI's process beside this one
    remaining = ntf_phase(torch, tt, counters, drive, card)
    remaining.update(matrix_families_phase(torch, tt, counters, drive, card, eu_x, eu_nndsvd))
    print(f"  phase 7 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print(f"phase 8: out of core [{card}]", flush=True)
    torch.cuda.empty_cache()
    out_of_core, c4_csr = out_of_core_phase(torch, drive, card, adm_csr, kl_x)
    print(f"  phase 8 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print(f"phase 9: MUR across GPUs as a world of one [{card}]", flush=True)
    torch.cuda.empty_cache()
    multi_gpu = multi_gpu_phase(torch, tt, drive, card, {"eu": eu_x, "kl": kl_x}, adm_csr,
                                c4_csr)
    del c4_csr
    print(f"  phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print(f"phase 10: the reference solvers across GPUs as a world of one [{card}]",
          flush=True)
    torch.cuda.empty_cache()
    multi_gpu["methods"] = methods_phase(torch, tt, drive, card, {"eu": eu_x, "kl": kl2_x},
                                         adm_csr)
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print(f"phase 11: every other method and keyword across GPUs as a world of one [{card}]",
          flush=True)
    torch.cuda.empty_cache()
    multi_gpu["rest"] = mesh_rest_phase(torch, tt, drive, card, {"eu": eu_x, "kl": kl_x})
    print(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print(f"phase 12: the CLI's bench (python -m tpunmf_torch bench) [{card}]", flush=True)
    torch.cuda.empty_cache()
    bench, bench_launched = bench_phase(torch, counters, card)
    for name, c in bench_launched.items():
        launches[name] += c
    print(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    t_phase = time.perf_counter()
    print(f"phase 13: BASELINE's configs to convergence against float64, and HALS against "
          f"MUR-EU in time to objective [{card}]", flush=True)
    torch.cuda.empty_cache()
    baseline, baseline_launched = configs_phase(torch, tt, counters, card, kl_x, adm_csr)
    for name, c in baseline_launched.items():
        launches[name] += c
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s; all phases "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)

    def headline(name):
        want = HEADLINE.get(name, "EU") + " "
        hits = [c for c in records[name]["cases"] if c["shape"].startswith(want)
                and c["shape"].endswith(HEADLINE_X.get(name, "f32"))]
        return hits[0]

    # library_ms: only blockmax_relayout (torch.amax over the view of the
    # scores that its s3 is) and the read probe (torch.sum over rows) have
    # one PyTorch call computing their function, timed in turns with the
    # kernel as ms is with the plain version; their device times are in
    # their cases.  The others fuse a product with an update, a masked
    # sum, a division or a selection, and have none (null)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": records[name]["max_abs_err"],
         "ms": headline(name)["ms"],
         "plain_ms": headline(name)["plain_ms"],
         "bound_ms": headline(name)["bound_ms"], "bound_by": headline(name)["bound_by"],
         "library_ms": headline(name)["library_ms"],
         "shape": headline(name)["shape"] + " " + headline(name)["case"],
         "cases": records[name]["cases"]}
        for name, (src, rep) in KERNELS.items()],
        "runs": {label: {k: v for k, v in r.items() if k != "trace"}
                 for label, r in runs.items()},
        "torch_topk": topk_line, "single_vs_pair": route_line, "dma_vs_auto": dma_line,
        "v1_vs_auto": v1_line,
        "profiles": profiles, "tooling": tooling, "kl_f64": kl_f64, "route_f64": route_f64,
        "families": families,
        "remaining": remaining, "out_of_core": out_of_core, "multi_gpu": multi_gpu,
        "bench": bench, "baseline": baseline}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
