#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pastix_tpu_torch``) on NVIDIA GPUs (one
is enough; phase 21 takes up to 4).

    python3 chip_smoke.py [--nx N] [--schur-nx N] [--lu-nx N] [--ldlt-nx N]
                          [--ooc-nx N] [--ooc-mb MB]

Phases; any failed check raises, so the script exits non-zero and never
prints the final ``ok`` line:

1. device: a CUDA device is required; prints the card's name and power
   limit (nvidia-smi);
2. build: compiles the hand-written CUDA kernels K1-K13 from ``csrc/``
   (one nvcc per source, in parallel; ptxas registers, shared memory and
   spills, and K1's, K3's, K5's, K6's, K10's and K12's HMMA counts from
   ``cuobjdump -sass`` where the toolkit has it, K5's (and K9's) those of
   K3's kernel with fp32 operands, K6's those of K1's windowed kernel
   with fp32 operands, K10's those with fp32 a and bf16 b: none fails,
   and the first designs of K6 and K9 must be gone from the library) and
   the port's native host library (g++; prints whether it was built or
   the Python ordering runs);
3. kernels: each kernel against its plain PyTorch twin on the same inputs,
   max|d| <= 1e-4 max|ref| for K1 and K3, 1e-5 for K2 (summation order
   only) and K4 (plus equal clamp counts); K1, K2, K3, K4, K5, K6, K9,
   K10 and K12 also run twice and must repeat bit for bit (K3, K4, K5,
   K6, K9 and K10 wherever they are checked, phases 7, 8, 11 and 13 too;
   K12 in phase 14), and K2 must launch once a
   sweep direction: on the
   poisson_3d(24) T=128 layout, K1 (left-looking E2) on the busiest
   level's chunks and the dense-tail pre-pass, bf16 and fp32 updates,
   K2 (sweeps) forward + backward at R = 1 and R = 3; on the poisson_3d(24) T=128 Schur layout
   (Schur = its last 24^2 unknowns), K3 (right-looking E2) on the busiest
   residue level and on every residue pair in one list cut into chunks
   that split dst segments, bf16 and fp32; that layout's ``get_schur``
   against A22 - A21 A11^-1 A12 from a sparse LU (fp32 updates,
   1e-4 max|S|); then slice 2 on T=128 layouts: K1 scaled (``d``) on the
   shift-invert poisson_3d(24) LDLᵗ layout, K1 cross-pool (``src_pool``,
   the pool side and the pool_u mirror, with a forced ``"full"`` plan) on
   the convection_diffusion_3d(24) LU layout, bf16 and fp32; K3 ``d`` and
   ``src_pool`` on those layouts in Schur mode (the plane z = 23); K2's
   LU backward at R = 1 and R = 3; K4 (static-pivot tile factorization)
   LU and LDLᵗ on the busiest level's diagonal tiles and on batches with
   planted zero pivots at T = 32, 64 and 128 (either side of its first
   32 x 32 block step too); ``get_schur`` under LU against the sparse-LU
   S;
   then slice 3 on the busiest level's pairs of the poisson_3d(24) (LLᵗ,
   LDLᵗ) and convection_diffusion_3d(24) (LU) T=128 layouts, bf16 and
   fp32, 1e-4 max|ref|: K3 reading operand arrays (the panel stream
   ``xab`` plain, ``d`` and LU's (L, Uᵗ) with its mirror; ``compact``
   plain, ``d`` and ``src_pool``), K5 (dst-block E2, every entry kept)
   and K6 (panel-slab E2, cost gate off) plain and ``d``; then slice 4 on
   the same pairs and dtypes: the E2 harness's variants, K3 on the pools
   at G=1 and 2, K3 ``ab_pack`` at G=1, 2 and 4, K9 (one-pair-per-step
   E2 over ``sort_triples``) and K10 (compact-gather E2 over a group-1
   schedule), plain, ``d`` and ``src_pool``; and K7 (fused Cholesky +
   inverse in place on the pool) on the poisson_3d(24) level with the
   most diagonal tiles, garbage planted above their diagonals and a pad
   sentinel in the index (every other tile bit-identical), and K8 on the
   same tiles symmetrized, 1e-5 max|ref|;
4. main path: ``Pastix(poisson_3d(--nx), T=128, bf16 updates)`` through
   order, symbfact, analyze, factorize (twice, the second timed) and a
   refined solve of b = A.1 to a fp64 residual <= 1e-10; the launch counts
   of K1 and K2 must rise and the twins' stay 0, and K2 may launch at
   most twice a fwd+bwd sweep pair (the first solve and one a refinement
   step; so on every path that calls ``solve``);
5. main-path shapes: K1 on the main path's busiest level and tail
   pre-pass and K2 on its sweeps, each against its twin as in 3, then
   each kernel and its twin timed (CUDA events), K1's per-chunk bf16
   operand gather timed alone, and K2 on a chain of 256 dependent
   columns (its latency an item);
6. Schur path: ``Pastix(poisson_3d(--schur-nx), T=128, bf16 updates)``
   with the plane z = nx-1 (its last nx^2 unknowns) as Schur unknowns:
   order, symbfact, analyze, factorize twice (the second timed),
   ``get_schur`` (shape, finite, symmetric), ``solve_with_schur(A.1)`` to
   a fp64 residual <= 1e-10; K1, K2 and K3 must launch and no twin may
   run; then K1 on the busiest level and K2 against their twins, and K3
   against its twin on the path's busiest residue level, and timed;
7. LU path: ``Pastix(convection_diffusion_3d(--lu-nx), T=128, bf16
   updates, LU)`` (n = 343,000 at the default 70: the reference's
   convdiff rung) as in 4; K1, K2 and K4 must launch, no twin; one more
   factorize under ``torch.profiler``: K4's device time summed by kernel
   name, its share of ``fact_ms`` and the longest kernels; then K1
   cross-pool, K2's LU sweeps and K4 LU against their twins and timed at
   the path's busiest level, and ``tri_inv_batch`` (upper, then unit) on
   the same factored tiles;
8. LDLᵗ path: ``Pastix(poisson_3d(--ldlt-nx) - σI, T=128, fp32 updates,
   LDLT)``, σ halfway between the two smallest eigenvalues of the
   Laplacian (a shift-and-invert matrix, one negative eigenvalue), as in
   7; with no clamped pivot exactly one pivot of d is negative
   (Sylvester); K4's device time over one factorize as in 7; K1 scaled
   (against its twin, and timed, in fp32, the path's dtype), K2 against
   its twin, and K4 LDLᵗ, with ``tri_inv_batch`` (unit) on its tiles;
   then, not checked, what bf16 updates leave
   on this matrix (their error is not contracted by the refinement at
   nx=64);
9. LU Schur path: ``convection_diffusion_3d(--schur-nx)`` with the plane
   z = nx-1 as Schur unknowns: ``get_schur`` (shape, finite),
   ``solve_with_schur(A.1)`` to <= 1e-10, K3 launched in its cross-pool
   variant; K1 and K2 (LU) against their twins as in 6; K3 ``src_pool``
   against its twin and timed (bf16);
10. LDLᵗ Schur path: the shift-invert poisson_3d(--schur-nx) with its
   plane z = nx-1, fp32 updates: as 9 (S symmetric), K3 launched in its
   scaled variant; K3 ``d`` against its twin and timed in fp32;
11. right-looking paths (the reference's ``PASTIX_E2_LL=0`` schedules,
   bf16 updates): LLᵗ on ``poisson_3d(--nx)`` (dense tail on) in stream,
   block, slab, pair and pair+compact; LDLᵗ on the same (unshifted)
   Laplacian in stream, block and slab; LU on
   ``convection_diffusion_3d(--lu-nx)`` in stream.  Per matrix the host
   analysis once and the left-looking ``fact_ms`` for reference (no
   claim); per schedule its own factorize program
   (``build_factorize_fn(e2=...)``): factorize twice (the second timed)
   and a refined solve to <= 1e-10, the schedule's kernel (K3, K5 or K6)
   launched, K1 not, no twin; where the reference's cost gate keeps no
   block or slab pair of the matrix the gate is opened, and the log says
   so; on the LDLᵗ slab path one more factorize under ``torch.profiler``
   (K4's and K6's device time and their shares of ``fact_ms``); then
   that kernel against its twin (twice, bit for bit) at the path's
   busiest level, timed and bound, and per matrix K2 against its twin;
12. fused-diagonal LLᵗ path (the reference's ``PASTIX_FUSED_DIAG=1``):
   ``poisson_3d(--nx)``, dense tail on, bf16 updates, left-looking and
   right-looking stream, each as in 4 (factorize twice, the second
   timed; a refined solve to <= 1e-10): K7 and K8 must launch (K1; or K3
   and not K1), no twin may run, and ``cholesky_ex`` runs only at the
   levels without panels; ``fact_ms`` beside the unfused one of phases 4
   and 11; then K7 on the left path's level with the most diagonal tiles
   against its twin and against ``cholesky_ex`` + ``solve_triangular``
   (two library calls), and K8 on one tile (the dense tail's call), both
   timed and bound; K1 (left) and K2 (both) against their twins; then K8
   on one tile at T = 32, 64 and 128 against its twin and timed beside
   the two library calls, on a tile of condition 1e4 (L against the twin,
   X against fp64 within T u cond(L)) and on a tile with a negative
   pivot (NaN where the twin has it);
13. E2 A/B harness (the reference's ``exp_pipe.py``): on exp_pipe's
   default triples (ng=8192, a pool of 12000 T=128 tiles, segments of
   about 3 pairs) and on the busiest right-looking level of phase 12's
   stream solver (its factored pool), bf16 and fp32, every variant of
   phase 3's slice 4 (K3 G=1/2, ``ab_pack`` G=1/2/4, K9, K10) against its
   twin (1e-4 max|ref|; each also twice, bit for bit), then kernel and
   twin timed and bound; the launches are those of the timed runs,
   counted from 0;
14. operand-cache harness (the reference's ``exp_cache.py`` and
   ``exp_mp.py``) on phase 13's poisson level with its bf16 panel stream:
   K11 (``gemm_scatter_vcache``, chunk 1536, group 2) and K12
   (``gemm_scatter_mp`` ``loop`` and ``dot2``, chunk 1536, G = 4 and 8),
   each against its twin and against ``kernels.gemm_scatter`` with bf16
   operands (1e-4 max|ref|; K12 also twice, bit for bit), beside the
   reference's K3 baselines (pools
   at G=2; ``xab`` at chunk 1536 and 6144); kernels and twins timed and
   bound, the cache's size (CT, MiB) and the mp padding logged; the
   launches those of the timed runs, counted from 0;
15. copy probe (the reference's ``exp_dma.py``): every row of its table
   (S = 1..32 tiles of 64 KB, D = 2..8 in flight; 32 KB and 16 KB
   sub-tiles, D = 2..16) in 4 KB bulk copies, then its first row on 1,
   4, 16 and 66 CTAs (on one at D = 8 and 16 too) and in 8, 16 and 32 KB
   bulk copies (32 KB on one CTA too), on a 786 MB pool, K13's (2, D, T)
   first- and last-row sums against
   ``probe_ref`` (1e-5 max|ref|), then K13, its twin and
   ``index_select`` of the same copies timed, µs per copy, GB/s and the
   bytes in flight logged against the bytes bound;
16. front door and refinement: on ``poisson_3d(--nx)`` (the main path's
   configuration, one host analysis saved with ``IOStrategy.SAVE`` and
   loaded by every later solver) the device loops ``CG``, ``GMRES`` and
   ``BICGSTAB``, then ``CG`` with ``device_refine=False`` and with
   ``fast_solve=False``: each solver analyzed, factorized and solved
   twice (the second solve timed), residual <= 1e-10, its iterations, its
   host steps and its preconditioner applications; K1 and K2 must launch
   (no K2 under ``fast_solve=False``, whose factors hold no inverse
   diagonal tiles; its peak device memory beside the fast path's), no
   twin may run, and the timed solve launches K2 at most twice an
   application; then ``factorize(values)`` with the stored diagonal
   raised by 10 % (refactor ms beside the first factorize's) against a
   fresh solver on the new matrix (equal iterations, solutions within
   1e-12, max|pool difference| logged), ``as_preconditioner`` under
   ``scipy.sparse.linalg.cg`` to 1e-10 within phase 4's iterations + 2,
   the array API ``pastix()`` with the phase window ORDERING..ANALYSE (no
   solution, no factors) and ORDERING..CLEAN (residual <= 1e-10), and
   ``clean()`` (the allocated bytes back within 64 MiB of their level
   before the solver); on ``convection_diffusion_3d(--lu-nx)`` LU
   ``GMRES`` and ``BICGSTAB`` the same way (K1, K2 and K4 launched); at
   ``poisson_3d(24)`` once each: ``MurgeSolver`` (graph, assembly, solve,
   then new values on the cached analysis), ``dspsolve`` over 4 CSCD
   parts and ``cli.main(["-lap3", "24", "--refine", "gmres",
   "--steps"])`` (exit code 0);
17. complex and fp64 factorizations (ROADMAP A3: torch ops in the pool's
   dtype, no hand kernel): at T=128, each solver analyzed (one host
   analysis a layout, saved and loaded), factorized twice (the second
   timed) and solved twice (the second timed): (a) Hermitian LLᴴ in
   complex64 and complex128 on ``herm_3d(--nx)`` (poisson_3d + i S -
   i Sᵀ, S = 0.2 N(0, 1) on the strict lower pattern, plus 0.1 I to stay
   definite; dense tail on); (b) complex-symmetric LDLᵗ and LLᵗ in
   complex64 on ``helmholtz_3d(--nx)`` (poisson_3d - (k² + 0.05i k²) /
   (nx + 1)² I, k = 10), GMRES; (c) LDLᴴ in complex64 on the indefinite
   ``herm_3d(--nx, 0) - σI`` (σ of phase 8), GMRES, its inertia from the
   real pivots logged; (d) complex LU in complex64 on
   ``convection_diffusion_3d(--lu-nx) + 0.3i |B|`` (a smaller nx if the
   pools do not fit twice over); (e) fp64 LLᵗ on ``poisson_3d(--nx)`` and
   LDLᵗ on phase 8's shift-invert matrix (the device loop); (f)
   ``cli.main(["-lap3", "24", "--dtype", "c128", "--steps"])`` (exit code
   0).  Each run: residual <= 1e-10 in the host's complex128 or fp64, no
   hand kernel launched and no twin run, its figures logged (``fact_ms``,
   the reference's real-arithmetic ``fact_flops``, solve and host
   refinement ms, steps, static pivots, peak memory).  Then, on the card
   only, the complex64 pools and unrefined solutions of (a) and (b) at 24³
   against the same solvers on the CPU (1e-4 max|cpu|), and a complex64
   ``bmm`` under ``pin_precision`` against complex128 (1e-5); the phase's
   seconds are logged;
18. ILU(k) and the packed E2 path (ROADMAP A5, A7), T=128, each run
   analyzed, factorized twice (the second timed) and solved twice (the
   second timed), its counts read after the factorizations and again
   after the solves, residual <= 1e-10 in the host's fp64: (a) block
   ILU(0) and ILU(1) LLᵗ on ``poisson_3d(--nx)``, bf16 updates, GMRES
   (the config's auto-upgrade), ``refinement_itermax=400``: K1 and K2
   launched, no twin, no dense tail; device and host steps, the tile
   count beside the complete layout's (phase 4), peak memory; then the
   ILU(0) factors as ``as_preconditioner`` under
   ``scipy.sparse.linalg.gmres`` to 1e-10; (b) block ILU(1) LU on
   ``convection_diffusion_3d(--lu-nx)``: K1, K4 and K2 launched; after
   each block ILU run, with the counts reset, K1 on the busiest level of
   its incomplete layout (each pool side of LU) against its twin
   (``TOL_E2``, a second run bit-identical) and K2 forward and backward
   on its factors against its twin (``TOL_K2``, one launch a direction,
   a second run bit-identical); (c)
   scalar ILU(1) on ``poisson_3d(24)`` and on
   ``convection_diffusion_3d(16)`` LU: host factors, no device program,
   no hand kernel launched, the host seconds logged; (d) packed LLᵗ on
   ``poisson_3d(--nx)`` (dense tail, bf16 updates), shift-invert LDLᵗ on
   phase 8's matrix (fp32 updates) and LU on
   ``convection_diffusion_3d(--lu-nx)`` (bf16): no K1 or K3 in the
   factorizations, K4 on LDLᵗ and LU, K2 in the solves; ``fact_ms``,
   useful GFLOP/s, steps, residual and peak memory beside the
   left-looking figures of phases 4, 7 and 8, and the packed plan's GEMM
   and TRSM flops beside the grid's padded count; (e) at 24³: packed
   with the plane z = 23 as Schur unknowns, ``get_schur`` against the
   sparse-LU S (1e-4 max|S|, fp32 updates, no K1 or K3), and, on the card
   only, a complex64 LLᴴ packed solver's pool and unrefined solution
   against the same solver on the CPU (1e-4 max|cpu|); the phase's
   seconds are logged;
19. out-of-core (ROADMAP A8), T=128, each streamed factorization with
   the counts set to 0 just before it and read just after (K3 launched,
   and K4 on LDLᵗ and LU; K1, K2, K5-K13 and every twin not), the card's
   cached blocks released and its peaks reset before it: peak allocated
   and reserved bytes <= ``ooc_limit_mb``; then a refined solve of
   b = A 1 through the streamed solve and the host loop to <= 1e-10,
   bytes and seconds uploaded and downloaded logged: (a) LLᵗ bf16 on
   ``poisson_3d(--nx)``, shift-invert LDLᵗ fp32 on phase 8's matrix and
   LU fp32 on ``convection_diffusion_3d(--lu-nx)`` (with bf16 updates
   its pools differ by a bf16 rounding here and there: PERF.md), each
   under a third of its pools (at least 3 segments), against the same
   matrix's resident ``e2="pair"`` solver (one host analysis, saved and
   loaded): LLᵗ and LU pools within 1e-4 max|resident| (the entries above
   1e-5 counted), LDLᵗ pools a level at a time within 1e-4 or 4 times
   that level's spread between the resident left-looking and pair
   schedules on the same matrix, the larger (how far fp32 summation
   order moves its factor: near-singular pivots make a few levels
   ill-determined), residuals and steps (within
   2); for each, K3 and K4 held against their twins on the inputs of the
   busiest segment and of the busiest that factors columns (the
   factorization streamed again up to them, each call checked before it
   runs: K3 at 1e-4, on buffer coordinates with export slots, LDLᵗ's
   ``d=`` and LU's ``src_pool=`` both ways, two runs bit-identical; K4
   at 1e-5 on each group of diagonal tiles, equal clamps); (a')
   auto-streaming: LLᵗ bf16 on
   ``poisson_3d(40)`` without ``ooc``, the card's free memory patched to
   a third of its pool: it streams (no device refinement loop) with its
   peaks within that memory; (b)
   LLᵗ bf16 on ``poisson_3d(--ooc-nx)`` under ``--ooc-mb``; (c) the
   offload: ``poisson_3d(24)`` LLᵗ with the plane z = 23 as Schur
   unknowns (which cannot stream) under a 1 MB limit: after the
   factorization the pool is in host memory and the card holds less than
   it, ``solve_with_schur`` restores it and launches K2 (residual <=
   1e-10); the phase's seconds are logged;
20. the rest of one device (ROADMAP A10, A3b, A6), T=128: (a) the main
   path's configuration with ``trace=True`` (``device_refine=False``: off
   a TPU the reference refines on the host, so its solve and refinement
   are two spans) on ``poisson_3d(--nx)``: analyzed, factorized twice,
   solved twice, K1 and K2 launched and no twin, residual <= 1e-10;
   ``dump_trace`` holds ``order``, ``symbfact``, ``analyze``,
   ``numfact``, ``solve`` and ``refine``, every ``dur`` >= 0 and each
   ``numfact`` span within 1 ms or 2 % of its ``report.fact_time``;
   ``fact_ms`` traced beside phase 4's untraced; then one factorize and
   solve under ``trace.profile_device``: K1 (``seg_mma_kernel``) and K2
   (``sweep_kernel``) in the profile, the ten device operations with the
   most time logged (name, calls, ms, share), and the matrix products
   outside the kernels split by caller (a second profile of the same
   calls, shapes recorded, ``matmul_callers``); (b) the cost model:
   ``perf.calibrate(T, force=True)`` on the card at T = 16 (K3's twin:
   K3 is not built for 16), 32, 64 and 128 into a fresh cache file, the
   seconds each takes (what a first factorize at that size pays) and its
   overhead and marginal seconds per body logged, the predicted
   ``fact_ms`` beside the measured one for the main path (this
   calibration), the LU path (phase 7) and the shift-invert LDLᵗ path
   (phase 8) (their factorizations' ``report.predicted_fact_time``;
   logged, not checked, as the reference checks none), and the main
   path's ``estimate_fact_time`` and ``speed_of_light``; (c) fp64 Schur on
   ``poisson_3d(24)`` with the plane z = 23 under LLᵗ, LDLᵗ and LU:
   factorized twice (the second timed), ``get_schur`` within 1e-10
   max|S| of the sparse-LU S, ``solve_with_schur`` to <= 1e-10, no hand
   kernel launched and no twin run; (d) the nine examples of
   ``pastix_tpu_torch/examples`` in this process with ``--device cuda``
   at ``tests/test_examples.py``'s arguments, each exiting 0 and
   printing that test's lines; the phase's seconds are logged;
21. the mesh (ROADMAP A9, ``pastix_tpu_torch/parallel``), T=128: ranks
   started by ``parallel.launch.run_ranks``, the mode logged.  With two
   or more cards, NCCL with one rank a card (up to 4; and a (2, 2) dp x
   tp mesh with 4); with one card, 4 ranks sharing it under gloo (owner
   runs at MESH_SHARED_NX: gloo carries every collective through host
   memory), then 1 rank under NCCL, whose collectives run on the card as
   on a group of several.  The runs: the owner-computes main path
   (``poisson_3d(--nx)``, bf16 updates), LU on
   ``convection_diffusion_3d(--lu-nx)``, LDLᵗ on phase 8's matrix with
   fp32 updates, then at MESH_SMALL_NX the replicated pool
   (``shard_pool=False``, the device loop: K2), Schur unknowns and the
   subtree schedule.  On every rank: the counts set to 0 just before the
   timed factorization and read after the solve (K3 on each run, K4 on
   LU and LDLᵗ, K2 on the replicated ones; no twin), the refined
   residual <= 1e-10, the pools against one card's factorization of the
   same analysis in fp64 a level at a time, within TOL_E2 or TOL_ORDER
   times one card's own fp32 error there (its pair schedule, the same
   right-looking order and update dtype), ``get_schur`` within 1e-4 of
   the sparse-LU S,
   and K3 and K4 against their twins on the rank's busiest level with a
   second run bit-identical (their errors join the ``[xab]`` and K4
   rows); logged: ``fact_ms`` beside one card's on the same analysis,
   ``nloc`` against npool, each rank's peak memory, the owner plan's
   flop imbalance and halo MiB; K3 timed on rank 0's busiest owner level
   with the other ranks held at a barrier (a kernels row a mode); any
   rank's failure fails the script.  The 4 gloo ranks' owner runs at
   the full sizes (about 7 minutes) are not in the phase: call
   ``mesh_path(64, 70, 64, MESH_SMALL_NX, 64, ...)`` from a script that
   builds the library first;

then the card's nvidia-smi line, one JSON line of the kernels (each
variant on its own line of the list, ``launches`` from the path that runs
it), and last ``{"ok": true, "device": {...}}``.  --nx 64 is
n = 262,144; --nx 100 is the 1M-unknown flagship of bench.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

TOL_E2 = 1e-4  # max|kernel - twin| / max|twin| for K1 and K3
TOL_K2 = 1e-5  # the same for the sweeps
TOL_K4 = 1e-5  # the same for the static-pivot tile factorization
TOL_K7 = 1e-5  # the same for the fused Cholesky + inverse (K7, K8)
TOL_K13 = 1e-5  # the copy probe's (2, D, T) sums against the closed form
TOL_RES = 1e-10  # fp64 ||b - A x|| / ||b|| after refinement
TOL_S = 1e-4  # max|S - S_ref| / max|S_ref| with fp32 updates
TOL_REFAC = 1e-12  # factorize(values) against a fresh solver, relative
CLEAN_SLACK = 64 * 2 ** 20  # bytes clean() may leave allocated
# the skew part of herm_3d lowers the smallest eigenvalues by about 0.041
# (eigsh on the host, nx = 16 to 40); poisson_3d(64)'s smallest is 0.007,
# so phase 17 (a) adds this to stay definite
HERM_DELTA = 0.1
TOL_ORDER = 4.0  # streamed LDLᵗ pools against resident ones a level at
# a time, in units of that level's spread between the resident
# left-looking and pair schedules (where it is above TOL_E2 / 4); a
# mesh's pools against fp64 a level at a time, in units of one card's
# fp32 error there
TOL_CARD = 1e-4  # card against CPU, complex64 pool and solution, max|ref|
TOL_BMM = 1e-5  # complex64 bmm against complex128 under pin_precision
# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
PEAK_BF16, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` runs after one
    warm-up, by CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int = 20):
    """Mean device time of ``fn()`` in ms, the sum of every kernel, copy
    and fill it runs on the card, by ``torch.profiler`` over ``reps``
    runs after one warm-up: free of the host's launch overhead, which
    :func:`cuda_ms` includes when the host is the slower side.  None if
    the profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    return total / reps / 1e3 or None


def bound(flops: float, peak: float, nbytes: float):
    """(bound_ms, bound_by): the larger of operations over the peak rate
    and bytes over the memory rate."""
    t_op, t_by = flops / peak, nbytes / PEAK_BYTES
    return max(t_op, t_by) * 1e3, ("operations" if t_op >= t_by else "bytes")


def k1_flops(c, T=128):
    """A K1 chunk's operations: 2 H T² per pair (row-bounded a)."""
    return c.n_pairs * 2.0 * c.H * T ** 2


def k3_flops(c, T=128):
    """A K3 chunk's operations: 2 T³ per pair (full tiles)."""
    return c.n_pairs * 2.0 * T ** 3


def e2_bound_lists(lists, T, pair_flops, upd):
    """Bound of E2 lists ``(chunks, dst_pool, src_pool)`` run as one step
    (the LU pool side and its pool_u mirror) with ``upd`` operands: a read
    from the dst pool, b from the src pool, each distinct (pool, tile)
    once; each dst tile read and written once; the pivot rows of d that
    the pairs name, once."""
    import torch

    flops, reads, dsts, krows = 0.0, {}, {}, set()
    for chunks, dk, sk in lists:
        flops += sum(pair_flops(c) for c in chunks)
        for c in chunks:
            reads.setdefault(dk, set()).update(c.pair_a.tolist())
            reads.setdefault(sk, set()).update(c.pair_b.tolist())
            dsts.setdefault(dk, set()).update(c.seg_dst.tolist())
            if c.pair_k is not None:
                krows.update(c.pair_k.tolist())
    tile = T * T * 4
    nbytes = (sum(map(len, reads.values())) * tile
              + 2 * sum(map(len, dsts.values())) * tile + len(krows) * T * 4)
    peak = PEAK_BF16 if upd == torch.bfloat16 else PEAK_FP32
    return bound(flops, peak, nbytes)


def check_e2(name, run, run_ref, pool, chunks, update_dtype, label,
             repeat=False, quiet=False, **kw):
    """An E2 kernel (K1, K3, K5 or K6) against its twin on copies of
    ``pool`` (``kw``: the ``d`` or ``src_pool`` variant, K3's operand
    arrays); ``repeat``: a second run must be bit-identical; ``quiet``
    logs a failure only.  Returns max|d|."""
    import torch

    got = run(pool.clone(), chunks, update_dtype, **kw)
    if repeat and not torch.equal(got, run(pool.clone(), chunks,
                                           update_dtype, **kw)):
        raise AssertionError(f"{name} {label}: two runs differ")
    ref = run_ref(pool.clone(), chunks, update_dtype, **kw)
    torch.cuda.synchronize()
    touched = torch.cat([c.seg_dst for c in chunks]).unique()
    scale = float(ref[touched].abs().max())
    err = float((got - ref).abs().max())
    ok = err <= TOL_E2 * scale
    if quiet and ok:
        return err
    log(f"{name} {label}: {len(chunks)} chunks, "
        f"{sum(c.n_pairs for c in chunks)} pairs, max|d|={err:.3e} "
        f"max|ref|={scale:.3e}{', two runs bit-identical' if repeat else ''}"
        f" -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label} disagrees with its twin")
    return err


def check_k1(pool, chunks, update_dtype, label, **kw):
    from pastix_tpu_torch.numeric import leftlook as LL

    return check_e2("K1", LL.gemm_scatter_ll, LL.gemm_scatter_ll_ref, pool,
                    chunks, update_dtype, label, repeat=True, **kw)


def check_k3(pool, chunks, update_dtype, label, quiet=False, **kw):
    from pastix_tpu_torch.numeric import pipelined as PL

    return check_e2("K3", PL.gemm_scatter_pipelined,
                    PL.gemm_scatter_pipelined_ref, pool, chunks,
                    update_dtype, label, repeat=True, quiet=quiet, **kw)


def sweep_pair(solver):
    """The (pool, dinv, lu) of the solver's forward and backward sweeps:
    LU sweeps backward over the Uᵗ pool with the upper inverses."""
    f = solver.factors
    if f.pool_u is not None:
        return (f.pool, f.dinv, False), (f.pool_u, f.dinv_u, True)
    return (f.pool, f.dinv, False), (f.pool, f.dinv, False)


def check_k2(solver, R, seed):
    """K2 forward + backward against its twin, one launch a direction and
    a second run bit-identical; returns max|d|."""
    import torch
    from pastix_tpu_torch.numeric import sweep_kernels as SW

    lay, f = solver.layout, solver.factors
    plan = solver._solve_fn.plan
    g = torch.Generator(device=f.pool.device).manual_seed(seed)
    y2 = torch.randn(lay.nbc * R, lay.T, generator=g, device=f.pool.device)
    got, again, ref = y2.clone(), y2.clone(), y2.clone()
    n0 = SW.run_sweep.launches
    for key, (pool, dinv, lu) in zip(("fwd", "bwd"), sweep_pair(solver)):
        SW.run_sweep(pool, dinv, got, plan, key, lu)
        SW.run_sweep(pool, dinv, again, plan, key, lu)
        SW.run_sweep_ref(pool, dinv, ref, plan, key, lu)
    torch.cuda.synchronize()
    if SW.run_sweep.launches != n0 + 4 or not torch.equal(got, again):
        raise AssertionError("K2: not one launch a direction, or two runs "
                             "differ")
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = err <= TOL_K2 * scale
    kind = "LU " if f.pool_u is not None else ""
    log(f"K2 {kind}fwd+bwd R={R}: max|d|={err:.3e} max|ref|={scale:.3e} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K2 {kind}R={R} disagrees with its twin")
    return err


def k2_timed(solver):
    """K2 fwd + bwd at R = 1, kernel and twin, with its bound: every op
    one (T, T) x (T, 1) product; every pool tile and inverse diagonal the
    plan names read once (from both pools for LU), y read and written
    once."""
    import torch
    from pastix_tpu_torch.numeric import sweep_kernels as SW

    lay, plan = solver.layout, solver._solve_fn.plan
    y2 = torch.randn(lay.nbc, lay.T, device=solver.factors.pool.device)
    sides = sweep_pair(solver)

    def sweeps(run):
        for key, (pool, dinv, lu) in zip(("fwd", "bwd"), sides):
            run(pool, dinv, y2, plan, key, lu)

    ms = cuda_ms(lambda: sweeps(SW.run_sweep))
    plain = cuda_ms(lambda: sweeps(SW.run_sweep_ref))
    nops = sum(ph.op_tile.numel() if ph.kind == "upd" else ph.cols.numel()
               for key in ("fwd", "bwd") for ph in plan[key])
    tiles = torch.cat([ph.op_tile for ph in plan["fwd"] if ph.kind == "upd"])
    ncols = sum(ph.cols.numel() for ph in plan["fwd"] if ph.kind == "diag")
    npools = 2 if sides[1][2] else 1
    bd = bound(nops * 2.0 * lay.T ** 2, PEAK_FP32,
               npools * (tiles.unique().numel() + ncols) * lay.T ** 2 * 4
               + 2 * lay.nbc * lay.T * 4)
    items = {k: plan["items"][k].nitems for k in ("fwd", "bwd")}
    for key in ("fwd", "bwd"):
        n, slots, most, ops = k2_critical_chain(plan["items"][key], lay.nbc)
        log(f"  K2 {key}: longest dependent chain {n} items; its diag "
            f"items sum {slots:.1f} slots (at most {most}), its update "
            f"items hold {ops:.2f} ops")
    log(f"timing K2 {'LU ' if npools == 2 else ''}fwd+bwd R=1 "
        f"({len(plan['fwd']) + len(plan['bwd'])} phases, items {items}): "
        f"kernel {ms:.3f} ms, twin {plain:.3f} ms, bound {bd[0]:.3f} ms "
        f"({bd[1]})")
    return ms, plain, bd


def k2_critical_chain(items, nbc):
    """The longest chain of dependent work items of one K2 direction,
    from its host tables: (items on it, the mean and largest slot count
    of its diag items, the mean op count of its update items)."""
    it = items.item.cpu().numpy()
    slots = items.slot_list.cpu().numpy()
    src, wait = items.op_src.cpu().numpy(), items.op_wait.cpu().numpy()
    kind, col, lo, hi = it[:, 0], it[:, 1], it[:, 2], it[:, 3]
    red = np.flatnonzero(kind != 1)
    owner = np.full(nbc, -1)
    owner[col[red]] = red
    upd = np.flatnonzero(kind == 1)
    depth, parent = np.zeros(len(it), np.int64), np.full(len(it), -1)
    for t in range(len(it)):
        if kind[t] == 1:
            deps = owner[src[lo[t]:hi[t]][wait[lo[t]:hi[t]] != 0]]
        else:
            deps = upd[slots[lo[t]:hi[t]]]
        if deps.size:
            j = deps[np.argmax(depth[deps])]
            depth[t], parent[t] = depth[j] + 1, j
    chain, t = [], int(np.argmax(depth))
    while t >= 0:
        chain.append(t)
        t = parent[t]
    n = (hi - lo)[chain]
    on_upd = kind[chain] == 1
    return (len(chain), float(n[~on_upd].mean()), int(n[~on_upd].max()),
            float(n[on_upd].mean()))


def k2_chain_timed(dev, n=256, T=128):
    """K2 on a chain of ``n`` columns, each column's one update feeding
    the next column's diagonal: every item waits on the one before, so
    the time over the 2 n - 1 items is K2's latency an item on a
    dependent path (the sweeps' critical path is such a chain, about 185
    items a direction at Poisson 64^3).  Checked against the twin."""
    import torch
    from pastix_tpu_torch.numeric import sweep_kernels as SW

    g = torch.Generator(device=dev).manual_seed(7)
    phases = []
    for c in range(n):
        phases.append(("diag", np.array([c])))
        if c + 1 < n:
            phases.append(("upd", np.array([c]), np.array([c]),
                           np.array([c + 1])))
    tabs = SW.sweep_direction(phases, n, dev)
    plan = {"nbc": n, "T": T, "fwd": tabs[0], "items": {"fwd": tabs[1]}}
    pool = torch.randn(n, T, T, device=dev, generator=g) / T
    dinv = (torch.eye(T, device=dev)
            + torch.randn(n, T, T, device=dev, generator=g) / (4 * T))
    y2 = torch.randn(n, T, device=dev, generator=g)
    got, ref = y2.clone(), y2.clone()
    SW.run_sweep(pool, dinv, got, plan, "fwd")
    SW.run_sweep_ref(pool, dinv, ref, plan, "fwd")
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not err <= TOL_K2 * float(ref.abs().max()):
        raise AssertionError(f"K2 chain disagrees with its twin ({err:.3e})")
    ms = cuda_ms(lambda: SW.run_sweep(pool, dinv, y2.clone(), plan, "fwd"))
    log(f"timing K2 chain of {n} columns ({2 * n - 1} dependent items): "
        f"{ms:.3f} ms, {ms * 1e3 / (2 * n - 1):.2f} us an item; max|d| "
        f"{err:.3e}")
    return ms


def planted_tiles(T, lu, n=6, seed=0):
    """(tiles, clamps): ``n`` random diagonally dominant tiles with zero
    pivots planted by a zero row and column, which stay exactly zero
    through the updates, each clamped once: tile 0 at 0, tile 1 at 0 and
    5, tile 2 at T - 1, and either side of K4's first 32 x 32 block
    step, tile 3 at 31 and tile 4 at 32 (T > 32)."""
    import torch

    rng = np.random.default_rng(seed)
    R = rng.standard_normal((n, T, T))
    M = R + (0 if lu else R.transpose(0, 2, 1)) + 2 * T * np.eye(T)
    planted = ((0, 0), (1, 0), (1, 5), (2, T - 1), (3, 31)) + (
        ((4, 32),) if T > 32 else ())
    for t, k in planted:
        M[t, k, :] = M[t, :, k] = 0.0
    return torch.tensor(M, dtype=torch.float32, device="cuda"), len(planted)


def check_k4(tiles, eps, lu, label, expect=None, quiet=False):
    """K4 against its twin on copies of ``tiles`` (all factored): equal
    clamp counts (and ``expect`` when given), max|d| <= 1e-5 max|ref| on
    the tiles and, for LDLᵗ, on d, and a second K4 run bit-identical to
    the first; ``quiet`` logs a failure only.  Returns max|d|."""
    import torch
    from pastix_tpu_torch.numeric import tile_factor as TF

    idx = torch.arange(tiles.shape[0], device=tiles.device)
    got, again, ref = tiles.clone(), tiles.clone(), tiles.clone()
    n_got = torch.zeros((), dtype=torch.int32, device=tiles.device)
    n_again, n_ref = torch.zeros_like(n_got), torch.zeros_like(n_got)
    d_got = TF.tile_factor(got, idx, eps, n_got, lu)
    d_again = TF.tile_factor(again, idx, eps, n_again, lu)
    d_ref = TF.tile_factor_ref(ref, idx, eps, n_ref, lu)
    torch.cuda.synchronize()
    same = torch.equal(got, again) and int(n_got) == int(n_again) and (
        d_got is None or torch.equal(d_got, d_again))
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    ok = same and err <= TOL_K4 * scale and int(n_got) == int(n_ref)
    if expect is not None:
        ok = ok and int(n_got) == expect
    if d_got is not None:
        d_err = float((d_got - d_ref).abs().max())
        ok = ok and d_err <= TOL_K4 * float(d_ref.abs().max())
        err = max(err, d_err)
    if quiet and ok:
        return err
    log(f"K4 {'LU' if lu else 'LDLT'} {label}: {tiles.shape[0]} tiles, "
        f"clamps {int(n_got)} (twin {int(n_ref)}), max|d|={err:.3e} "
        f"max|ref|={scale:.3e}, two runs "
        f"{'bit-identical' if same else 'DIFFER'} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K4 {label} disagrees with its twin")
    return err


def busiest_level(fact_fn):
    return max(fact_fn.levels, key=lambda lv: sum(c.n_pairs for c in lv.ll))


def busiest_residue(fact_fn):
    return max(fact_fn.levels,
               key=lambda lv: sum(c.n_pairs for c in lv.schur)).schur


def analyzed(A, cfg, dev, schur=None):
    from pastix_tpu_torch import Pastix

    s = Pastix(A, cfg, device=dev)
    if schur is not None:
        s.set_schur_unknowns(schur)
    t = {}
    for phase in ("order", "symbfact", "analyze"):
        t0 = time.perf_counter()
        getattr(s, phase)()
        t[phase] = time.perf_counter() - t0
    return s, t


def last_plane(nx):
    """The Schur unknowns: the plane z = nx-1, the last nx^2 unknowns of
    the generator's lexicographic numbering."""
    n = nx ** 3
    return np.arange(n - nx * nx, n)


def schur_reference(A, schur):
    """A22 - A21 A11^-1 A12 in fp64, through a sparse LU of A11."""
    import scipy.sparse.linalg as spla

    M = A.to_scipy().tocsc()
    rest = np.setdiff1d(np.arange(A.n), schur)
    A11 = M[rest][:, rest].tocsc()
    X = spla.splu(A11).solve(M[rest][:, schur].toarray())
    return M[schur][:, schur].toarray() - M[schur][:, rest] @ X


def counters():
    from pastix_tpu_torch.numeric import block as BK
    from pastix_tpu_torch.numeric import cache as CA
    from pastix_tpu_torch.numeric import chol_inv as CI
    from pastix_tpu_torch.numeric import dma_probe as DP
    from pastix_tpu_torch.numeric import fused as FU
    from pastix_tpu_torch.numeric import leftlook as LL
    from pastix_tpu_torch.numeric import pipelined as PL
    from pastix_tpu_torch.numeric import slab as SB
    from pastix_tpu_torch.numeric import sweep_kernels as SW
    from pastix_tpu_torch.numeric import tile_factor as TF

    return {"K1": LL.gemm_scatter_ll, "K2": SW.run_sweep,
            "K3": PL.gemm_scatter_pipelined, "K4": TF.tile_factor,
            "K5": BK.gemm_scatter_block, "K6": SB.gemm_scatter_slab,
            "K7": CI.chol_inv_pool, "K8": CI.chol_inv,
            "K9": FU.gemm_scatter_fused, "K10": FU.gemm_scatter_blockspec,
            "K11": CA.gemm_scatter_vcache, "K12": CA.gemm_scatter_mp,
            "K13": DP.probe}


def reset_counts():
    from pastix_tpu_torch.numeric import leftlook as LL

    for fn in counters().values():
        fn.launches = fn.twin_launches = 0
    LL.gemm_scatter_ll.half_launches = 0


def read_counts(path, need, forbid=()):
    """The launch counts since :func:`reset_counts`; fails unless every
    kernel of ``need`` launched, none of ``forbid`` did and no twin ran."""
    launches = {k: fn.launches for k, fn in counters().items()}
    twins = {k: fn.twin_launches for k, fn in counters().items()}
    log(f"  {path}: launches {launches}, twin calls {twins}")
    if (min((launches[k] for k in need), default=1) == 0
            or max(twins.values()) != 0
            or any(launches[k] for k in forbid)):
        raise AssertionError(
            f"the {path} did not run through all of {need}, ran one of "
            f"{forbid}, or ran a twin")
    return launches


def shift_invert(nx):
    """poisson_3d(nx) - σI, σ halfway between the two smallest eigenvalues
    of the 7-point Laplacian, λ = Σ 2 - 2 cos(k π / (nx + 1)): exactly one
    negative eigenvalue.  Returns (matrix, σ)."""
    import scipy.sparse as sp
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.sparse import SparseMatrix

    mu = lambda k: 2.0 - 2.0 * np.cos(k * np.pi / (nx + 1))
    sigma = (3 * mu(1) + 2 * mu(1) + mu(2)) / 2
    M = (poisson_3d(nx).to_scipy() - sigma * sp.eye(nx ** 3)).tocsc()
    return SparseMatrix.from_scipy(M, symmetric_storage=True), sigma


def kind_cfg(kind, upd="bfloat16"):
    from pastix_tpu_torch.config import PastixConfig

    return PastixConfig(tile_size=128, update_dtype=upd, factorization=kind)


def drive(path, A, cfg, dev, need, schur=None, forbid=()):
    """One path at full width, its counts set to 0 just before and read
    just after: order, symbfact, analyze, factorize twice (the second
    timed), then a refined solve of b = A.1 (``schur``: ``get_schur`` and
    ``solve_with_schur``) to a fp64 residual <= 1e-10.  Returns (solver,
    launches, numbers)."""
    import torch
    from pastix_tpu_torch.numeric import leftlook as LL

    dev_ = torch.device(dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev_)
    s, t = analyzed(A, cfg, dev, schur=schur)
    lay = s.layout
    npools = 2 if cfg.factorization.name == "LU" else 1
    pool_gib = npools * lay.npool * lay.T ** 2 * 4 / 2 ** 30
    log(f"{path}: n={A.n} T={lay.T} nbc={lay.nbc} npool={lay.npool} "
        f"pools={pool_gib:.3f} GiB levels={s.report.n_levels} "
        f"dense_tail_m={s.report.dense_tail_m}"
        + (f" schur={schur.size}" if schur is not None else ""))
    log(f"  order {t['order']:.3f} s  symbfact {t['symbfact']:.3f} s  "
        f"analyze {t['analyze']:.3f} s")
    fact_s = []
    for _ in range(2):
        s.factorize()
        fact_s.append(s.report.fact_time)
    gflops = s.report.fact_flops / fact_s[1] / 1e9
    log(f"  factorize {fact_s[0] * 1e3:.1f} ms (first), "
        f"{fact_s[1] * 1e3:.1f} ms (second); useful {gflops:.1f} GFLOP/s "
        f"(flops {s.report.fact_flops:.4e}, padded "
        f"{s.report.fact_flops_padded:.4e}); static_pivots "
        f"{s.report.static_pivots}")
    M = A.to_scipy()
    b = M @ np.ones(A.n)
    get_ms = None
    if schur is None:
        x = s.solve(b)
        what = "solve+refine"
    else:
        t0 = time.perf_counter()
        S = s.get_schur()
        get_ms = (time.perf_counter() - t0) * 1e3
        asym = float(np.abs(S - S.T).max())
        log(f"  get_schur {S.shape} in {get_ms:.1f} ms, finite "
            f"{bool(np.isfinite(S).all())}, max|S - S^T| {asym}")
        if S.shape != (schur.size, schur.size) or not np.isfinite(S).all():
            raise AssertionError("Schur complement has the wrong shape or "
                                 "is not finite")
        if npools == 1 and asym != 0:
            raise AssertionError("Schur complement is not symmetric")
        x = s.solve_with_schur(b)
        what = "solve_with_schur"
    res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
    peak = torch.cuda.max_memory_allocated(dev_) / 2 ** 30
    log(f"  {what} {s.report.solve_time * 1e3:.1f} ms, refine_iters "
        f"{s.report.refine_iters}, residual {s.report.residual:.3e} "
        f"(original order {res:.3e}), max|x-1| {np.abs(x - 1).max():.3e}")
    log(f"  peak device memory {peak:.3f} GiB")
    if x.shape != (A.n,) or not np.isfinite(x).all():
        raise AssertionError("solution has the wrong shape or is not finite")
    if not max(res, s.report.residual) <= TOL_RES:
        raise AssertionError(f"{path}: residual {res:.3e} above {TOL_RES}")
    launches = read_counts(path, need, forbid)
    log(f"  K1 launches on 128 x 64 halves: "
        f"{LL.gemm_scatter_ll.half_launches} of {launches['K1']}")
    if schur is None:
        # K2: one launch a sweep direction, a fwd+bwd pair a precondition
        # (the first solve and one a refinement step)
        pairs = s.report.refine_iters + 1
        log(f"  K2 launches {launches['K2']} for {pairs} fwd+bwd sweep "
            f"pairs")
        if launches["K2"] > 2 * pairs:
            raise AssertionError(f"{path}: more than 2 K2 launches a "
                                 "fwd+bwd sweep pair")
    return s, launches, {
        "fact_ms": fact_s[1] * 1e3, "gflops": gflops,
        "solve_ms": s.report.solve_time * 1e3, "get_schur_ms": get_ms,
        "iters": s.report.refine_iters,
        "predicted_ms": s.report.predicted_fact_time * 1e3,
        "residual": s.report.residual, "static_pivots": s.report.static_pivots,
        "tiles": lay.npool, "levels": s.report.n_levels,
        "pool_gib": pool_gib, "peak_gib": peak,
    }


def k1_lists(solver, lv):
    """The K1 lists of one level as (chunks, kwargs, dst, src): LDLᵗ the
    scaled pass, LU the pool pass and its pool_u mirror."""
    f = solver.factors
    if f.pool_u is not None:
        out = [(lv.ll, {"src_pool": f.pool_u}, f.pool, "pool")]
        if lv.ll_nd:
            out.append((lv.ll_nd, {"src_pool": f.pool}, f.pool_u, "pool_u"))
        return out
    if f.d is not None:
        return [(lv.ll, {"d": f.d}, f.pool, "pool")]
    return [(lv.ll, {}, f.pool, "pool")]


def k3_lists(solver, lv):
    """The K3 lists of one level, as :func:`k1_lists`."""
    f = solver.factors
    if f.pool_u is not None:
        out = [(lv.schur, {"src_pool": f.pool_u}, f.pool, "pool")]
        if lv.schur_nd:
            out.append((lv.schur_nd, {"src_pool": f.pool}, f.pool_u,
                        "pool_u"))
        return out
    return [(lv.schur, {"d": f.d} if f.d is not None else {}, f.pool,
             "pool")]


def upd_of(solver):
    """The torch dtype of the solver's trailing updates."""
    import torch

    return torch.bfloat16 if solver.config.update_dtype else torch.float32


def e2_timed(name, run, run_ref, lists, T, pair_flops, upd):
    """One level's E2 lists (``k1_lists``/``k3_lists``) run as one step
    on copies of their pools with ``upd`` operands, kernel and twin, with
    the bound at that dtype's peak."""
    other = {"pool": "pool_u", "pool_u": "pool"}
    pools = {}
    for _, kw, pool, key in lists:
        pools[key] = pool
        if "src_pool" in kw:
            pools[other[key]] = kw["src_pool"]
    work = {key: pool.clone() for key, pool in pools.items()}

    def step(fn):
        for chunks, kw, _, key in lists:
            kw = dict(kw)
            if "src_pool" in kw:
                kw["src_pool"] = work[other[key]]
            fn(work[key], chunks, upd, **kw)

    ms = cuda_ms(lambda: step(run))
    plain = cuda_ms(lambda: step(run_ref))
    bd = e2_bound_lists(
        [(c, key, other[key] if "src_pool" in kw else key)
         for c, kw, _, key in lists], T, pair_flops, upd)
    pairs = sum(ch.n_pairs for c, _, _, _ in lists for ch in c)
    log(f"timing {name} ({sum(len(c) for c, _, _, _ in lists)} chunks, "
        f"{pairs} pairs, {str(upd)[6:]}): kernel {ms:.3f} ms, twin "
        f"{plain:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]})")
    del work, pools
    return ms, plain, bd


def k4_timed(solver, lu):
    """K4 on the busiest level's diagonal tiles of A (most tiles), kernel,
    twin and, for LU, ``torch.linalg.lu_factor_ex(pivot=False)`` (the same
    function when no pivot is clamped); each call factors a fresh copy,
    whose time is measured alone and taken off.  Bound: 2/3 T^3 (LU) or
    1/3 T^3 (LDLᵗ) flop per tile at the fp32 peak, or the bytes per tile at
    the memory rate: LU reads and writes the tile (2 T^2 floats), LDLᵗ
    reads its lower triangle and writes the tile and the pivots
    (T(T+1)/2 + T^2 + T floats)."""
    import scipy.sparse as sp
    import torch
    from pastix_tpu_torch.numeric import tile_factor as TF
    from pastix_tpu_torch.numeric.kernels import tri_inv_batch

    lay = solver.layout
    T = lay.T
    lv = max(solver._fact_fn.levels, key=lambda lv: lv.diag.numel())
    vals = torch.as_tensor(sp.coo_matrix(solver._A_perm).data.astype(
        np.float32), device=lv.diag.device)
    pools = solver._coef_fn(vals)
    pool = pools[0] if isinstance(pools, tuple) else pools
    tiles = pool[lv.diag].clone()
    del pools, pool
    B = tiles.shape[0]
    work = tiles.clone()
    idx = torch.arange(B, device=tiles.device)
    npiv = torch.zeros((), dtype=torch.int32, device=tiles.device)
    eps = 1e-14 * float(abs(solver._A_perm).max())
    copy_ms = cuda_ms(lambda: work.copy_(tiles))
    ms = cuda_ms(lambda: (work.copy_(tiles),
                          TF.tile_factor(work, idx, eps, npiv, lu))) - copy_ms
    plain = cuda_ms(lambda: (work.copy_(tiles),
                             TF.tile_factor_ref(work, idx, eps, npiv, lu)),
                    reps=2) - copy_ms
    lib = None
    if lu:
        lib = cuda_ms(lambda: torch.linalg.lu_factor_ex(tiles, pivot=False))
    floats = 2 * T * T if lu else T * (T + 1) // 2 + T * T + T
    bd = bound(B * (2.0 if lu else 1.0) / 3.0 * T ** 3, PEAK_FP32,
               B * floats * 4)
    log(f"timing K4 {'LU' if lu else 'LDLT'} busiest level ({B} tiles): "
        f"kernel {ms:.3f} ms, twin {plain:.3f} ms, bound {bd[0]:.4f} ms "
        f"({bd[1]}), lu_factor_ex(pivot=False) "
        f"{'n/a' if lib is None else f'{lib:.3f} ms'}")
    err = check_k4(tiles, eps, lu, f"{'LU' if lu else 'LDLT'} path busiest "
                   "level")
    # the inverses the factorization takes after K4 (numeric/factorize.py:
    # LU U^-1 and the unit L^-1, LDLᵗ the unit L^-1), on the same tiles
    work.copy_(tiles)
    TF.tile_factor(work, idx, eps, npiv, lu)
    tri = ((lambda: (tri_inv_batch(work, upper=True),
                     tri_inv_batch(work, unit=True))) if lu
           else (lambda: tri_inv_batch(work, unit=True)))
    tri_ms = cuda_ms(tri)
    log(f"timing tri_inv_batch on the same {B} factored tiles "
        f"({'two calls, upper then unit' if lu else 'one call, unit'}): "
        f"{tri_ms:.3f} ms")
    return ms, plain, bd, lib, err, tri_ms


def factor_kernels(solver, num, launches):
    """One more ``factorize()`` of a solver under ``torch.profiler``: K4's
    device time summed by kernel name (``tile_factor_kernel``) and its
    share of ``num["fact_ms"]`` (the path's second, unprofiled call), the
    run's device time over every kernel, copy and fill, and its eight
    longest kernels by name, logged; the numbers go into ``num``.  K4's
    profiled launches must be those of one factorization (half of the
    path's ``launches``, which counted two).  Where the path launched K6,
    K6 is summed and checked so (its kernels by :data:`K6_NAMES`), its
    numbers in ``num`` as ``k6_device_ms`` and ``k6_share``."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solver.factorize()
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    k4 = [r for r in rows if "tile_factor_kernel" in r[0]]
    k4_ms, k4_n = sum(r[1] for r in k4), sum(r[2] for r in k4)
    log(f"  one factorize under the profiler: device {total:.3f} ms; K4 "
        f"{k4_ms:.3f} ms in {k4_n} launches (path's count "
        f"{launches['K4'] // 2} a factorization), "
        f"{100 * k4_ms / num['fact_ms']:.1f} % of fact_ms "
        f"{num['fact_ms']:.1f}")
    for name, ms, n in rows[:8]:
        log(f"    {ms:9.3f} ms {n:5d}x {name[:100]}")
    if not total or k4_n != launches["K4"] // 2:
        raise AssertionError("the profiler did not see one factorization's "
                             "K4 launches")
    num.update(k4_device_ms=k4_ms, k4_share=k4_ms / num["fact_ms"],
               fact_device_ms=total)
    if launches["K6"]:
        k6 = [r for r in rows if re.search(K6_NAMES, r[0])]
        k6_ms, k6_n = sum(r[1] for r in k6), sum(r[2] for r in k6)
        log(f"  K6: {k6_ms:.3f} ms in {k6_n} launches (path's count "
            f"{launches['K6'] // 2} a factorization), "
            f"{100 * k6_ms / num['fact_ms']:.1f} % of fact_ms")
        if k6_n != launches["K6"] // 2:
            raise AssertionError("the profiler did not see one "
                                 "factorization's K6 launches")
        num.update(k6_device_ms=k6_ms, k6_share=k6_ms / num["fact_ms"])


def k1_gather_timed(lists, T):
    """The per-chunk bf16 operand gather of ``gemm_scatter_ll`` alone
    over one level's K1 lists (CUDA events), as the wrapper runs it."""
    import torch

    nu = max(c.cu.numel() for chunks, _, _, _ in lists for c in chunks)
    pool = lists[0][2]
    cache = torch.empty((nu, T, T), dtype=torch.bfloat16, device=pool.device)

    def run():
        for chunks, kw, pool, _ in lists:
            src = kw.get("src_pool", pool)
            for c in chunks:
                cache[: c.cu.numel()].copy_(src.index_select(0, c.cu))

    return cuda_ms(run)


def check_lists(check, lists, label, errs, key, upd):
    """``check`` (check_k1 / check_k3) on each list of
    ``k1_lists``/``k3_lists`` with ``upd`` operands; the largest max|d|
    goes to ``errs[key]``."""
    for chunks, kw, pool, side in lists:
        errs[key] = max(errs[key], check(pool, chunks, upd,
                                         f"{label} {side} {str(upd)[6:]}",
                                         **kw))


def main_path(nx, dev, errs):
    """Phases 4 and 5: the LLᵗ main path, then K1 (busiest level and the
    dense tail's pre-pass) and K2 against their twins and timed at its
    shapes."""
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.numeric import leftlook as LL

    s, launches, num = drive(
        f"main path poisson_3d({nx})", poisson_3d(nx),
        kind_cfg(Factorization.LLT), dev, ("K1", "K2"))
    lv, upd = busiest_level(s._fact_fn), upd_of(s)
    tail = [(s._fact_fn.tail, {}, s.factors.pool, "pool")]
    check_lists(check_k1, k1_lists(s, lv), "main path busiest level", errs,
                "K1", upd)
    check_lists(check_k1, tail, "main path tail", errs, "K1", upd)
    errs["K2"] = max(errs["K2"], check_k2(s, 1, seed=0))
    k1 = e2_timed("K1 main path busiest level", LL.gemm_scatter_ll,
                  LL.gemm_scatter_ll_ref, k1_lists(s, lv), s.layout.T,
                  k1_flops, upd)
    shape = lambda chunks: [
        (c.nseg, c.n_pairs, int((c.seg_ptr[1:] - c.seg_ptr[:-1]).max()))
        for c in chunks]
    log(f"  K1 chunks (segments, pairs, longest segment): busiest level "
        f"{shape(lv.ll)}; tail pre-pass {shape(s._fact_fn.tail)}")
    gather = k1_gather_timed(k1_lists(s, lv), s.layout.T)
    log(f"  K1 busiest level: wrapper {k1[0]:.3f} ms, its bf16 operand "
        f"gather alone {gather:.3f} ms ({gather / k1[0]:.1%}), kernel "
        f"{k1[0] - gather:.3f} ms")
    k1t = e2_timed("K1 main path tail pre-pass", LL.gemm_scatter_ll,
                   LL.gemm_scatter_ll_ref, tail, s.layout.T, k1_flops, upd)
    gather_t = k1_gather_timed(tail, s.layout.T)
    log(f"  K1 tail pre-pass: wrapper {k1t[0]:.3f} ms, gather alone "
        f"{gather_t:.3f} ms ({gather_t / k1t[0]:.1%}), kernel "
        f"{k1t[0] - gather_t:.3f} ms")
    k2 = k2_timed(s)
    k2_chain_timed(s.device)
    return launches, num, k1, k2


def lu_path(nx, dev, errs):
    """Phase 7: the LU path, then K1 cross-pool, K2's LU sweeps and K4 LU
    against their twins and timed at its busiest level."""
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import convection_diffusion_3d
    from pastix_tpu_torch.numeric import leftlook as LL

    s, launches, num = drive(
        f"LU path convection_diffusion_3d({nx})", convection_diffusion_3d(nx),
        kind_cfg(Factorization.LU), dev, ("K1", "K2", "K4"))
    lv, upd = busiest_level(s._fact_fn), upd_of(s)
    check_lists(check_k1, k1_lists(s, lv), "LU path busiest level", errs,
                "K1x", upd)
    errs["K2lu"] = max(errs["K2lu"], check_k2(s, 1, seed=0))
    k1x = e2_timed("K1 src_pool LU path busiest level", LL.gemm_scatter_ll,
                   LL.gemm_scatter_ll_ref, k1_lists(s, lv), s.layout.T,
                   k1_flops, upd)
    k2lu = k2_timed(s)
    factor_kernels(s, num, launches)
    k4lu = k4_timed(s, lu=True)
    errs["K4lu"] = max(errs["K4lu"], k4lu[4])
    num["tri_inv_ms"] = k4lu[5]
    return launches, num, k1x, k2lu, k4lu


def ldlt_path(nx, dev, errs):
    """Phase 8: the LDLᵗ path (fp32 updates), the inertia, K1 scaled and
    K4 LDLᵗ against their twins and timed at its shapes and dtype; then
    what bf16 updates leave on this matrix (printed, not checked)."""
    from pastix_tpu_torch import Pastix
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.numeric import leftlook as LL

    LDLT = Factorization.LDLT
    A, sigma = shift_invert(nx)
    b = A.to_scipy() @ np.ones(A.n)
    log(f"LDLT matrix: poisson_3d({nx}) - {sigma:.6g} I")
    s, launches, num = drive(
        f"LDLT path poisson_3d({nx}) - sigma I fp32 updates", A,
        kind_cfg(LDLT, None), dev, ("K1", "K2", "K4"))
    nneg = int((s.factors.d < 0).sum())
    log(f"  negative pivots {nneg}, clamped {s.report.static_pivots}")
    if s.report.static_pivots == 0 and nneg != 1:
        raise AssertionError(f"{nneg} negative pivots; the matrix has one "
                             "negative eigenvalue")
    lv, upd = busiest_level(s._fact_fn), upd_of(s)
    check_lists(check_k1, k1_lists(s, lv), "LDLT path busiest level", errs,
                "K1d", upd)
    errs["K2"] = max(errs["K2"], check_k2(s, 1, seed=8))
    k1d = e2_timed("K1 d LDLT path busiest level", LL.gemm_scatter_ll,
                   LL.gemm_scatter_ll_ref, k1_lists(s, lv), s.layout.T,
                   k1_flops, upd)
    factor_kernels(s, num, launches)
    k4ldlt = k4_timed(s, lu=False)
    errs["K4ldlt"] = max(errs["K4ldlt"], k4ldlt[4])
    num["tri_inv_ms"] = k4ldlt[5]
    x0 = s.solve(b, refine=False)
    del s, lv
    # not a check: bf16 trailing updates on this nearly singular matrix
    # leave an error the Richardson refinement does not contract
    p = Pastix(A, kind_cfg(LDLT), device=dev)
    x1 = p.solve(b, refine=False)
    p.solve(b)
    log(f"  bf16 updates instead (informational): unrefined max|x-1| "
        f"{np.abs(x1 - 1).max():.3e} (fp32 updates {np.abs(x0 - 1).max():.3e}"
        f"), refined residual {p.report.residual:.3e} after "
        f"{p.report.refine_iters} iterations")
    return launches, num, k1d, k4ldlt


def schur_path(kind, A, nx, upd, key, dev, errs):
    """Phases 6, 9 and 10: a Schur path (the plane z = nx-1) under
    ``kind``, then K3 (its variant for LU and LDLᵗ) against its twin and
    timed at its busiest residue level, at the path's update dtype."""
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.numeric import pipelined as PL

    LLT, LU, LDLT = Factorization.LLT, Factorization.LU, Factorization.LDLT
    need = ("K1", "K2", "K3") + (() if kind == Factorization.LLT
                                 else ("K4",))
    s, launches, num = drive(f"{kind.name} Schur path (nx={nx})", A,
                             kind_cfg(kind, upd), dev, need,
                             schur=last_plane(nx))
    check_lists(check_k1, k1_lists(s, busiest_level(s._fact_fn)),
                f"{kind.name} Schur path busiest level", errs,
                {LLT: "K1", LU: "K1x", LDLT: "K1d"}[kind], upd_of(s))
    k2key = "K2lu" if kind == Factorization.LU else "K2"
    errs[k2key] = max(errs[k2key], check_k2(s, 1, seed=6))
    lv = max(s._fact_fn.levels,
             key=lambda lv: sum(c.n_pairs for c in lv.schur))
    check_lists(check_k3, k3_lists(s, lv),
                f"{kind.name} Schur path busiest level", errs, key, upd_of(s))
    timed = e2_timed(f"K3 {kind.name} busiest residue level",
                     PL.gemm_scatter_pipelined, PL.gemm_scatter_pipelined_ref,
                     k3_lists(s, lv), s.layout.T, k3_flops, upd_of(s))
    return launches, num, timed


def check_variants(dev, errs, sch24):
    """Phase 3 for slice 2: K1 scaled and cross-pool (with a forced
    "full" plan), K2's LU sweeps, K4 on a level's diagonal tiles of A
    and on planted zero pivots, K3 scaled and cross-pool on the Schur
    layouts (Schur = ``sch24``), and ``get_schur`` under LU against a
    sparse LU, all on size-24 layouts at T=128."""
    import scipy.sparse as sp
    import torch
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import convection_diffusion_3d
    from pastix_tpu_torch.numeric import leftlook as LL

    bf16, fp32 = torch.bfloat16, torch.float32
    LU, LDLT = Factorization.LU, Factorization.LDLT
    A24s, _ = shift_invert(24)
    A24c = convection_diffusion_3d(24)
    for kind, A24, key in ((LDLT, A24s, "K1d"), (LU, A24c, "K1x")):
        ks, _ = analyzed(A24, kind_cfg(kind), dev)
        ks.factorize()
        lv = busiest_level(ks._fact_fn)
        for chunks, kw, pool, side in k1_lists(ks, lv):
            for upd, name in ((bf16, "bf16"), (fp32, "fp32")):
                errs[key] = max(errs[key], check_k1(
                    pool, chunks, upd,
                    f"{kind.name} {side} busiest level {name} "
                    f"modes={sorted({c.mode for c in chunks})}", **kw))
        if kind == LU:
            # a forced "full" plan: a from the destination pool, never
            # from the cache filled from src_pool
            lay = ks.layout
            _, incoming, _ = LL.regroup_left(lay.levels, lay.blk_col, None)
            li = int(np.argmax([i[0].size for i in incoming]))
            ga, gb, gd = incoming[li][:3]
            full = LL.ll_plan(LL.build_ll_schedule(
                ga, gb, gd, group=4, cap=1024, mode="full",
                rb=(lay.row_lo, lay.row_hi), T=lay.T), dev)
            for upd, name in ((bf16, "bf16"), (fp32, "fp32")):
                errs[key] = max(errs[key], check_k1(
                    ks.factors.pool, full, upd, f"LU pool forced full {name}",
                    src_pool=ks.factors.pool_u))
            for R in (1, 3):
                errs["K2lu"] = max(errs["K2lu"], check_k2(ks, R, seed=R))
        # K4 on the busiest level's diagonal tiles of A and planted pivots
        vals = torch.as_tensor(
            sp.coo_matrix(ks._A_perm).data.astype(np.float32), device=dev)
        pools = ks._coef_fn(vals)
        pool = pools[0] if kind == LU else pools
        lvd = max(ks._fact_fn.levels, key=lambda lv: lv.diag.numel())
        eps = 1e-14 * float(abs(ks._A_perm).max())
        k4 = "K4lu" if kind == LU else "K4ldlt"
        errs[k4] = max(errs[k4], check_k4(pool[lvd.diag], eps, kind == LU,
                                          "busiest level of A"))
        for T in (32, 64, 128):
            tiles, clamps = planted_tiles(T, kind == LU)
            errs[k4] = max(errs[k4], check_k4(
                tiles, 1e-6, kind == LU, f"planted zero pivots T={T}",
                clamps))
        del ks, pools, pool
    # K3 variants on the Schur layouts (plane z = 23), fp32 for get_schur
    for kind, A24, key in ((LDLT, A24s, "K3d"), (LU, A24c, "K3x")):
        ss, _ = analyzed(A24, kind_cfg(kind, None), dev, schur=sch24)
        ss.factorize()
        lv = max(ss._fact_fn.levels,
                 key=lambda lv: sum(c.n_pairs for c in lv.schur))
        for chunks, kw, pool, side in k3_lists(ss, lv):
            for upd, name in ((bf16, "bf16"), (fp32, "fp32")):
                errs[key] = max(errs[key], check_k3(
                    pool, chunks, upd,
                    f"{kind.name} Schur {side} busiest level {name}", **kw))
        if kind == LU:
            S = ss.get_schur()
            S_ref = schur_reference(A24, sch24)
            s_err = float(np.abs(S - S_ref).max() / np.abs(S_ref).max())
            log(f"get_schur LU convection_diffusion_3d(24) {S.shape} fp32 "
                f"updates: max|S - S_ref|/max|S_ref| = {s_err:.3e}")
            if not s_err <= TOL_S:
                raise AssertionError(f"LU get_schur off by {s_err:.3e}")
        del ss


def pair_arrays(c, T):
    """(a, b, dst, k, lo, hi) of every pair of one K3, K5, K6 or K9
    chunk as numpy arrays: a's tile (K3: its position in the chunk's
    operand form, see :func:`e2_work`), b's, the dst tile, the source
    column (or None) and the rows [lo, hi) of a the pair reads (K6: its
    window, the last two of its six ``pairs()``).  K5 and K9 chunks are
    K3's."""
    p = [None if x is None else x.cpu().numpy().astype(np.int64)
         for x in c.pairs()]
    if len(p) == 6:  # K6
        a, b, dst, k, rl, h = p
        return a, b, dst, k, rl, rl + h
    a, b, dst, k = p
    return a, b, dst, k, np.zeros(a.size, np.int64), np.full(a.size, T)


def e2_work(steps, T):
    """(flops, bytes) of right-looking E2 steps ``(dst, a_src, b_src,
    chunks, scaled)``, run as one: 2 (hi - lo) T^2 flops a pair; each
    distinct tile of each source read once over the rows its pairs read
    (``a_src``/``b_src`` name a pool, fp32, or ``("stream", side)``, the
    level's bf16 panel stream, where a K3 chunk's ``ext_a``/``ext_b``
    positions index it), each dst tile read and written once over the
    rows its pairs change, and the pivot rows of d once."""
    flops, rows, krows = 0.0, {}, set()

    def add(key, idx, lo, hi):
        rows.setdefault(key, []).append((idx, lo, hi))

    for dst, a_src, b_src, chunks, scaled in steps:
        for c in chunks:
            a, b, d, k, lo, hi = pair_arrays(c, T)
            if isinstance(a_src, tuple):
                a, b = c.ext_a.cpu().numpy(), c.ext_b.cpu().numpy()
            flops += float((2.0 * (hi - lo) * T ** 2).sum())
            add(a_src, a, lo, hi)
            add(b_src, b, np.zeros_like(lo), np.full_like(hi, T))
            add(("dst", dst), d, lo, hi)
            if scaled and k is not None:
                krows.update(k.tolist())
    nbytes = 0.0
    for key, parts in rows.items():
        idx = np.concatenate([p[0] for p in parts]).astype(np.int64)
        lo = np.concatenate([p[1] for p in parts])
        hi = np.concatenate([p[2] for p in parts])
        u, inv = np.unique(idx, return_inverse=True)
        tlo = np.full(u.size, T)
        thi = np.zeros(u.size, np.int64)
        np.minimum.at(tlo, inv, lo)
        np.maximum.at(thi, inv, hi)
        per_row = T * (2 if isinstance(key, tuple) and key[0] == "stream"
                       else 4)
        nbytes += (2 if key[0] == "dst" else 1) * float(
            ((thi - tlo) * per_row).sum())
    return flops, nbytes + len(krows) * T * 4


def rl_checked(name, run, run_ref, steps, pools, upd, T, errs, key,
               repeat=False):
    """Right-looking E2 steps ``(dst, a_src, b_src, chunks, kw)`` with
    ``pools`` naming their tensors: each step against its twin on copies
    of its pool (max|d| to ``errs[key]``; ``repeat``: and a second run
    bit-identical to the first), then all steps as one, kernel
    and twin timed, and bound by :func:`e2_work` at the bf16 peak
    (``upd`` bf16) or the fp32 one.  Returns (kernel ms, twin ms, bound,
    the kernel's launches in its timed runs, counted from 0)."""
    import torch

    for dst, _, _, chunks, kw in steps:
        errs[key] = max(errs[key], check_e2(
            name, run, run_ref, pools[dst], chunks, upd,
            f"{key} {dst} {str(upd)[6:]}", repeat=repeat, **kw))
    work = {k: pools[k].clone() for k in {st[0] for st in steps}}

    def step(fn):
        for dst, _, _, chunks, kw in steps:
            fn(work[dst], chunks, upd, **kw)

    reset_counts()
    ms = cuda_ms(lambda: step(run))
    launched = run.launches
    plain = cuda_ms(lambda: step(run_ref))
    flops, nbytes = e2_work(
        [(d, a, b, c, "d" in kw) for d, a, b, c, kw in steps], T)
    bd = bound(flops, PEAK_BF16 if upd == torch.bfloat16 else PEAK_FP32,
               nbytes)
    pairs = sum(c.n_pairs for st in steps for c in st[3])
    log(f"timing {name} {key} ({sum(len(st[3]) for st in steps)} chunks, "
        f"{pairs} pairs, {str(upd)[6:]}): kernel {ms:.3f} ms, twin "
        f"{plain:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]})")
    del work
    return ms, plain, bd, launched


def rl_steps(f, lv, mode, form=None):
    """The E2 steps of one right-looking level as :func:`rl_checked` takes
    them, with the pools and streams they read: ``mode`` stream, block,
    slab or pair (``form``: K3's ``compact`` or ``ab_pack``).  Returns
    (steps, pools, run, run_ref)."""
    import torch
    from pastix_tpu_torch.numeric import block as BK
    from pastix_tpu_torch.numeric import pipelined as PL
    from pastix_tpu_torch.numeric import slab as SB

    lu = f.pool_u is not None
    pools = {"pool": f.pool}
    kw = {} if f.d is None else {"d": f.d}
    if mode == "block":
        return ([("pool", "pool", "pool", lv.blk, kw)], pools,
                BK.gemm_scatter_block, BK.gemm_scatter_block_ref)
    if mode == "slab":
        return ([("pool", "pool", "pool", lv.slab, kw)], pools,
                SB.gemm_scatter_slab, SB.gemm_scatter_slab_ref)
    run = (PL.gemm_scatter_pipelined, PL.gemm_scatter_pipelined_ref)
    if lu:
        pools["pool_u"] = f.pool_u
    if mode == "stream":
        xl = f.pool[lv.tp].to(torch.bfloat16)
        if not lu:
            return ([("pool", ("stream", "l"), ("stream", "l"), lv.full,
                      dict(kw, xab=xl))], pools) + run
        xu = f.pool_u[lv.tp].to(torch.bfloat16)
        steps = [("pool", ("stream", "l"), ("stream", "u"), lv.full,
                  {"xab": (xl, xu)})]
        if lv.nd:
            steps.append(("pool_u", ("stream", "u"), ("stream", "l"),
                          lv.nd, {"xab": (xu, xl)}))
        return (steps, pools) + run
    if form is not None:
        kw = dict(kw, **{form: True})
    if not lu:
        return ([("pool", "pool", "pool", lv.full, kw)], pools) + run
    steps = [("pool", "pool", "pool_u", lv.full, dict(kw, src_pool=f.pool_u))]
    if lv.nd:
        steps.append(("pool_u", "pool_u", "pool", lv.nd,
                      dict(kw, src_pool=f.pool)))
    return (steps, pools) + run


# the cost gate settings that keep every pair of a block or slab plan,
# for a matrix whose levels the reference's defaults (1.8 tiles a pair;
# the slab cost model) leave wholly to the pair kernel
RL_GATE_OPEN = {"block": ("PASTIX_BLOCK_GATE", "100"),
                "slab": ("PASTIX_SLAB_GATE", "0")}
# the kernel each right-looking schedule must launch
RL_KERNEL = {"stream": "K3", "pair": "K3", "pair+compact": "K3",
             "block": "K5", "slab": "K6"}
# K6's kernels in a profile: K1's windowed tensor-core body with fp32 a
# and b (``seg_mma_kernel<T, BN, true, true, SCALED, true>``)
K6_NAMES = r"seg_mma_kernel<\d+, \d+, true, true, (true|false), true>"


def rl_busiest(fact_fn, mode):
    """The level with the most pairs of ``mode``'s kernel."""
    attr = {"block": ("blk",), "slab": ("slab",)}.get(mode, ("full", "nd"))
    return max(fact_fn.levels, key=lambda lv: sum(
        c.n_pairs for a in attr for c in getattr(lv, a)))


def e2_variants(f, ga, gb, gd, gk, nd, dev):
    """The variants of the E2 A/B harness (the reference's ``exp_pipe.py``)
    on one pair list: K3 on the pools at G=1 and G=2, K3 ``ab_pack`` at
    G=1, 2 and 4 (the schedule's group; the port drops its pad pairs), K9
    (``gemm_scatter_fused`` over ``sort_triples``) and K10
    (``gemm_scatter_blockspec`` over a group-1 schedule).  ``f`` holds the
    pools (``pool``, ``pool_u`` for LU) and ``d`` (LDLᵗ, scaled by ``gk``);
    LU takes b from the other pool and adds the pool_u mirror of the pairs
    ``nd``.  Yields (label, errs key, run, run_ref, steps), the steps as
    :func:`rl_checked` takes them."""
    from pastix_tpu_torch.numeric import fused as FU
    from pastix_tpu_torch.numeric import pipelined as PL

    kw = {} if f.d is None else {"d": f.d}
    gk = gk if f.d is not None else None

    def sides(build, extra=None):
        extra = extra or {}
        if f.pool_u is None:
            return [("pool", "pool", "pool", build(ga, gb, gd, gk),
                     dict(kw, **extra))]
        out = [("pool", "pool", "pool_u", build(ga, gb, gd, None),
                dict(extra, src_pool=f.pool_u))]
        if nd.any():
            out.append(("pool_u", "pool_u", "pool",
                        build(ga[nd], gb[nd], gd[nd], None),
                        dict(extra, src_pool=f.pool)))
        return out

    def pipe(G):
        return lambda a, b, d, k: PL.pipeline_plan(
            PL.build_pipeline_schedule(a, b, d, gk=k, group=G), dev)

    k3 = (PL.gemm_scatter_pipelined, PL.gemm_scatter_pipelined_ref)
    for G in (1, 2):
        yield (f"K3 G={G}", "K3", *k3, sides(pipe(G)))
    for G in (1, 2, 4):
        yield (f"K3 ab_pack G={G}", "K3pack", *k3,
               sides(pipe(G), {"ab_pack": True}))
    yield ("K9", "K9", FU.gemm_scatter_fused, FU.gemm_scatter_fused_ref,
           sides(lambda a, b, d, k: FU.fused_plan(
               *FU.sort_triples(a, b, d, k), device=dev)))
    yield ("K10", "K10", FU.gemm_scatter_blockspec,
           FU.gemm_scatter_blockspec_ref,
           sides(lambda a, b, d, k: FU.blockspec_plan(
               PL.build_pipeline_schedule(a, b, d, gk=k), dev)))


def check_chol_inv_kernels(dev, errs):
    """Phase 3 for slice 4: K7 in place on the poisson_3d(24) T=128
    coefinit pool at the level with the most diagonal tiles and panels,
    garbage planted above their diagonals and a pad sentinel in the index
    (L and L⁻¹ against the twin, every other tile bit-identical); K8 on
    the same tiles symmetrized from their lower triangles."""
    import scipy.sparse as sp
    import torch
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.numeric import chol_inv as CI

    s, _ = analyzed(poisson_3d(24), kind_cfg(Factorization.LLT), dev)
    lv = max((lv for lv in s._fact_fn.levels if lv.tp.numel()),
             key=lambda lv: lv.diag.numel())
    vals = torch.as_tensor(sp.coo_matrix(s._A_perm).data.astype(np.float32),
                           device=dev)
    pool = s._coef_fn(vals)
    B, T, npool = lv.diag.numel(), pool.shape[1], pool.shape[0]
    g = torch.Generator(device=dev).manual_seed(3)
    pool[lv.diag] += torch.triu(torch.randn(B, T, T, generator=g,
                                            device=dev), 1)
    idx = torch.cat([lv.diag, torch.tensor([npool + 3], device=dev)])
    got, ref = pool.clone(), pool.clone()
    dinv = CI.chol_inv_pool(got, idx)
    dref = CI.chol_inv_pool_ref(ref, idx)
    torch.cuda.synchronize()
    rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
    err = max(rel(got[lv.diag], ref[lv.diag]), rel(dinv, dref))
    rest = torch.ones(npool, dtype=torch.bool, device=dev)
    rest[lv.diag] = False
    same = bool(torch.equal(got[rest], pool[rest])) and not dinv[-1].any()
    ok = err <= TOL_K7 and same
    log(f"K7 busiest fused level ({B} tiles + 1 sentinel, upper garbage): "
        f"max|d|/max|ref| {err:.3e}, other tiles untouched {same} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("K7 disagrees with its twin")
    errs["K7"] = max(errs["K7"], err)
    tiles = torch.tril(pool[lv.diag])
    sym = (tiles + torch.tril(tiles, -1).transpose(1, 2)).contiguous()
    L, X = CI.chol_inv(sym)
    Lr, Xr = CI.chol_inv_ref(sym)
    torch.cuda.synchronize()
    err = max(rel(L, Lr), rel(X, Xr))
    log(f"K8 the same tiles symmetrized ({B}): max|d|/max|ref| {err:.3e} "
        f"-> {'ok' if err <= TOL_K7 else 'FAIL'}")
    if not err <= TOL_K7:
        raise AssertionError("K8 disagrees with its twin")
    errs["K8"] = max(errs["K8"], err)
    del s, pool, got, ref


def check_rightlook_kernels(dev, errs):
    """Phase 3 for slices 3 and 4: K3's operand arrays (the panel stream
    ``xab`` plain, ``d`` and LU's (L, Uᵗ) with its mirror; ``compact``
    plain, ``d`` and ``src_pool``), the E2 harness's variants
    (:func:`e2_variants`: K3 on the pools at G=1 and 2, ``ab_pack`` at
    G=1, 2 and 4, K9 and K10, plain, ``d`` and ``src_pool``), K5 and K6
    plain and ``d``, each against its twin in bf16 and fp32, on the
    busiest level's pairs of the poisson_3d(24) (LLᵗ and LDLᵗ) and
    convection_diffusion_3d(24) (LU) T=128 layouts.  K5 keeps every entry
    of the level (gate 100); K6 runs the default slab sizes, its cost gate
    off."""
    import torch
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
    from pastix_tpu_torch.numeric import block as BK
    from pastix_tpu_torch.numeric import slab as SB
    from pastix_tpu_torch.numeric.factorize import _Level
    from pastix_tpu_torch.numeric.pipelined import (
        build_pipeline_schedule, pipeline_plan,
    )

    LLT, LDLT, LU = Factorization.LLT, Factorization.LDLT, Factorization.LU
    for kind, A in ((LLT, poisson_3d(24)), (LDLT, poisson_3d(24)),
                    (LU, convection_diffusion_3d(24))):
        s, _ = analyzed(A, kind_cfg(kind), dev)
        s.factorize()
        f, lay, T = s.factors, s.layout, s.layout.T
        src = max(lay.levels, key=lambda lv: lv.gemm_a.size)
        ga, gb, gd, gk = src.gemm_a, src.gemm_b, src.gemm_d, src.gemm_k
        nd = np.asarray(src.gemm_nondiag, bool)
        tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        pipe = lambda a, b, d, k=None, ext=None: pipeline_plan(
            build_pipeline_schedule(a, b, d, gk=k, group=2, ext_tiles=ext),
            dev)
        lv = _Level(cols=None, diag=None, tp=tens(src.trsm_panel), tc=None,
                    tcpos=None)
        for upd in (torch.bfloat16, torch.float32):
            lv.full = pipe(ga, gb, gd, gk, ext=src.trsm_panel)
            lv.nd = pipe(ga[nd], gb[nd], gd[nd], ext=src.trsm_panel) if (
                kind == LU and nd.any()) else []
            steps, pools, run, ref = rl_steps(f, lv, "stream")
            for dst, _, _, chunks, kw in steps:
                errs["K3xab"] = max(errs["K3xab"], check_e2(
                    "K3", run, ref, pools[dst], chunks, upd,
                    f"xab {kind.name} {dst} {str(upd)[6:]}", **kw))
            steps, pools, run, ref = rl_steps(f, lv, "pair", "compact")
            for dst, _, _, chunks, kw in steps:
                errs["K3compact"] = max(errs["K3compact"], check_e2(
                    "K3", run, ref, pools[dst], chunks, upd,
                    f"compact {kind.name} {dst} {str(upd)[6:]}", **kw))
            pools = {"pool": f.pool, "pool_u": f.pool_u}
            for label, key, run, ref, steps in e2_variants(
                    f, ga, gb, gd, gk, nd, dev):
                for dst, _, _, chunks, kw in steps:
                    errs[key] = max(errs[key], check_e2(
                        label, run, ref, pools[dst], chunks, upd,
                        f"{kind.name} {dst} {str(upd)[6:]}",
                        repeat=key in ("K9", "K10"), **kw))
            if kind == LU:
                continue
            bp = BK.build_block_plan(ga, gb, gd, gk, lay.blk_row,
                                     lay.blk_col, lay.keys, lay.nbc,
                                     lay.npool, gate=100.0)
            lv.blk = BK.block_plan(bp, lay.blk_row, dev)
            old = os.environ.get("PASTIX_SLAB_GATE")
            os.environ["PASTIX_SLAB_GATE"] = "0"
            try:
                doc = lay.lookup(np.arange(lay.nbc), np.arange(lay.nbc))
                sp_ = SB.build_slab_plan(
                    ga, gb, gd, gk, doc, lay.npool, C=0, H=0,
                    rbounds=(lay.row_lo, lay.row_hi), T=T)
            finally:
                if old is None:
                    del os.environ["PASTIX_SLAB_GATE"]
                else:
                    os.environ["PASTIX_SLAB_GATE"] = old
            lv.slab = SB.slab_plan(sp_, T, dev)
            for mode, key in (("block", "K5"), ("slab", "K6")):
                if not getattr(lv, "blk" if mode == "block" else "slab"):
                    raise AssertionError(f"{key}: no {mode} pairs at nx=24")
                steps, pools, run, ref = rl_steps(f, lv, mode)
                for dst, _, _, chunks, kw in steps:
                    errs[key] = max(errs[key], check_e2(
                        key, run, ref, pools[dst], chunks, upd,
                        f"{kind.name} {str(upd)[6:]}", repeat=True, **kw))
        del s, f, lv


def rightlook_path(label, A, kind, modes, dev, errs):
    """Phase 11, one matrix and kind: the host analysis once, the
    left-looking ``fact_ms`` (second call) for reference, then per
    right-looking schedule of ``modes`` its own factorize program
    (``build_factorize_fn(e2=mode)``) in the solver, the counts set to 0
    just before and read just after: factorize twice (the second timed)
    and a refined solve of b = A.1 to a fp64 residual <= 1e-10 (with the
    peak device memory of both, the panel stream included); the
    schedule's kernel (K3, K5 or K6) must launch, K1 not, and no twin
    may run.  Then the schedule's kernel against its twin at the path's
    busiest level, timed and bound.  Returns {mode: (launches, numbers,
    timed)}."""
    import torch
    from pastix_tpu_torch.numeric.factorize import build_factorize_fn

    s, t = analyzed(A, kind_cfg(kind), dev)
    lay = s.layout
    log(f"{label}: n={A.n} T={lay.T} npool={lay.npool} levels="
        f"{len(lay.levels)} dense_tail_m={s.report.dense_tail_m}; order "
        f"{t['order']:.3f} s symbfact {t['symbfact']:.3f} s analyze "
        f"{t['analyze']:.3f} s")
    for _ in range(2):
        s.factorize()
    left_ms = s.report.fact_time * 1e3
    log(f"  left-looking factorize {left_ms:.1f} ms (second call)")
    M = A.to_scipy()
    b = M @ np.ones(A.n)
    need = ("K2",) + (() if kind.name == "LLT" else ("K4",))
    out = {}
    for mode in modes:
        s._fact_fn = s.factors = None
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        fn = build_factorize_fn(lay, s.device, kind,
                                update_dtype=torch.bfloat16,
                                dense_tail=s._dense_tail, e2=mode)
        plan_s = time.perf_counter() - t0
        kept = {"block": "n_block_pairs", "slab": "n_slab_pairs"}.get(mode)
        if kept and not getattr(fn, kept):
            # the reference's cost gate keeps no pair of this matrix: the
            # schedule runs with the gate opened, and says so
            var, val = RL_GATE_OPEN[mode]
            log(f"  {mode}: the default {var} keeps no pair; {var}={val}")
            os.environ[var] = val
            try:
                fn = build_factorize_fn(lay, s.device, kind,
                                        update_dtype=torch.bfloat16,
                                        dense_tail=s._dense_tail, e2=mode)
            finally:
                del os.environ[var]
            plan_s = time.perf_counter() - t0
        s._fact_fn = fn
        reset_counts()
        torch.cuda.reset_peak_memory_stats(s.device)
        fact = []
        for _ in range(2):
            s.factorize()
            fact.append(s.report.fact_time * 1e3)
        x = s.solve(b)
        peak = torch.cuda.max_memory_allocated(s.device) / 2 ** 30
        res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
        log(f"  {mode}: plans {plan_s:.2f} s (block pairs "
            f"{getattr(fn, 'n_block_pairs', 0)}, slab pairs "
            f"{getattr(fn, 'n_slab_pairs', 0)}); factorize {fact[0]:.1f} "
            f"ms (first), {fact[1]:.1f} ms (second; left-looking "
            f"{left_ms:.1f}); solve {s.report.solve_time * 1e3:.1f} ms, "
            f"refine_iters {s.report.refine_iters}, residual "
            f"{s.report.residual:.3e} (original order {res:.3e}); peak "
            f"device memory {peak:.3f} GiB")
        if not np.isfinite(x).all() or not max(res, s.report.residual) <= (
                TOL_RES):
            raise AssertionError(f"{label} {mode}: residual {res:.3e}")
        launches = read_counts(f"{label} {mode}", need + (RL_KERNEL[mode],),
                               forbid=("K1",))
        num = {"fact_ms": fact[1], "left_fact_ms": left_ms,
               "solve_ms": s.report.solve_time * 1e3,
               "iters": s.report.refine_iters,
               "residual": s.report.residual, "plan_s": plan_s,
               "tiles": lay.npool, "peak_gib": peak}
        if kind.name == "LDLT" and mode == "slab":
            factor_kernels(s, num, launches)
        lv = rl_busiest(fn, mode)
        kern = RL_KERNEL[mode]
        steps, pools, run, ref = rl_steps(
            s.factors, lv, "pair" if mode == "pair+compact" else mode,
            "compact" if mode == "pair+compact" else None)
        key = f"{kind.name} {mode}"
        errs.setdefault(key, 0.0)
        timed = rl_checked(kern, run, ref, steps, pools, torch.bfloat16,
                           lay.T, errs, key, repeat=True)
        out[mode] = (launches, num, timed)
        del steps, pools
    k2key = "K2lu" if kind.name == "LU" else "K2"
    errs[k2key] = max(errs[k2key], check_k2(s, 1, seed=11))
    del s
    return out


def chol_two_calls(t):
    """L⁻¹ of symmetric tiles by two library calls: ``cholesky_ex`` and
    ``solve_triangular`` (the yardstick of K7 and K8, used nowhere in
    the port)."""
    import torch

    eye = torch.eye(t.shape[1], device=t.device).expand_as(t)
    L, _ = torch.linalg.cholesky_ex(t)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def k8_tiles(dev, errs):
    """Phase 12: K8 on one tile at T = 32, 64 and 128 (symmetric positive
    definite, numpy seed T) against its twin (1e-5 max|ref|), then
    kernel, twin and :func:`chol_two_calls` timed; one tile of condition
    1e4 at each T (eigenvalues 1 down to 1e-4, evenly in log): L against
    the twin at 1e-5, and X against the fp64 inverse of the same fp32
    tile within the textbook bound T u cond(L) for triangular inversion
    (u = 2^-24; the twin's own X is off by 1.4e-5 to 4.9e-5 there, so
    two summation orders differ by more than 1e-5); and one tile with a
    negative pivot at row 70 % T: NaN exactly where the twin has it
    (lower triangles), the rest within 1e-5.  Kernel and library calls
    are also timed on the card alone (:func:`device_ms`): at small T the
    host's launch overhead outlasts them.  Returns {T: (ms, twin ms,
    bound, two-call ms, device ms, two-call device ms)}."""
    import torch
    from pastix_tpu_torch.numeric import chol_inv as CI

    out = {}
    for T in (32, 64, 128):
        rng = np.random.default_rng(T)
        R = rng.standard_normal((T, T))
        one = torch.tensor((R @ R.T / T + 3 * np.eye(T))[None],
                           dtype=torch.float32, device=dev)
        Q, _ = np.linalg.qr(rng.standard_normal((T, T)))
        M = (Q * np.logspace(0, -4, T)) @ Q.T
        ill = torch.tensor((M + M.T)[None] / 2, dtype=torch.float32,
                           device=dev)
        bad = one.clone()
        bad[0, 70 % T, 70 % T] = -5.0
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())
        (L, X), (Lr, Xr) = CI.chol_inv(one), CI.chol_inv_ref(one)
        err = max(rel(L, Lr), rel(X, Xr))
        (L, X), (Lr, Xr) = CI.chol_inv(ill), CI.chol_inv_ref(ill)
        L64 = torch.linalg.cholesky(ill.double())
        X64 = torch.linalg.inv(L64)
        ill_l, ill_x, twin_x = rel(L, Lr), rel(X.double(), X64), rel(
            Xr.double(), X64)
        x_bound = T * 2.0 ** -24 * float(torch.linalg.cond(L64[0]))
        (L, X), (Lr, Xr) = CI.chol_inv(bad), CI.chol_inv_ref(bad)
        nan_ok, bad_err = True, 0.0
        for got, ref in ((L, Lr), (torch.tril(X), torch.tril(Xr))):
            nan = torch.isnan(ref)
            nan_ok &= bool(nan.any()) and torch.equal(torch.isnan(got), nan)
            bad_err = max(bad_err, rel(got[~nan], ref[~nan]))
        ms = cuda_ms(lambda: CI.chol_inv(one), reps=20)
        plain = cuda_ms(lambda: CI.chol_inv_ref(one), reps=2)
        lib = cuda_ms(lambda: chol_two_calls(one), reps=20)
        dev_ms = device_ms(lambda: CI.chol_inv(one))
        dev_lib = device_ms(lambda: chol_two_calls(one))
        bd = bound(2.0 / 3.0 * T ** 3, PEAK_FP32,
                   (T * (T + 1) // 2 + 2 * T * T) * 4)
        ok = (err <= TOL_K7 and ill_l <= TOL_K7
              and ill_x <= x_bound and nan_ok and bad_err <= TOL_K7)
        log(f"K8 one tile T={T}: max|d|/max|ref| {err:.3e}; condition 1e4: "
            f"L {ill_l:.3e} from the twin, X {ill_x:.3e} from fp64 (twin "
            f"{twin_x:.3e}, bound {x_bound:.3e}); negative pivot: NaN where "
            f"the twin's {'yes' if nan_ok else 'NO'}, rest {bad_err:.3e}; "
            f"kernel {ms:.4f} ms (on the card alone {dev_ms} ms), twin "
            f"{plain:.3f} ms, bound {bd[0]:.5f} ms ({bd[1]}), cholesky_ex + "
            f"solve_triangular {lib:.4f} ms (on the card {dev_lib} ms) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K8 at T={T} disagrees with its twin")
        errs["K8"] = max(errs["K8"], err, ill_l, bad_err)
        out[T] = (ms, plain, bd, lib, dev_ms, dev_lib)
    return out


def chol_timed(solver, errs):
    """K7 on the level with the most diagonal tiles of the fused path (of
    A's coefinit, fresh copies each call, the copy timed alone and taken
    off), against its twin and against ``cholesky_ex`` +
    ``solve_triangular`` on the same tiles (two library calls, not one);
    K8 on one tile symmetrized (the dense tail's call shape), the same
    three ways.  Bound: 2/3 T^3 flop a tile at the fp32 peak, or the
    tile's bytes at the memory rate: the lower triangle of M read
    (T (T + 1) / 2 floats, all the kernel reads), L and X written.  Returns
    (K7 numbers, K8 numbers), each (ms, twin ms, bound, two-call ms)."""
    import scipy.sparse as sp
    import torch
    from pastix_tpu_torch.numeric import chol_inv as CI

    fn = solver._fact_fn
    lv = max((lv for lv in fn.levels if lv.tp.numel()),
             key=lambda lv: lv.diag.numel())
    dev = lv.diag.device
    vals = torch.as_tensor(sp.coo_matrix(solver._A_perm).data.astype(
        np.float32), device=dev)
    tiles = solver._coef_fn(vals)[lv.diag].clone()
    B, T = tiles.shape[0], tiles.shape[1]
    idx = torch.arange(B, device=dev)
    work = tiles.clone()

    two_calls = chol_two_calls
    copy_ms = cuda_ms(lambda: work.copy_(tiles))
    ms = cuda_ms(lambda: (work.copy_(tiles),
                          CI.chol_inv_pool(work, idx))) - copy_ms
    plain = cuda_ms(lambda: (work.copy_(tiles),
                             CI.chol_inv_pool_ref(work, idx)),
                    reps=2) - copy_ms
    lib = cuda_ms(lambda: two_calls(tiles))
    tile_bytes = (T * (T + 1) // 2 + 2 * T * T) * 4
    bd = bound(B * 2.0 / 3.0 * T ** 3, PEAK_FP32, B * tile_bytes)
    got, ref = tiles.clone(), tiles.clone()
    d1, d2 = CI.chol_inv_pool(got, idx), CI.chol_inv_pool_ref(ref, idx)
    err = max(float((got - ref).abs().max() / ref.abs().max()),
              float((d1 - d2).abs().max() / d2.abs().max()))
    log(f"timing K7 busiest fused level ({B} tiles): kernel {ms:.3f} ms, "
        f"twin {plain:.3f} ms, bound {bd[0]:.4f} ms ({bd[1]}), "
        f"cholesky_ex + solve_triangular (two library calls) {lib:.3f} ms; "
        f"max|d|/max|ref| {err:.3e}")
    if not err <= TOL_K7:
        raise AssertionError("K7 disagrees with its twin at the path level")
    errs["K7"] = max(errs["K7"], err)
    lo = torch.tril(tiles[:1])
    one = (lo + torch.tril(lo, -1).transpose(1, 2)).contiguous()
    ms8 = cuda_ms(lambda: CI.chol_inv(one))
    plain8 = cuda_ms(lambda: CI.chol_inv_ref(one), reps=2)
    lib8 = cuda_ms(lambda: two_calls(one))
    bd8 = bound(2.0 / 3.0 * T ** 3, PEAK_FP32, tile_bytes)
    log(f"timing K8 one tile (the dense tail's call, {solver._dense_tail.q} "
        f"a factorization): kernel {ms8:.3f} ms, twin {plain8:.3f} ms, "
        f"bound {bd8[0]:.5f} ms ({bd8[1]}), cholesky_ex + solve_triangular "
        f"(two library calls) {lib8:.3f} ms")
    return (ms, plain, bd, lib), (ms8, plain8, bd8, lib8)


def fused_path(nx, dev, errs, left_ms, stream_ms):
    """Phase 12: the fused-diagonal LLᵗ path (``PASTIX_FUSED_DIAG=1``) on
    ``poisson_3d(nx)`` with the dense tail, bf16 updates, left-looking and
    right-looking stream (``PASTIX_E2_LL=0``), each through ``drive``: K7
    and K8 must launch (K1, or K3 and not K1), no twin, and
    ``cholesky_ex`` only at the levels without panels (twice each, one
    per factorization).  ``fact_ms`` is set beside the unfused path's of
    phases 4 and 11 (``left_ms``, ``stream_ms``).  Then K7 and K8 timed
    (:func:`chol_timed`).  Returns ({e2: (launches, numbers)}, the stream
    solver, K7 numbers, K8 numbers)."""
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.numeric import factorize as F

    out, solver = {}, None
    for e2, base in (("left", left_ms), ("stream", stream_ms)):
        env = {"PASTIX_FUSED_DIAG": "1",
               "PASTIX_E2_LL": "0" if e2 == "stream" else "1"}
        old = {k: os.environ.get(k) for k in env}
        calls, potrf = [], F.potrf_batch
        F.potrf_batch = lambda t: calls.append(int(t.shape[0])) or potrf(t)
        os.environ.update(env)
        try:
            need = ("K2", "K7", "K8") + (("K1",) if e2 == "left" else ("K3",))
            s, launches, num = drive(
                f"fused-DIAG LLT {e2} poisson_3d({nx})", poisson_3d(nx),
                kind_cfg(Factorization.LLT), dev, need,
                forbid=() if e2 == "left" else ("K1",))
        finally:
            F.potrf_batch = potrf
            for k, v in old.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v
        fn = s._fact_fn
        bare = [lv for lv in fn.levels if not lv.tp.numel()]
        fused = len(fn.levels) - len(bare)
        log(f"  {e2}: {fused} fused levels, {len(bare)} without panels; "
            f"K7 {launches['K7']} K8 {launches['K8']} launches, cholesky_ex "
            f"{len(calls)} calls; fact_ms {num['fact_ms']:.1f} (unfused "
            f"{base:.1f}, {num['fact_ms'] / base - 1:+.1%})")
        if not (fn.fused_diag and fn.e2 == e2
                and launches["K7"] == 2 * fused
                and launches["K8"] == 2 * s._dense_tail.q
                and len(calls) == 2 * len(bare)):
            raise AssertionError(f"the fused {e2} path did not fuse every "
                                 "level with panels and the tail")
        num["unfused_fact_ms"] = base
        out[e2] = (launches, num)
        errs["K2"] = max(errs["K2"], check_k2(s, 1, seed=12))
        if e2 == "stream":
            solver = s
        else:
            check_lists(check_k1, k1_lists(s, busiest_level(fn)),
                        "fused-DIAG left busiest level", errs, "K1",
                        upd_of(s))
            k7, k8 = chol_timed(s, errs)
        del s
    return out, solver, k7, k8


def busiest_stream_level(solver):
    """The level with the most pairs of a right-looking solver (its dense
    tail's lower levels when it has one), as phases 13 and 14 take it."""
    levels = (solver._dense_tail.levels_lo if solver._dense_tail is not None
              else solver.layout.levels)
    return max(levels, key=lambda lv: lv.gemm_a.size)


def ab_harness(solver, dev, errs):
    """Phase 13: the reference's E2 A/B harness (``exp_pipe.py``) on two
    pair lists, bf16 and fp32 operands, every variant of
    :func:`e2_variants` against its twin, then kernel and twin timed (CUDA
    events, a warm-up, mean of 5) and bound (:func:`e2_work`): exp_pipe's
    default triples (ng=8192 on a pool of 12000 T=128 tiles, a and b from
    the first half, dst segments of about 3 pairs; numpy default_rng(0)
    drawn as there) and the busiest right-looking level of
    the phase-12 stream solver (``poisson_3d(--nx)`` LLᵗ, its factored
    pool).  The counts are each kernel's launches in its timed runs.
    Returns {(input, dtype, label): (ms, twin ms, bound, launches)}."""
    import types

    import torch

    ng, npool, T, seg = 8192, 12000, 128, 3
    rng = np.random.default_rng(0)
    nsrc = npool // 2
    ga = rng.integers(0, nsrc, ng).astype(np.int32)
    gb = rng.integers(0, nsrc, ng).astype(np.int32)
    ndst = max(1, ng // seg)
    gd = (nsrc + rng.integers(0, min(ndst, npool - nsrc), ng)).astype(
        np.int32)
    P = torch.from_numpy(rng.standard_normal((npool, T, T)).astype(
        np.float32)).to(dev)
    lv = busiest_stream_level(solver)
    inputs = (
        ("exp_pipe", types.SimpleNamespace(pool=P, pool_u=None, d=None),
         (ga, gb, gd)),
        ("poisson level", solver.factors,
         (lv.gemm_a, lv.gemm_b, lv.gemm_d)),
    )
    out = {}
    for name, f, (a, b, d) in inputs:
        log(f"E2 A/B harness, {name}: {a.size} pairs, "
            f"{np.unique(d).size} dst tiles")
        pools = {"pool": f.pool}
        for upd in (torch.bfloat16, torch.float32):
            for label, key, run, ref, steps in e2_variants(
                    f, a, b, d, None, None, dev):
                out[name, str(upd)[6:], label] = rl_checked(
                    f"{label} {name}", run, ref, steps, pools, upd, T, errs,
                    key, repeat=True)
    del P
    return out


def cache_harness(solver, dev, errs):
    """Phase 14: the reference's operand-cache harnesses (``exp_cache.py``,
    ``exp_mp.py``) on phase 13's poisson level, the busiest level of the
    phase-12 stream solver (its factored pool), with ``xab`` the level's
    panel tiles of the pool in bf16.  K11 on
    ``build_pipeline_schedule(chunk=1536, group=2, ext_tiles=panel)`` and
    K12 ``loop`` and ``dot2`` on ``build_mp_schedule(chunk=1536, G)`` at
    G = 4 and 8, each against its twin and against ``kernels.gemm_scatter``
    with bf16 operands (``TOL_E2`` of max|ref|), beside the reference's
    baselines: K3 on the pools at G=2 (exp_cache.py:232), K3 ``xab`` on
    the 1536-pair schedule (:235) and at chunk 6144 (exp_mp.py:329).
    K12 runs twice and must repeat bit for bit.  Every case's kernel and
    twin timed (CUDA events, a warm-up, mean of 5), the level's work
    bound by :func:`e2_work` (the cache counted as
    the bf16 stream, the pools as fp32); launches counted from 0 over the
    timed runs.  Returns {label: (ms, twin ms, bound, launches)}."""
    import torch
    from pastix_tpu_torch.numeric import cache as CA
    from pastix_tpu_torch.numeric import kernels as KN
    from pastix_tpu_torch.numeric import pipelined as PL

    f = solver.factors
    lv = busiest_stream_level(solver)
    ga, gb, gd = lv.gemm_a, lv.gemm_b, lv.gemm_d
    tp = np.asarray(lv.trsm_panel)
    T, ng = f.pool.shape[1], ga.size
    xab = f.pool[torch.as_tensor(tp, device=dev)].to(torch.bfloat16)
    bf16 = torch.bfloat16
    # what the reference checks against: its XLA gemm_scatter, bf16
    # operands (additive, so in batches of 4096 pairs)
    want = f.pool.clone()
    tens = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    for lo in range(0, ng, 4096):
        sl = slice(lo, lo + 4096)
        KN.gemm_scatter(want, tens(ga[sl]), tens(gb[sl]), tens(gd[sl]), bf16)
    touched = tens(np.unique(gd))
    scale = float(want[touched].abs().max())

    sched = PL.build_pipeline_schedule(ga, gb, gd, chunk=1536, group=2,
                                       ext_tiles=tp)
    vplan = CA.vcache_plan(sched, dev)
    x1536 = PL.pipeline_plan(sched, dev)
    log(f"cache harness, poisson level: {ng} pairs, {np.unique(gd).size} "
        f"dst tiles, {tp.size} panel tiles; vcache: {len(vplan.chunks)} "
        f"chunks, CT {vplan.ct} (cache {vplan.ct * T * T * 2 / 2**20:.1f} "
        "MiB against the 50 MB L2)")
    seg_len = np.unique(gd, return_counts=True)[1]
    log(f"  segments={seg_len.size} len: mean={seg_len.mean():.1f} "
        f"med={int(np.median(seg_len))} max={seg_len.max()}")
    def level_bound(steps):
        flops, nbytes = e2_work(steps, T)
        return bound(flops, PEAK_BF16, nbytes)

    # every case runs the level's pairs: bound as K3 on the bf16 stream,
    # or on the fp32 pools for the pools baseline
    stream_bd = level_bound(
        [("pool", ("stream", "l"), ("stream", "l"), x1536, False)])
    cases = [("K11", CA.gemm_scatter_vcache, CA.gemm_scatter_vcache_ref,
              (xab, vplan), "K11", stream_bd)]
    for G in (4, 8):
        mplan = CA.mp_plan(CA.build_mp_schedule(ga, gb, gd, 1536, G, tp), dev)
        padded = int((np.ceil(seg_len / G) * G).sum())
        log(f"  G={G}: padded pairs {padded} (x{padded / ng:.2f}), steps "
            f"{padded // G} ({ng / (padded // G):.1f} real pairs/step), "
            f"{len(mplan.chunks)} chunks, CT {mplan.ct} (cache "
            f"{mplan.ct * T * T * 2 / 2**20:.1f} MiB)")
        for variant in CA.MP_VARIANTS:
            cases.append((f"K12 {variant} G={G}", CA.gemm_scatter_mp,
                          CA.gemm_scatter_mp_ref, (xab, mplan, variant),
                          "K12", stream_bd))
    k3, k3_ref = PL.gemm_scatter_pipelined, PL.gemm_scatter_pipelined_ref
    pools2 = PL.pipeline_plan(PL.build_pipeline_schedule(ga, gb, gd, group=2),
                              dev)
    x6144 = PL.pipeline_plan(PL.build_pipeline_schedule(
        ga, gb, gd, chunk=6144, group=2, ext_tiles=tp), dev)
    on_stream = (lambda p, plan: k3(p, plan, bf16, xab=xab),
                 lambda p, plan: k3_ref(p, plan, bf16, xab=xab))
    cases += [
        ("K3 G=2 pools", lambda p, plan: k3(p, plan, bf16),
         lambda p, plan: k3_ref(p, plan, bf16), (pools2,), "K3",
         level_bound([("pool", "pool", "pool", pools2, False)])),
        ("K3 xab chunk 1536", *on_stream, (x1536,), "K3", stream_bd),
        ("K3 xab chunk 6144", *on_stream, (x6144,), "K3", stream_bd),
    ]
    out = {}
    for label, run, run_ref, args, key, bd in cases:
        got = run(f.pool.clone(), *args)
        if key == "K12" and not torch.equal(got, run(f.pool.clone(), *args)):
            raise AssertionError(f"{label}: two runs differ")
        ref = run_ref(f.pool.clone(), *args)
        torch.cuda.synchronize()
        e_twin = float((got - ref).abs().max())
        e_xla = float((got - want).abs().max())
        ok = max(e_twin, e_xla) <= TOL_E2 * scale
        log(f"{label}: max|d| twin {e_twin:.3e}, gemm_scatter bf16 "
            f"{e_xla:.3e}, max|ref| {scale:.3e} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label} disagrees with its twin or with "
                                 "gemm_scatter")
        if key in errs:
            errs[key] = max(errs[key], e_twin)
        del got, ref
        work = f.pool.clone()
        reset_counts()
        ms = cuda_ms(lambda: run(work, *args))
        launched = counters()[key].launches
        plain = cuda_ms(lambda: run_ref(work, *args))
        log(f"timing {label} ({ng} pairs, bf16): kernel {ms:.3f} ms "
            f"({ms * 1e6 / ng:.0f} ns/pair), twin {plain:.3f} ms, bound "
            f"{bd[0]:.4f} ms ({bd[1]}), launches {launched}")
        out[label] = (ms, plain, bd, launched)
        del work
    return out


# exp_dma.py's rows, in its order: (rows of a tile, S, D, steps, reps,
# CTAs (0: one per SM), bytes a bulk copy at most), then its first row on
# fewer CTAs (the card's bytes in flight cut down to one CTA's) and in
# larger pieces (the same count in flight, more bytes a copy)
PROBE_ROWS = (
    [(128, S, D, st, reps, 0, 4096) for S, D, st, reps in (
        (1, 2, 1024, 128), (1, 4, 1024, 64), (1, 8, 512, 64),
        (2, 2, 1024, 64), (4, 2, 1024, 32), (8, 2, 512, 32),
        (16, 2, 256, 32), (32, 2, 128, 32))]
    + [(rows, 1, D, 1024, 64, 0, 4096) for rows in (64, 32)
       for D in (2, 4, 8)]
    + [(rows, 1, D, 512, 64, 0, 4096) for rows in (64, 32)
       for D in (12, 16)]
    + [(128, 1, 2, 1024, 16, c, 4096) for c in (1, 4, 16, 66)]
    + [(128, 1, D, 1024, 4, 1, 4096) for D in (8, 16)]
    + [(128, 1, 2, 1024, 128, 0, pc) for pc in (8192, 16384, 32768)]
    + [(128, 1, 2, 1024, 16, 1, 32768)])


def probe_harness(dev, errs):
    """Phase 15: the reference's copy probe (``exp_dma.py``): a pool of
    12,000 fp32 T=128 tiles (786 MB) drawn as ``exp_dma.py:26-28``, viewed
    as (12000, 128, T), (24000, 64, T) and (48000, 32, T); every row of
    :data:`PROBE_ROWS` with its index table drawn in the reference's order
    (``integers(0, N - S, (steps, D))``).  K13 against ``probe_ref`` (both
    rows of every copy, ``TOL_K13`` of max|ref|), then K13 (its index
    table checked once, before), its twin and one library call timed:
    ``view.index_select`` of one repeat's S-tile runs, times reps (the
    same bytes).  The twin is the closed form, which reads two rows a
    copy, not the copies.  Bound: every copy's bytes over 3.35 TB/s.  The
    log gives the card's bytes in flight (CTAs x 2 D pieces) and, by
    Little's law, the latency they imply at the measured rate.  Launches
    counted from 0 over each row's timed runs.  Returns a list of (rows,
    S, D, steps, reps, ctas, ms, twin ms, bound, library ms, launches)."""
    import torch
    from pastix_tpu_torch.numeric import dma_probe as DP

    npool, T = 12000, 128
    rng = np.random.default_rng(0)
    pool = torch.from_numpy(rng.standard_normal((npool, T, T)).astype(
        np.float32)).to(dev)
    views = {128: pool, 64: pool.view(npool * 2, 64, T),
             32: pool.view(npool * 4, 32, T)}
    out = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for rows, S, D, steps, reps, ctas, pc in PROBE_ROWS:
        view = views[rows]
        idx = torch.as_tensor(rng.integers(0, view.shape[0] - S, (
            steps, D)).astype(np.int32), device=dev)
        got = DP.probe(view, idx, S, reps, ctas=ctas, piece=pc)
        ref = DP.probe_ref(view, idx, S, reps)
        err = float((got - ref).abs().max()) / float(ref.abs().max())
        piece = DP.piece_bytes(S, rows, T, pc)
        label = (f"{rows * T * 4 // 1024} KB tiles, S={S} D={D}"
                 + (f" on {ctas} CTAs" if ctas else "")
                 + (f", {piece // 1024} KB pieces" if pc != DP.PIECE
                    else ""))
        if not err <= TOL_K13:
            raise AssertionError(f"K13 {label}: rel max|d| {err:.3e}")
        errs["K13"] = max(errs["K13"], float((got - ref).abs().max()))
        flat = (idx.long()[:, :, None] + torch.arange(S, device=dev)).reshape(
            -1)
        reset_counts()
        ms = cuda_ms(lambda: DP.probe(view, idx, S, reps, ctas=ctas,
                                      piece=pc, check_idx=False))
        launched = DP.probe.launches
        plain = cuda_ms(lambda: DP.probe_ref(view, idx, S, reps))
        lib = cuda_ms(lambda: view.index_select(0, flat)) * reps
        ncopy = reps * steps * D
        nbytes = ncopy * S * rows * T * 4.0
        bd = bound(0.0, PEAK_FP32, nbytes)
        distinct = np.unique(flat.cpu().numpy()).size * rows * T * 4
        grid = min(ctas or sms, reps * steps)
        flight = grid * 2 * D * piece
        per_piece = ms * 1e3 * grid / (nbytes / piece)  # us a CTA's piece
        log(f"probe {label} ({S * rows * T * 4 // 1024} KB a copy), "
            f"{steps} steps x {reps} reps: rel max|d| {err:.1e}; kernel "
            f"{ms:.3f} ms = {ms * 1e3 / ncopy:.4f} us/copy, "
            f"{nbytes / ms / 1e6:.1f} GB/s; twin (closed form) "
            f"{plain:.3f} ms; index_select x reps {lib:.3f} ms "
            f"({nbytes / lib / 1e6:.1f} GB/s); bound {bd[0]:.3f} ms; "
            f"in flight {flight / 1e6:.3f} MB ({piece} B pieces, "
            f"{per_piece:.3f} us a CTA's piece), Little's latency "
            f"{flight / (nbytes / ms * 1e3) * 1e6:.3f} us; one "
            f"repeat's distinct bytes {distinct / 1e6:.1f} MB (L2 50 MB); "
            f"launches {launched}")
        out.append((rows, S, D, steps, reps, ctas, piece, ms, plain, bd,
                    lib, launched))
    del pool, views
    return out


_SASS = {}  # cuobjdump -sass of each library, dumped once


def instrument(s):
    """Counters of the solver's next solves: the device loop's iterations
    and preconditioner applications, and the host's factored solves (the
    host loop's M⁻¹, one a call whatever the RHS width)."""
    rec = {"dev_iters": 0, "dev_applies": 0, "host_solves": 0}
    dev_fn, raw = s._refine_fn, s._raw_solve_ext
    if dev_fn is not None:
        def counted_dev(*args):
            x, it = dev_fn(*args)
            rec["dev_iters"] += it
            rec["dev_applies"] += dev_fn.applies
            return x, it

        s._refine_fn = counted_dev

    def counted_host(v):
        rec["host_solves"] += 1
        return raw(v)

    s._raw_solve_ext = counted_host
    return rec


def front_door_solver(label, A, cfg, dev, b, need, forbid=()):
    """One solver of phase 16: analyze, factorize twice, solve; its counts
    read (``need`` launched, ``forbid`` and the twins not); then a second
    solve, timed and counted alone: residual <= 1e-10, K2 at most twice a
    preconditioner application.  Returns (solver, x, figures)."""
    import torch

    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    s, t = analyzed(A, cfg, dev)
    fact = []
    for _ in range(2):
        s.factorize()
        fact.append(s.report.fact_time * 1e3)
    s.solve(b)
    read_counts(f"{label}: analysis, factorize, first solve", need, forbid)
    rec = instrument(s)
    reset_counts()
    x = s.solve(b)
    launches = read_counts(f"{label}: second solve",
                           [k for k in need if k == "K2"], forbid)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30
    M = A.to_scipy()
    res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
    applies = rec["dev_applies"] + rec["host_solves"]
    num = {
        "analysis_s": sum(t.values()), "fact_ms": fact,
        "solve_ms": s.report.solve_time * 1e3,
        "refine_ms": s.report.refine_time * 1e3,
        "iters": s.report.refine_iters,
        "host_steps": s.report.refine_iters - rec["dev_iters"],
        "applies": applies, "K2": launches["K2"],
        "residual": s.report.residual, "residual_original_order": res,
        "peak_gib": peak, "dinv": s.factors.dinv is not None,
    }
    log(f"front door {label}: " + json.dumps(num))
    if not max(res, s.report.residual) <= TOL_RES:
        raise AssertionError(f"{label}: residual {res:.3e} above {TOL_RES}")
    if launches["K2"] > 2 * applies:
        raise AssertionError(f"{label}: {launches['K2']} K2 launches for "
                             f"{applies} preconditioner applications")
    return s, x, num


def front_door_path(nx, lu_nx, dev, main_iters):
    """Phase 16: the front door and the refinement methods at full width
    (see the module docstring); each run's figures go to the log."""
    import gc
    import inspect
    import shutil
    import tempfile

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch
    from pastix_tpu_torch import cli
    from pastix_tpu_torch.config import (
        Factorization, IOStrategy, PastixConfig, RefinementMethod, Task,
    )
    from pastix_tpu_torch.distributed import CSCDPart, dspsolve
    from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
    from pastix_tpu_torch.murge import MurgeSolver
    from pastix_tpu_torch.pastix import pastix
    from pastix_tpu_torch.sparse import SparseMatrix

    io_root = tempfile.mkdtemp(prefix="pastix_front_door_")
    saved = set()

    def cfg(kind, **kw):
        # the first solver of a matrix saves its order, symbol and layout;
        # every later one loads them (one host analysis a matrix)
        io = IOStrategy.LOAD if kind in saved else IOStrategy.SAVE
        saved.add(kind)
        return PastixConfig(
            tile_size=128, update_dtype="bfloat16",
            factorization=Factorization[kind], io_strategy=io,
            io_dir=os.path.join(io_root, kind), **kw)

    try:
        os.makedirs(os.path.join(io_root, "LLT"))
        os.makedirs(os.path.join(io_root, "LU"))
        CG = RefinementMethod.CG
        A = poisson_3d(nx)
        M = A.to_scipy()
        b = M @ np.ones(A.n)
        gc.collect()
        m0 = torch.cuda.memory_allocated(dev)
        need = ("K1", "K2")
        base, _, fast = front_door_solver(
            f"LLT CG poisson_3d({nx})", A, cfg("LLT", refinement=CG), dev, b,
            need)
        for name, kw, forbid in (
                ("GMRES", dict(refinement=RefinementMethod.GMRES), ()),
                ("BICGSTAB", dict(refinement=RefinementMethod.BICGSTAB), ()),
                ("CG device_refine=False", dict(refinement=CG,
                                                device_refine=False), ()),
                ("CG fast_solve=False", dict(refinement=CG, fast_solve=False),
                 ("K2",))):
            s, _, num = front_door_solver(
                f"LLT {name}", A, cfg("LLT", **kw), dev, b,
                [k for k in need if k not in forbid], forbid)
            if (s.factors.dinv is None) != bool(forbid):
                raise AssertionError(f"LLT {name}: dinv is "
                                     f"{'present' if forbid else 'missing'}")
            del s
            gc.collect()
        # num: the last run's, fast_solve=False
        log(f"  peak device memory above the run's start: fast_solve "
            f"{fast['peak_gib']:.3f} GiB, fast_solve=False "
            f"{num['peak_gib']:.3f} GiB")

        # new values on the cached analysis, against a fresh solver
        v = np.array(A.values, dtype=np.float64)
        v[A.rowind == np.repeat(np.arange(A.n), np.diff(A.colptr))] *= 1.1
        A2 = SparseMatrix(A.n, A.colptr, A.rowind, v, A.symmetric_storage)
        reset_counts()
        t0 = time.perf_counter()
        base.factorize(v)
        call_ms = (time.perf_counter() - t0) * 1e3
        x = base.solve(b)
        read_counts("LLT CG factorize(values)", need)
        fresh, xf, _ = front_door_solver(
            "LLT CG fresh solver on the new values", A2, cfg("LLT",
                                                             refinement=CG),
            dev, b, need)
        pool_d = float((base.factors.pool - fresh.factors.pool).abs().max())
        rel = float(np.linalg.norm(x - xf) / np.linalg.norm(xf))
        num = {
            "fact_ms_first": fast["fact_ms"][0],
            "fact_ms_second": fast["fact_ms"][1],
            "refactor_ms": base.report.fact_time * 1e3,
            "refactor_call_ms": call_ms, "iters": base.report.refine_iters,
            "fresh_iters": fresh.report.refine_iters,
            "x_rel_diff": rel, "max_pool_diff": pool_d,
            "residual": base.report.residual,
        }
        log("front door factorize(values): " + json.dumps(num))
        if (base.report.refine_iters != fresh.report.refine_iters
                or not rel <= TOL_REFAC
                or not base.report.residual <= TOL_RES):
            raise AssertionError("factorize(values) disagrees with a fresh "
                                 "solver on the new values")
        del fresh
        gc.collect()

        # the factored solve under scipy's CG
        M2 = A2.to_scipy()
        op = base.as_preconditioner()
        steps = [0]
        tol = ("rtol" if "rtol" in inspect.signature(spla.cg).parameters
               else "tol")
        t0 = time.perf_counter()
        xs, info = spla.cg(M2, b, M=op, atol=0.0, maxiter=main_iters + 2,
                           callback=lambda _: steps.__setitem__(
                               0, steps[0] + 1), **{tol: TOL_RES})
        cg_ms = (time.perf_counter() - t0) * 1e3
        res = float(np.linalg.norm(b - M2 @ xs) / np.linalg.norm(b))
        num = {
            "scipy_cg_steps": steps[0], "max_steps": main_iters + 2,
            "info": int(info), "residual": res, "ms": cg_ms,
            "dtype": str(op.dtype)}
        log("front door as_preconditioner under scipy cg: " + json.dumps(num))
        if info != 0 or not res <= TOL_RES:
            raise AssertionError("scipy cg with as_preconditioner did not "
                                 f"reach {TOL_RES} in {main_iters + 2} steps")

        # the array API and its phase window
        Mc = M.tocsc()
        reset_counts()
        x, rep = pastix(A.n, Mc.indptr, Mc.indices, Mc.data, b,
                        cfg("LLT", end_task=Task.ANALYSE), device=dev)
        if x is not None or rep.fact_time != 0 or rep.n_tiles == 0:
            raise AssertionError("pastix() ORDERING..ANALYSE factored or "
                                 "solved")
        x, rep = pastix(A.n, Mc.indptr, Mc.indices, Mc.data, b,
                        cfg("LLT", end_task=Task.CLEAN), device=dev)
        read_counts("pastix() ORDERING..CLEAN", need)
        res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
        num = {"residual": rep.residual, "residual_original_order": res,
               "iters": rep.refine_iters}
        log("front door pastix(): " + json.dumps(num))
        if not max(res, rep.residual) <= TOL_RES:
            raise AssertionError("pastix() did not reach the residual")

        # clean() gives the card's memory back
        del op
        gc.collect()
        held = torch.cuda.memory_allocated(dev)
        base.clean()
        left = torch.cuda.memory_allocated(dev)
        num = {"before_solver_mib": m0 / 2 ** 20, "held_mib": held / 2 ** 20,
               "after_clean_mib": left / 2 ** 20}
        log("front door clean(): " + json.dumps(num))
        if left > m0 + CLEAN_SLACK:
            raise AssertionError(f"clean() left {(left - m0) / 2 ** 20:.1f} "
                                 "MiB allocated")
        del base
        gc.collect()

        # LU with GMRES and BiCGStab
        C = convection_diffusion_3d(lu_nx)
        bc = C.to_scipy() @ np.ones(C.n)
        for name in ("GMRES", "BICGSTAB"):
            s, _, _ = front_door_solver(
                f"LU {name} convection_diffusion_3d({lu_nx})", C,
                cfg("LU", refinement=RefinementMethod[name]), dev, bc,
                ("K1", "K2", "K4"))
            del s
            gc.collect()

        # the host front ends, once each at poisson_3d(24)
        A24 = poisson_3d(24)
        M24 = A24.to_scipy()
        C24 = sp.coo_matrix(M24)
        b24 = M24 @ np.ones(A24.n)
        res = lambda M_, x_: float(np.linalg.norm(b24 - M_ @ x_)
                                   / np.linalg.norm(b24))
        small = PastixConfig(tile_size=128, update_dtype="bfloat16")
        reset_counts()
        m = MurgeSolver(A24.n, small, device=dev)
        m.graph_begin()
        m.graph_edge(C24.row, C24.col)
        m.graph_end()
        m.assembly_begin()
        m.assembly_set_value(C24.row, C24.col, C24.data)
        m.assembly_end()
        r1 = res(M24, m.solve(b24))
        layout = m._solver.layout
        m.assembly_begin(MurgeSolver.OVERWRITE)
        m.assembly_set_value(C24.row, C24.col, 2.0 * C24.data)
        m.assembly_end()
        r2 = res(2.0 * M24, m.solve(b24))
        reused = m._solver.layout is layout
        parts = []
        for ch in np.array_split(np.arange(C24.nnz), 4):
            rows, cols = C24.row[ch], C24.col[ch]
            gl = np.unique(np.concatenate([rows, cols]))
            parts.append(CSCDPart(rows=np.searchsorted(gl, rows),
                                  cols=np.searchsorted(gl, cols),
                                  vals=C24.data[ch], loc2glob=gl))
        owner = np.full(A24.n, -1)
        for i, p in enumerate(parts):
            owner[p.loc2glob[owner[p.loc2glob] < 0]] = i
        xs = dspsolve(A24.n, parts,
                      [np.where(owner[p.loc2glob] == i, b24[p.loc2glob], 0.0)
                       for i, p in enumerate(parts)], small, device=dev)
        xd = np.zeros(A24.n)
        for p, xp in zip(parts, xs):
            xd[p.loc2glob] = xp
        r3 = res(M24, xd)
        rc = cli.main(["-lap3", "24", "--refine", "gmres", "--steps"])
        read_counts("front ends poisson_3d(24)", need)
        num = {
            "murge_residual": r1, "murge_new_values_residual": r2,
            "murge_analysis_reused": reused, "dspsolve_residual": r3,
            "cli_rc": rc}
        log("front door front ends: " + json.dumps(num))
        if (not max(r1, r2, r3) <= TOL_RES or not reused or rc != 0):
            raise AssertionError("a front end failed at poisson_3d(24)")
    finally:
        shutil.rmtree(io_root, ignore_errors=True)


def herm_3d(nx, delta=HERM_DELTA):
    """Phase 17 (a): poisson_3d(nx) + i S - i Sᵀ + delta I, S the strict
    lower triangle of the Laplacian's pattern times 0.2 N(0, 1) from
    ``default_rng(0)``: ``tests/test_complex.py``'s ``_hermitian_spd`` in
    3D (scipy CSC, Hermitian).  Without ``delta`` the matrix is
    indefinite from nx = 32 on (the skew part lowers the low modes by
    about 0.041); ``delta=0`` is (c)'s base."""
    import scipy.sparse as sp
    from pastix_tpu_torch.generators import poisson_3d

    L = poisson_3d(nx).to_scipy().tocsc()
    C = sp.tril(L, -1).tocoo()
    S = sp.coo_matrix(
        (0.2 * np.random.default_rng(0).standard_normal(C.nnz),
         (C.row, C.col)), shape=L.shape)
    return (L + 1j * S - 1j * S.T + delta * sp.eye(L.shape[0])).tocsc()


def helmholtz_3d(nx, k=10.0, damping=0.05):
    """Phase 17 (b): poisson_3d(nx) - (k² + i damping k²) / (nx + 1)² I,
    ``generators.helmholtz_2d``'s formula on the 3D Laplacian (scipy CSC,
    complex-symmetric)."""
    import scipy.sparse as sp
    from pastix_tpu_torch.generators import poisson_3d

    L = poisson_3d(nx).to_scipy().tocsc()
    shift = (k * k + 1j * damping * k * k) / (nx + 1) ** 2
    return (L - shift * sp.eye(L.shape[0])).tocsc()


def complex_lu_3d(nx):
    """Phase 17 (d): B + 0.3i |B|, B = convection_diffusion_3d(nx)
    (``tests/test_complex.py``'s complex LU construction)."""
    from pastix_tpu_torch.generators import convection_diffusion_3d

    B = convection_diffusion_3d(nx).to_scipy().tocsc()
    return (B + 0.3j * abs(B)).tocsc()


def precision_cfg(dtype, kind="LLT", herm=False, **kw):
    from pastix_tpu_torch.config import (
        Factorization, PastixConfig, Symmetry,
    )

    sym = Symmetry.HERMITIAN if herm else Symmetry.SYMMETRIC
    return PastixConfig(tile_size=128, compute_dtype=dtype,
                        factorization=Factorization[kind], symmetry=sym, **kw)


def precision_run(label, M, cfg, dev, solver=None, t=None):
    """One run of phase 17 on the scipy matrix ``M``: analyze (unless
    ``solver`` is already analyzed, in ``t`` seconds), factorize twice (the second timed),
    solve b = M 1 twice (the second timed and counted alone); the counts
    are set to 0 before the first factorize and read after the second
    solve: no hand kernel and no twin may run.  Residual <= 1e-10 in the
    host's complex128 or fp64.  Returns (solver, figures)."""
    import torch

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if solver is None:
        solver, t = analyzed(M, cfg, dev)
    s, lay = solver, solver.layout
    reset_counts()
    fact = []
    for _ in range(2):
        s.factorize()
        fact.append(s.report.fact_time * 1e3)
    b = M @ np.ones(M.shape[0])
    s.solve(b)
    rec = instrument(s)
    x = s.solve(b)
    read_counts(f"precision {label}", (), tuple(counters()))
    res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
    pool = s.factors.pool
    npools = 1 if s.factors.pool_u is None else 2
    num = {
        "dtype": str(pool.dtype).split(".")[-1], "kind": s._kind.name,
        "hermitian": s.factors.hermitian, "n": int(M.shape[0]),
        "analysis_s": sum(t.values()), "fact_ms": fact,
        "fact_flops": s.report.fact_flops,
        "solve_ms": s.report.solve_time * 1e3,
        "refine_ms": s.report.refine_time * 1e3,
        "steps": s.report.refine_iters,
        "host_steps": s.report.refine_iters - rec["dev_iters"],
        "device_loop": s._refine_fn is not None,
        "residual": s.report.residual, "residual_original_order": res,
        "static_pivots": s.report.static_pivots,
        "dense_tail_m": s.report.dense_tail_m, "levels": s.report.n_levels,
        "pools_gib": npools * pool.numel() * pool.element_size() / 2 ** 30,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if cuda else None),
    }
    log(f"precision {label}: " + json.dumps(num))
    if x.shape != (M.shape[0],) or not np.isfinite(x).all():
        raise AssertionError(f"{label}: the solution is not finite")
    if not max(res, s.report.residual) <= TOL_RES:
        raise AssertionError(f"{label}: residual {res:.3e} above {TOL_RES}")
    return s, num


def card_matches_cpu(M, cfg, dev):
    """(pool, solution) max|card - cpu| / max|cpu| of one solver
    configuration, its unrefined solve of b = M 1 included: the card's
    complex products in the precision of the CPU's."""
    from pastix_tpu_torch import Pastix

    out = []
    for d in (dev, "cpu"):
        s = Pastix(M, cfg, device=d)
        x = s.solve(M @ np.ones(M.shape[0]), refine=False)
        out.append((s.factors.pool.cpu().numpy(), x))
    rel = lambda a, r: float(np.abs(a - r).max() / np.abs(r).max())
    (p1, x1), (p0, x0) = out
    return rel(p1, p0), rel(x1, x0)


def bmm_pinned_error(dev, seed=0):
    """max|bmm(a, b) - bmm in complex128| / max|ref| of complex64 (64,
    128, 128) operands under ``pin_precision``, with TF32 asked for
    outside it: complex products must stay in true fp32."""
    import torch
    from pastix_tpu_torch._device import pin_precision

    g = torch.Generator(device="cpu").manual_seed(seed)
    a, b = (torch.randn((64, 128, 128), dtype=torch.complex64, generator=g)
            .to(dev) for _ in range(2))
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        with pin_precision():
            c = torch.bmm(a, b)
    finally:
        torch.set_float32_matmul_precision(saved)
    ref = torch.bmm(a.to(torch.complex128), b.to(torch.complex128))
    return float((c.to(torch.complex128) - ref).abs().max()
                 / ref.abs().max())


def precision_path(nx, lu_nx, dev):
    """Phase 17: complex and fp64 factorizations at full width (see the
    module docstring); each run's figures go to the log.  Returns the
    runs' figures by label."""
    import gc
    import shutil
    import tempfile

    import torch
    from pastix_tpu_torch import cli
    from pastix_tpu_torch.config import IOStrategy, RefinementMethod

    t_phase = time.perf_counter()
    runs = {}
    io_root = tempfile.mkdtemp(prefix="pastix_precision_")
    saved = set()

    def io(group):
        # one host analysis a layout: poisson_3d(nx)'s pattern with the
        # dense tail (LLᴴ, fp64 LLᵗ) and without it (the others)
        d = os.path.join(io_root, group)
        first = group not in saved
        saved.add(group)
        if first:
            os.makedirs(d)
        return dict(io_strategy=IOStrategy.SAVE if first else IOStrategy.LOAD,
                    io_dir=d)

    def run(label, M, cfg, solver=None, t=None):
        gc.collect()
        s, num = precision_run(label, M, cfg, dev, solver, t)
        runs[label] = num
        return s

    GMRES = RefinementMethod.GMRES
    try:
        # (a) Hermitian LLᴴ, complex64 and complex128, dense tail on
        H = herm_3d(nx)
        for dt in ("complex64", "complex128"):
            run(f"LLH {dt} herm_3d({nx})", H,
                precision_cfg(dt, herm=True, **io("tail")))
        # (b) complex-symmetric LDLᵗ and LLᵗ on the 3D Helmholtz matrix
        Hz = helmholtz_3d(nx)
        for kind in ("LDLT", "LLT"):
            run(f"{kind} complex64 helmholtz_3d({nx})", Hz,
                precision_cfg("complex64", kind, refinement=GMRES,
                              **io("plain")))
        del Hz
        # (c) LDLᴴ of the indefinite herm_3d(nx, 0) - sigma I
        _, sigma = shift_invert(nx)
        import scipy.sparse as sp

        Hc = (herm_3d(nx, 0.0) - sigma * sp.eye(H.shape[0])).tocsc()
        del H
        label = f"LDLH complex64 herm_3d({nx}, 0) - {sigma:.6g} I"
        s = run(label, Hc, precision_cfg("complex64", "LDLH", herm=True,
                                         refinement=GMRES, **io("plain")))
        d = s.factors.d.real
        inertia = (int((d < 0).sum()), int((d > 0).sum()), int((d == 0).sum()))
        runs[label]["inertia"] = inertia
        log(f"  LDLH inertia (negative, positive, zero real pivots of "
            f"{d.numel()}, padding included): {inertia}, static pivots "
            f"{s.report.static_pivots}")
        del s, Hc, d
        # (d) complex LU: the largest nx <= lu_nx whose two complex64
        # pools fit the card twice over (the pools and their temporaries)
        nxl = lu_nx
        while True:
            C = complex_lu_3d(nxl)
            s, t = analyzed(C, precision_cfg("complex64", "LU"), dev)
            need = 2 * 2 * s.layout.npool * s.layout.T ** 2 * 8
            free = (torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda"
                    else need)
            log(f"  complex LU convection_diffusion_3d({nxl}): pools "
                f"{need / 2 / 2 ** 30:.3f} GiB, free {free / 2 ** 30:.3f} GiB")
            if need <= free or nxl <= 24:
                break
            del s, C
            gc.collect()
            nxl -= 6
        log(f"  complex LU at nx = {nxl}")
        run(f"LU complex64 convection_diffusion_3d({nxl}) + 0.3i|B|", C,
            None, solver=s, t=t)
        del s, C
        # (e) fp64: LLᵗ on poisson_3d(nx), LDLᵗ on the shift-invert matrix
        from pastix_tpu_torch.generators import poisson_3d

        P = poisson_3d(nx).to_scipy().tocsc()
        run(f"LLT float64 poisson_3d({nx})", P,
            precision_cfg("float64", **io("tail")))
        del P
        Si = shift_invert(nx)[0].to_scipy().tocsc()
        run(f"LDLT float64 poisson_3d({nx}) - {sigma:.6g} I", Si,
            precision_cfg("float64", "LDLT", update_dtype=None,
                          **io("plain")))
        del Si
        gc.collect()
        # (f) the CLI in complex128
        reset_counts()
        rc = cli.main(["-lap3", "24", "--dtype", "c128", "--steps"]
                      + ([] if dev.type == "cuda" else ["--cpu"]))
        read_counts("precision CLI -lap3 24 --dtype c128", (),
                    tuple(counters()))
        log(f"precision CLI -lap3 24 --dtype c128 --steps: exit code {rc}")
        if rc != 0:
            raise AssertionError("the CLI failed in complex128")
        runs["CLI c128"] = {"rc": rc}
        # the card-only checks at 24³
        if dev.type == "cuda":
            for label, M, cfg in (
                    ("LLH", herm_3d(24), precision_cfg("complex64",
                                                       herm=True)),
                    ("LDLT", helmholtz_3d(24),
                     precision_cfg("complex64", "LDLT")),
                    ("LLT", helmholtz_3d(24),
                     precision_cfg("complex64", "LLT"))):
                ep, ex = card_matches_cpu(M, cfg, dev)
                log(f"  card against CPU, {label} complex64 at 24³: pool "
                    f"{ep:.3e}, unrefined solution {ex:.3e}")
                runs[f"card vs cpu {label}"] = {"pool": ep, "solution": ex}
                if not max(ep, ex) <= TOL_CARD:
                    raise AssertionError(f"{label}: the card's complex64 "
                                         "differs from the CPU's")
            eb = bmm_pinned_error(dev)
            log(f"  complex64 bmm under pin_precision against complex128: "
                f"{eb:.3e}")
            runs["bmm complex64"] = {"rel_err": eb}
            if not eb <= TOL_BMM:
                raise AssertionError("complex64 bmm is not true fp32")
    finally:
        shutil.rmtree(io_root, ignore_errors=True)
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")
    return runs


def phase18_run(label, M, cfg, dev, need_fact=(), forbid_fact=(),
                need_solve=("K2",), forbid_solve=()):
    """One run of phase 18 on the scipy matrix ``M``: analyze, factorize
    twice (the second timed), the counts read (``need_fact`` launched,
    ``forbid_fact`` not, no twin); then solve b = M 1 twice (the second
    timed), the counts read again (``need_solve`` launched).  Residual
    <= 1e-10 in the host's fp64.  Returns (solver, figures)."""
    import torch

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    s, t = analyzed(M, cfg, dev)
    fact = []
    for _ in range(2):
        s.factorize()
        fact.append(s.report.fact_time * 1e3)
    fl = read_counts(f"{label}: factorize x2", need_fact, forbid_fact)
    b = M @ np.ones(M.shape[0])
    reset_counts()
    s.solve(b)
    rec = instrument(s)
    x = s.solve(b)
    sl = read_counts(f"{label}: solve x2", need_solve, forbid_solve)
    res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
    lay = s.layout
    num = {
        "n": int(M.shape[0]), "analysis_s": sum(t.values()),
        "fact_ms": fact, "fact_flops": s.report.fact_flops,
        "gflops": s.report.fact_flops / fact[1] / 1e6,
        "solve_ms": s.report.solve_time * 1e3,
        "refine_ms": s.report.refine_time * 1e3,
        "steps": s.report.refine_iters, "device_steps": rec["dev_iters"],
        "host_steps": s.report.refine_iters - rec["dev_iters"],
        "residual": s.report.residual, "residual_original_order": res,
        "static_pivots": s.report.static_pivots,
        "npool": lay.npool if lay is not None else None,
        "levels": s.report.n_levels if lay is not None else None,
        "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                     if cuda else None),
        "launches_fact": {k: v for k, v in fl.items() if v},
        "launches_solve": {k: v for k, v in sl.items() if v},
    }
    log(f"ilu/packed {label}: " + json.dumps(num))
    if x.shape != (M.shape[0],) or not np.isfinite(x).all():
        raise AssertionError(f"{label}: the solution is not finite")
    if not max(res, s.report.residual) <= TOL_RES:
        raise AssertionError(f"{label}: residual {res:.3e} above {TOL_RES}")
    return s, num


def ilu_twins(s, label, errs, k1key, k2key):
    """K1 on the busiest level of the block ILU solver ``s`` and K2 on
    its factors against their twins, on the plans its incomplete layout
    gives them; the counts are reset first, so these launches stay out of
    the path's.  max|d| to ``errs[k1key]`` and ``errs[k2key]``."""
    reset_counts()
    lv = busiest_level(s._fact_fn)
    if not lv.ll:
        raise AssertionError(f"{label}: no K1 chunks on its busiest level")
    check_lists(check_k1, k1_lists(s, lv), f"{label} busiest level", errs,
                k1key, upd_of(s))
    errs[k2key] = max(errs[k2key], check_k2(s, 1, seed=18))


def ilu_packed_path(nx, lu_nx, ldlt_nx, dev, left, errs):
    """Phase 18: block ILU(k) on the card, scalar ILU(k) on the host and
    the packed E2 path at full width (see the module docstring); ``left``
    the left-looking figures of phases 4, 7 and 8 by kind; the block ILU
    runs' K1 and K2 errors against their twins go to ``errs``.  Returns
    the runs' figures by label."""
    import gc
    import inspect

    import scipy.sparse.linalg as spla
    from pastix_tpu_torch.config import Factorization, PastixConfig
    from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d

    t_phase = time.perf_counter()
    runs = {}
    everything = tuple(counters())

    def cfg(kind="LLT", upd="bfloat16", **kw):
        return PastixConfig(tile_size=128, update_dtype=upd,
                            factorization=Factorization[kind], **kw)

    def ilu(k, grain="block"):
        return dict(incomplete=True, level_of_fill=k, ilu_grain=grain,
                    refinement_itermax=400, refinement_eps=TOL_RES)

    # (a) block ILU(0) and ILU(1), LLᵗ, GMRES (the auto-upgrade)
    P = poisson_3d(nx).to_scipy().tocsc()
    b = P @ np.ones(P.shape[0])
    for k in (0, 1):
        gc.collect()
        label = f"block ILU({k}) LLT poisson_3d({nx})"
        s, num = phase18_run(label, P, cfg(**ilu(k)), dev, ("K1",))
        num["npool_complete"] = left["LLT"]["tiles"]
        log(f"  {label}: npool {num['npool']} (complete layout "
            f"{num['npool_complete']}), refinement "
            f"{s.config.refinement.name}, {num['device_steps']} device + "
            f"{num['host_steps']} host steps")
        if s.config.refinement.name != "GMRES" or s._dense_tail is not None:
            raise AssertionError(f"{label}: not GMRES, or a dense tail")
        ilu_twins(s, label, errs, "K1", "K2")
        if k == 0:
            # the factors as M under scipy's GMRES
            op = s.as_preconditioner()
            steps = [0]
            tol = ("rtol" if "rtol" in inspect.signature(spla.gmres)
                   .parameters else "tol")
            t0 = time.perf_counter()
            xs, info = spla.gmres(P, b, M=op, atol=0.0, restart=30,
                                  maxiter=20, callback_type="pr_norm",
                                  callback=lambda _: steps.__setitem__(
                                      0, steps[0] + 1), **{tol: TOL_RES})
            res = float(np.linalg.norm(b - P @ xs) / np.linalg.norm(b))
            num["scipy_gmres"] = {
                "steps": steps[0], "info": int(info), "residual": res,
                "ms": (time.perf_counter() - t0) * 1e3}
            log(f"  {label} as_preconditioner under scipy gmres: "
                + json.dumps(num["scipy_gmres"]))
            if info != 0 or not res <= TOL_RES:
                raise AssertionError("scipy gmres with the ILU(0) "
                                     f"preconditioner did not reach {TOL_RES}")
            del op
        runs[label] = num
        del s
    # (b) block ILU(1), LU
    gc.collect()
    C = convection_diffusion_3d(lu_nx).to_scipy().tocsc()
    label = f"block ILU(1) LU convection_diffusion_3d({lu_nx})"
    s, runs[label] = phase18_run(label, C, cfg("LU", **ilu(1)), dev,
                                 ("K1", "K4"))
    ilu_twins(s, label, errs, "K1x", "K2lu")
    del C, s
    # (c) scalar ILU(1) on the host: no device program, no hand kernel
    for label, M, kind in (
            ("scalar ILU(1) LLT poisson_3d(24)",
             poisson_3d(24).to_scipy().tocsc(), "LLT"),
            ("scalar ILU(1) LU convection_diffusion_3d(16)",
             convection_diffusion_3d(16).to_scipy().tocsc(), "LU")):
        t0 = time.perf_counter()
        s, num = phase18_run(label, M, cfg(kind, **ilu(1, "scalar")), dev,
                             forbid_fact=everything, need_solve=(),
                             forbid_solve=everything)
        num["seconds"] = time.perf_counter() - t0
        num["memory_terms"] = s.report.memory_terms
        log(f"  {label}: {num['seconds']:.2f} s on the host "
            f"(pattern {s.report.analyze_time:.2f} s, factor "
            f"{num['fact_ms'][1] / 1e3:.2f} s), {num['memory_terms']} terms")
        if s.layout is not None or s._refine_fn is not None:
            raise AssertionError(f"{label}: a device program was built")
        runs[label] = num
    # (d) the packed E2 path beside the left-looking figures
    Si = shift_invert(ldlt_nx)[0].to_scipy().tocsc()
    for label, M, c, key, need in (
            (f"packed LLT poisson_3d({nx})", P,
             cfg(packed_update=True), "LLT", ()),
            (f"packed LDLT poisson_3d({ldlt_nx}) - sigma I fp32", Si,
             cfg("LDLT", None, packed_update=True), "LDLT", ("K4",)),
            (f"packed LU convection_diffusion_3d({lu_nx})",
             convection_diffusion_3d(lu_nx).to_scipy().tocsc(),
             cfg("LU", packed_update=True), "LU", ("K4",))):
        gc.collect()
        s, num = phase18_run(label, M, c, dev, need, ("K1", "K3"))
        plan = s._packed_plan
        num.update(
            gemm_flops=plan.gemm_flops(), trsm_flops=plan.trsm_flops(),
            fact_flops_padded=s.report.fact_flops_padded,
            dense_tail_m=s.report.dense_tail_m,
            left={f: left[key][f] for f in ("fact_ms", "gflops", "iters",
                                            "residual", "peak_gib")})
        log(f"  {label}: fact_ms {num['fact_ms'][1]:.1f} (left-looking "
            f"{left[key]['fact_ms']:.1f}), {num['gflops']:.1f} useful "
            f"GFLOP/s, {num['steps']} steps ({left[key]['iters']}), peak "
            f"{num['peak_gib']} GiB ({left[key]['peak_gib']:.3f}); packed "
            f"GEMM {plan.gemm_flops():.4e} + TRSM {plan.trsm_flops():.4e} "
            f"flop against the grid's padded {s.report.fact_flops_padded:.4e}")
        if s._fact_fn.e2 != "packed":
            raise AssertionError(f"{label}: not the packed route")
        runs[label] = num
        del s, M
    del P, Si
    gc.collect()
    # (e) at 24³: packed Schur against the sparse-LU S; complex64 LLᴴ
    # packed, the card against the CPU
    A24 = poisson_3d(24)
    sch = last_plane(24)
    reset_counts()
    s, _ = analyzed(A24, cfg("LLT", None, packed_update=True), dev,
                    schur=sch)
    S = s.get_schur()
    read_counts("packed Schur poisson_3d(24)", (), ("K1", "K3"))
    S_ref = schur_reference(A24, sch)
    s_err = float(np.abs(S - S_ref).max() / np.abs(S_ref).max())
    log(f"  packed Schur poisson_3d(24) {S.shape}: max|S - S_ref|/"
        f"max|S_ref| = {s_err:.3e}")
    runs["packed Schur 24"] = {"rel_err": s_err}
    if S.shape != (sch.size, sch.size) or not s_err <= TOL_S:
        raise AssertionError(f"packed get_schur off by {s_err:.3e}")
    del s
    if dev.type == "cuda":
        reset_counts()
        ep, ex = card_matches_cpu(
            herm_3d(24), precision_cfg("complex64", herm=True,
                                       packed_update=True), dev)
        read_counts("packed LLH complex64 herm_3d(24)", (), everything)
        log(f"  packed LLH complex64 at 24³, card against CPU: pool "
            f"{ep:.3e}, unrefined solution {ex:.3e}")
        runs["packed LLH c64 card vs cpu"] = {"pool": ep, "solution": ex}
        if not max(ep, ex) <= TOL_CARD:
            raise AssertionError("packed LLH complex64: the card's pool "
                                 "differs from the CPU's")
    seconds = time.perf_counter() - t_phase
    runs["seconds"] = seconds
    log(f"phase 18: {seconds:.1f} s")
    return runs


def pool_diff(host, pool):
    """(max|host - pool|, max|pool|, the entries whose difference is
    above 1e-5 max|pool|): a streamed pool in host memory against a
    resident one on the card, compared on the card in chunks of 4096
    tiles."""
    m = float(pool.abs().max())
    d, n = 0.0, 0
    for lo in range(0, pool.shape[0], 4096):
        diff = (host[lo:lo + 4096].to(pool.device) - pool[lo:lo + 4096]).abs()
        d = max(d, float(diff.max()))
        n += int((diff > 1e-5 * m).sum())
    return d, m, n


def level_spread(X, pool, lay):
    """max|X - pool| over the tiles of each level of ``lay`` (the tiles
    of its block columns) / max|pool|, a numpy array; ``X`` in host
    memory or on the card, compared on the card in chunks of 4096
    tiles."""
    import torch

    per = torch.empty(pool.shape[0], dtype=pool.dtype, device=pool.device)
    for lo in range(0, pool.shape[0], 4096):
        per[lo:lo + 4096] = (X[lo:lo + 4096].to(pool.device)
                             - pool[lo:lo + 4096]).abs().amax(dim=(1, 2))
    lev = np.zeros(lay.nbc, np.int64)
    for i, lv in enumerate(lay.levels):
        lev[np.asarray(lv.cols)] = i
    out = np.zeros(len(lay.levels))
    np.maximum.at(out, lev[lay.blk_col], per.cpu().numpy())
    return out / float(pool.abs().max())


def streamed_run(label, A, cfg, dev, need, forbid, limit_mb):
    """One streamed solver of phase 19: analyze, then one factorize with
    the counts set to 0 just before and read just after (``need``
    launched, ``forbid`` and the twins not), the card's cached blocks
    released and its peaks reset first: the peak allocated and reserved
    bytes above their level before it are the factorization's own (each
    <= ``limit_mb``); then a refined solve of b = A 1 (residual <= 1e-10,
    the host loop).  Returns (solver, figures)."""
    import gc

    import torch

    s, t = analyzed(A, cfg, dev)
    plan = s._ooc_plan
    if plan is None:
        raise AssertionError(f"{label}: the analysis did not stream")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    base_r = torch.cuda.memory_reserved(dev)
    reset_counts()
    s.factorize()
    launches = read_counts(f"{label}: streamed factorize", need, forbid)
    peak = torch.cuda.max_memory_allocated(dev) - base
    reserved = torch.cuda.max_memory_reserved(dev) - base_r
    io = dict(plan.io)
    M = A.to_scipy()
    b = M @ np.ones(A.n)
    rec = instrument(s)
    x = s.solve(b)
    res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
    lay = s.layout
    npools = 2 if s.factors.pool_u is not None else 1
    num = {
        "n": A.n, "analysis_s": sum(t.values()),
        "order_symbfact_analyze_s": [t["order"], t["symbfact"], t["analyze"]],
        "npool": lay.npool,
        "pools_gib": npools * lay.npool * lay.T ** 2 * 4 / 2 ** 30,
        "limit_mib": limit_mb, "segments": len(plan.segments),
        "passes": sum(a.win is b_.win for a, b_ in zip(plan.segments,
                                                      plan.segments[1:])),
        "max_window_tiles": max(g.n_win for g in plan.segments),
        "max_footprint_tiles": plan.max_footprint_tiles(),
        "gemm_chunk": plan.gemm_chunk,
        "fact_ms": s.report.fact_time * 1e3,
        "gflops": s.report.fact_flops / s.report.fact_time / 1e9,
        "peak_allocated_mib": peak / 2 ** 20,
        "peak_reserved_mib": reserved / 2 ** 20,
        "allocated_before_mib": base / 2 ** 20,
        "reserved_before_mib": base_r / 2 ** 20,
        "up_gib": io["up_bytes"] / 2 ** 30, "up_s": io["up_s"],
        "down_gib": io["down_bytes"] / 2 ** 30, "down_s": io["down_s"],
        "solve_s": s.report.solve_time + s.report.refine_time,
        "host_steps": s.report.refine_iters - rec["dev_iters"],
        "host_solves": rec["host_solves"],
        "residual": s.report.residual, "residual_original_order": res,
        "static_pivots": s.report.static_pivots,
        "launches": {k: v for k, v in launches.items() if v},
    }
    log(f"ooc {label}: " + json.dumps(num))
    if not s.factors.streamed or s.factors.pool.device.type != "cpu":
        raise AssertionError(f"{label}: the factors are not in host memory")
    if max(peak, reserved) > limit_mb * 2 ** 20:
        raise AssertionError(
            f"{label}: peak allocated {peak / 2 ** 20:.1f} MiB or reserved "
            f"{reserved / 2 ** 20:.1f} MiB above the {limit_mb} MiB budget")
    if x.shape != (A.n,) or not np.isfinite(x).all():
        raise AssertionError(f"{label}: the solution is not finite")
    if not max(res, s.report.residual) <= TOL_RES:
        raise AssertionError(f"{label}: residual {res:.3e} above {TOL_RES}")
    return s, num


def segment_twins(s, label):
    """K3 and K4 of a streamed solver against their twins on the inputs
    its segment programs give them: the factorization streamed again
    (from the host coefinit) up to its busiest segment (the most K3
    pairs) and the busiest one that factors columns, where those differ
    (a later pass of a multi-pass segment runs updates only).  In those
    segments every K3 call (chunks on buffer coordinates into the window
    and the export slots; LDLᵗ ``d=``, LU ``src_pool=`` both ways) and
    every K4 call (a group of diagonal tiles) is checked on copies of
    its operands (``check_k3``: TOL_E2, two runs bit-identical;
    ``check_k4``: TOL_K4, equal clamps) before it runs.  The launches of
    this run are not the main path's.  Returns the figures."""
    import dataclasses

    import scipy.sparse as sp
    import torch
    from pastix_tpu_torch.numeric import factorize as F
    from pastix_tpu_torch.numeric import ooc as O

    fn, plan, lay = s._fact_fn, s._ooc_plan, s.layout
    kind = fn.kind.name
    pairs = [sum(c.n_pairs for lv in p.levels for c in lv.full + lv.nd)
             for p in fn.programs]
    cols = [i for i, p in enumerate(fn.programs)
            if any(lv.groups for lv in p.levels)]
    watch = {int(np.argmax(pairs)), max(cols, key=lambda i: pairs[i])}
    sub = dataclasses.replace(plan, segments=plan.segments[:max(watch) + 1])
    st = {"on": None, "k3": 0, "k4": 0, "k3_err": 0.0, "k4_err": 0.0}
    k3_real, k4_real = O.gemm_scatter_pipelined, F.tile_factor

    def k3(pool, chunks, upd=None, **kw):
        if st["on"] is not None:
            st["k3_err"] = max(st["k3_err"], check_k3(
                pool, chunks, upd, f"{label} segment {st['on']} call "
                f"{st['k3']}", quiet=True, **kw))
            st["k3"] += 1
        return k3_real(pool, chunks, upd, **kw)

    def k4(pool, idx, eps, npiv, lu=False):
        if st["on"] is not None:
            st["k4_err"] = max(st["k4_err"], check_k4(
                pool[idx], eps, lu, f"{label} segment {st['on']} group "
                f"{st['k4']}", quiet=True))
            st["k4"] += 1
        return k4_real(pool, idx, eps, npiv, lu)

    def watched(i, prog):
        def run(*a, **kw):
            st["on"] = i
            try:
                prog(*a, **kw)
            finally:
                st["on"] = None
        return run

    progs = [watched(i, p) if i in watch else p
             for i, p in enumerate(fn.programs[:len(sub.segments)])]
    vals = torch.as_tensor(sp.coo_matrix(s._A_perm).data.astype(np.float32))
    pools = s._coef_fn(vals)
    eps = s.config.static_pivoting_threshold * float(abs(s._A_perm).max())
    O.gemm_scatter_pipelined, F.tile_factor = k3, k4
    try:
        if kind == "LU":
            O.factorize_ooc_lu(lay, sub, *pools, eps, s.device,
                               programs=progs)
        elif kind == "LDLT":
            O.factorize_ooc_ldlt(lay, sub, pools, eps, s.device,
                                 programs=progs)
        else:
            O.factorize_ooc(lay, sub, pools, s.device, programs=progs)
        torch.cuda.synchronize()
    finally:
        O.gemm_scatter_pipelined, F.tile_factor = k3_real, k4_real
    num = {"segments": sorted(watch),
           "pairs": [pairs[i] for i in sorted(watch)],
           "k3_calls": st["k3"], "k3_max_abs_err": st["k3_err"],
           "k4_calls": st["k4"], "k4_max_abs_err": st["k4_err"]}
    log(f"ooc {label}: segment kernels against their twins "
        f"{json.dumps(num)} -> ok")
    if not st["k3"] or (kind != "LLT" and not st["k4"]):
        raise AssertionError(f"{label}: the watched segments ran no K3 or "
                             "no K4")
    return num


def ooc_path(nx, lu_nx, ldlt_nx, big_nx, big_mb, dev, auto_nx=40):
    """Phase 19: out-of-core on the card (see the module docstring).
    Returns the runs' figures by label."""
    import gc
    import shutil
    import tempfile

    import torch
    from pastix_tpu_torch import Pastix
    from pastix_tpu_torch.config import Factorization, IOStrategy, PastixConfig
    from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
    from pastix_tpu_torch.numeric.factorize import build_factorize_fn

    t_phase = time.perf_counter()
    runs = {}
    io_root = tempfile.mkdtemp(prefix="pastix_ooc_")
    LLT, LDLT, LU = Factorization.LLT, Factorization.LDLT, Factorization.LU
    rest = ("K1", "K2", "K5", "K6", "K7", "K8", "K9", "K10", "K11", "K12",
            "K13")
    try:
        # (a) streamed against the resident pair schedule, one host
        # analysis a matrix (saved alone, loaded by both); the pools are
        # held to the resident ones for LLᵗ (bf16) and LU, whose updates
        # are fp32 here: with bf16 ones LU's pools differ by up to 1.1e-4
        # max|resident| where an operand's fp32 value, summed in another
        # order, rounds to another bf16 (PERF.md §6)
        for name, A, kind, upds in (
                (f"LLT poisson_3d({nx})", poisson_3d(nx), LLT,
                 ("bfloat16",)),
                (f"LDLT shift-invert poisson_3d({ldlt_nx})",
                 shift_invert(ldlt_nx)[0], LDLT, (None,)),
                (f"LU convection_diffusion_3d({lu_nx})",
                 convection_diffusion_3d(lu_nx), LU, (None,))):
            gc.collect()
            d = os.path.join(io_root, kind.name)
            os.makedirs(d)
            cfg = lambda io, upd, **kw: PastixConfig(
                tile_size=128, update_dtype=upd, factorization=kind,
                dense_tail=False, io_strategy=io, io_dir=d, **kw)
            # the host analysis alone, saved (no device table is built)
            p = Pastix(A, cfg(IOStrategy.SAVE, None), device=dev)
            p.order()
            p.symbfact()
            lay = p._build_layout(False)
            del p
            npools = 2 if kind == LU else 1
            limit = max(1, npools * lay.npool * lay.T ** 2 * 4 // 3 // 2 ** 20)
            M = A.to_scipy()
            for upd in upds:
                t_run = time.perf_counter()
                label = f"{name} {'fp32' if upd is None else 'bf16'}"
                s, num = streamed_run(
                    label, A, cfg(IOStrategy.LOAD, upd, ooc=True,
                                  ooc_limit_mb=limit),
                    dev, ("K3", "K4") if kind != LLT else ("K3",), rest,
                    limit)
                if num["segments"] < 3:
                    raise AssertionError(f"{label}: fewer than 3 segments")
                t0 = time.perf_counter()
                num["segment_twins"] = segment_twins(s, label)
                num["segment_twins"]["seconds"] = time.perf_counter() - t0
                r, _ = analyzed(A, cfg(IOStrategy.LOAD, upd), dev)
                left = None
                if kind == LDLT:
                    # the resident left-looking schedule (K1) first: how
                    # far fp32 summation order alone moves this matrix's
                    # factor is its spread against the pair one (K3)
                    r.factorize()
                    left = r.factors.pool.clone()
                    r.factors = None
                r._fact_fn = build_factorize_fn(
                    r.layout, dev, kind, e2="pair",
                    update_dtype=None if upd is None else torch.bfloat16)
                r.factorize()
                r.solve(M @ np.ones(A.n))
                resident = {"fact_ms": r.report.fact_time * 1e3,
                            "iters": r.report.refine_iters,
                            "residual": r.report.residual}
                num["resident_pair"] = resident
                errs, over = {}, {}
                for side in ("pool", "pool_u") if kind == LU else ("pool",):
                    diff, top, n = pool_diff(getattr(s.factors, side),
                                             getattr(r.factors, side))
                    errs[side], over[side] = diff / top, n
                num["pool_rel_err"] = errs
                num["entries_above_1e-5"] = over
                ok = max(errs.values()) <= TOL_E2
                held = f"held to {TOL_E2}"
                if left is not None:
                    # a level at a time: TOL_E2, or TOL_ORDER times the
                    # level's spread between the resident schedules
                    pair = r.factors.pool
                    lv_s = level_spread(s.factors.pool, pair, r.layout)
                    lv_l = level_spread(left, pair, r.layout)
                    tol = np.maximum(TOL_E2, TOL_ORDER * lv_l)
                    w = int(np.argmax(lv_s / tol))
                    diff, top, n = pool_diff(left, pair)
                    num["resident_left_vs_pair"] = {
                        "pool_rel_err": diff / top, "entries_above_1e-5": n}
                    num["levels"] = {
                        "count": len(tol),
                        "held_to_tol_e2": int((tol == TOL_E2).sum()),
                        "worst": w, "streamed": lv_s[w], "left": lv_l[w],
                        "tol": tol[w]}
                    ok = bool((lv_s <= tol).all())
                    held = ("held a level at a time: "
                            + json.dumps(num["levels"])
                            + "; resident left-looking against pair "
                            + json.dumps(num["resident_left_vs_pair"]))
                    del left, pair
                log(f"ooc {label}: resident pair {json.dumps(resident)}, "
                    f"pools max|streamed - resident| / max|resident| {errs}"
                    f", entries above 1e-5 max|resident| {over} ({held})")
                if not ok:
                    raise AssertionError(f"{label}: the streamed pools "
                                         "differ from the resident ones")
                if resident["residual"] > TOL_RES or abs(
                        num["host_steps"] - resident["iters"]) > 2:
                    raise AssertionError(
                        f"{label}: {num['host_steps']} streamed refinement "
                        f"steps against the resident {resident['iters']}")
                num["seconds"] = time.perf_counter() - t_run
                runs[label] = num
                del r, s
        shutil.rmtree(io_root, ignore_errors=True)
        # (a') auto-streaming: without ooc, a pool above the card's free
        # memory (patched to a third of it) streams under 0.8 of it, with
        # no device refinement loop; the peaks stay within that memory
        gc.collect()
        t_run = time.perf_counter()
        A = poisson_3d(auto_nx)
        label = f"LLT bf16 poisson_3d({auto_nx}) auto-streamed"
        cfg = PastixConfig(tile_size=128, update_dtype="bfloat16")
        p = Pastix(A, cfg, device=dev)
        p.order()
        p.symbfact()
        free_mb = max(1, p._build_layout(False).npool * 128 ** 2 * 4
                      // 3 // 2 ** 20)
        del p
        real_free = Pastix._free_device_bytes
        Pastix._free_device_bytes = lambda self: free_mb << 20
        try:
            s, num = streamed_run(label, A, cfg, dev, ("K3",), rest, free_mb)
        finally:
            Pastix._free_device_bytes = real_free
        if s.config.ooc or s._refine_fn is not None or num["segments"] < 3:
            raise AssertionError(f"{label}: not auto-streamed, fewer than 3 "
                                 "segments, or a device refinement loop")
        num["seconds"] = time.perf_counter() - t_run
        runs[label] = num
        del s
        # (b) full width: the flagship LLᵗ streamed under big_mb
        gc.collect()
        t_run = time.perf_counter()
        label = f"LLT bf16 poisson_3d({big_nx})"
        cfg = PastixConfig(tile_size=128, update_dtype="bfloat16", ooc=True,
                           ooc_limit_mb=big_mb)
        s, num = streamed_run(label, poisson_3d(big_nx), cfg, dev, ("K3",),
                              rest, big_mb)
        num["seconds"] = time.perf_counter() - t_run
        log(f"ooc {label}: {num['seconds']:.1f} s in all")
        runs[label] = num
        del s
        # (c) offload: Schur unknowns cannot stream, so with a limit below
        # the pool the resident factors leave the card; solve_with_schur
        # restores them for K2
        gc.collect()
        A = poisson_3d(24)
        label = "LLT bf16 poisson_3d(24) Schur, offloaded"
        cfg = PastixConfig(tile_size=128, update_dtype="bfloat16", ooc=True,
                           ooc_limit_mb=1)
        reset_counts()
        s, _ = analyzed(A, cfg, dev, schur=last_plane(24))
        base = torch.cuda.memory_allocated(dev)
        s.factorize()
        fl = read_counts(f"{label}: factorize", ("K1",), ("K2",))
        held = torch.cuda.memory_allocated(dev) - base
        pool_b = s.factors.pool.numel() * 4
        if not s.factors.offloaded or s.factors.pool.device.type != "cpu":
            raise AssertionError(f"{label}: the factors stayed on the card")
        reset_counts()
        M = A.to_scipy()
        b = M @ np.ones(A.n)
        x = s.solve_with_schur(b)
        sl = read_counts(f"{label}: solve_with_schur", ("K2",), ("K1",))
        res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
        runs[label] = num = {
            "pool_mib": pool_b / 2 ** 20,
            "held_after_factorize_mib": held / 2 ** 20,
            "launches_fact": {k: v for k, v in fl.items() if v},
            "launches_solve": {k: v for k, v in sl.items() if v},
            "residual": res, "iters": s.report.refine_iters}
        log(f"ooc {label}: " + json.dumps(num))
        if held >= pool_b or not res <= TOL_RES:
            raise AssertionError(f"{label}: the pool stayed on the card or "
                                 f"the residual {res:.3e} is above {TOL_RES}")
        del s
    finally:
        shutil.rmtree(io_root, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    runs["seconds"] = seconds
    log(f"phase 19: {seconds:.1f} s")
    return runs


def top_device_ops(prof, n=10):
    """The ``n`` device operations with the most total time in a
    ``torch.profiler`` profile: (name, calls, ms, share of the device
    total), and the device total in ms."""
    from torch.autograd import DeviceType

    rows = sorted(((e.key, e.count, e.device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[2])
    total = sum(r[2] for r in rows)
    return [(k, c, ms, ms / total if total else 0.0)
            for k, c, ms in rows[:n]], total


def matmul_callers(prof):
    """The matrix products of a ``torch.profiler`` profile recorded with
    shapes, by the device time of their kernels: per op (``diag_trsm``'s
    panel TRSM is the ``bmm`` of T x T tiles, the dense tail's blocked
    factor and solve are ``mm``/``addmm`` of its m rows) the calls, ms,
    the count of distinct shapes and the shapes of its costliest one."""
    ops = ("aten::mm", "aten::bmm", "aten::addmm", "aten::addmm_",
           "aten::baddbmm", "aten::matmul")
    by = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key not in ops or (e.key == "aten::matmul"
                                and e.self_device_time_total == 0):
            continue
        ms = e.device_time_total / 1e3
        r = by.setdefault(e.key, [0, 0.0, 0, "", -1.0])
        r[0] += e.count
        r[1] += ms
        r[2] += 1
        if ms > r[4]:
            r[3], r[4] = str(e.input_shapes), ms
    return sorted(((op, c, ms, k, sh) for op, (c, ms, k, sh, _)
                   in by.items()), key=lambda r: -r[2])


# the main path's kernels by their names in a device profile
PROFILE_KERNELS = (("K1", "seg_mma_kernel"), ("K2", "sweep_kernel"))


def run_example(name, args, dev):
    """One of the port's examples in this process (``runpy``), its
    standard output captured: (exit code, output)."""
    import contextlib
    import io
    import runpy

    saved = sys.argv
    sys.argv = [name, *args, "--device", str(dev)]
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_module(f"pastix_tpu_torch.examples.{name}",
                             run_name="__main__")
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        sys.argv = saved
    return code, out.getvalue()


def tail_path(nx, dev, paths):
    """Phase 20: (a) the traced main path and its device profile, (b) the
    cost model calibrated on the card against measured ``fact_ms``, (c)
    fp64 Schur, (d) the port's examples.  ``paths`` holds phase 4's, 7's
    and 8's figures (``fact_ms``, ``predicted_ms``).  Returns the
    phase's figures."""
    import shutil
    import tempfile

    import torch

    from pastix_tpu_torch import perf
    from pastix_tpu_torch.config import Factorization, PastixConfig
    from pastix_tpu_torch.examples import CHECKS
    from pastix_tpu_torch.generators import poisson_3d
    from pastix_tpu_torch.pastix import Pastix
    from pastix_tpu_torch.trace import profile_device

    t_phase = time.perf_counter()
    out = {}
    tmp = tempfile.mkdtemp(prefix="pastix_phase20_")
    try:
        # (a) the main path traced: the device loop is the reference's on
        # a TPU only, so off it (device_refine=False) the solve and the
        # host refinement are two spans, as the reference records them
        A = poisson_3d(nx)
        M = A.to_scipy()
        b = M @ np.ones(A.n)
        s = Pastix(A, PastixConfig(tile_size=128, update_dtype="bfloat16",
                                   trace=True, device_refine=False),
                   device=dev)
        reset_counts()
        s.order()
        s.symbfact()
        s.analyze()
        fact = []
        for _ in range(2):
            s.factorize()
            fact.append(s.report.fact_time)
        for _ in range(2):
            x = s.solve(b)
        launches = read_counts("traced main path", ("K1", "K2"))
        res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
        if not max(res, s.report.residual) <= TOL_RES:
            raise AssertionError(f"traced main path: residual {res:.3e}")
        path = os.path.join(tmp, "trace.json")
        s.dump_trace(path)
        spans = [e for e in json.load(open(path))["traceEvents"]
                 if e["ph"] == "X"]
        names = [e["name"] for e in spans]
        log(f"  traced main path poisson_3d({nx}): spans {names}")
        for e in spans:
            log(f"    {e['name']:9s} {e['ts'] / 1e3:10.3f} ms "
                f"+{e['dur'] / 1e3:9.3f} ms")
        want = {"order", "symbfact", "analyze", "numfact", "solve", "refine"}
        if not want <= set(names) or min(e["dur"] for e in spans) < 0:
            raise AssertionError(f"the trace lacks one of {sorted(want)}")
        numfact = [e["dur"] / 1e6 for e in spans if e["name"] == "numfact"]
        for span, ft in zip(numfact, fact):
            if abs(span - ft) > max(1e-3, 0.02 * ft):
                raise AssertionError(f"numfact span {span:.6f} s against "
                                     f"fact_time {ft:.6f} s")
        log(f"  fact_ms traced {fact[1] * 1e3:.1f} (first "
            f"{fact[0] * 1e3:.1f}), untraced (phase 4) "
            f"{paths['LLT']['fact_ms']:.1f}; numfact spans "
            f"{[round(v * 1e3, 3) for v in numfact]} ms")
        with profile_device(os.path.join(tmp, "profile")) as prof:
            s.factorize()
            s.solve(b)
        top, total = top_device_ops(prof)
        log(f"  profile of one factorize + solve: device {total:.3f} ms; "
            "the ten device operations with the most time:")
        for name, calls, ms, share in top:
            log(f"    {ms:9.3f} ms {calls:5d}x {100 * share:5.1f} % "
                f"{name[:110]}")
        keys = [e.key for e in prof.key_averages()]
        for kname, pat in PROFILE_KERNELS:
            if not any(pat in k for k in keys):
                raise AssertionError(f"{kname} ({pat}) is not in the profile")
        # the same calls again, the shapes recorded: the matrix products
        # outside the kernels by caller
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof2:
            s.factorize()
            s.solve(b)
            torch.cuda.synchronize(dev)
        mms = matmul_callers(prof2)
        log("  the matrix products outside the kernels, by shape "
            "(a second profile of the same calls, shapes recorded):")
        for op, calls, ms, k, shapes in mms:
            log(f"    {ms:9.3f} ms {calls:5d}x {op} ({k} shapes; costliest "
                f"{shapes[:100]})")
        del prof2
        out["traced"] = {
            "spans": names, "fact_ms": fact[1] * 1e3,
            "fact_ms_untraced": paths["LLT"]["fact_ms"],
            "numfact_span_ms": [v * 1e3 for v in numfact],
            "device_ms": total, "residual": s.report.residual,
            "launches": {k: v for k, v in launches.items() if v},
            "top": [{"name": n_, "calls": c, "ms": ms, "share": sh}
                    for n_, c, ms, sh in top],
            "matmuls": [{"op": op, "calls": c, "ms": ms, "shapes": k,
                         "costliest": sh} for op, c, ms, k, sh in mms],
        }
        # (b) the cost model: fresh calibrations on the card, at the tile
        # sizes K3 is built for and at 16 (the twin's route), each the
        # one-time cost a first factorize at that size pays
        perf.measure_kernels.cache_clear()
        perf._DISK_CACHE = os.path.join(tmp, "perf", os.path.basename(
            perf._DISK_CACHE))
        cal_s = {}
        for T in (16, 32, 64, 128):
            t0 = time.perf_counter()
            cal = perf.calibrate(T, "float32", force=True, device=dev)
            cal_s[T] = time.perf_counter() - t0
            log(f"  calibrate({T}) on {perf.device_kind(dev)} in "
                f"{cal_s[T]:.2f} s: " + json.dumps(cal))
        pred = {"LLT": perf.predict_fact_time(s.layout, device=dev) * 1e3}
        for kind in ("LU", "LDLT"):  # predicted in their phases
            pred[kind] = paths[kind]["predicted_ms"]
        for kind, label in (("LLT", f"main path poisson_3d({nx})"),
                            ("LU", "LU (phase 7)"),
                            ("LDLT", "shift-invert LDLT (phase 8)")):
            ms = paths[kind]["fact_ms"]
            log(f"  predicted {pred[kind]:.1f} ms, measured fact_ms "
                f"{ms:.1f} ms (ratio {pred[kind] / ms:.3f}): {label}")
        # the per-level estimate (bodies timed at each level's batch) and
        # the roofline of the main path's measured fact_ms (bf16 updates)
        t0 = time.perf_counter()
        est = perf.estimate_fact_time(s.layout, device=dev) * 1e3
        est_s = time.perf_counter() - t0
        sol = perf.speed_of_light(s.layout, paths["LLT"]["fact_ms"] / 1e3,
                                  PEAK_BF16 / 1e9)
        log(f"  main path: estimate_fact_time {est:.1f} ms (in {est_s:.2f}"
            f" s), padded {sol['padded_gflops']:.1f} GFLOP/s, "
            f"{100 * sol['peak_fraction']:.2f} % of the bf16 peak")
        out["cost"] = {"calibration": cal, "calibrate_s": cal_s,
                       "predicted_ms": pred, "estimated_ms": est,
                       "roofline": sol,
                       "fact_ms": {k: paths[k]["fact_ms"] for k in pred}}
        del s, prof
        # (c) fp64 Schur: no hand kernel, no twin
        A24 = poisson_3d(24)
        sch = last_plane(24)
        S_ref = schur_reference(A24, sch)
        M = A24.to_scipy()
        b = M @ np.ones(A24.n)
        out["fp64 schur"] = {}
        for kind in ("LLT", "LDLT", "LU"):
            reset_counts()
            s = Pastix(A24, PastixConfig(
                tile_size=128, compute_dtype="float64",
                factorization=Factorization[kind]), device=dev)
            s.set_schur_unknowns(sch)
            fact = []
            for _ in range(2):
                s.factorize()
                fact.append(s.report.fact_time)
            S = s.get_schur()
            x = s.solve_with_schur(b)
            read_counts(f"fp64 Schur {kind}", (), forbid=tuple(counters()))
            err = float(np.abs(S - S_ref).max() / np.abs(S_ref).max())
            res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
            num = {"fact_ms": fact[1] * 1e3, "fact_ms_first": fact[0] * 1e3,
                   "schur_err": err, "residual": s.report.residual,
                   "residual_original_order": res,
                   "refine_iters": s.report.refine_iters,
                   "solve_ms": s.report.solve_time * 1e3}
            log(f"  fp64 Schur {kind} poisson_3d(24), z = 23: "
                + json.dumps(num))
            if not err <= 1e-10 or not max(res, s.report.residual) <= TOL_RES:
                raise AssertionError(f"fp64 Schur {kind}: S off by {err:.3e} "
                                     f"or residual {res:.3e}")
            out["fp64 schur"][kind] = num
        # (d) the examples, in this process on the card
        out["examples"] = {}
        for name, (args, lines) in CHECKS.items():
            t0 = time.perf_counter()
            code, text = run_example(name, args, dev)
            sec = time.perf_counter() - t0
            last = [ln for ln in text.splitlines() if ln.strip()][-1:]
            log(f"  example {name} {' '.join(args)}: exit {code}, "
                f"{sec:.2f} s: {last[0] if last else ''}")
            if code != 0 or not all(ln in text for ln in lines):
                raise AssertionError(f"example {name} failed:\n{text}")
            out["examples"][name] = sec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    out["seconds"] = seconds
    log(f"phase 20: {seconds:.1f} s")
    return out


TOL_MESH_S = 1e-4  # get_schur on a mesh against the sparse-LU S (fp32)
MESH_SMALL_NX = 24  # phase 21's replicated, Schur and subtree runs
MESH_SHARED_NX = 24  # its owner runs on ranks sharing one card (gloo)


def mesh_matrix(spec):
    """The matrix of a phase 21 run: (SparseMatrix, label)."""
    from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d

    kind, nx = spec
    if kind == "poisson":
        return poisson_3d(nx), f"poisson_3d({nx})"
    if kind == "convdiff":
        return convection_diffusion_3d(nx), f"convection_diffusion_3d({nx})"
    return shift_invert(nx)[0], f"poisson_3d({nx}) - sigma I"


def rank_barrier(dev):
    """Every rank's queued work on ``dev`` done, then all ranks met (an
    all_reduce of one element: NCCL and gloo alike)."""
    import torch
    import torch.distributed as dist

    torch.cuda.synchronize(dev)
    dist.all_reduce(torch.zeros(1, device=dev))
    torch.cuda.synchronize(dev)


def mesh_fn_parts(fn):
    """(diagonal-tile index tensors, K3 plans) of a mesh factorization
    program: the owner path's rank levels, the replicated path's levels,
    the subtree's local and shared levels."""
    diags, plans = [], []
    for r in list(getattr(fn, "levels", [])):
        lv = getattr(r, "lv", r)
        diags.append(lv.diag)
        for name in ("e2", "e2_u", "pairs", "pairs_u"):
            p = getattr(r, name, None)
            if isinstance(p, list) and p:
                plans.append(p)
    for lv, pairs in getattr(fn, "local", []):
        diags.append(lv.diag)
        if isinstance(pairs, list) and pairs:
            plans.append(pairs)
    return diags, plans


def mesh_checked_factorize(s, label):
    """One more factorization of ``s`` with K3 and K4 held against their
    twins (``check_k3``, ``check_k4``: TOL_E2 / TOL_K4, two runs
    bit-identical) on the rank's inputs at its busiest level (the K3 plan
    with most pairs, the K4 call with most tiles), and K3 timed there
    (CUDA events) beside its twin on rank 0 after the factorization, the
    other ranks held at a barrier meanwhile (no other rank's work on a
    shared card).  Returns (k3 max|d|, k4 max|d|, rank 0's K3 (ms,
    plain_ms, bound, pairs)), the K4 error None where no K4 runs."""
    import torch
    import torch.distributed as dist
    from pastix_tpu_torch.numeric import factorize as F
    from pastix_tpu_torch.numeric import pipelined as PL
    from pastix_tpu_torch.parallel import owner as O
    from pastix_tpu_torch.parallel import subtree as ST

    diags, plans = mesh_fn_parts(s._fact_fn)
    busiest = max(plans, key=lambda p: sum(c.n_pairs for c in p), default=None)
    k4_n = max((int(d.numel()) for d in diags), default=0)
    out = {"k3": 0.0, "k4": None, "k3_in": None, "k3_timed": None}
    # the replicated path reaches K3 through owner.run_pairs
    mods = (O, ST)
    tf = F.tile_factor

    def copy(v):
        if torch.is_tensor(v):
            return v.clone()
        return tuple(copy(x) for x in v) if isinstance(v, tuple) else v

    def k3(pool, plan, update_dtype=None, **kw):
        if plan is busiest and out["k3_in"] is None:
            out["k3"] = check_k3(pool, plan, update_dtype,
                                 f"{label} busiest level", quiet=True, **kw)
            out["k3_in"] = (pool.clone(), update_dtype,
                            {k: copy(v) for k, v in kw.items()})
        return PL.gemm_scatter_pipelined(pool, plan, update_dtype, **kw)


    def k4(pool, diag, eps, npiv, lu):
        if diag.numel() == k4_n and out["k4"] is None and k4_n:
            out["k4"] = check_k4(pool[diag].contiguous(), eps, lu,
                                 f"{label} busiest level", quiet=True)
        return tf(pool, diag, eps, npiv, lu)

    try:
        for m in mods:
            m.gemm_scatter_pipelined = k3
        F.tile_factor = k4
        s.factorize()
    finally:
        for m in mods:
            m.gemm_scatter_pipelined = PL.gemm_scatter_pipelined
        F.tile_factor = tf
    rank_barrier(s.device)
    if dist.get_rank() == 0 and out["k3_in"] is not None:
        scratch, update_dtype, kw = out["k3_in"]
        ms = cuda_ms(lambda: PL.gemm_scatter_pipelined(
            scratch, busiest, update_dtype, **kw))
        plain = cuda_ms(lambda: PL.gemm_scatter_pipelined_ref(
            scratch, busiest, update_dtype, **kw))
        T = scratch.shape[-1]
        xa = kw.get("xab")
        pos = set()
        for c in busiest:
            pos.update(c.ext_a.tolist() if xa is not None
                       else c.pair_a.tolist())
            pos.update(c.ext_b.tolist() if xa is not None
                       else c.pair_b.tolist())
        dsts = {int(x) for c in busiest for x in c.seg_dst.tolist()}
        flops = sum(k3_flops(c, T) for c in busiest)
        nbytes = (len(pos) + 2 * len(dsts)) * T * T * 4
        peak = PEAK_BF16 if update_dtype == torch.bfloat16 else PEAK_FP32
        out["k3_timed"] = (ms, plain, bound(flops, peak, nbytes),
                           sum(c.n_pairs for c in busiest))
    out["k3_in"] = None
    rank_barrier(s.device)
    return out["k3"], out["k4"], out["k3_timed"]


def one_card(s, e2, dtype=None, runs=2):
    """The one-card factorization of ``s``'s own layout (the same host
    analysis) by ``numeric.factorize`` with schedule ``e2``, in ``dtype``
    (fp32 with ``s``'s update dtype; fp64 with none), timed on its last
    of ``runs``: (Factors, ms)."""
    import torch
    from pastix_tpu_torch.config import Factorization
    from pastix_tpu_torch.numeric.factorize import (
        build_coefinit_fn, build_factorize_fn, factorize,
    )
    from pastix_tpu_torch.pastix import _UPDATE_DTYPES

    lay, dev, kind = s.layout, s.device, s._kind
    dtype = dtype or torch.float32
    upd = (_UPDATE_DTYPES[s.config.update_dtype] if dtype == torch.float32
           else None)
    coef = build_coefinit_fn(lay, s._A_perm, dev,
                             for_lu=kind == Factorization.LU, dtype=dtype)
    fn = build_factorize_fn(lay, dev, kind, update_dtype=upd,
                            dense_tail=s._dense_tail, e2=e2, dtype=dtype)
    for _ in range(runs):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        f = factorize(lay, s._A_perm, coef, fn, dev,
                      pivot_threshold=s.config.static_pivoting_threshold)
        torch.cuda.synchronize(dev)
    return f, (time.perf_counter() - t0) * 1e3


def mesh_pool_levels(s, pair, exact):
    """The mesh's pools and one card's against ``exact``, one card's
    fp64 factorization of the same analysis, a level at a time (the
    tiles of each level's block columns; LDLᵗ's pivots of its columns):
    max|mesh - exact| and max|pair - exact|, ``pair`` one card's fp32
    factorization in the same right-looking order and update dtype, over
    the rank's tiles (the owner path's own slots, the replicated pools
    whole), and max|exact|: this rank's (2 * levels + 1) maxima."""
    import torch

    lay = s.layout
    nl = len(lay.levels)
    lev = np.zeros(lay.nbc, np.int64)
    for i, lv in enumerate(lay.levels):
        lev[np.asarray(lv.cols)] = i
    tile_lev = lev[np.asarray(lay.blk_col)]
    sh = s._pool_sharding
    mine = None if sh is None else sh.mine(s._tp.me)
    vals = np.zeros(2 * nl + 1)
    for name in ("pool", "pool_u", "d"):
        got = getattr(s.factors, name)
        if got is None:
            continue
        ref, fp64 = getattr(pair, name), getattr(exact, name)
        at = lev if name == "d" else tile_lev
        rows = np.arange(at.size) if mine is None or name == "d" else mine
        for lo in range(0, rows.size, 4096):  # fp64 differences in chunks
            part = rows[lo:lo + 4096]
            idx = torch.as_tensor(part, device=s.device)
            g = got[lo:lo + part.size] if rows is mine else got[idx]
            x = fp64[idx]
            dims = tuple(range(1, x.dim()))
            np.maximum.at(vals[:nl], at[part], (
                g.double() - x).abs().amax(dim=dims).cpu().numpy())
            np.maximum.at(vals[nl:-1], at[part], (
                ref[idx].double() - x).abs().amax(dim=dims).cpu().numpy())
            vals[-1] = max(vals[-1], float(x.abs().max()))
    return vals


def mesh_pool_verdict(s, vals):
    """The mesh's pools as accurate as one card's: the rank maxima of
    :func:`mesh_pool_levels` reduced over the process group, each
    level's max|mesh - exact| held to TOL_E2 or TOL_ORDER times its
    max|pair - exact|, both relative to max|exact|.  Returns the
    figures, ``ok`` among them."""
    import torch
    import torch.distributed as dist

    nl = len(s.layout.levels)
    red = torch.as_tensor(vals, device=s.device)
    dist.all_reduce(red, op=dist.ReduceOp.MAX)
    vals = red.cpu().numpy()
    err, one = vals[:nl] / vals[-1], vals[nl:-1] / vals[-1]
    tol = np.maximum(TOL_E2, TOL_ORDER * one)
    w = int(np.argmax(err / tol))
    return {"mesh_err": float(err.max()), "one_card_err": float(one.max()),
            "levels": nl, "held_to_tol_e2": int((tol == TOL_E2).sum()),
            "worst": w, "worst_err": float(err[w]),
            "worst_tol": float(tol[w]), "ok": bool((err <= tol).all())}


def mesh_run(spec):
    """One phase 21 run in a rank: analyze, factorize twice (the second
    timed, the counts set to 0 just before it and read after the solve),
    a refined solve of b = A.1 (Schur: ``get_schur`` against the
    sparse-LU S and ``solve_with_schur``), then the pools against one
    card's (``spec["compare"]``) and K3/K4 against their twins
    (``spec["check"]``)."""
    import torch
    import torch.distributed as dist
    from pastix_tpu_torch import Pastix
    from pastix_tpu_torch.config import Factorization, PastixConfig
    from pastix_tpu_torch.parallel.owner import distribution_report

    A, mlabel = mesh_matrix(spec["matrix"])
    cfg = PastixConfig(**spec["cfg"])
    label = f"{spec['label']} {mlabel}"
    t_run = time.perf_counter()

    def note(what):  # rank 0's progress, as it happens
        if dist.get_rank() == 0:
            log(f"    [rank 0, {time.perf_counter() - t_run:.1f} s] "
                f"{label}: {what}")

    s = Pastix(A, cfg)
    dev = s.device
    torch.cuda.reset_peak_memory_stats(dev)
    schur = last_plane(spec["matrix"][1]) if spec.get("schur") else None
    if schur is not None:
        s.set_schur_unknowns(schur)
    t0 = time.perf_counter()
    s.analyze()
    analyze_s = time.perf_counter() - t0
    note("analyzed")
    s.factorize()
    reset_counts()
    s.factorize()
    fact_ms = s.report.fact_time * 1e3
    note(f"factorized twice ({fact_ms:.1f} ms)")
    M = A.to_scipy()
    b = M @ np.ones(A.n)
    s_err = None
    if schur is not None:
        S = s.get_schur()
        if dist.get_rank() == 0:  # the host's sparse LU, once
            S_ref = schur_reference(A, schur)
            s_err = float(np.abs(S - S_ref).max() / np.abs(S_ref).max())
        x = s.solve_with_schur(b)
    else:
        x = s.solve(b)
    torch.cuda.synchronize(dev)
    launches = {k: fn.launches for k, fn in counters().items()}
    twins = {k: fn.twin_launches for k, fn in counters().items()}
    res = float(np.linalg.norm(b - M @ x) / np.linalg.norm(b))
    note(f"solved ({s.report.refine_iters} steps, residual {res:.3e})")
    out = {
        "label": label, "rank": dist.get_rank(), "device": str(dev),
        "fact_ms": fact_ms, "analyze_s": analyze_s,
        "solve_ms": s.report.solve_time * 1e3,
        "refine_iters": s.report.refine_iters,
        "residual": max(res, s.report.residual or 0.0),
        "static_pivots": s.report.static_pivots,
        "npool": s.layout.npool, "schur_err": s_err,
        "launches": {k: v for k, v in launches.items() if v},
        "twins": sum(twins.values()),
        "route": ("owner" if s._pool_sharding is not None else
                  "subtree" if hasattr(s._fact_fn, "local") else
                  "replicated"),
        "device_refine": s._sharded_refine_fn is not None,
    }
    sh = s._pool_sharding
    if sh is not None:
        out["nloc"] = sh.nloc
        rep = distribution_report(s.layout, sh, dense_tail=s._dense_tail
                                  if s._kind == Factorization.LLT else None)
        out["flop_imbalance"] = rep["flop_imbalance"]
        out["halo_mib"] = float(rep["halo_bytes"].sum() / 2 ** 20)
        out["memory_bytes"] = s.report.memory_bytes
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if spec.get("compare"):
        # ranks sharing a card take turns: one card's three
        # factorizations of a full-size matrix on every rank at once
        # would not fit, and each times its own alone
        nr = dist.get_world_size()
        turns = nr if nr > torch.cuda.device_count() else 1
        for t in range(turns):
            if turns == 1 or t == dist.get_rank():
                left, out["one_card_ms"] = one_card(s, "left")
                del left
                pair, _ = one_card(s, "pair", runs=1)
                exact, _ = one_card(s, None, torch.float64, runs=1)
                vals = mesh_pool_levels(s, pair, exact)
                del pair, exact
                torch.cuda.empty_cache()
            if turns > 1:
                rank_barrier(dev)
        out["pools"] = mesh_pool_verdict(s, vals)
        note("pools against one card's fp64: " + json.dumps(out["pools"]))
    if spec.get("check"):
        out["k3_err"], out["k4_err"], out["k3_timed"] = (
            mesh_checked_factorize(s, label))
        note("K3/K4 checked")
    del s
    torch.cuda.empty_cache()
    return out


def mesh_rank(rank, runs):
    """The body of each phase 21 rank: the process pins true fp32 as the
    parent does, then runs ``runs`` in order (every rank the same)."""
    import torch

    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    return [mesh_run(spec) for spec in runs]


def mesh_runs(nx, lu_nx, ldlt_nx, small_nx, shape, full):
    """The runs of one phase 21 mode on a mesh of ``shape``: with
    ``full`` the owner-computes main path (LLᵗ poisson_3d(nx), T=128,
    bf16 updates), LU on convection_diffusion_3d(lu_nx) and LDLᵗ on phase
    8's matrix (at ``ldlt_nx``) with fp32 updates; then, at
    ``small_nx``, the replicated pool (``shard_pool=False``, the device
    loop), Schur unknowns (the plane z = small_nx - 1) and the subtree
    schedule."""
    base = dict(tile_size=128, mesh_shape=shape,
                mesh_axis_names=("dp", "tp")[2 - len(shape):])
    bf = dict(base, update_dtype="bfloat16")
    runs = []
    if full:
        runs += [
            {"label": "owner LLT", "matrix": ("poisson", nx), "cfg": bf,
             "need": ("K3",), "compare": True, "check": True},
            {"label": "owner LU", "matrix": ("convdiff", lu_nx),
             "cfg": dict(bf, factorization="LU"), "need": ("K3", "K4"),
             "compare": True, "check": True},
            {"label": "owner LDLT fp32", "matrix": ("shift", ldlt_nx),
             "cfg": dict(base, factorization="LDLT"), "need": ("K3", "K4"),
             "compare": True, "check": True},
        ]
    runs += [
        {"label": "replicated LLT", "matrix": ("poisson", small_nx),
         "cfg": dict(bf, shard_pool=False), "need": ("K3", "K2"),
         "compare": True, "check": True},
        {"label": "Schur LLT", "matrix": ("poisson", small_nx),
         "cfg": dict(base), "need": ("K3",), "schur": True},
        {"label": "subtree LLT", "matrix": ("poisson", small_nx),
         "cfg": dict(base, dist_strategy="subtree"), "need": ("K3",),
         "compare": True, "check": True},
    ]
    for r in runs:
        if "factorization" in r["cfg"]:
            from pastix_tpu_torch.config import Factorization

            r["cfg"]["factorization"] = Factorization[
                r["cfg"]["factorization"]]
    return runs


def mesh_path(nx, lu_nx, ldlt_nx, small_nx, shared_nx, errs, main_ms):
    """Phase 21: the mesh paths (``pastix_tpu_torch/parallel``) on ranks
    started by ``parallel.launch.run_ranks``.  With two or more cards:
    NCCL, one rank a card for up to 4 (and a (2, 2) mesh with 4); with
    one: 4 ranks sharing it under gloo (its owner runs at ``shared_nx``:
    gloo carries every collective through host memory), then 1 rank
    under NCCL (at the full sizes; a group of one runs every collective).
    Every
    run must reach TOL_RES on every rank, launch the kernels it needs on
    every rank (counts set to 0 before its timed factorization and read
    after its solve) and run no twin; the pools are as accurate as one
    card's a level at a time (:func:`mesh_pool_verdict`); K3 and K4 hold
    against their twins on each rank's busiest level.
    Returns the rows for the kernels line, the phase's figures and its
    seconds."""
    import torch

    from pastix_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    modes = []
    full = (nx, lu_nx, ldlt_nx)
    if cards >= 2:
        nr = min(cards, 4)
        modes.append((f"NCCL, {nr} ranks, one a card", "nccl",
                      list(range(nr)), (nr,), full))
        if nr == 4:
            modes.append(("NCCL, (2, 2) dp x tp mesh", "nccl",
                          list(range(4)), (2, 2), None))
    else:
        modes.append(("gloo, 4 ranks sharing one card", "gloo", [0] * 4,
                      (4,), (shared_nx, shared_nx, shared_nx)))
        modes.append(("NCCL, 1 rank", "nccl", [0], (1,), full))
    figures, rows = {}, {}
    for mode, backend, devices, shape, sizes in modes:
        t0 = time.perf_counter()
        runs = mesh_runs(*(sizes or full), small_nx, shape, bool(sizes))
        log(f"phase 21 mode: {mode}, mesh {shape}, "
            f"{len(runs)} runs")
        out = run_ranks(mesh_rank, len(devices), backend, devices,
                        args=(runs,), timeout=900)
        for i, spec in enumerate(runs):
            per = [o[i] for o in out]
            label = per[0]["label"]
            for r in per:
                log(f"  {label} rank {r['rank']} ({r['device']}): "
                    + json.dumps({k: v for k, v in r.items()
                                  if k not in ("label", "rank", "device")}))
                if not r["residual"] <= TOL_RES:
                    raise AssertionError(f"{label} rank {r['rank']}: "
                                         f"residual {r['residual']:.3e}")
                if any(not r["launches"].get(k) for k in spec["need"]) or \
                        r["twins"]:
                    raise AssertionError(
                        f"{label} rank {r['rank']}: launches "
                        f"{r['launches']}, twins {r['twins']}; needs "
                        f"{spec['need']}")
                if spec.get("schur") and r["rank"] == 0 and not (
                        r["schur_err"] <= TOL_MESH_S):
                    raise AssertionError(f"{label}: get_schur off by "
                                         f"{r['schur_err']:.3e}")
                if spec.get("compare") and not r["pools"]["ok"]:
                    raise AssertionError(
                        f"{label}: the pools differ from one card's: "
                        + json.dumps(r["pools"]))
                if spec.get("check"):
                    errs["K3xab"] = max(errs["K3xab"], r["k3_err"])
                    if r["k4_err"] is not None:
                        k4key = ("K4lu" if spec["cfg"].get("factorization")
                                 and spec["cfg"]["factorization"].name == "LU"
                                 else "K4ldlt")
                        errs[k4key] = max(errs[k4key], r["k4_err"])
            figures[f"{mode}: {label}"] = {
                "fact_ms": [r["fact_ms"] for r in per],
                "one_card_ms": per[0].get("one_card_ms"),
                "nloc": per[0].get("nloc"), "npool": per[0]["npool"],
                "peak_gib": [r["peak_gib"] for r in per],
                "flop_imbalance": per[0].get("flop_imbalance"),
                "halo_mib": per[0].get("halo_mib"),
                "launches": [r["launches"] for r in per],
                "residual": per[0]["residual"],
                "pools": per[0].get("pools"),
                "k3_err": max((r.get("k3_err") or 0.0) for r in per),
                "k4_err": max((r.get("k4_err") or 0.0) for r in per),
            }
            if spec.get("check") and label.startswith("owner LLT"):
                rows[f"{backend} x{len(devices)}"] = (
                    per[0]["launches"]["K3"], max(r["k3_err"] for r in per),
                    per[0]["k3_timed"])
        log(f"  mode {mode}: {time.perf_counter() - t0:.1f} s")
    for key, f in figures.items():
        if f["one_card_ms"]:
            log(f"  {key}: fact_ms {min(f['fact_ms']):.1f}-"
                f"{max(f['fact_ms']):.1f} against one card "
                f"{f['one_card_ms']:.1f} (phase 4: {main_ms:.1f}), nloc "
                f"{f['nloc']} of npool {f['npool']}, peak "
                f"{max(f['peak_gib']):.3f} GiB")
    seconds = time.perf_counter() - t_phase
    log(f"phase 21: {seconds:.1f} s")
    return rows, figures, seconds


def sass_count(build, kernel, ops, also=None):
    """How many of each SASS opcode of ``ops`` the library's ``kernel``
    functions hold (``cuobjdump -sass``, run once a library; ``also``:
    only those whose name holds one of these strings too), and how many
    functions that is, or why it cannot say."""
    import shutil
    import subprocess

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = os.path.join(build._OUT, f"libpastix_kernels_{build._digest()}.so")
    if not os.path.isfile(tool):
        return "cuobjdump not found"
    if lib not in _SASS:
        _SASS[lib] = subprocess.run([tool, "-sass", lib], capture_output=True,
                                    text=True, timeout=300).stdout
    sass = _SASS[lib]
    counts, inside = dict.fromkeys(ops + ("functions",), 0), False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line and (
                also is None or any(s in line for s in also))
            counts["functions"] += inside
        elif inside:
            for op in ops:
                counts[op] += f" {op}." in line or f" {op} " in line
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=64,
                    help="main path: poisson_3d(nx) (default 64)")
    ap.add_argument("--schur-nx", type=int, default=64,
                    help="Schur paths: poisson_3d(nx) (LLT), "
                         "convection_diffusion_3d(nx) (LU) and "
                         "poisson_3d(nx) - sigma I (LDLT), Schur = the "
                         "plane z = nx-1 (default 64)")
    ap.add_argument("--lu-nx", type=int, default=70,
                    help="LU path: convection_diffusion_3d(nx) (default 70, "
                         "n = 343,000)")
    ap.add_argument("--ldlt-nx", type=int, default=64,
                    help="LDLT path: poisson_3d(nx) - sigma I (default 64)")
    ap.add_argument("--ooc-nx", type=int, default=100,
                    help="out-of-core at full width: poisson_3d(nx) "
                         "streamed (default 100, n = 1,000,000)")
    ap.add_argument("--ooc-mb", type=int, default=4096,
                    help="its ooc_limit_mb (default 4096)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    from pastix_tpu_torch import _build, native
    from pastix_tpu_torch._device import card_name_power
    from pastix_tpu_torch.config import Factorization, PastixConfig
    from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d
    from pastix_tpu_torch.numeric import leftlook as LL
    from pastix_tpu_torch.numeric import pipelined as PL

    # 1. device
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # true fp32 for the whole process, as the port's phases pin it
    # (_device.pin_precision): the script also runs kernels and twins
    # outside those phases
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_power().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t_start = time.perf_counter()

    def elapsed(what):
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")

    # 2. build
    t0 = time.perf_counter()
    _build.get_lib()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc, {len(_build._SOURCES)} sources in parallel + link: "
        f"{_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if ("registers" in line or "spill" in line or "entry function"
                in line or line.startswith("---")):
            log(f"  ptxas: {line.strip()}")
    # K5 and K9 run K3's kernel with fp32 operands (the pools): its
    # instantiations with A_F32 and B_F32 set (mangled, or demangled);
    # K10's scaled bf16 updates those with A_F32 set and B_F32 not (after
    # BN); K6 K1's windowed ones with A_F32 and B_F32 set (after BN)
    bns = (32, 64, 128)
    mixed = tuple(f"Li{bn}ELb1ELb0E" for bn in bns) + tuple(
        f"{bn}, true, false" for bn in bns)
    both = tuple(f"Li{bn}ELb1ELb1E" for bn in bns) + tuple(
        f"{bn}, true, true" for bn in bns)
    for kname, src, also in (
            ("K1", "ll_gemm_scatter", None),
            ("K3", "pipelined_gemm_scatter", None),
            ("K5, K9", "pipelined_gemm_scatter", ("Lb1ELb1E", "true, true")),
            ("K6", "ll_gemm_scatter", both),
            ("K10 d", "pipelined_gemm_scatter", mixed),
            ("K12", "cache_gemm_scatter", None)):
        counts = sass_count(_build, src, ("HMMA", "HGMMA"), also)
        log(f"{kname} SASS: {counts}")
        if isinstance(counts, dict) and not counts["HMMA"]:
            raise AssertionError(f"{kname}: no HMMA in its SASS")
    # the first designs of K6 and K9 are gone from the library
    for gone in ("slab_gemm_scatter", "segment_gemm_scatter"):
        counts = sass_count(_build, gone, ("HMMA",))
        if isinstance(counts, dict) and counts["functions"]:
            raise AssertionError(f"the library still holds {gone}")
    t0 = time.perf_counter()
    native.get_lib()
    log(f"native host library: {native.status} "
        f"({time.perf_counter() - t0:.2f} s)")
    bf16, fp32 = torch.bfloat16, torch.float32

    # 3. kernels against their twins on poisson_3d(24) layouts
    ks, _ = analyzed(poisson_3d(24),
                     PastixConfig(tile_size=128, update_dtype="bfloat16"), dev)
    ks.factorize()
    lv = busiest_level(ks._fact_fn)
    errs = {k: 0.0 for k in ("K1", "K1d", "K1x", "K2", "K2lu", "K3", "K3d",
                             "K3x", "K4lu", "K4ldlt", "K3xab", "K3compact",
                             "K3pack", "K5", "K6", "K7", "K8", "K9", "K10",
                             "K11", "K12", "K13")}
    for chunks, where in ((lv.ll, "busiest level"), (ks._fact_fn.tail, "tail")):
        if not chunks:
            raise AssertionError(f"K1: no {where} chunks at this size")
        modes = sorted({c.mode for c in chunks})
        hs = sorted({c.H for c in chunks})
        for upd, name in ((bf16, "bf16"), (fp32, "fp32")):
            errs["K1"] = max(errs["K1"], check_k1(
                ks.factors.pool, chunks, upd,
                f"{where} {name} modes={modes} H={hs}",
            ))
    for R in (1, 3):
        errs["K2"] = max(errs["K2"], check_k2(ks, R, seed=R))
    del ks

    A24 = poisson_3d(24)
    sch24 = last_plane(24)
    ss, _ = analyzed(A24, PastixConfig(tile_size=128, update_dtype=None), dev,
                     schur=sch24)
    ss.factorize()
    lay = ss.layout
    reduced, _, _ = LL.regroup_left(lay.levels, lay.blk_col, None)
    ga, gb, gd = (np.concatenate([getattr(r, f) for r in reduced])
                  for f in ("gemm_a", "gemm_b", "gemm_d"))
    chunk = max(7, ga.size // 5 + 1)  # about five chunks
    straddle = PL.pipeline_plan(
        PL.build_pipeline_schedule(ga, gb, gd, group=2, chunk=chunk), dev)
    split = sum(int(a.seg_dst[-1]) == int(b.seg_dst[0])
                for a, b in zip(straddle, straddle[1:]))
    if not split:
        raise AssertionError("K3: no dst segment straddles a chunk boundary")
    for chunks, where in ((busiest_residue(ss._fact_fn), "busiest level"),
                          (straddle, f"all residue, chunk={chunk}, "
                                     f"{split} split segments")):
        for upd, name in ((bf16, "bf16"), (fp32, "fp32")):
            errs["K3"] = max(errs["K3"], check_k3(
                ss.factors.pool, chunks, upd, f"Schur {where} {name}"))
    S = ss.get_schur()
    S_ref = schur_reference(A24, sch24)
    s_err = float(np.abs(S - S_ref).max() / np.abs(S_ref).max())
    log(f"get_schur poisson_3d(24) {S.shape} fp32 updates: "
        f"max|S - S_ref|/max|S_ref| = {s_err:.3e}")
    if not s_err <= TOL_S:
        raise AssertionError(f"get_schur off by {s_err:.3e}")
    del ss, straddle

    # 3, slice 2: the LDLᵗ and LU variants on T=128 layouts of size 24
    check_variants(dev, errs, sch24)
    # 3, slices 3 and 4: K3's operand arrays, the E2 harness's variants
    # (K9, K10), K5 and K6 on the same layouts; K7 and K8
    check_rightlook_kernels(dev, errs)
    check_chol_inv_kernels(dev, errs)

    elapsed("phases 1-3")
    # 4.-5. the main path, and its kernels at its shapes
    launches, main_num, k1, k2 = main_path(args.nx, dev, errs)

    elapsed("phases 4-5")
    # 6.-10. the LLᵗ Schur path, the LU and LDLᵗ paths and their Schur
    # paths
    LLT, LU, LDLT = Factorization.LLT, Factorization.LU, Factorization.LDLT
    nxs = args.schur_nx
    schur_runs = {"K3": schur_path(LLT, poisson_3d(nxs), nxs, "bfloat16",
                                   "K3", dev, errs)}
    lu_launches, lu_num, k1x, k2lu, k4lu = lu_path(args.lu_nx, dev, errs)
    ldlt_launches, ldlt_num, k1d, k4ldlt = ldlt_path(args.ldlt_nx, dev, errs)
    schur_runs["K3x"] = schur_path(LU, convection_diffusion_3d(nxs), nxs,
                                   "bfloat16", "K3x", dev, errs)
    schur_runs["K3d"] = schur_path(LDLT, shift_invert(nxs)[0], nxs, None,
                                   "K3d", dev, errs)

    elapsed("phases 6-10")
    # 11. the right-looking E2 schedules (PASTIX_E2_LL=0), bf16 updates:
    # LDLᵗ on the unshifted Laplacian (bf16 diverges on the shifted one)
    rl = {
        "LLT": rightlook_path(
            f"LLT right-looking poisson_3d({args.nx})", poisson_3d(args.nx),
            LLT, ("stream", "block", "slab", "pair", "pair+compact"), dev,
            errs),
        "LDLT": rightlook_path(
            f"LDLT right-looking poisson_3d({args.nx})",
            poisson_3d(args.nx), LDLT, ("stream", "block", "slab"), dev,
            errs),
        "LU": rightlook_path(
            f"LU right-looking convection_diffusion_3d({args.lu_nx})",
            convection_diffusion_3d(args.lu_nx), LU, ("stream",), dev, errs),
    }

    elapsed("phase 11")
    # 12. the fused-diagonal LLᵗ path (PASTIX_FUSED_DIAG=1)
    fused, fsolver, k7, k8 = fused_path(
        args.nx, dev, errs, main_num["fact_ms"],
        rl["LLT"]["stream"][1]["fact_ms"])
    k8_one = k8_tiles(dev, errs)

    elapsed("phase 12")
    # 13. the E2 A/B harness (exp_pipe.py); the counts are those of each
    # case's timed runs
    ab = ab_harness(fsolver, dev, errs)
    if min(v[3] for v in ab.values()) == 0:
        raise AssertionError("the E2 harness did not launch every variant")

    # 14. the operand-cache harness (exp_cache.py, exp_mp.py) on the same
    # level; 15. the copy probe (exp_dma.py).  The counts are those of
    # each case's timed runs
    cache = cache_harness(fsolver, dev, errs)
    del fsolver
    elapsed("phases 13-14")
    probes = probe_harness(dev, errs)
    elapsed("phase 15")
    if min(v[3] for v in cache.values()) == 0 or min(
            r[-1] for r in probes) == 0:
        raise AssertionError("phase 14 or 15 did not launch every kernel")

    # 16. the front door and the refinement methods
    front_door_path(args.nx, args.lu_nx, dev, main_num["iters"])
    elapsed("phase 16")

    # 17. complex and fp64 factorizations: torch ops, no hand kernel
    precision = precision_path(args.nx, args.lu_nx, dev)
    elapsed("phase 17")

    # 18. ILU(k) (block on the card, scalar on the host) and the packed E2
    # path beside the left-looking figures of phases 4, 7 and 8
    ilu_packed = ilu_packed_path(
        args.nx, args.lu_nx, args.ldlt_nx, dev,
        {"LLT": main_num, "LU": lu_num, "LDLT": ldlt_num}, errs)
    elapsed("phase 18")

    # 19. out-of-core: the streamed factorization and solve, the offload
    ooc = ooc_path(args.nx, args.lu_nx, args.ldlt_nx, args.ooc_nx,
                   args.ooc_mb, dev)
    elapsed("phase 19")

    # 20. the traced main path and its profile, the cost model, fp64
    # Schur and the examples
    tail = tail_path(args.nx, dev, {"LLT": main_num, "LU": lu_num,
                                    "LDLT": ldlt_num})
    elapsed("phase 20")

    # 21. the mesh paths: ranks of a process group, K3, K4 and K2 on each
    # (the ranks are other processes: this one's cached blocks go back)
    torch.cuda.empty_cache()
    mesh_rows, mesh = mesh_path(args.nx, args.lu_nx, args.ldlt_nx,
                                MESH_SMALL_NX, MESH_SHARED_NX, errs,
                                main_num["fact_ms"])[:2]
    elapsed("phase 21")

    # no single PyTorch call computes a gather-GEMM-scatter over a pair
    # list or a block-sparse triangular sweep: library_ms is null but for
    # K4 LU (lu_factor_ex without pivoting) and K13 (index_select of the
    # same copies)
    # seg: the row runs the tensor-core body seg_mma.cuh from another
    # kernel's source (K5, K6, K9 and K10's bf16 updates, K12)
    def entry(name, src, replaces, launches, err, timed, lib=None,
              seg=False):
        ms, plain, bd = timed[:3]
        body = {"body": "pastix_tpu_torch/csrc/seg_mma.cuh"} if seg else {}
        return {"name": name, "route": "cuda",
                "source": f"pastix_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bd[0], "bound_by": bd[1], "library_ms": lib,
                **body}

    k1_at = "pastix_tpu/numeric/leftlook.py:469"
    k2_at = "pastix_tpu/numeric/sweep_kernels.py:241"
    k3_at = "pastix_tpu/numeric/pallas_kernels.py:666"
    k3 = "pipelined_gemm_scatter"
    kernels = [
        entry("ll_gemm_scatter", "ll_gemm_scatter.cu", k1_at,
              launches["K1"], errs["K1"], k1),
        entry("sweep", "sweep.cu", k2_at, launches["K2"], errs["K2"], k2),
        entry(k3, f"{k3}.cu", k3_at, schur_runs["K3"][0]["K3"], errs["K3"],
              schur_runs["K3"][2]),
        entry("ll_gemm_scatter[d]", "ll_gemm_scatter.cu", k1_at,
              ldlt_launches["K1"], errs["K1d"], k1d),
        entry("ll_gemm_scatter[src_pool]", "ll_gemm_scatter.cu", k1_at,
              lu_launches["K1"], errs["K1x"], k1x),
        entry("sweep[lu]", "sweep.cu", k2_at, lu_launches["K2"],
              errs["K2lu"], k2lu),
        entry(f"{k3}[src_pool]", f"{k3}.cu", k3_at,
              schur_runs["K3x"][0]["K3"], errs["K3x"], schur_runs["K3x"][2]),
        entry(f"{k3}[d]", f"{k3}.cu", k3_at, schur_runs["K3d"][0]["K3"],
              errs["K3d"], schur_runs["K3d"][2]),
        entry("tile_factor[lu]", "tile_factor.cu",
              "pastix_tpu/numeric/kernels.py:258", lu_launches["K4"],
              errs["K4lu"], k4lu, k4lu[3]),
        entry("tile_factor[ldlt]", "tile_factor.cu",
              "pastix_tpu/numeric/kernels.py:186", ldlt_launches["K4"],
              errs["K4ldlt"], k4ldlt),
    ]
    # the right-looking rows: launches from the schedule's run, max|d|
    # the larger of phase 3's and the path level's
    # K5 runs K3's kernel (pipelined_gemm_scatter.cu) on its tensor-core
    # body seg_mma.cuh (bf16) with the pool as both operand arrays
    # K6 runs K1's kernel (ll_gemm_scatter.cu) on the same body, a window
    # height a pair
    k5_at = "pastix_tpu/numeric/block_kernels.py:689"
    k6_at = "pastix_tpu/numeric/slab_kernels.py:588"
    k1 = "ll_gemm_scatter"
    for name, src, at, kind, mode, k3key in (
        (f"{k3}[xab]", k3, k3_at, "LLT", "stream", "K3xab"),
        (f"{k3}[xab,d]", k3, k3_at, "LDLT", "stream", "K3xab"),
        (f"{k3}[xab,src_pool]", k3, k3_at, "LU", "stream", "K3xab"),
        (f"{k3}[compact]", k3, k3_at, "LLT", "pair+compact", "K3compact"),
        ("block_gemm_scatter", k3, k5_at, "LLT", "block", "K5"),
        ("block_gemm_scatter[d]", k3, k5_at, "LDLT", "block", "K5"),
        ("slab_gemm_scatter", k1, k6_at, "LLT", "slab", "K6"),
        ("slab_gemm_scatter[d]", k1, k6_at, "LDLT", "slab", "K6"),
    ):
        launches_m, _, timed = rl[kind][mode]
        kernels.append(entry(name, f"{src}.cu", at,
                             launches_m[RL_KERNEL[mode]],
                             max(errs[k3key], errs[f"{kind} {mode}"]), timed,
                             seg=mode in ("block", "slab")))
    # slice 4: K7 and K8 with launches from the fused left-looking path;
    # K9, K10 and ab_pack from the harness, each row the poisson level's
    # case in bf16, its launches too (the other cases in the log)
    at = "pastix_tpu/numeric/pallas_kernels.py"
    ab_row = lambda label: ab["poisson level", "bfloat16", label]
    kernels += [
        entry("chol_inv_pool", "chol_inv.cu", f"{at}:1021",
              fused["left"][0]["K7"], errs["K7"], k7),
        entry("chol_inv", "chol_inv.cu", f"{at}:902", fused["left"][0]["K8"],
              errs["K8"], k8),
        entry("gemm_scatter_fused", f"{k3}.cu", f"{at}:186",
              ab_row("K9")[3], errs["K9"], ab_row("K9"), seg=True),
        entry("gemm_scatter_blockspec", f"{k3}.cu", f"{at}:806",
              ab_row("K10")[3], errs["K10"], ab_row("K10"), seg=True),
        entry("gemm_scatter_blockspec[fp32]", f"{k3}.cu", f"{at}:806",
              ab["poisson level", "float32", "K10"][3], errs["K10"],
              ab["poisson level", "float32", "K10"]),
        entry(f"{k3}[ab_pack]", f"{k3}.cu", k3_at,
              ab_row("K3 ab_pack G=1")[3], errs["K3pack"],
              ab_row("K3 ab_pack G=1")),
    ]
    # the measurement scripts: K11 from phase 14, K12 at G=4 and 8, K13
    # at S=1, D=2 from phase 15 (the other cases in the log)
    rows, S, D, steps, reps, ctas, piece, ms, plain, bd, lib, n = probes[0]
    kernels.append(entry("vcache_gemm_scatter", f"{k3}.cu",
                         "exp_cache.py:181", cache["K11"][3], errs["K11"],
                         cache["K11"]))
    for G in (4, 8):
        for variant in ("loop", "dot2"):
            case = cache[f"K12 {variant} G={G}"]
            kernels.append(entry(
                f"mp_gemm_scatter[{variant}]" + ("" if G == 4 else f"[G={G}]"),
                "cache_gemm_scatter.cu", "exp_mp.py:267", case[3],
                errs["K12"], case, seg=True))
    kernels.append(entry("dma_probe", "dma_probe.cu", "exp_dma.py:76", n,
                         errs["K13"], (ms, plain, bd), lib))
    for label, (ms, plain, bd, n) in cache.items():
        log(f"cache harness {label}: " + json.dumps(
            {"ms": ms, "plain_ms": plain, "bound_ms": bd[0],
             "bound_by": bd[1], "launches": n}))
    # dma_probe's twin is the closed form (two rows a copy), not copies
    kernels[-1]["plain"] = "closed form: reads two rows a copy, no copies"
    # phase 21: K3 on the owner-computes main path, rank 0 of each mode
    # (launches of its timed factorization and solve; timed on its
    # busiest level's halo and touched buffer, the other ranks held)
    for mode, (n_k3, err, (ms, plain, bd, _)) in mesh_rows.items():
        kernels.append(entry(f"{k3}[xab,mesh,{mode}]", f"{k3}.cu", k3_at,
                             n_k3, err, (ms, plain, bd)))
    for rows, S, D, steps, reps, ctas, piece, ms, plain, bd, lib, n in (
            probes):
        log(f"probe rows={rows} S={S} D={D} steps={steps} reps={reps} "
            f"ctas={ctas or 'one per SM'} piece={piece}: "
            + json.dumps({"ms": ms, "plain_ms": plain, "bound_ms": bd[0],
                          "bound_by": bd[1], "library_ms": lib,
                          "launches": n}))
    for (name, upd, label), (ms, plain, bd, n) in ab.items():
        log(f"harness {name} {upd} {label}: " + json.dumps(
            {"ms": ms, "plain_ms": plain, "bound_ms": bd[0],
             "bound_by": bd[1], "launches": n}))
    for name, num in (("LLT", main_num), ("LLT Schur", schur_runs["K3"][1]),
                      ("LU", lu_num), ("LDLT", ldlt_num),
                      ("LU Schur", schur_runs["K3x"][1]),
                      ("LDLT Schur", schur_runs["K3d"][1])):
        log(f"path {name}: " + json.dumps(num))
    for kind, runs in rl.items():
        for mode, (_, num, _) in runs.items():
            log(f"path {kind} right-looking {mode}: " + json.dumps(num))
    for e2, (_, num) in fused.items():
        log(f"path LLT fused-DIAG {e2}: " + json.dumps(num))
    for label, num in precision.items():
        log(f"path precision {label}: " + json.dumps(num))
    for label, num in ilu_packed.items():
        log(f"path ilu/packed {label}: " + json.dumps(num))
    for label, num in ooc.items():
        log(f"path ooc {label}: " + json.dumps(num))
    log("phase 20: " + json.dumps(tail))
    for label, num in mesh.items():
        log(f"path mesh {label}: " + json.dumps(num))
    for T, (ms, plain, bd, lib, dev_ms, dev_lib) in k8_one.items():
        log(f"K8 one tile T={T}: " + json.dumps(
            {"ms": ms, "plain_ms": plain, "bound_ms": bd[0],
             "bound_by": bd[1], "two_library_calls_ms": lib,
             "device_ms": dev_ms, "two_library_calls_device_ms": dev_lib}))
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
