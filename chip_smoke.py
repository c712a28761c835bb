#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``agglomerationmultigrid1d_tpu_torch``) on
one CUDA card.

    python3 chip_smoke.py

Phases, one line of numbers each:

1. the card: its name, and its name and power limit from ``nvidia-smi``;
2. the CUDA kernels K1-K3 and K5 (with and without the residual), built from
   ``csrc/block_kernels.cu`` into ``build/aggmg_torch_kernels/``, against
   their plain PyTorch versions on the same tensors on the card (to 1e-5 of
   ``max|out|``), and both timed with CUDA events (median of 20 launches after
   a warm-up);
3. the DG-topped path: the 2,097,152-DoF problem (DG p=3 on 524,288
   elements, DG p=1, 12 agglomerated levels, dense coarse solve) solved to
   1e-10 by ``multigrid_mixed`` with float32 V-cycles through K1-K3; the
   launch counts of that solve show it went through every kernel;
4. the float64 reference entry point ``multigrid`` at 16,384 DoF, and the
   mixed solve of the same problem held against it;
5. the Chebyshev path: the same 2,097,152-DoF problem under
   ``chebyshev_hierarchy`` (a power iteration per level), solved to 1e-10 by
   ``multigrid_mixed`` through K5 on every block level;
6. the CG-topped flagship ``poisson_full_hierarchy(n=16384)`` (131,073 DoF;
   CG p = 8, 4, 2, 1, then 13 agglomerated levels): float64 ``multigrid`` and
   ``multigrid_mixed``, each with damped and with Chebyshev smoothing;
7. the 1e8-DoF north star (``examples/xl_north_star.py``): 50,331,648 DG p=1
   elements (100,663,296 DoF), 6 agglomerated levels at 4:1, c_dir = 1000 n,
   built by ``build_xl_problem(..., slim_fine=True, ff_levels=True)`` on the
   card and solved to 1e-8 by ``multigrid_true``, whose fine-level defects go
   through K6 (7 launches per V-cycle); then, on the same build, the guarded
   float-float refinement that hands over to the true cycles
   (``_mixed_loop_ff(..., ffops=)``, ``tools/run_xl_solve.py``'s arguments):
   K6 once per guarded defect and 7 times per true cycle, K5 / K5r in the
   float32 inner cycles, its peak memory at most 1.1x ``multigrid_true``'s;
   both relative residuals recomputed independently in float64 from the
   materialized fine operator.

8. K7, the ghosted multisweep (four forms: damped and Chebyshev, each with
   and without the residual), and the edge pair that the sharded path
   launches in its place, at the local shape of every sharded level of the
   one-rank slice solve, with random non-zero ghosts of the path's width,
   into outputs filled with a sentinel.  K7's two in-place 4-column edge
   strips (``out=``, ``cols=``) are held to the plain version of the whole
   shard.  The edge pair (one launch for both edges, through an
   ``EdgePlan``, its vector ghosts read from the received messages) is held
   to its plain version (1e-5 of ``max|out|``) and to the two strips (0
   expected, limit 1e-6 of ``max|out|``, the difference printed); neither
   may write a column outside the edges; a plan with no neighbour on a side
   (a null message) must equal one with explicit zero ghosts there, exactly;
   the packing kernel must equal its plain version exactly.  At the finest
   level the edge-pair call is timed beside the two strip calls, the packing
   and the launch floor (an empty kernel through the same ctypes route).
   Then the whole-shard ghosted launch (the schedule of ``overlap=False``
   and of shards narrower than two edges) at (4, 1,048,576), (4, 4,194,304)
   and (2, 524,288), and four virtual shards of a (4, 4,194,304) problem,
   each swept by K7 with ghosts cut from its neighbours, stitched and held
   to K2 / K1 / K5 on the whole problem (K7's launches are counted here);
9. the sweep bench of ``bench.py:bench_sweeps`` on the port: K4 (the
   bandwidth yardstick of the multisweep's operand mix) and K8 (one A-form
   sweep) at (4, 4,194,304), and every multisweep-family kernel's share of
   K4's bandwidth and of the 3.35 TB/s data-sheet peak;
10. the element-sharded solve on a one-rank NCCL group: the 2,097,152-DoF
   slice sharded by ``shard_hierarchy`` and solved by ``multigrid_mixed``,
   damped and Chebyshev (the overlapped schedule on every sharded level:
   exactly one edge-pair launch per smoothing and no strip launch),
   and float64 ``multigrid`` on the sharded 16,384-DoF problem, each beside
   the unsharded solve in the same run (equal counts); ``sharded_multisweep``
   timed against K2 at the headline shape;
11. two ranks on the one card over gloo (spawned processes, kernels built
   once here first): the same sharded damped ``multigrid_mixed`` of the
   slice, held to the one-rank result; here each rank has a neighbour, so
   every smoothing also launches the packing kernel and exchanges messages;
12. the CG-topped flagship built by stencil inflation on the card in
   ``bench.py:369-394``'s form (``build_xl_problem``, CG p = 8, 4, 2, 1,
   agglomerated levels down to 512 blocks, c_dir = 1000 n) and solved by the
   guarded float-float refinement ``_mixed_loop_ff`` to 1e-10, damped and
   Chebyshev: at 131,073 DoF held within 2 of the port's own V-cycles on
   the JAX package's inputs on the CPU (16 / 12), with JAX's 12 / 11 on the
   TPU (BENCH_r05.json) printed beside; at 16,777,217 DoF (15 levels) the
   same two solves, then the
   ``ff_levels=True`` build solved by ``multigrid_true`` to 1e-8 and by the
   hand-over (``_mixed_loop_ff(..., ffops=)``, tol 1e-8), damped and
   Chebyshev, each below 1e-8 and below the guarded-only solve's end; every
   residual recomputed in float64 on the card from the float-float band;
13. the ragged DG slice: 500,000 elements (2,000,000 DoF), whose
   agglomerated levels below 15,625 blocks are ragged
   (``RaggedBlockProlong``), solved by float64 ``multigrid`` and by
   ``multigrid_mixed`` damped and Chebyshev to 1e-10 through K1-K3 and K5;
   then sharded by ``shard_hierarchy`` on a one-rank NCCL group
   (``one_rank_family``: the sharded matvecs and transfers against the whole
   ones on random vectors, then float64 ``multigrid`` and damped
   ``multigrid_mixed`` on the shards with the unsharded counts, K1-K3 and
   one edge pair per sharded smoothing);
14. the device coarse chain: a DG p=1 chain at 2,097,152 DoF built on the
   host and cast (strip, float32, ``chebyshev_hierarchy``,
   ``prepare_fast_smoothers``) beside ``build_dg_hierarchy_device`` on the
   same meshes and fine operators: every leaf (operators, block inverses,
   M-form streams, the coarse solver's operator and inverse) to 2e-5 of its
   max, the Chebyshev bounds and coefficient table to 1e-3 relative, equal
   ``multigrid_mixed`` counts, both setups timed;
15. the scattered slice: ``poisson_scattered_hierarchy`` at 1,048,576 DG
   p = 1 elements with ``interleaved_pair_groups`` (10 block-COO levels),
   float64 ``multigrid`` and ``multigrid_mixed`` damped and Chebyshev to
   1e-10, the kernels at the fine level only, one launch per V-cycle; then
   sharded on a one-rank NCCL group as the ragged slice (block-COO levels by
   block rows, their matvecs through the exchange plans);
16. the mixed-switch slice: ``poisson_switch_hierarchy`` at 524,288 DG p = 3
   elements (every level block-pentadiagonal), ``multigrid``,
   ``multigrid_mixed`` and ``multigrid_progressive`` to 1e-10 with no kernel
   launched, then the same three sharded on a one-rank NCCL group as the
   ragged slice (pentadiagonal levels by columns, two halo columns a side);
   then the odd 500,000-element chain (a padded coarse solve) held
   on its residuals, with its distance to the banded direct solve and to an
   extended-precision refined solution printed beside the operator's
   condition estimate;
16b. the rest of the surface: ``models.solve`` on the reference problem
   beside ``multigrid``, ``iterative_smoother_solve`` on a CG p = 2 level
   beside the host's count, a checkpoint round trip of a solution on the
   card, ``utils.device_trace`` around one float32 V-cycle (its kernel
   events and K1/K2 among them), and every ``examples/*_torch.py`` at its
   default size in a subprocess, side by side, each with rc 0.

17. K6s, K6 on one shard, at the north star's fine shape: as one rank
   against K6, as two ranks and as four virtual shards (each shard against
   its plain version, the stitched shards against K6), all bit for bit;
   timed beside K6;
18. the north star built rank by rank (``build_sharded_xl_problem``,
   ``slim_fine=True``) on a one-rank NCCL group: every leaf equal to
   ``build_xl_problem``'s bit for bit, setup seconds and peak memory, three
   outer steps of ``_mixed_loop_ff`` held to the unsharded build's (equal
   counts, history within 1e-5 relative), one K6s launch per float-float
   defect, one edge pair per smoothing of a sharded level;
19. the CG-topped flagship built rank by rank on a one-rank NCCL group: at
   131,073 DoF damped and Chebyshev to 1e-10 with the unsharded phase's
   counts, at 16,777,217 DoF damped held to the unsharded run;
20. ``shard_hierarchy`` on ``poisson_full_hierarchy(n=16384)`` on a one-rank
   NCCL group: float64 ``multigrid`` (12 cycles, x within 1e-12 ||b|| of the
   unsharded x) and damped ``multigrid_mixed`` (the unsharded counts);
21. two ranks on the one card over gloo: the north star built rank by rank
   (each rank its 25,165,824 fine columns and no tensor of the global fine
   width, at most 0.6 of the one-rank peak device memory, the one-rank
   run's counts and history), the 16,777,217-DoF flagship (an odd node
   count: unequal node shards and the shared vertex) held to the one-rank
   run, phase 20's solves held to the unsharded ones, and the ragged,
   mixed-switch and scattered slices of phases 13, 15 and 16, each rank
   building the whole problem, sharding it and dropping the rest
   (``sharded_family``): the sharded operations against the whole ones, the
   unsharded float64 counts, the float32 inner solves within 1 outer step /
   2 inner cycles, each rank at most 0.6 of the one-rank run's peak device
   memory (ragged, mixed switch; the scattered slice's printed); for the
   ragged and mixed-switch slices also ROADMAP G24's probes: (a) the
   one-rank and the two-rank float64 x against the fine operator's banded
   solve refined with extended-precision residuals, (b) float64
   ``multigrid`` with every contraction a fixed-order multiply-and-sum
   (``fixed_order_einsum``), unsharded and on the two ranks, whose x must
   then agree within 1e-12 of max|x|;
22. three ranks on the one card over gloo (spawned): the north star's spec
   with 3:1 first agglomerates at 12,582,912 elements (25,165,824 DoF),
   built whole on the card and solved with NS_LOOP (and further, by the
   hand-over, for a reference x), then built rank by rank
   (``build_sharded_xl_problem``: the fine level sharded, the 4,194,304
   blocks below it whole on every rank, transfer 0 cut because its
   agglomerates straddle the ranks): each rank the whole build's level
   widths and counts, its history within 1e-5, one K6s per float-float
   defect and one edge pair per V-cycle, no leaf of the global fine width,
   its peak device memory printed over the whole build's; the gathered x
   within half the whole build's own error of its x (G24's hold).  The whole
   script's seconds are printed before the JSON lines.

The kernel phase also holds K6 (the float-float stencil defect) and K12 (the
float-float defect of a materialised operator, ``ff_bt_defect``: the north
star's levels 1 and 2, and every other block size, without and with ghost
columns) to their plain versions bit for bit, hi and lo, K12 timed beside
its plain chain against its bytes over 3.35 TB/s, K14 (a true Chebyshev
step's apply, recurrence and float-float update, ``ff_cheb_update``: the
north star's levels 0 and 1 and every other block size, the first, a middle
and the last step) the same way, K13 (the float-float
defect of a CG band, ``ff_cg_defect``: the 16.8M flagship's four CG levels
and p = 3, without and with a halo) the same way, and the three block
contractions K9-K11
(``bd_gemv``, ``bp_prolong_gemv``, ``bp_restrict_gemv``) at the north star's
level-0 and level-1 shapes and the slice's fine shapes, float32 (and float64
at the slice's): each bit for bit against its plain version, timed beside it
and beside the einsum it replaced, against its bytes over 3.35 TB/s.  Phase
7 also solves the north star with the contractions swapped back to the
einsum (``einsum_contractions``), by ``multigrid_true`` and by the
hand-over: the residual histories (the hand-over's every norm) and the
hand-over's x must equal the kernels' to the last bit; and by
``multigrid_true`` with the plain float-float chain in K12's place
(``plain_ff_bt_defect``): its residual history must equal K12's to the last
bit, with K12 launched 7 times a cycle on each of the 5 agglomerated levels;
and by ``multigrid_true`` with the plain Chebyshev chain in K14's place
(``plain_cheb_update``): its residual history must equal K14's to the last
bit, with K14 launched 6 times a cycle on each of the 6 smoothed levels.

Then a JSON line with the kernels' numbers (each kernel's launches from the
path that runs it, counted from zero just before that path), and last a JSON
line with the device.  Any failure raises, and the exit code is non-zero;
without a CUDA device the script exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import multiprocessing as mp
import os
import queue
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

SOURCE = "agglomerationmultigrid1d_tpu_torch/csrc/block_kernels.cu"
PALLAS = "agglomerationmultigrid1d_tpu/ops/pallas/block_kernels.py"
SHARDED = "agglomerationmultigrid1d_tpu/parallel/sharded_kernels.py"  # _gather_ghosts :60, _strip_ghosts :81
# (bs, n): the headline shape of 16,777,216 DoF, the main path's level shapes
# from the finest down to the smallest smoothed level, an awkward size, then
# the fine levels of the scattered slice and the device chain (DG p = 1 at
# 1,048,576 elements) and of the ragged slice (DG p = 3 and p = 1 at 500,000)
SHAPES = [(4, 4194304), (4, 524288), (2, 524288), (2, 131072), (2, 128), (4, 1000),
          (2, 1048576), (4, 500000), (2, 500000)]
TOL = 1e-5  # of max|out|: float32 kernels with FMA against unfused plain torch
SLICE = dict(n=524288, max_p=3, n_dg=2, n_agg=12)
SMALL = dict(n=4096, max_p=3, n_dg=2, n_agg=5)
FLAGSHIP_N = 16384
FLAGSHIP_XL_N = 2097152  # the stencil-built flagship at 16,777,217 DoF
# the JAX package's V-cycles for this solve at 131,073 DoF: (BENCH_r05.json on the TPU, its CPU path with
# use_pallas=False); the count follows the float32 rounding of the inner cycle at c_dir = 1000 n
FLAGSHIP_XL_JAX = {"damped": (12, 16), "chebyshev": (11, 14)}
# the port's V-cycles for it on the JAX package's inputs on the CPU (tests/test_torch_flagship_xl.py): the
# card's solve is held to these within 2
FLAGSHIP_XL_PORT_CPU = {"damped": 16, "chebyshev": 12}
RAGGED_SLICE = dict(n=500000, max_p=3, n_dg=2, n_agg=12)  # 2,000,000 DoF, ragged below 15,625 agglomerates
POW2_SLICE_COUNTS = {"damped": "22 outer / 28 inner", "chebyshev": "14 outer / 18 inner"}
DEVICE_CHAIN_N = 1048576  # DG p=1: 2,097,152 DoF
SCATTERED_N = 1048576  # DG p=1 elements: 2,097,152 DoF; 10 scattered levels down to 1,024 agglomerates
SCATTERED_COARSEST = 1024
SWITCH_N = 524288  # DG p=3 elements: 2,097,152 DoF; DG p=1, agg r=2, 6 x 2:1 down to 4,096 agglomerates
SWITCH_COARSEN = 6
SWITCH_ODD = (500000, 4)  # the same chain down to 15,625 agglomerates: a padded pentadiagonal coarse solve
# the port's counts on the same inputs on the CPU (tools/scattered_switch_counts.py --device cpu, full size): the card's
# solves are held to these within 2; JAX's CPU counts (its --package jax, use_pallas=False) are printed beside
SCATTERED_PORT_CPU = {"multigrid": 16, "damped": (14, 19), "chebyshev": (10, 13)}
SCATTERED_JAX_CPU = "at 65,536 elements: multigrid 16, damped 11 / 20, Chebyshev 9 / 15"
SWITCH_PORT_CPU = {"multigrid": 11, "mixed": (11, 14), "progressive": 11, "odd multigrid": 11}
SWITCH_JAX_CPU = "at 65,536 elements: multigrid 11, mixed 10 / 14, progressive 11"
KERNEL_COUNTERS = ("bt_matvec", "multisweep", "multisweep_residual", "chebyshev_multisweep",
                   "chebyshev_multisweep_residual")  # K3, K2, K1, K5, K5r
SEED = 0
GEMV_COUNTERS = ("bd_gemv", "bp_prolong_gemv", "bp_restrict_gemv")
# the block contractions at the main path's shapes: north-star levels 0 and 1, the slice's two fine levels
# (the first of each list is the kernel table's headline); bd: (bs, n), transfers: (r, bs_f, bs_c, n_c)
GEMV_BD_SHAPES = [(2, 50331648, torch.float32), (2, 12582912, torch.float32), (4, 524288, torch.float32),
                  (2, 524288, torch.float32), (4, 524288, torch.float64), (2, 524288, torch.float64)]
GEMV_BP_SHAPES = [(4, 2, 2, 12582912, torch.float32), (4, 2, 2, 3145728, torch.float32),
                  (1, 4, 2, 524288, torch.float32), (2, 2, 2, 262144, torch.float32),
                  (1, 4, 2, 524288, torch.float64), (2, 2, 2, 262144, torch.float64)]
DAMPED = ("bt_matvec", "multisweep", "multisweep_residual")  # K3, K2, K1: the damped solves' kernels
CHEB_INTERVAL = (0.3, 1.2)  # K5's and K7's coefficients in the kernel phases, k = 3
# the whole-shard form: a shard of the four-shards phase (the path that launches
# it), the headline shape and the slice's bs=2 level
K7_SHAPES = [(4, 1048576), (4, 4194304), (2, 524288)]
# the one-rank sharded slice's sharded levels (all but the coarsest), local
# (bs, n): DG p=3, DG p=1, then 11 agglomerated levels, 4:1 first, then 2:1
SLICE_SHARDED = [(4, 524288), (2, 524288)] + [(2, 131072 >> i) for i in range(11)]
STRIP = 4  # the sharded path's edge strip: s = k + 1 columns for k = 3
GHOST = 9  # its ghost width: min(GHOST_W, n) = 9 columns a side on every sharded slice level
K7_FORMS = {  # label: (ghosted wrapper, its launch counter, the unsharded kernel it extends)
    "K7": ("multisweep", "multisweep_ghost", "K2"),
    "K7r": ("multisweep_residual", "multisweep_residual_ghost", "K1"),
    "K7c": ("chebyshev_multisweep", "chebyshev_multisweep_ghost", "K5"),
    "K7cr": ("chebyshev_multisweep_residual", "chebyshev_multisweep_residual_ghost", "K5r"),
}
# the edge pair's four forms, by the K7 form they take the place of on the
# sharded path: label -> launch counter
EDGE_FORMS = {
    "K7": "edge_pair", "K7r": "edge_pair_residual",
    "K7c": "chebyshev_edge_pair", "K7cr": "chebyshev_edge_pair_residual",
}
EDGE_TOL = 1e-6  # of max|out|: the edge pair against the two strips (the same arithmetic: 0 expected)
PEAK_BPS = 3.35e12  # H100 SXM data sheet: HBM3 bytes/s
PEAK_FLOPS = 67e12  # H100 SXM data sheet: float32 outside the tensor cores
CHILD_TIMEOUT_S = 300  # each spawned rank of the two-rank phase
# the sharded families (ragged, mixed-switch, scattered): the solves run on
# their shards, on one NCCL rank and on two gloo ranks
FAMILY_SOLVERS = {"ragged": ("multigrid", "mixed"), "switch": ("multigrid", "mixed", "progressive"),
                  "scattered": ("multigrid", "mixed")}
FAMILY_PEAK_SHARE = {"ragged": 0.6, "switch": 0.6}  # NS_PEAK_SHARE's bound; the scattered chain's is printed
# K6's (bs, n): the north star's fine level, the JAX test's shape, the width of
# K1-K3's headline, an awkward size
K6_SHAPES = [(2, 50331648), (2, 16384), (4, 4194304), (2, 1000)]
K6_BW = 4  # boundary columns of the stencil, as the setup extracts them
# K12's (bs, n): the north star's levels 1 and 2 (the first is the kernel table's headline), then every
# other block size of SUPPORTED_BLOCK_SIZES at an awkward size
K12_SHAPES = [(2, 12582912), (2, 3145728), (1, 100003), (3, 100003), (4, 100003), (5, 100003), (9, 100003)]
# K14's (bs, n): the north star's levels 0 and 1 (the first is the kernel table's headline), then every other
# block size at an awkward column count
K14_SHAPES = [(2, 50331648), (2, 12582912), (1, 100003), (3, 100003), (4, 100003), (5, 100003), (9, 100003)]
K14_STEPS = ("first", "middle", "last")  # the three forms of a degree-3 smoothing; "middle" heads the table
# K13's (p, n): the 16.8M flagship's CG levels 0-3 (the first is the kernel table's headline), then an
# order without an instance of its own at an awkward size
K13_SHAPES = [(8, 16777217), (4, 8388609), (2, 4194305), (1, 2097153), (3, 100003)]
NORTH_STAR_N = 50331648  # DG p=1 elements: 100,663,296 DoF
# the sharded north star's _mixed_loop_ff: JAX's arguments, cut to 3 outer steps
# (the float-float defect floors near 4e-7 there: the phases hold the sharded
# runs to the unsharded one, not to a tolerance)
NS_LOOP = dict(maxiter=3, tol=1e-8, inner_tol=3e-5, max_inner=20)
# the north star's spec with 3:1 first agglomerates, cut to 12,582,912 elements (25,165,824 DoF) on three gloo
# ranks: the fine level sharded, the 4,194,304 blocks below it whole (3 does not divide them), so transfer 0's
# agglomerates straddle the ranks; at 50,331,648 elements every rank would hold the whole 16.8M-block level
THREE_RANK_N = 12582912
THREE_RANK_FIRST_AGG = 3
THREE_RANK_TIMEOUT_S = 600
# G24's diagnosis: on two ranks the shards' rounding moved the float64 x of the ragged and mixed-switch
# slices by 0.31 and 0.11 of the one-rank x's own error (its distance to the refined solution), and by 0
# with fixed-order contractions.  So the three-rank x may lie from the whole build's x at most this share of
# the whole build's own error (its distance to a longer solve of the same build)
G24_X_SHARE = 0.5
THREE_RANK_REF_LOOP = dict(maxiter=40, tol=1e-10, inner_tol=3e-5, max_inner=20)  # with the hand-over (ffops=)
G24_FAMILIES = ("ragged", "switch")  # the families whose two-rank float64 x moved on the card (ROADMAP G24)
G24_FIXED_TOL = 1e-12  # fixed-order contractions: the two-rank x against the one-rank x, of max|x|
NS_HIST_RTOL = 1e-5  # the sharded runs' relative-defect histories against the unsharded one's
NS_PEAK_SHARE = 0.6  # a rank of two may peak at this share of the one-rank run's device memory
# the hand-over of _mixed_loop_ff(ffops=) to the true cycles: tools/run_xl_solve.py's call on the
# north star, and on the 16,777,217-DoF flagship the target of multigrid_true's solve of the same build:
# a workaround, not a result, since the CG-topped true cycle floors near 1e-8 there (ROADMAP G23). The
# flagship phase also runs the hand-over at tol 1e-10 and maxiter 60 and, as the witness of that floor,
# multigrid_true alone at tol 1e-10 (FLAGSHIP_TRUE_FLOOR) on the same build; both are printed, not held.
# The hand-over's peak memory at most HANDOVER_PEAK_RATIO times multigrid_true's
NS_HANDOVER = dict(maxiter=100, tol=1e-8, inner_tol=3e-5, max_inner=20)
FLAGSHIP_HANDOVER = dict(maxiter=60, tol=1e-8, inner_tol=3e-5, max_inner=20)
FLAGSHIP_HANDOVER_1E10 = dict(FLAGSHIP_HANDOVER, tol=1e-10)
FLAGSHIP_TRUE_FLOOR = dict(maxiter=40, tol=1e-10)
HANDOVER_PEAK_RATIO = 1.1
EXAMPLES = ("cg_convergence", "full_hierarchy_solve", "mixed_precision_fastpath", "smoother_study",
            "scattered_partitions", "xl_north_star", "distributed_solve")
EXAMPLE_TIMEOUT_S = 300  # all examples, run side by side
# iterative_smoother_solve on the card against the host: 300 Jacobi steps (tol 1e-3 of ||b|| is not reached on
# the 33-node level), both histories in float64, held to RICHARDSON_RTOL relative
RICHARDSON = dict(maxiter=300, tol=1e-3, alpha=2 / 3)
RICHARDSON_RTOL = 1e-9
# the 16,777,217-DoF flagship's damped _mixed_loop_ff stalls (1.396e-8 on one
# rank): on two ranks its float64 residual must stall below FLAGSHIP_STALL and
# within FLAGSHIP_STALL_RATIO of the one-rank run's
FLAGSHIP_STALL = 1e-7
FLAGSHIP_STALL_RATIO = 10.0
NORTH_STAR_JAX_CYCLES = 15  # BENCH_r05.json (cycles do not depend on the hardware)
# iterations of the JAX package on the CPU at the same sizes (its
# multigrid_mixed with use_pallas=False), for comparison
JAX_CPU = {
    "slice_cheb": "15 outer / 19 inner (BENCH_r05.json: 19 V-cycles)",
    "flagship_f64": "12", "flagship_f64_cheb": "7",
    "flagship_mixed": "14 outer / 20 inner", "flagship_mixed_cheb": "13 outer / 18 inner",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def k1_k8(launches: dict) -> dict:
    """The nonzero counts of ``launches`` but the contraction kernels'
    (K9-K11, which every solve on the card runs, float64 ones too)."""
    return {k: v for k, v in launches.items() if v and k not in GEMV_COUNTERS}


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, reps: int = 200) -> float:
    """Host microseconds one call takes to return (the enqueue, not the
    device's work): ``reps`` calls on the host clock, the queue drained
    before and after."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def kernel_inputs(bs: int, n: int, seed: int):
    """Random diagonally dominant block-tridiagonal operator with S^-1 the
    exact inverse of A_D (as tests/test_pallas.py builds them), on the card."""
    from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag, block_mul

    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    l, u = rnd(bs, bs, n), rnd(bs, bs, n)
    l[:, :, 0] = 0
    u[:, :, -1] = 0
    d = rnd(bs, bs, n) + 5 * torch.eye(bs, device="cuda")[:, :, None]
    sinv = torch.linalg.inv(d.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    x, b = rnd(bs, n), rnd(bs, n)
    return BlockTridiag(l, d, u), sinv, block_mul(sinv, l), block_mul(sinv, u), x, b


def col_bytes(name, bs):
    """Bytes per block column a kernel must move: each input read once, each
    output written once (K7: those of the kernel it extends; its ghosts are
    priced per launch by ``ghost_bytes``)."""
    name = K7_FORMS[name][2] if name in K7_FORMS else name
    return 4 * {
        "K1": 4 * bs * bs + 2 * bs + 2 * bs,
        "K2": 3 * bs * bs + 2 * bs + bs,
        "K3": 3 * bs * bs + bs + bs,
        "K5": 3 * bs * bs + 2 * bs + bs,
        "K5r": 4 * bs * bs + 2 * bs + 2 * bs,
        "K6": 6 * bs,
        "K12": 6 * bs * bs + 6 * bs,
        "K8": 4 * bs * bs + 2 * bs + bs,
        "K4": 3 * bs * bs + 2 * bs + bs,
    }[name]


def ghost_bytes(name, bs):
    """K7's ghost columns a launch reads: ML, MU, S^-1, x, b of the
    ``k (+1)`` nearest ghost columns a side (the kernel's window halo)."""
    halo = 3 + (1 if name in ("K7r", "K7cr") else 0)
    return 4 * 2 * halo * (3 * bs * bs + 2 * bs)


def col_ops(name, bs, k=3):
    """Float32 operations per block column (an FMA is two): the
    contractions and updates of the kernel's arithmetic."""
    name = K7_FORMS[name][2] if name in K7_FORMS else name
    mat = 2 * bs * bs
    sweeps = 2 * mat + 4 * bs
    return {
        "K1": mat + k * sweeps + 2 * mat + 3 * bs + mat + bs,
        "K2": mat + k * sweeps,
        "K3": 3 * mat + 2 * bs,
        "K5": mat + k * (sweeps + 3 * bs),
        "K5r": mat + k * (sweeps + 3 * bs) + 2 * mat + 3 * bs + mat + bs,
        "K6": 105 * bs * bs,
        "K12": 105 * bs * bs,
        "K8": 4 * mat + 5 * bs,
        "K4": 3 * bs * bs + 2 * bs,
    }[name]


def bound(name, bs, n) -> tuple:
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes / 3.35 TB/s and operations / 67 TFLOP/s (float32)."""
    nbytes = col_bytes(name, bs) * n + (ghost_bytes(name, bs) if name in K7_FORMS else 0)
    t_bytes, t_ops = nbytes / PEAK_BPS * 1e3, col_ops(name, bs) * n / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hold(name, kern, plain, bs, n, results, line, timed=True):
    """Run a kernel and its plain version on the same tensors, check the
    kernel (finite, within TOL of max|out|), time both with CUDA events and
    record the numbers under ``results[name]``."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
    scale = max(float(w_.abs().max()) for w_ in want)
    check(all(bool(torch.isfinite(g_).all()) for g_ in got), f"{name} non-finite at {bs},{n}")
    check(err <= TOL * scale, f"{name} differs from plain at bs={bs} n={n}: {err} > {TOL} * {scale}")
    r = results.setdefault(name, {"max_abs_err": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    if not timed:
        line.append(f"{name} err={err:.3e} (rel {err / scale:.2e});")
        return
    ms, plain_ms = time_ms(kern), time_ms(plain)
    gbps = col_bytes(name, bs) * n / (ms * 1e-3) / 1e9
    line.append(
        f"{name} err={err:.3e} (rel {err / scale:.2e}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"GB/s={gbps:.1f} plain_GB/s={col_bytes(name, bs) * n / (plain_ms * 1e-3) / 1e9:.1f};"
    )
    r[(bs, n)] = (ms, plain_ms)
    if "ms" not in r:  # the first shape timed is the headline
        bound_ms, bound_by = bound(name, bs, n)
        r.update(ms=ms, plain_ms=plain_ms, gbps=gbps, bound_ms=bound_ms, bound_by=bound_by)


def phase_kernels(bk) -> dict:
    coef = bk.chebyshev_coefficients(*CHEB_INTERVAL, 3)
    results = {}
    for bs, n in SHAPES:
        a, sinv, ml, mu, x, b = kernel_inputs(bs, n, SEED + bs * n)
        runs = {
            "K1": (lambda: bk.multisweep_residual(ml, mu, sinv, a.diag, x, b),
                   lambda: bk.multisweep_residual_plain(ml, mu, sinv, a.diag, x, b)),
            "K2": (lambda: bk.multisweep(ml, mu, sinv, x, b),
                   lambda: bk.multisweep_plain(ml, mu, sinv, x, b)),
            "K3": (lambda: bk.fused_bt_matvec(a, x), lambda: bk.bt_matvec_plain(a, x)),
            "K5": (lambda: bk.chebyshev_multisweep(ml, mu, sinv, x, b, coef),
                   lambda: bk.chebyshev_multisweep_plain(ml, mu, sinv, x, b, coef)),
            "K5r": (lambda: bk.chebyshev_multisweep_residual(ml, mu, sinv, a.diag, x, b, coef),
                    lambda: bk.chebyshev_multisweep_residual_plain(ml, mu, sinv, a.diag, x, b, coef)),
            "K8": (lambda: bk.block_jacobi_sweep(a, sinv, x, b), lambda: bk.block_jacobi_sweep_plain(a, sinv, x, b)),
            "K4": (lambda: bk.stream_kernel(ml, mu, sinv, x, b), lambda: bk.stream_kernel_plain(ml, mu, sinv, x, b)),
        }
        line = [f"kernels bs={bs} n={n}:"]
        for name, (kern, plain) in runs.items():
            hold(name, kern, plain, bs, n, results, line)
        print(" ".join(line), flush=True)
        del a, sinv, ml, mu, x, b, runs
        torch.cuda.empty_cache()
    return results


def phase_k6(bk) -> dict:
    """K6 against its plain version, bit for bit, on random stencils with
    boundary columns; both timed with CUDA events."""
    out = {"max_abs_err": 0.0}
    for bs, n in K6_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(SEED + 7 * bs + n)
        rnd = lambda *s, scale=1.0: scale * torch.randn(*s, generator=g, device="cuda")  # noqa: E731
        blocks = torch.stack([rnd(3, bs, bs, 2 * K6_BW + 1, scale=1e3),
                              rnd(3, bs, bs, 2 * K6_BW + 1, scale=1e-4)]).contiguous()
        x_hi, x_lo = rnd(bs, n), rnd(bs, n, scale=1e-8)
        b_hi, b_lo = rnd(bs, n, scale=1e3), rnd(bs, n, scale=1e-5)
        args = (blocks, x_hi, x_lo, b_hi, b_lo)
        got, want = bk.ff_stencil_mid_defect(*args), bk.ff_stencil_mid_defect_plain(*args)
        torch.cuda.synchronize()
        err = max(float((got_ - want_).abs().max()) for got_, want_ in zip(got, want))
        n_diff = sum(int((got_ != want_).sum()) for got_, want_ in zip(got, want))
        check(all(bool(torch.isfinite(t).all()) for t in got), f"K6 non-finite at {bs},{n}")
        check(n_diff == 0, f"K6 differs from plain at bs={bs} n={n}: {n_diff} elements, max {err}")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        del got, want
        ms = time_ms(lambda: bk.ff_stencil_mid_defect(*args))
        plain_ms = time_ms(lambda: bk.ff_stencil_mid_defect_plain(*args), reps=5)
        gbps = 24 * bs * n / (ms * 1e-3) / 1e9  # x and b pairs in, r pair out
        print(f"K6 bs={bs} n={n}: bit-exact (hi and lo) ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"GB/s={gbps:.1f}", flush=True)
        out[(bs, n)] = (ms, plain_ms)
        if (bs, n) == K6_SHAPES[0]:
            bound_ms, bound_by = bound("K6", bs, n)
            out.update(ms=ms, plain_ms=plain_ms, gbps=gbps, bound_ms=bound_ms, bound_by=bound_by)
        del args, blocks, x_hi, x_lo, b_hi, b_lo
        torch.cuda.empty_cache()
    return out


def k12_inputs(bs: int, n: int, seed: int):
    """A random float-float block-tridiagonal operator (hi ~ 1e3, lo ~ 1e-4),
    x and b pairs and two ghost columns, on the card."""
    from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import BlockTridiagFF

    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s, scale=1.0: scale * torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    a = BlockTridiagFF(BlockTridiag(*(rnd(bs, bs, n, scale=1e3) for _ in range(3))),
                       BlockTridiag(*(rnd(bs, bs, n, scale=1e-4) for _ in range(3))))
    v = (rnd(bs, n), rnd(bs, n, scale=1e-8), rnd(bs, n, scale=1e3), rnd(bs, n, scale=1e-5))
    return a, v, (rnd(2, bs), rnd(2, bs, scale=1e-8))


def phase_k12(bk) -> dict:
    """K12, the float-float defect of a materialised operator, against its
    plain version bit for bit (hi and lo), without and with ghost columns;
    both timed with CUDA events, against the byte bound."""
    out = {"max_abs_err": 0.0}
    for bs, n in K12_SHAPES:
        a, v, ghosts = k12_inputs(bs, n, SEED + 11 * bs + n)
        for gl, gr in ((None, None), ghosts):
            got, want = bk.ff_bt_defect(a, *v, gl, gr), bk.ff_bt_defect_plain(a, *v, gl, gr)
            torch.cuda.synchronize()
            n_diff = sum(int((got_.view(torch.int32) != want_.view(torch.int32)).sum())
                         for got_, want_ in zip(got, want))
            check(all(bool(torch.isfinite(t).all()) for t in got), f"K12 non-finite at {bs},{n}")
            check(n_diff == 0, f"K12 differs from plain at bs={bs} n={n} ghosts={gl is not None}: {n_diff} elements")
            del got, want
        ms = time_ms(lambda: bk.ff_bt_defect(a, *v))
        plain_ms = time_ms(lambda: bk.ff_bt_defect_plain(a, *v), reps=3)
        bound_ms, bound_by = bound("K12", bs, n)
        gbps = col_bytes("K12", bs) * n / (ms * 1e-3) / 1e9
        print(f"K12 bs={bs} n={n}: bit-exact (hi and lo, without and with ghosts) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}; {100 * bound_ms / ms:.1f} % of the "
              f"bound) GB/s={gbps:.1f}", flush=True)
        if "ms" not in out:  # the first shape is the headline
            out.update(ms=ms, plain_ms=plain_ms, gbps=gbps, bound_ms=bound_ms, bound_by=bound_by)
        del a, v, ghosts
        torch.cuda.empty_cache()
    return out


def k14_bytes(bs: int, n: int, step: str) -> int:
    """Bytes K14 must move: S^-1 and r_hi in, u's pair in and out, d in (not
    on the first step) and out (not on the last), once each."""
    return 4 * (bs * bs + 5 * bs + (bs if step != "first" else 0) + (bs if step != "last" else 0)) * n


def phase_k14(bk) -> dict:
    """K14, a true Chebyshev step on a block-Jacobi level, against its plain
    version bit for bit (u's hi and lo and d) in each of its three forms;
    each form and the plain middle step timed with CUDA events (median of
    20), against the byte bound."""
    from agglomerationmultigrid1d_tpu_torch.ops.kernels.block_kernels import chebyshev_coefficients, chebyshev_theta

    coef = [tuple(map(float, row)) for row in chebyshev_coefficients(*CHEB_INTERVAL, 3)]
    theta = float(chebyshev_theta(*CHEB_INTERVAL))
    out = {"max_abs_err": 0.0}
    for bs, n in K14_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(SEED + 14 * bs + n)
        rnd = lambda *s, scale=1.0: scale * torch.randn(*s, generator=g, device="cuda")  # noqa: E731
        s_inv, r_hi, u_hi, u_lo, d = rnd(bs, bs, n), rnd(bs, n), rnd(bs, n), rnd(bs, n, scale=1e-8), rnd(bs, n)
        calls = {
            step: (lambda fn, step=step, row=row: fn(s_inv, r_hi, u_hi, u_lo, None if step == "first" else d,
                                                   theta=theta, coef=coef[row], keep_d=step != "last"))
            for step, row in zip(K14_STEPS, range(3))
        }
        times = {}
        for step, call in calls.items():
            got, want = call(bk.ff_cheb_update), call(bk.ff_cheb_update_plain)
            torch.cuda.synchronize()
            check((got[2] is None) == (want[2] is None) == (step == "last"), f"K14 {step} step's d")
            pairs = [(a, b) for a, b in zip(got, want) if a is not None]
            n_diff = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in pairs)
            check(all(bool(torch.isfinite(a).all()) for a, _ in pairs), f"K14 non-finite at {bs},{n}")
            check(n_diff == 0, f"K14 differs from plain at bs={bs} n={n} step={step}: {n_diff} elements")
            del got, want, pairs
            times[step] = time_ms(lambda call=call: call(bk.ff_cheb_update))
        plain_ms = time_ms(lambda: calls["middle"](bk.ff_cheb_update_plain), reps=5)
        bounds = {step: k14_bytes(bs, n, step) / PEAK_BPS * 1e3 for step in K14_STEPS}
        share = {step: 100 * bounds[step] / times[step] for step in K14_STEPS}
        print(f"K14 bs={bs} n={n}: bit-exact (u hi and lo, d; first, middle and last step) "
              + " ".join(f"{st}: ms={times[st]:.4f} bound_ms={bounds[st]:.4f} ({share[st]:.1f} % of the bound);"
                         for st in K14_STEPS)
              + f" plain middle ms={plain_ms:.4f}; a degree-3 smoothing ms={sum(times.values()):.4f} "
              f"bound_ms={sum(bounds.values()):.4f}", flush=True)
        out[(bs, n)] = (times, plain_ms, bounds)
        if "ms" not in out:  # the first shape's middle step is the headline
            gbps = k14_bytes(bs, n, "middle") / (times["middle"] * 1e-3) / 1e9
            out.update(ms=times["middle"], plain_ms=plain_ms, gbps=gbps, bound_ms=bounds["middle"], bound_by="bytes",
                       smoothing_ms=sum(times.values()), smoothing_bound_ms=sum(bounds.values()))
        del s_inv, r_hi, u_hi, u_lo, d, calls
        torch.cuda.empty_cache()
    return out


def k13_bytes(p: int, n: int) -> int:
    """Bytes K13 must move: the band's 2p + 1 rows hi and lo, the x and b
    pairs in, the r pair out, once each."""
    return (8 * (2 * p + 1) + 24) * n


def phase_k13(bk) -> dict:
    """K13, the float-float defect of a CG band, against its plain version
    bit for bit (hi and lo), without and with a halo; both timed with CUDA
    events (median of 20), against the byte bound."""
    out = {"max_abs_err": 0.0}
    for p, n in K13_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(SEED + 13 * p + n)
        rnd = lambda *s, scale=1.0: scale * torch.randn(*s, generator=g, device="cuda")  # noqa: E731
        args = (rnd(2 * p + 1, n, scale=1e3), rnd(2 * p + 1, n, scale=1e-4), rnd(n), rnd(n, scale=1e-8),
                rnd(n, scale=1e3), rnd(n, scale=1e-5))
        halo = ((rnd(p), rnd(p, scale=1e-8)), (rnd(p), rnd(p, scale=1e-8)))
        for hl, hr in ((None, None), halo):
            got, want = bk.ff_cg_defect(*args, hl, hr), bk.ff_cg_defect_plain(*args, hl, hr)
            torch.cuda.synchronize()
            n_diff = sum(int((got_.view(torch.int32) != want_.view(torch.int32)).sum())
                         for got_, want_ in zip(got, want))
            check(all(bool(torch.isfinite(t).all()) for t in got), f"K13 non-finite at p={p} n={n}")
            check(n_diff == 0, f"K13 differs from plain at p={p} n={n} halo={hl is not None}: {n_diff} elements")
            del got, want
        ms = time_ms(lambda: bk.ff_cg_defect(*args))
        plain_ms = time_ms(lambda: bk.ff_cg_defect_plain(*args))
        bound_ms = k13_bytes(p, n) / PEAK_BPS * 1e3
        gbps = k13_bytes(p, n) / (ms * 1e-3) / 1e9
        print(f"K13 p={p} n={n}: bit-exact (hi and lo, without and with a halo) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} (bytes; {100 * bound_ms / ms:.1f} % of the bound) "
              f"GB/s={gbps:.1f}", flush=True)
        out[(p, n)] = (ms, plain_ms, bound_ms)
        if "ms" not in out:  # the first shape is the headline
            out.update(ms=ms, plain_ms=plain_ms, gbps=gbps, bound_ms=bound_ms, bound_by="bytes")
        del args, halo
        torch.cuda.empty_cache()
    return out


def phase_gemv(bk) -> dict:
    """The three block contractions (``bd_gemv``, ``bp_prolong_gemv``,
    ``bp_restrict_gemv``) at the main path's shapes: each held to its plain
    version bit for bit (and its difference from the einsum it replaced, the
    einsum path, counted), timed with CUDA events beside the plain version
    and that einsum, against its bytes over 3.35 TB/s."""
    out = {}
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    cases = [("bd", (bs, bs, n), (bs, n), (bs * bs + 2 * bs) * n, dt, f"bs={bs} n={n}")
             for bs, n, dt in GEMV_BD_SHAPES]
    for r, bs_f, bs_c, n_c, dt in GEMV_BP_SHAPES:
        nbytes = (r * bs_f * bs_c + bs_c + r * bs_f) * n_c
        cases.append(("prolong", (r, bs_f, bs_c, n_c), (bs_c, n_c), nbytes, dt, f"r={r} {bs_f}x{bs_c} n_c={n_c}"))
        cases.append(("restrict", (r, bs_f, bs_c, n_c), (bs_f, r * n_c), nbytes, dt, f"r={r} {bs_f}x{bs_c} n_c={n_c}"))
    from agglomerationmultigrid1d_tpu_torch.ops.block_diag import BlockDiag, bd_matvec
    from agglomerationmultigrid1d_tpu_torch.ops.transfer_ops import BlockProlong, bp_prolong, bp_restrict

    def einsum_path(op, wrap):  # the package's own einsum line, the kernels off
        def run(blocks, v):
            with einsum_contractions(bk):
                return op(wrap(blocks), v)
        return run

    forms = {"bd": (bk.bd_gemv, bk.bd_gemv_plain, einsum_path(bd_matvec, BlockDiag)),
             "prolong": (bk.bp_prolong_gemv, bk.bp_prolong_gemv_plain, einsum_path(bp_prolong, BlockProlong)),
             "restrict": (bk.bp_restrict_gemv, bk.bp_restrict_gemv_plain, einsum_path(bp_restrict, BlockProlong))}
    for form, bshape, vshape, words, dt, what in cases:
        kern, plain, einsum = forms[form]
        blocks = torch.randn(*bshape, generator=g, device="cuda", dtype=dt)
        v = torch.randn(*vshape, generator=g, device="cuda", dtype=dt)
        got, want, lib = kern(blocks, v), plain(blocks, v), einsum(blocks, v)
        torch.cuda.synchronize()
        n_diff, n_lib = int((got != want).sum()), int((got != lib).sum())
        check(bool(torch.isfinite(got).all()), f"{form} gemv non-finite at {what}")
        check(n_diff == 0, f"{form} gemv differs from its plain version at {what} {dt}: {n_diff} entries")
        del got, want, lib
        ms = time_ms(lambda: kern(blocks, v))
        plain_ms = time_ms(lambda: plain(blocks, v), reps=3)
        lib_ms = time_ms(lambda: einsum(blocks, v), reps=10)
        bound_ms = words * blocks.element_size() / PEAK_BPS * 1e3
        print(f"gemv {form} {what} {str(dt)[6:]}: bit-exact; differs from the einsum in {n_lib} entries; "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} einsum_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
              f"({100 * bound_ms / ms:.1f} % of the bound; einsum {100 * bound_ms / lib_ms:.1f} %)", flush=True)
        if form not in out:  # the first shape of each form is the headline
            out[form] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by="bytes")
        del blocks, v
        torch.cuda.empty_cache()
    return out


def phase_surface(bk) -> None:
    """The rest of the port's surface on the card, held for correctness only
    (nothing here is timed: the examples share the card): ``solve`` on the
    reference problem beside ``multigrid``; ``iterative_smoother_solve`` on a
    CG p = 2 level beside the same solve on the host; a checkpoint round trip of a
    solution on the card; ``device_trace`` around one float32 V-cycle; and
    every ``examples/*_torch.py`` at its default size in a subprocess (all
    started first, run side by side on the card, each held to rc 0)."""
    from agglomerationmultigrid1d_tpu_torch.assembly import cg_stiffness_and_rhs
    from agglomerationmultigrid1d_tpu_torch.mesh import BoundaryCondition, create_uniform_mesh, make_cg_mesh
    from agglomerationmultigrid1d_tpu_torch.models import (
        CgLevel,
        iterative_smoother_solve,
        make_low_precision_hierarchy,
        multigrid,
        poisson_dg_hierarchy,
        solve,
        v_cycle,
    )
    from agglomerationmultigrid1d_tpu_torch.smoothers import cg_smoother
    from agglomerationmultigrid1d_tpu_torch.utils import (
        SolveParams,
        device_trace,
        load_solver_state,
        save_solver_state,
        tree_to,
    )

    root = os.path.dirname(os.path.abspath(__file__))
    procs = {name: subprocess.Popen([sys.executable, os.path.join("examples", f"{name}_torch.py")], cwd=root,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in EXAMPLES}
    t_examples = time.perf_counter()
    try:
        prob = poisson_dg_hierarchy(**SMALL, device="cuda")
        b = prob.b
        res = solve(prob, solve_params=SolveParams(maxiter=80, tol=1e-10, compute_error=False))
        ref = multigrid(prob.hierarchy, torch.zeros_like(b), b, 80, 1e-10, compute_error=False)
        gap = float((res.x - ref.x).abs().max() / ref.x.abs().max())
        rel = rel_residual(prob, res.x)
        print(f"surface: solve on the reference problem ({b.numel()} DoF): iterations={res.iterations} "
              f"(multigrid {ref.iterations}) rel_residual={rel:.3e} max|x - x_multigrid|/max|x|={gap:.3e}",
              flush=True)
        check(res.iterations == ref.iterations and rel < 1e-10 and gap <= 1e-12, "solve against multigrid")

        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "state.npz")
            save_solver_state(path, res.x, res.iterations, res.res_history, res.err_history)
            x, it, res_h, err_h = load_solver_state(path, device="cuda")
            check(x.is_cuda and torch.equal(x, res.x) and it == res.iterations
                  and np.array_equal(res_h.numpy(), res.res_history.numpy(), equal_nan=True)
                  and np.array_equal(err_h.numpy(), res.err_history.numpy(), equal_nan=True),
                  "checkpoint round trip")
            print(f"surface: checkpoint round trip of a {tuple(x.shape)} {x.dtype} solution on {x.device}: bit for bit "
                  f"({os.path.getsize(path)} bytes)", flush=True)

            h32 = make_low_precision_hierarchy(prob.hierarchy)
            b32, e = b.float(), torch.zeros_like(b, dtype=torch.float32)
            v_cycle(h32, e, b32)  # warm-up
            torch.cuda.synchronize()
            bk.reset_launch_counts()
            with device_trace(os.path.join(td, "trace")):
                v_cycle(h32, e, b32)
            launches = {k: v for k, v in bk.LAUNCHES.items() if v}
            with open(os.path.join(td, "trace", "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            kernels = [ev for ev in events if ev.get("cat") == "kernel"]
            ours = sum(1 for ev in kernels if "multisweep" in ev.get("name", ""))
            busy_ms = sum(ev.get("dur", 0) for ev in kernels) / 1e3
            print(f"surface: device_trace of one float32 V-cycle: {len(kernels)} kernel events ({ours} of K1/K2, "
                  f"launches {launches}), device busy {busy_ms:.3f} ms", flush=True)
            check(len(kernels) > 0 and ours == launches.get("multisweep", 0) + launches.get("multisweep_residual", 0),
                  "device_trace shows no kernel, or not the V-cycle's K1/K2 launches")

        cg = make_cg_mesh(create_uniform_mesh(16, 0.0, 1.0), 2)
        a, f = cg_stiffness_and_rhs(cg, torch.ones_like, BoundaryCondition(("dir", 0.0), ("dir", 0.0)))
        runs = {}
        for dev in ("cuda", "cpu"):
            a_d, f_d = tree_to(a, dev), f.to(dev)
            runs[dev] = iterative_smoother_solve(CgLevel(a=a_d, smoother=cg_smoother(a_d, "jac")),
                                                 torch.zeros_like(f_d), f_d, **RICHARDSON)
        card, host = runs["cuda"], runs["cpu"]
        it = card.iterations
        gaps = [float(np.max(np.abs(getattr(card, k)[:it].numpy() / getattr(host, k)[:it].numpy() - 1)))
                for k in ("res_history", "err_history")]
        print(f"surface: iterative_smoother_solve (CG p=2, 33 nodes, Jacobi, {RICHARDSON}): {it} iterations on the "
              f"card, {host.iterations} on the host; res {float(card.res_history[it - 1]):.3e}; card against host: "
              f"res_history within {gaps[0]:.3e}, err_history within {gaps[1]:.3e} relative", flush=True)
        check(it == host.iterations and max(gaps) <= RICHARDSON_RTOL,
              "iterative_smoother_solve: card and host histories")
    finally:
        outs = {}
        for name, proc in procs.items():
            try:
                outs[name] = (proc.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t_examples)))[0],
                              proc.returncode)
            except subprocess.TimeoutExpired:
                proc.kill()
                outs[name] = (proc.communicate()[0], "timeout")
    for name, (text, rc) in outs.items():
        last = text.strip().splitlines()[-1] if text.strip() else ""
        print(f"surface: examples/{name}_torch.py rc={rc}: {last}", flush=True)
    bad = {name: (rc, text[-1500:]) for name, (text, rc) in outs.items() if rc != 0}
    check(not bad, f"examples failed: {bad}")
    print(f"surface: {len(outs)} examples ran side by side, each rc 0", flush=True)


def north_star_spec(n: int = NORTH_STAR_N, first_agg_factor: int = 4):
    """``examples/xl_north_star.py``'s spec: DG p = 1, 6 agglomerated levels
    at 4:1 (the first at ``first_agg_factor``:1), c_dir = 1000 n, on ``n``
    elements."""
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    return HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=6, p_agg=1, first_agg_factor=first_agg_factor,
                         agg_factor=4, c_dir=1000.0 * n)


def _einsum_bd(blocks, x):  # ops/block_diag.py:bd_matvec's CPU line
    return torch.einsum("ijn,jn->in", blocks, x)


def _einsum_prolong(blocks, xc):  # ops/transfer_ops.py:bp_prolong's CPU lines
    t = torch.einsum("jibn,bn->jin", blocks, xc)
    return t.permute(1, 2, 0).reshape(blocks.shape[1], blocks.shape[0] * xc.shape[-1])


def _einsum_restrict(blocks, rf):  # ops/transfer_ops.py:bp_restrict's CPU lines
    r, out = blocks.shape[0], None
    for j in range(r):
        oj = torch.einsum("ibn,in->bn", blocks[j], rf[:, j::r])
        out = oj if out is None else out + oj
    return out


@contextlib.contextmanager
def einsum_contractions(bk):
    """Inside, every block contraction on the card takes the
    ``torch.einsum`` its kernel replaced (the package's CPU lines, in place
    of ``bd_gemv`` / ``bp_prolong_gemv`` / ``bp_restrict_gemv``, uncounted),
    and the true cycles' Chebyshev steps take the plain chain in place of
    K14, which holds their block-Jacobi apply (``plain_cheb_update``): the
    path before K9-K11 and K14, for the rounding comparisons."""
    from agglomerationmultigrid1d_tpu_torch.ops import transfer_ops

    saved = bk.bd_gemv, transfer_ops.bp_prolong_gemv, transfer_ops.bp_restrict_gemv
    bk.bd_gemv, transfer_ops.bp_prolong_gemv, transfer_ops.bp_restrict_gemv = (
        _einsum_bd, _einsum_prolong, _einsum_restrict)
    try:
        with plain_cheb_update():
            yield
    finally:
        bk.bd_gemv, transfer_ops.bp_prolong_gemv, transfer_ops.bp_restrict_gemv = saved


@contextlib.contextmanager
def plain_ff_bt_defect(bk):
    """Inside, every float-float defect of a materialised operator on the
    card takes the plain torch chain (``ff_bt_defect_plain``, uncounted) in
    place of K12: the path before K12, for the bit-for-bit comparisons."""
    saved = bk.ff_bt_defect
    bk.ff_bt_defect = bk.ff_bt_defect_plain
    try:
        yield
    finally:
        bk.ff_bt_defect = saved


@contextlib.contextmanager
def plain_cheb_update():
    """Inside, every true Chebyshev smoothing on a block-Jacobi level takes
    the plain chain (``models.solvers._chebyshev`` with the ``ff_add``
    update, K9 and the 0-d recurrence) in place of K14: the path before K14,
    for the bit-for-bit comparisons."""
    from agglomerationmultigrid1d_tpu_torch.models import solvers
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF, ff_add

    saved = solvers._chebyshev_k14
    solvers._chebyshev_k14 = lambda s, degree, u, residual: solvers._chebyshev(
        s, degree, u, residual, lambda v, d: ff_add(v, FF(d, torch.zeros_like(d))))
    try:
        yield
    finally:
        solvers._chebyshev_k14 = saved


@contextlib.contextmanager
def recorded_norms():
    """Inside, every norm the solvers take (``models.solvers._norm``: the
    outer defects, each inner solve's right-hand side and residuals, the
    true cycles' residuals) is kept in the yielded list, as the 0-d tensor it
    returned."""
    from agglomerationmultigrid1d_tpu_torch.models import solvers

    own, log = solvers._norm, []

    def kept(*a, **kw):
        v = own(*a, **kw)
        log.append(v.detach().clone())
        return v

    solvers._norm = kept
    try:
        yield log
    finally:
        solvers._norm = own


def phase_north_star(bk) -> dict:
    """The 100,663,296-DoF north star: build on the card, one warm-up cycle,
    then the solve to 1e-8, then the same solve with the contractions on the
    einsum (its residual history must equal the kernels'); the hand-over,
    twice too (its outer history, every norm it takes and its x must equal
    the einsum path's); returns the solve's K6 and contraction launches."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, default_stencil_factor, multigrid_true
    from agglomerationmultigrid1d_tpu_torch.ops.block_tridiag import BlockTridiag, bt_matvec
    from agglomerationmultigrid1d_tpu_torch.ops.coarse_solve import BTCoarseSolver
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import BlockTridiagFF, ff_join

    n = NORTH_STAR_N
    spec = north_star_spec()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    t0 = time.perf_counter()
    h, ffops, b_ff, norm_b = build_xl_problem(spec, n, slim_fine=True, ff_levels=True, device="cuda",
                                              timings=timings)
    setup_s = time.perf_counter() - t0
    coarse = ffops.coarse64
    blocks_c = h.levels[-1].a.n_blocks
    print(f"north star {2 * n} DoF: setup_s={setup_s:.3f} (host stencil {timings['host_stencil']:.3f}, "
          f"inflation {timings['inflate']:.3f}, device rhs {timings['rhs']:.3f}); levels={h.n_levels} "
          f"coarsest={blocks_c} blocks ({type(coarse).__name__}); stencil factor z={default_stencil_factor(spec, n)}",
          flush=True)
    check(h.n_levels == 7 and blocks_c == 12288 and isinstance(coarse, BTCoarseSolver), "north star shape")

    t0 = time.perf_counter()
    multigrid_true(h, ffops, b_ff, norm_b, 1, 1e-8)  # warm-up: one V-cycle
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    build_peak = torch.cuda.max_memory_allocated()  # the build and the warm-up cycle
    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    res = multigrid_true(h, ffops, b_ff, norm_b, 40, 1e-8)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k6 = bk.LAUNCHES["ff_stencil_mid_defect"]
    k12 = bk.LAUNCHES["ff_bt_defect"]
    k14 = bk.LAUNCHES["ff_cheb_update"]
    gemv = {k: bk.LAUNCHES[k] for k in GEMV_COUNTERS}
    peak = torch.cuda.max_memory_allocated()
    it = res.iterations
    hist = (res.res_history[:it] / norm_b).tolist()
    res_h = res.res_history.clone()
    x = res.x.cpu()  # the two solves start from the same resident set
    del res
    with einsum_contractions(bk):  # the einsum path: the kernels must round as it does
        t0 = time.perf_counter()
        ein = multigrid_true(h, ffops, b_ff, norm_b, 40, 1e-8)
        torch.cuda.synchronize()
        ein_s = time.perf_counter() - t0
    print(f"north star multigrid_true through the einsum: cycles={ein.iterations} solve_s={ein_s:.3f}; "
          f"residual history equal to the kernels' to the last bit: {torch.equal(ein.res_history[:it], res_h[:it])}; "
          f"contraction launches {gemv}", flush=True)
    check(ein.iterations == it and torch.equal(ein.res_history[:it], res_h[:it]),
          "north star: the contraction kernels' residual history differs from the einsum path's")
    check(gemv["bp_prolong_gemv"] and gemv["bp_restrict_gemv"] and k14,  # the block-Jacobi applies are in K14
          f"north star: a contraction kernel or K14 did not run: {gemv}, K14 {k14}")
    del ein
    with plain_ff_bt_defect(bk):  # the path before K12: the plain chain on levels 1-5
        t0 = time.perf_counter()
        pl = multigrid_true(h, ffops, b_ff, norm_b, 40, 1e-8)
        torch.cuda.synchronize()
        pl_s = time.perf_counter() - t0
    materialised = sum(isinstance(a, BlockTridiagFF) for a in ffops.a_ffs[: h.n_levels - 1])
    print(f"north star multigrid_true through the plain float-float chain: cycles={pl.iterations} "
          f"solve_s={pl_s:.3f}; residual history equal to K12's to the last bit: "
          f"{torch.equal(pl.res_history[:it], res_h[:it])}; K12 launches {k12} ({materialised} materialised levels)",
          flush=True)
    check(pl.iterations == it and torch.equal(pl.res_history[:it], res_h[:it]),
          "north star: the residual history through K12 differs from the plain chain's")
    check(k12 == 7 * materialised * it, f"K12 launched {k12} times in {it} cycles, expected {7 * materialised * it}")
    del pl
    with plain_cheb_update():  # the path before K14: K9, the 0-d recurrence and ff_add's chain on levels 0-5
        t0 = time.perf_counter()
        pl = multigrid_true(h, ffops, b_ff, norm_b, 40, 1e-8)
        torch.cuda.synchronize()
        pl_s = time.perf_counter() - t0
    smoothed = h.n_levels - 1
    print(f"north star multigrid_true through the plain Chebyshev chain: cycles={pl.iterations} "
          f"solve_s={pl_s:.3f}; residual history equal to K14's to the last bit: "
          f"{torch.equal(pl.res_history[:it], res_h[:it])}; K14 launches {k14} ({smoothed} smoothed levels)",
          flush=True)
    check(pl.iterations == it and torch.equal(pl.res_history[:it], res_h[:it]),
          "north star: the residual history through K14 differs from the plain Chebyshev chain's")
    check(k14 == 6 * smoothed * it, f"K14 launched {k14} times in {it} cycles, expected {6 * smoothed * it}")
    del pl
    with recorded_norms() as norms:
        ho = handover_solve(bk, h, ffops, b_ff, norm_b, NS_HANDOVER)
    # the einsum path: the hand-over's inner stopping test reads _mform_matvec's contractions too
    with einsum_contractions(bk), recorded_norms() as norms_ein:
        ho_ein = handover_solve(bk, h, ffops, b_ff, norm_b, NS_HANDOVER)
    same = dict(outer_history=bool(np.array_equal(ho["hist"], ho_ein["hist"])),
                every_norm=len(norms) == len(norms_ein) and all(map(torch.equal, norms, norms_ein)),
                x=torch.equal(ho["x"], ho_ein["x"]))
    print(f"north star hand-over through the einsum: outer={ho_ein['outer']} cycles={ho_ein['cycles']} "
          f"solve_s={ho_ein['solve_s']:.3f}; {len(norms)} norms (the outer defects, each inner solve's "
          f"right-hand side and residuals, the true cycles'); equal to the kernels' to the last bit: {same}",
          flush=True)
    check((ho_ein["outer"], ho_ein["cycles"]) == (ho["outer"], ho["cycles"]) and all(same.values()),
          "north star hand-over: the contraction kernels' residual histories or x differ from the einsum path's")
    del ho_ein, norms, norms_ein

    # independent check: the fine operator materialized in float64 from the
    # stencil (hi + lo joined, interior broadcast, boundary columns spliced)
    st = ffops.a_ffs[0]

    def full(name):
        parts = []
        for side, reps in (("left", 1), ("mid", n - 2 * st.bw), ("right", 1)):
            v = getattr(getattr(st, "hi_" + side), name).double() + getattr(getattr(st, "lo_" + side), name).double()
            parts.append(v.expand(*v.shape[:-1], reps) if side == "mid" else v)
        return torch.cat(parts, dim=-1)

    del ffops, h
    b64 = ff_join(b_ff)
    a64 = BlockTridiag(lower=full("lower"), diag=full("diag"), upper=full("upper"))

    def rel_f64(x_host):
        x = x_host.cuda()
        return float(torch.linalg.vector_norm(b64 - bt_matvec(a64, x)) / torch.linalg.vector_norm(b64))

    rel, ho["rel"] = rel_f64(x), rel_f64(ho.pop("x"))
    del a64, b64
    print(f"north star solve: cycles={it} (JAX: {NORTH_STAR_JAX_CYCLES}, BENCH_r05.json) "
          f"solve_s={solve_s:.3f} warmup_cycle_s={warm_s:.3f} rel_residual_f64={rel:.3e} "
          f"K6_launches={k6} peak_mem_bytes={max(build_peak, peak)} solve_peak_mem_bytes={peak} "
          f"res_history={[f'{v:.3e}' for v in hist]}", flush=True)
    check(tuple(x.shape) == (2, n) and bool(torch.isfinite(x).all()), "north star x")
    check(rel < 1e-8, f"north star relative residual {rel:.3e} >= 1e-8")
    check(k6 == 7 * it, f"K6 launched {k6} times in {it} cycles, expected {7 * it}")
    report_handover("north star", ho, dict(cycles=it, solve_s=solve_s, rel=rel, peak=peak))
    check(ho["rel"] < 1e-8, f"north star hand-over: relative residual {ho['rel']:.3e} >= 1e-8")
    check(ho["peak"] <= HANDOVER_PEAK_RATIO * peak,
          f"north star hand-over: peak {ho['peak']} > {HANDOVER_PEAK_RATIO} x multigrid_true's {peak}")
    k6_want = ho["info"]["defects"] + 7 * ho["info"]["true_cycles"]
    check(ho["launches"].get("ff_stencil_mid_defect", 0) == k6_want,
          f"north star hand-over: K6 launched {ho['launches'].get('ff_stencil_mid_defect', 0)} times, expected "
          f"{k6_want} (one per guarded defect, 7 per true cycle)")
    check(all(ho["launches"].get(k, 0) > 0 for k in ("chebyshev_multisweep", "chebyshev_multisweep_residual")),
          f"north star hand-over skipped K5 / K5r: {ho['launches']}")
    del x
    torch.cuda.empty_cache()
    # K9's launches from the hand-over (its float32 inner cycles' matvecs): multigrid_true's applies are in K14
    return {"ff_stencil_mid_defect": k6, "ff_bt_defect": k12, "ff_cheb_update": k14, **gemv,
            "bd_gemv": ho["launches"].get("bd_gemv", 0)}


def handover_solve(bk, h, ffops, b_ff, norm_b, kw) -> dict:
    """``_mixed_loop_ff(..., ffops=)`` from zero (``tools/run_xl_solve.py``'s
    call with ``kw``): the guarded float-float refinement, then the
    TRUE-precision cycles once it only trickles.  Launch counts and the
    device's peak memory from zero just before; ``x`` (float64) on the host."""
    from agglomerationmultigrid1d_tpu_torch.models.solvers import _mixed_loop_ff
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF, ff_join

    zero = torch.zeros_like(b_ff.hi)
    info = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    x_ff, outer, cycles, hist = _mixed_loop_ff(h, ffops.a_ffs[0], FF(zero, zero), b_ff, np.float32(1.0 / norm_b),
                                               ffops=ffops, info=info, **kw)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    out = dict(outer=outer, cycles=cycles, hist=np.asarray(hist[:outer], dtype=np.float64), solve_s=solve_s,
               launches={k: v for k, v in bk.LAUNCHES.items() if v}, peak=torch.cuda.max_memory_allocated(),
               info=info, x=ff_join(x_ff).cpu())
    check(bool(torch.isfinite(out["x"]).all()), "hand-over x")
    check(info["true_cycles"] >= 1 and outer == info["guarded_outer"] + info["true_cycles"],
          f"the guarded refinement did not hand over: {info}")
    return out


def report_handover(what: str, ho: dict, ref: dict) -> None:
    """One line: the hand-over's phases, seconds, residual, launches and
    peak memory beside the reference solve of the same build (``ref``)."""
    info = ho["info"]
    print(f"{what} hand-over (_mixed_loop_ff, ffops=): {info['guarded_outer']} guarded steps with "
          f"{info['guarded_cycles']} float32 V-cycles ({info['defects']} float-float defects), ended by "
          f"{info['ended']}; then {info['true_cycles']} true cycles; outer={ho['outer']} cycles={ho['cycles']} "
          f"solve_s={ho['solve_s']:.3f} rel_residual_f64={ho['rel']:.3e} peak_mem_bytes={ho['peak']} "
          f"launches={ho['launches']} res_history={[f'{v:.3e}' for v in ho['hist']]}; beside: {ref}", flush=True)


def rel_residual(prob, x) -> float:
    """||b - A x|| / ||b|| in float64 on the card, on the float64 fine operator."""
    return level_rel_residual(prob.hierarchy, prob.b, x)


def level_rel_residual(h, b, x) -> float:
    """||b - A x|| / ||b|| in float64 on ``h``'s fine operator."""
    from agglomerationmultigrid1d_tpu_torch.models.solvers import level_matvec

    r = b - level_matvec(h.levels[0], x.to(torch.float64))
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b))


def phase_slice(bk) -> dict:
    from agglomerationmultigrid1d_tpu_torch.models import (
        make_low_precision_hierarchy,
        multigrid_mixed,
        poisson_dg_hierarchy,
    )

    t0 = time.perf_counter()
    prob = poisson_dg_hierarchy(**SLICE, device="cuda")
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = prob.b
    check(prob.hierarchy.n_levels == 14 and prob.hierarchy.coarse.n == 128, "slice shape")

    t0 = time.perf_counter()
    multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(b), b, 80, 1e-10)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    res = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(b), b, 80, 1e-10)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    rel = rel_residual(prob, res.x)
    print(
        f"slice {b.numel()} DoF, {prob.hierarchy.n_levels} levels: setup_s={setup_s:.3f} "
        f"first_solve_s={first_s:.3f} solve_s={solve_s:.3f} outer={res.iterations} "
        f"inner_cycles={res.inner_cycles} rel_residual={rel:.3e} launches={launches} "
        f"peak_mem_bytes={peak} (JAX on the CPU at this size: 21 outer / 27 inner; "
        f"BENCH_r05.json: 28 inner)",
        flush=True,
    )
    check(tuple(res.x.shape) == (4, SLICE["n"]) and bool(torch.isfinite(res.x).all()), "slice x")
    check(rel < 1e-10, f"slice relative residual {rel:.3e} >= 1e-10")
    check(all(launches[k] > 0 for k in DAMPED), f"a kernel was not launched by the solve: {launches}")
    return launches


def phase_reference(bk) -> None:
    from agglomerationmultigrid1d_tpu_torch.models import (
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        poisson_dg_hierarchy,
    )

    prob = poisson_dg_hierarchy(**SMALL, device="cuda")
    b = prob.b
    ref = multigrid(prob.hierarchy, torch.zeros_like(b), b, 80, 1e-10, compute_error=False)
    rel_ref = rel_residual(prob, ref.x)
    h32 = make_low_precision_hierarchy(prob.hierarchy)
    before = dict(bk.LAUNCHES)
    mixed = multigrid_mixed(prob.hierarchy, h32, torch.zeros_like(b), b, 80, 1e-10)
    rel_mixed = rel_residual(prob, mixed.x)
    diff = float((mixed.x - ref.x).abs().max())
    print(
        f"reference {b.numel()} DoF: multigrid f64 iterations={ref.iterations} "
        f"rel_residual={rel_ref:.3e}; multigrid_mixed outer={mixed.iterations} "
        f"inner_cycles={mixed.inner_cycles} rel_residual={rel_mixed:.3e} "
        f"max|x_mixed - x_f64|={diff:.3e}",
        flush=True,
    )
    check(rel_ref < 1e-10, f"f64 multigrid relative residual {rel_ref:.3e}")
    check(rel_mixed < 1e-10, f"small mixed relative residual {rel_mixed:.3e}")
    check(diff < 1e-4, f"mixed and f64 solutions differ by {diff:.3e}")
    check(all(bk.LAUNCHES[k] > before[k] for k in DAMPED), "small mixed solve skipped a kernel")


def phase_chebyshev(bk) -> dict:
    """The DG-topped Chebyshev mixed solve at full width; returns its K5 launches."""
    from agglomerationmultigrid1d_tpu_torch.models import (
        chebyshev_hierarchy,
        make_low_precision_hierarchy,
        multigrid_mixed,
        poisson_dg_hierarchy,
    )

    t0 = time.perf_counter()
    prob = poisson_dg_hierarchy(**SLICE, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    h = chebyshev_hierarchy(prob.hierarchy)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    h32 = make_low_precision_hierarchy(h)
    torch.cuda.synchronize()
    setup_s, lam_s = time.perf_counter() - t0, t2 - t1
    b = prob.b

    t0 = time.perf_counter()
    multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    res = multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    rel = rel_residual(prob, res.x)
    print(
        f"chebyshev {b.numel()} DoF, {h.n_levels} levels: setup_s={setup_s:.3f} "
        f"(lambda estimation {lam_s:.3f}) first_solve_s={first_s:.3f} solve_s={solve_s:.3f} "
        f"outer={res.iterations} inner_cycles={res.inner_cycles} rel_residual={rel:.3e} "
        f"launches={launches} peak_mem_bytes={peak} (JAX on the CPU at this size: "
        f"{JAX_CPU['slice_cheb']})",
        flush=True,
    )
    check(tuple(res.x.shape) == (4, SLICE["n"]) and bool(torch.isfinite(res.x).all()), "chebyshev x")
    check(rel < 1e-10, f"chebyshev relative residual {rel:.3e} >= 1e-10")
    k5 = {k: launches[k] for k in ("chebyshev_multisweep", "chebyshev_multisweep_residual")}
    check(all(v > 0 for v in k5.values()), f"K5 was not launched by the Chebyshev solve: {launches}")
    return k5


def phase_flagship(bk) -> None:
    from agglomerationmultigrid1d_tpu_torch.models import (
        chebyshev_hierarchy,
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        poisson_full_hierarchy,
    )

    t0 = time.perf_counter()
    prob = poisson_full_hierarchy(n=FLAGSHIP_N, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    h = prob.hierarchy
    check(h.n_levels == 17 and tuple(prob.b.shape) == (8 * FLAGSHIP_N + 1,), "flagship shape")
    b = prob.b
    line = [f"flagship {b.numel()} DoF, {h.n_levels} levels: setup_s={setup_s:.3f};"]
    for cheb in (False, True):
        hh = chebyshev_hierarchy(h) if cheb else h
        tag = "_cheb" if cheb else ""
        t0 = time.perf_counter()
        ref = multigrid(hh, torch.zeros_like(b), b, 100, 1e-10, compute_error=False)
        torch.cuda.synchronize()
        f64_s = time.perf_counter() - t0
        rel_ref = rel_residual(prob, ref.x)
        h32 = make_low_precision_hierarchy(hh)
        bk.reset_launch_counts()
        t0 = time.perf_counter()
        mixed = multigrid_mixed(hh, h32, torch.zeros_like(b), b, 80, 1e-10)
        torch.cuda.synchronize()
        mixed_s = time.perf_counter() - t0
        launches = dict(bk.LAUNCHES)
        rel_mixed = rel_residual(prob, mixed.x)
        line.append(
            f"{'chebyshev' if cheb else 'damped'}: f64 iterations={ref.iterations} "
            f"(JAX on the CPU: {JAX_CPU['flagship_f64' + tag]}) rel_residual={rel_ref:.3e} "
            f"first_solve_s={f64_s:.3f}; mixed outer={mixed.iterations} inner_cycles={mixed.inner_cycles} "
            f"(JAX on the CPU: {JAX_CPU['flagship_mixed' + tag]}) rel_residual={rel_mixed:.3e} "
            f"first_solve_s={mixed_s:.3f} launches={launches};"
        )
        check(rel_ref < 1e-10, f"flagship f64{tag} relative residual {rel_ref:.3e}")
        check(rel_mixed < 1e-10, f"flagship mixed{tag} relative residual {rel_mixed:.3e}")
        used = ("chebyshev_multisweep", "chebyshev_multisweep_residual") if cheb else (
            "multisweep", "multisweep_residual")
        check(all(launches[k] > 0 for k in used), f"flagship mixed{tag} skipped a kernel: {launches}")
    print(" ".join(line), flush=True)


def flagship_xl_spec(n: int):
    """``bench.py:bench_flagship_solve``'s spec: CG p = 8, 4, 2, 1, then
    agglomerated levels down to a 512-block coarsest level, c_dir = 1000 n."""
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec

    return HierarchySpec(cg_orders=(8, 4, 2, 1), n_agg_levels=int(math.log2(n // 4 // 512)) + 1, p_agg=1,
                         c_dir=1000.0 * n)


def cg_rel_residual_f64(h, a_ff, b_ff, x) -> float:
    """``||b - A x|| / ||b||`` recomputed in float64 on the card from the
    float-float fine band (``hi + lo`` is the float64 operator) and the
    float64 rhs, independently of the solver's own defect."""
    from agglomerationmultigrid1d_tpu_torch.ops.cg_operator import CgOperator, cg_matvec
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import ff_join

    band = a_ff.hi.double() + a_ff.lo.double()
    b64 = ff_join(b_ff)
    r = b64 - cg_matvec(CgOperator(windows=h.levels[0].a.windows, band=band), x)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def phase_flagship_xl(bk, n: int, true_solve: bool) -> dict:
    """The CG-topped flagship built by stencil inflation on the card and
    solved by the guarded float-float refinement ``_mixed_loop_ff``, damped
    and Chebyshev, as ``bench.py:369-394``; with ``true_solve`` also built
    with ``ff_levels=True`` and solved by ``multigrid_true`` to 1e-8.  Each
    solve: setup timings, seconds, counts, the relative residual recomputed
    in float64, peak memory and the launches of its run (counts set to 0
    just before).  Returns {tag: {"outer", "cycles", "hist"}}."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem, default_stencil_factor, multigrid_true
    from agglomerationmultigrid1d_tpu_torch.models.solvers import _mixed_loop_ff
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF

    spec = flagship_xl_spec(n)
    z = default_stencil_factor(spec, n)
    out = {}
    for cheb in (False, True):
        tag = "chebyshev" if cheb else "damped"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        t0 = time.perf_counter()
        h, a_ff, b_ff, norm_b = build_xl_problem(spec, n, chebyshev=cheb, device="cuda", timings=timings)
        setup_s = time.perf_counter() - t0
        check(h.n_levels == 4 + spec.n_agg_levels and tuple(b_ff.hi.shape) == (8 * n + 1,), "flagship XL shape")
        zero = torch.zeros_like(b_ff.hi)
        bk.reset_launch_counts()
        t0 = time.perf_counter()
        x_ff, outer, cycles, hist = _mixed_loop_ff(h, a_ff, FF(zero, zero), b_ff, np.float32(1.0 / norm_b),
                                                   maxiter=60, tol=1e-10, inner_tol=3e-5, max_inner=20)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = {k: v for k, v in bk.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        x = x_ff.hi.double() + x_ff.lo.double()
        rel = cg_rel_residual_f64(h, a_ff, b_ff, x)
        print(f"flagship XL {8 * n + 1} DoF ({h.n_levels} levels, z={z}, n0={n // z}) {tag} _mixed_loop_ff: "
              f"setup_s={setup_s:.3f} (host stencil {timings['host_stencil']:.3f}, inflation {timings['inflate']:.3f}, "
              f"device rhs {timings['rhs']:.3f}) solve_s={solve_s:.3f} outer={outer} v_cycles={cycles} "
              f"(at 131,073 DoF: JAX {FLAGSHIP_XL_JAX[tag][0]} on the TPU, BENCH_r05.json, {FLAGSHIP_XL_JAX[tag][1]} "
              f"on the CPU; the port {FLAGSHIP_XL_PORT_CPU[tag]} on the CPU) rel_history_end={float(hist[outer - 1]):.3e} "
              f"rel_residual_f64={rel:.3e} peak_mem_bytes={peak} launches={launches}", flush=True)
        check(bool(torch.isfinite(x).all()), f"flagship XL {tag} x")
        used = ("chebyshev_multisweep", "chebyshev_multisweep_residual") if cheb else ("multisweep", "multisweep_residual")
        check(all(launches.get(k, 0) > 0 for k in used), f"flagship XL {tag} skipped a kernel: {launches}")
        if n <= FLAGSHIP_N:
            check(rel < 1e-10, f"flagship XL {tag} relative residual {rel:.3e} >= 1e-10")
            tpu, want = FLAGSHIP_XL_JAX[tag][0], FLAGSHIP_XL_PORT_CPU[tag]
            print(f"flagship XL {tag}: {cycles} V-cycles, {'within' if abs(cycles - tpu) <= 1 else 'NOT within'} 1 of "
                  f"the TPU's {tpu}", flush=True)
            check(abs(cycles - want) <= 2, f"flagship XL {tag}: {cycles} V-cycles, the port on the CPU {want}")
        elif rel >= 1e-10:
            print(f"flagship XL {tag}: the guarded refinement stopped at {rel:.3e} (above 1e-10) after {outer} "
                  f"outer steps; multigrid_true takes over from here in the JAX package", flush=True)
        out[tag] = dict(outer=outer, cycles=cycles, hist=np.asarray(hist[:outer], dtype=np.float64), rel=rel)
        del h, a_ff, b_ff, x_ff, x
    if true_solve:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        t0 = time.perf_counter()
        h, ffops, b_ff, norm_b = build_xl_problem(spec, n, chebyshev=False, ff_levels=True, device="cuda",
                                                  timings=timings)
        setup_s = time.perf_counter() - t0
        bk.reset_launch_counts()
        t0 = time.perf_counter()
        res = multigrid_true(h, ffops, b_ff, norm_b, 40, 1e-8)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = {k: v for k, v in bk.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated()
        rel = cg_rel_residual_f64(h, ffops.a_ffs[0], b_ff, res.x)
        hist = (res.res_history[: res.iterations] / norm_b).tolist()
        print(f"flagship XL {8 * n + 1} DoF multigrid_true: setup_s={setup_s:.3f} (host stencil "
              f"{timings['host_stencil']:.3f}, inflation {timings['inflate']:.3f}, device rhs {timings['rhs']:.3f}) "
              f"solve_s={solve_s:.3f} cycles={res.iterations} rel_residual_f64={rel:.3e} peak_mem_bytes={peak} "
              f"launches={launches} (the CG levels' float-float defects K13, the agglomerated levels' K12) "
              f"res_history={[f'{v:.3e}' for v in hist]}", flush=True)
        check(bool(torch.isfinite(res.x).all()), "flagship XL multigrid_true x")
        check(rel < 1e-8, f"flagship XL multigrid_true relative residual {rel:.3e} >= 1e-8")
        out["true"] = dict(outer=res.iterations, cycles=res.iterations)
        true_ref = dict(cycles=res.iterations, solve_s=solve_s, rel=rel, peak=peak)
        del res
        # G23's witness: multigrid_true alone below its floor, its best and last iterates
        res = multigrid_true(h, ffops, b_ff, norm_b, **FLAGSHIP_TRUE_FLOOR)
        hist = (res.res_history[: res.iterations] / norm_b).numpy()
        rel = cg_rel_residual_f64(h, ffops.a_ffs[0], b_ff, res.x)
        print(f"flagship XL {8 * n + 1} DoF multigrid_true {FLAGSHIP_TRUE_FLOOR} (the floor's witness): "
              f"cycles={res.iterations} best={hist.min():.3e} at cycle {int(hist.argmin()) + 1}, last "
              f"rel_residual_f64={rel:.3e}, over its last 10 cycles {hist[-10:].min():.3e} to {hist[-10:].max():.3e} "
              f"res_history={[f'{v:.3e}' for v in hist]}", flush=True)
        check(bool(torch.isfinite(res.x).all()), "flagship XL multigrid_true at tol 1e-10 x")
        del res
        # the guarded refinement handing over to the true cycles, on this build
        # (damped) and on the Chebyshev one, beside the guarded-only solves above
        for cheb in (False, True):
            tag = "chebyshev" if cheb else "damped"
            if cheb:
                del h, ffops, b_ff
                torch.cuda.empty_cache()
                h, ffops, b_ff, norm_b = build_xl_problem(spec, n, chebyshev=True, ff_levels=True, device="cuda")
            ho = handover_solve(bk, h, ffops, b_ff, norm_b, FLAGSHIP_HANDOVER_1E10)
            ho["rel"] = cg_rel_residual_f64(h, ffops.a_ffs[0], b_ff, ho.pop("x").cuda())
            report_handover(f"flagship XL {8 * n + 1} DoF {tag} at tol 1e-10 (printed, not held; G23)", ho,
                            dict(best=float(ho["hist"].min()), guarded_only_rel=out[tag]["rel"]))
            ho = handover_solve(bk, h, ffops, b_ff, norm_b, FLAGSHIP_HANDOVER)
            ho["rel"] = cg_rel_residual_f64(h, ffops.a_ffs[0], b_ff, ho.pop("x").cuda())
            guarded = out[tag]["rel"]
            report_handover(f"flagship XL {8 * n + 1} DoF {tag}", ho, dict(
                guarded_only_rel=guarded, guarded_only_outer=out[tag]["outer"], guarded_only_cycles=out[tag]["cycles"],
                **({} if cheb else {"multigrid_true": true_ref})))
            check(ho["rel"] < 1e-8 and ho["rel"] < guarded,
                  f"flagship XL {tag} hand-over: relative residual {ho['rel']:.3e} (guarded only {guarded:.3e})")
            used = ("chebyshev_multisweep", "chebyshev_multisweep_residual") if cheb else ("multisweep",
                                                                                          "multisweep_residual")
            check(all(ho["launches"].get(k, 0) > 0 for k in used), f"flagship XL {tag} hand-over: {ho['launches']}")
            check(ho["launches"].get("ff_cg_defect", 0) > 0,
                  f"flagship XL {tag} hand-over without K13: {ho['launches']}")
            out["handover " + tag] = dict(outer=ho["outer"], cycles=ho["cycles"], launches=ho["launches"])
        del h, ffops, b_ff
    torch.cuda.empty_cache()
    return out


def phase_ragged(bk) -> dict:
    """The 2,000,000-DoF ragged DG slice (500,000 elements: 125,000
    agglomerates, then groups of about 2 once the count is odd) solved by
    ``multigrid_mixed`` damped and Chebyshev to 1e-10; K1 / K2 / K3 (and K5)
    launched.  Returns the launches of the two solves."""
    from agglomerationmultigrid1d_tpu_torch.models import (
        chebyshev_hierarchy,
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        poisson_dg_hierarchy,
    )
    from agglomerationmultigrid1d_tpu_torch.ops.transfer_ops import RaggedBlockProlong

    t0 = time.perf_counter()
    prob = poisson_dg_hierarchy(**RAGGED_SLICE, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    b = prob.b
    kinds = [type(t).__name__ for t in prob.hierarchy.transfers]
    check(b.numel() == 2000000 and "RaggedBlockProlong" in kinds, f"ragged slice shape: {kinds}")
    n_ragged = sum(isinstance(t, RaggedBlockProlong) for t in prob.hierarchy.transfers)
    out = {}
    res, solve_s, launches = timed_solve(
        lambda: multigrid(prob.hierarchy, torch.zeros_like(b), b, 100, 1e-10, compute_error=False), bk)
    rel = rel_residual(prob, res.x)
    print(f"ragged slice multigrid f64: solve_s={solve_s:.3f} iterations={res.iterations} rel_residual_f64={rel:.3e}",
          flush=True)
    check(rel < 1e-10, f"ragged slice f64 relative residual {rel:.3e} >= 1e-10")
    ref = {"multigrid": dict(counts=(res.iterations,), solve_s=solve_s)}
    for cheb in (False, True):
        tag = "chebyshev" if cheb else "damped"
        h = chebyshev_hierarchy(prob.hierarchy) if cheb else prob.hierarchy
        h32 = make_low_precision_hierarchy(h)
        torch.cuda.reset_peak_memory_stats()
        res, solve_s, launches = timed_solve(lambda: multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10), bk)
        peak = torch.cuda.max_memory_allocated()
        rel = rel_residual(prob, res.x)
        launches = {k: v for k, v in launches.items() if v}
        print(f"ragged slice {b.numel()} DoF, {h.n_levels} levels ({n_ragged} ragged transfers, coarsest "
              f"{h.levels[-1].a.n_blocks} blocks) {tag}: setup_s={setup_s:.3f} solve_s={solve_s:.3f} "
              f"outer={res.iterations} inner_cycles={res.inner_cycles} (the power-of-two slice: "
              f"{POW2_SLICE_COUNTS[tag]}) rel_residual_f64={rel:.3e} peak_mem_bytes={peak} launches={launches}",
              flush=True)
        check(rel < 1e-10, f"ragged slice {tag} relative residual {rel:.3e} >= 1e-10")
        used = ("bt_matvec", "chebyshev_multisweep", "chebyshev_multisweep_residual") if cheb else DAMPED
        check(all(launches.get(k, 0) > 0 for k in used), f"ragged slice {tag} skipped a kernel: {launches}")
        out[tag] = launches
        if not cheb:
            ref["mixed"] = dict(counts=(res.iterations, res.inner_cycles), solve_s=solve_s)
        del h, h32, res
    whole = {"h": prob.hierarchy, "b": b}
    del prob, b
    torch.cuda.empty_cache()
    out["sharded"] = one_rank_family("ragged", whole, bk, ref)
    out["ref"] = ref
    return out


def phase_device_chain(bk) -> dict:
    """The DG p=1 chain at 2,097,152 DoF (``bench.py:336``'s agglomeration
    rule): the host path (``build_problem``, then strip, cast,
    ``prepare_fast_smoothers``, ``chebyshev_hierarchy``) beside
    ``build_dg_hierarchy_device`` on the same meshes and fine operators;
    every leaf (operators, block inverses, M-form streams, the coarse
    solver's) to 2e-5 of its max, the Chebyshev bounds and table to 1e-3
    relative, and ``multigrid_mixed`` with equal counts on both."""
    from agglomerationmultigrid1d_tpu_torch.models import (
        build_dg_hierarchy_device,
        build_problem,
        chebyshev_hierarchy,
        multigrid_mixed,
        prepare_fast_smoothers,
        strip_hierarchy,
    )
    from agglomerationmultigrid1d_tpu_torch.utils.config import HierarchySpec
    from agglomerationmultigrid1d_tpu_torch.utils.precision import hierarchy_astype, tree_to

    n = DEVICE_CHAIN_N
    spec = HierarchySpec(cg_orders=(), dg_orders=(1,), n_agg_levels=int(math.log2(n // 4)) - 5, p_agg=1,
                         c_dir=1000.0 * n)
    t0 = time.perf_counter()
    fine_only = build_problem(HierarchySpec(cg_orders=(), dg_orders=(1,), c_dir=1000.0 * n), n, device="cpu")
    fine_s = time.perf_counter() - t0
    del fine_only
    t0 = time.perf_counter()
    prob = build_problem(spec, n, device="cpu")
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h_host = prepare_fast_smoothers(chebyshev_hierarchy(
        tree_to(hierarchy_astype(strip_hierarchy(prob.hierarchy), torch.float32), "cuda")))
    torch.cuda.synchronize()
    host_post_s = time.perf_counter() - t0
    lv0 = prob.hierarchy.levels[0]
    build_dg_hierarchy_device(prob.meshes, lv0.a, lv0.g, lv0.d, lv0.c, device="cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_dev = build_dg_hierarchy_device(prob.meshes, lv0.a, lv0.g, lv0.d, lv0.c, device="cuda")
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    diffs = []  # (difference of a leaf over its max, level, leaf, column of the largest difference)
    for k, (lh, ld) in enumerate(zip(h_host.levels, h_dev.levels)):
        pairs = [(f"a.{f}", getattr(ld.a, f), getattr(lh.a, f)) for f in ("lower", "diag", "upper")]
        if k < len(h_host.levels) - 1:
            pairs += [(f, getattr(ld.smoother.base, f), getattr(lh.smoother.base, f)) for f in ("inv", "ml", "mu")]
        for name, got, want in pairs:
            scale = float(want.abs().max()) or 1.0
            d = (got - want).abs().amax(dim=(0, 1))
            diffs.append((float(d.max()) / scale, k, name, int(d.argmax()), got.shape[-1]))
    diffs.sort(reverse=True)
    worst = diffs[0][0]
    bounds = []  # (relative difference, level, leaf) of the Chebyshev interval and its coefficient table
    for k, (lh, ld) in enumerate(zip(h_host.levels[:-1], h_dev.levels[:-1])):
        sh, sd = lh.smoother, ld.smoother
        bounds += [(abs(float(getattr(sd, f)) / float(getattr(sh, f)) - 1.0), k, f) for f in ("lam_lo", "lam_hi")]
        ch, cd = np.asarray(sh.coef), np.asarray(sd.coef)
        bounds.append((float(np.abs(cd - ch).max() / np.abs(ch).max()), k, "coef"))
    bounds.sort(reverse=True)
    coarse = [(float((getattr(h_dev.coarse, f) - getattr(h_host.coarse, f)).abs().max())
               / float(getattr(h_host.coarse, f).abs().max()), f) for f in h_host.coarse._fields]
    print(f"device chain vs host cast, largest leaf differences (of the leaf's max; level, leaf, column of n): "
          f"{[f'{d:.2e} L{k} {nm} col {c}/{n_}' for d, k, nm, c, n_ in diffs[:6]]}; Chebyshev bounds and table "
          f"(relative; level, leaf): {[f'{d:.2e} L{k} {nm}' for d, k, nm in bounds[:4]]}; coarse solver "
          f"{type(h_dev.coarse).__name__} (of the leaf's max): {[f'{d:.2e} {nm}' for d, nm in coarse]}", flush=True)
    check(worst <= 2e-5, f"device chain differs from the host cast: {worst:.3e} of a leaf's max")
    check(bounds[0][0] <= 1e-3, f"device chain's Chebyshev bounds differ from the host's: {bounds[0]}")
    check(type(h_dev.coarse) is type(h_host.coarse) and max(coarse)[0] <= 2e-5,
          f"device chain's coarse solver differs from the host cast's: {coarse}")
    h64 = tree_to(chebyshev_hierarchy(prob.hierarchy), "cuda")
    b = prob.b.to("cuda")
    counts = {}
    for tag, h32 in (("host", h_host), ("device", h_dev)):
        res, solve_s, launches = timed_solve(lambda: multigrid_mixed(h64, h32, torch.zeros_like(b), b, 80, 1e-10), bk)
        rel = float(res.res_history[res.iterations - 1]) / float(torch.linalg.vector_norm(b))
        counts[tag] = (res.iterations, res.inner_cycles)
        print(f"device chain {b.numel()} DoF, {h64.n_levels} levels, {tag} hierarchy: solve_s={solve_s:.3f} "
              f"outer={res.iterations} inner_cycles={res.inner_cycles} rel_residual={rel:.3e} "
              f"launches={ {k: v for k, v in launches.items() if v} }", flush=True)
        check(rel < 1e-10, f"device-chain {tag} solve relative residual {rel:.3e}")
        check(all(launches[k] > 0 for k in ("chebyshev_multisweep", "chebyshev_multisweep_residual", "bt_matvec")),
              f"device-chain {tag} solve skipped a kernel: {launches}")
    print(f"device chain setup: fine level only (host) {fine_s:.3f} s; build_problem (host float64 chain) "
          f"{build_s:.3f} s; strip + cast + move + chebyshev_hierarchy + prepare_fast_smoothers on the card "
          f"{host_post_s:.3f} s; build_dg_hierarchy_device {dev_s:.3f} s (second call; the card's "
          f"device-chain over host-chain setup: {dev_s / (build_s - fine_s + host_post_s):.3f}); "
          f"max leaf difference {worst:.3e} of the leaf's max, bounds {bounds[0][0]:.3e}, coarse {max(coarse)[0]:.3e}; counts host {counts['host']} device "
          f"{counts['device']}", flush=True)
    check(counts["host"] == counts["device"], f"device-chain counts differ from the host chain's: {counts}")
    del prob, h_host, h_dev, h64
    torch.cuda.empty_cache()
    return counts


def switch_problem(n: int, n_coarsen: int) -> tuple:
    """``poisson_switch_hierarchy`` built on the host and moved to the card:
    (hierarchy, b, {"host": s, "to_device": s})."""
    from agglomerationmultigrid1d_tpu_torch.models import poisson_switch_hierarchy
    from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_to

    t0 = time.perf_counter()
    prob = poisson_switch_hierarchy(n, n_coarsen, device="cpu")
    t1 = time.perf_counter()
    h, b = tree_to(prob.hierarchy, "cuda"), prob.b.to("cuda")
    torch.cuda.synchronize()
    return h, b, {"host": t1 - t0, "to_device": time.perf_counter() - t1}


def phase_scattered(bk) -> dict:
    """The scattered slice: ``poisson_scattered_hierarchy`` at 1,048,576 DG
    p = 1 elements (2,097,152 DoF), interleaved pairs and then nine pairwise
    merges (10 block-COO levels, 524,288 -> 1,024 agglomerates, a dense
    coarse solve at 2,048 DoF); float64 ``multigrid``, then
    ``multigrid_mixed`` damped and after ``chebyshev_hierarchy``, each to
    1e-10 recomputed in float64.  The fused kernels run at the fine DG
    level only: K1 = K2 = K3 (K5 = K5r = K3) = the inner cycles, one launch
    of each per V-cycle, none at a block-COO level.  Returns the launches of
    the two mixed solves."""
    from agglomerationmultigrid1d_tpu_torch.models import (
        chebyshev_hierarchy,
        interleaved_pair_groups,
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        poisson_scattered_hierarchy,
    )
    from agglomerationmultigrid1d_tpu_torch.ops import BlockCOO
    from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_to

    n = SCATTERED_N
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = poisson_scattered_hierarchy(n=n, p_dg=1, groups_per_level=interleaved_pair_groups(n, SCATTERED_COARSEST),
                                       device="cpu")
    t1 = time.perf_counter()
    prob = dataclasses.replace(prob, hierarchy=tree_to(prob.hierarchy, "cuda"), b=prob.b.to("cuda"))
    torch.cuda.synchronize()
    timings = {"host": t1 - t0, "to_device": time.perf_counter() - t1}
    h, b = prob.hierarchy, prob.b
    kinds = [type(lv.a).__name__ for lv in h.levels]
    check(b.numel() == 2 * n and kinds == ["BlockTridiag"] + ["BlockCOO"] * 10 and h.coarse.n == 2048,
          f"scattered slice shape: {kinds}, coarse {h.coarse.n}")
    nnz = [lv.a.nnz for lv in h.levels[1:]]
    print(f"scattered slice {b.numel()} DoF, {h.n_levels} levels (block-COO nnz {nnz}): setup host_s="
          f"{timings['host']:.3f} to_card_s={timings['to_device']:.3f} peak_mem_bytes="
          f"{torch.cuda.max_memory_allocated()}", flush=True)
    out = {}
    res, solve_s, launches = timed_solve(lambda: multigrid(h, torch.zeros_like(b), b, 100, 1e-10,
                                                           compute_error=False), bk)
    rel = rel_residual(prob, res.x)
    print(f"scattered slice multigrid f64: solve_s={solve_s:.3f} iterations={res.iterations} (port on the CPU "
          f"{SCATTERED_PORT_CPU['multigrid']}; JAX on the CPU {SCATTERED_JAX_CPU}) rel_residual_f64={rel:.3e} "
          f"launches={ {k: v for k, v in launches.items() if v} }", flush=True)
    check(rel < 1e-10, f"scattered slice f64 relative residual {rel:.3e}")
    check(not k1_k8(launches), f"a float64 solve launched a kernel: {launches}")
    check(abs(res.iterations - SCATTERED_PORT_CPU["multigrid"]) <= 2,
          f"scattered f64 count {res.iterations}, the port on the CPU {SCATTERED_PORT_CPU['multigrid']}")
    ref = {"multigrid": dict(counts=(res.iterations,), solve_s=solve_s)}
    for cheb in (False, True):
        tag = "chebyshev" if cheb else "damped"
        t0 = time.perf_counter()
        hc = chebyshev_hierarchy(h) if cheb else h
        h32 = make_low_precision_hierarchy(hc)
        torch.cuda.synchronize()
        cast_s = time.perf_counter() - t0
        check(all(isinstance(lv.a, BlockCOO) and lv.a.rows.dtype == torch.int64 for lv in h32.levels[1:]),
              "the float32 scattered levels")
        torch.cuda.reset_peak_memory_stats()
        res, solve_s, launches = timed_solve(lambda: multigrid_mixed(hc, h32, torch.zeros_like(b), b, 80, 1e-10), bk)
        peak = torch.cuda.max_memory_allocated()
        rel = rel_residual(prob, res.x)
        launches = {k: v for k, v in launches.items() if v}
        want = SCATTERED_PORT_CPU[tag]
        print(f"scattered slice multigrid_mixed {tag}: setup (cast{' + chebyshev_hierarchy' if cheb else ''}) "
              f"{cast_s:.3f} s solve_s={solve_s:.3f} outer={res.iterations} inner_cycles={res.inner_cycles} "
              f"(port on the CPU {want[0]} / {want[1]}; JAX on the CPU {SCATTERED_JAX_CPU}) rel_residual_f64={rel:.3e} "
              f"peak_mem_bytes={peak} launches={launches}", flush=True)
        check(tuple(res.x.shape) == (2, n) and bool(torch.isfinite(res.x).all()), f"scattered {tag} x")
        check(rel < 1e-10, f"scattered slice {tag} relative residual {rel:.3e} >= 1e-10")
        used = ("bt_matvec",) + (("chebyshev_multisweep", "chebyshev_multisweep_residual") if cheb
                                 else ("multisweep", "multisweep_residual"))
        check(set(k1_k8(launches)) == set(used) and all(launches[k] == res.inner_cycles for k in used),
              f"scattered {tag}: kernels must launch once per V-cycle, at the fine level only: {launches}, "
              f"{res.inner_cycles} V-cycles")
        check(abs(res.iterations - want[0]) <= 2 and abs(res.inner_cycles - want[1]) <= 2,
              f"scattered {tag} counts {res.iterations} / {res.inner_cycles}, the port on the CPU {want}")
        out[tag] = launches
        if not cheb:
            ref["mixed"] = dict(counts=(res.iterations, res.inner_cycles), solve_s=solve_s)
        del hc, h32, res
    whole = {"h": h, "b": b}
    del prob, h, b
    torch.cuda.empty_cache()
    out["sharded"] = one_rank_family("scattered", whole, bk, ref)
    out["ref"] = ref
    return out


def phase_mixed_switch(bk) -> dict:
    """The mixed-switch slice: DG p = 3 at 524,288 elements (2,097,152 DoF)
    with a mixed switch, every level block-pentadiagonal, the coarsest
    (4,096 agglomerates) solved by pair-merged cyclic reduction; float64
    ``multigrid``, ``multigrid_mixed`` and ``multigrid_progressive`` to 1e-10
    recomputed in float64, with no kernel launched (a launch would mean a
    pentadiagonal level reached a tridiagonal kernel).  Then the odd chain
    at 500,000 elements down to 15,625 agglomerates (a
    ``PaddedBTCoarseSolver`` at 31,250 DoF): float64 ``multigrid`` to 1e-10
    and to 1e-14, held on its float64 residual.  Beside it, for
    information: the gap to the banded direct solve of the fine operator
    (held to 1e-3 of max|x| only, and whether it is within 1e-8 is printed),
    the operator's 1-norm condition estimate, and both solutions' distance
    to the banded solution refined with extended-precision residuals
    (``fine_refined_solve``), the witness of which one is accurate."""
    from agglomerationmultigrid1d_tpu_torch.models import (
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        multigrid_progressive,
    )
    from agglomerationmultigrid1d_tpu_torch.ops import BlockPenta, BTCoarseSolver, PaddedBTCoarseSolver
    from agglomerationmultigrid1d_tpu_torch.ops.banded_solve import fine_direct_solve, fine_refined_solve

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    h, b, timings = switch_problem(SWITCH_N, SWITCH_COARSEN)
    check(b.numel() == 4 * SWITCH_N and h.n_levels == 3 + SWITCH_COARSEN
          and all(isinstance(lv.a, BlockPenta) for lv in h.levels)
          and h.levels[-1].a.n_blocks == 4096 and isinstance(h.coarse, BTCoarseSolver), "mixed-switch slice shape")
    print(f"mixed-switch slice {b.numel()} DoF, {h.n_levels} block-pentadiagonal levels, coarsest "
          f"{h.levels[-1].a.n_blocks} blocks ({type(h.coarse).__name__}, pair-merged): setup host_s="
          f"{timings['host']:.3f} to_card_s={timings['to_device']:.3f}", flush=True)
    t0 = time.perf_counter()
    h32 = make_low_precision_hierarchy(h)
    torch.cuda.synchronize()
    cast_s = time.perf_counter() - t0
    solves = {
        "multigrid": lambda: multigrid(h, torch.zeros_like(b), b, 100, 1e-10, compute_error=False),
        "mixed": lambda: multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10),
        "progressive": lambda: multigrid_progressive(h, h32, torch.zeros_like(b), b, 80, 1e-10),
    }
    ref = {}
    for tag, fn in solves.items():
        torch.cuda.reset_peak_memory_stats()
        res, solve_s, launches = timed_solve(fn, bk)
        peak = torch.cuda.max_memory_allocated()
        rel = level_rel_residual(h, b, res.x)
        want = SWITCH_PORT_CPU[tag]
        counts = res.iterations if tag != "mixed" else (res.iterations, res.inner_cycles)
        print(f"mixed-switch slice {tag}: solve_s={solve_s:.3f} counts={counts} (port on the CPU {want}; JAX on "
              f"the CPU {SWITCH_JAX_CPU}) rel_residual_f64={rel:.3e} peak_mem_bytes={peak}"
              f"{' (cast ' + format(cast_s, '.3f') + ' s)' if tag == 'mixed' else ''} "
              f"launches={ {k: v for k, v in launches.items() if v} }", flush=True)
        check(tuple(res.x.shape) == (4, SWITCH_N) and bool(torch.isfinite(res.x).all()), f"mixed-switch {tag} x")
        check(rel < 1e-10, f"mixed-switch {tag} relative residual {rel:.3e} >= 1e-10")
        check(not k1_k8(launches), f"a pentadiagonal level reached a kernel ({tag}): {launches}")
        got = counts if tag == "mixed" else (counts,)
        exp = want if tag == "mixed" else (want,)
        check(all(abs(g - e) <= 2 for g, e in zip(got, exp)), f"mixed-switch {tag} counts {counts}, the CPU's {want}")
        ref[tag] = dict(counts=tuple(got), solve_s=solve_s)
        del res
    whole = {"h": h, "b": b}
    del h, h32, b, solves
    torch.cuda.empty_cache()
    sharded = one_rank_family("switch", whole, bk, ref)

    n, k = SWITCH_ODD
    h, b, timings = switch_problem(n, k)
    check(h.levels[-1].a.n_blocks == 15625 and isinstance(h.coarse, PaddedBTCoarseSolver) and h.coarse.n == 31250,
          f"odd mixed-switch chain: coarsest {h.levels[-1].a.n_blocks} blocks, {type(h.coarse).__name__}")
    res, solve_s, launches = timed_solve(lambda: multigrid(h, torch.zeros_like(b), b, 100, 1e-10,
                                                           compute_error=False), bk)
    t0 = time.perf_counter()
    fine_host = h.levels[0]._replace(a=BlockPenta(*(t.cpu() for t in h.levels[0].a)))
    b_flat = b.cpu().T.reshape(-1).numpy()
    x_direct = torch.from_numpy(fine_direct_solve(fine_host, b_flat)).reshape(n, 4).T
    direct_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cond, x_ref, last = fine_refined_solve(fine_host, b_flat)
    refine_s = time.perf_counter() - t0
    x_direct = x_direct.to("cuda")
    deep = multigrid(h, torch.zeros_like(b), b, 100, 1e-14, compute_error=False)

    def gap(x):
        return float((x - x_direct).abs().max() / x_direct.abs().max())

    def gap_ref(x):  # in extended precision on the host
        x = x.cpu().T.reshape(-1).numpy().astype(np.longdouble)
        return float(np.abs(x - x_ref).max() / np.abs(x_ref).max())

    rel, rel_direct, rel_deep = (level_rel_residual(h, b, x) for x in (res.x, x_direct, deep.x))
    print(f"odd mixed-switch chain {b.numel()} DoF, {h.n_levels} levels, coarsest {h.levels[-1].a.n_blocks} blocks "
          f"({type(h.coarse).__name__}, {h.coarse.n} DoF): setup host_s={timings['host']:.3f} multigrid f64 "
          f"solve_s={solve_s:.3f} iterations={res.iterations} (port on the CPU {SWITCH_PORT_CPU['odd multigrid']}) "
          f"rel_residual_f64={rel:.3e} launches={ {k: v for k, v in launches.items() if v} }; banded direct solve "
          f"(host, {direct_s:.3f} s) rel_residual_f64={rel_direct:.3e}; max|x - x_banded| / max|x_banded| = "
          f"{gap(res.x):.3e} at tol 1e-10, {gap(deep.x):.3e} at tol 1e-14 ({deep.iterations} iterations, "
          f"rel_residual_f64={rel_deep:.3e}); within 1e-8: {'yes' if gap(res.x) < 1e-8 else 'no'}", flush=True)
    print(f"odd mixed-switch chain witness: 1-norm condition estimate {cond:.3e} (times float64 eps "
          f"{cond * np.finfo(np.float64).eps:.3e}); banded solution refined with extended-precision residuals "
          f"({refine_s:.3f} s on the host; last correction {last:.3e} of max|x|): max|x - x_refined| / max|x_refined| = {gap_ref(x_direct):.3e} banded, "
          f"{gap_ref(res.x):.3e} multigrid at tol 1e-10, {gap_ref(deep.x):.3e} at tol 1e-14", flush=True)
    check(rel < 1e-10 and rel_deep < 1e-13, f"odd mixed-switch relative residuals {rel:.3e}, {rel_deep:.3e}")
    check(rel_direct < 1e-12, f"the banded direct solve's relative residual {rel_direct:.3e}")
    # for information only (the residuals above are the check): two float64
    # solutions of this c_dir = 1000 n operator with residuals near 1e-15
    # differ by up to its condition number times eps; the witness line says
    # which one is the accurate one
    check(max(gap(res.x), gap(deep.x)) < 1e-3,
          f"odd mixed-switch x against the banded direct solve: {gap(res.x):.3e} (tol 1e-14: {gap(deep.x):.3e})")
    check(not k1_k8(launches), f"the odd pentadiagonal chain reached a kernel: {launches}")
    check(abs(res.iterations - SWITCH_PORT_CPU["odd multigrid"]) <= 2,
          f"odd mixed-switch count {res.iterations}, the CPU's {SWITCH_PORT_CPU['odd multigrid']}")
    del h, b, res
    torch.cuda.empty_cache()
    return {"sharded": sharded, "ref": ref}


# ---------------------------------------------------------------------------
# The ragged, mixed-switch and scattered families sharded (shard_hierarchy)
# ---------------------------------------------------------------------------


def family_problem(fam: str) -> dict:
    """A family's whole problem as its unsharded phase builds it: the ragged
    slice on the card, the mixed-switch and scattered slices on the host;
    ``{"h": hierarchy, "b": rhs}``."""
    from agglomerationmultigrid1d_tpu_torch.models import (
        interleaved_pair_groups,
        poisson_dg_hierarchy,
        poisson_scattered_hierarchy,
        poisson_switch_hierarchy,
    )

    if fam == "ragged":
        prob = poisson_dg_hierarchy(**RAGGED_SLICE, device="cuda")
    elif fam == "switch":
        prob = poisson_switch_hierarchy(SWITCH_N, SWITCH_COARSEN, device="cpu")
    else:
        prob = poisson_scattered_hierarchy(n=SCATTERED_N, p_dg=1, device="cpu",
                                           groups_per_level=interleaved_pair_groups(SCATTERED_N, SCATTERED_COARSEST))
    return {"h": prob.hierarchy, "b": prob.b}


def exchange_errors(h, hs, grp) -> dict:
    """Every level's matvec and every transfer's prolongation and restriction
    on the rank's parts of random float64 vectors (the same on every rank),
    through the sharded hierarchy ``hs``, gathered, against the whole
    hierarchy ``h``'s (on its own device): the largest difference over the
    whole result's max, per kind.  What each new exchange (the pentadiagonal
    halo, the block-COO plan, the straddling and scattered transfers) moves
    at the slice's own sizes."""
    from agglomerationmultigrid1d_tpu_torch.models.hierarchy import operator_data
    from agglomerationmultigrid1d_tpu_torch.models.solvers import (
        _group,
        _prolong,
        _restrict,
        level_matvec,
        transfer_prolong,
        transfer_restrict,
    )
    from agglomerationmultigrid1d_tpu_torch.parallel import all_gather_cols, local_range

    dev = operator_data(h.levels[0].a).device
    gen = torch.Generator().manual_seed(SEED)
    vecs = [torch.randn((lv.a.block_size, lv.a.n_blocks), generator=gen, dtype=torch.float64) for lv in h.levels]

    def mine(k):
        v = vecs[k].to(grp.device)
        return v[..., slice(*local_range(v.shape[-1], grp))] if hs.layout.sharded[k] else v

    def gathered(k, t):
        return all_gather_cols(t, grp) if hs.layout.sharded[k] else t

    def err(got, want):
        return float((got.to(want.device) - want).abs().max() / want.abs().max())

    errs = {"matvec": 0.0, "prolong": 0.0, "restrict": 0.0}
    for k, lv in enumerate(hs.levels):
        want = level_matvec(h.levels[k], vecs[k].to(dev))
        errs["matvec"] = max(errs["matvec"], err(gathered(k, level_matvec(lv, mine(k), _group(hs, k))), want))
    for k, t in enumerate(h.transfers):
        want = transfer_prolong(t, vecs[k + 1].to(dev))
        errs["prolong"] = max(errs["prolong"], err(gathered(k, _prolong(hs, k, mine(k + 1))), want))
        want = transfer_restrict(t, vecs[k].to(dev))
        errs["restrict"] = max(errs["restrict"], err(gathered(k + 1, _restrict(hs, k, mine(k))), want))
    return errs


def sharded_family(fam: str, whole: dict, grp, bk) -> dict:
    """Shard the family's whole problem (``whole``, whose entries are taken
    out and dropped once sharded: the card then holds only the rank's
    shards) over ``grp``, cast the float32 copy, and run
    ``FAMILY_SOLVERS[fam]`` on the shards, the launch counts set to 0 before
    each, after a warm-up run: per solve its counts, seconds, launches and
    relative residual (recomputed in float64 on the shards), rank 0 also
    the whole float64 x; the rank's peak device memory over the solves (its
    shards resident); and, before the whole problem is dropped, the
    sharded operations' errors against the whole ones (``exchange_errors``)."""
    from agglomerationmultigrid1d_tpu_torch.models import (
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        multigrid_progressive,
    )
    from agglomerationmultigrid1d_tpu_torch.models.solvers import _group, _norm, level_matvec
    from agglomerationmultigrid1d_tpu_torch.parallel import shard_hierarchy, shard_vector, unshard_vector

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = shard_hierarchy(whole["h"], grp)
    bl = shard_vector(whole["b"], grp, hs)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    errors = exchange_errors(whole["h"], hs, grp)
    whole.clear()
    t0 = time.perf_counter()
    h32 = make_low_precision_hierarchy(hs)
    torch.cuda.synchronize()
    shard_s += time.perf_counter() - t0
    torch.cuda.empty_cache()
    g0 = _group(hs, 0)
    solves = {
        "multigrid": lambda: multigrid(hs, torch.zeros_like(bl), bl, 100, 1e-10, compute_error=False),
        "mixed": lambda: multigrid_mixed(hs, h32, torch.zeros_like(bl), bl, 80, 1e-10),
        "progressive": lambda: multigrid_progressive(hs, h32, torch.zeros_like(bl), bl, 80, 1e-10),
    }
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for tag in FAMILY_SOLVERS[fam]:
        solves[tag]()  # a warm-up, as the unsharded phases' timed_solve runs
        torch.cuda.synchronize()
        bk.reset_launch_counts()
        t0 = time.perf_counter()
        res = solves[tag]()
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        launches = {k: v for k, v in bk.LAUNCHES.items() if v}
        x = res.x.to(torch.float64)
        rel = float(_norm(bl - level_matvec(hs.levels[0], x, g0), g0) / _norm(bl, g0))
        x_whole = unshard_vector(x, hs) if tag == "multigrid" else None
        runs[tag] = dict(counts=(res.iterations,) if tag != "mixed" else (res.iterations, res.inner_cycles),
                         solve_s=solve_s, rel=rel, launches=launches,
                         x=x_whole.cpu().numpy() if x_whole is not None and grp.rank == 0 else None)
        del res, x, x_whole
    peak = torch.cuda.max_memory_allocated()
    out = dict(flags=hs.layout.sharded, shard_s=shard_s, peak=peak, runs=runs, errors=errors,
               local=[lv.a.n_el if hasattr(lv.a, "n_el") else lv.a.n_blocks for lv in hs.levels])
    del hs, h32, bl
    torch.cuda.empty_cache()
    return out


def check_family_run(fam: str, where: str, got: dict, ref: dict) -> None:
    """Hold a sharded family run to the unsharded one (``ref``: counts and
    seconds per solve): the sharded matvecs and transfers within 1e-13 of
    the whole ones; float64 ``multigrid`` its count, the float32 inner
    solves within 1 outer step / 2 inner cycles, every relative residual
    below 1e-10; the fused kernels where the family reaches them (the
    ragged and scattered slices' block-tridiagonal levels, an edge pair per
    sharded smoothing), none on the mixed-switch slice."""
    print(f"sharded {fam} slice, {where}: the sharded matvecs and transfers against the whole ones, largest "
          f"difference over max|whole| {got['errors']}", flush=True)
    check(max(got["errors"].values()) <= 1e-13, f"sharded {fam} ({where}): exchange errors {got['errors']}")
    for tag, run in got["runs"].items():
        want = ref[tag]["counts"]
        launches = run["launches"]
        print(f"sharded {fam} slice {tag}, {where}, sharded={got['flags']}: counts={run['counts']} (unsharded "
              f"{want}) rel_residual_f64={run['rel']:.3e} solve_s={run['solve_s']:.3f} (unsharded "
              f"{ref[tag]['solve_s']:.3f}, ratio {run['solve_s'] / ref[tag]['solve_s']:.2f}) launches={launches}",
              flush=True)
        check(run["rel"] < 1e-10, f"sharded {fam} {tag} ({where}) relative residual {run['rel']:.3e}")
        if tag == "multigrid":
            check(run["counts"] == want, f"sharded {fam} f64 multigrid ({where}): {run['counts']} against {want}")
            check(not k1_k8(launches), f"a float64 solve launched a kernel: {launches}")
        else:
            check(abs(run["counts"][0] - want[0]) <= 1 and (len(want) == 1 or abs(run["counts"][1] - want[1]) <= 2),
                  f"sharded {fam} {tag} ({where}): {run['counts']} against {want}")
            if fam == "switch":
                check(not k1_k8(launches), f"a pentadiagonal level reached a kernel ({where}, {tag}): {launches}")
            else:
                used = ("multisweep", "multisweep_residual", "bt_matvec", "edge_pair", "edge_pair_residual")
                check(all(launches.get(k, 0) > 0 for k in used), f"sharded {fam} {tag} ({where}) skipped a kernel: "
                      f"{launches}")


def one_rank_family(fam: str, whole: dict, bk, ref: dict) -> dict:
    """A family on a one-rank NCCL group (``sharded_family``), held to the
    unsharded runs ``ref``; returns the run (its x and peak are what the
    two-rank phase is held to)."""
    from agglomerationmultigrid1d_tpu_torch.parallel import initialize, shutdown

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        grp = initialize(0, 1, store_path=os.path.join(td, "store"))
        try:
            got = sharded_family(fam, whole, grp, bk)
        finally:
            shutdown()
    print(f"sharded {fam} slice on one NCCL rank: shard_s={got['shard_s']:.3f} peak_mem_bytes={got['peak']} "
          f"phase_s={time.perf_counter() - t0:.3f}", flush=True)
    check_family_run(fam, "one NCCL rank", got, ref)
    return got


def strip_bound(name, bs, s=STRIP, sides=1) -> tuple:
    """(bound_ms, bound_by) of one K7 strip launch (``sides=1``) or one
    edge-pair launch (``sides=2``): per side, read the ``s`` output columns
    and ``reach`` columns on either side of them once (ML, MU, S^-1, x, b;
    A_D of the outputs with the residual), write the ``s`` columns; the
    operations of the ``s`` output columns."""
    residual = name in ("K7r", "K7cr")
    reach = 3 + (1 if residual else 0)
    nbytes = sides * 4 * ((s + 2 * reach) * (3 * bs * bs + 2 * bs) + s * (bs * bs if residual else 0)
                          + s * bs * (2 if residual else 1))
    t_bytes, t_ops = nbytes / PEAK_BPS * 1e3, sides * col_ops(name, bs) * s / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pack_bound(bs, g=GHOST) -> tuple:
    """(bound_ms, bound_by) of one packing launch with both neighbours: the
    ``g`` edge columns of x and b a side read once, the two messages written
    once; no arithmetic."""
    return 4 * 2 * (2 * 2 * bs * g) / PEAK_BPS * 1e3, "bytes"


def strip_plain(plain, ops, x, b, ghosts, side: int, s=STRIP):
    """The plain version of one strip launch: the plain ghosted sweeps on the
    shard's ``s + g`` edge columns, with the exchanged ghosts outside and
    zeros inside (the ``s`` columns do not reach them), cropped to the strip."""
    gops, gvec = ghosts
    g = gops.shape[-1] // 2
    cut = slice(None, s + g) if side == 0 else slice(-(s + g), None)
    outer = slice(None, g) if side == 0 else slice(g, None)

    def ghost(t):
        pair = [t[..., outer], torch.zeros_like(t[..., :g])]
        return torch.cat(pair if side == 0 else pair[::-1], dim=-1)

    out = plain([t[..., cut] for t in ops], x[:, cut], b[:, cut], (ghost(gops), ghost(gvec)))
    crop = slice(None, s) if side == 0 else slice(-s, None)
    return tuple(t[:, crop] for t in out) if isinstance(out, tuple) else out[:, crop]


def ghost_inputs(bs: int, g: int, seed: int):
    """Non-zero K7 ghosts ``(gops, gvec)``: the columns of another random
    operator of the same kind (ML, MU, S^-1 and x, b), 2 g wide."""
    _, sinv, ml, mu, x, b = kernel_inputs(bs, 2 * g, seed)
    return torch.stack([ml, mu, sinv]).contiguous(), torch.stack([x, b]).contiguous()


def k7_forms(bk, coef):
    """label -> (K7 wrapper, its plain version, residual?), each taking
    ``(ops, x, b, ghosts, **kw)`` with ``ops = (ML, MU, S^-1, A_D)``."""
    return {
        "K7": (lambda o, x, b, gh, **kw: bk.multisweep(*o[:3], x, b, ghosts=gh, **kw),
               lambda o, x, b, gh: bk.multisweep_plain(*o[:3], x, b, ghosts=gh), False),
        "K7r": (lambda o, x, b, gh, **kw: bk.multisweep_residual(*o, x, b, ghosts=gh, **kw),
                lambda o, x, b, gh: bk.multisweep_residual_plain(*o, x, b, ghosts=gh), True),
        "K7c": (lambda o, x, b, gh, **kw: bk.chebyshev_multisweep(*o[:3], x, b, coef, ghosts=gh, **kw),
                lambda o, x, b, gh: bk.chebyshev_multisweep_plain(*o[:3], x, b, coef, ghosts=gh), False),
        "K7cr": (lambda o, x, b, gh, **kw: bk.chebyshev_multisweep_residual(*o, x, b, coef, ghosts=gh, **kw),
                 lambda o, x, b, gh: bk.chebyshev_multisweep_residual_plain(*o, x, b, coef, ghosts=gh), True),
    }


def edge_forms(bk, coef):
    """label -> (edge-pair launch ``(plan, x, b, out)``, its plain version
    ``(ops, x, b, gops, from_left, from_right)`` returning the left and right
    edge columns of x, then of r with the residual)."""
    return {
        "K7": (lambda p, x, b, out: p.sweep_edges(x, b, out),
               lambda o, x, b, *gh: bk.multisweep_edges_plain(*o[:3], x, b, *gh)),
        "K7r": (lambda p, x, b, out: p.sweep_edges(x, b, out),
                lambda o, x, b, *gh: bk.multisweep_residual_edges_plain(*o, x, b, *gh)),
        "K7c": (lambda p, x, b, out: p.chebyshev_edges(x, b, out, coef),
                lambda o, x, b, *gh: bk.chebyshev_multisweep_edges_plain(*o[:3], x, b, coef, *gh)),
        "K7cr": (lambda p, x, b, out: p.chebyshev_edges(x, b, out, coef),
                 lambda o, x, b, *gh: bk.chebyshev_multisweep_residual_edges_plain(*o, x, b, coef, *gh)),
    }


def edge_plans(bk, ops, ghosts):
    """The phase's plans over one shard: with both neighbours and the
    ghosts ``(gops, gvec)`` as received messages; and per side ``(a plan
    without that neighbour, a plan with explicit zero ghosts there)``."""
    gops, gvec = ghosts
    g = gops.shape[-1] // 2
    halves = (slice(None, g), slice(g, None))

    def plan(gops_, left=True, right=True, zero=None):
        p = bk.EdgePlan(*ops, gops_, left=left, right=right)
        for side, buf in enumerate((p.from_left, p.from_right)):
            if buf is not None and side != zero:
                buf.copy_(gvec[..., halves[side]])
        return p

    nulls = []
    for side in (0, 1):
        zeroed = gops.clone()
        zeroed[..., halves[side]] = 0
        nulls.append((plan(gops, left=side != 0, right=side != 1), plan(zeroed, zero=side)))
    return plan(gops), nulls


def k7_runs(bk, ops, x, b, ghosts, coef):
    """label -> (whole-shard K7 launch, plain version) on the same tensors."""
    return {name: ((lambda k=kern: k(ops, x, b, ghosts)), (lambda p=plain: p(ops, x, b, ghosts)))
            for name, (kern, plain, _) in k7_forms(bk, coef).items()}


def phase_k7(bk) -> tuple:
    """K7's four forms and the edge pair's against their plain versions with
    random non-zero ghosts, at every sharded slice level's local shape
    (timed at the finest): the two in-place edge strips, then the edge pair
    against its plain version, against the strips, with a null side, and
    the packing kernel; then K7's whole-shard form.  Returns (strip results,
    edge-pair results, packing results, whole-shard results)."""
    coef = bk.chebyshev_coefficients(*CHEB_INTERVAL, 3)
    forms, eforms = k7_forms(bk, coef), edge_forms(bk, coef)
    strips = {name: {"max_abs_err": 0.0} for name in forms}
    edges = {name: {"max_abs_err": 0.0, "max_vs_strips": 0.0} for name in forms}
    pack = {"max_abs_err": 0.0}
    sentinel = 7.0
    crops = (slice(None, STRIP), slice(-STRIP, None))
    for bs, n in SLICE_SHARDED:
        a, sinv, ml, mu, x, b = kernel_inputs(bs, n, SEED + 11 * bs + n)
        ops = (ml, mu, sinv, a.diag)
        ghosts = ghost_inputs(bs, GHOST, SEED + 13 * bs + n)
        plan, null_plans = edge_plans(bk, ops, ghosts)
        headline = (bs, n) == SLICE_SHARDED[0]
        line = [f"K7 edge strips bs={bs} n={n} ghosts={GHOST} cols=(0,{STRIP}),({n - STRIP},{n}):"]
        eline = [f"edge pair bs={bs} n={n} ghosts={GHOST} (err vs plain / diff vs the two strips):"]
        for name, (kern, plain, residual) in forms.items():
            want = plain(ops, x, b, ghosts)
            want = want if residual else (want,)
            out = tuple(torch.full_like(x, sentinel) for _ in want)
            for cols in ((0, STRIP), (n - STRIP, n)):
                kern(ops, x, b, ghosts, out=out if residual else out[0], cols=cols)
            torch.cuda.synchronize()
            scale = max(float(w_.abs().max()) for w_ in want)
            err = 0.0
            for o_, w_ in zip(out, want):
                for crop in (slice(None, STRIP), slice(-STRIP, None)):
                    err = max(err, float((o_[:, crop] - w_[:, crop]).abs().max()))
                check(bool(torch.isfinite(o_[:, :STRIP]).all() and torch.isfinite(o_[:, -STRIP:]).all()),
                      f"{name} strip non-finite at {bs},{n}")
                check(bool((o_[:, STRIP:-STRIP] == sentinel).all()), f"{name} strip wrote outside cols at {bs},{n}")
            for side in (0, 1):  # the strip window's plain version is the whole shard's, cropped
                ref = strip_plain(plain, ops, x, b, ghosts, side)
                ref = ref if residual else (ref,)
                crop = slice(None, STRIP) if side == 0 else slice(-STRIP, None)
                d = max(float((r_ - w_[:, crop]).abs().max()) for r_, w_ in zip(ref, want))
                check(d <= TOL * scale, f"{name} strip window plain differs from the whole shard's: {d}")
            check(err <= TOL * scale, f"{name} strips differ from plain at bs={bs} n={n}: {err} > {TOL} * {scale}")
            r = strips[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if headline:
                ms = time_ms(lambda: kern(ops, x, b, ghosts, out=out if residual else out[0], cols=(0, STRIP)))
                plain_ms = time_ms(lambda: strip_plain(plain, ops, x, b, ghosts, 0))
                bound_ms, bound_by = strip_bound(name, bs)
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
                line.append(f"{name} err={err:.3e} (rel {err / scale:.2e}) strip_ms={ms:.4f} "
                            f"strip_plain_ms={plain_ms:.4f} bound_ms={bound_ms:.2e};")
            else:
                line.append(f"{name} err={err:.3e};")

            # the edge pair: one launch for both edges, ghosts from the plan's messages
            pair, pair_plain = eforms[name]
            fresh = lambda: tuple(torch.full_like(x, sentinel) for _ in want)  # noqa: E731
            arg = lambda o: o if residual else o[0]  # noqa: E731
            eout = fresh()
            pair(plan, x, b, arg(eout))
            torch.cuda.synchronize()
            ref = pair_plain(ops, x, b, ghosts[0], plan.from_left, plan.from_right)
            e_err = e_diff = 0.0
            for i, (e_, o_) in enumerate(zip(eout, out)):
                for side, crop in enumerate(crops):
                    check(bool(torch.isfinite(e_[:, crop]).all()), f"{name} edge pair non-finite at {bs},{n}")
                    e_err = max(e_err, float((e_[:, crop] - ref[2 * i + side]).abs().max()))
                    e_diff = max(e_diff, float((e_[:, crop] - o_[:, crop]).abs().max()))
                check(bool((e_[:, STRIP:-STRIP] == sentinel).all()), f"{name} edge pair wrote outside the edges at {bs},{n}")
            check(e_err <= TOL * scale, f"{name} edge pair differs from plain at bs={bs} n={n}: {e_err} > {TOL} * {scale}")
            check(e_diff <= EDGE_TOL * scale,
                  f"{name} edge pair differs from the two strips at bs={bs} n={n}: {e_diff} > {EDGE_TOL} * {scale}")
            for side, (null_plan, zero_plan) in enumerate(null_plans):  # a ring end is the zero boundary
                outs = []
                for p_ in (null_plan, zero_plan):
                    outs.append(fresh())
                    pair(p_, x, b, arg(outs[-1]))
                torch.cuda.synchronize()
                check(all(torch.equal(n_, z_) for n_, z_ in zip(*outs)),
                      f"{name} edge pair: a null {'left' if side == 0 else 'right'} message differs from zero ghosts at {bs},{n}")
            er = edges[name]
            er["max_abs_err"] = max(er["max_abs_err"], e_err)
            er["max_vs_strips"] = max(er["max_vs_strips"], e_diff)
            if headline:
                both = lambda: [kern(ops, x, b, ghosts, out=arg(out), cols=c) for c in ((0, STRIP), (n - STRIP, n))]  # noqa: E731
                one = lambda: pair(plan, x, b, arg(eout))  # noqa: E731
                ms, strips_ms = time_ms(one), time_ms(both)
                plain_ms = time_ms(lambda: pair_plain(ops, x, b, ghosts[0], plan.from_left, plan.from_right))
                bound_ms, bound_by = strip_bound(name, bs, sides=2)
                er.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, two_strips_ms=strips_ms,
                          host_us=host_us(one), two_strips_host_us=host_us(both))
                eline.append(f"{name} {e_err:.3e} / {e_diff:.3e} pair_ms={ms:.4f} two_strips_ms={strips_ms:.4f} "
                             f"pair_host_us={er['host_us']:.2f} two_strips_host_us={er['two_strips_host_us']:.2f} "
                             f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.2e};")
            else:
                eline.append(f"{name} {e_err:.3e} / {e_diff:.3e};")

        # the packing kernel, with both neighbours and with one
        for p_ in (plan, null_plans[0][0], null_plans[1][0]):
            p_.pack(x, b)
            torch.cuda.synchronize()
            wants = bk.pack_edges_plain(x, b, GHOST, p_.to_left is not None, p_.to_right is not None)
            for got_, want_ in zip((p_.to_left, p_.to_right), wants):
                check((got_ is None) == (want_ is None) and (got_ is None or torch.equal(got_, want_)),
                      f"pack_edges differs from plain at bs={bs} n={n}")
        eline.append("pack_edges exact; null sides exact;")
        if headline:
            floor_ms, floor_us = time_ms(bk.launch_floor), host_us(bk.launch_floor)
            pack_ms, pack_us = time_ms(lambda: plan.pack(x, b)), host_us(lambda: plan.pack(x, b))
            pack_plain_ms = time_ms(lambda: bk.pack_edges_plain(x, b, GHOST))
            bound_ms, bound_by = pack_bound(bs)
            pack.update(ms=pack_ms, plain_ms=pack_plain_ms, bound_ms=bound_ms, bound_by=bound_by, host_us=pack_us,
                        floor_ms=floor_ms, floor_host_us=floor_us)
            eline.append(f"pack_ms={pack_ms:.4f} pack_host_us={pack_us:.2f} pack_plain_ms={pack_plain_ms:.4f} "
                         f"launch_floor_ms={floor_ms:.4f} launch_floor_host_us={floor_us:.2f};")
        print(" ".join(line), flush=True)
        print(" ".join(eline), flush=True)
        del a, sinv, ml, mu, x, b, ghosts, ops, plan, null_plans
        torch.cuda.empty_cache()

    whole = {}
    for bs, n in K7_SHAPES:
        a, sinv, ml, mu, x, b = kernel_inputs(bs, n, SEED + 11 * bs + n)
        ghosts = ghost_inputs(bs, GHOST, SEED + 13 * bs + n)
        line = [f"K7 whole-shard form (overlap=False / narrow shards; the four-shards phase launches it) bs={bs} n={n} "
                f"ghosts={GHOST}:"]
        for name, (kern, plain) in k7_runs(bk, (ml, mu, sinv, a.diag), x, b, ghosts, coef).items():
            hold(name, kern, plain, bs, n, whole, line)
        print(" ".join(line), flush=True)
        del a, sinv, ml, mu, x, b, ghosts
        torch.cuda.empty_cache()
    return strips, edges, pack, whole


def phase_four_shards(bk) -> dict:
    """Four virtual shards of one (4, 4,194,304) problem: K7 on each with the
    neighbours' STRIP edge columns as ghosts (zeros at the ends), stitched,
    against K2 / K1 / K5 / K5 + residual on the whole problem.  The path that
    launches K7 (the whole-shard ghosted form): returns its launch counts,
    counted from zero."""
    bs, n, world = 4, 4194304, 4
    bk.reset_launch_counts()
    coef = bk.chebyshev_coefficients(*CHEB_INTERVAL, 3)
    a, sinv, ml, mu, x, b = kernel_inputs(bs, n, SEED + 4)
    ops = (ml, mu, sinv, a.diag)
    whole = {
        "K7": bk.multisweep(ml, mu, sinv, x, b),
        "K7r": bk.multisweep_residual(ml, mu, sinv, a.diag, x, b),
        "K7c": bk.chebyshev_multisweep(ml, mu, sinv, x, b, coef),
        "K7cr": bk.chebyshev_multisweep_residual(ml, mu, sinv, a.diag, x, b, coef),
    }
    parts = {name: [] for name in whole}
    g = STRIP
    for r in range(world):
        lo, hi = r * n // world, (r + 1) * n // world

        def ghost(t):
            left = t[..., lo - g : lo] if r > 0 else torch.zeros_like(t[..., :g])
            right = t[..., hi : hi + g] if r < world - 1 else torch.zeros_like(t[..., :g])
            return torch.cat([left, right], dim=-1)

        ghosts = (torch.stack([ghost(m) for m in ops[:3]]).contiguous(), torch.stack([ghost(x), ghost(b)]).contiguous())
        cut = [t[..., lo:hi].contiguous() for t in (*ops, x, b)]
        for name, (kern, _) in k7_runs(bk, cut[:4], cut[4], cut[5], ghosts, coef).items():
            parts[name].append(kern())
    torch.cuda.synchronize()
    line = [f"four shards of (4, {n}), ghosts {g}, stitched against the unsharded kernels:"]
    for name, want in whole.items():
        want = want if isinstance(want, tuple) else (want,)
        got = parts[name]
        got = tuple(torch.cat([p[i] if isinstance(p, tuple) else p for p in got], dim=-1) for i in range(len(want)))
        err = max(float((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
        scale = max(float(w_.abs().max()) for w_ in want)
        check(err <= TOL * scale, f"four-shard {name} differs from {K7_FORMS[name][2]}: {err} > {TOL} * {scale}")
        line.append(f"{name} vs {K7_FORMS[name][2]} err={err:.3e} (rel {err / scale:.2e});")
    launches = {K7_FORMS[k][1]: bk.LAUNCHES[K7_FORMS[k][1]] for k in K7_FORMS}
    print(" ".join(line), f"launches={launches}", flush=True)
    check(all(v == world for v in launches.values()), f"the four-shards phase skipped a K7 form: {launches}")
    del a, sinv, ml, mu, x, b, whole, parts
    torch.cuda.empty_cache()
    return launches


def phase_sweep_bench(bk, kernels: dict, k7_whole: dict) -> dict:
    """``bench.py:bench_sweeps`` on the port at (4, 4,194,304): K4, the
    achievable bandwidth of the multisweep's operand mix, and K8, the A-form
    single sweep; counts reset just before, so this path's launches are K4's
    and K8's.  Prints every multisweep-family kernel's share of K4's GB/s
    and of the data-sheet peak (K7's from its whole-shard form: a strip
    launch moves too few bytes for a rate)."""
    bs, n = SHAPES[0]
    a, sinv, ml, mu, x, b = kernel_inputs(bs, n, SEED + 99)
    bk.reset_launch_counts()
    stream_ms = time_ms(lambda: bk.stream_kernel(ml, mu, sinv, x, b))
    sweep_ms = time_ms(lambda: bk.block_jacobi_sweep(a, sinv, x, b))
    launches = {k: bk.LAUNCHES[k] for k in ("stream_kernel", "block_jacobi_sweep")}
    stream_gbps = col_bytes("K4", bs) * n / (stream_ms * 1e-3) / 1e9
    sweep_gbps = col_bytes("K8", bs) * n / (sweep_ms * 1e-3) / 1e9
    line = [f"sweep bench bs={bs} n={n}: K4 stream ms={stream_ms:.4f} GB/s={stream_gbps:.1f} "
            f"({100 * stream_gbps * 1e9 / PEAK_BPS:.1f} % of 3.35 TB/s); K8 sweep ms={sweep_ms:.4f} "
            f"GB/s={sweep_gbps:.1f}; shares of K4 / of the peak:"]
    for name in ("K1", "K2", "K5", "K5r", "K7", "K7r", "K7c", "K7cr", "K8"):
        gbps = sweep_gbps if name == "K8" else (k7_whole if name in K7_FORMS else kernels)[name]["gbps"]
        label = f"{name} (whole shard)" if name in K7_FORMS else name
        line.append(f"{label} {100 * gbps / stream_gbps:.1f} % / {100 * gbps * 1e9 / PEAK_BPS:.1f} %;")
    print(" ".join(line), f"launches={launches}", flush=True)
    check(all(v > 0 for v in launches.values()), f"the sweep bench skipped a kernel: {launches}")
    del a, sinv, ml, mu, x, b
    torch.cuda.empty_cache()
    return launches


def timed_solve(fn, bk) -> tuple:
    """``fn()`` after a warm-up call, with the launch counts set to 0 just
    before the timed call: (result, seconds, launches)."""
    fn()
    torch.cuda.synchronize()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(bk.LAUNCHES)


def phase_sharded(bk) -> dict:
    """The element-sharded solve on a one-rank NCCL group (the whole path,
    the overlapped schedule included; a one-rank ring exchanges nothing, so
    both messages are null: the zeros of the global boundary).  Returns the
    edge-pair launches of its paths and the damped one-rank solution."""
    from agglomerationmultigrid1d_tpu_torch.models import (
        chebyshev_hierarchy,
        make_low_precision_hierarchy,
        multigrid,
        multigrid_mixed,
        poisson_dg_hierarchy,
    )
    from agglomerationmultigrid1d_tpu_torch.parallel import (
        edge_plan,
        initialize,
        operator_ghosts,
        shard_hierarchy,
        shard_vector,
        sharded_multisweep,
        shutdown,
        unshard_vector,
    )

    out = {}
    with tempfile.TemporaryDirectory() as td:
        grp = initialize(0, 1, store_path=os.path.join(td, "store"))
        try:
            prob = poisson_dg_hierarchy(**SLICE, device="cuda")
            b = prob.b
            for cheb in (False, True):
                tag = "chebyshev" if cheb else "damped"
                h = chebyshev_hierarchy(prob.hierarchy) if cheb else prob.hierarchy
                h32 = make_low_precision_hierarchy(h)
                hs, h32s, bl = shard_hierarchy(h, grp), shard_hierarchy(h32, grp), shard_vector(b, grp)
                flags = h32s.layout.sharded
                local = [(lv.a.block_size, lv.a.n_blocks) for lv, sh in zip(h32s.levels, flags) if sh]
                check(local == SLICE_SHARDED, f"the sharded levels' local shapes {local} are not K7's phase's")
                ref, ref_s, _ = timed_solve(lambda: multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10), bk)
                res, solve_s, launches = timed_solve(
                    lambda: multigrid_mixed(hs, h32s, torch.zeros_like(bl), bl, 80, 1e-10), bk
                )
                x = unshard_vector(res.x, hs)
                rel = rel_residual(prob, x)
                k7 = {label: launches[EDGE_FORMS[label]] for label in EDGE_FORMS}
                print(f"sharded {tag} slice, one-rank NCCL group, sharded={flags}: outer={res.iterations} "
                      f"inner_cycles={res.inner_cycles} (unsharded: {ref.iterations} / {ref.inner_cycles}) "
                      f"rel_residual_f64={rel:.3e} solve_s={solve_s:.3f} unsharded_solve_s={ref_s:.3f} "
                      f"ratio={solve_s / ref_s:.2f} K7_launches={k7} (the edge pair) launches={launches}", flush=True)
                check(rel < 1e-10, f"sharded {tag} relative residual {rel:.3e} >= 1e-10")
                check((res.iterations, res.inner_cycles) == (ref.iterations, ref.inner_cycles),
                      f"sharded {tag} counts differ from the unsharded solve's")
                used = ("K7c", "K7cr") if cheb else ("K7", "K7r")
                smoothings = res.inner_cycles * len(SLICE_SHARDED)  # pre (with the residual) and post, each
                check(all(k7[k] == smoothings for k in used),
                      f"the sharded {tag} solve did not launch one edge pair per smoothing ({smoothings}): {k7}")
                check(all(launches[K7_FORMS[k][1]] == 0 for k in K7_FORMS),
                      f"the sharded {tag} solve launched a K7 strip: {launches}")
                out.update({k: k7[k] for k in used})
                if not cheb:
                    out.update(x_one_rank=x, outer_one_rank=res.iterations, norm_b=float(torch.linalg.vector_norm(b)))
                del h, h32, hs, h32s, res, ref, x

            small = poisson_dg_hierarchy(**SMALL, device="cuda")
            hs, bl = shard_hierarchy(small.hierarchy, grp), shard_vector(small.b, grp)
            ref = multigrid(small.hierarchy, torch.zeros_like(small.b), small.b, 80, 1e-10, compute_error=False)
            res = multigrid(hs, torch.zeros_like(bl), bl, 80, 1e-10, compute_error=False)
            rel = rel_residual(small, unshard_vector(res.x, hs))
            print(f"sharded f64 multigrid {small.b.numel()} DoF: iterations={res.iterations} "
                  f"(unsharded {ref.iterations}) rel_residual={rel:.3e}", flush=True)
            check(rel < 1e-10 and res.iterations == ref.iterations, "sharded f64 multigrid")

            bs, n = SHAPES[0]  # the sharded smoother against K2: no cliff (bench.py:247-261)
            a, sinv, ml, mu, x, bb = kernel_inputs(bs, n, SEED + 5)
            gops = operator_ghosts(ml, mu, sinv, grp)  # exchanged once, as shard_hierarchy does
            plan = edge_plan(ml, mu, sinv, a.diag, gops, grp)  # and the level's plan, built once
            sharded_ms = time_ms(
                lambda: sharded_multisweep(grp, a, sinv, x, bb, ml=ml, mu=mu, op_ghosts=gops, plan=plan))
            plain_k2_ms = time_ms(lambda: bk.multisweep(ml, mu, sinv, x, bb))
            print(f"sharded_multisweep (overlapped, one rank) bs={bs} n={n}: ms={sharded_ms:.4f} "
                  f"K2 ms={plain_k2_ms:.4f} ratio={sharded_ms / plain_k2_ms:.2f}", flush=True)
        finally:
            shutdown()
    torch.cuda.empty_cache()
    return out


def _two_rank_child(rank: int, store_path: str, q) -> None:
    """One rank of the gloo phase: the sharded damped slice solve on the card."""
    try:
        from agglomerationmultigrid1d_tpu_torch.models import (
            make_low_precision_hierarchy,
            multigrid_mixed,
            poisson_dg_hierarchy,
        )
        from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk
        from agglomerationmultigrid1d_tpu_torch.parallel import (
            initialize,
            shard_hierarchy,
            shard_vector,
            shutdown,
            unshard_vector,
        )

        grp = initialize(rank, 2, store_path=store_path, device="cuda", backend="gloo", timeout_s=CHILD_TIMEOUT_S)
        prob = poisson_dg_hierarchy(**SLICE, device="cuda")
        h = shard_hierarchy(prob.hierarchy, grp)
        h32 = shard_hierarchy(make_low_precision_hierarchy(prob.hierarchy), grp)
        b = shard_vector(prob.b, grp)
        res, solve_s, launches = timed_solve(
            lambda: multigrid_mixed(h, h32, torch.zeros_like(b), b, 80, 1e-10), bk
        )
        x = unshard_vector(res.x, h)
        rel = rel_residual(prob, x)
        out = None
        if rank == 0:
            out = dict(outer=res.iterations, inner=res.inner_cycles, solve_s=solve_s, rel=rel,
                       launches=launches, flags=h32.layout.sharded, x=x.cpu().numpy())  # plain bytes, not a shared tensor
        shutdown()
        q.put((rank, "ok", out))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
        raise


def phase_two_ranks(one_rank: dict) -> int:
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device): spawned processes, each with a time limit; the kernels were
    built by this process first, so the children load the same library.
    Returns rank 0's packing launches (the path on which a rank has a
    neighbour to pack for)."""
    r0 = spawn_ranks(_two_rank_child, 2, CHILD_TIMEOUT_S, "two-rank gloo phase")[0]
    x1 = one_rank["x_one_rank"]
    diff = float((torch.from_numpy(r0["x"]).to(x1.device) - x1).abs().max())
    nb = one_rank["norm_b"]
    k7 = {k: r0["launches"][EDGE_FORMS[k]] for k in ("K7", "K7r")}
    packs = r0["launches"]["pack_edges"]
    print(f"two ranks on one card over gloo, sharded={r0['flags']}: outer={r0['outer']} inner_cycles={r0['inner']} "
          f"(one rank: {one_rank['outer_one_rank']}) rel_residual_f64={r0['rel']:.3e} solve_s={r0['solve_s']:.3f} "
          f"max|x - x_one_rank|={diff:.3e} ({diff / nb:.2e} of ||b||) K7_launches={k7} (the edge pair) "
          f"pack_edges_launches={packs}", flush=True)
    check(r0["rel"] < 1e-10, f"two-rank relative residual {r0['rel']:.3e} >= 1e-10")
    check(abs(r0["outer"] - one_rank["outer_one_rank"]) <= 1, "two-rank outer steps differ by more than one")
    check(diff <= 1e-9 * nb, f"two-rank solution differs from the one-rank one by {diff:.3e}")
    smoothings = r0["inner"] * len(SLICE_SHARDED)
    check(all(v == smoothings for v in k7.values()),
          f"the two-rank solve did not launch one edge pair per smoothing ({smoothings}): {k7}")
    check(packs == 2 * smoothings, f"the two-rank solve packed {packs} times in {2 * smoothings} smoothings")
    check(all(r0["launches"][K7_FORMS[k][1]] == 0 for k in K7_FORMS), "the two-rank solve launched a K7 strip")
    return packs


def phase_k6s(bk) -> dict:
    """K6s, K6 on one shard, at the north star's fine shape (2, 50,331,648):
    as one rank (no offset, no ghosts) against K6, as two ranks (25,165,824
    columns at offsets 0 and 25,165,824, each the other's ghost) and as four
    virtual shards, each shard against its plain version and the shards
    stitched against K6: all bit for bit, hi and lo.  Timed at the two-rank
    shard beside K6 on the same columns and the plain version; returns the
    kernels-line numbers."""
    bs, n = 2, NORTH_STAR_N
    g = torch.Generator(device="cuda").manual_seed(SEED + 17)
    rnd = lambda *s, scale=1.0: scale * torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    blocks = torch.stack([rnd(3, bs, bs, 2 * K6_BW + 1, scale=1e3), rnd(3, bs, bs, 2 * K6_BW + 1, scale=1e-4)]).contiguous()
    vecs = (rnd(bs, n), rnd(bs, n, scale=1e-8), rnd(bs, n, scale=1e3), rnd(bs, n, scale=1e-5))

    def ghost(c):
        return torch.stack([vecs[0][:, c], vecs[1][:, c]]).contiguous() if 0 <= c < n else None

    def shard(c0, c1):
        return (blocks, *(t[:, c0:c1].contiguous() for t in vecs), c0, n, ghost(c0 - 1), ghost(c1))

    def n_diff(got, want):
        return sum(int((a != b).sum()) for a, b in zip(got, want))

    whole = bk.ff_stencil_mid_defect(blocks, *vecs)
    one = bk.ff_stencil_shard_defect(blocks, *vecs, 0, n, None, None)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in one), "K6s non-finite")
    check(n_diff(one, whole) == 0, f"K6s as one rank differs from K6 in {n_diff(one, whole)} elements")
    del one
    line = [f"K6s bs={bs} n={n}: one rank equals K6 bit for bit;"]
    for world in (2, 4):
        parts = []
        for r in range(world):
            args = shard(r * n // world, (r + 1) * n // world)
            parts.append(bk.ff_stencil_shard_defect(*args))
            want = bk.ff_stencil_mid_defect_plain(*args)
            torch.cuda.synchronize()
            d = n_diff(parts[-1], want)
            check(d == 0, f"K6s rank {r} of {world} differs from its plain version in {d} elements")
            del want, args
        stitched = tuple(torch.cat([p[k] for p in parts], dim=1) for k in range(2))
        d = n_diff(stitched, whole)
        check(d == 0, f"K6s: {world} stitched shards differ from K6 in {d} elements")
        line.append(f"{world} shards each equal to its plain version and, stitched, to K6, bit for bit;")
        del parts, stitched
        torch.cuda.empty_cache()
    del whole
    args = shard(n // 2, n)  # rank 1 of 2: the left neighbour's column as its ghost
    ms = time_ms(lambda: bk.ff_stencil_shard_defect(*args))
    k6_ms = time_ms(lambda: bk.ff_stencil_mid_defect(*args[:5]))
    plain_ms = time_ms(lambda: bk.ff_stencil_mid_defect_plain(*args), reps=5)
    bound_ms, bound_by = bound("K6", bs, n // 2)
    gbps = col_bytes("K6", bs) * (n // 2) / (ms * 1e-3) / 1e9
    line.append(f"timed at (2, {n // 2}) with a ghost: ms={ms:.4f} K6_ms={k6_ms:.4f} plain_ms={plain_ms:.4f} "
                f"GB/s={gbps:.1f} bound_ms={bound_ms:.4f} ({bound_by})")
    print(" ".join(line), flush=True)
    del args, blocks, vecs
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, gbps=gbps, k6_ms=k6_ms)


def tensor_leaves(tree, path="", out=None) -> list:
    """``(path, tensor)`` of every tensor of nested NamedTuples / tuples /
    dataclasses, leaving out what only a sharded hierarchy has (its layout,
    K7's operator ghosts and edge plans)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append((path, tree))
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            if f not in ("layout", "ghosts", "plan"):
                tensor_leaves(getattr(tree, f), f"{path}.{f}", out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            tensor_leaves(getattr(tree, f.name), f"{path}.{f.name}", out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            tensor_leaves(v, f"{path}[{i}]", out)
    return out


def ff_loop(bk, h, a_ff, b_ff, norm_b, **kw) -> dict:
    """``_mixed_loop_ff`` from zero with the launch counts set to 0 just
    before; also counts its float-float defects (each is one K6 or K6s
    launch on a stencil fine level)."""
    from agglomerationmultigrid1d_tpu_torch.models import solvers
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF

    calls = [0]
    own = solvers._ff_defect

    def counted(*args, **kwargs):
        calls[0] += 1
        return own(*args, **kwargs)

    zero = torch.zeros_like(b_ff.hi)
    solvers._ff_defect = counted
    try:
        torch.cuda.synchronize()
        bk.reset_launch_counts()
        t0 = time.perf_counter()
        x, outer, cycles, hist = solvers._mixed_loop_ff(h, a_ff, FF(zero, zero), b_ff, np.float32(1.0 / norm_b), **kw)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
    finally:
        solvers._ff_defect = own
    return dict(x=x, outer=outer, cycles=cycles, hist=np.asarray(hist[:outer], dtype=np.float64), solve_s=solve_s,
                launches={k: v for k, v in bk.LAUNCHES.items() if v}, defects=calls[0])


def held_to(got: dict, ref: dict, what: str, apart=(0, 0)) -> str:
    """Hold a sharded ``_mixed_loop_ff`` run to another: equal counts and
    histories within NS_HIST_RTOL relative, or counts at most ``apart``
    (outer, cycles) apart, the difference printed."""
    d_outer, d_cycles = got["outer"] - ref["outer"], got["cycles"] - ref["cycles"]
    if (d_outer, d_cycles) == (0, 0):
        rel = float(np.max(np.abs(got["hist"] - ref["hist"]) / np.abs(ref["hist"])))
        check(rel <= NS_HIST_RTOL, f"{what}: history {got['hist']} against {ref['hist']}: {rel:.3e} relative")
        return f"equal counts, history within {rel:.3e} relative"
    check(abs(d_outer) <= apart[0] and abs(d_cycles) <= apart[1],
          f"{what}: {got['outer']} / {got['cycles']} against {ref['outer']} / {ref['cycles']}, histories "
          f"{[f'{v:.4e}' for v in got['hist']]} against {[f'{v:.4e}' for v in ref['hist']]}")
    return f"counts {d_outer:+d} outer / {d_cycles:+d} cycles apart (allowed {apart[0]} / {apart[1]})"


def phase_sharded_north_star(bk) -> dict:
    """The north star built rank by rank (``build_sharded_xl_problem``,
    ``slim_fine=True``) on a one-rank NCCL group, beside ``build_xl_problem``
    on the same card: every leaf equal bit for bit; ``_mixed_loop_ff`` with
    NS_LOOP on both, the sharded run's counts and history held to the
    unsharded run's, its float-float defects through K6s (one launch each)
    and its sharded levels' smoothings through the edge pair (one launch
    each).  Returns the sharded run (with its peak device memory) and its
    launches."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem
    from agglomerationmultigrid1d_tpu_torch.parallel import build_sharded_xl_problem, initialize, shutdown

    n, spec = NORTH_STAR_N, north_star_spec()
    with tempfile.TemporaryDirectory() as td:
        grp = initialize(0, 1, store_path=os.path.join(td, "store"))
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            hs, a_s, b_s, nb_s = build_sharded_xl_problem(spec, n, group=grp, slim_fine=True)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            sh = ff_loop(bk, hs, a_s, b_s, nb_s, **NS_LOOP)
            sh.update(peak=torch.cuda.max_memory_allocated(), setup_s=setup_s)
            t0 = time.perf_counter()
            h, a_ff, b_ff, norm_b = build_xl_problem(spec, n, slim_fine=True, device="cuda")
            torch.cuda.synchronize()
            setup_u = time.perf_counter() - t0
            la = tensor_leaves((hs.levels, hs.transfers, hs.coarse, a_s, b_s))
            lb = tensor_leaves((h.levels, h.transfers, h.coarse, a_ff, b_ff))
            check([p for p, _ in la] == [p for p, _ in lb], "the sharded north star's leaves are not the unsharded one's")
            bad = [p for (p, t), (_, w) in zip(la, lb) if t.shape != w.shape or not torch.equal(t, w)]
            check(not bad, f"sharded north-star leaves differ from the unsharded build's: {bad[:8]}")
            nb_rel = abs(nb_s - norm_b) / norm_b  # the norm all-reduced against vector_norm: another sum order
            check(nb_rel <= 1e-12, f"sharded north-star ||b|| {nb_s!r} against {norm_b!r}")
            del la, lb
            un = ff_loop(bk, h, a_ff, b_ff, norm_b, **NS_LOOP)
            flags = hs.layout.sharded
            del h, a_ff, b_ff, hs, a_s, b_s
        finally:
            shutdown()
    held = held_to(sh, un, "sharded north star, one rank")
    launches = sh["launches"]
    n_sh = sum(flags)
    edges = {k: launches.get(k, 0) for k in ("chebyshev_edge_pair", "chebyshev_edge_pair_residual")}
    print(f"sharded north star {2 * n} DoF, one-rank NCCL group, sharded={flags}: setup_s={sh['setup_s']:.3f} "
          f"(unsharded {setup_u:.3f}) leaves all equal bit for bit, ||b|| within {nb_rel:.1e} outer={sh['outer']} "
          f"v_cycles={sh['cycles']} (unsharded {un['outer']} / {un['cycles']}; {held}) "
          f"history={[f'{v:.4e}' for v in sh['hist']]} (unsharded {[f'{v:.4e}' for v in un['hist']]}) "
          f"solve_s={sh['solve_s']:.3f} (unsharded {un['solve_s']:.3f}) s_per_outer={sh['solve_s'] / sh['outer']:.3f} "
          f"peak_mem_bytes={sh['peak']} defects={sh['defects']} launches={launches}", flush=True)
    check(launches.get("ff_stencil_shard_defect", 0) == sh["defects"] > 0 and "ff_stencil_mid_defect" not in launches,
          f"the sharded north star's defects did not each launch K6s: {sh['defects']} defects, {launches}")
    check(un["launches"].get("ff_stencil_mid_defect", 0) == un["defects"], "the unsharded run's defects are not K6's")
    check(all(v == sh["cycles"] * n_sh for v in edges.values()),
          f"not one edge pair per smoothing of the {n_sh} sharded levels in {sh['cycles']} cycles: {edges}")
    check(all(launches.get(K7_FORMS[k][1], 0) == 0 for k in K7_FORMS), "the sharded north star launched a K7 strip")
    check(bool(torch.isfinite(sh["x"].hi).all()) and tuple(sh["x"].hi.shape) == (2, n), "sharded north star x")
    del sh["x"], un["x"]
    torch.cuda.empty_cache()
    return sh


def flagship_gathered_residual(h, a_ff, b_ff, x_ff, grp) -> float:
    """``cg_rel_residual_f64`` of a sharded CG-topped build: the fine band,
    the rhs and x gathered (unequal node shards) on every rank."""
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import FF, CgBandFF
    from agglomerationmultigrid1d_tpu_torch.parallel import all_gather_cols, node_widths, unshard_vector

    fine = h.levels[0]
    widths = node_widths(fine.a.n_el * grp.world, fine.a.p, grp)
    whole = lambda t: all_gather_cols(t, grp, widths)  # noqa: E731
    band = CgBandFF(whole(a_ff.hi), whole(a_ff.lo))
    x = unshard_vector(x_ff.hi, h).double() + unshard_vector(x_ff.lo, h).double()
    hw = h._replace(levels=(fine._replace(a=fine.a._replace(windows=all_gather_cols(fine.a.windows, grp))),))
    return cg_rel_residual_f64(hw, band, FF(whole(b_ff.hi), whole(b_ff.lo)), x)


def phase_sharded_flagship(bk, unsharded: dict) -> dict:
    """The CG-topped flagship built rank by rank on a one-rank NCCL group
    (``min_blocks_per_device=8``): at 131,073 DoF damped and Chebyshev to
    1e-10, at 16,777,217 DoF damped; each held to the unsharded phase's
    counts (``unsharded``: {(n, tag): run}) and, where equal, its history;
    the residual recomputed in float64 from the gathered solution.  Returns
    the 16,777,217-DoF run."""
    from agglomerationmultigrid1d_tpu_torch.parallel import build_sharded_xl_problem, initialize, shutdown

    out = None
    with tempfile.TemporaryDirectory() as td:
        grp = initialize(0, 1, store_path=os.path.join(td, "store"))
        try:
            for n, cheb in ((FLAGSHIP_N, False), (FLAGSHIP_N, True), (FLAGSHIP_XL_N, False)):
                tag = "chebyshev" if cheb else "damped"
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                h, a_ff, b_ff, norm_b = build_sharded_xl_problem(flagship_xl_spec(n), n, group=grp, chebyshev=cheb,
                                                                 min_blocks_per_device=8)
                torch.cuda.synchronize()
                setup_s = time.perf_counter() - t0
                run = ff_loop(bk, h, a_ff, b_ff, norm_b, maxiter=60, tol=1e-10, inner_tol=3e-5, max_inner=20)
                rel = flagship_gathered_residual(h, a_ff, b_ff, run["x"], grp)
                ref = unsharded[(n, tag)]
                held = held_to(run, ref, f"sharded flagship {8 * n + 1} DoF {tag}")
                print(f"sharded flagship {8 * n + 1} DoF {tag}, one-rank NCCL group, sharded={h.layout.sharded}: "
                      f"setup_s={setup_s:.3f} outer={run['outer']} v_cycles={run['cycles']} (unsharded {ref['outer']} / "
                      f"{ref['cycles']}; {held}) rel_history_end={run['hist'][-1]:.3e} rel_residual_f64={rel:.3e} "
                      f"solve_s={run['solve_s']:.3f} launches={run['launches']}", flush=True)
                check(all(h.layout.sharded[:4]), "the flagship's CG levels are not sharded")
                if n <= FLAGSHIP_N:
                    check(rel < 1e-10, f"sharded flagship {tag} relative residual {rel:.3e} >= 1e-10")
                run.pop("x")
                out = dict(run, rel=rel)
                del h, a_ff, b_ff
        finally:
            shutdown()
    torch.cuda.empty_cache()
    return out


def phase_shard_hierarchy_cg(bk) -> dict:
    """``poisson_full_hierarchy(n=16384)`` (131,073 DoF) through
    ``shard_hierarchy`` on a one-rank NCCL group: float64 ``multigrid`` with
    the unsharded iterations and x within 1e-12 ||b||, damped
    ``multigrid_mixed`` with the unsharded counts.  Returns the unsharded
    run, which the two-rank phase is held to."""
    from agglomerationmultigrid1d_tpu_torch.models import make_low_precision_hierarchy, multigrid, multigrid_mixed
    from agglomerationmultigrid1d_tpu_torch.models import poisson_full_hierarchy
    from agglomerationmultigrid1d_tpu_torch.parallel import initialize, shard_hierarchy, shard_vector, shutdown
    from agglomerationmultigrid1d_tpu_torch.parallel import unshard_vector

    prob = poisson_full_hierarchy(n=FLAGSHIP_N, device="cuda")
    h, b = prob.hierarchy, prob.b
    ref = multigrid(h, torch.zeros_like(b), b, 100, 1e-10, compute_error=False)
    ref_mixed = multigrid_mixed(h, make_low_precision_hierarchy(h), torch.zeros_like(b), b, 80, 1e-10)
    with tempfile.TemporaryDirectory() as td:
        grp = initialize(0, 1, store_path=os.path.join(td, "store"))
        try:
            hs = shard_hierarchy(h, grp)
            bl = shard_vector(b, grp, hs)
            res = multigrid(hs, torch.zeros_like(bl), bl, 100, 1e-10, compute_error=False)
            x = unshard_vector(res.x, hs)
            mixed, solve_s, launches = timed_solve(
                lambda: multigrid_mixed(hs, make_low_precision_hierarchy(hs), torch.zeros_like(bl), bl, 80, 1e-10), bk)
        finally:
            shutdown()
    nb = float(torch.linalg.vector_norm(b))
    dx = float((x - ref.x).abs().max())
    print(f"shard_hierarchy CG-topped flagship {b.numel()} DoF, one-rank NCCL group, sharded={hs.layout.sharded}: "
          f"f64 multigrid iterations={res.iterations} (unsharded {ref.iterations}) max|x - x_unsharded|={dx:.3e} "
          f"({dx / nb:.2e} of ||b||); mixed outer={mixed.iterations} inner_cycles={mixed.inner_cycles} (unsharded "
          f"{ref_mixed.iterations} / {ref_mixed.inner_cycles}) solve_s={solve_s:.3f} launches="
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    check(res.iterations == ref.iterations == 12, f"sharded CG multigrid took {res.iterations} iterations")
    check(dx <= 1e-12 * nb, f"sharded CG multigrid x differs by {dx:.3e}")
    check((mixed.iterations, mixed.inner_cycles) == (ref_mixed.iterations, ref_mixed.inner_cycles),
          "sharded CG multigrid_mixed counts differ from the unsharded solve's")
    out = dict(iterations=ref.iterations, x=ref.x.cpu().numpy(), norm_b=nb,
               mixed=(ref_mixed.iterations, ref_mixed.inner_cycles))
    del prob, h, b, hs, bl, res, x, ref
    torch.cuda.empty_cache()
    return out


def _sharded_two_rank_child(rank: int, store_path: str, q) -> None:
    """One rank of two on the card over gloo: the north star built rank by
    rank and solved (NS_LOOP), the 16,777,217-DoF flagship built rank by rank
    and solved damped, ``shard_hierarchy`` of the 131,073-DoF flagship
    solved by float64 ``multigrid`` and ``multigrid_mixed``, and the ragged,
    mixed-switch and scattered slices sharded (``sharded_family``)."""
    try:
        from agglomerationmultigrid1d_tpu_torch.models import make_low_precision_hierarchy, multigrid, multigrid_mixed
        from agglomerationmultigrid1d_tpu_torch.models import poisson_full_hierarchy
        from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk
        from agglomerationmultigrid1d_tpu_torch.parallel import (
            build_sharded_xl_problem,
            initialize,
            shard_hierarchy,
            shard_vector,
            shutdown,
            unshard_vector,
        )

        grp = initialize(rank, 2, store_path=store_path, device="cuda", backend="gloo", timeout_s=CHILD_TIMEOUT_S)
        n = NORTH_STAR_N
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        h, a_ff, b_ff, norm_b = build_sharded_xl_problem(north_star_spec(), n, group=grp, slim_fine=True)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        leaves = tensor_leaves((h, a_ff, b_ff))
        ns = ff_loop(bk, h, a_ff, b_ff, norm_b, **NS_LOOP)
        ns.pop("x")
        ns.update(setup_s=setup_s, peak=torch.cuda.max_memory_allocated(), fine_width=h.levels[0].a.n_blocks,
                  whole_width=[p for p, t in leaves if t.dim() > 0 and t.shape[-1] == n], flags=h.layout.sharded)
        del h, a_ff, b_ff, leaves
        torch.cuda.empty_cache()
        out = dict(ns=ns)

        nf = FLAGSHIP_XL_N
        h, a_ff, b_ff, norm_b = build_sharded_xl_problem(flagship_xl_spec(nf), nf, group=grp, chebyshev=False,
                                                         min_blocks_per_device=8)
        fl = ff_loop(bk, h, a_ff, b_ff, norm_b, maxiter=60, tol=1e-10, inner_tol=3e-5, max_inner=20)
        fl.update(rel=flagship_gathered_residual(h, a_ff, b_ff, fl.pop("x"), grp), nodes=h.levels[0].a.band.shape[-1])
        out["flagship"] = fl
        del h, a_ff, b_ff
        torch.cuda.empty_cache()

        prob = poisson_full_hierarchy(n=FLAGSHIP_N, device="cuda")
        hs = shard_hierarchy(prob.hierarchy, grp)
        bl = shard_vector(prob.b, grp, hs)
        res = multigrid(hs, torch.zeros_like(bl), bl, 100, 1e-10, compute_error=False)
        mixed = multigrid_mixed(hs, make_low_precision_hierarchy(hs), torch.zeros_like(bl), bl, 80, 1e-10)
        out["cg"] = dict(iterations=res.iterations, x=unshard_vector(res.x, hs).cpu().numpy(),
                         mixed=(mixed.iterations, mixed.inner_cycles), nodes=hs.levels[0].a.band.shape[-1])
        del prob, hs, bl, res, mixed
        torch.cuda.empty_cache()

        out["families"] = {}
        for fam in FAMILY_SOLVERS:  # each rank builds the whole problem, shards it and drops the rest
            t0 = time.perf_counter()
            whole = family_problem(fam)
            build_s = time.perf_counter() - t0
            g24 = g24_probes(whole, grp) if fam in G24_FAMILIES else None
            got = sharded_family(fam, whole, grp, bk)
            got.update(build_s=build_s, phase_s=time.perf_counter() - t0, g24=g24)
            out["families"][fam] = got
        shutdown()
        q.put((rank, "ok", out))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
        raise


def spawn_ranks(child, world: int, timeout_s: float, what: str) -> dict:
    """Run ``child(rank, store_path, q)`` on ``world`` spawned ranks (gloo
    on the one card), each putting ``(rank, status, payload)``; {rank: its
    payload}.  Past ``timeout_s`` the processes are killed and this fails."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as td:
        procs = [ctx.Process(target=child, args=(r, os.path.join(td, "store"), q)) for r in range(world)]
        for p in procs:
            p.start()
        msgs = {}
        try:
            for _ in range(world):
                rank, status, payload = q.get(timeout=timeout_s)
                msgs[rank] = (status, payload)
        except queue.Empty:
            raise RuntimeError(f"chip_smoke: the {what} did not finish in {timeout_s} s") from None
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    for rank, (status, payload) in sorted(msgs.items()):
        check(status == "ok", f"{what}, rank {rank}:\n{payload}")
    return {rank: payload for rank, (_, payload) in msgs.items()}


def spawn_sharded_two_ranks() -> dict:
    """Run ``_sharded_two_rank_child`` on two spawned ranks; {rank: its results}."""
    return spawn_ranks(_sharded_two_rank_child, 2, 3 * CHILD_TIMEOUT_S, "sharded two-rank phase")


def phase_sharded_two_ranks(one_rank_ns: dict, flagship_one_rank: dict, cg_ref: dict, families: dict) -> None:
    """Two ranks on the one card over gloo (spawned, each with a time limit):
    the north star built rank by rank, each rank holding its half (25,165,824
    fine columns) and no tensor of the global fine width, at most
    NS_PEAK_SHARE of the one-rank run's peak device memory, its run held to
    the one-rank run; the 16,777,217-DoF flagship (an odd node count: the
    shared vertex and unequal node shards) held to the one-rank run's first
    step and stall level; and
    ``shard_hierarchy`` on the 131,073-DoF flagship held to the unsharded
    float64 and mixed solves."""
    msgs = spawn_sharded_two_ranks()
    n = NORTH_STAR_N
    for rank in range(2):
        ns = msgs[rank]["ns"]
        share = ns["peak"] / one_rank_ns["peak"]
        held = held_to(ns, one_rank_ns, f"sharded north star, rank {rank} of two", apart=(1, 2))
        print(f"sharded north star on two gloo ranks, rank {rank}, sharded={ns['flags']}: fine width {ns['fine_width']} "
              f"setup_s={ns['setup_s']:.3f} outer={ns['outer']} v_cycles={ns['cycles']} ({held}) "
              f"history={[f'{v:.4e}' for v in ns['hist']]} solve_s={ns['solve_s']:.3f} peak_mem_bytes={ns['peak']} "
              f"({share:.3f} of the one-rank run's {one_rank_ns['peak']}) defects={ns['defects']} "
              f"launches={ns['launches']}", flush=True)
        check(ns["fine_width"] == n // 2, f"rank {rank} holds {ns['fine_width']} fine columns")
        check(not ns["whole_width"], f"rank {rank} holds tensors of the global fine width: {ns['whole_width'][:8]}")
        check(share <= NS_PEAK_SHARE, f"rank {rank} peaks at {share:.3f} of the one-rank run's device memory")
        check(ns["launches"].get("ff_stencil_shard_defect", 0) == ns["defects"], f"rank {rank}: not one K6s per defect")
    r0 = msgs[0]
    fl, cg, one = r0["flagship"], r0["cg"], flagship_one_rank
    # this solve stalls in the float32 inner cycle's noise (G13, G20): the two
    # ranks' rounding (the edge pair's and K3's edge columns, the all-reduced
    # norms) moves its later steps, so it is held on its first step and on
    # where it stalls, not on its counts
    first = abs(fl["hist"][0] - one["hist"][0]) / one["hist"][0]
    print(f"sharded flagship {8 * FLAGSHIP_XL_N + 1} DoF damped on two gloo ranks: rank 0 holds {fl['nodes']} nodes "
          f"(rank 1 {msgs[1]['flagship']['nodes']}) outer={fl['outer']} v_cycles={fl['cycles']} (one rank "
          f"{one['outer']} / {one['cycles']}) first step within {first:.2e} relative, rel_residual_f64={fl['rel']:.3e} "
          f"(one rank {one['rel']:.3e}) history={[f'{v:.4e}' for v in fl['hist']]} (one rank "
          f"{[f'{v:.4e}' for v in one['hist']]}) solve_s={fl['solve_s']:.3f} (one rank {one['solve_s']:.3f})",
          flush=True)
    check(first <= NS_HIST_RTOL, f"two-rank flagship: first step {fl['hist'][0]} against {one['hist'][0]}")
    check(fl["rel"] < FLAGSHIP_STALL and fl["rel"] <= FLAGSHIP_STALL_RATIO * one["rel"],
          f"two-rank flagship stalls at {fl['rel']:.3e}, the one-rank run at {one['rel']:.3e}")
    check(msgs[1]["flagship"]["nodes"] == fl["nodes"] + 1 == 8 * FLAGSHIP_XL_N // 2 + 1, "flagship node shards")
    dx = float(np.abs(cg["x"] - cg_ref["x"]).max())
    print(f"shard_hierarchy CG-topped flagship on two gloo ranks: f64 multigrid iterations={cg['iterations']} "
          f"(unsharded {cg_ref['iterations']}) max|x - x_unsharded|={dx:.3e} ({dx / cg_ref['norm_b']:.2e} of ||b||) "
          f"mixed={cg['mixed']} (unsharded {cg_ref['mixed']}) nodes per rank {cg['nodes']} / "
          f"{msgs[1]['cg']['nodes']}", flush=True)
    check(cg["iterations"] == cg_ref["iterations"] and dx <= 1e-12 * cg_ref["norm_b"], "two-rank CG multigrid")
    check(cg["mixed"] == cg_ref["mixed"], "two-rank CG multigrid_mixed counts")
    report_two_rank_families(msgs, families)


def report_two_rank_families(msgs: dict, families: dict) -> None:
    """The ragged, mixed-switch and scattered slices on two gloo ranks, held
    to the unsharded runs (``check_family_run``) and to the one-rank run:
    each rank's peak device memory at most FAMILY_PEAK_SHARE of the
    one-rank run's (printed for the scattered slice), both ranks the same
    counts.  The float64 x's distance to the one-rank x is printed: both
    solves stop at the same relative residual, and on the card the shards'
    batched products round otherwise than the whole level's, which these
    operators (c_dir = 1000 n) amplify up to the solves' own error."""
    for fam in FAMILY_SOLVERS:
        one = families[fam]["sharded"]
        r0, r1 = (msgs[rank]["families"][fam] for rank in range(2))
        shares = [r["peak"] / one["peak"] for r in (r0, r1)]
        x1, x2 = one["runs"]["multigrid"]["x"], r0["runs"]["multigrid"]["x"]
        dx = float(np.abs(x2 - x1).max() / np.abs(x1).max())
        print(f"sharded {fam} slice on two gloo ranks: local blocks per level {r0['local']} build_s={r0['build_s']:.3f} "
              f"shard_s={r0['shard_s']:.3f} phase_s={r0['phase_s']:.3f} peak_mem_bytes={r0['peak']} / {r1['peak']} "
              f"({shares[0]:.3f} / {shares[1]:.3f} of the one-rank run's {one['peak']}) f64 max|x - x_one_rank| / "
              f"max|x| = {dx:.3e}", flush=True)
        if r0["g24"] is not None:
            report_g24(fam, r0["g24"], x1, x2)
        check_family_run(fam, "two gloo ranks", r0, families[fam]["ref"])
        check(all(r1["runs"][t]["counts"] == r0["runs"][t]["counts"] for t in r0["runs"]), f"{fam}: the ranks' counts")
        if fam in FAMILY_PEAK_SHARE:
            check(max(shares) <= FAMILY_PEAK_SHARE[fam], f"two-rank {fam} peaks at {shares} of the one-rank run")


def fixed_order_einsum(eq: str, *ops):
    """``torch.einsum(eq, *ops)`` as a broadcast multiply-and-sum over the
    contracted indices in a fixed order: one elementwise product and one add
    per term, so every output entry is rounded the same way whatever the
    other axes' widths (a batched library product need not be).  G24's probe
    (b) swaps it in for ``torch.einsum`` around a solve; nothing else uses
    it."""
    if "." in eq:
        raise ValueError(f"fixed_order_einsum: no ellipsis: {eq!r}")
    lhs, out = eq.replace(" ", "").split("->")
    ins = lhs.split(",")
    sizes = {c: d for spec, op in zip(ins, ops) for c, d in zip(spec, op.shape)}
    red = [c for c in dict.fromkeys("".join(ins)) if c not in out]
    full = out + "".join(red)
    views = []
    for spec, op in zip(ins, ops):  # every operand over ``full``, size 1 where it lacks an index
        order = sorted(range(len(spec)), key=lambda i: full.index(spec[i]))
        views.append(op.permute(*order).reshape([sizes[c] if c in spec else 1 for c in full]))
    acc = None
    for idx in itertools.product(*(range(sizes[c]) for c in red)):
        term = None
        for v in views:
            part = v[(Ellipsis,) + tuple(i if v.shape[len(out) + k] > 1 else 0 for k, i in enumerate(idx))]
            term = part if term is None else term * part
        acc = term if acc is None else acc + term
    return acc.expand([sizes[c] for c in out]).contiguous()


def g24_probes(whole: dict, grp) -> dict:
    """ROADMAP G24's two probes on a family's whole problem (``whole``, kept
    for ``sharded_family``), on each of the two ranks: (a) on rank 0, the
    fine operator's banded solve refined with extended-precision residuals
    (``ops/banded_solve.py:fine_refined_solve``, on the host: the witness of
    which float64 x is the accurate one) and its condition estimate; (b)
    float64 ``multigrid`` to 1e-10 with every ``torch.einsum`` formed by
    :func:`fixed_order_einsum` and the contraction kernels off (their
    callers take the einsum, :func:`einsum_contractions`), unsharded on rank
    0 and on the two ranks' shards.  Rank 0 returns the x's (NumPy, ``(bs, n)``), the counts and the
    seconds."""
    from agglomerationmultigrid1d_tpu_torch.models import multigrid
    from agglomerationmultigrid1d_tpu_torch.ops.banded_solve import fine_refined_solve
    from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk
    from agglomerationmultigrid1d_tpu_torch.parallel import shard_hierarchy, shard_vector, unshard_vector
    from agglomerationmultigrid1d_tpu_torch.utils.precision import tree_to

    h, b = whole["h"], whole["b"]
    out = {}
    if grp.rank == 0:
        t0 = time.perf_counter()
        bs, n = b.shape
        cond, x_ref, last = fine_refined_solve(tree_to(h.levels[0], "cpu"), b.cpu().T.reshape(-1).numpy())
        out.update(cond=cond, last=last, x_ref=np.asarray(x_ref, dtype=np.float64).reshape(n, bs).T.copy(),
                   refine_s=time.perf_counter() - t0)
    own = torch.einsum
    torch.einsum = fixed_order_einsum
    try:
        with einsum_contractions(bk):  # the contraction kernels off too: every contraction in fixed order
            if grp.rank == 0:
                hd, bd = tree_to(h, grp.device), b.to(grp.device)
                t0 = time.perf_counter()
                res = multigrid(hd, torch.zeros_like(bd), bd, 100, 1e-10, compute_error=False)
                torch.cuda.synchronize()
                out.update(fixed_whole=res.x.cpu().numpy(), fixed_whole_it=res.iterations,
                           fixed_whole_s=time.perf_counter() - t0)
                del hd, bd, res
            hs = shard_hierarchy(h, grp)
            bl = shard_vector(b, grp, hs)
            t0 = time.perf_counter()
            res = multigrid(hs, torch.zeros_like(bl), bl, 100, 1e-10, compute_error=False)
            x = unshard_vector(res.x, hs)
            torch.cuda.synchronize()
            out.update(fixed_sharded_it=res.iterations, fixed_sharded_s=time.perf_counter() - t0)
            if grp.rank == 0:
                out["fixed_sharded"] = x.cpu().numpy()
            del hs, bl, res, x
    finally:
        torch.cuda.empty_cache()
        torch.einsum = own
    return out


def report_g24(fam: str, g24: dict, x1: np.ndarray, x2: np.ndarray) -> None:
    """G24's two lines for one family: (a) the one-rank and the two-rank
    float64 x (cuBLAS contractions) against the refined solution, beside
    cond_1 * eps; (b) the fixed-order contractions' two-rank x against their
    unsharded x, which must lie within G24_FIXED_TOL of max|x| (the shards
    then round as the whole level does), and both against the refined
    solution."""
    ref = g24["x_ref"]

    def gap(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    eps = float(np.finfo(np.float64).eps)
    print(f"G24 (a) {fam}: refined solution ({g24['refine_s']:.3f} s on the host, last correction "
          f"{g24['last']:.3e} of max|x|, cond_1 {g24['cond']:.3e}, cond_1 * eps {g24['cond'] * eps:.3e}): "
          f"max|x - x_refined| / max|x_refined| one rank {gap(x1, ref):.3e}, two ranks {gap(x2, ref):.3e}; "
          f"two ranks from one rank {gap(x2, x1):.3e}", flush=True)
    fw, fs = g24["fixed_whole"], g24["fixed_sharded"]
    dx = gap(fs, fw)
    print(f"G24 (b) {fam}: fixed-order contractions: unsharded {g24['fixed_whole_it']} iterations "
          f"({g24['fixed_whole_s']:.3f} s), two ranks {g24['fixed_sharded_it']} ({g24['fixed_sharded_s']:.3f} s); "
          f"max|x_two - x_one| / max|x| = {dx:.3e} (limit {G24_FIXED_TOL:.0e}); against the refined solution: "
          f"unsharded {gap(fw, ref):.3e}, two ranks {gap(fs, ref):.3e}", flush=True)
    check(g24["fixed_whole_it"] == g24["fixed_sharded_it"], f"G24 (b) {fam}: the iteration counts differ")
    check(dx <= G24_FIXED_TOL, f"G24 (b) {fam}: fixed-order two-rank x {dx:.3e} of max|x| from the unsharded x")


def _three_rank_child(rank: int, store_path: str, q) -> None:
    """One rank of three on the card over gloo: the north star's spec with
    3:1 first agglomerates at THREE_RANK_N elements built rank by rank
    (``slim_fine``, ``ff_levels``) and solved with NS_LOOP from its fine
    float-float operator; its level widths, cut transfers, the leaves it
    holds at the fine level's global width (none may be), its own x."""
    try:
        from agglomerationmultigrid1d_tpu_torch.ops.df64 import ff_join
        from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk
        from agglomerationmultigrid1d_tpu_torch.parallel import build_sharded_xl_problem, initialize, shutdown
        from agglomerationmultigrid1d_tpu_torch.parallel.distributed import level_size
        from agglomerationmultigrid1d_tpu_torch.parallel.transfers import SHARD_TRANSFERS

        grp = initialize(rank, 3, store_path=store_path, device="cuda", backend="gloo",
                         timeout_s=THREE_RANK_TIMEOUT_S)
        n = THREE_RANK_N
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        h, a_ffs, b_ff, norm_b = build_sharded_xl_problem(north_star_spec(n, THREE_RANK_FIRST_AGG), n, group=grp,
                                                          slim_fine=True, ff_levels=True)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        leaves = tensor_leaves((h, a_ffs, b_ff))
        run = ff_loop(bk, h, a_ffs[0], b_ff, norm_b, **NS_LOOP)
        run.update(setup_s=setup_s, peak=torch.cuda.max_memory_allocated(), flags=h.layout.sharded,
                   widths=[level_size(lv) for lv in h.levels], norm_b=norm_b,
                   cut=[k for k, t in enumerate(h.transfers) if isinstance(t, SHARD_TRANSFERS)],
                   wide=[p for p, t in leaves if t.dim() > 0 and t.shape[-1] >= n],
                   x=ff_join(run["x"]).cpu().numpy())
        del h, a_ffs, b_ff, leaves
        shutdown()
        q.put((rank, "ok", run))
    except BaseException:
        q.put((rank, "error", traceback.format_exc()))
        raise


def phase_three_ranks(bk) -> dict:
    """Three ranks on the one card over gloo, agglomerates that straddle them:
    the north star's spec with 3:1 first agglomerates at THREE_RANK_N
    elements, first built whole (``build_xl_problem``) on the card and solved
    with NS_LOOP (its peak device memory, its x), and solved further with the
    hand-over (THREE_RANK_REF_LOOP) for the reference x; then built rank by
    rank on three spawned ranks (``_three_rank_child``).  Held: every rank's
    level widths the whole build's (the fine level its third), transfer 0
    cut and no leaf of the global fine width; its counts the whole build's
    and its history within NS_HIST_RTOL; one K6s launch per float-float
    defect and one edge pair per smoothing of the sharded fine level, no K7
    strip; the gathered x from the whole build's x at most G24_X_SHARE of
    the whole build's own error (its distance to the reference x).
    Each rank's peak over the whole build's is printed.  Returns rank 0's
    launches."""
    from agglomerationmultigrid1d_tpu_torch.models import build_xl_problem
    from agglomerationmultigrid1d_tpu_torch.ops.df64 import ff_join
    from agglomerationmultigrid1d_tpu_torch.parallel.distributed import level_size

    n, t_phase = THREE_RANK_N, time.perf_counter()
    spec = north_star_spec(n, THREE_RANK_FIRST_AGG)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h, ffops, b_ff, norm_b = build_xl_problem(spec, n, slim_fine=True, ff_levels=True, device="cuda")
    torch.cuda.synchronize()
    setup_w = time.perf_counter() - t0
    whole = ff_loop(bk, h, ffops.a_ffs[0], b_ff, norm_b, **NS_LOOP)
    whole["peak"] = torch.cuda.max_memory_allocated()
    x_whole = ff_join(whole.pop("x")).cpu().numpy()
    widths = [level_size(lv) for lv in h.levels]
    ref = ff_loop(bk, h, ffops.a_ffs[0], b_ff, norm_b, ffops=ffops, **THREE_RANK_REF_LOOP)
    x_ref = ff_join(ref.pop("x")).cpu().numpy()
    del h, ffops, b_ff
    torch.cuda.empty_cache()
    print(f"three-rank cell, whole build on the card: {2 * n} DoF, levels {widths}, setup_s={setup_w:.3f} "
          f"outer={whole['outer']} v_cycles={whole['cycles']} history={[f'{v:.4e}' for v in whole['hist']]} "
          f"solve_s={whole['solve_s']:.3f} peak_mem_bytes={whole['peak']}; reference (hand-over) outer={ref['outer']} "
          f"v_cycles={ref['cycles']} rel_history_end={ref['hist'][-1]:.3e} solve_s={ref['solve_s']:.3f}", flush=True)
    check(ref["hist"][-1] <= 1e-2 * whole["hist"][-1],
          f"the reference solve ({ref['hist'][-1]:.3e}) is not far below the cell's ({whole['hist'][-1]:.3e})")
    t1 = time.perf_counter()
    msgs = spawn_ranks(_three_rank_child, 3, THREE_RANK_TIMEOUT_S, "three-rank phase")
    spawn_s = time.perf_counter() - t1
    for rank in range(3):
        run = msgs[rank]
        share = run["peak"] / whole["peak"]
        held = held_to(run, whole, f"three-rank cell, rank {rank}")
        launches = run["launches"]
        edges = {k: launches.get(k, 0) for k in ("chebyshev_edge_pair", "chebyshev_edge_pair_residual")}
        print(f"three-rank cell, rank {rank} of three gloo ranks, sharded={run['flags']}: level widths {run['widths']} "
              f"cut transfers {run['cut']} setup_s={run['setup_s']:.3f} outer={run['outer']} v_cycles={run['cycles']} "
              f"({held}) solve_s={run['solve_s']:.3f} peak_mem_bytes={run['peak']} ({share:.3f} of the whole "
              f"build's) defects={run['defects']} launches={launches}", flush=True)
        check(run["widths"] == [n // 3] + widths[1:] and run["flags"][0] and not any(run["flags"][1:]),
              f"rank {rank}: level widths {run['widths']}, flags {run['flags']} (whole build {widths})")
        check(run["cut"] == [0], f"rank {rank}: cut transfers {run['cut']}, transfer 0 expected")
        check(not run["wide"], f"rank {rank} holds leaves of the global fine width: {run['wide'][:8]}")
        check(launches.get("ff_stencil_shard_defect", 0) == run["defects"] > 0
              and "ff_stencil_mid_defect" not in launches, f"rank {rank}: not one K6s per defect: {launches}")
        check(all(v == run["cycles"] for v in edges.values()),
              f"rank {rank}: not one edge pair per smoothing of the sharded fine level: {edges}, {run['cycles']} cycles")
        check(all(launches.get(K7_FORMS[k][1], 0) == 0 for k in K7_FORMS), f"rank {rank} launched a K7 strip")
        check(abs(run["norm_b"] - msgs[0]["norm_b"]) == 0, "the ranks' ||b|| differ")
    x3 = np.concatenate([msgs[r]["x"] for r in range(3)], axis=-1)
    check(x3.shape == x_whole.shape and bool(np.isfinite(x3).all()), f"three-rank x: {x3.shape}")
    scale = float(np.abs(x_ref).max())
    d3, dw = (float(np.abs(x - x_ref).max()) / scale for x in (x3, x_whole))
    dx = float(np.abs(x3 - x_whole).max()) / scale
    print(f"three-rank cell: gathered x from the whole build's {dx:.3e} of max|x| (limit {G24_X_SHARE} x the whole "
          f"build's own error {dw:.3e}); from the reference x {d3:.3e}; spawn, build and solve on three ranks "
          f"{spawn_s:.1f} s; phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    check(dx <= G24_X_SHARE * dw, f"three-rank x {dx:.3e} from the whole build's, its own error {dw:.3e}")
    return msgs[0]["launches"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from agglomerationmultigrid1d_tpu_torch.ops.kernels import block_kernels as bk

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card {name}; torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)

    t0 = time.perf_counter()
    so = bk.build()
    print(f"build {time.perf_counter() - t0:.1f} s -> {so.name}", flush=True)

    kernels = phase_kernels(bk)
    kernels["K6"] = phase_k6(bk)
    kernels["K12"] = phase_k12(bk)
    kernels["K13"] = phase_k13(bk)
    kernels["K14"] = phase_k14(bk)
    gemv = phase_gemv(bk)
    kernels.update({"bd": gemv["bd"], "prolong": gemv["prolong"], "restrict": gemv["restrict"]})
    k7_strips, k7_edges, pack, k7_whole = phase_k7(bk)
    for k in K7_FORMS:  # K7's rows: the whole-shard form, which a path launches; its error also over the strips
        kernels[k] = dict(k7_whole[k], max_abs_err=max(k7_whole[k]["max_abs_err"], k7_strips[k]["max_abs_err"]))
        kernels["edge " + k] = k7_edges[k]
    kernels["pack"] = pack
    k7_launches = phase_four_shards(bk)
    bench_launches = phase_sweep_bench(bk, kernels, k7_whole)
    launches = phase_slice(bk)
    phase_reference(bk)
    launches.update(phase_chebyshev(bk))
    phase_flagship(bk)
    flagship_runs = {(n, tag): run for n, true_solve in ((FLAGSHIP_N, False), (FLAGSHIP_XL_N, True))
                     for tag, run in phase_flagship_xl(bk, n, true_solve).items()}
    launches["ff_cg_defect"] = flagship_runs[(FLAGSHIP_XL_N, "handover damped")]["launches"]["ff_cg_defect"]
    families = {"ragged": phase_ragged(bk)}
    phase_device_chain(bk)
    families["scattered"] = phase_scattered(bk)
    families["switch"] = phase_mixed_switch(bk)
    phase_surface(bk)
    launches.update(phase_north_star(bk))
    one_rank = phase_sharded(bk)
    launches.update({EDGE_FORMS[k]: one_rank[k] for k in EDGE_FORMS})
    launches.update(k7_launches)
    launches.update(bench_launches)
    torch.cuda.empty_cache()
    launches["pack_edges"] = phase_two_ranks(one_rank)
    kernels["K6s"] = phase_k6s(bk)
    ns_one_rank = phase_sharded_north_star(bk)
    launches["ff_stencil_shard_defect"] = ns_one_rank["launches"]["ff_stencil_shard_defect"]
    flagship_one_rank = phase_sharded_flagship(bk, flagship_runs)
    cg_ref = phase_shard_hierarchy_cg(bk)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    phase_sharded_two_ranks(ns_one_rank, flagship_one_rank, cg_ref, families)
    print(f"sharded two-rank phase (north star, flagship, CG, the three families): {time.perf_counter() - t1:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    three_rank = phase_three_ranks(bk)
    print(f"three-rank launches (rank 0): K6s {three_rank.get('ff_stencil_shard_defect', 0)}, edge pairs "
          f"{three_rank.get('chebyshev_edge_pair', 0)} + {three_rank.get('chebyshev_edge_pair_residual', 0)}, "
          f"packings {three_rank.get('pack_edges', 0)}", flush=True)

    # kernel: (label, wrapper, launch counter, the TPU kernel it replaces)
    meta = {
        "K1": ("K1", "multisweep_residual", "multisweep_residual", PALLAS + ":510"),
        "K2": ("K2", "multisweep", "multisweep", PALLAS + ":495"),
        "K3": ("K3", "fused_bt_matvec", "bt_matvec", PALLAS + ":130"),
        "K5": ("K5", "chebyshev_multisweep", "chebyshev_multisweep", PALLAS + ":422"),
        "K5r": ("K5", "chebyshev_multisweep_residual", "chebyshev_multisweep_residual", PALLAS + ":422"),
        "K6": ("K6", "ff_stencil_mid_defect", "ff_stencil_mid_defect", PALLAS + ":621"),
        # K6 on a shard: the sharded north star's float-float defects
        "K6s": ("K6s", "ff_stencil_shard_defect", "ff_stencil_shard_defect", PALLAS + ":621"),
        # the float-float defect of a materialised operator: no Pallas kernel (the JAX package's plain jnp);
        # launches from the north star's multigrid_true, 7 a cycle on each agglomerated level
        "K12": ("K12", "ff_bt_defect", "ff_bt_defect", None),
        # the float-float defect of a CG band: no Pallas kernel (the JAX package's plain jnp); launches from
        # the 16.8M flagship's hand-over, one per float-float defect on a CG level
        "K13": ("K13", "ff_cg_defect", "ff_cg_defect", None),
        # a true Chebyshev step's apply, recurrence and float-float update: no Pallas kernel (the JAX package's
        # plain jnp); launches from the north star's multigrid_true, 6 a cycle on each smoothed level
        "K14": ("K14", "ff_cheb_update", "ff_cheb_update", None),
        # K7, the whole-shard ghosted launch (its cols= strips are held in the K7 phase)
        "K7": ("K7", "multisweep(ghosts=)", "multisweep_ghost", PALLAS + ":522"),
        "K7r": ("K7", "multisweep_residual(ghosts=)", "multisweep_residual_ghost", PALLAS + ":522"),
        "K7c": ("K7", "chebyshev_multisweep(ghosts=)", "chebyshev_multisweep_ghost", PALLAS + ":422"),
        "K7cr": ("K7", "chebyshev_multisweep_residual(ghosts=)", "chebyshev_multisweep_residual_ghost",
                 PALLAS + ":422"),
        # the edge pair, as the sharded path launches it: both shard edges in one launch
        "edge K7": ("K7", "EdgePlan.sweep_edges edge pair", "edge_pair", SHARDED + ":81"),
        "edge K7r": ("K7", "EdgePlan.sweep_edges edge pair with the residual", "edge_pair_residual",
                     SHARDED + ":81"),
        "edge K7c": ("K7", "EdgePlan.chebyshev_edges edge pair", "chebyshev_edge_pair", SHARDED + ":81"),
        "edge K7cr": ("K7", "EdgePlan.chebyshev_edges edge pair with the residual",
                      "chebyshev_edge_pair_residual", SHARDED + ":81"),
        "pack": ("K7", "EdgePlan.pack pack_edges", "pack_edges", SHARDED + ":60"),
        "K8": ("K8", "block_jacobi_sweep", "block_jacobi_sweep", PALLAS + ":103"),
        "K4": ("K4", "stream_kernel", "stream_kernel", "bench.py:159"),
        # the block contractions: no Pallas kernel (the JAX package's jnp.einsum, fused by XLA); launches from
        # the north star's multigrid_true (K9: its hand-over's, the true cycles' applies being in K14);
        # library_ms the einsum they replaced
        "bd": ("K9", "bd_gemv", "bd_gemv", None),
        "prolong": ("K10", "bp_prolong_gemv", "bp_prolong_gemv", None),
        "restrict": ("K11", "bp_restrict_gemv", "bp_restrict_gemv", None),
    }
    out = []
    for k, (label, wrapper, counter, replaces) in meta.items():
        r = kernels[k]
        out.append({
            "name": f"{label} {wrapper}", "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[counter], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # no single PyTorch call computes K1-K8; the contractions' is the einsum they replaced
            "library_ms": r.get("library_ms"),
        })
    print(f"chip_smoke total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
