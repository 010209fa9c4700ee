"""Analysis phase — the blend equivalent (reference phase 3).

The reference's blend (``src/blend/src/blend.c``: elimination tree → cost
model → proportional mapping → panel splitting → discrete-event simulated
static schedule → SolverMatrix; SURVEY.md section 2 row 7) assigns
block-tasks to MPI ranks and threads.  The TPU design replaces all of that
with a *compile-time static plan over uniform tiles*:

  * The permuted matrix is partitioned into uniform T x T tiles (T is
    MXU-shaped: 128 for big problems).  Uniformity is what blend's
    splitpart + amalgamation chased — here it is exact by construction, so
    every kernel invocation is one big batched matmul.
  * The tile-level nonzero pattern of L is computed by a quotient-graph
    symbolic factorization (superset of the scalar pattern, closed under
    the factorization).
  * Tiles are scheduled by *level sets* of the tile elimination DAG:
    level(J) = 1 + max level(K) over K with tile (J,K) nonzero.  All block
    columns in a level factor simultaneously: one batched panel
    factorization, one batched TRSM, one batched GEMM + scatter-add.
    This replaces blend's per-thread static task queues — XLA's scheduler
    plus the MXU pipeline latency-hide inside each batch.

Output: :class:`SolverLayout` — flat index tables consumed by the jitted
factorization loop (the SolverMatrix analog, solverMatrixGen equivalent).
"""

from pastix_tpu_torch.analyze.layout import SolverLayout, build_layout
from pastix_tpu_torch.analyze.blocksym import tile_symbolic

__all__ = ["SolverLayout", "build_layout", "tile_symbolic"]
