"""Configuration and report structures.

Equivalent of the reference's parameter surface: the ``iparm[128]`` /
``dparm[64]`` arrays and the ``API_*`` enums declared in
``src/common/src/api.h`` (reference anchor; see SURVEY.md section 2 row 1),
with defaults set by ``pastix_initParam`` (``src/sopalin/src/pastix.c``).

Instead of two opaque arrays we expose a typed dataclass; the mapping from
the reference's slots to fields is documented per-field so a PaStiX user can
find every knob.  Run-time outputs (the reference's *output* iparm/dparm
slots such as IPARM_NNZEROS, DPARM_FILL_IN, DPARM_FACT_TIME) live in
:class:`SolveReport`.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

# the tile sizes the card's kernels (K1-K4) are built for
CARD_TILES = (32, 64, 128)


class Task(enum.IntEnum):
    """Pipeline phases — reference API_TASK_* (api.h)."""

    INIT = 0
    ORDERING = 1  # API_TASK_ORDERING
    SYMBFACT = 2  # API_TASK_SYMBFACT
    ANALYSE = 3  # API_TASK_ANALYSE (blend)
    NUMFACT = 4  # API_TASK_NUMFACT (sopalin)
    SOLVE = 5  # API_TASK_SOLVE (updown)
    REFINE = 6  # API_TASK_REFINE (raff)
    CLEAN = 7  # API_TASK_CLEAN


class Factorization(enum.Enum):
    """Factorization kind — reference API_FACT_* (api.h)."""

    LLT = "llt"  # Cholesky, SPD
    LDLT = "ldlt"  # symmetric indefinite (static pivoting only)
    LU = "lu"  # general, static pivoting
    LDLH = "ldlh"  # Hermitian (complex) — maps onto LDLT with conj


class Symmetry(enum.Enum):
    """Matrix symmetry — reference API_SYM_* (api.h)."""

    SYMMETRIC = "symmetric"  # API_SYM_YES: only lower triangle stored
    UNSYMMETRIC = "unsymmetric"  # API_SYM_NO: full pattern stored
    HERMITIAN = "hermitian"  # API_SYM_HER


class OrderingMethod(enum.Enum):
    """Fill-reducing ordering — reference IPARM_ORDERING = API_ORDER_*."""

    ND = "nd"  # nested dissection (the Scotch-equivalent default)
    AMD = "amd"  # minimum-degree family
    RCM = "rcm"  # bandwidth reduction (not fill-optimal; for comparison)
    NATURAL = "natural"  # identity permutation
    PERSONAL = "personal"  # API_ORDER_PERSONAL: user supplies perm
    LOAD = "load"  # API_ORDER_LOAD: read a saved ordering


class RefinementMethod(enum.Enum):
    """Iterative refinement — reference IPARM_REFINEMENT = API_RAF_*."""

    SIMPLE = "simple"  # API_RAF_PIVOT: Richardson iteration
    CG = "cg"  # API_RAF_GRAD: preconditioned conjugate gradient
    GMRES = "gmres"  # API_RAF_GMRES
    BICGSTAB = "bicgstab"  # API_RAF_BICGSTAB
    NONE = "none"


class IOStrategy(enum.Enum):
    """Phase-artifact persistence — reference IPARM_IO_STRATEGY = API_IO_*."""

    NO = "no"
    SAVE = "save"  # save ordering + symbol after analysis
    LOAD = "load"  # load them instead of recomputing


class Verbosity(enum.IntEnum):
    """Reference IPARM_VERBOSE = API_VERBOSE_*."""

    NOT = 0  # API_VERBOSE_NOT
    NO = 1  # API_VERBOSE_NO (phase banners)
    YES = 2  # API_VERBOSE_YES (stats)
    CHATTERBOX = 3  # API_VERBOSE_CHATTERBOX


@dataclasses.dataclass
class PastixConfig:
    """Solver configuration.

    Field → reference slot mapping (api.h names) is given per field.
    """

    # --- factorization selection ---
    factorization: Factorization = Factorization.LLT  # IPARM_FACTORIZATION
    symmetry: Symmetry = Symmetry.SYMMETRIC  # IPARM_SYM

    # --- ordering (phase 1) ---
    ordering: OrderingMethod = OrderingMethod.ND  # IPARM_ORDERING
    dof_nbr: int = 1  # IPARM_DOF_NBR: degrees of freedom per graph node.
    # With d > 1 the matrix rows {i*d .. i*d+d-1} belong to node i (the
    # reference's node-compressed input with dense d x d blocks, e.g. 3D
    # elasticity with d=3): ordering runs on the d-times-smaller node
    # graph and the permutation/supernode ranges are expanded so a node's
    # dofs stay adjacent — same fill, ~d^2 cheaper ordering, and supernodes
    # start d-wide before amalgamation.  scipy BSR input with blocksize
    # (d, d) is accepted directly.
    nd_leaf_size: Optional[int] = None  # IPARM_ORDERING_CMIN-analog: stop
    # ND below this subgraph size; None = track the resolved tile size
    # (leaves become single tile columns: fewest levels AND least padding)
    nd_max_levels: int = 64
    amalgamation_level: int = 10  # IPARM_AMALGAMATION_LEVEL (% extra fill)

    # --- analysis / tiling (phase 3; replaces blend's splitpart knobs) ---
    tile_size: Optional[int] = None  # IPARM_MAX_BLOCKSIZE analog; None=auto
    min_tile_size: int = 16  # IPARM_MIN_BLOCKSIZE analog
    align_supernodes: bool = True  # amalgamate+pad supernodes to tile grid
    cluster_supernode_rows: bool = True  # within-supernode dof sort that
    # clusters rows reached by the same descendants into the same row
    # tiles (~9% fewer padded flops; no fill change, no reference analog)
    amalg_target_frac: float = 0.30  # chain-merge supernodes until width >=
    # this fraction of the tile size.  Flagship sweep (exp_pad2, v5e r4):
    # 0.28-0.35 gives padded/useful 3.20-3.22 vs 3.38 at the old 0.5
    # default, with FEWER levels (202-205 vs 222) and ~equal pool — the
    # wider columns the old target bought were mostly padding.
    # (~6x fewer padded flops / ~10x fewer levels vs no amalgamation)

    # --- numeric (phase 4) ---
    compute_dtype: str = "float32"  # factor storage/compute dtype
    update_dtype: Optional[str] = None  # bf16 trailing updates when set
    static_pivoting_threshold: float = 1e-14  # DPARM_EPSILON_MAGN_CTRL
    # (pivots with |d| < threshold * ||A|| are clamped; count reported
    #  like IPARM_STATIC_PIVOTING)

    packed_update: Optional[bool] = None  # compute panel TRSM + trailing
    # updates over packed scalar row supports (analyze/packed.py): the
    # a-side of every update GEMM is packed to its scalar row support,
    # cutting device GEMM flops ~2.3x.  None = auto: ON for CPU backends
    # (measured ~1.7x faster), OFF on TPU — the row-granular extend-add is
    # index-rate-bound in XLA's TPU scatter (~65 ns/row; measured 2.6x
    # SLOWER end to end, exp_full.py r2) and the TPU factorization is
    # latency-bound on the per-level diagonal chain, not update flops.
    # Complete factorizations only; ILU(k) keeps the tile path.

    dense_tail: bool = True  # factor the fully-dense trailing block-column
    # suffix (top separators) with ONE dense blocked Cholesky instead of a
    # per-tile-column level chain — removes O(q) sequential kernels from
    # the critical path (the reference's 2D-distribution analog; LLT only)
    dense_tail_fill: float = 0.25  # relaxed terminal amalgamation: add
    # explicit-zero tiles (up to this fraction of the suffix's dense size)
    # to extend the dense tail past the strictly-dense region

    # --- solve / refinement (phases 5-6) ---
    fast_solve: bool = True  # precompute diag-tile inverses: solve sweeps
    # become pure matmuls (MXU) instead of per-level triangular loops
    device_refine: bool = True  # fuse solve + Richardson refinement into
    # one jitted device program (one host->device dispatch instead of one
    # per iteration); the host fp64 loop finishes the descent below the
    # fp32 floor when refinement_eps asks for more
    refinement: RefinementMethod = RefinementMethod.SIMPLE  # IPARM_REFINEMENT
    refinement_eps: float = 1e-10  # DPARM_EPSILON_REFINEMENT
    refinement_itermax: int = 250  # IPARM_ITERMAX
    gmres_restart: int = 30  # IPARM_GMRES_IM
    residual_dtype: str = "float64"  # residuals accumulated here (host)

    # --- Schur complement ---
    schur: bool = False  # pastix_setSchurUnknownList analog
    # (set the unknown list via Pastix.set_schur_unknowns)

    # --- incomplete factorization (ILU(k) preconditioner mode) ---
    incomplete: bool = False  # IPARM_INCOMPLETE
    level_of_fill: int = 1  # IPARM_LEVEL_OF_FILL
    ilu_grain: str = "block"  # fill granularity of the ILU(k) pattern:
    # "block"  — tile-quotient levels (T-wide block fill; the device path);
    # "scalar" — exact scalar levels + host IKJ numeric (the reference's
    #            kass SF_level.c grain; ~3-4x less factor memory, applied
    #            on the host — analyze/scalar_ilu.py)

    # --- tracing (TRACE_SOPALIN analog) ---
    trace: bool = False  # collect phase spans; dump with Pastix.dump_trace()

    # --- io / misc ---
    io_strategy: IOStrategy = IOStrategy.NO  # IPARM_IO_STRATEGY
    io_dir: str = "."
    verbosity: Verbosity = Verbosity.NOT  # IPARM_VERBOSE
    check_matrix: bool = True  # pastix_checkMatrix on input
    start_task: Task = Task.ORDERING  # IPARM_START_TASK
    end_task: Task = Task.REFINE  # IPARM_END_TASK
    seed: int = 0

    # --- distribution (replaces IPARM_THREAD_NBR / MPI world) ---
    mesh_shape: Optional[tuple] = None  # e.g. (8,) or (4, 2); None = 1 device
    mesh_axis_names: tuple = ("tp",)
    shard_pool: Optional[bool] = None  # owner-computes distribution of the
    # tile pool itself over the tp axis (parallel/owner.py): each device
    # holds ~npool/ndev tiles + per-level halo/fan-in buffers, the way the
    # reference's blend emits a local SolverMatrix per rank.  None = auto
    # (on for real LL^T on a tp mesh); False = replicated-pool builders.
    dist_strategy: str = "level"  # multi-device schedule over the tp axis:
    # "level"   — bulk-synchronous per-level psum fan-in (parallel/sharded.py;
    #             all factorization kinds, dense-tail 2D sharding);
    # "subtree" — proportional etree-subtree mapping (the reference's
    #             distribPart/cand analog, parallel/subtree.py): each device
    #             factors its own subtrees with ZERO collectives, then one
    #             boundary psum and a bulk-synchronous shared top.  LLT with
    #             real dtypes only; other kinds fall back to "level".

    # --- out-of-core analog (host-RAM panel offload) ---
    ooc: bool = False  # IPARM_OOC_LIMIT != 0
    ooc_limit_mb: int = 0  # IPARM_OOC_LIMIT

    def __post_init__(self):
        if self.factorization in (Factorization.LLT, Factorization.LDLT):
            if self.symmetry == Symmetry.UNSYMMETRIC:
                raise ValueError(
                    f"{self.factorization} requires a symmetric matrix; "
                    "use Factorization.LU for unsymmetric input"
                )
        if self.factorization == Factorization.LU:
            # LU works on the symmetrized pattern but full values
            self.symmetry = Symmetry.UNSYMMETRIC
        if self.tile_size is not None and self.tile_size < 1:
            raise ValueError("tile_size must be >= 1")
        if self.dof_nbr < 1:
            raise ValueError("dof_nbr must be >= 1")
        if self.ilu_grain not in ("block", "scalar"):
            raise ValueError("ilu_grain must be 'block' or 'scalar'")
        if self.incomplete and self.refinement == RefinementMethod.SIMPLE:
            # ILU(k) factors are approximate: Richardson may stall, a Krylov
            # method is the intended consumer (reference pairs IPARM_INCOMPLETE
            # with API_RAF_GMRES/GRAD)
            self.refinement = RefinementMethod.GMRES

    @classmethod
    def from_iparm(cls, iparm: dict | None = None, dparm: dict | None = None,
                   **kw) -> "PastixConfig":
        """Build a config from reference-style slot names.

        Accepts IPARM_*/DPARM_* keys with API_* string or int values, e.g.::

            PastixConfig.from_iparm(
                {"IPARM_FACTORIZATION": "API_FACT_LDLT",
                 "IPARM_ORDERING": "API_ORDER_SCOTCH",
                 "IPARM_ITERMAX": 100},
                {"DPARM_EPSILON_REFINEMENT": 1e-12},
            )

        Unknown slots raise (fail loudly, like pastix_check_param).
        """
        out = dict(kw)
        fact_map = {
            "API_FACT_LLT": Factorization.LLT, 0: Factorization.LLT,
            "API_FACT_LDLT": Factorization.LDLT, 1: Factorization.LDLT,
            "API_FACT_LU": Factorization.LU, 2: Factorization.LU,
            "API_FACT_LDLH": Factorization.LDLH, 3: Factorization.LDLH,
        }
        ord_map = {
            "API_ORDER_SCOTCH": OrderingMethod.ND, 0: OrderingMethod.ND,
            "API_ORDER_METIS": OrderingMethod.ND, 1: OrderingMethod.ND,
            "API_ORDER_PERSONAL": OrderingMethod.PERSONAL, 2: OrderingMethod.PERSONAL,
            "API_ORDER_LOAD": OrderingMethod.LOAD, 3: OrderingMethod.LOAD,
        }
        raf_map = {
            "API_RAF_GMRES": RefinementMethod.GMRES, 0: RefinementMethod.GMRES,
            "API_RAF_GRAD": RefinementMethod.CG, 1: RefinementMethod.CG,
            "API_RAF_PIVOT": RefinementMethod.SIMPLE, 2: RefinementMethod.SIMPLE,
            "API_RAF_BICGSTAB": RefinementMethod.BICGSTAB, 3: RefinementMethod.BICGSTAB,
        }
        sym_map = {
            "API_SYM_YES": Symmetry.SYMMETRIC, 1: Symmetry.SYMMETRIC,
            "API_SYM_NO": Symmetry.UNSYMMETRIC, 0: Symmetry.UNSYMMETRIC,
            "API_SYM_HER": Symmetry.HERMITIAN, 2: Symmetry.HERMITIAN,
        }
        io_map = {
            "API_IO_NO": IOStrategy.NO, 0: IOStrategy.NO,
            "API_IO_SAVE": IOStrategy.SAVE, 1: IOStrategy.SAVE,
            "API_IO_LOAD": IOStrategy.LOAD, 2: IOStrategy.LOAD,
        }
        islots = {
            "IPARM_FACTORIZATION": ("factorization", fact_map.get),
            "IPARM_ORDERING": ("ordering", ord_map.get),
            "IPARM_REFINEMENT": ("refinement", raf_map.get),
            "IPARM_SYM": ("symmetry", sym_map.get),
            "IPARM_IO_STRATEGY": ("io_strategy", io_map.get),
            "IPARM_ITERMAX": ("refinement_itermax", int),
            "IPARM_GMRES_IM": ("gmres_restart", int),
            "IPARM_VERBOSE": ("verbosity", int),
            "IPARM_MAX_BLOCKSIZE": ("tile_size", int),
            "IPARM_MIN_BLOCKSIZE": ("min_tile_size", int),
            "IPARM_AMALGAMATION_LEVEL": ("amalgamation_level", int),
            "IPARM_INCOMPLETE": ("incomplete", bool),
            "IPARM_LEVEL_OF_FILL": ("level_of_fill", int),
            "IPARM_OOC_LIMIT": ("ooc_limit_mb", int),
            "IPARM_SCHUR": ("schur", bool),
            "IPARM_START_TASK": ("start_task", Task),
            "IPARM_END_TASK": ("end_task", Task),
            "IPARM_DOF_NBR": ("dof_nbr", int),
        }
        dslots = {
            "DPARM_EPSILON_REFINEMENT": ("refinement_eps", float),
            "DPARM_EPSILON_MAGN_CTRL": ("static_pivoting_threshold", float),
        }
        for src, slots in ((iparm or {}, islots), (dparm or {}, dslots)):
            for key, val in src.items():
                if key not in slots:
                    raise ValueError(f"unknown parameter slot '{key}'")
                field, conv = slots[key]
                cv = conv(val)
                if cv is None:
                    raise ValueError(f"bad value {val!r} for {key}")
                out[field] = cv
        if (iparm or {}).get("IPARM_OOC_LIMIT"):
            out["ooc"] = True  # a nonzero limit slot enables OOC mode
        elif out.get("ooc_limit_mb"):
            out.setdefault("ooc", True)
        return cls(**out)

    def resolve_tile_size(self, n: int, card: bool = False) -> int:
        """Pick the tile size for an n-dof problem.

        MXU-guided: 128 once panels are large enough to fill the systolic
        array; smaller power-of-two tiles for small problems so padding
        stays bounded.  On the card (``card``), whose kernels are built
        for :data:`CARD_TILES`, a size left open is at least 32.
        """
        if self.tile_size is not None:
            return self.tile_size
        if n >= 60_000:
            return 128
        if n >= 12_000:
            return 64
        if n >= 2_000:
            return 32
        return CARD_TILES[0] if card else 16


@dataclasses.dataclass
class SolveReport:
    """Per-run outputs — the reference's *output* iparm/dparm slots.

    Reference anchors: IPARM_NNZEROS, DPARM_FILL_IN, DPARM_FACT_FLOPS,
    DPARM_ANALYZE_TIME / DPARM_FACT_TIME / DPARM_SOLV_TIME /
    DPARM_RAFF_TIME, IPARM_STATIC_PIVOTING (api.h; sopalin timers).
    """

    n: int = 0
    nnz_a: int = 0
    nnz_l: int = 0  # IPARM_NNZEROS (scalar, block-padded)
    nnz_l_exact: int = 0  # exact scalar nnz(L) from the symbolic cost model
    fill_ratio: float = 0.0  # DPARM_FILL_IN
    fact_flops: float = 0.0  # DPARM_FACT_FLOPS (useful flops)
    fact_flops_padded: float = 0.0  # flops incl. tile padding (device work)
    order_time: float = 0.0
    symbfact_time: float = 0.0
    analyze_time: float = 0.0  # DPARM_ANALYZE_TIME
    fact_time: float = 0.0  # DPARM_FACT_TIME
    solve_time: float = 0.0  # DPARM_SOLV_TIME
    refine_time: float = 0.0  # DPARM_RAFF_TIME
    fact_gflops: float = 0.0  # achieved useful GFLOP/s
    predicted_fact_time: float = 0.0  # perf-model prediction (0 = none):
    # the measured-calibration analog of blend's simulated schedule cost
    static_pivots: int = 0  # IPARM_STATIC_PIVOTING
    refine_iters: int = 0
    residual: float = 0.0  # final ||b - Ax|| / ||b||
    tile_size: int = 0
    n_tiles: int = 0
    n_levels: int = 0
    dense_tail_m: int = 0  # width of the dense terminal block (0 = off)
    padding_waste: float = 0.0  # padded/useful flop ratio - 1
    memory_bytes: int = 0  # pastix_getMemoryUsage analog (device pools)
    memory_terms: int = 0  # IPARM_ALLOCATED_TERMS: allocated coefficient
    # terms (memory_bytes // dtype itemsize — the reference slot counts
    # terms, not bytes)
    fallbacks: list = dataclasses.field(default_factory=list)
    # names of platform fallbacks that fired (remote-TPU degradations:
    # "dinv-compile", "fast-solve", "dense-tail-solve", "fused-refine");
    # empty on a healthy run — tests assert this on CPU

    def to_iparm(self) -> tuple[dict, dict]:
        """Outputs under the reference's slot names: (iparm, dparm) dicts.

        Mirrors what a reference caller reads back from iparm[]/dparm[]
        after pastix() returns (api.h output slots)."""
        iparm = {
            "IPARM_NNZEROS": self.nnz_l_exact,
            "IPARM_NNZEROS_BLOCK_LOCAL": self.nnz_l,
            "IPARM_STATIC_PIVOTING": self.static_pivots,
            "IPARM_NBITER": self.refine_iters,
            "IPARM_ALLOCATED_TERMS": self.memory_terms,
            # bytes exposed under a non-reference key (the reference slot
            # counts coefficient terms)
            "PASTIX_TPU_MEMORY_BYTES": self.memory_bytes,
        }
        dparm = {
            "DPARM_FILL_IN": self.fill_ratio,
            "DPARM_FACT_FLOPS": self.fact_flops,
            "DPARM_ANALYZE_TIME": self.analyze_time,
            "DPARM_PRED_FACT_TIME": 0.0,
            "DPARM_FACT_TIME": self.fact_time,
            "DPARM_SOLV_TIME": self.solve_time,
            "DPARM_RAFF_TIME": self.refine_time,
            "DPARM_RELATIVE_ERROR": self.residual,
        }
        return iparm, dparm

    def summary(self) -> str:
        lines = [
            f"n={self.n} nnz(A)={self.nnz_a} nnz(L)={self.nnz_l} "
            f"(exact {self.nnz_l_exact}, fill {self.fill_ratio:.2f}x)",
            f"flops={self.fact_flops:.3e} (padded {self.fact_flops_padded:.3e}, "
            f"waste {100 * self.padding_waste:.1f}%)",
            f"times: order={self.order_time:.3f}s symb={self.symbfact_time:.3f}s "
            f"analyze={self.analyze_time:.3f}s fact={self.fact_time:.3f}s "
            f"solve={self.solve_time:.3f}s refine={self.refine_time:.3f}s",
            f"fact rate: {self.fact_gflops:.2f} GFLOP/s",
            f"static pivots: {self.static_pivots}  refine iters: {self.refine_iters}",
            f"residual ||b-Ax||/||b|| = {self.residual:.3e}",
        ]
        return "\n".join(lines)
