"""The port's copies of the reference's host builders emit the reference's
tables, and the port's analysis yields the reference's layout.

poisson_3d(12), T=32.  Tables are compared for exact equality.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp

import pastix_tpu.krylov as JKR
import pastix_tpu.numeric.leftlook as JLL
import pastix_tpu.numeric.sweep_kernels as JSW
import pastix_tpu.solve as JSO
from pastix_tpu.analyze.layout import LevelTables, plan_dense_tail
from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.generators import poisson_3d
from pastix_tpu.pastix import Pastix as JPastix

import pastix_tpu_torch.krylov as KR
import pastix_tpu_torch.numeric.leftlook as LL
import pastix_tpu_torch.numeric.sweep_kernels as SW
import pastix_tpu_torch.solve as SO
from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import poisson_3d as port_poisson_3d
from pastix_tpu_torch.pastix import Pastix


def _cfg(cls=PastixConfig):
    return cls(tile_size=32, update_dtype="bfloat16")


@pytest.fixture(scope="module")
def solvers():
    A = poisson_3d(12)
    ref = JPastix(A, _cfg(JPastixConfig))
    ref.order()
    ref.symbfact()
    ref.analyze()
    port = Pastix(port_poisson_3d(12), _cfg(), device="cpu")
    port.order()
    port.symbfact()
    port.analyze()
    return ref, port


def _eq(a, b):
    """Exact equality of nested dict / list / tuple / array tables."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif dataclasses.is_dataclass(a):
        _eq(dataclasses.asdict(a), dataclasses.asdict(b))
    elif isinstance(a, np.ndarray):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_layout_matches_reference(solvers):
    ref, port = solvers
    lr, lp = ref.layout, port.layout
    for f in dataclasses.fields(lr):
        if f.name != "levels":
            _eq(getattr(lr, f.name), getattr(lp, f.name))
    _eq(lr.levels, lp.levels)
    assert port.report.dense_tail_m == ref.report.dense_tail_m > 0
    assert port.report.fact_flops == ref.report.fact_flops


def _busiest_incoming(lay):
    _, incoming, _ = JLL.regroup_left(lay.levels, lay.blk_col, None)
    li = int(np.argmax([i[0].size for i in incoming]))
    return incoming[li]


@pytest.mark.parametrize("rowb", [False, True], ids=["full_height", "rowb"])
@pytest.mark.parametrize("mode", ["bcache", "full", "auto"])
def test_build_ll_schedule_matches(solvers, mode, rowb):
    lay = solvers[0].layout
    ga, gb, gd, gk, _ = _busiest_incoming(lay)
    rb = (lay.row_lo, lay.row_hi) if rowb else None
    kw = dict(group=4, cap=24, mode=mode, rb=rb, T=lay.T)
    ref = JLL.build_ll_schedule(ga, gb, gd, **kw)
    got = LL.build_ll_schedule(ga, gb, gd, **kw)
    assert len(ref) > 1
    if rowb:
        assert {c["H"] for c in ref} != {lay.T}  # row-bounded classes occur
    _eq(ref, got)


@pytest.mark.parametrize("with_tail", [False, True], ids=["no_tail", "tail"])
def test_regroup_left_matches(solvers, with_tail):
    lay = solvers[0].layout
    dt = plan_dense_tail(lay) if with_tail else None
    levels = dt.levels_lo if dt is not None else lay.levels
    s = dt.s if dt is not None else None
    ref = JLL.regroup_left(levels, lay.blk_col, s)
    got = LL.regroup_left(levels, lay.blk_col, s)
    _eq(ref, got)
    # every level left-looking: nothing stays right-looking at its source
    assert sum(lv.gemm_a.size for lv in got[0]) == 0


def test_build_sweep_schedule_matches(solvers):
    lay = solvers[0].layout
    _eq(JSW.build_sweep_schedule(lay), SW.build_sweep_schedule(lay))
    _eq(JSW.build_sweep_schedule(lay, chunk_max=256, group=2),
        SW.build_sweep_schedule(lay, chunk_max=256, group=2))


def test_sweep_phase_offsets_cover_the_stream(solvers):
    lay = solvers[0].layout
    sched = SW.build_sweep_schedule(lay)
    offs = SW.sweep_phase_offsets(lay)
    for key in ("fwd", "bwd"):
        kd = np.concatenate([c["kd"] for c in sched[key]])
        dst = np.concatenate([c["dst"] for c in sched[key]])
        kd = kd[dst != lay.nbc]
        pos = 0
        for kind, lo, hi in offs[key]:
            assert lo == pos and hi > lo
            assert (kd[lo:hi] == (kind == "diag")).all()
            pos = hi
        assert pos == kd.size


@pytest.mark.parametrize("nrhs", [1, 3])
def test_rhs_blocks_match(solvers, nrhs):
    ref, port = solvers
    lay = ref.layout
    b = np.random.default_rng(0).standard_normal((ref.A.n, nrhs))
    b_ext = ref._perm_rhs(b)
    np.testing.assert_array_equal(port._perm_rhs(b), b_ext)
    for dt in (np.float32, np.float64):
        blk = SO.rhs_to_blocks(lay, b_ext, dtype=dt)
        _eq(JSO.rhs_to_blocks(lay, b_ext, dtype=dt), blk)
        _eq(JSO.blocks_to_rhs(lay, blk), SO.blocks_to_rhs(lay, blk))


def test_build_ell_matches(solvers):
    ref = solvers[0]
    lay = ref.layout
    Ac = sp.coo_matrix(ref._A_perm64)
    for dt in (np.float32, np.float64):
        _eq(JKR.build_ell(Ac, lay.nbc * lay.T, dt),
            KR.build_ell(Ac, lay.nbc * lay.T, dt))
