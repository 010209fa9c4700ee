"""The cache E2 kernels K11 (``gemm_scatter_vcache``) and K12
(``gemm_scatter_mp``) of ``numeric/cache.py`` and the copy probe K13
(``probe``) of ``numeric/dma_probe.py`` against the reference's
measurement scripts, on the CPU.

``exp_cache.py``, ``exp_mp.py`` and ``exp_dma.py`` run a 64³ analysis or
draw a 786 MB pool at import, so no test imports them.  Their functions
are lifted with ``ast`` and run in a namespace that supplies what they
read at module level (``np``, ``jax``, ``jnp``, ``lax``, ``pltpu``, ``T``,
``CT``, the ``_F_*`` flags), with ``pl`` a copy of
``jax.experimental.pallas`` whose ``pallas_call`` runs in interpret mode;
``exp_cache.py:67-74`` (the per-chunk tables, module-level code) is
wrapped in a function.  No reference file is edited.

- Tables: ``vcache_tables`` and ``build_mp_schedule`` equal the lifted
  code, array for array, on random triples and on a level, at G = 2 and
  4 and a chunk that cuts dst segments.
- The slice as a whole: the port's analysis of poisson_3d(8) at T=16
  feeds its busiest level (217 pairs) through the panel stream, the
  schedules (one chunk each), the plans and the twins; the reference's
  analysis feeds the lifted kernels in interpret mode.  Three interpret-mode calls: vcache, mp ``loop`` at G=2 and mp
  ``dot2`` at G=4, one chunk each (an interpret-mode pallas_call costs
  about a second per chunk; the XLA cases below cut dst segments across
  chunks).  Pools agree to 1e-5 of max|ref| (bf16 products are exact in
  fp32; the sums differ in order only).
- Every other case against the reference's XLA
  ``kernels.gemm_scatter(update_dtype=bf16)``, to the same tolerance.
- The probe: ``probe_ref`` is the closed form; the reference's ``probe``,
  lifted and run in interpret mode, returns a non-finite accumulator (its
  scratch is never zeroed; ``probe_sub`` adds into its own the same way):
  the recorded deviation, shown.
- The CPU route: CPU tensors take the twins, any other device never does.
"""

import ast
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as jpl
from jax.experimental.pallas import tpu as pltpu

import pastix_tpu.numeric.pallas_kernels as JPK
from pastix_tpu.config import PastixConfig as JPastixConfig
from pastix_tpu.generators import poisson_3d as j_poisson_3d
from pastix_tpu.numeric import kernels as JK
from pastix_tpu.pastix import Pastix as JPastix

from pastix_tpu_torch.config import PastixConfig
from pastix_tpu_torch.generators import poisson_3d
from pastix_tpu_torch.numeric import cache as CA
from pastix_tpu_torch.numeric import dma_probe as DP
from pastix_tpu_torch.numeric.pipelined import build_pipeline_schedule
from pastix_tpu_torch.pastix import Pastix

from torch_common import no_calibration  # noqa: F401 (autouse)

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5  # max|port - reference| / max|reference|
T = 16


def lift(script, names, wrap=None, **ns):
    """The functions ``names`` of a root script, exec'd in a namespace of
    ``ns`` and the JAX names the scripts import, with interpret-mode
    Pallas.  ``wrap`` (name, (first, last) line, result) wraps the
    module-level statements on those lines in ``def name(sched)``."""
    tree = ast.parse(open(os.path.join(ROOT, script)).read())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    if wrap is not None:
        name, (lo, hi), result = wrap
        stmts = [n for n in tree.body if lo <= n.lineno <= hi]
        fn = ast.parse(f"def {name}(sched):\n    return {result}").body[0]
        fn.body[:0] = stmts
        body.append(fn)
    mod = ast.fix_missing_locations(ast.Module(body=body, type_ignores=[]))
    pl = types.ModuleType("pl")
    pl.__dict__.update(jpl.__dict__)
    pl.pallas_call = functools.partial(jpl.pallas_call, interpret=True)
    g = dict(np=np, jax=jax, jnp=jnp, lax=lax, pl=pl, pltpu=pltpu,
             **{f: getattr(JPK, f) for f in ("_F_FIRST", "_F_LAST",
                                             "_F_WRWAIT", "_F_PAR",
                                             "_F_VALID")})
    g.update(ns)
    exec(compile(mod, script, "exec"), g)
    return g


@pytest.fixture(scope="module")
def ref_cache():
    return lift("exp_cache.py", {"mk_kernel", "gemm_scatter_vcache"},
                wrap=("tables", (67, 74), "CT"), T=T)


@pytest.fixture(scope="module")
def ref_mp():
    return lift("exp_mp.py", {"build_mp_schedule", "mk_mp_kernel",
                              "gemm_scatter_mp"}, T=T)


def _pool(npool, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((npool, T, T)).astype(np.float32) * 1e-3


@pytest.fixture(scope="module")
def triples():
    """40 random pairs on a 64-tile pool, a and b among the first 24
    tiles (the panel stream), dst among the rest."""
    rng = np.random.default_rng(3)
    ga = rng.integers(0, 24, 40).astype(np.int32)
    gb = rng.integers(0, 24, 40).astype(np.int32)
    gd = rng.integers(24, 64, 40).astype(np.int32)
    return ga, gb, gd, np.arange(24), _pool(64, 5)


@pytest.fixture(scope="module")
def level():
    """poisson_3d(8) at T=16: the busiest level as the port and the
    reference analyse it, a pool drawn as exp_cache.py draws its own, and
    the bf16 panel stream."""
    port = Pastix(poisson_3d(8), PastixConfig(tile_size=T), device="cpu")
    ref = JPastix(j_poisson_3d(8), JPastixConfig(tile_size=T))
    levels = []
    for s in (port, ref):
        s.order()
        s.symbfact()
        s.analyze()
        levels.append(max(s.layout.levels, key=lambda lv: lv.gemm_a.size))
    for f in ("gemm_a", "gemm_b", "gemm_d", "trsm_panel"):
        np.testing.assert_array_equal(getattr(levels[0], f),
                                      getattr(levels[1], f))
    pool = _pool(port.layout.npool, 0)
    return levels[0], levels[1], pool


def _tables_of(sched, keys):
    return [{k: np.asarray(t[k]) for k in keys} for t in sched]


def _assert_tables_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _inputs(case, triples, level):
    """(ga, gb, gd, ext_tiles, chunk) of a case: random triples or the
    level, each with a chunk that cuts dst segments."""
    if case == "random":
        ga, gb, gd, ext, _ = triples
        return ga, gb, gd, ext, 16
    lv = level[0]
    return lv.gemm_a, lv.gemm_b, lv.gemm_d, np.asarray(lv.trsm_panel), 96


@pytest.mark.parametrize("case", ["random", "level"])
def test_vcache_tables_equal_reference(ref_cache, triples, level, case):
    ga, gb, gd, ext, chunk = _inputs(case, triples, level)
    kw = dict(chunk=chunk, group=2, ext_tiles=ext)
    got = build_pipeline_schedule(ga, gb, gd, **kw)
    want = JPK.build_pipeline_schedule(ga, gb, gd, **kw)
    assert CA.vcache_tables(got) == ref_cache["tables"](want)
    assert sum(a["gd"][-1] == b["gd"][0] for a, b in zip(got, got[1:]))
    keys = ("cu", "ga_v", "gb_v")
    _assert_tables_equal(_tables_of(got, keys), _tables_of(want, keys))


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("case", ["random", "level"])
def test_mp_schedule_equals_reference(ref_mp, triples, level, case, G):
    ga, gb, gd, ext, chunk = _inputs(case, triples, level)
    got = CA.build_mp_schedule(ga, gb, gd, chunk, G, ext)
    want = ref_mp["build_mp_schedule"](ga, gb, gd, chunk, G, ext)
    assert len(got) > 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


def _port_level(level, sched_of):
    """The port's side of the slice: its pool, panel stream and plan."""
    lv, _, pool = level
    tp = np.asarray(lv.trsm_panel)
    P = torch.from_numpy(pool.copy())
    xab = P[torch.from_numpy(tp)].to(torch.bfloat16)
    return P, xab, sched_of(lv.gemm_a, lv.gemm_b, lv.gemm_d, tp)


def _ref_level(level):
    _, lv, pool = level
    tp = np.asarray(lv.trsm_panel)
    xab = jnp.asarray(pool[tp]).astype(jnp.bfloat16)
    return jnp.asarray(pool), xab, lv, tp


def test_vcache_level_matches_interpret_mode(ref_cache, level):
    P, xab, plan = _port_level(level, lambda a, b, d, tp: CA.vcache_plan(
        build_pipeline_schedule(a, b, d, group=2, ext_tiles=tp), "cpu"))
    assert len(plan.chunks) == 1
    got = CA.gemm_scatter_vcache(P, xab, plan).numpy()
    pool, jxab, lv, tp = _ref_level(level)
    sched = JPK.build_pipeline_schedule(lv.gemm_a, lv.gemm_b, lv.gemm_d,
                                        group=2, ext_tiles=tp)
    ref_cache["CT"] = ref_cache["tables"](sched)
    assert plan.ct == ref_cache["CT"]
    _close(got, ref_cache["gemm_scatter_vcache"](pool, jxab, sched))


@pytest.mark.parametrize("variant,G", [("loop", 2), ("dot2", 4)])
def test_mp_level_matches_interpret_mode(ref_mp, level, variant, G):
    chunk = 4096
    P, xab, plan = _port_level(level, lambda a, b, d, tp: CA.mp_plan(
        CA.build_mp_schedule(a, b, d, chunk, G, tp), "cpu"))
    got = CA.gemm_scatter_mp(P, xab, plan, variant).numpy()
    pool, jxab, lv, tp = _ref_level(level)
    sched = ref_mp["build_mp_schedule"](lv.gemm_a, lv.gemm_b, lv.gemm_d,
                                        chunk, G, tp)
    assert len(plan.chunks) == len(sched) == 1
    assert plan.ct == -(-max(t["CT"] for t in sched) // 8) * 8
    _close(got, ref_mp["gemm_scatter_mp"](pool, jxab, sched, variant))


@pytest.fixture(scope="module")
def xla(triples):
    """The reference's XLA gemm_scatter of the triples, bf16 operands."""
    ga, gb, gd, _, pool = triples
    return np.asarray(JK.gemm_scatter(jnp.asarray(pool), ga, gb, gd,
                                      update_dtype=jnp.bfloat16))


@pytest.mark.parametrize("group", [1, 2, 4])
def test_vcache_twin_matches_xla(triples, xla, group):
    ga, gb, gd, ext, pool = triples
    sched = build_pipeline_schedule(ga, gb, gd, chunk=16, group=group,
                                    ext_tiles=ext)
    assert sum(a["gd"][-1] == b["gd"][0] for a, b in zip(sched, sched[1:]))
    plan = CA.vcache_plan(sched, "cpu")
    P = torch.from_numpy(pool.copy())
    xab = P[torch.from_numpy(ext)].to(torch.bfloat16)
    _close(CA.gemm_scatter_vcache_ref(P, xab, plan).numpy(), xla)


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", CA.MP_VARIANTS)
@pytest.mark.parametrize("chunk", [16, 4096])
def test_mp_twin_matches_xla(triples, xla, variant, G, chunk):
    ga, gb, gd, ext, pool = triples
    plan = CA.mp_plan(CA.build_mp_schedule(ga, gb, gd, chunk, G, ext), "cpu")
    assert plan.group == G and (len(plan.chunks) > 1) == (chunk == 16)
    P = torch.from_numpy(pool.copy())
    xab = P[torch.from_numpy(ext)].to(torch.bfloat16)
    _close(CA.gemm_scatter_mp_ref(P, xab, plan, variant).numpy(), xla)


@pytest.mark.parametrize("G,chunk", [(3, 4096), (8, 24)])
def test_mp_pieces_cut_at_step_boundaries(triples, G, chunk):
    """K12's kernel tables (the triples plus one segment of 30 pairs):
    the real pairs are the padded tables' without their null pairs, in
    order, each step's last marked; the pieces (cut at 8 pairs where no
    card is counted) start at step starts only and cover each segment's
    steps once, in order; and the update summed as the kernel sums it
    (each step's products, the steps into their piece, a cut segment's
    pieces added in piece order, then subtracted once) equals the twin's
    (1e-5 of max|ref|)."""
    ga, gb, gd, ext, pool = triples
    ga, gb = np.r_[ga, ga[:30]], np.r_[gb, gb[:30]]
    gd = np.r_[np.where(gd == 63, 62, gd), np.full(30, 63)].astype(np.int32)
    plan = CA.mp_plan(CA.build_mp_schedule(ga, gb, gd, chunk, G, ext), "cpu")
    assert (len(plan.chunks) > 1) == (chunk == 24)
    P = torch.from_numpy(pool.copy())
    xab = P[torch.from_numpy(ext)].to(torch.bfloat16)
    buf = torch.empty((plan.ct, T, T), dtype=torch.bfloat16)
    got, cuts = P.clone(), 0
    for c in plan.chunks:
        pa, ra, rb, last, rsp, pp, ps, spp, slot = (x.numpy() for x in (
            c.pos_a, c.real_a, c.real_b, c.real_last, c.real_seg_ptr,
            c.piece_ptr, c.piece_seg, c.seg_piece_ptr, c.piece_slot))
        real = pa < c.cu.numel()
        np.testing.assert_array_equal(ra, pa[real])
        np.testing.assert_array_equal(rb, c.pos_b.numpy()[real])
        steps = np.r_[0, np.cumsum(real.reshape(-1, G).sum(1))]
        assert (np.diff(steps) > 0).all() and steps[-1] == c.n_pairs
        np.testing.assert_array_equal(np.flatnonzero(last), steps[1:] - 1)
        np.testing.assert_array_equal(rsp, steps[c.seg_ptr.numpy()])
        assert pp[0] == 0 and pp[-1] == c.n_pairs and (np.diff(pp) > 0).all()
        assert np.isin(pp, steps).all()
        np.testing.assert_array_equal(pp[spp], rsp)
        np.testing.assert_array_equal(
            np.repeat(np.arange(c.nseg), np.diff(spp)), ps)
        cut = np.diff(spp)[ps] > 1
        np.testing.assert_array_equal(slot[cut], np.arange(c.nslot))
        assert (slot[~cut] == -1).all()
        cuts += c.nslot
        CA._fill(buf, xab, c)
        for g in range(c.nseg):
            total = torch.zeros(T, T)
            for p in range(spp[g], spp[g + 1]):
                part, step = torch.zeros(T, T), torch.zeros(T, T)
                for i in range(pp[p], pp[p + 1]):
                    step += (buf[ra[i]].float() @ buf[rb[i]].float().T)
                    if last[i]:
                        part, step = part + step, torch.zeros(T, T)
                assert not step.any()  # a piece ends at a step's end
                total += part
            got[c.seg_dst[g]] -= total
    assert cuts > 0
    _close(got.numpy(), CA.gemm_scatter_mp_ref(P.clone(), xab, plan).numpy())


def test_plans_refuse_what_they_do_not_take(triples):
    ga, gb, gd, ext, pool = triples
    with pytest.raises(ValueError, match="ext_tiles"):
        CA.vcache_plan(build_pipeline_schedule(ga, gb, gd), "cpu")
    P = torch.from_numpy(pool.copy())
    xab = P[:24].to(torch.bfloat16)
    vplan = CA.vcache_plan(build_pipeline_schedule(
        ga, gb, gd, group=2, ext_tiles=ext), "cpu")
    mplan = CA.mp_plan(CA.build_mp_schedule(ga, gb, gd, 16, 4, ext), "cpu")
    with pytest.raises(ValueError, match="mp_plan"):
        CA.gemm_scatter_mp(P, xab, vplan)
    with pytest.raises(ValueError, match="vcache_plan"):
        CA.gemm_scatter_vcache(P, xab, mplan)
    with pytest.raises(ValueError, match="variant"):
        CA.gemm_scatter_mp(P, xab, mplan, "dot3")
    with pytest.raises(ValueError, match="bfloat16"):
        CA.gemm_scatter_vcache(P, P[:24], vplan)


def _probe_inputs(rows=T, n=24, steps=5, D=3, S=2, seed=1):
    rng = np.random.default_rng(seed)
    view = rng.standard_normal((n, rows, T)).astype(np.float32)
    idx = rng.integers(0, n - S, (steps, D)).astype(np.int32)
    return torch.from_numpy(view), torch.from_numpy(idx)


@pytest.mark.parametrize("rows", [T, T // 2])
def test_probe_ref_is_the_closed_form(rows):
    view, idx = _probe_inputs(rows=rows)
    v, ix = view.numpy(), idx.numpy()
    want = np.stack([
        [7 * sum(v[ix[i, d] + k, r, :].astype(np.float64)
                 for i in range(ix.shape[0]))
         for d in range(ix.shape[1])]
        for k, r in ((0, 0), (1, rows - 1))])  # S = 2: first, last row
    got = DP.probe_ref(view, idx, 2, 7)
    assert got.shape == (2, 3, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_reference_probe_accumulator_is_not_finite():
    """exp_dma.py's probe adds into a scratch accumulator that is never
    zeroed (exp_dma.py:59; probe_sub the same at :149): run as written,
    in interpret mode, it returns non-finite values, where the port's
    probe returns reps * sum_i view[idx[i, 0], 0, :] in [0, 0]."""
    rng = np.random.default_rng(0)
    pool = jnp.asarray(rng.standard_normal((24, T, T)).astype(np.float32))
    outs = []
    jx = types.SimpleNamespace(
        jit=jax.jit, ShapeDtypeStruct=jax.ShapeDtypeStruct,
        block_until_ready=lambda x: outs.append(np.asarray(x)))
    g = lift("exp_dma.py", {"probe"}, T=T, npool=24, rng=rng,
             pool=pool, time=__import__("time"),
             print=lambda *a, **k: None)
    g["jax"] = jx
    g["probe"](2, 2, 4, 3)
    assert len(outs) == 4 and all(o.shape == (1, T) for o in outs)
    assert not any(np.isfinite(o).all() for o in outs)


def test_cpu_tensors_take_the_twins(triples):
    """The wrappers choose the twin by the tensor's device alone: a CPU
    tensor runs it, any other device never does (a CUDA tensor launches
    the kernel or raises; here a meta tensor raises)."""
    ga, gb, gd, ext, pool = triples
    P = torch.from_numpy(pool.copy())
    xab = P[torch.from_numpy(ext)].to(torch.bfloat16)
    vplan = CA.vcache_plan(build_pipeline_schedule(
        ga, gb, gd, group=2, ext_tiles=ext), "cpu")
    mplan = CA.mp_plan(CA.build_mp_schedule(ga, gb, gd, 16, 2, ext), "cpu")
    view, idx = _probe_inputs()
    runs = (
        (CA.gemm_scatter_vcache, lambda t: (t(P), t(xab), vplan)),
        (CA.gemm_scatter_mp, lambda t: (t(P), t(xab), mplan, "dot2")),
        (DP.probe, lambda t: (t(view), t(idx), 2, 3)),
    )
    for fn, args in runs:
        n0, t0 = fn.launches, fn.twin_launches
        fn(*args(lambda x: x))
        assert (fn.launches, fn.twin_launches) == (n0, t0 + 1)
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*args(lambda x: x.to("meta")))
        assert (fn.launches, fn.twin_launches) == (n0, t0 + 1)
    np.testing.assert_array_equal(DP.probe(view, idx, 2, 3),
                                  DP.probe_ref(view, idx, 2, 3))


def test_probe_refuses_bad_indices():
    view, idx = _probe_inputs(n=24, S=2)
    for bad in (21, -1):
        ix = idx.clone()
        ix[1, 2] = bad
        with pytest.raises(ValueError, match=r"idx must lie in \[0, 20\]"):
            DP.probe(view, ix, 4, 1)
    DP.probe(view, idx, 4, 1)
    with pytest.raises(ValueError, match="int32"):
        DP.probe(view, idx.long(), 2, 1)
    with pytest.raises(ValueError, match="at most 24 copies"):
        DP.probe(view, torch.zeros((2, 25), dtype=torch.int32), 2, 1)
    with pytest.raises(ValueError, match="ctas"):
        DP.probe(view, idx, 2, 1, ctas=-1)
    with pytest.raises(ValueError, match="must be a multiple of 16 B"):
        DP.probe(view, idx, 2, 1, piece=8)  # 8 B pieces
    DP.probe(view, idx, 2, 1, piece=64)  # one row a piece
    assert DP.piece_bytes(3, T, T, 4096) == 1024  # gcd(3 KB, 4 KB)
