"""K2's plain twin (``sweep_fwd`` + ``sweep_bwd`` on the CPU) against the
reference's Pallas ``run_sweep`` in interpret mode, on the same factored
pool, inverse diagonals and RHS (numpy, from a seed), R in {1, 3}.
poisson_3d(8), T=32: interpret mode costs about 10 ms per op on a CPU,
so the reference sweeps both cases' RHS in one run (R = 4).

Tolerance: rtol=1e-5 against max|ref|; both run fp32 arithmetic and
differ in summation order only.  The LU sweeps (forward on the L pool
with the unit-lower inverses, backward on the Uᵗ pool with the upper
inverses: updates transposed, the diagonal untransposed) the same way,
on convection_diffusion_3d(5)'s LU factors at R = 2.

K2's work items (``sweep_items``): every wait points at a smaller ticket,
the expected counts are the sub-segments per dst, and a plain replay of
the items, in ticket order and in a shuffled order that respects the
waits, with the twin's arithmetic (its per-op products, its order of
subtraction per dst), gives the twin's sweeps bit for bit on the CPU.
The replay is a test helper, not a second twin.
"""

import collections

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pastix_tpu.numeric.sweep_kernels as JSW
from pastix_tpu_torch.config import Factorization, PastixConfig
from pastix_tpu_torch.generators import convection_diffusion_3d, poisson_3d

import pastix_tpu_torch.numeric.sweep_kernels as SW
from pastix_tpu_torch.pastix import Pastix

# xdist runs six test files at once: one intra-op thread per process keeps
# six full-width PyTorch thread pools from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(JSW, "_INTERPRET", True)


@pytest.fixture(scope="module")
def factored():
    s = Pastix(poisson_3d(8), PastixConfig(tile_size=32), device="cpu")
    s.factorize()
    return s


@pytest.fixture(scope="module")
def reference_sweeps(factored):
    """{R: (RHS, the reference's forward + backward sweeps of it)} for R
    in {1, 3}.  Interpret mode costs per padded op, not per column, and
    the sweeps act on each column alone: the reference runs once on both
    cases' columns side by side (R = 4), and each case reads its own."""
    lay, f = factored.layout, factored.factors
    ys = {R: np.random.default_rng(R).standard_normal(
        (lay.nbc * R, lay.T)).astype(np.float32) for R in (1, 3)}
    both = np.concatenate([ys[1].reshape(lay.nbc, 1, lay.T),
                           ys[3].reshape(lay.nbc, 3, lay.T)], axis=1)
    pool, dinv = jnp.asarray(f.pool.numpy()), jnp.asarray(f.dinv.numpy())
    # interpret mode costs per padded op: one chunk that just fits
    nops = sum(len(lv.cols) + len(lv.trsm_panel) for lv in lay.levels)
    sched = JSW.build_sweep_schedule(lay, chunk_max=-(-nops // 4) * 4)
    ref = JSW.sweep_fwd(pool, dinv, jnp.asarray(both.reshape(-1, lay.T)),
                        sched, interpret=True)
    ref = np.asarray(JSW.sweep_bwd(pool, dinv, ref, sched, interpret=True))
    ref = ref.reshape(lay.nbc, 4, lay.T)
    return {1: (ys[1], ref[:, :1].reshape(-1, lay.T)),
            3: (ys[3], ref[:, 1:].reshape(-1, lay.T))}


@pytest.mark.parametrize("nrhs", [1, 3])
def test_twin_matches_pallas_sweeps(factored, reference_sweeps, nrhs):
    f = factored.factors
    y2, ref = reference_sweeps[nrhs]
    plan = SW.sweep_plan(factored.layout, "cpu")
    got = torch.from_numpy(y2.copy())
    before = SW.run_sweep.twin_launches
    SW.sweep_fwd(f.pool, f.dinv, got, plan)
    SW.sweep_bwd(f.pool, f.dinv, got, plan)
    assert SW.run_sweep.twin_launches == before + 2
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_rowvec_layout_round_trips(factored):
    lay = factored.layout
    b = torch.randn(lay.nbc, lay.T, 3, generator=torch.Generator().manual_seed(0))
    y2 = SW._to_rowvec(b)
    assert y2.shape == (lay.nbc * 3, lay.T)
    np.testing.assert_array_equal(
        y2.numpy(), np.transpose(b.numpy(), (0, 2, 1)).reshape(-1, lay.T)
    )
    assert torch.equal(SW._from_rowvec(y2, lay.nbc, lay.T), b)


def test_update_phase_sub_segments(factored):
    """Each update phase's ops sorted by dst; K2's update items hold
    1.._OPS_PER_ITEM[key] consecutive ops of one dst each and tile the
    ops of every phase in order."""
    plan = factored._solve_fn.plan
    for key in ("fwd", "bwd"):
        upd = [ph for ph in plan[key] if ph.kind == "upd"]
        assert upd
        for ph in upd:
            assert bool((ph.op_dst[1:] >= ph.op_dst[:-1]).all())
        op_dst = torch.cat([ph.op_dst for ph in upd])
        it = plan["items"][key]
        rows = it.item[it.item[:, 0] == SW.UPD]
        lens = rows[:, 3] - rows[:, 2]
        assert int(lens.min()) >= 1 and int(lens.max()) <= (
            SW._OPS_PER_ITEM[key])
        assert int(rows[0, 2]) == 0 and int(rows[-1, 3]) == op_dst.numel()
        assert torch.equal(rows[1:, 2], rows[:-1, 3])
        assert torch.equal(torch.repeat_interleave(rows[:, 1], lens), op_dst)
        assert torch.equal(torch.cat([ph.op_tile for ph in upd]),
                           it.op_tile)


@pytest.fixture(scope="module")
def factored_lu():
    s = Pastix(convection_diffusion_3d(5),
               PastixConfig(tile_size=32, factorization=Factorization.LU),
               device="cpu")
    s.factorize()
    return s


def test_lu_twin_matches_pallas_sweeps(factored_lu, nrhs=2):
    lay, f = factored_lu.layout, factored_lu.factors
    rng = np.random.default_rng(10 + nrhs)
    y2 = rng.standard_normal((lay.nbc * nrhs, lay.T)).astype(np.float32)
    nops = sum(len(lv.cols) + len(lv.trsm_panel) for lv in lay.levels)
    sched = JSW.build_sweep_schedule(lay, chunk_max=-(-nops // 4) * 4)
    j = lambda t: jnp.asarray(t.numpy())
    ref = JSW.sweep_fwd(j(f.pool), j(f.dinv), jnp.asarray(y2), sched,
                        interpret=True)
    ref = np.asarray(JSW.sweep_bwd(j(f.pool_u), j(f.dinv_u), ref, sched,
                                   lu=True, interpret=True))
    plan = SW.sweep_plan(lay, "cpu")
    got = torch.from_numpy(y2.copy())
    SW.sweep_fwd(f.pool, f.dinv, got, plan)
    SW.sweep_bwd(f.pool_u, f.dinv_u, got, plan, lu=True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    # the LU backward sweep is not the symmetric one
    sym = torch.from_numpy(y2.copy())
    SW.sweep_fwd(f.pool, f.dinv, sym, plan)
    SW.sweep_bwd(f.pool_u, f.dinv_u, sym, plan)
    assert np.abs(sym.numpy() - ref).max() > 1e-3 * np.abs(ref).max()


def _deps(it):
    """The tickets each item of :class:`SW.SweepItems` waits on."""
    item = it.item.tolist()
    owner = {col: t for t, (kind, col, *_) in enumerate(item)
             if kind != SW.UPD}
    upd = [t for t, row in enumerate(item) if row[0] == SW.UPD]
    deps = []
    for t, (kind, col, lo, hi, _) in enumerate(item):
        if kind == SW.UPD:
            deps.append({owner[int(s)] for s, w in zip(
                it.op_src[lo:hi].tolist(), it.op_wait[lo:hi].tolist()) if w})
        else:
            deps.append({upd[s] for s in it.slot_list[lo:hi].tolist()})
    return deps


def _shuffled(deps, seed):
    """A random order of the items in which each comes after its waits."""
    rng = np.random.default_rng(seed)
    left = [set(d) for d in deps]
    users = collections.defaultdict(list)
    for t, d in enumerate(deps):
        for s in d:
            users[s].append(t)
    ready, order = [t for t, d in enumerate(left) if not d], []
    while ready:
        t = ready.pop(int(rng.integers(len(ready))))
        order.append(t)
        for u in users[t]:
            left[u].discard(t)
            if not left[u]:
                ready.append(u)
    assert len(order) == len(deps)
    return order


def _replay(pool, dinv, y2, plan, key, lu=False, order=None):
    """K2's items applied in ``order`` (default: ticket order) with the
    twin's arithmetic: an UPD item keeps its ops' products, a DIAG or
    FLUSH item subtracts the products of its slots one by one (the twin's
    index_add_ order per dst), then DIAG applies the diagonal."""
    nbc, T = plan["nbc"], plan["T"]
    it = plan["items"][key]
    Y = y2.view(nbc, -1, T)
    eqs = ("nik,nrk->nri", "nki,nrk->nri")
    tu, td = SW._trans(key, lu)
    item = it.item.tolist()
    slots = {}
    for t in range(len(item)) if order is None else order:
        kind, col, lo, hi, slot = item[t]
        if kind == SW.UPD:
            slots[slot] = torch.einsum(eqs[tu], pool[it.op_tile[lo:hi]],
                                       Y[it.op_src[lo:hi]])
            continue
        for s in it.slot_list[lo:hi].tolist():
            for c in slots.pop(s):
                Y[col] -= c
        if kind == SW.DIAG:
            Y[col] = torch.einsum(eqs[td], dinv[col:col + 1],
                                  Y[col:col + 1])[0]
    assert not slots
    return y2


def _check_items(plan):
    """Every wait points at a smaller ticket; each reducing item expects
    the sub-segments of its column; the UPD items cover every op once."""
    for key in ("fwd", "bwd"):
        it = plan["items"][key]
        kind = it.item[:, 0]
        for t, d in enumerate(_deps(it)):
            assert all(s < t for s in d), (key, t)
        upd = (kind == SW.UPD).nonzero().flatten()
        assert torch.equal(it.item[upd, 4], torch.arange(upd.numel()))
        assert torch.equal(it.item[upd[1:], 2], it.item[upd[:-1], 3])
        assert int(it.item[upd[-1], 3]) == it.op_tile.numel()
        # sub-segments per dst, counted from the twin's phases
        subs = collections.Counter()
        for ph in plan[key]:
            if ph.kind == "upd":
                dst, n = ph.op_dst.unique_consecutive(return_counts=True)
                for c, k in zip(dst.tolist(), n.tolist()):
                    subs[c] += -(-k // SW._OPS_PER_ITEM[key])
        red = (kind != SW.UPD).nonzero().flatten().tolist()
        got = {int(it.item[t, 1]): int(it.item[t, 3] - it.item[t, 2])
               for t in red}
        assert len(got) == len(red)
        assert {c: n for c, n in got.items() if n} == dict(subs)
        diag_cols = torch.cat([ph.cols for ph in plan[key]
                               if ph.kind == "diag"])
        assert sorted(diag_cols.tolist()) == sorted(
            int(it.item[t, 1]) for t in red if it.item[t, 0] == SW.DIAG)


def test_sweep_items_wait_on_smaller_tickets(factored):
    plan = factored._solve_fn.plan
    _check_items(plan)
    assert all(int((plan["items"][k].item[:, 0] == SW.FLUSH).sum()) == 0
               for k in ("fwd", "bwd"))


@pytest.mark.parametrize("order", ["ticket", "shuffled"])
@pytest.mark.parametrize("nrhs", [1, 3])
def test_item_replay_matches_twin(factored, reference_sweeps, order, nrhs):
    f = factored.factors
    y2, ref = reference_sweeps[nrhs]
    plan = factored._solve_fn.plan
    twin = torch.from_numpy(y2.copy())
    got = torch.from_numpy(y2.copy())
    for seed, key in enumerate(("fwd", "bwd")):
        SW.run_sweep_ref(f.pool, f.dinv, twin, plan, key)
        perm = (None if order == "ticket"
                else _shuffled(_deps(plan["items"][key]), seed))
        _replay(f.pool, f.dinv, got, plan, key, order=perm)
    assert torch.equal(got, twin)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_sweep_items_schur_rows():
    """With Schur unknowns (the plane z = 5 of poisson_3d(6)) the forward
    sweep flushes the Schur rows (no diagonal) and the backward sweep
    reads them without waiting; the replay still gives the twin's sweeps
    bit for bit, in a shuffled order too."""
    A = poisson_3d(6)
    s = Pastix(A, PastixConfig(tile_size=32), device="cpu")
    s.set_schur_unknowns(np.arange(A.n - 36, A.n))
    s.factorize()
    plan, f = s._solve_fn.plan, s.factors
    _check_items(plan)
    fwd, bwd = plan["items"]["fwd"], plan["items"]["bwd"]
    assert int((fwd.item[:, 0] == SW.FLUSH).sum()) > 0
    assert int((bwd.op_wait == 0).sum()) > 0
    y2 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (s.layout.nbc * 2, s.layout.T)).astype(np.float32))
    twin, got = y2.clone(), y2.clone()
    for seed, key in enumerate(("fwd", "bwd")):
        SW.run_sweep_ref(f.pool, f.dinv, twin, plan, key)
        _replay(f.pool, f.dinv, got, plan, key,
                order=_shuffled(_deps(plan["items"][key]), seed))
    assert torch.equal(got, twin)


def test_lu_item_replay_matches_twin(factored_lu):
    lay, f = factored_lu.layout, factored_lu.factors
    plan = factored_lu._solve_fn.plan
    _check_items(plan)
    y2 = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (lay.nbc * 2, lay.T)).astype(np.float32))
    twin, got = y2.clone(), y2.clone()
    SW.run_sweep_ref(f.pool, f.dinv, twin, plan, "fwd")
    SW.run_sweep_ref(f.pool_u, f.dinv_u, twin, plan, "bwd", lu=True)
    _replay(f.pool, f.dinv, got, plan, "fwd")
    _replay(f.pool_u, f.dinv_u, got, plan, "bwd", lu=True,
            order=_shuffled(_deps(plan["items"]["bwd"]), 3))
    assert torch.equal(got, twin)


def test_sweep_items_refuse_a_wait_on_a_later_ticket():
    """A table whose update reads a column diagonalized after it would
    make the persistent kernel wait forever: sweep_items refuses it."""
    cols = np.array([0, 1], np.int64)
    upd = ("upd", np.array([0, 1]), np.array([5]), np.array([0]),
           np.array([1]))
    SW.sweep_items([("diag", cols[:1]), upd, ("diag", cols[1:])], 2)
    with pytest.raises(RuntimeError, match="topological"):
        SW.sweep_items([upd, ("diag", cols[:1]), ("diag", cols[1:])], 2)
