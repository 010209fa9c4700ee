"""The port's mesh paths (``pastix_tpu_torch/parallel``) on gloo ranks on
the CPU, held against the reference's mesh on ``conftest.py``'s eight
virtual devices at the same ``mesh_shape``, and against the port's own
one-device pools.

Each item starts its ranks once (``parallel.launch.run_ranks``, 4
processes with one intra-op thread each, the jobs of
``tests/torch_mesh_ranks.py``); this file holds at most 5 items, so that
``--dist loadfile`` hands it out after the longest file.

Tolerances: the ranks' pools and solutions differ from the reference's
and from one device's by the fp32 summation order of the fan-ins (each
level's touched tiles are summed over the ranks, in another order than
one device's scatter-add), and LDLᵗ/LU by the order inside the tile
factorizations (K4's twin against XLA's): pools to 2e-5 of their largest
entry, refined solutions to 1e-8 (against the reference's mesh and the
port's one device).  Everything a rank computes is the
same on every rank, bit for bit (the collectives give every rank one
sum)."""

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from pastix_tpu_torch import Factorization, Pastix, PastixConfig
from pastix_tpu_torch.parallel.launch import run_ranks
from torch_common import no_calibration  # noqa: F401

torch.set_num_threads(1)

RANKS = 4
POOL_TOL = 2e-5  # of max|pool|: fp32 fan-in summation order
X_TOL = 1e-8  # refined solutions (relative to max|x|)


def ranks(fn, *args):
    out = run_ranks(fn, RANKS, "gloo", args=args, threads=1)
    return out


def reference(name, fields, nrhs, schur=0):
    """The reference's ``Pastix`` on its mesh (the same config fields)."""
    import pastix_tpu

    A = R.problem(name)
    ref_fields = dict(fields)
    if "factorization" in ref_fields:
        ref_fields["factorization"] = pastix_tpu.Factorization[
            ref_fields["factorization"].name]
    s = pastix_tpu.Pastix(A, pastix_tpu.PastixConfig(**ref_fields))
    b = R.rhs(A, nrhs)
    out = {}
    if schur:
        n = A.shape[0]
        s.set_schur_unknowns(np.arange(n - schur, n))
        s.factorize()
        out["S"] = s.get_schur()
        out["X"] = s.solve_with_schur(b)
    else:
        out["X"] = s.solve(b)
    f = s.factors
    sh = s._pool_sharding
    pick = (lambda p: sh.from_local(np.asarray(p))) if sh is not None else (
        lambda p: np.asarray(p))
    out["pool"] = pick(f.pool)
    if f.pool_u is not None:
        out["pool_u"] = pick(f.pool_u)
    out["d"] = None if f.d is None else np.asarray(f.d)
    out["npiv"] = s.report.static_pivots
    out["nloc"] = None if sh is None else sh.nloc
    return out


def one_device(name, fields, nrhs):
    """The port's own one-device pools for the case."""
    A = R.problem(name)
    f = {k: v for k, v in fields.items()
         if k not in ("mesh_shape", "mesh_axis_names", "shard_pool",
                      "dist_strategy")}
    if fields.get("dist_strategy") == "subtree":
        f["dense_tail"] = False  # the subtree schedule has no dense tail
    s = Pastix(A, PastixConfig(**f), device="cpu")
    X = s.solve(R.rhs(A, nrhs))
    return {"X": X, "pool": s.factors.pool.numpy(),
            "pool_u": (None if s.factors.pool_u is None
                       else s.factors.pool_u.numpy()),
            "npiv": s.report.static_pivots}


def close(a, b, tol, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} > {tol:.1e}"


def check_cases(cases, out):
    """Every rank the same; each case against the reference's mesh and
    the port's one device."""
    assert out[0][-1] == [], f"a rank loaded {out[0][-1]}"
    for r in out[1:]:
        for a, b in zip(r[:-1], out[0][:-1]):
            np.testing.assert_array_equal(a["X"], b["X"])
            np.testing.assert_array_equal(a["pool"], b["pool"])
    for case, got in zip(cases, out[0][:-1]):
        name, fields, nrhs, schur = case
        clamps = name == "zeros8"
        # the reference's mesh merges LDLᵗ's pivots by adding d - 1 to
        # ones, which rounds the clamped pivots (1e-13) to 0 and divides
        # by them (NaN in its solution), and counts one device's clamps:
        # with clamped pivots the port is held against its one device
        ref = reference(name, {k: v for k, v in fields.items()
                               if not (clamps and k == "mesh_shape")},
                        nrhs, schur)
        tag = f"{name} {fields}"
        close(got["pool"], ref["pool"], POOL_TOL, f"pool vs reference {tag}")
        if "pool_u" in ref:
            close(got["pool_u"], ref["pool_u"], POOL_TOL,
                  f"pool_u vs reference {tag}")
        if ref["d"] is not None:
            close(got["d"], ref["d"], POOL_TOL, f"d vs reference {tag}")
        close(got["X"], ref["X"], X_TOL, f"X vs reference {tag}")
        if schur:
            close(got["S"], ref["S"], POOL_TOL, f"S vs reference {tag}")
            continue
        one = one_device(name, fields, nrhs)
        close(got["pool"], one["pool"], POOL_TOL, f"pool vs one device {tag}")
        close(got["X"], one["X"], X_TOL, f"X vs one device {tag}")
        assert got["npiv"] == one["npiv"] == ref["npiv"], tag
        assert got["npiv"] == (5 if clamps else 0), tag
        assert got["residual"] < 1e-12, (tag, got["residual"])
        if got["owner"] and not clamps:
            # the same ownership tables as the reference's
            assert got["nloc"] == ref["nloc"], tag
            assert got["local_shape"][0] == got["nloc"] < got["npool"]
    return out[0][:-1]


OWNER = [
    ("poisson10", dict(tile_size=8, mesh_shape=(4,)), 3, 0),
    ("poisson8", dict(tile_size=8, mesh_shape=(4,),
                      factorization=Factorization.LDLT), 2, 0),
    ("convdiff8", dict(tile_size=8, mesh_shape=(4,),
                       factorization=Factorization.LU), 2, 0),
    # static pivots on several ranks
    ("zeros8", dict(tile_size=8, mesh_shape=(4,),
                    factorization=Factorization.LDLT), 1, 0),
    ("zeros8", dict(tile_size=8, mesh_shape=(4,),
                    factorization=Factorization.LU), 1, 0),
    # one RHS column, padded over dp = 2
    ("poisson8", dict(tile_size=8, mesh_shape=(2, 2),
                      mesh_axis_names=("dp", "tp")), 1, 0),
]


def test_owner_paths_match_reference():
    """Owner-computes LLᵗ (with its 2D dense tail), LDLᵗ and LU on a tp
    mesh of 4 (LDLᵗ and LU also with five clamped pivots) and LLᵗ on a
    (2, 2) dp x tp mesh: each rank holds (nloc, T, T), and the gathered
    pools, pivots and solutions are the reference's mesh's and one
    device's."""
    got = check_cases(OWNER, ranks(R.solve_job, OWNER))
    assert all(g["owner"] for g in got)
    assert got[0]["dense_tail_m"] > 0


REPLICATED = [
    # shard_pool=False: the replicated pool and the device loop
    ("poisson8", dict(tile_size=8, mesh_shape=(4,), shard_pool=False), 2, 0),
    ("convdiff8", dict(tile_size=8, mesh_shape=(4,), shard_pool=False,
                       factorization=Factorization.LU), 1, 0),
    # Schur unknowns keep the replicated pool (unaligned on both sides:
    # in Schur mode the port keeps the supernode alignment the reference
    # drops, a recorded deviation)
    ("poisson8", dict(tile_size=8, mesh_shape=(4,),
                      align_supernodes=False), 1, 40),
]


def test_replicated_paths_match_reference():
    """``shard_pool=False`` (LLᵗ with the device refinement loop, LU) and
    Schur unknowns on the replicated pool, and a complex Hermitian LDLᴴ on
    a (2, 2) mesh, against the reference's mesh."""
    herm = ("helmholtz", dict(tile_size=16, factorization=Factorization.LDLH,
                              compute_dtype="complex64", mesh_shape=(2, 2),
                              mesh_axis_names=("dp", "tp")), 1, 0)
    out = ranks(R.solve_job, REPLICATED + [herm])
    complex_out = out[0][-2]
    got = check_cases(REPLICATED, [r[:-2] + r[-1:] for r in out])
    assert not any(g["owner"] for g in got)
    assert got[0]["sharded_refine"] and got[0]["iters"] >= 1
    A = R.problem("helmholtz")
    b = R.rhs(A, 1)
    ref = reference(*herm)
    assert np.linalg.norm(b - A @ complex_out["X"]) / np.linalg.norm(b) < 1e-5
    close(complex_out["pool"], ref["pool"], 1e-4, "complex pool")
    close(complex_out["X"], ref["X"], 1e-5, "complex X")


SUBTREE = [
    ("poisson8", dict(tile_size=8, mesh_shape=(4,),
                      dist_strategy="subtree"), 2, 0),
    ("poisson8", dict(tile_size=8, mesh_shape=(4,), dist_strategy="subtree",
                      factorization=Factorization.LDLT), 2, 0),
]


def test_subtree_matches_reference():
    """``dist_strategy="subtree"`` LLᵗ and LDLᵗ: local subtrees, one
    boundary all_reduce, the shared top, the masked merge."""
    got = check_cases(SUBTREE, ranks(R.solve_job, SUBTREE))
    assert got[0]["dense_tail_m"] == 0


def test_front_doors_and_refusals():
    """``spsolve``, ``pastix()`` and ``factorize(values)`` on a mesh of 4
    ranks; ``mesh_shape`` without a process group (here) or of another
    size (in the ranks) raises ``ValueError`` naming both numbers."""
    A = R.problem("poisson8")
    with pytest.raises(ValueError, match=r"needs a process group of 4 "
                                         r"ranks, but no process group"):
        Pastix(A, PastixConfig(tile_size=8, mesh_shape=(4,)), device="cpu")
    out = ranks(R.front_door_job)
    for r in out:
        assert r["loaded"] == []
        assert r["owner"]
        for k in ("spsolve", "pastix", "x1"):
            assert np.abs(r[k] - 1).max() < 1e-8, k
        assert np.abs(r["x2"] - 0.5).max() < 1e-8
        assert r["pastix_residual"] < 1e-12
        assert "needs a process group of 3 ranks, but the current one has 4" \
            in r["wrong_size"]


def test_multi_device_example_and_dryrun(capsys):
    """The ``multi_device`` example and ``dryrun_multichip`` on 4 gloo
    ranks (the dry run at nx = 16, where the reference's balance checks
    hold)."""
    from pastix_tpu_torch.examples import MESH_CHECKS
    from pastix_tpu_torch.examples.multi_device import main
    from pastix_tpu_torch.parallel.dryrun import dryrun_multichip

    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in MESH_CHECKS["multi_device"][1]:
        assert line in out
    assert "mesh=(2x2)" in out
    lines = dryrun_multichip(4, nx=16)
    assert lines[0].startswith("dryrun_multichip OK: mesh=(dp=2,tp=2)")
    assert any(ln.startswith("scale subtree nd=16") for ln in lines)
