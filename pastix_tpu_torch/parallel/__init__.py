"""Distribution over several devices (counterpart of
``pastix_tpu/parallel``; reference: MPI fan-in and blend's proportional
mapping, SURVEY.md §2 rows 7 and 10).

The reference expresses its distribution as ``shard_map`` over a
``jax.sharding.Mesh``; the port runs the same bodies once a rank of a
``torch.distributed`` process group, over a ``DeviceMesh`` of the
config's ``mesh_shape`` (:mod:`.mesh`):

  * ``tp`` axis: each level's trailing-update pairs are dealt over the
    ranks, which run them through kernel K3 into a buffer of the level's
    touched tiles; one all_reduce a level sums them (the fan-in);
  * ``dp`` axis: the right-hand sides' columns are split over it.

Three schedules, chosen by ``Pastix.analyze`` as the reference chooses
them: owner-computes over a sharded pool (:mod:`.owner`, real LLᵗ, LDLᵗ
and LU), the replicated pool (:mod:`.sharded`: ``shard_pool=False``,
Schur unknowns, complex pools) and the proportional subtree mapping
(:mod:`.subtree`, ``dist_strategy="subtree"``).  :mod:`.launch` starts
the ranks of a mesh on one host.
"""

from pastix_tpu_torch.parallel.mesh import Axis, make_mesh, rank_device

__all__ = ["Axis", "make_mesh", "rank_device"]
