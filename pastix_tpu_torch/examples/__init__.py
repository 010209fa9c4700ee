"""The port's examples: counterparts of the reference's ``examples/*.py``
(``multi_device`` over a mesh of ranks, the others on one device).

Each takes the reference script's arguments plus ``--device D`` (default
``cuda``; ``cpu`` runs the plain PyTorch twins) and prints the lines the
reference's do, e.g.::

    python -m pastix_tpu_torch.examples.simple -lap 24 --device cpu
    python -m pastix_tpu_torch.examples.out_of_core
"""

# name -> (the arguments tests/test_examples.py runs the reference's
# example with, the lines it looks for in its output)
CHECKS = {
    "simple": (["-lap", "24"], ["residual"]),
    "step_by_step": ([], ["reuse step 2"]),
    "schur": ([], ["solve-with-schur residual"]),
    "reentrant": ([], ["llt-2d", "ldlt-3d"]),
    "murge_assembly": ([], ["assembled n=200"]),
    "isolate_zeros": ([], ["isolate-zeros residual"]),
    "simple_dist": ([], ["max error"]),
    "memory_usage": (["-lap3", "12"], ["device factor pool", "residual"]),
    "out_of_core": ([], ["segments under", "residual"]),
}
NAMES = tuple(CHECKS)
# the examples that start ranks (``parallel.launch``): checked by the
# mesh tests, which start rank processes, not with the one-device ones
MESH_CHECKS = {
    "multi_device": ([], ["pool sharded", "residual"]),
}


def split_device(argv):
    """(device, the other arguments): ``--device D`` (default ``cuda``)
    taken out of ``argv``."""
    argv = list(argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 == len(argv):
            raise SystemExit("--device needs a value (cuda or cpu)")
        device = argv[i + 1]
        del argv[i:i + 2]
    return device, argv
