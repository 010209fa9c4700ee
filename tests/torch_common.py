"""A fixture shared by the port's CPU tests (``tests/test_torch_*.py``);
a module takes it by importing it."""

import pytest


@pytest.fixture(autouse=True, scope="module")
def no_calibration():
    """No test of the importing module reads a predicted factorization
    time: with PASTIX_MEASURED_PLAN=0 neither package calibrates its cost
    model (the reference's takes seconds at T=32 on a CPU).  The
    reference's grouping then takes its static unroll thresholds, which,
    as any calibrated ones (at least 512 pairs, 128 diagonal tiles),
    unroll no level of the port tests' layouts (at most 499 pairs, 33
    diagonal tiles a level)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PASTIX_MEASURED_PLAN", "0")
        yield
