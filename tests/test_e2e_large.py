"""Acceptance test for the LARGE generated reference example (SURVEY.md
section 4): ex10, the q=3 "bensolvehedron", m=n=343.

It takes about a minute on the CPU backend, so it is opt-in:

    BENSOLVE_SLOW=1 python -m pytest tests/test_e2e_large.py -v

chip_smoke.py runs the same solve on the GPU.
"""

import os

import pytest

from tests.test_e2e import check_support, run

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not os.environ.get("BENSOLVE_SLOW"),
                       reason="set BENSOLVE_SLOW=1 to run the large examples"),
]

from bensolve_tpu.algs.solution import SolStatus  # noqa: E402


def test_ex10_bensolvehedron():
    r = run("ex10")
    assert r.status is SolStatus.OPTIMAL
    # the bensolvehedron's upper image is bounded below along c and has
    # a large vertex set; directions are the 3 extreme rays of R^3_+
    assert len(r.primal_points) > 500
    assert len(r.primal_directions) == 3
    check_support(r, n_samples=16, tol=1e-4)
