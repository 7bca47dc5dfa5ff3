"""Round-trip and generator-parity tests for the .vlp writer and the
Python example generators (the prob2vlp.m front-end equivalents)."""

import numpy as np
import pytest

from bensolve_tpu import examples
from bensolve_tpu.vlp.reader import read_vlp
from bensolve_tpu.vlp.writer import vlp_text, write_vlp


def assert_same_problem(a, b):
    np.testing.assert_allclose(a.A, b.A)
    np.testing.assert_allclose(a.P, b.P)
    np.testing.assert_allclose(a.rows.lb, b.rows.lb)
    np.testing.assert_allclose(a.rows.ub, b.rows.ub)
    np.testing.assert_allclose(a.cols.lb, b.cols.lb)
    np.testing.assert_allclose(a.cols.ub, b.cols.ub)
    assert a.optdir == b.optdir
    assert a.cone_gen == b.cone_gen
    if a.gen is not None or b.gen is not None:
        np.testing.assert_allclose(a.gen, b.gen)


@pytest.mark.parametrize("ex", ["ex01", "ex02", "ex03", "ex04", "ex05",
                                "ex06", "ex08", "ex10", "ex11"])
def test_roundtrip(ex, tmp_path, ex_dir):
    orig = read_vlp(f"{ex_dir}/{ex}.vlp")
    p = str(tmp_path / "out.vlp")
    write_vlp(orig, p)
    again = read_vlp(p)
    assert_same_problem(orig, again)


# header counts (q, m, n, nz, nzobj, cone generators) of the reference's
# shipped ex/exNN.vlp files, as recorded in BASELINE.md
SHIPPED_HEADERS = {
    "example01": (2, 2, 2, 4, None, None),
    "example02": (2, 3, 2, 6, None, None),
    "example03": (2, 2, 3, 6, None, None),
    "example04": (2, 2, 3, 6, None, None),
    "example05": (3, 4, 3, 12, None, 4),
    "example06": (2, 1, 2, 2, None, 2),
    "example08": (2, 3, 2, 6, None, 2),
    "example10": (3, 343, 343, 343, 882, None),
    "example11": (5, 31, 5, 155, None, None),
}


@pytest.mark.parametrize("name", sorted(SHIPPED_HEADERS))
def test_generators_match_shipped_files(name):
    q, m, n, nz, nzobj, n_gen = SHIPPED_HEADERS[name]
    gen = examples.ALL[name]()
    assert (gen.q, gen.m, gen.n) == (q, m, n)
    assert int(np.count_nonzero(gen.A)) == nz
    if nzobj is not None:
        assert int(np.count_nonzero(gen.P)) == nzobj
    if n_gen is not None:
        assert gen.gen.shape[1] == n_gen
    # the written file carries the same header counts
    head = vlp_text(gen).splitlines()[0].split()
    assert list(map(int, head[3:6])) == [m, n, nz]
    assert int(head[6]) == q


def test_load_matches_generator():
    """examples.load gives the generator's problem through the .vlp
    grammar, unchanged."""
    for name in examples.NAMES:
        assert_same_problem(examples.load(name), examples.generate(name))
