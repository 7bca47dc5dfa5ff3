import os

import numpy as np
import pytest

from bensolve_tpu.vlp.problem import ConeGen
from bensolve_tpu.vlp.reader import VLPFormatError, read_vlp


def test_ex01(ex_dir):
    p = read_vlp(os.path.join(ex_dir, "ex01.vlp"))
    assert (p.m, p.n, p.q) == (2, 2, 2)
    assert p.optdir == 1
    assert p.cone_gen is ConeGen.DEFAULT
    np.testing.assert_allclose(p.A, [[2, 1], [1, 2]])
    np.testing.assert_allclose(p.P, [[1, -1], [1, 1]])
    assert list(p.rows.types) == ["l", "l"]
    np.testing.assert_allclose(p.rows.lb, [6, 6])
    assert np.all(np.isinf(p.rows.ub))
    assert list(p.cols.types) == ["l", "l"]
    np.testing.assert_allclose(p.cols.lb, [0, 0])


def test_ex05_cone(ex_dir):
    p = read_vlp(os.path.join(ex_dir, "ex05.vlp"))
    assert (p.m, p.n, p.q) == (4, 3, 3)
    assert p.cone_gen is ConeGen.CONE
    assert p.n_gen == 4
    np.testing.assert_allclose(p.c, [1, 1, 1])
    # k 1 3 -1 / k 3 3 2 -> generator column 3 (0-based 2) is (-1, 0, 2)
    np.testing.assert_allclose(p.gen[:, 2], [-1, 0, 2])


def test_ex06_dualcone_max(ex_dir):
    p = read_vlp(os.path.join(ex_dir, "ex06.vlp"))
    assert p.optdir == -1
    assert p.cone_gen is ConeGen.DUALCONE
    assert list(p.rows.types) == ["d"]
    np.testing.assert_allclose(p.rows.lb, [1])
    np.testing.assert_allclose(p.rows.ub, [2])
    assert list(p.cols.types) == ["d", "l"]


def test_all_examples_parse(ex_dir):
    sizes = {}
    for k in (1, 2, 3, 4, 5, 6, 8, 10, 11):
        name = f"ex{k:02d}.vlp"
        p = read_vlp(os.path.join(ex_dir, name))
        sizes[name] = (p.m, p.n, p.q)
    assert sizes["ex10.vlp"] == (343, 343, 3)
    assert sizes["ex11.vlp"] == (31, 5, 5)


def test_default_col_is_fixed_zero():
    # unspecified columns default to 's' fixed at 0 (bslv_vlp.c:572-574)
    text = "p vlp min 1 2 1 1 1\na 1 1 1\no 1 1 1\ni 1 l 0\ne\n"
    p = read_vlp(text, is_text=True)
    assert list(p.cols.types) == ["s", "s"]
    np.testing.assert_allclose(p.cols.lb, [0, 0])
    np.testing.assert_allclose(p.cols.ub, [0, 0])


def test_errors():
    with pytest.raises(VLPFormatError):
        read_vlp("p lp min 1 1 1 1 1\ne\n", is_text=True)
    with pytest.raises(VLPFormatError):
        read_vlp("p vlp min 1 1 1 1 1\na 2 1 5\ne\n", is_text=True)
    with pytest.raises(VLPFormatError):  # duplicate row descriptor
        read_vlp("p vlp min 1 1 0 1 0\ni 1 f\ni 1 f\ne\n", is_text=True)
    with pytest.raises(VLPFormatError):  # missing e terminator
        read_vlp("p vlp min 1 1 0 1 0\n", is_text=True)
