"""The frozen operation and byte counts."""

import numpy as np
import pytest

from hfbench.counts import work


@pytest.mark.parametrize("L,S1,S2,A", [(0, 1, 1, 1), (2, 4, 4, 3), (4, 10, 10, 9), (8, 35, 35, 36), (5, 10, 20, 6)])
def test_quartet_flops_is_the_ports(L, S1, S2, A):
    from qchem_rs_tpu_torch.ops.eri_tiled import _quartet_flops

    assert work.quartet_flops(L, S1, S2, A) == _quartet_flops(L, S1, S2, A)


def test_hand_count():
    # one (ss) class: pair 0 (3 real primitive pairs, q = 1) and pair 1 (9,
    # q = 1e-13); at 1e-12 only (0|0) is kept
    cls = [work.PairClass(0, 0, np.array([1.0, 1e-13]), np.array([3.0, 9.0]))]
    per = 12 + 24 + 10 + 5 + 1 + 2  # quartet_flops(0, 1, 1, 1)
    assert work.quartet_flops(0, 1, 1, 1) == per
    inputs = 8.0 * 12 * (1 + 4)
    assert work.v2_build(cls, 1e-12) == work.Work(9 * per, inputs + 8.0)
    assert work.direct_pass(cls, 1e-12, nao=2) == work.Work(9 * per + 3 * 2, inputs + 8.0 * 3 * 4)
    # with no screening all three pairs of pairs are kept, each once
    assert work.v2_build(cls, 0.0).flops == (9 + 27 + 81) * per


def test_bra_is_the_earlier_class():
    s = work.PairClass(0, 0, np.array([1.0]), np.array([1.0]))
    p = work.PairClass(1, 0, np.array([1.0]), np.array([1.0]))
    assert [c.la for c in work.classes([(0, 1, 1.0, 1), (0, 0, 1.0, 1)])] == [0, 1]
    got = work.v2_build([s, p], 0.0).flops
    want = sum(work.quartet_flops(L, work.nhermite(Lb), work.nhermite(L - Lb), A)
               for L, Lb, A in ((0, 0, 1), (1, 0, 1), (2, 1, 3)))
    assert got == want
