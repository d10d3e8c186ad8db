"""Port parity, chained sweeps in the pair and direct Fock modes:
``parallel.sweep.chained_sweep`` on the CPU against the JAX package's, on
water/STO-3G. The JAX package's chain in these modes rebinds one cached
engine to each geometry, which is wrong past 0.25 Bohr of drift from the
geometry it was built at, so the chain keeps every atom within 0.22 Bohr
of the first geometry."""

import pytest

from tests.test_torch_sweep import chained_matches_jax, systems  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

CHAIN_SCALES = (1.0, 1.04, 1.08, 1.12)  # H moves at most 0.217 Bohr


@pytest.mark.parametrize("mode", ["pair", "direct"])
def test_chained_sweep_matches_jax(systems, mode):  # noqa: F811
    chained_matches_jax(systems, mode, CHAIN_SCALES)
