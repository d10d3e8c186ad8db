"""Port parity, Fock matvec: kernel 2's plain twin against the JAX Pallas
kernel ``fock_matvec.matvec_df``, run in interpret mode on the CPU as
tests/test_fock_matvec.py runs it, on the same inputs. Kernel 2 itself runs
only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qchem_rs_tpu.ops import fock_matvec as jax_fm
from qchem_rs_tpu_torch.ops import fock_matvec
from qchem_rs_tpu_torch.utils.interop import to_tensor


@pytest.mark.parametrize("m", [150, max(jax_fm.block_sizes()) + 37])
def test_matvec_twin_matches_jax_matvec_df(m):
    rng = np.random.default_rng(m)
    T = rng.normal(size=(m, m)) * 3.0
    T = T + T.T  # terms matrices are symmetric
    d = rng.normal(size=(m,))
    th, tl = jax_fm.split_terms(jnp.asarray(T))
    ref = np.asarray(jax_fm.matvec_df(th, tl, jnp.asarray(d), m))
    out = fock_matvec.matvec(to_tensor(T, "cpu"), to_tensor(d, "cpu")).numpy()
    # the df kernel's contract: error-free products, ~66 sloppy adds
    assert np.max(np.abs(out - ref)) <= 1e-10


def test_matvec_cpu_takes_twin_and_checks_inputs():
    T = torch.randn(6, 6, dtype=torch.float64)
    d = torch.randn(6, dtype=torch.float64)
    before = fock_matvec.KERNEL.launches
    assert torch.equal(fock_matvec.matvec(T, d), T @ d)
    assert fock_matvec.KERNEL.launches == before  # CPU tensors never launch
    with pytest.raises(TypeError, match="float64"):
        fock_matvec.matvec(T.float(), d)
    with pytest.raises(ValueError, match="shapes"):
        fock_matvec.matvec(T[:, :5], d)
    with pytest.raises(ValueError, match="contiguous"):
        fock_matvec.matvec(T.T, d)
