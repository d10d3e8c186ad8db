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
from tests.torch_threads import one_torch_thread  # noqa: F401


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


def test_matvec_upper_plain_mirrors_the_block_upper_triangle():
    # what kernel 2 computes for any square terms: blocks on and above the
    # diagonal as they are, those below replaced by the mirror image
    rng = np.random.default_rng(11)
    m, B = 150, fock_matvec.BLOCK
    T = rng.normal(size=(m, m))
    d = rng.normal(size=m)
    ref = np.zeros(m)
    nb = -(-m // B)
    for i in range(nb):
        for j in range(i, nb):
            blk = T[i * B:(i + 1) * B, j * B:(j + 1) * B]
            ref[i * B:(i + 1) * B] += blk @ d[j * B:(j + 1) * B]
            if j != i:
                ref[j * B:(j + 1) * B] += blk.T @ d[i * B:(i + 1) * B]
    out = fock_matvec.matvec_upper_plain(torch.tensor(T), torch.tensor(d)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    S = torch.tensor(T + T.T)
    torch.testing.assert_close(fock_matvec.matvec_upper_plain(S, torch.tensor(d)),
                               S @ torch.tensor(d), rtol=1e-13, atol=0)


@pytest.mark.parametrize("m", [1, 2, 63, 64, 65, 127, 128, 129, 200])
def test_half_read_product_at_block_edges(m):
    # kernel 2's block grid at sizes below, on and past a block edge: the
    # half-read product mirrors exactly the blocks strictly below the
    # diagonal, and on a symmetric terms it is the full product
    rng = np.random.default_rng(300 + m)
    B = fock_matvec.BLOCK
    X = rng.normal(size=(m, m))
    d = rng.normal(size=m)
    blk = np.arange(m) // B
    mirrored = np.where(blk[:, None] > blk[None, :], X.T, X)
    out = fock_matvec.matvec_upper_plain(torch.tensor(X), torch.tensor(d)).numpy()
    np.testing.assert_allclose(out, mirrored @ d, rtol=0, atol=1e-12)
    S = torch.tensor(X + X.T)
    ref = fock_matvec.matvec(S, torch.tensor(d))
    out = fock_matvec.matvec_upper_plain(S, torch.tensor(d))
    assert float((out - ref).abs().max()) <= 1e-13 * float(ref.abs().max())
