"""The port's blocked Cholesky (mogptk_tpu_torch/ops/blocked_cholesky.py) on
the CPU, where it runs the K-spanel and K-colwrite kernels' plain twins."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mogptk_tpu.ops.blocked_cholesky import blocked_cholesky as jax_blocked_cholesky
from mogptk_tpu_torch.ops import blocked_cholesky as tbc


def _spd(n, seed, dtype):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n) / np.sqrt(n)
    return (A @ A.T + 3.0 * np.eye(n)).astype(dtype)


def test_f32_matches_jax_pallas_path():
    """n=1024, B=512, float32: the JAX package runs _s_panel_pallas and
    _col_strip_write (interpret mode) with bf16x3 products, the port plain
    FP32 products. Tolerance rtol 2e-4, atol 2e-5: bf16x3 against FP32, as in
    tests/test_linalg.py (test_pallas_s_panel_update_matches_jnp)."""
    K = _spd(1024, 40, np.float32)
    ref = np.asarray(jax_blocked_cholesky(jnp.asarray(K), 512, update_precision="high"))
    launches = (tbc.s_panel.launches, tbc.col_write.launches)
    L = tbc.blocked_cholesky(torch.from_numpy(K.copy()), block_size=512)
    assert L.dtype == torch.float32
    np.testing.assert_allclose(L.numpy(), ref, rtol=2e-4, atol=2e-5)
    assert np.all(np.triu(L.numpy(), 1) == 0.0)
    # CPU tensors run the plain twins, never a kernel
    assert (tbc.s_panel.launches, tbc.col_write.launches) == launches


@pytest.mark.parametrize("n", [192, 160], ids=["aligned", "padded"])
def test_f64_vector_shift_matches_numpy(n):
    """float64, B=64, a vector diag_shift applied inside the factorization;
    n=160 pads to 192 with an identity tail. rtol 1e-10: both are float64
    Cholesky factorizations of a well-conditioned matrix (eigenvalues >= 3)."""
    K = _spd(n, 41, np.float64)
    shift = np.random.RandomState(42).rand(n)
    Kt = torch.from_numpy(K.copy())
    L = tbc.blocked_cholesky(Kt, block_size=64, diag_shift=torch.from_numpy(shift))
    ref = np.linalg.cholesky(K + np.diag(shift))
    np.testing.assert_allclose(L.numpy(), ref, rtol=1e-10, atol=1e-12)
    assert np.all(np.triu(L.numpy(), 1) == 0.0)
    if n % 64 == 0:
        assert L.data_ptr() == Kt.data_ptr()   # factored in place
    else:
        np.testing.assert_array_equal(Kt.numpy(), K)   # padded: K untouched


def test_not_positive_definite_gives_nan():
    K = _spd(128, 43, np.float64)
    K[100, 100] = -50.0
    L = tbc.blocked_cholesky(torch.from_numpy(K), block_size=64)
    assert np.all(np.isfinite(L.numpy()[:64, :64]))
    assert np.all(np.isnan(L.numpy()[64:, 64:].diagonal()))


def test_effective_block():
    assert tbc.effective_block(16384, 512) == 512
    assert tbc.effective_block(7680, 1024) == 512
    assert tbc.effective_block(100, 512) == 100
    assert tbc.effective_block(160, 64) == 64
