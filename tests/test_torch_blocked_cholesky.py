"""The port's blocked Cholesky (mogptk_tpu_torch/ops/blocked_cholesky.py) on
the CPU, where it runs the K-spanel and K-colwrite kernels' plain twins."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mogptk_tpu.ops.blocked_cholesky import blocked_cholesky as jax_blocked_cholesky
from mogptk_tpu_torch.ops import blocked_cholesky as tbc

import jax_reference


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small shapes: one torch thread (the suite runs files in parallel
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    ref = np.asarray(jax_reference.jit(
        lambda K_: jax_blocked_cholesky(K_, 512, update_precision="high"))(jnp.asarray(K)))
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


def test_factor_plan_rounds_the_kernels_widths_up_to_64():
    """The width gate of the card's route, on shapes alone: where the
    kernels run, a panel width that is no multiple of 64 (K-colwrite's) is
    rounded up to one and n padded to it with the identity tail, n = 300 as
    one 320-wide panel and a 200-wide block at n = 4,000 as sixteen
    256-wide ones; the twins keep effective_block's width, and widths the
    kernels took before are unchanged."""
    assert tbc.factor_plan(300, 512, kernels=False) == (300, 300)
    assert tbc.factor_plan(300, 512, kernels=True) == (320, 320)
    assert tbc.factor_plan(4000, 200, kernels=False) == (200, 4000)
    assert tbc.factor_plan(4000, 200, kernels=True) == (256, 4096)
    for n, block in ((16384, 512), (7680, 1024), (160, 64), (1280, 256)):
        B = tbc.effective_block(n, block)
        assert tbc.factor_plan(n, block, True) == tbc.factor_plan(n, block, False) == (B, -(-n // B) * B)


def test_range_scale_is_one_in_range_and_exact_beyond():
    """The range scale: exactly 1 (all three entries) while max diag(K) is
    below 2⁶⁴; for diag(K) ~ 1e30 an exact power of two s = r² that brings
    max diag(K) below 1, and the twins' factor of s·K, unscaled by 1/r, is
    bit-identical to the factor of K (scaling by a power of two is exact,
    sqrt included)."""
    assert torch.equal(tbc.range_scale(torch.tensor([1.0, 2.0 ** 63])), torch.ones(3))
    K = _spd(64, 46, np.float64).astype(np.float32) * np.float32(1e30)
    sc = tbc.range_scale(torch.from_numpy(np.diag(K).copy()))
    s, r, rinv = (float(v) for v in sc)
    m = float(np.max(np.diag(K)))
    assert np.frexp(r)[0] == 0.5 and s == r * r and r * rinv == 1.0
    assert m * s < 1.0 <= m * s * 4
    L = tbc.blocked_cholesky(torch.from_numpy(K.copy()), block_size=32)
    Ls = tbc.blocked_cholesky(torch.from_numpy(K.copy()) * sc[0], block_size=32)
    assert torch.isfinite(L).all()
    assert torch.equal(Ls * sc[2], L)


@pytest.mark.parametrize("n, B", [(16384, 512), (1024, 64)], ids=["bench", "small"])
def test_spanel_plan_covers_k_once(n, B):
    """K-spanel's split-K plan at every block column: the chunks cover
    [0, r0) exactly once, in order, none empty, each a whole number of
    32-deep k slices (csrc/gemm_tf32x3.cuh's stage); the last columns,
    whose output tiles cannot fill the card's 132 SMs, are split, and at
    N = 16,384 the first ones, whose tiles fill whole waves, are not."""
    split = []
    for j in range(n // B):
        r0 = j * B
        splits, k_chunk = tbc.spanel_plan(n, r0, B)
        if r0 == 0:
            assert (splits, k_chunk) == (1, 0)
            continue
        assert splits >= 1 and k_chunk > 0 and k_chunk % tbc.TF32X3_K_SLICE == 0
        chunks = [(z * k_chunk, min(r0, (z + 1) * k_chunk)) for z in range(splits)]
        assert chunks[0][0] == 0 and chunks[-1][1] == r0
        assert all(a < b for a, b in chunks)
        assert all(chunks[z][1] == chunks[z + 1][0] for z in range(splits - 1))
        if splits > 1:
            split.append(j)
    tiles = [-(-(n - j * B) // tbc.TF32X3_TILE) * -(-B // tbc.TF32X3_TILE) for j in split]
    assert split and split[-1] == n // B - 1 and min(tiles) < tbc.H100_SMS
    if n == 16384:
        assert split[0] >= 8 and all(j in split for j in range(26, 32))


def _tf32_rna(x):
    """cvt.rna.tf32.f32 on the float32 bit pattern: keep 10 explicit
    mantissa bits, rounding to nearest with ties away from zero (add half of
    the 13 dropped bits to the magnitude, then clear them). Finite inputs."""
    bits = np.asarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_3xtf32_split_stays_inside_spanel_bound():
    """The precision argument K-spanel's tensor-core kernel rests on,
    emulated on the CPU: each operand split into big = rna(x) and small =
    rna(x − big), three TF32 products (small·big, big·small, big·big, exact
    in float32) summed into a float32 accumulator k by k. Each product is
    within 12u|a·b| of the exact one (u = 2⁻²⁴), and S = K − A·Cᵀ at block
    column 2 of a real factor (n = 256, B = 64, r0 = 128) stays within the
    summation bound chip_smoke.py holds the kernel to, 2(r0+1)u(|A||C|ᵀ +
    |K|), against float64; a single TF32 pass (big·big only) does not. And
    with the tensor cores' flush of products below FLT_MIN emulated, the
    kernel's 2¹⁶ prescale keeps subnormal sums that the unscaled split
    loses."""
    u = 2.0 ** -24
    rng = np.random.RandomState(44)
    a = (rng.randn(100000) * np.exp(rng.randn(100000))).astype(np.float32)
    b = (rng.randn(100000) * np.exp(rng.randn(100000))).astype(np.float32)
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    as_, bs = _tf32_rna(a - ab), _tf32_rna(b - bb)
    exact = a.astype(np.float64) * b
    three = ab.astype(np.float64) * bs + as_.astype(np.float64) * bb + ab.astype(np.float64) * bb
    assert np.all(np.abs(three - exact) <= 12 * u * np.abs(exact))

    n, B, j = 256, 64, 2
    r0, K = j * B, _spd(n, 45, np.float64)
    buf = K.copy()
    buf[:, :r0] = np.linalg.cholesky(K)[:, :r0]
    buf = buf.astype(np.float32)
    A, C, Kp = buf[r0:, :r0], buf[r0:r0 + B, :r0], buf[r0:, r0:r0 + B]
    acc3 = np.zeros((n - r0, B), np.float32)
    acc1 = np.zeros((n - r0, B), np.float32)
    for k in range(r0):
        abig, cbig = _tf32_rna(A[:, k]), _tf32_rna(C[:, k])
        asml, csml = _tf32_rna(A[:, k] - abig), _tf32_rna(C[:, k] - cbig)
        acc3 += np.outer(asml, cbig)
        acc3 += np.outer(abig, csml)
        acc3 += np.outer(abig, cbig)
        acc1 += np.outer(abig, cbig)
    ref = Kp.astype(np.float64) - A.astype(np.float64) @ C.astype(np.float64).T
    bound = 2 * (r0 + 1) * u * (np.abs(A).astype(np.float64) @ np.abs(C).T + np.abs(Kp))
    assert np.all(np.abs((Kp - acc3) - ref) <= bound)
    assert np.max(np.abs((Kp - acc1) - ref) / bound) > 1.0

    # the range: the tensor cores flush a product below FLT_MIN (2⁻¹²⁶) to
    # zero, so the kernel scales both operands by 2¹⁶ before the split and
    # the sum by 2⁻³² after. With operands ~1e-20 (products ~1e-40,
    # subnormal in float32) the unscaled split loses the sums; the scaled
    # one stays within the bound plus the underflow term (r0+1)·2⁻¹⁴⁹
    At, Ct = A * np.float32(1e-20), C * np.float32(1e-20)

    def tensor_core(prescale):
        acc = np.zeros((n - r0, B), np.float32)
        for k in range(r0):
            a, c = At[:, k] * np.float32(prescale), Ct[:, k] * np.float32(prescale)
            abig, cbig = _tf32_rna(a), _tf32_rna(c)
            asml, csml = _tf32_rna(a - abig), _tf32_rna(c - cbig)
            for x, y in ((asml, cbig), (abig, csml), (abig, cbig)):
                prod = np.outer(x, y)
                acc += np.where(np.abs(prod) < np.float32(2.0 ** -126), np.float32(0), prod)
        return acc * np.float32(1.0 / prescale ** 2)

    exact = At.astype(np.float64) @ Ct.astype(np.float64).T
    tiny = 2 * (r0 + 1) * (u * (np.abs(At).astype(np.float64) @ np.abs(Ct).T) + 2.0 ** -150)
    assert np.all(np.abs(tensor_core(2.0 ** 16) - exact) <= tiny)
    assert np.max(np.abs(tensor_core(1.0) - exact) / tiny) > 1.0
