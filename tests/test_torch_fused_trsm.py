"""The fused below-TRSM column loop (ops/blocked_cholesky fused_trsm: K-sdiag,
K-below-trsm, K-commit) and the block-lower syrk (ops/blocked_trisolve
syrk_lower: K-syrk) of mogptk_tpu_torch, on the CPU, where they run their
kernels' plain twins; each against the port's unfused route and against the
JAX package (its Pallas kernels in interpret mode). The training steps with
both switches on are cases of the blocked-route tests in
test_torch_closed_form.py and test_torch_training.py."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mogptk_tpu.ops.blocked_cholesky import blocked_cholesky as jax_blocked_cholesky
from mogptk_tpu.ops.blocked_trisolve import syrk_lower as jax_syrk_lower
import mogptk_tpu_torch.gpr as tgpr
from mogptk_tpu_torch.ops import blocked_cholesky as tbc
from mogptk_tpu_torch.ops import blocked_trisolve as tbt
from mogptk_tpu_torch.ops import linalg as tla

import jax_reference

FUSED = (tbc.s_diag, tbc.below_trsm, tbc.col_commit, tbt.syrk_lower)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small shapes: one torch thread (the suite runs files in parallel
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spd(n, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n) / np.sqrt(n)
    return A @ A.T + 3.0 * np.eye(n)


def _launches():
    return [f.launches for f in FUSED]


@pytest.mark.parametrize("zero_upper", [True, False], ids=["zero_upper", "keep_upper"])
@pytest.mark.parametrize("shift", ["scalar", "vector"])
def test_fused_twins_match_unfused_route(shift, zero_upper):
    """float64, n = 192, B = 64 (three block columns: K-below-trsm's twin
    runs for the middle one), every panel inverse returned. rtol 1e-10:
    both routes are float64 factorizations of the same matrix that differ
    only in how the S products are grouped. With zero_upper off both leave
    the same K values in the strict upper. CPU tensors count no launch."""
    n = 192
    K = _spd(n, 60)
    d = 0.3 if shift == "scalar" else np.random.RandomState(61).rand(n)
    before = _launches()
    outs = [tbc.blocked_cholesky(torch.from_numpy(K.copy()), block_size=64,
                                 diag_shift=torch.as_tensor(np.asarray(d)), zero_upper=zero_upper,
                                 return_panel_invs=True, fused_trsm=fused)
            for fused in (False, True)]
    (L0, invs0), (L1, invs1) = outs
    torch.testing.assert_close(L1, L0, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(invs1, invs0, rtol=1e-10, atol=1e-12)
    assert invs1.shape == (3, 64, 64)
    ref = np.linalg.cholesky(K + np.diag(np.broadcast_to(d, (n,))))
    np.testing.assert_allclose(np.tril(L1.numpy()), ref, rtol=1e-10, atol=1e-12)
    if zero_upper:
        assert np.all(np.triu(L1.numpy(), 1) == 0.0)
    assert _launches() == before


def _jax_fused(K, d):
    L, invs = jax_reference.jit(lambda K_, d_: jax_blocked_cholesky(
        K_, block_size=512, diag_shift=d_, fused_trsm=True, return_panel_invs=True,
        zero_upper=False))(jnp.asarray(K), jnp.asarray(d))
    return np.tril(np.asarray(L)), np.stack([np.asarray(i) for i in invs])


def _f32_problem():
    """tests/test_linalg.py test_fused_trsm_column_pipeline_matches_base's
    matrix (A·Aᵀ + n·I, float32, n = 1,536) and vector shift."""
    rng = np.random.RandomState(0)
    n = 1536
    A = rng.randn(n, n).astype(np.float32)
    K = (A @ A.T + n * np.eye(n)).astype(np.float32)
    d = (0.1 + rng.rand(n)).astype(np.float32)
    return K, d


@pytest.fixture(scope="module")
def jax_fused_f32(tmp_path_factory):
    return jax_reference.once_per_run(tmp_path_factory, "fused_trsm_jax_f32",
                                      lambda: _jax_fused(*_f32_problem()))


def test_f32_fused_route_matches_jax_fused_pipeline(jax_fused_f32):
    """float32 at n = 1,536, B = 512 (three block columns, so the JAX
    package runs _s_diag_pallas, _below_trsm_pallas and _col_commit in
    interpret mode with bf16x3 products; the port runs the plain twins in
    FP32), a vector shift, every panel inverse, zero_upper off. atol 5e-4
    on the factor (entries ~40-60), as tests/test_linalg.py holds the JAX
    fused pipeline to its unfused flow; the panel inverses rtol 1e-4 with
    atol 1e-7 (entries up to ~0.025)."""
    L_ref, invs_ref = jax_fused_f32
    K, d = _f32_problem()
    L, invs = tbc.blocked_cholesky(torch.from_numpy(K), block_size=512,
                                   diag_shift=torch.from_numpy(d), zero_upper=False,
                                   return_panel_invs=True, fused_trsm=True)
    assert L.dtype == torch.float32
    np.testing.assert_allclose(np.tril(L.numpy()), L_ref, rtol=0, atol=5e-4)
    np.testing.assert_allclose(invs.numpy(), invs_ref, rtol=1e-4, atol=1e-7)


def test_syrk_lower_twin_matches_jax_syrk():
    """syrk_lower_plain against the JAX package's Pallas syrk_lower
    (interpret mode, bf16x3) at n = 256, block 128, k_chunk 64, on the
    block-lower part (the strict upper blocks are unwritten in both).
    rtol 2e-5, atol 2e-3·max|block|, tests/test_linalg.py
    test_syrk_lower_matches_dense's tolerance."""
    n, B = 256, 128
    W = np.tril(np.random.RandomState(11).randn(n, n)).astype(np.float32)
    ref = np.asarray(jax_reference.jit(lambda W_: jax_syrk_lower(W_, block=B, k_chunk=64))(
        jnp.asarray(W)))
    got = tbt.syrk_lower_plain(torch.from_numpy(W), B).numpy()
    for i in range(n // B):
        for j in range(i + 1):
            want = ref[i * B:(i + 1) * B, j * B:(j + 1) * B]
            np.testing.assert_allclose(got[i * B:(i + 1) * B, j * B:(j + 1) * B], want, rtol=2e-5,
                                       atol=2e-3 * np.abs(want).max())


def test_not_positive_definite_gives_nan_with_fused_trsm():
    """The failure latch: a non-positive-definite second diagonal block
    gives NaN there and in every later block (NaN inverse → NaN rows below
    → NaN S_jj), the first block stays finite."""
    K = _spd(192, 43)
    K[100, 100] = -50.0
    L = tbc.blocked_cholesky(torch.from_numpy(K), block_size=64, fused_trsm=True).numpy()
    assert np.all(np.isfinite(L[:64, :64]))
    assert np.all(np.isnan(L[64:, 64:].diagonal()))
    assert np.all(np.isnan(L[128:, 64:128]))


def test_switches_default_off_and_route_the_training_factor(monkeypatch):
    """Both switches default to False, as in the JAX package. Switched on,
    the training LMLs' factor (ops/linalg._chol_lml) goes through s_diag,
    below_trsm and col_commit, and spd_inverse_from_factor through
    syrk_lower; switched off, through neither; cholesky() without
    fused_trsm (predict, the jitter ladder) never. K⁻¹ agrees either way
    (float64, rtol 1e-10)."""
    cfg = tgpr.config
    assert cfg.blocked_cholesky_fused_trsm is False and cfg.pallas_syrk is False
    calls = []
    for mod, name in ((tbc, "s_diag_plain"), (tbc, "below_trsm_plain"), (tbc, "col_commit_plain"),
                      (tbt, "syrk_lower")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or _fn(*a, **k))
    n = 192
    K = torch.from_numpy(_spd(n, 62))
    y = torch.from_numpy(np.random.RandomState(63).randn(n, 1))
    diag = torch.full((n,), 0.1, dtype=torch.float64)
    saved = (cfg.blocked_cholesky, cfg.blocked_cholesky_block)
    tgpr.use_blocked_cholesky(True, block_size=64)
    got = {}
    try:
        for on in (False, True):
            cfg.blocked_cholesky_fused_trsm = cfg.pallas_syrk = on
            del calls[:]
            val, L, invs, _ = tla._chol_lml(K.clone(), diag, y)
            Kinv = tbt.spd_inverse_from_factor(L, block_size=64, invs=invs)
            tla.cholesky(K.clone(), diag_shift=diag)
            got[on] = (float(val), Kinv)
            want = ["s_diag_plain", "below_trsm_plain", "col_commit_plain", "s_diag_plain",
                    "col_commit_plain", "syrk_lower"] if on else []
            assert calls == want
    finally:
        cfg.blocked_cholesky_fused_trsm = cfg.pallas_syrk = False
        cfg.blocked_cholesky, cfg.blocked_cholesky_block = saved
    assert got[True][0] == pytest.approx(got[False][0], rel=1e-12)
    torch.testing.assert_close(got[True][1], got[False][1], rtol=1e-10, atol=1e-12)
    ref = np.linalg.inv(K.numpy() + 0.1 * np.eye(n))
    np.testing.assert_allclose(got[True][1].numpy(), ref, rtol=1e-10, atol=1e-12)


def test_fused_gates():
    """Where the fused loop and K-syrk apply: the twins take any block; on
    the card the fused kernels take a block of 256 or 512 and K-syrk a
    multiple of 128 (the unfused loop and the matmul loop otherwise: shape
    gates, as the JAX package has its own)."""
    cpu = torch.zeros(4, 4)
    assert tbc.fused_applicable(cpu, 40)
    meta = torch.empty((1024, 1024), device="meta")
    assert tbc.fused_applicable(meta, 512) and tbc.fused_applicable(meta, 256)
    assert not tbc.fused_applicable(meta, 1024) and not tbc.fused_applicable(meta, 128)
    cfg = tgpr.config
    assert not tbt._syrk_lower_applicable(meta, 512)       # switched off
    cfg.pallas_syrk = True
    try:
        assert tbt._syrk_lower_applicable(meta, 512)
        assert not tbt._syrk_lower_applicable(meta, 64)
        assert tbt._syrk_lower_applicable(torch.zeros(120, 120), 40)
        assert not tbt._syrk_lower_applicable(torch.zeros(120, 120), 50)
    finally:
        cfg.pallas_syrk = False


def test_wrappers_route_by_device_and_dtype():
    """ops/_build.runs_plain's route for the four new wrappers, on the meta
    device standing in for the card: float64 runs the plain twin on the
    tensor's device and counts no launch; float32 goes to the kernel, which
    needs a CUDA tensor and raises."""
    n, B, j = 1024, 256, 1
    before = _launches()
    for dtype in (torch.float64, torch.float32):
        L = torch.empty((n, n), dtype=dtype, device="meta")
        M = torch.empty((B, B), dtype=dtype, device="meta")
        calls = [lambda: tbc.s_diag(L, j, B), lambda: tbc.below_trsm(L, M, j, B),
                 lambda: tbc.col_commit(L, M, j, B), lambda: tbt.syrk_lower(L, 128)]
        for call in calls:
            if dtype == torch.float64:
                call()
            else:
                with pytest.raises(ValueError, match="must be on"):
                    call()
    assert _launches() == before
