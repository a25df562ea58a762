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


@pytest.mark.parametrize("zero_upper", [True, False], ids=["zero_upper", "keep_upper"])
def test_commit_twins_take_the_range_scale(zero_upper):
    """K-commit's twin takes the factor's range scale [s, r, 1/r] as the
    kernel does: the diagonal block is Ljj·(1/r), exactly (a power of two),
    the strip right of it zeroed with zero_upper and untouched without;
    K-below-trsm's twin given Ljj finishes the rows below and then commits,
    bit for bit as the two twins called one after the other. float32, n =
    192, B = 64, the middle block column."""
    n, B, j = 192, 64, 1
    r0 = j * B
    rng = np.random.RandomState(64)
    L = torch.as_tensor(rng.randn(n, n), dtype=torch.float32)
    Ljj = torch.tril(torch.as_tensor(rng.rand(B, B), dtype=torch.float32)) + torch.eye(B)
    inv = torch.linalg.solve_triangular(Ljj, torch.eye(B), upper=False)
    scale = torch.tensor([2.0 ** -100, 2.0 ** -50, 2.0 ** 50])
    L1 = L.clone()
    tbc.col_commit_plain(L1, Ljj, j, B, zero_upper, scale)
    assert torch.equal(L1[r0:r0 + B, r0:r0 + B], Ljj * 2.0 ** 50)
    assert torch.equal(L1[r0:r0 + B, r0:r0 + B] * 2.0 ** -50, Ljj)
    strip = L1[r0:r0 + B, r0 + B:]
    assert torch.equal(strip, torch.zeros_like(strip) if zero_upper else L[r0:r0 + B, r0 + B:])
    L1[r0:r0 + B, r0:] = L[r0:r0 + B, r0:]
    assert torch.equal(L1, L)                       # nothing else written
    L2, L3 = L.clone(), L.clone()
    tbc.below_trsm_plain(L2, inv, j, B, Ljj, zero_upper, scale)
    tbc.below_trsm_plain(L3, inv, j, B)
    tbc.col_commit_plain(L3, Ljj, j, B, zero_upper, scale)
    assert torch.equal(L2, L3)
    before = _launches() + [tbc.below_trsm.commits]
    tbc.below_trsm(L3, inv, j, B, scale, Ljj, zero_upper)   # CPU: the twin, no launch
    assert _launches() + [tbc.below_trsm.commits] == before


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


def test_sdiag_plan_covers_each_lower_tile_once():
    """K-sdiag's work: the lower 128 × 128 tiles of the B × B block in the
    kernel's order (10 at B = 512, 3 at 256), each over the same chunks of
    k, which cover [0, r0) once in order, each a whole number of 32-deep
    slices; the tiles × chunks fit in one wave of the 132 SMs and, where k
    is long enough, fill it (more than 132 − tiles CTAs). K-below-trsm's
    split-K plan on the rows below, at every block column of N = 16,384
    with rows below."""
    for B in (256, 512):
        tiles = tbc.sdiag_tiles(B)
        t1 = B // tbc.TF32X3_TILE
        assert len(tiles) == t1 * (t1 + 1) // 2 == len(set(tiles))
        assert all(0 <= tj <= ti < t1 for ti, tj in tiles)
        for t, tile in enumerate(tiles):   # the kernel's walk from the tile index
            ti = 0
            while (ti + 1) * (ti + 2) // 2 <= t:
                ti += 1
            assert tile == (ti, t - ti * (ti + 1) // 2)
        for j in range(1, 16384 // B):
            r0 = j * B
            splits = tbc.sdiag_plan(r0, B)
            chunks = tbc.sdiag_chunks(r0, splits)
            assert chunks[0][0] == 0 and chunks[-1][1] == r0
            assert all(a < b and a % tbc.TF32X3_K_SLICE == 0 for a, b in chunks)
            assert all(chunks[z][1] == chunks[z + 1][0] for z in range(splits - 1))
            assert len(tiles) * splits <= tbc.H100_SMS
            if r0 // tbc.TF32X3_K_SLICE >= tbc.SDIAG_MIN_SLICES * (tbc.H100_SMS // len(tiles)):
                assert len(tiles) * splits > tbc.H100_SMS - len(tiles), (B, j)
        # K-below-trsm's product, CTA by CTA as csrc/fused_trsm.cu
        # below_product_kernel walks its grid: each (128-row tile below the
        # diagonal block, 128-column tile, 32-deep k slice) exactly once
        n, T, K = 16384, tbc.TF32X3_TILE, tbc.TF32X3_K_SLICE
        split = []
        for j in range(1, n // B - 1):
            r0 = j * B
            splits, k_chunk = tbc.below_trsm_plan(n, r0, B)
            assert k_chunk > 0 and k_chunk % K == 0 and -(-r0 // k_chunk) == splits
            tiles_m, tiles_b = -(-(n - r0 - B) // T), B // T
            seen = np.zeros((tiles_m, tiles_b, r0 // K), dtype=int)
            for blk in range(tiles_m * tiles_b * splits):
                z = blk // (tiles_m * tiles_b)
                kbeg, kend = z * k_chunk, min(r0, (z + 1) * k_chunk)
                assert kbeg < kend
                seen[(blk // tiles_b) % tiles_m, blk % tiles_b, kbeg // K:kend // K] += 1
            assert (seen == 1).all(), (B, j)
            if splits > 1:
                split.append(j)
        assert split and split[-1] == n // B - 2   # the last columns below split k


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
