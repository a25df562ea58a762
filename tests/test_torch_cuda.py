"""The CUDA kernels of mogptk_tpu_torch against their plain twins, on the
card. Without CUDA the whole file is skipped before collection, so these
tests are neither collected nor counted there; on a card,

    python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py

runs them (the tests directory's conftest imports jax)."""
import numpy as np
import pytest
import torch

if not torch.cuda.is_available():
    pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)",
                allow_module_level=True)

from mogptk_tpu_torch.ops import blocked_cholesky as tbc
from mogptk_tpu_torch.ops import block_mosm as tbm
from mogptk_tpu_torch.ops import mosm_gram as tmg
from mogptk_tpu_torch.ops import mosm_matvec as tmv

from test_torch_package import _family_kernels


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small shapes: one torch thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_twins():
    """Each kernel against its plain twin on the card, float32, small shapes.
    Tolerances: K-gram 2e-4·max|K| (float32 cosines of arguments up to
    ~30 rad here), its square launch (x1 is x2: the lower launch with band
    = N, the lower tiles mirrored) bitwise symmetric, at n = 300 and 557
    (partial tiles, rows not 16-byte aligned) and channel-sorted, repeats
    bit-identical, and at D = 4 and Q = 5 (the component loop at run
    time); K-spanel, K-colwrite and K-sdiag 2·k·2⁻²⁴·max(|A||B|ᵀ),
    the summation-order bound of two float32 dot products of length k; the
    repaired factors (n = 300 forced, diag ~ 1e30) 1e-4 of max|L| from
    float64 (κ ≤ 5 here); K-matvec as test_cuda_matvec_matches_plain_twin,
    K-matvec-reduce exact (the same order of sums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    O, Q, D, N, M = 3, 2, 1, 300, 200
    x1 = torch.as_tensor(rng.rand(N, D) * 50, dtype=torch.float32, device=dev)
    x2 = torch.as_tensor(rng.rand(M, D) * 50, dtype=torch.float32, device=dev)
    c1 = torch.as_tensor(rng.randint(0, O, N), dtype=torch.int32, device=dev)
    c2 = torch.as_tensor(rng.randint(0, O, M), dtype=torch.int32, device=dev)
    params = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (
        0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
        0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))]
    st3, st2 = tbm.mosm_pair_stats(*params, float(np.sqrt(2 * np.pi)))
    got = tmg.mosm_gram(x1, c1, x2, c2, st3, st2)
    ref = tmg.mosm_gram_pairstats_plain(x1, c1, x2, c2, st3, st2)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 2e-4 * float(ref.abs().max())
    xs = torch.as_tensor(np.sort(rng.rand(557, D) * 50, axis=0), dtype=torch.float32, device=dev)
    for xx, cc in ((x1, c1), (xs, torch.as_tensor(rng.randint(0, O, 557), dtype=torch.int32,
                                                  device=dev)),
                   (xs, tbm.channel_ids((300, 1, 256), dev))):
        launches = tmg.mosm_gram.launches
        got = tmg.mosm_gram(xx, cc, xx, cc, st3, st2)
        assert tmg.mosm_gram.launches == launches + 1
        ref = tmg.mosm_gram_pairstats_plain(xx, cc, xx, cc, st3, st2)
        torch.cuda.synchronize()
        assert torch.equal(got, got.T) and torch.equal(tmg.mosm_gram(xx, cc, xx, cc, st3, st2), got)
        assert float((got - ref).abs().max()) <= 2e-4 * float(ref.abs().max()), xx.shape
        # the same points as another tensor: the cross launch, every tile
        cross = tmg.mosm_gram(xx, cc, xx.clone(), cc.clone(), st3, st2)
        assert float((cross - ref).abs().max()) <= 2e-4 * float(ref.abs().max()), xx.shape
    # K-gram's unrolled instances with the component loop at run time (D = 4;
    # Q = 5), square and cross, channels sorted and not
    rk = np.random.RandomState(5)
    for Qk, Dk in ((2, 4), (5, 1)):
        pk = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (
            0.5 + rk.rand(O, Qk), 0.1 + rk.rand(O, Qk, Dk), 0.2 + rk.rand(O, Qk, Dk),
            0.1 * rk.randn(O, Qk, Dk), 0.1 * rk.randn(O, Qk))]
        s3, s2 = tbm.mosm_pair_stats(*pk, float((2 * np.pi) ** (Dk / 2)))
        assert tmg.kernel_instance("forward", O, Qk, Dk) == "unrolled"
        xk = torch.as_tensor(np.sort(rk.rand(557, Dk) * 20, axis=0), dtype=torch.float32,
                             device=dev)
        for ck in (tbm.channel_ids((300, 1, 256), dev),
                   torch.as_tensor(rk.randint(0, O, 557), dtype=torch.int32, device=dev)):
            for x2k, c2k in ((xk, ck), (xk[::3].contiguous(), ck[::3].contiguous())):
                got = tmg.mosm_gram(xk, ck, x2k, c2k, s3, s2)
                ref = tmg.mosm_gram_pairstats_plain(xk, ck, x2k, c2k, s3, s2)
                torch.cuda.synchronize()
                assert float((got - ref).abs().max()) <= 2e-4 * float(ref.abs().max()), (Qk, Dk)

    # K-spanel (3xTF32, split-K where planned) and K-colwrite at every block
    # column of real factors, B = 64 (masked column tiles), 256 and 512,
    # against their twins under the summation bounds chip_smoke.py uses;
    # each launch repeated bit-identically
    u = 2.0 ** -24
    for n, B in ((256, 64), (2048, 256), (4096, 512)):
        A0 = rng.randn(n, n) / np.sqrt(n)
        K = torch.as_tensor(A0 @ A0.T + np.eye(n), dtype=torch.float32, device=dev)
        F = torch.linalg.cholesky(K)
        S, S_ref = torch.empty(n, B, device=dev), torch.empty(n, B, device=dev)
        eye = torch.eye(B, device=dev)
        for j in range(n // B):
            r0, m = j * B, n - j * B
            L = K.clone()
            L[:, :r0] = F[:, :r0]
            tbc.s_panel(L, S, j, B)
            got = S[:m].clone()
            tbc.s_panel(L, S, j, B)
            assert torch.equal(S[:m], got), (n, B, j)
            tbc.s_panel_plain(L, S_ref, j, B)
            A, Kp = L[r0:, :r0].abs(), L[r0:, r0:r0 + B].abs()
            bound = 2 * (r0 + 1) * u * (A @ A[:B].T + Kp)
            assert bool(((got - S_ref[:m]).abs() <= bound).all()), (n, B, j)
            Ljj = F[r0:r0 + B, r0:r0 + B].contiguous()
            inv = torch.linalg.solve_triangular(Ljj, eye, upper=False).contiguous()
            tol = 2 * B * u * float((got[B:].abs() @ inv.abs().T).max()) if m > B else 0.0
            for zero_upper in (True, False):
                L1, L2 = L.clone(), L.clone()
                tbc.col_write(L1, S, Ljj, inv, j, B, zero_upper)
                again = L.clone()
                tbc.col_write(again, S, Ljj, inv, j, B, zero_upper)
                assert torch.equal(again, L1), (n, B, j, zero_upper)
                tbc.col_write_plain(L2, S, Ljj, inv, j, B, zero_upper)
                assert float((L1 - L2).abs().max()) <= tol, (n, B, j, zero_upper)
            if j > 0 and B in tbc.FUSED_BLOCKS:
                # K-sdiag (3xTF32 on the lower tiles, the upper product mirrored) under
                # the same summation bound, repeated bit-identically
                Sjj = tbc.s_diag(L, j, B)
                assert torch.equal(tbc.s_diag(L, j, B), Sjj) and torch.equal(Sjj, Sjj.T), (n, B, j)
                C = L[r0:r0 + B, :r0].abs()
                tolS = 2 * (r0 + 1) * u * (C @ C.T + L[r0:r0 + B, r0:r0 + B].abs())
                assert bool(((Sjj - tbc.s_diag_plain(L, j, B)).abs() <= tolS).all()), (n, B, j)

    # the blocked factor's repairs, against float64 of the same float32
    # input: a forced factor at n = 300 (one 320-wide panel, padded), and
    # a Gram with diag ~ 1e30, unfused and fused, which is moreover
    # bit-identical to the factor of the same Gram times its range scale
    # (in range: scale 1), unscaled
    for n, big in ((300, False), (1280, True)):
        A0 = rng.randn(n, n) / np.sqrt(n)
        K = torch.as_tensor((A0 @ A0.T + np.eye(n)) * (1e30 if big else 1.0), dtype=torch.float32,
                            device=dev)
        ref = torch.linalg.cholesky(K.double())
        for fused in ((False, True) if big else (False,)):
            L = tbc.blocked_cholesky(K.clone(), block_size=256 if big else 512, fused_trsm=fused)
            assert L.shape == (n, n) and bool(torch.isfinite(L).all()), (n, fused)
            assert float((L.double() - ref).abs().max()) <= 1e-4 * float(ref.abs().max()), (n, fused)
            if big:
                sc = tbc.range_scale(K.diagonal())
                assert float(sc[0]) < 1.0
                Ls = tbc.blocked_cholesky(K.clone() * sc[0], block_size=256, fused_trsm=fused)
                assert torch.equal(L, Ls * sc[2]), fused

    # K-matvec (the fold) and K-matvec-reduce against their twins: R = 1,
    # 33, 300 and 2,100 (one, one, eight and 53 column chunks), channel-
    # sorted and permuted, repeats bit-identical; tolerance as
    # test_cuda_matvec_matches_plain_twin's
    counts, O, Q, D = (300, 1, 257), 3, 2, 1
    n = sum(counts)
    x = torch.as_tensor(np.sort(rng.rand(n, D) * 20, axis=0), dtype=torch.float32, device=dev)
    c = tbm.channel_ids(counts, dev)
    params = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (
        0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
        0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))]
    st3, st2 = tbm.mosm_pair_stats(*params, float(np.sqrt(2 * np.pi)))
    perm = torch.as_tensor(rng.permutation(n), device=dev)
    kmax = float(tmg.mosm_gram_pairstats_plain(x, c, x, c, st3, st2).abs().max())
    for R in (1, 33, 300, 2100):
        V = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=dev)
        tol = (2e-4 + n * 2.0 ** -24) * kmax * V.abs().sum(dim=0)
        for xx, cc, VV in ((x, c, V), (x[perm].contiguous(), c[perm].contiguous(),
                                       V[perm].contiguous())):
            got = tmv.mosm_matvec(xx, cc, st3, st2, VV)
            assert torch.equal(tmv.mosm_matvec(xx, cc, st3, st2, VV), got), R
            assert bool(((got - tmv.mosm_matvec_plain(xx, cc, st3, st2, VV)).abs() <= tol).all()), R
            if R == 33:
                part = tmv.fold_partials(xx, cc, st3, st2, VV)
                assert torch.equal(tmv.mosm_matvec_reduce(part, n),
                                   tmv.mosm_matvec_reduce_plain(part, n))
    torch.cuda.synchronize()


def _rel_err(got, ref):
    """max |got − ref| over max |ref|, across a list of tensors."""
    return max(float((g.double() - r.double()).abs().max()) / max(float(r.abs().max()), 1e-30)
               for g, r in zip(got, ref))


@pytest.mark.cuda
def test_cuda_training_kernels_match_plain_twins():
    """K-gram-lower, K-solve and K-lowrank-vjp against their plain twins on
    the card, float32, small shapes. Tolerances: K-gram-lower 2e-4·max|K| on
    the written tiles, as K-gram; K-solve and K-lowrank-vjp no more than
    2× the float32 twin's error against a float64 twin on the same inputs,
    plus a floor of 1e-5 relative (summation order alone). Repeats of
    K-solve and K-lowrank-vjp are bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from mogptk_tpu_torch.ops import blocked_trisolve as tbt
    from mogptk_tpu_torch.ops import fused_solve as tfs
    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    T = tbm.TILE
    for counts, Q, D in (((T, T), 2, 1), ((T, 2 * T), 1, 2)):
        O, n = len(counts), sum(counts)
        x = torch.as_tensor(np.sort(rng.rand(n, D) * 20, axis=0), dtype=torch.float32, device=dev)
        params = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (
            0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
            0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))]
        st3, st2 = tbm.mosm_pair_stats(*params, float((2 * np.pi) ** (D / 2)))
        c = tbm.channel_ids(counts, dev)
        got = tbm.mosm_gram_sorted_lower(x, counts, st3, st2, band=T)
        ref = tbm.mosm_gram_sorted_lower_plain(x, c, st3, st2, T)
        torch.cuda.synchronize()
        written = ~torch.isnan(ref)
        assert float((got - ref)[written].abs().max()) <= 2e-4 * float(ref[written].abs().max())

    # K-solve: R = 1, 17 and 64 with Bs = 256 and 512; the strict upper holds
    # NaN (neither solve may read it); a repeat, and grids forced to a quarter
    # of the SMs and to one CTA, bit-identical: the persistent launch cannot
    # deadlock (one CTA runs every ticket in order, so a wait on a later
    # ticket would hang it) and sums each output in one order
    n = 1024
    A = torch.as_tensor(rng.randn(n, n) / np.sqrt(n), dtype=torch.float64, device=dev)
    L64 = torch.linalg.cholesky(A @ A.T + 2 * torch.eye(n, dtype=torch.float64, device=dev))
    L = torch.tril(L64).float() + torch.triu(torch.full((n, n), float("nan"), device=dev), 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def capped(cap, *args):
        tfs._GRID_CAP = cap
        try:
            return tfs.fused_cho_solve(*args)
        finally:
            tfs._GRID_CAP = 0

    for Bs in (256, 512):
        invs = tbt.panel_inverses(torch.tril(L64).float(), block_size=Bs)
        for r in (1, 17, 64):
            B = torch.as_tensor(rng.randn(n, r), dtype=torch.float32, device=dev)
            launches = tfs.fused_cho_solve.launches
            X = tfs.fused_cho_solve(L, invs, B)
            repeats = [capped(m, L, invs, B) for m in (0, sms // 4, 1)]
            assert tfs.fused_cho_solve.launches == launches + 4
            X_twin = tbt.blocked_cho_solve(L, B, invs=invs)
            X64 = torch.cholesky_solve(B.double(), torch.tril(L.nan_to_num(0.0)).double(),
                                       upper=False)
            torch.cuda.synchronize()
            assert _rel_err([X], [X64]) <= 2 * _rel_err([X_twin], [X64]) + 1e-5, (Bs, r)
            assert all(torch.equal(X, Xr) for Xr in repeats), (Bs, r)
    # a panel width that is no multiple of 4 (element-wise copies, ragged
    # row tiles) still solves
    n, Bs, r = 300, 50, 5
    L = torch.tril(L64[:n, :n]).float()
    invs = tbt.panel_inverses(L, block_size=Bs)
    B = torch.as_tensor(rng.randn(n, r), dtype=torch.float32, device=dev)
    X = tfs.fused_cho_solve(L, invs, B)
    X_twin = tbt.blocked_cho_solve(L, B, invs=invs)
    X64 = torch.cholesky_solve(B.double(), L.double(), upper=False)
    torch.cuda.synchronize()
    assert _rel_err([X], [X64]) <= 2 * _rel_err([X_twin], [X64]) + 1e-5

    for counts, Q, D in (((300, 260), 2, 1), ((40, 33, 50), 2, 2)):
        O, n = len(counts), sum(counts)
        x = torch.as_tensor(np.sort(rng.rand(n, D) * 20, axis=0), dtype=torch.float32, device=dev)
        params = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (
            0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
            0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))]
        twopi = float((2 * np.pi) ** (D / 2))
        st3, st2 = tbm.mosm_pair_stats(*params, twopi)
        Am = torch.as_tensor(rng.randn(n, 17) / n, dtype=torch.float32, device=dev)
        Bm = torch.as_tensor(rng.randn(n, 17), dtype=torch.float32, device=dev)
        raw = tbm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, Am, Bm)
        again = tbm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, Am, Bm)
        got = tbm.pair_stats_vjp(params, twopi, *raw)
        twin = tbm.pair_stats_vjp(params, twopi, *tbm.mosm_lowrank_vjp_plain(x, counts, st3, st2, Am, Bm))
        p64 = [p.double() for p in params]
        st64 = tbm.mosm_pair_stats(*p64, twopi)
        ref = tbm.pair_stats_vjp(p64, twopi, *tbm.mosm_lowrank_vjp_plain(
            x.double(), counts, *st64, Am.double(), Bm.double()))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(raw, again))
        assert _rel_err(got, ref) <= 2 * _rel_err(twin, ref) + 1e-5


@pytest.mark.cuda
def test_cuda_kernels_spread_nan_made_on_the_card():
    """NaN made by the card's own FP32 operations (torch.sqrt(-1): the
    canonical NaN 0x7fffffff, which an integer TF32 rounding could carry
    into -0) spreads through K-solve, K-lowrank-vjp, K-matvec, K-gram,
    K-gram-bwd and K-fam-lowrank-vjp as through their plain twins: the same
    entries are NaN, and none of the others."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from mogptk_tpu_torch.ops import blocked_trisolve as tbt
    from mogptk_tpu_torch.ops import fused_solve as tfs
    dev = torch.device("cuda")
    rng = np.random.RandomState(5)
    nan = torch.sqrt(-torch.ones((), device=dev))

    def same_nan(got, twin):
        for g, t in zip(got, twin):
            assert bool(torch.isnan(t).any()) and torch.equal(torch.isnan(g), torch.isnan(t))

    # K-solve: NaN in one entry of B (its column only), then in the
    # inverse of one panel (every column)
    n, Bs = 1024, 256
    A = torch.as_tensor(rng.randn(n, n) / np.sqrt(n), dtype=torch.float64, device=dev)
    L = torch.tril(torch.linalg.cholesky(A @ A.T + 2 * torch.eye(n, dtype=torch.float64,
                                                                 device=dev))).float()
    invs = tbt.panel_inverses(L, block_size=Bs)
    B = torch.as_tensor(rng.randn(n, 17), dtype=torch.float32, device=dev)
    Bn = B.clone()
    Bn[300, 2] = nan
    invn = invs.clone()
    invn[1] = invn[1] * nan
    for args in ((L, invs, Bn), (L, invn, B)):
        same_nan([tfs.fused_cho_solve(*args)], [tbt.blocked_cho_solve(args[0], args[2],
                                                                      invs=args[1])])

    counts, O, Q, D = (300, 260), 2, 2, 1
    n = sum(counts)
    x = torch.as_tensor(np.sort(rng.rand(n, D) * 20, axis=0), dtype=torch.float32, device=dev)
    params = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (
        0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
        0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))]
    twopi = float(np.sqrt(2 * np.pi))
    st3, st2 = tbm.mosm_pair_stats(*params, twopi)
    # K-lowrank-vjp: NaN in one row of A, then of B
    Am = torch.as_tensor(rng.randn(n, 17) / n, dtype=torch.float32, device=dev)
    Bm = torch.as_tensor(rng.randn(n, 17), dtype=torch.float32, device=dev)
    for which in (0, 1):
        AB = [Am.clone(), Bm.clone()]
        AB[which][100] = nan
        same_nan(tbm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, *AB),
                 tbm.mosm_lowrank_vjp_plain(x, counts, st3, st2, *AB))
    # K-matvec: NaN in one entry of V (its column only), then in channel 1's
    # weight, so the Gram the kernel evaluates holds NaN
    c = tbm.channel_ids(counts, dev)
    V = torch.as_tensor(rng.randn(n, 33), dtype=torch.float32, device=dev)
    Vn = V.clone()
    Vn[400, 5] = nan
    pn = [p.clone() for p in params]
    pn[0][1, 0] = nan
    stn = tbm.mosm_pair_stats(*pn, twopi)
    for s3, s2, VV in ((st3, st2, Vn), (*stn, V)):
        same_nan([tmv.mosm_matvec(x, c, s3, s2, VV)], [tmv.mosm_matvec_plain(x, c, s3, s2, VV)])
    # K-gram, square (mirrored) and cross: NaN in channel 1's weight, then in
    # one point (the turn reduction's rounding and the hardware cos on NaN)
    xn = x.clone()
    xn[200] = nan
    x3, c3 = x[::3].contiguous(), c[::3].contiguous()
    for s3, s2, xx in ((*stn, x), (st3, st2, xn)):
        same_nan([tmg.mosm_gram(xx, c, xx, c, s3, s2), tmg.mosm_gram(xx, c, x3, c3, s3, s2)],
                 [tmg.mosm_gram_pairstats_plain(xx, c, xx, c, s3, s2),
                  tmg.mosm_gram_pairstats_plain(xx, c, x3, c3, s3, s2)])
    # K-gram-bwd: NaN in g below the diagonal, then above it, then in
    # channel 1's weight (sincos_two_pi's rint and (int)k on NaN); x2 as x
    # (one channel map) and as a copy of x
    g = torch.as_tensor(rng.randn(n, n), dtype=torch.float32, device=dev)
    for i, j in ((400, 10), (10, 400)):
        gn = g.clone()
        gn[i, j] = nan
        for x2 in (x, x.clone()):
            same_nan(tmg.mosm_gram_bwd(x, c, x2, c, st3, st2, gn, counts, counts),
                     tmg.mosm_gram_bwd_plain(x, c, x2, c, st3, st2, gn))
    same_nan(tmg.mosm_gram_bwd(x, c, x, c, *stn, g, counts, counts),
             tmg.mosm_gram_bwd_plain(x, c, x, c, *stn, g))
    # K-fam-lowrank-vjp (its g through the same TF32 split): NaN in one row
    # of A, then of B
    from mogptk_tpu_torch import gpr
    from mogptk_tpu_torch.ops import block_families as tbf
    csm = gpr.CrossSpectralKernel(O, D, Rq=2).to(dev)
    pack = tbf.family_pack(csm.family, csm._fused_params()).detach()
    for which in (0, 1):
        AB = [Am.clone(), Bm.clone()]
        AB[which][100] = nan
        same_nan([tbf.family_lowrank_vjp_sorted(csm.family, x, counts, pack, *AB)],
                 [tbf.family_lowrank_vjp_plain(csm.family, x, counts, pack, *AB)])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_gram_bwd_matches_plain_twin():
    """K-gram-bwd against its plain twin on the card, float32, small shapes:
    unsorted channel IDs with a cross-Gram (N ≠ M); channel-sorted data with
    unequal ragged channels and D = 2 (padding on every channel); and n = 300
    points with channels permuted. The square cases run with x2 as x1 (one
    channel map for rows and columns) and as a copy of x1. Tolerance: no
    more than 2x the float32 twin's error against a float64 twin on the same
    inputs, plus a floor of 1e-5 relative (summation order alone). A repeated
    call is bit-identical (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    O, Q = 3, 2
    cases = []
    for D, layout in ((1, "cross"), (2, "sorted"), (1, "permuted")):
        if layout == "cross":
            N, M = 700, 500
            c1 = torch.as_tensor(rng.randint(0, O, N), dtype=torch.int32, device=dev)
            c2 = torch.as_tensor(rng.randint(0, O, M), dtype=torch.int32, device=dev)
            x1 = torch.as_tensor(rng.rand(N, D) * 20, dtype=torch.float32, device=dev)
            x2 = torch.as_tensor(rng.rand(M, D) * 20, dtype=torch.float32, device=dev)
            cases.append((D, None, x1, c1, x2, c2))
            continue
        counts = (300, 1, 257) if layout == "sorted" else (200, 60, 40)
        N = sum(counts)
        x = torch.as_tensor(np.sort(rng.rand(N, D) * 20, axis=0), dtype=torch.float32, device=dev)
        c = tbm.channel_ids(counts, dev)
        if layout == "permuted":
            perm = torch.as_tensor(rng.permutation(N), device=dev)
            x, c = x[perm].contiguous(), c[perm].contiguous()
        cases.append((D, counts, x, c, x, c))                   # one channel map
        cases.append((D, counts, x, c, x.clone(), c.clone()))   # two
    for D, counts, x1, c1, x2, c2 in cases:
        params = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (
            0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
            0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))]
        twopi = float((2 * np.pi) ** (D / 2))
        st3, st2 = tbm.mosm_pair_stats(*params, twopi)
        g = torch.as_tensor(rng.randn(x1.shape[0], x2.shape[0]), dtype=torch.float32, device=dev)
        launches = tmg.mosm_gram_bwd.launches
        got = tmg.mosm_gram_bwd(x1, c1, x2, c2, st3, st2, g, counts, counts)
        again = tmg.mosm_gram_bwd(x1, c1, x2, c2, st3, st2, g, counts, counts)
        assert tmg.mosm_gram_bwd.launches == launches + 2
        twin = tmg.mosm_gram_bwd_plain(x1, c1, x2, c2, st3, st2, g)
        ref = tmg.mosm_gram_bwd_plain(x1.double(), c1, x2.double(), c2, st3.double(),
                                      st2.double(), g.double())
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert _rel_err(got, ref) <= 2 * _rel_err(twin, ref) + 1e-5, (D, counts, x1 is x2)
        # through autograd: the Gram on the card carries MosmGram's backward
        ps = [p.clone().requires_grad_() for p in params]
        K = tmg.mosm_gram(x1, c1, x2, c2, *tbm.mosm_pair_stats(*ps, twopi), counts, counts)
        assert type(K.grad_fn).__name__ == "MosmGramBackward"
        grads = torch.autograd.grad(torch.sum(K * g), ps)
        for a, b in zip(grads, tbm.pair_stats_vjp(params, twopi, *got)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


@pytest.mark.cuda
def test_cuda_matvec_matches_plain_twin():
    """K-matvec against its plain twin on the card, float32: channel-sorted
    ragged channels and the same points permuted, at R = 1, 33 and 1,024
    (one chunk of V, two, and a shrunk row tile). Tolerance per entry
    (2e-4 + N·2⁻²⁴)·max|K|·‖V[:, r]‖₁: K-gram's per-entry bound against its
    twin (2e-4·max|K|, float32 cosines of arguments up to ~140 rad here)
    carried through the sum, plus the float32 summation bound of N terms. A
    repeated call is bit-identical (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    rng = np.random.RandomState(3)
    counts, O, Q, D = (300, 1, 257), 3, 2, 1
    n = sum(counts)
    x = torch.as_tensor(np.sort(rng.rand(n, D) * 20, axis=0), dtype=torch.float32, device=dev)
    c = tbm.channel_ids(counts, dev)
    params = [torch.as_tensor(p, dtype=torch.float32, device=dev) for p in (
        0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
        0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))]
    st3, st2 = tbm.mosm_pair_stats(*params, float(np.sqrt(2 * np.pi)))
    perm = torch.as_tensor(rng.permutation(n), device=dev)
    kmax = float(tmg.mosm_gram_pairstats_plain(x, c, x, c, st3, st2).abs().max())
    for R in (1, 33, 1024):
        V = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=dev)
        tol = (2e-4 + n * 2.0 ** -24) * kmax * V.abs().sum(dim=0)
        for xx, cc, VV in ((x, c, V), (x[perm].contiguous(), c[perm].contiguous(),
                                       V[perm].contiguous())):
            launches = tmv.mosm_matvec.launches
            got = tmv.mosm_matvec(xx, cc, st3, st2, VV)
            again = tmv.mosm_matvec(xx, cc, st3, st2, VV)
            assert tmv.mosm_matvec.launches == launches + 2
            twin = tmv.mosm_matvec_plain(xx, cc, st3, st2, VV)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            assert bool(((got - twin).abs() <= tol).all())


def _mosm_case(rng, O, Q, D, dev, dtype=torch.float32):
    params = [torch.as_tensor(p, dtype=dtype, device=dev) for p in (
        0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
        0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))]
    return params, float((2 * np.pi) ** (D / 2))


@pytest.mark.cuda
def test_cuda_gram_bwd_input_half_matches_plain_twin():
    """K-gram-bwd's input half (dx1, dx2) and its parameter half against the
    plain twin on the card, float32: inducing-point-like rows (channel-sorted,
    ragged) against unsorted columns, the same permuted, x1 is x2 through
    MosmGram's autograd (dx1 + dx2), and the generic instance (Q = 5,
    D = 3). Tolerance: no more than 2x the float32 twin's error against a
    float64 twin on the same inputs, plus 1e-5 relative (summation order).
    A repeated call is bit-identical (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    rng = np.random.RandomState(4)
    O = 3
    for Q, D, layout in ((2, 1, "sorted"), (2, 1, "permuted"), (2, 2, "square"),
                         (5, 3, "sorted")):
        counts = (40, 33, 50)
        M = sum(counts)
        x1 = torch.as_tensor(np.sort(rng.rand(M, D) * 20, axis=0), dtype=torch.float32,
                             device=dev)
        c1 = tbm.channel_ids(counts, dev)
        if layout == "permuted":
            perm = torch.as_tensor(rng.permutation(M), device=dev)
            x1, c1 = x1[perm].contiguous(), c1[perm].contiguous()
        if layout == "square":
            x2, c2 = x1, c1
        else:
            x2 = torch.as_tensor(rng.rand(700, D) * 20, dtype=torch.float32, device=dev)
            c2 = torch.as_tensor(rng.randint(0, O, 700), dtype=torch.int32, device=dev)
        params, twopi = _mosm_case(rng, O, Q, D, dev)
        st3, st2 = tbm.mosm_pair_stats(*params, twopi)
        g = torch.as_tensor(rng.randn(x1.shape[0], x2.shape[0]), dtype=torch.float32, device=dev)
        launches = (tmg.mosm_gram_bwd.launches, tmg.mosm_gram_bwd.input_launches)
        got = tmg.mosm_gram_bwd(x1, c1, x2, c2, st3, st2, g, inputs=3)
        again = tmg.mosm_gram_bwd(x1, c1, x2, c2, st3, st2, g, inputs=3)
        assert (tmg.mosm_gram_bwd.launches, tmg.mosm_gram_bwd.input_launches) == (
            launches[0], launches[1] + 2)
        twin = tmg.mosm_gram_bwd_plain(x1, c1, x2, c2, st3, st2, g, inputs=3)
        ref = tmg.mosm_gram_bwd_plain(x1.double(), c1, x2.double(), c2, st3.double(),
                                      st2.double(), g.double(), inputs=3)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        for k, name in enumerate(("dst3", "dst2", "dx1", "dx2")):
            assert _rel_err(got[k:k + 1], ref[k:k + 1]) <= \
                2 * _rel_err(twin[k:k + 1], ref[k:k + 1]) + 1e-5, (layout, name)
        if layout == "square":
            xs = x1.clone().requires_grad_()
            K = tmg.mosm_gram(xs, c1, xs, c1, st3, st2)
            (dx,) = torch.autograd.grad(torch.sum(K * g), xs)
            torch.testing.assert_close(dx, got[2] + got[3], rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_kernels_take_every_shape_and_float64():
    """The repairs on the card: K-lowrank-vjp at R = 65 and 129 (two and
    three chunks) and in its generic instance (Q = 5, D = 3), against a
    float64 twin as above; K-gram and K-matvec in their generic instance
    for O = 20, Q = 4, D = 2 (a 51 KB pair table, read from global memory)
    and for D = 9, against their plain twins (2e-4·max|K|, K-matvec with
    the float32 summation bound of N terms added); and a float64 MOSM Exact
    model on the card (the plain twins, no launch) against the same model on
    the CPU, rtol 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from mogptk_tpu_torch import gpr
    dev = torch.device("cuda")
    rng = np.random.RandomState(6)
    counts = (300, 1, 257)
    n = sum(counts)
    for Q, D, R in ((2, 1, 65), (2, 1, 129), (5, 3, 17)):
        x = torch.as_tensor(np.sort(rng.rand(n, D) * 20, axis=0), dtype=torch.float32, device=dev)
        params, twopi = _mosm_case(rng, 3, Q, D, dev)
        st3, st2 = tbm.mosm_pair_stats(*params, twopi)
        A = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=dev)
        B = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=dev)
        got = tbm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, A, B)
        again = tbm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, A, B)
        twin = tbm.mosm_lowrank_vjp_plain(x, counts, st3, st2, A, B)
        ref = tbm.mosm_lowrank_vjp_plain(x.double(), counts, st3.double(), st2.double(),
                                         A.double(), B.double())
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        p64 = [p.double() for p in params]
        assert _rel_err(tbm.pair_stats_vjp(params, twopi, *got),
                        tbm.pair_stats_vjp(p64, twopi, *ref)) <= 2 * _rel_err(
            tbm.pair_stats_vjp(params, twopi, *twin), tbm.pair_stats_vjp(p64, twopi, *ref)) + 1e-5
    for O, Q, D in ((20, 4, 2), (2, 1, 9)):
        assert tmg.kernel_instance("forward", O, Q, D) == "generic"
        N = 2000
        x = torch.as_tensor(rng.rand(N, D) * 10, dtype=torch.float32, device=dev)
        c = torch.as_tensor(rng.randint(0, O, N), dtype=torch.int32, device=dev)
        params, twopi = _mosm_case(rng, O, Q, D, dev)
        st3, st2 = tbm.mosm_pair_stats(*params, twopi)
        K = tmg.mosm_gram(x, c, x[:700], c[:700], st3, st2)
        Kp = tmg.mosm_gram_pairstats_plain(x, c, x[:700], c[:700], st3, st2)
        V = torch.as_tensor(rng.randn(N, 33), dtype=torch.float32, device=dev)
        KV = tmv.mosm_matvec(x, c, st3, st2, V)
        KVp = tmv.mosm_matvec_plain(x, c, st3, st2, V)
        torch.cuda.synchronize()
        kmax = float(Kp.abs().max())
        assert float((K - Kp).abs().max()) <= 2e-4 * kmax, (O, Q, D)
        tol = (2e-4 + N * 2.0 ** -24) * kmax * V.abs().sum(dim=0)
        assert bool(((KV - KVp).abs() <= tol).all()), (O, Q, D)

    saved = gpr.config._dtype
    gpr.use_double_precision()
    try:
        xs = [np.sort(rng.rand(300, 1) * 20, axis=0) for _ in range(3)]
        ys = [np.sin(x) + 0.1 * rng.randn(300, 1) for x in xs]
        out = []
        for device in ("cpu", "cuda"):
            _, X, Y = gpr.merge_data(xs, ys, device=device)
            m = gpr.Exact(gpr.MultiOutputSpectralMixtureKernel(2, output_dims=3), X, Y,
                          variance=0.1, device=device)
            before = (tmg.mosm_gram.launches, tmg.mosm_gram_bwd.launches)
            loss = m.loss()
            loss.backward()
            mu, var = m.predict_f(X[::7])
            assert (tmg.mosm_gram.launches, tmg.mosm_gram_bwd.launches) == before
            out.append([loss.detach(), mu, var] + [r.grad for r in m.trainable_raws()])
        for a, b in zip(*out):
            torch.testing.assert_close(b.cpu(), a, rtol=1e-9, atol=1e-12 * float(a.abs().max()))
    finally:
        gpr.config._dtype = saved


@pytest.mark.cuda
def test_cuda_gram_matvec_and_lowrank_vjp_match_plain_twins():
    """K-gram-matvec and K-gram-lowrank-vjp on the card, float32, through
    ops/pallas_mosm.py's entry points: a small square shape (N = M = 256,
    two channels, shuffled, phase inside), ragged ones (N = 301 and 300
    against M = 77, three shuffled channels, both phase forms) and the
    shapes whose column axis K-gram-matvec splits (N = 1,024 and 4,096
    against M = 16,384, four shuffled channels), matvec at R = 1, 33 and
    200 (two chunks of 128 columns), low-rank at R = 5 and 70 (two chunks).
    K-gram-matvec per entry within (2e-4 + M·2⁻²⁴)·max|K|·‖V[:, r]‖₁ of its
    twin (K-gram's bound carried through the sum, plus the float32
    summation bound of M terms); the five parameter cotangents no further
    from a float64 twin than twice the float32 twin, plus 1e-5 relative.
    Repeats are bit-identical; each call is one launch, and one launch of
    K-gram-matvec's second pass where its plan splits the columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from mogptk_tpu_torch.ops import pallas_mosm as tpm
    dev = torch.device("cuda")
    rng = np.random.RandomState(8)
    for O, N, M, phase_inside in ((2, 256, 256, True), (3, 301, 77, False), (3, 300, 77, True),
                                  (4, 1024, 16384, False), (4, 4096, 16384, True)):
        Q, D = 2, 1
        x1 = torch.as_tensor(rng.rand(N, D) * 20, dtype=torch.float32, device=dev)
        x2 = x1 if N == M else torch.as_tensor(rng.rand(M, D) * 20, dtype=torch.float32,
                                               device=dev)
        c1 = torch.as_tensor(rng.permutation(np.arange(N) % O), dtype=torch.int32, device=dev)
        c2 = c1 if N == M else torch.as_tensor(rng.permutation(np.arange(M) % O),
                                               dtype=torch.int32, device=dev)
        params, twopi = _mosm_case(rng, O, Q, D, dev)
        p64 = [p.double() for p in params]
        with torch.no_grad():
            st3, st2 = tpm.pair_stats(*params, twopi, phase_inside)
        kmax = float(max(tmg.mosm_gram_pairstats_plain(x1[r0:r0 + 2048], c1[r0:r0 + 2048], x2,
                                                       c2, st3, st2).abs().max()
                         for r0 in range(0, N, 2048)))
        for R in (1, 33, 200):
            V = torch.as_tensor(rng.randn(M, R), dtype=torch.float32, device=dev)
            launches = (tmv.mosm_gram_matvec_pairstats.launches,
                        tmv.mosm_gram_matvec_reduce.launches)
            got = tpm.mosm_gram_matvec(x1, c1, x2, c2, *params, twopi, phase_inside, V)
            again = tpm.mosm_gram_matvec(x1, c1, x2, c2, *params, twopi, phase_inside, V)
            _, splits, _ = tmv.gram_matvec_plan(N, M, R, tmv.sm_count(dev))
            assert (tmv.mosm_gram_matvec_pairstats.launches,
                    tmv.mosm_gram_matvec_reduce.launches) == (launches[0] + 2,
                                                              launches[1] + 2 * (splits > 1))
            twin = tmv.mosm_gram_matvec_plain(x1, c1, x2, c2, st3, st2, V)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            tol = (2e-4 + M * 2.0 ** -24) * kmax * V.abs().sum(dim=0)
            assert bool(((got - twin).abs() <= tol).all()), (N, M, R)
        for R in (5, 70):
            A = torch.as_tensor(rng.randn(N, R), dtype=torch.float32, device=dev)
            B = torch.as_tensor(rng.randn(M, R), dtype=torch.float32, device=dev)
            launches = tbm.mosm_gram_lowrank_vjp_pairstats.launches
            got = tpm.mosm_gram_lowrank_vjp(x1, c1, x2, c2, *params, twopi, phase_inside, A, B)
            again = tpm.mosm_gram_lowrank_vjp(x1, c1, x2, c2, *params, twopi, phase_inside, A, B)
            assert tbm.mosm_gram_lowrank_vjp_pairstats.launches == launches + 2
            ref = tpm.mosm_gram_lowrank_vjp(x1.double(), c1, x2.double(), c2, *p64, twopi,
                                            phase_inside, A.double(), B.double())
            # the float32 twin: the kernel's plain twin on the same tensors
            with torch.no_grad():
                twin = tpm.stats_vjp(params, twopi, phase_inside, *tbm.mosm_gram_lowrank_vjp_plain(
                    x1, c1, x2, c2, st3, st2, A, B))
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            ref = [r.cpu() for r in ref]
            assert _rel_err([g.cpu() for g in got], ref) <= \
                2 * _rel_err([t.cpu() for t in twin], ref) + 1e-5, (N, M, R)


@pytest.mark.cuda
def test_cuda_family_kernels_match_plain_twins():
    """K-fam-gram, K-fam-gram-bwd, K-fam-matvec and K-fam-lowrank-vjp for
    every block family, unrolled (D = 1, 2 with 1 or 2 components) and
    generic (D = 3 with 3 components) instances, on 300 points in 3
    channels (counts 150, 1, 149, padded to 256-row tiles; the Gram on
    random channel IDs), float32, against their plain twins. K-fam-gram
    2e-4·max|K|, its square launch (x1 is x2 and c1 is c2: the lower tiles
    mirrored) also at n = 300 and 557 (partial tiles, rows not 16-byte
    aligned) on sorted and on random channels, each bitwise symmetric and
    bit-identical on a repeat; K-fam-matvec (the fold, at R = 33 on sorted channels and
    R = 1, 17 on random ones, each repeat bit-identical) with the float32
    summation bound of N terms added; the two backward kernels through the
    pack to the parameters, at most twice the float32 twin's distance from
    the float64 twin plus 1e-5 relative: K-fam-gram-bwd on sorted and on
    random channels, K-fam-lowrank-vjp at R = 1, 17, 33, 65 and 130 (more
    than one chunk of its tensor-core product); each backward repeated
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from mogptk_tpu_torch.ops import block_families as tbf
    dev = torch.device("cuda")
    rng = np.random.RandomState(8)
    counts = (150, 1, 149)
    n = sum(counts)
    c = tbm.channel_ids(counts, dev)
    cr = torch.as_tensor(rng.randint(0, 3, n), dtype=torch.int32, device=dev)
    rsq = np.random.RandomState(18)   # the square launches' points and channels
    squares = {D: [(torch.as_tensor(np.sort(rsq.rand(m, D) * 10, axis=0), dtype=torch.float32,
                                    device=dev), cs)
                   for m, sorted_counts in ((300, counts), (557, (300, 7, 250)))
                   for cs in (tbm.channel_ids(sorted_counts, dev),
                              torch.as_tensor(rsq.randint(0, 3, m), dtype=torch.int32,
                                              device=dev))]
               for D in (1, 2, 3)}
    for D, A in ((1, 1), (1, 2), (2, 2), (3, 3)):
        x = torch.as_tensor(np.sort(rng.rand(n, D) * 10, axis=0), dtype=torch.float32, device=dev)
        for k in _family_kernels(rng, D, A, dev):
            family = k.family
            raws = k.trainable_raws()
            pack = tbf.family_pack(family, k._fused_params())
            p = pack.detach()
            K = tbf.family_gram(family, x, cr, x[:200], c[:200], p)
            Kp = tbf.family_gram_plain(family, x, cr, x[:200], c[:200], p)
            kmax = float(Kp.abs().max())
            assert float((K - Kp).abs().max()) <= 2e-4 * kmax, (family, D, A)
            for xs, cs in squares[D]:
                Ks = tbf.family_gram(family, xs, cs, xs, cs, p)
                Kt = tbf.family_gram_plain(family, xs, cs, xs, cs, p)
                assert torch.equal(Ks, Ks.T), (family, D, A, xs.shape[0])
                assert torch.equal(Ks, tbf.family_gram(family, xs, cs, xs, cs, p))
                assert float((Ks - Kt).abs().max()) <= 2e-4 * float(Kt.abs().max()), \
                    (family, D, A, xs.shape[0])
            for cc, R in ((c, 33), (cr, 1), (cr, 17)):   # the fold, sorted and on random channels
                V = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=dev)
                KV = tbf.family_matvec(family, x, cc, p, V)
                assert torch.equal(KV, tbf.family_matvec(family, x, cc, p, V)), (family, D, A, R)
                KVp = tbf.family_matvec_plain(family, x, cc, p, V)
                tol = (2e-4 + n * 2.0 ** -24) * kmax * V.abs().sum(dim=0)
                assert bool(((KV - KVp).abs() <= tol).all()), (family, D, A, R)

            G = torch.as_tensor(rng.randn(n, n), dtype=torch.float32, device=dev)
            p64 = p.double()
            runs = {}
            for how, cc, cts in (("sorted", c, counts), ("permuted", cr, None)):
                runs["gram_bwd " + how] = (
                    lambda cc=cc, cts=cts: tbf.family_gram_bwd(family, x, cc, x, cc, p, G, cts, cts),
                    lambda cc=cc: tbf.family_gram_bwd_plain(family, x, cc, x, cc, p, G),
                    lambda cc=cc: tbf.family_gram_bwd_plain(family, x.double(), cc, x.double(),
                                                            cc, p64, G.double()))
            for R in (1, 17, 33, 65, 130):   # 130: three chunks of the product's k
                Am = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=dev)
                Bm = torch.as_tensor(rng.randn(n, R), dtype=torch.float32, device=dev)
                runs["lowrank R=%d" % R] = (
                    lambda Am=Am, Bm=Bm: tbf.family_lowrank_vjp_sorted(family, x, counts, p, Am,
                                                                       Bm),
                    lambda Am=Am, Bm=Bm: tbf.family_lowrank_vjp_plain(family, x, counts, p, Am,
                                                                      Bm),
                    lambda Am=Am, Bm=Bm: tbf.family_lowrank_vjp_plain(
                        family, x.double(), counts, p64, Am.double(), Bm.double()))
            for what, (kernel, twin, ref) in runs.items():
                got, again = kernel(), kernel()
                torch.cuda.synchronize()
                assert torch.equal(got, again), (what, family, D, A)
                chain = lambda d: [g.double() for g in torch.autograd.grad(
                    pack, raws, d.to(pack.dtype), retain_graph=True)]
                r = chain(ref())
                assert _rel_err(chain(got), r) <= 2 * _rel_err(chain(twin()), r) + 1e-5, \
                    (what, family, D, A)


@pytest.mark.cuda
def test_cuda_fused_kernels_match_plain_twins():
    """K-sdiag, K-below-trsm, K-commit and K-syrk against their plain twins
    on the card, float32, small shapes; K-sdiag and K-below-trsm at columns
    where K-below-trsm splits k and where it does not, K-below-trsm also
    with a range scale (bit-identical to the unscaled call); K-commit alone
    and inside K-below-trsm's launch, with and without a range scale. Tolerances: K-sdiag and
    K-below-trsm's S 2·(k+1)·2⁻²⁴·(|C||C|ᵀ + |K|), the summation-order
    bound of two float32 sums of length k, carried through invᵀ with
    2·B·2⁻²⁴·|S||inv|ᵀ more; K-commit exact (a copy); K-syrk
    2·(n+1)·2⁻²⁴·‖W_a‖‖W_b‖ (Cauchy-Schwarz on |W|ᵀ|W|). Then the fused
    factor against the unfused one on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from mogptk_tpu_torch.ops import blocked_trisolve as tbt
    dev = torch.device("cuda")
    u = 2.0 ** -24
    rng = np.random.RandomState(2)
    n = 5632
    L = torch.as_tensor(rng.randn(n, n) / 8, dtype=torch.float32, device=dev)
    # at n = 5,632 these columns run K-below-trsm with k in one chunk (j = 1)
    # and in 3 to 16 chunks (below_trsm_plan) for B = 256 and for B = 512
    for B, js in ((256, (1, 11, 15, 19)), (512, (1, 5, 7, 9))):
        for j in js:
            r0 = j * B
            C = L[r0:r0 + B, :r0]
            tolS = 2 * (r0 + 1) * u * (C.abs() @ C.abs().T + L[r0:r0 + B, r0:r0 + B].abs())
            assert bool(((tbc.s_diag(L, j, B) - tbc.s_diag_plain(L, j, B)).abs() <= tolS).all())

            Ljj = torch.tril(torch.rand(B, B, device=dev)) / B + torch.eye(B, device=dev)
            inv = torch.linalg.solve_triangular(Ljj, torch.eye(B, device=dev),
                                                upper=False).contiguous()
            L1, L2 = L.clone(), L.clone()
            tbc.below_trsm(L1, inv, j, B)
            tbc.below_trsm_plain(L2, inv, j, B)
            A = L[r0 + B:, :r0].abs()
            S = L[r0 + B:, r0:r0 + B] - L[r0 + B:, :r0] @ C.T
            tol = (2 * (r0 + 1) * u * (A @ C.abs().T + L[r0 + B:, r0:r0 + B].abs())) @ inv.abs().T \
                + 2 * (B + 1) * u * (S.abs() @ inv.abs().T)
            assert bool(((L1 - L2)[r0 + B:, r0:r0 + B].abs() <= tol + 1e-7).all()), (B, j)
            # with a range scale [s, r, 1/r] of exact powers of two and the
            # inverse of s·K's panel (inv·2^50), the same rows bit for bit
            Ls = L.clone()
            tbc.below_trsm(Ls, inv * 2.0 ** 50, j, B,
                           torch.tensor([2.0 ** -100, 2.0 ** -50, 2.0 ** 50], device=dev))
            assert torch.equal(Ls, L1), (B, j)
            L1[r0 + B:, r0:r0 + B] = L2[r0 + B:, r0:r0 + B]
            assert torch.equal(L1, L2)                     # nothing else written
            del L1, L2, Ls

    # K-commit, exact: alone, and inside K-below-trsm's TRSM launch, with
    # and without a range scale
    sc = torch.tensor([2.0 ** -100, 2.0 ** -50, 2.0 ** 50], device=dev)
    for zero_upper in (True, False):
        for scale in (None, sc):
            L1, L2 = L.clone(), L.clone()
            tbc.col_commit(L1, Ljj, j, B, zero_upper, scale)
            tbc.col_commit_plain(L2, Ljj, j, B, zero_upper, scale)
            assert torch.equal(L1, L2), (zero_upper, scale)
            jb = j - 1   # a column with rows below
            L1, L2 = L.clone(), L.clone()
            tbc.below_trsm(L1, inv, jb, B, scale, Ljj, zero_upper)
            tbc.below_trsm(L2, inv, jb, B, scale)
            tbc.col_commit_plain(L2, Ljj, jb, B, zero_upper, scale)
            assert torch.equal(L1, L2), (zero_upper, scale)

    W = torch.tril(torch.as_tensor(rng.randn(512, 512), dtype=torch.float32, device=dev))
    nrm = torch.linalg.vector_norm(W, dim=0)
    got, ref = tbt.syrk_lower(W, 256), tbt.syrk_lower_plain(W, 256)
    for i in range(2):
        for jj in range(i + 1):
            blk = (slice(i * 256, (i + 1) * 256), slice(jj * 256, (jj + 1) * 256))
            tol = 2 * 513 * u * torch.outer(nrm[blk[0]], nrm[blk[1]])
            assert bool(((got[blk] - ref[blk]).abs() <= tol).all())

    n = 1280
    A = rng.randn(n, n) / np.sqrt(n)
    K = torch.as_tensor(A @ A.T + 3.0 * np.eye(n), dtype=torch.float32, device=dev)
    L0 = tbc.blocked_cholesky(K.clone(), block_size=256)
    Lf = tbc.blocked_cholesky(K.clone(), block_size=256, fused_trsm=True)
    torch.cuda.synchronize()
    assert float((Lf - L0).abs().max()) <= 1e-4
