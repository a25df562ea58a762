"""Package boundary of mogptk_tpu_torch: what it imports, what it builds, and
the CUDA kernels against their plain twins where a card is present."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mogptk_tpu_torch.ops import _build
from mogptk_tpu_torch.ops import blocked_cholesky as tbc
from mogptk_tpu_torch.ops import block_mosm as tbm
from mogptk_tpu_torch.ops import mosm_gram as tmg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax_pandas_matplotlib():
    code = ("import sys, mogptk_tpu_torch\n"
            "import mogptk_tpu_torch.gpr.training, mogptk_tpu_torch.ops.linalg\n"
            "import mogptk_tpu_torch.ops.fused_solve, mogptk_tpu_torch.ops.blocked_trisolve\n"
            "import mogptk_tpu_torch.ops.block_mosm, mogptk_tpu_torch.ops.blocked_cholesky\n"
            "import mogptk_tpu_torch.model, mogptk_tpu_torch.models.mosm, mogptk_tpu_torch.init\n"
            "bad = [m for m in ('jax', 'pandas', 'matplotlib') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_kernel_sources_and_nvcc_command():
    names = sorted(os.path.basename(p) for p in _build.sources())
    assert names == ["blocked_cholesky.cu", "fused_cho_solve.cu", "mosm_gram.cu",
                     "mosm_gram_bwd.cu", "mosm_lowrank_vjp.cu"]
    compiles, link = _build.nvcc_commands("/tmp/out.so")
    # one compile per source, all into the one library
    assert [cmd[cmd.index("-c") + 1] for cmd in compiles] == _build.sources()
    for cmd in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "--use_fast_math" not in cmd and "-fPIC" in cmd
    assert link[:4] == ["nvcc", "-shared", "-o", "/tmp/out.so"]
    assert link[4:] == [cmd[cmd.index("-o") + 1] for cmd in compiles]
    # one source hash per set of sources and flags
    assert _build.source_hash() == _build.source_hash()


@pytest.mark.cuda
def test_cuda_kernels_match_plain_twins():
    """Each kernel against its plain twin on the card, float32, small shapes.
    Tolerances: K-gram 2e-4·max|K| (float32 cosines of arguments up to
    ~30 rad here); K-spanel and K-colwrite 2·k·2⁻²⁴·max(|A||B|ᵀ), the
    summation-order bound of two float32 dot products of length k."""
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

    n, B, j = 256, 64, 2
    L = torch.as_tensor(rng.randn(n, n) / 8, dtype=torch.float32, device=dev)
    S, S_ref = torch.empty(n, B, device=dev), torch.empty(n, B, device=dev)
    tbc.s_panel(L, S, j, B)
    tbc.s_panel_plain(L, S_ref, j, B)
    r0 = j * B
    A = L[r0:, :r0].abs()
    bound = 2 * r0 * 2.0 ** -24 * float((A @ A[:B].T).max()) + 1e-6
    assert float((S[:n - r0] - S_ref[:n - r0]).abs().max()) <= bound

    Ljj = torch.tril(torch.rand(B, B, device=dev)) / B + torch.eye(B, device=dev)
    inv = torch.linalg.solve_triangular(Ljj, torch.eye(B, device=dev), upper=False).contiguous()
    for zero_upper in (True, False):
        L1, L2 = L.clone(), L.clone()
        tbc.col_write(L1, S, Ljj, inv, j, B, zero_upper)
        tbc.col_write_plain(L2, S, Ljj, inv, j, B, zero_upper)
        bound = 2 * B * 2.0 ** -24 * float((S[B:n - r0].abs() @ inv.abs().T).max()) + 1e-6
        assert float((L1 - L2).abs().max()) <= bound
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
    plus a floor of 1e-5 relative (summation order alone)."""
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

    n, Bs, r = 1024, 256, 17
    A = torch.as_tensor(rng.randn(n, n) / np.sqrt(n), dtype=torch.float64, device=dev)
    L64 = torch.linalg.cholesky(A @ A.T + 2 * torch.eye(n, dtype=torch.float64, device=dev))
    # the strict upper holds NaN: neither solve may read it
    L = torch.tril(L64).float() + torch.triu(torch.full((n, n), float("nan"), device=dev), 1)
    invs = tbt.panel_inverses(torch.tril(L64).float(), block_size=Bs)
    B = torch.as_tensor(rng.randn(n, r), dtype=torch.float32, device=dev)
    X = tfs.fused_cho_solve(L, invs, B)
    X_twin = tbt.blocked_cho_solve(L, B, invs=invs)
    X64 = torch.cholesky_solve(B.double(), torch.tril(L.nan_to_num(0.0)).double(), upper=False)
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
        got = tbm.pair_stats_vjp(params, twopi, *tbm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, Am, Bm))
        twin = tbm.pair_stats_vjp(params, twopi, *tbm.mosm_lowrank_vjp_plain(x, counts, st3, st2, Am, Bm))
        p64 = [p.double() for p in params]
        st64 = tbm.mosm_pair_stats(*p64, twopi)
        ref = tbm.pair_stats_vjp(p64, twopi, *tbm.mosm_lowrank_vjp_plain(
            x.double(), counts, *st64, Am.double(), Bm.double()))
        torch.cuda.synchronize()
        assert _rel_err(got, ref) <= 2 * _rel_err(twin, ref) + 1e-5


@pytest.mark.cuda
def test_cuda_gram_bwd_matches_plain_twin():
    """K-gram-bwd against its plain twin on the card, float32, small shapes:
    unsorted channel IDs with a cross-Gram (N ≠ M), and channel-sorted data
    with ragged channels and D = 2 (padding on every channel). Tolerance: no
    more than 2x the float32 twin's error against a float64 twin on the same
    inputs, plus a floor of 1e-5 relative (summation order alone). A repeated
    call is bit-identical (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    O, Q = 3, 2
    cases = []
    for D, sorted_counts in ((1, None), (2, (300, 1, 257))):
        if sorted_counts is None:
            N, M = 700, 500
            c1 = torch.as_tensor(rng.randint(0, O, N), dtype=torch.int32, device=dev)
            c2 = torch.as_tensor(rng.randint(0, O, M), dtype=torch.int32, device=dev)
            x1 = torch.as_tensor(rng.rand(N, D) * 20, dtype=torch.float32, device=dev)
            x2 = torch.as_tensor(rng.rand(M, D) * 20, dtype=torch.float32, device=dev)
        else:
            N = M = sum(sorted_counts)
            c1 = c2 = tbm.channel_ids(sorted_counts, dev)
            x1 = x2 = torch.as_tensor(np.sort(rng.rand(N, D) * 20, axis=0), dtype=torch.float32,
                                      device=dev)
        cases.append((D, sorted_counts, x1, c1, x2, c2))
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
        assert _rel_err(got, ref) <= 2 * _rel_err(twin, ref) + 1e-5
        # through autograd: the Gram on the card carries MosmGram's backward
        ps = [p.clone().requires_grad_() for p in params]
        K = tmg.mosm_gram(x1, c1, x2, c2, *tbm.mosm_pair_stats(*ps, twopi), counts, counts)
        assert type(K.grad_fn).__name__ == "MosmGramBackward"
        grads = torch.autograd.grad(torch.sum(K * g), ps)
        for a, b in zip(grads, tbm.pair_stats_vjp(params, twopi, *got)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
