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
from mogptk_tpu_torch.ops import mosm_matvec as tmv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small shapes: one torch thread (the suite runs files in parallel
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_import_pulls_in_no_jax_pandas_matplotlib():
    code = ("import sys, mogptk_tpu_torch\n"
            "import mogptk_tpu_torch.gpr.training, mogptk_tpu_torch.ops.linalg\n"
            "import mogptk_tpu_torch.ops.fused_solve, mogptk_tpu_torch.ops.blocked_trisolve\n"
            "import mogptk_tpu_torch.ops.block_mosm, mogptk_tpu_torch.ops.blocked_cholesky\n"
            "import mogptk_tpu_torch.model, mogptk_tpu_torch.models.mosm, mogptk_tpu_torch.init\n"
            "import mogptk_tpu_torch.gpr.iterative, mogptk_tpu_torch.ops.iterative\n"
            "import mogptk_tpu_torch.ops.mosm_matvec, mogptk_tpu_torch.gpr.model\n"
            "import mogptk_tpu_torch.ops.block_families, mogptk_tpu_torch.gpr.multioutput\n"
            "import mogptk_tpu_torch.gpr.kernel, mogptk_tpu_torch.models.csm\n"
            "import mogptk_tpu_torch.models.sm_lmc, mogptk_tpu_torch.models.conv\n"
            "import mogptk_tpu_torch.models.mohsm\n"
            "bad = [m for m in ('jax', 'pandas', 'matplotlib') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_kernel_sources_and_nvcc_command():
    names = sorted(os.path.basename(p) for p in _build.sources())
    assert names == ["blocked_cholesky.cu", "family_gram.cu", "family_gram_bwd.cu",
                     "family_lowrank_vjp.cu", "family_matvec.cu", "fused_cho_solve.cu",
                     "fused_trsm.cu", "mosm_gram.cu", "mosm_gram_bwd.cu",
                     "mosm_gram_bwd_inputs.cu", "mosm_lowrank_vjp.cu", "mosm_matvec.cu",
                     "syrk_lower.cu"]
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


def test_lowrank_vjp_takes_any_rank_in_chunks():
    """K-lowrank-vjp stages at most 64 columns of A and B at a time and
    accumulates the cotangent tile over the chunks inside the block: the
    chunk for rank R is min(R, 64), so R = probes + 1 >= 65 runs in
    ceil(R / 64) chunks where the kernel once refused it."""
    assert [tbm.lowrank_chunk(R) for R in (1, 17, 64, 65, 129, 1025)] == [1, 17, 64, 64, 64, 64]
    with pytest.raises(ValueError):
        tbm.lowrank_chunk(0)


def test_float64_routes_to_the_plain_twins_on_any_device():
    """The one dtype route (ops/_build.runs_plain): float64 runs the plain
    twin on the tensor's own device and counts no launch; float32 off the
    CPU goes to the kernel, which needs a CUDA tensor and raises otherwise.
    Shown on the meta device, which stands in for the card here."""
    meta = torch.device("meta")
    assert _build.runs_plain(torch.empty(2, dtype=torch.float64, device=meta))
    assert _build.runs_plain(torch.empty(2, dtype=torch.float32))
    assert not _build.runs_plain(torch.empty(2, dtype=torch.float32, device=meta))
    O, Q, D, n = 2, 2, 1, 6
    c = torch.zeros(n, dtype=torch.int32, device=meta)
    for dtype in (torch.float64, torch.float32):
        x = torch.empty((n, D), dtype=dtype, device=meta)
        st3 = torch.empty((O, O, Q, D, 3), dtype=dtype, device=meta)
        st2 = torch.empty((O, O, Q, 2), dtype=dtype, device=meta)
        V = torch.empty((n, 3), dtype=dtype, device=meta)
        calls = [lambda: tmg.mosm_gram(x, c, x, c, st3, st2),
                 lambda: tmv.mosm_matvec(x, c, st3, st2, V)]
        before = (tmg.mosm_gram.launches, tmv.mosm_matvec.launches)
        for call in calls:
            if dtype == torch.float64:
                assert call().device == meta
            else:
                with pytest.raises(ValueError, match="must be on"):
                    call()
        assert (tmg.mosm_gram.launches, tmv.mosm_matvec.launches) == before


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


def _family_kernels(rng, D, A, dev):
    """One port kernel of each block family at input dims D (CSM with Rq = A
    components, SM-LMC with Q = A), random parameters, on `dev`."""
    from mogptk_tpu_torch import gpr
    O = 3
    ks = [gpr.UncoupledMultiOutputSpectralKernel(O, D), gpr.CrossSpectralKernel(O, D, Rq=A),
          gpr.GaussianConvolutionProcessKernel(O, D),
          gpr.MultiOutputHarmonizableSpectralKernel(O, D, psd_safe=True),
          gpr.LinearModelOfCoregionalizationKernel([gpr.SpectralKernel(D) for _ in range(A)],
                                                   output_dims=O, input_dims=D, Q=A, Rq=2)]
    for k in ks:
        with torch.no_grad():
            for r in k.trainable_raws():
                r.add_(0.3 * torch.as_tensor(rng.randn(*r.shape), dtype=r.dtype))
        k.to(dev)
    return ks


@pytest.mark.cuda
def test_cuda_family_kernels_match_plain_twins():
    """K-fam-gram, K-fam-gram-bwd, K-fam-matvec and K-fam-lowrank-vjp for
    every block family, unrolled (D = 1, 2 with 1 or 2 components) and
    generic (D = 3 with 3 components) instances, on 300 points in 3
    channels (counts 150, 1, 149, padded to 256-row tiles; the Gram on
    random channel IDs), float32, against their plain twins. K-fam-gram
    2e-4·max|K| and K-fam-matvec with the float32 summation bound of N terms
    added; the two backward kernels through the pack to the parameters, at
    most twice the float32 twin's distance from the float64 twin plus 1e-5
    relative; each backward repeated bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from mogptk_tpu_torch.ops import block_families as tbf
    dev = torch.device("cuda")
    rng = np.random.RandomState(8)
    counts = (150, 1, 149)
    n = sum(counts)
    c = tbm.channel_ids(counts, dev)
    cr = torch.as_tensor(rng.randint(0, 3, n), dtype=torch.int32, device=dev)
    for D, A in ((1, 1), (1, 2), (2, 2), (3, 3)):
        x = torch.as_tensor(np.sort(rng.rand(n, D) * 10, axis=0), dtype=torch.float32, device=dev)
        for k in _family_kernels(rng, D, A, dev):
            family = k.family
            raws = k.trainable_raws()
            pack = tbf.family_pack(family, k._fused_params())
            p = pack.detach()
            K = tbf.family_gram(family, x, cr, x[:200], c[:200], p)
            Kp = tbf.family_gram_plain(family, x, cr, x[:200], c[:200], p)
            V = torch.as_tensor(rng.randn(n, 33), dtype=torch.float32, device=dev)
            KV = tbf.family_matvec(family, x, c, p, V)
            KVp = tbf.family_matvec_plain(family, x, c, p, V)
            torch.cuda.synchronize()
            kmax = float(Kp.abs().max())
            assert float((K - Kp).abs().max()) <= 2e-4 * kmax, (family, D, A)
            tol = (2e-4 + n * 2.0 ** -24) * kmax * V.abs().sum(dim=0)
            assert bool(((KV - KVp).abs() <= tol).all()), (family, D, A)

            G = torch.as_tensor(rng.randn(n, n), dtype=torch.float32, device=dev)
            Am = torch.as_tensor(rng.randn(n, 17), dtype=torch.float32, device=dev)
            Bm = torch.as_tensor(rng.randn(n, 17), dtype=torch.float32, device=dev)
            p64 = p.double()
            runs = {
                "gram_bwd": (lambda: tbf.family_gram_bwd(family, x, c, x, c, p, G, counts, counts),
                             lambda: tbf.family_gram_bwd_plain(family, x, c, x, c, p, G),
                             lambda: tbf.family_gram_bwd_plain(family, x.double(), c, x.double(),
                                                               c, p64, G.double())),
                "lowrank": (lambda: tbf.family_lowrank_vjp_sorted(family, x, counts, p, Am, Bm),
                            lambda: tbf.family_lowrank_vjp_plain(family, x, counts, p, Am, Bm),
                            lambda: tbf.family_lowrank_vjp_plain(family, x.double(), counts, p64,
                                                                 Am.double(), Bm.double()))}
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
    on the card, float32, small shapes; K-sdiag and K-below-trsm at the
    columns where each of K-below-trsm's row tiles runs. Tolerances: K-sdiag and
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
    # at n = 5,632 these columns run every K-below-trsm instance: row tile
    # 32, 16, 8 and 4 (by the rows below) for B = 256 and for B = 512
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
            L1[r0 + B:, r0:r0 + B] = L2[r0 + B:, r0:r0 + B]
            assert torch.equal(L1, L2)                     # nothing else written
            del L1, L2

    for zero_upper in (True, False):
        L1, L2 = L.clone(), L.clone()
        tbc.col_commit(L1, Ljj, j, B, zero_upper)
        tbc.col_commit_plain(L2, Ljj, j, B, zero_upper)
        assert torch.equal(L1, L2)

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
