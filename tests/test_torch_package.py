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
            "import mogptk_tpu_torch.models.mohsm, mogptk_tpu_torch.ops.pallas_mosm\n"
            "bad = [m for m in ('jax', 'pandas', 'matplotlib') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_kernel_sources_and_nvcc_command():
    names = sorted(os.path.basename(p) for p in _build.sources())
    assert names == ["blocked_cholesky.cu", "family_gram.cu", "family_gram_bwd.cu",
                     "family_lowrank_vjp.cu", "family_matvec.cu", "fused_cho_solve.cu",
                     "fused_trsm.cu", "mosm_gram.cu", "mosm_gram_bwd.cu",
                     "mosm_gram_bwd_inputs.cu", "mosm_gram_lowrank_vjp.cu", "mosm_lowrank_vjp.cu",
                     "mosm_matvec.cu", "syrk_lower.cu"]
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


def test_lowrank_kpad_covers_every_column(monkeypatch):
    """K-lowrank-vjp's and K-fam-lowrank-vjp's k plan (lowrank_plan): R in
    chunks of lowrank_chunk(R) columns, each half of the tensor-core
    product's k padded to lowrank_kpad(chunk), a multiple of 8 that holds
    every chunk, the last (shorter) one included; the chunks cover each
    column of A and B once. Both wrappers pass that plan to their C entries
    with the entries' argument counts (a stand-in library records the calls;
    the meta device stands in for the card)."""
    from mogptk_tpu_torch.ops import block_families as tbf
    for R in (1, 7, 8, 17, 33, 64, 65, 129, 130, 1025):
        rc = tbm.lowrank_chunk(R)
        kh = tbm.lowrank_kpad(rc)
        assert tbm.lowrank_plan(R) == (rc, kh)
        assert kh % 8 == 0 and rc <= kh < rc + 8 and kh <= 64
        cols = [r0 + k for r0 in range(0, R, rc) for k in range(min(rc, R - r0))]
        assert cols == list(range(R)), R

    calls = {}

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.setdefault(name, []).append(args) or 0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "require_cuda_inputs", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    meta = torch.device("meta")
    counts, O, Q, D = (300, 260), 2, 2, 1
    x = torch.empty((sum(counts), D), device=meta)
    st3, st2 = torch.empty((O, O, Q, D, 3), device=meta), torch.empty((O, O, Q, 2), device=meta)
    csm = ("csm", (2,))
    pack = torch.empty((O, O, 2 * D + 4), device=meta)
    for R in (1, 17, 33, 65, 130):
        A = torch.empty((sum(counts), R), device=meta)
        tbm.mosm_lowrank_vjp_sorted(x, counts, st3, st2, A, A)
        tbf.family_lowrank_vjp_sorted(csm, x, counts, pack, A, A)
        mosm, fam = calls["mosm_lowrank_vjp_f32"][-1], calls["family_lowrank_vjp_f32"][-1]
        assert len(mosm) == len(_build.SIGNATURES["mosm_lowrank_vjp_f32"])
        assert len(fam) == len(_build.SIGNATURES["family_lowrank_vjp_f32"])
        assert mosm[12:15] == (R,) + tbm.lowrank_plan(R)   # R, RC, KH
        assert fam[10:13] == (R,) + tbm.lowrank_plan(R)


def test_square_gram_and_commit_reach_their_entries(monkeypatch):
    """The launches the card takes, recorded by a stand-in library on the
    meta device: K-fam-gram's square entry (the lower tiles mirrored) where
    x1 and x2 are one tensor and so are c1 and c2, also through FamilyGram,
    which detaches them; the cross entry for a copy of x or other channel
    IDs. K-below-trsm given Ljj carries it, zero_upper and the range scale to
    the one launch that commits (counted on below_trsm.commits), without it
    a null Ljj; K-commit carries the scale. Each call with its entry's
    argument count."""
    from mogptk_tpu_torch.ops import block_families as tbf
    calls = []

    class Library:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_build, "require_cuda_inputs", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: 0)
    meta = torch.device("meta")
    csm, O, D = ("csm", (2,)), 3, 1
    x = torch.empty((300, D), device=meta)
    c = torch.empty((300,), dtype=torch.int32, device=meta)
    pack = torch.empty((O, O, 2 * D + 4), device=meta)
    tbf.family_gram(csm, x, c, x, c, pack)
    tbf.FamilyGram.apply(csm, x, c, x, c, pack.requires_grad_(), None, None)
    tbf.family_gram(csm, x, c, x[:200], c[:200], pack.detach())
    assert [name for name, _ in calls] == ["family_gram_square_f32"] * 2 + ["family_gram_f32"]
    for name, args in calls:
        assert len(args) == len(_build.SIGNATURES[name]), name
    n, B = 1024, 256
    L = torch.empty((n, n), device=meta)
    M = torch.empty((B, B), device=meta)
    scale = torch.empty((3,), device=meta)
    del calls[:]
    commits = tbc.below_trsm.commits
    tbc.below_trsm(L, M, 1, B, scale, M, False)
    tbc.below_trsm(L, M, 2, B)
    tbc.col_commit(L, M, 3, B, True, scale)
    assert [name for name, _ in calls] == ["below_trsm_f32"] * 2 + ["col_commit_f32"]
    for name, args in calls:
        assert len(args) == len(_build.SIGNATURES[name]), name
    (_, fused), (_, alone), (_, last) = calls
    assert fused[4] is not None and fused[9:11] == (0, scale.data_ptr())   # Ljj, zero_upper, scale
    assert alone[4] is None and alone[10] is None
    assert last[5:7] == (1, scale.data_ptr())
    assert tbc.below_trsm.commits == commits + 1


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


def test_gram_matvec_and_lowrank_vjp_route_by_device_and_dtype():
    """K-gram-matvec and K-gram-lowrank-vjp follow the one dtype route:
    float64 runs the plain twin on the tensor's own device (the meta device
    stands in for the card) and counts no launch; float32 off the CPU goes
    to the kernel, which needs a CUDA tensor and raises."""
    meta = torch.device("meta")
    O, Q, D, N, M = 2, 2, 1, 6, 4
    c1 = torch.zeros(N, dtype=torch.int32, device=meta)
    c2 = torch.zeros(M, dtype=torch.int32, device=meta)
    for dtype in (torch.float64, torch.float32):
        x1 = torch.empty((N, D), dtype=dtype, device=meta)
        x2 = torch.empty((M, D), dtype=dtype, device=meta)
        st3 = torch.empty((O, O, Q, D, 3), dtype=dtype, device=meta)
        st2 = torch.empty((O, O, Q, 2), dtype=dtype, device=meta)
        V, A = torch.empty((M, 3), dtype=dtype, device=meta), torch.empty((N, 3), dtype=dtype,
                                                                          device=meta)
        before = (tmv.mosm_gram_matvec_pairstats.launches,
                  tbm.mosm_gram_lowrank_vjp_pairstats.launches)
        calls = [lambda: (tmv.mosm_gram_matvec_pairstats(x1, c1, x2, c2, st3, st2, V),),
                 lambda: tbm.mosm_gram_lowrank_vjp_pairstats(x1, c1, x2, c2, st3, st2, A, V)]
        for call in calls:
            if dtype == torch.float64:
                assert all(t.device == meta for t in call())
            else:
                with pytest.raises(ValueError, match="must be on"):
                    call()
        assert (tmv.mosm_gram_matvec_pairstats.launches,
                tbm.mosm_gram_lowrank_vjp_pairstats.launches) == before


@pytest.mark.parametrize("N", [557, 16384], ids=["ragged", "bench"])
def test_matvec_fold_plan_covers_each_tile_pair_once(N):
    """K-matvec's work plan: every tile pair (a, b) of the N × N tile grid
    is covered exactly once, as a row contribution (item (a, J) evaluating
    tile b ≥ a) or a column one (the transposed product of tile (b, a),
    b < a); every slab slot is written exactly once and lies in its row
    tile's range; the items off the diagonal super-block come first. On the ragged N the fold's
    plain twins (first pass and fixed-order second pass) give the plain
    matvec in float64, channels permuted: K-matvec's and K-fam-matvec's for
    each of the five block families (D = 1 and 2)."""
    ntiles, nsupers = tmv.fold_tiles(N)
    total = tmv.fold_slab_base(ntiles, nsupers)
    bases = [tmv.fold_slab_base(t, nsupers) for t in range(ntiles + 1)]
    assert all(bases[t + 1] - bases[t] == tmv.fold_slot_count(t, nsupers) for t in range(ntiles))
    seen = np.zeros((ntiles, ntiles), dtype=int)
    written = np.zeros(total, dtype=int)
    items = tmv.fold_items(N)
    assert all(len(tmv.fold_item_tiles(i, J, ntiles)) >= 1 for i, J in items)
    assert all(J > i // 4 for i, J in items[:-ntiles]) and all(J == i // 4 for i, J in items[-ntiles:])
    for i, J in items.tolist():
        slot = tmv.fold_row_slot(i, J, nsupers)
        assert bases[i] <= slot < bases[i + 1]
        written[slot] += 1
        for j in tmv.fold_item_tiles(i, J, ntiles):
            seen[i, j] += 1
            if j != i:
                seen[j, i] += 1
                slot = tmv.fold_col_slot(j, i, nsupers)
                assert bases[j] <= slot < bases[j + 1]
                written[slot] += 1
    assert (seen == 1).all() and (written == 1).all()
    if N < 1000:
        rng = np.random.RandomState(7)
        O, Q, D = 3, 2, 1
        x = torch.as_tensor(rng.rand(N, D) * 20)
        c = torch.as_tensor(rng.randint(0, O, N), dtype=torch.int32)
        params = [torch.as_tensor(p) for p in (
            0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
            0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))]
        st3, st2 = tbm.mosm_pair_stats(*params, float(np.sqrt(2 * np.pi)))
        V = torch.as_tensor(rng.randn(N, 5))
        got = tmv.mosm_matvec_reduce_plain(tmv.fold_partials_plain(x, c, st3, st2, V), N)
        torch.testing.assert_close(got, tmv.mosm_matvec_plain(x, c, st3, st2, V), rtol=1e-12,
                                   atol=1e-12)
        # K-fam-matvec's fold, the same plan and slabs, for each block family
        from mogptk_tpu_torch.ops import block_families as tbf
        for D, A in ((1, 2), (2, 1)):
            x = torch.as_tensor(rng.rand(N, D) * 5)
            for k in _family_kernels(rng, D, A, "cpu"):
                pack = tbf.family_pack(k.family, [p.detach().double() for p in k._fused_params()])
                got = tmv.mosm_matvec_reduce_plain(
                    tbf.family_fold_partials_plain(k.family, x, c, pack, V), N)
                torch.testing.assert_close(got, tbf.family_matvec_plain(k.family, x, c, pack, V),
                                           rtol=1e-12, atol=1e-12)


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
