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
            "bad = [m for m in ('jax', 'pandas', 'matplotlib') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_kernel_sources_and_nvcc_command():
    names = sorted(os.path.basename(p) for p in _build.sources())
    assert names == ["blocked_cholesky.cu", "mosm_gram.cu"]
    cmd = _build.nvcc_command("/tmp/out.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "--use_fast_math" not in cmd
    assert cmd[-2:] == _build.sources()
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
