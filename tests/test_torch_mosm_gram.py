"""The port's MOSM Gram (mogptk_tpu_torch/ops/mosm_gram.py, block_mosm.py)
against the JAX package's Pallas Grams, run in interpret mode on the CPU the
way tests/test_block_mosm.py runs them. On CPU tensors the port runs the
K-gram kernel's plain twin. float64; tolerance rtol 1e-7 because XLA-CPU's
exp is only ~1e-8 accurate even in float64."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

import mogptk_tpu.ops.block_mosm as jbm
import mogptk_tpu.ops.pallas_mosm as jpm
from mogptk_tpu.gpr.multioutput import _mosm_K
from mogptk_tpu_torch.ops import block_mosm as tbm
from mogptk_tpu_torch.ops import mosm_gram as tmg

RTOL, ATOL = 1e-7, 1e-12


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jbm.pl, "pallas_call", interp)
    monkeypatch.setattr(jpm.pl, "pallas_call", interp)
    monkeypatch.setattr(jbm, "TILE", 32)
    monkeypatch.setattr(jpm, "TILE", 32)
    yield


def _params(O, Q, D, seed):
    rng = np.random.RandomState(seed)
    return (0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
            0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("counts,Q,D", [
    ((40, 33, 27), 2, 1),
    ((33, 0, 50), 1, 2),    # empty channel + multi-dim inputs
    ((64,), 3, 1),          # single channel
])
def test_sorted_gram_matches_pallas(counts, Q, D):
    O = len(counts)
    rng = np.random.RandomState(0)
    x = np.sort(rng.rand(sum(counts), D) * 5, axis=0)
    params = _params(O, Q, D, 1)
    twopi = float((2 * np.pi) ** (D / 2))
    # jitted: one compile instead of one trace per interpret-mode pallas_call
    ref = jax.jit(lambda x, *p: jbm.mosm_gram_sorted(x, counts, *p, twopi, True))(
        jnp.asarray(x), *map(jnp.asarray, params))
    launches = tmg.mosm_gram.launches
    got = tbm.mosm_gram_sorted(_t(x), counts, *map(_t, params), twopi)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert tmg.mosm_gram.launches == launches


def test_cross_gram_matches_pallas_and_mosm_K():
    """Unsorted random channel IDs, N != M: the generic Pallas Gram (C1)."""
    O, Q, D, N, M = 3, 2, 2, 45, 38
    rng = np.random.RandomState(3)
    x1, x2 = rng.rand(N, D) * 4, rng.rand(M, D) * 4
    c1, c2 = rng.randint(0, O, N), rng.randint(0, O, M)
    params = _params(O, Q, D, 4)
    twopi = float((2 * np.pi) ** (D / 2))
    jp = tuple(map(jnp.asarray, params))
    ref_pallas = jax.jit(lambda *a: jpm.mosm_gram(*a, twopi, True))(
        jnp.asarray(x1), jnp.asarray(c1, jnp.int32), jnp.asarray(x2), jnp.asarray(c2, jnp.int32), *jp)
    ref_dense = _mosm_K(jnp.asarray(c1), jnp.asarray(x1), jnp.asarray(c2), jnp.asarray(x2),
                        jp, twopi, phase_inside_2pi=True)
    st3, st2 = tbm.mosm_pair_stats(*map(_t, params), twopi)
    got = tmg.mosm_gram(_t(x1), torch.as_tensor(c1, dtype=torch.int32), _t(x2),
                        torch.as_tensor(c2, dtype=torch.int32), st3, st2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_pallas), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref_dense), rtol=RTOL, atol=ATOL)


def test_sorted_channel_counts():
    assert tbm.sorted_channel_counts([0, 0, 1, 2, 2], 3) == (2, 1, 2)
    assert tbm.sorted_channel_counts([0, 2, 1], 3) is None
    assert tbm.sorted_channel_counts([0, 3], 3) is None
