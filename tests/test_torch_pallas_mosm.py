"""The port's ops/pallas_mosm.py (the MOSM Gram, its matvec and its low-rank
VJP from the raw parameters, any channel order, x1 ≠ x2) against the JAX
package's ops/pallas_mosm.py, whose Pallas kernels run here in interpret
mode with 64-point tiles; and the one-pair low-rank bodies that no
pallas_call of the JAX package reaches (block_mosm.py `_lowrank_bwd_kernel`,
block_families.py `_lowrank_bwd_kernel`) against the port's one-pair twins;
then torch-only properties of the entry points and plain twins (row-block
edges, autograd, K(x2, x1) = K(x1, x2)ᵀ, empty and permuted point sets).
On CPU tensors the port runs the kernels' plain twins and counts no launch.
float64; rtol 1e-7 because XLA-CPU's exp is only ~1e-8 accurate even in
float64."""
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

import mogptk_tpu.ops.block_families as jbf
import mogptk_tpu.ops.block_mosm as jbm
import mogptk_tpu.ops.pallas_mosm as jpm
from mogptk_tpu_torch.ops import block_families as tbf
from mogptk_tpu_torch.ops import block_mosm as tbm
from mogptk_tpu_torch.ops import mosm_gram as tmg
from mogptk_tpu_torch.ops import mosm_matvec as tmv
from mogptk_tpu_torch.ops import pallas_mosm as tpm

import jax_reference

RTOL, ATOL = 1e-7, 1e-12
O, N, M = 3, 70, 45          # ragged against the 64-point tiles, N ≠ M
TILE = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small shapes: one torch thread (the suite runs files in parallel
    processes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """The JAX module's pallas_calls in interpret mode, its tiles at 64."""
    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jpm.pl, "pallas_call", interp)
    monkeypatch.setattr(jpm, "TILE", TILE)
    monkeypatch.setattr(jpm, "BWD_TILE", TILE)
    yield


def _case(Q, D, seed=0):
    """Shuffled channel IDs (every channel present), inputs and parameters
    from a numpy seed."""
    rng = np.random.RandomState(seed)
    x1, x2 = rng.rand(N, D) * 5, rng.rand(M, D) * 5
    c1 = rng.permutation(np.arange(N) % O).astype(np.int32)
    c2 = rng.permutation(np.arange(M) % O).astype(np.int32)
    params = (0.5 + rng.rand(O, Q), 0.1 + rng.rand(O, Q, D), 0.2 + rng.rand(O, Q, D),
              0.1 * rng.randn(O, Q, D), 0.1 * rng.randn(O, Q))
    return rng, (x1, c1, x2, c2), params, float((2 * np.pi) ** (D / 2))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(ref), rtol=RTOL, atol=ATOL)


_ANSWERS = {}


def _jax_references(tmp_path_factory, request, name, compute):
    """compute() under the interpret fixture, once per run (and once per
    process: several tests read one answer)."""
    if name not in _ANSWERS:
        request.getfixturevalue("interpret_pallas")
        _ANSWERS[name] = jax_reference.once_per_run(tmp_path_factory, name, compute)
    return _ANSWERS[name]


# (Q, D, phase_inside): each (Q, D) and each phase form once. Every JAX
# answer of a group comes from one compile of one function (an
# interpret-mode reference costs ~1 s a compile here).
GROUPS = [(2, 1, True), (2, 2, False)]
# mosm_gram's phase-inside form at arbitrary channel IDs is held to the JAX
# package in test_torch_mosm_gram.py and test_torch_gram_bwd.py
GRAM_GROUP = (2, 2, False)
MATVEC_RS = (1, 5)
VJP_RS = (5, 70)   # 70 crosses K-gram-lowrank-vjp's 64-column chunk


def _group(Q, D):
    """A group's inputs: the points and parameters, V for each matvec R,
    (A, B) for each low-rank R and a dense Gram cotangent g."""
    rng, data, params, twopi = _case(Q, D)
    Vs = {R: rng.randn(M, R) for R in MATVEC_RS}
    AB = {R: (rng.randn(N, R), rng.randn(M, R)) for R in VJP_RS}
    return data, params, twopi, Vs, AB, rng.randn(N, M)


def _pad(a, width):
    """a with zero columns up to width: the narrower cases' JAX answers come
    from the same compile (K·V is column by column, and zero columns of A
    and B add nothing to A·Bᵀ)."""
    return np.concatenate([a, np.zeros((a.shape[0], width - a.shape[1]))], axis=1)


def _group_answers(tmp_path_factory, request, Q, D, phase_inside):
    data, params, twopi, Vs, AB, g = _group(Q, D)

    def compute():
        def fn(x1, x2, V, A, B, g, *p):
            c1, c2 = data[1], data[3]
            mv = jpm.mosm_gram_matvec(x1, c1, x2, c2, *p, twopi, phase_inside, V)
            vjp = jpm.mosm_gram_lowrank_vjp(x1, c1, x2, c2, *p, twopi, phase_inside, A, B)
            if (Q, D, phase_inside) != GRAM_GROUP:
                return mv, vjp, ()
            K, pull = jax.vjp(lambda x1, x2, *p: jpm.mosm_gram(
                x1, c1, x2, c2, *p, twopi, phase_inside, True), x1, x2, *p)
            return mv, vjp, (K,) + pull(g)

        f = jax_reference.jit(fn)
        x1, x2 = jnp.asarray(data[0]), jnp.asarray(data[2])
        out = {"matvec": {}, "vjp": {}}
        for (r, V), (q, (A, B)) in zip(Vs.items(), AB.items()):
            mv, vjp, gram = f(x1, x2, *(jnp.asarray(_pad(a, w)) for a, w in (
                (V, max(MATVEC_RS)), (A, max(VJP_RS)), (B, max(VJP_RS)))),
                jnp.asarray(g), *map(jnp.asarray, params))
            out["matvec"][r] = np.asarray(mv)[:, :r]
            out["vjp"][q] = [np.asarray(v) for v in vjp]
            out["gram"] = [np.asarray(v) for v in gram]
        return out

    return (data, params, twopi, Vs, AB, g), _jax_references(
        tmp_path_factory, request, "pallas_mosm_%d%d%d" % (Q, D, phase_inside), compute)


# -- K-gram-matvec (E3a) ---------------------------------------------------------

@pytest.mark.parametrize("R", MATVEC_RS)
@pytest.mark.parametrize("Q,D,phase_inside", GROUPS)
def test_gram_matvec_matches_pallas(tmp_path_factory, request, Q, D, phase_inside, R):
    (data, params, twopi, Vs, _, _), ref = _group_answers(tmp_path_factory, request, Q, D,
                                                          phase_inside)
    launches = tmv.mosm_gram_matvec_pairstats.launches
    got = tpm.mosm_gram_matvec(*map(_t, data + params), twopi, phase_inside, _t(Vs[R]))
    assert got.shape == (N, R) and got.dtype == torch.float64
    _close(got, ref["matvec"][R])
    assert tmv.mosm_gram_matvec_pairstats.launches == launches


@pytest.mark.parametrize("R", [1, 33, 1024])
@pytest.mark.parametrize("N,M", [(4096, 16384), (16384, 16384), (1024, 16384), (300, 77)])
def test_gram_matvec_split_plan_covers_each_tile_once(N, M, R):
    """K-gram-matvec's split of the column tiles (gram_matvec_plan for 132
    SMs): every (row tile, column tile) pair is one CTA's, exactly once, for
    every chunk of V's columns; no split is empty; the slabs stay within
    GRAM_MATVEC_SLAB_BYTES; at K(Xq, X) (4,096 × 16,384, R ≤ 40) the grid
    holds at least two waves of the CTAs the card runs at once."""
    sms, T = 132, tmv.GRAM_MATVEC_TILE
    plan = tmv.gram_matvec_plan(N, M, R, sms)
    nb, splits, tps = plan
    nrt, nct = -(-N // T), -(-M // T)
    seen = np.zeros((nrt, nct), dtype=int)
    for s in range(splits):
        tiles = tmv.gram_matvec_split_tiles(M, tps, s)
        assert len(tiles) >= 1
        for it in range(nrt):
            seen[it, list(tiles)] += 1
    assert (seen == 1).all()
    assert nb in (1, 5, 16) and 8 * nb >= min(R, 128)
    assert splits == 1 or 4 * splits * N * R <= tmv.GRAM_MATVEC_SLAB_BYTES
    if (N, M) == (4096, 16384) and R <= 40:   # two CTAs an SM at nb <= 5
        assert nrt * splits * -(-R // (8 * nb)) >= 2 * 2 * sms


@pytest.mark.parametrize("tps", [1, 2, 3])
def test_gram_matvec_second_pass_twin_sums_the_splits(tps):
    """K-gram-matvec's two passes in plain torch: the slabs of each split of
    the column tiles (tps tiles a split, M = 300: three, two and one
    splits), summed in split order by the second pass's twin, are the plain
    twin's K(x1, x2)·V."""
    rng = np.random.RandomState(tps)
    st3, st2 = _stats(2, 2, False)
    x1, c1 = _points(rng, N, 2)
    x2, c2 = _points(rng, 300, 2)
    V = _t(rng.randn(300, 7))
    part = tmv.mosm_gram_matvec_partials_plain(x1, c1, x2, c2, st3, st2, V, tps)
    assert part.shape == (-(-3 // tps), N, 7)
    _close(tmv.mosm_gram_matvec_reduce(part),
           tmv.mosm_gram_matvec_plain(x1, c1, x2, c2, st3, st2, V))


# -- K-gram-lowrank-vjp (E3b) ----------------------------------------------------

@pytest.mark.parametrize("R", VJP_RS)
@pytest.mark.parametrize("Q,D,phase_inside", GROUPS)
def test_gram_lowrank_vjp_matches_pallas(tmp_path_factory, request, Q, D, phase_inside, R):
    (data, params, twopi, _, AB, _), ref = _group_answers(tmp_path_factory, request, Q, D,
                                                          phase_inside)
    launches = tbm.mosm_gram_lowrank_vjp_pairstats.launches
    A, B = AB[R]
    got = tpm.mosm_gram_lowrank_vjp(*map(_t, data + params), twopi, phase_inside, _t(A), _t(B))
    assert [g.shape for g in got] == [p.shape for p in params]
    for g, r in zip(got, ref["vjp"][R]):
        assert g.dtype == torch.float64
        _close(g, r)
    assert tbm.mosm_gram_lowrank_vjp_pairstats.launches == launches


def test_gram_lowrank_vjp_staging_gathers_the_padded_layout():
    """K-gram-lowrank-vjp gathers its rows through the channel map as it
    stages them: position p of the laid-out rows holds point rmap[p], a
    zero row where rmap[p] = −1. That is K-lowrank-vjp's channel-padded
    layout (_pad_channels) of the channel-sorted points and cotangent rows
    (300 shuffled points over three channels, none a multiple of 256)."""
    n = 300
    rng = np.random.RandomState(n)
    x, c = _points(rng, n, 2)
    A = _t(rng.randn(n, 5))
    counts = tmg.channel_counts(c, O)
    rmap = tmg.channel_map(c, counts, tbm.BWD_TILE)
    order = torch.argsort(c, stable=True)
    for a in (x, A):
        staged = torch.where(rmap[:, None] >= 0, a[rmap.long().clamp(min=0)], 0.0)
        assert torch.equal(staged, tbm._pad_channels(a[order], counts, tbm.BWD_TILE))


# -- mosm_gram at the JAX signature (C1, C1b) ------------------------------------

@pytest.mark.parametrize("input_grads", [False, True])
def test_gram_and_its_gradients_match_pallas(tmp_path_factory, request, input_grads):
    """Forward, the parameters' gradients by autograd and, under
    input_grads, x1's and x2's. One JAX answer (input_grads=True) serves
    both: its parameter cotangents do not depend on input_grads, and
    without it the JAX function's input cotangents are zero."""
    Q, D, phase_inside = GRAM_GROUP
    (data, params, twopi, _, _, g), ref = _group_answers(tmp_path_factory, request, Q, D,
                                                         phase_inside)
    ref = ref["gram"]
    x1, c1, x2, c2 = map(_t, data)
    x1.requires_grad_()
    x2.requires_grad_()
    p = [_t(a).requires_grad_() for a in params]
    launches = (tmg.mosm_gram.launches, tmg.mosm_gram_bwd.launches,
                tmg.mosm_gram_bwd.input_launches)
    K = tpm.mosm_gram(x1, c1, x2, c2, *p, twopi, phase_inside, input_grads)
    _close(K, ref[0])
    wrt = p + ([x1, x2] if input_grads else [])
    grads = torch.autograd.grad(K, wrt, _t(g), allow_unused=not input_grads)
    for got, r in zip(grads, ref[3:] + (ref[1:3] if input_grads else [])):
        _close(got, r)
    if not input_grads:
        K = tpm.mosm_gram(x1, c1, x2, c2, *p, twopi, phase_inside, input_grads)
        assert torch.autograd.grad(K, [x1, x2], _t(g), allow_unused=True) == (None, None)
    assert (tmg.mosm_gram.launches, tmg.mosm_gram_bwd.launches,
            tmg.mosm_gram_bwd.input_launches) == launches


# -- E3c: one pair's low-rank bodies -----------------------------------------------

def _one_pair_call(kernel, n_outs, smem_shapes, n1, n2, D, R, T=32):
    """One pair's pallas_call of a `_lowrank_bwd_kernel` body over an
    (n1/T, n2/T) grid, in interpret mode (as benchmarks/hot_decomp.py builds
    one), returning its n_outs scalars."""
    scalar = pl.BlockSpec((1, 1), lambda i, j: (0, 0))
    rows = lambda w: pl.BlockSpec((T, w), lambda i, j: (i, 0))
    cols = lambda w: pl.BlockSpec((T, w), lambda i, j: (j, 0))
    return pl.pallas_call(
        kernel,
        out_shape=tuple(jax.ShapeDtypeStruct((1, 1), jnp.float64) for _ in range(n_outs)),
        grid=(n1 // T, n2 // T),
        in_specs=[rows(D), cols(D)] + [jbm._smem_spec(s) for s in smem_shapes]
                 + [rows(R), rows(R), cols(R), cols(R)],
        out_specs=tuple(scalar for _ in range(n_outs)),
        interpret=True)


def _one_pair_inputs():
    """One pair's blocks (64 rows against 32, D = 1, R = 5), the MOSM pair
    statistics (Q = 2) and the CSM pack (Rq = 2) of pair (0, 1)."""
    rng = np.random.RandomState(3)
    n1, n2, D, R, Q, Rq = 64, 32, 1, 5, 2, 2
    x1, x2 = rng.rand(n1, D) * 5, rng.rand(n2, D) * 5
    ab = (rng.randn(n1, R), rng.randn(n1, R), rng.randn(n2, R), rng.randn(n2, R))
    st3, st2 = tbm.mosm_pair_stats(*map(_t, _case(Q, D)[2]), float(np.sqrt(2 * np.pi)))
    csm = (0.5 + rng.rand(O, Rq), 0.1 + rng.rand(1, D), 0.2 + rng.rand(1, D),
           0.1 * rng.randn(O, Rq))
    pack = tbf._csm_pack((Rq,), list(map(_t, csm)))[0, 1]
    return (n1, n2, D, R, Q, Rq), x1, x2, ab, st3[0, 1], st2[0, 1], pack


def _one_pair_answers(tmp_path_factory, request):
    (n1, n2, D, R, Q, Rq), x1, x2, ab, s3, s2, pack = _one_pair_inputs()

    def compute():
        def fn(x1, x2, s3, s2, pack, *ab):
            out = {}
            for sym in (False, True):
                mosm = _one_pair_call(functools.partial(jbm._lowrank_bwd_kernel, Q=Q, D=D,
                                                        phase_inside=True, sym=sym),
                                      3 * Q * D + 2 * Q, [(Q * D, 3), (Q, 2)], n1, n2, D, R)
                csm = _one_pair_call(functools.partial(jbf._lowrank_bwd_kernel,
                                                       tile=jbf._resolve("csm", (Rq, D))[1],
                                                       S=pack.shape[0], sym=sym),
                                     pack.shape[0], [(pack.shape[0], 1)], n1, n2, D, R)
                out["mosm", sym] = mosm(x1, x2, s3, s2, *ab)
                out["csm", sym] = csm(x1, x2, pack[:, None], *ab)
            return out

        out = jax_reference.jit(fn)(*map(jnp.asarray, (x1, x2, s3.reshape(Q * D, 3).numpy(),
                                                        s2.numpy(), pack.numpy()) + ab))
        return {k: np.array([float(r[0, 0]) for r in v]) for k, v in out.items()}

    return _jax_references(tmp_path_factory, request, "pallas_mosm_one_pair", compute)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("family", ["mosm", "csm"])
def test_one_pair_lowrank_bodies_match_port_twins(tmp_path_factory, request, family, sym):
    """g = A_i B_jᵀ (+ B_i A_jᵀ with sym, the transposed block folded in)
    reduced to one pair's statistics cotangents: JAX block_mosm.py:174 (MOSM,
    phase inside) and block_families.py:300 (CSM, Rq = 2) against
    tbm._bwd_scalars_plain and tbf._csm_grad."""
    (n1, n2, D, R, Q, Rq), x1, x2, (a1, b1, a2, b2), s3, s2, pack = _one_pair_inputs()
    ref = _one_pair_answers(tmp_path_factory, request)[family, sym]
    gm = _t(a1 @ b2.T + (b1 @ a2.T if sym else 0.0))
    if family == "mosm":
        ds3, ds2 = tbm._bwd_scalars_plain(_t(x1), _t(x2), s3, s2, gm)
        got = torch.cat([ds3.reshape(-1), ds2.reshape(-1)])
    else:
        X1, X2 = tbf._cols(_t(x1), _t(x2))
        terms = tbf._csm_grad(gm, pack, X1, X2, D, Rq)
        got = torch.stack([torch.sum(torch.broadcast_to(t, gm.shape)) for t in terms])
    _close(got, ref)


# -- sub-float32 parameters -------------------------------------------------------

@pytest.mark.parametrize("fn", ["mosm_gram", "mosm_gram_matvec", "mosm_gram_lowrank_vjp"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_sub_float32_parameters_raise(fn, dtype):
    """The JAX functions compute bf16/f16 parameters in float32; the port
    has no sub-float32 route and says so instead of upcasting silently."""
    _, data, params, twopi = _case(2, 1)
    args = list(map(_t, data)) + [_t(p).to(dtype) for p in params] + [twopi, True]
    extra = {"mosm_gram": [], "mosm_gram_matvec": [torch.ones(M, 2)],
             "mosm_gram_lowrank_vjp": [torch.ones(N, 2), torch.ones(M, 2)]}[fn]
    with pytest.raises(TypeError, match="ROADMAP item 5"):
        getattr(tpm, fn)(*args, *extra)


# -- properties of the entry points and plain twins (torch only) -------------------

def _points(rng, n, D):
    """n points in D dims and shuffled channel IDs over the O channels."""
    return _t(rng.rand(n, D) * 5), _t(rng.permutation(np.arange(n) % O).astype(np.int32))


def _stats(Q, D, phase_inside):
    _, _, params, twopi = _case(Q, D)
    return tpm.pair_stats(*map(_t, params), twopi, phase_inside)


def _row_block_ns(rows):
    """N at and on either side of the plain twins' row-block edge."""
    return (1, rows - 1, rows, rows + 1, 2 * rows + 1)


@pytest.mark.parametrize("n", _row_block_ns(tmv.PLAIN_ROWS))
def test_gram_matvec_twin_crosses_row_blocks(n):
    """K-gram-matvec's twin forms the Gram 2,048 rows at a time; at every N
    it equals the whole Gram times V."""
    rng = np.random.RandomState(n)
    st3, st2 = _stats(2, 1, True)
    x1, c1 = _points(rng, n, 1)
    x2, c2 = _points(rng, 9, 1)
    V = _t(rng.randn(9, 3))
    got = tmv.mosm_gram_matvec_plain(x1, c1, x2, c2, st3, st2, V)
    assert got.shape == (n, 3)
    _close(got, tmg.mosm_gram_pairstats_plain(x1, c1, x2, c2, st3, st2) @ V)


@pytest.mark.parametrize("n", _row_block_ns(tbm.PLAIN_ROWS))
def test_gram_lowrank_vjp_twin_crosses_row_blocks(n):
    """K-gram-lowrank-vjp's twin forms A·Bᵀ 2,048 rows at a time; at every N
    it equals K-gram-bwd's twin on the whole cotangent."""
    rng = np.random.RandomState(n)
    st3, st2 = _stats(2, 2, False)
    x1, c1 = _points(rng, n, 2)
    x2, c2 = _points(rng, 9, 2)
    A, B = _t(rng.randn(n, 4)), _t(rng.randn(9, 4))
    got = tbm.mosm_gram_lowrank_vjp_plain(x1, c1, x2, c2, st3, st2, A, B)
    want = tmg.mosm_gram_bwd_plain(x1, c1, x2, c2, st3, st2, A @ B.T)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("R", [0, 1, 5, 70])
def test_gram_lowrank_vjp_twin_is_the_gram_autograd(R):
    """The pair statistics' cotangents for dK = A·Bᵀ are autograd's through
    the plain Gram, R = 0 (no cotangent) included."""
    rng, (x1, c1, x2, c2), _, _ = _case(2, 1)
    x1, c1, x2, c2 = map(_t, (x1, c1, x2, c2))
    st3, st2 = (s.requires_grad_() for s in _stats(2, 1, True))
    A, B = _t(rng.randn(N, R)), _t(rng.randn(M, R))
    K = tmg.mosm_gram_pairstats_plain(x1, c1, x2, c2, st3, st2)
    want = torch.autograd.grad(torch.sum(K * (A @ B.T)), (st3, st2))
    got = tbm.mosm_gram_lowrank_vjp_plain(x1, c1, x2, c2, st3.detach(), st2.detach(), A, B)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("fn", ["matvec", "lowrank_vjp"])
@pytest.mark.parametrize("Q,D,phase_inside", GROUPS)
def test_swapping_the_point_sets_transposes_the_gram(Q, D, phase_inside, fn):
    """K(x2, x1) = K(x1, x2)ᵀ: the matvec with the point sets swapped is
    the transposed Gram times U, and the cotangents of A·Bᵀ with them
    swapped (B·Aᵀ) are the same."""
    rng, data, params, twopi = _case(Q, D)
    x1, c1, x2, c2 = map(_t, data)
    p = list(map(_t, params))
    if fn == "matvec":
        U = _t(rng.randn(N, 3))
        got = tpm.mosm_gram_matvec(x2, c2, x1, c1, *p, twopi, phase_inside, U)
        _close(got, tpm.mosm_gram(x1, c1, x2, c2, *p, twopi, phase_inside).T @ U)
    else:
        A, B = _t(rng.randn(N, 5)), _t(rng.randn(M, 5))
        got = tpm.mosm_gram_lowrank_vjp(x2, c2, x1, c1, *p, twopi, phase_inside, B, A)
        want = tpm.mosm_gram_lowrank_vjp(x1, c1, x2, c2, *p, twopi, phase_inside, A, B)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("Q,D", [(2, 1), (2, 2)])
def test_phase_outside_statistic_is_the_phase_over_two_pi(Q, D):
    """pair_stats with the phase outside differs from phase inside only in
    Δφ, divided by 2π."""
    _, _, params, twopi = _case(Q, D)
    inside = tpm.pair_stats(*map(_t, params), twopi, True)
    outside = tpm.pair_stats(*map(_t, params), twopi, False)
    assert torch.equal(inside[0], outside[0])
    assert torch.equal(inside[1][..., 0], outside[1][..., 0])
    _close(outside[1][..., 1] * (2 * np.pi), inside[1][..., 1])


@pytest.mark.parametrize("phase_inside", [True, False])
def test_stats_vjp_ignores_the_diagonal_pairs_delta_cotangents(phase_inside):
    """The Δθ and Δφ of a diagonal pair are constantly 0: stats_vjp gives
    the same parameter cotangents whatever their cotangents are, and agrees
    with autograd through pair_stats."""
    rng, _, params, twopi = _case(2, 2, seed=5)
    p = list(map(_t, params))
    st3, st2 = tpm.pair_stats(*p, twopi, phase_inside)
    dst3, dst2 = _t(rng.randn(*st3.shape)), _t(rng.randn(*st2.shape))
    got = tpm.stats_vjp(p, twopi, phase_inside, dst3, dst2)
    other3, other2 = dst3.clone(), dst2.clone()
    for a in range(O):
        other3[a, a, :, :, 2] += 7.0
        other2[a, a, :, 1] -= 3.0
    again = tpm.stats_vjp(p, twopi, phase_inside, other3, other2)
    assert all(torch.equal(g, h) for g, h in zip(got, again))
    leaves = [t.clone().requires_grad_() for t in p]
    want = torch.autograd.grad(tpm.pair_stats(*leaves, twopi, phase_inside), leaves,
                               (dst3, dst2))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("fn", ["matvec", "lowrank_vjp"])
@pytest.mark.parametrize("n,m", [(0, M), (N, 0)])
def test_empty_point_set(n, m, fn):
    """No rows or no columns: an empty or zero product, zero cotangents."""
    rng, _, params, twopi = _case(2, 1)
    x1, c1 = _points(rng, n, 1)
    x2, c2 = _points(rng, m, 1)
    p = list(map(_t, params))
    if fn == "matvec":
        got = tpm.mosm_gram_matvec(x1, c1, x2, c2, *p, twopi, True, _t(rng.randn(m, 3)))
        assert got.shape == (n, 3) and not bool(got.abs().any())
    else:
        got = tpm.mosm_gram_lowrank_vjp(x1, c1, x2, c2, *p, twopi, True, _t(rng.randn(n, 3)),
                                        _t(rng.randn(m, 3)))
        assert [g.shape for g in got] == [q.shape for q in p]
        assert not any(bool(g.abs().any()) for g in got)


@pytest.mark.parametrize("fn", ["matvec", "lowrank_vjp"])
@pytest.mark.parametrize("side", ["x1", "x2"])
def test_point_order_is_free(side, fn):
    """Any channel order: permuting x1's points (with c1 and A's rows)
    permutes the matvec's rows and leaves the cotangents alone; permuting
    x2's (with c2 and V's or B's rows) changes neither."""
    rng, data, params, twopi = _case(2, 2, seed=7)
    x1, c1, x2, c2 = map(_t, data)
    p = list(map(_t, params))
    V, A, B = _t(rng.randn(M, 3)), _t(rng.randn(N, 5)), _t(rng.randn(M, 5))
    perm = torch.as_tensor(rng.permutation(N if side == "x1" else M))
    if side == "x1":
        px1, pc1, px2, pc2, pV, pA, pB = x1[perm], c1[perm], x2, c2, V, A[perm], B
    else:
        px1, pc1, px2, pc2, pV, pA, pB = x1, c1, x2[perm], c2[perm], V[perm], A, B[perm]
    if fn == "matvec":
        want = tpm.mosm_gram_matvec(x1, c1, x2, c2, *p, twopi, False, V)
        got = tpm.mosm_gram_matvec(px1, pc1, px2, pc2, *p, twopi, False, pV)
        _close(got, want[perm] if side == "x1" else want)
    else:
        want = tpm.mosm_gram_lowrank_vjp(x1, c1, x2, c2, *p, twopi, False, A, B)
        got = tpm.mosm_gram_lowrank_vjp(px1, pc1, px2, pc2, *p, twopi, False, pA, pB)
        for g, w in zip(got, want):
            _close(g, w)
