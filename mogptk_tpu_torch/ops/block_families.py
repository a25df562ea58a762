"""The non-MOSM multi-output families' Gram engines: the (O, O, S) scalar
pack of each family, the four kernels K-fam-gram, K-fam-gram-bwd,
K-fam-matvec and K-fam-lowrank-vjp, each wrapper with its plain PyTorch
twin, and `FamilyGram`, the differentiable channel-sorted Gram.

JAX counterpart: mogptk_tpu/ops/block_families.py (the registry
`_umosm_spec` :41, `_csm_spec` :90, `_conv_spec` :126, `_mohsm_spec` :151,
`_lmc_sm_spec` :211; `family_gram_sorted` :455 with the per-block custom
VJP `_gram_block` whose forward and backward reach pallas_call at :392 and
:431; `family_matvec_sorted` :504, :525; `family_lowrank_vjp_sorted`
:590). Within one channel pair every cross-channel quantity of these
families is a scalar, so a family is a differentiable pack function of the
constrained parameters, (O, O, S) scalars in the JAX package's order, and
an element of the τ chain over the S scalars of its pair. The JAX package
evaluated the upper channel-pair blocks and transposed them; here every
element takes the scalars of its own pair (c1[i], c2[j]), which gives the
same Gram because each family's element is unchanged when the two points
and the pair swap (the antisymmetric scalars Δθ, Δφ and CSM's shift flip
sign with τ). K-fam-gram's square launch rests on the same swap: it
evaluates the lower 64² tiles and writes their transposes as the upper
ones. The pack's cotangent then differs from the JAX package's while the
parameters' gradient is the same: compare parameter gradients.

The CUDA sources are csrc/family_*.cu over csrc/family_element.cuh, which
transcribes the element values and their hand-derived derivatives with
respect to the S scalars; `_VALUE` and `_GRAD` below are the same formulas
in torch. On a CPU or float64 tensor every wrapper runs its plain twin
(ops/_build.runs_plain); on a float32 CUDA tensor it launches its kernel or
raises. `pack_of`, `gram_of`, `matvec_of` and `lowrank_vjp_of` dispatch a
family id (name, statics) between these engines and the MOSM ones
(ops/block_mosm.py, ops/mosm_gram.py, ops/mosm_matvec.py) for the fused
training LML and the iterative engine.
"""
import numpy as np
import torch

from . import _build
from .block_mosm import (BWD_TILE, _pad_channels, _pair_layout, _device_layout, channel_ids,
                         lowrank_plan, mosm_pair_stats, mosm_lowrank_vjp_sorted)
from .mosm_gram import (_gram_layout, _device_gram_layout, channel_counts, channel_map,
                        mosm_gram, same_tensor)
from .mosm_matvec import (FOLD_TILE, PLAIN_ROWS, fold_group, fold_items_on, fold_matvec,
                          fold_partials_plain_of, fold_slab_base, fold_tiles, mosm_matvec)

_pi = np.pi
_two_pi = 2.0 * np.pi

# the family ids of csrc/family_element.cuh
FAMILY_IDS = {"umosm": 0, "csm": 1, "conv": 2, "mohsm": 3, "lmc_sm": 4}


# -- the packs (JAX: the `pack` of each _*_spec) -------------------------------

def _umosm_pack(statics, params):
    """uMOSM: MOSM with Q = 1, a trained lower-triangular cross weight and
    the phase outside 2π. params = (W (O, O), mu, var, theta (O, D) or
    (O, 1, D), phi (O,) or (O, 1)). Order: [V_d, M_d, Δθ_d]·D + [α, Δφ]."""
    (twopi,) = statics
    W, mu, var, theta, phi = params
    O = W.shape[0]
    mu, var, theta, phi = mu.reshape(O, -1), var.reshape(O, -1), theta.reshape(O, -1), phi.reshape(O)
    D = mu.shape[1]
    v1, v2 = var[:, None], var[None, :]
    m1, m2 = mu[:, None], mu[None, :]
    inv = 1.0 / (v1 + v2)
    mean_nm = inv * (v1 * m2 + v2 * m1)
    var_nm = 2.0 * v1 * inv * v2
    mag = torch.sum((m1 - m2) ** 2 * inv, dim=-1)
    Wt = torch.tril(W)
    alpha = (Wt @ Wt.T) * torch.exp(-_pi ** 2 * mag) * twopi * torch.sqrt(torch.prod(var_nm, dim=-1))
    dth = theta[:, None] - theta[None, :]
    dph = (phi[:, None] - phi[None, :])[..., None]
    return torch.cat([torch.stack([var_nm, mean_nm, dth], dim=-1).reshape(O, O, 3 * D),
                      alpha[..., None], dph], dim=-1)


def _csm_pack(statics, params):
    """CSM: one spectral envelope shared by the channels, per (channel,
    component) amplitude and shift. params = (amp (O, Rq), mu (1, D),
    var (1, D), shift (O, Rq)). Order: [v_d]·D + [μ_d]·D + [amp_r]·Rq +
    [s_r]·Rq."""
    amp, mu, var, shift = params
    O = amp.shape[0]
    amp_oo = torch.sqrt(amp[:, None] * amp[None, :])
    s_oo = shift[:, None] - shift[None, :]
    shared = torch.cat([var[0], mu[0]]).expand(O, O, -1)
    return torch.cat([shared, amp_oo, s_oo], dim=-1)


def _conv_pack(statics, params):
    """CONV: params = (w (O, 1), var (O, D), base (1, D)). Order:
    [1/v_d]·D + [magnitude], v_d = var_i + var_j + base."""
    w, var, base = params
    vd = var[:, None] + var[None, :] + base[0]
    mag = (w[:, 0][:, None] * w[:, 0][None, :]
           * torch.sqrt(torch.prod(base) / torch.prod(vd, dim=-1)))
    return torch.cat([1.0 / vd, mag[..., None]], dim=-1)


def _mohsm_pack(statics, params):
    """MOHSM: MOSM Q = 1 with the phase outside 2π, times the envelope
    (√l_ij)^D exp(−½‖(x + x')/2 − center‖² l_ij), l_ij = 2l_i²l_j²/(l_i² + l_j²).
    params = (w, mu, var, theta, phi, ls, center), flat or MOSM-lifted.
    Order: [V_d, M_d, Δθ_d]·D + [α, Δφ, l] + [center_d]·D."""
    twopi, D = statics
    w, mu, var, theta, phi, ls, center = params
    O = w.shape[0]
    w, ls, phi = w.reshape(O), ls.reshape(O), phi.reshape(O)
    mu, var, theta = mu.reshape(O, -1), var.reshape(O, -1), theta.reshape(O, -1)
    center = center.reshape(-1)
    v1, v2 = var[:, None], var[None, :]
    m1, m2 = mu[:, None], mu[None, :]
    inv = 1.0 / (v1 + v2)
    mean_nm = inv * (v1 * m2 + v2 * m1)
    var_nm = 2.0 * v1 * inv * v2
    mag = torch.sum((m1 - m2) ** 2 * inv, dim=-1)
    l2 = ls ** 2
    l_nm = 2.0 * l2[:, None] * l2[None, :] / (l2[:, None] + l2[None, :])
    alpha = (w[:, None] * w[None, :] * torch.exp(-_pi ** 2 * mag)
             * twopi * torch.sqrt(torch.prod(var_nm, dim=-1))
             * torch.pow(torch.sqrt(l_nm), float(D)))
    dth = theta[:, None] - theta[None, :]
    dph = (phi[:, None] - phi[None, :])[..., None]
    return torch.cat([torch.stack([var_nm, mean_nm, dth], dim=-1).reshape(O, O, 3 * D),
                      alpha[..., None], dph, l_nm[..., None], center.expand(O, O, D)], dim=-1)


def _lmc_sm_pack(statics, params):
    """SM-LMC, the LMC over plain spectral kernels: params = (W (O, Q, Rq),
    mag (Q, 1), mu (Q, D), var (Q, D)). Order: [a_q]·Q + [var_qd]·QD +
    [μ_qd]·QD, a_q = σ²_q Σ_r W_iqr W_jqr."""
    Q, D = statics
    W, mag, mu, var = params
    O = W.shape[0]
    W = W.reshape(O, Q, -1)
    amp = torch.einsum("iqr,jqr->ijq", W, W) * mag.reshape(Q)
    shared = torch.cat([var.reshape(-1), mu.reshape(-1)]).expand(O, O, -1)
    return torch.cat([amp, shared], dim=-1)


_PACKS = {"umosm": _umosm_pack, "csm": _csm_pack, "conv": _conv_pack,
          "mohsm": _mohsm_pack, "lmc_sm": _lmc_sm_pack}


def has_block_family(name):
    return name in _PACKS


def family_pack(family, params):
    """The (O, O, S) scalar pack of family = (name, statics) at `params`,
    differentiable."""
    name, statics = family
    return _PACKS[name](statics, params)


def family_dims(family, pack, D):
    """(family id, A, S) for csrc/family_element.cuh: A is the family's
    component count (CSM's Rq, SM-LMC's Q, 0 for the others) and S the
    scalars per pair, checked against the pack."""
    name, statics = family
    A = int(statics[0]) if name in ("csm", "lmc_sm") else 0
    S = {"umosm": 3 * D + 2, "csm": 2 * D + 2 * A, "conv": D + 1, "mohsm": 4 * D + 3,
         "lmc_sm": A + 2 * A * D}[name]
    if pack.shape[-1] != S:
        raise ValueError("%s pack has %d scalars per pair, expected %d for D = %d"
                         % (name, pack.shape[-1], S, D))
    return FAMILY_IDS[name], A, S


# -- the elements: values and hand-derived derivatives -------------------------
# s[k] is the k-th scalar of each element's pair (a tensor that broadcasts
# to the block, or a 0-d tensor); x1[d] (n1, 1) and x2[d] (1, n2) are the
# inputs. Each _GRAD returns g·∂K/∂s_k for every k, the terms
# csrc/family_element.cuh accumulates.

def _umosm_value(s, x1, x2, D, A):
    e = a = 0.0
    for d in range(D):
        td = (x1[d] - x2[d]) + s[3 * d + 2]
        e = e + td * td * s[3 * d]
        a = a + td * s[3 * d + 1]
    return s[3 * D] * torch.exp(-0.5 * e) * torch.cos(_two_pi * a + s[3 * D + 1])


def _umosm_grad(g, s, x1, x2, D, A):
    tds = [(x1[d] - x2[d]) + s[3 * d + 2] for d in range(D)]
    e = sum(td * td * s[3 * d] for d, td in enumerate(tds))
    a = sum(td * s[3 * d + 1] for d, td in enumerate(tds))
    ang = _two_pi * a + s[3 * D + 1]
    gE = g * torch.exp(-0.5 * e)
    C, S_ = torch.cos(ang), torch.sin(ang)
    P = s[3 * D] * gE
    dang = -P * S_
    de = -0.5 * P * C
    out = [None] * (3 * D + 2)
    out[3 * D], out[3 * D + 1] = gE * C, dang
    for d, td in enumerate(tds):
        out[3 * d] = de * td * td
        out[3 * d + 1] = _two_pi * dang * td
        out[3 * d + 2] = de * (2.0 * s[3 * d]) * td + _two_pi * dang * s[3 * d + 1]
    return out


def _mohsm_value(s, x1, x2, D, A):
    e = a = dist2 = 0.0
    for d in range(D):
        td = (x1[d] - x2[d]) + s[3 * d + 2]
        e = e + td * td * s[3 * d]
        a = a + td * s[3 * d + 1]
        avg = 0.5 * (x1[d] + x2[d]) - s[3 * D + 3 + d]
        dist2 = dist2 + avg * avg
    return (s[3 * D] * torch.exp(-0.5 * (e + dist2 * s[3 * D + 2]))
            * torch.cos(_two_pi * a + s[3 * D + 1]))


def _mohsm_grad(g, s, x1, x2, D, A):
    tds = [(x1[d] - x2[d]) + s[3 * d + 2] for d in range(D)]
    avgs = [0.5 * (x1[d] + x2[d]) - s[3 * D + 3 + d] for d in range(D)]
    e = sum(td * td * s[3 * d] for d, td in enumerate(tds))
    a = sum(td * s[3 * d + 1] for d, td in enumerate(tds))
    dist2 = sum(avg * avg for avg in avgs)
    lnm = s[3 * D + 2]
    ang = _two_pi * a + s[3 * D + 1]
    gE = g * torch.exp(-0.5 * (e + dist2 * lnm))
    C, S_ = torch.cos(ang), torch.sin(ang)
    P = s[3 * D] * gE
    dang = -P * S_
    de = -0.5 * P * C
    out = [None] * (4 * D + 3)
    out[3 * D], out[3 * D + 1], out[3 * D + 2] = gE * C, dang, de * dist2
    for d, td in enumerate(tds):
        out[3 * d] = de * td * td
        out[3 * d + 1] = _two_pi * dang * td
        out[3 * d + 2] = de * (2.0 * s[3 * d]) * td + _two_pi * dang * s[3 * d + 1]
        out[3 * D + 3 + d] = -2.0 * de * lnm * avgs[d]
    return out


def _csm_value(s, x1, x2, D, A):
    e = a = 0.0
    for d in range(D):
        tau = x1[d] - x2[d]
        e = e + tau * tau * s[d]
        a = a + tau * s[D + d]
    E = torch.exp(-0.5 * e)
    K = 0.0
    for r in range(A):
        K = K + s[2 * D + r] * E * torch.cos(_two_pi * (a + s[2 * D + A + r]))
    return K


def _csm_grad(g, s, x1, x2, D, A):
    taus = [x1[d] - x2[d] for d in range(D)]
    e = sum(tau * tau * s[d] for d, tau in enumerate(taus))
    a = sum(tau * s[D + d] for d, tau in enumerate(taus))
    gE = g * torch.exp(-0.5 * e)
    out = [None] * (2 * D + 2 * A)
    da = dsum = 0.0
    for r in range(A):
        ang = _two_pi * (a + s[2 * D + A + r])
        C, S_ = torch.cos(ang), torch.sin(ang)
        dang = -s[2 * D + r] * gE * S_
        out[2 * D + r] = gE * C
        out[2 * D + A + r] = _two_pi * dang
        da = da + _two_pi * dang
        dsum = dsum + s[2 * D + r] * C
    de = -0.5 * gE * dsum
    for d, tau in enumerate(taus):
        out[d] = de * tau * tau
        out[D + d] = da * tau
    return out


def _conv_value(s, x1, x2, D, A):
    e = 0.0
    for d in range(D):
        tau = x1[d] - x2[d]
        e = e + tau * tau * s[d]
    return s[D] * torch.exp(-0.5 * e)


def _conv_grad(g, s, x1, x2, D, A):
    taus = [x1[d] - x2[d] for d in range(D)]
    gE = g * torch.exp(-0.5 * sum(tau * tau * s[d] for d, tau in enumerate(taus)))
    de = -0.5 * s[D] * gE
    return [de * tau * tau for tau in taus] + [gE]


def _lmc_sm_value(s, x1, x2, D, A):
    K = 0.0
    for q in range(A):
        acc = 0.0
        for d in range(D):
            tau = x1[d] - x2[d]
            acc = acc + (torch.exp(-2.0 * _pi ** 2 * tau * tau * s[A + q * D + d])
                         * torch.cos(_two_pi * tau * s[A + A * D + q * D + d]))
        K = K + s[q] * acc
    return K


def _lmc_sm_grad(g, s, x1, x2, D, A):
    taus = [x1[d] - x2[d] for d in range(D)]
    out = [None] * (A + 2 * A * D)
    for q in range(A):
        acc = 0.0
        ga = g * s[q]
        for d, tau in enumerate(taus):
            E = torch.exp(-2.0 * _pi ** 2 * tau * tau * s[A + q * D + d])
            ang = _two_pi * tau * s[A + A * D + q * D + d]
            C, S_ = torch.cos(ang), torch.sin(ang)
            acc = acc + E * C
            out[A + q * D + d] = ga * E * C * (-2.0 * _pi ** 2) * tau * tau
            out[A + A * D + q * D + d] = -ga * E * S_ * _two_pi * tau
        out[q] = g * acc
    return out


_VALUE = {"umosm": _umosm_value, "csm": _csm_value, "conv": _conv_value,
          "mohsm": _mohsm_value, "lmc_sm": _lmc_sm_value}
_GRAD = {"umosm": _umosm_grad, "csm": _csm_grad, "conv": _conv_grad,
         "mohsm": _mohsm_grad, "lmc_sm": _lmc_sm_grad}


class _PairScalars:
    """s[k]: the k-th scalar of each element's pair, an (N, M) gather."""

    def __init__(self, pack, c1, c2):
        self.pack, self.i1, self.i2 = pack, c1.long()[:, None], c2.long()[None, :]

    def __getitem__(self, k):
        return self.pack[:, :, k][self.i1, self.i2]


def _cols(x1, x2):
    D = x1.shape[1]
    return [x1[:, d, None] for d in range(D)], [x2[None, :, d] for d in range(D)]


# -- K-fam-gram (TPU kernel D2 forward; C2 for the families) -------------------

def family_gram_plain(family, x1, c1, x2, c2, pack):
    """Plain twin of K-fam-gram: the (N, M) Gram, each element from the
    scalars of its pair (c1[i], c2[j])."""
    D = x1.shape[1]
    _, A, _ = family_dims(family, pack, D)
    X1, X2 = _cols(x1, x2)
    return _VALUE[family[0]](_PairScalars(pack, c1, c2), X1, X2, D, A)


def _table(pack):
    O = pack.shape[0]
    return pack.reshape(O * O, -1).contiguous()


def family_gram(family, x1, c1, x2, c2, pack):
    """(N, M) Gram of a family for points x1 (N, D) with channel IDs c1
    (N,) int32 and x2 (M, D) with c2, from the (O, O, S) pack. Not
    differentiable (FamilyGram is). CPU or float64: the plain twin. float32
    CUDA, contiguous: one launch of csrc/family_gram.cu, or raises. Where x1
    and x2 are the same tensor and c1 and c2 are the same tensor (the
    training Gram), the square launch: the lower tiles only, each written to
    its place and its mirror, so the Gram is bitwise symmetric; else every
    tile."""
    if _build.runs_plain(x1):
        return family_gram_plain(family, x1, c1, x2, c2, pack)
    D = x1.shape[1]
    fam, A, S = family_dims(family, pack, D)
    O = pack.shape[0]
    table = _table(pack)
    _build.require_cuda_inputs("family_gram", floats=(x1, x2, table), ints=(c1, c2))
    N, M = x1.shape[0], x2.shape[0]
    if x2.shape[1] != D or c1.shape != (N,) or c2.shape != (M,):
        raise ValueError("family_gram: x1 (N, D), c1 (N,), x2 (M, D), c2 (M,) expected")
    out = torch.empty((N, M), dtype=torch.float32, device=x1.device)
    if same_tensor(x1, x2) and same_tensor(c1, c2):
        err = _build.library().family_gram_square_f32(
            x1.data_ptr(), c1.data_ptr(), table.data_ptr(), out.data_ptr(), N, O, S, D, A, fam,
            _build.stream_ptr(x1))
        _build.check(err, "family_gram_square_f32")
    else:
        err = _build.library().family_gram_f32(
            x1.data_ptr(), c1.data_ptr(), x2.data_ptr(), c2.data_ptr(), table.data_ptr(),
            out.data_ptr(), N, M, O, S, D, A, fam, _build.stream_ptr(x1))
        _build.check(err, "family_gram_f32")
    family_gram.launches += 1
    return out


family_gram.launches = 0


# -- K-fam-gram-bwd (TPU kernel D2 backward) -----------------------------------

def family_gram_bwd_plain(family, x1, c1, x2, c2, pack, g):
    """Plain twin of K-fam-gram-bwd: the (O, O, S) cotangent of the pack for
    the Gram's cotangent g (N, M), each element's g·∂K/∂s summed into its
    pair in float64, as the kernel's per-pair reduction is."""
    D = x1.shape[1]
    _, A, S = family_dims(family, pack, D)
    O = pack.shape[0]
    X1, X2 = _cols(x1, x2)
    pid = (c1.long()[:, None] * O + c2.long()[None, :]).reshape(-1)
    terms = _GRAD[family[0]](g, _PairScalars(pack, c1, c2), X1, X2, D, A)
    sums = [torch.zeros(O * O, dtype=torch.float64, device=x1.device).index_add_(
        0, pid, torch.broadcast_to(t, g.shape).reshape(-1).double()) for t in terms]
    return torch.stack(sums, dim=1).reshape(O, O, S).to(pack.dtype)


def family_gram_bwd(family, x1, c1, x2, c2, pack, g, counts1=None, counts2=None):
    """Cotangent (O, O, S) of the pack for a dense cotangent g (N, M) of
    family_gram(family, x1, c1, x2, c2, pack); the inputs' cotangents are
    zero, as in the JAX package. counts1/counts2: the per-channel counts of
    c1/c2 when known. CPU or float64: the plain twin. float32 CUDA: one call
    of csrc/family_gram_bwd.cu (the tile kernel and its per-pair reduction),
    or raises."""
    if _build.runs_plain(x1):
        return family_gram_bwd_plain(family, x1, c1, x2, c2, pack, g)
    D = x1.shape[1]
    fam, A, S = family_dims(family, pack, D)
    O = pack.shape[0]
    N, M = x1.shape[0], x2.shape[0]
    if g.shape != (N, M):
        raise ValueError("family_gram_bwd: the cotangent must be (N, M) = (%d, %d)" % (N, M))
    counts1 = channel_counts(c1, O) if counts1 is None else tuple(int(k) for k in counts1)
    counts2 = channel_counts(c2, O) if counts2 is None else tuple(int(k) for k in counts2)
    idx_np, pairs_np = _gram_layout(counts1, counts2, BWD_TILE)
    out = torch.zeros((O * O, S), dtype=torch.float32, device=x1.device)
    ntiles = idx_np.shape[0]
    if ntiles:
        table = _table(pack)
        rmap, cmap = channel_map(c1, counts1), channel_map(c2, counts2)
        idx, pairs = _device_gram_layout(counts1, counts2, BWD_TILE, x1.device)
        partial = torch.empty((4 * ntiles, S), dtype=torch.float32, device=x1.device)
        _build.require_cuda_inputs("family_gram_bwd", floats=(g, x1, x2, table, partial),
                                   ints=(idx, pairs, rmap, cmap))
        err = _build.library().family_gram_bwd_f32(
            idx.data_ptr(), g.data_ptr(), x1.data_ptr(), rmap.data_ptr(), x2.data_ptr(),
            cmap.data_ptr(), table.data_ptr(), partial.data_ptr(), pairs.data_ptr(),
            out.data_ptr(), ntiles, pairs_np.shape[0], M, S, D, A, fam, _build.stream_ptr(x1))
        _build.check(err, "family_gram_bwd_f32")
        family_gram_bwd.launches += 1
    return out.reshape(O, O, S)


family_gram_bwd.launches = 0


class FamilyGram(torch.autograd.Function):
    """The (N, M) Gram of a family's pack, differentiable in the pack
    (JAX: `_gram_block`'s custom VJP). Forward: K-fam-gram on float32 CUDA,
    the plain twin on the CPU and in float64; it saves its inputs, never
    its output (the exact LML factors the Gram in place). Backward: the
    pack's cotangent from K-fam-gram-bwd or its twin; autograd chains it
    through family_pack. The inputs get no cotangent (training inputs are
    constant, as in the JAX package's sorted engines)."""

    @staticmethod
    def forward(ctx, family, x1, c1, x2, c2, pack, counts1, counts2):
        x1, x2, pack = x1.detach(), x2.detach(), pack.detach()
        ctx.family, ctx.counts = family, (counts1, counts2)
        ctx.save_for_backward(x1, c1, x2, c2, pack)
        return family_gram(family, x1, c1, x2, c2, pack)

    @staticmethod
    def backward(ctx, g):
        x1, c1, x2, c2, pack = ctx.saved_tensors
        dpack = family_gram_bwd(ctx.family, x1, c1, x2, c2, pack, g.contiguous(), *ctx.counts)
        return None, None, None, None, None, dpack, None, None


def family_gram_sorted(family, x, counts, params):
    """Full (N, N) Gram of a family for channel-sorted x with per-channel
    `counts`, differentiable in the parameters (JAX: family_gram_sorted)."""
    counts = tuple(int(n) for n in counts)
    if sum(counts) != x.shape[0]:
        raise ValueError("counts must sum to the number of rows of x")
    c = channel_ids(counts, x.device)
    return FamilyGram.apply(family, x, c, x, c, family_pack(family, params), counts, counts)


# -- K-fam-matvec (TPU kernel D3; C3 for the families) -------------------------

def family_matvec_plain(family, x, c, pack, V):
    """Plain twin of K-fam-matvec: K(x, x)·V from Gram row blocks of at
    most 2,048 rows, one matmul each."""
    N = x.shape[0]
    out = V.new_empty((N, V.shape[1]))
    for r0 in range(0, N, PLAIN_ROWS):
        r1 = min(N, r0 + PLAIN_ROWS)
        out[r0:r1] = family_gram_plain(family, x[r0:r1], c[r0:r1], x, c, pack) @ V
    return out


def family_fold_partials_plain(family, x, c, pack, V):
    """Plain twin of K-fam-matvec's first pass: the partial slabs
    family_fold_partials fills (mosm_matvec.fold_partials_plain_of with the
    family's plain Gram), which mosm_matvec.mosm_matvec_reduce_plain sums."""
    return fold_partials_plain_of(
        lambda ri, rj: family_gram_plain(family, x[ri], c[ri], x[rj], c[rj], pack), V)


def family_fold_partials(family, x, c, pack, V):
    """K-fam-matvec's first pass on the card: the (slots·128, R) partial
    slabs of K(x, x)·V (K-matvec's layout, mosm_matvec.fold_slab_base), one
    launch of csrc/family_matvec.cu family_matvec_fold_f32 (counted on
    family_matvec), R within one fold_group. Raises on what the kernel does
    not take."""
    D = x.shape[1]
    fam, A, S = family_dims(family, pack, D)
    O = pack.shape[0]
    table = _table(pack)
    N = x.shape[0]
    _build.require_cuda_inputs("family_matvec", floats=(x, table, V), ints=(c,))
    if V.dim() != 2 or V.shape[0] != N or c.shape != (N,) or V.shape[1] < 1:
        raise ValueError("family_matvec: V must be (N, R) with N = %d rows and R >= 1" % N)
    R = V.shape[1]
    nb, cols = fold_group(N, R)
    if cols < R:
        raise ValueError("family_matvec: R = %d exceeds one launch's %d columns" % (R, cols))
    part = torch.empty((fold_slab_base(*fold_tiles(N)) * FOLD_TILE, R), dtype=torch.float32,
                       device=x.device)
    items = fold_items_on(N, x.device)
    err = _build.library().family_matvec_fold_f32(
        x.data_ptr(), c.data_ptr(), table.data_ptr(), V.data_ptr(), items.data_ptr(),
        items.shape[0], part.data_ptr(), N, R, nb, O, S, D, A, fam, _build.stream_ptr(x))
    _build.check(err, "family_matvec_fold_f32")
    family_matvec.launches += 1
    return part


def family_matvec(family, x, c, pack, V):
    """K(x, x)·V for a family's Gram, x (N, D), channel IDs c (N,) int32 in
    any order, V (N, R). Not differentiable. CPU or float64: the plain twin.
    float32 CUDA: per fold_group of columns of V one K-fam-matvec launch
    (family_fold_partials: each symmetric 128² tile evaluated once, 3xTF32
    products) and one K-matvec-reduce launch, or raises."""
    if _build.runs_plain(x):
        return family_matvec_plain(family, x, c, pack, V)
    return fold_matvec(lambda Vg: family_fold_partials(family, x, c, pack, Vg), x.shape[0], V)


family_matvec.launches = 0


# -- K-fam-lowrank-vjp (TPU kernel D4; C4 for the families) --------------------

def _zero_diagonal_antisymmetric(family, dpack, D):
    """Sets the cotangents of the scalars that flip sign when the pair swaps
    (Δθ_d and Δφ of uMOSM and MOHSM, CSM's s_r) to 0 on the diagonal pairs,
    in place, and returns dpack. There they are θ_a − θ_a, constantly 0,
    and carry no parameter gradient; K-fam-lowrank-vjp's fold of each lower
    tile into its upper mirror leaves them large, and the pack's chain rule
    would cancel them in float32 (Σ_b ds_ab − Σ_b ds_ba), losing the
    digits of the other pairs' terms."""
    _, A, _ = family_dims(family, dpack, D)
    slots = {"umosm": [3 * d + 2 for d in range(D)] + [3 * D + 1],
             "mohsm": [3 * d + 2 for d in range(D)] + [3 * D + 1],
             "csm": [2 * D + A + r for r in range(A)]}.get(family[0])
    if slots:
        diag = torch.arange(dpack.shape[0], device=dpack.device)
        dpack[diag[:, None], diag[:, None], torch.as_tensor(slots, device=dpack.device)] = 0.0
    return dpack


def family_lowrank_vjp_plain(family, x, counts, pack, A, B):
    """Plain twin of K-fam-lowrank-vjp: for every upper pair (a ≤ b) the
    block cotangent g = (ABᵀ)_ab + [a≠b]·((ABᵀ)_ba)ᵀ reduced by the
    hand-derived element derivatives. A diagonal pair reduces its whole
    block, where the kernel folds each lower tile into its upper mirror;
    the antisymmetric scalars of a diagonal pair (Δθ_aa, Δφ_aa, CSM's
    s_aa), which would differ between the two, carry no parameter gradient
    and are set to 0 in both (_zero_diagonal_antisymmetric)."""
    D = x.shape[1]
    _, Aux, S = family_dims(family, pack, D)
    O = pack.shape[0]
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(int)
    dpack = torch.zeros_like(pack)
    grad = _GRAD[family[0]]
    for a in range(O):
        sa = slice(offs[a], offs[a + 1])
        for b in range(a, O):
            sb = slice(offs[b], offs[b + 1])
            if counts[a] == 0 or counts[b] == 0:
                continue
            g = A[sa] @ B[sb].T
            if a != b:
                g = g + (A[sb] @ B[sa].T).T
            X1, X2 = _cols(x[sa], x[sb])
            terms = grad(g, pack[a, b], X1, X2, D, Aux)
            dpack[a, b] = torch.stack([torch.sum(torch.broadcast_to(t, g.shape)) for t in terms])
    return _zero_diagonal_antisymmetric(family, dpack, D)


def family_lowrank_vjp_sorted(family, x, counts, pack, A, B):
    """Cotangent (O, O, S) of the pack for dK = A·Bᵀ without forming dK,
    for channel-sorted x (N, D) with per-channel `counts` and A, B (N, R),
    any R. Rows of lower pairs (a > b) stay zero, and so do the
    antisymmetric scalars of the diagonal pairs. CPU or float64: the plain
    twin. float32 CUDA: one call of csrc/family_lowrank_vjp.cu (the tile
    kernel over the upper tiles of the upper pairs, g on the tensor cores
    with R in the chunks of lowrank_plan(R), and its per-pair reduction),
    or raises."""
    counts = tuple(int(n) for n in counts)
    if _build.runs_plain(x):
        return family_lowrank_vjp_plain(family, x, counts, pack, A, B)
    D = x.shape[1]
    fam, Aux, S = family_dims(family, pack, D)
    O = pack.shape[0]
    R = A.shape[1]
    if sum(counts) != x.shape[0] or A.shape != B.shape or A.shape[0] != x.shape[0]:
        raise ValueError("family_lowrank_vjp_sorted: x (N, D), A and B (N, R) with N = sum(counts)")
    idx_np, pairs_np = _pair_layout(counts, BWD_TILE)
    out = torch.zeros((O * O, S), dtype=torch.float32, device=x.device)
    if idx_np.shape[0]:
        xp, ap, bp = (_pad_channels(t, counts, BWD_TILE) for t in (x, A, B))
        idx, pairs = _device_layout(counts, BWD_TILE, x.device)
        table = _table(pack)
        partial = torch.empty((4 * idx_np.shape[0], S), dtype=torch.float32, device=x.device)
        _build.require_cuda_inputs("family_lowrank_vjp_sorted", floats=(xp, ap, bp, table, partial),
                                   ints=(idx, pairs))
        err = _build.library().family_lowrank_vjp_f32(
            idx.data_ptr(), xp.data_ptr(), ap.data_ptr(), bp.data_ptr(), table.data_ptr(),
            partial.data_ptr(), pairs.data_ptr(), out.data_ptr(), idx_np.shape[0],
            pairs_np.shape[0], R, *lowrank_plan(R), S, D, Aux, fam, _build.stream_ptr(x))
        _build.check(err, "family_lowrank_vjp_f32")
        family_lowrank_vjp_sorted.launches += 1
    return _zero_diagonal_antisymmetric(family, out.reshape(O, O, S), D)


family_lowrank_vjp_sorted.launches = 0


# -- one dispatch over the MOSM engines and the families' ----------------------

def pack_of(family, params):
    """The engine's differentiable pack as a tuple: MOSM's pair statistics
    (st3, st2), or a family's (pack,)."""
    name, statics = family
    if name == "mosm":
        return mosm_pair_stats(*params, statics[0])
    return (family_pack(family, params),)


def gram_of(family, x1, c1, x2, c2, pack, counts1=None, counts2=None):
    """The (N, M) Gram of the engine's pack (K-gram or K-fam-gram)."""
    if family[0] == "mosm":
        return mosm_gram(x1, c1, x2, c2, *pack, counts1, counts2)
    return family_gram(family, x1, c1, x2, c2, *pack)


def matvec_of(family, x, c, pack, V):
    """K(x, x)·V (K-matvec or K-fam-matvec)."""
    if family[0] == "mosm":
        return mosm_matvec(x, c, *pack, V)
    return family_matvec(family, x, c, *pack, V)


def lowrank_vjp_of(family, x, counts, pack, A, B):
    """The pack's cotangents for dK = A·Bᵀ on channel-sorted x, a tuple
    shaped like the pack (K-lowrank-vjp or K-fam-lowrank-vjp)."""
    if family[0] == "mosm":
        return mosm_lowrank_vjp_sorted(x, counts, *pack, A, B)
    return (family_lowrank_vjp_sorted(family, x, counts, *pack, A, B),)
