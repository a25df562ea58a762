"""The MOSM Gram from the raw parameters for any channel IDs and x1 ≠ x2:
the Gram itself (`mosm_gram`, differentiable), the Gram times a block of
vectors (`mosm_gram_matvec`) and the Gram's parameter cotangents for a
low-rank cotangent A·Bᵀ (`mosm_gram_lowrank_vjp`), none of which stores
more of the Gram than it returns.

Named after its JAX counterpart, mogptk_tpu/ops/pallas_mosm.py, whose
public functions it mirrors at their signatures and argument order; there
is no Pallas in it. Each function builds the channel-pair statistics
(ops/block_mosm.mosm_pair_stats) and hands them to the wrapper of a
hand-written CUDA kernel:

- `mosm_gram` → ops/mosm_gram.MosmGram: K-gram forward (JAX pallas_call at
  :207), K-gram-bwd backward (:274), with x1/x2 cotangents under
  `input_grads`;
- `mosm_gram_matvec` → ops/mosm_matvec.mosm_gram_matvec_pairstats:
  K-gram-matvec (:351);
- `mosm_gram_lowrank_vjp` → ops/block_mosm.mosm_gram_lowrank_vjp_pairstats:
  K-gram-lowrank-vjp (:431), then the chain to the five parameters by
  autograd.

`phase_inside=False` is the form cos(2πa + Δφ) (JAX pallas_mosm.py:84-87).
The kernels compute cos(2π(a + s)); the statistic s is then Δφ/(2π),
divided inside autograd so that dphi chains through it. In float32 this
rounds the cosine's argument in another place, about one ulp of an
argument of ~250 rad (~1.5e-5 rad).

The dtype route is ops/_build's: CPU or float64 tensors run the kernels'
plain twins, float32 CUDA tensors launch the kernels or raise. x, V, A and
B are cast to the parameters' dtype, as the JAX functions cast them to
their compute dtype. bfloat16 and float16 parameters, which the JAX
functions compute in float32, raise a TypeError: sub-float32 precision is
not ported (ROADMAP item 5).
"""
import numpy as np
import torch

from . import block_mosm
from .mosm_gram import mosm_gram as _mosm_gram_pairstats
from .mosm_matvec import mosm_gram_matvec_pairstats

_two_pi = 2.0 * np.pi


def _dtype(name, w):
    """The parameters' dtype, float32 or float64; raises for sub-float32."""
    if w.dtype in (torch.bfloat16, torch.float16):
        raise TypeError("%s: %s parameters are not ported; sub-float32 precision is ROADMAP "
                        "item 5 (use float32 or float64)" % (name, w.dtype))
    return w.dtype


def _ids(c):
    return c.reshape(-1).to(torch.int32).contiguous()


def _data(t, dtype):
    """A constant input (x, V, A, B) as a contiguous tensor of dtype."""
    return t.detach().to(dtype).contiguous()


def pair_stats(w, mu, var, theta, phi, twopi, phase_inside):
    """block_mosm.mosm_pair_stats, with the phase statistic Δφ/(2π) when
    phase_inside is False (the kernels compute cos(2π(a + st2[..., 1])))."""
    st3, st2 = block_mosm.mosm_pair_stats(w, mu, var, theta, phi, twopi)
    if not phase_inside:
        st2 = torch.stack([st2[..., 0], st2[..., 1] / _two_pi], dim=-1)
    return st3, st2


def mosm_gram(x1, c1, x2, c2, w, mu, var, theta, phi, twopi, phase_inside, input_grads=False):
    """(N, M) MOSM Gram K(x1, x2) for channel IDs c1 (N,), c2 (M,) in any
    order, x1 (N, D), x2 (M, D), parameters w (O, Q), mu/var/theta
    (O, Q, D), phi (O, Q) and twopi = (2π)^(D/2). Differentiable in the
    parameters by autograd, and in x1 and x2 when input_grads is True (the
    sparse models' trained inducing points); otherwise x1 and x2 are
    constants, as in the JAX function, whose input cotangents are zero.
    Returns the parameters' dtype."""
    dtype = _dtype("mosm_gram", w)
    if not input_grads:
        x1, x2 = x1.detach(), x2.detach()
    st3, st2 = pair_stats(*(p.to(dtype) for p in (w, mu, var, theta, phi)), twopi, phase_inside)
    return _mosm_gram_pairstats(x1.to(dtype).contiguous(), _ids(c1), x2.to(dtype).contiguous(),
                                _ids(c2), st3, st2)


def mosm_gram_matvec(x1, c1, x2, c2, w, mu, var, theta, phi, twopi, phase_inside, V):
    """K(x1, x2)·V with V (M, R), the Gram never formed (K-gram-matvec),
    arguments as mosm_gram. Not differentiable (the JAX function has no
    VJP): computed under torch.no_grad(). Returns the parameters' dtype."""
    dtype = _dtype("mosm_gram_matvec", w)
    with torch.no_grad():
        st3, st2 = pair_stats(*(p.detach().to(dtype) for p in (w, mu, var, theta, phi)), twopi,
                              phase_inside)
        return mosm_gram_matvec_pairstats(_data(x1, dtype), _ids(c1), _data(x2, dtype), _ids(c2),
                                          st3, st2, _data(V, dtype))


def stats_vjp(params, twopi, phase_inside, dst3, dst2):
    """Parameter cotangents (dw, dmu, dvar, dtheta, dphi) from cotangents of
    pair_stats(*params, twopi, phase_inside), by autograd.

    The Δθ and Δφ statistics of a diagonal pair (θ_a − θ_a, φ_a − φ_a) are
    constantly 0, so their cotangents carry no parameter gradient. They are
    set to 0 before the chain: otherwise the chain subtracts each from
    itself, which in float32 can lose the digits of the other pairs' terms."""
    diag = torch.arange(dst3.shape[0], device=dst3.device)
    dst3, dst2 = dst3.clone(), dst2.clone()
    dst3[diag, diag, :, :, 2] = 0.0
    dst2[diag, diag, :, 1] = 0.0
    params = [p.detach().requires_grad_() for p in params]
    with torch.enable_grad():
        st3, st2 = pair_stats(*params, twopi, phase_inside)
        return tuple(torch.autograd.grad((st3, st2), params, (dst3, dst2)))


def mosm_gram_lowrank_vjp(x1, c1, x2, c2, w, mu, var, theta, phi, twopi, phase_inside, A, B):
    """Parameter cotangents (dw, dmu, dvar, dtheta, dphi) of mosm_gram for
    the Gram cotangent dK = A·Bᵀ, A (N, R), B (M, R), without forming dK
    (K-gram-lowrank-vjp, then stats_vjp), in the parameters' dtype. The
    channel counts of c1 and c2 are read on the host once a call (the JAX
    signature carries none)."""
    dtype = _dtype("mosm_gram_lowrank_vjp", w)
    params = [p.detach().to(dtype) for p in (w, mu, var, theta, phi)]
    with torch.no_grad():
        st3, st2 = pair_stats(*params, twopi, phase_inside)
        dst3, dst2 = block_mosm.mosm_gram_lowrank_vjp_pairstats(
            _data(x1, dtype), _ids(c1), _data(x2, dtype), _ids(c2), st3, st2, _data(A, dtype),
            _data(B, dtype))
    return stats_vjp(params, twopi, phase_inside, dst3, dst2)
