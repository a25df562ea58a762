"""L-BFGS with a zoom line search, on one flat parameter vector.

JAX counterpart: optax.lbfgs() as mogptk_tpu/gpr/training.py uses it
(`_make_optimizer` :29-31, `_build_lbfgs_step` :39-56): the chain
scale_by_lbfgs(memory_size=10, scale_init_precond=True) → scale(-1) →
scale_by_zoom_linesearch(max_linesearch_steps=20,
initial_guess_strategy='one'), with the value and gradient of the accepted
step reused by the next iteration (optax.value_and_grad_from_state). This
module follows optax 0.2's semantics step for step, in plain torch:

- the direction is the two-loop recursion over a ring buffer of the last
  `memory_size` differences of parameters and gradients
  (optax/_src/transform.py `_precondition_by_lbfgs`, `scale_by_lbfgs`),
  with an identity scale capped by the reciprocal of the gradient norm at
  the first iteration and δwᵀδu / δuᵀδu after it;
- the step size comes from the zoom line search of Nocedal and Wright
  (algorithms 3.5 and 3.6; optax/_src/linesearch.py `zoom_linesearch`):
  an interval search from step 1 that doubles the step, then a zoom by
  cubic, quadratic or bisection interpolation, in that order of choice,
  until the sufficient decrease (or Hager and Zhang's approximate decrease)
  and the curvature conditions hold. On failure it takes the safe step, the
  largest-decrease step seen that met the decrease condition. A non-finite
  trial value counts as outside the domain (decrease error = inf); nothing
  raises.

The vectors stay on their device in their dtype; the line search's scalars
(values, slopes, step sizes) are float64 numbers on the host, one read of
the device per evaluation.
"""
import numpy as np
import torch

# the zoom line search's settings, optax.lbfgs()'s: at most 20 evaluations,
# the step doubled while the interval is searched, the sufficient-decrease,
# curvature and approximate-decrease tolerances, and the interval width
# below which a step with sufficient decrease is taken
MAX_LINESEARCH_STEPS = 20
INCREASE_FACTOR = 2.0
SLOPE_RTOL, CURV_RTOL, APPROX_DEC_RTOL = 1e-4, 0.9, 1e-6
STEPSIZE_PRECISION = 1e-5


class LBFGS:
    """L-BFGS state and iteration.

    Args:
        memory_size: the number of past differences kept.
        scale_init_precond: scale the initial inverse Hessian by
            δwᵀδu / δuᵀδu (and, at the first iteration, by
            min(1, 1/|g|)); else the identity.

    After each step(), `linesearch_steps` is the number of evaluations
    its line search made (optax: ZoomLinesearchInfo.num_linesearch_steps)."""

    def __init__(self, memory_size=10, scale_init_precond=True):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.memory_size = int(memory_size)
        self.scale_init_precond = scale_init_precond
        self.count = 0
        self.linesearch_steps = 0
        # the value and gradient at the current x, from the last line search
        self._value, self._grad = np.inf, None

    def step(self, fun, x):
        """One iteration from the flat vector x. fun(x) returns the value (a
        0-d tensor) and the gradient (a tensor like x). Returns the new x and
        the value at x."""
        value, grad = self._value, self._grad
        if not np.isfinite(value):
            value, grad = fun(x)
            value = float(value)
        direction = -1.0 * self._precondition(grad, x)
        stepsize, self._value, self._grad = self._zoom(fun, x, direction, value, grad)
        return x + stepsize * direction, value

    def _precondition(self, grad, x):
        """scale_by_lbfgs's update: store the newest differences in the ring
        buffers, then the two-loop product of the inverse-Hessian estimate
        with grad."""
        m = self.memory_size
        idx, prev = self.count % m, (self.count - 1) % m
        if self.count == 0:
            self._dw, self._du = x.new_zeros((m,) + x.shape), x.new_zeros((m,) + x.shape)
            self._rho = x.new_zeros(m)
            dw, du, rho = torch.zeros_like(x), torch.zeros_like(x), x.new_zeros(())
        else:
            dw, du = x - self._params, grad - self._updates
            d = torch.dot(du, dw)
            rho = torch.where(d == 0.0, torch.zeros_like(d), 1.0 / d)
        self._dw[prev], self._du[prev], self._rho[prev] = dw, du, rho
        if not self.scale_init_precond:
            gamma = 1.0
        elif self.count > 0:
            den = torch.dot(du, du)
            gamma = torch.where(den > 0.0, torch.dot(du, dw) / den, torch.ones_like(den))
        else:
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        order = [(idx + k) % m for k in range(m)]
        vec, alphas = grad, {}
        for i in reversed(order):
            alphas[i] = self._rho[i] * torch.dot(self._dw[i], vec)
            vec = vec + (-alphas[i]) * self._du[i]
        vec = gamma * vec
        for i in order:
            beta = self._rho[i] * torch.dot(self._du[i], vec)
            vec = vec + (alphas[i] - beta) * self._dw[i]
        self._params, self._updates = x, grad
        self.count += 1
        return vec

    @staticmethod
    def _errors(stepsize, value, slope, value_init, slope_init):
        """The decrease and curvature errors of a trial step, each max(·, 0)
        and inf where NaN (optax's _compute_decrease_error and
        _compute_curvature_error): the decrease is Armijo's or, near the
        minimum, Hager and Zhang's approximate one, whichever holds."""
        dec = value - value_init - SLOPE_RTOL * stepsize * slope_init
        approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
        delta = value - value_init - APPROX_DEC_RTOL * np.abs(value_init)
        dec = np.maximum(np.minimum(np.maximum(approx, delta), dec), 0.0)
        dec = np.inf if np.isnan(dec) else dec
        curv = np.maximum(np.abs(slope) - CURV_RTOL * np.abs(slope_init), 0.0)
        curv = np.inf if np.isnan(curv) else curv
        return dec, curv

    def _zoom(self, fun, x, u, value_init, grad_init):
        """The zoom line search along u from x. Returns the step size and the
        value and gradient at the accepted step; sets linesearch_steps."""
        f64 = np.float64
        with np.errstate(all="ignore"):
            slope_init = f64(torch.dot(u, grad_init))
            value_init = f64(value_init)
            step, value, grad, slope = f64(0.0), value_init, grad_init, slope_init
            low, value_low, slope_low = f64(0.0), value_init, slope_init
            high, value_high, slope_high = f64(0.0), value_init, slope_init
            cubic_ref, value_cubic_ref = f64(0.0), value_init
            safe_step, safe_value, safe_grad = f64(0.0), value_init, grad_init
            dec = np.inf
            interval_found = False
            count = 0
            while True:
                if not interval_found:
                    # interval search, algorithm 3.5
                    new = f64(1.0) if count == 0 else INCREASE_FACTOR * step
                    v, g, s = self._on_line(fun, x, new, u)
                    dec, curv = self._errors(new, v, s, value_init, slope_init)
                    error = np.maximum(dec, curv)
                    if dec <= 0.0:
                        safe_step, safe_value, safe_grad = new, v, g
                    set_high = dec > 0.0 or (v >= value and count > 0)
                    set_low = s >= 0.0 and not set_high
                    if set_low:
                        low, value_low, slope_low = new, v, s
                        high, value_high, slope_high = step, value, slope
                    else:
                        low, value_low, slope_low = step, value, slope
                        high, value_high, slope_high = new, v, s
                    cubic_ref, value_cubic_ref = low, value_low
                    interval_found = set_high or set_low or error <= 0.0
                    done = error <= 0.0
                    failed = count + 1 >= MAX_LINESEARCH_STEPS and not done
                else:
                    # zoom, algorithm 3.6
                    delta = np.abs(high - low)
                    left, right = np.minimum(high, low), np.maximum(high, low)
                    cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                                      cubic_ref, value_cubic_ref)
                    quad = _quadmin(low, value_low, slope_low, high, value_high)
                    if left + 0.2 * delta < cubic < right - 0.2 * delta:
                        new = cubic
                    elif left + 0.1 * delta < quad < right - 0.1 * delta:
                        new = quad
                    else:
                        new = (low + high) / 2.0
                    v, g, s = self._on_line(fun, x, new, u)
                    dec, curv = self._errors(new, v, s, value_init, slope_init)
                    error = np.maximum(dec, curv)
                    if dec <= 0.0 and v < safe_value:
                        safe_step, safe_value, safe_grad = new, v, g
                    done = error <= 0.0
                    set_high_to_new = dec > 0.0 or v >= value_low
                    set_high_to_low = s * (high - low) >= 0.0 and not set_high_to_new
                    if set_high_to_new or set_high_to_low:
                        cubic_ref, value_cubic_ref = high, value_high
                    else:
                        cubic_ref, value_cubic_ref = low, value_low
                    if set_high_to_new:
                        high, value_high, slope_high = new, v, s
                    elif set_high_to_low:
                        high, value_high, slope_high = low, value_low, slope_low
                    if not set_high_to_new:
                        low, value_low, slope_low = new, v, s
                    failed = not done and (count + 1 >= MAX_LINESEARCH_STEPS
                                           or (delta <= STEPSIZE_PRECISION and safe_step > 0.0))
                step, value, grad, slope = new, v, g, s
                count += 1
                if failed and (safe_step > 0.0 or np.isinf(dec)):
                    # the safe step: the best sufficient decrease seen, or no
                    # step where every trial left the domain
                    step, value, grad = safe_step, safe_value, safe_grad
                if done or failed:
                    break
        self.linesearch_steps = count
        return float(step), float(value), grad

    @staticmethod
    def _on_line(fun, x, stepsize, u):
        """The value, gradient and slope along u at x + stepsize·u."""
        value, grad = fun(x + float(stepsize) * u)
        v, s = torch.stack([value.to(grad.dtype), torch.dot(grad, u)]).tolist()
        return np.float64(v), grad, np.float64(s)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN where there is none (optax's _cubicmin)."""
    C = fpa
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0, r1 = fb - fa - C * db, fc - fa - C * dc
    A = (dc ** 2 * r0 - db ** 2 * r1) / denom
    B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * C)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The critical point of the quadratic through (a, fa), (b, fb) with
    slope fpa at a (optax's _quadmin)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)
