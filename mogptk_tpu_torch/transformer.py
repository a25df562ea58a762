"""Invertible Y-data transformation pipeline.

Capability parity with the reference's transformer layer
(mogptk/transformer.py:4-153): a `Transformer` holds an ordered stack of
invertible transforms applied to Y before training and undone after
prediction. This is host-side NumPy preprocessing, outside the device compute
path, so the redesign here is structural rather than numerical: the three
purely-affine transforms (Linear / Normalize / Standard) share one affine
base class, and Detrend is expressed through `numpy.polynomial.Polynomial`.

A copy of mogptk_tpu/transformer.py (framework-free), kept in this package so
that it imports nothing of the JAX package.
"""
import copy
import numpy as np


class TransformBase:
    """A single invertible transform.

    Subclasses implement `_apply` / `_invert` (and `_fit` when the transform
    has data-dependent state). `forward`/`backward`/`set_data` are the public
    names the data layer calls.
    """

    def _fit(self, y, x):
        pass

    def _apply(self, y, x):
        raise NotImplementedError

    def _invert(self, y, x):
        raise NotImplementedError

    # public API (reference names)
    def set_data(self, y, x=None):
        self._fit(y, x)

    def forward(self, y, x=None):
        return self._apply(y, x)

    def backward(self, y, x=None):
        return self._invert(y, x)


class Transformer:
    """Ordered stack of transforms, composed left to right.

    `append` fits the new transform on the data as seen *after* the existing
    stack, so each transform operates in its predecessor's output space.
    """

    def __init__(self, transformers=None):
        if transformers is None:
            stack = []
        elif isinstance(transformers, (list, tuple)):
            stack = list(transformers)
        else:
            stack = [transformers]
        for t in stack:
            self._check(t)
        self.transformers = stack

    @staticmethod
    def _check(t):
        if not isinstance(t, TransformBase):
            raise ValueError("transformer must be a TransformBase instance, got %r"
                             % (type(t).__name__,))

    def __len__(self):
        return len(self.transformers)

    def __iter__(self):
        return iter(self.transformers)

    def append(self, t, y, x=None):
        # accept a class (instantiate fresh) or an instance (copy, so the
        # caller's object is never mutated by fitting)
        t = t() if isinstance(t, type) else copy.deepcopy(t)
        self._check(t)
        t.set_data(self.forward(y, x), x)
        self.transformers.append(t)

    def forward(self, y, x=None):
        for t in self.transformers:
            y = t.forward(y, x)
        return y

    def backward(self, y, x=None):
        for t in reversed(self.transformers):
            y = t.backward(y, x)
        return y


class _AffineTransform(TransformBase):
    """Shared implementation for transforms of the form y → (y − offset)/scale.

    Subclasses set `offset`/`scale` in __init__ or `_fit`.
    """

    offset = 0.0
    scale = 1.0

    def _apply(self, y, x):
        return (y - self.offset) / self.scale

    def _invert(self, y, x):
        return y * self.scale + self.offset


class TransformLinear(_AffineTransform):
    """Fixed affine map y → (y − bias)/slope (reference: transformer.py:78-93)."""

    def __init__(self, bias=0.0, slope=1.0):
        self.offset = bias
        self.scale = slope

    # reference attribute names, kept for API parity (read AND write)
    @property
    def bias(self):
        return self.offset

    @bias.setter
    def bias(self, value):
        self.offset = value

    @property
    def slope(self):
        return self.scale

    @slope.setter
    def slope(self, value):
        self.scale = value

    def __repr__(self):
        return "TransformLinear(bias=%g, slope=%g)" % (self.offset, self.scale)


class TransformStandard(_AffineTransform):
    """Z-score whitening: zero mean, unit variance
    (reference: transformer.py:135-153)."""

    def _fit(self, y, x):
        self.offset = float(np.mean(y))
        self.scale = float(np.std(y))

    @property
    def mean(self):
        return self.offset

    @property
    def std(self):
        return self.scale

    def __repr__(self):
        return "TransformStandard(mean=%g, std=%g)" % (self.offset, self.scale)


class TransformNormalize(_AffineTransform):
    """Rescale Y onto [-1, 1] (reference: transformer.py:95-113).

    Affine form: offset = midpoint of the data range, scale = half-range.
    """

    def _fit(self, y, x):
        lo, hi = float(np.min(y)), float(np.max(y))
        self.offset = 0.5 * (lo + hi)
        self.scale = 0.5 * (hi - lo)

    @property
    def ymin(self):
        return self.offset - self.scale

    @property
    def ymax(self):
        return self.offset + self.scale

    def __repr__(self):
        return "TransformNormalize(min=%g, max=%g)" % (self.ymin, self.ymax)


class TransformDetrend(TransformBase):
    """Subtract a least-squares polynomial trend of the given degree along
    one input dimension (reference: transformer.py:47-76)."""

    def __init__(self, degree=1, input_dim=0):
        self.degree = degree
        self.dim = input_dim
        self._poly = None

    def _axis(self, x):
        if x is None:
            raise ValueError("TransformDetrend needs X to evaluate the trend")
        return x[:, self.dim]

    def _fit(self, y, x):
        self._poly = np.polynomial.Polynomial.fit(self._axis(x), y, self.degree)

    def _apply(self, y, x):
        return y - self._poly(self._axis(x))

    def _invert(self, y, x):
        return y + self._poly(self._axis(x))

    @property
    def coef(self):
        # highest-degree-first coefficients, as np.polyfit would return them
        return self._poly.convert().coef[::-1]

    def __repr__(self):
        return "TransformDetrend(degree=%g)" % (self.degree,)


class TransformLog(TransformBase):
    """Shifted, centered log: shift Y so its minimum sits at 1, take the log,
    and center it (reference: transformer.py:115-133)."""

    def _fit(self, y, x):
        self.shift = 1.0 - float(np.min(y))
        self.mean = float(np.mean(np.log(y + self.shift)))

    def _apply(self, y, x):
        return np.log(y + self.shift) - self.mean

    def _invert(self, y, x):
        return np.exp(y + self.mean) - self.shift

    def __repr__(self):
        return "TransformLog(shift=%g, mean=%g)" % (self.shift, self.mean)
