"""Process configuration: dtype, device, seed and kernel routing.

JAX counterpart: mogptk_tpu/gpr/config.py. The TPU-only switches
(`pallas_enabled`, matmul-precision scopes, compilation caches) have no
counterpart here: on CUDA the hand-written kernels are chosen from the tensor's
device, and float32 matmuls stay full float32 (TF32 is never enabled by this
package).
"""
import numpy as np
import torch


class Config:
    """Process-global configuration.

    Attributes:
        dtype: floating dtype of parameters and data. None (the default) is
            the JAX package's auto rule, float32 unless float64 is asked for
            (use_double_precision): the type of the CUDA kernels.
        device: default device for models, data helpers and training: the
            card ("cuda"). On a machine without CUDA every entry point raises
            unless the caller asks for the CPU (device="cpu", or
            config.device = "cpu", as the CPU tests do).
        positive_minimum: lower bound of positive-constrained parameters.
        seed: seed of the package's torch.Generator and of its numpy
            Generator (numpy_rng), which draws host-side initial parameters
            and data removals as in the JAX package.
        blocked_cholesky: None = auto (CUDA, float32, n >= blocked_cholesky_min_n
            and n a multiple of blocked_cholesky_block), True/False to force.
    """

    def __init__(self):
        self._dtype = None
        self.device = "cuda"
        self.positive_minimum = 1e-8
        self.seed = 0
        self._generator = None
        self._np_rng = None
        self.blocked_cholesky = None
        self.blocked_cholesky_block = 512
        self.blocked_cholesky_min_n = 4096

    @property
    def dtype(self):
        return torch.float32 if self._dtype is None else self._dtype

    @dtype.setter
    def dtype(self, value):
        self._dtype = value

    def generator(self, device=None):
        """The package's torch.Generator, seeded from `seed` on first use."""
        device = resolve_device(device)
        if self._generator is None or self._generator.device != device:
            self._generator = torch.Generator(device=device)
            self._generator.manual_seed(self.seed)
        return self._generator

    def numpy_rng(self):
        """The package's numpy Generator, np.random.default_rng(seed) on
        first use (JAX: gpr/config.py Config.numpy_rng): the same seed draws
        the same initial parameters in both packages."""
        if self._np_rng is None:
            self._np_rng = np.random.default_rng(self.seed)
        return self._np_rng


config = Config()


def resolve_device(device=None):
    """torch.device for `device` (None = config.device). Raises when CUDA is
    asked for and this process has no CUDA device."""
    device = torch.device(config.device if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device %s requested but torch.cuda.is_available() is False; "
                           "pass device=\"cpu\" to run on the CPU" % device)
    return device


def set_seed(seed):
    """Seed the package's random state (the analog of the reference's
    torch.manual_seed): the torch.Generator and the numpy Generator."""
    config.seed = int(seed)
    config._generator = None
    config._np_rng = np.random.default_rng(config.seed)


def use_single_precision():
    """Use float32 for parameters, data and compute (the H100 kernels' type)."""
    config.dtype = torch.float32


def use_double_precision():
    """Use float64 (the original mogptk default; plain torch on every device)."""
    config.dtype = torch.float64


def use_blocked_cholesky(enable=True, block_size=None, min_n=None):
    """Force the blocked Cholesky on or off; None restores the auto policy.
    Tests force it at small n on the CPU, where it runs the kernels' plain
    twins."""
    config.blocked_cholesky = enable
    if block_size is not None:
        config.blocked_cholesky_block = int(block_size)
    if min_n is not None:
        config.blocked_cholesky_min_n = int(min_n)


def blocked_cholesky_enabled(n, device, dtype):
    """Route an (n, n) factorization on `device` in `dtype`: the blocked path
    with the hand-written kernels runs on CUDA float32 for n >= min_n with n
    a multiple of the block, unless forced either way."""
    if config.blocked_cholesky is not None:
        return bool(config.blocked_cholesky)
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and n >= config.blocked_cholesky_min_n
            and n % config.blocked_cholesky_block == 0)
