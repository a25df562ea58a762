"""Helpers of the port's parity tests (tests/test_torch_*.py) for their JAX
reference computations.

`jit` compiles one with XLA's backend optimizations off. A reference
computation runs once or a few times at small shapes, so XLA:CPU's
optimizing compile is most of its cost. Unoptimized, the same program
compiles several times faster and agrees with the optimized build to about
1e-12 relative, far inside the tests' 1e-7. The option goes to these
compiles only: no process-wide JAX setting changes.

`once_per_run` computes a module's reference answers once per test run,
however many parallel worker processes (pytest-xdist) run that module's
tests: the suite's scheduler hands consecutive tests to different workers,
and each would otherwise compute the module fixture again.
"""
import os
import pickle

import jax
import numpy as np
from filelock import FileLock

UNOPTIMIZED = {"xla_backend_optimization_level": 0}


def jit(fn):
    """fn under jax.jit, compiled with UNOPTIMIZED at the first call's
    argument shapes; later calls must have the same shapes and dtypes."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(UNOPTIMIZED))
        return compiled[0](*args)

    return call


def raws_and_names(model):
    """A JAX model's raw parameters (numpy) and names, what
    gpr.load_raw_state carries into the port: a picklable stand-in for the
    model in answers shared by once_per_run."""
    return dict(raws=[np.asarray(r) for r in model.raw_state()],
                names=[p.name for p in model.parameters()])


def once_per_run(tmp_path_factory, name, compute):
    """compute() (numpy arrays and Python values only) once per test run:
    the first worker to ask computes it and pickles it into the run's base
    temporary directory, shared by its workers; the others wait on the lock
    and load it. Without xdist, compute() runs in place."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return compute()
    path = tmp_path_factory.getbasetemp().parent / (name + ".pkl")
    with FileLock(str(path) + ".lock"):
        if path.is_file():
            with open(path, "rb") as f:
                return pickle.load(f)
        data = compute()
        with open(path, "wb") as f:
            pickle.dump(data, f)
    return data
