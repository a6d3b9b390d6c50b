"""CG iteration counts of the JAX package and the PyTorch port on the dense
SPD system of tests/test_precond.py (n = 400, condition 3e3, float64), on
the CPU: Jacobi and the Chebyshev preconditioner of degrees 3 and 5, the
JAX solve compiled at XLA's default backend optimization level and at
level 0.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/dense_cg_counts.py

prints one JSON line per degree.  Chebyshev's counts agree across the
three; Jacobi's hangs on the last bits of the matvec.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from adaptiveviscositysolver_tpu import operator as joperator
from adaptiveviscositysolver_tpu_torch import operator
from tests.test_precond import _spd_system

jax.config.update("jax_enable_x64", True)


def counts(degree: int, tol: float = 1e-8) -> dict:
    a, b = _spd_system()
    a_t, a_j = torch.tensor(a), jnp.asarray(a)
    _, it, _, _ = operator.pcg_flat(
        lambda t: {(0, 0): a_t @ t[(0, 0)]}, {(0, 0): torch.tensor(b)},
        {(0, 0): torch.zeros(len(b), dtype=torch.float64)}, {(0, 0): torch.tensor(np.diag(a))},
        tol, 10000, cheb_degree=degree)
    args = ({(0, 0): jnp.asarray(b)}, {(0, 0): jnp.zeros(len(b))},
            {(0, 0): jnp.asarray(np.diag(a))})
    fn = jax.jit(lambda r, x0, d: joperator.pcg_flat(
        lambda t: {(0, 0): a_j @ t[(0, 0)]}, r, x0, d, tol, 10000, cheb_degree=degree))
    out = {"cheb_degree": degree, "port": it}
    for name, opts in (("jax_default", None), ("jax_opt_level_0",
                                               {"xla_backend_optimization_level": 0})):
        compiled = fn.lower(*args).compile(compiler_options=opts) if opts else fn
        out[name] = int(compiled(*args)[1])
    return out


if __name__ == "__main__":
    for k in (1, 3, 5):
        print(json.dumps(counts(k)), flush=True)
