"""Solves through the fused Pallas sweep (interpreted) vs the XLA path.

The solver is built on the XLA backend and switched to the kernel before
its first solve (on the CPU an explicit ``pallas`` backend is refused), so
the V- and F-cycles, the fused pre-sweep residual and the fused
convergence residual all run the kernel body on every level.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from cedar_jax import FivePt, NinePt, Solver2, gallery
from cedar_jax.config import Config
from cedar_jax.solver import cycle2


def _pair(so, kind, solver_conf):
    conf = {"log": [], "kernels": {"backend": "xla"},
            "solver": {"tol": 1e-6, "max-iter": 5, **solver_conf}}
    ref = Solver2(so, kind, Config(conf))
    pal = Solver2(so, kind, Config(conf))
    pal.settings.kernel_backend = "pallas"
    pal.settings.kernel_interpret = True
    return ref, pal


@pytest.mark.parametrize("nine", [False, True])
@pytest.mark.parametrize("cycle", ["v", "f"])
def test_pallas_solver_matches_xla(nine, cycle):
    nx, ny = 65, 48
    kind = NinePt if nine else FivePt
    so = (gallery.fe(nx, ny, dtype=jnp.float32) if nine
          else gallery.poisson(nx, ny, dtype=jnp.float32))
    b = gallery.poisson_rhs(nx, ny, dtype=jnp.float32)
    ref, pal = _pair(so, kind, {"cycle": {"type": cycle, "nrelax-pre": 2,
                                          "nrelax-post": 1}})
    assert cycle2._use_pallas(pal.settings, kind, (nx, ny), jnp.float32,
                              (False, False))
    assert cycle2.fuse_final_ok(pal.levels, pal.kinds, (nx, ny),
                                jnp.float32, pal.settings, pal.periodic,
                                None) == (cycle == "v")
    x_ref = ref.solve(b)
    x_pal = pal.solve(b)
    # the kernel's sweeps equal XLA's up to FMA contraction, so the two
    # float32 solves agree to rounding
    assert len(ref.history) == len(pal.history)
    np.testing.assert_allclose(pal.history, ref.history, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(x_pal), np.asarray(x_ref),
                               atol=1e-5 * float(jnp.max(jnp.abs(x_ref))))
