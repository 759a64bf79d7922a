"""Procedural, handle-based API (reference: include/cedar/capi.h).

The reference exposes a C interface with opaque handles — topo / operator
create-set-apply-dump / solver create-run-destroy
(include/cedar/2d/interface/c/{topo,operator,solver}.h,
src/2d/interface/c/solver.cc) — so host applications can drive the solver
without touching the C++ API.  This module is the same surface for Python
hosts: flat functions over integer handles, numpy in / numpy out, and a
mesh handle in place of the MPI communicator.  2D and 3D.

Example (mirrors examples/basic-2d-ser/poisson.cc):

    import cedar_jax.capi as capi
    topo = capi.bmg2_topo_create(256, 256)
    op = capi.bmg2_operator_create(topo)
    capi.bmg2_operator_set(op, coords, vals)   # (i, j, dir) triples
    slv = capi.bmg2_solver_create(op)
    capi.bmg2_solver_run(slv, x, b)
    capi.bmg2_solver_destroy(slv)
"""

from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np

from cedar_jax.config import Config
from cedar_jax.core.types import StencilKind
from cedar_jax.ops.stencil2 import matvec as matvec2
from cedar_jax.ops.stencil3 import matvec as matvec3
from cedar_jax.solver.solver2 import Solver2
from cedar_jax.solver.solver3 import Solver3

# direction enums (reference: 2d/base_types.h bmg2_dir, 3d cdr3_dir)
BMG2_O, BMG2_W, BMG2_S, BMG2_SW, BMG2_NW = 0, 1, 2, 3, 4
(BMG3_P, BMG3_PW, BMG3_PS, BMG3_B, BMG3_PSW, BMG3_PNW, BMG3_BW, BMG3_BNW,
 BMG3_BN, BMG3_BNE, BMG3_BE, BMG3_BSE, BMG3_BS, BMG3_BSW) = range(14)

_handles = {}
_next = itertools.count(1)


def _new(obj) -> int:
    h = next(_next)
    _handles[h] = obj
    return h


def _get(h):
    return _handles[h]


class _Topo:
    def __init__(self, shape, mesh=None, config=None):
        self.shape = tuple(int(n) for n in shape)
        self.mesh = mesh
        self.config = config or {}


class _Op:
    def __init__(self, topo: _Topo, ndim: int):
        self.topo = topo
        self.ndim = ndim
        ndir = 5 if ndim == 2 else 14
        self.so = np.zeros((ndir,) + topo.shape)
        self.kind = None  # decided at solver creation / apply

    def kind_of(self) -> StencilKind:
        if self.ndim == 2:
            five = not (self.so[BMG2_SW].any() or self.so[BMG2_NW].any())
            return StencilKind.five_pt if five else StencilKind.nine_pt
        seven = not self.so[4:].any()
        return (
            StencilKind.seven_pt if seven
            else StencilKind.twenty_seven_pt
        )


# -- topo ---------------------------------------------------------------------

def bmg2_topo_create(ngx: int, ngy: int, mesh=None, config=None) -> int:
    """reference: bmg2_topo_create (MPI comm -> optional device mesh)."""
    return _new(_Topo((ngx, ngy), mesh, config))


def bmg3_topo_create(ngx: int, ngy: int, ngz: int, mesh=None,
                     config=None) -> int:
    return _new(_Topo((ngx, ngy, ngz), mesh, config))


# -- operator -----------------------------------------------------------------

def bmg2_operator_create(topo: int) -> int:
    return _new(_Op(_get(topo), 2))


def bmg3_operator_create(topo: int) -> int:
    return _new(_Op(_get(topo), 3))


def bmg2_operator_set(op: int, coords, vals) -> None:
    """Set stencil entries; ``coords`` rows are (i, j, dir)
    (reference: bmg2_operator_set; 1-based interior indices like the
    reference's Fortran-facing convention are NOT used here — indices are
    0-based interior)."""
    o = _get(op)
    for (i, j, d), v in zip(coords, vals):
        o.so[int(d), int(i), int(j)] = v


def bmg3_operator_set(op: int, coords, vals) -> None:
    o = _get(op)
    for (i, j, k, d), v in zip(coords, vals):
        o.so[int(d), int(i), int(j), int(k)] = v


def bmg2_operator_set_full(op: int, so) -> None:
    """Bulk variant (no reference analogue; avoids per-entry loops)."""
    o = _get(op)
    so = np.asarray(so)
    o.so[: so.shape[0]] = so


bmg3_operator_set_full = bmg2_operator_set_full


def bmg2_operator_apply(op: int, x) -> np.ndarray:
    """b = A x (reference: bmg2_operator_apply -> UTILS_matvec)."""
    o = _get(op)
    mv = matvec2 if o.ndim == 2 else matvec3
    return np.asarray(
        mv(jnp.asarray(o.so), jnp.asarray(x), o.kind_of())
    )


bmg3_operator_apply = bmg2_operator_apply


def bmg2_operator_dump(op: int) -> np.ndarray:
    """Return the stored stencil (reference dumps to file; we return it)."""
    return _get(op).so.copy()


bmg3_operator_dump = bmg2_operator_dump


def bmg2_operator_destroy(op: int) -> None:
    _handles.pop(op, None)


bmg3_operator_destroy = bmg2_operator_destroy


# -- solver -------------------------------------------------------------------

def _solver_create(op_h: int, config, ndim: int) -> int:
    o = _get(op_h)
    conf = Config(config or o.topo.config)
    kind = o.kind_of()
    so = jnp.asarray(o.so)
    if o.topo.mesh is not None:
        from cedar_jax.parallel import DistSolver2, DistSolver3

        cls = DistSolver2 if ndim == 2 else DistSolver3
        slv = cls(so, kind, conf, o.topo.mesh)
    else:
        cls = Solver2 if ndim == 2 else Solver3
        slv = cls(so, kind, conf)
    return _new(slv)


def bmg2_solver_create(op: int, config=None) -> int:
    """reference: bmg2_solver_create (src/2d/interface/c/solver.cc)."""
    return _solver_create(op, config, 2)


def bmg3_solver_create(op: int, config=None) -> int:
    return _solver_create(op, config, 3)


def bmg2_solver_run(slv: int, x, b) -> np.ndarray:
    """x = solve(b) with initial guess x (reference: bmg2_solver_run).

    Returns the solution (also written into ``x`` when it is a numpy
    array, matching the reference's in-place semantics)."""
    s = _get(slv)
    out = np.asarray(s.solve(jnp.asarray(b), jnp.asarray(x)))
    if isinstance(x, np.ndarray):
        x[...] = out
    return out


bmg3_solver_run = bmg2_solver_run


def bmg2_solver_destroy(slv: int) -> None:
    _handles.pop(slv, None)


bmg3_solver_destroy = bmg2_solver_destroy
