"""Fused 2D multicolor sweep as a Pallas kernel for the GPU (Triton route).

The XLA formulation of multicolor relaxation (:mod:`cedar_jax.ops.relax2`)
is a `lax.scan` over color masks: every phase evaluates the whole stencil
over the whole grid and re-reads the stencil planes, ``q`` and ``b``, and
the residual the cycle needs next is one more pass.  This kernel runs ALL
color phases (and optionally that residual) in one pass: each program
loads a 2D window of ``so``, ``q`` and ``b``, runs the phases on the
window, and writes ``q`` (and ``r``) once.

Design:

* a program owns a power-of-two window ``(WX, WY)``; its central tile is
  written, the rest is halo.  Each color phase (and the residual) reads
  neighbours at distance 1, so the valid region shrinks by one cell per
  phase: the halo is ``ncolors + 1`` rows (rounded up to a multiple of 4
  columns, which keeps the column starts 16-byte aligned);
* windows load with masked ``load`` and zero fill beyond the grid edge,
  which is exactly the zero coupling the interior-only storage convention
  gives Dirichlet boundaries (the diagonal fills with 1 so the dead cells
  stay finite); at the low edge the window start clamps to 0 instead of
  reaching outside the grid;
* between phases the window's ``q`` goes through a per-program scratch
  buffer in device memory (L1/L2-resident in practice): a Triton program
  cannot shift a register tile, so the phase's neighbour reads are
  shifted loads from that buffer, fenced by block barriers;
* periodic axes are wrap-padded by the halo width in the wrapper, and the
  kernel's color masks use the wrapped (true) index;
* color masks anchor to GLOBAL indices (the reference anchors its MPI
  sweeps to iGs/jGs parity, BMG2_SymStd_relax_GS.f90:95-99), so the result
  equals the XLA sweep up to FMA contraction and rounding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from cedar_jax.core.types import Dir2, StencilKind
from cedar_jax.ops.stencil2 import NEIGHBOR_COUPLINGS, offsets_for

#: the window each program loads, (rows, columns), and its warps: the
#: fastest of six shapes tried in the whole 4096² solve on an H100
WINDOW = (32, 128)
NUM_WARPS = 8


def ncolors(kind: StencilKind) -> int:
    return 2 if kind == StencilKind.five_pt else 4


def halo(kind: StencilKind) -> tuple[int, int]:
    """(rows, cols) of halo: one cell per color phase plus one for the
    residual; columns rounded up to a multiple of 4."""
    h = ncolors(kind) + 1
    return h, -(-h // 4) * 4


def _color_order(kind: StencilKind, updown: str):
    if kind == StencilKind.five_pt:
        return [0, 1] if updown == "down" else [1, 0]
    return (
        [(0, 0), (0, 1), (1, 0), (1, 1)]
        if updown == "down"
        else [(1, 1), (1, 0), (0, 1), (0, 0)]
    )


def _axis_window(pid, tile, h, n, wrap_n, origin, w):
    """Window start, global indices, in-grid mask, owned mask and the
    true (color-anchoring) index along one axis."""
    start = jnp.maximum(pid * tile - h, 0)
    idx = start + jnp.arange(w, dtype=jnp.int32)
    inside = idx < n
    own = (idx >= pid * tile) & (idx < jnp.minimum(pid * tile + tile, n))
    true = idx + origin
    if wrap_n:
        # periodic: fold the wrap-pad back onto the true index; the
        # offset keeps the operand non-negative (C and Python ``%`` then
        # agree)
        true = (true + wrap_n * (-(-h // wrap_n))) % wrap_n
    return start, idx, inside, own, true


def _sweep_kernel(so_ref, q_ref, b_ref, *out_refs, kind, updown, nx, ny,
                  wx, wy, hx, hy, origin, wrap, fuse_residual, interpret):
    if fuse_residual:
        qo_ref, ro_ref, scr_ref = out_refs
    else:
        qo_ref, scr_ref = out_refs
    nine = kind != StencilKind.five_pt
    tx, ty = wx - 2 * hx, wy - 2 * hy
    px, py = pl.program_id(0), pl.program_id(1)
    prog = px * pl.num_programs(1) + py

    r0, ri, rin, rown, rtrue = _axis_window(px, tx, hx, nx, wrap[0],
                                            origin[0], wx)
    c0, ci, cin, cown, ctrue = _axis_window(py, ty, hy, ny, wrap[1],
                                            origin[1], wy)
    c0 = pl.multiple_of(c0, 4)
    inside = rin[:, None] & cin[None, :]

    def window(ref, plane, sz, sw, other):
        mask = (ri[:, None] + sz < nx) & (ci[None, :] + sw < ny)
        idx = (pl.ds(r0 + sz, wx), pl.ds(c0 + sw, wy))
        view = ref.at[(plane,) + idx] if plane is not None else ref.at[idx]
        return plt.load(view, mask=mask, other=other)

    q = window(q_ref, None, 0, 0, 0.0)
    b = window(b_ref, None, 0, 0, 0.0)
    diag = window(so_ref, Dir2.O, 0, 0, 1.0)
    rec = 1.0 / diag
    cpl = {}
    for off in offsets_for(kind):
        plane, sz, sw = NEIGHBOR_COUPLINGS[off]
        cpl[off] = window(so_ref, plane, sz, sw, 0.0)

    lr = jnp.arange(wx, dtype=jnp.int32)
    lc = jnp.arange(wy, dtype=jnp.int32)

    def barrier():
        if not interpret:
            plt.debug_barrier()

    def offdiag(q):
        """Σ couplings × neighbour q, the neighbours read back shifted
        from this program's scratch window (zero beyond the window)."""
        # int32 starts: one index type for the interpreter under x64
        one, four = jnp.int32(1), jnp.int32(4)
        plt.store(scr_ref.at[prog, pl.ds(one, wx), pl.ds(four, wy)], q)
        barrier()
        acc = None
        for off, c in cpl.items():
            dz, dw = off
            mask = (((lr + dz >= 0) & (lr + dz < wx))[:, None]
                    & ((lc + dw >= 0) & (lc + dw < wy))[None, :])
            qn = plt.load(
                scr_ref.at[prog, pl.ds(1 + dz, wx), pl.ds(4 + dw, wy)],
                mask=mask, other=0.0)
            term = c * qn
            acc = term if acc is None else acc + term
        barrier()
        return acc

    zp = (rtrue & 1)[:, None]
    wp = (ctrue & 1)[None, :]
    for color in _color_order(kind, updown):
        if nine:
            cw, cz = color
            mask = (wp == cw) & (zp == cz)
        else:
            mask = ((zp + wp) & 1) == color
        upd = (b + offdiag(q)) * rec
        q = jnp.where(mask & inside, upd, q)

    own = rown[:, None] & cown[None, :]
    out = (pl.ds(r0, wx), pl.ds(c0, wy))
    plt.store(qo_ref.at[out], q, mask=own)
    if fuse_residual:
        res = b + offdiag(q) - diag * q
        plt.store(ro_ref.at[out], res, mask=own)


def supported(shape, dtype, kind=StencilKind.nine_pt,
              periodic=(False, False)) -> bool:
    """Kernel applicability (else callers use the XLA path): float32
    only; periodic axes need at least one halo's extent."""
    if jnp.dtype(dtype) != jnp.dtype(jnp.float32):
        return False
    h = halo(kind)
    return all(n >= hh or not p for n, hh, p in zip(shape, h, periodic))


def point_relax(so, q, b, kind, updown, fuse_residual=False,
                periodic=(False, False), interpret=False):
    """One multicolor GS sweep (all colors), DOWN or UP ordering.

    Drop-in for :func:`cedar_jax.ops.relax2.point_relax` (the reciprocal
    diagonal is formed in the kernel).  With ``fuse_residual`` also
    returns ``b - A q`` of the swept iterate.  ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests)."""
    nx, ny = q.shape
    h = halo(kind)
    pads = [hh if p else 0 for hh, p in zip(h, periodic)]
    if any(pads):
        pw = ((pads[0], pads[0]), (pads[1], pads[1]))
        so = jnp.pad(so, ((0, 0),) + pw, mode="wrap")
        q = jnp.pad(q, pw, mode="wrap")
        b = jnp.pad(b, pw, mode="wrap")
    out = _point_relax_call(
        so, q, b, kind=kind, updown=updown, fuse_residual=fuse_residual,
        origin=(-pads[0], -pads[1]),
        wrap=(nx if pads[0] else 0, ny if pads[1] else 0),
        interpret=interpret,
    )
    if any(pads):
        crop = (slice(pads[0], pads[0] + nx), slice(pads[1], pads[1] + ny))
        out = tuple(o[crop] for o in out) if fuse_residual else out[crop]
    return out


@functools.partial(
    jax.jit, static_argnames=("kind", "updown", "fuse_residual", "origin",
                              "wrap", "interpret"),
)
def _point_relax_call(so, q, b, *, kind, updown, fuse_residual, origin,
                      wrap, interpret):
    nx, ny = q.shape
    wx, wy = WINDOW
    hx, hy = halo(kind)
    grid = (pl.cdiv(nx, wx - 2 * hx), pl.cdiv(ny, wy - 2 * hy))
    kernel = functools.partial(
        _sweep_kernel, kind=kind, updown=updown, nx=nx, ny=ny, wx=wx, wy=wy,
        hx=hx, hy=hy, origin=origin, wrap=wrap, fuse_residual=fuse_residual,
        interpret=interpret,
    )
    field = jax.ShapeDtypeStruct((nx, ny), q.dtype)
    # per-program window buffer, with a one-cell (row) / four-cell
    # (column) margin so every shifted read starts inside it
    scratch = jax.ShapeDtypeStruct((grid[0] * grid[1], wx + 2, wy + 8),
                                   q.dtype)
    outs = pl.pallas_call(
        kernel,
        grid=grid,
        out_shape=[field] * (2 if fuse_residual else 1) + [scratch],
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name=f"sweep2_{ncolors(kind)}c",
    )(so, q, b)
    if fuse_residual:
        return outs[0], outs[1]
    return outs[0]
