"""Shifted-window primitives over interior-only arrays.

These replace the reference's ghost-padded array accesses
(include/cedar/array.h, include/cedar/grid_quantity.h): instead of storing a
ghost ring and exchanging it (MSG/Tausch halo, SURVEY §2.3), every stencil
read is a static shifted window.  Under `jit` with sharded inputs, XLA's SPMD
partitioner turns these shifts into exactly the halo exchanges Cedar performs
with MPI — but fused into the surrounding compute and scheduled automatically
over the device links.

``shift(a, (dz, dw))`` returns ``out[z, w] = a[z+dz, w+dw]`` with
out-of-range reads giving 0 (Dirichlet ghosts) or wrapping (periodic).
"""

from __future__ import annotations

import jax.numpy as jnp


def shift(a: jnp.ndarray, offsets, periodic=None) -> jnp.ndarray:
    """N-D static shift: ``out[idx] = a[idx + offsets]``.

    Out-of-range elements are 0 for non-periodic axes and wrap around for
    periodic axes.  ``offsets`` has one entry per array axis; extra leading
    axes of `a` relative to ``offsets`` are treated as batch axes.

    Implemented as pad+slice (Dirichlet) / roll (periodic); XLA fuses these
    into neighboring elementwise ops and, under SPMD sharding, lowers the
    boundary region to a collective-permute of the halo slab.
    """
    ndim = a.ndim
    noff = len(offsets)
    lead = ndim - noff
    if periodic is None:
        periodic = (False,) * noff

    out = a
    # periodic axes: roll (out[z] = a[z+d] == roll(a, -d))
    for ax in range(noff):
        d = int(offsets[ax])
        if d != 0 and periodic[ax]:
            out = jnp.roll(out, -d, axis=lead + ax)

    # Uniform unit pad on EVERY non-periodic trailing axis (even zero-offset
    # ones) as long as all offsets are within ±1: every shift of the same
    # array then produces an IDENTICAL pad op that XLA CSEs into one
    # materialization, with the per-offset windows fused into consumers
    # (offset-dependent pads defeat CSE and cost an HBM round trip per
    # shifted read — measured 2x effective-bandwidth loss on the 2D
    # residual).
    pad_axes = [
        ax for ax in range(noff)
        if not periodic[ax] and int(offsets[ax]) != 0
    ]
    if not pad_axes:
        return out
    if all(abs(int(offsets[ax])) <= 1 for ax in range(noff)):
        pad_width = [(0, 0)] * lead + [
            (0, 0) if periodic[ax] else (1, 1) for ax in range(noff)
        ]
        slices = [slice(None)] * lead
        for ax in range(noff):
            d = int(offsets[ax])
            n = a.shape[lead + ax]
            if periodic[ax]:
                slices.append(slice(None))
            else:
                slices.append(slice(1 + d, 1 + d + n))
        return jnp.pad(out, pad_width)[tuple(slices)]

    pad_width = [(0, 0)] * lead
    slices = [slice(None)] * lead
    for ax in range(noff):
        d = int(offsets[ax])
        n = a.shape[lead + ax]
        if d == 0 or periodic[ax]:
            pad_width.append((0, 0))
            slices.append(slice(None))
        else:
            p = abs(d)
            pad_width.append((p, p))
            slices.append(slice(p + d, p + d + n))
    return jnp.pad(out, pad_width)[tuple(slices)]


def shift2(a, dz, dw, periodic=(False, False)):
    """2D shift acting on the last two axes."""
    return shift(a, (dz, dw), periodic)


def shift3(a, d0, d1, d2, periodic=(False, False, False)):
    """3D shift acting on the last three axes."""
    return shift(a, (d0, d1, d2), periodic)


def coarse_sample(a: jnp.ndarray, offsets, nc, periodic=None) -> jnp.ndarray:
    """Sample a fine-grid array at ``fine = 2*coarse + offset``.

    Returns ``out[c0, c1, ...] = a[2*c0 + off0, 2*c1 + off1, ...]`` on the
    coarse grid of shape ``nc`` (one entry per trailing axis), with
    out-of-range fine reads 0 (or wrapped, per ``periodic``).  This is the
    building block of restriction and of the generic Galerkin (RAP) product
    (see :mod:`cedar_jax.ops.galerkin`), where the reference instead
    hand-expands the index algebra (src/2d/ftn/BMG2_SymStd_SETUP_ITLI_ex.f90).
    """
    ndim = a.ndim
    noff = len(offsets)
    lead = ndim - noff
    if periodic is None:
        periodic = (False,) * noff

    out = a
    # First apply the offset as a shift, then take the even-strided slice.
    out = shift(out, offsets, periodic)
    slc = [slice(None)] * lead
    for ax in range(noff):
        n = out.shape[lead + ax]
        want = nc[ax]
        # even indices 0, 2, ..., 2*(want-1); fine grid always has
        # 2*(want-1) <= n-1 + possible offset overhang handled by shift
        slc.append(slice(0, 2 * want - 1 if 2 * want - 1 <= n else n, 2))
    out = out[tuple(slc)]
    # pad (with zeros) if the strided slice came up short of the coarse shape
    pads = [(0, 0)] * lead
    short = False
    for ax in range(noff):
        have = out.shape[lead + ax]
        pads.append((0, nc[ax] - have))
        short = short or have < nc[ax]
    if short:
        out = jnp.pad(out, pads)
    return out


def interleave2(parts: dict, nx: int, ny: int) -> jnp.ndarray:
    """Assemble a fine 2D array from its four parity classes.

    ``parts[(pz, pw)]`` holds values for fine points with
    ``z % 2 == pz, w % 2 == pw`` in natural order.  Missing classes are
    treated as zero.  Inverse of strided slicing; implemented with
    stack+reshape (transposes, no scatter).
    """
    nzs = ((nx + 1) // 2, nx // 2)  # counts of even / odd z indices
    nws = ((ny + 1) // 2, ny // 2)
    dtype = None
    for v in parts.values():
        dtype = v.dtype
        break
    cols = []
    mz = max(nzs)
    mw = max(nws)
    for pz in (0, 1):
        row = []
        for pw in (0, 1):
            v = parts.get((pz, pw))
            if v is None:
                v = jnp.zeros((mz, mw), dtype)
            else:
                v = jnp.pad(v, ((0, mz - v.shape[0]), (0, mw - v.shape[1])))
            row.append(v)
        cols.append(jnp.stack(row, axis=-1))  # (mz, mw, 2)
    stacked = jnp.stack(cols, axis=1)  # (mz, 2, mw, 2)
    out = stacked.reshape(2 * mz, 2 * mw)
    return out[:nx, :ny]


def interleave3(parts: dict, n0: int, n1: int, n2: int) -> jnp.ndarray:
    """3D analogue of :func:`interleave2` over eight parity classes."""
    ms = ((n0 + 1) // 2, (n1 + 1) // 2, (n2 + 1) // 2)
    dtype = None
    for v in parts.values():
        dtype = v.dtype
        break
    planes = []
    for p0 in (0, 1):
        rows = []
        for p1 in (0, 1):
            row = []
            for p2 in (0, 1):
                v = parts.get((p0, p1, p2))
                if v is None:
                    v = jnp.zeros(ms, dtype)
                else:
                    v = jnp.pad(
                        v,
                        tuple(
                            (0, ms[ax] - v.shape[ax]) for ax in range(3)
                        ),
                    )
                row.append(v)
            rows.append(jnp.stack(row, axis=-1))  # (m0,m1,m2,2)
        planes.append(jnp.stack(rows, axis=2))  # (m0,m1,2,m2,2)
    stacked = jnp.stack(planes, axis=1)  # (m0,2,m1,2,m2,2)
    out = stacked.reshape(2 * ms[0], 2 * ms[1], 2 * ms[2])
    return out[:n0, :n1, :n2]
