"""Halo-exchange domain-decomposed causal march (parallel phase 2b).

The face-major wavefront (sweep.py) recast for a grid that is *sharded*
into x-slabs across a device-mesh axis — the design the reference's
disabled Cartesian topology hints at (mpi.F90:183-275, reorder=.false.
:69) and SURVEY.md §7.3.3 calls the hard part.  Unlike
parallel/domain.py's replicated march, here every O(N^3) field —
including the march state itself — lives sharded, so meshes larger than
one device's memory become tractable and the march work scales 1/ndom.

Key structural facts (derived from the wedge-fixup geometry of
_wavefront_plane_update, sweep.py:311-406) that make the communication
tiny:

  * z+/z-/y+/y- face planes have the grid x-axis as their first plane
    axis, so each device holds the m-row *strip* of those planes that
    overlaps its slab.  The causal shift toward the source along x needs
    exactly ONE halo row from each x-neighbor per shell; all b-axis
    shifts, weights, and the y-plane wedge fixups are strip-local.
  * The x+/x- face planes at shell d are single grid rows src_x +/- d,
    owned by one device.  Their interior update reads only the previous
    x-plane, and ALL their wedge-fixup inputs (py/my/pz/mz rows at
    ox = +/-d) live on the owning device's strips.  Ownership advances
    one row per shell, so the plane state is handed to the same-or-
    adjacent device: one ring ppermute per direction per shell.

Total per-shell communication: two ring ppermutes (halo rows + the x+
plane upward; halo rows + the x- plane downward).  The rate pass and
chemistry then run on the local slab exactly as in the replicated-march
domain layout (sweep.py _rate_pass row_ci path).

Validated bitwise against the replicated face-major march on virtual
CPU meshes (tests/test_parallel.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .. import constants as const
from ..config import RunConfig
from .sweep import SQRT2, SQRT3, SweepScalars, _mirror_b

Array = jax.Array


def _ring_perm(k: int, shift: int):
    return [(i, (i + shift) % k) for i in range(k)]


def _stage_strips(slab: Array, d_max: int) -> Array:
    """Stage a local (m, N, N) slab (axes: grid-x rows, centered y,
    centered z) into strip planes (d_max+1, 4, m, N) for faces
    (z+, z-, y+, y-) — the slab-local analogue of _stage_faces."""
    n = slab.shape[-1]
    c = n // 2
    dp = np.minimum(c + np.arange(d_max + 1), n - 1)   # edge-pad like
    dm = np.maximum(c - np.arange(d_max + 1), 0)       # _stage_faces
    zp = jnp.moveaxis(slab[:, :, dp], 2, 0)
    zm = jnp.moveaxis(slab[:, :, dm], 2, 0)
    yp = jnp.moveaxis(slab[:, dp, :], 1, 0)
    ym = jnp.moveaxis(slab[:, dm, :], 1, 0)
    return jnp.stack([zp, zm, yp, ym], axis=1)


def _interp(c1, c2, c3, c4, ta, tb, d, dtype):
    """The short-characteristics corner interpolation in the shell frame
    (column_density.f90:108-267 reduced to closed form; identical math to
    _wavefront_plane_update)."""
    sigma = const.SIGMA_HI_AT_ION_FREQ
    df = d.astype(dtype) if hasattr(d, "astype") else jnp.asarray(d, dtype)
    inv_d = 1.0 / df
    f_a = jnp.clip((df - jnp.abs(ta)) * inv_d, 0.0, 1.0)
    f_b = jnp.clip((df - jnp.abs(tb)) * inv_d, 0.0, 1.0)
    s1 = (1.0 - f_a) * (1.0 - f_b)
    s2 = f_a * (1.0 - f_b)
    s3 = (1.0 - f_a) * f_b
    s4 = f_a * f_b

    def wf(cd):
        return 1.0 / jnp.maximum(0.6, cd * sigma)

    w1 = s1 * wf(c1)
    w2 = s2 * wf(c2)
    w3 = s3 * wf(c3)
    w4 = s4 * wf(c4)
    cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / (w1 + w2 + w3 + w4)
    path = jnp.sqrt((ta * ta + tb * tb) * (inv_d * inv_d) + 1.0)
    return cdensi, path


def _diag_fix(cdensi, d, abs_a1, abs_b1, dtype):
    """Shell-1 sqrt(2)/sqrt(3) diagonal corrections
    (column_density.f90:152-158)."""
    diag = jnp.where(abs_a1 & abs_b1, SQRT3,
                     jnp.where(abs_a1 | abs_b1, SQRT2, 1.0)).astype(dtype)
    return jnp.where(d == 1, cdensi * diag, cdensi)


def _strip_update(prev, halo_below, halo_above, ndhi_p, lcol, d,
                  cfg: RunConfig, dr, ox: Array, n: int):
    """Advance the 4 strip faces (z+, z-, y+, y-) one shell.

    prev: (4, m, N) previous dominant planes (strip rows).
    halo_below/above: (4, N) rows r0-1 / r0+m from the x-neighbors.
    ox: (m,) centered x-offsets of the local rows.
    """
    dtype = prev.dtype
    c = n // 2
    ta = ox.astype(dtype)[None, :, None]
    itb = lax.broadcasted_iota(jnp.int32, (1, 1, n), 2) - c
    tb = itb.astype(dtype)
    pos_a = (ox >= 0)[None, :, None]
    pos_b = itb >= 0

    # causal shift toward the source along x: rows with ox>=0 read the
    # grid row below (r-1), ox<0 read above (r+1) — the halo rows supply
    # the slab boundaries; ring ppermute = grid periodicity.
    read_below = jnp.concatenate([halo_below[:, None, :], prev[:, :-1]], 1)
    read_above = jnp.concatenate([prev[:, 1:], halo_above[:, None, :]], 1)
    c3 = jnp.where(pos_a, read_below, read_above)

    def shift_b(x):
        up = jnp.roll(x, 1, axis=2)
        dn = jnp.roll(x, -1, axis=2)
        return jnp.where(pos_b, up, dn)

    c4 = prev
    c2 = shift_b(prev)
    c1 = shift_b(c3)

    cdensi, path = _interp(c1, c2, c3, c4, ta, tb, d, dtype)
    cdensi = _diag_fix(cdensi, d, jnp.abs(ox)[None, :, None] == 1,
                       jnp.abs(itb) == 1, dtype)
    coldensh_in = cdensi
    if cfg.use_lls and cfg.type_of_lls in (1, 2):
        coldensh_in = coldensh_in + lcol * path
    newp = coldensh_in + ndhi_p * (path * dr)

    # y-plane wedge fixups (|oz| = d columns come from the z planes) —
    # same-x-row transfers, strip-local (sweep.py:393-396)
    on_pb = itb == d
    on_mb = itb == -d
    fb = _mirror_b(newp)
    pz, mz = newp[0], newp[1]
    py = jnp.where(on_pb[0], pz, jnp.where(on_mb[0], fb[1], newp[2]))
    my = jnp.where(on_pb[0], fb[0], jnp.where(on_mb[0], mz, newp[3]))
    return jnp.stack([pz, mz, py, my])


def _xplane_update(prev, ndhi_plane, lcol_plane, d, cfg: RunConfig, dr,
                   rows4, n: int):
    """Advance one x-face plane (axes: centered y, centered z) one shell.

    rows4: (4, N) the owning device's strip rows at the plane's grid row
    — (pz, mz, py_fixed, my_fixed); z rows feed the |oz|=d columns, y
    rows the |oy|=d rows (the fa/tz wedge transfers of sweep.py:397-405
    reduced to same-row reads, see module docstring).
    sign: +1 plane uses rows at grid row src_x+d, -1 at src_x-d; the
    caller passes the right rows, the in-plane formula is sign-agnostic
    because both plane axes are transverse.
    """
    dtype = prev.dtype
    c = n // 2
    ita = lax.broadcasted_iota(jnp.int32, (n, 1), 0) - c
    itb = lax.broadcasted_iota(jnp.int32, (1, n), 1) - c
    ta = ita.astype(dtype)
    tb = itb.astype(dtype)
    pos_a = ita >= 0
    pos_b = itb >= 0

    def shift(x, axis, pos):
        return jnp.where(pos, jnp.roll(x, 1, axis), jnp.roll(x, -1, axis))

    c4 = prev
    c3 = shift(prev, 0, pos_a)
    c2 = shift(prev, 1, pos_b)
    c1 = shift(c3, 1, pos_b)
    cdensi, path = _interp(c1, c2, c3, c4, ta, tb, d, dtype)
    cdensi = _diag_fix(cdensi, d, jnp.abs(ita) == 1, jnp.abs(itb) == 1,
                       dtype)
    coldensh_in = cdensi
    if cfg.use_lls and cfg.type_of_lls in (1, 2):
        coldensh_in = coldensh_in + lcol_plane * path
    newp = coldensh_in + ndhi_plane * (path * dr)

    pz_r, mz_r, py_r, my_r = rows4
    # rows |oy| = d from the fixed y planes, then |oz| = d columns from
    # the z planes overwrite (z has top priority) — sweep.py:397-405
    newp = jnp.where(ita == d, py_r[None, :], newp)
    newp = jnp.where(ita == -d, my_r[None, :], newp)
    newp = jnp.where(itb == d, pz_r[:, None], newp)
    newp = jnp.where(itb == -d, mz_r[:, None], newp)
    return newp


def _unstage_strips(stk: Array, ox: Array, n: int) -> Array:
    """Merge stacked strip planes (D, 4, m, N), shells 1..D, into the
    local (m, n, n) column slab by cell ownership — the slab analogue of
    _unstage_faces (x-face cells are deposited during the scan)."""
    d_max, _, m, _ = stk.shape
    c = n // 2
    dtype = stk.dtype
    axo = jnp.abs(ox)[:, None, None]                       # (m,1,1)
    oyo = np.abs(np.arange(n) - c)
    navp = min(d_max, n - 1 - c)
    navm = min(d_max, c)
    out = jnp.zeros((m, n, n), dtype)

    # z+ : cells (x, y, z=c+dz), own: dz >= |ox| and dz >= |oy|
    dzp = np.arange(1, navp + 1)
    zp = jnp.moveaxis(stk[:navp, 0], 0, 2)                 # (m, N, navp)
    own = (dzp[None, None, :] >= axo) & \
        (dzp[None, None, :] >= oyo[None, :, None])
    out = out.at[:, :, c + 1:c + 1 + navp].set(jnp.where(own, zp, 0.0))
    # z- : z = c-dz, descending index = ascending dz flipped
    dzm = np.arange(navm, 0, -1)
    zm = jnp.flip(jnp.moveaxis(stk[:navm, 1], 0, 2), 2)
    own = (dzm[None, None, :] >= axo) & \
        (dzm[None, None, :] >= oyo[None, :, None])
    out = out.at[:, :, c - navm:c].set(jnp.where(own, zm, 0.0))
    # y+ : cells (x, y=c+dy, z), own: dy >= |ox| and dy > |oz|; the y
    # regions overlap the z regions, so keep existing values where this
    # face does not own the cell (as _unstage_faces does)
    ozo = oyo[None, None, :]
    yp = jnp.moveaxis(stk[:navp, 2], 0, 1)                 # (m, navp, N)
    own = (dzp[None, :, None] >= axo) & (dzp[None, :, None] > ozo)
    reg = out[:, c + 1:c + 1 + navp, :]
    out = out.at[:, c + 1:c + 1 + navp, :].set(jnp.where(own, yp, reg))
    # y-
    ym = jnp.flip(jnp.moveaxis(stk[:navm, 3], 0, 1), 1)
    own = (dzm[None, :, None] >= axo) & (dzm[None, :, None] > ozo)
    reg = out[:, c - navm:c, :]
    out = out.at[:, c - navm:c, :].set(jnp.where(own, ym, reg))
    return out


def compute_columns_slab(cfg: RunConfig, ndhi_slab: Array,
                         sc: SweepScalars, lls_slab: Optional[Array],
                         max_shell: int, src_x, r0, ndom: int,
                         axis_name: str) -> Array:
    """Run the halo-exchange causal march for one source over this
    device's grid slab.

    ndhi_slab: (m, N, N) local x-slab of the neutral density, axes 1/2
    already recentered on the source (rolled by c - src_{y,z}); axis 0
    in GRID order, rows [r0, r0+m).
    src_x: the source's grid row (traced).
    Returns the local coldensh_out slab (m, N, N), axes 1/2 centered.
    """
    m, n = ndhi_slab.shape[0], ndhi_slab.shape[-1]
    c = n // 2
    dtype = ndhi_slab.dtype
    use_lls_grid = (lls_slab is not None and cfg.use_lls
                    and cfg.type_of_lls in (1, 2))
    scalar_lls = sc.lls_coldens if not use_lls_grid else None

    rows = r0 + jnp.arange(m, dtype=jnp.int32)
    ox = (rows - src_x.astype(jnp.int32) + c) % n - c      # (m,)

    strips_nd = _stage_strips(ndhi_slab, max_shell)
    strips_ll = _stage_strips(lls_slab, max_shell) if use_lls_grid else None

    # source cell: half-cell column (evolve_point.F90:151-160)
    lrow_src = (src_x.astype(jnp.int32) - r0) % n
    own_src = lrow_src < m
    lrow_src_c = jnp.minimum(lrow_src, m - 1)
    cc = jnp.asarray(c, lrow_src_c.dtype)
    nd_src = lax.dynamic_slice(ndhi_slab, (lrow_src_c, cc, cc), (1, 1, 1))
    cdo0 = jnp.where(own_src, nd_src[0, 0, 0], 0.0) * (0.5 * sc.dr)

    onehot_src = ((jnp.arange(m) == lrow_src) & own_src).astype(dtype)
    strips0 = (jnp.zeros((4, m, n), dtype)
               .at[:, :, c].add(onehot_src[None, :] * cdo0))
    xplane0 = jnp.zeros((n, n), dtype).at[c, c].set(cdo0)
    # every device needs a valid x-plane seed before ownership reaches
    # it; cdo0 is zero off the source owner, so broadcast the true value
    xplane0 = xplane0.at[c, c].set(lax.psum(cdo0, axis_name))

    cdo_slab = (jnp.zeros((m, n, n), dtype)
                .at[:, c, c].add(onehot_src * lax.psum(cdo0, axis_name)))

    up_perm = _ring_perm(ndom, +1)
    dn_perm = _ring_perm(ndom, -1)

    def take_row(a3, lrow):
        """(m,N,...) slab -> one (N,...) row at clamped traced index."""
        return lax.dynamic_slice_in_dim(a3, jnp.minimum(lrow, m - 1),
                                        1, axis=0)[0]

    ds = jnp.arange(1, max_shell + 1)
    nd_xs = strips_nd[1:]
    ll_xs = strips_ll[1:] if use_lls_grid else None

    def body(carry, xs):
        strips, px, mx, cdo = carry
        if use_lls_grid:
            d, nd_p, ll_p = xs
            lcol = ll_p
        else:
            d, nd_p = xs
            lcol = scalar_lls

        # --- one merged ring exchange per direction: halo rows for the
        # strip shift + the x-plane ownership handoff ---
        send_up = jnp.concatenate([strips[:, -1, :], px], 0)   # (4+N, N)
        send_dn = jnp.concatenate([strips[:, 0, :], mx], 0)
        recv_up = lax.ppermute(send_up, axis_name, up_perm)
        recv_dn = lax.ppermute(send_dn, axis_name, dn_perm)
        halo_below, px_from_dn = recv_up[:4], recv_up[4:]
        halo_above, mx_from_up = recv_dn[:4], recv_dn[4:]
        # px/mx state as seen by this device entering shell d: mine if I
        # owned row src_x +/- (d-1), else the neighbor's
        own_prev_p = ((src_x + d - 1 - r0) % n) < m
        own_prev_m = ((src_x - (d - 1) - r0) % n) < m
        px = jnp.where(own_prev_p, px, px_from_dn)
        mx = jnp.where(own_prev_m, mx, mx_from_up)

        strips_new = _strip_update(strips, halo_below, halo_above, nd_p,
                                   lcol, d, cfg, sc.dr, ox, n)

        # x planes: owner rows src_x +/- d (wrap-aware ownership: at
        # d = c the +d row aliases the -d row and belongs to x-)
        lrow_p = (src_x + d - r0) % n
        lrow_m = (src_x - d - r0) % n
        oxp = (d + c) % n - c
        rows_p = take_row(jnp.moveaxis(strips_new, 1, 0), lrow_p)  # (4,N)
        rows_m = take_row(jnp.moveaxis(strips_new, 1, 0), lrow_m)
        nd_pp = take_row(ndhi_slab, lrow_p)
        nd_pm = take_row(ndhi_slab, lrow_m)
        if use_lls_grid:
            ll_pp = take_row(lls_slab, lrow_p)
            ll_pm = take_row(lls_slab, lrow_m)
        else:
            ll_pp = ll_pm = scalar_lls
        px_new = _xplane_update(px, nd_pp, ll_pp, d, cfg, sc.dr,
                                rows_p, n)
        mx_new = _xplane_update(mx, nd_pm, ll_pm, d, cfg, sc.dr,
                                rows_m, n)

        # deposit owned x-face cells into the column slab
        ita = lax.broadcasted_iota(jnp.int32, (n, 1), 0) - c
        itb = lax.broadcasted_iota(jnp.int32, (1, n), 1) - c
        interior = (jnp.abs(ita) < d) & (jnp.abs(itb) < d)
        own_p = (lrow_p < m) & (oxp == d)
        own_m = lrow_m < m                    # ox of row src_x-d is -d
        cur = take_row(cdo, lrow_p)
        cdo = lax.dynamic_update_slice_in_dim(
            cdo, jnp.where(interior & own_p, px_new, cur)[None],
            jnp.minimum(lrow_p, m - 1), axis=0)
        cur = take_row(cdo, lrow_m)
        cdo = lax.dynamic_update_slice_in_dim(
            cdo, jnp.where(interior & own_m, mx_new, cur)[None],
            jnp.minimum(lrow_m, m - 1), axis=0)

        return (strips_new, px_new, mx_new, cdo), strips_new

    xs = (ds, nd_xs, ll_xs) if use_lls_grid else (ds, nd_xs)
    (strips, px, mx, cdo_slab), stk = lax.scan(
        body, (strips0, xplane0, xplane0, cdo_slab), xs)
    return cdo_slab + _unstage_strips(stk, ox, n)
