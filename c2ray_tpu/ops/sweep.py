"""Causal wavefront ray-sweep engine — the heart of the framework.

Data-parallel reformulation of the reference's per-source
short-characteristics ray trace (evolve_source.F90 + evolve_point.F90:83-299
+ column_density.f90:29-293).  The reference visits cells serially, marching
outward from the source (6 axes / 12 planes / 8 octants under OpenMP).
Here the same causal order becomes a *Chebyshev-shell wavefront*:

  * Work in a source-centered frame: all per-source fields are rolled so
    the source sits at index c = N//2.  Offsets o = idx - c span
    [-N//2, N-1-N//2], exactly the reference's periodic trace bounds
    (evolve_source.F90:100-102).
  * Cells at Chebyshev distance d = max(|ox|,|oy|,|oz|) depend only on
    cells at distance < d: every interpolation corner of the
    short-characteristics scheme either lies in shell d-1 or receives an
    exactly-zero geometric weight (the dx=(d-|t|)/d factors vanish on the
    shell diagonal).  So shell d is one fully parallel step.
  * A shell's surface is processed as 6 faces (dominant axis +/-, with the
    reference's z>=y>=x tie-breaking, column_density.f90:108,173,226).
    On a face, the 4 upstream corners are *shifted copies of the previous
    dominant plane*, so the entire interpolation is rolls + selects +
    elementwise math on 2D planes - no gathers - and the geometric weights
    reduce to closed forms evaluated from iota coordinates:
        dx = (d - |ta|)/d,  path = sqrt((ta^2+tb^2)/d^2 + 1).
  * ONLY the column densities are causal.  The sequential wavefront loop
    computes nothing but coldensh_out; all rate physics (photon-conserving
    table/mixture evaluation, LLS opacity losses, boundary-loss tallies,
    per-atom rate deposition) happens afterwards in ONE fully vectorized
    pass over the grid, recovering coldensh_in = coldensh_out - cell
    column exactly.  This halves the sequential-path op count: per-op
    and per-loop-iteration overheads dominate small plane work.
  * Read-only fields (density, ionization) are pre-staged into face-major
    stacks (d, face, a, b) before the loop, so the loop body performs two
    dynamic slices instead of twelve.
  * The dynamic subbox growth (evolve_source.F90:128-212) becomes a static
    `max_shell` radius; escaping photons are tallied exactly as the
    reference's boundary-face loss (evolve_point.F90:290-295) so a host
    driver can re-sweep under-radiused sources.
  * Sources are batched with vmap (raytrace_all_sources): one shared shell
    loop over a batch of recentered grids.

Units policy (float32-safe): photon rates in units of S_star photons/s
(tables pre-normalized), geometry in cell units; the single combined scale
rate_scale = S_star/dr^3 converts to physical per-atom rates.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from .. import constants as const
from ..config import RunConfig
from .tables import RadTables, photoion_rates, photoion_rates_lls_fused

SQRT2 = float(np.sqrt(2.0))
SQRT3 = float(np.sqrt(3.0))
FOURPI = 4.0 * np.pi

# The 6 shell faces: (dominant axis, sign, bound_sub_a, bound_sub_b).
# bound_sub encodes the tie-breaking partition (z beats y beats x, matching
# the elif-chain in column_density.f90:108-267): transverse offsets satisfy
# |t| <= d - bound_sub.
_FACES = (
    (2, +1, 0, 0), (2, -1, 0, 0),   # z faces: |ox|<=d, |oy|<=d
    (1, +1, 0, 1), (1, -1, 0, 1),   # y faces: |ox|<=d, |oz|<=d-1
    (0, +1, 1, 1), (0, -1, 1, 1),   # x faces: |oy|<=d-1, |oz|<=d-1
)


class SweepScalars(NamedTuple):
    """Traced per-step scalars (all float32-safe magnitudes)."""

    dr: jax.Array           # proper cell size [cm]
    rate_scale: jax.Array   # S_star / dr^3  [photons / s / cm^3 per table unit]
    lls_coldens: jax.Array  # LLS column density per cell [cm^-2] (type 1)
    rmax2_cells: jax.Array  # squared LLS type-3 barrier radius [cell units]


class SweepResult(NamedTuple):
    phih: jax.Array         # per-neutral-atom photoionization rate [1/s]
    phiheat: jax.Array      # photo-heating rate [erg/s/cm^3]
    photon_loss: jax.Array  # photons/s escaping the traced region [S_star units]
    lls_loss: jax.Array     # photons/s absorbed by LLS fog [S_star units]
    coldensh_out: jax.Array  # outgoing column densities (diagnostics/tests)


def _take_plane(vol: jax.Array, axis: int, idx, lo: int, p: int) -> jax.Array:
    """Extract the (p,p) plane at (possibly traced) index along `axis`,
    with static transverse window [lo, lo+p)."""
    starts: List = [lo, lo, lo]
    sizes = [p, p, p]
    starts[axis] = idx
    sizes[axis] = 1
    return lax.dynamic_slice(vol, starts, sizes).squeeze(axis)


def _put_plane(vol: jax.Array, plane: jax.Array, axis: int, idx, lo: int) -> jax.Array:
    starts: List = [lo, lo, lo]
    starts[axis] = idx
    return lax.dynamic_update_slice(vol, jnp.expand_dims(plane, axis), starts)


def roll3(a: jax.Array, shifts) -> jax.Array:
    """Periodic roll of a 3D field by (possibly traced) per-axis shifts."""
    return jnp.roll(a, (shifts[0], shifts[1], shifts[2]), axis=(0, 1, 2))


def _stage_faces(x: jax.Array, d_max: int) -> jax.Array:
    """Pre-stage a centered field into face-major planes.

    Returns (d_max+1, 6, N, N): entry [d, f] is the full transverse plane
    of grid plane (dominant axis of face f at offset sign*d).  Pure
    slices/flips/transposes, done once per sweep so the shell loop needs a
    single dynamic slice per field instead of six.
    """
    n = x.shape[0]
    c = n // 2
    slabs = []
    for (ax, s, _, _) in _FACES:
        # Forward-stride slices + a standalone flip (see the matching
        # note in _unstage_faces).
        idx: List = [slice(None)] * 3
        if s > 0:
            idx[ax] = slice(c, None)          # planes d = 0 .. n-1-c
            slab = jnp.moveaxis(x[tuple(idx)], ax, 0)
        else:
            idx[ax] = slice(0, c + 1)         # planes d = c .. 0
            slab = jnp.flip(jnp.moveaxis(x[tuple(idx)], ax, 0), 0)
        pad = d_max + 1 - slab.shape[0]
        if pad > 0:
            slab = jnp.pad(slab, ((0, pad), (0, 0), (0, 0)), mode="edge")
        slabs.append(slab[:d_max + 1])
    return jnp.stack(slabs, axis=1)


def _stage_faces_patch(x: jax.Array, d_lo: int, d_hi: int, lo: int,
                       p: int) -> jax.Array:
    """Patch-restricted face staging: (nd, 6, p, p) planes for shells
    d_lo..d_hi, transverse window [lo, lo+p) of the centered cube.

    Same slicing/flip/edge-pad rules as _stage_faces (values at shared
    coordinates are identical); small shells stage only the (2d_hi+1)^2
    patch they can reach instead of full N^2 planes.
    """
    n = x.shape[0]
    c = n // 2
    nd = d_hi - d_lo + 1
    slabs = []
    for (ax, s, _, _) in _FACES:
        idx: List = [slice(lo, lo + p)] * 3
        if s > 0:
            end = min(d_hi, n - 1 - c)
            idx[ax] = slice(c + d_lo, c + end + 1)
            slab = jnp.moveaxis(x[tuple(idx)], ax, 0)
        else:
            end = min(d_hi, c)
            idx[ax] = slice(c - end, c - d_lo + 1)
            slab = jnp.flip(jnp.moveaxis(x[tuple(idx)], ax, 0), 0)
        pad = nd - slab.shape[0]
        if pad > 0:
            slab = jnp.pad(slab, ((0, pad), (0, 0), (0, 0)), mode="edge")
        slabs.append(slab)
    return jnp.stack(slabs, axis=1)


def face_ownership_masks(n: int, c: int):
    """Cell-ownership partition of the shell cube's surface, _FACES order
    [z+, z-, y+, y-, x+, x-] with z > y > x priority (the octant wedge
    rules of column_density.f90 reduced to a disjoint partition).

    Shared by _unstage_patch (grid backend) and _unstage_faces
    (facemajor backend): both backends must keep an identical cell
    partition to stay bitwise-equal."""
    o = np.arange(n) - c
    oi = o[:, None, None]
    oj = o[None, :, None]
    ok = o[None, None, :]
    ai, aj, ak = abs(oi), abs(oj), abs(ok)
    return [
        (ok > 0) & (ok >= ai) & (ok >= aj),
        (ok < 0) & (-ok >= ai) & (-ok >= aj),
        (oj > 0) & (oj >= ai) & (oj > ak),
        (oj < 0) & (-oj >= ai) & (-oj > ak),
        (oi > 0) & (oi > aj) & (oi > ak),
        (oi < 0) & (-oi > aj) & (-oi > ak),
    ]


def _unstage_patch(out: jax.Array, planes: jax.Array, n: int, d_lo: int,
                   lo: int, p: int) -> jax.Array:
    """Merge one bucket's patch planes (nd, 6, p, p), shells d_lo.., into
    the grid-layout cube by cell ownership (same partition as
    _unstage_faces, restricted to the patch's transverse window)."""
    c = n // 2
    pos_max = n - 1 - c
    nd = planes.shape[0]
    d_hi = d_lo + nd - 1
    own = face_ownership_masks(n, c)
    for f, (ax, s, _, _) in enumerate(_FACES):
        hi = min(d_hi, pos_max if s > 0 else c)
        if hi < d_lo:
            continue
        slab = planes[:hi - d_lo + 1, f]
        region: List = [slice(lo, lo + p)] * 3
        if s > 0:
            region[ax] = slice(c + d_lo, c + hi + 1)
        else:
            region[ax] = slice(c - hi, c - d_lo + 1)
            slab = jnp.flip(slab, 0)
        slab = jnp.moveaxis(slab, 0, ax)
        m = jnp.asarray(own[f][tuple(region)])
        out = out.at[tuple(region)].set(
            jnp.where(m, slab, out[tuple(region)]))
    return out


def plan_buckets(cfg: RunConfig, max_shell: int) -> List[Tuple[int, int, int, int]]:
    """Split shells 1..max_shell into buckets of static patch size.

    Returns (d_lo, d_hi, patch, lo) tuples; within a bucket a fori_loop
    runs with patch-size-static shapes.  This is the analogue of the
    reference's growing subboxes (evolve_source.F90:128-136): small shells
    touch only small windows of the grid.
    """
    n = cfg.mesh[0]
    c = n // 2
    w = cfg.shell_bucket_size
    if w <= 0:
        ranges = [(1, max_shell)]
    else:
        ranges = []
        d = 1
        while d <= max_shell:
            hi = min(d + w - 1, max_shell)
            ranges.append((d, hi))
            d = hi + 1
    out = []
    for d_lo, d_hi in ranges:
        p = min(n, 2 * d_hi + 1)
        lo = max(0, min(c - d_hi, n - p))
        out.append((d_lo, d_hi, p, lo))
    return out


def _column_step(d, cdo, *, cfg: RunConfig, ndhi_faces, lls_faces,
                 sc: SweepScalars, patch: int, lo: int):
    """One wavefront step: interpolate incoming columns for all 6 faces of
    shell d and commit the outgoing columns.

    The causal core of evolve0D (evolve_point.F90:128-248) + cinterp
    (column_density.f90:29-271), columns only.
    """
    n = cfg.mesh[0]
    c = n // 2
    pos_max = n - 1 - c
    dtype = cdo.dtype
    sigma = const.SIGMA_HI_AT_ION_FREQ
    eps = cfg.epsilon

    df = jnp.asarray(d, dtype) if not hasattr(d, "astype") else d.astype(dtype)
    inv_d = 1.0 / df

    ar = np.arange(patch) + (lo - c)            # transverse offsets (static)
    ita = jnp.asarray(ar[:, None], jnp.int32)
    itb = jnp.asarray(ar[None, :], jnp.int32)
    ta = jnp.asarray(ar[:, None], dtype)
    tb = jnp.asarray(ar[None, :], dtype)
    abs_ta = jnp.abs(ta)
    abs_tb = jnp.abs(tb)

    # previous dominant planes (the only in-loop reads of mutable state)
    prev = jnp.stack([_take_plane(cdo, ax, c + s * (d - 1), lo, patch)
                      for (ax, s, _, _) in _FACES])
    # staged read-only neutral-density planes at distance d: one slice
    ndhip = lax.dynamic_slice(ndhi_faces, (d, 0, lo, lo),
                              (1, 6, patch, patch))[0]
    if lls_faces is not None:
        lcol = lax.dynamic_slice(lls_faces, (d, 0, lo, lo),
                                 (1, 6, patch, patch))[0]
    else:
        lcol = sc.lls_coldens

    # --- short-characteristics corners: shifted copies of prev plane ------
    # Corner offset along a transverse axis t is t - sign(t), with the
    # Fortran convention sign(0) = +1 (column_density.f90:88-96).
    pos_a = (ita >= 0)[None, :, :]
    pos_b = (itb >= 0)[None, :, :]

    def shift_toward_source(x, plane_axis, pos_mask):
        up = jnp.roll(x, 1, axis=plane_axis)    # x[p-1]
        dn = jnp.roll(x, -1, axis=plane_axis)   # x[p+1]
        return jnp.where(pos_mask, up, dn)

    c4 = prev                                    # (i , j ) corner
    c3 = shift_toward_source(prev, 1, pos_a)     # (im, j )
    c2 = shift_toward_source(prev, 2, pos_b)     # (i , jm)
    c1 = shift_toward_source(c3, 2, pos_b)       # (im, jm)

    # --- geometric interpolation weights (column_density.f90:112-142) -----
    f_a = jnp.clip((df - abs_ta) * inv_d, 0.0, 1.0)
    f_b = jnp.clip((df - abs_tb) * inv_d, 0.0, 1.0)
    s1 = (1.0 - f_a) * (1.0 - f_b)
    s2 = f_a * (1.0 - f_b)
    s3 = (1.0 - f_a) * f_b
    s4 = f_a * f_b

    def wf(cd):
        """weightf = 1/max(0.6, cd*sigma). column_density.f90:276-293."""
        return 1.0 / jnp.maximum(0.6, cd * sigma)

    w1 = s1 * wf(c1)
    w2 = s2 * wf(c2)
    w3 = s3 * wf(c3)
    w4 = s4 * wf(c4)
    cdensi = (c1 * w1 + c2 * w2 + c3 * w3 + c4 * w4) / (w1 + w2 + w3 + w4)

    # diagonal corrections, active only on shell 1 (column_density.f90:152-158)
    a1 = jnp.abs(ita) == 1
    b1 = jnp.abs(itb) == 1
    diag = jnp.where(a1 & b1, SQRT3, jnp.where(a1 | b1, SQRT2, 1.0)).astype(dtype)
    cdensi = jnp.where(d == 1, cdensi * diag, cdensi)

    # path length through the cell (column_density.f90:168)
    path = jnp.sqrt((ta * ta + tb * tb) * (inv_d * inv_d) + 1.0)

    # LLS opacity added to the incoming column (evolve_point.F90:186-196)
    coldensh_in = cdensi
    if cfg.use_lls and cfg.type_of_lls in (1, 2):
        coldensh_in = coldensh_in + lcol * path

    # outgoing column (evolve_point.F90:247-248); ndhi = x_HI,av * n_H is
    # the only field combination the sweep ever needs
    cdo_new = coldensh_in + ndhip * (path * sc.dr)

    # masked per-face commits (faces partition the shell; edge cells that
    # appear in several planes resolve by the static bound_sub priority)
    for f, (ax, sgn, sub_a, sub_b) in enumerate(_FACES):
        mask = (jnp.abs(ita) <= d - sub_a) & (jnp.abs(itb) <= d - sub_b)
        if sgn > 0:
            mask = mask & (d <= pos_max)
        zi = c + sgn * d
        old = _take_plane(cdo, ax, zi, lo, patch)
        cdo = _put_plane(cdo, jnp.where(mask, cdo_new[f], old), ax, zi, lo)
    return cdo


def _mirror_perm(n: int, dtype) -> jax.Array:
    """Permutation matrix P with P[i,j]=1 iff i = (2c - j) mod n (c = n//2):
    the reflection about the center index, applied as one contraction
    (exact: one nonzero per row) instead of a flip + roll pair."""
    rows = lax.broadcasted_iota(jnp.int32, (n, n), 0)
    cols = lax.broadcasted_iota(jnp.int32, (n, n), 1)
    return ((rows + cols) % n == (2 * (n // 2)) % n).astype(dtype)


def _mirror_b(x: jax.Array) -> jax.Array:
    """Reflect the last axis about the center index c=N//2 (b -> 2c-b).

    precision=HIGHEST is required: a default-precision float32 product
    may round its operands to a reduced-mantissa format (TF32 on GPU
    tensor cores, ~10 mantissa bits), which corrupts the *selected
    values* of a one-hot permutation product; HIGHEST keeps the one-hot
    contraction an exact copy.
    """
    with jax.named_scope("mirror"):
        p = _mirror_perm(x.shape[-1], x.dtype)
        return jax.lax.dot_general(x, p, (((x.ndim - 1,), (0,)), ((), ())),
                                   preferred_element_type=x.dtype,
                                   precision=lax.Precision.HIGHEST)


def _mirror_a(x: jax.Array) -> jax.Array:
    """Reflect the second-to-last axis about the center index."""
    with jax.named_scope("mirror"):
        p = _mirror_perm(x.shape[-2], x.dtype)   # symmetric
        # out[.., i, b] = sum_a x[.., a, b] P[a, i]  (P symmetric)
        out = jax.lax.dot_general(x, p, (((x.ndim - 2,), (0,)), ((), ())),
                                  preferred_element_type=x.dtype,
                                  precision=lax.Precision.HIGHEST)
        return jnp.swapaxes(out, -1, -2)


def _wavefront_plane_update(prev, ndhi_p, lcol, d, cfg: RunConfig,
                            dr, n: int):
    """Face-major wavefront step: from the 6 previous dominant planes
    (6,N,N) compute the 6 new planes of shell d, wedge-fixed so that each
    face's plane is valid on its full |t| <= d read extent.

    The wedge fixups replace cross-face reads: shell-cube edge cells are
    owned by the higher-priority face but appear in the other faces'
    planes; by the coordinate coincidence at the 45-degree wedges the
    transfers reduce to elementwise selects of (optionally mirrored /
    transposed) sibling planes - no gathers, no dynamic indexing.  The
    mirrored/transposed variants are built once for the whole (6,N,N)
    stack, so the per-face transfers become pure selects.
    """
    c = n // 2
    dtype = prev.dtype
    sigma = const.SIGMA_HI_AT_ION_FREQ
    df = d.astype(dtype) if hasattr(d, "astype") else jnp.asarray(d, dtype)
    inv_d = 1.0 / df

    # transverse offset coordinates via iota (no captured constants)
    ita = lax.broadcasted_iota(jnp.int32, (n, 1), 0) - c
    itb = lax.broadcasted_iota(jnp.int32, (1, n), 1) - c
    ta = ita.astype(dtype)
    tb = itb.astype(dtype)

    pos_a = (ita >= 0)[None, :, :]
    pos_b = (itb >= 0)[None, :, :]

    def shift_toward_source(x, plane_axis, pos_mask):
        up = jnp.roll(x, 1, axis=plane_axis)
        dn = jnp.roll(x, -1, axis=plane_axis)
        return jnp.where(pos_mask, up, dn)

    c4 = prev
    c3 = shift_toward_source(prev, 1, pos_a)
    c2 = shift_toward_source(prev, 2, pos_b)
    c1 = shift_toward_source(c3, 2, pos_b)

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

    a1 = jnp.abs(ita) == 1
    b1 = jnp.abs(itb) == 1
    diag = jnp.where(a1 & b1, SQRT3, jnp.where(a1 | b1, SQRT2, 1.0)).astype(dtype)
    cdensi = jnp.where(d == 1, cdensi * diag, cdensi)

    path = jnp.sqrt((ta * ta + tb * tb) * (inv_d * inv_d) + 1.0)
    coldensh_in = cdensi
    if cfg.use_lls and cfg.type_of_lls in (1, 2):
        coldensh_in = coldensh_in + lcol * path
    newp = coldensh_in + ndhi_p * (path * dr)

    # ---- wedge fixups (edge cells owned by the higher-priority face) ----
    on_pa = (ita == d)[None]           # row a = c+d
    on_ma = (ita == -d)[None]
    on_pb = (itb == d)[None]           # col b = c+d
    on_mb = (itb == -d)[None]
    pz, mz = newp[0], newp[1]

    fb = _mirror_b(newp)               # b -> 2c-b for all faces at once
    fa = _mirror_a(newp)
    fab = _mirror_a(fb)
    tz = jnp.swapaxes(newp[0:2], -1, -2)
    tfb = _mirror_b(tz)
    # y planes: |oz| = d columns come from the z planes (same a; b is oz in
    # the y plane and oy in the z plane, both = +-d -> same/mirrored slot)
    py = jnp.where(on_pb[0], pz, jnp.where(on_mb[0], fb[1], newp[2]))
    my = jnp.where(on_pb[0], fb[0], jnp.where(on_mb[0], mz, newp[3]))
    # x planes: |oy| = d rows from the (fixed) y planes...
    fa_py = jnp.where(on_pb[0], fa[0], jnp.where(on_mb[0], fab[1], fa[2]))
    fa_my = jnp.where(on_pb[0], fab[0], jnp.where(on_mb[0], fa[1], fa[3]))
    px = jnp.where(on_pa[0], py, jnp.where(on_ma[0], fa_my, newp[4]))
    mx = jnp.where(on_pa[0], fa_py, jnp.where(on_ma[0], my, newp[5]))
    # ...then |oz| = d columns from the (transposed) z planes; z has top
    # priority so these overwrite the cube corners
    px = jnp.where(on_pb[0], tz[0], jnp.where(on_mb[0], tfb[1], px))
    mx = jnp.where(on_pb[0], tfb[0], jnp.where(on_mb[0], tz[1], mx))
    return jnp.stack([pz, mz, py, my, px, mx])


def _unstage_faces(planes: jax.Array, n: int, cdo0) -> jax.Array:
    """Merge face-major planes back to grid layout by cell ownership.

    planes: (D, 6, N, N) face planes for shells d = 1..D (the shell-0
    plane is never consulted: every face-ownership mask requires strict
    positivity along the dominant axis, so shell 0 contributes only the
    source cell, set from cdo0 directly).

    Inverse of _stage_faces restricted to each face's owned cells (the
    z>=y>=x tie-breaking partition); the source cell gets cdo0.  Cells
    beyond the swept radius keep zero columns (masked in the rate pass).
    """
    c = n // 2
    pos_max = n - 1 - c
    d_max = planes.shape[0]
    own = face_ownership_masks(n, c)
    # Only forward-stride regions below, with the reversal kept as a
    # standalone jnp.flip on the slab: a reversed-stride region write
    # under vmap has been miscompiled by an XLA backend before, and this
    # form is pinned bitwise against single-source sweeps (tests and the
    # on-card march cross-check).
    out = jnp.zeros((n, n, n), planes.dtype)
    for f, (ax, s, _, _) in enumerate(_FACES):
        navail = min(pos_max if s > 0 else c, d_max)    # planes d=1..navail
        slab = planes[:navail, f]
        region: List = [slice(None)] * 3
        if s > 0:
            region[ax] = slice(c + 1, c + 1 + navail)
        else:
            region[ax] = slice(c - navail, c)
            slab = jnp.flip(slab, 0)
        slab = jnp.moveaxis(slab, 0, ax)
        m = jnp.asarray(own[f][tuple(region)])
        out = out.at[tuple(region)].set(jnp.where(m, slab, out[tuple(region)]))
    out = out.at[c, c, c].set(cdo0)
    return out


def compute_columns_facemajor(cfg: RunConfig, ndhi_c: jax.Array,
                              sc: SweepScalars,
                              lls_c: Optional[jax.Array],
                              max_shell: int) -> jax.Array:
    """Face-major wavefront: the loop carries the previous shell's 6
    planes directly, so each iteration is one field slice + one fused
    plane update + one stack write - the minimal sequential op count
    (per-op overhead dominates plane-sized work).
    """
    n = cfg.mesh[0]
    c = n // 2
    dtype = ndhi_c.dtype

    with jax.named_scope("stage"):
        ndhi_faces = _stage_faces(ndhi_c, max_shell)
        lls_faces = (_stage_faces(lls_c, max_shell) if lls_c is not None
                     else None)

    cdo0 = ndhi_c[c, c, c] * (0.5 * sc.dr)
    prev0 = jnp.zeros((6, n, n), dtype).at[:, c, c].set(cdo0)

    ds = jnp.arange(1, max_shell + 1)
    lls_xs = lls_faces[1:] if lls_faces is not None else None

    def body(prev, xs):
        d, ndhi_p, lcol = xs
        if lcol is None:
            lcol = sc.lls_coldens
        newp = _wavefront_plane_update(prev, ndhi_p, lcol, d, cfg, sc.dr, n)
        return newp, newp

    # lax.scan slices the staged inputs and stacks the outputs natively
    # (no explicit dynamic_slice/update ops in the loop body)
    with jax.named_scope("march"):
        _, planes = lax.scan(body, prev0, (ds, ndhi_faces[1:], lls_xs))
    with jax.named_scope("stage"):
        return _unstage_faces(planes, n, cdo0)


def compute_columns(cfg: RunConfig, ndhi_c: jax.Array,
                    sc: SweepScalars, lls_c: Optional[jax.Array],
                    max_shell: int) -> jax.Array:
    """Run the causal wavefront and return coldensh_out for one source.

    ndhi_c: time-averaged neutral hydrogen density x_HI,av * n_H (centered)
    - the single field combination the column march needs.
    """
    n = cfg.mesh[0]
    c = n // 2
    dtype = ndhi_c.dtype

    ndhi_faces = _stage_faces(ndhi_c, max_shell)
    lls_faces = _stage_faces(lls_c, max_shell) if lls_c is not None else None

    cdo = jnp.zeros((n, n, n), dtype)     # coldensh_out (evolve_source.F90:91)
    # source cell (evolve_point.F90:151-160): half-cell column
    cdo = cdo.at[c, c, c].set(ndhi_c[c, c, c] * (0.5 * sc.dr))

    for d_lo, d_hi, patch, lo in plan_buckets(cfg, max_shell):
        def body(d, cdo, patch=patch, lo=lo):
            return _column_step(d, cdo, cfg=cfg, ndhi_faces=ndhi_faces,
                                lls_faces=lls_faces, sc=sc, patch=patch, lo=lo)
        cdo = lax.fori_loop(d_lo, d_hi + 1, body, cdo)
    return cdo


def _rate_pass(cfg: RunConfig, tables: RadTables, cdo, ndhi_c,
               nflux, sc: SweepScalars, lls_c, max_shell: int,
               row_ci=None, nflux_xray=None) -> SweepResult:
    """Vectorized rate deposition from the completed column-density field.

    Reconstructs coldensh_in = coldensh_out - cell column (exactly the
    value used to build cdo), then applies the per-cell physics of
    evolve0D (evolve_point.F90:151-295): shell-volume dilution, the
    max_coldensh / R_max cutoffs, photon-conserving rates, per-atom rate
    division, boundary photon-loss and LLS-loss tallies.

    row_ci: optional (m,) int32 *centered* row indices for axis 0 - the
    domain-decomposed path (parallel/domain.py) evaluates the rate physics
    only on its grid slab; cdo/ndhi_c/lls_c then carry m rows whose
    centered-frame identity is row_ci.  None = full grid (rows 0..n-1).
    """
    n = cfg.mesh[0]
    c = n // 2
    pos_max = n - 1 - c
    dtype = cdo.dtype
    sigma = const.SIGMA_HI_AT_ION_FREQ
    eps = cfg.epsilon

    o = np.arange(n) - c
    if row_ci is None:
        oi = jnp.asarray(o[:, None, None], jnp.int32)
    else:
        oi = (row_ci.astype(jnp.int32) - c)[:, None, None]
    oj = jnp.asarray(o[None, :, None], jnp.int32)
    ok = jnp.asarray(o[None, None, :], jnp.int32)
    aoi, aoj, aok = jnp.abs(oi), jnp.abs(oj), jnp.abs(ok)
    cheb = jnp.maximum(jnp.maximum(aoi, aoj), aok)
    is_src = cheb == 0

    dom = cheb.astype(dtype)
    safe_d = jnp.maximum(dom, 1.0)
    fi = oi.astype(dtype)
    fj = oj.astype(dtype)
    fk = ok.astype(dtype)
    dist2 = fi * fi + fj * fj + fk * fk
    t2 = dist2 - dom * dom
    path = jnp.sqrt(t2 / (safe_d * safe_d) + 1.0)
    path = jnp.where(is_src, 0.5, path)            # evolve_point.F90:155
    vol_ph = FOURPI * dist2 * path
    vol_ph = jnp.where(is_src, 1.0, vol_ph)        # evolve_point.F90:160

    colcell = ndhi_c * (path * sc.dr)
    coldensh_in = jnp.maximum(cdo - colcell, 0.0)

    active = cheb <= max_shell
    stop = coldensh_in > cfg.max_coldensh          # evolve_point.F90:201
    if cfg.use_lls and cfg.type_of_lls == 3:
        stop = stop | (dist2 > sc.rmax2_cells)     # evolve_point.F90:191

    lls_cell = None
    if cfg.use_lls and cfg.type_of_lls in (1, 2):
        # Photons absorbed by the LLS fog: the exact spectral gap between
        # the pre-LLS and post-LLS incoming columns, tallied inside the
        # same mixture evaluation as the cell rates (one fused pass; see
        # photoion_rates_lls_fused).  NOTE: the reference's tally is
        # broken twice over - it passes its never-assigned photo_in_HI
        # field (evolve_point.F90:269, radiation_photoionrates.F90:438-452,
        # so it always adds 0) and its formula is grey-only by its own
        # comment (photonstatistics.F90:243-247).  This version closes the
        # photon budget with LLS absorption enabled.
        lcol = lls_c if lls_c is not None else sc.lls_coldens
        cold_pre = jnp.maximum(coldensh_in - lcol * path, 0.0)
        phi, lls_cell = photoion_rates_lls_fused(
            cfg, tables, coldensh_in, cdo, vol_ph, nflux, cold_pre,
            nflux_xray=nflux_xray)
    else:
        phi = photoion_rates(cfg, tables, coldensh_in, cdo, vol_ph, nflux,
                             nflux_xray=nflux_xray)
    live = active & ~stop
    gamma = jnp.where(live, phi.photo_cell * sc.rate_scale / ndhi_c, 0.0)
    heat = (jnp.where(live, phi.heat, 0.0) * sc.rate_scale
            if not cfg.isothermal else jnp.zeros((), dtype))

    # boundary-of-trace loss (evolve_point.F90:290-295)
    p_lim = min(max_shell, pos_max)
    q_lim = min(max_shell, c)
    bnd = ((oi == p_lim) | (oi == -q_lim) | (oj == p_lim) | (oj == -q_lim)
           | (ok == p_lim) | (ok == -q_lim))
    loss = jnp.sum(jnp.where(live & bnd, phi.photo_out / vol_ph, 0.0))

    lls_loss = jnp.zeros((), dtype)
    if lls_cell is not None:
        # rate * vol/vol_ph with vol = 1 cell: lls_cell already carries
        # the /vol_ph factor
        lls_loss = jnp.sum(jnp.where(live, lls_cell, 0.0))

    return SweepResult(gamma, heat, loss, lls_loss, cdo)


def neutral_density(cfg: RunConfig, ndens: jax.Array,
                    xh_av1: jax.Array) -> jax.Array:
    """ndhi = max(1 - max(x_av, eps), eps) * n - the epsilon-clamped
    time-averaged neutral density (evolve_point.F90:137-142).

    Under compressed storage (cfg.compressed_xfrac) xh_av1 is the signed
    min-fraction form and the neutral side decodes tail-exactly."""
    eps = cfg.epsilon
    if cfg.compressed_xfrac:
        xh0 = jnp.where(xh_av1 >= 0,
                        1.0 - jnp.maximum(xh_av1, eps), -xh_av1)
        return jnp.maximum(xh0, eps) * ndens
    return jnp.maximum(1.0 - jnp.maximum(xh_av1, eps), eps) * ndens


def slab_rows(n: int, m: int, x0, src_x):
    """Centered-frame row indices of grid slab [x0, x0+m) for a source at
    grid row src_x (both may be traced)."""
    return (x0 + (n // 2) - src_x + jnp.arange(m, dtype=jnp.int32)) % n


def _slab_rows_take(a: Optional[jax.Array], m: int, x0, src_x):
    """Slice the centered field `a` down to the rows of grid slab
    [x0, x0+m): a circular interval in the centered frame, realized as a
    traced roll + static slice."""
    if a is None:
        return None
    n = a.shape[0]
    return jnp.roll(a, src_x - (n // 2) - x0, axis=0)[:m]


def sweep_single_source(cfg: RunConfig, tables: RadTables,
                        ndhi_c: jax.Array, nflux, sc: SweepScalars,
                        lls_c: Optional[jax.Array] = None,
                        max_shell: Optional[int] = None,
                        slab=None, src_x=None,
                        nflux_xray=None) -> SweepResult:
    """Ray-trace one source over its (source-centered) grid.

    Equivalent of do_source (evolve_source.F90:58-221): resets the
    per-source column-density grid, runs the causal wavefront to
    max_shell, then deposits per-atom photoionization/heating rates and
    tallies boundary + LLS photon losses.

    ndhi_c: neutral density field from neutral_density(), recentered on
    the source.

    slab: optional (x0, m) grid-axis-0 slab (x0 traced, m static) for the
    domain-decomposed layout: the causal column march still covers the
    full cube (it is op-latency-bound and cheap, O(N^2) per shell), but
    the N^3-work rate physics runs only on the slab; the returned fields
    have m rows, already in grid order along axis 0 (axes 1,2 centered).
    src_x: the source's grid row (required with slab).
    """
    n = cfg.mesh[0]
    assert cfg.mesh[0] == cfg.mesh[1] == cfg.mesh[2], "sweep assumes cubic mesh"
    c = n // 2
    d_max = c
    if max_shell is None:
        max_shell = cfg.max_shell if cfg.max_shell is not None else d_max
    max_shell = min(max_shell, min(d_max, cfg.max_subbox))

    if cfg.sweep_backend == "grid":
        with jax.named_scope("march"):
            cdo = compute_columns(cfg, ndhi_c, sc, lls_c, max_shell)
    else:
        cdo = compute_columns_facemajor(cfg, ndhi_c, sc, lls_c, max_shell)
    with jax.named_scope("deposition"):
        if slab is None:
            return _rate_pass(cfg, tables, cdo, ndhi_c, nflux, sc, lls_c,
                              max_shell, nflux_xray=nflux_xray)
        x0, m = slab
        row_ci = slab_rows(n, m, x0, src_x)
        return _rate_pass(cfg, tables,
                          _slab_rows_take(cdo, m, x0, src_x),
                          _slab_rows_take(ndhi_c, m, x0, src_x),
                          nflux, sc,
                          _slab_rows_take(lls_c, m, x0, src_x),
                          max_shell, row_ci=row_ci, nflux_xray=nflux_xray)


def windowed_prepass(cfg: RunConfig, ndens: jax.Array, xh_av1: jax.Array,
                     lls_grid: Optional[jax.Array], radius: int):
    """Amortized per-call setup of the windowed sweep: the neutral-density
    field and its r-wide periodic pad (plus the LLS grid's, type-2 LLS).
    A window of half-width `radius` at grid position q is then the
    contiguous (2r+1)^3 slice of the padded field with corner q."""
    ndhi = neutral_density(cfg, ndens, xh_av1)
    ndhi_pad = jnp.pad(ndhi, radius, mode="wrap")
    lls_pad = (jnp.pad(lls_grid, radius, mode="wrap")
               if lls_grid is not None else None)
    return ndhi_pad, lls_pad


def windowed_batch(cfg: RunConfig, tables: RadTables, ndhi_pad: jax.Array,
                   lls_pad: Optional[jax.Array], pos: jax.Array,
                   nf: jax.Array, nfx: Optional[jax.Array],
                   sc: SweepScalars, radius: int,
                   acc: jax.Array, heat_acc: jax.Array,
                   padded_acc: bool = False):
    """Sweep ONE fixed-size batch of (2r+1)^3 windows and scatter-add the
    rates into the grid accumulators.

    This is the windowed sweep's unit of compiled work: its shape depends
    only on (radius, batch size) — never on how many sources currently
    occupy an adaptive-radius bucket — so the convergence loop's subbox
    promotions (evolve_source.F90:128-212) re-bucket sources without
    triggering recompiles.

    pos is in grid coords; ndhi_pad/lls_pad come from windowed_prepass.
    Zero-flux entries pad partial batches and contribute exactly zero.
    Returns (acc, heat_acc, photon_loss_sum, lls_loss_sum, per_window_loss).

    padded_acc=True writes into a PADDED accumulator at the window corner
    (pos..pos+p on every axis, no mod wrap); the caller folds the pad
    ring afterwards (fold_padded_acc).  Used by the halo-sharded windowed
    sweep, where axis 0 of the accumulator is a slab whose overflow
    strips ride a ring exchange instead of wrapping locally
    (parallel/domain.py).
    """
    n = cfg.mesh[0]
    r = int(radius)
    p = 2 * r + 1
    cfgw = cfg.replace(mesh=(p, p, p))
    have_x = nfx is not None
    if not have_x:
        nfx = jnp.zeros_like(nf)

    def window_of(field_pad, q):
        return lax.dynamic_slice(field_pad, (q[0], q[1], q[2]), (p, p, p))

    with jax.named_scope("window_gather"):
        wins = jax.vmap(lambda q: window_of(ndhi_pad, q))(pos)
        lwins = (jax.vmap(lambda q: window_of(lls_pad, q))(pos)
                 if lls_pad is not None else None)
    lax_ax = 0 if lls_pad is not None else None

    def sweep_one(win, lwin, f, fx):
        return sweep_single_source(
            cfgw, tables, win, f, sc, lls_c=lwin, max_shell=r,
            nflux_xray=fx if have_x else None)

    res = jax.vmap(sweep_one, in_axes=(0, lax_ax, 0, 0))(
        wins, lwins, nf, nfx)

    # one scatter-add per batch: windows may overlap each other and
    # the periodic boundary, so duplicates sum
    ar = jnp.arange(p, dtype=jnp.int32)
    if padded_acc:
        # padded-coordinate scatter (window corner = pos, in bounds by
        # construction); the pad ring is folded back by the caller
        ix = pos[:, 0, None] + ar[None, :]            # (b, p)
        iy = pos[:, 1, None] + ar[None, :]
        iz = pos[:, 2, None] + ar[None, :]
    else:
        ix = (pos[:, 0, None] - r + ar[None, :]) % n  # (b, p)
        iy = (pos[:, 1, None] - r + ar[None, :]) % n
        iz = (pos[:, 2, None] - r + ar[None, :]) % n
    idx = (ix[:, :, None, None], iy[:, None, :, None],
           iz[:, None, None, :])
    with jax.named_scope("scatter_add"):
        acc = acc.at[idx].add(res.phih, mode="promise_in_bounds")
        if not cfg.isothermal:
            heat_acc = heat_acc.at[idx].add(res.phiheat,
                                            mode="promise_in_bounds")
    return (acc, heat_acc, jnp.sum(res.photon_loss),
            jnp.sum(res.lls_loss), res.photon_loss)


def fold_padded_acc(acc_pad: jax.Array, n: int, radius: int,
                    axes: Tuple[int, ...] = (0, 1, 2)) -> jax.Array:
    """Fold the r-wide pad ring of an (n+2r)-extent padded accumulator
    back into the n-extent grid with periodic wrapping: the companion of
    windowed_batch(padded_acc=True).

    `axes` selects which axes fold locally: the halo-sharded windowed
    sweep folds axes (1, 2) only, its axis-0 slab overflow strips ride a
    ring ppermute instead (parallel/domain.py)."""
    r = radius
    if r == 0:
        return acc_pad
    a = acc_pad
    # fold axis by axis: low pad adds to the high end, high pad to the low
    for ax in axes:
        def take(lo, hi, ax=ax):
            s: List = [slice(None)] * 3
            s[ax] = slice(lo, hi)
            return a[tuple(s)]

        core = take(r, a.shape[ax] - r)
        lo_pad = take(0, r)
        hi_pad = take(a.shape[ax] - r, a.shape[ax])
        m = core.shape[ax]
        idx_hi: List = [slice(None)] * 3
        idx_hi[ax] = slice(m - r, m)
        idx_lo: List = [slice(None)] * 3
        idx_lo[ax] = slice(0, r)
        core = core.at[tuple(idx_hi)].add(lo_pad)
        core = core.at[tuple(idx_lo)].add(hi_pad)
        a = core
    return a


def raytrace_windowed(cfg: RunConfig, tables: RadTables,
                      ndens: jax.Array, xh_av1: jax.Array,
                      srcpos: jax.Array, nflux: jax.Array,
                      sc: SweepScalars,
                      lls_grid: Optional[jax.Array] = None,
                      radius: int = 8, nflux_xray=None):
    """Windowed multi-source sweep: per-source cost O(radius^3), not O(N^3).

    The production regime of the reference is 10^4-10^8 halo sources whose
    subboxes (evolve_source.F90:128-212) stay far smaller than the grid.
    Here each source is swept entirely inside its (2r+1)^3 window:

      * the neutral-density field is periodically padded once per call
        (O((N+2r)^3), amortized over all sources),
      * a window is one dynamic_slice of the padded field - the source
        lands exactly at the window center, so the whole single-source
        wavefront machinery (facemajor march + vectorized rate pass) runs
        unchanged on a virtual (2r+1)^3 mesh,
      * rates scatter back with ONE mod-N scatter-add per batch (windows
        may overlap each other and the periodic boundary; duplicate
        indices sum), a single op per batch instead of one per window.

    The window boundary coincides with the max_shell boundary, so the
    escaping-photon tally is exactly the reference's subbox-face loss
    (evolve_point.F90:290-295) and drives the same growth criterion.

    Requires 2*radius+1 <= N (otherwise use the full-cube sweep).
    Returns (phih, phiheat, photon_loss, lls_loss, per_source_loss).
    """
    n = cfg.mesh[0]
    r = int(radius)
    p = 2 * r + 1
    assert p <= n, "window must fit in the grid; use the full sweep"
    dtype = ndens.dtype

    ndhi_pad, lls_pad = windowed_prepass(cfg, ndens, xh_av1, lls_grid, r)

    s = int(srcpos.shape[0])
    b = max(1, min(cfg.source_batch, s))
    nbatch = -(-s // b)
    pad = nbatch * b - s
    have_x = nflux_xray is not None
    if not have_x:
        nflux_xray = jnp.zeros_like(nflux)
    if pad:
        srcpos = jnp.concatenate([srcpos, jnp.zeros((pad, 3), srcpos.dtype)])
        nflux = jnp.concatenate([nflux, jnp.zeros((pad,), nflux.dtype)])
        nflux_xray = jnp.concatenate(
            [nflux_xray, jnp.zeros((pad,), nflux_xray.dtype)])
    srcpos_b = srcpos.reshape(nbatch, b, 3)
    nflux_b = nflux.reshape(nbatch, b)
    nfx_b = nflux_xray.reshape(nbatch, b)

    def one_batch(carry, inp):
        acc, heat_acc, loss_t, lls_t = carry
        pos, nf, nfx = inp
        acc, heat_acc, lo, ll, per_win = windowed_batch(
            cfg, tables, ndhi_pad, lls_pad, pos, nf,
            nfx if have_x else None, sc, r, acc, heat_acc)
        return (acc, heat_acc, loss_t + lo, lls_t + ll), per_win

    zero3 = jnp.zeros((n, n, n), dtype)
    heat0 = zero3 if not cfg.isothermal else jnp.zeros((), dtype)
    carry0 = (zero3, heat0, jnp.zeros((), dtype), jnp.zeros((), dtype))
    (phih, heat, loss, lls_loss), per_src = lax.scan(
        one_batch, carry0, (srcpos_b, nflux_b, nfx_b))
    return phih, heat, loss, lls_loss, per_src.reshape(-1)[:s]


def raytrace_all_sources(cfg: RunConfig, tables: RadTables,
                         ndens: jax.Array, xh_av1: jax.Array,
                         srcpos: jax.Array, nflux: jax.Array,
                         sc: SweepScalars,
                         lls_grid: Optional[jax.Array] = None,
                         max_shell: Optional[int] = None,
                         slab=None, nflux_xray=None):
    """Sweep every source and accumulate the global rate grids.

    Equivalent of pass_all_sources/do_grid (evolve.F90:444-495,
    master_slave.F90:53-96) for the sources local to this device; the
    distributed version psums the returned grids (parallel/source_shard.py).

    Sources are processed in vmapped batches of cfg.source_batch: the
    shell wavefront loop is shared across the batch (one set of ops per
    shell, batched planes), which is what keeps the device busy - single
    sources at small meshes are per-op-overhead-bound.  This is the
    within-device analogue of the reference's OpenMP sector parallelism
    (evolve_source.F90:141-187), but batching whole sources instead of
    octants.

    Args:
      srcpos: (S, 3) int32 0-based source cell positions.
      nflux:  (S,) source luminosities in S_star units.
      slab:   optional (x0, m) grid slab for the domain-decomposed layout
              (parallel/domain.py): rate grids come back with m rows
              (grid rows x0..x0+m-1); the column march stays full-cube.
    Returns:
      (phih_grid, phiheat_grid, photon_loss, lls_loss, per_source_loss)
    """
    n = cfg.mesh[0]
    c = n // 2
    dtype = ndens.dtype
    m_rows = n if slab is None else slab[1]

    d_sweep = max_shell
    if d_sweep is None:
        d_sweep = cfg.max_shell if cfg.max_shell is not None else c
    d_sweep = min(d_sweep, min(c, cfg.max_subbox))

    # windowed dispatch: when the sweep radius is small relative to the
    # grid, per-source work must be O(r^3), not O(N^3) (the reference's
    # entire subbox rationale, evolve_source.F90:128-212)
    if (slab is None and cfg.window_sweep and max_shell is not None
            and 2 * d_sweep + 1 <= n - 1):
        return raytrace_windowed(cfg, tables, ndens, xh_av1, srcpos, nflux,
                                 sc, lls_grid=lls_grid, radius=d_sweep,
                                 nflux_xray=nflux_xray)

    s = srcpos.shape[0]
    # memory cap: the full-cube path stages (b, N, N, N) source-centered
    # fields (~3 live copies incl. the face-major staging); bound the
    # batch so the staging working set stays ~<3 GiB regardless of how
    # many sources a caller passes (a promotion to the full-radius rung
    # can deliver thousands)
    b_mem = full_batch_cap(n, dtype)
    b = max(1, min(cfg.source_batch, s, b_mem))
    nbatch = -(-s // b)
    pad = nbatch * b - s
    have_x = nflux_xray is not None
    if not have_x:
        nflux_xray = jnp.zeros_like(nflux)
    if pad:
        # zero-flux padding sources contribute exactly zero everywhere
        srcpos = jnp.concatenate([srcpos, jnp.zeros((pad, 3), srcpos.dtype)])
        nflux = jnp.concatenate([nflux, jnp.zeros((pad,), nflux.dtype)])
        nflux_xray = jnp.concatenate(
            [nflux_xray, jnp.zeros((pad,), nflux_xray.dtype)])
    srcpos_b = srcpos.reshape(nbatch, b, 3)
    nflux_b = nflux.reshape(nbatch, b)
    nfx_b = nflux_xray.reshape(nbatch, b)

    ndhi = neutral_density(cfg, ndens, xh_av1)

    def _center(ext, pos):
        start = (pos - c) % n
        return lax.dynamic_slice(ext, (start[0], start[1], start[2]),
                                 (n, n, n))

    # Source-centered fields via ONE shared wrap-padded cube + a
    # contiguous dynamic_slice per source: a single copy instead of the
    # 3-axis roll's slice+concat passes (bitwise-identical values).  The
    # (2N-1)^3 pad is amortized over all sources and iterations.
    pad_w = ((0, n - 1),) * 3
    ndhi_ext = jnp.pad(ndhi, pad_w, mode="wrap")
    lls_ext = (jnp.pad(lls_grid, pad_w, mode="wrap")
               if lls_grid is not None else None)

    def _to_grid(field, pos):
        """Return the rate field in grid layout: full roll when the field
        covers the cube, axes-1/2 roll when axis 0 is already a grid slab."""
        if slab is None:
            return roll3(field, pos - c)
        return jnp.roll(field, (pos[1] - c, pos[2] - c), axis=(1, 2))

    def sweep_one(pos, nf, nfx):
        with jax.named_scope("stage"):
            ndhi_c = _center(ndhi_ext, pos)
            lls_c = (_center(lls_ext, pos) if lls_grid is not None
                     else None)
        res = sweep_single_source(cfg, tables, ndhi_c, nf, sc,
                                  lls_c=lls_c, max_shell=max_shell,
                                  slab=slab, src_x=pos[0],
                                  nflux_xray=nfx if have_x else None)
        with jax.named_scope("deposition"):
            phih_g = _to_grid(res.phih, pos)
            heat_g = (_to_grid(res.phiheat, pos) if not cfg.isothermal
                      else res.phiheat)
        return phih_g, heat_g, res.photon_loss, res.lls_loss

    vsweep = jax.vmap(sweep_one)

    def one_batch(carry, inp):
        phih_g, heat_g, loss_t, lls_t = carry
        pos, nf, nfx = inp
        ph, he, lo, ll = vsweep(pos, nf, nfx)
        with jax.named_scope("deposition"):
            phih_g = phih_g + jnp.sum(ph, axis=0)
            if not cfg.isothermal:
                heat_g = heat_g + jnp.sum(he, axis=0)
        return (phih_g, heat_g, loss_t + jnp.sum(lo),
                lls_t + jnp.sum(ll)), lo

    zero3 = jnp.zeros((m_rows, n, n), dtype)
    heat0 = zero3 if not cfg.isothermal else jnp.zeros((), dtype)
    carry0 = (zero3, heat0, jnp.zeros((), dtype), jnp.zeros((), dtype))
    (phih, heat, loss, lls_loss), per_src_loss = lax.scan(
        one_batch, carry0, (srcpos_b, nflux_b, nfx_b))
    return phih, heat, loss, lls_loss, per_src_loss.reshape(-1)[:s]


def full_batch_cap(n: int, dtype) -> int:
    """Most sources one full-cube batch may stage: the batch's
    (b, N, N, N) source-centered staging is bounded to ~1 GiB per live
    copy, a fixed fraction of device memory chosen so that the full-cube
    path leaves room for the grid state at the meshes one device holds."""
    return max(1, (1 << 30) // (n * n * n * jnp.dtype(dtype).itemsize))
