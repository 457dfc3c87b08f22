"""Main driver: redshift-slice loop, timestep loop, outputs, restarts.

Re-implementation of the reference main program (/root/reference/C2Ray.F90):
the startup sequence (:108-198), restart handling (:200-253), the
redshift-slice loop (:267-427) with its inner timestep loop (:352-407),
output cadence and the photon-conservation abort (:395-416).

Also provides a reader for the reference's ordered input-file protocol
(stdin answers, C2Ray.F90:115-127 + material.F90:76-112 +
sourceprops.F90:694-755 + time_module.F90:44-54) so the bundled
inputs/input_example* files drive this framework unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

import jax.numpy as jnp

from . import constants as const
from .config import RunConfig
from .cosmology import CosmoClock
from .models.clumping import ClumpingModel, load_clumping_model  # noqa: F401 (loader re-exported for drivers)
from .models.lls import set_lls
from .models.nbody import NbodyAdapter, test_adapter
from .models.sources import SourceModel, sort_sources_by_flux
from .ops.photonstats import PhotonStatistics
from .ops.tables import build_rad_tables
from .ops.thermal import setup_cool
from .solver import Evolve3D
from .state import GridState, MaterialState, initial_state, uniform_material
from .utils.checkpoint import load_slice_restart
from .utils.clocks import Clocks
from .utils.output import OutputWriter


@dataclass
class DriverConfig:
    """Runtime answers of the reference's stdin protocol."""

    restart: int = 0            # 0 none, 1 slice, 2 mid-slice
    nz0: int = 0                # starting slice (0-based; stdin is 1-based)
    uv_recipe: int = 7          # UV luminosity model (0-7)
    number_timesteps: int = 10  # per slice (time_module.F90:44-48)
    number_outputs: int = 1     # per slice (:51-53)
    redshift_file: str = ""     # cubep3m runs
    uv_file: str = ""           # fixed N_gamma models
    results_dir: str = "./results/"
    dump_dir: str = "./"
    # restart-from-iteration-dump answer (C2Ray.F90:200-226):
    # 0 = no, 1/2 = iterdump1/2, 3 = generic (newest)
    iter_restart: int = 0
    # mid-slice restart redshift (restart=2; C2Ray.F90:238-253)
    zred_interm: float = -1.0
    # gadget runs: single initial redshift instead of a redshift file
    # (nbody_gadget.F90:204-227)
    zred_initial: float = -1.0


def read_input_file(path: str, nbody_type: str = "test") -> DriverConfig:
    """Parse the ordered input protocol (see inputs/input_example_test).

    Lines are answers in a fixed sequence; anything after whitespace is a
    comment.  Sequence (test case): restart y/n, mid-slice y/n, start
    slice, UV recipe, [uv file], timesteps/slice, outputs/slice.  The
    cubep3m case inserts the redshift file after the start slice.
    """
    answers = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if tok:
                answers.append(tok[0])
    return parse_input_answers(answers, nbody_type)


def read_input_stdin(nbody_type: str = "test",
                     stream=None) -> DriverConfig:
    """Read the ordered answers interactively from stdin (the reference's
    no-argv path, C2Ray.F90:115-127: list-directed reads consume the
    answers in sequence).  All whitespace-separated tokens count, so both
    `echo "n n 1 7 1 1" | ...` and one-answer-per-line piping work."""
    import sys
    stream = stream if stream is not None else sys.stdin
    answers = stream.read().split()
    if not answers:            # empty pipe (e.g. < /dev/null): defaults
        return DriverConfig()
    return parse_input_answers(answers, nbody_type)


def parse_input_answers(answers, nbody_type: str = "test") -> DriverConfig:
    """Consume the ordered answer sequence (shared by the input-file and
    stdin protocols)."""
    it = iter(answers)
    dc = DriverConfig()
    restart_yn = next(it).lower().startswith("y")
    mid_yn = next(it).lower().startswith("y")
    dc.restart = (2 if mid_yn else 1) if restart_yn else 0
    dc.nz0 = int(next(it)) - 1
    # redshift-list answer: cubep3m/LG/pmfast read a file of redshifts
    # (nbody_cubep3m.F90:226-261, nbody_pmfast.F90:212-247); gadget reads
    # ONE initial redshift (nbody_gadget.F90:204-227); the test adapter
    # hard-codes its list (nbody_test.F90:212-251)
    if nbody_type in ("cubep3m", "LG", "pmfast"):
        dc.redshift_file = next(it)
    elif nbody_type == "gadget":
        dc.zred_initial = float(next(it))
    dc.uv_recipe = int(next(it))
    if dc.uv_recipe in (1, 2):
        dc.uv_file = next(it)
    dc.number_timesteps = int(next(it))
    dc.number_outputs = int(next(it))
    # trailing restart answers (C2Ray.F90:200-253): iteration-dump answer
    # when restarting, then the intermediate redshift for restart=2
    if dc.restart != 0:
        ans = next(it, "n")
        dc.iter_restart = (3 if ans.lower().startswith("y")
                           else int(ans) if ans in ("0", "1", "2") else 0)
    if dc.restart == 2:
        dc.zred_interm = float(next(it))
    return dc


class C2RayDriver:
    """The full simulation pipeline (program C2Ray equivalent)."""

    def __init__(self, cfg: RunConfig, adapter: Optional[NbodyAdapter] = None,
                 driver_cfg: Optional[DriverConfig] = None,
                 material: Optional[MaterialState] = None,
                 raytracer=None, verbose: bool = True, layout=None):
        self.cfg = cfg
        self.dc = driver_cfg or DriverConfig()
        self.adapter = adapter or test_adapter(cfg)

        # multi-host rank discipline (mpi.F90:83-178): process 0 owns all
        # file I/O; every process runs the same SPMD driver code.  In a
        # single-process run io_rank is True and nothing changes.
        from .parallel import multihost as mh
        self._mh = mh
        self.io_rank = mh.is_io_rank()
        self.verbose = verbose and self.io_rank

        # init sequence (C2Ray.F90:108-198): grid, radiation tables,
        # cooling, material, sources, time, cosmology
        self.clocks = Clocks(os.path.join(self.dc.results_dir, "Timings.log"),
                             enabled=self.io_rank)
        self.tables = build_rad_tables(cfg)
        self.clocks.stamp("Time after radiation tables")
        self.cool = None if cfg.isothermal else setup_cool(cfg)
        # runtime parallel layout (the reference's link-time parallel
        # modes, makefile_core:40-104: one driver, any parallelism):
        # builds the device mesh and the raytracer/chemistry injections
        from .parallel.layout import LayoutRuntime, ParallelLayout
        self.layout = LayoutRuntime(cfg, layout or ParallelLayout(),
                                    cool=self.cool)
        if raytracer is None:
            raytracer = self.layout.raytracer
        self.solver = Evolve3D(cfg, self.tables, cool=self.cool,
                               raytracer=raytracer,
                               chemistry=self.layout.chemistry,
                               windowed=self.layout.windowed,
                               rate_sharding=self.layout.rate_sharding)
        self.stats = PhotonStatistics(cfg)
        self.output = OutputWriter(cfg, results_dir=self.dc.results_dir,
                                   io_enabled=self.io_rank)
        self.output.setup()
        self.source_model = SourceModel.from_recipe(
            cfg, self.dc.uv_recipe, m_grid=self.adapter.m_grid,
            n_box=self.adapter.n_box)
        # fixed-budget UV models read their per-slice photon budgets at
        # init (source_properties_ini, sourceprops.F90:727-753)
        if self.dc.uv_recipe in (1, 2) and self.dc.uv_file:
            # read on the I/O process and broadcast (the reference reads
            # on rank 0 and MPI_BCASTs, sourceprops.F90:727-755)
            from .models.sources import read_uv_file
            self.source_model.uv_array = mh.read_on_io_rank(
                read_uv_file, self.dc.uv_file, self.dc.uv_recipe)
        # load the sub-grid clumping parameter files at startup, passing
        # the grid resolution (C2Ray.F90:264 load_clumping_model(dr(1));
        # the file names carry the resolution in Mpc at f5.3,
        # clumping_module.F90:122-223).  Types 1/5 need no parameters.
        if cfg.type_of_clumping in (2, 3, 4):
            self.clumping_model = load_clumping_model(
                cfg, resolution_mpc=cfg.dr_comoving / const.MPC,
                params_dir=self.adapter.dir_clump.rstrip("/") or None)
        else:
            self.clumping_model = ClumpingModel(cfg=cfg)
        self.material = material
        self.clock = CosmoClock.init(cfg.cosmo,
                                     float(self.adapter.zred_array[0]))
        # 15-minute double-buffered iteration dumps (evolve.F90:253-266),
        # written by the I/O process only (:258 `if (rank == 0)`)
        from .utils.checkpoint import IterDumper
        collective_dump = (self.layout.sharded_grid
                           and mh.process_count() > 1)
        self.dumper = IterDumper(dump_dir=self.dc.dump_dir,
                                 enabled=self.io_rank or collective_dump,
                                 collective=collective_dump)
        self.history = []
        # rank-0 run log (the reference's results/C2Ray.log, unit logf=30,
        # mpi.F90:93-151): every driver message is teed into it
        self._logf = None
        if self.io_rank:
            try:
                self._logf = open(os.path.join(self.dc.results_dir,
                                               "C2Ray.log"), "a")
            except OSError:
                pass

    def _log(self, *msg):
        if self.verbose:
            print(*msg, flush=True)
        if self._logf is not None:
            print(*msg, file=self._logf, flush=True)

    def _x1(self, state) -> np.ndarray:
        """Dense ionized fraction (decodes compressed storage)."""
        if self.cfg.compressed_xfrac:
            from .state import xh1_of
            return np.asarray(xh1_of(state.xh1))
        return np.asarray(state.xh1)

    def _x1_dev(self, state):
        """Dense ionized fraction as a DEVICE array (keeps a sharded
        layout sharded; gathers/reductions on it stay device-side)."""
        if self.cfg.compressed_xfrac:
            from .state import xh1_of
            return xh1_of(state.xh1)
        return state.xh1

    def _restart_sharded(self, zred: float) -> GridState:
        """Slice restart with per-slab reads into the sharded layout
        (same math as utils.checkpoint.load_slice_restart)."""
        from .models.nbody import fortran_f6_3
        from .utils.io_fortran import read_sm3d_slab
        cfg = self.cfg
        zs = fortran_f6_3(zred)
        xpath = os.path.join(self.dc.results_dir, f"xfrac3D_{zs}.bin")

        def x_slab(r0, m):
            x = read_sm3d_slab(xpath, np.float64, cfg.mesh, r0, m)
            if cfg.compressed_xfrac:
                x = np.where(x <= 0.5, x,
                             np.where(x < 1.0, -(1.0 - x), 1.0))
            return x

        xh1 = self.layout.make_sharded(x_slab)
        if cfg.isothermal:
            return GridState(xh1=xh1)
        tpath = os.path.join(self.dc.results_dir, f"Temper3D_{zs}.bin")
        t = self.layout.make_sharded(
            lambda r0, m: read_sm3d_slab(tpath, np.float32, cfg.mesh, r0, m))
        return GridState(xh1=xh1, temper_current=t, temper_av=t,
                         temper_intermed=t)

    # ------------------------------------------------------------------
    def run(self, max_slices: Optional[int] = None) -> GridState:
        cfg = self.cfg
        dc = self.dc
        ad = self.adapter
        zreds = ad.zred_array

        # material initialization (material.F90:44-134); a sharded layout
        # lays the fields out P(dom) from the start
        if self.material is None:
            if ad.nbody_type == "test":
                self.material = uniform_material(cfg)
            else:
                self.material = MaterialState(
                    ndens_comoving=jnp.zeros(cfg.mesh, cfg.jnp_dtype))
        if self.layout.sharded_grid:
            self.material = MaterialState(
                *[self.layout.shard_grid(f) for f in self.material])

        # restart handling (C2Ray.F90:200-253); restart cubes are read on
        # the I/O process and broadcast (xfrac_restart_init reads on the
        # master and MPI_BCASTs, ionfractions_module.F90:56-120).  In a
        # sharded layout every process slab-reads its own rows instead
        # (the cubes are seekable; no full-grid materialization).
        def _restart_from(zr):
            if self.layout.sharded_grid:
                return self._restart_sharded(zr)
            vals = self._mh.read_on_io_rank(
                lambda: tuple(None if x is None else np.asarray(x)
                              for x in load_slice_restart(
                                  cfg, dc.results_dir, zr)))
            return GridState(*[None if v is None else jnp.asarray(v)
                               for v in vals])

        nz0 = dc.nz0
        if dc.restart == 2:
            # mid-slice restart: resume from an intermediate output
            # redshift, with the reference's consistency check
            # (C2Ray.F90:238-253)
            if not (zreds[nz0 + 1] <= dc.zred_interm <= zreds[nz0]):
                raise ValueError(
                    f"restart=2: zred_interm {dc.zred_interm} outside slice "
                    f"[{zreds[nz0 + 1]}, {zreds[nz0]}]")
            state = _restart_from(dc.zred_interm)
        elif dc.restart == 1:
            state = _restart_from(float(zreds[nz0]))
        else:
            state = self.layout.shard_state(initial_state(cfg))

        # restart-from-iteration-dump (C2Ray.F90:200-226): consumed by the
        # first evolve3d call only (evolve.F90:154-158)
        iter_restart = None
        if dc.restart != 0 and dc.iter_restart:
            from .utils.checkpoint import IterDumper

            def _load_dump():
                which = dc.iter_restart
                if which == 3:   # generic: newest valid dump
                    cands = [(i, os.path.join(dc.dump_dir,
                                              f"iterdump{i}.npz"))
                             for i in (1, 2)]
                    cands = [(i, p) for i, p in cands if os.path.exists(p)]
                    which = (max(cands, key=lambda t: os.path.getmtime(t[1]))
                             [0] if cands else 0)
                return (IterDumper.load(dc.dump_dir, which), which) \
                    if which else (None, 0)

            iter_restart, which = self._mh.read_on_io_rank(_load_dump)
            if iter_restart is not None:
                self._log(f"resuming from iterdump{which} "
                          f"(niter={int(iter_restart['niter'])})")

        sim_time = self.clock.zred2time(float(zreds[nz0]))
        n_slices = len(zreds) - 1
        if max_slices is not None:
            n_slices = min(n_slices, nz0 + max_slices)
        if n_slices <= nz0:
            # a single-redshift list cannot evolve (the slice loop needs
            # z_next; the reference's do nz=nz0,NumZred-1 is equally
            # degenerate at NumZred=1) - say so instead of silently
            # returning the initial state
            self._log(f"WARNING: {len(zreds)} redshift(s) from slice "
                      f"{nz0}: nothing to evolve (need z_next per slice)")

        for nz in range(nz0, n_slices):
            zred = float(zreds[nz])
            zred_next = float(zreds[nz + 1])
            self.clocks.stamp(f"Time before slice z={zred:.3f}")

            # set_timesteps (time_module.F90:72-98)
            end_time = self.clock.zred2time(zred_next)
            dt = (end_time - self.clock.zred2time(zred)) / dc.number_timesteps
            output_dt = (end_time - self.clock.zred2time(zred)) / dc.number_outputs
            next_output_time = sim_time + output_dt

            # mid-slice restart: re-derive the simulation time from the
            # intermediate redshift (C2Ray.F90:319-333; like the
            # reference, exact one-dt alignment is snapped)
            if dc.restart >= 2 and nz == nz0:
                t_slice = self.clock.zred2time(zred)
                interm_zred = self.clock.time2zred(t_slice + dt)
                if abs(interm_zred - dc.zred_interm) < 0.001:
                    sim_time = t_slice + dt
                else:
                    sim_time = self.clock.zred2time(dc.zred_interm)
                next_output_time = end_time

            # per-slice sources (C2Ray.F90:303, sourceprops.F90:103-209)
            sup_file = ad.source_filename(zred, nz,
                                          "_sources_used_wfgamma.dat")
            # catalogs are read on the I/O process and broadcast (the
            # reference reads on rank 0 and MPI_BCASTs the source arrays,
            # sourceprops.F90:154-209,246-263)
            if (dc.restart >= 2 and nz == nz0
                    and self.source_model.uv_model != "Test"
                    and self._mh.read_on_io_rank(os.path.exists, sup_file)):
                # reproduce the restart's suppression state from the saved
                # post-suppression list (sourceprops.F90:422-429,452-466)
                from .models.sources import read_suppressed_source_list
                cat = self._mh.read_on_io_rank(
                    read_suppressed_source_list, sup_file)
            else:
                rows = self._mh.read_on_io_rank(ad.read_sources, zred, nz)
                # suppression gathers x1 at the source cells ON DEVICE
                # (models/sources.py), so a sharded state stays sharded
                cat = self.source_model.load(rows, self._x1_dev(state), nz,
                                             end_time - sim_time, dt_slice=dt)
                if cat.num_src == 0:
                    # bank the slice's photon budget (sourceprops.F90:199-207)
                    self.source_model.bank_photons(nz)
                elif (self.source_model.uv_model != "Test"
                      and sup_file != ad.source_filename(zred, nz)
                      and self.io_rank):
                    # record the post-suppression list for reproducible
                    # restarts (sourceprops.F90:434-450, rank-0 write :154)
                    from .models.sources import write_suppressed_source_list
                    write_suppressed_source_list(sup_file, cat)
            cat = sort_sources_by_flux(cat)
            self._log(f"slice z={zred:.3f}: {cat.num_src} sources, "
                      f"total flux {cat.total_flux * cfg.sed.s_star:.3e} /s")

            # per-slice density (C2Ray.F90:308, density_module.F90:48-125;
            # read on the I/O process + broadcast like the reference's
            # rank-0 read + MPI_BCAST, density_module.F90:82-125)
            if ad.nbody_type not in ("test",):
                if self.layout.sharded_grid:
                    # each process slab-reads its own rows directly from
                    # the (seekable) density cube - no broadcast_obj of
                    # the whole grid, no full-cube materialization
                    # anywhere (the whole point of the halo layout; the
                    # reference instead BCASTs the cube into every rank,
                    # density_module.F90:82-125)
                    zfac = ((1.0 + zred) ** 3 if cfg.cosmological else 1.0)

                    def nd_slab(r0, m):
                        return ad.read_density_slab(zred, nz, r0, m) / \
                            cfg.np_dtype(zfac)

                    ndc = self.layout.make_sharded(nd_slab)
                else:
                    nd_prop = self._mh.read_on_io_rank(
                        ad.read_density, zred, nz)   # proper at zred
                    comoving = (nd_prop / (1.0 + zred) ** 3
                                if cfg.cosmological else nd_prop)
                    ndc = jnp.asarray(comoving)
                self.material = MaterialState(
                    ndens_comoving=ndc,
                    clumping_grid=self.material.clumping_grid,
                    lls_grid=self.material.lls_grid)

            # per-slice precomputed grids (C2Ray.F90:312-313): the grid
            # clumping cube (type 5) and normalized LLS cross-section cube
            # (type 2) are read from the adapter's files unless injected
            # via MaterialState
            clump_grid_slice = None
            if cfg.type_of_clumping == 5:
                if self.material.clumping_grid is not None:
                    clump_grid_slice = (
                        self.layout.shard_grid(self.material.clumping_grid)
                        if self.layout.sharded_grid
                        else np.asarray(self.material.clumping_grid))
                elif self.layout.sharded_grid:
                    # halo layout: per-process slab reads (no host cube)
                    clump_grid_slice = self.layout.make_sharded(
                        lambda r0, nr: ad.read_clumping_grid_slab(
                            zred, r0, nr))
                else:
                    clump_grid_slice = self._mh.read_on_io_rank(
                        ad.read_clumping_grid, zred)
            lls_grid_slice = self.material.lls_grid
            lls_slice = None
            if cfg.use_lls and cfg.type_of_lls == 2:
                if lls_grid_slice is None:
                    if self.layout.sharded_grid:
                        lls_grid_slice = self.layout.make_sharded(
                            lambda r0, nr: ad.read_lls_grid_slab(
                                zred, r0, nr),
                            dtype=cfg.np_dtype)
                    else:
                        lls_grid_slice = self._mh.read_on_io_rank(
                            ad.read_lls_grid, zred)
                elif self.layout.sharded_grid:
                    lls_grid_slice = self.layout.shard_grid(
                        jnp.asarray(lls_grid_slice, cfg.np_dtype))
                # type-2 LLS columns are converted ONCE per slice at the
                # slice redshift (C2Ray.F90:313; the timestep loop at
                # :376 explicitly skips set_LLS for type 2)
                zp1_slice = (1.0 + zred) if cfg.cosmological else 1.0
                import jax as _jax
                if isinstance(lls_grid_slice, _jax.Array):
                    from .models.lls import set_lls_device
                    lls_slice = set_lls_device(
                        cfg, zred, cfg.dr_comoving / zp1_slice,
                        lls_grid_slice)
                else:
                    lls_slice = set_lls(cfg, zred,
                                        cfg.dr_comoving / zp1_slice,
                                        lls_grid_slice)

            # inner timestep loop (C2Ray.F90:352-407)
            while sim_time < end_time - 1e-6 * abs(dt):
                actual_dt = min(next_output_time - sim_time, dt)
                if cfg.cosmological:
                    self.clock.redshift_evol(sim_time + 0.5 * actual_dt)
                    z_now = self.clock.zred
                else:
                    # non-cosmological runs keep the slice redshift: the
                    # clumping C(z) and LLS mfp(z) models still see the
                    # actual epoch (C2Ray.F90:375-376 passes zred always)
                    z_now = zred
                zp1 = (1.0 + z_now) if cfg.cosmological else 1.0
                nd_proper = self.material.ndens_comoving * cfg.np_dtype(zp1**3)
                dr_proper = cfg.dr_comoving / zp1

                # per-step clumping + LLS (C2Ray.F90:375-376).  Scalar
                # models (types 1/2) need no density grid; per-cell
                # models (3/4) evaluate elementwise ON DEVICE — works on
                # replicated and slab-sharded grids alike, and the
                # type-4 counter-based draw is sharding-invariant, so
                # every layout produces the identical clumping cube
                if cfg.type_of_clumping in (1, 2):
                    clump = self.clumping_model.evaluate(z_now)
                elif cfg.type_of_clumping == 5:
                    clump = self.clumping_model.evaluate(
                        z_now, grid_file_reader=lambda _z: clump_grid_slice)
                else:
                    from .models.clumping import evaluate_device
                    avg_dens = float(jnp.mean(
                        self.material.ndens_comoving)) * zp1**3
                    clump = evaluate_device(self.clumping_model, z_now,
                                            nd_proper, avg_dens)
                lls = (lls_slice if lls_slice is not None
                       else set_lls(cfg, z_now, dr_proper, lls_grid_slice))
                cosmo_cool_coeff = 0.0
                if cfg.cosmological and not cfg.isothermal:
                    p = cfg.cosmo
                    dzdt = p.H0 * (1 + z_now) * np.sqrt(
                        p.omega0 * (1 + z_now) ** 3 + 1 - p.omega0)
                    cosmo_cool_coeff = 2.0 / (1 + z_now) * dzdt

                if cat.num_src > 0:
                    state, info = self.solver.evolve3d(
                        state, nd_proper, dr_proper, cat.srcpos,
                        cat.normflux_stellar, actual_dt,
                        clumping=clump, lls_coldens=lls.coldensh_lls,
                        rmax_cells=lls.r_max_cells,
                        lls_grid=(jnp.asarray(lls.grid)
                                  if lls.grid is not None else None),
                        cosmo_cool_coeff=cosmo_cool_coeff, stats=self.stats,
                        dumper=self.dumper, iter_restart=iter_restart,
                        clocks=self.clocks,
                        nflux_xray=(cat.normflux_xray
                                    if cfg.sed.use_xray_sed else None),
                        # per-iteration convergence statistics, as the
                        # reference logs each iteration
                        # (evolve.F90:206-209)
                        verbose=self.verbose and cfg.log_convergence)
                else:
                    # no active sources: the reference skips evolve3D
                    # entirely for this step (C2Ray.F90:379)
                    from .solver import EvolveInfo
                    info = EvolveInfo(
                        niter=0, conv_flag=0, converged=True,
                        mean_xh1=float(jnp.mean(self._x1_dev(state))),
                        photon_loss=0.0, lls_loss=0.0,
                        per_source_loss=np.zeros(0), photon_stats={})
                iter_restart = None   # consumed by the first step only
                sim_time += actual_dt
                self.history.append(dict(z=z_now, t=sim_time, **info._asdict()))
                self._log(f"  t={sim_time / (1e6 * const.YEAR):8.2f} Myr "
                          f"niter={info.niter} converged={info.converged} "
                          f"mean_x={info.mean_xh1:.5f} "
                          f"photcons={info.photon_stats.get('photon_cons', 0):.4f}")

                # output cadence (C2Ray.F90:389-403)
                # per-step memory report into the run log (the reference
                # calls report_memory every timestep into logf,
                # C2Ray.F90:354, report_memory.f90:52)
                if self._logf is not None:
                    from .utils.report_memory import format_memory_report
                    print(f"  memory: {format_memory_report()}",
                          file=self._logf, flush=True)

                if abs(sim_time - next_output_time) <= 1e-6 * abs(actual_dt):
                    next_output_time += output_dt
                    flag = self._write_outputs(zred_next if abs(
                        sim_time - end_time) < 1e-6 * abs(dt) else
                        self.clock.time2zred(sim_time),
                        sim_time, actual_dt, state, nd_proper,
                        dr_proper, info, cat)
                    if flag and cfg.stop_on_photon_violation:
                        self._log("PhotonConservation violated, stopping")
                        self.output.close_down()
                        return state
                self.clocks.stamp("Time after timestep")

        self.output.close_down()
        self.clocks.report()
        return state

    # ------------------------------------------------------------------
    def _write_outputs(self, zred, sim_time, dt, state, nd_proper,
                       dr_proper, info, cat) -> int:
        cfg = self.cfg
        out = self.output
        vol = float(dr_proper) ** 3
        x1 = self._x1_dev(state)      # device view; sharded stays sharded
        if out.streams[0]:
            from .parallel.layout import replicate_to_host as r2h
            x_coords = (np.arange(cfg.mesh[0]) + 0.5) * float(dr_proper)
            src0 = cat.srcpos[0] if cat.num_src else (0, 0, 0)
            j, k = int(src0[1]), int(src0[2])
            t_line = (None if state.temper_current is None
                      else r2h(state.temper_current[:, j, k]))
            out.write_stream1(zred, x_coords, r2h(x1[:, j, k]),
                              t_line, r2h(nd_proper[:, j, k]))
        if out.streams[1]:
            out.write_stream2(zred, x1, state.temper_current)
        if out.streams[2] and info.phih is not None:
            out.write_stream3(zred, info.phih, info.phiheat)
        if out.streams[3]:
            out.write_stream4(zred, x1)
        if out.streams[4]:
            out.write_stream5(zred, nd_proper)
        return out.write_photonstatistics(
            zred, sim_time, dt, self.stats, info.photon_loss, info.lls_loss,
            cat.total_flux, nd_proper, x1, vol)
