"""Solver-level physics tests: Strömgren sphere vs analytic, multi-source
convergence, photon conservation.

These are the framework's equivalent of the reference's test problem
harness (SURVEY.md section 4): the analytic I-front growth
r_I(t) = r_S (1 - e^{-t/t_rec})^{1/3} is the classic C2-Ray validation
(Mellema et al. 2006 Test 1; mainpage.h:13-21).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from c2ray_tpu import constants as const
from c2ray_tpu.config import test_problem_config as make_config
from c2ray_tpu.ops.photonstats import PhotonStatistics
from c2ray_tpu.ops.tables import build_rad_tables
from c2ray_tpu.solver import Evolve3D
from c2ray_tpu.state import GridState, initial_state


def run_stromgren(n=32, steps=10, t_end_frac=0.25, grey=False):
    """Static uniform medium, single central source (the onesrc fixture
    physics: 1e57 photons/s BB source in mean z=9 density); returns
    measured and analytic ionized volumes at each step."""
    cfg = make_config(mesh=n, dtype="float64", use_lls=False,
                      cosmological=False, grey=grey)
    tabs = build_rad_tables(cfg)
    solver = Evolve3D(cfg, tabs)

    nh = 1.98e-4                    # mean baryon density at z=9 [cm^-3]
    s_phot = 1e57                   # photons/s (test_sources_onesrc.dat)
    alpha = const.BH00              # T = 1e4 K
    t_rec = 1.0 / (alpha * nh)
    r_s = (3.0 * s_phot / (4.0 * np.pi * alpha * nh * nh)) ** (1.0 / 3.0)
    dr = r_s / 5.0                  # Strömgren radius = 5 cells

    state = initial_state(cfg)
    ndens = jnp.full((n, n, n), nh)
    src = np.array([[n // 2, n // 2, n // 2]], np.int32)
    nflux = np.array([s_phot / cfg.sed.s_star])
    dt = t_end_frac * t_rec / steps
    t = 0.0
    vols, vols_exact = [], []
    for _ in range(steps):
        state, info = solver.evolve3d(state, ndens, dr, src, nflux, dt)
        t += dt
        assert info.converged
        # ionized volume in cells (subtract the uniform background x)
        v = float(jnp.sum(state.xh1 - cfg.initial_xh))
        vols.append(v)
        r_exact = r_s * (1.0 - np.exp(-t / t_rec)) ** (1.0 / 3.0)
        vols_exact.append(4.0 / 3.0 * np.pi * (r_exact / dr) ** 3)
    return np.array(vols), np.array(vols_exact), r_s / dr


class TestStromgren:
    def test_ifront_tracks_analytic(self):
        """Ionized volume within a few % of the analytic Strömgren growth
        (gate iii of SURVEY.md 7.4, 2% on radius ~ 6% on volume)."""
        vols, vols_exact, _ = run_stromgren(n=32, steps=8, t_end_frac=0.3)
        # skip the first couple of steps (front inside a few cells:
        # discretization dominates)
        ratio = vols[2:] / vols_exact[2:]
        r_err = np.abs(ratio ** (1.0 / 3.0) - 1.0)
        assert np.all(r_err < 0.03), (ratio, r_err)

    def test_ifront_monotonic(self):
        vols, _, _ = run_stromgren(n=24, steps=5, t_end_frac=0.2)
        assert np.all(np.diff(vols) > 0)


class TestPhotonConservation:
    def test_photcons_within_tolerance(self):
        """Photon conservation audit stays well within the reference's 15%
        violation threshold (output.F90:588-598) and near 1 after the
        first step."""
        n = 32
        cfg = make_config(mesh=n, dtype="float64", use_lls=False,
                          cosmological=False)
        tabs = build_rad_tables(cfg)
        solver = Evolve3D(cfg, tabs)
        stats = PhotonStatistics(cfg)
        nh = 1.98e-4
        dr = 5.7e24
        state = initial_state(cfg)
        ndens = jnp.full((n, n, n), nh)
        src = np.array([[16, 16, 16]], np.int32)
        nflux = np.array([1e57 / cfg.sed.s_star])
        dt = 0.05 / (const.BH00 * nh)
        photcons = []
        for _ in range(4):
            state, info = solver.evolve3d(state, ndens, dr, src, nflux, dt,
                                          stats=stats)
            photcons.append(info.photon_stats["photon_cons"])
        # first steps carry the near-source discretization deficit (see
        # test_sweep.py); the audit settles toward 1 as the front expands
        assert abs(photcons[0] - 1.0) < 0.15
        for pc in photcons[1:]:
            assert abs(pc - 1.0) < 0.07, photcons
        assert abs(photcons[-1] - 1.0) < 0.05, photcons


class TestMultiSource:
    def test_standard_fixture(self):
        """The bundled 10-source problem (overlapping I-fronts + isolated
        sources; reference inputs/test_sources_standard.dat) converges and
        conserves photons."""
        from c2ray_tpu.models.sources import SourceModel, read_source_file
        n = 25  # fixture positions span 1..100 on a 100-mesh; scale by 1/4
        cfg = make_config(mesh=n, dtype="float64", use_lls=False,
                          cosmological=False)
        tabs = build_rad_tables(cfg)
        solver = Evolve3D(cfg, tabs)
        rows = read_source_file("tests/fixtures/test_sources_standard.dat")
        rows[:, 0:3] = np.ceil(rows[:, 0:3] / 4.0)  # rescale to 25^3
        model = SourceModel.from_recipe(cfg, 7)  # "Test"
        state = initial_state(cfg)
        cat = model.load(rows, np.asarray(state.xh1), 0, cfg.lifetime)
        assert cat.num_src == 10
        nh = 1.98e-4
        dr = 2.3e24      # ~100/h Mpc comoving box at z=9 scaled to 25 cells
        ndens = jnp.full((n, n, n), nh)
        stats = PhotonStatistics(cfg)
        dt = 0.016 / (const.BH00 * nh)   # ~10 Myr
        for _ in range(3):
            state, info = solver.evolve3d(state, ndens, dr, cat.srcpos,
                                          cat.normflux_stellar, dt, stats=stats)
            assert info.converged
        assert abs(info.photon_stats["photon_cons"] - 1.0) < 0.1
        x = np.asarray(state.xh1)
        # source cells with enough photons to ionize their own cell's atoms
        # must be ionized (the weakest 1e54 source cannot at this cell size)
        atoms_per_cell = nh * dr**3
        for pos, flux in zip(cat.srcpos, cat.normflux_stellar):
            if flux * cfg.sed.s_star * 3 * dt > 3 * atoms_per_cell:
                assert x[pos[0], pos[1], pos[2]] > 0.9, (pos, flux)

    def test_float32_matches_float64(self):
        """The f32 production path reproduces f64 mean ionization to ~1e-3."""
        results = {}
        for dtype in ("float64", "float32"):
            n = 16
            cfg = make_config(mesh=n, dtype=dtype, use_lls=False,
                              cosmological=False)
            tabs = build_rad_tables(cfg)
            solver = Evolve3D(cfg, tabs)
            state = initial_state(cfg)
            ndens = jnp.full((n, n, n), cfg.np_dtype(1.98e-4))
            src = np.array([[8, 8, 8]], np.int32)
            nflux = np.array([1e57 / cfg.sed.s_star])
            dt = 0.02 / (const.BH00 * 1.98e-4)
            for _ in range(3):
                state, info = solver.evolve3d(state, ndens, 2.9e24, src, nflux, dt)
            results[dtype] = info.mean_xh1
        assert results["float32"] == pytest.approx(results["float64"],
                                                   rel=2e-3)


class TestLLS:
    def test_lls_absorbs_photons(self):
        """Homogeneous LLS opacity (type 1) slows the I-front and registers
        LLS losses."""
        n = 24
        base = dict(mesh=n, dtype="float64", cosmological=False)
        cfg0 = make_config(**base, use_lls=False)
        cfg1 = make_config(**base, use_lls=True, type_of_lls=1, lls_model=5)
        nh = 1.98e-4
        dr = 2.9e24
        res = {}
        for key, cfg in (("off", cfg0), ("on", cfg1)):
            tabs = build_rad_tables(cfg)
            solver = Evolve3D(cfg, tabs)
            state = initial_state(cfg)
            ndens = jnp.full((n, n, n), nh)
            src = np.array([[12, 12, 12]], np.int32)
            nflux = np.array([1e57 / cfg.sed.s_star])
            dt = 0.02 / (const.BH00 * nh)
            # strong LLS fog: one mfp per 2 cells
            lls_col = 0.5 / const.SIGMA_HI_AT_ION_FREQ if key == "on" else 0.0
            state, info = solver.evolve3d(state, ndens, dr, src, nflux, dt,
                                          lls_coldens=lls_col)
            res[key] = info
        assert res["on"].lls_loss > 0.0
        assert res["off"].lls_loss == 0.0

    def test_rmax_barrier(self):
        """Type-3 LLS: no ionization beyond the R_max barrier."""
        n = 24
        cfg = make_config(mesh=n, dtype="float64", cosmological=False,
                          use_lls=True, type_of_lls=3)
        tabs = build_rad_tables(cfg)
        solver = Evolve3D(cfg, tabs)
        state = initial_state(cfg)
        ndens = jnp.full((n, n, n), 2e-6)   # thin: front would cross the box
        src = np.array([[12, 12, 12]], np.int32)
        nflux = np.array([1e57 / cfg.sed.s_star])
        dt = 3e15
        state, info = solver.evolve3d(state, ndens, 2.9e24, src, nflux, dt,
                                      rmax_cells=4.0)
        x = np.asarray(state.xh1)
        assert x[12, 12, 12] > 0.9
        assert x[12 + 4, 12, 12] > 0.9       # inside the barrier
        # outside: only the (tiny) collisional drift from the initial value
        assert x[12 + 6, 12, 12] == pytest.approx(cfg.initial_xh, rel=1e-2)


class TestNonIsothermal:
    def test_heating_raises_temperature(self):
        """Non-isothermal run: photo-heating raises T inside the HII region,
        leaves it untouched outside (thermal.f90 + heat tables)."""
        n = 16
        cfg = make_config(mesh=n, dtype="float64", use_lls=False,
                          cosmological=False, isothermal=False,
                          initial_temperature=100.0)
        from c2ray_tpu.ops.thermal import setup_cool
        tabs = build_rad_tables(cfg)
        solver = Evolve3D(cfg, tabs, cool=setup_cool(cfg))
        state = initial_state(cfg)
        assert state.temper_current is not None
        ndens = jnp.full((n, n, n), 1.98e-4)
        src = np.array([[8, 8, 8]], np.int32)
        nflux = np.array([1e9])
        dt = 3.1e14
        for _ in range(2):
            state, info = solver.evolve3d(state, ndens, 2.9e24, src, nflux, dt)
        t = np.asarray(state.temper_current)
        x = np.asarray(state.xh1)
        assert x[8, 8, 8] > 0.9
        # ionized gas photo-heated to ~1e4 K; neutral gas stays cold
        assert t[8, 8, 8] > 3000.0, t[8, 8, 8]
        assert t[0, 0, 0] == pytest.approx(100.0, rel=1e-3)
        # temperature states are consistent
        assert np.all(t >= 100.0 - 1e-6)


class TestAdaptiveSweep:
    def test_adaptive_matches_full_sweep(self):
        """Adaptive per-source radii (subbox analogue) reproduce the
        full-grid sweep once promotion converges."""
        n = 32
        base = dict(mesh=n, dtype="float64", use_lls=False,
                    cosmological=False)
        nh = 1.98e-4
        dr = 5.7e24 / 2
        src = np.array([[16, 16, 16], [4, 28, 9]], np.int32)
        nflux = np.array([1e57, 1e55]) / 1e48
        dt = 0.01 / (const.BH00 * nh)
        results = {}
        for key, extra in [("full", {}),
                           ("adaptive", dict(adaptive_sweep=True,
                                             adaptive_min_shell=4))]:
            cfg = make_config(**base, **extra)
            tabs = build_rad_tables(cfg)
            solver = Evolve3D(cfg, tabs)
            state = initial_state(cfg)
            ndens = jnp.full((n, n, n), nh)
            for _ in range(2):
                state, info = solver.evolve3d(state, ndens, dr, src, nflux, dt)
            results[key] = np.asarray(state.xh1)
        # fronts are well inside the box; the capped sweeps converge to the
        # same answer after promotion
        diff = np.abs(results["adaptive"] - results["full"])
        assert diff.max() < 1e-3, diff.max()
        assert np.mean(results["adaptive"]) == pytest.approx(
            np.mean(results["full"]), rel=1e-3)
