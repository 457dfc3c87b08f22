"""Golden regression gates: frozen f64/table-exact cubes of the bundled
reference fixtures at their native 100^3 geometry (VERDICT r1 item 2).

The goldens (tests/fixtures/golden_*.npz, generated by
scripts/make_goldens.py) pin the framework's end-to-end semantics: the
causal sweep, photon-conserving tables, chemistry coupling and the
convergence-iteration structure.  Every backend, dtype and sharding mode
must reproduce them; any drift turns this file red.
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from c2ray_tpu import constants as const
from c2ray_tpu.config import test_problem_config as make_config
from c2ray_tpu.models.sources import SourceModel, read_source_file
from c2ray_tpu.ops.tables import build_rad_tables
from c2ray_tpu.solver import Evolve3D
from c2ray_tpu.state import initial_state

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")

# the frozen problem definition (must match scripts/make_goldens.py)
NH = 1.98e-4
ZRED = 9.0
DT = 1e7 * const.YEAR


def golden_config(n, **kw):
    base = dict(mesh=n, dtype="float64", use_lls=False, cosmological=False,
                rate_eval="table", sweep_backend="facemajor")
    base.update(kw)
    return make_config(**base)


def run_fixture(cfg, src_file, steps=1, raytracer=None, **evolve_kw):
    from c2ray_tpu.ops.thermal import setup_cool
    tabs = build_rad_tables(cfg)
    cool = None if cfg.isothermal else setup_cool(cfg)
    solver = Evolve3D(cfg, tabs, cool=cool, raytracer=raytracer)
    rows = read_source_file(os.path.join(FIXDIR, src_file))
    model = SourceModel.from_recipe(cfg, 7)
    state = initial_state(cfg)
    cat = model.load(rows, np.asarray(state.xh1), 0, cfg.lifetime)
    n = cfg.mesh[0]
    ndens = jnp.full((n, n, n), NH, cfg.jnp_dtype)
    dr = cfg.dr_comoving / (1.0 + ZRED)
    infos = []
    for _ in range(steps):
        state, info = solver.evolve3d(state, ndens, dr, cat.srcpos,
                                      cat.normflux_stellar, DT, **evolve_kw)
        infos.append(info)
    return state, infos


def load_golden(name):
    return np.load(os.path.join(FIXDIR, name))


class TestOnesrcGolden:
    def test_facemajor_reproduces_golden(self):
        g = load_golden("golden_onesrc_100.npz")
        state, infos = run_fixture(golden_config(100),
                                   "test_sources_onesrc.dat")
        np.testing.assert_allclose(np.asarray(state.xh1), g["xh1"],
                                   rtol=1e-12, atol=0)
        assert infos[0].niter == g["niters"][0]

    def test_compressed_storage_reproduces_golden(self):
        """The compressed min-fraction storage mode is a pure re-encoding
        in f64: the decoded cube lands on the golden."""
        from c2ray_tpu.state import xh1_of
        g = load_golden("golden_onesrc_100.npz")
        state, infos = run_fixture(golden_config(100, compressed_xfrac=True),
                                   "test_sources_onesrc.dat")
        np.testing.assert_allclose(np.asarray(xh1_of(state.xh1)), g["xh1"],
                                   rtol=1e-9, atol=1e-13)
        assert infos[0].niter == g["niters"][0]

    def test_grid_backend_reproduces_golden(self):
        """The independent grid-layout wavefront backend must land on the
        same converged cube."""
        g = load_golden("golden_onesrc_100.npz")
        state, infos = run_fixture(golden_config(100, sweep_backend="grid"),
                                   "test_sources_onesrc.dat")
        np.testing.assert_allclose(np.asarray(state.xh1), g["xh1"],
                                   rtol=1e-9, atol=1e-12)

    def test_float32_expsum_tracks_golden(self):
        """The float32 path (f32 + exponential-mixture rates) reproduces
        the golden to documented tolerances (PARITY.md)."""
        g = load_golden("golden_onesrc_100.npz")
        state, infos = run_fixture(
            golden_config(100, dtype="float32", rate_eval="expsum"),
            "test_sources_onesrc.dat")
        assert infos[0].mean_xh1 == pytest.approx(
            float(g["mean_xh1"][0]), rel=2e-3)
        x = np.asarray(state.xh1, np.float64)
        # ionized volume agreement (front position) to sub-cell accuracy
        v32 = x.sum()
        v64 = g["xh1"].sum()
        assert v32 == pytest.approx(v64, rel=2e-3)


class TestStandardGolden:
    def test_facemajor_reproduces_golden(self):
        g = load_golden("golden_standard_100.npz")
        state, infos = run_fixture(golden_config(100),
                                   "test_sources_standard.dat")
        np.testing.assert_allclose(np.asarray(state.xh1), g["xh1"],
                                   rtol=1e-12, atol=0)
        assert infos[0].niter == g["niters"][0]

    def test_source_sharded_reproduces_golden(self):
        """Source sharding over the 8-device CPU mesh is semantics-free:
        the psum'd rates land on the golden cube."""
        from c2ray_tpu.parallel.source_shard import (make_device_mesh,
                                                     sharded_raytracer)
        mesh = make_device_mesh()
        rt = sharded_raytracer(mesh)
        g = load_golden("golden_standard_100.npz")
        state, infos = run_fixture(golden_config(100),
                                   "test_sources_standard.dat",
                                   raytracer=rt)
        np.testing.assert_allclose(np.asarray(state.xh1), g["xh1"],
                                   rtol=1e-10, atol=1e-13)


class TestThermalGolden:
    def test_thermal_lls_reproduces_golden(self):
        from c2ray_tpu.models.lls import set_lls
        g = load_golden("golden_thermal_32.npz")
        cfg = golden_config(32, isothermal=False, use_lls=True,
                            type_of_lls=1, lls_model=5,
                            initial_temperature=100.0)
        dr = cfg.dr_comoving / (1.0 + ZRED)
        lls = set_lls(cfg, ZRED, dr)
        state, infos = run_fixture(cfg, "test_sources_onesrc_32.dat",
                                   steps=2, lls_coldens=lls.coldensh_lls)
        np.testing.assert_allclose(np.asarray(state.xh1), g["xh1"],
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(np.asarray(state.temper_current),
                                   g["temper"], rtol=1e-12, atol=0)


class TestPhotonCountsFormat:
    def test_row_matches_fortran_es_format(self, tmp_path):
        """PhotonCounts columns byte-match the reference's Fortran
        '(f6.3,9(es10.3))' edit descriptor (output.F90:554) for
        representative magnitudes."""
        vals = [1.234e68, 5.0e67, 0.98765, 0.123, 4.5e-3, 0.0,
                6.789e-5, 1.0e-12, 1.5]
        row = f"{8.892:6.3f}" + "".join(f"{v:10.3E}" for v in vals)
        assert row == (" 8.892 1.234E+68 5.000E+67 9.877E-01 1.230E-01"
                       " 4.500E-03 0.000E+00 6.789E-05 1.000E-12 1.500E+00")
        # and the writer emits exactly this shape
        from c2ray_tpu.utils.output import OutputWriter
        from c2ray_tpu.ops.photonstats import PhotonStatistics
        cfg = golden_config(8)
        out = OutputWriter(cfg, results_dir=str(tmp_path) + "/")
        out.setup()
        stats = PhotonStatistics(cfg)
        stats.total_ion = 1.2e68
        stats.dh0 = 1.0e68
        stats.totrec = 2.0e67
        stats.totcollisions = 0.0
        stats.grtotal_ion = 1.2e68
        stats.grtotal_src = 1.5e68
        nd = np.full((8, 8, 8), NH)
        x1 = np.full((8, 8, 8), 0.5)
        out.write_photonstatistics(8.892, 1.0, 3.15e14, stats, 0.0, 0.0,
                                   1.0e54 / cfg.sed.s_star, nd, x1, 1e72)
        out.close_down()
        line = (tmp_path / "PhotonCounts.out").read_text().splitlines()[-1]
        assert line[:6] == " 8.892"
        cols = [line[6 + 10 * i: 6 + 10 * (i + 1)] for i in range(9)]
        assert len(line) == 6 + 90
        for c in cols:
            assert len(c) == 10
            assert c[-4] in "Ee" or c.strip() == ""
            assert "E" in c
