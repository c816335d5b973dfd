"""Port parity of the 3-D host analysis (``geo/``), float64 on the CPU.

* great circles, ``GeoMap`` bilinear values, the NaN-aware Gaussian
  smoother (1e-12 of each field's max: both are the same separable
  edge-padded convolution, summed in a different order) and the
  spline-in-tension smoother (1e-10 of max: the port's orthonormal
  DCT-II / DCT-III is built on ``torch.fft``, the JAX one on its own
  FFT), against the JAX package's on seeded fields with holes;
* the exchange containers' round trip and the decoration cases of
  tests/test_decorations.py, against the JAX package's;
* ``Model3D`` on one directory of npz chain files (a 2 x 2 grid of
  PointCascadia posteriors) loaded by both packages: Vs maps, profiles
  and sections to 1e-9 km/s (the posterior models are the same
  numbers; only their float64 grid builds differ), the predicted phase
  velocities to 1e-7 km/s (two float64 solves, tests/test_torch_point.py
  holds them to 1e-8), parameter-space and physical-grid smoothing to
  1e-10 of each field's max, the phase-velocity QC maps, the write /
  load round trip, and one section plot and one QC figure under Agg.
"""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from test_compiled_mcmc import (LOCAL, PERIODS, SETTING,  # noqa: E402
                                UNCERS, VELS)

from pysurfinv_tpu.geo import decorations as jdec  # noqa: E402
from pysurfinv_tpu.geo import exchange as jex  # noqa: E402
from pysurfinv_tpu.geo import grid as jgrid  # noqa: E402
from pysurfinv_tpu.geo.model3d import Model3D as JaxModel3D  # noqa: E402
from pysurfinv_tpu_torch.geo import decorations as tdec  # noqa: E402
from pysurfinv_tpu_torch.geo import exchange as tex  # noqa: E402
from pysurfinv_tpu_torch.geo import grid as tgrid  # noqa: E402
from pysurfinv_tpu_torch.geo.model3d import Model3D  # noqa: E402
from pysurfinv_tpu_torch.inversion.point import PointCascadia  # noqa: E402

torch.set_num_threads(1)

CPU = dict(device="cpu")
T5, V5, U5 = PERIODS[::4], VELS[::4], UNCERS[::4]


def _of_max(got, ref, tol):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    scale = np.nanmax(np.abs(ref))
    assert np.nanmax(np.abs(got - ref)) <= tol * scale


def _field(seed=3):
    rng = np.random.default_rng(seed)
    lons = np.arange(0.0, 12.01, 0.25)
    lats = np.arange(40.0, 48.01, 0.25)
    LO, LA = np.meshgrid(lons, lats)
    base = 4.0 + 0.3 * np.sin(2 * np.pi * LO / 8.0) * np.cos(
        2 * np.pi * LA / 6.0)
    z = np.stack([base + 0.05 * rng.standard_normal(base.shape),
                  np.where(LO < 6.0, 4.0, 4.5)])
    z[0, 5:8, 10:14] = np.nan  # a data hole
    z[1, 20, 3] = np.nan
    return lons, lats, z


def test_great_circles_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(8):
        lat1, lat2 = rng.uniform(-60, 60, 2)
        lon1, lon2 = rng.uniform(-180, 180, 2)
        a = tgrid.gc_inverse(lat1, lon1, lat2, lon2)
        b = jgrid.gc_inverse(lat1, lon1, lat2, lon2)
        assert a == pytest.approx(b, rel=1e-12)
        a = tgrid.gc_direct(lat1, lon1, a["azi1"], 0.3 * a["s12"])
        b = jgrid.gc_direct(lat1, lon1, b["azi1"], 0.3 * b["s12"])
        assert a == pytest.approx(b, rel=1e-12)


@pytest.mark.parametrize("width", [60.0, 150.0])
def test_gaussian_smooth_matches_jax(width):
    lons, lats, z = _field()
    got = tgrid.gaussian_smooth_nan(lons, lats, z, width, **CPU)
    ref = jgrid.gaussian_smooth_nan(lons, lats, z, width)
    for g, r in zip(got, ref):
        _of_max(g, r, 1e-12)
    got = tgrid.gaussian_smooth_nan_fill(lons, lats, z, width, **CPU)
    ref = jgrid.gaussian_smooth_nan_fill(lons, lats, z, width)
    assert np.isfinite(got).all()
    for g, r in zip(got, ref):
        _of_max(g, r, 1e-12)
    _of_max(tgrid.mapSmooth(lons, lats, z[0], width=width, **CPU),
            jgrid.mapSmooth(lons, lats, z[0], width=width), 1e-12)


@pytest.mark.parametrize("tension", [0.01, 0.5, 0.9])
def test_tension_smooth_matches_jax(tension):
    lons, lats, z = _field()
    got = tgrid.tension_spline_smooth(lons, lats, z, 150.0, tension, **CPU)
    ref = jgrid.tension_spline_smooth(lons, lats, z, 150.0, tension)
    for g, r in zip(got, ref):
        _of_max(g, r, 1e-10)
    _of_max(tgrid.mapSmooth(lons, lats, z[0], tension=tension, width=80.0,
                            **CPU),
            jgrid.mapSmooth(lons, lats, z[0], tension=tension, width=80.0),
            1e-10)


def test_geomap_matches_jax():
    lons, lats, z = _field()
    gt, gj = tgrid.GeoMap(lons, lats, z[0]), jgrid.GeoMap(lons, lats, z[0])
    rng = np.random.default_rng(1)
    for lon, lat in zip(rng.uniform(-1, 13, 20), rng.uniform(39, 49, 20)):
        a, b = gt.value(lon, lat), gj.value(lon, lat)
        assert (np.isnan(a) and np.isnan(b)) or a == pytest.approx(
            b, rel=1e-12)
    np.testing.assert_array_equal(gt.mask, gj.mask)
    for tension in (0.0, 0.5):
        _of_max(gt.smooth(tension=tension, width=100.0, **CPU).z,
                gj.smooth(tension=tension, width=100.0).z, 1e-10)


def test_exchange_round_trip_matches_jax(tmp_path):
    z = np.linspace(0, 100, 11)
    out = {}
    for name, ex in (("t", tex), ("j", jex)):
        m3 = ex.Model3D_Exchange(lons=[0, 1], lats=[0, 1])
        for lon in (0, 1):
            for lat in (0, 1):
                vs = 3.0 + 0.01 * z + 0.1 * lon + 0.2 * lat
                m3.addMod(lon, lat, ex.Model1D_Exchange({"z": z, "vs": vs}))
        f = str(tmp_path / f"{name}.npz")
        m3.save(f)
        m3b = ex.Model3D_Exchange(fname=f)
        mid = m3b.getMod(0.3, 0.6, "vs", zdeps=z)
        sec = m3b.getSection(0.1, 0.1, 0.9, 0.8, "vs",
                             y=np.linspace(0, 99, 12))
        m1 = ex.Model1D_Exchange({"h": np.array([1.0, 2.0]),
                                  "vs": np.array([3.0, 4.0])})
        out[name] = (mid.parm["vs"], m3b.getMap(50.0, "vs").z, *sec,
                     *m1.propGrids("vs"), *m1.propLayers("vs"),
                     m1.value([0.5, 2.0]))
    for a, b in zip(out["t"], out["j"]):
        np.testing.assert_allclose(np.ma.filled(a, np.nan),
                                   np.ma.filled(b, np.nan), rtol=1e-12)


def _slab_maps(mod):
    lons = np.linspace(229.0, 236.0, 71)
    lats = np.linspace(44.0, 50.0, 61)
    LO, _ = np.meshgrid(lons, lats)
    kpd = 111.19 * np.cos(np.deg2rad(47.0))
    dep = 20.0 + (LO - 229.0) * kpd * np.tan(np.deg2rad(30.0))
    return (mod.grid.GeoMap(lons, lats, dep),
            mod.grid.GeoMap(lons, lats, np.full_like(dep, 10.0)),
            mod.grid.GeoMap(lons, lats, np.full_like(dep, 30.0)))


def test_decorations_match_jax(tmp_path):
    """The cases of tests/test_decorations.py through both packages."""
    import pysurfinv_tpu.geo as jgeo
    import pysurfinv_tpu_torch.geo as tgeo

    fig, ax = plt.subplots()
    res = {}
    west = np.column_stack([np.full(5, -127.0), np.linspace(40, 50, 5)])
    east = np.column_stack([np.full(5, -125.5), np.linspace(50, 40, 5)])
    prism = np.vstack([west, east])
    ridge = np.column_stack([np.linspace(-128, -126, 5), np.full(5, 46.0)])
    vol = np.array([[233.0, 47.05], [233.0, 49.0]])
    poly = np.column_stack([np.full(11, -127.0), np.linspace(40, 50, 11)])
    for name, dec, pkg in (("t", tdec, tgeo), ("j", jdec, jgeo)):
        dep, thk, dip = _slab_maps(pkg)
        f = tmp_path / f"slab_{name}.npz"
        np.savez(f, lons=dep.lons, lats=dep.lats, z=dep.z)
        loaded = dec.geomap_from_file(str(f))
        cs = dec.plotCascadiaSlab4Map(ax, loaded, levels=(60, 90, 120))
        res[name] = [
            *dec.plotCascadiaSlab(230.0, 47.0, 235.0, 47.0, dep, thk, dip,
                                  ax=ax),
            *dec.plotCascadiaSlab(230.0, 45.0, 235.0, 49.0, dep, thk, dip,
                                  ax=ax),
            dec.segment_polyline_intersections(poly, (-130.0, 47.0),
                                               (-124.0, 47.0)),
            dec.segment_polyline_intersections(poly, (-130.0, 44.0),
                                               (-124.0, 44.0)),
            dec.plotCascadiaTrenchCoast(230.0, 47.0, 236.0, 47.0, prism,
                                        ax=ax),
            np.array(dec.plotMORLocation(233.0, 44.0, 233.0, 49.0, ridge,
                                         ax=ax)),
            dec.plotVolcanos(230.0, 47.0, 236.0, 47.0, volcanos=vol, ax=ax),
            dec.plotVolcanos(230.0, 47.0, 236.0, 47.0),
            loaded.z, np.asarray(cs.levels)]
    plt.close(fig)
    for a, b in zip(res["t"], res["j"]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# Model3D on one directory of npz files
# ---------------------------------------------------------------------------

LLS = [(229.0, 46.0), (229.5, 46.0), (229.0, 46.5), (229.5, 46.5)]
NGRIDS = {"water": 2, "sediment": 4, "crust": 8, "mantle": 24}


@pytest.fixture(scope="module")
def invdir(tmp_path_factory):
    """A 2 x 2 grid of posterior npz files: thetas of a seeded prior run
    of each point, seeded misfits and accept flags."""
    base = tmp_path_factory.mktemp("m3d")
    rng = np.random.default_rng(0)
    out = base / "mc"
    for k, (lon, lat) in enumerate(LLS):
        p = PointCascadia(SETTING, dict(LOCAL, sedthk=0.3 + 0.2 * k,
                                        lithoAge=1.0 + k),
                          periods=T5, vels=V5, uncers=U5)
        pid = f"{lon:g}_{lat:g}"
        p.MCinvMP(str(base / "pri"), pid=pid, runN=40, chainL=20, seed=k,
                  priori=True, verbose=False, **CPU)
        th = np.load(base / "pri_priori" / f"{pid}.npz",
                     allow_pickle=True)["mcTrack"][:, 3:]
        mis = 1.0 + rng.exponential(0.5, len(th))
        acc = (rng.random(len(th)) < 0.5).astype(float)
        acc[::20] = 1.0
        p._save_npz(str(out), pid, np.column_stack(
            [mis, np.exp(-mis), acc, th]), 20)
    return str(out)


@pytest.fixture(scope="module")
def models(invdir):
    mt = Model3D(**CPU)
    assert mt.loadInvDir(invdir) == 4 and mt.skipped == []
    mj = JaxModel3D()
    mj.loadInvDir(invdir)
    return mt, mj


def test_model3d_load_maps_profiles_sections(models):
    mt, mj = models
    np.testing.assert_array_equal(mt.lons, mj.lons)
    np.testing.assert_array_equal(mt.lats, mj.lats)
    assert (~mt.mask).sum() == 4
    np.testing.assert_array_equal(mt.mask, mj.mask)
    for z in (5.0, 50.0, 150.0):
        a, b = mt.genVsMap(z), mj.genVsMap(z)
        assert np.isfinite(a.zMasked).sum() == 4
        np.testing.assert_allclose(a.zMasked.filled(np.nan),
                                   b.zMasked.filled(np.nan), rtol=0,
                                   atol=1e-9)
    zs = np.array([10.0, 50.0, 150.0])
    np.testing.assert_allclose(mt.vsProfile(zs, 46.25, 229.25),
                               mj.vsProfile(zs, 46.25, 229.25), atol=1e-9)
    # the section's 301 columns in the port; the JAX package's eager
    # host models take seconds a column, so its columns are checked at
    # four of the track's points (the track itself is the shared gc)
    y = np.linspace(0, 180, 19)
    XX, YY, Z, moho, topo = mt.section(229.0, 46.0, 229.5, 46.5, y=y)
    assert Z.shape == (19, 301) and np.isfinite(Z).any()
    _, track = mj._section_track(229.0, 46.0, 229.5, 46.5)
    assert np.allclose(mt._section_track(229.0, 46.0, 229.5, 46.5)[1],
                       track, rtol=1e-12)
    for c in (0, 97, 203, 300):
        la, lo = track[c]
        np.testing.assert_allclose(np.ma.filled(Z[:, c], np.nan),
                                   mj.vsProfile(y, la, lo), atol=1e-9)
        np.testing.assert_allclose([moho[c], topo[c]],
                                   [mj.moho(la, lo), mj.topo(la, lo)],
                                   rtol=0, atol=1e-9)
    assert np.isfinite(moho).sum() > 250
    for i in range(2):
        for j in range(2):
            dt, dj = mt.disps[i][j], mj.disps[i][j]
            np.testing.assert_allclose(dt["pvelp"], dj["pvelp"], rtol=0,
                                       atol=1e-7)
            assert mt.misfits[i][j] == pytest.approx(mj.misfits[i][j],
                                                     rel=1e-7)
    qt = mt.checkPhaseVelocity(pers=[10, 26])
    qj = mj.checkPhaseVelocity(pers=[10, 26])
    assert set(qt) == {10, 26}
    for per in qt:
        for k in ("pvelo", "pvelp", "resid_norm"):
            np.testing.assert_allclose(qt[per][k].filled(np.nan),
                                       qj[per][k].filled(np.nan), rtol=0,
                                       atol=1e-7 * (1 if k != "resid_norm"
                                                    else 1 / 0.005))


def test_model3d_smoothing_matches_jax(models):
    mt, mj = (m.copy() for m in models)
    mt.smooth(width=60)
    mj.smooth(width=60)
    for i in range(2):
        for j in range(2):
            _of_max(mt.mods[i][j]._brownians(), mj.mods[i][j]._brownians(),
                    1e-10)
    mt, mj = (m.copy() for m in models)
    mt.smoothGrid(width=60, nGridsDict=NGRIDS)
    mj.smoothGrid(width=60, nGridsDict=NGRIDS)
    for i in range(2):
        for j in range(2):
            a = mt.mods[i][j].seisPropGrids(hLowerLimit=-1)
            b = mj.mods[i][j].seisPropGrids(hLowerLimit=-1)
            assert list(a[-1]) == list(b[-1])
            for x, y in zip(a[:-1], b[:-1]):
                _of_max(x, y, 1e-10)
    _of_max(mt.genVsMap(50.0).zMasked.filled(np.nan),
            mj.genVsMap(50.0).zMasked.filled(np.nan), 1e-10)


def test_model3d_write_load_and_plots(models, tmp_path, monkeypatch):
    mt = models[0].copy()
    f = str(tmp_path / "m3.npz")
    mt.write(f)
    back = Model3D(**CPU)
    back.load(f)
    np.testing.assert_array_equal(back.mask, mt.mask)
    np.testing.assert_array_equal(back.genVsMap(50.0).zMasked,
                                  mt.genVsMap(50.0).zMasked)
    plt.close("all")
    imC, imM = mt.plotSection(229.0, 46.0, 229.5, 46.5, maxD=150,
                              label=("A", "B"))
    assert imC is not None and imM is not None
    monkeypatch.chdir(tmp_path)
    mt.checkPhaseVelocity(pers=[10], savefig=True)
    assert (tmp_path / "PhaseVel-10s.png").exists()
    plt.close("all")
