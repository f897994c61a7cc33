"""The port's real-site path against the JAX package's, on the fabricated
DFC-format site of ``tests/conftest.py::dfc_site``: RPCs, camera fits,
bounds and scaling, units and capture times, the TIFF reader (against PIL),
IMD and lidar parsing, site preprocessing, the ray table and its cache,
the weighted ray draw, and the slice as a whole (``cli.prepare_real``
against ``cli._prepare_real``), then a 2-step ``cli train`` on the CPU and
a render of the model directory it wrote.

Host geometry is numpy float64 in both packages with the same formulas, so
most comparisons are exact; the stated tolerance is 1e-9 relative where a
reordering could creep in.  The slice-as-a-whole comparison runs at a tiny
prior grid (8 x 8 x 6, patch 3) and with ``test_accuracy`` at 11^3 points
instead of 51^3 (its statistic is reported, not used): both packages are
patched the same way, which keeps the file inside its CPU budget."""

import functools
import io
import os
import shutil
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin

import chip_smoke
from season_nerf_torch import cli as t_cli
from season_nerf_torch.config import Config as TConfig
from season_nerf_torch.data import ingest as t_ingest
from season_nerf_torch.data import io as t_io
from season_nerf_torch.data import lidar as t_lidar
from season_nerf_torch.data import rays as t_rays
from season_nerf_torch.geometry import camera as t_cam
from season_nerf_torch.geometry import rpc as t_rpc
from season_nerf_torch.geometry import time_enc as t_time
from season_nerf_torch.geometry import units as t_units
from season_nerf_torch.priors import space_carving as t_sc
from season_nerf_torch.train import engine as t_engine
from season_nerf_tpu import cli as j_cli
from season_nerf_tpu.config import Config as JConfig
from season_nerf_tpu.data import ingest as j_ingest
from season_nerf_tpu.data import io as j_io
from season_nerf_tpu.data import lidar as j_lidar
from season_nerf_tpu.data import rays as j_rays
from season_nerf_tpu.geometry import camera as j_cam
from season_nerf_tpu.geometry import rpc as j_rpc
from season_nerf_tpu.geometry import time_enc as j_time
from season_nerf_tpu.geometry import units as j_units
from season_nerf_tpu.priors import space_carving as j_sc

torch.set_num_threads(1)

RTOL = 1e-9
SITE_KW = dict(img_training_downscale=16, img_validation_downscale=16,
               testing_size=1, skip_Bundle_Adjust=True,
               weight_training_samples=True, jump_start=True,
               DSM_Mode="Space_Carve")


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol, atol=0)


def _same_rpc(a, b, rtol=RTOL):
    for k in j_rpc.RPCModel.__dataclass_fields__:
        _close(getattr(a, k), getattr(b, k), rtol)


@pytest.fixture(scope="module")
def site(dfc_site, tmp_path_factory):
    """A private copy of the fabricated site (the fixture's own directory
    is shared with other test files' caches)."""
    io_root, name = dfc_site
    root = tmp_path_factory.mktemp("site") / "io"
    shutil.copytree(io_root, root, ignore=shutil.ignore_patterns("Logs"))
    for f in (root / "Cache" / name).glob("*.np[yz]"):
        f.unlink()
    return str(root), name


def _paths(root, name):
    cache = os.path.join(root, "Cache", name)
    imgs = os.path.join(root, "IEEE_Data", "Images")
    return dict(
        cache=cache, rpcs=os.path.join(cache, "RPCs"), imgs=imgs,
        truth=os.path.join(root, "IEEE_Data", "Track3-Truth"),
        ikonos=sorted(os.path.join(cache, f) for f in os.listdir(cache)
                      if f.endswith(".ikono")),
        tifs=sorted(os.path.join(imgs, f) for f in os.listdir(imgs)))


@pytest.fixture(scope="module")
def rpcs(site):
    return [(t_rpc.parse_rpc_file(p), j_rpc.parse_rpc_file(p))
            for p in _paths(*site)["ikonos"]]


# --- RPCs -------------------------------------------------------------------
def test_parse_rpc_file(site, rpcs):
    """Both layouts (``KEY_n: value`` files and RPB ``key = value;`` text)
    parse to the same model in both packages."""
    for t, j in rpcs:
        _same_rpc(t, j)
    j = rpcs[0][1]
    rpb = "\n".join(
        [f"lineOffset = {j.row_offset};", f"sampOffset = {j.col_offset};",
         f"latOffset = {j.lat_offset};", f"longOffset = {j.lon_offset};",
         f"heightOffset = {j.alt_offset};", f"lineScale = {j.row_scale};",
         f"sampScale = {j.col_scale};", f"latScale = {j.lat_scale};",
         f"longScale = {j.lon_scale};", f"heightScale = {j.alt_scale};"]
        + [f"{k} = ({', '.join(repr(float(v)) for v in vec)});"
           for k, vec in (("lineNumCoef", j.row_num), ("lineDenCoef",
                                                         j.row_den),
                          ("sampNumCoef", j.col_num), ("sampDenCoef",
                                                         j.col_den))])
    _same_rpc(t_rpc.parse_rpc_file(rpb), j_rpc.parse_rpc_file(rpb))
    _same_rpc(t_rpc.parse_rpc_file(rpb), j)
    with pytest.raises(ValueError, match="missing fields"):
        t_rpc.parse_rpc_file("LINE_OFF: 1.0\nSAMP_OFF: 2.0\n")
    d = rpcs[0][0].to_dict()
    assert d == rpcs[0][1].to_dict()
    _same_rpc(t_rpc.RPCModel.from_dict(d), j)


def test_rpc_project_and_localize(rpcs):
    """project and the Newton localize (the same iterations: its early exit
    tests the largest residual over all points) at 1e-9 relative."""
    rng = np.random.default_rng(5)
    for t, j in rpcs:
        lat = j.lat_offset + j.lat_scale * rng.uniform(-0.9, 0.9, 300)
        lon = j.lon_offset + j.lon_scale * rng.uniform(-0.9, 0.9, 300)
        alt = j.alt_offset + j.alt_scale * rng.uniform(-0.9, 0.9, 300)
        for a, b in zip(t.project(lat, lon, alt), j.project(lat, lon, alt)):
            _close(a, b)
        r, c = j.project(lat, lon, alt)
        for a, b in zip(t.localize(r, c, alt), j.localize(r, c, alt)):
            _close(a, b)
        _close(t.localize(r, c, alt)[0], lat, 1e-12)
        for a, b in zip(t.localize(r[:5], c[:5], alt[:5], n_iter=2),
                        j.localize(r[:5], c[:5], alt[:5], n_iter=2)):
            _close(a, b)
    M = t_rpc.monomials([0.1, -0.5], [0.3, 0.2], [0.7, -0.1])
    np.testing.assert_array_equal(
        M, j_rpc.monomials([0.1, -0.5], [0.3, 0.2], [0.7, -0.1]))


def test_fit_rpc_from_projector():
    def project(lat, lon, alt):
        return ((lat - 39.0) * 2.2e5 + 500 + 0.3 * alt,
                (lon + 83.95) * 1.7e5 + 400 - 0.1 * alt + 1e3 * (lat - 39.0))
    args = ((38.996, 39.004), (-83.954, -83.946), (200.0, 260.0))
    _same_rpc(t_rpc.fit_rpc_from_projector(project, *args, n_grid=8),
              j_rpc.fit_rpc_from_projector(project, *args, n_grid=8))


# --- cameras ------------------------------------------------------------------
@pytest.mark.parametrize("affine", [False, True], ids=["Pinhole", "Parallel"])
def test_camera_fit_scale_and_accuracy(rpcs, affine):
    """fit_camera_from_rpc (Chebyshev and uniform), test_accuracy, Camera.
    scale (P, S, sun vector) and the world frame at 1e-9 relative."""
    h = (205.0, 235.0)
    cams = []
    for method in ("chebyshev", "uniform"):
        t = t_cam.fit_camera_from_rpc(rpcs[1][0], (1024, 1024, 3), *h,
                                      affine=affine, method=method)
        j = j_cam.fit_camera_from_rpc(rpcs[1][1], (1024, 1024, 3), *h,
                                      affine=affine, method=method)
        _close(t.P, j.P)
        cams.append((t, j))
    t, j = cams[0]
    _close(t_cam.test_accuracy(t, *h, n_test=12),
           j_cam.test_accuracy(j, *h, n_test=12), 1e-7)
    bounds = np.array([[38.999, 39.001], [-83.951, -83.949], [*h]])
    t.sun_el_az = j.sun_el_az = (55.0, 160.0)
    ts, js = t.scale(bounds), j.scale(bounds)
    for k in ("P", "S", "S_inv", "sun_vec"):
        _close(getattr(ts, k), getattr(js, k))
    assert ts.scaled and not t.scaled
    _close(ts.get_world_center(), js.get_world_center())
    _close(ts.world_angle_2_local_vec(70.0, 30.0),
           js.world_angle_2_local_vec(70.0, 30.0))
    _close(t_cam.test_accuracy(ts, *h, n_test=6),
           j_cam.test_accuracy(js, *h, n_test=6), 1e-7)
    for ds, b in ((1, ((-1, 1), (-1, 1), (-1, 1))),
                  (16, ((-0.8, 0.9), (-1, 0.7), (-0.5, 1)))):
        for a, c in zip(ts.pixel_rays(downscale=ds, bounds=b),
                        js.pixel_rays(downscale=ds, bounds=b)):
            np.testing.assert_array_equal(a, c)


def test_dlt_grids_and_bounds(rpcs):
    for grid in ("chebyshev_grid", "uniform_grid"):
        for a, b in zip(getattr(t_cam, grid)((100, 80), 2.0, 9.0, 5),
                        getattr(j_cam, grid)((100, 80), 2.0, 9.0, 5)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(2)
    pts = [rng.uniform(lo, hi, 60) for lo, hi in
           ((38.99, 39.01), (-83.96, -83.94), (200, 260), (0, 1000),
            (0, 1000))]
    for affine in (False, True):
        _close(t_cam.fit_projective_dlt(*pts, affine=affine),
               j_cam.fit_projective_dlt(*pts, affine=affine))
    h = (205.0, 235.0)
    tc = [t_cam.fit_camera_from_rpc(t, (1024, 1024, 3), *h) for t, _ in rpcs]
    jc = [j_cam.fit_camera_from_rpc(j, (1024, 1024, 3), *h) for _, j in rpcs]
    _close(t_cam.find_bounds(tc, h), j_cam.find_bounds(jc, h))
    for c in tc + jc:                    # the 3x4 path, without the RPC
        c.rpc = None
    _close(t_cam.find_bounds(tc, h, shrink_iters=12),
           j_cam.find_bounds(jc, h, shrink_iters=12))


# --- units and time -------------------------------------------------------------
def test_units():
    lat = np.array([39.0, 39.001, -33.9, 60.0, 78.0])
    lon = np.array([-83.95, -83.949, 151.2, 5.0, 15.0])
    for i in range(len(lat)):
        for a, b in zip(t_units.wgs84_to_utm(lat[i:], lon[i:]),
                        j_units.wgs84_to_utm(lat[i:], lon[i:])):
            np.testing.assert_array_equal(a, b)
        assert (t_units.latlon_to_zone_number(lat[i], lon[i])
                == j_units.latlon_to_zone_number(lat[i], lon[i]))
        assert (t_units.latitude_to_zone_letter(lat[i])
                == j_units.latitude_to_zone_letter(lat[i]))
    for a, b in zip(t_units.wgs84_to_utm(39.0, -83.95, force_zone_number=16),
                    j_units.wgs84_to_utm(39.0, -83.95, force_zone_number=16)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(t_units.OutOfRangeError):
        t_units.wgs84_to_utm(85.0, 0.0)
    with pytest.raises(t_units.OutOfRangeError):
        t_units.wgs84_to_utm(0.0, 181.0)
    assert t_units.latitude_to_zone_letter(-81.0) is None
    np.testing.assert_array_equal(
        t_units.lat_lon_to_meters(lat, lon, lat + 0.01, lon - 0.02),
        j_units.lat_lon_to_meters(lat, lon, lat + 0.01, lon - 0.02))
    b = [[38.99, 39.01], [-83.96, -83.94], [200.0, 260.0]]
    S = t_units.make_similarity(b, [[-1, 1], [-1, 1], [-1, 1]])
    np.testing.assert_array_equal(
        S, j_units.make_similarity(b, [[-1, 1], [-1, 1], [-1, 1]]))
    wc = np.array([39.0, -83.95, 230.0])
    _close(t_units.sun_frame_from_site(wc, S),
           j_units.sun_frame_from_site(wc, S))
    vec = t_units.world_angle_2_local_vec(60.0, 130.0, wc, S)
    _close(t_units.local_vec_2_world_angle(vec, wc, np.linalg.inv(S)),
           j_units.local_vec_2_world_angle(vec, wc, np.linalg.inv(S)))


def test_capture_time_and_dates():
    for s in ("2015-02-15T15:30:00.000000Z", "2016-12-31T23:59:59.5Z",
              "2016-02-29T00:00:01.25Z"):
        t, j = t_time.CaptureTime.parse(s), j_time.CaptureTime.parse(s)
        assert dataclasses_equal(t, j)
        assert (t.year_frac, t.day_frac) == (j.year_frac, j.day_frac)
        np.testing.assert_array_equal(t.encode(), j.encode())
        assert t.to_datetime() == j.to_datetime()
    for f in (0.0, 0.37, 0.999):
        assert t_time.time_frac_to_date(f) == j_time.time_frac_to_date(f)
        assert (t_time.time_frac_to_date(f, True)
                == j_time.time_frac_to_date(f, True))
        np.testing.assert_array_equal(t_time.time_encode_year_only(f),
                                      j_time.time_encode_year_only(f))
    assert t_time.date_to_time_frac(7, 19) == j_time.date_to_time_frac(7, 19)
    assert (t_time.date_to_time_frac(2, 29, True)
            == j_time.date_to_time_frac(2, 29, True))


def dataclasses_equal(a, b):
    return vars(a) == vars(b)


# --- TIFF -----------------------------------------------------------------------
def _pil(path):
    with Image.open(path) as im:
        return np.asarray(im)


def test_read_tiff_matches_pil_on_the_site(site):
    """The fixture's RGB GeoTIFFs (PIL-written, uncompressed strips) and its
    float32 DSM ("F" mode, -9999 -> NaN): bit-exact against the JAX
    package's PIL reader."""
    p = _paths(*site)
    for path in p["tifs"][:2] + [os.path.join(p["truth"], "OMA_777_DSM.tif")]:
        got, want = t_io.read_tiff(path), j_io.read_tiff(path)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            t_io.read_tiff(path, nodata_to_nan=False),
            j_io.read_tiff(path, nodata_to_nan=False))


def _arrays():
    rng = np.random.default_rng(11)
    rgb = (rng.random((37, 29, 3)) * 255).astype(np.uint8)
    rgb[:5] = 7                                  # runs, for PackBits/LZW
    u16 = (rng.random((23, 41)) * 65535).astype(np.uint16)
    f32 = rng.normal(size=(19, 33)).astype(np.float32)
    f32[3, 4] = -9999.0
    return {"rgb8": rgb, "gray16": u16, "f32": f32}


@pytest.mark.parametrize("kind,comp,predictor", [
    (kind, comp, pred) for kind in ("rgb8", "gray16", "f32")
    for comp, pred in ((None, 1), ("tiff_lzw", 1), ("tiff_lzw", 2),
                       ("tiff_adobe_deflate", 1), ("tiff_adobe_deflate", 2),
                       ("packbits", 1))
    if not (pred == 2 and kind == "f32")])   # the predictor is for integers
def test_read_tiff_matches_pil_on_compressed_files(tmp_path, kind, comp,
                                                   predictor):
    """PIL (libtiff) writes each compression, with the horizontal predictor
    for integer samples; the reader returns PIL's pixels bit for bit."""
    arr = _arrays()[kind]
    path = str(tmp_path / "x.tif")
    info = {317: predictor} if predictor != 1 else {}
    Image.fromarray(arr).save(path, compression=comp, tiffinfo=info)
    want = _pil(path).astype(np.float32)
    if want.ndim == 2:
        want[want == -9999.0] = np.nan
    np.testing.assert_array_equal(t_io.read_tiff(path), want)


def _tiff(arr, order="<", tile=None, deflate=False, extra=()):
    """A TIFF written here: chunky samples, strips of 5 rows or tiles of
    ``tile`` (multiples of 16), byte order ``order``, optionally Deflate;
    ``extra`` adds or overrides (tag, type, values)."""
    arr = np.ascontiguousarray(arr)
    h, w = arr.shape[:2]
    spp = arr.shape[2] if arr.ndim == 3 else 1
    dt = arr.dtype.newbyteorder(order)
    blocks = []
    if tile is None:
        for r in range(0, h, 5):
            blocks.append(arr[r:r + 5].astype(dt).tobytes())
    else:
        for r in range(0, h, tile):
            for c in range(0, w, tile):
                t = np.zeros((tile, tile) + arr.shape[2:], arr.dtype)
                part = arr[r:r + tile, c:c + tile]
                t[:part.shape[0], :part.shape[1]] = part
                blocks.append(t.astype(dt).tobytes())
    if deflate:
        blocks = [zlib.compress(b) for b in blocks]
    offs = list(np.cumsum([8] + [len(b) for b in blocks[:-1]]).tolist())
    fmt = {"u": 1, "f": 3}[arr.dtype.kind]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8 * arr.itemsize] * spp),
            259: (3, [8 if deflate else 1]), 262: (3, [2 if spp == 3 else 1]),
            277: (3, [spp]), 284: (3, [1]), 339: (3, [fmt] * spp)}
    if tile is None:
        tags.update({273: (4, offs), 278: (4, [5]),
                     279: (4, [len(b) for b in blocks])})
    else:
        tags.update({322: (3, [tile]), 323: (3, [tile]), 324: (4, offs),
                     325: (4, [len(b) for b in blocks])})
    for tag, typ, values in extra:
        tags[tag] = (typ, values)
    body = b"".join(blocks)
    ifd = 8 + len(body) + len(body) % 2
    pool_at = ifd + 2 + 12 * len(tags) + 4
    entries, pool = b"", b""
    for tag in sorted(tags):
        typ, values = tags[tag]
        code = {3: "H", 4: "I"}[typ]
        raw = struct.pack(order + code * len(values), *values)
        entries += struct.pack(order + "HHI", tag, typ, len(values))
        if len(raw) <= 4:
            entries += raw.ljust(4, b"\0")
        else:
            entries += struct.pack(order + "I", pool_at + len(pool))
            pool += raw
    mark = b"II" if order == "<" else b"MM"
    return (mark + struct.pack(order + "HI", 42, ifd) + body
            + b"\0" * (ifd - 8 - len(body)) + struct.pack(order + "H",
                                                          len(tags))
            + entries + struct.pack(order + "I", 0) + pool)


@pytest.mark.parametrize("kind", ["rgb8", "gray16", "f32"])
@pytest.mark.parametrize("order,tile,deflate", [
    ("<", None, False), (">", None, False), (">", 16, False),
    ("<", 32, True), (">", 16, True)])
def test_read_tiff_byte_orders_and_tiles(tmp_path, kind, order, tile,
                                         deflate):
    """Files written here in both byte orders, in strips and in tiles with
    ragged edges: the reader returns the written samples, and PIL's pixels
    bit for bit (but where PIL, through libtiff, leaves big-endian float32
    Deflate tiles unswapped)."""
    arr = _arrays()[kind]
    path = tmp_path / "x.tif"
    path.write_bytes(_tiff(arr, order, tile, deflate))
    np.testing.assert_array_equal(t_io.read_tiff(str(path), False),
                                  arr.astype(np.float32))
    if not (order == ">" and deflate and kind == "f32"):
        want = _pil(str(path)).astype(np.float32)
        if want.ndim == 2:
            want[want == -9999.0] = np.nan
        np.testing.assert_array_equal(t_io.read_tiff(str(path)), want)


@pytest.mark.parametrize("extra,match", [
    ([(284, 3, [2])], "284"), ([(259, 3, [7])], "259"),
    ([(317, 3, [3])], "317"), ([(339, 3, [2, 2, 2])], "258/339"),
    ([(262, 3, [3])], "262")])
def test_read_tiff_refuses_what_it_does_not_read(tmp_path, extra, match):
    path = tmp_path / "x.tif"
    path.write_bytes(_tiff(_arrays()["rgb8"], extra=extra))
    with pytest.raises(ValueError, match=match):
        t_io.read_tiff(str(path))
    path.write_bytes(b"II+\x00" + bytes(12))
    with pytest.raises(ValueError, match="BigTIFF"):
        t_io.read_tiff(str(path))


def test_rpc_tag_and_the_smoke_writer(tmp_path, rpcs):
    """Tag 50844 written by PIL reads to the JAX package's model; the
    chip_smoke.py writer's files (RGB with the tag, float32 DSM) read in
    PIL and in the port identically, tag included."""
    rpc = rpcs[2][1]
    vals = chip_smoke.rpc_tag_values(rpc)
    arr = (np.random.default_rng(4).random((70, 45, 3)) * 255).astype(
        np.uint8)
    ifd = TiffImagePlugin.ImageFileDirectory_v2()
    ifd[t_io.RPC_TIFF_TAG] = tuple(vals)
    ifd.tagtype[t_io.RPC_TIFF_TAG] = 12
    pil_path = str(tmp_path / "pil.tif")
    Image.fromarray(arr).save(pil_path, tiffinfo=ifd)
    _same_rpc(t_io.rpc_from_tiff(pil_path), j_io.rpc_from_tiff(pil_path))
    _same_rpc(t_io.rpc_from_tiff(pil_path), rpc, 0)
    smoke_path = tmp_path / "smoke.tif"
    smoke_path.write_bytes(chip_smoke.tiff_bytes(arr, vals))
    np.testing.assert_array_equal(_pil(str(smoke_path)), arr)
    np.testing.assert_array_equal(t_io.read_tiff(str(smoke_path)),
                                  arr.astype(np.float32))
    _same_rpc(j_io.rpc_from_tiff(str(smoke_path)), rpc, 0)
    _same_rpc(t_io.rpc_from_tiff(str(smoke_path)), rpc, 0)
    dsm = np.random.default_rng(5).normal(size=(130, 66)).astype(np.float32)
    smoke_path.write_bytes(chip_smoke.tiff_bytes(dsm))
    np.testing.assert_array_equal(_pil(str(smoke_path)), dsm)
    np.testing.assert_array_equal(t_io.read_tiff(str(smoke_path)), dsm)
    assert t_io.rpc_from_tiff(str(smoke_path)) is None
    _same_rpc(t_rpc.parse_rpc_file(chip_smoke.rpc_text(rpc)), rpc, 0)


# --- IMD, site files, lidar ----------------------------------------------------
def test_imd_and_site_files(site, tmp_path):
    root, name = site
    p = _paths(root, name)
    for f in sorted(os.listdir(p["rpcs"])):
        path = os.path.join(p["rpcs"], f)
        assert t_io.parse_imd(path) == j_io.parse_imd(path)
        text = open(path).read()
        assert t_io.parse_imd(text) == j_io.parse_imd(text)
    ieee = os.path.join(root, "IEEE_Data")
    assert (t_io.find_site_images(ieee, name)
            == j_io.find_site_images(ieee, name))
    # the DFC layout: <PFX>/<id without its first character>.IMD
    (tmp_path / "WV3").mkdir()
    (tmp_path / "WV3" / "5MAR15.IMD").write_text("x")
    (tmp_path / "x_001.IMD").write_text("x")
    for img, dirs in (("WV3_OMA_05MAR15_RGB", [None, str(tmp_path)]),
                      ("OMA_777_001_RGB", [str(tmp_path)]),
                      ("OMA_777_003_RGB", [p["rpcs"]]),
                      ("OMA_777_009_RGB", [p["rpcs"], str(tmp_path)])):
        assert (t_ingest.find_imd(img, dirs) == j_ingest.find_imd(img, dirs))
    assert t_ingest.find_imd("WV3_OMA_05MAR15_RGB", [str(tmp_path)]) \
        .endswith("5MAR15.IMD")
    # RPC resolution: corrected, then original, then the TIFF tag
    img, tif = "OMA_777_000_RGB", p["tifs"][0]
    _same_rpc(t_io.load_rpc_for_image(img, tif, p["cache"]),
              j_io.load_rpc_for_image(img, tif, p["cache"]))
    shutil.copy(os.path.join(p["cache"], f"rpc_{img}_original.ikono"),
                tmp_path / f"rpc_{img}_corrected.ikono")
    _same_rpc(t_io.load_rpc_for_image(img, tif, str(tmp_path)),
              j_io.load_rpc_for_image(img, tif, str(tmp_path)))
    with pytest.raises(FileNotFoundError, match="no RPC"):
        t_io.load_rpc_for_image(img, tif, str(tmp_path),
                                prefer_corrected=False)


def test_lidar(site):
    root, name = site
    truth = _paths(root, name)["truth"]
    assert (t_lidar.height_range_from_dsm(truth, name)
            == j_lidar.height_range_from_dsm(truth, name))
    bounds = np.array([[38.9985, 39.0012], [-83.9512, -83.9481],
                       [205.0, 235.0]])
    for hw in ((16, 16), (9, 23)):
        np.testing.assert_array_equal(
            t_lidar.get_gt_dsm(truth, name, hw, bounds),
            j_lidar.get_gt_dsm(truth, name, hw, bounds))


# --- weights and the weighted draw ----------------------------------------------
def test_inverse_density_weights():
    rng = np.random.default_rng(8)
    X = np.stack([rng.uniform(0, 30, 9), rng.uniform(0, 360, 9),
                  rng.uniform(0, 1, 9)], 1)
    args = (X, np.array([0.0, 0, 0]), np.array([35.0, 360, 1]),
            np.array([False, True, True]))
    _close(t_rays.inverse_density_weights(*args),
           j_rays.inverse_density_weights(*args))
    _close(t_rays.inverse_density_weights(*args, sigma=[3.0, 40.0, 0.2]),
           j_rays.inverse_density_weights(*args, sigma=[3.0, 40.0, 0.2]))


def test_weighted_draw_matches_jax():
    """One injected u: the port's inverse-CDF draw against the JAX
    trainer's (season_nerf_tpu/train/engine.py:276-279 and :294-296, the
    same lines in jnp): indices identical, ties at CDF values included."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    w = np.repeat(rng.uniform(0.2, 3.0, 7), rng.integers(1, 400, 7))
    w[:3] = -1.0                               # counts as 0
    w = w.astype(np.float32)
    n = w.shape[0]
    cdf_j = np.cumsum(np.maximum(np.asarray(w, np.float64), 0.0))
    cdf_j = jnp.asarray(cdf_j / cdf_j[-1], jnp.float32)
    u = np.concatenate([rng.random(5000, np.float32), np.asarray(cdf_j)[:50],
                        np.float32([0.0, 1.0 - 2 ** -24])])
    want = np.asarray(jnp.clip(jnp.searchsorted(cdf_j, jnp.asarray(u)),
                               0, n - 1))
    cdf_t = t_engine.weight_cdf(w)
    np.testing.assert_array_equal(cdf_t, np.asarray(cdf_j))
    got = t_engine.weighted_indices(torch.as_tensor(cdf_t),
                                    torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(got, want)
    assert t_engine.weight_cdf(np.ones(5, np.float32)) is None
    d = t_engine.StepDraws(0, n, 16, 4, device="cpu", weighted=True)(3)
    assert "idx" not in d and d["u"].shape == (16,)
    assert "u" not in t_engine.StepDraws(0, n, 16, 4, device="cpu")(3)


# --- the slice as a whole -------------------------------------------------------
@pytest.fixture(scope="module")
def prepared(site, tmp_path_factory):
    """_prepare_real and prepare_real on copies of the site, at the small
    prior grid; then ``cli train`` (2 steps, width 32, weighted sampling) on
    the port's copy, whose caches it reuses, and ``cli render`` of the
    model directory."""
    root, name = site
    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = str(tmp_path_factory.mktemp(who) / "io")
        shutil.copytree(root, dirs[who])
    grid = lambda bounds, voxel=None: (8, 8, 6)
    with pytest.MonkeyPatch.context() as mp:
        for ing, cam in ((j_ingest, j_cam), (t_ingest, t_cam)):
            mp.setattr(ing, "test_accuracy",
                       functools.partial(cam.test_accuracy, n_test=10))
        # cli train's evaluation at 8 px, not its default 256 x 256 test
        # renders and 128 px walks (test_torch_analysis.py holds it)
        mp.setattr(t_cli, "run_test", functools.partial(
            t_cli.run_test, eval_img_size=(8, 8)))
        for sc in (j_sc, t_sc):
            mp.setattr(sc, "model_grid_from_bounds", grid)
            mp.setattr(sc, "space_carve_dsm",
                       functools.partial(sc.space_carve_dsm, patch=3))
        jcfg = JConfig(site_name=name, exp_name="slice", IO_Location=dirs[
            "jax"], **SITE_KW).resolve_dirs()
        tcfg = TConfig(site_name=name, exp_name="slice", IO_Location=dirs[
            "port"], **SITE_KW).resolve_dirs()
        J = j_cli._prepare_real(jcfg)
        T = t_cli.prepare_real(tcfg, device="cpu")
        argv = ["--site_name", name, "--exp_name", "cli",
                "--IO_Location", dirs["port"], "--max_train_steps", "2",
                "--n_samples", "8", "--batch_size", "64", "--fc_units", "32",
                "--testing_size", "1", "--n_saves", "1", "--compute_dtype",
                "float32", "--img_training_downscale", "16",
                "--img_validation_downscale", "16", "--skip_Bundle_Adjust",
                "--weight_training_samples", "--device", "cpu"]
        assert t_cli.main(["train"] + argv) == 0
    logs = os.path.join(dirs["port"], "Logs", "cli")
    png = os.path.join(logs, "r.png")
    t_cli.main(["render", "--Model_Location", logs, "--Output_Size", "8",
                "--device", "cpu", "--Save_Name", png])
    return dict(J=J, T=T, jcfg=jcfg, tcfg=tcfg, logs=logs, png=png)


def test_prepare_real_matches_jax(prepared):
    """The slice as a whole on the fabricated site: the ray table (built at
    downscale 16 with inverse-density weights) within 1e-6 (the float32
    rows of the same float64 geometry: identical in practice), the split,
    the lidar DSM on the prior's grid, the cameras, the height range, the
    world frame, and the Space_Carve prior (each package's own sweep and
    graph cut: near-ties may flip a label; 0 of 64 cells flipped here, held
    to at most 1 in 16)."""
    J, T = prepared["J"], prepared["T"]
    jt, tt = J[1], T[1]
    np.testing.assert_allclose(tt.rows, jt.rows, atol=1e-6, rtol=0)
    for k in ("img_ids", "img_sizes"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k))
    _close(tt.sun_vecs, jt.sun_vecs)
    _close(tt.time_encs, jt.time_encs)
    assert tt.img_names == jt.img_names
    assert len(np.unique(tt.rows[:, 18])) > 1          # weighted rows
    assert T[2] == J[2] and T[3] == J[3]
    np.testing.assert_array_equal(T[5], J[5])
    assert T[5].shape == (8, 8)
    assert np.mean(T[4] != J[4]) <= 1 / 16
    assert T[4].shape == (8, 8) and np.isfinite(T[4]).all()
    assert T[6] == J[6]
    _close(T[7], J[7])
    _close(T[8], J[8])
    for tc, jc in zip(T[0], J[0]):
        for k in ("P", "S", "sun_vec"):
            _close(getattr(tc, k), getattr(jc, k))
        assert (tc.view_el_az, tc.time_frac, tc.day_frac) == \
            (jc.view_el_az, jc.time_frac, jc.day_frac)
        np.testing.assert_array_equal(tc.image, jc.image)


def test_prepare_real_writes_the_jax_artifacts(prepared):
    """The split files, W2C_W2L_H.npy, bounds_LLA.npy and the ray-table
    cache: the same names and contents, and each package loads the other's
    cache."""
    jcfg, tcfg = prepared["jcfg"], prepared["tcfg"]
    for f in ("Training_Imgs.txt", "Testing_Imgs.txt"):
        assert (open(os.path.join(tcfg.logs_dir, f)).read()
                == open(os.path.join(jcfg.logs_dir, f)).read())
    for a, b in zip(t_ingest.load_w2c_w2l(os.path.join(tcfg.logs_dir,
                                                       "W2C_W2L_H.npy")),
                    j_ingest.load_w2c_w2l(os.path.join(jcfg.logs_dir,
                                                       "W2C_W2L_H.npy"))):
        _close(a, b)
    np.testing.assert_array_equal(
        np.load(os.path.join(tcfg.cache_dir, "bounds_LLA.npy")),
        np.load(os.path.join(jcfg.cache_dir, "bounds_LLA.npy")))
    j_npz = [f for f in os.listdir(jcfg.cache_dir) if f.endswith(".npz")]
    ds = [16] * 4
    assert j_npz == [os.path.basename(t_rays.cache_path(tcfg.cache_dir, tcfg,
                                                        ds))]
    from_jax = t_rays.RayTable.load(os.path.join(jcfg.cache_dir, j_npz[0]))
    from_port = j_rays.RayTable.load(t_rays.cache_path(tcfg.cache_dir, tcfg,
                                                       ds))
    for t in (from_jax, from_port):
        np.testing.assert_array_equal(t.rows, prepared["J"][1].rows)
        assert t.img_names == prepared["J"][1].img_names
    assert os.path.exists(os.path.join(tcfg.cache_dir, "SC_OMA_777_hm.npy"))


def test_cli_trains_the_real_site_and_renders_it(prepared):
    """``cli train`` on the real-format site (weighted sampling) wrote a
    model directory with a world frame, and ``cli render`` loaded it."""
    logs = prepared["logs"]
    for f in ("Final_Model.nn", "opts.json", "W2C_W2L_H.npy",
              "Training_Imgs.txt", "Testing_Imgs.txt"):
        assert os.path.exists(os.path.join(logs, f)), f
    wc, S, h_range = t_ingest.load_w2c_w2l(os.path.join(logs,
                                                        "W2C_W2L_H.npy"))
    assert wc is not None and S.shape == (4, 4) and h_range[1] > h_range[0]
    cfg = TConfig.load_json(os.path.join(logs, "opts.json"))
    assert cfg.weight_training_samples and cfg.site_name == "OMA_777"
    with Image.open(prepared["png"]) as im:
        assert im.size == (8, 8)
    shown, _ = t_cli.render_pretrained(logs, (75, 120), (50, 170), "06/15",
                                       out_size=8, device="cpu")
    assert shown.shape == (8, 8, 3) and np.isfinite(shown).all()


def test_setup_data_matches_jax(tmp_path):
    """``cli setup_data``: the DFC2019 zips' images and the repository's
    Data.zip (cached RPCs) unpack to the same tree as the JAX package's."""
    import zipfile
    zips = tmp_path / "zips"
    zips.mkdir()
    with zipfile.ZipFile(zips / "Track3-RGB-1.zip", "w") as z:
        z.writestr("Track3-RGB-1/OMA_281_001_RGB.tif", b"tif")
        z.writestr("Track3-RGB-1/OMA_281_001_RGB.IMD", b"imd")
        z.writestr("Track3-RGB-1/readme.md", b"skipped")
    with zipfile.ZipFile(zips / "Data.zip", "w") as z:
        z.writestr("Data/OMA_281/rpc_OMA_281_001_RGB_corrected.ikono", b"r")
        z.writestr("Data/misc.txt", b"m")
    trees = []
    for who, fn in (("port", t_cli.setup_data), ("jax", j_cli.setup_data)):
        out = tmp_path / who
        assert fn(str(zips), str(out)) == str(out / "IEEE_Data" / "Images")
        trees.append(sorted((str(p.relative_to(out)), p.read_bytes())
                            for p in out.rglob("*") if p.is_file()))
    assert trees[0] == trees[1]
    assert ("Cache/OMA_281/rpc_OMA_281_001_RGB_corrected.ikono", b"r") \
        in trees[0]
