"""The port's host-side modules against the JAX package's: the msgpack codec
of ``Final_Model.nn``, the PNG encoder, ``Config`` and ``opts.json``, the
world artifact, angles to vectors, time and HSLuv.  All exact or at f64
round-off, since both sides run the same numpy math."""

import dataclasses
import io
import json

import flax.serialization as flax_ser
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from PIL import Image

from season_nerf_torch import config as t_config
from season_nerf_torch.data import ingest as t_ingest
from season_nerf_torch.geometry import time_enc as t_time
from season_nerf_torch.geometry import units as t_units
from season_nerf_torch.render import serving as t_serving
from season_nerf_torch.train import state as t_state
from season_nerf_torch.utils import hsluv as t_hsluv
from season_nerf_torch.utils import msgpack_lite
from season_nerf_torch.utils.convert import (flax_from_state_dict,
                                             state_dict_from_flax)
from season_nerf_tpu import config as j_config
from season_nerf_tpu.data import ingest as j_ingest
from season_nerf_tpu.geometry import time_enc as j_time
from season_nerf_tpu.geometry import units as j_units
from season_nerf_tpu.render import serving as j_serving
from season_nerf_tpu.train import state as j_state
from season_nerf_tpu.utils import hsluv as j_hsluv

torch.set_num_threads(1)


def _assert_trees_equal(a, b, path=""):
    """Same keys, and leaves equal in value and dtype."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), path


# --- msgpack codec ------------------------------------------------------------
def test_codec_reads_flax_model_file_like_flax(tiny_model_dir):
    raw = open(f"{tiny_model_dir}/Final_Model.nn", "rb").read()
    _assert_trees_equal(msgpack_lite.unpackb(raw),
                        flax_ser.msgpack_restore(raw))


def test_flax_reads_what_the_codec_writes(tiny_model_dir, tmp_path):
    src = f"{tiny_model_dir}/Final_Model.nn"
    sd, meta = t_state.load_model_artifact(src)
    path = str(tmp_path / "Final_Model.nn")
    t_state.save_model_artifact(path, sd, meta=meta)
    assert open(path, "rb").read() == open(src, "rb").read()
    t_state.save_model_artifact(path, sd, meta={"step": 7, "tag": "port"})
    params, stats, meta = j_state.load_model_artifact(path)
    want_p, want_s, _ = j_state.load_model_artifact(
        f"{tiny_model_dir}/Final_Model.nn")
    _assert_trees_equal(params, want_p)
    _assert_trees_equal(stats, want_s)
    assert meta == {"step": 7, "tag": "port"}


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 127, 128, -1, -32, -33, 255, 65535, 2 ** 31,
    2 ** 63 - 1, -2 ** 63, 1.5, -0.0, "", "a" * 31, "ü" * 40, "x" * 70000,
    b"\x00\xff" * 200, [], [1, [2, [3]]], list(range(20)), {"a": {"b": 1}},
    {f"k{i}": i for i in range(20)}])
def test_codec_plain_values_match_flax(obj):
    """Every msgpack form the codec emits or reads: byte-identical to what
    flax writes, and read back from it."""
    assert msgpack_lite.packb(obj) == flax_ser.msgpack_serialize(obj)
    assert msgpack_lite.unpackb(flax_ser.msgpack_serialize(obj)) == obj
    assert msgpack_lite.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


@pytest.mark.parametrize("arr", [
    np.arange(6, dtype=np.float32).reshape(2, 3), np.zeros((0,), np.int64),
    np.array([1, 2], np.uint8), np.float32(3.5), np.ones((3, 1, 2), bool),
    np.random.default_rng(0).normal(size=(40, 17))])
def test_codec_arrays_match_flax(arr):
    payload = {"w": arr, "nested": {"v": arr}}
    mine = msgpack_lite.packb(payload)
    assert mine == flax_ser.msgpack_serialize(payload)
    _assert_trees_equal(msgpack_lite.unpackb(mine),
                        flax_ser.msgpack_restore(mine))


def test_codec_widens_bfloat16():
    x = jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16)
    got = msgpack_lite.unpackb(flax_ser.msgpack_serialize({"x": x}))["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(x, np.float32))


def test_codec_rejects_truncated_and_trailing():
    data = msgpack_lite.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(data[:-1])
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(data + b"\x00")


def test_weight_bridge_round_trips(tiny_model_dir):
    params, stats, _ = j_state.load_model_artifact(
        f"{tiny_model_dir}/Final_Model.nn")
    sd = state_dict_from_flax(params, stats)
    # torch layouts: Linear [out, in], BN weight/bias/running stats
    k = np.asarray(params["gnerf"]["fc2"]["linear"]["kernel"])
    np.testing.assert_array_equal(sd["G_NeRF_net.fc2.linear.weight"].numpy(),
                                  k.T)
    np.testing.assert_array_equal(
        sd["G_NeRF_net.fc2.norm.running_var"].numpy(),
        stats["gnerf"]["fc2"]["norm"]["var"])
    np.testing.assert_array_equal(sd["get_class_layer.bias"].numpy(),
                                  params["class_head"]["bias"])
    p2, s2 = flax_from_state_dict(sd)
    _assert_trees_equal(p2, jax_tree_to_np(params))
    _assert_trees_equal(s2, jax_tree_to_np(stats))


def jax_tree_to_np(tree):
    return {k: jax_tree_to_np(v) if isinstance(v, dict)
            else np.asarray(v, np.float32) for k, v in tree.items()}


# --- PNG ----------------------------------------------------------------------
@pytest.mark.parametrize("stretch", [False, True])
@pytest.mark.parametrize("channels", [None, 3])
def test_png_decodes_to_the_jax_services_pixels(stretch, channels):
    rng = np.random.default_rng(1)
    shape = (13, 21) if channels is None else (13, 21, channels)
    img = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    img[2:4, 5:9] = np.nan
    want = np.asarray(Image.open(io.BytesIO(j_serving._png_bytes(img,
                                                                 stretch))))
    got = np.asarray(Image.open(io.BytesIO(t_serving.png_bytes(img,
                                                               stretch))))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_png_all_nan_height_map():
    img = np.full((4, 5), np.nan, np.float32)
    got = np.asarray(Image.open(io.BytesIO(t_serving.png_bytes(img, True))))
    np.testing.assert_array_equal(got, np.zeros((4, 5), np.uint8))


# --- config -------------------------------------------------------------------
def test_config_fields_and_defaults_match():
    assert (dataclasses.asdict(t_config.Config())
            == dataclasses.asdict(j_config.Config()))
    assert t_config.Config._LEGACY_DEFAULTS == j_config.Config._LEGACY_DEFAULTS


def test_opts_json_crosses_both_ways(tmp_path):
    j = j_config.Config(site_name="s", fc_units=64, fc_layers=3,
                        compute_dtype="float32", fast_sine=False,
                        height_range=(1.0, 2.0))
    j.save_json(str(tmp_path / "a.json"))
    t = t_config.Config.load_json(str(tmp_path / "a.json"))
    t.save_json(str(tmp_path / "b.json"))
    assert (dataclasses.asdict(j_config.Config.load_json(str(tmp_path
                                                              / "b.json")))
            == dataclasses.asdict(t_config.Config.load_json(str(tmp_path
                                                                 / "a.json"))))


def test_legacy_opts_json_gets_legacy_defaults(tmp_path):
    p = tmp_path / "opts.json"
    p.write_text(json.dumps({"fc_units": 64, "an_old_key": 1}))
    t, j = t_config.Config.load_json(str(p)), j_config.Config.load_json(str(p))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.compute_dtype == "float32" and t.fast_sine is False


# --- geometry, time, world artifact, HSLuv -------------------------------------
@pytest.mark.parametrize("el,az", [(90.0, 0.0), (45.0, 180.0), (70.0, 33.3),
                                   (12.5, -70.0)])
def test_angles_to_vectors(el, az):
    np.testing.assert_array_equal(t_units.elevation_azimuth_to_vec(el, az),
                                  j_units.elevation_azimuth_to_vec(el, az))
    wc = np.array([39.0, -83.95, 230.0])
    S = j_units.make_similarity([[38.99, 39.01], [-83.96, -83.94],
                                 [200.0, 260.0]], [[-1, 1], [-1, 1], [-1, 1]])
    np.testing.assert_array_equal(
        t_units.angles_to_vec_from_site(wc, S)(el, az),
        j_units.angles_to_vec_from_site(wc, S)(el, az))


@pytest.mark.parametrize("month,day", [(1, 1), (7, 19), (12, 31), (2, 28)])
def test_year_fraction(month, day):
    assert (t_time.year_frac_from_month_day(month, day)
            == j_time.year_frac_from_month_day(month, day))


def test_world_artifact_crosses_both_ways(tmp_path):
    wc, S = np.array([1.0, 2.0, 3.0]), np.eye(4) * 2
    t_ingest.save_world_artifact(str(tmp_path / "t.npy"), wc, S, (5.0, 9.0))
    j_ingest.save_world_artifact(str(tmp_path / "j.npy"), None, None, None)
    for a, b in [(t_ingest.load_w2c_w2l(str(tmp_path / "t.npy")),
                  j_ingest.load_w2c_w2l(str(tmp_path / "t.npy"))),
                 (t_ingest.load_w2c_w2l(str(tmp_path / "j.npy")),
                  j_ingest.load_w2c_w2l(str(tmp_path / "j.npy")))]:
        for x, y in zip(a, b):
            if x is None:
                assert y is None
            else:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_hsluv_to_rgb():
    hsl = np.random.default_rng(2).uniform(0, 1, (50, 3))
    hsl[0] = [0.3, 0.5, 0.0]           # black
    hsl[1] = [0.3, 0.5, 1.0]           # white
    np.testing.assert_array_equal(t_hsluv.hsluv_normalized_to_rgb(hsl),
                                  j_hsluv.hsluv_normalized_to_rgb(hsl))
