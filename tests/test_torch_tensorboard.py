"""The TensorBoard half of ``utils/logging.py``: the port's ``MetricWriter``
against the JAX package's, which writes through
``torch.utils.tensorboard.SummaryWriter``.

The same scalars and images go through both writers; both event files are
read with tensorboard's ``EventAccumulator`` (the format's oracle, present
where these tests run and never imported by the port): the same tags,
steps and values, and the images' decoded pixels equal (PIL as the PNG
oracle).  The record framing is checked byte by byte (every masked CRC-32C
holds, as tensorboard's reader checks it), and a ``Trainer``'s validation
report writes its images and ``Testing`` scalars into the run's event
file.

About 15 s on one worker, most of it importing the reader."""

import glob
import io
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator)

from season_nerf_torch.config import Config
from season_nerf_torch.data.synthetic import make_scene, scene_ray_tables
from season_nerf_torch.train.engine import Trainer
from season_nerf_torch.utils import logging as t_logging
from season_nerf_tpu.utils import logging as j_logging

torch.set_num_threads(1)


def _write(writer_cls, d):
    rng = np.random.default_rng(3)
    w = writer_cls(str(d))
    for step in (0, 5, 10):
        w.scalars("Training", {"Total": 1.0 / (step + 1), "Col": -2.5e-3 *
                               step, "Big": 3.0e38}, step)
    w.scalar("Testing/Mean_PSNR", np.float32(21.75), 10)
    w.image("Testing/render_0", rng.uniform(-0.2, 1.2, (6, 9, 3)), 10)
    w.image("Testing/height_0", rng.uniform(0, 1, (6, 9)).astype(np.float32),
            10)
    w.image("Testing/rgba", rng.uniform(0, 1, (4, 5, 4)), 10)
    w.image("Testing/gray1", rng.uniform(0, 1, (4, 5, 1)), 10)
    w.image("Testing/u8", rng.integers(0, 256, (3, 4, 3), dtype=np.uint8), 10)
    w.image("Testing/render_0", np.full((6, 9, 3), 0.5), 15)
    w.close()
    ea = EventAccumulator(str(d), size_guidance={"scalars": 0, "images": 0})
    ea.Reload()
    return ea


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return (_write(j_logging.MetricWriter, tmp_path_factory.mktemp("jax")),
            _write(t_logging.MetricWriter, tmp_path_factory.mktemp("port")))


def test_same_tags(both):
    j, t = both
    assert t.Tags()["scalars"] == j.Tags()["scalars"]
    assert t.Tags()["images"] == j.Tags()["images"]
    assert len(t.Tags()["images"]) == 5


def test_same_scalars(both):
    j, t = both
    for tag in j.Tags()["scalars"]:
        assert [(e.step, e.value) for e in t.Scalars(tag)] == \
            [(e.step, e.value) for e in j.Scalars(tag)], tag


def test_same_image_pixels(both):
    j, t = both
    for tag in j.Tags()["images"]:
        je, te = j.Images(tag), t.Images(tag)
        assert [e.step for e in te] == [e.step for e in je], tag
        for a, b in zip(te, je):
            assert (a.width, a.height) == (b.width, b.height), tag
            pa = np.asarray(Image.open(io.BytesIO(a.encoded_image_string)))
            pb = np.asarray(Image.open(io.BytesIO(b.encoded_image_string)))
            np.testing.assert_array_equal(pa, pb, err_msg=tag)


def _records(path):
    """Every TFRecord of ``path``, each CRC checked."""
    data, out, at = open(path, "rb").read(), [], 0
    while at < len(data):
        n_bytes = data[at:at + 8]
        (n,) = struct.unpack("<Q", n_bytes)
        assert struct.unpack("<I", data[at + 8:at + 12])[0] == \
            t_logging.masked_crc32c(n_bytes)
        rec = data[at + 12:at + 12 + n]
        assert struct.unpack("<I", data[at + 12 + n:at + 16 + n])[0] == \
            t_logging.masked_crc32c(rec)
        out.append(rec)
        at += 16 + n
    return out


def test_records_and_first_event(tmp_path):
    # CRC-32C's check value (RFC 3720's test vector)
    assert t_logging.crc32c(b"123456789") == 0xE3069283
    w = t_logging.MetricWriter(str(tmp_path))
    w.scalar("Training/Total", 0.5, 3)
    w.flush()
    (path,) = glob.glob(str(tmp_path / "events.out.tfevents.*"))
    recs = _records(path)
    assert len(recs) == 2 and b"brain.Event:2" in recs[0]
    w.close()


def test_no_tensorboard_and_no_logdir(tmp_path):
    w = t_logging.MetricWriter(str(tmp_path), use_tensorboard=False)
    w.scalar("Training/Total", 0.5, 3)
    w.image("Testing/render_0", np.zeros((2, 2, 3)), 3)
    w.close()
    assert os.listdir(tmp_path) == ["metrics.jsonl"]
    w = t_logging.MetricWriter("")
    w.scalar("Training/Total", 0.5, 3)
    w.image("Testing/render_0", np.zeros((2, 2, 3)), 3)
    w.close()


def test_validation_report_writes_images(tmp_path):
    """A save point's report: each held-out view's render and height map
    and the ``Testing`` means, at the step, in the run's event file."""
    scene = make_scene(n_views=3, img_size=8, grid=8, seed=0)
    train, val = scene_ray_tables(scene, testing_size=1)
    cfg = Config(fc_units=32, fc_layers=2, batch_size=16, n_samples=8,
                 max_train_steps=4, compute_dtype="float32",
                 logs_dir=str(tmp_path))
    trainer = Trainer(cfg, train, val, prior_hm=scene.prior_hm,
                      device="cpu")
    report = trainer.validation_report(step=7)
    trainer.writer.close()
    ea = EventAccumulator(str(tmp_path), size_guidance={"scalars": 0,
                                                        "images": 0})
    ea.Reload()
    assert sorted(ea.Tags()["images"]) == ["Testing/height_0",
                                           "Testing/render_0"]
    for tag in ea.Tags()["images"]:
        (e,) = ea.Images(tag)
        assert e.step == 7 and (e.height, e.width) == (8, 8)
    (psnr,) = ea.Scalars("Testing/Mean_PSNR")
    assert psnr.step == 7 and psnr.value == pytest.approx(
        report["Mean_PSNR"], rel=1e-6)
