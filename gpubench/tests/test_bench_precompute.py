"""The cell ``vit_b.precompute_volume`` at a size the CPU holds: a sound run
is correct; a run whose per-slice normalization is shifted in the port, and
the control, are not; the reference's normalization is upstream's."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import benchtiny
from micro_sam_tpu_torch import util
from reference.to_image import to_image

CELL = "vit_b.precompute_volume"
TRAFFIC = {"driver": "precompute_volume", "slices": 6, "height": 256, "width": 256, "top": 4095,
           "pool": 2, "batch": 4, "check_slices": 4}
TO_IMAGE = util._to_image


def tiny_cell():
    cell = benchtiny.spec.load_cell(CELL)
    cell.config = benchtiny.tiny_config()
    cell.traffic = dict(TRAFFIC)
    return cell


def run_tiny(seed=2 ** 31 + 23):
    return benchtiny.run.run_cell(tiny_cell(), seed, 0.5, False, torch.device("cpu"), time.time())


def shifted(image):
    """The port's normalization, every grey value 12 levels up."""
    return np.minimum(TO_IMAGE(image).astype(np.int32) + 12, 255).astype(np.uint8)


def test_sound_run_is_correct():
    result = run_tiny()
    assert result["correct"], result["checks"]
    assert result["attempted"] >= TRAFFIC["slices"] and result["attempted"] % TRAFFIC["slices"] == 0
    assert result["failed"] == 0 and list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"embed_images_per_s", "setup_s"}


def test_shifted_normalization_is_not_correct(monkeypatch):
    monkeypatch.setattr(util, "_to_image", shifted)
    result = run_tiny()
    assert not result["correct"], result["checks"]


def test_control_fails_the_limit():
    cell = tiny_cell()
    driver = benchtiny.run.load_file(benchtiny.spec.driver_file("precompute_volume"),
                                     "control_precompute_volume")
    for seed in (1, 2, 3):
        numbers = driver.control(benchtiny.context(cell, seed))
        assert any(v > cell.limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("dtype, top", [(np.uint16, 4095), (np.uint8, 255), (np.float32, 1.0)])
def test_reference_normalization_is_the_ports(dtype, top):
    rng = np.random.default_rng(5)
    grey = (rng.random((64, 48)) * top).astype(dtype)
    assert np.array_equal(to_image(grey), TO_IMAGE(grey))
    rgb = (rng.random((64, 48, 3)) * top).astype(dtype)
    assert np.array_equal(to_image(rgb), TO_IMAGE(rgb))


def test_the_pool_is_drawn_from_the_seed():
    driver = benchtiny.run.load_file(benchtiny.spec.driver_file("precompute_volume"),
                                     "pool_precompute_volume")
    a = driver.volume_pool(7, 2, 4, 64, 64, 4095, "cpu")
    b = driver.volume_pool(7, 2, 4, 64, 64, 4095, "cpu")
    c = driver.volume_pool(8, 1, 4, 64, 64, 4095, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b)) and not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.uint16 and a[0].shape == (4, 64, 64) and a[0].max() <= 4095
    assert not np.array_equal(a[0], a[1])


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_on_the_card(card, trace):
    root = os.path.dirname(benchtiny.BENCH)
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELL, "--seed",
                          str(2 ** 31 + 103), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, cwd=root, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "checks"
    names = {"embed.cast_idle_share", "embed.copy_in_gbps", "precompute.normalize_idle_share",
             "precompute.store_idle_share", "embed.idle_share", "embed.mfu"}
    assert set(result["metrics"]) == (names if trace else {"embed_images_per_s", "setup_s"})
