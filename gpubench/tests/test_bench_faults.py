"""A run with its timed path broken underneath comes out not correct, and so
does the control, with the committed limits; a sound run comes out correct.

Each test drives the rest of a run (set-up, window, check; not the look for
a card) at the tiny size on the CPU, with one fault planted in the port's
``SamPredictor``: an answer altered where it is produced, half of a batch
left out (its slots filled from the rest), a batch that returns the first
batch's answers unchanged. The exchange between chips is not a fault these
one-card cells can have.
"""
import pytest
import torch

import benchtiny
from micro_sam_tpu_torch.predictor import SamPredictor

ENCODE = SamPredictor.encode_batch


def altered(self, batch):
    out = ENCODE(self, batch).clone()
    out[0] = out[0] * 1.1
    return out


def half_left_out(self, batch):
    half = (len(batch) + 1) // 2
    out = ENCODE(self, batch[:half])
    return torch.cat([out, out[: len(batch) - half]])


def unchanged(self, batch):
    if getattr(self, "_first", None) is None:
        self._first = ENCODE(self, batch)
    return self._first


@pytest.mark.parametrize("driver", ["embed_batch"])
def test_sound_run_is_correct(driver):
    result = benchtiny.run_tiny(driver)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("driver, fault", [
    ("embed_batch", altered), ("embed_batch", half_left_out), ("embed_batch", unchanged)])
def test_broken_run_is_not_correct(monkeypatch, driver, fault):
    monkeypatch.setattr(SamPredictor, "encode_batch", fault)
    result = benchtiny.run_tiny(driver)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("driver", ["embed_batch"])
def test_control_fails_the_limit(driver):
    """The reference in fp8 in the program's place reads above the cell's
    limit (on the card at the cell's size: ``control.py``)."""
    cell = benchtiny.tiny_cell(driver)
    module = benchtiny.run.load_file(benchtiny.spec.driver_file(driver), f"control_{driver}")
    for seed in (1, 2, 3):
        numbers = module.control(benchtiny.context(cell, seed))
        assert any(v > cell.limits[k] for k, v in numbers.items()), numbers
