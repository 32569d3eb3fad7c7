"""The check catches a broken timed path: a whole run (set-up, window,
check) on the CPU at a tiny size, past the harness's look for a card,
with a fault planted in the program underneath, has to come out not
correct; the same run without the fault, correct. The cells run on one
chip, so there is no exchange between chips to leave out."""

from __future__ import annotations

import pytest

from portbench import bench
from portbench.faults import planted

CASES = [
    (0, "answer_altered"),  # utnet photos: the uint8 image altered where produced
    (2, "answer_altered"),  # unet photos
    (1, "unchanged"),       # utnet training: the step leaves its state as it was
    (1, "half_batch"),      # utnet training: the mean over half the batch
    (3, "unchanged"),       # unet training
    (3, "half_batch"),
]


@pytest.mark.parametrize("index,fault", CASES, ids=[f"{i}-{f}" for i, f in CASES])
def test_fault_is_not_correct(tiny_root, index, fault):
    root, names = tiny_root
    with planted(fault):
        res, lines, readings = bench.run_cell(root, names[index], 424242, 0.5, False,
                                              device="cpu")
    assert not res["correct"], (readings, lines)
    assert any(line.endswith("FAILED") for line in lines)


@pytest.mark.parametrize("index", range(4))
def test_sound_run_is_correct(tiny_root, index):
    root, names = tiny_root
    res, lines, _ = bench.run_cell(root, names[index], 424242, 0.5, False, device="cpu")
    assert res["correct"], lines


def test_faults_are_removed_after_use():
    from nind_denoise_tpu_torch.ops import rl_deblur
    from nind_denoise_tpu_torch.train import optim, steps

    before = (rl_deblur.rl_to_u8_device, optim.AmsGrad.step, steps.make_generator_train_step)
    for f in ("answer_altered", "unchanged", "half_batch"):
        with planted(f):
            pass
    assert before == (rl_deblur.rl_to_u8_device, optim.AmsGrad.step,
                      steps.make_generator_train_step)
