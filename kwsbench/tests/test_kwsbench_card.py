"""On the card: each cell's control, the program's own bfloat16 path in
place of the float32 the configuration states, comes out as not correct,
and the cell as configured comes out correct, at full width with shorter
traffic. Skipped without a card.

    python -m pytest kwsbench/tests -q -m card
"""

import pytest

from kwsbench import run

SHORT = {
    "scan-b0t3-10min": {"traffic": {"stream_s": 60, "batch_size": 8192}},
    "pretrain-b0e761-b64": {"traffic": {"words": 60, "steps_per_epoch": 20, "expected_clips_per_s": 100}},
    "finetune-b0t3-5shot": {"traffic": {"keywords": 3, "unknown": 64}},
}
SECONDS = {"scan-b0t3-10min": 2.0, "pretrain-b0e761-b64": 1.0, "finetune-b0t3-5shot": 1.0}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SHORT))
def test_the_cell_is_correct_and_its_bf16_control_is_not(card, cell):
    sound = run.run_cell(cell, 11, SECONDS[cell], False, card, overrides=SHORT[cell])
    assert sound["correct"] is True, sound["checks"]
    control = run.run_cell(cell, 11, SECONDS[cell], False, card,
                           overrides={**SHORT[cell], "config": {"compute_dtype": "bfloat16"}})
    assert control["correct"] is False, control["checks"]
