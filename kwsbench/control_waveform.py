"""The planted fault of the waveform cell, read on what set-up recorded: one
sample of one clip in every training batch altered where the program's
transform produces it (``drivers/pretrain_xlsr.plant_altered_sample``),
then ``kwsbench.control``'s ``setup`` mode in this process (the cell's check
on set-up's warm call, without a window).

    python -m kwsbench.control_waveform --workload pretrain-xlsr300m-b64 --seeds S1,S2,...

The benchmark's own runs never run this.
"""

from __future__ import annotations

import sys

from kwsbench import control
from kwsbench.drivers import pretrain_xlsr


def main(argv=None) -> int:
    pretrain_xlsr.plant_altered_sample()
    return control.main([*(sys.argv[1:] if argv is None else argv), "--mode", "setup"])


if __name__ == "__main__":
    sys.exit(main())
