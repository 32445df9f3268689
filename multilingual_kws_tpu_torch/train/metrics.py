"""Metrics logging: the Keras CSVLogger of the reference
(transfer_learning.py:81-84).

The port's own copy of ``CSVLogger`` from ``multilingual_kws_tpu/train/metrics.py``.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict


class CSVLogger:
    """Writes one row per epoch; header from the first row's keys."""

    def __init__(self, dest):
        self.dest = Path(dest)
        self.dest.parent.mkdir(parents=True, exist_ok=True)
        self._writer = None
        self._fh = None

    def log(self, row: Dict):
        if self._fh is None:
            self._fh = open(self.dest, "w", newline="")
            self._writer = csv.DictWriter(self._fh, fieldnames=list(row.keys()))
            self._writer.writeheader()
        self._writer.writerow(row)
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
