"""Metrics logging: the Keras CSVLogger of the reference
(transfer_learning.py:81-84, train_multilingual_embedding.py:117) and the
history file (train_monolingual_embedding.py:145-149).

The port's own copies of ``CSVLogger`` and ``save_history`` from
``multilingual_kws_tpu/train/metrics.py``.
"""

from __future__ import annotations

import csv
import json
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


def save_history(history: Dict, dest) -> None:
    """The per-epoch history dict as JSON at ``dest``."""
    dest = Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    with open(dest, "w") as fh:
        json.dump(history, fh, indent=1)
