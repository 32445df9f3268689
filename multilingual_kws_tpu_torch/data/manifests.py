"""File-manifest contracts shared with the reference.

- unknown_files.txt: one wav path per line, relative to its directory
  (reference run.py:272-278)
- commands.txt / train_files.txt / val_files.txt: one entry per line
  (reference train_multilingual_embedding.py:27-32)
- labels from parent directory name (reference input_data.py:403-405)

The port's own copy of ``multilingual_kws_tpu/data/manifests.py`` (numpy only): the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence


def read_lines(path) -> List[str]:
    with open(path) as fh:
        return [ln for ln in fh.read().splitlines() if ln.strip()]


def read_unknown_files(unknown_words_dir) -> List[str]:
    """unknown_files.txt semantics from reference run.py:272-278."""
    d = Path(unknown_words_dir)
    manifest = d / "unknown_files.txt"
    if not manifest.is_file():
        raise FileNotFoundError(f"{manifest} not found")
    return [str(d / w) for w in read_lines(manifest)]


def read_commands(path) -> List[str]:
    return read_lines(path)


def label_from_parent_dir(filepath) -> str:
    """The reference's get_label: parent directory name (input_data.py:403-405)."""
    return Path(filepath).parent.name


def write_lines(path, lines: Sequence[str]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        fh.write("\n".join(str(l) for l in lines))
        if lines:
            fh.write("\n")
