"""Minimal Praat TextGrid parser (long and short text formats).

The reference consumes forced-alignment TextGrids via the `textgrid` PyPI
package (word_extraction.py:13-14, :66-80); this environment has no such
package, and only the first tier's (mark, minTime, maxTime) intervals are
ever used — so this is a small, dependency-free parser of exactly that.

The port's own copy of ``multilingual_kws_tpu/tools/textgrid.py``, with the same names and
outputs: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple


class TextGridError(ValueError):
    pass


@dataclass(frozen=True)
class Interval:
    mark: str
    minTime: float
    maxTime: float


def _parse_long(text: str) -> List[Interval]:
    """Long format: `intervals [k]:` blocks with xmin/xmax/text fields."""
    intervals = []
    # restrict to the first tier: cut at the second "item [" if present
    items = [m.start() for m in re.finditer(r"item\s*\[\s*\d+\s*\]", text)]
    if len(items) >= 3:  # item [] header + tier1 + tier2...
        text = text[: items[2]]
    pattern = re.compile(
        r"intervals\s*\[\s*\d+\s*\][^\[]*?"
        r"xmin\s*=\s*([-\d.eE+]+)\s*"
        r"xmax\s*=\s*([-\d.eE+]+)\s*"
        r'text\s*=\s*"((?:[^"]|"")*)"',
        re.S,
    )
    for m in pattern.finditer(text):
        intervals.append(
            Interval(m.group(3).replace('""', '"'), float(m.group(1)),
                     float(m.group(2)))
        )
    return intervals


def _parse_short(text: str) -> List[Interval]:
    """Short format: bare lines — class, name, xmin, xmax, n, then triples."""
    lines = [l.strip() for l in text.splitlines()]
    try:
        i = next(ix for ix, l in enumerate(lines) if l.strip('"') == "IntervalTier")
    except StopIteration:
        raise TextGridError("no IntervalTier found")
    # lines[i+1]=tier name, i+2=xmin, i+3=xmax, i+4=interval count
    n = int(float(lines[i + 4]))
    out = []
    j = i + 5
    for _ in range(n):
        xmin = float(lines[j]); xmax = float(lines[j + 1])
        mark = lines[j + 2].strip()
        if mark.startswith('"') and mark.endswith('"'):
            mark = mark[1:-1].replace('""', '"')
        out.append(Interval(mark, xmin, xmax))
        j += 3
    return out


def read_textgrid(path) -> List[Interval]:
    """First tier's intervals of a TextGrid file."""
    try:
        text = Path(path).read_text(encoding="utf-8", errors="replace")
    except OSError as e:
        raise TextGridError(str(e))
    if "ooTextFile" not in text.split("\n", 1)[0] and "ooTextFile" not in text[:200]:
        raise TextGridError(f"{path}: not a TextGrid")
    if re.search(r"item\s*\[", text):
        intervals = _parse_long(text)
    else:
        intervals = _parse_short(text)
    if not intervals:
        raise TextGridError(f"{path}: no intervals parsed")
    return intervals


def write_textgrid(path, intervals: List[Tuple[str, float, float]],
                   tier_name: str = "words") -> None:
    """Long-format writer — used to build test fixtures."""
    xmin = min(i[1] for i in intervals) if intervals else 0.0
    xmax = max(i[2] for i in intervals) if intervals else 0.0
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        f"xmin = {xmin}",
        f"xmax = {xmax}",
        "tiers? <exists>",
        "size = 1",
        "item []:",
        "    item [1]:",
        '        class = "IntervalTier"',
        f'        name = "{tier_name}"',
        f"        xmin = {xmin}",
        f"        xmax = {xmax}",
        f"        intervals: size = {len(intervals)}",
    ]
    for k, (mark, a, b) in enumerate(intervals, 1):
        lines += [
            f"        intervals [{k}]:",
            f"            xmin = {a}",
            f"            xmax = {b}",
            f'            text = "{mark}"',
        ]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")
