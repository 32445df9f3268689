"""Human-in-the-loop clip audition / labeling CLIs.

Equivalent of the reference's raw-terminal labeling tools
(label_directory.py, label_directory_dataperf.py, listen.py): play each
clip, take a single-key rating (good / bad / replay / quit), write a CSV of
ratings. Playback uses the first available CLI player (aplay/paplay/ffplay/
afplay) — the reference used pydub/afplay.

The interaction loop is injectable (getch_fn / play_fn) so it is testable
and scriptable; the default wiring is the reference's tty/termios getch.

The port's own copy of ``multilingual_kws_tpu/api/labeling.py``, with the same names and
outputs: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import csv
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

KEYS_HELP = "[g]ood  [b]ad  [r]eplay  [s]kip  [q]uit"


def getch_unix() -> str:
    """Single raw keypress (reference label_directory.py:16-28)."""
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        return sys.stdin.read(1)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def default_player() -> Optional[str]:
    for p in ("aplay", "paplay", "ffplay", "afplay", "play"):
        if shutil.which(p):
            return p
    return None


def play_clip(path, player: Optional[str] = None) -> None:
    player = player or default_player()
    if player is None:
        print(f"(no audio player found; cannot play {path})")
        return
    cmd = [player, str(path)]
    if player == "ffplay":
        cmd = [player, "-nodisp", "-autoexit", "-loglevel", "quiet", str(path)]
    subprocess.run(cmd, check=False, capture_output=True)


def label_clips(
    clips: Sequence[Tuple[str, float]],
    out_csv,
    getch_fn: Callable[[], str] = getch_unix,
    play_fn: Callable[[str], None] = play_clip,
    echo: Callable[[str], None] = print,
) -> List[Tuple[str, float, str]]:
    """Audition loop: for each (clip_path, metric) play + rate; returns and
    writes [(clip, metric, rating)] where rating in {good, bad, skip}.

    Mirrors label_directory.py:50-103 ('closest'/'farthest' distance-sorted
    CSVs in, ratings CSV out); quitting persists ratings so far.
    """
    results: List[Tuple[str, float, str]] = []
    for ix, (clip, metric) in enumerate(clips):
        echo(f"\n:::::: CLIP # {ix} ::: {clip} (metric {metric:.3f})")
        echo(KEYS_HELP)
        play_fn(clip)
        rating = None
        while rating is None:
            ch = getch_fn().lower()
            if ch == "g":
                rating = "good"
            elif ch == "b":
                rating = "bad"
            elif ch == "s":
                rating = "skip"
            elif ch == "r":
                play_fn(clip)
            elif ch in ("q", "\x03"):
                _write_ratings(out_csv, results)
                return results
        results.append((str(clip), float(metric), rating))
    _write_ratings(out_csv, results)
    return results


def _write_ratings(out_csv, rows) -> None:
    Path(out_csv).parent.mkdir(parents=True, exist_ok=True)
    with open(out_csv, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerows(rows)


def read_distance_csv(path) -> List[Tuple[str, float]]:
    """[(clip, distance)] from the distance-filtering CSVs the reference's
    labeling flow consumes (label_directory.py:45-52)."""
    out = []
    with open(path) as fh:
        for r in csv.reader(fh):
            if len(r) >= 2:
                out.append((r[0], float(r[1])))
    return out


def listen(files: Sequence[str], play_fn: Callable[[str], None] = play_clip,
           echo: Callable[[str], None] = print) -> None:
    """Sequential audition scratchpad (reference listen.py)."""
    for f in files:
        echo(str(f))
        play_fn(f)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="audition + rate clips")
    ap.add_argument("--input-csv", required=True,
                    help="csv of clip,distance rows (distance filtering output)")
    ap.add_argument("--clips-dir", default=".",
                    help="directory the clip paths are relative to")
    ap.add_argument("--out-csv", required=True)
    args = ap.parse_args(argv)
    clips = [
        (str(Path(args.clips_dir) / c), d)
        for c, d in read_distance_csv(args.input_csv)
    ]
    label_clips(clips, args.out_csv)


if __name__ == "__main__":
    main()
