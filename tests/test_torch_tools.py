"""The port's copies of the corpus tools, audio ops and labeling CLI
(multilingual_kws_tpu_torch/{utils/audio_ops,tools/*,api/labeling}.py)
against the JAX package's, on the fixtures of tests/test_tools.py,
tests/test_transcripts.py and tests/test_microset_speaker.py: the same
calls on the same inputs in both packages, and every output (arrays,
manifests, label files, wavs, JSON, returned values) must be ``==``. Both
are numpy on the same wav reader and writer, so nothing may differ.
"""

import csv
import dataclasses
import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import multilingual_kws_tpu.api.labeling as j_labeling
import multilingual_kws_tpu.tools.capture_golden as j_golden
import multilingual_kws_tpu.tools.corpus as j_corpus
import multilingual_kws_tpu.tools.microset as j_microset
import multilingual_kws_tpu.tools.stream_sentences as j_sentences
import multilingual_kws_tpu.tools.stream_synth as j_synth
import multilingual_kws_tpu.tools.textgrid as j_textgrid
import multilingual_kws_tpu.tools.transcripts as j_transcripts
import multilingual_kws_tpu.tools.word_extraction as j_wx
import multilingual_kws_tpu.utils.audio_ops as j_audio
import multilingual_kws_tpu_torch.api.labeling as labeling
import multilingual_kws_tpu_torch.tools.capture_golden as golden
import multilingual_kws_tpu_torch.tools.corpus as corpus
import multilingual_kws_tpu_torch.tools.microset as microset
import multilingual_kws_tpu_torch.tools.stream_sentences as sentences
import multilingual_kws_tpu_torch.tools.stream_synth as synth
import multilingual_kws_tpu_torch.tools.textgrid as textgrid
import multilingual_kws_tpu_torch.tools.transcripts as transcripts
import multilingual_kws_tpu_torch.tools.word_extraction as wx
import multilingual_kws_tpu_torch.utils.audio_ops as audio
from helpers import keyword_clip
from multilingual_kws_tpu_torch.utils.wav import read_wav, write_wav

SR = 16000
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this file runs: the suite runs in parallel
    workers that share the cores, and small ops then spend their time in
    thread barriers rather than arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain(x):
    """Dataclasses (each package has its own classes) as tuples, recursively."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    return x


def same_tree(a: Path, b: Path):
    """Two directories hold the same relative paths with the same bytes."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


# -- audio ops -----------------------------------------------------------------


def test_audio_ops_equal(tmp_path):
    rng = np.random.default_rng(0)
    t48 = np.arange(48000) / 48000
    x48 = (0.5 * np.sin(2 * np.pi * 440 * t48) + rng.normal(0, 0.01, 48000)).astype(np.float32)
    x = rng.normal(0, 0.2, SR).astype(np.float32)
    for sr_in, sr_out in ((48000, 16000), (16000, 16000), (22050, 16000), (8000, 16000)):
        np.testing.assert_array_equal(audio.resample(x48, sr_in, sr_out), j_audio.resample(x48, sr_in, sr_out))
    np.testing.assert_array_equal(audio.trim(x, SR, 0.25, 0.75), j_audio.trim(x, SR, 0.25, 0.75))
    np.testing.assert_array_equal(audio.fade(x, SR, 0.025, 0.025), j_audio.fade(x, SR, 0.025, 0.025))
    np.testing.assert_array_equal(audio.pad(x, SR, 0.1, 0.2), j_audio.pad(x, SR, 0.1, 0.2))
    np.testing.assert_array_equal(audio.concat([x, x[:100]]), j_audio.concat([x, x[:100]]))
    write_wav(tmp_path / "d.wav", np.zeros(24000, np.float32))
    assert audio.duration_s(tmp_path / "d.wav") == j_audio.duration_s(tmp_path / "d.wav") == 1.5
    write_wav(tmp_path / "x48.wav", x48.clip(-1, 1), 48000)
    np.testing.assert_array_equal(audio.read_audio_any(tmp_path / "x48.wav"),
                                  j_audio.read_audio_any(tmp_path / "x48.wav"))
    audio.decode_to_wav(tmp_path / "x48.wav", tmp_path / "port" / "x.wav")
    j_audio.decode_to_wav(tmp_path / "x48.wav", tmp_path / "jax" / "x.wav")
    assert (tmp_path / "port" / "x.wav").read_bytes() == (tmp_path / "jax" / "x.wav").read_bytes()


def test_decode_without_a_decoder_raises(tmp_path, monkeypatch):
    (tmp_path / "c.mp3").write_bytes(b"")
    monkeypatch.setattr(audio.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="no decoder available for .mp3"):
        audio.decode_to_wav(tmp_path / "c.mp3", tmp_path / "c.wav")


# -- textgrid --------------------------------------------------------------------


def test_textgrid_roundtrip_and_short_format(tmp_path):
    intervals = [("", 0.0, 0.42), ("hello", 0.42, 0.91), ("world", 0.91, 1.5)]
    textgrid.write_textgrid(tmp_path / "p.TextGrid", intervals)
    j_textgrid.write_textgrid(tmp_path / "j.TextGrid", intervals)
    assert (tmp_path / "p.TextGrid").read_bytes() == (tmp_path / "j.TextGrid").read_bytes()
    assert plain(textgrid.read_textgrid(tmp_path / "p.TextGrid")) == plain(j_textgrid.read_textgrid(tmp_path / "p.TextGrid"))
    short = tmp_path / "short.TextGrid"
    short.write_text('File type = "ooTextFile"\nObject class = "TextGrid"\n\n0\n2.5\n<exists>\n1\n'
                     '"IntervalTier"\n"words"\n0\n2.5\n2\n0\n1.2\n"foo"\n1.2\n2.5\n"bar"\n')
    got = textgrid.read_textgrid(short)
    assert [(i.mark, i.minTime, i.maxTime) for i in got] == [("foo", 0.0, 1.2), ("bar", 1.2, 2.5)]
    assert plain(got) == plain(j_textgrid.read_textgrid(short))
    bad = tmp_path / "bad.TextGrid"
    bad.write_text("not a textgrid\n")
    with pytest.raises(textgrid.TextGridError):
        textgrid.read_textgrid(bad)
    with pytest.raises(j_textgrid.TextGridError):
        j_textgrid.read_textgrid(bad)


# -- word extraction -------------------------------------------------------------


@pytest.fixture()
def mini_cv(tmp_path):
    """tests/test_tools.py's miniature Common Voice layout."""
    lang, base, clipdir = "xx", tmp_path / "align", tmp_path / "clips"
    clipdir.mkdir()
    rows = [("c0.wav", "", "hello world"), ("c1.wav", "", "world again today"), ("c2.wav", "", "nothing here"),
            ("c3.wav", "", "hello hello")]
    csvp = base / lang / "validated.csv"
    csvp.parent.mkdir(parents=True)
    with open(csvp, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["path", "x", "sentence"])
        w.writerows(rows)
    for name, _, sent in rows:
        stem = name[:-4]
        iv, t = [("", 0.0, 0.2)], 0.2
        for wd in sent.split():
            iv.append((wd, t, t + 0.5))
            t += 0.5
        iv.append(("", t, 2.0))
        textgrid.write_textgrid(base / lang / "alignments" / f"{stem}.TextGrid", iv)
        tt = np.arange(2 * SR) / SR
        write_wav(clipdir / name, (0.3 * np.sin(2 * np.pi * (300 + 100 * int(stem[1])) * tt)).astype(np.float32))
    return dict(lang=lang, base=base, clips=clipdir)


def test_word_extraction_equal(mini_cv, tmp_path):
    lang, base = mini_cv["lang"], mini_cv["base"]
    assert wx.wordcounts(base / lang / "validated.csv") == j_wx.wordcounts(base / lang / "validated.csv")
    fm = wx.generate_filemap(lang, base)
    assert fm == j_wx.generate_filemap(lang, base) and set(fm) == {"c0", "c1", "c2", "c3"}
    want = j_wx.generate_wordtimings({"hello", "world"}, fm, lang, base, num_workers=0)
    assert wx.generate_wordtimings({"hello", "world"}, fm, lang, base, num_workers=0) == want
    assert len(want[0]["hello"]) == 5 and want[1] == []
    # the process pool (spawned workers)
    assert wx.generate_wordtimings({"hello", "world"}, fm, lang, base, num_workers=2) == want
    for seed in (0, 1):
        assert (wx.random_non_target_sentences(1, {"hello", "world"}, lang, base, rng=np.random.default_rng(seed))
                == j_wx.random_non_target_sentences(1, {"hello", "world"}, lang, base,
                                                    rng=np.random.default_rng(seed)))
    with pytest.raises(ValueError):
        wx.random_non_target_sentences(3, {"hello", "world"}, lang, base, rng=np.random.default_rng(0))
    for args in ((0.8, 0.1, 0.5), (2.0, 0.6, 1.0), (2.0, 1.8, 2.0), (2.0, 0.0, 0.1)):
        assert wx.extract_one_second(*args) == j_wx.extract_one_second(*args)
    tg = base / lang / "alignments" / "c1.TextGrid"
    assert wx.full_transcription_timings(tg) == j_wx.full_transcription_timings(tg)
    for pkg, mod in (("port", wx), ("jax", j_wx)):
        dest = tmp_path / pkg
        dest.mkdir()
        mod.extract_shot(mini_cv["clips"] / "c0.wav", 0.2, 0.7, dest, include_context=False)
        mod.extract_shot(mini_cv["clips"] / "c1.wav", 0.2, 0.7, dest, include_context=True)
    same_tree(tmp_path / "port", tmp_path / "jax")
    assert read_wav(next((tmp_path / "port").glob("c0*")))[0].shape == (SR,)


# -- corpus scaffolding ------------------------------------------------------------


def test_corpus_equal(tmp_path):
    counts = Counter({f"stop{i:02d}": 1000 - i for i in range(30)})
    counts.update({"keyword": 500, "anotherone": 400, "tiny": 300, "word!": 200})
    for kw in (dict(n_words=3, min_char_len=5, skip_first_n=20), dict(n_words=10, min_char_len=3, skip_first_n=0)):
        assert corpus.select_frequent_words(counts, **kw) == j_corpus.select_frequent_words(counts, **kw)
    for lang, words in (("xx", {"aaa": 3, "bbb": 1}), ("yy", {"ccc": 2}), ("zz", {})):
        for word, n in words.items():
            for i in range(n):
                write_wav(tmp_path / "frequent" / lang / "clips" / word / f"{i}.wav", np.zeros(160, np.float32))
        (tmp_path / "frequent" / lang).mkdir(parents=True, exist_ok=True)
    got = corpus.select_embedding_commands(tmp_path / "frequent", min_clips=1)
    assert got == j_corpus.select_embedding_commands(tmp_path / "frequent", min_clips=1)
    assert [w for w, _ in got["xx"]] == ["aaa"] and [w for w, _ in got["yy"]] == ["ccc"] and "zz" not in got
    for word in ["aaa", "bbb"]:
        d = tmp_path / "clips" / word
        d.mkdir(parents=True)
        for i in range(20):
            write_wav(d / f"{i}.wav", np.zeros(1600, np.float32))
    dirs = {w: str(tmp_path / "clips" / w) for w in ["aaa", "bbb"]}
    got = corpus.make_embedding_manifests(dirs, tmp_path / "port", val_fraction=0.1, seed=0)
    assert got == j_corpus.make_embedding_manifests(dirs, tmp_path / "jax", val_fraction=0.1, seed=0)
    assert len(got["val_files"]) == 4 and len(got["train_files"]) == 36
    same_tree(tmp_path / "port", tmp_path / "jax")
    timings = {"hello": [("c1", 0.5, 1.0), ("c1", 1.5, 2.0), ("c2", 0.2, 0.7)]}
    corpus.write_timing_csvs(timings, tmp_path / "t_port")
    j_corpus.write_timing_csvs(timings, tmp_path / "t_jax")
    same_tree(tmp_path / "t_port", tmp_path / "t_jax")
    assert corpus.read_timing_csv(tmp_path / "t_port" / "hello.csv") == {"c1": (0.5, 1.0), "c2": (0.2, 0.7)}
    assert (corpus.read_timing_csv(tmp_path / "t_port" / "hello.csv")
            == j_corpus.read_timing_csv(tmp_path / "t_port" / "hello.csv"))
    old, new = tmp_path / "nocontext", tmp_path / "context"
    for root in (old, new):
        (root / "word").mkdir(parents=True)
        (root / "word" / "a.wav").write_bytes(b"")
    files = [str(old / "word" / "a.wav")]
    assert corpus.repoint_manifest(files, old, new) == j_corpus.repoint_manifest(files, old, new)
    with pytest.raises(FileNotFoundError):
        corpus.repoint_manifest([str(old / "word" / "missing.wav")], old, new)


# -- streams ---------------------------------------------------------------------------


def test_generate_stream_and_labels_equal(mini_cv, tmp_path):
    wav_data = [dict(is_target=True, clip="c0", start_s=0.2, end_s=0.7), dict(is_target=False, clip="c2"),
                dict(is_target=True, clip="c3", start_s=0.7, end_s=1.2)]
    got = sentences.generate_stream_and_labels(tmp_path / "port", "hello", wav_data, mini_cv["clips"],
                                               clip_suffix=".wav")
    want = j_sentences.generate_stream_and_labels(tmp_path / "jax", "hello", wav_data, mini_cv["clips"],
                                                  clip_suffix=".wav")
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    same_tree(tmp_path / "port", tmp_path / "jax")
    assert Path(got[1]).read_text().splitlines() == ["hello, 0", "hello, 3000"]


def test_select_samples_equal(mini_cv):
    timings = {"hello": [("c0", 0.2, 0.7), ("c1", 0.2, 0.7), ("c3", 0.2, 0.7)]}
    kw = dict(num_samples_for_streaming_wav=1, num_shots=1, num_val=1)
    for seed in (0, 3):
        got = sentences.select_samples("hello", timings, mini_cv["lang"], mini_cv["base"],
                                       rng=np.random.default_rng(seed), **kw)
        want = j_sentences.select_samples("hello", timings, mini_cv["lang"], mini_cv["base"],
                                          rng=np.random.default_rng(seed), **kw)
        assert got == want


def test_stream_synth_equal(tmp_path):
    targets = [keyword_clip("alpha", seed=500 + i) for i in range(3)]
    others = [keyword_clip("charlie", seed=600 + i) for i in range(3)]
    got = synth.synthesize_stream("alpha", targets, others, 4, 3, noise_rms=0.003, seed=1)
    assert plain(got) == plain(j_synth.synthesize_stream("alpha", targets, others, 4, 3, noise_rms=0.003, seed=1))
    assert len(got.labels) == 4
    nt = synth.synthesize_nontarget_stream(others, num_distractors=4, seed=2, noise_rms=0.003)
    assert plain(nt) == plain(j_synth.synthesize_nontarget_stream(others, num_distractors=4, seed=2,
                                                                   noise_rms=0.003))
    assert nt.labels == []
    for pkg, mod, spec in (("port", synth, got), ("jax", j_synth, got)):
        (tmp_path / pkg).mkdir()
        mod.write_stream(spec, tmp_path / pkg / "s.wav", tmp_path / pkg / "s.txt")
    same_tree(tmp_path / "port", tmp_path / "jax")


# -- transcripts --------------------------------------------------------------------------


def _tone(freq, dur_s, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(dur_s * SR)) / SR
    return np.clip(0.3 * np.sin(2 * np.pi * freq * t) + rng.normal(0, 0.01, t.shape), -1, 1).astype(np.float32)


@pytest.fixture()
def transcript_corpus(tmp_path):
    """tests/test_transcripts.py's Makerere-style layout."""
    clips = tmp_path / "clips"
    clips.mkdir()
    rows = [("a.wav", "akawuka kiki kino"), ("b.wav", "ekintu kirala wano"), ("c.wav", "masiki eyo wano"),
            ("d.wav", "akawuka era akawuka"), ("e.wav", "tulina okwegendereza")]
    durs = {"a.wav": 2.0, "b.wav": 1.5, "c.wav": 1.2, "d.wav": 3.0, "e.wav": 1.8}
    for i, (name, _t) in enumerate(rows):
        write_wav(clips / name, _tone(300 + 100 * i, durs[name], seed=i))
    csv_path = tmp_path / "transcripts.csv"
    with open(csv_path, "w") as fh:
        fh.write("wav_filename,wav_filesize,transcript\n")
        for name, t in rows:
            fh.write(f"{name},0,{t}\n")
    adir, cdir = tmp_path / "alignments", tmp_path / "cs_clips"
    for cid, (name, text, ivs) in {
        "a": ("a.wav", "akawuka kiki kino", [("akawuka", 0.5, 1.0), ("kiki", 1.0, 1.4)]),
        "d": ("d.wav", "akawuka era akawuka", [("akawuka", 0.2, 0.7), ("era", 0.8, 1.1), ("akawuka", 1.9, 2.4)]),
        "b": ("b.wav", "ekintu kirala wano", [("ekintu", 0.1, 0.6)]),
    }.items():
        (cdir / cid).mkdir(parents=True)
        (adir / cid).mkdir(parents=True)
        write_wav(cdir / cid / f"{cid}.wav", read_wav(clips / name)[0])
        (cdir / cid / f"{cid}.lab").write_text(text)
        textgrid.write_textgrid(adir / cid / f"{cid}.TextGrid", ivs)
    (adir / "unaligned.txt").write_text("")
    return dict(csv=csv_path, clips=clips, alignments=adir, cs_clips=cdir)


def test_transcripts_equal(transcript_corpus, tmp_path):
    c = transcript_corpus
    out = {}
    for pkg, mod in (("port", transcripts), ("jax", j_transcripts)):
        entries = mod.load_transcripts_csv(c["csv"], c["clips"])
        with_kw, without = mod.split_by_keywords(entries, {"akawuka"}, exclude={"masiki"})
        targets = mod.timings_from_alignments(c["alignments"], c["cs_clips"], {"akawuka"})
        gt = mod.assemble_multitarget_stream(targets, without, tmp_path / pkg / "eval", seed=3)
        nt = mod.assemble_nontarget_stream(without, tmp_path / pkg / "nt", num_wavs=6, seed=0)
        lookups = [mod.transcript_by_offset(t["time_ms"], gt) for t in gt["groundtruth_target_times_ms"]]
        lookups += [mod.transcript_by_offset(500.0, nt), mod.transcript_by_offset(nt["total_duration_s"] * 1000 + 50, nt)]
        out[pkg] = plain([entries, with_kw, without, mod.keyword_counts(entries, {"akawuka"}), targets, gt, nt, lookups])
    assert out["port"] == out["jax"]
    same_tree(tmp_path / "port", tmp_path / "jax")
    gt = json.loads((tmp_path / "port" / "eval" / "groundtruth.json").read_text())
    assert len(gt["groundtruth_target_times_ms"]) == 3


# -- microset ---------------------------------------------------------------------------------


def test_microset_equal(tmp_path):
    splits = tmp_path / "en_splits.csv"
    rows = [["SET", "LINK", "WORD", "VALID", "SPEAKER", "GENDER"]]
    rows += [["TRAIN", f"hello/c{i}.wav", "hello", "", "", ""] for i in range(10)]
    rows += [["DEV", "hello/d0.wav", "hello", "", "", ""], ["TEST", "hello/t0.wav", "hello", "", "", ""],
             ["TRAIN", "other/x.wav", "other", "", "", ""], ["TRAIN", "hello/swts1.wav", "hello", "", "", ""]]
    with open(splits, "w", newline="") as fh:
        csv.writer(fh).writerows(rows)
    (tmp_path / "swts.txt").write_text("clips/swts1.mp3\n")
    swts = microset.read_swts_filter(tmp_path / "swts.txt")
    assert swts == j_microset.read_swts_filter(tmp_path / "swts.txt")
    ms = microset.generate_microset(["hello"], splits, swts, max_clips_per_kw=4)
    assert ms == j_microset.generate_microset(["hello"], splits, swts, max_clips_per_kw=4)
    assert len(ms["train"]["hello"]) == 4 and "other" not in ms["train"]
    microset.write_microset_csv(ms, tmp_path / "port.csv")
    j_microset.write_microset_csv(ms, tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    rng = np.random.default_rng(9)
    for clip in {c for split in ms.values() for clips in split.values() for c in clips}:
        write_wav(tmp_path / "audio" / clip, rng.normal(0, 0.1, 22050).clip(-1, 1).astype(np.float32), 22050)
    got = microset.materialize_microset(ms, tmp_path / "audio", tmp_path / "m_port")
    want = j_microset.materialize_microset(ms, tmp_path / "audio", tmp_path / "m_jax")
    assert [p.relative_to(tmp_path / "m_port") for p in got] == [p.relative_to(tmp_path / "m_jax") for p in want]
    same_tree(tmp_path / "m_port", tmp_path / "m_jax")


# -- golden capture ----------------------------------------------------------------------------


def test_capture_golden_inputs_equal():
    got, want = golden.make_waveforms(), j_golden.make_waveforms()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert golden.CONFIGS == j_golden.CONFIGS


def test_capture_golden_reproduces_the_committed_file(tmp_path, monkeypatch):
    """The port's capture (the real TFLite op, TensorFlow imported inside)
    writes arrays == tests/golden/microfrontend_golden.npz, which the JAX
    package's tool wrote. It writes into <repo>/tests/golden, found from its
    own path: here the module's path is moved under tmp_path."""
    pytest.importorskip("tensorflow")
    monkeypatch.setattr(golden, "__file__", str(tmp_path / "pkg" / "tools" / "capture_golden.py"))
    golden.main()
    got = np.load(tmp_path / "tests" / "golden" / "microfrontend_golden.npz")
    want = np.load(REPO / "tests" / "golden" / "microfrontend_golden.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- labeling -------------------------------------------------------------------------------------


def test_labeling_loop_scripted_equal(tmp_path):
    clips = [("a.wav", 0.1), ("b.wav", 0.5), ("c.wav", 0.9)]
    out = {}
    for pkg, mod in (("port", labeling), ("jax", j_labeling)):
        keys = iter(["g", "r", "x", "b", "s", "q"])
        played, echoed = [], []
        res = mod.label_clips(clips + [("d.wav", 1.0)], tmp_path / f"{pkg}.csv", getch_fn=lambda: next(keys),
                              play_fn=played.append, echo=echoed.append)
        out[pkg] = (res, played, echoed, (tmp_path / f"{pkg}.csv").read_bytes(),
                    mod.read_distance_csv(tmp_path / f"{pkg}.csv"))
        listened = []
        mod.listen(["a.wav", "b.wav"], play_fn=listened.append, echo=listened.append)
        out[pkg] += (listened,)
    assert out["port"] == out["jax"]
    assert out["port"][0] == [("a.wav", 0.1, "good"), ("b.wav", 0.5, "bad"), ("c.wav", 0.9, "skip")]
    assert out["port"][1] == ["a.wav", "b.wav", "b.wav", "c.wav", "d.wav"]


def test_labeling_main_equal(tmp_path, monkeypatch):
    (tmp_path / "dist.csv").write_text("a.wav,0.25\nb.wav,0.75\n")
    for pkg, mod in (("port", labeling), ("jax", j_labeling)):
        keys = iter(["b", "g"])
        monkeypatch.setattr(mod, "getch_unix", lambda: next(keys))
        monkeypatch.setattr(mod, "play_clip", lambda path: None)
        monkeypatch.setattr(mod.label_clips, "__defaults__",
                            (mod.getch_unix, mod.play_clip, lambda *_: None))
        mod.main(["--input-csv", str(tmp_path / "dist.csv"), "--clips-dir", "clips",
                  "--out-csv", str(tmp_path / f"{pkg}.csv")])
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert labeling.read_distance_csv(tmp_path / "port.csv") == [("clips/a.wav", 0.25), ("clips/b.wav", 0.75)]
