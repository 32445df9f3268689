"""AudioDataset: host file loading + on-device augmentation/featurization.

Counterpart of ``multilingual_kws_tpu/data/dataset.py`` (itself a re-design
of the reference AudioDataset, input_data.py:173-556). The host decides
which clip fills each batch slot (target, unknown or silence; file IO lives
there); the device applies the whole train transform to the batch:

    augment_quantize (CUDA: gather, shift, crop, mix, int16 quantize)
      -> features_from_int16 (CUDA: clip_features; in fast mode the fast
         prefix and noise_scan_f32) -> SpecAugment

Label order is the reference's: [_silence_, _unknown_, word1, ...].

Host draws are the JAX package's, line for line (``_host_train_draw``, one
numpy ``default_rng(seed)``), so one seed gives the same clip indices,
labels and silence flags in both packages. The device draws (augmentation,
SpecAugment) come from one ``torch.Generator`` on the dataset's device,
seeded with the same seed: they have the JAX package's distributions, not
its bits. Both training pipelines, the streaming one (``train_batches``: a
host batch uploaded per step, prefetched on a thread) and the resident one
(``train_batches_resident``: the clips uploaded once, indices per step), go
through one device transform (``augment_featurize``) and consume the
generator alike, so one seed gives them identical specs.

Data parallelism (``shard=(rank, world_size)``, ``parallel/mesh.py``): every
process makes the same host draw of the global batch and the same device
draws (augmentation, SpecAugment) for all of its rows, from the same seed,
and keeps its own contiguous block of rows (``mesh.local_rows``): it uploads
only those clips (or bank indices), and the augment kernel and the frontend
run on those rows only. A process's rows are therefore the rows one process
would make of the global batch.

Clips are read by the native threaded wav loader (``native/wavloader.py``,
batches of cache misses), whose rows equal ``utils/wav.read_wav_int16``'s.
"""

from __future__ import annotations

import functools
import glob
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..native.wavloader import load_batch
from ..ops.augment import AugmentParams, SpecAugParams, SpecMaskDraws, apply_spec_masks, draw_spec_masks, pad_background_bank
from ..ops.cuda_augment import AugmentDraws, augment_quantize, draw_augment_params
from ..ops.micro_exact import FrontendConfig
from ..ops.micro_torch import MicroFrontendTorch, cached_stream_frontend
from ..parallel.mesh import local_rows
from ..settings import SILENCE_LABEL, UNKNOWN_WORD_LABEL, ModelSettings
from ..utils.wav import read_wav, read_wav_int16


def file2spec(model_settings, filepath, device="cuda") -> np.ndarray:
    """One wav path -> (49, 40) float32 features (reference file2spec,
    input_data.py:38-47). Batch work should use
    train/evaluate.featurize_files instead."""
    fe = cached_stream_frontend(model_settings.sample_rate, str(resolve_device(device)))
    audio, _ = read_wav(filepath, desired_samples=model_settings.desired_samples)
    return fe.features(torch.from_numpy(audio[None, :]).to(fe.device))[0].cpu().numpy()


@functools.lru_cache(maxsize=8)
def _shared_frontend(config: FrontendConfig, device: str) -> MicroFrontendTorch:
    """One frontend per config and device, so its tables upload once."""
    return MicroFrontendTorch(config, device=device)


def augment_featurize(
    frontend, aug_params: AugmentParams, gen, fg_bank, rows, is_silence, bg_data, bg_sizes, keep=slice(None)
):
    """The whole train-batch device transform: (B,) rows of the int16
    ``fg_bank`` -> (B, 49, 40, 1) float32 specs.

    Draws the augmentation, runs ``augment_quantize`` (which reads the rows
    from the bank), the frontend on the int16 result and SpecAugment, all
    from ``gen``. ``keep`` selects a process's rows of the global batch
    (data parallelism): the draws are made for all B rows, and the kernels
    run on the kept rows only (``rows`` outside ``keep`` are not read)."""
    b = rows.shape[0]
    draws = draw_augment_params(gen, b, fg_bank.shape[1], bg_sizes, aug_params)
    draws = AugmentDraws(*(d[keep] for d in draws))
    quant = augment_quantize(fg_bank, rows[keep], is_silence[keep], bg_data, draws)
    specs = frontend.features_from_int16(quant)
    masks = draw_spec_masks(gen, b, specs.shape[1], specs.shape[2], aug_params.spec_aug)
    return apply_spec_masks(specs, SpecMaskDraws(*(m[keep] for m in masks)))[..., None]


def load_background_bank(background_dir) -> Tuple[np.ndarray, np.ndarray]:
    """All background wavs into one zero-padded float32 array (reference
    get_background_data, input_data.py:375-394), padded like the JAX
    package's bank. Returns (bank, sizes)."""
    paths = sorted(glob.glob(os.path.join(str(background_dir), "*.wav")))
    if not paths:
        raise FileNotFoundError(f"no background wavs in {background_dir}")
    wavs = [read_wav(p)[0] for p in paths]
    sizes = np.array([w.shape[0] for w in wavs], dtype=np.int32)
    bank = np.zeros((len(wavs), sizes.max()), dtype=np.float32)
    for i, w in enumerate(wavs):
        bank[i, : w.shape[0]] = w
    return pad_background_bank(bank), sizes


class AudioDataset:
    """Few-shot / pretraining dataset with on-device augmentation.

    Parameters mirror the reference constructor (input_data.py:174-213);
    ``device`` is where batches are augmented and featurized (``"cuda"`` by
    default: it raises without a card unless given ``"cpu"``). ``shard`` =
    (rank, world size): the training batches hold that rank's rows of each
    global batch (module docstring); eval batches are whole."""

    # default device-memory budget for transfer_learn's automatic choice of
    # the resident pipeline (the JAX package's value)
    RESIDENT_MAX_BYTES = 4 << 30

    def __init__(
        self,
        model_settings: ModelSettings,
        commands: Sequence[str],
        background_data_dir,
        unknown_files: Sequence[str],
        time_shift_ms: int = 100,
        background_frequency: float = 0.8,
        background_volume_range: float = 0.1,
        silence_percentage: float = 10.0,
        unknown_percentage: float = 10.0,
        spec_aug_params: SpecAugParams = SpecAugParams(),
        seed: Optional[int] = None,
        frontend: Optional[MicroFrontendTorch] = None,
        device="cuda",
        shard: Tuple[int, int] = (0, 1),
    ):
        self.device = resolve_device(device)
        self.shard = shard
        self.model_settings = model_settings
        self.unknown_files = list(unknown_files)
        self.unknown_percentage = unknown_percentage
        self.silence_percentage = silence_percentage

        commands = list(commands)
        if len(self.unknown_files) > 0 and unknown_percentage > 0:
            commands = [UNKNOWN_WORD_LABEL] + commands
        if silence_percentage > 0:
            commands = [SILENCE_LABEL] + commands
        self.commands = commands
        self.label_to_id = {c: i for i, c in enumerate(commands)}

        bank, sizes = load_background_bank(background_data_dir)
        self._bg_host, self._bg_sizes_host = bank, sizes
        self.bg_data = torch.from_numpy(bank).to(self.device)
        self.bg_sizes = torch.from_numpy(sizes).to(self.device)

        self.aug_params = AugmentParams(
            time_shift_samples=int(time_shift_ms * model_settings.sample_rate / 1000),
            background_frequency=background_frequency,
            background_volume_range=background_volume_range,
            spec_aug=spec_aug_params,
        )
        self.frontend = frontend or _shared_frontend(
            FrontendConfig(
                sample_rate=model_settings.sample_rate,
                window_size_ms=int(model_settings.window_size_ms),
                window_step_ms=int(model_settings.window_stride_ms),
                num_channels=model_settings.fingerprint_width,
            ),
            str(self.device),
        )

        seed_val = seed if seed is not None else np.random.SeedSequence().entropy % (2**31)
        self.host_rng = np.random.default_rng(seed_val)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed_val) % (2**31))
        self._wav_cache: Dict[str, np.ndarray] = {}

    # -- device functions -----------------------------------------------------

    def _train_device(self, fg_bank, rows, is_silence, keep=slice(None)):
        return augment_featurize(
            self.frontend, self.aug_params, self.gen, fg_bank, rows, is_silence,
            self.bg_data, self.bg_sizes, keep,
        )

    def _keep(self, batch_size: int) -> slice:
        """This process's rows of a global training batch."""
        return local_rows(batch_size, self.shard)

    def _eval_device(self, wav_int16):
        return self.frontend.features_from_int16(wav_int16)[..., None]

    def _put_batch(self, batch):
        """numpy (int16 waveforms or bank rows, label ids, is_silence) -> the
        same on the device (rows as int32, labels as int64)."""
        data, lbl, sil = batch
        dtype = torch.int16 if data.dtype == np.int16 else torch.int32
        return (
            torch.from_numpy(np.ascontiguousarray(data)).to(self.device, dtype),
            torch.from_numpy(np.asarray(lbl)).to(self.device, torch.int64),
            torch.from_numpy(np.asarray(sil, dtype=bool)).to(self.device),
        )

    # -- host helpers -----------------------------------------------------------

    def _load(self, path: str) -> np.ndarray:
        """Clip as int16 PCM (cached): the device casts it itself."""
        cached = self._wav_cache.get(path)
        if cached is None:
            cached, _ = read_wav_int16(path, desired_samples=self.model_settings.desired_samples)
            if len(self._wav_cache) < 4096:
                self._wav_cache[path] = cached
        return cached

    def _load_many(self, paths: Sequence[str]) -> np.ndarray:
        """Clips -> int16 (N, samples): the cache misses are read in one call
        of the native threaded wav loader (``native/wavloader.py``), each row
        equal to ``_load``'s."""
        n = self.model_settings.desired_samples
        misses = list(dict.fromkeys(p for p in paths if p not in self._wav_cache))
        loaded = dict(zip(misses, load_batch(misses, n)))
        for p, row in loaded.items():
            if len(self._wav_cache) < 4096:
                self._wav_cache[p] = row
        out = np.empty((len(paths), n), np.int16)
        for i, p in enumerate(paths):
            out[i] = loaded[p] if p in loaded else self._wav_cache[p]
        return out

    # -- public pipelines --------------------------------------------------------

    def train_batches(
        self,
        files: Sequence[str],
        batch_size: int,
        num_steps: int,
        labels: Optional[Sequence[str]] = None,
        single_target: bool = True,
        prefetch: int = 0,
    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Infinite-shuffle training batches: yields (specs (B, T, F, 1),
        label_ids (B,)) on the device.

        single_target=True mimics init_single_target (label = last command,
        input_data.py:447-471); otherwise labels come from the parallel
        ``labels`` list. prefetch > 0 assembles host batches, and uploads
        them, that many steps ahead on a background thread
        (data/pipeline.py); the batches are the same either way. Under a
        ``shard`` only this process's clips are read and uploaded."""
        keep = self._keep(batch_size)
        host = self.host_train_batches(
            files, batch_size, num_steps, labels=labels, single_target=single_target, keep=keep
        )
        transfer = map(self._put_batch, host)
        if prefetch > 0:
            from .pipeline import prefetch as _prefetch

            transfer = _prefetch(transfer, size=prefetch)
        # the global batch's rows, numbered so that the kept ones index the
        # uploaded clips
        rows = torch.arange(-keep.start, batch_size - keep.start, dtype=torch.int32, device=self.device)
        for wav, lbl, sil in transfer:
            yield self._train_device(wav, rows, sil, keep), lbl

    def build_resident_bank(self, files: Sequence[str]):
        """Upload every unique training clip (plus unknowns) once as an
        int16 (N, samples) device tensor. Returns {"bank": tensor, "index":
        {path: row}}."""
        uniq = list(dict.fromkeys(list(files) + list(self.unknown_files)))
        bank = torch.from_numpy(self._load_many(uniq)).to(self.device)
        return {"bank": bank, "index": {f: i for i, f in enumerate(uniq)}}

    def host_train_indices(
        self,
        files: Sequence[str],
        batch_size: int,
        num_steps: int,
        bank,
        labels: Optional[Sequence[str]] = None,
        single_target: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """The batch draw mapped onto resident-bank rows: yields numpy
        (bank row indices (B,), label_ids (B,), is_silence (B,)) per step.
        Silence slots point at bank row 0; the augment kernel replaces them
        with the background crop whatever the row holds."""
        row = bank["index"]
        files = list(files)
        rows_files = np.array([row[p] for p in files], dtype=np.int32)
        p_unk = self.unknown_percentage / 100.0 if self.unknown_files else 0.0
        rows_unknown = (
            np.array([row[p] for p in self.unknown_files], dtype=np.int32)
            if p_unk > 0
            else np.zeros(1, np.int32)
        )
        for fidx, is_sil, is_unk, unk_pick, lbl in self._host_train_draw(
            files, batch_size, num_steps, labels=labels
        ):
            idx = rows_files[fidx]
            if p_unk > 0:
                idx = np.where(is_unk, rows_unknown[unk_pick], idx)
            idx = np.where(is_sil, np.int32(0), idx).astype(np.int32)
            yield idx, lbl, is_sil

    def train_batches_resident(
        self,
        files: Sequence[str],
        batch_size: int,
        num_steps: int,
        labels: Optional[Sequence[str]] = None,
        single_target: bool = True,
        bank=None,
    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """train_batches with the clips already on the device
        (build_resident_bank): same draws, same augmentation, same specs, but
        each step uploads only (indices, labels, silence flags)."""
        bank = bank or self.build_resident_bank(files)
        keep = self._keep(batch_size)
        for idx, lbl, sil in self.host_train_indices(
            files, batch_size, num_steps, bank, labels=labels, single_target=single_target
        ):
            idx, lbl, sil = self._put_batch((idx, lbl[keep], sil))
            yield self._train_device(bank["bank"], idx, sil, keep), lbl

    def host_train_batches(
        self,
        files: Sequence[str],
        batch_size: int,
        num_steps: int,
        labels: Optional[Sequence[str]] = None,
        single_target: bool = True,
        keep: slice = slice(None),
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Host-side half of train_batches: yields numpy (int16 waveforms
        (B, N), label_ids (B,), is_silence (B,)), silence rows zero. Pure
        numpy and file IO: safe on a background thread. ``keep`` selects the
        rows of the waveforms and labels to load and yield (is_silence stays
        whole)."""
        n = self.model_settings.desired_samples
        for paths, lbl, sil in self.host_train_paths(
            files, batch_size, num_steps, labels=labels, single_target=single_target
        ):
            paths, lbl = paths[keep], lbl[keep]
            wav = np.zeros((len(paths), n), dtype=np.int16)
            real = [(i, p) for i, p in enumerate(paths) if p is not None]
            if real:
                loaded = self._load_many([p for _, p in real])
                for (i, _), r in zip(real, loaded):
                    wav[i] = r
            yield wav, lbl, sil

    def host_train_paths(
        self,
        files: Sequence[str],
        batch_size: int,
        num_steps: int,
        labels: Optional[Sequence[str]] = None,
        single_target: bool = True,
    ) -> Iterator[Tuple[List[Optional[str]], np.ndarray, np.ndarray]]:
        """The batch draw without the data: yields (clip paths, None for
        silence; label_ids; is_silence) per step."""
        files = list(files)
        unk = self.unknown_files
        for fidx, is_sil, is_unk, unk_pick, lbl in self._host_train_draw(
            files, batch_size, num_steps, labels=labels
        ):
            paths: List[Optional[str]] = [
                None if s else (unk[u] if k else files[f])
                for s, k, u, f in zip(
                    is_sil.tolist(), is_unk.tolist(), unk_pick.tolist(), fidx.tolist()
                )
            ]
            yield paths, lbl, is_sil

    def _host_train_draw(
        self,
        files: Sequence[str],
        batch_size: int,
        num_steps: int,
        labels: Optional[Sequence[str]] = None,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """The batch draw shared by both pipelines, and the one consumer of
        host_rng for training draws. Yields per step: (fidx (B,) index into
        files, is_silence (B,), is_unknown (B,), unk_pick (B,) index into
        unknown_files where is_unknown, label_ids (B,) int32).

        The reference's per-slot substitution (input_data.py:284-298): each
        slot takes the next file of a reshuffled permutation (the cursor
        advances for substituted slots too), then becomes silence w.p.
        p_sil, else unknown w.p. p_unk."""
        nf = len(files)
        if labels is None:
            label_ids = np.full(nf, len(self.commands) - 1, dtype=np.int32)
        else:
            label_ids = np.array([self.label_to_id[l] for l in labels], dtype=np.int32)
        sil_id = self.label_to_id.get(SILENCE_LABEL, -1)
        unk_id = self.label_to_id.get(UNKNOWN_WORD_LABEL, -1)
        p_sil = self.silence_percentage / 100.0
        p_unk = self.unknown_percentage / 100.0 if self.unknown_files else 0.0

        order = self.host_rng.permutation(nf)
        cursor = 0
        for _ in range(num_steps):
            chunks = []
            need = batch_size
            while need:
                if cursor >= nf:
                    order = self.host_rng.permutation(nf)
                    cursor = 0
                m = min(need, nf - cursor)
                chunks.append(order[cursor : cursor + m])
                cursor += m
                need -= m
            fidx = chunks[0] if len(chunks) == 1 else np.concatenate(chunks)
            is_sil = self.host_rng.uniform(size=batch_size) < p_sil
            if p_unk > 0:
                is_unk = ~is_sil & (self.host_rng.uniform(size=batch_size) < p_unk)
                unk_pick = self.host_rng.integers(len(self.unknown_files), size=batch_size)
            else:
                is_unk = np.zeros(batch_size, dtype=bool)
                unk_pick = np.zeros(batch_size, dtype=np.int64)
            lbl = label_ids[fidx].copy()
            lbl[is_sil] = sil_id
            lbl[is_unk] = unk_id
            yield fidx, is_sil, is_unk, unk_pick, lbl

    def eval_batches(
        self,
        files: Sequence[str],
        batch_size: int,
        labels: Optional[Sequence[str]] = None,
        single_target: bool = True,
        with_silence_unknown: bool = False,
    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """Deterministic eval batches (no augmentation): yields (specs (B,
        49, 40, 1), label_ids (B,)) on the device. Optionally appends
        synthetic silence/unknown examples like eval_with_silence_unknown
        (input_data.py:521-556). The last batch may be smaller."""
        files = list(files)
        if labels is None:
            label_ids = [len(self.commands) - 1] * len(files)
        else:
            label_ids = [self.label_to_id[l] for l in labels]

        n = self.model_settings.desired_samples
        loaded = self._load_many(files)
        entries: List[Tuple[np.ndarray, int]] = [(loaded[i], label_ids[i]) for i in range(len(files))]
        if with_silence_unknown:
            n_sil = int(len(files) * self.silence_percentage / 100)
            n_unk = int(len(files) * self.unknown_percentage / 100)
            bgd, bgs = self._bg_host, self._bg_sizes_host
            for _ in range(n_sil):
                bi = self.host_rng.integers(len(bgs))
                off = self.host_rng.integers(max(bgs[bi] - n, 1))
                vol = self.host_rng.uniform()
                # trunc(x*32768): the library's float -> int16 convention
                sil = np.clip(
                    np.trunc(bgd[bi, off : off + n] * vol * 32768.0), -32768, 32767
                ).astype(np.int16)
                entries.append((sil, self.label_to_id[SILENCE_LABEL]))
            for _ in range(n_unk):
                upath = self.unknown_files[self.host_rng.integers(len(self.unknown_files))]
                entries.append((self._load(upath), self.label_to_id[UNKNOWN_WORD_LABEL]))

        for i in range(0, len(entries), batch_size):
            chunk = entries[i : i + batch_size]
            wav = torch.from_numpy(np.stack([c[0] for c in chunk])).to(self.device)
            lbl = torch.tensor([c[1] for c in chunk], dtype=torch.int64, device=self.device)
            yield self._eval_device(wav), lbl
