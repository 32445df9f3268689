"""The micro audio frontend in PyTorch: the bit-exact mode and the fast mode.

Counterpart of ``multilingual_kws_tpu/ops/micro_jax.py``. The pipeline is
split as there (exact mode below; ``mode="fast"``, a float rFFT prefix and
an integer-valued float32 suffix, is ``ops/micro_fast.py``):

- the stateless prefix (``base_frames``): framing, quantized-Hann window
  ``>>12``, per-frame input_shift, the 512-point fixed-point kiss FFT,
  uint32 energies, the exact 64-bit filterbank accumulate, Sqrt64 and
  ``>>shift``. On a CUDA tensor it is one launch of the ``stream_prefix``
  kernel (``ops/cuda_fft.py``);
- the stateful suffix (``nr_pcan_log_int``): the noise-estimate
  recurrence, noise subtraction, PCAN gain and integer log. On a CUDA
  tensor it is one launch of the ``stream_suffix`` kernel
  (``ops/cuda_frontend.py``).

On a CPU tensor both run their plain PyTorch versions (int64 tensors that
hold uint32 values, ``ops/micro_int.py``). Every output is ``==`` to the
JAX package's exact mode, and hence to the TFLite op's golden features.

Clip batches (``features_from_int16``, ``features``) take both stages in one
launch of the ``clip_features`` kernel (``ops/cuda_clip.py``) on a CUDA
tensor, with the clip's signal kept in shared memory between them.

Streaming computes the prefix once per 20 ms hop for the whole stream; each
window then runs only the suffix over its 49 rows, with the noise state
restarting at the window start (``stream_features``).

The three entry points, ``features``, ``features_from_int16`` and
``stream_features``, are programs (``train/graphs.ProgramGraphs``), the
counterparts of ``MicroFrontendJax``'s jitted ``_features_jit``,
``_features_i16_jit`` and ``_stream_jit``: on a card one CUDA graph per
input shape after one eager call, and one program per ``num_windows`` of
the stream (its jit's static argument). Each runs on the frontend's device
and keeps its tables there. Inside another program or an epoch step they
run their eager twins (``features_eager``, ...), which that graph records.
"""

from __future__ import annotations

import functools
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..train.graphs import MAX_SHAPES, ProgramGraphs, _ProgramCache, inside_program
from . import cuda_clip, cuda_fast, cuda_fft, cuda_frontend, micro_fast
from . import micro_int as mi
from .micro_exact import NOISE_REDUCTION_BITS, FrontendConfig, MicroFrontend, _LOG_LUT


def _t(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


class KissFftrTorch:
    """Bit-exact fixed-point kiss_fftr(512) on int64 tensors.

    Four radix-4 stages over the 256-point complex substate, then the real
    post-stage, vectorized over any leading dims. Every intermediate fits
    int32 (the C code's accumulator width), so int64 never wraps where the
    C code would not.
    """

    STAGES = ((64, 1), (16, 4), (4, 16), (1, 64))

    def __init__(self):
        n = 256
        phase = -2.0 * np.pi * np.arange(n) / n
        self.tw_r = np.floor(0.5 + 32767 * np.cos(phase)).astype(np.int64)
        self.tw_i = np.floor(0.5 + 32767 * np.sin(phase)).astype(np.int64)
        sphase = -np.pi * ((np.arange(n // 2) + 1.0) / n + 0.5)
        self.stw_r = np.floor(0.5 + 32767 * np.cos(sphase)).astype(np.int64)
        self.stw_i = np.floor(0.5 + 32767 * np.sin(sphase)).astype(np.int64)
        # base-4 digit reversal of the 256 substate indices (an involution)
        self.perm = np.array(
            [sum(((i >> (2 * d)) & 3) << (2 * (3 - d)) for d in range(4)) for i in range(n)],
            np.int64,
        )

    @staticmethod
    def _sround(x):
        return (x + (1 << 14)) >> 15

    def _bfly4(self, fr, fi, fstride: int, m: int):
        sr = self._sround
        k = np.arange(m)
        tw = [
            (_t(self.tw_r[q * k * fstride], fr), _t(self.tw_i[q * k * fstride], fr))
            for q in (1, 2, 3)
        ]
        xs = [(sr(fr[..., q * m:(q + 1) * m] * 8191), sr(fi[..., q * m:(q + 1) * m] * 8191)) for q in range(4)]
        (x0r, x0i), rest = xs[0], xs[1:]
        s = [(sr(xr * tr - xi * ti), sr(xr * ti + xi * tr)) for (xr, xi), (tr, ti) in zip(rest, tw)]
        (s0r, s0i), (s1r, s1i), (s2r, s2i) = s
        s5r, s5i = x0r - s1r, x0i - s1i
        x0r, x0i = x0r + s1r, x0i + s1i
        s3r, s3i = s0r + s2r, s0i + s2i
        s4r, s4i = s0r - s2r, s0i - s2i
        return (
            torch.cat([x0r + s3r, s5r + s4i, x0r - s3r, s5r - s4i], dim=-1),
            torch.cat([x0i + s3i, s5i - s4r, x0i - s3i, s5i + s4r], dim=-1),
        )

    def __call__(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(..., 512) int64 (int16 range) -> (out_r, out_i): (..., 257) int64."""
        perm = _t(self.perm, x)
        return self.substate(x[..., 0::2][..., perm], x[..., 1::2][..., perm])

    def substate(self, fr: torch.Tensor, fi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The input-permuted complex substate (even and odd samples, each in
        base-4 digit-reversed order), (..., 256) int64 x2 -> (out_r, out_i):
        the four radix-4 stages and the real post-stage, (..., 257) int64."""
        sr = self._sround
        lead = fr.shape[:-1]
        for fstride, m in self.STAGES:
            groups = 256 // (4 * m)
            fr, fi = self._bfly4(
                fr.reshape(*lead, groups, 4 * m), fi.reshape(*lead, groups, 4 * m), fstride, m
            )
            fr, fi = fr.reshape(*lead, 256), fi.reshape(*lead, 256)

        tdc_r, tdc_i = sr(fr[..., 0] * 16383), sr(fi[..., 0] * 16383)
        k = torch.arange(1, 129, device=fr.device)
        fpk_r, fpk_i = sr(fr[..., k] * 16383), sr(fi[..., k] * 16383)
        fpnk_r, fpnk_i = sr(fr[..., 256 - k] * 16383), sr(-fi[..., 256 - k] * 16383)
        f1k_r, f1k_i = fpk_r + fpnk_r, fpk_i + fpnk_i
        f2k_r, f2k_i = fpk_r - fpnk_r, fpk_i - fpnk_i
        twr, twi = _t(self.stw_r, fr), _t(self.stw_i, fr)
        tw_r = sr(f2k_r * twr - f2k_i * twi)
        tw_i = sr(f2k_r * twi + f2k_i * twr)

        out_r = fr.new_zeros((*lead, 257))
        out_i = fr.new_zeros((*lead, 257))
        out_r[..., 0] = tdc_r + tdc_i
        out_r[..., 256] = tdc_r - tdc_i
        out_r[..., k] = (f1k_r + tw_r) >> 1
        out_i[..., k] = (f1k_i + tw_i) >> 1
        # bin 128 is written twice, as in the C loop: this write wins
        out_r[..., 256 - k] = (f1k_r - tw_r) >> 1
        out_i[..., 256 - k] = (tw_i - f1k_i) >> 1
        return out_r, out_i


class MicroFrontendTorch:
    """Batched micro frontend on one device.

    ``features(audio)``: (..., samples) float in [-1, 1] -> (..., F, C)
    float32 features on the reference 10/256 scale. The entry points
    (``features``, ``features_from_int16``, ``stream_features``) run on
    ``device`` whatever the input is (a numpy array, a tensor anywhere) and
    return tensors there; their eager twins (``features_eager``, ...) take
    numpy arrays to ``device`` and compute tensors where they lie.

    ``mode="exact"`` (the default) is bit-exact to the TFLite op.
    ``mode="fast"`` is the JAX package's fast mode (``ops/micro_fast.py``):
    a float rFFT prefix, features within a few grid steps of exact mode's.
    ``quantize`` rounds fast mode's features (exact mode's are integers).
    """

    def __init__(self, config: FrontendConfig = FrontendConfig(), device="cuda", mode: str = "exact",
                 quantize: bool = True):
        if mode not in ("exact", "fast"):
            raise ValueError(f"mode must be 'exact' or 'fast', got {mode!r}")
        self.device = resolve_device(device)
        self.config = config
        self.mode = mode
        self.quantize = quantize
        host = MicroFrontend(config)
        self.window_size = host.window_size
        self.window_step = host.window_step
        self.num_channels = config.num_channels
        # frames per clip of one second (the model's 49 rows)
        self.clip_frames = 1 + (config.sample_rate - host.window_size) // host.window_step
        self.smoothing_bits = config.smoothing_bits
        self.min_signal_remaining = host.min_signal_remaining
        self.enable_pcan = config.enable_pcan
        self.enable_log = config.enable_log
        self.snr_shift = host.snr_shift
        self.correction_bits = host.correction_bits
        self.scale_shift = config.scale_shift
        self.kiss = KissFftrTorch()

        ch = np.arange(config.num_channels)
        sm = np.where(ch % 2 == 0, host.even_smoothing, host.odd_smoothing).astype(np.int64)
        fb_idx, fb_wgt = mi.filterbank_tables(host.fb, config.num_channels)
        if config.enable_pcan:
            wdf_rows, lut012 = mi.wdf_tables(host.pcan_lut)
        else:  # unused placeholders keep the kernel's signature uniform
            wdf_rows, lut012 = np.zeros((32, 3), np.int64), np.zeros(3, np.int64)
        self._host_tables: Dict[str, np.ndarray] = {
            "window": host.window_coeffs.astype(np.int64),
            "tw_r": self.kiss.tw_r,
            "tw_i": self.kiss.tw_i,
            "stw_r": self.kiss.stw_r,
            "stw_i": self.kiss.stw_i,
            "fb_idx": fb_idx,
            "fb_wgt": fb_wgt,
            "sm": sm,
            "om": (1 << NOISE_REDUCTION_BITS) - sm,
            "wdf_rows": wdf_rows,
            "lut012": lut012,
            "log_lut": _LOG_LUT.astype(np.int64),
        }
        self._tables: Dict[Tuple[torch.device, torch.dtype], Dict[str, torch.Tensor]] = {}
        self._fast_host = micro_fast.fast_host_tables(host, config) if mode == "fast" else {}
        self._fast_tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        # entry point (and num_windows) -> its program, least recently used first
        self._programs = _ProgramCache()

    def tables(self, device, dtype=torch.int64) -> Dict[str, torch.Tensor]:
        """The frontend's integer tables as contiguous tensors on ``device``
        (int64 for the plain versions, int32 for the kernels), cached."""
        key = (torch.device(device), dtype)
        if key not in self._tables:
            self._tables[key] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device=device, dtype=dtype)
                for k, v in self._host_tables.items()
            }
        return self._tables[key]

    def fast_tables(self, device) -> Dict[str, torch.Tensor]:
        """Fast mode's float32 tables on ``device``, cached."""
        key = torch.device(device)
        if key not in self._fast_tables:
            self._fast_tables[key] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in self._fast_host.items()
            }
        return self._fast_tables[key]

    def _as_tensor(self, audio) -> torch.Tensor:
        if isinstance(audio, torch.Tensor):
            return audio
        return torch.from_numpy(np.ascontiguousarray(audio)).to(self.device)

    def num_frames(self, num_samples: int) -> int:
        if num_samples < self.window_size:
            return 0
        return 1 + (num_samples - self.window_size) // self.window_step

    # -- stages ----------------------------------------------------------------

    def base_frames(self, audio_int16) -> torch.Tensor:
        """(..., samples) int16 -> (..., F, C) int32 sqrt-filterbank
        signal (uint32 values, all below 2^26); float32 in fast mode."""
        audio = self._as_tensor(audio_int16)
        if self.mode == "fast":
            return micro_fast.base_frames_fast(audio, self)
        lead, t = audio.shape[:-1], audio.shape[-1]
        base = cuda_fft.stream_prefix(audio.reshape(-1, t), self)
        return base.reshape(*lead, *base.shape[-2:])

    def nr_pcan_log_int(self, signal) -> torch.Tensor:
        """(..., F, C) sqrt-filterbank signal -> (..., F, C) int32 integer
        features (uint16 range), noise state restarting per leading index."""
        signal = self._as_tensor(signal)
        lead, (f, c) = signal.shape[:-2], signal.shape[-2:]
        n = int(np.prod(lead))
        raw = cuda_frontend.stream_suffix(signal.reshape(n * f, c), n, f, f, self, scaled=False)
        return raw.reshape(signal.shape)

    def nr_pcan_log(self, signal) -> torch.Tensor:
        """Fast mode's suffix: (..., F, C) float32 sqrt-filterbank signal ->
        (..., F, C) integer-valued float32 features, noise state restarting
        per leading index. The recurrence is ``cuda_fast.noise_scan_f32``."""
        signal = self._as_tensor(signal).to(torch.float32)
        lead, (f, c) = signal.shape[:-2], signal.shape[-2:]
        n = int(np.prod(lead))
        rows = signal.reshape(n * f, c).contiguous()
        est = cuda_fast.noise_scan_f32(rows, n, f, f, self)
        raw = micro_fast.nr_pcan_log_fast(rows.view(n, f, c), est, self)
        return raw.reshape(signal.shape)

    # -- public entry points ---------------------------------------------------

    def program(self, entry: str, num_windows: Optional[int] = None) -> ProgramGraphs:
        """The program of an entry point on the frontend's device, cached on
        the frontend: "features", "features_from_int16", or
        "stream_features" at ``num_windows`` (a program a window count, of
        which the ``MAX_SHAPES`` used last are kept). Its ``fn`` is the
        entry point's eager twin."""
        key = entry if entry != "stream_features" else (entry, int(num_windows))
        prog = self._programs.pop(key, None)
        if prog is None:
            ref = weakref.ref(self)  # the frontend owns its programs
            if entry == "features":
                fn = lambda x: ref().features_eager(x)  # noqa: E731
            elif entry == "features_from_int16":
                fn = lambda x: ref().features_from_int16_eager(x)  # noqa: E731
            elif entry == "stream_features":
                fn = lambda x, n=key[1]: ref().stream_features_eager(x, n)  # noqa: E731
            else:
                raise ValueError(f"no entry point {entry!r}")
            prog = ProgramGraphs(fn, device=self.device)
        self._programs[key] = prog  # the most recently used last
        counts = [k for k in self._programs if isinstance(k, tuple)]
        for old in counts[: max(0, len(counts) - MAX_SHAPES)]:
            del self._programs[old]
        return prog

    def features_from_int16(self, audio_int16) -> torch.Tensor:
        """(..., samples) int16, or a wider integer type holding int16
        values, -> (..., F, C) float32, 10/256 scale, through the
        program (``features_from_int16_eager`` inside another program)."""
        if inside_program():
            return self.features_from_int16_eager(audio_int16)
        return self.program("features_from_int16")(self._as_int16(_host_or_tensor(audio_int16)))

    def features(self, audio_float) -> torch.Tensor:
        """(..., samples) float waveform in [-1, 1] -> (..., F, C) features,
        through the program (``features_eager`` inside another program)."""
        if inside_program():
            return self.features_eager(audio_float)
        return self.program("features")(_host_or_tensor(audio_float))

    def stream_features(self, audio_int16, num_windows: int) -> torch.Tensor:
        """Long audio (samples,) -> (num_windows, F, C) per-window features,
        through the program of ``num_windows`` (``stream_features_eager``
        inside another program)."""
        if inside_program():
            return self.stream_features_eager(audio_int16, num_windows)
        return self.program("stream_features", num_windows)(_host_or_tensor(audio_int16))

    # -- eager twins ---------------------------------------------------------------

    def features_from_int16_eager(self, audio_int16) -> torch.Tensor:
        """``features_from_int16``, eagerly.

        Clip-scale audio (``cuda_clip.fits``) takes the fused
        ``clip_features`` kernel; longer audio the prefix and the suffix, as
        the JAX package gates its fused Pallas kernel. Both give ``==``
        features."""
        audio = self._as_int16(self._as_tensor(audio_int16))
        if self.mode == "fast":  # never the fused kernel: it is exact mode's
            return self.nr_pcan_log(self.base_frames(audio)) * cuda_frontend.FEATURE_SCALE
        lead, t = audio.shape[:-1], audio.shape[-1]
        nf = self.num_frames(t)
        if cuda_clip.fits(nf, self.num_channels):
            feats = cuda_clip.clip_features(audio.reshape(-1, t), self, scaled=True)
            return feats.reshape(*lead, nf, self.num_channels)
        base = self.base_frames(audio)
        f, c = base.shape[-2:]
        n = int(np.prod(lead))
        feats = cuda_frontend.stream_suffix(base.reshape(n * f, c), n, f, f, self, scaled=True)
        return feats.reshape(*lead, f, c)

    @staticmethod
    def _as_int16(audio: torch.Tensor) -> torch.Tensor:
        """int16 audio as it is; other integer audio cast to int16 after a
        check that every value lies in the int16 range (raises otherwise:
        values are never wrapped)."""
        if audio.dtype == torch.int16:
            return audio.contiguous()
        if audio.dtype.is_floating_point or audio.dtype.is_complex or audio.dtype == torch.bool:
            raise TypeError(f"features_from_int16 takes integer audio, got {audio.dtype}")
        if audio.numel() and (int(audio.min()) < -32768 or int(audio.max()) > 32767):
            raise ValueError("features_from_int16: audio values outside the int16 range")
        return audio.to(torch.int16).contiguous()

    def features_eager(self, audio_float) -> torch.Tensor:
        """``features``, eagerly: the saturating float->int16 cast of
        to_micro_spectrogram, then the frontend, scaled by 10/256."""
        x = self._as_tensor(audio_float)
        i16 = torch.clamp(torch.trunc(x.to(torch.float32) * 32768.0), -32768.0, 32767.0)
        return self.features_from_int16_eager(i16.to(torch.int16))

    def stream_features_eager(self, audio_int16, num_windows: int) -> torch.Tensor:
        """``stream_features``, eagerly.

        The prefix runs once per hop over the whole stream; window w is rows
        w..w+F-1 of it with the noise state restarting at row w, like the
        reference's independent per-window to_micro_spectrogram calls."""
        base = self.base_frames(audio_int16)  # (T, C)
        if self.mode == "fast":
            f = self.clip_frames
            est = cuda_fast.noise_scan_f32(base, num_windows, 1, f, self)
            raw = micro_fast.nr_pcan_log_fast(micro_fast.windows_view(base, num_windows, 1, f), est, self)
            return raw * cuda_frontend.FEATURE_SCALE
        return cuda_frontend.stream_suffix(
            base, num_windows, 1, self.clip_frames, self, scaled=True
        )


def _host_or_tensor(audio) -> torch.Tensor:
    """A tensor as it is; an array as a host tensor (the program uploads
    it into its static input)."""
    if isinstance(audio, torch.Tensor):
        return audio
    return torch.from_numpy(np.ascontiguousarray(audio))


@functools.lru_cache(maxsize=8)
def cached_stream_frontend(sample_rate: int = 16000, device: str = "cuda") -> MicroFrontendTorch:
    """Process-cached frontend, so its device tables upload once."""
    return MicroFrontendTorch(FrontendConfig(sample_rate=sample_rate), device=device)
