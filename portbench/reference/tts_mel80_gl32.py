"""Plain reference of ``tts_mel80_gl32``: a mel-80 dB analysis and its
inversion to a waveform by fast Griffin-Lim, in float64 with ``torch.fft``.

The framing, the symmetric Hann window and Slaney's mel filterbank are
``reference/speech_mfcc40.py``'s, loaded from that file; nothing here
imports the program. The definitions:

- mel-dB: centred frames (``n_fft // 2`` zeros each side), the window,
  ``|rfft|²``, Slaney mel-80 triangles with area normalisation, then
  ``10·log10(max(mel, 10^(floor_db/10)))``;
- inversion, as the library documents ``invert_mel_db``: mel power
  ``10^(dB/10)``; linear power ``max(P⁺·mel, 0)`` with ``P⁺`` the
  pseudo-inverse of the filterbank clamped non-negative; magnitude its
  square root;
- fast Griffin-Lim (Perraudin, Balazs and Søndergaard, WASPAA 2013) from the
  library's documented initial phase: uniform in [−π, π), torch's seed 0 on
  the host, a (frames, bins) float64 draw shared by every row. With
  ``c_prev = S₀``, each iteration takes ``c = STFT(ISTFT(S))``,
  ``t = c + α(c − c_prev)``, ``S = M·t/max(|t|, 1e-16)``, ``c_prev = c``;
  ISTFT is the irfft of each frame times the window, overlap-added and
  divided by the overlap-added squared window where that exceeds 1e-10;
  STFT the rfft of the windowed frames of that padded signal; the waveform
  is the padded signal from ``n_fft // 2`` on, ``length`` samples long.

Departures from the published algorithm, each the library's: the initial
phase is a fixed draw and not a data-dependent one; ``|t|`` is clamped at
1e-16 before the division; the first iteration's momentum term is taken
against the initial spectrum. Those from the Tacotron 2 settings are the
configuration's ``assumed``.

``outputs(..., tf32=True)`` is the control: the same in float32, every
product's operands rounded to TF32 (10 mantissa bits): the analysis DFT,
the filterbank, the pseudo-inverse, and the Griffin-Lim's STFT and ISTFT
as products against the (i)rDFT matrices, the program's route one
precision below.

``check`` compares three numbers (see its docstring). ``gl_task`` is the
frozen least work of one iteration, counted as an FFT-based iteration
whatever route the program takes.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from harness.judge import rel_err
from harness.manifest import load_module
from harness.precision import tf32_round

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_f64 = load_module(Path(__file__).with_name("speech_mfcc40.py"), "reference")
BLOCK = 8  # rows computed together: float64 state of 8 × 10 s clips is ~60 MB an array


def _sizes(cfg: dict) -> tuple:
    return int(cfg["n_fft"]), int(cfg["hop"])


def filterbank(cfg: dict) -> np.ndarray:
    """(n_mels, n_fft//2 + 1) Slaney triangles, float64."""
    return _f64.mel_filterbank(float(cfg["sr"]), int(cfg["n_fft"]), int(cfg["n_mels"]),
                               float(cfg["f_min"]), float(cfg["f_max"]))


def pinv(cfg: dict) -> np.ndarray:
    """(n_bins, n_mels) pseudo-inverse of the filterbank, clamped non-negative."""
    return np.maximum(np.linalg.pinv(filterbank(cfg)), 0.0)


def _blocks(n: int):
    return [(i, min(n, i + BLOCK)) for i in range(0, n, BLOCK)]


def mel_db(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, n) signal → (B, n_mels, frames) float64 mel-dB."""
    n_fft, hop = _sizes(cfg)
    dev = x.device
    win = torch.tensor(_f64.hann(n_fft), dtype=torch.float64, device=dev)
    fb = torch.tensor(filterbank(cfg), dtype=torch.float64, device=dev)
    floor = 10.0 ** (float(cfg["floor_db"]) / 10.0)
    out = []
    for a, b in _blocks(x.shape[0]):
        fr = _f64.frames_of(x[a:b].to(torch.float64), n_fft, hop) * win
        power = torch.fft.rfft(fr, dim=-1).abs().square()          # (rows, frames, bins)
        mel = torch.matmul(fb, power.transpose(-1, -2))            # (rows, n_mels, frames)
        out.append(10.0 * torch.log10(torch.clamp_min(mel, floor)))
    return torch.cat(out)


def target_magnitude(cfg: dict, db: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, frames) mel-dB → (B, frames, bins) float64 linear magnitude."""
    p = torch.tensor(pinv(cfg), dtype=torch.float64, device=db.device)
    power = torch.clamp_min(torch.matmul(p, torch.pow(10.0, db.to(torch.float64) / 10.0)), 0.0)
    return torch.sqrt(power).transpose(-1, -2)


def initial_phase(frames: int, bins: int, dtype, device) -> torch.Tensor:
    """(frames, bins) uniform in [−π, π) from torch's seed 0, drawn on the host."""
    gen = torch.Generator().manual_seed(0)
    ang = torch.rand((frames, bins), generator=gen, dtype=torch.float64) * (2 * np.pi) - np.pi
    return ang.to(dtype).to(device)


def _ola(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(rows, frames, n_fft) → (rows, (frames − 1)·hop + n_fft), overlap-added."""
    rows, n_frames, n_fft = frames.shape
    full = (n_frames - 1) * hop + n_fft
    return torch.nn.functional.fold(frames.transpose(1, 2), (1, full), (1, n_fft),
                                    stride=(1, hop)).reshape(rows, full)


class _Gl:
    """The Griffin-Lim's transforms at one size: float64 ``torch.fft``, or
    under ``tf32`` float32 products against TF32-rounded (i)rDFT matrices."""

    def __init__(self, cfg: dict, n_frames: int, dtype, device, tf32: bool):
        self.n_fft, self.hop = _sizes(cfg)
        self.tf32 = tf32
        w64 = _f64.hann(self.n_fft)
        self.w = torch.tensor(w64, dtype=dtype, device=device)
        norm = _ola((self.w * self.w).expand(1, n_frames, self.n_fft), self.hop)[0]
        self.ok = norm > 1e-10
        self.norm = torch.where(self.ok, norm, torch.ones_like(norm))
        if tf32:
            nb = self.n_fft // 2 + 1
            ang = 2.0 * np.pi * np.outer(np.arange(self.n_fft), np.arange(nb)) / self.n_fft
            c = np.full(nb, 2.0)
            c[0] = 1.0
            if self.n_fft % 2 == 0:
                c[-1] = 1.0
            fwd = np.concatenate([w64[:, None] * np.cos(ang), -w64[:, None] * np.sin(ang)], 1)
            inv = np.concatenate([(c[:, None] * np.cos(ang.T)), -(c[:, None] * np.sin(ang.T))],
                                 0) / self.n_fft
            self.fwd = tf32_round(torch.tensor(fwd, dtype=dtype, device=device))
            self.inv = tf32_round(torch.tensor(inv, dtype=dtype, device=device))

    def istft(self, s: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            fr = tf32_round(torch.cat([s.real, s.imag], dim=-1)) @ self.inv
        else:
            fr = torch.fft.irfft(s, n=self.n_fft, dim=-1)
        out = _ola(fr * self.w, self.hop)
        return torch.where(self.ok, out / self.norm, out)

    def stft(self, y: torch.Tensor) -> torch.Tensor:
        fr = y.unfold(-1, self.n_fft, self.hop)
        if self.tf32:
            ri = tf32_round(fr) @ self.fwd
            re, im = ri.chunk(2, dim=-1)
            return torch.complex(re, im)
        return torch.fft.rfft(fr * self.w, dim=-1)


def griffin_lim(cfg: dict, mag: torch.Tensor, length: int, n_iter: int = None,
                momentum: float = None, tf32: bool = False) -> torch.Tensor:
    """(B, frames, bins) magnitude → (B, length) waveform by fast Griffin-Lim,
    float64 (float32 products under ``tf32``), in blocks of rows."""
    n_iter = int(cfg["n_iter"]) if n_iter is None else int(n_iter)
    alpha = float(cfg["momentum"]) if momentum is None else float(momentum)
    dt = torch.float32 if tf32 else torch.float64
    n_fft, _ = _sizes(cfg)
    n_frames, bins = mag.shape[-2:]
    gl = _Gl(cfg, n_frames, dt, mag.device, tf32)
    phase0 = torch.polar(torch.ones((), dtype=dt, device=mag.device),
                         initial_phase(n_frames, bins, dt, mag.device))
    out = []
    for a, b in _blocks(mag.shape[0]):
        m = mag[a:b].to(dt)
        s = m * phase0
        prev = s
        for _ in range(n_iter):
            c = gl.stft(gl.istft(s))
            t = c + alpha * (c - prev)
            s = m * (t / torch.clamp_min(t.abs(), 1e-16))
            prev = c
        out.append(gl.istft(s)[:, n_fft // 2: n_fft // 2 + length])
    return torch.cat(out)


def spectral_convergence(cfg: dict, y: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """(B,) ‖|STFT(y)| − M‖ / ‖M‖ a row, float64: the STFT of the waveform as
    analysed (centred frames with zeros, the window)."""
    n_fft, hop = _sizes(cfg)
    win = torch.tensor(_f64.hann(n_fft), dtype=torch.float64, device=y.device)
    out = []
    for a, b in _blocks(y.shape[0]):
        fr = _f64.frames_of(y[a:b].to(torch.float64), n_fft, hop) * win
        got = torch.fft.rfft(fr, dim=-1).abs()
        m = mag[a:b].to(torch.float64)
        out.append(torch.linalg.vector_norm(got - m, dim=(-2, -1))
                   / torch.linalg.vector_norm(m, dim=(-2, -1)))
    return torch.cat(out)


def _control_mel_db(cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """``mel_db`` in float32 with TF32-rounded operands of every product."""
    n_fft, hop = _sizes(cfg)
    dt, dev = torch.float32, x.device
    ang = 2.0 * np.pi * np.outer(np.arange(n_fft), np.arange(n_fft // 2 + 1)) / n_fft
    win = _f64.hann(n_fft)[:, None]
    cos_b = tf32_round(torch.tensor(win * np.cos(ang), dtype=dt, device=dev))
    sin_b = tf32_round(torch.tensor(win * np.sin(ang), dtype=dt, device=dev))
    fb_t = tf32_round(torch.tensor(filterbank(cfg).T, dtype=dt, device=dev))
    floor = 10.0 ** (float(cfg["floor_db"]) / 10.0)
    out = []
    for a, b in _blocks(x.shape[0]):
        fr = tf32_round(_f64.frames_of(x[a:b].to(dt), n_fft, hop))
        re, im = fr @ cos_b, fr @ sin_b
        mel = tf32_round(re * re + im * im) @ fb_t
        out.append(10.0 * torch.log10(torch.clamp_min(mel, floor)).transpose(-1, -2))
    return torch.cat(out)


def _control_magnitude(cfg: dict, db: torch.Tensor) -> torch.Tensor:
    p = tf32_round(torch.tensor(pinv(cfg), dtype=torch.float32, device=db.device))
    power = torch.pow(10.0, db.to(torch.float32) / 10.0)
    return torch.sqrt(torch.clamp_min(p @ tf32_round(power), 0.0)).transpose(-1, -2)


def outputs(cfg: dict, x: torch.Tensor, tf32: bool = False) -> dict:
    """{"mel_db", "audio"} of the (B, n) signal ``x``: float64, or under
    ``tf32`` the control."""
    if tf32:
        db = _control_mel_db(cfg, x)
        return {"mel_db": db, "audio": griffin_lim(cfg, _control_magnitude(cfg, db),
                                                   x.shape[-1], tf32=True)}
    db = mel_db(cfg, x)
    return {"mel_db": db, "audio": griffin_lim(cfg, target_magnitude(cfg, db), x.shape[-1])}


def _median(v: torch.Tensor) -> float:
    return float(torch.quantile(v.to(torch.float64), 0.5))


def check(cfg: dict, traffic: dict, x: torch.Tensor, out: dict) -> dict:
    """The numbers compared for one answer:

    - ``mel_err``: the program's mel-dB against the float64 mel-dB of ``x``,
      per band on its own scale;
    - ``sc_self_err``: over the clips of the batch, the median of
      |SC(program's audio) − SC(reference's audio)| / SC(reference's audio),
      where the reference's Griffin-Lim starts from the program's own mel-dB
      cast to float64 and both SCs are taken against that mel's float64
      target magnitude, so that the analysis' error stays out of it;
    - ``wave_err``: over the clips, the median of max|program − reference| /
      max|reference| of a clip's waveform against that reference waveform.

    Medians over the clips, because the iteration at momentum 0.99 is
    chaotic: float32 rounding sends a few clips of a batch onto trajectories
    of their own, whose worst clip then reads up to ~0.4 of its largest
    sample and ~2e-3 in SC against float64, as a TF32 control does, while
    the typical clip reads ~1e-2 and ~3e-6. A fault that moves every clip (a
    lower precision, an iteration missing, the momentum, the sign, the hop,
    the length) moves the medians; one confined to a few clips' waveforms
    does not (the mel-dB is held on every clip).
    """
    db = out["mel_db"].to(torch.float64)
    nums = {"mel_err": rel_err(db, mel_db(cfg, x), axis=1)}
    mag = target_magnitude(cfg, db)
    ref = griffin_lim(cfg, mag, x.shape[-1])
    audio = out["audio"]
    if audio.shape != ref.shape:
        return dict(nums, sc_self_err=math.nan, wave_err=math.nan)
    sc_ref = spectral_convergence(cfg, ref, mag)
    sc_prog = spectral_convergence(cfg, audio, mag)
    nums["sc_self_err"] = _median((sc_prog - sc_ref).abs() / sc_ref)
    clip_err = ((audio.to(torch.float64) - ref).abs().amax(dim=-1)
                / ref.abs().amax(dim=-1).clamp_min(torch.finfo(torch.float64).tiny))
    nums["wave_err"] = _median(clip_err)
    return nums


def gl_task(cfg: dict, traffic: dict) -> tuple:
    """(operations, bytes) of one Griffin-Lim iteration over one batch, the
    least an FFT-based iteration needs, whatever route the program takes.

    Operations a frame: the irfft and the rfft at 2.5·n·log2(n) each; the
    synthesis window and the overlap-add at n each, the normalisation at
    hop, the analysis window at n; a bin: the momentum at 6 (two real
    subtractions, scalings and additions), the modulus at 4 (two squares, a
    sum, a root) and the projection at 4 (two divisions, two scalings).
    Bytes, float32: the magnitude read once; the spectrum and the previous
    spectrum (complex, 8 a bin) each read and written once; the overlap-added
    signal written once and read once."""
    n_fft, hop = _sizes(cfg)
    rows = int(traffic["clips"])
    n = int(round(traffic["clip_s"] * traffic["sr"]))
    n_frames = _f64.n_frames(n, n_fft, hop)
    frames = rows * n_frames
    bins = n_fft // 2 + 1
    per_frame = 2 * 2.5 * n_fft * math.log2(n_fft) + 3 * n_fft + hop + 14 * bins
    signal = rows * ((n_frames - 1) * hop + n_fft)
    nbytes = 4 * frames * bins + 2 * 2 * 8 * frames * bins + 2 * 4 * signal
    return per_frame * frames, nbytes
