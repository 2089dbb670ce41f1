"""Signal reconstruction: Griffin-Lim phase recovery and mel inversion.

Counterpart of ``spectrograms_tpu.reconstruct``: Griffin-Lim with the
momentum of Perraudin et al., "A fast Griffin-Lim algorithm" (WASPAA 2013),
and mel inversion through the non-negative pseudo-inverse of the filterbank,
so that ``mel_db → audio`` works end to end.

The iteration is a Python loop of torch ops on the device: nothing in it
reads a value back to the host. Like the JAX package it takes one of two
routes: at float32 and ``n_fft ≤ MATMUL_MAX_N_FFT`` the analysis and
synthesis transforms are matmuls against the (i)rDFT matrices of
``ops/dft.py``, the spectrum carried as [re | im]; at float64 or larger
sizes they are ``torch.fft.rfft``/``irfft``. The initial phase is uniform
in [-π, π), drawn on the host from a fixed seed (so a CUDA run and a CPU run
start alike, as the JAX package's fixed key does), or given as
``init_angles``.

On a float32 CUDA magnitude that does not require grad (nor does
``init_angles``), with ``n_fft`` a power of two from 64 to 4096 and ``hop =
n_fft/k``, k a power of two up to 16, each iteration is one launch of
``csrc/griffin_lim.cu``: the windowed rfft of every frame of the last
signal, the momentum step, the projection onto the magnitude, the irfft, the
window and the normalised overlap-add, with the spectrum never leaving the
chip's registers and shared memory; one more launch turns the magnitude and
the initial phase into the first signal. ``griffin_lim_kernel_twin``
computes that factorization in torch ops. Every other call (CPU tensors,
float64, other sizes and hops, inputs that require grad) takes the routes
above, unchanged.

Spans ``tg.op.reconstruct.griffin_lim`` (set-up, the iteration loop and the
last synthesis) and ``tg.op.reconstruct.mel_to_linear``. Counters, summed
over calls: ``gl_iterations`` the iterations run, on every route;
``gl_kernel_calls``, ``gl_matmul_calls`` and ``gl_fft_calls`` the calls by
route; ``launches`` the kernel's launches (``ops/_build.py::Source.launch``
adds to it).
"""

from __future__ import annotations

import math
import sys
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from .dtypes import check_true_f32, resolve_device, result_data
from .errors import InvalidInputError
from .ops._build import SOURCES
from .ops.dft import MATMUL_MAX_N_FFT, irdft_matrices, rdft_matrices
from .ops.filterbanks import mel_filterbank
from .ops.framing import frame_signal, framed_matmul
from .ops.ola import overlap_add
from .params import MelParams, r2c_output_size
from .spans import span
from .windows import WindowType, make_window

__all__ = ["griffin_lim", "mel_to_linear", "mel_filterbank_pinv", "invert_mel_db"]

gl_iterations = 0    # Griffin-Lim iterations run, on every route
gl_kernel_calls = 0  # griffin_lim calls that took csrc/griffin_lim.cu
gl_matmul_calls = 0  # griffin_lim calls that took the matmul route
gl_fft_calls = 0     # griffin_lim calls that took the fft route
launches = 0         # csrc/griffin_lim.cu launches, counted as each returns
SOURCES["griffin_lim"].counter = sys.modules[__name__]

KERNEL_N_FFT = (64, 4096)   # the kernel's n_fft: a power of two in this range
KERNEL_MAX_OVERLAP = 16     # the kernel's largest k = n_fft / hop, a power of two
KERNEL_RUN = 37             # the twin's run of segments a team takes (the kernel sizes its own)
_START, _ITERATE, _LAST = 0, 1, 2   # the kernel's modes


def _initial_angles(init_angles, shape, dtype, device) -> torch.Tensor:
    """(..., n_frames, n_bins) initial phase from ``init_angles`` (laid out
    like the magnitude, (…, n_bins, n_frames)) or drawn from seed 0."""
    if init_angles is None:
        gen = torch.Generator().manual_seed(0)
        angles = torch.rand(shape[-2:], generator=gen, dtype=torch.float64) * (2 * np.pi) - np.pi
    else:
        if not isinstance(init_angles, torch.Tensor):
            init_angles = torch.from_numpy(np.array(init_angles, dtype=np.float64))
        angles = init_angles.to(torch.float64).transpose(-1, -2)
        if angles.shape[-2:] != shape[-2:]:
            raise InvalidInputError(
                f"init_angles must be laid out like the magnitude (n_bins, n_frames) = "
                f"{tuple(reversed(shape[-2:]))}, got {tuple(angles.shape)}"
            )
    return angles.to(dtype).to(device)


def griffin_lim(
    magnitude,
    n_fft: int,
    hop_size: int,
    window: WindowType = WindowType.HANNING,
    centre: bool = True,
    n_iter: int = 32,
    momentum: float = 0.99,
    length: Optional[int] = None,
    *,
    init_angles=None,
    device=None,
) -> torch.Tensor:
    """Reconstruct a waveform from an STFT magnitude (n_bins, n_frames).

    A (B, n_bins, n_frames) batch runs as one batched iteration, each item
    from the same initial phase (the JAX package vmaps one key). ``momentum=0``
    gives classic Griffin-Lim; the default 0.99 is the fast variant.
    """
    mag = torch.as_tensor(result_data(magnitude), device=resolve_device(device))
    if mag.ndim not in (2, 3):
        raise InvalidInputError(f"magnitude must be 2-D or 3-D, got {tuple(mag.shape)}")
    expected = r2c_output_size(n_fft)
    if mag.shape[-2] != expected:
        raise InvalidInputError(
            f"magnitude has {mag.shape[-2]} bins, expected {expected} for n_fft={n_fft}"
        )
    if hop_size > n_fft:
        raise InvalidInputError("hop_size must be <= n_fft")
    if not (0.0 <= momentum < 1.0):
        raise InvalidInputError("momentum must be in [0, 1)")
    global gl_iterations, gl_kernel_calls, gl_matmul_calls, gl_fft_calls
    with span("tg.op.reconstruct.griffin_lim"):
        n_frames = mag.shape[-1]
        pad = n_fft // 2 if centre else 0
        full_len = (n_frames - 1) * hop_size + n_fft
        out_len = full_len - 2 * pad if length is None else int(length)
        out_len = max(1, min(out_len, full_len - pad))
        real_dt = torch.float64 if mag.dtype == torch.float64 else torch.float32
        dev = mag.device
        mag_t = mag.to(real_dt).transpose(-1, -2)  # (..., n_frames, n_bins)
        angles = _initial_angles(init_angles, mag_t.shape, real_dt, dev)
        w64 = make_window(window, n_fft, np.float64)
        if _kernel_admits(mag, init_angles, n_fft, hop_size):
            mag_k, angles_k, tables, lead = _kernel_inputs(mag_t, angles, w64, n_fft, hop_size)
            y = _kernel_run(mag_k, angles_k, tables, n_fft, hop_size, n_iter, momentum,
                            _kernel_step)
            gl_kernel_calls += 1
            gl_iterations += n_iter
            return y.reshape(*lead, y.shape[-1])[..., pad : pad + out_len]
        w = torch.tensor(w64, dtype=real_dt, device=dev)

        norm = overlap_add((w * w).expand(n_frames, n_fft), hop_size)
        safe_norm = torch.where(norm > 1e-10, norm, 1.0)

        def ola(frames):
            out = overlap_add(frames, hop_size)
            return torch.where(norm > 1e-10, out / safe_norm, out)

        if real_dt == torch.float32 and n_fft <= MATMUL_MAX_N_FFT:
            if dev.type == "cuda":
                check_true_f32()
            # Analysis [C | S] with the window folded in; synthesis [Ci; Si],
            # the window applied after. The spectrum rides as [re | im].
            cs_f = torch.cat(rdft_matrices(n_fft, w64, real_dt, dev), dim=1)
            cs_i = torch.cat(irdft_matrices(n_fft, real_dt, dev), dim=0)

            def istft(ri):
                return ola((ri @ cs_i) * w)

            ri = torch.cat([mag_t * torch.cos(angles), mag_t * torch.sin(angles)], dim=-1)
            prev = ri
            for _ in range(n_iter):
                cand = framed_matmul(istft(ri), cs_f, n_fft, hop_size, centre=False)
                acc = cand + momentum * (cand - prev)
                acc_re, acc_im = acc.chunk(2, dim=-1)
                a = torch.clamp_min(torch.sqrt(acc_re * acc_re + acc_im * acc_im), 1e-16)
                ri = torch.cat([mag_t * acc_re / a, mag_t * acc_im / a], dim=-1)
                prev = cand
            x = istft(ri)
            gl_matmul_calls += 1
        else:

            def istft(spec_t):
                return ola(torch.fft.irfft(spec_t, n=n_fft, dim=-1) * w)

            def stft(x):
                # x is the padded overlap-add signal, (n_frames-1)*hop + n_fft long
                return torch.fft.rfft(frame_signal(x, n_fft, hop_size, centre=False) * w, dim=-1)

            spec = mag_t * torch.exp(1j * angles)
            prev = spec
            for _ in range(n_iter):
                cand = stft(istft(spec))
                accel = cand + momentum * (cand - prev)
                spec, prev = mag_t * (accel / torch.clamp_min(accel.abs(), 1e-16)), cand
            x = istft(spec)
            gl_fft_calls += 1
        gl_iterations += n_iter
        return x[..., pad : pad + out_len]


def _kernel_admits(mag: torch.Tensor, init_angles, n_fft: int, hop: int) -> bool:
    """Whether ``csrc/griffin_lim.cu`` computes this call: a float32 CUDA
    magnitude that does not require grad (nor do the given initial angles),
    ``n_fft`` a power of two in ``KERNEL_N_FFT``, ``hop = n_fft/k`` with k
    up to ``KERNEL_MAX_OVERLAP``, rows of fewer than 2**31 samples."""
    n_frames = mag.shape[-1]
    return (mag.is_cuda and mag.dtype == torch.float32 and not mag.requires_grad
            and not (isinstance(init_angles, torch.Tensor) and init_angles.requires_grad)
            and KERNEL_N_FFT[0] <= n_fft <= KERNEL_N_FFT[1] and n_fft & (n_fft - 1) == 0
            and n_fft % hop == 0 and n_fft // hop <= KERNEL_MAX_OVERLAP and n_frames > 0
            and (n_frames - 1) * hop + n_fft < 2**31)


@lru_cache(maxsize=16)
def _kernel_tables_np(n_fft: int, hop: int, window_key, n_frames: int) -> np.ndarray:
    """``csrc/griffin_lim.cu``'s constants in float64 (M = n_fft/2): the
    window, the window over n_fft (the irfft's 1/N), the FFT's ``W_M^t =
    exp(−2πit/M)`` and the split's ``W_N^k = exp(−2πik/N)``, k = 0..M/2, as
    (re, im) pairs, two zeros, then a row's 1/norm: ``norm`` the squared
    window overlap-added over ``n_frames`` frames, 1 where it is ≤ 1e-10."""
    m, k = n_fft // 2, n_fft // hop
    w = np.asarray(window_key, dtype=np.float64)
    norm = np.zeros((n_frames + k - 1, hop))
    for j, chunk in enumerate((w * w).reshape(k, hop)):   # chunk j of frame f: segment f + j
        norm[j : j + n_frames] += chunk
    norm = norm.ravel()
    ok = norm > 1e-10
    inv_norm = np.where(ok, 1.0 / np.where(ok, norm, 1.0), 1.0)

    def pairs(z):
        return np.stack([z.real, z.imag], axis=-1).ravel()

    out = np.concatenate([w, w / n_fft, pairs(np.exp(-2j * np.pi * np.arange(m) / m)),
                          pairs(np.exp(-2j * np.pi * np.arange(m // 2 + 1) / n_fft)),
                          np.zeros(2), inv_norm])
    out.setflags(write=False)
    return out


@lru_cache(maxsize=16)
def _device_tables(n_fft: int, hop: int, window_key, n_frames: int,
                   device: torch.device) -> torch.Tensor:
    """``_kernel_tables_np`` rounded to float32 once, kept on ``device``."""
    return torch.tensor(_kernel_tables_np(n_fft, hop, window_key, n_frames),
                        dtype=torch.float32, device=device)


def _table_parts(tables: torch.Tensor, n_fft: int) -> tuple:
    """(window, window/N, a row's 1/norm) of the kernel's tables."""
    return tables[:n_fft], tables[n_fft : 2 * n_fft], tables[7 * n_fft // 2 + 4 :]


def _kernel_inputs(mag_t: torch.Tensor, angles: torch.Tensor, w64: np.ndarray, n_fft: int,
                   hop: int) -> tuple:
    """(magnitude (rows, n_frames, n_fft/2 + 4), initial phase (1 or rows,
    n_frames, n_fft/2 + 4), tables, the leading shape) as the kernel reads
    them, from ``griffin_lim``'s (..., n_frames, n_bins) views: each frame's
    bins then three zeros, so that every frame starts on 16 bytes."""
    n_frames, n_bins = mag_t.shape[-2:]
    # numpy's: torch.broadcast_shapes costs seconds at its first call in a process
    lead = np.broadcast_shapes(tuple(mag_t.shape[:-2]), tuple(angles.shape[:-2]))
    rows = math.prod(lead)

    def frames(t, n_rows):
        t = t.expand(*lead, n_frames, n_bins) if n_rows > 1 else t
        return torch.nn.functional.pad(t.reshape(n_rows, n_frames, n_bins), (0, 3))

    mag_k = frames(mag_t, rows)
    angles_k = frames(angles, 1 if math.prod(angles.shape[:-2]) == 1 else rows)
    tables = _device_tables(n_fft, hop, tuple(w64.tolist()), n_frames, mag_t.device)
    return mag_k, angles_k, tables, lead


def _kernel_run(mag_k, angles_k, tables, n_fft: int, hop: int, n_iter: int, momentum: float,
                step) -> torch.Tensor:
    """The fused iteration's host loop: ``step`` in start mode, then ``n_iter``
    times in iterate mode (the last without storing the spectrum), the
    spectrum (rows, n_frames, n_fft/2 + 2) complex, each frame's bins then one
    unused) and the signal ping-ponged between two buffers each, since a
    team's halo frames read what another team's frames replace. Returns the
    last (rows, (n_frames − 1)·hop + n_fft) signal."""
    rows, n_frames = mag_k.shape[:2]
    length = (n_frames - 1) * hop + n_fft
    n_iter = max(0, n_iter)     # as the chain's loop, a negative count runs none
    if rows == 0:
        return mag_k.new_zeros((0, length))
    prev = [mag_k.new_empty((rows, n_frames, n_fft // 2 + 2, 2))
            for _ in range(min(2, max(1, n_iter)))]
    y = [mag_k.new_empty((rows, length)) for _ in range(min(2, n_iter + 1))]
    step(_START, mag_k, angles_k, None, prev[0], None, y[0], tables, n_fft, hop, momentum)
    for i in range(n_iter):
        last = i == n_iter - 1
        step(_LAST if last else _ITERATE, mag_k, angles_k, prev[i % 2],
             None if last else prev[(i + 1) % 2], y[i % 2], y[(i + 1) % 2], tables, n_fft, hop,
             momentum)
    return y[n_iter % 2]


def _kernel_step(mode, mag_k, angles_k, prev_in, prev_out, y_in, y_out, tables, n_fft, hop,
                 momentum) -> None:
    """One launch of ``csrc/griffin_lim.cu`` on float32 CUDA tensors; the
    kernel derives its teams, runs and grid from n_fft, hop, rows and
    frames."""
    rows, n_frames, _ = mag_k.shape
    stride = 0 if angles_k.shape[0] == 1 else angles_k[0].numel()

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    SOURCES["griffin_lim"].launch(
        mag_k.device, mag_k.data_ptr(), angles_k.data_ptr(), stride, ptr(prev_in), ptr(prev_out),
        ptr(y_in), y_out.data_ptr(), tables.data_ptr(), rows, n_frames, int(n_fft), int(hop),
        float(momentum), mode)


def _twin_step(mode, mag_k, angles_k, prev_in, prev_out, y_in, y_out, tables, n_fft, hop,
               momentum, run: int = KERNEL_RUN) -> None:
    """What one launch computes, in torch ops, with the kernel's tiling: a
    run of ``run`` output segments (``hop`` samples) of a row takes the
    frames that start in it and the k − 1 before it (the halo); each frame
    the windowed rfft of the old signal, the momentum step against the
    stored spectrum, the projection onto the magnitude (start: the magnitude
    at the initial phase), the unnormalised irfft times window/N; the
    frames overlap-added in frame order and scaled by 1/norm; the owned
    frames' spectra stored."""
    rows, n_frames = mag_k.shape[:2]
    n_bins, k = n_fft // 2 + 1, n_fft // hop
    segs = n_frames + k - 1
    w, w_syn, inv_norm = _table_parts(tables, n_fft)
    for s0 in range(0, segs, run):
        s1 = min(s0 + run, segs)
        fa, fb = max(0, s0 - k + 1), min(s1, n_frames)
        m = mag_k[:, fa:fb, :n_bins]
        if mode == _START:
            a = angles_k[:, fa:fb, :n_bins]
            re, im = m * torch.cos(a), m * torch.sin(a)
            cand = torch.complex(re, im)
        else:
            frames = y_in[:, fa * hop : (fb + k - 1) * hop].unfold(-1, n_fft, hop) * w
            cand = torch.fft.rfft(frames, dim=-1)
            p = torch.view_as_complex(prev_in[:, fa:fb, :n_bins])
            re = cand.real + momentum * (cand.real - p.real)
            im = cand.imag + momentum * (cand.imag - p.imag)
            a = torch.clamp_min(torch.sqrt(re * re + im * im), 1e-16)
            re, im = m * re / a, m * im / a
        if prev_out is not None and fb > s0:
            prev_out[:, s0:fb, :n_bins] = torch.view_as_real(cand[:, s0 - fa :])
        im = im.clone()
        im[..., 0] = 0.0    # irfft reads the real parts of bins 0 and N/2 only
        im[..., -1] = 0.0
        fr = torch.fft.irfft(torch.complex(re, im), n=n_fft, dim=-1, norm="forward") * w_syn
        chunks = fr.reshape(rows, fb - fa, k, hop)
        acc = None
        for j in range(k - 1, -1, -1):   # segment s: frames s − k + 1 .. s, in that order
            part = torch.nn.functional.pad(chunks[:, :, j], (0, 0, j, k - 1 - j))
            acc = part if acc is None else acc + part
        y_out[:, s0 * hop : s1 * hop] = (acc[:, s0 - fa : s1 - fa].reshape(rows, -1)
                                         * inv_norm[s0 * hop : s1 * hop])


def griffin_lim_kernel_twin(mag_k: torch.Tensor, angles_k: torch.Tensor, tables: torch.Tensor,
                            n_fft: int, hop: int, n_iter: int, momentum: float,
                            run: int = KERNEL_RUN) -> torch.Tensor:
    """What ``csrc/griffin_lim.cu``'s 1 + ``n_iter`` launches compute, in
    torch ops and float32: ``_kernel_run`` over ``_twin_step`` (runs of
    ``run`` segments). Takes and returns what ``_kernel_inputs`` and
    ``_kernel_run`` do: (rows, (n_frames − 1)·hop + n_fft)."""
    return _kernel_run(mag_k, angles_k, tables, n_fft, hop, n_iter, momentum,
                       lambda *args: _twin_step(*args, run=run))


@lru_cache(maxsize=32)
def _pinv_np(mel_key, sr: float, n_fft: int):
    m = mel_filterbank(sr, n_fft, MelParams(*mel_key))  # (n_mels, n_bins)
    # Least-squares pseudo-inverse clamped non-negative (power domain):
    # better conditioned than the row-normalized transpose for overlapping
    # triangles.
    return np.maximum(np.linalg.pinv(m), 0.0)  # (n_bins, n_mels)


def mel_filterbank_pinv(mel_params: MelParams, sample_rate_hz: float, n_fft: int) -> np.ndarray:
    """Non-negative pseudo-inverse of the mel filterbank, (n_bins, n_mels), f64."""
    key = (mel_params.n_mels, mel_params.f_min, mel_params.f_max, mel_params.norm)
    return _pinv_np(key, float(sample_rate_hz), int(n_fft))


def mel_to_linear(mel_power, mel_params: MelParams, sample_rate_hz: float, n_fft: int,
                  device=None) -> torch.Tensor:
    """Mel power (n_mels, n_frames) → approximate linear power (n_bins, n_frames)."""
    m = torch.as_tensor(result_data(mel_power), device=resolve_device(device))
    if m.is_cuda and m.dtype == torch.float32:
        check_true_f32()
    with span("tg.op.reconstruct.mel_to_linear"):
        pinv = torch.tensor(mel_filterbank_pinv(mel_params, sample_rate_hz, n_fft),
                            dtype=m.dtype, device=m.device)
        return torch.clamp_min(pinv @ m, 0.0)


def invert_mel_db(
    mel_db,
    mel_params: MelParams,
    sample_rate_hz: float,
    n_fft: int,
    hop_size: int,
    window: WindowType = WindowType.HANNING,
    centre: bool = True,
    n_iter: int = 32,
    length: Optional[int] = None,
    device=None,
) -> torch.Tensor:
    """Mel-dB spectrogram → waveform (dB → power → linear power → Griffin-Lim)."""
    db = torch.as_tensor(result_data(mel_db), device=resolve_device(device))
    linear_power = mel_to_linear(torch.pow(10.0, db / 10.0), mel_params, sample_rate_hz, n_fft,
                                 device=db.device)
    return griffin_lim(torch.sqrt(linear_power), n_fft, hop_size, window, centre,
                       n_iter=n_iter, length=length, device=db.device)
