"""Builds ``music_cqt84`` in the port: config 4's ``FeatureSet`` of a CQT-84
power plan, the multirate chroma plan and the batched MDCT/IMDCT round trip
(as ``chip_smoke.py::config4_set`` builds it: the public ``mdct``/``imdct``
take one signal each, so the member calls the module's batched forms)."""

import spectrograms_tpu_torch as tg
from spectrograms_tpu_torch.mdct import _consts_for, _imdct_impl, _mdct_impl


class System:
    """The entry the window drives: ``FeatureSet.compute_batch``."""

    def __init__(self, cfg: dict, device):
        sr = float(cfg["sr"])
        params = tg.SpectrogramParams(tg.StftParams(int(cfg["n_fft"]), int(cfg["hop"])), sr)
        cqt_p = tg.CqtParams(int(cfg["bins_per_octave"]), int(cfg["n_octaves"]),
                             float(cfg["f_min"]))
        cq = tg.CqtPowerPlan(params, cqt_p, dtype=cfg["dtype"], device=device)
        ch = tg.ChromaPlan(params.stft, sr, tg.ChromaParams.music_standard().with_multirate(),
                           dtype=cfg["dtype"], device=device)
        mp = tg.MdctParams.sine_window(int(cfg["mdct_window"]))
        two_n, hop = mp.window_size, mp.hop_size

        def mdct_rt(b):
            fwd, inv = _consts_for(mp, False, b.dtype, b.device)
            c = _mdct_impl(b, fwd, two_n, hop)
            return _imdct_impl(c.transpose(-1, -2), inv, two_n, hop)[..., : b.shape[-1]]

        self.set = tg.FeatureSet([cq, ch, mdct_rt])

    def __call__(self, x):
        cqt, chroma, rt = self.set.compute_batch(x)
        return {"cqt": cqt, "chroma": chroma, "mdct_rt": rt}


def build(cfg: dict, traffic: dict, device) -> System:
    return System(cfg, device)
