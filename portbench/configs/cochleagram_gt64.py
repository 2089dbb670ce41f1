"""Builds ``cochleagram_gt64`` in the port: the 64-band gammatone cochleagram
of a batch of clips through ``tg.gammatone_iir_spectrogram(...,
batched=True)``, the float64 IIR bank with the dB cast to float32."""

import spectrograms_tpu_torch as tg


class System:
    """The entry the window drives: one batched call of the gammatone bank."""

    def __init__(self, cfg: dict, device):
        self.sr = float(cfg["sr"])
        self.frame, self.hop = int(cfg["frame_size"]), int(cfg["hop_size"])
        self.erb = tg.ErbParams(int(cfg["n_bands"]), float(cfg["f_min"]), float(cfg["f_max"]),
                                tg.ErbSpacing(cfg["spacing"]), db_floor=float(cfg["db_floor"]))
        self.dtype, self.method = cfg["dtype"], cfg["method"]

    def __call__(self, x):
        out, _ = tg.gammatone_iir_spectrogram(x, self.sr, self.frame, self.hop, self.erb,
                                              dtype=self.dtype, method=self.method,
                                              device=x.device, batched=True)
        return {"cochleagram": out}


def build(cfg: dict, traffic: dict, device) -> System:
    return System(cfg, device)
