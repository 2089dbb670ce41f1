"""Builds ``tts_mel80_gl32`` in the port: Tacotron 2's LJSpeech mel-80
analysis as a ``MelDbPlan`` on the f32 kernel (``precision=HIGH``), then
``tg.invert_mel_db``'s fast Griffin-Lim at its defaults back to a waveform
of the input's length."""

import spectrograms_tpu_torch as tg


class System:
    """The entry the window drives: ``plan.compute_batch`` then
    ``tg.invert_mel_db`` of its mel-dB."""

    def __init__(self, cfg: dict, device):
        self.sr, self.n_fft, self.hop = float(cfg["sr"]), int(cfg["n_fft"]), int(cfg["hop"])
        self.mel = tg.MelParams(int(cfg["n_mels"]), float(cfg["f_min"]), float(cfg["f_max"]),
                                tg.MelNorm.SLANEY)
        self.plan = tg.MelDbPlan(
            tg.SpectrogramParams(tg.StftParams(self.n_fft, self.hop), self.sr),
            self.mel,
            tg.LogParams(float(cfg["floor_db"])),
            dtype=cfg["dtype"],
            precision=tg.Precision[cfg["precision"]],
            device=device,
        )
        self.n_iter = int(cfg["n_iter"])

    def __call__(self, x):
        mel_db = self.plan.compute_batch(x)
        audio = tg.invert_mel_db(mel_db, self.mel, self.sr, self.n_fft, self.hop,
                                 n_iter=self.n_iter, length=x.shape[-1], device=x.device)
        return {"mel_db": mel_db, "audio": audio}


def build(cfg: dict, traffic: dict, device) -> System:
    return System(cfg, device)
