"""Builds ``speech_mfcc40`` in the port: the flagship ``MfccPlan`` (as in
``__graft_entry__.py:16-50``) and ``tg.delta`` of its coefficients."""

import spectrograms_tpu_torch as tg


class System:
    """The entry the window drives: ``plan.compute_batch`` then ``tg.delta``."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.plan = tg.MfccPlan(
            tg.StftParams(int(cfg["n_fft"]), int(cfg["hop"])),
            float(cfg["sr"]),
            mel_params=tg.MelParams(int(cfg["n_mels"]), float(cfg["f_min"]),
                                    float(cfg["f_max"]), tg.MelNorm.SLANEY),
            mfcc_params=tg.MfccParams(int(cfg["n_mfcc"]), include_c0=bool(cfg["include_c0"]),
                                      lifter=int(cfg["lifter"])),
            log_params=tg.LogParams(float(cfg["floor_db"])),
            dtype=cfg["dtype"],
            device=device,
        )
        self.width, self.order = int(cfg["delta_width"]), int(cfg["delta_order"])

    def __call__(self, x):
        return self.post(self.plan.compute_batch(x))

    def post(self, mfcc):
        return {"mfcc": mfcc, "delta": tg.delta(mfcc, self.width, self.order)}

    def pipeline(self, traffic: dict):
        return tg.FeaturePipeline(self.plan, batch_size=int(traffic["batch_size"]),
                                  target_seconds=float(traffic["target_seconds"]),
                                  transport=traffic["transport"])


def build(cfg: dict, traffic: dict, device) -> System:
    return System(cfg, device)
