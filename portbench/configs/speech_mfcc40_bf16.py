"""Builds ``speech_mfcc40_bf16`` in the port: ``speech_mfcc40``'s entry with
the flagship ``MfccPlan`` at ``Precision.DEFAULT``. The plan's default method
resolves to ``pallas`` on CUDA, the 1-pass bf16 tier kernel
(``csrc/fused_tier_features.cu``); ``tg.delta`` runs on its float32 output."""

from pathlib import Path

import spectrograms_tpu_torch as tg

from harness.manifest import load_module

_base = load_module(Path(__file__).with_name("speech_mfcc40.py"), "config")


class System(_base.System):
    """``plan.compute_batch`` at ``Precision.DEFAULT``, then ``tg.delta``."""

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
            precision=tg.Precision[cfg["precision"]],
            device=device,
        )
        self.width, self.order = int(cfg["delta_width"]), int(cfg["delta_order"])


def build(cfg: dict, traffic: dict, device) -> System:
    return System(cfg, device)
