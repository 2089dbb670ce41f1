"""Plan-cache introspection (``fft_plan_cache_info``/``clear_fft_plan_cache``,
python/mod.rs:203-233, and ``cache_stats``, fft_backend.rs:1071).

Counterpart of ``spectrograms_tpu.cache``. The port's plan cache is its
``functools.lru_cache``'d host builders: the one-shots' plans, filterbanks,
DFT matrices, the iSTFT's window-energy normalizer, the MFCC DCT and the
decimation filters, the CQT kernels and multirate groups, the gammatone IIR
bank, the MDCT bases and the image filters' masks (host and device copies). ``fft_plan_cache_info`` reports each one's counters
and, when a card is present, the CUDA memory PyTorch has allocated under the
label ``device.cuda_memory_allocated`` (bytes; the JAX package reports its
live arrays there), and the autotune wisdom's size under ``autotune.wisdom``.
``clear_fft_plan_cache`` empties every host cache (not the wisdom).
"""

from __future__ import annotations

import sys
from typing import Dict

import torch

__all__ = ["fft_plan_cache_info", "clear_fft_plan_cache", "cache_stats"]

# label → module (under this package) whose cached builders it reports. The
# package imports every one of them; they are looked up in ``sys.modules``
# because the package rebinds some module names (``mfcc``, ``mdct``) to
# functions.
_CACHE_MODULES = {
    "functions": "functions",
    "filterbanks": "ops.filterbanks",
    "cqt_kernels": "ops.cqt",
    "dft_matrices": "ops.dft",
    "ola_norm": "ops.stft",
    "erb": "erb",
    "mfcc_dct": "mfcc",
    "image_kernels": "image_ops",
    "mdct": "mdct",
    "decimate": "ops.decimate",
}


def _host_caches():
    """name → lru-cached callable defined in one of ``_CACHE_MODULES``."""
    out = {}
    for label, name in _CACHE_MODULES.items():
        mod = sys.modules[f"{__package__}.{name}"]
        for attr in vars(mod).values():
            if (callable(attr) and hasattr(attr, "cache_info") and hasattr(attr, "cache_clear")
                    and getattr(attr, "__module__", None) == mod.__name__):
                out[f"{label}.{attr.__name__.lstrip('_')}"] = attr
    return out


def fft_plan_cache_info() -> Dict[str, Dict[str, int]]:
    """Per-cache ``{hits, misses, currsize, maxsize}``, the CUDA memory
    allocated when a card is present, and the wisdom's size."""
    info: Dict[str, Dict[str, int]] = {}
    for name, fn in _host_caches().items():
        ci = fn.cache_info()
        info[name] = {
            "hits": ci.hits,
            "misses": ci.misses,
            "currsize": ci.currsize,
            "maxsize": ci.maxsize if ci.maxsize is not None else -1,
        }
    if torch.cuda.is_available():
        info["device.cuda_memory_allocated"] = {
            "hits": -1,
            "misses": -1,
            "currsize": torch.cuda.memory_allocated(),
            "maxsize": -1,
        }
    from .autotune import wisdom

    info["autotune.wisdom"] = {
        "hits": -1,  # decisions taken without measuring are marked on AutotuneResult
        "misses": -1,
        "currsize": len(wisdom()),
        "maxsize": -1,
    }
    return info


def cache_stats() -> Dict[str, Dict[str, int]]:
    """Alias for :func:`fft_plan_cache_info`."""
    return fft_plan_cache_info()


def clear_fft_plan_cache() -> None:
    """Clear every host constant cache, the one-shots' plans included."""
    for fn in _host_caches().values():
        fn.cache_clear()
