"""FFT-domain namespace (``spectrograms::fft``): direct 1-D/2-D FFT access,
as in the JAX package's ``fft`` module.

Importing this submodule rebinds the package attribute
``spectrograms_tpu_torch.fft`` from the one-shot function to this module
(the import machinery always sets a loaded submodule on its package). The
module is therefore callable, so ``tg.fft(samples, n_fft)`` works whichever
was imported first.
"""

import sys as _sys
import types as _types

from .convolution import OverlapSaveConvolver, fft_convolve, fft_deconvolve  # noqa: F401
from .fft2d import (  # noqa: F401
    Fft2dPlanner,
    fft2d,
    fftfreq,
    fftshift,
    fftshift_1d,
    ifft2d,
    ifftshift,
    ifftshift_1d,
    magnitude_spectrum_2d,
    power_spectrum_2d,
    rfftfreq,
)
from .min_phase import minimum_phase, minimum_phase_with  # noqa: F401
from .ops.stft import (  # noqa: F401
    fft,
    irfft,
    istft,
    magnitude_spectrum,
    power_spectrum,
    rfft,
    stft,
)


class _CallableFftModule(_types.ModuleType):
    __call__ = staticmethod(fft)


_sys.modules[__name__].__class__ = _CallableFftModule
