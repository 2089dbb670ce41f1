"""Image-domain namespace (``spectrograms::image``): the FFT image filters
of ``image_ops``, as in the JAX package's ``image`` module."""

from .image_ops import (  # noqa: F401
    bandpass_filter,
    convolve_fft,
    detect_edges_fft,
    gaussian_kernel_2d,
    highpass_filter,
    lowpass_filter,
    sharpen_fft,
)
