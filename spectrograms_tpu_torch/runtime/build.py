"""``python -m spectrograms_tpu_torch.runtime.build`` — compile the native library."""

from .native import build_library

if __name__ == "__main__":
    path = build_library(force=True)
    print(f"built {path}")
