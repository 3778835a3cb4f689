"""DES arrival-block kernel (CUDA); see ``csrc/arrival.cu``."""

from .ops import arrival_block  # noqa: F401
