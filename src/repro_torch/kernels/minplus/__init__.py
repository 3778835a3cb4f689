"""Min-plus DP transition kernels (CUDA): dense ``csrc/minplus.cu`` and
structured ``csrc/minplus_structured.cu``."""

from .ops import minplus_step, minplus_step_structured  # noqa: F401
