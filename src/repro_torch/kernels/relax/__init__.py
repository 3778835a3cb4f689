"""The gradient tuner's relaxation, forward and reverse (CUDA); see
``csrc/relax.cu``."""

from .ops import relax_backward, relax_forward, relaxed_cost  # noqa: F401
