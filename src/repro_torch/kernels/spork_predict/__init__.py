"""Alg. 2 expected-objective kernel (CUDA); see ``csrc/spork_predict.cu``."""

from .ops import expected_objective  # noqa: F401
