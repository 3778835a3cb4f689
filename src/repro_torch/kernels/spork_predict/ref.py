"""Plain PyTorch version of the `spork_predict` kernel.

Canonical implementation: `repro_torch.core.predictor.expected_objective`
(a transliteration of the reference's ``expected_objective_jnp``, the TPU
kernel's own oracle); re-exported to keep the kernels/<name>/{ref,ops}
layout.
"""

from repro_torch.core.predictor import expected_objective as expected_objective_ref  # noqa: F401,E501
