"""Plain PyTorch versions of the min-plus kernels.

Canonical implementations live in `repro_torch.core.dp` (the dense step
is the port of the reference's ``minplus_step_jnp``; the structured step
is the kernel's oracle with ``check=False``); re-exported to keep the
kernels/<name>/{ref,ops} layout.
"""

from repro_torch.core.dp import minplus_step as minplus_step_ref  # noqa: F401
from repro_torch.core.dp import (  # noqa: F401
    minplus_step_structured as minplus_step_structured_ref,
)
