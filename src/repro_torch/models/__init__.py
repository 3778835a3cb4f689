"""Model zoo (port of `repro.models`): the architecture configuration of
all ten assigned models, the shared layers, GQA attention with the
`decode_attn` kernel on every decode step, and the dense-family `Model`
(qwen3, granite, nemotron). The other families (moe, mla, ssm, hybrid,
encdec, vlm) and training wait for later slices (ROADMAP.md)."""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import Model, build_model  # noqa: F401
