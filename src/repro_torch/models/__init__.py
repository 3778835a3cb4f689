"""Model zoo (port of `repro.models`): the architecture configuration of
all ten assigned models, the shared layers, GQA attention with the
`decode_attn` kernel on every decode step, the RG-LRU block, and `Model`
for the dense (qwen3, granite, nemotron) and hybrid (recurrentgemma)
families. The other families (moe, mla, ssm, encdec, vlm) and training
wait for later slices (ROADMAP.md)."""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import Model, build_model  # noqa: F401
