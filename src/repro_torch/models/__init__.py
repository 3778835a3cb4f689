"""Model zoo (port of `repro.models`): the architecture configuration of
all ten assigned models, the shared layers, GQA attention with the
`decode_attn` kernel on every decode step (cross-attention included), the
RG-LRU block, the mixture-of-experts layer, multi-head latent attention,
and `Model` for the dense (qwen3, granite, nemotron), MoE (dbrx,
deepseek-v3), hybrid (recurrentgemma), encoder-decoder (whisper) and VLM
(internvl2) families. The ssm family and training wait for later slices
(ROADMAP.md)."""

from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.model import Model, build_model  # noqa: F401
