"""Architecture registry: --arch <id> resolution for every launcher."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = {
    "dbrx-132b": "repro_torch.configs.dbrx_132b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "qwen3-32b": "repro_torch.configs.qwen3_32b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "internvl2-76b": "repro_torch.configs.internvl2_76b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2_7b",
}

# input-shape grid shared by all LM archs (seq_len x global_batch);
# decode_* / long_* lower serve_step (one token against a full cache).
SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

# long_500k needs sub-quadratic context handling: only the SSM/hybrid
# archs run it (full-attention archs skip; DESIGN.md §Arch-applicability).
LONG_CONTEXT_ARCHS = ("mamba2-2.7b", "recurrentgemma-2b")


def get_config(arch: str, variant: str = "full") -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    mod = importlib.import_module(ARCHS[arch])
    return getattr(mod, variant)()


def list_archs() -> list[str]:
    return sorted(ARCHS)


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, with skip annotations."""
    out = []
    for arch in list_archs():
        for shape, spec in SHAPES.items():
            skip = (shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS)
            if skip and not include_skipped:
                continue
            out.append((arch, shape, skip))
    return out
