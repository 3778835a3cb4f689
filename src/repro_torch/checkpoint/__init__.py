"""Checkpointing (port of `repro.checkpoint`): the atomic npz + manifest
store and its managers, on the reference's on-disk format."""

from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: F401
                                            ChunkStore)
from repro_torch.checkpoint.store import (has_named,  # noqa: F401
                                          latest_step, restore_checkpoint,
                                          restore_named, save_checkpoint,
                                          save_named)
