"""Fault-tolerant checkpointing, in the reference's on-disk format."""
import os

from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CheckpointMismatch,
                                            load_checkpoint, save_checkpoint,
                                            valid_steps)


def party_checkpoint_dir(root: str, name: str) -> str:
    """Canonical location of one party's TrainState-slice checkpoints
    under a run's checkpoint root: a party server writes there, and the
    serving engine's hot model swap loads from there."""
    return os.path.join(root, f"party_{name}")


__all__ = ["CheckpointManager", "CheckpointMismatch", "load_checkpoint",
           "save_checkpoint", "valid_steps", "party_checkpoint_dir"]
