"""Atomic, checksummed, retained, resumable checkpoints of the full training
state: parameters, optimizer state, the generator, env cursors and carry.

Counterpart of the JAX package's ``checkpoint/`` with the same protocol;
the payload is ``state.npz`` (``checkpoint/manager.py``).
"""

from sharetrade_tpu_torch.checkpoint.manager import (  # noqa: F401
    CheckpointCorruptError,
    CheckpointIntegrityError,
    CheckpointManager,
    ForeignCheckpointError,
    is_foreign,
    verify_checkpoint_files,
)
