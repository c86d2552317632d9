from .saver import CheckpointManager, restore_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "restore_checkpoint", "save_checkpoint"]
