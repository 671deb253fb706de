from .store import (CheckpointStore, latest_step, restore, restore_resharded,
                    save_async, save_sync)

__all__ = ["CheckpointStore", "latest_step", "restore", "restore_resharded",
           "save_async", "save_sync"]
