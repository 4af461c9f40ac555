from .checkpoint import (latest_step, latest_steps, load_checkpoint, restore,
                         restore_sharded, save_checkpoint,
                         save_sharded_checkpoint)

__all__ = ["latest_step", "latest_steps", "load_checkpoint", "restore",
           "restore_sharded", "save_checkpoint", "save_sharded_checkpoint"]
