"""Checkpoints of the port (counterpart of ``repro.ckpt``): the
reference's msgpack format v2, written by the port's own codec."""

from repro_torch.ckpt.msgpack_ckpt import (AsyncCheckpointer,
                                           CheckpointManager, load_pytree,
                                           register_treedef, restore_pytree,
                                           save_pytree, save_pytree_async)

__all__ = ["AsyncCheckpointer", "CheckpointManager", "load_pytree",
           "register_treedef", "restore_pytree", "save_pytree",
           "save_pytree_async"]
