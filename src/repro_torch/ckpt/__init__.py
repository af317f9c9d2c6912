"""repro_torch.ckpt — atomic, integrity-checked checkpoints in the JAX
package's file layout (the counterpart of ``repro.ckpt``)."""
from repro_torch.ckpt.checkpoint import (  # noqa: F401
    latest_step,
    load_manifest,
    restore_checkpoint,
    save_checkpoint,
    tree_flatten,
    tree_unflatten,
)
