from .ckpt import latest_step, map_leaves, restore, save  # noqa: F401
