from .ckpt import latest_step, restore, save  # noqa: F401
