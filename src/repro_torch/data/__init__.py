from .pipeline import SyntheticLM, make_batches  # noqa: F401
