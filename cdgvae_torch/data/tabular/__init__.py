from .datasets import DATASET_SPECS, load_tabular  # noqa: F401
