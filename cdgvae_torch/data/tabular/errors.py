"""Transformer-stack exceptions (port of ``cdgvae_tpu/data/tabular/
errors.py``)."""


class Error(Exception):
    """Generic transformer error."""


class NotFittedError(Error):
    """Transform called before fit."""


class TransformerInputError(Error):
    """Invalid input passed to a transformer."""
