"""The benchmark of ``cdgvae_torch``: ``python3 benchmark/run.py``
(README.md). A package, so that its imports cannot resolve to another
installed module of the same name."""
