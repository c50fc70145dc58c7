"""The benchmark of the PyTorch/CUDA port (``repro_torch``): ODB-fed
training on one H100, one cell (a configuration under a traffic mix) per
run.  ``run.py`` is the entry point; everything a cell needs is found by
name under this folder."""
