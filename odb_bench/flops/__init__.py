"""Model FLOPs per family: ``train_flops(sizes, lengths)`` counts the
forward and backward operations a training step needs for real segments of
these lengths (no recompute, no padding), from the configuration's
published sizes.  The configuration's ``run.family`` names the module."""
