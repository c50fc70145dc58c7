"""Framework-neutral ODB admission core: the parts serving uses."""
