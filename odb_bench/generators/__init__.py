"""Traffic generators: a traffic file under ``traffic/`` names one of these
modules in its ``generator`` key; the module's ``records(traffic, seed,
streams)`` makes the epoch's records, given the order in which each rank
admits the identities."""
