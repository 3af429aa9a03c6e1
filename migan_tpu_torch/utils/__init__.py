"""Training utilities: the config banks, the run log and the stats
registry."""
