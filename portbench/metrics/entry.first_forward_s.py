"""entry.first_forward_s: wall seconds of the process's first forward
through `load_model` (the program's set-up span `entry.first_forward`),
which pays the device's lazy set-up; part of `setup_s`."""

from portbench.metrics._program import spans


def read(r):
    first = spans("entry.first_forward", setup=True)
    return first[0].wall_ns / 1e9 if first else None
