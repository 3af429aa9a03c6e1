"""serve.encode_ms: mean wall ms of the server's `serve.encode` spans in
the traced stretch (the composite and its PNG encode, on a handler
thread)."""

from portbench.metrics._program import mean_ms


def read(r):
    return mean_ms("serve.encode")
