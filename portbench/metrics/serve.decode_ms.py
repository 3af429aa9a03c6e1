"""serve.decode_ms: mean wall ms of the server's `serve.decode` spans in
the traced stretch (a request's body to model input: JSON, base64, image
decode and resizes, on a handler thread)."""

from portbench.metrics._program import mean_ms


def read(r):
    return mean_ms("serve.decode")
