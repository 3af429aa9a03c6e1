"""serve.queue_wait_ms: mean wall ms of the server's `serve.queue_wait`
spans in the traced stretch: from a request's submit to the batcher
taking it, the time work waited for the batcher."""

from portbench.metrics._program import mean_ms


def read(r):
    return mean_ms("serve.queue_wait")
