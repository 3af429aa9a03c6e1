"""serve.handler_cpu_pct: 100 x the handler threads' CPU time over their
wall time, summed over the traced stretch's `serve.decode` and
`serve.encode` spans. The rest is the handlers waiting, for the
interpreter lock most of all."""

from portbench.metrics._program import spans


def read(r):
    ss = spans("serve.decode") + spans("serve.encode")
    wall = sum(s.wall_ns for s in ss)
    return 100.0 * sum(s.cpu_ns for s in ss) / wall if wall else None
