"""serve.mean_batch: rows per generator dispatch over the window, from
the deltas of the server's own counts (`MicroBatcher.batch_sizes_served`:
rows served, and dispatches); padded rows are not counted."""


def read(r):
    d = getattr(r.window, "dispatches", 0)
    return r.window.images / d if d else None
