"""The host's microseconds to enqueue one product (the solver loop, the
plan cache and the launcher), timed while a spin kernel holds the card so
that no launch waits for the queue."""


def read(run):
    s = run.host.get("enqueue_s_per_product")
    return None if s is None else s * 1e6
