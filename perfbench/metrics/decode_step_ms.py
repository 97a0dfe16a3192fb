"""Caller's milliseconds a decode step: the wall time of the window's
session calls outside the traced slice, less their prefills (each
request's ``prefill_s``), over the decode steps the session counted."""


def read(run):
    steps = run.host.get("decode_steps")
    if not steps:
        return None
    return run.host["decode_wall_s"] / steps * 1e3
