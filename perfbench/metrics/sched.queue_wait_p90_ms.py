"""90th percentile (nearest rank) of the scheduler's queue wait, in ms:
from a request's arrival to the iteration that first scheduled a chunk of
it (``Request.scheduled_time - arrival_time`` on the client's clock), over
the requests sent in the window; one never scheduled counts as infinite."""

import math

from perfbench.metrics import _yardstick as Y


def read(run):
    waits = []
    for c in run.clients:
        if not run.t_open <= c.sent < run.t_close:
            continue
        r = c.req
        waits.append(math.inf if r is None or r.scheduled_time is None
                     else r.scheduled_time - r.arrival_time)
    if not waits:
        return None
    return 1e3 * Y.percentile(waits, 90)
