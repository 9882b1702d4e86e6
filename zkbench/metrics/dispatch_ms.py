"""Median over the window's batches of the host's time from the call into
the round trip (or the dp step) to its return, before the synchronise:
what paces the card once it exceeds the device time."""

import statistics


def read(obs):
    return statistics.median(obs.dispatch_ms) if obs.dispatch_ms else None
