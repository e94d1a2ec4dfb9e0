"""The 90th percentile of the latency of every step in the window, in ms:
from the step's images handed to the entry to its answers on the host."""
import statistics


def read(window: dict) -> float:
    return 1000.0 * statistics.quantiles(window["latencies"], n=10, method="inclusive")[8]
