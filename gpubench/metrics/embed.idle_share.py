"""embed.idle_share: the share of the traced window in which the card ran no
operation (from the profiler's CUDA activities), in %."""
from harness.readers import idle_share


def read(run):
    return idle_share(run)
