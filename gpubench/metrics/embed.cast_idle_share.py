"""embed.cast_idle_share: idle device time under the port's span
``encode_batch.cast`` (``SamPredictor.encode_batch``'s float32 conversion of
the batch on the host) over the traced window, in % (``harness/spans.py``)."""
from harness.spans import idle_share_under


def read(run):
    return idle_share_under(run, ("encode_batch.cast",))
