"""embed.copy_in_gbps: the bytes of the port's spans ``encode_batch.copy_in``
(``SamPredictor.encode_batch``'s copy of the float32 batch to the card) over
those spans' seconds, in GB/s (``harness/spans.py``)."""
from harness.spans import rate_gbps


def read(run):
    return rate_gbps(run, "encode_batch.copy_in")
