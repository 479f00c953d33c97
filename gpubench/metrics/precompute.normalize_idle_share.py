"""precompute.normalize_idle_share: idle device time under the port's spans
``precompute.to_image`` and ``precompute.resize`` (``util._resize_for_encoder``:
each slice's min-max normalization to uint8, then its resize to the model's
input) over the traced window, in % (``harness/spans.py``)."""
from harness.spans import idle_share_under


def read(run):
    return idle_share_under(run, ("precompute.to_image", "precompute.resize"))
