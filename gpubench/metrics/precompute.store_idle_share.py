"""precompute.store_idle_share: idle device time under the port's span
``precompute.store`` (``util._compute_3d``'s writes of a batch's embeddings,
zlib chunks of the cache) over the traced window, in % (``harness/spans.py``)."""
from harness.spans import idle_share_under


def read(run):
    return idle_share_under(run, ("precompute.store",))
