"""The port's kernels and the attention entry points."""
from .attention import attention_with_rel_pos
