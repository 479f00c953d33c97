"""embed.relpos_attention_roofline: the least time of the window's
``ops.relpos_attention.relpos_attention`` calls (K1, the rel-pos attention
forward; shapes recorded at the ViT chains' kernel table) over the device
time of its kernels, in %."""
from harness.readers import roofline

KERNEL_NAMES = ("relpos_attention_bf16_kernel", "relpos_attention_f32_kernel")


def read(run):
    return roofline(run, "relpos_attention", KERNEL_NAMES)
