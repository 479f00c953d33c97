"""embed.gemm_roofline: the least time of the window's ``ops.gemm.gemm`` calls
(their shapes, recorded at the ViT chains' kernel table, at the peaks) over
the device time of the port's gemm kernels, in %."""
from harness.readers import roofline

KERNEL_NAMES = ("gemm_wgmma_kernel", "gemm_f32_kernel")


def read(run):
    return roofline(run, "gemm", KERNEL_NAMES)
