"""The product kernels' share of their roofline where convolutions do the
work, in percent: the least time for the step's convolutions and the
matrix products beside them (cuDNN runs some 1x1 convolutions as GEMM
kernels, so the two are timed together), each the larger of its
operations over the peak of the traffic's precision and its bytes over
the memory's rate, times the window's steps, over the device time of the
kernels whose names mark them as cuDNN, cuBLAS or CUTLASS products,
with the FFT, Winograd and layout transforms that cuDNN's algorithms run
for a convolution."""
import re

from benchmark.products import roofline_seconds

UNIT = "%"
PATTERN = re.compile(
    r"conv|fprop|dgrad|wgrad|winograd|implicit|gemm|gemv|cutlass|xmma"
    r"|splitk|fft|DSE::|pointwise_mult_and_sum_complex|region_transform"
    r"|cudnn::", re.IGNORECASE)
NOT = re.compile(r"batch_?norm|bn_fw|bn_bw|elementwise|reduce_kernel|"
                 r"pooling|softmax", re.IGNORECASE)


def is_product(name: str) -> bool:
    return bool(PATTERN.search(name)) and not NOT.search(name)


def read(ctx):
    prods = ctx.products.get("conv")
    if not prods or ctx.peak_flops is None:
        return None
    seconds = ctx.trace.kernel_seconds(is_product)
    if seconds <= 0:
        return None
    bound = roofline_seconds(prods + ctx.products.get("gemm", []),
                             ctx.peak_flops, ctx.peak_bytes)
    return 100.0 * bound * ctx.steps / seconds
