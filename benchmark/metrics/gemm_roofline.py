"""The matrix-product kernels' share of their roofline, in percent: the
least time the card could take for the step's matrix products (each the
larger of its operations over the peak of the traffic's precision and its
bytes over the memory's rate), times the window's steps, over the device
time of the kernels whose names mark them as cuBLAS or CUTLASS products."""
import re

from benchmark.products import roofline_seconds

UNIT = "%"
PATTERN = re.compile(r"gemm|gemv|cutlass|xmma|splitk|dot_kernel",
                     re.IGNORECASE)
NOT = re.compile(r"conv|fprop|dgrad|wgrad|winograd|implicit", re.IGNORECASE)


def is_gemm(name: str) -> bool:
    return bool(PATTERN.search(name)) and not NOT.search(name)


def read(ctx):
    gemms = ctx.products.get("gemm")
    if not gemms or ctx.peak_flops is None:
        return None
    seconds = ctx.trace.kernel_seconds(is_gemm)
    if seconds <= 0:
        return None
    bound = roofline_seconds(gemms, ctx.peak_flops, ctx.peak_bytes)
    return 100.0 * bound * ctx.steps / seconds
