"""Operations and bytes of the products a training step needs, from their
shapes: each matrix product or convolution of the forward, and of the
backward the two products that give the weight's gradient and, where the
input needs one, the input's. Each is a ``(flops, bytes)`` pair, 2
operations a multiply-add, each operand read once and the result written
once at ``item`` bytes an element."""
from __future__ import annotations


def gemm(m: int, k: int, n: int, batch: int = 1, item: int = 4,
         dw: bool = True, dx: bool = True) -> list:
    """``[batch, m, k] @ [batch, k, n]``: the forward, then the weight's
    gradient (``dw``) and the input's (``dx``)."""
    flops = 2 * batch * m * k * n
    x, w, y = batch * m * k, batch * k * n, batch * m * n
    out = [(flops, item * (x + w + y))]
    if dw:
        out.append((flops, item * (x + y + w)))
    if dx:
        out.append((flops, item * (y + w + x)))
    return out


def conv(batch: int, hw_out: int, k: int, cin: int, cout: int,
         hw_in: int | None = None, item: int = 4,
         backward: bool = True) -> list:
    """A ``k`` x ``k`` convolution of ``batch`` images from ``cin`` to
    ``cout`` channels, square outputs of side ``hw_out`` (inputs of side
    ``hw_in``, the same by default); ``backward`` False for a frozen
    layer."""
    hw_in = hw_out if hw_in is None else hw_in
    flops = 2 * batch * hw_out * hw_out * k * k * cin * cout
    x = batch * hw_in * hw_in * cin
    w = k * k * cin * cout
    y = batch * hw_out * hw_out * cout
    out = [(flops, item * (x + w + y))]
    if backward:  # the weight's gradient and the input's
        out += [(flops, item * (x + y + w)), (flops, item * (y + w + x))]
    return out


def roofline_seconds(products, peak_flops: float, bytes_per_s: float):
    """The least time the card could take for ``products``: each bounded
    by the larger of its operations over the peak and its bytes over the
    memory's rate."""
    return sum(max(f / peak_flops, b / bytes_per_s) for f, b in products)
