"""K2, the dense window refine around every lobe (`refine_window` with its
table `window_stats`, csrc/refine_window.cu).

Need of one call over M ranges of N taps, C lobes a range and windows of
W positions: both orientations' numerators at each scored position,
M * C * W * 2 * N multiply-adds (4 N flops a position), at the dense BF16
tensor rate; the bytes read once: the box-mean sequence (L float32), the
lobes (M C int32), the ranges (M N float32), and a score and an index a
range written once."""

SYMBOLS = ("refine_window_kernel", "window_stats_kernel")


def work(call: dict):
    M, N, C, W, L = call["M"], call["N"], call["C"], call["W"], call["L"]
    flops = 4 * N * M * C * W
    nbytes = 4 * L + 4 * M * C + 4 * M * N + 8 * M
    return flops, nbytes
