"""K4, the staged window refine over the full bank (`staged_refine` with
its table `staged_stats`, csrc/staged_refine.cu).

Need of one call over M ranges of N taps and C lobes a range, each range
scoring R bank rows (the plan's own count: C * W dense rows, or one lobe's
descent at steps 16 and 4 and a dense last window): both orientations'
numerators of every scored row, M * R * 2 * N multiply-adds (4 N flops a
row), at the dense BF16 tensor rate; the bytes read once: the bank (D N
float32), the ranges, the lobes, and an index and a score a range written
once."""

SYMBOLS = ("staged_refine_kernel", "staged_stats_kernel")


def work(call: dict):
    M, N, C, R, D = call["M"], call["N"], call["C"], call["R"], call["D"]
    flops = 4 * N * M * R
    nbytes = 4 * D * N + 4 * M * N + 4 * M * C + 8 * M
    return flops, nbytes
