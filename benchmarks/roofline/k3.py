"""K3, the top-C coarse scan (`topc_scan`, csrc/topc_scan.cu).

Need of one call over M ranges of N taps, D valid bank rows and C lobes:
both orientations' numerators of every pair, M * D * 2 * N multiply-adds
(4 N flops a pair), at the dense BF16 tensor rate; the bytes read once:
the centred ranges, the rows, a weight and a valid flag a row (and a clip
threshold a row for the damped objective), and C indices a range written
once."""

SYMBOLS = ("topc_scan_kernel", "topc_scan_wide_kernel")


def work(call: dict):
    M, N, D, C = call["M"], call["N"], call["D"], call["C"]
    flops = 4 * N * M * D
    nbytes = 4 * M * N + 4 * D * N + 5 * D + (4 * D if call["clip"] else 0) + 4 * M * C
    return flops, nbytes
