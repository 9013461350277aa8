"""K1, the coarse or exact scan of one lobe (`search_scan`, csrc/search_scan.cu).

Need of one call over M ranges of N taps and D valid bank rows: both
orientations' numerators of every pair, M * D * 2 * N multiply-adds
(4 N flops a pair), at the dense BF16 tensor rate; the bytes read once:
the centred ranges (M N float32), the rows (D N float32), a weight and a
valid flag a row (and a clip threshold a row for the damped objective),
and a score and an index a range written once."""

SYMBOLS = ("search_scan_kernel", "search_scan_wide_kernel", "merge_splits_kernel")


def work(call: dict):
    M, N, D = call["M"], call["N"], call["D"]
    flops = 4 * N * M * D
    nbytes = 4 * M * N + 4 * D * N + 5 * D + (4 * D if call["clip"] else 0) + 8 * M
    return flops, nbytes
