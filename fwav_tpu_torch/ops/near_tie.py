"""The near-tie bar: two scans' picks agree except where their scores tie
to float rounding.

Two implementations that sum in different orders (the port's plain
versions and the JAX package's kernels, or a kernel and its plain
version) may pick either of two domains that score within rounding of
each other. The bar is the one tests/test_pallas_search.py sets for the
Pallas kernels against lax.scan: the sets of rows without a finite score
(K1, K2) or of -1 entries (K3) are equal; at most 2 rows per 1,024
differ; and on each differing row the picks' scores agree to
`NEAR_TIE_RTOL`. Exact ties are not near-ties: duplicate domains score
identically on both sides and the lower index wins. `chip_smoke.py` holds
the CUDA kernels to this bar on the card (they meet it with no differing
row: they are bit-equal to their plain versions by design);
tests/test_torch_kernels.py holds the plain versions to the JAX
package's kernels.
"""

from __future__ import annotations

import numpy as np

NEAR_TIE_RTOL = 1e-5


def allowed_diffs(rows: int) -> int:
    """Differing rows the bar allows: 2 per 1,024, rounded up."""
    return 2 * -(-rows // 1024)


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def check_argmax(name, got, want, gain=None, rtol=NEAR_TIE_RTOL) -> dict:
    """Hold one argmax scan's (score, idx) to another's. On differing rows
    the two scans' own scores must agree, or with `gain(idx, rows)` the
    float64 gains of the two picks. Raises AssertionError; returns the
    numbers of the check."""
    s_k, i_k = (_np(x) for x in got)
    s_p, i_p = (_np(x) for x in want)
    fin = np.isfinite(s_p)
    if not np.array_equal(np.isfinite(s_k), fin):
        raise AssertionError(f"{name}: the -inf sets differ")
    diff = np.nonzero(fin & (i_k != i_p))[0]
    if len(diff) > allowed_diffs(len(i_p)):
        raise AssertionError(f"{name}: {len(diff)} idx differ in {len(i_p)} rows")
    a, b = (s_k[diff], s_p[diff]) if gain is None else (gain(i_k[diff], diff),
                                                          gain(i_p[diff], diff))
    if not np.allclose(a, b, rtol=rtol, atol=0):
        raise AssertionError(f"{name}: idx differ where the scores do not tie")
    err = float(np.max(np.abs(s_k[fin] - s_p[fin]))) if fin.any() else 0.0
    return {"rows": int(len(i_p)), "idx_diff": int(len(diff)),
            "finite": int(fin.sum()), "max_abs_err": err}


def check_lists(name, got, want, gain, rtol=NEAR_TIE_RTOL) -> dict:
    """Hold one top-C scan's (M, C) lists to another's: equal -1 entries;
    on differing rows the float64 gains `gain(idx, rows)` of the two lists
    agree position by position. Raises AssertionError; returns the numbers
    of the check, among them the largest gain gap (absolute and relative)
    on differing rows."""
    got, want = _np(got), _np(want)
    if not np.array_equal(got < 0, want < 0):
        raise AssertionError(f"{name}: the -1 entries differ")
    rows = np.nonzero((got != want).any(1))[0]
    if len(rows) > allowed_diffs(len(want)):
        raise AssertionError(f"{name}: {len(rows)} lists differ in {len(want)} rows")
    gap = rel = 0.0
    if len(rows):
        g_k, g_p = gain(got[rows], rows), gain(want[rows], rows)
        if not np.allclose(g_k, g_p, rtol=rtol, atol=0):
            raise AssertionError(f"{name}: lists differ where the scores do not tie")
        fin = np.isfinite(g_p)
        if fin.any():
            d = np.abs(g_k[fin] - g_p[fin])
            gap, rel = float(d.max()), float(np.max(d / np.abs(g_p[fin])))
    return {"rows": int(len(want)), "idx_diff": int(len(rows)),
            "unfilled": int((want < 0).sum()), "max_abs_err": gap, "max_rel_gap": rel}


def topc_gain64(r_c, bank_t, w, thresh, s_clip, idx):
    """float64 K3 score of domain idx[i, k] for range i (r_c (M, N),
    bank_t (N, D), w and thresh (D,) or None); -inf where idx is -1."""
    r = _np(r_c).astype(np.float64)[:, None, :]
    idx = _np(idx)
    safe = np.maximum(idx, 0)
    b = _np(bank_t).T[safe].astype(np.float64)
    wk = _np(w)[safe].astype(np.float64)
    no, nm = np.abs((r * b).sum(-1)), np.abs((r[..., ::-1] * b).sum(-1))
    if thresh is None:
        g = np.maximum(no * no * wk, nm * nm * wk)
    else:
        a = np.maximum(no, nm)
        t = _np(thresh)[safe].astype(np.float64)
        g = np.where(a > t, abs(s_clip) * (2 * a - t), a * a * wk)
    return np.where(idx >= 0, g, -np.inf)
