"""The numbers that decide `correct`: one answer of the codec against the
reference's answer for the same input.

An answer is what a decoder would read: the header, the live bitmap, each
live range's bank row, orientation (sym), scale s and offset o, and the
bank rows, either float32 (the in-memory encode) or float16 patterns under
a power-of-two scale (the v2 container). Every number is computed on the
reference's own ranges and bank, in float64:

- header_diff: header fields that differ from what the input and the
  configuration give (range count, range size, tile, domain step, energy
  threshold, length; the v2 decode hint);
- sentinel_diff: ranges whose live/sentinel state differs;
- bank_diff: shipped bank rows equal to no reference row, in the shipped
  precision;
- select_loss: the selection gain that the answer's rows lose against the
  reference's rows, summed over the ranges live in both, over the
  reference's summed |gain| (0 where every range picks a row as good as
  the reference's);
- fit_loss: the residual energy that the answer's stored (s, o, sym) add
  over the reference refit of the same rows, summed over the answer's live
  ranges, over the reference refit's summed residual energy.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .encode import EPS, Encoded, Settings, refit

NAMES = ("header_diff", "sentinel_diff", "bank_diff", "select_loss", "fit_loss")
#: Every number of an answer that cannot be judged at all (no ranges to
#: compare, or unreadable): finite, so that the printed line stays JSON.
UNJUDGED = 1e300


@dataclasses.dataclass
class Answer:
    header: dict
    live: np.ndarray
    rows: np.ndarray        # (n_live,) rows of the shipped bank, in range order
    sym: np.ndarray
    s: np.ndarray
    o: np.ndarray
    bank: np.ndarray | None = None       # (K, n) float32 rows
    bank_f16: np.ndarray | None = None   # (K, n) uint16 float16 patterns
    bank_exp: int = 0


def from_arrays(result) -> Answer:
    """An answer from the in-memory encode's 8-tuple (records, bank,
    n_ranges, range_size, tile_size, domain_step, energy_thresh,
    original_len)."""
    rec, bank, n_ranges, range_size, tile_size, domain_step, energy, original_len = result
    live = rec["idx"] >= 0
    return Answer(
        dict(n_ranges=int(n_ranges), range_size=int(range_size), tile_size=int(tile_size),
             domain_step=int(domain_step), energy_thresh=float(np.float32(energy)),
             original_len=int(original_len)),
        live, rec["idx"][live].astype(np.int64), rec["sym"][live] != 0,
        rec["s"][live].astype(np.float32), rec["o"][live].astype(np.float32),
        bank=np.asarray(bank, np.float32))


def from_container(c) -> Answer:
    """An answer from a parsed v2 container (reference/v2.py)."""
    return Answer(
        dict(n_ranges=c.n_ranges, range_size=c.range_size, tile_size=c.tile_size,
             domain_step=c.domain_step, energy_thresh=float(np.float32(c.energy_threshold)),
             original_len=c.original_len, hint=c.hint),
        c.live, c.idx, c.sym, c.s, c.o, bank_f16=c.bank_f16, bank_exp=c.bank_exp)


def from_reference(e: Encoded, cfg: Settings) -> Answer:
    """The reference's own answer in the program's place (the control)."""
    return Answer(
        dict(n_ranges=e.n_ranges, range_size=cfg.range_size, tile_size=cfg.tile_size,
             domain_step=cfg.domain_step, energy_thresh=float(np.float32(cfg.energy_thresh)),
             original_len=e.original_len),
        e.live, e.idx[e.live], e.sym[e.live], e.s[e.live], e.o[e.live], bank=e.bank)


def _row_keys(rows: np.ndarray) -> np.ndarray:
    """One sortable key per row of uint16 patterns."""
    rows = np.ascontiguousarray(rows)
    return rows.view(np.dtype((np.void, rows.dtype.itemsize * rows.shape[1])))[:, 0]


def _map_rows(ans: Answer, ref: Encoded):
    """(the reference row each shipped row stands for, -1 for none; the
    count of shipped rows that differ from the reference's)."""
    if ans.bank_f16 is None:
        # the whole bank is shipped: row k is the bank's row k, whatever
        # its values, which bank_diff judges
        k = min(len(ans.bank), len(ref.bank))
        same = np.zeros(len(ans.bank), bool)
        if ans.bank.shape[1:] == ref.bank.shape[1:]:
            same[:k] = np.all(ans.bank[:k] == ref.bank[:k], axis=1)
        mapping = np.where(np.arange(len(ans.bank)) < k, np.arange(len(ans.bank)), -1)
        return mapping, int((~same).sum()) + max(0, len(ref.bank) - len(ans.bank))
    if ans.bank_f16.shape[1:] != ref.bank.shape[1:]:
        return np.full(len(ans.bank_f16), -1), len(ans.bank_f16)
    target = (ref.bank * np.float32(2.0 ** -ans.bank_exp)).astype(np.float16).view(np.uint16)
    keys, first = np.unique(_row_keys(target), return_index=True)
    shipped = _row_keys(ans.bank_f16)
    pos = np.clip(np.searchsorted(keys, shipped), 0, len(keys) - 1)
    found = keys[pos] == shipped
    mapping = np.where(found, first[pos], -1)
    return mapping, int((~found).sum())


def gains(r: np.ndarray, t: np.ndarray, objective: str, s_clip: float) -> np.ndarray:
    """The selection gain of each range r against its row t (float64): the
    orientation-folded matched-filter gain of the objective."""
    r = r.astype(np.float64)
    t = t.astype(np.float64)
    n = r.shape[1]
    rc = r - r.mean(1, keepdims=True)
    tm = t.mean(1)
    tc = t - tm[:, None]
    denom = (tc * tc).sum(1)
    no = (rc * tc).sum(1)
    nm = (rc[:, ::-1] * tc).sum(1)
    c = abs(s_clip)
    if objective == "damped":
        a = np.maximum(np.abs(no), np.abs(nm))
        th = c * denom
        return np.where(a > th, c * (2.0 * a - th), a * a / (denom + EPS))
    w = ((denom - n * tm * tm) / (denom + EPS) ** 2 if objective == "balanced"
         else 1.0 / (denom + EPS))
    return np.maximum(no * no * w, nm * nm * w)


def residual(r, t, s, o, sym) -> np.ndarray:
    """||r - (s * t' + o)||^2 per range, t' the row reversed where sym."""
    t = np.where(sym[:, None], t[:, ::-1], t).astype(np.float64)
    d = r.astype(np.float64) - (s.astype(np.float64)[:, None] * t + o.astype(np.float64)[:, None])
    return (d * d).sum(1)


def judge(ref: Encoded, ans: Answer, cfg: Settings, hint: float | None = None) -> dict:
    """The numbers of one answer (see the module doc)."""
    want = dict(n_ranges=ref.n_ranges, range_size=cfg.range_size, tile_size=cfg.tile_size,
                domain_step=cfg.domain_step, energy_thresh=float(np.float32(cfg.energy_thresh)),
                original_len=ref.original_len)
    if hint is not None:
        want["hint"] = hint
    out = {"header_diff": sum(ans.header.get(k) != v for k, v in want.items())}
    if len(ans.live) != ref.n_ranges:
        return {**out, "sentinel_diff": ref.n_ranges, "bank_diff": UNJUDGED,
                "select_loss": UNJUDGED, "fit_loss": UNJUDGED}
    out["sentinel_diff"] = int((ans.live != ref.live).sum())
    mapping, out["bank_diff"] = _map_rows(ans, ref)
    row = np.full(ref.n_ranges, -1, np.int64)
    row[ans.live] = mapping[ans.rows]
    both = ref.live & (row >= 0)
    g_ref = gains(ref.ranges[both], ref.bank[ref.idx[both]], cfg.objective, cfg.s_clip)
    g_ans = gains(ref.ranges[both], ref.bank[row[both]], cfg.objective, cfg.s_clip)
    out["select_loss"] = float(np.maximum(g_ref - g_ans, 0.0).sum()
                               / max(np.abs(g_ref).sum(), 1e-300))
    mine = row[ans.live] >= 0
    rr = row[ans.live][mine]
    r = ref.ranges[ans.live][mine]
    t = ref.bank[rr]
    s_opt, o_opt, sym_opt = refit(r, ref.bank, rr, cfg.s_clip)
    e_opt = residual(r, t, s_opt, o_opt, sym_opt)
    e_ans = residual(r, t, ans.s[mine], ans.o[mine], ans.sym[mine])
    out["fit_loss"] = float((e_ans - e_opt).sum() / max(e_opt.sum(), 1e-300))
    return out
