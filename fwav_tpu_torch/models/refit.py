"""The host refit on the card: where models/encode.py _encode_stack hands a
stack's codes to `collect_refit` (ops/kernels.py, csrc/collect_refit.cu),
and the self-check that lets it.

A stack's codes are refit on the card where everything the host refit
reads is there when the program ends:

- its samples reach the card as int16 (their bank is `bank_means`' on the
  card, models/encode.py _bank_builds);
- the mesh is one cell, a CUDA device of this process (the captured
  program, or a one-device _mesh_program / _packed_cells);
- `cfg.fast_mode`: the raw ranges are the refit's targets (the VAD-weighted
  ranges of fast_mode=False are made on the host).

Such a stack is always refit on the card, in the arithmetic variant of the
self-check (`refit_mode`), which raises where no variant gives the host's
bits. Every other stack keeps the host refit (collect_idx_matches, the
native fwav_collect), and so does the stream (models/stream.py
refit_host).

The self-check: `g++ -O3 -march=native`, which builds the native refit,
fuses a product into the sum that takes it on a host with FMA, and
vectorizes the loops of range sizes other than 4, 8 and 16 as the compiler
chooses; the kernel follows one of two arithmetic variants
(csrc/collect_refit.cuh). The native build is not made to round as the
kernel does (`-ffp-contract=off`) because the port's records are held byte
for byte to the JAX package's, whose own native build contracts. On the
first stack of a card and range size, `refit_mode` runs the kernel in each
variant on `check_case` (three files with reflected tails, ranges and rows
at the orientation rule's tie edge, exactly palindromic ranges, sentinels,
a zero range, a flat row, a -0.0 first bank value on the host side,
clipped slopes) and keeps the one whose records equal the native refit's
byte for byte. Where neither does, or the native library is missing (the
host would take the numpy refit), it raises: such a host cannot write the
bytes the card makes. The self-check's launches are not counted in
kernels.LAUNCHES, which counts those of the encodes.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from ..ops import kernels

#: The variants the self-check tries, in order: the native build's on an
#: FMA host at range sizes 4, 8, 16 (every product fused), then at the
#: others (the vectorized loop's rounding).
MODES = (kernels.REFIT_FUSED, kernels.REFIT_VECTOR8)
#: The slope clip of the self-check: small, so that many of its slopes clip.
CHECK_CLIP = 2.0

_modes: dict = {}
_lock = threading.Lock()


class CardRecords(NamedTuple):
    """One file's records refit on the card (a view into the stack's pinned
    copy), its live records and its codes at or past its bank's rows."""

    rec: np.ndarray
    live: int
    bad: int


def card_refit_mode(dtype, cfg, mesh) -> int | None:
    """The variant in which a stack of `dtype` samples under `cfg` on
    `mesh` is refit on the card, or None where it keeps the host refit
    (refit_mode raises where the card cannot give the host's bits)."""
    dev = mesh.first_local_device()
    if (dtype != np.int16 or not cfg.fast_mode or mesh.size != 1 or mesh.multi_process
            or dev.type != "cuda"):
        return None
    return refit_mode(dev, cfg.range_size)


def refit_mode(device, range_size: int) -> int:
    """The self-check's variant for a card and a range size, run once a
    process; RuntimeError where no variant gives the native refit's bits
    or the native library is missing."""
    key = (str(torch.device(device)), int(range_size))
    with _lock:
        if key not in _modes:
            _modes[key] = _self_check(torch.device(device), int(range_size))
        return _modes[key]


def start(codes, x, bank, files, cfg, mode: int):
    """Launch `collect_refit` on a stack (codes (B, rb, 3), its int16
    samples x and device bank; files as _encode_stack's) on the current
    stream and copy its output into pinned host memory behind it (CPU
    tensors: the plain version, no copy). Returns a function that waits for
    the copy and gives one CardRecords a file."""
    lengths = [len(f[0]) for f in files]
    n_domains = [f[3] for f in files]
    out = kernels.collect_refit(codes, x, bank, lengths, n_domains, cfg.range_size,
                                cfg.s_clip, mode)
    host, done = out, None
    keep = (codes, x, bank, out)  # alive until the copy is done, whatever stream frees them
    if out.device.type == "cuda":
        host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(out.device))

    def wait():
        nonlocal keep
        if done is not None:
            done.synchronize()
        keep = None
        return [CardRecords(*part)
                for part in kernels.split_records(host.numpy(), [f[2] for f in files])]

    return wait


class CheckCase(NamedTuple):
    """The self-check's stack: per file its float32 samples (the host
    path's, -0.0 included) and its host bank (a -0.0 first value); the
    int16 stack, the device bank (B, D, n) with +0.0 there, the codes
    (B, rb, 3) and the counts."""

    signals: list
    host_banks: list
    x: np.ndarray
    bank: np.ndarray
    codes: np.ndarray
    n_domains: list


def _edge_row(r: np.ndarray, rng, scale: float):
    """A bank row at which the orientation rule's margin |num_m| - |num_o|
    - 1e-5 |r_c| |t_c| of range r crosses 0 (float64 bisection along one
    coordinate from a random row), or None where the scan finds no
    crossing."""
    n = len(r)
    rc = r - r.mean()

    def margin(t):
        tc = t - t.mean(axis=-1, keepdims=True)
        no, nm = tc @ rc, tc @ rc[::-1]
        return (np.abs(nm) - np.abs(no)
                - 1e-5 * np.linalg.norm(rc) * np.linalg.norm(tc, axis=-1))

    for _ in range(16):
        t0 = rng.standard_normal(n) * scale
        e = np.zeros(n)
        e[rng.integers(n)] = 1.0
        beta = np.linspace(-4.0, 4.0, 401) * scale
        m = margin(t0 + beta[:, None] * e)
        cross = np.flatnonzero(np.sign(m[:-1]) * np.sign(m[1:]) < 0)
        if len(cross) == 0:
            continue
        lo, hi = beta[cross[0]], beta[cross[0] + 1]
        m_lo = margin(t0 + lo * e)
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            m_mid = margin(t0 + mid * e)
            if np.sign(m_mid) == np.sign(m_lo):
                lo, m_lo = mid, m_mid
            else:
                hi = mid
        return (t0 + lo * e).astype(np.float32), int(np.flatnonzero(e)[0])
    return None


def check_case(n: int, seed: int = 0) -> CheckCase:
    """The self-check's inputs for range size n (deterministic for a seed):
    three files of 37, 64 and 51 ranges and a part, each with a reflected
    tail; from range 2 on every 12th a run of five copies of one range
    against a row at its tie edge and rows 1 and 2 float32 steps either
    side; from range 9 on every 12th a palindrome; file 0's first range
    all -0.0 (0 in int16) and coded to row 0, whose first value is -0.0 in
    its host bank; a flat row and a zero row; about 15% sentinels; the rest
    random rows of large and small scale."""
    rng = np.random.default_rng(seed)
    lengths = [37 * n + 1, 64 * n + n - 1, 51 * n + max(1, n // 2)]
    signals, host_banks, code_rows = [], [], []
    for b, L in enumerate(lengths):
        m = -(-L // n)
        sig = rng.integers(-32767, 32768, m * n).astype(np.float32)
        rows = [(rng.standard_normal((40, n)) * 9000.0).astype(np.float32),
                (rng.standard_normal((8, n)) * 3.0).astype(np.float32)]
        rows[0][1] = 1234.5  # flat: denom 0
        rows[0][2] = 0.0
        codes = rng.integers(0, 48, m)
        codes[rng.random(m) < 0.15] = -1
        extra = []
        for k in range(2, m - 6, 12):
            r = sig[k * n : (k + 1) * n].astype(np.float64)
            found = _edge_row(r, rng, 9000.0)
            if found is None:
                continue
            row, q = found
            for d, step in enumerate((0, 1, -1, 2, -2)):
                t = row.copy()
                for _ in range(abs(step)):
                    t[q] = np.nextafter(t[q], np.float32(np.inf if step > 0 else -np.inf))
                sig[(k + d) * n : (k + d + 1) * n] = sig[k * n : (k + 1) * n]
                codes[k + d] = 48 + len(extra)
                extra.append(t)
        for k in range(9, m - 1, 12):  # palindromes against random rows
            half = sig[k * n : k * n + (n + 1) // 2]
            sig[k * n : (k + 1) * n] = np.concatenate([half, half[: n // 2][::-1]])
            codes[k] = rng.integers(0, 48)
        if b == 0:
            sig[:n] = -0.0
            codes[0] = 0
        bank = np.concatenate(rows + ([np.stack(extra)] if extra else []))
        if b == 0:
            bank[0, 0] = -0.0
        signals.append(sig[:L].copy())
        host_banks.append(bank)
        code_rows.append(codes)
    D = kernels.bank_rows([len(h) for h in host_banks])
    rb = max(len(c) for c in code_rows)
    nb = -(-max(lengths) // 256) * 256
    x = np.zeros((3, nb), np.int16)
    dev_bank = np.zeros((3, D, n), np.float32)
    codes3 = np.full((3, rb, 3), 0xFF, np.uint8)
    for b, (sig, h, c) in enumerate(zip(signals, host_banks, code_rows)):
        x[b, : len(sig)] = sig.astype(np.int16)
        dev_bank[b, : len(h)] = np.where(h == 0, np.float32(0.0), h)  # int16 sums: +0.0
        live = c >= 0
        c3 = np.stack([(c >> s) & 0xFF for s in (0, 8, 16)], axis=-1).astype(np.uint8)
        codes3[b, : len(c)] = np.where(live[:, None], c3, np.uint8(0xFF))
    return CheckCase(signals, host_banks, x, dev_bank, codes3, [len(h) for h in host_banks])


def host_records(case: CheckCase, n: int, s_clip: float) -> list | None:
    """The host path's records of a check case (the native refit of
    models/encode.py collect_idx_matches on the float32 samples,
    reflect-padded, against the host banks), or None where the native
    library is missing."""
    from ..io import native

    out = []
    for b, (sig, bank) in enumerate(zip(case.signals, case.host_banks)):
        m = -(-len(sig) // n)
        ranges = np.pad(sig, (0, m * n - len(sig)), mode="reflect").reshape(m, n)
        rec = native.collect(np.ascontiguousarray(case.codes[b, :m]), ranges, bank, s_clip)
        if rec is None:
            return None
        out.append(rec)
    return out


def _self_check(device, n: int) -> int:
    case = check_case(n)
    want = host_records(case, n, CHECK_CLIP)
    if want is None:
        raise RuntimeError(
            "the refit on the card needs the native refit library (io/native.py), whose "
            "bytes it gives, and it is not built")
    codes, x, bank = (torch.from_numpy(a).to(device) for a in (case.codes, case.x, case.bank))
    lengths = [len(s) for s in case.signals]
    live = [int(np.sum(w["idx"] >= 0)) for w in want]
    launches = kernels.LAUNCHES["collect_refit"]
    try:
        for mode in MODES:
            out = kernels.collect_refit(codes, x, bank, lengths, case.n_domains, n,
                                        CHECK_CLIP, mode)
            got = kernels.split_records(out.cpu().numpy(), [len(w) for w in want])
            if all(g[0].tobytes() == w.tobytes() and g[1:] == (k, 0)
                   for g, w, k in zip(got, want, live)):
                return mode
    finally:
        kernels.LAUNCHES["collect_refit"] = launches
    raise RuntimeError(
        f"collect_refit gives the native refit's bytes in none of its arithmetic variants at "
        f"range size {n} on {device}: the native library's compiler rounds otherwise "
        f"(csrc/collect_refit.cuh)")
