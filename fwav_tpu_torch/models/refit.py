"""A stack's host half: where its bank is built, where its codes become
records, and how the records come back; the stream's refits; and the
self-check that lets a stack's refit run on the card.

models/encode.py _encode_stack runs a stack's device program and leaves the
rest to a `HostHalf`, made under DEVICE_LOCK before the program is enqueued
with the stack's samples on the mesh's first local device, which decides
both places from what it observes:

- the bank: an int16 stack (every sample a whole number, encode.py
  _as_i16_or_f32) takes `bank_means` on those samples, enqueued at once
  ahead of the program, and each file's rows are copied into pinned host
  memory on a side stream while the program runs: the bits of
  build_domains_host, whose float64 sums of whole numbers are exact (the
  host's -0.0 first mean restored, _host_zero_sign). A float stack takes
  build_domains_host on the host while the devices run.
- the refit: on the card (`card_refit_mode`) where everything the host
  refit reads is there when the program ends: the samples are int16 (their
  bank is `bank_means`' on the card); the mesh is one cell, a CUDA device
  of this process (the captured program, or a one-device _mesh_program /
  _packed_cells); `cfg.fast_mode` (the VAD-weighted ranges of
  fast_mode=False are made on the host). `HostHalf.take` then launches
  `collect_refit` (ops/kernels.py, csrc/collect_refit.cu) on the program's
  codes behind it, and one copy brings the records back in place of the
  codes. Every other stack's codes come back, one copy per cell, and are
  refit on the host (collect_idx_matches, the native fwav_collect).

The stream's shards and its global pass refit on the host (refit_shard,
refit_rows: numpy refit_host against bank rows rebuilt from the signal, as
in the JAX package's stream).

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

from ..io.container import MATCH_DTYPE
from ..ops import kernels
from ..ops.affine import refit_host
from ..ops.domains import bank_rows_host, build_domains_host
from ..ops.vad import voiced_detection
from ..parallel.mesh import fetch_global
from ..utils.trace import phase
from .program import DEVICE_LOCK

#: The 3-byte little-endian idx code of a dead range (sentinel).
IDX3_SENTINEL = 0xFFFFFF
#: The variants the self-check tries, in order: the native build's on an
#: FMA host at range sizes 4, 8, 16 (every product fused), then at the
#: others (the vectorized loop's rounding).
MODES = (kernels.REFIT_FUSED, kernels.REFIT_VECTOR8)
#: The slope clip of the self-check: small, so that many of its slopes clip.
CHECK_CLIP = 2.0

_modes: dict = {}
_lock = threading.Lock()
#: Side streams that copy banks built on a card to the host, one a device.
_BANK_STREAMS: dict = {}


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


class HostHalf:
    """The host half of one stack of files (signal, raw_p, n_ranges,
    n_domains), as models/encode.py _encode_stack gives them. Made under
    DEVICE_LOCK before the stack's program is enqueued, with x (B, nb) its
    samples on the mesh's first local device: takes the refit's place
    (`mode`, None for the host) and starts the bank. Then `take` (the
    program's codes, under DEVICE_LOCK), `fetch` (in phase d2h) and
    `results`."""

    def __init__(self, x, files, cfg, mesh):
        self.files, self.cfg, self.mesh, self.x = files, cfg, mesh, x
        self.mode = card_refit_mode(files[0][1].dtype, cfg, mesh)
        self.bank = self._host_banks = self._done = None
        if x.dtype != torch.int16:
            kernels.BANK_BUILDS["host"] += len(files)
            return
        n, n_domains = cfg.range_size, [f[3] for f in files]
        bank = self.bank = kernels.bank_means(x, n_domains, cfg.tile_size, n, cfg.domain_step)
        kernels.BANK_BUILDS["device"] += len(files)
        if bank.device.type != "cuda":
            self._host_banks = [bank[b, :d] for b, d in enumerate(n_domains)]
            return
        side = _BANK_STREAMS.get(bank.device)
        if side is None:
            side = _BANK_STREAMS[bank.device] = torch.cuda.Stream(bank.device)
        side.wait_stream(torch.cuda.current_stream(bank.device))
        self._host_banks = [torch.empty((d, n), dtype=torch.float32, pin_memory=True)
                            for d in n_domains]
        with torch.cuda.stream(side):
            for b, h in enumerate(self._host_banks):
                h.copy_(bank[b, : len(h)], non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(side)
        bank.record_stream(side)

    def take(self, codes: dict, axis: int = 0) -> None:
        """The program's codes, {position: (files, ranges, 3) uint8} whose
        parts join along `axis` (0: files, 1: ranges). Where the card
        refits (a one-cell mesh, so codes[0] is the whole stack), launches
        collect_refit on them, the samples and the bank on the current
        stream, and copies its output into pinned host memory behind it (a
        CPU tensor: the plain version, no copy). Call under DEVICE_LOCK."""
        self.codes, self.axis = codes, axis
        if self.mode is None:
            return
        files, cfg = self.files, self.cfg
        out = kernels.collect_refit(codes[0], self.x, self.bank, [len(f[0]) for f in files],
                                    [f[3] for f in files], cfg.range_size, cfg.s_clip, self.mode)
        self.out, self.records, self.copied = out, out, None
        if out.device.type == "cuda":
            self.records = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
            self.records.copy_(out, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record(torch.cuda.current_stream(out.device))

    def fetch(self) -> None:
        """The banks, one C-contiguous float32 (n_domains, range_size) array
        a file (phase host_bank), then the records from the card, or the
        codes (fetch_global under DEVICE_LOCK) for the host refit. Drops
        the stack's device tensors."""
        files, cfg = self.files, self.cfg
        with phase("host_bank"):
            if self._host_banks is None:
                self.banks = [build_domains_host(f[0], cfg.tile_size, cfg.range_size,
                                                 cfg.domain_step) for f in files]
            else:
                if self._done is not None:
                    self._done.synchronize()
                self.banks = [_host_zero_sign(h.numpy(), f[0], cfg.tile_size // cfg.range_size)
                              for h, f in zip(self._host_banks, files)]
        if self.mode is not None:
            if self.copied is not None:
                self.copied.synchronize()
            self.found = kernels.split_records(self.records.numpy(), [f[2] for f in files])
        else:
            codes = self.codes
            if self.axis:
                codes = {k: v.transpose(0, 1) for k, v in codes.items()}
            with DEVICE_LOCK:
                c = fetch_global(codes, self.mesh)
            if self.axis:
                c = c.transpose(1, 0, 2)
            self.found = [cj[: f[2]] for cj, f in zip(c, files)]
        self.x = self.bank = self.codes = self.out = None
        kernels.REFITS["host" if self.mode is None else "device"] += len(files)

    def results(self) -> list:
        """One compress_audio_arrays 8-tuple a file, after `fetch` and
        outside DEVICE_LOCK: the card's records checked (_card_result), or
        the codes refit on the host (_host_result)."""
        finish = _host_result if self.mode is None else _card_result
        out = []
        for found, (signal, _, n_ranges, n_domains), bank in zip(self.found, self.files,
                                                                 self.banks):
            assert len(bank) == n_domains
            out.append(finish(found, signal, self.cfg, n_ranges, bank))
        return out


def _host_zero_sign(bank: np.ndarray, signal: np.ndarray, block_len: int) -> np.ndarray:
    """The one bit of build_domains_host that an integer build lacks: its
    first mean is -0.0 where the first block's samples are all -0.0 (a
    float64 sum of -0.0s stays -0.0, and -0.0 - 0.0 is -0.0)."""
    head = signal[:block_len]
    if len(bank) and not head.any() and np.signbit(head).all():
        bank[0, 0] = -0.0
    return bank


def _result(rec, bank, n_ranges: int, cfg, original_len: int):
    return (rec, bank, n_ranges, cfg.range_size, cfg.tile_size, cfg.domain_step,
            cfg.energy_thresh, original_len)


def _empty_result(cfg, original_len: int):
    return _result(np.empty(0, dtype=MATCH_DTYPE),
                   np.zeros((0, cfg.range_size), dtype=np.float32), 0, cfg, original_len)


def _voiced(signal, cfg):
    """The signal weighted by its host VAD (phase vad), or None where that
    leaves no energy: the file gives the empty result."""
    with phase("vad"):
        weighted = signal * voiced_detection(signal, frame_size=cfg.range_size * 2,
                                             energy_threshold=cfg.energy_thresh)
    return None if float(np.sum(weighted.astype(np.float64) ** 2)) < 1e-8 else weighted


def _card_result(found, signal, cfg, n_ranges: int, bank):
    """A file whose records the card made, `found` (records, live, bad) of
    kernels.split_records; fast_mode holds. An all-sentinel file whose
    host VAD leaves no energy gives the empty result; a code at or past its
    bank's rows raises the native refit's IndexError."""
    rec, live, bad = found
    if live == 0 and _voiced(signal, cfg) is None:
        return _empty_result(cfg, len(signal))
    with phase("refit"):
        if bad:
            raise IndexError("collect: domain index out of range for the bank")
    return _result(rec, bank, n_ranges, cfg, len(signal))


def _host_result(codes, signal, cfg, n_ranges: int, bank):
    """Host half of the idx-only protocol (copied from the JAX package): a
    file's 3-byte codes, sentinel classification and the exact refit of
    the device's selections against the serialized bank."""
    n = cfg.range_size
    pad_len = -len(signal) % n
    if cfg.fast_mode and bool(np.all(codes == 0xFF)):  # every code 0xFFFFFF
        # all pruned: an all-silent file gives the empty container
        if _voiced(signal, cfg) is None:
            return _empty_result(cfg, len(signal))
        ranges = None
    else:
        # under fast_mode every live range is fully voiced, so the raw
        # ranges are its refit targets (the reflected tail's sources are
        # voiced whenever the tail is live)
        target = signal if cfg.fast_mode else _voiced(signal, cfg)
        if target is None:
            return _empty_result(cfg, len(signal))
        if pad_len:
            target = np.pad(target, (0, pad_len), mode="reflect")
        ranges = target.reshape(n_ranges, n)
    with phase("refit"):
        rec = collect_idx_matches(codes, n_ranges, ranges, bank, cfg.s_clip)
    return _result(rec, bank, n_ranges, cfg, len(signal))


def sentinel_records(m: int) -> np.ndarray:
    """m dead records: (-1, 1, 0, 0, 0)."""
    rec = np.empty(m, dtype=MATCH_DTYPE)
    rec["idx"] = -1
    rec["s"] = 1.0
    rec["o"] = 0.0
    rec["sym"] = 0
    rec["err"] = 0.0
    return rec


def collect_idx_matches(codes, n_ranges: int, ranges, bank, s_clip: float):
    """3-byte codes -> MATCH_DTYPE records: sentinels become
    (-1, 1, 0, 0, 0); live rows are refit on the host (refit_host, or the
    native kernel that runs the same rule)."""
    b3 = np.ascontiguousarray(codes[:n_ranges])
    if ranges is not None:
        from ..io import native

        rec = native.collect(
            b3, np.ascontiguousarray(ranges, dtype=np.float32), bank, s_clip
        )
        if rec is not None:
            return rec

    c = unpack3_np(b3)
    dead = c < 0
    if ranges is None or bool(np.all(dead)):
        return sentinel_records(n_ranges)
    rec = np.empty(n_ranges, dtype=MATCH_DTYPE)
    idx = np.where(dead, 0, c).astype(np.int32)
    s, o, err, sym = refit_host(ranges, bank, idx, s_clip)
    rec["idx"] = np.where(dead, -1, idx)
    rec["s"] = np.where(dead, np.float32(1.0), s)
    rec["o"] = np.where(dead, np.float32(0.0), o)
    rec["sym"] = np.where(dead, False, sym).astype(np.uint8)
    rec["err"] = np.where(dead, np.float32(0.0), err)
    return rec


def refit_shard(b3, signal, ranges, row_base, cfg):
    """One stream shard's records from its 3-byte codes: window-local rows
    plus row_base are whole-file rows, refit on the host (refit_rows)."""
    c = unpack3_np(b3)
    rec = sentinel_records(len(b3))
    live = c >= 0
    if live.any():
        refit_rows(rec, live, c[live] + row_base, ranges[live], signal, cfg)
    return rec


def refit_rows(rec, live, rows, ranges, signal, cfg):
    """Store into rec[live] the whole-file bank rows `rows` and their
    host refit against `ranges`: exactly those rows of the serialized bank
    are rebuilt from the raw signal (bank_rows_host), as the writers
    serialize them."""
    tiles = bank_rows_host(signal, cfg.tile_size, cfg.range_size, cfg.domain_step,
                           rows.astype(np.int64))
    s, o, err, sym = refit_host(
        np.ascontiguousarray(ranges), tiles, np.arange(len(rows), dtype=np.int32), cfg.s_clip,
    )
    rec["idx"][live] = rows
    rec["s"][live] = s
    rec["o"][live] = o
    rec["sym"][live] = sym
    rec["err"][live] = err


def pack3_np(rows: np.ndarray) -> np.ndarray:
    """(m,) integer rows (< 0 = dead) -> (m, 3) uint8, host side."""
    code = np.where(rows < 0, IDX3_SENTINEL, rows).astype(np.int64)
    return np.stack(
        [code & 0xFF, (code >> 8) & 0xFF, (code >> 16) & 0xFF], axis=1
    ).astype(np.uint8)


def unpack3_np(b3: np.ndarray) -> np.ndarray:
    """(m, 3) uint8 -> (m,) int64 rows, -1 where the sentinel, host side."""
    b3 = b3.astype(np.int64)
    c = b3[:, 0] | (b3[:, 1] << 8) | (b3[:, 2] << 16)
    return np.where(c == IDX3_SENTINEL, -1, c)


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
    collect_idx_matches on the float32 samples,
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
