"""The search kernels of the encode core: wrappers, plain versions, gates.

The counterpart of fwav_tpu/ops/pallas_search.py for its three Pallas
kernels:

- `search_scan` (K1) replaces `_search_kernel` (exact_search_scan_pallas
  with with_sym=False): the running argmax over domains of the
  orientation-folded matched-filter gain. CUDA source:
  csrc/search_scan.cu.
- `topc_scan` (K3) replaces `_topc_kernel` (topc_search_scan_pallas):
  the sorted top-C domains per range, the damped profile's coarse lobes.
  CUDA source: csrc/topc_scan.cu.
  K1 and K3 take every range size of 4 to 255 taps, as the TPU kernels
  take any: up to 16 the kernels of csrc/scan_tile.cuh, from 17 on (tiles
  from 4352 samples) the wide kernels of csrc/scan_wide.cuh, the same
  tensor-core screen and exact confirm at a runtime tap count.
- `refine_window` (K2) replaces `_refine_kernel` (refine_window_pallas)
  and the per-lobe merge of its callers: the dense window refine around
  every coarse lobe of a range, in one launch. Its per-position table
  comes from `window_stats`, a kernel of its own. CUDA source:
  csrc/refine_window.cu.

and one kernel with no Pallas counterpart:

- `staged_refine` (K4) replaces XLA's fusion of the JAX package's
  `refine_from_lobes` (fwav_tpu/ops/search.py:470) inside its compiled
  encode core: the staged window refine around coarse lobes over the full
  bank, where the window-refine kernel's gates refuse a geometry, in the
  whole-file global pass (each lobe column alone, merged with a strict >)
  and in coarse_refine_search. Its per-row table comes from
  `staged_stats`, a kernel of its own. CUDA source: csrc/staged_refine.cu.
- `bank_means` replaces the host's numpy build of the serialized bank
  (ops/domains.py build_domains_host; the JAX package's build_domains_host
  in fwav_tpu/ops/domains.py) for stacks of integer-valued samples, which
  reach the card as int16: the same bits, from exact integer block sums.
  CUDA source: csrc/bank_means.cu.

Each wrapper dispatches on the device of its tensors: a CPU tensor takes
the plain PyTorch version (`search_scan_ref`, `topc_scan_ref`,
`refine_window_ref`, `window_stats_ref`, `staged_refine_ref`, which runs
`refine_from_lobes`, defined here, `staged_stats_ref`, `bank_means_ref`), a
CUDA tensor launches the kernel or raises. The plain versions are the spec, and on the
same inputs each kernel agrees with its plain version bit for bit: K2 computes in its
order of operations; K1 and K3 screen every pair on the tensor cores
within a proven margin and confirm the pairs that can win in its float32
arithmetic (csrc/scan_tile.cuh). `LAUNCHES` counts kernel launches per
kernel: K1's and K3's wide kernels under their own keys.

Every wrapper and every plain version also takes a stack of files: the
same arguments with a leading file axis B on every tensor (and one n_valid
per file for K2, ints or an int32 tensor on the device, and for K4 an int32
tensor on the device). On the card a
stack is ONE launch, with the file as the slowest axis of the kernel's
grid; a single file is the B = 1 case of the same kernel. Each file is
scanned against its own bank and no reduction crosses files, so a file's
result does not depend on the stack it is in. The plain versions loop
over the files of a stack.

`pallas_blocks_ok` and `refine_blocks_ok` are the JAX package's gates for
its kernel path, copied so that the port takes the same branches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .affine import row_mean, row_sum

_NEG = float("-inf")
_EPS = 1e-12

#: Kernel launches since the last reset, per kernel (CPU calls, which take
#: the plain versions, are not counted). The wide K1 and K3 (range sizes
#: over 16) count under "search_scan_wide" and "topc_scan_wide".
LAUNCHES = {"search_scan": 0, "topc_scan": 0, "refine_window": 0, "window_stats": 0,
            "search_scan_wide": 0, "topc_scan_wide": 0, "staged_refine": 0,
            "staged_stats": 0, "bank_means": 0}
#: Serialized banks made since the last reset, one a file, by their source
#: (models/encode.py _encode_stack): "device", `bank_means` on an int16
#: stack (the kernel, or on a CPU tensor its plain version); "host",
#: ops/domains.py build_domains_host on a float stack.
BANK_BUILDS = {"device": 0, "host": 0}
#: The packing of compress_audio_packed since the last reset
#: (models/encode.py): per call 1 to "calls" and its signals to "clips";
#: per stack launched 1 to "stacks" and its files to "stack_files"; per
#: file of a stack n_ranges x n_domains to "valid_pairs" and its bucket's
#: mb x db to "grid_pairs", so that 1 - valid_pairs / grid_pairs is the
#: share of an exact scan's grid that is bucket padding. Counted on every
#: device, outside DEVICE_LOCK: exact for one calling thread.
PACKS = {"calls": 0, "clips": 0, "stacks": 0, "stack_files": 0, "valid_pairs": 0,
         "grid_pairs": 0}

_OBJECTIVES = {"balanced": 0, "affine": 1, "damped": 2}
#: Range sizes of K2 and its table (csrc/refine_window.cu). Wider ranges
#: never reach them: a range size over 16 comes with a tile of 4352 or
#: more and so a domain_step over 1, which the window refine's gate
#: (refine_blocks_ok) refuses, so models/encode.py _plan_search sends it to
#: the staged refine.
_KERNEL_N = range(4, 17)
#: Range sizes of K1 and K3: up to 16 the kernels of csrc/scan_tile.cuh
#: (N a template, A's fragments in registers), from 17 the wide ones of
#: csrc/scan_wide.cuh (N at run time, A's fragments in shared memory).
_SCAN_N = range(4, 256)
#: Domains per staged bank tile of K1 and K3 (csrc/scan_tile.cuh); the wide
#: kernels stage 128, 64 or 32 by N, and a domain split of K1 is a
#: multiple of 128 in every case.
_SCAN_TILE_D = 128
#: Ranges per block of K1 (csrc/scan_tile.cuh kRangesPerBlock), and of its
#: wide kernel (csrc/scan_wide.cuh WideShape<cls, 1>::kRanges).
_SCAN_RANGES = 128
_WIDE_RANGES = 32
#: Largest C of the top-C kernel (its list lives in registers).
_TOPC_MAX = 8
#: Most files of one K2 launch: a packed stack's bound (models/encode.py
#: PACK_B_MAX; csrc/refine_window.cu kMaxFiles).
_REFINE_MAX_FILES = 16
#: The refine window's box-mean budget on the TPU (bytes of means). The
#: card needs no such cap; the gate keeps it so that the port selects the
#: same geometries as the JAX kernel path until the cap is lifted.
_REFINE_VMEM_MEANS_BYTES = 9 << 20


def reset_launch_counts() -> None:
    """Zero LAUNCHES, BANK_BUILDS and PACKS."""
    for counts in (LAUNCHES, BANK_BUILDS, PACKS):
        for k in counts:
            counts[k] = 0


def pallas_blocks_ok(M: int, D: int, range_block: int, domain_block: int) -> bool:
    """The JAX kernel path's block constraint (fwav_tpu pallas_blocks_ok):
    the domain block divisible by 128 or equal to D, the range block
    divisible by 8 or equal to M."""
    return (
        (domain_block % 128 == 0 or domain_block == D)
        and (range_block % 8 == 0 or range_block == M)
    )


def refine_blocks_ok(M: int, range_block: int, stride: int, domain_step: int,
                     objective: str, db: int) -> bool:
    """The JAX kernel path's gate for the window refine (fwav_tpu
    refine_blocks_ok): domain_step 1, a stride that is a multiple of 128,
    whole range blocks, and a box-mean sequence within the 9 MB cap."""
    return (
        domain_step == 1
        and stride % 128 == 0
        and M % range_block == 0
        and range_block % 8 == 0
        and objective in _OBJECTIVES
        and db * 4 <= _REFINE_VMEM_MEANS_BYTES
    )


def _cuda_args(name, tensors, dtypes, device):
    """Check that every tensor is a contiguous CUDA tensor of its dtype on
    `device`; raise otherwise."""
    for (label, t), dt in zip(tensors.items(), dtypes):
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected {device}")
        if t.dtype not in dt:
            raise TypeError(f"{name}: {label} has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _fill_nums(r, b, no, nm, t):
    """num_o = r . b and num_m = reverse(r) . b for every (range, domain)
    pair of a block, summed tap by tap left to right (the kernels' order),
    into the preallocated no and nm; t is scratch."""
    N = r.shape[1]
    torch.mul(r[:, 0:1], b[0], out=no)
    torch.mul(r[:, N - 1 : N], b[0], out=nm)
    for j in range(1, N):
        no.add_(torch.mul(r[:, j : j + 1], b[j], out=t))
        nm.add_(torch.mul(r[:, N - 1 - j : N - j], b[j], out=t))


def _stack_of_one(*tensors):
    """Each tensor (None stays None) with a leading file axis of 1."""
    return tuple(None if t is None else t[None] for t in tensors)


def _check_scan_args(name, r_c, bankT, w, valid, thresh):
    """The K1/K3 wrappers' input checks on a stack; returns (B, M, N, D)."""
    B, M, N = r_c.shape
    D = bankT.shape[2]
    f32 = (torch.float32,)
    args = {"r_c": r_c, "bankT": bankT, "w": w, "valid": valid}
    types = [f32, f32, f32, (torch.int8, torch.bool)]
    if thresh is not None:
        args["thresh"] = thresh
        types.append(f32)
    _cuda_args(name, args, types, r_c.device)
    if bankT.shape != (B, N, D) or w.shape != (B, D) or valid.shape != (B, D) or (
        thresh is not None and thresh.shape != (B, D)
    ):
        raise ValueError(f"{name}: shapes disagree")
    if N not in _SCAN_N or M == 0 or D == 0 or not 1 <= B <= 65535:
        raise ValueError(f"{name}: no kernel for B={B}, M={M}, N={N}, D={D}")
    return B, M, N, D


# --- K1 -------------------------------------------------------------------


def search_scan_ref(r_c, bankT, w, valid, thresh=None, s_clip=0.0,
                    range_block: int = 2048, domain_block: int = 512):
    """Plain PyTorch K1, blocked over ranges and domains so no (M, D) score
    tensor exists; the block temporaries are reused in place. Returns
    (score (M,) float32, idx (M,) int32): the lowest-index maximum of
    max(s_o, s_m) over valid domains, -inf and 0 where none is valid. A
    stack (r_c (B, M, N), every other tensor with the same leading axis) is
    a loop over its files; returns (B, M) each."""
    if r_c.dim() == 3:
        per_file = [
            search_scan_ref(r_c[b], bankT[b], w[b], valid[b],
                            None if thresh is None else thresh[b], s_clip,
                            range_block, domain_block)
            for b in range(r_c.shape[0])
        ]
        return tuple(torch.stack(x) for x in zip(*per_file))
    M, N = r_c.shape
    D = bankT.shape[1]
    dev = r_c.device
    c = abs(float(s_clip))
    score = torch.empty(M, dtype=torch.float32, device=dev)
    idx = torch.empty(M, dtype=torch.int32, device=dev)
    shape = (min(range_block, M), min(domain_block, D))
    NO, NM, T, A = (torch.empty(shape, dtype=torch.float32, device=dev)
                    for _ in range(4))
    for r0 in range(0, M, range_block):
        r = r_c[r0 : r0 + range_block]
        rb = r.shape[0]
        best = torch.full((rb,), _NEG, dtype=torch.float32, device=dev)
        best_i = torch.zeros(rb, dtype=torch.int64, device=dev)
        for d0 in range(0, D, domain_block):
            b = bankT[:, d0 : d0 + domain_block]
            db = b.shape[1]
            no, nm, t, a = NO[:rb, :db], NM[:rb, :db], T[:rb, :db], A[:rb, :db]
            _fill_nums(r, b, no, nm, t)
            wk = w[d0 : d0 + db]
            tk = None if thresh is None else thresh[d0 : d0 + db]
            for num in (no, nm):  # each becomes its orientation's gain
                if tk is not None:
                    torch.abs(num, out=a)
                    clip = a > tk
                    a.mul_(2.0).sub_(tk).mul_(c)  # c * (2|num| - t)
                num.mul_(num).mul_(wk)            # num^2 * w
                if tk is not None:
                    torch.where(clip, a, num, out=num)
            torch.maximum(no, nm, out=t)
            t.masked_fill_(valid[d0 : d0 + db] == 0, _NEG)
            arg = torch.argmax(t, dim=1)  # first max
            g = t.gather(1, arg[:, None])[:, 0]
            upd = g > best  # strict: the earlier block wins ties
            best = torch.where(upd, g, best)
            best_i = torch.where(upd, arg + d0, best_i)
        score[r0 : r0 + rb] = best
        idx[r0 : r0 + rb] = best_i.to(torch.int32)
    return score, idx


def search_scan(r_c, bankT, w, valid, thresh=None, s_clip=0.0):
    """K1: per range, the lowest-index argmax over domains of the
    orientation-folded gain max(num_o^2 w, num_m^2 w) (clip-aware where
    `thresh` is given), -inf for invalid domains. r_c (M, N) centered
    ranges, bankT (N, D), w (D,), valid (D,) int8 or bool, thresh (D,) or
    None. Returns (score (M,) float32, idx (M,) int32). A stack of files
    (r_c (B, M, N), bankT (B, N, D), w, valid, thresh (B, D)) is one
    launch and returns (B, M) each."""
    dev = r_c.device
    if dev.type == "cpu":
        return search_scan_ref(r_c, bankT, w, valid, thresh, s_clip)
    if dev.type != "cuda":
        raise ValueError(f"search_scan: unsupported device {dev}")
    if r_c.dim() == 2:
        score, idx = search_scan(*_stack_of_one(r_c, bankT, w, valid, thresh), s_clip)
        return score[0], idx[0]
    B, M, N, D = _check_scan_args("search_scan", r_c, bankT, w, valid, thresh)

    from . import _build

    lib = _build.load()
    # split the domains over blockIdx.y when the ranges of all files would
    # leave the card's SMs idle (the exact branch: few ranges, a large bank)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    range_blocks = B * -(-M // (_SCAN_RANGES if N in _KERNEL_N else _WIDE_RANGES))
    tiles = -(-D // _SCAN_TILE_D)
    n_split = max(1, min(-(-4 * sms // range_blocks), tiles))
    d_per_split = -(-tiles // n_split) * _SCAN_TILE_D
    n_split = -(-D // d_per_split)
    score = torch.empty((B, M), dtype=torch.float32, device=dev)
    idx = torch.empty((B, M), dtype=torch.int32, device=dev)
    if n_split > 1:
        part_s = torch.empty((B, n_split, M), dtype=torch.float32, device=dev)
        part_i = torch.empty((B, n_split, M), dtype=torch.int32, device=dev)
    else:
        part_s, part_i = score, idx
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fwav_search_scan(
            _ptr(r_c), _ptr(bankT), _ptr(w), _ptr(valid),
            _ptr(thresh) if thresh is not None else None,
            abs(float(s_clip)), B, M, N, D, n_split, d_per_split,
            _ptr(part_s), _ptr(part_i), _ptr(score), _ptr(idx),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "search_scan")
    LAUNCHES["search_scan" if N in _KERNEL_N else "search_scan_wide"] += 1
    return score, idx


# --- K3 -------------------------------------------------------------------


def topc_scan_ref(r_c, bankT, w, valid, top_c: int, thresh=None, s_clip=0.0,
                  range_block: int = 2048, domain_block: int = 512):
    """Plain PyTorch K3, blocked over ranges and domains so no (M, D) score
    tensor exists. Per domain block it runs top_c rounds of first-max
    argmax and mask; each extracted candidate is inserted into the carried
    sorted list behind every entry of an equal or higher score, so the
    list is the stable order (score descending, lower domain index first)
    whatever the block sizes. torch.topk promises no order on ties and is
    not used. Returns idx (M, top_c) int32, -1 where the score is not
    finite.

    The TPU kernel's cascade differs on exact ties: an entry it displaces
    moves on with a strict > and lands behind later entries of its own
    score, so its order of equal scores depends on its domain block. This
    version keeps the order of its oracle, gain_topk_scan.

    A stack (r_c (B, M, N), every other tensor with the same leading axis)
    is a loop over its files; returns (B, M, top_c)."""
    if r_c.dim() == 3:
        return torch.stack([
            topc_scan_ref(r_c[b], bankT[b], w[b], valid[b], top_c,
                          None if thresh is None else thresh[b], s_clip,
                          range_block, domain_block)
            for b in range(r_c.shape[0])
        ])
    M, N = r_c.shape
    D = bankT.shape[1]
    dev = r_c.device
    c = abs(float(s_clip))
    out = torch.empty((top_c, M), dtype=torch.int32, device=dev)
    shape = (min(range_block, M), min(domain_block, D))
    NO, NM, T, A = (torch.empty(shape, dtype=torch.float32, device=dev)
                    for _ in range(4))
    for r0 in range(0, M, range_block):
        r = r_c[r0 : r0 + range_block]
        rb = r.shape[0]
        best_s = [torch.full((rb,), _NEG, dtype=torch.float32, device=dev)
                  for _ in range(top_c)]
        best_i = [torch.zeros(rb, dtype=torch.int64, device=dev)
                  for _ in range(top_c)]
        for d0 in range(0, D, domain_block):
            b = bankT[:, d0 : d0 + domain_block]
            db = b.shape[1]
            no, nm, t, a = NO[:rb, :db], NM[:rb, :db], T[:rb, :db], A[:rb, :db]
            _fill_nums(r, b, no, nm, t)
            wk = w[d0 : d0 + db]
            if thresh is not None:
                # damped: the orientations fold BEFORE the clip branch
                tk = thresh[d0 : d0 + db]
                torch.maximum(no.abs_(), nm.abs_(), out=a)
                clip = a > tk
                torch.mul(a, a, out=t).mul_(wk)     # a^2 w
                a.mul_(2.0).sub_(tk).mul_(c)        # c (2a - t)
                torch.where(clip, a, t, out=t)
            else:
                # per orientation before the max: balanced w can be negative
                no.mul_(no).mul_(wk)
                nm.mul_(nm).mul_(wk)
                torch.maximum(no, nm, out=t)
            t.masked_fill_(valid[d0 : d0 + db] == 0, _NEG)
            for _ in range(top_c):
                arg = torch.argmax(t, dim=1)[:, None]  # first max
                cur_s = t.gather(1, arg)[:, 0]
                cur_i = arg[:, 0] + d0
                t.scatter_(1, arg, _NEG)
                # insert after every carried entry of an equal or higher
                # score (strict >); the entries behind it shift down one
                # place in their order, whatever their scores
                moving = torch.zeros(rb, dtype=torch.bool, device=dev)
                for k in range(top_c):
                    take = moving | (cur_s > best_s[k])
                    best_s[k], cur_s = (torch.where(take, cur_s, best_s[k]),
                                        torch.where(take, best_s[k], cur_s))
                    best_i[k], cur_i = (torch.where(take, cur_i, best_i[k]),
                                        torch.where(take, best_i[k], cur_i))
                    moving = take
        for k in range(top_c):
            out[k, r0 : r0 + rb] = torch.where(torch.isfinite(best_s[k]), best_i[k], -1)
    return out.T


def topc_scan(r_c, bankT, w, valid, top_c: int, thresh=None, s_clip=0.0):
    """K3: per range, the top_c domains by orientation-folded gain, sorted
    by score with the lower index first on ties: max(num_o^2 w, num_m^2 w),
    or with `thresh` (damped) a = max(|num_o|, |num_m|) scored c(2a - t)
    where a > t, else a^2 w. Invalid domains never enter the list. Inputs
    as search_scan's; 1 <= top_c <= 8. Returns idx (M, top_c) int32, -1
    where fewer than top_c domains have a finite score.

    The result is the transposed view of a (top_c, M) tensor (each lobe
    column idx[:, c] is contiguous); refine_window reads it through its
    strides, without a copy. A stack of files (a leading axis B on every
    tensor) is one launch and returns (B, M, top_c), the view of a
    (B, top_c, M) tensor."""
    if not 1 <= top_c <= _TOPC_MAX:
        raise ValueError(f"topc_scan: top_c={top_c} is outside 1..{_TOPC_MAX}")
    dev = r_c.device
    if dev.type == "cpu":
        return topc_scan_ref(r_c, bankT, w, valid, top_c, thresh, s_clip)
    if dev.type != "cuda":
        raise ValueError(f"topc_scan: unsupported device {dev}")
    if r_c.dim() == 2:
        return topc_scan(*_stack_of_one(r_c, bankT, w, valid), top_c,
                         *_stack_of_one(thresh), s_clip)[0]
    B, M, N, D = _check_scan_args("topc_scan", r_c, bankT, w, valid, thresh)

    from . import _build

    lib = _build.load()
    out = torch.empty((B, top_c, M), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fwav_topc_scan(
            _ptr(r_c), _ptr(bankT), _ptr(w), _ptr(valid),
            _ptr(thresh) if thresh is not None else None,
            abs(float(s_clip)), B, M, N, D, top_c, _ptr(out),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "topc_scan")
    LAUNCHES["topc_scan" if N in _KERNEL_N else "topc_scan_wide"] += 1
    return out.transpose(1, 2)


# --- K2 -------------------------------------------------------------------


def _window_taps(means_ext, q, n: int, block_len: int):
    """The n taps means_ext[q + j*block_len] of every index in q, zeros
    past the end of the sequence."""
    L = means_ext.shape[0]
    taps = []
    for j in range(n):
        qj = q + j * block_len
        taps.append(torch.where(qj < L, means_ext[qj.clamp(max=L - 1)], 0.0))
    return taps


def _position_stats(v, n: int):
    """(mean, denom, denom + eps) of the taps v of every position, in the
    kernels' order of operations."""
    mean = v[0]
    for vj in v[1:]:
        mean = mean + vj
    mean = mean * (1.0 / n)
    denom = torch.zeros_like(mean)
    for vj in v:
        d = vj - mean
        denom = denom + d * d
    return mean, denom, denom + 1e-12


def _balanced_weight(mean, denom, denom_eps, n: int):
    return (denom - n * mean * mean) / (denom_eps * denom_eps)


def window_stats_ref(means_ext, n: int, block_len: int, objective: str = "balanced"):
    """Plain PyTorch version of `window_stats`: what K2's score needs of a
    position q of means_ext alone (taps means_ext[q + j*block_len], zeros
    past the end), in refine_window_ref's arithmetic. Returns (L,)
    float32: the balanced weight; for affine and damped the taps' centered
    energy denom (denom + eps and the damped clip threshold c*denom are
    one operation each from it). A stack means_ext (B, L) is a loop over
    its files; returns (B, L)."""
    if objective not in _OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    if means_ext.dim() == 2:
        return torch.stack([window_stats_ref(m, n, block_len, objective)
                            for m in means_ext])
    q = torch.arange(means_ext.shape[0], device=means_ext.device)
    mean, denom, denom_eps = _position_stats(
        _window_taps(means_ext, q, n, block_len), n)
    if objective == "balanced":
        return _balanced_weight(mean, denom, denom_eps, n)
    return denom


def window_stats(means_ext, n: int, block_len: int, objective: str = "balanced"):
    """The per-position table of K2 (see window_stats_ref), computed once
    per box-mean sequence by its own kernel on a CUDA tensor; a stack
    means_ext (B, L) is one launch and returns (B, L)."""
    dev = means_ext.device
    if dev.type == "cpu":
        return window_stats_ref(means_ext, n, block_len, objective)
    if dev.type != "cuda":
        raise ValueError(f"window_stats: unsupported device {dev}")
    if means_ext.dim() == 1:
        return window_stats(means_ext[None], n, block_len, objective)[0]
    _cuda_args("window_stats", {"means_ext": means_ext}, [(torch.float32,)], dev)
    B, L = means_ext.shape if means_ext.dim() == 2 else (0, 0)
    if n not in _KERNEL_N or L == 0 or objective not in _OBJECTIVES or not 1 <= B <= 65535:
        raise ValueError(
            f"window_stats: no kernel for means_ext {tuple(means_ext.shape)}, "
            f"N={n}, objective={objective!r}{_K2_RANGE_NOTE}"
        )

    from . import _build

    lib = _build.load()
    out = torch.empty((B, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fwav_window_stats(
            _ptr(means_ext), B, L, n, int(block_len), _OBJECTIVES[objective],
            np.float32(1.0 / n).item(), _ptr(out), ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "window_stats")
    LAUNCHES["window_stats"] += 1
    return out


#: Why K2 and its table stop at 16 taps, for their error messages.
_K2_RANGE_NOTE = (
    " (the window refine's kernels take range sizes 4..16: a wider range "
    "comes with a domain_step over 1, which models/encode.py _plan_search "
    "sends to the staged refine)"
)


def check_refine_lead(L: int, n_valid, stride: int) -> None:
    """K2's size check on the host ints of a call: the box-mean sequence
    of L values holds the stride-wide lead and every file's n_valid
    positions. The wrapper runs it where it is given ints; a caller that
    passes n_valid as a device tensor (a program captured in a CUDA graph)
    runs it on its own host counts, on every call."""
    top = max(int(v) for v in n_valid)
    if L < top + stride:
        raise ValueError(
            f"refine_window: means_ext holds {L} values, fewer than the "
            f"stride-wide lead and n_valid = {top} positions"
        )


def _refine_one_lobe(means_ext, lobes, ranges, n_valid, stride: int,
                     block_len: int, objective: str, s_clip: float):
    """refine_window_ref for one lobe per range, blocked over ranges;
    n_valid an int or an integer tensor of one element."""
    range_block = 16384
    M, n = ranges.shape
    dev = ranges.device
    W = stride + stride // 4
    half = W // 2
    c = abs(float(s_clip))
    t = torch.arange(W, device=dev)
    # read on the data's device: a tensor's value never goes to the host
    n_valid = torch.as_tensor(n_valid, device=dev).reshape(()).to(torch.int64)
    last = (n_valid - 1).clamp(min=0)
    score = torch.empty(M, dtype=torch.float32, device=dev)
    idx = torch.empty(M, dtype=torch.int32, device=dev)
    for r0 in range(0, M, range_block):
        lob = lobes[r0 : r0 + range_block].to(torch.int64)
        lb = lob.clamp(min=0)
        r = ranges[r0 : r0 + range_block]
        rc = r - row_mean(r)[:, None]
        p0 = lb * stride - half                       # position of t = 0
        q = (p0 + stride)[:, None] + t[None, :]       # its index in means_ext
        v = _window_taps(means_ext, q, n, block_len)
        mean, denom, denom_eps = _position_stats(v, n)
        no = rc[:, 0:1] * v[0]
        nm = rc[:, n - 1 : n] * v[0]
        for j in range(1, n):
            no = no + rc[:, j : j + 1] * v[j]
            nm = nm + rc[:, n - 1 - j : n - j] * v[j]
        if objective == "balanced":
            wgt = _balanced_weight(mean, denom, denom_eps, n)
            sc = torch.maximum(no * no, nm * nm) * wgt
        elif objective == "damped":
            a = torch.maximum(no.abs(), nm.abs())
            th = c * denom
            sc = torch.where(a > th, c * (2.0 * a - th), a * a / denom_eps)
        elif objective == "affine":
            sc = torch.maximum(no * no, nm * nm) / denom_eps
        else:
            raise ValueError(f"unknown objective {objective!r}")
        pos = p0[:, None] + t[None, :]
        ok = (pos >= 0) & (pos < n_valid) & (lob[:, None] >= 0)
        sc = torch.where(ok, sc, _NEG)
        arg = torch.argmax(sc, dim=1)  # first max
        score[r0 : r0 + range_block] = sc.gather(1, arg[:, None])[:, 0]
        idx[r0 : r0 + range_block] = torch.minimum((p0 + arg).clamp(min=0),
                                                   last).to(torch.int32)
    return score, idx


def refine_window_ref(means_ext, lobes, ranges, n_valid, stride: int,
                      block_len: int, objective: str = "balanced",
                      s_clip: float = 16.0):
    """Plain PyTorch K2. lobes (M,) or (M, C): each lobe column is refined
    on its own and a later column takes a range only with a strictly higher
    score (the earlier lobe wins ties). n_valid is an int or an integer
    tensor of one element, read on the data's device. Returns (score (M,)
    float32, idx (M,) int32). A stack (means_ext (B, L), lobes (B, M) or
    (B, M, C), ranges (B, M, N), n_valid B ints or a (B,) integer tensor)
    is a loop over its files; returns (B, M) each."""
    if ranges.dim() == 3:
        per_file = [
            refine_window_ref(means_ext[b], lobes[b], ranges[b], n_valid[b],
                              stride, block_len, objective, s_clip)
            for b in range(ranges.shape[0])
        ]
        return tuple(torch.stack(x) for x in zip(*per_file))
    cols = [lobes] if lobes.dim() == 1 else list(lobes.unbind(1))
    best = None
    for col in cols:
        s_k, i_k = _refine_one_lobe(means_ext, col, ranges, n_valid, stride,
                                    block_len, objective, s_clip)
        if best is None:
            best = (s_k, i_k)
        else:
            take = s_k > best[0]  # strict: the earlier lobe wins ties
            best = (torch.where(take, s_k, best[0]), torch.where(take, i_k, best[1]))
    return best


def refine_window(means_ext, lobes, ranges, n_valid, stride: int,
                  block_len: int, objective: str = "balanced",
                  s_clip: float = 16.0, stats=None):
    """K2: per range and coarse lobe L (-1 = none), the best of the
    W = stride + stride/4 positions p = L*stride - W/2 + t of the box-mean
    sequence (tap j = means[p + j*block_len]; means_ext (Lext,) holds a
    stride-wide zero lead), by the balanced, affine or damped gain;
    positions outside [0, n_valid) score -inf. lobes is (M,), or (M, C)
    with the lobes of a range in its row (contiguous, or the transposed
    view that topc_scan returns): one launch walks every lobe of a range,
    and the first max in (lobe, position) order wins, so the earlier lobe
    wins ties. `stats` is window_stats(...) of the same means_ext, range
    size, block_len and objective, computed here when not given.
    Returns (score (M,) float32, idx (M,) int32 clipped to
    [0, n_valid - 1]).

    A stack of up to 16 files is one launch: means_ext (B, L), lobes
    (B, M) or (B, M, C) with any strides, ranges (B, M, N), n_valid one
    count per file (the files of a stack share every size but this one),
    stats (B, L); returns (B, M) each.

    n_valid is ints (an int for one file), which are checked here
    (check_refine_lead) and copied to the device through pinned memory,
    or an int32 tensor on the device, (B,) or one element for one file,
    which the kernel reads there: nothing of it is then baked into a
    captured launch, and the caller runs check_refine_lead on its host
    counts. Under a CUDA graph capture n_valid must be the tensor."""
    dev = ranges.device
    if dev.type == "cpu":
        return refine_window_ref(means_ext, lobes, ranges, n_valid, stride,
                                 block_len, objective, s_clip)
    if dev.type != "cuda":
        raise ValueError(f"refine_window: unsupported device {dev}")
    if ranges.dim() == 2:
        nv = n_valid.reshape(1) if torch.is_tensor(n_valid) else [int(n_valid)]
        score, idx = refine_window(
            *_stack_of_one(means_ext, lobes, ranges), nv, stride,
            block_len, objective, s_clip, *_stack_of_one(stats))
        return score[0], idx[0]
    B, M, n = ranges.shape
    if (means_ext.dim() != 2 or lobes.dim() not in (2, 3) or lobes.shape[:2] != (B, M)
            or means_ext.shape[0] != B or len(n_valid) != B):
        raise ValueError("refine_window: shapes disagree")
    if (n not in _KERNEL_N or M == 0 or lobes.numel() == 0 or objective not in _OBJECTIVES
            or B > _REFINE_MAX_FILES):
        raise ValueError(
            f"refine_window: no kernel for B={B}, M={M}, N={n}, lobes "
            f"{tuple(lobes.shape)}, objective={objective!r}{_K2_RANGE_NOTE}"
        )
    L = means_ext.shape[1]
    if torch.is_tensor(n_valid):
        if (n_valid.shape != (B,) or n_valid.dtype != torch.int32 or n_valid.device != dev
                or not n_valid.is_contiguous()):
            raise TypeError(f"refine_window: n_valid is {n_valid.dtype} {tuple(n_valid.shape)} "
                            f"on {n_valid.device}, expected int32 ({B},) on {dev}")
    else:
        check_refine_lead(L, n_valid, stride)
        if torch.cuda.is_current_stream_capturing():
            raise TypeError("refine_window: under a graph capture n_valid must be an int32 "
                            "tensor on the device, not host ints")
        n_valid = torch.tensor([int(v) for v in n_valid], dtype=torch.int32).pin_memory()
        n_valid = n_valid.to(dev, non_blocking=True)
    if stats is None:
        stats = window_stats(means_ext, n, block_len, objective)
    elif stats.shape != (B, L):
        raise ValueError("refine_window: stats is not window_stats of this means_ext")
    f32 = (torch.float32,)
    _cuda_args(
        "refine_window", {"means_ext": means_ext, "stats": stats, "ranges": ranges},
        [f32, f32, f32], dev,
    )
    # the kernel reads lobes through its strides: any layout, no copy
    if lobes.device != dev or lobes.dtype != torch.int32:
        raise TypeError(f"refine_window: lobes is {lobes.dtype} on {lobes.device}, "
                        f"expected int32 on {dev}")
    C = 1 if lobes.dim() == 2 else lobes.shape[2]
    stride_b, stride_m = lobes.stride(0), lobes.stride(1)
    stride_c = 0 if lobes.dim() == 2 else lobes.stride(2)

    from . import _build

    lib = _build.load()
    score = torch.empty((B, M), dtype=torch.float32, device=dev)
    idx = torch.empty((B, M), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fwav_refine_window(
            _ptr(means_ext), _ptr(stats), B, L, _ptr(lobes), C, stride_b, stride_m,
            stride_c, _ptr(ranges), M, n, _ptr(n_valid), int(stride),
            int(block_len),
            _OBJECTIVES[objective], np.float32(abs(float(s_clip))).item(),
            _ptr(score), _ptr(idx), ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "refine_window")
    LAUNCHES["refine_window"] += 1
    return score, idx


# --- K4 -------------------------------------------------------------------

#: Ranges per block of staged_refine_ref: the blocks bound the gathered
#: rows, as the JAX package's lax.map blocks (EncoderConfig.range_block) do.
_STAGED_REF_BLOCK = 32768


def domain_thresh(d_denom, objective: str, s_clip: float):
    """Per-domain clip threshold t = s_clip * denom for "damped" (None for
    every other objective): the optimal scale num/denom clips exactly when
    |num| > t."""
    if objective != "damped":
        return None
    return abs(s_clip) * d_denom


def _gain_from_num(num, weight, thresh, s_clip):
    """Selection gain of one orientation: num^2 * w, or with `thresh` the
    clip-aware gain, c*(2|num| - t) where |num| > t (c = s_clip)."""
    g = num * num * weight
    if thresh is None:
        return g
    a = torch.abs(num)
    c = abs(s_clip)
    return torch.where(a > thresh, c * (2.0 * a - thresh), g)


def _window_gains(r_c, bank, cand, valid, objective: str, s_clip):
    """Gains and orientation pick of per-range candidate rows. r_c (N, M)
    centered ranges, transposed; bank (D, N); cand (K, M) int64 rows in
    [0, D); valid (K, M). Returns (score, use_m), each (K, M), score -inf
    where not valid. The sums over N run left to right in the (N, K, M)
    layout of the JAX function."""
    N = r_c.shape[0]
    K, M = cand.shape
    tiles = bank.index_select(0, cand.reshape(-1)).T.reshape(N, K, M)

    def over_n(x):  # (N, K, M) -> (K, M), left to right
        return row_sum(x.movedim(0, -1))

    d_mean = row_mean(tiles.movedim(0, -1))
    d_c = tiles - d_mean[None]
    denom = over_n(d_c * d_c) + _EPS
    num_o = over_n(d_c * r_c[:, None, :])
    num_m = over_n(d_c * r_c.flip(0)[:, None, :])
    if objective == "balanced":
        w = (denom - _EPS - N * d_mean * d_mean) / (denom * denom)
    else:
        w = torch.reciprocal(denom)
    thresh = domain_thresh(denom - _EPS, objective, s_clip)
    score_o = _gain_from_num(num_o, w, thresh, s_clip)
    score_m = _gain_from_num(num_m, w, thresh, s_clip)
    use_m = score_m > score_o  # strict: the original orientation wins ties
    score = torch.where(use_m, score_m, score_o)
    return torch.where(valid, score, _NEG), use_m


def refine_from_lobes(ranges, bank, n_valid, coarse, stride: int,
                      s_clip: float, objective: str = "balanced"):
    """The window refine around coarse lobes, staged: ranges (M, N); bank
    (D, N), the full bank with its rows from n_valid on invalid; coarse
    (M, C) lobes in the stride-subsampled index space, -1 for none;
    n_valid an int or an integer tensor of one element, read on the data's
    device (so that a program built on it reads no count on the host).

    The window of each lobe is W = stride + stride/4 rows starting at
    lobe*stride - W/2, clamped to [0, n_valid - W]. With one lobe column
    and stride >= 32 (the global pass always) the window is sampled at
    step 16 and then 4 (8 alone for W < 64), each stage keeping the first
    best sample, and only a dense window of step + 2 rows around the last
    one is scored in full; otherwise all C*W rows are. Rows at or past
    n_valid never win: padding rows score exactly 0, which beats a
    negative balanced gain. Returns (idx (M,) int32, score (M,) float32)
    of the first best candidate; the score is -inf where the range has no
    lobe. The JAX function's refit outputs (s, o, sym, err) are not
    ported: only the selection leaves the device and the host refits it.
    The plain version of K4 (ops/kernels.py staged_refine), which runs it
    over a stack on the card (staged_refine_ref)."""
    M, N = ranges.shape
    D = bank.shape[0]
    dev = ranges.device
    top_c = coarse.shape[1]
    W = max(2, stride + stride // 4)
    n_valid = torch.as_tensor(n_valid, device=dev).reshape(()).to(torch.int64)
    last = (n_valid - 1).clamp(min=0)
    lobe_ok = coarse >= 0                                        # (M, C)
    starts = torch.minimum((coarse.to(torch.int64) * stride - W // 2).clamp(min=0),
                           (n_valid - W).clamp(min=0))
    cand = (starts.T[:, None, :]
            + torch.arange(W, device=dev)[None, :, None]).reshape(top_c * W, M)
    valid = lobe_ok.T[:, None, :].expand(top_c, W, M).reshape(top_c * W, M)
    r_c = (ranges - row_mean(ranges)[:, None]).T                 # (N, M)
    cols = torch.arange(M, device=dev)

    if stride >= 32 and top_c == 1:
        steps = (16, 4) if W >= 64 else (8,)
        st = steps[0]
        k1 = W // st + 1
        mid = torch.minimum(starts.T[:, None, :]
                            + (st * torch.arange(k1, device=dev))[None, :, None],
                            last).reshape(top_c * k1, M)
        v1 = lobe_ok.T[:, None, :].expand(top_c, k1, M).reshape(top_c * k1, M)
        v1 = v1 & (mid < n_valid)
        s1, _ = _window_gains(r_c, bank, mid.clamp(max=D - 1), v1, objective, s_clip)
        center = mid[s1.argmax(0), cols]                         # first max
        ok_any = lobe_ok.any(1)
        for st2 in steps[1:]:
            # cover center +/- st/2 at the finer step st2
            u = st // 2
            k = 2 * u // st2 + 1
            mid = torch.minimum(((center[None, :] - u)
                                 + st2 * torch.arange(k, device=dev)[:, None]).clamp(min=0),
                                last)
            vk = ok_any[None, :].expand(k, M) & (mid < n_valid)
            sk, _ = _window_gains(r_c, bank, mid.clamp(max=D - 1), vk, objective, s_clip)
            center = mid[sk.argmax(0), cols]
            st = st2
        # the dense final window: +/- st/2, with one row of margin
        w2 = st + 2
        starts2 = torch.minimum((center - w2 // 2).clamp(min=0), (n_valid - w2).clamp(min=0))
        cand = starts2[None, :] + torch.arange(w2, device=dev)[:, None]
        valid = ok_any[None, :].expand(w2, M)

    valid = valid & (cand < n_valid)
    cand = cand.clamp(max=D - 1)  # jnp.take's clamp, explicit here
    score, _ = _window_gains(r_c, bank, cand, valid, objective, s_clip)
    pick = score.argmax(0)                                       # first max
    return cand[pick, cols].to(torch.int32), score[pick, cols]


def staged_refine_ref(ranges, bank, n_valid, lobes, stride: int, objective: str = "balanced",
                      s_clip: float = 16.0, per_lobe: bool = False):
    """Plain PyTorch K4: refine_from_lobes, in blocks of _STAGED_REF_BLOCK
    ranges (every range is refined on its own, so the result does not
    depend on them). With `per_lobe` each lobe column is refined alone and
    a later column takes a range only with a strictly higher score (the
    global pass's merge); idx 0 and -inf where no column scores. n_valid is an int or an integer tensor, read on the data's
    device. Returns (idx (M,) int32, score (M,) float32). A stack (ranges
    (B, M, N), bank (B, D, N), lobes (B, M, C), n_valid B counts) is a loop
    over its files; returns (B, M) each."""
    dev = ranges.device
    if ranges.dim() == 3:
        nv = torch.as_tensor(n_valid, device=dev).reshape(-1)
        per_file = [staged_refine_ref(ranges[b], bank[b], nv[b], lobes[b], stride, objective,
                                      s_clip, per_lobe)
                    for b in range(ranges.shape[0])]
        return tuple(torch.stack(x) for x in zip(*per_file))
    idx, score = [], []
    blk = _STAGED_REF_BLOCK
    for r0 in range(0, ranges.shape[0], blk):
        r, lob = ranges[r0 : r0 + blk], lobes[r0 : r0 + blk]
        if not per_lobe:
            i, s = refine_from_lobes(r, bank, n_valid, lob, stride, s_clip, objective)
        else:
            i = torch.zeros(r.shape[0], dtype=torch.int32, device=dev)
            s = torch.full((r.shape[0],), _NEG, dtype=torch.float32, device=dev)
            for c in range(lob.shape[1]):
                i_c, s_c = refine_from_lobes(r, bank, n_valid, lob[:, c : c + 1], stride,
                                             s_clip, objective)
                take = s_c > s  # strict: the earlier lobe wins ties
                s, i = torch.where(take, s_c, s), torch.where(take, i_c, i)
        idx.append(i)
        score.append(s)
    return torch.cat(idx), torch.cat(score)


def staged_uses_table(N: int, stride: int, C: int, per_lobe: bool) -> bool:
    """Whether K4 scores through its per-row table (staged_stats): dense
    windows, and every range size over 16. A descent at up to 16 taps (one
    lobe column at stride >= 32) scores 5 to 52 rows a bank row, each a
    scattered read of a sector that holds the row anyway, so there the
    kernel computes a row's terms as it scores it and no table is made."""
    descent = stride >= 32 and (per_lobe or C == 1)
    return N > 16 or not descent


def staged_stats_ref(bank, objective: str = "balanced", s_clip: float = 16.0):
    """Plain PyTorch version of `staged_stats`: what _window_gains computes
    of one bank row alone, in its order of operations. bank (D, N); returns
    (D, 4) float32 rows [mean, w, th, 0]: the row's mean, the balanced
    weight (denom - eps - N mean^2) / denom^2 or the affine and damped
    1 / denom, where denom is the centred energy + eps, and the damped clip
    threshold |s_clip| (denom - eps), 0 for the other objectives. A stack
    bank (B, D, N) is a loop over its files."""
    if objective not in _OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}")
    if bank.dim() == 3:
        return torch.stack([staged_stats_ref(b, objective, s_clip) for b in bank])
    D, N = bank.shape
    d_mean = row_mean(bank)
    d_c = bank - d_mean[:, None]
    denom = row_sum(d_c * d_c) + _EPS
    if objective == "balanced":
        w = (denom - _EPS - N * d_mean * d_mean) / (denom * denom)
    else:
        w = torch.reciprocal(denom)
    thresh = domain_thresh(denom - _EPS, objective, s_clip)
    out = torch.zeros((D, 4), dtype=torch.float32, device=bank.device)
    out[:, 0] = d_mean
    out[:, 1] = w
    if thresh is not None:
        out[:, 2] = thresh
    return out


def staged_stats(bank, objective: str = "balanced", s_clip: float = 16.0):
    """K4's per-row table (see staged_stats_ref), made once per bank by its
    own kernel on a CUDA tensor, one thread a row. A stack bank (B, D, N)
    is one launch and returns (B, D, 4)."""
    dev = bank.device
    if dev.type == "cpu":
        return staged_stats_ref(bank, objective, s_clip)
    if dev.type != "cuda":
        raise ValueError(f"staged_stats: unsupported device {dev}")
    if bank.dim() == 2:
        return staged_stats(bank[None], objective, s_clip)[0]
    _cuda_args("staged_stats", {"bank": bank}, [(torch.float32,)], dev)
    B, D, N = bank.shape if bank.dim() == 3 else (0, 0, 0)
    if N not in _SCAN_N or D == 0 or objective not in _OBJECTIVES or not 1 <= B <= 65535:
        raise ValueError(f"staged_stats: no kernel for bank {tuple(bank.shape)}, "
                         f"objective={objective!r}")

    from . import _build

    lib = _build.load()
    out = torch.empty((B, D, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fwav_staged_stats(
            _ptr(bank), B * D, N, _OBJECTIVES[objective], np.float32(abs(float(s_clip))).item(),
            _ptr(out), ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "staged_stats")
    LAUNCHES["staged_stats"] += 1
    return out


def staged_refine(ranges, bank, n_valid, lobes, stride: int, objective: str = "balanced",
                  s_clip: float = 16.0, per_lobe: bool = False):
    """K4: the staged window refine around coarse lobes (see
    staged_refine_ref and refine_from_lobes) over the full
    bank. ranges (M, N) float32, 4 <= N <= 255 (not centred); bank (D, N)
    float32, its rows from n_valid on invalid; lobes (M, C) int32 in the
    stride-subsampled index space, -1 for none, any strides (K3's
    transposed view included); n_valid an int32 tensor on the device of one
    element. With one lobe column and stride >= 32 the staged descent runs,
    else all C * W rows are scored; `per_lobe` refines each column alone
    and keeps the earlier lobe on ties (the global pass). Where
    staged_uses_table says it pays, the bank's table is made first
    (staged_stats, a launch of its own); elsewhere the kernel computes each
    row's terms as it scores it. Returns (idx (M,) int32, score (M,)
    float32).

    A stack of files (a leading axis B on ranges, bank and lobes;
    n_valid (B,)) is one launch, with the file as the slowest axis of the
    grid; returns (B, M) each. n_valid is read from device memory, so
    nothing of it is baked into a captured launch."""
    dev = ranges.device
    if dev.type == "cpu":
        return staged_refine_ref(ranges, bank, n_valid, lobes, stride, objective, s_clip,
                                 per_lobe)
    if dev.type != "cuda":
        raise ValueError(f"staged_refine: unsupported device {dev}")
    if not torch.is_tensor(n_valid):
        raise TypeError("staged_refine: n_valid must be an int32 tensor on the device")
    if ranges.dim() == 2:
        r, b, lob = _stack_of_one(ranges, bank, lobes)
        idx, score = staged_refine(r, b, n_valid.reshape(1), lob, stride, objective, s_clip,
                                   per_lobe)
        return idx[0], score[0]
    B, M, N = ranges.shape
    if bank.dim() != 3 or bank.shape[0] != B or bank.shape[2] != N or lobes.dim() != 3 or (
            lobes.shape[:2] != (B, M)):
        raise ValueError("staged_refine: shapes disagree")
    f32 = (torch.float32,)
    _cuda_args("staged_refine", {"ranges": ranges, "bank": bank, "n_valid": n_valid},
               [f32, f32, (torch.int32,)], dev)
    if n_valid.shape != (B,):
        raise ValueError(f"staged_refine: n_valid is {tuple(n_valid.shape)}, expected ({B},)")
    if lobes.device != dev or lobes.dtype != torch.int32:
        raise TypeError(f"staged_refine: lobes is {lobes.dtype} on {lobes.device}, "
                        f"expected int32 on {dev}")
    D, C = bank.shape[1], lobes.shape[2]
    if (N not in _SCAN_N or M == 0 or D == 0 or C == 0 or stride < 1
            or objective not in _OBJECTIVES or not 1 <= B <= 65535):
        raise ValueError(f"staged_refine: no kernel for B={B}, M={M}, N={N}, D={D}, C={C}, "
                         f"stride={stride}, objective={objective!r}")
    stats = staged_stats(bank, objective, s_clip) if staged_uses_table(
        N, stride, C, per_lobe) else None

    from . import _build

    lib = _build.load()
    idx = torch.empty((B, M), dtype=torch.int32, device=dev)
    score = torch.empty((B, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fwav_staged_refine(
            _ptr(ranges), B, M, N, _ptr(bank), D, None if stats is None else _ptr(stats),
            _ptr(lobes), C, lobes.stride(0), lobes.stride(1), lobes.stride(2),
            _ptr(n_valid), int(stride), _OBJECTIVES[objective], int(per_lobe),
            np.float32(abs(float(s_clip))).item(), _ptr(idx), _ptr(score),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "staged_refine")
    LAUNCHES["staged_refine"] += 1
    return idx, score


# --- the serialized bank ----------------------------------------------------


def bank_rows(n_domains) -> int:
    """Rows per file of `bank_means`' output: the most domains of a file,
    rounded up to a multiple of 4 (at least 4), so that every file's rows
    start 16-byte aligned."""
    return max(4, -(-max(int(d) for d in n_domains) // 4) * 4)


def _check_bank_args(x, n_domains, tile_size: int, range_size: int, domain_step: int):
    """The bank's geometry checks; returns (n_domains as ints, block_len)."""
    if x.dim() != 2 or x.dtype != torch.int16:
        raise TypeError(f"bank_means: x must be a (B, nb) int16 stack, got {x.dtype} "
                        f"{tuple(x.shape)}")
    n_domains = [int(d) for d in n_domains]
    block_len = tile_size // range_size
    nb = x.shape[1]
    if len(n_domains) != x.shape[0] or block_len < 1 or domain_step < 1 or any(
            d < 0 or (d and (d - 1) * domain_step + range_size * block_len > nb)
            for d in n_domains):
        raise ValueError(f"bank_means: {n_domains} domains of tile {tile_size}, range "
                         f"{range_size}, step {domain_step} do not fit {tuple(x.shape)}")
    return n_domains, block_len


def bank_means_ref(x, n_domains, tile_size: int, range_size: int, domain_step: int,
                   block_rows: int = 1 << 16):
    """Plain PyTorch version of `bank_means`, blocked over rows: per block
    of rows the int64 prefix sums of the samples it reads, each block sum
    their exact difference, times the float64 1 / block_len, rounded to
    float32. Rows from n_domains[b] on are zero."""
    n_domains, block_len = _check_bank_args(x, n_domains, tile_size, range_size, domain_step)
    inv = 1.0 / block_len
    out = torch.zeros((x.shape[0], bank_rows(n_domains), range_size), dtype=torch.float32,
                      device=x.device)
    for b, nd in enumerate(n_domains):
        for r0 in range(0, nd, block_rows):
            r1 = min(nd, r0 + block_rows)
            lo = r0 * domain_step
            hi = (r1 - 1) * domain_step + range_size * block_len
            cs = torch.zeros(hi - lo + 1, dtype=torch.int64, device=x.device)
            torch.cumsum(x[b, lo:hi].to(torch.int64), 0, out=cs[1:])
            span = (r1 - r0) * domain_step
            for j in range(range_size):
                a = j * block_len
                sums = (cs[a + block_len : a + block_len + span : domain_step]
                        - cs[a : a + span : domain_step])
                out[b, r0:r1, j] = (sums.to(torch.float64) * inv).to(torch.float32)
    return out


def bank_means(x, n_domains, tile_size: int, range_size: int, domain_step: int = 1):
    """The serialized bank of a stack of integer-valued files, from their
    int16 samples: x (B, nb) int16, n_domains one count a file. Returns
    (B, bank_rows(n_domains), range_size) float32 with bank[b, i, j] the
    sum of x[b, i*domain_step + j*block_len :][:block_len] (block_len =
    tile_size // range_size) as an exact integer, times the float64
    1.0 / block_len, rounded to float32: ops/domains.py
    build_domains_host's bits on the same samples. Rows from n_domains[b]
    on are not written. A CPU tensor takes bank_means_ref; a CUDA tensor is
    one launch a stack (csrc/bank_means.cu), on the current stream."""
    dev = x.device
    if dev.type == "cpu":
        return bank_means_ref(x, n_domains, tile_size, range_size, domain_step)
    if dev.type != "cuda":
        raise ValueError(f"bank_means: unsupported device {dev}")
    n_domains, block_len = _check_bank_args(x, n_domains, tile_size, range_size, domain_step)
    _cuda_args("bank_means", {"x": x}, [(torch.int16,)], dev)
    B, nb = x.shape
    D = bank_rows(n_domains)

    from . import _build

    lib = _build.load()
    out = torch.empty((B, D, range_size), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fwav_bank_means(
            _ptr(x), B, nb, (ctypes.c_int * B)(*n_domains), D, range_size, block_len,
            int(domain_step), _ptr(out), ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "bank_means")
    LAUNCHES["bank_means"] += 1
    return out
