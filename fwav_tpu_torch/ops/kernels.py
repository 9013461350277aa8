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
- `refine_window` (K2) replaces `_refine_kernel` (refine_window_pallas):
  the dense window refine around each coarse lobe. CUDA source:
  csrc/refine_window.cu.

Each wrapper dispatches on the device of its tensors: a CPU tensor takes
the plain PyTorch version (`search_scan_ref`, `topc_scan_ref`,
`refine_window_ref`), a CUDA tensor launches the kernel or raises. The
plain versions compute in the kernels' order of operations, so on the
same inputs the two agree bit for bit. `LAUNCHES` counts kernel launches
per wrapper.

`pallas_blocks_ok` and `refine_blocks_ok` are the JAX package's gates for
its kernel path, copied so that the port takes the same branches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .affine import row_mean

_NEG = float("-inf")

#: Kernel launches per wrapper since the last reset (CPU calls, which take
#: the plain versions, are not counted).
LAUNCHES = {"search_scan": 0, "topc_scan": 0, "refine_window": 0}

_OBJECTIVES = {"balanced": 0, "affine": 1, "damped": 2}
#: Range sizes the CUDA kernels are instantiated for.
_KERNEL_N = range(4, 17)
#: Domains per shared-memory tile of the search kernel (search_scan.cu).
_SCAN_TILE_D = 256
#: Threads per block of the search kernel, one range each.
_SCAN_THREADS = 256
#: Largest C of the top-C kernel (its list lives in registers).
_TOPC_MAX = 8
#: The refine window's box-mean budget on the TPU (bytes of means). The
#: card needs no such cap; the gate keeps it so that the port selects the
#: same geometries as the JAX kernel path until the cap is lifted.
_REFINE_VMEM_MEANS_BYTES = 9 << 20


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _check_scan_args(name, r_c, bankT, w, valid, thresh):
    """The K1/K3 wrappers' input checks; returns (M, N, D)."""
    M, N = r_c.shape
    D = bankT.shape[1]
    f32 = (torch.float32,)
    args = {"r_c": r_c, "bankT": bankT, "w": w, "valid": valid}
    types = [f32, f32, f32, (torch.int8, torch.bool)]
    if thresh is not None:
        args["thresh"] = thresh
        types.append(f32)
    _cuda_args(name, args, types, r_c.device)
    if bankT.shape[0] != N or w.shape != (D,) or valid.shape != (D,) or (
        thresh is not None and thresh.shape != (D,)
    ):
        raise ValueError(f"{name}: shapes disagree")
    if N not in _KERNEL_N or M == 0 or D == 0:
        raise ValueError(f"{name}: no kernel for M={M}, N={N}, D={D}")
    return M, N, D


# --- K1 -------------------------------------------------------------------


def search_scan_ref(r_c, bankT, w, valid, thresh=None, s_clip=0.0,
                    range_block: int = 2048, domain_block: int = 512):
    """Plain PyTorch K1, blocked over ranges and domains so no (M, D) score
    tensor exists; the block temporaries are reused in place. Returns
    (score (M,) float32, idx (M,) int32): the lowest-index maximum of
    max(s_o, s_m) over valid domains, -inf and 0 where none is valid."""
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
    None. Returns (score (M,) float32, idx (M,) int32)."""
    dev = r_c.device
    if dev.type == "cpu":
        return search_scan_ref(r_c, bankT, w, valid, thresh, s_clip)
    if dev.type != "cuda":
        raise ValueError(f"search_scan: unsupported device {dev}")
    M, N, D = _check_scan_args("search_scan", r_c, bankT, w, valid, thresh)

    from . import _build

    lib = _build.load()
    # split the domains over blockIdx.y when the ranges alone would leave
    # the card's SMs idle (the exact branch: few ranges, a large bank)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    range_blocks = -(-M // _SCAN_THREADS)
    tiles = -(-D // _SCAN_TILE_D)
    n_split = max(1, min(-(-2 * sms // range_blocks), tiles))
    d_per_split = -(-tiles // n_split) * _SCAN_TILE_D
    n_split = -(-D // d_per_split)
    score = torch.empty(M, dtype=torch.float32, device=dev)
    idx = torch.empty(M, dtype=torch.int32, device=dev)
    if n_split > 1:
        part_s = torch.empty((n_split, M), dtype=torch.float32, device=dev)
        part_i = torch.empty((n_split, M), dtype=torch.int32, device=dev)
    else:
        part_s, part_i = score, idx
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fwav_search_scan(
            _ptr(r_c), _ptr(bankT), _ptr(w), _ptr(valid),
            _ptr(thresh) if thresh is not None else None,
            abs(float(s_clip)), M, N, D, n_split, d_per_split,
            _ptr(part_s), _ptr(part_i), _ptr(score), _ptr(idx),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "search_scan")
    LAUNCHES["search_scan"] += 1
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
    version keeps the order of its oracle, gain_topk_scan."""
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

    The result is the transposed view of a (top_c, M) tensor, so each lobe
    column idx[:, c] is contiguous and goes to refine_window without a
    copy."""
    if not 1 <= top_c <= _TOPC_MAX:
        raise ValueError(f"topc_scan: top_c={top_c} is outside 1..{_TOPC_MAX}")
    dev = r_c.device
    if dev.type == "cpu":
        return topc_scan_ref(r_c, bankT, w, valid, top_c, thresh, s_clip)
    if dev.type != "cuda":
        raise ValueError(f"topc_scan: unsupported device {dev}")
    M, N, D = _check_scan_args("topc_scan", r_c, bankT, w, valid, thresh)

    from . import _build

    lib = _build.load()
    out = torch.empty((top_c, M), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fwav_topc_scan(
            _ptr(r_c), _ptr(bankT), _ptr(w), _ptr(valid),
            _ptr(thresh) if thresh is not None else None,
            abs(float(s_clip)), M, N, D, top_c, _ptr(out),
            ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "topc_scan")
    LAUNCHES["topc_scan"] += 1
    return out.T


# --- K2 -------------------------------------------------------------------


def refine_window_ref(means_ext, lobes, ranges, n_valid: int, stride: int,
                      block_len: int, objective: str = "balanced",
                      s_clip: float = 16.0):
    """Plain PyTorch K2, blocked over ranges. Returns (score (M,) float32,
    idx (M,) int32)."""
    range_block = 16384
    M, n = ranges.shape
    dev = ranges.device
    W = stride + stride // 4
    half = W // 2
    L = means_ext.shape[0]
    c = abs(float(s_clip))
    t = torch.arange(W, device=dev)
    score = torch.empty(M, dtype=torch.float32, device=dev)
    idx = torch.empty(M, dtype=torch.int32, device=dev)
    for r0 in range(0, M, range_block):
        lob = lobes[r0 : r0 + range_block].to(torch.int64)
        lb = lob.clamp(min=0)
        r = ranges[r0 : r0 + range_block]
        rc = r - row_mean(r)[:, None]
        p0 = lb * stride - half                       # position of t = 0
        q = (p0 + stride)[:, None] + t[None, :]       # its index in means_ext
        v = []
        for j in range(n):
            qj = q + j * block_len
            v.append(torch.where(qj < L, means_ext[qj.clamp(max=L - 1)], 0.0))
        mean = v[0]
        for vj in v[1:]:
            mean = mean + vj
        mean = mean * (1.0 / n)
        no = rc[:, 0:1] * v[0]
        nm = rc[:, n - 1 : n] * v[0]
        for j in range(1, n):
            no = no + rc[:, j : j + 1] * v[j]
            nm = nm + rc[:, n - 1 - j : n - j] * v[j]
        denom = torch.zeros_like(mean)
        for vj in v:
            d = vj - mean
            denom = denom + d * d
        denom_eps = denom + 1e-12
        if objective == "balanced":
            wgt = (denom - n * mean * mean) / (denom_eps * denom_eps)
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
        idx[r0 : r0 + range_block] = (p0 + arg).clamp(0, max(n_valid - 1, 0)).to(torch.int32)
    return score, idx


def refine_window(means_ext, lobes, ranges, n_valid: int, stride: int,
                  block_len: int, objective: str = "balanced",
                  s_clip: float = 16.0):
    """K2: per range with coarse lobe L (-1 = none), the best of the
    W = stride + stride/4 positions p = L*stride - W/2 + t of the box-mean
    sequence (tap j = means[p + j*block_len]; means_ext (Lext,) holds a
    stride-wide zero lead), by the balanced, affine or damped gain;
    positions outside [0, n_valid) score -inf, the first max wins.
    Returns (score (M,) float32, idx (M,) int32 clipped to
    [0, n_valid - 1])."""
    dev = ranges.device
    if dev.type == "cpu":
        return refine_window_ref(means_ext, lobes, ranges, n_valid, stride,
                                 block_len, objective, s_clip)
    if dev.type != "cuda":
        raise ValueError(f"refine_window: unsupported device {dev}")
    f32 = (torch.float32,)
    _cuda_args(
        "refine_window",
        {"means_ext": means_ext, "lobes": lobes, "ranges": ranges},
        [f32, (torch.int32,), f32], dev,
    )
    M, n = ranges.shape
    if means_ext.dim() != 1 or lobes.shape != (M,):
        raise ValueError("refine_window: shapes disagree")
    if n not in _KERNEL_N or M == 0 or objective not in _OBJECTIVES:
        raise ValueError(
            f"refine_window: no kernel for M={M}, N={n}, objective={objective!r}"
        )

    from . import _build

    lib = _build.load()
    score = torch.empty(M, dtype=torch.float32, device=dev)
    idx = torch.empty(M, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.fwav_refine_window(
            _ptr(means_ext), means_ext.shape[0], _ptr(lobes), _ptr(ranges),
            M, n, int(n_valid), int(stride), int(block_len),
            _OBJECTIVES[objective], np.float32(abs(float(s_clip))).item(),
            _ptr(score), _ptr(idx), ctypes.c_void_p(stream),
        )
    _build.check(lib, code, "refine_window")
    LAUNCHES["refine_window"] += 1
    return score, idx
