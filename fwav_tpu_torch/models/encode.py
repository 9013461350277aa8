"""Single-shot encode: compress_audio_arrays, on one device or a mesh.

The counterpart of fwav_tpu/models/encode.py's single-shot path
(`compress_audio_arrays` -> `_compress_fast` -> the mode="raw" core).
`encode_core` is that core in eager PyTorch: normalize, device VAD,
ranges with the reflect-padded tail, then the search, then the sentinel
mask and the 3-byte idx codes. A stack's host half, models/refit.py
`HostHalf`, decides where its serialized bank is built (on the card from
int16 samples, else on the host: the same bits either way) and where its
codes become records with s, o, err and the orientation (the host refit
copied from the JAX package, or `collect_refit` behind the program on one
card, whose records leave the device in place of the codes: the native
refit's bits). `prune_bank` drops the rows no record uses.

The search takes the JAX package's kernel path (EncoderConfig.use_pallas
there): "exact" is K1 over the whole bank; "coarse" with one lobe is K1
over the stride-subsampled bank, then K2 around each range's lobe;
"coarse" with several lobes (the damped profile always takes 4) is K3's
top-C lobes over the subsampled bank, then K2 once over all of them.
Where the JAX kernel path leaves its window-refine kernel (a coarse stride
that is no multiple of 128: tile sizes under 1024; domain_step over 1:
tile 2048; a bank over the 9 MB means cap: files over ~53 s), so does the
port, by the same gates (`_plan_search`): K1 or K3 scans the subsampled
rows of the full device bank and K4 (ops/kernels.py staged_refine, the
staged window refine, which XLA fuses in the JAX package) refines around
the lobes, once per stack. "topk", the reference-shaped compatibility
mode that "auto" never picks, is the JAX package's embedding shortlist
(ops/search.py topk_search_block): torch ops, no kernel, as it has no
Pallas kernel there either.

Every device program here is written over a stack of files, (B, ...)
tensors with one count per file, and runs on a (dp, tp) mesh of devices
(parallel/mesh.py); one device is the one-cell mesh. `_mesh_program` is
that one program: the part before the search (`_front_packed` for raw
files, `_front_masked` for one streaming shard: the JAX core's
mode="raw" and mode="masked"), replicated on every cell, then the search
and `_pack_out`, split as the JAX core's dp/tp branches split them: dp
rows take contiguous range slabs; under "coarse" a row's tp cells split
its slab again, each running the one-cell search; under "exact" and
"topk" each cell scans its bank row shard and the row merges the winners
in the single-device tie order. Only the codes leave the devices and the
host refits them, so the records equal the single-device encode's at
every (dp, tp).

`encode_core_packed` (`encode_core` is its B = 1 case) is the program on
one device, which `compress_audio_packed` runs once per stack of
same-bucket files on every cell of its mesh: each kernel launches once
per stack, with the file as the slowest axis of its grid, and one file's
codes do not depend on its neighbours. The streaming encode
(models/stream.py) runs one more device program, `encode_core_global`,
the counterpart of the JAX core's mode="global" (the whole-file
global-candidate pass: K3 nomination, then K4 over every lobe column).

The counts of a file ride in a device `meta` tensor, one JAX `meta` row
per file, so a program reads none of them on the host. On one card,
under the plans "exact" and "coarse" (`_captured`),
the program of a shape key (`_core_key`, the JAX package's cache key) is
captured once, on the key's second call, as a CUDA graph and replayed for
every later call of that key, every length of the bucket
(models/program.py), as the JAX package compiles one program per key.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EncoderConfig
from ..io import native
from ..ops.affine import affine_stats, batched_affine_match, row_mean
from ..ops.domains import box_sums, build_bank, n_domains_for
from ..ops.kernels import (
    PACKS,
    check_refine_lead,
    pallas_blocks_ok,
    refine_blocks_ok,
    refine_window,
    search_scan,
    staged_refine,
    topc_scan,
)
from ..ops.dct import multi_head_embedding_batch
from ..ops.search import (
    _window_gains,
    domain_thresh,
    domain_weights,
    merge_shard_bests,
    topk_scores_block,
    topk_search_block,
)
from ..ops.vad import voiced_mask
from ..parallel.mesh import DP_AXIS, TP_AXIS, Mesh, as_mesh
from ..utils.buckets import bucket, pad_to
from ..utils.logging import device_banner
from ..utils.trace import phase
from .program import DEVICE_LOCK, PROGRAMS
from .refit import IDX3_SENTINEL, HostHalf, _empty_result

#: Largest whole-file bank (rows) whose global pass ships rows as 3-byte
#: codes; beyond it both of its transfers are int32 with -1 for none. A
#: module attribute, read at each call, so that a test can drive the int32
#: branch.
PACK3_MAX_ROWS = (1 << 24) - 1


#: Files per packed stack: bounds device memory (B banks) while one launch
#: of each kernel serves the whole stack.
PACK_B_MAX = 16

#: The transfer dtype that _as_i16_or_f32 chose, in files ("int16",
#: "float32"), and its passes that ran the numpy spec ("fallback": the
#: native library missing, or samples that are not C-contiguous float32).
PREPS = {"int16": 0, "float32": 0, "fallback": 0}


def pack3(code: torch.Tensor) -> torch.Tensor:
    """(..., m) int32 codes -> (..., m, 3) uint8, little-endian."""
    return torch.stack(
        [(code >> s) & 0xFF for s in (0, 8, 16)], dim=-1
    ).to(torch.uint8)


def unpack3(b3: torch.Tensor) -> torch.Tensor:
    """(m, 3) uint8 -> (m,) int32 rows, -1 where the sentinel, on the device."""
    b = b3.to(torch.int32)
    c = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return torch.where(c == IDX3_SENTINEL, -1, c)


def _pow2_divisor(n: int, cap: int) -> int:
    p = 1
    while n % (p * 2) == 0 and p * 2 <= cap:
        p *= 2
    return p


def _means_ext_len(n: int, block_len: int, stride: int, dc: int) -> int:
    """Length of `_means_setup`'s means_ext for dc subsampled rows."""
    W = stride + stride // 4
    lane0 = stride - W // 2
    ls = lane0 + (W - 1) + (n - 1) * block_len + 1
    Lslice = -(-ls // 128) * 128
    return -(-(stride + (dc - 1) * stride + Lslice) // 128) * 128


def _means_setup(raw_norm, n: int, block_len: int, stride: int, dc: int):
    """The box-mean sequence in the layout K2 reads (`means_ext`: a
    stride-wide zero lead, then a zero tail) and the stride-subsampled bank
    rows K1 scans (strided views of the sequence; the full bank is never
    built on this path). Along the last axis: a stack raw_norm (B, nb)
    gives (B, Lext) and (B, dc, n)."""
    means = box_sums(raw_norm, block_len) * (1.0 / block_len)
    lead = means.shape[:-1]
    Lext = _means_ext_len(n, block_len, stride, dc)
    k = min(means.shape[-1], Lext - stride)
    means_ext = torch.cat([
        means.new_zeros((*lead, stride)), means[..., :k],
        means.new_zeros((*lead, Lext - stride - k)),
    ], dim=-1)
    span = (dc - 1) * stride + 1
    mp = means if means.shape[-1] >= span + (n - 1) * block_len else means_ext[..., stride:]
    bank_sub = torch.stack(
        [mp[..., j * block_len : j * block_len + span : stride] for j in range(n)],
        dim=-1,
    )
    return means_ext, bank_sub


def _resolve_search(cfg: EncoderConfig, range_size: int, db: int):
    """Search mode and coarse stride for a bucketed bank size: "auto" takes
    "coarse" once the bank dwarfs the refine windows."""
    block_len = cfg.tile_size // range_size
    stride = min(cfg.coarse_stride, max(1, block_len // 2))
    stride = 1 << (stride.bit_length() - 1)  # largest pow2 <= stride
    search_mode = cfg.search
    if search_mode == "auto":
        search_mode = (
            "coarse"
            if db >= max(cfg.auto_coarse_threshold, 256 * stride) and stride > 1
            else "exact"
        )
    return search_mode, stride


def _coarse_topc(cfg: EncoderConfig) -> int:
    """Coarse lobes per range: the damped objective takes at least 4 (the
    JAX package's damped profile rule)."""
    if cfg.objective == "damped":
        return max(cfg.coarse_topc, 4)
    return cfg.coarse_topc


def _plan_search(cfg: EncoderConfig, mb: int, db: int):
    """(search mode, coarse stride, refine) for mb bucketed ranges and a
    db-row bucketed bank. `refine` is None for "exact" and "topk"; for
    "coarse" it is
    "window" where the JAX kernel path runs its window-refine kernel (K2
    here) and "staged" where it runs the staged refine over the full bank
    instead: its gates, mirrored, so that both packages take the same
    branch. One lobe takes K2 where pallas_blocks_ok and refine_blocks_ok
    hold; several lobes where refine_blocks_ok holds. K1 and K3 serve every
    geometry (the JAX package runs exact_search_block or gain_topk_scan, the
    same selection rules, where its scan kernels' block gate fails), every
    range size included: from 17 taps (tiles from 4352) their wide kernels.
    K2 takes range sizes up to 16 only, and never sees a wider one: such a
    range comes with domain_step > 1, which refine_blocks_ok refuses."""
    n = cfg.range_size
    if cfg.objective not in ("balanced", "affine", "damped"):
        raise ValueError(f"unknown objective {cfg.objective!r}")
    search_mode, stride = _resolve_search(cfg, n, db)
    if search_mode in ("exact", "topk"):
        return search_mode, stride, None
    if search_mode != "coarse":
        raise ValueError(f"unknown search mode {cfg.search!r}")
    if db % stride:
        raise ValueError(f"a {db}-row bank does not divide into stride {stride}")
    rblk = _pow2_divisor(mb, cfg.range_block)
    rb_rk = _pow2_divisor(rblk, 512)
    window = refine_blocks_ok(rblk, rb_rk, stride, cfg.domain_step, cfg.objective, db)
    if _coarse_topc(cfg) == 1:
        prb = 512 if rblk % 512 == 0 else _pow2_divisor(rblk, 512)
        dc = db // stride
        window = window and pallas_blocks_ok(
            rblk, dc, prb, _pow2_divisor(dc, cfg.domain_block))
    return search_mode, stride, "window" if window else "staged"


def _stack_counts(*per_file) -> np.ndarray:
    """Lists of one count per file -> the host side of a stack's `meta`:
    (B, len(per_file)) int32, one JAX `meta` row per file ([n_samples,
    n_ranges, n_domains] for raw files). It fills a device program's
    static input (models/program.py) or is copied to the device beside the
    raw samples, before the program enqueues anything: a copy from the host
    waits for the stream (ops/affine.py row_mean), so none is made later."""
    return np.array([[int(v) for v in row] for row in per_file], dtype=np.int32).T.copy()


def _core_key(cfg: EncoderConfig, nb: int, lb: int, db: int, mode: str, in_i16: bool,
              device, B: int = 1):
    """The device program's cache key for one shape bucket: the JAX
    package's _core_key (every static argument of its build_encode_core,
    fwav_tpu/models/encode.py) without use_pallas, which the port has no
    use for, then the device and the files per stack. The damped
    objective's coarse scan keeps at least 4 lobes; mode "global" rides
    the coarse slots with the global pass's stride and depth. The
    single-shot, packed and streaming programs all take their key here."""
    range_size = cfg.range_size
    search_mode, stride = _resolve_search(cfg, range_size, db)
    topc = cfg.coarse_topc
    if cfg.objective == "damped" and search_mode == "coarse":
        topc = max(topc, 4)
    if mode == "global":
        search_mode, stride, topc = "coarse", cfg.global_stride, cfg.global_topc
    return (
        nb, lb, db, cfg.tile_size, range_size, cfg.domain_step, search_mode,
        cfg.top_k, cfg.emb_dim, cfg.fast_mode, cfg.s_clip, cfg.domain_block,
        cfg.range_block, cfg.objective, stride, topc, mode, in_i16,
        float(cfg.energy_thresh), str(torch.device(device)), int(B),
    )


def _captured(cfg: EncoderConfig, lb: int, db: int, mesh) -> bool:
    """Whether a program runs as a captured graph (models/program.py): on
    a one-cell mesh of a CUDA device of this process, under the plans
    "exact" and "coarse" (the window refine, K2, or the staged one, K4).
    topk, meshes of several cells and the global pass stay eager."""
    if mesh.size != 1 or mesh.multi_process or mesh.first_local_device().type != "cuda":
        return False
    return _plan_search(cfg, lb // cfg.range_size, db)[0] in ("exact", "coarse")


def _check_counts(cfg: EncoderConfig, lb: int, db: int, n_domains) -> None:
    """The host-side size checks of a call, on its host counts, before its
    program runs (eager or replayed): K2's (ops/kernels.py
    check_refine_lead) on the box-mean sequence a coarse program builds."""
    search_mode, stride = _resolve_search(cfg, cfg.range_size, db)
    if search_mode == "coarse":
        n = cfg.range_size
        L = _means_ext_len(n, cfg.tile_size // n, stride, db // stride)
        check_refine_lead(L, n_domains, stride)


def _norm(raw):
    """float32 signal and the 1/max|x| normalization (1 for silence), along
    the last axis: inv is 0-d for one signal, (B,) for a stack."""
    rawf = raw.to(torch.float32)
    scale = rawf.abs().amax(dim=-1)
    return rawf, torch.where(scale > 0, torch.reciprocal(scale), 1.0)


def _topk_search(ranges, bank, valid, cfg: EncoderConfig):
    """The topk compatibility mode of one file (the JAX core's "topk"
    branch): ranges (M, n), its device bank (db, n) and valid rows (db,).
    The bank's embeddings once, then per range block of the JAX lax.map's
    size the embedding shortlist of cfg.top_k rows and the affine solve
    over it (ops/search.py topk_search_block). Returns (idx, score), each
    (M,): the score is the negated selection score, -inf where the
    shortlist held no valid row."""
    half = cfg.emb_dim // 2
    bank_emb = multi_head_embedding_batch(bank, tonal_k=half, transient_k=half)
    mb, db = ranges.shape[0], bank.shape[0]
    rblk = _pow2_divisor(mb, cfg.range_block)
    dblk = _pow2_divisor(db, cfg.domain_block)
    idx, score = [], []
    for r0 in range(0, mb, rblk):
        i, _s, _o, _y, _e, sel, _pick = topk_search_block(
            ranges[r0 : r0 + rblk], bank, bank_emb, valid, cfg.top_k, dblk, cfg.s_clip,
            cfg.emb_dim, objective=cfg.objective, return_score=True,
        )
        idx.append(i)
        score.append(torch.where(torch.isfinite(sel), -sel, float("-inf")))
    return torch.cat(idx), torch.cat(score)


def _run_search(ranges, raw_norm, nd, db: int, cfg: EncoderConfig,
                search_mode: str, stride: int, refine):
    """(idx, score), each (B, M), of a stack: ranges (B, M, n), raw_norm
    (B, nb), nd the files' domain counts on the device (B,), which every
    plan reads there, so that a captured program bakes in no count. K1 over
    the whole bank ("exact"), or K1 (one lobe) or K3 (several) over the
    subsampled bank, then around every lobe K2 (refine "window") or K4, the
    staged refine over the full bank ("staged"). Each kernel is one launch
    per stack. "topk" launches none of them: torch ops, file by file."""
    n = cfg.range_size
    dev = ranges.device
    nd = nd[:, None]
    if search_mode == "topk":
        bank = build_bank(raw_norm, cfg.tile_size, n, cfg.domain_step, db, nd[:, 0])
        valid = torch.arange(db, device=dev)[None, :] < nd
        per_file = [_topk_search(ranges[b], bank[b], valid[b], cfg)
                    for b in range(ranges.shape[0])]
        return torch.stack([f[0] for f in per_file]), torch.stack([f[1] for f in per_file])
    r_c = ranges - row_mean(ranges)[..., None]
    if search_mode == "exact":
        bank = build_bank(raw_norm, cfg.tile_size, n, cfg.domain_step, db, nd[:, 0])
        d_mean, d_denom = affine_stats(bank)
        valid = torch.arange(db, device=dev)[None, :] < nd
        score, idx = search_scan(
            r_c, bank.transpose(1, 2).contiguous(),
            domain_weights(d_mean, d_denom, n, cfg.objective), valid,
            domain_thresh(d_denom, cfg.objective, cfg.s_clip), cfg.s_clip,
        )
        return idx, score
    dc = db // stride
    block_len = cfg.tile_size // n
    if refine == "window":
        means_ext, bank_sub = _means_setup(raw_norm, n, block_len, stride, dc)
    else:
        # the full bank, for the staged refine; the scan reads its
        # subsampled rows (not _means_setup's strided views of the box
        # means: near-ties depend on whose bits the scan reads)
        bank = build_bank(raw_norm, cfg.tile_size, n, cfg.domain_step, db, nd[:, 0])
        bank_sub = bank.reshape(-1, dc, stride, n)[:, :, 0, :]
    sub_mean, sub_denom = affine_stats(bank_sub)
    v_sub = torch.arange(dc, device=dev)[None, :] * stride < nd
    scan_args = (
        r_c, bank_sub.transpose(1, 2).contiguous(),
        domain_weights(sub_mean, sub_denom, n, cfg.objective), v_sub,
    )
    thresh = domain_thresh(sub_denom, cfg.objective, cfg.s_clip)
    topc = _coarse_topc(cfg)
    if topc == 1:
        score, cidx = search_scan(*scan_args, thresh, cfg.s_clip)
        lobes = torch.where(torch.isfinite(score), cidx, -1)
        if refine == "staged":
            lobes = lobes[..., None]
    else:
        # (B, M, topc), the transposed view of K3's output, as K2 takes it
        lobes = topc_scan(*scan_args, topc, thresh, cfg.s_clip)
    if refine == "window":
        # one launch walks every lobe of a range; the earlier lobe wins ties
        # n_valid from device memory; the caller checked its host counts
        # (_check_counts)
        r_score, r_idx = refine_window(
            means_ext, lobes, ranges, nd[:, 0].to(torch.int32).contiguous(), stride, block_len,
            cfg.objective, cfg.s_clip,
        )
        return r_idx, r_score
    # every lobe column in one call, as the JAX package's coarse_refine_search
    # passes them: one column at stride >= 32 descends, C columns are dense
    return staged_refine(ranges, bank, nd[:, 0].to(torch.int32).contiguous(), lobes, stride,
                         cfg.objective, cfg.s_clip)


def _pack_out(ranges, idx, score, nr, inv, cfg: EncoderConfig, row0: int = 0):
    """The sentinel mask and the 3-byte codes of a stack's ranges (B, m, n)
    from row0 of the file on (the JAX core's `pack_out`): energy-pruned
    (mean power under 0.75 * thresh, on the normalized scale), bucket-pad
    rows (at or past the file's range count nr (B,)) and rows with no finite
    score are IDX3_SENTINEL. Returns (B, m, 3) uint8."""
    m = ranges.shape[1]
    r_pow = row_mean(ranges * ranges)
    thr_n = (float(cfg.energy_thresh) * inv * inv)[:, None]
    r_valid = row0 + torch.arange(m, device=ranges.device)[None, :] < nr[:, None]
    silent = (r_pow < thr_n * 0.75) if cfg.fast_mode else torch.zeros_like(r_valid)
    dead = silent | ~r_valid | ~torch.isfinite(score)
    return pack3(torch.where(dead, IDX3_SENTINEL, idx).to(torch.int32))


def _front_packed(raw, meta, lb: int, cfg: EncoderConfig):
    """The part of the raw program before the search, over a stack: each
    file normalized, masked by the device VAD and cut into lb // range_size
    ranges with its tail range reflect-padded. meta (B, 3) is one JAX
    `meta` per file, [n_samples, n_ranges, n_domains], an integer tensor
    on raw's device. Returns (ranges (B, mb, n), raw_norm (B, nb), nr, nd,
    inv), the last three (B,) on the device."""
    n = cfg.range_size
    B, nb = raw.shape
    mb = lb // n
    dev = raw.device
    meta = meta.to(torch.int64)
    ns, nr, nd = meta[:, 0], meta[:, 1], meta[:, 2]
    rawf, inv = _norm(raw)
    mask = voiced_mask(rawf, ns, 2 * n, float(cfg.energy_thresh))
    weighted = rawf * (mask.to(torch.float32) * inv[:, None])
    if lb <= nb:
        base = weighted[:, :lb]
    else:
        base = torch.cat([weighted, weighted.new_zeros((B, lb - nb))], dim=1)
    ranges = base.reshape(B, mb, n)
    # reflect-pad each file's tail range: position p >= ns reads 2*ns - 2 - p
    ns = ns[:, None]
    last = (ns - 1) // n                                          # (B, 1)
    tpos = last * n + torch.arange(n, device=dev)[None, :]
    refl = torch.where(tpos < ns, tpos, 2 * ns - 2 - tpos)
    tail = weighted.gather(1, refl.clamp(0, nb - 1))              # (B, n)
    is_tail = (torch.arange(mb, device=dev)[None, :] == last) & (ns % n != 0)
    ranges = torch.where(is_tail[..., None], tail[:, None, :], ranges)
    return ranges, rawf * inv[:, None], nr, nd, inv


def _program_raw(raw, meta, lb: int, db: int, cfg: EncoderConfig):
    """The raw program of a stack on raw's device: (B, lb // range_size,
    3) codes from raw (B, nb) and meta (B, 3) on the device, with nothing
    of the counts on the host. What models/program.py captures."""
    return _mesh_program(Mesh([[raw.device]]), lambda d: _front_packed(raw, meta, lb, cfg),
                         lb, db, cfg)[0]


def encode_core_packed(raw, meta, lb: int, db: int, cfg: EncoderConfig):
    """The device program over a stack of same-bucket files on one device:
    raw (B, nb), the bucket-padded raw signals (int16 or float32, on the
    device), meta (B, 3) int32 [n_samples, n_ranges, n_domains] per file
    (host, as _stack_counts makes it) -> (B, lb // range_size, 3) uint8 idx
    codes, IDX3_SENTINEL for energy-pruned, padded and no-candidate ranges.
    Each file is normalized, masked, cut into ranges and searched as it is
    alone; each kernel launches once for the stack. Eager: `_program_raw`
    of meta copied to the device, after the host checks of _check_counts."""
    _check_counts(cfg, lb, db, [int(v) for v in meta[:, 2]])
    return _program_raw(raw, torch.from_numpy(meta).to(raw.device), lb, db, cfg)


def encode_core(raw, n_samples: int, n_ranges: int, n_domains: int, lb: int,
                db: int, cfg: EncoderConfig):
    """The device program of one file: bucket-padded raw signal (int16 or
    float32, on the device) -> (lb // range_size, 3) uint8 idx codes. The
    stack of one of encode_core_packed."""
    return encode_core_packed(raw[None], _stack_counts([n_samples], [n_ranges], [n_domains]),
                              lb, db, cfg)[0]


def _mask_weighted(raw, mask_bytes):
    """float32 window, its 1/max|x| and the normalized voiced-weighted
    window, from the host VAD's packed bits (little-endian within each
    byte, as np.packbits(..., bitorder="little") writes them): expanded
    with shifts and a reshape, no gather."""
    rawf, inv = _norm(raw)
    shifts = torch.arange(8, dtype=torch.uint8, device=raw.device)
    bits = (mask_bytes[:, None] >> shifts[None, :]) & 1
    return rawf, inv, rawf * (bits.reshape(-1).to(torch.float32) * inv)


def _front_masked(raw, mask_bytes, meta, lb: int, cfg: EncoderConfig):
    """The part of one streaming shard's program before the search (the
    JAX core's mode="masked", a stack of one window): the window's raw
    samples (int16 or float32, bucket-padded to nb, on the device), the
    host VAD of the same samples as nb/8 packed bytes, and meta (4,) =
    [n_window_samples, range_offset, n_ranges, n_domains], an integer
    tensor on the device. The window is normalized by its own max|x|; the
    ranges are the lb weighted samples at range_offset, clamped on the
    device as lax.dynamic_slice clamps its start (the host reflect-pads the
    file's tail before it cuts the windows); the bank is built from the
    unmasked window, so the codes are window-local rows. Returns
    _front_packed's tuple."""
    n = cfg.range_size
    meta = meta.to(torch.int64)
    rawf, inv, weighted = _mask_weighted(raw, mask_bytes)
    off = meta[1].clamp(0, raw.shape[0] - lb)
    ranges = weighted[off + torch.arange(lb, device=raw.device)].reshape(1, lb // n, n)
    return ranges, (rawf * inv)[None], meta[2:3], meta[3:4], inv[None]


def encode_core_global(raw, mask_bytes, meta, local_rows, lb: int, db: int,
                       cfg: EncoderConfig, stride: int, topc: int):
    """The whole-file global-candidate pass (the JAX core's mode="global").
    Inputs as _front_masked's for the whole reflect-padded file (meta
    = (n_samples, 0, n_ranges, n_domains_total)), plus each range's
    shard-local winner as a whole-file row: (lb // range_size, 3) uint8
    codes when db < PACK3_MAX_ROWS, else int32 with -1 for none.

    K3 nominates the top-`topc` rows of the stride-subsampled whole-file
    bank for every range; K4 (ops/kernels.py staged_refine, per_lobe)
    refines each lobe column at full resolution in one launch, where a
    strict > lets the earlier lobe win ties. The best is compared with the
    local winner's gain on the same device bank. Returns, in the input's
    protocol, the nominated row where it strictly beats a live local
    winner, else none."""
    n = cfg.range_size
    mb = lb // n
    dev = raw.device
    n_domains = int(meta[3])
    dc = db // stride
    packed = db < PACK3_MAX_ROWS
    rawf, inv, weighted = _mask_weighted(raw, mask_bytes)
    ranges = weighted[:lb].reshape(mb, n)  # the caller buckets nb >= lb
    if packed:
        local_rows = unpack3(local_rows)
    bank = build_bank(rawf * inv, cfg.tile_size, n, cfg.domain_step, db, n_domains)
    # nomination stats on the subsampled rows only (per-row quantities)
    bank_sub = bank.reshape(dc, stride, n)[:, 0, :]
    sub_mean, sub_denom = affine_stats(bank_sub)
    v_sub = torch.arange(dc, device=dev) * stride < n_domains
    r_c = ranges - row_mean(ranges)[:, None]
    lobes = topc_scan(
        r_c, bank_sub.T.contiguous(),
        domain_weights(sub_mean, sub_denom, n, cfg.objective), v_sub, topc,
        domain_thresh(sub_denom, cfg.objective, cfg.s_clip), cfg.s_clip,
    )
    # n_valid filled on the device: a copy from the host would wait for the
    # stream (ops/affine.py row_mean)
    n_valid = torch.full((1,), n_domains, dtype=torch.int32, device=dev)
    best_i, best_s = staged_refine(ranges, bank, n_valid, lobes, stride, cfg.objective,
                                   cfg.s_clip, per_lobe=True)
    # the local winner's gain on the SAME device bank: one float32 metric
    # on both sides of the comparison
    live = local_rows >= 0
    ls, _ = _window_gains(
        r_c.T, bank, local_rows.clamp(0, db - 1).to(torch.int64)[None, :],
        live[None, :], cfg.objective, cfg.s_clip,
    )
    win = torch.isfinite(best_s) & (best_s > ls[0]) & live
    if packed:
        return pack3(torch.where(win, best_i, IDX3_SENTINEL).to(torch.int32))
    return torch.where(win, best_i, -1).to(torch.int32)


# --- the mesh program -------------------------------------------------------


def _mesh_dims(mesh):
    """(dp, tp) of a mesh."""
    return mesh.shape[DP_AXIS], mesh.shape[TP_AXIS]


def _shard_banks(cells, db: int, cfg: EncoderConfig):
    """Each tp cell's contiguous row shard of the bank: [(row offset,
    bank (B, db / tp, n), valid rows (B, db / tp))], built on the cell's
    device from its replicated front."""
    tp = len(cells)
    dloc = db // tp
    out = []
    for j, (_, raw_norm, _, nd, _) in enumerate(cells):
        off = j * dloc
        bank = build_bank(raw_norm, cfg.tile_size, cfg.range_size, cfg.domain_step, db,
                          nd, row_offset=off, d_rows=dloc)
        rows = off + torch.arange(dloc, device=nd.device)
        out.append((off, bank, rows[None, :] < nd[:, None]))
    return out


def _exact_tp(slabs, shards, cfg: EncoderConfig):
    """"exact" over a row of tp cells: K1 over each cell's bank row shard,
    the shard's offset added to its winners, merge_shard_bests on the first
    cell's device. Returns (idx, score), each (B, M)."""
    n = cfg.range_size
    dev0 = slabs[0].device
    scores, idxs = [], []
    for rs, (off, bank, valid) in zip(slabs, shards):
        d_mean, d_denom = affine_stats(bank)
        score, lidx = search_scan(
            rs - row_mean(rs)[..., None], bank.transpose(1, 2).contiguous(),
            domain_weights(d_mean, d_denom, n, cfg.objective), valid,
            domain_thresh(d_denom, cfg.objective, cfg.s_clip), cfg.s_clip,
        )
        scores.append(score.to(dev0))
        idxs.append((lidx + off).to(dev0))
    score = torch.stack(scores)
    score, idx, _ = merge_shard_bests(score, torch.stack(idxs),
                                      torch.zeros_like(score, dtype=torch.bool))
    return idx, score


def _topk_tp(slabs, shards, cfg: EncoderConfig):
    """"topk" of one file over a row of tp cells (the JAX core's tp topk
    branch): per range block of the JAX lax.map's size, each cell's top-k
    shortlist of its bank row shard; on the first cell the shortlists
    merge into the exact global top k (sorted by score descending, then
    global row ascending: the order of the single-device merge); each cell
    solves the candidates it owns, and the winners merge on (selection
    score, position among the originals-then-mirrors), which is the
    single-device solve's first minimum. slabs: (M, n) per cell; shards:
    (offset, bank (D/tp, n), valid) per cell. Returns (idx, score), each
    (M,), score -inf where no candidate was valid."""
    half = cfg.emb_dim // 2
    k = cfg.top_k
    M = slabs[0].shape[0]
    dev0 = slabs[0].device
    dloc = shards[0][1].shape[0]
    rblk = _pow2_divisor(M, cfg.range_block)
    ldblk = _pow2_divisor(dloc, cfg.domain_block)
    imax = torch.iinfo(torch.int32).max
    embs = [multi_head_embedding_batch(bank, tonal_k=half, transient_k=half)
            for _, bank, _ in shards]
    idx_out, score_out = [], []
    for r0 in range(0, M, rblk):
        sc_all, key_all = [], []
        for rs, (off, _, valid), emb in zip(slabs, shards, embs):
            q = multi_head_embedding_batch(rs[r0 : r0 + rblk], tonal_k=half, transient_k=half)
            sc, lidx = topk_scores_block(q, emb, valid, k, ldblk)
            sc_all.append(sc.to(dev0))
            key_all.append(torch.where(lidx >= 0, lidx + off, imax).to(dev0))
        sc_all, key_all = torch.cat(sc_all, dim=1), torch.cat(key_all, dim=1)
        # lexicographic (-score, row): a stable sort by row, then by -score
        order = torch.sort(key_all, dim=1, stable=True).indices
        sc_all, key_all = sc_all.gather(1, order), key_all.gather(1, order)
        order = torch.sort(-sc_all, dim=1, stable=True).indices
        key_all = key_all.gather(1, order)[:, :k]
        cand = torch.where(key_all == imax, -1, key_all)          # global top k
        sels, picks = [], []
        for rs, (off, bank, _) in zip(slabs, shards):
            c = cand.to(rs.device)
            own = (c >= off) & (c < off + dloc)
            *_, sel, pick = batched_affine_match(
                rs[r0 : r0 + rblk], torch.where(own, c - off, -1), bank, s_clip=cfg.s_clip,
                objective=cfg.objective, return_score=True,
            )
            sels.append(torch.where(torch.isfinite(sel), -sel, float("-inf")).to(dev0))
            picks.append(pick.to(dev0))
        # a slot is owned by one cell, so equal positions never tie
        sel = torch.stack(sels)
        score, pick, _ = merge_shard_bests(sel, torch.stack(picks),
                                           torch.zeros_like(sel, dtype=torch.bool))
        slot = torch.where(pick >= k, pick - k, pick).to(torch.int64)
        idx = cand.gather(1, slot[:, None])[:, 0]
        idx_out.append(idx)
        score_out.append(torch.where(torch.isfinite(score) & (idx >= 0), score, float("-inf")))
    return torch.cat(idx_out), torch.cat(score_out)


def _mesh_program(mesh, front, lb: int, db: int, cfg: EncoderConfig):
    """The device program of a stack over the (dp, tp) cells of `mesh` (the
    JAX core's `finish` and `pack_out`, with its dp/tp branches under
    shard_map; a one-cell mesh is the single-device program): the rows this
    process owns. front(device) copies the host inputs to a device and runs
    the replicated part before the search (_front_packed or _front_masked),
    once per distinct device of those rows. Dp row i takes the range slab
    [i * mloc, (i + 1) * mloc); under "coarse" its tp cells split the slab
    into sub-slabs, each searched by the single-device program planned at
    the sub-slab's shape; under "exact" and "topk" each cell scans its bank
    row shard and the row merges. The merge and the codes are on the row's
    first cell. Every cell's work is enqueued on its own device with no
    copy to the host. Returns {row: (B, mloc, 3) uint8 codes}."""
    n = cfg.range_size
    dp, tp = _mesh_dims(mesh)
    mloc = lb // n // dp
    search_mode, _ = _resolve_search(cfg, n, db)
    split = tp if search_mode == "coarse" else 1  # coarse tp splits ranges
    msub = mloc // split
    plan = _plan_search(cfg, msub, db)  # at the shape of one cell's ranges
    rows = mesh.local_rows()
    fronts = {}
    for i in rows:
        for d in mesh.devices[i]:
            if d not in fronts:
                fronts[d] = front(d)
    out = {}
    for i in rows:
        row0 = i * mloc
        cells = [fronts[d] for d in mesh.devices[i]]
        ranges0, raw_norm0, nr0, nd0, inv0 = cells[0]
        dev0 = ranges0.device
        if split > 1:
            parts = [
                _run_search(c[0][:, row0 + j * msub : row0 + (j + 1) * msub], c[1],
                            c[3], db, cfg, *plan)
                for j, c in enumerate(cells)
            ]
            idx = torch.cat([p[0].to(dev0) for p in parts], dim=1)
            score = torch.cat([p[1].to(dev0) for p in parts], dim=1)
        elif tp > 1:
            slabs = [c[0][:, row0 : row0 + mloc] for c in cells]
            shards = _shard_banks(cells, db, cfg)
            if search_mode == "exact":
                idx, score = _exact_tp(slabs, shards, cfg)
            elif search_mode == "topk":
                per_file = [
                    _topk_tp([s[b] for s in slabs], [(o, bk[b], v[b]) for o, bk, v in shards],
                             cfg)
                    for b in range(ranges0.shape[0])
                ]
                idx = torch.stack([f[0] for f in per_file])
                score = torch.stack([f[1] for f in per_file])
        else:
            idx, score = _run_search(ranges0[:, row0 : row0 + mloc], raw_norm0, nd0, db,
                                     cfg, *plan)
        out[i] = _pack_out(ranges0[:, row0 : row0 + mloc], idx, score, nr0, inv0, cfg, row0)
    return out


def _packed_cells(x, meta_np, lb: int, db: int, cfg: EncoderConfig, mesh):
    """A packed stack over every cell of `mesh` (the JAX package's
    _packed_sharded_core): the file axis, padded with copies of the last
    file to a multiple of the cell count, splits into contiguous groups of
    whole files, one per cell in flat (dp, tp) order, each encoded by the
    single-device program on its cell. x is the stack's (B, nb) samples on
    the mesh's first local device, copied to each cell on another device;
    meta_np its (B, 3) meta. Returns {flat cell: (files, mb, 3) codes} of
    the cells this process owns."""
    B = x.shape[0]
    per = -(-B // mesh.size)
    order = list(range(B)) + [B - 1] * (per * mesh.size - B)
    flat = mesh.devices.reshape(-1)
    out = {}
    for k in mesh.local_cells():
        sel = order[k * per : (k + 1) * per]
        raw, meta = (x, meta_np) if sel == list(range(B)) else (x[sel], meta_np[sel])
        out[k] = encode_core_packed(raw.to(flat[k]), meta, lb, db, cfg)
    return out


def _i16_spec(signal: np.ndarray, nb: int):
    """The numpy decision and row, the executable spec of native/prep.cpp:
    (the (nb,) int16 row padded with zeros, True) where every sample is
    finite, |x| <= 32767 and whole, else (None, False)."""
    peak = float(np.max(np.abs(signal))) if len(signal) else 0.0
    if np.isfinite(peak) and peak <= 32767.0:
        as_i16 = signal.astype(np.int16)
        if np.array_equal(signal, as_i16):
            row = np.zeros(nb, dtype=np.int16)
            row[: len(signal)] = as_i16
            return row, True
    return None, False


def _as_i16_or_f32(signal: np.ndarray, nb: int | None = None):
    """16-bit-exact content ships to the device as int16 (half the bytes);
    the device casts it back to float32 exactly. Returns (src, in_i16): an
    int16 src is the row of `nb` samples (the signal's length by default)
    padded with zeros, a float32 one the signal itself. Float32 samples take
    the native pass (native/prep.cpp), which decides and writes the row in
    one read; anything else, or a missing library, the numpy spec."""
    nb = len(signal) if nb is None else nb
    in_i16 = None
    if signal.dtype == np.float32 and signal.flags.c_contiguous:
        row = np.empty(nb, dtype=np.int16)
        in_i16 = native.prep_i16(signal, row)
    if in_i16 is None:
        PREPS["fallback"] += 1
        row, in_i16 = _i16_spec(signal, nb)
    PREPS["int16" if in_i16 else "float32"] += 1
    return (row, True) if in_i16 else (signal, False)


def _range_split_factor(cfg: EncoderConfig, range_size: int, db: int, dp: int,
                        tp: int) -> int:
    """How many ways the range axis splits over the mesh: dp, times tp
    where the search resolves to "coarse", whose tp splits ranges rather
    than bank rows. Shared by _prep_signal and the streaming encode so that
    their padding always matches the program's slab split."""
    if tp > 1 and _resolve_search(cfg, range_size, db)[0] == "coarse":
        return dp * tp
    return dp


@phase("prep")
def _prep_signal(signal: np.ndarray, cfg: EncoderConfig, dp: int = 1, tp: int = 1):
    """Counts and shape buckets (the JAX package's, so both take the same
    search branch), and the padded raw buffer. On a real mesh the bank
    bucket pads to a multiple of tp * 256 rows and the range bucket to a
    multiple of (range split) * 256, as the JAX package pads them; at
    dp = tp = 1 there is no such padding. Returns (raw_p, n_ranges,
    n_domains, lb, db), or None when the signal has no ranges or no
    domains. Raises ValueError past the 3-byte code's 2^24 rows."""
    range_size = cfg.range_size
    original_len = len(signal)
    n_ranges = -(-original_len // range_size) if original_len else 0
    n_domains = n_domains_for(original_len, cfg.tile_size, cfg.domain_step)
    if n_ranges == 0 or n_domains == 0:
        return None
    if n_domains >= 1 << 24:
        raise ValueError(
            f"{n_domains} domains exceeds the single-shot encoder's 2^24 "
            "index range; encode long files with "
            "models.stream.compress_audio_streaming"
        )
    nb = bucket(original_len, 4096)
    rb = bucket(n_ranges, 256)
    dbk = bucket(n_domains, 256)
    db = pad_to(dbk, tp * 256) if tp > 1 else dbk
    rsplit = _range_split_factor(cfg, range_size, db, dp, tp)
    lb = (pad_to(rb, rsplit * 256) if rsplit > 1 else rb) * range_size
    raw_p, in_i16 = _as_i16_or_f32(signal, nb)
    if not in_i16:
        raw_p = np.zeros(nb, dtype=np.float32)
        raw_p[:original_len] = signal
    return raw_p, n_ranges, n_domains, lb, db


def _encode_stack(files, lb: int, db: int, cfg: EncoderConfig, mesh: Mesh,
                  by_file: bool = False):
    """One stack of same-bucket files, each (signal, raw_p, n_ranges,
    n_domains) of _prep_signal: the device program over `mesh` and the
    stack's host half (models/refit.py HostHalf). The stack's samples reach
    the mesh's first local device once, where the bank build, the
    program's front and a card refit read them. The ranges of the stack
    split over the cells (_mesh_program), or with `by_file` its files
    (_packed_cells); on one card, where _captured says so, the program of
    its _core_key is replayed instead (models/program.py), the counts in
    its `meta`. The enqueue of the whole program, the host half's start
    before it and its card refit behind it hold DEVICE_LOCK. Returns one
    result per file."""
    raw_np = files[0][1][None] if len(files) == 1 else np.stack([f[1] for f in files])
    n_domains = [f[3] for f in files]
    meta_np = _stack_counts([len(f[0]) for f in files], [f[2] for f in files], n_domains)
    _check_counts(cfg, lb, db, n_domains)
    dev0 = mesh.first_local_device()
    captured = _captured(cfg, lb, db, mesh)
    # the JAX package's phases: "device" from the enqueue to the codes on
    # the host, "d2h" from the end of the enqueue, "host_bank" inside it
    with phase("device"):
        with DEVICE_LOCK:
            if captured:
                # one program per shape key, replayed (models/program.py)
                key = _core_key(cfg, raw_np.shape[1], lb, db, "raw",
                                raw_np.dtype == np.int16, dev0, len(files))
                run = PROGRAMS.load(
                    key, dev0, (raw_np, meta_np),
                    lambda raw, meta: _program_raw(raw, meta, lb, db, cfg),
                )
                x = run.inputs[0]
            else:
                x = torch.from_numpy(raw_np).to(dev0)
                if not by_file:  # ahead of any launch: a copy from the host waits for the stream
                    meta = torch.from_numpy(meta_np).to(dev0)
            half = HostHalf(x, files, cfg, mesh)  # the bank enqueued ahead of the program
            if captured:
                half.take({0: run.launch()})
            elif by_file:
                half.take(_packed_cells(x, meta_np, lb, db, cfg, mesh))
            else:  # dp slabs along the range axis
                half.take(_mesh_program(
                    mesh, lambda d: _front_packed(x.to(d), meta.to(d), lb, cfg), lb, db, cfg),
                    axis=1)
        with phase("d2h"):
            half.fetch()
    return half.results()


def _compress_fast(signal: np.ndarray, cfg: EncoderConfig, mesh: Mesh):
    """Single-shot encode: the stack of one file over the (dp, tp) cells of
    `mesh` (records bit-equal to the single-device encode's at every
    (dp, tp))."""
    prep = _prep_signal(signal, cfg, *_mesh_dims(mesh))
    if prep is None:
        return _empty_result(cfg, len(signal))
    raw_p, n_ranges, n_domains, lb, db = prep
    return _encode_stack([(signal, raw_p, n_ranges, n_domains)], lb, db, cfg, mesh)[0]


@phase("prune")
def prune_bank(rec: np.ndarray, bank: np.ndarray):
    """Drop every bank row no match references and reindex. An all-sentinel
    table keeps one zero row, so the file stays loadable. Returns
    (rec', bank'); rec is not modified."""
    used = np.unique(rec["idx"][rec["idx"] >= 0])
    if used.size == 0 and len(bank):
        return rec.copy(), np.zeros((1, bank.shape[1]), dtype=np.float32)
    return remap_matches(rec, used), np.ascontiguousarray(bank[used])


def remap_matches(rec: np.ndarray, used: np.ndarray) -> np.ndarray:
    """Reindex live matches against the sorted kept-row list `used`."""
    out = rec.copy()
    live = out["idx"] >= 0
    out["idx"][live] = np.searchsorted(used, out["idx"][live]).astype(np.int32)
    return out


def compress_audio_arrays(
    signal,
    framerate,
    sampwidth,
    tile_size: int = 1024,
    emb_dim: int = 16,
    top_k: int = 32,
    ef_search: int = 50,
    use_gpu: bool = False,
    energy_thresh: float = 1e-4,
    domains_tmpdir=None,
    batch_size_gpu: int = 512,
    batch_size_cpu: int = 128,
    fast_mode: bool = True,
    transient_weight: float = 1.0,
    n_mels: int = 40,
    cpu_workers=None,
    search: str = "auto",
    objective: str = "balanced",
    global_candidates: bool | None = None,
    config: EncoderConfig | None = None,
    device="cuda",
):
    """Encode one mono signal; returns (records, bank, n_ranges,
    range_size, tile_size, domain_step, energy_thresh, original_len) with
    MATCH_DTYPE records. `device` runs the core: "cuda" (the default) or,
    when asked for, "cpu", which runs the kernels' plain versions.

    The keyword set is the JAX package's: `emb_dim`, `top_k` and
    `global_candidates` ride the config (a single-shot encode searches the
    whole bank, so the last changes nothing here; file-level callers pass
    one set to this and to the streaming encoder); the other
    reference-signature kwargs are accepted and do nothing."""
    del framerate, sampwidth  # not used by the encode; kept for API symmetry
    del ef_search, use_gpu, domains_tmpdir, batch_size_gpu, batch_size_cpu
    del transient_weight, n_mels, cpu_workers
    mesh = as_mesh(None, device)
    device_banner(mesh.first_local_device())
    cfg = config or EncoderConfig(
        tile_size=tile_size, emb_dim=emb_dim, top_k=top_k,
        energy_thresh=energy_thresh, fast_mode=fast_mode, search=search,
        objective=objective, global_candidates=global_candidates,
    )
    signal = np.ascontiguousarray(np.asarray(signal, dtype=np.float32))
    return _compress_fast(signal, cfg, mesh)


def compress_audio_packed(
    signals,
    framerate,
    sampwidth,
    tile_size: int = 1024,
    energy_thresh: float = 1e-4,
    fast_mode: bool = True,
    search: str = "auto",
    objective: str = "balanced",
    global_candidates: bool | None = None,
    config: EncoderConfig | None = None,
    mesh=None,
    device="cuda",
):
    """Encode many signals, one device program per stack of up to
    PACK_B_MAX files that share a shape bucket (nb, lb, db) and a transfer
    dtype (16-bit-exact files ship as int16 and never share a stack with
    float32 ones). Each of K1 / K3, K2 and its table launches once per
    stack, with the file as the slowest axis of its grid
    (encode_core_packed), K4 where the geometry takes the staged refine
    (_plan_search). The host builds each file's
    bank while the device runs, one copy brings the stack's codes back, and
    each file is finalized as the single-shot encoder does it, so every
    file's records equal compress_audio_arrays' exactly. ops/kernels.py
    PACKS counts the calls, their stacks and files, and the pairs of each
    stack's scan grid that belong to a file.

    Returns a list of compress_audio_arrays-shaped 8-tuples in input
    order; an empty or too-short input gives the empty result in its place.
    A ValueError of one input is re-raised as `signal {i}: ...`. `device`:
    "cuda" (the default) or, when asked for, "cpu". `mesh`: a (dp, tp) mesh
    of several cells splits each stack's file axis over every cell (whole
    files per cell, in flat (dp, tp) order; the stack padded with copies of
    its last file to a multiple of the cell count), each cell running the
    single-device program on its files; the records are the same. A mesh
    decides the devices: `device` is then not used."""
    del framerate, sampwidth  # not used by the encode; kept for API symmetry
    del global_candidates  # a streaming knob: a single-shot encode searches the whole bank
    mesh = as_mesh(mesh, device)
    for k in mesh.local_cells():
        device_banner(mesh.devices.reshape(-1)[k])
    cfg = config or EncoderConfig(
        tile_size=tile_size, energy_thresh=energy_thresh, fast_mode=fast_mode,
        search=search, objective=objective,
    )
    PACKS["calls"] += 1
    PACKS["clips"] += len(signals)
    results = [None] * len(signals)
    groups: dict = {}
    prepped: dict = {}
    for i, sig in enumerate(signals):
        signal = np.ascontiguousarray(np.asarray(sig, dtype=np.float32))
        try:
            prep = _prep_signal(signal, cfg)
        except ValueError as e:
            raise ValueError(f"signal {i}: {e}") from None
        if prep is None:
            results[i] = _empty_result(cfg, len(signal))
            continue
        raw_p, n_ranges, n_domains, lb, db = prep
        groups.setdefault((len(raw_p), lb, db, raw_p.dtype), []).append(i)
        prepped[i] = (signal, raw_p, n_ranges, n_domains)

    for (_, lb, db, _), idxs in groups.items():
        for c0 in range(0, len(idxs), PACK_B_MAX):
            chunk = idxs[c0 : c0 + PACK_B_MAX]
            stack = [prepped[i] for i in chunk]
            done = _encode_stack(stack, lb, db, cfg, mesh, by_file=True)
            PACKS["stacks"] += 1
            PACKS["stack_files"] += len(stack)
            PACKS["valid_pairs"] += sum(f[2] * f[3] for f in stack)  # ranges x rows
            PACKS["grid_pairs"] += len(stack) * (lb // cfg.range_size) * db
            for i, res in zip(chunk, done):
                results[i] = res
    return results


def compress_audio(signal, framerate, sampwidth, **kwargs):
    """Reference-shaped encode: matches as a list of 5-tuples."""
    from ..io.container import struct_to_matches

    rec, *rest = compress_audio_arrays(signal, framerate, sampwidth, **kwargs)
    return (struct_to_matches(rec), *rest)
