"""File-level compress and decompress: the counterpart of
fwav_tpu/models/codec.py, the layer under the CLI.

process_file_compress and process_file_decompress return one metrics dict
per file ({'input', 'output', 'time_s', 'ratio', ...}), or
{'input', 'error'} when the file failed, so that a batch survives a bad
file. They pick the path for a real file as the JAX package does: up to
STREAMING_THRESHOLD samples the single-shot encode, above it the
streaming one with its bank pruned from the signal; `compact` writes v2
with the damped profile's decode hint; a multichannel file under
channels="keep"/"ms" takes the packed encode into v3; a decode honours the
stored hint. Every call takes `device`: "cuda" (the default) or, when
asked for, "cpu"; a CUDA request without a card is the file's error, never
a run on the CPU.

Output paths: a path that ends in .fwav / .wav is the output file;
anything else is a directory, as in the reference.

A compress runs under the phases of utils/trace.py: `wav_read` (the read
and the float clip), the encode's own, `prune` (models/encode.py
prune_bank, models/stream.py _prune_streamed), `container` (the v2/v3
bytes, io/compact.py compact_bytes; on v1 the whole native save) and
`write` (the v2/v3 file's open and write).

devices > 1 runs over a (dp = devices // tp, tp) mesh of `device`'s kind
(parallel/mesh.py make_mesh): the single-shot encode through
compress_audio_sharded, the streaming encode with every shard over the
mesh, the packed batch with its files over every cell, and the damped
decode range-sharded over dp (the closed-form decode ignores the mesh and
builds none). The records are those of one device. Fewer devices than
requested is the file's error, as make_mesh raises it.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np

from ..io.container import (
    load_compressed_arrays,
    read_version,
    save_compressed,
    save_compressed_streaming,
)
from ..io.wav import read_wav, read_wav_mono, write_wav
from ..utils.logging import logger
from ..utils.metrics import compression_ratio, x_realtime
from ..utils.trace import phase
from .decode import decompress_audio, decompress_segment
from ..parallel.mesh import make_mesh
from ..parallel.shard import compress_audio_sharded
from .encode import compress_audio_arrays, compress_audio_packed, prune_bank as _prune
from .stream import _prune_streamed, compress_audio_streaming, domain_block_iter

#: Files longer than this (samples) encode through the streaming encoder
#: with a bank serialized block by block.
STREAMING_THRESHOLD = 1 << 22


def _save_v1(*args):
    """The v1 writer (io/container.py save_compressed): native, with no
    bytes form, so the phase `container` covers the whole save."""
    with phase("container"):
        save_compressed(*args)


def _mesh(devices, tp, device):
    """The (devices // tp, tp) mesh of `device`'s kind for devices > 1,
    else None; ValueError when fewer devices are present."""
    if devices and devices > 1:
        return make_mesh(devices, dp=devices // tp, tp=tp, device=device)
    return None


def _resolve_out(path, outdir, default_suffix, expected_ext):
    if outdir is None:
        return os.path.splitext(path)[0] + default_suffix
    if outdir.lower().endswith(expected_ext):
        parent = os.path.dirname(outdir)
        if parent:
            os.makedirs(parent, exist_ok=True)
        return outdir
    os.makedirs(outdir, exist_ok=True)
    base = os.path.basename(path)
    if default_suffix == ".fwav":
        return os.path.join(outdir, base + ".fwav")
    return os.path.join(outdir, base + "_recon.wav")


def _profile_hint(kwargs):
    """The decode hint a compact or multichannel writer stores for this
    encode's keywords: DAMPED_DECODE_DAMPING for the damped profile, None
    (the default decode) for every other."""
    if kwargs.get("objective") == "damped":
        from ..config import DAMPED_DECODE_DAMPING

        return DAMPED_DECODE_DAMPING
    return None


def _stored_decode_hint(path):
    """The container's stored decode hint (v2 FLAG_DECODE_HINT; v3 through
    its first channel), or None; v1 never carries one. Advisory: a read or
    parse failure gives None and the loader raises the real error later."""
    try:
        v = read_version(path)
        if v == 2:
            from ..io.compact import parse_decode_hint

            with open(path, "rb") as f:
                return parse_decode_hint(f.read(128))
        if v == 3:
            from ..io.multich import multi_decode_hint

            with open(path, "rb") as f:
                return multi_decode_hint(f.read())
    except (OSError, ValueError):
        return None
    return None


def process_file_compress(path, outdir=None, tile=1024, energy_thresh=1e-4,
                          use_gpu=False, prune_bank=False, search="auto",
                          devices=1, tp=1, compact=False, resume_dir=None,
                          channels="fold", device="cuda", **kwargs):
    """Compress one WAV. prune_bank=True stores only the referenced bank
    rows (still a v1 file any decoder reads, decoded bit for bit);
    compact=True writes v2 (implies prune_bank) with the decode hint of
    the damped profile. channels: "fold" averages to mono; "keep" encodes
    every channel (one packed device program for a short file) into v3;
    "ms" stores stereo as mid/side. A mono file under keep/ms takes the
    mono path. devices > 1 encodes over a (devices // tp, tp) mesh (module
    doc). `use_gpu` is accepted for the reference's signature."""
    if channels not in ("fold", "keep", "ms"):
        return {"input": path, "error": f"Unknown channels mode: {channels!r}"}
    if channels != "fold":
        try:
            with phase("wav_read"):
                ch_data = read_wav(path)[0]
        except Exception as e:  # noqa: BLE001 — per-file isolation
            logger.exception("Compression failed for %s", path)
            return {"input": path, "error": str(e)}
        if ch_data.shape[1] > 1:
            return _process_file_compress_multi(
                path, outdir, tile, energy_thresh, search=search, devices=devices, tp=tp,
                mid_side=(channels == "ms"), device=device, **kwargs,
            )
    if compact:
        from ..io.compact import save_compressed_compact

        prune_bank = True
        _save = functools.partial(save_compressed_compact,
                                  decode_damping=_profile_hint(kwargs))
    else:
        _save = _save_v1
    try:
        start = time.time()
        with phase("wav_read"):
            signal, framerate, sampwidth = read_wav_mono(path)
            if sampwidth == 4:
                signal = np.clip(signal.astype(np.float32), -1.0, 1.0)
        if len(signal) > STREAMING_THRESHOLD:
            (
                rec, _, n_ranges, range_size, tile_size, domain_step,
                energy_threshold, original_len,
            ) = compress_audio_streaming(
                signal, framerate, sampwidth, tile_size=tile,
                energy_thresh=energy_thresh, search=search, resume_dir=resume_dir,
                mesh=_mesh(devices, tp, device), device=device, **kwargs,
            )
            from ..ops.domains import n_domains_for

            n_domains = n_domains_for(original_len, tile_size, domain_step)
            logger.info("Processed %d ranges (streaming), %d domains", n_ranges, n_domains)
            outpath = _resolve_out(path, outdir, ".fwav", ".fwav")
            if prune_bank:
                rec, bank = _prune_streamed(rec, signal, tile_size, range_size, domain_step)
                _save(outpath, rec, bank, range_size, framerate, sampwidth,
                      tile_size, domain_step, energy_threshold, original_len)
            else:
                with phase("container"):
                    save_compressed_streaming(
                        outpath, rec,
                        domain_block_iter(signal, tile_size, range_size, domain_step),
                        n_domains, range_size, framerate, sampwidth, tile_size,
                        domain_step, energy_threshold, original_len,
                    )
        else:
            mesh = _mesh(devices, tp, device)
            if mesh is not None:
                enc = compress_audio_sharded(
                    signal, framerate, sampwidth, mesh=mesh, tile_size=tile,
                    energy_thresh=energy_thresh, search=search, **kwargs,
                )
            else:
                enc = compress_audio_arrays(
                    signal, framerate, sampwidth, tile_size=tile,
                    energy_thresh=energy_thresh, use_gpu=use_gpu, search=search,
                    device=device, **kwargs,
                )
            (
                rec, domains, n_ranges, range_size, tile_size, domain_step,
                energy_threshold, original_len,
            ) = enc
            logger.info("Processed %d ranges, domain matrix shape %s", n_ranges, domains.shape)
            if prune_bank:
                rec, domains = _prune(rec, domains)
                logger.info("Pruned bank to %d referenced domains", len(domains))
            outpath = _resolve_out(path, outdir, ".fwav", ".fwav")
            _save(outpath, rec, domains, range_size, framerate, sampwidth,
                  tile_size, domain_step, energy_threshold, original_len)
        elapsed = time.time() - start
        ratio = compression_ratio(os.path.getsize(path), os.path.getsize(outpath))
        xrt = x_realtime(original_len, framerate, elapsed)
        logger.info(
            "Compressed %s -> %s  time=%.2fs  ratio=%.2f  x_realtime=%.1f",
            path, outpath, elapsed, ratio, xrt,
        )
        return {"input": path, "output": outpath, "time_s": elapsed,
                "ratio": ratio, "x_realtime": xrt}
    except Exception as e:  # noqa: BLE001 — per-file isolation, like the reference
        logger.exception("Compression failed for %s", path)
        return {"input": path, "error": str(e)}


def _process_file_compress_multi(path, outdir, tile, energy_thresh, search="auto",
                                 devices=1, tp=1, mid_side=False, device="cuda", **kwargs):
    """Channel-preserving compress: every channel encodes on its own, all
    channels of a short file in one packed device program (channel by
    channel over a mesh, through compress_audio_sharded), a long file
    channel by channel through the streaming encoder; the pruned channels
    are written as one v3 container."""
    from ..io.multich import (
        TRANSFORM_DIRECT,
        TRANSFORM_MS,
        ms_forward,
        save_compressed_multi,
    )

    try:
        start = time.time()
        with phase("wav_read"):
            ch_data, framerate, sampwidth = read_wav(path)
            if sampwidth == 4:
                ch_data = np.clip(ch_data.astype(np.float32), -1.0, 1.0)
        transform = TRANSFORM_DIRECT
        if mid_side:
            if ch_data.shape[1] != 2:
                raise ValueError(
                    "channels='ms' requires stereo input "
                    f"({ch_data.shape[1]} channels found)"
                )
            ch_data = ms_forward(ch_data)
            transform = TRANSFORM_MS
        signals = [np.ascontiguousarray(ch_data[:, c]) for c in range(ch_data.shape[1])]

        mesh = _mesh(devices, tp, device)
        if len(signals[0]) > STREAMING_THRESHOLD:
            encoded = [
                _streamed_pruned(sig, framerate, sampwidth, tile, energy_thresh, search,
                                 mesh=mesh, device=device, **kwargs)
                for sig in signals
            ]
        elif mesh is not None:
            encoded = [
                _prune_tuple(_prune, compress_audio_sharded(
                    sig, framerate, sampwidth, mesh=mesh, tile_size=tile,
                    energy_thresh=energy_thresh, search=search, **kwargs,
                ), framerate, sampwidth)
                for sig in signals
            ]
        else:
            encoded = [
                _prune_tuple(_prune, enc, framerate, sampwidth)
                for enc in compress_audio_packed(
                    signals, framerate, sampwidth, tile_size=tile,
                    energy_thresh=energy_thresh, search=search, device=device, **kwargs,
                )
            ]

        outpath = _resolve_out(path, outdir, ".fwav", ".fwav")
        save_compressed_multi(outpath, encoded, transform=transform,
                              decode_damping=_profile_hint(kwargs))
        elapsed = time.time() - start
        ratio = compression_ratio(os.path.getsize(path), os.path.getsize(outpath))
        xrt = x_realtime(len(signals[0]), framerate, elapsed)
        logger.info(
            "Compressed %s (%d ch) -> %s  time=%.2fs  ratio=%.2f  x_realtime=%.1f",
            path, len(signals), outpath, elapsed, ratio, xrt,
        )
        return {"input": path, "output": outpath, "time_s": elapsed,
                "ratio": ratio, "x_realtime": xrt, "channels": len(signals)}
    except Exception as e:  # noqa: BLE001 — per-file isolation
        logger.exception("Compression failed for %s", path)
        return {"input": path, "error": str(e)}


def _prune_tuple(prune, enc, framerate, sampwidth):
    """(rec, domains, ...) 8-tuple -> the pruned 9-tuple of the v3 writer."""
    (rec, domains, _n_ranges, range_size, tile_size, domain_step,
     energy_threshold, original_len) = enc
    rec, domains = prune(rec, domains)
    return (rec, domains, range_size, framerate, sampwidth, tile_size,
            domain_step, energy_threshold, original_len)


def _streamed_pruned(signal, framerate, sampwidth, tile, energy_thresh, search,
                     mesh=None, device="cuda", **kwargs):
    """One channel through the streaming encoder and the prune from the
    signal (the mono streaming branch's recipe); the 9-tuple of the v3
    writer."""
    (
        rec, _, _n_ranges, range_size, tile_size, domain_step,
        energy_threshold, original_len,
    ) = compress_audio_streaming(
        signal, framerate, sampwidth, tile_size=tile, energy_thresh=energy_thresh,
        search=search, mesh=mesh, device=device, **kwargs,
    )
    rec, bank = _prune_streamed(rec, signal, tile_size, range_size, domain_step)
    return (rec, bank, range_size, framerate, sampwidth, tile_size,
            domain_step, energy_threshold, original_len)


def process_files_compress_packed(jobs, tile=1024, energy_thresh=1e-4, search="auto",
                                  prune_bank=False, compact=False, objective="balanced",
                                  devices=1, tp=1, device="cuda"):
    """Batch compress through compress_audio_packed (CLI `--batch
    --packed`): one device program per same-bucket stack of files, then a
    save per file. jobs: [(input_wav, output_fwav), ...]. Files are read
    and encoded in slices of 64, so that a large directory is never held
    whole. A file over STREAMING_THRESHOLD takes process_file_compress; a
    slice whose packed encode raises is encoded file by file on the same
    device. Returns one dict per job: "packed": True marks a file of a
    packed stack, whose time_s is the packed encode and save time shared
    across those files; an unreadable file gives its error dict. devices >
    1 splits each stack's files over every cell of the (devices // tp, tp)
    mesh; fewer devices than requested fails every job alike."""
    if compact:
        from ..io.compact import save_compressed_compact

        prune_bank_ = True
        _save = functools.partial(save_compressed_compact,
                                  decode_damping=_profile_hint({"objective": objective}))
    else:
        _save = _save_v1
        prune_bank_ = prune_bank
    try:
        mesh = _mesh(devices, tp, device)
    except ValueError as e:  # the single-file path's error dicts, for every job
        logger.error("Batch mesh setup failed: %s", e)
        return [{"input": p, "error": str(e)} for p, _ in jobs]

    def one_by_one(k):
        return process_file_compress(
            jobs[k][0], jobs[k][1], tile, energy_thresh, prune_bank=prune_bank,
            search=search, compact=compact, objective=objective, device=device,
        )

    results = [None] * len(jobs)
    n_packed = 0
    packed_elapsed = 0.0  # time inside packed encode + save only (see time_s)
    slice_files = 64
    for s0 in range(0, len(jobs), slice_files):
        loaded = []
        for k in range(s0, min(len(jobs), s0 + slice_files)):
            path = jobs[k][0]
            try:
                with phase("wav_read"):
                    signal, framerate, sampwidth = read_wav_mono(path)
            except Exception as e:  # noqa: BLE001 — per-file isolation
                logger.exception("Compression failed for %s", path)
                results[k] = {"input": path, "error": str(e)}
                continue
            if len(signal) > STREAMING_THRESHOLD:
                results[k] = one_by_one(k)
                continue
            if sampwidth == 4:
                signal = np.clip(signal.astype(np.float32), -1.0, 1.0)
            loaded.append((k, signal, framerate, sampwidth))

        t_slice = time.time()
        try:
            encoded = compress_audio_packed(
                [sig for _, sig, _, _ in loaded], 0, 0, tile_size=tile,
                energy_thresh=energy_thresh, search=search, objective=objective,
                mesh=mesh, device=device,
            )
        except Exception:  # noqa: BLE001 — resolve blame per file
            logger.exception("Packed encode failed for a %d-file slice; falling back to "
                             "per-file encode", len(loaded))
            for k, *_ in loaded:
                results[k] = one_by_one(k)
            continue
        n_packed += len(loaded)
        for (k, _sig, framerate, sampwidth), enc in zip(loaded, encoded):
            path, outpath = jobs[k]
            try:
                (rec, domains, _n_ranges, range_size, tile_size, domain_step,
                 energy_threshold, original_len) = enc
                if prune_bank_:
                    rec, domains = _prune(rec, domains)
                outpath = _resolve_out(path, outpath, ".fwav", ".fwav")
                _save(outpath, rec, domains, range_size, framerate, sampwidth,
                      tile_size, domain_step, energy_threshold, original_len)
                results[k] = {
                    "input": path, "output": outpath,
                    "ratio": compression_ratio(os.path.getsize(path),
                                               os.path.getsize(outpath)),
                    "packed": True,
                }
            except Exception as e:  # noqa: BLE001
                logger.exception("Compression failed for %s", path)
                results[k] = {"input": path, "error": str(e)}
        packed_elapsed += time.time() - t_slice
    share = packed_elapsed / max(n_packed, 1)
    for r in results:
        if r is not None and r.get("packed"):
            r["time_s"] = share
    logger.info("Packed-compressed %d files in %.2fs (%.1f files/s)", n_packed,
                packed_elapsed, n_packed / packed_elapsed if packed_elapsed > 0 else 0)
    return results


def _decode_window(rec, domains, n_ranges, range_size, framerate, original_len,
                   start_s, duration_s, **decode_kwargs):
    """The full decode, or with start_s / duration_s the segment decode of
    that window (exact: ranges decode independently)."""
    if start_s is None and duration_s is None:
        return decompress_audio(rec, domains, n_ranges, range_size,
                                original_len=original_len, **decode_kwargs)
    a = int(round((start_s or 0.0) * framerate))
    b = a + int(round(duration_s * framerate)) if duration_s is not None else int(original_len)
    return decompress_segment(rec, domains, n_ranges, range_size, a, b,
                              original_len=original_len, **decode_kwargs)


def process_file_decompress(path, outdir=None, iterations=8, eps=1e-3, use_gpu=False,
                            s_damping=None, start_s=None, duration_s=None, devices=1,
                            tp=1, device="cuda", **kwargs):
    """Decode one .fwav to a WAV. start_s / duration_s decode only that
    window (models/decode.py decompress_segment). s_damping=None honours
    the container's stored decode hint and falls back to 0 (the
    reference's default) where there is none; an explicit value, 0
    included, overrides the hint. A v3 file decodes every channel, undoes
    mid/side and writes a multichannel WAV. devices > 1 runs a damped decode
    (s_damping > 0) range-sharded over the mesh's dp axis; the closed form
    (s_damping 0) ignores the mesh and builds none, so --devices N stays
    harmless on a smaller host there."""
    try:
        start = time.time()
        hint_applied = None
        if s_damping is None:
            hint_applied = _stored_decode_hint(path)
            s_damping = hint_applied if hint_applied is not None else 0.0
            if hint_applied:
                logger.info("Using stored decode hint: s_damping=%.2f "
                            "(pass --damping to override)", s_damping)
        if s_damping > 0:
            kwargs["mesh"] = _mesh(devices, tp, device)
        decode_kwargs = dict(kwargs, iterations=iterations, convergence_eps=eps,
                             use_gpu=use_gpu, s_damping=s_damping, device=device)
        if read_version(path) == 3:
            return _process_file_decompress_multi(path, outdir, start, start_s,
                                                  duration_s, **decode_kwargs)
        (
            rec, domains, n_ranges, range_size, framerate, sampwidth,
            _tile_size, _domain_step, _energy_threshold, original_len,
        ) = load_compressed_arrays(path)
        # the convergence counters of the decode, surfaced in the metrics
        dec_stats = decode_kwargs.setdefault("stats", {})
        recon = _decode_window(rec, domains, n_ranges, range_size, framerate,
                               original_len, start_s, duration_s, **decode_kwargs)
        if sampwidth == 4:
            recon = np.clip(recon, -1.0, 1.0)
        outpath = _resolve_out(path, outdir, "_recon.wav", ".wav")
        write_wav(outpath, np.asarray(recon), framerate, sampwidth)
        elapsed = time.time() - start
        xrt = x_realtime(len(recon), framerate, elapsed)
        logger.info("Decompressed %s -> %s  time=%.2fs  x_realtime=%.1f",
                    path, outpath, elapsed, xrt)
        out = {"input": path, "output": outpath, "time_s": elapsed, "x_realtime": xrt}
        if s_damping:
            out["s_damping"] = s_damping
            if hint_applied is not None:
                out["s_damping_from_hint"] = True
        if dec_stats:
            out["decode_iterations"] = dec_stats["iterations"]
            out["decode_final_delta"] = dec_stats["final_delta"]
            out["decode_converged"] = dec_stats["converged"]
        return out
    except Exception as e:  # noqa: BLE001
        logger.exception("Decompression failed for %s", path)
        return {"input": path, "error": str(e)}


def _process_file_decompress_multi(path, outdir, start, start_s=None, duration_s=None,
                                   **decode_kwargs):
    """Decode a v3 container: every channel with the mono path's decoder,
    mid/side undone, one frame-major WAV. The caller owns the error dict."""
    from ..io.multich import TRANSFORM_MS, load_compressed_multi, ms_inverse

    channels, transform = load_compressed_multi(path)
    recons = []
    for (
        rec, domains, n_ranges, range_size, framerate, sampwidth,
        _tile_size, _domain_step, _energy_threshold, original_len,
    ) in channels:
        recons.append(np.asarray(_decode_window(
            rec, domains, n_ranges, range_size, framerate, original_len,
            start_s, duration_s, **decode_kwargs)))
    out = np.stack(recons, axis=1)
    if transform == TRANSFORM_MS:
        out = ms_inverse(out)
    if sampwidth == 4:
        out = np.clip(out, -1.0, 1.0)
    outpath = _resolve_out(path, outdir, "_recon.wav", ".wav")
    write_wav(outpath, out, framerate, sampwidth)
    elapsed = time.time() - start
    xrt = x_realtime(len(out), framerate, elapsed)
    logger.info("Decompressed %s (%d ch) -> %s  time=%.2fs  x_realtime=%.1f",
                path, out.shape[1], outpath, elapsed, xrt)
    return {"input": path, "output": outpath, "time_s": elapsed,
            "x_realtime": xrt, "channels": int(out.shape[1])}
