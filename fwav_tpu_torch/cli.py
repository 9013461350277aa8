"""CLI: `python -m fwav_tpu_torch` (console script `fwavc-torch`), the
counterpart of fwav_tpu/cli.py.

Subcommands compress, decompress, info, snr and warmup, with the JAX CLI's
flags, defaults, validation and exit codes: 0 on success, 1 if any file
failed. Batch mode lists *.wav or *.fwav, skips outputs that exist
(resume) and writes compression_metrics.json or
decompression_metrics.json. Batch work fans out over a thread pool; the
device programs of the threads take turns under models/program.py's
DEVICE_LOCK.

New here: --device {cuda,cpu} on compress, decompress and warmup, "cuda"
by default; a CUDA request without a card is the file's error (exit code
1), never a run on the CPU. --gpu is accepted and does nothing. --devices
N runs over a (N // --tp, --tp) mesh of --device's kind (the cards, or N
CPU cells for --device cpu); fewer cards than N is the file's error (exit
code 1), as in the JAX CLI. --exec-cache is accepted and ignored: it serializes XLA executables
in the JAX package, and the port's nvcc output is cached in
fwav_tpu_torch/_build/.

`info` and `snr` import only the container, WAV and metrics modules: they
never import the kernels' module nor initialize CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .utils.logging import configure_cli_logging, logger


def _run_jobs(fn, jobs, workers):
    if not jobs:
        return []
    with ThreadPoolExecutor(max_workers=min(workers, len(jobs))) as pool:
        return list(pool.map(lambda args: fn(*args), jobs))


def _exit_code(results) -> int:
    """0 unless any per-file result reports an error."""
    if isinstance(results, dict):
        results = [results]
    return 1 if any("error" in (r or {}) for r in results) else 0


def _run_batch(in_dir, out_dir, ext, out_name, run_todo, metrics_name, verb):
    """Shared batch scaffolding: list *ext files, skip those whose output
    exists, run the rest, write the metrics JSON. `out_name(base)` maps an
    input basename to its output name; `run_todo(todo)` returns one metrics
    dict per file."""
    files = [
        os.path.join(in_dir, f)
        for f in sorted(os.listdir(in_dir))
        if f.lower().endswith(ext)
    ]
    todo = []
    for f in files:
        outpath = os.path.join(out_dir, out_name(os.path.basename(f)))
        if not os.path.exists(outpath):
            todo.append((f, outpath))
    logger.info("Batch %s %d/%d files", verb, len(todo), len(files))
    if not todo:
        logger.info("Nothing to do — all outputs already exist.")
        return 0
    os.makedirs(out_dir, exist_ok=True)
    results = run_todo(todo)
    metrics_file = os.path.join(out_dir, metrics_name)
    with open(metrics_file, "w") as mf:
        json.dump(results, mf, indent=2)
    logger.info("Wrote metrics to %s", metrics_file)
    return _exit_code(results)


def _info_multichannel(path, verify) -> int:
    """`info` of a v3 container: the outer header, the shared per-channel
    geometry and each channel's sentinel count."""
    from .io.multich import TRANSFORM_MS, parse_multi_bytes

    checksum_state = "not checked"
    with open(path, "rb") as f:
        data = f.read()
    try:
        channels, transform = parse_multi_bytes(data, verify_checksum=bool(verify))
        if verify:
            checksum_state = "verified"
    except ValueError as e:
        if verify:
            print(json.dumps({
                "file": path, "error": str(e), "checksum": f"FAILED: {e}",
            }, indent=2))
            return 1
        print(json.dumps({"file": path, "error": str(e)}, indent=2))
        return 1
    (
        rec0, _domains0, n_ranges, range_size, framerate, sampwidth,
        tile_size, domain_step, energy_threshold, original_len,
    ) = channels[0]
    info = {
        "file": path,
        "version": 3,
        "n_channels": len(channels),
        "channel_transform": "mid_side" if transform == TRANSFORM_MS else "direct",
        "n_ranges": int(n_ranges),
        "n_domains_per_channel": [int(len(c[1])) for c in channels],
        "range_size": int(range_size),
        "tile_size": int(tile_size),
        "domain_step": int(domain_step),
        "framerate": int(framerate),
        "sampwidth": int(sampwidth),
        "energy_threshold": float(energy_threshold),
        "original_len": int(original_len),
        "duration_s": round(original_len / framerate, 3) if framerate else None,
        "silent_sentinel_ranges": [int(np.sum(c[0]["idx"] < 0)) for c in channels],
        "file_bytes": os.path.getsize(path),
        "checksum": checksum_state,
    }
    try:
        from .io.compact import describe_layout
        from .io.multich import iter_channel_blobs

        info["v2_layout_per_channel"] = [
            describe_layout(blob) for _, blob in iter_channel_blobs(data)
        ]
        for lay in info["v2_layout_per_channel"]:
            if lay and "decode_damping_hint" in lay:
                info["decode_damping_hint"] = lay["decode_damping_hint"]
                break
    except ValueError:
        pass  # the framing is reported above; the layout is best effort
    print(json.dumps(info, indent=2))
    return 0


def _info(args) -> int:
    """`info`: the header and integrity report of one .fwav, as JSON."""
    from .io.container import read_header, read_matches, read_version

    try:
        if read_version(args.input) == 3:
            return _info_multichannel(args.input, args.verify)
    except (ValueError, OSError) as e:
        print(json.dumps({"file": args.input, "error": str(e)}, indent=2))
        return 1

    checksum_state = "not checked"
    if args.verify:
        from .io.container import load_compressed_arrays

        try:
            load_compressed_arrays(args.input, verify_checksum=True)
            checksum_state = "verified"
        except ValueError as e:
            # every corruption class the loaders raise is a ValueError: a
            # clean FAILED verdict with exit code 1, never a traceback
            checksum_state = f"FAILED: {e}"
    # the header and the match table only, never the whole bank
    try:
        (range_size, framerate, sampwidth, tile_size, domain_step,
         energy_threshold, n_ranges, n_domains, original_len) = read_header(args.input)
    except (ValueError, OSError) as e:
        print(json.dumps({
            "file": args.input, "error": str(e),
            "checksum": checksum_state if args.verify else "not checked",
        }, indent=2))
        return 1
    try:
        rec = read_matches(args.input)
        sentinels = int(np.sum(rec["idx"] < 0)) if len(rec) else 0
    except ValueError:
        # a v2 file's match streams live inside its (possibly corrupt)
        # payload; the header still reports
        sentinels = None
    info = {
        "file": args.input,
        "version": read_version(args.input),
        "n_ranges": int(n_ranges),
        "n_domains": int(n_domains),
        "range_size": int(range_size),
        "tile_size": int(tile_size),
        "domain_step": int(domain_step),
        "framerate": int(framerate),
        "sampwidth": int(sampwidth),
        "energy_threshold": float(energy_threshold),
        "original_len": int(original_len),
        "duration_s": round(original_len / framerate, 3) if framerate else None,
        "silent_sentinel_ranges": sentinels,
        "file_bytes": os.path.getsize(args.input),
        "checksum": checksum_state,
    }
    if info["version"] == 2:
        # the header-level layout report: works on corrupt payloads too
        from .io.compact import describe_layout

        with open(args.input, "rb") as f:
            head = f.read(128)
        layout = describe_layout(head)
        if layout is not None:
            info["v2_layout"] = layout
            if "decode_damping_hint" in layout:
                info["decode_damping_hint"] = layout["decode_damping_hint"]
    print(json.dumps(info, indent=2))
    return 1 if checksum_state.startswith("FAILED") else 0


def _snr(args) -> int:
    """`snr`: the round-trip SNR of two WAVs, per channel where both have
    several, else over the mono folds."""
    from .io.wav import read_wav, read_wav_mono
    from .utils.metrics import compute_snr

    a, sr_a, _ = read_wav(args.original)
    b, sr_b, _ = read_wav(args.reconstruction)
    if sr_a != sr_b:
        logger.warning("sample rates differ: %d vs %d", sr_a, sr_b)
    report = {"original": args.original, "reconstruction": args.reconstruction}
    if a.shape[1] == b.shape[1]:
        report["snr_db"] = round(compute_snr(a.reshape(-1), b.reshape(-1)), 4)
        if a.shape[1] > 1:
            n = min(len(a), len(b))
            report["channels"] = a.shape[1]
            report["snr_db_per_channel"] = [
                round(compute_snr(a[:n, c], b[:n, c]), 4) for c in range(a.shape[1])
            ]
    else:
        logger.warning("channel counts differ (%d vs %d): comparing mono folds",
                       a.shape[1], b.shape[1])
        a, _, _ = read_wav_mono(args.original)
        b, _, _ = read_wav_mono(args.reconstruction)
        report["snr_db"] = round(compute_snr(a, b), 4)
        report["compared"] = "mono_fold"
    report["compared_samples"] = int(min(len(a), len(b)))
    print(json.dumps(report, indent=2))
    return 0


def _warmup(args) -> int:
    """Build the CUDA kernels (on a card) and run one encode of the asked
    duration, and the damped decode with --decode-damping; log the build
    and encode seconds. nvcc's output is kept in fwav_tpu_torch/_build/, so
    later processes skip the build; the encode warms this process only."""
    import time

    from .models.codec import STREAMING_THRESHOLD
    from .models.encode import compress_audio_arrays

    n = int(args.seconds * args.rate)
    if n <= 0:
        logger.error("warmup needs --seconds > 0")
        return 1
    if n > STREAMING_THRESHOLD:
        logger.error(
            "warmup --seconds %.0f exceeds the single-shot limit (%.0f s at this rate): "
            "such files stream through other programs; compress one representative "
            "file instead.", args.seconds, STREAMING_THRESHOLD / args.rate,
        )
        return 1
    t_build = 0.0
    try:
        if args.device == "cuda":
            from .ops import _build
            from .utils.device import resolve_device

            resolve_device("cuda")
            t0 = time.time()
            _build.load()
            t_build = time.time() - t0
        # noise keeps every stage live; integral samples take the int16
        # transfer that 8/16/24-bit WAVs take (--float32: the float one)
        rng = np.random.default_rng(0)
        sig = np.round(rng.normal(0.0, 0.2, n) * 16000.0).astype(np.float32)
        if args.float32:
            sig += 0.5
        objective = "damped" if args.profile == "damped" else "balanced"
        t0 = time.time()
        rec, domains, n_ranges, range_size, *_ = compress_audio_arrays(
            sig, args.rate, 2, tile_size=args.tile, objective=objective, device=args.device,
        )
        t_enc = time.time() - t0
        t_dec = 0.0
        if args.decode_damping is not None and args.decode_damping > 0:
            from .models.decode import decompress_audio
            from .models.encode import prune_bank

            rec_p, bank_p = prune_bank(rec, domains)
            t0 = time.time()
            decompress_audio(rec_p, bank_p, n_ranges, range_size,
                             s_damping=args.decode_damping, device=args.device)
            t_dec = time.time() - t0
    except Exception:  # noqa: BLE001 — the CLI's contract: a logged error, exit 1
        logger.exception("warmup failed")
        return 1
    logger.info(
        "Warmed %.1f s @ %d Hz (%s profile) on %s: kernel build %.1f s, encode %.2f s%s",
        args.seconds, args.rate, args.profile, args.device, t_build, t_enc,
        f", damped decode {t_dec:.2f} s" if t_dec else "",
    )
    return 0


def _add_device(p, help_tail=""):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="run on the CUDA card (default) or, when asked for, on the "
                        "CPU through the kernels' plain versions; a CUDA request "
                        "without a card fails the file" + help_tail)


def _add_mesh_flags(p, devices_help, tp_help):
    p.add_argument("--devices", type=int, default=1, help=devices_help)
    p.add_argument("--tp", type=int, default=1, help=tp_help)
    p.add_argument("--exec-cache", default=None, metavar="DIR",
                   help="accepted and ignored: the JAX package's serialized "
                        "executables; nvcc output is cached in fwav_tpu_torch/_build/")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fwav_tpu_torch",
        description="Fractal WAV compressor on PyTorch and CUDA, with batch "
                    "processing and metrics",
    )
    sub = parser.add_subparsers(dest="cmd")

    pc = sub.add_parser("compress")
    pc.add_argument("input", help="input WAV file or directory")
    pc.add_argument("output", nargs="?", default=None,
                    help="output FWAV file (required unless --batch)")
    pc.add_argument("--tile", type=int, default=1024)
    pc.add_argument("--out", default=None, help="output directory (batch mode)")
    pc.add_argument("--energy-thresh", type=float, default=1e-4)
    pc.add_argument("--gpu", action="store_true",
                    help="accepted for parity; --device picks the device")
    pc.add_argument("--batch", action="store_true",
                    help="treat input as directory and compress all WAV inside")
    pc.add_argument("--workers", type=int, default=4,
                    help="parallel file-level workers for batch")
    pc.add_argument("--packed", action="store_true",
                    help="batch mode: encode same-bucket files in one device program "
                         "per stack of up to 16 (each kernel launches once a stack)")
    pc.add_argument("--search", default="auto",
                    choices=["auto", "exact", "coarse", "topk"],
                    help="auto (default: coarse-to-fine for large banks, brute exact "
                         "otherwise), exact, or coarse. topk is the reference-shaped "
                         "embedding-shortlist compatibility mode: auto never picks it")
    pc.add_argument("--prune-bank", dest="prune_bank", action="store_true", default=True,
                    help="store only referenced domain rows (the default): still an "
                         "ordinary .fwav that decodes bit-identically with any decoder")
    pc.add_argument("--full-bank", dest="prune_bank", action="store_false",
                    help="store the entire sliding-window domain bank like the reference")
    pc.add_argument("--compact", action="store_true",
                    help="write the v2 compact container (fp16 bank + entropy-coded "
                         "match streams); defaults to --profile damped and stores the "
                         "decode hint, so a bare decompress realizes the profile")
    pc.add_argument("--profile", default="auto", choices=["auto", "default", "damped"],
                    help="encode profile: 'default' tunes matches for the "
                         "reference-default decode (s_damping=0); 'damped' for the "
                         "damped decoder's fixed point. 'auto' picks damped for "
                         "--compact and --channels keep/ms, 'default' otherwise")
    pc.add_argument("--global-candidates", default="auto", choices=["auto", "on", "off"],
                    dest="global_candidates",
                    help="whole-file candidate pass for long (streaming) encodes; "
                         "'auto' (default) enables it exactly for --profile damped")
    pc.add_argument("--channels", default="fold", choices=["fold", "keep", "ms"],
                    help="multichannel policy: 'fold' (default) averages to mono; "
                         "'keep' encodes every channel into the v3 container; 'ms' "
                         "stores stereo as mid/side")
    pc.add_argument("--resume-dir", default=None, metavar="DIR",
                    help="shard-level crash recovery for long (streaming) encodes")
    _add_mesh_flags(pc, "encode over an N-device mesh (ranges data-parallel; the records "
                        "are bit-identical to one device's)",
                    "bank tensor-parallel shards within --devices (dp = devices // tp)")
    _add_device(pc)

    pw = sub.add_parser(
        "warmup",
        help="build the CUDA kernels and run one encode of a signal duration "
             "(and optionally the damped decode)")
    pw.add_argument("--seconds", type=float, default=10.0,
                    help="signal duration to warm")
    pw.add_argument("--rate", type=int, default=44100)
    pw.add_argument("--tile", type=int, default=1024)
    pw.add_argument("--profile", default="default", choices=["default", "damped"])
    pw.add_argument("--decode-damping", type=float, default=None, metavar="D",
                    help="also run the damped decode loop at this s_damping (e.g. 0.25)")
    pw.add_argument("--float32", action="store_true",
                    help="warm the float32 transfer (sampwidth-4 WAV inputs) instead of "
                         "the int16 one that 8/16/24-bit WAVs use")
    pw.add_argument("--exec-cache", default=None, metavar="DIR",
                    help="accepted and ignored (see compress --exec-cache)")
    _add_device(pw)

    pi = sub.add_parser("info", help="print .fwav header + integrity info")
    pi.add_argument("input", help=".fwav file")
    pi.add_argument("--verify", action="store_true",
                    help="also verify the SHA-256 payload checksum")

    ps = sub.add_parser("snr", help="round-trip quality: SNR between two WAVs")
    ps.add_argument("original", help="original WAV")
    ps.add_argument("reconstruction", help="reconstructed WAV")

    pd = sub.add_parser("decompress")
    pd.add_argument("input", help="input file or directory")
    pd.add_argument("--out", default=None, help="output file or directory")
    pd.add_argument("--iter", type=int, default=8)
    pd.add_argument("--eps", type=float, default=1e-3)
    pd.add_argument("--damping", type=float, default=None,
                    help="s_damping blend toward the per-iteration refit scale (0 = "
                         "reference default). Default: the file's stored decode hint "
                         "when present (damped-profile compact files store 0.25), else 0")
    pd.add_argument("--gpu", action="store_true",
                    help="accepted for parity; --device picks the device")
    pd.add_argument("--batch", action="store_true",
                    help="treat input as directory and decompress all FWAV inside")
    pd.add_argument("--workers", type=int, default=4)
    pd.add_argument("--start", type=float, default=None, metavar="SEC",
                    help="decode only from this time (exact segment decode)")
    pd.add_argument("--duration", type=float, default=None, metavar="SEC",
                    help="length of the decoded segment (with --start)")
    _add_mesh_flags(pd, "run the damped (--damping > 0) decode loop range-sharded over an "
                        "N-device mesh; the default damping=0 decode is a host closed "
                        "form and ignores this",
                    "mesh tp axis within --devices (decode shards only over "
                    "dp = devices // tp)")
    _add_device(pd)
    return parser


def _check_mesh(parser, args):
    if args.devices < 1 or args.tp < 1 or args.devices % args.tp:
        parser.error(f"--tp must divide --devices (got devices={args.devices}, "
                     f"tp={args.tp})")


def main(argv=None) -> int:
    configure_cli_logging()
    parser = build_parser()
    args = parser.parse_args(argv)
    if getattr(args, "workers", 1) < 1:
        parser.error("--workers must be >= 1")
    if getattr(args, "exec_cache", None):
        logger.info("--exec-cache %s ignored: nvcc output is cached in "
                    "fwav_tpu_torch/_build/", args.exec_cache)

    if args.cmd == "warmup":
        return _warmup(args)
    if args.cmd == "info":
        return _info(args)
    if args.cmd == "snr":
        return _snr(args)

    if args.cmd == "compress":
        if args.packed and not args.batch:
            parser.error("--packed only applies to --batch mode")
        _check_mesh(parser, args)
        if args.channels != "fold":
            if not args.prune_bank:
                parser.error("--full-bank only applies to mono containers; "
                             "--channels keep/ms always store pruned compact "
                             "per-channel blobs")
            if args.packed:
                parser.error("--packed batches same-bucket FILES; --channels keep/ms "
                             "already packs a file's channels — use the thread-pool "
                             "batch mode")
            if args.resume_dir:
                parser.error("--resume-dir is not supported with --channels keep/ms "
                             "(per-channel shard checkpoints of one file would collide)")
        from .models.codec import process_file_compress

        profile = args.profile
        if profile == "auto":
            # v2 (--compact) and v3 (--channels keep/ms) store a decode hint,
            # so the damped profile reaches a bare decompress; v1 is hintless
            profile = "damped" if args.compact or args.channels != "fold" else "default"
        objective = "damped" if profile == "damped" else "balanced"
        gcand = {"auto": None, "on": True, "off": False}[args.global_candidates]
        kw = dict(search=args.search, prune_bank=args.prune_bank, compact=args.compact,
                  resume_dir=args.resume_dir, objective=objective, channels=args.channels,
                  global_candidates=gcand, devices=args.devices, tp=args.tp,
                  device=args.device)
        if not args.batch:
            if args.output is None:
                parser.error("compress requires OUTPUT unless --batch is used")
            return _exit_code(process_file_compress(
                args.input, args.output, args.tile, args.energy_thresh, args.gpu, **kw))
        if args.output is not None:
            parser.error("Do not provide positional OUTPUT when using --batch; "
                         "use --out instead")

        def run_todo(todo):
            if args.packed:
                from .models.codec import process_files_compress_packed

                return process_files_compress_packed(
                    todo, tile=args.tile, energy_thresh=args.energy_thresh,
                    search=args.search, prune_bank=args.prune_bank,
                    compact=args.compact, objective=objective, devices=args.devices,
                    tp=args.tp, device=args.device,
                )
            return _run_jobs(
                lambda f, outp: process_file_compress(
                    f, outp, args.tile, args.energy_thresh, args.gpu, **kw),
                todo, args.workers,
            )

        return _run_batch(
            args.input, args.out or args.input, ".wav", lambda base: base + ".fwav",
            run_todo, "compression_metrics.json", "compressing",
        )

    if args.cmd == "decompress":
        _check_mesh(parser, args)
        from .models.codec import process_file_decompress

        # a segment gets its own output name: an excerpt must not pass for
        # the full reconstruction nor trip the batch resume against one
        if args.start is not None or args.duration is not None:
            seg = "_recon_seg"
            if args.start is not None:
                seg += f"_{args.start:g}s"
            if args.duration is not None:
                seg += f"+{args.duration:g}s"
            recon_suffix = seg + ".wav"
        else:
            recon_suffix = "_recon.wav"
        kw = dict(s_damping=args.damping, start_s=args.start, duration_s=args.duration,
                  devices=args.devices, tp=args.tp, device=args.device)
        if not args.batch:
            out_file = args.out or (os.path.splitext(args.input)[0] + recon_suffix)
            return _exit_code(process_file_decompress(
                args.input, out_file, args.iter, args.eps, args.gpu, **kw))

        def run_todo(todo):
            return _run_jobs(
                lambda f, outp: process_file_decompress(
                    f, outp, args.iter, args.eps, args.gpu, **kw),
                todo, args.workers,
            )

        return _run_batch(
            args.input, args.out or args.input, ".fwav",
            lambda base: base[: -len(".fwav")] + recon_suffix, run_todo,
            "decompression_metrics.json", "decompressing",
        )

    parser.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
