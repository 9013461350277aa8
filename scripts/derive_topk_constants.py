#!/usr/bin/env python3
"""Derive the topk constants that chip_smoke.py holds the card to.

    JAX_PLATFORMS=cpu python scripts/derive_topk_constants.py [--seconds S]
        [--keep DIR] [--port]

Writes S seconds (10 by default) of bench.make_signal at 44.1 kHz, 16-bit,
as a WAV, runs the JAX package's CLI on the CPU in this process
(`compress IN OUT --search topk`, then a bare `decompress`) and prints the
range count, the sentinel count and the round-trip SNR of its file. With
--port the port's CLI does the same with `--device cpu` (the plain
versions) and the line also says how far its records are from the JAX
run's. --keep DIR keeps the WAV and the .fwav files there. The numbers go
into chip_smoke.TOPK by hand; tests/test_torch_topk.py::
test_topk_constants_of_chip_smoke (marked slow) re-derives them.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


def run_cli(main, wav: Path, out: Path, extra=()):
    """compress, then a bare decompress, through one CLI's main(); returns
    (records, SNR of the round trip, compress seconds)."""
    from fwav_tpu_torch.io.container import read_matches
    from fwav_tpu_torch.io.wav import read_wav_mono
    from fwav_tpu_torch.utils.metrics import compute_snr

    t0 = time.perf_counter()
    if main(["compress", str(wav), str(out), "--search", "topk", *extra]) != 0:
        raise SystemExit(f"compress failed: {out}")
    enc_s = time.perf_counter() - t0
    recon = out.with_name(out.stem + "_recon.wav")
    if main(["decompress", str(out), "--out", str(recon), *extra]) != 0:
        raise SystemExit(f"decompress failed: {out}")
    snr = compute_snr(read_wav_mono(wav)[0], read_wav_mono(recon)[0])
    return read_matches(out), snr, enc_s


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--keep", default=None, metavar="DIR")
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from fwav_tpu import cli as jax_cli
    from fwav_tpu_torch.io.wav import write_wav

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(args.keep or tmp)
        d.mkdir(parents=True, exist_ok=True)
        wav = d / f"bench{args.seconds:g}.wav"
        write_wav(wav, bench.make_signal(args.seconds), 44100, 2)
        rec_j, snr_j, t_j = run_cli(jax_cli.main, wav, d / "jax_topk.fwav")
        line = {"seconds": args.seconds, "n_ranges": int(len(rec_j)),
                "sentinels": int((rec_j["idx"] < 0).sum()), "snr_db": round(float(snr_j), 4),
                "snr_db_full": float(snr_j), "jax_cpu_compress_s": t_j}
        if args.port:
            from fwav_tpu_torch import cli as port_cli
            from fwav_tpu_torch.io.container import load_compressed_arrays

            rec_t, snr_t, t_t = run_cli(port_cli.main, wav, d / "port_topk.fwav",
                                        ("--device", "cpu"))

            def tiles(path):  # each file prunes its bank: compare the stored tiles
                rec, bank = load_compressed_arrays(path)[:2]
                return np.where((rec["idx"] >= 0)[:, None], bank[np.maximum(rec["idx"], 0)], 0)

            line.update(
                port_sentinels_equal=bool(np.array_equal(rec_j["idx"] < 0, rec_t["idx"] < 0)),
                port_tiles_differ=int((tiles(d / "jax_topk.fwav")
                                       != tiles(d / "port_topk.fwav")).any(1).sum()),
                port_snr_db=float(snr_t), port_cpu_compress_s=t_t,
                files_equal=(d / "jax_topk.fwav").read_bytes()
                == (d / "port_topk.fwav").read_bytes())
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
