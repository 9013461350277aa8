#!/usr/bin/env python
"""Minimal end-to-end example on the PyTorch/CUDA port (fwav_tpu_torch):
synthesize a WAV, compress it to .fwav, decode it back, and report
quality/size. The counterpart of examples/round_trip.py.

    python examples/torch_round_trip.py [--device cuda|cpu] [--profile damped]

`--device cuda` (the default) needs a CUDA card and fails without one;
`--device cpu` runs the kernels' plain versions.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from fwav_tpu_torch import compute_snr
from fwav_tpu_torch.io.wav import read_wav_mono, write_wav
from fwav_tpu_torch.models.codec import process_file_compress, process_file_decompress


def main():
    ap = argparse.ArgumentParser()
    # pruned containers are the default, matching the CLI; --full-bank
    # restores the reference's full-bank layout, --compact writes the
    # rate-focused v2 container
    ap.add_argument("--full-bank", dest="prune_bank", action="store_false",
                    default=True)
    ap.add_argument("--compact", action="store_true")
    ap.add_argument("--profile", default="default",
                    choices=["default", "damped"],
                    help="'damped': clip-aware selection + damped decode")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--sr", type=int, default=44100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    t = np.arange(int(args.sr * args.seconds)) / args.sr
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.15 * np.sin(2 * np.pi * 1320 * t)
    sig[int(0.4 * args.sr):int(0.55 * args.sr)] = 0.0   # a silence gap
    sig = (sig * 0.5 * (2**15 - 1)).astype(np.float32)

    with tempfile.TemporaryDirectory() as d:
        wav = os.path.join(d, "in.wav")
        write_wav(wav, sig, args.sr, 2)

        damped = args.profile == "damped"
        m = process_file_compress(wav, os.path.join(d, "out"),
                                  prune_bank=args.prune_bank, compact=args.compact,
                                  objective="damped" if damped else "balanced",
                                  device=args.device)
        if "error" in m:
            raise SystemExit(f"compress failed: {m['error']}")
        print("compress:", m)
        # damped-profile files decode with their matched damping (the
        # container is unchanged; this is purely a decoder knob)
        r = process_file_decompress(m["output"], os.path.join(d, "rec"),
                                    s_damping=0.25 if damped else 0.0, device=args.device)
        if "error" in r:
            raise SystemExit(f"decompress failed: {r['error']}")
        print("decompress:", r)

        recon, _, _ = read_wav_mono(r["output"])
        print(f"round-trip SNR: {compute_snr(sig, recon):.2f} dB  "
              f"ratio: {m['ratio']:.3f}  encode {m['x_realtime']:.0f}x realtime")


if __name__ == "__main__":
    main()
