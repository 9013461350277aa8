"""How far the host refit's numpy fallback is from its native version.

    JAX_PLATFORMS=cpu python scripts/compare_native_fallback.py [--seconds 1.0]

Encodes bench.make_signal(SECONDS) with search="topk" twice in each
package, the JAX package (fwav_tpu) and the port (fwav_tpu_torch, on the
CPU): once with the native library of fwavio.cpp, once with the library
held unloaded so that the refit runs its numpy version. Prints, per
package, one JSON line: the share of record bytes that differ, whether the
idx agree, and the share of rows whose s, o, err or sym differ. Run from
the repository root (both packages and bench.py are imported from there).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def _fallback(native):
    """Hold the package's native library unloaded (its _load gives None)."""
    with native._lock:
        native._lib, native._tried = None, True


def _compare(label, native, encode):
    if native._load() is None:
        raise SystemExit(f"{label}: the native library does not load")
    lib = native._lib
    rec_n = encode()
    _fallback(native)
    rec_f = encode()
    with native._lock:
        native._lib, native._tried = lib, True
    a, b = rec_n.view(np.uint8), rec_f.view(np.uint8)
    rows = {k: float(np.mean(rec_n[k] != rec_f[k])) for k in ("s", "o", "err", "sym")}
    print(json.dumps({
        "package": label, "n_ranges": len(rec_n),
        "bytes_differ": float(np.mean(a != b)),
        "idx_equal": bool(np.array_equal(rec_n["idx"], rec_f["idx"])),
        "rows_differ": rows,
    }), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()

    import numpy as np

    import bench

    sig = bench.make_signal(args.seconds)

    from fwav_tpu.io import native as jax_native
    from fwav_tpu.models.encode import compress_audio_arrays as jax_encode

    _compare("fwav_tpu", jax_native,
             lambda: jax_encode(sig, 44100, 2, search="topk")[0])

    import torch

    torch.set_num_threads(4)
    import fwav_tpu_torch as port
    from fwav_tpu_torch.io import native as port_native

    _compare("fwav_tpu_torch", port_native,
             lambda: port.compress_audio_arrays(sig, 44100, 2, search="topk",
                                                device="cpu")[0])
