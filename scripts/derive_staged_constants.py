#!/usr/bin/env python3
"""Derive the staged-refine and wide-tile constants that chip_smoke.py holds
the card to.

    JAX_PLATFORMS=cpu python scripts/derive_staged_constants.py [case ...]

For each case of chip_smoke.STAGED (a single-shot encode whose coarse
refine is the staged one: a 60 s file, whose bank is over the window
refine's 9 MB means cap, and 10 s files at tile 512 and tile 2048) and of
chip_smoke.WIDE (10 s at tiles 8192 and 16384: range sizes 32 and 64,
which K1 and K3 scan with their wide kernels on the card) it runs
the JAX package on the CPU on its kernel path
(EncoderConfig(use_pallas=True)) and prints the range count, the sentinel
count and the round-trip SNR, then runs the port on the CPU (the plain
versions) and prints how far its records are from the JAX run's. The
numbers go into chip_smoke.STAGED and chip_smoke.WIDE by hand;
tests/test_torch_encode.py::test_staged_constants_of_chip_smoke and
::test_wide_constants_of_chip_smoke re-derive them.
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def main(argv):
    import torch

    import fwav_tpu_torch as port
    from fwav_tpu.config import EncoderConfig as JaxEncoderConfig
    from fwav_tpu.models.decode import decompress_audio as jax_decode
    from fwav_tpu.models.encode import compress_audio_arrays as jax_encode
    from fwav_tpu.utils.metrics import compute_snr

    torch.set_num_threads(4)
    cases = {**chip_smoke.STAGED, **chip_smoke.WIDE}
    for name in argv or list(cases):
        case = cases[name]
        sig = bench.make_signal(case["seconds"])
        jcfg = JaxEncoderConfig(use_pallas=True, **case["kw"])
        t0 = time.perf_counter()
        J = jax_encode(sig, 44100, 2, config=jcfg)
        t_jax = time.perf_counter() - t0
        snr_j = compute_snr(sig, jax_decode(J[0], J[1], J[2], J[3], original_len=J[7],
                                            **case["decode"]))
        cfg = port.EncoderConfig.from_reference(dataclasses.asdict(jcfg))
        t0 = time.perf_counter()
        T = port.compress_audio_arrays(sig, 44100, 2, config=cfg, device="cpu")
        t_port = time.perf_counter() - t0
        snr_t = compute_snr(sig, port.decompress_audio(
            T[0], T[1], T[2], T[3], original_len=T[7], device="cpu", **case["decode"]))
        print(json.dumps({
            "case": name, "n_ranges": int(J[2]),
            "sentinels": int((J[0]["idx"] < 0).sum()), "snr_db": round(float(snr_j), 4),
            "port_sentinels_equal": bool(np.array_equal(J[0]["idx"] < 0, T[0]["idx"] < 0)),
            "port_idx_diff": int((J[0]["idx"] != T[0]["idx"]).sum()),
            "port_snr_db": float(snr_t), "jax_cpu_s": t_jax, "port_cpu_s": t_port,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
