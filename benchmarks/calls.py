"""The kernel calls one encode makes, with the counts their work depends
on, from the file's length and the configuration's plan alone (the
reference's copy of the codec's plan): every count is a valid one (ranges
of the file or the shard, bank rows of its window), never a padded
bucket."""

from __future__ import annotations

from .reference.encode import Plan, Settings, n_domains_for, plan
from .reference.stream import GLOBAL_TOPC, global_stride, stream_plan


def descent_rows(W: int) -> int:
    """Rows one lobe's staged descent scores: samples at step 16 then 4
    (8 alone for a window under 64), then a dense window of step + 2."""
    if W >= 64:
        return (W // 16 + 1) + (2 * 8 // 4 + 1) + (4 + 2)
    return (W // 8 + 1) + (8 + 2)


def _search_calls(cfg: Settings, p: Plan, M: int, D: int) -> list[dict]:
    """The scan and the refine of one program over M ranges and D rows."""
    n = cfg.range_size
    clip = cfg.objective == "damped"
    if p.mode == "exact":
        return [dict(kernel="k1", M=M, N=n, D=D, clip=clip)]
    calls = [dict(kernel="k1" if p.topc == 1 else "k3", M=M, N=n, D=-(-D // p.stride),
                  C=p.topc, clip=clip)]
    W = p.stride + p.stride // 4
    if p.refine == "window":
        L = D + (n - 1) * (cfg.tile_size // n)
        calls.append(dict(kernel="k2", M=M, N=n, C=p.topc, W=W, L=L))
    else:
        W = max(2, W)
        R = descent_rows(W) if p.stride >= 32 and p.topc == 1 else p.topc * W
        calls.append(dict(kernel="k4", M=M, N=n, C=p.topc, R=R, D=D))
    return calls


def single_calls(cfg: Settings, n_samples: int) -> list[dict]:
    """The calls of one file's single-shot program."""
    p = plan(cfg, n_samples)
    return _search_calls(cfg, p, p.n_ranges, p.n_domains)


def stream_calls(cfg: Settings, n_samples: int) -> list[dict]:
    """The calls of one streamed file: one program per time shard and, for
    the damped objective, the whole-file pass (K3's top 4 over the
    subsampled bank, then each lobe column's staged descent)."""
    sp = stream_plan(cfg, n_samples)
    calls = [c for _, m, n_dom, _, _ in sp.geo if n_dom
             for c in _search_calls(cfg, sp.plan, m, n_dom)]
    if cfg.objective == "damped" and len(sp.bounds) > 1:
        n = cfg.range_size
        M = -(-n_samples // n)
        D = n_domains_for(n_samples, cfg.tile_size, cfg.domain_step)
        stride = global_stride(D)
        W = stride + stride // 4
        calls += [dict(kernel="k3", M=M, N=n, D=-(-D // stride), C=GLOBAL_TOPC, clip=True),
                  dict(kernel="k4", M=M, N=n, C=GLOBAL_TOPC, R=GLOBAL_TOPC * descent_rows(W),
                       D=D)]
    return calls
