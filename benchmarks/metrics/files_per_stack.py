"""Files a packed stack holds, over the timed requests (files): the
program's packing counter (ops/kernels.py PACKS, `stack_files` over
`stacks`), as the packed entry records it per request
(entries/packed.py). Nothing where the entry keeps no such record or the
program has no such counter."""


def read(run):
    totals = getattr(run.entry, "pack_totals", None)
    got = totals(run.timed) if totals else None
    if not got or not got.get("stacks"):
        return None
    return got["stack_files"] / got["stacks"]
