"""The share of the packed stacks' scan grids that belongs to no file,
over the timed requests (%): 100 (1 - valid_pairs / grid_pairs) of the
program's packing counter (ops/kernels.py PACKS: each file's ranges times
its bank rows, against its bucket's), as the packed entry records it per
request (entries/packed.py). Nothing where the entry keeps no such record
or the program has no such counter."""


def read(run):
    totals = getattr(run.entry, "pack_totals", None)
    got = totals(run.timed) if totals else None
    if not got or not got.get("grid_pairs"):
        return None
    return 100.0 * (1.0 - got["valid_pairs"] / got["grid_pairs"])
