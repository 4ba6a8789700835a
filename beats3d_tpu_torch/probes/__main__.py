"""Print every probe script's cost table, measured on the card:

    python -m beats3d_tpu_torch.probes [name ...]

Exits non-zero without a CUDA device.
"""

import sys

from . import PROBES, tiles


def main(argv=None):
    """Print the tables of the named probes (all when none is named) and
    return them, {script: rows of tiles.table}."""
    names = sys.argv[1:] if argv is None else argv
    by_name = {p.SCRIPT: p for p in PROBES}
    unknown = [n for n in names if n not in by_name]
    if unknown:
        raise SystemExit(f"unknown probe(s) {unknown}; known: {list(by_name)}")
    dev = tiles.require_cuda("beats3d_tpu_torch.probes")
    tables = {}
    for probe in [by_name[n] for n in names] or PROBES:
        tables[probe.SCRIPT] = tiles.table(probe, dev)
        tiles.print_table(probe.SCRIPT, tables[probe.SCRIPT])
    return tables


if __name__ == "__main__":
    main()
