"""Offline converter: text graph formats -> binary CSR (+ labels) — the
port's copy of gardenia_tpu/tools/converter.py.

Reference: tools/converter.cc (CountDegrees/PrefixSum/write_labels_bin):
  python -m gardenia_tpu_torch.tools.converter <input> <out-prefix>
      [--symmetrize] [--no-dedup] [--labels=degree|file.txt]

Writes <prefix>.meta.txt / .vertex.bin / .edge.bin (and .vlabel.bin),
the same layout the reference Graph ctor reads (csr_graph.h:215-233).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("prefix")
    ap.add_argument("--symmetrize", action="store_true")
    ap.add_argument("--no-dedup", action="store_true")
    ap.add_argument("--filetype", default=None)
    ap.add_argument("--labels", default=None,
                    help="'degree' for degree-bucket labels, or a text "
                         "file with one label per line")
    args = ap.parse_args(argv)

    from gardenia_tpu_torch.core.graph import from_edges
    from gardenia_tpu_torch.core.io import parse_text, write_bin_csr

    t0 = time.perf_counter()
    edges = parse_text(args.input, args.filetype)
    t1 = time.perf_counter()
    g = from_edges(edges, symmetrize=args.symmetrize,
                   dedup=not args.no_dedup)
    t2 = time.perf_counter()
    vlabels = None
    if args.labels == "degree":
        vlabels = np.minimum(g.degrees, 255).astype(np.uint8)
    elif args.labels:
        vlabels = np.loadtxt(args.labels, dtype=np.int64) \
            .astype(np.uint8)
    write_bin_csr(args.prefix, g.rowptr, g.colidx, vlabels)
    t3 = time.perf_counter()
    print(f"|V| {g.m} |E| {g.nnz}")
    print(f"parse {1e3*(t1-t0):.1f} ms, build {1e3*(t2-t1):.1f} ms, "
          f"write {1e3*(t3-t2):.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
