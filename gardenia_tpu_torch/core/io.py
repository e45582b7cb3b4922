"""Graph file parsers: text formats -> COO edge arrays, binary CSR read/write.

Format parity with the reference loaders:
  .mtx    MatrixMarket coordinate, 1-indexed, '%' comments
          (reference include/csr_graph.h:74-121, include/graph_io.h:288-355)
  .gr     DIMACS-9: 'c' comments, 'p sp <m> <nnz>' header, 'a src dst [wt]'
          lines, 1-indexed (include/graph_io.h:146-199; note the reference
          ignores the weight column and synthesizes wt=1 — we keep the real
          weights and let callers override, since SSSP's driver synthesizes
          unit weights anyway, src/sssp/main.cc:26)
  .graph  Metis adjacency: first line '<m> <nnz>', line i = neighbors of
          vertex i, 1-indexed (include/graph_io.h:247-286)
  .el     edge list: first line '<m> <nnz>', then 'src dst [wt]', 1-indexed
          (include/graph_io.h:202-245)
  .bin    pre-converted CSR: <prefix>.meta.txt ('<m> <nnz> <vid_size>
          <max_degree>'), <prefix>.vertex.bin uint64[m+1],
          <prefix>.edge.bin int32[nnz], optional <prefix>.vlabel.bin
          uint8[m] (include/csr_graph.h:215-233, src/common/graph.cc:4-36)

All parsers are vectorized NumPy (no per-edge Python loops); a native C++
fast path for huge text files lives in gardenia_tpu_torch/native.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from gardenia_tpu_torch.core import types as T


@dataclass
class EdgeListData:
    """Raw parsed edges, 0-indexed, before any cleaning."""

    num_rows: int
    num_cols: int          # == num_rows except bipartite matrices (SGD)
    src: np.ndarray        # int32[nnz]
    dst: np.ndarray        # int32[nnz]
    wt: Optional[np.ndarray] = None   # float64[nnz] raw weights, or None
    mtx_symmetric: bool = False       # MatrixMarket 'symmetric' qualifier
    vlabels: Optional[np.ndarray] = None


def _numeric_tokens(text: str, dtype=np.float64) -> np.ndarray:
    """Fast whitespace-separated numeric parse of a text blob."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return np.fromstring(text, dtype=dtype, sep=" ")


def parse_mtx(path: str) -> EdgeListData:
    """MatrixMarket coordinate format -> COO.

    Mirrors reference csr_graph.h:74-121 (1-indexed, '%' comment skip,
    optional third value column). The banner's 'symmetric' qualifier is
    recorded but NOT auto-expanded, matching the reference, which only
    duplicates edges when the caller passes symmetrize=1.
    """
    with open(path, "r") as f:
        text = f.read()
    symmetric = False
    pos = 0
    n_text = len(text)
    # banner + comments
    first = True
    while pos < n_text and text[pos] in "%":
        eol = text.find("\n", pos)
        if first and "symmetric" in text[pos:eol]:
            symmetric = True
        first = False
        pos = eol + 1
    eol = text.find("\n", pos)
    header = text[pos:eol].split()
    m, n, nnz = int(header[0]), int(header[1]), int(header[2])
    body = text[eol + 1:]
    vals = _numeric_tokens(body)
    if nnz == 0:
        return EdgeListData(m, n, np.empty(0, T.VID_DTYPE),
                            np.empty(0, T.VID_DTYPE), None, symmetric)
    if vals.size % nnz != 0:
        # trailing junk or missing lines: fall back to row-count inference
        fields = vals.size // nnz if vals.size >= nnz * 2 else 2
    else:
        fields = vals.size // nnz
    fields = max(2, min(fields, 4))
    vals = vals[: nnz * fields].reshape(nnz, fields)
    src = vals[:, 0].astype(T.VID_DTYPE) - 1
    dst = vals[:, 1].astype(T.VID_DTYPE) - 1
    wt = vals[:, 2].copy() if fields >= 3 else None
    return EdgeListData(m, n, src, dst, wt, symmetric)


def parse_gr(path: str) -> EdgeListData:
    """DIMACS-9 .gr format -> COO (reference graph_io.h:146-199)."""
    with open(path, "r") as f:
        lines = f.read().split("\n")
    m = nnz = None
    data_lines = []
    for ln in lines:
        if not ln:
            continue
        c = ln[0]
        if c == "c":
            continue
        if c == "p":
            parts = ln.split()
            m, nnz = int(parts[2]), int(parts[3])
        elif c == "a":
            data_lines.append(ln[1:])
    if m is None:
        raise ValueError(f"{path}: no 'p' header line")
    vals = _numeric_tokens(" ".join(data_lines))
    k = len(data_lines)
    fields = vals.size // k if k else 2
    vals = vals[: k * fields].reshape(k, fields)
    src = vals[:, 0].astype(T.VID_DTYPE) - 1
    dst = vals[:, 1].astype(T.VID_DTYPE) - 1
    wt = vals[:, 2].copy() if fields >= 3 else None
    return EdgeListData(m, m, src, dst, wt)


def parse_graph(path: str) -> EdgeListData:
    """Metis .graph adjacency format -> COO (reference graph_io.h:247-286)."""
    with open(path, "r") as f:
        lines = f.read().split("\n")
    header = lines[0].split()
    m = int(header[0])
    srcs, dsts = [], []
    for i in range(m):
        toks = _numeric_tokens(lines[1 + i], dtype=np.int64)
        if toks.size:
            srcs.append(np.full(toks.size, i, T.VID_DTYPE))
            dsts.append(toks.astype(T.VID_DTYPE) - 1)
    if srcs:
        src = np.concatenate(srcs)
        dst = np.concatenate(dsts)
    else:
        src = np.empty(0, T.VID_DTYPE)
        dst = np.empty(0, T.VID_DTYPE)
    return EdgeListData(m, m, src, dst, None)


def parse_el(path: str) -> EdgeListData:
    """Edge-list .el format -> COO (reference graph_io.h:202-245)."""
    with open(path, "r") as f:
        text = f.read()
    eol = text.find("\n")
    header = text[:eol].split()
    m, nnz = int(header[0]), int(header[1])
    vals = _numeric_tokens(text[eol + 1:])
    fields = max(2, vals.size // nnz) if nnz else 2
    fields = min(fields, 3)
    vals = vals[: nnz * fields].reshape(nnz, fields)
    src = vals[:, 0].astype(T.VID_DTYPE) - 1
    dst = vals[:, 1].astype(T.VID_DTYPE) - 1
    wt = vals[:, 2].copy() if fields >= 3 else None
    return EdgeListData(m, m, src, dst, wt)


# --- binary CSR format (reference csr_graph.h:215-233) -----------------------

def read_bin_csr(prefix: str):
    """Read <prefix>.meta.txt / .vertex.bin / .edge.bin (+.vlabel.bin).

    Returns (rowptr int64[m+1], colidx int32[nnz], vlabels or None).
    """
    with open(prefix + ".meta.txt") as f:
        toks = f.read().split()
    m, nnz = int(toks[0]), int(toks[1])
    vid_size = int(toks[2]) if len(toks) > 2 else 4
    assert vid_size == 4, f"unsupported vid size {vid_size}"
    rowptr = np.fromfile(prefix + ".vertex.bin", dtype=np.uint64,
                         count=m + 1).astype(np.int64)
    colidx = np.fromfile(prefix + ".edge.bin", dtype=T.VID_DTYPE, count=nnz)
    vlabels = None
    vpath = prefix + ".vlabel.bin"
    if os.path.exists(vpath):
        vlabels = np.fromfile(vpath, dtype=T.VLABEL_DTYPE, count=m)
    return rowptr, colidx, vlabels


def write_bin_csr(prefix: str, rowptr: np.ndarray, colidx: np.ndarray,
                  vlabels: Optional[np.ndarray] = None) -> None:
    """Write the reference's binary CSR layout (tools/converter.cc:39-101)."""
    m = len(rowptr) - 1
    nnz = len(colidx)
    deg = np.diff(rowptr)
    max_degree = int(deg.max()) if m else 0
    with open(prefix + ".meta.txt", "w") as f:
        f.write(f"{m} {nnz} 4 {max_degree}\n")
    rowptr.astype(np.uint64).tofile(prefix + ".vertex.bin")
    colidx.astype(T.VID_DTYPE).tofile(prefix + ".edge.bin")
    if vlabels is not None:
        vlabels.astype(T.VLABEL_DTYPE).tofile(prefix + ".vlabel.bin")


def parse_txt(path: str) -> EdgeListData:
    """Labeled-graph .txt format for FSM (reference include/mgraph.h
    read_txt: 'v <id> <label>' vertex lines then 'e <src> <dst>
    <elabel>' edge lines; 0-indexed)."""
    vlines, elines = [], []
    with open(path) as f:
        for ln in f:
            if ln.startswith("v"):
                vlines.append(ln[1:])
            elif ln.startswith("e"):
                elines.append(ln[1:])
    vt = _numeric_tokens(" ".join(vlines), dtype=np.int64).reshape(-1, 2)
    m = int(vt[:, 0].max()) + 1 if len(vt) else 0
    vlabels = np.zeros(m, T.VLABEL_DTYPE)
    vlabels[vt[:, 0]] = vt[:, 1].astype(T.VLABEL_DTYPE)
    if elines:
        et = _numeric_tokens(" ".join(elines),
                             dtype=np.int64)
        fields = et.size // len(elines)
        et = et[: len(elines) * fields].reshape(-1, fields)
        src = et[:, 0].astype(T.VID_DTYPE)
        dst = et[:, 1].astype(T.VID_DTYPE)
        wt = et[:, 2].astype(np.float64) if fields >= 3 else None
    else:
        src = dst = np.empty(0, T.VID_DTYPE)
        wt = None
    return EdgeListData(m, m, src, dst, wt, vlabels=vlabels)


_PARSERS = {
    "mtx": parse_mtx,
    "gr": parse_gr,
    "graph": parse_graph,
    "el": parse_el,
    "txt": parse_txt,
}


def parse_text(path: str, filetype: Optional[str] = None,
               prefer_native: bool = True) -> EdgeListData:
    """Dispatch on extension like reference read_graph (graph_io.h:357-366).

    Large files go through the native C++ single-pass scanner
    (gardenia_tpu_torch/native/graph_io.cpp) when it is available; the NumPy
    parsers are the fallback and the behavioral reference."""
    if filetype is None:
        filetype = os.path.splitext(path)[1].lstrip(".")
    if filetype not in _PARSERS:
        raise ValueError(f"unrecognized graph format: {filetype} ({path})")
    if prefer_native:
        try:
            from gardenia_tpu_torch import native
            res = native.parse_edges(path, filetype)
        except Exception:
            res = None
        if res is not None:
            m, n, src, dst, wt = res
            symmetric = False
            if filetype == "mtx":
                with open(path) as f:
                    symmetric = "symmetric" in f.readline()
            return _fix_base(EdgeListData(m, n, src, dst, wt, symmetric))
    return _fix_base(_PARSERS[filetype](path))


def _fix_base(e: EdgeListData) -> EdgeListData:
    """Handle 0-indexed inputs: formats are nominally 1-indexed, but
    some files in the wild (e.g. the reference's own datasets/4.gr) are
    0-indexed — after the standard -1 shift those show a -1 vertex, so
    shift back.  (The reference's gr2csr would underflow on such files.)"""
    if len(e.src) and (e.src.min() < 0 or e.dst.min() < 0):
        e.src = e.src + 1
        e.dst = e.dst + 1
    return e
