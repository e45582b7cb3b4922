"""Share of the TC trial's device busy time that the graph's own bytes
need at the card's published HBM rate.  Reads the kernels of the count
(ops/tc_count: K3, K4 and H1), whatever layout implements it.  Moves
trials_per_s.

Bytes: the degree-ordered DAG's CSR read once, a 4-byte id a DAG edge
and a 4-byte offset a vertex and one (|E| / 2 + |V| + 1 words).  Not the
port's pair streams or bitmap: a layout change leaves this count as it
is."""


def dag_bytes(vertices: int, dag_edges: int) -> int:
    return 4 * dag_edges + 4 * (vertices + 1)


def read(run):
    tr, peaks = run.get("trace"), run.get("peaks")
    if not tr or not peaks or tr["busy_s"] <= 0 or not tr["trials"]:
        return None
    g = run["graph"]
    least_s = dag_bytes(g["vertices"], g["dag_edges"]) \
        / peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (tr["busy_s"] / tr["trials"])
