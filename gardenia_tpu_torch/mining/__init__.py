"""Graph mining (reference L6: mining/{kcl_*,motif_*}): k-clique counting
(kcl, with kernel Q1 in ops/kcl_count) and the motif census (motif, over
the wedge streams of wedgestream)."""
