"""Device operators of the port: semirings, ELL SpMV, the hybrid layout
and its dense-panel kernel (K1, csrc/dense_panel_matmul.cu)."""
