"""Device operators of the port: semirings, ELL SpMV, the hybrid layout
and its dense-panel kernel (K1, csrc/dense_panel_matmul.cu), and triangle
counting's per-pair counts (K3, K4, H1, csrc/tc_*.cu) and membership
counts."""
