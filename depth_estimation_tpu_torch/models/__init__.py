"""The four depth families (DPT-Large, DPT-Hybrid, MiDaS small, MiDaS v2.1 Large) and their blocks, on PyTorch."""
