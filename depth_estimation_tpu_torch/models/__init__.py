"""DPT-Large, MiDaS v2.1 Large and the MiDaS decoder blocks they share, on PyTorch."""
