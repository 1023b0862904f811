"""PyTorch / CUDA port of synthesis_in_style_tpu (see README.md, "PyTorch / H100 port")."""
