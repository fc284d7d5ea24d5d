"""Multi-device rendering on torch.distributed (render.py) and a launcher
of several ranks on one host (local.py)."""
