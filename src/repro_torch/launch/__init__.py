"""Entry points of the port's LLM side (``python -m
repro_torch.launch.serve`` and ``python -m repro_torch.launch.train``),
the process group and device meshes, and the elasticity helpers."""
