"""Entry points of the port's LLM side (``python -m
repro_torch.launch.serve`` and ``python -m repro_torch.launch.train``) and
the elasticity helpers."""
