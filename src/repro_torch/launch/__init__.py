"""Entry points of the port's LLM side (``python -m
repro_torch.launch.serve``)."""
