"""The benchmark of the PyTorch and CUDA port (`repro_torch`): the
keystream path of an HHE gateway, measured on one card.

``python3 hhebench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line last.  Nothing here imports JAX or the JAX package."""
