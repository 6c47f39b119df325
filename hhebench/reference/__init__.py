"""The benchmark's plain reference: AES-128-CTR XOF, the samplers, HERA
and Rubato, and the fixed-point boundary.  Plain numpy and PyTorch; no
module here imports the program or JAX."""
