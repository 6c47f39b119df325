"""Data plane: the deterministic, resumable pipeline and the HHE-encrypted
batch path (the paper's cipher as a first-class framework feature)."""
