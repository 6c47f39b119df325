"""Data plane: the HHE-encrypted batch path (the paper's cipher as a
first-class framework feature)."""
