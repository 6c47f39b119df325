"""Training substrate: hand-rolled AdamW (float32 and 8-bit moment
variants), the train-step factory with microbatch accumulation and an
optional HHE-decrypting data plane, and checkpointing that crosses to and
from the reference's format."""
