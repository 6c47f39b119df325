"""Training substrate: hand-rolled AdamW (float32 and 8-bit moment
variants, on local shards of DTensor leaves), the train-step factory with
microbatch accumulation, an optional HHE-decrypting data plane and an
optional sharding policy, int8 gradient compression across pods, and
checkpointing that crosses to and from the reference's format."""
