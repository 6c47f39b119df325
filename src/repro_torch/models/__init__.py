"""The LM substrate in PyTorch: dense / MoE / SSM / hybrid transformer
stacks over group-stacked parameters, GQA attention (RoPE / M-RoPE /
softcap / sliding window), capacity-based MoE and Mamba2 SSD.

The port's copy of `repro.models` without its sharding policy; the
parameters carry across from the reference by
:func:`repro_torch.models.convert.params_from_reference`."""
