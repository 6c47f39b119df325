"""The port's core: the HHE stream ciphers (HERA, Rubato, PASTA), the
producer/consumer split, the farm, the tuner and RtF transciphering, with
the names `repro.core` exports.  Importing it builds no kernel and
touches no device: the CUDA kernels build at their first launch.

The names resolve on first use (PEP 562): importing one submodule (say
``repro_torch.core.params``) does not import them all, and the modules
with a command line (``python -m repro_torch.core.engine``, ``.tuner``,
``.producer``) are not imported before they run.
"""

import importlib

#: exported name -> the submodule that defines it
_EXPORTS = {
    "CipherParams": "params",
    "HERA_128A": "params",
    "RUBATO_128S": "params",
    "RUBATO_128M": "params",
    "RUBATO_128L": "params",
    "PASTA_128S": "params",
    "PASTA_128L": "params",
    "get_params": "params",
    "Cipher": "cipher",
    "CipherBatch": "cipher",
    "StreamSession": "cipher",
    "EngineCaps": "engine",
    "KeystreamEngine": "engine",
    "engine_caps": "engine",
    "make_engine": "engine",
    "registered_engines": "engine",
    "resolve_engine": "engine",
    "KeystreamFarm": "farm",
    "WindowPlan": "farm",
    "pack_windows": "farm",
    "plan_windows": "farm",
    "ConstantsProducer": "producer",
    "ProducerCaps": "producer",
    "compatible_producers": "producer",
    "make_producer": "producer",
    "producer_caps": "producer",
    "registered_producers": "producer",
    "resolve_producer": "producer",
    "StreamPlan": "tuner",
    "autotune": "tuner",
    "load_plan": "tuner",
    "Schedule": "schedule",
    "build_schedule": "schedule",
    "execute_schedule": "schedule",
    "make_cipher": "cipher",
    "hera_stream_key": "hera",
    "pasta_stream_key": "pasta",
    "rubato_stream_key": "rubato",
    "transcipher": "transcipher",
    "evaluate_decryption_circuit": "transcipher",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
