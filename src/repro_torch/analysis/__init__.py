"""Static analysis of the port's `Schedule` programs.

The port's copy of `repro.analysis`, run on the port's own IR
(`repro_torch.core.schedule`, `redplan`, and `crypto.modmath`'s bound
enumerators):

  * :mod:`repro_torch.analysis.lint` — well-formedness and safety rules
    beyond ``Schedule.validate()``, each a registered checker with an
    error code, severity and noqa-style suppression;
  * :mod:`repro_torch.analysis.bounds` — overflow proofs of the
    limb-scheme datapath for every preset x variant, and the static
    multiplicative depth cross-checked against the depth-tracked circuit
    (`core/transcipher.py`);
  * :mod:`repro_torch.analysis.cost` — static op and byte counts, and
    per-engine roofline predictions on the port's machine models,
    validated against the tuner's measured `StreamPlan` timings.

One CLI drives all three::

    PYTHONPATH=src python -m repro_torch.analysis <preset> [--device cpu]
    PYTHONPATH=src python -m repro_torch.analysis --all --check --device cpu
"""

from repro_torch.analysis.bounds import (    # noqa: F401  (public API)
    DepthReport,
    OverflowProof,
    depth_report,
    prove_overflow_safety,
    static_depth,
)
from repro_torch.analysis.cost import (      # noqa: F401
    CostReport,
    analyze_cost,
    predict_engine_times,
    validate_measured_ordering,
)
from repro_torch.analysis.lint import (      # noqa: F401
    Finding,
    lint,
    registered_rules,
)
