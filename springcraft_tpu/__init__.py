"""
springcraft_tpu — an elastic-network-model framework for accelerators.

Built on JAX/XLA/Pallas, providing the full capability surface of the
reference *springcraft* package (GNM/ANM elastic network models, the
complete force-field family, and the normal-mode-analysis toolkit) with an
accelerator-first architecture: dense masked interaction assembly, batched
XLA eigensolves, vmap-able ensemble pipelines and mesh-sharded multi-device
execution.
"""

__version__ = "0.1.0"

from . import io, ops, parallel, structure, utils
from .models import (
    ANM,
    GNM,
    ForceField,
    HinsenForceField,
    InvariantForceField,
    ParameterFreeForceField,
    PatchedForceField,
    TabulatedForceField,
    bfactor,
    compute_hessian,
    compute_kirchhoff,
    dcc,
    effector_sensor,
    eigen,
    frequencies,
    linear_response,
    mean_square_fluctuation,
    nma,
    normal_mode,
    prs,
)

# Make `import springcraft_tpu.nma` resolve to the models.nma module
# (mirrors the reference's flat module layout; the forcefield/anm/gnm/
# interaction aliases are real modules).
import sys as _sys

_sys.modules[__name__ + ".nma"] = nma

__all__ = [
    "__version__",
    "ANM",
    "GNM",
    "ForceField",
    "PatchedForceField",
    "InvariantForceField",
    "HinsenForceField",
    "ParameterFreeForceField",
    "TabulatedForceField",
    "compute_kirchhoff",
    "compute_hessian",
    "eigen",
    "frequencies",
    "mean_square_fluctuation",
    "bfactor",
    "dcc",
    "normal_mode",
    "linear_response",
    "prs",
    "effector_sensor",
    "nma",
    "io",
    "ops",
    "parallel",
    "structure",
    "utils",
]
