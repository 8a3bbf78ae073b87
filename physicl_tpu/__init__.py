"""physicl_tpu — a JAX particle/photon simulation framework.

Brand-new JAX/XLA/Pallas implementation with the capabilities of the reference
OpenCL package (bcwarner/physicl): a code-units system, a generic
Simulation/Object/Step engine (re-expressed as a jit-compiled scan over
structure-of-arrays particle state resident in HBM), and a photon-transport
toolkit (Planck generation, kinematics, absorption/isotropic/wavelength-dependent
scattering, measurement steps), sharded over device meshes for scale-out.
"""

from physicl_tpu.units import (
    Measurement,
    MeasurementError,
    set_code_scale,
    reset_code_scale,
    raw_code_value,
)
from physicl_tpu.engine import (
    Step,
    UpdateTimeStep,
    MeasureStep,
    ElementwiseStep,
    ReduceMeasureStep,
    ParticleView,
    Object,
    Simulation,
    IndexException,
    StepContext,
    UntilT,
    ExtinctionExit,
    PlanReport,
)
from physicl_tpu.state import SimState
from physicl_tpu.ops.fused import clear_kernel_cache

from physicl_tpu import newton  # noqa: F401
from physicl_tpu import light  # noqa: F401
from physicl_tpu import functional  # noqa: F401

__version__ = "0.1.0"


__all__ = [
    "Measurement",
    "MeasurementError",
    "set_code_scale",
    "reset_code_scale",
    "raw_code_value",
    "Step",
    "UpdateTimeStep",
    "MeasureStep",
    "ElementwiseStep",
    "ReduceMeasureStep",
    "ParticleView",
    "Object",
    "Simulation",
    "IndexException",
    "StepContext",
    "UntilT",
    "ExtinctionExit",
    "PlanReport",
    "SimState",
    "clear_kernel_cache",
    "newton",
    "light",
]
