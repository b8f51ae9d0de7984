from .panda import (PandaModel, make_panda_model, panda_model_from_numpy,
                    NQ, NV, NX, KEYFRAMES, TAU_LIMIT, TAU_RATE_LIMIT)
from .kinematics import fk, ee_jacobian, ee_velocity, FKResult
from .dynamics import (
    rnea,
    bias_forces,
    gravity_torque,
    mass_matrix,
    fwd_dynamics_free,
    fwd_dynamics_contact,
    ContactDynOut,
)

__all__ = [
    "PandaModel", "make_panda_model", "panda_model_from_numpy",
    "NQ", "NV", "NX", "KEYFRAMES", "TAU_LIMIT", "TAU_RATE_LIMIT",
    "fk", "ee_jacobian", "ee_velocity", "FKResult",
    "rnea", "bias_forces", "gravity_torque", "mass_matrix",
    "fwd_dynamics_free", "fwd_dynamics_contact", "ContactDynOut",
]
