"""sep2023_tpu — an elastic wave modeling & DAS full-waveform inversion
framework in JAX / XLA, built from scratch with the capabilities of the
seisfwi/SEP-2023 reference (TorchFWI-CUDA + Numba CPU solver).

Layers (bottom-up):
  ops.fd / ops.signal / ops.misfit   stencils, filters, objectives
  cpml, medium                       absorbing boundaries, material fields
  propagator                         lax.scan elastic propagator + boundary-
                                     saving custom_vjp adjoint
  das                                gauge-length DAS operator, fiber geometry
  heads                              model parameterizations (7 heads)
  parallel                           shot sharding over a device mesh
  optimize                           L-BFGS-B outer loop + scipy bridge
  analytic                           Aki & Richards solutions (test oracles)
"""

from sep2023_tpu.config import (C1, C2, Grid, SimConfig, Survey, klauder,
                                ricker, ricker_integrated)
from sep2023_tpu import medium
from sep2023_tpu.medium import MatFields, Medium, material_fields, pad_model
from sep2023_tpu.cpml import CpmlCoefs, cpml_profiles
from sep2023_tpu.propagator import (CHANNELS, ShotGeom, propagate,
                                    propagate_ad, propagate_shots)
from sep2023_tpu.acoustic import AcGeom, propagate_acoustic

__version__ = "0.4.0"
