"""phy_engine_tpu_torch — the PyTorch + CUDA port of phy_engine_tpu.

The JAX package ``phy_engine_tpu`` stays the reference; this package runs
the same engine in PyTorch on an NVIDIA H100 (and, through the plain
versions of its kernels, on the CPU for the parity tests).  It never
imports ``jax`` or ``phy_engine_tpu``: the netlist, the model metadata,
the stamp-IR lowering, the Verilog front end and synthesis, and the
digital IR and turbo plan are carried here as host-side copies whose
output the tests hold identical to the JAX package's.

Dtype policy (mirrors the reference's x64 mode and its
``Precision.HIGHEST`` GEMMs):

* analog state, stamps and residuals are ``torch.float64`` — every
  factory call in the package names the dtype, because torch's default
  dtype is float32;
* the dense factor path (equilibrated Jacobian, Gauss-Jordan kernels,
  the carried inverse and its Newton-Schulz refresh) is float32;
* TF32 is off, so every f32 GEMM runs in full float32.

Kernel rule: each TPU Pallas kernel on the port's path is a hand-written
CUDA kernel (``ops/csrc``) with a plain torch version beside it.  A
wrapper uses the plain version only for a CPU tensor; for a CUDA tensor
it launches the kernel or raises — there is no fallback.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

F64 = torch.float64      # analog state, stamps, residuals
F32 = torch.float32      # dense factor path

__version__ = "0.1.0"

from .netlist.netlist import Netlist, Node, ModelInstance  # noqa: E402,F401
from .netlist import operations as netops  # noqa: E402,F401
from .engine.circuit import (Circuit, AnalyzeType, ACSweepType,  # noqa: E402,F401
                             ACSettings, TRSettings)
from .engine.environment import Environment  # noqa: E402,F401
from . import models  # noqa: E402,F401
