"""Device families of the port: every analog family of the JAX package
(linear, waveform sources, switch and relay, PN, BJT, MOSFET, full-bridge
rectifier, BSIM3v3.2 and its terminal-parasitic variant), the digital
gates' metadata, the comparator and the VERILOG_MODULE device."""

from .base import (MODEL_REGISTRY, DeviceClass, ModelDef, StampCtx,  # noqa: F401
                   UpdatePhase, register)
from .linear import (RESISTANCE, CAPACITOR, INDUCTOR, VDC, VAC, IDC,  # noqa: F401
                     IAC, VCVS, VCCS, CCVS, CCCS, TRANSFORMER,
                     TRANSFORMER_CENTER_TAP, COUPLED_INDUCTORS, OP_AMP)
from .sources import SAWTOOTH, SQUARE, PULSE, TRIANGLE  # noqa: F401
from .nonlinear import (PN_JUNCTION, BJT_NPN, BJT_PNP, NMOSFET,  # noqa: F401
                        PMOSFET, FULL_BRIDGE_RECTIFIER)
from .controller import SWITCH, RELAY, COMPARATOR  # noqa: F401
from .bsim3 import (BSIM3V32_NMOS, BSIM3V32_PMOS, BSIM3V32_NMOS_RC,  # noqa: F401
                    BSIM3V32_PMOS_RC)
from .digital_gates import (AND, OR, NOT, YES, XOR, XNOR, NAND, NOR, IMP,  # noqa: F401
                            NIMP, INPUT, OUTPUT, TRI_STATE, RESOLVE2,
                            CASE_EQ, IS_UNKNOWN, TICK_DELAY, SCHMITT_TRIGGER,
                            EIGHT_BIT_INPUT, EIGHT_BIT_DISPLAY,
                            D_FF, D_FF_ARSTN, D_LATCH, JK_FF, T_FF, T_BAR_FF,
                            HALF_ADDER, FULL_ADDER, HALF_SUBTRACTOR,
                            FULL_SUBTRACTOR, MUL2, COUNTER4,
                            RANDOM_GENERATOR4)
from .verilog_module import VERILOG_MODULE, make_verilog_module  # noqa: F401
