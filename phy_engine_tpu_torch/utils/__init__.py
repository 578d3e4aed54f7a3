from .version import __version__, version_string
from .subnet import detect_floating_subnets

__all__ = ["__version__", "version_string", "detect_floating_subnets"]
