"""Version info (utils/version.h analogue; the port's copy of
``phy_engine_tpu/utils/version.py``, naming this package)."""

import subprocess
from pathlib import Path

from .. import __version__


def version_string() -> str:
    """``phy_engine_tpu_torch <version>`` plus the checkout's short commit
    hash where the package sits in a git checkout."""
    try:
        h = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                           capture_output=True, text=True, timeout=5,
                           cwd=Path(__file__).resolve().parent).stdout.strip()
    except Exception:
        h = ""
    return f"phy_engine_tpu_torch {__version__}" + (f" ({h})" if h else "")
