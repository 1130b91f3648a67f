"""Public problem-layer entry point mirroring the reference's ``Control``
namespace class (reference control/control.py:99)."""

from .instationary import Instationary


class Control:
    Instationary = Instationary
