"""The roofline cost layer of the port: analytic flops and bytes of each
serving phase (``cost``), the counterpart of ``repro/roofline/hlo_cost.py``.
The reference's dry-run analysis (``repro/roofline/analysis.py``) is not
ported yet."""
from .cost import PhaseCost, phase_cost

__all__ = ["PhaseCost", "phase_cost"]
