"""Roofline of a cell: ``analysis.py`` (the three time terms, the H100's
peaks as arguments), ``cost.py`` (FLOPs and HBM bytes per device from the
model code's shapes; the reference parses XLA's HLO instead) and
``report.py`` (the dry run's tables)."""
from .analysis import (CollectiveStats, Roofline, model_flops_for,
                       roofline_from)
from .cost import CellCost, cell_cost
