"""Planner pass pipeline (ISSUE 4): composable, reorderable passes over a
shared ``PlanDraft``.  See ``base.Pipeline.default`` for the canonical
order and ``placement.register_placement`` for adding policies."""
from .base import Pass, Pipeline, PlanDraft
from .linearize import LinearizePass, linearize
from .placement import (GroupedPlacement, GroupFinalizePass, NaivePlacement,
                        OptimizedPlacement, PlacementPass, get_placement,
                        placement_names, register_placement)
from .purity import PurityPass, pure_device_loops
from .simulate import NoupdatePass, PlanGap, SimulateFixPass, simulate
from .streams import StreamAssignPass, assign_streams

__all__ = [
    "Pass", "Pipeline", "PlanDraft",
    "LinearizePass", "linearize",
    "PlacementPass", "OptimizedPlacement", "NaivePlacement",
    "GroupedPlacement", "GroupFinalizePass",
    "register_placement", "get_placement", "placement_names",
    "SimulateFixPass", "NoupdatePass", "PlanGap", "simulate",
    "StreamAssignPass", "assign_streams",
    "PurityPass", "pure_device_loops",
]
