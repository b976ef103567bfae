"""Roofline pricing for the plan-space tuner (see ``analysis``)."""
from .analysis import (HW, analytic_hbm_bytes, analytic_model_flops,
                       block_flops, offload_cost_terms)

__all__ = ["HW", "analytic_hbm_bytes", "analytic_model_flops",
           "block_flops", "offload_cost_terms"]
