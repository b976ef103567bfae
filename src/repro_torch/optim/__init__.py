"""Optimizers: AdamW, Adafactor, host-offloaded state (the paper's
technique), and the training-step block programs."""
from .adafactor import adafactor
from .adamw import LeafRule, Optimizer, adamw
from .offload import (attention_step_program, host_memory_kind,
                      offload_shardings, offloaded_optimizer,
                      offloaded_state, opt_state_shardings,
                      plan_step_program, supports_pinned_host)


def default_optimizer(cfg) -> Optimizer:
    """Adafactor for the 480B MoE (Adam fp32 state > one pod's HBM);
    AdamW elsewhere."""
    from ..configs import param_count
    if param_count(cfg) > 100e9:
        return adafactor()
    return adamw()


__all__ = ["adamw", "adafactor", "Optimizer", "LeafRule",
           "default_optimizer", "offload_shardings", "offloaded_optimizer",
           "offloaded_state", "opt_state_shardings", "plan_step_program",
           "attention_step_program",
           "host_memory_kind", "supports_pinned_host"]
