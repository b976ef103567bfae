"""Training-step block programs (the optimizers come with the training
port)."""
from .offload import attention_step_program, plan_step_program

__all__ = ["plan_step_program", "attention_step_program"]
