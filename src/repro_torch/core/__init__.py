"""OMP2HMPP-style offload planning on PyTorch — the paper's core contribution.

Public API:
    Program          — block/loop program builder (the "pragma'd source")
    analyze          — FX-graph def/use + liveness analysis (paper §2)
    plan             — optimized directive placement (advancedload ASAP,
                       delegatestore ALAP, noupdate, groups, async+sync,
                       per-group transfer streams)
    naive_plan       — the paper's baseline policy (Figs. 4a/5a)
    execute          — instrumented driver over pluggable backends;
                       mode="interpreted" | "compiled"
    compile_plan     — lower a Plan to a fused schedule
    Backend et al.   — the execution backends (numpy / torch)
    run_host_oracle  — pure-host reference semantics
    emit             — HMPP-style generated source (paper Table 2)
    verify_plan      — static race / transfer-consistency / donation-safety
                       checker run at every plan boundary (hard error)
    plan_records     — a plan as plain records, and ``plan_from_records``
                       back (carries plans across packages)
    tune             — the plan-space explorer (``plan(p, policy="auto")``)
                       with its persistent cache (``TuneCache``)
    DeviceResidency  — runtime residency tracker for the training substrates
"""
from .analysis import ProgramAnalysis, ShapeDtype, analyze
from .backend import (Backend, Event, NumpyHostBackend, TorchDeviceBackend,
                      get_backend, register_backend)
from .compile import CompiledPlan, compile_plan
from .emitter import emit
from .executor import ExecStats, PlanExecutionError, execute, run_host_oracle
from .interop import plan_from_records, plan_records
from .ir import (AdvancedLoad, Block, BlockKind, Callsite, DelegateStore,
                 GroupDecl, Plan, PlanOp, Program, Release, Synchronize,
                 VarIO)
from .passes import (Pass, Pipeline, PlanDraft, get_placement,
                     placement_names, register_placement)
from .planner import naive_plan, plan, transfer_summary
from .residency import (DeviceResidency, ResidencyStats,
                        plan_peak_device_bytes)
from .tunecache import (COST_MODEL_VERSION, TuneCache, backend_fingerprint,
                        default_cache, device_class_key, program_fingerprint,
                        tuning_fingerprint)
from .tuner import (OBJECTIVES, PlanConfig, pareto_front, predict_cost, tune,
                    winner_exec_kwargs)
from .verify import (PlanVerificationError, VerifyReport, Violation,
                     verify_plan)

__all__ = [
    "Program", "Block", "BlockKind", "VarIO", "Plan", "PlanOp",
    "AdvancedLoad", "DelegateStore", "Callsite", "Synchronize", "Release",
    "GroupDecl",
    "ProgramAnalysis", "ShapeDtype", "analyze", "plan", "naive_plan",
    "transfer_summary",
    "execute", "run_host_oracle", "ExecStats", "PlanExecutionError",
    "compile_plan", "CompiledPlan",
    "Backend", "Event", "NumpyHostBackend", "TorchDeviceBackend",
    "get_backend", "register_backend",
    "emit", "plan_records", "plan_from_records",
    "DeviceResidency", "ResidencyStats",
    "Pass", "Pipeline", "PlanDraft",
    "register_placement", "get_placement", "placement_names",
    "PlanConfig", "predict_cost", "tune", "winner_exec_kwargs",
    "OBJECTIVES", "pareto_front", "plan_peak_device_bytes",
    "TuneCache", "COST_MODEL_VERSION", "default_cache",
    "program_fingerprint", "backend_fingerprint", "tuning_fingerprint",
    "device_class_key",
    "verify_plan", "VerifyReport", "Violation", "PlanVerificationError",
]
