"""`repro_torch.analysis`: the static-analysis subsystem.

The counterpart of ``repro.analysis``. Four engines keep the port's memory,
compute and launch envelope a checked contract instead of a convention:

  * ``jaxpr_budget`` + ``manifests`` — record every registered search entry
    point on fake tensors at corpus size 2^20 (a ``TorchDispatchMode`` that
    keeps each aten op, its outputs and the live bytes) and enforce the
    per-entry budgets: max intermediate bytes, the peak's growth per
    document, and output dtypes;
  * ``cost_model`` — FLOPs, HBM bytes and arithmetic intensity of the same
    recordings against the H100's roofline, gated by contracts and by
    ``COST_baseline_torch.json``;
  * ``pallas_check`` — PAL01-PAL04 on the four CUDA kernels' launch
    geometry (shared memory and registers against the sm_90 budget,
    divisibility, grid coverage, output dtypes);
  * ``recompile`` — a runtime sentry over the serving ladder's call shapes;
  * ``lintcore`` + ``astchecks`` — the shared AST lint framework (E9, F401,
    F811, F541 with ``# noqa[: CODE]`` semantics) plus the PyTorch-aware
    rules TORCH01, TORCH02, TORCH04 and TORCH05.

``python -m repro_torch.analysis`` drives them all.
"""
from repro_torch.analysis.jaxpr_budget import (BudgetViolation,
                                               analyze_manifest,
                                               intermediate_avals,
                                               trace_manifest)
from repro_torch.analysis.lintcore import Finding, Rule, check_source, run_paths
from repro_torch.analysis.manifests import (BudgetManifest, get_manifest,
                                            manifests)
from repro_torch.analysis.recompile import (RecompileGuardError,
                                            RecompileSentry,
                                            abstract_signature,
                                            ladder_signatures)

__all__ = [
    "BudgetManifest",
    "BudgetViolation",
    "Finding",
    "RecompileGuardError",
    "RecompileSentry",
    "Rule",
    "abstract_signature",
    "analyze_manifest",
    "check_source",
    "get_manifest",
    "intermediate_avals",
    "ladder_signatures",
    "manifests",
    "run_paths",
    "trace_manifest",
]
