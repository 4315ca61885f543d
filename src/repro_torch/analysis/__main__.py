"""Static-analysis entry point for ``repro_torch.analysis``.

  python -m repro_torch.analysis [--ast] [--jaxpr] [--recompile] [--cost]
                                 [--pallas] [--github] [--json OUT.json]
                                 [--write-cost-baseline] [paths...]

The counterpart of ``tools/jaxlint.py``, with the same flags; every engine
runs when none is given. CPU-only, network-free, no card needed; exit code
1 on any finding or violation.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
AST_DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py")


def run_ast(paths) -> list:
    from repro_torch.analysis.astchecks import TORCH_RULES
    from repro_torch.analysis.lintcore import RUFF_FALLBACK_RULES, run_paths
    return run_paths(paths, tuple(RUFF_FALLBACK_RULES) + tuple(TORCH_RULES))


def run_jaxpr() -> list:
    from repro_torch.analysis.jaxpr_budget import report
    from repro_torch.analysis.manifests import manifests
    return [report(m) for m in manifests()]


def run_cost() -> tuple:
    """(reports, drift) for every manifest: contracts and the baseline."""
    from repro_torch.analysis.cost_model import (CostViolation,
                                                 check_against_baseline,
                                                 cost_report, load_baseline)
    from repro_torch.analysis.manifests import manifests
    reports = [cost_report(m) for m in manifests()]
    baseline = load_baseline()
    if baseline is None:
        drift = [CostViolation(
            "<all>", "baseline",
            "COST_baseline_torch.json missing — generate it with "
            "`python -m repro_torch.analysis --cost --write-cost-baseline`")]
    else:
        drift = check_against_baseline(reports, baseline)
    return reports, drift


def run_pallas() -> list:
    from repro_torch.analysis.pallas_check import check_all
    return check_all()


def run_recompile() -> dict:
    """Warm the default serving ladder under a sentry; gate the rung set."""
    import torch

    from repro_torch.analysis.recompile import (RecompileGuardError,
                                                RecompileSentry,
                                                ladder_signatures)
    from repro_torch.serving.server import ServeConfig

    ladder = ServeConfig().resolved_ladder()
    mq = 8

    def search_stub(q, qm, qs):
        return q.sum(dim=(1, 2)), torch.argsort(qm.sum(dim=1))

    def key_fn(q, qm, qs):
        return (int(q.shape[0]), int(q.shape[1]))

    sentry = RecompileSentry(search_stub, name="ladder", key_fn=key_fn)
    for b in ladder:
        for _ in range(2):  # repeat calls must not mint new signatures
            sentry(torch.zeros((b, mq, 4)), torch.ones((b, mq), dtype=bool),
                   torch.zeros((b, mq)))
    try:
        sentry.assert_signatures(ladder_signatures(ladder, mq))
        error = None
    except RecompileGuardError as e:
        error = str(e)
    return {"ladder": list(ladder), "report": sentry.report(),
            "ok": error is None, "error": error}


def _annotate(findings, github: bool) -> None:
    for f in findings:
        print(f)
        if github:
            print(f.to_github())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--ast", action="store_true",
                    help="AST lints: E9/F401/F811/F541 and TORCH01, "
                         "TORCH02, TORCH04, TORCH05 over src/repro_torch "
                         "and chip_smoke.py (or the given paths)")
    ap.add_argument("--jaxpr", action="store_true",
                    help="memory-budget manifests: record every search "
                         "entry point on fake tensors at N = 2^20 and "
                         "2^19 and enforce its budgets and dtypes")
    ap.add_argument("--recompile", action="store_true",
                    help="serving-ladder contract: a sentry over the "
                         "default ladder must see exactly its rungs")
    ap.add_argument("--cost", action="store_true",
                    help="cost model: FLOPs, HBM bytes and intensity of "
                         "the manifests' recordings on the h100 and cpu_ci "
                         "rooflines, gated by contracts and by "
                         "COST_baseline_torch.json")
    ap.add_argument("--pallas", action="store_true",
                    help="launch-geometry checks PAL01-PAL04 of the four "
                         "CUDA kernels at every registered site")
    ap.add_argument("--github", action="store_true",
                    help="emit GitHub annotations (auto in Actions)")
    ap.add_argument("--write-cost-baseline", action="store_true",
                    help="regenerate COST_baseline_torch.json from this run")
    ap.add_argument("--json", metavar="OUT", default=None)
    ap.add_argument("paths", nargs="*", help="--ast paths")
    args = ap.parse_args(argv)
    run_all = not (args.ast or args.jaxpr or args.recompile or args.cost
                   or args.pallas)
    github = args.github or os.environ.get("GITHUB_ACTIONS") == "true"
    out: dict = {}
    failed = False

    if args.ast or run_all:
        findings = run_ast(args.paths or [str(ROOT / p)
                                          for p in AST_DEFAULT_PATHS])
        _annotate(findings, github)
        print(f"analysis --ast: {len(findings)} finding(s)")
        out["ast"] = [f.to_json() for f in findings]
        failed |= bool(findings)

    if args.jaxpr or run_all:
        reports = run_jaxpr()
        bad = [r for r in reports if not r["ok"]]
        for r in bad:
            for v in r["violations"]:
                print(f"[{v['manifest']}] {v['kind']}: {v['detail']}")
        print(f"analysis --jaxpr: {len(reports)} manifest(s), {len(bad)} "
              f"violating")
        out["jaxpr"] = reports
        failed |= bool(bad)

    if args.cost or run_all:
        from repro_torch.analysis.cost_model import write_baseline
        reports, drift = run_cost()
        if args.write_cost_baseline:
            print(f"analysis --cost: wrote {write_baseline(reports)}")
            drift = []                   # the run is the new baseline
        contract = [v for r in reports for v in r["violations"]]
        for v in contract:
            print(f"[{v['manifest']}] {v['kind']}: {v['detail']}")
        for d in drift:
            print(str(d))
        print(f"analysis --cost: {len(reports)} manifest(s), "
              f"{len(contract)} contract violation(s), {len(drift)} drift "
              f"violation(s)")
        out["cost"] = {"reports": reports,
                       "drift": [d.to_json() for d in drift]}
        failed |= bool(contract) or bool(drift)

    if args.pallas or run_all:
        from repro_torch.analysis.pallas_check import kernel_sites
        findings = run_pallas()
        _annotate(findings, github)
        print(f"analysis --pallas: {len(kernel_sites())} kernel site(s), "
              f"{len(findings)} finding(s)")
        out["pallas"] = [f.to_json() for f in findings]
        failed |= bool(findings)

    if args.recompile or run_all:
        rec = run_recompile()
        if not rec["ok"]:
            print(f"analysis --recompile: {rec['error']}")
        print(f"analysis --recompile: ladder {rec['ladder']}, "
              f"{rec['report']['n_signatures']} signature(s), "
              f"ok={rec['ok']}")
        out["recompile"] = rec
        failed |= not rec["ok"]

    out["ok"] = not failed
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2, default=str))
        print(f"analysis: wrote {args.json}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
