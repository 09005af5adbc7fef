"""CLI: ``python -m pilosa_tpu_torch.analysis`` — the CI gate.

Exit 0 when every finding is suppressed or baselined; exit 1 on NEW
findings (and print them).  ``--write-baseline`` grandfathers the
current findings; ``--write-registry`` regenerates the counters
registry (COUNTERS.md); ``--all`` lists every finding including the
grandfathered ones.

The interleaving-explorer lane (analysis/sched.py + spec.py):

- ``--explore`` lists the scenario registry;
- ``--explore <name|all>`` exhaustively explores one scenario (or the
  whole live suite plus the protocol model check) under the preemption
  bound (``--bound``) — exit 1 with printed schedule strings on any
  violation;
- ``--explore <name> --schedule <string>`` replays one serialized
  schedule (the deterministic repro for a failure CI printed).
"""

from __future__ import annotations

import argparse
import sys

from pilosa_tpu_torch.analysis import engine, registry


def _run_explore(name, schedule, bound) -> int:
    from pilosa_tpu_torch.analysis import sched, scenarios, spec

    if not name:
        print("explorer scenarios (see DEVELOPMENT.md):")
        for sname, s in sorted(scenarios.SCENARIOS.items()):
            tag = " [known-bug fixture]" if s.known_bug else ""
            print(f"  {sname}{tag}")
            if s.description:
                first = s.description.strip().splitlines()[0].strip()
                print(f"      {first}")
        return 0

    if schedule:
        s = scenarios.get(name)
        outcomes = sched.replay(s, schedule)
        for o in outcomes:
            print(o.describe())
        if outcomes:
            return 1
        print(f"{name}: schedule {schedule} replayed clean")
        return 0

    targets = (
        scenarios.live_scenarios() if name == "all" else [scenarios.get(name)]
    )
    rc = 0
    for s in targets:
        res = sched.explore(s, bound=bound)
        print(res.describe())
        if not res.ok:
            rc = 1
    if name == "all":
        model = spec.model_check(n_groups=3, max_writes=2)
        print(
            f"replica-protocol model: {model.states} states explored, "
            f"{len(model.violations)} violation(s)"
        )
        for v in model.violations:
            print("  " + v)
        if not model.ok:
            rc = 1
    if rc:
        print(
            "replay a failing schedule with: python -m pilosa_tpu_torch.analysis "
            "--explore <scenario> --schedule <string>",
            file=sys.stderr,
        )
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m pilosa_tpu_torch.analysis",
        description="Project invariant linter (see DEVELOPMENT.md).",
    )
    p.add_argument("--root", default=None, help="package dir to scan (default: installed pilosa_tpu_torch)")
    p.add_argument("--rules", default=None, help="comma-separated subset of: " + ",".join(engine.RULES))
    p.add_argument("--baseline", default=None, help="baseline file (default: <root>/analysis/baseline.json)")
    p.add_argument("--write-baseline", action="store_true", help="grandfather the current findings and exit")
    p.add_argument("--write-registry", action="store_true", help="regenerate analysis/COUNTERS.md and exit")
    p.add_argument("--all", action="store_true", help="also list suppressed/baselined findings")
    p.add_argument("--explore", nargs="?", const="", default=None,
                   metavar="SCENARIO",
                   help="interleaving explorer: list scenarios (no value), "
                        "run one, or `all` for the live suite + model check")
    p.add_argument("--schedule", default=None,
                   help="with --explore <scenario>: replay this serialized "
                        "schedule string")
    p.add_argument("--bound", type=int, default=None,
                   help="preemption bound for --explore (default: per-scenario)")
    args = p.parse_args(argv)

    root = args.root or engine.package_root()

    if args.explore is not None:
        return _run_explore(args.explore, args.schedule, args.bound)

    if args.write_registry:
        text = registry.generate_counters_registry(root)
        path = registry.registry_path(root)
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {path}")
        return 0

    rules = tuple(engine.RULES)
    if args.rules:
        wanted = tuple(r.strip() for r in args.rules.split(",") if r.strip())
        unknown = [r for r in wanted if r not in engine.RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}", file=sys.stderr)
            return 2
        rules = wanted

    findings = engine.run_analysis(root=root, rules=rules, baseline=args.baseline)

    if args.write_baseline:
        path = args.baseline or engine.baseline_path(root)
        engine.write_baseline(path, findings)
        kept = sum(1 for f in findings if not f.suppressed)
        print(f"wrote {path} ({kept} grandfathered finding(s))")
        return 0

    fresh = engine.new_findings(findings)
    n_sup = sum(1 for f in findings if f.suppressed)
    n_base = sum(1 for f in findings if f.baselined)
    shown = findings if args.all else fresh
    for f in shown:
        print(f.render())
    print(
        f"analysis: {len(findings)} finding(s) over {len(rules)} rule(s) — "
        f"{n_sup} suppressed, {n_base} baselined, {len(fresh)} NEW"
    )
    if fresh:
        print(
            "fix the new findings, tag them with `# analysis-ok: <rule>: "
            "<reason>`, or (last resort) --write-baseline.",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
