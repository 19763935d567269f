"""CLI: ``python -m repro_torch.analysis.staticcheck [paths] [--baseline FILE]``.

Exit status: 0 when no finding exceeds the baseline, 1 otherwise.
``--write-baseline`` regenerates the baseline from the current tree (the
ratchet: counts can only be spent, never grown).  The port keeps no
baseline file: its tree scans clean.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .core import load_baseline, new_findings, scan, summarize, write_baseline

DEFAULT_BASELINE = "staticcheck-torch-baseline.txt"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.staticcheck",
        description="PyTorch/CUDA-aware lint of the port (SC01 host-sync, "
        "SC03 kernel-contract, SC06 allocator-discipline, SC07 ledger-"
        "discipline, SC09 health-state discipline, SC10 speculative-"
        "contract).",
    )
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to scan (default: "
                    "src/repro_torch)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: ./{DEFAULT_BASELINE} if "
                    "present)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from the current findings")
    ap.add_argument("--all", action="store_true",
                    help="print every finding, including grandfathered ones")
    args = ap.parse_args(argv)

    findings = scan([Path(p) for p in args.paths])
    baseline_path = Path(args.baseline or DEFAULT_BASELINE)

    if args.write_baseline:
        write_baseline(findings, baseline_path)
        print(f"wrote {len(findings)} grandfathered finding(s) to "
              f"{baseline_path}")
        return 0

    baseline = load_baseline(baseline_path)
    fresh = findings if args.all else new_findings(findings, baseline)
    for f in fresh:
        print(f.render())

    grandfathered = len(findings) - len(new_findings(findings, baseline))
    if fresh and not args.all:
        rules = sorted({f.rule for f in fresh})
        print(f"\n{len(fresh)} new finding(s) ({', '.join(rules)}); "
              f"{grandfathered} grandfathered by {baseline_path}.")
        print("Fix, suppress with `# staticcheck: ignore[RULE] -- reason`, "
              "or (last resort) --write-baseline.")
    if args.all and findings:
        for (path, rule), count in sorted(summarize(findings).items()):
            print(f"  {path} {rule} x{count}")
    return 1 if new_findings(findings, baseline) else 0


if __name__ == "__main__":
    sys.exit(main())
