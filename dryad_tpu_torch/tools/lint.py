"""graftlint CLI: run the static-analysis registry over the repo.

Usage::

    python -m dryad_tpu_torch.tools.lint               # human-readable
    python -m dryad_tpu_torch.tools.lint --json        # machine-readable
    python -m dryad_tpu_torch.tools.lint --rule host-transfer --rule event-schema
    python -m dryad_tpu_torch.tools.lint --list-rules

Exit status: 0 when the tree is clean (no unsuppressed findings),
1 when findings remain, 2 on usage errors.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from dryad_tpu_torch.analysis import engine
from dryad_tpu_torch.analysis.core import all_checkers, known_rules


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dryad_tpu_torch.tools.lint",
        description="run the graftlint static-analysis registry",
    )
    ap.add_argument(
        "--json", action="store_true", help="emit a JSON report"
    )
    ap.add_argument(
        "--rule",
        action="append",
        default=None,
        metavar="RULE",
        help="run only this rule (repeatable)",
    )
    ap.add_argument(
        "--list-rules", action="store_true", help="list rule ids and exit"
    )
    ap.add_argument(
        "--root", default=None, help="repo root (default: autodetect)"
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, checker in all_checkers().items():
            print(f"{rule}: {checker.summary}")
        print("bad-suppression: suppressions must carry a reason")
        print("unused-suppression: suppressions must match a finding")
        return 0

    try:
        report = engine.run_repo(rules=args.rule, root=args.root)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        print(f"known rules: {', '.join(known_rules())}", file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(report.to_json(), indent=2, sort_keys=True))
    else:
        for f in report.unsuppressed():
            print(f.render())
        n_sup = len(report.suppressed())
        n_bad = len(report.unsuppressed())
        print(
            f"graftlint: {n_bad} finding(s), {n_sup} suppressed, "
            f"{len(report.rules_run)} rule(s) run"
        )
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
