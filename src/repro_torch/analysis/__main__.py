"""CLI: ``python -m repro_torch.analysis lint [paths...]`` (default
``src/repro_torch``).

Exit status 0 iff every finding is fixed or suppressed by a justified
pragma.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.lint import RULE_IDS, LintConfig, lint_paths, report

DEFAULT_PATHS = ["src/repro_torch"]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = parser.add_subparsers(dest="command", required=True)
    lint = sub.add_parser("lint", help="run the lint pass")
    lint.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                      help="files or directories")
    lint.add_argument("--rules", default=",".join(RULE_IDS),
                      help="comma-separated rule subset (default: all)")
    lint.add_argument("--show-suppressed", action="store_true",
                      help="also print pragma-suppressed findings with "
                           "their justifications")
    args = parser.parse_args(argv)
    config = LintConfig(rules=tuple(r.strip() for r in args.rules.split(",")
                                    if r.strip()))
    findings = lint_paths(args.paths or DEFAULT_PATHS, config)
    text, status = report(findings, show_suppressed=args.show_suppressed)
    print(text)
    return status


if __name__ == "__main__":
    sys.exit(main())
