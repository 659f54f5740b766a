"""Lint engine: file discovery, pragma handling, rule dispatch, reporting.

The port of ``repro/analysis/lint.py``.  Suppression pragmas are
line-scoped and must carry a justification:

    x = bank[ids]  # lint: disable=R5 -- ids checked by the caller

A pragma may sit on the offending line or the line directly above it, and
may list several rules (``disable=R1,R5``).  A pragma without the ``--
justification`` tail is itself an error (rule id ``PRAGMA``), so a clean
run implies every suppression is explained.
"""
from __future__ import annotations

import io
import os
import re
import tokenize
from dataclasses import dataclass

from repro_torch.analysis.astutil import ModuleInfo
from repro_torch.analysis.rules import RULES

_PRAGMA = re.compile(
    r"#\s*lint:\s*disable=(?P<rules>[A-Z0-9,\s]+?)"
    r"(?:\s*--\s*(?P<why>\S.*?))?\s*$")

RULE_IDS = ("R1", "R5", "R7")
# a pragma may name any of the JAX linter's rules: that linter reads the
# port's sources too (``tests/test_analysis.py`` lints all of ``src/``)
PRAGMA_RULE_IDS = ("R1", "R2", "R3", "R4", "R5", "R6", "R7")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False
    justification: str | None = None

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule}{tag}: {self.message}"


@dataclass
class Pragma:
    line: int
    rules: set[str]
    justification: str | None


@dataclass
class LintConfig:
    rules: tuple[str, ...] = RULE_IDS


def _collect_pragmas(path: str, source: str) -> tuple[list[Pragma],
                                                      list[Finding]]:
    """The ``# lint: disable=...`` comments, read through tokenize (so
    pragma-shaped text inside string literals does not count)."""
    pragmas: list[Pragma] = []
    bad: list[Finding] = []
    try:
        comments = [(tok.start[0], tok.string) for tok in
                    tokenize.generate_tokens(io.StringIO(source).readline)
                    if tok.type == tokenize.COMMENT]
    except tokenize.TokenError:
        comments = []
    for lineno, text in comments:
        match = _PRAGMA.search(text)
        if not match:
            if "lint:" in text and "disable" in text:
                bad.append(Finding(
                    "PRAGMA", path, lineno,
                    f"unparseable lint pragma {text.strip()!r}; expected "
                    "`# lint: disable=R<n>[,R<m>] -- justification`"))
            continue
        rules = {r.strip() for r in match.group("rules").split(",")
                 if r.strip()}
        why = match.group("why")
        if not why:
            bad.append(Finding(
                "PRAGMA", path, lineno,
                "suppression pragma without a justification: append "
                "`-- <one-line reason>`"))
            continue
        unknown = rules - set(PRAGMA_RULE_IDS)
        if unknown:
            bad.append(Finding(
                "PRAGMA", path, lineno,
                f"pragma names unknown rule(s) {sorted(unknown)}; known "
                f"rules: {', '.join(PRAGMA_RULE_IDS)}"))
            continue
        pragmas.append(Pragma(line=lineno, rules=rules, justification=why))
    return pragmas, bad


def lint_source(path: str, source: str,
                config: LintConfig | None = None) -> list[Finding]:
    config = config or LintConfig()
    pragmas, findings = _collect_pragmas(path, source)
    try:
        info = ModuleInfo.parse(path, source)
    except SyntaxError as exc:
        findings.append(Finding("PARSE", path, exc.lineno or 0,
                                f"syntax error: {exc.msg}"))
        return findings
    raw = [f for rule in RULES for f in rule(info)]
    by_line = {p.line: p for p in pragmas}
    for rule_id, lineno, message in sorted(raw, key=lambda r: (r[1], r[0])):
        if rule_id not in config.rules:
            continue
        finding = Finding(rule_id, path, lineno, message)
        for candidate in (lineno, lineno - 1):
            pragma = by_line.get(candidate)
            if pragma is not None and rule_id in pragma.rules:
                finding.suppressed = True
                finding.justification = pragma.justification
                break
        findings.append(finding)
    return findings


def discover(paths: list[str]) -> list[str]:
    files: list[str] = []
    for path in paths:
        if os.path.isfile(path):
            files.append(path)
            continue
        for root, dirs, names in os.walk(path):
            dirs[:] = sorted(d for d in dirs if d not in ("__pycache__",
                                                          ".git"))
            files.extend(os.path.join(root, n) for n in sorted(names)
                         if n.endswith(".py"))
    return files


def lint_paths(paths: list[str],
               config: LintConfig | None = None) -> list[Finding]:
    findings: list[Finding] = []
    for path in discover(paths):
        with open(path, encoding="utf-8") as fh:
            findings.extend(lint_source(path, fh.read(), config))
    return findings


def report(findings: list[Finding], *,
           show_suppressed: bool = False) -> tuple[str, int]:
    """The findings rendered, and the exit status: 1 iff an unsuppressed
    finding remains."""
    active = [f for f in findings if not f.suppressed]
    suppressed = [f for f in findings if f.suppressed]
    lines = [f.render() for f in active]
    if show_suppressed:
        lines += [f"{f.render()}  [why: {f.justification}]"
                  for f in suppressed]
    lines.append(f"{len(active)} finding(s), {len(suppressed)} suppressed "
                 "(justified) pragma(s)")
    return "\n".join(lines), (1 if active else 0)
