"""AST lint for the port's conventions that generic linters cannot know
(port of ``repro/analysis/lint.py``, DESIGN.md §12).  Run as ``python -m
repro_torch.analysis.lint`` or through ``python -m
repro_torch.analysis.audit --lint-only``.

Rules:

* **A001 bare-assert** — no ``assert`` statements in
  ``repro_torch/serving`` / ``repro_torch/core``: serving-path invariants
  must survive ``python -O``, so they raise typed exceptions instead.
* **A002 host-sync-in-hook** — no ``.item()``, ``.cpu()``, ``.numpy()``,
  ``.tolist()``, ``int(...)``, ``float(...)`` or ``bool(...)`` inside the
  ``pre_step`` / ``post_dispatch`` hot hooks: on a tensor each is a device
  sync on the step's critical path.
* **A003 seam-site** — the registered host seams
  (``repro_torch.models.moe.callback_seam``: the store's ``read_misses``,
  ``fetch_weights``, ``little_weights``, ``host_ffn``, ``prefill_fetch``,
  ``prefill_little``, ``prefill_host``) may only be CALLED from
  ``models/moe.py`` (and the audit's own seeded-violation fixtures):
  every host seam flows through the MoE layer the audit watches.
* **A004 telemetry-owner** — the store's ``_tel`` counter dict may only
  be mutated inside ``_bump`` / ``drain`` / ``reset_stats`` /
  ``__init__``.  The port's store has no callback thread and no
  ``_tel_lock`` (the reference's callbacks bump from the runtime's
  callback thread, so there the rule guards a data race); here the rule
  keeps one owner for the counters, so ``drain``'s deltas stay exact.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import sys
from typing import Iterable, List, Optional

REPO_SRC = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))
#: directories whose asserts must survive ``python -O``
ASSERT_FREE = (os.path.join("repro_torch", "serving"),
               os.path.join("repro_torch", "core"))
#: the hot hooks a device sync may not hide in
HOT_HOOKS = ("pre_step", "post_dispatch")
#: calls that read a tensor on the host
SYNC_METHODS = ("item", "cpu", "numpy", "tolist")
SYNC_BUILTINS = ("int", "float", "bool")
#: the only modules allowed to CALL a registered seam
SEAM_SITES = (os.path.join("repro_torch", "models", "moe.py"),
              # the seeded-violation fixtures deliberately build illegal
              # steps for the self-test to catch
              os.path.join("repro_torch", "analysis", "selftest.py"))
#: methods of ExpertStore that may mutate self._tel
TEL_MUTATORS = ("_bump", "drain", "reset_stats", "__init__")
_DICT_MUTATORS = ("update", "clear", "pop", "popitem", "setdefault")


def seam_names() -> frozenset:
    """Names of the registered host seams (importing the store registers
    its own)."""
    import repro_torch.serving.expert_store  # noqa: F401 — registers seams
    from repro_torch.models.moe import CALLBACK_SEAMS
    return frozenset(s.name for s in CALLBACK_SEAMS.values())


@dataclasses.dataclass(frozen=True)
class LintFinding:
    code: str
    path: str
    line: int
    detail: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.detail}"

    def asdict(self):
        return dataclasses.asdict(self)


def _rel(path: str) -> str:
    try:
        return os.path.relpath(path, REPO_SRC)
    except ValueError:                  # pragma: no cover (windows drives)
        return path


class _Visitor(ast.NodeVisitor):
    def __init__(self, rel: str, seams: frozenset):
        self.rel = rel
        self.seams = seams
        self.findings: List[LintFinding] = []
        self._func_stack: List[str] = []
        self.in_serving_core = any(d in rel for d in ASSERT_FREE)
        self.seam_ok = any(rel.endswith(p) for p in SEAM_SITES)
        self.is_store = rel.endswith(os.path.join("serving",
                                                  "expert_store.py"))

    def _find(self, code: str, node: ast.AST, detail: str):
        self.findings.append(LintFinding(code, self.rel, node.lineno,
                                         detail))

    def _in_hot_hook(self) -> bool:
        return bool(self._func_stack) and self._func_stack[-1] in HOT_HOOKS

    def _in_tel_mutator(self) -> bool:
        return any(f in TEL_MUTATORS for f in self._func_stack)

    def visit_FunctionDef(self, node):
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assert(self, node):
        if self.in_serving_core:
            self._find("A001", node,
                       "bare assert on a serving path — raise a typed "
                       "exception that survives python -O")
        self.generic_visit(node)

    def visit_Call(self, node):
        f = node.func
        if self._in_hot_hook():
            if isinstance(f, ast.Attribute) and f.attr in SYNC_METHODS:
                self._find("A002", node,
                           f".{f.attr}() inside a hot hook is a device "
                           f"sync on the step's critical path")
            if (isinstance(f, ast.Name) and f.id in SYNC_BUILTINS
                    and node.args):
                self._find("A002", node,
                           f"{f.id}(...) inside a hot hook syncs the "
                           f"device — hoist it off the critical path")
        if isinstance(f, ast.Attribute) and f.attr in self.seams \
                and not self.seam_ok:
            self._find("A003", node,
                       f"seam {f.attr!r} called outside models/moe.py — "
                       f"host seams must be entered from the MoE layer "
                       f"the audit watches")
        if (self.is_store and isinstance(f, ast.Attribute)
                and f.attr in _DICT_MUTATORS and self._is_tel(f.value)
                and not self._in_tel_mutator()):
            self._tel_finding(node)
        self.generic_visit(node)

    @staticmethod
    def _is_tel(node) -> bool:
        return isinstance(node, ast.Attribute) and node.attr == "_tel"

    def _tel_finding(self, node):
        self._find("A004", node,
                   "telemetry counters mutated outside _bump()/drain()/"
                   "reset_stats() — drain()'s deltas would miss the change")

    def _check_tel_target(self, target, node):
        if ((isinstance(target, ast.Subscript) and self._is_tel(target.value))
                or self._is_tel(target)) and not self._in_tel_mutator():
            self._tel_finding(node)

    def visit_Assign(self, node):
        if self.is_store:
            for t in node.targets:
                self._check_tel_target(t, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node):
        if self.is_store:
            self._check_tel_target(node.target, node)
        self.generic_visit(node)


def lint_file(path: str, rel: Optional[str] = None) -> List[LintFinding]:
    rel = rel or _rel(path)
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    return lint_source(src, rel)


def lint_source(src: str, rel: str) -> List[LintFinding]:
    """Lint one module's source text (the unit the tests drive)."""
    tree = ast.parse(src, filename=rel)
    v = _Visitor(rel, seam_names())
    v.visit(tree)
    return v.findings


def iter_py_files(root: str) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def lint_tree(root: Optional[str] = None) -> List[LintFinding]:
    root = root or os.path.join(REPO_SRC, "repro_torch")
    findings: List[LintFinding] = []
    for path in iter_py_files(root):
        findings.extend(lint_file(path))
    return findings


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="the port's convention lint (DESIGN.md §12)")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch)")
    args = ap.parse_args(argv)
    findings: List[LintFinding] = []
    if args.paths:
        for p in args.paths:
            if os.path.isdir(p):
                findings.extend(lint_tree(p))
            else:
                findings.extend(lint_file(p))
    else:
        findings = lint_tree()
    for f in findings:
        print(f)
    print(f"lint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
