"""The ``# guarded-by:`` comment scanner of the JAX package's ralint
(``devtools/lint.py`` there, run as ``tools/ralint.py``), copied for
:func:`tsan.watch_module`, which maps each annotated field to its lock.
The linter itself is not part of this package: ``python tools/ralint.py
src/`` lints both packages' sources."""

from __future__ import annotations

import ast
import re
from typing import Dict, Set, Tuple

GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
ALLOW_RE = re.compile(r"#\s*ralint:\s*allow=([a-z-]+)")


class FileInfo:
    """Parsed source + the comment-carried metadata the AST can't see."""

    def __init__(self, path: str, src: str):
        self.path = path
        self.src = src
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        # line -> lock name from "# guarded-by: <lock>" comments
        self.guard_lines: Dict[int, str] = {}
        # line -> set of rules waived by "# ralint: allow=<rule>" comments
        self.allow_lines: Dict[int, Set[str]] = {}
        for i, text in enumerate(self.lines, start=1):
            m = GUARDED_RE.search(text)
            if m:
                self.guard_lines[i] = m.group(1)
            for rule in ALLOW_RE.findall(text):
                self.allow_lines.setdefault(i, set()).add(rule)

    def allowed(self, rule: str, line: int) -> bool:
        """Waived when the flagged line, or the contiguous comment block
        immediately above it, carries ``# ralint: allow=<rule>``."""
        if rule in self.allow_lines.get(line, set()):
            return True
        ln = line - 1
        while 1 <= ln <= len(self.lines) and self.lines[ln - 1].lstrip().startswith("#"):
            if rule in self.allow_lines.get(ln, set()):
                return True
            ln -= 1
        return False


def _collect_guards(info: FileInfo) -> Tuple[
    Dict[str, Dict[str, str]],  # class name -> {attr: lock}
    Dict[str, str],             # module-level global -> lock
]:
    """Attach ``# guarded-by`` comments to the assignments on their lines."""
    class_guards: Dict[str, Dict[str, str]] = {}
    module_guards: Dict[str, str] = {}

    for node in info.tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            lock = info.guard_lines.get(node.lineno)
            if lock:
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        module_guards[t.id] = lock
        elif isinstance(node, ast.ClassDef):
            guards = class_guards.setdefault(node.name, {})
            for sub in ast.walk(node):
                if not isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    continue
                lock = info.guard_lines.get(sub.lineno)
                if not lock:
                    continue
                targets = (
                    sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                )
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        guards[t.attr] = lock
                    elif isinstance(t, ast.Name):
                        # annotated slot-style class body assignment
                        guards[t.id] = lock
    class_guards = {k: v for k, v in class_guards.items() if v}
    return class_guards, module_guards


def collect_guards(path: str) -> Dict[str, Dict[str, str]]:
    """Public: ``# guarded-by`` map of one file (used by the tsan tracer)."""
    with open(path, "r", encoding="utf-8") as f:
        info = FileInfo(path, f.read())
    return _collect_guards(info)[0]
