"""skylint engine: file loading, pragma handling, rule registry, reporting.

The engine is deliberately stdlib-only (``ast`` + ``tokenize``): CI runs it
before any heavyweight dependency is installed, and the self-tests run it
against synthetic trees under ``tmp_path``.

Vocabulary:

  * :class:`Finding`    — one violation: file:line, rule id, severity,
    message and a fix hint.
  * :class:`SourceFile` — one parsed file plus its pragma index.
  * :class:`Context`    — the whole scanned tree. Rules receive it on every
    ``visit`` call so cross-file rules (sim parity, report protocol) can
    read their sibling files; ``ctx.current`` is the file under visit.
  * :class:`Rule`       — the plugin protocol: ``visit(tree, ctx) ->
    list[Finding]`` plus ``id`` / ``severity`` / ``description`` class
    attributes. Register implementations with :func:`register`.

Pragmas: ``# skylint: disable=SKY001,SKY003``. A standalone comment line
disables the listed rules for the WHOLE file; a trailing comment disables
them for that line only. Every pragma is recorded (file, line, scope,
rules) so the JSON report doubles as the allowlist audit, and a pragma
naming an unknown rule id is itself a finding (``SKY000``) — a typo must
not silently disable nothing.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import json
import re
import tokenize
from pathlib import Path

SEVERITIES = ("error", "warning")

# Engine-level rule id: parse failures and bad pragmas.
ENGINE_RULE_ID = "SKY000"

_PRAGMA_RE = re.compile(r"#\s*skylint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    path: str  # root-relative, posix separators
    line: int
    rule: str
    severity: str
    message: str
    hint: str = ""

    def format(self) -> str:
        s = f"{self.path}:{self.line}: {self.rule} [{self.severity}] {self.message}"
        if self.hint:
            s += f"  (hint: {self.hint})"
        return s

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Pragma:
    """One ``# skylint: disable=...`` occurrence (for the allowlist audit)."""

    path: str
    line: int
    scope: str  # "file" | "line"
    rules: tuple[str, ...]

    def to_dict(self) -> dict:
        return {"path": self.path, "line": self.line, "scope": self.scope,
                "rules": list(self.rules)}


@dataclasses.dataclass
class SourceFile:
    """One parsed source file plus its pragma index."""

    relpath: str
    source: str
    tree: ast.Module | None  # None when the file failed to parse
    file_pragmas: set = dataclasses.field(default_factory=set)
    line_pragmas: dict = dataclasses.field(default_factory=dict)  # line -> set
    pragmas: list = dataclasses.field(default_factory=list)  # [Pragma]
    parse_error: str | None = None

    @property
    def lines(self) -> list[str]:
        return self.source.splitlines()

    def suppressed(self, rule: str, line: int) -> bool:
        if rule in self.file_pragmas:
            return True
        return rule in self.line_pragmas.get(line, ())


def _scan_pragmas(sf: SourceFile) -> None:
    """Tokenize-based pragma extraction: comments only, so pragma-looking
    text inside string literals (fixture snippets in the self-tests) is
    never mistaken for a real pragma."""
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(sf.source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return
    for tok in toks:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if m is None:
            continue
        rules = tuple(
            r.strip() for r in m.group(1).split(",") if r.strip()
        )
        line_no = tok.start[0]
        standalone = sf.lines[line_no - 1].lstrip().startswith("#")
        scope = "file" if standalone else "line"
        sf.pragmas.append(Pragma(sf.relpath, line_no, scope, rules))
        if standalone:
            sf.file_pragmas.update(rules)
        else:
            sf.line_pragmas.setdefault(line_no, set()).update(rules)


@dataclasses.dataclass
class ClassInfo:
    """Repo-wide class-table entry used by cross-file inheritance rules."""

    name: str
    relpath: str
    line: int
    bases: tuple[str, ...]  # simple names (Attribute bases keep the attr)
    own_names: frozenset  # methods + class-level assignments


class Context:
    """The scanned tree. ``current`` rotates as the engine visits files."""

    def __init__(self, root: Path, files: dict):
        self.root = Path(root)
        self.files: dict[str, SourceFile] = files
        self.current: SourceFile | None = None
        self._class_index: dict[str, ClassInfo] | None = None

    # ------------------------------------------------------------- utilities
    def file(self, relpath: str) -> SourceFile | None:
        return self.files.get(relpath)

    def under(self, *prefixes: str) -> bool:
        """Is the current file under any of the given root-relative dirs?"""
        rp = self.current.relpath
        return any(rp == p or rp.startswith(p.rstrip("/") + "/")
                   for p in prefixes)

    def finding(self, rule, node_or_line, message: str, hint: str = "") -> Finding:
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(
            path=self.current.relpath, line=int(line), rule=rule.id,
            severity=rule.severity, message=message, hint=hint or rule.hint,
        )

    @property
    def class_index(self) -> dict[str, ClassInfo]:
        """name -> ClassInfo over every scanned file (last definition wins —
        class names are unique in this repo; good enough for lint)."""
        if self._class_index is None:
            index: dict[str, ClassInfo] = {}
            for sf in self.files.values():
                if sf.tree is None:
                    continue
                for node in ast.walk(sf.tree):
                    if not isinstance(node, ast.ClassDef):
                        continue
                    bases = []
                    for b in node.bases:
                        if isinstance(b, ast.Name):
                            bases.append(b.id)
                        elif isinstance(b, ast.Attribute):
                            bases.append(b.attr)
                    own = set()
                    for st in node.body:
                        if isinstance(st, (ast.FunctionDef,
                                           ast.AsyncFunctionDef)):
                            own.add(st.name)
                        elif isinstance(st, ast.Assign):
                            for t in st.targets:
                                if isinstance(t, ast.Name):
                                    own.add(t.id)
                        elif isinstance(st, ast.AnnAssign) and isinstance(
                            st.target, ast.Name
                        ):
                            own.add(st.target.id)
                    index[node.name] = ClassInfo(
                        node.name, sf.relpath, node.lineno, tuple(bases),
                        frozenset(own),
                    )
            self._class_index = index
        return self._class_index

    def mro_names(self, cls: str, *, include: tuple[str, ...] = (),
                  exclude: tuple[str, ...] = ()) -> set:
        """Union of ``own_names`` along the (simple-name) inheritance chain.

        ``exclude`` drops the listed class names' contributions (used to ask
        "does the chain define ``kind`` anywhere OTHER than the root
        mixin"). Unknown bases contribute nothing."""
        seen: set[str] = set()
        names: set[str] = set()
        stack = [cls]
        while stack:
            c = stack.pop()
            if c in seen:
                continue
            seen.add(c)
            info = self.class_index.get(c)
            if info is None:
                continue
            if c not in exclude or c in include:
                names |= info.own_names
            stack.extend(info.bases)
        return names


# ------------------------------------------------------------- rule registry
class Rule:
    """Base class / protocol for skylint rules.

    Subclasses set ``id`` (``SKY###``), ``severity``, ``description`` and a
    default fix ``hint``, and implement ``visit(tree, ctx)`` returning the
    findings for ``ctx.current``. ``visit`` is called once per parsed file;
    rules that need a whole-repo view anchor themselves on one file and
    read siblings through ``ctx.files``."""

    id: str = "SKY999"
    severity: str = "error"
    description: str = ""
    hint: str = ""

    def visit(self, tree: ast.Module, ctx: Context) -> list:
        raise NotImplementedError


_REGISTRY: dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule to the active set."""
    if cls.severity not in SEVERITIES:
        raise ValueError(f"{cls.id}: bad severity {cls.severity!r}")
    if cls.id in _REGISTRY:
        raise ValueError(f"duplicate rule id {cls.id}")
    _REGISTRY[cls.id] = cls()
    return cls


def active_rules() -> list:
    return [_REGISTRY[k] for k in sorted(_REGISTRY)]


def active_rule_ids() -> tuple:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------- the check
def _collect_py(root: Path, paths) -> list:
    out = []
    for p in paths:
        ap = (root / p) if not Path(p).is_absolute() else Path(p)
        if ap.is_file() and ap.suffix == ".py":
            out.append(ap)
        elif ap.is_dir():
            out.extend(
                f for f in sorted(ap.rglob("*.py"))
                if "__pycache__" not in f.parts
                and not any(part.startswith(".") for part in f.parts)
            )
    return out


def load_tree(root, paths) -> Context:
    root = Path(root).resolve()
    files: dict[str, SourceFile] = {}
    for f in _collect_py(root, paths):
        rel = f.resolve().relative_to(root).as_posix()
        source = f.read_text(encoding="utf-8")
        try:
            tree = ast.parse(source, filename=rel)
            err = None
        except SyntaxError as e:
            tree, err = None, f"line {e.lineno}: {e.msg}"
        sf = SourceFile(relpath=rel, source=source, tree=tree,
                        parse_error=err)
        _scan_pragmas(sf)
        files[rel] = sf
    return Context(root, files)


@dataclasses.dataclass
class CheckReport:
    """Everything one ``check`` run produced."""

    findings: list
    pragmas: list
    files_scanned: int
    rules: list  # active Rule instances

    @property
    def ok(self) -> bool:
        return not self.findings

    def to_dict(self) -> dict:
        return {
            "version": 1,
            "ok": self.ok,
            "files_scanned": self.files_scanned,
            "rules": [
                {"id": r.id, "severity": r.severity,
                 "description": r.description}
                for r in self.rules
            ],
            "findings": [f.to_dict() for f in self.findings],
            "pragmas": [p.to_dict() for p in self.pragmas],
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def to_text(self) -> str:
        lines = [f.format() for f in self.findings]
        n_err = sum(1 for f in self.findings if f.severity == "error")
        n_warn = len(self.findings) - n_err
        lines.append(
            f"skylint: {self.files_scanned} files, "
            f"{len(self.rules)} rules, {n_err} errors, {n_warn} warnings"
        )
        return "\n".join(lines)


def check(root, paths, rules=None) -> CheckReport:
    """Run every active rule over the tree under ``paths`` (relative to
    ``root``). Returns the full report; callers gate on ``report.ok``."""
    ctx = load_tree(root, paths)
    rules = list(rules) if rules is not None else active_rules()
    known_ids = {r.id for r in rules} | {ENGINE_RULE_ID}
    findings: list[Finding] = []
    pragmas: list[Pragma] = []

    for sf in ctx.files.values():
        pragmas.extend(sf.pragmas)
        # pragma allowlist audit: unknown ids are findings, not no-ops
        for pr in sf.pragmas:
            for rid in pr.rules:
                if rid not in known_ids:
                    findings.append(Finding(
                        path=sf.relpath, line=pr.line, rule=ENGINE_RULE_ID,
                        severity="error",
                        message=f"pragma disables unknown rule {rid!r}",
                        hint="fix the rule id or drop the pragma",
                    ))
        if sf.parse_error is not None:
            findings.append(Finding(
                path=sf.relpath, line=1, rule=ENGINE_RULE_ID,
                severity="error",
                message=f"syntax error: {sf.parse_error}",
            ))

    for sf in ctx.files.values():
        if sf.tree is None:
            continue
        ctx.current = sf
        for rule in rules:
            for f in rule.visit(sf.tree, ctx):
                if not sf.suppressed(f.rule, f.line):
                    findings.append(f)
    ctx.current = None

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return CheckReport(
        findings=findings, pragmas=pragmas,
        files_scanned=len(ctx.files), rules=rules,
    )
