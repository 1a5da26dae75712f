"""Plugin framework for wukong-analyze: project-wide static analysis.

The port's copy of the JAX package's analysis/framework.py. A gate is an
:class:`AnalysisPlugin` registered with :func:`register`; it receives one
shared :class:`RepoContext` (parsed ASTs + comment maps + doc surfaces,
computed once) and returns structured :class:`Violation`\\ s that render
identically on the CLI (``python -m wukong_tpu_torch.analysis``), in JSON
(``--json``), and in ``tests/test_torch_analysis.py``.

Design rules for plugins:

- **Pure source analysis.** Plugins read the tree under ``ctx.pkg_root``;
  they never import the code they analyze (the tests run every gate
  against synthetic temp trees too).
- **Comment-driven annotations.** ``ctx.file(path).comments`` maps line
  numbers to comment text extracted with :mod:`tokenize` (never regex —
  a ``#`` inside a string literal is not a comment). The guarded-by
  checker's ``# guarded by:`` / ``# unguarded:`` vocabulary lives on top
  of this.
- **Allowlists are declarations.** A violation is silenced by naming the
  site in the plugin's allowlist or by an inline justification comment —
  both reviewable diffs — never by weakening the gate.

One difference from the JAX framework: :meth:`RepoContext.tests_text`
reads only the port's own tests (``tests/test_torch_*.py``), so a fault
site counts as exercised only where a port test drives it.
"""

from __future__ import annotations

import ast
import io
import os
import tokenize
from dataclasses import dataclass, field

#: the file-name prefix of the tests that exercise the port
TESTS_PREFIX = "test_torch_"


@dataclass(frozen=True)
class Violation:
    """One gate finding, stable across renderers (CLI/JSON/pytest)."""

    gate: str  # plugin name, e.g. "guarded-by"
    path: str  # package-relative posix path ("" for repo-level findings)
    line: int  # 1-based; 0 when the finding is not line-anchored
    message: str

    def __str__(self) -> str:
        where = f"{self.path}:{self.line}" if self.line else (self.path or "-")
        return f"{where}: [{self.gate}] {self.message}"

    def to_dict(self) -> dict:
        return {"gate": self.gate, "path": self.path, "line": self.line,
                "message": self.message}


class SourceFile:
    """One parsed module: AST + per-line comment map + raw lines."""

    def __init__(self, abspath: str, rel: str):
        self.abspath = abspath
        self.rel = rel  # package-relative, posix separators
        with open(abspath, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.error: str | None = None
        try:
            self.tree: ast.Module | None = ast.parse(self.text,
                                                     filename=abspath)
        except SyntaxError as e:
            self.tree = None
            self.error = f"syntax error: {e}"
        self.comments: dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(
                    io.StringIO(self.text).readline):
                if tok.type == tokenize.COMMENT:
                    # last comment on a line wins (there is only ever one)
                    self.comments[tok.start[0]] = tok.string.lstrip("#").strip()
        except (tokenize.TokenError, IndentationError):
            pass  # the AST error above already reports the file

    def comment(self, line: int) -> str:
        return self.comments.get(line, "")


@dataclass
class RepoContext:
    """Everything a plugin may look at, parsed once and shared.

    ``pkg_root`` is the package tree under analysis (normally
    ``wukong_tpu_torch/``; tests point it at synthetic temp trees).
    ``repo_root`` / ``readme_path`` / ``tests_dir`` feed the drift gates;
    they default relative to ``pkg_root`` and may be absent (drift gates
    skip what is missing rather than failing on partial fixtures).
    """

    pkg_root: str
    repo_root: str = ""
    readme_path: str = ""
    tests_dir: str = ""
    _files: dict[str, SourceFile] = field(default_factory=dict)

    def __post_init__(self):
        self.pkg_root = os.path.abspath(self.pkg_root)
        if not self.repo_root:
            self.repo_root = os.path.dirname(self.pkg_root)
        if not self.readme_path:
            self.readme_path = os.path.join(self.repo_root, "README.md")
        if not self.tests_dir:
            self.tests_dir = os.path.join(self.repo_root, "tests")

    # ------------------------------------------------------------------
    def paths(self) -> list[str]:
        """Package-relative posix paths of every .py file, sorted."""
        out = []
        for dirpath, dirs, files in os.walk(self.pkg_root):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for fn in files:
                if fn.endswith(".py"):
                    rel = os.path.relpath(os.path.join(dirpath, fn),
                                          self.pkg_root)
                    out.append(rel.replace(os.sep, "/"))
        return sorted(out)

    def file(self, rel: str) -> SourceFile:
        sf = self._files.get(rel)
        if sf is None:
            sf = self._files[rel] = SourceFile(
                os.path.join(self.pkg_root, rel.replace("/", os.sep)), rel)
        return sf

    def iter_files(self):
        for rel in self.paths():
            yield self.file(rel)

    def readme_text(self) -> str | None:
        if not os.path.isfile(self.readme_path):
            return None
        with open(self.readme_path, encoding="utf-8") as f:
            return f.read()

    def tests_text(self) -> str | None:
        """Concatenated source of the port's tests, tests/test_torch_*.py
        (the fault-site exercise gate): a JAX-package test drives the JAX
        code, not the port's."""
        if not os.path.isdir(self.tests_dir):
            return None
        chunks = []
        for fn in sorted(os.listdir(self.tests_dir)):
            if fn.startswith(TESTS_PREFIX) and fn.endswith(".py"):
                with open(os.path.join(self.tests_dir, fn),
                          encoding="utf-8") as f:
                    chunks.append(f.read())
        return "\n".join(chunks)


class AnalysisPlugin:
    """One gate. Subclass, set ``name``/``description``, implement
    :meth:`run`, and decorate with :func:`register`."""

    name: str = ""
    description: str = ""

    def run(self, ctx: RepoContext) -> list[Violation]:  # pragma: no cover
        raise NotImplementedError

    # helper: every plugin reports unparseable files the same way
    def _syntax_violations(self, ctx: RepoContext) -> list[Violation]:
        return [Violation(self.name, sf.rel, 1, sf.error)
                for sf in ctx.iter_files() if sf.error]


_PLUGINS: dict[str, type[AnalysisPlugin]] = {}


def register(cls: type[AnalysisPlugin]) -> type[AnalysisPlugin]:
    if not cls.name:
        raise ValueError(f"plugin {cls.__name__} has no name")
    _PLUGINS[cls.name] = cls
    return cls


def plugin_names() -> list[str]:
    _load_builtin_plugins()
    return sorted(_PLUGINS)


def _load_builtin_plugins() -> None:
    # import for the registration side effect; lazy so lockdep (runtime
    # checker, imported by hot modules) never drags the AST gates in. The
    # JAX registry's transportgate waits for runtime/procs.py (ROADMAP §A
    # 7b)
    from wukong_tpu_torch.analysis import (  # noqa: F401
        admitgate,
        cachegate,
        devicegate,
        drift,
        guarded,
        joingate,
        migrategate,
        obs_gates,
        placegate,
        slogate,
        telemetry,
        vectorgate,
    )


def run_analysis(pkg_root: str | None = None, *, plugins=None,
                 repo_root: str = "", readme_path: str = "",
                 tests_dir: str = "",
                 ctx: RepoContext | None = None) -> list[Violation]:
    """Run gates over a package tree; returns every violation found.

    ``plugins`` selects by name (default: all registered). Unparseable
    files surface once (not once per gate)."""
    _load_builtin_plugins()
    if ctx is None:
        if pkg_root is None:
            pkg_root = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        ctx = RepoContext(pkg_root, repo_root=repo_root,
                          readme_path=readme_path, tests_dir=tests_dir)
    names = list(plugins) if plugins is not None else plugin_names()
    unknown = [n for n in names if n not in _PLUGINS]
    if unknown:
        raise KeyError(f"unknown analysis plugin(s): {unknown} "
                       f"(have: {plugin_names()})")
    out: list[Violation] = [
        Violation("parse", sf.rel, 1, sf.error)
        for sf in ctx.iter_files() if sf.error]
    for name in names:
        out.extend(_PLUGINS[name]().run(ctx))
    return out
