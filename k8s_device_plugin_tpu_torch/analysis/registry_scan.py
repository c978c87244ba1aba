"""The one source of truth for the code-to-doc lockstep inventories.

Every inventory is derived once, from the AST, with file and line
provenance, and both the lockstep tests and the tpu-lint rules
(:mod:`rules`) consume the same functions, so code, tests and lint cannot
disagree about what "documented" means. A multi-line call or a kind
recorded through the global inside its own module is seen like any other.

Code-side inventories (``(value, relpath, line)`` tuples over the port's
package unless ``files`` narrows them):

* :func:`flight_kind_sites`: ``RECORDER.record("<kind>", ...)``
* :func:`ledger_kind_sites`: ``LEDGER.record("<kind>", ...)``
* :func:`span_name_sites`: ``tracing.span("<name>")`` and
  ``_span_for("<name>")``
* :func:`metric_family_sites`: ``*REGISTRY.counter|gauge|histogram(
  "tpu_...", ...)``, with :func:`local_registry_family_sites` for the
  other receivers and :func:`uptime_families` for the families a registry
  renders without registering them
* :func:`heartbeat_names`: loop names at ``HEARTBEATS.register`` and
  ``profiling.supervised`` call sites (exact literals and f-string
  prefixes; the runtime ``loop_inventory`` audit invariant matches against
  these)
* :func:`debug_endpoint_keys` and :func:`debug_path_compare_sites`: the
  ``DEBUG_ENDPOINTS`` index against the paths the handlers dispatch on

Doc side: :func:`documented_backticked` parses the ``\\`name\\```
convention every doc table uses, over the shared doc and the port's
addendum.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

# (value, relpath, line)
Site = Tuple[str, str, int]

# The port's addendum to each shared operator doc, under the docs dir.
ADDENDUM_DIR = "torch"


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def package_files() -> List[str]:
    """Every ``.py`` file of the port's package (sorted, stable)."""
    out: List[str] = []
    for root, _dirs, files in os.walk(package_root()):
        if "__pycache__" in root:
            continue
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.join(root, f))
    return sorted(out)


_AST_CACHE: Dict[str, Tuple[float, ast.Module]] = {}


def parse_file(path: str) -> ast.Module:
    """Parse (and cache by mtime) one source file. A file that does not
    parse raises: an unparseable module is itself a finding the caller must
    surface, never skip."""
    mtime = os.path.getmtime(path)
    cached = _AST_CACHE.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1]
    with open(path, "r") as f:
        tree = ast.parse(f.read(), filename=path)
    _AST_CACHE[path] = (mtime, tree)
    return tree


_WALK_CACHE: Dict[int, Tuple[ast.AST, List[ast.AST]]] = {}


def walk(tree: ast.AST) -> List[ast.AST]:
    """``list(ast.walk(tree))`` (the same breadth-first order), kept for
    each module :func:`parse_file` returns: every inventory and rule walks
    every module, so the walk is paid once a parse."""
    hit = _WALK_CACHE.get(id(tree))
    if hit is not None and hit[0] is tree:
        return hit[1]
    nodes = list(ast.walk(tree))
    _WALK_CACHE[id(tree)] = (tree, nodes)
    return nodes


def clear_cache() -> None:
    """Drop every parsed module and walk (about 50 MiB over the port's
    package): a long-lived process that needed one inventory need not keep
    the trees."""
    _AST_CACHE.clear()
    _WALK_CACHE.clear()


def relpath(path: str) -> str:
    return os.path.relpath(path, repo_root())


def _dotted(node: ast.AST) -> str:
    """Dotted rendering of a Name/Attribute chain ("" for anything else):
    the cheap way to ask "does this call sit on RECORDER, LEDGER or a
    *REGISTRY?"."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _const_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _iter_calls(tree: ast.Module) -> Iterable[ast.Call]:
    for node in walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _record_sites(files: Iterable[str], owner_suffix: str) -> List[Site]:
    """Call sites ``<X>.record("<kind>", ...)`` whose dotted receiver is or
    ends with ``owner_suffix`` (``RECORDER``, ``LEDGER``). An attribute
    receiver such as ``self.recorder`` is not matched: taps go through the
    globals by convention."""
    out: List[Site] = []
    for path in files:
        for call in _iter_calls(parse_file(path)):
            func = call.func
            if not (isinstance(func, ast.Attribute) and func.attr == "record"):
                continue
            owner = _dotted(func.value)
            if not (owner == owner_suffix or owner.endswith("." + owner_suffix)):
                continue
            kind = _const_str(call.args[0] if call.args else None)
            if kind:
                out.append((kind, relpath(path), call.lineno))
    return out


def flight_kind_sites(files: Optional[Iterable[str]] = None) -> List[Site]:
    return _record_sites(files or package_files(), "RECORDER")


def ledger_kind_sites(files: Optional[Iterable[str]] = None) -> List[Site]:
    return _record_sites(files or package_files(), "LEDGER")


def span_name_sites(files: Optional[Iterable[str]] = None) -> List[Site]:
    """``tracing.span("<name>")`` and ``_span_for("<name>")`` literals
    (f-string spans like ``kube.<verb>`` are documented as their pattern,
    not enumerable statically)."""
    out: List[Site] = []
    for path in files or package_files():
        for call in _iter_calls(parse_file(path)):
            func = call.func
            name = None
            if isinstance(func, ast.Attribute) and func.attr == "span":
                name = _const_str(call.args[0] if call.args else None)
            elif isinstance(func, ast.Name) and func.id == "_span_for":
                name = _const_str(call.args[0] if call.args else None)
            if name:
                out.append((name, relpath(path), call.lineno))
    return out


_REGISTER_METHODS = ("counter", "gauge", "histogram")


def _family_sites(files: Optional[Iterable[str]], production: bool) -> List[Site]:
    out: List[Site] = []
    for path in files or package_files():
        for call in _iter_calls(parse_file(path)):
            func = call.func
            if not (isinstance(func, ast.Attribute) and func.attr in _REGISTER_METHODS):
                continue
            owner = _dotted(func.value)
            if production != owner.endswith("REGISTRY") or not owner:
                continue
            fam = _const_str(call.args[0] if call.args else None)
            if fam and fam.startswith("tpu_"):
                out.append((fam, relpath(path), call.lineno))
    return out


def metric_family_sites(files: Optional[Iterable[str]] = None) -> List[Site]:
    """Registration sites ``<...>REGISTRY.counter|gauge|histogram("tpu_...",
    ...)``. The receiver must END with the case-sensitive ``REGISTRY`` (the
    module-global convention), so a transient lowercase ``registry =
    Registry()`` in bench or test code publishes no family here."""
    return _family_sites(files, production=True)


def local_registry_family_sites(files: Optional[Iterable[str]] = None) -> List[Site]:
    """Registration sites of ``tpu_*`` families on receivers that do not
    follow the ``*REGISTRY`` convention: transient bench, simulator or test
    registries (``self._reg.counter(...)``, ``reg = Registry();
    reg.gauge(...)``). They are invisible to :func:`metric_family_sites`
    (and so to TPL003); TPL011 checks that none mints the name of a
    production family, which would poison every dashboard the two meet
    on."""
    return _family_sites(files, production=False)


def uptime_families(files: Optional[Iterable[str]] = None) -> Set[str]:
    """Families ``Registry.render`` emits without a registration: every
    ``uptime_name=`` constant (keyword arguments at ``Registry``
    construction sites and the parameter's default in ``__init__``)."""
    out: Set[str] = set()
    for path in files or package_files():
        for node in walk(parse_file(path)):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "uptime_name":
                        v = _const_str(kw.value)
                        if v:
                            out.add(v)
            elif isinstance(node, ast.FunctionDef) and node.name == "__init__":
                names = [a.arg for a in node.args.args]
                defaults = node.args.defaults
                for arg_name, default in zip(names[len(names) - len(defaults):], defaults):
                    if arg_name == "uptime_name":
                        v = _const_str(default)
                        if v:
                            out.add(v)
    return out


# -- heartbeat / supervised-loop names ----------------------------------------


def _resolve_local_str(func_node: ast.AST, name: str) -> Optional[ast.AST]:
    """The last straight-line assignment of ``name`` inside ``func_node``
    (one hop: enough for the ``loop_name = f"index_warm_{i}"`` idiom)."""
    found: Optional[ast.AST] = None
    for node in ast.walk(func_node):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id == name:
                    found = node.value
    return found


def _name_or_prefix(node: Optional[ast.AST],
                    scope: Optional[ast.AST] = None) -> Tuple[Optional[str], Optional[str]]:
    """(exact, prefix) of a loop-name expression: a constant is exact, an
    f-string contributes its constant lead as a prefix, a local variable
    resolves one hop within ``scope``."""
    if node is None:
        return None, None
    s = _const_str(node)
    if s is not None:
        return s, None
    if isinstance(node, ast.JoinedStr) and node.values:
        lead = _const_str(node.values[0])
        return (None, lead) if lead else (None, None)
    if isinstance(node, ast.Name) and scope is not None:
        resolved = _resolve_local_str(scope, node.id)
        if resolved is not None and not isinstance(resolved, ast.Name):
            return _name_or_prefix(resolved, None)
    return None, None


_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _outermost_scopes(tree: ast.Module) -> Dict[int, ast.AST]:
    """Node id → its outermost enclosing function or lambda (itself for an
    outermost one), in one pass over the tree."""
    out: Dict[int, ast.AST] = {}
    stack: List[Tuple[ast.AST, Optional[ast.AST]]] = [(tree, None)]
    while stack:
        node, scope = stack.pop()
        if scope is None and isinstance(node, _SCOPES):
            scope = node
        if scope is not None:
            out[id(node)] = scope
        stack.extend((child, scope) for child in ast.iter_child_nodes(node))
    return out


def _is_loop_site(call: ast.Call) -> bool:
    func = call.func
    if isinstance(func, ast.Attribute) and func.attr == "register":
        return _dotted(func.value).endswith("HEARTBEATS")
    if isinstance(func, ast.Name):
        return func.id in ("supervised", "run_supervised")
    return isinstance(func, ast.Attribute) and func.attr in ("supervised", "run_supervised")


def heartbeat_names(files: Optional[Iterable[str]] = None) -> Tuple[Set[str], Set[str]]:
    """(exact names, prefixes) of every loop the code registers a heartbeat
    for or supervises: the static loop inventory. Sources: the first
    argument of ``HEARTBEATS.register``, ``supervised`` and
    ``run_supervised``; an f-string contributes its constant prefix
    (``index_warm_`` covers ``index_warm_0..N``), a local variable or a
    parameter with a constant default resolves one hop. The runtime
    ``loop_inventory`` audit invariant warns about any registered heartbeat
    this inventory cannot explain: a loop the linter cannot see is a loop
    the ``loop-without-heartbeat`` rule cannot protect."""
    exact: Set[str] = set()
    prefixes: Set[str] = set()
    for path in files or package_files():
        tree = parse_file(path)
        sites = [call for call in _iter_calls(tree) if _is_loop_site(call)]
        if not sites:
            continue
        scopes = _outermost_scopes(tree)
        for call in sites:
            arg = call.args[0] if call.args else None
            scope = scopes.get(id(call))
            name, prefix = _name_or_prefix(arg, scope)
            if (name is None and prefix is None and isinstance(arg, ast.Name)
                    and isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef))):
                # A parameter with a constant default.
                a = scope.args
                names = [x.arg for x in a.args]
                for arg_name, default in zip(names[len(names) - len(a.defaults):], a.defaults):
                    if arg_name == arg.id:
                        name = _const_str(default)
            if name:
                exact.add(name)
            if prefix:
                prefixes.add(prefix)
    return exact, prefixes


def loop_name_known(name: str, exact: Set[str], prefixes: Set[str]) -> bool:
    return name in exact or any(name.startswith(p) for p in prefixes)


# -- /debug endpoints -----------------------------------------------------------


def debug_endpoint_keys(files: Optional[Iterable[str]] = None) -> List[Site]:
    """The keys of the ``DEBUG_ENDPOINTS`` dict literal (the ``/debug``
    index and the tpu-doctor bundle's collection list)."""
    out: List[Site] = []
    for path in files or package_files():
        for node in walk(parse_file(path)):
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            else:
                continue
            if not any(isinstance(t, ast.Name) and t.id == "DEBUG_ENDPOINTS" for t in targets):
                continue
            if not isinstance(node.value, ast.Dict):
                continue
            for key in node.value.keys:
                k = _const_str(key)
                if k:
                    out.append((k, relpath(path), key.lineno))
    return out


def debug_path_compare_sites(files: Optional[Iterable[str]] = None) -> List[Site]:
    """``/debug/...`` string literals used in comparisons (the dispatch
    tests of ``debug_payload`` and the HTTP handlers): the surface a request
    can reach. Only Compare nodes count, which keeps descriptions, log lines
    and docstrings out."""
    out: List[Site] = []
    index_paths = {"/debug", "/debug/"}
    for path in files or package_files():
        for node in walk(parse_file(path)):
            if not isinstance(node, ast.Compare):
                continue
            literals: List[ast.AST] = [node.left, *node.comparators]
            for lit in literals:
                if isinstance(lit, (ast.Tuple, ast.List, ast.Set)):
                    literals.extend(lit.elts)
            for lit in literals:
                s = _const_str(lit)
                if s and s.startswith("/debug/") and s not in index_paths:
                    out.append((s, relpath(path), lit.lineno))
    return out


# -- doc-side parsing -------------------------------------------------------------


def _docs_base(docs_dir: Optional[str]) -> str:
    return docs_dir or os.path.join(repo_root(), "docs")


def _read(path: str) -> str:
    with open(path, "r") as f:
        return f.read()


def doc_text(doc_name: str, docs_dir: Optional[str] = None) -> str:
    """The shared operator doc ``docs/<doc_name>``, followed by the port's
    addendum ``docs/torch/<doc_name>`` where one exists."""
    base = _docs_base(docs_dir)
    text = _read(os.path.join(base, doc_name))
    addendum = os.path.join(base, ADDENDUM_DIR, doc_name)
    if os.path.exists(addendum):
        text += "\n" + _read(addendum)
    return text


def documented_backticked(doc_name: str, pattern: str = r"`([a-z][A-Za-z0-9_./<>-]*)`",
                          docs_dir: Optional[str] = None) -> Set[str]:
    """Every backticked token of a doc and its addendum: the convention the
    kind, family and invariant tables share."""
    return set(re.findall(pattern, doc_text(doc_name, docs_dir)))


def documented_metric_families(docs_dir: Optional[str] = None) -> Set[str]:
    return set(re.findall(r"`(tpu_[a-z0-9_]+)`", doc_text("metrics.md", docs_dir)))


def doc_line_of(doc_name: str, needle: str, docs_dir: Optional[str] = None) -> int:
    """1-based line of the first occurrence in the shared doc (0 when it is
    absent there): gives doc-side findings a clickable location."""
    text = _read(os.path.join(_docs_base(docs_dir), doc_name))
    for i, line in enumerate(text.splitlines(), start=1):
        if needle in line:
            return i
    return 0


def doc_site(doc_name: str, needle: str, docs_dir: Optional[str] = None) -> Tuple[str, int]:
    """(repo-relative doc path, line) of the first occurrence: the shared
    doc's line, else the addendum's, else the shared doc at line 0."""
    line = doc_line_of(doc_name, needle, docs_dir)
    shared = f"docs/{doc_name}"
    if line:
        return shared, line
    addendum = os.path.join(_docs_base(docs_dir), ADDENDUM_DIR, doc_name)
    if os.path.exists(addendum):
        for i, text in enumerate(_read(addendum).splitlines(), start=1):
            if needle in text:
                return f"docs/{ADDENDUM_DIR}/{doc_name}", i
    return shared, 0
